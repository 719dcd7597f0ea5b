#!/usr/bin/env python3
"""Times the port's kernels K1, K2, K3, K4, K5, K6 and K7 of one checkout on the card.

    python3 chip_kernels.py [--src DIR] [--save FILE] [--only PREFIX,...]

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two checkouts can be compared on one
card in one call, in turns: ``--src A/src``, ``--src B/src``, ``--src
B/src``, ``--src A/src``, each in its own process; ``--save FILE`` keeps
K2's outputs, to hold two checkouts' against each other; ``--only`` times
just the readings whose names start with one of the given prefixes
(``k3`` for K3's).  Every kernel
runs on ``chip_smoke.py``'s inputs at that script's shapes (K1: 192 cells
at K = 10 and K = 100; K2: 8 cells at K = 10^4, top_m 128, at V = 1e-5
(m* <= 8) and 1e-3 (m* ~ 62); K3: the §VI grid's 192
cells x 300 rounds x K = 10 on seeded gains, and 192 cells x 40 rounds x
K = 100; K3's streamed-radio instance and its failure instance under each
failure mode at the §VI shape, on seeded radio and delivery streams, and
its guarded instance (a cap that never fires), its bisect instance and a
chaos backend's instance (the fallback every round) at the §VI shape, and
its newton instance (``k3_newton``, where the checkout has it) and its
HasMetrics instance with the telemetry overhead spec of
benchmarks/traj_bench.py:304 there (each where the checkout has it; that
reading also carries the digest of its decision outputs alone), and a
segment launch of rounds 128-192 from round 128's carry (``k3_seg``, where
the checkout has checkpoint/resume), and its wide instance on traj_bench's
K-scaling cell, 8 cells x 8 rounds x K = 10^4, top_m 128 (``k3_wide``, where
the checkout has it), and with pallas, newton and bisect on the §VI
per-client load at that shape (``k3_wide_<solver>``), and there its ranked
row (``k3_ranked_sort``: ranking="sort" under pallas;
``k3_ranked_over_topm``: overprovision under top-m 128 with a drop_heavy
mask, where the checkout has them; ``k3_ranked_topm128``: the ranked row
forced onto ``k3_wide``'s cell, and ``k3_wide_K1e5`` /
``k3_ranked_topm128_K1e5`` both rows on that cell at K = 10^5); the §VI instance's reading also
carries ptxas's registers and spills (``ptxas``); K4: ``chip_smoke.K4_SHAPES``
(``k4_<label>``; head_dim 256 and float32 where the checkout has them); K5: the long cache; K6: one 4096-channel block of jamba's mixer
over 8192 steps; K7: the rwkv6 prefill layer, 8 x 8192 x 32 heads of 64,
and at B = 4, 128 (b, h) chains, fewer than the card's 132 SMs) and is
timed two ways: ``ms``, back-to-back wrapper calls between two CUDA events
(``chip_smoke.gpu_ms``), and ``device_ms``, the sum of its kernels in a
torch.profiler reading (``chip_smoke.device_ms``); a digest of its outputs
says whether two checkouts compute the same bits.  K3 at K = 100 also
carries its bound (``chip_smoke.k3_bound``).  Prints the card's name
and power limit and one JSON line.  Needs a CUDA device; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--save", help="file to torch.save K2's outputs (b, wm) in, by reading")
    ap.add_argument("--only", default="", help="comma-separated prefixes of the readings to take")
    args = ap.parse_args()
    only = tuple(p for p in args.only.split(",") if p)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_kernels: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj
    from repro_torch.kernels.rwkv6_scan import wkv_scan

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    ).stdout.strip()
    rec = {}

    def timed(name, fn, reps):
        """Both times, the device time by kernel, and a digest of the outputs
        (the first 16 hex digits of their bytes' SHA-256), which tells
        whether two checkouts compute the same bits."""
        if only and not name.startswith(only):
            return
        out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        h = hashlib.sha256()
        for t in outs:
            if t is None:  # an output the instance does not write
                continue
            if isinstance(t, dict):  # a HasMetrics launch's telemetry, by key
                t = torch.cat([t[k].reshape(-1) for k in sorted(t)])
            h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        dev_ms, by_kernel, seen = cs.device_ms(torch, fn, reps)
        rec[name] = dict(ms=cs.gpu_ms(torch, fn, reps), device_ms=dev_ms,
                         device_ms_by_kernel=by_kernel, device_records_seen=seen,
                         digest=h.hexdigest()[:16],
                         clocks_sm_mem_power_temp=cs.clocks())
        if getattr(out, "metrics", None) is not None:
            rec[name]["decision_digest"] = cs.k3_digest(torch, out)

    for K in (10, 100):
        scal, rho, _ = cs._k1_inputs(torch, np, dev, 192, K, seed=K)
        timed(f"k1_K{K}", lambda scal=scal, rho=rho: ocean_p_prefix(scal, rho), 20)

    k2_out = {}
    for name, v in (("k2", 1e-5), ("k2_V1e-3", 1e-3)):
        scal, work, *_ = cs._k2_inputs(torch, np, dev, 8, 10_000, v, 1.0, 128)
        timed(name, lambda: ocean_p_topm(scal, work, K=10_000, top_m=128), 10)
        if name in rec:
            k2_out[name] = [t.cpu() for t in ocean_p_topm(scal, work, K=10_000, top_m=128)]
    if args.save:
        torch.save(k2_out, args.save)

    from repro_torch.core.patterns import eta_schedule
    from repro_torch.sim import GridEngine

    T, K, cells = 300, 10, 192
    scen, pols, _ = cs._grid_args(T, K, 64)
    cfg = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev).cfg
    rng = np.random.default_rng(3)
    h2c = torch.tensor(rng.exponential(size=(cells, T, K)).astype(np.float32) * 2.5e-4,
                       device=dev)
    inc = torch.full_like(h2c, 0.15 / T)
    eta = eta_schedule("uniform", T, device=dev).expand(cells, T).contiguous()
    vv = torch.full((cells, T), 1e-5, device=dev)
    timed("k3", lambda: ocean_traj(cfg, h2c, vv, eta, inc), 5)
    from repro_torch.kernels.ocean_traj import FUSED_SOLVERS

    if "newton" in FUSED_SOLVERS:
        cfg_n = dataclasses.replace(cfg, solver="newton")
        timed("k3_newton", lambda: ocean_traj(cfg_n, h2c, vv, eta, inc), 5)
    from repro_torch.kernels import _build

    build_output = getattr(_build, "build_output", None)
    log = (build_output("ocean_traj") if build_output is not None
           else _build.BUILD_LOG.get("ocean_traj", {}).get("output"))
    # registers and spills of the §VI instance (None where this process did
    # not build it and the checkout keeps no build log)
    if "k3" in rec:
        rec["k3"]["ptxas"] = cs.ptxas_of(log, cs.K3_VI_INSTANCE)
    try:
        from repro_torch.core.ocean import segment_step, slice_rounds
    except ImportError:  # a checkout without checkpoint/resume
        segment_step = None
    if segment_step is not None and (not only or "k3_seg".startswith(only)):
        from repro_torch.core.ocean import init_state

        streams = (h2c, vv, eta, inc, None, None)
        carry = init_state(cfg, cells, device=dev)
        for t0, t1 in ((0, 64), (64, 128)):
            carry = segment_step(cfg, "fused", carry, None, slice_rounds(streams, t0, t1))[0]
        seg = slice_rounds(streams, 128, 192)[:4]
        timed("k3_seg", lambda: ocean_traj(cfg, *seg, init_state=carry), 5)
    try:
        from repro_torch.obs import MetricsSpec
    except ImportError:  # a checkout without the telemetry
        MetricsSpec = None
    if MetricsSpec is not None:
        cfg_m = dataclasses.replace(cfg, metrics=MetricsSpec.of(*cs.OVERHEAD_SPEC))
        timed("k3_metrics", lambda: ocean_traj(cfg_m, h2c, vv, eta, inc), 5)
    try:
        from repro_torch.env.failure import TracedFailure
        from repro_torch.env.radio import traced_radio
    except ImportError:  # a checkout without the environment processes
        TracedFailure = None
    if TracedFailure is not None:
        share = torch.tensor(rng.uniform(0.5, 1.0, (cells, T)), dtype=torch.float32, device=dev)
        radio = traced_radio(cfg.radio, T).map(lambda x: x.to(dev).expand(cells, T).contiguous())
        bw = radio.bandwidth_hz * share
        radio = radio._replace(bandwidth_hz=bw, beta=radio.model_bits / (radio.deadline_s * bw),
                               energy_scale=radio.deadline_s * radio.noise_w * bw)
        timed("k3_radio", lambda: ocean_traj(cfg, h2c, vv, eta, inc, radio=radio), 5)
        fail = TracedFailure(
            delivered=torch.tensor((rng.random((cells, T, K)) < 0.7).astype(np.float32),
                                   device=dev),
            rate=torch.full((cells, K), 0.7, device=dev))
        for mode in ("plain", "overprovision", "reallocate"):
            cfg_m = dataclasses.replace(cfg, failure_mode=mode)
            timed(f"k3_failure_{mode}",
                  lambda cfg_m=cfg_m: ocean_traj(cfg_m, h2c, vv, eta, inc, failure=fail), 5)
        del radio, fail
    try:
        from repro_torch.guard import GuardSpec, register_chaos_solver
    except ImportError:  # a checkout without the guard
        GuardSpec = None
    if GuardSpec is not None:
        for name, cfg_r, reps in (
                ("k3_guard", dataclasses.replace(cfg, guard=GuardSpec(energy_cap=1e6)), 5),
                ("k3_bisect", dataclasses.replace(cfg, solver="bisect"), 3),
                ("k3_chaos", dataclasses.replace(
                    cfg, solver=register_chaos_solver("pallas", kind="objective").name,
                    guard=GuardSpec()), 3)):
            timed(name, lambda cfg_r=cfg_r: ocean_traj(cfg_r, h2c, vv, eta, inc), reps)
    k3_large = cs._k3_inputs(torch, np, dev, 192, 40, 100, seed=3)
    timed("k3_K100", lambda: ocean_traj(*k3_large), 3)
    if "k3_K100" in rec:
        rec["k3_K100"]["bound_ms"], rec["k3_K100"]["bound_by"] = cs.k3_bound(
            torch, ocean_traj(*k3_large).rho)[:2]
    del h2c, inc, k3_large
    from repro_torch.kernels import ocean_traj as k3mod

    if hasattr(k3mod, "MAX_WIDE_TOP_M"):  # a checkout with K3's wide instances
        wide = cs._kscale_inputs(torch, np, dev, 8, 8, 10_000, seed=10_000)
        timed("k3_wide", lambda: ocean_traj(*wide), 5)
        if "k3_wide" in rec:
            rec["k3_wide"]["bound_ms"], rec["k3_wide"]["bound_by"] = cs.k3_bound(
                torch, ocean_traj(*wide).rho, n_cands=128, wide=True)[:2]
        # the other branch-free wide instances on the §VI per-client load
        # with H / 300 a round (phase k3_wide's inputs)
        ranked = cs._k3_ranked_inputs(torch, np, dev, 8, 8, 10_000, seed=10_000)
        ranked = ranked[:4] + (torch.full_like(ranked[1], 0.15 / 300),)
        for solver in ("pallas", "newton", "bisect"):
            cfg_w = dataclasses.replace(ranked[0], solver=solver, ranking="topm", top_m=128)
            timed(f"k3_wide_{solver}", lambda cfg_w=cfg_w: ocean_traj(cfg_w, *ranked[1:]),
                  3 if solver == "bisect" else 5)
        if hasattr(k3mod, "ranked_row"):  # a checkout with the wide ranked row
            # sort under pallas, and overprovision under top-m 128 with a
            # drop_heavy mask (p_deliver 0.7), on the same cells
            cfg_s = dataclasses.replace(ranked[0], solver="pallas", ranking="sort")
            timed("k3_ranked_sort", lambda: ocean_traj(cfg_s, *ranked[1:]), 5)
            over = dataclasses.replace(cfg_s, ranking="topm", top_m=128,
                                       failure_mode="overprovision")
            drop = cs._drop_heavy(torch, np, dev, 8, 8, 10_000, seed=10_000)
            timed("k3_ranked_over_topm",
                  lambda: ocean_traj(over, *ranked[1:], failure=drop), 5)
            del drop

            def forced(fn):
                """``fn`` with the ranked row taken for any configuration."""
                def run():
                    keep = k3mod.ranked_row
                    k3mod.ranked_row = lambda cfg, failure=False: True
                    try:
                        return fn()
                    finally:
                        k3mod.ranked_row = keep
                return run

            # the ranked row on the compact row's traffic: traj_bench's
            # K-scaling cell (top-m 128), and the same at K = 10^5
            timed("k3_ranked_topm128", forced(lambda: ocean_traj(*wide)), 5)
            wide5 = cs._kscale_inputs(torch, np, dev, 8, 8, 100_000, seed=100_000)
            timed("k3_wide_K1e5", lambda: ocean_traj(*wide5), 5)
            timed("k3_ranked_topm128_K1e5", forced(lambda: ocean_traj(*wide5)), 3)
            del wide5
        del wide, ranked

    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.kernels import flash_attention as fa

    for label, (arch, B, local, dtype_name, seed) in cs.K4_SHAPES.items():
        cfg, dtype = ARCH_CONFIGS.get(arch), getattr(torch, dtype_name)
        if cfg is None or cfg.head_dim not in fa.HEAD_DIMS or (
                dtype != torch.bfloat16 and 256 not in fa.HEAD_DIMS):
            continue  # a checkout before head_dim 256 and float32
        if only and not f"k4_{label}".startswith(only):
            continue
        q, k, v = cs.k4_inputs(torch, dev, cfg, B, 8192, dtype, seed)
        win = cfg.sliding_window if local else None
        timed(f"k4_{label}", lambda: fa.flash_attention(
            q, k, v, causal=True, window=win, logit_cap=cfg.attn_logit_softcap),
            10 if dtype == torch.bfloat16 else 3)
        del q, k, v

    qd, kc, vc, vl = cs._k5_inputs(torch, dev, 4, 8192, 32, 16, 128, 8000)
    timed("k5", lambda: decode_attention(qd, kc, vc, vl, logit_cap=50.0), 50)
    del qd, kc, vc, vl

    da, dbu, c = cs._k6_inputs(torch, dev, 8192 + 4096, 1, 8192, 4096, 16)
    timed("k6", lambda: mamba_scan(da, dbu, c), 10)
    del da, dbu, c
    for B, name in ((8, "k7"), (4, "k7_B4")):
        r, k, v, u, decays = cs._k7_inputs(torch, dev, B, 8192, 32, 64)
        w = decays["model"]
        timed(name, lambda: wkv_scan(r, k, v, w, u), 10)
        del r, k, v, u, decays, w

    print(smi, flush=True)
    print(json.dumps({"src": str(src), "gpu": smi, "kernels": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
