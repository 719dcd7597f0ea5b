#!/usr/bin/env python3
"""Times the port's kernels K1, K2, K3, K5, K6 and K7 of one checkout on the card.

    python3 chip_kernels.py [--src DIR] [--save FILE]

``--src`` names the ``src/`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two checkouts can be compared on one
card in one call, in turns: ``--src A/src``, ``--src B/src``, ``--src
B/src``, ``--src A/src``, each in its own process; ``--save FILE`` keeps
K2's outputs, to hold two checkouts' against each other.  Every kernel
runs on ``chip_smoke.py``'s inputs at that script's shapes (K1: 192 cells
at K = 10 and K = 100; K2: 8 cells at K = 10^4, top_m 128, at V = 1e-5
(m* <= 8) and 1e-3 (m* ~ 62); K3: the §VI grid's 192
cells x 300 rounds x K = 10 on seeded gains, and 192 cells x 40 rounds x
K = 100; K3's streamed-radio instance and its failure instance under each
failure mode at the §VI shape, on seeded radio and delivery streams, and
its guarded instance (a cap that never fires), its bisect instance and a
chaos backend's instance (the fallback every round) at the §VI shape, and
its HasMetrics instance with the telemetry overhead spec of
benchmarks/traj_bench.py:304 there (each where the checkout has it; that
reading also carries the digest of its decision outputs alone); K5: the long cache; K6: one 4096-channel block of jamba's mixer
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
    args = ap.parse_args()
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
    rec["k3_K100"]["bound_ms"], rec["k3_K100"]["bound_by"] = cs.k3_bound(
        torch, ocean_traj(*k3_large).rho)[:2]
    del h2c, inc, k3_large

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
