#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``src/repro_torch/csrc`` with nvcc, holds
each against its plain PyTorch version on the card, drives OCEAN's main
path through the user entry point ``run_grid`` (the paper's §VI grid:
3 scenarios x 64 seeds, K = 10, T = 300, through kernel K3), replays every
(cell, round) of it against the plain round, and drives the paths of K1
(the scan trajectory) and K2 (the sort-free top-m solve at K = 10^4) with
the launch counters reset just before and read just after.

Each phase prints one JSON line; any failed check raises and the script
exits non-zero.  The last lines are the card's name and power limit, the
``kernels`` record (time on the card, plain version's time, bound, launches
and error of every kernel), and ``{"ok": true, "device": {...}}``.  It
needs a CUDA device and the repository's ``src/`` beside it, and imports
nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Tolerances (float32 kernels vs their float32 plain versions; the gap is
# FMA contraction, exp2f's ulp and the order of block sums).
B_ATOL = 2e-4            # bandwidth ratios
W_RTOL = 2e-4            # P3 objective; also the near-tie margin
Q_ATOL, Q_RTOL = 1e-6, 1e-5   # next-round queues
TOPM_B_RTOL, TOPM_B_ATOL = 2e-4, 1e-6   # K2 vs the bisect oracle

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

# Operation counts of the shared device code, counted from
# csrc/ocean_common.cuh: every add, multiply, compare, select, min/max,
# division, square root, exp2f and log2f counts as ONE operation.
OPS_F_PRIME = 9
OPS_F_SECOND = 11
OPS_F_SHANNON = 7
OPS_NEWTON_STEP = OPS_F_PRIME + OPS_F_SECOND + 12
OPS_B_OF_LAM_SETUP = 21 + 2 * OPS_F_PRIME + 2 + 4


def ops_b_of_lam(inner):
    return OPS_B_OF_LAM_SETUP + inner * OPS_NEWTON_STEP


def ops_candidate(m, outer, inner):
    """One candidate of the prefix sweep with m members."""
    per_outer = m * (ops_b_of_lam(inner) + 1 + 2 + OPS_F_SECOND + 4) + 14
    final = m * (ops_b_of_lam(inner) + 1)
    repair = m * (4 + 8 + OPS_F_SHANNON + 2) + 12
    setup = 2 * m + 20 + OPS_F_PRIME
    return setup + outer * per_outer + final + repair + 4


def ops_sweep(counts, outer, inner):
    """Sum over cells of the candidates this data makes the sweep run;
    ``counts`` is a list of per-cell numbers of evaluated candidates."""
    return sum(ops_candidate(m, outer, inner) for n in counts for m in range(1, n + 1))


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = n_ops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def gpu_ms(torch, fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def draws(np, rng, C, K, zero_frac=0.2, tie_eps=None):
    """Seeded (C, K) queues and gains; ``tie_eps`` pairs clients into
    near-identical twins (the reference tests' tie idiom)."""
    if tie_eps is None:
        q = rng.uniform(0.01, 0.2, (C, K))
        h2 = rng.uniform(0.5, 2.0, (C, K)) * 2.5e-4
    else:
        half = (K + 1) // 2
        q = np.repeat(rng.uniform(0.01, 0.2, (C, half)), 2, 1)[:, :K]
        q = q * (1.0 + rng.uniform(-tie_eps, tie_eps, (C, K)))
        h2 = np.repeat(rng.uniform(0.5, 2.0, (C, half)), 2, 1)[:, :K] * 2.5e-4
        h2 = h2 * (1.0 + rng.uniform(-tie_eps, tie_eps, (C, K)))
    q[rng.random((C, K)) < zero_frac] = 0.0
    return q.astype(np.float32), h2.astype(np.float32)


# ---------------------------------------------------------------------------
def phase_card(torch):
    from repro_torch.kernels import _build

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        smi = f"{torch.cuda.get_device_name(0)}, power limit not readable"
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    ptxas = {
        k: [ln for ln in v["output"].splitlines() if "registers" in ln or "smem" in ln]
        for k, v in _build.BUILD_LOG.items()
    }
    emit({
        "phase": "card", "gpu": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": round(build_s, 3),
        "nvcc_s": {k: round(v["seconds"], 3) for k, v in _build.BUILD_LOG.items()},
        "ptxas": ptxas,
    })
    return smi


def _k1_inputs(torch, np, dev, C, K, seed):
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.selection import prefix_inputs, priorities
    from repro_torch.kernels.ocean_p import _scal

    radio = RadioParams(b_min=min(0.02, 0.5 / K))
    rng = np.random.default_rng(seed)
    q, h2 = draws(np, rng, C, K)
    rho = priorities(torch.tensor(q, device=dev), torch.tensor(h2, device=dev))
    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    # V*eta scaled with K so that a third or so of the clients win
    v_eta = torch.tensor(rng.uniform(0.2, 1.8, C) * 1e-5 * K, dtype=torch.float32, device=dev)
    scal = _scal(n0, delta, v_eta, radio, rho_sorted)
    return scal, rho_sorted.contiguous(), n0


def phase_k1(torch, np, dev, C=192, Ks=(10, 100)):
    from repro_torch.kernels.ocean_p import (
        INNER_ITERS, OUTER_ITERS, ocean_p_prefix, ocean_p_prefix_plain,
    )

    rec = {}
    for K in Ks:
        scal, rho, n0 = _k1_inputs(torch, np, dev, C, K, seed=K)
        b_k, wm_k = ocean_p_prefix(scal, rho)
        b_p, wm_p = ocean_p_prefix_plain(scal, rho)
        m_k, m_p = wm_k[:, 1], wm_p[:, 1]
        check(torch.equal(m_k, m_p), f"K1 K={K}: m* differs in {(m_k != m_p).sum().item()} cells")
        err_b = (b_k - b_p).abs().max().item()
        rel_w = ((wm_k[:, 0] - wm_p[:, 0]).abs() / wm_p[:, 0].abs().clamp(min=1e-30)).max().item()
        check(err_b <= B_ATOL, f"K1 K={K}: max |b - b_plain| = {err_b}")
        check(rel_w <= W_RTOL, f"K1 K={K}: max rel W error = {rel_w}")
        counts = torch.clamp(K - n0, max=K).tolist()
        ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS)
        n_bytes = 4 * (scal.numel() + rho.numel() + b_k.numel() + wm_k.numel())
        ms = gpu_ms(torch, lambda: ocean_p_prefix(scal, rho), 20)
        plain_ms = gpu_ms(torch, lambda: ocean_p_prefix_plain(scal, rho), 3)
        bms, by = bound_ms(n_bytes, ops)
        rec[K] = dict(
            cells=C, K=K, max_abs_err_b=err_b, max_rel_err_w=rel_w,
            mean_m_star=m_k.mean().item(), ms=ms, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
        )
    emit({"phase": "k1_ocean_p_prefix", "results": rec})
    return rec


def phase_k2(torch, np, dev, C=8, K=10_000, top_m=128, block_k=128, oracle_cells=2):
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.selection import _RHO_ZERO_TOL, ocean_p, priorities
    from repro_torch.kernels.ocean_p import (
        INNER_ITERS, OUTER_ITERS, _scal, ocean_p_topm, ocean_p_topm_plain,
    )

    radio = RadioParams(b_min=0.1 / K)
    rng = np.random.default_rng(2024)
    q, h2 = draws(np, rng, C, K, tie_eps=1e-4)
    v, eta = 1e-5, 1.0
    qt, ht = torch.tensor(q, device=dev), torch.tensor(h2, device=dev)
    rho = priorities(qt, ht)
    n0 = (rho <= _RHO_ZERO_TOL).sum(1)
    delta = 1.0 - n0.to(torch.float32) * radio.b_min
    K_pad = -(-K // block_k) * block_k
    work = torch.where(rho > _RHO_ZERO_TOL, rho, torch.inf)
    work = torch.nn.functional.pad(work, (0, K_pad - K), value=torch.inf).contiguous()
    scal = _scal(n0, delta, torch.full((C,), v * eta, device=dev), radio, rho)

    b_k, wm_k = ocean_p_topm(scal, work, K=K, top_m=top_m)
    b_p, wm_p = ocean_p_topm_plain(scal, work, K=K, top_m=top_m)
    check(torch.equal(wm_k[:, 1], wm_p[:, 1]), "K2: m* differs from the plain version")
    check(torch.equal(b_k > 0, b_p > 0), "K2: selections differ from the plain version")
    err_b = (b_k - b_p).abs().max().item()
    rel_w = ((wm_k[:, 0] - wm_p[:, 0]).abs() / wm_p[:, 0].abs()).max().item()
    check(err_b <= B_ATOL, f"K2: max |b - b_plain| = {err_b}")
    check(rel_w <= W_RTOL, f"K2: max rel W error = {rel_w}")

    # The sort + bisect oracle on a few cells.  Its sweep clipped to the
    # top_m best candidates (ranking="topm") equals the full sorted sweep
    # whenever m* < top_m, and keeps the oracle's lattice at (top_m+1, K).
    # At b_min = 0.1/K the bisect's level bracket spans ~1e27, so 42
    # halvings leave its allocation unconverged (its W is the lower one):
    # selections and W are held to it, the allocation to the converged
    # Newton sweep, at the reference test's tolerances.
    sl = slice(0, oracle_cells)
    got = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="pallas_tiled",
                  ranking="topm", top_m=top_m, block_k=block_k)
    ref = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="bisect",
                  ranking="topm", top_m=top_m)
    newton = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="newton",
                     ranking="topm", top_m=top_m)
    check(bool(((ref.num_selected - n0[sl]) < top_m).all()),
          "K2 oracle: the optimum does not fit top_m, pick a smaller V")
    check(torch.equal(got.a, ref.a), "K2 vs bisect: selections differ")
    check(torch.equal(got.num_selected, ref.num_selected), "K2 vs bisect: counts differ")
    check(torch.allclose(got.objective, ref.objective, rtol=W_RTOL, atol=0.0),
          "K2 vs bisect: objective differs")
    check(torch.equal(got.a, newton.a), "K2 vs newton: selections differ")
    check(torch.allclose(got.b, newton.b, rtol=TOPM_B_RTOL, atol=TOPM_B_ATOL),
          f"K2 vs newton: b differs by {(got.b - newton.b).abs().max().item()}")

    finite = torch.isfinite(work).sum(1).clamp(max=top_m)
    counts = torch.minimum(finite, K - n0).tolist()
    ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS) + C * top_m * K_pad * 3
    n_bytes = 4 * (scal.numel() + 2 * work.numel() + wm_k.numel())
    ms = gpu_ms(torch, lambda: ocean_p_topm(scal, work, K=K, top_m=top_m), 10)
    plain_ms = gpu_ms(torch, lambda: ocean_p_topm_plain(scal, work, K=K, top_m=top_m), 2)
    bms, by = bound_ms(n_bytes, ops)
    rec = dict(
        cells=C, K=K, top_m=top_m, max_abs_err_b=err_b, max_rel_err_w=rel_w,
        m_star=wm_k[:, 1].tolist(), oracle_cells=oracle_cells,
        bisect_max_abs_diff_b=(got.b - ref.b).abs().max().item(),
        newton_max_abs_err_b=(got.b - newton.b).abs().max().item(),
        w_minus_bisect_w=(got.objective - ref.objective).tolist(),
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
    )
    emit({"phase": "k2_ocean_p_topm", **{k: v for k, v in rec.items()}})
    return rec


def _grid_args(T, K, seeds):
    from repro_torch.core.scenario import paper_scenarios

    return paper_scenarios(T, K), ["ocean-u", "ocean-a"], range(seeds)


def teacher_forced(torch, dev, cfg, res, p_idx, eta, v):
    """Replay every (cell, round) of policy ``p_idx`` through the plain round
    on the kernel's own q_pre; return the per-round comparison."""
    from repro_torch.core.ocean import OceanState, ocean_round
    from repro_torch.core.selection import prefix_inputs, priorities
    from repro_torch.core.solvers import PALLAS_PLAIN
    from repro_torch.kernels.ocean_p import _scal, prefix_objectives_plain

    P, S, N, T, K = res.a.shape
    CT = S * N * T
    q_pre = res.q[p_idx].reshape(CT, K)
    h2 = res.h2.reshape(CT, K)
    inc = res.budget_inc.reshape(CT, K)
    t_idx = torch.arange(T, device=dev, dtype=torch.int32).repeat(S * N)
    eta_c = eta.repeat(S * N)
    plain_cfg = dataclasses.replace(cfg, solver=PALLAS_PLAIN, traj="scan")
    state = OceanState(q=q_pre, t=t_idx, energy_spent=torch.zeros_like(q_pre))
    nxt, dec = ocean_round(state, h2, v, eta_c, plain_cfg, budget_inc=inc)

    # near-tie margins of the plain version: best minus runner-up W
    rho = priorities(q_pre, h2)
    _, rho_sorted, n0, delta = prefix_inputs(rho, cfg.radio)
    w = prefix_objectives_plain(_scal(n0, delta, v * eta_c, cfg.radio, rho_sorted), rho_sorted)
    top2 = torch.topk(w, 2, dim=1).values
    near = (top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()

    a_k = res.a[p_idx].reshape(CT, K)
    flip = (a_k != dec.a).any(1)
    check(not bool((flip & ~near).any()),
          f"K3: {(flip & ~near).sum().item()} rounds select differently outside near ties")
    ok = ~near
    b_k = res.b[p_idx].reshape(CT, K)
    err_b = (b_k - dec.b).abs()[ok].max().item()
    check(err_b <= B_ATOL, f"K3: max |b - b_plain| = {err_b}")
    ns_k = res.num_selected[p_idx].reshape(CT)
    check(torch.equal(ns_k[ok], dec.num_selected[ok]), "K3: num_selected differs")
    # next round's queues: the kernel's q_pre at t+1 (no reset inside a frame)
    q_next_k = res.q[p_idx].reshape(S * N, T, K)[:, 1:].reshape(-1, K)
    q_next_p = nxt.q.reshape(S * N, T, K)[:, :-1].reshape(-1, K)
    keep = (ok.reshape(S * N, T)[:, :-1] & ((torch.arange(1, T, device=dev) % cfg.R) != 0)).reshape(-1)
    dq = (q_next_k - q_next_p).abs()
    excess = (dq - Q_ATOL - Q_RTOL * q_next_p.abs())[keep]
    if bool((excess > 0).any()):
        row = int(torch.nonzero(keep)[excess.amax(1).argmax()])
        r_src = (row // (T - 1)) * T + row % (T - 1)   # the round that produced it
        k = int(dq[row].argmax())
        detail = dict(
            dq=dq[row, k].item(), q_next=q_next_p[row, k].item(),
            e_plain=dec.e[r_src, k].item(), e_kernel=res.e[p_idx].reshape(CT, K)[r_src, k].item(),
            b_plain=dec.b[r_src, k].item(), b_kernel=b_k[r_src, k].item(),
            n_over=int((excess > 0).sum()), n_compared=int(keep.sum()) * K,
        )
        raise AssertionError(f"K3: next-round queues differ beyond tolerance: {detail}")
    return dict(near_tie_rounds=int(near.sum()), flipped_rounds=int(flip.sum()),
                max_abs_err_b=err_b, near=near.reshape(S * N, T))


def phase_main(torch, np, dev, smi, T=300, K=10, seeds=64):
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.kernels.ocean_p import INNER_ITERS, OUTER_ITERS, ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_traj_plain
    from repro_torch.sim import GridEngine, run_grid

    scen, pols, sd = _grid_args(T, K, seeds)
    run_grid(scen, pols, sd, solver="pallas", traj="fused", device=dev)  # warm-up
    torch.cuda.synchronize()
    for fn in (ocean_p_prefix, ocean_p_topm, ocean_traj):
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_grid(scen, pols, sd, solver="pallas", traj="fused", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ocean_traj": ocean_traj.launches, "ocean_p_prefix": ocean_p_prefix.launches,
                "ocean_p_topm": ocean_p_topm.launches}
    check(launches["ocean_traj"] > 0, "main path: K3 was never launched")
    P, S, N = res.a.shape[:3]
    C = S * N
    for f in ("b", "e", "q"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"main path: non-finite {f}")
    check(tuple(res.a.shape) == (2, 3, seeds, T, K), f"main path: shape {tuple(res.a.shape)}")

    engine = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev)
    cfg = engine.cfg
    v = 1e-5
    tf, nears = {}, []
    for p_idx, pol in enumerate(pols):
        eta = eta_schedule({"ocean-u": "uniform", "ocean-a": "ascend"}[pol], T, device=dev)
        r = teacher_forced(torch, dev, cfg, res, p_idx, eta, v)
        nears.append(r.pop("near"))
        tf[pol] = r

    # K3 alone at the main path's shapes, and its plain version (one run).
    h2c = res.h2.reshape(C, T, K).contiguous()
    inc = res.budget_inc.reshape(C, T, K).contiguous()
    eta_u = eta_schedule("uniform", T, device=dev).expand(C, T).contiguous()
    vv = torch.full((C, T), v, device=dev)
    ms = gpu_ms(torch, lambda: ocean_traj(cfg, h2c, vv, eta_u, inc), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ocean_traj_plain(cfg, h2c, vv, eta_u, inc)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(bool(torch.isfinite(plain.b).all()), "plain K3: non-finite b")

    # Bound from this run's data (policy ocean-u): per cell-round the sweep
    # runs K - n0 candidates; the sort is P log2(P)(log2(P)+1)/4 exchanges.
    rho0 = res.q[0].reshape(C, T, K) / torch.clamp(h2c, min=1e-30)
    counts = (K - (rho0 <= 1e-30).sum(-1)).reshape(-1).tolist()
    Pp = max(32, 1 << (K - 1).bit_length())
    lg = int(math.log2(Pp))
    sort_ops = Pp * lg * (lg + 1) // 4 * 8
    ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS) + C * T * (sort_ops + 30 * K)
    n_bytes = C * T * K * (4 * 2 + 4 * 4 + 1) + C * T * 4 * 4 + C * K * 4 * 2
    bms, by = bound_ms(n_bytes, ops)

    rounds_cells = P * C * T
    e_mean = res.e.sum(-2).mean().item()
    out = dict(
        grid=f"{len(pols)} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
        gpu=smi, launches=launches, wall_s=wall,
        rounds_cells_per_s=rounds_cells / wall,
        k3_rounds_cells_per_s=C * T / (ms / 1e3),
        teacher_forced=tf, k3_ms=ms, k3_plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
    )
    emit({"phase": "k3_main_path", **out})
    emit({"phase": "sanity", "mean_energy_per_client_j": e_mean, "budget_h_j": 0.15,
          "ratio": e_mean / 0.15})
    err = max(r["max_abs_err_b"] for r in tf.values())
    return res, out, err, torch.stack(nears).any(-1)


def phase_scan(torch, dev, smi, res_fused, near_cells, T=300, K=10, seeds=64):
    """K1's path: the same grid through the scan trajectory."""
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj
    from repro_torch.sim import run_grid

    scen, pols, sd = _grid_args(T, K, seeds)
    for fn in (ocean_p_prefix, ocean_p_topm, ocean_traj):
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_grid(scen, pols, sd, solver="pallas", traj="scan", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ocean_p_prefix": ocean_p_prefix.launches, "ocean_traj": ocean_traj.launches}
    check(launches["ocean_p_prefix"] > 0, "scan path: K1 was never launched")
    P, S, N = res.a.shape[:3]
    # One near-tie flip changes q and every later round of its cell, so a
    # cell may differ only if one of its rounds is a near tie.
    near = near_cells.reshape(P, S, N)
    same = (res.a == res_fused.a).flatten(3).all(-1) & (
        res.num_selected == res_fused.num_selected).all(-1)
    check(bool((same | near).all()),
          f"scan vs fused: {int((~same & ~near).sum())} cells differ without a near tie")
    err = (res.b[same] - res_fused.b[same]).abs().max().item()
    check(err <= B_ATOL, f"scan vs fused: max |b| diff {err}")
    out = dict(gpu=smi, launches=launches, wall_s=wall,
               rounds_cells_per_s=P * S * N * T / wall,
               cells=int(same.numel()), cells_identical_decisions=int(same.sum()),
               cells_with_near_tie=int(near.sum()), max_abs_err_b=err)
    emit({"phase": "k1_scan_path", **out})
    return out


def phase_topm_path(torch, dev, K=10_000, T=4, seeds=8, top_m=128):
    """K2's path: the large-K regime through run_grid with pallas_tiled."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj
    from repro_torch.sim import run_grid

    scen = [Scenario(name="large_k", num_clients=K, num_rounds=T,
                     radio=RadioParams(b_min=0.1 / K))]
    for fn in (ocean_p_prefix, ocean_p_topm, ocean_traj):
        fn.launches = 0
    t0 = time.perf_counter()
    res = run_grid(scen, ["ocean-u"], range(seeds), solver="pallas_tiled",
                   ranking="topm", top_m=top_m, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(ocean_p_topm.launches > 0, "top-m path: K2 was never launched")
    for f in ("b", "e"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"top-m path: non-finite {f}")
    check(bool((res.b.sum(-1) <= 1.0 + 1e-4).all()), "top-m path: bandwidth exceeds 1")
    out = dict(launches={"ocean_p_topm": ocean_p_topm.launches}, wall_s=wall,
               mean_selected=res.num_selected.float().mean().item(), K=K, T=T, cells=seeds)
    emit({"phase": "k2_topm_path", **out})
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run it from the "
              f"repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = phase_card(torch)
    k1 = phase_k1(torch, np, dev)
    k2 = phase_k2(torch, np, dev)
    res, main_out, k3_err, near_cells = phase_main(torch, np, dev, smi)
    scan = phase_scan(torch, dev, smi, res, near_cells)
    topm = phase_topm_path(torch, dev)

    k1_main = k1[10]
    kernels = [
        dict(name="ocean_p_prefix", route="cuda", source="src/repro_torch/csrc/ocean_p.cu",
             replaces="src/repro/kernels/ocean_p.py:48",
             launches=scan["launches"]["ocean_p_prefix"],
             max_abs_err=max(r["max_abs_err_b"] for r in k1.values()),
             ms=k1_main["ms"], plain_ms=k1_main["plain_ms"], bound_ms=k1_main["bound_ms"],
             bound_by=k1_main["bound_by"], library_ms=None),
        dict(name="ocean_p_topm", route="cuda", source="src/repro_torch/csrc/ocean_p.cu",
             replaces="src/repro/kernels/ocean_p.py:232",
             launches=topm["launches"]["ocean_p_topm"], max_abs_err=k2["max_abs_err_b"],
             ms=k2["ms"], plain_ms=k2["plain_ms"], bound_ms=k2["bound_ms"],
             bound_by=k2["bound_by"], library_ms=None),
        dict(name="ocean_traj", route="cuda", source="src/repro_torch/csrc/ocean_traj.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=main_out["launches"]["ocean_traj"], max_abs_err=k3_err,
             ms=main_out["k3_ms"], plain_ms=main_out["k3_plain_ms"],
             bound_ms=main_out["bound_ms"], bound_by=main_out["bound_by"], library_ms=None),
    ]
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
