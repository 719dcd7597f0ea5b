#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from ``src/repro_torch/csrc`` with nvcc, holds
each against its plain PyTorch version on the card, drives OCEAN's main
path through the user entry point ``run_grid`` (the paper's §VI grid:
3 scenarios x 64 seeds, K = 10, T = 300, through kernel K3), replays every
(cell, round) of it against the plain round, holds K3 alone to its plain
version at K = 100 and K = 2048, and drives the paths of K1 (the scan
trajectory) and K2 (the sort-free top-m solve at K = 10^4, one cluster
of CTAs per cell) with the launch counters reset just before and read
just after.

Then the LM serving path at gemma2-27b's full width and depth (46 layers,
27.2e9 random bf16 parameters from a seed): K4 and K5 against their plain
versions at the model's shapes (K4 also at jamba-1.5-large's attention
layer, and with gemma2's soft-cap removed, which isolates the soft-cap's
error), ``make_prefill_step`` on one 8192-token prompt through K4 (one
launch per layer; the kernel path held to the plain path at 2 full-width
layers), and the ``launch/serve.py`` loop (batch 4, prompt 32, 32 new
tokens), after which K5 runs on every
layer's cache at the last position, on the inputs the decode step gave
its attention there, and is held to what that attention computed.

Then the recurrent LMs: K7 and K6 against their plain versions at the
rwkv6 prefill shape (8 x 8192, 32 heads of 64) and at one 4096-channel
block of jamba's Mamba mixer; rwkv6-1.6b at full width and depth (24
layers, 1.58e9 parameters) through ``make_prefill_step`` on 8 x 8192
tokens (K7 once per layer; each of the first 2 layers' K7 call held to
the plain version with planted faults, the kernel path to the plain
path, and the float32 prefill to the token-by-token decode of a
256-token prompt) and the serve loop; jamba-1.5-large-398b at full width
cut to its first 5 layers (24.05e9 parameters) through
``make_prefill_step`` on 1 x 8192 tokens (K6 once per Mamba layer and
4096-channel block, K4 on the attention layer, every call held to its
plain version, the kernel path to the plain path) and the serve loop.

Then the telemetry (``repro_torch.obs``): the §VI grid with a spec of
every collector and reduction through K3's HasMetrics instances (its
decisions bit for bit those of the metrics-off grid, its telemetry held to
the replay of the kernel's own rows), the same spec on the scan path, one
HasMetrics launch of each radio, failure, guard, bisect and chaos instance,
K = 2048 with the region in shared and in global memory, and a planted
fault that must fail.

Each phase prints one JSON line; any failed check raises and the script
exits non-zero.  The last lines are the card's name and power limit, the
``kernels`` record (time on the card, plain version's time, bound, launches
and error of every kernel, and the time of one library call computing the
same function where there is one: ``flex_attention`` for K4 and K5; every
kernel also carries ``device_ms``, the profiler's kernel time per call,
and K4/K5 flex_attention's as ``library_device_ms``; K7 also carries
``yardstick_ms``, the JAX package's chunked matrix form of the WKV scan
in eager PyTorch), and ``{"ok": true, "device": {...}}``.  It
needs a CUDA device and the repository's ``src/`` beside it, and imports
nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import json
import math
import os
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

# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, dense
# bf16 on the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# Attention kernels (bf16 in, f32 inside, bf16 out) vs their plain
# versions, which round their probabilities to bf16 before the second
# product: tests/test_kernels.py's bf16 tolerance, |d| <= atol + rtol |plain|
# (one bf16 ulp of an output near 4 is 2^-5).
ATT_ATOL = ATT_RTOL = 2e-2
# Kernel path vs plain path through 2 full-width gemma2 layers in bf16:
# relative L2 error of the final hidden states and of the logits.  One
# bf16 rounding is 2^-9 relative; the two paths round attention outputs
# differently and the difference passes through two residual layers.  At
# random init the attention branch is a few percent of the residual, so
# this reading alone cannot see a wrong attention: each layer's attention
# output is also held, on that layer's own q/k/v, element-wise to
# ATT_ATOL/ATT_RTOL and in relative L2 to ATT_REL.  The layer's outputs
# are ~1/sqrt(keys) ~ 0.02, where ATT_ATOL alone admits 100% error; the
# L2 limit is set by bf16: each output rounds to within 2^-9 relative in
# both paths and the probabilities round to bf16 in both (about 2e-3 of
# L2 each), so 1e-2 leaves room.  Planted faults (zeros; the window
# dropped on a local layer) must fail that test.
MODEL_REL = 2e-2
ATT_REL = 1e-2

# K7 (WKV) and K6 (selective scan): float32 kernels vs float32 plain
# versions, which differ in summation order and FMA contraction.
# tests/test_kernels.py's tolerances: 5e-4 for the WKV scan, 2e-4 for the
# selective scan.  The WKV state at the model's decays (w ~ 0.995) sums
# ~200 steps, so its rounding is of the size of the typical output even
# where an output cancels to near 0: |d| <= WKV_TOL (|plain| + rms(plain)).
# The selective scan: |d| <= MAMBA_TOL + MAMBA_TOL |plain|.  Both also in
# relative L2, where float32 rounding gives ~1e-6: SCAN_REL = 1e-4, which
# the planted faults (u dropped, the decay ignored, C zeroed) must exceed.
WKV_TOL = 5e-4
MAMBA_TOL = 2e-4
SCAN_REL = 1e-4
# rwkv6 prefill through K7 vs token-by-token decode (plain recurrence) of
# the same prompt, float32 at full width: relative L2 of the last
# logits.  Both paths compute the same float32 function in another order.
CROSS_REL = 1e-4

# Operation counts of the shared device code, counted from
# csrc/ocean_common.cuh: every add, multiply, compare, select, min/max,
# division, square root, exp2f and log2f counts as ONE operation.
OPS_F_PRIME = 9
OPS_F_SECOND = 11
OPS_F_SHANNON = 7
# f''(b) reuses f'(b)'s max, division, clip and exp2 inside b_of_lam's step.
OPS_NEWTON_STEP = OPS_F_PRIME + (OPS_F_SECOND - 4) + 12
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


def ops_sweep(counts, outer, inner, candidate=None):
    """Sum over cells of the candidates this data makes the sweep run;
    ``counts`` is a list of per-cell numbers of evaluated candidates;
    ``candidate`` (default ``ops_candidate``) counts one candidate."""
    candidate = ops_candidate if candidate is None else candidate
    return sum(f * sum(candidate(m, outer, inner) for m in range(1, n + 1))
               for n, f in collections.Counter(counts).items())


def ops_b_of_lam_bisect(inner):
    """b(lam) by bisection: target, then per halving the midpoint, f', the
    compare and two selects, then the last midpoint."""
    return 3 + inner * (2 + OPS_F_PRIME + 3) + 2


def ops_bisect_sweep(counts):
    """``ops_sweep`` of the bisect sweep at K3's halvings."""
    from repro_torch.kernels.ocean_traj import BISECT_ITERS

    return ops_sweep(counts, BISECT_ITERS, BISECT_ITERS, ops_candidate_bisect)


def ops_candidate_bisect(m, outer, inner):
    """One candidate of the bisect sweep with m members: ``outer`` budget
    halvings and the final allocation (43 bisections of b(lam) a member,
    each ``inner`` f' evaluations), then candidate_w's repair."""
    per_outer = m * (ops_b_of_lam_bisect(inner) + 1) + 6
    final = m * (ops_b_of_lam_bisect(inner) + 1)
    repair = m * (4 + 8 + OPS_F_SHANNON + 2) + 12
    setup = m + 12 + OPS_F_PRIME
    return setup + outer * per_outer + final + repair + 4


def bound_ms(n_bytes, n_ops, peak_flops=PEAK_F32_FLOPS):
    t_bytes = n_bytes / PEAK_HBM_BYTES
    t_ops = n_ops / peak_flops
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


# Host time the profiler's window holds on each side of the calls it reads.
# The profiler keeps only the kernels that it places inside its window, and
# places them by a clock that drifts from the window's as the process ages:
# on the H100, readings late in a long run kept 30-50 % of the launches, and
# once none.  Idle time on both sides keeps the drifted kernels inside.
PROFILE_PAD_S = (0.25, 2.0)


@contextlib.contextmanager
def profiled(torch, pad_s):
    """A ``torch.profiler`` window over the block, with ``pad_s`` seconds of
    idle host time before and after it (see ``PROFILE_PAD_S``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        yield prof
        torch.cuda.synchronize()
        time.sleep(pad_s)


def device_ms(torch, fn, reps):
    """Device time per call of ``fn`` from a ``torch.profiler`` reading of
    ``reps`` calls (after one warm-up): each kernel's mean duration times
    the times one call launches it (its count over ``reps``, rounded up),
    summed; also by kernel, and the share of those launches the reading
    recorded.  Unlike ``gpu_ms`` it leaves out the host and the gaps
    between kernels.  Means, not sums over the calls, so that a reading
    that misses some records is still a kernel's time.  A reading that
    misses any is taken again with a wider window (``PROFILE_PAD_S``); if
    the profiler still sees no kernel, the time is the median over
    ``reps`` calls of CUDA events around one call (host launch gap
    included), ``by_kernel`` is ``{"cuda_events": ms}`` and the share
    seen is 0."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for pad in PROFILE_PAD_S:
        with profiled(torch, pad) as prof:
            for _ in range(reps):
                fn()
        by_kernel, seen, launched = {}, 0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.count == 0:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                per_call = math.ceil(e.count / reps)
                name = kernel_class(e.key)
                name = e.key[:80] if name == "other" else name
                by_kernel[name] = by_kernel.get(name, 0.0) + us / e.count / 1e3 * per_call
                seen, launched = seen + e.count, launched + per_call * reps
        if by_kernel and seen == launched:
            break
    if by_kernel:
        return sum(by_kernel.values()), by_kernel, seen / launched
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
    ms = sorted(times)[len(times) // 2]
    return ms, {"cuda_events": ms}, 0.0


def clocks():
    """The card's SM and memory clocks, power draw and temperature as
    ``nvidia-smi`` reads them now (a reading beside a timing window)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.mem,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not readable"


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


def phase_k1(torch, np, dev, smi, C=192, Ks=(10, 100)):
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
        dev_ms, _, seen = device_ms(torch, lambda: ocean_p_prefix(scal, rho), 20)
        plain_ms = gpu_ms(torch, lambda: ocean_p_prefix_plain(scal, rho), 3)
        bms, by = bound_ms(n_bytes, ops)
        rec[K] = dict(
            cells=C, K=K, max_abs_err_b=err_b, max_rel_err_w=rel_w,
            mean_m_star=m_k.mean().item(), ms=ms, device_ms=dev_ms,
            device_records_seen=seen, plain_ms=plain_ms,
            bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
        )
    emit({"phase": "k1_ocean_p_prefix", "gpu": smi, "results": rec})
    return rec


def _k2_inputs(torch, np, dev, C, K, v, eta, block_k):
    """Seeded K2 inputs: queues and gains with twin near ties, the client
    row padded with +inf to a ``block_k`` multiple, and ``scal``."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.selection import _RHO_ZERO_TOL, priorities
    from repro_torch.kernels.ocean_p import _scal

    radio = RadioParams(b_min=0.1 / K)
    q, h2 = draws(np, np.random.default_rng(2024), C, K, tie_eps=1e-4)
    qt, ht = torch.tensor(q, device=dev), torch.tensor(h2, device=dev)
    rho = priorities(qt, ht)
    n0 = (rho <= _RHO_ZERO_TOL).sum(1)
    delta = 1.0 - n0.to(torch.float32) * radio.b_min
    work = torch.where(rho > _RHO_ZERO_TOL, rho, torch.inf)
    work = torch.nn.functional.pad(work, (0, -K % block_k), value=torch.inf).contiguous()
    scal = _scal(n0, delta, torch.full((C,), v * eta, device=dev), radio, rho)
    return scal, work, qt, ht, n0, radio


def phase_k2(torch, np, dev, smi, C=8, K=10_000, top_m=128, block_k=128, oracle_cells=2):
    from repro_torch.core.selection import ocean_p
    from repro_torch.kernels.ocean_p import (
        INNER_ITERS, OUTER_ITERS, ocean_p_topm, ocean_p_topm_plain, topm_shape,
    )

    v, eta = 1e-5, 1.0
    scal, work, qt, ht, n0, radio = _k2_inputs(torch, np, dev, C, K, v, eta, block_k)
    K_pad = work.shape[1]

    b_k, wm_k = ocean_p_topm(scal, work, K=K, top_m=top_m)
    b_p, wm_p = ocean_p_topm_plain(scal, work, K=K, top_m=top_m)
    check(torch.equal(wm_k[:, 1], wm_p[:, 1]), "K2: m* differs from the plain version")
    check(torch.equal(b_k > 0, b_p > 0), "K2: selections differ from the plain version")
    err_b = (b_k - b_p).abs().max().item()
    rel_w = ((wm_k[:, 0] - wm_p[:, 0]).abs() / wm_p[:, 0].abs()).max().item()
    check(err_b <= B_ATOL, f"K2: max |b - b_plain| = {err_b}")
    check(rel_w <= W_RTOL, f"K2: max rel W error = {rel_w}")
    # Every cluster size computes the same bits: the extraction is exact
    # and each candidate is one warp's work wherever it runs.
    for R in (16, 4, 2):
        b_r, wm_r = ocean_p_topm(scal, work, K=K, top_m=top_m, cluster=R)
        check(torch.equal(b_r, b_k) and torch.equal(wm_r, wm_k),
              f"K2: clusters of {R} compute other bits than the chosen shape")

    # The sort + bisect oracle on a few cells.  Its sweep clipped to the
    # top_m best candidates (ranking="topm") equals the full sorted sweep
    # whenever m* < top_m, and keeps the oracle's lattice at (top_m+1, K).
    # At b_min = 0.1/K the bisect's level bracket spans ~1e27, so 42
    # halvings leave its allocation unconverged (its W is the lower one):
    # selections and W are held to it, the allocation to the converged
    # Newton sweep, at the reference test's tolerances.  The K1 path
    # (solver="pallas", ranking="topm") runs each candidate through the
    # same warp body on the same extracted values, so it gives K2's bits.
    sl = slice(0, oracle_cells)
    got = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="pallas_tiled",
                  ranking="topm", top_m=top_m, block_k=block_k)
    ref = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="bisect",
                  ranking="topm", top_m=top_m)
    newton = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="newton",
                     ranking="topm", top_m=top_m)
    k1 = ocean_p(qt[sl], ht[sl], v, eta, radio, solver="pallas",
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
    for f in ("a", "num_selected", "b", "objective"):
        check(torch.equal(getattr(got, f), getattr(k1, f)),
              f"K2 vs the K1 top-m path: {f} differs")

    finite = torch.isfinite(work).sum(1).clamp(max=top_m)
    counts = torch.minimum(finite, K - n0).tolist()
    # one pass over the row: its key, a compare against the running list
    ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS) + C * K_pad * 3
    n_bytes = 4 * (scal.numel() + 2 * work.numel() + wm_k.numel())
    call = lambda: ocean_p_topm(scal, work, K=K, top_m=top_m)  # noqa: E731
    ms = gpu_ms(torch, call, 10)
    dev_ms, _, seen = device_ms(torch, call, 10)
    plain_ms = gpu_ms(torch, lambda: ocean_p_topm_plain(scal, work, K=K, top_m=top_m), 2)
    bms, by = bound_ms(n_bytes, ops)
    shape = topm_shape(C, K_pad, top_m)
    # The cluster size read both ways: 16 CTAs of fewer warps, 8 of more.
    by_cluster = {}
    for R in (16, 8):
        sh = topm_shape(C, K_pad, top_m, R)
        by_cluster[R] = dict(nw=sh.nw, cap=sh.cap, device_ms=device_ms(
            torch, lambda R=R: ocean_p_topm(scal, work, K=K, top_m=top_m, cluster=R), 10)[0])
    # The fixed cost: the extraction and one candidate of one member.
    top_m1_ms = device_ms(torch, lambda: ocean_p_topm(scal, work, K=K, top_m=1), 10)[0]
    rec = dict(
        cells=C, K=K, top_m=top_m, cluster=shape.R, warps=shape.nw, cap=shape.cap,
        max_abs_err_b=err_b, max_rel_err_w=rel_w,
        m_star=wm_k[:, 1].tolist(), oracle_cells=oracle_cells,
        bisect_max_abs_diff_b=(got.b - ref.b).abs().max().item(),
        newton_max_abs_err_b=(got.b - newton.b).abs().max().item(),
        w_minus_bisect_w=(got.objective - ref.objective).tolist(),
        ms=ms, device_ms=dev_ms, device_records_seen=seen, by_cluster=by_cluster,
        top_m1_device_ms=top_m1_ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
    )
    emit({"phase": "k2_ocean_p_topm", "gpu": smi, **rec})
    return rec


def _grid_args(T, K, seeds):
    from repro_torch.core.scenario import paper_scenarios

    return paper_scenarios(T, K), ["ocean-u", "ocean-a"], range(seeds)


def teacher_forced(torch, dev, cfg, res, p_idx, eta, v, radio=None, failure=None, obj=None):
    """Replay every (cell, round) of policy ``p_idx`` through the plain round
    on the kernel's own q_pre; return the per-round comparison.  ``radio``
    (a TracedRadio of (S, N, T) leaves) and ``failure`` (a TracedFailure of
    (S, N, T, K) masks and (S, N, K) rates) are the grid's streams; with a
    failure process the delivery masks and reallocation flags must agree
    too, and ``committed`` (the plain mode's count) is returned.  ``obj``
    (the kernel's (S * N * T,) P3 values on the same queues) must lie within
    W_RTOL x (|P3| + v eta) of the plain round's: relative to the value,
    with one client's utility as the floor where the value is near 0."""
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
    rows = cfg.radio if radio is None else radio.map(lambda x: x.reshape(CT))
    kw = {"radio": None if radio is None else rows}
    if failure is not None:
        kw["delivered"] = failure.delivered.reshape(CT, K)
        kw["fail_rate"] = failure.rate[:, :, None, :].expand(S, N, T, K).reshape(CT, K)
    state = OceanState(q=q_pre, t=t_idx, energy_spent=torch.zeros_like(q_pre))
    nxt, dec = ocean_round(state, h2, v, eta_c, plain_cfg, budget_inc=inc, **kw)

    # near-tie margins of the plain version: best minus runner-up W
    rho = priorities(q_pre, h2)
    _, rho_sorted, n0, delta = prefix_inputs(rho, rows)
    w = prefix_objectives_plain(_scal(n0, delta, v * eta_c, rows, rho_sorted), rho_sorted)
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
    out = {}
    if obj is not None:
        rel = ((obj - dec.objective).abs() / (dec.objective.abs() + v * eta_c))[ok].max().item()
        check(rel <= W_RTOL, f"K3: P3 value off the plain round's by {rel} (relative)")
        out["max_rel_err_obj"] = rel
    if failure is not None:
        dlv_k = res.delivered[p_idx].reshape(CT, K)
        check(torch.equal(dlv_k[ok], dec.delivered[ok]), "K3: delivered differs from the plain round")
        committed = ocean_round(state, h2, v, eta_c, dataclasses.replace(
            plain_cfg, failure_mode="plain"), budget_inc=inc, **kw)[1].num_selected
        out["committed"] = committed.reshape(S * N, T)
        out["realloc"] = dec.realloc.reshape(S * N, T)
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
                max_abs_err_b=err_b, near=near.reshape(S * N, T), **out)


def phase_main(torch, np, dev, smi, k1_device_ms, T=300, K=10, seeds=64):
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
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
    dev_ms, _, seen = device_ms(torch, lambda: ocean_traj(cfg, h2c, vv, eta_u, inc), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ocean_traj_plain(cfg, h2c, vv, eta_u, inc)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    check(bool(torch.isfinite(plain.b).all()), "plain K3: non-finite b")

    # Bound from this run's data (policy ocean-u).
    bms, by, ops, n_bytes = k3_bound(torch, res.q[0].reshape(C, T, K) / torch.clamp(h2c, min=1e-30))

    rounds_cells = P * C * T
    e_mean = res.e.sum(-2).mean().item()
    out = dict(
        grid=f"{len(pols)} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
        gpu=smi, launches=launches, wall_s=wall,
        rounds_cells_per_s=rounds_cells / wall,
        k3_rounds_cells_per_s=C * T / (ms / 1e3),
        teacher_forced=tf, k3_ms=ms, k3_device_ms=dev_ms, k3_device_records_seen=seen,
        # the chain floor of K3's candidate body: T rounds of K1 at this shape
        t_x_k1_ms=T * k1_device_ms, k3_plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
    )
    emit({"phase": "k3_main_path", **out})
    emit({"phase": "sanity", "gpu": smi, "mean_energy_per_client_j": e_mean, "budget_h_j": 0.15,
          "ratio": e_mean / 0.15})
    err = max(r["max_abs_err_b"] for r in tf.values())
    return res, out, err, torch.stack(nears).any(-1)


def ops_waterfill(n, outer, inner, grid):
    """One masked P4 of n members (ocean_common.cuh, masked_waterfill)."""
    setup = 3 * n + 20 + 2 * OPS_F_PRIME
    levels = grid * (n * (ops_b_of_lam(inner) + 1) + 8)
    per_outer = n * (ops_b_of_lam(inner) + 1 + 2 + OPS_F_SECOND + 4) + 14
    final = n * (ops_b_of_lam(inner) + 1) + n * (4 + 8) + 12
    return setup + levels + outer * per_outer + final


def k3_bound(torch, rho, radio=False, failure=False, solves=(), bisect=False, guard=False,
             fallback=None):
    """K3's bound on (C, T, K) priorities: per cell-round the sweep runs
    K - n0 candidates (K1's Newton, or with ``bisect`` the bisect sweep);
    the sort is P log2(P)(log2(P)+1)/4 exchanges.  The streamed-radio
    instance also reads 3 floats a cell-round; the failure instance reads
    the (C, T, K) mask and (C, K) rates, writes the delivered mask and the
    reallocation flags, and runs one masked P4 for each member count in
    ``solves`` (the re-solves this run's data needed).  The guarded
    instance reads the (K,) caps, writes three ints a cell-round, screens
    and validates each round (~20 K operations) and runs the bisect sweep
    again on the (C, T) rounds ``fallback`` marks.  Returns (bound ms, what
    bounds it, operations, bytes)."""
    from repro_torch.core.solvers import newton_iteration_budgets
    from repro_torch.kernels.ocean_p import INNER_ITERS, OUTER_ITERS

    C, T, K = rho.shape
    per_round = K - (rho <= 1e-30).sum(-1)
    counts = per_round.reshape(-1).tolist()
    Pp = max(32, 1 << (K - 1).bit_length())
    lg = int(math.log2(Pp))
    sort_ops = Pp * lg * (lg + 1) // 4 * 8
    if bisect:
        ops = ops_bisect_sweep(counts)
    else:
        ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS)
    ops += C * T * (sort_ops + 30 * K)
    n_bytes = C * T * K * (4 * 2 + 4 * 4 + 1) + C * T * 4 * 4 + C * K * 4 * 2
    if guard:
        n_bytes += K * 4 + C * T * 3 * 4
        ops += C * T * 20 * K
        if fallback is not None:
            ops += ops_bisect_sweep(per_round[fallback.bool()].tolist())
    if radio:
        n_bytes += C * T * 3 * 4
    if failure:
        n_bytes += C * T * K * (4 + 1) + C * T * 4 + C * K * 4
        wf = newton_iteration_budgets(torch.float32, K)
        ops += C * T * 10 * K + sum(ops_waterfill(n, *wf) for n in solves)
    return (*bound_ms(n_bytes, ops), ops, n_bytes)


def _k3_inputs(torch, np, dev, C, T, K, seed):
    """Seeded K3 inputs at any K: exponential gains, b_min = min(0.02,
    0.5/K) so that every client fits the band, frames of 13 rounds, the
    per-round budget share, V = 1e-5 and the ascending eta schedule."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import OceanConfig
    from repro_torch.core.patterns import eta_schedule

    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(b_min=min(0.02, 0.5 / K)),
                      frame_len=13, solver="pallas", traj="fused")
    h2 = torch.tensor(
        np.random.default_rng(seed).exponential(size=(C, T, K)).astype(np.float32) * 2.5e-4,
        device=dev)
    v = torch.full((C, T), 1e-5, device=dev)
    eta = eta_schedule("ascend", T, device=dev).expand(C, T).contiguous()
    return cfg, h2, v, eta, torch.full_like(h2, 0.15 / T)


def phase_k3_large(torch, np, dev, smi, cases=((100, 16, 40), (2048, 2, 3))):
    """K3 beyond a warp's width against its plain version, whole
    trajectories: K = 100 (more candidates than a block has warps) and
    K = 2048 (the warps cut by the shared-memory limit); each with its
    time, its plain version's and its bound."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_traj_plain

    lib = _build.load("ocean_traj")
    rec = {}
    for K, C, T in cases:
        args = _k3_inputs(torch, np, dev, C, T, K, seed=K)
        out = ocean_traj(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ocean_traj_plain(*args)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        check(torch.equal(out.a, plain.a), f"K3 K={K}: selections differ from the plain version")
        check(torch.equal(out.nsel, plain.nsel), f"K3 K={K}: nsel differs from the plain version")
        err_b = (out.b - plain.b).abs().max().item()
        check(err_b <= B_ATOL, f"K3 K={K}: max |b - b_plain| = {err_b}")
        dq = (out.q_final - plain.q_final).abs()
        over = (dq - Q_ATOL - Q_RTOL * plain.q_final.abs()).max().item()
        check(over <= 0, f"K3 K={K}: final queues differ by {dq.max().item()}")
        bms, by, ops, n_bytes = k3_bound(torch, out.rho)
        rec[K] = dict(cells=C, T=T, warps=lib.ocean_traj_warps(K, 0), max_abs_err_b=err_b,
                      max_abs_err_q_final=dq.max().item(),
                      mean_selected=out.nsel.float().mean().item(),
                      ms=gpu_ms(torch, lambda: ocean_traj(*args), 3), plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes)
    emit({"phase": "k3_large_K", "gpu": smi, "results": rec})
    return rec


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
    # Where the scan's wall goes: device busy and idle share, K1's share.
    try:
        prof = profile_call(torch, lambda: run_grid(scen, pols, sd, solver="pallas",
                                                    traj="scan", device=dev))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, launches=launches, wall_s=wall,
               rounds_cells_per_s=P * S * N * T / wall,
               cells=int(same.numel()), cells_identical_decisions=int(same.sum()),
               cells_with_near_tie=int(near.sum()), max_abs_err_b=err, profile=prof)
    emit({"phase": "k1_scan_path", **out})
    return out


def phase_topm_path(torch, dev, smi, K=10_000, T=4, seeds=8, top_m=128):
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
    out = dict(gpu=smi, launches={"ocean_p_topm": ocean_p_topm.launches}, wall_s=wall,
               mean_selected=res.num_selected.float().mean().item(), K=K, T=T, cells=seeds)
    emit({"phase": "k2_topm_path", **out})
    return out


# ---------------------------------------------------------------------------
# the environment processes: the reliability grid, the radio grid, and the
# paper's baselines
# ---------------------------------------------------------------------------
# The failure cells of benchmarks/reliability_sweep.py:52-59 and the radio
# lattice of benchmarks/radio_sweep.py:26-31.
FAILURE_CELLS = (
    ("drop_light", "iid_dropout", {"p_deliver": 0.9}),
    ("drop_heavy", "iid_dropout", {"p_deliver": 0.7}),
    ("burst_light", "markov_availability", {"p_fail": 0.1, "p_recover": 0.4}),
    ("burst_heavy", "markov_availability", {"p_fail": 0.3, "p_recover": 0.3}),
    ("strag_light", "straggler_slowdown", {"sigma": 0.5, "compute_frac": 0.8}),
    ("strag_heavy", "straggler_slowdown", {"sigma": 0.8, "compute_frac": 0.6}),
)
BANDWIDTHS_HZ = (5e6, 10e6, 20e6)
DEADLINES_S = (0.15, 0.3, 0.6)
OCEAN_FAILURE_MODES = {"ocean-u": "plain", "ocean-over": "overprovision",
                       "ocean-realloc": "reallocate"}
V_PAPER = 1e-5
INSTANCE_KEYS = ("ms", "device_ms", "plain_ms", "plain_rounds", "bound_ms", "bound_by")


def _reset_counts():
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj

    for fn in (ocean_p_prefix, ocean_p_topm, ocean_traj):
        fn.launches = 0
    ocean_traj.instances.clear()


def _counts():
    from repro_torch.kernels.ocean_p import ocean_p_prefix, ocean_p_topm
    from repro_torch.kernels.ocean_traj import ocean_traj

    return {"ocean_traj": ocean_traj.launches, "ocean_p_prefix": ocean_p_prefix.launches,
            "ocean_p_topm": ocean_p_topm.launches,
            "ocean_traj_instances": dict(ocean_traj.instances)}


def _timed_grid(torch, dev, scen, pols, seeds):
    """A warm-up of the OCEAN policies (the ones that launch K3) on 2 seeds,
    then the grid between reset and read counts."""
    from repro_torch.core.policy import PolicyParams
    from repro_torch.sim import run_grid

    specs = [(p, PolicyParams(v=V_PAPER)) for p in pols]
    warm = [sp for sp in specs if sp[0].startswith("ocean")]
    run_grid(scen, warm, range(2), solver="pallas", traj="fused", device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = run_grid(scen, specs, range(seeds), solver="pallas", traj="fused", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return res, wall, _counts()


def _k3_args(torch, cfg, res, radio=None, failure=None, v=V_PAPER):
    """K3's arguments for a grid's cells under ocean-u's schedule."""
    from repro_torch.core.patterns import eta_schedule

    S, N, T, K = res.h2.shape
    C = S * N
    dev = res.h2.device
    h2c = res.h2.reshape(C, T, K).contiguous()
    inc = res.budget_inc.reshape(C, T, K).contiguous()
    eta = eta_schedule("uniform", T, device=dev).expand(C, T).contiguous()
    vv = torch.full((C, T), v, device=dev)
    return (cfg, h2c, vv, eta, inc, radio, failure)


def _k3_replayed_obj(torch, res, p_idx, args):
    """K3 once more on the grid's cells (a comparison launch): the same
    launch gives the grid's bits, so its P3 values belong to the queues
    that ``teacher_forced`` replays; returns them as (S * N * T,)."""
    from repro_torch.kernels.ocean_traj import ocean_traj

    out = ocean_traj(*args)
    for f, g in (("a", "a"), ("b", "b"), ("q_pre", "q")):
        check(torch.equal(getattr(out, f), getattr(res, g)[p_idx].reshape(out.a.shape)),
              f"K3: a launch on the grid's cells differs from the grid's run ({f})")
    return out.obj.reshape(-1)


def _k3_alone(torch, args, plain_rounds=10):
    """K3 alone on a grid's cells (``_k3_args``): device ms and ms, and the
    plain version's ms over the first ``plain_rounds`` rounds (its time is
    the rounds' host loop, ~70 ms a round whatever the cells)."""
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_traj_plain

    cfg, h2c, vv, eta, inc, radio, failure = args
    dev_ms, _, seen = device_ms(torch, lambda: ocean_traj(*args), 3)
    n = plain_rounds
    head = (cfg, h2c[:, :n], vv[:, :n], eta[:, :n], inc[:, :n],
            None if radio is None else radio.map(lambda x: x[:, :n]),
            None if failure is None else failure._replace(delivered=failure.delivered[:, :n]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ocean_traj_plain(*head)
    torch.cuda.synchronize()
    return dict(ms=gpu_ms(torch, lambda: ocean_traj(*args), 3), device_ms=dev_ms,
                device_records_seen=seen, plain_ms=1e3 * (time.perf_counter() - t0),
                plain_rounds=n)


def _cells(res, C, T, radio=None, failure=None):
    """The grid's (S, N, ...) streams as K3's (C, ...) cell streams."""
    from repro_torch.env.failure import TracedFailure

    r = None if radio is None else radio.map(lambda x: x.reshape(C, T).contiguous())
    f = None
    if failure is not None:
        K = failure.rate.shape[-1]
        f = TracedFailure(delivered=failure.delivered.reshape(C, T, K).contiguous(),
                          rate=failure.rate.reshape(C, K).contiguous())
    return r, f


def phase_reliability(torch, np, dev, smi, T=300, K=10, seeds=64):
    """The reliability grid (a clean cell and six failure cells, the paper's
    §VI settings) through K3's failure instances, one launch per OCEAN
    variant, with SMO and AMO beside them; every OCEAN variant's rounds
    replayed against the plain round.  Returns the phase's record and K3's
    arguments on the grid's cells by failure mode."""
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.env import EnvSpec
    from repro_torch.sim import GridEngine

    scen = [Scenario(name="clean", num_rounds=T, num_clients=K)] + [
        Scenario(name=n, num_rounds=T, num_clients=K, env=EnvSpec(failure=p, failure_params=pp))
        for n, p, pp in FAILURE_CELLS
    ]
    pols = ["ocean-u", "ocean-over", "ocean-realloc", "smo", "amo"]
    res, wall, launches = _timed_grid(torch, dev, scen, pols, seeds)
    check(launches["ocean_traj"] == 3, f"reliability grid: K3 launched {launches}")
    check(launches["ocean_traj_instances"]
          == {f"failure/{m}": 1 for m in OCEAN_FAILURE_MODES.values()},
          f"reliability grid: K3 instances {launches['ocean_traj_instances']}")
    P, S, N = res.a.shape[:3]
    C = S * N
    for f in ("b", "e", "q"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"reliability grid: non-finite {f}")
    check(bool((res.delivered <= res.a).all()), "reliability grid: delivered is not a submask of a")
    check(torch.equal(res.delivered[:, 0], res.a[:, 0]), "reliability grid: clean cell lost updates")
    for p in (1, 2):
        for f in ("a", "b", "e", "q"):
            check(torch.equal(getattr(res, f)[0, 0], getattr(res, f)[p, 0]),
                  f"reliability grid: {pols[p]} differs from ocean-u in the clean cell ({f})")
    rates = {}
    for s, (name, _, _) in enumerate(FAILURE_CELLS, start=1):
        cell_means = res.failure_seq.delivered[s].double().mean((1, 2))
        se = float(cell_means.std()) / math.sqrt(N)
        got, declared = float(cell_means.mean()), float(res.failure_seq.rate[s].double().mean())
        check(abs(got - declared) <= 3.0 * se,
              f"reliability grid: {name} delivers {got}, declared {declared} (se {se})")
        rates[name] = dict(realized=got, declared=declared, se=se)

    engine = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev)
    eta = eta_schedule("uniform", T, device=dev)
    _, fail = _cells(res, C, T, failure=res.failure_seq)
    rho = res.q[:3].reshape(3, C, T, K) / torch.clamp(res.h2.reshape(C, T, K), min=1e-30)
    n0 = (rho <= 1e-30).sum(-1)
    variants, errs, k3_args = {}, [], {}
    for p_idx, pol in enumerate(pols[:3]):
        cfg = dataclasses.replace(engine.cfg, failure_mode=OCEAN_FAILURE_MODES[pol])
        args = k3_args[cfg.failure_mode] = _k3_args(torch, cfg, res, failure=fail)
        r = teacher_forced(torch, dev, cfg, res, p_idx, eta, V_PAPER, failure=res.failure_seq,
                           obj=_k3_replayed_obj(torch, res, p_idx, args))
        r.pop("near")
        nsel = res.num_selected[p_idx].reshape(C, T)
        if pol == "ocean-over":
            resolved = nsel != r.pop("committed")
            solves = (nsel - n0[p_idx])[resolved].tolist()
        elif pol == "ocean-realloc":
            r.pop("committed")
            surv = res.delivered[p_idx].reshape(C, T, K) & (rho[p_idx] > 1e-30)
            solves = surv.sum(-1)[r["realloc"] > 0].tolist()
        else:
            r.pop("committed")
            solves = []
        r.pop("realloc")
        errs.append(r["max_abs_err_b"])
        bms, by, ops, n_bytes = k3_bound(torch, rho[p_idx], failure=True, solves=solves)
        variants[pol] = dict(
            teacher_forced=r, masked_p4_solves=len(solves), bound_ms=bms, bound_by=by, ops=ops,
            bytes=n_bytes, **_k3_alone(torch, args),
            launches=launches["ocean_traj_instances"][f"failure/{cfg.failure_mode}"])
    out = dict(gpu=smi, grid=f"{P} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
               launches=launches, wall_s=wall, rounds_cells_per_s=P * C * T / wall,
               delivery_rates=rates, k3=variants, max_abs_err_b=max(errs),
               mean_selected={p: res.num_selected[i].float().mean().item()
                              for i, p in enumerate(pols)},
               delivered_utility={p: res.delivered[i].float().sum((-1, -2)).mean().item()
                                  for i, p in enumerate(pols)})
    emit({"phase": "reliability", **out})
    return out, k3_args


def phase_radio_grid(torch, np, dev, smi, T=300, K=10, seeds=64):
    """The radio grid (nine static (B, tau) cells and a spectrum-sharing
    cell) through K3's streamed-radio instance, with SMO and AMO beside it;
    every round replayed against the plain round, and each static cell
    held bit for bit to the same cell run as a scalar-radio grid.  Returns
    the phase's record and K3's arguments on the grid's cells."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.env import EnvSpec
    from repro_torch.sim import GridEngine, run_grid

    scen = [
        Scenario(name=f"B{b / 1e6:g}MHz_tau{tau:g}s", num_rounds=T, num_clients=K,
                 radio=RadioParams(bandwidth_hz=b, deadline_s=tau))
        for b in BANDWIDTHS_HZ for tau in DEADLINES_S
    ] + [Scenario(name="spectrum_sharing", num_rounds=T, num_clients=K, env=EnvSpec(
        radio="spectrum_sharing", radio_params={"share_min": 0.5, "share_max": 1.0,
                                                "p_change": 0.5}))]
    pols = ["ocean-u", "smo", "amo"]
    res, wall, launches = _timed_grid(torch, dev, scen, pols, seeds)
    check(launches["ocean_traj"] == 1 and launches["ocean_traj_instances"] == {"radio": 1},
          f"radio grid: K3 launched {launches}")
    P, S, N = res.a.shape[:3]
    C = S * N
    for f in ("b", "e", "q"):
        check(bool(torch.isfinite(getattr(res, f)).all()), f"radio grid: non-finite {f}")
    engine = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev)
    eta = eta_schedule("uniform", T, device=dev)
    radio, _ = _cells(res, C, T, radio=res.radio_seq)
    args = _k3_args(torch, engine.cfg, res, radio=radio)
    r = teacher_forced(torch, dev, engine.cfg, res, 0, eta, V_PAPER, radio=res.radio_seq,
                       obj=_k3_replayed_obj(torch, res, 0, args))
    r.pop("near")
    # static cells: the streamed leaves give the scalar instance's bits
    for s, sc in enumerate(scen[:-1]):
        one = run_grid([sc], ["ocean-u"], range(seeds), solver="pallas", traj="fused", device=dev)
        for f in ("a", "b", "e", "q", "num_selected"):
            check(torch.equal(getattr(res, f)[0, s], getattr(one, f)[0, 0]),
                  f"radio grid: {sc.name} through the radio stream differs from the scalar "
                  f"instance ({f})")
    rho = res.q[0].reshape(C, T, K) / torch.clamp(res.h2.reshape(C, T, K), min=1e-30)
    bms, by, ops, n_bytes = k3_bound(torch, rho, radio=True)
    share = res.radio_seq.bandwidth_hz[-1] / 10e6
    out = dict(gpu=smi, grid=f"{P} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
               launches=launches, wall_s=wall, rounds_cells_per_s=P * C * T / wall,
               teacher_forced=r, static_cells_bitwise=S - 1,
               spectrum_mean_share=share.mean().item(), bound_ms=bms, bound_by=by, ops=ops,
               bytes=n_bytes, **_k3_alone(torch, args),
               mean_selected={f"{p}/{sc.name}": res.num_selected[i, s].float().mean().item()
                              for i, p in enumerate(pols) for s, sc in enumerate(scen)
                              if s in (0, 4, 8, 9)})
    emit({"phase": "radio_grid", **out})
    return out, args


def phase_baselines(torch, np, dev, smi, T=300, K=10, seeds=64, num_iters=400):
    """The paper's baselines on the card against the same calls on the CPU,
    on the §VI stationary cells; the dual oracle on one cell through K1
    (num_iters + 1 launches), and OCEAN's utility against it (Theorem 2's
    practical form, tests/test_ocean.py:72-84)."""
    from repro_torch.core import baselines as bl
    from repro_torch.core.ocean import simulate
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import paper_scenarios
    from repro_torch.kernels.ocean_p import ocean_p_prefix
    from repro_torch.sim import GridEngine

    sc = paper_scenarios(T, K)["stationary"]
    engine = GridEngine([sc], ["ocean-u"], solver="pallas", device=dev)
    cfg = engine.cfg
    h2 = engine.sample_env(range(seeds))[0][0]                    # (N, T, K)
    h2_cpu = h2.cpu()
    cpu_cfg = cfg
    rec = {}
    for name, fn in (("select_all", bl.select_all), ("smo", bl.smo), ("amo", bl.amo)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = fn(cfg, h2)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        cpu = fn(cpu_cfg, h2_cpu)
        check(torch.equal(card.a.cpu(), cpu.a), f"{name}: decisions differ card vs CPU")
        err = (card.b.cpu() - cpu.b).abs().max().item()
        check(err <= B_ATOL, f"{name}: max |b card - b CPU| = {err}")
        rec[name] = dict(ms=ms, max_abs_err_b=err, mean_selected=card.num_selected.float().mean().item())

    eta = eta_schedule("uniform", T, device=dev)
    cell = h2[:1]
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trace, dual = bl.lookahead_dual(cfg, cell, eta, num_iters=num_iters)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    k1 = ocean_p_prefix.launches
    check(k1 == num_iters + 1, f"lookahead_dual: K1 launched {k1} times, not {num_iters + 1}")
    # the same call's last step on the CPU from the card's multipliers
    mu, _ = bl.dual_ascent(cfg, cell, eta, num_iters=num_iters)
    a_c, b_c, _ = bl.lookahead_rounds(cfg, cell.cpu(), eta.cpu(), mu.cpu())
    check(torch.equal(trace.a.cpu(), a_c), "lookahead_dual: decisions differ card vs CPU")
    err = (trace.b.cpu() - b_c).abs().max().item()
    check(err <= B_ATOL, f"lookahead_dual: max |b card - b CPU| = {err}")
    oracle = bl.utility(trace, eta).item()
    _, decs = simulate(cfg, cell, eta, 1e-4, traj="fused", device=dev)
    ours = (eta * decs.num_selected.float()).sum().item()
    check(ours >= 0.6 * oracle, f"Theorem 2: OCEAN {ours} < 0.6 x oracle {oracle}")
    rec["lookahead_dual"] = dict(num_iters=num_iters, k1_launches=k1, wall_s=oracle_s,
                                 max_abs_err_b=err, oracle_utility=oracle,
                                 dual_value=dual.item(), ocean_utility=ours, ocean_v=1e-4,
                                 ratio=ours / oracle)
    emit({"phase": "baselines", "gpu": smi, "cells": seeds, "T": T, "K": K, **rec})
    return rec


# ---------------------------------------------------------------------------
# the guarded-execution layer: the robustness sweep
# (benchmarks/robustness_sweep.py) through K3's guard and bisect instances
# ---------------------------------------------------------------------------
GUARD_FIELDS = (("fault_count", "fc"), ("demoted", "dm"), ("fallback", "fb"))
INJECT = dict(num_inf=3, num_zero=2, num_negative=2)   # robustness_sweep.py:59
ENERGY_CAP = 1.0


def replay_guarded(torch, cfg, dec, h2, eta, v, inc):
    """Every (cell, round) of a guarded K3 run through the plain guarded
    round on the kernel's own q_pre.  ``dec`` holds (C, T, ...) decisions
    and the three counters, ``h2``/``inc`` (C, T, K), ``eta`` (C, T).
    Decisions exact outside near ties (margins of the plain K1 sweep on the
    guarded priorities), b within B_ATOL there, the counters exact
    everywhere (they do not depend on the solve's last bits)."""
    from repro_torch.core.ocean import OceanState, _guard_admission, ocean_round
    from repro_torch.core.selection import RHO_DEMOTED, priorities
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels.ocean_traj import _plain_solver

    C, T, K = dec.a.shape
    CT = C * T
    dev = h2.device
    q_pre = dec.q.reshape(CT, K)
    h2r = h2.reshape(CT, K)
    eta_c = eta.reshape(CT)
    plain_cfg = dataclasses.replace(cfg, solver=_plain_solver(get_solver(cfg.solver)),
                                    traj="scan")
    state = OceanState(q=q_pre, t=torch.arange(T, device=dev, dtype=torch.int32).repeat(C),
                       energy_spent=torch.zeros_like(q_pre))
    _, d = ocean_round(state, h2r, v, eta_c, plain_cfg, budget_inc=inc.reshape(CT, K))
    h2s, admit, _, _ = _guard_admission(plain_cfg, h2r, None, cfg.radio)
    rho = priorities(q_pre, h2s)
    if admit is not None:
        rho = torch.where(admit, rho, torch.full_like(rho, RHO_DEMOTED))
    near = _near_rounds(torch, rho, v * eta_c, cfg.radio)
    flip = (dec.a.reshape(CT, K) != d.a).any(1)
    check(not bool((flip & ~near).any()),
          f"guarded K3: {(flip & ~near).sum().item()} rounds select differently outside near ties")
    ok = ~near
    err_b = (dec.b.reshape(CT, K) - d.b).abs()[ok].max().item()
    check(err_b <= B_ATOL, f"guarded K3: max |b - b_plain| = {err_b}")
    for f, _ in GUARD_FIELDS:
        got, want = getattr(dec, f).reshape(CT), getattr(d, f)
        check(torch.equal(got, want),
              f"guarded K3: {f} differs from the plain round in {(got != want).sum().item()} rounds")
    return dict(rounds=CT, near_tie_rounds=int(near.sum()), flipped_rounds=int(flip.sum()),
                max_abs_err_b=err_b, **{f: int(getattr(d, f).sum()) for f, _ in GUARD_FIELDS})


def _vi_k3_args(torch, np, dev, cfg, C=192, T=300):
    """K3 alone at the §VI shape on chip_kernels.py's seeded inputs (192
    cells x 300 rounds x K = 10, exponential gains, H / T increments, V =
    1e-5, the uniform schedule)."""
    from repro_torch.core.patterns import eta_schedule

    K = cfg.num_clients
    h2 = torch.tensor(np.random.default_rng(3).exponential(size=(C, T, K)).astype(np.float32)
                      * 2.5e-4, device=dev)
    eta = eta_schedule("uniform", T, device=dev).expand(C, T).contiguous()
    return h2, torch.full((C, T), V_PAPER, device=dev), eta, torch.full_like(h2, 0.15 / T)


def phase_robustness(torch, np, dev, smi, T=300, K=10, seeds=64, t_fault=12):
    """The robustness sweep at the paper's §VI settings on the card.

    1. The grid (clean and drift-toward cells x 64 seeds, ocean-a at V = 1e-5,
       solver="pallas", traj="fused") unguarded, with energy_cap = 1 and with
       a cap of 1e6 that never fires: the latter equals the unguarded grid bit
       for bit, the cap bounds every round's energy, and on the clean cells
       the guard moves the selections by under 3 %.
    2. Fault telemetry on every cell of the same two scenarios cut to
       ``t_fault`` rounds (half the sweep's own fault part's T = 24: the
       plain bisect round on the scan path is ~27,000 eager launches, ~0.3 s
       on the H100 machine's host): inf/zero/negative
       draws injected per cell, GuardSpec() with solver pallas and bisect on
       the scan and fused paths; fault_count exact per round and cell, no
       quarantined client selected, finite queues, scan against fused under
       the parity rule.
    3. Chaos on the grid's cells: objective chaos on base pallas and bisect
       falls back every round and commits the guarded bisect run's bits;
       budget chaos (x 1.5) falls back exactly on the rounds with m* > 0.
    Then every guarded K3 run replayed against the plain round, and K3's
    guard, bisect and chaos instances timed at the §VI shape."""
    from repro_torch.core.ocean import simulate
    from repro_torch.core.scenario import Scenario, paper_scenarios
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.policy import PolicyParams
    from repro_torch.guard import GuardSpec, inject_h2_faults, register_chaos_solver
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_trajectory_fused
    from repro_torch.sim import GridEngine, run_grid

    def scenarios(t):
        return [Scenario(name="clean", num_rounds=t, num_clients=K),
                paper_scenarios(t, K)["scenario2"]]

    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        """Seconds since the previous part ended (the phase's breakdown)."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    scen = scenarios(T)
    pols = [("ocean-a", PolicyParams(v=V_PAPER))]
    chaos_obj = {b: register_chaos_solver(b, kind="objective").name for b in ("pallas", "bisect")}
    chaos_budget = register_chaos_solver("bisect", kind="budget", scale=1.5).name
    guards = {"unguarded": None, "cap1": GuardSpec(energy_cap=ENERGY_CAP),
              "cap1e6": GuardSpec(energy_cap=1e6)}
    fault_scen = scenarios(t_fault)
    fault_engine = GridEngine(fault_scen, pols, device=dev)
    h2_f = fault_engine.sample_env(range(seeds))[0].reshape(-1, t_fault, K)
    C = h2_f.shape[0]
    rows, expected = [], []
    for c in range(C):  # faults injected per cell, seeded by the cell
        x, rep = inject_h2_faults(h2_f[c], seed=c, **INJECT)
        rows.append(torch.from_numpy(x))
        expected.append(torch.from_numpy(rep.per_round_quarantined(t_fault)))
    h2_bad = torch.stack(rows).to(dev)
    expected = torch.stack(expected).to(device=dev, dtype=torch.int32)
    eta_f = eta_schedule("ascend", t_fault, device=dev)
    run_grid(scen, pols, range(2), solver="pallas", traj="fused", device=dev)  # warm-up
    part("setup")

    # -- the main path: every run below between reset and read counts ------
    _reset_counts()
    t0 = time.perf_counter()
    grids = {k: run_grid(scen, pols, range(seeds), solver="pallas", traj="fused", guard=g,
                         device=dev) for k, g in guards.items()}
    torch.cuda.synchronize()
    grid_wall = time.perf_counter() - t0
    part("grids")
    faults = {}
    for solver in ("pallas", "bisect"):
        for traj in ("scan", "fused"):
            cfg_f = dataclasses.replace(fault_scen[0].ocean_config(), solver=solver, traj=traj,
                                        guard=GuardSpec())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            st, d = simulate(cfg_f, h2_bad, eta_f, V_PAPER, device=dev)
            torch.cuda.synchronize()
            faults[solver, traj] = (cfg_f, st, d, time.perf_counter() - t1)
    part("faults")
    h2_g = grids["unguarded"].h2.reshape(-1, T, K)
    eta_g = eta_schedule("ascend", T, device=dev)
    cfg_g = dataclasses.replace(scen[0].ocean_config(), traj="fused", guard=GuardSpec())
    chaos = {}
    for name, solver, guard in (("bisect", "bisect", None), ("guarded_bisect", "bisect", True),
                                ("objective/pallas", chaos_obj["pallas"], True),
                                ("objective/bisect", chaos_obj["bisect"], True),
                                ("budget/bisect", chaos_budget, True)):
        cfg_c = dataclasses.replace(cfg_g, solver=solver, guard=cfg_g.guard if guard else None)
        chaos[name] = (cfg_c, *simulate(cfg_c, h2_g, eta_g, V_PAPER, device=dev))
    part("chaos")
    launches = _counts()
    inst = launches["ocean_traj_instances"]
    for label in ("guard", "bisect", "bisect+guard", "guard+chaos", "bisect+guard+chaos"):
        check(inst.get(label, 0) > 0, f"robustness: K3's {label} instance was never launched")
    check(launches["ocean_p_prefix"] > 0, "robustness: K1 (the scan path) was never launched")

    # -- 1. the grid ------------------------------------------------------
    g0, g1, g2 = grids["unguarded"], grids["cap1"], grids["cap1e6"]
    for f in ("a", "b", "e", "q", "num_selected"):
        check(torch.equal(getattr(g0, f), getattr(g2, f)),
              f"robustness: the never-firing guard moved the grid's {f}")
    h_round = 0.15
    guarded_max = g1.e.max().item()
    check(guarded_max <= ENERGY_CAP * h_round * (1 + 1e-6),
          f"robustness: a guarded round spent {guarded_max} J > cap x H")
    util0 = g0.num_selected[:, 0].sum(-1).double().mean().item()
    util1 = g1.num_selected[:, 0].sum(-1).double().mean().item()
    rel = abs(util1 - util0) / max(util0, 1e-9)
    check(rel < 0.03, f"robustness: the guard moved the clean cells' selections by {rel}")
    tail_max = g0.e[:, 1].max().item()
    part("checks/grid")

    # -- 2. fault telemetry -------------------------------------------------
    fault_rec = {}
    for (solver, traj), (cfg_f, st, d, wall) in faults.items():
        check(torch.equal(d.fault_count, expected),
              f"robustness: fault_count differs from the injection ({solver}, {traj})")
        check(not bool((d.a & ~(torch.isfinite(h2_bad) & (h2_bad > 0))).any()),
              f"robustness: a quarantined client was selected ({solver}, {traj})")
        check(bool(torch.isfinite(st.q).all()), f"robustness: non-finite queues ({solver}, {traj})")
        fault_rec[f"{solver}/{traj}"] = dict(
            wall_s=wall, faults=int(d.fault_count.sum()), demoted=int(d.demoted.sum()),
            fallback=int(d.fallback.sum()), mean_selected=d.num_selected.float().mean().item())
    for solver in ("pallas", "bisect"):
        ds, df = faults[solver, "scan"][2], faults[solver, "fused"][2]
        # a cell may differ only after one of its rounds is a near tie
        same = (ds.a == df.a).flatten(1).all(-1) & (ds.num_selected == df.num_selected).all(-1)
        near = _near_rounds(torch, df.rho.reshape(-1, K), V_PAPER * eta_f.repeat(C),
                            scen[0].radio).reshape(C, t_fault).any(-1)
        check(bool((same | near).all()),
              f"robustness: scan vs fused ({solver}): {int((~same & ~near).sum())} cells differ "
              f"without a near tie")
        err = (ds.b[same] - df.b[same]).abs().max().item() if bool(same.any()) else 0.0
        check(err <= B_ATOL, f"robustness: scan vs fused ({solver}) max |b| diff {err}")
        for f, _ in GUARD_FIELDS:
            check(torch.equal(getattr(ds, f)[same], getattr(df, f)[same]),
                  f"robustness: scan vs fused ({solver}) {f} differs")
        fault_rec[f"{solver}/scan_vs_fused"] = dict(cells_identical=int(same.sum()),
                                                    cells_with_near_tie=int(near.sum()),
                                                    max_abs_err_b=err)
    part("checks/faults")

    # -- 3. chaos -----------------------------------------------------------
    ref = chaos["guarded_bisect"][2]
    for f in ("a", "b", "e", "q", "num_selected"):
        check(torch.equal(getattr(chaos["bisect"][2], f), getattr(ref, f)),
              f"robustness: the never-firing guard moved the bisect run's {f}")
    chaos_rec = {}
    for name in ("objective/pallas", "objective/bisect", "budget/bisect"):
        d = chaos[name][2]
        if name.startswith("objective"):
            check(bool((d.fallback.sum(-1) == T).all()),
                  f"robustness: chaos {name} did not fall back on every round")
        else:
            m_pos = (ref.a & (ref.rho > 1e-30)).any(-1).int()
            check(torch.equal(d.fallback, m_pos),
                  "robustness: budget chaos fell back elsewhere than on the rounds with m* > 0")
        for f in ("a", "b", "e", "q"):
            check(torch.equal(getattr(d, f), getattr(ref, f)),
                  f"robustness: chaos {name} + fallback differs from the guarded bisect run ({f})")
        chaos_rec[name] = dict(fallback_rounds=int(d.fallback.sum()))

    part("checks/chaos")

    # -- replays ------------------------------------------------------------
    engine = GridEngine(scen, pols, solver="pallas", traj="fused", guard=guards["cap1"],
                        device=dev)
    Cg = h2_g.shape[0]
    inc_g = g1.budget_inc.reshape(Cg, T, K).contiguous()
    eta_gc = eta_g.expand(Cg, T).contiguous()
    vv = torch.full((Cg, T), V_PAPER, device=dev)
    # a comparison launch on the grid's cells: the grid's bits, with the counters
    _, grid_dec = ocean_trajectory_fused(engine.cfg, h2_g.contiguous(), vv, eta_gc, inc_g)
    for f in ("a", "b", "q"):
        check(torch.equal(getattr(grid_dec, f), getattr(g1, f)[0].reshape(grid_dec.a.shape)),
              f"robustness: a launch on the grid's cells differs from the grid's run ({f})")
    inc_f = torch.full_like(h2_bad, 0.15 / t_fault)
    replays = {"grid_cap1": replay_guarded(torch, engine.cfg, grid_dec, h2_g, eta_gc, V_PAPER,
                                           inc_g)}
    for solver in ("pallas", "bisect"):
        cfg_f, _, d, _ = faults[solver, "fused"]
        replays[f"faults/{solver}"] = replay_guarded(torch, cfg_f, d, h2_bad,
                                                     eta_f.expand(C, t_fault), V_PAPER, inc_f)
    # the chaos run's first 16 cells: every round there commits the bisect
    # fallback, whose plain version is ~27,000 launches however many rows
    cfg_c, _, d = chaos["objective/pallas"]
    n_sub = min(16, Cg)
    replays["chaos/objective/pallas"] = replay_guarded(
        torch, cfg_c, type(d)(*(None if x is None else x[:n_sub] for x in d)), h2_g[:n_sub],
        eta_g.expand(n_sub, T), V_PAPER, torch.full_like(h2_g[:n_sub], 0.15 / T))
    part("replays")

    # -- K3's readings at the §VI shape ------------------------------------
    h2v, vv, etav, incv = _vi_k3_args(torch, np, dev, engine.cfg)
    base = dataclasses.replace(engine.cfg, guard=None)
    readings = {}
    for name, cfg_r, rounds in (
            ("guard", dataclasses.replace(base, guard=GuardSpec(energy_cap=1e6)), 3),
            ("bisect", dataclasses.replace(base, solver="bisect"), 1),
            ("chaos", dataclasses.replace(base, solver=chaos_obj["pallas"], guard=GuardSpec()), 1)):
        args = (cfg_r, h2v, vv, etav, incv, None, None)
        o = ocean_traj(*args)
        if name == "chaos":
            check(bool((o.fb == 1).all()), "robustness: the chaos reading did not fall back")
        bms, by, ops, n_bytes = k3_bound(torch, o.rho, bisect=name == "bisect",
                                         guard=name != "bisect",
                                         fallback=o.fb if name == "chaos" else None)
        readings[name] = dict(bound_ms=bms, bound_by=by, ops=ops, bytes=n_bytes,
                              **_k3_alone(torch, args, plain_rounds=rounds))
    part("readings")
    out = dict(gpu=smi, grid=f"1 policy x {len(scen)} scenarios x {seeds} seeds, T={T}, K={K}",
               launches=launches, grid_wall_s=grid_wall,
               grid_rounds_cells_per_s=3 * g0.e.shape[1] * seeds * T / grid_wall,
               unguarded_tail_energy_max_j=tail_max, guarded_energy_max_j=guarded_max,
               clean_utility_rel_delta=rel, faults_injected_per_cell=sum(INJECT.values()),
               fault_cells=C, fault_rounds=t_fault, faults=fault_rec, chaos=chaos_rec,
               replays=replays, k3=readings, parts_s=parts,
               max_abs_err_b=max(r["max_abs_err_b"] for r in replays.values()))
    emit({"phase": "robustness", **out})
    return out


# ---------------------------------------------------------------------------
# telemetry: repro_torch.obs and K3's HasMetrics instances
# ---------------------------------------------------------------------------
# The in-kernel telemetry overhead spec of benchmarks/traj_bench.py:304
# (chip_kernels.py's reading); the telemetry phase's spec names every
# collector with every reduction, covering it and the diagnosis spec of
# examples/diagnose_fig10_13.py:50.
OVERHEAD_SPEC = ("queue:last", "lyapunov:mean", "num_selected:full_trace",
                 "energy_headroom:last", "queue:histogram", "solver_residual:mean")
# The first hex digits of K3's output digest on chip_kernels.py's §VI inputs,
# which the telemetry must leave as they are.
K3_VI_DIGEST = "c27a0410"
# Integer-valued collectors (and ratios of integers): exact wherever two
# runs' decisions agree.
EXACT_COLLECTORS = frozenset((
    "num_selected", "selection_count", "selection_gap", "delivery_rate", "reallocation_count",
    "fault_count", "demoted_clients", "fallback_rounds", "topm_saturated"))


def telemetry_spec(hist_bins=32, names=None, reductions=None):
    """Every collector (or ``names``) with every reduction (or ``reductions``)."""
    from repro_torch.obs import REDUCTIONS, MetricsSpec, available_collectors

    return MetricsSpec(collect=tuple(
        (n, r) for n in (available_collectors() if names is None else names)
        for r in (REDUCTIONS if reductions is None else reductions)), hist_bins=hist_bins)


def k3_digest(torch, out):
    """chip_kernels.py's digest of a K3 launch's decision outputs (the
    first 16 hex digits of the SHA-256 of a, b, e, q_pre, rho, obj, nsel,
    q_final and es_final)."""
    import hashlib

    h = hashlib.sha256()
    for t in out[:9]:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def metrics_bound(torch, rho, spec, cfg, **k3_kw):
    """The HasMetrics instance's bound: K3's (``k3_bound``) plus, per
    cell-round, the collectors' arithmetic (the seven block-summed terms
    and three state rows a client, four operations a client per
    per-client entry, eight per scalar entry) and the bytes of the
    telemetry outputs, each written once."""
    from repro_torch.kernels.ocean_traj import _metrics_descriptor

    C, T, K = rho.shape
    ml = _metrics_descriptor(cfg, C, rho.device)
    _, _, ops, n_bytes = k3_bound(torch, rho, **k3_kw)
    n_client = ml.layout[1]
    n_scalar = len(spec.collect) - n_client
    ops += C * T * (K * (24 + 4 * n_client) + 8 * n_scalar)
    n_bytes += sum(t.numel() * 4 for t in ml.out.values())
    return (*bound_ms(n_bytes, ops), ops, n_bytes)


def _metrics_launch(torch, args, spec, what):
    """K3's HasMetrics instance on ``args`` (``_k3_args``'s tuple) beside its
    metrics-off launch: decisions bit for bit equal, the telemetry held to
    the replay of its rows (``check_metrics_replay``).  Returns the launch,
    its comparison record and the replay's wall ms."""
    from repro_torch.kernels.ocean_traj import check_metrics_replay, ocean_traj

    cfg, h2, v, eta, inc, radio, failure = args
    off = ocean_traj(*args)
    cfg_m = dataclasses.replace(cfg, metrics=spec)
    before = dict(ocean_traj.instances)
    on = ocean_traj(cfg_m, h2, v, eta, inc, radio, failure)
    label = [k for k, n in ocean_traj.instances.items() if n != before.get(k, 0)]
    check(len(label) == 1 and "metrics" in label[0],
          f"telemetry {what}: the HasMetrics launch launched {label}")
    for f in ("a", "b", "e", "q_pre", "rho", "obj", "nsel", "q_final", "es_final", "dlv", "ral",
              "fc", "dm", "fb"):
        x, y = getattr(off, f), getattr(on, f)
        check((x is None and y is None) or torch.equal(x, y),
              f"telemetry {what}: metrics-on {f} differs from metrics-off")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    errs = check_metrics_replay(cfg_m, on.metrics, on, v, eta, inc, radio)
    torch.cuda.synchronize()
    replay_ms = 1e3 * (time.perf_counter() - t0)
    return on, dict(max_abs_err=max(errs.values()), entries=len(errs),
                    instance=label[0] if label else None, launches=len(label)), replay_ms


def _metrics_instance(torch, args, spec, what, plain_rounds=10, **bound_kw):
    """One HasMetrics instance checked (``_metrics_launch``) and read: its
    ms, its bound, and the plain version's ms over the first rounds
    (``ocean_traj_plain`` with the telemetry)."""
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_traj_plain

    cfg, h2, v, eta, inc, radio, failure = args
    on, rec, replay_ms = _metrics_launch(torch, args, spec, what)
    cfg_m = dataclasses.replace(cfg, metrics=spec)
    margs = (cfg_m, h2, v, eta, inc, radio, failure)
    n = plain_rounds
    cfg_head = dataclasses.replace(cfg_m, num_rounds=n)
    head = (cfg_head, h2[:, :n], v[:, :n], eta[:, :n], inc[:, :n],
            None if radio is None else radio.map(lambda x: x[:, :n]),
            None if failure is None else failure._replace(delivered=failure.delivered[:, :n]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ocean_traj_plain(*head)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if bound_kw.pop("fallback", False):  # the bisect fallback on the rounds it fired
        bound_kw["fallback"] = on.fb
    bms, by, ops, n_bytes = metrics_bound(torch, on.rho, spec, cfg_m,
                                          radio=radio is not None, failure=failure is not None,
                                          **bound_kw)
    return on, dict(rec, ms=gpu_ms(torch, lambda: ocean_traj(*margs), 3), plain_ms=plain_ms,
                    plain_rounds=n, replay_ms=replay_ms, bound_ms=bms, bound_by=by, ops=ops,
                    bytes=n_bytes)


def _grid_rate(torch, dev, scen, pols, sd, **kw):
    """Wall seconds of one ``run_grid`` call, ending in a synchronize."""
    from repro_torch.sim import run_grid

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_grid(scen, pols, sd, solver="pallas", device=dev, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_telemetry(torch, np, dev, smi, rel_args, radio_args, T=300, K=10, seeds=64):
    """The telemetry layer (``repro_torch.obs``) through K3's HasMetrics
    instances, with a spec that names every collector with every reduction.

    1. The §VI grid at full size on ``traj="fused"``, metrics off and on
       (four turns each after warm-ups; the counts reset just before the
       first metrics-on run and read just after): the decisions equal the
       metrics-off grid's bit for bit; K3's launch on the grid's cells gives
       the grid's bits and telemetry, which holds to the replay of its rows;
       on chip_kernels.py's §VI inputs the HasMetrics launch keeps K3's
       digest.
    2. The same spec on ``traj="scan"`` (K1): in every cell whose
       decisions agree with the fused grid, the scan telemetry equals the
       replay of the fused rows exactly where the rows agree bit for bit,
       and within the parity rule (rtol 2e-4, atol 1e-6 x the collector's
       histogram span; integer-valued collectors exact) elsewhere.  The scan
       grid's rate with the named spans on and off, five turns each, and
       the spans' share of its wall: the ranges one grid opens times one
       range's host cost (on less off) over the median wall.
    3. One HasMetrics launch of each other instance on the existing phases'
       inputs: the radio grid's cells, the reliability grid's cells under
       each failure mode, and the §VI inputs with injected faults guarded
       (energy cap 1) on pallas and bisect and under objective chaos (the
       fallback every round); each held to its replay.
    4. K = 2048 (phase_k3_large's case) with every per-client collector in
       mean and histogram: the region in shared memory beside K3's rows
       (fewer teams), and with 16,384 bins in the global scratch.
    5. A planted fault (the queue histogram's edges moved by one bin in the
       launch descriptor) must fail the replay check."""
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.guard import GuardSpec, inject_h2_faults, register_chaos_solver
    from repro_torch.kernels import _build
    from repro_torch.kernels.ocean_traj import (
        _metrics_descriptor,
        check_metrics_replay,
        metrics_replay,
        ocean_traj,
    )
    from repro_torch.obs import get_collector, metric_key
    from repro_torch.obs.spans import set_trace_spans
    from repro_torch.sim import GridEngine

    spec = telemetry_spec()
    scen, pols, sd = _grid_args(T, K, seeds)
    P, S, N = len(pols), len(scen), seeds
    C = S * N
    rounds_cells = P * C * T
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # 1. the §VI grid, metrics off and on in turns (four each)
    _grid_rate(torch, dev, scen, pols, sd, traj="fused")
    _grid_rate(torch, dev, scen, pols, sd, traj="fused", metrics=spec)
    walls = {"off": [], "on": []}
    for i, m in enumerate((None, spec) * 4):
        if i == 1:
            _reset_counts()
        res, w = _grid_rate(torch, dev, scen, pols, sd, traj="fused", metrics=m)
        walls["off" if m is None else "on"].append(w)
        if i == 0:
            res_off = res
        elif i == 1:
            res_on, launches = res, _counts()
    del res
    check(launches["ocean_traj"] == P and launches["ocean_traj_instances"] == {"metrics": P},
          f"telemetry: the metrics grid launched {launches}")
    for f in ("a", "b", "e", "q", "num_selected", "energy_spent"):
        check(torch.equal(getattr(res_on, f), getattr(res_off, f)),
              f"telemetry: the metrics grid's {f} differs from the metrics-off grid's")
    check(res_off.metrics is None and len(res_on.metrics) == P
          and all(set(m) == {metric_key(n, r) for n, r in spec.collect} for m in res_on.metrics),
          "telemetry: GridResult.metrics")
    part("grid")

    cfg = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev).cfg
    cfg_m = dataclasses.replace(cfg, metrics=spec)
    h2v, vv, etav, incv = _vi_k3_args(torch, np, dev, cfg)
    d_off = k3_digest(torch, ocean_traj(cfg, h2v, vv, etav, incv))
    d_on = k3_digest(torch, ocean_traj(cfg_m, h2v, vv, etav, incv))
    check(d_off == d_on and d_on.startswith(K3_VI_DIGEST),
          f"telemetry: K3 digests {d_off} (off) / {d_on} (on), expected {K3_VI_DIGEST}...")

    grid_errs, fused_rows, wants = {}, {}, {}
    h2c = res_on.h2.reshape(C, T, K).contiguous()
    inc = res_on.budget_inc.reshape(C, T, K).contiguous()
    vc = torch.full((C, T), V_PAPER, device=dev)
    for p_idx, pol in enumerate(pols):
        eta = eta_schedule({"ocean-u": "uniform", "ocean-a": "ascend"}[pol], T,
                           device=dev).expand(C, T).contiguous()
        o = ocean_traj(cfg_m, h2c, vc, eta, inc)
        for f, g in (("a", "a"), ("b", "b"), ("q_pre", "q")):
            check(torch.equal(getattr(o, f), getattr(res_on, g)[p_idx].reshape(C, T, K)),
                  f"telemetry: K3 on the grid's cells differs from the grid ({f})")
        for key, val in res_on.metrics[p_idx].items():
            check(torch.equal(o.metrics[key], val.reshape(o.metrics[key].shape)),
                  f"telemetry: K3 on the grid's cells gives other telemetry ({key})")
        wants[pol] = metrics_replay(cfg_m, o, vc, eta, inc)
        errs = check_metrics_replay(cfg_m, o.metrics, o, vc, eta, inc, want=wants[pol])
        grid_errs[pol] = max(errs.values())
        fused_rows[pol] = o
    part("grid_replay")

    # 2. the scan grid (K1) with the same spec, and its spans' cost
    res_scan, w_scan = _grid_rate(torch, dev, scen, pols, sd, traj="scan", metrics=spec)
    lo_hi = {n: get_collector(n).hist_range(cfg) for n in spec.names}
    scan_rec = {}
    for p_idx, pol in enumerate(pols):
        o = fused_rows[pol]
        same = ((res_scan.a[p_idx].reshape(C, T, K) == o.a).flatten(1).all(1)
                & (res_scan.num_selected[p_idx].reshape(C, T) == o.nsel).all(1))
        bits = same.clone()
        for f, g in (("b", "b"), ("e", "e"), ("q", "q_pre")):
            bits &= (getattr(res_scan, f)[p_idx].reshape(C, T, K) == getattr(o, g)).flatten(1).all(1)
        loose = same & ~bits
        for key, want in wants[pol].items():
            got = res_scan.metrics[p_idx][key].reshape(want.shape)
            name = key.split("/")[0]
            check(torch.equal(got[bits], want[bits]),
                  f"telemetry: scan {key} differs from the fused rows' replay in bit-equal cells")
            if not bool(loose.any()):
                continue
            if name in EXACT_COLLECTORS and not key.endswith("/mean"):
                check(torch.equal(got[loose], want[loose]), f"telemetry: scan {key} not exact")
            elif key.endswith("/histogram"):
                check(torch.equal(got[loose].sum(-1), want[loose].sum(-1)),
                      f"telemetry: scan {key} counts")
            else:
                lo, hi = lo_hi[name]
                check(torch.allclose(got[loose], want[loose], rtol=W_RTOL, atol=1e-6 * (hi - lo)),
                      f"telemetry: scan {key} beyond the parity rule")
        scan_rec[pol] = dict(cells_same_decisions=int(same.sum()), cells_bit_equal_rows=int(bits.sum()),
                             cells_parity_rule=int(loose.sum()))
    part("scan_grid")

    # the named spans' cost on the scan grid: the ranges one grid opens, one
    # range's host cost on and off, and the grid's wall in turns
    from repro_torch.obs import spans as obs_spans

    opened, enter = [0], obs_spans._Span.__enter__

    def counting(self):
        opened[0] += 1
        return enter(self)

    obs_spans._Span.__enter__ = counting
    try:
        _grid_rate(torch, dev, scen, pols, sd, traj="scan")
    finally:
        obs_spans._Span.__enter__ = enter
    span_s, span_walls = {}, {"on": [], "off": []}
    for on in (True, False, True, False, True, False, True, False, True, False):
        prev = set_trace_spans(on)
        try:
            if on not in span_s:
                t0 = time.perf_counter()
                for _ in range(20000):
                    with obs_spans.trace_span("ocean/rank"):
                        pass
                span_s[on] = (time.perf_counter() - t0) / 20000
            span_walls["on" if on else "off"].append(
                _grid_rate(torch, dev, scen, pols, sd, traj="scan")[1])
        finally:
            set_trace_spans(prev)
    wall_off = sorted(span_walls["off"])[len(span_walls["off"]) // 2]
    spans_share = opened[0] * (span_s[True] - span_s[False]) / wall_off
    part("scan_spans")

    # 3. the other instances, one launch each
    instances = {}
    _, instances["radio"] = _metrics_instance(torch, radio_args, spec, "radio")
    for mode, args in rel_args.items():
        _, instances[f"failure/{mode}"] = _metrics_instance(torch, args, spec, f"failure/{mode}")
    rows = []
    for c in range(h2v.shape[0]):
        x, _ = inject_h2_faults(h2v[c].cpu(), 900 + c, **INJECT)
        rows.append(torch.tensor(x))
    h2f = torch.stack(rows).to(dev).contiguous()
    guard = GuardSpec(energy_cap=ENERGY_CAP)
    chaos = register_chaos_solver("pallas", kind="objective").name
    for name, cfg_i in (("guard", dataclasses.replace(cfg, guard=guard)),
                        ("bisect+guard", dataclasses.replace(cfg, guard=guard, solver="bisect")),
                        ("chaos+guard", dataclasses.replace(cfg, guard=guard, solver=chaos))):
        on, instances[name] = _metrics_instance(
            torch, (cfg_i, h2f, vv, etav, incv, None, None), spec, name, guard=True,
            bisect=name.startswith("bisect"), fallback=name.startswith("chaos"))
        check(bool(on.metrics["fault_count/last"].eq(on.fc.sum(1).float()).all())
              and float(on.metrics["fault_count/last"].min()) > 0,
              f"telemetry {name}: fault_count")
        check(bool(on.metrics["demoted_clients/last"].eq(on.dm.sum(1).float()).all()),
              f"telemetry {name}: demoted_clients")
        check(bool(on.metrics["fallback_rounds/last"].eq(on.fb.sum(1).float()).all()),
              f"telemetry {name}: fallback_rounds")
    part("instances")

    # 4. K = 2048, the richest per-client spec, in shared memory and global
    lib = _build.load("ocean_traj_metrics")
    large = {}
    args = _k3_inputs(torch, np, dev, 2, 3, 2048, seed=2048)
    names = ("queue", "queue_next", "energy_headroom", "selection_count", "selection_gap")
    for bins in (32, 16384):
        sp = telemetry_spec(hist_bins=bins, names=names,
                            reductions=("mean", "histogram", "full_trace_ds"))
        region = _metrics_descriptor(dataclasses.replace(args[0], metrics=sp), 2, dev).region
        in_smem = ctypes.c_int(0)
        warps = lib.ocean_traj_metrics_warps(2048, 0, 0, region, ctypes.byref(in_smem))
        _, rec, _ = _metrics_launch(torch, (*args, None, None), sp, f"K=2048 bins={bins}")
        large[bins] = dict(rec, region_floats=region, in_shared=bool(in_smem.value), warps=warps,
                           warps_without_metrics=_build.load("ocean_traj").ocean_traj_warps(2048, 0))
    check(large[32]["in_shared"] and not large[16384]["in_shared"],
          f"telemetry: K=2048 regions {large}")
    part("k2048")

    # 5. a planted fault: one histogram's edges moved by a bin
    o = ocean_traj(cfg_m, h2v, vv, etav, incv, hist_shift={"queue": 1})
    try:
        check_metrics_replay(cfg_m, o.metrics, o, vv, etav, incv)
        caught = False
    except AssertionError as exc:
        caught = "queue/histogram" in str(exc)
    check(caught, "telemetry: the planted fault (a shifted histogram edge) was not caught")

    # the HasMetrics instance alone at the §VI shape: the main path's spec
    args = (cfg_m, h2v, vv, etav, incv)
    dev_ms, _, seen = device_ms(torch, lambda: ocean_traj(*args), 3)
    ms = gpu_ms(torch, lambda: ocean_traj(*args), 5)
    ms_off = gpu_ms(torch, lambda: ocean_traj(cfg, h2v, vv, etav, incv), 5)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    from repro_torch.kernels.ocean_traj import ocean_traj_plain

    ocean_traj_plain(dataclasses.replace(cfg_m, num_rounds=n), h2v[:, :n], vv[:, :n],
                     etav[:, :n], incv[:, :n])
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    bms, by, ops, n_bytes = metrics_bound(torch, ocean_traj(cfg, h2v, vv, etav, incv).rho,
                                          spec, cfg_m)
    part("reading")
    out = dict(
        gpu=smi, grid=f"{P} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
        spec_entries=len(spec.collect), launches=launches,
        rounds_cells_per_s_off=[rounds_cells / w for w in walls["off"]],
        rounds_cells_per_s_on=[rounds_cells / w for w in walls["on"]],
        digest=d_on, grid_max_abs_err=grid_errs, scan=scan_rec,
        scan_rounds_cells_per_s_metrics=rounds_cells / w_scan,
        scan_rounds_cells_per_s_spans_on=[rounds_cells / w for w in span_walls["on"]],
        scan_rounds_cells_per_s_spans_off=[rounds_cells / w for w in span_walls["off"]],
        scan_spans_per_grid=opened[0], span_host_us_on=1e6 * span_s[True],
        span_host_us_off=1e6 * span_s[False], scan_spans_share_of_wall=spans_share,
        instances=instances, large_K=large, planted_fault_caught=caught,
        k3_ms=ms, k3_ms_metrics_off=ms_off, k3_device_ms=dev_ms, k3_device_records_seen=seen,
        k3_plain_ms=plain_ms, k3_plain_rounds=n, bound_ms=bms, bound_by=by, ops=ops,
        bytes=n_bytes, parts_s=parts,
        max_abs_err=max([*grid_errs.values()] + [r["max_abs_err"] for r in instances.values()]
                        + [r["max_abs_err"] for r in large.values()]),
    )
    emit({"phase": "telemetry", **out})
    return out


def _near_rounds(torch, rho, v_eta, radio):
    """Rounds (rows of ``rho``, priorities with the guard's demotions) whose
    best and runner-up prefix W of the plain K1 sweep lie within W_RTOL |W*|."""
    from repro_torch.core.selection import prefix_inputs
    from repro_torch.kernels.ocean_p import _scal, prefix_objectives_plain

    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    w = prefix_objectives_plain(_scal(n0, delta, v_eta, radio, rho_sorted), rho_sorted)
    top2 = torch.topk(w, 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs()


# ---------------------------------------------------------------------------
# the LM serving path: gemma2-27b prefill through K4, decode beside K5
# ---------------------------------------------------------------------------
GEMMA = "gemma2-27b"


def attn_pairs(S, window):
    """Unmasked (query, key) pairs of one causal head, with an optional window."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def att_close(a, ref):
    """Max |a - ref| and whether every element is within the attention tolerance."""
    a, ref = a.float(), ref.float()
    d = (a - ref).abs()
    return d.max().item(), bool((d <= ATT_ATOL + ATT_RTOL * ref.abs()).all())


def att_layer_reading(a, ref):
    """One layer's attention output against the plain one: max |d|, the share
    of elements beyond the element-wise tolerance, relative L2, and whether
    it passes both the element-wise and the L2 limit."""
    a, ref = a.float(), ref.float()
    d = (a - ref).abs()
    over = (d > ATT_ATOL + ATT_RTOL * ref.abs()).float().mean().item()
    rel = rel_err(a, ref)
    return dict(max_abs=d.max().item(), share_over_tol=over, rel_l2=rel,
                passes=over == 0 and rel <= ATT_REL)


@contextlib.contextmanager
def recorded_calls(module, name, keep):
    """Replace ``module.name`` by a wrapper that calls it and appends
    ``keep(args, kwargs, result)`` to the yielded list."""
    real = getattr(module, name)
    calls = []

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(keep(args, kwargs, out))
        return out

    setattr(module, name, wrapper)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def flex_library(torch, plain, q, k, v, cap, reps, causal=True, window=None, valid_len=None):
    """``library_ms``: one ``torch.compile``d ``flex_attention`` call that
    computes the kernel's function -- the soft-cap (if any) as its
    score_mod, the causal / window / valid-length mask as its block mask,
    GQA -- on the same q/k/v (B, S, H, Dh), laid out (B, H, S, Dh)
    beforehand and untimed.  Held against the plain version at the
    attention tolerance; its ``device_ms`` reading is ``library_device_ms``.
    The port itself never calls it."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sq, sk = qt.shape[2], kt.shape[2]

    def capped(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    score_mod = None if cap is None else capped

    def mask_mod(b, h, qi, ki):
        m = ki >= 0
        if causal:
            m = m & (ki <= qi)
        if window is not None:
            m = m & (qi - ki < window)
        if valid_len is not None:
            m = m & (ki < valid_len)
        return m

    try:
        block_mask = create_block_mask(mask_mod, None, None, sq, sk, device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)

        def run():
            return flex(qt, kt, vt, score_mod=score_mod, block_mask=block_mask, enable_gqa=True)

        out = run().transpose(1, 2)
        torch.cuda.synchronize()
    except Exception as exc:  # a library that does not build is a reading, not a fault of the port
        return dict(library_ms=None, library_error=repr(exc)[:400])
    err, ok = att_close(out, plain)
    check(ok, f"flex_attention vs plain beyond tolerance (max |d| = {err}): not the same function")
    dev, by_kernel, seen = device_ms(torch, run, reps)
    return dict(library_ms=gpu_ms(torch, run, reps), library_device_ms=dev,
                library_device_ms_by_kernel=by_kernel, library_device_records_seen=seen,
                library_max_abs_err_vs_plain=err)


def phase_k4(torch, dev, smi, B=1, S=8192):
    """K4 against its plain version at gemma2-27b's global and local layer
    shapes and at jamba-1.5-large's attention layer, each timed beside one
    compiled flex_attention call; and the soft-cap's share of K4's error
    (the global inputs with and without the cap)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gem, jam = get_config(GEMMA), get_config(JAMBA)
    bf = torch.bfloat16

    def inputs(cfg, seed):
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q = (torch.randn((B, S, H, Dh), generator=g, device=dev) * 4.0).to(bf)
        k = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(bf)
        v = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(bf)
        return q, k, v

    qkv = {GEMMA: inputs(gem, 4), JAMBA: inputs(jam, 6)}
    shapes = {"global": (gem, None, gem.attn_logit_softcap),
              "local": (gem, gem.sliding_window, gem.attn_logit_softcap),
              "jamba": (jam, None, jam.attn_logit_softcap)}
    rec = {}
    for label, (cfg, win, cap) in shapes.items():
        q, k, v = qkv[cfg.name]

        def run(fn=flash_attention, win=win, cap=cap, q=q, k=k, v=v):
            return fn(q, k, v, causal=True, window=win, logit_cap=cap)

        out, plain = run(), run(flash_attention_plain)
        check(bool(torch.isfinite(out.float()).all()), f"K4 {label}: non-finite output")
        err, ok = att_close(out, plain)
        check(ok, f"K4 {label}: out vs plain beyond tolerance (max |d| = {err})")
        ms = gpu_ms(torch, run, 10)
        dev_ms, _, seen = device_ms(torch, run, 10)
        plain_ms = gpu_ms(torch, lambda: run(flash_attention_plain), 2)
        flops = 4 * B * cfg.n_heads * cfg.head_dim * attn_pairs(S, win)
        n_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
        lib = flex_library(torch, plain, q, k, v, cap, 10, window=win)
        rec[label] = dict(arch=cfg.name, H=cfg.n_heads, KV=cfg.n_kv_heads, Dh=cfg.head_dim,
                          window=win, softcap=cap, max_abs_err=err,
                          rel_l2=rel_err(out, plain), ms=ms, device_ms=dev_ms,
                          device_records_seen=seen, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, flops=flops, bytes=n_bytes,
                          tflop_per_s=flops / ms / 1e9, **lib)
        if lib.get("library_ms"):
            rec[label]["library_tflop_per_s"] = flops / lib["library_ms"] / 1e9
        del out, plain
    # The soft-cap's share of the error: the kernel computes cap * tanh(x / cap)
    # with tanh.approx.f32, the plain version with the precise tanh.  The same
    # global inputs without the cap isolate it.
    q, k, v = qkv[GEMMA]
    softcap = dict(formula="cap * tanh.approx.f32(x / cap)", cap=gem.attn_logit_softcap,
                   capped=dict(max_abs_err=rec["global"]["max_abs_err"],
                               rel_l2=rec["global"]["rel_l2"]))
    out = flash_attention(q, k, v, causal=True)
    plain = flash_attention_plain(q, k, v, causal=True)
    softcap["uncapped"] = dict(max_abs_err=max_abs(out, plain), rel_l2=rel_err(out, plain))
    del out, plain
    # A second yardstick: SDPA on gemma2's q/k/v, causal, WITHOUT soft-cap or
    # window (SDPA cannot soft-cap), so not the same function.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    G = gem.n_heads // gem.n_kv_heads
    qt = q.transpose(1, 2)
    kt = k.repeat_interleave(G, dim=2).transpose(1, 2)
    vt = v.repeat_interleave(G, dim=2).transpose(1, 2)
    sdpa_ms = gpu_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True), 10)
    out = dict(gpu=smi, shape=dict(B=B, S=S, dtype="bfloat16"), results=rec, softcap=softcap,
               sdpa_causal_no_softcap_no_window_ms=sdpa_ms)
    emit({"phase": "k4_flash", **out})
    return out


def _k5_inputs(torch, dev, B, S, H, KV, Dh, valid):
    """Seeded bf16 q (B, H, Dh), caches (B, S, KV, Dh) and an int64 valid_len."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    bf = torch.bfloat16
    q = (torch.randn((B, H, Dh), generator=g, device=dev) * 4.0).to(bf)
    kc = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(bf)
    vc = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(bf)
    return q, kc, vc, torch.tensor(valid, device=dev)


def phase_k5_long(torch, dev, smi, B=4, S=8192, H=32, KV=16, Dh=128, valid=8000, cap=50.0):
    """K5 against its plain version on a long cache."""
    from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain

    q, kc, vc, vl = _k5_inputs(torch, dev, B, S, H, KV, Dh, valid)
    out = decode_attention(q, kc, vc, vl, logit_cap=cap)
    plain = decode_attention_plain(q, kc, vc, vl, logit_cap=cap)
    err, ok = att_close(out, plain)
    check(ok, f"K5 long cache: out vs plain beyond tolerance (max |d| = {err})")
    # valid_len as an int64 tensor (the kernel reads it where it lies), an
    # int32 one and a Python int: the same output.
    for alt in (vl.to(torch.int32), valid):
        check(torch.equal(decode_attention(q, kc, vc, alt, logit_cap=cap), out),
              f"K5 long cache: valid_len as {type(alt).__name__} changes the output")
    ms = gpu_ms(torch, lambda: decode_attention(q, kc, vc, vl, logit_cap=cap), 50)
    dev_ms, dev_by_kernel, seen = device_ms(
        torch, lambda: decode_attention(q, kc, vc, vl, logit_cap=cap), 50)
    clocks_after = clocks()
    plain_ms = gpu_ms(torch, lambda: decode_attention_plain(q, kc, vc, vl, logit_cap=cap), 3)
    flops = 4 * B * H * valid * Dh
    n_bytes = 2 * (2 * B * valid * KV * Dh + 2 * q.numel())
    bms, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS)
    lib = flex_library(torch, plain[:, None], q[:, None], kc, vc, cap, 50, causal=False,
                       valid_len=valid)
    # The soft-cap's share of the error: tanh.approx.f32 in the kernel, the
    # precise tanh in the plain version; the same inputs without the cap.
    out_nc, plain_nc = decode_attention(q, kc, vc, vl), decode_attention_plain(q, kc, vc, vl)
    nocap = dict(max_abs_err=max_abs(out_nc, plain_nc), rel_l2=rel_err(out_nc, plain_nc))
    # A second yardstick: SDPA over the valid slots, WITHOUT the soft-cap.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt = q[:, :, None]
    kt = kc[:, :valid].repeat_interleave(H // KV, dim=2).transpose(1, 2)
    vt = vc[:, :valid].repeat_interleave(H // KV, dim=2).transpose(1, 2)
    sdpa_ms = gpu_ms(torch, lambda: sdpa(qt, kt, vt), 50)
    rec = dict(gpu=smi, shape=dict(B=B, S=S, H=H, KV=KV, Dh=Dh, valid_len=valid,
                                   dtype="bfloat16", softcap=cap),
               max_abs_err=err, rel_l2=rel_err(out, plain), uncapped=nocap,
               ms=ms, device_ms=dev_ms, device_ms_by_kernel=dev_by_kernel,
               device_records_seen=seen,
               clocks_sm_mem_power_temp=clocks_after,
               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               flops=flops, bytes=n_bytes, gb_per_s=n_bytes / ms / 1e6,
               device_gb_per_s=n_bytes / dev_ms / 1e6, hbm_share=bms / dev_ms,
               sdpa_no_softcap_ms=sdpa_ms, **lib)
    emit({"phase": "k5_long_cache", **rec})
    return rec


def kernel_class(name):
    """The profiler's kernel name as a class: cuBLAS/CUTLASS matrix products,
    PyTorch's native kernels (elementwise, copies, reductions), or one of
    the port's own kernels (csrc/*.cu, by function name)."""
    if name.startswith("nvjet") or "gemm" in name:
        return "matmul"
    if "at::native::" in name:
        return "pytorch_native"
    if "(anonymous namespace)::" in name:
        return name.split("(anonymous namespace)::")[1].split("<")[0].split("(")[0]
    return "other"


def profile_call(torch, fn):
    """Device time by kernel over one call of ``fn`` (torch.profiler): the
    ten largest kernels and the time of every kernel class."""
    from torch.autograd import DeviceType

    with profiled(torch, PROFILE_PAD_S[0]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # kernels only: CPU ops would count them twice
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    by_class = {}
    for us, key, _ in rows:
        by_class[kernel_class(key)] = by_class.get(kernel_class(key), 0.0) + us / 1e3
    return dict(wall_s=wall, device_busy_s=busy, idle_share=max(0.0, 1 - busy / wall),
                ms_by_class=by_class,
                top=[dict(kernel=k[:90], ms=us / 1e3, calls=c) for us, k, c in rows[:10]])


def phase_prefill(torch, dev, smi, B=1, S=8192, seed=0, check_layers=2):
    """gemma2-27b at full width and depth through make_prefill_step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model

    cfg = get_config(GEMMA)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)}

    # Kernel path vs plain path on the same weights (per-tensor seeding
    # gives the first layers of the full model), 2 layers of full width:
    # each layer's attention output on its own q/k/v, element-wise, with
    # two planted faults that must fail the same test; then the hidden
    # states and logits end to end, with the window-dropped model's reading.
    small = build_model(dataclasses.replace(cfg, num_layers=check_layers), dev).init(seed)
    with torch.no_grad():
        with recorded_calls(attn_mod, "flash_attention", lambda a, kw, out: (a, kw, out)) as calls:
            h_k, _ = small(batch["tokens"])
        per_layer = []
        for i, (layer, (args, kw, out)) in enumerate(zip(small.layers, calls)):
            plain = flash_attention_plain(*args, **kw)
            rd = att_layer_reading(out, plain)
            check(rd["passes"], f"prefill: layer {i} ({layer.kind}) attention vs plain {rd}")
            faults = {"zeros": torch.zeros_like(plain)}
            if kw["window"] is not None:
                faults["no_window"] = flash_attention_plain(*args, **{**kw, "window": None})
            controls = {name: att_layer_reading(bad, plain) for name, bad in faults.items()}
            for name, c in controls.items():
                check(not c["passes"], f"prefill: planted fault {name} passes on layer {i}: {c}")
            per_layer.append(dict(kind=layer.kind, **rd, controls=controls))
            del plain, faults
        del calls
        h_p, _ = small(batch["tokens"], plain=True)
        lg_k, lg_p = small.logits(h_k[:, -1:]), small.logits(h_p[:, -1:])
        small.cfg = dataclasses.replace(small.cfg, sliding_window=S)  # the window dropped
        h_c, _ = small(batch["tokens"], plain=True)
        lg_c = small.logits(h_c[:, -1:])
    torch.cuda.synchronize()
    cmp = dict(layers=check_layers, per_layer=per_layer,
               rel_hidden=rel_err(h_k, h_p), rel_logits=rel_err(lg_k, lg_p),
               max_abs_logits=max_abs(lg_k, lg_p), tol_rel=MODEL_REL,
               same_argmax=bool(torch.equal(lg_k.argmax(-1), lg_p.argmax(-1))),
               no_window_rel_hidden=rel_err(h_c, h_p), no_window_rel_logits=rel_err(lg_c, lg_p))
    check(cmp["rel_hidden"] <= MODEL_REL, f"prefill: kernel vs plain hidden {cmp}")
    check(cmp["rel_logits"] <= MODEL_REL, f"prefill: kernel vs plain logits {cmp}")
    del small, h_k, h_p, h_c
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_prefill_step(model, cfg)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == cfg.num_layers, f"prefill: K4 launched {launches} times, not {cfg.num_layers}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab), f"prefill: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill: non-finite logits")
    check(logits.abs().max().item() <= cfg.final_logit_softcap, "prefill: logits above the soft-cap")
    try:
        prof = profile_call(torch, lambda: step(batch))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               params=n_params, B=B, S=S, init_s=init_s, prefill_s=wall,
               prefill_tokens_per_s=B * S / wall, k4_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               kernel_vs_plain=cmp, profile=prof)
    emit({"phase": "prefill_main", **out})
    return model, out


def phase_serve(torch, dev, smi, model, B=4, prompt=32, gen=32, seed=0):
    """The launch/serve.py loop at full width, then K5 on every layer's
    cache at the last position against the decode path."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import attention as attn_mod

    cfg = model.cfg
    generate(model, cfg, batch=B, prompt_len=4, gen=2, temperature=0.0, seed=seed)  # warm-up
    decode_attention.launches = 0
    flash_attention.launches = 0
    r = generate(model, cfg, batch=B, prompt_len=prompt, gen=gen, temperature=0.0, seed=seed)
    toks = r["tokens"]
    check(tuple(toks.shape) == (B, gen), f"serve: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), "serve: token out of range")
    check(bool(torch.isfinite(r["logits"]).all()), "serve: non-finite logits")

    pos = prompt + gen - 1   # the last slot of the caches
    serve = make_serve_step(model, cfg)
    try:
        prof = profile_call(torch, lambda: serve(r["cache"], toks[:, -1:], pos))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    # attention_decode's attention is K5's plain version at valid_len =
    # min(pos + 1, C); record its inputs and output in one more step.
    def keep(args, kw, out):
        q, k, v, vl = args
        return q.contiguous(), k.clone(), v.clone(), vl, kw["logit_cap"], out

    with torch.no_grad(), recorded_calls(attn_mod, "decode_attention_plain", keep) as calls:
        model.decode_step(r["cache"], toks[:, -1:], pos)
    check(len(calls) == cfg.num_layers, f"serve: {len(calls)} decode attentions recorded")
    err_decode, ok_decode = 0.0, True
    for q, k, v, vl, cap, seen in calls:
        e, ok = att_close(decode_attention(q, k, v, vl, logit_cap=cap), seen)
        err_decode, ok_decode = max(err_decode, e), ok_decode and ok
    torch.cuda.synchronize()
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    check(launches["decode_attention"] == len(calls), f"serve: K5 launches {launches}")
    check(ok_decode, f"serve: K5 vs attention_decode beyond tolerance (max |d| = {err_decode})")
    out = dict(gpu=smi, arch=cfg.name, B=B, prompt_len=prompt, gen=gen,
               prefill_by_decode_s=r["prefill_s"], decode_s=r["decode_s"],
               decode_steps=r["decode_steps"],
               decode_tokens_per_s=B * r["decode_steps"] / r["decode_s"],
               ms_per_decode_step=1e3 * r["decode_s"] / r["decode_steps"],
               launches=launches, k5_pos=pos, k5_layers=len(calls),
               k5_valid_len={layer.kind: c[3] for layer, c in zip(model.layers, calls)},
               k5_max_abs_err_vs_attention_decode=err_decode,
               sample=toks[0, :8].tolist(), profile_one_step=prof)
    emit({"phase": "serve_decode", **out})
    return out


# ---------------------------------------------------------------------------
# the recurrent LMs: rwkv6-1.6b through K7, jamba-1.5-large (5 layers)
# through K6 and K4
# ---------------------------------------------------------------------------
RWKV = "rwkv6-1.6b"
JAMBA = "jamba-1.5-large-398b"
JAMBA_LAYERS = 5


def scan_reading(a, ref, atol, rtol):
    """A scan's output against the plain one: max |d|, the share of
    elements beyond |d| <= atol + rtol |ref|, relative L2, and whether it
    passes both that and SCAN_REL."""
    a, ref = a.float(), ref.float()
    d = (a - ref).abs()
    over = (d > atol + rtol * ref.abs()).float().mean().item()
    rel = rel_err(a, ref)
    return dict(max_abs=d.max().item(), share_over_tol=over, rel_l2=rel,
                passes=over == 0 and rel <= SCAN_REL)


def wkv_reading(a, ref):
    scale = ref.float().square().mean().sqrt().item()
    return scan_reading(a, ref, WKV_TOL * scale, WKV_TOL)


def mamba_reading(a, ref):
    return scan_reading(a, ref, MAMBA_TOL, MAMBA_TOL)


def wkv_chunk_matrix(torch, r, k, v, w, u, chunk=32):
    """The JAX package's chunked matrix form of the WKV scan
    (``repro/models/rwkv.py:80``, ``_wkv_chunk_matrix``) in eager PyTorch,
    from the zero state: the ``yardstick_ms`` reading of K7.  The port
    never calls it."""
    b, t, h, n = r.shape
    logw = torch.log(w)
    s = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device), -1)
    ys = []
    for c0 in range(0, t, chunk):
        rc, kc, vc, lw = (x[:, c0 : c0 + chunk] for x in (r, k, v, logw))
        c = rc.shape[1]
        big_l = torch.cumsum(lw, 1)
        l_prev = big_l - lw
        l_ref = big_l[:, c // 2]
        r_dec = rc * torch.exp(l_prev - l_ref[:, None])
        k_dec = kc * torch.exp(l_ref[:, None] - big_l)
        a = torch.einsum("bthn,bshn->bhts", r_dec, k_dec).masked_fill(~mask[:c, :c], 0.0)
        y = torch.einsum("bhts,bshn->bthn", a, vc)
        y = y + torch.einsum("bthn,bhnm->bthm", rc * torch.exp(l_prev), s)
        y = y + torch.einsum("bthn,bthn->bth", rc * u, kc)[..., None] * vc
        l_end = big_l[:, -1]
        s = torch.exp(l_end)[..., None] * s + torch.einsum(
            "bshn,bshm->bhnm", kc * torch.exp(l_end[:, None] - big_l), vc)
        ys.append(y)
    return torch.cat(ys, 1)


def wkv_bound(B, T, H, N):
    """Bytes: r, k, v, w read once, y written once, u; operations of the
    kernel per (b, t, h): 5 N^2 (y: N^2 FMAs; state: N^2 products and N^2
    FMAs; an FMA is 2) + 3 N (the bonus r . (u * k)) + 5 (the sums)."""
    n_bytes = 4 * (5 * B * T * H * N + H * N)
    ops = B * T * H * (5 * N * N + 3 * N + 5)
    return n_bytes, ops


def mamba_bound(B, T, Di, Ds):
    """Bytes: dA, dBu and C read once, y written once; operations per
    state element and step: one FMA (2), the product with C and its share
    of the sum over Ds (2)."""
    n_bytes = 4 * (2 * B * T * Di * Ds + B * T * Ds + B * T * Di)
    ops = 4 * B * T * Di * Ds
    return n_bytes, ops


def _k7_inputs(torch, dev, B, T, H, N):
    """Seeded r, k, v, u and two decays: rwkv6's range at init,
    exp(-exp(-6 + U)), and tests/test_kernels.py's sigmoid."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    shape = (B, T, H, N)
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    u = 0.5 * torch.randn((H, N), generator=g, device=dev)
    decays = {
        "model": torch.exp(-torch.exp(-6.0 + torch.rand(shape, generator=g, device=dev))),
        "sigmoid": torch.sigmoid(torch.randn(shape, generator=g, device=dev)),
    }
    return r, k, v, u, decays


def phase_k7(torch, dev, smi, B=8, T=8192, H=32, N=64):
    """K7 against its plain version at the rwkv6 prefill layer shape."""
    from repro_torch.kernels.rwkv6_scan import wkv_scan, wkv_scan_plain

    r, k, v, u, decays = _k7_inputs(torch, dev, B, T, H, N)
    rec = {}
    for label, w in decays.items():
        out = wkv_scan(r, k, v, w, u)
        plain = wkv_scan_plain(r, k, v, w, u)
        check(bool(torch.isfinite(out).all()), f"K7 {label}: non-finite output")
        rd = wkv_reading(out, plain)
        check(rd["passes"], f"K7 {label}: out vs plain {rd}")
        rec[label] = rd
        if label == "model":
            plain_model = plain
        del out, plain
    w = decays["model"]
    ms = gpu_ms(torch, lambda: wkv_scan(r, k, v, w, u), 10)
    dev_ms, _, seen = device_ms(torch, lambda: wkv_scan(r, k, v, w, u), 10)
    plain_ms = gpu_ms(torch, lambda: wkv_scan_plain(r, k, v, w, u), 1)
    n_bytes, ops = wkv_bound(B, T, H, N)
    bms, by = bound_ms(n_bytes, ops)
    # yardstick: the JAX package's chunked matrix form, eager, same inputs
    ym = wkv_chunk_matrix(torch, r, k, v, w, u)
    y_rel = rel_err(ym, plain_model)
    check(y_rel <= 1e-3, f"K7 yardstick (chunked matrix form) vs plain: rel L2 {y_rel}")
    yard_ms = gpu_ms(torch, lambda: wkv_chunk_matrix(torch, r, k, v, w, u), 2)
    out = dict(gpu=smi, shape=dict(B=B, T=T, H=H, N=N, dtype="float32"), results=rec,
               max_abs_err=max(x["max_abs"] for x in rec.values()),
               ms=ms, device_ms=dev_ms, device_records_seen=seen, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, bytes=n_bytes, ops=ops,
               gb_per_s=n_bytes / ms / 1e6,
               device_gb_per_s=n_bytes / dev_ms / 1e6, yardstick_ms=yard_ms,
               yardstick_rel_l2_vs_plain=y_rel, library_ms=None)
    emit({"phase": "k7_wkv", **out})
    del r, k, v, u, decays, plain_model, ym
    torch.cuda.empty_cache()
    return out


def _k6_inputs(torch, dev, seed, B, t, di, Ds):
    """Seeded dA, dBu and C of jamba's mixer: dt = softplus(...) in [1e-3,
    0.1] at init (log-uniform dt_bias), A = -(1..Ds), discretised by the
    model's own code."""
    from repro_torch.models.mamba import discretize

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dt = torch.exp(torch.empty((B, t, di), device=dev).uniform_(-6.9078, -2.3026, generator=g))
    a = -torch.arange(1, Ds + 1, dtype=torch.float32, device=dev).expand(di, Ds)
    bm = torch.randn((B, t, Ds), generator=g, device=dev)
    uu = torch.randn((B, t, di), generator=g, device=dev)
    c = torch.randn((B, t, Ds), generator=g, device=dev)
    da, dbu = discretize(dt, bm, uu, a)
    return da, dbu, c


def phase_k6(torch, dev, smi, B=1, T=8192, Ds=16):
    """K6 against its plain version at one d_inner block of jamba's mixer
    (model ranges of dt and A, discretised by the model's own code), and
    at a ragged T and Di."""
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.models.mamba import DISCRETIZE_BLOCK

    rec = {}
    for label, (t, di) in (("ragged", (T - 1, DISCRETIZE_BLOCK - 96)), ("block", (T, DISCRETIZE_BLOCK))):
        da, dbu, c = _k6_inputs(torch, dev, t + di, B, t, di, Ds)
        out = mamba_scan(da, dbu, c)
        plain = mamba_scan_plain(da, dbu, c)
        check(bool(torch.isfinite(out).all()), f"K6 {label}: non-finite output")
        rd = mamba_reading(out, plain)
        check(rd["passes"], f"K6 {label}: out vs plain {rd}")
        rec[label] = dict(T=t, Di=di, **rd)
        del out, plain
    ms = gpu_ms(torch, lambda: mamba_scan(da, dbu, c), 10)
    dev_ms, _, seen = device_ms(torch, lambda: mamba_scan(da, dbu, c), 10)
    plain_ms = gpu_ms(torch, lambda: mamba_scan_plain(da, dbu, c), 1)
    n_bytes, ops = mamba_bound(B, T, DISCRETIZE_BLOCK, Ds)
    bms, by = bound_ms(n_bytes, ops)
    out = dict(gpu=smi, shape=dict(B=B, T=T, Di=DISCRETIZE_BLOCK, Ds=Ds, dtype="float32"),
               results=rec, max_abs_err=max(x["max_abs"] for x in rec.values()),
               ms=ms, device_ms=dev_ms, device_records_seen=seen, plain_ms=plain_ms,
               bound_ms=bms, bound_by=by, bytes=n_bytes, ops=ops,
               gb_per_s=n_bytes / ms / 1e6,
               device_gb_per_s=n_bytes / dev_ms / 1e6, library_ms=None)
    emit({"phase": "k6_mamba", **out})
    del da, dbu, c
    torch.cuda.empty_cache()
    return out


def phase_rwkv6_prefill(torch, dev, smi, B=8, S=8192, seed=0, check_layers=2, cross_len=256):
    """rwkv6-1.6b at full width and depth through make_prefill_step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import wkv_scan, wkv_scan_plain
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models import rwkv as rwkv_mod

    cfg = get_config(RWKV)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)}

    # (a) each of the first 2 layers' K7 output on its own r/k/v/w/u
    # against the plain version, with planted faults; (b) the kernel path
    # against the plain path end to end over those layers.
    small = build_model(dataclasses.replace(cfg, num_layers=check_layers), dev).init(seed)

    def keep(args, kw, out):
        r, k, v, w, u = args
        plain = wkv_scan_plain(r, k, v, w, u)
        rd = wkv_reading(out, plain)
        faults = {"u_dropped": wkv_scan_plain(r, k, v, w, torch.zeros_like(u)),
                  "decay_ignored": wkv_scan_plain(r, k, v, torch.ones_like(w), u)}
        rd["controls"] = {name: wkv_reading(bad, plain) for name, bad in faults.items()}
        return rd

    with torch.no_grad():
        with recorded_calls(rwkv_mod, "wkv_scan", keep) as per_layer:
            h_k, _ = small(batch["tokens"])
        h_p, _ = small(batch["tokens"], plain=True)
        lg_k, lg_p = small.logits(h_k[:, -1:]), small.logits(h_p[:, -1:])
    torch.cuda.synchronize()
    check(len(per_layer) == check_layers, f"rwkv6 prefill: {len(per_layer)} K7 calls recorded")
    for i, rd in enumerate(per_layer):
        check(rd["passes"], f"rwkv6 prefill: layer {i} K7 vs plain {rd}")
        for name, c in rd["controls"].items():
            check(not c["passes"], f"rwkv6 prefill: planted fault {name} passes on layer {i}: {c}")
    cmp = dict(layers=check_layers, per_layer=per_layer, rel_hidden=rel_err(h_k, h_p),
               rel_logits=rel_err(lg_k, lg_p), max_abs_logits=max_abs(lg_k, lg_p),
               tol_rel=MODEL_REL, same_argmax=bool(torch.equal(lg_k.argmax(-1), lg_p.argmax(-1))))
    check(cmp["rel_hidden"] <= MODEL_REL, f"rwkv6 prefill: kernel vs plain hidden {cmp}")
    check(cmp["rel_logits"] <= MODEL_REL, f"rwkv6 prefill: kernel vs plain logits {cmp}")
    del small, h_k, h_p

    # (c) prefill through K7 against the token-by-token decode (plain
    # recurrence) of the same prompt: 2 layers of full width, float32.
    f32 = build_model(dataclasses.replace(cfg, num_layers=check_layers, dtype="float32"), dev).init(seed)
    prompt = batch["tokens"][:2, :cross_len]
    serve = make_serve_step(f32, f32.cfg)

    def decode_all():
        cache = f32.init_cache(prompt.shape[0], cross_len)
        for t in range(cross_len):
            lg, cache = serve(cache, prompt[:, t : t + 1], t)
        return lg

    with torch.no_grad():
        pre = make_prefill_step(f32, f32.cfg)({"tokens": prompt})
        dec = decode_all()
        saved = [layer.rwkv.u.clone() for layer in f32.layers]
        for layer in f32.layers:  # planted fault: the bonus u dropped on the decode path
            layer.rwkv.u.zero_()
        dec_bad = decode_all()
        for layer, u in zip(f32.layers, saved):
            layer.rwkv.u.copy_(u)
    cross = dict(layers=check_layers, prompt_len=cross_len, batch=prompt.shape[0],
                 dtype="float32", rel_logits=rel_err(pre, dec), max_abs_logits=max_abs(pre, dec),
                 tol_rel=CROSS_REL, control_u_dropped_rel_logits=rel_err(pre, dec_bad))
    check(cross["rel_logits"] <= CROSS_REL, f"rwkv6: prefill vs decode logits {cross}")
    check(cross["control_u_dropped_rel_logits"] > CROSS_REL,
          f"rwkv6: the planted fault passes the prefill-vs-decode check {cross}")
    del f32, pre, dec, dec_bad
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_prefill_step(model, cfg)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    wkv_scan.launches = 0
    t0 = time.perf_counter()
    logits = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = wkv_scan.launches
    check(launches == cfg.num_layers, f"rwkv6 prefill: K7 launched {launches} times, not {cfg.num_layers}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab), f"rwkv6 prefill: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "rwkv6 prefill: non-finite logits")
    try:
        prof = profile_call(torch, lambda: step(batch))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               params=n_params, B=B, S=S, init_s=init_s, prefill_s=wall,
               prefill_tokens_per_s=B * S / wall, k7_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               kernel_vs_plain=cmp, prefill_vs_decode=cross, profile=prof)
    emit({"phase": "rwkv6_prefill", **out})
    return model, out


def phase_lm_serve(torch, smi, model, name, B=4, prompt=32, gen=32, seed=0):
    """The launch/serve.py loop at full width: decode tokens/s."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_scan import mamba_scan
    from repro_torch.kernels.rwkv6_scan import wkv_scan
    from repro_torch.launch.serve import generate
    from repro_torch.launch.steps import make_serve_step

    cfg = model.cfg
    generate(model, cfg, batch=B, prompt_len=4, gen=2, temperature=0.0, seed=seed)  # warm-up
    for fn in (flash_attention, mamba_scan, wkv_scan):
        fn.launches = 0
    r = generate(model, cfg, batch=B, prompt_len=prompt, gen=gen, temperature=0.0, seed=seed)
    toks = r["tokens"]
    check(tuple(toks.shape) == (B, gen), f"{name}: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"{name}: token out of range")
    check(bool(torch.isfinite(r["logits"]).all()), f"{name}: non-finite logits")
    serve = make_serve_step(model, cfg)
    try:
        prof = profile_call(torch, lambda: serve(r["cache"], toks[:, -1:], prompt + gen - 1))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, arch=cfg.name, layers=cfg.num_layers, B=B, prompt_len=prompt, gen=gen,
               prefill_by_decode_s=r["prefill_s"], decode_s=r["decode_s"],
               decode_steps=r["decode_steps"],
               decode_tokens_per_s=B * r["decode_steps"] / r["decode_s"],
               ms_per_decode_step=1e3 * r["decode_s"] / r["decode_steps"],
               kernel_launches={"wkv_scan": wkv_scan.launches, "mamba_scan": mamba_scan.launches,
                                "flash_attention": flash_attention.launches},
               sample=toks[0, :8].tolist(), profile_one_step=prof)
    emit({"phase": name, **out})
    return out


def routing_differs(calls_a, calls_b):
    """(B, S) bool: tokens that two runs route differently (expert or
    capacity drop) in any MoE layer."""
    diff = None
    for (ea, ka), (eb, kb) in zip(calls_a, calls_b):
        b, s, k = ea.shape
        d = (ea != eb).any(-1) | (ka != kb).view(b, s, k).any(-1)
        diff = d if diff is None else diff | d
    return diff


def phase_jamba_prefill(torch, dev, smi, B=1, S=8192, seed=0):
    """jamba-1.5-large cut to its first 5 layers, full width, through
    make_prefill_step: K6 on every Mamba layer's d_inner blocks, K4 on the
    attention layer; per-layer checks of both and the kernel path against
    the plain path."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.kernels.mamba_scan import mamba_scan, mamba_scan_plain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.models import mamba as mamba_mod
    from repro_torch.models import moe as moe_mod

    full = get_config(JAMBA)
    cfg = dataclasses.replace(full, num_layers=JAMBA_LAYERS)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 3)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)}
    blocks = -(-cfg.d_inner // mamba_mod.DISCRETIZE_BLOCK)
    mamba_layers = [i for i, k in enumerate(cfg.layer_kinds()) if k == "mamba"]
    attn_layers = [i for i, k in enumerate(cfg.layer_kinds()) if k in ("global", "local")]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg, dev).init(seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    step = make_prefill_step(model, cfg)
    step(batch)  # warm-up
    torch.cuda.synchronize()
    mamba_scan.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    logits = step(batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"mamba_scan": mamba_scan.launches, "flash_attention": flash_attention.launches}
    check(launches["mamba_scan"] == len(mamba_layers) * blocks,
          f"jamba prefill: K6 launched {launches['mamba_scan']} times, not {len(mamba_layers) * blocks}")
    check(launches["flash_attention"] == len(attn_layers), f"jamba prefill: K4 launches {launches}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab), f"jamba prefill: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "jamba prefill: non-finite logits")
    peak = torch.cuda.max_memory_allocated() / 1e9

    # (a) every K6 call (each Mamba layer's d_inner blocks) and (b) the K4
    # call on the attention layer, each on its own inputs against the plain
    # version, with planted faults on the first block of each layer;
    # (c) the kernel path against the plain path end to end.
    def keep_k6(args, kw, out):
        da, dbu, c = args
        plain = mamba_scan_plain(da, dbu, c)
        rd = mamba_reading(out, plain)
        if len(k6_calls) % blocks == 0:
            faults = {"c_zeroed": torch.zeros_like(plain),
                      "decay_ignored": mamba_scan_plain(torch.ones_like(da), dbu, c)}
            rd["controls"] = {name: mamba_reading(bad, plain) for name, bad in faults.items()}
        return rd

    def keep_k4(args, kw, out):
        plain = flash_attention_plain(*args, **kw)
        rd = att_layer_reading(out, plain)
        rd["controls"] = {"zeros": att_layer_reading(torch.zeros_like(plain), plain)}
        return rd

    # Near-tie router choices fall the other way under the two paths' bf16
    # roundings (~1 % of the tokens at this size; a choice moved at one
    # expert also moves that expert's capacity cut), and one token routed
    # elsewhere changes its FFN output wholesale: the plain path replays
    # the kernel path's routing, and the tokens its own router would have
    # routed differently are counted, as a reading.
    own_routing = []

    def replayed_route(p, x, cfg_):
        theirs = route_k[len(own_routing)]
        mine = real_route(p, x, cfg_)
        own_routing.append(((mine.experts, mine.keep), (theirs.experts, theirs.keep)))
        return theirs

    real_route = moe_mod.moe_route
    with torch.no_grad():
        with recorded_calls(mamba_mod, "mamba_scan", keep_k6) as k6_calls, \
                recorded_calls(attn_mod, "flash_attention", keep_k4) as k4_calls, \
                recorded_calls(moe_mod, "moe_route", lambda a, kw, out: out) as route_k:
            h_k, aux_k = model(batch["tokens"])
        moe_mod.moe_route = replayed_route
        try:
            h_p, _ = model(batch["tokens"], plain=True)
        finally:
            moe_mod.moe_route = real_route
        lg_k, lg_p = model.logits(h_k[:, -1:]), model.logits(h_p[:, -1:])
    torch.cuda.synchronize()
    check(len(k6_calls) == len(mamba_layers) * blocks, f"jamba: {len(k6_calls)} K6 calls recorded")
    for i, rd in enumerate(k6_calls):
        where = f"layer {mamba_layers[i // blocks]} block {i % blocks}"
        check(rd["passes"], f"jamba prefill: K6 {where} vs plain {rd}")
        for name, c in rd.get("controls", {}).items():
            check(not c["passes"], f"jamba prefill: planted fault {name} passes on {where}: {c}")
    for i, rd in zip(attn_layers, k4_calls):
        check(rd["passes"], f"jamba prefill: layer {i} K4 vs plain {rd}")
        check(not rd["controls"]["zeros"]["passes"], f"jamba prefill: zeros pass K4's check on layer {i}")
    diff = routing_differs([m for m, _ in own_routing], [t for _, t in own_routing])
    n_diff = int(diff.sum())
    dropped = [int((~rt.keep).sum()) for rt in route_k]
    capacity = route_k[0].capacity
    cmp = dict(
        k6_calls=len(k6_calls), k6_worst_rel_l2=max(rd["rel_l2"] for rd in k6_calls),
        k6_worst_max_abs=max(rd["max_abs"] for rd in k6_calls),
        k6_controls=[rd["controls"] for rd in k6_calls if "controls" in rd],
        k4_per_layer=k4_calls, plain_router_differs_tokens=n_diff,
        rel_hidden=rel_err(h_k, h_p), rel_logits=rel_err(lg_k, lg_p),
        max_abs_logits=max_abs(lg_k, lg_p), tol_rel=MODEL_REL, aux=aux_k.item(),
        same_argmax=bool(torch.equal(lg_k.argmax(-1), lg_p.argmax(-1))))
    check(len(own_routing) == len(route_k) == cfg.ffn_kinds().count("moe"),
          f"jamba prefill: {len(route_k)} MoE routings recorded")
    check(cmp["rel_hidden"] <= MODEL_REL, f"jamba prefill: kernel vs plain hidden {cmp}")
    check(cmp["rel_logits"] <= MODEL_REL, f"jamba prefill: kernel vs plain logits {cmp}")
    del h_k, h_p, k6_calls, k4_calls, route_k, own_routing
    try:
        prof = profile_call(torch, lambda: step(batch))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               reduced={"num_layers": f"{full.num_layers} -> {cfg.num_layers}"},
               params=n_params, param_count=cfg.param_count(),
               active_param_count=cfg.active_param_count(), B=B, S=S, init_s=init_s,
               prefill_s=wall, prefill_tokens_per_s=B * S / wall, launches=launches,
               d_inner_block=mamba_mod.DISCRETIZE_BLOCK, moe_capacity=capacity,
               moe_choices_dropped=dropped, moe_choices=B * S * cfg.top_k,
               peak_mem_gb=peak, kernel_vs_plain=cmp, profile=prof)
    emit({"phase": "jamba_prefill", **out})
    return model, out


def main() -> int:
    # torch.compile (the flex_attention reading) caches inside the checkout.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
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

    walls = {}

    def timed(name, fn, *args):
        """Run one phase and keep its wall time (seconds, host clock)."""
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    smi = timed("card", phase_card, torch)
    k1 = timed("k1", phase_k1, torch, np, dev, smi)
    k2 = timed("k2", phase_k2, torch, np, dev, smi)
    res, main_out, k3_err, near_cells = timed("k3_main_path", phase_main, torch, np, dev, smi,
                                              k1[10]["device_ms"])
    k3_large = timed("k3_large_K", phase_k3_large, torch, np, dev, smi)
    scan = timed("k1_scan_path", phase_scan, torch, dev, smi, res, near_cells)
    topm = timed("k2_topm_path", phase_topm_path, torch, dev, smi)
    del res
    torch.cuda.empty_cache()
    reliability, rel_args = timed("reliability", phase_reliability, torch, np, dev, smi)
    robustness = timed("robustness", phase_robustness, torch, np, dev, smi)
    radio_grid, radio_args = timed("radio_grid", phase_radio_grid, torch, np, dev, smi)
    baselines = timed("baselines", phase_baselines, torch, np, dev, smi)
    telemetry = timed("telemetry", phase_telemetry, torch, np, dev, smi, rel_args, radio_args)
    del rel_args, radio_args
    torch.cuda.empty_cache()
    k4 = timed("k4_flash", phase_k4, torch, dev, smi)
    k5 = timed("k5_long_cache", phase_k5_long, torch, dev, smi)
    torch.cuda.empty_cache()
    model, prefill = timed("prefill_main", phase_prefill, torch, dev, smi)
    serve = timed("serve_decode", phase_serve, torch, dev, smi, model)
    del model
    torch.cuda.empty_cache()
    k7 = timed("k7_wkv", phase_k7, torch, dev, smi)
    k6 = timed("k6_mamba", phase_k6, torch, dev, smi)
    model, rwkv_prefill = timed("rwkv6_prefill", phase_rwkv6_prefill, torch, dev, smi)
    rwkv_serve = timed("rwkv6_serve", phase_lm_serve, torch, smi, model, "rwkv6_serve")
    del model
    torch.cuda.empty_cache()
    model, jamba_prefill = timed("jamba_prefill", phase_jamba_prefill, torch, dev, smi)
    jamba_serve = timed("jamba_serve", phase_lm_serve, torch, smi, model, "jamba_serve")
    del model
    torch.cuda.empty_cache()

    k1_main = k1[10]
    rob_inst = robustness["launches"]["ocean_traj_instances"]
    kernels = [
        dict(name="ocean_p_prefix", route="cuda", source="src/repro_torch/csrc/ocean_p.cu",
             replaces="src/repro/kernels/ocean_p.py:48",
             launches=scan["launches"]["ocean_p_prefix"],
             launches_lookahead_dual=baselines["lookahead_dual"]["k1_launches"],
             max_abs_err=max(r["max_abs_err_b"] for r in k1.values()),
             ms=k1_main["ms"], device_ms=k1_main["device_ms"], plain_ms=k1_main["plain_ms"],
             bound_ms=k1_main["bound_ms"], bound_by=k1_main["bound_by"], library_ms=None),
        dict(name="ocean_p_topm", route="cuda", source="src/repro_torch/csrc/ocean_p.cu",
             replaces="src/repro/kernels/ocean_p.py:232",
             launches=topm["launches"]["ocean_p_topm"], max_abs_err=k2["max_abs_err_b"],
             ms=k2["ms"], device_ms=k2["device_ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             cluster=k2["cluster"], warps=k2["warps"]),
        dict(name="ocean_traj", route="cuda", source="src/repro_torch/csrc/ocean_traj.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=main_out["launches"]["ocean_traj"],
             max_abs_err=max([k3_err, reliability["max_abs_err_b"],
                              radio_grid["teacher_forced"]["max_abs_err_b"],
                              robustness["max_abs_err_b"]]
                             + [r["max_abs_err_b"] for r in k3_large.values()]),
             ms=main_out["k3_ms"], device_ms=main_out["k3_device_ms"],
             plain_ms=main_out["k3_plain_ms"],
             bound_ms=main_out["bound_ms"], bound_by=main_out["bound_by"], library_ms=None,
             instances={
                 "radio": dict(launches=radio_grid["launches"]["ocean_traj_instances"]["radio"],
                               **{k: radio_grid[k] for k in INSTANCE_KEYS}),
                 **{f"failure/{OCEAN_FAILURE_MODES[p]}": dict(
                     launches=v["launches"], **{k: v[k] for k in INSTANCE_KEYS})
                    for p, v in reliability["k3"].items()},
                 # the robustness phase's readings; launches by label there
                 **{name: dict(launches=sum(n for label, n in rob_inst.items()
                                            if label == name or name == "chaos" and name in label),
                               **{k: robustness["k3"][name][k] for k in INSTANCE_KEYS})
                    for name in ("guard", "bisect", "chaos")},
             }),
        dict(name="ocean_traj_metrics", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_metrics.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=telemetry["launches"]["ocean_traj_instances"]["metrics"],
             max_abs_err=telemetry["max_abs_err"],
             ms=telemetry["k3_ms"], device_ms=telemetry["k3_device_ms"],
             plain_ms=telemetry["k3_plain_ms"], plain_rounds=telemetry["k3_plain_rounds"],
             bound_ms=telemetry["bound_ms"], bound_by=telemetry["bound_by"], library_ms=None,
             instances={name: {k: r[k] for k in ("instance", "launches", "max_abs_err", "ms",
                                                 "plain_ms", "plain_rounds", "bound_ms",
                                                 "bound_by")}
                        for name, r in telemetry["instances"].items()}),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=prefill["k4_launches"],
             max_abs_err=max(r["max_abs_err"] for r in k4["results"].values()),
             ms=k4["results"]["global"]["ms"], device_ms=k4["results"]["global"]["device_ms"],
             plain_ms=k4["results"]["global"]["plain_ms"],
             bound_ms=k4["results"]["global"]["bound_ms"],
             bound_by=k4["results"]["global"]["bound_by"],
             library_ms=k4["results"]["global"]["library_ms"],
             library_device_ms=k4["results"]["global"].get("library_device_ms")),
        dict(name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:27",
             launches=serve["launches"]["decode_attention"],
             max_abs_err=max(k5["max_abs_err"], serve["k5_max_abs_err_vs_attention_decode"]),
             ms=k5["ms"], device_ms=k5["device_ms"], plain_ms=k5["plain_ms"],
             bound_ms=k5["bound_ms"], bound_by=k5["bound_by"], library_ms=k5["library_ms"],
             library_device_ms=k5.get("library_device_ms")),
        dict(name="mamba_scan", route="cuda", source="src/repro_torch/csrc/mamba_scan.cu",
             replaces="src/repro/kernels/mamba_scan.py:27",
             launches=jamba_prefill["launches"]["mamba_scan"],
             max_abs_err=max(k6["max_abs_err"], jamba_prefill["kernel_vs_plain"]["k6_worst_max_abs"]),
             ms=k6["ms"], device_ms=k6["device_ms"], plain_ms=k6["plain_ms"],
             bound_ms=k6["bound_ms"],
             bound_by=k6["bound_by"], library_ms=None),
        dict(name="wkv_scan", route="cuda", source="src/repro_torch/csrc/rwkv6_scan.cu",
             replaces="src/repro/kernels/rwkv6_scan.py:29",
             launches=rwkv_prefill["k7_launches"],
             max_abs_err=max([k7["max_abs_err"]] + [
                 rd["max_abs"] for rd in rwkv_prefill["kernel_vs_plain"]["per_layer"]]),
             ms=k7["ms"], device_ms=k7["device_ms"], plain_ms=k7["plain_ms"],
             bound_ms=k7["bound_ms"],
             bound_by=k7["bound_by"], library_ms=None, yardstick_ms=k7["yardstick_ms"]),
    ]
    emit({"phase": "lm_rates", "gpu": smi,
          "rwkv6_prefill_tokens_per_s": rwkv_prefill["prefill_tokens_per_s"],
          "rwkv6_decode_tokens_per_s": rwkv_serve["decode_tokens_per_s"],
          "jamba_prefill_tokens_per_s": jamba_prefill["prefill_tokens_per_s"],
          "jamba_decode_tokens_per_s": jamba_serve["decode_tokens_per_s"]})
    emit({"phase": "wall_s", "gpu": smi, **walls})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
