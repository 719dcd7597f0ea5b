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
just after.  Then K3's ranking and solver branches (phase ``k3_ranking``):
the §VI grid with solver="newton", and K = 2048 under ranking="topm"
(top_m 128) with pallas, newton and pallas_tiled, each bit for bit the
sort instance on the rounds whose optimum fits and held to its plain
version round by round.  Then K3's wide instances (phase ``k3_wide``,
``csrc/ocean_traj_wide.cuh``): bit for bit the shared-memory top-m instance
at K = 100 and 2048, for each solver, the streamed radio, failure plain and
reallocate, the guard, objective chaos of bisect and the overhead spec;
traj_bench's K-scaling cell (K = 10^4, 8 cells x 8
rounds, pallas_tiled, top_m 128) through ``run_grid`` on traj="fused"
(one wide launch) beside traj="scan" (K2 every round) and against the
plain version, the same shape for pallas, newton and bisect, and for the
failure, guard, chaos and telemetry branches through ``run_grid`` and
``simulate`` (segmented and resumed telemetry runs bit for bit the whole
one); K = 10^5 with
``stream_bf16`` through ``simulate``, its bf16 rows the float32 rows cast.
Then K3's wide ranked row (phase ``k3_ranked``): ranking="sort", a top-m
clip past 2048 and overprovision, sorted inside the kernel, bit for bit
the shared-memory instances at K = 100 and 2048 and held to the plain
rounds at K = 10^4 (traj_bench's K-scaling cell under sort beside the
scan path's K1 rounds, its round cell against top-m 128, overprovision
through ``run_grid`` under top-m, sort and the energy cap, a clip of
4096).

Then the LM serving path at gemma2-27b's full width and depth (46 layers,
27.2e9 random bf16 parameters from a seed): K4 and K5 against their plain
versions at the model's shapes (K4 also at jamba-1.5-large's attention
layer, and with gemma2's soft-cap removed, which isolates the soft-cap's
error), ``make_prefill_step`` on one 8192-token prompt through K4 (one
launch per layer; the kernel path held to the plain path at 2 full-width
layers), and the ``launch/serve.py`` loop (batch 4, prompt 32, 32 new
tokens), after which K5 runs on every
layer's cache at the last position, on the inputs the decode step gave
its attention there, and is held to what that attention computed.  The
same two phases run gemma3-1b at full width and depth (26 layers of
head_dim 256, MQA with 4 query heads, a 5:1 local:global pattern with a
window of 1024, 1.0e9 random bf16 parameters): ``gemma3_prefill`` on 4 x
8192 tokens (K4 once per layer; the kernel path held to the plain path
on the first 6 layers, five local and a global one) and ``gemma3_serve``
(K5 on all 26 caches, the local layers' rings among them).  ``k4_flash``
also holds K4 at gemma3-1b's global and local shapes (B = 4, head_dim
256) with planted faults, and K4's float32 kernel at gemma3-1b's and
gemma2-27b's global shapes; ``smoke_f32_prefill`` runs
``make_prefill_step`` in float32 on the card for the smoke variants of
gemma3-1b, gemma2-27b and jamba-1.5-large (K4's float32 kernel once per
attention layer), each held to its plain path.

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
fault that must fail.  Then checkpoint/resume (``repro_torch.checkpoint``):
the §VI grid with and without that spec run as 64-round segments (K3's
segment launches) and resumed from round 128, bit for bit the whole grid;
one segmented run per other K3 instance family, K = 2048, the scan path
and the baselines, each bit for bit its whole run.

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


def ops_candidate(m, outer, inner, setup=None):
    """One candidate of the prefix sweep with m members (``setup``: its
    bracket's operations, by default K1's seed from the members' rho)."""
    per_outer = m * (ops_b_of_lam(inner) + 1 + 2 + OPS_F_SECOND + 4) + 14
    final = m * (ops_b_of_lam(inner) + 1)
    repair = m * (4 + 8 + OPS_F_SHANNON + 2) + 12
    setup = 2 * m + 20 + OPS_F_PRIME if setup is None else setup
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


def ops_candidate_grid(m, outer, inner, grid):
    """One candidate of the newton sweep with m members (ocean_common.cuh,
    GridCandidate): its bracket from the grid's bits (a compare and a min
    or max a level), then ``ops_candidate``'s polish, final allocation and
    repair at the newton budgets."""
    return ops_candidate(m, outer, inner, setup=20 + 3 * grid)


def ops_grid_pass(K, n_c, inner, grid):
    """The newton sweep's per-round seed grid (newton_grid_seeds) over n_c
    candidate slots: two reductions over the row, the levels' bounds and
    exp/log, ``grid`` b(lam) a slot, and each level's prefix sums (a
    shuffle scan, a compare and a bit per slot)."""
    return 4 * K + 40 + grid * 6 + grid * n_c * (ops_b_of_lam(inner) + 1 + 5 * 2 + 4)


def ops_newton_sweep(torch, counts, K):
    """``ops_sweep`` of the newton solver at its float32 budgets at K, with
    each round's seed grid over its candidates."""
    from repro_torch.core.solvers import newton_iteration_budgets

    outer, inner, grid = newton_iteration_budgets(torch.float32, K)
    return (ops_sweep(counts, outer, inner,
                      lambda m, o, i: ops_candidate_grid(m, o, i, grid))
            + sum(ops_grid_pass(K, n, inner, grid) for n in counts))


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
# The §VI grid's K3 instance (K <= 16: half-warp teams; no radio, failure,
# guard or bisect branch; no telemetry), as ptxas names it.
K3_VI_INSTANCE = r"ocean_traj_kernelILi16ELb0ELb0ELb0EL[bi]0E.*NoMetrics"


def ptxas_kernels(output):
    """Every kernel's ptxas report in an ``nvcc -Xptxas -v`` output: the
    mangled name, registers, stack frame and spill bytes."""
    import re

    rows, name, frame = [], None, None
    for ln in output.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", ln)
        if m:
            frame = [int(x) for x in m.groups()]
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.append(dict(name=name, registers=int(m.group(1)), stack_bytes=frame[0],
                             spill_store_bytes=frame[1], spill_load_bytes=frame[2]))
            name = None
    return rows


def ptxas_of(output, pattern):
    """The ptxas report of the one kernel whose name matches ``pattern``."""
    import re

    hits = [r for r in ptxas_kernels(output or "") if re.search(pattern, r["name"])]
    return hits[0] if len(hits) == 1 else None


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
    log = _build.build_output("ocean_traj")
    vi = ptxas_of(log, K3_VI_INSTANCE)
    check(log is None or (vi is not None and vi["spill_store_bytes"] == 0
                          and vi["spill_load_bytes"] == 0),
          f"card: K3's §VI instance spills or is missing from ptxas's report ({vi})")
    # K4's head_dim-256 instances (bf16 wgmma, float32 FFMA): registers and
    # spills, recorded (the bf16 one's 168 is the launch bound's cap; its
    # consumers run under setmaxnreg's 240).
    k4_log = _build.build_output("flash_attention")
    k4 = {"bf16_dh256": ptxas_of(k4_log, r"flash_attention_kernelILi256E"),
          "f32_dh256": ptxas_of(k4_log, r"flash_attention_f32_kernelILi256E")}
    check(k4_log is None or None not in k4.values(),
          f"card: K4's head_dim-256 instances are missing from ptxas's report ({k4})")
    emit({
        "phase": "card", "gpu": smi, "torch": torch.__version__,
        "cuda": torch.version.cuda, "build_s": round(build_s, 3),
        "nvcc_s": {k: round(v["seconds"], 3) for k, v in _build.BUILD_LOG.items()},
        "ptxas": ptxas, "k3_vi_instance": vi, "k4_dh256": k4,
        "spilling_kernels": {k: [(r["name"], r["spill_store_bytes"], r["spill_load_bytes"])
                                 for r in ptxas_kernels(v["output"]) if r["spill_store_bytes"]]
                             for k, v in _build.BUILD_LOG.items()},
    })
    return smi, k4


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
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels.ocean_p import _scal, prefix_objectives_plain
    from repro_torch.kernels.ocean_traj import _plain_solver

    P, S, N, T, K = res.a.shape
    CT = S * N * T
    q_pre = res.q[p_idx].reshape(CT, K)
    h2 = res.h2.reshape(CT, K)
    inc = res.budget_inc.reshape(CT, K)
    t_idx = torch.arange(T, device=dev, dtype=torch.int32).repeat(S * N)
    eta_c = eta.repeat(S * N)
    plain_cfg = dataclasses.replace(cfg, solver=_plain_solver(get_solver(cfg.solver)),
                                    traj="scan")
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
    w = prefix_objectives_plain(_scal(n0, delta, v * eta_c, rows, rho_sorted), rho_sorted,
                                n_cands=min(cfg.top_m, K) if cfg.ranking == "topm" else K)
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
    from repro_torch.kernels.ocean_traj import m_star, ocean_traj, ocean_traj_plain, rounds_alone
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
             fallback=None, newton=False, n_cands=None, wide=False, row_bytes=4, ranked=False):
    """K3's bound on (C, T, K) priorities: per cell-round the sweep runs
    K - n0 candidates, at most ``n_cands`` (the top-m clip; K1's Newton, or
    with ``bisect`` the bisect sweep, with ``newton`` the newton sweep and
    its seed grid);
    the sort is P log2(P)(log2(P)+1)/4 exchanges; the ``wide`` instances
    (csrc/ocean_traj_wide.cuh) sort only the clip's list, n_cands padded to a
    power of two (its keys and appends are in the ~30 K operations a round
    every instance counts), but on the ``ranked`` row, which sorts all K
    keys (P the power of two above K) and writes and reads each client's
    key, rank and ranked priority once a round (20 bytes).  The b, e, q_pre and rho rows take
    ``row_bytes`` a value (2 under stream_bf16).  The streamed-radio
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
    if n_cands is not None:
        per_round = torch.clamp(per_round, max=n_cands)
    counts = per_round.reshape(-1).tolist()
    Pp = max(32, 1 << (K - 1).bit_length())
    if wide and not ranked:
        Pp = 1 << (min(n_cands, K) - 1).bit_length()
    lg = int(math.log2(Pp))
    sort_ops = Pp * lg * (lg + 1) // 4 * 8
    if bisect:
        ops = ops_bisect_sweep(counts)
    elif newton:
        ops = ops_newton_sweep(torch, counts, K)
    else:
        ops = ops_sweep(counts, OUTER_ITERS, INNER_ITERS)
    ops += C * T * (sort_ops + 30 * K)
    n_bytes = C * T * K * (4 * 2 + row_bytes * 4 + 1) + C * T * 4 * 4 + C * K * 4 * 2
    if ranked:
        n_bytes += C * T * K * 20
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
# K3 under ranking="topm", and its newton and pallas_tiled solvers
# ---------------------------------------------------------------------------
# the top-m instances of phase_k3_ranking, by solver; pallas_tiled's sort
# counterpart is pallas (on finite W its non-finite mask never acts)
RANKED_SOLVERS = ("pallas", "newton", "pallas_tiled")
RANKED_LABELS = {"pallas": "topm", "newton": "newton+topm", "pallas_tiled": "pallas_tiled+topm"}
RANK_FIELDS = ("a", "b", "e", "obj", "nsel")


def _k3_ranked_inputs(torch, np, dev, C, T, K, seed):
    """``_k3_inputs`` with the §VI per-client load at any K: the model's
    bits cut with b_min, so that beta / b_min is what it is at b_min = 0.02.
    With the §VI bits at K = 2048, f(b_min) ~ 2^80 b_min: no client with a
    positive queue is ever selected, and the newton solver's W is NaN."""
    from repro_torch.core.energy import RadioParams

    cfg, h2, v, eta, inc = _k3_inputs(torch, np, dev, C, T, K, seed)
    b_min = cfg.radio.b_min
    radio = RadioParams(b_min=b_min, model_bits=RadioParams().model_bits * b_min / 0.02)
    return dataclasses.replace(cfg, radio=radio), h2, v, eta, inc


def _plain_rounds(torch, cfg, q_pre, h2, v, eta, inc, chunk=160, failure=None):
    """The plain round of ``cfg``'s solver on every (cell, round) of the
    (C, T, K) queues ``q_pre`` (``failure`` a TracedFailure of (C, T, K)
    masks and (C, K) rates), ``chunk`` cell-rounds at a time: (C * T, ...)
    a, b, objective and num_selected, and the delivered mask, reallocation
    flags and guard counters the round reports."""
    from repro_torch.core.ocean import OceanState, ocean_round
    from repro_torch.core.solvers import get_solver
    from repro_torch.kernels.ocean_traj import _plain_solver

    C, T, K = h2.shape
    CT = C * T
    plain_cfg = dataclasses.replace(cfg, solver=_plain_solver(get_solver(cfg.solver)),
                                    traj="scan")
    q, hh, ii = (x.reshape(CT, K) for x in (q_pre, h2, inc))
    vv, ee = v.reshape(CT), eta.reshape(CT)
    t = torch.arange(T, dtype=torch.int32, device=h2.device).repeat(C)
    dlv = rate = None
    if failure is not None:
        dlv = failure.delivered.reshape(CT, K)
        rate = failure.rate[:, None, :].expand(C, T, K).reshape(CT, K)
    parts = []
    for i in range(0, CT, chunk):
        sl = slice(i, i + chunk)
        state = OceanState(q=q[sl], t=t[sl], energy_spent=torch.zeros_like(q[sl]))
        parts.append(ocean_round(state, hh[sl], vv[sl], ee[sl], plain_cfg, budget_inc=ii[sl],
                                 delivered=None if dlv is None else dlv[sl],
                                 fail_rate=None if rate is None else rate[sl])[1])
    return {f: None if getattr(parts[0], f) is None else torch.cat([getattr(d, f) for d in parts])
            for f in ("a", "b", "objective", "num_selected") + BRANCH_ROWS}


# The rows the failure and guard branches add: TrajOut's names and the
# RoundDecision's.
BRANCH_FIELDS = ("dlv", "ral", "fc", "dm", "fb")
BRANCH_ROWS = ("delivered", "realloc", "fault_count", "demoted", "fallback")


# A round whose P3 value K3 and the plain round agree on within FLAT_W_RTOL
# (relative, floor v eta) but whose allocations differ beyond B_ATOL has a
# flat optimum: there float32 resolves b only to a few 1e-4 (at K = 2048
# K1 lands 2.1e-4 from the float64 optimum even at 40 x 40 Newton steps,
# the reference's own float32 solvers 1.0e-4 to 2.4e-4, ``tools/
# flat_rounds.py``).  Such a round is counted and held to the float64
# optimum (the plain bisect solver, FLAT_ITERS halvings, outer and inner,
# in plain PyTorch on the inputs' device) as the reference's own test of
# its backends on random radios holds them to each other
# (tests/test_solvers.py:76-101): the same selection and sum(b) within
# FLAT_SUM_ATOL; beyond it, P3 no more than one float32 ulp short of the
# optimum's and b within FLAT_B_ATOL of it.  Under overprovision, whose
# extended set is re-solved, the optimum is that set's masked P4
# (``_masked_witness``).  Only where a caller asks: with ``flat64`` (the
# ranked row's runs with ~10^4 clients selected, whose float32 P3 outputs
# carry a 10^4-term cost sum's order) a round is also flat by its two
# allocations' P3 values in float64 (``_p3_64``); with ``resolvable`` (the
# clip of 4096 on the §VI per-client load, ROADMAP Queue 3) also a flat
# round's b is held within the deviation that moves the client's cost term
# by one float32 ulp of P3 where that exceeds FLAT_B_ATOL, at most
# FLAT_B_CAP (``_b_resolvable``).
FLAT_W_RTOL = 1e-6
FLAT_ITERS = 60
FLAT_SUM_ATOL = 1e-5
FLAT_B_ATOL = 10 * B_ATOL
FLAT_B_CAP = 0.1


def _flat_witness(torch, cfg, rows, got, pl, q_pre, h2, v, eta, resolvable=False):
    """The float64 optimum of the rounds ``rows`` (indices into the C x T
    cell-rounds) beside K3's ``got`` and the plain round's ``pl``: per
    round, whether K3 selects as the optimum does, each side's max |b -
    b64| and |sum(b) - sum(b64)|, and each side's float64 P3 shortfall
    from the optimum in float32 ulps of the optimum's P3; with
    ``resolvable``, each side's max |b - b64| over ``_b_resolvable``'s."""
    from repro_torch.core.selection import ocean_p, p3_value, priorities

    C, T, K = h2.shape
    f64 = torch.float64
    t = rows % T
    q = q_pre.reshape(-1, K)[rows].to(f64)
    q = torch.where(((t > 0) & (t % cfg.R == 0))[:, None], torch.zeros_like(q), q)
    hh = h2.reshape(-1, K)[rows].to(f64)
    vv, ee = (x.reshape(-1)[rows].to(f64) for x in (v, eta))
    sol = ocean_p(q, hh, vv, ee, cfg.radio, solver="bisect", ranking=cfg.ranking,
                  top_m=cfg.top_m, outer_iters=FLAT_ITERS, inner_iters=FLAT_ITERS)
    w64 = p3_value(sol.a, sol.b, q, hh, vv, ee, cfg.radio)
    w32 = w64.abs().float()
    ulp = (torch.nextafter(w32, torch.full_like(w32, math.inf)) - w32).to(f64)
    out = dict(rounds=rows.tolist(), same_a=(got.a.reshape(-1, K)[rows] == sol.a).all(1).tolist())
    res = _b_resolvable(torch, cfg, priorities(q, hh), sol.b, ulp) if resolvable else None
    for name, a, b in (("kernel", got.a.reshape(-1, K)[rows], got.b.reshape(-1, K)[rows]),
                       ("plain", pl["a"][rows], pl["b"][rows])):
        b = b.to(f64)
        out[f"{name}_b_off"] = (b - sol.b).abs().amax(1).tolist()
        if res is not None:
            out[f"{name}_b_excess"] = ((b - sol.b).abs() / res).amax(1).tolist()
        out[f"{name}_sum_off"] = (b.sum(1) - sol.b.sum(1)).abs().tolist()
        out[f"{name}_p3_short_ulps"] = ((w64 - p3_value(a, b, q, hh, vv, ee, cfg.radio))
                                        / ulp).tolist()
    return out


def _b_resolvable(torch, cfg, rho, b64, ulp):
    """Per client, how far from the float64 optimum ``b64`` a flat round's
    b is held under ``resolvable``: FLAT_B_ATOL, or where larger the
    deviation that moves the client's P3 cost term by one float32 ulp
    ``ulp`` of the optimum's P3 at its curvature, sqrt(2 ulp / (scale rho
    f''(b64))), at most FLAT_B_CAP.  Where f is flat in b (b >> beta:
    f(b) -> beta ln 2) no float32 sweep resolves b finer, the plain
    version's neither (ROADMAP Queue 3); zero-rho clients stay at
    FLAT_B_ATOL."""
    beta = torch.as_tensor(cfg.radio.beta, dtype=torch.float64)
    scale = float(cfg.radio.energy_scale)
    bb = torch.clamp(b64, min=1e-30)
    f2 = math.log(2.0) ** 2 * torch.exp2(torch.clamp(beta / bb, max=80.0)) * beta ** 2 / bb ** 3
    dev = torch.sqrt(2.0 * ulp[:, None] / (scale * rho * f2))
    dev = torch.where((rho > 1e-30) & (b64 > 0), dev, torch.zeros_like(dev))
    return torch.clamp(torch.nan_to_num(dev, nan=0.0, posinf=FLAT_B_CAP), min=FLAT_B_ATOL,
                       max=FLAT_B_CAP)


def _p3_64(torch, cfg, rows, *allocs, q_pre, h2, v, eta):
    """The float64 P3 value of each (a, b) allocation in ``allocs`` ((C*T,
    K) rows) on the cell-rounds ``rows`` of the (C, T, K) queues, with the
    frame reset and the guard's quarantine applied as the round applies
    them."""
    from repro_torch.core.selection import p3_value

    C, T, K = h2.shape
    f64 = torch.float64
    t = rows % T
    q = q_pre.reshape(-1, K)[rows].to(f64)
    q = torch.where(((t > 0) & (t % cfg.R == 0))[:, None], torch.zeros_like(q), q)
    hh = h2.reshape(-1, K)[rows].to(f64)
    if cfg.guard is not None and cfg.guard.quarantine:
        hh = torch.where(torch.isfinite(hh) & (hh > 0), hh, torch.ones_like(hh))
    vv, ee = (x.reshape(-1)[rows].to(f64) for x in (v, eta))
    return [p3_value(a[rows], b[rows].to(f64), q, hh, vv, ee, cfg.radio) for a, b in allocs]


def _masked_witness(torch, cfg, rows, got, pl, q_pre, h2, v, eta, resolvable=False):
    """``_flat_witness`` for a failure mode that re-solves the selected set
    (overprovision's extended prefix): the float64 optimum of the masked
    P4 of the rounds' selected set ``got.a`` (the bisect solve_p4,
    FLAT_ITERS halvings; the set's zero-rho members split as
    ``core.ocean._masked_p4`` splits them), the kernel's and the plain
    round's b and P3 value beside it.  ``same_a``: the kernel's set is the
    plain round's; ``resolvable`` as there."""
    from repro_torch.core.bandwidth import solve_p4
    from repro_torch.core.selection import p3_value, priorities

    C, T, K = h2.shape
    f64 = torch.float64
    t = rows % T
    q = q_pre.reshape(-1, K)[rows].to(f64)
    q = torch.where(((t > 0) & (t % cfg.R == 0))[:, None], torch.zeros_like(q), q)
    hh = h2.reshape(-1, K)[rows].to(f64)
    if cfg.guard is not None and cfg.guard.quarantine:
        hh = torch.where(torch.isfinite(hh) & (hh > 0), hh, torch.ones_like(hh))
    vv, ee = (x.reshape(-1)[rows].to(f64) for x in (v, eta))
    a = got.a.reshape(-1, K)[rows]
    rho = priorities(q, hh)
    in_s0 = rho <= 1e-30
    n0 = (a & in_s0).sum(1).to(f64)
    delta = 1.0 - n0 * cfg.radio.b_min
    pos = a & ~in_s0
    b_pos, _ = solve_p4(rho, pos, delta, cfg.radio, FLAT_ITERS, FLAT_ITERS)
    left = torch.where(pos.sum(1) == 0, delta, torch.zeros_like(delta))
    b0 = cfg.radio.b_min + left / torch.clamp(n0, min=1.0)
    b64 = torch.where(pos, b_pos, torch.where(a & in_s0, b0[:, None], torch.zeros_like(b_pos)))
    w64 = p3_value(a, b64, q, hh, vv, ee, cfg.radio)
    w32 = w64.abs().float()
    ulp = (torch.nextafter(w32, torch.full_like(w32, math.inf)) - w32).to(f64)
    out = dict(rounds=rows.tolist(), same_a=(a == pl["a"][rows]).all(1).tolist())
    res = _b_resolvable(torch, cfg, rho, b64, ulp) if resolvable else None
    for name, aa, b in (("kernel", a, got.b.reshape(-1, K)[rows]),
                        ("plain", pl["a"][rows], pl["b"][rows])):
        b = b.to(f64)
        out[f"{name}_b_off"] = (b - b64).abs().amax(1).tolist()
        if res is not None:
            out[f"{name}_b_excess"] = ((b - b64).abs() / res).amax(1).tolist()
        out[f"{name}_sum_off"] = (b.sum(1) - b64.sum(1)).abs().tolist()
        out[f"{name}_p3_short_ulps"] = ((w64 - p3_value(aa, b, q, hh, vv, ee, cfg.radio))
                                        / ulp).tolist()
    return out


def _nan_as_nan(torch, x, y, d):
    """The difference ``d`` of x and y with a NaN beside a NaN counted as 0."""
    return torch.where(x.isnan() & y.isnan(), torch.zeros_like(d), d)


def _n_cands(cfg):
    """The sweep's candidates under ``cfg``'s ranking: the clip, or all K."""
    K = cfg.num_clients
    return min(cfg.top_m, K) if cfg.ranking == "topm" else K


def _plain_chunk(cfg, rho, cap=16):
    """Cell-rounds a plain-round batch may hold: its sweep's (rows, M, K)
    tensors within NEAR_ELEMS elements, M the candidates the rounds of the
    (C, T, K) priorities ``rho`` sweep (``sweep_cands``: one past the
    largest K - n0, at most the clip)."""
    K = rho.shape[-1]
    m = min(int((rho > 1e-30).sum(-1).max()), _n_cands(cfg)) + 2
    return max(1, min(cap, NEAR_ELEMS // (m * K)))


def _hold_to_plain(torch, cfg, got, q_pre, h2, v, eta, inc, what, same_selection=False,
                   failure=None, chunk=160, near_all=True, flat64=False, resolvable=False):
    """Contract (b): K3's one-round outputs ``got`` ((C, T, ...)) against the
    plain round on the same queues: selections and counts exact outside
    near ties (margins of the plain K1 sweep over the clip's candidates),
    the P3 value within W_RTOL x (|P3| + v eta) and b within B_ATOL there
    (``same_selection``: also on the near-tie rounds that select alike);
    flat rounds (FLAT_W_RTOL) are counted and held to the float64 optimum
    (``_flat_witness``; under overprovision, whose extended set is
    re-solved, ``_masked_witness``).  A NaN (W, or b) beside a NaN counts
    as equal.
    ``near_all=False`` (with ``same_selection``) computes the near ties of
    the flipped rounds only, all a held round needs (at K = 10^4 under sort
    a round's plain sweep takes about a second).
    ``flat64``, ``resolvable`` (which implies it): flat rounds as the
    comment above FLAT_W_RTOL says.
    With ``failure`` (a TracedFailure) or a guard, the delivered mask, the
    reallocation flags and the guard's counters exact on every round that
    selects alike."""
    C, T, K = h2.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl = _plain_rounds(torch, cfg, q_pre, h2, v, eta, inc, chunk=chunk, failure=failure)
    torch.cuda.synchronize()
    plain_rounds_ms = 1e3 * (time.perf_counter() - t0)
    v_eta = (v * eta).reshape(-1)
    flip = (got.a.reshape(-1, K) != pl["a"]).any(1) | (got.nsel.reshape(-1) != pl["num_selected"])
    if near_all or not same_selection:
        near = _near_rounds(torch, got.rho.reshape(-1, K), v_eta, cfg.radio,
                            n_cands=_n_cands(cfg))
    else:
        near = torch.zeros_like(flip)
        if bool(flip.any()):
            near[flip] = _near_rounds(torch, got.rho.reshape(-1, K)[flip], v_eta[flip],
                                      cfg.radio, n_cands=_n_cands(cfg))
    check(not bool((flip & ~near).any()),
          f"{what}: {int((flip & ~near).sum())} rounds select differently outside near ties")
    for f, g in zip(BRANCH_FIELDS, BRANCH_ROWS):
        x = getattr(got, f, None)
        if x is not None or pl[g] is not None:
            check(x is not None and pl[g] is not None
                  and torch.equal(x.reshape(C * T, -1)[~flip], pl[g].reshape(C * T, -1)[~flip]),
                  f"{what}: {g} differs from the plain round's on rounds that select alike")
    ok = ~flip if same_selection else ~near
    obj = got.obj.reshape(-1)
    rel = _nan_as_nan(torch, obj, pl["objective"],
                      (obj - pl["objective"]).abs() / (pl["objective"].abs() + v_eta))
    check(rel[ok].max().item() <= W_RTOL, f"{what}: P3 value off the plain round's by "
                                          f"{rel[ok].max().item()} (relative)")
    b = got.b.reshape(-1, K)
    db = _nan_as_nan(torch, b, pl["b"], (b - pl["b"]).abs()).amax(1)
    flat = ok & (db > B_ATOL) & (rel <= FLAT_W_RTOL)
    apart = (ok & (db > B_ATOL) & ~flat).nonzero().reshape(-1)
    if (flat64 or resolvable) and apart.numel():
        # the float32 P3 outputs also carry their cost sums' order (a sum of
        # up to K terms); a round whose two allocations' P3 values agree
        # within FLAT_W_RTOL evaluated in float64 is flat as well
        w_k, w_p = _p3_64(torch, cfg, apart, (got.a.reshape(-1, K), b), (pl["a"], pl["b"]),
                          q_pre=q_pre, h2=h2, v=v, eta=eta)
        flat[apart] = (w_k - w_p).abs() <= FLAT_W_RTOL * (w_p.abs() + v_eta[apart].double())
    err_b = db[ok & ~flat].max().item() if bool((ok & ~flat).any()) else 0.0
    resolves = failure is not None and cfg.failure_mode == "overprovision"
    if err_b > B_ATOL:  # the rounds beside the float64 optimum, for the record
        off = (ok & ~flat & (db > B_ATOL)).nonzero().reshape(-1)
        seen = (_masked_witness if resolves else _flat_witness)(
            torch, cfg, off[:8], got, pl, q_pre, h2, v, eta)
        seen.update(rel_obj=rel[off[:8]].tolist(), nsel=got.nsel.reshape(-1)[off[:8]].tolist(),
                    n0=(got.rho.reshape(-1, K)[off[:8]] <= 1e-30).sum(1).tolist())
        check(False, f"{what}: max |b - b_plain| = {err_b}: {seen}")
    witness = None
    if bool(flat.any()):
        witness = (_masked_witness if resolves else _flat_witness)(
            torch, cfg, flat.nonzero().reshape(-1), got, pl, q_pre, h2, v, eta,
            resolvable=resolvable)
        check(all(witness["same_a"])
              and max(witness["kernel_sum_off"]) <= FLAT_SUM_ATOL
              and max(witness["kernel_p3_short_ulps"]) <= 1.0
              and (max(witness["kernel_b_excess"]) <= 1.0 if resolvable
                   else max(witness["kernel_b_off"]) <= FLAT_B_ATOL),
              f"{what}: a flat round is off the float64 optimum: {witness}")
    return dict(rounds=C * T, plain_rounds_ms=plain_rounds_ms, near_tie_rounds=int(near.sum()),
                flipped_rounds=int(flip.sum()),
                rounds_held=int(ok.sum()), max_abs_err_b=err_b,
                max_rel_err_obj=rel[ok].max().item(),
                flat_rounds=int(flat.sum()),
                flat_max_abs_err_b=db[flat].max().item() if witness else 0.0,
                flat_witness=witness)


def phase_k3_ranking(torch, np, dev, smi, T=300, K=10, seeds=64, big=(2048, 16, 40),
                     top_m=128):
    """K3's top-m ranking and its newton and pallas_tiled solvers.

    1. The §VI grid through ``run_grid`` with solver="newton" on
       traj="fused" (K3's newton instance; its launches counted between a
       reset and a read), every (cell, round) replayed against the plain
       round (the newton solver's plain PyTorch version), and K3 alone on
       chip_kernels.py's §VI inputs beside the static instance, whose
       digest must stay ``c27a0410``: device ms, plain ms, bound.
    2. K = 2048, 16 cells x 40 rounds (``_k3_ranked_inputs``): the sort
       instance's run (pallas) gives the rounds' queues.  It and the top-m
       instances (pallas, newton, pallas_tiled, top_m 128) each run the 40
       rounds once (counted between a reset and a read).  Then, on the sort
       run's queues as one-round launches (``rounds_alone``): each top-m
       instance equals the sort instance of its solver (pallas for
       pallas_tiled) bit for bit on every round whose sort optimum fits the
       clip (contract a; the count printed) and, at top_m = K, on every
       round; each holds to its plain version (contract b, flat rounds to
       the float64 optimum).  Each whole run, the sort run's too, is timed
       the same way (``gpu_ms`` and ``device_ms``), the top-m ones with their
       candidates cut from 2049 to 129.
    """
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.kernels.ocean_traj import m_star, ocean_traj, ocean_traj_plain, rounds_alone
    from repro_torch.sim import GridEngine, run_grid

    scen, pols, sd = _grid_args(T, K, seeds)
    run_grid(scen, pols, range(2), solver="newton", traj="fused", device=dev)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = run_grid(scen, pols, sd, solver="newton", traj="fused", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    check(launches["ocean_traj_instances"] == {"newton": len(pols)},
          f"k3_ranking: the newton grid's launches {launches}")
    check(bool(torch.isfinite(res.b).all() and torch.isfinite(res.q).all()),
          "k3_ranking: the newton grid's b or q is not finite")
    P, S, N = res.a.shape[:3]
    C = S * N
    cfg = GridEngine(scen, pols, solver="newton", traj="fused", device=dev).cfg
    tf = {}
    for p_idx, pol in enumerate(pols):
        eta = eta_schedule({"ocean-u": "uniform", "ocean-a": "ascend"}[pol], T, device=dev)
        args = (cfg, res.h2.reshape(C, T, K).contiguous(), torch.full((C, T), V_PAPER, device=dev),
                eta.expand(C, T).contiguous(), res.budget_inc.reshape(C, T, K).contiguous(),
                None, None)
        r = teacher_forced(torch, dev, cfg, res, p_idx, eta, V_PAPER,
                           obj=_k3_replayed_obj(torch, res, p_idx, args))
        r.pop("near")
        tf[pol] = r
    vi = {}
    for name, c in (("static", dataclasses.replace(cfg, solver="pallas")), ("newton", cfg)):
        a = (c, *_vi_k3_args(torch, np, dev, c, T=T), None, None)
        out = ocean_traj(*a[:5])
        vi[name] = dict(_k3_alone(torch, a), digest=k3_digest(torch, out), **dict(zip(
            ("bound_ms", "bound_by", "ops", "bytes"),
            k3_bound(torch, out.rho, newton=name == "newton"))))
    check(vi["static"]["digest"].startswith("c27a0410"),
          f"k3_ranking: the §VI static instance's digest moved: {vi['static']['digest']}")

    Kb, Cb, Tb = big
    cfg2, h2, v, eta, inc = _k3_ranked_inputs(torch, np, dev, Cb, Tb, Kb, seed=Kb)
    runs = {"sort": cfg2, **{c_: dataclasses.replace(cfg2, solver=c_, ranking="topm",
                                                     top_m=top_m)
                             for c_ in RANKED_SOLVERS}}
    labels = {"sort": "static", **RANKED_LABELS}
    _reset_counts()
    wholes = {c_: ocean_traj(rc, h2, v, eta, inc) for c_, rc in runs.items()}
    torch.cuda.synchronize()
    big_launches = _counts()
    check(big_launches["ocean_traj_instances"] == {labels[c_]: 1 for c_ in runs},
          f"k3_ranking: the K={Kb} launches {big_launches}")
    s = wholes["sort"]
    m_sort = m_star(s.nsel, s.rho)
    base = {"pallas": s, "pallas_tiled": s,
            "newton": rounds_alone(dataclasses.replace(cfg2, solver="newton"), s.q_pre, h2, v,
                                   eta, inc)}
    big_rec = {}
    for c_, rc in runs.items():
        row = dict(label=labels[c_],
                   launches=big_launches["ocean_traj_instances"].get(labels[c_], 0),
                   n_cands=min(top_m, Kb) + 1 if c_ != "sort" else Kb + 1)
        if c_ != "sort":
            rounds = rounds_alone(rc, s.q_pre, h2, v, eta, inc)
            check(bool((m_star(rounds.nsel, rounds.rho) <= top_m).all()),
                  f"k3_ranking: {c_} passed the clip")
            fits = m_star(base[c_].nsel, base[c_].rho) <= top_m
            diff = [f for f in RANK_FIELDS
                    if not _same_bits(torch, getattr(rounds, f)[fits], getattr(base[c_], f)[fits])]
            check(not diff, f"k3_ranking K={Kb}: {c_} top-m {top_m} differs from sort where "
                            f"m* <= {top_m}: {diff}")
            full = rounds_alone(dataclasses.replace(rc, top_m=Kb), s.q_pre, h2, v, eta, inc)
            diff = [f for f in RANK_FIELDS
                    if not _same_bits(torch, getattr(full, f), getattr(base[c_], f))]
            check(not diff, f"k3_ranking K={Kb}: {c_} at top_m = K differs from sort: {diff}")
            row.update(rounds_fitting=int(fits.sum()),
                       saturated_rounds=int((m_star(wholes[c_].nsel, wholes[c_].rho)
                                             == top_m).sum()),
                       contract_b=_hold_to_plain(torch, rc, rounds, s.q_pre, h2, v, eta, inc,
                                                 f"k3_ranking K={Kb} {c_}"))
        fn = lambda rc=rc: ocean_traj(rc, h2, v, eta, inc)  # noqa: E731
        dev_ms, _, seen = device_ms(torch, fn, 2)
        row.update(ms=gpu_ms(torch, fn, 2), device_ms=dev_ms, device_records_seen=seen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ocean_traj_plain(rc, h2[:, :10], v[:, :10], eta[:, :10], inc[:, :10])
        torch.cuda.synchronize()
        row.update(plain_ms=1e3 * (time.perf_counter() - t0), plain_rounds=10, **dict(zip(
            ("bound_ms", "bound_by", "ops", "bytes"),
            k3_bound(torch, wholes[c_].rho, newton=c_ == "newton",
                     n_cands=top_m if c_ != "sort" else None))))
        big_rec[c_] = row
    out = dict(gpu=smi, vi_grid=dict(launches=launches, wall_s=wall,
                                     rounds_cells_per_s=P * C * T / wall, teacher_forced=tf),
               vi=vi, big=dict(K=Kb, cells=Cb, T=Tb, top_m=top_m, rounds=Cb * Tb,
                               mean_m_star_sort=m_sort.float().mean().item(),
                               max_m_star_sort=int(m_sort.max()), rows=big_rec),
               max_abs_err_b=max([r["max_abs_err_b"] for r in tf.values()]
                                 + [max(r["contract_b"]["max_abs_err_b"],
                                        r["contract_b"]["flat_max_abs_err_b"])
                                    for k, r in big_rec.items() if k != "sort"]))
    emit({"phase": "k3_ranking", **out})
    return out


# ---------------------------------------------------------------------------
# K3's wide instances (ranking="topm" past K = 2048) and stream_bf16
# ---------------------------------------------------------------------------
WIDE_SOLVERS = ("pallas", "newton", "pallas_tiled", "bisect")
WIDE_FIELDS = ("a", "b", "e", "q_pre", "rho", "obj", "nsel", "q_final", "es_final")
WIDE_LABELS = {"pallas": "topm+wide", "newton": "newton+topm+wide",
               "pallas_tiled": "pallas_tiled+topm+wide", "bisect": "bisect+topm+wide"}
KSCALE_TOP_M = 128


def _kscale_inputs(torch, np, dev, C, T, K, seed):
    """benchmarks/traj_bench.py's K-scaling cell (``_kscale_cfg``, :118-129)
    with C cells: b_min = 0.1 / K, pallas_tiled under top-m 128, one frame,
    V = 1e-5, the uniform eta schedule, the per-round share of the 0.15 J
    budget; gains exponential x 2.5e-4 from a numpy seed."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import OceanConfig
    from repro_torch.core.patterns import eta_schedule

    cfg = OceanConfig(num_clients=K, num_rounds=T, radio=RadioParams(b_min=0.1 / K),
                      solver="pallas_tiled", ranking="topm", top_m=KSCALE_TOP_M, traj="fused")
    h2 = torch.tensor(
        np.random.default_rng(seed).exponential(size=(C, T, K)).astype(np.float32) * 2.5e-4,
        device=dev)
    eta = eta_schedule("uniform", T, device=dev).expand(C, T).contiguous()
    inc = (cfg.budgets(device=dev) / T)[None, None, :].expand(C, T, K).contiguous()
    return cfg, h2, torch.full((C, T), V_PAPER, device=dev), eta, inc


def _modulated_radio(torch, np, dev, cfg, C, T, seed):
    """(C, T) radio leaves: every round's bandwidth a seeded share in
    [0.5, 1] of the static radio's (chip_kernels.py's k3_radio)."""
    from repro_torch.env.radio import traced_radio

    share = torch.tensor(np.random.default_rng(seed).uniform(0.5, 1.0, (C, T)),
                         dtype=torch.float32, device=dev)
    radio = traced_radio(cfg.radio, T).map(lambda x: x.to(dev).expand(C, T).contiguous())
    bw = radio.bandwidth_hz * share
    return radio._replace(bandwidth_hz=bw, beta=radio.model_bits / (radio.deadline_s * bw),
                          energy_scale=radio.deadline_s * radio.noise_w * bw)


def _wide_vs_plain(torch, cfg, out, h2, v, eta, inc, what, failure=None, whole=True,
                   chunk=160, near_all=True, flat64=False, resolvable=False):
    """A wide launch's outputs ``out`` against ``ocean_traj_plain``: every
    round on the launch's own queues through ``rounds_alone`` (bit for bit
    the whole launch's rows) and ``_hold_to_plain`` (b within B_ATOL and P3
    within W_RTOL on every round that selects alike, near ties included:
    with thousands of S0 clients their utility makes W_RTOL |W*| exceed a
    candidate's margin; flat rounds to the float64 optimum; with
    ``failure`` or a guard the delivered mask, reallocation flags and guard
    counters exact there), and, with ``whole``, the whole trajectory: a
    cell may select unlike the plain version only where one of its rounds
    is a near tie, and the other cells' final queues lie within Q_ATOL +
    Q_RTOL |q| (their branch rows equal).
    b over the whole trajectory is read, not held: the two runs' queues
    part in their last bits, which on a flat round moves b by more than
    the round's own tolerance (``tests/test_torch_kernels_cuda.py``,
    ``_replay_rounds``); the worst round's P3 values are read beside it.
    Returns the readings and the plain version's wall ms (the whole run's,
    or without ``whole`` that of the plain round on every cell-round)."""
    from repro_torch.kernels.ocean_traj import ocean_traj_plain, rounds_alone

    C, T, K = h2.shape
    cfg = dataclasses.replace(cfg, metrics=None)  # the decisions are the metrics-off launch's
    rounds = rounds_alone(cfg, out.q_pre, h2, v, eta, inc, failure=failure)
    diff = [f for f in RANK_FIELDS + BRANCH_FIELDS
            if getattr(out, f) is not None
            and not _same_bits(torch, getattr(rounds, f), getattr(out, f))]
    check(not diff, f"{what}: one-round launches differ from the whole launch: {diff}")
    rec = _hold_to_plain(torch, cfg, rounds, out.q_pre, h2, v, eta, inc, what,
                         same_selection=True, failure=failure, chunk=chunk,
                         near_all=near_all, flat64=flat64, resolvable=resolvable)
    rec.update(plain_ms=rec["plain_rounds_ms"], plain_rounds=T,
               mean_selected=out.nsel.float().mean().item())
    if not whole:
        return rec
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = ocean_traj_plain(cfg, h2, v, eta, inc, failure=failure)
    torch.cuda.synchronize()
    rec["plain_ms"] = 1e3 * (time.perf_counter() - t0)
    near = _near_rounds(torch, out.rho.reshape(-1, K), (v * eta).reshape(-1), cfg.radio,
                        n_cands=_n_cands(cfg)).reshape(C, T).any(1)
    same = (out.a == plain.a).flatten(1).all(1) & (out.nsel == plain.nsel).all(1)
    check(bool((same | near).all()),
          f"{what}: {int((~same & ~near).sum())} cells select unlike the plain version "
          f"without a near tie")
    dq = _nan_as_nan(torch, out.q_final, plain.q_final, (out.q_final - plain.q_final).abs())
    qa = torch.nan_to_num(plain.q_final.abs())  # a NaN queue beside a NaN one: held by dq
    over = (dq - Q_ATOL - Q_RTOL * qa)[same].max().item()
    check(over <= 0, f"{what}: final queues differ by {dq[same].max().item()}")
    for f in BRANCH_FIELDS:
        if getattr(out, f) is not None:
            check(torch.equal(getattr(out, f)[same], getattr(plain, f)[same]),
                  f"{what}: the whole run's {f} differs from the plain version's")
    db = _nan_as_nan(torch, out.b, plain.b, (out.b - plain.b).abs()).amax(-1).reshape(-1)
    db = torch.where(same[:, None].expand(C, T).reshape(-1), db, torch.zeros_like(db))
    worst = int(db.argmax())
    o_k, o_p = out.obj.reshape(-1)[worst].item(), plain.obj.reshape(-1)[worst].item()
    rec.update(cells=C, cells_identical_decisions=int(same.sum()),
               whole_max_abs_err_b=db[worst].item(),
               whole_worst_round=dict(round=worst, obj=o_k, obj_plain=o_p,
                                      rel_obj=abs(o_k - o_p) / max(abs(o_p), 1e-30)),
               whole_max_abs_err_q_final=dq[same].max().item(),
               nan_w_rounds=int(out.obj.isnan().sum()))
    return rec


def _wide_row(torch, cfg, args, out, label, launches, launch=None, **bound_kw):
    """A wide instance's reading for the kernels line: device ms, ms back to
    back (``launch``: more keywords of the launch), its launches on the
    phase's path, its bound."""
    from repro_torch.kernels.ocean_traj import ocean_traj

    h2, v, eta, inc = args
    launch = launch or {}
    fn = lambda: ocean_traj(cfg, h2, v, eta, inc, **launch)  # noqa: E731
    dev_ms, _, seen = device_ms(torch, fn, 3)
    row = dict(label=label, launches=launches, ms=gpu_ms(torch, fn, 3), device_ms=dev_ms,
               device_records_seen=seen)
    row.update(zip(("bound_ms", "bound_by", "ops", "bytes"),
                   k3_bound(torch, out.rho.float(), n_cands=min(cfg.top_m, h2.shape[-1]),
                            wide=True, **bound_kw)))
    return row


# The readings of a wide row in the kernels line.
WIDE_ROW_KEYS = ("shape", "launches", "ms", "device_ms", "plain_ms", "plain_rounds", "bound_ms",
                 "bound_by")
# The wide instances' failure, guard and telemetry branches (phase k3_wide):
# the labels ocean_traj counts their launches under, by branch.
WIDE_BRANCH_LABELS = {
    "failure/plain": "topm+failure+wide/plain",
    "failure/reallocate": "topm+failure+wide/reallocate",
    "guard": "topm+guard+wide", "guard+cap": "topm+guard+wide",
    "chaos": "bisect+topm+guard+chaos+wide", "metrics": "topm+metrics+wide",
}


def _drop_heavy(torch, np, dev, C, T, K, seed):
    """reliability_sweep.py's drop_heavy (iid_dropout, p_deliver 0.7) as a
    seeded (C, T, K) mask and its declared rates."""
    from repro_torch.env.failure import TracedFailure

    dlv = (np.random.default_rng(seed).random((C, T, K)) < 0.7).astype(np.float32)
    return TracedFailure(delivered=torch.tensor(dlv, device=dev),
                         rate=torch.full((C, K), 0.7, device=dev))


def _faulty_cells(torch, h2, seed, faults):
    """(C, T, K) gains with ``inject_h2_faults``' draws per cell (seeded by
    the cell) and the (C, T) quarantined counts it reports."""
    from repro_torch.guard import inject_h2_faults

    rows, expected = [], []
    for c in range(h2.shape[0]):
        x, rep = inject_h2_faults(h2[c], seed + c, **faults)
        rows.append(torch.from_numpy(x))
        expected.append(torch.from_numpy(rep.per_round_quarantined(h2.shape[1])))
    return (torch.stack(rows).to(h2.device).contiguous(),
            torch.stack(expected).to(device=h2.device, dtype=torch.int32))


def _branch_cfgs(cfg, top_m):
    """Each wide branch's config on ``cfg`` under top-m: the failure modes
    (launched with a drop_heavy mask), the robustness sweep's guard
    (quarantine and the fallback; with the energy cap 1), the objective
    chaos backend of bisect under that guard, and the overhead spec."""
    from repro_torch.guard import GuardSpec, register_chaos_solver
    from repro_torch.obs import MetricsSpec

    base = dataclasses.replace(cfg, solver="pallas", ranking="topm", top_m=top_m, traj="fused")
    guard = GuardSpec(quarantine=True, fallback=True)
    return {
        "failure/plain": dataclasses.replace(base, failure_mode="plain"),
        "failure/reallocate": dataclasses.replace(base, failure_mode="reallocate"),
        "guard": dataclasses.replace(base, guard=guard),
        "guard+cap": dataclasses.replace(base, guard=dataclasses.replace(guard, energy_cap=1.0)),
        "chaos": dataclasses.replace(
            base, guard=guard, solver=register_chaos_solver("bisect", kind="objective").name),
        "metrics": dataclasses.replace(base, metrics=MetricsSpec.of(*OVERHEAD_SPEC)),
    }


def _branch_bits(torch, x, y, what):
    """Two launches' outputs bit for bit: every decision and branch row, and
    the telemetry but for the float-sum collectors (their block sums follow
    each block's size; the replay holds them)."""
    from repro_torch.kernels.ocean_traj import FLOAT_SUM_COLLECTORS

    diff = [f for f in WIDE_FIELDS + BRANCH_FIELDS
            if not ((getattr(x, f) is None and getattr(y, f) is None)
                    or _same_bits(torch, getattr(x, f), getattr(y, f)))]
    if x.metrics is not None:
        diff += [k for k in x.metrics if k.split("/")[0] not in FLOAT_SUM_COLLECTORS
                 and not _same_bits(torch, x.metrics[k], y.metrics[k])]
    check(not diff, f"{what}: differs in {diff}")


def _wide_branches(torch, np, dev, equal, big, top_m):
    """Phase k3_wide's failure, guard and telemetry branches.

    1. At the ``equal`` shapes (``_k3_ranked_inputs``, top_m 128): for
       failure plain and reallocate under drop_heavy, the guard (quarantine,
       energy cap 1, fallback) on ``WIDE_INJECT`` gains, the objective chaos
       backend of bisect under it, and the overhead spec, the forced wide
       instance equals the shared-memory top-m instance bit for bit (the
       telemetry but for its float sums); fault counts the injected ones;
       the wide telemetry held to the replay of its rows.
    2. At ``big`` (K = 10^4, 8 cells x 8 rounds) on the §VI per-client load
       with H / 300 a round: ``run_grid`` with drop_heavy under ocean-realloc
       and ocean-u (one wide launch each), ``simulate`` under the guard on
       ``WIDE_INJECT`` gains, with the cap, and under the chaos backend, and
       ``run_grid`` with the overhead spec, whole and as two 4-round
       segments resumed from a checkpoint; every round of each held to its
       plain version (``_wide_vs_plain``), fault counts exact, the energy
       within the cap, no quarantined client selected, a never-firing guard
       the unguarded bits, the chaos run the guarded bisect run's bits, the
       telemetry through ``check_metrics_replay`` (a planted ``hist_shift``
       must fail it), segmented and resumed equal to whole.
    3. Each branch's row: device ms beside the unbranched instance's on the
       same cells, launches on the path above, bound, plain ms.
    """
    import tempfile

    from repro_torch.checkpoint import CheckpointSpec
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import simulate
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.env import EnvSpec
    from repro_torch.guard import GuardSpec
    from repro_torch.kernels.ocean_traj import check_metrics_replay, m_star, ocean_traj
    from repro_torch.sim import GridEngine, run_grid

    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        """Seconds since the previous part ended (the breakdown)."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # 1. bit for bit the shared-memory top-m instance
    bits = {}
    for K, C, T in equal:
        cfg, h2, v, eta, inc = _k3_ranked_inputs(torch, np, dev, C, T, K, seed=K + 11)
        fail = _drop_heavy(torch, np, dev, C, T, K, seed=K + 11)
        h2_bad, expected = _faulty_cells(torch, h2, K + 11, WIDE_INJECT)
        for name, rc in _branch_cfgs(cfg, top_m).items():
            if name == "guard":  # the cap's run covers the quarantine and the fallback
                continue
            kw = dict(failure=fail) if name.startswith("failure") else {}
            hh = h2_bad if rc.guard is not None else h2
            shared = ocean_traj(rc, hh, v, eta, inc, **kw)
            wide = ocean_traj(rc, hh, v, eta, inc, _force_wide=True, **kw)
            what = f"k3_wide K={K} {name}"
            _branch_bits(torch, shared, wide, f"{what}: the wide instance against the shared one")
            rec = dict(rounds=C * T, mean_m_star=m_star(wide.nsel, wide.rho).float().mean().item())
            if rc.guard is not None:
                check(torch.equal(wide.fc, expected), f"{what}: fault counts")
                rec.update(fallback_rounds=int(wide.fb.sum()), demoted=int(wide.dm.sum()))
            if name == "failure/reallocate":
                rec["realloc_rounds"] = int(wide.ral.sum())
            if rc.metrics is not None:
                check_metrics_replay(rc, wide.metrics, wide, v, eta, inc)
                rec["float_sums_bitwise"] = all(
                    _same_bits(torch, wide.metrics[k], shared.metrics[k]) for k in wide.metrics)
            bits[f"K={K} {name}"] = rec

    part("bits")

    # 2. K = 10^4 through the entry points
    Kb, Cb, Tb = big
    b_min = 0.5 / Kb
    radio = RadioParams(b_min=b_min, model_bits=RadioParams().model_bits * b_min / 0.02)
    load = dict(num_clients=Kb, num_rounds=Tb, radio=radio, energy_budget_j=0.15 * Tb / 300)
    drop = [Scenario(name="drop_heavy", env=EnvSpec(failure="iid_dropout",
                                                    failure_params={"p_deliver": 0.7}), **load)]
    clean = [Scenario(name="clean", **load)]
    gkw = dict(solver="pallas", ranking="topm", top_m=top_m, traj="fused", device=dev)
    cfgs = _branch_cfgs(GridEngine(clean, ["ocean-u"], **gkw).cfg, top_m)
    # the guard caps at cfg.budgets(): the §VI H = 0.15 J, with H / 300 a
    # round as above
    g_cfgs = _branch_cfgs(Scenario(name="guard", num_clients=Kb, num_rounds=Tb,
                                   radio=radio).ocean_config(), top_m)
    cfgs.update({k: g_cfgs[k] for k in ("guard", "guard+cap", "chaos")})
    eta = eta_schedule("uniform", Tb, device=dev).expand(Cb, Tb).contiguous()
    v = torch.full((Cb, Tb), V_PAPER, device=dev)
    run_grid(drop, ["ocean-realloc", "ocean-u"], range(2), **gkw)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    g_drop = run_grid(drop, ["ocean-realloc", "ocean-u"], range(Cb), **gkw)
    torch.cuda.synchronize()
    launches = dict(_counts()["ocean_traj_instances"])
    check(launches == {WIDE_BRANCH_LABELS["failure/reallocate"]: 1,
                       WIDE_BRANCH_LABELS["failure/plain"]: 1},
          f"k3_wide: the K={Kb} drop_heavy grid's launches {launches}")
    h2d = g_drop.h2.reshape(Cb, Tb, Kb).contiguous()
    incd = g_drop.budget_inc.reshape(Cb, Tb, Kb).contiguous()
    _, fail = _cells(g_drop, Cb, Tb, failure=g_drop.failure_seq)
    runs = {}  # name: (cfg, gains, launch keywords, TrajOut-like outputs)
    for p_idx, name in enumerate(("failure/reallocate", "failure/plain")):
        rc = cfgs[name]
        out = ocean_traj(rc, h2d, v, eta, incd, failure=fail)  # a comparison launch
        for f, g in (("a", "a"), ("b", "b"), ("e", "e"), ("q_pre", "q"), ("dlv", "delivered")):
            check(torch.equal(getattr(out, f), getattr(g_drop, g)[p_idx].reshape(out.a.shape)),
                  f"k3_wide K={Kb} {name}: a launch on the grid's cells differs from it ({f})")
        runs[name] = (rc, h2d, incd, dict(failure=fail), out)
    # the guard, the cap and the chaos backend on faulty gains, through simulate
    h2c = GridEngine(clean, ["ocean-u"], **gkw).sample_env(range(Cb))[0].reshape(Cb, Tb, Kb)
    h2_bad, expected = _faulty_cells(torch, h2c, 0, WIDE_INJECT)
    incc = torch.full((Cb, Tb, Kb), 0.15 / 300, device=dev)
    sim = {}
    _reset_counts()
    for name in ("guard", "guard+cap", "chaos"):
        sim[name] = simulate(cfgs[name], h2_bad, eta[0], V_PAPER, budget_seq=incc, device=dev)
    torch.cuda.synchronize()
    launches.update(_counts()["ocean_traj_instances"])
    check(launches.get(WIDE_BRANCH_LABELS["guard"]) == 2
          and launches.get(WIDE_BRANCH_LABELS["chaos"]) == 1,
          f"k3_wide: the K={Kb} guarded runs' launches {launches}")
    for name in ("guard", "guard+cap", "chaos"):
        rc = cfgs[name]
        out = ocean_traj(rc, h2_bad, v, eta, incc)
        st, d = sim[name]
        for f, g in (("a", "a"), ("b", "b"), ("fc", "fault_count"), ("fb", "fallback")):
            check(torch.equal(getattr(out, f), getattr(d, g)),
                  f"k3_wide K={Kb} {name}: simulate differs from the launch ({f})")
        check(torch.equal(out.fc, expected), f"k3_wide K={Kb} {name}: fault counts")
        bad = ~torch.isfinite(h2_bad) | (h2_bad <= 0)
        check(not bool(out.a[bad].any()), f"k3_wide K={Kb} {name}: a quarantined client selected")
        check(bool(torch.isfinite(out.q_final).all()), f"k3_wide K={Kb} {name}: queues not finite")
        runs[name] = (rc, h2_bad, incc, {}, out)
    path_launches = {name: launches.get(WIDE_BRANCH_LABELS[name], 0)
                     for name in ("failure/reallocate", "failure/plain", "chaos")}
    path_launches.update(guard=1, **{"guard+cap": 1})  # the two launches of one label
    cap = cfgs["guard+cap"].guard.energy_cap * cfgs["guard+cap"].budgets(device=dev)
    e_max = runs["guard+cap"][4].e.amax((0, 1))
    check(bool((e_max <= cap * (1 + 1e-6)).all()),
          f"k3_wide K={Kb}: energy {float(e_max.max())} past the cap")
    check(bool((runs["chaos"][4].fb == 1).all()), f"k3_wide K={Kb}: chaos did not fall back")
    g_bisect = ocean_traj(dataclasses.replace(cfgs["guard"], solver="bisect"), h2_bad, v, eta, incc)
    _branch_bits(torch, runs["chaos"][4]._replace(fb=g_bisect.fb), g_bisect,
                 f"k3_wide K={Kb}: the chaos run against the guarded bisect run")
    h2c = h2c.contiguous()
    never = ocean_traj(dataclasses.replace(cfgs["guard"], guard=GuardSpec(energy_cap=1e6)), h2c,
                       v, eta, incc)
    plain_run = ocean_traj(dataclasses.replace(cfgs["guard"], guard=None), h2c, v, eta, incc)
    check(not bool(never.fc.any() or never.dm.any() or never.fb.any())
          and all(_same_bits(torch, getattr(never, f), getattr(plain_run, f)) for f in WIDE_FIELDS),
          f"k3_wide K={Kb}: a never-firing guard moved the unguarded bits")
    # the telemetry: run_grid whole, then as 4-round segments, resumed
    spec = cfgs["metrics"].metrics
    mkw = dict(gkw, metrics=spec)
    _reset_counts()
    g_met = run_grid(clean, ["ocean-u"], range(Cb), **mkw)
    torch.cuda.synchronize()
    launches.update(_counts()["ocean_traj_instances"])
    check(launches.get(WIDE_BRANCH_LABELS["metrics"]) == 1,
          f"k3_wide: the K={Kb} telemetry grid's launches {launches}")
    path_launches["metrics"] = 1
    with tempfile.TemporaryDirectory(prefix="chip-smoke-wide-") as tmp:
        ck = CheckpointSpec(directory=os.path.join(tmp, "ck"), every_rounds=Tb // 2)
        g_seg = run_grid(clean, ["ocean-u"], range(Cb), checkpoint=ck, **mkw)
        snaps = sorted(os.listdir(ck.directory))
        os.remove(os.path.join(ck.directory, snaps[-1]))  # a run killed after its first segment
        g_res = run_grid(clean, ["ocean-u"], range(Cb), checkpoint=ck, resume_from=True, **mkw)
        torch.cuda.synchronize()
    seg_launches = {k: n for k, n in _counts()["ocean_traj_instances"].items() if "+seg" in k}
    check(seg_launches == {"topm+metrics+wide+seg": 3},
          f"k3_wide: the K={Kb} segmented telemetry launches {seg_launches}")
    for gname, g in (("segmented", g_seg), ("resumed", g_res)):
        diff = [f for f in ("a", "b", "e", "q", "num_selected", "energy_spent")
                if not _same_bits(torch, getattr(g, f), getattr(g_met, f))]
        diff += [k for k in g_met.metrics[0]
                 if not _same_bits(torch, g.metrics[0][k], g_met.metrics[0][k])]
        check(not diff, f"k3_wide K={Kb}: the {gname} telemetry run differs from whole: {diff}")
    h2m = g_met.h2.reshape(Cb, Tb, Kb).contiguous()
    incm = g_met.budget_inc.reshape(Cb, Tb, Kb).contiguous()
    out = ocean_traj(cfgs["metrics"], h2m, v, eta, incm)
    check(all(_same_bits(torch, out.metrics[k], g_met.metrics[0][k].reshape(out.metrics[k].shape))
              for k in out.metrics), f"k3_wide K={Kb}: the grid's telemetry is not the launch's")
    replay = check_metrics_replay(cfgs["metrics"], out.metrics, out, v, eta, incm)
    planted = ocean_traj(cfgs["metrics"], h2m, v, eta, incm, hist_shift={"queue": 1})
    try:
        check_metrics_replay(cfgs["metrics"], planted.metrics, planted, v, eta, incm)
        caught = False
    except AssertionError:
        caught = True
    check(caught, f"k3_wide K={Kb}: the planted hist_shift passed the replay")
    runs["metrics"] = (cfgs["metrics"], h2m, incm, {}, out)
    part("runs")

    # every round of each run against its plain version; the rows, beside
    # the unbranched wide instance on the drop_heavy grid's cells
    held, rows = {}, {}
    bare = dataclasses.replace(cfgs["failure/plain"], failure_mode="plain")
    unbranched_ms = device_ms(torch, lambda: ocean_traj(bare, h2d, v, eta, incd), 3)[0]
    for name, (rc, hh, ii, kw, out) in runs.items():
        held[name] = _wide_vs_plain(torch, rc, out, hh, v, eta, ii, f"k3_wide K={Kb} {name}",
                                    failure=kw.get("failure"), whole=False)
        ms_ = m_star(out.nsel, out.rho)
        held[name].update(mean_m_star=ms_.float().mean().item(),
                          saturated_rounds=int((ms_ == top_m).sum()))
        bound_kw = {}
        if kw:
            surv = (out.dlv & (out.rho > 1e-30)).sum(-1)[out.ral > 0].tolist()
            bound_kw.update(failure=True, solves=surv)
            held[name].update(realloc_rounds=int(out.ral.sum()))
        if rc.guard is not None:
            bound_kw.update(guard=True, fallback=out.fb, bisect="chaos" in name)
            held[name].update(fallback_rounds=int(out.fb.sum()), demoted=int(out.dm.sum()))
        label = WIDE_BRANCH_LABELS[name]
        row = _wide_row(torch, rc, (hh, v, eta, ii), out, label, path_launches[name],
                        launch=kw, **bound_kw)
        if rc.metrics is not None:
            row.update(zip(("bound_ms", "bound_by", "ops", "bytes"),
                           metrics_bound(torch, out.rho, rc.metrics, rc, n_cands=top_m,
                                         wide=True, **bound_kw)))
            row["replay_max_abs_err"] = max(replay.values())
        rows[name] = dict(row, unbranched_device_ms=unbranched_ms,
                          shape=f"{Cb} cells x {Tb} rounds x K = {Kb}, top_m {top_m}",
                          plain_ms=held[name]["plain_ms"], plain_rounds=Tb)
        part(f"held and timed: {name}")
    err = max([r["max_abs_err_b"] for r in held.values()]
              + [r["flat_max_abs_err_b"] for r in held.values()])
    return dict(parts_s=parts, bitwise_vs_shared=bits, held_to_plain=held, rows=rows,
                launches=launches,
                segment_launches=seg_launches, max_abs_err_b=err, energy_max=float(e_max.max()),
                energy_cap=float(cap.max()),
                never_firing_guard_digest=k3_digest(torch, never),
                unguarded_digest=k3_digest(torch, plain_run))


def phase_k3_wide(torch, np, dev, smi, equal=((100, 4, 40), (2048, 4, 40)), big=(10_000, 8, 8),
                  huge=(100_000, 1, 2), top_m=KSCALE_TOP_M):
    """K3's wide instances (csrc/ocean_traj_wide.cuh) and stream_bf16.

    1. At K = 100 and 2048, 4 cells x 40 rounds (``_k3_ranked_inputs``, top_m
       128): the wide instance, forced, equals the shared-memory top-m
       instance bit for bit on every output for pallas, newton,
       pallas_tiled and bisect, and with a streamed radio.
    2. K = 10^4, 8 cells x 8 rounds, traj_bench's K-scaling cell
       (``_kscale_inputs``): ``run_grid(traj="fused")`` (one wide launch,
       counted between a reset and a read) beside ``traj="scan"`` (K2 every
       round); every round of the scan grid's queues through the wide
       instance against the scan grid's decisions; the wide instance
       against ``ocean_traj_plain``, whole and per round.  The same shape
       on ``_k3_ranked_inputs`` with the §VI grid's per-round budget share
       (finite optima, the clip binding) for pallas, newton and bisect (and
       pallas_tiled), each against its plain version only.
    3. K = 10^5, one cell, T = 2, stream_bf16 through ``simulate`` (counted):
       bf16 rows equal to the float32 launch's rows cast, every other
       output its bits; the float32 launch against its plain version; the
       bf16 casts on the §VI instance too.
    4. Each wide row's device ms, ms, launches, bound and plain ms, and the
       K = 10^4 grid's rounds·cells/s on fused against the scan path.
    5. The failure, guard, chaos and telemetry branches (``_wide_branches``).
    """
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import simulate
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels import _build
    from repro_torch.kernels.ocean_traj import BF16_ROWS, m_star, ocean_traj, rounds_alone
    from repro_torch.sim import GridEngine, run_grid

    lib = _build.load("ocean_traj_wide")
    lib.ocean_traj_wide_warps.restype = ctypes.c_int
    t_phase = time.perf_counter()

    # 1. the wide instance is the shared-memory top-m instance, bit for bit
    same = {}
    for K, C, T in equal:
        cfg, h2, v, eta, inc = _k3_ranked_inputs(torch, np, dev, C, T, K, seed=K + 7)
        radio = _modulated_radio(torch, np, dev, cfg, C, T, seed=K + 7)
        for solver in WIDE_SOLVERS + ("radio",):
            rc = dataclasses.replace(cfg, solver="pallas" if solver == "radio" else solver,
                                     ranking="topm", top_m=top_m)
            kw = dict(radio=radio) if solver == "radio" else {}
            shared = ocean_traj(rc, h2, v, eta, inc, **kw)
            wide = ocean_traj(rc, h2, v, eta, inc, _force_wide=True, **kw)
            diff = [f for f in WIDE_FIELDS
                    if not _same_bits(torch, getattr(shared, f), getattr(wide, f))]
            check(not diff, f"k3_wide K={K} {solver}: the wide instance differs from the "
                            f"shared-memory top-m instance in {diff}")
            ms_ = m_star(wide.nsel, wide.rho)
            same[f"K={K} {solver}"] = dict(rounds=C * T, saturated_rounds=int((ms_ == top_m).sum()),
                                           mean_m_star=ms_.float().mean().item())

    # 2. K = 10^4: the grid on both paths, then the wide instance vs plain
    Kb, Cb, Tb = big
    scen = [Scenario(name="kscale", num_clients=Kb, num_rounds=Tb,
                     radio=RadioParams(b_min=0.1 / Kb))]
    gkw = dict(solver="pallas_tiled", ranking="topm", top_m=top_m, device=dev)
    grids, walls, glaunch = {}, {}, {}
    for traj in ("fused", "scan"):
        run_grid(scen, ["ocean-u"], range(2), traj=traj, **gkw)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        grids[traj] = run_grid(scen, ["ocean-u"], range(Cb), traj=traj, **gkw)
        torch.cuda.synchronize()
        walls[traj] = time.perf_counter() - t0
        glaunch[traj] = _counts()
    check(glaunch["fused"]["ocean_traj_instances"] == {"pallas_tiled+topm+wide": 1}
          and glaunch["fused"]["ocean_p_topm"] == 0,
          f"k3_wide: the fused K={Kb} grid's launches {glaunch['fused']}")
    check(glaunch["scan"]["ocean_p_topm"] == Tb and glaunch["scan"]["ocean_traj"] == 0,
          f"k3_wide: the scan K={Kb} grid's launches {glaunch['scan']}")
    gf, gs = grids["fused"], grids["scan"]
    gcfg = GridEngine(scen, ["ocean-u"], traj="fused", **gkw).cfg
    h2g = gs.h2.reshape(Cb, Tb, Kb).contiguous()
    incg = gs.budget_inc.reshape(Cb, Tb, Kb).contiguous()
    vg = torch.full((Cb, Tb), V_PAPER, device=dev)
    etag = eta_schedule("uniform", Tb, device=dev).expand(Cb, Tb).contiguous()
    check(torch.equal(gf.h2, gs.h2), "k3_wide: the two grids drew other gains")
    # every round of the scan grid's queues through the wide instance
    q_s = gs.q[0].reshape(Cb, Tb, Kb).contiguous()
    tf = rounds_alone(gcfg, q_s, h2g, vg, etag, incg)
    near = _near_rounds(torch, tf.rho.reshape(-1, Kb), (vg * etag).reshape(-1), gcfg.radio,
                        n_cands=top_m)
    a_s, b_s = gs.a[0].reshape(-1, Kb), gs.b[0].reshape(-1, Kb)
    n_s = gs.num_selected[0].reshape(-1)
    flip = (tf.a.reshape(-1, Kb) != a_s).any(1) | (tf.nsel.reshape(-1) != n_s)
    check(not bool((flip & ~near).any()),
          f"k3_wide: {int((flip & ~near).sum())} rounds select unlike the K2 scan grid")
    db = (tf.b.reshape(-1, Kb) - b_s).abs().amax(1)
    err_scan = db[~near].max().item()
    check(err_scan <= B_ATOL, f"k3_wide: max |b - b_scan| = {err_scan}")
    bits_same = int(((tf.a.reshape(-1, Kb) == a_s).all(1) & (db == 0)
                     & (tf.nsel.reshape(-1) == n_s)).sum())
    same_cells = (gf.a == gs.a).flatten(3).all(-1).reshape(-1)
    vs_scan = dict(rounds=Cb * Tb, near_tie_rounds=int(near.sum()), flipped_rounds=int(flip.sum()),
                   max_abs_err_b=err_scan, rounds_bit_for_bit=bits_same,
                   cells_identical_decisions=int(same_cells.sum()), cells=Cb,
                   fused_wall_s=walls["fused"], scan_wall_s=walls["scan"],
                   fused_rounds_cells_per_s=Cb * Tb / walls["fused"],
                   scan_rounds_cells_per_s=Cb * Tb / walls["scan"], launches=glaunch)

    rows, held = {}, {}
    kscale = _kscale_inputs(torch, np, dev, Cb, Tb, Kb, seed=Kb)
    # the §VI per-client load with the §VI grid's per-round budget share
    # (H / 300): at H / T = 0.019 J a round (T = 8) the queues drain, 99.8 %
    # of the clients sit in S0 and 56 of 64 rounds are near ties (H100)
    ranked = _k3_ranked_inputs(torch, np, dev, Cb, Tb, Kb, seed=Kb)
    ranked = ranked[:4] + (torch.full_like(ranked[1], 0.15 / 300),)
    for solver in WIDE_SOLVERS:
        cfg, h2, v, eta, inc = kscale if solver == "pallas_tiled" else ranked
        cfg = dataclasses.replace(cfg, solver=solver, ranking="topm", top_m=top_m)
        what = f"k3_wide K={Kb} {solver}"
        _reset_counts()
        out = ocean_traj(cfg, h2, v, eta, inc)
        torch.cuda.synchronize()
        launches = _counts()["ocean_traj_instances"].get(WIDE_LABELS[solver], 0)
        # the bisect run's rounds only (its whole plain run took 8.5 s of
        # the script; the other solvers hold the whole trajectories)
        rec = _wide_vs_plain(torch, cfg, out, h2, v, eta, inc, what, whole=solver != "bisect")
        ms_ = m_star(out.nsel, out.rho)
        rec.update(mean_m_star=ms_.float().mean().item(),
                   saturated_rounds=int((ms_ == top_m).sum()),
                   inputs="_kscale_inputs" if solver == "pallas_tiled" else "_k3_ranked_inputs")
        held[solver] = rec
        rows[WIDE_LABELS[solver]] = dict(
            _wide_row(torch, cfg, (h2, v, eta, inc), out, WIDE_LABELS[solver],
                      launches=glaunch["fused"]["ocean_traj_instances"].get(
                          WIDE_LABELS[solver], 0) if solver == "pallas_tiled" else launches,
                      newton=solver == "newton", bisect=solver == "bisect"),
            shape=f"{Cb} cells x {Tb} rounds x K = {Kb}, top_m {top_m}",
            warps=lib.ocean_traj_wide_warps(top_m, {"pallas": 0, "pallas_tiled": 0, "bisect": 1,
                                                    "newton": 2}[solver]),
            plain_ms=rec["plain_ms"], plain_rounds=Tb)
        del out
    # traj_bench's radio selects nobody past S0 at this K: pallas_tiled on
    # the finite optima of _k3_ranked_inputs too (a comparison launch)
    cfg = dataclasses.replace(ranked[0], solver="pallas_tiled", ranking="topm", top_m=top_m)
    out = ocean_traj(cfg, *ranked[1:])
    held["pallas_tiled ranked"] = _wide_vs_plain(torch, cfg, out, *ranked[1:],
                                                 f"k3_wide K={Kb} pallas_tiled ranked")
    held["pallas_tiled ranked"]["mean_m_star"] = m_star(out.nsel, out.rho).float().mean().item()
    del out
    t_branches = time.perf_counter()
    branches = _wide_branches(torch, np, dev, equal, big, top_m)
    branches["phase_s"] = time.perf_counter() - t_branches

    # 3. K = 10^5, stream_bf16 through simulate; the bf16 casts on the §VI instance
    Kh, Ch, Th = huge
    cfg, h2, v, eta, inc = _kscale_inputs(torch, np, dev, Ch, Th, Kh, seed=Kh)
    simulate(cfg, h2, eta, V_PAPER, budget_seq=inc, traj="fused", stream_bf16=True, device=dev)
    torch.cuda.synchronize()
    _reset_counts()
    st16, d16 = simulate(cfg, h2, eta, V_PAPER, budget_seq=inc, traj="fused", stream_bf16=True,
                         device=dev)
    torch.cuda.synchronize()
    bf_launch = _counts()
    check(bf_launch["ocean_traj_instances"] == {"pallas_tiled+topm+wide+bf16": 1},
          f"k3_wide: the K={Kh} bf16 run's launches {bf_launch}")
    f32 = ocean_traj(cfg, h2, v, eta, inc)
    rec_h = _wide_vs_plain(torch, cfg, f32, h2, v, eta, inc, f"k3_wide K={Kh}")
    bf = ocean_traj(cfg, h2, v, eta, inc, stream_bf16=True)
    torch.cuda.synchronize()

    def bf16_bits(f32_out, bf_out, what):
        for f in BF16_ROWS:
            check(getattr(bf_out, f).dtype == torch.bfloat16
                  and _same_bits(torch, getattr(bf_out, f), getattr(f32_out, f).to(torch.bfloat16)),
                  f"{what}: the bf16 {f} row is not the float32 row cast")
        for f in ("a", "obj", "nsel", "q_final", "es_final"):
            check(_same_bits(torch, getattr(bf_out, f), getattr(f32_out, f)),
                  f"{what}: bf16 changed {f}")

    bf16_bits(f32, bf, f"k3_wide K={Kh}")
    for f, g in (("a", "a"), ("b", "b"), ("e", "e"), ("q_pre", "q"), ("rho", "rho"),
                 ("obj", "objective"), ("nsel", "num_selected")):
        check(_same_bits(torch, getattr(bf, f), getattr(d16, g)),
              f"k3_wide K={Kh}: simulate's bf16 {g} differs from the launch's")
    check(_same_bits(torch, st16.q, bf.q_final), f"k3_wide K={Kh}: simulate's final queues")
    rec_h.update(mean_m_star=m_star(f32.nsel, f32.rho).float().mean().item())
    held["pallas_tiled K=1e5"] = rec_h
    big_args = (h2, v, eta, inc)
    f32_row = _wide_row(torch, cfg, big_args, f32, "pallas_tiled+topm+wide", 0)
    rows["pallas_tiled+topm+wide+bf16"] = dict(
        _wide_row(torch, cfg, big_args, f32, "pallas_tiled+topm+wide+bf16",
                  bf_launch["ocean_traj_instances"].get("pallas_tiled+topm+wide+bf16", 0),
                  launch={"stream_bf16": True}, row_bytes=2),
        shape=f"{Ch} cell x {Th} rounds x K = {Kh}, top_m {top_m}",
        float32_ms=f32_row["ms"], float32_device_ms=f32_row["device_ms"],
        float32_bound_ms=f32_row["bound_ms"], plain_ms=rec_h["plain_ms"], plain_rounds=Th)
    del f32, bf, d16, st16
    vi_cfg = GridEngine(*_grid_args(300, 10, 64)[:2], solver="pallas", traj="fused",
                        device=dev).cfg
    vi_args = _vi_k3_args(torch, np, dev, vi_cfg)
    vi32 = ocean_traj(vi_cfg, *vi_args)
    vi16 = ocean_traj(vi_cfg, *vi_args, stream_bf16=True)
    bf16_bits(vi32, vi16, "k3_wide §VI")
    vi_digest = k3_digest(torch, vi32)
    check(vi_digest.startswith("c27a0410"), f"k3_wide: the §VI digest moved: {vi_digest}")
    vi_fn = lambda kw: (lambda: ocean_traj(vi_cfg, *vi_args, **kw))  # noqa: E731
    vi = {}
    for name, kw, rb in (("float32", {}, 4), ("bf16", {"stream_bf16": True}, 2)):
        dev_ms, _, seen = device_ms(torch, vi_fn(kw), 3)
        vi[name] = dict(device_ms=dev_ms, device_records_seen=seen,
                        ms=gpu_ms(torch, vi_fn(kw), 3), **dict(zip(
                            ("bound_ms", "bound_by"), k3_bound(torch, vi32.rho,
                                                               row_bytes=rb)[:2])))
    del vi32, vi16, vi_args

    out = dict(gpu=smi, bitwise_vs_shared=same, vs_scan_grid=vs_scan, held_to_plain=held,
               rows=rows, vi_bf16=dict(digest=vi_digest, **vi), branches=branches,
               max_abs_err_b=max([r["max_abs_err_b"] for r in held.values()]
                                 + [r["flat_max_abs_err_b"] for r in held.values()]
                                 + [err_scan, branches["max_abs_err_b"]]),
               phase_s=time.perf_counter() - t_phase)
    emit({"phase": "k3_wide", **out})
    return out


# ---------------------------------------------------------------------------
# K3's wide ranked row: ranking="sort", a clip past 2048, overprovision
# ---------------------------------------------------------------------------
# the ranked row's launches, by path: the labels ocean_traj counts them under
RANKED_ROW_LABELS = {
    "sort": "wide+ranked",
    "over_sort": "failure+wide+ranked/overprovision",
    "over_topm": "topm+failure+wide+ranked/overprovision",
    "over_cap": "guard+failure+wide+ranked/overprovision",
    "clip": "topm+wide+ranked",
    "clip_vi": "topm+wide+ranked",
    "metrics": "topm+failure+metrics+wide+ranked/overprovision",
}


def _ranked_cfgs(cfg, top_m):
    """The ranked row's configurations of the bit checks on ``cfg``: under
    sort, pallas / newton / bisect, the streamed radio (``radio``), each
    failure mode (launched with a drop_heavy mask), the robustness sweep's
    guard with the energy cap 1, objective chaos of bisect under that guard,
    the overhead spec and a segment launch; under top-m, overprovision."""
    from repro_torch.guard import GuardSpec, register_chaos_solver
    from repro_torch.obs import MetricsSpec

    base = dataclasses.replace(cfg, solver="pallas", ranking="sort", traj="fused")
    guard = GuardSpec(quarantine=True, fallback=True)
    return {
        "pallas": base,
        "newton": dataclasses.replace(base, solver="newton"),
        "bisect": dataclasses.replace(base, solver="bisect"),
        "radio": base,
        "failure/plain": dataclasses.replace(base, failure_mode="plain"),
        "failure/overprovision": dataclasses.replace(base, failure_mode="overprovision"),
        "failure/reallocate": dataclasses.replace(base, failure_mode="reallocate"),
        "guard+cap": dataclasses.replace(base, guard=dataclasses.replace(guard, energy_cap=1.0)),
        "chaos": dataclasses.replace(
            base, guard=guard, solver=register_chaos_solver("bisect", kind="objective").name),
        "metrics": dataclasses.replace(base, metrics=MetricsSpec.of(*OVERHEAD_SPEC)),
        "segment": base,
        "topm/overprovision": dataclasses.replace(base, ranking="topm", top_m=top_m,
                                                  failure_mode="overprovision"),
    }


def _call_ms(torch, fn, kernel=None):
    """One warm call of ``fn``: (its result, ms between CUDA events, device
    ms from a profiler reading of the same call: its kernels' time, or
    those whose name holds ``kernel``; None where the reading holds none).
    For launches of seconds, where ``gpu_ms`` and ``device_ms`` would take
    eight calls."""
    from torch.autograd import DeviceType

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    with profiled(torch, PROFILE_PAD_S[0]) as prof:
        t0.record()
        res = fn()
        t1.record()
    ms = t0.elapsed_time(t1)
    dev_us = sum(getattr(e, "self_device_time_total", 0) for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
    return res, ms, (dev_us / 1e3 if dev_us > 0 else None)


def _timed(torch, fn, slow_ms=1000.0):
    """(ms, device ms, the share of launches the profiler recorded) of a
    warm ``fn``: ``gpu_ms`` and ``device_ms`` over 3 calls, or for a call
    of ``slow_ms`` or more one call's (``_call_ms``; its device ms the
    events' where the profiler recorded nothing, the share then 0)."""
    _, ms, dms = _call_ms(torch, fn)
    if ms >= slow_ms:
        return ms, (ms if dms is None else dms), 0.0 if dms is None else 1.0
    dms, _, seen = device_ms(torch, fn, 3)
    return gpu_ms(torch, fn, 3), dms, seen


def _ranked_row(torch, cfg, out, label, launches, run, held, **bound_kw):
    """A ranked-row instance's reading for the kernels line: ms and device
    ms (``_timed``), its launches on the phase's path, its
    bound (``k3_bound`` with ``ranked``: the sort of all K keys and the
    sweep of K - n0 candidates, or the clip's) and the plain ms of its
    held rounds."""
    C, T, K = out.rho.shape
    ms, dms, seen = _timed(torch, run)
    n_cands = min(cfg.top_m, K) if cfg.ranking == "topm" else None
    row = dict(label=label, launches=launches, ms=ms, device_ms=dms, device_records_seen=seen,
               shape=f"{C} cells x {T} rounds x K = {K}"
               + (f", top_m {cfg.top_m}" if n_cands else ", sort"),
               plain_ms=held["plain_ms"], plain_rounds=held["plain_rounds"])
    row.update(zip(("bound_ms", "bound_by", "ops", "bytes"),
                   k3_bound(torch, out.rho.float(), n_cands=n_cands, wide=True, ranked=True,
                            **bound_kw)))
    return row


def _over_solves(torch, out):
    """The masked P4s a failure run's data needed: per re-solved round
    (overprovision extended it, or reallocate lost a client) its
    positive-rho members (k3_bound's ``solves``)."""
    pos = out.rho > 1e-30
    if out.ral is not None and bool(out.ral.any()):
        return (out.dlv & pos).sum(-1)[out.ral > 0].tolist()
    return (out.a & pos).sum(-1).reshape(-1).tolist()


def _ranked_bits(torch, np, dev, equal, top_m):
    """Phase k3_ranked (a): the ranked row bit for bit the shared-memory
    instances (``phase_k3_ranked``)."""
    from repro_torch.core.ocean import OceanState
    from repro_torch.kernels.ocean_traj import (
        FLOAT_SUM_COLLECTORS, check_metrics_replay, m_star, ocean_traj, ranked_row)

    # (a) bit for bit the shared-memory instances
    bits = {}
    for K, C, T in equal:
        cfg, h2, v, eta, inc = _k3_ranked_inputs(torch, np, dev, C, T, K, seed=K + 13)
        fail = _drop_heavy(torch, np, dev, C, T, K, seed=K + 13)
        radio = _modulated_radio(torch, np, dev, cfg, C, T, seed=K + 13)
        h2_bad, expected = _faulty_cells(torch, h2, K + 13, WIDE_INJECT)
        for name, rc in _ranked_cfgs(cfg, top_m).items():
            kw = dict(failure=fail) if "overprovision" in name or name.startswith("failure") \
                else dict(radio=radio) if name == "radio" else {}
            hh = h2_bad if rc.guard is not None else h2
            what = f"k3_ranked K={K} {name}"
            check(ranked_row(rc, "failure" in kw), f"{what}: not a ranked-row configuration")
            if name == "segment":  # rounds T/2.. from the shared launch's carry there
                t0 = T // 2
                z = torch.zeros((C, K), device=dev)
                first = ocean_traj(rc, *(x[:, :t0].contiguous() for x in (hh, v, eta, inc)),
                                   init_state=OceanState(q=z, t=torch.zeros(
                                       (C,), dtype=torch.int32, device=dev), energy_spent=z))
                st = OceanState(q=first.q_final, t=torch.full((C,), t0, dtype=torch.int32,
                                                              device=dev),
                                energy_spent=first.es_final)
                args = [x[:, t0:].contiguous() for x in (hh, v, eta, inc)]
                shared = ocean_traj(rc, *args, init_state=st)
                wide = ocean_traj(rc, *args, init_state=st, _force_wide=True)
            else:
                shared = ocean_traj(rc, hh, v, eta, inc, **kw)
                wide = ocean_traj(rc, hh, v, eta, inc, _force_wide=True, **kw)
            diff = [f for f in WIDE_FIELDS + BRANCH_FIELDS
                    if not ((getattr(shared, f) is None and getattr(wide, f) is None)
                            or _same_bits(torch, getattr(shared, f), getattr(wide, f)))]
            rec = dict(rounds=C * T, mean_m_star=m_star(wide.nsel, wide.rho).float().mean().item())
            if diff == ["obj"] and rc.failure_mode == "overprovision" and "failure" in kw:
                # an extended round's P3 value: its cost is a block sum over
                # the ranked slots, in the order of the block's thread count
                odd = (shared.obj.view(torch.int32) != wide.obj.view(torch.int32))
                bare = ocean_traj(dataclasses.replace(rc, failure_mode="plain"), hh, v, eta, inc,
                                  _force_wide=True, **kw)
                check(bool((wide.nsel[odd] != bare.nsel[odd]).all()),
                      f"{what}: P3 values differ on rounds the extension did not grow")
                held_obj = _hold_to_plain(torch, rc, wide, wide.q_pre, hh, v, eta, inc,
                                          what, same_selection=True, failure=fail, chunk=16)
                rec.update(obj_rounds_not_bitwise=int(odd.sum()),
                           obj_held_max_rel_err=held_obj["max_rel_err_obj"])
                diff = []
            check(not diff, f"{what}: the ranked row differs from the shared instance in {diff}")
            if rc.metrics is not None:
                odd = [k for k in wide.metrics if k.split("/")[0] not in FLOAT_SUM_COLLECTORS
                       and not _same_bits(torch, wide.metrics[k], shared.metrics[k])]
                check(not odd, f"{what}: telemetry differs in {odd}")
                check_metrics_replay(rc, wide.metrics, wide, v, eta, inc)
                rec["float_sums_bitwise"] = all(
                    _same_bits(torch, wide.metrics[k], shared.metrics[k]) for k in wide.metrics)
            if rc.guard is not None:
                check(torch.equal(wide.fc, expected), f"{what}: fault counts")
                rec.update(fallback_rounds=int(wide.fb.sum()), demoted=int(wide.dm.sum()))
            if rc.failure_mode == "overprovision" and "failure" in kw:
                bare = ocean_traj(dataclasses.replace(rc, failure_mode="plain"), hh, v, eta, inc,
                                  _force_wide=True, **kw)
                rec["extended_rounds"] = int((wide.nsel > bare.nsel).sum())
                check(bool((wide.nsel >= bare.nsel).all()), f"{what}: a prefix shrank")
            if rc.failure_mode == "reallocate" and "failure" in kw:
                rec["realloc_rounds"] = int(wide.ral.sum())
            bits[f"K={K} {name}"] = rec
    return bits


def _ranked_kscale(torch, np, dev, big, whole_cells, lib, part):
    """Phase k3_ranked (b): traj_bench's K-scaling cell under sort
    (``phase_k3_ranked``); the comparison with the scan path, the held
    rounds and the sort instance's row; ``part(name)`` records the
    breakdown.  The scan path runs each cell-round once, all in one batch
    on the fused grid's queues: its grid would take minutes (K1 holds its
    rows in shared memory, so at K = 10^4 a block has 2 warps and a round
    of 10^4 candidates takes ~50 s; eight of them in turn)."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import OceanState, ocean_round
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.kernels.ocean_traj import rounds_alone
    from repro_torch.sim import GridEngine, run_grid
    in_smem = ctypes.c_int(0)

    # (b) traj_bench's K-scaling cell under sort through run_grid, under the
    # profiler (its one launch is the row's reading)
    Kb, Cb, Tb = big
    scen = [Scenario(name="kscale", num_clients=Kb, num_rounds=Tb,
                     radio=RadioParams(b_min=0.1 / Kb))]
    gkw = dict(solver="pallas", ranking="sort", device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    gf, fused_ms, fused_dms = _call_ms(
        torch, lambda: run_grid(scen, ["ocean-u"], range(Cb), traj="fused", **gkw),
        kernel="ocean_traj_wide")
    wall = time.perf_counter() - t0
    glaunch = {"fused": _counts()}
    check(glaunch["fused"]["ocean_traj_instances"] == {RANKED_ROW_LABELS["sort"]: 1}
          and glaunch["fused"]["ocean_p_prefix"] == 0,
          f"k3_ranked: the fused K={Kb} sort grid's launches {glaunch['fused']}")
    part("b: the fused grid")
    gcfg = GridEngine(scen, ["ocean-u"], traj="fused", **gkw).cfg
    h2g = gf.h2.reshape(Cb, Tb, Kb).contiguous()
    incg = gf.budget_inc.reshape(Cb, Tb, Kb).contiguous()
    vg = torch.full((Cb, Tb), V_PAPER, device=dev)
    etag = eta_schedule("uniform", Tb, device=dev).expand(Cb, Tb).contiguous()
    q_f = gf.q[0].reshape(Cb, Tb, Kb).contiguous()
    # the scan path's round (argsort and K1, what traj="scan" runs each
    # round) on every cell-round of the fused grid's queues, in one batch
    CT = Cb * Tb
    _reset_counts()
    _, dec = ocean_round(
        OceanState(q=q_f.reshape(CT, Kb), t=torch.arange(Tb, dtype=torch.int32,
                                                          device=dev).repeat(Cb),
                   energy_spent=torch.zeros((CT, Kb), device=dev)),
        h2g.reshape(CT, Kb), vg.reshape(-1), etag.reshape(-1),
        dataclasses.replace(gcfg, traj="scan"), budget_inc=incg.reshape(CT, Kb))
    torch.cuda.synchronize()
    glaunch["scan"] = _counts()
    check(glaunch["scan"]["ocean_p_prefix"] == 1 and glaunch["scan"]["ocean_traj"] == 0,
          f"k3_ranked: the scan path's rounds' launches {glaunch['scan']}")
    part("b: the scan path's rounds (K1)")
    a_f, b_f = gf.a[0].reshape(CT, Kb), gf.b[0].reshape(CT, Kb)
    n_f = gf.num_selected[0].reshape(-1)
    flip = (a_f != dec.a).any(1) | (n_f != dec.num_selected)
    near = torch.zeros_like(flip)
    if bool(flip.any()):
        near[flip] = _near_rounds(torch, dec.rho[flip], (vg * etag).reshape(-1)[flip],
                                  gcfg.radio)
    check(not bool((flip & ~near).any()),
          f"k3_ranked: {int((flip & ~near).sum())} rounds select unlike the scan path's")
    db = (b_f - dec.b).abs().amax(1)
    err_scan = db[~flip].max().item()
    check(err_scan <= B_ATOL, f"k3_ranked: max |b - b_scan| = {err_scan}")
    # the rounds of ``whole_cells`` cells against the plain round, one
    # cell-round at a time (the launch's own rows, teacher-forced: bit for
    # bit the grid's)
    cells = slice(0, whole_cells)
    sub = [x[cells].contiguous() for x in (q_f, h2g, vg, etag, incg)]
    tf = rounds_alone(gcfg, *sub)
    same = all(torch.equal(getattr(tf, f).reshape(whole_cells, Tb, -1),
                           getattr(gf, g).reshape(Cb, Tb, -1)[cells])
               for f, g in (("a", "a"), ("b", "b"), ("e", "e"), ("nsel", "num_selected")))
    check(same, "k3_ranked: the grid's rounds teacher-forced differ from the grid")
    held_b = _hold_to_plain(torch, gcfg, tf, *sub, "k3_ranked K-scaling sort",
                            same_selection=True, chunk=1, near_all=False)
    held_b.update(plain_ms=held_b["plain_rounds_ms"], plain_rounds=Tb)
    part("b: held to the plain rounds")
    rho_f = q_f / torch.clamp(h2g, min=1e-30)  # the launch's rho
    n0_b = (rho_f <= 1e-30).sum(-1)
    vs_scan = dict(rounds=CT, flipped_rounds=int(flip.sum()), near_tie_flips=int(near.sum()),
                   max_abs_err_b=err_scan, fused_wall_s=wall,
                   fused_rounds_cells_per_s=CT / wall, launches=glaunch,
                   n0_per_round=n0_b.tolist(),
                   m_star_per_round=(n_f.reshape(Cb, Tb) - n0_b).tolist())
    row = dict(
        label=RANKED_ROW_LABELS["sort"],
        launches=glaunch["fused"]["ocean_traj_instances"].get(RANKED_ROW_LABELS["sort"], 0),
        ms=fused_ms, device_ms=fused_ms if fused_dms is None else fused_dms,
        device_records_seen=0.0 if fused_dms is None else 1.0,
        ms_is="the fused run_grid call between CUDA events",
        shape=f"{Cb} cells x {Tb} rounds x K = {Kb}, sort", plain_ms=held_b["plain_ms"],
        plain_rounds=Tb, warps=lib.ocean_traj_wide_ranked_warps(Kb, 0, ctypes.byref(in_smem)),
        keys_in_shared_memory=bool(in_smem.value))
    row.update(zip(("bound_ms", "bound_by", "ops", "bytes"),
                   k3_bound(torch, rho_f, wide=True, ranked=True)))
    return vs_scan, held_b, row


def _ranked_round_cell(torch, np, dev, big, top_m):
    """Phase k3_ranked (c): traj_bench's round cell, sort against top-m
    (``phase_k3_ranked``)."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.ocean import OceanConfig, OceanState
    from repro_torch.kernels.ocean_traj import m_star, ocean_traj

    Kb = big[0]
    # (c) traj_bench's round cell: one warm round at K = 10^4
    rng = np.random.default_rng(Kb)
    q = rng.uniform(0.0, 0.2, Kb).astype(np.float32)
    q[rng.random(Kb) < 0.2] = 0.0
    h2c = rng.exponential(2.5e-4, Kb).astype(np.float32)
    cell = {}
    for frames, T_cfg in (("warm (R = 8)", 8), ("as traj_bench (T = R = 1)", 1)):
        outs = {}
        for name, solver, ranking in (("sort", "pallas", "sort"),
                                      ("topm", "pallas_tiled", "topm")):
            rc = OceanConfig(num_clients=Kb, num_rounds=T_cfg, radio=RadioParams(b_min=0.1 / Kb),
                             solver=solver, ranking=ranking, top_m=top_m, traj="fused")
            st = OceanState(q=torch.tensor(q, device=dev)[None], t=torch.ones(
                (1,), dtype=torch.int32, device=dev), energy_spent=torch.zeros((1, Kb), device=dev))
            args = (torch.tensor(h2c, device=dev)[None, None], torch.full((1, 1), 1e-5, device=dev),
                    torch.ones((1, 1), device=dev),
                    (rc.budgets(device=dev) / T_cfg)[None, None].contiguous())
            run = lambda rc=rc, args=args, st=st: ocean_traj(rc, *args, init_state=st)  # noqa: E731
            out = run()
            ms, dms, _ = _timed(torch, run)
            outs[name] = (rc, out, ms, dms, args)
        (rs, os_, ms_s, dms_s, args_s), (_, ot, ms_t, dms_t, _) = outs["sort"], outs["topm"]
        same_sel = torch.equal(os_.a, ot.a)
        close = abs(os_.obj.item() - ot.obj.item()) <= 2e-4 * abs(ot.obj.item())
        pl = _plain_rounds(torch, rs, os_.q_pre, *args_s, chunk=1)
        held_c = dict(same_selection_as_plain=bool(torch.equal(pl["a"], os_.a.reshape(1, -1))),
                      obj=os_.obj.item(), obj_plain=pl["objective"].item())
        check(held_c["same_selection_as_plain"] and abs(held_c["obj"] - held_c["obj_plain"])
              <= W_RTOL * (abs(held_c["obj_plain"]) + 1e-5),
              f"k3_ranked round cell {frames}: the sort launch against its plain round {held_c}")
        cell[frames] = dict(sort_ms=ms_s, sort_device_ms=dms_s, topm_ms=ms_t,
                            topm_device_ms=dms_t, sort_over_topm=dms_s / dms_t,
                            traj_bench_gate=">= 2", selections_equal=same_sel,
                            objectives_within_w_rtol=close, n0=int((os_.rho <= 1e-30).sum()),
                            m_star_sort=int(m_star(os_.nsel, os_.rho).item()),
                            m_star_topm=int(m_star(ot.nsel, ot.rho).item()), held=held_c)
    return cell


def _ranked_over(torch, np, dev, big, top_m, clip, part):
    """Phase k3_ranked (d), and (e) on the §VI per-client load:
    overprovision and a clip past 2048 at K = 10^4 (``phase_k3_ranked``);
    the held rounds and each instance's row; ``part(name)`` records the
    breakdown."""
    from repro_torch.core.energy import RadioParams
    from repro_torch.core.patterns import eta_schedule
    from repro_torch.core.scenario import Scenario
    from repro_torch.env import EnvSpec
    from repro_torch.guard import GuardSpec
    from repro_torch.kernels.ocean_traj import check_metrics_replay, m_star, ocean_traj
    from repro_torch.obs import MetricsSpec
    from repro_torch.sim import GridEngine, run_grid

    # (d) overprovision at K = 10^4 through run_grid, under top-m and sort
    Kb, Cb, Tb = big
    b_min = 0.5 / Kb
    radio = RadioParams(b_min=b_min, model_bits=RadioParams().model_bits * b_min / 0.02)
    load = dict(num_clients=Kb, num_rounds=Tb, radio=radio, energy_budget_j=0.15 * Tb / 300)
    drop = [Scenario(name="drop_heavy", env=EnvSpec(failure="iid_dropout",
                                                    failure_params={"p_deliver": 0.7}), **load)]
    eta = eta_schedule("uniform", Tb, device=dev).expand(Cb, Tb).contiguous()
    v = torch.full((Cb, Tb), V_PAPER, device=dev)
    runs, held, rows = {}, {}, {}
    spec = MetricsSpec.of(*OVERHEAD_SPEC)
    for name, kw in (("over_topm", dict(ranking="topm", top_m=top_m)),
                     ("over_sort", dict(ranking="sort")),
                     ("metrics", dict(ranking="topm", top_m=top_m, metrics=spec))):
        _reset_counts()
        g = run_grid(drop, ["ocean-over"], range(Cb), solver="pallas", traj="fused",
                     device=dev, **kw)
        torch.cuda.synchronize()
        lc = _counts()["ocean_traj_instances"]
        check(lc == {RANKED_ROW_LABELS[name]: 1}, f"k3_ranked: the {name} grid's launches {lc}")
        gc = dataclasses.replace(GridEngine(drop, ["ocean-over"], solver="pallas", traj="fused",
                                            device=dev, **kw).cfg, failure_mode="overprovision")
        hh = g.h2.reshape(Cb, Tb, Kb).contiguous()
        ii = g.budget_inc.reshape(Cb, Tb, Kb).contiguous()
        _, fail = _cells(g, Cb, Tb, failure=g.failure_seq)
        out = ocean_traj(gc, hh, v, eta, ii, failure=fail)
        check(torch.equal(out.a, g.a[0].reshape(out.a.shape))
              and torch.equal(out.dlv, g.delivered[0].reshape(out.a.shape)),
              f"k3_ranked {name}: a launch on the grid's cells differs from it")
        if gc.metrics is not None:
            check(all(_same_bits(torch, out.metrics[k], g.metrics[0][k].reshape(
                out.metrics[k].shape)) for k in out.metrics),
                f"k3_ranked {name}: the grid's telemetry is not the launch's")
        runs[name] = (gc, hh, ii, fail, out, 1)
    # the guard's energy cap on the same cells: the admitted count binds
    gc, hh, ii, fail, _, _ = runs["over_sort"]
    cap_cfg = dataclasses.replace(gc, guard=GuardSpec(energy_cap=1.0))
    _reset_counts()
    out_cap = ocean_traj(cap_cfg, hh, v, eta, ii, failure=fail)
    torch.cuda.synchronize()
    lc = _counts()["ocean_traj_instances"]
    check(lc == {RANKED_ROW_LABELS["over_cap"]: 1}, f"k3_ranked: the capped run's launches {lc}")
    n_adm = Kb - out_cap.fc - out_cap.dm
    check(bool((out_cap.nsel == n_adm)[out_cap.nsel > 0].any()),
          "k3_ranked: the capped overprovision never stopped at the admitted count")
    check(bool((out_cap.nsel <= n_adm).all()), "k3_ranked: an extension past the admitted")
    runs["over_cap"] = (cap_cfg, hh, ii, fail, out_cap, 1)
    # (e) a clip past 2048 on the §VI per-client load
    cfg_e, h2e, ve, etae, ince = _k3_ranked_inputs(torch, np, dev, Cb, Tb, Kb, seed=Kb + 1)
    cfg_e = dataclasses.replace(cfg_e, ranking="topm", top_m=clip)
    _reset_counts()
    out_e = ocean_traj(cfg_e, h2e, ve, etae, ince)
    torch.cuda.synchronize()
    lc = _counts()["ocean_traj_instances"]
    check(lc == {RANKED_ROW_LABELS["clip"]: 1}, f"k3_ranked: the clip run's launches {lc}")
    part("d-e: runs")
    for name, (rc, hh, ii, fail, out, n) in list(runs.items()) + [
            ("clip_vi", (cfg_e, h2e, ince, None, out_e, 1))]:
        vv, ee = (ve, etae) if name == "clip_vi" else (v, eta)
        what = f"k3_ranked K={Kb} {name}"
        if name == "metrics":  # the metrics-off run's decisions, bit for bit: held above
            diff = [f for f in WIDE_FIELDS + BRANCH_FIELDS if getattr(out, f) is not None
                    and not _same_bits(torch, getattr(out, f), getattr(runs["over_topm"][4], f))]
            check(not diff, f"{what}: the telemetry run's decisions differ in {diff}")
            held[name] = dict(held["over_topm"])
        else:
            # ~10^4 clients selected (S0 included): the float64 flatness;
            # the clip on this load also b where f is flat in it (ROADMAP
            # Queue 3)
            held[name] = _wide_vs_plain(torch, dataclasses.replace(rc, metrics=None), out, hh,
                                        vv, ee, ii, what, failure=fail, whole=False,
                                        chunk=_plain_chunk(rc, out.rho), near_all=False,
                                        flat64=True, resolvable=name == "clip_vi")
        ms_ = m_star(out.nsel, out.rho)
        held[name].update(mean_m_star=ms_.float().mean().item(), max_m_star=int(ms_.max()),
                          n0_per_round=(out.rho <= 1e-30).sum(-1).tolist())
        bound_kw = {}
        if fail is not None:
            bound_kw.update(failure=True, solves=_over_solves(torch, out))
        if rc.guard is not None:
            bound_kw.update(guard=True, fallback=out.fb)
            held[name].update(demoted=int(out.dm.sum()), fallback_rounds=int(out.fb.sum()))
        run = (lambda rc=rc, hh=hh, vv=vv, ee=ee, ii=ii, fail=fail:
               ocean_traj(rc, hh, vv, ee, ii, failure=fail))
        rows[name] = _ranked_row(torch, rc, out, RANKED_ROW_LABELS[name], n, run, held[name],
                                 **bound_kw)
        if rc.metrics is not None:
            rows[name].update(zip(("bound_ms", "bound_by", "ops", "bytes"), metrics_bound(
                torch, out.rho, rc.metrics, rc, n_cands=top_m, wide=True, ranked=True,
                **bound_kw)))
            rows[name]["replay_max_abs_err"] = max(check_metrics_replay(
                rc, out.metrics, out, vv, ee, ii).values())
        part(f"held and timed: {name}")
    return held, rows


def _ranked_clip(torch, np, dev, big, clip, whole_cells, part):
    """Phase k3_ranked (e): a top-m clip past 2048 on traj_bench's K-scaling
    cell (``_kscale_inputs`` under pallas: n0 = 0 from round 1, so every
    round sweeps the full clip); one launch, counted and timed under the
    profiler; all rounds of ``whole_cells`` cells against the plain round,
    one cell-round at a time (the launch's own rows, teacher-forced: bit for
    bit the launch's); the instance's row."""
    from repro_torch.kernels.ocean_traj import m_star, ocean_traj, rounds_alone

    Kb, Cb, Tb = big
    cfg, h2, v, eta, inc = _kscale_inputs(torch, np, dev, Cb, Tb, Kb, seed=Kb + 1)
    cfg = dataclasses.replace(cfg, solver="pallas", top_m=clip)
    _reset_counts()
    out, ms, dms = _call_ms(torch, lambda: ocean_traj(cfg, h2, v, eta, inc),
                            kernel="ocean_traj_wide")
    lc = _counts()["ocean_traj_instances"]
    check(lc == {RANKED_ROW_LABELS["clip"]: 1}, f"k3_ranked: the clip run's launches {lc}")
    part("e: the clip's launch")
    cells = slice(0, whole_cells)
    sub = [x[cells].contiguous() for x in (out.q_pre, h2, v, eta, inc)]
    tf = rounds_alone(cfg, *sub)
    same = all(torch.equal(getattr(tf, f), getattr(out, f)[cells])
               for f in ("a", "b", "e", "nsel"))
    check(same, "k3_ranked clip: the launch's rounds teacher-forced differ from it")
    held = _hold_to_plain(torch, cfg, tf, *sub, f"k3_ranked K={Kb} clip",
                          same_selection=True, chunk=1, near_all=False)
    n0 = (out.rho <= 1e-30).sum(-1)
    ms_ = m_star(out.nsel, out.rho)
    held.update(plain_ms=held["plain_rounds_ms"], plain_rounds=Tb,
                n0_per_round=n0.tolist(), swept_per_round=torch.clamp(Kb - n0, max=clip).tolist(),
                mean_m_star=ms_.float().mean().item(), max_m_star=int(ms_.max()))
    part("e: held to the plain rounds")
    row = dict(label=RANKED_ROW_LABELS["clip"], launches=lc[RANKED_ROW_LABELS["clip"]], ms=ms,
               device_ms=ms if dms is None else dms,
               device_records_seen=0.0 if dms is None else 1.0,
               ms_is="the counted launch between CUDA events",
               shape=f"{Cb} cells x {Tb} rounds x K = {Kb}, top_m {clip}",
               plain_ms=held["plain_ms"], plain_rounds=Tb)
    row.update(zip(("bound_ms", "bound_by", "ops", "bytes"),
                   k3_bound(torch, out.rho, n_cands=clip, wide=True, ranked=True)))
    return held, row


def phase_k3_ranked(torch, np, dev, smi, equal=((100, 4, 40), (2048, 4, 40)),
                    big=(10_000, 8, 8), whole_cells=2, top_m=KSCALE_TOP_M, clip=4096,
                    kscale_rounds=4):
    """K3's wide ranked row (csrc/ocean_traj_wide.cuh, instances in
    ``ocean_traj_wide_ranked{,_metrics}.cu``): ranking="sort", a top-m clip
    past 2048 and failure_mode="overprovision", each sorting every client's
    key inside the kernel.

    (a) At K = 100 and 2048, 4 cells x 40 rounds (``_k3_ranked_inputs``):
        the forced wide instance under sort (pallas, newton, bisect, a
        streamed radio, failure plain / overprovision / reallocate under
        drop_heavy, the guard with the energy cap 1 on ``WIDE_INJECT``
        gains, objective chaos of bisect, the overhead spec, a segment
        launch) equals the shared sort instance, and under top-m 128 with
        overprovision the shared top-m instance, bit for bit on every
        output; named exceptions (the telemetry's float sums, an extended
        round's P3 value where the two blocks have other thread counts) are
        held to the replay and to the plain round.
    (b) traj_bench's K-scaling cell (``_kscale_inputs``) at K = 10^4, 8 cells
        x ``kscale_rounds`` (4: each round past the first sweeps ~10^4
        candidates, ~7 s of the launch; 8 rounds took 137 s of the phase on
        the H100, with the scan path's and the plain rounds), under sort with
        pallas: ``run_grid(traj="fused")`` (one ranked-row
        launch, counted, timed under the profiler); the scan path's round
        (argsort and K1, counted) on each of its 64 cell-rounds, in one
        batch on the fused grid's queues (``_ranked_kscale`` says why not
        the scan grid), against the fused decisions; all rounds of
        ``whole_cells`` cells against the plain round, one cell-round at a
        time; n0 and m* per round.
    (c) traj_bench's round cell (``benchmarks/traj_bench.py:131-158``): one
        round at K = 10^4 from its warm queues as a one-round segment at
        global round 1, under sort + pallas and top-m 128 + pallas_tiled:
        both device ms and their ratio beside traj_bench's 2x gate, whether
        the selections agree and the P3 values lie within 2e-4; the sort
        launch held to its plain round.  Read twice: with frames of 8
        rounds (warm queues), and as traj_bench configures it (T = 1, so
        R = 1 and the round resets the queues: every client in S0).
    (d) overprovision at K = 10^4, 8 x 8, the §VI per-client load with
        H / 300 a round, drop_heavy under ``ocean-over`` through
        ``run_grid`` (one launch each, counted) under top-m 128 and under
        sort, and with the energy cap 1 on the guard (the admitted count
        binds); with the overhead spec under top-m; every round held to
        the plain round (``flat64``: with ~10^4 clients selected a round
        whose float64 P3 values agree is flat, and held to its masked
        optimum, from which the plain round may lie farther than K3).
    (e) top_m 4096 at K = 10^4, 8 x 8: on ``_k3_ranked_inputs`` (m* <= 47,
        K - n0 a few hundred), every round held to the plain round with
        ``resolvable`` flat rounds (ROADMAP Queue 3); and on traj_bench's
        K-scaling cell (``_ranked_clip``: every round past the first sweeps
        the full clip), all rounds of ``whole_cells`` cells held to the
        plain round.
    (f) each instance's row (ms, device ms, launches, bound, plain ms).
    """
    from repro_torch.kernels import _build

    lib = _build.load("ocean_traj_wide_ranked")
    lib.ocean_traj_wide_ranked_warps.restype = ctypes.c_int
    t_phase = time.perf_counter()
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        """Seconds since the previous part ended (the breakdown), also on
        stderr as the phase goes."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now
        print(f"k3_ranked: {name} {parts[name]:.1f} s", file=sys.stderr, flush=True)

    bits = _ranked_bits(torch, np, dev, equal, top_m)
    part("a: bits")
    vs_scan, held_b, row_sort = _ranked_kscale(torch, np, dev, big[:2] + (kscale_rounds,),
                                               whole_cells, lib, part)
    part("b: the row")
    cell = _ranked_round_cell(torch, np, dev, big, top_m)
    part("c: the round cell")
    held, rows = _ranked_over(torch, np, dev, big, top_m, clip, part)
    held["clip"], row_clip = _ranked_clip(torch, np, dev, big, clip, whole_cells, part)
    rows = {"sort": row_sort, **rows, "clip": row_clip}
    err = max([r["max_abs_err_b"] for r in held.values()]
              + [r["flat_max_abs_err_b"] for r in held.values()]
              + [held_b["max_abs_err_b"], held_b["flat_max_abs_err_b"],
                 vs_scan["max_abs_err_b"]])
    out = dict(gpu=smi, bitwise_vs_shared=bits, vs_scan_grid=vs_scan, held_k_scaling=held_b,
               round_cell=cell, held_to_plain=held, rows=rows, max_abs_err_b=err,
               parts_s=parts, phase_s=time.perf_counter() - t_phase)
    emit({"phase": "k3_ranked", **out})
    return out


def ranked_kernel_entries(ranked):
    """The kernels line's entries of K3's ranked-row instances from phase
    k3_ranked's record: the K-scaling grid's sort launch, overprovision
    under top-m and sort (and with the cap) through run_grid, the clip of
    4096 on the K-scaling cell and on the §VI load; the HasMetrics
    source's instance with the overhead spec."""
    rows = ranked["rows"]
    keys = WIDE_ROW_KEYS + ("label",)
    plain_rows = {n: r for n, r in rows.items() if n != "metrics"}
    return [
        dict(name="ocean_traj_wide_ranked", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_wide_ranked.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=sum(r["launches"] for r in plain_rows.values()),
             max_abs_err=ranked["max_abs_err_b"],
             **{k: rows["sort"][k] for k in WIDE_ROW_KEYS if k != "launches"},
             library_ms=None,
             instances={n: {k: r[k] for k in keys} for n, r in plain_rows.items()}),
        dict(name="ocean_traj_wide_ranked_metrics", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_wide_ranked_metrics.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             max_abs_err=ranked["held_to_plain"]["metrics"]["max_abs_err_b"],
             **{k: rows["metrics"][k] for k in WIDE_ROW_KEYS + ("label", "replay_max_abs_err")},
             library_ms=None),
    ]


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
WIDE_INJECT = dict(INJECT, num_nan=2)  # phase k3_wide: the sweep's draws and two NaNs
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


def _same_bits(torch, x, y):
    """Two tensors of one dtype and shape with the same bytes (NaN equal
    to NaN)."""
    return (x.dtype == y.dtype and x.shape == y.shape
            and torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8)))


def _check_tree_bits(torch, ref, got, what):
    """Every tensor of two results (tuples, NamedTuples, dicts) bit for bit."""
    if ref is None or isinstance(ref, (str, int, float)):
        check(got == ref, f"{what}: {got!r} != {ref!r}")
    elif isinstance(ref, torch.Tensor):
        check(isinstance(got, torch.Tensor) and _same_bits(torch, ref, got),
              f"{what}: not bit for bit")
    elif isinstance(ref, dict):
        check(isinstance(got, dict) and sorted(got) == sorted(ref), f"{what}: keys")
        for k in ref:
            _check_tree_bits(torch, ref[k], got[k], f"{what}/{k}")
    else:
        check(len(got) == len(ref), f"{what}: length")
        for i, (r, g) in enumerate(zip(ref, got)):
            _check_tree_bits(torch, r, g, f"{what}[{i}]")


@contextlib.contextmanager
def _timed_snapshots(rec, write=True):
    """Time every ``save_snapshot`` (the segmented runs call it through
    the module) and add its seconds and file bytes to ``rec``; with
    ``write=False`` no snapshot is written (the segments' own time)."""
    from repro_torch.checkpoint import trajectory as ckpt_io

    orig = ckpt_io.save_snapshot

    def timed(spec, snapshot, round_idx):
        if not write:
            return None
        t0 = time.perf_counter()
        path = orig(spec, snapshot, round_idx)
        rec["seconds"] += time.perf_counter() - t0
        rec["bytes"] += os.path.getsize(path)
        rec["count"] += 1
        return path

    ckpt_io.save_snapshot = timed
    try:
        yield rec
    finally:
        ckpt_io.save_snapshot = orig


def _seg_launches():
    from repro_torch.kernels.ocean_traj import ocean_traj

    return {k: n for k, n in ocean_traj.instances.items() if "+seg" in k}


def phase_checkpoint(torch, np, dev, smi, rel_args, radio_args, T=300, K=10, seeds=64,
                     every=64, cells=8):
    """Checkpoint/resume (``repro_torch.checkpoint``) through K3's segment
    launches; every snapshot in a fresh temporary directory.

    1. The §VI grid (``traj="fused"``) whole and with
       ``CheckpointSpec(every_rounds=64)``, in turns (whole, segmented,
       segmented, whole; the counts reset just before the first segmented
       run and read just after): segments 0-64, ..., 256-300 (no frame
       reset inside: R = T), one K3 segment launch per policy and
       segment and no whole launch; a, b, e, q, num_selected and
       energy_spent bit for bit those of the whole grid; snapshots at 64,
       128, 192, 256 and 300; those above 128 deleted, ``resume_from=True``
       bit for bit again.  The rates whole, segmented, and segmented with
       the snapshot writes skipped (two turns), and the snapshots' seconds
       and bytes.
    2. The same grid with every (collector, reduction) entry (K3's
       HasMetrics segment launches, the region in shared memory): the
       telemetry bit for bit too, segmented and resumed.
    3. One segmented ``simulate`` per other instance family on ``cells``
       cells of the earlier phases' inputs at T = 300 (the radio grid's,
       the reliability grid's under each failure mode, the §VI inputs
       with injected faults guarded on pallas, bisect and objective
       chaos), metrics off and on, each held bit for bit to its whole
       launch; and the scan trajectory segmented on the card.
    4. K = 2048 with per-client telemetry, the region in shared memory and
       (16,384 bins) in the global scratch, ``every_rounds=2``.
    5. The baselines (select_all, SMO, AMO, pattern) segmented on 4 seeds
       of one scenario, bit for bit those of the whole grid.
    6. A 64-round segment launch alone at the §VI shape (from round 128's
       carry): its ms, device ms, its plain version's ms and bound; five
       segments of the §VI inputs give the whole launch's digest."""
    import tempfile

    from repro_torch.checkpoint import CheckpointSpec, segment_bounds
    from repro_torch.core.ocean import (
        concat_rounds,
        init_state,
        segment_step,
        simulate,
        slice_rounds,
    )
    from repro_torch.core.policy import PolicyParams
    from repro_torch.core.scenario import paper_scenarios
    from repro_torch.guard import GuardSpec, inject_h2_faults, register_chaos_solver
    from repro_torch.kernels.ocean_traj import ocean_traj, ocean_traj_plain
    from repro_torch.sim import GridEngine, run_grid

    scen, pols, sd = _grid_args(T, K, seeds)
    P, S, N = len(pols), len(scen), seeds
    C = S * N
    rounds_cells = P * C * T
    tmp = tempfile.TemporaryDirectory(prefix="chip-smoke-ckpt-")
    n_dir = [0]

    def fresh(every_rounds=every):
        n_dir[0] += 1
        return CheckpointSpec(directory=os.path.join(tmp.name, f"run{n_dir[0]}"),
                              every_rounds=every_rounds)

    def steps(spec):
        return sorted(int(f[5:13]) for f in os.listdir(spec.directory))

    def drop_after(spec, r):
        for st in steps(spec):
            if st > r:
                os.remove(os.path.join(spec.directory, f"step_{st:08d}.npz"))

    fields = ("a", "b", "e", "q", "num_selected", "energy_spent", "metrics")
    bounds = segment_bounds(T, every)
    mid = bounds[1][1]  # a run killed after its second snapshot
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    # 1-2. the §VI grid, whole and segmented, without and with telemetry
    spec95 = telemetry_spec()
    grids = {}
    for label, m in (("plain", None), ("metrics", spec95)):
        _grid_rate(torch, dev, scen, pols, sd, traj="fused", metrics=m)  # warm-up
        walls = {"whole": [], "segmented": [], "no_saves": []}
        snap_s = []
        turns = ("whole", "segmented", "no_saves", "no_saves", "segmented", "whole")
        for turn, kind in enumerate(turns):
            ck = None if kind == "whole" else fresh()
            if turn == 1:
                _reset_counts()
            r = dict(seconds=0.0, bytes=0, count=0)
            with (_timed_snapshots(r, write=kind == "segmented") if kind != "whole"
                  else contextlib.nullcontext()):
                res, w = _grid_rate(torch, dev, scen, pols, sd, traj="fused", metrics=m,
                                    checkpoint=ck)
            walls[kind].append(w)
            if kind == "segmented":
                snap_s.append(r["seconds"])
                rec = r
            if turn == 0:
                whole = res
            elif turn == 1:
                launches, seg_res, ck1 = _counts(), res, ck
        inst = "metrics+seg" if m is not None else "static+seg"
        n_seg = P * len(bounds)
        check(launches["ocean_traj"] == n_seg and launches["ocean_traj_instances"] == {inst: n_seg},
              f"checkpoint {label}: the segmented grid launched {launches}")
        for f in fields:
            _check_tree_bits(torch, getattr(whole, f), getattr(seg_res, f),
                             f"checkpoint {label}: segmented {f}")
        check(steps(ck1) == [t1 for _, t1 in bounds], f"checkpoint {label}: snapshots {steps(ck1)}")
        drop_after(ck1, mid)
        _reset_counts()
        res, w_resume = _grid_rate(torch, dev, scen, pols, sd, traj="fused", metrics=m,
                                   checkpoint=ck1, resume_from=True)
        resumed = _counts()
        check(resumed["ocean_traj_instances"] == {inst: P * (len(bounds) - 2)},
              f"checkpoint {label}: the resumed grid launched {resumed}")
        for f in fields:
            _check_tree_bits(torch, getattr(whole, f), getattr(res, f),
                             f"checkpoint {label}: resumed {f}")
        grids[label] = dict(
            launches=launches, resumed_launches=resumed["ocean_traj_instances"],
            rounds_cells_per_s_whole=[rounds_cells / w for w in walls["whole"]],
            rounds_cells_per_s_segmented=[rounds_cells / w for w in walls["segmented"]],
            rounds_cells_per_s_resumed=P * C * (T - mid) / w_resume, resumed_from=mid,
            rounds_cells_per_s_segmented_no_saves=[rounds_cells / w for w in walls["no_saves"]],
            snapshots=rec["count"], snapshot_s=snap_s, snapshot_bytes=rec["bytes"])
        del whole, seg_res, res
        part(f"grid_{label}")

    # 3. one segmented simulate per other instance family, metrics off and on
    cfg = GridEngine(scen, pols, solver="pallas", traj="fused", device=dev).cfg
    h2v, vv, etav, incv = _vi_k3_args(torch, np, dev, cfg, C=cells, T=T)
    rows = [torch.tensor(inject_h2_faults(h2v[c].cpu(), 900 + c, **INJECT)[0])
            for c in range(cells)]
    h2f = torch.stack(rows).to(dev).contiguous()
    guard = GuardSpec(energy_cap=ENERGY_CAP)
    chaos = register_chaos_solver("pallas", kind="objective").name

    def head(args):
        cfg_a, h2, v, eta, inc, radio, failure = args
        return (cfg_a, h2[:cells], v[:cells], eta[:cells], inc[:cells],
                None if radio is None else radio.map(lambda x: x[:cells].contiguous()),
                None if failure is None else failure._replace(
                    delivered=failure.delivered[:cells], rate=failure.rate[:cells]))

    families = {"radio": head(radio_args),
                **{f"failure/{mode}": head(a) for mode, a in rel_args.items()},
                "guard": (dataclasses.replace(cfg, guard=guard), h2f, vv, etav, incv, None, None),
                "bisect+guard": (dataclasses.replace(cfg, guard=guard, solver="bisect"), h2f, vv,
                                 etav, incv, None, None),
                "chaos+guard": (dataclasses.replace(cfg, guard=guard, solver=chaos), h2f, vv,
                                etav, incv, None, None)}
    fam = {}
    for name, (cfg_f, h2, v, eta, inc, radio, failure) in families.items():
        for m in (None, spec95):
            cfg_m = dataclasses.replace(cfg_f, metrics=m, traj="fused")
            kw = dict(budget_seq=inc, radio_seq=radio, failure_seq=failure, device=dev)
            ref = simulate(cfg_m, h2, eta, V_PAPER, **kw)
            before = _seg_launches()
            got = simulate(cfg_m, h2, eta, V_PAPER, checkpoint=fresh(), **kw)
            new = {k: c - before.get(k, 0) for k, c in _seg_launches().items()
                   if c != before.get(k, 0)}
            check(sum(new.values()) == len(bounds),
                  f"checkpoint {name}: segment launches {new}")
            _check_tree_bits(torch, ref, got, f"checkpoint {name} metrics={m is not None}")
            fam[f"{name}{'+metrics' if m is not None else ''}"] = new
    cfg_scan = dataclasses.replace(cfg, traj="scan")
    ref = simulate(cfg_scan, h2v, etav, V_PAPER, budget_seq=incv, device=dev)
    got = simulate(cfg_scan, h2v, etav, V_PAPER, budget_seq=incv, checkpoint=fresh(),
                   device=dev)
    _check_tree_bits(torch, ref, got, "checkpoint scan")
    part("families")

    # 4. K = 2048, the region in shared memory and in the global scratch
    large = {}
    cfg_l, h2l, vl, etal, incl = _k3_inputs(torch, np, dev, 2, 3, 2048, seed=2048)
    names = ("queue", "queue_next", "energy_headroom", "selection_count", "selection_gap")
    for bins in (32, 16384):
        sp = telemetry_spec(hist_bins=bins, names=names,
                            reductions=("mean", "histogram", "full_trace_ds", "last"))
        cfg_m = dataclasses.replace(cfg_l, metrics=sp)
        ref = simulate(cfg_m, h2l, etal, V_PAPER, budget_seq=incl, device=dev)
        before = sum(_seg_launches().values())
        got = simulate(cfg_m, h2l, etal, V_PAPER, budget_seq=incl, checkpoint=fresh(2),
                       device=dev)
        _check_tree_bits(torch, ref, got, f"checkpoint K=2048 bins={bins}")
        large[bins] = dict(segment_launches=sum(_seg_launches().values()) - before)
    part("k2048")

    # 5. the baselines, segmented on a few seeds
    one = [paper_scenarios(T, K)["scenario1"]]
    base = [("select_all", PolicyParams()), ("smo", PolicyParams()), ("amo", PolicyParams()),
            ("pattern", PolicyParams(counts=torch.tensor([(t % K) + 1 for t in range(T)])))]
    ref = run_grid(one, base, range(4), solver="pallas", device=dev)
    got = run_grid(one, base, range(4), solver="pallas", checkpoint=fresh(), device=dev)
    for f in fields:
        _check_tree_bits(torch, getattr(ref, f), getattr(got, f), f"checkpoint baselines {f}")
    part("baselines")

    # 6. one segment launch alone at the §VI shape, and the §VI digest
    h2s, vs, etas, incs = _vi_k3_args(torch, np, dev, cfg, T=T)
    streams = (h2s, vs, etas, incs, None, None)
    Cv = h2s.shape[0]
    state = init_state(cfg, Cv, device=dev)
    decs = []
    for t0, t1 in bounds:
        if t0 == mid:
            carry = state
        state, _, d, _ = segment_step(cfg, "fused", state, None, slice_rounds(streams, t0, t1))
        decs.append(d)
    d = concat_rounds(decs)
    digest = k3_digest(torch, (d.a, d.b, d.e, d.q, d.rho, d.objective, d.num_selected, state.q,
                               state.energy_spent))
    whole = k3_digest(torch, ocean_traj(cfg, h2s, vs, etas, incs))
    check(digest == whole and (T != 300 or digest.startswith(K3_VI_DIGEST)),
          f"checkpoint: the §VI inputs in segments give digest {digest}, whole {whole}")
    seg_args = slice_rounds(streams, mid, mid + every)[:4]

    def seg_launch():
        return ocean_traj(cfg, *seg_args, init_state=carry)

    ms = gpu_ms(torch, seg_launch, 5)
    dev_ms, _, seen = device_ms(torch, seg_launch, 3)
    n = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ocean_traj_plain(cfg, *(x[:, :n] for x in seg_args), init_state=carry)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    bms, by, ops, n_bytes = k3_bound(torch, seg_launch().rho)
    # the segment's bytes add the carry read (q0, es0, t0)
    bms, by = bound_ms(n_bytes + Cv * (K * 8 + 4), ops)
    part("reading")
    tmp.cleanup()
    out = dict(
        gpu=smi, grid=f"{P} policies x {S} scenarios x {N} seeds, T={T}, K={K}",
        every_rounds=every, segments=bounds, grids=grids, families=fam,
        scan_segmented=True, large_K=large, baselines=[p for p, _ in base], digest=digest,
        segment=dict(shape=f"{Cv} cells x rounds {mid}-{mid + every} x K={K}", ms=ms,
                     device_ms=dev_ms, device_records_seen=seen, plain_ms=plain_ms,
                     plain_rounds=n, bound_ms=bms, bound_by=by, ops=ops,
                     bytes=n_bytes + Cv * (K * 8 + 4),
                     launches=grids["plain"]["launches"]["ocean_traj"]),
        segment_metrics_launches=grids["metrics"]["launches"]["ocean_traj"],
        parts_s=parts,
    )
    emit({"phase": "checkpoint", **out})
    return out


def _near_rounds(torch, rho, v_eta, radio, n_cands=None):
    """Rounds (rows of ``rho``, priorities with the guard's demotions) whose
    best and runner-up prefix W of the plain K1 sweep (over ``n_cands``
    candidates, default all) lie within W_RTOL |W*|."""
    from repro_torch.core.selection import prefix_inputs
    from repro_torch.core.solvers import sweep_cands
    from repro_torch.kernels.ocean_p import _scal, prefix_objectives_plain

    # a NaN rho (a NaN gain outside the quarantine) ranks as +inf, as the
    # top-m extraction ranks it
    rho = torch.where(rho.isnan(), torch.full_like(rho, math.inf), rho)
    _, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    K = rho.shape[-1]
    # the candidates past every row's K - n0 are infeasible (sweep_cands
    # keeps one); rows in chunks of at most NEAR_ELEMS (rows, M, K) elements
    if rho.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=rho.device)
    m = sweep_cands(n0, K, n_cands)
    step = max(1, NEAR_ELEMS // ((m + 1) * K))
    scal = _scal(n0, delta, v_eta, radio, rho_sorted)
    near = []
    for i in range(0, rho.shape[0], step):
        w = prefix_objectives_plain(scal[i:i + step], rho_sorted[i:i + step], n_cands=m)
        top2 = torch.topk(w, 2, dim=1).values
        near.append((top2[:, 0] - top2[:, 1]) <= W_RTOL * top2[:, 0].abs())
    return torch.cat(near)


NEAR_ELEMS = 1 << 27


# ---------------------------------------------------------------------------
# the LM serving path: gemma2-27b prefill through K4, decode beside K5
# ---------------------------------------------------------------------------
GEMMA = "gemma2-27b"
GEMMA3 = "gemma3-1b"
JAMBA = "jamba-1.5-large-398b"
# K4's shapes in phase k4_flash (chip_kernels.py times the same): label ->
# (arch, B, a local layer (its window) or a global one, dtype, input seed), S = 8192.
K4_SHAPES = {
    "global": (GEMMA, 1, False, "bfloat16", 4),
    "local": (GEMMA, 1, True, "bfloat16", 4),
    "jamba": (JAMBA, 1, False, "bfloat16", 6),
    "gemma3_global": (GEMMA3, 4, False, "bfloat16", 7),
    "gemma3_local": (GEMMA3, 4, True, "bfloat16", 7),
    "f32_gemma3_global": (GEMMA3, 4, False, "float32", 8),
    "f32_global": (GEMMA, 1, False, "float32", 9),
}


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


# K4's float32 kernel vs its float32 plain version: tests/test_kernels.py's
# float32 tolerance, |d| <= F32_TOL + F32_TOL |plain|.  Both compute the
# logits, the softmax and both products in float32 and differ in the order
# of the Dh- and key-long sums and in expf's / tanhf's last ulp.
F32_TOL = 2e-5


def f32_close(a, ref):
    """Max |a - ref| and whether every element is within F32_TOL."""
    d = (a - ref).abs()
    return d.max().item(), bool((d <= F32_TOL + F32_TOL * ref.abs()).all())


def k4_inputs(torch, dev, cfg, B, S, dtype, seed):
    """Seeded q (B, S, H, Dh) x 4 and k, v (B, S, KV, Dh) at ``cfg``'s heads."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (torch.randn((B, S, H, Dh), generator=g, device=dev) * 4.0).to(dtype)
    k = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(dtype)
    v = torch.randn((B, S, KV, Dh), generator=g, device=dev).to(dtype)
    return q, k, v


def phase_k4(torch, dev, smi, S=8192):
    """K4 against its plain version, each shape timed beside one compiled
    flex_attention call: in bf16 at gemma2-27b's global and local layer
    shapes and jamba-1.5-large's attention layer (B = 1), and gemma3-1b's
    global and local layers at head_dim 256 (B = 4, each with planted
    faults that must fail); in float32 (the FFMA kernel) at gemma3-1b's and
    gemma2-27b's global shapes.  Also the soft-cap's share of K4's error
    (gemma2's global inputs with and without the cap)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    bf, f32 = torch.bfloat16, torch.float32
    rec = {}
    for label, (arch, B, local, dtype_name, seed) in K4_SHAPES.items():
        t_label = time.perf_counter()
        cfg, dtype = get_config(arch), getattr(torch, dtype_name)
        win = cfg.sliding_window if local else None
        cap = cfg.attn_logit_softcap
        q, k, v = k4_inputs(torch, dev, cfg, B, S, dtype, seed)

        def run(fn=flash_attention, win=win, cap=cap, q=q, k=k, v=v):
            return fn(q, k, v, causal=True, window=win, logit_cap=cap)

        out, plain = run(), run(flash_attention_plain)
        check(out.dtype == dtype, f"K4 {label}: output {out.dtype}")
        check(bool(torch.isfinite(out.float()).all()), f"K4 {label}: non-finite output")
        faults = {}
        if dtype == f32:
            err, ok = f32_close(out, plain)
            check(ok, f"K4 {label}: out vs plain beyond {F32_TOL} (max |d| = {err})")
            faults["zeros"] = not f32_close(torch.zeros_like(plain), plain)[1]
        else:
            err, ok = att_close(out, plain)
            check(ok, f"K4 {label}: out vs plain beyond tolerance (max |d| = {err})")
        if cfg.head_dim == 256 and dtype == bf:
            # The head_dim-256 shapes: also relative L2, with planted faults.
            reading = att_layer_reading(out, plain)
            check(reading["passes"], f"K4 {label}: out vs plain {reading}")
            bad = {"zeros": torch.zeros_like(plain)}
            if win is not None:
                bad["no_window"] = flash_attention_plain(q, k, v, causal=True, window=None,
                                                         logit_cap=cap)
            faults.update({name: not att_layer_reading(x, plain)["passes"]
                           for name, x in bad.items()})
            del bad
        check(all(faults.values()), f"K4 {label}: a planted fault passes {faults}")
        reps = 10 if dtype == bf else 3
        ms = gpu_ms(torch, run, reps)
        dev_ms, _, seen = device_ms(torch, run, reps)
        plain_ms = gpu_ms(torch, lambda: run(flash_attention_plain), 2)
        flops = 4 * B * cfg.n_heads * cfg.head_dim * attn_pairs(S, win)
        n_bytes = out.element_size() * (2 * q.numel() + k.numel() + v.numel())
        bms, by = bound_ms(n_bytes, flops, PEAK_BF16_FLOPS if dtype == bf else PEAK_F32_FLOPS)
        lib = flex_library(torch, plain, q, k, v, cap, reps, window=win)
        rec[label] = dict(arch=cfg.name, B=B, H=cfg.n_heads, KV=cfg.n_kv_heads, Dh=cfg.head_dim,
                          window=win, softcap=cap, dtype=str(dtype).split(".")[-1],
                          max_abs_err=err, rel_l2=rel_err(out, plain), planted_faults_fail=faults,
                          ms=ms, device_ms=dev_ms, device_records_seen=seen, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, flops=flops, bytes=n_bytes,
                          tflop_per_s=flops / ms / 1e9, **lib)
        if lib.get("library_ms"):
            rec[label]["library_tflop_per_s"] = flops / lib["library_ms"] / 1e9
        del out, plain
        torch.cuda.synchronize()
        rec[label]["seconds"] = time.perf_counter() - t_label  # with flex_attention's compile
        del q, k, v
    # The soft-cap's share of the error: the kernel computes cap * tanh(x / cap)
    # with tanh.approx.f32, the plain version with the precise tanh.  The same
    # global inputs without the cap isolate it.
    gem = get_config(GEMMA)
    q, k, v = k4_inputs(torch, dev, gem, 1, S, bf, K4_SHAPES["global"][4])
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
    out = dict(gpu=smi, shape=dict(S=S), results=rec, softcap=softcap,
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


def phase_prefill(torch, dev, smi, arch=GEMMA, B=1, S=8192, seed=0, check_layers=2,
                  name="prefill_main"):
    """``arch`` (gemma2-27b; gemma3-1b at head_dim 256) at full width and
    depth through make_prefill_step."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model

    cfg = get_config(arch)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)}

    # Kernel path vs plain path on the same weights (per-tensor seeding
    # gives the first layers of the full model), check_layers layers of
    # full width (gemma3's 6: five local layers and a global one):
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
            check(rd["passes"], f"{name}: layer {i} ({layer.kind}) attention vs plain {rd}")
            faults = {"zeros": torch.zeros_like(plain)}
            if kw["window"] is not None:
                faults["no_window"] = flash_attention_plain(*args, **{**kw, "window": None})
            controls = {fault: att_layer_reading(bad, plain) for fault, bad in faults.items()}
            for fault, c in controls.items():
                check(not c["passes"], f"{name}: planted fault {fault} passes on layer {i}: {c}")
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
    check(cmp["rel_hidden"] <= MODEL_REL, f"{name}: kernel vs plain hidden {cmp}")
    check(cmp["rel_logits"] <= MODEL_REL, f"{name}: kernel vs plain logits {cmp}")
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
    check(launches == cfg.num_layers, f"{name}: K4 launched {launches} times, not {cfg.num_layers}")
    check(tuple(logits.shape) == (B, 1, cfg.vocab), f"{name}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{name}: non-finite logits")
    check(cfg.final_logit_softcap is None or logits.abs().max().item() <= cfg.final_logit_softcap,
          f"{name}: logits above the soft-cap")
    try:
        prof = profile_call(torch, lambda: step(batch))
    except Exception as exc:  # the profiler is a reading, not a check
        prof = {"error": repr(exc)}
    out = dict(gpu=smi, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               head_dim=cfg.head_dim, params=n_params, B=B, S=S, init_s=init_s, prefill_s=wall,
               prefill_tokens_per_s=B * S / wall, k4_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               kernel_vs_plain=cmp, profile=prof)
    emit({"phase": name, **out})
    return model, out


def phase_serve(torch, dev, smi, model, B=4, prompt=32, gen=32, seed=0, name="serve_decode"):
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
    check(tuple(toks.shape) == (B, gen), f"{name}: tokens {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab)).all()), f"{name}: token out of range")
    check(bool(torch.isfinite(r["logits"]).all()), f"{name}: non-finite logits")

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
    check(len(calls) == cfg.num_layers, f"{name}: {len(calls)} decode attentions recorded")
    err_decode, ok_decode = 0.0, True
    for q, k, v, vl, cap, seen in calls:
        e, ok = att_close(decode_attention(q, k, v, vl, logit_cap=cap), seen)
        err_decode, ok_decode = max(err_decode, e), ok_decode and ok
    torch.cuda.synchronize()
    launches = {"decode_attention": decode_attention.launches,
                "flash_attention": flash_attention.launches}
    check(launches["decode_attention"] == len(calls), f"{name}: K5 launches {launches}")
    check(ok_decode, f"{name}: K5 vs attention_decode beyond tolerance (max |d| = {err_decode})")
    out = dict(gpu=smi, arch=cfg.name, B=B, prompt_len=prompt, gen=gen,
               prefill_by_decode_s=r["prefill_s"], decode_s=r["decode_s"],
               decode_steps=r["decode_steps"],
               decode_tokens_per_s=B * r["decode_steps"] / r["decode_s"],
               ms_per_decode_step=1e3 * r["decode_s"] / r["decode_steps"],
               launches=launches, k5_pos=pos, k5_layers=len(calls),
               k5_valid_len={layer.kind: c[3] for layer, c in zip(model.layers, calls)},
               k5_cache_slots={layer.kind: c[1].shape[1] for layer, c in zip(model.layers, calls)},
               k5_max_abs_err_vs_attention_decode=err_decode,
               sample=toks[0, :8].tolist(), profile_one_step=prof)
    emit({"phase": name, **out})
    return out


# float32 smoke prefill on the card (K4's FFMA kernel): the kernel path
# against the plain path, relative L2 of the hidden states and of the
# last logits.  Both compute the same float32 function in another order
# (the attention's sums, expf's ulp; jamba's Mamba layers also through K6,
# whose float32 tolerance is of this size).
SMOKE_F32_REL = 1e-4


def phase_smoke_f32(torch, dev, smi, B=2, S=128, seed=0):
    """make_prefill_step on the card for smoke_variant of gemma3-1b,
    gemma2-27b and jamba-1.5-large at full smoke depth, in float32: K4's
    float32 kernel once per attention layer, held to the plain path."""
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import build_model

    rec = {}
    for arch in (GEMMA3, GEMMA, JAMBA):
        cfg = smoke_variant(get_config(arch))
        check(cfg.dtype == "float32", f"smoke_f32: {arch}'s smoke variant is {cfg.dtype}")
        model = build_model(cfg, dev).init(seed)
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 5)
        batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)}
        step = make_prefill_step(model, cfg)
        step(batch)  # warm-up
        torch.cuda.synchronize()
        n_attn = sum(k in ("global", "local") for k in cfg.layer_kinds())
        flash_attention.launches = 0
        t0 = time.perf_counter()
        logits = step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
        with torch.no_grad():
            h_k, _ = model(batch["tokens"])
            h_p, _ = model(batch["tokens"], plain=True)
            lg_p = model.logits(h_p[:, -1:])
        r = dict(layers=cfg.num_layers, attention_layers=n_attn, head_dim=cfg.head_dim,
                 window=cfg.sliding_window, k4_launches=launches, prefill_s=wall,
                 rel_hidden=rel_err(h_k, h_p), rel_logits=rel_err(logits, lg_p),
                 max_abs_logits=max_abs(logits, lg_p), tol_rel=SMOKE_F32_REL)
        check(launches == n_attn, f"smoke_f32 {arch}: K4 launched {launches} times, not {n_attn}")
        check(logits.dtype == torch.float32 and tuple(logits.shape) == (B, 1, cfg.vocab)
              and bool(torch.isfinite(logits).all()), f"smoke_f32 {arch}: logits {logits.shape}")
        check(r["rel_hidden"] <= SMOKE_F32_REL and r["rel_logits"] <= SMOKE_F32_REL,
              f"smoke_f32 {arch}: kernel vs plain {r}")
        rec[arch] = r
        del model, h_k, h_p
    out = dict(gpu=smi, B=B, S=S, dtype="float32", results=rec,
               k4_launches=sum(r["k4_launches"] for r in rec.values()))
    emit({"phase": "smoke_f32_prefill", **out})
    return out


# ---------------------------------------------------------------------------
# the recurrent LMs: rwkv6-1.6b through K7, jamba-1.5-large (5 layers)
# through K6 and K4
# ---------------------------------------------------------------------------
RWKV = "rwkv6-1.6b"
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


def wide_kernel_entries(wide):
    """The kernels line's entries of K3's wide instances from phase
    k3_wide's record: the K = 10^4 grid's launch (traj_bench's K-scaling
    cell), the K = 10^5 stream_bf16 run through simulate, the other solvers
    and the failure and guard branches on the §VI per-client load (beside
    the unbranched instance on the same cells), and the HasMetrics source's
    instance with the overhead spec."""
    rows, branches = wide["rows"], wide["branches"]["rows"]
    metrics = branches["metrics"]
    return [
        dict(name="ocean_traj_wide", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_wide.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=sum(r["launches"] for r in rows.values())
             + sum(r["launches"] for n, r in branches.items() if n != "metrics"),
             max_abs_err=wide["max_abs_err_b"],
             **{k: rows["pallas_tiled+topm+wide"][k] for k in WIDE_ROW_KEYS if k != "launches"},
             library_ms=None,
             instances={**{label: {k: r[k] for k in WIDE_ROW_KEYS} for label, r in rows.items()},
                        **{f"{r['label']} ({n})": {k: r[k] for k in
                                                   WIDE_ROW_KEYS + ("unbranched_device_ms",)}
                           for n, r in branches.items() if n != "metrics"}}),
        dict(name="ocean_traj_wide_metrics", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_wide_metrics.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             max_abs_err=wide["branches"]["max_abs_err_b"],
             **{k: metrics[k] for k in WIDE_ROW_KEYS + ("unbranched_device_ms",
                                                        "replay_max_abs_err")},
             library_ms=None),
    ]


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
        print(f"chip_smoke: phase {name} {walls[name]:.1f} s", file=sys.stderr, flush=True)
        return out

    smi, k4_ptxas = timed("card", phase_card, torch)
    k1 = timed("k1", phase_k1, torch, np, dev, smi)
    k2 = timed("k2", phase_k2, torch, np, dev, smi)
    res, main_out, k3_err, near_cells = timed("k3_main_path", phase_main, torch, np, dev, smi,
                                              k1[10]["device_ms"])
    k3_large = timed("k3_large_K", phase_k3_large, torch, np, dev, smi)
    scan = timed("k1_scan_path", phase_scan, torch, dev, smi, res, near_cells)
    topm = timed("k2_topm_path", phase_topm_path, torch, dev, smi)
    ranking = timed("k3_ranking", phase_k3_ranking, torch, np, dev, smi)
    wide = timed("k3_wide", phase_k3_wide, torch, np, dev, smi)
    ranked = timed("k3_ranked", phase_k3_ranked, torch, np, dev, smi)
    del res
    torch.cuda.empty_cache()
    reliability, rel_args = timed("reliability", phase_reliability, torch, np, dev, smi)
    robustness = timed("robustness", phase_robustness, torch, np, dev, smi)
    radio_grid, radio_args = timed("radio_grid", phase_radio_grid, torch, np, dev, smi)
    baselines = timed("baselines", phase_baselines, torch, np, dev, smi)
    telemetry = timed("telemetry", phase_telemetry, torch, np, dev, smi, rel_args, radio_args)
    ckpt = timed("checkpoint", phase_checkpoint, torch, np, dev, smi, rel_args, radio_args)
    del rel_args, radio_args
    torch.cuda.empty_cache()
    k4 = timed("k4_flash", phase_k4, torch, dev, smi)
    k5 = timed("k5_long_cache", phase_k5_long, torch, dev, smi)
    torch.cuda.empty_cache()
    model, prefill = timed("prefill_main", phase_prefill, torch, dev, smi)
    serve = timed("serve_decode", phase_serve, torch, dev, smi, model)
    del model
    torch.cuda.empty_cache()
    model, g3_prefill = timed("gemma3_prefill", phase_prefill, torch, dev, smi, GEMMA3, 4, 8192,
                              0, 6, "gemma3_prefill")
    g3_serve = timed("gemma3_serve", phase_serve, torch, dev, smi, model, 4, 32, 32, 0,
                     "gemma3_serve")
    del model
    torch.cuda.empty_cache()
    smoke_f32 = timed("smoke_f32_prefill", phase_smoke_f32, torch, dev, smi)
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
                              robustness["max_abs_err_b"], ranking["max_abs_err_b"]]
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
                 # the segment launches of checkpoint/resume: the §VI grid's
                 # in the checkpoint phase, one timed alone
                 "static+seg": dict(launches=ckpt["segment"]["launches"],
                                    **{k: ckpt["segment"][k] for k in INSTANCE_KEYS}),
                 # the k3_ranking phase: the §VI grid with solver="newton"
                 # (csrc/ocean_traj_grid.cu), and the top-m instances at
                 # K = 2048, beside the sort instance there
                 "newton": dict(source="src/repro_torch/csrc/ocean_traj_grid.cu",
                                launches=ranking["vi_grid"]["launches"]["ocean_traj"],
                                **{k: ranking["vi"]["newton"][k] for k in INSTANCE_KEYS}),
                 **{r["label"]: dict(
                     source="src/repro_torch/csrc/ocean_traj_grid.cu" if c_ == "newton"
                     else "src/repro_torch/csrc/ocean_traj.cu", shape="16 cells x 40 rounds x "
                     "K = 2048, top_m 128", launches=r["launches"],
                     **{k: r[k] for k in INSTANCE_KEYS})
                    for c_, r in ranking["big"]["rows"].items() if c_ != "sort"},
                 "static K=2048": dict(shape="16 cells x 40 rounds x K = 2048",
                                       launches=ranking["big"]["rows"]["sort"]["launches"],
                                       **{k: ranking["big"]["rows"]["sort"][k]
                                          for k in INSTANCE_KEYS}),
             }),
        *wide_kernel_entries(wide),
        *ranked_kernel_entries(ranked),
        dict(name="ocean_traj_metrics", route="cuda",
             source="src/repro_torch/csrc/ocean_traj_metrics.cu",
             replaces="src/repro/kernels/ocean_traj.py:96",
             launches=telemetry["launches"]["ocean_traj_instances"]["metrics"],
             max_abs_err=telemetry["max_abs_err"],
             ms=telemetry["k3_ms"], device_ms=telemetry["k3_device_ms"],
             plain_ms=telemetry["k3_plain_ms"], plain_rounds=telemetry["k3_plain_rounds"],
             bound_ms=telemetry["bound_ms"], bound_by=telemetry["bound_by"], library_ms=None,
             instances={**{name: {k: r[k] for k in ("instance", "launches", "max_abs_err", "ms",
                                                    "plain_ms", "plain_rounds", "bound_ms",
                                                    "bound_by")}
                           for name, r in telemetry["instances"].items()},
                        # the §VI grid's HasMetrics segment launches (checkpoint phase)
                        "metrics+seg": dict(launches=ckpt["segment_metrics_launches"])}),
        dict(name="flash_attention", route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention.py:32",
             launches=prefill["k4_launches"] + g3_prefill["k4_launches"] + smoke_f32["k4_launches"],
             max_abs_err=max(r["max_abs_err"] for r in k4["results"].values()),
             ms=k4["results"]["global"]["ms"], device_ms=k4["results"]["global"]["device_ms"],
             plain_ms=k4["results"]["global"]["plain_ms"],
             bound_ms=k4["results"]["global"]["bound_ms"],
             bound_by=k4["results"]["global"]["bound_by"],
             library_ms=k4["results"]["global"]["library_ms"],
             library_device_ms=k4["results"]["global"].get("library_device_ms"),
             # every shape of phase k4_flash; launches on its model's path
             # (gemma2-27b's and gemma3-1b's prefills, the float32 smoke
             # prefills; jamba's attention layer: phase jamba_prefill)
             instances={label: dict(
                 launches={"global": prefill["k4_launches"], "local": prefill["k4_launches"],
                           "jamba": jamba_prefill["launches"]["flash_attention"],
                           "gemma3_global": g3_prefill["k4_launches"],
                           "gemma3_local": g3_prefill["k4_launches"]}.get(
                               label, smoke_f32["k4_launches"]),
                 **{k: r.get(k) for k in ("arch", "B", "H", "KV", "Dh", "window", "softcap",
                                          "dtype", "max_abs_err", "ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms",
                                          "library_device_ms", "library_error")})
                 for label, r in k4["results"].items()},
             ptxas_dh256=k4_ptxas),
        dict(name="decode_attention", route="cuda", source="src/repro_torch/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:27",
             launches=serve["launches"]["decode_attention"] + g3_serve["launches"]["decode_attention"],
             max_abs_err=max(k5["max_abs_err"], serve["k5_max_abs_err_vs_attention_decode"],
                             g3_serve["k5_max_abs_err_vs_attention_decode"]),
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
          "gemma3_prefill_tokens_per_s": g3_prefill["prefill_tokens_per_s"],
          "gemma3_decode_tokens_per_s": g3_serve["decode_tokens_per_s"],
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
