"""The whole OCEAN trajectory on the card: kernel K3 ``ocean_traj``.

K3 replaces ``repro/kernels/ocean_traj.py::_traj_kernel`` (:96,
``pallas_call`` at :532).  The CUDA source is ``csrc/ocean_traj.cuh``
(instantiated by ``ocean_traj.cu`` and, for the ``newton`` solver,
``ocean_traj_grid.cu``, and with telemetry by ``ocean_traj_metrics.cu`` and
``ocean_traj_metrics_grid.cu``): one
persistent block per cell runs all T rounds of Alg. 1 with the queues and
the spent energy resident in shared memory, each round's prefix
candidates side by side (a warp, or at K <= 16 a half warp, per
candidate: K1's sweep); its header states what bounds it on the H100 and
what the design does about it.  Compile-time branches stream per-round
radio physics (``radio``) and per-client delivery failures (``failure``,
with ``cfg.failure_mode``), run the ``bisect`` solver's or the ``newton``
solver's sweep (a per-round seed grid, then each candidate's polish)
instead of K1's, and guard the round (``cfg.guard``, a ``repro_torch.guard.GuardSpec``:
quarantine, energy admission, the bisect fallback).  A chaos backend
(``repro_torch.guard.chaos``) of ``pallas`` or ``bisect`` runs on the
guarded instance, which applies its corruption inside the round.  With
``cfg.metrics`` (a ``repro_torch.obs.MetricsSpec``) the ``HasMetrics``
instances collect the telemetry inside the kernel, round by round, from a
launch descriptor (``_metrics_descriptor``); the wrapper finalizes it.
Every instance also runs as a *segment* of a longer trajectory, the
checkpoint/resume launch (``init_state``, ``init_mstate``,
``raw_metrics``): runtime launch arguments seed the carry and the global
round, and the telemetry region goes in and comes back out raw.  Past
``MAX_CLIENTS`` (the shared-memory sort's limit) K3 runs its *wide*
instances (``csrc/ocean_traj_wide.cuh``): the carry in global memory, each
round a streaming pass with the guard's screens and the ranking's keys,
the sweep (the guard's validation and bisect fallback, a failure mode's
masked P4 there too) and a commit pass in client order, then the
telemetry's pass.  Two rankings: the *compact row* (``ocean_traj_wide.cu``
and, with telemetry, ``ocean_traj_wide_metrics.cu``) runs
``ranking="topm"`` with a clip of at most ``MAX_WIDE_TOP_M``, extracting
the clip in the streaming pass (K2's phase 1 in one block); the *ranked
row* (``ocean_traj_wide_ranked.cu``, ``ocean_traj_wide_ranked_metrics.cu``)
runs everything else, ``ranking="sort"``, a clip past it and
``failure_mode="overprovision"``: every client's key is sorted inside the
kernel each round, the sweep runs on the ranked row's candidates, and
overprovision extends the prefix along it.  ``stream_bf16`` stores the
(C, T, K) b, e, q_pre and rho rows as bfloat16 (a launch argument of
every instance); the trajectory is the float32 one.

* ``ocean_traj`` — the wrapper: launches K3 for CUDA tensors (counting
  launches in ``ocean_traj.launches``, by instance in
  ``ocean_traj.instances``, the wide ones as ``...+wide`` and the ranked
  row's as ``...+wide+ranked``; raising on CUDA errors) and runs the plain
  version for CPU tensors.
* ``ocean_traj_plain`` — the plain PyTorch version: the port's scan loop
  through ``ocean_round`` with the plain K1 sweep (or ``bisect``,
  ``newton``, K2's plain version for ``pallas_tiled``), and
  ``metrics_round`` after each round.
* ``metrics_replay`` — the telemetry of a finished trajectory, replayed
  from its per-round outputs through ``metrics_round``: the plain version
  of the ``HasMetrics`` branch, independent of near ties.
* ``rounds_alone`` — every round of given queues teacher-forced as a
  one-round segment, all in one launch; ``m_star`` — each round's m*.
* ``ocean_trajectory_fused`` — the ``traj="fused"`` backend of
  ``repro_torch.core.ocean.simulate``.

Scope: ``ranking`` ``sort`` or ``topm``; ``solver`` ``pallas``, ``bisect``,
``newton`` or ``pallas_tiled`` (top-m only), or a chaos backend of
``pallas`` or ``bisect``.  Under ``ranking="topm"`` the round's sweep is
clipped to ``min(top_m, K)`` candidates, a launch argument: at K <= 2048
K3's sorted row holds at those slots what the top-m extraction ranks,
ties by client index.  ``pallas_tiled`` is K2's semantics in the round:
K1's candidates on that clip with a non-finite W counted as NEG_INF,
another launch argument.  Every ranking, clip, solver, failure mode,
guard, chaos backend and ``MetricsSpec`` in scope runs at any K, in any
mix, whole or as a segment: past K = 2048 on the wide instances.
``stream_bf16`` runs on every instance at every K.  Anything else raises
``NotImplementedError`` (``check_fused_scope``).  Like the reference's
kernel, K3 caps a guard's energy at ``energy_cap x cfg.budgets()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.ocean_p import (
    INNER_ITERS,
    OUTER_ITERS,
    _RHO_ZERO_TOL,
    _check_f32,
    _launch_target,
    _ptr,
    _stream,
)

# The shared-memory sort's limit: past it K3 runs its wide instances.
MAX_CLIENTS = 2048
# The wide compact row's largest clip: its key list, compact row and sweep
# rows live in shared memory.  A clip past it runs on the ranked row.
MAX_WIDE_TOP_M = 2048
FUSED_SOLVERS = ("pallas", "bisect", "newton", "pallas_tiled")
# the bases of the chaos backends K3 runs
CHAOS_BASES = ("pallas", "bisect")
# The bisect sweep's outer and inner halvings: ``ocean_p``'s defaults.
BISECT_ITERS = 42
# The guard's bits, the chaos kinds and the sweeps (K1's Newton, bisect,
# the newton solver's grid-seeded one), as csrc/ocean_traj.cuh numbers them.
_QUARANTINE, _FLOOR, _FALLBACK = 1, 2, 4
_CHAOS = {None: 0, "objective": 1, "budget": 2}
_SOLVER_CODE = {"pallas": 0, "pallas_tiled": 0, "bisect": 1, "newton": 2}
# The (C, T, K) float rows that stream_bf16 stores as bfloat16.
BF16_ROWS = ("b", "e", "q_pre", "rho")


class TrajOut(NamedTuple):
    a: torch.Tensor         # (C, T, K) bool
    b: torch.Tensor         # (C, T, K); b, e, q_pre, rho bfloat16 under stream_bf16
    e: torch.Tensor         # (C, T, K)
    q_pre: torch.Tensor     # (C, T, K) queues used by each round's P3
    rho: torch.Tensor       # (C, T, K)
    obj: torch.Tensor       # (C, T)
    nsel: torch.Tensor      # (C, T) int32
    q_final: torch.Tensor   # (C, K)
    es_final: torch.Tensor  # (C, K)
    dlv: Optional[torch.Tensor] = None  # (C, T, K) bool, with a failure process
    ral: Optional[torch.Tensor] = None  # (C, T) int32, with a failure process
    fc: Optional[torch.Tensor] = None   # (C, T) int32 fault_count, with a guard
    dm: Optional[torch.Tensor] = None   # (C, T) int32 demoted, with a guard
    fb: Optional[torch.Tensor] = None   # (C, T) int32 fallback, with a guard
    # with cfg.metrics: the finalized telemetry, "<collector>/<reduction>" keys
    metrics: Optional[Dict[str, torch.Tensor]] = None
    # with cfg.metrics and raw_metrics: the unfinalized MetricsState after
    # the launch's last round, and its full traces by key; None otherwise
    mstate: Any = None
    traces: Optional[Dict[str, torch.Tensor]] = None


def _base_solver(backend) -> str:
    """The solver a backend's sweep is: a chaos backend's base, else its name."""
    return backend.chaos[0] if backend.chaos is not None else backend.name


def check_fused_scope(cfg) -> None:
    """Raise for configurations K3 does not run: a solver other than
    ``FUSED_SOLVERS`` or a chaos backend of one of ``CHAOS_BASES``
    (``NotImplementedError``, naming the hook); ``pallas_tiled`` under
    ``ranking="sort"`` raises the scan path's ``ValueError``.  Everything
    else runs at any K: up to ``MAX_CLIENTS`` on the shared-memory
    instances (at K = 2048 a guarded failure newton instance needs 106,960
    bytes with one warp of teams, and the launch takes as many teams as fit,
    ``csrc/ocean_traj.cuh::traj_smem``), past it on the wide ones."""
    from repro_torch.core.ocean import not_ported
    from repro_torch.core.solvers import get_solver

    backend = get_solver(cfg.solver)
    base = _base_solver(backend)
    if base not in (FUSED_SOLVERS if backend.chaos is None else CHAOS_BASES):
        raise not_ported(
            f"traj='fused' with solver={backend.name!r} (the fused kernel runs the "
            f"solvers {', '.join(FUSED_SOLVERS)} and chaos backends of "
            f"{' or '.join(CHAOS_BASES)})"
        )
    if base == "pallas_tiled" and cfg.ranking != "topm":
        get_solver("pallas_tiled").prefixes()  # raises the sort-free solver's ValueError


def ranked_row(cfg, failure: bool = False) -> bool:
    """Whether a wide launch runs on the ranked row (``csrc/
    ocean_traj_wide.cuh``): under ``ranking="sort"``, a clip past
    ``MAX_WIDE_TOP_M``, or with a failure process (``failure``) under
    ``failure_mode="overprovision"``, whose extension walks the full ranked
    order (repro/core/ocean.py:369)."""
    return (cfg.ranking != "topm" or min(cfg.top_m, cfg.num_clients) > MAX_WIDE_TOP_M
            or (failure and cfg.failure_mode == "overprovision"))


def _library(base: str, metrics: bool) -> str:
    """The K3 library whose instances run solver ``base``: the newton
    solver's are built apart (``csrc/ocean_traj_grid.cu``)."""
    name = "ocean_traj_metrics" if metrics else "ocean_traj"
    return name + "_grid" if base == "newton" else name


def _wf_budgets(K: int):
    """The masked P4's and the newton sweep's (outer, inner, grid) and grid
    fractions at K clients: ``newton_iteration_budgets``' float32 budgets
    and ``torch.linspace``."""
    from repro_torch.core.solvers import newton_iteration_budgets

    outer, inner, grid = newton_iteration_budgets(torch.float32, K)
    return outer, inner, grid, torch.linspace(0.0, 1.0, grid, dtype=torch.float32)


def _plain_solver(backend):
    """The backend K3's plain version runs: the plain K1 sweep for
    ``pallas``, K2's plain version for ``pallas_tiled``, ``bisect`` and
    ``newton`` as they are, and a chaos backend's corruption on its base's
    plain solve."""
    from repro_torch.core.solvers import PALLAS_PLAIN, PALLAS_TILED_PLAIN
    from repro_torch.guard.chaos import chaos_backend

    base = _base_solver(backend)
    if base in ("bisect", "newton"):
        return backend
    if backend.chaos is None:
        return PALLAS_TILED_PLAIN if base == "pallas_tiled" else PALLAS_PLAIN
    _, kind, scale = backend.chaos
    return chaos_backend(PALLAS_PLAIN, backend.name, kind=kind, scale=scale)


def ocean_traj_plain(cfg, h2, v, eta, inc, radio=None, failure=None, *, init_state=None,
                     init_mstate=None, raw_metrics: bool = False,
                     stream_bf16: bool = False) -> TrajOut:
    """Plain PyTorch K3: the scan loop through ``ocean_round`` with plain K1
    (or bisect), guarded by ``cfg.guard`` with caps at ``cfg.budgets()``.
    It runs at any K (the top-m ranking's plain extraction past 2048).

    ``radio`` is a ``TracedRadio`` of (C, T) leaves; ``failure`` a
    ``TracedFailure`` with a (C, T, K) ``delivered`` mask and (C, K) ``rate``.
    ``init_state`` (an ``OceanState``) and ``init_mstate`` (a
    ``MetricsState``) make the T rounds a segment from that carry;
    ``raw_metrics`` returns the telemetry unfinalized (``TrajOut.mstate``,
    ``TrajOut.traces``).  ``stream_bf16`` casts the b, e, q_pre and rho
    rows to bfloat16 at the end (``.to(torch.bfloat16)``, round to nearest
    even); the loop, the carry and the telemetry stay float32.
    """
    from repro_torch.core.ocean import init_state as zero_state
    from repro_torch.core.ocean import ocean_round, stack_decisions
    from repro_torch.core.solvers import get_solver
    from repro_torch.obs.metrics import (
        finalize_metrics,
        init_metrics,
        metrics_round,
        round_context,
        stack_traces,
    )

    cfg_plain = dataclasses.replace(
        cfg, solver=_plain_solver(get_solver(cfg.solver)), traj="scan")
    spec = cfg.metrics
    C, T, _ = h2.shape
    state = zero_state(cfg_plain, C, device=h2.device) if init_state is None else init_state
    mstate = None
    if spec is not None:
        mstate = init_metrics(spec, cfg, C, device=h2.device) if init_mstate is None \
            else init_mstate
    decs, traces = [], []
    for t in range(T):
        radio_t = None if radio is None else radio.at(t)
        new_state, dec = ocean_round(
            state, h2[:, t], v[:, t], eta[:, t], cfg_plain, budget_inc=inc[:, t],
            radio=radio_t,
            delivered=None if failure is None else failure.delivered[:, t],
            fail_rate=None if failure is None else failure.rate,
        )
        if spec is not None:
            ctx = round_context(state.t, dec, new_state, v[:, t], eta[:, t], inc[:, t],
                                cfg.radio if radio_t is None else radio_t)
            mstate, tr = metrics_round(spec, cfg, ctx, mstate)
            traces.append(tr)
        state = new_state
        decs.append(dec)
    d = stack_decisions(decs)
    out = TrajOut(
        a=d.a, b=d.b, e=d.e, q_pre=d.q, rho=d.rho, obj=d.objective,
        nsel=d.num_selected, q_final=state.q, es_final=state.energy_spent,
        dlv=d.delivered, ral=d.realloc, fc=d.fault_count, dm=d.demoted, fb=d.fallback,
    )
    if stream_bf16:
        out = out._replace(**{f: getattr(out, f).to(torch.bfloat16) for f in BF16_ROWS})
    if spec is None:
        return out
    if raw_metrics:
        return out._replace(mstate=mstate, traces=stack_traces(traces))
    return out._replace(metrics=finalize_metrics(spec, cfg, mstate, stack_traces(traces)))


def m_star(nsel: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """m* of every round: the selected count ``nsel`` less the S0 clients
    (rho <= 1e-30) of the priorities ``rho`` (last axis K)."""
    return nsel - (rho <= _RHO_ZERO_TOL).sum(-1).to(nsel.dtype)


def rounds_alone(cfg, q_pre, h2, v, eta, inc, failure=None) -> TrajOut:
    """Every (cell, round) of the (C, T, K) queues ``q_pre`` teacher-forced:
    one ``ocean_traj`` launch of C x T one-round segments, each at its
    round's index (``failure`` a ``TracedFailure`` of (C, T, K) masks and
    (C, K) rates).  The per-round outputs come back as (C, T, ...),
    ``q_final`` and ``es_final`` as each round's (C, T, K) state after it."""
    from repro_torch.core.ocean import OceanState

    C, T, K = h2.shape
    CT = C * T
    state = OceanState(q=q_pre.reshape(CT, K).contiguous(),
                       t=torch.arange(T, dtype=torch.int32, device=h2.device).repeat(C),
                       energy_spent=torch.zeros((CT, K), device=h2.device))
    if failure is not None:
        failure = failure._replace(
            delivered=failure.delivered.reshape(CT, 1, K).contiguous(),
            rate=failure.rate[:, None, :].expand(C, T, K).reshape(CT, K).contiguous())
    out = ocean_traj(cfg, h2.reshape(CT, 1, K), v.reshape(CT, 1), eta.reshape(CT, 1),
                     inc.reshape(CT, 1, K), failure=failure, init_state=state)
    per_round = ("a", "b", "e", "q_pre", "rho", "obj", "nsel", "dlv", "ral", "fc", "dm", "fb")
    return out._replace(**{f: getattr(out, f).reshape((C, T) + getattr(out, f).shape[2:])
                           for f in per_round if getattr(out, f) is not None},
                        q_final=out.q_final.reshape(C, T, K),
                        es_final=out.es_final.reshape(C, T, K))


def metrics_replay(cfg, out: TrajOut, v, eta, inc, radio=None) -> Dict[str, torch.Tensor]:
    """``cfg.metrics``'s telemetry of a finished trajectory, from its
    per-round outputs: each round's context is built from ``out``'s rows
    (q_pre, a, b, e, rho, obj, nsel, and the failure and guard rows), with
    the updated queues ``max(q_pre + e - inc, 0)`` (a guard's quarantine
    zeroing non-finite increments, as the round does) and the spent energy
    summed round by round, and goes through ``metrics_round``.  What the
    ``HasMetrics`` branch computes from the same rows, in PyTorch."""
    from repro_torch.core.ocean import OceanState, RoundDecision
    from repro_torch.obs.metrics import (
        finalize_metrics,
        init_metrics,
        metrics_round,
        round_context,
        stack_traces,
    )

    spec = cfg.metrics
    C, T, K = out.q_pre.shape
    dev = out.q_pre.device
    mstate = init_metrics(spec, cfg, C, device=dev)
    es = torch.zeros((C, K), dtype=torch.float32, device=dev)
    quarantine = cfg.guard is not None and cfg.guard.quarantine
    traces = []

    def row(x, t):
        return None if x is None else x[:, t]

    for t in range(T):
        inc_t = inc[:, t]
        drain = torch.where(torch.isfinite(inc_t), inc_t, torch.zeros_like(inc_t)) \
            if quarantine else inc_t
        q_next = torch.clamp(out.q_pre[:, t] + out.e[:, t] - drain, min=0.0)
        es = es + out.e[:, t]
        dec = RoundDecision(
            a=out.a[:, t], b=out.b[:, t], e=out.e[:, t], q=out.q_pre[:, t], rho=out.rho[:, t],
            objective=out.obj[:, t], num_selected=out.nsel[:, t], delivered=row(out.dlv, t),
            realloc=row(out.ral, t), fault_count=row(out.fc, t), demoted=row(out.dm, t),
            fallback=row(out.fb, t),
        )
        tt = torch.full((C,), t, dtype=torch.int32, device=dev)
        ctx = round_context(tt, dec, OceanState(q=q_next, t=tt + 1, energy_spent=es),
                            v[:, t], eta[:, t], inc_t, cfg.radio if radio is None else radio.at(t))
        mstate, tr = metrics_round(spec, cfg, ctx, mstate)
        traces.append(tr)
    return finalize_metrics(spec, cfg, mstate, stack_traces(traces))


# The scalar collectors that sum K float terms a round: the kernel adds them
# in another order than PyTorch (its block sum), so they agree within the
# float32 bound on reordering a K-term sum; every other collector is the
# same float32 operations on the same values, exact.
FLOAT_SUM_COLLECTORS = (
    "lyapunov", "lyapunov_drift", "dpp_drift", "solver_residual", "wasted_energy",
)
_EPS32 = 2.0 ** -23


def _round_bounds(cfg, out: TrajOut, inc) -> Dict[str, torch.Tensor]:
    """(C, T) bounds of each float-sum collector's reordering error:
    K 2^-23 sum |terms| (the terms as ``metrics_round`` adds them)."""
    quarantine = cfg.guard is not None and cfg.guard.quarantine
    drain = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc)) if quarantine else inc
    q, e = out.q_pre, out.e
    qn = torch.clamp(q + e - drain, min=0.0)
    sq, sqn = (q * q).sum(-1), (qn * qn).sum(-1)
    wasted = torch.zeros_like(sq)
    if out.dlv is not None:
        wasted = (e * (out.a & ~out.dlv)).abs().sum(-1)
    k = cfg.num_clients * _EPS32
    return {"lyapunov": k * 0.5 * sq, "lyapunov_drift": k * 0.5 * (sq + sqn),
            "dpp_drift": k * (q * e).abs().sum(-1), "solver_residual": k * out.b.abs().sum(-1),
            "wasted_energy": k * wasted}


def check_metrics_replay(cfg, got: Dict[str, torch.Tensor], out: TrajOut, v, eta, inc,
                         radio=None, want: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Dict[str, float]:
    """Hold a ``HasMetrics`` launch's telemetry ``got`` to ``metrics_replay``
    of the same launch's rows (``out``): exact (a NaN equal to a NaN), but
    for the float-sum
    collectors (``FLOAT_SUM_COLLECTORS``), whose per-round values agree
    within K 2^-23 sum |terms| (plus one rounding of the value), their
    means within the rounds' bounds over T (plus the accumulator's T
    roundings), and whose histograms may move a count only between
    neighbouring bins, and only for a round whose value lies within its
    bound of an edge.  Raises ``AssertionError`` naming every entry that
    fails; returns each entry's largest absolute difference."""
    from repro_torch.obs.metrics import (
        MetricsSpec,
        ds_indices,
        hist_bin,
        hist_edges,
        metric_key,
    )

    spec = cfg.metrics
    if want is None:
        want = metrics_replay(cfg, out, v, eta, inc, radio)
    sums = [n for n in spec.names if n in FLOAT_SUM_COLLECTORS]
    vals = {}
    if sums:
        trace_cfg = dataclasses.replace(cfg, metrics=MetricsSpec(
            collect=tuple((n, "full_trace") for n in sums)))
        vals = {n: t for n, t in zip(sums, metrics_replay(trace_cfg, out, v, eta, inc,
                                                         radio).values())}
    bounds = _round_bounds(cfg, out, inc) if sums else {}
    T = cfg.num_rounds
    errs, bad = {}, []
    for name, red in spec.collect:
        key = metric_key(name, red)
        g, w = got[key], want[key]
        if g.shape != w.shape:
            bad.append(f"{key}: shape {tuple(g.shape)} != {tuple(w.shape)}")
            continue
        diff = (g - w).abs()
        errs[key] = float(diff.max()) if diff.numel() else 0.0
        if name not in FLOAT_SUM_COLLECTORS:
            if not bool(((g == w) | (g.isnan() & w.isnan())).all()):
                bad.append(f"{key}: not exact (max |diff| {errs[key]})")
            continue
        tol = bounds[name] + _EPS32 * vals[name].abs()          # (C, T)
        if red == "histogram":
            # a near-edge round may count in the bin beside its plain one
            lo, width = hist_edges(spec, cfg, name)
            x = vals[name]
            r = torch.remainder(x - lo, width)
            down, up = r <= tol, width - r <= tol
            idx = hist_bin(x, lo, width, spec.hist_bins)
            nb = torch.clamp(torch.where(down, idx - 1, idx + 1), 0, spec.hist_bins - 1)
            near = (down | up).to(torch.float32)
            allowed = torch.zeros_like(w).scatter_add_(1, idx, near).scatter_add_(1, nb, near)
            ok = (torch.equal(g.sum(-1), w.sum(-1))
                  and bool(((g - w).abs().sum(-1) <= 2 * near.sum(-1)).all())
                  and bool(((g == w) | (allowed > 0)).all()))
            if not ok:
                bad.append(f"{key}: counts off their plain bins beyond near-edge rounds")
            continue
        if red == "full_trace":
            lim = tol
        elif red == "full_trace_ds":
            lim = tol[:, torch.as_tensor(ds_indices(T, spec.ds_samples), device=tol.device)]
        elif red == "last":
            lim = tol[:, -1]
        else:  # mean: T additions, each within 2^-23 of the running sum
            lim = tol.sum(-1) / T + _EPS32 * vals[name].abs().sum(-1)
        if bool((diff > lim).any()):
            bad.append(f"{key}: max |diff| {errs[key]} beyond the reordering bound")
    if bad:
        raise AssertionError("HasMetrics against the replay: " + "; ".join(bad))
    return errs


# The collectors in csrc/ocean_traj.cuh's order: the per-client ones first.
KERNEL_COLLECTORS = (
    "queue", "queue_next", "energy_headroom", "selection_count", "selection_gap",
    "lyapunov", "lyapunov_drift", "dpp_penalty", "dpp_drift", "num_selected",
    "solver_residual", "bmin_active", "delivery_rate", "wasted_energy",
    "reallocation_count", "fault_count", "demoted_clients", "fallback_rounds",
    "topm_saturated",
)


class MetricsLaunch(NamedTuple):
    """A MetricsSpec lowered to one K3 launch (``csrc/ocean_traj_metrics.cu``,
    ``make_desc``): ctypes arrays of the layout and entries, the outputs
    by key, the per-cell region's size in floats, and per region entry
    (a mean accumulator or histogram) its key, offset and width."""

    layout: ctypes.Array
    ent: ctypes.Array
    entf: ctypes.Array
    outs: ctypes.Array
    out: Dict[str, torch.Tensor]
    region: int
    slots: Tuple[Tuple[str, int, int], ...]


def _metrics_descriptor(cfg, C: int, dev, hist_shift: Optional[Dict[str, int]] = None,
                        T: Optional[int] = None, init_accs=None) -> MetricsLaunch:
    """Lower ``cfg.metrics`` for one launch of C cells over T rounds (default
    ``cfg.num_rounds``; fewer for a segment): the entries with per-client
    collectors first, the region's layout (the state rows the spec's
    collectors need, and per entry its mean accumulator or histogram bins),
    each entry's histogram ``lo`` and width, and its output tensor: (C,) +
    shape for ``last``/``mean`` (a mean leaves the kernel as a sum), (C,
    bins), (C, T) + shape or (C, slots) + shape, the slots and their stride
    those of the whole trajectory.  ``init_accs`` (a segment's restored
    accumulators) fills the ``last`` and ``full_trace_ds`` outputs, so the
    slots earlier segments wrote survive.  ``hist_shift`` moves named
    histograms' ``lo`` by that many bins: a planted fault for the checks."""
    from repro_torch.obs.metrics import (
        REDUCTIONS,
        ds_slots,
        ds_stride,
        get_collector,
        hist_edges,
        metric_key,
    )

    spec = cfg.metrics
    T_total, K = cfg.num_rounds, cfg.num_clients
    T = T_total if T is None else T
    names = spec.names
    off = 0

    def take(n):
        nonlocal off
        off += n
        return off - n

    cum = take(K) if "energy_headroom" in names else -1
    cnt = take(K) if "selection_count" in names else -1
    last = gsum = gn = -1
    if "selection_gap" in names:
        last, gsum, gn = take(K), take(K), take(K)
    slots = ds_slots(T_total, spec.ds_samples)
    n = len(spec.collect)
    ent = (ctypes.c_int * (3 * n))()
    entf = (ctypes.c_float * (2 * n))()
    outs = (ctypes.c_void_p * n)()
    out = {}
    region_slots = []
    entries = sorted(spec.collect, key=lambda e: not get_collector(e[0]).shape(K))
    n_client = sum(1 for name, _ in entries if get_collector(name).shape(K))
    for j, (name, red) in enumerate(entries):
        shape = get_collector(name).shape(K)
        width = K if shape else 1
        key = metric_key(name, red)
        o = -1
        if red == "mean":
            o = take(width)
            region_slots.append((key, o, width))
        elif red == "histogram":
            o = take(spec.hist_bins)
            region_slots.append((key, o, spec.hist_bins))
            lo, bw = hist_edges(spec, cfg, name)
            entf[2 * j] = lo + bw * (hist_shift or {}).get(name, 0)
            entf[2 * j + 1] = bw
        full = {"histogram": (spec.hist_bins,), "full_trace": (T,) + shape,
                "full_trace_ds": (slots,) + shape}.get(red, shape)
        if init_accs is not None and red in ("last", "full_trace_ds"):
            t = init_accs[key].to(device=dev, dtype=torch.float32).clone()
        else:
            t = torch.empty((C,) + full, dtype=torch.float32, device=dev)  # the kernel writes all
        out[key] = t
        ent[3 * j], ent[3 * j + 1], ent[3 * j + 2] = (
            KERNEL_COLLECTORS.index(name), REDUCTIONS.index(red), o)
        outs[j] = t.data_ptr()
    layout = (ctypes.c_int * 10)(n, n_client, cum, cnt, last, gsum, gn, off,
                                  ds_stride(T_total, spec.ds_samples), spec.hist_bins)
    return MetricsLaunch(layout, ent, entf, outs, out, off, tuple(region_slots))


# The collectors of the kernel's running counters, in its order; a segment
# launch's region carries them after the region's floats.
COUNTER_COLLECTORS = ("reallocation_count", "fault_count", "demoted_clients", "fallback_rounds")


def _region_seed(cfg, ml: MetricsLaunch, mstate, C: int, dev) -> torch.Tensor:
    """A ``MetricsState`` of C cells as a segment launch's (C, region + 4)
    seed on ``dev``: the state rows (the allowance, selection counts, the
    selection gap's last round, gap sum and count), each mean's sum and
    each histogram's counts at their offsets, then the four running
    counters."""
    K = cfg.num_clients
    st = mstate.states
    seed = torch.zeros((C, ml.region + len(COUNTER_COLLECTORS)), dtype=torch.float32, device=dev)
    n, n_client, cum, cnt, last, gsum, gn = ml.layout[:7]
    if cum >= 0:
        seed[:, cum:cum + K] = st["energy_headroom"]
    if cnt >= 0:
        seed[:, cnt:cnt + K] = st["selection_count"]
    if last >= 0:
        lt, gs, gc = st["selection_gap"]
        seed[:, last:last + K] = lt.to(torch.float32)
        seed[:, gsum:gsum + K] = gs
        seed[:, gn:gn + K] = gc
    for key, off, width in ml.slots:
        seed[:, off:off + width] = mstate.accs[key].reshape(C, width)
    for j, name in enumerate(COUNTER_COLLECTORS):
        if name in st:
            seed[:, ml.region + j] = st[name]
    return seed


def _region_state(cfg, ml: MetricsLaunch, raw: torch.Tensor):
    """A segment launch's raw (C, region + 4) region and outputs as the
    ``MetricsState`` a round loop would carry, and the full traces by key
    (``_region_seed``'s inverse)."""
    from repro_torch.obs.metrics import MetricsState, get_collector, metric_key

    spec = cfg.metrics
    K = cfg.num_clients
    C = raw.shape[0]
    n, n_client, cum, cnt, last, gsum, gn = ml.layout[:7]
    rows = {"energy_headroom": cum, "selection_count": cnt}
    states = {}
    for name in spec.names:
        if name in rows:
            states[name] = raw[:, rows[name]:rows[name] + K].clone()
        elif name == "selection_gap":
            states[name] = (raw[:, last:last + K].to(torch.int32), raw[:, gsum:gsum + K].clone(),
                            raw[:, gn:gn + K].clone())
        elif name in COUNTER_COLLECTORS:
            states[name] = raw[:, ml.region + COUNTER_COLLECTORS.index(name)].clone()
        else:
            states[name] = ()
    region = {key: (off, width) for key, off, width in ml.slots}
    accs, traces = {}, {}
    for name, red in spec.collect:
        key = metric_key(name, red)
        if red == "full_trace":
            traces[key] = ml.out[key]
        elif key in region:
            off, width = region[key]
            shape = (spec.hist_bins,) if red == "histogram" else get_collector(name).shape(K)
            accs[key] = raw[:, off:off + width].reshape((C,) + shape).clone()
        else:  # last, full_trace_ds: the outputs themselves
            accs[key] = ml.out[key]
    return MetricsState(states=states, accs=accs), traces


def ocean_traj(cfg, h2, v, eta, inc, radio=None, failure=None, *,
               hist_shift: Optional[Dict[str, int]] = None, init_state=None, init_mstate=None,
               raw_metrics: bool = False, stream_bf16: bool = False,
               _force_wide: bool = False) -> TrajOut:
    """K3: every cell's T rounds in one launch.

    ``h2``/``inc`` (C, T, K) and ``v``/``eta`` (C, T), contiguous float32
    on one device; ``cfg`` supplies K, T, R, the static radio, the failure
    mode, the solver and the guard.  ``radio`` (optional) streams (C, T)
    ``b_min``, ``beta`` and ``energy_scale`` leaves in place of
    ``cfg.radio``; ``failure`` (optional) a (C, T, K) ``delivered`` mask and
    (C, K) ``rate``.  Gains and increments may be non-finite under a
    guard's quarantine: the kernel screens them.  With ``cfg.metrics`` the
    ``HasMetrics`` instance also collects the spec's telemetry
    (``TrajOut.metrics``); ``hist_shift`` ({collector: bins}) moves those
    collectors' histogram edges in the launch descriptor, a planted fault
    that the checks must catch.

    ``init_state`` (an ``OceanState`` of (C, K) queues and spent energy and
    (C,) global rounds) makes the launch a segment: the streams then cover
    T <= ``cfg.num_rounds`` rounds from that carry, frame resets and the
    telemetry follow the global round, and with ``cfg.metrics``
    ``init_mstate`` (the ``MetricsState`` after the earlier rounds) seeds
    the telemetry.  ``raw_metrics`` returns the telemetry unfinalized
    (``TrajOut.mstate`` and ``TrajOut.traces``) for the next segment.
    Segment launches count under their instance's label with ``+seg``.

    ``stream_bf16`` stores the b, e, q_pre and rho rows as bfloat16 (the
    label gains ``+bf16``); every other output, and the trajectory, is the
    float32 launch's.  Past ``MAX_CLIENTS`` clients the launch runs K3's
    wide instances (``csrc/ocean_traj_wide.cuh``, label ``+wide``; on the
    ranked row, ``ranked_row``, ``+wide+ranked``); ``_force_wide`` runs
    them at any K, to hold them against the shared-memory instances on the
    card.
    """
    wide = cfg.num_clients > MAX_CLIENTS or _force_wide
    ranked = wide and ranked_row(cfg, failure is not None)
    check_fused_scope(cfg)
    for name, x, nd in (("h2", h2, 3), ("v", v, 2), ("eta", eta, 2), ("inc", inc, 3)):
        _check_f32(name, x, nd)
    C, T, K = h2.shape
    seg = init_state is not None
    spec = cfg.metrics
    if (K != cfg.num_clients or inc.shape != h2.shape
            or not (T <= cfg.num_rounds if seg else T == cfg.num_rounds)):
        raise ValueError(
            f"h2/inc must be (C, {cfg.num_rounds}, {cfg.num_clients}) (a segment: "
            f"(C, T <= {cfg.num_rounds}, {cfg.num_clients})); got {tuple(h2.shape)} "
            f"and {tuple(inc.shape)}"
        )
    if v.shape != (C, T) or eta.shape != (C, T):
        raise ValueError(f"v and eta must be ({C}, {T})")
    if init_mstate is not None and (spec is None or not seg):
        raise ValueError("init_mstate seeds a segment launch with cfg.metrics set; pass "
                         "init_state with it")
    if seg and spec is not None and init_mstate is None:
        raise ValueError("a segment launch with cfg.metrics set needs init_mstate (the "
                         "restored MetricsState carry)")
    streams = [h2, v, eta, inc]
    if seg:
        _check_f32("init_state.q", init_state.q, 2)
        _check_f32("init_state.energy_spent", init_state.energy_spent, 2)
        if (init_state.q.shape != (C, K) or init_state.energy_spent.shape != (C, K)
                or init_state.t.shape != (C,)):
            raise ValueError(f"init_state must hold ({C}, {K}) q and energy_spent and ({C},) t")
        streams += [init_state.q, init_state.energy_spent, init_state.t]
    if radio is not None:
        for f in ("b_min", "beta", "energy_scale"):
            _check_f32(f"radio.{f}", getattr(radio, f), 2)
            if getattr(radio, f).shape != (C, T):
                raise ValueError(f"radio.{f} must be ({C}, {T})")
            streams.append(getattr(radio, f))
    if failure is not None:
        _check_f32("failure.delivered", failure.delivered, 3)
        _check_f32("failure.rate", failure.rate, 2)
        if failure.delivered.shape != h2.shape or failure.rate.shape != (C, K):
            raise ValueError(f"failure.delivered must be {tuple(h2.shape)} and rate ({C}, {K})")
        streams += [failure.delivered, failure.rate]
    if _launch_target(*streams) == "cpu":
        return ocean_traj_plain(cfg, h2, v, eta, inc, radio, failure, init_state=init_state,
                                init_mstate=init_mstate, raw_metrics=raw_metrics,
                                stream_bf16=stream_bf16)
    from repro_torch.kernels import _build

    from repro_torch.core.ocean import guard_caps
    from repro_torch.core.solvers import get_solver

    raw_metrics = raw_metrics and spec is not None
    backend = get_solver(cfg.solver)
    base = _base_solver(backend)
    if wide:
        name = "ocean_traj_wide_ranked" if ranked else "ocean_traj_wide"
        lib = _build.load(name if spec is None else name + "_metrics")
        fn = getattr(lib, name + ("_launch" if spec is None else "_metrics_launch"))
    else:
        lib = _build.load(_library(base, spec is not None))
        fn = lib.ocean_traj_launch if spec is None else lib.ocean_traj_metrics_launch
    fn.restype = ctypes.c_int
    dev = h2.device
    f32 = dict(dtype=torch.float32, device=dev)
    guard = cfg.guard
    chaos = backend.chaos
    topm = cfg.ranking == "topm"
    # a chaos backend without a guard runs on the guarded instance with
    # every defence off: the unguarded round's bits, corrupted
    guarded = guard is not None or chaos is not None
    i32 = dict(dtype=torch.int32, device=dev)
    gout = [torch.empty((C, T), **i32) for _ in range(3)] if guarded else [None] * 3
    rows = dict(dtype=torch.bfloat16 if stream_bf16 else torch.float32, device=dev)
    out = TrajOut(
        a=torch.empty((C, T, K), dtype=torch.bool, device=dev),
        b=torch.empty((C, T, K), **rows),
        e=torch.empty((C, T, K), **rows),
        q_pre=torch.empty((C, T, K), **rows),
        rho=torch.empty((C, T, K), **rows),
        obj=torch.empty((C, T), **f32),
        nsel=torch.empty((C, T), dtype=torch.int32, device=dev),
        q_final=torch.empty((C, K), **f32),
        es_final=torch.empty((C, K), **f32),
        dlv=None if failure is None else torch.empty((C, T, K), dtype=torch.bool, device=dev),
        ral=None if failure is None else torch.empty((C, T), dtype=torch.int32, device=dev),
        **dict(zip(("fc", "dm", "fb"), gout if guard is not None else [None] * 3)),
    )
    extra, raw, mirror = [], None, None
    if spec is not None:
        if stream_bf16:  # the telemetry reads the round's float32 rows here
            mirror = torch.empty((C, 3, K), **f32)
        ml = _metrics_descriptor(cfg, C, dev, hist_shift, T=T,
                                 init_accs=None if init_mstate is None else init_mstate.accs)
        scratch = torch.empty((max(C * ml.region, 1),), **f32)
        seed = None if init_mstate is None else _region_seed(cfg, ml, init_mstate, C, dev)
        if raw_metrics:
            raw = torch.empty((C, ml.region + len(COUNTER_COLLECTORS)), **f32)
        extra = [ml.layout, ml.ent, ml.entf, ml.outs, _ptr(scratch), _ptr(seed), _ptr(raw)]
    if C == 0:
        if spec is None:
            return out
        if raw_metrics:
            return out._replace(mstate=init_mstate, traces={
                k: t for k, t in ml.out.items() if k.endswith("/full_trace")})
        return out._replace(metrics=_finalize_launch(cfg, ml.out))
    # the kernel's kPlain, kOverprovision, kReallocate are this tuple's order
    from repro_torch.core.ocean import FAILURE_MODES

    wf_outer, wf_inner, wf_grid, frac = _wf_budgets(K)
    frac = frac.to(dev)
    rad = cfg.radio
    r_ptrs = [None] * 3 if radio is None else [radio.b_min, radio.beta, radio.energy_scale]
    cap, bits, floor, tol = None, 0, 0.0, 0.0
    if guard is not None:
        if guard.energy_cap is not None:
            cap = guard_caps(guard, cfg.budgets(device=dev)).contiguous()
        bits = ((_QUARANTINE if guard.quarantine else 0) | (_FALLBACK if guard.fallback else 0)
                | (_FLOOR if guard.gain_floor is not None else 0))
        floor = guard.gain_floor or 0.0
        tol = guard.residual_tol
    kind, scale = (None, 1.0) if chaos is None else chaos[1:]
    q0 = es0 = t0 = None
    if seg:
        q0 = init_state.q.contiguous()
        es0 = init_state.energy_spent.contiguous()
        t0 = init_state.t.to(torch.int32).contiguous()
    params = (
        _ptr(h2), _ptr(v), _ptr(eta), _ptr(inc), *(_ptr(x) for x in out[:9]),
        ctypes.c_int(C), ctypes.c_int(T), ctypes.c_int(K), ctypes.c_int(cfg.R),
        ctypes.c_float(rad.b_min), ctypes.c_float(rad.beta),
        ctypes.c_float(rad.energy_scale), ctypes.c_int(OUTER_ITERS),
        ctypes.c_int(INNER_ITERS), ctypes.c_int(min(cfg.top_m, K) if topm else K),
        ctypes.c_int(int(base == "pallas_tiled")), ctypes.c_int(int(topm)),
        *(_ptr(x) for x in r_ptrs),
        _ptr(None if failure is None else failure.delivered),
        _ptr(None if failure is None else failure.rate),
        _ptr(out.dlv), _ptr(out.ral), ctypes.c_int(FAILURE_MODES.index(cfg.failure_mode)),
        ctypes.c_int(wf_outer), ctypes.c_int(wf_inner), ctypes.c_int(wf_grid), _ptr(frac),
        ctypes.c_int(_SOLVER_CODE[base]), ctypes.c_int(BISECT_ITERS), ctypes.c_int(BISECT_ITERS),
        ctypes.c_int(int(guarded)), _ptr(cap), *(_ptr(x) for x in gout), ctypes.c_int(bits),
        ctypes.c_float(floor), ctypes.c_float(tol), ctypes.c_int(_CHAOS[kind]),
        ctypes.c_float(scale), _ptr(q0), _ptr(es0), _ptr(t0), ctypes.c_int(cfg.num_rounds),
        ctypes.c_int(int(stream_bf16)), _ptr(mirror), *extra,
    )
    if ranked:  # the ranked row's per-cell keys, ranks and sweep rows, as the launch sizes them
        floats = ctypes.c_longlong(0)
        _build.check(fn(*params, _ptr(None), ctypes.byref(floats), _stream()), lib, "ocean_traj")
        rk_scratch = torch.empty((max(floats.value, 1),), **f32)
        params += (_ptr(rk_scratch), ctypes.byref(floats))
    _build.check(fn(*params, _stream()), lib, "ocean_traj")
    if raw_metrics:
        mstate, traces = _region_state(cfg, ml, raw)
        out = out._replace(mstate=mstate, traces=traces)
    elif spec is not None:  # the means divide what the kernel wrote
        out = out._replace(metrics=_finalize_launch(cfg, ml.out))
    ocean_traj.launches += 1
    parts = (("radio", radio is not None), ("bisect", base == "bisect"),
             ("newton", base == "newton"), ("pallas_tiled", base == "pallas_tiled"),
             ("topm", topm), ("guard", guard is not None), ("chaos", chaos is not None),
             ("failure", failure is not None), ("metrics", spec is not None), ("wide", wide),
             ("ranked", ranked), ("bf16", stream_bf16))
    inst = "+".join(n for n, on in parts if on) or "static"
    if seg:
        inst += "+seg"
    if failure is not None:
        inst += f"/{cfg.failure_mode}"
    ocean_traj.instances[inst] = ocean_traj.instances.get(inst, 0) + 1
    return out


ocean_traj.launches = 0
# launches by instance: "static", or the "+"-joined branches it ran of
# "radio", "bisect", "newton", "pallas_tiled", "topm" (the ranking), "guard",
# "chaos", "failure", "metrics", "wide" (csrc/ocean_traj_wide.cuh), "ranked"
# (its ranked row) and "bf16" (stream_bf16), then "+seg" for a segment
# launch (and "/<mode>" with failures), e.g. "bisect+guard", "newton+topm",
# "pallas_tiled+topm+wide", "newton+topm+guard+metrics+wide", "static+seg",
# "radio+failure+metrics+seg/plain", "pallas_tiled+topm+failure+wide/reallocate",
# "wide+ranked" (ranking="sort", pallas) or
# "topm+failure+wide+ranked/overprovision"
ocean_traj.instances = {}


def _finalize_launch(cfg, outputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The telemetry dict from a ``HasMetrics`` launch's outputs (means
    leave the kernel as sums)."""
    from repro_torch.obs.metrics import MetricsState, finalize_metrics

    traces = {k: v for k, v in outputs.items() if k.endswith("/full_trace")}
    return finalize_metrics(cfg.metrics, cfg, MetricsState(states={}, accs=outputs), traces)


def ocean_trajectory_fused(
    cfg,
    h2_seq,
    v_seq,
    eta_seq,
    budget_seq,
    radio_seq=None,
    failure_seq=None,
    *,
    chunk=None,
    stream_bf16: bool = False,
    init_state=None,
    init_mstate=None,
    raw_metrics: bool = False,
):
    """The ``fused`` trajectory backend: (OceanState, stacked RoundDecision).

    Inputs carry the cell axis: ``h2_seq``/``budget_seq`` (C, T, K),
    ``v_seq``/``eta_seq`` (C, T); ``radio_seq`` a ``TracedRadio`` of (C, T)
    leaves and ``failure_seq`` a ``TracedFailure`` ((C, T, K), (C, K)).
    ``chunk`` is accepted for signature parity and has no role: K3 keeps
    every round on chip.  With ``cfg.metrics`` a third element, the
    telemetry dict, comes back.

    ``init_state`` turns the launch into a mid-trajectory segment (the
    streams cover only its rounds; the returned state's ``t`` is
    ``init_state.t`` plus them), with ``cfg.metrics`` seeded by
    ``init_mstate``; ``raw_metrics=True`` returns the unfinalized
    ``(state, decisions, mstate, traces)`` so that a segmented run can
    keep accumulating (``ocean_traj``).  ``stream_bf16`` returns the b, e,
    q and rho decisions as bfloat16.
    """
    from repro_torch.core.ocean import OceanState, RoundDecision

    del chunk
    out = ocean_traj(cfg, h2_seq, v_seq, eta_seq, budget_seq, radio_seq, failure_seq,
                     init_state=init_state, init_mstate=init_mstate, raw_metrics=raw_metrics,
                     stream_bf16=stream_bf16)
    C, T = h2_seq.shape[:2]
    if init_state is None:
        t = torch.full((C,), cfg.num_rounds, dtype=torch.int32, device=h2_seq.device)
    else:
        t = init_state.t + T
    state = OceanState(q=out.q_final, t=t, energy_spent=out.es_final)
    decs = RoundDecision(
        a=out.a, b=out.b, e=out.e, q=out.q_pre, rho=out.rho,
        objective=out.obj, num_selected=out.nsel, delivered=out.dlv, realloc=out.ral,
        fault_count=out.fc, demoted=out.dm, fallback=out.fb,
    )
    if cfg.metrics is None:
        return state, decs
    if raw_metrics:
        return state, decs, out.mstate, out.traces
    return state, decs, out.metrics
