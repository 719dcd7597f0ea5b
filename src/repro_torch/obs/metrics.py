"""Per-round telemetry of the Lyapunov machinery — port of ``repro.obs.metrics``.

A static :class:`MetricsSpec` — ``((collector, reduction), ...)`` pairs —
selects per-round collectors from a registry of 19 and is carried on
``OceanConfig`` / ``Scenario`` (a grid must-agree field; ``None`` leaves
every path as it was, bit for bit).  Each collector reads a
:class:`RoundContext` assembled from the outputs of ``ocean_round``: the
round itself never changes.  Per-collector running state and
per-``(collector, reduction)`` accumulators form :class:`MetricsState`,
which rides the ``traj="scan"`` round loop; under ``traj="fused"`` kernel
K3 keeps the same state resident on chip across its rounds
(``csrc/ocean_traj.cuh``, its ``HasMetrics`` branch) and this module
finalizes what it wrote.

Every tensor carries the leading cell axis C, as ``ocean_round``'s do: a
scalar collector's value is (C,), a per-client one's (C, K).  Reductions:
``last`` and ``mean`` keep one value shape, ``histogram`` ``hist_bins``
counts over every round and element, ``full_trace`` the (C, T, ...)
stream (capped by ``FULL_TRACE_ELEM_CAP``), ``full_trace_ds`` a strided
downsample of at most ``ds_samples`` rounds.

Solver iteration budgets are constants of the program, reported by
:func:`solver_effort` for run manifests; the per-round solver diagnostics
are the derived ``solver_residual``, ``bmin_active`` and
``topm_saturated``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

# The S0 membership threshold of ``repro_torch.core.selection`` (a copy,
# so that the core can import this package without a cycle; the tests pin
# the two together).
_RHO_ZERO_TOL = 1e-30

REDUCTIONS = ("last", "mean", "histogram", "full_trace", "full_trace_ds")

# Ceiling on one full_trace stream: T x prod(value shape) elements (~134 MB
# as float32), checked when a config or scenario takes the spec.
FULL_TRACE_ELEM_CAP = 1 << 25

DEFAULT_HIST_BINS = 32

# Slot budget of a ``full_trace_ds`` entry: at most this many strided
# rounds are kept however long the horizon.
DEFAULT_DS_SAMPLES = 256


def ds_stride(num_rounds: int, ds_samples: int) -> int:
    """Sampling stride of ``full_trace_ds``: ceil(T / ds_samples).

    Rounds with ``t % stride == 0`` are kept, so the kept rounds are
    ``ds_indices(T, ds_samples)`` and at most ``ds_samples`` slots exist.
    """
    return -(-int(num_rounds) // int(ds_samples))


def ds_indices(num_rounds: int, ds_samples: int) -> np.ndarray:
    """The rounds ``full_trace_ds`` keeps: ``full_trace[:, ds_indices(T, n)]
    == full_trace_ds``."""
    return np.arange(0, int(num_rounds), ds_stride(num_rounds, ds_samples))


def ds_slots(num_rounds: int, ds_samples: int) -> int:
    """The number of rounds ``full_trace_ds`` keeps."""
    return -(-int(num_rounds) // ds_stride(num_rounds, ds_samples))


class RoundContext(NamedTuple):
    """What one OCEAN round shows the collectors, for every cell."""

    t: torch.Tensor             # (C,) int32 round index
    q: torch.Tensor             # (C, K) queues as P3 used them (after a frame reset)
    q_next: torch.Tensor        # (C, K) queues after the update
    a: torch.Tensor             # (C, K) bool selections
    b: torch.Tensor             # (C, K) bandwidth ratios
    e: torch.Tensor             # (C, K) this round's energy
    rho: torch.Tensor           # (C, K) priorities q / h^2
    objective: torch.Tensor     # (C,) P3 value
    num_selected: torch.Tensor  # (C,) int
    energy_spent: torch.Tensor  # (C, K) cumulative energy after this round
    budget_inc: torch.Tensor    # (C, K) this round's queue drain, as given
    v: torch.Tensor             # (C,) control parameter V
    eta: torch.Tensor           # (C,) temporal weight eta^t
    b_min: torch.Tensor         # (C,) or () bandwidth floor
    # With a failure process; None without one (the reliability collectors
    # then report perfect delivery):
    delivered: Optional[torch.Tensor] = None  # (C, K) bool selected and delivered
    realloc: Optional[torch.Tensor] = None    # (C,) int32 P4 re-solved mid-round
    # With a GuardSpec; None without one (the guard collectors report 0):
    fault_count: Optional[torch.Tensor] = None  # (C,) int32 quarantined draws
    demoted: Optional[torch.Tensor] = None      # (C,) int32 cap/floor demotions
    fallback: Optional[torch.Tensor] = None     # (C,) int32 bisect fallback


def _cells(x, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (C,) value as a float32 (C,) tensor beside ``like``."""
    x = torch.as_tensor(x, dtype=torch.float32, device=like.device)
    return x.expand(like.shape[0]) if x.dim() == 0 else x


def round_context(t, dec, new_state, v, eta, budget_inc, radio) -> RoundContext:
    """The collectors' view of one round's inputs and outputs."""
    return RoundContext(
        t=t,
        q=dec.q,
        q_next=new_state.q,
        a=dec.a,
        b=dec.b,
        e=dec.e,
        rho=dec.rho,
        objective=dec.objective,
        num_selected=dec.num_selected,
        energy_spent=new_state.energy_spent,
        budget_inc=budget_inc,
        v=_cells(v, dec.q),
        eta=_cells(eta, dec.q),
        b_min=(radio.b_min.to(torch.float32) if isinstance(radio.b_min, torch.Tensor)
               else _const(radio.b_min, dec.q)),
        delivered=getattr(dec, "delivered", None),
        realloc=getattr(dec, "realloc", None),
        fault_count=getattr(dec, "fault_count", None),
        demoted=getattr(dec, "demoted", None),
        fallback=getattr(dec, "fallback", None),
    )


class MetricsState(NamedTuple):
    """The metrics carry: per-collector state and per-entry accumulators."""

    states: Dict[str, Any]
    accs: Dict[str, torch.Tensor]


class Collector(NamedTuple):
    """One registered collector: a named per-round quantity."""

    name: str
    # per-round value shape (without the cell axis) as a function of K
    shape: Callable[[int], Tuple[int, ...]]
    # running-state init (cfg, C, device) -> tensors; () if stateless
    init: Callable[[Any, int, Any], Any]
    # (cfg, ctx, state) -> (value, new_state)
    collect: Callable[[Any, RoundContext, Any], Tuple[torch.Tensor, Any]]
    # histogram support (cfg) -> (lo, hi); values outside clip to the edge bins
    hist_range: Callable[[Any], Tuple[float, float]]
    doc: str


def _budget_hi(cfg) -> float:
    h = cfg.energy_budget_j
    return float(h if isinstance(h, (int, float)) else max(h))


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.sum(-1)


_CONSTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """A cached float32 0-dim constant (a Python float rounds once) on
    ``like``'s device."""
    key = (float(x), like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(x, dtype=torch.float32, device=like.device)
    return t


# -- collector bodies -------------------------------------------------------
def _c_queue(cfg, ctx, state):
    return _f32(ctx.q), state


def _c_queue_next(cfg, ctx, state):
    return _f32(ctx.q_next), state


def _c_lyapunov(cfg, ctx, state):
    q = _f32(ctx.q)
    return 0.5 * _sum(q * q), state


def _c_lyapunov_drift(cfg, ctx, state):
    q, qn = _f32(ctx.q), _f32(ctx.q_next)
    return 0.5 * (_sum(qn * qn) - _sum(q * q)), state


def _c_dpp_penalty(cfg, ctx, state):
    return ctx.v * ctx.eta * _f32(ctx.num_selected), state


def _c_dpp_drift(cfg, ctx, state):
    return _sum(_f32(ctx.q) * _f32(ctx.e)), state


def _c_energy_headroom(cfg, ctx, state):
    cum_inc = state + _f32(ctx.budget_inc)
    return cum_inc - _f32(ctx.energy_spent), cum_inc


def _c_num_selected(cfg, ctx, state):
    return _f32(ctx.num_selected), state


def _c_selection_count(cfg, ctx, state):
    counts = state + _f32(ctx.a)
    return counts, counts


def _c_selection_gap(cfg, ctx, state):
    last_t, gap_sum, gap_n = state
    t = ctx.t.to(torch.int32)[:, None]
    sel = ctx.a
    take = sel & (last_t >= 0)
    zero, one = _const(0.0, sel), _const(1.0, sel)
    gap_sum = gap_sum + torch.where(take, _f32(t - last_t), zero)
    gap_n = gap_n + torch.where(take, one, zero)
    last_t = torch.where(sel, t.expand_as(last_t), last_t)
    value = gap_sum / torch.clamp(gap_n, min=1.0)
    return value, (last_t, gap_sum, gap_n)


def _c_solver_residual(cfg, ctx, state):
    any_sel = _f32(ctx.num_selected > 0)
    return (_sum(_f32(ctx.b)) - 1.0).abs() * any_sel, state


def _c_bmin_active(cfg, ctx, state):
    b_min = torch.as_tensor(ctx.b_min, dtype=torch.float32, device=ctx.b.device)
    if b_min.dim() == 1:
        b_min = b_min[:, None]
    clamped = ctx.a & (_f32(ctx.b) <= b_min * _const(1.0 + 1e-6, b_min))
    return _sum(_f32(clamped)), state


def _c_topm_saturated(cfg, ctx, state):
    if cfg.ranking != "topm":
        return torch.zeros(ctx.q.shape[:1], dtype=torch.float32, device=ctx.q.device), state
    m_cands = min(int(cfg.top_m), int(cfg.num_clients))
    n0 = (ctx.rho <= _RHO_ZERO_TOL).sum(-1)
    sat = (_f32(ctx.num_selected) - _f32(n0)) >= float(m_cands)
    return _f32(sat), state


def _c_delivery_rate(cfg, ctx, state):
    # the share of this round's selections whose update arrived; without a
    # failure process every selection arrives
    ns = _f32(ctx.num_selected)
    dlv = ns if ctx.delivered is None else _sum(_f32(ctx.delivered))
    return dlv / torch.clamp(ns, min=1.0), state


def _c_wasted_energy(cfg, ctx, state):
    # energy charged to clients selected whose update did not arrive
    if ctx.delivered is None:
        return torch.zeros(ctx.q.shape[:1], dtype=torch.float32, device=ctx.q.device), state
    failed = ctx.a & ~ctx.delivered
    return _sum(_f32(ctx.e) * _f32(failed)), state


def _counter(field: str):
    """A running count of one (C,) int32 decision field (0 where absent)."""
    def collect(cfg, ctx, state):
        x = getattr(ctx, field)
        count = state if x is None else state + _f32(x)
        return count, count
    return collect


def _no_state(cfg, C, device):
    return ()


def _client_zeros(cfg, C, device):
    return torch.zeros((C, cfg.num_clients), dtype=torch.float32, device=device)


def _cell_zeros(cfg, C, device):
    return torch.zeros((C,), dtype=torch.float32, device=device)


def _gap_init(cfg, C, device):
    return (
        torch.full((C, cfg.num_clients), -1, dtype=torch.int32, device=device),
        _client_zeros(cfg, C, device),
        _client_zeros(cfg, C, device),
    )


_COLLECTORS: Dict[str, Collector] = {}


def _register(name, shape, init, collect, hist_range, doc):
    _COLLECTORS[name] = Collector(name, shape, init, collect, hist_range, doc)


def _per_client(k):
    return (k,)


def _scalar(k):
    return ()


_register("queue", _per_client, _no_state, _c_queue,
          lambda cfg: (0.0, _budget_hi(cfg)),
          "virtual energy-deficit queues q_k(t) as used by P3 (post frame-reset)")
_register("queue_next", _per_client, _no_state, _c_queue_next,
          lambda cfg: (0.0, _budget_hi(cfg)),
          "queues after the round's update q_k(t+1) = [q + e - inc]^+")
_register("lyapunov", _scalar, _no_state, _c_lyapunov,
          lambda cfg: (0.0, 0.5 * cfg.num_clients * _budget_hi(cfg) ** 2),
          "Lyapunov function L(t) = 0.5 * ||q(t)||^2")
_register("lyapunov_drift", _scalar, _no_state, _c_lyapunov_drift,
          lambda cfg: (-0.5 * cfg.num_clients * _budget_hi(cfg) ** 2,
                       0.5 * cfg.num_clients * _budget_hi(cfg) ** 2),
          "one-round Lyapunov drift 0.5 * (||q(t+1)||^2 - ||q(t)||^2)")
_register("dpp_penalty", _scalar, _no_state, _c_dpp_penalty,
          lambda cfg: (0.0, 1e-3),
          "drift-plus-penalty utility term V * eta^t * |S^t|")
_register("dpp_drift", _scalar, _no_state, _c_dpp_drift,
          lambda cfg: (0.0, 1e-3),
          "drift-plus-penalty queue-weighted energy term sum_k q_k * e_k")
_register("energy_headroom", _per_client, _client_zeros, _c_energy_headroom,
          lambda cfg: (-_budget_hi(cfg), _budget_hi(cfg)),
          "per-client budget headroom: cumulative allowance - cumulative spend")
_register("num_selected", _scalar, _no_state, _c_num_selected,
          lambda cfg: (0.0, float(cfg.num_clients)),
          "realized selection cardinality |S^t|")
_register("selection_count", _per_client, _client_zeros, _c_selection_count,
          lambda cfg: (0.0, float(cfg.num_rounds)),
          "running per-client selection counts (the paper's §IV temporal patterns)")
_register("selection_gap", _per_client, _gap_init, _c_selection_gap,
          lambda cfg: (0.0, float(cfg.num_rounds)),
          "running mean inter-selection gap per client (rounds between picks)")
_register("solver_residual", _scalar, _no_state, _c_solver_residual,
          lambda cfg: (0.0, 1e-4),
          "P4 feasibility residual |sum_k b_k - 1| of the returned allocation")
_register("bmin_active", _scalar, _no_state, _c_bmin_active,
          lambda cfg: (0.0, float(cfg.num_clients)),
          "selected clients pinned at the b_min bandwidth floor (clamp count)")
_register("delivery_rate", _scalar, _no_state, _c_delivery_rate,
          lambda cfg: (0.0, 1.0),
          "fraction of selected clients whose update arrived (1.0 sans failures)")
_register("wasted_energy", _scalar, _no_state, _c_wasted_energy,
          lambda cfg: (0.0, _budget_hi(cfg)),
          "energy charged to selected-but-failed clients this round")
_register("reallocation_count", _scalar, _cell_zeros, _counter("realloc"),
          lambda cfg: (0.0, float(cfg.num_rounds)),
          "running count of mid-round P4 re-solves (failure_mode='reallocate')")
_register("fault_count", _scalar, _cell_zeros, _counter("fault_count"),
          lambda cfg: (0.0, float(cfg.num_rounds * cfg.num_clients)),
          "running count of quarantined (non-finite/non-positive) channel draws")
_register("demoted_clients", _scalar, _cell_zeros, _counter("demoted"),
          lambda cfg: (0.0, float(cfg.num_rounds * cfg.num_clients)),
          "running count of bounded-energy admission demotions (cap/gain floor)")
_register("fallback_rounds", _scalar, _cell_zeros, _counter("fallback"),
          lambda cfg: (0.0, float(cfg.num_rounds)),
          "running count of rounds the solver fallback cascade committed bisect")
_register("topm_saturated", _scalar, _no_state, _c_topm_saturated,
          lambda cfg: (0.0, 1.0),
          "1.0 when ranking='topm' admitted its full candidate prefix "
          "(the optimum may be truncated); always 0.0 under ranking='sort'")


def available_collectors() -> Tuple[str, ...]:
    return tuple(sorted(_COLLECTORS))


def get_collector(name: str) -> Collector:
    if name not in _COLLECTORS:
        raise ValueError(
            f"unknown metrics collector {name!r}; available: "
            f"{', '.join(available_collectors())} (see repro_torch.obs.metrics)"
        )
    return _COLLECTORS[name]


def collector_table() -> Tuple[Tuple[str, str, str], ...]:
    """(name, shape, doc) rows, as the reference's report renders them."""
    return tuple(
        (name, "(K,)" if _COLLECTORS[name].shape(2) else "()", _COLLECTORS[name].doc)
        for name in available_collectors()
    )


# -- the spec ---------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class MetricsSpec:
    """Which ``(collector, reduction)`` entries a run records.

    It shapes the metrics state and outputs, so every scenario of one grid
    must agree on it; ``None`` means no metrics, and every path runs as it
    did without them.

    Attributes:
      collect:    ``((collector_name, reduction), ...)`` pairs; reductions are
                  ``last``, ``mean`` (over T), ``histogram`` (``hist_bins``
                  counts over all rounds and elements), ``full_trace`` (the
                  (T, ...) stream, capped by ``FULL_TRACE_ELEM_CAP``) and
                  ``full_trace_ds`` (rounds ``t % ds_stride(T, ds_samples)
                  == 0``, at most ``ds_samples`` of them).
      hist_bins:  histogram bins (each collector has a fixed support; values
                  outside it count in the edge bins).
      ds_samples: slot budget of every ``full_trace_ds`` entry.
    """

    collect: Tuple[Tuple[str, str], ...]
    hist_bins: int = DEFAULT_HIST_BINS
    ds_samples: int = DEFAULT_DS_SAMPLES

    def __post_init__(self):
        entries = tuple((str(n), str(r)) for n, r in self.collect)
        object.__setattr__(self, "collect", entries)
        seen = set()
        for name, red in entries:
            get_collector(name)
            if red not in REDUCTIONS:
                raise ValueError(
                    f"unknown metrics reduction {red!r} for collector "
                    f"{name!r}; available: {', '.join(REDUCTIONS)}"
                )
            if (name, red) in seen:
                raise ValueError(
                    f"duplicate metrics entry ({name!r}, {red!r}); each "
                    f"(collector, reduction) pair may appear once"
                )
            seen.add((name, red))
        if self.hist_bins < 2:
            raise ValueError(f"hist_bins={self.hist_bins} must be >= 2")
        if self.ds_samples < 1:
            raise ValueError(
                f"ds_samples={self.ds_samples} must be >= 1 (it is the "
                f"slot budget of every full_trace_ds entry)"
            )

    @classmethod
    def of(cls, *entries: str, hist_bins: int = DEFAULT_HIST_BINS,
           ds_samples: int = DEFAULT_DS_SAMPLES) -> "MetricsSpec":
        """Parse ``"collector:reduction"`` strings, e.g.
        ``MetricsSpec.of("queue:full_trace", "lyapunov_drift:mean")``."""
        pairs = []
        for s in entries:
            name, sep, red = s.partition(":")
            if not sep:
                raise ValueError(
                    f"metrics entry {s!r} must be 'collector:reduction' "
                    f"(e.g. 'queue:full_trace')"
                )
            pairs.append((name, red))
        return cls(collect=tuple(pairs), hist_bins=hist_bins, ds_samples=ds_samples)

    def validate(self, num_rounds: int, num_clients: int) -> "MetricsSpec":
        """Raise, before anything runs, for a trace above the memory cap."""
        for name, red in self.collect:
            if red not in ("full_trace", "full_trace_ds"):
                continue
            shape = get_collector(name).shape(num_clients)
            elems = min(self.ds_samples, num_rounds) if red == "full_trace_ds" else num_rounds
            for d in shape:
                elems *= d
            if elems > FULL_TRACE_ELEM_CAP:
                raise ValueError(
                    f"metrics entry ('{name}', '{red}') would stream "
                    f"{elems} elements (T={num_rounds} x shape {shape}), "
                    f"above the FULL_TRACE_ELEM_CAP={FULL_TRACE_ELEM_CAP} "
                    f"memory cap; record a bounded reduction instead "
                    f"('last'/'mean'/'histogram'), shorten the horizon, or "
                    f"trace a scalar collector"
                )
        return self

    @property
    def names(self) -> Tuple[str, ...]:
        """Unique collector names, in first-appearance order."""
        return tuple(dict.fromkeys(n for n, _ in self.collect))

    @property
    def full_trace_entries(self) -> Tuple[str, ...]:
        return tuple(n for n, r in self.collect if r == "full_trace")

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"collect": [list(p) for p in self.collect]}
        if self.hist_bins != DEFAULT_HIST_BINS:
            d["hist_bins"] = self.hist_bins
        if self.ds_samples != DEFAULT_DS_SAMPLES:
            d["ds_samples"] = self.ds_samples
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricsSpec":
        return cls(
            collect=tuple(tuple(p) for p in d.get("collect", ())),
            hist_bins=int(d.get("hist_bins", DEFAULT_HIST_BINS)),
            ds_samples=int(d.get("ds_samples", DEFAULT_DS_SAMPLES)),
        )


def metric_key(name: str, reduction: str) -> str:
    """The output key of one spec entry, ``"<collector>/<reduction>"``."""
    return f"{name}/{reduction}"


def hist_edges(spec: MetricsSpec, cfg, name: str) -> Tuple[float, float]:
    """``(lo, width)`` of a collector's histogram, as the binning uses them."""
    lo, hi = get_collector(name).hist_range(cfg)
    return lo, (hi - lo) / spec.hist_bins


def hist_bin(value: torch.Tensor, lo: float, width: float, bins: int) -> torch.Tensor:
    """The int64 bin of each value: floor((value - lo) / width) in float32,
    clipped to [0, bins - 1]; a NaN counts in bin 0."""
    f = torch.floor((_f32(value) - _const(lo, value)) / _const(width, value))
    top = torch.full_like(f, float(bins - 1))
    f = torch.where(f >= top, top, torch.where(f >= 0, f, torch.zeros_like(f)))
    return f.to(torch.int64)


# -- the round machinery ----------------------------------------------------
def init_metrics(spec: MetricsSpec, cfg, num_cells: int = 1, device=None) -> MetricsState:
    """The zero metrics state of ``num_cells`` trajectories."""
    C = num_cells
    states = {name: get_collector(name).init(cfg, C, device) for name in spec.names}
    accs: Dict[str, torch.Tensor] = {}
    for name, red in spec.collect:
        if red == "full_trace":
            continue  # streamed, not accumulated
        shape = get_collector(name).shape(cfg.num_clients)
        if red == "histogram":
            shape = (spec.hist_bins,)
        elif red == "full_trace_ds":
            shape = (ds_slots(cfg.num_rounds, spec.ds_samples),) + shape
        accs[metric_key(name, red)] = torch.zeros((C,) + shape, dtype=torch.float32,
                                                  device=device)
    return MetricsState(states=states, accs=accs)


def _keep(valid, new, old):
    if valid is True:
        return new
    v = torch.as_tensor(valid, dtype=torch.bool, device=new.device)
    return torch.where(v.reshape(v.shape + (1,) * (new.dim() - v.dim())), new, old)


def metrics_round(
    spec: MetricsSpec,
    cfg,
    ctx: RoundContext,
    mstate: MetricsState,
    valid=True,
) -> Tuple[MetricsState, Dict[str, torch.Tensor]]:
    """Collect one round: update states and accumulators, return this round's
    full-trace values.  ``valid`` ((C,) bool or True) masks the updates, as
    the reference's chunk-padded rounds need; every round of the port is
    valid."""
    values: Dict[str, torch.Tensor] = {}
    states: Dict[str, Any] = {}
    for name in spec.names:
        value, new = get_collector(name).collect(cfg, ctx, mstate.states[name])
        values[name] = value
        old = mstate.states[name]
        states[name] = (tuple(_keep(valid, n, o) for n, o in zip(new, old))
                        if isinstance(new, tuple) else _keep(valid, new, old))

    accs = dict(mstate.accs)
    traces: Dict[str, torch.Tensor] = {}
    for name, red in spec.collect:
        value = values[name]
        key = metric_key(name, red)
        if red == "full_trace":
            traces[key] = value
            continue
        acc = accs[key]
        if red == "last":
            accs[key] = _keep(valid, value, acc)
        elif red == "mean":
            accs[key] = acc + _keep(valid, value, torch.zeros_like(value))
        elif red == "full_trace_ds":
            stride = ds_stride(cfg.num_rounds, spec.ds_samples)
            t = ctx.t.to(torch.int64)
            take = (t % stride) == 0
            if valid is not True:
                take = take & torch.as_tensor(valid, dtype=torch.bool, device=t.device)
            idx = (t // stride).reshape((-1, 1) + (1,) * (acc.dim() - 2))
            idx = idx.expand((acc.shape[0], 1) + tuple(acc.shape[2:]))
            cur = acc.gather(1, idx)
            new = torch.where(take.reshape((-1,) + (1,) * (acc.dim() - 1)),
                              _f32(value).unsqueeze(1), cur)
            accs[key] = acc.scatter(1, idx, new)
        else:  # histogram
            lo, width = hist_edges(spec, cfg, name)
            idx = hist_bin(value, lo, width, spec.hist_bins)
            idx = idx.reshape(idx.shape[0], -1)
            w = torch.ones(idx.shape, dtype=torch.float32, device=idx.device)
            if valid is not True:
                w = _keep(valid, w, torch.zeros_like(w))
            accs[key] = acc.scatter_add(1, idx, w)
    return MetricsState(states=states, accs=accs), traces


def finalize_metrics(
    spec: MetricsSpec,
    cfg,
    mstate: MetricsState,
    traces: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """The output dict: accumulators resolved, full traces (C, T, ...)."""
    out: Dict[str, torch.Tensor] = {}
    for name, red in spec.collect:
        key = metric_key(name, red)
        if red == "full_trace":
            if traces is None or key not in traces:
                raise ValueError(
                    f"metrics entry {key!r} is a full trace but no streamed "
                    f"trace was provided to finalize_metrics"
                )
            out[key] = traces[key]
        elif red == "mean":
            out[key] = mstate.accs[key] / float(cfg.num_rounds)
        else:  # last / histogram / full_trace_ds: the accumulator itself
            out[key] = mstate.accs[key]
    return out


def stack_traces(per_round) -> Dict[str, torch.Tensor]:
    """Per-round trace dicts stacked along a round axis after the cell axis."""
    if not per_round:
        return {}
    return {k: torch.stack([tr[k] for tr in per_round], dim=1) for k in per_round[0]}


def solver_effort(cfg) -> Dict[str, Any]:
    """The solver's iteration budgets, constants of the program.

    ``bisect`` runs 42 x 42 halvings (``ocean_p``'s defaults, and
    ``BISECT_ITERS`` in kernel K3); ``pallas`` runs K1/K3's 12 outer x 9
    inner Newton steps per candidate from the geometric-mean seed (no seed
    grid); ``newton`` and ``pallas_tiled`` the bucketed
    ``newton_iteration_budgets`` with their seed grid.  The reference
    reports the newton budgets for ``pallas`` too; these are the port's.
    """
    from repro_torch.core.solvers import get_solver, newton_iteration_budgets
    from repro_torch.kernels.ocean_p import INNER_ITERS, OUTER_ITERS
    from repro_torch.kernels.ocean_traj import BISECT_ITERS

    backend = get_solver(cfg.solver)
    base = backend.chaos[0] if backend.chaos is not None else backend.name
    out: Dict[str, Any] = {
        "solver": backend.name,
        "ranking": cfg.ranking,
        "outer_iters": BISECT_ITERS,
        "inner_iters": BISECT_ITERS,
    }
    if base == "pallas":
        out.update(outer_iters=OUTER_ITERS, inner_iters=INNER_ITERS, seed_grid=0)
    elif base in ("newton", "pallas_tiled"):
        outer, inner, grid = newton_iteration_budgets(torch.float32, cfg.num_clients)
        out.update(outer_iters=outer, inner_iters=inner, seed_grid=grid)
    if cfg.ranking == "topm":
        out["top_m"] = int(cfg.top_m)
    return out
