"""OCEAN — Online Client sElection and bAndwidth allocatioN (paper Alg. 1).

Port of ``repro.core.ocean``.  Each client keeps a virtual energy-deficit
queue

    q_k(t+1) = [ E(a_k^t, b_k^t | h_k^t) - H_k / T + q_k(t) ]^+ ,

reset at every frame boundary t = m*R, and every round solves P3 through
OCEAN-P with the frame's V and the round's eta.  The port runs many
independent cells at once: every state and decision carries a leading
cell axis C (the JAX engine's vmap over scenarios x seeds).

``simulate`` has two trajectory backends: ``scan`` (a Python loop over
rounds on (C, K) tensors) and ``fused`` (kernel K3,
``repro_torch.kernels.ocean_traj``: all T rounds of every cell in one
launch).  Both take per-round radio physics (a ``TracedRadio`` of (C, T)
leaves, ``repro_torch.env.radio``) and per-client delivery failures (a
``TracedFailure``, ``repro_torch.env.failure``) with the failure-aware
modes ``overprovision`` and ``reallocate``, a ``GuardSpec``
(``repro_torch.guard``: energy admission, solver fallback, quarantine)
and a ``MetricsSpec`` (``repro_torch.obs``: per-round telemetry).  Hooks
not ported yet — checkpoint/resume (segment launches) and bf16 streaming
— keep their arguments and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.bandwidth import solve_p4
from repro_torch.core.energy import RadioParams, as_f32, energy, lead
from repro_torch.core.selection import (
    DEFAULT_BLOCK_K,
    DEFAULT_TOP_M,
    OceanPSolution,
    check_ranking,
    ocean_p,
    p3_value,
)
from repro_torch.core.solvers import SolverBackend, get_solver
from repro_torch.guard.spec import GuardSpec
from repro_torch.obs.metrics import (
    MetricsSpec,
    finalize_metrics,
    init_metrics,
    metrics_round,
    round_context,
    stack_traces,
)

TRAJ_BACKENDS = ("scan", "fused")
FAILURE_MODES = ("plain", "overprovision", "reallocate")
# S0 membership, as repro_torch.core.selection classifies it
_RHO_ZERO_TOL = 1e-30


def not_ported(hook: str) -> NotImplementedError:
    """The error every hook outside this slice of the port raises."""
    return NotImplementedError(
        f"{hook} is not ported to repro_torch yet (see ROADMAP.md); use the "
        f"JAX package repro for it"
    )


def check_failure_mode(name: str) -> str:
    if name not in FAILURE_MODES:
        raise ValueError(
            f"unknown failure mode {name!r}; available: {', '.join(FAILURE_MODES)}"
        )
    return name


def check_traj_backend(name: str) -> str:
    if name not in TRAJ_BACKENDS:
        raise ValueError(
            f"unknown trajectory backend {name!r}; available: "
            f"{', '.join(TRAJ_BACKENDS)} (``scan`` is the round loop, "
            f"``fused`` the whole-trajectory kernel — see "
            f"repro_torch.kernels.ocean_traj)"
        )
    return name


@dataclasses.dataclass(frozen=True)
class OceanConfig:
    """Static configuration of one OCEAN run (fields as in ``repro``).

    ``failure_mode`` acts only where a failure process is passed
    (``plain``, ``overprovision`` or ``reallocate``; see
    ``_failure_adjust``).  ``guard`` is a ``repro_torch.guard.GuardSpec``
    or None (every round as unguarded).  ``metrics`` is a
    ``repro_torch.obs.MetricsSpec`` or None (no telemetry; ``simulate``
    then returns its 2-tuple).  ``checkpoint`` is a hook not ported yet:
    setting it raises ``NotImplementedError``.
    """

    num_clients: int
    num_rounds: int
    radio: RadioParams
    energy_budget_j: Union[float, Tuple[float, ...]] = 0.15
    frame_len: Optional[int] = None
    solver: Union[str, SolverBackend] = "bisect"
    ranking: str = "sort"
    top_m: int = DEFAULT_TOP_M
    block_k: int = DEFAULT_BLOCK_K
    traj: str = "scan"
    failure_mode: str = "plain"
    metrics: Optional[MetricsSpec] = None
    guard: Optional[GuardSpec] = None
    checkpoint: Any = None

    def __post_init__(self):
        backend = get_solver(self.solver)
        check_ranking(self.ranking)
        check_traj_backend(self.traj)
        check_failure_mode(self.failure_mode)
        if backend.topm is not None and self.ranking != "topm":
            raise ValueError(
                f"solver {backend.name!r} is sort-free and only runs under "
                f"ranking='topm' (got ranking={self.ranking!r})"
            )
        if self.top_m < 1:
            raise ValueError(f"top_m={self.top_m} must be >= 1")
        if self.block_k < 1:
            raise ValueError(f"block_k={self.block_k} must be >= 1")
        self.radio.validate(self.num_clients)
        if self.frame_len is not None and self.frame_len <= 0:
            raise ValueError(
                f"frame_len={self.frame_len} must be a positive number of "
                f"rounds (or None for the single-frame R = T setting)"
            )
        if self.guard is not None and not isinstance(self.guard, GuardSpec):
            raise TypeError(
                f"guard must be a repro_torch.guard.GuardSpec or None; got {self.guard!r}"
            )
        if self.metrics is not None:
            if not isinstance(self.metrics, MetricsSpec):
                raise TypeError(
                    f"metrics must be a repro_torch.obs.MetricsSpec or None; "
                    f"got {self.metrics!r}"
                )
            # the full-trace memory cap needs this config's (T, K)
            self.metrics.validate(self.num_rounds, self.num_clients)
        if self.checkpoint is not None:
            raise not_ported("OceanConfig.checkpoint (checkpoint/resume)")

    @property
    def R(self) -> int:
        return self.frame_len or self.num_rounds

    @property
    def num_frames(self) -> int:
        return -(-self.num_rounds // self.R)

    def budgets(self, device=None) -> torch.Tensor:
        h = torch.as_tensor(self.energy_budget_j, dtype=torch.float32, device=device)
        return torch.broadcast_to(h, (self.num_clients,))


class OceanState(NamedTuple):
    q: torch.Tensor             # (C, K) energy-deficit queues
    t: torch.Tensor             # (C,) int32 round index
    energy_spent: torch.Tensor  # (C, K) cumulative true energy


class RoundDecision(NamedTuple):
    a: torch.Tensor             # (C, K) bool selection (stacked: (C, T, K))
    b: torch.Tensor             # (C, K) bandwidth ratios
    e: torch.Tensor             # (C, K) energy consumed this round
    q: torch.Tensor             # (C, K) queues before the update (used by P3)
    rho: torch.Tensor           # (C, K) priorities
    objective: torch.Tensor     # (C,) P3 optimum
    num_selected: torch.Tensor  # (C,) int32
    # With a failure process: selected and delivered (C, K) bool, and
    # whether P4 re-ran mid-round (C,) int32; None without one.
    delivered: Optional[torch.Tensor] = None
    realloc: Optional[torch.Tensor] = None
    # With a GuardSpec, (C,) int32 each: quarantined draws, clients demoted
    # by the cap or the floor, and 1 where the bisect fallback was
    # committed; None without one.
    fault_count: Optional[torch.Tensor] = None
    demoted: Optional[torch.Tensor] = None
    fallback: Optional[torch.Tensor] = None


def init_state(cfg: OceanConfig, num_cells: int = 1, device=None) -> OceanState:
    dev = resolve_device(device)
    k = cfg.num_clients
    return OceanState(
        q=torch.zeros((num_cells, k), dtype=torch.float32, device=dev),
        t=torch.zeros((num_cells,), dtype=torch.int32, device=dev),
        energy_spent=torch.zeros((num_cells, k), dtype=torch.float32, device=dev),
    )


def _masked_p4(cfg: OceanConfig, rho, in_s0, mask, radio) -> torch.Tensor:
    """P4 bandwidth over an arbitrary selected set with OCEAN-P's S0 split
    (reference ``repro/core/ocean.py:248``): zero-rho members get b_min
    (and the whole budget when no positive-rho member is selected); the
    rest share delta through ``solve_p4(method=cfg.solver)``."""
    b_min = lead(radio.b_min, 1)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    n0 = (mask & in_s0).sum(1).to(rho.dtype)
    delta = 1.0 - n0 * b_min
    pos = mask & ~in_s0
    b_pos, _ = solve_p4(rho, pos, delta, radio, method=cfg.solver)
    leftover = torch.where(pos.sum(1) == 0, delta, zero)
    b0_each = b_min + leftover / torch.clamp(n0, min=1.0)
    return torch.where(pos, b_pos, torch.where(mask & in_s0, b0_each[:, None], zero))


def guard_caps(guard: GuardSpec, budgets: torch.Tensor) -> torch.Tensor:
    """The admission ceiling ``energy_cap x H_k`` in float32."""
    return torch.as_tensor(guard.energy_cap, dtype=torch.float32, device=budgets.device) * budgets


def _guard_admission(cfg: OceanConfig, h2, budgets, radio):
    """The guard's screens before P3 (reference ``repro/core/ocean.py:266``).

    Returns ``(h2, admit, fault_count, demoted)``: the gains with
    quarantined draws set to 1, the (C, K) admission mask for ``ocean_p``
    (None where the spec demotes nobody), and per cell the quarantined
    draws and the cap/floor demotions.  Eq. (2) energy decreases in b
    (Lemma 1), so ``E(b_min | h^2) <= energy_cap x H_k`` bounds every
    feasible allocation's spend.
    """
    g = cfg.guard
    dev = h2.device
    ok = torch.ones_like(h2, dtype=torch.bool)
    fault_count = torch.zeros((h2.shape[0],), dtype=torch.int32, device=dev)
    if g.quarantine:
        finite = torch.isfinite(h2) & (h2 > 0.0)
        fault_count = (~finite).sum(1).to(torch.int32)
        # sanitized before any arithmetic touches the draw
        h2 = torch.where(finite, h2, torch.ones_like(h2))
        ok = finite
    admit = ok
    if g.gain_floor is not None:
        admit = admit & (h2 >= as_f32(g.gain_floor, h2))
    if g.energy_cap is not None:
        caps = guard_caps(g, cfg.budgets(device=dev) if budgets is None
                          else torch.as_tensor(budgets, dtype=torch.float32, device=dev))
        b_min = torch.broadcast_to(
            torch.as_tensor(lead(radio.b_min, 2), dtype=h2.dtype, device=dev), h2.shape)
        admit = admit & (energy(b_min, h2, radio) <= caps)
    demoted = (ok & ~admit).sum(1).to(torch.int32)
    return h2, (admit if g.admits else None), fault_count, demoted


def _guard_fallback(cfg: OceanConfig, q, h2, v, eta, radio, admit, sol: OceanPSolution):
    """Validate the committed solve; fall back to bisect where it fails
    (reference ``repro/core/ocean.py:302``).

    A cell fails on a non-finite b, P3 value or rho, a budget residual
    ``|sum b - 1|`` above ``residual_tol`` with anything selected, or a
    selected b below ``b_min (1 - 1e-6)``.  Failing cells commit
    ``ocean_p(solver="bisect")`` of the same guarded inputs; the bisect
    solve runs only when some cell fails (the committed bits are the same
    as the reference's solve-then-select).  Returns the solution and the
    (C,) int32 flags.
    """
    zero = torch.zeros((), dtype=sol.b.dtype, device=sol.b.device)
    b_min = torch.as_tensor(lead(radio.b_min, 2), dtype=torch.float32, device=sol.b.device)
    fin_b = torch.isfinite(sol.b)
    bz = torch.where(fin_b, sol.b, zero)
    finite_ok = fin_b.all(1) & torch.isfinite(sol.objective) & torch.isfinite(sol.rho).all(1)
    residual = (bz.sum(1) - 1.0).abs()
    residual_ok = (sol.num_selected == 0) | (residual <= as_f32(cfg.guard.residual_tol, residual))
    bmin_ok = (~sol.a | (bz >= b_min * as_f32(1.0 - 1e-6, bz))).all(1)
    bad = ~(finite_ok & residual_ok & bmin_ok)
    if bool(bad.any()):
        fb = ocean_p(
            q, h2, v, eta, radio, solver="bisect", ranking=cfg.ranking,
            top_m=cfg.top_m, block_k=cfg.block_k, admit=admit,
        )
        sol = OceanPSolution(*(
            torch.where(bad.reshape((-1,) + (1,) * (s.dim() - 1)), f, s)
            for s, f in zip(sol, fb)
        ))
    return sol, bad.to(torch.int32)


def cumsum_sequential(x: torch.Tensor) -> torch.Tensor:
    """Prefix sums along the last axis, added left to right in x's dtype:
    one defined order on every device (K3 adds in the same order)."""
    acc = torch.zeros_like(x[..., 0])
    out = []
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
        out.append(acc)
    return torch.stack(out, -1)


def _failure_adjust(cfg: OceanConfig, q, h2, v, eta, sol: OceanPSolution, e, radio,
                    delivered, fail_rate, admit=None):
    """Apply ``cfg.failure_mode`` to one committed round of every cell
    (reference ``repro/core/ocean.py:339``).  With a guard's ``admit``
    mask, overprovision's extension stops at the admitted count.

    Returns ``(a, b, e, objective, num_selected, delivered, realloc)``.
    Selected clients pay their energy whether or not their update arrives,
    except under ``reallocate``, where failures found at the deadline
    midpoint stop transmitting: the round then costs half the committed
    energy plus half that of P4 re-run on the survivors.  Under
    ``overprovision``, a cell whose extended prefix is the plain selection
    keeps the committed solve (the reference re-solves the same strictly
    convex P4, which agrees within its tolerance).
    """
    ok = delivered > 0.0
    C, K = q.shape
    no_ral = torch.zeros((C,), dtype=torch.int32, device=q.device)
    if cfg.failure_mode == "plain":
        return sol.a, sol.b, e, sol.objective, sol.num_selected, sol.a & ok, no_ral
    in_s0 = sol.rho <= _RHO_ZERO_TOL
    if cfg.failure_mode == "overprovision":
        if fail_rate is None:
            raise ValueError(
                "failure_mode='overprovision' needs the failure process's declared "
                "delivery rates (TracedFailure.rate); pass the full TracedFailure"
            )
        m_plain = sol.num_selected.to(torch.int64)
        order = torch.argsort(sol.rho, dim=1, stable=True)  # ascending: S0 first
        inv = torch.argsort(order, dim=1, stable=True)
        rate = torch.broadcast_to(torch.as_tensor(fail_rate, device=q.device), (C, K))
        csum = cumsum_sequential(torch.gather(rate, 1, order))
        # the smallest prefix whose declared rates sum to the plain count,
        # at least the plain prefix, at most what b_min leaves room for
        n_exp = 1 + (csum < m_plain.to(csum.dtype)[:, None]).sum(1)
        b_min = torch.as_tensor(lead(radio.b_min, 1), dtype=torch.float32, device=q.device)
        cap = torch.floor(torch.tensor(1.0 + 1e-9, dtype=torch.float32, device=q.device) / b_min)
        n_max = torch.clamp(cap.to(torch.int64), max=K)
        if admit is not None:
            # never reach into the demoted clients at the tail of the order
            n_max = torch.minimum(n_max, admit.sum(1))
        n_ext = torch.minimum(torch.clamp(torch.maximum(n_exp, m_plain), min=0), n_max)
        n_ext = torch.where(m_plain > 0, n_ext, torch.zeros_like(n_ext))
        a = inv < n_ext[:, None]
        b_ext = _masked_p4(cfg, sol.rho, in_s0, a, radio)
        extended = (n_ext != m_plain)[:, None]
        b = torch.where(extended, b_ext, sol.b)
        e_out = torch.where(extended, energy(b_ext, h2, radio, a), e)
        obj = torch.where(extended[:, 0], p3_value(a, b_ext, q, h2, v, eta, radio), sol.objective)
        ns = a.sum(1).to(sol.num_selected.dtype)
        return a, b, e_out, obj, ns, a & ok, no_ral
    # reallocate: commit the plain decision, re-run P4 on the survivors
    surv = sol.a & ok
    any_failed = (sol.a & ~ok).any(1)
    b2 = _masked_p4(cfg, sol.rho, in_s0, surv, radio)
    e2 = energy(b2, h2, radio, surv)
    e_out = torch.where(any_failed[:, None], 0.5 * e + 0.5 * e2, e)
    return (sol.a, sol.b, e_out, sol.objective, sol.num_selected, surv,
            any_failed.to(torch.int32))


def ocean_round(
    state: OceanState,
    h2: torch.Tensor,
    v,
    eta,
    cfg: OceanConfig,
    budgets: Optional[torch.Tensor] = None,
    budget_inc: Optional[torch.Tensor] = None,
    radio=None,
    delivered: Optional[torch.Tensor] = None,
    fail_rate: Optional[torch.Tensor] = None,
) -> Tuple[OceanState, RoundDecision]:
    """One OCEAN round for every cell: frame reset -> P3 -> act -> queue update.

    ``h2`` (C, K); ``v``/``eta`` scalars or (C,); ``budgets`` (K,) or
    (C, K) totals; ``budget_inc`` (C, K) per-round drain (default
    budgets / T).  ``radio`` overrides ``cfg.radio`` with this round's
    physics: a ``RadioParams`` or per-cell (C,) leaves (one round of a
    ``TracedRadio``).  ``delivered`` (C, K) is this round's {0, 1}
    delivery mask and ``fail_rate`` (K,) or (C, K) the declared rates;
    with them the round applies ``cfg.failure_mode`` and reports
    ``delivered``/``realloc``.  Without them it is the pre-failure round.

    With ``cfg.guard`` the round runs guarded: gains are quarantined and
    the cap / floor demotes clients before P3 (``budgets`` sets the cap,
    ``cfg.budgets()`` without it), the solve is validated with a bisect
    fallback, and a non-finite queue increment becomes 0; the counts come
    back as ``fault_count``/``demoted``/``fallback``.
    """
    radio = cfg.radio if radio is None else radio
    at_boundary = (state.t > 0) & (torch.remainder(state.t, cfg.R) == 0)
    q = torch.where(at_boundary[:, None], torch.zeros_like(state.q), state.q)

    admit = fault_count = demoted = fb_flag = None
    if cfg.guard is not None:
        h2, admit, fault_count, demoted = _guard_admission(
            cfg, torch.as_tensor(h2), budgets, radio)
    sol: OceanPSolution = ocean_p(
        q, h2, v, eta, radio,
        solver=cfg.solver, ranking=cfg.ranking, top_m=cfg.top_m,
        block_k=cfg.block_k, admit=admit,
    )
    if cfg.guard is not None:
        if cfg.guard.fallback:
            sol, fb_flag = _guard_fallback(cfg, q, h2, v, eta, radio, admit, sol)
        else:
            fb_flag = torch.zeros_like(sol.num_selected)
    e = energy(sol.b, h2, radio, sol.a)
    a, b, objective, num_selected = sol.a, sol.b, sol.objective, sol.num_selected
    dlv = ral = None
    if delivered is not None:
        a, b, e, objective, num_selected, dlv, ral = _failure_adjust(
            cfg, q, h2, v, eta, sol, e, radio, delivered, fail_rate, admit=admit
        )
    if budget_inc is None:
        if budgets is None:
            budgets = cfg.budgets(device=q.device)
        budget_inc = budgets / cfg.num_rounds
    if cfg.guard is not None and cfg.guard.quarantine:
        budget_inc = torch.where(torch.isfinite(budget_inc), budget_inc,
                                 torch.zeros_like(budget_inc))
    q_next = torch.clamp(q + e - budget_inc, min=0.0)
    new_state = OceanState(
        q=q_next, t=state.t + 1, energy_spent=state.energy_spent + e
    )
    dec = RoundDecision(
        a=a, b=b, e=e, q=q, rho=sol.rho,
        objective=objective, num_selected=num_selected, delivered=dlv, realloc=ral,
        fault_count=fault_count, demoted=demoted, fallback=fb_flag,
    )
    return new_state, dec


def v_schedule(cfg: OceanConfig, v, device=None) -> torch.Tensor:
    """Broadcast a scalar V (or per-frame (M,) sequence) to per-round (T,)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.dim() == 0:
        return torch.full((cfg.num_rounds,), float(v), dtype=torch.float32, device=device)
    if v.dim() != 1 or v.shape[0] != cfg.num_frames:
        raise ValueError(
            f"per-frame V sequence has shape {tuple(v.shape)}, but this config "
            f"has {cfg.num_frames} frames (T={cfg.num_rounds} rounds / "
            f"R={cfg.R} per frame => M=ceil(T/R)={cfg.num_frames}); pass a "
            f"scalar V or one entry per frame"
        )
    frame_idx = torch.arange(cfg.num_rounds, device=v.device) // cfg.R
    return v[frame_idx]


def _per_cell(x, C, shape, name, dev) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if x.shape == shape:
        x = x.expand((C,) + shape)
    if tuple(x.shape) != (C,) + shape:
        raise ValueError(
            f"{name} must have shape {shape} or {(C,) + shape}; got {tuple(x.shape)}"
        )
    return x.contiguous()


def simulate(
    cfg: OceanConfig,
    h2_seq,
    eta_seq,
    v,
    budgets=None,
    budget_seq=None,
    radio_seq=None,
    failure_seq=None,
    traj: Optional[str] = None,
    stream_bf16: bool = False,
    checkpoint=None,
    resume_from=None,
    *,
    device=None,
):
    """Run T rounds for every cell; returns the final state and decisions,
    and with ``cfg.metrics`` set a third element, the telemetry dict of
    ``"<collector>/<reduction>"`` keys ((C, ...) tensors, full traces
    (C, T, ...)).  ``cfg.metrics=None`` returns the 2-tuple, bit for bit as
    without the hook.

    ``h2_seq`` (C, T, K); ``eta_seq`` (T,) or (C, T); ``v`` a scalar or a
    per-frame (M,) sequence; ``budgets`` (K,) or (C, K); ``budget_seq``
    (T, K) or (C, T, K) per-round increments; ``radio_seq`` a
    ``TracedRadio`` of (T,) or (C, T) leaves (None: the static
    ``cfg.radio``); ``failure_seq`` a ``TracedFailure`` ((T, K) or
    (C, T, K) mask, (K,) or (C, K) rates; None: no failures).  Decisions
    come back stacked as (C, T, K) and (C, T).  Runs on the card unless
    ``device="cpu"``.

    ``budgets`` also sets a guard's energy cap on the scan path, as in the
    reference; the fused path, like the reference's fused kernel, caps at
    ``cfg.budgets()`` (``ROADMAP.md`` Queue 3).
    """
    traj = check_traj_backend(cfg.traj if traj is None else traj)
    if stream_bf16:
        if traj != "fused":
            raise ValueError(
                "stream_bf16=True requires the 'fused' trajectory backend; "
                f"got traj={traj!r}"
            )
        raise not_ported("stream_bf16")
    if checkpoint not in (None, False) or resume_from is not None:
        raise not_ported("checkpoint/resume")
    dev = resolve_device(device)
    h2_seq = torch.as_tensor(h2_seq, dtype=torch.float32, device=dev)
    if h2_seq.dim() != 3 or tuple(h2_seq.shape[1:]) != (cfg.num_rounds, cfg.num_clients):
        raise ValueError(
            f"h2_seq must be (C, T={cfg.num_rounds}, K={cfg.num_clients}); "
            f"got {tuple(h2_seq.shape)}"
        )
    h2_seq = h2_seq.contiguous()
    C, T, K = h2_seq.shape
    v_seq = v_schedule(cfg, v, device=dev).expand(C, T).contiguous()
    eta_seq = _per_cell(eta_seq, C, (T,), "eta_seq", dev)
    if budgets is not None:
        budgets = _per_cell(budgets, C, (K,), "budgets", dev)
    if budget_seq is None:
        tot = cfg.budgets(device=dev) if budgets is None else budgets
        tot = _per_cell(tot, C, (K,), "budgets", dev)
        budget_seq = (tot / cfg.num_rounds)[:, None, :].expand(C, T, K)
    budget_seq = _per_cell(budget_seq, C, (T, K), "budget_seq", dev)
    if radio_seq is not None:
        radio_seq = type(radio_seq)(
            *(_per_cell(x, C, (T,), "radio_seq leaf", dev) for x in radio_seq)
        )
    if failure_seq is not None:
        failure_seq = type(failure_seq)(
            delivered=_per_cell(failure_seq.delivered, C, (T, K), "failure_seq.delivered", dev),
            rate=_per_cell(failure_seq.rate, C, (K,), "failure_seq.rate", dev),
        )

    if traj == "fused":
        from repro_torch.kernels.ocean_traj import ocean_trajectory_fused

        return ocean_trajectory_fused(
            cfg, h2_seq, v_seq, eta_seq, budget_seq, radio_seq, failure_seq
        )

    spec = cfg.metrics
    state = init_state(cfg, C, device=dev)
    mstate = None if spec is None else init_metrics(spec, cfg, C, device=dev)
    decs, traces = [], []
    for t in range(T):
        radio_t = None if radio_seq is None else radio_seq.at(t)
        new_state, dec = ocean_round(
            state, h2_seq[:, t], v_seq[:, t], eta_seq[:, t], cfg, budgets,
            budget_inc=budget_seq[:, t],
            radio=radio_t,
            delivered=None if failure_seq is None else failure_seq.delivered[:, t],
            fail_rate=None if failure_seq is None else failure_seq.rate,
        )
        if spec is not None:
            # the collectors read the round's outputs and never change them
            ctx = round_context(state.t, dec, new_state, v_seq[:, t], eta_seq[:, t],
                                budget_seq[:, t], cfg.radio if radio_t is None else radio_t)
            mstate, tr = metrics_round(spec, cfg, ctx, mstate)
            traces.append(tr)
        state = new_state
        decs.append(dec)
    if spec is None:
        return state, stack_decisions(decs)
    return state, stack_decisions(decs), finalize_metrics(spec, cfg, mstate, stack_traces(traces))


def stack_decisions(decs) -> RoundDecision:
    """Stack per-round decisions along a round axis after the cell axis."""
    return RoundDecision(
        *(
            None if getattr(decs[0], f) is None
            else torch.stack([getattr(d, f) for d in decs], dim=1)
            for f in RoundDecision._fields
        )
    )
