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
launch).  Hooks this slice does not port — per-round radio sequences,
failure processes and failure modes, guards, metrics, checkpointing and
bf16 streaming — keep their arguments and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.core.energy import RadioParams, energy
from repro_torch.core.selection import (
    DEFAULT_BLOCK_K,
    DEFAULT_TOP_M,
    OceanPSolution,
    check_ranking,
    ocean_p,
)
from repro_torch.core.solvers import SolverBackend, get_solver

TRAJ_BACKENDS = ("scan", "fused")
FAILURE_MODES = ("plain", "overprovision", "reallocate")


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

    ``failure_mode`` other than ``plain``, ``metrics``, ``guard`` and
    ``checkpoint`` are hooks this slice does not port: setting them raises
    ``NotImplementedError``.
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
    metrics: Any = None
    guard: Any = None
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
        if self.failure_mode != "plain":
            raise not_ported(f"failure_mode={self.failure_mode!r}")
        for hook in ("metrics", "guard", "checkpoint"):
            if getattr(self, hook) is not None:
                raise not_ported(f"OceanConfig.{hook}")

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
    # Extensions of hooks not ported yet; always None here.
    delivered: Optional[torch.Tensor] = None
    realloc: Optional[torch.Tensor] = None
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
    budgets / T).  ``radio``, ``delivered`` and ``fail_rate`` are hooks of
    later slices.
    """
    if radio is not None:
        raise not_ported("a per-round radio (radio_seq)")
    if delivered is not None or fail_rate is not None:
        raise not_ported("failure processes (failure_seq)")
    at_boundary = (state.t > 0) & (torch.remainder(state.t, cfg.R) == 0)
    q = torch.where(at_boundary[:, None], torch.zeros_like(state.q), state.q)

    sol: OceanPSolution = ocean_p(
        q, h2, v, eta, cfg.radio,
        solver=cfg.solver, ranking=cfg.ranking, top_m=cfg.top_m,
        block_k=cfg.block_k,
    )
    e = energy(sol.b, h2, cfg.radio, sol.a)
    if budget_inc is None:
        if budgets is None:
            budgets = cfg.budgets(device=q.device)
        budget_inc = budgets / cfg.num_rounds
    q_next = torch.clamp(q + e - budget_inc, min=0.0)
    new_state = OceanState(
        q=q_next, t=state.t + 1, energy_spent=state.energy_spent + e
    )
    dec = RoundDecision(
        a=sol.a, b=sol.b, e=e, q=q, rho=sol.rho,
        objective=sol.objective, num_selected=sol.num_selected,
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
    """Run T rounds for every cell; returns the final state and decisions.

    ``h2_seq`` (C, T, K); ``eta_seq`` (T,) or (C, T); ``v`` a scalar or a
    per-frame (M,) sequence; ``budgets`` (K,) or (C, K); ``budget_seq``
    (T, K) or (C, T, K) per-round increments.  Decisions come back stacked
    as (C, T, K) and (C, T).  Runs on the card unless ``device="cpu"``.
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
    if radio_seq is not None:
        raise not_ported("radio_seq")
    if failure_seq is not None:
        raise not_ported("failure_seq")
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
    if budget_seq is None:
        tot = cfg.budgets(device=dev) if budgets is None else budgets
        tot = _per_cell(tot, C, (K,), "budgets", dev)
        budget_seq = (tot / cfg.num_rounds)[:, None, :].expand(C, T, K)
    budget_seq = _per_cell(budget_seq, C, (T, K), "budget_seq", dev)

    if traj == "fused":
        from repro_torch.kernels.ocean_traj import ocean_trajectory_fused

        return ocean_trajectory_fused(cfg, h2_seq, v_seq, eta_seq, budget_seq)

    state = init_state(cfg, C, device=dev)
    decs = []
    for t in range(T):
        state, dec = ocean_round(
            state, h2_seq[:, t], v_seq[:, t], eta_seq[:, t], cfg,
            budget_inc=budget_seq[:, t],
        )
        decs.append(dec)
    return state, stack_decisions(decs)


def stack_decisions(decs) -> RoundDecision:
    """Stack per-round decisions along a round axis after the cell axis."""
    return RoundDecision(
        *(
            None if getattr(decs[0], f) is None
            else torch.stack([getattr(d, f) for d in decs], dim=1)
            for f in RoundDecision._fields
        )
    )
