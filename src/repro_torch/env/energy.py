"""Budget processes — port of ``repro.env.energy``.

A budget process gives a (T, K) matrix of per-round energy increments dH
(what OCEAN's queues and SMO's per-round caps consume) and a (K,) total
(what AMO budgets against).  Every entry lowers to one
:class:`BudgetParams` record interpreted by one sampler.

``static``
    ``dH[t] = H_k / T``, the paper's constant drain.
``harvesting``
    With probability ``p_active`` a round harvests an Exp packet whose
    mean keeps the long-run arrival rate at ``mean_j_per_round`` (default
    ``H_k / T``); the realized total replaces ``H_k``.
``depleting``
    Increments decay linearly to ``end_frac`` of the first while summing
    to ``H_k`` (battery wear).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.env.channel import LowerCtx, check_spec_keys


class BudgetParams(NamedTuple):
    """Unified parameterization of every budget process (float32 tensors)."""

    det_inc: torch.Tensor       # (T, K) deterministic per-round increments
    stoch_scale: torch.Tensor   # ()  1.0 => add stochastic arrivals
    rate: torch.Tensor          # (K,) mean energy per active arrival (J)
    p_active: torch.Tensor      # ()  per-round arrival probability
    total_static: torch.Tensor  # (K,) declared total H_k
    use_realized: torch.Tensor  # ()  1.0 => total = sum of the increments


def needs_budget_stream(params: BudgetParams) -> bool:
    """Whether these (host) parameters read the budget stream."""
    return bool((params.stoch_scale != 0).any())


def budget_draws(generator: torch.Generator, num_rounds: int, num_clients: int):
    """One cell's (u_act, u_amt) uniforms, each (T, K); u_amt on [1e-6, 1)."""
    u_act = torch.rand((num_rounds, num_clients), generator=generator)
    u_amt = 1e-6 + torch.rand((num_rounds, num_clients), generator=generator) * (1.0 - 1e-6)
    return u_act, u_amt


def sample_budget_cells(
    params: BudgetParams, draws: Optional[Tuple[torch.Tensor, torch.Tensor]]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dH (C, T, K), total (C, K)) of C cells from stacked parameters and
    draws; ``draws`` may be ``None`` where no cell reads the stream."""
    if draws is None:
        return params.det_inc, params.total_static
    u_act, u_amt = draws
    p = params
    arrivals = (
        p.rate[:, None, :] * -torch.log(u_amt)
        * (u_act < p.p_active[:, None, None]).to(torch.float32)
    )
    dh = p.det_inc + p.stoch_scale[:, None, None] * arrivals
    total = torch.where(p.use_realized[:, None] > 0.0, dh.sum(1), p.total_static)
    return dh, total


def sample_budget_process(
    params: BudgetParams, generator: torch.Generator, num_rounds: int, num_clients: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dH (T, K), total (K,)) of one cell."""
    stacked = BudgetParams(*(x[None] for x in params))
    draws = None
    if needs_budget_stream(params):
        draws = tuple(x[None] for x in budget_draws(generator, num_rounds, num_clients))
    dh, total = sample_budget_cells(stacked, draws)
    return dh[0], total[0]


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
BudgetLowerFn = Callable[[Mapping[str, Any], LowerCtx], BudgetParams]


class BudgetProcess(NamedTuple):
    name: str
    lower: BudgetLowerFn
    doc: str = ""


_BUDGET_REGISTRY: Dict[str, BudgetProcess] = {}


def register_budget_process(name: str, lower: BudgetLowerFn, *, doc: str = "") -> BudgetProcess:
    proc = BudgetProcess(name, lower, doc)
    _BUDGET_REGISTRY[name] = proc
    return proc


def available_budget_processes() -> Tuple[str, ...]:
    return tuple(sorted(_BUDGET_REGISTRY))


def get_budget_process(name: str) -> BudgetProcess:
    if name not in _BUDGET_REGISTRY:
        raise ValueError(
            f"unknown budget process {name!r}; available: "
            f"{', '.join(available_budget_processes())}"
        )
    return _BUDGET_REGISTRY[name]


def _ctx_budgets(spec: Mapping[str, Any], ctx: LowerCtx) -> torch.Tensor:
    h = spec.get("budget_j", ctx.budgets_j)
    return torch.broadcast_to(torch.as_tensor(h, dtype=torch.float32), (ctx.num_clients,))


def _off_fields(ctx: LowerCtx, det_inc, totals) -> Dict[str, torch.Tensor]:
    return dict(
        det_inc=det_inc,
        stoch_scale=torch.tensor(0.0),
        rate=torch.zeros((ctx.num_clients,)),
        p_active=torch.tensor(0.0),
        total_static=totals,
        use_realized=torch.tensor(0.0),
    )


def _static_lower(spec, ctx):
    check_spec_keys("static", spec, ("budget_j",))
    h = _ctx_budgets(spec, ctx)
    det = torch.broadcast_to(h / ctx.num_rounds, (ctx.num_rounds, ctx.num_clients))
    return BudgetParams(**_off_fields(ctx, det, h))


def _harvesting_lower(spec, ctx):
    check_spec_keys("harvesting", spec, ("budget_j", "p_active", "mean_j_per_round"))
    h = _ctx_budgets(spec, ctx)
    p_active = float(spec.get("p_active", 0.5))
    if not 0.0 < p_active <= 1.0:
        raise ValueError(f"harvesting p_active must be in (0, 1], got {p_active}")
    mean = spec.get("mean_j_per_round")
    mean_arr = (
        h / ctx.num_rounds if mean is None
        else torch.broadcast_to(torch.as_tensor(mean, dtype=torch.float32), (ctx.num_clients,))
    )
    fields = _off_fields(ctx, torch.zeros((ctx.num_rounds, ctx.num_clients)), h)
    fields.update(
        stoch_scale=torch.tensor(1.0),
        rate=mean_arr / torch.tensor(p_active),
        p_active=torch.tensor(p_active),
        use_realized=torch.tensor(1.0),
    )
    return BudgetParams(**fields)


def _depleting_lower(spec, ctx):
    check_spec_keys("depleting", spec, ("budget_j", "end_frac"))
    h = _ctx_budgets(spec, ctx)
    T = ctx.num_rounds
    end_frac = float(spec.get("end_frac", 0.0))
    if not 0.0 <= end_frac <= 1.0:
        raise ValueError(f"depleting end_frac must be in [0, 1], got {end_frac}")
    ramp = 1.0 - (1.0 - end_frac) * torch.arange(T, dtype=torch.float32) / max(T - 1, 1)
    weights = ramp / ramp.sum()
    return BudgetParams(**_off_fields(ctx, weights[:, None] * h[None, :], h))


register_budget_process(
    "static", _static_lower, doc="constant H_k / T drain (the paper's setting)"
)
register_budget_process(
    "harvesting", _harvesting_lower,
    doc="stochastic per-round energy arrivals accumulating into H_k",
)
register_budget_process(
    "depleting", _depleting_lower,
    doc="per-round allowance decays linearly to end_frac (battery wear)",
)
