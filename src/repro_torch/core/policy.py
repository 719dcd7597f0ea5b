"""Unified Policy API — port of ``repro.core.policy`` (OCEAN variants only).

Every policy is a function

    trace_fn(cfg, h2_seq: (C, T, K), params: PolicyParams) -> PolicyTrace

looked up by name.  This slice registers ``ocean`` and its eta variants
``ocean-a`` / ``ocean-d`` / ``ocean-u``; the reference's baselines (SMO,
AMO, select_all, pattern) and failure-aware variants raise
``NotImplementedError`` until a later slice ports them.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.ocean import OceanConfig, not_ported, simulate
from repro_torch.core.patterns import eta_schedule

# Names the reference registers that this slice does not port.
_NOT_PORTED = ("select_all", "smo", "amo", "pattern", "ocean-over", "ocean-realloc")


class PolicyTrace(NamedTuple):
    """Per-cell decision traces of one policy: (C, T, K) and (C, T)."""

    a: torch.Tensor
    b: torch.Tensor
    e: torch.Tensor
    num_selected: torch.Tensor
    metrics: Optional[Dict[str, torch.Tensor]] = None
    delivered: Optional[torch.Tensor] = None
    # The queues each round's P3 saw (C, T, K); not in the reference's trace,
    # kept so a run can be replayed round by round against the plain path.
    q: Optional[torch.Tensor] = None


class PolicyParams(NamedTuple):
    """Common hyperparameters (fields as in the reference).

    ``eta`` (T,) or (C, T); ``budgets`` (K,) or (C, K); ``budget_seq``
    (C, T, K).  ``key``/``counts`` serve the stochastic pattern policy and
    ``radio_seq``/``failure_seq`` the environment hooks, none of which this
    slice ports.
    """

    v: Union[float, torch.Tensor] = 1e-5
    eta: Optional[torch.Tensor] = None
    budgets: Optional[torch.Tensor] = None
    key: Any = None
    counts: Optional[torch.Tensor] = None
    budget_seq: Optional[torch.Tensor] = None
    radio_seq: Any = None
    failure_seq: Any = None


TraceFn = Callable[[OceanConfig, torch.Tensor, PolicyParams], PolicyTrace]


class Policy(NamedTuple):
    name: str
    trace_fn: TraceFn
    default_eta: Optional[str] = None
    needs_key: bool = False


_REGISTRY: Dict[str, Policy] = {}

_OCEAN_VARIANTS = {"a": "ascend", "d": "descend", "u": "uniform"}


def register_policy(
    name: str,
    trace_fn: TraceFn,
    *,
    default_eta: Optional[str] = None,
    needs_key: bool = False,
) -> Policy:
    pol = Policy(name, trace_fn, default_eta, needs_key)
    _REGISTRY[name] = pol
    return pol


def available_policies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_policy(name: Union[str, Policy]) -> Policy:
    if isinstance(name, Policy):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _NOT_PORTED:
        raise not_ported(f"policy {name!r}")
    if name.startswith("ocean"):
        variant = name.split("-", 1)[1] if "-" in name else name[len("ocean"):]
        known = ", ".join(f"'ocean-{v}' ({s})" for v, s in _OCEAN_VARIANTS.items())
        raise ValueError(
            f"unknown OCEAN variant {variant!r} in policy name {name!r}; "
            f"known variants: {known}, or plain 'ocean' with an explicit "
            f"PolicyParams.eta"
        )
    raise ValueError(
        f"unknown policy {name!r}; available: {', '.join(available_policies())}"
    )


def resolve_params(
    policy: Policy,
    cfg: OceanConfig,
    params: Optional[PolicyParams] = None,
    *,
    scenario_eta: Optional[torch.Tensor] = None,
    scenario_budgets: Optional[torch.Tensor] = None,
    scenario_budget_seq: Optional[torch.Tensor] = None,
    device=None,
) -> PolicyParams:
    """Fill None fields: explicit > policy default > scenario > uniform/cfg."""
    params = PolicyParams() if params is None else params
    if params.radio_seq is not None:
        raise not_ported("PolicyParams.radio_seq")
    if params.failure_seq is not None:
        raise not_ported("PolicyParams.failure_seq")
    eta = params.eta
    if eta is None:
        if policy.default_eta is not None:
            eta = eta_schedule(policy.default_eta, cfg.num_rounds, device=device)
        elif scenario_eta is not None:
            eta = scenario_eta
        else:
            eta = eta_schedule("uniform", cfg.num_rounds, device=device)
    budgets = params.budgets
    if budgets is None:
        budgets = (
            scenario_budgets if scenario_budgets is not None
            else cfg.budgets(device=device)
        )
    budget_seq = params.budget_seq
    if budget_seq is None:
        budget_seq = scenario_budget_seq
    if policy.needs_key and params.key is None:
        raise ValueError(
            f"policy {policy.name!r} is stochastic and requires PolicyParams.key"
        )
    return params._replace(
        eta=torch.as_tensor(eta, dtype=torch.float32, device=device),
        budgets=budgets,
        budget_seq=budget_seq,
    )


def run_policy(
    name_or_policy: Union[str, Policy],
    cfg: OceanConfig,
    h2_seq: torch.Tensor,
    params: Optional[PolicyParams] = None,
    *,
    device=None,
) -> PolicyTrace:
    """Resolve defaults and run one policy over (C, T, K) channel draws."""
    pol = get_policy(name_or_policy)
    dev = torch.as_tensor(h2_seq).device if device is None else device
    return pol.trace_fn(
        cfg, h2_seq, resolve_params(pol, cfg, params, device=dev), device=dev
    )


def _ocean_fn(cfg: OceanConfig, h2_seq, params: PolicyParams, *, device=None):
    _, decs = simulate(
        cfg, h2_seq, params.eta, params.v,
        budgets=params.budgets, budget_seq=params.budget_seq, device=device,
    )
    return PolicyTrace(
        a=decs.a, b=decs.b, e=decs.e, num_selected=decs.num_selected, q=decs.q
    )


register_policy("ocean", _ocean_fn)
for _v, _sched in _OCEAN_VARIANTS.items():
    register_policy(f"ocean-{_v}", _ocean_fn, default_eta=_sched)
