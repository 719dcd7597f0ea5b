"""Unified Policy API — port of ``repro.core.policy``.

Every policy is a function

    trace_fn(cfg, h2_seq: (C, T, K), params: PolicyParams) -> PolicyTrace

looked up by name: OCEAN (``ocean``, the eta variants ``ocean-a`` /
``ocean-d`` / ``ocean-u`` and the failure-aware ``ocean-over`` /
``ocean-realloc``), the baselines ``select_all`` / ``smo`` / ``amo``, and
the stochastic count ``pattern``.  The reference's ``seg_init``/``seg_fn``
slots (segmented execution for checkpoint/resume) stay empty until that
hook is ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.baselines import PolicyTrace, amo, select_all, smo
from repro_torch.core.ocean import OceanConfig, simulate
from repro_torch.core.patterns import eta_schedule

__all__ = [
    "Policy", "PolicyParams", "PolicyTrace", "available_policies", "get_policy",
    "pattern_trace", "pattern_trace_scores", "register_policy", "resolve_params",
    "run_policy",
]


class PolicyParams(NamedTuple):
    """Common hyperparameters (fields as in the reference).

    ``eta`` (T,) or (C, T); ``budgets`` (K,) or (C, K); ``budget_seq``
    (C, T, K); ``key`` a ``torch.Generator`` (the pattern policy's
    scores); ``counts`` (T,) for ``pattern``; ``radio_seq`` a
    ``TracedRadio`` of (C, T) leaves; ``failure_seq`` a ``TracedFailure``.
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
    seg_init: Optional[Callable] = None  # segmented execution: not ported yet
    seg_fn: Optional[Callable] = None


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
    scenario_radio_seq=None,
    scenario_failure_seq=None,
    device=None,
) -> PolicyParams:
    """Fill None fields: explicit > policy default > scenario > uniform/cfg."""
    params = PolicyParams() if params is None else params
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
    radio_seq = scenario_radio_seq if params.radio_seq is None else params.radio_seq
    failure_seq = scenario_failure_seq if params.failure_seq is None else params.failure_seq
    if policy.needs_key and params.key is None:
        raise ValueError(
            f"policy {policy.name!r} is stochastic and requires PolicyParams.key"
        )
    return params._replace(
        eta=torch.as_tensor(eta, dtype=torch.float32, device=device),
        budgets=budgets,
        budget_seq=budget_seq,
        radio_seq=radio_seq,
        failure_seq=failure_seq,
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
    out = simulate(
        cfg, h2_seq, params.eta, params.v,
        budgets=params.budgets, budget_seq=params.budget_seq,
        radio_seq=params.radio_seq, failure_seq=params.failure_seq, device=device,
    )
    # simulate's arity follows cfg.metrics: the telemetry dict comes third
    # exactly when a MetricsSpec is set
    if cfg.metrics is not None:
        _, decs, metrics = out
    else:
        (_, decs), metrics = out, None
    return PolicyTrace(
        a=decs.a, b=decs.b, e=decs.e, num_selected=decs.num_selected,
        metrics=metrics, delivered=decs.delivered, q=decs.q,
    )


def _ocean_mode_fn(mode: str) -> TraceFn:
    def fn(cfg, h2_seq, params, *, device=None):
        return _ocean_fn(dataclasses.replace(cfg, failure_mode=mode), h2_seq, params,
                         device=device)
    return fn


def _on(h2_seq, device):
    return torch.as_tensor(h2_seq, dtype=torch.float32, device=device)


def _select_all_fn(cfg, h2_seq, params: PolicyParams, *, device=None):
    return select_all(cfg, _on(h2_seq, device), radio_seq=params.radio_seq,
                      failure_seq=params.failure_seq)


def _smo_fn(cfg, h2_seq, params: PolicyParams, *, device=None):
    return smo(cfg, _on(h2_seq, device), budgets=params.budgets,
               budget_seq=params.budget_seq, radio_seq=params.radio_seq,
               failure_seq=params.failure_seq)


def _amo_fn(cfg, h2_seq, params: PolicyParams, *, device=None):
    return amo(cfg, _on(h2_seq, device), budgets=params.budgets,
               radio_seq=params.radio_seq, failure_seq=params.failure_seq)


def pattern_trace_scores(scores: torch.Tensor, counts) -> PolicyTrace:
    """The pattern policy on given uniform scores (..., T, K): each round
    selects the ``counts[t]`` clients of the highest scores and splits the
    band evenly among them (energy is not the object of §III)."""
    counts = torch.as_tensor(counts, device=scores.device).to(torch.int64)
    K = scores.shape[-1]
    ranked = torch.sort(scores, dim=-1, descending=True).values
    idx = torch.clamp(counts - 1, min=0, max=K - 1)
    idx = torch.broadcast_to(idx, scores.shape[:-1])[..., None]
    thresh = torch.gather(ranked, -1, idx)
    a = (scores >= thresh) & (counts > 0)[..., None]
    n = torch.clamp(a.sum(-1, keepdim=True), min=1).to(scores.dtype)
    b = torch.where(a, 1.0 / n, torch.zeros((), dtype=scores.dtype, device=scores.device))
    return PolicyTrace(a=a, b=b, e=torch.zeros_like(b), num_selected=a.sum(-1).to(torch.int32))


def pattern_trace(generator: torch.Generator, counts, num_clients: int, num_cells: int = 1):
    """Random selection of ``counts[t]`` clients a round, (C, T, K) traces;
    the scores are uniforms drawn from ``generator``."""
    T = torch.as_tensor(counts).shape[-1]
    scores = torch.rand((num_cells, T, num_clients), generator=generator,
                        device=generator.device)
    return pattern_trace_scores(scores, counts)


def _pattern_fn(cfg, h2_seq, params: PolicyParams, *, device=None):
    if params.counts is None:
        raise ValueError("policy 'pattern' requires PolicyParams.counts (T,)")
    C = torch.as_tensor(h2_seq).shape[0]
    tr = pattern_trace(params.key, params.counts, cfg.num_clients, C)
    return PolicyTrace(*(x if not isinstance(x, torch.Tensor) else x.to(device) for x in tr))


register_policy("select_all", _select_all_fn)
register_policy("smo", _smo_fn)
register_policy("amo", _amo_fn)
register_policy("ocean", _ocean_fn)
for _v, _sched in _OCEAN_VARIANTS.items():
    register_policy(f"ocean-{_v}", _ocean_fn, default_eta=_sched)
# failure-aware OCEAN as policy names, so a grid sweeps them beside plain
# OCEAN; without a failure process they run the plain program
for _mode, _suffix in (("overprovision", "over"), ("reallocate", "realloc")):
    register_policy(f"ocean-{_suffix}", _ocean_mode_fn(_mode))
register_policy("pattern", _pattern_fn, needs_key=True)
