"""Failure processes — port of ``repro.env.failure``.

Per-client delivery reliability as environment data: every registered
:class:`FailureProcess` lowers a JSON-able parameter dict to one
:class:`FailureParams` record, and one interpreter
(:func:`sample_failure_cells`) realizes a (T, K) *delivered* mask per
cell — 1.0 where a selected client's update would arrive.

``none``
    Every update delivers: an exact all-ones mask.
``iid_dropout``
    Bernoulli delivery with probability ``p_deliver`` (scalar or per client).
``markov_availability``
    Gilbert-Elliott up/down chain per client (``p_fail``, ``p_recover``),
    started from its stationary distribution.
``straggler_slowdown``
    Compute time ``compute_frac * exp(sigma z)`` deadlines, z ~ N(0, 1);
    late updates are lost.  Rate ``Phi(ln(1 / compute_frac) / sigma)``.

The lowering also declares each client's stationary delivery rate, which
``failure_mode="overprovision"`` reads.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.env.channel import LowerCtx, check_spec_keys


class TracedFailure(NamedTuple):
    """Realized reliability: the {0, 1} float32 ``delivered`` mask, (T, K)
    ((C, T, K) in a grid), and the declared rates ``rate``, (K,) ((C, K))."""

    delivered: torch.Tensor
    rate: torch.Tensor


class FailureParams(NamedTuple):
    """Unified parameterization of every failure process (float32 tensors)."""

    drop_on: torch.Tensor       # ()  1.0 => i.i.d. Bernoulli dropout
    p_deliver: torch.Tensor     # (K,)
    chain_on: torch.Tensor      # ()  1.0 => Gilbert-Elliott chain
    p_fail: torch.Tensor        # (K,) up -> down
    p_recover: torch.Tensor     # (K,) down -> up
    strag_on: torch.Tensor      # ()  1.0 => lognormal straggler slowdown
    strag_sigma: torch.Tensor   # (K,)
    compute_frac: torch.Tensor  # (K,) median compute time / deadline
    rate: torch.Tensor          # (K,) declared stationary delivery rate


def _off_mods(num_clients: int) -> Dict[str, torch.Tensor]:
    ones = torch.ones((num_clients,))
    zeros = torch.zeros((num_clients,))
    return dict(
        drop_on=torch.tensor(0.0), p_deliver=ones, chain_on=torch.tensor(0.0),
        p_fail=zeros, p_recover=ones, strag_on=torch.tensor(0.0), strag_sigma=ones,
        compute_frac=0.5 * ones, rate=ones,
    )


def is_active(params: FailureParams) -> bool:
    """Whether these (host) parameters can fail an update."""
    return bool(
        (params.drop_on > 0).any() or (params.chain_on > 0).any() or (params.strag_on > 0).any()
    )


class FailureDraws(NamedTuple):
    """One cell's failure stream (leading cell axis when stacked)."""

    u_drop: torch.Tensor   # (T, K)
    u_chain0: torch.Tensor  # (K,)
    u_chain: torch.Tensor  # (T, K)
    z: torch.Tensor        # (T, K) standard normal


def failure_draws(generator: torch.Generator, num_rounds: int, num_clients: int) -> FailureDraws:
    T, K = num_rounds, num_clients
    g = generator
    return FailureDraws(
        u_drop=torch.rand((T, K), generator=g),
        u_chain0=torch.rand((K,), generator=g),
        u_chain=torch.rand((T, K), generator=g),
        z=torch.randn((T, K), generator=g),
    )


def sample_failure_cells(
    params: FailureParams, draws: Optional[FailureDraws], num_rounds: int, num_clients: int
) -> torch.Tensor:
    """(C, T, K) delivered masks of C cells from stacked parameters and
    draws; inactive sub-processes contribute exact factors of 1.0, and
    ``draws`` may be ``None`` where no cell is active (all ones)."""
    p = params
    C = p.rate.shape[0]
    ones = torch.ones((C, num_rounds, num_clients))
    if draws is None:
        return ones

    def on(x):
        return x[:, None, None] > 0.0

    m_drop = (draws.u_drop < p.p_deliver[:, None, :]).to(torch.float32)
    pi_up = p.p_recover / torch.clamp(p.p_fail + p.p_recover, min=1e-12)
    up = (draws.u_chain0 < pi_up).to(torch.float32)
    chain = []
    for t in range(num_rounds):
        p_flip = torch.where(up > 0.0, p.p_fail, p.p_recover)
        up = torch.where(draws.u_chain[:, t] < p_flip, 1.0 - up, up)
        chain.append(up)
    m_chain = torch.stack(chain, 1)
    t_frac = p.compute_frac[:, None, :] * torch.exp(p.strag_sigma[:, None, :] * draws.z)
    m_strag = (t_frac <= 1.0).to(torch.float32)
    delivered = ones * torch.where(on(p.drop_on), m_drop, 1.0)
    delivered = delivered * torch.where(on(p.chain_on), m_chain, 1.0)
    return delivered * torch.where(on(p.strag_on), m_strag, 1.0)


def sample_failure_process(
    params: FailureParams, generator: torch.Generator, num_rounds: int, num_clients: int
) -> torch.Tensor:
    """(T, K) delivered mask of one cell."""
    stacked = FailureParams(*(x[None] for x in params))
    draws = None
    if is_active(params):
        draws = FailureDraws(
            *(x[None] for x in failure_draws(generator, num_rounds, num_clients))
        )
    return sample_failure_cells(stacked, draws, num_rounds, num_clients)[0]


def traced_failure(
    params: FailureParams, generator: torch.Generator, num_rounds: int, num_clients: int
) -> TracedFailure:
    """One cell's realized mask with its declared rates."""
    return TracedFailure(
        delivered=sample_failure_process(params, generator, num_rounds, num_clients),
        rate=params.rate,
    )


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
FailureLowerFn = Callable[[Mapping[str, Any], LowerCtx], FailureParams]
RateFn = Callable[[Mapping[str, Any], LowerCtx], Tuple[float, ...]]


class FailureProcess(NamedTuple):
    name: str
    lower: FailureLowerFn
    delivery_rate: Optional[RateFn] = None
    doc: str = ""


_FAILURE_REGISTRY: Dict[str, FailureProcess] = {}


def register_failure_process(
    name: str, lower: FailureLowerFn, *, delivery_rate: Optional[RateFn] = None, doc: str = ""
) -> FailureProcess:
    proc = FailureProcess(name, lower, delivery_rate, doc)
    _FAILURE_REGISTRY[name] = proc
    return proc


def available_failure_processes() -> Tuple[str, ...]:
    return tuple(sorted(_FAILURE_REGISTRY))


def get_failure_process(name: str) -> FailureProcess:
    if name not in _FAILURE_REGISTRY:
        raise ValueError(
            f"unknown failure process {name!r}; available: "
            f"{', '.join(available_failure_processes())}"
        )
    return _FAILURE_REGISTRY[name]


def _per_client(
    process: str, key: str, value: Any, num_clients: int, lo: float, hi: float
) -> Tuple[float, ...]:
    """A scalar-or-length-K parameter as K validated Python floats."""
    if isinstance(value, (int, float)):
        vals = (float(value),) * num_clients
    else:
        vals = tuple(float(v) for v in value)
        if len(vals) != num_clients:
            raise ValueError(
                f"{process} {key} needs a scalar or {num_clients} per-client "
                f"entries, got {len(vals)}"
            )
    for v in vals:
        if not lo <= v <= hi:
            raise ValueError(f"{process} {key} must lie in [{lo}, {hi}], got {v}")
    return vals


def _f32_vec(vals: Tuple[float, ...]) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.float32)


def _none_lower(spec, ctx):
    check_spec_keys("none", spec, ())
    return FailureParams(**_off_mods(ctx.num_clients))


def _none_rate(spec, ctx):
    return (1.0,) * ctx.num_clients


def _dropout_rate(spec, ctx):
    return _per_client(
        "iid_dropout", "p_deliver", spec.get("p_deliver", 0.9), ctx.num_clients, 0.0, 1.0
    )


def _dropout_lower(spec, ctx):
    check_spec_keys("iid_dropout", spec, ("p_deliver",))
    p = _dropout_rate(spec, ctx)
    fields = _off_mods(ctx.num_clients)
    fields.update(drop_on=torch.tensor(1.0), p_deliver=_f32_vec(p), rate=_f32_vec(p))
    return FailureParams(**fields)


def _markov_rates(spec, ctx):
    p_fail = _per_client(
        "markov_availability", "p_fail", spec.get("p_fail", 0.1), ctx.num_clients, 0.0, 1.0
    )
    p_recover = _per_client(
        "markov_availability", "p_recover", spec.get("p_recover", 0.4), ctx.num_clients, 0.0, 1.0
    )
    rates = []
    for pf, pr in zip(p_fail, p_recover):
        if pf + pr <= 0.0:
            raise ValueError(
                f"markov_availability needs p_fail + p_recover > 0 per client "
                f"(the chain must mix), got p_fail={pf}, p_recover={pr}"
            )
        rates.append(pr / (pf + pr))
    return p_fail, p_recover, tuple(rates)


def _markov_lower(spec, ctx):
    check_spec_keys("markov_availability", spec, ("p_fail", "p_recover"))
    p_fail, p_recover, rates = _markov_rates(spec, ctx)
    fields = _off_mods(ctx.num_clients)
    fields.update(
        chain_on=torch.tensor(1.0), p_fail=_f32_vec(p_fail), p_recover=_f32_vec(p_recover),
        rate=_f32_vec(rates),
    )
    return FailureParams(**fields)


def _markov_rate(spec, ctx):
    return _markov_rates(spec, ctx)[2]


def _straggler_rates(spec, ctx):
    sigma = _per_client(
        "straggler_slowdown", "sigma", spec.get("sigma", 0.5), ctx.num_clients, 1e-6, 10.0
    )
    frac = _per_client(
        "straggler_slowdown", "compute_frac", spec.get("compute_frac", 0.8),
        ctx.num_clients, 1e-6, 100.0,
    )
    rates = tuple(
        0.5 * (1.0 + math.erf(math.log(1.0 / f) / s / math.sqrt(2.0)))
        for s, f in zip(sigma, frac)
    )
    return sigma, frac, rates


def _straggler_lower(spec, ctx):
    check_spec_keys("straggler_slowdown", spec, ("sigma", "compute_frac"))
    sigma, frac, rates = _straggler_rates(spec, ctx)
    fields = _off_mods(ctx.num_clients)
    fields.update(
        strag_on=torch.tensor(1.0), strag_sigma=_f32_vec(sigma), compute_frac=_f32_vec(frac),
        rate=_f32_vec(rates),
    )
    return FailureParams(**fields)


def _straggler_rate(spec, ctx):
    return _straggler_rates(spec, ctx)[2]


register_failure_process(
    "none", _none_lower, delivery_rate=_none_rate,
    doc="every selected update delivers (the pre-failure paths)",
)
register_failure_process(
    "iid_dropout", _dropout_lower, delivery_rate=_dropout_rate,
    doc="i.i.d. Bernoulli delivery with probability p_deliver per round",
)
register_failure_process(
    "markov_availability", _markov_lower, delivery_rate=_markov_rate,
    doc="Gilbert-Elliott per-client up/down chain (p_fail / p_recover)",
)
register_failure_process(
    "straggler_slowdown", _straggler_lower, delivery_rate=_straggler_rate,
    doc="lognormal compute-time inflation; late updates miss the deadline",
)
