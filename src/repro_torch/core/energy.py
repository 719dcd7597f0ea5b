"""Radio physics of the WFLN uplink (paper §IV-A) — port of ``repro.core.energy``.

    E(a, b | h) = tau * N0 * B * b / h^2 * (2^{L / (tau * B * b)} - 1) * a

The workhorse is ``f(b) = b * (2^{beta / b} - 1)`` with ``beta = L/(tau*B)``
(Lemma 1: decreasing and convex on b > 0).  ``exp2`` exponents are clipped
to +-80 so impossible allocations saturate to a huge-but-finite energy.

Python-float radio constants enter the float32 math the way JAX's weak
types do: rounded once to float32 at the op.  ``exp2`` is evaluated in
float64 and rounded to float32 (correctly rounded), because PyTorch's CPU
float32 ``exp2`` takes a vector or a scalar code path depending on an
element's position in the tensor, and those disagree in the last bit —
the cell-batched engine would then not reproduce a single-cell run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]

_EXP2_CLIP = 80.0
SAFE_DIV_FLOOR = 1e-30
FLT_MIN = float(np.finfo(np.float32).tiny)  # smallest normal float32

# ln 2 and its square as float32 values (what jnp.log(2.0) and its
# float32 square give), used wherever the reference multiplies by them.
LN2 = float(np.float32(math.log(2.0)))
LN2_SQ = float(np.float32(LN2) * np.float32(LN2))

_RADIO_FIELDS = ("bandwidth_hz", "noise_w", "deadline_s", "model_bits", "b_min")


@dataclasses.dataclass(frozen=True)
class RadioParams:
    """Radio parameters of the WFLN (paper §VI defaults); Python floats only."""

    bandwidth_hz: float = 10e6
    noise_w: float = 1e-12
    deadline_s: float = 0.3
    model_bits: float = 3.4e5
    b_min: float = 0.02

    @property
    def beta(self) -> float:
        """L / (tau * B): exponent scale of the Shannon inversion."""
        return self.model_bits / (self.deadline_s * self.bandwidth_hz)

    @property
    def energy_scale(self) -> float:
        """tau * N0 * B: prefactor of E before the 1/h^2 term."""
        return self.deadline_s * self.noise_w * self.bandwidth_hz

    def validate(self, num_clients: int) -> None:
        """Fail fast on physically impossible configurations."""
        vals = {f: float(getattr(self, f)) for f in _RADIO_FIELDS}
        for name in ("bandwidth_hz", "deadline_s", "noise_w", "model_bits"):
            if not vals[name] > 0.0:
                raise ValueError(
                    f"{name}={vals[name]} must be positive: the Shannon "
                    f"inversion E = tau*N0*B*f(b) is undefined otherwise"
                )
        if not vals["b_min"] > 0.0:
            raise ValueError(
                f"b_min={vals['b_min']} must be positive (it is the "
                f"smallest bandwidth ratio a selected client can receive)"
            )
        if vals["b_min"] * num_clients > 1.0 + 1e-9:
            raise ValueError(
                f"b_min={vals['b_min']} infeasible for K={num_clients} "
                f"clients (need b_min <= 1/K)"
            )


_CONSTS: dict = {}


def as_f32(x: Scalar, like: torch.Tensor) -> torch.Tensor:
    """A float32 tensor on ``like``'s device (Python floats round once).

    Python floats become cached 0-dim tensors: tensor-tensor ops cost
    PyTorch about half the dispatch time of tensor-scalar ones.
    """
    if isinstance(x, torch.Tensor):
        return x
    key = (float(x), like.device)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(x, dtype=torch.float32, device=like.device)
    return t


def exp2(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 2^x (see the module docstring)."""
    return x.double().exp2_().to(x.dtype)


def exp2m1(x: torch.Tensor) -> torch.Tensor:
    """2^x - 1 with overflow clipping (x >= 0 in our use)."""
    return exp2(torch.clamp(x, -_EXP2_CLIP, _EXP2_CLIP)) - as_f32(1.0, x)


def _y(b: torch.Tensor, beta: Scalar):
    """(beta / safe_b, safe_b) with the float32 floor applied to b."""
    safe_b = torch.clamp(b, min=SAFE_DIV_FLOOR)
    return torch.div(as_f32(beta, safe_b), safe_b), safe_b


def f_shannon(b: torch.Tensor, beta: Scalar) -> torch.Tensor:
    """f(b) = b * (2^{beta/b} - 1); Lemma 1: decreasing & convex on b>0."""
    y, safe_b = _y(b, beta)
    return safe_b * exp2m1(y)


def _prime_second(b, beta, second: bool):
    y, safe_b = _y(b, beta)
    p = exp2(torch.clamp(y, -_EXP2_CLIP, _EXP2_CLIP))
    one = as_f32(1.0, y)
    fp = p * (one - as_f32(LN2, y) * y) - one
    if not second:
        return fp, None
    if isinstance(beta, torch.Tensor):
        beta_sq = beta * beta
    else:  # a Python float squares in double, as the reference's does
        beta_sq = as_f32(beta**2, safe_b)
    return fp, as_f32(LN2_SQ, y) * p * beta_sq / (safe_b * safe_b * safe_b)


def f_shannon_prime(b: torch.Tensor, beta: Scalar) -> torch.Tensor:
    """f'(b) = 2^{beta/b} (1 - ln2 * beta/b) - 1  (Eq. 21; negative, increasing)."""
    return _prime_second(b, beta, False)[0]


def f_shannon_second(b: torch.Tensor, beta: Scalar) -> torch.Tensor:
    """f''(b) = (ln2)^2 2^{beta/b} beta^2 / b^3  (Eq. 22; positive on b>0)."""
    return _prime_second(b, beta, True)[1]


def f_shannon_prime_second(b: torch.Tensor, beta: Scalar):
    """(f'(b), f''(b)) sharing one 2^{beta/b}: what a Newton step needs."""
    return _prime_second(b, beta, True)


def transmit_power_w_per_hz(
    b: torch.Tensor, h2: torch.Tensor, radio: RadioParams
) -> torch.Tensor:
    """p = N0 (2^{L/(tau B b)} - 1) / h^2 — inverted from Shannon (Eq. 1)."""
    y, _ = _y(b, radio.beta)
    return radio.noise_w * exp2m1(y) / h2


def energy(
    b: torch.Tensor,
    h2: torch.Tensor,
    radio: RadioParams,
    a: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Uplink energy E(a, b | h) of Eq. (2); 0 where ``a == 0`` or ``b == 0``.

    A subnormal b counts as 0, as it does in the reference, whose
    platforms (XLA on the CPU, the TPU) flush subnormals to zero.
    """
    e = radio.energy_scale * f_shannon(b, radio.beta) / h2
    e = torch.where(b >= FLT_MIN, e, torch.zeros_like(e))
    if a is not None:
        e = e * a.to(e.dtype)
    return e


def min_bandwidth_for_energy(
    e_budget: torch.Tensor,
    h2: torch.Tensor,
    radio: RadioParams,
    iters: int = 60,
) -> torch.Tensor:
    """Smallest bandwidth ratio b with E(b | h) <= e_budget (bisection).

    Returns b in [b_min, 1]; +inf where even b = 1 exceeds the budget.
    """
    shape = torch.broadcast_shapes(e_budget.shape, h2.shape)
    lo = torch.full(shape, radio.b_min, dtype=torch.float32, device=h2.device)
    hi = torch.ones_like(lo)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        too_much = energy(mid, h2, radio) > e_budget
        lo = torch.where(too_much, mid, lo)
        hi = torch.where(too_much, hi, mid)
    b = hi
    feasible = energy(torch.ones_like(lo), h2, radio) <= e_budget
    b = torch.where(
        feasible, torch.clamp(b, min=radio.b_min), torch.full_like(b, math.inf)
    )
    min_ok = energy(torch.full_like(lo, radio.b_min), h2, radio) <= e_budget
    return torch.where(min_ok, torch.full_like(b, radio.b_min), b)
