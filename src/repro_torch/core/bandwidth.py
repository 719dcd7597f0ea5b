"""P4 — the per-selection-set convex bandwidth problem (paper §V-B).

Port of ``repro.core.bandwidth``.  For a selection mask over clients with
priorities rho_k > 0 and a budget ``delta``:

    minimize    sum_k rho_k * f(b_k)
    subject to  sum_k b_k = delta,   b_k >= b_min

KKT gives rho_k f'(b_k) = -lam for interior clients; ``b_k(lam)`` is found
by an inner bisection on f' and ``lam`` by an outer bisection on the
budget residual.  Every function takes any number of leading axes: the
client axis is the last one, ``delta`` carries the leading axes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.energy import (
    RadioParams,
    as_f32,
    f_shannon,
    f_shannon_prime,
    lead,
)


def _b_of_lam(
    lam: torch.Tensor,
    rho: torch.Tensor,
    beta: float,
    b_min: float,
    b_max: torch.Tensor,
    iters: int,
) -> torch.Tensor:
    """Solve rho_k f'(b) = -lam for each k by bisection; clamp to [b_min, b_max]."""
    target = -lam / torch.clamp(rho, min=1e-30)
    lo = torch.broadcast_to(as_f32(b_min, target), target.shape)
    hi = torch.broadcast_to(b_max, target.shape).to(target.dtype)
    half = as_f32(0.5, target)
    for _ in range(iters):
        mid = half * (lo + hi)
        below = f_shannon_prime(mid, beta) < target
        lo = torch.where(below, mid, lo)
        hi = torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def solve_p4(
    rho: torch.Tensor,
    mask: torch.Tensor,
    delta: torch.Tensor,
    radio: RadioParams,
    outer_iters: int = 42,
    inner_iters: int = 42,
    method: str = "bisect",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal bandwidth split of ``delta`` among ``mask``-ed clients.

    Args:
      rho:   (..., K) priorities q_k / h_k^2.
      mask:  (..., K) bool — membership of S - S0.
      delta: (...) total ratio to distribute.
      radio: ``RadioParams``, or per-cell leaves shaped like leading axes
            of ``delta`` (``repro_torch.core.energy.lead``).
      method: ``bisect`` (this module) or another registered backend's
            single-mask waterfiller (``repro_torch.core.solvers``).

    Returns ``b`` (..., K), 0 outside the mask, and ``cost`` (...), the
    sum of rho_k f(b_k) over the mask.
    """
    if method != "bisect":
        from repro_torch.core.solvers import get_solver, waterfill_newton

        backend = get_solver(method)
        waterfill = backend.waterfill or waterfill_newton
        return waterfill(rho, mask, delta, radio)
    mask = mask.to(torch.bool)
    delta = torch.as_tensor(delta, dtype=rho.dtype, device=rho.device)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    nd = rho.dim()
    beta = lead(radio.beta, nd)
    b_min = lead(radio.b_min, nd)
    b_min_d = lead(radio.b_min, nd - 1)

    n = mask.sum(-1)
    has_any = n > 0
    n_safe = torch.clamp(n, min=1)
    b_max = torch.clamp(delta - (n_safe - 1) * b_min_d, min=b_min_d)[..., None]

    fp_min = -f_shannon_prime(as_f32(b_min, rho), beta)
    rho_mx = torch.where(mask, rho, zero).amax(-1, keepdim=True)
    lam_hi = rho_mx * fp_min * (1.0 + 1e-6) + 1e-30
    d = delta[..., None]

    def sum_b(lam):
        b = _b_of_lam(lam, rho, beta, b_min, b_max, inner_iters)
        return torch.where(mask, b, zero).sum(-1, keepdim=True), b

    lo, hi = torch.zeros_like(lam_hi), lam_hi
    for _ in range(outer_iters):
        mid = 0.5 * (lo + hi)
        s, _ = sum_b(mid)
        too_big = s > d
        lo = torch.where(too_big, mid, lo)
        hi = torch.where(too_big, hi, mid)
    lam = 0.5 * (lo + hi)
    _, b = sum_b(lam)
    b = torch.where(mask, b, zero)

    # Exact budget repair (see repro.core.bandwidth.solve_p4).
    s = b.sum(-1, keepdim=True)
    residual = d - s
    headroom = torch.where(mask, torch.clamp(b_max - b, min=0.0), zero)
    slack = torch.where(mask, torch.clamp(b - b_min, min=0.0), zero)
    pos_w = headroom / torch.clamp(headroom.sum(-1, keepdim=True), min=1e-30)
    neg_w = slack / torch.clamp(slack.sum(-1, keepdim=True), min=1e-30)
    b = torch.where(residual >= 0, b + residual * pos_w, b + residual * neg_w)
    b = torch.where(mask, torch.minimum(torch.clamp(b, min=b_min), b_max), zero)

    cost = torch.where(
        mask, rho * f_shannon(torch.clamp(b, min=b_min), beta), zero
    ).sum(-1)
    b = torch.where(has_any[..., None], b, zero)
    cost = torch.where(has_any, cost, zero)
    return b, cost


def p4_objective(
    rho: torch.Tensor,
    b: torch.Tensor,
    mask: torch.Tensor,
    v_eta: torch.Tensor,
    radio: RadioParams,
) -> torch.Tensor:
    """W*(S) contribution of S - S0:  sum_k (V*eta - rho_k N0 tau B f(b_k))."""
    v_eta = torch.as_tensor(v_eta, dtype=rho.dtype, device=rho.device)
    nd = rho.dim()
    per_client = v_eta[..., None] - rho * lead(radio.energy_scale, nd) * f_shannon(
        torch.clamp(b, min=lead(radio.b_min, nd)), lead(radio.beta, nd)
    )
    return torch.where(mask.to(torch.bool), per_client, 0.0).sum(-1)
