"""Pluggable P4 / OCEAN-P solver backends — port of ``repro.core.solvers``.

``bisect``
    The double-bisection oracle: every one of the K+1 prefix candidates
    runs ``bandwidth.solve_p4`` (42 x 42 steps) on a (C, K+1, K) lattice.
``newton``
    Safeguarded Newton waterfilling with shared log-grid seeding and the
    (outer, inner, grid) budget table of ``newton_iteration_budgets``.
``pallas``
    The fused prefix sweep (``repro_torch.kernels.ocean_p``, kernel K1):
    12 outer x 9 inner Newton steps per candidate, seeded at the
    geometric-mean KKT level, candidates swept in order keeping only the
    running argmax.  It ignores the bisect budgets and the log grid, so it
    is *not* ``newton``.  On CUDA tensors it launches the Hopper kernel;
    on CPU tensors it runs the kernel's plain PyTorch version.
``pallas_tiled``
    The sort-free top-m kernel (K2): extraction, compact sweep and scatter
    in one launch on client-order rho.  Runs only under ``ranking="topm"``.

Every array carries a leading cell axis ``C``; the client axis is last.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.energy import (
    LN2,
    as_f32,
    f_shannon,
    f_shannon_prime,
    f_shannon_prime_second,
    f_shannon_second,
    lead,
)
from repro_torch.obs.spans import trace_span

DEFAULT_SOLVER = "bisect"

NEWTON_OUTER_ITERS = 7
NEWTON_INNER_ITERS = 9
NEWTON_GRID_LEVELS = 9
NEWTON_OUTER_ITERS_X64 = 12
NEWTON_INNER_ITERS_X64 = 14
NEWTON_GRID_LEVELS_X64 = 13

# (bucket max K, float32 (outer, inner, grid), float64 (outer, inner, grid))
_NEWTON_BUDGET_TABLE = (
    (
        128,
        (NEWTON_OUTER_ITERS, NEWTON_INNER_ITERS, NEWTON_GRID_LEVELS),
        (NEWTON_OUTER_ITERS_X64, NEWTON_INNER_ITERS_X64, NEWTON_GRID_LEVELS_X64),
    ),
    (4096, (8, 10, 11), (13, 15, 15)),
    (None, (9, 11, 13), (14, 16, 17)),
)


def newton_iteration_budgets(dtype, k: Optional[int] = None) -> Tuple[int, int, int]:
    """(outer, inner, grid) Newton budgets for the float dtype and K."""
    wide = torch.empty((), dtype=dtype).element_size() >= 8
    for k_max, budget_f32, budget_f64 in _NEWTON_BUDGET_TABLE:
        if k is None or k_max is None or k <= k_max:
            return budget_f64 if wide else budget_f32
    raise AssertionError("unreachable: the last budget bucket is open-ended")


class PrefixSolution(NamedTuple):
    """The winning candidate of the K+1 prefix evaluation (sorted order)."""

    m_star: torch.Tensor          # (C,) int32 — number of positive-rho clients
    w_star: torch.Tensor          # (C,)      — optimal P3 value W*(S*)
    b_pos_sorted: torch.Tensor    # (C, K) allocation of the winning prefix
    sel_pos_sorted: torch.Tensor  # (C, K) bool — winning prefix membership


PrefixFn = Callable[..., PrefixSolution]
WaterfillFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]
TopmFn = Callable[..., Tuple[torch.Tensor, ...]]


class SolverBackend(NamedTuple):
    name: str
    prefixes: PrefixFn
    waterfill: Optional[WaterfillFn]
    topm: Optional[TopmFn] = None
    # A chaos backend (``repro_torch.guard.chaos``): (the base backend's
    # name, the corruption kind, its scale), which kernel K3 reads to apply
    # the same corruption in the fused round; None for every other backend.
    chaos: Optional[Tuple[str, str, float]] = None


_REGISTRY: Dict[str, SolverBackend] = {}


def register_solver(
    name: str,
    prefixes: PrefixFn,
    waterfill: Optional[WaterfillFn] = None,
    topm: Optional[TopmFn] = None,
    chaos: Optional[Tuple[str, str, float]] = None,
) -> SolverBackend:
    """Add a solver backend to the registry (overwrites an existing name)."""
    backend = SolverBackend(name, prefixes, waterfill, topm, chaos)
    _REGISTRY[name] = backend
    return backend


def available_solvers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_solver(name: Union[str, SolverBackend, None]) -> SolverBackend:
    """Look up a backend by name; ``None`` resolves to the default."""
    if name is None:
        name = DEFAULT_SOLVER
    if isinstance(name, SolverBackend):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise ValueError(
        f"unknown solver backend {name!r}; available: "
        f"{', '.join(available_solvers())} (see repro_torch.core.solvers)"
    )


def sweep_cands(n0, K: int, m_cands: Optional[int] = None) -> int:
    """The candidates a plain prefix sweep evaluates: m <= m_cands (every
    m <= K under sort, m_cands None) clipped to one past the cells' largest
    K - n0.  A candidate past K - n0 is infeasible (W = -inf, or K1's
    NEG_INF), so every cell keeps one of them and its first maximum, and
    with it every output, is the one over the whole axis; the sweep's
    (C, M, K) tensors shrink to the positive clients a round has."""
    m = K if m_cands is None else m_cands
    if n0.numel() == 0:
        return m
    return min(m, int((K - n0.long()).max()) + 1)


def _candidate_axis(n0, m_cands, K, device):
    """(M,) candidate counts (``sweep_cands``') and the (C, M, K) prefix
    masks in sorted order."""
    ms = torch.arange(sweep_cands(n0, K, m_cands) + 1, device=device)
    ranks = torch.arange(K, device=device)
    n0 = n0.long()[:, None, None]
    mask = (ranks >= n0) & (ranks < n0 + ms[None, :, None])
    return ms, mask


def _pick_best(w, ms, b_all, mask):
    """First argmax over the candidate axis (ties keep the smaller m)."""
    best = torch.argmax(w, dim=1)
    rows = torch.arange(w.shape[0], device=w.device)
    return PrefixSolution(
        m_star=ms[best].to(torch.int32),
        w_star=w[rows, best],
        b_pos_sorted=b_all[rows, best],
        sel_pos_sorted=mask[rows, best],
    )


# --------------------------------------------------------------------------
# bisect — the reference backend
# --------------------------------------------------------------------------
def _prefix_bisect(
    rho_sorted: torch.Tensor,
    n0: torch.Tensor,
    delta: torch.Tensor,
    v_eta: torch.Tensor,
    radio,
    outer_iters: int,
    inner_iters: int,
    *,
    m_cands: Optional[int] = None,
    rho_hi: Optional[torch.Tensor] = None,
) -> PrefixSolution:
    """All K+1 prefixes via the double-bisection ``solve_p4`` on a lattice."""
    del rho_hi
    from repro_torch.core.bandwidth import solve_p4

    C, K = rho_sorted.shape
    ms, mask = _candidate_axis(n0, m_cands, K, rho_sorted.device)
    feasible = ms[None, :] <= (K - n0.long())[:, None]
    with trace_span("p4/bisect/candidate_sweep"):
        b_all, cost = solve_p4(
            rho_sorted[:, None, :], mask, delta[:, None].expand(C, len(ms)),
            radio, outer_iters, inner_iters,
        )
    w = v_eta[:, None] * (n0.long()[:, None] + ms[None, :]).to(rho_sorted.dtype)
    w = w - lead(radio.energy_scale, 2) * cost
    w = torch.where(feasible, w, -torch.inf)
    return _pick_best(w, ms, b_all, mask)


# --------------------------------------------------------------------------
# newton — safeguarded Newton waterfilling
# --------------------------------------------------------------------------
def b_of_lam_newton(
    lam: torch.Tensor,
    rho: torch.Tensor,
    beta,
    b_min,
    b_max,
    iters: Optional[int] = None,
) -> torch.Tensor:
    """Solve ``rho * f'(b) = -lam`` elementwise, clamped to [b_min, b_max].

    Any broadcastable shapes; ``beta``/``b_min``/``b_max`` may be Python
    floats or tensors.  Bracketed, closed-form-seeded Newton whose
    boundary roots are detected analytically.
    """
    if iters is None:
        k = rho.shape[-1] if rho.dim() else None
        iters = newton_iteration_budgets(torch.result_type(lam, rho), k)[1]
    rho_safe = torch.clamp(rho, min=1e-30)
    t = -lam / rho_safe
    u = lam / rho_safe
    b_max = as_f32(b_max, t) if not isinstance(b_max, torch.Tensor) else b_max
    b_min_t = as_f32(b_min, t) if not isinstance(b_min, torch.Tensor) else b_min
    shape = torch.broadcast_shapes(t.shape, b_max.shape, b_min_t.shape)
    c = LN2

    # a tensor divisor: a Python-float one makes CUDA multiply by 1/c
    y_small = torch.div(torch.sqrt(2.0 * u), as_f32(c, u))
    y_log = torch.log2(1.0 + u)
    y_big = torch.log2(
        torch.clamp(u - 1.0, min=1e-12) / torch.clamp(c * y_log - 1.0, min=1e-12)
    )
    y0 = torch.clamp(torch.where(u > 2.0, y_big, y_small), min=1e-12)
    beta_t = as_f32(beta, t) if not isinstance(beta, torch.Tensor) else beta
    b = torch.minimum(torch.maximum(beta_t / y0, b_min_t), b_max)
    b = torch.broadcast_to(b, shape)

    lo = torch.broadcast_to(b_min_t, shape)
    hi = torch.broadcast_to(b_max, shape)
    at_min = f_shannon_prime(lo, beta) >= t
    at_max = f_shannon_prime(hi, beta) <= t

    for _ in range(iters):
        fp, fpp = f_shannon_prime_second(b, beta)
        g = fp - t
        below = g < 0
        lo = torch.where(below, b, lo)
        hi = torch.where(below, hi, b)
        bn = b - g / torch.clamp(fpp, min=1e-30)
        ok = (bn >= lo) & (bn <= hi) & torch.isfinite(bn)
        b = torch.where(ok, bn, 0.5 * (lo + hi))
    b = torch.minimum(torch.maximum(b, b_min_t), b_max)
    b = torch.where(at_min, torch.broadcast_to(b_min_t, shape), b)
    b = torch.where(at_max, torch.broadcast_to(b_max, shape), b)
    return b


def _geo_mid(lo, hi):
    """Log-space bisection fallback for rejected outer-Newton steps."""
    return torch.sqrt(torch.maximum(lo, 1e-6 * hi) * torch.clamp(hi, min=1e-30))


def _budget_repair(b, mask, delta, b_min, b_max):
    """Distribute the residual over the headroom so sum(b) == delta exactly."""
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    s = b.sum(-1, keepdim=True)
    residual = delta - s
    headroom = torch.where(mask, torch.clamp(b_max - b, min=0.0), zero)
    slack = torch.where(mask, torch.clamp(b - b_min, min=0.0), zero)
    pos_w = headroom / torch.clamp(headroom.sum(-1, keepdim=True), min=1e-30)
    neg_w = slack / torch.clamp(slack.sum(-1, keepdim=True), min=1e-30)
    b = torch.where(residual >= 0, b + residual * pos_w, b + residual * neg_w)
    b_min_t = as_f32(b_min, b) if not isinstance(b_min, torch.Tensor) else b_min
    return torch.where(mask, torch.minimum(torch.maximum(b, b_min_t), b_max), zero)


def _outer_newton_polish(
    lam0, lo0, hi0, rho, mask, delta, beta, b_min, b_max,
    outer_iters: int, inner_iters: int,
) -> torch.Tensor:
    """Safeguarded Newton on the budget residual; returns the final b.

    ``lam0``/``lo0``/``hi0``/``b_max``/``delta`` carry the leading axes of
    ``rho``/``mask`` (the client axis dropped).
    """
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    lam, lo, hi = lam0, lo0, hi0
    bm = b_max[..., None]
    for _ in range(outer_iters):
        b = b_of_lam_newton(lam[..., None], rho, beta, b_min, bm, inner_iters)
        r = torch.where(mask, b, zero).sum(-1) - delta
        too_big = r > 0
        lo = torch.where(too_big, lam, lo)
        hi = torch.where(too_big, hi, lam)
        interior = mask & (b > b_min) & (b < bm)
        dbdlam = -1.0 / (
            torch.clamp(rho, min=1e-30)
            * torch.clamp(f_shannon_second(b, beta), min=1e-30)
        )
        drdlam = torch.where(interior, dbdlam, zero).sum(-1)
        lam_n = lam - r / torch.clamp(drdlam, max=-1e-30)
        ok = (lam_n >= lo) & (lam_n <= hi) & torch.isfinite(lam_n)
        lam = torch.where(ok, lam_n, _geo_mid(lo, hi))
    return b_of_lam_newton(lam[..., None], rho, beta, b_min, bm, inner_iters)


def _log_grid(lam_lo, lam_hi, levels, like):
    frac = torch.linspace(0.0, 1.0, levels, dtype=like.dtype, device=like.device)
    return torch.exp(
        torch.log(lam_lo)[..., None] * (1.0 - frac)
        + torch.log(torch.clamp(lam_hi, min=1e-30))[..., None] * frac
    )


def waterfill_newton(
    rho: torch.Tensor,
    mask: torch.Tensor,
    delta: torch.Tensor,
    radio,
    outer_iters: Optional[int] = None,
    inner_iters: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Newton drop-in for ``solve_p4`` on one mask per cell: (C, K) inputs."""
    d_outer, d_inner, d_grid = newton_iteration_budgets(rho.dtype, rho.shape[-1])
    outer_iters = d_outer if outer_iters is None else outer_iters
    inner_iters = d_inner if inner_iters is None else inner_iters
    mask = mask.to(torch.bool)
    delta = torch.as_tensor(delta, dtype=rho.dtype, device=rho.device)
    zero = torch.zeros((), dtype=rho.dtype, device=rho.device)
    # radio leaves against the cell axes (d), the clients (d + 1) and the
    # grid levels x clients (d + 2)
    d = rho.dim() - 1
    beta_d, b_min_d = lead(radio.beta, d), lead(radio.b_min, d)
    beta, b_min = lead(radio.beta, d + 1), lead(radio.b_min, d + 1)

    n = mask.sum(-1)
    has_any = n > 0
    n_safe = torch.clamp(n, min=1)
    b_max = torch.clamp(delta - (n_safe - 1) * b_min_d, min=b_min_d)

    fp_min = -f_shannon_prime(as_f32(b_min_d, rho), beta_d)
    lam_hi = torch.where(mask, rho, zero).amax(-1) * fp_min * (1.0 + 1e-6) + 1e-30

    rho_pos = torch.where(mask & (rho > 0), rho, torch.inf)
    rho_min = rho_pos.amin(-1)
    lam_lo_g = torch.where(
        torch.isfinite(rho_min),
        rho_min * torch.clamp(-f_shannon_prime(b_max, beta_d), min=1e-30) * 0.5,
        torch.full_like(rho_min, 1e-30),
    )
    lam_lo_g = torch.minimum(torch.clamp(lam_lo_g, min=1e-30), lam_hi)
    lam_grid = _log_grid(lam_lo_g, lam_hi, d_grid, rho)           # (..., G)
    bg = b_of_lam_newton(
        lam_grid[..., None], rho[..., None, :], lead(radio.beta, d + 2),
        lead(radio.b_min, d + 2), b_max[..., None, None],
    )
    rg = torch.where(mask[..., None, :], bg, zero).sum(-1) - delta[..., None]
    hi_seed = torch.where(rg <= 0, lam_grid, torch.inf).amin(-1)
    hi0 = torch.minimum(
        torch.where(torch.isfinite(hi_seed), hi_seed, lam_hi), lam_hi
    )
    lo0 = torch.where(rg > 0, lam_grid, zero).amax(-1)
    lam0 = torch.minimum(
        torch.clamp(
            torch.sqrt(torch.clamp(lo0, min=1e-30) * torch.clamp(hi0, min=1e-30)),
            min=0.0,
        ),
        hi0,
    )
    b = _outer_newton_polish(
        lam0, lo0, hi0, rho, mask, delta, beta, b_min, b_max,
        outer_iters, inner_iters,
    )
    b = torch.where(mask, b, zero)
    b = _budget_repair(b, mask, delta[..., None], b_min, b_max[..., None])
    cost = torch.where(
        mask, rho * f_shannon(torch.clamp(b, min=b_min), beta), zero
    ).sum(-1)
    b = torch.where(has_any[..., None], b, zero)
    cost = torch.where(has_any, cost, zero)
    return b, cost


def _prefix_newton(
    rho_sorted: torch.Tensor,
    n0: torch.Tensor,
    delta: torch.Tensor,
    v_eta: torch.Tensor,
    radio,
    outer_iters: int = 0,
    inner_iters: int = 0,
    *,
    m_cands: Optional[int] = None,
    rho_hi: Optional[torch.Tensor] = None,
) -> PrefixSolution:
    """All K+1 prefixes at once: shared-grid seeding + vectorized Newton.

    The bisect budgets are ignored; Newton's own table applies.
    """
    del outer_iters, inner_iters
    dtype = rho_sorted.dtype
    dev = rho_sorted.device
    C, K = rho_sorted.shape
    n_outer, n_inner, n_grid = newton_iteration_budgets(dtype, K)
    # radio leaves against (C,), (C, M) and (C, M|G, K) operands
    beta1, b_min1 = lead(radio.beta, 1), lead(radio.b_min, 1)
    beta2, b_min2 = lead(radio.beta, 2), lead(radio.b_min, 2)
    beta, b_min = lead(radio.beta, 3), lead(radio.b_min, 3)
    zero = torch.zeros((), dtype=dtype, device=dev)
    n0l = n0.long()

    ms, mask = _candidate_axis(n0, m_cands, K, dev)              # (M,), (C,M,K)
    mf = ms.to(dtype)
    ranks = torch.arange(K, device=dev)
    pos = ranks[None, :] >= n0l[:, None]                         # (C, K)
    feasible = ms[None, :] <= (K - n0l)[:, None]
    b_max = torch.clamp(
        delta[:, None] - (torch.clamp(ms, min=1) - 1).to(dtype) * b_min2, min=b_min2
    )                                                            # (C, M)

    fp_min = -f_shannon_prime(as_f32(b_min1, rho_sorted), beta1)  # (C,) or ()
    fp_min2 = lead(fp_min, 2)
    last = torch.clamp(n0l[:, None] + ms[None, :] - 1, 0, K - 1)
    rho_last = torch.where(
        ms[None, :] >= 1, torch.gather(rho_sorted, 1, last), zero
    )
    lam_hi = rho_last * fp_min2 * (1.0 + 1e-6) + 1e-30           # (C, M)

    if rho_hi is None:
        lam_hi_glob = lam_hi.amax(1)
    else:
        lam_hi_glob = rho_hi * fp_min * (1.0 + 1e-6) + 1e-30
    rho_pos = torch.where(pos & (rho_sorted > 0), rho_sorted, torch.inf)
    rho_min_pos = rho_pos.amin(1)
    b_cap_glob = torch.clamp(delta, min=b_min1)
    lam_lo_glob = torch.where(
        torch.isfinite(rho_min_pos),
        rho_min_pos
        * torch.clamp(-f_shannon_prime(b_cap_glob, beta1), min=1e-30) * 0.5,
        torch.full_like(rho_min_pos, 1e-30),
    )
    lam_lo_glob = torch.minimum(torch.clamp(lam_lo_glob, min=1e-30), lam_hi_glob)
    lam_grid = _log_grid(lam_lo_glob, lam_hi_glob, n_grid, rho_sorted)  # (C, G)
    with trace_span("p4/newton/grid_seed"):
        bg = b_of_lam_newton(
            lam_grid[:, :, None], rho_sorted[:, None, :], beta, b_min,
            b_cap_glob[:, None, None],
        )                                                        # (C, G, K)
    csum = torch.cumsum(torch.where(pos[:, None, :], bg, zero), dim=2)
    csum0 = torch.cat([torch.zeros_like(csum[..., :1]), csum], dim=2)  # (C,G,K+1)
    G = lam_grid.shape[1]
    hi_idx = torch.clamp(n0l[:, None] + ms[None, :], 0, K)       # (C, M)
    lo_idx = torch.clamp(n0l, 0, K)[:, None]                     # (C, 1)
    prefix_sums = torch.gather(
        csum0, 2, hi_idx[:, None, :].expand(C, G, -1)
    ) - torch.gather(csum0, 2, lo_idx[:, None, :].expand(C, G, 1))   # (C, G, M)
    r_grid = prefix_sums - delta[:, None, None]
    nonpos = r_grid <= 0
    hi_seed = torch.where(nonpos, lam_grid[:, :, None], torch.inf).amin(1)
    hi0 = torch.minimum(
        torch.where(torch.isfinite(hi_seed), hi_seed, lam_hi), lam_hi
    )
    lo_seed = torch.where(~nonpos, lam_grid[:, :, None], zero).amax(1)
    lam0 = torch.minimum(
        torch.clamp(
            torch.sqrt(
                torch.clamp(lo_seed, min=1e-30) * torch.clamp(hi0, min=1e-30)
            ),
            min=0.0,
        ),
        hi0,
    )

    rho_b = rho_sorted[:, None, :]
    with trace_span("p4/newton/polish"):
        b = _outer_newton_polish(
            lam0, torch.zeros_like(lam0), hi0, rho_b, mask, delta[:, None], beta,
            b_min, b_max, n_outer, n_inner,
        )
    b = torch.where(mask, b, zero)
    b = _budget_repair(b, mask, delta[:, None, None], b_min, b_max[..., None])
    cost = torch.where(
        mask, rho_b * f_shannon(torch.clamp(b, min=b_min), beta), zero
    ).sum(-1)
    has_any = ms > 0
    b = torch.where(has_any[None, :, None], b, zero)
    cost = torch.where(has_any[None, :], cost, zero)

    w = v_eta[:, None] * (n0l.to(dtype)[:, None] + mf[None, :])
    w = w - lead(radio.energy_scale, 2) * cost
    w = torch.where(feasible, w, -torch.inf)
    return _pick_best(w, ms, b, mask)


# --------------------------------------------------------------------------
# pallas — fused prefix sweep (kernel K1, repro_torch.kernels.ocean_p)
# --------------------------------------------------------------------------
def _prefix_pallas(
    rho_sorted, n0, delta, v_eta, radio, outer_iters=0, inner_iters=0,
    *, m_cands=None, rho_hi=None,
) -> PrefixSolution:
    del outer_iters, inner_iters, rho_hi
    from repro_torch.kernels.ocean_p import ocean_p_prefixes_fused

    return ocean_p_prefixes_fused(
        rho_sorted, n0, delta, v_eta, radio, n_cands=m_cands
    )


def _prefix_pallas_plain(
    rho_sorted, n0, delta, v_eta, radio, outer_iters=0, inner_iters=0,
    *, m_cands=None, rho_hi=None,
) -> PrefixSolution:
    del outer_iters, inner_iters, rho_hi
    from repro_torch.kernels.ocean_p import ocean_p_prefixes_fused

    return ocean_p_prefixes_fused(
        rho_sorted, n0, delta, v_eta, radio, n_cands=m_cands, plain=True
    )


def _prefix_pallas_tiled(*args, **kwargs) -> PrefixSolution:
    raise ValueError(
        "solver 'pallas_tiled' is sort-free: it fuses top-m extraction, "
        "the candidate solve and the client-order scatter in one kernel "
        "and never sees a rho-sorted array; run it with ranking='topm' "
        "(OceanConfig/Scenario ranking field or ocean_p(ranking=...))"
    )


def _topm_pallas_tiled(rho, n0, delta, v_eta, radio, *, top_m, block_k, plain=False):
    from repro_torch.kernels.ocean_p import ocean_p_topm_fused

    return ocean_p_topm_fused(
        rho, n0, delta, v_eta, radio, top_m=top_m, block_k=block_k, plain=plain
    )


register_solver("bisect", _prefix_bisect, waterfill=None)
register_solver("newton", _prefix_newton, waterfill=waterfill_newton)
register_solver("pallas", _prefix_pallas, waterfill=waterfill_newton)
register_solver(
    "pallas_tiled",
    _prefix_pallas_tiled,
    waterfill=waterfill_newton,
    topm=_topm_pallas_tiled,
)

# The K1 sweep's and K2's plain PyTorch versions on any device, as backend
# objects (not registered): the plain whole-trajectory path and the chip
# checks hand them to ``ocean_round`` through ``OceanConfig.solver``.
PALLAS_PLAIN = SolverBackend("pallas_plain", _prefix_pallas_plain, waterfill_newton)
PALLAS_TILED_PLAIN = SolverBackend(
    "pallas_tiled_plain", _prefix_pallas_tiled, waterfill_newton,
    functools.partial(_topm_pallas_tiled, plain=True),
)
