"""OCEAN-P — optimal solver of the per-round problem P3 (paper §V-B, Alg. 2).

Port of ``repro.core.selection``.  Theorem 1: the optimal selection is a
prefix of the clients sorted by rho_k = q_k / h_k^2 (ascending), so only
the K+1 prefixes matter; the registry backend (``repro_torch.core.solvers``)
evaluates them and returns the winner.  Clients with rho_k == 0 form S0:
always selected at b_min, the rest of the budget goes to the prefix.

Every function takes a leading cell axis: q, h2 are (C, K); v, eta are
scalars or (C,); the radio is a ``RadioParams`` or one round of per-cell
leaves, (C,) each.  Sorting is stable (``stable=True`` everywhere), so ties
break by client index exactly as ``jnp.argsort`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.core.energy import SAFE_DIV_FLOOR, RadioParams, f_shannon, lead
from repro_torch.core.solvers import SolverBackend, get_solver

_RHO_ZERO_TOL = 1e-30

RANKINGS = ("sort", "topm")
DEFAULT_RANKING = "sort"
DEFAULT_TOP_M = 128
DEFAULT_BLOCK_K = 128

# Priority sentinel for clients demoted by an ``admit`` mask: huge but
# finite, so demoted clients sort last and poison any prefix holding them.
RHO_DEMOTED = 1e30


def check_ranking(name: str) -> str:
    """Fail fast on unknown ranking names."""
    if name not in RANKINGS:
        raise ValueError(
            f"unknown ranking {name!r}; available: {', '.join(RANKINGS)} "
            f"(``sort`` is the stable-argsort default, ``topm`` the "
            f"sort-free iterative extraction — see repro_torch.core.selection)"
        )
    return name


class OceanPSolution(NamedTuple):
    a: torch.Tensor             # (C, K) bool — selection decisions
    b: torch.Tensor             # (C, K) bandwidth ratios
    objective: torch.Tensor     # (C,) optimal P3 value W*(S*)
    rho: torch.Tensor           # (C, K) priorities
    num_selected: torch.Tensor  # (C,) int32


def priorities(q: torch.Tensor, h2: torch.Tensor) -> torch.Tensor:
    """rho_k = q_k / h_k^2 — lower is higher selection priority."""
    return q / torch.clamp(h2, min=SAFE_DIV_FLOOR)


def topm_extract(rho: torch.Tensor, top_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank the ``top_m`` smallest *positive* priorities without sorting.

    ``top_m`` rounds of (min, first argmin, mask to +inf); S0 members
    (rho <= 1e-30) are excluded; exhausted slots hold +inf / index 0.
    Returns ``(vals, idx)`` of shape (C, top_m), ``idx`` int32.
    """
    from repro_torch.kernels.ocean_p import extract_min_plain

    work = torch.where(rho > _RHO_ZERO_TOL, rho, torch.inf)
    vals, idx = extract_min_plain(work, top_m)
    return vals, idx.to(torch.int32)


def _promote_real(x) -> torch.Tensor:
    x = torch.as_tensor(x)
    if not torch.is_floating_point(x):
        x = x.to(torch.float32)
    return x


def _cell_scalar(x, C, dtype, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device).expand(C)


def ocean_p(
    q: torch.Tensor,
    h2: torch.Tensor,
    v,
    eta,
    radio: RadioParams,
    outer_iters: int = 42,
    inner_iters: int = 42,
    solver: Union[str, SolverBackend, None] = None,
    ranking: Optional[str] = None,
    top_m: Optional[int] = None,
    block_k: Optional[int] = None,
    admit: Optional[torch.Tensor] = None,
) -> OceanPSolution:
    """Solve P3 exactly for every cell; q, h2 are (C, K).

    ``solver``: ``bisect`` (default), ``newton``, ``pallas`` (K1) or
    ``pallas_tiled`` (K2, needs ``ranking="topm"``).  ``ranking``:
    ``sort`` (stable argsort) or ``topm`` (extraction of the ``top_m``
    best, exact whenever m* <= top_m).  ``admit`` (C, K) bool demotes
    clients to rho = ``RHO_DEMOTED``.
    """
    q = _promote_real(q)
    h2 = _promote_real(h2).to(q.device)
    dtype = torch.promote_types(torch.promote_types(q.dtype, h2.dtype), torch.float32)
    q = q.to(dtype)
    h2 = h2.to(dtype)
    C, K = q.shape
    v_eta = (
        _cell_scalar(v, C, dtype, q.device) * _cell_scalar(eta, C, dtype, q.device)
    ).to(dtype)

    ranking = check_ranking(DEFAULT_RANKING if ranking is None else ranking)
    backend = get_solver(solver)
    rho = priorities(q, h2)
    if admit is not None:
        rho = torch.where(admit.to(torch.bool), rho, RHO_DEMOTED)

    if ranking == "topm":
        return _ocean_p_topm(
            rho, v_eta, radio, backend, outer_iters, inner_iters,
            DEFAULT_TOP_M if top_m is None else top_m,
            DEFAULT_BLOCK_K if block_k is None else block_k,
        )
    if backend.topm is not None:
        raise ValueError(
            f"solver {backend.name!r} is sort-free and has no argsort "
            f"path; call ocean_p(..., ranking='topm') (or set the "
            f"ranking config field)"
        )

    order, rho_sorted, n0, delta = prefix_inputs(rho, radio)
    in_s0 = rho_sorted <= _RHO_ZERO_TOL
    sol = backend.prefixes(
        rho_sorted, n0, delta, v_eta, radio, outer_iters, inner_iters
    )
    m_star = sol.m_star
    leftover = torch.where(m_star == 0, delta, torch.zeros_like(delta))
    b0_each = radio.b_min + leftover / torch.clamp(n0.to(dtype), min=1.0)
    b_sorted_full = torch.where(in_s0, b0_each[:, None], sol.b_pos_sorted)
    a_sorted = in_s0 | sol.sel_pos_sorted

    inv = torch.argsort(order, dim=1, stable=True)
    a = torch.gather(a_sorted, 1, inv)
    b = torch.gather(
        torch.where(a_sorted, b_sorted_full, torch.zeros((), dtype=dtype, device=q.device)),
        1,
        inv,
    )
    return OceanPSolution(
        a=a,
        b=b,
        objective=sol.w_star,
        rho=rho,
        num_selected=a.sum(1).to(torch.int32),
    )


def prefix_inputs(rho: torch.Tensor, radio: RadioParams):
    """The sort path's ranking: ``(order, rho_sorted, n0, delta)`` per cell.

    ``order`` is the stable ascending argsort of rho, ``n0`` (int64) the
    S0 count and ``delta = 1 - n0 * b_min`` the budget left for the prefix.
    """
    order = torch.argsort(rho, dim=1, stable=True)
    rho_sorted = torch.gather(rho, 1, order)
    n0 = (rho_sorted <= _RHO_ZERO_TOL).sum(1)
    delta = 1.0 - n0.to(rho.dtype) * radio.b_min
    return order, rho_sorted, n0, delta


def _ocean_p_topm(
    rho: torch.Tensor,
    v_eta: torch.Tensor,
    radio: RadioParams,
    backend: SolverBackend,
    outer_iters: int,
    inner_iters: int,
    top_m: int,
    block_k: int,
) -> OceanPSolution:
    """The sort-free P3 path: rank only the best ``top_m`` clients."""
    dtype = rho.dtype
    dev = rho.device
    C, K = rho.shape
    if top_m < 1:
        raise ValueError(f"top_m={top_m} must be >= 1")
    if block_k < 1:
        raise ValueError(f"block_k={block_k} must be >= 1")
    m_cands = int(min(top_m, K))
    zero = torch.zeros((), dtype=dtype, device=dev)

    in_s0 = rho <= _RHO_ZERO_TOL
    n0 = in_s0.sum(1)
    delta = 1.0 - n0.to(dtype) * radio.b_min

    if backend.topm is not None:
        m_star, w_star, b_pos, sel_pos = backend.topm(
            rho, n0, delta, v_eta, radio, top_m=m_cands, block_k=block_k
        )
    else:
        vals, idx = topm_extract(rho, m_cands)
        # Extracted values land at their exact sorted offsets [n0, n0 + m).
        buf = torch.full((C, K + m_cands), torch.inf, dtype=dtype, device=dev)
        slots = n0[:, None] + torch.arange(m_cands, device=dev)[None, :]
        buf.scatter_(1, slots, vals)
        rho_rank = buf[:, :K].contiguous()
        rho_hi = rho.amax(1)
        sol = backend.prefixes(
            rho_rank, n0, delta, v_eta, radio, outer_iters, inner_iters,
            m_cands=m_cands, rho_hi=rho_hi,
        )
        m_star = sol.m_star
        w_star = sol.w_star
        bpad = torch.cat(
            [sol.b_pos_sorted, torch.zeros((C, m_cands), dtype=dtype, device=dev)], 1
        )
        b_cand = torch.gather(bpad, 1, slots)
        sel_j = torch.arange(m_cands, device=dev)[None, :] < m_star[:, None]
        idx64 = idx.long()
        b_pos = torch.zeros((C, K), dtype=dtype, device=dev).scatter_add_(
            1, idx64, torch.where(sel_j, b_cand, zero)
        )
        sel_pos = (
            torch.zeros((C, K), dtype=torch.int32, device=dev)
            .scatter_reduce_(1, idx64, sel_j.to(torch.int32), reduce="amax")
            .to(torch.bool)
        )

    leftover = torch.where(m_star == 0, delta, torch.zeros_like(delta))
    b0_each = radio.b_min + leftover / torch.clamp(n0.to(dtype), min=1.0)
    a = in_s0 | sel_pos
    b = torch.where(in_s0, b0_each[:, None], torch.where(sel_pos, b_pos, zero))
    return OceanPSolution(
        a=a,
        b=b,
        objective=w_star,
        rho=rho,
        num_selected=a.sum(1).to(torch.int32),
    )


def p3_value(a, b, q, h2, v, eta, radio: RadioParams) -> torch.Tensor:
    """Evaluate the P3 objective for arbitrary (a, b) per cell — tests/oracles."""
    rho = priorities(q, h2)
    C = q.shape[0]
    util = (
        _cell_scalar(v, C, q.dtype, q.device)
        * _cell_scalar(eta, C, q.dtype, q.device)
        * a.to(q.dtype).sum(1)
    )
    en = lead(radio.energy_scale, 1) * torch.where(
        a > 0, rho * f_shannon(torch.clamp(b, min=lead(radio.b_min, 2)), lead(radio.beta, 2)),
        torch.zeros((), dtype=q.dtype, device=q.device),
    ).sum(1)
    return util - en
