"""The paper's benchmark policies (§VI-A) and an offline oracle — port of
``repro.core.baselines``.

* ``select_all`` — every client every round; the P4 waterfiller splits the
  band to minimize total energy (budgets ignored).
* ``smo`` — Static Myopic Optimal: a hard per-round budget H_k / T.
* ``amo`` — Adaptive Myopic Optimal: per-round budget (H_k - spent) / (T - t).
* ``lookahead_dual`` — the offline R = T oracle by Lagrangian dual
  decomposition over the known channel: static multipliers mu_k in place
  of the queues, projected subgradient ascent on mu.

Every function works on a leading cell axis: ``h2_seq`` is (C, T, K),
``radio_seq`` a ``TracedRadio`` of (C, T) leaves (None: the static
``cfg.radio``) and ``failure_seq`` a ``TracedFailure`` with a (C, T, K)
mask.  ``amo_segment`` loops over rounds on (C, K) tensors; the others
take the whole (C, T, K) block at once.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.bandwidth import solve_p4
from repro_torch.core.energy import energy, min_bandwidth_for_energy
from repro_torch.core.ocean import OceanConfig, cumsum_sequential
from repro_torch.core.selection import ocean_p


class PolicyTrace(NamedTuple):
    """Per-cell decision traces of one policy: (C, T, K) and (C, T)."""

    a: torch.Tensor
    b: torch.Tensor
    e: torch.Tensor
    num_selected: torch.Tensor
    metrics: Optional[Dict[str, torch.Tensor]] = None
    # selected-and-delivered (C, T, K) mask with a failure process; else None
    delivered: Optional[torch.Tensor] = None
    # The queues each round's P3 saw (C, T, K): OCEAN policies only; not in
    # the reference's trace, kept so a run can be replayed round by round.
    q: Optional[torch.Tensor] = None


def _trace(a, b, e, delivered=None) -> PolicyTrace:
    return PolicyTrace(
        a=a, b=b, e=e, num_selected=a.sum(-1).to(torch.int32), delivered=delivered
    )


def _delivered_mask(a, failure_seq) -> Optional[torch.Tensor]:
    """Selected-and-delivered mask; baselines keep their selections and pay
    their energy, failures only gate which updates arrive."""
    if failure_seq is None:
        return None
    return a & (failure_seq.delivered.to(a.device) > 0.0)


def _radio(cfg: OceanConfig, radio_seq):
    return cfg.radio if radio_seq is None else radio_seq


# --------------------------------------------------------------------------
# Select-All
# --------------------------------------------------------------------------
def select_all(cfg: OceanConfig, h2_seq, radio_seq=None, failure_seq=None) -> PolicyTrace:
    """Select everyone; minimize total energy with ``cfg.solver``'s P4."""
    h2_seq = torch.as_tensor(h2_seq)
    radio = _radio(cfg, radio_seq)
    rho = 1.0 / torch.clamp(h2_seq, min=1e-30)
    a = torch.ones(h2_seq.shape, dtype=torch.bool, device=h2_seq.device)
    delta = torch.ones(h2_seq.shape[:-1], dtype=h2_seq.dtype, device=h2_seq.device)
    b, _ = solve_p4(rho, a, delta, radio, method=cfg.solver)
    return _trace(a, b, energy(b, h2_seq, radio, a), _delivered_mask(a, failure_seq))


# --------------------------------------------------------------------------
# SMO / AMO
# --------------------------------------------------------------------------
def _myopic_round(h2, budget, radio):
    """The greedy of §VI-A: cheapest-bandwidth clients first until the band
    is used up.  The stable ascending argsort of b_dag and the prefix sums
    (infeasible clients as 1e9, added left to right) decide the bits."""
    b_dag = min_bandwidth_for_energy(budget, h2, radio)   # inf where infeasible
    order = torch.argsort(b_dag, dim=-1, stable=True)
    b_sorted = torch.gather(b_dag, -1, order)
    finite = torch.isfinite(b_sorted)
    csum = cumsum_sequential(torch.where(finite, b_sorted, torch.full_like(b_sorted, 1e9)))
    take_sorted = (csum <= 1.0) & finite
    inv = torch.argsort(order, dim=-1, stable=True)
    a = torch.gather(take_sorted, -1, inv)
    return a, torch.where(a, b_dag, torch.zeros_like(b_dag))


def smo(cfg: OceanConfig, h2_seq, budgets=None, budget_seq=None, radio_seq=None,
        failure_seq=None) -> PolicyTrace:
    """Static Myopic Optimal: the hard cap is ``budget_seq`` (C, T, K) or
    H_k / T every round."""
    h2_seq = torch.as_tensor(h2_seq)
    if budget_seq is None:
        tot = cfg.budgets(device=h2_seq.device) if budgets is None else budgets
        per = torch.as_tensor(tot, dtype=torch.float32, device=h2_seq.device) / cfg.num_rounds
        if per.dim() == 2:  # (C, K) totals
            per = per[:, None, :]
        budget_seq = torch.broadcast_to(per, h2_seq.shape)
    radio = _radio(cfg, radio_seq)
    a, b = _myopic_round(h2_seq, torch.as_tensor(budget_seq, device=h2_seq.device), radio)
    return _trace(a, b, energy(b, h2_seq, radio, a), _delivered_mask(a, failure_seq))


def amo_segment(cfg: OceanConfig, spent, h2_seq, ts, budgets=None, radio_seq=None,
                failure_seq=None) -> Tuple[torch.Tensor, PolicyTrace]:
    """AMO over one block of rounds from a carried ``spent`` (C, K).

    ``ts`` holds the block's global round indices (the recycling rate
    depends on how many of the T rounds remain); ``amo`` is this from
    ``spent = 0`` over ``ts = 0..T-1``.
    """
    h2_seq = torch.as_tensor(h2_seq)
    dev = h2_seq.device
    C, n, K = h2_seq.shape
    budgets = cfg.budgets(device=dev) if budgets is None else torch.as_tensor(budgets, device=dev)
    budgets = torch.broadcast_to(budgets.to(torch.float32), (C, K))
    T = cfg.num_rounds
    outs = []
    for i, t in enumerate(int(x) for x in ts):
        radio = cfg.radio if radio_seq is None else radio_seq.at(i)
        remaining = torch.clamp(budgets - spent, min=0.0)
        # (T - t) as float32, a tensor divisor (a Python one may become a
        # multiplication by its reciprocal)
        per_round = remaining / torch.tensor(float(max(T - t, 1)), device=dev)
        a, b = _myopic_round(h2_seq[:, i], per_round, radio)
        e = energy(b, h2_seq[:, i], radio, a)
        spent = spent + e
        outs.append((a, b, e))
    a, b, e = (torch.stack([o[j] for o in outs], 1) for j in range(3))
    return spent, _trace(a, b, e, _delivered_mask(a, failure_seq))


def amo(cfg: OceanConfig, h2_seq, budgets=None, radio_seq=None, failure_seq=None) -> PolicyTrace:
    h2_seq = torch.as_tensor(h2_seq)
    C, _, K = h2_seq.shape
    spent = torch.zeros((C, K), dtype=torch.float32, device=h2_seq.device)
    _, trace = amo_segment(
        cfg, spent, h2_seq, range(cfg.num_rounds), budgets=budgets, radio_seq=radio_seq,
        failure_seq=failure_seq,
    )
    return trace


# --------------------------------------------------------------------------
# Offline T-round lookahead oracle via Lagrangian dual decomposition
# --------------------------------------------------------------------------
def lookahead_rounds(cfg: OceanConfig, h2_seq, eta_seq, mu, radio_seq=None):
    """Every round of every cell under static multipliers ``mu`` (C, K):
    one ``ocean_p`` over the C x T rows with V = 1.  Returns (a, b, e),
    each (C, T, K)."""
    C, T, K = h2_seq.shape
    rows = C * T
    if radio_seq is None:
        radio = cfg.radio
    else:
        radio = radio_seq.map(lambda x: torch.broadcast_to(x, (C, T)).reshape(rows))
    h2 = h2_seq.reshape(rows, K)
    q = torch.broadcast_to(mu[:, None, :], (C, T, K)).reshape(rows, K)
    eta = torch.broadcast_to(eta_seq, (C, T)).reshape(rows)
    sol = ocean_p(
        q, h2, 1.0, eta, radio, solver=cfg.solver, ranking=cfg.ranking,
        top_m=cfg.top_m, block_k=cfg.block_k,
    )
    e = energy(sol.b, h2, radio, sol.a)
    return tuple(x.reshape(C, T, K) for x in (sol.a, sol.b, e))


def dual_ascent(cfg: OceanConfig, h2_seq, eta_seq, num_iters: int = 400, lr: float = 50.0,
                budgets=None, radio_seq=None):
    """Projected subgradient ascent on mu: ``(mu (C, K), dual values
    (num_iters, C))``, one ``lookahead_rounds`` an iteration."""
    h2_seq = torch.as_tensor(h2_seq)
    dev = h2_seq.device
    C, T, K = h2_seq.shape
    eta_seq = torch.as_tensor(eta_seq, dtype=torch.float32, device=dev)
    budgets = cfg.budgets(device=dev) if budgets is None else torch.as_tensor(budgets, device=dev)
    budgets = torch.broadcast_to(budgets.to(torch.float32), (C, K))
    eta_ct = torch.broadcast_to(eta_seq, (C, T))
    mu = torch.zeros((C, K), dtype=torch.float32, device=dev)
    duals = []
    for _ in range(num_iters):
        a, _, e = lookahead_rounds(cfg, h2_seq, eta_seq, mu, radio_seq)
        viol = e.sum(1) - budgets                      # (C, K) subgradient
        util = (eta_ct * a.sum(-1).to(torch.float32)).sum(1)
        duals.append(util - (mu * viol).sum(1))
        mu = torch.clamp(mu + lr * viol, min=0.0)
    dual_vals = torch.stack(duals) if duals else torch.zeros((0, C), device=dev)
    return mu, dual_vals


def lookahead_dual(cfg: OceanConfig, h2_seq, eta_seq, num_iters: int = 400, lr: float = 50.0,
                   budgets=None, radio_seq=None) -> Tuple[PolicyTrace, torch.Tensor]:
    """The R = T lookahead oracle with full channel knowledge: the primal
    trace of the final multipliers and the last dual value (C,), an upper
    bound on the oracle's utility (the Theorem-2 checks)."""
    h2_seq = torch.as_tensor(h2_seq)
    mu, dual_vals = dual_ascent(cfg, h2_seq, eta_seq, num_iters, lr, budgets, radio_seq)
    eta_seq = torch.as_tensor(eta_seq, dtype=torch.float32, device=h2_seq.device)
    a, b, e = lookahead_rounds(cfg, h2_seq, eta_seq, mu, radio_seq)
    return _trace(a, b, e), dual_vals[-1]


def utility(trace: PolicyTrace, eta_seq) -> torch.Tensor:
    """sum_t eta^t |S^t| per cell — the paper's long-term objective (Eq. 4)."""
    eta = torch.as_tensor(eta_seq, dtype=torch.float32, device=trace.num_selected.device)
    return (eta * trace.num_selected.to(torch.float32)).sum(-1)


def delivered_utility(trace: PolicyTrace, eta_seq) -> torch.Tensor:
    """sum_t eta^t |delivered S^t| per cell; ``utility`` without failures."""
    if trace.delivered is None:
        return utility(trace, eta_seq)
    eta = torch.as_tensor(eta_seq, dtype=torch.float32, device=trace.delivered.device)
    return (eta * trace.delivered.to(torch.float32).sum(-1)).sum(-1)
