"""Fault injection for the guarded OCEAN layer — port of ``repro.guard.chaos``.

* ``inject_h2_faults`` corrupts a concrete (T, K) gain sequence with an
  exact number of faults of each kind at distinct positions: ``nan``,
  ``inf``, ``zero`` and ``negative`` draws are for the quarantine,
  ``subnormal`` gains (finite and positive, with an Eq. (2) energy of
  ~1e36 J) for the energy admission.  Positions come from a numpy
  ``Generator`` seeded with ``seed``, so the reference and the port corrupt
  the same cells with the same values.  The ``FaultReport`` is the ground
  truth that the ``fault_count`` stream must match exactly.
* ``register_chaos_solver`` registers a backend whose P4 output is
  corrupted: ``objective`` makes the P3 value +inf (the fallback fires
  every round), ``budget`` multiplies the winning prefix's waterfilled
  bandwidth by ``scale`` (it fires on the rounds with m* > 0).  The
  backend carries ``(base, kind, scale)`` as ``SolverBackend.chaos``, so
  that kernel K3 applies the same corruption in the fused round.
* ``starved_newton_budgets`` collapses the Newton budget table for a
  genuinely under-converged solve; it is read at call time, so it reaches
  ``waterfill_newton`` and K3's masked P4 alike.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np

import repro_torch.core.solvers as _solvers
from repro_torch.core.solvers import SolverBackend, get_solver, register_solver

FAULT_KINDS: Tuple[str, ...] = ("nan", "inf", "zero", "negative", "subnormal")
QUARANTINE_KINDS: Tuple[str, ...] = ("nan", "inf", "zero", "negative")
CHAOS_KINDS: Tuple[str, ...] = ("objective", "budget")


@dataclasses.dataclass(frozen=True)
class FaultReport:
    """Ground truth of one ``inject_h2_faults`` call: the count of each
    kind (every kind present) and the exact ``(t, k)`` cells corrupted."""

    counts: Dict[str, int]
    positions: Dict[str, Tuple[Tuple[int, int], ...]]

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    @property
    def quarantined(self) -> int:
        """Faults the quarantine must count (the ``fault_count`` total)."""
        return sum(self.counts[k] for k in QUARANTINE_KINDS)

    def per_round_quarantined(self, num_rounds: int) -> np.ndarray:
        """(T,) quarantined faults per round."""
        out = np.zeros((num_rounds,), np.int64)
        for kind in QUARANTINE_KINDS:
            for t, _ in self.positions[kind]:
                out[t] += 1
        return out


def _fault_value(kind: str, dtype: np.dtype) -> float:
    if kind == "nan":
        return float("nan")
    if kind == "inf":
        return float("inf")
    if kind == "zero":
        return 0.0
    if kind == "negative":
        return -1.0
    if kind == "subnormal":
        # 1e-4 of the smallest normal float: subnormal in float32 and
        # float64, finite and positive, so only the admission stops it
        return float(np.finfo(dtype).tiny) * 1e-4
    raise ValueError(f"unknown fault kind {kind!r}; known: {FAULT_KINDS}")


def inject_h2_faults(
    h2_seq,
    seed: int,
    *,
    num_nan: int = 0,
    num_inf: int = 0,
    num_zero: int = 0,
    num_negative: int = 0,
    num_subnormal: int = 0,
) -> Tuple[np.ndarray, FaultReport]:
    """A corrupted copy of a concrete (T, K) gain sequence and its report.

    Positions are drawn without replacement, so kinds never overlap and
    the counts are exact.  ``h2_seq`` may be numpy or a torch tensor (on
    any device); the copy is numpy.
    """
    if hasattr(h2_seq, "detach"):
        h2_seq = h2_seq.detach().cpu().numpy()
    h2 = np.array(h2_seq, copy=True)
    if h2.ndim != 2:
        raise ValueError(f"h2_seq must be a (T, K) array, got shape {h2.shape}")
    want = {
        "nan": int(num_nan), "inf": int(num_inf), "zero": int(num_zero),
        "negative": int(num_negative), "subnormal": int(num_subnormal),
    }
    if any(n < 0 for n in want.values()):
        raise ValueError(f"fault counts must be >= 0, got {want}")
    total = sum(want.values())
    if total > h2.size:
        raise ValueError(
            f"cannot place {total} faults in a {h2.shape} sequence ({h2.size} cells)"
        )
    rng = np.random.default_rng(seed)
    flat = rng.choice(h2.size, size=total, replace=False)
    kinds = [kind for kind in FAULT_KINDS for _ in range(want[kind])]
    positions: Dict[str, list] = {kind: [] for kind in FAULT_KINDS}
    for idx, kind in zip(flat, kinds):
        t, k = divmod(int(idx), h2.shape[1])
        h2[t, k] = _fault_value(kind, h2.dtype)
        positions[kind].append((t, k))
    return h2, FaultReport(
        counts=want, positions={kind: tuple(v) for kind, v in positions.items()}
    )


def chaos_backend(
    base: Union[str, SolverBackend],
    name: Optional[str] = None,
    *,
    kind: str = "objective",
    scale: float = 1.5,
) -> SolverBackend:
    """A backend whose solve is ``base``'s, corrupted by ``kind`` (not
    registered; ``register_chaos_solver`` registers one)."""
    if kind not in CHAOS_KINDS:
        raise ValueError(f"unknown chaos kind {kind!r}; known: {CHAOS_KINDS}")
    backend = get_solver(base)
    if name is None:
        name = f"chaos_{kind}_{backend.name}"

    def prefixes(*args, **kwargs):
        sol = backend.prefixes(*args, **kwargs)
        if kind == "objective":
            return sol._replace(w_star=sol.w_star + float("inf"))
        return sol._replace(b_pos_sorted=sol.b_pos_sorted * scale)

    topm = None
    if backend.topm is not None:

        def topm(*args, **kwargs):
            m_star, w_star, b_pos, sel_pos = backend.topm(*args, **kwargs)
            if kind == "objective":
                return m_star, w_star + float("inf"), b_pos, sel_pos
            return m_star, w_star, b_pos * scale, sel_pos

    return SolverBackend(name, prefixes, backend.waterfill, topm,
                         chaos=(backend.name, kind, float(scale)))


def register_chaos_solver(
    base: Union[str, SolverBackend] = "bisect",
    name: Optional[str] = None,
    *,
    kind: str = "objective",
    scale: float = 1.5,
) -> SolverBackend:
    """Register a backend with deterministically corrupted output.

    ``kind="objective"``: the P3 value becomes +inf, so a guarded run
    falls back on every round and commits the bisect solve.
    ``kind="budget"``: the winning prefix's waterfilled bandwidth is
    multiplied by ``scale``, breaking ``|sum b - 1| <= residual_tol``
    exactly on rounds with m* > 0.  The selection (m*, membership) and
    the base's ``waterfill``/``topm`` capabilities are kept.
    """
    b = chaos_backend(base, name, kind=kind, scale=scale)
    return register_solver(b.name, b.prefixes, b.waterfill, b.topm, chaos=b.chaos)


@contextlib.contextmanager
def starved_newton_budgets(outer: int = 1, inner: int = 1, grid: int = 2):
    """Collapse every Newton budget to ``(outer, inner, grid)`` inside the
    context, so that ``newton`` (and every masked P4) under-converges."""
    saved = _solvers._NEWTON_BUDGET_TABLE
    budget = (int(outer), int(inner), int(grid))
    _solvers._NEWTON_BUDGET_TABLE = ((None, budget, budget),)
    try:
        yield
    finally:
        _solvers._NEWTON_BUDGET_TABLE = saved
