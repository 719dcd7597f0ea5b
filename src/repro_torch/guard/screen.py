"""Eager host-side screens of concrete streams — port of ``repro.guard.screen``.

``screen_streams`` validates user-supplied sequences (a measured channel
trace, a replayed budget log) before they enter ``simulate``.  Every
torch tensor is concrete, so unlike the reference's screen nothing is
skipped as traced.  ``simulate`` does not call it: the chaos harness feeds
corrupted sequences to guarded runs to prove the in-round quarantine.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.env.radio import TracedRadio


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _violations(x, *, positive: bool) -> int:
    """Non-finite (and, with ``positive``, non-positive) float entries."""
    arr = _as_numpy(x)
    if arr.dtype.kind != "f":
        return 0
    ok = np.isfinite(arr)
    if positive:
        ok = ok & (arr > 0.0)
    return int(arr.size - np.sum(ok))


def screen_streams(
    *,
    h2_seq=None,
    budget_seq=None,
    radio_seq: Optional[TracedRadio] = None,
    strict: bool = True,
) -> Dict[str, int]:
    """Count bad entries of numpy or torch streams before a run.

    Gains must be finite and positive, budget increments finite and
    non-negative, every radio leaf finite and positive.  Returns the
    per-stream counts; with ``strict=True`` raises ``ValueError`` naming
    every offending stream instead.
    """
    counts: Dict[str, int] = {}
    if h2_seq is not None:
        counts["h2_seq"] = _violations(h2_seq, positive=True)
    if budget_seq is not None:
        arr = _as_numpy(budget_seq)
        neg = int(np.sum(np.isfinite(arr) & (arr < 0.0))) if arr.dtype.kind == "f" else 0
        counts["budget_seq"] = _violations(arr, positive=False) + neg
    if radio_seq is not None:
        counts["radio_seq"] = sum(_violations(leaf, positive=True) for leaf in radio_seq)
    bad = {k: v for k, v in counts.items() if v}
    if strict and bad:
        raise ValueError(
            f"stream screen failed: non-finite/out-of-range entries in "
            f"{', '.join(f'{k} ({v})' for k, v in bad.items())}; sanitize the "
            f"input or run with GuardSpec(quarantine=True) to contain it in the round"
        )
    return counts
