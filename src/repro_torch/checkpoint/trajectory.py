"""Trajectory checkpointing: spec, snapshot IO, and event recording —
port of ``repro.checkpoint.trajectory``.

:class:`CheckpointSpec` is the user-facing knob threaded through
``OceanConfig`` / ``Scenario`` / ``GridEngine`` as a must-agree field.
It carries *where* snapshots land and *how often* (in Alg. 1 rounds) a
segment boundary is committed.  A ``None`` spec everywhere keeps the
legacy single-program execution paths byte-identical.

Snapshots are plain pytrees persisted through the hardened
:mod:`repro_torch.checkpoint.ckpt` (atomic replace, bit-exact dtypes), keyed
by the *global round index* already executed: ``step_r`` holds the state
needed to run rounds ``r..T``.  Save/restore events are recorded into a
module-global :class:`CheckpointEventRecorder` (mirroring
``repro_torch.obs.spans.SPANS``) that a benchmark runner drains into the
``checkpoints`` field of a JSONL run manifest
(``repro_torch.obs.manifest.ManifestWriter.module``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint import ckpt

__all__ = [
    "CheckpointSpec",
    "CheckpointEventRecorder",
    "CKPT_EVENTS",
    "record_event",
    "drain_events",
    "segment_bounds",
    "save_snapshot",
    "load_snapshot",
    "latest_round",
]


@dataclasses.dataclass(frozen=True)
class CheckpointSpec:
    """Where and how often to snapshot a segmented trajectory.

    ``directory``   — snapshot directory (created on first save).
    ``every_rounds``— segment length: one round loop / fused-kernel
                      launch per segment, snapshot at each boundary.

    Frozen + hashable so it can ride ``OceanConfig`` and the engine's
    must-agree compatibility check.
    """

    directory: str
    every_rounds: int

    def __post_init__(self) -> None:
        if not self.directory:
            raise ValueError("CheckpointSpec.directory must be non-empty")
        if int(self.every_rounds) < 1:
            raise ValueError(
                f"CheckpointSpec.every_rounds must be >= 1, got {self.every_rounds}"
            )
        object.__setattr__(self, "every_rounds", int(self.every_rounds))

    def to_dict(self) -> Dict[str, Any]:
        return {"directory": self.directory, "every_rounds": self.every_rounds}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "CheckpointSpec":
        return cls(directory=d["directory"], every_rounds=int(d["every_rounds"]))


def segment_bounds(
    num_rounds: int, every_rounds: int, start: int = 0
) -> List[Tuple[int, int]]:
    """Half-open ``(t0, t1)`` segment bounds covering ``[start, num_rounds)``.

    Boundaries stay aligned to multiples of ``every_rounds`` regardless
    of ``start``, so a resumed run re-enters the same segment grid as
    the uninterrupted one (a prerequisite for bitwise identity).
    """
    if not 0 <= start <= num_rounds:
        raise ValueError(f"start {start} outside [0, {num_rounds}]")
    bounds = []
    t0 = start
    while t0 < num_rounds:
        t1 = min(((t0 // every_rounds) + 1) * every_rounds, num_rounds)
        bounds.append((t0, t1))
        t0 = t1
    return bounds


class CheckpointEventRecorder:
    """Accumulates checkpoint save/restore events (manifest-ready rows)."""

    def __init__(self) -> None:
        self._events: List[Dict[str, Any]] = []

    def record(self, kind: str, **fields: Any) -> None:
        row = {"kind": kind, "time": time.time()}
        row.update(fields)
        self._events.append(row)

    def drain(self) -> List[Dict[str, Any]]:
        out, self._events = self._events, []
        return out

    def snapshot(self) -> Tuple[Dict[str, Any], ...]:
        return tuple(dict(e) for e in self._events)


CKPT_EVENTS = CheckpointEventRecorder()


def record_event(kind: str, **fields: Any) -> None:
    CKPT_EVENTS.record(kind, **fields)


def drain_events() -> List[Dict[str, Any]]:
    return CKPT_EVENTS.drain()


def save_snapshot(spec: CheckpointSpec, snapshot: Any, round_idx: int) -> str:
    """Persist ``snapshot`` at global round ``round_idx`` (atomic)."""
    path = ckpt.save_pytree(spec.directory, snapshot, round_idx)
    record_event("save", directory=spec.directory, round=int(round_idx), path=path)
    return path


def load_snapshot(
    directory: str, like: Any, round_idx: Optional[int] = None, *, device=None
) -> Tuple[Any, int]:
    """Restore the snapshot at ``round_idx`` (default: latest committed),
    its tensors on ``device`` (``ckpt.load_pytree``)."""
    snap, step = ckpt.load_pytree(directory, like, round_idx, device=device)
    record_event("restore", directory=directory, round=int(step))
    return snap, step


def latest_round(directory: str) -> Optional[int]:
    """Latest committed snapshot round in ``directory`` (None if empty)."""
    return ckpt.latest_step(directory)
