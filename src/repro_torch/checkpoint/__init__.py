"""Preemption-safe checkpointing of the port (port of ``repro.checkpoint``).

* :mod:`repro_torch.checkpoint.ckpt` — ``save_pytree``/``load_pytree``/
  ``latest_step``: atomic, bit-exact npz snapshots of nested tensors, in
  the reference's file format.
* :mod:`repro_torch.checkpoint.trajectory` — ``CheckpointSpec`` (where and
  how often), ``segment_bounds``, snapshot IO and the event recorder that
  segmented ``simulate`` and ``GridEngine`` runs use.
"""
from repro_torch.checkpoint.ckpt import TensorSpec, latest_step, load_pytree, save_pytree
from repro_torch.checkpoint.trajectory import (
    CKPT_EVENTS,
    CheckpointSpec,
    drain_events,
    latest_round,
    load_snapshot,
    record_event,
    save_snapshot,
    segment_bounds,
)

__all__ = [
    "save_pytree",
    "load_pytree",
    "latest_step",
    "TensorSpec",
    "CheckpointSpec",
    "CKPT_EVENTS",
    "segment_bounds",
    "save_snapshot",
    "load_snapshot",
    "latest_round",
    "record_event",
    "drain_events",
]
