"""Named profiler spans and host wall-clock span timers — port of ``repro.obs.spans``.

Two layers:

* :func:`trace_span` — names a stretch of the port's code
  (``ocean/rank``, ``ocean/p4_solve/<backend>``, ``p4/bisect/candidate_sweep``,
  ``p4/newton/grid_seed``, ``p4/newton/polish``, ``grid/sample_env``,
  ``grid/policy/<name>``) as a ``torch.profiler.record_function`` range
  while a ``torch.profiler`` trace records, so that the trace shows the
  algorithm's phases, and, where CUDA is available, as an NVTX range for
  Nsight Systems.  It only
  names: numerics are unchanged.  The reference's ``traj/chunk_io`` span
  has no counterpart: kernel K3 keeps every round on chip and has no
  chunks to copy in and out.
* :func:`wall_span` — a host-side span: a ``record_function`` range plus a
  wall-clock timer recorded into the module-global :class:`SpanRecorder`,
  whose drained rows go into a run manifest (``repro_torch.obs.manifest``).
  A host time, not a device time: it ends when the host leaves the block,
  whatever the card still runs.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import torch

__all__ = [
    "trace_span", "wall_span", "SpanRecorder", "SPANS", "record_span", "set_trace_spans",
]

_NVTX: Optional[bool] = None
_ENABLED = True


def _nvtx() -> bool:
    """Whether NVTX ranges are on: only where CUDA is (a CPU-only torch
    raises from ``torch.cuda.nvtx.range_push``)."""
    global _NVTX
    if _NVTX is None:
        _NVTX = torch.cuda.is_available()
    return _NVTX


def set_trace_spans(enabled: bool) -> bool:
    """Turn :func:`trace_span` on or off (it is on by default); returns the
    previous setting.  Off, a span is an empty context: what the spans
    cost is the difference."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(enabled)
    return prev


class _Span(contextlib.ContextDecorator):
    """A ``record_function`` range while a ``torch.profiler`` trace records
    (outside one it would cost ~15 µs a range on the H100 machine's host
    and name nothing), and an NVTX range where CUDA is."""

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if _nvtx():
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if _nvtx():
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
            self.rf = None
        return False


_OFF = contextlib.nullcontext()


def trace_span(name: str):
    """Name the work done inside the block (a context manager or decorator)."""
    return _Span(name) if _ENABLED else _OFF


class SpanRecorder:
    """Accumulates named wall-clock spans: ``{name: [seconds, ...]}``."""

    def __init__(self) -> None:
        self._spans: Dict[str, List[float]] = {}

    def record(self, name: str, seconds: float) -> None:
        self._spans.setdefault(name, []).append(float(seconds))

    def drain(self) -> List[Dict[str, object]]:
        """Return and clear the recorded spans (manifest-ready rows)."""
        out = [
            {
                "name": name,
                "count": len(times),
                "total_s": sum(times),
                "mean_s": sum(times) / len(times),
            }
            for name, times in self._spans.items()
        ]
        self._spans.clear()
        return out

    def snapshot(self) -> Dict[str, Tuple[float, ...]]:
        return {k: tuple(v) for k, v in self._spans.items()}


SPANS = SpanRecorder()


def record_span(name: str, seconds: float) -> None:
    """Record one wall-clock span into the global recorder."""
    SPANS.record(name, seconds)


@contextlib.contextmanager
def wall_span(name: str, recorder: Optional[SpanRecorder] = None):
    """Host-side span: a named profiler range and a wall-clock timer, recorded
    into ``recorder`` (the global ``SPANS`` by default) even when the block
    raises."""
    recorder = SPANS if recorder is None else recorder
    t0 = time.perf_counter()
    with trace_span(name):
        try:
            yield
        finally:
            recorder.record(name, time.perf_counter() - t0)
