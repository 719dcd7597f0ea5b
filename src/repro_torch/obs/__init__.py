"""repro_torch.obs — telemetry of the port (port of ``repro.obs``).

* :mod:`repro_torch.obs.metrics` — the static :class:`MetricsSpec` and its
  collector registry: per-round telemetry (queues, drift, the
  drift-plus-penalty terms, energy headroom, selection patterns, solver
  diagnostics) recorded on the scan path's round loop and inside kernel
  K3 on the fused path.
* :mod:`repro_torch.obs.spans` — ``torch.profiler.record_function`` (and,
  on the card, NVTX) ranges, plus host wall-clock span timers.
* :mod:`repro_torch.obs.manifest` — JSONL run manifests in the
  reference's schema.
"""
from repro_torch.obs.manifest import (
    SCHEMA_VERSION,
    ManifestWriter,
    config_hash,
    read_manifest,
    runs_in_manifest,
)
from repro_torch.obs.metrics import (
    FULL_TRACE_ELEM_CAP,
    REDUCTIONS,
    Collector,
    MetricsSpec,
    MetricsState,
    RoundContext,
    available_collectors,
    collector_table,
    finalize_metrics,
    get_collector,
    init_metrics,
    metric_key,
    metrics_round,
    round_context,
    solver_effort,
)
from repro_torch.obs.spans import SPANS, SpanRecorder, record_span, trace_span, wall_span

__all__ = [
    "Collector",
    "FULL_TRACE_ELEM_CAP",
    "ManifestWriter",
    "MetricsSpec",
    "MetricsState",
    "REDUCTIONS",
    "RoundContext",
    "SCHEMA_VERSION",
    "SPANS",
    "SpanRecorder",
    "available_collectors",
    "collector_table",
    "config_hash",
    "finalize_metrics",
    "get_collector",
    "init_metrics",
    "metric_key",
    "metrics_round",
    "read_manifest",
    "record_span",
    "round_context",
    "runs_in_manifest",
    "solver_effort",
    "trace_span",
    "wall_span",
]
