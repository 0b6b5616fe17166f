"""Observability: tracing, metrics, critical-path and SLO analysis."""
from repro_torch.obs.trace import (
    EVENT_KINDS,
    NULL_TRACER,
    Event,
    NullTracer,
    TraceContext,
    Tracer,
)
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    merge_snapshots,
    rollup_by_role,
)
from repro_torch.obs.critical_path import (
    CriticalPath,
    StageSpan,
    critical_path,
    spans_from_events,
    spans_from_requests,
    stage_breakdown,
)
from repro_torch.obs.slo import (
    SLO,
    RequestSample,
    percentile,
    request_samples,
    slo_report,
)
from repro_torch.obs.export import (
    events_from_dicts,
    events_to_dicts,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)

__all__ = [
    "EVENT_KINDS", "NULL_TRACER", "Event", "NullTracer", "TraceContext",
    "Tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_snapshots",
    "rollup_by_role",
    "CriticalPath", "StageSpan", "critical_path", "spans_from_events",
    "spans_from_requests", "stage_breakdown",
    "SLO", "RequestSample", "percentile", "request_samples", "slo_report",
    "events_from_dicts", "events_to_dicts", "to_chrome_trace",
    "validate_chrome_trace", "write_chrome_trace",
]
