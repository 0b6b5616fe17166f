"""Observability: tracing and metrics (the parts the fused engine uses)."""
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

__all__ = [
    "EVENT_KINDS", "NULL_TRACER", "Event", "NullTracer", "TraceContext",
    "Tracer",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "merge_snapshots",
    "rollup_by_role",
]
