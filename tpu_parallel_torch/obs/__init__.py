"""Telemetry of the port: the metric registry and the request-lifecycle
span tracer, copied from ``tpu_parallel/obs`` (both are plain Python).
The exporters, span spool and trace stitching are not in the port yet."""

from tpu_parallel_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    HistogramWindow,
    MetricRegistry,
    PercentileWindow,
    validate_snapshot,
)
from tpu_parallel_torch.obs.tracer import NULL_TRACER, Span, TraceContext, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramWindow",
    "MetricRegistry",
    "NULL_TRACER",
    "PercentileWindow",
    "Span",
    "TraceContext",
    "Tracer",
    "validate_snapshot",
]
