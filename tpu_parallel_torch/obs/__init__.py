"""Telemetry of the port: the metric registry, the request-lifecycle span
tracer, the Chrome-trace / Prometheus exporters and the per-process span
spool, copied from ``tpu_parallel/obs`` (plain Python).  Trace stitching
is not in the port yet."""

from tpu_parallel_torch.obs.exporters import (
    chrome_trace_events,
    prometheus_lines,
    prometheus_text,
    write_chrome_trace,
    write_prometheus,
)
from tpu_parallel_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    HistogramWindow,
    MetricRegistry,
    PercentileWindow,
    validate_snapshot,
)
from tpu_parallel_torch.obs.spool import SpanSpool, read_span_log
from tpu_parallel_torch.obs.tracer import NULL_TRACER, Span, TraceContext, Tracer

__all__ = [
    "chrome_trace_events",
    "prometheus_lines",
    "prometheus_text",
    "write_chrome_trace",
    "write_prometheus",
    "Counter",
    "Gauge",
    "Histogram",
    "HistogramWindow",
    "MetricRegistry",
    "NULL_TRACER",
    "PercentileWindow",
    "SpanSpool",
    "Span",
    "TraceContext",
    "Tracer",
    "read_span_log",
    "validate_snapshot",
]
