"""Telemetry of the port: the metric registry, the request-lifecycle span
tracer and the Chrome-trace / Prometheus exporters, copied from
``tpu_parallel/obs`` (plain Python).  The span spool and trace stitching
are not in the port yet."""

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
    "Span",
    "TraceContext",
    "Tracer",
    "validate_snapshot",
]
