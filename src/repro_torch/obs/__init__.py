"""Telemetry: span tracing and the metrics registry."""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import NULL_SPAN, Span, Tracer, get_tracer, set_tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NULL_SPAN",
           "Span", "Tracer", "get_tracer", "set_tracer"]
