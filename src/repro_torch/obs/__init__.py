"""Telemetry: span tracing and the metrics registry, and the streaming
health detectors and SLO burn-rate monitors that act on them
(``python -m repro_torch.obs.analyze`` is the offline counterpart,
``python -m repro_torch.obs.validate`` the schema check)."""

from repro_torch.obs.health import (Alert, HealthMonitor, LinkDegradeDetector,
                                    LossSpikeDetector, StragglerDetector)
from repro_torch.obs.metrics import (Counter, DeviceAccumulator, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.slo import SLOMonitor, SLOSpec, serve_slos, train_slos
from repro_torch.obs.trace import (NULL_SPAN, Span, Tracer, get_tracer,
                                   set_tracer)

__all__ = [
    "Alert", "Counter", "DeviceAccumulator", "Gauge", "HealthMonitor",
    "Histogram", "LinkDegradeDetector", "LossSpikeDetector",
    "MetricsRegistry", "NULL_SPAN", "SLOMonitor", "SLOSpec", "Span",
    "StragglerDetector", "Tracer", "get_tracer", "serve_slos",
    "set_tracer", "train_slos",
]
