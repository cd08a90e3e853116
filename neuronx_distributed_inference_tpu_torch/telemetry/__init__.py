"""Runtime telemetry of the port (counterpart:
``neuronx_distributed_inference_tpu/telemetry/``): the metrics registry,
request spans, the flight recorder and request-scoped trace ids — copies
of the JAX package's host modules, so metric names, label sets, bucket
edges and event names are identical.

Quick start::

    from neuronx_distributed_inference_tpu_torch import telemetry
    reg = telemetry.enable()          # global registry (default: disabled)
    ... serve ...
    print(reg.render_prometheus())    # Prometheus text exposition

Disabled (the default) every instrument is a shared no-op. ``slo.py`` is
the per-tenant SLO tracker; ``observatory.py`` is the compiled-graph
observatory (``observatory.analyze_app(app)``: per-graph flops, bytes,
capture seconds, memory and roofline, schema ``nxdi-graph-report-v1``).
"""

from . import metrics, observatory
from .registry import (DEFAULT_LATENCY_BUCKETS, Counter, Gauge, Histogram,
                       MetricsRegistry, NULL_REGISTRY, NullRegistry, disable,
                       enable, get_registry, set_registry)
from .request_trace import (chrome_by_trace, new_trace_id, trace_events,
                            trace_of)
from .slo import RollingWindow, SLOPolicy, SLOTracker
from .spans import NULL_SPAN, NullSpan, Span
from .trace import (FlightRecorder, NULL_RECORDER, NullFlightRecorder,
                    disable_recorder, enable_recorder, get_recorder,
                    set_recorder)

__all__ = [
    "metrics", "observatory",
    "DEFAULT_LATENCY_BUCKETS", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "NULL_REGISTRY", "NullRegistry",
    "enable", "disable", "get_registry", "set_registry",
    "Span", "NullSpan", "NULL_SPAN",
    "FlightRecorder", "NullFlightRecorder", "NULL_RECORDER",
    "enable_recorder", "disable_recorder", "get_recorder", "set_recorder",
    "new_trace_id", "trace_of", "trace_events", "chrome_by_trace",
    "RollingWindow", "SLOPolicy", "SLOTracker",
]
