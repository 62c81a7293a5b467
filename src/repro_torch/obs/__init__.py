"""Unified observability layer: metrics registry + trace spans (DESIGN.md §14).

Import surface for the rest of the codebase::

    from repro_torch.obs import REGISTRY, MetricGroup, span, propagate

Metrics live in one process-wide :data:`REGISTRY`; legacy stats dicts
are :class:`MetricGroup` compat views over it, so the same counters the
tests assert on are scrapeable as Prometheus text via ``GET
/api/metrics`` on the hub and serve daemons (or ``cli obs metrics`` for
an offline repo).  Trace spans export Chrome-trace/Perfetto JSON via
``cli obs trace``.
"""

from repro_torch.obs.metrics import (DEFAULT_BUCKETS, REGISTRY, Counter, Gauge,
                               Histogram, MetricGroup, Registry,
                               render_prometheus)
from repro_torch.obs.trace import (MAX_EVENTS, current_span, disable, enable,
                             export_chrome_trace, is_enabled, propagate,
                             reset_trace, save_trace, span, tracing)

__all__ = [
    "DEFAULT_BUCKETS", "REGISTRY", "Counter", "Gauge", "Histogram",
    "MetricGroup", "Registry", "render_prometheus",
    "MAX_EVENTS", "current_span", "disable", "enable",
    "export_chrome_trace", "is_enabled", "propagate", "reset_trace",
    "save_trace", "span", "tracing",
]
