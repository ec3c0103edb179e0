"""Unified observability plane (port of ``repro/obs``): metrics registry,
per-request trace spans, exporters and the device-telemetry cost bridge.
Dependency-free (numpy only): the bridge imports the cost model and the
host oracle inside ``predicted_query_ns``, so importing this package
pulls in no torch module."""
from repro_torch.obs.metrics import (Counter, Family, Gauge, Histogram,
                                     ObsEvent, Registry, counter,
                                     default_registry, emit_event, gauge,
                                     histogram)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer
from repro_torch.obs.export import (parse_prometheus, prometheus_families,
                                    snapshot, snapshot_json, to_prometheus)
from repro_torch.obs.bridge import predicted_query_ns, record_search_stats

__all__ = [
    "Counter", "Family", "Gauge", "Histogram", "ObsEvent", "Registry",
    "counter", "default_registry", "emit_event", "gauge", "histogram",
    "NULL_SPAN", "NULL_TRACER", "Span", "Tracer",
    "parse_prometheus", "prometheus_families", "snapshot",
    "snapshot_json", "to_prometheus",
    "predicted_query_ns", "record_search_stats",
]
