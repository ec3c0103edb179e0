"""Unified observability plane (port of ``repro/obs``): metrics registry,
per-request trace spans and exporters. Dependency-free (numpy only).
The device-telemetry cost bridge (``repro/obs/bridge.py``) is not ported
yet: it needs the cost model and the host search's stats (ROADMAP.md
A9)."""
from repro_torch.obs.metrics import (Counter, Family, Gauge, Histogram,
                                     ObsEvent, Registry, counter,
                                     default_registry, emit_event, gauge,
                                     histogram)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer
from repro_torch.obs.export import (parse_prometheus, prometheus_families,
                                    snapshot, snapshot_json, to_prometheus)

__all__ = [
    "Counter", "Family", "Gauge", "Histogram", "ObsEvent", "Registry",
    "counter", "default_registry", "emit_event", "gauge", "histogram",
    "NULL_SPAN", "NULL_TRACER", "Span", "Tracer",
    "parse_prometheus", "prometheus_families", "snapshot",
    "snapshot_json", "to_prometheus",
]
