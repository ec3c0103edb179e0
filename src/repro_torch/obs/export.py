"""Exporters for the observability plane: Prometheus text exposition +
a sort-stable JSON snapshot (port of ``repro/obs/export.py``).

``to_prometheus`` renders a ``Registry`` in the text exposition format
(``# HELP`` / ``# TYPE`` headers, ``name{label="v"} value`` samples;
histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
``_count`` — the log-bucket upper edges become the ``le`` bounds, so
any Prometheus-compatible scraper computes the same exact-to-bucket
quantiles the in-process ``percentile()`` does). ``parse_prometheus``
is the matching minimal parser.

``snapshot`` emits the same data as one JSON-serializable dict with
every collection sorted (family name, label values, bucket index), so
two snapshots of identical registries are byte-identical after
``json.dumps`` — diffable in tests and stable under re-serialization.
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     default_registry)


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    return repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...],
               extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


def to_prometheus(registry: Optional[Registry] = None) -> str:
    """Render every family of ``registry`` (default: the process
    registry) in the Prometheus text exposition format."""
    registry = registry or default_registry()
    out: List[str] = []
    for fam in registry.families():
        out.append(f"# HELP {fam.name} {fam.help}")
        out.append(f"# TYPE {fam.name} {fam.kind}")
        for m in fam.children():
            if isinstance(m, (Counter, Gauge)):
                out.append(f"{fam.name}{_label_str(m.labels)} "
                           f"{_fmt(m.value)}")
            elif isinstance(m, Histogram):
                cum = 0
                for i, c in enumerate(m.counts):
                    cum += int(c)
                    out.append(
                        f"{fam.name}_bucket"
                        f"{_label_str(m.labels, (('le', _fmt(m.upper_edge(i))),))}"
                        f" {cum}")
                    # emit up to the first bucket that reaches the
                    # total (plus +Inf below) — full fidelity without
                    # the empty tail
                    if cum == m.count:
                        break
                out.append(f"{fam.name}_bucket"
                           f"{_label_str(m.labels, (('le', '+Inf'),))}"
                           f" {m.count}")
                out.append(f"{fam.name}_sum{_label_str(m.labels)} "
                           f"{_fmt(m.sum)}")
                out.append(f"{fam.name}_count{_label_str(m.labels)} "
                           f"{m.count}")
    return "\n".join(out) + "\n"


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Minimal exposition-format parser: ``{metric_name: [(labels,
    value), ...]}``. Raises ``ValueError`` on a malformed line."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            series, value = line.rsplit(" ", 1)
            labels: Dict[str, str] = {}
            if "{" in series:
                name, rest = series.split("{", 1)
                if not rest.endswith("}"):
                    raise ValueError(line)
                body = rest[:-1]
                if body:
                    for item in body.split(","):
                        k, v = item.split("=", 1)
                        if not (v.startswith('"') and v.endswith('"')):
                            raise ValueError(line)
                        labels[k] = v[1:-1]
            else:
                name = series
            out.setdefault(name, []).append((labels, float(value)))
        except ValueError:
            raise
        except Exception as e:
            raise ValueError(f"malformed exposition line: {line!r}") from e
    return out


def prometheus_families(text: str) -> List[str]:
    """The family names declared by ``# TYPE`` headers, in order."""
    return [line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")]


def snapshot(registry: Optional[Registry] = None) -> dict:
    """JSON-serializable snapshot of every metric + the event stream,
    fully sorted — stable under re-serialization."""
    registry = registry or default_registry()
    fams = []
    for fam in registry.families():
        children = []
        for m in fam.children():
            entry: dict = {"labels": dict(m.labels)}
            if isinstance(m, (Counter, Gauge)):
                entry["value"] = m.value
            else:
                nz = {int(i): int(c) for i, c in enumerate(m.counts)
                      if c}
                entry.update({
                    "count": m.count, "sum": m.sum,
                    "min": None if m.count == 0 else m.min,
                    "max": None if m.count == 0 else m.max,
                    "buckets": {str(k): nz[k] for k in sorted(nz)},
                    "p50": m.percentile(50), "p99": m.percentile(99),
                    "p999": m.percentile(99.9),
                })
            children.append(entry)
        fams.append({"name": fam.name, "kind": fam.kind,
                     "help": fam.help,
                     "label_names": list(fam.label_names),
                     "children": children})
    return {
        "families": fams,
        "events": [{"kind": e.kind, "source": e.source,
                    "target": e.target, "detail": e.detail,
                    "t_wall": e.t_wall} for e in registry.events],
    }


def snapshot_json(registry: Optional[Registry] = None, **dumps_kw) -> str:
    return json.dumps(snapshot(registry), sort_keys=True, **dumps_kw)
