"""Metrics core of the observability plane (port of
``repro/obs/metrics.py``; the reference imports no jax either, but the
port imports nothing of the JAX package, so it keeps its own copy).

A dependency-free (numpy-only) registry of three metric kinds behind
one naming/labeling scheme:

* ``Counter`` — monotone float total (requests served, events emitted);
* ``Gauge``   — last-set value (coverage, live shards);
* ``Histogram`` — **log-bucketed** distribution: bucket ``i >= 1``
  covers ``(lo * growth^(i-1), lo * growth^i]``, bucket 0 holds
  everything ``<= lo``. Recording is O(1) (one log + one slot
  increment; ``observe_many`` amortizes a whole device batch into one
  vectorized bincount), quantiles are exact-to-bucket WITHOUT storing
  samples (a service serving forever holds a fixed ~150-slot array per
  histogram, and ``percentile()`` is an O(buckets) cumulative walk),
  and two
  histograms with the same bucket config **merge** by adding counts —
  per-shard / per-replica distributions aggregate losslessly.

Metrics are grouped into labeled **families**: ``registry.counter(
"phnsw_requests_total", labels=("status",))`` returns a ``Family``
whose ``.labels(status="ok")`` child is the actual counter; a family
declared without labels IS its single child. Families are idempotent —
re-declaring a name returns the existing family (so modules can
declare what they record without coordinating).

``DEFAULT`` is the process-global registry (the same pattern as
``distributed.faults``' module registry): library code records into it
unless handed an explicit registry, and ``Registry.reset()`` zeroes
every metric in place WITHOUT invalidating references held by scrapers
or bound recorders (warmup exclusion relies on this).

The registry also carries the unified **event stream**: one bounded
deque of ``ObsEvent`` records shared by the serving plane's shard
health tracker and ``StepMonitor`` — straggler marks,
dead marks, failures, recoveries all land in one record type, tagged
by ``source``.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


# --------------------------------------------------------------------------
# the unified event record (serving-plane + train-loop monitoring share it)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ObsEvent:
    """One monitoring event in the unified stream: ``kind`` is the
    event type (``straggler`` / ``dead`` / ``failure`` / ``recovered``
    / ...), ``source`` names the emitter (``train``,
    ``serve.shard3``, ``replica1``), ``target`` is the affected
    shard/replica/worker id (-1 = n/a)."""
    kind: str
    source: str = ""
    target: int = -1
    detail: str = ""
    t_wall: float = 0.0


# --------------------------------------------------------------------------
# metric kinds
# --------------------------------------------------------------------------

class Counter:
    """Monotone total. ``inc`` is thread-safe (lock per metric — the
    hot serving path records once per REQUEST, not per vector, so a
    lock is noise next to a device dispatch)."""
    __slots__ = ("labels", "_v", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...] = ()):
        self.labels = labels
        self._v = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Gauge:
    """Last-set value (plus inc/dec for level-style gauges)."""
    __slots__ = ("labels", "_v", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...] = ()):
        self.labels = labels
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        return self._v

    def reset(self) -> None:
        with self._lock:
            self._v = 0.0


class Histogram:
    """Log-bucketed histogram; see the module docstring for the bucket
    scheme. Defaults (``lo=1e-3, hi=1e7, growth=2**0.25``) resolve
    microsecond-to-hour latencies in milliseconds at <= ~9% relative
    half-width (sqrt(growth)) in ~134 buckets. Exact count/sum/min/max
    ride along, so means are exact and ``percentile(0)/percentile(100)``
    return the true extremes."""
    __slots__ = ("labels", "lo", "hi", "growth", "_log_g", "counts",
                 "count", "sum", "min", "max", "_lock")

    def __init__(self, labels: Tuple[Tuple[str, str], ...] = (), *,
                 lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 2 ** 0.25):
        assert 0 < lo < hi and growth > 1
        self.labels = labels
        self.lo, self.hi, self.growth = float(lo), float(hi), float(growth)
        self._log_g = math.log(growth)
        n = 2 + int(math.ceil(math.log(hi / lo) / self._log_g))
        self.counts = np.zeros(n, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        return min(len(self.counts) - 1,
                   1 + int(math.log(v / self.lo) / self._log_g))

    def observe(self, v: float) -> None:
        v = float(v)
        i = self._index(v)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def observe_many(self, values) -> None:
        """Fold a whole array (e.g. a device batch's per-query
        telemetry) in one vectorized pass."""
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        idx = np.ones(v.shape, np.int64)
        pos = v > self.lo
        idx[~pos] = 0
        idx[pos] += np.minimum(
            len(self.counts) - 2,
            (np.log(v[pos] / self.lo) / self._log_g).astype(np.int64))
        binned = np.bincount(idx, minlength=len(self.counts))
        with self._lock:
            self.counts += binned
            self.count += int(v.size)
            self.sum += float(v.sum())
            self.min = min(self.min, float(v.min()))
            self.max = max(self.max, float(v.max()))

    # -- reading -----------------------------------------------------------

    def upper_edge(self, i: int) -> float:
        """Inclusive upper bound of bucket ``i``."""
        if i == 0:
            return self.lo
        return self.lo * self.growth ** i

    def lower_edge(self, i: int) -> float:
        return 0.0 if i == 0 else self.lo * self.growth ** (i - 1)

    def _representative(self, i: int) -> float:
        """A bucket's point estimate: the geometric midpoint of its
        edges (relative error <= sqrt(growth) - 1), clamped into the
        observed [min, max]."""
        if i == 0:
            r = self.lo
        else:
            r = math.sqrt(self.lower_edge(i) * self.upper_edge(i))
        return min(max(r, self.min), self.max)

    def percentile(self, p: float) -> float:
        """Bucket quantile: the representative value of the bucket
        holding the rank-``p`` sample — within one bucket width of the
        exact sample quantile, O(buckets), no samples stored."""
        if self.count == 0:
            return 0.0
        if p <= 0:
            return self.min
        if p >= 100:
            return self.max
        rank = p / 100.0 * (self.count - 1)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += int(c)
            if cum > rank:
                return self._representative(i)
        return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def merge(self, other: "Histogram") -> "Histogram":
        """Add ``other``'s buckets into self (same bucket config
        required) — lossless cross-shard / cross-replica aggregation."""
        if (self.lo, self.hi, self.growth) != (other.lo, other.hi,
                                               other.growth):
            raise ValueError("histogram bucket configs differ; merge "
                             "needs identical (lo, hi, growth)")
        with self._lock:
            self.counts += other.counts
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
        return self

    def reset(self) -> None:
        with self._lock:
            self.counts[:] = 0
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf


# --------------------------------------------------------------------------
# labeled families + the registry
# --------------------------------------------------------------------------

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class Family:
    """One named metric family: children keyed by their label values.
    A family declared with ``labels=()`` has exactly one anonymous
    child and proxies the metric API directly (``fam.inc()`` /
    ``fam.observe()`` / ... just work)."""

    def __init__(self, name: str, kind: str, help: str = "",
                 label_names: Tuple[str, ...] = (), **metric_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.label_names = tuple(label_names)
        self._metric_kw = metric_kw
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.label_names:
            self.labels()          # materialize the anonymous child

    def labels(self, **kv) -> object:
        if set(kv) != set(self.label_names):
            raise ValueError(f"{self.name} has labels "
                             f"{self.label_names}, got {tuple(kv)}")
        key = tuple(str(kv[n]) for n in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = _KINDS[self.kind](
                        tuple(zip(self.label_names, key)),
                        **self._metric_kw)
                    self._children[key] = child
        return child

    def children(self) -> List[object]:
        return [self._children[k] for k in sorted(self._children)]

    def reset(self) -> None:
        for c in self.children():
            c.reset()

    # -- unlabeled-family convenience proxy --------------------------------

    def _solo(self):
        if self.label_names:
            raise ValueError(f"{self.name} is labeled "
                             f"{self.label_names}; call .labels(...)")
        return self._children[()]

    def __getattr__(self, attr):
        # only metric API attributes fall through; anything else is a
        # genuine AttributeError
        if attr in ("inc", "dec", "set", "observe", "observe_many",
                    "percentile", "merge", "value", "count", "sum",
                    "min", "max", "mean", "counts", "upper_edge",
                    "lower_edge", "lo", "hi", "growth"):
            return getattr(self._solo(), attr)
        raise AttributeError(attr)


class Registry:
    """A named set of metric families + the unified event stream."""

    def __init__(self, *, event_capacity: int = 4096):
        self._families: Dict[str, Family] = {}
        self._lock = threading.Lock()
        from collections import deque
        self.events = deque(maxlen=event_capacity)

    # -- declaration (idempotent) ------------------------------------------

    def _family(self, name: str, kind: str, help: str,
                labels: Tuple[str, ...], **kw) -> Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind or fam.label_names != tuple(labels):
                raise ValueError(
                    f"metric {name!r} re-declared as {kind}"
                    f"{tuple(labels)} but exists as {fam.kind}"
                    f"{fam.label_names}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = Family(name, kind, help, tuple(labels), **kw)
                self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Tuple[str, ...] = ()) -> Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Tuple[str, ...] = ()) -> Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Tuple[str, ...] = (), *, lo: float = 1e-3,
                  hi: float = 1e7, growth: float = 2 ** 0.25) -> Family:
        return self._family(name, "histogram", help, labels,
                            lo=lo, hi=hi, growth=growth)

    # -- reading / lifecycle ----------------------------------------------

    def families(self) -> List[Family]:
        return [self._families[n] for n in sorted(self._families)]

    def get(self, name: str) -> Optional[Family]:
        return self._families.get(name)

    def reset(self) -> None:
        """Zero every metric IN PLACE (references stay valid) and drop
        buffered events — the warmup-exclusion / test-isolation hook."""
        for fam in self.families():
            fam.reset()
        self.events.clear()

    # -- the event stream --------------------------------------------------

    def emit(self, kind: str, *, source: str = "", target: int = -1,
             detail: str = "") -> ObsEvent:
        """Append one event to the unified stream (bounded) and bump
        the per-kind event counter."""
        ev = ObsEvent(kind, source, target, detail, time.time())
        self.events.append(ev)
        self.counter("obs_events_total",
                     "monitoring events by kind",
                     labels=("kind",)).labels(kind=kind).inc()
        return ev

    def events_of(self, kind: Optional[str] = None,
                  source_prefix: str = "") -> List[ObsEvent]:
        return [e for e in self.events
                if (kind is None or e.kind == kind)
                and e.source.startswith(source_prefix)]


# --------------------------------------------------------------------------
# process-global default registry
# --------------------------------------------------------------------------

DEFAULT = Registry()


def default_registry() -> Registry:
    return DEFAULT


def counter(name: str, help: str = "",
            labels: Tuple[str, ...] = ()) -> Family:
    return DEFAULT.counter(name, help, labels)


def gauge(name: str, help: str = "",
          labels: Tuple[str, ...] = ()) -> Family:
    return DEFAULT.gauge(name, help, labels)


def histogram(name: str, help: str = "",
              labels: Tuple[str, ...] = (), **kw) -> Family:
    return DEFAULT.histogram(name, help, labels, **kw)


def emit_event(kind: str, *, source: str = "", target: int = -1,
               detail: str = "") -> ObsEvent:
    return DEFAULT.emit(kind, source=source, target=target, detail=detail)
