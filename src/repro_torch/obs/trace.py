"""Per-request trace spans for the serving path (port of
``repro/obs/trace.py``; the port keeps its own copy).

A ``Span`` is one timed unit of serving work (a request, one shard
probe, the cross-shard merge, an epoch swap); spans nest into a tree
and carry ordered **events** (retry/backoff decisions, fault-injection
hits, straggler marks, dead-shard marks) so a degraded query is
explainable after the fact from its trace alone.

Context is passed EXPLICITLY: a function that should appear in the
trace takes a ``span`` argument and opens children with
``span.child(...)`` — no thread-locals, no contextvars, so the trace
tree is exactly the call tree the serving code actually took (and the
machinery works unchanged if requests ever fan out across threads).

**Off by default, one is-enabled check.** The cost gate is the same
pattern ``distributed.faults`` uses for its hook registry: the single
check lives in ``Tracer.span`` — a disabled tracer returns the
module-singleton ``NULL_SPAN``, whose every method is a no-op and
whose ``child()`` returns itself, so instrumented code is written
unconditionally (``span.event(...)``, ``span.child(...)``) and the
disabled hot path allocates NO span objects at all (counted by
``Span.n_created``) and costs one no-op method call per
instrumentation point.

Finished ROOT spans land in ``tracer.finished`` (bounded deque);
``Span.to_dict()`` / ``find()`` / ``iter_spans()`` are the assertion
surface for tests and the JSON export shape.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple


class Span:
    """One timed, attributed, evented node of a trace tree."""

    __slots__ = ("name", "attrs", "events", "children", "t0", "t1",
                 "_tracer")

    # allocation counter — the zero-overhead-when-disabled test reads
    # this across a disabled-path run to prove no Span was created
    n_created = 0

    def __init__(self, name: str, tracer: Optional["Tracer"] = None,
                 **attrs):
        Span.n_created += 1
        self.name = name
        self.attrs: Dict[str, object] = dict(attrs)
        self.events: List[Tuple[float, str, Dict[str, object]]] = []
        self.children: List["Span"] = []
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self._tracer = tracer

    # -- building the tree -------------------------------------------------

    def child(self, name: str, **attrs) -> "Span":
        s = Span(name, **attrs)
        self.children.append(s)
        return s

    def event(self, kind: str, **fields) -> None:
        """Record an ordered event at the current offset into the
        span (milliseconds since span start)."""
        self.events.append(((time.perf_counter() - self.t0) * 1e3,
                            kind, fields))

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def end(self) -> "Span":
        if self.t1 is None:
            self.t1 = time.perf_counter()
            if self._tracer is not None:
                self._tracer._finish(self)
        return self

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc is not None:
            self.event("error", error=repr(exc))
            self.set(ok=False)
        self.end()
        return False                       # never swallow

    # -- reading -----------------------------------------------------------

    @property
    def duration_ms(self) -> float:
        t1 = self.t1 if self.t1 is not None else time.perf_counter()
        return (t1 - self.t0) * 1e3

    @property
    def enabled(self) -> bool:
        return True

    def iter_spans(self) -> Iterator["Span"]:
        """self + all descendants, depth-first in creation order."""
        yield self
        for c in self.children:
            yield from c.iter_spans()

    def find(self, name: str) -> Optional["Span"]:
        return next((s for s in self.iter_spans() if s.name == name),
                    None)

    def find_all(self, name: str) -> List["Span"]:
        return [s for s in self.iter_spans() if s.name == name]

    def event_kinds(self) -> List[str]:
        return [k for _, k, _ in self.events]

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "duration_ms": self.duration_ms,
            "attrs": dict(self.attrs),
            "events": [{"t_ms": t, "kind": k, **f}
                       for t, k, f in self.events],
            "children": [c.to_dict() for c in self.children],
        }

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.duration_ms:.2f}ms, "
                f"{len(self.children)} children, "
                f"{len(self.events)} events)")


class _NullSpan:
    """The disabled path: a singleton whose whole API is no-ops and
    whose ``child()`` is itself — instrumented code never branches."""

    __slots__ = ()

    enabled = False
    name = ""
    attrs: Dict[str, object] = {}
    events: List[Tuple[float, str, Dict[str, object]]] = []
    children: List[Span] = []
    duration_ms = 0.0

    def child(self, name: str, **attrs) -> "_NullSpan":
        return self

    def event(self, kind: str, **fields) -> None:
        pass

    def set(self, **attrs) -> None:
        pass

    def end(self) -> "_NullSpan":
        return self

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def iter_spans(self) -> Iterator[Span]:
        return iter(())

    def find(self, name: str) -> None:
        return None

    def find_all(self, name: str) -> List[Span]:
        return []

    def event_kinds(self) -> List[str]:
        return []

    def to_dict(self) -> dict:
        return {}

    def __repr__(self) -> str:
        return "NULL_SPAN"

    def __bool__(self) -> bool:
        # truthiness mirrors ``enabled`` so rare non-hot-path code can
        # gate expensive attr computation with ``if span: ...``
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + finished-trace sink. ``Tracer(enabled=False)``
    (or the module's ``NULL_TRACER``) is the zero-cost default: its
    ``span()`` returns ``NULL_SPAN`` after ONE boolean check."""

    def __init__(self, *, enabled: bool = True, capacity: int = 256):
        self.enabled = enabled
        self.finished: Deque[Span] = deque(maxlen=capacity)

    def span(self, name: str, **attrs):
        """Open a ROOT span (it lands in ``finished`` when ended).
        This is THE is-enabled check of the tracing plane."""
        if not self.enabled:
            return NULL_SPAN
        return Span(name, tracer=self, **attrs)

    def _finish(self, span: Span) -> None:
        self.finished.append(span)

    def last(self, name: Optional[str] = None) -> Optional[Span]:
        """Most recent finished root span (optionally by name)."""
        for s in reversed(self.finished):
            if name is None or s.name == name:
                return s
        return None

    def clear(self) -> None:
        self.finished.clear()


NULL_TRACER = Tracer(enabled=False, capacity=1)
