"""Lightweight span API for per-request distributed traces.

A copy of the JAX package's ``repro.observability.tracing`` (framework-free),
kept in the port so that the port imports nothing of the JAX package.

A ``TraceContext`` rides on a serving ``Request`` and collects the spans of
its journey: queue wait, (chunked) prefill with prefix-cache annotations,
decode with per-verify speculative accept counts, plus the control-plane
events it survived (failover re-queues, preemption detach/adopt carries).
The finished tree serializes to a plain dict for the flight recorder.

Design constraints, in order:

* **~zero cost when disabled.** Call sites do ``r.trace.event(...)``
  unconditionally; when tracing is off ``r.trace`` is the shared
  ``NULL_TRACE`` singleton whose methods are empty — no allocation, no
  branching at the call site, no lock.
* **Monotonic clocks.** All span times come from ``time.perf_counter``
  (monotonic), matching the engine's own TTFT/latency bookkeeping; records
  store durations and *relative* offsets, never wall-clock deltas.
* **Thread-safe.** A request's trace is touched from the submitting thread,
  the replica decode thread, and the health/failover sweep; one lock per
  trace context serializes them (traces are per-request, so the lock is
  uncontended in practice).

Spans for phases that start in one method and end in another (queue wait
opened at submit, closed at admission) use the named ``open``/``close``
API; events attach to the innermost open span, so a ``verify`` event lands
inside the ``decode`` span without the call site holding a reference.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

_rid_counter = itertools.count(1)


def next_rid() -> int:
    """Process-unique request id (itertools.count is GIL-atomic)."""
    return next(_rid_counter)


class Span:
    """One timed phase of a request. ``t0``/``t1`` are perf_counter values;
    ``events`` are point-in-time annotations ``(t, name, attrs)``."""

    __slots__ = ("name", "t0", "t1", "attrs", "events", "children")

    def __init__(self, name: str, t0: Optional[float] = None, **attrs):
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs = dict(attrs)
        self.events: List[tuple] = []
        self.children: List["Span"] = []

    def child(self, name: str, **attrs) -> "Span":
        c = Span(name, **attrs)
        self.children.append(c)
        return c

    def event(self, name: str, **attrs):
        self.events.append((time.perf_counter(), name, attrs))

    def annotate(self, **attrs):
        self.attrs.update(attrs)

    def end(self, **attrs):
        if attrs:
            self.attrs.update(attrs)
        if self.t1 is None:
            self.t1 = time.perf_counter()
        return self

    @property
    def duration_s(self) -> Optional[float]:
        if self.t1 is None:
            return None
        return self.t1 - self.t0

    def to_dict(self, base: float) -> dict:
        """Serialize with times relative to the trace start (seconds)."""
        out = {"name": self.name, "start_s": round(self.t0 - base, 6)}
        if self.t1 is not None:
            out["duration_s"] = round(self.t1 - self.t0, 6)
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = [{"at_s": round(t - base, 6), "name": n,
                              **({"attrs": a} if a else {})}
                             for t, n, a in self.events]
        if self.children:
            out["children"] = [c.to_dict(base) for c in self.children]
        return out


class TraceContext:
    """The span tree of one request. The root span covers submit ->
    completion; phase spans are its children. ``open``/``close`` manage
    cross-method spans by name (re-opening a name after a close starts a
    *new* span — a failed-over request gets a second ``queue_wait``)."""

    __slots__ = ("root", "_lock", "_open")

    enabled = True

    def __init__(self, name: str = "request", **attrs):
        self.root = Span(name, **attrs)
        self._lock = threading.Lock()
        self._open: List[Span] = []      # innermost last

    def open(self, name: str, **attrs) -> Span:
        with self._lock:
            parent = self._open[-1] if self._open else self.root
            span = parent.child(name, **attrs)
            self._open.append(span)
            return span

    def close(self, name: str, **attrs) -> Optional[Span]:
        """End the most recent open span called ``name`` (and implicitly
        anything opened inside it that was left dangling)."""
        with self._lock:
            for i in range(len(self._open) - 1, -1, -1):
                if self._open[i].name == name:
                    span = self._open[i]
                    for dangling in self._open[i + 1:]:
                        dangling.end()
                    del self._open[i:]
                    return span.end(**attrs)
        return None

    def event(self, name: str, **attrs):
        """Point annotation on the innermost open span (root if none) —
        a ``verify`` event lands inside ``decode``; a ``failover`` event
        arriving with nothing open lands on the root."""
        with self._lock:
            target = self._open[-1] if self._open else self.root
            target.event(name, **attrs)

    def annotate(self, **attrs):
        with self._lock:
            self.root.attrs.update(attrs)

    def finish(self, **attrs) -> "TraceContext":
        with self._lock:
            for span in reversed(self._open):
                span.end()
            self._open.clear()
            self.root.end(**attrs)
        return self

    def to_dict(self) -> dict:
        return self.root.to_dict(self.root.t0)


class _NullTrace:
    """Shared do-nothing trace: the disabled path costs one attribute load
    and an empty method call per site. Every mutator is a no-op and every
    accessor returns an inert value, so call sites never branch."""

    __slots__ = ()
    enabled = False
    root = None

    def open(self, name, **attrs):
        return self

    def close(self, name, **attrs):
        return None

    def child(self, name, **attrs):
        return self

    def event(self, name, **attrs):
        return None

    def annotate(self, **attrs):
        return None

    def end(self, **attrs):
        return self

    def finish(self, **attrs):
        return self

    def to_dict(self):
        return {}


NULL_TRACE = _NullTrace()


def null_trace() -> _NullTrace:
    return NULL_TRACE
