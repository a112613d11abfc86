"""Structured span tracing for the serving stack — zero dependencies
(``repro.obs.trace``'s spans and tracer, stdlib only, plus the span log
below).

A ``Span`` is a named interval with attributes and children; a
``Tracer`` mints one root span per request and the runtime hangs phase
spans off it as the request moves through its lane:

    request
      admit                     admission control
        canonicalize            relabel to canonical form
        probe                   plan-cache probe (the fast path's test)
        route                   routing ladder: quarantine, deadline
                                reroute, backpressure, breakers
      queue_wait                enqueue -> bucket close        (miss lane)
      seed                      layer-cache warm-start probe
      lane_wait                 hand-off to the lane -> the lane begins
      coalesce                  joined an identical in-flight request
      fast_path                 cache hit served inline
      dispatch                  solver work: compile|execute split,
                                while-loop rounds, engine tag, flops
      extract                   tree reconstruction + cache insert
      respond                   completion bookkeeping
      shed                      refused: deadline / backpressure / error

``PlanServer.plan_one`` records the same names (``admit`` with its three
children, ``seed``, ``dispatch``, ``extract``, ``respond``) while a
``torch.profiler`` session is active.

Timestamps come EXCLUSIVELY from the runtime's ``Clock`` abstraction —
on a ``VirtualClock`` span trees are bit-deterministic and tests assert
their exact ``shape()``.  On close, each span's duration feeds a
``trace.<name>_s`` histogram in the bound ``MetricsRegistry``, giving
the per-phase p50/p95 breakdown (``export.span_phase_summary``).

Disabled tracing costs one attribute check per call site: ``Tracer``
hands out the shared ``NULL_SPAN``, whose every method is a no-op.

The span log (``SPAN_LOG``): while a ``torch.profiler`` session is
active (``profiling()``, one flag read), every span a tracer closes on a
clock with a wall anchor (``clock.epoch_ns``, the ``WallClock``) is also
appended to one bounded process-wide log as ``(name, request id, parent
name, t0_ns, t1_ns, thread name)``, in epoch nanoseconds: the clock of
``time.time_ns()``, which is the profiler's, so the log lies over the
session's device trace.  The log counts what it drops.  With no session
a closed span costs one flag read more and the log allocates nothing.
"""
from __future__ import annotations

import collections
import sys
import threading


def profiling() -> bool:
    """Whether a ``torch.profiler`` (autograd profiler) session is
    active: one module-flag read; False where torch was never loaded."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class SpanLog:
    """A bounded log of closed spans in epoch nanoseconds, oldest
    dropped first.  ``dropped`` counts the entries lost to the bound and
    ``last_dropped_ns`` is the end of the newest of them, so a reader of
    a window ``[t0_ns, t1_ns]`` knows it lost nothing when
    ``last_dropped_ns < t0_ns``."""

    def __init__(self, capacity: int = 1 << 16):
        self.entries: collections.deque = collections.deque(
            maxlen=capacity)
        self.dropped = 0
        self.last_dropped_ns = -1
        self._lock = threading.Lock()

    def append(self, name: str, req, parent: "str | None", t0_ns: int,
               t1_ns: int, thread: "str | None" = None) -> None:
        entry = (name, req, parent, int(t0_ns), int(t1_ns),
                 thread if thread is not None
                 else threading.current_thread().name)
        with self._lock:
            if len(self.entries) == self.entries.maxlen:
                old = self.entries[0]
                self.dropped += 1
                self.last_dropped_ns = max(self.last_dropped_ns, old[4])
            self.entries.append(entry)

    def window(self, t0_ns: int, t1_ns: int) -> "list | None":
        """The entries that lie wholly inside ``[t0_ns, t1_ns]``, or None
        when the bound dropped an entry that ended in or after it."""
        with self._lock:
            if self.last_dropped_ns >= t0_ns:
                return None
            return [e for e in self.entries
                    if e[3] >= t0_ns and e[4] <= t1_ns]

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()
            self.dropped = 0
            self.last_dropped_ns = -1


SPAN_LOG = SpanLog()


class Span:
    __slots__ = ("name", "t0", "t1", "attrs", "children", "_tracer",
                 "parent", "req")

    def __init__(self, name: str, t0: float, tracer: "Tracer | None" = None,
                 attrs: "dict | None" = None):
        self.name = name
        self.t0 = t0
        self.t1: "float | None" = None
        # the span OWNS the dict passed in (child()/request() hand over
        # the fresh **attrs dict) — no defensive copy on the hot path
        self.attrs = attrs if attrs is not None else {}
        self.children: list = []
        self._tracer = tracer
        self.parent: "str | None" = None    # the parent's name (log)
        self.req = None                     # the root's request id (log)

    # ------------------------------------------------------- lifecycle
    def child(self, name: str, at: "float | None" = None, **attrs) -> "Span":
        tr = self._tracer
        t0 = at if at is not None else (tr.clock.now() if tr else 0.0)
        s = Span(name, t0, tr, attrs)
        s.parent = self.name
        s.req = self.req
        self.children.append(s)
        if tr is not None:
            tr._opened()
        return s

    def close(self, at: "float | None" = None, **attrs) -> "Span":
        if self.t1 is not None:  # idempotent: keep the first close time
            return self
        tr = self._tracer
        self.t1 = at if at is not None else (tr.clock.now() if tr else
                                             self.t0)
        if attrs:
            self.attrs.update(attrs)
        if tr is not None:
            tr._closed(self)
        return self

    @property
    def open(self) -> bool:
        return self.t1 is None

    @property
    def duration(self) -> float:
        return (self.t1 if self.t1 is not None else self.t0) - self.t0

    # ------------------------------------------------------ inspection
    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> "Span | None":
        for s in self.walk():
            if s.name == name:
                return s
        return None

    def count(self) -> int:
        return sum(1 for _ in self.walk())

    def shape(self):
        """Nested ``(name, (child shapes...))`` — what tests assert."""
        return (self.name, tuple(c.shape() for c in self.children))

    def to_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "attrs": self.attrs,
                "children": [c.to_dict() for c in self.children]}


class _NullSpan:
    """Shared no-op span: tracing disabled, every call site stays live."""

    __slots__ = ()
    name = "null"
    attrs: dict = {}
    children: list = []
    t0 = 0.0
    t1 = 0.0
    open = False
    duration = 0.0

    def child(self, name, at=None, **attrs):
        return self

    def close(self, at=None, **attrs):
        return self

    def walk(self):
        return iter(())

    def find(self, name):
        return None

    def count(self):
        return 0

    def shape(self):
        return ("null", ())

    def to_dict(self):
        return {}


NULL_SPAN = _NullSpan()


class Tracer:
    """Mints request span trees against a ``Clock``; aggregates phase
    durations into a ``MetricsRegistry``; hands finished trees to a
    ``FlightRecorder``.

    Not thread-safe per span (each request's tree is touched by one
    logical flow at a time, which the runtime guarantees); the open/
    closed tallies are plain ints updated from the event loop only.
    """

    def __init__(self, clock, registry=None, recorder=None,
                 enabled: bool = True, sample_rate: float = 1.0):
        if not 0.0 <= sample_rate <= 1.0:
            raise ValueError("sample_rate must be in [0, 1]")
        self.clock = clock
        self.registry = registry
        self.recorder = recorder
        self.enabled = enabled
        # head sampling: trace this fraction of requests.  The decision
        # is counter-based (the k-th request is traced iff the integer
        # part of k * rate advanced), so sampled sets are deterministic
        # — no RNG — and evenly spread through the stream.  Incident
        # capture (shed / error / deadline miss) does NOT go through the
        # tracer and is never sampled away: the runtime records
        # incidents on the FlightRecorder unconditionally.
        self.sample_rate = sample_rate
        self.sampled = 0          # requests that got a real root span
        self.sampled_out = 0      # requests handed NULL_SPAN by sampling
        self.spans_opened = 0
        self.spans_closed = 0
        self.requests = 0
        self.unclosed_spans = 0   # spans force-closed by finish()
        self.shape_mismatches = 0  # lane-taxonomy self-check failures
        self._hists: dict = {}    # span name -> Histogram (skips the
        #                           registry lock on the per-close path)

    @property
    def open_spans(self) -> int:
        return self.spans_opened - self.spans_closed

    # ------------------------------------------------------- internals
    def _opened(self) -> None:
        self.spans_opened += 1

    def _closed(self, span: Span) -> None:
        self.spans_closed += 1
        if self.registry is not None:
            h = self._hists.get(span.name)
            if h is None:
                h = self.registry.histogram(f"trace.{span.name}_s")
                self._hists[span.name] = h
            h.observe(span.duration)
        if profiling():
            epoch_ns = getattr(self.clock, "epoch_ns", None)
            if epoch_ns is not None:
                SPAN_LOG.append(span.name, span.req, span.parent,
                                epoch_ns(span.t0), epoch_ns(span.t1))

    # ------------------------------------------------------- interface
    def request(self, at: "float | None" = None, **attrs):
        """Open a root span (or ``NULL_SPAN`` when disabled)."""
        if not self.enabled:
            return NULL_SPAN
        self.requests += 1
        if self.sample_rate < 1.0:
            k = self.requests
            if int(k * self.sample_rate) <= int((k - 1) * self.sample_rate):
                self.sampled_out += 1
                return NULL_SPAN
        self.sampled += 1
        root = Span("request", at if at is not None else self.clock.now(),
                    self, attrs)
        root.req = attrs.get("req_id")
        self._opened()
        return root

    def finish(self, root, expected_spans: "int | None" = None) -> None:
        """Close the tree.  Any descendant still open is force-closed
        and counted in ``unclosed_spans`` — the smoke gate asserts this
        stays zero, so a leak is a taxonomy bug, not a silent drop.
        """
        if root is NULL_SPAN or not self.enabled:
            return
        n = 0                      # one walk: force-close AND count
        for s in root.walk():
            n += 1
            if s is not root and s.open:
                self.unclosed_spans += 1
                s.close()
        if root.open:
            root.close()
        if expected_spans is not None and n != expected_spans:
            self.shape_mismatches += 1
            if self.registry is not None:
                self.registry.counter("trace.lane_shape_mismatches").inc()
        if self.recorder is not None:
            self.recorder.completed(root)

    def stats(self) -> dict:
        return {"requests": self.requests,
                "sample_rate": self.sample_rate,
                "sampled": self.sampled,
                "sampled_out": self.sampled_out,
                "spans_opened": self.spans_opened,
                "spans_closed": self.spans_closed,
                "open_spans": self.open_spans,
                "unclosed_spans": self.unclosed_spans,
                "lane_shape_mismatches": self.shape_mismatches}
