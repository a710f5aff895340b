"""Spans + flight recorder: the causal record of a provisioning cycle.
(Copy of ``karpenter_tpu/obs/trace.py``.)

Dependency-free tracing for the pod-event -> batch -> solve -> actuate ->
cloud-RPC path.  Three design constraints shape everything here:

- **Cheap on the hot path.**  A span is one small ``__slots__`` object;
  completed traces land in a *preallocated* ring-buffer slot (the list
  itself never grows), and retroactive phase spans (``Tracer.record``)
  cost one allocation + one slot write — no context-manager machinery on
  the solver's timing path.  tests/test_obs.py asserts the per-span
  bound.
- **Deterministic under the chaos VirtualClock.**  Every timestamp is
  read through ``now()``, which resolves ``time.monotonic`` at CALL time
  — the chaos harness patches the ``time`` module attributes
  (chaos/clock.py), so scenario spans carry virtual durations and the
  span dump of a seeded run is structurally reproducible.  Span/trace
  ids come from a per-tracer counter, never ``uuid``/``random``.
- **Bounded memory, errors never evicted by success.**  The flight
  recorder retains the last N completed traces in one ring and every
  trace that ended in error in a SEPARATE ring — a hot success path
  cannot flush the one failed cycle an operator needs to see.

Context propagation uses a ``contextvars.ContextVar``: spans opened on
the same thread of control nest automatically (the window handler, the
solve, the actuation, and each cloud RPC attempt all run synchronously
on the fired window's executor thread).  Cross-thread hand-off (the
pipelined solve's dispatch vs. fetch) passes the parent span explicitly.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time


def now() -> float:
    """Monotonic clock read at call time — the chaos VirtualClock patches
    ``time.monotonic``, so scenario spans run on virtual time."""
    return time.monotonic()


_CURRENT: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "karpenter_tpu_span", default=None)


def current_span() -> "Span | None":
    return _CURRENT.get()


class Span:
    """One timed operation.  Doubles as its own context manager so the
    common path (``with tracer.span(...)``) allocates exactly one object.

    ``attrs``/``events`` are lazy — a bare span allocates neither."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "end", "status", "error", "attrs", "events",
                 "_tracer", "_token")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: int, name: str, start: float,
                 attrs: dict | None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = start
        self.end = 0.0
        self.status = "ok"
        self.error = ""
        self.attrs = attrs
        self.events = None
        self._tracer = tracer
        self._token = None

    # -- mutation ----------------------------------------------------------

    def set(self, key: str, value) -> None:
        if self.attrs is None:
            self.attrs = {}
        self.attrs[key] = value

    def event(self, name: str, **fields) -> None:
        if self.events is None:
            self.events = []
        if len(self.events) < 64:      # bounded: events must not grow a trace
            self.events.append({"name": name, "t": now(), **fields})

    def fail(self, error) -> None:
        """Mark failed without an exception propagating through the span
        (handlers that convert exceptions into per-caller results)."""
        self.status = "error"
        self.error = str(error)[:200]

    @property
    def duration_s(self) -> float:
        return max(0.0, self.end - self.start)

    # -- context manager ----------------------------------------------------

    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, et, ev, tb) -> bool:
        if et is not None:
            self.status = "error"
            self.error = f"{et.__name__}: {ev}"[:200]
        self.end = now()
        if self._token is not None:
            _CURRENT.reset(self._token)
            self._token = None
        self._tracer._finish(self)
        return False


class FlightRecorder:
    """Bounded in-memory retention of completed traces.

    Two preallocated rings (fixed-size lists written by index — the hot
    path never grows a container): ``capacity`` recent traces regardless
    of status, plus ``error_capacity`` traces that ended in error, so
    failures survive an arbitrarily long success streak.  Parentless
    instant spans (pod events, breaker transitions) go to a third small
    ring rather than each becoming a one-span trace."""

    MAX_SPANS_PER_TRACE = 1000
    MAX_OPEN_TRACES = 256

    def __init__(self, capacity: int = 64, error_capacity: int = 32,
                 instant_capacity: int = 256,
                 telemetry_capacity: int = 256):
        self.capacity = capacity
        self.error_capacity = error_capacity
        self.instant_capacity = instant_capacity
        self.telemetry_capacity = telemetry_capacity
        self._lock = threading.Lock()
        # preallocated slots; _n_* monotonically count writes
        self._ring: list = [None] * capacity
        self._n_ring = 0
        self._err_ring: list = [None] * error_capacity
        self._n_err = 0
        self._instants: list = [None] * instant_capacity
        self._n_instants = 0
        # per-window solver-quality telemetry (obs/telemetry_words):
        # decoded slot dicts, one per solve window, same preallocated-
        # ring discipline as spans — /debug/telemetry reads this
        self._telemetry: list = [None] * telemetry_capacity
        self._n_telemetry = 0
        # trace_id -> [spans] completed so far (root still open)
        self._open: dict[int, list] = {}
        # trace_id -> finalized trace tuple, insertion-ordered and
        # bounded: late spans (a pipelined drain finishing after its
        # window's root closed) attach here instead of re-opening a
        # stale _open entry that no root would ever finalize
        self._finalized: dict[int, tuple] = {}
        self.dropped_spans = 0
        # wall/monotonic anchor pair: exports convert monotonic span
        # times to an absolute-ish display timeline
        self.anchor_monotonic = now()
        self.anchor_wall = time.time()

    # -- ingestion ----------------------------------------------------------

    def _drop_locked(self) -> None:
        """Bounded-memory drop accounting: the process counter AND the
        scrapeable karpenter_tpu_recorder_dropped_spans_total series (a
        recorder silently shedding evidence is itself an SLO signal).
        Lazy import: utils.metrics' package __init__ imports the
        batcher, which imports obs — a module-top import here would
        re-enter this module half-built."""
        self.dropped_spans += 1
        from karpenter_tpu_torch.utils import metrics

        metrics.RECORDER_DROPPED.inc()

    def add(self, span: Span) -> None:
        """A span completed.  Root completion finalizes the trace into a
        ring slot; non-root spans accumulate under their open trace."""
        with self._lock:
            spans = self._open.get(span.trace_id)
            if spans is None:
                done = self._finalized.get(span.trace_id)
                if done is not None:
                    # late arrival for a finalized trace: attach to its
                    # span list (still referenced by the ring tuple) so
                    # readouts see it.  The trace's status is already
                    # sealed — a late error span doesn't re-file it into
                    # the error ring.
                    if len(done[3]) < self.MAX_SPANS_PER_TRACE:
                        done[3].append(span)
                    else:
                        self._drop_locked()
                    return
                if len(self._open) >= self.MAX_OPEN_TRACES:
                    # a leaked (never-closed) root must not grow memory
                    self._open.pop(next(iter(self._open)))
                    self._drop_locked()
                spans = self._open[span.trace_id] = []
            if len(spans) >= self.MAX_SPANS_PER_TRACE:
                self._drop_locked()
            else:
                spans.append(span)
            if span.parent_id == 0:
                self._finalize_locked(span.trace_id, spans, span)

    def add_instant(self, span: Span) -> None:
        with self._lock:
            self._instants[self._n_instants % self.instant_capacity] = span
            self._n_instants += 1

    def add_telemetry(self, entry: dict) -> None:
        """One decoded solve window's telemetry slots (a plain dict,
        obs/telemetry_words.record_window) into the bounded ring."""
        with self._lock:
            self._telemetry[self._n_telemetry
                            % self.telemetry_capacity] = entry
            self._n_telemetry += 1

    def _finalize_locked(self, trace_id: int, spans: list,
                         root: Span) -> None:
        self._open.pop(trace_id, None)
        status = "error" if any(s.status == "error" for s in spans) \
            else root.status
        trace = (trace_id, status, root, spans)
        self._ring[self._n_ring % self.capacity] = trace
        self._n_ring += 1
        if status == "error":
            self._err_ring[self._n_err % self.error_capacity] = trace
            self._n_err += 1
        self._finalized[trace_id] = trace
        while len(self._finalized) > self.capacity + self.error_capacity:
            self._finalized.pop(next(iter(self._finalized)))

    # -- readout -------------------------------------------------------------

    def traces(self) -> list:
        """(trace_id, status, root, spans) tuples, newest first; error-ring
        traces included (deduped) so they outlive the recent ring."""
        with self._lock:
            recent = [t for t in self._ring if t is not None]
            errors = [t for t in self._err_ring if t is not None]
        seen = set()
        out = []
        for t in sorted(recent + errors,
                        key=lambda t: t[2].start, reverse=True):
            if t[0] not in seen:
                seen.add(t[0])
                out.append(t)
        return out

    def instants(self) -> list:
        with self._lock:
            return [s for s in self._instants if s is not None]

    def telemetry(self) -> list:
        """Retained telemetry entries in write order (oldest first)."""
        with self._lock:
            n, cap = self._n_telemetry, self.telemetry_capacity
            if n <= cap:
                return [e for e in self._telemetry[:n] if e is not None]
            start = n % cap
            return (self._telemetry[start:] + self._telemetry[:start])

    def stats(self) -> dict:
        with self._lock:
            retained = sum(1 for t in self._ring if t is not None)
            return {
                "traces_retained": retained,
                "traces_total": self._n_ring,
                "error_traces_retained": sum(1 for t in self._err_ring
                                             if t is not None),
                "error_traces_total": self._n_err,
                "instants_total": self._n_instants,
                "telemetry_windows_total": self._n_telemetry,
                "telemetry_retained": sum(1 for e in self._telemetry
                                          if e is not None),
                "open_traces": len(self._open),
                "dropped_spans": self.dropped_spans,
                "capacity": self.capacity,
                "error_capacity": self.error_capacity,
                "ring_occupancy": round(retained / self.capacity, 4)
                if self.capacity else 0.0,
            }


class Tracer:
    """Span factory bound to one recorder.  Ids are a plain counter —
    deterministic for seeded runs, and cheap."""

    def __init__(self, recorder: FlightRecorder | None = None):
        self.recorder = recorder or FlightRecorder()
        self._ids = itertools.count(1)   # .__next__ is atomic under the GIL

    # -- span creation -------------------------------------------------------

    def span(self, name: str, *, start: float | None = None,
             parent: Span | None = None, **attrs) -> Span:
        """Open a span (use as a context manager).  ``parent`` overrides
        the ambient context (cross-thread hand-off); ``start`` backdates
        (the batch window starts when its first item enqueued)."""
        if parent is None:
            parent = _CURRENT.get()
        sid = next(self._ids)
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = sid, 0
        return Span(self, trace_id, sid, parent_id, name,
                    now() if start is None else start, attrs or None)

    def record(self, name: str, start: float, end: float, *,
               parent: Span | None = None, status: str = "ok",
               error: str = "", **attrs) -> Span:
        """Retroactive span from already-measured timestamps — the hot
        solve path's shape: time with two clock reads, then record once
        (one allocation, one preallocated ring-slot write)."""
        if parent is None:
            parent = _CURRENT.get()
        sid = next(self._ids)
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = sid, 0
        sp = Span(self, trace_id, sid, parent_id, name, start, attrs or None)
        sp.end = end
        sp.status = status
        sp.error = error
        if parent_id == 0:
            self.recorder.add_instant(sp) if end == start \
                else self.recorder.add(sp)
        else:
            self.recorder.add(sp)
        return sp

    def instant(self, name: str, **attrs) -> None:
        """Zero-duration marker.  Attaches as an event to the active span
        when one exists, else lands in the recorder's instant ring (pod
        arrivals, breaker flips — signals with no enclosing operation)."""
        cur = _CURRENT.get()
        if cur is not None:
            cur.event(name, **attrs)
            return
        t = now()
        sid = next(self._ids)
        sp = Span(self, sid, sid, 0, name, t, attrs or None)
        sp.end = t
        self.recorder.add_instant(sp)

    # -- internals -----------------------------------------------------------

    def _finish(self, span: Span) -> None:
        self.recorder.add(span)
