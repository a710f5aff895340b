"""Placement ledger: per-pod lifecycle accounting from first-seen to
placement.  (Copy of ``karpenter_tpu/obs/ledger.py``.)

The span layer (obs/trace.py) records the causal chain of ONE
provisioning cycle; nothing there accounts a pod's WHOLE life — a pod
that rides three retry windows, gets parked behind a gang, or is
preempted and re-placed spans many traces.  The ledger closes that gap:
one bounded record per pending pod, stamped at every lifecycle edge
(first-seen, window-enqueue, solve-start, plan-decode, nomination,
registration, plus preempt/park/admit/release transitions), feeding

- ``karpenter_tpu_pod_placement_seconds{outcome}`` — the p99
  pod-to-placement SLO's source, observed at resolution;
- ``karpenter_tpu_pending_staleness_seconds{kind}`` — age of the oldest
  unresolved pod, and age of the cluster-state snapshot the last solve
  consumed when its plan decoded;
- a bounded worst-case table: the slowest resolutions with their trace
  ids, so ``/debug/slo`` links tail pods to retained flight-recorder
  bundles instead of leaving p99 an anonymous number.

Same design rules as the flight recorder:

- **Cheap on the hot path.**  A stamp is one dict lookup + one list
  append under a lock (~µs; tests/test_slo.py asserts the bound
  alongside the span bounds).  Records are small ``__slots__`` objects
  with a hard per-record stamp cap.
- **Bounded, errors never evicted by successes.**  Open records are
  capped (oldest evicted, counted in ``dropped_records`` and the
  ``karpenter_tpu_ledger_dropped_records_total`` counter); resolved
  records land in a preallocated success ring PLUS a separate ring for
  degraded/error outcomes, so one released gang survives an arbitrarily
  long streak of clean placements.
- **Deterministic under the chaos VirtualClock.**  Every stamp reads
  ``obs.now()`` (patched monotonic), so soak-run latencies are virtual
  seconds and seeded runs reproduce.
"""

from __future__ import annotations

import heapq
import threading

from karpenter_tpu_torch.obs.trace import current_span, now
from karpenter_tpu_torch.utils import metrics

# outcomes filed into the degraded/error retention ring (never evicted
# by clean placements)
ERROR_OUTCOMES = frozenset({"placed_degraded", "released", "failed"})


class PodRecord:
    """One pod's lifecycle.  ``stamps`` is an append-only (name, t) list
    bounded at MAX_STAMPS; ``flags`` records transitions that change the
    resolution outcome (gang release, preemption)."""

    __slots__ = ("key", "first_seen", "stamps", "trace_id", "flags",
                 "outcome", "resolved_at", "duration_s", "context")

    MAX_STAMPS = 24

    def __init__(self, key: str, first_seen: float):
        self.key = key
        self.first_seen = first_seen
        self.stamps: list[tuple[str, float]] = [("first_seen", first_seen)]
        self.trace_id = 0
        self.flags: set | None = None
        self.outcome = ""
        self.resolved_at = 0.0
        self.duration_s = 0.0
        self.context = ""

    def add_stamp(self, name: str, t: float, dedupe: bool = False) -> None:
        if dedupe and self.stamps and self.stamps[-1][0] == name:
            return
        if len(self.stamps) < self.MAX_STAMPS:
            self.stamps.append((name, t))

    def flag(self, name: str) -> None:
        if self.flags is None:
            self.flags = set()
        self.flags.add(name)

    def has_flag(self, name: str) -> bool:
        return self.flags is not None and name in self.flags

    def stamp_names(self) -> list[str]:
        return [n for n, _ in self.stamps]

    def to_dict(self) -> dict:
        return {
            "pod": self.key,
            "outcome": self.outcome,
            "trace_id": self.trace_id,
            "duration_s": round(self.duration_s, 6),
            "stamps": [(n, round(t - self.first_seen, 6))
                       for n, t in self.stamps],
            "context": self.context,
        }


class PlacementLedger:
    """Bounded per-pod lifecycle ledger (see module docstring)."""

    WORST_K = 16

    def __init__(self, capacity: int = 256, error_capacity: int = 128,
                 max_open: int = 8192, sample_capacity: int = 4096,
                 arrival_capacity: int = 16384):
        self.capacity = capacity
        self.error_capacity = error_capacity
        self.max_open = max_open
        self.sample_capacity = sample_capacity
        self.arrival_capacity = arrival_capacity
        self._lock = threading.Lock()
        self._open: dict[str, PodRecord] = {}
        # preallocated rings, written by index (the hot path never grows
        # a container) — success ring + separate degraded/error ring
        self._ring: list = [None] * capacity
        self._n_ring = 0
        self._err_ring: list = [None] * error_capacity
        self._n_err = 0
        # resolved-by-key index for post-resolution stamps
        # (registration lands after nomination resolved the record)
        self._resolved: dict[str, PodRecord] = {}
        # bounded resolution samples (t, duration, record) — the SLO
        # evaluator's burn-window source
        self._samples: list = [None] * sample_capacity
        self._n_samples = 0
        # min-heap of the WORST_K slowest resolutions: (duration, seq,
        # record) — seq breaks duration ties without comparing records
        self._worst: list[tuple[float, int, PodRecord]] = []
        self._worst_seq = 0
        self.dropped_records = 0
        self.resolved_total = 0
        self.outcome_counts: dict[str, int] = {}
        self.transition_counts: dict[str, int] = {}
        # staleness state
        self._last_snapshot_at = 0.0
        self._snapshot_staleness = 0.0
        self.staleness_high_water = 0.0
        self._context = ""
        # labeled spot lifecycle history (karpenter_tpu/stochastic/
        # risk.py learns per-(type, zone) interruption rates from it):
        # exposures = live-spot-instance scan rounds, interruptions =
        # observed spot preemptions, both stamped by the production
        # SpotPreemptionController from ground-truth cloud state
        self._spot_interrupted: dict[tuple[str, str], int] = {}
        self._spot_exposure: dict[tuple[str, str], int] = {}
        # arrival history ring (karpenter_tpu/whatif/forecast.py learns
        # per-signature-group arrival rates from it): one (signature
        # key, virtual hour-of-day) event per pod INTAKE, preallocated
        # and FIFO-bounded like every other ring.  Independent of the
        # record lifecycle by design — a pod that resolved, was evicted,
        # or was dropped from the open map STILL counts as an arrival
        # (demand happened whether or not its record survived).
        self._arrival_ring: list = [None] * arrival_capacity
        self._n_arrivals = 0

    # -- context -------------------------------------------------------------

    def set_context(self, name: str) -> None:
        """Label subsequent resolutions (the soak stamps its segment name
        so worst-case entries name which span bundle holds their trace)."""
        with self._lock:
            self._context = name

    # -- stamping ------------------------------------------------------------

    def first_seen(self, key: str, t: float | None = None) -> None:
        """Open a record (idempotent while the pod stays unresolved)."""
        t = now() if t is None else t
        with self._lock:
            if key in self._open:
                return
            if len(self._open) >= self.max_open:
                self._open.pop(next(iter(self._open)))
                self.dropped_records += 1
                metrics.LEDGER_DROPPED.inc()
            rec = self._open[key] = PodRecord(key, t)
            # context stamped at BIRTH, not just at resolution: an
            # unresolved (stranded) record must still name the segment
            # whose span bundle holds its causal chain
            rec.context = self._context

    def stamp(self, key: str, name: str, t: float | None = None,
              dedupe: bool = False) -> None:
        """Append a lifecycle stamp.  Falls through to the resolved
        index so post-resolution edges (bound, registered) land on the
        retained record instead of vanishing."""
        t = now() if t is None else t
        with self._lock:
            rec = self._open.get(key) or self._resolved.get(key)
            if rec is not None:
                rec.add_stamp(name, t, dedupe=dedupe)

    def stamp_many(self, keys, name: str, t: float | None = None) -> None:
        t = now() if t is None else t
        with self._lock:
            for key in keys:
                rec = self._open.get(key)
                if rec is not None:
                    rec.add_stamp(name, t)

    def link_trace(self, keys, trace_id: int) -> None:
        """Attach the fired window's trace id to every pod it carried —
        the link /debug/slo follows from a tail observation to its
        retained flight-recorder bundle."""
        with self._lock:
            for key in keys:
                rec = self._open.get(key)
                if rec is not None:
                    rec.trace_id = trace_id

    def solve_start(self, keys, t: float | None = None) -> None:
        """A solve cycle consumed these pods: stamp them, remember the
        cluster-state snapshot time, and refresh the staleness gauge."""
        t = now() if t is None else t
        with self._lock:
            for key in keys:
                rec = self._open.get(key)
                if rec is not None:
                    rec.add_stamp("solve_start", t)
            self._last_snapshot_at = t
            staleness = self._pending_staleness_locked(t)
        metrics.PENDING_STALENESS.labels("oldest_pod").set(staleness)

    def plan_decoded(self, keys, t: float | None = None) -> None:
        """The solve's plan decoded: the snapshot THIS plan consumed is
        now this old — the solver-staleness SLO's source.  The snapshot
        time is read from the decoded pods' own ``solve_start`` stamps,
        not the ledger-global last solve: under a deep dispatch/fetch
        pipeline (bench runs depth ~192) the global stamp belongs to a
        window far ahead of the one whose plan just landed."""
        t = now() if t is None else t
        with self._lock:
            snap = 0.0
            for key in keys:
                rec = self._open.get(key)
                if rec is not None:
                    rec.add_stamp("plan_decode", t)
                    for name, st in reversed(rec.stamps):
                        if name == "solve_start":
                            snap = max(snap, st)
                            break
            if not snap:
                snap = self._last_snapshot_at
            if snap:
                self._snapshot_staleness = max(0.0, t - snap)
                staleness = self._snapshot_staleness
            else:
                staleness = 0.0
        metrics.PENDING_STALENESS.labels("solve_snapshot").set(staleness)

    def transition(self, key: str, name: str,
                   t: float | None = None) -> None:
        """A non-terminal lifecycle edge (gang.park / gang.admit /
        gang.release / preempted).  Deduped against the record's last
        stamp so a 5s reconcile loop doesn't fill the stamp budget."""
        t = now() if t is None else t
        with self._lock:
            rec = self._open.get(key)
            if rec is None:
                return
            before = len(rec.stamps)
            rec.add_stamp(name, t, dedupe=True)
            if len(rec.stamps) != before:
                self.transition_counts[name] = \
                    self.transition_counts.get(name, 0) + 1
            if name == "gang.release":
                rec.flag("released_degraded")

    def unplaced(self, key: str, reason: str,
                 t: float | None = None) -> None:
        """A solve window left this pod unplaced for ``reason``
        (karpenter_tpu/explain canonical taxonomy).  Non-terminal — the
        record stays open for the retry loop — but each NEW verdict
        observes the pod's age-so-far into
        ``pod_placement_seconds{outcome="unplaced"}`` and stamps
        ``unplaced:<reason>`` (deduped, so a retry loop re-deciding the
        same reason every 15 s neither spams the histogram nor burns the
        record's stamp budget)."""
        t = now() if t is None else t
        name = f"unplaced:{reason}"
        with self._lock:
            rec = self._open.get(key)
            if rec is None:
                return
            before = len(rec.stamps)
            rec.add_stamp(name, t, dedupe=True)
            changed = len(rec.stamps) != before
            if changed:
                self.transition_counts[name] = \
                    self.transition_counts.get(name, 0) + 1
            age = max(0.0, t - rec.first_seen)
            tid = rec.trace_id
        if changed:
            metrics.POD_PLACEMENT.labels("unplaced").observe(
                age, exemplar={"trace_id": str(tid)} if tid else None)

    def reopen(self, key: str, reason: str, t: float | None = None) -> None:
        """A resolved pod re-entered the queue (preemption eviction):
        restart its placement clock — the re-placement is a fresh
        latency measurement, flagged so it resolves as ``replaced``."""
        t = now() if t is None else t
        with self._lock:
            if key in self._open:
                rec = self._open[key]
            else:
                if len(self._open) >= self.max_open:
                    self._open.pop(next(iter(self._open)))
                    self.dropped_records += 1
                    metrics.LEDGER_DROPPED.inc()
                rec = self._open[key] = PodRecord(key, t)
                rec.context = self._context
            rec.first_seen = t
            rec.add_stamp(reason, t)
            rec.flag(reason)
            self.transition_counts[reason] = \
                self.transition_counts.get(reason, 0) + 1

    def resolve(self, key: str, outcome: str = "placed",
                t: float | None = None, trace_id: int | None = None) -> None:
        """Terminal edge: observe the placement histogram, retain the
        record (error/degraded outcomes in their own ring), and keep the
        worst-K table current.  ``trace_id`` defaults to the ambient
        span's trace — the fired window that nominated the pod."""
        t = now() if t is None else t
        if trace_id is None:
            cur = current_span()
            trace_id = cur.trace_id if cur is not None else 0
        with self._lock:
            rec = self._open.pop(key, None)
            if rec is None:
                return
            if rec.has_flag("released_degraded") and outcome == "placed":
                outcome = "placed_degraded"
            elif rec.has_flag("preempted") and outcome == "placed":
                outcome = "replaced"
            if trace_id:
                rec.trace_id = trace_id
            rec.add_stamp("nominated" if outcome.startswith(
                ("placed", "replaced")) else outcome, t)
            rec.outcome = outcome
            rec.resolved_at = t
            rec.duration_s = max(0.0, t - rec.first_seen)
            rec.context = self._context
            self._retain_locked(rec)
        # OpenMetrics exemplar: a slow placement bucket links straight
        # to the deciding window's span bundle via /debug/traces
        metrics.POD_PLACEMENT.labels(outcome).observe(
            rec.duration_s,
            exemplar={"trace_id": str(rec.trace_id)} if rec.trace_id
            else None)

    def registered(self, key: str, t: float | None = None) -> None:
        """The claim a pod was nominated onto registered its node: the
        true end-to-end latency (decision + cloud create + boot +
        register), observed as a second histogram outcome."""
        t = now() if t is None else t
        with self._lock:
            rec = self._resolved.get(key) or self._open.get(key)
            if rec is None:
                return
            rec.add_stamp("registered", t, dedupe=True)
            elapsed = max(0.0, t - rec.first_seen)
            tid = rec.trace_id
        metrics.POD_PLACEMENT.labels("registered").observe(
            elapsed, exemplar={"trace_id": str(tid)} if tid else None)

    # -- spot lifecycle history (stochastic/risk.py) -------------------------

    def node_seen(self, itype: str, zone: str, n: int = 1) -> None:
        """One spot-exposure observation per live spot instance per scan
        round — the denominator of the learned interruption rate."""
        with self._lock:
            key = (itype, zone)
            self._spot_exposure[key] = self._spot_exposure.get(key, 0) + n

    def interruption(self, itype: str, zone: str, n: int = 1) -> None:
        """One observed spot preemption — the numerator.  Counted per
        instance (not per pod) so the rate is a per-node survival
        statistic, comparable across pod densities."""
        with self._lock:
            key = (itype, zone)
            self._spot_interrupted[key] = \
                self._spot_interrupted.get(key, 0) + n
        metrics.SPOT_INTERRUPTIONS.labels(itype, zone).inc(n)

    def interruption_history(self) -> dict:
        """{"interrupted": {(type, zone): n}, "exposure": ...} — the
        risk model's exact learning surface (copies; callers never see
        live dicts)."""
        with self._lock:
            return {"interrupted": dict(self._spot_interrupted),
                    "exposure": dict(self._spot_exposure)}

    def reset_interruption_history(self) -> None:
        """Chaos-harness hook: each seeded scenario starts from an empty
        history, so determinism-verify reruns in one process observe
        identical rates (the ledger is process-global)."""
        with self._lock:
            self._spot_interrupted.clear()
            self._spot_exposure.clear()

    # -- arrival history (whatif/forecast.py) --------------------------------

    def arrival(self, signature: str, t: float | None = None) -> None:
        """One pod-intake observation for a constraint-signature group
        (the same grouping key the encoder and the shard router use).
        Stamped at ``ClusterState.add_pod`` — the intake every path
        shares — into the bounded arrival ring, carrying the virtual
        hour-of-day (the diurnal axis) AND the absolute virtual hour
        (the recency axis the forecaster's rate EWMA walks)."""
        t = now() if t is None else t
        abs_hour = int(t // 3600.0)
        with self._lock:
            self._arrival_ring[self._n_arrivals % self.arrival_capacity] = \
                (signature, abs_hour % 24, abs_hour)
            self._n_arrivals += 1

    def arrival_history(self) -> dict[str, list[int]]:
        """Bounded per-(signature-group, virtual-hour) arrival count
        table — the forecaster's exact learning surface.  Aggregated
        from the FIFO ring, so counts only ever cover the last
        ``arrival_capacity`` intakes; resolution/eviction of the pod's
        lifecycle record never removes its arrival."""
        with self._lock:
            events = [e for e in self._arrival_ring if e is not None]
        table: dict[str, list[int]] = {}
        for sig, hour, _abs in events:
            row = table.get(sig)
            if row is None:
                row = table[sig] = [0] * 24
            row[hour] += 1
        return table

    def arrival_series(self) -> list[tuple[str, int]]:
        """(signature, absolute virtual hour) events in FIFO order —
        the chronological axis the forecaster's recency EWMA needs (the
        hour-of-day table above deliberately loses ordering)."""
        with self._lock:
            n = self._n_arrivals
            cap = self.arrival_capacity
            if n <= cap:
                ring = self._arrival_ring[:n]
            else:
                start = n % cap
                ring = self._arrival_ring[start:] \
                    + self._arrival_ring[:start]
        return [(e[0], e[2]) for e in ring if e is not None]

    @property
    def arrival_total(self) -> int:
        """Arrivals ever observed (monotonic; the ring retains the last
        ``arrival_capacity`` of them)."""
        with self._lock:
            return self._n_arrivals

    def reset_arrival_history(self) -> None:
        """Chaos-harness hook, like ``reset_interruption_history``:
        seeded scenarios (and the whatif determinism check) must learn
        from an empty table on every rerun in one process."""
        with self._lock:
            self._arrival_ring = [None] * self.arrival_capacity
            self._n_arrivals = 0

    # -- retention -----------------------------------------------------------

    def _retain_locked(self, rec: PodRecord) -> None:
        self.resolved_total += 1
        self.outcome_counts[rec.outcome] = \
            self.outcome_counts.get(rec.outcome, 0) + 1
        evicted = self._ring[self._n_ring % self.capacity]
        self._ring[self._n_ring % self.capacity] = rec
        self._n_ring += 1
        if rec.outcome in ERROR_OUTCOMES:
            self._err_ring[self._n_err % self.error_capacity] = rec
            self._n_err += 1
        self._resolved[rec.key] = rec
        if evicted is not None and \
                self._resolved.get(evicted.key) is evicted \
                and evicted.outcome not in ERROR_OUTCOMES:
            self._resolved.pop(evicted.key, None)
        while len(self._resolved) > self.capacity + self.error_capacity:
            self._resolved.pop(next(iter(self._resolved)))
        self._samples[self._n_samples % self.sample_capacity] = \
            (rec.resolved_at, rec.duration_s, rec)
        self._n_samples += 1
        self._worst_seq += 1
        entry = (rec.duration_s, self._worst_seq, rec)
        if len(self._worst) < self.WORST_K:
            heapq.heappush(self._worst, entry)
        elif rec.duration_s > self._worst[0][0]:
            heapq.heapreplace(self._worst, entry)

    # -- readout -------------------------------------------------------------

    def _pending_staleness_locked(self, t: float) -> float:
        if not self._open:
            return 0.0
        oldest = min(rec.first_seen for rec in self._open.values())
        staleness = max(0.0, t - oldest)
        if staleness > self.staleness_high_water:
            self.staleness_high_water = staleness
        return staleness

    def pending_staleness(self) -> float:
        """Age of the oldest unresolved pod, refreshed now (also updates
        the high-water mark the SLO evaluator reads)."""
        with self._lock:
            return self._pending_staleness_locked(now())

    def snapshot_staleness(self) -> float:
        with self._lock:
            return self._snapshot_staleness

    def get(self, key: str) -> PodRecord | None:
        with self._lock:
            return self._open.get(key) or self._resolved.get(key)

    def open_records(self, n: int | None = None) -> list[PodRecord]:
        """Currently-unresolved records, oldest first (the soak's
        day-end-drain violator table)."""
        with self._lock:
            recs = sorted(self._open.values(),
                          key=lambda r: r.first_seen)
        return recs if n is None else recs[:n]

    def worst(self, n: int = WORST_K) -> list[dict]:
        """The slowest resolutions, worst first, with trace ids — the
        /debug/slo tail table."""
        with self._lock:
            entries = sorted(self._worst, reverse=True)[:n]
        return [rec.to_dict() for _, _, rec in entries]

    def resolution_samples(self) -> list[tuple[float, float, PodRecord]]:
        """(resolved_at, duration_s, record) tuples, retention-bounded —
        the SLO burn-window source."""
        with self._lock:
            return [s for s in self._samples if s is not None]

    @property
    def sample_count(self) -> int:
        with self._lock:
            return self._n_samples

    def rebase_recent(self, since: int, delta: float) -> None:
        """Shift the resolution timestamps of samples recorded at index
        >= ``since`` by ``delta``.  The soak runs each segment on its
        own VirtualClock (all anchored near the same real monotonic
        base, so raw stamps OVERLAP instead of concatenating); rebasing
        each segment's samples onto a cumulative day offset gives the
        burn-window evaluator one coherent, monotonic timeline."""
        with self._lock:
            lo = max(since, self._n_samples - self.sample_capacity)
            for i in range(lo, self._n_samples):
                s = self._samples[i % self.sample_capacity]
                if s is not None:
                    t, d, rec = s
                    self._samples[i % self.sample_capacity] = \
                        (t + delta, d, rec)
                    rec.resolved_at = t + delta

    def durations(self, outcome: str | None = None) -> list[float]:
        return [d for _, d, rec in self.resolution_samples()
                if outcome is None or rec.outcome == outcome]

    def stats(self) -> dict:
        with self._lock:
            return {
                "open_records": len(self._open),
                "resolved_total": self.resolved_total,
                "retained": sum(1 for r in self._ring if r is not None),
                "error_retained": sum(1 for r in self._err_ring
                                      if r is not None),
                "dropped_records": self.dropped_records,
                "arrivals": self._n_arrivals,
                "outcomes": dict(self.outcome_counts),
                "transitions": dict(self.transition_counts),
                "staleness_high_water_s":
                    round(self.staleness_high_water, 6),
                "snapshot_staleness_s":
                    round(self._snapshot_staleness, 6),
            }
