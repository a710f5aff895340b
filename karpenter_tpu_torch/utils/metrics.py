"""Dependency-free Prometheus-style metric registry (copy of
``karpenter_tpu/utils/metrics.py``: the same families under the same
names, so a scrape of either package reads alike).

Parity with the reference's 11 metric families (pkg/metrics/metrics.go:24-117)
plus autoplacement metrics (autoplacement/metrics.go:81).  Exposes counters,
gauges, and histograms with labels, and a ``render()`` that emits Prometheus
text exposition format so the numbers are scrapeable without client libs.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Sequence

_DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
                    2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0, 600.0)

_registry_lock = threading.Lock()
_registry: list["_Metric"] = []


class _Child:
    __slots__ = ("_metric", "_labels")

    def __init__(self, metric: "_Metric", labels: tuple[str, ...]):
        self._metric = metric
        self._labels = labels

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._labels, amount)

    def dec(self, amount: float = 1.0) -> None:
        self._metric._inc(self._labels, -amount)

    def set(self, value: float) -> None:
        self._metric._set(self._labels, value)

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        self._metric._observe(self._labels, value, exemplar)

    def get(self) -> float:
        return self._metric._get(self._labels)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()
        self._values: dict[tuple[str, ...], float] = {}
        with _registry_lock:
            _registry.append(self)

    def labels(self, *label_values: str) -> _Child:
        if len(label_values) != len(self.label_names):
            raise ValueError(f"{self.name}: expected {len(self.label_names)} labels, "
                             f"got {len(label_values)}")
        return _Child(self, tuple(str(v) for v in label_values))

    # default (no-label) passthroughs
    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def observe(self, value: float, exemplar: dict | None = None) -> None:
        self.labels().observe(value, exemplar)

    def get(self, *label_values: str) -> float:
        return self._get(tuple(str(v) for v in label_values))

    def _inc(self, labels, amount):
        with self._lock:
            self._values[labels] = self._values.get(labels, 0.0) + amount

    def _set(self, labels, value):
        with self._lock:
            self._values[labels] = value

    def _observe(self, labels, value, exemplar=None):
        raise TypeError(f"{self.kind} does not support observe()")

    def _get(self, labels):
        with self._lock:
            return self._values.get(labels, 0.0)

    def remove(self, *label_values: str) -> None:
        """Drop one label series (gauges tracking per-object state must
        not leak series after the object is deleted)."""
        with self._lock:
            self._values.pop(tuple(str(v) for v in label_values), None)

    def samples(self):
        with self._lock:
            return dict(self._values)

    def reset(self):
        with self._lock:
            self._values.clear()

    def _render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} {self.kind}"]
        for labels, value in sorted(self.samples().items()):
            lines.append(f"{self.name}{_fmt_labels(self.label_names, labels)} {value}")
        return lines

    def _render_om(self) -> list[str]:
        """OpenMetrics-flavored lines (exemplar-bearing families
        override); identical to the plain text render by default."""
        return self._render()


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names, values, extra: str = "") -> str:
    parts = [f'{n}="{_escape(v)}"' for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    kind = "counter"

    def _render_om(self) -> list[str]:
        """OpenMetrics counter shape: the FAMILY is named without the
        ``_total`` suffix and samples carry it back — a strict
        OpenMetrics parser (Prometheus with exemplar scraping on)
        rejects a TYPE line whose family name ends in _total, failing
        the whole scrape."""
        family = self.name[:-len("_total")] \
            if self.name.endswith("_total") else self.name
        lines = [f"# HELP {family} {self.help}",
                 f"# TYPE {family} counter"]
        for labels, value in sorted(self.samples().items()):
            lines.append(f"{family}_total"
                         f"{_fmt_labels(self.label_names, labels)} {value}")
        return lines


class Gauge(_Metric):
    kind = "gauge"


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}
        # OpenMetrics exemplars: LAST exemplar per (labelset, bucket) —
        # cardinality is bounded by len(buckets)+1 per labelset BY
        # CONSTRUCTION (tests/test_prof.py pins it); the plain text
        # render never shows them (content negotiation only)
        self._exemplars: dict[tuple, tuple[dict, float, float]] = {}

    def _observe(self, labels, value, exemplar=None):
        with self._lock:
            counts = self._counts.setdefault(labels, [0] * len(self.buckets))
            idx = next((j for j, b in enumerate(self.buckets) if value <= b), None)
            if idx is not None:
                counts[idx] += 1
            self._sums[labels] = self._sums.get(labels, 0.0) + value
            self._totals[labels] = self._totals.get(labels, 0) + 1
            if exemplar:
                self._exemplars[(labels,
                                 len(self.buckets) if idx is None
                                 else idx)] = \
                    (dict(exemplar), float(value), time.time())

    def _get(self, labels):
        with self._lock:
            return float(self._totals.get(labels, 0))

    def sum(self, *label_values: str) -> float:
        with self._lock:
            return self._sums.get(tuple(str(v) for v in label_values), 0.0)

    def count(self, *label_values: str) -> int:
        with self._lock:
            return self._totals.get(tuple(str(v) for v in label_values), 0)

    def reset(self):
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()
            self._exemplars.clear()

    def _render(self, exemplars: bool = False) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            items = [(lv, list(c), self._sums.get(lv, 0.0), self._totals.get(lv, 0))
                     for lv, c in self._counts.items()]
            ex = dict(self._exemplars) if exemplars else {}
        for labels, counts, s, total in sorted(items):
            cum = 0
            for j, (b, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                le = f'le="{b}"'
                lines.append(f"{self.name}_bucket"
                             f"{_fmt_labels(self.label_names, labels, le)} {cum}"
                             + _fmt_exemplar(ex.get((labels, j))))
            le_inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(self.label_names, labels, le_inf)} {total}"
                         + _fmt_exemplar(ex.get((labels, len(self.buckets)))))
            lines.append(f"{self.name}_sum{_fmt_labels(self.label_names, labels)} {s}")
            lines.append(f"{self.name}_count{_fmt_labels(self.label_names, labels)} {total}")
        return lines

    def _render_om(self) -> list[str]:
        return self._render(exemplars=True)


def _fmt_exemplar(ex: tuple[dict, float, float] | None) -> str:
    """OpenMetrics exemplar suffix: `` # {trace_id="7"} value ts`` —
    empty when no exemplar is attached to the bucket."""
    if ex is None:
        return ""
    lbls, value, ts = ex
    lset = ",".join(f'{k}="{_escape(str(v))}"' for k, v in lbls.items())
    return f" # {{{lset}}} {value} {round(ts, 3)}"


def render() -> str:
    """Prometheus text exposition of every registered metric."""
    with _registry_lock:
        metrics_ = list(_registry)
    out: list[str] = []
    for m in metrics_:
        out.extend(m._render())
    return "\n".join(out) + "\n"


def render_openmetrics() -> str:
    """Exemplar-bearing OpenMetrics-flavored exposition: the SAME
    families and sample lines as :func:`render`, plus histogram bucket
    exemplars (`` # {trace_id="..."} value ts``) and the ``# EOF``
    terminator.  Served by the metrics server under content negotiation
    (``Accept: application/openmetrics-text``); the plain text render
    is byte-for-byte unchanged — exemplars never leak into it
    (tests/test_prof.py pins both)."""
    with _registry_lock:
        metrics_ = list(_registry)
    out: list[str] = []
    for m in metrics_:
        out.extend(m._render_om())
    out.append("# EOF")
    return "\n".join(out) + "\n"


def reset_all() -> None:
    with _registry_lock:
        for m in _registry:
            m.reset()


# ---------------------------------------------------------------------------
# The reference's metric families (pkg/metrics/metrics.go:24-117), renamed to
# this project's prefix.
# ---------------------------------------------------------------------------

API_REQUESTS = Counter(
    "karpenter_tpu_api_requests_total",
    "Cloud API requests by service, operation, status",
    ("service", "operation", "status"))
PROVISIONING_DURATION = Histogram(
    "karpenter_tpu_provisioning_duration_seconds",
    "Instance provisioning duration",
    ("instance_type", "zone", "status"))
COST_PER_HOUR = Gauge(
    "karpenter_tpu_cost_per_hour",
    "Hourly cost of provisioned capacity",
    ("instance_type", "zone", "capacity_type"))
QUOTA_UTILIZATION = Gauge(
    "karpenter_tpu_quota_utilization",
    "Quota utilization ratio", ("resource", "region"))
INSTANCE_LIFECYCLE = Counter(
    "karpenter_tpu_instance_lifecycle_total",
    "Instance lifecycle events", ("event", "instance_type", "zone"))
ERRORS = Counter(
    "karpenter_tpu_errors_total",
    "Errors by component and kind", ("component", "kind"))
TIMEOUT_ERRORS = Counter(
    "karpenter_tpu_timeout_errors_total",
    "Timeout errors by component", ("component",))
DRIFT_DETECTIONS = Counter(
    "karpenter_tpu_drift_detections_total",
    "Drift detections by reason", ("reason",))
DRIFT_DETECTION_DURATION = Histogram(
    "karpenter_tpu_drift_detection_duration_seconds",
    "Drift check duration", ())
BATCH_WINDOW_SECONDS = Histogram(
    "karpenter_tpu_batcher_batch_time_seconds",
    "Age of fired batch windows", ("batcher",))
BATCH_SIZE = Histogram(
    "karpenter_tpu_batcher_batch_size",
    "Items per fired batch", ("batcher",),
    buckets=(1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 10000))
RECONCILE_DURATION = Histogram(
    "karpenter_tpu_reconcile_duration_seconds",
    "Controller reconcile latency", ("controller",))

# Solver-specific families (new in the TPU build).
SOLVE_DURATION = Histogram(
    "karpenter_tpu_solve_duration_seconds",
    "End-to-end placement solve latency", ("backend",))
SOLVE_PODS = Histogram(
    "karpenter_tpu_solve_pods",
    "Pods per solve window", ("backend",),
    buckets=(1, 10, 100, 1000, 10000, 100000))
SOLVE_COST = Gauge(
    "karpenter_tpu_solve_plan_cost_per_hour",
    "Hourly cost of the last plan", ("backend",))
SOLVE_PATH = Counter(
    "karpenter_tpu_solve_path_total",
    "Device solves by kernel path (pallas vs lax.scan fallback) — makes "
    "silent pallas-viability fallbacks observable", ("path",))
SOLVE_D2H_BYTES = Histogram(
    "karpenter_tpu_solve_d2h_bytes",
    "Device->host result bytes per solve", ("backend",),
    buckets=(1 << 10, 1 << 13, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24))
# Solve phases live in a bimodal ms-scale regime (BENCH_r05: sub-ms
# compute vs exec_fetch ~70 ms and encode_cold ~105-117 ms).  The old
# ladder jumped 0.05 -> 0.1 -> 0.25, flattening the entire 50-250 ms
# band — where the DOMINANT costs live — into two buckets, so p99 was a
# bucket edge, not a measurement.  Dense coverage over 10-250 ms;
# boundaries are pinned by tests/test_slo.py::TestBucketTuning.
SOLVE_PHASE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005,
    0.01, 0.02, 0.035, 0.05, 0.065, 0.08, 0.1, 0.13, 0.17,
    0.25, 0.5, 1.0, 2.5)
# Pod-to-placement spans batching windows (seconds) through retry loops
# (minutes): sub-second decision latency still resolves, and the tail
# reaches the chaos soak's virtual-hours regime without saturating +Inf.
POD_PLACEMENT_BUCKETS = (
    0.005, 0.025, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
    60.0, 120.0, 300.0, 600.0, 1800.0, 3600.0)
SOLVE_PHASE = Histogram(
    "karpenter_tpu_solve_phase_seconds",
    "Per-phase solve latency: encode (host encode+pack), h2d (H2D upload "
    "+ kernel dispatch), compute (device execute + D2H await — not "
    "separable through the async fetch without an extra round trip), "
    "d2h (host-side result unpack/decode).  Fed from the SAME "
    "measurements as the obs span layer so the two agree.", ("phase",),
    buckets=SOLVE_PHASE_BUCKETS)
# Preemption plane (karpenter_tpu/preempt + controllers/preemption.py).
PREEMPTIONS = Counter(
    "karpenter_tpu_preemptions_total",
    "Pod evictions executed by the preemption plane, by reason "
    "(priority = a higher-priority pending pod took the capacity)",
    ("reason",))
PREEMPTION_CANDIDATES = Histogram(
    "karpenter_tpu_preemption_candidates",
    "Victim pods considered per preemption plan",
    (), buckets=(1, 10, 50, 100, 500, 1000, 5000, 10000, 100000))
PREEMPTION_PLAN_DURATION = Histogram(
    "karpenter_tpu_preemption_plan_seconds",
    "Preemption plan latency (encode victims + batched solve)",
    ("backend",))
# Gang plane (karpenter_tpu/gang + controllers/gang.py).
GANG_ADMISSIONS = Counter(
    "karpenter_tpu_gang_admissions_total",
    "Gang admission outcomes: admitted (min_member reached), "
    "released_degraded (deadline expired sub-min_member; members fell "
    "back to per-pod scheduling)",
    ("outcome",))
GANG_PLACEMENTS = Counter(
    "karpenter_tpu_gang_placements_total",
    "Gangs placed atomically by the gang plane, by backend",
    ("backend",))
GANG_PARKED = Gauge(
    "karpenter_tpu_gang_parked",
    "Gangs currently parked out of the provision queue awaiting "
    "min_member", ())
GANG_MEMBERS = Histogram(
    "karpenter_tpu_gang_members",
    "Members per admitted gang",
    (), buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024))
GANG_PLAN_DURATION = Histogram(
    "karpenter_tpu_gang_plan_seconds",
    "Gang placement plan latency (encode + batched slice grid)",
    ("backend",))
# Repack plane (karpenter_tpu/repack + controllers/disruption.py).
REPACK_PLAN_DURATION = Histogram(
    "karpenter_tpu_repack_plan_seconds",
    "Fleet repack plan latency (encode from the resident occupancy "
    "substrate + batched LP-relaxed scoring grid + integral rounding), "
    "by planner backend (device / vector / greedy / degraded:*)",
    ("backend",))
REPACK_MIGRATIONS = Counter(
    "karpenter_tpu_repack_migrations_total",
    "Pod migrations executed by the repack plane, by kind (consolidate "
    "= source node fully drained and deleted; defrag = chip-consuming "
    "singletons vacated so a parked gang slice reopens)",
    ("kind",))
REPACK_SLICES_REOPENED = Counter(
    "karpenter_tpu_repack_slices_reopened_total",
    "Parked gang slice shapes newly fitting an accelerator node after a "
    "defrag migration vacated its singleton chips", ())
REPACK_SAVINGS_FRACTION = Gauge(
    "karpenter_tpu_repack_savings_fraction",
    "Savings fraction of the most recent actuated repack migration plan "
    "(drained node cost / fleet cost at plan time)", ())
# Sharded continuous-solve service (karpenter_tpu/sharded/).
SHARDED_SOLVES = Counter(
    "karpenter_tpu_sharded_solves_total",
    "Sharded solve windows by mode (device = one stacked shard_map "
    "dispatch over the shard mesh; degraded = per-shard host fallback "
    "after a failed dispatch)", ("mode",))
SHARD_BACKLOG = Gauge(
    "karpenter_tpu_shard_backlog_pods",
    "Pending pods owned per shard at the last admitted window (the "
    "pressure column the rebalance collective keys on)", ("shard",))
SHARD_MIGRATIONS = Counter(
    "karpenter_tpu_shard_migrations_total",
    "Signature-group ownership migrations executed by the cross-shard "
    "rebalance collective", ())
SHARD_REBALANCE_SKEW = Gauge(
    "karpenter_tpu_shard_rebalance_skew_pods",
    "Pod-count skew (max - min over shards) the last rebalance "
    "collective observed, before its migrations applied", ())
SHARDED_SOLVE_DURATION = Histogram(
    "karpenter_tpu_sharded_solve_seconds",
    "Wall latency of one sharded solve window (route + encode + "
    "stacked dispatch + per-shard decode), by mode", ("mode",))
# What-if planning plane (karpenter_tpu/whatif): forecast-driven
# scenario evaluation as one extra batch dimension over the solver.
WHATIF_SCENARIOS = Counter(
    "karpenter_tpu_whatif_scenarios_total",
    "Scenarios evaluated by the planning service, by mode (device = "
    "the stacked vmapped dispatch; host = the scenario-at-a-time "
    "oracle loop, including degraded fallbacks)", ("mode",))
WHATIF_PLAN_DURATION = Histogram(
    "karpenter_tpu_whatif_plan_seconds",
    "Wall latency of one whatif planning pass (forecast + scenario "
    "lowering + stacked dispatch + decode + ranking), by mode",
    ("mode",))
WHATIF_RECOMMENDATIONS = Gauge(
    "karpenter_tpu_whatif_recommendations",
    "Capacity-action recommendations currently held in the bounded "
    "audit registry (positive SLO-risk averted per dollar)", ())
WHATIF_HORIZON_RISK = Gauge(
    "karpenter_tpu_whatif_horizon_risk",
    "Unplaced pods the last planning pass projected for each standing "
    "action-free scenario over the horizon (cardinality bounded by the "
    "standing menu: baseline, forecast peak, one threat per chaos "
    "knob)", ("scenario",))
# SLO ledger plane (karpenter_tpu/obs/ledger.py + obs/slo.py).
POD_PLACEMENT = Histogram(
    "karpenter_tpu_pod_placement_seconds",
    "End-to-end pod lifecycle latency by outcome: placed (first-seen -> "
    "nominated), placed_degraded (same, after a gang deadline release), "
    "replaced (re-placement after a preemption eviction), registered "
    "(first-seen -> the nominated claim's node registered).  Tail "
    "observations carry their trace id in the ledger so /debug/slo "
    "links worst-case pods to retained flight-recorder bundles.",
    ("outcome",), buckets=POD_PLACEMENT_BUCKETS)
PENDING_STALENESS = Gauge(
    "karpenter_tpu_pending_staleness_seconds",
    "Staleness by kind: oldest_pod (age of the oldest unresolved pod in "
    "the placement ledger), solve_snapshot (age of the cluster-state "
    "snapshot the last solve consumed when its plan was decoded)",
    ("kind",))
RECORDER_DROPPED = Counter(
    "karpenter_tpu_recorder_dropped_spans_total",
    "Spans the flight recorder dropped to stay bounded (open-trace cap, "
    "span-per-trace cap, late arrivals past the cap)", ())
LEDGER_DROPPED = Counter(
    "karpenter_tpu_ledger_dropped_records_total",
    "Pod lifecycle records the placement ledger dropped to stay bounded "
    "(open-record cap; errors are retained in a separate ring and never "
    "evicted by successes)", ())

# Explainability plane (karpenter_tpu/explain): why unplaced pods are
# unplaced.  UNPLACED_REASONS is the label ALLOWLIST — the reason-label
# cardinality bound, and one of the three reason enumerations graftlint
# GL108 keeps drift-free (the others: explain.REASON_BITS and
# explain.LADDER).  Keep it a pure tuple literal: GL108 reads it from
# the AST.
UNPLACED_REASONS = (
    "insufficient_cpu",
    "insufficient_mem",
    "insufficient_accel",
    "insufficient_pods",
    "requirements",
    "taints",
    "zone_affinity",
    "zone_blackout",
    "availability",
    "preemption_budget",
    "gang_geometry",
    "gang_parked",
    "priority_starved",
    "capacity_higher_prio",
    "capacity_exhausted",
    "overcommit_risk",
    "affinity_unsatisfied",
    "spread_bound",
)
# Affinity plane (karpenter_tpu/affinity): pod-to-pod (anti-)affinity
# and topology-spread as dense constraint tensors.
AFFINITY_EDGES = Gauge(
    "karpenter_tpu_affinity_edges",
    "Inter-group (anti-)affinity edges armed in the last encoded window "
    "(required + anti, both topology scopes; zero for edge-free windows "
    "— the plane never activates)", ())
AFFINITY_COMPONENTS = Gauge(
    "karpenter_tpu_affinity_components",
    "Multi-group affinity components in the last encoded window "
    "(union-find over armed edges and bounded spread classes; the "
    "sharded router co-routes each component to one shard)", ())
AFFINITY_SPREAD_AVOIDED = Counter(
    "karpenter_tpu_affinity_spread_violations_avoided_total",
    "Pods the decode choke point clamped off a node because placing "
    "them would have exceeded a hostname topology-spread bound "
    "(affinity/enforce.py; each clamp returns pods to unplaced with "
    "the spread_bound explain bit)", ())
UNPLACED_PODS = Gauge(
    "karpenter_tpu_unplaced_pods",
    "Pods currently unplaced by canonical explain reason "
    "(karpenter_tpu/explain: most-specific-wins fold of the per-group "
    "elimination bitmask the solve computes on device).  Label "
    "cardinality is bounded by the UNPLACED_REASONS allowlist; every "
    "reason renders (0 when empty) so counts never linger.", ("reason",))

# Solver-quality telemetry plane (karpenter_tpu/obs/telemetry_words.py):
# per-window quality slots computed ON DEVICE inside the solve dispatch
# and decoded from the packed result's telemetry suffix
# (solver/result_layout.py).  "plane" label = the solve lane that
# produced the window (scan, pref, batch, pallas, resident, sharded,
# stochastic, whatif) — bounded cardinality by construction.
SOLVE_QUALITY_FILL = Gauge(
    "karpenter_tpu_solve_quality_fill_fraction",
    "Fleet fill fraction of the last solved window per plane and "
    "resource (placed request demand over open-node capacity, decoded "
    "from the device-computed basis-point telemetry slot)",
    ("plane", "resource"))
SOLVE_QUALITY_SLACK = Gauge(
    "karpenter_tpu_solve_quality_slack_fraction",
    "Per-open-node remaining-capacity fraction of the last solved "
    "window per plane: min / mean over open nodes of the per-node "
    "min-over-resources slack", ("plane", "stat"))
SOLVE_QUALITY_COUNT = Gauge(
    "karpenter_tpu_solve_quality_count",
    "Placement-shape counts of the last solved window per plane: "
    "nodes_open, groups_placed, groups_unplaced, pods_unplaced, "
    "binding_groups (chance-constraint binding, stochastic lanes)",
    ("plane", "kind"))
SOLVE_QUALITY_WINDOWS = Counter(
    "karpenter_tpu_solve_quality_windows_total",
    "Solve windows whose telemetry suffix was decoded and recorded, "
    "per plane", ("plane",))
SOLVE_QUALITY_ESCALATIONS = Counter(
    "karpenter_tpu_solve_quality_escalations_total",
    "Host-side solve retries per plane and kind (node = node-axis "
    "escalation re-dispatch, coo = COO-bucket growth re-dispatch) — "
    "the host-sourced telemetry slots, also fed to the watchdog's "
    "escalation-burst detector", ("plane", "kind"))

# Device telemetry (karpenter_tpu/obs/devtel.py): direct instrumentation
# for the device-resident-state refactor (ROADMAP item 1).
JIT_RECOMPILES = Counter(
    "karpenter_tpu_jit_recompiles_total",
    "Executable-cache misses per kernel and constraint-signature bucket: "
    "a dispatch whose static-shape signature (path, G, O, U, N, output "
    "layout) was never seen by this process implies an XLA trace+compile",
    ("kernel", "bucket"))
EXEC_CACHE = Counter(
    "karpenter_tpu_executable_cache_events_total",
    "Solve dispatches by executable-cache outcome (hit = signature "
    "already compiled this process); hit/(hit+miss) is the cache ratio "
    "surfaced on /statusz and /debug/slo", ("event",))
TRANSFER_BYTES = Counter(
    "karpenter_tpu_device_transfer_bytes_total",
    "Host<->device payload bytes moved by the live solve path, by "
    "direction (h2d includes packed problem uploads and catalog tensor "
    "re-uploads; d2h is fetched result buffers)", ("direction",))
SOLVE_H2D_BYTES = Histogram(
    "karpenter_tpu_solve_h2d_bytes",
    "Host->device packed-problem bytes per solve window", ("backend",),
    buckets=(1 << 10, 1 << 13, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24))
DONATION_MISSES = Counter(
    "karpenter_tpu_donation_misses_total",
    "Dispatches whose input buffer was a fresh host array (re-uploaded, "
    "not donated device-resident state) — the transfer-overhead debt the "
    "device-resident refactor pays down, counted per call site", ("site",))

# Resident state store (karpenter_tpu/resident/): per-window outcome of
# the delta-encoded incremental solve path (docs/design/resident.md)
RESIDENT_WINDOWS = Counter(
    "karpenter_tpu_resident_windows_total",
    "Solve windows through the resident state store by outcome: hit "
    "(unchanged window, zero-delta dispatch), delta (compact update "
    "tensors), rebuild (full re-upload)", ("mode",))
RESIDENT_REBUILDS = Counter(
    "karpenter_tpu_resident_rebuilds_total",
    "Resident-state rebuilds by reason (cold, generation = catalog/"
    "availability bump, shape = padded-bucket change, delta_too_large, "
    "degraded_* = degraded-mode invalidation, nodepool_edit)", ("reason",))
RESIDENT_DELTA_BYTES = Histogram(
    "karpenter_tpu_resident_delta_bytes",
    "Host->device bytes one resident window actually moved (the padded "
    "delta pair on warm windows; the full packed buffer on rebuilds)",
    (), buckets=(256, 1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18,
                 1 << 20, 1 << 22))

# Serving loop (karpenter_tpu/serving/): the persistent device-resident
# solve service — ring-fed windows, double-buffered fetch overlap
# (docs/design/serving.md)
SERVING_WINDOWS = Counter(
    "karpenter_tpu_serving_windows_total",
    "Windows through the serving loop by route: hit/delta/rebuild (ring-"
    "fed — the resident ladder), classic (ineligible window, unchanged "
    "single-shot dispatch), backpressure (ring full -> classic "
    "fallback), host_failover (device fault at kick/fetch -> classic "
    "re-solve; the window is never lost)", ("mode",))
SERVING_RING_OCCUPANCY = Gauge(
    "karpenter_tpu_serving_ring_occupancy",
    "In-flight un-fetched output-ring slots (kicked windows whose "
    "result D2H is overlapping later compute); capacity-bounded — at "
    "capacity the next window backpressures to classic dispatch", ())
SERVING_BACKPRESSURE = Counter(
    "karpenter_tpu_serving_backpressure_total",
    "Windows refused by a full serving ring and re-routed to classic "
    "per-window dispatch (explicit flow control, never a drop)", ())
SERVING_OVERLAP = Gauge(
    "karpenter_tpu_serving_overlap_fraction",
    "Fraction of fetched serving windows whose result D2H overlapped a "
    "later window's kicked compute (the double-buffer contract; 0 = "
    "fully serialized, the single-shot RTT floor)", ())

# Stochastic packing plane (karpenter_tpu/stochastic/): chance-
# constrained oversubscription + spot-risk-aware placement
# (docs/design/stochastic.md).
OVERCOMMIT_SOLVES = Counter(
    "karpenter_tpu_overcommit_solves_total",
    "Chance-constrained solve dispatches by mode: stochastic (the "
    "quantile-check kernel ran), degraded (the kernel failed and the "
    "window fell back to deterministic requests)", ("mode",))
OVERCOMMIT_Z = Gauge(
    "karpenter_tpu_overcommit_z_score",
    "z(epsilon) multiplier of the most recent stochastic dispatch — the "
    "variance-buffer strength the violation-probability bound implies "
    "(0 when the plane never dispatched)", ())
SPOT_INTERRUPTIONS = Counter(
    "karpenter_tpu_spot_risk_interruptions_total",
    "Observed spot interruptions per (instance_type, zone) — the "
    "ledger-derived history the spot risk model learns from "
    "(karpenter_tpu/stochastic/risk.py); cardinality bounded by the "
    "catalog (types x zones)", ("instance_type", "zone"))
SPOT_RISK_RATE = Gauge(
    "karpenter_tpu_spot_risk_rate",
    "Learned spot-interruption rate per (instance_type, zone): observed "
    "interruptions / exposures in [0, 1]; priced into offering RANKING "
    "as rank * (1 + lambda * rate) — real cost accounting never moves",
    ("instance_type", "zone"))

# Device profiling plane (karpenter_tpu/obs/prof.py + obs/watchdog.py):
# sampled device-time attribution + anomaly-triggered triage bundles
# (docs/design/profiling.md).
DEVICE_TIME = Histogram(
    "karpenter_tpu_device_time_seconds",
    "Sampled decomposition of the async dispatch->result wall per "
    "kernel: dispatch (host launch until the call returns), execute "
    "(block_until_ready after launch — true device execution), fetch "
    "(device->host copy of the result).  Fed by the profiler's "
    "synchronization brackets (every Nth dispatch per kernel), which "
    "the host-side solve_phase histograms structurally cannot "
    "decompose under async dispatch.", ("kernel", "phase"),
    buckets=SOLVE_PHASE_BUCKETS)
PROF_SAMPLES = Counter(
    "karpenter_tpu_prof_samples_total",
    "Sampled (synchronized) dispatches per kernel — the denominator "
    "context for device_time_seconds", ("kernel",))
PROF_OVERHEAD = Gauge(
    "karpenter_tpu_prof_overhead_fraction",
    "Profiler self-overhead: the sampled brackets' extra fetch wall "
    "over the estimated total dispatch wall (steady-state gate <1%, "
    "asserted in tests and surfaced on /statusz)", ())
WATCHDOG_BREACHES = Counter(
    "karpenter_tpu_watchdog_breaches_total",
    "Anomaly-watchdog breaches by kernel and phase (phase 'recompile' "
    "= a jit-recompile burst inside the rolling window; others = a "
    "sampled duration far outside its EWMA baseline)",
    ("kernel", "phase"))
TRIAGE_BUNDLES = Counter(
    "karpenter_tpu_triage_bundles_total",
    "Triage bundles written to the .triage/ directory by trigger "
    "(slow_kernel, recompile_burst, slo_burn)", ("trigger",))
WATCHDOG_SUPPRESSED = Counter(
    "karpenter_tpu_watchdog_suppressed_total",
    "Breaches whose triage bundle was suppressed by the rate limit, "
    "by trigger", ("trigger",))

# Device-fault survivability plane (karpenter_tpu/faulttol,
# docs/design/faulttol.md): health-gated dispatch with deadlines and
# host failover.
DEVICE_HEALTH = Gauge(
    "karpenter_tpu_device_health",
    "Per-device health state machine position: 0=healthy 1=suspect "
    "2=quarantined 3=probation (faulttol/health.py)", ("device",))
DEVICE_DEADLINE_EXCEEDED = Counter(
    "karpenter_tpu_device_dispatch_deadline_exceeded_total",
    "Dispatches whose dispatch->fetch wall blew the profiler-EWMA "
    "deadline (real or injected hang), per kernel — each one failed "
    "over to the host oracle for its plane", ("kernel",))
DEVICE_FAILOVERS = Counter(
    "karpenter_tpu_device_failovers_total",
    "Shard-mesh failovers by reason (device_failover = quarantine "
    "remapped the mesh onto survivors, device_recovered = a healed "
    "device rejoined)", ("reason",))
DEVICE_QUARANTINES = Counter(
    "karpenter_tpu_device_quarantines_total",
    "Health-board transitions into quarantined, per device (each one "
    "also writes a watchdog triage bundle)", ("device",))

# Crash-recovery plane: write-ahead intent journal + restart reconciler
# (karpenter_tpu/recovery, docs/design/recovery.md).
JOURNAL_RECORDS = Counter(
    "karpenter_tpu_journal_records_total",
    "Write-ahead journal records appended, by record type (intent = "
    "durable pre-RPC intent, note = staged-RPC progress, done = "
    "completion, state = newest-wins control-plane state)", ("rec",))
JOURNAL_OPEN_INTENTS = Gauge(
    "karpenter_tpu_journal_open_intents",
    "Intents currently open (written ahead of an actuation whose "
    "completion record has not landed); nonzero across a restart means "
    "the reconciler has replay work", ())
JOURNAL_COMPACTIONS = Counter(
    "karpenter_tpu_journal_compactions_total",
    "Journal compaction rewrites (bounded-file guarantee)", ())
JOURNAL_BYTES = Gauge(
    "karpenter_tpu_journal_bytes",
    "On-disk journal size after the last flush/compaction", ())
RECOVERY_DURATION = Histogram(
    "karpenter_tpu_recovery_seconds",
    "Restart recovery latency by phase: replay (journal read), fence "
    "(open-intent resolution + state rebuild against ground truth)",
    ("phase",))
RECOVERY_INTENTS = Counter(
    "karpenter_tpu_recovery_intents_total",
    "Open intents resolved on restart, by kind and outcome (finished = "
    "completed against ground truth, fenced = leftovers deleted / state "
    "released, error = the recovery action itself failed and was left "
    "to the orphan/GC backstops)", ("kind", "outcome"))

LEADER = Gauge(
    "karpenter_tpu_leader",
    "1 when this replica holds the named leader-election lease", ("lease",))
CB_STATE = Gauge(
    "karpenter_tpu_circuit_breaker_state",
    "Circuit breaker state per (nodeclass, region): 0=closed 1=open "
    "2=half-open", ("nodeclass", "region"))

BUILD_INFO = Gauge(
    "karpenter_tpu_build_info",
    "Always 1; the labels carry build identity (version, solver backend, "
    "jax platform) — join other series against it in dashboards",
    ("version", "backend", "platform"))


def record_build_info(backend: str = "", platform: str = "") -> None:
    """Render the build_info series (idempotent — the series is keyed by
    its labels, and stale label sets are dropped so a backend change
    never leaves two '1' rows).  ``platform`` defaults to the device
    type the port would run on ("cuda" with a card, else "cpu")."""
    import os

    if not platform:
        try:
            import torch

            platform = "cuda" if torch.cuda.is_available() else "cpu"
        except Exception:  # noqa: BLE001 — identity must never fail boot
            platform = "unknown"
    BUILD_INFO.reset()
    BUILD_INFO.labels(os.environ.get("KARPENTER_TPU_VERSION", "dev"),
                      backend or "unknown", platform).set(1.0)


# Autoplacement families (autoplacement/metrics.go:81).
AUTOPLACEMENT_SELECTIONS = Counter(
    "karpenter_tpu_autoplacement_selections_total",
    "Autoplacement selection runs", ("kind", "status"))
AUTOPLACEMENT_DURATION = Histogram(
    "karpenter_tpu_autoplacement_duration_seconds",
    "Autoplacement selection latency", ("kind",))
