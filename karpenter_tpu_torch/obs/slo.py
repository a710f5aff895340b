"""Declarative SLOs + burn-rate evaluation over the placement ledger.

An :class:`SLOSpec` is pure data (no YAML): an objective key into a
measurement snapshot, a threshold, and a burn window.  The evaluator
compares each spec against measurements assembled from the placement
ledger (obs/ledger.py), the flight recorder, and device telemetry, and
renders a burn-rate report that NAMES the violating pods and the trace
bundles holding their causal chains — a failed SLO gate hands the
operator evidence, not a number.

Consumers:

- ``make soak`` (chaos/soak.py) — the simulated-production-day gate:
  composes chaos profiles on the VirtualClock and fails the run on any
  burned SLO;
- ``/debug/slo`` (operator/server.py) — the live readout, same
  evaluator, default specs;
- ``bench.py`` — emits :func:`slo_summary` into the trajectory JSON so
  the bench files gain p99/staleness columns.

(Copy of ``karpenter_tpu/obs/slo.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.obs.ledger import PlacementLedger
from karpenter_tpu_torch.obs.trace import FlightRecorder, now


def quantile(xs: list[float], q: float) -> float:
    """Nearest-rank quantile (deterministic, no interpolation jitter)."""
    if not xs:
        return 0.0
    s = sorted(xs)
    idx = min(len(s) - 1, max(0, int(q * len(s) + 0.999999) - 1))
    return s[idx]


@dataclass(frozen=True)
class SLOSpec:
    """One service-level objective.  ``objective`` keys into the
    measurement snapshot; ``comparison`` is "le" (value must stay at or
    under threshold) or "ge"."""

    name: str
    objective: str
    threshold: float
    burn_window_s: float = 600.0
    comparison: str = "le"
    description: str = ""

    def ok(self, value: float) -> bool:
        return value >= self.threshold if self.comparison == "ge" \
            else value <= self.threshold


@dataclass
class Measurement:
    """One objective's evidence: the headline value, optional
    (timestamp, value) samples for burn-rate windows, and the violator
    table (pods + trace ids) shown when the SLO burns."""

    value: float
    samples: list[tuple[float, float]] = field(default_factory=list)
    violators: list[dict] = field(default_factory=list)


@dataclass
class SLOResult:
    spec: SLOSpec
    value: float
    ok: bool
    # windowed violating fraction (or value/threshold for scalar gauges)
    burn_rate: float
    violators: list[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "slo": self.spec.name,
            "objective": self.spec.objective,
            "threshold": self.spec.threshold,
            "comparison": self.spec.comparison,
            "value": round(self.value, 6),
            "ok": self.ok,
            "burn_rate": round(self.burn_rate, 4),
            "burn_window_s": self.spec.burn_window_s,
            "violators": self.violators,
        }


@dataclass
class SLOReport:
    results: list[SLOResult]

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def burned(self) -> list[SLOResult]:
        return [r for r in self.results if not r.ok]

    def to_dict(self) -> dict:
        return {"ok": self.ok,
                "burned": [r.spec.name for r in self.burned],
                "results": [r.to_dict() for r in self.results]}

    def render(self) -> str:
        lines = []
        for r in self.results:
            mark = "ok  " if r.ok else "BURN"
            lines.append(
                f"{mark} {r.spec.name:<28} {r.spec.objective}="
                f"{r.value:.4g} (threshold {r.spec.comparison} "
                f"{r.spec.threshold:g}, burn_rate {r.burn_rate:.2f})")
            for v in ([] if r.ok else r.violators[:5]):
                lines.append(
                    f"       pod={v.get('pod', '?')} "
                    f"took={v.get('duration_s', 0):.3f}s "
                    f"trace_id={v.get('trace_id', 0)}"
                    + (f" bundle={v['bundle']}" if v.get("bundle") else ""))
        status = "ALL SLOS MET" if self.ok else \
            f"{len(self.burned)} SLO(S) BURNED"
        lines.append(f"slo report: {status}")
        return "\n".join(lines)


def evaluate_slos(specs: list[SLOSpec],
                  measurements: dict[str, Measurement],
                  at: float | None = None) -> SLOReport:
    """Compare every spec against its measurement.  A missing objective
    evaluates as a burn (value NaN-ish via -inf/inf would hide bugs;
    an SLO nobody measures is a failed SLO, loudly)."""
    at = now() if at is None else at
    results = []
    for spec in specs:
        m = measurements.get(spec.objective)
        if m is None:
            results.append(SLOResult(
                spec=spec, value=float("inf"), ok=False, burn_rate=1.0,
                violators=[{"pod": f"<objective {spec.objective!r} "
                                   f"not measured>", "trace_id": 0}]))
            continue
        ok = spec.ok(m.value)
        if m.samples:
            cutoff = at - spec.burn_window_s
            windowed = [(t, v) for t, v in m.samples if t >= cutoff] \
                or m.samples
            bad = sum(1 for _, v in windowed if not spec.ok(v))
            burn = bad / len(windowed)
        else:
            burn = 0.0 if ok else (
                m.value / spec.threshold if spec.threshold > 0
                and spec.comparison == "le" else 1.0)
        results.append(SLOResult(spec=spec, value=m.value, ok=ok,
                                 burn_rate=round(burn, 4),
                                 violators=list(m.violators)))
    return SLOReport(results=results)


# ---------------------------------------------------------------------------
# Measurement assembly
# ---------------------------------------------------------------------------

# (real perf_counter stamp, cached value) — /debug/slo is scraped by
# dashboards; re-running a 2000-iteration busy loop per request would
# make the observability endpoint the overhead it measures
_OVERHEAD_CACHE: list = [0.0, 0.0]
_OVERHEAD_TTL_S = 60.0


def measure_recorder_overhead_us(samples: int = 2000,
                                 max_age_s: float = _OVERHEAD_TTL_S
                                 ) -> float:
    """Per-stamp cost of the telemetry hot path (one ledger stamp + one
    retroactive span), measured with ``perf_counter`` — which the chaos
    VirtualClock deliberately does NOT patch, so the overhead SLO stays
    a real-microseconds gate even inside a virtual-time soak.  Cached
    for ``max_age_s`` real seconds (pass 0 to force a fresh run)."""
    from karpenter_tpu_torch.obs.trace import Tracer

    measured_at, cached = _OVERHEAD_CACHE
    if cached and time.perf_counter() - measured_at < max_age_s:
        return cached
    ledger = PlacementLedger(capacity=8, error_capacity=8)
    tracer = Tracer(FlightRecorder(capacity=8, error_capacity=8))
    ledger.first_seen("overhead-probe")
    t_now = now()
    t0 = time.perf_counter()
    for _ in range(samples):
        ledger.stamp("overhead-probe", "window_enqueue")
        tracer.record("solve.h2d", t_now, t_now + 0.001)
    per = (time.perf_counter() - t0) / samples
    value = per * 1e6 / 2.0         # two operations per iteration
    _OVERHEAD_CACHE[0] = time.perf_counter()
    _OVERHEAD_CACHE[1] = value
    return value


def ledger_measurements(ledger: PlacementLedger,
                        recorder: FlightRecorder | None = None,
                        extra: dict[str, Measurement] | None = None,
                        threshold_hint: float | None = None,
                        measure_overhead: bool = True
                        ) -> dict[str, Measurement]:
    """The standard measurement snapshot the default SLOs evaluate:

    - ``pod_placement_p99_s``: nearest-rank p99 over retained
      resolutions, violators = the ledger's worst-case table (trace ids
      attached), filtered to entries over ``threshold_hint`` when given;
    - ``pending_staleness_s``: the staleness HIGH-WATER mark (a gauge
      sampled only at quiet moments would lie about the worst case);
    - ``degraded_rate``: degraded/released resolutions over all
      resolutions (gang releases, degraded placements);
    - ``recorder_overhead_us``: measured per-stamp cost (real µs);
    - ``recorder_dropped_fraction``: spans dropped / spans retained+dropped.
    """
    samples = ledger.resolution_samples()
    durations = [d for _, d, _ in samples]
    p99 = quantile(durations, 0.99)
    worst = ledger.worst()
    if threshold_hint is not None:
        over = [w for w in worst if w["duration_s"] > threshold_hint]
        worst = over or worst[:3]
    stats = ledger.stats()
    ledger.pending_staleness()      # refresh the high-water mark
    resolved = max(1, stats["resolved_total"])
    degraded = sum(n for outcome, n in stats["outcomes"].items()
                   if outcome in ("placed_degraded", "released", "failed"))
    out = {
        "pod_placement_p99_s": Measurement(
            value=p99,
            samples=[(t, d) for t, d, _ in samples],
            violators=worst),
        "pending_staleness_s": Measurement(
            value=ledger.staleness_high_water),
        "degraded_rate": Measurement(
            value=degraded / resolved,
            violators=[r.to_dict() for _, _, r in samples
                       if r.outcome in ("placed_degraded", "released",
                                        "failed")][:8]),
    }
    if measure_overhead:
        out["recorder_overhead_us"] = Measurement(
            value=measure_recorder_overhead_us())
    if recorder is not None:
        rstats = recorder.stats()
        kept = max(1, rstats["traces_total"] + rstats["instants_total"])
        out["recorder_dropped_fraction"] = Measurement(
            value=rstats["dropped_spans"] / kept)
    if extra:
        out.update(extra)
    return out


def telemetry_measurements() -> dict[str, Measurement]:
    """Solver-quality measurements from the device telemetry words
    (obs/telemetry_words: the per-window slots every solve plane emits
    inside its fused dispatch), aggregated over the recorder's bounded
    telemetry ring:

    - ``telemetry_escalations_per_window``: node-escalation + COO-growth
      re-dispatches per recorded window across all planes — a healthy
      day re-dispatches rarely; a chronically escalating one is sized
      wrong;
    - ``telemetry_min_fill_fraction``: the lowest per-plane mean fill
      fraction over retained windows, planes with fewer than 8 windows
      skipped (too few samples to call a collapse).  Open nodes exist
      because pods landed on them, so a healthy FFD keeps this well
      above the floor; a collapse is a solver-quality regression, the
      same signal the watchdog's EWMA detector fires on live.
    """
    from karpenter_tpu_torch.obs import telemetry_words

    s = telemetry_words.summary()
    planes = s.get("planes", {})
    windows = sum(p["windows"] for p in planes.values())
    esc = sum(p["escalations"] + p["coo_growths"]
              for p in planes.values())
    meaningful = {name: p for name, p in planes.items()
                  if p["windows"] >= 8}
    fills = [p["mean_fill_fraction"] for p in meaningful.values()]
    return {
        "telemetry_escalations_per_window": Measurement(
            value=esc / windows if windows else 0.0),
        "telemetry_min_fill_fraction": Measurement(
            value=min(fills) if fills else 1.0,
            violators=[{"pod": f"<plane {name}: mean_fill="
                               f"{p['mean_fill_fraction']:.4f} over "
                               f"{p['windows']} windows>",
                        "trace_id": 0}
                       for name, p in sorted(meaningful.items(),
                                             key=lambda kv:
                                             kv[1]["mean_fill_fraction"])
                       ][:5]),
    }


# The production-day gate (chaos/soak.py) — thresholds in VIRTUAL
# seconds for the latency/staleness objectives (soak rounds advance the
# clock 60s per beat; three beats of queueing is the budget), and real
# microseconds for the overhead gate.
DEFAULT_SOAK_SLOS: tuple[SLOSpec, ...] = (
    SLOSpec(name="p99-pod-to-placement", objective="pod_placement_p99_s",
            threshold=3600.0, burn_window_s=7200.0,
            description="99% of pods get a placement decision within 1 "
                        "virtual hour of first-seen — pods stranded "
                        "behind the overload quota legitimately wait "
                        "~1-2 quiesce beats (1200s each); a pod that "
                        "needs MORE than an hour is a stuck plane, not "
                        "a busy one"),
    SLOSpec(name="pending-staleness", objective="pending_staleness_s",
            threshold=7200.0, burn_window_s=7200.0,
            description="no pod waits unresolved past 2 virtual hours "
                        "(high-water, not a quiet-moment sample)"),
    SLOSpec(name="degraded-mode-rate", objective="degraded_rate",
            threshold=0.25, burn_window_s=3600.0,
            description="under 25% of resolutions ride a degraded path "
                        "(gang release / degraded placement)"),
    SLOSpec(name="recorder-overhead", objective="recorder_overhead_us",
            threshold=75.0,
            description="ledger stamp + span record stay at the "
                        "microsecond bound tests pin (real time, "
                        "measured inside the soak)"),
    SLOSpec(name="recorder-drops", objective="recorder_dropped_fraction",
            threshold=0.5,
            description="the flight recorder keeps at least half of "
                        "what it is asked to retain"),
)

# Fixture: provably impossible — the soak evaluates it on EVERY run and
# fails unless it burns, showing a real violation fails the gate (an SLO
# harness that cannot fail is decoration).  Threshold -1 so even an
# all-zero-latency day (every pod resolved within its arrival beat of
# the VirtualClock) still burns it: p99 >= 0 > -1 always.
BROKEN_FIXTURE_SLO = SLOSpec(
    name="broken-fixture", objective="pod_placement_p99_s",
    threshold=-1.0, description="deliberately unmeetable: any measured "
                                "p99 (>= 0) burns it")


def slo_summary(ledger: PlacementLedger,
                specs: tuple[SLOSpec, ...] = DEFAULT_SOAK_SLOS) -> dict:
    """Compact summary block for bench trajectory JSON / statusz: the
    p99/staleness columns plus per-SLO pass state."""
    durations = ledger.durations()
    # the overhead gate is a real-time microbenchmark — skip it for the
    # summary path (bench runs it as its own target elsewhere)
    cheap = [s for s in specs
             if s.objective not in ("recorder_overhead_us",
                                    "recorder_dropped_fraction")]
    report = evaluate_slos(
        cheap, ledger_measurements(ledger, measure_overhead=False))
    return {
        "pod_placement_p50_s": round(quantile(durations, 0.50), 6),
        "pod_placement_p99_s": round(quantile(durations, 0.99), 6),
        "pending_staleness_s": round(ledger.staleness_high_water, 6),
        "snapshot_staleness_s": round(ledger.snapshot_staleness(), 6),
        "resolved": ledger.stats()["resolved_total"],
        "slos": {r.spec.name: r.ok for r in report.results},
    }


def debug_slo_payload(ledger: PlacementLedger,
                      recorder: FlightRecorder | None = None,
                      devtel=None) -> dict:
    """The ``/debug/slo`` endpoint body: live evaluation of the default
    specs, the worst-case pod table (trace ids link into
    ``/debug/traces``), ledger stats, and the device-telemetry
    snapshot."""
    report = evaluate_slos(
        list(DEFAULT_SOAK_SLOS),
        ledger_measurements(ledger, recorder=recorder))
    if devtel is None:
        from karpenter_tpu_torch.obs.devtel import get_devtel

        devtel = get_devtel()
    return {
        "report": report.to_dict(),
        "worst_pods": ledger.worst(),
        "ledger": ledger.stats(),
        "pending_staleness_s": round(ledger.pending_staleness(), 6),
        "device_telemetry": devtel.snapshot(),
    }
