"""`make soak`: a simulated production day with SLO gates.

Composes EXISTING chaos profiles into one day-shaped sequence on the
VirtualClock — diurnal load ramps (pods_per_wave scaled per segment),
a midday overload peak, an afternoon spot storm, evening gang waves —
with ONE placement ledger accounting every pod across all segments.
At the end the ledger is evaluated against the declarative SLO specs
(obs/slo.py); a burned SLO fails the run with a burn-rate report that
names the violating pods and the span bundle holding each one's causal
chain.

The gate is proven honest on EVERY run: a deliberately-unmeetable
fixture SLO (threshold 0) is evaluated alongside the real ones and the
soak fails unless that fixture actually burns — an SLO harness that
cannot fail is decoration, not a gate.

Latency thresholds are VIRTUAL seconds: scenario rounds advance the
clock 60 s per beat and quiesce beats 1200 s, so a pod stranded behind
the overload quota until recovery legitimately shows a multi-virtual-
hour placement.  The recorder-overhead gate deliberately uses
``perf_counter`` (unpatched) so it stays a real-microseconds bound.

Port of ``karpenter_tpu/chaos/soak.py``: every segment's harness runs
its device planes on ``device`` ("cuda" unless the caller asks for the
CPU).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.chaos.clock import VirtualClock
from karpenter_tpu_torch.chaos.profile import get_profile
from karpenter_tpu_torch.chaos.runner import ChaosHarness
from karpenter_tpu_torch.obs.export import dump_jsonl, recorder_to_dicts
from karpenter_tpu_torch.obs.ledger import PlacementLedger
from karpenter_tpu_torch.obs.slo import (
    BROKEN_FIXTURE_SLO, DEFAULT_SOAK_SLOS, Measurement, SLOReport, SLOSpec,
    evaluate_slos, ledger_measurements, slo_summary,
    telemetry_measurements,
)


@dataclass(frozen=True)
class SoakSegment:
    """One stretch of the production day: an existing chaos profile run
    for ``rounds`` beats with its wave size scaled by ``load``."""

    profile: str
    rounds: int
    load: float = 1.0


# The production day (full soak): calm overnight state, morning ramp of
# API flake, midday overload peak (quota + mixed priorities), afternoon
# spot storm, evening gang waves, load tapering off.
PRODUCTION_DAY: tuple[SoakSegment, ...] = (
    SoakSegment("calm", 3, 0.5),
    SoakSegment("flaky-api", 4, 0.8),
    SoakSegment("overload", 6, 1.5),
    SoakSegment("spot-storm", 6, 1.2),
    SoakSegment("gang", 6, 1.0),
    SoakSegment("calm", 3, 0.4),
)

# CI-sized short profile (the `slow`-marked job): same composition,
# fewer beats.  The overload peak runs 5 rounds at 2x load against the
# 10-instance quota — enough beats for the seeded fault schedule to
# strand pods across rounds and trigger the preemption plane (verified:
# ~8 preemptions, placements up to ~21 virtual minutes), so the CI
# day's latency gates see real nonzero samples.  A soak whose every pod
# places within its arrival beat measures p99 = 0 and can never burn;
# tests/test_slo.py pins the non-vacuousness.
SHORT_DAY: tuple[SoakSegment, ...] = (
    SoakSegment("calm", 2, 0.5),
    SoakSegment("overload", 5, 2.0),
    SoakSegment("spot-storm", 3, 1.0),
    SoakSegment("gang", 3, 1.0),
)

# Extends the default specs with the day-end drain gate: every pod the
# day produced must have resolved (virtual hours of quiesce are part of
# the day — a pod still open at the end is stranded, not merely slow).
SOAK_SLOS: tuple[SLOSpec, ...] = DEFAULT_SOAK_SLOS + (
    SLOSpec(name="day-end-drain", objective="unresolved_pods",
            threshold=0.0,
            description="no pod is still unresolved when the production "
                        "day ends (stranding, not latency)"),
    # solver-quality gates from the device telemetry words
    # (obs/telemetry_words): what the solver itself measured about its
    # windows, not a host recomputation
    SLOSpec(name="telemetry-escalation-rate",
            objective="telemetry_escalations_per_window", threshold=2.0,
            description="device solve windows re-dispatch (node "
                        "escalation / COO growth) at most twice per "
                        "window on average — chronic escalation means "
                        "the bucket ladders are sized wrong for the "
                        "day's load"),
    SLOSpec(name="telemetry-fill-floor",
            objective="telemetry_min_fill_fraction", threshold=0.05,
            comparison="ge",
            description="no plane's mean fill fraction collapses below "
                        "5% over its retained windows (open nodes exist "
                        "because pods landed on them — a collapse is a "
                        "packing regression, the soak twin of the "
                        "watchdog's live EWMA detector)"),
)


@dataclass
class SoakResult:
    segments: list[dict]
    report: SLOReport
    gate_proven: bool              # the broken fixture SLO really burned
    summary: dict
    ledger_stats: dict
    chaos_violations: int
    report_path: str = ""
    # triage bundle auto-written on a burned day (obs/watchdog.py);
    # empty when the day passed (or the write failed)
    triage_bundle: str = ""

    @property
    def ok(self) -> bool:
        return self.chaos_violations == 0 and self.report.ok \
            and self.gate_proven


def _scaled(profile, load: float, shard_count: int = 0,
            serving: bool = False):
    lo, hi = profile.pods_per_wave
    kwargs = {"pods_per_wave": (max(1, round(lo * load)),
                                max(1, round(hi * load)))}
    if shard_count:
        # `make soak-sharded-short`: the WHOLE day runs with the
        # sharded continuous-solve plane armed (shadow service + the
        # shards-converge invariant every pump) — the SLO gates are
        # unchanged; a shard-state divergence surfaces as a chaos
        # violation, which fails the soak like any other
        kwargs["shard_count"] = shard_count
    if serving:
        # `make soak-serving-short`: the WHOLE day streams every pump
        # beat's window through the persistent serving loop (ring
        # kicks, depth-1 deferred fetch) under the
        # no-window-lost-serving and ring-converges invariants — same
        # SLO gates, same failure semantics as the sharded arm
        kwargs["serving"] = True
    return dataclasses.replace(profile, **kwargs)


def run_soak(segments: tuple[SoakSegment, ...] = PRODUCTION_DAY, *,
             seed: int = 1, slos: tuple[SLOSpec, ...] = SOAK_SLOS,
             report_dir: str = ".soak-report",
             triage_dir: str = ".triage", shard_count: int = 0,
             serving: bool = False, echo=print,
             device="cuda") -> SoakResult:
    """Run the composed production day and gate it on the SLOs.  Every
    segment's flight-recorder spans are dumped as a bundle next to the
    burn report, and each violator row names its bundle."""
    out_dir = Path(report_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    ledger = PlacementLedger(capacity=2048, error_capacity=512,
                             sample_capacity=16384, max_open=65536)
    seg_results: list[dict] = []
    bundles: dict[str, str] = {}
    chaos_violations = 0
    rec_dropped = rec_total = 0
    # cumulative day clock: each segment runs on its own VirtualClock
    # (all anchored near the same real monotonic base), so segment
    # samples are rebased onto one concatenated day timeline — the burn
    # windows evaluate against coherent, monotonic day-seconds
    day_t = 0.0
    # route the process watchdog's breach bundles into THIS soak's
    # triage dir for the duration — a slow-kernel breach mid-day must
    # land next to the slo_burn bundle, not in the ambient cwd
    from karpenter_tpu_torch.obs.watchdog import get_watchdog

    wd = get_watchdog()
    prev_triage = wd.triage_dir
    wd.triage_dir = triage_dir
    try:
        with obs.use_ledger(ledger):
            for i, seg in enumerate(segments):
                name = f"{i:02d}-{seg.profile}"
                ledger.set_context(name)
                profile = _scaled(get_profile(seg.profile), seg.load,
                                  shard_count, serving)
                clock = VirtualClock()
                mono0 = clock.monotonic()
                since = ledger.sample_count
                harness = ChaosHarness(profile, seed, rounds=seg.rounds,
                                       clock=clock, device=device)
                violations = harness.run()
                ledger.rebase_recent(since, day_t - mono0)
                day_t += clock.monotonic() - mono0
                chaos_violations += len(violations)
                rstats = harness.recorder.stats()
                rec_dropped += rstats["dropped_spans"]
                rec_total += rstats["traces_total"] \
                    + rstats["instants_total"]
                bundle = out_dir / f"{name}-spans.jsonl"
                dump_jsonl(recorder_to_dicts(harness.recorder), bundle)
                bundles[name] = str(bundle)
                stats = ledger.stats()
                seg_results.append({
                    "segment": name, "rounds": seg.rounds,
                    "load": seg.load,
                    "chaos_violations": [v.render() for v in violations],
                    "resolved_so_far": stats["resolved_total"],
                    "open_records": stats["open_records"],
                    "bundle": bundles[name],
                })
                echo(f"segment {name:<16} rounds={seg.rounds} "
                     f"load={seg.load:.1f} violations={len(violations)} "
                     f"resolved={stats['resolved_total']} "
                     f"open={stats['open_records']} "
                     f"day_t={day_t:.0f}s")
    finally:
        wd.triage_dir = prev_triage

    extra = {
        "recorder_dropped_fraction": Measurement(
            value=rec_dropped / max(1, rec_total)),
        "unresolved_pods": Measurement(
            value=float(ledger.stats()["open_records"]),
            violators=[rec.to_dict()
                       for rec in ledger.open_records(8)]),
    }
    # device telemetry-word quality measurements (process-global ring —
    # the day's device windows, whatever plane dispatched them)
    extra.update(telemetry_measurements())
    measurements = ledger_measurements(ledger, extra=extra)
    report = evaluate_slos(list(slos), measurements, at=day_t)
    # attach each violator's span bundle (its segment's dump)
    for r in report.results:
        for v in r.violators:
            ctx = v.get("context", "")
            if ctx in bundles:
                v["bundle"] = bundles[ctx]
    # prove the gate can fail: the fixture SLO is unmeetable by
    # construction, so it MUST burn — if it doesn't (e.g. the ledger
    # resolved nothing and every latency reads 0.0), the gate is inert
    # and the soak fails loudly instead of green-washing
    proof = evaluate_slos([BROKEN_FIXTURE_SLO], measurements, at=day_t)
    gate_proven = not proof.ok

    result = SoakResult(
        segments=seg_results, report=report, gate_proven=gate_proven,
        summary=slo_summary(ledger), ledger_stats=ledger.stats(),
        chaos_violations=chaos_violations)
    report_path = out_dir / "slo_report.json"
    report_path.write_text(json.dumps({
        "ok": result.ok,
        "gate_proven": gate_proven,
        "chaos_violations": chaos_violations,
        "report": report.to_dict(),
        "summary": result.summary,
        "ledger": result.ledger_stats,
        "segments": seg_results,
    }, indent=2, default=str))
    result.report_path = str(report_path)

    # a burned day auto-writes a triage bundle next to the burn report:
    # the span bundles name WHAT happened, the triage manifest packages
    # the worst-K pods / devtel / profiler state an operator needs for
    # WHY — and CI uploads .triage/ as an artifact alongside the report
    if not result.ok:
        from karpenter_tpu_torch.obs.watchdog import write_triage_bundle

        try:
            result.triage_bundle = write_triage_bundle(
                "slo_burn",
                {"burned": [r.spec.name for r in report.burned],
                 "gate_proven": gate_proven,
                 "chaos_violations": chaos_violations,
                 "report_path": str(report_path)},
                triage_dir=triage_dir, ledger=ledger)
            echo(f"triage bundle: {result.triage_bundle}")
        except Exception as e:  # noqa: BLE001 — a failed bundle must not
            # mask the burn verdict the soak exists to deliver
            echo(f"triage bundle write failed: {e}")

    echo(report.render())
    if not gate_proven:
        echo("GATE NOT PROVEN: the deliberately-broken fixture SLO did "
             "not burn — the soak resolved nothing measurable")
    if chaos_violations:
        echo(f"chaos invariants: {chaos_violations} violation(s) — see "
             f"segment entries in {report_path}")
    echo(f"soak report: {report_path}")
    echo(f"SOAK {'PASS' if result.ok else 'FAIL'}")
    return result
