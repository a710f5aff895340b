"""The operator-resident planning service, opt-in with
KARPENTER_ENABLE_WHATIF (port of ``karpenter_tpu/whatif/service.py``).

Periodically (and on demand via ``GET /debug/whatif``) evaluates a
STANDING SCENARIO MENU against the live pending window:

- scenario 0 is always the baseline (the live solve problem, untouched);
- the forecast peak (expected arrivals per signature group over the
  horizon, from the ledger-learned forecaster);
- threat scenarios — spot storm, a seeded zone blackout — each composed
  WITH the forecast wave (the question is "tonight's peak during a spot
  storm", not either alone);
- the pool-shrink capacity scenario (cap clamps ARE solve-visible).

All K scenarios ride ONE stacked device dispatch (planner).
Pre-provision capacity actions are solve-INVISIBLE (scenario.py), so
they cost zero extra scenarios: ``_rank`` derives each threat's
candidate from the threat's own decoded outcome (the offering it opens
most nodes of) and scores it by (SLO-risk averted per dollar), where
risk = weighted unplaced + boot-exposed pods and the action averts the
boot exposure of pods landing on its pre-provisioned nodes.
Positive-averted actions are recorded into a bounded audit registry
with the before-outcome and the projected after-state, the forecast
generation, and the plan backend, so ``/debug/whatif`` can always
answer "why did you recommend pre-provisioning 2 of type X".

Determinism: the menu derives from (ledger arrival table, seed,
baseline); the digest over the recommendation set is byte-stable across
reruns — the `make whatif-determinism` CI check runs the whole cycle
twice and compares digests, the same discipline the chaos matrix
enforces on event traces.

The service plans on ``device`` (``"cuda"`` by default, which raises
without a card; ``"cpu"`` runs the kernels' plain versions).  On the
card a failed stacked plan raises out of ``evaluate``: no host plan
stands in for it, and ``WhatIfController`` counts it as the reference
counts a failed tick.
"""

from __future__ import annotations

import hashlib
import json
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.obs.trace import now
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger
from karpenter_tpu_torch.whatif.forecast import ArrivalForecaster
from karpenter_tpu_torch.whatif.scenario import (
    PreProvision, Scenario, spot_storm_mask, wave_from_forecast,
    zone_blackout_mask,
)

log = get_logger("whatif.service")


@dataclass
class Recommendation:
    """One ranked capacity action: the audit-registry row."""

    scenario: str
    action: dict
    risk_before: int
    risk_after: int
    averted: int
    cost_per_hour: float
    score: float
    horizon_hours: int
    forecast_generation: int
    backend: str
    created_at: float = 0.0
    outcome_before: dict = field(default_factory=dict)
    outcome_after: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "action": self.action,
            "risk_before": self.risk_before,
            "risk_after": self.risk_after,
            "risk_averted": self.averted,
            "cost_per_hour": round(self.cost_per_hour, 6),
            "score": round(self.score, 6),
            "horizon_hours": self.horizon_hours,
            "forecast_generation": self.forecast_generation,
            "backend": self.backend,
            "created_at": round(self.created_at, 3),
            "outcome_before": self.outcome_before,
            "outcome_after": self.outcome_after,
        }


class PlanningService:
    """Forecast -> standing menu -> stacked plan -> ranked
    recommendations (see module docstring)."""

    def __init__(self, cluster, provisioner=None, *, catalog_fn=None,
                 nodepool_fn=None, seed: int = 17,
                 horizon_hours: int | None = None, planner=None,
                 journal=None, registry_cap: int = 256,
                 validate: bool = False, device="cuda"):
        from karpenter_tpu_torch.whatif import WHATIF_HORIZON_HOURS
        from karpenter_tpu_torch.whatif.degraded import ResilientPlanner

        self.cluster = cluster
        self.provisioner = provisioner
        self._catalog_fn = catalog_fn
        self._nodepool_fn = nodepool_fn
        self.seed = seed
        self.horizon_hours = horizon_hours if horizon_hours is not None \
            else WHATIF_HORIZON_HOURS
        self.device = resolve_device(device)
        # a planner passed in keeps its own device
        self.planner = planner or ResilientPlanner(
            planner_device=self.device)
        self.journal = journal
        self.validate = validate
        self.forecaster = ArrivalForecaster()
        self._registry: deque[Recommendation] = deque(maxlen=registry_cap)
        self._flight = threading.Lock()
        self._lock = threading.Lock()
        self.ticks = 0
        self.evaluations = 0
        self.busy_rejections = 0
        self.last_payload: dict | None = None
        self.last_error = ""
        self.validation_failures = 0
        self._saved_forecast_generation = -1
        self._risk_labels: set[str] = set()
        # restart warm-start: the journal's forecast snapshot merges
        # (elementwise max — same bounded ring, never double-counted)
        # into every rebuilt forecaster until the live ring catches up
        self._persisted: ArrivalForecaster | None = None
        if journal is not None:
            loaded = ArrivalForecaster.load(journal)
            if loaded.rates():
                self._persisted = loaded

    # -- inputs ------------------------------------------------------------

    def _resolve_catalog(self):
        if self._catalog_fn is not None:
            return self._catalog_fn()
        if self.provisioner is None:
            return None
        pools = self.cluster.list("nodepools")
        pool = pools[0] if pools else None
        wanted = pool.nodeclass_name if pool and pool.nodeclass_name \
            else "default"
        nodeclass = self.cluster.get_nodeclass(wanted)
        if nodeclass is None:
            return None
        return self.provisioner._catalog_for(nodeclass)

    def _resolve_nodepool(self):
        if self._nodepool_fn is not None:
            return self._nodepool_fn()
        pools = self.cluster.list("nodepools")
        return pools[0] if pools else None

    def _pending(self) -> list:
        return [p.spec for p in self.cluster.pending_pods()]

    # -- the standing menu -------------------------------------------------

    def build_menu(self, baseline, expected: dict[str, int],
                   rng: random.Random) -> list[Scenario]:
        """Baseline + forecast peak + chaos-derived threats + the
        pool-shrink capacity action — every scenario a pure function of
        (baseline, forecast table, seed).  Pre-provision actions are
        solve-INVISIBLE (scenario.py), so the menu carries only
        solve-distinct futures and ``_rank`` derives the pre-provision
        recommendation for each threat from its own decoded outcome —
        the action axis costs zero extra scenarios and zero extra
        dispatches."""
        catalog = baseline.catalog
        wave = wave_from_forecast(baseline, expected)
        threat_base = (wave,) if wave.waves else ()
        menu: list[Scenario] = [Scenario("baseline")]
        if wave.waves:
            menu.append(Scenario("forecast-peak", (wave,)))
        storm = spot_storm_mask(catalog)
        if storm.offerings:
            menu.append(Scenario("spot-storm", threat_base + (storm,)))
        if catalog.zones:
            zone = catalog.zones[rng.randrange(len(catalog.zones))]
            blackout = zone_blackout_mask(catalog, zone)
            if blackout.offerings:
                menu.append(Scenario(f"zone-blackout:{zone}",
                                     threat_base + (blackout,)))
        # "what if this NodePool shrinks": per-node pod caps clamped
        # hard under the forecast peak — the disruption-budget question
        # from the ROADMAP, as a standing capacity-action scenario (its
        # answer is the risk row in /debug/whatif)
        from karpenter_tpu_torch.whatif.scenario import quota_clamp

        shrink = quota_clamp(baseline, 2)
        if shrink.caps:
            menu.append(Scenario("pool-shrink", threat_base + (shrink,)))
        return menu

    # -- evaluation --------------------------------------------------------

    def evaluate(self, horizon_hours: int | None = None,
                 scenario_names: list[str] | None = None,
                 record: bool = False,
                 hour: int | None = None) -> dict | None:
        """One planning pass.  SINGLE-FLIGHT like /debug/profile: a
        concurrent call returns None (the endpoint maps it to 429) —
        a stacked K-scenario dispatch is exactly the kind of work two
        callers must not double-launch.  ``hour`` pins the virtual
        hour-of-day (the determinism check's knob; default = derived
        from the ambient clock)."""
        if not self._flight.acquire(blocking=False):
            with self._lock:
                self.busy_rejections += 1
            return None
        try:
            return self._evaluate_locked(horizon_hours, scenario_names,
                                         record, hour)
        finally:
            self._flight.release()

    def _evaluate_locked(self, horizon_hours, scenario_names,
                         record, hour=None) -> dict:
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.whatif.planner import build_baseline
        from karpenter_tpu_torch.whatif.validate import validate_whatif

        from karpenter_tpu_torch.whatif import WHATIF_MAX_HORIZON_HOURS

        t0 = time.perf_counter()
        horizon = int(horizon_hours) if horizon_hours is not None \
            else self.horizon_hours
        # clamped like /debug/profile's ?duration_s=: an unbounded
        # horizon would run an O(horizon) forecast loop under the
        # single-flight lock and scale waves into an OOM-sized stack
        horizon = max(0, min(horizon, WHATIF_MAX_HORIZON_HOURS))
        catalog = self._resolve_catalog()
        if catalog is None:
            payload = {"error": "no catalog resolvable (no nodeclass?)",
                       "scenarios": []}
            with self._lock:
                self.last_error = payload["error"]
            return payload
        pods = self._pending()
        baseline = build_baseline(pods, catalog, self._resolve_nodepool())
        self.forecaster = ArrivalForecaster.from_ledger(obs.get_ledger())
        if self._persisted is not None:
            # the warm-start snapshot EXPIRES once the live ring has
            # re-observed as much demand as the snapshot held —
            # otherwise a max-merge would forecast decommissioned
            # workloads forever (the ring can age demand out, a
            # never-cleared snapshot cannot)
            live = sum(sum(r) for r in
                       obs.get_ledger().arrival_history().values())
            kept = sum(sum(r) for r in
                       self._persisted._counts.values())
            if live >= kept:
                self._persisted = None
            else:
                self.forecaster = \
                    self.forecaster.merged_with(self._persisted)
        # journal persistence only on RECORDING passes (the periodic
        # tick) and only when the table actually changed — a read-only
        # /debug/whatif GET must never append to the recovery journal
        if record and self.journal is not None:
            gen = self.forecaster.generation
            if gen != self._saved_forecast_generation:
                self.forecaster.save(self.journal)
                self._saved_forecast_generation = gen
        if hour is None:
            hour = int(now() // 3600.0) % 24
        expected = self.forecaster.expected_arrivals(horizon, hour)
        rng = random.Random((self.seed, horizon, baseline.G_pad).__repr__())
        menu = self.build_menu(baseline, expected, rng)
        if scenario_names:
            wanted = set(scenario_names)
            menu = [s for s in menu if s.name in wanted] or menu[:1]
        plan = self.planner.plan(baseline, menu)
        # the cheap well-formedness layer ALWAYS runs (a garbage
        # forecast must never reach the registry, validate flag or
        # not); the full fresh-solve replay is the opt-in half
        violations = validate_whatif(plan, replay=self.validate)
        if violations:
            with self._lock:
                self.validation_failures += 1
        recs = self._rank(plan, horizon)
        horizon_risk = max((o.unplaced for o in plan.outcomes
                            if o.action is None), default=0)
        if record and not violations:
            with self._lock:
                for r in recs:
                    self._registry.append(r)
            # refresh the horizon-risk gauge over THIS pass's standing
            # names and clear rows the menu no longer carries (the
            # seeded blackout zone rotates with the baseline shape; a
            # stale row would report a risk no pass maintains — the
            # series-hygiene rule every gauge here follows)
            fresh = {o.name for o in plan.outcomes if o.action is None}
            with self._lock:
                stale = self._risk_labels - fresh
                self._risk_labels = fresh
            for name in stale:
                metrics.WHATIF_HORIZON_RISK.remove(name)
            for o in plan.outcomes:
                if o.action is None:
                    metrics.WHATIF_HORIZON_RISK.labels(o.name).set(
                        float(o.unplaced))
        mode = "device" if plan.backend == "device" else "host"
        metrics.WHATIF_SCENARIOS.labels(mode).inc(len(menu))
        metrics.WHATIF_PLAN_DURATION.labels(mode).observe(
            plan.plan_seconds)
        with self._lock:
            metrics.WHATIF_RECOMMENDATIONS.set(float(len(self._registry)))
            self.evaluations += 1
            self.last_error = ""
        payload = {
            "horizon_hours": horizon,
            "virtual_hour": hour,
            "pending_pods": len(pods),
            "backend": plan.backend,
            "dispatches": plan.dispatches,
            "plan_seconds": round(plan.plan_seconds, 6),
            "horizon_risk": horizon_risk,
            "forecast": self.forecaster.snapshot(),
            "scenarios": [o.to_dict() for o in plan.outcomes],
            "recommendations": [r.to_dict() for r in recs],
            "validation": {"checked": bool(self.validate),
                           "violations": violations},
            "wall_seconds": round(time.perf_counter() - t0, 6),
        }
        with self._lock:
            self.last_payload = {k: payload[k] for k in
                                 ("horizon_hours", "backend", "dispatches",
                                  "plan_seconds", "horizon_risk",
                                  "pending_pods")}
        return payload

    # an unplaced pod outweighs a boot-waiting pod in the risk metric:
    # unplaced = SLO burn for the whole horizon, boot-wait = one
    # create+boot latency
    RISK_UNPLACED_WEIGHT = 10
    # pre-provision at most this many nodes per recommendation
    MAX_PREPROVISION = 2

    @classmethod
    def scenario_risk(cls, outcome) -> int:
        """SLO risk of one future: weighted unplaced pods + boot-exposed
        pods (every placed pod lands on a node the scenario would have
        to create and boot)."""
        return cls.RISK_UNPLACED_WEIGHT * max(outcome.unplaced, 0) \
            + max(outcome.placed, 0)

    def _rank(self, plan, horizon: int) -> list[Recommendation]:
        """(SLO-risk averted per dollar): for every non-baseline,
        action-free scenario, derive the pre-provision candidate from
        its OWN decoded outcome — the offering the scenario opens most
        nodes of — and score the action by the boot exposure (plus any
        unplaced delta, for explicitly actioned scenarios) it averts
        per dollar of pre-provisioned capacity.  Pre-provision is
        solve-invisible, so this costs zero extra scenarios and zero
        extra dispatches."""
        import numpy as np

        price = np.asarray(plan.baseline.catalog.off_price,
                           dtype=np.float64)
        recs: list[Recommendation] = []
        for o, s in zip(plan.outcomes, plan.stacked.scenarios):
            if s.name == "baseline" or s.action is not None:
                continue
            if not o.offering_node_pods:
                continue
            # most-opened offering, lowest index on ties — deterministic
            off, (n_nodes, pods_list) = max(
                o.offering_node_pods.items(),
                key=lambda kv: (kv[1][0], -kv[0]))
            count = min(self.MAX_PREPROVISION, n_nodes)
            if count <= 0 or off >= price.shape[0]:
                continue
            covered = sum(pods_list[:count])
            averted = covered
            cost = float(price[off]) * count
            if averted <= 0 or cost <= 0:
                continue
            action = PreProvision(offering=int(off), count=int(count))
            risk_before = self.scenario_risk(o)
            # the projected after-state: the same solve with the
            # action's sunk capacity applied — covered pods lose their
            # boot exposure, the action's price becomes standing spend
            after = {
                "scenario": s.name,
                "risk": risk_before - averted,
                "boot_exposed_pods": max(o.placed, 0) - covered,
                "covered_pods": covered,
                "unplaced": o.unplaced,
                "cost_per_hour": round(o.cost, 6),
                "standing_action_cost_per_hour": round(cost, 6),
            }
            recs.append(Recommendation(
                scenario=s.name,
                action=action.describe(plan.baseline.catalog),
                risk_before=risk_before,
                risk_after=risk_before - averted,
                averted=averted, cost_per_hour=cost,
                score=averted / cost, horizon_hours=horizon,
                forecast_generation=self.forecaster.generation,
                backend=plan.backend, created_at=now(),
                outcome_before=o.to_dict(),
                outcome_after=after))
        recs.sort(key=lambda r: (-r.score, r.scenario))
        return recs

    # -- periodic tick -----------------------------------------------------

    def tick(self) -> dict | None:
        payload = self.evaluate(record=True)
        if payload is not None:
            with self._lock:
                self.ticks += 1
        return payload

    # -- readout -----------------------------------------------------------

    def recommendations(self, n: int | None = None) -> list[dict]:
        with self._lock:
            rows = [r.to_dict() for r in self._registry]
        rows.reverse()                      # newest first
        return rows if n is None else rows[:n]

    def digest(self) -> str:
        """SHA-256 over the canonical recommendation set (action +
        risk numbers; timestamps excluded) — the determinism check's
        comparison surface.  Built from the dataclass fields directly:
        a read-only digest must never mutate the shared registry rows
        the audit surface serves."""
        with self._lock:
            rows = [{
                "scenario": r.scenario, "action": r.action,
                "risk_before": r.risk_before, "risk_after": r.risk_after,
                "averted": r.averted,
                "cost_per_hour": round(r.cost_per_hour, 6),
                "score": round(r.score, 6),
                "horizon_hours": r.horizon_hours,
                "forecast_generation": r.forecast_generation,
                "backend": r.backend,
            } for r in self._registry]
        blob = json.dumps(rows, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def snapshot(self) -> dict:
        """The /statusz whatif block."""
        with self._lock:
            return {
                "ticks": self.ticks,
                "evaluations": self.evaluations,
                "busy_rejections": self.busy_rejections,
                "recommendations": len(self._registry),
                "validation_failures": self.validation_failures,
                "horizon_hours": self.horizon_hours,
                "last": dict(self.last_payload or {}),
                "last_error": self.last_error,
                "forecast_generation": self.forecaster.generation,
                "degraded_plans": getattr(self.planner, "degraded_plans",
                                          0),
            }


class WhatIfController(PollController):
    """The operator's periodic planning tick (docs/design/whatif.md):
    registered only under KARPENTER_ENABLE_WHATIF, like every other
    opt-in plane."""

    name = "whatif.planning"

    def __init__(self, service: PlanningService,
                 interval: float | None = None):
        from karpenter_tpu_torch.whatif import WHATIF_INTERVAL_S

        self.service = service
        self.interval = interval if interval is not None \
            else WHATIF_INTERVAL_S

    def reconcile(self) -> Result:
        try:
            self.service.tick()
        except Exception as e:  # noqa: BLE001 — a planning failure must
            # never crash the controller plane; the breadcrumb + statusz
            # carry the cause
            metrics.ERRORS.labels("whatif", type(e).__name__).inc()
            with self.service._lock:
                self.service.last_error = str(e)[:200]
            log.warning("whatif tick failed", error=str(e)[:200])
        return Result()
