"""Preemption degraded mode: the greedy fallback instead of a failed
plan (port of ``karpenter_tpu/preempt/degraded.py``).

As ``solver/degraded.py``: the batched planner can fail where the host
loop cannot (a faulted device under its fit grid, a shape bug in the
grid's padding).  None of those may stall the preemption plane while
high-priority pods sit pending: ``ResilientPlanner`` degrades that one
plan to ``preempt/greedy.py`` with an ``ERRORS{preempt, degraded_*}``
sample, a ``preempt.plan.degraded`` span and a ``degraded:`` backend
tag.  A planner on the card never hands its plan to the host
(``device.holds_card``): the failure raises, and an invalid plan raises
``InvalidPlanError``.

The structural gate is cheap (O(evictions + placements)); full
feasibility stays with ``validate_preemption_plan``
(``solver/validate.py``).
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.preempt.encode import VictimSet
from karpenter_tpu_torch.preempt.greedy import GreedyPreemptionPlanner
from karpenter_tpu_torch.preempt.planner import PreemptionPlanner
from karpenter_tpu_torch.preempt.types import PlannerOptions, PreemptionPlan
from karpenter_tpu_torch.solver.encode import EncodedProblem
from karpenter_tpu_torch.solver.degraded import InvalidPlanError
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("preempt.degraded")


def plan_defects(plan: PreemptionPlan, problem: EncodedProblem,
                 victims: VictimSet) -> list[str]:
    """Structural sanity of a preemption plan (cheap; the full oracle is
    ``validate_preemption_plan``)."""
    if plan is None:
        return ["planner returned no plan"]
    defects: list[str] = []
    known_claims = set(victims.claim_names)
    evicted: set[str] = set()
    for ev in plan.evictions:
        if ev.claim_name not in known_claims:
            defects.append(f"eviction on unknown claim {ev.claim_name}")
        if ev.pod_key in evicted:
            defects.append(f"pod {ev.pod_key} evicted twice")
        evicted.add(ev.pod_key)
        # the invariant the plane exists to uphold: an inverted eviction
        # never reaches the execution gate
        if ev.victim_priority >= ev.beneficiary_priority:
            defects.append(
                f"priority inversion: victim {ev.pod_key} "
                f"(prio {ev.victim_priority}) evicted for prio "
                f"{ev.beneficiary_priority}")
    pending = {pn for g in problem.groups for pn in g.pod_names}
    for pn, claim in plan.placements.items():
        if pn not in pending:
            defects.append(f"placement of unknown pending pod {pn}")
        if claim not in known_claims:
            defects.append(f"placement onto unknown claim {claim}")
        if pn in evicted:
            defects.append(f"pod {pn} both placed and evicted")
    return defects


class ResilientPlanner:
    """Wraps the batched planner (built on ``device`` when not given);
    degrades single plans of a planner on the CPU to greedy."""

    def __init__(self, primary: PreemptionPlanner | None = None,
                 options: PlannerOptions | None = None, device="cuda"):
        self.options = options or getattr(primary, "options", None) \
            or PlannerOptions()
        self.primary = primary or PreemptionPlanner(self.options,
                                                    device=device)
        self._fallback = None

    @property
    def fallback(self) -> GreedyPreemptionPlanner:
        if self._fallback is None:
            self._fallback = GreedyPreemptionPlanner(self.options)
        return self._fallback

    def plan(self, problem: EncodedProblem, victims: VictimSet,
             compat: np.ndarray | None = None) -> PreemptionPlan:
        try:
            plan = self.primary.plan(problem, victims, compat)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the cycle
            if holds_card(self.primary):
                log.error("preemption planner failed on the card",
                          error=str(e)[:200])
                raise
            log.error("preemption planner failed; degrading to greedy",
                      error=str(e)[:200])
            return self._degrade(problem, victims, compat, "backend_failure")
        defects = plan_defects(plan, problem, victims)
        if defects:
            if holds_card(self.primary):
                log.error("preemption planner produced invalid plan on "
                          "the card", defects=defects[:3])
                raise InvalidPlanError(defects)
            log.error("preemption planner produced invalid plan; degrading",
                      defects=defects[:3])
            return self._degrade(problem, victims, compat, "invalid_plan")
        return plan

    def _degrade(self, problem, victims, compat, reason: str) -> PreemptionPlan:
        metrics.ERRORS.labels("preempt", f"degraded_{reason}").inc()
        with obs.span("preempt.plan.degraded", reason=reason):
            plan = self.fallback.plan(problem, victims, compat)
        plan.backend = f"degraded:{plan.backend}"
        return plan


__all__ = ["ResilientPlanner", "plan_defects"]
