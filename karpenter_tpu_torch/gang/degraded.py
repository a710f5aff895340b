"""Gang degraded mode: the greedy fallback instead of a failed plan
(port of ``karpenter_tpu/gang/degraded.py``).

As ``solver/degraded.py``: the batched planner can fail where the host
loop cannot (a faulted device under its torch grid, a shape bug in the
grid's padding).  None of those may stall the gang plane while whole
jobs sit parked: ``ResilientGangPlanner`` degrades that one plan to
``gang/greedy.py`` with an ``ERRORS{gang, degraded_*}`` sample, a
``gang.plan.degraded`` span and a ``degraded:`` backend tag.  A
planner on the card never hands its plan to the host
(``device.holds_card``): the failure raises, and an invalid plan raises
``InvalidPlanError``.

The structural gate is cheap (O(members + nodes)); full feasibility
stays with ``validate_gang_plan`` (``solver/validate.py``).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.gang.encode import GangProblem
from karpenter_tpu_torch.gang.greedy import GreedyGangPlanner
from karpenter_tpu_torch.gang.planner import GangPlanner
from karpenter_tpu_torch.gang.types import GangOptions, GangPlan
from karpenter_tpu_torch.solver.degraded import InvalidPlanError
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("gang.degraded")


def gang_plan_defects(plan: GangPlan, problem: GangProblem) -> list[str]:
    """Structural sanity of a gang plan (cheap; the full oracle is
    ``validate_gang_plan``)."""
    if plan is None:
        return ["planner returned no plan"]
    defects: list[str] = []
    members = {g.name: set(g.pod_names) for g in problem.gangs}
    placed: dict[str, set[str]] = {}
    seen: set[str] = set()
    for node in plan.nodes:
        if not (0 <= node.offering_index < problem.catalog.num_offerings):
            defects.append(f"node offering index {node.offering_index} "
                           f"out of range")
        for a in node.assignments:
            for pn in a.pod_names:
                if pn in seen:
                    defects.append(f"pod {pn} placed twice")
                seen.add(pn)
            placed.setdefault(a.gang, set()).update(a.pod_names)
    for name, pods in placed.items():
        want = members.get(name)
        if want is None:
            defects.append(f"placement of unknown gang {name}")
        elif pods != want:
            # the invariant the plane exists to uphold: a partial gang
            # never reaches the execution gate
            defects.append(f"partial gang {name}: {len(pods)}/{len(want)} "
                           f"members placed")
    for pn in plan.unplaced:
        if pn in seen:
            defects.append(f"pod {pn} both placed and unplaced")
    return defects


class ResilientGangPlanner:
    """Wraps the batched planner (built on ``device`` when not given);
    degrades single plans of a planner on the CPU to greedy."""

    def __init__(self, primary: GangPlanner | None = None,
                 options: GangOptions | None = None, device="cuda"):
        self.options = options or getattr(primary, "options", None) \
            or GangOptions()
        self.primary = primary or GangPlanner(self.options, device=device)
        self._fallback = None

    @property
    def fallback(self) -> GreedyGangPlanner:
        if self._fallback is None:
            self._fallback = GreedyGangPlanner(self.options)
        return self._fallback

    def plan(self, problem: GangProblem) -> GangPlan:
        try:
            plan = self.primary.plan(problem)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the cycle
            if holds_card(self.primary):
                log.error("gang planner failed on the card",
                          error=str(e)[:200])
                raise
            log.error("gang planner failed; degrading to greedy",
                      error=str(e)[:200])
            return self._degrade(problem, "backend_failure")
        defects = gang_plan_defects(plan, problem)
        if defects:
            if holds_card(self.primary):
                log.error("gang planner produced invalid plan on the card",
                          defects=defects[:3])
                raise InvalidPlanError(defects)
            log.error("gang planner produced invalid plan; degrading",
                      defects=defects[:3])
            return self._degrade(problem, "invalid_plan")
        return plan

    def _degrade(self, problem: GangProblem, reason: str) -> GangPlan:
        metrics.ERRORS.labels("gang", f"degraded_{reason}").inc()
        with obs.span("gang.plan.degraded", reason=reason):
            plan = self.fallback.plan(problem)
        plan.backend = f"degraded:{plan.backend}"
        return plan


__all__ = ["ResilientGangPlanner", "gang_plan_defects"]
