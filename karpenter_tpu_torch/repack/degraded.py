"""Repack degraded mode: the host loop instead of a failed plan (port
of ``karpenter_tpu/repack/degraded.py``).

As ``preempt/degraded.py`` and ``gang/degraded.py``: the batched planner
can fail where the host loop cannot (a faulted device under its scoring
grid, a shape bug in the grid's padding).  None of those may stall the
disruption plane: ``ResilientRepacker`` degrades that one plan to the
``repack/greedy.py`` host loop with an ``ERRORS{repack, degraded_*}``
sample, a ``repack.plan.degraded`` span and a ``degraded:`` backend tag.
A planner on the card never hands its plan to the host
(``device.holds_card``): the failure raises, and an invalid plan raises
``InvalidPlanError``.

The structural gate is cheap (O(migrations + nodes)); full feasibility
stays with ``validate_repack_plan`` (``solver/validate.py``).
"""

from __future__ import annotations

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.repack.encode import RepackProblem
from karpenter_tpu_torch.repack.greedy import GreedyRepacker
from karpenter_tpu_torch.repack.planner import RepackPlanner
from karpenter_tpu_torch.repack.types import RepackOptions, RepackPlan
from karpenter_tpu_torch.solver.degraded import InvalidPlanError
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("repack.degraded")


def repack_plan_defects(plan: RepackPlan,
                        problem: RepackProblem) -> list[str]:
    """Structural sanity of a repack plan (cheap; the full oracle is
    ``validate_repack_plan``)."""
    if plan is None:
        return ["planner returned no plan"]
    defects: list[str] = []
    known = set(problem.claim_names)
    drained = set(plan.drained)
    on_node = {name: {r.key for r in refs}
               for name, refs in zip(problem.claim_names, problem.pods)}
    moved: dict[str, str] = {}
    for m in plan.migrations:
        if m.src_claim not in known:
            defects.append(f"migration of {m.pod_key} from unknown claim "
                           f"{m.src_claim}")
        elif m.pod_key not in on_node.get(m.src_claim, ()):
            defects.append(f"migration of {m.pod_key}: pod not on "
                           f"{m.src_claim}")
        if m.dst_claim not in known:
            defects.append(f"migration of {m.pod_key} onto unknown claim "
                           f"{m.dst_claim}")
        if m.dst_claim == m.src_claim:
            defects.append(f"migration of {m.pod_key} onto its own node")
        if m.dst_claim in drained:
            defects.append(f"migration of {m.pod_key} onto drained claim "
                           f"{m.dst_claim}")
        if m.pod_key in moved:
            defects.append(f"pod {m.pod_key} migrated twice")
        moved[m.pod_key] = m.dst_claim
    for name in plan.drained:
        if name not in known:
            defects.append(f"drain of unknown claim {name}")
            continue
        # the invariant the plane exists to uphold: every occupant of a
        # drained node has somewhere to go
        for key in on_node.get(name, ()):
            if key not in moved:
                defects.append(f"drained claim {name} still hosts "
                               f"{key} (pod dropped)")
    for r in plan.reopened:
        if r.claim_name not in known:
            defects.append(f"reopened slice on unknown claim "
                           f"{r.claim_name}")
        if r.claim_name in drained:
            defects.append(f"reopened slice on DRAINED claim "
                           f"{r.claim_name} (a deleted torus hosts "
                           f"nothing)")
    return defects


class ResilientRepacker:
    """Wraps the batched planner (built on ``device`` when not given);
    degrades single plans of a planner on the CPU to the host
    loop."""

    def __init__(self, primary: RepackPlanner | None = None,
                 options: RepackOptions | None = None, device="cuda"):
        self.options = options or getattr(primary, "options", None) \
            or RepackOptions()
        self.primary = primary or RepackPlanner(self.options, device=device)
        self._fallback = None

    @property
    def fallback(self) -> GreedyRepacker:
        if self._fallback is None:
            self._fallback = GreedyRepacker(self.options)
        return self._fallback

    def plan(self, problem: RepackProblem) -> RepackPlan:
        try:
            plan = self.primary.plan(problem)
        except Exception as e:  # noqa: BLE001 — degrade, never fail the tick
            if holds_card(self.primary):
                log.error("repack planner failed on the card",
                          error=str(e)[:200])
                raise
            log.error("repack planner failed; degrading to host loop",
                      error=str(e)[:200])
            return self._degrade(problem, "backend_failure")
        defects = repack_plan_defects(plan, problem)
        if defects:
            if holds_card(self.primary):
                log.error("repack planner produced invalid plan on the card",
                          defects=defects[:3])
                raise InvalidPlanError(defects)
            log.error("repack planner produced invalid plan; degrading",
                      defects=defects[:3])
            return self._degrade(problem, "invalid_plan")
        return plan

    def _degrade(self, problem: RepackProblem, reason: str) -> RepackPlan:
        metrics.ERRORS.labels("repack", f"degraded_{reason}").inc()
        with obs.span("repack.plan.degraded", reason=reason):
            plan = self.fallback.plan(problem)
        plan.backend = f"degraded:{plan.backend}"
        return plan


__all__ = ["ResilientRepacker", "repack_plan_defects"]
