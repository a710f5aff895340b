"""Preemption-plane interface types: plan, eviction, options (port of
``karpenter_tpu/preempt/types.py``).

A :class:`PreemptionPlan` is the priority-aware counterpart of the
solver's Plan: instead of *nodes to create* it names *pods to evict*
from existing nodes and the pending high-priority pods that take their
place.  The planner is a pure function over explicit inputs (the
encoded pending problem and the victim tensors).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PlannerOptions:
    """Gated planner config (mirrors SolverOptions' env-style gating)."""

    # "auto": the torch fit grid on the planner's device once a grid
    # step reaches planner._DEVICE_MIN_CELLS cells (and every tensor
    # fits int32), numpy otherwise (a size rule); "on"/"off" force.
    # Both routes are integer exact, so the choice never changes the
    # plan.
    use_device: str = "auto"
    # max evictions this plan may spend (the per-NodePool disruption
    # budget, threaded by the controller). -1 = unbounded.
    max_evictions: int = -1


@dataclass(slots=True, frozen=True)
class Eviction:
    """One victim pod removed from its node to free capacity."""

    claim_name: str
    pod_key: str                 # canonical 'namespace/name'
    victim_priority: int
    # the pending group this eviction served: its priority is the
    # no-inversion witness (victim_priority < beneficiary_priority,
    # enforced by construction and re-checked by solver/validate.py)
    beneficiary_priority: int
    beneficiary: str = ""        # representative pending pod key


@dataclass
class PreemptionPlan:
    """Eviction set + the placements it unlocks."""

    evictions: list[Eviction] = field(default_factory=list)
    placements: dict[str, str] = field(default_factory=dict)  # pod -> claim
    candidate_count: int = 0     # victims considered by the scorer
    eviction_weight: int = 0     # Σ priority-rank weights spent
    unplaced: list[str] = field(default_factory=list)
    backend: str = ""
    plan_seconds: float = 0.0

    @property
    def eviction_count(self) -> int:
        return len(self.evictions)

    @property
    def placed_count(self) -> int:
        return len(self.placements)

    @property
    def empty(self) -> bool:
        return not self.evictions and not self.placements

    def summary(self) -> dict[str, object]:
        return {
            "evictions": self.eviction_count,
            "placed": self.placed_count,
            "unplaced": len(self.unplaced),
            "candidates": self.candidate_count,
            "weight": self.eviction_weight,
            "backend": self.backend,
            "plan_seconds": round(self.plan_seconds, 6),
        }
