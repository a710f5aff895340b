"""Repack-plane interface types: the migration plan, options, records
(port of ``karpenter_tpu/repack/types.py``).

A :class:`RepackPlan` names pods to migrate between existing nodes:
fully evacuating nodes whose workload provably fits elsewhere (the node
is then drained and deleted: the savings), and moving chip-consuming
singletons off accelerator nodes when that reopens contiguous torus
slices for parked gangs (the defrag term: no savings, but a parked gang
stops starving).  The planner is a pure function over an encoded
:class:`~karpenter_tpu_torch.repack.encode.RepackProblem`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# candidate kinds the scoring grid emits (shared by every backend and
# the rounding pass — the integer values ARE the wire contract)
KIND_NONE = 0          # not a candidate this round
KIND_DRAIN = 1         # full evacuation: node deleted, price saved
KIND_DEFRAG = 2        # singleton evacuation: node kept, slices reopened


@dataclass
class RepackOptions:
    """Gated planner config (mirrors PlannerOptions' env-style gating)."""

    # "auto": the torch scoring grid on the planner's device from
    # _DEVICE_MIN_CELLS pairwise cells on, numpy below; "on"/"off" force.
    # Both are integer exact, so the choice never changes the plan.
    use_device: str = "auto"
    # topology-aware slice defragmentation (scoring parked gang shapes
    # against per-node chip bitmasks); off = pure cost consolidation
    defrag: bool = True
    # max pod migrations this plan may spend. -1 = unbounded.
    max_migrations: int = -1


@dataclass(slots=True, frozen=True)
class Migration:
    """One pod moved from its current node to another live node."""

    pod_key: str                 # canonical 'namespace/name'
    src_claim: str
    dst_claim: str
    # why the pod moved: the source candidate's kind (KIND_DRAIN =
    # consolidation, KIND_DEFRAG = slice defragmentation)
    kind: int = KIND_DRAIN


@dataclass(slots=True, frozen=True)
class ReopenedSlice:
    """One parked gang shape that newly fits a node after its singleton
    chips were vacated — the defrag win, with the occupancy evidence the
    validator re-derives geometry against."""

    claim_name: str
    offering: int                # catalog offering index of the node
    shape: tuple[int, ...]       # the parked gang's slice shape
    pre_mask: int                # chip occupancy before the migration
    post_mask: int               # chip occupancy after (singletons gone)


@dataclass
class RepackPlan:
    """Migration set + the drains and slice reopenings it unlocks."""

    migrations: list[Migration] = field(default_factory=list)
    drained: list[str] = field(default_factory=list)    # claims deleted
    reopened: list[ReopenedSlice] = field(default_factory=list)
    current_cost: float = 0.0    # $/h of the live fleet at plan time
    proposed_cost: float = 0.0   # $/h after the drains
    candidate_count: int = 0     # nodes the scoring grid considered
    backend: str = ""
    plan_seconds: float = 0.0

    @property
    def savings(self) -> float:
        return self.current_cost - self.proposed_cost

    @property
    def savings_fraction(self) -> float:
        return self.savings / self.current_cost if self.current_cost > 0 \
            else 0.0

    @property
    def migration_count(self) -> int:
        return len(self.migrations)

    @property
    def slices_reopened(self) -> int:
        return len(self.reopened)

    @property
    def empty(self) -> bool:
        return not self.migrations and not self.drained

    def summary(self) -> dict[str, object]:
        return {
            "migrations": self.migration_count,
            "drained": len(self.drained),
            "slices_reopened": self.slices_reopened,
            "savings": round(self.savings, 4),
            "savings_fraction": round(self.savings_fraction, 4),
            "candidates": self.candidate_count,
            "backend": self.backend,
            "plan_seconds": round(self.plan_seconds, 6),
        }
