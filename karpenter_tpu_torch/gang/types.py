"""Gang-plane interface types: plan, node, options (port of
``karpenter_tpu/gang/types.py``).

A :class:`GangPlan` is the all-or-nothing counterpart of the solver's
Plan: instead of *pods to nodes* it names *gangs to torus slices*.
Every gang either has all of its members on one node (one contiguous
sub-slice of that node's accelerator torus) or appears in
``unplaced_gangs`` with every member unplaced; an assignment row carries
the whole member list, so a partial placement cannot be written down.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GangOptions:
    """Gated planner config (mirrors SolverOptions/PlannerOptions)."""

    # "auto": the torch grid on the planner's device once a grid step
    # reaches planner._DEVICE_MIN_CELLS cells, numpy below (a size rule);
    # "on"/"off" force.  Both routes are integer/bool exact, so the
    # choice never changes the plan.
    use_device: str = "auto"
    # static bound on nodes one plan may open
    max_nodes: int = 4096


@dataclass(slots=True, frozen=True)
class GangAssignment:
    """One gang occupying one contiguous sub-slice of a node's torus."""

    gang: str                        # PodGroup name
    placement_mask: int              # chip bitmask within the node torus
    pod_names: tuple[str, ...]       # ALL members — partiality is
                                     # structurally unrepresentable
    # rank-aware placement (MPI-style: rank r <-> chip rank_chips[r],
    # member pod_names[i] takes rank i mod chips): the slice's chips in
    # the hop-minimizing rank order, and the achieved max ring-hop —
    # validated by an independent recount in solver/validate.py
    rank_chips: tuple[int, ...] = ()
    max_hop: int = 0


@dataclass(slots=True)
class GangNode:
    """One node the plan wants created, with its slice assignments."""

    instance_type: str
    zone: str
    capacity_type: str
    price: float
    offering_index: int = -1
    assignments: list[GangAssignment] = field(default_factory=list)

    @property
    def pod_names(self) -> list[str]:
        return [pn for a in self.assignments for pn in a.pod_names]


@dataclass
class GangPlan:
    """Atomic gang placement result."""

    nodes: list[GangNode] = field(default_factory=list)
    placements: dict[str, int] = field(default_factory=dict)  # pod -> node idx
    placed_gangs: list[str] = field(default_factory=list)
    unplaced_gangs: list[str] = field(default_factory=list)
    unplaced: list[str] = field(default_factory=list)         # pod keys
    total_cost_per_hour: float = 0.0
    backend: str = ""
    plan_seconds: float = 0.0

    @property
    def placed_count(self) -> int:
        return len(self.placements)
