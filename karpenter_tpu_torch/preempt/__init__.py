"""Priority-aware preemption planning (port of ``karpenter_tpu/preempt``).

When the placement solve leaves high-priority groups unplaced, this
plane computes a minimal-cost eviction set over placed lower-priority
pods whose freed capacity hosts them: one batched candidate grid per
round (:mod:`planner`, torch ops on the card from its size threshold
on) over victim tensors built from the cluster state (:mod:`encode`),
with a pure-python greedy parity path (:mod:`greedy`).  The degraded
planner of the reference waits for ROADMAP queue 1 item 13; the
eviction controller for item 12.
"""

from karpenter_tpu_torch.preempt.encode import (  # noqa: F401
    VictimSet, encode_victims, group_node_compat,
)
from karpenter_tpu_torch.preempt.greedy import GreedyPreemptionPlanner  # noqa: F401
from karpenter_tpu_torch.preempt.planner import PreemptionPlanner  # noqa: F401
from karpenter_tpu_torch.preempt.types import (  # noqa: F401
    Eviction, PlannerOptions, PreemptionPlan,
)
