"""Gang scheduling and torus-slice placement (port of
``karpenter_tpu/gang``): :mod:`topology` lowers per-type torus dims into
placement bitmask tables, :mod:`encode` builds dense gang tensors from
pending pods, :mod:`planner` places gangs atomically (the grid as torch
ops on the card from its size threshold on), :mod:`greedy` is the
bit-identical host oracle and :mod:`degraded` degrades a failed or
structurally invalid plan of a planner on the CPU onto it
(``ResilientGangPlanner``; one on the card raises).
"""

from karpenter_tpu_torch.apis.podgroup import PodGroup, parse_slice_shape
from karpenter_tpu_torch.gang.degraded import (
    ResilientGangPlanner, gang_plan_defects,
)
from karpenter_tpu_torch.gang.encode import GangInfo, GangProblem, encode_gangs
from karpenter_tpu_torch.gang.greedy import GreedyGangPlanner
from karpenter_tpu_torch.gang.planner import GangPlanner
from karpenter_tpu_torch.gang.topology import (
    SliceTable, enumerate_placements, slice_table,
)
from karpenter_tpu_torch.gang.types import (
    GangAssignment, GangNode, GangOptions, GangPlan,
)

__all__ = [
    "GangAssignment", "GangInfo", "GangNode", "GangOptions", "GangPlan",
    "GangPlanner", "GangProblem", "GreedyGangPlanner", "PodGroup",
    "ResilientGangPlanner", "SliceTable", "encode_gangs",
    "enumerate_placements", "gang_plan_defects", "parse_slice_shape",
    "slice_table",
]
