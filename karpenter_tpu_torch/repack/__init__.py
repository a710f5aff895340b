"""Fleet-wide consolidation as a batched LP-relaxed solve (port of
``karpenter_tpu/repack``).

- :mod:`encode` — the live fleet as dense migration tensors, read off
  the resident occupancy rows (``ResidentStore.occupancy_tensors``) when
  a store is given;
- :mod:`planner` — one batched scoring grid per plan (torch ops on the
  planner's device, or numpy below ``_DEVICE_MIN_CELLS``; integer exact
  both ways) and the integral rounding;
- :mod:`greedy` — the scalar host-loop oracle the planner must equal;
- :mod:`degraded` — ``ResilientRepacker``: a failed or structurally
  invalid plan of a planner on the CPU degrades to the host loop (one
  on the card raises);
- ``validate_repack_plan`` (``solver/validate.py``) — the independent
  feasibility check of a plan.
"""

from karpenter_tpu_torch.repack.encode import (
    RepackProblem, encode_repack, parked_gang_shapes,
)
from karpenter_tpu_torch.repack.degraded import (
    ResilientRepacker, repack_plan_defects,
)
from karpenter_tpu_torch.repack.greedy import GreedyRepacker
from karpenter_tpu_torch.repack.planner import RepackPlanner
from karpenter_tpu_torch.repack.types import (
    KIND_DEFRAG, KIND_DRAIN, Migration, ReopenedSlice, RepackOptions,
    RepackPlan,
)

__all__ = [
    "GreedyRepacker", "KIND_DEFRAG", "KIND_DRAIN", "Migration", "ReopenedSlice",
    "RepackOptions", "RepackPlan", "RepackPlanner", "RepackProblem",
    "ResilientRepacker", "encode_repack", "parked_gang_shapes",
    "repack_plan_defects",
]
