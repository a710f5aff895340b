from karpenter_tpu_torch.solver.encode import EncodedProblem, encode
from karpenter_tpu_torch.solver.greedy import GreedySolver
from karpenter_tpu_torch.solver.torch_backend import PendingSolve, TorchSolver
from karpenter_tpu_torch.solver.types import (
    Plan, PlannedNode, SolveRequest, SolverOptions,
)
from karpenter_tpu_torch.solver.validate import validate_plan

__all__ = [
    "EncodedProblem", "GreedySolver", "PendingSolve", "Plan", "PlannedNode", "SolveRequest",
    "SolverOptions", "TorchSolver", "encode", "validate_plan",
]
