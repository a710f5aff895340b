"""karpenter_tpu_torch: the provisioning solve in PyTorch, on CUDA.

The port of ``karpenter_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
H100.  This package imports nothing of JAX or of ``karpenter_tpu``; the
JAX package stays in the repository as the frozen reference it is held
against.  The served path is the default provisioning solve::

    from karpenter_tpu_torch import SolveRequest, make_solver
    plan = make_solver().solve(SolveRequest(pods, catalog))

on the card by default (``device="cuda"``, which raises without one);
``device="cpu"`` runs the plain PyTorch versions of the kernels.
"""

from karpenter_tpu_torch.core.provisioner import make_solver
from karpenter_tpu_torch.solver import (
    EncodedProblem, Plan, PlannedNode, SolveRequest, SolverOptions,
    TorchSolver, encode, validate_plan,
)

__all__ = [
    "EncodedProblem", "Plan", "PlannedNode", "SolveRequest", "SolverOptions",
    "TorchSolver", "encode", "make_solver", "validate_plan",
]
