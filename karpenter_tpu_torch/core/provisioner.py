"""The solver backend gate of the provisioning loop.

Port of ``make_solver`` from ``karpenter_tpu/core/provisioner.py``.  The
provisioning loop itself (windows, actuation) is not ported yet.
"""

from __future__ import annotations

from karpenter_tpu_torch.sharded import sharded_shards
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.solver.types import SolverOptions


def make_solver(options: SolverOptions | None = None, device="cuda"):
    """The solver for ``options`` on ``device``: the host greedy oracle
    (``GreedySolver``, no device) for ``backend="greedy"``; the sharded
    service (``ShardedSolver``) when ``sharded_shards(options)`` resolves
    more than one shard, as the reference routes it; ``TorchSolver``
    otherwise.

    The device solvers come wrapped in ``ResilientSolver``, as the
    reference's (``karpenter_tpu/core/provisioner.py:51-80``).  On the
    CPU a failed solve or a structurally invalid plan degrades that one
    solve to the greedy oracle, with an ``ERRORS{solver, degraded_*}``
    sample and a ``degraded:`` backend tag; on the card it raises
    (``solver/degraded.py``).  The primary is built first, outside the
    wrapper: a missing card or a failed kernel build raises out of
    ``make_solver``."""
    options = options or SolverOptions()
    if options.backend == "greedy":
        from karpenter_tpu_torch.solver.greedy import GreedySolver

        return GreedySolver(options)
    from karpenter_tpu_torch.solver.degraded import ResilientSolver

    shards = sharded_shards(options)
    if shards > 1:
        # two degradation layers on the CPU: the sharded plane's own
        # host route for a failed window, then the solver-level greedy
        from karpenter_tpu_torch.sharded.solver import ShardedSolver

        return ResilientSolver(ShardedSolver(shards, options, device=device),
                               options)
    return ResilientSolver(TorchSolver(options, device=device), options)
