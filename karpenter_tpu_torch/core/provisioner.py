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

    The card's solver is returned UNWRAPPED.  The reference wraps its
    solver in ``ResilientSolver``, which degrades a failed solve to the
    host greedy oracle; here that would hide a broken kernel, so the
    degraded mode waits for ROADMAP queue 1 item 13 (the unserved
    fallbacks)."""
    options = options or SolverOptions()
    if options.backend == "greedy":
        from karpenter_tpu_torch.solver.greedy import GreedySolver

        return GreedySolver(options)
    shards = sharded_shards(options)
    if shards > 1:
        from karpenter_tpu_torch.sharded.solver import ShardedSolver

        return ShardedSolver(shards, options, device=device)
    return TorchSolver(options, device=device)
