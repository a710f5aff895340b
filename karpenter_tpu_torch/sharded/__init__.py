"""The sharded continuous-solve service on one device (port of
``karpenter_tpu/sharded``).

Pods hash to shards by constraint signature (:mod:`router`); each
shard's packed window stays resident on the device as one row of a
stacked ``[S, L + 1]`` state fed by word deltas; every window is one
stacked solve, the shards being the problem axis of the fleet kernel
(:mod:`kernels`: one ``ffd_scan_fleet`` and one ``cost_sum`` launch);
a periodic rebalance moves signature-group ownership from the most to
the least loaded shard (:mod:`service`).  ``ShardedSolver`` serves it
behind ``.solve()`` and :mod:`validate` checks it independently.

Windows with soft preferences, a stochastic pool or affinity take the
host route (the greedy oracle shard by shard), and
:class:`ResilientShardedService` (:mod:`degraded`) re-solves a failed
window of a service on the CPU there (one on the card raises).

Opt-in through ``SolverOptions(sharded=N)`` (N > 1) or the environment
variable ``KARPENTER_ENABLE_SHARDED`` (with ``KARPENTER_SHARDS``,
default 2): ``make_solver`` then returns ``ShardedSolver`` (wrapped in
``ResilientSolver``).  Shard meshes wider than one device and the
health-board failover are not ported (ROADMAP queue 1 item 10).
"""

from __future__ import annotations

import os

ENV_FLAG = "KARPENTER_ENABLE_SHARDED"
ENV_SHARDS = "KARPENTER_SHARDS"


def sharded_shards(options=None) -> int:
    """Resolved shard count: ``SolverOptions.sharded`` when forced (> 0),
    else ``KARPENTER_SHARDS`` when ``KARPENTER_ENABLE_SHARDED`` opts in
    (default 2), else 0 = off."""
    forced = getattr(options, "sharded", 0) if options is not None else 0
    if forced:
        return int(forced)
    if os.environ.get(ENV_FLAG, "").lower() in ("1", "true", "yes", "on"):
        return max(int(os.environ.get(ENV_SHARDS, "2") or 2), 1)
    return 0


from karpenter_tpu_torch.sharded.degraded import (  # noqa: E402
    ResilientShardedService,
)
from karpenter_tpu_torch.sharded.router import (  # noqa: E402
    ShardRouter, signature_key, stable_shard,
)
from karpenter_tpu_torch.sharded.service import (  # noqa: E402
    ShardedSolveService,
)
from karpenter_tpu_torch.sharded.solver import ShardedSolver  # noqa: E402
from karpenter_tpu_torch.sharded.types import (  # noqa: E402
    RebalanceDecision, ShardedPlan,
)

__all__ = ["ENV_FLAG", "ENV_SHARDS", "ResilientShardedService",
           "RebalanceDecision", "ShardRouter", "ShardedPlan",
           "ShardedSolveService", "ShardedSolver", "signature_key",
           "sharded_shards", "stable_shard"]
