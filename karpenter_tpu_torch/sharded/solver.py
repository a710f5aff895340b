"""The sharded service behind the solver protocol's ``.solve()`` (port of
``karpenter_tpu/sharded/solver.py``).

``make_solver`` (``core/provisioner.py``) returns this when the shard
count resolves above 1.  It is unwrapped: the reference's
``ResilientShardedService`` and ``ResilientSolver`` degrade a failed
window to the host greedy oracle, which waits for ROADMAP queue 1 item
13; here a failed window raises.  The merged plan is an ordinary
``Plan``, so shard-ness is invisible downstream of the solve call.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.sharded.service import ShardedSolveService
from karpenter_tpu_torch.solver.types import Plan, SolveRequest, SolverOptions


class ShardedSolver:
    """Routes whole solve requests through the sharded service on
    ``device``.  ``last_stats`` holds the path (``"sharded-cuda"`` or
    ``"sharded-cpu"``), the pods per shard, the resident mode of the
    window and its delta words."""

    def __init__(self, num_shards: int,
                 options: SolverOptions | None = None, device="cuda"):
        self.options = options or SolverOptions()
        self.service = ShardedSolveService(
            num_shards, right_size=self.options.right_size, device=device)
        self.device = self.service.device
        self.last_stats: dict[str, object] = {}

    def solve(self, request: SolveRequest) -> Plan:
        t0 = time.perf_counter()
        # this window is the current pending ground truth: entries that
        # left it any other way are withdrawn first, then this window's
        # pods admit, and whatever places below withdraws
        self.service.sync_backlog(pod_key(p) for p in request.pods)
        self.service.admit(request.pods)
        sharded = self.service.solve_window(
            request.catalog, request.nodepool, request.pods)
        plan = sharded.merged()
        placed = {pn for n in plan.nodes for pn in n.pod_names}
        self.service.withdraw(placed)
        # the rebalance tick: pods left pending are the shard pressure,
        # so a hash-hot backlog migrates ownership before the next window
        if plan.unplaced_pods:
            unplaced = set(plan.unplaced_pods)
            self.service.rebalance(
                [p for p in request.pods if pod_key(p) in unplaced])
        plan.solve_seconds = time.perf_counter() - t0
        delta = self.service.last_delta
        self.last_stats = {"path": f"sharded-{self.device.type}",
                           "shard_pods": list(sharded.shard_pods),
                           "resident_mode": delta.mode,
                           "delta_words": delta.words}
        return plan

    def stats(self) -> dict:
        return self.service.stats()
