"""Sharded degraded mode: the host route instead of a failed window
(port of ``karpenter_tpu/sharded/degraded.py``).

As ``solver/degraded.ResilientSolver``: for a service on the CPU a
failed stacked solve (a failed ``ffd_scan_fleet`` or ``cost_sum``
launch, a corrupt result) must not fail the window.  The wrapper
invalidates the stacked resident state (the failed dispatch may have
left it half-applied) and re-solves every shard on the host route
(:meth:`ShardedSolveService.solve_window_host`, the greedy oracle), with
an ``ERRORS{sharded, degraded_window}`` sample and ``degraded_windows``
counted.  A failed rebalance falls to the numpy oracle of the decision
(``sharded/kernels.rebalance_oracle``), with
``ERRORS{sharded, degraded_rebalance}`` and ``degraded_rebalances``.

A service on the card never hands a window or a rebalance to the host
(``device.holds_card``): the failure raises, the service having
invalidated its stacked state at the failed kick or fetch.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.sharded.types import RebalanceDecision, ShardedPlan
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("sharded.degraded")


class ResilientShardedService:
    """Wraps a :class:`~karpenter_tpu_torch.sharded.service.
    ShardedSolveService`; delegates everything, degrades failed windows
    and rebalance ticks of a service on the CPU."""

    def __init__(self, primary):
        self.primary = primary
        self.degraded_windows = 0
        self.degraded_rebalances = 0

    def __getattr__(self, name: str):
        return getattr(self.primary, name)

    def solve_window(self, catalog, nodepool=None, pods=None) -> ShardedPlan:
        if pods is None:
            pods = self.primary.backlog_pods()
        try:
            return self.primary.solve_window(catalog, nodepool, pods)
        except Exception as e:  # noqa: BLE001 — any backend fault degrades
            if holds_card(self.primary):
                log.error("sharded window failed on the card",
                          error=str(e)[:200])
                raise
            log.warning("sharded window degraded to host fallback",
                        error=str(e)[:200])
            metrics.ERRORS.labels("sharded", "degraded_window").inc()
            self.degraded_windows += 1
            # the stacked state may be half-applied: never trust it again
            self.primary.invalidate("degraded_window")
            return self.primary.solve_window_host(catalog, nodepool, pods)

    def rebalance(self, pods=None) -> RebalanceDecision:
        if pods is None:
            pods = self.primary.backlog_pods()
        try:
            return self.primary.rebalance(pods)
        except Exception as e:  # noqa: BLE001
            if holds_card(self.primary):
                log.error("rebalance collective failed on the card",
                          error=str(e)[:200])
                raise
            log.warning("rebalance collective degraded to host oracle",
                        error=str(e)[:200])
            metrics.ERRORS.labels("sharded", "degraded_rebalance").inc()
            self.degraded_rebalances += 1
            return self._rebalance_host(pods)

    def _rebalance_host(self, pods) -> RebalanceDecision:
        """The numpy oracle applied directly: the device decision's exact
        twin, so a degraded tick migrates what the device would have."""
        from karpenter_tpu_torch.sharded.kernels import rebalance_oracle

        svc = self.primary
        mat = svc.pressure(pods)
        donor, receiver, amount, skew = rebalance_oracle(mat)
        decision = RebalanceDecision(donor=donor, receiver=receiver,
                                     amount=amount, skew=skew,
                                     pressure=mat,
                                     tile=np.zeros((0, 7), np.int32))
        metrics.SHARD_REBALANCE_SKEW.set(float(skew))
        if amount > 0 and donor != receiver:
            decision.moved_keys = svc._apply_migration(pods, decision)
        with svc._lock:
            svc.rebalances += 1
            svc.migrations += len(decision.moved_keys)
            svc.last_decision = decision
        if decision.moved_keys:
            metrics.SHARD_MIGRATIONS.inc(len(decision.moved_keys))
        return decision


__all__ = ["ResilientShardedService"]
