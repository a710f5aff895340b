"""IKS pool-cleanup controller: reap empty dynamic worker pools
(port of ``karpenter_tpu/controllers/iks.py``).

Reference: ``pkg/controllers/iks/poolcleanup/controller.go:75-258`` — a
1-minute poller that deletes karpenter-created (dynamic) pools that have
held zero workers past ``emptyPoolTTL``, honoring the cleanup policy
(Delete vs Retain) from the NodeClass's ``iksDynamicPools`` config.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.cloud.errors import CloudError
from karpenter_tpu_torch.cloud.fake_iks import FakeIKS
from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.iks")


class PoolCleanupController(PollController):
    name = "iks.poolcleanup"
    interval = 60.0

    def __init__(self, cluster: ClusterState, iks: FakeIKS,
                 empty_pool_ttl: float = 600.0, cleanup_policy: str = "Delete"):
        self.cluster = cluster
        self.iks = iks
        self.empty_pool_ttl = empty_pool_ttl
        self.cleanup_policy = cleanup_policy
        self._empty_since: dict[str, float] = {}

    def _policy_for(self, pool) -> tuple:
        """(ttl, policy) from the NodeClass that owns this dynamic pool —
        resolved by the ownership label stamped at creation (immune to name
        sanitization/collision-disambiguation), with a sanitized-prefix
        match as fallback for pools from before the label existed."""
        from karpenter_tpu_torch.core.workerpool import (
            LABEL_OWNER_NODECLASS, sanitize_pool_name,
        )
        owner = pool.labels.get(LABEL_OWNER_NODECLASS, "")
        if owner:
            nc = self.cluster.get("nodeclasses", owner)
            if nc is not None and nc.spec.iks_dynamic_pools is not None \
                    and nc.spec.iks_dynamic_pools.enabled:
                dyn = nc.spec.iks_dynamic_pools
                return float(dyn.empty_pool_ttl_seconds), dyn.cleanup_policy
        for nc in self.cluster.list("nodeclasses"):
            dyn = nc.spec.iks_dynamic_pools
            if dyn is not None and dyn.enabled and \
                    pool.name.startswith(sanitize_pool_name(dyn.pool_name_prefix)):
                return float(dyn.empty_pool_ttl_seconds), dyn.cleanup_policy
        return self.empty_pool_ttl, self.cleanup_policy

    def reconcile(self) -> Result:
        now = time.time()
        try:
            pools = self.iks.list_pools()
        except CloudError as e:
            log.warning("pool list failed", error=str(e))
            return Result()
        live_ids = {p.id for p in pools}
        for pid in list(self._empty_since):
            if pid not in live_ids:
                del self._empty_since[pid]
        for pool in pools:
            if not pool.dynamic or pool.state != "normal":
                continue
            workers = self.iks.list_workers(pool.id)
            if workers:
                self._empty_since.pop(pool.id, None)
                continue
            since = self._empty_since.setdefault(pool.id, now)
            ttl, policy = self._policy_for(pool)
            if now - since < ttl:
                continue
            if policy != "Delete":
                continue   # Retain: leave the empty pool alone
            try:
                self.iks.delete_pool(pool.id)
                self._empty_since.pop(pool.id, None)
                self.cluster.record_event(
                    "WorkerPool", pool.name, "Normal", "EmptyPoolDeleted",
                    f"dynamic pool empty past {ttl:.0f}s")
                log.info("deleted empty dynamic pool", pool=pool.name)
            except CloudError as e:
                log.warning("empty pool delete failed", pool=pool.name,
                            error=str(e))
        return Result()
