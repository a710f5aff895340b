"""IKS worker-pool actuation: the alternate Create/Delete path
(port of ``karpenter_tpu/core/workerpool.py``).

Capability parity with ``pkg/providers/iks/workerpool/provider.go``:
Create = find-or-select a pool for the instance type (:469-546; dynamic
pool creation :553 gated by ``iksDynamicPools.enabled`` :548) -> **atomic
pool increment** (:126) -> NodeClaim tracking the new worker (the
reference's placeholder Node :135-168); Delete = targeted decrement.  Pool
naming/sanitization mirrors :386-453.

Drop-in alternative to the VPC :class:`~karpenter_tpu_torch.core.actuator.Actuator`
— same ``create_node`` / ``delete_node`` / ``execute_plan`` surface, chosen
per-NodeClass by the :class:`~karpenter_tpu_torch.core.factory.ProviderFactory`.
"""

from __future__ import annotations

import hashlib
import re
import time

from karpenter_tpu_torch.constants import CLAIM_FINALIZER
from karpenter_tpu_torch.apis.nodeclaim import (
    NodeClaim, parse_provider_id, provider_id,
)
from karpenter_tpu_torch.apis.nodeclass import NodeClass
from karpenter_tpu_torch.apis.requirements import (
    LABEL_CAPACITY_TYPE, LABEL_NODEPOOL, LABEL_REGION, LABEL_ZONE,
)
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.cloud.errors import (
    CloudError, NodeClaimNotFoundError, is_capacity, is_not_found, parse_error,
)
from karpenter_tpu_torch.cloud.fake_iks import FakeIKS, FakeWorkerPool
from karpenter_tpu_torch.core.circuitbreaker import CircuitBreakerManager
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.solver.types import Plan, PlannedNode
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.workerpool")

ANNOTATION_POOL_ID = "karpenter-tpu.sh/iks-pool-id"
ANNOTATION_WORKER_ID = "karpenter-tpu.sh/iks-worker-id"
LABEL_OWNER_NODECLASS = "karpenter-tpu.sh/nodeclass"

_POOL_NAME_MAX = 31
_POOL_NAME_RE = re.compile(r"[^a-z0-9-]+")


def sanitize_pool_name(raw: str) -> str:
    """IKS pool-name rules (ref workerpool/provider.go:386-453): lowercase
    alphanumeric + dashes, must start with a letter, bounded length."""
    name = _POOL_NAME_RE.sub("-", raw.lower()).strip("-")
    if not name or not name[0].isalpha():
        name = "kp-" + name
    return name[:_POOL_NAME_MAX].rstrip("-")


class WorkerPoolActuator:
    def __init__(self, iks: FakeIKS, cluster: ClusterState,
                 breaker: CircuitBreakerManager | None = None,
                 unavailable: UnavailableOfferings | None = None):
        self.iks = iks
        self.cluster = cluster
        self.breaker = breaker or CircuitBreakerManager()
        self.unavailable = unavailable or UnavailableOfferings()

    # -- create ------------------------------------------------------------

    def create_node(self, planned: PlannedNode, nodeclass: NodeClass,
                    catalog: CatalogArrays, nodepool_name: str = "default"
                    ) -> NodeClaim:
        if not nodeclass.status.is_ready():
            raise CloudError(f"nodeclass {nodeclass.name} is not ready",
                             status_code=409, retryable=False)
        region = nodeclass.spec.region
        self.breaker.can_provision(nodeclass.name, region)
        t0 = time.perf_counter()
        try:
            claim = self._do_create(planned, nodeclass, nodepool_name, catalog)
        except Exception as e:
            err = parse_error(e, operation="increment_pool")
            self.breaker.record_failure(nodeclass.name, region, str(err))
            metrics.ERRORS.labels("workerpool", err.code or "unknown").inc()
            if is_capacity(err):
                self.unavailable.mark_unavailable(
                    planned.instance_type, planned.zone, planned.capacity_type,
                    reason=err.code)
            metrics.PROVISIONING_DURATION.labels(
                planned.instance_type, planned.zone, "error").observe(
                time.perf_counter() - t0)
            raise
        self.breaker.record_success(nodeclass.name, region)
        metrics.PROVISIONING_DURATION.labels(
            planned.instance_type, planned.zone, "success").observe(
            time.perf_counter() - t0)
        metrics.INSTANCE_LIFECYCLE.labels("created", planned.instance_type,
                                          planned.zone).inc()
        return claim

    def _do_create(self, planned: PlannedNode, nodeclass: NodeClass,
                   nodepool_name: str, catalog: CatalogArrays) -> NodeClaim:
        pool = self._find_or_create_pool(planned, nodeclass)
        worker = self.iks.increment_pool(pool.id, planned.zone)
        labels = dict(catalog.offering_label_values(planned.offering_index)) \
            if planned.offering_index >= 0 else {}
        labels.update({LABEL_REGION: nodeclass.spec.region,
                       LABEL_NODEPOOL: nodepool_name,
                       LABEL_ZONE: planned.zone,
                       LABEL_CAPACITY_TYPE: planned.capacity_type})
        claim = NodeClaim(
            name=worker.id,
            nodeclass_name=nodeclass.name,
            nodepool_name=nodepool_name,
            instance_type=planned.instance_type,
            zone=planned.zone,
            capacity_type=planned.capacity_type,
            provider_id=provider_id(nodeclass.spec.region, worker.instance_id),
            labels=labels,
            annotations={ANNOTATION_POOL_ID: pool.id,
                         ANNOTATION_WORKER_ID: worker.id},
            hourly_price=planned.price,
            launched=True,
            finalizers=[CLAIM_FINALIZER])
        self.cluster.add_nodeclaim(claim)
        self.cluster.record_event(
            "NodeClaim", claim.name, "Normal", "WorkerAdded",
            f"pool {pool.name} ({pool.id}) +1 in {planned.zone}")
        return claim

    def _find_or_create_pool(self, planned: PlannedNode,
                             nodeclass: NodeClass) -> FakeWorkerPool:
        """(ref findOrSelectWorkerPool, workerpool/provider.go:469-546)"""
        # explicit pool pin wins
        if nodeclass.spec.iks_worker_pool_id:
            return self.iks.get_pool(nodeclass.spec.iks_worker_pool_id)
        # exact flavor+zone match among existing pools
        for pool in self.iks.list_pools():
            if pool.flavor == planned.instance_type and \
                    planned.zone in pool.zones and pool.state == "normal":
                return pool
        # dynamic creation, gated (ref :548-553)
        dyn = nodeclass.spec.iks_dynamic_pools
        if dyn is None or not dyn.enabled:
            raise CloudError(
                f"no worker pool for {planned.instance_type} in "
                f"{planned.zone} and dynamic pools disabled", 409,
                code="no_pool", retryable=False)
        name = sanitize_pool_name(
            f"{dyn.pool_name_prefix}-{planned.instance_type}")
        existing = self.iks.get_pool_by_name(name)
        if existing is not None and existing.flavor != planned.instance_type:
            # sanitization/truncation collision: two flavors mapped to one
            # name — disambiguate instead of provisioning the wrong type
            suffix = hashlib.sha1(
                planned.instance_type.encode()).hexdigest()[:6]
            name = sanitize_pool_name(f"{name[:_POOL_NAME_MAX - 7]}-{suffix}")
            existing = self.iks.get_pool_by_name(name)
        if existing is not None:
            self.iks.add_pool_zone(existing.id, planned.zone)
            return existing
        return self.iks.create_pool(
            name=name, flavor=planned.instance_type, zones=[planned.zone],
            size_per_zone=0,
            # ownership label: the cleanup controller resolves TTL/policy by
            # owner, immune to name sanitization/disambiguation
            labels={"karpenter.sh/managed": "true",
                    LABEL_OWNER_NODECLASS: nodeclass.name},
            dynamic=True)

    # -- delete ------------------------------------------------------------

    def delete_node(self, claim: NodeClaim) -> None:
        """Targeted pool decrement; NodeClaimNotFoundError once the worker
        is verifiably gone (same finalizer-release contract as VPC)."""
        pool_id = claim.annotations.get(ANNOTATION_POOL_ID, "")
        worker_id = claim.annotations.get(ANNOTATION_WORKER_ID, "")
        if not pool_id or not worker_id:
            raise NodeClaimNotFoundError(claim.name)
        try:
            self.iks.decrement_pool(pool_id, worker_id)
        except CloudError as e:
            if not is_not_found(e):
                raise
        try:
            self.iks.get_worker(worker_id)
        except CloudError as e:
            if is_not_found(e):
                metrics.INSTANCE_LIFECYCLE.labels(
                    "deleted", claim.instance_type, claim.zone).inc()
                raise NodeClaimNotFoundError(claim.name)
            raise
        raise CloudError(f"worker {worker_id} still exists after decrement", 500)

    # -- plan execution (same contract as Actuator.execute_plan) -----------

    def execute_plan(self, plan: Plan, nodeclass: NodeClass,
                     catalog: CatalogArrays, nodepool_name: str = "default"
                     ) -> tuple[list[NodeClaim | None], list[str]]:
        claims: list[NodeClaim | None] = []
        errors: list[str] = []
        for planned in plan.nodes:
            try:
                claims.append(self.create_node(planned, nodeclass, catalog,
                                               nodepool_name))
            except Exception as e:  # noqa: BLE001
                claims.append(None)
                errors.append(f"{planned.instance_type}/{planned.zone}: {e}")
        return claims, errors
