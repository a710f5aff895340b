"""NodeClaim -> load balancer registration controller
(port of ``karpenter_tpu/controllers/loadbalancer.py``).

Reference: ``pkg/controllers/nodeclaim/loadbalancer/controller.go:95`` —
when a NodeClass has ``loadBalancerIntegration.enabled``, registered nodes'
IPs join the configured LB pools; deletion (or claim deletion with
``autoDeregister``) removes them (:201).

Registrations are recorded as durable objects in cluster state (the K8s-API
analogue, SURVEY.md §5.4) so deregistration survives controller restarts and
missed DELETED events, and so the sweep poller only ever touches members
karpenter itself registered — never operator-added backends sharing a pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.nodeclass import LoadBalancerTarget
from karpenter_tpu_torch.cloud.errors import CloudError
from karpenter_tpu_torch.cloud.loadbalancer import LoadBalancerProvider
from karpenter_tpu_torch.controllers.runtime import (
    PollController, Result, WatchController,
)
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.loadbalancer")

ANNOTATION_LB_REGISTERED = "karpenter-tpu.sh/lb-registered"


@dataclass
class LBRegistration:
    """Durable record of one claim's LB membership (what karpenter owns)."""

    name: str                                  # claim name
    address: str
    targets: tuple[LoadBalancerTarget, ...]
    auto_deregister: bool = True
    resource_version: int = 0


class LoadBalancerController(WatchController):
    name = "nodeclaim.loadbalancer"
    watch_kinds = ("nodeclaims", "nodes")

    def __init__(self, cluster: ClusterState, provider: LoadBalancerProvider):
        self.cluster = cluster
        self.provider = provider

    def map_event(self, kind: str, event_type: str, obj) -> str | None:
        if kind == "nodes":
            for claim in self.cluster.nodeclaims():
                if claim.provider_id == obj.provider_id:
                    return claim.name
            return None
        return getattr(obj, "name", None)

    def reconcile(self, key: str) -> Result:
        claim = self.cluster.get_nodeclaim(key)
        if claim is None or claim.deleted:
            return self._deregister(key)
        nc = self.cluster.get_nodeclass(claim.nodeclass_name)
        if nc is None or nc.spec.load_balancer_integration is None or \
                not nc.spec.load_balancer_integration.enabled:
            return Result()
        if not claim.registered or not claim.node_name:
            return Result()   # wait for the node join
        if claim.annotations.get(ANNOTATION_LB_REGISTERED) == "true":
            return Result()
        node = self.cluster.get_node(claim.node_name)
        if node is None or not node.addresses:
            return Result()
        address = node.addresses[0]
        integration = nc.spec.load_balancer_integration
        try:
            self.provider.register_instance(integration, address)
        except CloudError as e:
            log.warning("LB registration failed", claim=key, error=str(e))
            self.cluster.record_event("NodeClaim", key, "Warning",
                                      "LBRegistrationFailed", str(e))
            return Result(requeue_after=10.0)
        claim.annotations[ANNOTATION_LB_REGISTERED] = "true"
        self.cluster.update("nodeclaims", key, claim)
        record = LBRegistration(name=key, address=address,
                                targets=tuple(integration.target_groups),
                                auto_deregister=integration.auto_deregister)
        if self.cluster.get("lbregistrations", key) is None:
            self.cluster.add("lbregistrations", key, record)
        else:
            self.cluster.update("lbregistrations", key, record)
        self.cluster.record_event(
            "NodeClaim", key, "Normal", "LBRegistered",
            f"{address} -> {len(integration.target_groups)} pools")
        return Result()

    def _deregister(self, key: str) -> Result:
        record = self.cluster.get("lbregistrations", key)
        if record is None:
            return Result()
        if record.auto_deregister:
            removed, failures = self.provider.remove_targets(record.targets,
                                                             record.address)
            if failures:
                # keep the record: a leaked member keeps routing traffic to
                # a dead backend, and the sweeper can only retry what is
                # still recorded
                return Result(requeue_after=10.0)
            if removed:
                self.cluster.record_event("NodeClaim", key, "Normal",
                                          "LBDeregistered", record.address)
        self.cluster.delete("lbregistrations", key)
        return Result()


class LBMembershipSweeper(PollController):
    """Safety net for missed DELETED events / controller restarts: walks the
    durable registration records and removes membership for claims that no
    longer exist.  Only karpenter-recorded addresses are ever touched —
    operator-added backends sharing a managed pool are invisible to the
    sweep (the reference's eventual-consistency two-way pattern,
    SURVEY.md §5.3, applied to LB membership)."""

    name = "nodeclaim.loadbalancer.sweep"
    interval = 300.0

    def __init__(self, cluster: ClusterState, provider: LoadBalancerProvider):
        self.cluster = cluster
        self.provider = provider

    def reconcile(self) -> Result:
        for record in self.cluster.list("lbregistrations"):
            claim = self.cluster.get_nodeclaim(record.name)
            if claim is not None and not claim.deleted:
                continue
            if record.auto_deregister:
                removed, failures = self.provider.remove_targets(
                    record.targets, record.address)
                if failures:
                    continue   # keep the record; retry next sweep
                if removed:
                    log.info("LB sweep removed stale membership",
                             claim=record.name, address=record.address)
            self.cluster.delete("lbregistrations", record.name)
        return Result()
