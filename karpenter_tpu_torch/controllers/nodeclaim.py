"""NodeClaim lifecycle controllers: registration, startup taints,
termination, garbage collection, tagging.

Reference: ``pkg/controllers/nodeclaim/{registration,startuptaint,
garbagecollection,tagging}`` plus the karpenter-core claim-termination
lifecycle the reference delegates to (standalone framework implements both
halves — SURVEY.md §0).

(Copy of ``karpenter_tpu/controllers/nodeclaim.py``.)
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.apis.nodeclaim import Node, NodeClaim, parse_provider_id
from karpenter_tpu_torch.apis.pod import Taint, pod_key
from karpenter_tpu_torch.cloud.errors import CloudError, NodeClaimNotFoundError, is_not_found
from karpenter_tpu_torch.controllers.runtime import PollController, Result, WatchController
from karpenter_tpu_torch.core.actuator import KARPENTER_TAGS, Actuator
from karpenter_tpu_torch.core.bootstrap import TAINT_UNREGISTERED
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.nodeclaim")

LABEL_INITIALIZED = "karpenter.sh/initialized"
from karpenter_tpu_torch.constants import CLAIM_FINALIZER

# Taint-key prefixes that mean "CNI/cloud init not finished" — startup
# taints are held until these clear (ref startuptaint/controller.go:322-433).
CNI_NOT_READY_PREFIXES = (
    "node.cilium.io", "node.cloudprovider.kubernetes.io",
    "node.kubernetes.io/not-ready", "node.kubernetes.io/network-unavailable",
)


def _claim_for_node(cluster: ClusterState, node: Node) -> NodeClaim | None:
    for claim in cluster.nodeclaims():
        if claim.provider_id and claim.provider_id == node.provider_id:
            return claim
    return None


class RegistrationController(WatchController):
    """Post-join node<->claim sync (ref registration/controller.go:67):
    find the node by providerID (:192), copy labels/annotations/taints from
    the claim (:238-391), set Registered, then Initialized + the
    initialized label once the node reports Ready (:393-463)."""

    name = "nodeclaim.registration"
    watch_kinds = ("nodes", "nodeclaims")

    def __init__(self, cluster: ClusterState):
        self.cluster = cluster

    def map_event(self, kind: str, event_type: str, obj) -> str | None:
        if kind == "nodes":
            claim = _claim_for_node(self.cluster, obj)
            return claim.name if claim else None
        return getattr(obj, "name", None)

    def reconcile(self, key: str) -> Result:
        claim = self.cluster.get_nodeclaim(key)
        if claim is None or claim.deleted or not claim.launched:
            return Result()
        node = self._find_node(claim)
        if node is None:
            return Result()   # not joined yet; node ADDED will re-trigger
        changed = False
        if not claim.registered:
            self._sync_metadata(claim, node)
            claim.registered = True
            claim.registered_at = time.time()
            claim.node_name = node.name
            self.cluster.update("nodeclaims", key, claim)
            self.cluster.record_event("NodeClaim", claim.name, "Normal",
                                      "Registered", f"node {node.name}")
            # SLO ledger: every pod nominated onto this claim now has a
            # full first-seen -> registered latency (the true end-to-end
            # leg including cloud create + boot + join)
            ledger = obs.get_ledger()
            for pending in self.cluster.pending_pods():
                if pending.nominated_node == claim.name:
                    ledger.registered(pod_key(pending.spec))
            changed = True
        if claim.registered and not claim.initialized and node.ready:
            claim.initialized = True
            self.cluster.update("nodeclaims", key, claim)
            node.labels[LABEL_INITIALIZED] = "true"
            changed = True
        if changed:
            self.cluster.update("nodes", node.name, node)
        return Result()

    def _find_node(self, claim: NodeClaim) -> Node | None:
        for node in self.cluster.nodes():
            if node.provider_id == claim.provider_id and not node.deleted:
                return node
        return None

    def _sync_metadata(self, claim: NodeClaim, node: Node) -> None:
        for k, v in claim.labels.items():
            node.labels.setdefault(k, v)
        for k, v in claim.annotations.items():
            node.annotations.setdefault(k, v)
        have = {(t.key, t.effect) for t in node.taints}
        for t in list(claim.taints) + list(claim.startup_taints):
            if (t.key, t.effect) not in have:
                node.taints.append(t)
        # registration releases the unregistered NoExecute taint the
        # bootstrap applied (registration/controller.go:238-391)
        node.taints = [t for t in node.taints
                       if t.key != TAINT_UNREGISTERED.key]


class StartupTaintController(WatchController):
    """Removes the claim's startup taints once the node is Ready and no
    CNI/init taints remain (ref startuptaint/controller.go:322-433;
    node events map to claims via nodehandler.go)."""

    name = "nodeclaim.startuptaint"
    watch_kinds = ("nodes", "nodeclaims")

    def __init__(self, cluster: ClusterState):
        self.cluster = cluster

    def map_event(self, kind: str, event_type: str, obj) -> str | None:
        if kind == "nodes":
            claim = _claim_for_node(self.cluster, obj)
            return claim.name if claim else None
        return getattr(obj, "name", None)

    def reconcile(self, key: str) -> Result:
        claim = self.cluster.get_nodeclaim(key)
        if claim is None or not claim.registered or not claim.startup_taints:
            return Result()
        node = self.cluster.get_node(claim.node_name) if claim.node_name else None
        if node is None or not node.ready:
            return Result()
        if any(t.key.startswith(CNI_NOT_READY_PREFIXES) for t in node.taints):
            return Result(requeue_after=5.0)   # CNI still settling
        startup = {(t.key, t.effect) for t in claim.startup_taints}
        before = len(node.taints)
        node.taints = [t for t in node.taints
                       if (t.key, t.effect) not in startup]
        if len(node.taints) != before:
            self.cluster.update("nodes", node.name, node)
            self.cluster.record_event(
                "Node", node.name, "Normal", "StartupTaintsRemoved",
                f"removed {before - len(node.taints)} startup taints")
        return Result()


class NodeClaimTerminationController(WatchController):
    """Claim deletion lifecycle (the karpenter-core half): deleted claim ->
    cloud delete -> finalizer release on NodeClaimNotFoundError (the
    contract from vpc/instance/provider.go:1041-1046) -> node removed."""

    name = "nodeclaim.termination"
    watch_kinds = ("nodeclaims",)

    def __init__(self, cluster: ClusterState, actuator: Actuator, factory=None):
        self.cluster = cluster
        self.actuator = actuator
        # optional ProviderFactory: deletes route to the actuator that
        # created the claim (IKS pool decrement vs VPC instance delete)
        self.factory = factory

    def _actuator_for(self, claim):
        if self.factory is not None:
            return self.factory.get_actuator_for_claim(claim)
        return self.actuator

    def reconcile(self, key: str) -> Result:
        claim = self.cluster.get_nodeclaim(key)
        if claim is None or not claim.deleted:
            return Result()
        try:
            self._actuator_for(claim).delete_node(claim)
        except NodeClaimNotFoundError:
            pass   # instance verifiably gone -> release finalizer
        except CloudError as e:
            log.warning("claim delete retrying", claim=key, error=str(e))
            return Result(requeue_after=5.0)
        else:
            # delete_node returning without the not-found signal means the
            # instance may still be draining; verify next pass
            return Result(requeue_after=5.0)
        if CLAIM_FINALIZER in claim.finalizers:
            claim.finalizers.remove(CLAIM_FINALIZER)
        if claim.node_name:
            # node-lifecycle eviction: pods bound to the dying node
            # re-pend (the retry ticker re-windows them)
            self.cluster.evict_node_pods(claim.node_name)
            self.cluster.delete("nodes", claim.node_name)
        self.cluster.delete("nodeclaims", key)
        self.cluster.record_event("NodeClaim", key, "Normal", "Terminated", "")
        return Result()


class GarbageCollectionController(PollController):
    """Cloud<->cluster reconciliation sweep (ref garbagecollection/
    controller.go): instances with no claim -> delete (:106); claims whose
    instance is gone -> finalize; claims never registered past the timeout
    -> replace (:343); orphaned nodes -> delete (:242).  Adaptive interval:
    10s while dirty, 2m when a full sweep finds nothing (:201)."""

    name = "nodeclaim.garbagecollection"
    interval = 120.0
    fast_interval = 10.0
    registration_timeout = 900.0   # 15 min (ref registration TTL)
    min_instance_age = 120.0       # create_instance -> add_nodeclaim race grace

    def __init__(self, cluster: ClusterState, cloud, journal=None):
        from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL

        self.cluster = cluster
        self.cloud = cloud
        self.journal = journal if journal is not None else NULL_JOURNAL

    def reconcile(self) -> Result:
        dirty = 0
        dirty += self._orphan_instances()
        dirty += self._dead_claims()
        dirty += self._unregistered_claims()
        dirty += self._orphan_nodes()
        return Result(requeue_after=self.fast_interval if dirty else self.interval)

    def _claimed_ids(self) -> set:
        ids = set()
        for claim in self.cluster.nodeclaims():
            parsed = parse_provider_id(claim.provider_id)
            if parsed:
                ids.add(parsed[1])
        return ids

    def _orphan_instances(self) -> int:
        """Karpenter-tagged instances with no NodeClaim tracking them."""
        claimed = self._claimed_ids()
        now = time.time()
        n = 0
        for inst in self.cloud.list_instances():
            if inst.id in claimed:
                continue
            if not all(inst.tags.get(k) == v for k, v in KARPENTER_TAGS.items()):
                continue   # not ours — never touch unmanaged instances
            # grace: the actuator creates the instance BEFORE registering
            # the claim; a sweep in that gap must not reap the newborn
            if now - inst.created_at < self.min_instance_age:
                continue
            try:
                with self.journal.intent("orphan_delete", instance=inst.id,
                                         reason="gc_sweep"):
                    self.cloud.delete_instance(inst.id)
                n += 1
                metrics.INSTANCE_LIFECYCLE.labels(
                    "gc_orphan_instance", inst.profile, inst.zone).inc()
                log.info("GC: deleted orphan instance", instance=inst.id)
            except CloudError as e:
                if not is_not_found(e):
                    log.warning("GC: orphan delete failed", instance=inst.id,
                                error=str(e))
        return n

    def _dead_claims(self) -> int:
        """Claims whose backing instance no longer exists -> mark deleted so
        the termination controller finalizes them."""
        n = 0
        for claim in self.cluster.nodeclaims():
            if claim.deleted or not claim.launched:
                continue
            parsed = parse_provider_id(claim.provider_id)
            if parsed is None:
                continue
            try:
                self.cloud.get_instance(parsed[1])
            except CloudError as e:
                if is_not_found(e):
                    claim.deleted = True
                    self.cluster.update("nodeclaims", claim.name, claim)
                    self.cluster.record_event(
                        "NodeClaim", claim.name, "Warning", "InstanceGone",
                        "backing instance disappeared; finalizing claim")
                    n += 1
        return n

    def _unregistered_claims(self) -> int:
        """Launched but never registered past the timeout -> give up and
        delete (pods re-pend, next solve replaces the capacity)."""
        now = time.time()
        n = 0
        for claim in self.cluster.nodeclaims():
            if claim.deleted or claim.registered or not claim.launched:
                continue
            if now - claim.created_at > self.registration_timeout:
                claim.deleted = True
                self.cluster.update("nodeclaims", claim.name, claim)
                self.cluster.record_event(
                    "NodeClaim", claim.name, "Warning", "RegistrationTimeout",
                    f"not registered after {self.registration_timeout:.0f}s")
                n += 1
        return n

    def _orphan_nodes(self) -> int:
        """Nodes with a karpenter providerID but no claim and no instance."""
        claimed_pids = {c.provider_id for c in self.cluster.nodeclaims()
                        if c.provider_id}
        n = 0
        for node in self.cluster.nodes():
            parsed = parse_provider_id(node.provider_id)
            if parsed is None or node.provider_id in claimed_pids:
                continue
            try:
                self.cloud.get_instance(parsed[1])
            except CloudError as e:
                if is_not_found(e):
                    self.cluster.evict_node_pods(node.name)
                    self.cluster.delete("nodes", node.name)
                    log.info("GC: deleted orphan node", node=node.name)
                    n += 1
        return n


class TaggingController(PollController):
    """Ensures Karpenter tags on every claimed instance (ref tagging/
    controller.go:62; VPC mode only :130 — the IKS pool path owns its
    workers' tags)."""

    name = "nodeclaim.tagging"
    interval = 300.0

    def __init__(self, cluster: ClusterState, cloud):
        self.cluster = cluster
        self.cloud = cloud

    def reconcile(self) -> Result:
        for claim in self.cluster.nodeclaims():
            if claim.deleted:
                continue
            parsed = parse_provider_id(claim.provider_id)
            if parsed is None:
                continue
            try:
                inst = self.cloud.get_instance(parsed[1])
            except CloudError:
                continue
            want = {**KARPENTER_TAGS,
                    "karpenter.sh/nodepool": claim.nodepool_name,
                    "karpenter-tpu.sh/nodeclass": claim.nodeclass_name}
            missing = {k: v for k, v in want.items() if inst.tags.get(k) != v}
            if missing:
                try:
                    self.cloud.update_tags(parsed[1], {**inst.tags, **missing})
                except CloudError as e:
                    log.warning("tagging failed", instance=parsed[1],
                                error=str(e))
        return Result()
