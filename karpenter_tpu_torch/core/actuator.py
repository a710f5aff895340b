"""Actuator: executes a placement Plan against the cloud.

The Create side mirrors ``pkg/providers/vpc/instance/provider.go:184-903``
and ``pkg/cloudprovider/cloudprovider.go:249-501``:

- Ready-condition gate on the NodeClass (cloudprovider.go:282-301);
- circuit-breaker gate per (nodeclass, region) with the deferred
  success/failure record balancing concurrency counters (:356-383);
- zone/subnet resolution: plan zone -> status-selected subnets, else best
  free-IP subnet in zone (vpc/instance/provider.go:243-329);
- image from status cache else resolver (:403-475);
- bootstrap user-data generation (:587-597);
- error taxonomy on create: capacity/quota errors feed the
  UnavailableOfferings blackout (the scheduler stops picking dead
  offerings); partial-failure cleanup is the fake cloud's create-side
  atomicity (ref cleans VNI/volume orphans :1192-1312);
- NodeClaim construction with labels from the offering + provider id
  (cloudprovider.go:420-494).

Delete verifies the instance is gone and raises NodeClaimNotFoundError so
the lifecycle releases the finalizer (:993-1061 contract).

(Copy of ``karpenter_tpu/core/actuator.py``.)
"""

from __future__ import annotations

import time
import uuid

from karpenter_tpu_torch.constants import CLAIM_FINALIZER
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, parse_provider_id, provider_id
from karpenter_tpu_torch.apis.nodeclass import (
    ANNOTATION_IMAGE, ANNOTATION_NODECLASS_HASH, ANNOTATION_NODECLASS_HASH_VERSION,
    ANNOTATION_SECURITY_GROUPS, ANNOTATION_SUBNET, NODECLASS_HASH_VERSION, NodeClass,
)
from karpenter_tpu_torch.apis.requirements import (
    LABEL_CAPACITY_TYPE, LABEL_NODEPOOL, LABEL_REGION, LABEL_ZONE,
)
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.cloud.errors import (
    CloudError, NodeClaimNotFoundError, is_capacity, is_not_found, is_quota,
    parse_error,
)
from karpenter_tpu_torch.cloud.image import ImageResolver
from karpenter_tpu_torch.cloud.subnet import SubnetProvider
from karpenter_tpu_torch.core.bootstrap import BootstrapOptions, BootstrapProvider, ClusterConfig
from karpenter_tpu_torch.core.circuitbreaker import CircuitBreakerManager
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.recovery import crashpoints
from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL
from karpenter_tpu_torch.solver.types import Plan, PlannedNode
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.actuator")

KARPENTER_TAGS = {"karpenter.sh/managed": "true"}


class Actuator:
    def __init__(self, cloud, cluster: ClusterState,
                 subnet_provider: SubnetProvider | None = None,
                 image_resolver: ImageResolver | None = None,
                 bootstrap: BootstrapProvider | None = None,
                 breaker: CircuitBreakerManager | None = None,
                 unavailable: UnavailableOfferings | None = None,
                 cluster_config: ClusterConfig | None = None,
                 journal=None):
        self.cloud = cloud
        self.cluster = cluster
        # write-ahead intent journal (karpenter_tpu/recovery): every
        # staged create / delete records a durable intent before its
        # first RPC; NULL_JOURNAL (the default) no-ops the whole plane
        self.journal = journal if journal is not None else NULL_JOURNAL
        self.subnets = subnet_provider or SubnetProvider(
            cloud, cluster_subnets_fn=cluster.node_count_by_subnet)
        self.images = image_resolver or ImageResolver(cloud)
        self.bootstrap = bootstrap or BootstrapProvider()
        self.breaker = breaker or CircuitBreakerManager()
        self.unavailable = unavailable or UnavailableOfferings()
        self.cluster_config = cluster_config or ClusterConfig()

    # -- create ------------------------------------------------------------

    def create_node(self, planned: PlannedNode, nodeclass: NodeClass,
                    catalog: CatalogArrays, nodepool_name: str = "default") -> NodeClaim:
        """Launch one instance for a planned node; returns the launched
        NodeClaim (registered into cluster state)."""
        with obs.span("actuate.create",
                      instance_type=planned.instance_type, zone=planned.zone,
                      capacity_type=planned.capacity_type,
                      nodeclass=nodeclass.name) as sp:
            claim = self._create_node_span(planned, nodeclass, catalog,
                                           nodepool_name, sp)
            sp.set("claim", claim.name)
            return claim

    def _create_node_span(self, planned: PlannedNode, nodeclass: NodeClass,
                          catalog: CatalogArrays, nodepool_name: str,
                          sp) -> NodeClaim:
        if not nodeclass.status.is_ready():
            self.cluster.record_event("NodeClass", nodeclass.name, "Warning",
                                      "NotReady", "nodeclass not ready for provisioning")
            raise CloudError(f"nodeclass {nodeclass.name} is not ready",
                             status_code=409, retryable=False)
        region = nodeclass.spec.region
        self.breaker.can_provision(nodeclass.name, region)
        # breaker state AFTER the gate passed (half-open probes show up)
        sp.set("cb_state", self.breaker.get(nodeclass.name, region).state)
        t0 = time.perf_counter()
        try:
            claim = self._do_create(planned, nodeclass, catalog, nodepool_name)
        except Exception as e:
            err = parse_error(e, operation="create_instance")
            self.breaker.record_failure(nodeclass.name, region, str(err))
            self._record_create_failure(planned, nodeclass, err, catalog)
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
        # quota introspection (ref vpc/instance/provider.go:905-991 + the
        # quota_utilization family, metrics.go:45)
        try:
            used, limit = self.cloud.quota_status()
            if limit > 0:
                metrics.QUOTA_UTILIZATION.labels(
                    "instances", nodeclass.spec.region).set(used / limit)
        except Exception:   # quota introspection must never fail a create
            pass
        metrics.COST_PER_HOUR.labels(planned.instance_type, planned.zone,
                                     planned.capacity_type).set(planned.price)
        return claim

    def _do_create(self, planned: PlannedNode, nodeclass: NodeClass,
                   catalog: CatalogArrays, nodepool_name: str) -> NodeClaim:
        subnet_id = self._resolve_subnet(planned.zone, nodeclass)
        image_id = self._resolve_image(nodeclass)
        sgs = tuple(nodeclass.status.resolved_security_groups) or \
            tuple(nodeclass.spec.security_groups)
        node_name = f"karpenter-{nodeclass.name}-{uuid.uuid4().hex[:8]}"
        labels = dict(catalog.offering_label_values(planned.offering_index)) \
            if planned.offering_index >= 0 else {}
        labels[LABEL_REGION] = nodeclass.spec.region
        labels[LABEL_NODEPOOL] = nodepool_name
        user_data = self.bootstrap.user_data(nodeclass, BootstrapOptions(
            cluster=self.cluster_config, node_name=node_name,
            instance_type=planned.instance_type,
            architecture=labels.get("kubernetes.io/arch", "amd64"),
            region=nodeclass.spec.region, zone=planned.zone, labels=labels))

        # write-ahead intent: durable BEFORE the first RPC, carrying
        # everything the restart reconciler needs to finish the create
        # (replay with idempotency keys + nominate) or fence its
        # half-built leftovers (docs/design/recovery.md)
        with self.journal.intent(
                "node_create", node=node_name, nodeclass=nodeclass.name,
                nodepool=nodepool_name, region=nodeclass.spec.region,
                type=planned.instance_type, zone=planned.zone,
                capacity_type=planned.capacity_type, subnet=subnet_id,
                image=image_id, price=planned.price,
                sgs=list(sgs or ()),
                # the rendered bootstrap config: a replayed create whose
                # instance RPC never ran must boot a node that can still
                # join the cluster (an empty user_data node never
                # registers and is GC'd — dead spend)
                user_data=user_data,
                volumes=[{"capacity_gb": b.volume.capacity_gb,
                          "profile": b.volume.profile}
                         for b in nodeclass.spec.block_device_mappings],
                pods=list(planned.pod_names)) as intent:
            crashpoints.hit("actuate.pre_rpc")
            inst = self._staged_create(planned, nodeclass, node_name,
                                       subnet_id, image_id, sgs, user_data,
                                       nodepool_name, intent)
            claim = self._register_claim(planned, nodeclass, nodepool_name,
                                         node_name, subnet_id, image_id,
                                         labels, inst)
            intent.note("claim", name=claim.name)
            # the pods this node was created FOR: survives the intent's
            # completion so a crash after this point (post-create,
            # pre-nominate) still recovers the nomination
            self.journal.state(f"claimpods/{claim.name}",
                               list(planned.pod_names))
        return claim

    def _register_claim(self, planned: PlannedNode, nodeclass: NodeClass,
                        nodepool_name: str, node_name: str, subnet_id: str,
                        image_id: str, labels: dict, inst) -> NodeClaim:
        # the claim inherits the pool's taints/startup taints (karpenter
        # core semantics: NodeClaim carries them, registration syncs them
        # onto the node — registration/controller.go:238-391)
        pool = self.cluster.get("nodepools", nodepool_name)
        claim = NodeClaim(
            name=node_name,
            nodeclass_name=nodeclass.name,
            nodepool_name=nodepool_name,
            taints=tuple(pool.taints) if pool is not None else (),
            startup_taints=tuple(pool.startup_taints)
            if pool is not None else (),
            instance_type=planned.instance_type,
            zone=planned.zone,
            capacity_type=planned.capacity_type,
            provider_id=provider_id(nodeclass.spec.region, inst.id),
            labels={**labels, LABEL_ZONE: planned.zone,
                    LABEL_CAPACITY_TYPE: planned.capacity_type},
            annotations={
                ANNOTATION_NODECLASS_HASH: nodeclass.spec_hash(),
                ANNOTATION_NODECLASS_HASH_VERSION: NODECLASS_HASH_VERSION,
                ANNOTATION_SUBNET: subnet_id,
                ANNOTATION_IMAGE: image_id,
                ANNOTATION_SECURITY_GROUPS: ",".join(sorted(
                    inst.security_group_ids)),
            },
            subnet_id=subnet_id, image_id=image_id,
            security_group_ids=tuple(inst.security_group_ids),
            hourly_price=planned.price,
            launched=True,
            finalizers=[CLAIM_FINALIZER])
        self.cluster.add_nodeclaim(claim)
        self.cluster.record_event("NodeClaim", claim.name, "Normal", "Launched",
                                  f"{planned.instance_type}/{planned.zone}/"
                                  f"{planned.capacity_type} -> {inst.id}")
        return claim

    def _staged_create(self, planned: PlannedNode, nodeclass: NodeClass,
                       node_name: str, subnet_id: str, image_id: str,
                       sgs, user_data: str, nodepool_name: str, intent):
        """Staged allocation with partial-failure cleanup (ref
        vpc/instance/provider.go:333-401 VNI prototype, :477-481 volumes,
        :720-797 create with orphan cleanup :1192-1312): allocate VNI ->
        volumes -> instance; any stage failing deletes what the earlier
        stages allocated, so a failed create leaks nothing.

        Every RPC carries an idempotency key derived from the write-ahead
        intent id and notes its result id back into the journal, so a
        crash at ANY point replays as lookups, never duplicates
        (docs/design/recovery.md)."""
        vni_id = ""
        created_volume_ids: list[str] = []
        try:
            with obs.span("rpc.create_vni", subnet=subnet_id):
                vni_id = self.cloud.create_vni(
                    subnet_id, idempotency_key=intent.idem_key("vni")).id
            intent.note("vni", id=vni_id)
            crashpoints.hit("actuate.mid_create")
            for i, bdm in enumerate(nodeclass.spec.block_device_mappings):
                v = bdm.volume
                with obs.span("rpc.create_volume", index=i):
                    created_volume_ids.append(self.cloud.create_volume(
                        capacity_gb=v.capacity_gb, profile=v.profile,
                        volume_id=f"vol-{node_name}-{i}",
                        idempotency_key=intent.idem_key(f"vol{i}")).id)
                intent.note(f"vol{i}", id=created_volume_ids[-1])
            tags = {**KARPENTER_TAGS,
                    "karpenter.sh/nodepool": nodepool_name,
                    "karpenter-tpu.sh/nodeclass": nodeclass.name}
            if intent.id:
                # ground-truth marker for the no-double-create chaos
                # invariant (detection, not the recovery mechanism —
                # replay dedupe rides the idempotency key)
                tags["karpenter.sh/intent-id"] = intent.id
            with obs.span("rpc.create_instance",
                          instance_type=planned.instance_type,
                          zone=planned.zone,
                          capacity_type=planned.capacity_type):
                inst = self.cloud.create_instance(
                    name=node_name, profile=planned.instance_type,
                    zone=planned.zone, subnet_id=subnet_id,
                    image_id=image_id,
                    capacity_type=planned.capacity_type,
                    security_group_ids=sgs or (),
                    user_data=user_data,
                    vni_id=vni_id, volume_ids=tuple(created_volume_ids),
                    tags=tags,
                    idempotency_key=intent.idem_key("inst"))
            # the response-lost window: the instance exists server-side
            # but its id is not yet durable — exactly the leaked-create
            # failure mode the idempotent replay exists for
            crashpoints.hit("actuate.post_create")
            intent.note("instance", id=inst.id)
            return inst
        except Exception:
            self._cleanup_partial_create(vni_id, created_volume_ids, intent)
            raise

    def _cleanup_partial_create(self, vni_id: str,
                                volume_ids: list[str], intent) -> None:
        """Best-effort orphan deletion — cleanup failure must not mask the
        create error (the GC sweep is the eventual-consistency backstop).
        The intent notes what was cleaned so a crash DURING cleanup still
        replays the remainder."""
        for vid in volume_ids:
            try:
                self.cloud.delete_volume(vid)
                intent.note(f"cleaned:{vid}", id=vid)
            except Exception as e:  # noqa: BLE001
                log.warning("orphan volume cleanup failed", volume=vid,
                            error=str(e))
                metrics.ERRORS.labels("actuator", "orphan_cleanup").inc()
        if vni_id:
            try:
                self.cloud.delete_vni(vni_id)
                intent.note(f"cleaned:{vni_id}", id=vni_id)
            except Exception as e:  # noqa: BLE001
                log.warning("orphan vni cleanup failed", vni=vni_id,
                            error=str(e))
                metrics.ERRORS.labels("actuator", "orphan_cleanup").inc()

    def _resolve_subnet(self, zone: str, nodeclass: NodeClass) -> str:
        """4-way resolution (vpc/instance/provider.go:243-329): explicit
        spec.subnet -> status.selected_subnets filtered by zone -> best
        free-IP subnet in zone."""
        if nodeclass.spec.subnet:
            return nodeclass.spec.subnet
        if nodeclass.status.selected_subnets:
            for sid in nodeclass.status.selected_subnets:
                try:
                    if self.subnets.get_subnet(sid).zone == zone:
                        return sid
                except CloudError:
                    continue
        best = self.subnets.best_subnet_in_zone(zone)
        if best is None:
            raise CloudError(f"no subnet available in zone {zone}", 409,
                             retryable=False)
        return best.id

    def _resolve_image(self, nodeclass: NodeClass) -> str:
        if nodeclass.status.resolved_image_id:
            return nodeclass.status.resolved_image_id
        return self.images.resolve(nodeclass.spec.image,
                                   nodeclass.spec.image_selector)

    def _record_create_failure(self, planned: PlannedNode, nodeclass: NodeClass,
                               err: CloudError,
                               catalog: CatalogArrays | None = None) -> None:
        metrics.ERRORS.labels("actuator", err.code or "unknown").inc()
        # subnet state may have shifted under the 5-min cache (IP counts
        # move with every create); refresh so retries see reality
        self.subnets.invalidate()
        self.cluster.record_event(
            "NodeClass", nodeclass.name, "Warning", "CreateFailed",
            f"{planned.instance_type}/{planned.zone}: {err.message}")
        # capacity/quota failures blackout offerings so the next solve
        # avoids them (ref UnavailableOfferings feedback)
        if is_capacity(err):
            # capacity exhaustion is zonal
            self.unavailable.mark_unavailable(
                planned.instance_type, planned.zone, planned.capacity_type,
                reason=err.code)
        elif is_quota(err):
            # quota is regional: blackout the type in every zone briefly so
            # the solver doesn't burn breaker budget walking the zone list
            zones = catalog.zones if catalog is not None else [planned.zone]
            for z in zones:
                self.unavailable.mark_unavailable(
                    planned.instance_type, z, planned.capacity_type,
                    ttl=300.0, reason=err.code)

    # -- plan execution ----------------------------------------------------

    def execute_plan(self, plan: Plan, nodeclass: NodeClass,
                     catalog: CatalogArrays,
                     nodepool_name: str = "default"
                     ) -> tuple[list[NodeClaim | None], list[str]]:
        """Create every planned node; returns (claims, errors) with claims
        POSITIONALLY aligned to plan.nodes (None = that create failed).  A
        failed node leaves its pods pending for the next solve window (the
        reference's per-NodeClaim create failures behave the same)."""
        with obs.span("actuate.plan", nodes=len(plan.nodes),
                      nodepool=nodepool_name, backend=plan.backend) as sp:
            claims: list[NodeClaim | None] = []
            errors: list[str] = []
            for planned in plan.nodes:
                try:
                    claims.append(self.create_node(planned, nodeclass,
                                                   catalog, nodepool_name))
                except Exception as e:  # noqa: BLE001
                    claims.append(None)
                    errors.append(f"{planned.instance_type}/"
                                  f"{planned.zone}: {e}")
            if errors:
                sp.fail(f"{len(errors)} of {len(plan.nodes)} creates failed")
            return claims, errors

    # -- delete ------------------------------------------------------------

    def delete_node(self, claim: NodeClaim) -> None:
        """Delete the backing instance; raises NodeClaimNotFoundError once
        verifiably gone (finalizer-release contract,
        vpc/instance/provider.go:1041-1046)."""
        parsed = parse_provider_id(claim.provider_id)
        if parsed is None:
            raise NodeClaimNotFoundError(claim.name)
        _, instance_id = parsed
        # journaled delete: a crash between the delete RPC and the
        # verify re-drives the (idempotent) delete on restart.  The
        # success contract RAISES NodeClaimNotFoundError, so that
        # exception closes the intent as ok.
        with self.journal.intent("claim_delete", claim=claim.name,
                                 instance=instance_id,
                                 ok=(NodeClaimNotFoundError,)):
            # expected not-found outcomes are caught INSIDE the spans: a
            # routine successful delete must not mint error traces, or the
            # flight recorder's error ring (reserved for real failures)
            # drowns in the success path
            with obs.span("rpc.delete_instance", instance=instance_id) as sp:
                try:
                    self.cloud.delete_instance(instance_id)
                except CloudError as e:
                    if not is_not_found(e):
                        raise
                    sp.set("already_gone", True)
            # verify gone
            gone = False
            with obs.span("rpc.get_instance", instance=instance_id,
                          verify="post-delete") as sp:
                try:
                    self.cloud.get_instance(instance_id)
                except CloudError as e:
                    if not is_not_found(e):
                        raise
                    gone = True
                    sp.set("gone", True)
            if gone:
                metrics.INSTANCE_LIFECYCLE.labels("deleted",
                                                  claim.instance_type,
                                                  claim.zone).inc()
                self._drop_cost_series(claim)
                # the node is gone for good: its created-for record
                # must not re-nominate pods onto it after a restart
                self.journal.state(f"claimpods/{claim.name}", None)
                raise NodeClaimNotFoundError(claim.name)
            raise CloudError(
                f"instance {instance_id} still exists after delete", 500)

    def _drop_cost_series(self, claim: NodeClaim) -> None:
        """Series hygiene: the COST_PER_HOUR gauge is keyed by
        (instance_type, zone, capacity_type) — drop the label set once the
        LAST claim with that shape is verifiably gone, or churned
        offerings accumulate stale series forever.  A deleted-marked
        sibling still counts as live: the tombstone is set BEFORE the
        cloud delete (which can fail and requeue for minutes), and a
        claim leaves cluster state only once its instance is verifiably
        gone — until then the shape is still billing."""
        for other in self.cluster.nodeclaims():
            if other.name != claim.name \
                    and other.instance_type == claim.instance_type \
                    and other.zone == claim.zone \
                    and other.capacity_type == claim.capacity_type:
                return
        metrics.COST_PER_HOUR.remove(claim.instance_type, claim.zone,
                                     claim.capacity_type)
