"""NodeClass controllers: hash, status (validation), autoplacement,
termination.

Reference: ``pkg/controllers/nodeclass/{hash,status,autoplacement,
termination}`` (SURVEY.md §2.5).

(Copy of ``karpenter_tpu/controllers/nodeclass.py``.)
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.apis.nodeclass import (
    ANNOTATION_NODECLASS_HASH, ANNOTATION_NODECLASS_HASH_VERSION,
    NODECLASS_HASH_VERSION, NodeClass,
)
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider, filter_instance_types
from karpenter_tpu_torch.cloud.errors import CloudError
from karpenter_tpu_torch.cloud.image import ImageResolver
from karpenter_tpu_torch.cloud.subnet import SubnetProvider
from karpenter_tpu_torch.controllers.runtime import Result, WatchController
from karpenter_tpu_torch.core.cluster import ClusterState, ConflictError
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.nodeclass")

TERMINATION_FINALIZER = "karpenter-tpu.sh/nodeclass-termination"


class NodeClassHashController(WatchController):
    """Stamps the spec-hash + hash-version annotations used for drift
    (ref hash/controller.go:62-84)."""

    name = "nodeclass.hash"
    watch_kinds = ("nodeclasses",)

    def __init__(self, cluster: ClusterState):
        self.cluster = cluster

    def reconcile(self, key: str) -> Result:
        nc = self.cluster.get_nodeclass(key)
        if nc is None or nc.deleted:
            return Result()
        want_hash = nc.spec_hash()
        if nc.annotations.get(ANNOTATION_NODECLASS_HASH) == want_hash and \
                nc.annotations.get(ANNOTATION_NODECLASS_HASH_VERSION) == \
                NODECLASS_HASH_VERSION:
            return Result()
        nc.annotations[ANNOTATION_NODECLASS_HASH] = want_hash
        nc.annotations[ANNOTATION_NODECLASS_HASH_VERSION] = NODECLASS_HASH_VERSION
        self.cluster.update("nodeclasses", key, nc)
        return Result()


class NodeClassStatusController(WatchController):
    """Validates the NodeClass against the cloud, resolves defaults into
    status, and sets the Ready condition (ref status/controller.go: field
    checks :200-222, subnet/zone compat :567-660, image :662-733, SGs :735;
    24h revalidation :44)."""

    name = "nodeclass.status"
    watch_kinds = ("nodeclasses",)
    revalidate_after = 24 * 3600.0

    def __init__(self, cluster: ClusterState, cloud,
                 subnet_provider: SubnetProvider | None = None,
                 image_resolver: ImageResolver | None = None):
        self.cluster = cluster
        self.cloud = cloud
        self.subnets = subnet_provider or SubnetProvider(cloud)
        self.images = image_resolver or ImageResolver(cloud)

    def reconcile(self, key: str) -> Result:
        nc = self.cluster.get_nodeclass(key)
        if nc is None or nc.deleted:
            return Result()
        errs = nc.validate()
        if not errs:
            errs += self._validate_cloud(nc)
        # snapshot the material outcome BEFORE mutating: publishing an
        # update on every pass would re-trigger our own watch (MODIFIED ->
        # re-enqueue -> reconcile), a self-feeding hot loop in live mode
        ready_before = nc.status.is_ready()
        before = (nc.status.validation_error,
                  list(nc.status.resolved_security_groups),
                  nc.status.resolved_image_id)
        nc.status.last_validation_time = time.time()
        if errs:
            nc.status.validation_error = "; ".join(errs)
            nc.status.set_condition("Ready", "False", "ValidationFailed",
                                    nc.status.validation_error)
        else:
            nc.status.validation_error = ""
            self._resolve_status(nc)
            nc.status.set_condition("Ready", "True", "Validated", "")
        after = (nc.status.validation_error,
                 list(nc.status.resolved_security_groups),
                 nc.status.resolved_image_id)
        if before == after and ready_before == nc.status.is_ready():
            return Result(requeue_after=self.revalidate_after)
        if errs:
            self.cluster.record_event("NodeClass", nc.name, "Warning",
                                      "ValidationFailed", nc.status.validation_error)
        try:
            self.cluster.update("nodeclasses", key, nc)
        except ConflictError:
            return Result(requeue_after=1.0)
        return Result(requeue_after=self.revalidate_after)

    def _validate_cloud(self, nc: NodeClass) -> list:
        errs = []
        zones = set(self.cloud.list_zones())
        if nc.spec.zone and nc.spec.zone not in zones:
            errs.append(f"zone {nc.spec.zone} not found in region")
        if nc.spec.subnet:
            try:
                sub = self.subnets.get_subnet(nc.spec.subnet)
                if nc.spec.zone and sub.zone != nc.spec.zone:
                    errs.append(f"subnet {nc.spec.subnet} is in zone "
                                f"{sub.zone}, not {nc.spec.zone}")
            except CloudError:
                errs.append(f"subnet {nc.spec.subnet} not found")
        if nc.spec.instance_profile:
            profiles = {p.name for p in self.cloud.list_instance_profiles()}
            if nc.spec.instance_profile not in profiles:
                errs.append(f"instance profile {nc.spec.instance_profile} "
                            "not found")
        errs += self._validate_vpc_resources(nc)
        try:
            self.images.resolve(nc.spec.image, nc.spec.image_selector)
        except CloudError as e:
            errs.append(f"image resolution failed: {e.message}")
        return errs

    def _validate_vpc_resources(self, nc: NodeClass) -> list:
        """VPC-in-region, security-group, and SSH-key existence (ref
        status/controller.go:471 VPC, :735 SGs, :796 keys).  Cloud hiccups
        during these lookups do NOT fail validation — a transient list
        error must not flip a Ready NodeClass to NotReady.  Capability is
        probed explicitly (getattr) so a client lacking the listing
        surface skips the check, while a genuine bug inside a list
        implementation still surfaces."""
        errs = []
        checks = [
            ("list_vpcs", [nc.spec.vpc] if nc.spec.vpc else [],
             lambda ident: f"VPC {ident} not found in region"),
            ("list_security_groups", list(nc.spec.security_groups),
             lambda ident: f"security group {ident} not found"),
            ("list_ssh_keys", list(nc.spec.ssh_keys),
             lambda ident: f"SSH key {ident} not found"),
        ]
        for method, idents, msg in checks:
            if not idents:
                continue
            fn = getattr(self.cloud, method, None)
            if fn is None:
                continue
            try:
                known = set(fn())
            except CloudError:
                continue
            errs.extend(msg(i) for i in idents if i not in known)
        return errs

    def _resolve_status(self, nc: NodeClass) -> None:
        # default security group when none specified (ref resolves the VPC
        # default SG, status/controller.go:735)
        if nc.spec.security_groups:
            nc.status.resolved_security_groups = list(nc.spec.security_groups)
        else:
            nc.status.resolved_security_groups = [
                self.cloud.get_default_security_group()]
        nc.status.resolved_image_id = self.images.resolve(
            nc.spec.image, nc.spec.image_selector)


class AutoplacementController(WatchController):
    """Resolves instanceRequirements -> Status.SelectedInstanceTypes and
    placementStrategy -> Status.SelectedSubnets (ref autoplacement/
    controller.go:104-242, optimistic-lock patch :248)."""

    name = "nodeclass.autoplacement"
    watch_kinds = ("nodeclasses",)

    def __init__(self, cluster: ClusterState,
                 instance_types: InstanceTypeProvider,
                 subnet_provider: SubnetProvider):
        self.cluster = cluster
        self.instance_types = instance_types
        self.subnets = subnet_provider
        # names already warned about an empty selection — a fresh
        # NodeClass starts with selected==[] so the change-check alone
        # would never emit the first warning, and without the memo every
        # revalidation would re-emit it
        self._warned_empty: set = set()

    def reconcile(self, key: str) -> Result:
        nc = self.cluster.get_nodeclass(key)
        if nc is None or nc.deleted:
            # a recreated NodeClass with the same name must warn afresh
            self._warned_empty.discard(key)
            return Result()
        rv = nc.resource_version
        changed = False
        if nc.spec.instance_requirements is not None:
            changed |= self._select_types(nc)
        if nc.spec.placement_strategy is not None and not nc.spec.subnet:
            changed |= self._select_subnets(nc)
        if changed:
            try:
                self.cluster.update("nodeclasses", key, nc, expect_rv=rv)
            except ConflictError:
                return Result(requeue_after=0.5)
        return Result()

    def _select_types(self, nc: NodeClass) -> bool:
        t0 = time.perf_counter()
        types = filter_instance_types(self.instance_types.list(nc),
                                      nc.spec.instance_requirements)
        selected = [t.name for t in types]
        metrics.AUTOPLACEMENT_DURATION.labels("instance_types").observe(
            time.perf_counter() - t0)
        metrics.AUTOPLACEMENT_SELECTIONS.labels(
            "instance_types", "ok" if selected else "empty").inc()
        if not selected and nc.name not in self._warned_empty:
            self._warned_empty.add(nc.name)
            self.cluster.record_event(
                "NodeClass", nc.name, "Warning", "NoMatchingInstanceTypes",
                "instanceRequirements matched no instance types")
        elif selected:
            self._warned_empty.discard(nc.name)
        if selected == nc.status.selected_instance_types:
            return False
        nc.status.selected_instance_types = selected
        return True

    def _select_subnets(self, nc: NodeClass) -> bool:
        t0 = time.perf_counter()
        subnets = self.subnets.select_subnets(nc.spec.placement_strategy)
        selected = [s.id for s in subnets]
        metrics.AUTOPLACEMENT_DURATION.labels("subnets").observe(
            time.perf_counter() - t0)
        metrics.AUTOPLACEMENT_SELECTIONS.labels(
            "subnets", "ok" if selected else "empty").inc()
        if selected == nc.status.selected_subnets:
            return False
        nc.status.selected_subnets = selected
        return True


class NodeClassTerminationController(WatchController):
    """Finalizer-based deletion: a deleted NodeClass is only removed once no
    NodeClaim references it (ref termination/controller.go:63)."""

    name = "nodeclass.termination"
    watch_kinds = ("nodeclasses", "nodeclaims")

    def __init__(self, cluster: ClusterState):
        self.cluster = cluster

    def map_event(self, kind: str, event_type: str, obj) -> str | None:
        if kind == "nodeclaims":
            # a claim going away may unblock its nodeclass's deletion
            return getattr(obj, "nodeclass_name", None) or None
        return getattr(obj, "name", None)

    def reconcile(self, key: str) -> Result:
        nc = self.cluster.get_nodeclass(key)
        if nc is None:
            return Result()
        if not nc.deleted:
            if TERMINATION_FINALIZER not in nc.finalizers:
                nc.finalizers.append(TERMINATION_FINALIZER)
                self.cluster.update("nodeclasses", key, nc)
            return Result()
        holders = [c.name for c in self.cluster.nodeclaims()
                   if c.nodeclass_name == key and not c.deleted]
        if holders:
            self.cluster.record_event(
                "NodeClass", key, "Warning", "TerminationBlocked",
                f"{len(holders)} NodeClaims still reference this class")
            return Result(requeue_after=10.0)
        if TERMINATION_FINALIZER in nc.finalizers:
            nc.finalizers.remove(TERMINATION_FINALIZER)
        if not nc.finalizers:
            self.cluster.delete("nodeclasses", key)
        return Result()
