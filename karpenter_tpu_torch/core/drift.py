"""Drift detection: is a launched NodeClaim stale vs its NodeClass?

Mirrors the reference's six-check chain (``pkg/cloudprovider/
cloudprovider.go:585-642``): nodeclass-missing (:644), hash-version (:656),
spec-hash (:668), image (:681), subnet (:694), security groups (:726).
A non-empty reason means the disruption loop should replace the node via
the normal Create/Delete cycle.

Also carries the repair-policy table the reference hands to core
node-auto-repair (``cloudprovider.go:775-804``).

(Copy of ``karpenter_tpu/core/drift.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.nodeclass import (
    ANNOTATION_IMAGE, ANNOTATION_NODECLASS_HASH, ANNOTATION_NODECLASS_HASH_VERSION,
    ANNOTATION_SECURITY_GROUPS, ANNOTATION_SUBNET, NODECLASS_HASH_VERSION, NodeClass,
)
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.drift")

# Drift reasons (ref uses string cloudprovider.DriftReason values).
DRIFT_NODECLASS_DELETED = "NodeClassDeleted"
DRIFT_HASH_VERSION = "NodeClassHashVersionDrifted"
DRIFT_HASH = "NodeClassHashDrifted"
DRIFT_IMAGE = "ImageDrifted"
DRIFT_SUBNET = "SubnetDrifted"
DRIFT_SECURITY_GROUPS = "SecurityGroupsDrifted"


def is_drifted(claim: NodeClaim, nodeclass: NodeClass | None) -> str:
    """Returns a drift reason or "" (the reference's IsDrifted contract).

    Checks run in the reference's order; the first hit wins.
    """
    t0 = time.perf_counter()
    reason = _detect(claim, nodeclass)
    metrics.DRIFT_DETECTION_DURATION.observe(time.perf_counter() - t0)
    if reason:
        metrics.DRIFT_DETECTIONS.labels(reason).inc()
    return reason


def _detect(claim: NodeClaim, nodeclass: NodeClass | None) -> str:
    # 1. nodeclass gone (cloudprovider.go:644)
    if nodeclass is None or nodeclass.deleted:
        return DRIFT_NODECLASS_DELETED

    ann = claim.annotations
    # 2. hash schema version changed (:656) — a version bump invalidates all
    # old hashes without comparing them
    if ann.get(ANNOTATION_NODECLASS_HASH_VERSION, "") != NODECLASS_HASH_VERSION:
        return DRIFT_HASH_VERSION

    # 3. spec hash changed (:668)
    claim_hash = ann.get(ANNOTATION_NODECLASS_HASH, "")
    if claim_hash and claim_hash != nodeclass.spec_hash():
        return DRIFT_HASH

    # 4. image drift (:681): claim's launched image vs currently-resolved one
    claim_image = ann.get(ANNOTATION_IMAGE, "") or claim.image_id
    resolved = nodeclass.status.resolved_image_id
    if claim_image and resolved and claim_image != resolved:
        return DRIFT_IMAGE

    # 5. subnet drift (:694): claim's subnet no longer in the allowed set
    # (explicit spec.subnet, else Status.SelectedSubnets)
    claim_subnet = ann.get(ANNOTATION_SUBNET, "") or claim.subnet_id
    if claim_subnet:
        if nodeclass.spec.subnet:
            if claim_subnet != nodeclass.spec.subnet:
                return DRIFT_SUBNET
        elif nodeclass.status.selected_subnets and \
                claim_subnet not in nodeclass.status.selected_subnets:
            return DRIFT_SUBNET

    # 6. security-group drift (:726): set comparison, order-insensitive
    claim_sgs = ann.get(ANNOTATION_SECURITY_GROUPS, "")
    want = nodeclass.status.resolved_security_groups or \
        list(nodeclass.spec.security_groups)
    if claim_sgs and want and set(claim_sgs.split(",")) != set(want):
        return DRIFT_SECURITY_GROUPS

    return ""


# -- repair policies (cloudprovider.go:775-804) -----------------------------

@dataclass(frozen=True)
class RepairPolicy:
    """Replace a node whose condition has been bad past the toleration."""

    condition_type: str
    condition_status: str      # the UNHEALTHY status value
    toleration_seconds: float


def repair_policies() -> list[RepairPolicy]:
    """The reference's table: Ready=False/Unknown 5 min; pressure conditions
    10 min (cloudprovider.go:775-804)."""
    return [
        RepairPolicy("Ready", "False", 300.0),
        RepairPolicy("Ready", "Unknown", 300.0),
        RepairPolicy("MemoryPressure", "True", 600.0),
        RepairPolicy("DiskPressure", "True", 600.0),
        RepairPolicy("PIDPressure", "True", 600.0),
    ]
