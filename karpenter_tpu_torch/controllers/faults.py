"""Fault-ring controllers: interruption, spot preemption, orphan cleanup,
catalog/pricing refreshers.

Each is an availability-mask writer (SURVEY.md §7.1 "faults"): their output
feeds ``UnavailableOfferings`` so the next solve window stops picking dead
offerings — the standalone shape of the reference's failure-detection loop
(SURVEY.md §5.3).

(Copy of ``karpenter_tpu/controllers/faults.py``.)
"""

from __future__ import annotations

import os
import time

from karpenter_tpu_torch.apis.nodeclaim import parse_provider_id
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
from karpenter_tpu_torch.cloud.errors import CloudError, is_not_found
from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.core.actuator import KARPENTER_TAGS
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.faults")

ANNOTATION_INTERRUPTED = "karpenter-tpu.sh/interrupted"

# Node-condition heuristics -> interruption classes (ref interruption/
# controller.go:220-255).
_CAPACITY_CONDITIONS = ("OutOfCapacity", "InstanceRetired", "Preempted")
_HEALTH_CONDITIONS = ("KernelDeadlock", "ReadonlyFilesystem",
                      "FrequentKubeletRestart")
_NETWORK_CONDITIONS = ("NetworkUnavailable",)


class InterruptionController(PollController):
    """1-min scan of nodes for interruption signals (ref interruption/
    controller.go:151): condition heuristics with never-ready suppression
    (:259) PLUS the instance metadata-health signal (:304-325 — the
    reference queries the metadata service for health_state
    degraded/faulted; here the cloud API exposes the same field), then
    annotate + event + delete the claim so the replacement cycle runs;
    capacity reasons black out the offering."""

    name = "interruption"
    interval = 60.0
    never_ready_grace = 600.0   # suppress signals on nodes still booting

    def __init__(self, cluster: ClusterState,
                 unavailable: UnavailableOfferings, cloud=None):
        self.cluster = cluster
        self.unavailable = unavailable
        # optional: enables the metadata-health probe (condition
        # heuristics alone otherwise, as when metadata is unreachable —
        # the reference treats that as expected, controller.go:310)
        self.cloud = cloud

    def reconcile(self) -> Result:
        now = time.time()
        health = self._instance_health()
        for node in self.cluster.nodes():
            if node.deleted or ANNOTATION_INTERRUPTED in node.annotations:
                continue
            claim = self._claim_for(node)
            if claim is None or claim.deleted:
                continue
            # never-ready suppression: a node that hasn't become Ready yet
            # is booting, not interrupted (interruption/controller.go:259).
            # Anchored on the CLAIM's registration stamp, never
            # node.created_at alone: a node object recreated by
            # re-adoption would reset the grace window and suppress real
            # interruptions indefinitely.  Before registration stamps it
            # (slow launch, poll ordering) fall back to the LATER of
            # claim/node creation so a freshly joined node still gets
            # its boot grace.
            if not claim.initialized:
                anchor = claim.registered_at \
                    or max(claim.created_at, node.created_at)
                if now - anchor < self.never_ready_grace:
                    continue
            reason = self._interruption_reason(node, health)
            if not reason:
                continue
            self._handle(node, claim, reason)
        return Result()

    def _instance_health(self) -> dict:
        """instance id -> degraded|faulted, from one list call per sweep
        (the per-node metadata probe of the reference, lifted to the
        API so the control plane can see it).  Unreachable cloud ->
        heuristics only, never a failed sweep."""
        if self.cloud is None:
            return {}
        try:
            return {i.id: i.health_state for i in self.cloud.list_instances()
                    if getattr(i, "health_state", "ok")
                    in ("degraded", "faulted")}
        except Exception as e:  # noqa: BLE001 — e.g. a raw socket timeout
            # from the HTTP client; the condition heuristics need no
            # cloud access and must still run this sweep
            log.warning("metadata health probe failed", error=str(e))
            return {}

    def _claim_for(self, node):
        for claim in self.cluster.nodeclaims():
            if claim.provider_id == node.provider_id:
                return claim
        return None

    def _interruption_reason(self, node, health: dict) -> str:
        for cond in _CAPACITY_CONDITIONS:
            if node.conditions.get(cond) == "True":
                return f"capacity:{cond}"
        for cond in _NETWORK_CONDITIONS:
            if node.conditions.get(cond) == "True":
                return f"network:{cond}"
        for cond in _HEALTH_CONDITIONS:
            if node.conditions.get(cond) == "True":
                return f"health:{cond}"
        parsed = parse_provider_id(node.provider_id)
        if parsed and parsed[1] in health:
            # metadata-service health signal (controller.go:316-322)
            return f"health:metadata:{health[parsed[1]]}"
        return ""

    def _handle(self, node, claim, reason: str) -> None:
        node.annotations[ANNOTATION_INTERRUPTED] = reason
        self.cluster.update("nodes", node.name, node)
        self.cluster.record_event("Node", node.name, "Warning", "Interrupted",
                                  reason)
        metrics.INSTANCE_LIFECYCLE.labels("interrupted", claim.instance_type,
                                          claim.zone).inc()
        # capacity interruptions mean the offering is bad right now
        if reason.startswith("capacity:"):
            self.unavailable.mark_unavailable(
                claim.instance_type, claim.zone, claim.capacity_type,
                reason=reason)
        claim.deleted = True   # hand to the termination controller
        self.cluster.update("nodeclaims", claim.name, claim)
        log.info("interrupted node; replacing", node=node.name, reason=reason)


class SpotPreemptionController(PollController):
    """1-min spot scan (ref spot/preemption/controller.go:39-110): stopped
    instances with status_reason stopped_by_preemption -> offering blackout
    for 1h (key type:zone:spot, :97) + delete instance + finalize claim."""

    name = "spot.preemption"
    interval = 60.0
    blackout_ttl = 3600.0

    def __init__(self, cluster: ClusterState, cloud,
                 unavailable: UnavailableOfferings, journal=None):
        from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL

        self.cluster = cluster
        self.cloud = cloud
        self.unavailable = unavailable
        self.journal = journal if journal is not None else NULL_JOURNAL
        # instance ids already counted as interruptions: a stopped
        # instance whose delete keeps failing stays listed for many
        # polls — one real preemption must count ONCE in the risk
        # history, not once per reconcile (pruned against the live
        # list, so the set stays bounded)
        self._counted_interruptions: set[str] = set()

    def reconcile(self) -> Result:
        try:
            spot = self.cloud.list_spot_instances()
        except CloudError as e:
            log.warning("spot list failed", error=str(e))
            return Result()
        preempted = [i for i in spot if i.status == "stopped" and
                     i.status_reason == "stopped_by_preemption"]
        # labeled lifecycle history for the spot risk model
        # (karpenter_tpu_torch/stochastic/risk.py): every live spot instance
        # this round is one exposure, every NEW preemption one
        # interruption — stamped from ground-truth cloud state, so
        # chaos spot storms generate exactly the histories production
        # would
        ledger = obs.get_ledger()
        for inst in spot:
            if inst.status == "running":
                ledger.node_seen(inst.profile, inst.zone)
        self._counted_interruptions &= {i.id for i in preempted}
        for inst in preempted:
            if inst.id not in self._counted_interruptions:
                self._counted_interruptions.add(inst.id)
                ledger.interruption(inst.profile, inst.zone)
            self.unavailable.mark_unavailable(
                inst.profile, inst.zone, "spot",
                ttl=self.blackout_ttl, reason="preempted")
            metrics.INSTANCE_LIFECYCLE.labels("preempted", inst.profile,
                                              inst.zone).inc()
            try:
                with self.journal.intent("orphan_delete", instance=inst.id,
                                         reason="spot_preempted"):
                    self.cloud.delete_instance(inst.id)
            except CloudError as e:
                if not is_not_found(e):
                    log.warning("preempted delete failed", instance=inst.id,
                                error=str(e))
            claim = self._claim_for_instance(inst.id)
            if claim is not None and not claim.deleted:
                claim.deleted = True
                self.cluster.update("nodeclaims", claim.name, claim)
                self.cluster.record_event(
                    "NodeClaim", claim.name, "Warning", "SpotPreempted",
                    f"{inst.profile}/{inst.zone} preempted; offering "
                    f"blacked out {self.blackout_ttl:.0f}s")
        if spot:
            # production learning loop (stochastic/risk.py): re-derive
            # the process risk model from the history this round just
            # extended and persist it through the journal's keyed state
            # records — the provisioner prices every catalog it
            # resolves from this model
            from karpenter_tpu_torch.stochastic.risk import refresh_from_ledger

            refresh_from_ledger(ledger).save(self.journal)
        return Result()

    def _claim_for_instance(self, instance_id: str):
        for claim in self.cluster.nodeclaims():
            parsed = parse_provider_id(claim.provider_id)
            if parsed and parsed[1] == instance_id:
                return claim
        return None


class OrphanCleanupController(PollController):
    """Env-gated two-way orphan sweep (ref orphancleanup/controller.go:117,
    gate KARPENTER_ENABLE_ORPHAN_CLEANUP at controllers.go:238): nodes
    without instances and Karpenter-tagged instances without nodes
    (tag check :350-437)."""

    name = "node.orphancleanup"
    interval = 300.0
    min_instance_age = 600.0   # don't reap instances whose node is booting

    def __init__(self, cluster: ClusterState, cloud, enabled: bool | None = None,
                 journal=None):
        from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL

        self.cluster = cluster
        self.cloud = cloud
        self.journal = journal if journal is not None else NULL_JOURNAL
        self.enabled = (os.environ.get("KARPENTER_ENABLE_ORPHAN_CLEANUP", "")
                        .lower() in ("1", "true", "yes")) if enabled is None \
            else enabled

    def reconcile(self) -> Result:
        if not self.enabled:
            return Result()
        now = time.time()
        # precompute both reference sets once: the sweep must stay
        # O(instances + nodes + claims), not O(instances x (nodes + claims))
        node_ids = set()
        for n in self.cluster.nodes():
            parsed = parse_provider_id(n.provider_id)
            if parsed:
                node_ids.add(parsed[1])
        claim_ids = set()
        for c in self.cluster.nodeclaims():
            parsed = parse_provider_id(c.provider_id)
            if parsed:
                claim_ids.add(parsed[1])
        # instances without nodes (tag-checked — never touch unmanaged)
        for inst in self.cloud.list_instances():
            if not all(inst.tags.get(k) == v for k, v in KARPENTER_TAGS.items()):
                continue
            if now - inst.created_at < self.min_instance_age:
                continue
            if inst.id not in node_ids and inst.id not in claim_ids:
                try:
                    with self.journal.intent("orphan_delete",
                                             instance=inst.id,
                                             reason="orphan_sweep"):
                        self.cloud.delete_instance(inst.id)
                    log.info("orphan cleanup: deleted instance", instance=inst.id)
                except CloudError as e:
                    if not is_not_found(e):
                        log.warning("orphan instance delete failed",
                                    instance=inst.id, error=str(e))
        # nodes without instances
        for node in self.cluster.nodes():
            parsed = parse_provider_id(node.provider_id)
            if parsed is None:
                continue
            try:
                self.cloud.get_instance(parsed[1])
            except CloudError as e:
                if is_not_found(e):
                    self.cluster.delete("nodes", node.name)
                    log.info("orphan cleanup: deleted node", node=node.name)
        return Result()


class InstanceTypeRefreshController(PollController):
    """Hourly catalog refresh + expired-blackout cleanup (ref controllers/
    providers/instancetype/instancetype.go:73)."""

    name = "providers.instancetype"
    interval = 3600.0

    def __init__(self, instance_types: InstanceTypeProvider,
                 unavailable: UnavailableOfferings):
        self.instance_types = instance_types
        self.unavailable = unavailable

    def reconcile(self) -> Result:
        self.instance_types.refresh()
        removed = self.unavailable.cleanup()
        if removed:
            log.info("offering blackouts expired", count=removed)
        return Result()


class PricingRefreshController(PollController):
    """12h pricing refresh (ref controllers/providers/pricing/
    controller.go:73; NoOp fallback :38-50 — a provider without refresh()
    is skipped)."""

    name = "providers.pricing"
    interval = 12 * 3600.0

    def __init__(self, pricing_provider):
        self.pricing = pricing_provider

    def reconcile(self) -> Result:
        refresh = getattr(self.pricing, "refresh", None)
        if callable(refresh):
            refresh()
        return Result()
