"""Restart reconciler: replay open intents against ground truth.

On operator start, :meth:`Reconciler.recover` owns the whole restart
sequence (docs/design/recovery.md "fence-vs-finish decision table"):

1. **replay** (``recovery.replay`` span): read the journal — open
   intents (the actuations a crash interrupted) plus the newest-wins
   state map (nominations, preemption ``preempted_keys``, gang
   admissions);
2. **fence or finish** (``recovery.fence`` span): each open intent is
   resolved against cloud + cluster ground truth, never against the
   journal alone.  A ``node_create`` whose pods still wait is *finished*
   — the staged create replays with the intent's idempotency keys, so
   every RPC that already succeeded is a lookup, not a duplicate — and
   its pods nominated; one whose pods moved on is *fenced* — the
   half-built VNI/volumes/instance are deleted (idempotent-create to
   learn a leaked id, then delete).  Evictions re-pend their noted
   victims; gang placements re-nominate whole or not at all; repack
   migrations conservatively re-pend; claim/orphan deletes re-drive the
   delete (not-found tolerated);
3. **state rebuild**: surviving nominations re-apply where pod and claim
   both still exist; ``preempted_keys`` / gang admission stamps are
   returned for the controllers to adopt.

The caller (operator, chaos harness) then hands off to the existing AOT
prewarm + resident rebuild, so one ``recover()`` path owns the restart.

(Copy of ``karpenter_tpu/recovery/reconciler.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, parse_provider_id, provider_id
from karpenter_tpu_torch.apis.requirements import (
    LABEL_CAPACITY_TYPE, LABEL_NODEPOOL, LABEL_ZONE,
)
from karpenter_tpu_torch.cloud.errors import is_not_found
from karpenter_tpu_torch.constants import CLAIM_FINALIZER
from karpenter_tpu_torch.recovery.journal import (
    KIND_CLAIM_DELETE, KIND_EVICTION, KIND_GANG_PLACEMENT, KIND_NODE_CREATE,
    KIND_ORPHAN_DELETE, KIND_REPACK_MIGRATION, Intent, IntentJournal,
)
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("recovery.reconciler")


@dataclass
class RecoveryReport:
    """What one restart recovery did — the /statusz recovery block."""

    replayed: int = 0              # open intents found in the journal
    finished: int = 0              # completed against ground truth
    fenced: int = 0                # leftovers deleted / state released
    errors: int = 0                # recovery actions that themselves failed
    by_kind: dict[str, str] = field(default_factory=dict)  # id -> outcome
    nominations_restored: int = 0
    preempted_keys: set[str] = field(default_factory=set)
    gang_admitted: dict[str, float] = field(default_factory=dict)
    gang_parked: dict[str, float] = field(default_factory=dict)
    replay_s: float = 0.0
    fence_s: float = 0.0
    duration_s: float = 0.0

    def to_dict(self) -> dict:
        return {
            "replayed": self.replayed, "finished": self.finished,
            "fenced": self.fenced, "errors": self.errors,
            "nominations_restored": self.nominations_restored,
            "preempted_keys": len(self.preempted_keys),
            "gang_admitted": len(self.gang_admitted),
            "gang_parked": len(self.gang_parked),
            "replay_s": round(self.replay_s, 6),
            "fence_s": round(self.fence_s, 6),
            "duration_s": round(self.duration_s, 6),
            "intents": dict(self.by_kind),
        }


class Reconciler:
    def __init__(self, journal: IntentJournal, cloud, cluster):
        self.journal = journal
        self.cloud = cloud
        self.cluster = cluster

    # -- entry -------------------------------------------------------------

    def recover(self) -> RecoveryReport:
        report = RecoveryReport()
        t0 = time.perf_counter()
        with obs.span("recovery.replay") as sp:
            open_intents = self.journal.open_intents()
            state = self.journal.state_map()
            report.replayed = len(open_intents)
            sp.set("open_intents", len(open_intents))
            sp.set("state_keys", len(state))
        report.replay_s = time.perf_counter() - t0
        metrics.RECOVERY_DURATION.labels("replay").observe(report.replay_s)
        t1 = time.perf_counter()
        with obs.span("recovery.fence", intents=len(open_intents)) as sp:
            for intent in open_intents:
                outcome = self._resolve(intent, report)
                report.by_kind[f"{intent.kind}:{intent.id}"] = outcome
                metrics.RECOVERY_INTENTS.labels(intent.kind, outcome).inc()
                if outcome == "finished":
                    report.finished += 1
                elif outcome == "error":
                    report.errors += 1
                else:
                    report.fenced += 1
            self._rebuild_state(state, report)
            sp.set("finished", report.finished)
            sp.set("fenced", report.fenced)
            sp.set("nominations_restored", report.nominations_restored)
        report.fence_s = time.perf_counter() - t1
        metrics.RECOVERY_DURATION.labels("fence").observe(report.fence_s)
        # drop replayed intents + dead state from the file so restart
        # cost stays bounded no matter how many crashes preceded us
        self.journal.compact()
        self.journal.flush()
        report.duration_s = time.perf_counter() - t0
        obs.instant("recovery.done", replayed=report.replayed,
                    finished=report.finished, fenced=report.fenced,
                    errors=report.errors)
        if report.replayed:
            log.info("recovery replayed open intents",
                     replayed=report.replayed, finished=report.finished,
                     fenced=report.fenced, errors=report.errors)
        return report

    # -- per-kind resolution -----------------------------------------------

    def _resolve(self, intent: Intent, report: RecoveryReport) -> str:
        handler = {
            KIND_NODE_CREATE: self._recover_node_create,
            KIND_CLAIM_DELETE: self._recover_instance_delete,
            KIND_ORPHAN_DELETE: self._recover_instance_delete,
            KIND_EVICTION: self._recover_eviction,
            KIND_GANG_PLACEMENT: self._recover_gang_placement,
            KIND_REPACK_MIGRATION: self._recover_repack_migration,
        }.get(intent.kind, self._fence_unknown)
        try:
            outcome = handler(intent, report)
        except Exception as e:  # noqa: BLE001 — recovery must finish the sweep
            log.error("recovery handler failed; intent left to backstops",
                      intent=intent.id, kind=intent.kind, error=str(e)[:200])
            metrics.ERRORS.labels("recovery", intent.kind).inc()
            self.journal.complete(intent, "error", detail=str(e)[:200])
            return "error"
        self.journal.complete(intent, outcome)
        return outcome

    def _pods_pending(self, pod_keys) -> list:
        out = []
        for key in pod_keys or ():
            p = self.cluster.get("pods", key)
            if p is not None and not p.bound_node:
                out.append((key, p))
        return out

    def _nominate_pending(self, pod_keys, claim_name: str,
                          report: RecoveryReport) -> int:
        n = 0
        for key, p in self._pods_pending(pod_keys):
            if not p.nominated_node:
                p.nominated_node = claim_name
                self.journal.state(f"nom/{key}", claim_name)
                n += 1
        report.nominations_restored += n
        return n

    def _recover_node_create(self, intent: Intent,
                             report: RecoveryReport) -> str:
        pl = intent.payload
        node_name = pl.get("node", "")
        claim = self.cluster.get_nodeclaim(node_name)
        if claim is not None and not claim.deleted:
            # the create committed (claim registered); only the
            # nomination may have been lost — finish it
            self._nominate_pending(pl.get("pods"), node_name, report)
            return "finished"
        waiting = [key for key, p in self._pods_pending(pl.get("pods"))
                   if not p.nominated_node]
        if waiting:
            return self._finish_create(intent, report)
        return self._fence_create(intent)

    def _finish_create(self, intent: Intent, report: RecoveryReport) -> str:
        """Replay the staged create with the intent's idempotency keys:
        every stage that already succeeded is a lookup on the cloud
        side, so a finished replay can never double-allocate.

        This mirrors Actuator._staged_create/_register_claim from the
        intent PAYLOAD rather than calling them: the live path re-derives
        subnet/image/bootstrap from a NodeClass that may have changed (or
        vanished) since the crash, and recovery must complete the
        decision that was journaled, not re-make it.  Anything added to
        the live create that replay needs must ride the payload
        (user_data and sgs already do)."""
        pl = intent.payload
        node_name = pl["node"]
        vni = self.cloud.create_vni(pl.get("subnet", ""),
                                    idempotency_key=intent.idem_key("vni"))
        vol_ids = []
        try:
            for i, vol in enumerate(pl.get("volumes") or ()):
                v = self.cloud.create_volume(
                    capacity_gb=int(vol.get("capacity_gb", 100)),
                    profile=vol.get("profile", "general-purpose"),
                    volume_id=f"vol-{node_name}-{i}",
                    idempotency_key=intent.idem_key(f"vol{i}"))
                vol_ids.append(v.id)
            from karpenter_tpu_torch.core.actuator import KARPENTER_TAGS

            inst = self.cloud.create_instance(
                name=node_name, profile=pl.get("type", ""),
                zone=pl.get("zone", ""), subnet_id=pl.get("subnet", ""),
                image_id=pl.get("image", ""),
                capacity_type=pl.get("capacity_type", "on-demand"),
                security_group_ids=tuple(pl.get("sgs") or ()),
                user_data=pl.get("user_data", ""),
                vni_id=vni.id, volume_ids=tuple(vol_ids),
                tags={**KARPENTER_TAGS,
                      "karpenter.sh/nodepool": pl.get("nodepool", "default"),
                      "karpenter-tpu.sh/nodeclass": pl.get("nodeclass", ""),
                      "karpenter.sh/intent-id": intent.id},
                idempotency_key=intent.idem_key("inst"))
        except Exception:
            # the replay itself failed (quota, capacity, blackout): the
            # same partial-sequence cleanup the live path guarantees —
            # nothing the replay allocated may leak
            for vid in vol_ids:
                self._delete_tolerant("delete_volume", vid)
            self._delete_tolerant("delete_vni", vni.id)
            raise
        region = pl.get("region", "")
        pid = provider_id(region, inst.id)
        # the instance may already be registered under a different claim
        # row (a racing sweep adopted it) — never register twice
        for c in self.cluster.nodeclaims():
            if c.provider_id == pid and not c.deleted:
                self._nominate_pending(pl.get("pods"), c.name, report)
                return "finished"
        # pool taints ride the claim exactly as the live path's
        # _register_claim sets them (registration syncs them to the node)
        pool = self.cluster.get("nodepools", pl.get("nodepool", "default"))
        claim = NodeClaim(
            name=node_name, nodeclass_name=pl.get("nodeclass", ""),
            nodepool_name=pl.get("nodepool", "default"),
            taints=tuple(pool.taints) if pool is not None else (),
            startup_taints=tuple(pool.startup_taints)
            if pool is not None else (),
            instance_type=pl.get("type", ""), zone=pl.get("zone", ""),
            capacity_type=pl.get("capacity_type", "on-demand"),
            provider_id=pid,
            labels={LABEL_ZONE: pl.get("zone", ""),
                    LABEL_CAPACITY_TYPE: pl.get("capacity_type",
                                                "on-demand"),
                    LABEL_NODEPOOL: pl.get("nodepool", "default")},
            subnet_id=pl.get("subnet", ""), image_id=pl.get("image", ""),
            hourly_price=float(pl.get("price", 0.0)),
            launched=True, finalizers=[CLAIM_FINALIZER])
        self.cluster.add_nodeclaim(claim)
        self.cluster.record_event(
            "NodeClaim", claim.name, "Normal", "Recovered",
            f"create intent {intent.id} finished on restart -> {inst.id}")
        self._nominate_pending(pl.get("pods"), claim.name, report)
        return "finished"

    def _fence_create(self, intent: Intent) -> str:
        """Nobody is waiting for this node: delete whatever the crashed
        sequence half-built.  Ids come from stage notes when the note
        survived, else from an idempotent re-create (which returns the
        leaked resource under the same key) followed by a delete."""
        pl = intent.payload
        inst_id = (intent.notes.get("instance") or {}).get("id", "")
        if not inst_id and hasattr(self.cloud, "find_by_idempotency"):
            inst_id = self.cloud.find_by_idempotency(
                intent.idem_key("inst")) or ""
        if inst_id:
            self._delete_tolerant("delete_instance", inst_id)
            # the instance delete releases its attached VNI/volumes
            return "fenced"
        for i in range(len(pl.get("volumes") or ())):
            vid = (intent.notes.get(f"vol{i}") or {}).get("id", "")
            if not vid and intent.idem_key(f"vol{i}"):
                vid = self.cloud.create_volume(
                    volume_id=f"vol-{pl.get('node', '')}-{i}",
                    idempotency_key=intent.idem_key(f"vol{i}")).id
            if vid:
                self._delete_tolerant("delete_volume", vid)
        vni_id = (intent.notes.get("vni") or {}).get("id", "")
        if not vni_id and intent.idem_key("vni") and pl.get("subnet"):
            vni_id = self.cloud.create_vni(
                pl["subnet"], idempotency_key=intent.idem_key("vni")).id
        if vni_id:
            self._delete_tolerant("delete_vni", vni_id)
        return "fenced"

    def _delete_tolerant(self, op: str, resource_id: str) -> None:
        try:
            getattr(self.cloud, op)(resource_id)
        except Exception as e:  # noqa: BLE001 — classified below
            if not is_not_found(e):
                log.warning("recovery cleanup delete failed", op=op,
                            resource=resource_id, error=str(e)[:120])
                metrics.ERRORS.labels("recovery", "cleanup_delete").inc()

    def _recover_instance_delete(self, intent: Intent,
                                 report: RecoveryReport) -> str:
        inst_id = intent.payload.get("instance", "")
        if not inst_id:
            claim = self.cluster.get_nodeclaim(
                intent.payload.get("claim", ""))
            parsed = parse_provider_id(claim.provider_id) \
                if claim is not None else None
            inst_id = parsed[1] if parsed else ""
        if not inst_id:
            return "fenced"
        self._delete_tolerant("delete_instance", inst_id)
        return "finished"

    def _recover_eviction(self, intent: Intent,
                          report: RecoveryReport) -> str:
        """Re-pend the victims that were already evicted (idempotent);
        victims the crash spared keep their capacity — the plan's
        beneficiary context died with the process, so re-driving the
        remaining evictions would evict for nobody."""
        evicted = [d.get("pod", "") for s, d in intent.notes.items()
                   if s.startswith("evicted")]
        for key in evicted:
            p = self.cluster.get("pods", key)
            if p is not None and not p.bound_node:
                p.nominated_node = ""
                p.enqueued_at = 0.0
                report.preempted_keys.add(key)
        return "fenced"

    def _recover_gang_placement(self, intent: Intent,
                                report: RecoveryReport) -> str:
        """All-or-nothing, like the placement itself: a live claim gets
        the whole remaining membership nominated; a dead claim releases
        every member back to pending."""
        pl = intent.payload
        claim = self.cluster.get_nodeclaim(pl.get("claim", ""))
        if claim is not None and not claim.deleted:
            self._nominate_pending(pl.get("pods"), claim.name, report)
            return "finished"
        for key, p in self._pods_pending(pl.get("pods")):
            if p.nominated_node == pl.get("claim", ""):
                p.nominated_node = ""
                p.enqueued_at = 0.0
        return "fenced"

    def _recover_repack_migration(self, intent: Intent,
                                  report: RecoveryReport) -> str:
        """Conservative fence: interrupted migrations re-pend their pods
        (the next solve window re-places them against current ground
        truth); drained-source deletion is left to the consolidation
        plane, which re-derives emptiness itself."""
        for m in intent.payload.get("migrations") or ():
            key = m[0] if isinstance(m, (list, tuple)) else m
            p = self.cluster.get("pods", key)
            if p is not None and not p.bound_node:
                p.nominated_node = ""
                p.enqueued_at = 0.0
        return "fenced"

    def _fence_unknown(self, intent: Intent,
                       report: RecoveryReport) -> str:
        log.warning("unknown intent kind fenced", intent=intent.id,
                    kind=intent.kind)
        return "fenced"

    # -- journal state rebuild ---------------------------------------------

    def _rebuild_state(self, state: dict, report: RecoveryReport) -> None:
        for key, value in state.items():
            if key.startswith("nom/"):
                pod_key = key[len("nom/"):]
                p = self.cluster.get("pods", pod_key)
                claim = self.cluster.get_nodeclaim(str(value))
                if p is not None and not p.bound_node \
                        and not p.nominated_node \
                        and claim is not None and not claim.deleted:
                    p.nominated_node = claim.name
                    report.nominations_restored += 1
                elif p is None or p.bound_node:
                    self.journal.state(key, None)   # resolved: tombstone
            elif key.startswith("claimpods/"):
                claim = self.cluster.get_nodeclaim(key[len("claimpods/"):])
                if claim is not None and not claim.deleted:
                    self._nominate_pending(value, claim.name, report)
                else:
                    self.journal.state(key, None)
            elif key.startswith("preempted/"):
                pod_key = key[len("preempted/"):]
                p = self.cluster.get("pods", pod_key)
                if p is None or p.bound_node:
                    self.journal.state(key, None)
                else:
                    report.preempted_keys.add(pod_key)
            elif key.startswith("gang/admitted/"):
                report.gang_admitted[key[len("gang/admitted/"):]] = \
                    float(value)
            elif key.startswith("gang/first_seen/"):
                report.gang_parked[key[len("gang/first_seen/"):]] = \
                    float(value)
