"""Disruption controller: drift replacement + consolidation.

In the reference these live in karpenter-core (the drift and disruption
controllers call ``CloudProvider.IsDrifted`` — SURVEY.md §3.4 — and run
empty/underutilized consolidation against the cluster state).  The
standalone framework owns both:

- **Drift replacement**: claims whose NodeClass has moved under them
  (hash/hash-version/image/subnet/security-group drift, core/drift.py)
  are replaced — pods are unbound back to pending, the claim is deleted
  (the termination controller finalizes the instance), and the
  provisioning window re-places the pods against the *current* spec.
- **Empty consolidation**: nodes with no bound pods past the pool's
  ``consolidate_after_seconds`` are removed (policy gate:
  WhenEmpty / WhenEmptyOrUnderutilized).
- **Underutilized consolidation**: karpenter's single-node move — if every
  pod on a node provably fits in the residual capacity of other live
  nodes, bind them there directly (this framework owns the scheduler
  role, so the rebind is ours to do, not a kube-scheduler's) and delete
  the node.  Savings-first order: cheapest-to-remove nodes go first.

The full cost-optimal *repack* (BASELINE config #4) reuses the solver:
``propose_repack`` returns the fresh-solve plan and its cost delta vs the
live fleet; the poll loop only *executes* the safe single-node moves, so
actuation stays idempotent while the repack remains observable (and is
what the repack plane exercises on the card).

The planners run on the controller's ``device`` (the card unless the
caller asks for the CPU; resolved at construction): the migration
repack's ``ResilientRepacker`` on it, the blue/green proposal through
the provisioner's solver on the provisioner's.  A planner on the card
that faults raises out of ``reconcile`` into the manager's counted
reconcile error; no plan is made on the host in its place.

(Copy of ``karpenter_tpu/controllers/disruption.py``, with the
``device`` keyword.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, NodePool
from karpenter_tpu_torch.apis.pod import NUM_RESOURCES
from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.cloudprovider import CloudProvider
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.disruption")


@dataclass(frozen=True)
class RepackRecord:
    """Ground-truth evidence of one EXECUTED migration plan — the chaos
    harness's ``repack-plan-valid`` invariant re-derives plan validity
    (no pod dropped, capacity respected, claimed slices actually
    reopened) from these records + the live cluster, the same drained-
    log discipline the preemption/gang invariants use."""

    migrations: tuple = ()       # (pod_key, src_claim, dst_claim) triples
    drained: tuple = ()          # claim names deleted by the plan
    # (claim_name, offering, shape, pre_mask, post_mask) per reopened
    # slice — geometry evidence the invariant re-enumerates from scratch
    reopened: tuple = ()
    backend: str = ""
    savings_fraction: float = 0.0


@dataclass
class RepackProposal:
    """Observable outcome of a fresh fleet solve vs the live fleet."""

    current_cost: float
    proposed_cost: float
    plan: object = None            # solver Plan
    savings: float = 0.0
    nodeclass: object = None       # resolved once; apply reuses it
    catalog: object = None
    pool: object = None


@dataclass
class _PendingRepack:
    """Phase-2 state: new fleet created, waiting for it to become Ready
    before any pod moves or old capacity drains."""

    new_claims: list
    old_claim_names: list
    pod_map: dict                  # pod key -> new claim name
    deadline: float
    current_cost: float
    proposed_cost: float


class DisruptionController(PollController):
    """Singleton poller (10s — the repack cadence of BASELINE config #4)."""

    name = "disruption"
    interval = 10.0

    def __init__(self, cluster: ClusterState, cloudprovider: CloudProvider,
                 provisioner=None, clock=time.time,
                 repack_enabled: bool = False,
                 repack_min_savings_fraction: float = 0.15,
                 repack_cooldown: float = 600.0,
                 resident_occupancy: bool = False,
                 repack_migrate: bool = True,
                 repack_rebuild: bool = True,
                 repack_options=None, journal=None, device="cuda"):
        from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL

        self.cluster = cluster
        # the card unless the caller asks for the CPU: resolved here, so
        # a controller meant for the card raises without one; the
        # migration repack's planner runs on it
        self.device = resolve_device(device)
        self.cloudprovider = cloudprovider
        self.provisioner = provisioner
        self.clock = clock
        # write-ahead journal: an executed migration plan records an
        # intent before the first rebind, so a crash mid-plan re-pends
        # the interrupted pods on restart (docs/design/recovery.md)
        self.journal = journal if journal is not None else NULL_JOURNAL
        # KARPENTER_ENABLE_RESIDENT: the consolidation passes read node
        # occupancy through ONE shared per-tick snapshot
        # (resident/store.OccupancySnapshot) instead of one full pod
        # scan per claim — results pinned bit-identical to the rescan
        # path (tests/test_resident.py)
        self.resident_occupancy = resident_occupancy
        self._occ = None
        # cost-optimal repack (BASELINE config #4 actuated): OFF by
        # default — blue/green churn is a policy decision, gated like the
        # reference's consolidation policies.  Hysteresis: a minimum
        # savings fraction plus a cooldown between applications.
        self.repack_enabled = repack_enabled
        self.repack_min_savings_fraction = repack_min_savings_fraction
        self.repack_cooldown = repack_cooldown
        self.repack_ready_timeout = 900.0   # new-fleet Ready deadline
        self._last_repack = 0.0             # stamped on EVERY attempt —
        # a converged fleet must not pay a full fresh solve per 10s poll
        self._pending_repack: _PendingRepack | None = None
        # migration-first repack (karpenter_tpu_torch/repack): one batched
        # LP-relaxed plan over EXISTING capacity — drains + defrag moves
        # actuated directly (no create burst, no blue/green wait) when
        # the plan clears the same savings-fraction hysteresis, or
        # reopens a parked gang slice.  The blue/green fresh-solve
        # transition below remains the fallback for savings only a
        # re-typed fleet can reach.
        self.repack_migrate = repack_migrate
        # the blue/green fresh-solve rebuild (phase-1 create burst +
        # Ready-gated cutover).  Off = migration-only repack: no create
        # bursts, no transition state — what the chaos harness runs,
        # where a rollback's re-pended pods would race the round clock.
        self.repack_rebuild = repack_rebuild
        self._repacker = None
        self._repack_options = repack_options
        # ground truth for the chaos repack-plan-valid invariant:
        # executed plans (drained per check) + choke-point validator
        # errors (an invalid plan is never actuated, but the harness
        # must still see that it was produced)
        self.repack_log: list[RepackRecord] = []
        self.repack_violations: list[str] = []

    # -- reconcile ---------------------------------------------------------

    def reconcile(self) -> Result:
        drifted = self._replace_drifted()
        # consolidation pauses while a repack transition is in flight:
        # the new fleet is intentionally empty until cutover, so empty
        # consolidation would reap it (and underutilized moves would use
        # unproven nodes as targets / drain old capacity early)
        transitioning = self._pending_repack is not None
        # the occupancy snapshot is built AFTER drift replacement (which
        # unbinds pods) and stays live through the migration repack (its
        # moves ride rebind(), same as consolidation); it is torn down
        # before the blue/green fallback can renominate pending pods the
        # snapshot does not track (nothing reads it after that point)
        if self.resident_occupancy and not transitioning:
            from karpenter_tpu_torch.resident.store import OccupancySnapshot

            self._occ = OccupancySnapshot(self.cluster)
        try:
            emptied = 0 if transitioning else self._consolidate_empty()
            moved = 0 if transitioning else self._consolidate_underutilized()
            repacked = self._repack_if_profitable() \
                if self.repack_enabled else 0
        finally:
            self._occ = None
        if drifted or emptied or moved or repacked:
            log.info("disruption pass", drifted=drifted, empty=emptied,
                     consolidated=moved, repacked=repacked)
        return Result()

    # -- drift (SURVEY.md §3.4) -------------------------------------------

    def _replace_drifted(self) -> int:
        n = 0
        for claim in self.cluster.nodeclaims():
            if claim.deleted or not claim.registered:
                continue
            reason = self.cloudprovider.is_drifted(claim)
            if not reason:
                continue
            # (is_drifted already counted the detection metric)
            log.info("drifted claim replaced", claim=claim.name,
                     reason=reason)
            self._evict_and_delete(claim)
            n += 1
        return n

    # -- consolidation -----------------------------------------------------

    def _pool_for(self, claim: NodeClaim) -> NodePool:
        pool = self.cluster.get("nodepools", claim.nodepool_name)
        return pool if pool is not None else NodePool(name="default")

    EMPTY_SINCE_ANNOTATION = "karpenter-tpu.sh/empty-since"

    def _consolidate_empty(self) -> int:
        now = self.clock()
        n = 0
        for claim in self.cluster.nodeclaims():
            if claim.deleted or not claim.initialized or not claim.node_name:
                continue
            pool = self._pool_for(claim)
            if pool.consolidation_policy not in (
                    "WhenEmpty", "WhenEmptyOrUnderutilized"):
                continue
            if self._claim_pods(claim):
                # node busy again: reset the emptiness clock so a later
                # drain restarts the consolidateAfter damping window
                if claim.annotations.pop(self.EMPTY_SINCE_ANNOTATION, None):
                    self.cluster.update("nodeclaims", claim.name, claim)
                continue
            # consolidateAfter measures from when the node *became* empty
            # (karpenter semantics), not from node creation — a long-lived
            # node must still wait out the window after its last pod exits
            empty_since = claim.annotations.get(self.EMPTY_SINCE_ANNOTATION)
            if empty_since is None:
                claim.annotations[self.EMPTY_SINCE_ANNOTATION] = repr(now)
                self.cluster.update("nodeclaims", claim.name, claim)
                empty_since = repr(now)
            if now - float(empty_since) < pool.consolidate_after_seconds:
                continue
            log.info("empty node consolidated", claim=claim.name)
            self._evict_and_delete(claim)
            n += 1
        return n

    def _consolidate_underutilized(self) -> int:
        """Single-node move: cheapest removable node whose pods all fit in
        the other nodes' residuals; pods are rebound directly."""
        claims = [c for c in self.cluster.nodeclaims()
                  if not c.deleted and c.initialized and c.node_name
                  and self._pool_for(c).consolidation_policy
                  == "WhenEmptyOrUnderutilized"]
        if len(claims) < 2:
            return 0
        resid = {c.name: self._residual(c) for c in claims}
        moved = 0
        # cheapest first: removing a low-price node frees least value, but
        # is likeliest to fit elsewhere; karpenter sorts by disruption cost
        for claim in sorted(claims, key=lambda c: c.hourly_price):
            pods = self._claim_pods(claim)
            if not pods:
                continue
            if any((p := self.cluster.get("pods", pk)) is not None
                   and (not p.bound_node or p.spec.gang is not None)
                   for pk in pods):
                # in-flight nominations: the node is about to RECEIVE
                # pods — rebinding an unbound nomination here would
                # bypass the kubelet bind.  Gang members are immovable
                # outright: a single-node move scatters an atomically
                # co-located gang (and voids its slice geometry) — the
                # same movability rule the repack plane enforces.
                continue
            placement = self._fit_elsewhere(claim, pods, claims, resid)
            if placement is None:
                continue
            for pod, target in placement:
                p = self.cluster.get("pods", pod)
                if p is not None:
                    # clear the stale nomination: leaving it pointing at
                    # the OLD claim lets that claim's finalizer
                    # (evict_node_pods matches nominated too) rip the
                    # pod off its new home later
                    p.nominated_node = ""
                self.cluster.bind_pod(pod, target.node_name)
                if self._occ is not None:
                    self._occ.rebind(pod, target.node_name, "")
                resid[target.name] = resid[target.name] - \
                    self._pod_req(pod)
            log.info("underutilized node consolidated", claim=claim.name,
                     pods_moved=len(placement))
            self._delete_claim(claim)
            claims.remove(claim)
            moved += 1
        return moved

    # -- repack (observable; BASELINE config #4) --------------------------

    def propose_repack(self) -> RepackProposal | None:
        """Fresh solve of the entire workload vs the live fleet cost.
        Single-pool scope: with multiple NodePools (or pool taints the
        solve can't reproduce without pool context) the repack proposal
        declines rather than produce a fleet stripped of pool policy."""
        if self.provisioner is None:
            return None
        from karpenter_tpu_torch.solver.types import SolveRequest

        pools = self.cluster.list("nodepools")
        if len(pools) > 1:
            return None
        pool = pools[0] if pools else None
        claims = [c for c in self.cluster.nodeclaims() if not c.deleted]
        if not claims:
            return None
        current = sum(c.hourly_price for c in claims)
        wanted = pool.nodeclass_name if pool and pool.nodeclass_name \
            else "default"
        nodeclass = self.cluster.get_nodeclass(wanted)
        if nodeclass is None:
            # decline rather than silently rebuilding the fleet from a
            # DIFFERENT nodeclass (drift would immediately fight it)
            return None
        catalog = self.provisioner._catalog_for(nodeclass)
        if catalog is None:
            return None
        if pool is not None and (pool.cpu_limit_milli
                                 or pool.memory_limit_mib):
            # blue/green repack doubles the pool's footprint during the
            # overlap, which a resource-limited pool cannot absorb;
            # rather than transiently violate spec.limits (or apply a
            # trimmed fleet that strands pods mid-replacement), repack
            # defers to the consolidation paths for capped pools
            log.info("repack skipped: pool has resource limits",
                     pool=pool.name)
            return None
        pods = [p.spec for p in self.cluster.list("pods")]
        if not pods:
            return None
        plan = self.provisioner.solver.solve(
            SolveRequest(pods, catalog, pool))
        return RepackProposal(
            current_cost=current, proposed_cost=plan.total_cost_per_hour,
            plan=plan, savings=current - plan.total_cost_per_hour,
            nodeclass=nodeclass, catalog=catalog, pool=pool)

    def _repack_if_profitable(self) -> int:
        """Two-phase blue/green repack, serialized behind the
        provisioner's solve lock (a concurrent solve window and a repack
        solving the same pods would double-provision).

        Phase 1: fresh solve; when it places everything and saves at
        least the threshold, CREATE the new fleet — and stop.  No pod
        moves, no old capacity drained: the plan is unproven until its
        nodes are Ready.  Phase 2 (subsequent polls): once every new
        claim is initialized, renominate the pods onto their planned
        nodes and drain the old fleet; if the new fleet misses the Ready
        deadline, roll IT back and keep the old fleet serving."""
        if self.provisioner is None:
            return 0
        with self.provisioner._solve_lock:
            if self._pending_repack is not None:
                return self._advance_pending_repack_locked()
            now = self.clock()
            if now - self._last_repack < self.repack_cooldown:
                return 0
            self._last_repack = now   # stamp EVERY attempt (poll damping)
            if self.repack_migrate:
                migrated = self._repack_migrate_locked()
                if migrated:
                    return migrated
            if not self.repack_rebuild:
                return 0
            proposal = self.propose_repack()
            if proposal is None or proposal.current_cost <= 0:
                return 0
            if proposal.plan.unplaced_pods:
                return 0   # the fresh solve can't host the full workload
            if proposal.savings < \
                    self.repack_min_savings_fraction * proposal.current_cost:
                return 0
            old_names = [c.name for c in self.cluster.nodeclaims()
                         if not c.deleted]
            actuator = self.provisioner.actuator_for(proposal.nodeclass)
            # repack creates its fleet in one burst and cannot make
            # incremental progress on partial creates — defer when the
            # plan exceeds the breaker's per-minute budget instead of
            # churning create/rollback every cooldown
            breaker = getattr(actuator, "breaker", None)
            if breaker is not None and getattr(breaker, "config", None) \
                    is not None and breaker.config.enabled and \
                    len(proposal.plan.nodes) > \
                    breaker.config.rate_limit_per_minute:
                log.warning(
                    "repack deferred: plan exceeds the circuit breaker's "
                    "provision rate budget",
                    plan_nodes=len(proposal.plan.nodes),
                    rate_limit=breaker.config.rate_limit_per_minute)
                return 0
            pool_name = proposal.pool.name if proposal.pool is not None \
                else "default"
        # the create burst runs OUTSIDE the solve lock — per-node cloud
        # calls must not stall unrelated solve windows; the old_names
        # snapshot was taken under the lock, so claims a concurrent
        # window creates are never drained at cutover
        new_claims, errors = actuator.execute_plan(
            proposal.plan, proposal.nodeclass, proposal.catalog,
            nodepool_name=pool_name)
        if errors or any(c is None for c in new_claims):
            # roll back: the old fleet keeps serving.  Stamp the cooldown
            # so the failure backs off instead of retrying next poll.
            for c in new_claims:
                if c is not None:
                    self._delete_claim(c)
            # single-writer: only this controller's keyed reconcile
            # thread touches the cooldown stamp, and the create burst
            # deliberately runs outside the solve lock (see above)
            self._last_repack = self.clock()  # graftlint: disable=GL103
            log.warning("repack aborted on partial create",
                        errors=errors[:3])
            return 0
        with self.provisioner._solve_lock:
            pod_map = {pk: claim.name
                       for node, claim in zip(proposal.plan.nodes, new_claims)
                       for pk in node.pod_names}
            # pods that are still PENDING (unnominated, unbound) nominate
            # onto the new fleet immediately — exactly what a provisioner
            # window would do — so no concurrent window double-provisions
            # them during the Ready wait.  Pods bound to old nodes move
            # only at cutover.
            for pk, claim_name in pod_map.items():
                p = self.cluster.get("pods", pk)
                if p is not None and not p.bound_node \
                        and not p.nominated_node:
                    p.nominated_node = claim_name
            self._pending_repack = _PendingRepack(
                new_claims=new_claims, old_claim_names=old_names,
                pod_map=pod_map,
                deadline=self.clock() + self.repack_ready_timeout,
                current_cost=proposal.current_cost,
                proposed_cost=proposal.proposed_cost)
        log.info("repack phase 1: new fleet created, awaiting Ready",
                 new_nodes=len(new_claims), old_nodes=len(old_names))
        return 0   # nothing moved yet

    def _repack_migrate_locked(self) -> int:
        """Migration-first repack: plan one batched LP-relaxed
        consolidation + defrag pass over EXISTING capacity (the
        karpenter_tpu_torch/repack plane, fed from the resident occupancy
        substrate), validate it with the independent
        ``validate_repack_plan`` oracle, then actuate — pods rebound
        directly (this framework owns the scheduler role), emptied
        nodes drained.  Same single-pool scope and savings-fraction
        hysteresis as the blue/green path; a plan that reopens a parked
        gang slice actuates regardless of savings (a starving gang
        outranks cost hysteresis)."""
        if self.provisioner is None:
            return 0
        pools = self.cluster.list("nodepools")
        if len(pools) > 1:
            return 0
        pool = pools[0] if pools else None
        wanted = pool.nodeclass_name if pool and pool.nodeclass_name \
            else "default"
        nodeclass = self.cluster.get_nodeclass(wanted)
        if nodeclass is None:
            return 0
        catalog = self.provisioner._catalog_for(nodeclass)
        if catalog is None:
            return 0
        from karpenter_tpu_torch.repack import (
            ResilientRepacker, RepackOptions, encode_repack,
        )
        from karpenter_tpu_torch.resident.store import resident_store_of
        from karpenter_tpu_torch.solver.validate import validate_repack_plan

        if self._repacker is None:
            self._repacker = ResilientRepacker(
                options=self._repack_options or RepackOptions(),
                device=self.device)
        store = resident_store_of(self.provisioner.solver) \
            if self.resident_occupancy else None
        t0 = time.perf_counter()
        with obs.span("repack.plan", pool=pool.name if pool else "") as sp:
            problem = encode_repack(self.cluster, catalog, pool,
                                    snapshot=self._occ, store=store)
            plan = self._repacker.plan(problem)
            sp.set("backend", plan.backend)
            sp.set("nodes", problem.num_nodes)
            sp.set("migrations", plan.migration_count)
            sp.set("drained", len(plan.drained))
            sp.set("slices_reopened", plan.slices_reopened)
        metrics.REPACK_PLAN_DURATION.labels(plan.backend).observe(
            time.perf_counter() - t0)
        if plan.empty:
            return 0
        profitable = plan.current_cost > 0 and plan.savings >= \
            self.repack_min_savings_fraction * plan.current_cost
        if not profitable and plan.slices_reopened == 0:
            return 0
        # independent oracle gate: never actuate an invalid plan (same
        # choke-point discipline as preempt/gang execution)
        errors = validate_repack_plan(plan, self.cluster, catalog, pool)
        if errors:
            metrics.ERRORS.labels("repack", "invalid_plan").inc()
            self.repack_violations.extend(errors[:10])
            log.error("repack migration plan failed validation; dropped",
                      errors=errors[:3])
            return 0
        return self._actuate_repack_plan(plan)

    def _actuate_repack_plan(self, plan) -> int:
        from karpenter_tpu_torch.repack.types import KIND_DRAIN

        claims = {c.name: c for c in self.cluster.nodeclaims()
                  if not c.deleted}
        moved = 0
        with self.journal.intent(
                "repack_migration",
                migrations=[(m.pod_key, m.src_claim, m.dst_claim)
                            for m in plan.migrations],
                drained=list(plan.drained)) as intent:
            for m in plan.migrations:
                dst = claims.get(m.dst_claim)
                if dst is None:
                    continue
                p = self.cluster.get("pods", m.pod_key)
                if p is not None:
                    # re-home fully: a nomination left dangling on the
                    # source claim would keep counting against its chips
                    p.nominated_node = ""
                self.cluster.bind_pod(m.pod_key, dst.node_name)
                if self._occ is not None:
                    self._occ.rebind(m.pod_key, dst.node_name, "")
                intent.note(f"moved:{m.pod_key}", dst=m.dst_claim)
                metrics.REPACK_MIGRATIONS.labels(
                    "consolidate" if m.kind == KIND_DRAIN else "defrag").inc()
                moved += 1
            drained = 0
            for name in plan.drained:
                claim = self.cluster.get_nodeclaim(name)
                if claim is not None and not claim.deleted:
                    # occupants were all migrated above; eviction only
                    # re-pends stragglers that raced onto the node
                    self._evict_and_delete(claim)
                    drained += 1
        if plan.slices_reopened:
            metrics.REPACK_SLICES_REOPENED.inc(plan.slices_reopened)
        metrics.REPACK_SAVINGS_FRACTION.set(plan.savings_fraction)
        self.repack_log.append(RepackRecord(
            migrations=tuple((m.pod_key, m.src_claim, m.dst_claim)
                             for m in plan.migrations),
            drained=tuple(plan.drained),
            reopened=tuple((r.claim_name, r.offering, tuple(r.shape),
                            r.pre_mask, r.post_mask)
                           for r in plan.reopened),
            backend=plan.backend,
            savings_fraction=plan.savings_fraction))
        self.cluster.record_event(
            "NodeClaim", "fleet", "Normal", "RepackMigrated",
            f"${plan.current_cost:.2f}/h -> ${plan.proposed_cost:.2f}/h "
            f"({moved} pods moved, {drained} nodes drained, "
            f"{plan.slices_reopened} slices reopened)")
        log.info("repack migration plan actuated", migrations=moved,
                 drained=drained, slices_reopened=plan.slices_reopened,
                 backend=plan.backend,
                 savings_fraction=round(plan.savings_fraction, 4))
        defrag_sources = {r.claim_name for r in plan.reopened}
        return drained + len(defrag_sources)

    def _advance_pending_repack_locked(self) -> int:
        pending = self._pending_repack
        fresh = [self.cluster.get_nodeclaim(c.name)
                 for c in pending.new_claims]
        if any(c is None or c.deleted for c in fresh):
            # GC/interruption took a new node out before cutover: abandon
            self._rollback_pending_locked("new fleet lost a node before Ready")
            return 0
        if not all(c.initialized for c in fresh):
            if self.clock() > pending.deadline:
                self._rollback_pending_locked("new fleet missed the Ready deadline")
            return 0
        # cutover: every new node proved Ready — move pods, drain old
        for pk, claim_name in pending.pod_map.items():
            p = self.cluster.get("pods", pk)
            if p is not None:
                p.bound_node = ""
                p.nominated_node = claim_name
        drained = 0
        for name in pending.old_claim_names:
            old = self.cluster.get_nodeclaim(name)
            if old is not None and not old.deleted:
                # pods in pod_map were just renominated (bound_node
                # cleared), so eviction only re-pends stragglers that
                # landed on the old node after the phase-1 snapshot
                self._evict_and_delete(old)
                drained += 1
        self.cluster.record_event(
            "NodeClaim", "fleet", "Normal", "Repacked",
            f"${pending.current_cost:.2f}/h -> "
            f"${pending.proposed_cost:.2f}/h "
            f"({drained} -> {len(pending.new_claims)} nodes)")
        log.info("repack phase 2: cutover complete", drained=drained,
                 new_nodes=len(pending.new_claims))
        self._pending_repack = None
        self._last_repack = self.clock()
        return 1

    def _rollback_pending_locked(self, why: str) -> None:
        for c in self._pending_repack.new_claims:
            live = self.cluster.get_nodeclaim(c.name)
            if live is not None and not live.deleted:
                # eviction, not bare delete: anything that bound onto a
                # new node during the wait must re-pend, not strand
                self._evict_and_delete(live)
        log.warning("repack rolled back", reason=why)
        self._pending_repack = None
        # a failed transition backs off a full cooldown before retrying
        self._last_repack = self.clock()

    # -- helpers -----------------------------------------------------------

    def _claim_pods(self, claim: NodeClaim) -> list[str]:
        """Pods homed on ``claim`` under EITHER name — bound/nominated to
        its node, or nominated onto the claim itself (the provisioner
        nominates by CLAIM name; a node-name-only scan would call a node
        with in-flight nominations 'empty' and strand them on delete).
        Same two-name union as ``preempt.encode.claim_pods``."""
        seen: dict[str, None] = {}
        for name in (claim.node_name, claim.name):
            for pk in self._bound_pods(name):
                seen.setdefault(pk, None)
        return list(seen)

    def _bound_pods(self, node_name: str) -> list[str]:
        from karpenter_tpu_torch.apis.pod import pod_key

        if not node_name:
            # a never-joined claim has node_name "" — matching it against
            # pods would claim every un-nominated pod in the cluster
            return []
        if self._occ is not None:
            # one shared snapshot per tick (KARPENTER_ENABLE_RESIDENT):
            # same pods, same order as the rescan below — in-pass moves
            # and evictions keep it current via rebind()/unbind()
            return self._occ.pods_on(node_name)
        return [pod_key(p.spec) for p in self.cluster.list("pods")
                if p.bound_node == node_name
                or p.nominated_node == node_name]

    def _pod_req(self, pod_key_str: str) -> np.ndarray:
        pending = self.cluster.get("pods", pod_key_str)
        if pending is None:
            return np.zeros(NUM_RESOURCES, dtype=np.int64)
        req = pending.spec.requests.as_tuple()
        return np.array((req[0], req[1], req[2], max(req[3], 1)),
                        dtype=np.int64)

    def _alloc(self, claim: NodeClaim) -> np.ndarray:
        it = self.cloudprovider.instance_types.get(claim.instance_type)
        if it is None:
            return np.zeros(NUM_RESOURCES, dtype=np.int64)
        return np.array((it.allocatable_cpu_milli, it.allocatable_memory_mib,
                         it.gpu, it.pods), dtype=np.int64)

    def _residual(self, claim: NodeClaim) -> np.ndarray:
        resid = self._alloc(claim)
        for pk in self._claim_pods(claim):
            resid = resid - self._pod_req(pk)
        return resid

    def _target_labels(self, claim: NodeClaim) -> dict[str, str]:
        """Effective scheduling labels of the node backing ``claim``: claim
        labels + pool static labels + well-known placement labels (mirrors
        what the actuator/registration stamp on the real node)."""
        from karpenter_tpu_torch.apis.requirements import (
            LABEL_CAPACITY_TYPE, LABEL_HOSTNAME, LABEL_INSTANCE_TYPE,
            LABEL_NODEPOOL, LABEL_ZONE)

        labels = dict(self._pool_for(claim).labels)
        labels.update(claim.labels)
        labels.setdefault(LABEL_INSTANCE_TYPE, claim.instance_type)
        labels.setdefault(LABEL_ZONE, claim.zone)
        labels.setdefault(LABEL_CAPACITY_TYPE, claim.capacity_type)
        labels.setdefault(LABEL_NODEPOOL, claim.nodepool_name)
        labels.setdefault(LABEL_HOSTNAME, claim.node_name)
        return labels

    def _pod_compatible(self, spec, victim: NodeClaim, target: NodeClaim,
                        target_labels: dict[str, str],
                        planned_on_target: list) -> bool:
        """Full compatibility of a pod move onto ``target`` — the same
        constraints the solver's compat mask enforces at placement time
        (node selectors / required affinity, taints, zone co-location,
        hostname anti-affinity cap).  Reference karpenter simulates full
        scheduling before consolidating; moves that only check resources
        can silently break zone pins and taint gates."""
        from karpenter_tpu_torch.apis.pod import tolerates_all
        from karpenter_tpu_torch.solver.encode import (
            _has_hostname_anti_affinity, _has_zone_affinity,
            _zone_spread_constraints)

        if not spec.scheduling_requirements().matches(target_labels):
            return False
        pool = self._pool_for(target)
        if not tolerates_all(spec.tolerations, target.taints) or \
                not tolerates_all(spec.tolerations, pool.taints):
            return False
        # zone co-schedule affinity and DoNotSchedule zone spread: keep the
        # pod in its current zone so group purity / skew is preserved
        if (_has_zone_affinity(spec) or _zone_spread_constraints(spec)) \
                and target.zone != victim.zone:
            return False
        # hostname anti-affinity (self): at most one matching pod per node
        if _has_hostname_anti_affinity(spec):
            own = spec.labels_dict
            for other in self._pods_on(target, planned_on_target):
                if other is not None and all(
                        other.labels_dict.get(k) == v
                        for k, v in own.items()) and own:
                    return False
        return True

    def _pods_on(self, claim: NodeClaim, planned: list):
        """PodSpecs currently bound to ``claim``'s node plus any planned
        moves onto it within this consolidation pass."""
        out = []
        for pk in self._claim_pods(claim):
            pending = self.cluster.get("pods", pk)
            if pending is not None:
                out.append(pending.spec)
        out.extend(planned)
        return out

    def _fit_elsewhere(self, victim: NodeClaim, pods: list[str],
                       claims: list[NodeClaim],
                       resid: dict[str, np.ndarray]
                       ) -> list[tuple[str, NodeClaim]] | None:
        """First-fit each pod into other nodes' residuals (on a working
        copy), honoring the pod's full scheduling constraints against each
        candidate target; None if any pod does not fit."""
        work = {k: v.copy() for k, v in resid.items()}
        placement: list[tuple[str, NodeClaim]] = []
        planned: dict[str, list] = {}
        others = [c for c in claims if c.name != victim.name]
        labels = {c.name: self._target_labels(c) for c in others}
        for pk in pods:
            req = self._pod_req(pk)
            pending = self.cluster.get("pods", pk)
            spec = pending.spec if pending is not None else None
            target = None
            for c in others:
                if not (work[c.name] >= req).all():
                    continue
                if spec is not None and not self._pod_compatible(
                        spec, victim, c, labels[c.name],
                        planned.get(c.name, [])):
                    continue
                target = c
                break
            if target is None:
                return None
            work[target.name] = work[target.name] - req
            if spec is not None:
                planned.setdefault(target.name, []).append(spec)
            placement.append((pk, target))
        return placement

    def _evict_and_delete(self, claim: NodeClaim) -> None:
        """Unbind the node's pods back to pending, then delete the claim
        (the termination controller finalizes the instance; the window
        re-places the pods)."""
        for pk in self._claim_pods(claim):
            pending = self.cluster.get("pods", pk)
            if pending is not None:
                pending.bound_node = ""
                pending.nominated_node = ""
                pending.enqueued_at = 0.0   # immediate re-window
            if self._occ is not None:
                self._occ.unbind(pk)
        self._delete_claim(claim)

    def _delete_claim(self, claim: NodeClaim) -> None:
        claim.deleted = True
        self.cluster.update("nodeclaims", claim.name, claim)
