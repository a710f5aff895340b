"""Preemption controller: executes priority-aware eviction plans.

The planning half lives in ``karpenter_tpu_torch/preempt`` (pure functions);
this controller owns the messy parts:

- **trigger**: pending pods still unnominated after the provisioning
  plane had its chance (``min_pending_age``) — the solve could not
  create capacity for them (blackouts, quota, pool budgets);
- **budgets**: plans run per NodePool with ``pool.preemption_budget``
  as the eviction cap per reconcile round (0 disables the pool; the
  karpenter spec.disruption.budgets analogue);
- **execution**: victims are stamped back into the pending queue
  (unbound, un-nominated, immediate re-window — the provisioner
  re-places them when capacity returns), beneficiaries are nominated
  onto the freed claims for the scheduler/kubelet bind;
- **safety**: the planner structurally cannot evict equal-or-higher
  priority (``preempt/planner.py``), the ResilientPlanner degrades a
  broken batched path on the CPU to the greedy host loop (on the card
  it raises into the manager's counted reconcile error), and the independent
  ``validate_preemption_plan`` oracle gates every execution — an
  invalid plan is dropped with an ERRORS breadcrumb, never actuated;
- **evidence**: ``preempt.plan`` / ``preempt.evict`` spans, Preempted
  events, ``karpenter_tpu_preemptions_total{reason}`` + candidate
  metrics, and an ``eviction_log`` the chaos invariants drain
  (no-priority-inversion, preempted-pods-resolve).

The planner runs on the controller's ``device`` (the card unless the
caller asks for the CPU; resolved at construction).

(Copy of ``karpenter_tpu/controllers/preemption.py``, with the
``device`` keyword.)
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.preempt.degraded import ResilientPlanner
from karpenter_tpu_torch.preempt.encode import encode_victims, occupancy_index
from karpenter_tpu_torch.preempt.types import PlannerOptions
from karpenter_tpu_torch.recovery import crashpoints
from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL
from karpenter_tpu_torch.solver.encode import encode
from karpenter_tpu_torch.solver.validate import validate_preemption_plan
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.preemption")


@dataclass(frozen=True)
class PreemptionRecord:
    """One executed eviction — the chaos invariants' ground-truth row."""

    pod_key: str
    victim_priority: int
    beneficiary_priority: int
    beneficiary: str
    claim_name: str


class PreemptionController(PollController):
    """Singleton poller: plan + execute priority preemption per pool."""

    name = "preemption"
    interval = 15.0

    def __init__(self, cluster: ClusterState, provisioner,
                 options: PlannerOptions | None = None, clock=time.time,
                 min_pending_age: float = 5.0, journal=None, device="cuda"):
        self.cluster = cluster
        # the card unless the caller asks for the CPU: resolved here, so
        # a controller meant for the card raises without one
        self.device = resolve_device(device)
        self.provisioner = provisioner
        # write-ahead journal: evictions record an intent before the
        # first victim moves, and every victim a durable preempted/
        # state row — a restart rebuilds preempted_keys from it
        self.journal = journal if journal is not None else NULL_JOURNAL
        self.options = options or PlannerOptions()
        self.planner = ResilientPlanner(options=self.options,
                                        device=self.device)
        self.clock = clock
        # a pod must have sat unnominated this long before preemption is
        # considered — the provisioning plane (window + retry ticker)
        # gets first shot at CREATING capacity for it.  0 = immediate
        # (the chaos harness, whose pump provisions before every sync).
        # Age is tracked by OUR first-seen stamps, not enqueued_at: the
        # provisioner's retry ticker restamps enqueued_at on every
        # re-window, and both loops run at the same fixed period — an
        # unlucky phase offset would make every stranded pod look
        # permanently "too young" and starve the plane forever.
        self.min_pending_age = min_pending_age
        self._first_pending: dict[str, float] = {}
        # executed-eviction evidence: `eviction_log` is drained per
        # chaos round (no-priority-inversion) and bounded for the
        # operator path, where nothing drains it; `preempted_keys`
        # backs preempted-pods-resolve and is pruned as evicted pods
        # bind again, so neither grows without bound under sustained
        # overload
        self.eviction_log: deque[PreemptionRecord] = deque(maxlen=4096)
        self.preempted_keys: set[str] = set()

    def seed_recovered(self, preempted_keys) -> None:
        """Adopt the restart reconciler's rebuilt ``preempted_keys`` —
        the preempted-pods-resolve contract survives the crash only if
        the new process keeps watching the old process's victims."""
        self.preempted_keys.update(preempted_keys)

    # -- reconcile ---------------------------------------------------------

    def reconcile(self) -> Result:
        if self.provisioner is None:
            return Result()
        now = self.clock()
        for key in list(self.preempted_keys):
            p = self.cluster.get("pods", key)
            if p is None or p.bound_node:
                self.preempted_keys.discard(key)   # resolved (or gone)
                self.journal.state(f"preempted/{key}", None)
        pending = {pod_key(p.spec): p for p in self.cluster.pending_pods()
                   if not p.nominated_node}
        self._first_pending = {k: self._first_pending.get(k, now)
                               for k in pending}
        cutoff = now - self.min_pending_age
        stranded = [p for k, p in pending.items()
                    if self._first_pending[k] <= cutoff]
        if not stranded:
            return Result()
        executed = 0
        budget_blocked = False
        attempted = False
        for pool in self._pools():
            if pool.preemption_budget == 0:
                budget_blocked = True
                continue
            # placements from an earlier pool consume their pods
            stranded = [p for p in stranded if not p.nominated_node]
            if not stranded:
                break
            attempted = True
            executed += self._preempt_pool(pool, stranded)
        if executed:
            log.info("preemption pass", evictions=executed)
        # explain verdict for pods the plane could not help.  A plan
        # that RAN and left them stranded is the most specific truth —
        # no strictly-lower-priority victim worth evicting
        # (priority_starved) — regardless of some OTHER pool being
        # budget-gated; only when no budgeted pool attempted at all is
        # the budget the blocker.
        still = [p for p in stranded if not p.nominated_node]
        if still and (budget_blocked or attempted):
            self._stamp_unhelped(
                still, "priority_starved" if attempted
                else "preemption_budget")
        return Result()

    def _stamp_unhelped(self, stranded: list, reason: str) -> None:
        """Layer the preemption plane's verdict onto the explain
        registry (karpenter_tpu_torch/explain).  Pods whose standing reason is
        STATIC (nothing could ever host them) are skipped — preemption
        was never going to help, and blaming it would contradict the
        consistency oracle."""
        from karpenter_tpu_torch.explain import get_registry
        from karpenter_tpu_torch.explain.validate import STATIC_REASONS

        registry = get_registry()
        for p in stranded:
            key = pod_key(p.spec)
            entry = registry.get(key)
            if entry is not None and entry.reason in STATIC_REASONS:
                continue
            if registry.stamp(key, reason, detail="preemption plane"):
                self.cluster.record_event(
                    "Pod", key, "Warning", "Unplaced",
                    f"cannot place: {reason}")
        registry.update_unplaced_gauge()

    def _pools(self) -> list[NodePool]:
        # the provisioner's resolution, not a reimplementation: it knows
        # the configured default_nodepool name — a hardcoded "default"
        # here would silently dead-end the plane on customized setups
        return self.provisioner._pools()

    def _pool_claims(self, pool: NodePool) -> list:
        # a synthesized pool (no cluster object) also owns claims with
        # no nodepool_name stamp (manually adopted capacity)
        synthesized = self.cluster.get("nodepools", pool.name) is None
        return [c for c in self.cluster.nodeclaims()
                if not c.deleted and c.launched
                and (c.nodepool_name == pool.name
                     or (synthesized and not c.nodepool_name))]

    def _preempt_pool(self, pool: NodePool, stranded: list) -> int:
        claims = self._pool_claims(pool)
        if not claims:
            return 0
        nodeclass = self.cluster.get_nodeclass(pool.nodeclass_name) \
            or self.cluster.get_nodeclass("default")
        if nodeclass is None:
            return 0
        catalog = self.provisioner._catalog_for(nodeclass)
        if catalog is None:
            return 0
        # plan + execute under the solve lock: a concurrent window
        # nominating one of these pods (or onto one of these claims)
        # would race the capacity accounting
        with self.provisioner._solve_lock:
            pods = [p.spec for p in stranded
                    if not p.nominated_node and not p.bound_node]
            if not pods:
                return 0
            t0 = time.perf_counter()
            with obs.span("preempt.plan", pool=pool.name,
                          pending=len(pods)) as sp:
                problem = encode(pods, catalog, pool)
                # one pod-collection scan shared by the victim encoder
                # and the validation oracle (both on this lock-holding
                # path; nothing mutates occupancy between them)
                occupancy = occupancy_index(self.cluster)
                victims = encode_victims(self.cluster, catalog,
                                         claims=claims,
                                         occupancy=occupancy)
                if victims.num_nodes == 0:
                    return 0
                budget = pool.preemption_budget
                self.planner.options.max_evictions = \
                    budget if budget >= 0 else -1
                plan = self.planner.plan(problem, victims)
                sp.set("backend", plan.backend)
                sp.set("candidates", plan.candidate_count)
                sp.set("evictions", plan.eviction_count)
                sp.set("placed", plan.placed_count)
                metrics.PREEMPTION_CANDIDATES.observe(plan.candidate_count)
                metrics.PREEMPTION_PLAN_DURATION.labels(
                    plan.backend).observe(time.perf_counter() - t0)
                if plan.empty:
                    return 0
                # independent oracle gate: never actuate an invalid plan
                errors = validate_preemption_plan(plan, pods, self.cluster,
                                                  catalog, pool,
                                                  occupancy=occupancy)
                if errors:
                    metrics.ERRORS.labels("preempt", "invalid_plan").inc()
                    sp.set("invalid", len(errors))
                    log.error("preemption plan failed validation; dropped",
                              pool=pool.name, errors=errors[:3])
                    return 0
                return self._execute(plan, pool)

    def _execute(self, plan, pool: NodePool) -> int:
        """Evict victims, then nominate beneficiaries (that order: a bind
        racing the eviction must see the capacity already released).
        The whole eviction batch runs under one write-ahead intent: a
        crash mid-batch leaves the intent open, and the restart
        reconciler re-pends exactly the victims the notes say moved."""
        executed = 0
        with self.journal.intent(
                "eviction", pool=pool.name,
                pods=[ev.pod_key for ev in plan.evictions]) as intent:
            for ev in plan.evictions:
                pending = self.cluster.get("pods", ev.pod_key)
                if pending is None:
                    continue
                crashpoints.hit("preempt.mid_evict")
                with obs.span("preempt.evict", pod=ev.pod_key,
                              claim=ev.claim_name,
                              victim_priority=ev.victim_priority,
                              beneficiary_priority=ev.beneficiary_priority):
                    pending.bound_node = ""
                    pending.nominated_node = ""
                    pending.enqueued_at = 0.0   # immediate re-window
                    # SLO ledger: the victim's placement clock restarts —
                    # its re-placement resolves as outcome "replaced"
                    obs.get_ledger().reopen(ev.pod_key, "preempted")
                    executed += 1
                intent.note(f"evicted:{ev.pod_key}", pod=ev.pod_key)
                self.journal.state(f"preempted/{ev.pod_key}", 1)
                metrics.PREEMPTIONS.labels("priority").inc()
                self.cluster.record_event(
                    "Pod", ev.pod_key, "Warning", "Preempted",
                    f"evicted from {ev.claim_name} (priority "
                    f"{ev.victim_priority}) for a priority "
                    f"{ev.beneficiary_priority} pod")
                rec = PreemptionRecord(
                    pod_key=ev.pod_key, victim_priority=ev.victim_priority,
                    beneficiary_priority=ev.beneficiary_priority,
                    beneficiary=ev.beneficiary, claim_name=ev.claim_name)
                self.eviction_log.append(rec)
                self.preempted_keys.add(ev.pod_key)
        placed = 0
        for pn, claim_name in plan.placements.items():
            pending = self.cluster.get("pods", pn)
            if pending is None or pending.bound_node \
                    or pending.nominated_node:
                continue
            pending.nominated_node = claim_name
            self.journal.state(f"nom/{pn}", claim_name)
            obs.get_ledger().resolve(pn, "placed")
            from karpenter_tpu_torch.explain import get_registry

            get_registry().resolve(pn)
            placed += 1
            self.cluster.record_event(
                "Pod", pn, "Normal", "PreemptionPlaced",
                f"nominated onto existing node {claim_name} by the "
                f"preemption planner")
        if executed or placed:
            obs.instant("preempt.executed", pool=pool.name,
                        evictions=executed, placed=placed)
        return executed
