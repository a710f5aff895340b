"""Provisioner: the pod-watch -> window -> solve -> actuate loop.

This replaces the karpenter-core provisioning controller + Scheduler.Solve
(SURVEY.md §3.2's hot path) with the batched solve on the card:

  pending pods --watch--> SolveWindow --fire--> Solver.solve
       -> Plan -> Actuator.execute_plan -> NodeClaims -> pods nominated

Per-NodePool flow mirrors GetInstanceTypes' per-pool filtered catalog
(cloudprovider.go:553): each pool solves against the catalog filtered by
its NodeClass's selected instance types; failed creates leave pods pending
for the next window (retry loop).

Port of ``karpenter_tpu/core/provisioner.py``.  ``Provisioner`` takes one
keyword more, ``device`` (default ``"cuda"``), which it resolves at
construction and hands to :func:`make_solver`: without a card it raises.
On the card a failed solve raises out of ``provision_once`` (and into
the window's futures on the watch path) with a log line and no claim;
it is never replaced by a host plan (``solver/degraded.py``).  On the
CPU the window still plans through the greedy degrade, as the
reference's does.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from collections.abc import Sequence

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.nodeclass import NodeClass
from karpenter_tpu_torch.apis.pod import PodSpec, intern_signatures, pod_key
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.cluster import ClusterState, PendingPod
from karpenter_tpu_torch.core.window import SolveWindow, WindowOptions
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.recovery import crashpoints
from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL
from karpenter_tpu_torch.sharded import sharded_shards
from karpenter_tpu_torch.solver.torch_backend import TorchSolver
from karpenter_tpu_torch.solver.types import Plan, SolveRequest, SolverOptions
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.provisioner")


@dataclass
class ProvisionerOptions:
    solver: SolverOptions = field(default_factory=SolverOptions)
    window: WindowOptions = field(default_factory=WindowOptions)
    default_nodepool: str = "default"
    # retry loop: pods whose create failed (or whose node died) re-enter a
    # window after sitting unnominated this long
    retry_interval: float = 15.0


def make_solver(options: SolverOptions | None = None, device="cuda"):
    """The solver for ``options`` on ``device``: the host greedy oracle
    (``GreedySolver``, no device) for ``backend="greedy"``; a sidecar's
    client (``service.RemoteSolver`` at ``options.address``, whose
    device is the sidecar's) for ``backend="remote"``; the sharded
    service (``ShardedSolver``) when ``sharded_shards(options)`` resolves
    more than one shard, as the reference routes it; ``TorchSolver``
    otherwise.

    The device solvers come wrapped in ``ResilientSolver``, as the
    reference's (``karpenter_tpu/core/provisioner.py:51-80``).  On the
    CPU a failed solve or a structurally invalid plan degrades that one
    solve to the greedy oracle, with an ``ERRORS{solver, degraded_*}``
    sample and a ``degraded:`` backend tag; on the card it raises
    (``solver/degraded.py``).  The primary is built first, outside the
    wrapper: a missing card or a failed kernel build raises out of
    ``make_solver``."""
    options = options or SolverOptions()
    if options.backend == "greedy":
        from karpenter_tpu_torch.solver.greedy import GreedySolver

        return GreedySolver(options)
    from karpenter_tpu_torch.solver.degraded import ResilientSolver

    if options.backend == "remote":
        from karpenter_tpu_torch.service import RemoteSolver

        return ResilientSolver(
            RemoteSolver(options.address or "127.0.0.1:50051", options),
            options)
    shards = sharded_shards(options)
    if shards > 1:
        # two degradation layers on the CPU: the sharded plane's own
        # host route for a failed window, then the solver-level greedy
        from karpenter_tpu_torch.sharded.solver import ShardedSolver

        return ResilientSolver(ShardedSolver(shards, options, device=device),
                               options)
    return ResilientSolver(TorchSolver(options, device=device), options)


class Provisioner:
    def __init__(self, cluster: ClusterState, catalog_provider: InstanceTypeProvider,
                 actuator: Actuator, options: ProvisionerOptions | None = None,
                 factory=None, leader=None, journal=None, device="cuda"):
        self.cluster = cluster
        # the card unless the caller asks for the CPU: resolved here, so
        # a provisioner meant for the card raises without one, whatever
        # its backend
        self.device = resolve_device(device)
        self.catalog_provider = catalog_provider
        self.actuator = actuator
        # write-ahead journal (karpenter_tpu/recovery): nominations are
        # recorded as newest-wins state so a restart rebuilds them
        self.journal = journal if journal is not None else NULL_JOURNAL
        # optional ProviderFactory: per-NodeClass VPC/IKS actuation selection
        # (ref factory.go:70); without one, the VPC actuator serves all
        self.factory = factory
        self.options = options or ProvisionerOptions()
        self.solver = make_solver(self.options.solver, device=self.device)
        # actuation gate (core/leaderelection.py): a non-leader replica
        # keeps its watches and window warm but never solves/creates —
        # pods stay pending for the leader (ref controller-runtime leases,
        # controllers.go:37-41)
        self.leader = leader if leader is not None else (lambda: True)
        self._catalog_cache: dict[tuple, CatalogArrays] = {}
        self._lock = threading.Lock()
        # serializes solve+actuate: the window batcher runs handlers on an
        # executor POOL, so back-to-back windows can overlap — two
        # concurrent solves would both see a pod unnominated and
        # double-provision it (karpenter-core runs one scheduling loop at
        # a time for the same reason).  The pending-set recheck in
        # _on_window happens under this lock.
        self._solve_lock = threading.Lock()
        # provider-wide type->(cpu,mem) fallback for pool-limit
        # accounting (claims whose type left the filtered catalog)
        self._all_type_alloc: dict[str, tuple[int, int]] | None = None
        # optional admission gate (callable(PodSpec) -> bool): the gang
        # plane registers one to PARK sub-min_member gangs (and all
        # slice-shaped gangs, which its topology planner owns) out of
        # every solve window — held pods stay pending and re-enter via
        # the retry ticker once admitted (controllers/gang.py)
        self.admission = None
        self._window: SolveWindow | None = None
        self._unsubscribe = None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        """Begin watch-driven provisioning: pod ADDED events feed the
        window; each fired window runs one solve + actuation.  Two repair
        feeds keep pods from stranding: a claim-deletion watch un-nominates
        that claim's pods immediately, and a retry ticker re-windows any pod
        still unnominated after retry_interval (failed creates, unplaceable
        pods waiting out an offering blackout)."""
        self._window = SolveWindow(self._on_window, self.options.window)

        def on_pod_event(event_type: str, pending: PendingPod):
            if event_type == "ADDED" and not pending.bound_node:
                # intern at ingestion (watch-stream time), so the solve
                # window's encode finds every signature token cached —
                # a restart never pays 10k signature constructions
                # inside one window (apis/pod.py intern_signatures)
                intern_signatures((pending.spec,))
                obs.instant("pod.event", pod=pod_key(pending.spec))
                self._window.add(pending.spec)

        def on_claim_event(event_type: str, claim):
            deleted = event_type == "DELETED" or getattr(claim, "deleted", False)
            if deleted and getattr(claim, "name", ""):
                self._renominate_orphans(claim.name)

        def on_pool_event(event_type: str, pool):
            # generation-tracked invalidation (docs/design/resident.md):
            # a NodePool edit changes how windows lower (taints,
            # requirement merging, labels) — the resident store must
            # rebuild from ground truth rather than trust device state
            # encoded under the old pool spec
            store = getattr(self.solver, "resident", None)
            if store is not None:
                store.invalidate("nodepool_edit")

        self._unsubscribe = self.cluster.watch("pods", on_pod_event)
        self._unsub_claims = self.cluster.watch("nodeclaims", on_claim_event)
        self._unsub_pools = self.cluster.watch("nodepools", on_pool_event)
        self._stop_retry = threading.Event()
        self._retry_thread = threading.Thread(
            target=self._retry_loop, name="provisioner-retry", daemon=True)
        self._retry_thread.start()

    def stop(self) -> None:
        if self._unsubscribe:
            self._unsubscribe()
            self._unsubscribe = None
        if getattr(self, "_unsub_claims", None):
            self._unsub_claims()
            self._unsub_claims = None
        if getattr(self, "_unsub_pools", None):
            self._unsub_pools()
            self._unsub_pools = None
        if getattr(self, "_stop_retry", None):
            self._stop_retry.set()
            self._retry_thread.join(timeout=5.0)
        if self._window:
            self._window.close()
            self._window = None

    # -- repair feeds ------------------------------------------------------

    def _renominate_orphans(self, claim_name: str) -> None:
        """A claim died: its nominated (not yet bound) pods go back in the
        queue for the next window (the replacement cycle of SURVEY.md §5.3)."""
        for pending in self.cluster.list("pods"):
            if pending.nominated_node == claim_name and not pending.bound_node:
                pending.nominated_node = ""
                if self._window is not None:
                    self._window.add(pending.spec)

    def _retry_loop(self) -> None:
        while not self._stop_retry.wait(self.options.retry_interval):
            self.requeue_pending()

    def requeue_pending(self) -> int:
        """Re-window every pod that has sat unnominated past the retry
        interval (create failures and blacked-out offerings resolve with
        time; the reference's per-reconcile retry has the same effect)."""
        if self._window is None:
            return 0
        cutoff = time.time() - self.options.retry_interval
        n = 0
        for pending in self.cluster.pending_pods():
            if not pending.nominated_node and pending.enqueued_at <= cutoff:
                pending.enqueued_at = time.time()   # rate-limit re-adds
                self._window.add(pending.spec)
                n += 1
        return n

    # -- synchronous entry (tests, repair loops, consolidation) ------------

    def provision_once(self) -> list[Plan]:
        """Solve + actuate all currently-pending unnominated pods, grouped
        by NodePool.  Returns the executed plans.  Shares the solve lock
        with the window path so repair/consolidation loops can't
        double-provision against an in-flight window."""
        with self._solve_lock:
            pending = [p for p in self.cluster.pending_pods()
                       if not p.nominated_node]
            if not pending:
                return []
            plans, _ = self._provision([p.spec for p in pending])
            return plans

    # -- internals ---------------------------------------------------------

    def _on_window(self, pods: Sequence[PodSpec]) -> Sequence[object]:
        if not self.leader():
            # follower replica: never solve/actuate.  The pods stay
            # pending and unnominated; the retry ticker re-windows them
            # after failover, so nothing strands.
            return [None for _ in pods]
        with self._solve_lock:
            # The retry feeds can enqueue a pod more than once, and a pod
            # added to the window may have been nominated/bound since:
            # solve only the still-pending unnominated set, deduped by
            # key.  The recheck MUST be inside the solve lock — an
            # overlapping window's nomination only becomes visible once
            # its solve completes.
            seen = set()
            to_solve: list[PodSpec] = []
            for p in pods:
                key = pod_key(p)
                if key in seen:
                    continue
                seen.add(key)
                pending = self.cluster.get("pods", key)
                if pending is None or pending.bound_node \
                        or pending.nominated_node:
                    continue
                to_solve.append(p)
            # per-pod outcome = the claim the pod was ACTUALLY nominated
            # onto (pods on failed creates resolve to None, stay pending)
            _, nominated = self._provision(to_solve)
            return [nominated.get(pod_key(p)) for p in pods]

    def _provision(self, pods: list[PodSpec]) -> tuple[list[Plan], dict[str, str]]:
        """Span-wrapped provisioning cycle: the root of the causal chain
        when invoked synchronously (provision_once, chaos, repair loops);
        under a fired window it nests beneath the batch.window span."""
        if self.admission is not None:
            pods = [p for p in pods if self.admission(p)]
            if not pods:
                return [], {}
        with obs.span("provision.cycle", pods=len(pods)) as sp:
            # SLO ledger: this cycle consumed these pods against the
            # cluster state as of NOW — solve_start stamps them and
            # refreshes the pending-staleness gauge (obs/ledger.py)
            obs.get_ledger().solve_start([pod_key(p) for p in pods])
            try:
                plans, nominated = self._provision_pools(pods)
            except Exception as e:
                # on the card a failed solve (DeviceFaultError,
                # InvalidPlanError) raises out of the solver: the caller
                # sees it, and the pods stay pending with no claim for
                # that pool; never a quiet host plan
                log.error("provisioning cycle failed", pods=len(pods),
                          error=f"{type(e).__name__}: {e}"[:300])
                raise
            sp.set("plans", len(plans))
            sp.set("nominated", len(nominated))
            return plans, nominated

    def _provision_pools(self, pods: list[PodSpec]) -> tuple[list[Plan], dict[str, str]]:
        """Two soft-taint passes over the pool ladder (kube's
        PreferNoSchedule semantics: 'prefer not to schedule, but
        allow'): pass 0 offers each pool only the pods that tolerate its
        SOFT taints; pass 1 re-offers whatever remains with the
        preference waived — a pod lands on a soft-tainted pool only when
        no untainted pool could host it.  Hard NoSchedule/NoExecute
        rejection is unchanged (encode(); SURVEY §7.4 soft terms)."""
        from karpenter_tpu_torch.apis.pod import tolerates_soft

        plans: list[Plan] = []
        nominated: dict[str, str] = {}   # pod key -> claim name
        # explain verdicts collected across the pool ladder: the LAST
        # pool's verdict for a pod stands (later pools had the later
        # word on it); only pods still unnominated at window end are
        # recorded (karpenter_tpu/explain)
        window_reasons: dict[str, tuple[str, int, dict | None]] = {}
        # pods trimmed by a pool resource limit this window: the Warning
        # event is emitted only for those STILL unnominated at window
        # end (another pool may place them — an event then would be a
        # false alarm)
        limit_dropped: dict[str, str] = {}  # pod key -> pool name
        # pods a soft-tainted pool was denied in pass 0: ONLY these are
        # re-offered in pass 1 — re-running the whole ladder would
        # double every solve and re-issue failed creates within one
        # window for clusters with no soft taints at all
        soft_excluded: set = set()
        for soft_pass in (0, 1):
            if soft_pass == 1:
                pods = [p for p in pods if pod_key(p) in soft_excluded]
            for pool in self._pools():
                if soft_pass == 0 and pool.taints:
                    pool_pods = []
                    for p in pods:
                        if tolerates_soft(p.tolerations, pool.taints):
                            pool_pods.append(p)
                        else:
                            soft_excluded.add(pod_key(p))
                else:
                    # encode() rejects pods incompatible with the pool
                    pool_pods = pods
                if not pool_pods:
                    continue
                nodeclass = self.cluster.get_nodeclass(pool.nodeclass_name) \
                    or self.cluster.get_nodeclass("default")
                if nodeclass is None:
                    log.warning("no nodeclass for pool", pool=pool.name)
                    continue
                catalog = self._catalog_for(nodeclass)
                if catalog is None:
                    continue
                usage = self._pool_usage(pool, catalog) \
                    if (pool.cpu_limit_milli or pool.memory_limit_mib) \
                    else (0, 0)
                solve_catalog = self._catalog_within_limits(pool, catalog,
                                                            usage)
                if solve_catalog is None:
                    # pool budget exhausted: pods stay pending — but they
                    # must still carry a verdict (another pool's real
                    # solve verdict wins via setdefault; otherwise the
                    # limit_dropped fallback records capacity_exhausted
                    # + the NodePoolLimitReached event at window end)
                    for p in pool_pods:
                        limit_dropped.setdefault(pod_key(p), pool.name)
                    continue
                plan = self.solver.solve(
                    SolveRequest(pool_pods, solve_catalog, pool))
                plan, dropped = self._apply_pool_limits(pool, plan,
                                                        catalog, usage)
                for pn in dropped:
                    limit_dropped.setdefault(pn, pool.name)
                for pn, reason in plan.unplaced_reasons.items():
                    window_reasons[pn] = (
                        reason, plan.unplaced_words.get(pn, 0),
                        plan.unplaced_nearest.get(pn))
                # plan decoded: the snapshot this solve consumed is now
                # this stale (solver-staleness SLO source)
                obs.get_ledger().plan_decoded(
                    [pn for node in plan.nodes for pn in node.pod_names])
                if not plan.nodes:
                    continue
                actuator = self.actuator_for(nodeclass)
                claims, errors = actuator.execute_plan(
                    plan, nodeclass, catalog, pool.name)
                # the stranded-capacity window: claims registered, pods
                # not yet nominated — covered by the actuator's
                # claimpods state records (docs/design/recovery.md)
                crashpoints.hit("provision.pre_nominate")
                # nominate pods onto successfully-created claims
                for node, claim in zip(plan.nodes, claims):
                    if claim is None:
                        continue  # create failed -> pods stay pending
                    for pn in node.pod_names:
                        self._nominate(pn, claim.name)
                        nominated[pn] = claim.name
                if errors:
                    log.warning("plan partially executed", pool=pool.name,
                                errors=errors[:3])
                plans.append(plan)
                # nominated pods are consumed; leftovers roll into the
                # next pool (or the soft-waived second pass)
                pods = [p for p in pods if pod_key(p) not in nominated]
                if not pods:
                    break
            if not pods:
                break
        for pn, pool_name in limit_dropped.items():
            if pn not in nominated:
                self.cluster.record_event(
                    "Pod", pn, "Warning", "NodePoolLimitReached",
                    f"pool {pool_name} resource limit blocks provisioning")
        self._record_unplaced(window_reasons, nominated, limit_dropped)
        return plans, nominated

    def _record_unplaced(self, window_reasons: dict, nominated: dict,
                         limit_dropped: dict) -> None:
        """Window-end explain accounting (karpenter_tpu/explain): every
        pod that stayed unnominated gets its verdict recorded in the
        bounded registry (the /debug/explain surface), an
        ``unplaced:<reason>`` ledger stamp feeding
        ``pod_placement_seconds{outcome="unplaced"}``, and — only when
        the canonical reason CHANGED — a Warning event carrying the
        reason and the window's trace id.  The
        ``karpenter_tpu_unplaced_pods{reason}`` gauge refreshes over the
        full allowlist so counts never linger."""
        from karpenter_tpu_torch.explain import get_registry, word_for

        registry = get_registry()
        ledger = obs.get_ledger()
        cur = obs.current_span()
        trace_id = cur.trace_id if cur is not None else 0
        for pn, pool_name in limit_dropped.items():
            if pn not in nominated and pn not in window_reasons:
                window_reasons[pn] = (
                    "capacity_exhausted", word_for("capacity_exhausted"),
                    None)
        for pn, (reason, word, near) in window_reasons.items():
            if pn in nominated:
                continue
            changed = registry.note(pn, word, reason, nearest=near,
                                    trace_id=trace_id, merge=False)
            ledger.unplaced(pn, reason)
            if changed:
                self.cluster.record_event(
                    "Pod", pn, "Warning", "Unplaced",
                    f"cannot place: {reason} (trace={trace_id})")
        # unconditional: a window that placed its last previously-stuck
        # pod must ZERO that reason's gauge ("counts never linger"), not
        # just windows that produced fresh verdicts
        registry.update_unplaced_gauge()

    def _type_alloc_for(self, name: str, catalog):
        """(cpu_milli, mem_mib) of an instance type: the pool's filtered
        catalog first, then the PROVIDER-WIDE type table — a claim whose
        type was later filtered out of the NodeClass selection must still
        count against the pool limit, or the budget silently resets."""
        try:
            ti = catalog.type_names.index(name)
            return int(catalog.type_alloc[ti, 0]), int(catalog.type_alloc[ti, 1])
        except ValueError:
            pass
        fallback = self._all_type_alloc
        if fallback is None or name not in fallback:
            fallback = {}
            try:
                for it in self.catalog_provider.list():
                    fallback[it.name] = (int(it.allocatable_cpu_milli),
                                         int(it.allocatable_memory_mib))
            except Exception:  # noqa: BLE001 — provider outage: see below
                pass
            self._all_type_alloc = fallback
        if name in fallback:
            return fallback[name]
        log.warning("unknown instance type for pool-limit accounting; "
                    "counting zero", instance_type=name)
        return 0, 0

    def _pool_usage(self, pool: NodePool, catalog):
        """(cpu_milli, mem_mib) currently provisioned by this pool's live
        claims."""
        used_cpu = used_mem = 0
        for claim in self.cluster.list("nodeclaims"):
            if claim.nodepool_name != pool.name or claim.deleted:
                continue
            cpu, mem = self._type_alloc_for(claim.instance_type, catalog)
            used_cpu += cpu
            used_mem += mem
        return used_cpu, used_mem

    def _catalog_within_limits(self, pool: NodePool, catalog, usage):
        """Steer the SOLVE under the pool's remaining resource budget
        (karpenter-core passes remaining capacity into scheduling): a
        shallow catalog view masks out offerings larger than what's left,
        so the solver picks right-sized nodes instead of producing a plan
        the limit trim must discard wholesale.  None = budget exhausted.
        The view gets a DERIVED uid (it must not evict the base
        catalog's device tensors — TorchSolver prunes stale generations per
        uid) and an availability generation keyed by the MASK content,
        which is stable across windows while the binding offering set is
        unchanged."""
        if not pool.cpu_limit_milli and not pool.memory_limit_mib:
            return catalog
        used_cpu, used_mem = usage
        rem_cpu = (pool.cpu_limit_milli - used_cpu) \
            if pool.cpu_limit_milli else None
        rem_mem = (pool.memory_limit_mib - used_mem) \
            if pool.memory_limit_mib else None
        if (rem_cpu is not None and rem_cpu <= 0) or \
                (rem_mem is not None and rem_mem <= 0):
            return None
        import copy
        import hashlib

        alloc = catalog.offering_alloc()
        avail = catalog.off_avail.copy()
        if rem_cpu is not None:
            avail &= alloc[:, 0] <= rem_cpu
        if rem_mem is not None:
            avail &= alloc[:, 1] <= rem_mem
        if avail.sum() == catalog.off_avail.sum():
            return catalog   # budget doesn't bind any offering: no view
        view = copy.copy(catalog)
        view.off_avail = avail
        view.uid = f"{catalog.uid}-limit-{pool.name}"
        view.availability_generation = (
            "pool-limit", hashlib.sha1(avail.tobytes()).hexdigest()[:12],
            catalog.availability_generation)
        return view

    def _apply_pool_limits(self, pool: NodePool, plan: Plan, catalog,
                           usage) -> tuple[Plan, list[str]]:
        """Enforce NodePool resource limits (karpenter-core semantics the
        reference inherits upstream: capacity is never provisioned past
        `spec.limits`; the overflow's pods stay pending).  Plan nodes are
        kept in solver order until existing pool usage + kept nodes
        would exceed the cpu/memory limit; dropped nodes' pods join
        unplaced and retry next window (the limit may have freed up).
        Returns (trimmed plan, dropped pod keys)."""
        if not pool.cpu_limit_milli and not pool.memory_limit_mib:
            return plan, []
        used_cpu, used_mem = usage
        keep = []
        dropped: list[str] = []
        for node in plan.nodes:
            alloc = catalog.offering_alloc()[node.offering_index] \
                if 0 <= node.offering_index < catalog.num_offerings \
                else None
            if alloc is None:
                keep.append(node)
                continue
            over_cpu = pool.cpu_limit_milli and \
                used_cpu + int(alloc[0]) > pool.cpu_limit_milli
            over_mem = pool.memory_limit_mib and \
                used_mem + int(alloc[1]) > pool.memory_limit_mib
            if over_cpu or over_mem:
                dropped.extend(node.pod_names)
                continue
            used_cpu += int(alloc[0])
            used_mem += int(alloc[1])
            keep.append(node)
        if not dropped:
            return plan, []
        log.warning("nodepool limit reached; trimming plan",
                    pool=pool.name, dropped_nodes=len(plan.nodes) - len(keep),
                    pending_pods=len(dropped))
        return Plan(nodes=keep,
                    unplaced_pods=list(plan.unplaced_pods) + dropped,
                    total_cost_per_hour=sum(n.price for n in keep),
                    backend=plan.backend,
                    solve_seconds=plan.solve_seconds), dropped

    def actuator_for(self, nodeclass: NodeClass):
        """Per-NodeClass actuation routing (ref factory.go:70) — the ONE
        place selection logic lives; repack and the window path share it."""
        if self.factory is not None:
            return self.factory.get_actuator(nodeclass)
        return self.actuator

    def _nominate(self, key: str, node_name: str) -> None:
        pending = self.cluster.get("pods", key)
        if pending is not None:
            pending.nominated_node = node_name
            # durable nomination record: newest wins, rebuilt on restart
            self.journal.state(f"nom/{key}", node_name)
            # terminal ledger edge: placement decision latency observed
            # into karpenter_tpu_pod_placement_seconds{outcome}; the
            # ambient span (fired window / gang.place) supplies the
            # trace id /debug/slo links tail pods through
            obs.get_ledger().resolve(key, "placed")
            # the pod placed: drop its explain row so /debug/explain
            # only ever describes pods that are still unplaced
            from karpenter_tpu_torch.explain import get_registry

            get_registry().resolve(key)

    def _pools(self) -> list[NodePool]:
        pools = self.cluster.list("nodepools")
        if not pools:
            pools = [NodePool(name=self.options.default_nodepool,
                              nodeclass_name="default")]
        return sorted(pools, key=lambda p: -p.weight)

    MAX_CATALOG_CACHE = 16

    def _catalog_for(self, nodeclass: NodeClass) -> CatalogArrays | None:
        """Per-NodeClass filtered catalog arrays.  Cached per (nodeclass
        spec, selected types) so multi-pool setups keep one entry each;
        blackout changes only re-derive the availability mask in place
        (cheap), never rebuild the arrays — device tensors re-upload only
        when the mask actually changed (keyed by availability generation in
        TorchSolver.device_offerings)."""
        types = self.catalog_provider.list(nodeclass)
        if nodeclass.status.selected_instance_types:
            allowed = set(nodeclass.status.selected_instance_types)
            types = [t for t in types if t.name in allowed]
        if not types:
            return None
        key = (nodeclass.name, nodeclass.spec_hash(),
               tuple(sorted(t.name for t in types)))
        with self._lock:
            cached = self._catalog_cache.get(key)
            if cached is None:
                cached = CatalogArrays.build(types)
                if len(self._catalog_cache) >= self.MAX_CATALOG_CACHE:
                    oldest = next(iter(self._catalog_cache))
                    del self._catalog_cache[oldest]
                self._catalog_cache[key] = cached
        cached.refresh_availability(self.catalog_provider.unavailable_offerings)
        # spot-risk pricing (karpenter_tpu/stochastic/risk.py): price
        # learned interruption rates into offering RANKING on every
        # catalog this provisioner resolves.  The model is refreshed by
        # SpotPreemptionController from the ledger history; with no
        # observations price_catalog is a cheap no-op (off_risk stays
        # unset, generation untouched) — and it only bumps the risk
        # generation when the column actually changed.
        from karpenter_tpu_torch.stochastic.risk import get_risk_model

        model = get_risk_model()
        if model.counts():
            model.price_catalog(cached)
        return cached
