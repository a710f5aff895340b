"""Gang admission controller: parks, admits, places, and releases gangs.

The planning half lives in ``karpenter_tpu_torch/gang`` (pure functions); this
controller owns the messy parts:

- **parking**: it registers the provisioner's admission gate, so a
  gang's members never enter a solve window until the gang is admitted
  (``min_member`` members pending).  Slice-shaped gangs are NEVER
  released to the ordinary solver — their contiguous-sub-slice contract
  is invisible to it — and are placed here via the topology-aware
  planner instead;
- **first-seen stamps**: gang age is tracked by controller-owned
  stamps, not ``enqueued_at`` — the provisioner's retry ticker restamps
  that field every interval, which would make a parked gang look
  forever-young and never hit its deadline (the same lesson the
  preemption controller learned);
- **admission**: once ``min_member`` members are pending the gang is
  admitted (``gang.admit`` span, event, metrics); non-slice gangs are
  re-windowed immediately and the gang-aware solver places them
  atomically;
- **slice placement**: admitted slice gangs are planned per NodePool
  under the solve lock (``gang.place`` span), validated by the
  independent ``validate_gang_plan`` oracle — an invalid plan is
  dropped with an ERRORS breadcrumb, never actuated — and executed
  through the same actuator path the provisioner uses.  A failed create
  nominates NOBODY (one node per gang), so atomicity survives partial
  actuation;
- **deadline release**: a gang still unplaced past its
  ``deadline_seconds`` is released with a degraded per-pod fallback —
  members lose their gang field and re-enter the queue as ordinary
  pods — plus an ``ERRORS{gang, deadline_release}`` breadcrumb and a
  Warning event (a parked-forever gang is a deadlocked job; per-pod
  capacity at least lets the operator see it running partially);
- **evidence**: ``gang.admit``/``gang.place`` spans,
  ``karpenter_tpu_gang_*`` metric families, and a ``placement_log`` the
  chaos invariants drain (no-partial-gang-placed,
  gangs-resolve-or-release).

The planner runs on the controller's ``device`` (the card unless the
caller asks for the CPU; resolved at construction).  On the card a
faulted planner raises out of ``reconcile`` into the manager's counted
reconcile error; no gang is placed by the host loop in its place.

(Copy of ``karpenter_tpu/controllers/gang.py``, with the ``device``
keyword.)
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from dataclasses import dataclass

from karpenter_tpu_torch.apis.pod import PodSpec, pod_key
from karpenter_tpu_torch.controllers.runtime import PollController, Result
from karpenter_tpu_torch.explain import get_registry
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.gang.degraded import ResilientGangPlanner
from karpenter_tpu_torch.gang.encode import encode_gangs
from karpenter_tpu_torch.gang.types import GangOptions
from karpenter_tpu_torch.recovery.journal import NULL_JOURNAL
from karpenter_tpu_torch.solver.validate import validate_gang_plan
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.gang")


@dataclass(frozen=True)
class GangPlacementRecord:
    """One executed gang placement — the chaos invariants' ground truth."""

    gang: str
    claim_name: str
    members: tuple[str, ...]
    total_members: int
    min_member: int
    backend: str


class GangAdmissionController(PollController):
    """Singleton poller: admit, place, or release pending gangs."""

    name = "gang"
    interval = 5.0

    def __init__(self, cluster: ClusterState, provisioner,
                 options: GangOptions | None = None, clock=time.time,
                 journal=None, device="cuda"):
        self.cluster = cluster
        # the card unless the caller asks for the CPU: resolved here, so
        # a controller meant for the card raises without one
        self.device = resolve_device(device)
        self.provisioner = provisioner
        # write-ahead journal: gang placements are intents (all-or-
        # nothing on replay), admissions durable state — a restarted
        # operator must not reset parked gangs' deadline clocks
        self.journal = journal if journal is not None else NULL_JOURNAL
        self.options = options or GangOptions()
        self.planner = ResilientGangPlanner(options=self.options,
                                            device=self.device)
        self.clock = clock
        # controller-owned first-seen stamps (see module docstring)
        self._first_seen: dict[str, float] = {}
        self.admitted: set[str] = set()
        # gangs released to per-pod scheduling by the deadline fallback
        # — insertion-ordered and FIFO-bounded like placement_log: the
        # release strips members' gang fields, so nothing ever prunes
        # entries by reference and an unbounded set would leak one name
        # per released gang for the process lifetime
        self.released: dict[str, None] = {}
        self._released_max = 4096
        # executed-placement evidence, drained per chaos round and
        # bounded for the operator path where nothing drains it
        self.placement_log: deque[GangPlacementRecord] = deque(maxlen=4096)
        if provisioner is not None:
            provisioner.admission = self.admit

    def seed_recovered(self, admitted: dict[str, float],
                       parked: dict[str, float] | None = None) -> None:
        """Adopt the reconciler's rebuilt gang state: admitted names
        re-enter the admission set, and BOTH admitted and still-parked
        gangs keep the crashed process's first-seen stamps — deadlines
        keep burning across the restart instead of resetting."""
        for name, first in (parked or {}).items():
            self._first_seen.setdefault(name, float(first))
        for name, first in admitted.items():
            self.admitted.add(name)
            self._first_seen.setdefault(name, float(first))

    # -- the provision-queue gate -----------------------------------------

    def admit(self, spec: PodSpec) -> bool:
        """May this pod enter an ordinary solve window?  Non-gang pods
        always; slice gangs never (the topology planner owns them);
        other gangs once admitted."""
        gang = spec.gang
        if gang is None:
            return True
        if gang.slice_shape:
            return False
        return gang.name in self.admitted

    # -- reconcile ---------------------------------------------------------

    def reconcile(self) -> Result:
        if self.provisioner is None:
            return Result()
        now = self.clock()
        groups: dict[str, list] = {}
        for p in self.cluster.pending_pods():
            if p.spec.gang is not None and not p.bound_node:
                groups.setdefault(p.spec.gang.name, []).append(p)
        # prune state for gangs that fully resolved (bound or deleted)
        for name in list(self._first_seen):
            if name not in groups:
                self._first_seen.pop(name, None)
                self.journal.state(f"gang/first_seen/{name}", None)
                if name in self.admitted:
                    self.admitted.discard(name)
                    self.journal.state(f"gang/admitted/{name}", None)
        parked = 0
        to_place: list[tuple[str, list]] = []
        for name, members in groups.items():
            spec = members[0].spec.gang
            if name not in self._first_seen:
                # durable first-seen stamp from the FIRST park
                # observation: a parked gang's deadline clock must keep
                # burning across operator restarts, not reset to zero
                # every time the process rolls
                self.journal.state(f"gang/first_seen/{name}", now)
            first = self._first_seen.setdefault(name, now)
            complete = len(members) >= spec.min_member
            if complete and name not in self.admitted:
                self.admitted.add(name)
                # durable admission + first-seen stamp: a restart must
                # neither re-park an admitted gang nor reset its
                # deadline clock (docs/design/recovery.md)
                self.journal.state(f"gang/admitted/{name}", first)
                metrics.GANG_ADMISSIONS.labels("admitted").inc()
                metrics.GANG_MEMBERS.observe(len(members))
                for p in members:
                    obs.get_ledger().transition(pod_key(p.spec),
                                                "gang.admit")
                    # the park verdict lifted: members now compete as
                    # ordinary solve-window pods
                    get_registry().clear_bits(pod_key(p.spec),
                                              "gang_parked")
                with obs.span("gang.admit", gang=name,
                              members=len(members),
                              min_member=spec.min_member,
                              slice=str(spec.slice_shape or "")):
                    self.cluster.record_event(
                        "PodGroup", name, "Normal", "GangAdmitted",
                        f"{len(members)} members pending "
                        f"(min_member {spec.min_member})")
            if name in self.admitted:
                waiting = [p for p in members if not p.nominated_node]
                if waiting and now - first >= spec.deadline_seconds:
                    # admitted but still (even partially) unplaced by
                    # the deadline: the capacity never fully
                    # materialized — e.g. one of a spanning gang's
                    # creates failed, stranding a sub-min_member
                    # remainder the atomic solver can never place
                    # alone.  Degrade to per-pod rather than park the
                    # job forever (nominated members keep their
                    # nominations; only the gang field is stripped).
                    self._release(name, members, spec)
                elif spec.slice_shape:
                    if waiting:
                        to_place.append((name, members))
                else:
                    # immediate re-window: the admission gate now passes
                    # these pods; waiting out the retry interval would
                    # add a whole tick of latency to every admission
                    for p in waiting:
                        p.enqueued_at = 0.0
            elif now - first >= spec.deadline_seconds:
                self._release(name, members, spec)
            else:
                parked += 1
                # deduped transition: the 5s reconcile loop stamps
                # "gang.park" once per park episode, not once per tick
                for p in members:
                    key = pod_key(p.spec)
                    obs.get_ledger().transition(key, "gang.park")
                    # explain verdict for the parked members: the
                    # registry stamp dedupes, so the 5s loop emits the
                    # Warning event once per park episode
                    if get_registry().stamp(
                            key, "gang_parked",
                            detail=f"gang {name}: {len(members)}/"
                                   f"{spec.min_member} members pending"):
                        self.cluster.record_event(
                            "Pod", key, "Warning", "Unplaced",
                            f"cannot place: gang_parked (gang {name} "
                            f"awaiting min_member {spec.min_member})")
        metrics.GANG_PARKED.set(parked)
        # unconditional: the tick that unparks the LAST gang must zero
        # the gang_parked gauge count, not leave it lingering
        get_registry().update_unplaced_gauge()
        if to_place:
            self._place_slice_gangs(to_place)
        return Result()

    # -- deadline fallback -------------------------------------------------

    def _release(self, name: str, members: list, spec) -> None:
        """Degraded per-pod fallback: strip the gang field so members
        re-enter the queue as ordinary pods."""
        for p in members:
            p.spec = dataclasses.replace(p.spec, gang=None)
            p.enqueued_at = 0.0
            # flags the record: a later nomination resolves as
            # outcome "placed_degraded", feeding the degraded-rate SLO
            obs.get_ledger().transition(pod_key(p.spec), "gang.release")
            # released members are ordinary pods: gang verdicts lift
            get_registry().clear_bits(pod_key(p.spec), "gang_parked",
                                      "gang_geometry")
        while len(self.released) >= self._released_max:
            self.released.pop(next(iter(self.released)))
        self.released[name] = None
        self.admitted.discard(name)
        self.journal.state(f"gang/admitted/{name}", None)
        self._first_seen.pop(name, None)
        self.journal.state(f"gang/first_seen/{name}", None)
        metrics.GANG_ADMISSIONS.labels("released_degraded").inc()
        metrics.ERRORS.labels("gang", "deadline_release").inc()
        obs.instant("gang.release", gang=name, members=len(members),
                    min_member=spec.min_member)
        self.cluster.record_event(
            "PodGroup", name, "Warning", "GangReleased",
            f"deadline {spec.deadline_seconds:.0f}s expired with "
            f"{len(members)}/{spec.min_member} members; released to "
            f"per-pod scheduling (degraded)")
        log.warning("gang released on deadline", gang=name,
                    members=len(members), min_member=spec.min_member)

    # -- slice placement ---------------------------------------------------

    def _place_slice_gangs(self, gangs: list[tuple[str, list]]) -> None:
        placed: set[str] = set()
        for pool in self.provisioner._pools():
            remaining = [(n, m) for n, m in gangs if n not in placed]
            if not remaining:
                break
            placed.update(self._place_pool(pool, remaining))

    def _place_pool(self, pool, gangs: list[tuple[str, list]]) -> set[str]:
        nodeclass = self.cluster.get_nodeclass(pool.nodeclass_name) \
            or self.cluster.get_nodeclass("default")
        if nodeclass is None:
            return set()
        catalog = self.provisioner._catalog_for(nodeclass)
        if catalog is None:
            return set()
        # plan + actuate under the solve lock: a concurrent window
        # nominating one of these pods would race capacity accounting
        with self.provisioner._solve_lock:
            # live-capacity pre-pass: a gang whose slice is already open
            # on an existing accelerator node nominates there directly —
            # free capacity beats a create, and it is the payoff path of
            # the repack plane's slice defragmentation (a parked gang
            # lands on the torus the defrag migrations just vacated,
            # docs/design/repack.md)
            placed_live = self._place_on_live(pool, catalog, gangs)
            gangs = [(n, m) for n, m in gangs if n not in placed_live]
            pods = [p.spec for _, members in gangs for p in members
                    if not p.nominated_node and not p.bound_node]
            if not pods:
                return placed_live
            t0 = time.perf_counter()
            with obs.span("gang.place", pool=pool.name,
                          gangs=len(gangs), pods=len(pods)) as sp:
                problem = encode_gangs(pods, catalog, pool)
                plan = self.planner.plan(problem)
                sp.set("backend", plan.backend)
                sp.set("nodes", len(plan.nodes))
                sp.set("gangs_placed", len(plan.placed_gangs))
                metrics.GANG_PLAN_DURATION.labels(plan.backend).observe(
                    time.perf_counter() - t0)
                # explain: a gang whose compat row is EMPTY has no
                # offering whose torus hosts its slice (or fits its
                # total demand) — the gang_geometry verdict.  A NON-empty
                # row clears the bit: a catalog that recovered (new
                # torus-bearing offering) must not keep blaming geometry
                # for a gang now merely waiting on capacity.
                for idx, g in enumerate(problem.gangs):
                    if not problem.compat[idx].any():
                        for pn in g.pod_names:
                            if get_registry().stamp(
                                    pn, "gang_geometry",
                                    detail=f"gang {g.name}: no offering "
                                           f"hosts the slice"):
                                self.cluster.record_event(
                                    "Pod", pn, "Warning", "Unplaced",
                                    f"cannot place: gang_geometry "
                                    f"(gang {g.name})")
                    else:
                        for pn in g.pod_names:
                            get_registry().clear_bits(pn, "gang_geometry")
                if plan.empty:
                    return placed_live
                # independent oracle gate: never actuate an invalid plan
                errors = validate_gang_plan(plan, pods, catalog, pool)
                if errors:
                    metrics.ERRORS.labels("gang", "invalid_plan").inc()
                    sp.set("invalid", len(errors))
                    log.error("gang plan failed validation; dropped",
                              pool=pool.name, errors=errors[:3])
                    return placed_live
                return placed_live | self._execute(plan, pool, nodeclass,
                                                   catalog, problem)

    def _place_on_live(self, pool, catalog, gangs) -> set[str]:
        """Nominate gangs onto EXISTING initialized nodes of THIS pool
        whose residual capacity covers the gang's total demand and whose
        torus has a free contiguous placement for its slice shape (chip
        occupancy re-derived via the canonical chip model
        repack/encode.py defines).  Oldest claim first, lowest placement
        mask first — deterministic, and by construction atomic (all
        waiting members nominate onto ONE claim or none).

        Eligibility mirrors the repack plane's: initialized, node-backed
        claims only (a launched-but-unready node is unproven capacity —
        a gang parked on a claim the registration-timeout GC later reaps
        would burn its deadline for nothing), and only claims of the
        pool being placed (another pool's labels/taints were never
        matched).  Only torus-bearing types are scanned — slice gangs
        can land nowhere else, and a full-fleet occupancy rebuild per
        reconcile would re-add exactly the host loop the repack plane
        removed."""
        import numpy as np

        from karpenter_tpu_torch.apis.pod import tolerates_all
        from karpenter_tpu_torch.gang.topology import enumerate_placements
        from karpenter_tpu_torch.preempt.encode import (
            _pod_req_vec, claim_pods, occupancy_index,
        )
        from karpenter_tpu_torch.repack.encode import PodRef, chip_layout

        placed: set[str] = set()
        claims = [c for c in self.cluster.nodeclaims()
                  if not c.deleted and c.launched and c.initialized
                  and c.node_name and c.nodepool_name == pool.name]
        if not claims:
            return placed
        idx = None
        alloc = catalog.offering_alloc().astype(np.int64)
        states = []
        for c in claims:
            off = catalog.find_offering(c.instance_type, c.zone,
                                        c.capacity_type)
            if off is None:
                continue
            t = int(catalog.off_type[off])
            torus = tuple(catalog.type_torus[t]) \
                if t < len(catalog.type_torus) else ()
            if not torus:
                continue   # no torus: no slice gang can ever land here
            if idx is None:
                idx = occupancy_index(self.cluster)
            resid = alloc[off].copy()
            refs: list[PodRef] = []
            gang_shapes: list[tuple[str, tuple]] = []
            seen: set[str] = set()
            for p in claim_pods(self.cluster, c, index=idx):
                spec = p.spec
                resid -= _pod_req_vec(spec)
                ref = PodRef(key=pod_key(spec), req=None, sig=0,
                             gpu=int(spec.requests.gpu), movable=False,
                             single=False)
                if spec.gang is not None and spec.gang.slice_shape:
                    if spec.gang.name not in seen:
                        seen.add(spec.gang.name)
                        gang_shapes.append(
                            (spec.gang.name, tuple(spec.gang.slice_shape)))
                    ref.chip_mask = -1
                refs.append(ref)
            occ, _sing = chip_layout(refs, gang_shapes, torus)
            states.append({"claim": c, "off": off, "torus": torus,
                           "resid": resid, "occ": occ})
        if not states:
            return placed
        for name, members in gangs:
            waiting = [p for p in members
                       if not p.nominated_node and not p.bound_node]
            if not waiting:
                continue
            spec = waiting[0].spec.gang
            shape = tuple(spec.slice_shape) if spec.slice_shape else ()
            need = np.zeros(alloc.shape[1], np.int64)
            for p in waiting:
                need += _pod_req_vec(p.spec)
            reqs = waiting[0].spec.scheduling_requirements().merged(
                pool.requirements)
            for st in states:
                c = st["claim"]
                if not (st["resid"] >= need).all():
                    continue
                labels = dict(pool.labels)
                labels.update(catalog.offering_label_values(st["off"]))
                if not reqs.matches(labels):
                    continue
                if (c.taints and any(
                        not tolerates_all(p.spec.tolerations, c.taints)
                        for p in waiting)) or (pool.taints and any(
                        not tolerates_all(p.spec.tolerations, pool.taints)
                        for p in waiting)):
                    continue
                mask = 0
                if shape:
                    for m in enumerate_placements(st["torus"], shape):
                        if (m & st["occ"]) == 0:
                            mask = m
                            break
                    if not mask:
                        continue
                with obs.span("gang.place.live", gang=name, claim=c.name,
                              members=len(waiting)), \
                        self.journal.intent(
                            "gang_placement", gang=name, claim=c.name,
                            pods=[pod_key(p.spec) for p in waiting]):
                    for p in waiting:
                        self.provisioner._nominate(pod_key(p.spec), c.name)
                    self.placement_log.append(GangPlacementRecord(
                        gang=name, claim_name=c.name,
                        members=tuple(pod_key(p.spec) for p in waiting),
                        total_members=len(waiting),
                        min_member=spec.min_member, backend="live"))
                    metrics.GANG_PLACEMENTS.labels("live").inc()
                    self.cluster.record_event(
                        "PodGroup", name, "Normal", "GangPlaced",
                        f"{len(waiting)} members onto live node "
                        f"{c.name}" + (f" (slice "
                                       f"{'x'.join(map(str, shape))})"
                                       if shape else ""))
                st["resid"] = st["resid"] - need
                st["occ"] |= mask
                placed.add(name)
                log.info("gang placed on live capacity", gang=name,
                         claim=c.name, members=len(waiting),
                         slice=str(spec.slice_shape or ""))
                break
        return placed

    def _execute(self, plan, pool, nodeclass, catalog, problem) -> set[str]:
        sizes = {g.name: len(g.pod_names) for g in problem.gangs}
        mins = {g.name: g.min_member for g in problem.gangs}
        actuator = self.provisioner.actuator_for(nodeclass)
        claims, errors = actuator.execute_plan(plan.to_plan(), nodeclass,
                                               catalog, pool.name)
        if errors:
            log.warning("gang plan partially executed", pool=pool.name,
                        errors=errors[:3])
        placed: set[str] = set()
        for node, claim in zip(plan.nodes, claims):
            if claim is None:
                continue   # create failed: the gang stays pending whole
            for a in node.assignments:
                # one intent per (gang, claim): replay is all-or-nothing
                # — a live claim gets the whole membership re-nominated,
                # a dead one releases every member back to pending
                with self.journal.intent("gang_placement", gang=a.gang,
                                         claim=claim.name,
                                         pods=list(a.pod_names)):
                    for pn in a.pod_names:
                        self.provisioner._nominate(pn, claim.name)
                # total_members = the gang's pending membership when
                # planned; the invariant checker compares it against the
                # members the record actually carried (an assignment row
                # holds ALL of them by construction — the checker proves
                # it, never assumes it)
                self.placement_log.append(GangPlacementRecord(
                    gang=a.gang, claim_name=claim.name,
                    members=a.pod_names,
                    total_members=sizes.get(a.gang, len(a.pod_names)),
                    min_member=mins.get(a.gang, 0),
                    backend=plan.backend))
                metrics.GANG_PLACEMENTS.labels(plan.backend).inc()
                placed.add(a.gang)
                self.cluster.record_event(
                    "PodGroup", a.gang, "Normal", "GangPlaced",
                    f"{len(a.pod_names)} members on {claim.name} "
                    f"({node.instance_type}/{node.zone})")
        return placed
