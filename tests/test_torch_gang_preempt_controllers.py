"""The port's gang admission and preemption controllers against the
reference's, on the CPU.

``karpenter_tpu_torch/controllers/{gang,preemption}.py`` are copies of
the reference's modules with one keyword more, ``device``, on which
their planners (``ResilientGangPlanner``, ``ResilientPlanner``) run.
The call scripts come from the reference's tests (``tests/test_gang.py``
``_rig`` and ``TestGangController``, ``tests/test_preempt.py``'s
controller cases); each runs once per package, the port with
``device="cpu"`` and a CPU ``Provisioner``, with the planners' grids
taken by numpy (``"off"``) and by torch / jax (``"on"``).  Compared
exactly: claims, pods (bindings, nominations, gang fields), events, the
fake cloud's calls and instances, ``placement_log``, ``eviction_log``,
the admitted / released / preempted sets, the journal's records and the
``ERRORS`` samples moved.

A planner on the card that faults raises out of ``reconcile`` into the
manager's counted reconcile error, with no host plan and no breadcrumb;
on the CPU that is shown by treating the port's planner as one on the
card (``holds_card``) and injecting a fault at its guard site.
"""

from __future__ import annotations

import json

import pytest
import torch

from test_torch_controllers import (
    CSIDES, FakeClock, both, dev, errors_moved, world,
)
from test_torch_provisioner import (  # noqa: F401 — fixtures
    fixed_ids, frozen, permissive_breaker,
)

PORT = CSIDES[1]
SMALL = "bx2-2x8"


# -- the gang rig (``tests/test_gang.py::_rig``) -----------------------------

class GRig:
    def __init__(self, m, families=("gx3", "bx2", "cx2"), use_device="off",
                 nodeclass="gang", solver=None, journal=None, **prov_kw):
        NC = m.nodeclass
        self.m = m
        self.cloud = m.fake.FakeCloud(profiles=m.fake.generate_profiles(
            24, families=families))
        self.pricing = m.catalog.PricingProvider(self.cloud)
        self.unavail = m.catalog.UnavailableOfferings()
        self.itp = m.catalog.InstanceTypeProvider(self.cloud, self.pricing,
                                                  self.unavail)
        self.cluster = m.cluster.ClusterState()
        if nodeclass == "gang":
            nc = NC.NodeClass(name="default", spec=NC.NodeClassSpec(
                region="us-south", image="img-1", vpc="vpc-1",
                instance_requirements=NC.InstanceRequirements(min_cpu=2),
                placement_strategy=NC.PlacementStrategy()))
        else:
            nc = NC.NodeClass(name="default", spec=NC.NodeClassSpec(
                region="us-south", image="img-1", vpc="vpc-1",
                instance_profile="bx2-4x16"))
        nc.status.resolved_image_id = "img-1"
        nc.status.set_condition("Ready", "True", "Test")
        self.cluster.add_nodeclass(nc)
        self.actuator = m.actuator.Actuator(
            self.cloud, self.cluster, unavailable=self.unavail,
            breaker=permissive_breaker(m), journal=journal)
        opts = m.provisioner.ProvisionerOptions(
            solver=m.types.SolverOptions(**(solver or {})), **prov_kw)
        self.prov = m.provisioner.Provisioner(
            self.cluster, self.itp, self.actuator, opts, journal=journal,
            **dev(m))
        self.clock = FakeClock()
        self.use_device = use_device
        self.journal = journal

    def gang_ctrl(self, **kw):
        return self.m.gangctl.GangAdmissionController(
            self.cluster, self.prov, clock=self.clock,
            options=self.m.gang_types.GangOptions(use_device=self.use_device),
            journal=self.journal, **kw, **dev(self.m))

    def preempt_ctrl(self, **kw):
        kw.setdefault("min_pending_age", 0.0)
        return self.m.preemption.PreemptionController(
            self.cluster, self.prov,
            options=self.m.preempt_types.PlannerOptions(
                use_device=self.use_device),
            journal=self.journal, **kw, **dev(self.m))

    def close(self):
        self.prov.stop()
        self.pricing.close()


def run(m, script, **kw):
    r = GRig(m, **kw)
    try:
        return script(m, r)
    finally:
        r.close()


def gang_pods(m, name, n, *, min_member=None, shape=None, cpu=250, mem=512,
              priority=0, deadline=120.0):
    """``tests/test_gang.py::gang_pods``."""
    gang = m.podgroup.PodGroup(name=name, min_member=min_member or n,
                               slice_shape=shape, deadline_seconds=deadline)
    return m.pod.make_pods(n, name_prefix=name,
                           requests=m.pod.ResourceRequests(cpu, mem, 0, 1),
                           priority=priority, gang=gang)


def backend(b: str) -> str:
    return b.replace("torch", "device").replace("jax", "device")


def gang_view(ctrl):
    return ([(g.gang, g.claim_name, g.members, g.total_members,
              g.min_member, backend(g.backend)) for g in ctrl.placement_log],
            sorted(ctrl.admitted), list(ctrl.released))


def preempt_view(ctrl):
    return ([(e.pod_key, e.victim_priority, e.beneficiary_priority,
              e.beneficiary, e.claim_name) for e in ctrl.eviction_log],
            sorted(ctrl.preempted_keys))


def add(r, pods):
    for p in pods:
        r.cluster.add_pod(p)


def keys(m, pods):
    return [m.pod.pod_key(p) for p in pods]


# -- gang admission -----------------------------------------------------------

GANG_CASES = ("slice_gang", "plain_gang", "deadline_release", "unplaceable",
              "partially_nominated", "released_bounded")


@pytest.mark.parametrize("case,use_device", [
    *((c, "off") for c in GANG_CASES), ("slice_gang", "on"),
    ("plain_gang", "on")])
def test_gang_controller(fixed_ids, case, use_device):
    """``TestGangController`` and the gang cases of ``TestReviewHardening``:
    a slice gang parks under ``min_member`` then is admitted and placed
    on one node; a plain gang is released to the solver on admit; a
    starved gang, an unplaceable slice gang and a half-nominated gang
    release on their deadline (members lose the gang field); the
    released set is bounded."""
    def script(m, r):
        ctrl = r.gang_ctrl()
        steps = []
        if case == "slice_gang":
            half = gang_pods(m, "j", 2, min_member=4, shape="2x2")
            add(r, half)
            steps.append(ctrl.admit(half[0]))
            ctrl.reconcile()
            steps.append(m.metrics.GANG_PARKED.get())
            steps.append(len(r.prov.provision_once()))
            add(r, m.pod.make_pods(2, "j-rest",
                                   requests=m.pod.ResourceRequests(
                                       250, 512, 0, 1),
                                   gang=half[0].gang))
            ctrl.reconcile()
        elif case == "plain_gang":
            pods = gang_pods(m, "plain", 3)
            add(r, pods)
            steps.append(ctrl.admit(pods[0]))
            ctrl.reconcile()
            steps.append(ctrl.admit(pods[0]))
            steps.append(len(r.prov.provision_once()))
        elif case == "deadline_release":
            add(r, gang_pods(m, "starved", 2, min_member=4, deadline=30.0))
            ctrl.reconcile()
            r.clock.t += 31.0
            ctrl.reconcile()
            steps.append(len(r.prov.provision_once()))
        elif case == "unplaceable":
            add(r, gang_pods(m, "doomed", 4, shape="2x2", deadline=30.0))
            ctrl.reconcile()
            steps.append(sorted(ctrl.admitted))
            r.clock.t += 31.0
            ctrl.reconcile()
        elif case == "partially_nominated":
            pods = gang_pods(m, "span", 4, deadline=30.0)
            add(r, pods)
            ctrl.reconcile()
            for k in keys(m, pods[:2]):
                r.cluster.get("pods", k).nominated_node = "c-x"
            r.clock.t += 31.0
            ctrl.reconcile()
        else:
            ctrl._released_max = 2
            for i in range(3):
                add(r, gang_pods(m, f"r{i}", 1, min_member=4,
                                 deadline=10.0))
            ctrl.reconcile()
            r.clock.t += 11.0
            ctrl.reconcile()
        return steps, world(r.cluster, r.cloud), gang_view(ctrl)

    kw = {"families": ("bx2", "cx2")} if case == "unplaceable" else {}
    steps, w, (log, admitted, released) = both(
        fixed_ids, lambda m: run(m, script, use_device=use_device, **kw))
    if case == "slice_gang":
        assert steps == [False, 1.0, 0] and [g[0] for g in log] == ["j"]
        assert len({w["pods"][f"default/{k}"][1] for k in (
            "j-0", "j-1", "j-rest-0", "j-rest-1")}) == 1
    elif case == "plain_gang":
        assert steps[:2] == [False, True]
        assert all(v[1] for v in w["pods"].values())
    elif case in ("deadline_release", "unplaceable"):
        assert released and all(v[3] for v in w["pods"].values())
    elif case == "partially_nominated":
        assert released == ["span"]
        assert w["pods"]["default/span-0"][1] == "c-x"
    else:
        assert released == ["r1", "r2"]


def test_gang_placement_on_the_device_grid_equals_numpy(fixed_ids):
    """Four slice gangs of mixed shapes placed by the controller with the
    planner's grid forced on (torch on the CPU in the port, jax in the
    reference) and off: one outcome, ranks and nominations included."""
    def script(m, r):
        ctrl = r.gang_ctrl()
        for i, shape in enumerate(["2x2", "2x2x2", "4x4", "2x2"]):
            add(r, gang_pods(m, f"rk{i}", 4, shape=shape))
        ctrl.reconcile()
        if m.torch:
            grids.append(ctrl.planner.primary.device_steps)
        return world(r.cluster, r.cloud), gang_view(ctrl)

    grids = []
    outs = [both(fixed_ids, lambda m: run(m, script, use_device=u))
            for u in ("off", "on")]
    assert outs[0] == outs[1] and outs[0][1][0]
    assert grids[0] == 0 and grids[1] > 0


def test_gang_gate_holds_windows_already_batched(fixed_ids, frozen):
    """Gang members batched in a live ``SolveWindow`` before the
    controller existed meet its admission gate when the window fires:
    they stay pending, the plain pods of the same window place."""
    def script(m, r):
        frozen(r)
        r.prov.options.window = m.window.WindowOptions(
            idle_seconds=60.0, max_seconds=60.0, max_pods=8)
        r.prov.options.retry_interval = 60.0
        r.prov.start()
        futures = []
        add_window = r.prov._window.add

        def kept(spec):
            fut = add_window(spec)
            futures.append(fut)
            return fut

        r.prov._window.add = kept
        try:
            add(r, gang_pods(m, "late", 4, shape="2x2"))
            ctrl = r.gang_ctrl()
            add(r, m.pod.make_pods(4, "plain",
                                   requests=m.pod.ResourceRequests(
                                       250, 512, 0, 1)))
            got = [f.result(timeout=10) is not None for f in futures]
        finally:
            r.prov.stop()
        return got, world(r.cluster, r.cloud), gang_view(ctrl)

    got, w, _ = both(fixed_ids, lambda m: run(m, script))
    assert got == [False] * 4 + [True] * 4


def test_gang_seed_recovered_keeps_deadlines(fixed_ids):
    """Recovered admissions re-enter the set and parked gangs keep the
    crashed process's first-seen stamps: the deadline keeps burning."""
    def script(m, r):
        ctrl = r.gang_ctrl()
        ctrl.seed_recovered({"adm": r.clock.t - 5.0},
                            parked={"old": r.clock.t - 100.0})
        add(r, gang_pods(m, "old", 2, min_member=4, deadline=60.0))
        ctrl.reconcile()
        return world(r.cluster, r.cloud), gang_view(ctrl), \
            sorted(ctrl._first_seen.items())

    _, (_, admitted, released), first_seen = both(
        fixed_ids, lambda m: run(m, script))
    # released on its first sight: the seeded stamp is 100 s old
    assert released == ["old"] and first_seen == []


# -- preemption ---------------------------------------------------------------

def req(m, cpu, mem=1024):
    return m.pod.ResourceRequests(cpu, mem, 0, 1)


def add_claim(r, name, pool="", itype=SMALL):
    """``tests/test_preempt.py::add_claim``."""
    c = r.m.nodeclaim.NodeClaim(
        name=name, nodeclass_name="default", nodepool_name=pool,
        instance_type=itype, zone="us-south-1", capacity_type="on-demand",
        launched=True, node_name=f"node-{name}")
    r.cluster.add_nodeclaim(c)
    return c


def bind(r, spec, claim):
    r.cluster.add_pod(spec)
    r.cluster.bind_pod(r.m.pod.pod_key(spec), claim.node_name)


def pend(r, spec):
    p = r.cluster.add_pod(spec)
    p.enqueued_at = 0.0
    return p


PREEMPT_CASES = ("executes", "budget_zero", "budget_one", "no_stranded",
                 "equal_priority", "custom_pool")


@pytest.mark.parametrize("use_device", ["off", "on"])
@pytest.mark.parametrize("case", PREEMPT_CASES)
def test_preemption_controller(fixed_ids, case, use_device):
    """``TestPreemptionController``: a plan evicts the low-priority pod
    back to pending and nominates the high-priority one onto the freed
    claim; a pool budget of 0 disables the plane and of 1 caps a round;
    nothing stranded, nothing evicted; never for equal priority; a
    customized default pool still preempts."""
    def script(m, r):
        PodSpec = m.pod.PodSpec
        pool = "custom" if case == "custom_pool" else ""
        if case in ("budget_zero", "budget_one"):
            pool = "default"
            r.cluster.add_nodepool(m.nodeclaim.NodePool(
                name="default", nodeclass_name="default",
                preemption_budget=0 if case == "budget_zero" else 1))
        if case == "budget_one":
            for i in range(2):
                bind(r, PodSpec(f"lo{i}", requests=req(m, 1500, 4096),
                                priority=0), add_claim(r, f"c{i}", pool))
            for p in m.pod.make_pods(2, "hi", requests=req(m, 1000, 2048),
                                     priority=100):
                pend(r, p)
        else:
            c = add_claim(r, "c1", pool)
            lo_prio = 7 if case == "equal_priority" else 0
            lo_cpu = 500 if case == "no_stranded" else 1500
            bind(r, PodSpec("lo", requests=req(m, lo_cpu, 4096),
                            priority=lo_prio), c)
            if case != "no_stranded":
                pend(r, PodSpec("hi", requests=req(m, 1000, 2048),
                                priority=7 if case == "equal_priority"
                                else 100))
        ctrl = r.preempt_ctrl()
        ctrl.reconcile()
        return world(r.cluster, r.cloud), preempt_view(ctrl)

    kw = {"default_nodepool": "custom"} if case == "custom_pool" else {}
    w, (log, preempted) = both(fixed_ids, lambda m: run(
        m, script, use_device=use_device, nodeclass="plain",
        solver={"backend": "greedy"}, **kw))
    want = {"executes": 1, "budget_zero": 0, "budget_one": 1,
            "no_stranded": 0, "equal_priority": 0, "custom_pool": 1}[case]
    assert len(log) == want
    if case == "executes":
        assert w["pods"]["default/hi"][1] == "c1"
        assert w["pods"]["default/lo"][:3] == ("", "", True)


def test_preemption_pending_age_uses_own_stamps(fixed_ids):
    """The age gate reads the controller's first-seen stamps: the
    retry ticker's ``enqueued_at`` restamps do not reset it."""
    def script(m, r):
        bind(r, m.pod.PodSpec("lo", requests=req(m, 1500, 4096),
                              priority=0), add_claim(r, "c1"))
        p = r.cluster.add_pod(m.pod.PodSpec("hi", requests=req(m, 1000, 2048),
                                            priority=100))
        ctrl = r.preempt_ctrl(clock=r.clock, min_pending_age=5.0)
        logs = []
        for dt in (0.0, 4.0, 2.0):
            r.clock.t += dt
            p.enqueued_at = r.clock.t
            ctrl.reconcile()
            logs.append(len(ctrl.eviction_log))
        return logs, world(r.cluster, r.cloud), preempt_view(ctrl)

    logs = both(fixed_ids, lambda m: run(m, script, nodeclass="plain",
                                         solver={"backend": "greedy"}))[0]
    assert logs == [0, 0, 1]


def test_preemption_is_journaled(fixed_ids, tmp_path):
    """Evictions write an intent before the first victim moves and a
    durable ``preempted/`` state row per victim; a restart's seed adopts
    the keys.  The records equal record for record (timestamps aside)."""
    from test_torch_recovery import records

    def script(m, r):
        path = str(tmp_path / f"{m.pkg}.jsonl")
        r.journal = m.journal.IntentJournal(path, owner="t")
        for i in range(2):
            bind(r, m.pod.PodSpec(f"lo{i}", requests=req(m, 1500, 4096),
                                  priority=0), add_claim(r, f"c{i}"))
        for p in m.pod.make_pods(2, "hi", requests=req(m, 1000, 2048),
                                 priority=100):
            pend(r, p)
        ctrl = r.preempt_ctrl()
        ctrl.reconcile()
        r.journal.close()
        r.journal = m.journal.IntentJournal(path, owner="t2")
        report = m.reconciler.Reconciler(r.journal, r.cloud,
                                         r.cluster).recover()
        again = r.preempt_ctrl()
        again.seed_recovered(report.preempted_keys)
        r.journal.close()
        recs = records(path)
        for rec in recs:
            rec.pop("owner", None)
        return json.dumps(recs, sort_keys=True), preempt_view(ctrl), \
            sorted(again.preempted_keys), world(r.cluster, r.cloud)

    recs, (log, _), seeded, _ = both(
        fixed_ids, lambda m: run(m, script, nodeclass="plain",
                                 solver={"backend": "greedy"}))
    assert len(log) == 2 and "preempt" in recs and seeded


# -- the card ---------------------------------------------------------------------

def test_planning_controllers_on_the_card_by_default(monkeypatch):
    """``GangAdmissionController`` and ``PreemptionController`` resolve
    ``device="cuda"`` at construction: without a card they raise."""
    m = PORT
    cluster = m.cluster.ClusterState()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctrl in (m.gangctl.GangAdmissionController,
                 m.preemption.PreemptionController):
        with pytest.raises(RuntimeError, match="CUDA"):
            ctrl(cluster, None)
        made = ctrl(cluster, None, device="cpu")
        assert made.device == torch.device("cpu")
        assert made.planner.primary.device == torch.device("cpu")


def placed(cluster):
    """Claims, nodes and pods: what a plan would change (the gang
    controller records its admissions before it plans)."""
    w = world(cluster)
    return w["claims"], w["nodes"], w["pods"]


def faulted_sync(monkeypatch, m, r, ctrl, site, degraded_mod):
    """One scripted fault at ``site`` with the planner treated as one on
    the card: the wrapper raises, the manager counts one reconcile error
    and the device fault, no breadcrumb moves and the world stands; the
    next sync plans on the grid."""
    from test_torch_degraded import SiteInjector

    from karpenter_tpu_torch.faulttol import (
        DeviceFaultError, clear_injector, install_injector,
    )
    from karpenter_tpu_torch.faulttol import health as health_mod
    from karpenter_tpu_torch.solver.degraded import breadcrumbs

    monkeypatch.setattr(degraded_mod, "holds_card", lambda obj: True)
    monkeypatch.setattr(health_mod, "_BOARD", None)
    mgr = m.controllers.ControllerManager(r.cluster)
    mgr.register(ctrl)
    before_w = placed(r.cluster)
    crumbs = breadcrumbs()
    inj = SiteInjector(site)
    install_injector(inj)
    try:
        with pytest.raises(DeviceFaultError):
            ctrl.reconcile()
        inj.left = 1
        errs = m.metrics.ERRORS.samples()
        mgr.sync(rounds=1)
        moved = errors_moved(m, errs)
    finally:
        clear_injector()
        health_mod._BOARD = None
    assert inj.injected == 2
    assert moved == {(f"controller.{ctrl.name}", "reconcile"): 1.0,
                     ("device", "error"): 1.0}
    assert breadcrumbs() == crumbs
    assert placed(r.cluster) == before_w
    steps = ctrl.planner.primary.device_steps
    mgr.sync(rounds=1)
    assert ctrl.planner.primary.device_steps > steps


def test_faulted_gang_planner_on_the_card_raises_into_the_reconcile_error(
        monkeypatch):
    from karpenter_tpu_torch.gang import degraded

    m = PORT
    r = GRig(m, use_device="on")
    try:
        ctrl = r.gang_ctrl()
        for i, shape in enumerate(["2x2", "2x2"]):
            add(r, gang_pods(m, f"f{i}", 4, shape=shape))
        faulted_sync(monkeypatch, m, r, ctrl, "gang-grid", degraded)
        assert ctrl.placement_log
    finally:
        r.close()


def test_faulted_preempt_planner_on_the_card_raises_into_the_reconcile_error(
        monkeypatch):
    from karpenter_tpu_torch.preempt import degraded

    m = PORT
    r = GRig(m, use_device="on", nodeclass="plain",
             solver={"backend": "greedy"})
    try:
        bind(r, m.pod.PodSpec("lo", requests=req(m, 1500, 4096),
                              priority=0), add_claim(r, "c1"))
        pend(r, m.pod.PodSpec("hi", requests=req(m, 1000, 2048),
                              priority=100))
        ctrl = r.preempt_ctrl()
        faulted_sync(monkeypatch, m, r, ctrl, "preempt-grid", degraded)
        assert [e.pod_key for e in ctrl.eviction_log] == ["default/lo"]
    finally:
        r.close()
