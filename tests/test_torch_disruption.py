"""The port's disruption controller against the reference's, on the CPU.

``karpenter_tpu_torch/controllers/disruption.py`` is a copy of the
reference's module with one keyword more, ``device``: the migration
repack's planner runs there, and the blue/green proposal solves through
the provisioner's solver.  The call scripts come from the reference's
tests (``tests/test_disruption.py``'s rig, ``test_repack.py``'s
controller cases, ``test_resident.py``'s occupancy parity rig); each
runs once per package, the port with ``device="cpu"`` and a CPU
``Provisioner``, and the outcomes are compared exactly: claims, pods
(bindings and nominations), events, the fake cloud's calls and
instances, ``repack_log``, ``repack_violations``, the journal's records,
the ``ERRORS`` samples moved and each step's return values.

A planner on the card that faults raises out of ``reconcile`` into the
manager's counted reconcile error with no host plan; on the CPU that is
shown by treating the port's repack planner as one on the card
(``holds_card``) and injecting a fault at its guard site.
"""

from __future__ import annotations

import itertools
import json

import pytest
import torch

from test_torch_controllers import (
    CSIDES, FakeClock, both, dev, errors_moved, world,
)
from test_torch_provisioner import fixed_ids  # noqa: F401 — fixture

ACCEL = "gx3-64x512"      # 8 gpu -> (2, 2, 2) torus
BIG = "bx2-16x64"
PORT = CSIDES[1]


# -- the rig (``tests/test_disruption.py::rig``) ------------------------------

class DRig:
    """cloud, pricing, itp, cluster, cp, clock, ctrl of one package."""

    def __init__(self, m, profiles=None, nodeclass_ready=False,
                 provisioner=False, actuator=False, solver=None, **ctrl_kw):
        self.m = m
        self.cloud = m.fake.FakeCloud() if profiles is None else \
            m.fake.FakeCloud(profiles=m.fake.generate_profiles(
                24, families=("gx3", "bx2", "cx2")))
        self.pricing = m.catalog.PricingProvider(self.cloud)
        self.itp = m.catalog.InstanceTypeProvider(self.cloud, self.pricing)
        self.cluster = m.cluster.ClusterState()
        nc = m.nodeclass.NodeClass(name="default",
                                   spec=m.nodeclass.NodeClassSpec(
                                       region="us-south", image="img-1",
                                       vpc="vpc-1",
                                       instance_profile="bx2-4x16"))
        if nodeclass_ready:
            nc.status.resolved_image_id = "img-1"
            nc.status.set_condition("Ready", "True", "Validated")
        self.cluster.add_nodeclass(nc)
        self.cp = m.cloudprovider.CloudProvider(
            self.cluster, actuator=None, instance_types=self.itp)
        self.clock = FakeClock()
        self.actuator = None
        if actuator:
            self.actuator = m.actuator.Actuator(
                self.cloud, self.cluster,
                breaker=actuator if actuator is not True else None)
        self.prov = None
        if provisioner:
            kw = {}
            if solver is not None:
                kw["options"] = m.provisioner.ProvisionerOptions(
                    solver=m.types.SolverOptions(**solver))
            self.prov = m.provisioner.Provisioner(
                self.cluster, self.itp, self.actuator, **kw, **dev(m))
        self.ctrl = m.disruption.DisruptionController(
            self.cluster, self.cp, provisioner=self.prov, clock=self.clock,
            **ctrl_kw, **dev(m))

    def close(self):
        self.pricing.close()


def run(m, script, **kw):
    r = DRig(m, **kw)
    try:
        return script(m, r)
    finally:
        r.close()


def claim(r, name, itype="bx2-4x16", price=0.2, pool="default", age=1000.0,
          node=None, zone="us-south-1"):
    """``tests/test_disruption.py::_claim``."""
    c = r.m.nodeclaim.NodeClaim(
        name=name, nodeclass_name="default", nodepool_name=pool,
        instance_type=itype, zone=zone, node_name=node or f"node-{name}",
        hourly_price=price, launched=True, registered=True, initialized=True)
    c.created_at = age
    r.cluster.add_nodeclaim(c)
    return c


def current(r, c):
    """Stamp ``c`` with its NodeClass's hash, as the actuator does: the
    drift sweep leaves it alone."""
    nc = r.m.nodeclass
    c.annotations.update({
        nc.ANNOTATION_NODECLASS_HASH:
            r.cluster.get_nodeclass("default").spec_hash(),
        nc.ANNOTATION_NODECLASS_HASH_VERSION: nc.NODECLASS_HASH_VERSION})
    return c


def pod(r, name, node, cpu=500, mem=1024, gpu=0, **kw):
    r.cluster.add_pod(r.m.pod.PodSpec(
        name, requests=r.m.pod.ResourceRequests(cpu, mem, gpu, 1), **kw))
    if node:
        r.cluster.bind_pod(f"default/{name}", node)


def repack_view(ctrl):
    return ([(rec.migrations, rec.drained, rec.reopened,
              rec.backend.replace("torch", "jax"),
              round(rec.savings_fraction, 9)) for rec in ctrl.repack_log],
            list(ctrl.repack_violations),
            None if ctrl._pending_repack is None else (
                sorted(c.name for c in ctrl._pending_repack.new_claims),
                sorted(ctrl._pending_repack.old_claim_names),
                sorted(ctrl._pending_repack.pod_map.items())))


def outcome(r, *steps):
    return steps, world(r.cluster, r.cloud), repack_view(r.ctrl)


# -- consolidation ------------------------------------------------------------

def test_empty_consolidation_gates_and_clock_reset(fixed_ids):
    """The first pass only stamps; the emptiness window elapses; the
    Never pool is exempt; a returning pod resets the clock."""
    def script(m, r):
        r.cluster.add_nodepool(m.nodeclaim.NodePool(
            name="never", nodeclass_name="default",
            consolidation_policy="Never"))
        t = r.clock
        claim(r, "young", age=t.t - 5)
        claim(r, "old", age=t.t - 3600)
        claim(r, "gated", pool="never", age=t.t - 3600)
        a = claim(r, "a", age=t.t - 3600)
        steps = [r.ctrl._consolidate_empty()]
        t.t += 20
        pod(r, "p", a.node_name)
        steps.append(r.ctrl._consolidate_empty())
        t.t += 11
        steps.append(r.ctrl._consolidate_empty())
        r.cluster.delete("pods", "default/p")
        steps.append(r.ctrl._consolidate_empty())
        t.t += 20
        steps.append(r.ctrl._consolidate_empty())
        t.t += 15
        steps.append(r.ctrl._consolidate_empty())
        return outcome(r, *steps)

    steps = both(fixed_ids, lambda m: run(m, script))[0]
    assert steps == (0, 0, 2, 0, 0, 1)


UNDERUTILIZED = ("moves", "nothing_fits", "node_selector", "taints",
                 "anti_affinity")


@pytest.mark.parametrize("case", UNDERUTILIZED)
def test_underutilized_consolidation(fixed_ids, case):
    """``TestUnderutilizedConsolidation``: a cheap node's pods move into
    the residuals of others and it goes; nothing moves when nothing fits,
    nor against a zone selector, a taint or hostname anti-affinity."""
    def script(m, r):
        t = r.clock.t - 3600
        if case == "moves":
            a = claim(r, "a", itype=BIG, price=0.8, age=t)
            b = claim(r, "b", itype=BIG, price=0.8, age=t)
            v = claim(r, "v", itype="bx2-2x8", price=0.1, age=t)
            pod(r, "pa", a.node_name, cpu=2000, mem=4096)
            pod(r, "pb", b.node_name, cpu=2000, mem=4096)
            pod(r, "pv1", v.node_name)
            pod(r, "pv2", v.node_name)
        elif case == "nothing_fits":
            for n in ("a", "b"):
                c = claim(r, n, itype="bx2-2x8", price=0.1, age=t)
                pod(r, f"p{n}", c.node_name, cpu=1200, mem=2048)
        elif case == "node_selector":
            big = claim(r, "big", itype=BIG, price=0.8, age=t,
                        zone="us-south-2")
            v = claim(r, "v", itype="bx2-2x8", price=0.1, age=t)
            pod(r, "pinned", v.node_name, node_selector=(
                (m.requirements.LABEL_ZONE, "us-south-1"),))
            assert big.zone == "us-south-2"
        elif case == "taints":
            tainted = claim(r, "t", itype=BIG, price=0.8, age=t)
            tainted.taints = (m.pod.Taint("dedicated", "gpu",
                                          "NoSchedule"),)
            v = claim(r, "v", itype="bx2-2x8", price=0.1, age=t)
            pod(r, "plain", v.node_name)
        else:
            target = claim(r, "big", itype=BIG, price=0.8, age=t)
            v = claim(r, "v", itype="bx2-4x16", price=0.2, age=t)
            anti = m.pod.PodAffinityTerm(
                label_selector=(("app", "web"),),
                topology_key="kubernetes.io/hostname", anti=True)
            for name, node in (("web-1", target.node_name),
                               ("web-2", v.node_name)):
                pod(r, name, node, labels=(("app", "web"),),
                    affinity=(anti,))
        return outcome(r, r.ctrl._consolidate_underutilized())

    steps, w, _ = both(fixed_ids, lambda m: run(m, script))
    assert (steps[0] >= 1) == (case == "moves")


def test_drift_replacement(fixed_ids):
    def script(m, r):
        c = claim(r, "d", age=r.clock.t - 100)
        c.annotations = {
            m.nodeclass.ANNOTATION_NODECLASS_HASH: "stale-hash",
            "karpenter-tpu.sh/nodeclass-hash-version":
                m.nodeclass.NODECLASS_HASH_VERSION}
        claim(r, "fresh", age=r.clock.t - 100).annotations = {
            m.nodeclass.ANNOTATION_NODECLASS_HASH:
                r.cluster.get_nodeclass("default").spec_hash(),
            "karpenter-tpu.sh/nodeclass-hash-version":
                m.nodeclass.NODECLASS_HASH_VERSION}
        pod(r, "pd", c.node_name)
        return outcome(r, r.ctrl._replace_drifted())

    steps, w, _ = both(fixed_ids, lambda m: run(m, script))
    assert steps == (1,) and w["pods"]["default/pd"][:2] == ("", "")


# -- the blue/green repack -----------------------------------------------------

def test_propose_repack_reports_savings(fixed_ids):
    def script(m, r):
        for i in range(3):
            c = claim(r, f"r{i}", itype=BIG, price=0.8,
                      age=r.clock.t - 3600)
            pod(r, f"pr{i}", c.node_name)
        p = r.ctrl.propose_repack()
        return outcome(r, round(p.current_cost, 9),
                       round(p.proposed_cost, 6), round(p.savings, 6),
                       [(n.instance_type, n.zone, n.capacity_type,
                         sorted(n.pod_names)) for n in p.plan.nodes])

    steps = both(fixed_ids, lambda m: run(m, script, provisioner=True))[0]
    assert steps[0] == 2.4 and steps[1] < steps[0]


BLUE_GREEN = ("cutover", "never_ready", "unprofitable", "cooldown",
              "partial_create", "breaker")


@pytest.mark.parametrize("case", BLUE_GREEN)
def test_blue_green_repack(fixed_ids, case):
    """``TestRepackApply`` and ``TestRepackBreakerGuard``: phase 1
    creates the new fleet and moves nothing; the Ready new fleet cuts
    over; one that misses its deadline rolls back; the savings gate and
    the cooldown hold; a partial create rolls back; a plan over the
    breaker's budget defers."""
    def script(m, r):
        ctrl, t = r.ctrl, r.clock
        ctrl.repack_enabled = True
        ctrl.repack_cooldown = 0.0
        ctrl.repack_migrate = False
        steps = []
        if case in ("cutover", "never_ready", "partial_create"):
            for i in range(3 if case == "cutover" else 2):
                c = claim(r, f"fat{i}", itype=BIG, price=0.8,
                          age=t.t - 3600)
                pod(r, f"p{i}", c.node_name, cpu=250, mem=512)
        if case == "cutover":
            steps.append(ctrl._repack_if_profitable())
            steps.append(ctrl._repack_if_profitable())
            mid = world(r.cluster, r.cloud)
            kubelet = m.kubelet.FakeKubelet(r.cluster)
            kubelet.join_pending(ready=True)
            reg = m.claimctl.RegistrationController(r.cluster)
            for c in ctrl._pending_repack.new_claims:
                reg.reconcile(c.name)
            steps.append(ctrl._repack_if_profitable())
            steps.append(mid)
        elif case == "never_ready":
            ctrl.repack_ready_timeout = 100.0
            steps.append(ctrl._repack_if_profitable())
            steps.append(ctrl._pending_repack is not None)
            t.t += 101
            steps.append(ctrl._repack_if_profitable())
        elif case in ("unprofitable", "cooldown"):
            c = claim(r, "ok0", price=0.2, age=t.t - 3600)
            pod(r, "q0", c.node_name, cpu=3000, mem=12288)
            ctrl.repack_min_savings_fraction = 0.9
            if case == "cooldown":
                ctrl.repack_cooldown = 600.0
            solves = []
            orig = ctrl.propose_repack
            ctrl.propose_repack = lambda: solves.append(1) or orig()
            for _ in range(3):
                steps.append(ctrl._repack_if_profitable())
            t.t += 601
            steps.append(ctrl._repack_if_profitable())
            steps.append(len(solves))
        elif case == "partial_create":
            r.cloud.recorder.inject_error(
                "create_instance", m.errors.CloudError(
                    "zone capacity", 503, code="insufficient_capacity"))
            try:
                steps.append(ctrl._repack_if_profitable())
            finally:
                r.cloud.recorder.reset()
        else:
            for i in range(8):
                c = claim(r, f"fat{i}", itype=BIG, price=0.9,
                          age=t.t - 3600)
                pod(r, f"p{i}", c.node_name, cpu=70000, mem=3000)
            steps.append(ctrl._repack_if_profitable())
        return outcome(r, *steps)

    def build(m):
        breaker = True
        if case == "breaker":
            breaker = m.breaker.CircuitBreakerManager(
                m.breaker.CircuitBreakerConfig(rate_limit_per_minute=2))
        return run(m, script, nodeclass_ready=True, provisioner=True,
                   actuator=breaker)

    steps, w, (log, _, pending) = both(fixed_ids, build)
    if case == "cutover":
        assert steps[:3] == (0, 0, 1) and pending is None
        assert sum(c[15] for c in w["claims"].values() if not c[9]) < 2.04
    elif case == "never_ready":
        assert steps == (0, True, 0) and pending is None
    elif case == "cooldown":
        assert steps[-1] == 2
    elif case == "unprofitable":
        assert steps[-1] == 4
    else:
        assert steps == (0,) and pending is None


# -- the migration repack ------------------------------------------------------

MIGRATION = ("consolidates", "hysteresis", "structural_gate", "choke_point",
             "cooldown")


@pytest.mark.parametrize("case", MIGRATION)
def test_migration_repack(fixed_ids, case):
    """``TestControllerMigration``: the batched plan drains two of three
    nodes with no create; the savings gate holds; a corrupted plan is
    caught by the planner wrapper's structural gate (the host loop plans
    on the CPU) or, unwrapped, by the controller's validator, which
    records it and actuates nothing; the cooldown is stamped on every
    attempt."""
    def script(m, r):
        ctrl = r.ctrl
        for i in range(3):
            c = claim(r, f"c{i}", itype=BIG, price=0.8)
            pod(r, f"cp{i}", c.node_name, cpu=250, mem=512)
        steps = []
        planner_kw = dev(m)

        def corrupted(problem):
            plan = m.repack.RepackPlanner(m.repack.RepackOptions(
                use_device="off"), **planner_kw).plan(problem)
            if plan.migrations:
                plan.migrations.pop()
            return plan

        if case == "hysteresis":
            ctrl.repack_min_savings_fraction = 0.99
        elif case == "structural_gate":
            class Evil:
                options = m.repack.RepackOptions()

                def plan(self, problem):
                    return corrupted(problem)

            ctrl._repacker = m.repack.ResilientRepacker(primary=Evil(),
                                                        **planner_kw)
        elif case == "choke_point":
            class EvilUnwrapped:
                def plan(self, problem):
                    return corrupted(problem)

            ctrl._repacker = EvilUnwrapped()
        elif case == "cooldown":
            ctrl.repack_cooldown = 600.0
            tick = itertools.count(10_000, 1)
            ctrl.clock = lambda: next(tick)
        steps.append(ctrl._repack_if_profitable())
        if case == "cooldown":
            calls = []
            orig = ctrl._repack_migrate_locked
            ctrl._repack_migrate_locked = lambda: calls.append(1) or orig()
            steps += [ctrl._repack_if_profitable(),
                      ctrl._repack_if_profitable(), len(calls)]
        return outcome(r, *steps)

    steps, w, (log, violations, _) = both(
        fixed_ids, lambda m: run(m, script, profiles=True, provisioner=True,
                                 repack_enabled=True, repack_cooldown=0.0,
                                 repack_rebuild=False))
    want = {"consolidates": (2,), "hysteresis": (0,),
            "structural_gate": (2,), "choke_point": (0,),
            "cooldown": (2, 0, 0, 0)}[case]
    assert steps == want
    assert bool(violations) == (case == "choke_point")
    if case == "structural_gate":
        assert log[0][3] == "degraded:greedy"


def test_defrag_reopens_the_slice_and_the_gang_lands_live(fixed_ids):
    """``TestDefragEndToEnd``: at an instance quota of the current
    footprint, the migration repack vacates one torus (no drain) and the
    gang controller's live pre-pass nominates the parked 2x2x2 gang onto
    it."""
    def script(m, r):
        r.cloud.instance_quota = 2
        pk = 0
        for i in range(2):
            c = claim(r, f"a{i}", itype=ACCEL, price=3.0)
            for _ in range(3 if i == 0 else 1):
                pod(r, f"sg{pk}", c.node_name, gpu=2)
                pk += 1
        gang = m.podgroup.PodGroup(name="parked-1", min_member=4,
                                   slice_shape="2x2x2", deadline_seconds=1e9)
        for j in range(4):
            pod(r, f"pg{j}", "", gang=gang)
        gangc = m.gangctl.GangAdmissionController(r.cluster, r.prov,
                                                  **dev(m))
        moved = r.ctrl._repack_if_profitable()
        gangc.reconcile()
        return outcome(r, moved, [(g.gang, g.claim_name, g.members,
                                   g.backend) for g in gangc.placement_log])

    steps, w, (log, _, _) = both(
        fixed_ids, lambda m: run(m, script, profiles=True, provisioner=True,
                                 repack_enabled=True, repack_cooldown=0.0,
                                 repack_rebuild=False))
    assert steps[0] == 1 and log[0][2] and log[0][1] == ()
    assert all(w["pods"][f"default/pg{j}"][1] == "a0" for j in range(4))


# -- the resident occupancy view -----------------------------------------------

def occupancy_script(m, r):
    """``tests/test_resident.py::_consolidation_rig``'s fleet: one cheap
    nearly empty node, one loaded, one empty; three ticks 31 s apart.
    The claims carry their NodeClass's hash, so the drift sweep keeps
    them and the consolidation moves run (rebinding through the
    snapshot)."""
    r.cluster.add_nodepool(m.nodeclaim.NodePool(
        name="default", nodeclass_name="default",
        consolidation_policy="WhenEmptyOrUnderutilized",
        consolidate_after_seconds=30))
    for name, itype, price in (("big", "bx2-8x32", 0.5),
                               ("cheap", "bx2-4x16", 0.1),
                               ("empty", "bx2-4x16", 0.1)):
        current(r, claim(r, name, itype=itype, price=price,
                         age=r.clock.t - 400.0))
    for name, node, cpu, mem in (("a1", "node-big", 1000, 2048),
                                 ("a2", "node-big", 1000, 2048),
                                 ("c1", "node-cheap", 500, 1024),
                                 ("c2", "node-cheap", 250, 512)):
        pod(r, name, node, cpu=cpu, mem=mem)
    for _ in range(3):
        r.ctrl.reconcile()
        r.clock.t += 31.0
    return outcome(r)


@pytest.mark.parametrize("resident", [False, True])
def test_occupancy_snapshot_and_rescan_give_the_same_moves(fixed_ids,
                                                           resident):
    """The consolidation ticks through the shared per-tick snapshot
    (``resident_occupancy``) and through the per-claim rescan make the
    same mutations, in both packages."""
    out = both(fixed_ids, lambda m: run(
        m, occupancy_script, resident_occupancy=resident))
    flip = both(fixed_ids, lambda m: run(
        m, occupancy_script, resident_occupancy=not resident))
    assert out == flip
    # cheapest first: the loaded nodes' pods move onto the empty one
    assert [n for n, c in out[1]["claims"].items() if c[9]] == ["big",
                                                                 "cheap"]
    assert {v[0] for v in out[1]["pods"].values()} == {"node-empty"}


@pytest.mark.parametrize("resident", [False, True])
def test_migration_repack_store_route_equals_rescan(fixed_ids, resident):
    """The migration repack with the resident store's occupancy rows
    (``resident_store_of`` reaches the store through the provisioner's
    wrapped solver) gives the rescan route's moves."""
    def script(m, r):
        store = m.store.resident_store_of(r.prov.solver)
        assert (store is not None) == r.ctrl.resident_occupancy
        for i in range(4):
            c = current(r, claim(r, f"c{i}", itype=BIG, price=0.8))
            pod(r, f"cp{i}", c.node_name, cpu=250 * (i + 1), mem=512)
        steps = [r.ctrl._repack_if_profitable()]
        r.ctrl.reconcile()
        return outcome(r, *steps)

    def build(m, flag):
        return run(m, script, profiles=True, provisioner=True,
                   solver={"resident": "on" if flag else "off"},
                   repack_enabled=True, repack_cooldown=0.0,
                   repack_rebuild=False, resident_occupancy=flag)

    out = both(fixed_ids, lambda m: build(m, resident))
    assert out == both(fixed_ids, lambda m: build(m, not resident))
    assert out[0][0] >= 1


# -- the journal ----------------------------------------------------------------

def test_migration_is_journaled(fixed_ids, tmp_path):
    """An executed migration plan writes its intent before the first
    rebind, with a note per moved pod; the records equal record for
    record (timestamps aside)."""
    from test_torch_recovery import intents_view, records

    def script(m, r):
        path = str(tmp_path / f"{m.pkg}.jsonl")
        r.ctrl.journal = m.journal.IntentJournal(path, owner="t")
        for i in range(3):
            c = claim(r, f"c{i}", itype=BIG, price=0.8)
            pod(r, f"cp{i}", c.node_name, cpu=250, mem=512)
        moved = r.ctrl._repack_if_profitable()
        r.ctrl.journal.close()
        recs = records(path)
        for rec in recs:
            rec.pop("owner", None)
        return outcome(r, moved, json.dumps(recs, sort_keys=True),
                       intents_view(m.journal.read_journal(path)[0]))

    steps = both(fixed_ids, lambda m: run(
        m, script, profiles=True, provisioner=True, repack_enabled=True,
        repack_cooldown=0.0, repack_rebuild=False))[0]
    assert steps[0] == 2 and "repack_migration" in steps[1]


# -- the card ---------------------------------------------------------------------

def test_disruption_controller_on_the_card_by_default(monkeypatch):
    """``DisruptionController`` resolves ``device="cuda"`` at
    construction: without a card it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = PORT
    cluster = m.cluster.ClusterState()
    with pytest.raises(RuntimeError, match="CUDA"):
        m.disruption.DisruptionController(cluster, cloudprovider=None)
    assert m.disruption.DisruptionController(
        cluster, None, device="cpu").device == torch.device("cpu")


def test_faulted_repack_on_the_card_raises_into_the_reconcile_error(
        monkeypatch):
    """The repack planner treated as one on the card (``holds_card``)
    with its torch grid forced on and a scripted device fault at its
    guard site: ``DeviceFaultError`` out of the wrapper and the
    controller, one ``ERRORS{controller.disruption, reconcile}`` sample
    from the manager's poller, no migration, no drain, no breadcrumb;
    the next sync after the fault plans."""
    from test_torch_degraded import SiteInjector

    m = PORT
    from karpenter_tpu_torch.faulttol import (
        DeviceFaultError, clear_injector, install_injector,
    )
    from karpenter_tpu_torch.faulttol import health as health_mod
    from karpenter_tpu_torch.repack import degraded as repack_degraded
    from karpenter_tpu_torch.solver.degraded import breadcrumbs

    monkeypatch.setattr(repack_degraded, "holds_card", lambda obj: True)
    monkeypatch.setattr(health_mod, "_BOARD", None)
    r = DRig(m, profiles=True, provisioner=True, repack_enabled=True,
             repack_cooldown=0.0, repack_rebuild=False,
             repack_options=m.repack.RepackOptions(use_device="on"))
    try:
        # consolidation off and the claims current with their NodeClass:
        # the tick's moves are the repack's alone
        r.cluster.add_nodepool(m.nodeclaim.NodePool(
            name="default", nodeclass_name="default",
            consolidation_policy="Never"))
        for i in range(3):
            c = current(r, claim(r, f"c{i}", itype=BIG, price=0.8))
            pod(r, f"cp{i}", c.node_name, cpu=250, mem=512)
        before_w = world(r.cluster)
        inj = SiteInjector("repack-grid")
        install_injector(inj)
        try:
            with pytest.raises(DeviceFaultError):
                r.ctrl.reconcile()
            mgr = m.controllers.ControllerManager(r.cluster)
            mgr.register(r.ctrl)
            crumbs = breadcrumbs()
            errs = m.metrics.ERRORS.samples()
            inj.left = 1
            mgr.sync(rounds=1)
            moved = errors_moved(m, errs)
        finally:
            clear_injector()
            health_mod._BOARD = None
        assert inj.injected == 2
        # the guard counts the device fault, the manager the reconcile
        assert moved == {("controller.disruption", "reconcile"): 1.0,
                         ("device", "error"): 1.0}
        assert breadcrumbs() == crumbs
        assert world(r.cluster) == before_w
        assert r.ctrl.repack_log == [] and r.ctrl.repack_violations == []
        steps = r.ctrl._repacker.primary.device_steps
        mgr.sync(rounds=1)
        assert r.ctrl.repack_log and r.ctrl._repacker.primary.device_steps \
            > steps
    finally:
        r.close()
