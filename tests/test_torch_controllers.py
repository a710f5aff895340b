"""The port's controller runtime and its host controllers against the
reference's, on the CPU.

``karpenter_tpu_torch/controllers/{runtime,nodeclaim,nodeclass,bootstrap,
faults}.py`` and ``core/leaderelection.py`` are copies of the
reference's modules.  Each call script below is taken from the
reference's own tests (``tests/test_controllers.py``,
``test_nodeclaim_depth.py``, ``test_nodeclass_depth.py``,
``test_admission.py``, ``test_leaderelection.py``) and runs once per
package; the two outcomes are compared exactly: the claims, nodes, pods
(bindings and nominations), NodeClass statuses, events, the fake
cloud's calls and instances, the blacked-out offerings, the ``ERRORS``
samples a script moved, the manager's crash counters and the lease
state.  Claim names and tokens come from the ``fixed_ids`` counters.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
import time
import types

import pytest

from test_torch_provisioner import (  # noqa: F401 — fixtures
    PKGS, cloud_calls, events, fixed_ids, mods, permissive_breaker,
    ready_nodeclass,
)

_CMODS = dict(
    runtime="controllers.runtime", controllers="controllers",
    claimctl="controllers.nodeclaim", classctl="controllers.nodeclass",
    bootctl="controllers.bootstrap", faults="controllers.faults",
    disruption="controllers.disruption", preemption="controllers.preemption",
    gangctl="controllers.gang", leader="core.leaderelection",
    drift="core.drift", podgroup="apis.podgroup",
    requirements="apis.requirements", repack="repack",
    repack_planner="repack.planner", store="resident.store",
    gang_planner="gang.planner", preempt_planner="preempt.planner",
    gang_types="gang.types", preempt_types="preempt.types",
    faulttol="faulttol", health="faulttol.health")


def cmods(pkg: str) -> types.SimpleNamespace:
    """``test_torch_provisioner.mods`` plus the controllers' modules."""
    m = mods(pkg)
    for k, v in _CMODS.items():
        setattr(m, k, importlib.import_module(f"{pkg}.{v}"))
    return m


CSIDES = tuple(cmods(p) for p in PKGS)


def dev(m) -> dict:
    """The port's planning controllers and provisioner on the CPU."""
    return {"device": "cpu"} if m.torch else {}


@contextlib.contextmanager
def own_state(pkg: str):
    """One package's run on a fresh explain registry (it dedupes the
    controllers' Unplaced events per pod key, process-wide), a fresh
    placement ledger and a fresh spot risk model (the spot controller
    rebuilds the model from the ledger): no earlier test in the worker
    decides an event or a price."""
    explain = importlib.import_module(f"{pkg}.explain")
    obs = importlib.import_module(f"{pkg}.obs")
    risk = importlib.import_module(f"{pkg}.stochastic.risk")
    saved = explain._REGISTRY, risk._MODEL
    explain._REGISTRY = explain.ExplainRegistry()
    risk._MODEL = risk.SpotRiskModel()
    try:
        with obs.use_ledger(obs.PlacementLedger()):
            yield
    finally:
        explain._REGISTRY, risk._MODEL = saved


def both(ids, script):
    """``script(m)`` once per package with the id counters restarted,
    each on its own process state (``own_state``); asserts the outcomes
    equal and returns the reference's."""
    outs = []
    for pkg, m in zip(PKGS, CSIDES):
        ids.reset()
        before = m.metrics.ERRORS.samples()
        with own_state(pkg):
            out = script(m)
        outs.append((out, errors_moved(m, before)))
    assert outs[0] == outs[1], first_diff(outs[0], outs[1])
    return outs[0][0]


def first_diff(a, b, path="") -> str:
    """Where two outcomes first part: a path and both values."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in list(a) + [k for k in b if k not in a]:
            if a.get(k, "<absent>") != b.get(k, "<absent>"):
                return first_diff(a.get(k, "<absent>"),
                                  b.get(k, "<absent>"), f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_diff(x, y, f"{path}[{i}]")
    return f"{path}: reference {a!r}, port {b!r}"


def errors_moved(m, before: dict) -> dict:
    after = m.metrics.ERRORS.samples()
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v != before.get(k, 0.0)}


# -- views --------------------------------------------------------------------

def claims_view(cluster, stamps=False):
    out = {}
    for c in cluster.nodeclaims():
        ann = dict(c.annotations)
        out[c.name] = (c.instance_type, c.zone, c.capacity_type,
                       c.nodepool_name, c.node_name, c.provider_id,
                       c.registered, c.initialized, c.launched, c.deleted,
                       tuple(c.finalizers), tuple(sorted(c.labels.items())),
                       tuple(sorted(ann.items())), taints_view(c.taints),
                       taints_view(c.startup_taints), c.hourly_price)
        if stamps:
            out[c.name] += (c.registered_at > 0,)
    return out


def taints_view(taints):
    return tuple((t.key, t.value, t.effect) for t in taints)


def nodes_view(cluster):
    return {n.name: (n.provider_id, tuple(sorted(n.labels.items())),
                     tuple(sorted(n.annotations.items())),
                     taints_view(n.taints), n.ready,
                     tuple(sorted(n.conditions.items())), n.deleted)
            for n in cluster.nodes()}


def pods_view(cluster):
    return {k: (p.bound_node, p.nominated_node, p.enqueued_at == 0.0,
                p.spec.gang is None)
            for k, p in sorted(cluster._collections["pods"].items())}


def nodeclass_view(nc):
    if nc is None:
        return None
    s = nc.status
    return (s.is_ready(), s.validation_error, s.resolved_image_id,
            tuple(s.resolved_security_groups),
            tuple(s.selected_instance_types), tuple(s.selected_subnets),
            tuple(sorted(nc.annotations.items())), tuple(nc.finalizers),
            nc.deleted)


def cluster_events(cluster):
    return events(types.SimpleNamespace(cluster=cluster))


def world(cluster, cloud=None, unavail=None):
    out = {"claims": claims_view(cluster), "nodes": nodes_view(cluster),
           "pods": pods_view(cluster), "events": cluster_events(cluster),
           "nodeclasses": {nc.name: nodeclass_view(nc)
                           for nc in cluster.list("nodeclasses")}}
    if cloud is not None:
        out["calls"] = cloud_calls(types.SimpleNamespace(cloud=cloud))
        out["instances"] = sorted(
            (i.id, i.name, i.profile, i.zone, i.capacity_type, i.subnet_id,
             i.image_id, tuple(sorted(i.tags.items())))
            for i in cloud.list_instances())
    if unavail is not None:
        out["unavailable"] = sorted(unavail.unavailable_keys())
    return out


# -- the rig (``tests/test_controllers.py::rig``) ---------------------------

class CRig(types.SimpleNamespace):
    def close(self):
        self.pricing.close()


def crig(m, profiles=None) -> CRig:
    cloud = m.fake.FakeCloud() if profiles is None else \
        m.fake.FakeCloud(profiles=profiles)
    pricing = m.catalog.PricingProvider(cloud)
    unavail = m.catalog.UnavailableOfferings()
    itp = m.catalog.InstanceTypeProvider(cloud, pricing, unavail)
    cluster = m.cluster.ClusterState()
    actuator = m.actuator.Actuator(cloud, cluster, unavailable=unavail,
                                   breaker=permissive_breaker(m))
    return CRig(m=m, cloud=cloud, pricing=pricing, unavail=unavail, itp=itp,
                cluster=cluster, actuator=actuator)


def with_rig(script, **kw):
    def run(m):
        r = crig(m, **kw)
        try:
            return script(m, r)
        finally:
            r.close()
    return run


def plain_nodeclass(m, name="default", **kw):
    """``tests/test_controllers.py::ready_nodeclass``."""
    nc = m.nodeclass.NodeClass(name=name, spec=m.nodeclass.NodeClassSpec(
        region="us-south", image="img-1", vpc="vpc-1", **kw))
    if not nc.spec.instance_requirements:
        nc.spec.instance_profile = nc.spec.instance_profile or "bx2-4x16"
    nc.status.resolved_image_id = "img-1"
    nc.status.set_condition("Ready", "True", "Validated")
    return nc


def launch_claim(m, r, name="default", capacity="on-demand", price=0.2):
    if r.cluster.get_nodeclass(name) is None:
        r.cluster.add_nodeclass(plain_nodeclass(m, name))
    cat = m.arrays.CatalogArrays.build(r.itp.list())
    o = cat.find_offering("bx2-4x16", "us-south-1", capacity)
    return r.actuator.create_node(
        m.types.PlannedNode("bx2-4x16", "us-south-1", capacity, price=price,
                            offering_index=o, pod_names=("default/p0",)),
        r.cluster.get_nodeclass(name), cat)


# -- the runtime --------------------------------------------------------------

def test_runtime_sync_requeue_and_crash_backoff(fixed_ids):
    """Sync reconciles what exists, a poller reruns per round, a raising
    reconcile is counted and backs off 5 s doubling to 5 min per key, a
    success resets its key, ``stop`` clears the history."""
    def script(m, r):
        rt = m.runtime
        seen, polls = [], []

        class Watch(rt.WatchController):
            name = "t"
            watch_kinds = ("nodeclasses",)

            def reconcile(self, key):
                seen.append(key)
                return rt.Result()

        class Poll(rt.PollController):
            name = "p"
            interval = 100.0

            def reconcile(self):
                polls.append(1)
                return rt.Result(requeue_after=0.01)

        class Flaky(rt.WatchController):
            name = "flaky"
            watch_kinds = ("nodeclasses",)
            poisoned = True

            def reconcile(self, key):
                if self.poisoned:
                    raise RuntimeError("boom")
                return rt.Result()

        r.cluster.add_nodeclass(plain_nodeclass(m, "a"))
        mgr = m.controllers.ControllerManager(r.cluster)
        flaky = Flaky()
        for c in (Watch(), Poll(), flaky):
            mgr.register(c)
        with pytest.raises(TypeError):
            mgr.register(object())
        mgr.sync(rounds=2)
        delays = [mgr._reconcile_one(flaky, "k").requeue_after
                  for _ in range(9)]
        steps = [mgr._reconcile_one(flaky, "b").requeue_after]
        flaky.poisoned = False
        steps.append(mgr._reconcile_one(flaky, "k").requeue_after)
        flaky.poisoned = True
        steps.append(mgr._reconcile_one(flaky, "k").requeue_after)
        steps.append(mgr._reconcile_one(flaky, "k").requeue_after)
        mgr.stop()
        steps.append(mgr._reconcile_one(flaky, "k").requeue_after)
        return (seen, len(polls), delays, steps, mgr.controllers(),
                dict(mgr._crash_counts))

    out = both(fixed_ids, with_rig(script))
    assert out[2] == [5.0, 10.0, 20.0, 40.0, 80.0, 160.0, 300.0, 300.0,
                      300.0]
    assert out[3] == [5.0, 0.0, 5.0, 10.0, 5.0]


def test_runtime_live_watch_and_leader_gate(fixed_ids):
    """The threaded manager: a watch event reaches reconcile; a follower
    keeps the key queued and its pollers skip, a sync of a follower does
    nothing; after the flip to leader the queued key drains."""
    def script(m, r):
        rt = m.runtime
        done = threading.Event()
        got, polls = [], []
        leading = {"v": False}

        class C(rt.WatchController):
            name = "live"
            watch_kinds = ("nodeclasses",)

            def reconcile(self, key):
                got.append(key)
                done.set()
                return rt.Result()

        class P(rt.PollController):
            name = "poll"
            interval = 0.05

            def reconcile(self):
                polls.append(1)
                return rt.Result()

        mgr = m.controllers.ControllerManager(
            r.cluster, leader=lambda: leading["v"])
        mgr.register(C())
        mgr.register(P())
        mgr.sync()
        mgr.start()
        try:
            r.cluster.add_nodeclass(plain_nodeclass(m, "live-nc"))
            follower = (done.wait(0.5), len(polls))
            leading["v"] = True
            assert done.wait(5.0), "the queued key never drained"
        finally:
            mgr.stop()
        return follower, got[:1]

    assert both(fixed_ids, with_rig(script)) == ((False, 0), ["live-nc"])


# -- leader election ----------------------------------------------------------

class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def lease_view(m, store, name):
    lease = store.get(m.leader.LEASE_KIND, name)
    return None if lease is None else (lease.holder, lease.acquire_time,
                                       lease.renew_time,
                                       lease.lease_duration, lease.resource_version)


def test_lease_acquire_renew_takeover_and_release(fixed_ids):
    """``tests/test_leaderelection.py::TestLeaseCAS``: first acquire,
    a live lease not stolen, an expired one taken over with the old
    holder fenced, renew keeping the acquire time, stop releasing."""
    def script(m):
        store, clock = m.cluster.ClusterState(), FakeClock()

        def el(ident):
            return m.leader.LeaderElector(store, identity=ident,
                                          clock=clock, lease_duration=15.0)

        a, b, c = el("a"), el("b"), el("c")
        steps = [a.try_acquire_or_renew(), a.is_leader()]
        steps.append(lease_view(m, store, a.lease_name))
        clock.t += 5
        steps += [b.try_acquire_or_renew(), b.is_leader(), a.is_leader(),
                  a.try_acquire_or_renew(),
                  lease_view(m, store, a.lease_name)]
        clock.t += 16
        steps += [b.try_acquire_or_renew(), b.is_leader(), a.is_leader(),
                  lease_view(m, store, a.lease_name)]
        b.stop()
        steps += [c.is_leader(), c.try_acquire_or_renew(), c.is_leader(),
                  lease_view(m, store, a.lease_name)]
        always = m.leader.AlwaysLeader()
        steps += [always.is_leader(), always.start() is always]
        always.stop()
        return steps

    steps = both(fixed_ids, script)
    assert steps[:2] == [True, True] and steps[3] is False


def test_lease_race_has_one_winner(fixed_ids):
    def script(m):
        store, clock = m.cluster.ClusterState(), FakeClock()
        electors = [m.leader.LeaderElector(store, identity=f"r{i}",
                                           clock=clock, lease_duration=15.0)
                    for i in range(8)]
        barrier = threading.Barrier(8)
        results = [None] * 8

        def race(i):
            barrier.wait()
            results[i] = electors[i].try_acquire_or_renew()

        threads = [threading.Thread(target=race, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        holder = store.get(m.leader.LEASE_KIND, electors[0].lease_name)
        winners = [e.identity for e, ok in zip(electors, results) if ok]
        return sum(results), winners == [holder.holder]

    assert both(fixed_ids, script) == (1, True)


def test_leader_gate_on_the_provisioner_and_the_manager(fixed_ids):
    """A follower's provisioner window and manager sync actuate nothing;
    the same rig as leader does (``TestActuationGate``)."""
    def script(m, r):
        r.cluster.add_nodeclass(ready_nodeclass(m))
        for i in range(4):
            r.cluster.add_pod(m.pod.PodSpec(
                f"p{i}", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
        store, clock = r.cluster, FakeClock()
        el = m.leader.LeaderElector(store, identity="x", clock=clock)
        prov = m.provisioner.Provisioner(
            r.cluster, r.itp, r.actuator, m.provisioner.ProvisionerOptions(
                solver=m.types.SolverOptions(backend="greedy")),
            leader=el.is_leader, **dev(m))
        mgr = m.controllers.ControllerManager(r.cluster, leader=el.is_leader)
        mgr.register(m.claimctl.GarbageCollectionController(r.cluster,
                                                            r.cloud))
        specs = [p.spec for p in r.cluster.pending_pods()]
        follower = prov._on_window(specs)
        mgr.sync()
        before = world(r.cluster, r.cloud)
        el.try_acquire_or_renew()
        leader = [o is not None for o in prov._on_window(specs)]
        mgr.sync()
        return follower, before, leader, world(r.cluster, r.cloud)

    out = both(fixed_ids, with_rig(script))
    assert out[0] == [None] * 4 and not out[1]["claims"] and any(out[2])


# -- the NodeClass controllers -----------------------------------------------

def _valid_spec(m, **kw):
    """``tests/test_admission.py::_valid_spec``."""
    base = dict(region="us-south", zone="us-south-1", vpc="vpc-1",
                image="img-1", instance_profile="bx2-4x16")
    base.update(kw)
    return m.nodeclass.NodeClassSpec(**base)


def test_nodeclass_hash_and_status(fixed_ids):
    """Hash stamps; status validates and resolves an image selector and
    the default security group; a bad profile and a zone/subnet mismatch
    are refused; the cloud checks (VPC, security groups, SSH keys) each
    give their error; a transient listing error does not unready."""
    def script(m, r):
        NC = m.nodeclass
        cluster = r.cluster
        cluster.add_nodeclass(plain_nodeclass(m))
        m.classctl.NodeClassHashController(cluster).reconcile("default")
        status = m.classctl.NodeClassStatusController(cluster, r.cloud)
        wrong = next(s for s in r.cloud.list_subnets()
                     if s.zone != "us-south-1")
        r.cloud.security_groups["sg-app"] = "app"
        cases = {
            "nc1": NC.NodeClassSpec(
                region="us-south", instance_profile="bx2-4x16",
                image_selector=NC.ImageSelector(os="ubuntu",
                                                major_version="22")),
            "bad": NC.NodeClassSpec(region="us-south",
                                    instance_profile="nope-99x99",
                                    image="img-1"),
            "zs": NC.NodeClassSpec(region="us-south", zone="us-south-1",
                                   subnet=wrong.id,
                                   instance_profile="bx2-4x16",
                                   image="img-1"),
            "vpc": _valid_spec(m, vpc="vpc-elsewhere"),
            "sg": _valid_spec(m, security_groups=("sg-app", "sg-ghost")),
            "ssh": _valid_spec(m, ssh_keys=("key-1", "key-ghost")),
            "ok": _valid_spec(m, security_groups=("sg-default",),
                              ssh_keys=("key-1",)),
        }
        results = {}
        for name, spec in cases.items():
            cluster.add_nodeclass(NC.NodeClass(name=name, spec=spec))
            res = status.reconcile(name)
            results[name] = (nodeclass_view(cluster.get_nodeclass(name)),
                             res.requeue_after)
        r.cloud.recorder.set_persistent_error(
            "list_vpcs", m.errors.CloudError("api down", 503))
        cluster.add_nodeclass(NC.NodeClass(name="flaky",
                                           spec=_valid_spec(m)))
        status.reconcile("flaky")
        r.cloud.recorder.set_persistent_error("list_vpcs", None)
        results["flaky"] = nodeclass_view(cluster.get_nodeclass("flaky"))
        results["noop"] = status.reconcile("ok").requeue_after
        return results, world(cluster, r.cloud)

    results, _ = both(fixed_ids, with_rig(script))
    assert results["nc1"][0][0] and not results["bad"][0][0]
    assert results["flaky"][0]


def test_autoplacement_and_hash_restamp(fixed_ids):
    """Requirements select types and one subnet per zone (Balanced);
    an empty selection warns; the hash restamps only on a spec change."""
    def script(m, r):
        NC = m.nodeclass
        cluster = r.cluster
        ctrl = m.classctl.AutoplacementController(
            cluster, r.itp, m.subnet.SubnetProvider(r.cloud))
        cluster.add_nodeclass(NC.NodeClass(name="auto", spec=NC.NodeClassSpec(
            region="us-south", image="img-1",
            instance_requirements=NC.InstanceRequirements(
                min_cpu=4, min_memory_gib=8),
            placement_strategy=NC.PlacementStrategy(
                zone_balance="Balanced"))))
        cluster.add_nodeclass(NC.NodeClass(name="none", spec=NC.NodeClassSpec(
            region="us-south", image="img-1",
            instance_requirements=NC.InstanceRequirements(min_cpu=100000))))
        out = [ctrl.reconcile(n).requeue_after for n in ("auto", "none",
                                                         "auto")]
        hasher = m.classctl.NodeClassHashController(cluster)
        hasher.reconcile("auto")
        first = dict(cluster.get_nodeclass("auto").annotations)
        hasher.reconcile("auto")
        same = dict(cluster.get_nodeclass("auto").annotations) == first
        nc = cluster.get_nodeclass("auto")
        nc.spec.zone = "us-south-2"
        cluster.update("nodeclasses", "auto", nc)
        hasher.reconcile("auto")
        moved = dict(cluster.get_nodeclass("auto").annotations) != first
        return out, same, moved, world(cluster)

    _, same, moved, w = both(fixed_ids, with_rig(script))
    assert same and moved and w["nodeclasses"]["auto"][4]


def test_nodeclass_termination_waits_for_claims(fixed_ids):
    def script(m, r):
        claim = launch_claim(m, r)
        ctrl = m.classctl.NodeClassTerminationController(r.cluster)
        steps = [ctrl.reconcile("default").requeue_after]
        nc = r.cluster.get_nodeclass("default")
        finalizers = list(nc.finalizers)
        nc.deleted = True
        steps.append(ctrl.reconcile("default").requeue_after > 0)
        steps.append(r.cluster.get_nodeclass("default") is not None)
        r.cluster.delete("nodeclaims", claim.name)
        ctrl.reconcile("default")
        steps.append(r.cluster.get_nodeclass("default") is None)
        return finalizers, steps, world(r.cluster, r.cloud)

    finalizers, steps, _ = both(fixed_ids, with_rig(script))
    assert finalizers and steps[1:] == [True, True, True]


# -- the NodeClaim controllers -----------------------------------------------

def test_registration_and_startup_taints(fixed_ids):
    """Registration syncs labels and taints, drops the unregistered
    taint, initializes on Ready (two phases, one Registered event);
    startup taints wait for Ready and a settling CNI taint, and only
    startup taints go."""
    def script(m, r):
        Taint = m.pod.Taint
        claim = launch_claim(m, r)
        claim.taints = (Taint("dedicated", "gpu", "NoSchedule"),)
        claim.startup_taints = (Taint("example.com/startup", "",
                                      "NoSchedule"),)
        kubelet = m.kubelet.FakeKubelet(r.cluster)
        node = kubelet.join(claim)
        node.labels["karpenter.sh/capacity-type"] = "kept"
        reg = m.claimctl.RegistrationController(r.cluster)
        st = m.claimctl.StartupTaintController(r.cluster)
        steps = [reg.reconcile(claim.name).requeue_after,
                 reg.reconcile(claim.name).requeue_after,
                 st.reconcile(claim.name).requeue_after]
        mid = world(r.cluster)
        kubelet.mark_ready(node.name)
        n = r.cluster.get_node(node.name)
        n.taints.append(Taint("node.cilium.io/agent-not-ready", "",
                              "NoExecute"))
        r.cluster.update("nodes", n.name, n)
        steps += [reg.reconcile(claim.name).requeue_after,
                  st.reconcile(claim.name).requeue_after > 0]
        n = r.cluster.get_node(node.name)
        n.taints = [t for t in n.taints
                    if not t.key.startswith("node.cilium.io")]
        r.cluster.update("nodes", n.name, n)
        steps.append(st.reconcile(claim.name).requeue_after)
        # a deleted claim and a wrong provider id are never matched
        stray = m.nodeclaim.Node(name="stray", provider_id="tpu:///x/y")
        r.cluster.add_node(stray)
        steps.append(reg.reconcile("no-such-claim").requeue_after)
        return steps, mid, world(r.cluster, r.cloud)

    steps, mid, end = both(fixed_ids, with_rig(script))
    claim = next(iter(end["claims"].values()))
    assert claim[6] and claim[7]          # registered, initialized


def test_claim_termination_and_node_eviction(fixed_ids):
    """A deleted claim's termination evicts its bound pods back to
    pending, deletes the node and the instance, then the claim."""
    def script(m, r):
        claim = launch_claim(m, r)
        m.kubelet.FakeKubelet(r.cluster).join(claim, ready=True)
        m.claimctl.RegistrationController(r.cluster).reconcile(claim.name)
        claim = r.cluster.get_nodeclaim(claim.name)
        for i in range(3):
            r.cluster.add_pod(m.pod.PodSpec(
                f"b{i}", requests=m.pod.ResourceRequests(100, 128, 0, 1)))
            r.cluster.bind_pod(f"default/b{i}", claim.node_name)
        claim.deleted = True
        ctrl = m.claimctl.NodeClaimTerminationController(r.cluster,
                                                         r.actuator)
        res = [ctrl.reconcile(claim.name).requeue_after,
               ctrl.reconcile(claim.name).requeue_after]
        return res, world(r.cluster, r.cloud), r.cloud.instance_count(), \
            r.cluster.evict_node_pods("")

    res, w, count, noop = both(fixed_ids, with_rig(script))
    assert not w["claims"] and not w["nodes"] and count == 0 and noop == 0
    assert all(v[:2] == ("", "") for v in w["pods"].values())


def test_garbage_collection(fixed_ids):
    """Orphans past the newborn grace are reaped (unmanaged instances
    never), a dead claim and a never-registered claim are deleted, the
    interval is fast while dirty and slow when clean (the newborn orphan
    does not make the first sweep dirty)."""
    def script(m, r):
        claim = launch_claim(m, r)
        timeout = launch_claim(m, r)
        sub = r.cloud.list_subnets()[0].id
        orphan = r.cloud.create_instance(
            name="orphan", profile="bx2-4x16", zone="us-south-1",
            subnet_id=sub, image_id="img-1",
            tags={"karpenter.sh/managed": "true"})
        pet = r.cloud.create_instance(
            name="pet", profile="bx2-4x16", zone="us-south-1",
            subnet_id=sub, image_id="img-1")
        gc = m.claimctl.GarbageCollectionController(r.cluster, r.cloud)
        m.kubelet.FakeKubelet(r.cluster).join(claim, ready=True)
        m.claimctl.RegistrationController(r.cluster).reconcile(claim.name)
        steps = [gc.reconcile().requeue_after == gc.fast_interval,
                 orphan.id in {i.id for i in r.cloud.list_instances()}]
        r.cloud.instances[orphan.id].created_at = time.time() - 10000
        r.cluster.get_nodeclaim(timeout.name).created_at = \
            time.time() - 1000
        steps.append(gc.reconcile().requeue_after == gc.fast_interval)
        ids = {i.id for i in r.cloud.list_instances()}
        steps += [orphan.id in ids, pet.id in ids]
        r.cloud.delete_instance(claim.provider_id.rsplit("/", 1)[1])
        gc.reconcile()
        steps.append(r.cluster.get_nodeclaim(claim.name).deleted)
        steps.append(r.cluster.get_nodeclaim(timeout.name).deleted)
        for _ in range(3):
            res = gc.reconcile()
        steps.append(res.requeue_after == gc.interval)
        return steps, world(r.cluster, r.cloud)

    steps, _ = both(fixed_ids, with_rig(script))
    assert steps == [False, True, True, False, True, True, True, True]


def test_tagging_restores_tags(fixed_ids):
    def script(m, r):
        claim = launch_claim(m, r)
        iid = claim.provider_id.rsplit("/", 1)[1]
        r.cloud.update_tags(iid, {})
        res = m.claimctl.TaggingController(r.cluster, r.cloud).reconcile()
        return res.requeue_after, \
            sorted(r.cloud.get_instance(iid).tags.items()), \
            world(r.cluster, r.cloud)

    _, tags, _ = both(fixed_ids, with_rig(script))
    assert ("karpenter.sh/managed", "true") in tags


# -- the fault ring -----------------------------------------------------------

def test_interruption_replaces_blacks_out_and_suppresses(fixed_ids):
    """A capacity condition replaces and blacks out; a never-ready node
    is suppressed inside its grace (anchored on the claim's
    registration) and handled past it; a health condition replaces
    without a blackout, and a node is interrupted once."""
    def script(m, r):
        ctrl = m.faults.InterruptionController(r.cluster, r.unavail)
        kubelet = m.kubelet.FakeKubelet(r.cluster)
        reg = m.claimctl.RegistrationController(r.cluster)
        a = launch_claim(m, r)
        node = kubelet.join(a, ready=True)
        reg.reconcile(a.name)
        kubelet.mark_condition(node.name, "OutOfCapacity", "True")
        ctrl.reconcile()
        steps = [r.cluster.get_nodeclaim(a.name).deleted]
        b = launch_claim(m, r)
        node_b = kubelet.join(b)
        kubelet.mark_condition(node_b.name, "NetworkUnavailable", "True")
        b.registered_at = time.time() - (ctrl.never_ready_grace - 30)
        ctrl.reconcile()
        steps.append(r.cluster.get_nodeclaim(b.name).deleted)
        b.registered_at = time.time() - (ctrl.never_ready_grace + 30)
        ctrl.reconcile()
        steps.append(r.cluster.get_nodeclaim(b.name).deleted)
        c = launch_claim(m, r)
        node_c = kubelet.join(c, ready=True)
        reg.reconcile(c.name)
        kubelet.mark_condition(node_c.name, "KernelDeadlock", "True")
        ctrl.reconcile()
        ctrl.reconcile()
        steps.append(r.cluster.get_nodeclaim(c.name).deleted)
        steps.append(len([e for e in r.cluster.events_for("Node", node.name)
                          if e.reason == "Interrupted"]))
        return steps, world(r.cluster, r.cloud, r.unavail)

    steps, w = both(fixed_ids, with_rig(script))
    assert steps == [True, False, True, True, 1]
    assert w["unavailable"] == ["bx2-4x16:us-south-1:on-demand"]


def test_spot_preemption_blacks_out_and_rekeys_the_catalog(fixed_ids):
    """The cloud preempts a spot instance: the controller blacks the
    offering out, deletes the claim and the instance; the catalog's
    availability is re-keyed, not rebuilt, and its mask drops the
    offering."""
    def script(m, r):
        claim = launch_claim(m, r, capacity="spot", price=0.1)
        cat = m.arrays.CatalogArrays.build(r.itp.list())
        o = cat.find_offering("bx2-4x16", "us-south-1", "spot")
        iid = claim.provider_id.rsplit("/", 1)[1]
        r.cloud.preempt_spot_instance(iid)
        res = m.faults.SpotPreemptionController(
            r.cluster, r.cloud, r.unavail).reconcile()
        gen = cat.availability_generation
        cat.refresh_availability(r.unavail)
        return (res.requeue_after, gen != cat.availability_generation,
                bool(cat.offering_available()[o]) if hasattr(
                    cat, "offering_available") else None,
                r.cloud.instance_count(),
                world(r.cluster, r.cloud, r.unavail))

    out = both(fixed_ids, with_rig(script))
    assert out[1] and out[3] == 0
    assert "bx2-4x16:us-south-1:spot" in out[4]["unavailable"]


def test_orphan_cleanup_two_way_and_gated(fixed_ids):
    """Off by default; on, it reaps old managed instances only (never a
    young or an unmanaged one), drops a node whose instance is gone and
    keeps one through a transient 503."""
    def script(m, r):
        tags = {"karpenter.sh/managed": "true"}
        sub = r.cloud.list_subnets()[0].id
        off = m.faults.OrphanCleanupController(r.cluster, r.cloud,
                                               enabled=False)
        on = m.faults.OrphanCleanupController(r.cluster, r.cloud,
                                              enabled=True)
        made = {}
        for name, tag, age in (
                ("old", tags, on.min_instance_age + 60),
                ("young", tags, on.min_instance_age - 60),
                ("pet", {"owner": "someone-else"}, 10 ** 6)):
            inst = r.cloud.create_instance(name=name, profile="bx2-4x16",
                                           zone="us-south-1", subnet_id=sub,
                                           image_id="img-1", tags=tag)
            r.cloud.instances[inst.id].created_at = time.time() - age
            made[name] = inst.id
        off.reconcile()
        steps = [r.cloud.instance_count()]
        claim = launch_claim(m, r)
        live = m.kubelet.FakeKubelet(r.cluster).join(claim, ready=True)
        r.cluster.add_node(m.nodeclaim.Node(
            name="ghost", provider_id=m.nodeclaim.provider_id(
                "us-south", "inst-xyz")))
        r.cloud.recorder.inject_error(
            "get_instance", m.errors.CloudError("brownout", 503), times=1)
        on.reconcile()
        on.reconcile()
        ids = {i.id for i in r.cloud.list_instances()}
        steps += [{k: v in ids for k, v in made.items()},
                  r.cluster.get_node("ghost") is None,
                  r.cluster.get_node(live.name) is not None]
        return steps, world(r.cluster, r.cloud)

    steps, _ = both(fixed_ids, with_rig(script))
    assert steps[0] == 3
    assert steps[1] == {"old": False, "young": True, "pet": True}
    assert steps[2:] == [True, True]


def test_refreshers(fixed_ids):
    def script(m, r):
        r.unavail.mark_unavailable("bx2-4x16", "us-south-1", "spot",
                                   ttl=-1.0)
        a = m.faults.InstanceTypeRefreshController(
            r.itp, r.unavail).reconcile().requeue_after
        b = m.faults.PricingRefreshController(object()).reconcile()
        c = m.faults.PricingRefreshController(r.pricing).reconcile()
        return (a, b.requeue_after, c.requeue_after,
                r.unavail.is_unavailable("bx2-4x16", "us-south-1", "spot"))

    assert both(fixed_ids, with_rig(script))[3] is False


# -- the bootstrap token controller -------------------------------------------

def test_bootstrap_token_lifecycle(fixed_ids):
    """RBAC ensured once, a token pre-minted, a fresh one near expiry,
    the dead one swept (``TestBootstrapTokenController``)."""
    def script(m):
        now = [1000.0]
        tokens = m.bootstrap.TokenStore(clock=lambda: now[0])
        cluster = m.cluster.ClusterState()
        ctrl = m.bootctl.BootstrapTokenController(cluster, tokens)

        def view():
            return (sorted(t.token_id for t in tokens.live_tokens()),
                    len(cluster.list("rbac")), ctrl.missing_bindings())

        steps = [ctrl.reconcile().requeue_after, view()]
        first = tokens.live_tokens()[0]
        now[0] += 3600
        ctrl.reconcile()
        steps.append(view())
        now[0] = first.expires_at - 3600
        ctrl.reconcile()
        steps.append(view())
        now[0] = first.expires_at + 1
        ctrl.reconcile()
        steps.append(view())
        return steps, len(m.bootctl.REQUIRED_BINDINGS)

    steps, bindings = both(fixed_ids, script)
    assert steps[1][1] == bindings and len(steps[3][0]) == 2
    assert len(steps[4][0]) == 1


# -- the plane ----------------------------------------------------------------

def test_controller_plane_end_to_end(fixed_ids):
    """Launch, join, register, interrupt, terminate through one
    manager's ``sync``."""
    def script(m, r):
        claim = launch_claim(m, r)
        mgr = m.controllers.ControllerManager(r.cluster)
        for c in (m.classctl.NodeClassHashController(r.cluster),
                  m.classctl.NodeClassStatusController(r.cluster, r.cloud),
                  m.claimctl.RegistrationController(r.cluster),
                  m.claimctl.StartupTaintController(r.cluster),
                  m.claimctl.NodeClaimTerminationController(r.cluster,
                                                            r.actuator),
                  m.claimctl.GarbageCollectionController(r.cluster, r.cloud),
                  m.faults.InterruptionController(r.cluster, r.unavail)):
            mgr.register(c)
        kubelet = m.kubelet.FakeKubelet(r.cluster)
        node = kubelet.join(claim, ready=True)
        mgr.sync()
        mid = world(r.cluster, r.cloud, r.unavail)
        kubelet.mark_condition(node.name, "OutOfCapacity", "True")
        mgr.sync()
        return mid, world(r.cluster, r.cloud, r.unavail)

    mid, end = both(fixed_ids, with_rig(script))
    assert all(c[6] and c[7] for c in mid["claims"].values())
    assert not end["claims"] and not end["instances"]


def operator_controllers(m, r, prov, journal=None):
    """The reference operator's registration list
    (``karpenter_tpu/operator/operator.py:189-255``) without the IKS,
    load-balancer and what-if entries; interruption, preemption and gang
    admission enabled, orphan cleanup off (its default)."""
    cp = m.cloudprovider.CloudProvider(r.cluster, r.actuator, r.itp)
    return [
        m.classctl.NodeClassHashController(r.cluster),
        m.classctl.NodeClassStatusController(
            r.cluster, r.cloud, subnet_provider=r.actuator.subnets,
            image_resolver=r.actuator.images),
        m.classctl.AutoplacementController(r.cluster, r.itp,
                                           r.actuator.subnets),
        m.classctl.NodeClassTerminationController(r.cluster),
        m.claimctl.RegistrationController(r.cluster),
        m.claimctl.StartupTaintController(r.cluster),
        m.claimctl.NodeClaimTerminationController(r.cluster, r.actuator),
        m.claimctl.GarbageCollectionController(r.cluster, r.cloud,
                                               journal=journal),
        m.claimctl.TaggingController(r.cluster, r.cloud),
        m.faults.SpotPreemptionController(r.cluster, r.cloud, r.unavail,
                                          journal=journal),
        m.faults.InstanceTypeRefreshController(r.itp, r.unavail),
        m.faults.PricingRefreshController(r.pricing),
        m.faults.InterruptionController(r.cluster, r.unavail,
                                        cloud=r.cloud),
        m.bootctl.BootstrapTokenController(r.cluster,
                                           r.actuator.bootstrap.tokens),
        m.disruption.DisruptionController(
            r.cluster, cp, provisioner=prov, journal=journal, **dev(m)),
        m.preemption.PreemptionController(r.cluster, prov, journal=journal,
                                          **dev(m)),
        m.gangctl.GangAdmissionController(r.cluster, prov, journal=journal,
                                          **dev(m)),
        m.faults.OrphanCleanupController(r.cluster, r.cloud, enabled=False,
                                         journal=journal),
    ]


def test_operator_controller_list_provisions_joins_and_drains(fixed_ids):
    """Every ported controller in the operator's order over a started
    provisioning rig: 40 pods provisioned, the kubelet joins, ``sync``
    registers and binds nothing it should not; half the pods deleted,
    the empty claims retire after the pool's 30 s (a fake clock)."""
    def script(m, r):
        r.cluster.add_nodeclass(ready_nodeclass(m))
        r.actuator.breaker = permissive_breaker(m)
        prov = m.provisioner.Provisioner(
            r.cluster, r.itp, r.actuator, m.provisioner.ProvisionerOptions(
                solver=m.types.SolverOptions(backend="jax")), **dev(m))
        mgr = m.controllers.ControllerManager(
            r.cluster, leader=m.leader.AlwaysLeader().is_leader)
        ctrls = operator_controllers(m, r, prov)
        clock = FakeClock()
        ctrls[14].clock = clock
        for c in ctrls:
            mgr.register(c)
        for pod in m.pod.make_pods(40, name_prefix="w",
                                   requests=m.pod.ResourceRequests(
                                       1500, 3072, 0, 1)):
            r.cluster.add_pod(pod)
        plans = prov.provision_once()
        m.kubelet.FakeKubelet(r.cluster, r.cloud).join_pending(ready=True)
        mgr.sync()
        mid = world(r.cluster, r.cloud, r.unavail)
        for i in range(0, 40, 2):
            r.cluster.delete("pods", f"default/w-{i}")
        for _ in range(2):
            mgr.sync(rounds=1)
            clock.t += 31.0
        return ([c.name for c in ctrls], len(plans), mid,
                world(r.cluster, r.cloud, r.unavail))

    names, n_plans, mid, end = both(fixed_ids, with_rig(script))
    assert n_plans == 1 and mid["claims"]
    assert all(c[6] and c[7] for c in mid["claims"].values())
    assert "disruption" in names and "gang" in names
