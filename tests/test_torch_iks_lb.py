"""The port's IKS worker pools, provider factory, pool cleanup and load
balancers against the reference's, on the CPU.

Each case is a script of ``tests/test_iks_lb.py`` run once in each
package (``karpenter_tpu_torch/{cloud/fake_iks,cloud/loadbalancer,
core/workerpool,core/factory,controllers/iks,controllers/loadbalancer}.py``
beside ``karpenter_tpu/``): its outcome (pools, workers, instances,
claims, events, load-balancer members and records, errors raised) must
be the reference's, field for field with the creation times taken out.
Claim names of the VPC actuator come from ``uuid.uuid4``: the
``fixed_ids`` fixture swaps it for a counter, restarted before each
side.  The pool cleanup's TTL reads its module's clock, which the
scripts replace with a counter of their own.  The last case drives a
``Provisioner`` (``device="cpu"`` in the port) through
``ProviderFactory`` with ``IKS_CLUSTER_ID`` in the env it is given.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import threading
import types

import pytest

from tests.test_torch_controllers import own_state
from tests.test_torch_provisioner import fixed_ids  # noqa: F401 (fixture)

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")

_MODS = dict(
    nodeclass="apis.nodeclass", nodeclaim="apis.nodeclaim",
    pod="apis.pod", catalog="catalog", errors="cloud.errors",
    fake="cloud.fake", fake_iks="cloud.fake_iks", lb="cloud.loadbalancer",
    ctrl_iks="controllers.iks", ctrl_lb="controllers.loadbalancer",
    ctrl_claim="controllers.nodeclaim", core="core",
    bootstrap="core.bootstrap", factory="core.factory",
    kubelet="core.kubelet", workerpool="core.workerpool",
    provisioner="core.provisioner", types="solver.types")


def mods(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        pkg=pkg, torch=pkg.endswith("_torch"),
        **{k: importlib.import_module(f"{pkg}.{v}")
           for k, v in _MODS.items()})


SIDES = tuple(mods(p) for p in PKGS)


def both(ids, script):
    """``script(m)`` in each package with the id counters restarted,
    each on its own process state (``own_state``); the two outcomes must
    be equal."""
    outs = []
    for m in SIDES:
        ids.reset()
        with own_state(m.pkg):
            outs.append(script(m))
    assert outs[1] == outs[0]
    return outs[1]


def outcome(fn, *args, **kwargs):
    """("ok", value) or (error type, message, status) of one call."""
    try:
        return ("ok", fn(*args, **kwargs))
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, str(e), getattr(e, "status_code", None),
                getattr(e, "code", None))


def record(obj) -> tuple:
    d = dataclasses.asdict(obj)
    d.pop("created_at", None)
    return tuple(sorted((k, repr(v)) for k, v in d.items()))


def claim_view(c) -> tuple:
    return (c.name, c.nodeclass_name, c.nodepool_name, c.instance_type,
            c.zone, c.capacity_type, c.provider_id, c.hourly_price,
            tuple(sorted(c.annotations.items())),
            tuple(sorted(c.labels.items())), tuple(c.finalizers))


def world(r) -> dict:
    return {"pools": sorted(record(p) for p in r.iks.list_pools()),
            "workers": sorted(record(w) for w in r.iks.list_workers()),
            "instances": sorted((i.id, i.name, i.profile, i.zone,
                                 i.capacity_type, i.status)
                                for i in r.cloud.list_instances()),
            "claims": sorted(claim_view(c) for c in r.cluster.nodeclaims()),
            "events": [(e.kind, e.name, e.type, e.reason, e.message)
                       for e in r.cluster.events]}


def iks_nodeclass(m, name="iks", dynamic=True, **kw):
    """``tests/test_iks_lb.py::iks_nodeclass`` in package ``m``."""
    nc = m.nodeclass.NodeClass(name=name, spec=m.nodeclass.NodeClassSpec(
        region="us-south", image="img-1", instance_profile="bx2-4x16",
        bootstrap_mode="iks-api", iks_cluster_id="cls-1",
        iks_dynamic_pools=m.nodeclass.DynamicPoolConfig(
            enabled=dynamic, pool_name_prefix="kp",
            empty_pool_ttl_seconds=1) if dynamic else None, **kw))
    nc.status.resolved_image_id = "img-1"
    nc.status.set_condition("Ready", "True", "Validated")
    return nc


def vpc_nodeclass(m, name="v", **kw):
    return m.nodeclass.NodeClass(name=name, spec=m.nodeclass.NodeClassSpec(
        region="us-south", instance_profile="bx2-4x16", image="img-1", **kw))


def iks_rig(m) -> types.SimpleNamespace:
    """``tests/test_iks_lb.py::iks_rig`` in package ``m``."""
    cloud = m.fake.FakeCloud()
    iks = m.fake_iks.FakeIKS("cls-1", cloud)
    pricing = m.catalog.PricingProvider(cloud)
    itp = m.catalog.InstanceTypeProvider(cloud, pricing)
    cluster = m.core.ClusterState()
    actuator = m.workerpool.WorkerPoolActuator(
        iks, cluster, breaker=m.core.CircuitBreakerManager(
            m.core.CircuitBreakerConfig(rate_limit_per_minute=1000,
                                        max_concurrent_instances=1000)))
    catalog = m.catalog.CatalogArrays.build(itp.list())
    pricing.close()
    return types.SimpleNamespace(m=m, cloud=cloud, iks=iks, cluster=cluster,
                                 actuator=actuator, catalog=catalog)


def planned(m, catalog, profile="bx2-4x16", zone="us-south-1",
            cap="on-demand"):
    o = catalog.find_offering(profile, zone, cap)
    return m.types.PlannedNode(profile, zone, cap, price=0.2,
                               offering_index=o)


def create(r, nc, profile="bx2-4x16", zone="us-south-1"):
    return outcome(lambda: claim_view(r.actuator.create_node(
        planned(r.m, r.catalog, profile, zone), nc, r.catalog)))


class Clock:
    """The pool cleanup's clock: ``time()`` returns ``now``."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


@pytest.fixture
def clocks(monkeypatch):
    out = []
    for m in SIDES:
        clock = Clock()
        monkeypatch.setattr(m.ctrl_iks, "time", clock)
        out.append(clock)
    return dict(zip(PKGS, out))


# -- the worker-pool actuator -------------------------------------------------

@pytest.mark.parametrize("raw", [
    "kp-bx2-4x16", "KP_bx2.4x16!", "9starts-with-digit", "x" * 100, "---",
    "a-very-long-pool-prefix-name-bx2-8x32"])
def test_sanitize_pool_name_equals_reference(raw):
    names = [m.workerpool.sanitize_pool_name(raw) for m in SIDES]
    assert names[1] == names[0] and len(names[1]) <= 31


def test_dynamic_pool_create_and_increment_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        nc = r.cluster.add_nodeclass(iks_nodeclass(m))
        steps = [create(r, nc), create(r, nc),
                 create(r, nc, zone="us-south-2")]
        return steps, world(r)

    steps, w = both(fixed_ids, script)
    assert [s[0] for s in steps] == ["ok"] * 3
    assert len(w["pools"]) == 1 and len(w["workers"]) == 3


def test_static_pool_gating_and_pin_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        ops = r.iks.create_pool("ops-pool", "cx2-2x4", ["us-south-1"], 0)
        static = r.cluster.add_nodeclass(iks_nodeclass(m, "static",
                                                       dynamic=False))
        pinned = r.iks.create_pool("pinned", "bx2-4x16", ["us-south-1"], 0)
        nc = iks_nodeclass(m, "pinned")
        nc.spec.iks_worker_pool_id = pinned.id
        r.cluster.add_nodeclass(nc)
        return ([create(r, static, "cx2-2x4"), create(r, static, "mx2-2x16"),
                 create(r, nc)], ops.id, world(r))

    steps, _, _ = both(fixed_ids, script)
    assert steps[0][0] == "ok" and steps[1][0] == "CloudError"
    assert "dynamic pools disabled" in steps[1][1]


def test_delete_decrements_and_finalizes_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        nc = r.cluster.add_nodeclass(iks_nodeclass(m))
        claim = r.actuator.create_node(planned(m, r.catalog), nc, r.catalog)
        gone = outcome(r.actuator.delete_node, claim)
        bare = m.nodeclaim.NodeClaim(name="bare")
        return gone, outcome(r.actuator.delete_node, bare), world(r)

    gone, bare, w = both(fixed_ids, script)
    assert gone[0] == bare[0] == "NodeClaimNotFoundError"
    assert w["workers"] == [] and w["instances"] == []


def test_concurrent_increments_lose_no_worker():
    r = iks_rig(SIDES[1])
    pool = r.iks.create_pool("racy", "bx2-4x16", ["us-south-1"], 0)
    errs = []

    def inc():
        try:
            r.iks.increment_pool(pool.id, "us-south-1")
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=inc) for _ in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(r.iks.list_workers(pool.id)) == 16
    assert r.iks.get_pool(pool.id).size_per_zone == 16
    assert len({w.instance_id for w in r.iks.list_workers()}) == 16


def test_pool_name_collision_disambiguates_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        nc = iks_nodeclass(m, "long")
        nc.spec.iks_dynamic_pools = m.nodeclass.DynamicPoolConfig(
            enabled=True, pool_name_prefix="a-very-long-pool-prefix-name",
            empty_pool_ttl_seconds=600)
        r.cluster.add_nodeclass(nc)
        return [create(r, nc, "bx2-4x16"), create(r, nc, "bx2-8x32")], \
            world(r)

    _, w = both(fixed_ids, script)
    assert len(w["pools"]) == 2


def test_iks_bootstrap_provider_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        bp = m.bootstrap.IKSBootstrapProvider(r.iks)
        cfg = bp.cluster_config()
        subnet = r.cloud.list_subnets()[0]
        inst = r.cloud.create_instance(
            name="byo-node", profile="bx2-4x16", zone=subnet.zone,
            subnet_id=subnet.id, image_id=r.cloud.list_images()[0].id)
        worker = bp.register_instance(inst.id)
        states = [bp.worker_state(worker.id)]
        r.iks.deploy_worker(worker.id)
        states.append(bp.worker_state(worker.id))
        return record(cfg), record(worker), states, world(r)

    _, _, states, _ = both(fixed_ids, script)
    assert states == ["provisioning", "deployed"]


# -- the provider factory -----------------------------------------------------

def test_mode_selection_equals_reference():
    def modes(m):
        det = m.factory.determine_mode
        nc2 = vpc_nodeclass(m, "c", iks_cluster_id="cls-9")
        return [det(iks_nodeclass(m), env={}),
                det(vpc_nodeclass(m), env={}),
                det(vpc_nodeclass(m), env={"IKS_CLUSTER_ID": "c"}),
                det(nc2, env={}),
                det(vpc_nodeclass(m), env={"IKS_CLUSTER_ID": ""})]

    got = [modes(m) for m in SIDES]
    assert got[1] == got[0] == ["iks", "vpc", "iks", "iks", "vpc"]


def test_factory_routes_actuators_as_reference(fixed_ids):
    def script(m):
        r = iks_rig(m)
        vpc = m.core.Actuator(r.cloud, r.cluster)
        factory = m.factory.ProviderFactory(vpc, r.actuator, env={})
        bare = m.factory.ProviderFactory(vpc, None, env={})
        nc = r.cluster.add_nodeclass(iks_nodeclass(m))
        claim = r.actuator.create_node(planned(m, r.catalog), nc, r.catalog)
        plain = m.nodeclaim.NodeClaim(name="plain")
        routes = [factory.get_actuator(iks_nodeclass(m)),
                  factory.get_actuator(vpc_nodeclass(m)),
                  bare.get_actuator(iks_nodeclass(m)),
                  factory.get_actuator_for_claim(claim),
                  factory.get_actuator_for_claim(plain),
                  bare.get_actuator_for_claim(claim)]
        return ["iks" if a is r.actuator else "vpc" for a in routes]

    assert both(fixed_ids, script) == ["iks", "vpc", "vpc", "iks", "vpc",
                                       "vpc"]


# -- the pool cleanup ---------------------------------------------------------

def test_empty_dynamic_pool_reaped_after_ttl_as_reference(fixed_ids,
                                                          clocks):
    def script(m):
        clock = clocks[m.pkg]
        r = iks_rig(m)
        nc = r.cluster.add_nodeclass(iks_nodeclass(m))     # ttl 1 s
        claim = r.actuator.create_node(planned(m, r.catalog), nc, r.catalog)
        ctrl = m.ctrl_iks.PoolCleanupController(r.cluster, r.iks)
        pools = []
        ctrl.reconcile()
        pools.append(len(r.iks.list_pools()))
        outcome(r.actuator.delete_node, claim)
        ctrl.reconcile()                                   # starts the clock
        pools.append(len(r.iks.list_pools()))
        clock.now += 1.1
        ctrl.reconcile()
        pools.append(len(r.iks.list_pools()))
        return pools, world(r)

    pools, _ = both(fixed_ids, script)
    assert pools == [1, 1, 0]


@pytest.mark.parametrize("policy", ["Retain", "Delete"])
def test_static_retain_and_owner_policy_as_reference(fixed_ids, clocks,
                                                     policy):
    """A static pool is never reaped; a collision-renamed dynamic pool
    resolves its owner's policy by the ownership label."""
    def script(m):
        clock = clocks[m.pkg]
        r = iks_rig(m)
        r.iks.create_pool("admin", "bx2-4x16", ["us-south-1"], 0)
        nc = iks_nodeclass(m, "own")
        nc.spec.iks_dynamic_pools = m.nodeclass.DynamicPoolConfig(
            enabled=True, pool_name_prefix="a-very-long-pool-prefix-name",
            empty_pool_ttl_seconds=0, cleanup_policy=policy)
        r.cluster.add_nodeclass(nc)
        for profile in ("cx2-2x4", "bx2-8x32"):
            claim = r.actuator.create_node(planned(m, r.catalog, profile),
                                           nc, r.catalog)
            outcome(r.actuator.delete_node, claim)
        ctrl = m.ctrl_iks.PoolCleanupController(r.cluster, r.iks)
        ctrl.reconcile()
        clock.now += 0.05
        ctrl.reconcile()
        return world(r)

    w = both(fixed_ids, script)
    assert len(w["pools"]) == (3 if policy == "Retain" else 1)


# -- the load balancers -------------------------------------------------------

def lb_integration(m, **kw):
    n = m.nodeclass
    return n.LoadBalancerIntegration(enabled=True, target_groups=(
        n.LoadBalancerTarget(load_balancer_id="lb-1", pool_name="web",
                             port=443, health_check=n.HealthCheck(
                                 protocol="tcp", port=443)),), **kw)


def members(lbs, lb="lb-1", pool="web") -> list:
    p = lbs.pools.get((lb, pool))
    return [] if p is None else sorted(record(v) for v in p.members.values())


def test_integration_validation_equals_reference():
    def errors(m):
        n = m.nodeclass
        target = n.LoadBalancerTarget
        cases = [
            n.LoadBalancerIntegration(),
            n.LoadBalancerIntegration(enabled=True, target_groups=(
                target(load_balancer_id="", pool_name="", port=0,
                       weight=200),)),
            n.LoadBalancerIntegration(enabled=True, target_groups=(
                target(load_balancer_id="lb", pool_name="p", port=80,
                       health_check=n.HealthCheck(protocol="udp", interval=1,
                                                  timeout=5)),))]
        for hc in (n.HealthCheck(protocol="http"),
                   n.HealthCheck(protocol="http", path="health"),
                   n.HealthCheck(interval=10, timeout=10),
                   n.HealthCheck(protocol="https", path="/ok", retries=0)):
            cases.append(n.LoadBalancerIntegration(
                enabled=True, target_groups=(target(
                    load_balancer_id="lb", pool_name="p", port=80,
                    health_check=hc),)))
        return [m.lb.validate_integration(c) for c in cases]

    got = [errors(m) for m in SIDES]
    assert got[1] == got[0]
    assert got[1][0] == [] and len(got[1][1]) == 4


def test_register_wait_healthy_and_deregister_as_reference(fixed_ids):
    def script(m):
        lbs = m.lb.FakeLoadBalancers()
        provider = m.lb.LoadBalancerProvider(lbs)
        integ = lb_integration(m)
        steps = [len(provider.register_instance(integ, "10.0.0.5",
                                                wait_healthy=True))]
        pool = lbs.get_pool("lb-1", "web")
        steps.append((members(lbs), record(pool.health_monitor)))
        provider.register_instance(integ, "10.0.0.5")
        steps.append(members(lbs))
        steps.append(provider.deregister_instance(integ, "10.0.0.5"))
        steps.append(members(lbs))
        return steps

    steps = both(fixed_ids, script)
    assert steps[0] == 1 and steps[3] == 1 and steps[4] == []


def test_controller_registers_on_node_join_as_reference(fixed_ids):
    def script(m):
        cloud = m.fake.FakeCloud()
        pricing = m.catalog.PricingProvider(cloud)
        cluster = m.core.ClusterState()
        actuator = m.core.Actuator(cloud, cluster)
        nc = vpc_nodeclass(m, "lbnc",
                           load_balancer_integration=lb_integration(m))
        nc.status.resolved_image_id = "img-1"
        nc.status.set_condition("Ready", "True", "Validated")
        cluster.add_nodeclass(nc)
        catalog = m.catalog.CatalogArrays.build(
            m.catalog.InstanceTypeProvider(cloud, pricing).list())
        pricing.close()
        claim = actuator.create_node(planned(m, catalog), nc, catalog,
                                     nodepool_name="default")
        lbs = m.lb.FakeLoadBalancers()
        ctrl = m.ctrl_lb.LoadBalancerController(
            cluster, m.lb.LoadBalancerProvider(lbs))
        steps = [ctrl.reconcile(claim.name).requeue_after, members(lbs)]
        m.kubelet.FakeKubelet(cluster).join(claim, ready=True)
        m.ctrl_claim.RegistrationController(cluster).reconcile(claim.name)
        ctrl.reconcile(claim.name)
        steps.append((members(lbs), [record(x) for x in
                                     cluster.list("lbregistrations")]))
        cluster.delete("nodeclaims", claim.name)
        ctrl.reconcile(claim.name)
        steps.append((members(lbs), cluster.list("lbregistrations")))
        return steps, [(e.reason, e.message) for e in cluster.events]

    steps, _ = both(fixed_ids, script)
    assert steps[1] == [] and len(steps[2][0]) == 1 and steps[3] == ([], [])


def test_membership_sweep_and_failed_removal_as_reference(fixed_ids):
    """The sweep removes recorded members of dead claims only; a removal
    that fails keeps its record for the next sweep."""
    def script(m):
        cluster = m.core.ClusterState()
        lbs = m.lb.FakeLoadBalancers()
        provider = m.lb.LoadBalancerProvider(lbs)
        integ = lb_integration(m)
        reg = m.ctrl_lb.LBRegistration
        provider.register_instance(integ, "192.168.1.5")
        for name, addr in (("dead-claim", "10.0.0.77"),
                           ("live-claim", "10.0.0.88"),
                           ("c1", "10.0.0.50")):
            provider.register_instance(integ, addr)
            cluster.add("lbregistrations", name, reg(
                name=name, address=addr, targets=tuple(integ.target_groups)))
        cluster.add_nodeclaim(m.nodeclaim.NodeClaim(name="live-claim"))
        real = lbs.remove_member
        fail = {"on": True}

        def flaky(lb_id, pool_name, address):
            if fail["on"] and address == "10.0.0.50":
                raise m.errors.CloudError("lb api down", 503, retryable=True)
            return real(lb_id, pool_name, address)

        lbs.remove_member = flaky
        ctrl = m.ctrl_lb.LoadBalancerController(cluster, provider)
        sweeper = m.ctrl_lb.LBMembershipSweeper(cluster, provider)
        steps = [ctrl._deregister("c1").requeue_after]
        sweeper.reconcile()
        steps.append((members(lbs), sorted(
            r.name for r in cluster.list("lbregistrations"))))
        fail["on"] = False
        ctrl._deregister("c1")
        sweeper.reconcile()
        steps.append((members(lbs), sorted(
            r.name for r in cluster.list("lbregistrations"))))
        return steps

    steps = both(fixed_ids, script)
    assert steps[0] > 0 and steps[1][1] == ["c1", "live-claim"]
    assert steps[2][1] == ["live-claim"] and len(steps[2][0]) == 2


def test_termination_routes_iks_claims_through_pool_as_reference(
        fixed_ids):
    def script(m):
        r = iks_rig(m)
        vpc = m.core.Actuator(r.cloud, r.cluster)
        factory = m.factory.ProviderFactory(vpc, r.actuator, env={})
        nc = r.cluster.add_nodeclass(iks_nodeclass(m))
        claim = r.actuator.create_node(planned(m, r.catalog), nc, r.catalog)
        claim.deleted = True
        m.ctrl_claim.NodeClaimTerminationController(
            r.cluster, vpc, factory=factory).reconcile(claim.name)
        return world(r), r.cloud.recorder.call_count("delete_instance")

    w, _ = both(fixed_ids, script)
    assert w["claims"] == [] and w["workers"] == [] and w["instances"] == []


def test_health_check_patches_and_config_as_reference(fixed_ids):
    def script(m):
        n = m.nodeclass
        lbs = m.lb.FakeLoadBalancers()
        pool = lbs.ensure_pool("lb-1", "web")
        patches = []
        for hc in (n.HealthCheck(protocol="http", interval=30, timeout=5,
                                 retries=2, path="/healthz"),
                   n.HealthCheck(protocol="http", interval=30, timeout=5,
                                 retries=2, path="/healthz"),
                   n.HealthCheck(protocol="http", interval=60, timeout=5,
                                 retries=2, path="/healthz")):
            needs, patch = m.lb.build_health_check_patch(hc, pool)
            patches.append((needs, patch))
            if needs:
                lbs.update_pool("lb-1", "web", patch)
        provider = m.lb.LoadBalancerProvider(m.lb.FakeLoadBalancers())
        integ = lb_integration(m)
        provider.register_instance(integ, "10.0.0.9")
        again = provider.configure_health_check(integ.target_groups[0])
        return patches, again

    patches, again = both(fixed_ids, script)
    assert patches[0][0] and not patches[1][0] and patches[2][0]
    assert again is False


def test_member_states_and_instance_deregistration_as_reference(fixed_ids):
    def script(m):
        lbs = m.lb.FakeLoadBalancers(healthy_after=0.05)
        lbs.fault_address("10.0.0.66")
        provider = m.lb.LoadBalancerProvider(lbs)
        integ = lb_integration(m)
        ids = provider.register_instance(integ, "10.0.0.7")
        first = lbs.get_member("lb-1", "web", ids[0]).provisioning_status
        provider.wait_member_healthy("lb-1", "web", ids[0], timeout=2.0)
        member = lbs.get_member("lb-1", "web", ids[0])
        faulted = outcome(provider.register_instance, integ, "10.0.0.66",
                          wait_healthy=True, timeout=30.0)
        provider.register_instance(integ, "10.0.0.8", instance_id="inst-77")
        counts = [provider.deregister_instance(integ, "", instance_id=i)
                  for i in ("nope", "inst-77")]
        return (first in ("create_pending", "active"),
                (member.provisioning_status, member.health), faulted[0],
                faulted[3], counts)

    out = both(fixed_ids, script)
    assert out[1] == ("active", "ok") and out[3] == "member_faulted"
    assert out[4] == [0, 1]


def test_validate_configuration_as_reference():
    def errors(m):
        n = m.nodeclass
        lbs = m.lb.FakeLoadBalancers()
        lbs.create_load_balancer("lb-real")
        lbs.ensure_pool("lb-real", "web")
        provider = m.lb.LoadBalancerProvider(lbs)
        return [provider.validate_configuration(n.LoadBalancerIntegration(
            enabled=True, target_groups=(n.LoadBalancerTarget(
                load_balancer_id=lb, pool_name=pool, port=443),)))
            for lb, pool in (("lb-real", "web"), ("lb-ghost", "web"),
                             ("lb-real", "api"))]

    got = [errors(m) for m in SIDES]
    assert got[1] == got[0]
    assert got[1][0] == [] and got[1][1] and got[1][2]


# -- the provisioner through the factory --------------------------------------

def test_provisioner_through_the_factory_matches_reference(fixed_ids):
    """A window of 60 pods planned by each package's ``Provisioner``
    (the port's on the CPU) and actuated through ``ProviderFactory`` as
    IKS pool workers; then half the claims (the smallest pools' first)
    terminated through the factory and one pool cleanup tick."""
    def script(m):
        cloud = m.fake.FakeCloud()
        iks = m.fake_iks.FakeIKS("cls-1", cloud)
        pricing = m.catalog.PricingProvider(cloud)
        itp = m.catalog.InstanceTypeProvider(cloud, pricing)
        cluster = m.core.ClusterState()
        # a VPC NodeClass that the factory's env turns into IKS
        nc = vpc_nodeclass(m, "default", vpc="vpc-1",
                           iks_dynamic_pools=m.nodeclass.DynamicPoolConfig(
                               enabled=True, pool_name_prefix="kp",
                               empty_pool_ttl_seconds=0))
        nc.status.resolved_image_id = "img-1"
        nc.status.set_condition("Ready", "True", "Validated")
        cluster.add_nodeclass(nc)
        breaker = m.core.CircuitBreakerManager(m.core.CircuitBreakerConfig(
            rate_limit_per_minute=100_000, max_concurrent_instances=100_000))
        vpc = m.core.Actuator(cloud, cluster, breaker=breaker)
        pools = m.workerpool.WorkerPoolActuator(iks, cluster,
                                                breaker=breaker)
        factory = m.factory.ProviderFactory(
            vpc, pools, env={"IKS_CLUSTER_ID": "cls-1"})
        prov = m.provisioner.Provisioner(
            cluster, itp, vpc, m.provisioner.ProvisionerOptions(),
            factory=factory, **({"device": "cpu"} if m.torch else {}))
        try:
            for i in range(60):
                cluster.add_pod(m.pod.PodSpec(
                    f"p{i}", requests=m.pod.ResourceRequests(
                        250 * (1 + i % 4), 512 * (1 + i % 3), 0, 1)))
            plans = prov.provision_once()
        finally:
            prov.stop()
            pricing.close()
        r = types.SimpleNamespace(iks=iks, cloud=cloud, cluster=cluster)
        before = world(r)
        term = m.ctrl_claim.NodeClaimTerminationController(cluster, vpc,
                                                           factory=factory)
        pool_of = {c.name: c.annotations[m.workerpool.ANNOTATION_POOL_ID]
                   for c in cluster.nodeclaims()}
        size = collections.Counter(pool_of.values())
        claims = sorted(cluster.nodeclaims(), key=lambda c: (
            size[pool_of[c.name]], pool_of[c.name], c.name))
        for c in claims[:len(claims) // 2]:       # the smallest pools first
            c.deleted = True
            term.reconcile(c.name)
        m.ctrl_iks.PoolCleanupController(cluster, iks).reconcile()
        nominated = sorted((p.spec.name, p.nominated_node)
                           for p in cluster.list("pods"))
        return ([[(n.instance_type, n.zone, n.pod_names)
                  for n in p.nodes] for p in plans], before, world(r),
                nominated)

    plans, before, after, _ = both(fixed_ids, script)
    assert plans[0] and len(before["workers"]) == len(plans[0])
    assert len(after["workers"]) < len(before["workers"])
    assert len(after["pools"]) < len(before["pools"])
