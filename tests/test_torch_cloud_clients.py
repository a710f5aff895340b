"""The port's HTTP cloud layer against the reference's, on the CPU.

``karpenter_tpu_torch/cloud/{http,vpc,iks,stub,client_manager}.py`` speak
the reference's wire: every case starts a ``StubCloudServer`` of each
package on 127.0.0.1 (port 0), over a ``FakeCloud`` and ``FakeIKS`` of
its own package, and runs one script of ``tests/test_cloud_clients.py``
through ``VPCCloudClient`` / ``IKSClient`` in all four pairings (each
package's client against each package's stub).  The four outcomes
(records with their creation times taken out, errors with their type,
status, code and retry flag) must be equal.  The last cases provision
a window over HTTP: the port's ``Provisioner(device="cpu")`` through its
client and stub against the reference's through its own, claims and
instances equal.
"""

from __future__ import annotations

import dataclasses
import importlib
import threading
import types

import pytest

from tests.test_torch_controllers import own_state
from tests.test_torch_provisioner import SIDES as RIG_SIDES
from tests.test_torch_provisioner import (  # noqa: F401 (fixture)
    claims_by_pods, fixed_ids, make_rig, permissive_breaker, plans_equal,
)

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")
API_KEY = "contract-key"

_MODS = dict(
    errors="cloud.errors", fake="cloud.fake", fake_iks="cloud.fake_iks",
    iks="cloud.iks", stub="cloud.stub", vpc="cloud.vpc", http="cloud.http",
    manager="cloud.client_manager", nodeclass="apis.nodeclass",
    pod="apis.pod", catalog="catalog", core="core",
    bootstrap="core.bootstrap", workerpool="core.workerpool",
    types="solver.types")


def mods(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        pkg=pkg, torch=pkg.endswith("_torch"),
        **{k: importlib.import_module(f"{pkg}.{v}")
           for k, v in _MODS.items()})


SIDES = tuple(mods(p) for p in PKGS)
PAIRS = [(c, s) for c in SIDES for s in SIDES]


class Wire(types.SimpleNamespace):
    """One pairing: ``client`` (``VPCCloudClient``) and ``iks``
    (``IKSClient``) of package ``cm`` against ``server`` of package
    ``sm`` over ``fake`` / ``fake_iks``."""


def start(sm, cm, sleep=None) -> Wire:
    fake = sm.fake.FakeCloud(profiles=sm.fake.generate_profiles(8),
                             instance_quota=50)
    fake_iks = sm.fake_iks.FakeIKS("cluster-1", fake)
    server = sm.stub.StubCloudServer(cloud=fake, iks=fake_iks,
                                     api_key=API_KEY).start()
    sleeps = []
    client = cm.vpc.VPCCloudClient(server.endpoint, API_KEY,
                                   sleep=sleep or sleeps.append)
    iks = cm.iks.IKSClient(server.endpoint, "cluster-1", api_key=API_KEY,
                           sleep=sleeps.append)
    return Wire(cm=cm, sm=sm, fake=fake, fake_iks=fake_iks, server=server,
                client=client, iks=iks, sleeps=sleeps)


def over_all_pairs(script) -> object:
    """``script(wire)`` in each of the four pairings, each on a fresh
    stub; the outcomes must be equal."""
    outs = []
    for cm, sm in PAIRS:
        wire = start(sm, cm)
        try:
            outs.append(script(wire))
        finally:
            wire.server.stop()
    for (cm, sm), out in zip(PAIRS, outs):
        assert out == outs[0], f"client {cm.pkg} over stub {sm.pkg}"
    return outs[0]


def view(obj):
    """A record as plain data, its clock fields taken out."""
    if dataclasses.is_dataclass(obj):
        return tuple(sorted(
            (k, view(v)) for k, v in dataclasses.asdict(obj).items()
            if not k.endswith("_at")))
    if isinstance(obj, (list, tuple)):
        return tuple(view(v) for v in obj)
    if isinstance(obj, dict):
        return tuple(sorted((k, view(v)) for k, v in obj.items()
                            if not k.endswith("_at")))
    return obj


def outcome(fn, *args, **kwargs):
    try:
        return ("ok", view(fn(*args, **kwargs)))
    except Exception as e:  # noqa: BLE001
        return (type(e).__name__, getattr(e, "status_code", None),
                getattr(e, "code", None), getattr(e, "retryable", None),
                str(e))


def create(w, name, **kw):
    args = dict(name=name, profile="bx2-2x8", zone="us-south-1",
                subnet_id="subnet-11", image_id="img-1")
    args.update(kw)
    return w.client.create_instance(**args)


# -- the VPC client -----------------------------------------------------------

def test_catalog_surface_over_the_wire():
    def script(w):
        profiles = w.client.list_instance_profiles()
        return (w.client.list_zones(), view(profiles),
                [w.client.get_pricing(p.name) for p in profiles],
                view(w.client.list_subnets()), view(w.client.list_images()),
                w.client.get_default_security_group(),
                view(w.client.get_subnet("subnet-21")))

    zones, profiles, prices, subnets, *_ = over_all_pairs(script)
    assert zones == ["us-south-1", "us-south-2", "us-south-3"]
    assert len(profiles) == 8 and all(p > 0 for p in prices)
    assert len(subnets) == 6


def test_instance_lifecycle_over_the_wire():
    def script(w):
        inst = create(w, "contract-a", tags={"karpenter.sh/managed": "true"},
                      user_data="#cloud-config")
        steps = [view(inst), outcome(w.client.get_instance, inst.id),
                 [i.id for i in w.client.list_instances()]]
        w.client.update_tags(inst.id, {"extra": "1"})
        steps.append(w.client.get_instance(inst.id).tags)
        spot = create(w, "contract-spot", capacity_type="spot")
        steps.append([i.id for i in w.client.list_spot_instances()])
        w.client.delete_instance(inst.id)
        steps.append(outcome(w.client.get_instance, inst.id))
        steps.append(outcome(w.client.delete_instance, spot.id))
        return steps

    steps = over_all_pairs(script)
    assert steps[3] == {"karpenter.sh/managed": "true", "extra": "1"}
    assert steps[5][0] == "CloudError" and steps[5][1] == 404


def test_error_taxonomy_and_quota_over_the_wire():
    def script(w):
        steps = [outcome(create, w, "x", zone="nope-1"),
                 outcome(create, w, "x", subnet_id="subnet-21"),
                 w.client.quota_status()]
        w.fake.instance_quota = w.client.quota_status()[0]
        steps.append(outcome(create, w, "q"))
        w.fake.instance_quota = 50
        steps.append(outcome(w.client.get_instance, "inst-missing"))
        steps.append(outcome(w.client.http.get, "/v1/nope", "nope"))
        return steps

    steps = over_all_pairs(script)
    assert steps[0][1] == 404 and steps[1][1] == 400
    assert steps[3][0] == "CloudError" and steps[3][3] is False
    assert steps[5][1] == 404


def test_orphan_cleanup_ops_over_the_wire():
    def script(w):
        inst = create(w, "orphan")
        vni, vols = inst.vni_id, inst.volume_ids
        w.fake.instances.pop(inst.id)
        steps = [outcome(w.client.delete_vni, vni)]
        steps += [outcome(w.client.delete_volume, v) for v in vols]
        steps.append((vni in w.fake.vnis, [v in w.fake.volumes
                                           for v in vols]))
        steps.append(outcome(w.client.delete_vni, vni))
        return steps

    steps = over_all_pairs(script)
    assert steps[-2][0] is False and not any(steps[-2][1])
    assert steps[0][0] == "ok"


def test_retry_after_and_reauth_over_the_wire():
    """A 429 is retried after its Retry-After; a revoked token 401s once
    and the next call re-authenticates."""
    def script(w):
        w.fake.recorder.inject_error(
            "list_subnets", w.sm.errors.CloudError("slow down", 429,
                                                   retry_after=2.0))
        steps = [len(w.client.list_subnets()),
                 any(s >= 2.0 for s in w.sleeps)]
        assert w.client.list_zones()
        w.server.revoke_all_tokens()
        steps.append(outcome(w.client.list_zones))
        steps.append(outcome(w.client.list_zones))
        w.server.revoke_all_tokens()
        w.client.tokens.invalidate()
        steps.append(outcome(w.client.list_zones))
        return steps

    steps = over_all_pairs(script)
    assert steps[:2] == [6, True]
    assert steps[2][0] == "CloudError" and steps[2][1] == 401
    assert steps[3][0] == steps[4][0] == "ok"


def test_client_manager_caches_and_refreshes_on_auth():
    """The TTL cache and the drop of the cached client on an auth error,
    on a clock of the test's own."""
    def script(m):
        built, now = [], [0.0]

        def build():
            built.append(len(built))
            return f"client-{len(built)}"

        def flaky(client):
            raise m.errors.CloudError("token expired", 401)

        mgr = m.manager.ClientManager(build, ttl=10.0, clock=lambda: now[0])
        steps = [mgr.get(), mgr.get()]
        now[0] = 11.0
        steps.append(mgr.get())
        steps.append(mgr.call(lambda c: c + "!"))
        steps.append(outcome(mgr.call, flaky, "list"))
        steps.append(mgr.get())
        mgr.invalidate()
        steps += [mgr.get(), len(built)]
        return steps

    got = [script(m) for m in SIDES]
    assert got[1] == got[0]
    assert got[1][:3] == ["client-1", "client-1", "client-2"]


# -- the IKS client -----------------------------------------------------------

def test_pool_crud_and_resize_over_the_wire():
    def script(w):
        pool = w.iks.create_pool(name="pool-a", flavor="bx2-2x8",
                                 zones=["us-south-1"], size_per_zone=1,
                                 dynamic=True)
        steps = [view(pool), view(w.iks.get_pool(pool.id)),
                 view(w.iks.get_pool_by_name(pool.name)),
                 w.iks.get_pool_by_name("none"),
                 [p.id for p in w.iks.list_pools()]]
        w.iks.add_pool_zone(pool.id, "us-south-2")
        steps.append(w.iks.get_pool(pool.id).zones)
        worker = w.iks.increment_pool(pool.id, "us-south-2")
        steps += [view(worker), w.iks.worker_instance_id(worker.id),
                  view(w.iks.list_workers(pool.id)),
                  view(w.iks.get_worker(worker.id))]
        w.iks.decrement_pool(pool.id, worker.id)
        steps += [view(w.iks.list_workers(pool.id)),
                  outcome(w.iks.get_worker, worker.id),
                  outcome(w.iks.get_pool, "pool-missing"),
                  w.iks.get_cluster_config()]
        return steps

    steps = over_all_pairs(script)
    assert steps[-2][1] == 404 and steps[-1]["cluster_id"] == "cluster-1"


def test_concurrent_increments_over_the_wire():
    def script(w):
        pool = w.iks.create_pool(name="race", flavor="bx2-2x8",
                                 zones=["us-south-1"], size_per_zone=0)
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            w.iks.increment_pool(pool.id, "us-south-1"))) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return (len(w.iks.list_workers(pool.id)), len({r.id for r in results}),
                w.iks.get_pool(pool.id).size_per_zone)

    assert over_all_pairs(script) == (8, 8, 8)


def test_iks_api_bootstrap_over_the_wire():
    def script(w):
        bp = w.cm.bootstrap.IKSBootstrapProvider(w.iks)
        cfg = bp.cluster_config()
        inst = w.fake.create_instance(
            name="iksapi-bp", profile="bx2-2x8", zone="us-south-1",
            subnet_id="subnet-11", image_id="img-1")
        worker = bp.register_instance(inst.id)
        states = [bp.worker_state(worker.id)]
        w.fake_iks.deploy_worker(worker.id)
        states.append(bp.worker_state(worker.id))
        return view(cfg), view(worker), states

    _, _, states = over_all_pairs(script)
    assert states == ["provisioning", "deployed"]


def test_workerpool_actuator_over_the_wire(fixed_ids):
    def script(w):
        m = w.cm
        pricing = m.catalog.PricingProvider(w.client)
        catalog = m.catalog.CatalogArrays.build(
            m.catalog.InstanceTypeProvider(w.client, pricing).list())
        pricing.close()
        cluster = m.core.ClusterState()
        actuator = m.workerpool.WorkerPoolActuator(
            w.iks, cluster, breaker=m.core.CircuitBreakerManager(
                m.core.CircuitBreakerConfig(rate_limit_per_minute=1000,
                                            max_concurrent_instances=1000)))
        nc = cluster.add_nodeclass(m.nodeclass.NodeClass(
            name="iks-contract", spec=m.nodeclass.NodeClassSpec(
                region="us-south", instance_profile="bx2-2x8", image="img-1",
                bootstrap_mode="iks-api", iks_cluster_id=w.iks.cluster_id,
                iks_dynamic_pools=m.nodeclass.DynamicPoolConfig(
                    enabled=True))))
        nc.status.set_condition("Ready", "True", "Validated")
        off = catalog.find_offering("bx2-2x8", "us-south-1", "on-demand")
        node = m.types.PlannedNode(
            instance_type="bx2-2x8", zone="us-south-1",
            capacity_type="on-demand", price=0.1, pod_names=["default/p0"],
            offering_index=off)
        claim = actuator.create_node(node, nc, catalog)
        steps = [claim.name, dict(claim.annotations), claim.provider_id,
                 view(w.iks.list_pools())]
        steps.append(outcome(actuator.delete_node, claim))
        steps.append(view(w.iks.list_workers()))
        steps.append(sorted(i.name for i in w.fake.list_instances()))
        return steps

    steps = over_all_pairs(script)
    assert steps[4][0] == "NodeClaimNotFoundError" and steps[5] == ()


# -- provisioning over HTTP ---------------------------------------------------

def provision_over_http(m, ids, n_pods):
    """A window of ``n_pods`` planned and actuated by the provisioning
    rig of ``tests/test_torch_provisioner.py`` over HTTP: (plans, claims
    by pod set, instances on the stub's cloud, cloud calls by method)."""
    fake = m.fake.FakeCloud()
    stub = importlib.import_module(f"{m.pkg}.cloud.stub")
    vpc = importlib.import_module(f"{m.pkg}.cloud.vpc")
    server = stub.StubCloudServer(cloud=fake, api_key=API_KEY).start()
    client = vpc.VPCCloudClient(server.endpoint, API_KEY,
                                  region=fake.region, sleep=lambda s: None)
    rig = make_rig(m, cloud=client)
    try:
        rig.actuator.breaker = permissive_breaker(m)
        rig.ids = ids
        for i in range(n_pods):
            rig.cluster.add_pod(m.pod.PodSpec(
                f"h{i}", requests=m.pod.ResourceRequests(
                    250 * (1 + i % 4), 512 * (1 + i % 3), 0, 1)))
        plans = rig.prov.provision_once()
        return (plans, claims_by_pods(rig),
                sorted((i.name, i.profile, i.zone, i.capacity_type,
                        i.subnet_id, i.image_id, len(i.volume_ids),
                        tuple(sorted(i.tags.items())))
                       for i in fake.list_instances()),
                {k: len(v) for k, v in fake.recorder.calls.items()})
    finally:
        rig.close()
        server.stop()


@pytest.mark.parametrize("n_pods", [40, 200])
def test_provisioner_over_http_matches_reference(fixed_ids, n_pods):
    outs = []
    for m in RIG_SIDES:
        fixed_ids.reset()
        # a spot risk model left by an earlier test in the worker would
        # rank one package's offerings apart from the other's
        with own_state(m.pkg):
            outs.append(provision_over_http(m, fixed_ids, n_pods))
    (jplans, jclaims, jinst, jcalls), (tplans, tclaims, tinst, tcalls) = outs
    plans_equal(tplans, jplans)
    assert tclaims == jclaims
    assert tinst == jinst and len(tinst) == sum(len(p.nodes)
                                                for p in tplans) > 0
    assert tcalls == jcalls
