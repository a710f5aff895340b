"""The port's actuation layer against the reference's, on the CPU.

``core/{actuator,bootstrap,cloudinit,kubelet,drift,cloudprovider}.py``
and ``cloud/{image,subnet}.py`` of ``karpenter_tpu_torch`` are copies of
the reference's modules.  Each test runs one call script through both
packages on a fresh fake cloud and compares what comes out: claims,
instances, staged resources left behind, events, call counts, user data
and the drift verdicts.  Claim names and bootstrap tokens come from the
``fixed_ids`` counters (``tests/test_torch_provisioner.py``).
"""

from __future__ import annotations

import dataclasses

import pytest

from test_torch_provisioner import (  # noqa: F401 — fixtures
    SIDES, claims_by_pods, cloud_calls, events, fixed_ids, make_rig,
    ready_nodeclass, run_both, rigs,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def catalog_of(r):
    return r.m.arrays.CatalogArrays.build(r.itp.list())


def planned(r, cat, pods=("p",), itype="bx2-4x16", zone="us-south-1",
            ct="on-demand", price=0.19):
    return r.m.types.PlannedNode(
        instance_type=itype, zone=zone, capacity_type=ct, price=price,
        pod_names=list(pods), offering_index=cat.find_offering(itype, zone,
                                                               ct))


def leftovers(r):
    return {"vnis": sorted(r.cloud.vnis), "volumes": sorted(r.cloud.volumes),
            "instances": sorted((i.id, i.name, i.profile, i.zone,
                                 i.capacity_type, i.vni_id,
                                 tuple(i.volume_ids), i.user_data,
                                 tuple(sorted(i.tags.items())))
                                for i in r.cloud.list_instances()),
            "calls": cloud_calls(r), "events": events(r),
            "claims": claims_by_pods(r)}


def both(rigs_, script, **kw):
    a, b = run_both(rigs_(provisioner=False, **kw), script)
    assert a == b
    return a


# -- the actuator -------------------------------------------------------------

def test_create_and_delete_node(rigs):
    def script(r):
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        claim = r.actuator.create_node(planned(r, cat, ("p1",)), nc, cat)
        assert claim.provider_id.startswith("tpu:///us-south/")
        inst = r.cloud.list_instances()[0]
        assert inst.tags["karpenter.sh/managed"] == "true"
        assert "#cloud-config" in inst.user_data
        made = leftovers(r)
        with pytest.raises(r.m.errors.NodeClaimNotFoundError):
            r.actuator.delete_node(claim)
        assert r.cloud.instance_count() == 0
        return made, leftovers(r)

    both(rigs, script)


@pytest.mark.parametrize("case", ["not_ready", "capacity", "quota",
                                  "unknown_provider_id"])
def test_create_gates_and_blackouts(rigs, case):
    """The Ready gate, the zonal capacity blackout, the regional quota
    blackout of the type in every zone, and a delete of an unknown id."""
    def script(r):
        m = r.m
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        err = None
        if case == "not_ready":
            nc = ready_nodeclass(m, "unready")
            nc.status.set_condition("Ready", "False", "ValidationFailed")
            with pytest.raises(m.errors.CloudError, match="not ready") as ei:
                r.actuator.create_node(planned(r, cat), nc, cat)
            err = str(ei.value)
        elif case == "capacity":
            r.cloud.capacity_limits[("bx2-4x16", "us-south-1")] = 0
            with pytest.raises(m.errors.CloudError) as ei:
                r.actuator.create_node(planned(r, cat, ct="spot"), nc, cat)
            err = str(ei.value)
        elif case == "quota":
            r.cloud.recorder.inject_error("create_instance", m.errors.
                                          CloudError("quota", 403,
                                                     code="quota_exceeded",
                                                     retryable=False))
            with pytest.raises(m.errors.CloudError) as ei:
                r.actuator.create_node(planned(r, cat), nc, cat)
            err = str(ei.value)
        else:
            with pytest.raises(m.errors.NodeClaimNotFoundError):
                r.actuator.delete_node(m.nodeclaim.NodeClaim(
                    name="ghost", provider_id="bogus"))
        return err, sorted(r.actuator.unavailable.unavailable_keys()), \
            leftovers(r)

    err, dark, _ = both(rigs, script)
    if case == "capacity":
        assert dark == ["bx2-4x16:us-south-1:spot"]
    if case == "quota":
        assert len(dark) == 3


STAGES = ["vni_fails", "volume_fails", "instance_fails", "cleanup_fails",
          "success"]


@pytest.mark.parametrize("stage", STAGES)
def test_partial_failure_cleanup(rigs, stage):
    """``TestPartialFailureCleanup``: a failure at each stage of the staged
    create (VNI, the second volume, the instance, the instance with the
    VNI's cleanup failing too) leaks nothing but what the reference
    leaks; a clean create attaches every staged resource and its delete
    reclaims them."""
    def script(r):
        m = r.m
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        nc.spec.block_device_mappings = (
            m.nodeclass.BlockDeviceMapping(volume=m.nodeclass.VolumeSpec(
                capacity_gb=200)),
            m.nodeclass.BlockDeviceMapping(volume=m.nodeclass.VolumeSpec(
                capacity_gb=50)))
        capacity = m.errors.CloudError("insufficient capacity", 503,
                                       code="insufficient_capacity",
                                       retryable=False)
        if stage == "vni_fails":
            r.cloud.recorder.inject_error("create_vni",
                                          m.errors.CloudError("boom", 500))
        elif stage == "volume_fails":
            orig, calls = r.cloud.create_volume, []

            def flaky(*a, **k):
                calls.append(1)
                if len(calls) == 2:
                    raise m.errors.CloudError("volume quota", 403,
                                              code="quota_exceeded",
                                              retryable=False)
                return orig(*a, **k)
            r.cloud.create_volume = flaky
        elif stage in ("instance_fails", "cleanup_fails"):
            r.cloud.recorder.inject_error("create_instance", capacity)
            if stage == "cleanup_fails":
                r.cloud.recorder.inject_error(
                    "delete_vni", m.errors.CloudError("hiccup", 500))
        if stage == "success":
            claim = r.actuator.create_node(planned(r, cat), nc, cat)
            inst = r.cloud.list_instances()[0]
            assert inst.vni_id in r.cloud.vnis and len(inst.volume_ids) == 2
            made = leftovers(r)
            with pytest.raises(m.errors.NodeClaimNotFoundError):
                r.actuator.delete_node(claim)
            assert not r.cloud.vnis and not r.cloud.volumes
            return made, leftovers(r)
        with pytest.raises(m.errors.CloudError) as ei:
            r.actuator.create_node(planned(r, cat), nc, cat)
        out = leftovers(r)
        assert not out["volumes"] and not out["instances"]
        assert bool(out["vnis"]) == (stage == "cleanup_fails")
        return str(ei.value), out

    both(rigs, script)


def test_execute_plan_aligns_claims_with_failures(rigs):
    """``execute_plan``: claims positionally aligned with the plan's
    nodes, None where a create failed; errors listed."""
    def script(r):
        m = r.m
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        r.actuator.breaker = m.breaker.CircuitBreakerManager(
            m.breaker.CircuitBreakerConfig(
                failure_threshold=10000, rate_limit_per_minute=100000,
                max_concurrent_instances=100000))
        nodes = [planned(r, cat, (f"p{i}",), itype=t, zone=z)
                 for i, (t, z) in enumerate((
                     ("bx2-4x16", "us-south-1"), ("bx2-4x16", "us-south-2"),
                     ("cx2-2x4", "us-south-3")))]
        r.cloud.capacity_limits[("bx2-4x16", "us-south-2")] = 0
        plan = m.types.Plan(nodes=nodes, backend="test")
        claims, errors = r.actuator.execute_plan(plan, nc, cat, "default")
        return [c.name if c else None for c in claims], errors, leftovers(r)

    names, errors, _ = both(rigs, script)
    assert names[1] is None and None not in (names[0], names[2])
    assert len(errors) == 1


def test_subnet_resolution(rigs):
    """The actuator's subnet order: ``spec.subnet``, then the status's
    selected subnets in the plan's zone, then the best subnet there."""
    def script(r):
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        r.actuator.breaker = r.m.breaker.CircuitBreakerManager(
            r.m.breaker.CircuitBreakerConfig(rate_limit_per_minute=100))
        got = []
        for mode in ("best", "selected", "spec_subnet"):
            if mode == "spec_subnet":
                nc.spec.subnet = "subnet-32"
            elif mode == "selected":
                nc.status.selected_subnets = ["subnet-11", "subnet-32"]
            got.append(r.actuator.create_node(
                planned(r, cat, zone="us-south-3"), nc, cat).subnet_id)
        return got, leftovers(r)

    sids, _ = both(rigs, script)
    assert sids[1:] == ["subnet-32", "subnet-32"] and sids[0]


# -- image and subnet providers ----------------------------------------------

IMAGE_CASES = [{"image": "img-1"}, {"image": "ubuntu-22-04-amd64"},
               {"os": "ubuntu", "architecture": "amd64"},
               {"os": "ubuntu", "architecture": "arm64"}, {"os": "windows"}]


def test_image_resolver():
    """By id, by name, the newest of a selector, an architecture filter
    and a selector nothing matches."""
    out = []
    for m in SIDES:
        cloud = m.fake.FakeCloud()
        r = m.image.ImageResolver(cloud)
        got = []
        for kw in IMAGE_CASES:
            try:
                if "image" in kw:
                    iid = r.resolve(image=kw["image"])
                else:
                    iid = r.resolve(selector=m.nodeclass.ImageSelector(**kw))
                got.append((iid, cloud.images[iid].name))
            except m.errors.CloudError as e:
                got.append(("error", str(e)))
        out.append((got, m.image.parse_image_name("ubuntu-24-04-amd64"),
                    m.image.parse_image_name("weird")))
    assert out[0] == out[1]
    assert [g[0] == "error" for g in out[0][0]] == [False] * 4 + [True]


SUBNET_CASES = ["Balanced", "AvailabilityFirst", "CostOptimized", "min_ips",
                "cluster_aware", "none_eligible"]


def test_subnet_provider():
    """Each placement strategy, the free-IP floor, the cluster-awareness
    bonus and no eligible subnet; the scores and the best per zone."""
    out = []
    for m in SIDES:
        got = []
        for case in SUBNET_CASES:
            cloud = m.fake.FakeCloud(subnets_per_zone=2)
            fn = (lambda: {"subnet-12": 3}) if case == "cluster_aware" \
                else None
            prov = m.subnet.SubnetProvider(cloud, cluster_subnets_fn=fn)
            strat = m.nodeclass.PlacementStrategy
            if case == "min_ips":
                cloud.subnets["subnet-11"].available_ips = 3
                st = strat(zone_balance="AvailabilityFirst",
                           subnet_selection=m.nodeclass.
                           SubnetSelectionCriteria(minimum_available_ips=10))
            elif case in ("cluster_aware", "none_eligible"):
                st = strat(zone_balance="Balanced")
                if case == "none_eligible":
                    for s in cloud.subnets.values():
                        s.state = "pending"
            else:
                st = strat(zone_balance=case)
            try:
                sel = [(s.id, s.zone) for s in prov.select_subnets(st)]
            except ValueError as e:
                sel = str(e)
            best = prov.best_subnet_in_zone("us-south-2")
            got.append((sel, best.id if best else None,
                        [round(m.subnet.subnet_score(s), 9)
                         for s in prov.list_subnets()]))
        out.append(got)
    assert out[0] == out[1]
    assert [len(g[0]) for g in out[0][:3]] == [3, 6, 2]


# -- bootstrap and cloud-init -------------------------------------------------

def test_token_reuse_and_expiry(fixed_ids):
    out = []
    for m in SIDES:
        fixed_ids.reset()
        clock = FakeClock()
        ts = m.bootstrap.TokenStore(clock=clock)
        t1, t2 = ts.find_or_create(), ts.find_or_create()
        clock.t = 19 * 3600
        t3 = ts.find_or_create()
        clock.t = 25 * 3600
        out.append((t1.token, t2.token, t3.token, ts.cleanup_expired(),
                    [t.token for t in ts.live_tokens()]))
    assert out[0] == out[1]
    assert out[0][0] == out[0][1] != out[0][2]


USERDATA_CASES = ["generated", "custom", "append", "endpoint", "arm_cilium",
                  "kubelet_env"]


@pytest.mark.parametrize("case", USERDATA_CASES)
def test_user_data(fixed_ids, case):
    """``BootstrapProvider.user_data`` (tokens fixed) and the cloud-init
    document behind it, byte for byte."""
    out = []
    for m in SIDES:
        fixed_ids.reset()
        spec = dict(region="us-south")
        if case == "custom":
            spec["user_data"] = "#!/bin/sh\necho custom"
        if case in ("custom", "append"):
            spec["user_data_append"] = "echo extra"
        if case == "endpoint":
            spec["api_server_endpoint"] = "https://10.9.9.9:6443"
        if case == "kubelet_env":
            spec["kubelet"] = m.nodeclass.KubeletConfig(
                max_pods=58, system_reserved=(("cpu", "100m"),),
                eviction_hard=(("memory.available", "100Mi"),),
                cluster_dns=("10.96.0.10",))
        nc = m.nodeclass.NodeClass(name="default",
                                   spec=m.nodeclass.NodeClassSpec(**spec))
        cluster = m.bootstrap.ClusterConfig()
        arch = "amd64"
        if case == "arm_cilium":
            cluster = dataclasses.replace(cluster, cni_plugin="cilium",
                                          cni_version="1.16")
            arch = "arm64"
        env = m.cloudinit.BootstrapEnv(
            http_proxy="http://proxy:3128", extra=(("CUSTOM_FLAG", "42"),)) \
            if case == "kubelet_env" else None
        bp = m.bootstrap.BootstrapProvider(env=env)
        ud = bp.user_data(nc, m.bootstrap.BootstrapOptions(
            cluster=cluster, node_name="n1", instance_type="bx2-4x16",
            architecture=arch, labels={"x": "y"},
            taints=(m.pod.Taint("k", "v", "NoSchedule"),)))
        cni = m.cloudinit.cni_install_commands(cluster)
        out.append((ud, cni))
    assert out[0] == out[1]
    ud = out[0][0]
    assert ud.startswith("#!/bin/sh") == (case == "custom")
    assert ("echo extra" in ud) == (case in ("custom", "append"))


class FakeIKSClient:
    """The two calls ``IKSBootstrapProvider`` makes, by duck typing."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.registered = []

    def get_cluster_config(self):
        return dict(self.cfg)

    def register_worker(self, instance_id, pool_id=""):
        self.registered.append((instance_id, pool_id))
        return {"id": f"worker-{instance_id}", "pool": pool_id}

    def get_worker(self, worker_id):
        class W:
            state = "deployed"
        return W()


def test_iks_bootstrap_provider():
    out = []
    full = {"api_endpoint": "https://iks:6443", "kube_version": "1.31.2",
            "ca_bundle": "Q0E="}
    for m in SIDES:
        ok = m.bootstrap.IKSBootstrapProvider(FakeIKSClient(full))
        cfg = ok.cluster_config()
        reg = ok.register_instance("inst-1", "pool-a")
        bad = m.bootstrap.IKSBootstrapProvider(FakeIKSClient(
            {"api_endpoint": "https://iks:6443"}))
        with pytest.raises(m.errors.CloudError, match="incomplete") as ei:
            bad.cluster_config()
        out.append((dataclasses.astuple(cfg), reg, ok.worker_state("w"),
                    str(ei.value), ok.iks.registered))
    assert out[0] == out[1]


# -- the kubelet, drift and the cloud provider --------------------------------

def test_kubelet_join_and_bind(rigs):
    """``FakeKubelet.join_pending`` materializes each launched claim's
    node with the bootstrap taints; pods nominated onto ready nodes
    bind."""
    def script(r):
        m = r.m
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        for i in range(3):
            r.cluster.add_pod(m.pod.PodSpec(f"p{i}"))
        claims = [r.actuator.create_node(planned(r, cat, (f"default/p{i}",),
                                                 ct="spot"), nc, cat)
                  for i in range(2)]
        for i, c in enumerate(claims):
            r.cluster.get("pods", f"default/p{i}").nominated_node = c.name
        kubelet = m.kubelet.FakeKubelet(r.cluster, r.cloud)
        joined = kubelet.join_pending()
        bound0 = [p.bound_node for p in r.cluster.list("pods")]
        kubelet.mark_ready(claims[0].name)
        kubelet.mark_condition(claims[1].name, "DiskPressure", "True",
                               since=5.0)
        n = kubelet.bind_nominated()
        again = kubelet.join_pending()
        return ([(j.name, j.provider_id, [(t.key, t.effect)
                                          for t in j.taints], j.ready)
                 for j in joined], bound0, n,
                [p.bound_node for p in r.cluster.list("pods")],
                [(x.name, x.ready, dict(x.conditions), dict(x.annotations))
                 for x in r.cluster.nodes()], len(again))

    out = both(rigs, script)
    assert out[2] == 1 and out[5] == 0


DRIFTS = ["none", "nodeclass_deleted", "hash_version", "hash", "image",
          "subnet", "security_groups"]


@pytest.mark.parametrize("case", DRIFTS)
def test_drift_and_cloud_provider(rigs, case):
    """The six drift checks in the reference's order, through
    ``CloudProvider.is_drifted``, beside ``get`` / ``list`` / ``delete``,
    the filtered instance types and the repair policies."""
    def script(r):
        m = r.m
        cat = catalog_of(r)
        nc = r.cluster.get_nodeclass("default")
        nc.status.selected_subnets = ["subnet-11"]
        nc.status.resolved_security_groups = ["sg-1"]
        cp = m.cloudprovider.CloudProvider(r.cluster, r.actuator, r.itp)
        claim = cp.create(planned(r, cat), nc, cat)
        assert claim.subnet_id == "subnet-11"
        claim.annotations[m.nodeclass.ANNOTATION_SECURITY_GROUPS] = "sg-1"
        if case == "nodeclass_deleted":
            r.cluster.delete("nodeclasses", "default")
        elif case == "hash_version":
            claim.annotations[
                m.nodeclass.ANNOTATION_NODECLASS_HASH_VERSION] = "v0"
        elif case == "hash":
            nc.spec.user_data_append = "echo changed"
        elif case == "image":
            nc.status.resolved_image_id = "img-2"
        elif case == "subnet":
            nc.status.selected_subnets = ["subnet-12"]
        elif case == "security_groups":
            nc.status.resolved_security_groups = ["sg-9"]
        reason = cp.is_drifted(claim)
        got = cp.get(claim.provider_id)
        listed = [c.name for c in cp.list()]
        nc.status.selected_instance_types = ["bx2-4x16", "cx2-2x4"]
        types_ = [t.name for t in cp.get_instance_types(nc)]
        with pytest.raises(m.errors.NodeClaimNotFoundError):
            cp.delete(claim)
        with pytest.raises(m.errors.NodeClaimNotFoundError):
            cp.get(claim.provider_id)
        return (reason, got.name, listed, types_, cp.name(),
                cp.get_supported_node_classes(),
                [dataclasses.astuple(p) for p in cp.repair_policies()],
                leftovers(r))

    out = both(rigs, script)
    want = {"none": "", "nodeclass_deleted": "NodeClassDeleted",
            "hash_version": "NodeClassHashVersionDrifted",
            "hash": "NodeClassHashDrifted", "image": "ImageDrifted",
            "subnet": "SubnetDrifted",
            "security_groups": "SecurityGroupsDrifted"}[case]
    assert out[0] == want
