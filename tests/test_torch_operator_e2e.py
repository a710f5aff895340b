"""The port's operator end to end against the reference's, on the CPU.

The twelve scripts of ``tests/test_e2e_scenarios.py`` (the reference's
e2e scenario files on the simulated cluster and the fake cloud) run on
each package's ``Operator`` with the full controller fleet live, the
port's with ``device="cpu"``; so does the operator over HTTP
(``tests/test_cloud_clients.py::TestOperatorOverHTTP``) and both
command lines' ``main()``.  The operators run their own threads, so
outcomes are compared rather than call sequences: claims by the pods
nominated onto them (offering, pool, state), the instances' images and
volumes, the NodeClass statuses, events.  The first window of each
script fires at its pod count (``KARPENTER_WINDOW_MAX_PODS``) with an
idle long enough that no stall of the host splits it; later windows
(re-pended pods) fire on the idle.

The reference's ``python -m karpenter_tpu`` counts only the pods still
pending when it reports nominations, so once the kubelet has bound
every pod it prints ``0/N`` and exits 1; the port counts bound pods
too (their nomination stays), prints ``N/N`` and exits 0.  Every other
line of the two summaries is equal.
"""

from __future__ import annotations

import importlib
import json
import sys
import time

import pytest

from test_torch_controllers import own_state
from test_torch_operator import OSIDES, PKGS, odev
from test_torch_operator import backend as backend_name
from test_torch_provisioner import fixed_ids  # noqa: F401 — fixture

ENV = {
    "TPU_CLOUD_REGION": "us-south",
    "TPU_CLOUD_API_KEY": "k3y",
    "KARPENTER_WINDOW_IDLE_SECONDS": "2.0",
    "KARPENTER_WINDOW_MAX_SECONDS": "10.0",
    "CIRCUIT_BREAKER_RATE_LIMIT_PER_MINUTE": "10000",
    "CIRCUIT_BREAKER_MAX_CONCURRENT_INSTANCES": "10000",
}


def default_nodeclass(m, **spec):
    spec = {"region": "us-south", "image": "img-1", "vpc": "vpc-1",
            "instance_requirements": m.nodeclass.InstanceRequirements(
                min_cpu=2),
            "placement_strategy": m.nodeclass.PlacementStrategy(), **spec}
    return m.nodeclass.NodeClass(name="default",
                                 spec=m.nodeclass.NodeClassSpec(**spec))


def boot(m, pods: int, nodeclass=None, env=None, pools=(), retry_s=None):
    """``tests/test_e2e_scenarios.py::boot`` for package ``m``, its first
    window firing at ``pods``.  ``retry_s`` shortens the provisioner's
    retry ticker (15 s), which re-windows the pods of a replaced claim,
    and the disruption controller's poll (10 s), which replaces a
    drifted one."""
    env = {**ENV, "KARPENTER_WINDOW_MAX_PODS": str(pods), **(env or {})}
    op = m.operator.Operator(
        m.options.Options.from_env(env),
        credential_provider=m.credentials.EnvCredentialProvider(ENV),
        **odev(m))
    op.cluster.add_nodeclass(nodeclass or default_nodeclass(m))
    for pool in pools:
        op.cluster.add_nodepool(pool)
    if retry_s is not None:
        op.provisioner.options.retry_interval = retry_s
        for c in op.manager._poll:
            if isinstance(c, m.disruption.DisruptionController):
                c.interval = retry_s
    op.start()
    return op, m.kubelet.FakeKubelet(op.cluster, op.cloud)


def settle(op, kubelet, timeout=30.0, want=None):
    """``tests/test_e2e_scenarios.py::settle``."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        kubelet.join_pending(ready=True)
        if want is not None:
            if want():
                return True
        else:
            pending = [p for p in op.cluster.pending_pods()
                       if not p.nominated_node]
            claims = op.cluster.nodeclaims()
            if not pending and claims and all(c.initialized for c in claims):
                return True
        time.sleep(0.05)
    return False


def claims_view(op, live_only=False) -> list:
    """The claims by the pods nominated onto them: offering, pool,
    taints, state."""
    pods: dict = {}
    for p in op.cluster.list("pods"):
        if p.nominated_node:
            pods.setdefault(p.nominated_node, []).append(p.spec.name)
    return sorted(
        (tuple(sorted(pods.get(c.name, ()))), c.instance_type, c.zone,
         c.capacity_type, c.nodepool_name,
         tuple(sorted(t.key for t in c.taints)), c.launched, c.registered,
         c.initialized, c.deleted)
        for c in op.cluster.nodeclaims() if not (live_only and c.deleted))


def make_pods(m, n, prefix="pod", cpu=500, mem=1024):
    return m.pod.make_pods(n, name_prefix=prefix,
                           requests=m.pod.ResourceRequests(cpu, mem, 0, 1))


# -- the scripts --------------------------------------------------------------

def basic_workflow(m):
    op, kubelet = boot(m, 40)
    try:
        for pod in make_pods(m, 40):
            op.cluster.add_pod(pod)
        assert settle(op, kubelet)
        claims = op.cluster.nodeclaims()
        assert claims and all(c.launched and c.registered for c in claims)
        assert op.cloud.instance_count() == len(claims)
        provisioned = claims_view(op)
        for p in op.cluster.list("pods"):
            op.cluster.delete("pods", f"{p.spec.namespace}/{p.spec.name}")
        ctrl = next(c for c in op.manager._poll
                    if isinstance(c, m.disruption.DisruptionController))
        ctrl.reconcile()
        stamped = not any(c.deleted for c in op.cluster.nodeclaims())
        for c in op.cluster.nodeclaims():
            ann = c.annotations.get(ctrl.EMPTY_SINCE_ANNOTATION)
            assert ann is not None
            c.annotations[ctrl.EMPTY_SINCE_ANNOTATION] = repr(
                float(ann) - 3600)
        ctrl.reconcile()
        return provisioned, stamped, all(c.deleted
                                         for c in op.cluster.nodeclaims())
    finally:
        op.stop()


def drift(m):
    op, kubelet = boot(m, 10, retry_s=1.0)
    try:
        for pod in make_pods(m, 10):
            op.cluster.add_pod(pod)
        assert settle(op, kubelet)
        before = {c.name for c in op.cluster.nodeclaims()}
        provisioned = claims_view(op)
        nc = op.cluster.get_nodeclass("default")
        nc.spec.image = "img-2"
        op.cluster.update("nodeclasses", nc.name, nc)

        def replaced():
            kubelet.join_pending(ready=True)
            claims = [c for c in op.cluster.nodeclaims() if not c.deleted]
            return (claims and not (before & {c.name for c in claims})
                    and all(c.initialized for c in claims)
                    and not [p for p in op.cluster.pending_pods()
                             if not p.nominated_node])
        assert settle(op, kubelet, want=replaced)
        images = sorted(i.image_id for i in op.cloud.list_instances())
        return provisioned, images
    finally:
        op.stop()


def multizone(m):
    op, kubelet = boot(m, 30)
    try:
        for i in range(30):
            op.cluster.add_pod(m.pod.PodSpec(
                f"mz-{i}", requests=m.pod.ResourceRequests(1000, 2048, 0, 1),
                topology_spread=(m.pod.TopologySpreadConstraint(
                    max_skew=1),)))
        assert settle(op, kubelet)
        per_zone: dict = {}
        for c in op.cluster.nodeclaims():
            pods = [p for p in op.cluster.list("pods")
                    if p.nominated_node == c.name
                    or p.bound_node == c.node_name]
            per_zone[c.zone] = per_zone.get(c.zone, 0) + len(pods)
        assert len(per_zone) >= 2
        assert max(per_zone.values()) - min(per_zone.values()) <= 1
        return claims_view(op), per_zone
    finally:
        op.stop()


def scheduling(m):
    req = m.requirements
    op, kubelet = boot(m, 12)
    try:
        for i in range(6):
            op.cluster.add_pod(m.pod.PodSpec(
                f"zoned-{i}", requests=m.pod.ResourceRequests(500, 1024, 0, 1),
                node_selector=((req.LABEL_ZONE, "us-south-2"),)))
        for i in range(6):
            op.cluster.add_pod(m.pod.PodSpec(
                f"od-{i}", requests=m.pod.ResourceRequests(500, 1024, 0, 1),
                required_requirements=(req.Requirement(
                    req.LABEL_CAPACITY_TYPE, req.Operator.IN,
                    ("on-demand",)),)))
        assert settle(op, kubelet)
        claims = {c.name: c for c in op.cluster.nodeclaims()}
        for p in op.cluster.list("pods"):
            claim = claims[p.nominated_node]
            if p.spec.name.startswith("zoned-"):
                assert claim.zone == "us-south-2"
            else:
                assert claim.capacity_type == "on-demand"
        return claims_view(op)
    finally:
        op.stop()


def taints(m):
    pool = m.nodeclaim.NodePool(
        name="tainted", nodeclass_name="default",
        taints=(m.pod.Taint("dedicated", "gpu", "NoSchedule"),))
    op, kubelet = boot(m, 2, pools=[pool])
    try:
        op.cluster.add_pod(m.pod.PodSpec(
            "tolerant", requests=m.pod.ResourceRequests(500, 1024, 0, 1),
            tolerations=(m.pod.Toleration("dedicated", "Equal", "gpu",
                                          "NoSchedule"),)))
        op.cluster.add_pod(m.pod.PodSpec(
            "intolerant", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))

        def tolerant_placed():
            # the claim's state is part of the view: wait for it to be
            # initialized, as the other scripts' settles do
            p = op.cluster.get("pods", "default/tolerant")
            if p is None or not p.nominated_node:
                return False
            claim = op.cluster.get_nodeclaim(p.nominated_node)
            return claim is not None and claim.initialized
        assert settle(op, kubelet, want=tolerant_placed)
        assert not op.cluster.get("pods", "default/intolerant").nominated_node
        claim = op.cluster.get_nodeclaim(
            op.cluster.get("pods", "default/tolerant").nominated_node)
        assert any(t.key == "dedicated" for t in claim.taints)
        return claims_view(op)
    finally:
        op.stop()


def block_devices(m):
    nc = default_nodeclass(m, block_device_mappings=[
        m.nodeclass.BlockDeviceMapping(
            root_volume=True, volume=m.nodeclass.VolumeSpec(
                capacity_gb=250, profile="10iops-tier")),
        m.nodeclass.BlockDeviceMapping(
            root_volume=False, volume=m.nodeclass.VolumeSpec(
                capacity_gb=500, profile="general-purpose"))])
    op, kubelet = boot(m, 1, nodeclass=nc)
    try:
        op.cluster.add_pod(m.pod.PodSpec(
            "bd-0", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
        assert settle(op, kubelet)
        inst = list(op.cloud.instances.values())[0]
        vols = [op.cloud.volumes[v] for v in inst.volume_ids]
        assert sorted(v.capacity_gb for v in vols) == [250, 500]
        return claims_view(op), sorted((v.capacity_gb, v.profile)
                                       for v in vols)
    finally:
        op.stop()


def image_selector(m):
    nc = m.nodeclass.NodeClass(name="default", spec=m.nodeclass.NodeClassSpec(
        region="us-south", vpc="vpc-1",
        instance_requirements=m.nodeclass.InstanceRequirements(min_cpu=2),
        image_selector=m.nodeclass.ImageSelector(
            os="ubuntu", major_version="24", architecture="amd64")))
    op, kubelet = boot(m, 1, nodeclass=nc)
    try:
        def resolved():
            return bool(op.cluster.get_nodeclass("default")
                        .status.resolved_image_id)
        assert settle(op, kubelet, want=resolved, timeout=10)
        op.cluster.add_pod(m.pod.PodSpec(
            "img-0", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
        assert settle(op, kubelet)
        resolved_id = op.cluster.get_nodeclass("default") \
            .status.resolved_image_id
        inst = list(op.cloud.instances.values())[0]
        assert inst.image_id == resolved_id
        return claims_view(op), resolved_id
    finally:
        op.stop()


def instance_requirements(m):
    nc = default_nodeclass(m, instance_requirements=(
        m.nodeclass.InstanceRequirements(min_cpu=4, min_memory_gib=8,
                                         max_hourly_price=2.0)))
    op, kubelet = boot(m, 1, nodeclass=nc)
    try:
        def selected():
            return bool(op.cluster.get_nodeclass("default")
                        .status.selected_instance_types)
        assert settle(op, kubelet, want=selected, timeout=10)
        sel = sorted(op.cluster.get_nodeclass("default")
                     .status.selected_instance_types)
        op.cluster.add_pod(m.pod.PodSpec(
            "ip-0", requests=m.pod.ResourceRequests(2000, 4096, 0, 1)))
        assert settle(op, kubelet)
        assert all(c.instance_type in sel for c in op.cluster.nodeclaims())
        return claims_view(op), sel
    finally:
        op.stop()


def latency_envelope(m):
    op, kubelet = boot(m, 100)
    try:
        t0 = time.time()
        for pod in make_pods(m, 100, prefix="lat"):
            op.cluster.add_pod(pod)
        assert settle(op, kubelet)
        assert time.time() - t0 < 20.0
        assert not [p for p in op.cluster.pending_pods()
                    if not p.nominated_node]
        return claims_view(op)
    finally:
        op.stop()


def spot_preemption(m):
    req = m.requirements
    op, kubelet = boot(m, 1, retry_s=1.0)
    try:
        op.cluster.add_pod(m.pod.PodSpec(
            "spotty", requests=m.pod.ResourceRequests(500, 1024, 0, 1),
            required_requirements=(req.Requirement(
                req.LABEL_CAPACITY_TYPE, req.Operator.IN, ("spot",)),)))
        assert settle(op, kubelet)
        claim = op.cluster.nodeclaims()[0]
        assert claim.capacity_type == "spot"
        first = claims_view(op)
        op.cloud.preempt_spot_instance(
            m.nodeclaim.parse_provider_id(claim.provider_id)[1])
        ctrl = [c for c in op.manager._poll
                if isinstance(c, m.faults.SpotPreemptionController)][0]
        ctrl.reconcile()
        assert op.unavailable.is_unavailable(claim.instance_type, claim.zone,
                                             "spot")

        def replaced_live():
            live = [c for c in op.cluster.nodeclaims() if not c.deleted]
            return bool(live and live[0].name != claim.name
                        and live[0].initialized)
        assert settle(op, kubelet, want=replaced_live)
        return first, claims_view(op, live_only=True)
    finally:
        op.stop()


def custom_config(m):
    op, kubelet = boot(m, 1, env={"KARPENTER_SPOT_DISCOUNT_PERCENT": "10"})
    try:
        assert op.options.spot_discount_percent == 10
        t = op.instance_types.list()[0]
        spot = [o for o in t.offerings if o.capacity_type == "spot"]
        ondemand = [o for o in t.offerings if o.capacity_type == "on-demand"]
        assert spot[0].price == pytest.approx(ondemand[0].price * 0.10,
                                              rel=1e-3)
        return t.name, sorted((o.zone, o.capacity_type, o.price)
                              for o in t.offerings)
    finally:
        op.stop()


def interruption(m):
    op, kubelet = boot(m, 1)
    try:
        op.cluster.add_pod(m.pod.PodSpec(
            "w", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
        assert settle(op, kubelet)
        claim = op.cluster.nodeclaims()[0]
        first = claims_view(op)
        op.cloud.degrade_instance(
            m.nodeclaim.parse_provider_id(claim.provider_id)[1], "faulted")
        ctrl = [c for c in op.manager._poll
                if isinstance(c, m.faults.InterruptionController)][0]
        ctrl.reconcile()
        fresh = op.cluster.get_nodeclaim(claim.name)
        assert fresh is None or fresh.deleted
        node = op.cluster.get_node(claim.node_name)
        if node is not None:
            assert node.annotations.get("karpenter-tpu.sh/interrupted") == \
                "health:metadata:faulted"
        ev = [e.reason for e in op.cluster.events_for("Node",
                                                      claim.node_name)]
        assert "Interrupted" in ev
        return first
    finally:
        op.stop()


SCRIPTS = (basic_workflow, drift, multizone, scheduling, taints,
           block_devices, image_selector, instance_requirements,
           latency_envelope, spot_preemption, custom_config, interruption)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda f: f.__name__)
def test_e2e_scenario_matches_reference(script, fixed_ids):
    """One script of ``tests/test_e2e_scenarios.py`` on each package's
    live operator: the reference's assertions on each, and the two
    outcomes equal."""
    outs = []
    for pkg, m in zip(PKGS, OSIDES):
        fixed_ids.reset()
        with own_state(pkg):
            outs.append(script(m))
    assert outs[0] == outs[1]


# -- the operator over HTTP ---------------------------------------------------

def test_operator_over_http_matches_reference(fixed_ids):
    """``TestOperatorOverHTTP``: ``TPU_CLOUD_ENDPOINT`` selects the HTTP
    client; 20 pods provisioned through the wire, one claim deleted
    through it."""
    def script(m):
        stub = importlib.import_module(f"{m.pkg}.cloud.stub")
        vpc = importlib.import_module(f"{m.pkg}.cloud.vpc")
        fake = m.fake.FakeCloud(profiles=m.fake.generate_profiles(8))
        server = stub.StubCloudServer(cloud=fake, api_key="k3y").start()
        try:
            op, kubelet = boot(m, 20, env={
                "TPU_CLOUD_ENDPOINT": server.endpoint})
            try:
                assert isinstance(op.cloud, vpc.VPCCloudClient)
                for pod in make_pods(m, 20):
                    op.cluster.add_pod(pod)
                assert settle(op, kubelet)
                claims = op.cluster.nodeclaims()
                assert fake.instance_count() == len(claims)
                view = claims_view(op)
                victim = claims[0]
                try:
                    op.actuator.delete_node(victim)
                except m.errors.NodeClaimNotFoundError:
                    pass
                return (view, fake.instance_count(),
                        fake.recorder.call_count("create_instance"))
            finally:
                op.stop()
        finally:
            server.stop()

    outs = []
    for pkg, m in zip(PKGS, OSIDES):
        fixed_ids.reset()
        with own_state(pkg):
            outs.append(script(m))
    assert outs[0] == outs[1]
    view, left, creates = outs[1]
    assert left == len(view) - 1 and creates >= len(view)


# -- the command lines --------------------------------------------------------

CLI_ENV = {**ENV, "TPU_CLOUD_API_KEY": "simulated",
           "KARPENTER_WINDOW_MAX_PODS": "40",
           "CIRCUIT_BREAKER_RATE_LIMIT_PER_MINUTE": "1000",
           "CIRCUIT_BREAKER_MAX_CONCURRENT_INSTANCES": "1000"}


def test_simulation_cli_matches_reference(monkeypatch, capsys, fixed_ids):
    """``python -m karpenter_tpu_torch --pods 40 --device cpu`` against
    ``python -m karpenter_tpu --pods 40``, in process: the same summary
    but the nominated count (see the module docstring)."""
    outs = []
    for pkg, m in zip(PKGS, OSIDES):
        for k, v in CLI_ENV.items():
            monkeypatch.setenv(k, v)
        monkeypatch.setenv("KARPENTER_SOLVER_BACKEND",
                           "torch" if m.torch else "jax")
        cli = importlib.import_module(f"{pkg}.__main__")
        argv = ["prog", "--pods", "40", "--seconds", "30"]
        # the summary's window count reads the process's
        # SOLVE_DURATION{backend}, which earlier tests moved
        before = m.metrics.SOLVE_DURATION.count(backend_name(m))
        fixed_ids.reset()
        with own_state(pkg):
            if m.torch:
                rc = cli.main(argv[1:] + ["--device", "cpu"])
            else:
                monkeypatch.setattr(sys, "argv", argv)
                rc = cli.main()
        lines = capsys.readouterr().out.splitlines()
        label, count = lines[-1].split(":")
        lines[-1] = f"{label}: {int(count) - before}"
        outs.append((rc, lines))
    (rc_ref, ref), (rc_port, port) = outs
    assert rc_ref == 1 and ref[0] == "pods nominated: 0/40"
    assert rc_port == 0 and port[0] == "pods nominated: 40/40"
    assert port[1:] == ref[1:] and len(port) == 5


@pytest.mark.parametrize("fmt", ["chrome", "jsonl"])
def test_obs_export_cli_matches_reference(fmt, tmp_path, fixed_ids):
    """``python -m karpenter_tpu_torch.obs export --device cpu``: the demo
    cycle's trace holds the reference's spans (names and kinds)."""
    outs = []
    for pkg, m in zip(PKGS, OSIDES):
        cli = importlib.import_module(f"{pkg}.obs.__main__")
        out = tmp_path / f"{pkg}.{fmt}"
        argv = ["export", "--format", fmt, "-o", str(out)]
        fixed_ids.reset()
        with own_state(pkg):
            assert cli.main(argv + (["--device", "cpu"] if m.torch
                                    else [])) == 0
        text = out.read_text()
        if fmt == "chrome":
            events = json.loads(text)["traceEvents"]
            outs.append(sorted({(e["name"], e["ph"]) for e in events}))
        else:
            outs.append(sorted(json.loads(line)["name"]
                               for line in text.splitlines() if line))
    assert outs[0] == outs[1]
    names = {n[0] if isinstance(n, tuple) else n for n in outs[1]}
    assert {"pod.event", "provision.cycle", "solve", "actuate.create",
            "rpc.create_instance"} <= names


def test_obs_export_cli_needs_the_card_by_default(monkeypatch, tmp_path):
    """Without ``--device`` the demo's provisioner resolves the card and
    raises without one; ``--input`` converts a dump with no device."""
    import torch

    from karpenter_tpu_torch.obs import __main__ as cli
    from karpenter_tpu_torch.obs import export

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["export", "-o", str(tmp_path / "x.json")])
    dump = tmp_path / "spans.jsonl"
    export.dump_jsonl([{"trace_id": 1, "span_id": 1, "parent_id": 0,
                        "name": "solve", "start_us": 0.0, "dur_us": 5.0,
                        "status": "ok", "attrs": {}}], dump)
    assert cli.main(["export", "--input", str(dump), "-o",
                     str(tmp_path / "y.json")]) == 0
    doc = json.loads((tmp_path / "y.json").read_text())
    assert "solve" in {e["name"] for e in doc["traceEvents"]}
