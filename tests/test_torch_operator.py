"""The port's operator against the reference's, on the CPU.

``karpenter_tpu_torch/operator/{options,credentials,operator}.py`` run
the scripts of the reference's own tests (``tests/test_operator.py``,
``test_warmup.py::test_operator_boot_runs_warmup``,
``test_recovery.py::TestOperatorDrain``,
``test_leaderelection.py::TestOperatorFailover``) once per package, the
port's ``Operator`` with ``device="cpu"``; the outcomes are compared:
the options field for field, the credentials, the controller list in
order, the catalog, the ``statusz`` keys, the recovery reports.

The backend is the one place the two packages differ by design: the
reference's default and valid backend ``jax`` is the port's ``torch``
(``make_solver`` builds ``TorchSolver`` for any other name, so
``Options.validate`` is what refuses a stale ``jax``).  Each package's
run gets fresh process state (``test_torch_controllers.own_state``) and
every operator a test starts is stopped.
"""

from __future__ import annotations

import base64
import dataclasses
import importlib
import os
import time
import types

import pytest
import torch

from test_torch_controllers import cmods, own_state
from test_torch_provisioner import PKGS, fixed_ids  # noqa: F401 — fixture

BASE_ENV = {"TPU_CLOUD_REGION": "us-south", "TPU_CLOUD_API_KEY": "k3y"}

_OMODS = dict(
    operator="operator", op_mod="operator.operator",
    options="operator.options", credentials="operator.credentials",
    server="operator.server", fake_iks="cloud.fake_iks",
    workerpool="core.workerpool", read_journal="recovery.journal",
    requirements="apis.requirements")


def omods(pkg: str) -> types.SimpleNamespace:
    """``test_torch_controllers.cmods`` plus the operator's modules."""
    m = cmods(pkg)
    for k, v in _OMODS.items():
        setattr(m, k, importlib.import_module(f"{pkg}.{v}"))
    return m


OSIDES = tuple(omods(p) for p in PKGS)


def odev(m) -> dict:
    """The port's operator on the CPU."""
    return {"device": "cpu"} if m.torch else {}


def backend(m) -> str:
    return "torch" if m.torch else "jax"


def each(script, ids=None):
    """``script(m)`` once per package on its own process state (and the
    id counters restarted when given); the two outcomes."""
    outs = []
    for pkg, m in zip(PKGS, OSIDES):
        if ids is not None:
            ids.reset()
        with own_state(pkg):
            outs.append(script(m))
    return outs


def same(script, ids=None):
    a, b = each(script, ids)
    assert a == b
    return a


def operator(m, env=None, **kw):
    env = {**BASE_ENV, **(env or {})}
    kw.setdefault("credential_provider",
                  m.credentials.EnvCredentialProvider(env))
    return m.operator.Operator(m.options.Options.from_env(env), **kw,
                               **odev(m))


def ready_nodeclass(m, cluster, **spec):
    """``tests/test_recovery.py::ready_nodeclass`` for package ``m``."""
    spec = {"region": "us-south", "image": "img-1", "vpc": "vpc-1",
            "instance_requirements": m.nodeclass.InstanceRequirements(
                min_cpu=2),
            "placement_strategy": m.nodeclass.PlacementStrategy(), **spec}
    nc = m.nodeclass.NodeClass(name="default",
                               spec=m.nodeclass.NodeClassSpec(**spec))
    nc.status.resolved_image_id = "img-1"
    nc.status.set_condition("Ready", "True", "Test")
    cluster.add_nodeclass(nc)
    return nc


def wait_until(pred, deadline_s=20.0, poll_s=0.05) -> bool:
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(poll_s)
    return pred()


# -- options ------------------------------------------------------------------

def options_view(opts) -> dict:
    d = dataclasses.asdict(opts)
    d["solver"].pop("use_pallas", None)      # the reference's Pallas switch
    if d["solver"]["backend"] == "jax":
        d["solver"]["backend"] = "torch"
    return d


def errors_view(errs) -> list:
    """The validation messages with the backend message's tail (the
    port's names the valid backends) cut."""
    return [e.split(" (one of")[0] for e in errs]


ENVS = {
    "base": BASE_ENV,
    "empty": {},
    "layered": {**BASE_ENV, "KARPENTER_SPOT_DISCOUNT_PERCENT": "40",
                "KARPENTER_ENABLE_ORPHAN_CLEANUP": "true",
                "KARPENTER_ENABLE_INTERRUPTION": "false",
                "KARPENTER_SOLVER_BACKEND": "greedy",
                "KARPENTER_WINDOW_IDLE_SECONDS": "0.5",
                "CIRCUIT_BREAKER_FAILURE_THRESHOLD": "7",
                "IKS_CLUSTER_ID": "cls-42"},
    "planes": {**BASE_ENV, "KARPENTER_ENABLE_PREEMPTION": "1",
               "KARPENTER_ENABLE_GANG": "yes",
               "KARPENTER_ENABLE_WHATIF": "on",
               "KARPENTER_ENABLE_RESIDENT": "true",
               "KARPENTER_ENABLE_SERVING": "1",
               "KARPENTER_ENABLE_SHARDED": "1", "KARPENTER_SHARDS": "4",
               "KARPENTER_ENABLE_REPACK": "1",
               "KARPENTER_REPACK_MIN_SAVINGS_PERCENT": "20",
               "KARPENTER_LEADER_ELECTION": "true", "POD_NAME": "op-0",
               "KARPENTER_JOURNAL_DIR": "/var/journal",
               "KARPENTER_TPU_COMPILE_CACHE": "/var/cache",
               "KARPENTER_TPU_WARMUP": "false"},
    "bad": {"TPU_CLOUD_API_KEY": "k", "TPU_CLOUD_ZONE": "eu-de-1",
            "KARPENTER_SPOT_DISCOUNT_PERCENT": "150",
            "KARPENTER_SOLVER_BACKEND": "remote",
            "KARPENTER_WEBHOOK_PORT": "8443",
            "KARPENTER_WINDOW_IDLE_SECONDS": "0",
            "KARPENTER_WINDOW_MAX_PODS": "0"},
    "garbled": {**BASE_ENV, "KARPENTER_SPOT_DISCOUNT_PERCENT": "lots",
                "KARPENTER_METRICS_PORT": "x", "IBMCLOUD_REGION": "eu-de",
                "KARPENTER_WINDOW_MAX_SECONDS": "soon"},
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_options_from_env_and_validate_match_reference(name):
    """``Options.from_env`` field for field and ``validate`` message for
    message, the reference's backend ``jax`` read as ``torch``."""
    ref, port = (m.options.Options.from_env(ENVS[name]) for m in OSIDES)
    assert options_view(port) == options_view(ref)
    assert errors_view(port.validate()) == errors_view(ref.validate())


def test_backend_names_map_jax_to_torch():
    """The default backend is ``torch``; ``validate`` refuses ``jax`` (the
    reference's name) and names the valid ones, and accepts ``torch``
    where the reference refuses it."""
    ref, port = (m.options.Options for m in OSIDES)
    assert port.from_env(BASE_ENV).solver.backend == "torch"
    assert ref.from_env(BASE_ENV).solver.backend == "jax"
    for be in ("greedy", "remote"):
        env = {**BASE_ENV, "KARPENTER_SOLVER_BACKEND": be,
               "KARPENTER_SOLVER_ADDRESS": "127.0.0.1:1"}
        assert port.from_env(env).validate() == \
            ref.from_env(env).validate() == []
    stale = port.from_env({**BASE_ENV, "KARPENTER_SOLVER_BACKEND": "jax"})
    assert stale.validate() == [
        "solver backend invalid: 'jax' (one of greedy, torch, remote)"]
    assert ref.from_env({**BASE_ENV, "KARPENTER_SOLVER_BACKEND": "jax"}) \
        .validate() == []
    assert ref.from_env({**BASE_ENV, "KARPENTER_SOLVER_BACKEND": "torch"}) \
        .validate() == ["solver backend invalid: 'torch'"]
    # the operator refuses the stale name before it builds anything
    with pytest.raises(ValueError, match="one of greedy, torch, remote"):
        OSIDES[1].operator.Operator(stale, device="cpu")


# -- credentials --------------------------------------------------------------

def creds_roundtrip(m):
    store = m.credentials.CredentialStore(
        m.credentials.EnvCredentialProvider(BASE_ENV))
    creds = store.get()
    # plaintext never sits in the store's attributes
    for name, value in vars(store).items():
        if isinstance(value, (bytes, str)) and name != "_region":
            assert b"k3y" not in (value if isinstance(value, bytes)
                                  else value.encode())
    return dataclasses.astuple(creds)


def creds_missing_key(m):
    store = m.credentials.CredentialStore(m.credentials.EnvCredentialProvider(
        {"TPU_CLOUD_REGION": "us-south"}))
    with pytest.raises(m.errors.CloudError, match="API key") as e:
        store.get()
    return e.value.status_code, e.value.code, e.value.retryable


def creds_ttl(m):
    calls = []

    def provider():
        calls.append(1)
        if len(calls) == 3:
            raise m.errors.CloudError("provider down", 503)
        return m.credentials.Credentials(api_key=f"k{len(calls)}",
                                         region="us-south")

    clock = {"t": 0.0}
    store = m.credentials.CredentialStore(provider, ttl=100.0,
                                          clock=lambda: clock["t"])
    seen = [store.get().api_key, store.get().api_key]
    clock["t"] = 101.0
    seen.append(store.get().api_key)      # TTL refresh
    store.invalidate()
    seen.append(store.get().api_key)      # a failed refresh serves the cache
    store.invalidate()
    seen.append(store.get().api_key)      # forced
    return seen, len(calls)


def creds_static(m):
    p = m.credentials.StaticCredentialProvider(
        base64.b64encode(b"secret").decode(), "us-south",
        iks_api_key=base64.b64encode(b"iks").decode(), base64_encoded=True)
    return dataclasses.astuple(p())


def creds_fallback(m):
    """The stdlib cipher used without ``cryptography``: a round trip and
    a tampered blob refused."""
    aead = m.credentials._FallbackAEAD(
        m.credentials._FallbackAEAD.generate_key())
    nonce = os.urandom(12)
    blob = aead.encrypt(nonce, b"api\x00us-south\x00", None)
    assert b"api" not in blob
    plain = aead.decrypt(nonce, blob, None)
    bad = bytes([blob[0] ^ 1]) + blob[1:]
    with pytest.raises(ValueError, match="authentication failed"):
        aead.decrypt(nonce, bad, None)
    return plain, len(blob)


@pytest.mark.parametrize("script", [creds_roundtrip, creds_missing_key,
                                    creds_ttl, creds_static, creds_fallback],
                         ids=lambda f: f.__name__)
def test_credentials_match_reference(script):
    """Round trips, refusals, the TTL and a failed refresh, the base64
    provider and the fallback cipher (ciphertexts are not compared: the
    key is random per process)."""
    same(script)


# -- the operator's wiring ----------------------------------------------------

GATES = {
    "default": ({}, False, False),
    "no-interruption": ({"KARPENTER_ENABLE_INTERRUPTION": "false"},
                        False, False),
    "iks": ({}, True, False),
    "lbs": ({"KARPENTER_ENABLE_ORPHAN_CLEANUP": "1"}, False, True),
    "planes": ({"KARPENTER_ENABLE_PREEMPTION": "1",
                "KARPENTER_ENABLE_GANG": "1",
                "KARPENTER_ENABLE_WHATIF": "1",
                "KARPENTER_ENABLE_REPACK": "1"}, True, True),
}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_controller_fleet_and_gates_match_reference(gate):
    """``tests/test_operator.py::test_controller_fleet_and_gates`` over
    its flag combinations: the registered controllers, in order."""
    env, with_iks, with_lbs = GATES[gate]

    def script(m):
        cloud = m.fake.FakeCloud(region="us-south")
        kw = {"cloud": cloud}
        if with_iks:
            kw["iks"] = m.fake_iks.FakeIKS("cls-1", cloud)
        if with_lbs:
            kw["lbs"] = importlib.import_module(
                f"{m.pkg}.cloud.loadbalancer").FakeLoadBalancers()
        op = operator(m, env, **kw)
        try:
            names = op.manager.controllers()
            return names, op.whatif is not None
        finally:
            op.stop()

    names, whatif = same(script)
    assert ("iks.poolcleanup" in names) == with_iks
    assert "interruption" in names or gate == "no-interruption"
    assert whatif == (gate == "planes")


def test_options_iks_cluster_id_forces_mode():
    """``options.iks_cluster_id`` drives the factory without the ambient
    environment (``test_operator.py::test_options_iks_cluster_id_forces_mode``)."""
    def script(m):
        env = {**BASE_ENV, "IKS_CLUSTER_ID": "cls-42"}
        op = operator(m, env)
        op2 = operator(m, env, iks=m.fake_iks.FakeIKS("cls-42", op.cloud))
        try:
            plain = m.nodeclass.NodeClass(
                name="plain", spec=m.nodeclass.NodeClassSpec(
                    region="us-south", instance_profile="bx2-4x16",
                    image="img-1"))
            got = op2.factory.get_actuator(plain)
            assert isinstance(got, m.workerpool.WorkerPoolActuator)
            return type(got).__name__, op2.options.iks_cluster_id
        finally:
            op.stop()
            op2.stop()

    same(script)


def test_spot_discount_reaches_the_catalog():
    """``KARPENTER_SPOT_DISCOUNT_PERCENT`` prices the spot offerings of
    the operator's catalog as the reference's, offering for offering."""
    def script(m):
        env = {**BASE_ENV, "KARPENTER_SPOT_DISCOUNT_PERCENT": "30"}
        op = operator(m, env)
        try:
            types_ = op.instance_types.list()
            rows = sorted((t.name, o.zone, o.capacity_type, o.price)
                          for t in types_ for o in t.offerings)
            it = next(t for t in types_ if any(
                o.capacity_type == "spot" for o in t.offerings))
            od = next(o.price for o in it.offerings
                      if o.capacity_type == "on-demand")
            spot = next(o.price for o in it.offerings
                        if o.capacity_type == "spot")
            assert spot == pytest.approx(od * 0.30)
            return rows
        finally:
            op.stop()

    same(script)


def test_statusz_keys_match_reference(fixed_ids):
    """``statusz`` after one provisioning window: the same keys, the
    backend the package's own, the last solve's stats keys equal up to
    the reference's Pallas fields."""
    def script(m):
        op = operator(m, {"KARPENTER_ENABLE_WHATIF": "1",
                          "KARPENTER_TPU_WARMUP": "false",
                          "KARPENTER_WINDOW_IDLE_SECONDS": "2.0",
                          "KARPENTER_WINDOW_MAX_PODS": "6"})
        ready_nodeclass(m, op.cluster)
        try:
            op.start()
            for pod in m.pod.make_pods(
                    6, requests=m.pod.ResourceRequests(500, 1024, 0, 1)):
                op.cluster.add_pod(pod)
            assert wait_until(lambda: all(
                p.nominated_node for p in op.cluster.pending_pods()))
            s = op.statusz()
            assert s["backend"] == backend(m)
            assert s["leader"] is True and s["started"] is True
            assert s["last_solve"]
            return (sorted(s), sorted(s["recovery"]), sorted(s["whatif"]),
                    s["controllers"], sorted(s["circuit_breakers"]))
        finally:
            op.stop()

    same(script, fixed_ids)


# -- boot ---------------------------------------------------------------------

def boot_without_credentials(m):
    with pytest.raises(m.errors.CloudError) as e:
        operator(m, credential_provider=m.credentials.EnvCredentialProvider(
            {}))
    return e.value.code


def boot_invalid_options(m):
    with pytest.raises(ValueError, match="invalid options") as e:
        m.operator.Operator(
            m.options.Options.from_env({"TPU_CLOUD_API_KEY": "k"}),
            credential_provider=m.credentials.EnvCredentialProvider(BASE_ENV),
            **odev(m))
    return str(e.value)


def boot_programmatic_key(m):
    op = m.operator.Operator(m.options.Options(region="us-south",
                                               api_key="prog-key"),
                             **odev(m))
    try:
        return op.credentials.get().api_key
    finally:
        op.stop()


@pytest.mark.parametrize("script", [boot_without_credentials,
                                    boot_invalid_options,
                                    boot_programmatic_key],
                         ids=lambda f: f.__name__)
def test_boot_matches_reference(script):
    same(script)


def test_operator_needs_the_card_by_default(monkeypatch):
    """``Operator()`` resolves ``device="cuda"`` at construction: without a
    card it raises before the pricing batcher or any other thread
    starts."""
    import threading

    m = OSIDES[1]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = {t.ident for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="CUDA"):
        m.operator.Operator(m.options.Options.from_env(BASE_ENV))
    assert {t.ident for t in threading.enumerate()} <= before
    # asked for the CPU, the provisioner's solver and every controller
    # that plans get the operator's one device
    op = operator(m, dict(GATES["planes"][0]))
    try:
        assert op.device == torch.device("cpu")
        planners = [c for c in op.manager._poll + op.manager._watch
                    if hasattr(c, "device")]
        assert {"disruption", "preemption", "gang"} <= \
            {c.name for c in planners}
        assert all(c.device == op.device for c in planners)
        assert op.whatif.device == op.device
        assert op.provisioner.device == op.device
        assert op.provisioner.solver.primary.device == op.device
    finally:
        op.stop()


def test_build_info_names_the_operators_device(monkeypatch):
    """An operator asked for the CPU says ``platform="cpu"`` even where a
    card is present (the port's default reads the machine)."""
    m = OSIDES[1]
    op = operator(m, {"KARPENTER_SOLVER_BACKEND": "greedy"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        op.start()
        text = m.metrics.render()
        assert 'karpenter_tpu_build_info{version="dev",backend="greedy",' \
               'platform="cpu"} 1.0' in text
    finally:
        op.stop()


# -- warmup -------------------------------------------------------------------

def test_operator_boot_runs_warmup():
    """``tests/test_warmup.py::test_operator_boot_runs_warmup``: the
    warmup thread puts the provisioner's catalog on the solver's device
    (the port's backend ``torch``, as the reference's ``jax``)."""
    def script(m):
        op = m.operator.Operator(m.options.Options(
            api_key="k", region="us-south", solver_warmup=True), **odev(m))
        nc = m.nodeclass.NodeClass(name="default",
                                   spec=m.nodeclass.NodeClassSpec(
                                       region="us-south", image="img-1",
                                       vpc="vpc-1",
                                       instance_profile="bx2-4x16"))
        op.cluster.add_nodeclass(nc)
        try:
            op.start()
            assert op._warmup_thread is not None
            assert wait_until(
                lambda: op.provisioner.solver._device_catalog, 30.0, 0.1)
            keys = list(op.provisioner.solver._device_catalog)
            return len(keys), op.options.solver.backend == backend(m)
        finally:
            op.stop()
        assert op._warmup_thread is None

    assert same(script) == (1, True)


def test_warmup_runs_only_for_the_torch_backend(tmp_path, monkeypatch):
    """The gate reads ``torch``: the greedy backend warms nothing; the
    torch backend with a build directory records its AOT manifest."""
    from karpenter_tpu_torch import cuda_build
    from karpenter_tpu_torch.obs.devtel import get_devtel

    # the AOT cache moves the process's build directory and takes the
    # devtel signature sink: both are put back after
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(get_devtel(), "signature_sink",
                        get_devtel().signature_sink)
    m = OSIDES[1]
    greedy = operator(m, {"KARPENTER_SOLVER_BACKEND": "greedy"})
    try:
        greedy.start()
        assert greedy._warmup_thread is None
        assert not hasattr(greedy, "aot")
    finally:
        greedy.stop()
    op = operator(m, {"KARPENTER_TPU_COMPILE_CACHE": str(tmp_path)})
    try:
        op.start()
        assert op._warmup_thread is not None and op.aot is not None
        assert op.aot.dir == str(tmp_path)
        assert cuda_build.BUILD_DIR == tmp_path.resolve()
    finally:
        op.stop()


# -- drain and restart --------------------------------------------------------

def drain_operator(m, tmp_path, cloud=None, cluster=None, pods=4):
    """``TestOperatorDrain._operator`` for package ``m``, its window
    firing at ``pods`` (a stall of the host must not split it: the two
    packages' journals are compared)."""
    opts = m.options.Options(
        region="us-south", api_key="sim", journal_dir=str(tmp_path),
        solver=m.types.SolverOptions(backend="greedy"),
        window=m.window.WindowOptions(idle_seconds=2.0, max_seconds=10.0,
                                      max_pods=pods),
        solver_warmup=False)
    return m.operator.Operator(
        opts, cloud=cloud or m.fake.FakeCloud(region="us-south"),
        cluster=cluster, **odev(m))


def test_drain_then_restart_replays_zero_intents(tmp_path, fixed_ids):
    def script(m):
        d = tmp_path / m.pkg
        op = drain_operator(m, d)
        ready_nodeclass(m, op.cluster)
        op.start()
        try:
            for pod in m.pod.make_pods(
                    4, name_prefix="drain",
                    requests=m.pod.ResourceRequests(500, 1024, 0, 1)):
                op.cluster.add_pod(pod)
            assert wait_until(lambda: all(
                p.nominated_node for p in op.cluster.pending_pods()))
        finally:
            op.drain()
        intents, _, _, _ = m.read_journal.read_journal(
            os.path.join(str(d), "intents.jsonl"))
        assert all(i.outcome for i in intents)
        assert (d / "drain-spans.jsonl").exists()
        op2 = drain_operator(m, d)
        op2.recover()
        try:
            last = op2.statusz()["recovery"]["last_recovery"]
            return (sorted((i.kind, i.outcome) for i in intents),
                    op2._recovery_report.replayed, last["replayed"],
                    op.journal.stats().get("open_intents"))
        finally:
            op2.stop()

    out = same(script, fixed_ids)
    assert out[1] == out[2] == 0 and out[3] == 0


def test_crashed_operator_restart_replays(tmp_path, fixed_ids):
    """A not-drained operator with an open create intent: the next one
    finishes it and restores the lost nomination."""
    def script(m):
        d = tmp_path / m.pkg
        op = drain_operator(m, d)
        nc = ready_nodeclass(m, op.cluster)
        pricing = m.catalog.PricingProvider(op.cloud)
        catalog = m.arrays.CatalogArrays.build(
            m.catalog.InstanceTypeProvider(op.cloud, pricing).list())
        pricing.close()
        op.cluster.add_pod(m.pod.PodSpec(
            "crashpod", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
        injector = m.crash.CrashInjector("actuate.post_create", seed=1,
                                         first_hit_range=(1, 1),
                                         max_crashes=1)
        node = m.types.PlannedNode(
            instance_type=catalog.type_names[0], zone="us-south-1",
            capacity_type="on-demand", price=1.0,
            pod_names=["default/crashpod"])
        with m.crash.installed(injector), \
                pytest.raises(m.crash.SimulatedCrash):
            op.actuator.create_node(node, nc, catalog)
        op.journal.close()
        op.pricing.close()
        op2 = drain_operator(m, d, cloud=op.cloud, cluster=op.cluster)
        op2.recover()
        try:
            rep = op2._recovery_report
            pod = op2.cluster.get("pods", "default/crashpod")
            return (rep.replayed, rep.finished, rep.fenced,
                    op2.cloud.instance_count(), pod.nominated_node)
        finally:
            op2.stop()

    out = same(script, fixed_ids)
    assert out[:4] == (1, 1, 0, 1) and out[4]


# -- two operators on one cluster ---------------------------------------------

def test_two_operators_one_cluster_only_holder_actuates():
    """``tests/test_leaderelection.py::TestOperatorFailover``: only the
    lease holder actuates; on handoff the second takes over."""
    def script(m):
        cluster = m.cluster.ClusterState()
        cloud = m.fake.FakeCloud()

        def make_operator(ident):
            opts = m.options.Options(region="us-south", api_key="k",
                                     leader_election_enabled=True,
                                     leader_identity=ident)
            opts.solver = m.types.SolverOptions(backend="greedy")
            opts.window.idle_seconds = 0.05
            opts.window.max_seconds = 0.2
            return m.operator.Operator(options=opts, cloud=cloud,
                                       cluster=cluster, **odev(m))

        ops = [make_operator("op-a"), make_operator("op-b")]
        for op in ops:
            op.elector.lease_duration = 1.0
            op.elector.renew_interval = 0.1
            op.elector.retry_interval = 0.1
        nc = cluster.add_nodeclass(m.nodeclass.NodeClass(
            name="default", spec=m.nodeclass.NodeClassSpec(
                region="us-south", instance_profile="bx2-4x16",
                image="img-1")))
        nc.status.set_condition("Ready", "True", "Validated")
        op_a, op_b = ops
        op_a.start()
        op_b.start()
        try:
            leaders = (op_a.elector.is_leader(), op_b.elector.is_leader())
            cluster.add_pod(m.pod.PodSpec(
                "w0", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
            assert wait_until(lambda: cluster.nodeclaims(), 10.0)
            first = len(cluster.nodeclaims())
            once = len(cloud.list_instances()) == first
            op_a.stop()
            assert wait_until(op_b.elector.is_leader, 5.0)
            cluster.add_pod(m.pod.PodSpec(
                "w1", requests=m.pod.ResourceRequests(500, 1024, 0, 1)))
            assert wait_until(lambda: len(cluster.nodeclaims()) > first,
                              10.0)
            return (leaders, first, once, len(cluster.nodeclaims()),
                    op_b.statusz()["leader"])
        finally:
            for op in ops:
                op.stop()

    assert same(script) == ((True, False), 1, True, 2, True)
