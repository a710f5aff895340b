"""The port's provisioning loop against the reference's, on the CPU.

``karpenter_tpu_torch/core/provisioner.py::Provisioner`` (with the
cluster store, the actuator and the catalog cache it drives) runs the
same call scripts as ``karpenter_tpu/core/provisioner.py``: the
reference's rig (``tests/test_core.py``'s ``rig``) is built once for
each package, the port's with ``device="cpu"``.  Plans and claims are
compared exactly (the cost by the repo's 1e-6 relative rule), claims
keyed by their pod sets; so are the nominations, the events, the
explain verdicts and the fake cloud's call counts.

Claim names come from ``uuid.uuid4`` and bootstrap tokens from
``secrets.token_hex`` in both packages: the ``fixed_ids`` fixture swaps
both for counters, restarted before each side, so the names agree.  The
live cases freeze the window batcher's clock (its ``time`` module), so a
window fires on its pod count alone; every wait polls at 0.05 s under a
deadline of 5 s.
"""

from __future__ import annotations

import importlib
import re
import secrets
import time
import types
import uuid

import pytest
import torch

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")

_MODS = dict(
    pod="apis.pod", nodeclaim="apis.nodeclaim", nodeclass="apis.nodeclass",
    catalog="catalog", arrays="catalog.arrays", fake="cloud.fake",
    errors="cloud.errors", cluster="core.cluster", actuator="core.actuator",
    provisioner="core.provisioner", window="core.window",
    breaker="core.circuitbreaker", bootstrap="core.bootstrap",
    cloudinit="core.cloudinit", kubelet="core.kubelet",
    cloudprovider="core.cloudprovider", image="cloud.image",
    subnet="cloud.subnet", types="solver.types", explain="explain",
    obs="obs", ledger="obs.ledger", metrics="utils.metrics",
    batcher="utils.batcher", crash="recovery.crashpoints",
    journal="recovery.journal", reconciler="recovery.reconciler",
    constants="constants")


def mods(pkg: str) -> types.SimpleNamespace:
    """The modules of one package under short names."""
    return types.SimpleNamespace(
        pkg=pkg, torch=pkg.endswith("_torch"),
        **{k: importlib.import_module(f"{pkg}.{v}")
           for k, v in _MODS.items()})


SIDES = tuple(mods(p) for p in PKGS)


# -- deterministic names ------------------------------------------------------

class FixedIds:
    """Counters in place of ``uuid.uuid4`` and ``secrets.token_hex``;
    ``reset()`` before each side makes both mint the same names."""

    def __init__(self):
        self.n = self.t = 0

    def reset(self):
        self.n = self.t = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n << 96)     # hex[:8] is the counter

    def token_hex(self, nbytes=None):
        self.t += 1
        return f"{self.t:0{2 * (nbytes or 32)}x}"


@pytest.fixture
def fixed_ids(monkeypatch):
    ids = FixedIds()
    monkeypatch.setattr(uuid, "uuid4", ids.uuid4)
    monkeypatch.setattr(secrets, "token_hex", ids.token_hex)
    return ids


# -- the rig ------------------------------------------------------------------

def ready_nodeclass(m, name="default", **kw):
    """``tests/test_core.py::ready_nodeclass`` for package ``m``."""
    nc = m.nodeclass.NodeClass(name=name, spec=m.nodeclass.NodeClassSpec(
        region="us-south", instance_profile="", image="img-1", vpc="vpc-1",
        **kw))
    nc.spec.instance_requirements = None
    nc.spec.instance_profile = "bx2-4x16"
    nc.status.resolved_image_id = "img-1"
    nc.status.set_condition("Ready", "True", "Validated")
    return nc


def permissive_breaker(m):
    return m.breaker.CircuitBreakerManager(m.breaker.CircuitBreakerConfig(
        failure_threshold=10000, rate_limit_per_minute=100000,
        max_concurrent_instances=100000))


class Rig(types.SimpleNamespace):
    """cloud, pricing, itp, cluster, actuator, prov of one package."""

    def close(self):
        if self.prov is not None:
            self.prov.stop()
        self.pricing.close()


def make_rig(m, backend="jax", nodeclass=None, journal=None, cloud=None,
             provisioner=True, **solver_kw) -> Rig:
    cloud = cloud or m.fake.FakeCloud()
    pricing = m.catalog.PricingProvider(cloud)
    unavail = m.catalog.UnavailableOfferings()
    itp = m.catalog.InstanceTypeProvider(cloud, pricing, unavail)
    cluster = m.cluster.ClusterState()
    cluster.add_nodeclass(nodeclass or ready_nodeclass(m))
    actuator = m.actuator.Actuator(cloud, cluster, unavailable=unavail,
                                   journal=journal)
    prov = None
    if provisioner:
        prov = new_provisioner(m, cluster, itp, actuator, backend=backend,
                               journal=journal, **solver_kw)
    return Rig(m=m, cloud=cloud, pricing=pricing, unavail=unavail, itp=itp,
               cluster=cluster, actuator=actuator, prov=prov)


def new_provisioner(m, cluster, itp, actuator, backend="jax", journal=None,
                    **solver_kw):
    kw = {"device": "cpu"} if m.torch else {}
    return m.provisioner.Provisioner(
        cluster, itp, actuator, m.provisioner.ProvisionerOptions(
            solver=m.types.SolverOptions(backend=backend, **solver_kw)),
        journal=journal, **kw)


@pytest.fixture
def rigs(fixed_ids):
    """``build(**kw)`` -> one rig per package, each closed at the end."""
    made = []

    def build(**kw):
        out = [make_rig(m, **kw) for m in SIDES]
        for r in out:
            r.ids = fixed_ids
        made.extend(out)
        return out

    yield build
    for r in made:
        r.close()


def run_both(rigs_, script):
    """``script(rig)`` on each side with the id counters restarted; the
    outcome of each side."""
    outs = []
    for r in rigs_:
        r.ids.reset()
        outs.append(script(r))
    return outs


# -- outcomes -----------------------------------------------------------------

def plan_key(plan):
    return {"nodes": [(n.instance_type, n.zone, n.capacity_type,
                       n.offering_index, sorted(n.pod_names))
                      for n in plan.nodes],
            "prices": [n.price for n in plan.nodes],
            "unplaced": sorted(plan.unplaced_pods),
            "reasons": dict(plan.unplaced_reasons),
            "words": dict(plan.unplaced_words)}


def plans_equal(a, b):
    assert len(a) == len(b)
    for pa, pb in zip(a, b):
        assert plan_key(pa) == plan_key(pb)
        assert pa.total_cost_per_hour == pytest.approx(
            pb.total_cost_per_hour, rel=1e-6)


def claims_by_pods(r):
    """{sorted pod keys nominated onto a claim: the claim's offering and
    name}; claims with no nominated pod under their name's key."""
    pods: dict = {}
    for p in r.cluster.list("pods"):
        if p.nominated_node:
            pods.setdefault(p.nominated_node, []).append(
                f"{p.spec.namespace}/{p.spec.name}")
    out = {}
    for c in r.cluster.nodeclaims():
        key = tuple(sorted(pods.get(c.name, ()))) or (c.name,)
        out[key] = (c.name, c.instance_type, c.zone, c.capacity_type,
                    c.nodepool_name, c.provider_id, c.subnet_id,
                    c.image_id, c.hourly_price, c.launched, c.deleted,
                    tuple(c.finalizers), dict(c.labels),
                    dict(c.annotations))
    return out


_TRACE = re.compile(r"trace=\d+")


def events(r):
    return [(e.kind, e.name, e.type, e.reason, _TRACE.sub("trace=*",
                                                          e.message))
            for e in r.cluster.events]


def cloud_calls(r):
    return {k: len(v) for k, v in r.cloud.recorder.calls.items() if v}


def outcome(r, plans=()):
    return {"plans": [plan_key(p) for p in plans],
            "claims": claims_by_pods(r),
            "nominated": {k: p.nominated_node for k, p in sorted(
                r.cluster._collections["pods"].items())},
            "events": events(r), "calls": cloud_calls(r),
            "instances": sorted((i.name, i.profile, i.zone, i.capacity_type,
                                 i.subnet_id, i.image_id)
                                for i in r.cloud.list_instances())}


def same_outcome(outs, plans=None):
    a, b = outs
    if plans is not None:
        plans_equal(*plans)
    assert a == b


def add_pods(r, n, prefix="pod", cpu=500, mem=512):
    for pod in r.m.pod.make_pods(n, name_prefix=prefix,
                                 requests=r.m.pod.ResourceRequests(
                                     cpu, mem, 0, 1)):
        r.cluster.add_pod(pod)


def wait_until(pred, deadline_s=5.0, poll_s=0.05) -> bool:
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        if pred():
            return True
        time.sleep(poll_s)
    return pred()


# -- the end-to-end slice -----------------------------------------------------

def test_100_pods_provisioned(rigs):
    """``TestEndToEndSlice.test_100_pods_provisioned`` on both packages."""
    def script(r):
        add_pods(r, 100, "nginx")
        plans = r.prov.provision_once()
        assert sum(p.placed_count for p in plans) == 100
        assert all(p.nominated_node for p in r.cluster.pending_pods())
        assert all(c.annotations["karpenter-tpu.sh/subnet-id"]
                   for c in r.cluster.nodeclaims())
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob
    assert pb[0].backend == "torch" and pa[0].backend == "jax"


def test_failed_create_leaves_pods_pending_then_retries(rigs):
    def script(r):
        r.actuator.breaker = permissive_breaker(r.m)
        err = r.m.errors.CloudError("no capacity", 503,
                                    code="insufficient_capacity",
                                    retryable=False)
        r.cloud.recorder.set_persistent_error("create_instance", err)
        add_pods(r, 5)
        first = r.prov.provision_once()
        assert r.cloud.instance_count() == 0
        assert all(not p.nominated_node for p in r.cluster.pending_pods())
        blacked = sorted(r.unavail.unavailable_keys())
        assert blacked
        r.cloud.recorder.set_persistent_error("create_instance", None)
        second = r.prov.provision_once()
        assert all(p.nominated_node for p in r.cluster.pending_pods())
        return first + second, outcome(r, first + second), blacked

    (pa, oa, ba), (pb, ob, bb) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob and ba == bb


def test_greedy_backend_gate(rigs):
    def script(r):
        prov2 = new_provisioner(r.m, r.cluster, r.itp, r.actuator,
                                backend="greedy")
        add_pods(r, 10)
        plans = prov2.provision_once()
        assert plans[0].backend in ("greedy", "greedy-native")
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob


def test_provisioner_on_the_card_by_default():
    """``Provisioner`` resolves ``device="cuda"`` at construction: without
    a card it raises, whatever the backend."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    m = SIDES[1]
    r = make_rig(m, provisioner=False)
    try:
        for backend in ("jax", "greedy"):
            with pytest.raises(RuntimeError, match="CUDA"):
                m.provisioner.Provisioner(
                    r.cluster, r.itp, r.actuator,
                    m.provisioner.ProvisionerOptions(
                        solver=m.types.SolverOptions(backend=backend)))
    finally:
        r.close()


# -- pool limits --------------------------------------------------------------

def pods_of(m, n, prefix="p"):
    return [m.pod.PodSpec(f"{prefix}{i}",
                          requests=m.pod.ResourceRequests(1000, 2048))
            for i in range(n)]


@pytest.mark.parametrize("backend", ["jax", "greedy"])
def test_cpu_limit_blocks_overflow(rigs, backend):
    """``tests/test_pool_limits.py``: the pool's cpu budget trims the plan
    (the view masks offerings above what is left, then the trim drops
    nodes past the budget); dropped pods carry NodePoolLimitReached."""
    def script(r):
        r.cluster.add_nodepool(r.m.nodeclaim.NodePool(
            name="capped", nodeclass_name="default", cpu_limit_milli=8000))
        plans, nominated = r.prov._provision(pods_of(r.m, 40))
        catalog = r.prov._catalog_for(r.cluster.get_nodeclass("default"))
        idx = {n: i for i, n in enumerate(catalog.type_names)}
        total = sum(int(catalog.type_alloc[idx[c.instance_type], 0])
                    for c in r.cluster.nodeclaims())
        assert 0 < total <= 8000 and len(nominated) < 40
        limited = sorted(e.name for e in r.cluster.events
                         if e.reason == "NodePoolLimitReached")
        assert limited
        return plans, outcome(r, plans), dict(nominated), limited

    (pa, oa, na, la), (pb, ob, nb, lb) = run_both(rigs(backend=backend),
                                                  script)
    plans_equal(pa, pb)
    assert oa == ob and na == nb and la == lb


def test_existing_usage_counts_against_limit(rigs):
    def script(r):
        r.cluster.add_nodepool(r.m.nodeclaim.NodePool(
            name="capped", nodeclass_name="default", cpu_limit_milli=8000))
        first, _ = r.prov._provision(pods_of(r.m, 6))
        second, _ = r.prov._provision(pods_of(r.m, 40, "q"))
        usage = r.prov._pool_usage(
            r.cluster.get("nodepools", "capped"),
            r.prov._catalog_for(r.cluster.get_nodeclass("default")))
        assert usage[0] <= 8000
        return first + second, outcome(r, first + second), usage

    (pa, oa, ua), (pb, ob, ub) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob and ua == ub


def test_limit_view_keys_the_mask(rigs):
    """``_catalog_within_limits``: the shallow view's mask, derived uid and
    availability generation equal the reference's; a budget that binds no
    offering returns the base catalog, an exhausted one None."""
    def script(r):
        np_ = r.m.nodeclaim.NodePool
        catalog = r.prov._catalog_for(r.cluster.get_nodeclass("default"))
        out = []
        for limit, usage in ((8000, (0, 0)), (8000, (6000, 0)),
                             (10 ** 9, (0, 0)), (8000, (8000, 0))):
            pool = np_(name="v", nodeclass_name="default",
                       cpu_limit_milli=limit)
            view = r.prov._catalog_within_limits(pool, catalog, usage)
            if view is None or view is catalog:
                out.append(view is None)
                continue
            assert view.uid == f"{catalog.uid}-limit-v"
            out.append((view.off_avail.tolist(),
                        view.availability_generation[:2]))
        return out

    a, b = run_both(rigs(), script)
    assert a == b


def test_unlimited_pool_and_weights(rigs):
    """Pools solve in weight order; an unlimited pool places all."""
    def script(r):
        np_ = r.m.nodeclaim.NodePool
        r.cluster.add_nodepool(np_(name="light", nodeclass_name="default",
                                   weight=1))
        r.cluster.add_nodepool(np_(name="heavy", nodeclass_name="default",
                                   weight=50))
        plans, nominated = r.prov._provision(pods_of(r.m, 20))
        assert len(nominated) == 20
        assert {c.nodepool_name for c in r.cluster.nodeclaims()} == \
            {"heavy"}
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(backend="greedy"), script)
    plans_equal(pa, pb)
    assert oa == ob


# -- soft taints --------------------------------------------------------------

def soft_pools(r):
    m = r.m
    r.cluster.add_nodepool(m.nodeclaim.NodePool(
        name="gpu-pool", nodeclass_name="default", weight=100,
        taints=(m.pod.Taint("dedicated", "gpu", "PreferNoSchedule"),)))
    r.cluster.add_nodepool(m.nodeclaim.NodePool(
        name="general", nodeclass_name="default", weight=10))


@pytest.mark.parametrize("case", ["intolerant", "tolerant", "alone",
                                  "mixed"])
def test_soft_taint_passes(rigs, case):
    """``TestPreferNoScheduleTaints``: pass 0 offers a soft-tainted pool
    only the pods that tolerate it; pass 1 re-offers the pods it denied
    when no other pool took them."""
    def script(r):
        m = r.m
        soft_pools(r)
        tol = (m.pod.Toleration("dedicated", "Equal", "gpu",
                                "PreferNoSchedule"),)
        req = m.pod.ResourceRequests(500, 1024)
        if case == "alone":
            r.cluster.delete("nodepools", "general")
        pods = [m.pod.PodSpec("plain", requests=req)]
        if case in ("tolerant", "mixed"):
            pods.append(m.pod.PodSpec("gpuish", requests=req,
                                      tolerations=tol))
        if case == "tolerant":
            pods = pods[1:]
        plans, nominated = r.prov._provision(pods)
        pools = {k: r.cluster.get("nodeclaims", v).nodepool_name
                 for k, v in nominated.items()}
        want = {"intolerant": {"default/plain": "general"},
                "tolerant": {"default/gpuish": "gpu-pool"},
                "alone": {"default/plain": "gpu-pool"},
                "mixed": {"default/plain": "general",
                          "default/gpuish": "gpu-pool"}}[case]
        assert pools == want
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(backend="greedy"), script)
    plans_equal(pa, pb)
    assert oa == ob


def test_soft_taint_passes_on_the_port_solver(rigs):
    """The same two passes through the port's solver (``TorchSolver``)
    and the reference's ``JaxSolver``."""
    def script(r):
        m = r.m
        r.actuator.breaker = permissive_breaker(m)
        soft_pools(r)
        tol = (m.pod.Toleration("dedicated", "Equal", "gpu",
                                "PreferNoSchedule"),)
        pods = [m.pod.PodSpec(f"s{i}", requests=m.pod.ResourceRequests(
            500 + 100 * i, 1024), tolerations=tol if i % 3 == 0 else ())
            for i in range(12)]
        plans, nominated = r.prov._provision(pods)
        assert len(nominated) == 12
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob


# -- explain verdicts ---------------------------------------------------------

def registry_view(m):
    return sorted((e.pod, e.reason, e.word, repr(e.nearest))
                  for e in m.explain.get_registry().entries())


@pytest.mark.parametrize("backend", ["greedy", "jax"])
def test_window_records_unplaced(rigs, backend):
    """``TestEndToEndWindow.test_window_records_unplaced``: an unplaceable
    pod's verdict reaches the registry, the ledger, the gauge and one
    Warning event (deduped on the second window)."""
    def script(r):
        m = r.m
        m.explain.get_registry().clear()
        with m.obs.use_ledger(m.ledger.PlacementLedger()) as ledger:
            req = m.pod.ResourceRequests
            r.cluster.add_pod(m.pod.PodSpec("ok", requests=req(
                500, 1024, 0, 1)))
            r.cluster.add_pod(m.pod.PodSpec("stuck", requests=req(
                40_000_000, 800_000_000, 0, 1)))
            plans = r.prov.provision_once()
            entry = m.explain.get_registry().get("default/stuck")
            assert entry is not None and entry.nearest is not None
            assert entry.reason.startswith("insufficient_")
            assert m.explain.get_registry().get("default/ok") is None
            rec = ledger.get("default/stuck")
            stamps = [n for n in rec.stamp_names() if n.startswith(
                "unplaced:")]
            plans += r.prov.provision_once()
            gauge = m.metrics.UNPLACED_PODS.get(entry.reason)
            view = registry_view(m)
        return plans, outcome(r, plans), view, stamps, gauge

    (pa, *ra), (pb, *rb) = run_both(rigs(backend=backend), script)
    plans_equal(pa, pb)
    assert ra == rb
    assert [e for e in ra[0]["events"] if e[3] == "Unplaced"][0][1] == \
        "default/stuck"


def test_pool_budget_exhausted_gets_verdict(rigs):
    def script(r):
        m = r.m
        m.explain.get_registry().clear()
        r.cluster.add_nodepool(m.nodeclaim.NodePool(
            name="tight", nodeclass_name="default", cpu_limit_milli=1))
        r.cluster.add_nodeclaim(m.nodeclaim.NodeClaim(
            name="eats-budget", nodepool_name="tight",
            instance_type="bx2-4x16", zone="us-south-1", launched=True))
        r.cluster.add_pod(m.pod.PodSpec("budgeted", requests=m.pod.
                                        ResourceRequests(500, 1024, 0, 1)))
        plans = r.prov.provision_once()
        entry = m.explain.get_registry().get("default/budgeted")
        assert entry is not None and entry.reason == "capacity_exhausted"
        return plans, outcome(r, plans), registry_view(m)

    (pa, *ra), (pb, *rb) = run_both(rigs(backend="greedy"), script)
    plans_equal(pa, pb)
    assert ra == rb


def test_gauge_zeroes_when_pod_places(rigs):
    def script(r):
        m = r.m
        m.explain.get_registry().clear()
        req = m.pod.ResourceRequests
        r.cluster.add_pod(m.pod.PodSpec("flappy", requests=req(
            40_000_000, 800_000_000, 0, 1)))
        plans = r.prov.provision_once()
        reason = m.explain.get_registry().get("default/flappy").reason
        before = m.metrics.UNPLACED_PODS.get(reason)
        r.cluster.bind_pod("default/flappy", "node-external")
        m.explain.get_registry().resolve("default/flappy")
        r.cluster.add_pod(m.pod.PodSpec("easy", requests=req(
            500, 1024, 0, 1)))
        plans += r.prov.provision_once()
        return plans, outcome(r, plans), reason, before, \
            m.metrics.UNPLACED_PODS.get(reason)

    (pa, *ra), (pb, *rb) = run_both(rigs(backend="greedy"), script)
    plans_equal(pa, pb)
    assert ra == rb and ra[2:] == [1.0, 0.0]


# -- gates --------------------------------------------------------------------

def test_leader_and_admission_gates(rigs):
    """A follower's window resolves every pod to None and solves
    nothing; the admission gate parks pods out of the solve."""
    def script(r):
        m = r.m
        add_pods(r, 6)
        pods = [p.spec for p in r.cluster.pending_pods()]
        r.prov.leader = lambda: False
        follower = r.prov._on_window(pods)
        r.prov.leader = lambda: True
        r.prov.admission = lambda p: not p.name.endswith(("1", "3"))
        got = r.prov._on_window(pods + pods[:2])
        r.prov.admission = None
        return follower, got, outcome(r)

    (fa, ga, oa), (fb, gb, ob) = run_both(rigs(), script)
    assert fa == fb == [None] * 6
    assert ga == gb and ga[1] is None and ga[0] is not None
    assert oa == ob


# -- catalog identity ---------------------------------------------------------

def test_blackout_rekeys_the_availability_only(rigs):
    """``_catalog_for`` keeps one ``CatalogArrays`` per NodeClass: a
    blackout moves its availability generation and mask in place (no
    rebuild), and the port's solver uploads the catalog once more (one
    ``obs.devtel`` upload, ``device_offerings``)."""
    from karpenter_tpu_torch.obs.devtel import get_devtel

    def script(r):
        add_pods(r, 8)
        nc = r.cluster.get_nodeclass("default")
        cat = r.prov._catalog_for(nc)
        gen0, avail0 = cat.availability_generation, cat.off_avail.copy()
        plans = r.prov.provision_once()
        up0 = get_devtel().snapshot()["catalog_uploads"] if r.m.torch \
            else None
        node = plans[0].nodes[0]
        r.unavail.mark_unavailable(node.instance_type, node.zone,
                                   node.capacity_type, reason="test")
        add_pods(r, 8, "more")
        plans += r.prov.provision_once()
        cat2 = r.prov._catalog_for(nc)
        assert cat2 is cat and cat.availability_generation != gen0
        flipped = np_where(avail0 != cat.off_avail)
        assert all((plans[1].nodes[i].instance_type,
                    plans[1].nodes[i].zone,
                    plans[1].nodes[i].capacity_type)
                   != (node.instance_type, node.zone, node.capacity_type)
                   for i in range(len(plans[1].nodes)))
        uploads = None
        if r.m.torch:
            uploads = get_devtel().snapshot()["catalog_uploads"] - up0
        return plans, outcome(r, plans), flipped, uploads

    (pa, oa, fa, _), (pb, ob, fb, ub) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob and fa == fb and len(fa) == 1
    assert ub == 1


def np_where(mask):
    import numpy as np

    return [int(i) for i in np.flatnonzero(mask)]


# -- a failed solve -----------------------------------------------------------

class Boom(RuntimeError):
    pass


def test_failed_solve_degrades_on_the_cpu(rigs):
    """On the CPU ``make_solver``'s wrapper plans a failed solve through
    the greedy oracle, as the reference's does: the pods are nominated
    and the plan is tagged ``degraded:``."""
    def script(r):
        def fail(_request):
            raise Boom("backend down")
        r.prov.solver.primary.solve = fail
        add_pods(r, 12)
        plans = r.prov.provision_once()
        assert plans[0].backend.startswith("degraded:")
        assert all(p.nominated_node for p in r.cluster.pending_pods())
        return plans, outcome(r, plans)

    (pa, oa), (pb, ob) = run_both(rigs(), script)
    plans_equal(pa, pb)
    assert oa == ob


def test_device_fault_on_the_card_raises_and_creates_nothing(rigs):
    """A primary on the card (its ``device`` a CUDA device) whose solve
    fails raises out of ``provision_once`` and, on the watch path, into
    every future of the window: no claim, no instance, no host plan and
    no degradation breadcrumb."""
    from karpenter_tpu_torch.faulttol import DeviceFaultError
    from karpenter_tpu_torch.solver.degraded import breadcrumbs

    _, r = rigs()
    calls = []

    def fault(_request):
        calls.append(1)
        raise DeviceFaultError("scripted", kernel="scan", kind="error")

    r.prov.solver.primary.device = torch.device("cuda", 0)
    r.prov.solver.primary.solve = fault
    add_pods(r, 6)
    before = breadcrumbs()
    with pytest.raises(DeviceFaultError):
        r.prov.provision_once()
    assert r.cluster.nodeclaims() == [] and r.cloud.instance_count() == 0
    assert all(not p.nominated_node for p in r.cluster.pending_pods())
    # the watch path: the window's futures hold the error
    futures = [None] * 6
    r.prov._window = r.m.window.SolveWindow(
        r.prov._on_window, r.m.window.WindowOptions(
            idle_seconds=0.01, max_seconds=0.05, max_pods=6))
    futures = r.prov._window.add_all(
        [p.spec for p in r.cluster.pending_pods()])
    for f in futures:
        with pytest.raises(DeviceFaultError):
            f.result(timeout=5)
    assert r.cluster.nodeclaims() == [] and len(calls) == 2
    assert breadcrumbs() == before


# -- the live watch path ------------------------------------------------------

class FrozenTime:
    """The batcher module's ``time``: ``monotonic`` is frozen, so a window
    fires on its pod count alone."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def frozen(monkeypatch):
    """``freeze(rig)``: the catalog priced and listed first (the pricing
    provider batches on the same module's clock), then that package's
    window batcher frozen."""
    def freeze(r):
        r.prov._catalog_for(r.cluster.get_nodeclass("default"))
        monkeypatch.setattr(r.m.batcher, "time", FrozenTime())
    return freeze


def live_window(r, freeze, pods: int, retry_interval: float = 15.0):
    freeze(r)
    r.prov.options.window = r.m.window.WindowOptions(
        idle_seconds=60.0, max_seconds=60.0, max_pods=pods)
    r.prov.options.retry_interval = retry_interval
    r.actuator.breaker = permissive_breaker(r.m)


def all_nominated(r):
    return all(p.nominated_node for p in r.cluster.pending_pods())


def test_live_window_coalesces_arrivals(rigs, frozen):
    """Watch-driven mode: 30 pod ADDED events feed one window (it fires at
    its count of 30), whose solve and actuation nominate every pod."""
    def script(r):
        live_window(r, frozen, 30)
        fired = []
        on_window = r.prov._on_window

        def counted(pods):
            fired.append(len(pods))
            return on_window(pods)

        r.prov._on_window = counted
        r.prov.start()
        try:
            add_pods(r, 30)
            assert wait_until(lambda: all_nominated(r))
        finally:
            r.prov.stop()
        return fired, outcome(r)

    (fa, oa), (fb, ob) = run_both(rigs(), script)
    assert fa == fb == [30]
    assert oa == ob


def test_live_retry_loop_recovers_failed_creates(rigs, frozen):
    """Pods stranded by a failed create re-enter a window through the
    retry ticker once the fault clears."""
    def script(r):
        live_window(r, frozen, 5, retry_interval=0.1)
        err = r.m.errors.CloudError("no capacity", 503,
                                    code="insufficient_capacity",
                                    retryable=False)
        r.cloud.recorder.set_persistent_error("create_instance", err)
        r.prov.start()
        try:
            add_pods(r, 5)
            assert wait_until(lambda: r.cloud.recorder.call_count(
                "create_instance") >= 2)
            assert r.cloud.instance_count() == 0
            r.cloud.recorder.set_persistent_error("create_instance", None)
            assert wait_until(lambda: all_nominated(r))
        finally:
            r.prov.stop()
        return claims_by_pods(r)

    a, b = run_both(rigs(), script)
    assert {k: v[1:4] for k, v in a.items()} == \
        {k: v[1:4] for k, v in b.items()}


def test_live_claim_deletion_renominates(rigs, frozen):
    """A claim deleted from the store un-nominates its pods; the next
    window replaces the capacity."""
    def script(r):
        live_window(r, frozen, 4)
        r.prov.start()
        try:
            add_pods(r, 4)
            assert wait_until(lambda: all_nominated(r))
            victim = r.cluster.nodeclaims()[0]
            orphans = sum(p.nominated_node == victim.name
                          for p in r.cluster.pending_pods())
            # the next window fires at the orphans' count
            r.prov._window.close()
            r.prov._window = r.m.window.SolveWindow(
                r.prov._on_window, r.m.window.WindowOptions(
                    idle_seconds=60.0, max_seconds=60.0, max_pods=orphans))
            r.cluster.delete("nodeclaims", victim.name)
            assert wait_until(lambda: all(
                p.nominated_node and p.nominated_node != victim.name
                for p in r.cluster.pending_pods()))
        finally:
            r.prov.stop()
        return outcome(r)

    a, b = run_both(rigs(), script)
    assert a == b
