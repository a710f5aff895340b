"""The port's chaos harness units against the reference's.

Each test runs one script through the reference's module and the port's
(``karpenter_tpu_torch/chaos/``) and compares what comes out: the
virtual clock's patching, ``EventTrace`` digests, the profile registry
(names and every field), ``ChaosCloud``'s fault injection on the raw
``FakeCloud``, the chaos solver wrappers, and the invariant checker on
hand-made cluster snapshots.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import time
import types

import pytest

from tests.torch_native_pin import native_pin

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")


def mods(pkg: str) -> types.SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{pkg}.{name}")

    return types.SimpleNamespace(
        pkg=pkg, clock=m("chaos.clock"), trace=m("chaos.trace"),
        profile=m("chaos.profile"), cloud=m("chaos.cloud"),
        solver=m("chaos.solver"), inv=m("chaos.invariants"),
        fake=m("cloud.fake"), errors=m("cloud.errors"),
        actuator=m("core.actuator"), nodeclaim=m("apis.nodeclaim"),
        pod=m("apis.pod"), catalog=m("catalog"), cluster=m("core.cluster"),
        greedy=m("solver.greedy"), types=m("solver.types"))


SIDES = tuple(mods(p) for p in PKGS)


def both(script):
    """The script's outcome on the reference and on the port."""
    ref, port = (script(m) for m in SIDES)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# VirtualClock, EventTrace, profiles
# ---------------------------------------------------------------------------

def test_virtual_clock_patches_and_restores():
    def script(m):
        real = (time.time, time.monotonic, time.sleep)
        clock = m.clock.VirtualClock(start=5000.0)
        out = [clock.time()]
        with clock.installed():
            time.sleep(120.0)
            out += [time.time(), time.monotonic() == clock.monotonic()]
        out.append((time.time, time.monotonic, time.sleep) == real)
        clock.advance(60.0)
        out.append(clock.time())
        with pytest.raises(ValueError):
            clock.advance(-1.0)
        with pytest.raises(RuntimeError):
            with clock.installed():
                raise RuntimeError("boom")
        out.append(time.time is real[0])
        wall0 = time.perf_counter()
        clock.sleep(3600.0)
        out += [clock.time(), time.perf_counter() - wall0 < 5.0]
        return out

    assert both(script) == [5000.0, 5120.0, True, True, 5180.0, True,
                            8780.0, True]


def test_event_trace_digests_and_dumps(tmp_path):
    def script(m):
        a, b = m.trace.EventTrace(), m.trace.EventTrace()
        a.add("fault", method="m", error="timeout")
        a.add("round", n=0, t=1.5, nested={"k": [1, 2]})
        b.add("round", n=0, t=1.5, nested={"k": [1, 2]})
        b.add("fault", method="m", error="timeout")
        path = a.dump(tmp_path / m.pkg / "trace.jsonl")
        return (a.digest(), b.digest(), len(a), a.of_kind("fault"),
                path.read_text())

    digest_a, digest_b, *_ = both(script)
    assert digest_a != digest_b


def test_profile_registry_names_and_fields_equal():
    def script(m):
        reg = {}
        for kind in ("PROFILES", "FIXTURE_PROFILES"):
            reg[kind] = {name: dataclasses.asdict(p) for name, p in
                         getattr(m.profile, kind).items()}
        p = m.profile.ChaosProfile(
            name="t", error_rates={"*": 0.1, "get_instance": 0.5},
            latency={"*": (0.0, 1.0)})
        get = m.profile.get_profile
        with pytest.raises(KeyError):
            get("no-such-profile")
        return (reg, p.rate_for("get_instance"), p.rate_for("list"),
                p.latency_for("x"), get("calm").name,
                get("broken-ring").fixture)

    reg, *_ = both(script)
    assert len(reg["PROFILES"]) >= 5
    assert {"broken-fixture", "broken-affinity-fixture", "broken-ring"} <= \
        set(reg["FIXTURE_PROFILES"])


# ---------------------------------------------------------------------------
# ChaosCloud
# ---------------------------------------------------------------------------

def cloud_rate_one(m):
    chaos = m.cloud.ChaosCloud(
        m.fake.FakeCloud(),
        m.profile.ChaosProfile(name="t", error_rates={"*": 1.0},
                               error_kinds=(("rate_limited", 1.0),)),
        random.Random(7))
    unarmed = len(chaos.list_zones())
    chaos.arm()
    with pytest.raises(m.errors.CloudError) as ei:
        chaos.list_instances()
    return (unarmed, ei.value.status_code, ei.value.retry_after > 0,
            chaos.trace.of_kind("fault"))


def cloud_schedule(m):
    def schedule(seed):
        chaos = m.cloud.ChaosCloud(
            m.fake.FakeCloud(),
            m.profile.ChaosProfile(name="t", error_rates={"*": 0.5}),
            random.Random(seed))
        chaos.arm()
        out = []
        for _ in range(30):
            try:
                chaos.list_zones()
                out.append("ok")
            except m.errors.CloudError as e:
                out.append(e.status_code)
        return out, chaos.trace.digest()

    return schedule(3), schedule(4)


def cloud_partial_list(m):
    fake = m.fake.FakeCloud()
    sub = fake.list_subnets()[0].id
    for i in range(6):
        fake.create_instance(name=f"i{i}", profile="bx2-4x16",
                             zone="us-south-1", subnet_id=sub,
                             image_id="img-1")
    chaos = m.cloud.ChaosCloud(
        fake, m.profile.ChaosProfile(name="t", partial_list_rate=1.0),
        random.Random(1))
    chaos.arm()
    full = [i.name for i in fake.list_instances()]
    got = [i.name for i in chaos.list_instances()]
    return full, got, chaos.trace.of_kind("fault")


def cloud_leaked_create(m):
    fake = m.fake.FakeCloud()
    chaos = m.cloud.ChaosCloud(
        fake, m.profile.ChaosProfile(name="t", create_leak_rate=1.0),
        random.Random(1))
    chaos.arm()
    with pytest.raises(m.errors.CloudError) as ei:
        chaos.create_instance(name="leak", profile="bx2-4x16",
                              zone="us-south-1",
                              subnet_id=fake.list_subnets()[0].id,
                              image_id="img-1",
                              tags=dict(m.actuator.KARPENTER_TAGS))
    return (ei.value.status_code, str(ei.value), fake.instance_count(),
            chaos.trace.of_kind("fault"))


def cloud_latency(m):
    clock = m.clock.VirtualClock()
    t0 = clock.time()
    chaos = m.cloud.ChaosCloud(
        m.fake.FakeCloud(),
        m.profile.ChaosProfile(name="t", latency={"*": (1.0, 2.0)}),
        random.Random(1), clock=clock)
    chaos.arm()
    chaos.list_zones()
    chaos.list_instances()
    return clock.time() - t0, chaos.trace.of_kind("latency")


def cloud_preempt_storm(m):
    fake = m.fake.FakeCloud()
    inst = fake.create_instance(
        name="spot0", profile="bx2-4x16", zone="us-south-1",
        subnet_id=fake.list_subnets()[0].id, image_id="img-1",
        capacity_type="spot")
    chaos = m.cloud.ChaosCloud(
        fake, m.profile.ChaosProfile(name="t", preempt_storm_rate=1.0,
                                     preempt_storm_frac=1.0),
        random.Random(1))
    chaos.arm()
    chaos.tick()
    hit = fake.get_instance(inst.id)
    return (hit.status, hit.status_reason,
            [{k: v for k, v in e.items() if k != "ids"}
             for e in chaos.trace.of_kind("storm")])


def cloud_blackouts(m):
    fake = m.fake.FakeCloud()
    chaos = m.cloud.ChaosCloud(
        fake, m.profile.ChaosProfile(name="t", capacity_blackout_rate=1.0,
                                     capacity_blackout_rounds=2),
        random.Random(1))
    chaos.arm()
    chaos.tick()
    out = [sorted(fake.capacity_limits.items())]
    chaos.profile = m.profile.ChaosProfile(name="t",
                                           capacity_blackout_rate=0.0)
    chaos.tick()
    chaos.tick()
    out.append(sorted(fake.capacity_limits.items()))
    chaos.profile = m.profile.ChaosProfile(
        name="t", capacity_blackout_rate=1.0, capacity_blackout_rounds=99)
    chaos.tick()
    out.append(sorted(fake.capacity_limits.items()))
    chaos.disarm()
    out += [sorted(fake.capacity_limits.items()), len(chaos.list_zones()),
            chaos.trace.digest()]
    return out


def cloud_make_error(m):
    rng = random.Random(0)
    out = {kind: (lambda e: (e.status_code, str(e)))(
        m.cloud.make_error(kind, "m", rng))
        for kind in ("rate_limited", "internal", "unavailable", "timeout",
                     "conflict", "not_found")}
    with pytest.raises(ValueError):
        m.cloud.make_error("alien", "m", rng)
    return out


@pytest.mark.parametrize("script", [
    cloud_rate_one, cloud_schedule, cloud_partial_list, cloud_leaked_create,
    cloud_latency, cloud_preempt_storm, cloud_blackouts, cloud_make_error],
    ids=lambda f: f.__name__)
def test_chaos_cloud_injects_as_the_reference(script):
    both(script)


# ---------------------------------------------------------------------------
# The chaos solver wrappers
# ---------------------------------------------------------------------------

def catalog_of(m):
    cloud = m.fake.FakeCloud()
    pricing = m.catalog.PricingProvider(cloud)
    itp = m.catalog.InstanceTypeProvider(cloud, pricing,
                                         m.catalog.UnavailableOfferings())
    cat = m.catalog.CatalogArrays.build(itp.list())
    pricing.close()
    return cat


def request_of(m, n_pods=3):
    pods = m.pod.make_pods(n_pods, requests=m.pod.ResourceRequests(
        500, 1024, 0, 1))
    return m.types.SolveRequest(pods=pods, catalog=catalog_of(m))


class _Static:
    def __init__(self, plan, m):
        self.plan = plan
        self.options = m.types.SolverOptions(backend="greedy")

    def solve(self, request):
        return self.plan


def test_unstable_solver_draws_the_reference_schedule():
    def script(m):
        req = request_of(m)
        trace = m.trace.EventTrace()
        s = m.solver.UnstableSolver(
            m.greedy.GreedySolver(m.types.SolverOptions(backend="greedy")),
            random.Random(5), failure_rate=0.5, trace=trace)
        out = []
        for _ in range(12):
            try:
                plan = s.solve(req)
                out.append(("ok", len(plan.nodes)))
            except Exception as e:  # noqa: BLE001 — the injected failure
                out.append((type(e).__name__, str(e)))
        return out, trace.digest()

    out, _ = both(script)
    assert {o[0] for o in out} >= {"ok"} and len({o[0] for o in out}) == 2


def validating_script(use_native):
    """Both packages' ``ValidatingSolver`` on a garbage plan, then on the
    greedy oracle with ``use_native``: the trace holds its backend."""
    def script(m):
        req = request_of(m, n_pods=2)
        garbage = m.types.Plan(nodes=[], unplaced_pods=[],
                               total_cost_per_hour=0.0)
        trace = m.trace.EventTrace()
        v = m.solver.ValidatingSolver(_Static(garbage, m), trace=trace)
        v.solve(req)
        good = m.solver.ValidatingSolver(m.greedy.GreedySolver(
            m.types.SolverOptions(backend="greedy", use_native=use_native)),
            trace=trace)
        plan = good.solve(req)
        return (list(v.violations), list(v.explain_violations),
                list(good.violations), len(plan.nodes), plan.backend,
                trace.digest())

    return script


def test_validating_solver_accumulates_the_reference_violations():
    violations, *_ = both(validating_script(native_pin()))
    assert violations


def test_validating_solver_matches_with_the_reference_native_failed(
        monkeypatch):
    """A worker whose reference build raced holds ``_load_failed``: both
    packages then take the python greedy and agree."""
    import karpenter_tpu.native as j_native

    j_native.load()
    monkeypatch.setattr(j_native, "_lib", None)
    monkeypatch.setattr(j_native, "_load_failed", True)
    pin = native_pin()
    assert pin == "off"
    violations, *rest = both(validating_script(pin))
    assert violations and rest[-2] == "greedy"


# ---------------------------------------------------------------------------
# The invariant checker on hand-made snapshots
# ---------------------------------------------------------------------------

def checker_rig(m):
    cloud = m.fake.FakeCloud()
    pricing = m.catalog.PricingProvider(cloud)
    unavail = m.catalog.UnavailableOfferings()
    itp = m.catalog.InstanceTypeProvider(cloud, pricing, unavail)
    cluster = m.cluster.ClusterState()
    checker = m.inv.InvariantChecker(cluster, cloud, unavail,
                                     orphan_grace=300.0,
                                     stuck_claim_grace=900.0)
    return types.SimpleNamespace(cloud=cloud, pricing=pricing,
                                 unavail=unavail, itp=itp, cluster=cluster,
                                 checker=checker)


def orphan(m, r, tags, age):
    inst = r.cloud.create_instance(
        name="x", profile="bx2-4x16", zone="us-south-1",
        subnet_id=r.cloud.list_subnets()[0].id, image_id="img-1", tags=tags)
    r.cloud.instances[inst.id].created_at = time.time() - age
    return inst


def rendered(violations):
    return [(v.invariant, v.render()) for v in violations]


def inv_orphans(m, r):
    tags = dict(m.actuator.KARPENTER_TAGS)
    orphan(m, r, {"owner": "someone-else"}, age=10**6)
    orphan(m, r, tags, age=10.0)                 # within grace
    young = rendered(r.checker.check_round())
    stale = orphan(m, r, tags, age=1000)
    kinds = [v[0] for v in rendered(r.checker.check_round())]
    r.cluster.add_nodeclaim(m.nodeclaim.NodeClaim(
        name="c0", provider_id=m.nodeclaim.provider_id("us-south",
                                                       stale.id)))
    return young, kinds, rendered(r.checker.check_round())


def inv_stuck_claim(m, r):
    claim = m.nodeclaim.NodeClaim(name="stuck", launched=True)
    claim.created_at = time.time() - 1000
    r.cluster.add_nodeclaim(claim)
    first = rendered(r.checker.check_round())
    claim.initialized = True
    return first, rendered(r.checker.check_round())


def inv_solver_drained(m, r):
    r.checker.solver_violations.append("pod double-placed")
    return rendered(r.checker.check_round()), \
        rendered(r.checker.check_round())


def inv_blackout_final(m, r):
    r.unavail.mark_unavailable("bx2-4x16", "us-south-1", "spot", ttl=10**9)
    return [v[0] for v in rendered(r.checker.check_final())]


def inv_pods_resolve(m, r):
    catalog = m.catalog.CatalogArrays.build(r.itp.list())
    placeable, = m.pod.make_pods(1, name_prefix="small",
                                 requests=m.pod.ResourceRequests(
                                     500, 512, 0, 1))
    impossible, = m.pod.make_pods(1, name_prefix="huge",
                                  requests=m.pod.ResourceRequests(
                                      10**9, 10**9, 0, 1))
    r.cluster.add_pod(placeable)
    r.cluster.add_pod(impossible)
    return rendered(r.checker.check_final(catalog))


@pytest.mark.parametrize("script", [
    inv_orphans, inv_stuck_claim, inv_solver_drained, inv_blackout_final,
    inv_pods_resolve], ids=lambda f: f.__name__)
def test_invariant_checker_judges_as_the_reference(script):
    def run(m):
        r = checker_rig(m)
        try:
            return script(m, r)
        finally:
            r.pricing.close()

    out = both(run)
    assert out, "the script judged nothing"
