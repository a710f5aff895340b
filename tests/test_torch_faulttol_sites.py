"""The port's fault plane at the solver's dispatch sites, against the
reference, on the CPU (helpers and fixtures from
``tests/test_torch_faulttol.py``):

- devtel parity: the same windows through ``JaxSolver`` and
  ``TorchSolver(device="cpu")`` give equal counts and signatures;
- the batch's OOM halving: plans equal the unchunked port's and the
  reference's batch plans, the cost word bit for bit;
- every dispatch site of the port reached once on the CPU, under the
  reference's kernel name, with a probe and a devtel note;
- the AOT manifest read across packages, and ``warmup_solver``.
"""

from __future__ import annotations

import numpy as np
import pytest

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu.obs import devtel as j_devtel
from karpenter_tpu.resident.aot import AOTExecutableCache as JAOTCache
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
import karpenter_tpu_torch.faulttol as tft
from karpenter_tpu_torch import cuda_build, workload
from karpenter_tpu_torch.obs import devtel as t_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.resident.aot import AOTExecutableCache
from karpenter_tpu_torch.solver import (
    SolverOptions as TSolverOptions, TorchSolver,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.warmup import warmup_solver
from tests.test_torch_batch import jcatalog, tcatalog  # noqa: F401
from tests.test_torch_faulttol import (  # noqa: F401
    FakeClock, Recorder, ScriptedInjector, _pristine_faulttol,
    _reference_observability_untouched, make_board,
)
from tests.test_torch_solver import (
    assert_plans_equal, build_pods, mixed_specs,
)


# -- devtel parity ------------------------------------------------------------

DEVTEL_FIELDS = ("dispatches", "recompiles", "executable_cache_hits",
                 "h2d_bytes", "d2h_bytes", "explain_d2h_bytes",
                 "telemetry_d2h_bytes", "catalog_uploads",
                 "catalog_upload_bytes", "donation_misses")


def _norm_signatures(tel):
    return sorted((k, tuple(int(v) for v in sig))
                  for k, sig in tel._signatures)


def pref_pods(mod, req, zone, n=40):
    return [mod.PodSpec(
        f"p{i}", requests=mod.ResourceRequests(500, 1024, 0, 1),
        preferred_requirements=((100, req.Requirement(
            req.LABEL_ZONE, req.Operator.IN, (zone,))),))
        for i in range(n)]


def test_devtel_counts_match_the_reference(jcatalog, tcatalog,  # noqa: F811
                                           monkeypatch):
    jtel, ttel = j_devtel.DeviceTelemetry(), t_devtel.DeviceTelemetry()
    monkeypatch.setattr(j_devtel, "DEVTEL", jtel)
    monkeypatch.setattr(t_devtel, "DEVTEL", ttel)
    js = JaxSolver(SolverOptions(use_pallas="off"))
    ts = TorchSolver(TSolverOptions(), device="cpu")
    per_side = {}
    for side, pod_mod, req_mod, cat, enc, solver in (
            ("ref", j_pod, j_req, jcatalog, encode, js),
            ("port", t_pod, t_req, tcatalog, t_encode, ts)):
        a = enc(build_pods(mixed_specs(24, 1), pod_mod, req_mod), cat)
        b = enc(build_pods(mixed_specs(90, 2), pod_mod, req_mod), cat)
        pref = enc(pref_pods(pod_mod, req_mod, cat.zones[1]), cat)
        batch = [enc(build_pods(mixed_specs(30, s), pod_mod, req_mod), cat)
                 for s in (3, 4)]
        plans = [solver.solve_encoded(p) for p in (a, b, a, pref)]
        plans += solver.solve_encoded_batch(batch)
        per_side[side] = plans
    for jp, tp in zip(per_side["ref"], per_side["port"]):
        assert_plans_equal(jp, tp)
    js_snap, ts_snap = jtel.snapshot(), ttel.snapshot()
    assert {f: ts_snap[f] for f in DEVTEL_FIELDS} == \
        {f: js_snap[f] for f in DEVTEL_FIELDS}
    assert _norm_signatures(ttel) == _norm_signatures(jtel)
    kernels = {k for k, _ in _norm_signatures(ttel)}
    assert kernels == {"scan", "scan-pref", "scan-batch"}
    assert ts_snap["recompiles"] >= 4 and ts_snap["executable_cache_hits"] \
        >= 1


# -- the batch's OOM halving ---------------------------------------------------

@pytest.mark.parametrize("script", [["oom"], ["oom", "oom"]])
def test_oom_halves_the_batch_on_the_device(jcatalog, tcatalog,  # noqa: F811
                                            script):
    """An out-of-memory batch (``DeviceResourceExhausted``) is halved
    and each half solved on the same device: the plans equal the
    unchunked port's and the reference's batch plans, cost word
    included, bit for bit."""
    specs = [mixed_specs(40, s) for s in (11, 12, 13, 14)]
    jprobs = [encode(build_pods(s, j_pod, j_req), jcatalog) for s in specs]
    tprobs = [t_encode(build_pods(s, t_pod, t_req), tcatalog)
              for s in specs]
    make_board("port", FakeClock())
    ts = TorchSolver(TSolverOptions(), device="cpu")
    want_port = ts.solve_encoded_batch(tprobs)
    want_ref = JaxSolver(SolverOptions(use_pallas="off")) \
        .solve_encoded_batch(jprobs)
    inj = ScriptedInjector(script)
    tft.install_injector(inj)
    got = TorchSolver(TSolverOptions(), device="cpu") \
        .solve_encoded_batch(tprobs)
    tft.clear_injector()
    assert inj.injected == len(script)
    assert len(got) == len(tprobs)
    for g, wp, wr in zip(got, want_port, want_ref):
        assert_plans_equal(wp, g)
        assert_plans_equal(wr, g)
        assert np.float32(g.total_cost_per_hour).view(np.int32) == \
            np.float32(wr.total_cost_per_hour).view(np.int32)
    board = tft.get_health_board()
    assert board.faults_recorded == len(script)


def test_oom_of_a_single_problem_raises(tcatalog):  # noqa: F811
    make_board("port", FakeClock())
    p = t_encode(build_pods(mixed_specs(20, 5), t_pod, t_req), tcatalog)
    tft.install_injector(ScriptedInjector(["oom"]))
    with pytest.raises(tft.DeviceResourceExhausted):
        TorchSolver(TSolverOptions(), device="cpu").solve_encoded_batch([p])


def test_fault_in_a_window_raises_and_falls_back_nowhere(tcatalog):  # noqa: F811,E501
    make_board("port", FakeClock())
    p = t_encode(build_pods(mixed_specs(20, 6), t_pod, t_req), tcatalog)
    tft.install_injector(ScriptedInjector(["error"]))
    with pytest.raises(tft.DeviceFaultError):
        TorchSolver(TSolverOptions(), device="cpu").solve_encoded(p)


# -- every dispatch site -------------------------------------------------------

def _site_scan(cat):
    ts = TorchSolver(device="cpu")
    ts.solve_encoded(t_encode(build_pods(mixed_specs(20, 1), t_pod, t_req),
                              cat))


def _site_pref(cat):
    TorchSolver(device="cpu").solve_encoded(
        t_encode(pref_pods(t_pod, t_req, cat.zones[1]), cat))


def _site_stochastic(cat):
    from tests.test_torch_stochastic import t_pool

    TorchSolver(device="cpu").solve_encoded(
        t_encode(workload.stochastic_pods(60, seed=3), cat, t_pool()))


def _site_affinity(cat):
    pods = workload.affinity_bench_pods(
        "ap0", 120, np.random.RandomState(190), services=4, spread_sets=2)
    prob = t_encode(pods, cat)
    assert prob.aff is not None and prob.aff.device_armed
    TorchSolver(device="cpu").solve_encoded(prob)


def _site_resident(cat):
    from karpenter_tpu_torch.resident.store import ResidentBuffer

    ts = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    p = t_encode(build_pods(mixed_specs(20, 1), t_pod, t_req), cat)
    ts.solve_encoded(p)
    buf = ResidentBuffer()
    host = np.arange(64, dtype=np.int32)
    buf.update(host, "cpu")
    host[3] = 99
    buf.update(host, "cpu")


def _site_batch(cat):
    ts = TorchSolver(device="cpu")
    probs = [t_encode(build_pods(mixed_specs(20, s), t_pod, t_req), cat)
             for s in (1, 2, 3, 4)]
    ts.solve_encoded_batch(probs[:2])
    list(ts.solve_stream(probs, depth=4, batch=2))


def _site_serving(cat):
    ts = TorchSolver(TSolverOptions(serving="on"), device="cpu")
    specs = [mixed_specs(20, 1), mixed_specs(20, 1), mixed_specs(21, 1)]
    list(ts.serve_stream([t_encode(build_pods(s, t_pod, t_req), cat)
                          for s in specs]))


def _site_fleet(cat):
    from karpenter_tpu_torch.parallel.fleet import (
        CooCapacity, fleet_solve_packed,
    )
    from karpenter_tpu_torch.resident.store import ResidentBuffer
    from tests.test_torch_fleet import build_fleet

    _, problem = build_fleet(C=2, pods_per=30)
    buf = ResidentBuffer("fleet")
    fleet_solve_packed(problem, num_nodes=128, device="cpu",
                       resident_buf=buf)
    problem.group_count[1, 0] += 1
    fleet_solve_packed(problem, num_nodes=128, device="cpu",
                       resident_buf=buf, coo_state=CooCapacity(8, 4096))


def _site_whatif(cat):
    from karpenter_tpu_torch.whatif import (
        Scenario, WhatIfPlanner, build_baseline,
    )
    from karpenter_tpu_torch.whatif import scenario as t_scenario
    from tests.test_torch_whatif import build_menu

    pods, wcat = workload.build_workload(200, 20, seed=3)
    base = build_baseline(pods, wcat)
    WhatIfPlanner(device="cpu").plan(
        base, build_menu(t_scenario, Scenario, base, wcat, 5))


def _site_gang(cat):
    from karpenter_tpu_torch.apis import podgroup as t_pg
    from karpenter_tpu_torch.gang import GangOptions, GangPlanner, encode_gangs
    from tests.test_torch_gang import (
        accel_catalog, build_pods as gang_pods, gang_specs, port_catalog,
    )

    tcat = port_catalog(accel_catalog(20))
    specs = gang_specs(6, 4, 1)
    planner = GangPlanner(GangOptions(use_device="on"), device="cpu")
    planner.plan(encode_gangs(gang_pods(specs, t_pod, t_pg), tcat))
    assert planner.device_steps > 0


def _site_preempt(cat):
    import bench
    from karpenter_tpu_torch import carry
    from karpenter_tpu_torch.apis import nodeclaim as t_nc
    from karpenter_tpu_torch.core import cluster as t_cl
    from karpenter_tpu_torch.preempt import (
        PlannerOptions, PreemptionPlanner, encode_victims,
    )
    from tests.test_torch_preempt import build_side, overload_records

    jcat = bench.build_catalog(20)
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})
    rec = overload_records(jcat, 20, 80, 1)
    tcl, tpods = build_side(rec, t_pod, t_nc, t_cl)
    planner = PreemptionPlanner(PlannerOptions(use_device="on",
                                               max_evictions=60),
                                device="cpu")
    planner.plan(t_encode(tpods, tcat), encode_victims(tcl, tcat))
    assert planner.device_steps > 0


def _site_repack(cat):
    from karpenter_tpu.catalog import (
        CatalogArrays, InstanceTypeProvider, PricingProvider,
    )
    from karpenter_tpu.cloud.fake import FakeCloud, generate_profiles
    from karpenter_tpu_torch.repack import RepackOptions, RepackPlanner
    from karpenter_tpu_torch.repack.encode import encode_repack
    from karpenter_tpu_torch.resident.store import (
        OccupancySnapshot, ResidentStore,
    )
    from tests.test_torch_repack import carried, random_fleet

    cloud = FakeCloud(profiles=generate_profiles(
        24, families=("gx3", "bx2", "cx2")))
    pricing = PricingProvider(cloud)
    try:
        jcat = CatalogArrays.build(InstanceTypeProvider(cloud,
                                                        pricing).list())
    finally:
        pricing.close()
    tcat = carried(jcat)
    _, tcl = random_fleet(3).both()
    store = ResidentStore(device="cpu")
    encode_repack(tcl, tcat, snapshot=OccupancySnapshot(tcl), store=store)
    # one more pod on a claim: the occupancy rows move by a delta
    claim = next(c for c in tcl.nodeclaims()
                 if c.launched and not c.deleted)
    tcl.add_pod(t_pod.PodSpec("extra", requests=t_pod.ResourceRequests(
        100, 128, 0, 1)))
    tcl.bind_pod("default/extra", claim.node_name)
    prob = encode_repack(tcl, tcat, snapshot=OccupancySnapshot(tcl),
                         store=store)
    planner = RepackPlanner(RepackOptions(use_device="on"), device="cpu")
    planner.plan(prob)
    assert planner.device_steps > 0


def _site_sharded(cat):
    from karpenter_tpu_torch.sharded.service import ShardedSolveService

    svc = ShardedSolveService(2, device="cpu")
    rng = np.random.RandomState(4)
    pods = [t_pod.PodSpec(f"s-{i}", requests=t_pod.ResourceRequests(
        int(rng.randint(100, 900)), int(rng.randint(256, 2048)), 0, 1))
        for i in range(30)]
    svc.admit(pods)
    svc.solve_window(cat)
    svc.rebalance()


SITES = {
    "scan": (_site_scan, {"scan"}),
    "scan-pref": (_site_pref, {"scan-pref"}),
    "stochastic": (_site_stochastic, {"stochastic"}),
    "affinity": (_site_affinity, {"affinity"}),
    "resident": (_site_resident, {"resident", "resident-update"}),
    "scan-batch": (_site_batch, {"scan-batch"}),
    "serving": (_site_serving, {"serving-kick", "serving-fetch"}),
    "fleet": (_site_fleet, {"fleet-pallas", "fleet-resident"}),
    "whatif": (_site_whatif, {"whatif"}),
    "gang": (_site_gang, {"gang-grid"}),
    "preempt": (_site_preempt, {"preempt-grid"}),
    "repack": (_site_repack, {"repack-grid", "resident-occupancy"}),
    "sharded": (_site_sharded, {"sharded-solve", "sharded-fetch",
                                "rebalance"}),
}
# fetch sites share their dispatch's devtel note, and the sharded fetch
# has no profiler bracket, as in the reference
FETCH_ONLY = {"serving-fetch", "sharded-fetch"}
UNPROBED = {"sharded-fetch"}


@pytest.mark.parametrize("site", list(SITES))
def test_every_site_is_guarded_probed_and_noted(site, tcatalog,  # noqa: F811
                                                monkeypatch):
    from karpenter_tpu_torch.obs.prof import DeviceProfiler

    drive, want = SITES[site]
    make_board("port", FakeClock())
    tel = t_devtel.DeviceTelemetry()
    monkeypatch.setattr(t_devtel, "DEVTEL", tel)
    prof = DeviceProfiler(interval=1)
    monkeypatch.setattr("karpenter_tpu_torch.obs.prof._PROFILER", prof)
    rec = Recorder()
    tft.install_injector(rec)
    drive(tcatalog)
    assert want <= set(rec.kernels), rec.kernels
    assert rec.devices == {"cpu:0"}
    assert want - UNPROBED <= set(prof._counts)
    noted = {k for k, _ in tel._signatures}
    assert want - FETCH_ONLY <= noted, noted
    assert tft.get_health_board().snapshot()["guards_entered"] == \
        len(rec.kernels)


# -- AOT manifest and warmup ---------------------------------------------------

def test_aot_manifest_reads_across_packages(tmp_path, tcatalog):  # noqa: F811
    sigs = [("scan", (64, 128, 4, 128, 0, True, False, True)),
            ("scan-batch", (64, 128, 4, 128, 2, 0, True, False, True)),
            ("resident", (64, 128, 4, 128, 64, 0, True, False, True)),
            ("pallas", (64, 128, 4, 128, 0, True, False, True)),
            ("whatif", (3, 64, 64, 128, 4, 128, 0, False, True))]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    jcache, tcache = JAOTCache(str(ref_dir)), AOTExecutableCache(
        str(port_dir))
    for k, s in sigs:
        jcache.record(k, s)
        tcache.record(k, s)
    assert (ref_dir / "aot_manifest.json").read_text() == \
        (port_dir / "aot_manifest.json").read_text()
    assert AOTExecutableCache(str(ref_dir)).entries() == jcache.entries()
    assert JAOTCache(str(port_dir)).entries() == tcache.entries()
    make_board("port", FakeClock())
    rec = Recorder()
    tft.install_injector(rec)
    out = AOTExecutableCache(str(ref_dir)).prewarm(
        TorchSolver(device="cpu"), tcatalog)
    # scan, scan-batch, resident and pallas (on the FFD route) replay;
    # the what-if entry has no replayer
    assert (out["warmed"], out["skipped"]) == (4, 1)
    assert rec.kernels.count("scan") == 2 and "scan-batch" in rec.kernels


def test_warmup_marks_the_ladder_seen(tcatalog, monkeypatch):  # noqa: F811
    tel = t_devtel.DeviceTelemetry()
    monkeypatch.setattr(t_devtel, "DEVTEL", tel)
    make_board("port", FakeClock())
    ts = TorchSolver(device="cpu")
    p = t_encode(build_pods(mixed_specs(30, 8), t_pod, t_req), tcatalog)
    prep = ts._prepare(p)
    total = int(p.group_count.sum())
    assert warmup_solver(ts, tcatalog) == 0      # the CPU: catalog only
    assert tel.snapshot()["dispatches"] == 0
    n = warmup_solver(ts, tcatalog, shapes=[
        (prep.G_pad, prep.U_pad, prep.N, total)], batch_widths=(2,),
        force=True)
    assert n == 2
    warm = tel.snapshot()
    assert warm["recompiles"] == 2
    ts.solve_encoded(p)
    after = tel.snapshot()
    assert after["recompiles"] == warm["recompiles"]
    assert after["executable_cache_hits"] == warm["executable_cache_hits"] \
        + 1


def test_build_dir_names_the_warm_restart_directory(tmp_path, monkeypatch):
    from karpenter_tpu_torch.solver.warmup import (
        enable_persistent_compile_cache,
    )

    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setenv("KARPENTER_TPU_COMPILE_CACHE", str(tmp_path / "k"))
    d = enable_persistent_compile_cache()
    assert d == str((tmp_path / "k").resolve())
    assert cuda_build.library_path("ffd_scan").parent == tmp_path / "k"
    assert get_profiler() is get_profiler()
