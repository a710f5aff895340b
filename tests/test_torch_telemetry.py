"""The port's telemetry recording against the reference's.

After every solve the reference decodes the result's telemetry block
and records it (``obs/telemetry_words.decode_and_record``): the
``solve_quality_*`` metric families, the flight recorder's telemetry
ring and the watchdog's quality detector.  The same windows go through
``JaxSolver`` and ``TorchSolver(device="cpu")`` (single windows, the
pending result, node escalation, the zone-candidate batch, the stream,
the serving loop, the pref / affinity / stochastic / resident routes),
through both what-if planners and both sharded services (with the
rebalance skew stamped into later windows); the ring, the metric
samples, ``summary()`` and the watchdog's quality counts must be equal.
A buffer without the telemetry suffix records nothing in both.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import bench
import karpenter_tpu.apis.pod as j_pod
from karpenter_tpu import obs as j_obs
from karpenter_tpu.obs import telemetry_words as j_tw
from karpenter_tpu.obs import watchdog as j_wd
from karpenter_tpu.parallel.mesh import shard_mesh
from karpenter_tpu.sharded import ShardedSolveService as JShardedSolveService
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.utils import metrics as j_metrics
from karpenter_tpu.whatif import Scenario as JScenario
from karpenter_tpu.whatif import WhatIfPlanner as JWhatIfPlanner
from karpenter_tpu.whatif import build_baseline as j_build_baseline
from karpenter_tpu.whatif import scenario as j_scenario

import karpenter_tpu_torch.apis.pod as t_pod
from karpenter_tpu_torch import obs as t_obs
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.obs import telemetry_words as t_tw
from karpenter_tpu_torch.obs import watchdog as t_wd
from karpenter_tpu_torch.sharded.service import ShardedSolveService
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.utils import metrics as t_metrics
from karpenter_tpu_torch.whatif import Scenario, WhatIfPlanner
from karpenter_tpu_torch.whatif import build_baseline
from karpenter_tpu_torch.whatif import scenario as t_scenario

from tests.test_torch_sharded import churn, stream_pods
from tests.test_torch_solver import (  # noqa: F401 (fixtures)
    _route_windows, assert_plans_equal, both, jcatalog, mixed_specs,
    tcatalog,
)
from tests.test_torch_whatif import build_menu

FAMILIES = ("SOLVE_QUALITY_FILL", "SOLVE_QUALITY_SLACK",
            "SOLVE_QUALITY_COUNT", "SOLVE_QUALITY_WINDOWS",
            "SOLVE_QUALITY_ESCALATIONS")
SIDES = {"j": (j_obs, j_tw, j_wd, j_metrics),
         "t": (t_obs, t_tw, t_wd, t_metrics)}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Each package starts with an empty ring, fresh metric families, a
    fresh watchdog and no rebalance skew; afterwards both get back the
    recorder and the series they had, so a later test of the same
    worker reads only its own."""
    saved = []
    for obs_mod, tw, wd, metrics in SIDES.values():
        fams = [getattr(metrics, f) for f in FAMILIES + ("SHARD_BACKLOG",)]
        saved.append((obs_mod, obs_mod.get_tracer().recorder,
                      [(fam, fam.samples()) for fam in fams]))
        obs_mod.reset_recorder()
        for fam in fams:
            fam.reset()
        monkeypatch.setattr(wd, "_WATCHDOG", wd.Watchdog())
        monkeypatch.setattr(tw, "_LAST_REBALANCE_SKEW", 0)
    yield
    for obs_mod, recorder, series in saved:
        obs_mod.get_tracer().recorder = recorder
        for fam, samples in series:
            fam.reset()
            for labels, value in samples.items():
                fam.labels(*labels).set(value)


def state(side):
    obs_mod, tw, wd, metrics = SIDES[side]
    dog = wd.get_watchdog()
    return {
        "ring": obs_mod.get_recorder().telemetry(),
        "samples": {f: getattr(metrics, f).samples() for f in FAMILIES},
        "summary": tw.summary(),
        "quality": {p: (b.n, b.mean, b.dev)
                    for p, b in dog._quality.items()},
        "escalation_events": len(dog._escalations),
        "breaches": dog.breaches,
    }


def assert_recorded_equal(windows, planes):
    """Both packages recorded ``windows`` windows, on ``planes``, equal
    in every observable."""
    ref, port = state("j"), state("t")
    assert len(port["ring"]) == windows
    assert {e["plane"] for e in port["ring"]} == set(planes)
    for key in ref:
        assert port[key] == ref[key], key
    return port


def jax_solver(**kw):
    return JaxSolver(SolverOptions(use_pallas="off", **kw))


def torch_solver(**kw):
    return TorchSolver(TSolverOptions(**kw), device="cpu")


def test_single_windows_and_pending_result(jcatalog, tcatalog):
    js, ts = jax_solver(), torch_solver()
    for seed in (0, 1, 2):
        jpods, tpods = both(mixed_specs(150, seed))
        jp, tp = encode(jpods, jcatalog), t_encode(tpods, tcatalog)
        assert_plans_equal(js.solve_encoded(jp), ts.solve_encoded(tp))
        assert_plans_equal(js.solve_encoded_async(jp).result(),
                           ts.solve_encoded_async(tp).result())
    port = assert_recorded_equal(6, {"scan"})
    assert port["samples"]["SOLVE_QUALITY_WINDOWS"] == {("scan",): 6.0}
    assert ts.last_stats["telemetry"] == port["ring"][-1]
    assert port["summary"]["planes"]["scan"]["windows"] == 6


def test_node_escalation_counts(jcatalog, tcatalog, monkeypatch):
    monkeypatch.setattr(JaxSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    monkeypatch.setattr(TorchSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    jpods, tpods = both(mixed_specs(600, 12))
    jax_solver().solve_encoded(encode(jpods, jcatalog))
    torch_solver().solve_encoded(t_encode(tpods, tcatalog))
    port = assert_recorded_equal(1, {"scan"})
    assert port["ring"][0]["escalations"] >= 1
    assert port["escalation_events"] >= 1


def test_batch_stream_and_serving(jcatalog, tcatalog):
    specs = [mixed_specs(120, s) for s in (31, 32, 33)]
    jprobs = [encode(both(s)[0], jcatalog) for s in specs]
    tprobs = [t_encode(both(s)[1], tcatalog) for s in specs]
    js, ts = jax_solver(), torch_solver()
    for a, b in zip(js.solve_encoded_batch(jprobs),
                    ts.solve_encoded_batch(tprobs)):
        assert_plans_equal(a, b)
    for a, b in zip(js.solve_stream(iter(jprobs * 2), depth=8, batch=4),
                    ts.solve_stream(iter(tprobs * 2), depth=8, batch=4)):
        assert_plans_equal(a, b)
    jserve, tserve = jax_solver(serving="on"), torch_solver(serving="on")
    for a, b in zip(jserve.serve_stream(jprobs[:2]),
                    tserve.serve_stream(tprobs[:2])):
        assert_plans_equal(a, b)
    assert_recorded_equal(11, {"scan-batch", "serving"})


@pytest.mark.parametrize("route", ["preferences", "affinity", "stochastic"])
def test_route_windows_carry_the_route_plane(jcatalog, tcatalog, route):
    windows = _route_windows(jcatalog, tcatalog)
    jargs, _ = windows["j"][route]
    targs, _ = windows["t"][route]
    jax_solver().solve_encoded(encode(*jargs))
    ts = torch_solver()
    ts.solve_encoded(t_encode(*targs))
    plane = {"preferences": "scan-pref"}.get(route, route)
    assert_recorded_equal(1, {plane})


def test_resident_windows(jcatalog, tcatalog):
    jpods, tpods = both(mixed_specs(120, 4))
    jp, tp = encode(jpods, jcatalog), t_encode(tpods, tcatalog)
    js, ts = jax_solver(resident="on"), torch_solver(resident="on")
    for _ in range(2):
        assert_plans_equal(js.solve_encoded(jp), ts.solve_encoded(tp))
    assert_recorded_equal(2, {"resident"})


def test_whatif_scenarios_record_their_delta_words():
    jpods, jcat = bench.build_workload(300, 30, seed=3)
    tpods, tcat = workload.build_workload(300, 30, seed=3)
    jb, tb = j_build_baseline(jpods, jcat), build_baseline(tpods, tcat)
    jmenu = build_menu(j_scenario, JScenario, jb, jcat, 5)
    tmenu = build_menu(t_scenario, Scenario, tb, tcat, 5)
    JWhatIfPlanner().plan(jb, jmenu)
    WhatIfPlanner(device="cpu").plan(tb, tmenu)
    port = assert_recorded_equal(5, {"whatif"})
    assert any(e["delta_words"] > 0 for e in port["ring"])
    WhatIfPlanner(device="cpu").plan_host(tb, tmenu)   # host: no record
    assert len(state("t")["ring"]) == 5


def test_sharded_windows_and_rebalance_skew():
    jcat = bench.build_catalog(20)
    from tests.test_torch_sharded import carried

    tcat = carried(jcat)
    jsvc = JShardedSolveService(2, mesh=shard_mesh(
        2, devices=jax.devices()[:1]))
    tsvc = ShardedSolveService(2, device="cpu")
    jstream, tstream = churn(0, rounds=3)
    for w, (jpods, tpods) in enumerate(zip(jstream, tstream)):
        jsvc.solve_window(jcat, pods=jpods)
        tsvc.solve_window(tcat, pods=tpods)
        if w == 0:
            rng = np.random.RandomState(7)
            extra_j = stream_pods(j_pod, rng, 30, "skew")
            rng = np.random.RandomState(7)
            extra_t = stream_pods(t_pod, rng, 30, "skew")
            jd = jsvc.rebalance(jpods + extra_j)
            td = tsvc.rebalance(tpods + extra_t)
            assert td.skew == jd.skew
    port = assert_recorded_equal(6, {"sharded"})
    skews = [e["rebalance_skew"] for e in port["ring"]]
    assert skews[:2] == [0, 0] and set(skews[2:]) == {td.skew}
    assert any(e["delta_words"] > 0 for e in port["ring"])


def test_no_suffix_records_nothing_and_record_window_matches():
    G, N, K = 4, 8, 0
    short = np.zeros(N + G + 1 + G, np.int32)
    assert j_tw.decode_and_record(short, G, N, K) is None
    assert t_tw.decode_and_record(short, G, N, K) is None
    assert state("t")["ring"] == [] and state("j")["ring"] == []
    slots = np.arange(1, len(t_tw.SLOT_NAMES) + 1, dtype=np.int32) * 700
    for skew, esc, coo in ((3, 0, 0), (5, 2, 1)):
        j_tw.note_rebalance_skew(skew)
        t_tw.note_rebalance_skew(skew)
        assert t_tw.record_window("p", slots, escalations=esc,
                                  coo_growths=coo, delta_words=9) == \
            j_tw.record_window("p", slots, escalations=esc,
                               coo_growths=coo, delta_words=9)
    assert_recorded_equal(2, {"p"})
    assert t_tw.HOST_SLOTS == tuple(
        i for i, (_, src) in enumerate(t_tw.TELEMETRY_SLOTS)
        if src == "host")
