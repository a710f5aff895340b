"""The port's metric samples and trace spans against the reference's.

The plans and packed words of both packages are equal; this file holds
what they say about a window besides the plan.  Each script runs the
same windows through the reference and the port (on the CPU), each
package from freshly reset metric families and an empty flight
recorder, and compares:

- every metric sample (counters and gauges by value, histograms by
  observation count, and by sum where the family does not measure
  time), with the reference's backend label ``jax`` read as ``torch``;
- the span names of every trace (with the instants that landed on
  its spans), and the free instants, in order;
- the number of traces;
- the keys of ``obs.last_solve_breakdown()``.

The scripts: three affinity windows through the single solver, a
two-shard ``ShardedSolver`` window, and a serving loop given more
windows than its ring holds without a fetch.
"""

from __future__ import annotations

import copy

import jax
import numpy as np
import pytest

import bench
from karpenter_tpu import obs as j_obs
from karpenter_tpu.obs import prof as j_prof
from karpenter_tpu.obs import watchdog as j_watchdog
from karpenter_tpu.parallel.mesh import shard_mesh
from karpenter_tpu.serving import RING_SLOTS as J_RING_SLOTS
from karpenter_tpu.serving.service import ServingLoop as JServingLoop
from karpenter_tpu.sharded import ShardedSolveService as JShardedSolveService
from karpenter_tpu.sharded import ShardedSolver as JShardedSolver
from karpenter_tpu.sharded.degraded import (
    ResilientShardedService as JResilientShardedService,
)
from karpenter_tpu.solver import JaxSolver
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver import SolverOptions as JSolverOptions
from karpenter_tpu.solver import encode as j_encode
from karpenter_tpu.utils import metrics as j_metrics

from karpenter_tpu_torch import obs as t_obs
from karpenter_tpu_torch.obs import prof as t_prof
from karpenter_tpu_torch.obs import watchdog as t_watchdog
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.serving import RING_SLOTS
from karpenter_tpu_torch.serving.service import ServingLoop
from karpenter_tpu_torch.sharded.solver import ShardedSolver
from karpenter_tpu_torch.solver import SolveRequest, SolverOptions, TorchSolver
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.utils import metrics as t_metrics

from tests.test_torch_solver import assert_plans_equal

SIDES = {"j": (j_obs, j_metrics), "t": (t_obs, t_metrics)}

# families whose values are wall times or time-of-day stamps: their
# observation counts are compared, their values are not
_TIMED = ("duration", "seconds", "latency", "_ms", "timestamp", "age",
          "overhead", "wall")


def _families(metrics):
    with metrics._registry_lock:
        return list(metrics._registry)


def _state_of(fam):
    keep = ["_values"]
    if fam.kind == "histogram":
        keep += ["_counts", "_sums", "_totals", "_exemplars"]
    return {k: copy.deepcopy(getattr(fam, k)) for k in keep}


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Both packages start from empty metric families, an empty recorder
    and a fresh device profiler; afterwards every family, the recorder
    and the profiler are put back, so a later test of the same worker
    reads only its own samples.  The profiler samples dispatch 0, N,
    2N... of each kernel counted over the process, so without a fresh
    one the earlier solves of the worker decide which dispatch of this
    test writes ``karpenter_tpu_device_time_seconds``.  Each package's
    anomaly watchdog is fresh too (its breach counters are samples)."""
    for prof in (j_prof, t_prof):
        prof.get_profiler()         # its first call installs the hooks
        monkeypatch.setattr(prof, "_PROFILER", prof.DeviceProfiler())
    # the anomaly watchdog's baselines (latency per kernel and phase,
    # fill per plane) are the process's too: an earlier test's windows
    # decide whether this one's samples breach
    for wd in (j_watchdog, t_watchdog):
        monkeypatch.setattr(wd, "_WATCHDOG", wd.Watchdog())
    saved = []
    for obs_mod, metrics in SIDES.values():
        fams = _families(metrics)
        saved.append((obs_mod, obs_mod.get_tracer().recorder,
                      [(f, _state_of(f)) for f in fams]))
        obs_mod.reset_recorder()
        for f in fams:
            f.reset()
    yield
    for obs_mod, recorder, states in saved:
        obs_mod.get_tracer().recorder = recorder
        for fam, st in states:
            for k, v in st.items():
                setattr(fam, k, v)


def _label(v: str) -> str:
    return "torch" if v == "jax" else v


def samples(side) -> dict:
    """{family: {labels: value}} of every family with a sample."""
    _, metrics = SIDES[side]
    out = {}
    for fam in _families(metrics):
        timed = any(t in fam.name for t in _TIMED)
        if fam.kind == "histogram":
            rows = {}
            for labels, n in fam._totals.items():
                row = (n,) if timed else (n, round(fam._sums[labels], 6),
                                          tuple(fam._counts[labels]))
                rows[tuple(_label(v) for v in labels)] = row
        else:
            rows = {tuple(_label(v) for v in labels):
                    (None if timed else round(v, 6))
                    for labels, v in fam.samples().items()}
        if rows:
            out[fam.name] = rows
    return out


def traces(side) -> list:
    """The span names of every retained trace, with the instants that
    landed on its spans as events."""
    obs_mod, _ = SIDES[side]
    rec = obs_mod.get_recorder()
    return [sorted([sp.name for sp in spans]
                   + [e["name"] for sp in spans for e in sp.events or ()])
            for _tid, _status, _root, spans in rec.traces()]


def instants(side) -> list:
    obs_mod, _ = SIDES[side]
    return [sp.name for sp in obs_mod.get_recorder().instants()]


def assert_observed_equal():
    ref, port = samples("j"), samples("t")
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name
    assert traces("t") == traces("j")
    assert instants("t") == instants("j")
    assert sorted(t_obs.last_solve_breakdown()) == \
        sorted(j_obs.last_solve_breakdown())


# ---------------------------------------------------------------------------
# Windows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def catalogs():
    return bench.build_catalog(60), workload.build_catalog(60)


# The windows' pods are built here, once, before each test's ``fresh``:
# ``build_workload`` also prices a catalog through the pricing batcher,
# whose batches (a 0.2 s idle) a stall of a loaded host splits, so its
# samples would differ between the packages by timing alone.

@pytest.fixture(scope="module")
def plain_pods():
    return (bench.build_workload(400, 60, seed=5)[0],
            workload.build_workload(400, 60, seed=5)[0])


@pytest.fixture(scope="module")
def serving_pods():
    return [(bench.build_workload(120 + 10 * w, 60, seed=7)[0],
             workload.build_workload(120 + 10 * w, 60, seed=7)[0])
            for w in range(RING_SLOTS + 2)]


def affinity_pods():
    return (bench._affinity_bench_pods("ap0", 300, np.random.RandomState(190),
                                       services=4, spread_sets=2),
            workload.affinity_bench_pods("ap0", 300,
                                         np.random.RandomState(190),
                                         services=4, spread_sets=2))


def test_affinity_windows_write_the_reference_samples_and_spans(catalogs):
    jcat, tcat = catalogs
    jpods, tpods = affinity_pods()
    js = JaxSolver(JSolverOptions(use_pallas="off"))
    ts = TorchSolver(SolverOptions(), device="cpu")
    for _ in range(3):
        assert_plans_equal(js.solve(JSolveRequest(jpods, jcat)),
                           ts.solve(SolveRequest(tpods, tcat)))
    assert ts.last_stats["path"] == "affinity-cpu"
    assert_observed_equal()
    assert t_metrics.SOLVE_DURATION.count("torch") == 3
    assert t_metrics.AFFINITY_EDGES.get() > 0
    assert sorted(t_obs.last_solve_breakdown()) == \
        ["compute", "d2h", "encode", "h2d"]
    assert sum("solve" in t and "explain.fold" in t
               for t in traces("t")) == 3


def test_plain_windows_write_the_reference_samples_and_spans(catalogs,
                                                          plain_pods):
    jcat, tcat = catalogs
    jpods, tpods = plain_pods
    js = JaxSolver(JSolverOptions(use_pallas="off"))
    ts = TorchSolver(SolverOptions(), device="cpu")
    for _ in range(2):
        assert_plans_equal(js.solve(JSolveRequest(jpods, jcat)),
                           ts.solve(SolveRequest(tpods, tcat)))
    assert_observed_equal()
    assert t_metrics.SOLVE_PODS.count("torch") == 2


def test_sharded_window_writes_the_reference_samples_and_spans(catalogs,
                                                              plain_pods):
    jcat, tcat = catalogs
    jpods, tpods = plain_pods
    # the port holds every shard on one device: the reference's shards
    # go on one device too, as the port's sharded tests place them
    jsolver = JShardedSolver(2)
    jsolver.service = JResilientShardedService(JShardedSolveService(
        2, mesh=shard_mesh(2, devices=jax.devices()[:1])))
    jplan = jsolver.solve(JSolveRequest(jpods, jcat))
    tplan = ShardedSolver(2, device="cpu").solve(SolveRequest(tpods, tcat))
    assert_plans_equal(jplan, tplan)
    assert_observed_equal()
    assert t_metrics.SOLVE_DURATION.count("sharded") == 1
    assert sum(t_metrics.SHARD_BACKLOG.samples().values()) == 400
    assert any("sharded.window" in t for t in traces("t"))


def test_serving_backpressure_writes_the_reference_samples(catalogs,
                                                          serving_pods):
    jcat, tcat = catalogs
    assert RING_SLOTS == J_RING_SLOTS
    jloop = JServingLoop(JaxSolver(JSolverOptions(use_pallas="off")))
    tloop = ServingLoop(TorchSolver(SolverOptions(), device="cpu"))
    jh, th = [], []
    for jpods, tpods in serving_pods:
        jh.append(jloop.submit(j_encode(jpods, jcat)))
        th.append(tloop.submit(t_encode(tpods, tcat)))
    assert tloop.backpressured == jloop.backpressured == 2
    for a, b in zip(jh, th):
        assert_plans_equal(a.result(), b.result())
    assert_observed_equal()
    assert t_metrics.SERVING_BACKPRESSURE.get() == 2.0
    assert instants("t").count("serving.kick") == RING_SLOTS


def test_serving_drain_and_generation_track_as_the_reference(catalogs):
    jcat, tcat = catalogs
    jloop = JServingLoop(JaxSolver(JSolverOptions(use_pallas="off")))
    tloop = ServingLoop(TorchSolver(SolverOptions(), device="cpu"))
    for w in range(3):
        jpods, _ = bench.build_workload(150 + 5 * w, 60, seed=9)
        tpods, _ = workload.build_workload(150 + 5 * w, 60, seed=9)
        jloop.submit(j_encode(jpods, jcat))
        tloop.submit(t_encode(tpods, tcat))
    jplans, tplans = jloop.drain(), tloop.drain()
    assert sorted(tplans) == sorted(jplans)
    for seq in jplans:
        assert_plans_equal(jplans[seq], tplans[seq])
    assert tloop.drain() == {} and jloop.drain() == {}
    saved = jcat.availability_generation, tcat.availability_generation
    jcat.availability_generation = tcat.availability_generation = "bumped"
    try:
        jloop.track_generation(jcat)
        tloop.track_generation(tcat)
    finally:
        jcat.availability_generation, tcat.availability_generation = saved
    assert tloop.invalidations == jloop.invalidations == 1
    assert tloop.last_reason == jloop.last_reason == "generation"
    assert_observed_equal()
