"""The sharded solve service of the port against the reference's.

The same seeded pods go through both packages' shard routers, sharded
encoders and services, over the reference's catalog carried into the
port (``carry.catalog_from_numpy``).  The reference runs its services on
a one-device shard mesh, the case the port's single card is.  Held with
exact equality:

- the router's signature keys, hashes and partitions, and the hash-hot
  request sizes;
- every window's raw per-shard result words against the reference
  service's (its ``solve_shards``) and against ``solve_packed`` of each
  shard's buffer, for S = 2 and 4 over churn streams that rebuild, hit
  and delta, with the same resident-mode sequence and delta words, and
  the decoded plans;
- the rebalance tile against the reference's ``rebalance_shards`` and
  ``rebalance_oracle`` (ties included), and a hash-skewed stream's
  decisions and migrations;
- ``make_solver``'s routing, and ``ShardedSolver``'s plans against the
  reference's;
- the sharded serving loop's plans against the reference's loop.

A window with soft preferences, a stochastic pool or affinity raises
``NotImplementedError`` (the reference's host route waits for ROADMAP
queue 1 item 13); a failing stacked solve invalidates and raises.  The
headline window (10k pods x 500 types) is the ``slow`` case.
"""

import jax
import numpy as np
import pytest
import torch

import bench
import karpenter_tpu.apis.pod as j_pod
from karpenter_tpu.parallel.mesh import shard_mesh
from karpenter_tpu.serving.service import (
    ShardedServingLoop as JShardedServingLoop,
)
from karpenter_tpu.serving.validate import _churn_stream as j_churn_stream
from karpenter_tpu.sharded import ShardedSolver as JShardedSolver
from karpenter_tpu.sharded import ShardedSolveService as JShardedSolveService
from karpenter_tpu.sharded.kernels import rebalance_shards as j_rebalance
from karpenter_tpu.sharded.router import (
    craft_hot_requests as j_craft_hot_requests,
)
from karpenter_tpu.sharded.router import stable_shard as j_stable_shard
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.jax_backend import solve_packed as j_solve_packed
from karpenter_tpu.utils import metrics as j_metrics

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
from karpenter_tpu_torch import (
    SolveRequest, SolverOptions, TorchSolver, carry, make_solver, workload,
)
from karpenter_tpu_torch.resident.kernels import new_state
from karpenter_tpu_torch.serving.service import ShardedServingLoop
from karpenter_tpu_torch.serving.validate import (
    _churn_stream as t_churn_stream, sharded_parity_violations,
)
from karpenter_tpu_torch.sharded import sharded_shards
from karpenter_tpu_torch.sharded.kernels import (
    rebalance_oracle, rebalance_shards, solve_shards,
)
from karpenter_tpu_torch.sharded.router import (
    craft_hot_requests, signature_key, stable_shard,
)
from karpenter_tpu_torch.sharded.service import ShardedSolveService
from karpenter_tpu_torch.sharded.solver import ShardedSolver
from karpenter_tpu_torch.sharded.validate import (
    component_violations, partition_violations, rebalance_violations,
    state_violations,
)
from karpenter_tpu_torch.solver.packed import solve_packed_torch


@pytest.fixture(autouse=True)
def reference_backlog_series():
    """The reference's services publish ``shard_backlog_pods`` series
    into the reference's process-wide registry; leave it as each test
    found it, so a later test of the same worker reads only its own
    series (a 4-shard service here used to leave shards 2 and 3)."""
    before = j_metrics.SHARD_BACKLOG.samples()
    yield
    j_metrics.SHARD_BACKLOG.reset()
    for labels, value in before.items():
        j_metrics.SHARD_BACKLOG.labels(*labels).set(value)


def carried(jcat):
    return carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})


@pytest.fixture(scope="module")
def catalogs():
    jcat = bench.build_catalog(20)
    return jcat, carried(jcat)


def stream_pods(mod, rng, n, tag):
    """``bench.py::run_sharded``'s pods: 100-900m CPU, 256-2048 Mi."""
    return [mod.PodSpec(f"{tag}-{i}", requests=mod.ResourceRequests(
        int(rng.randint(100, 900)), int(rng.randint(256, 2048)), 0, 1))
        for i in range(n)]


def churn(seed, n=40, rounds=4):
    """Both packages' pods of a churn stream (``bench.py::run_sharded``'s
    churn): window 0 (a rebuild), the same window again (a hit), then
    1-7 departures and 4-11 arrivals per window (deltas)."""
    out = {"j": [], "t": []}
    for side, mod in (("j", j_pod), ("t", t_pod)):
        rng = np.random.RandomState(seed)
        pods = stream_pods(mod, rng, n, f"s{seed}")
        out[side] = [pods, pods]
        for r in range(rounds - 2):
            pods = pods[int(rng.randint(1, 8)):] + stream_pods(
                mod, rng, int(rng.randint(4, 12)), f"c{seed}r{r}")
            out[side].append(pods)
    return out["j"], out["t"]


def j_service(S):
    return JShardedSolveService(S, mesh=shard_mesh(S,
                                                   devices=jax.devices()[:1]))


def plan_view(plan):
    return ([(n.offering_index, n.instance_type, n.zone, n.capacity_type,
              tuple(n.pod_names)) for n in plan.nodes],
            list(plan.unplaced_pods), plan.total_cost_per_hour,
            dict(plan.unplaced_reasons))


def sharded_view(plan):
    return [plan_view(p) for p in plan.plans], list(plan.shard_pods)


# -- the router --------------------------------------------------------------


@pytest.mark.parametrize("S", [2, 3, 4])
def test_router_partitions_equal_reference(S):
    jpods, _ = bench.build_workload(400, 20, seed=3)
    tpods, _ = workload.build_workload(400, 20, seed=3)
    from karpenter_tpu.sharded.router import ShardRouter as JShardRouter
    from karpenter_tpu_torch.sharded.router import ShardRouter

    for jp, tp in zip(jpods, tpods):
        assert signature_key(tp) == jp.signature_key()
        assert stable_shard(signature_key(tp), S) == \
            j_stable_shard(jp.signature_key(), S)
    jparts = JShardRouter(S).partition(jpods)
    tparts = ShardRouter(S).partition(tpods)
    assert [[p.name for p in part] for part in tparts] == \
        [[p.name for p in part] for part in jparts]
    assert craft_hot_requests(S, S - 1, count=12) == \
        j_craft_hot_requests(S, S - 1, count=12)


def test_router_migrate_overrides_and_drops_home():
    from karpenter_tpu_torch.sharded.router import ShardRouter

    r = ShardRouter(2)
    key = "k"
    home = stable_shard(key, 2)
    assert r.migrate(key, 1 - home) and r.overrides() == {key: 1 - home}
    assert not r.migrate(key, 1 - home)
    assert r.migrate(key, home) and r.overrides() == {}
    with pytest.raises(ValueError):
        r.migrate(key, 2)


# -- the stacked solve: words, modes, plans -----------------------------------


@pytest.mark.parametrize("S,seed", [(2, 0), (4, 2)])
def test_churn_windows_equal_reference_words_modes_plans(catalogs, S, seed):
    jcat, tcat = catalogs
    jstream, tstream = churn(seed)
    jsvc, tsvc = j_service(S), ShardedSolveService(S, device="cpu")
    modes = []
    for w, (jpods, tpods) in enumerate(zip(jstream, tstream)):
        jkick = jsvc._kick_window(jcat, pods=jpods)
        tkick = tsvc._kick_window(tcat, pods=tpods)
        jout = np.asarray(jkick.out_dev)
        tout = tkick.host.numpy()
        np.testing.assert_array_equal(tout, jout, err_msg=f"window {w}")
        assert (tkick.delta.mode, tkick.delta.words, tkick.delta.reason) \
            == (jkick.delta.mode, jkick.delta.words, jkick.delta.reason)
        modes.append(tkick.delta.mode)
        tw = tkick.window
        np.testing.assert_array_equal(tw.stacked, jkick.window.stacked)
        assert tw.shapes == jkick.window.shapes
        jct = jsvc._catalog_tensors(jcat, tw.O_pad)
        tct = tsvc._catalog_tensors(tcat, tw.O_pad)
        kw = dict(G=tw.G_pad, O=tw.O_pad, U=tw.U_pad, N=tw.N)
        for s in range(S):
            single = solve_packed_torch(torch.from_numpy(tw.stacked[s]),
                                        *tct, **kw).numpy()
            np.testing.assert_array_equal(tout[s], single)
            if w == 0:          # (a compile of the reference per shape)
                np.testing.assert_array_equal(
                    single, np.asarray(j_solve_packed(tw.stacked[s], *jct,
                                                      **kw)))
        jplan = jsvc._fetch_window(jkick)
        tplan = tsvc._fetch_window(tkick)
        assert sharded_view(tplan) == sharded_view(jplan)
        assert plan_view(tplan.merged()) == plan_view(jplan.merged())
        assert state_violations(tsvc, tpods, tcat) == []
        assert partition_violations(tsvc, tpods) == []
    assert modes == ["rebuild", "hit", "delta", "delta"]
    assert tsvc.stats()["mesh_devices"] == 1
    assert tsvc.stats()["windows"] == len(tstream)


def test_solve_shards_pads_into_each_rows_spare_word(catalogs):
    """A delta scattered into the stacked state lands in its own row, its
    padding in that row's spare word; each result row is the single
    solve of the updated buffer."""
    _, tcat = catalogs
    jstream, tstream = churn(7, rounds=4)
    svc = ShardedSolveService(2, device="cpu")
    w0 = svc._kick_window(tcat, pods=tstream[0]).window
    w1 = svc._kick_window(tcat, pods=tstream[2]).window
    assert w0.shapes == w1.shapes
    L = w0.stacked.shape[1]
    state = new_state(w0.stacked, "cpu")
    didx = np.full((2, 64), L, np.int32)
    dval = np.full((2, 64), -7, np.int32)
    for s in range(2):
        idx = np.nonzero(w0.stacked[s] != w1.stacked[s])[0]
        didx[s, :idx.size] = idx
        dval[s, :idx.size] = w1.stacked[s][idx]
    didx[1, -1] = -3                    # out of range: the spare word too
    ct = svc._catalog_tensors(tcat, w0.O_pad)
    kw = dict(G=w0.G_pad, O=w0.O_pad, U=w0.U_pad, N=w0.N)
    state, out = solve_shards(state, torch.from_numpy(didx),
                              torch.from_numpy(dval), *ct, **kw)
    np.testing.assert_array_equal(state[:, :L].numpy(), w1.stacked)
    assert (state[:, L] == -7).all()
    for s in range(2):
        np.testing.assert_array_equal(
            out[s].numpy(), solve_packed_torch(
                torch.from_numpy(w1.stacked[s]), *ct, **kw).numpy())


def test_failed_solve_invalidates_and_raises(catalogs, monkeypatch):
    _, tcat = catalogs
    _, tstream = churn(3, rounds=3)
    svc = ShardedSolveService(2, device="cpu")
    svc.solve_window(tcat, pods=tstream[0])

    def broken(*a, **k):
        raise RuntimeError("stacked solve failed")

    monkeypatch.setattr("karpenter_tpu_torch.sharded.service.solve_shards",
                        broken)
    with pytest.raises(RuntimeError, match="stacked solve failed"):
        svc.solve_window(tcat, pods=tstream[1])
    assert svc.snapshot_state() is None and svc.invalidations == 1
    monkeypatch.undo()
    svc.solve_window(tcat, pods=tstream[1])
    assert (svc.last_delta.mode, svc.last_delta.reason) == \
        ("rebuild", "dispatch_error")


def test_corrupt_result_raises(catalogs):
    from karpenter_tpu_torch.sharded.service import CorruptShardResult

    _, tcat = catalogs
    svc = ShardedSolveService(2, device="cpu")
    kick = svc._kick_window(tcat, pods=churn(4, rounds=3)[1][0])
    kick.host[1, 0] = kick.window.O_pad + 5     # node_off out of range
    with pytest.raises(CorruptShardResult, match="shard 1"):
        svc._fetch_window(kick)
    assert svc.snapshot_state() is None


def _host_routed_windows():
    base = [t_pod.PodSpec(f"h{i}", requests=t_pod.ResourceRequests(
        500, 1024, 0, 1)) for i in range(12)]
    aff = base + [
        t_pod.PodSpec("a", labels=(("app", "a"),)),
        t_pod.PodSpec("b", affinity=(t_pod.PodAffinityTerm(
            (("app", "a"),), t_pod.HOSTNAME_TOPOLOGY_KEY, anti=True),))]
    return {"preferences": (workload.with_preferences(base), None),
            "stochastic": (base, t_nodeclaim.NodePool(name="oc",
                                                      overcommit=0.1)),
            "affinity": (aff, None)}


@pytest.mark.parametrize("route", ["preferences", "stochastic", "affinity"])
def test_host_routed_window_raises_naming_roadmap(catalogs, route):
    _, tcat = catalogs
    pods, pool = _host_routed_windows()[route]
    svc = ShardedSolveService(2, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 13"):
        svc.solve_window(tcat, pool, pods=pods)
    solver = ShardedSolver(2, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        solver.solve(SolveRequest(pods, tcat, pool))


def test_affinity_components_co_route(catalogs):
    from karpenter_tpu.sharded.router import ShardRouter as JShardRouter
    from karpenter_tpu_torch.sharded.router import ShardRouter

    tpods = workload.affinity_bench_pods("aff", 300,
                                         np.random.RandomState(19))
    jpods = bench._affinity_bench_pods("aff", 300, np.random.RandomState(19))
    svc = ShardedSolveService(4, device="cpu")
    jr = JShardRouter(4)
    assert svc.router.bind_components(tpods) == jr.bind_components(jpods) > 0
    assert svc.router.overrides() == jr.overrides()
    assert component_violations(svc, tpods) == []
    assert partition_violations(svc, tpods) == []
    assert isinstance(ShardRouter(4).bind_components(tpods[:1]), int)


# -- rebalance ----------------------------------------------------------------


@pytest.mark.parametrize("mat", [
    [[30, 5, 0], [4, 2, 0]],
    [[7, 1, 0], [7, 1, 0], [1, 1, 0], [1, 1, 0]],     # ties: lowest ids
    [[3, 1, 2], [3, 1, 0], [3, 2, 1], [3, 1, 0]],     # all tied
    [[0, 0, 0], [9, 2, 0], [0, 0, 0], [9, 3, 1], [4, 1, 0], [9, 1, 0],
     [1, 1, 0], [0, 0, 0]],
    [[2 ** 31 - 1, 1, 0], [5, 1, 0], [2 ** 31 - 1, 1, 0]],  # int32 wrap
])
def test_rebalance_tile_equals_reference(mat):
    mat = np.asarray(mat, np.int32)
    S = mat.shape[0]
    tile = rebalance_shards(torch.from_numpy(mat)).numpy()
    jtile = np.asarray(j_rebalance(mat, mesh=shard_mesh(
        S, devices=jax.devices()[:1])))
    np.testing.assert_array_equal(tile, jtile)
    assert tile.dtype == np.int32 and tile.shape == (S, 7)
    assert (tile == tile[0]).all()
    assert tuple(int(v) for v in tile[0, :4]) == rebalance_oracle(mat)


def test_rebalance_random_tiles_equal_reference():
    rng = np.random.RandomState(5)
    for _ in range(6):
        S = int(rng.choice([2, 3, 4, 8]))
        mat = rng.randint(0, 6, size=(S, 3)).astype(np.int32)
        tile = rebalance_shards(torch.from_numpy(mat)).numpy()
        jtile = np.asarray(j_rebalance(mat, mesh=shard_mesh(
            S, devices=jax.devices()[:1])))
        np.testing.assert_array_equal(tile, jtile)


def test_hot_stream_rebalance_equal_reference(catalogs):
    """``bench.py::run_sharded``'s hash-skewed stream: 24 hot request
    sizes, 2-5 pods each (seed 7), 4 windows, each followed by a
    rebalance tick."""
    jcat, tcat = catalogs
    pods = {}
    for side, mod, craft in (("j", j_pod, j_craft_hot_requests),
                             ("t", t_pod, craft_hot_requests)):
        rng = np.random.RandomState(7)
        pods[side] = [mod.PodSpec(f"hot{made}-{i}", requests=mod.
                                  ResourceRequests(hcpu, hmem, 0, 1))
                      for made, (hcpu, hmem) in enumerate(
                          craft(2, 0, count=24))
                      for i in range(int(rng.randint(2, 6)))]
    jsvc, tsvc = j_service(2), ShardedSolveService(2, device="cpu")
    jsvc.admit(pods["j"])
    tsvc.admit(pods["t"])
    migrations, modes = 0, []
    for _ in range(4):
        jplan = jsvc.solve_window(jcat)
        tplan = tsvc.solve_window(tcat)
        modes.append(tsvc.last_delta.mode)
        assert sharded_view(tplan) == sharded_view(jplan)
        jdec, tdec = jsvc.rebalance(), tsvc.rebalance()
        np.testing.assert_array_equal(tdec.pressure, jdec.pressure)
        np.testing.assert_array_equal(tdec.tile, np.asarray(jdec.tile))
        assert tdec.moved_keys == jdec.moved_keys
        assert rebalance_violations(tsvc, tdec) == []
        migrations += len(tdec.moved_keys)
    assert migrations > 0
    assert tsvc.router.overrides() == jsvc.router.overrides()
    assert modes[0] == "rebuild" and tsvc.stats()["rebalances"] == 4


# -- the solver entry points --------------------------------------------------


def test_make_solver_routes_sharded(catalogs, monkeypatch):
    jcat, tcat = catalogs
    monkeypatch.delenv("KARPENTER_ENABLE_SHARDED", raising=False)
    # sharded=1: the plain solver, which solves (the reference's JaxSolver
    # never reads the option)
    one = make_solver(SolverOptions(sharded=1), device="cpu")
    assert type(one) is TorchSolver
    jstream, tstream = churn(11, rounds=3)
    assert one.solve(SolveRequest(tstream[0], tcat)).placed_count == 40
    assert type(TorchSolver(SolverOptions(sharded=1), device="cpu")) \
        is TorchSolver
    two = make_solver(SolverOptions(sharded=2), device="cpu")
    assert type(two) is ShardedSolver and two.service.num_shards == 2
    jsolver = JShardedSolver(2)
    for jpods, tpods in zip(jstream[:2], tstream[:2]):
        jplan = jsolver.solve(JSolveRequest(jpods, jcat))
        tplan = two.solve(SolveRequest(tpods, tcat))
        assert plan_view(tplan) == plan_view(jplan)
        assert tplan.backend == jplan.backend == "sharded"
    assert two.last_stats["path"] == "sharded-cpu"
    assert two.last_stats["resident_mode"] == "hit"
    monkeypatch.setenv("KARPENTER_ENABLE_SHARDED", "1")
    monkeypatch.setenv("KARPENTER_SHARDS", "4")
    assert sharded_shards(SolverOptions()) == 4
    env = make_solver(SolverOptions(), device="cpu")
    assert type(env) is ShardedSolver and env.service.num_shards == 4
    monkeypatch.delenv("KARPENTER_SHARDS")
    assert sharded_shards(None) == 2


def test_sharded_solver_rebalances_unplaced_backlog(catalogs):
    """A window that leaves pods unplaced (here: larger than any
    offering) rebalances on the unplaced pods, as the reference's solver
    does."""
    jcat, tcat = catalogs
    jsolver, tsolver = JShardedSolver(2), ShardedSolver(2, device="cpu")
    jpods = [j_pod.PodSpec(f"big{i}", requests=j_pod.ResourceRequests(
        500_000 + i, 1024, 0, 1)) for i in range(6)] + churn(5, 10)[0][0]
    tpods = [t_pod.PodSpec(f"big{i}", requests=t_pod.ResourceRequests(
        500_000 + i, 1024, 0, 1)) for i in range(6)] + churn(5, 10)[1][0]
    jplan = jsolver.solve(JSolveRequest(jpods, jcat))
    tplan = tsolver.solve(SolveRequest(tpods, tcat))
    assert plan_view(tplan) == plan_view(jplan)
    assert len(tplan.unplaced_pods) == 6
    assert tplan.unplaced_reasons == jplan.unplaced_reasons
    assert tsolver.stats()["rebalances"] == 1


# -- the sharded serving loop -------------------------------------------------


def test_serving_loop_plans_equal_reference_loop():
    for seed in range(2):
        jseqs, jcat = j_churn_stream(64, 6, 4, 1000 + seed)
        tseqs, tcat = t_churn_stream(64, 6, 4, 1000 + seed)
        jloop = JShardedServingLoop(j_service(2), capacity=2)
        tloop = ShardedServingLoop(ShardedSolveService(2, device="cpu"),
                                   capacity=2)
        jh = [jloop.submit(jcat, pods=p) for p in jseqs]
        th = [tloop.submit(tcat, pods=p) for p in tseqs]
        for j, t in zip(jh, th):
            assert sharded_view(t.result()) == sharded_view(j.result())
        assert tloop.stats()["overlapped"] == jloop.stats()["overlapped"]
        assert tloop.overlap_fraction == jloop.overlap_fraction > 0
        assert tloop.stats()["inflight"] == 0


def test_serving_loop_failed_fetch_raises_again_and_counts_nothing():
    seqs, cat = t_churn_stream(64, 6, 2, 1000)
    service = ShardedSolveService(2, device="cpu")
    loop = ShardedServingLoop(service, capacity=2)
    handle = loop.submit(cat, pods=seqs[0])
    err = RuntimeError("fetch failed")

    def failing_fetch(kick):
        raise err

    service._fetch_window = failing_fetch
    for _ in range(2):
        with pytest.raises(RuntimeError) as caught:
            handle.result()
        assert caught.value is err
    stats = loop.stats()
    assert (stats["fetched"], stats["overlapped"], stats["inflight"]) == (
        0, 0, 0)
    del service._fetch_window
    plan = loop.submit(cat, pods=seqs[1]).result()
    assert plan.merged() is not None
    assert loop.stats()["fetched"] == 1


def test_sharded_parity_violations_empty():
    assert sharded_parity_violations(seeds=2, device="cpu") == []


@pytest.mark.slow
def test_headline_window_equal_reference():
    jpods, jcat = bench.build_workload(10_000, 500)
    tcat = carried(jcat)
    tpods, _ = workload.build_workload(10_000, 500)
    jplan = JShardedSolver(2).solve(JSolveRequest(jpods, jcat))
    solver = make_solver(SolverOptions(sharded=2), device="cpu")
    tplan = solver.solve(SolveRequest(tpods, tcat))
    assert plan_view(tplan) == plan_view(jplan)
