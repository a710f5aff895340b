"""The sharded service on a wide shard mesh, and its N-1 failover,
against the reference's.

The reference's service builds its shard mesh over the eight virtual
CPU devices of ``tests/conftest.py``; the port's service on the CPU
spans one slot, so the module's fixture has its ``slot_pool`` hand it
the eight CPU slots ``torch.device("cpu", i)`` instead.  Each side runs the
same script on the same pods with a fresh health board of its own
package (the board is per process and per package), and the plans,
``stats()``, the failover bookkeeping, the ``sharded.failover`` instant
and ``karpenter_tpu_device_failovers_total`` must agree.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.obs as j_obs
import karpenter_tpu.parallel as jpar
from karpenter_tpu.faulttol import DeviceFaultError as JDeviceFaultError
from karpenter_tpu.sharded import ResilientShardedService as JResilient
from karpenter_tpu.sharded import ShardedSolveService as JService
from karpenter_tpu.sharded.kernels import rebalance_shards as j_rebalance
from karpenter_tpu.utils import metrics as j_metrics

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.obs as t_obs
from karpenter_tpu_torch.faulttol import DeviceFaultError
from karpenter_tpu_torch.parallel import shard_mesh
from karpenter_tpu_torch.sharded import ResilientShardedService
from karpenter_tpu_torch.sharded.kernels import rebalance_shards
import karpenter_tpu_torch.sharded.service as t_service
from karpenter_tpu_torch.sharded.service import ShardedSolveService
from karpenter_tpu_torch.sharded.validate import state_violations
from karpenter_tpu_torch.utils import metrics as t_metrics

from tests.test_torch_faulttol import (  # noqa: F401 (autouse fixtures)
    FakeClock, ScriptedInjector, _pristine_faulttol,
    _reference_observability_untouched, make_board,
)
from tests.test_torch_sharded import (  # noqa: F401 (fixtures)
    catalogs, churn, reference_backlog_series, reference_deadline_widened,
    sharded_view,
)

CPU8 = [torch.device("cpu", i) for i in range(8)]

SIDES = {
    "ref": dict(pod=j_pod, obs=j_obs, metrics=j_metrics,
                fault=JDeviceFaultError,
                service=lambda S, **kw: JService(S, **kw),
                resilient=JResilient, cat=0),
    "port": dict(pod=t_pod, obs=t_obs, metrics=t_metrics,
                 fault=DeviceFaultError,
                 service=lambda S, **kw: ShardedSolveService(
                     S, device="cpu", **kw),
                 resilient=ResilientShardedService, cat=1),
}


@pytest.fixture(autouse=True)
def eight_cpu_slots(monkeypatch):
    """The port's counterpart of the reference's eight virtual devices:
    a CPU service spans the eight CPU slots."""
    monkeypatch.setattr(t_service, "slot_pool", lambda device: list(CPU8))


def make_pods(pod, n, seed):
    """``tests/test_faulttol.py::make_pods`` in either package."""
    rng = np.random.RandomState(seed)
    return [pod.PodSpec(f"p{seed}-{i}", requests=pod.ResourceRequests(
        int(rng.randint(100, 900)), int(rng.randint(256, 2048)), 0, 1))
        for i in range(n)]


def mesh_ids(svc):
    """Board ids of the mesh's slots: a JAX device's or a torch one's."""
    return [f"{d.platform}:{d.id}" if hasattr(d, "platform")
            else f"{d.type}:{d.index}" for d in svc.mesh.devices.flat]


def failovers_total(metrics):
    return {k: v for k, v in metrics.DEVICE_FAILOVERS.samples().items()}


def moved(before, after):
    return {k: after.get(k, 0.0) - before.get(k, 0.0) for k in after
            if after.get(k, 0.0) != before.get(k, 0.0)}


def failover_instants(obs):
    return [(s.name, dict(s.attrs or {})) for s in obs.get_recorder()
            .instants() if s.name == "sharded.failover"]


def run_sides(script, catalogs):
    out = {}
    for name, side in SIDES.items():
        side["obs"].reset_recorder()
        out[name] = script(name, side, catalogs[side["cat"]])
    return out


# -- the wide mesh --------------------------------------------------------------


@pytest.mark.parametrize("S,seed", [(2, 1), (4, 3)])
def test_wide_mesh_windows_and_stats_equal_reference(catalogs, S, seed):
    """Churn windows on ``shard_mesh(S)`` over eight slots: the result
    words, the delta modes, the plans and ``stats()`` window after
    window, then a rebalance."""
    jstream, tstream = churn(seed)
    jcat, tcat = catalogs
    jsvc, tsvc = SIDES["ref"]["service"](S), SIDES["port"]["service"](S)
    assert mesh_ids(tsvc) == mesh_ids(jsvc) == [f"cpu:{i}" for i in range(S)]
    for w, (jpods, tpods) in enumerate(zip(jstream, tstream)):
        jkick = jsvc._kick_window(jcat, pods=jpods)
        tkick = tsvc._kick_window(tcat, pods=tpods)
        np.testing.assert_array_equal(tkick.host.numpy(),
                                      np.asarray(jkick.out_dev),
                                      err_msg=f"window {w}")
        assert tkick.delta.mode == jkick.delta.mode
        assert sharded_view(tsvc._fetch_window(tkick)) == \
            sharded_view(jsvc._fetch_window(jkick))
        assert tsvc.stats() == jsvc.stats()
        assert state_violations(tsvc, tpods, tcat) == []
    jd, td = jsvc.rebalance(jstream[-1]), tsvc.rebalance(tstream[-1])
    np.testing.assert_array_equal(td.tile.cpu().numpy() if isinstance(
        td.tile, torch.Tensor) else td.tile, np.asarray(jd.tile))
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.stats()["mesh_devices"] == S


@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_rebalance_tiles_on_a_mesh_equal_reference(width):
    rng = np.random.RandomState(width)
    for trial in range(3):
        mat = rng.randint(0, 40, size=(8, 3)).astype(np.int32)
        if trial == 1:
            mat[:, 0] = 7                                   # every tie
        want = np.asarray(j_rebalance(mat, mesh=jpar.shard_mesh(
            8, devices=jax.devices()[:width])))
        got = rebalance_shards(torch.from_numpy(mat),
                               mesh=shard_mesh(8, devices=CPU8[:width]))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            rebalance_shards(torch.from_numpy(mat)).numpy(), want)


def test_explicit_mesh_is_honoured_and_kinds_checked(catalogs):
    """An explicit mesh replaces the default one: on the same two slots
    of the eight, the plans and ``stats()`` equal the reference's."""
    jcat, tcat = catalogs
    jsvc = JService(4, mesh=jpar.shard_mesh(4, devices=jax.devices()[4:6]))
    tsvc = ShardedSolveService(4, device="cpu",
                               mesh=shard_mesh(4, devices=CPU8[4:6]))
    assert mesh_ids(tsvc) == mesh_ids(jsvc) == ["cpu:4", "cpu:5"]
    jpods, tpods = (make_pods(side["pod"], 24, 5) for side in SIDES.values())
    assert sharded_view(tsvc.solve_window(tcat, pods=tpods)) == \
        sharded_view(jsvc.solve_window(jcat, pods=jpods))
    assert tsvc.stats() == jsvc.stats()
    assert tsvc.stats()["mesh_devices"] == 2
    card = np.array([torch.device("cuda", 0)], dtype=object)
    from karpenter_tpu_torch.parallel import Mesh

    with pytest.raises(ValueError, match="cpu slots only"):
        ShardedSolveService(2, device="cpu", mesh=Mesh(card, ("shard",)))


def test_slot_pool_follows_the_device(monkeypatch):
    """A bare ``cuda`` spans every card, an indexed device that one card
    alone, ``cpu`` the one CPU slot; an explicit mesh brings its own."""
    monkeypatch.undo()
    cards = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(t_service, "default_devices", lambda: list(cards))
    monkeypatch.setattr(t_service, "resolve_device", torch.device)
    assert t_service.slot_pool("cuda") == cards
    assert t_service.slot_pool("cuda:1") == [cards[1]]
    assert t_service.slot_pool("cpu") == [torch.device("cpu")]
    svc = ShardedSolveService(4, device="cuda:2")
    assert svc.mesh.shape == {"shard": 1} and svc.device_ids == ["cuda:2"]
    assert ShardedSolveService(4, device="cuda").device_ids == \
        [f"cuda:{i}" for i in range(4)]


# -- N-1 failover ------------------------------------------------------------------


def test_n_minus_one_failover_remaps_mesh_as_reference(catalogs):
    """``tests/test_faulttol.py::test_n_minus_one_failover_remaps_mesh``
    on both sides."""
    def script(name, side, cat):
        board = make_board(name, FakeClock())
        m0 = failovers_total(side["metrics"])
        svc = side["resilient"](side["service"](2))
        plan0 = svc.solve_window(cat, pods=make_pods(side["pod"], 40, 11))
        victim = mesh_ids(svc)[0]
        for _ in range(3):
            board.record_fault(victim, kind="deadline",
                               kernel="sharded-solve")
        assert not board.admits(victim)
        plan1 = svc.solve_window(cat, pods=make_pods(side["pod"], 40, 11))
        assert victim not in mesh_ids(svc)
        return dict(
            victim=victim, survivors=mesh_ids(svc),
            failovers=svc.failovers,
            reason=board.last_failover_reason, shards=svc.num_shards,
            unplaced=[[len(p.unplaced_pods) for p in plan.plans]
                      for plan in (plan0, plan1)],
            plans=[sharded_view(plan) for plan in (plan0, plan1)],
            delta_reason=svc.last_delta.reason, stats=svc.stats(),
            instants=failover_instants(side["obs"]),
            metric=moved(m0, failovers_total(side["metrics"])))

    out = run_sides(script, catalogs)
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port["survivors"] == ["cpu:1", "cpu:2"]
    assert port["failovers"] == 1 and port["reason"] == "device_failover"
    assert port["delta_reason"] == "device_failover"
    assert port["unplaced"][0] == port["unplaced"][1]
    assert port["stats"]["quarantined_devices"] == ["cpu:0"]
    assert port["instants"] == [("sharded.failover", {
        "reason": "device_failover", "survivors": 7, "quarantined": 1})]
    assert port["metric"] == {("device_failover",): 1.0}


@pytest.mark.slow
def test_flapping_quarantine_stops_rebuild_thrash_as_reference(catalogs):
    """``tests/test_faulttol.py::test_resilient_sharded_flapping_
    quarantine_stops_rebuild_thrash`` on both sides: the ladder walks the
    mesh down through the survivors until none remain, the degraded
    windows then cost no rebuild, and recovery costs exactly one.
    ``slow`` as the reference's own: the reference compiles its stacked
    solve on each of the seven meshes the ladder walks (10 s alone, over
    two minutes beside five other test workers)."""
    def script(name, side, cat):
        clock = FakeClock()
        board = make_board(name, clock, probe_runner=lambda d: True)
        board.probe_interval_s, board.probe_successes = 0.0, 1
        ft = __import__(("karpenter_tpu" if name == "ref"
                         else "karpenter_tpu_torch") + ".faulttol",
                        fromlist=["install_injector"])
        svc = side["resilient"](side["service"](2))
        svc.solve_window(cat, pods=make_pods(side["pod"], 24, 1))
        ft.install_injector(ScriptedInjector(["error"] * 24))
        windows, rebuilds, meshes = 1, [], []
        for i in range(27):
            svc.solve_window(cat, pods=make_pods(side["pod"], 24, 2 + i))
            windows += 1
            rebuilds.append(svc.rebuilds)
            meshes.append(tuple(mesh_ids(svc)))
        ft.clear_injector()
        assert svc.windows == windows
        quarantined = sorted(board.quarantined_ids())
        assert rebuilds[-1] == rebuilds[-2] == rebuilds[-3]
        flap = svc.rebuilds
        stats_flap = svc.stats()
        clock.advance(61.0)
        svc.solve_window(cat, pods=make_pods(side["pod"], 24, 50))
        return dict(quarantined=quarantined, rebuilds=rebuilds,
                    meshes=meshes, stats_flap=stats_flap,
                    recovered=sorted(board.quarantined_ids()),
                    extra_rebuilds=svc.rebuilds - flap,
                    failovers=svc.failovers, stats=svc.stats(),
                    reason=board.last_failover_reason,
                    degraded=svc.degraded_windows,
                    instants=len(failover_instants(side["obs"])))

    out = run_sides(script, catalogs)
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port["quarantined"] == [f"cpu:{i}" for i in range(8)]
    assert port["stats_flap"]["quarantined_devices"] == port["quarantined"]
    assert port["recovered"] == [] and port["extra_rebuilds"] == 1
    assert port["reason"] == "device_recovered"
    assert port["failovers"] == port["stats"]["failovers"] >= 1


def test_all_quarantined_raises_before_any_rebuild_as_reference(catalogs):
    """The plain service with every device quarantined: each kick raises
    ``DeviceFaultError(kind="quarantined")`` and pays no rebuild; one
    green probe later the next window rebuilds once, ``device_recovered``."""
    def script(name, side, cat):
        clock = FakeClock()
        board = make_board(name, clock, probe_runner=lambda d: True)
        board.probe_interval_s, board.probe_successes = 0.0, 1
        svc = side["service"](2)
        pods = make_pods(side["pod"], 30, 7)
        plan0 = sharded_view(svc.solve_window(cat, pods=pods))
        for i in range(8):
            for _ in range(3):
                board.record_fault(f"cpu:{i}", kind="error",
                                   kernel="sharded-solve")
        raised = []
        for _ in range(2):
            with pytest.raises(side["fault"]) as e:
                svc.solve_window(cat, pods=pods)
            raised.append((type(e.value).__name__, e.value.kind,
                           e.value.kernel))
        quarantined = svc.stats()["quarantined_devices"]
        rebuilds = svc.rebuilds
        clock.advance(61.0)
        plan1 = sharded_view(svc.solve_window(cat, pods=pods))
        return dict(raised=raised, quarantined=quarantined,
                    rebuilds=(rebuilds, svc.rebuilds),
                    reason=svc.last_delta.reason, same=plan0 == plan1,
                    stats=svc.stats())

    out = run_sides(script, catalogs)
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port["raised"] == [("DeviceFaultError", "quarantined",
                               "sharded-solve")] * 2
    assert port["quarantined"] == [f"cpu:{i}" for i in range(8)]
    assert port["rebuilds"] == (1, 2) and port["same"]
    assert port["reason"] == "device_recovered"
