"""The resident store of the port against the reference's.

``update_resident`` must scatter a padded word delta as the reference's
``.at[].set(mode="drop")`` does, at every ``DELTA_BUCKETS`` rung (the
port writes the padding into a spare last word); ``solve_resident`` must
return the reference's words over a churn stream, the cost word
included; ``TorchSolver(resident="on")`` must plan as resident off
and as ``JaxSolver(resident="on")``; the store's ladder (rebuild, delta,
hit) and its rebuild reasons must follow the reference's; the fleet's
``resident_buf`` must give the results of a fleet without it.  A failing
resident program fails the solve and invalidates the store.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.resident import kernels as j_kernels
from karpenter_tpu.resident.delta import DELTA_BUCKETS as J_BUCKETS
from karpenter_tpu.resident.delta import pad_delta as j_pad_delta
from karpenter_tpu.serving.validate import _churn_stream as j_churn
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode

from karpenter_tpu_torch.parallel import fleet_solve_packed
from karpenter_tpu_torch.resident import kernels as t_kernels
from karpenter_tpu_torch.resident import resident_enabled
from karpenter_tpu_torch.resident.delta import (
    DELTA_BUCKETS, pack_window, pad_delta, pod_churn,
)
from karpenter_tpu_torch.resident.store import (
    ResidentBuffer, ResidentStore, plan_update, resident_store_of,
)
from karpenter_tpu_torch.serving.validate import _churn_stream as t_churn
from karpenter_tpu_torch.solver import (
    SolverOptions as TSolverOptions, TorchSolver,
)
from karpenter_tpu_torch.solver import encode as t_encode
from tests.test_torch_fleet import build_fleet
from tests.test_torch_packed import assert_words_equal
from tests.test_torch_solver import assert_plans_equal


def test_ladder_constants_match_reference():
    assert DELTA_BUCKETS == J_BUCKETS


@pytest.mark.parametrize("rung", DELTA_BUCKETS)
def test_update_resident_drops_padding(rung):
    """A delta that lands on ``rung``: equal to the reference's scatter,
    the padding in the spare word only."""
    rng = np.random.RandomState(rung)
    L = 2 * rung + 17
    flat = rng.randint(-2 ** 31, 2 ** 31 - 1, L).astype(np.int32)
    n = rung // 2 + 1 if rung > DELTA_BUCKETS[0] else 5
    idx = np.sort(rng.choice(L, n, replace=False))
    val = rng.randint(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    didx, dval = pad_delta(idx, val, L)
    assert didx.size == rung
    jd = j_pad_delta(idx, val, L)
    np.testing.assert_array_equal(didx, jd[0])
    ref = np.asarray(j_kernels.update_resident(jnp.asarray(flat), didx,
                                               dval))
    state = t_kernels.new_state(flat, "cpu")
    got = t_kernels.update_resident(state, torch.from_numpy(didx),
                                    torch.from_numpy(dval))
    assert got is state
    np.testing.assert_array_equal(got[:-1].numpy(), ref)
    want = flat.copy()
    want[idx] = val
    np.testing.assert_array_equal(ref, want)


def test_new_state_is_not_a_view_of_the_mirror():
    flat = np.arange(10, dtype=np.int32)
    state = t_kernels.new_state(flat, "cpu")
    state[0] = 99
    assert flat[0] == 0 and state.shape[0] == 11


def _prepared(solver, pods, catalog):
    prep = solver._prepare(encode(pods, catalog))
    return prep, prep.packed.reshape(-1)


def test_solve_resident_matches_reference_over_churn():
    """The reference's churn stream (seeded, 48 pods x 6 types, 6
    windows): each window's delta through both ``solve_resident``s, the
    words equal, the carried states equal to the freshly packed buffer."""
    js = JaxSolver(SolverOptions(backend="jax", use_pallas="off"))
    for seed in range(3):
        seqs, catalog = j_churn(48, 6, 6, seed)
        jstate = tstate = mirror = None
        for pods in seqs:
            prep, flat = _prepared(js, pods, catalog)
            G, O, U, N = prep.G_pad, prep.O_pad, prep.U_pad, prep.N
            cat = js._device_offerings(catalog, O)
            if mirror is None or mirror.shape != flat.shape:
                mirror = flat.copy()
                jstate = jnp.asarray(flat)
                tstate = t_kernels.new_state(flat, "cpu")
                idx = np.empty(0, np.int64)
            else:
                idx = np.nonzero(mirror != flat)[0]
                mirror[idx] = flat[idx]
            didx, dval = pad_delta(idx, flat[idx], flat.size)
            jstate, ref = j_kernels.solve_resident(
                jstate, didx, dval, *cat, G=G, O=O, U=U, N=N)
            tstate, got = t_kernels.solve_resident(
                tstate, torch.from_numpy(didx), torch.from_numpy(dval),
                *(torch.from_numpy(np.array(x)) for x in cat), G=G, O=O,
                U=U, N=N)
            assert_words_equal(np.asarray(ref), got.numpy(), G, N)
            np.testing.assert_array_equal(tstate[:-1].numpy(), flat)
            np.testing.assert_array_equal(np.asarray(jstate), flat)


def _plan_key(plan):
    return ([(n.instance_type, n.zone, n.capacity_type, tuple(n.pod_names))
             for n in plan.nodes], tuple(plan.unplaced_pods),
            round(plan.total_cost_per_hour, 6))


@pytest.mark.parametrize("seed", range(3))
def test_resident_plans_match(seed):
    """resident on == resident off == JaxSolver(resident="on"), window by
    window, and the windows after the first ride deltas or hits."""
    jseqs, jcat = j_churn(64, 6, 5, 10 + seed)
    tseqs, tcat = t_churn(64, 6, 5, 10 + seed)
    jon = JaxSolver(SolverOptions(backend="jax", use_pallas="off",
                                  resident="on"))
    on = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    off = TorchSolver(TSolverOptions(resident="off"), device="cpu")
    modes = []
    for jpods, tpods in zip(jseqs + jseqs[-1:], tseqs + tseqs[-1:]):
        tprob = t_encode(tpods, tcat)
        plan = on.solve_encoded(tprob)
        assert on.last_stats["path"] == "resident-cpu"
        modes.append(on.last_stats["resident_mode"])
        assert _plan_key(plan) == _plan_key(off.solve_encoded(tprob))
        assert_plans_equal(jon.solve_encoded(encode(jpods, jcat)), plan)
        snap = on.resident.snapshot_state()
        np.testing.assert_array_equal(snap["mirror"], snap["device"])
    assert modes[0] == "rebuild" and modes[-1] == "hit"
    assert "delta" in modes
    assert jon.resident.stats()["windows"] == on.resident.stats()["windows"]
    assert off.resident is None and resident_store_of(on) is on.resident


def test_resident_gate(monkeypatch):
    monkeypatch.delenv("KARPENTER_ENABLE_RESIDENT", raising=False)
    assert not resident_enabled(TSolverOptions())
    assert resident_enabled(TSolverOptions(resident="on"))
    monkeypatch.setenv("KARPENTER_ENABLE_RESIDENT", "1")
    assert resident_enabled(TSolverOptions())
    assert not resident_enabled(TSolverOptions(resident="off"))
    assert TorchSolver(TSolverOptions(), device="cpu").resident is not None


def test_store_ladder_and_rebuild_reasons():
    """cold rebuild, hit, delta; a generation bump rebuilds; another
    catalog is another state (cold).  Oversized deltas and shape changes:
    the next test."""
    seqs, catalog = t_churn(64, 6, 3, 21)
    solver = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    store = solver.resident

    def run(pods):
        solver.solve_encoded(t_encode(pods, catalog))
        return store.last_delta

    assert (run(seqs[0]).mode, store.last_delta.reason) == ("rebuild", "cold")
    assert run(seqs[0]).mode == "hit"
    d = run(seqs[1])
    assert d.mode == "delta" and 0 < d.words and d.h2d_bytes == 8 * 64
    catalog.generation += 1
    d = run(seqs[1])
    assert (d.mode, d.reason) == ("rebuild", "generation")
    assert run(seqs[1]).mode == "hit"
    # another catalog is another state: cold, and the first state stays
    pods7, catalog7 = t_churn(64, 7, 1, 5)
    solver.solve_encoded(t_encode(pods7[0], catalog7))
    assert (store.last_delta.mode, store.last_delta.reason) == ("rebuild",
                                                                "cold")
    assert run(seqs[1]).mode == "hit"
    stats = store.stats()
    assert (stats["rebuilds"], stats["states"], stats["windows"]) == (3, 2, 7)


def test_oversized_delta_and_shape_change_rebuild():
    buf = ResidentBuffer("t")
    a = np.arange(1000, dtype=np.int32)
    dev, d = buf.update(a, "cpu", ("g", 1))
    assert (d.mode, d.reason) == ("rebuild", "cold")
    b = a.copy()
    b[:600] += 1
    _, d = buf.update(b, "cpu", ("g", 1))
    assert (d.mode, d.reason) == ("rebuild", "delta_too_large")
    _, d = buf.update(np.arange(1200, dtype=np.int32), "cpu", ("g", 1))
    assert (d.mode, d.reason) == ("rebuild", "shape")
    c = np.arange(1200, dtype=np.int32)
    c[7] = -1
    dev, d = buf.update(c, "cpu", ("g", 1))
    assert d.mode == "delta" and d.words == 1
    np.testing.assert_array_equal(dev.numpy(), c)
    assert buf.stats == {"hit": 0, "delta": 1, "rebuild": 3}
    reason, idx = plan_update(buf, c, ("g", 2))
    assert reason == "generation" and idx is None


def test_track_window_and_churn():
    seqs, catalog = t_churn(64, 6, 2, 4)
    store = ResidentStore("cpu")
    d0 = store.track_window(seqs[0], catalog)
    d1 = store.track_window(seqs[1], catalog)
    assert d0.mode == "rebuild" and d0.arrivals == 64
    arr, dep, _ = pod_churn(frozenset(p.namespace + "/" + p.name
                                      for p in seqs[0]), seqs[1])
    assert (d1.arrivals, d1.departures) == (arr, dep)
    snap = store.snapshot_state()
    packed, _ = pack_window(t_encode(seqs[1], catalog))
    np.testing.assert_array_equal(snap["device"], packed)


def test_failing_resident_program_raises_and_invalidates(monkeypatch):
    """A device fault of the resident program (a hand kernel's failed
    launch) invalidates the store and raises; the next window rebuilds.
    A host-side failure re-runs on the classic route, as the reference's
    (tests/test_torch_degraded.py)."""
    from karpenter_tpu_torch.cuda_build import KernelLaunchError
    from karpenter_tpu_torch.faulttol import DeviceFaultError
    from karpenter_tpu_torch.faulttol import health

    # a board of the test's own: the fault it records must not count
    # toward a quarantine of the worker's CPU device
    monkeypatch.setattr(health, "_BOARD", None)

    seqs, catalog = t_churn(48, 6, 2, 8)
    solver = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    solver.solve_encoded(t_encode(seqs[0], catalog))

    def broken(*a, **k):
        raise KernelLaunchError("ffd_scan", 1, "resident program failed")

    monkeypatch.setattr(t_kernels, "solve_resident", broken)
    solver.last_stats = {}
    with pytest.raises(DeviceFaultError, match="resident program failed"):
        solver.solve_encoded(t_encode(seqs[1], catalog))
    assert solver.last_stats == {}
    assert solver.resident.invalidations == 1
    monkeypatch.undo()
    solver.solve_encoded(t_encode(seqs[1], catalog))
    assert (solver.resident.last_delta.mode,
            solver.resident.last_delta.reason) == ("rebuild",
                                                   "dispatch_error")


def test_fleet_resident_buffer_equal_hits_and_deltas():
    """Window 1 again is a hit; one cluster churned is a delta; every
    result equals the fleet without the buffer."""
    _, problem = build_fleet(C=3, pods_per=60)
    kw = dict(num_nodes=128, device="cpu")
    buf = ResidentBuffer("fleet")
    for _ in range(2):
        got = fleet_solve_packed(problem, resident_buf=buf, **kw)
        for a, b in zip(fleet_solve_packed(problem, **kw), got):
            np.testing.assert_array_equal(a, b)
    assert buf.stats == {"hit": 1, "delta": 0, "rebuild": 1}
    problem.group_count[1, 0] += 3          # one cluster churns
    churned = fleet_solve_packed(problem, resident_buf=buf, **kw)
    for a, b in zip(fleet_solve_packed(problem, **kw), churned):
        np.testing.assert_array_equal(a, b)
    assert buf.stats == {"hit": 1, "delta": 1, "rebuild": 1}
