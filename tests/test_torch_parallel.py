"""The port's device mesh and mesh solves against the reference's.

The reference runs each mesh path on the eight virtual CPU devices of
``tests/conftest.py``; the port runs it on eight CPU slots
``torch.device("cpu", i)`` of the same mesh shapes.  The same numpy
problems (``tests/test_parallel.py``'s builders, made from a seed) go
through both: node_off, assign and unplaced must be equal word for
word, the cost as the reference's own tests compare it (``rel=1e-6``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax

import karpenter_tpu.parallel as jpar
from karpenter_tpu.parallel.mesh import SHARD_AXIS as J_SHARD_AXIS
from karpenter_tpu.solver.jax_backend import solve_kernel

import karpenter_tpu_torch.faulttol as tft
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.parallel import (
    FleetProblem, Mesh, fleet_mesh, fleet_solve, fleet_solve_packed,
    fleet_solve_pallas_sharded, fleet_solve_sharded_offerings, shard_mesh,
    solver_mesh,
)
from karpenter_tpu_torch.parallel.collectives import (
    gather_global, pmax, pmin, psum,
)
from karpenter_tpu_torch.parallel.fleet import _pad_offerings
from karpenter_tpu_torch.parallel.mesh import SHARD_AXIS

from tests.test_coo_escalation import TestFleetEscalation as _CooFleet
from tests.test_parallel import (  # noqa: F401 (fixtures)
    N_NODES, big_catalog, build_hetero_problem, build_problem, catalog,
)

CPU8 = [torch.device("cpu", i) for i in range(8)]


def stacked(per):
    return [np.stack([p[i] for p in per]) for i in range(7)]


def both_problems(arrays):
    return jpar.FleetProblem(*arrays), FleetProblem(*arrays)


def assert_same(got, want, assign=True):
    node_off, asg, unplaced, cost = got
    np.testing.assert_array_equal(node_off, np.asarray(want[0]))
    if assign:
        np.testing.assert_array_equal(asg, np.asarray(want[1]))
    np.testing.assert_array_equal(unplaced, np.asarray(want[2]))
    np.testing.assert_allclose(cost, np.asarray(want[3]), rtol=1e-6)


@pytest.fixture(scope="module")
def fleet_arrays(catalog):
    return stacked([build_problem(seed, 60, catalog) for seed in range(8)])


@pytest.fixture(scope="module")
def offer_arrays(catalog):
    return stacked([build_problem(s, 50, catalog) for s in range(4)])


# -- meshes ------------------------------------------------------------------


def test_eight_reference_devices_and_cpu_slot_ids():
    """Slot i's board id is the reference's id of its i-th device, and a
    tensor placed on a CPU slot lands on the CPU."""
    assert [tft.device_id(d) for d in CPU8] == \
        [f"{d.platform}:{d.id}" for d in jax.devices()]
    assert torch.zeros(2, device=torch.device("cpu", 3)).device.type == "cpu"


@pytest.mark.parametrize("shards,n_dev,width", [
    (1, 1, 1), (2, 1, 1), (3, 1, 1), (8, 1, 1), (8, 8, 8), (6, 8, 6),
    (5, 4, 1), (4, 8, 4), (4, 3, 2)])
def test_shard_mesh_widths_equal_reference(shards, n_dev, width):
    mesh = shard_mesh(shards, devices=CPU8[:n_dev])
    ref = jpar.shard_mesh(shards, devices=jax.devices()[:n_dev])
    assert mesh.shape[SHARD_AXIS] == ref.shape[J_SHARD_AXIS] == width
    assert [tft.device_id(d) for d in mesh.devices.flat] == \
        [f"{d.platform}:{d.id}" for d in ref.devices.flat]


def test_mesh_shapes_and_errors_equal_reference():
    for fleet, offer in ((4, 2), (2, 4), (1, 5)):
        mesh = solver_mesh(fleet, offer, devices=CPU8)
        ref = jpar.solver_mesh(fleet, offer)
        assert mesh.shape == dict(ref.shape)
        assert mesh.devices.shape == ref.devices.shape
    assert fleet_mesh(4, devices=CPU8).shape == dict(jpar.fleet_mesh(4).shape)
    with pytest.raises(ValueError) as want:
        jpar.solver_mesh(4, 4)
    with pytest.raises(ValueError) as got:
        solver_mesh(4, 4, devices=CPU8)
    assert str(got.value) == str(want.value) == \
        "mesh 4x4 needs 16 devices, have 8"
    for bad in (0, -1):
        with pytest.raises(ValueError):
            jpar.shard_mesh(bad)
        with pytest.raises(ValueError, match="num_shards must be >= 1"):
            shard_mesh(bad, devices=CPU8)


def test_mixed_repeated_and_default_slots():
    with pytest.raises(ValueError, match="all cuda or all cpu"):
        Mesh(np.array([CPU8[0], torch.device("cuda", 0)], dtype=object),
             ("fleet",))
    with pytest.raises(ValueError, match="repeats a slot"):
        fleet_mesh(devices=[CPU8[1], CPU8[1]])
    if not torch.cuda.is_available():
        # the default slots are the cards: none here, so it raises
        for make in (lambda: fleet_mesh(), lambda: shard_mesh(2),
                     lambda: solver_mesh(1, 1)):
            with pytest.raises(RuntimeError, match="CUDA device requested"):
                make()


# -- collectives ---------------------------------------------------------------


def test_collectives_reduce_in_slot_order():
    big = np.int32(2 ** 31 - 1)
    ints = [torch.tensor([big, 5], dtype=torch.int32),
            torch.tensor([1, -7], dtype=torch.int32),
            torch.tensor([3, 2], dtype=torch.int32)]
    s = psum(ints)
    assert all(t.dtype == torch.int32 for t in s)
    assert s[0].tolist() == s[2].tolist() == \
        (np.array([big, 5], np.int32) + np.array([1, -7], np.int32)
         + np.array([3, 2], np.int32)).tolist()           # wraps as int32
    assert pmin(ints)[1].tolist() == [1, -7]
    assert pmax(ints)[0].tolist() == [big, 5]
    rng = np.random.RandomState(0)
    fl = rng.rand(4, 16).astype(np.float32) * 1e4
    want = fl[0]
    for row in fl[1:]:
        want = want + row
    got = psum([torch.from_numpy(r) for r in fl])[3].numpy()
    np.testing.assert_array_equal(got, want)              # bit for bit
    # gather_global: offerings [0, 12) over 3 slots of 4
    vals = rng.randint(0, 100, size=(2, 12, 3)).astype(np.int32)
    idx = np.array([[-1, 0, 5, 11], [7, 3, 3, 8]], np.int32)
    out = gather_global(
        [torch.from_numpy(vals[:, 4 * w:4 * (w + 1)]) for w in range(3)],
        [torch.from_numpy(idx)] * 3, [0, 4, 8])
    want = np.where((idx >= 0)[..., None],
                    vals[np.arange(2)[:, None], np.clip(idx, 0, None)], 0)
    for o in out:
        np.testing.assert_array_equal(o.numpy(), want)


# -- the fleet axis ------------------------------------------------------------


@pytest.mark.parametrize("width", [8, 4])
def test_fleet_solve_equals_reference(fleet_arrays, width):
    jp, tp = both_problems(fleet_arrays)
    want = jpar.fleet_solve(jp, jpar.fleet_mesh(width), num_nodes=N_NODES)
    got = fleet_solve(tp, fleet_mesh(width, devices=CPU8),
                      num_nodes=N_NODES)
    assert_same(got, want)
    assert (got[2] == 0).all()


def test_fleet_solve_guards_every_slot(fleet_arrays):
    """One guard over the mesh's devices: a quarantined slot refuses the
    whole dispatch, and a clean one records success on every slot."""
    from tests.test_torch_faulttol import FakeClock, make_board

    board = make_board("port", FakeClock())
    four = FleetProblem(*[a[:4] for a in fleet_arrays])
    try:
        n0 = get_devtel().snapshot()["dispatches"]
        fleet_solve(four, fleet_mesh(4, devices=CPU8), num_nodes=N_NODES)
        assert get_devtel().snapshot()["dispatches"] == n0 + 1
        assert set(board.snapshot()["devices"]) == {
            "cpu:0", "cpu:1", "cpu:2", "cpu:3"}
        for _ in range(3):
            board.record_fault("cpu:2", kind="error", kernel="fleet-scan")
        with pytest.raises(tft.DeviceQuarantinedError):
            fleet_solve(four, fleet_mesh(4, devices=CPU8),
                        num_nodes=N_NODES)
        with pytest.raises(ValueError, match="not divisible by fleet axis"):
            fleet_solve(FleetProblem(*[a[:6] for a in fleet_arrays]),
                        fleet_mesh(4, devices=CPU8[4:]), num_nodes=N_NODES)
    finally:
        board.reset()
        tft.health._BOARD = None


def test_fleet_solve_pallas_sharded_escalates_as_reference():
    jp = _CooFleet()._fleet(C=2, pods=100)
    arrays = [jp.group_req, jp.group_count, jp.group_cap, jp.compat,
              jp.off_alloc, jp.off_price, jp.off_rank]
    want = jpar.fleet_solve_pallas_sharded(
        jp, jpar.fleet_mesh(2), num_nodes=128, interpret=True, compact=64,
        compact_cap=4096)
    import karpenter_tpu_torch.parallel.fleet as pf

    grown = []
    real = pf.grow_coo
    pf.grow_coo = lambda K, cap: grown.append(K) or real(K, cap)
    try:
        got = fleet_solve_pallas_sharded(
            FleetProblem(*arrays), fleet_mesh(2, devices=CPU8),
            num_nodes=128, compact=64, compact_cap=4096)
    finally:
        pf.grow_coo = real
    assert grown == [64]                      # escalated once, whole mesh
    assert_same(got, want)


# -- the offer axis ------------------------------------------------------------


@pytest.mark.parametrize("fleet,offer", [(4, 2), (2, 4)])
def test_sharded_offerings_equal_reference_and_unsharded(offer_arrays,
                                                         fleet, offer):
    jp, tp = both_problems(offer_arrays)
    want = jpar.fleet_solve_sharded_offerings(
        jp, jpar.solver_mesh(fleet, offer), num_nodes=N_NODES)
    got = fleet_solve_sharded_offerings(
        tp, solver_mesh(fleet, offer, devices=CPU8), num_nodes=N_NODES)
    assert_same(got, want)
    assert_same(got, fleet_solve_packed(_pad_offerings(tp),
                                        num_nodes=N_NODES, device="cpu"))
    for c in range(4):
        ref = solve_kernel(*[a[c] for a in offer_arrays],
                           num_nodes=N_NODES)
        assert_same(tuple(x[c] for x in got), ref)


def test_sharded_offerings_tie_goes_to_the_lowest_global_index(
        offer_arrays):
    """The second half of every catalog copies the first: each cheapest
    offering is reached on two offer slots, and the lower index wins."""
    a = [x.copy() for x in offer_arrays]
    O = a[3].shape[2]
    h = O // 2
    a[3][:, :, h:] = a[3][:, :, :h]
    for k in (4, 5, 6):
        a[k][:, h:] = a[k][:, :h]
    jp, tp = both_problems(a)
    want = jpar.fleet_solve_sharded_offerings(
        jp, jpar.solver_mesh(2, 2), num_nodes=N_NODES)
    got = fleet_solve_sharded_offerings(
        tp, solver_mesh(2, 2, devices=CPU8), num_nodes=N_NODES)
    assert_same(got, want)
    opened = got[0][got[0] >= 0]
    assert opened.size and (opened < h).all()
    assert_same(got, fleet_solve_packed(_pad_offerings(tp),
                                        num_nodes=N_NODES, device="cpu"))


def test_indivisible_offerings_rejected(catalog):
    arrays = stacked([build_problem(0, 10, catalog)])
    jp, tp = both_problems(arrays)
    with pytest.raises(ValueError, match="not divisible") as want:
        jpar.fleet_solve_sharded_offerings(
            jp, jpar.solver_mesh(fleet=1, offer=5), num_nodes=N_NODES)
    with pytest.raises(ValueError, match="not divisible") as got:
        fleet_solve_sharded_offerings(
            tp, solver_mesh(1, 5, devices=CPU8), num_nodes=N_NODES)
    assert str(got.value) == str(want.value)


# -- full size ------------------------------------------------------------------


@pytest.mark.slow
class TestLargeShapeParity:
    """The reference's scale shapes (85 profiles: O = 512, G >= 512)."""

    @pytest.fixture(scope="class")
    def big_fleet(self, big_catalog):
        return stacked([build_hetero_problem(s, 600, big_catalog, 1024, 512)
                        for s in range(8)])

    def test_fleet_parity_at_scale(self, big_fleet):
        jp, tp = both_problems(big_fleet)
        want = jpar.fleet_solve(jp, jpar.fleet_mesh(8), num_nodes=128)
        assert_same(fleet_solve(tp, fleet_mesh(8, devices=CPU8),
                                num_nodes=128), want)

    def test_sharded_offerings_parity_at_scale(self, big_fleet):
        jp, tp = both_problems(big_fleet)
        want = jpar.fleet_solve_sharded_offerings(
            jp, jpar.solver_mesh(4, 2), num_nodes=128)
        assert_same(fleet_solve_sharded_offerings(
            tp, solver_mesh(4, 2, devices=CPU8), num_nodes=128), want)
