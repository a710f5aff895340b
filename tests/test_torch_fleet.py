"""The port's fleet FFD scan and fleet solve against the reference.

``ffd_scan_fleet_reference`` (the plain PyTorch version of the fleet
launch of ``karpenter_tpu_torch/csrc/ffd_scan.cu``) must equal, exactly,
the reference's ``ffd_scan_pallas_fleet`` run in interpret mode, with a
distinct catalog per problem; a catalog expanded over the problems with
stride 0 must give what per-problem copies give.  ``fleet_solve_packed``
on the CPU must equal the reference's ``fleet_solve_pallas`` (interpret
mode) on one stacked ``FleetProblem``: dense, through the compact COO
fetch, and asynchronously.  Inputs are made from a seed with numpy and
handed to both sides.  The kernel itself is held against this plain
version on the card by ``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import karpenter_tpu.solver.pallas_kernel as pk
from karpenter_tpu.apis.pod import PodSpec, ResourceRequests
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud, generate_profiles
from karpenter_tpu.parallel import FleetProblem as JFleetProblem
from karpenter_tpu.parallel import fleet_solve_pallas
from karpenter_tpu.solver import encode
from karpenter_tpu.solver.jax_backend import _pad1, _pad2
from karpenter_tpu.solver.types import GROUP_BUCKETS, OFFERING_BUCKETS, bucket

from karpenter_tpu_torch.parallel import (
    CooCapacity, FleetProblem, fleet_solve_packed,
)
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import ffd_scan_fleet

BIG = 1 << 30


def problem_inputs(rng, G, O, alloc=None):
    """One FFD problem: meta [G, 8], compat [G, O] int32 and, unless
    given, its own catalog alloc [O, 4] and rank [O]."""
    meta = np.zeros((G, 8), np.int32)
    meta[:, 0] = rng.choice([0, 250, 500, 1000, 4000], G)
    meta[:, 1] = rng.choice([0, 512, 1024, 8192], G)
    meta[:, 2] = rng.choice([0, 0, 0, 1], G)
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 60, G)
    meta[:, 5] = np.where(rng.rand(G) < 0.2, 1, BIG)
    compat = (rng.rand(G, O) < 0.7).astype(np.int32)
    if alloc is not None:
        return meta, compat
    alloc = np.zeros((O, 4), np.int32)
    alloc[:, 0] = rng.choice([2000, 4000, 16000, 64000], O)
    alloc[:, 1] = rng.choice([4096, 16384, 65536], O)
    alloc[:, 2] = rng.choice([0, 0, 4], O)
    alloc[:, 3] = rng.choice([30, 60, 110], O)
    rank = (rng.rand(O) * 3 + 0.05).astype(np.float32)
    rank[1::7] = rank[0]                 # ties: the first index decides
    return meta, compat, alloc, rank


def fleet_inputs(seed, C=4, G=32, O=128):
    """C problems with distinct catalogs, stacked."""
    rng = np.random.RandomState(seed)
    probs = [problem_inputs(rng, G, O) for _ in range(C)]
    return tuple(np.stack([p[i] for p in probs]) for i in range(4))


def reference_fleet(meta, compat, alloc, rank, N):
    C, G, O = compat.shape
    alloc8 = np.zeros((C, 8, O), np.int32)
    alloc8[:, :4] = alloc.transpose(0, 2, 1)
    out = pk.ffd_scan_pallas_fleet(
        jnp.asarray(meta), jnp.asarray(compat), jnp.asarray(alloc8),
        jnp.asarray(rank[:, None, :]), C=C, G=G, O=O, N=N, interpret=True)
    return tuple(np.asarray(x) for x in out)


def port_fleet(meta, compat, alloc, rank, N):
    t = torch.from_numpy
    return tuple(x.numpy() for x in ffd_scan_fleet(
        t(meta), t(compat), t(alloc), t(rank), N))


def assert_same(a, b):
    for x, y, name in zip(a, b, ("node_off", "assign", "unplaced")):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("seed", range(4))
def test_fleet_reference_matches_pallas_interpret(seed):
    """Distinct per-problem catalogs: each problem reads its own."""
    meta, compat, alloc, rank = fleet_inputs(seed)
    N = 128
    got = port_fleet(meta, compat, alloc, rank, N)
    assert_same(got, reference_fleet(meta, compat, alloc, rank, N))
    # the catalogs really differ, and so do the solves
    assert not (alloc == alloc[:1]).all()
    assert not (got[0] == got[0][:1]).all()


def test_fleet_edge_cases_match_pallas_interpret():
    """An unplaceable group and an exhausted node axis inside a fleet."""
    meta, compat, alloc, rank = fleet_inputs(9, C=2)
    compat[0, 0] = 0
    meta[0, 0, 4] = 17
    meta[1, :, 4] = np.random.RandomState(9).randint(40, 200, 32)
    N = 128
    got = port_fleet(meta, compat, alloc, rank, N)
    assert_same(got, reference_fleet(meta, compat, alloc, rank, N))
    assert got[2][0, 0] == 17
    assert (got[0][1] >= 0).all() and got[2][1].sum() > 0


def test_expanded_catalog_matches_per_problem_copies():
    """One catalog expanded over C with stride 0 (the window batch) gives
    what C stacked copies of it give, and what the shared-catalog
    ``ffd_scan`` gives."""
    rng = np.random.RandomState(21)
    C, G, O, N = 5, 32, 128, 64
    _, _, alloc, rank = problem_inputs(rng, G, O)
    probs = [problem_inputs(rng, G, O, alloc) for _ in range(C)]
    meta = torch.from_numpy(np.stack([p[0] for p in probs]))
    compat = torch.from_numpy(np.stack([p[1] for p in probs]))
    a, r = torch.from_numpy(alloc), torch.from_numpy(rank)
    expanded = ffd_scan_fleet(meta, compat, a.expand(C, O, 4),
                              r.expand(C, O), N)
    copies = ffd_scan_fleet(meta, compat, a.repeat(C, 1, 1),
                            r.repeat(C, 1), N)
    shared = ffd_kernel.ffd_scan(meta, compat, a, r, N)
    for x, y, z in zip(expanded, copies, shared):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_cpu_tensors_never_count_a_launch():
    before = dict(ffd_kernel.LAUNCHES)
    meta, compat, alloc, rank = fleet_inputs(0, C=2)
    port_fleet(meta, compat, alloc, rank, 64)
    assert ffd_kernel.LAUNCHES == before


def test_fleet_wrapper_rejects_bad_inputs():
    meta, compat, alloc, rank = (torch.from_numpy(x)
                                 for x in fleet_inputs(0, C=2))
    with pytest.raises(ValueError, match="alloc"):
        ffd_scan_fleet(meta, compat, alloc[0], rank, 64)       # not [C,O,4]
    with pytest.raises(ValueError, match="rank"):
        ffd_scan_fleet(meta, compat, alloc, rank[:, :64], 64)
    with pytest.raises(ValueError, match="meta"):
        ffd_scan_fleet(meta.to(torch.int64), compat, alloc, rank, 64)


@pytest.mark.parametrize("layout", ["expanded", "stacked", "single"])
def test_problem_stride_accepts_only_contiguous_rows(layout):
    a = torch.zeros((7, 4), dtype=torch.int32)
    t = {"expanded": a.expand(3, 7, 4),
         "stacked": torch.zeros((3, 7, 4), dtype=torch.int32),
         "single": torch.zeros((6, 7, 4), dtype=torch.int32)[::6]}[layout]
    want = {"expanded": 0, "stacked": 28, "single": 0}[layout]
    assert ffd_kernel._problem_stride(t, "alloc") == want
    with pytest.raises(ValueError, match="contiguous"):
        ffd_kernel._problem_stride(
            torch.zeros((3, 7, 8), dtype=torch.int32)[:, :, :4], "alloc")
    with pytest.raises(ValueError, match="stride 0"):
        ffd_kernel._problem_stride(
            torch.zeros((6, 7, 4), dtype=torch.int32)[::2], "alloc")


# -- the fleet solve ----------------------------------------------------------


def build_fleet(C=4, pods_per=150):
    """tests/test_fleet_pallas.py's fleet, with a catalog of its own per
    cluster (another profile count and price scale each)."""
    per = []
    for c in range(C):
        cloud = FakeCloud(profiles=generate_profiles(6 + 2 * c))
        pricing = PricingProvider(cloud)
        catalog = CatalogArrays.build(
            InstanceTypeProvider(cloud, pricing).list())
        pricing.close()
        rng = np.random.RandomState(100 + c)
        sizes = [(250, 512), (1000, 4096), (4000, 16384)]
        pods = [PodSpec(f"c{c}p{i}",
                        requests=ResourceRequests(*sizes[rng.randint(3)],
                                                  0, 1))
                for i in range(pods_per)]
        prob = encode(pods, catalog)
        G = bucket(prob.num_groups, GROUP_BUCKETS)
        O = bucket(catalog.num_offerings, OFFERING_BUCKETS)
        scale = np.float32(1.0 + 0.25 * c)
        per.append((
            _pad2(prob.group_req, G), _pad1(prob.group_count, G),
            _pad1(prob.group_cap, G), _pad2(prob.compat, G, O),
            _pad2(catalog.offering_alloc().astype(np.int32), O),
            _pad1(catalog.off_price.astype(np.float32) * scale, O),
            _pad1(catalog.offering_rank_price() * scale, O)))
    arrays = [np.stack([p[i] for p in per]) for i in range(7)]
    return JFleetProblem(*arrays), FleetProblem(*arrays)


def assert_fleet_equal(got, want):
    for name, a, b in zip(("node_off", "assign", "unplaced"), got, want):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=1e-5)


@pytest.mark.parametrize("right_size", [False, True])
def test_fleet_solve_matches_reference(right_size):
    jfleet, tfleet = build_fleet()
    assert not (tfleet.off_alloc == tfleet.off_alloc[:1]).all()
    got = fleet_solve_packed(tfleet, num_nodes=128, device="cpu",
                             right_size=right_size)
    want = fleet_solve_pallas(jfleet, num_nodes=128, right_size=right_size,
                              interpret=True)
    assert_fleet_equal(got, want)
    assert (got[2] == 0).all()


def test_fleet_compact_coo_roundtrip():
    """A COO fetch that starts too small overflows, grows (and stays
    grown in the shared state), and parses to the dense result."""
    jfleet, tfleet = build_fleet(C=2)
    dense = fleet_solve_packed(tfleet, num_nodes=128, device="cpu")
    coo = CooCapacity(8, 4096)
    got = fleet_solve_packed(tfleet, num_nodes=128, device="cpu",
                             coo_state=coo)
    assert coo.k > 8
    assert_fleet_equal(got, dense)
    assert_fleet_equal(got, fleet_solve_pallas(jfleet, num_nodes=128,
                                               interpret=True, compact=1024))


def test_fleet_async_matches_sync():
    _, tfleet = build_fleet(C=2)
    fin = fleet_solve_packed(tfleet, num_nodes=128, device="cpu",
                             async_only=True)
    sync = fleet_solve_packed(tfleet, num_nodes=128, device="cpu")
    for a, b in zip(fin(), sync):
        np.testing.assert_array_equal(a, b)


def test_fleet_resident_buffer_is_not_served():
    _, tfleet = build_fleet(C=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fleet_solve_packed(tfleet, num_nodes=128, device="cpu",
                           resident_buf=object())


def test_fleet_default_device_is_the_card(monkeypatch):
    _, tfleet = build_fleet(C=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        fleet_solve_packed(tfleet, num_nodes=128)
