"""Tests of the port that need the card (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip without a CUDA device.
On the card they run without the JAX reference (which is not installed
there), and without tests/conftest.py, which imports it:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_cuda.py -m cuda

Each kernel is held against its plain PyTorch version on the same CUDA
tensors (exact int32 equality), and the solver on the card against the
solver on the CPU.
"""

import warnings

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import SolveRequest, TorchSolver, validate_plan
from karpenter_tpu_torch import encode, workload
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import (
    VARIANTS, chain_branches, ffd_scan, ffd_scan_fleet,
    ffd_scan_fleet_reference, ffd_scan_reference, scan_variant,
)

BIG = 1 << 30


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(seed, G=48, O=256):
    rng = np.random.RandomState(seed)
    meta = np.zeros((G, 8), np.int32)
    meta[:, 0] = rng.choice([0, 250, 1000, 4000], G)
    meta[:, 1] = rng.choice([0, 512, 8192], G)
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 80, G)
    meta[:, 5] = np.where(rng.rand(G) < 0.2, 1, BIG)
    compat = (rng.rand(G, O) < 0.7).astype(np.int32)
    alloc = np.zeros((O, 4), np.int32)
    alloc[:, 0] = rng.choice([2000, 16000, 64000], O)
    alloc[:, 1] = rng.choice([4096, 65536], O)
    alloc[:, 3] = rng.choice([30, 110], O)
    rank = (rng.rand(O) * 3 + 0.05).astype(np.float32)
    rank[1::5] = rank[0]
    return meta, compat, alloc, rank


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 384, 1024, 8192])
def test_ffd_kernel_matches_plain_version(cuda_device, N):
    for seed in range(8):
        meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                     for x in _inputs(seed))
        for c in (compat, compat.to(torch.uint8)):
            before = ffd_kernel.LAUNCHES["ffd_scan"]
            got = ffd_scan(meta[None], c[None], alloc, rank, N)
            assert ffd_kernel.LAUNCHES["ffd_scan"] == before + 1
            want = ffd_scan_reference(meta[None], c[None], alloc, rank, N)
            for x, y in zip(got, want):
                assert torch.equal(x, y)


@pytest.mark.cuda
def test_ffd_kernel_problem_grid(cuda_device):
    """C problems in one launch (gridDim.x = C) equal one launch each."""
    probs = [_inputs(s) for s in range(4)]
    meta = torch.from_numpy(np.stack([p[0] for p in probs])).to(cuda_device)
    compat = torch.from_numpy(np.stack([p[1] for p in probs])).to(
        cuda_device)
    alloc = torch.from_numpy(probs[0][2]).to(cuda_device)
    rank = torch.from_numpy(probs[0][3]).to(cuda_device)
    grid = ffd_scan(meta, compat, alloc, rank, 256)
    for c in range(4):
        one = ffd_scan(meta[c:c + 1], compat[c:c + 1], alloc, rank, 256)
        for x, y in zip(grid, one):
            assert torch.equal(x[c], y[0])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2])
def test_solver_on_card_matches_cpu(cuda_device, seed):
    pods, catalog = workload.build_workload(1500, 40, seed=seed)
    on_card = TorchSolver(device="cuda")
    plan = on_card.solve(SolveRequest(pods, catalog))
    assert on_card.last_stats["path"] == "ffd-cuda"
    ref = TorchSolver(device="cpu").solve(SolveRequest(pods, catalog))
    assert [(n.offering_index, n.pod_names) for n in plan.nodes] == \
        [(n.offering_index, n.pod_names) for n in ref.nodes]
    assert plan.unplaced_pods == ref.unplaced_pods
    assert plan.total_cost_per_hour == pytest.approx(
        ref.total_cost_per_hour, rel=1e-5)
    assert validate_plan(plan, pods, catalog) == []


def _plan_view(plan):
    return ([(n.offering_index, n.pod_names) for n in plan.nodes],
            plan.unplaced_pods)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 512, 4096])
def test_fleet_kernel_per_problem_catalogs(cuda_device, N):
    """Every problem reads its own catalog: the fleet launch equals its
    plain version exactly, int32 and uint8 compat."""
    probs = [_inputs(s) for s in range(6)]
    meta, compat, alloc, rank = (
        torch.from_numpy(np.stack([p[i] for p in probs])).to(cuda_device)
        for i in range(4))
    for c in (compat, compat.to(torch.uint8)):
        before = ffd_kernel.LAUNCHES["ffd_scan_fleet"]
        got = ffd_scan_fleet(meta, c, alloc, rank, N)
        assert ffd_kernel.LAUNCHES["ffd_scan_fleet"] == before + 1
        want = ffd_scan_fleet_reference(meta, c, alloc, rank, N)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


@pytest.mark.cuda
def test_fleet_kernel_expanded_catalog(cuda_device):
    """One catalog expanded over C (stride 0) equals the plain version
    and the problems launched one by one."""
    probs = [_inputs(s) for s in range(16)]
    meta = torch.from_numpy(np.stack([p[0] for p in probs])).to(cuda_device)
    compat = torch.from_numpy(np.stack([p[1] for p in probs])).to(
        cuda_device)
    alloc = torch.from_numpy(probs[0][2]).to(cuda_device)
    rank = torch.from_numpy(probs[0][3]).to(cuda_device)
    C, O = 16, alloc.shape[0]
    got = ffd_scan_fleet(meta, compat, alloc.expand(C, O, 4),
                         rank.expand(C, O), 512)
    want = ffd_scan_reference(meta, compat, alloc, rank, 512)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    for c in range(C):
        one = ffd_scan(meta[c:c + 1], compat[c:c + 1], alloc, rank, 512)
        for x, y in zip(got, one):
            assert torch.equal(x[c], y[0])


@pytest.mark.cuda
def test_solve_encoded_batch_on_card_matches_cpu(cuda_device):
    """Three windows of one catalog in one batch on the card: the plans
    of the CPU batch, each validated clean."""
    catalog = workload.build_catalog(40)
    windows = []
    for seed in (3, 4, 5):
        pods, _ = workload.build_workload(800, 40, seed=seed)
        windows.append((pods, encode(pods, catalog)))
    on_card = TorchSolver(device="cuda")
    before = ffd_kernel.LAUNCHES["ffd_scan_fleet"]
    with warnings.catch_warnings():
        # a vmapped op without a batching rule in this torch would run
        # as a loop over the rows, with a warning: none may
        warnings.simplefilter("error")
        plans = on_card.solve_encoded_batch([p for _, p in windows])
    assert ffd_kernel.LAUNCHES["ffd_scan_fleet"] > before
    assert on_card.last_stats["path"] == "ffd-cuda-batch"
    ref = TorchSolver(device="cpu").solve_encoded_batch(
        [p for _, p in windows])
    for (pods, _), plan, want in zip(windows, plans, ref):
        assert _plan_view(plan) == _plan_view(want)
        assert plan.total_cost_per_hour == pytest.approx(
            want.total_cost_per_hour, rel=1e-5)
        assert validate_plan(plan, pods, catalog) == []


def _exact(got, want):
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("O", [1, 129, 3000])
def test_ffd_kernel_ragged_offerings(cuda_device, O):
    """Offering counts that are not multiples of 4, 16 or 128: the rows
    the prologue writes are padded to 16 bytes, the catalog's rank row is
    staged word by word.  One problem and a fleet of three catalogs,
    int32 and uint8 compat."""
    probs = [_inputs(s, G=48, O=O) for s in (O, O + 1, O + 2)]
    meta, compat, alloc, rank = (
        torch.from_numpy(np.stack([p[i] for p in probs])).to(cuda_device)
        for i in range(4))
    for c in (compat, compat.to(torch.uint8)):
        _exact(ffd_scan(meta[:1], c[:1], alloc[0], rank[0], 256),
               ffd_scan_reference(meta[:1], c[:1], alloc[0], rank[0], 256))
        _exact(ffd_scan_fleet(meta, c, alloc, rank, 256),
               ffd_scan_fleet_reference(meta, c, alloc, rank, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("O, variant", [(3072, 2), (4096, 1), (5000, 0)])
def test_ffd_kernel_instantiations(cuda_device, O, variant):
    """Each instantiation of the chain kernel, picked by the shapes alone:
    N = 512 stages rows and catalog; N = 8192 with O = 4096 stages rows
    only; N = 8192 with O = 5000 reads both from global memory."""
    N = 512 if variant == 2 else 8192
    assert scan_variant(O, N) == VARIANTS[variant]
    meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                 for x in _inputs(variant, G=64, O=O))
    meta[:, 4] *= 4
    _exact(ffd_scan(meta[None], compat[None], alloc, rank, N),
           ffd_scan_reference(meta[None], compat[None], alloc, rank, N))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [64, 1024])
def test_ffd_kernel_no_request_groups(cuda_device, N):
    """Groups that request nothing fit FIT_BIG on every compatible open
    node, so the fill's int32 prefix sums wrap and the step sums the
    takes themselves: still equal to the plain version."""
    for seed in range(4):
        meta, compat, alloc, rank = _inputs(seed)
        free = np.random.RandomState(seed).rand(meta.shape[0]) < 0.35
        free[0] = False
        meta[free, :4] = 0
        meta[free, 5] = BIG
        meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                     for x in (meta, compat, alloc, rank))
        want = ffd_scan_reference(meta[None], compat[None], alloc, rank, N)
        _exact(ffd_scan(meta[None], compat[None], alloc, rank, N), want)
        assert chain_branches(meta[None], compat[None], alloc,
                              *want)["summed_takes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("G", [0, 1, 2, 3])
def test_ffd_kernel_short_windows(cuda_device, G):
    """G = 0 and G below the depth of the row ring."""
    meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                 for x in _inputs(G, G=G, O=256))
    got = ffd_scan(meta[None], compat[None], alloc, rank, 128)
    _exact(got, ffd_scan_reference(meta[None], compat[None], alloc, rank,
                                   128))
    if G == 0:
        assert (got[0] == -1).all()


@pytest.mark.cuda
def test_ffd_kernel_ulp_tie_and_branches(cuda_device):
    """Ranks one ulp apart that divide by a small rem to the same float:
    the capped sweep takes the lower index, as the plain version does;
    and over these windows both branches of the chain run."""
    rng = np.random.RandomState(9)
    while True:
        lo = np.float32(rng.rand() * 3 + 0.05)
        hi = np.nextafter(lo, np.float32(np.inf), dtype=np.float32)
        if hi / np.float32(3) == lo / np.float32(3) and \
                hi / np.float32(30) != lo / np.float32(30):
            break
    branches = {"uncapped": 0, "capped": 0}
    for seed in range(4):
        meta, compat, alloc, rank = _inputs(seed)
        rank[:2] = (hi, lo)
        rank[2:] = np.maximum(rank[2:], hi * 2)
        alloc[:2] = (64000, 65536, 0, 30)
        meta[0, :6] = (250, 512, 0, 1, 3, BIG)
        compat[0, :2] = 1
        meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                     for x in (meta, compat, alloc, rank))
        got = ffd_scan(meta[None], compat[None], alloc, rank, 256)
        want = ffd_scan_reference(meta[None], compat[None], alloc, rank, 256)
        _exact(got, want)
        assert int(got[0][0, 0]) == 0
        counts = chain_branches(meta[None], compat[None], alloc, *want)
        for k in branches:
            branches[k] += counts[k]
    assert branches["uncapped"] > 0 and branches["capped"] > 0
