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

import numpy as np
import pytest
import torch

from karpenter_tpu_torch import SolveRequest, TorchSolver, validate_plan
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import (
    ffd_scan, ffd_scan_reference,
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
