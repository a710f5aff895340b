"""The port's FFD scan against the reference kernel and scan.

``ffd_scan_reference`` (the plain PyTorch version of the CUDA kernel in
``karpenter_tpu_torch/csrc/ffd_scan.cu``) must equal, exactly, both the
reference's Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it on the CPU) and its ``lax.scan`` path (``solve_core`` without
right-sizing).  Inputs are made from a seed with numpy and handed to
both sides.  The CUDA kernel itself is held against this plain version
on the card by ``chip_smoke.py`` and tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import karpenter_tpu.solver.pallas_kernel as pk
from karpenter_tpu.solver.jax_backend import solve_core
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import ffd_scan

BIG = 1 << 30


def make_inputs(seed, G=32, O=128, unplaceable=False, exhaust=False):
    """Random FFD inputs: some zero-request dimensions, cap = 1 groups,
    unconstrained caps, 0/1 compat, per-offering allocatable and rank."""
    rng = np.random.RandomState(seed)
    meta = np.zeros((G, 8), np.int32)
    meta[:, 0] = rng.choice([0, 250, 500, 1000, 4000], G)
    meta[:, 1] = rng.choice([0, 512, 1024, 8192], G)
    meta[:, 2] = rng.choice([0, 0, 0, 1], G)
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 60, G)
    meta[:, 5] = np.where(rng.rand(G) < 0.2, 1, BIG)
    compat = (rng.rand(G, O) < 0.7).astype(np.int32)
    alloc = np.zeros((O, 4), np.int32)
    alloc[:, 0] = rng.choice([2000, 4000, 16000, 64000], O)
    alloc[:, 1] = rng.choice([4096, 16384, 65536], O)
    alloc[:, 2] = rng.choice([0, 0, 4], O)
    alloc[:, 3] = rng.choice([30, 60, 110], O)
    rank = (rng.rand(O) * 3 + 0.05).astype(np.float32)
    # ties in rank per pod: duplicate a few prices so the first-index
    # tie-break decides
    rank[1::7] = rank[0]
    if unplaceable:
        compat[0] = 0
        meta[0, 4] = 17
    if exhaust:
        meta[:, 4] = rng.randint(40, 200, G)
    return meta, compat, alloc, rank


def reference_pallas(meta, compat, alloc, rank, N):
    G, O = compat.shape
    alloc8 = np.zeros((8, O), np.int32)
    alloc8[:4] = alloc.T
    out = pk.ffd_scan_pallas(jnp.asarray(meta), jnp.asarray(compat),
                             jnp.asarray(alloc8), jnp.asarray(rank[None]),
                             G=G, O=O, N=N, interpret=True)
    return tuple(np.asarray(x) for x in out)


_scan = jax.jit(solve_core, static_argnames=("num_nodes", "right_size"))


def reference_scan(meta, compat, alloc, rank, N):
    out = _scan(jnp.asarray(meta[:, :4]), jnp.asarray(meta[:, 4]),
                jnp.asarray(meta[:, 5]), jnp.asarray(compat > 0),
                jnp.asarray(alloc), jnp.zeros(alloc.shape[0], jnp.float32),
                jnp.asarray(rank), num_nodes=N, right_size=False)
    return tuple(np.asarray(x) for x in out[:3])


def port(meta, compat, alloc, rank, N):
    out = ffd_scan(torch.from_numpy(meta)[None],
                   torch.from_numpy(compat)[None],
                   torch.from_numpy(alloc), torch.from_numpy(rank), N)
    return tuple(x[0].numpy() for x in out)


def assert_same(a, b):
    for x, y, name in zip(a, b, ("node_off", "assign", "unplaced")):
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("seed", range(8))
def test_reference_matches_pallas_interpret(seed):
    meta, compat, alloc, rank = make_inputs(seed)
    N = 128
    assert_same(port(meta, compat, alloc, rank, N),
                reference_pallas(meta, compat, alloc, rank, N))


@pytest.mark.parametrize("seed", range(8))
def test_reference_matches_scan(seed):
    meta, compat, alloc, rank = make_inputs(seed + 100)
    N = 128
    assert_same(port(meta, compat, alloc, rank, N),
                reference_scan(meta, compat, alloc, rank, N))


@pytest.mark.parametrize("case", ["unplaceable", "exhaust"])
def test_edge_cases_match_scan(case):
    meta, compat, alloc, rank = make_inputs(
        7, unplaceable=case == "unplaceable", exhaust=case == "exhaust")
    N = 64
    got = port(meta, compat, alloc, rank, N)
    assert_same(got, reference_scan(meta, compat, alloc, rank, N))
    if case == "unplaceable":
        assert got[2][0] == meta[0, 4]
    else:
        # node budget binding: every slot open and pods left over
        assert (got[0] >= 0).all() and got[2].sum() > 0


def test_tiled_grid_matches(monkeypatch):
    """The tiled-grid case of tests/test_pallas.py: a multi-block Pallas
    grid (group blocks smaller than G) gives the same scan as the port,
    whose kernel has no tiling at all."""
    G, O, N = 128, 128, 256
    rng = np.random.RandomState(11)
    meta = np.zeros((G, 8), np.int32)
    meta[:120, 0] = 100 + np.arange(120)
    meta[:120, 1] = 256
    meta[:120, 3] = 1
    meta[:120, 4] = 1
    meta[:120, 5] = BIG
    _, compat, alloc, rank = make_inputs(11, G=G, O=O)
    compat[:120] = (rng.rand(120, O) < 0.9).astype(np.int32)
    compat[120:] = 0
    monkeypatch.setattr(pk, "_VMEM_BUDGET", pk._block_vmem(32, O, N) + 1)
    gb = pk.choose_group_block(G, O, N)
    assert gb is not None and gb < G, (G, gb)
    assert_same(port(meta, compat, alloc, rank, N),
                reference_pallas(meta, compat, alloc, rank, N))


def test_problem_axis_and_uint8_compat():
    """C problems in one call (the fleet contract) and uint8 compat give
    the per-problem results."""
    probs = [make_inputs(s) for s in (1, 2, 3)]
    alloc, rank = probs[0][2], probs[0][3]
    meta = np.stack([p[0] for p in probs])
    compat = np.stack([p[1] for p in probs])
    N = 128
    out = ffd_scan(torch.from_numpy(meta),
                   torch.from_numpy(compat.astype(np.uint8)),
                   torch.from_numpy(alloc), torch.from_numpy(rank), N)
    for c in range(3):
        one = port(meta[c], compat[c], alloc, rank, N)
        assert_same(tuple(x[c].numpy() for x in out), one)


def test_cpu_tensors_never_count_a_launch():
    before = ffd_kernel.LAUNCHES["ffd_scan"]
    meta, compat, alloc, rank = make_inputs(0)
    port(meta, compat, alloc, rank, 64)
    assert ffd_kernel.LAUNCHES["ffd_scan"] == before


def test_wrapper_rejects_bad_inputs():
    meta, compat, alloc, rank = make_inputs(0)
    t = torch.from_numpy
    with pytest.raises(ValueError):
        ffd_scan(t(meta)[None].to(torch.int64), t(compat)[None], t(alloc),
                 t(rank), 64)
    with pytest.raises(ValueError):
        ffd_scan(t(meta)[None], t(compat)[None], t(alloc[:, :3].copy()),
                 t(rank), 64)
