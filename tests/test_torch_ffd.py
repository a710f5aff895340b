"""The port's FFD scan against the reference kernel and scan.

``ffd_scan_reference`` (the plain PyTorch version of the CUDA kernel in
``karpenter_tpu_torch/csrc/ffd_scan.cu``) must equal, exactly, both the
reference's Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it on the CPU) and its ``lax.scan`` path (``solve_core`` without
right-sizing).  Inputs are made from a seed with numpy and handed to
both sides.  The CUDA kernel itself is held against this plain version
on the card by ``chip_smoke.py`` and tests/test_torch_cuda.py.

The kernel splits each step: the offering work that does not depend on
node state runs ahead in a prologue (``ffd_offers_reference``), and the
chain sweeps the offerings only when the pods left cap one.  The tests
below hold that split against the reference: the prologue's quantities
against the reference's own ``_fit_counts`` and ``_ffd_step``, the lemma
the uncapped branch rests on against the reference scan's own steps, and
the whole algorithm, emulated in numpy step for step, against the plain
version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import karpenter_tpu.solver.pallas_kernel as pk
from karpenter_tpu.solver.jax_backend import _ffd_step, _fit_counts, solve_core
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver.ffd_kernel import (
    chain_branches, ffd_offers_reference, ffd_scan,
)

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


def ulp_tie_inputs(seed, G=8, O=16):
    """A window whose capped argmin ties only after rounding: offerings 0
    and 1 have ranks one ulp apart (the higher price at index 0) that
    divide by a small rem to the same float, and both hold far more than
    rem pods, so the step's sweep must take index 0 on the tie."""
    rng = np.random.RandomState(seed)
    three = np.float32(3)
    while True:
        lo = np.float32(rng.rand() * 5 + 0.05)
        hi = np.nextafter(lo, np.float32(np.inf), dtype=np.float32)
        if hi / three == lo / three and hi / np.float32(50) != \
                lo / np.float32(50):
            break
    meta, compat, alloc, rank = make_inputs(seed, G=G, O=O)
    rank[:2] = (hi, lo)
    rank[2:] = np.maximum(rank[2:], hi * 2)
    alloc[:2] = (64000, 65536, 4, 110)
    meta[0, :4] = (500, 512, 0, 1)
    meta[0, 4:6] = (3, BIG)                    # rem = 3 on an empty window
    compat[0, :2] = 1
    return meta, compat, alloc, rank


def split_scan(meta, compat, alloc, rank, N):
    """The CUDA kernel's algorithm, step for step in numpy: the
    prologue's rows, then the chain with its three branches (rem <= 0
    opens nothing; rem >= maxfe takes the prologue's (best0, bf0); else
    the sweep of rank / min(fe0, rem)).  Returns the scan's outputs and
    the branch counts."""
    t = torch.from_numpy
    fe0, best0, bf0, maxfe = (x[0].numpy() for x in ffd_offers_reference(
        t(meta)[None], t(compat)[None], t(alloc)[None], t(rank)[None]))
    G = meta.shape[0]
    node_off = np.full(N, -1, np.int64)
    resid = np.zeros((N, 4), np.int64)
    ptr = 0
    assign = np.zeros((G, N), np.int64)
    unplaced = np.zeros(G, np.int64)
    branches = {"opens_nothing": 0, "uncapped": 0, "capped": 0,
                "summed_takes": 0}
    idx = np.arange(N)
    for g in range(G):
        req = meta[g, :4].astype(np.int64)
        count, cap = int(meta[g, 4]), int(meta[g, 5])
        ok = (node_off >= 0) & (compat[g][np.clip(node_off, 0, None)] != 0)
        per = np.where(req > 0, resid // np.maximum(req, 1), BIG).min(1)
        fit = np.minimum(np.where(ok, per, 0), cap)
        if count < 0 or (fit < 0).any() or (fit >= ffd_kernel.WIDE_FIT).any():
            branches["summed_takes"] += 1
        # the prefix sum wraps as the reference's int32 cumsum does
        cum = (np.cumsum(fit) - fit).astype(np.int32).astype(np.int64)
        take = np.clip((count - cum).astype(np.int32), 0, fit)
        resid -= take[:, None] * req
        rem = int(np.int32(np.int64(count) - take.sum()))
        best, bf = 0, 0
        if rem <= 0:
            branches["opens_nothing"] += 1
        elif rem >= maxfe[g]:
            branches["uncapped"] += 1
            best, bf = int(best0[g]), int(bf0[g])
        else:
            branches["capped"] += 1
            fe = np.minimum(fe0[g], rem)
            cpp = np.where(fe > 0, rank / np.maximum(fe, 1).astype(
                np.float32), np.float32(np.inf))
            best = int(np.argmin(cpp))
            bf = int(fe[best])
        n_new = min(-(-rem // bf) if bf > 0 else 0, N - ptr)
        j = idx - ptr
        pods = np.where((j >= 0) & (j < n_new),
                        np.clip(rem - j * bf, 0, max(bf, 0)), 0)
        opened = pods > 0
        node_off[opened] = best
        resid[opened] = alloc[best] - pods[opened, None] * req
        ptr += n_new
        assign[g] = take + pods
        unplaced[g] = rem - int(pods.sum())
    out = tuple(x.astype(np.int32) for x in (node_off, assign, unplaced))
    return out, branches


@pytest.mark.parametrize("O, N", [(1, 64), (129, 128), (3000, 256),
                                  (256, 8192)])
def test_reference_matches_scan_ragged_and_widest(O, N):
    """The plain version against the reference scan at offering counts
    that are not multiples of 4, 16 or 128 (the Pallas kernel in
    interpret mode needs O % 128 == 0, so the scan is the reference
    here) and at the widest node axis the kernel takes."""
    meta, compat, alloc, rank = make_inputs(300 + O, G=24, O=O,
                                            exhaust=N <= 64)
    assert_same(port(meta, compat, alloc, rank, N),
                reference_scan(meta, compat, alloc, rank, N))


def test_offers_reference_matches_reference_step():
    """The prologue's plain twin against the reference: fe0 from the
    reference's own ``_fit_counts``, and (best0, bf0) from the
    reference's ``_ffd_step`` on an empty window whose pods left, rem =
    count, are at least maxfe."""
    meta, compat, alloc, rank = make_inputs(21, G=32, O=131)
    rank[3::5] = rank[2]
    t = torch.from_numpy
    fe0, best0, bf0, maxfe = (x[0].numpy() for x in ffd_offers_reference(
        t(meta)[None], t(compat)[None], t(alloc)[None], t(rank)[None]))
    N = 8
    empty = (jnp.full(N, -1, jnp.int32), jnp.zeros((N, 4), jnp.int32),
             jnp.int32(0))
    uncapped = 0
    for g in range(meta.shape[0]):
        req = jnp.asarray(meta[g, :4])
        fit = np.asarray(_fit_counts(jnp.asarray(alloc), req))
        want = np.maximum(np.minimum(np.where(compat[g] > 0, fit, 0),
                                     meta[g, 5]), 0)
        np.testing.assert_array_equal(fe0[g], want)
        assert maxfe[g] == want.max()
        count = max(int(maxfe[g]), 1)
        (node_off, _, _), (assign_g, _) = _ffd_step(
            jnp.asarray(alloc), jnp.asarray(rank), empty,
            (req, jnp.int32(count), jnp.asarray(meta[g, 5]),
             jnp.asarray(compat[g] > 0)))
        if bf0[g] > 0:
            uncapped += 1
            assert int(node_off[0]) == best0[g]
            assert int(assign_g[0]) == bf0[g]
        else:
            assert int(node_off[0]) == -1
    assert uncapped > 0


@pytest.mark.parametrize("seed", range(4))
def test_uncapped_branch_lemma_on_reference_steps(seed):
    """The lemma the uncapped branch rests on: whenever rem >= max fe0,
    the first-index argmin of rank / min(fe0, rem) is that of rank / fe0
    (and the fits there are equal).  Checked with jnp on the rem of every
    step of the reference scan and on rem = maxfe, maxfe + 1, 2 maxfe + 7
    and FIT_BIG, with seeded rank ties."""
    meta, compat, alloc, rank = make_inputs(40 + seed, G=32, O=128)
    rank[2::3] = rank[1]
    N = 128
    node_off, assign, unplaced = reference_scan(meta, compat, alloc, rank, N)
    t = torch.from_numpy
    fe0 = ffd_offers_reference(t(meta)[None], t(compat)[None],
                               t(alloc)[None], t(rank)[None])[0][0].numpy()
    mask = assign > 0
    first = np.where(mask.any(0), mask.argmax(0), meta.shape[0])
    first[node_off < 0] = meta.shape[0]
    rank_j = jnp.asarray(rank)

    def argmin_at(fe):
        fe = jnp.asarray(fe)
        cpp = jnp.where(fe > 0, rank_j / fe.astype(jnp.float32), jnp.inf)
        b = int(jnp.argmin(cpp))
        return b, int(fe[b])

    from_steps = 0
    for g in range(meta.shape[0]):
        mx = int(fe0[g].max())
        rem = int(unplaced[g]) + int(assign[g, first == g].sum())
        rems = [mx, mx + 1, 2 * mx + 7, BIG]
        if rem >= mx and rem > 0:
            rems.append(rem)
            from_steps += 1
        base = argmin_at(fe0[g])
        for r in rems:
            assert argmin_at(np.minimum(fe0[g], r)) == base
    assert from_steps > 0


def no_request_inputs(seed, G=24, O=64):
    """``make_inputs`` where a third of the groups request nothing at all
    and are uncapped: every compatible open node fits FIT_BIG of them,
    so the int32 prefix sums of the fill wrap."""
    meta, compat, alloc, rank = make_inputs(seed, G=G, O=O)
    rng = np.random.RandomState(seed + 1)
    free = rng.rand(G) < 0.35
    free[0] = False                            # open some nodes first
    meta[free, :4] = 0
    meta[free, 5] = BIG
    return meta, compat, alloc, rank


@pytest.mark.parametrize("seed", range(2))
def test_no_request_groups_match_scan(seed):
    """Groups with no request wrap the fill's prefix sums: the plain
    version wraps them as the reference scan does, and the kernel's
    algorithm (which sums the takes on such steps) equals both."""
    meta, compat, alloc, rank = no_request_inputs(60 + seed)
    N = 64
    want = port(meta, compat, alloc, rank, N)
    assert_same(want, reference_scan(meta, compat, alloc, rank, N))
    got, branches = split_scan(meta, compat, alloc, rank, N)
    assert_same(got, want)
    t = torch.from_numpy
    assert chain_branches(t(meta)[None], t(compat)[None], t(alloc),
                          *(t(x)[None] for x in want)) == branches
    assert branches["summed_takes"] > 0


@pytest.mark.parametrize("seed", range(6))
def test_split_algorithm_matches_plain_version(seed):
    """The kernel's split of each step (prologue rows, then three
    branches), emulated in numpy, equals the plain version; its branch
    counts equal ``chain_branches`` on the plain version's outputs, and
    across these windows both the uncapped and the capped branch run."""
    if seed == 5:
        meta, compat, alloc, rank = ulp_tie_inputs(seed)
        N = 64
    else:
        O = (1, 129, 128, 300, 67)[seed]
        meta, compat, alloc, rank = make_inputs(500 + seed, G=40, O=O,
                                                exhaust=seed == 4)
        N = 64 if seed == 4 else 256
    got, branches = split_scan(meta, compat, alloc, rank, N)
    want = port(meta, compat, alloc, rank, N)
    assert_same(got, want)
    t = torch.from_numpy
    assert chain_branches(t(meta)[None], t(compat)[None], t(alloc),
                          *(t(x)[None] for x in want)) == branches
    if seed == 5:
        # the tie went to the lower index, the higher price
        assert want[0][0] == 0 and branches["capped"] > 0
    if seed in (2, 3):
        assert branches["uncapped"] > 0 and branches["capped"] > 0


def test_ulp_tie_case_matches_reference():
    """The one-ulp rank tie after division by rem: the plain version
    equals the reference scan, and picks index 0."""
    meta, compat, alloc, rank = ulp_tie_inputs(5)
    got = port(meta, compat, alloc, rank, 64)
    assert_same(got, reference_scan(meta, compat, alloc, rank, 64))
    assert got[0][0] == 0
