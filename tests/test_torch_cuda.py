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
    assert plan.total_cost_per_hour == ref.total_cost_per_hour
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
        assert plan.total_cost_per_hour == want.total_cost_per_hour
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


def _group_rank(rank, G, seed):
    """A rank row per group, formed as the pref scan forms it: the
    shared row scaled by 1 + 0.5 * miss, with fractional misses, and no
    preference (the shared row itself) for some groups."""
    rng = np.random.RandomState(seed)
    miss = rng.choice(np.float32([0, 1 / 3, 2 / 3, 1]),
                      size=(G, rank.shape[0]))
    miss[rng.rand(G) < 0.3] = 0
    return rank[None, :] * (np.float32(1) + np.float32(0.5) * miss)


@pytest.mark.cuda
@pytest.mark.parametrize("O, N, variant", [(3072, 512, 3), (4096, 4096, 4),
                                          (4096, 8192, 1), (5000, 8192, 0)])
def test_ffd_kernel_group_rank_rows(cuda_device, O, N, variant):
    """A rank row per group ([G, O], the soft-preference scan) in each
    instantiation of the chain kernel the per-group form takes (its ring
    slots also hold the group's rank row where that fits, with the
    catalog or without it), against the plain version;
    over the seeds both the uncapped and the capped branch run, each
    launch counts as ffd_scan_pref, and a fleet of [C, G, O] ranks equals
    its plain version too."""
    assert scan_variant(O, N, group_rank=True) == VARIANTS[variant]
    branches = {"uncapped": 0, "capped": 0}
    for seed in range(3):
        meta, compat, alloc, rank = _inputs(10 * variant + seed, G=64, O=O)
        rank_g = _group_rank(rank, 64, seed)
        meta, compat, alloc, rank_g = (
            torch.from_numpy(x).to(cuda_device)
            for x in (meta, compat, alloc, rank_g))
        before = dict(ffd_kernel.LAUNCHES)
        got = ffd_scan(meta[None], compat[None], alloc, rank_g, N)
        assert ffd_kernel.LAUNCHES["ffd_scan_pref"] == \
            before["ffd_scan_pref"] + 1
        assert ffd_kernel.LAUNCHES["ffd_scan"] == before["ffd_scan"]
        want = ffd_scan_reference(meta[None], compat[None], alloc, rank_g, N)
        _exact(got, want)
        counts = chain_branches(meta[None], compat[None], alloc, *want)
        for k in branches:
            branches[k] += counts[k]
    assert branches["uncapped"] > 0 and branches["capped"] > 0
    probs = [_inputs(100 + c, G=64, O=O) for c in range(3)]
    meta, compat, alloc, rank = (
        torch.from_numpy(np.stack([p[i] for p in probs])).to(cuda_device)
        for i in range(4))
    rank_g = torch.stack([torch.from_numpy(_group_rank(p[3], 64, c))
                          for c, p in enumerate(probs)]).to(cuda_device)
    _exact(ffd_scan_fleet(meta, compat, alloc, rank_g, N),
           ffd_scan_fleet_reference(meta, compat, alloc, rank_g, N))


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 2, 5, 7])
def test_ffd_kernel_group_rank_short_windows(cuda_device, G):
    """A rank row per group with G below the ring's lead (kAhead = 3) or
    not a whole number of its slots (kStages = 4): one problem and a
    fleet of three, against the plain version."""
    probs = [_inputs(70 + G + c, G=G, O=3072) for c in range(3)]
    meta, compat, alloc, rank = (
        torch.from_numpy(np.stack([p[i] for p in probs])).to(cuda_device)
        for i in range(4))
    rank_g = torch.stack([torch.from_numpy(_group_rank(p[3], G, c))
                          for c, p in enumerate(probs)]).to(cuda_device)
    _exact(ffd_scan(meta[:1], compat[:1], alloc[0], rank_g[0], 512),
           ffd_scan_reference(meta[:1], compat[:1], alloc[0], rank_g[0],
                              512))
    _exact(ffd_scan_fleet(meta, compat, alloc, rank_g, 512),
           ffd_scan_fleet_reference(meta, compat, alloc, rank_g, 512))


@pytest.mark.cuda
def test_ffd_kernel_group_rank_needs_whole_words(cuda_device):
    """The per-group form's rank row rides the ring as one TMA copy, so
    the wrapper refuses an O that is not a multiple of 4."""
    meta, compat, alloc, rank = (torch.from_numpy(x).to(cuda_device)
                                 for x in _inputs(3, G=8, O=129))
    rank_g = rank[None].expand(8, 129).contiguous()
    with pytest.raises(ValueError, match="O % 4"):
        ffd_scan(meta[None], compat[None], alloc, rank_g, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("G, N, O", [(512, 512, 3072), (64, 64, 129),
                                     (341, 384, 1), (0, 8, 16),
                                     (77, 200, 3071), (45, 1, 256)])
def test_presence_sum_kernel_matches_plain_version(cuda_device, G, N, O):
    """The ordered presence sums of the pref right-size, bit for bit
    against one ordered ``addcmul_`` per group; one launch counted."""
    from karpenter_tpu_torch.solver.presence_sum import (
        LAUNCHES, presence_sum, presence_sum_reference,
    )

    rng = np.random.RandomState(G + N + O)
    present = torch.from_numpy(
        (rng.rand(G, N) < 0.05).astype(np.float32)).to(cuda_device)
    miss = torch.from_numpy(rng.choice(
        np.float32([0, 1 / 3, 2 / 3, 0.1, 1]), size=(G, O))).to(cuda_device)
    before = LAUNCHES["presence_sum"]
    got = presence_sum(present, miss)
    assert LAUNCHES["presence_sum"] == before + 1
    want = presence_sum_reference(present, miss)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all closed", "full node", "most groups"])
def test_presence_sum_kernel_edges(cuda_device, case):
    """An all-closed node axis (every list empty: zeros), a node holding
    every group, and G at the kernel's maximum with a node holding all of
    them: bit for bit against the plain version, one launch each."""
    from karpenter_tpu_torch.solver import presence_sum as ps

    G, N, O = {"all closed": (512, 512, 3072), "full node": (341, 64, 3072),
               "most groups": (ps._bound()[1], 40, 132)}[case]
    rng = np.random.RandomState(G + N)
    present = (rng.rand(G, N) < 0.02).astype(np.float32)
    if case == "all closed":
        present[:] = 0
    else:
        present[:, N // 2] = 1
    miss = rng.choice(np.float32([0, 1 / 3, 2 / 3, 0.1, 1]), size=(G, O))
    present, miss = (torch.from_numpy(x).to(cuda_device)
                     for x in (present, miss))
    before = ps.LAUNCHES["presence_sum"]
    got = ps.presence_sum(present, miss)
    assert ps.LAUNCHES["presence_sum"] == before + 1
    want = ps.presence_sum_reference(present, miss)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "all closed":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [1, 5, 129, 3073])
def test_segment_sum_kernel_matches_plain_version(cuda_device, segments):
    """The order-fixed float32 segment sum, bit for bit against its plain
    version (index-order adds on the CPU), at totals past 2^24, with
    empty segments, and with ids outside [0, segments), which both
    drop."""
    from karpenter_tpu_torch.solver.segment_sum import (
        segment_sum, segment_sum_reference,
    )

    rng = np.random.RandomState(segments)
    I = 16384
    vals = (rng.randint(100, 32768, size=(I, 4))
            * rng.choice([1.0, 1.0001, 0.9999], size=(I, 4))
            ).astype(np.float32)
    seg = rng.randint(0, max(segments - 1, 1), size=I).astype(np.int32)
    stray = rng.rand(I)
    seg[stray < 0.01] = -1
    seg[stray > 0.99] = segments + 3
    v, s = (torch.from_numpy(x).to(cuda_device) for x in (vals, seg))
    got = segment_sum(v, s, segments)
    want = segment_sum_reference(v, s, segments)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _segment_ids(order: str, I: int, S: int, rng) -> np.ndarray:
    """Adversarial id orders for the segment-sum kernel."""
    if order == "one_segment":           # one I-long chain
        return np.full(I, S - 1, np.int64)
    if order == "sorted":
        return np.sort(rng.randint(0, S, size=I))
    if order == "reversed":
        return np.sort(rng.randint(0, S, size=I))[::-1].copy()
    if order == "random":
        return rng.randint(-1, S + 1, size=I)
    # the flat program's shape: sorted ids with the dropped sentinel S
    # interleaved (an item that is no longer active)
    seg = np.sort(rng.randint(0, S, size=I))
    seg[rng.rand(I) < 0.6] = S
    return seg


def _segment_check(dev, vals, seg, S):
    from karpenter_tpu_torch.solver import segment_sum as ss

    v = torch.from_numpy(vals).to(dev)
    s = torch.from_numpy(seg).to(dev)
    before = ss.LAUNCHES["segment_sum"]
    got = ss.segment_sum(v, s, S)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["segment_sum"] == before + 1
    want = ss.segment_sum_reference(v, s, S)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32)), \
        float((got - want).abs().max())


def _segment_vals(rng, I, cols=4):
    return (rng.randint(100, 32768, size=(I, cols))
            * rng.choice([1.0, 1.0001, 0.9999], size=(I, cols))
            ).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["one_segment", "sorted", "reversed",
                                   "random", "flat_shape"])
def test_segment_sum_kernel_id_orders(cuda_device, order):
    """The one-launch segment sum at I = 32768 on adversarial id orders,
    S in {1, 32, 33, 4097}, int32 and int64 ids, bit for bit against its
    plain version."""
    rng = np.random.RandomState(len(order))
    I = 32768
    vals = _segment_vals(rng, I)
    for S in (1, 32, 33, 4097):
        seg = _segment_ids(order, I, S, rng)
        for dtype in (np.int32, np.int64):
            _segment_check(cuda_device, vals, seg.astype(dtype), S)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [1, 4, 5, 8])
def test_segment_sum_kernel_item_buckets(cuda_device, cols):
    """Every I in the flat program's ITEM_BUCKETS (and ragged I), random
    ids over 3073 segments; past the largest bucket the wrapper raises."""
    from karpenter_tpu_torch.solver.flat import ITEM_BUCKETS
    from karpenter_tpu_torch.solver.segment_sum import segment_sum

    rng = np.random.RandomState(cols)
    for I in ITEM_BUCKETS + (1, 31, 1000):
        vals = _segment_vals(rng, I, cols)
        seg = rng.randint(-1, 3074, size=I).astype(np.int32)
        _segment_check(cuda_device, vals, seg, 3073)
    big = torch.zeros((ITEM_BUCKETS[-1] + 1, cols), device=cuda_device)
    with pytest.raises(ValueError, match="items"):
        segment_sum(big, torch.zeros(big.shape[0], dtype=torch.int32,
                                     device=cuda_device), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flat", "affinity", "stochastic", "pref"])
def test_route_on_card_matches_cpu(cuda_device, route):
    from karpenter_tpu_torch.apis.nodeclaim import NodePool
    from karpenter_tpu_torch.solver.types import SolverOptions

    opts, pool = SolverOptions(), None
    if route == "flat":
        pods, catalog = workload.build_hetero_workload(
            1500, 60, seed=11, constrained_frac=0.3, pref_frac=0.15)
        opts = SolverOptions(flat_solver="on")
    elif route == "affinity":
        catalog = workload.build_catalog(60)
        pods = workload.affinity_bench_pods(
            "ap0", 300, np.random.RandomState(190), services=4,
            spread_sets=2)
    elif route == "stochastic":
        catalog = workload.build_catalog(60)
        pods = workload.stochastic_pods(300, seed=3)
        pool = NodePool(name="default", overcommit=0.05)
    else:
        pods, catalog = workload.build_workload(600, 60, seed=5)
        pods = workload.with_preferences(pods)
    request = SolveRequest(pods, catalog, pool)
    card = TorchSolver(opts, device=cuda_device)
    plan = card.solve(request)
    assert card.last_stats["path"] == f"{route}-cuda"
    cpu_plan = TorchSolver(opts, device="cpu").solve(request)
    assert [(n.offering_index, n.pod_names) for n in plan.nodes] == \
        [(n.offering_index, n.pod_names) for n in cpu_plan.nodes]
    assert plan.unplaced_pods == cpu_plan.unplaced_pods
    assert validate_plan(plan, pods, catalog, pool) == []


@pytest.mark.cuda
def test_serving_staging_pinned_rotation(cuda_device):
    """Pinned staging pairs in rotation: every upload lands on the card
    intact, a reused slot waits for its last copy, and refilling the
    host pair afterwards leaves the device pair as it was."""
    from karpenter_tpu_torch.serving.ring import Staging

    staging = Staging(2, device=cuda_device)
    kept = []
    for k in range(5):
        n = 64 if k < 3 else 128
        rng = np.random.RandomState(k)
        didx = rng.randint(0, 1000, n).astype(np.int32)
        dval = rng.randint(-9, 9, n).astype(np.int32)
        kept.append((didx, dval, staging.upload(didx, dval)))
        didx[:] = -1
    torch.cuda.synchronize()
    for k, (didx, dval, (d_idx, d_val)) in enumerate(kept):
        rng = np.random.RandomState(k)
        n = 64 if k < 3 else 128
        assert d_idx.device.type == "cuda"
        np.testing.assert_array_equal(d_idx.cpu().numpy(),
                                      rng.randint(0, 1000, n))
        np.testing.assert_array_equal(d_val.cpu().numpy(), dval)
    assert staging.uploads == 5


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 64])
def test_cost_sum_kernel_matches_plain_version(cuda_device, C):
    """The order-fixed cost sum of masked price rows (the cost word with
    node n open on offering n) bit for bit against its plain version at
    every N in NODE_BUCKETS, ragged lengths and rows near 2^24 totals;
    one LAUNCHES["cost_sum"] per call."""
    from karpenter_tpu_torch.solver import cost_sum as cs
    from karpenter_tpu_torch.solver.types import NODE_BUCKETS

    rng = np.random.RandomState(C)
    for N in NODE_BUCKETS + (0, 1, 33, 1000):
        for scale in (4.0, 2.0 ** 25 / max(N, 1)):
            prices = (rng.rand(C, N) * scale).astype(np.float32)
            prices[rng.rand(C, N) < rng.uniform(0.3, 0.7, (C, 1))] = 0
            x = torch.from_numpy(prices).to(cuda_device)
            node = torch.arange(N, dtype=torch.int32, device=cuda_device)
            before = cs.LAUNCHES["cost_sum"]
            got = cs.cost_word(node.expand(C, N).contiguous(),
                               torch.nn.functional.pad(x, (0, 1)))
            torch.cuda.synchronize()
            assert cs.LAUNCHES["cost_sum"] == before + 1
            want = cs.cost_sum_reference(x.cpu())
            assert torch.equal(got.cpu().view(torch.int32),
                               want.view(torch.int32)), (N, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 8, 64])
def test_cost_word_kernel_matches_plain_version(cuda_device, C):
    """The fused cost word (gather, mask and windowed sum in one launch)
    bit for bit against its plain version at every N in NODE_BUCKETS,
    with one price row for every problem (stride 0) and a row each; one
    LAUNCHES["cost_sum"] per call."""
    from karpenter_tpu_torch.solver import cost_sum as cs
    from karpenter_tpu_torch.solver.types import NODE_BUCKETS

    rng = np.random.RandomState(100 + C)
    O = 3072
    for N in NODE_BUCKETS + (1, 33, 1000):
        node = rng.randint(0, O, size=(C, N)).astype(np.int32)
        node[rng.rand(C, N) < rng.uniform(0.3, 0.7, (C, 1))] = -1
        prices = (rng.rand(C, O) * 2.0 ** 27 / N).astype(np.float32)
        no = torch.from_numpy(node).to(cuda_device)
        for price in (torch.from_numpy(prices[0]).to(cuda_device),
                      torch.from_numpy(prices).to(cuda_device)):
            for rows in ((no, price),) if price.dim() == 2 else \
                    ((no, price), (no[0], price)):
                before = cs.LAUNCHES["cost_sum"]
                got = cs.cost_word(*rows)
                torch.cuda.synchronize()
                assert cs.LAUNCHES["cost_sum"] == before + 1
                want = cs.cost_word_reference(*(t.cpu() for t in rows))
                assert torch.equal(got.cpu().view(torch.int32),
                                   want.view(torch.int32)), (N, price.dim())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8])
def test_cost_word_kernel_short_and_lane_rows(cuda_device, C):
    """The cost word at every N from 1 to 64 (rows of 30-32 take the
    8-lane order) and 929-1024 (30-32 window sums at the last level),
    bit for bit against its plain version; prices spread over six
    decades so every order of the adds gives another word."""
    from karpenter_tpu_torch.solver import cost_sum as cs

    rng = np.random.RandomState(200 + C)
    O = 512
    prices = (rng.rand(O) * 10.0 ** rng.uniform(-3, 3, O)).astype(
        np.float32)
    price = torch.from_numpy(prices).to(cuda_device)
    for N in list(range(1, 65)) + list(range(929, 1025)):
        node = rng.randint(-1, O, size=(C, N)).astype(np.int32)
        no = torch.from_numpy(node).to(cuda_device)
        got = cs.cost_word(no, price)
        want = cs.cost_word_reference(torch.from_numpy(node),
                                      torch.from_numpy(prices))
        assert torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)), N


@pytest.mark.cuda
def test_whatif_on_card_matches_cpu(cuda_device):
    """The stacked what-if plan on the card: one fleet-kernel launch and
    one cost-sum launch, the CPU plan's words, the validator clean."""
    from karpenter_tpu_torch.solver import cost_sum as cs
    from karpenter_tpu_torch.whatif import (
        Scenario, WhatIfPlanner, build_baseline, validate_whatif,
    )
    from karpenter_tpu_torch.whatif import scenario as sc

    pods, catalog = workload.build_workload(1500, 40, seed=4)
    base = build_baseline(pods, catalog)
    menu = [Scenario("baseline"),
            Scenario("wave", (sc.ArrivalWave(((0, 9), (1, 5))),)),
            Scenario("storm", (sc.spot_storm_mask(catalog),)),
            Scenario("quota", (sc.quota_clamp(base, 3),))]
    on_card = WhatIfPlanner(device="cuda")
    before = (ffd_kernel.LAUNCHES["ffd_scan_fleet"],
              cs.LAUNCHES["cost_sum"])
    plan = on_card.plan(base, menu)
    assert (ffd_kernel.LAUNCHES["ffd_scan_fleet"] - before[0],
            cs.LAUNCHES["cost_sum"] - before[1]) == (1, 1)
    ref = WhatIfPlanner(device="cpu").plan(base, menu)
    np.testing.assert_array_equal(plan.raw, ref.raw)
    assert validate_whatif(plan) == []


@pytest.mark.cuda
def test_gang_and_preempt_grids_on_card_match_numpy(cuda_device):
    """The torch grids of the gang and preemption planners on the card
    give the numpy grids' plans."""
    from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests
    from karpenter_tpu_torch.apis.podgroup import PodGroup
    from karpenter_tpu_torch.core.cluster import ClusterState
    from karpenter_tpu_torch.gang import GangOptions, GangPlanner, encode_gangs
    from karpenter_tpu_torch.preempt import (
        PlannerOptions, PreemptionPlanner, encode_victims,
    )

    gcat = workload.build_catalog(60, workload.ACCEL_FAMILIES)
    rng = np.random.RandomState(17)
    pods = []
    for g in range(16):
        shape = ["4x4", "2x2x2", "2x2", ""][rng.randint(4)]
        gang = PodGroup(name=f"job-{g}", min_member=4,
                        slice_shape=shape or None)
        pods += [PodSpec(f"job-{g}-{m}", requests=ResourceRequests(
            int(rng.randint(100, 500)), 512, 0, 1), gang=gang)
            for m in range(4)]
    problem = encode_gangs(pods, gcat)
    plans = [GangPlanner(GangOptions(use_device=u), device=d).plan(problem)
             for u, d in (("on", "cuda"), ("off", "cpu"))]
    assert plans[0].placements == plans[1].placements
    assert [(n.offering_index, [(a.gang, a.placement_mask)
                                for a in n.assignments])
            for n in plans[0].nodes] == \
        [(n.offering_index, [(a.gang, a.placement_mask)
                             for a in n.assignments]) for n in plans[1].nodes]

    catalog = workload.build_catalog(40)
    cluster = ClusterState()
    for i in range(50):
        cluster.add_nodeclaim(NodeClaim(
            name=f"c{i}", instance_type=catalog.type_names[10 + i % 5],
            zone=catalog.zones[i % 3], node_name=f"n{i}", launched=True))
        for j in range(3):
            cluster.add_pod(PodSpec(f"v{i}-{j}", requests=ResourceRequests(
                600, 1024, 0, 1), priority=int(rng.choice([0, 100]))))
            cluster.bind_pod(f"default/v{i}-{j}", f"n{i}")
    pending = [PodSpec(f"p{k}", requests=ResourceRequests(
        1000, 2048, 0, 1), priority=1000) for k in range(80)]
    prob = encode(pending, catalog)
    victims = encode_victims(cluster, catalog)
    out = [PreemptionPlanner(PlannerOptions(use_device=u),
                             device=d).plan(prob, victims)
           for u, d in (("on", "cuda"), ("off", "cpu"))]
    assert out[0].placements == out[1].placements
    assert [(e.claim_name, e.pod_key) for e in out[0].evictions] == \
        [(e.claim_name, e.pod_key) for e in out[1].evictions]


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4, 8])
def test_solve_shards_on_card_matches_plain_and_single(cuda_device, S):
    """The stacked sharded solve on the card: one fleet-kernel launch and
    one cost-sum launch, its rows equal to the plain version on the CPU
    and to S single-window launches on the card, word for word."""
    from karpenter_tpu_torch.sharded.encode import encode_shards
    from karpenter_tpu_torch.resident.kernels import new_state
    from karpenter_tpu_torch.sharded.kernels import solve_shards
    from karpenter_tpu_torch.sharded.router import ShardRouter
    from karpenter_tpu_torch.sharded.service import ShardedSolveService
    from karpenter_tpu_torch.solver import cost_sum as cs
    from karpenter_tpu_torch.solver.packed import solve_packed_torch

    pods, catalog = workload.build_workload(1200, 40, seed=S)
    window = encode_shards(ShardRouter(S).partition(pods), catalog)
    L = window.stacked.shape[1]
    didx = np.full((S, 64), L, np.int32)
    dval = np.zeros((S, 64), np.int32)
    kw = dict(G=window.G_pad, O=window.O_pad, U=window.U_pad, N=window.N)
    outs = {}
    for dev in ("cpu", "cuda"):
        ct = ShardedSolveService(S, device=dev)._catalog_tensors(
            catalog, window.O_pad)
        before = (ffd_kernel.LAUNCHES["ffd_scan_fleet"],
                  cs.LAUNCHES["cost_sum"])
        state, out = solve_shards(
            new_state(window.stacked, dev),
            torch.from_numpy(didx).to(dev), torch.from_numpy(dval).to(dev),
            *ct, **kw)
        outs[dev] = out.cpu().numpy()
        np.testing.assert_array_equal(state[:, :L].cpu().numpy(),
                                      window.stacked)
        if dev == "cuda":
            assert (ffd_kernel.LAUNCHES["ffd_scan_fleet"] - before[0],
                    cs.LAUNCHES["cost_sum"] - before[1]) == (1, 1)
            for s in range(S):
                single = solve_packed_torch(
                    torch.from_numpy(window.stacked[s]).to(dev), *ct, **kw)
                np.testing.assert_array_equal(outs[dev][s],
                                              single.cpu().numpy())
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])


@pytest.mark.cuda
def test_repack_grid_on_card_matches_numpy(cuda_device):
    """The repack planner's torch grid on the card gives the numpy grid's
    kinds, scores and reopened counts, and the same plan, with chip
    masks whose words have bit 31 set."""
    from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
    from karpenter_tpu_torch.apis.pod import PodSpec, ResourceRequests
    from karpenter_tpu_torch.apis.podgroup import PodGroup
    from karpenter_tpu_torch.core.cluster import ClusterState
    from karpenter_tpu_torch.repack import (
        RepackOptions, RepackPlanner, encode_repack,
    )

    catalog = workload.build_catalog(24, ("gx3", "bx2", "cx2"))
    rng = np.random.RandomState(13)
    cluster = ClusterState()
    types = ["bx2-4x16", "bx2-16x64", "gx3-64x512"]
    for i in range(120):
        t = types[rng.randint(3)]
        cluster.add_nodeclaim(NodeClaim(
            name=f"c{i}", instance_type=t, zone="us-south-1",
            node_name=f"node-c{i}", hourly_price=[0.2, 0.8, 3.0][
                types.index(t)], launched=True, initialized=True))
        for j in range(rng.randint(0, 4)):
            gpu = int(rng.randint(0, 3)) if t.startswith("gx3") else 0
            cluster.add_pod(PodSpec(f"p{i}-{j}", requests=ResourceRequests(
                int(rng.randint(100, 1500)), int(rng.randint(256, 3000)),
                gpu, 1)))
            cluster.bind_pod(f"default/p{i}-{j}", f"node-c{i}")
    gang = PodGroup(name="parked", min_member=4, slice_shape="2x2x2")
    for j in range(4):
        cluster.add_pod(PodSpec(f"g{j}", gang=gang))
    prob = encode_repack(cluster, catalog)
    card = RepackPlanner(RepackOptions(use_device="on"), device="cuda")
    plain = RepackPlanner(RepackOptions(use_device="off"), device="cpu")
    got = card._grid_device(prob, prob.tables)
    want = plain._grid_numpy(prob, prob.tables)
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)
    on, off = card.plan(prob), plain.plan(prob)
    assert on.backend == "device" and off.backend == "vector"
    assert [(m.pod_key, m.dst_claim) for m in on.migrations] == \
        [(m.pod_key, m.dst_claim) for m in off.migrations]
    assert on.drained == off.drained
    high = np.uint64(1 << 31) | np.uint64(1 << 63)
    prob.occ_mask = prob.occ_mask | high
    got = card._grid_device(prob, prob.tables)
    want = plain._grid_numpy(prob, prob.tables)
    for a, b in zip(got[:3], want):
        np.testing.assert_array_equal(a, b)


def _intake_change(kind: str, catalog, base):
    """Apply the catalog intake's change of ``kind`` to ``catalog``: the
    blackout of the offerings ``base`` opened in us-south-1, or an
    interruption rate of 3/4 on its spot pairs.  Returns the offering
    indexes the change darkened (none for the risk)."""
    from karpenter_tpu_torch.catalog import UnavailableOfferings
    from karpenter_tpu_torch.stochastic.risk import SpotRiskModel

    if kind == "blackout":
        used = sorted({(n.instance_type, n.zone, n.capacity_type)
                       for n in base.nodes if n.zone == "us-south-1"})
        assert used
        unavailable = UnavailableOfferings(clock=lambda: 0.0)
        for key in used:
            unavailable.mark_unavailable(*key)
        assert catalog.refresh_availability(unavailable)
        return {catalog.find_offering(*key) for key in used}
    model = SpotRiskModel()
    for itype, zone in {(n.instance_type, n.zone) for n in base.nodes
                        if n.capacity_type == "spot"}:
        model.observe(itype, zone, interrupted=3, exposure=4)
    generation = catalog.risk_generation
    model.price_catalog(catalog)
    assert catalog.risk_generation == generation + 1
    return set()


def _intake_window(cuda_device, kind):
    """(solver, request, base plan, darkened offerings) of a 2000-pod x
    60-type window solved once on the card before the change."""
    pods, catalog = workload.build_workload(2000, 60, seed=21)
    solver = TorchSolver(device=cuda_device)
    request = SolveRequest(pods, catalog)
    base = solver.solve(request)
    dark = _intake_change(kind, catalog, base)
    return solver, request, base, dark


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["blackout", "risk"])
def test_intake_change_uploads_the_catalog_once(cuda_device, kind):
    from karpenter_tpu_torch.obs.devtel import get_devtel

    solver, request, _, _ = _intake_window(cuda_device, kind)
    before = get_devtel().catalog_uploads
    solver.solve(request)
    assert get_devtel().catalog_uploads == before + 1
    solver.solve(request)
    assert get_devtel().catalog_uploads == before + 1


@pytest.mark.cuda
def test_intake_blackout_plan_avoids_the_dark_offerings(cuda_device):
    solver, request, base, dark = _intake_window(cuda_device, "blackout")
    plan = solver.solve(request)
    assert dark and not {n.offering_index for n in plan.nodes} & dark
    assert validate_plan(plan, request.pods, request.catalog) == []
    assert plan.placed_count == len(request.pods)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["blackout", "risk"])
def test_intake_change_words_equal_the_cpu_program(cuda_device, kind):
    solver, request, _, _ = _intake_window(cuda_device, kind)
    problem = encode(request.pods, request.catalog)
    card = solver.dispatch_packed(solver._prepare(problem)).cpu().numpy()
    cpu = TorchSolver(device="cpu")
    plain = cpu.dispatch_packed(cpu._prepare(problem)).numpy()
    np.testing.assert_array_equal(card, plain)
    assert [(n.offering_index, n.pod_names)
            for n in solver.solve(request).nodes] == \
        [(n.offering_index, n.pod_names) for n in cpu.solve(request).nodes]


def _provision_rig(device):
    """The provisioning loop on the fake cloud with 60 profiles: a ready
    NodeClass, the default NodePool, an actuator whose breaker admits a
    whole plan, and a ``Provisioner`` on ``device``."""
    from karpenter_tpu_torch.apis.nodeclaim import NodePool
    from karpenter_tpu_torch.apis.nodeclass import NodeClass, NodeClassSpec
    from karpenter_tpu_torch.catalog import (
        InstanceTypeProvider, PricingProvider, UnavailableOfferings,
    )
    from karpenter_tpu_torch.cloud.fake import FakeCloud, generate_profiles
    from karpenter_tpu_torch.core import (
        Actuator, CircuitBreakerConfig, CircuitBreakerManager, ClusterState,
        Provisioner,
    )

    cloud = FakeCloud(profiles=generate_profiles(60))
    pricing = PricingProvider(cloud)
    unavail = UnavailableOfferings()
    itp = InstanceTypeProvider(cloud, pricing, unavail)
    cluster = ClusterState()
    nc = NodeClass(name="default", spec=NodeClassSpec(
        region="us-south", instance_profile="bx2-4x16", image="img-1"))
    nc.status.resolved_image_id = "img-1"
    nc.status.set_condition("Ready", "True", "Validated")
    cluster.add_nodeclass(nc)
    cluster.add_nodepool(NodePool(name="default", nodeclass_name="default"))
    actuator = Actuator(cloud, cluster, unavailable=unavail,
                        breaker=CircuitBreakerManager(CircuitBreakerConfig(
                            failure_threshold=100_000,
                            rate_limit_per_minute=100_000,
                            max_concurrent_instances=100_000)))
    prov = Provisioner(cluster, itp, actuator, device=device)
    return prov, pricing, unavail


def _claims_by_pods(cluster):
    pods = {}
    for p in cluster.list("pods"):
        if p.nominated_node:
            pods.setdefault(p.nominated_node, []).append(p.spec.name)
    return {frozenset(pods.get(c.name, ())): (
        c.instance_type, c.zone, c.capacity_type)
        for c in cluster.nodeclaims()}


@pytest.mark.cuda
def test_provision_once_on_card_matches_cpu(cuda_device):
    """A 2,000-pod ``provision_once`` on the card makes the CPU port's
    claims (by pod set); a blackout of an offering it used re-keys the
    card's catalog with one upload and the next window avoids it."""
    from karpenter_tpu_torch.obs.devtel import get_devtel

    pods, _ = workload.build_workload(2000, 60, seed=21)
    rigs = [_provision_rig(d) for d in (cuda_device, "cpu")]
    try:
        out = []
        for prov, _, unavail in rigs:
            for p in pods:
                prov.cluster.add_pod(p)
            plans = prov.provision_once()
            assert len(plans) == 1
            assert all(p.nominated_node for p in prov.cluster.pending_pods())
            out.append((_claims_by_pods(prov.cluster),
                        [(n.offering_index, n.pod_names)
                         for n in plans[0].nodes]))
        assert out[0] == out[1]
        prov, _, unavail = rigs[0]
        node = plans[0].nodes[0]
        dark = (node.instance_type, node.zone, node.capacity_type)
        nodeclass = prov.cluster.get_nodeclass("default")
        catalog = prov._catalog_for(nodeclass)
        unavail.mark_unavailable(*dark)
        for i in range(40):
            prov.cluster.add_pod(pod_spec_like(pods[i], f"x{i}"))
        before = get_devtel().catalog_uploads
        again = prov.provision_once()
        assert get_devtel().catalog_uploads == before + 1
        assert prov._catalog_for(nodeclass) is catalog
        assert again and dark not in {(n.instance_type, n.zone,
                                       n.capacity_type)
                                      for n in again[0].nodes}
        assert all(p.nominated_node for p in prov.cluster.pending_pods())
    finally:
        for prov, pricing, _ in rigs:
            prov.stop()
            pricing.close()


def pod_spec_like(pod, name):
    """``pod`` under another name (its constraints and requests kept)."""
    import dataclasses

    return dataclasses.replace(pod, name=name)


@pytest.mark.cuda
def test_consolidation_and_repack_on_card_match_cpu(cuda_device, monkeypatch):
    """(x2) at a small size: 1,000 pods provisioned, joined and
    registered; half deleted; three disruption ticks 31 s apart with the
    repack's grid forced onto the device, with the resident occupancy
    view off and on: the claims, bindings, deletions and events of the
    card's runs equal the CPU port's, and the card's runs took the grid
    on the card."""
    import secrets
    import uuid

    from karpenter_tpu_torch.controllers import ControllerManager
    from karpenter_tpu_torch.controllers.disruption import (
        DisruptionController,
    )
    from karpenter_tpu_torch.controllers.nodeclaim import (
        NodeClaimTerminationController, RegistrationController,
    )
    from karpenter_tpu_torch.core.cloudprovider import CloudProvider
    from karpenter_tpu_torch.core.kubelet import FakeKubelet
    from karpenter_tpu_torch.repack import RepackOptions

    pods, _ = workload.build_workload(1000, 60, seed=23)

    def run(device, resident):
        n = iter(range(1, 1 << 30))
        monkeypatch.setattr(uuid, "uuid4",
                            lambda: uuid.UUID(int=next(n) << 96))
        monkeypatch.setattr(secrets, "token_hex",
                            lambda nbytes=None: f"{next(n):064x}")
        prov, pricing, _ = _provision_rig(device)
        try:
            cluster = prov.cluster
            t = [1000.0]
            ctrl = DisruptionController(
                cluster, CloudProvider(cluster, prov.actuator,
                                       prov.catalog_provider),
                provisioner=prov, clock=lambda: t[0], repack_enabled=True,
                repack_cooldown=0.0, resident_occupancy=resident,
                repack_options=RepackOptions(use_device="on"),
                device=device)
            mgr = ControllerManager(cluster)
            for c in (RegistrationController(cluster),
                      NodeClaimTerminationController(cluster,
                                                     prov.actuator), ctrl):
                mgr.register(c)
            for p in pods:
                cluster.add_pod(p)
            prov.provision_once()
            FakeKubelet(cluster, prov.actuator.cloud).join_pending(ready=True)
            mgr.sync(rounds=1)
            for p in pods[::2]:
                cluster.delete("pods", f"{p.namespace}/{p.name}")
            for _ in range(3):
                mgr.sync(rounds=1)
                t[0] += 31.0
            return ({c.name: (c.instance_type, c.zone, c.capacity_type,
                              c.deleted) for c in cluster.nodeclaims()},
                    {k: (p.bound_node, p.nominated_node)
                     for k, p in sorted(cluster._collections["pods"]
                                        .items())},
                    [(e.kind, e.name, e.reason) for e in cluster.events],
                    ctrl._repacker.primary.device_steps)
        finally:
            prov.stop()
            pricing.close()

    cpu = run("cpu", False)
    for resident in (False, True):
        card = run(cuda_device, resident)
        assert card[:3] == cpu[:3]
        assert card[3] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["headline", "pref", "flat"])
def test_sidecar_handlers_on_card_reply_the_cpu_words(cuda_device, kind):
    """The sidecar's byte handlers on the card, behind its gRPC server on
    127.0.0.1: each reply's arrays equal the CPU handlers' on the same
    request bytes, and the plan equals ``TorchSolver``'s on the card."""
    from karpenter_tpu_torch.service import (
        RemoteSolver, SolverHandlers, SolverServer, _unpack,
    )
    from karpenter_tpu_torch.solver.types import SolverOptions

    if kind == "flat":
        pods, catalog = workload.build_hetero_workload(600, 30, seed=7)
        opts = SolverOptions(flat_min_groups=64)
    else:
        pods, catalog = workload.build_workload(1500, 60, seed=42)
        opts = SolverOptions()
        if kind == "pref":
            pods = workload.with_preferences(pods)
    card = SolverServer(options=opts, device=cuda_device).start()
    cpu = SolverHandlers(opts, device="cpu")
    calls = []

    def logged(name, fn):
        def call(request):
            reply = fn(request)
            calls.append((name, request, reply))
            return reply
        return call

    client = RemoteSolver(f"127.0.0.1:{card.port}")
    for name in ("_upload", "_solve"):
        setattr(client, name, logged(name, getattr(client, name)))
    try:
        plan = client.solve(SolveRequest(pods, catalog))
    finally:
        client.close()
        card.stop()
    assert client.device == card.device
    local = TorchSolver(opts, device=cuda_device).solve(
        SolveRequest(pods, catalog))
    assert [(n.offering_index, n.pod_names) for n in plan.nodes] == \
        [(n.offering_index, n.pod_names) for n in local.nodes]
    for name, request, reply in calls:
        want = getattr(cpu, name)(request)
        if name == "_solve":
            got, ref = _unpack(reply), _unpack(want)
            assert sorted(got) == sorted(ref)
            for k in ref:
                assert np.array_equal(got[k], ref[k]), k


@pytest.mark.cuda
def test_calm_chaos_scenario_on_card_matches_cpu(cuda_device):
    from karpenter_tpu_torch.chaos.runner import run_scenario

    card = run_scenario("calm", 1, rounds=6, device=cuda_device)
    cpu = run_scenario("calm", 1, rounds=6, device="cpu")
    assert card.ok, card.render_failure()
    assert card.digest == cpu.digest
    assert card.harness.resident.device.type == cuda_device.type


def _whatif_run(device, pods, catalog):
    """One ``PlanningService`` evaluation over ``pods`` with a ledger
    seeded with 0-2 arrivals of each signature in each of 24 hours:
    (payload, digest, launches of the evaluation)."""
    import random
    from types import SimpleNamespace

    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.obs.ledger import PlacementLedger
    from karpenter_tpu_torch.solver import cost_sum
    from karpenter_tpu_torch.whatif import PlanningService

    class Pending:
        def pending_pods(self):
            return [SimpleNamespace(spec=p) for p in pods]

        def list(self, kind, predicate=None):
            return []

    ledger = PlacementLedger()
    rng = random.Random(17)
    for hour in range(24):
        for sig in sorted({p.signature_key() for p in pods}):
            for _ in range(rng.randint(0, 2)):
                ledger.arrival(sig, t=hour * 3600.0)
    counters = (ffd_kernel.LAUNCHES, cost_sum.LAUNCHES)
    before = {k: v for c in counters for k, v in c.items()}
    with obs.use_ledger(ledger):
        svc = PlanningService(Pending(), catalog_fn=lambda: catalog, seed=17,
                              device=device)
        payload = svc.evaluate(record=True, hour=9)
    launches = {k: v - before[k] for c in counters for k, v in c.items()
                if v != before[k]}
    return payload, svc.digest(), launches


@pytest.mark.cuda
def test_whatif_service_on_card_matches_cpu(cuda_device):
    """The standing menu over 2,000 pending pods runs in one stacked plan
    on the card (one ``ffd_scan_fleet``, one ``cost_sum``); the payload
    (clock fields aside) and the digest are the CPU port's."""
    def walls(obj):
        if isinstance(obj, dict):
            return {k: walls(v) for k, v in obj.items() if k not in (
                "plan_seconds", "wall_seconds", "built_at", "created_at")}
        if isinstance(obj, list):
            return [walls(v) for v in obj]
        return obj

    pods, catalog = workload.build_workload(2000, 60, seed=21)
    card, card_digest, launches = _whatif_run(cuda_device, pods, catalog)
    cpu, cpu_digest, _ = _whatif_run("cpu", pods, catalog)
    assert launches == {"ffd_scan_fleet": 1, "cost_sum": 1}
    assert card["dispatches"] == 1 and card["backend"] == "device"
    assert card["recommendations"]
    assert walls(card) == walls(cpu)
    assert card_digest == cpu_digest


def _iks_world(device, pods):
    """``pods`` provisioned through ``ProviderFactory`` (``IKS_CLUSTER_ID``
    in its env) as ``FakeIKS`` pool workers by a ``Provisioner`` on
    ``device``; then the claims of the smallest pools, half of all,
    terminated through the factory and one pool cleanup tick."""
    import collections

    from karpenter_tpu_torch.apis.nodeclass import DynamicPoolConfig
    from karpenter_tpu_torch.cloud.fake_iks import FakeIKS
    from karpenter_tpu_torch.controllers.iks import PoolCleanupController
    from karpenter_tpu_torch.controllers.nodeclaim import (
        NodeClaimTerminationController,
    )
    from karpenter_tpu_torch.core.factory import ProviderFactory
    from karpenter_tpu_torch.core.workerpool import (
        ANNOTATION_POOL_ID, WorkerPoolActuator,
    )

    prov, pricing, unavail = _provision_rig(device)
    try:
        nc = prov.cluster.get_nodeclass("default")
        nc.spec.iks_dynamic_pools = DynamicPoolConfig(
            enabled=True, pool_name_prefix="kp", empty_pool_ttl_seconds=0)
        iks = FakeIKS("cls-1", prov.actuator.cloud)
        pools = WorkerPoolActuator(iks, prov.cluster,
                                   breaker=prov.actuator.breaker,
                                   unavailable=unavail)
        prov.factory = ProviderFactory(prov.actuator, pools,
                                       env={"IKS_CLUSTER_ID": "cls-1"})
        for p in pods:
            prov.cluster.add_pod(p)
        plans = prov.provision_once()

        def state():
            return (sorted((p.id, p.name, p.flavor, tuple(sorted(p.zones)),
                            p.size_per_zone) for p in iks.list_pools()),
                    sorted((w.id, w.pool_id, w.zone, w.instance_id)
                           for w in iks.list_workers()),
                    _claims_by_pods(prov.cluster))

        made = state()
        size = collections.Counter(c.annotations[ANNOTATION_POOL_ID]
                                   for c in prov.cluster.nodeclaims())
        claims = sorted(prov.cluster.nodeclaims(), key=lambda c: (
            size[c.annotations[ANNOTATION_POOL_ID]],
            c.annotations[ANNOTATION_POOL_ID], c.name))
        term = NodeClaimTerminationController(prov.cluster, prov.actuator,
                                              factory=prov.factory)
        for c in claims[:len(claims) // 2]:
            c.deleted = True
            term.reconcile(c.name)
        PoolCleanupController(prov.cluster, iks).reconcile()
        return [(n.offering_index, n.pod_names) for n in plans[0].nodes], \
            made, state()
    finally:
        prov.stop()
        pricing.close()


@pytest.mark.cuda
def test_iks_factory_provisioning_on_card_matches_cpu(cuda_device):
    """2,000 pods planned on the card and actuated as IKS pool workers:
    the plan, the pools, the workers and the claims are the CPU port's,
    before and after half the claims are terminated and the emptied
    pools reaped."""
    from karpenter_tpu_torch.solver import cost_sum

    pods, _ = workload.build_workload(2000, 60, seed=21)
    before = (ffd_kernel.LAUNCHES["ffd_scan"], cost_sum.LAUNCHES["cost_sum"])
    card = _iks_world(cuda_device, pods)
    assert ffd_kernel.LAUNCHES["ffd_scan"] > before[0]
    assert cost_sum.LAUNCHES["cost_sum"] > before[1]
    cpu = _iks_world("cpu", pods)
    assert card == cpu
    plan, made, after = card
    assert len(made[1]) == len(plan) and len(after[0]) < len(made[0])
