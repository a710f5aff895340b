"""``solve_packed_torch`` against the reference's ``solve_packed``.

Both sides take the same packed problem buffer, built by the reference
``pack_input`` from an encoded seeded window, and the same padded
catalog tensors.  Every word of the result must be equal — node_off,
unplaced, the float cost word (summed in the reference's order by
``solver/cost_sum.py``), the assign tail, the explain words and the
telemetry block.  All four output modes of
``clamp_output_opts`` are covered (dense, dense16, COO, coo16), over the
shapes tests/test_packed_io.py (200 pods, N=256) and
tests/test_telemetry.py (100+ pods with an unplaceable one, N=64) sweep.
"""

import numpy as np
import pytest
import torch

from karpenter_tpu.apis.pod import PodSpec, ResourceRequests
from karpenter_tpu.apis.requirements import LABEL_ZONE
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud
from karpenter_tpu.solver import encode
from karpenter_tpu.solver.jax_backend import (
    _pad1, _pad2, clamp_output_opts, pack_input, solve_packed,
)
from karpenter_tpu.solver.types import (
    GROUP_BUCKETS, LABELROW_BUCKETS, OFFERING_BUCKETS, bucket,
)
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.solver.result_layout import result_len

# (K0, dense16_ok) -> the four wire modes clamp_output_opts can pick
MODES = {"dense": (0, False), "dense16": (0, True), "coo": (512, False),
         "coo16": (512, True)}
SHAPES = {"packed_io": (200, 256), "telemetry": (100, 64)}


@pytest.fixture(scope="module")
def catalog():
    cloud = FakeCloud()
    pricing = PricingProvider(cloud)
    arrays = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return arrays


def _pods(n, seed, shape):
    rng = np.random.RandomState(seed)
    sizes = ((250, 512), (500, 1024), (1000, 2048), (2000, 8192),
             (4000, 16384))
    pods = []
    for i in range(n + seed * 7):
        cpu, mem = sizes[rng.randint(len(sizes))]
        kw = {"priority": int(rng.choice([0, 0, 100]))}
        if rng.rand() < 0.2:
            kw["node_selector"] = ((LABEL_ZONE,
                                    f"us-south-{rng.randint(3) + 1}"),)
        pods.append(PodSpec(f"{shape}{seed}-{i}",
                            requests=ResourceRequests(cpu, mem, 0, 1), **kw))
    if shape == "telemetry":
        pods.append(PodSpec(f"huge{seed}", requests=ResourceRequests(
            40_000_000, 800_000_000, 0, 1)))
    return pods


def _window(catalog, seed, shape):
    n, N = SHAPES[shape]
    problem = encode(_pods(n, seed, shape), catalog)
    G = bucket(problem.num_groups, GROUP_BUCKETS)
    O = bucket(catalog.num_offerings, OFFERING_BUCKETS)
    rows, label_idx = problem.label_rows, problem.label_idx
    U = bucket(max(rows.shape[0], 1), LABELROW_BUCKETS)
    packed = pack_input(_pad2(problem.group_req, G),
                        _pad1(problem.group_count, G),
                        _pad1(problem.group_cap, G),
                        _pad1(label_idx, G), _pad2(rows, U, O),
                        group_prio=_pad1(problem.group_prio, G))
    cat = (_pad2(catalog.offering_alloc().astype(np.int32), O),
           _pad1(catalog.off_price.astype(np.float32), O),
           _pad1(catalog.offering_rank_price(), O))
    return packed, cat, G, O, U, N


def assert_words_equal(ref, got, G, N):
    """Every word equal, the cost word (at N + G) included."""
    assert ref.shape == got.shape, (ref.shape, got.shape)
    bad = np.nonzero(ref != got)[0]
    assert bad.size == 0, (f"{bad.size} words differ, first at {bad[0]} "
                           f"(cost word at {N + G}): {ref[bad[0]]} vs "
                           f"{got[bad[0]]}")


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", range(8))
def test_packed_words_match_reference(catalog, seed, shape):
    packed, (alloc, price, rank), G, O, U, N = _window(catalog, seed, shape)
    t = torch.from_numpy
    for mode, (K0, ok) in MODES.items():
        K, dense16, coo16 = clamp_output_opts(K0, ok, G, N)
        assert (K > 0, dense16 or coo16) == (mode.startswith("coo"),
                                             mode.endswith("16")), mode
        ref = np.asarray(solve_packed(
            packed.copy(), alloc, price, rank, G=G, O=O, U=U, N=N,
            compact=K, dense16=dense16, coo16=coo16))
        got = tp.solve_packed_torch(
            t(packed.copy()), t(alloc), t(price), t(rank), G=G, O=O, U=U,
            N=N, compact=K, dense16=dense16, coo16=coo16).numpy()
        assert got.shape[0] == result_len(G, N, K, dense16, coo16)
        assert_words_equal(ref, got, G, N)


@pytest.mark.parametrize("right_size", [False, True])
def test_right_size_flag_matches(catalog, right_size):
    packed, (alloc, price, rank), G, O, U, N = _window(catalog, 3,
                                                       "packed_io")
    t = torch.from_numpy
    ref = np.asarray(solve_packed(packed.copy(), alloc, price, rank, G=G,
                                  O=O, U=U, N=N, right_size=right_size))
    got = tp.solve_packed_torch(t(packed.copy()), t(alloc), t(price),
                                t(rank), G=G, O=O, U=U, N=N,
                                right_size=right_size).numpy()
    assert_words_equal(ref, got, G, N)


def test_coo_overflow_drops_like_the_reference():
    """A COO tail smaller than the nonzero count keeps the first K
    entries in n-major order (the reference's mode="drop" scatter)."""
    assign = torch.zeros((4, 8), dtype=torch.int32)
    assign[1, 0] = 3
    assign[0, 2] = 1
    assign[3, 2] = 2
    assign[2, 5] = 4
    idx, cnt = tp.compact_assign(assign, 3)
    assert idx.tolist() == [0 * 4 + 1, 2 * 4 + 0, 2 * 4 + 3]
    assert cnt.tolist() == [3, 1, 2]


def test_frac_bp_matches_float_reference():
    rng = np.random.RandomState(0)
    den = rng.randint(1, 2 ** 31 - 1, 64).astype(np.int32)
    num = (den * rng.rand(64)).astype(np.int32)
    got = tp.frac_bp(torch.from_numpy(num), torch.from_numpy(den)).numpy()
    want = np.floor(num.astype(np.float64) * 10000 / den).astype(np.int64)
    np.testing.assert_array_equal(got, want)
