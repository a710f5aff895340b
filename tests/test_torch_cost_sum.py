"""The order-fixed sums of the port against the reference's jitted sums.

``cost_word`` (``solver/cost_sum.py``) must round each row of open-node
prices exactly as the reference's ``jnp.sum`` does on the CPU, single
and under ``jax.vmap``, at every N in ``NODE_BUCKETS``: masked price rows
summed as they lie (every node open on its own offering), random prices
with 30-70% of the nodes open, rows whose totals reach 2^24 (where a
float32 add starts to drop bits), and ragged lengths; and it must give
the reference's word from the scan's ``node_off`` and the catalog's
prices (one price row, a row per problem, or one shared row).  A sweep
holds it against the reference's fused, jitted word at every N from 1 to
1024, the ``NODE_BUCKETS``, 2048, 4096 and 8192, single and ``[C, N]``
rows (C in 1, 4, 8), which pins the 8-lane order of rows of 30-32 nodes;
zone-affinity windows at ``max_nodes=32`` must then plan as the
reference does.  The flat program's
presence-averaged rank (``solver/flat.presence_rank_sum``,
summed class by class) must equal the reference's jitted ``jnp.dot`` at
the padded shapes the program runs: every U in ``CLASS_BUCKETS``, every
O in ``OFFERING_BUCKETS``, N from 64 to 8192.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu.solver import JaxSolver, SolverOptions
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.flat import CLASS_BUCKETS
from karpenter_tpu.solver.types import NODE_BUCKETS, OFFERING_BUCKETS

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch.solver.cost_sum import (
    cost_sum_reference, cost_word, cost_word_reference,
)
from karpenter_tpu_torch.solver.flat import presence_rank_sum
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
)

from tests.test_torch_solver import (  # noqa: F401 (fixtures)
    assert_plans_equal, build_pods, jcatalog, mixed_specs, tcatalog,
)

_masked_sum = jax.jit(lambda p, o: jnp.sum(jnp.where(o, p, 0.0)))
_masked_sum_batch = jax.vmap(_masked_sum)


def price_rows(rng, C, N, big=False):
    """(prices float32 [C, N], open bool [C, N]): each row 30-70% open;
    ``big`` rows total near 2^24."""
    scale = (2 ** 24) / (0.5 * N) if big else 4.0
    prices = (rng.random((C, N)) * scale).astype(np.float32)
    frac = rng.uniform(0.3, 0.7, size=(C, 1))
    return prices, rng.random((C, N)) < frac


def bits(a):
    return np.asarray(a, dtype=np.float32).view(np.int32)


def cost_sum(masked):
    """The masked price row(s) float32 [N] or [C, N] summed by
    ``cost_word``: node n open on offering n, over the row with one
    spare price (so N = 0 still has a catalog)."""
    N = masked.shape[-1]
    node = torch.arange(N, dtype=torch.int32).expand(masked.shape)
    return cost_word(node.contiguous(),
                     torch.nn.functional.pad(masked, (0, 1)))


@pytest.mark.parametrize("N", NODE_BUCKETS)
def test_cost_sum_matches_jnp_sum(N):
    rng = np.random.default_rng(N)
    for big in (False, True):
        prices, is_open = price_rows(rng, 8, N, big)
        masked = np.where(is_open, prices, np.float32(0)).astype(np.float32)
        want = np.asarray(_masked_sum_batch(prices, is_open))
        got = cost_sum(torch.from_numpy(masked)).numpy()
        assert np.count_nonzero(bits(got) != bits(want)) == 0
        for c in range(2):
            one = cost_sum(torch.from_numpy(masked[c])).numpy()
            assert bits(one) == bits(_masked_sum(prices[c], is_open[c]))
        if big:
            assert want.max() > 2 ** 23


@pytest.mark.parametrize("N", [0, 1, 31, 33, 100, 1000, 4097])
def test_cost_sum_ragged_lengths(N):
    """A masked row summed as ``cost_word(arange(N), row)`` equals the
    reference's word over the same gather (at 30-32 nodes XLA sums a
    gathered row in 8 lanes, a ``where``-only row left to right: the
    solve paths all gather)."""
    rng = np.random.default_rng(7 + N)
    prices, is_open = price_rows(rng, 3, N)
    masked = np.where(is_open, prices, np.float32(0)).astype(np.float32)
    got = cost_sum(torch.from_numpy(masked)).numpy()
    if N:
        node = np.broadcast_to(np.arange(N, dtype=np.int32), (3, N))
        want = np.asarray(_word_rows(np.ascontiguousarray(node),
                                     np.pad(masked, ((0, 0), (0, 1)))))
    else:
        want = np.zeros(3, np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))


def test_cost_sum_is_not_a_plain_sum():
    """The windowed order is what makes the word: a sequential sum and
    torch's own reduction each differ from it on these rows."""
    rng = np.random.default_rng(0)
    prices, is_open = price_rows(rng, 64, 512, big=True)
    masked = torch.from_numpy(
        np.where(is_open, prices, np.float32(0)).astype(np.float32))
    want = bits(_masked_sum_batch(prices, is_open))
    assert np.array_equal(bits(cost_sum(masked)), want)
    seq = np.zeros(64, np.float32)
    for n in range(512):
        seq = (seq + masked[:, n].numpy()).astype(np.float32)
    assert not np.array_equal(bits(seq), want)
    assert not np.array_equal(bits(masked.sum(dim=1)), want)


def test_cost_sum_checks_its_input():
    """A masked row reaches the kernel only as float32 prices of [N] or
    [C, N] nodes; summed so it is its plain order-fixed sum."""
    with pytest.raises(ValueError, match="float32"):
        cost_sum(torch.zeros(64, dtype=torch.float64))
    with pytest.raises(ValueError, match="int32"):
        cost_sum(torch.zeros((2, 2, 64)))
    x = torch.rand(4, 64)
    assert torch.equal(cost_sum(x), cost_sum_reference(x))


# the reference's cost word as finish_pallas_solve forms it
_word = jax.jit(lambda no, price: jnp.sum(
    jnp.where(no >= 0, price[jnp.clip(no, 0)], 0.0)))
_word_rows = jax.vmap(_word)
_word_shared = jax.vmap(_word, in_axes=(0, None))


def node_rows(rng, C, N, O, open_frac):
    """node_off int32 [C, N]: each node open (an offering index) with
    probability open_frac, else -1."""
    off = rng.integers(0, O, size=(C, N)).astype(np.int32)
    return np.where(rng.random((C, N)) < open_frac, off, -1).astype(np.int32)


@pytest.mark.parametrize("N", NODE_BUCKETS + (1, 33, 1000))
def test_cost_word_matches_reference_word(N):
    """cost_word (its plain version here) against the reference's word,
    bit for bit: one row, C = 8 rows with a price row each and with one
    shared row (stride 0), rows all closed and all open, and prices whose
    totals pass 2^24."""
    rng = np.random.default_rng(1000 + N)
    C, O = 8, 200
    scale = 2.0 ** 27 / N
    prices = (rng.random((C, O)) * scale).astype(np.float32)
    node_off = node_rows(rng, C, N, O, 0.5)
    node_off[1] = -1                                  # all closed
    node_off[2] = rng.integers(0, O, size=N)          # all open
    cases = [
        (node_off[0], prices[0], _word(node_off[0], prices[0])),
        (node_off, prices, _word_rows(node_off, prices)),
        (node_off, prices[3], _word_shared(node_off, prices[3])),
    ]
    for no, price, want in cases:
        no_t, price_t = torch.from_numpy(no), torch.from_numpy(price)
        got = cost_word(no_t, price_t)
        assert got.shape == no_t.shape[:-1]
        np.testing.assert_array_equal(bits(got.numpy()), bits(want))
        assert torch.equal(cost_word_reference(no_t, price_t), got)
    assert bits(cost_word(torch.from_numpy(node_off[1]),
                          torch.from_numpy(prices[1]))) == 0
    assert cases[1][2][2] > 2 ** 24


def test_cost_word_checks_its_input():
    no = torch.zeros(64, dtype=torch.int32)
    price = torch.ones(16)
    with pytest.raises(ValueError, match="int32"):
        cost_word(no.long(), price)
    with pytest.raises(ValueError, match="float32"):
        cost_word(no, price.double())
    with pytest.raises(ValueError, match="matching"):
        cost_word(no, price[None])
    with pytest.raises(ValueError, match="matching"):
        cost_word(no.reshape(2, 32), torch.ones(3, 16))
    assert cost_word(no.reshape(2, 32), torch.ones(2, 16)).tolist() == \
        [32.0, 32.0]


_dot = jax.jit(jnp.dot)


@pytest.mark.parametrize("U", CLASS_BUCKETS)
def test_flat_presence_rank_sum_matches_jnp_dot(U):
    """Every O in OFFERING_BUCKETS at N = 64, every N from 64 to 8192 at
    the smallest O, and the largest O at N = 1024."""
    rng = np.random.default_rng(U)
    shapes = [(64, O) for O in OFFERING_BUCKETS] \
        + [(N, OFFERING_BUCKETS[0]) for N in NODE_BUCKETS if N <= 8192] \
        + [(1024, OFFERING_BUCKETS[-1])]
    for N, O in shapes:
        hrow = (rng.random((N, U)) < rng.uniform(0.02, 0.5)).astype(
            np.float32)
        rows = (rng.random((U, O)).astype(np.float32)
                * np.float32(3.7)) * (1.0 + 0.15 * rng.random((U, 1)))
        rows = rows.astype(np.float32)
        want = np.asarray(_dot(hrow, rows))
        got = presence_rank_sum(torch.from_numpy(hrow),
                                torch.from_numpy(rows)).numpy()
        bad = np.count_nonzero(bits(got) != bits(want))
        assert bad == 0, f"U={U} N={N} O={O}: {bad} words differ"


# -- the sweep: every length against the reference's fused, jitted word ------

def _word_program(Ns, C):
    """One jitted program holding the reference's word once per length
    (``_word`` for C = 0, its vmap over C rows with one shared price row
    otherwise): each output is the same fused gather-mask-sum XLA
    compiles for that length alone, and one compile serves the band."""
    one = _word if C == 0 else jax.vmap(_word, in_axes=(0, None))
    return jax.jit(lambda rows, price: [one(r, price) for r in rows])


def _sweep(Ns, C, seed, chunk=128):
    """Hold ``cost_word`` against the reference's word at every length in
    ``Ns`` (C = 0: single rows; else [C, N] rows); returns the lengths
    that differ."""
    rng = np.random.default_rng(seed)
    O = 211
    price = (rng.random(O) * 10.0 ** rng.uniform(-3, 3, O)).astype(
        np.float32)
    bad = []
    for i in range(0, len(Ns), chunk):
        band = Ns[i:i + chunk]
        rows = [node_rows(rng, max(C, 1), N, O, rng.uniform(0.3, 1.0))
                for N in band]
        rows = [r[0] if C == 0 else r for r in rows]
        want = _word_program(band, C)(rows, price)
        for N, r, w in zip(band, rows, want):
            got = cost_word(torch.from_numpy(r), torch.from_numpy(price))
            if not np.array_equal(bits(got.numpy()), bits(w)):
                bad.append(N)
    return bad


_LONG = sorted(set(NODE_BUCKETS) | {2048, 4096, 8192})


def test_cost_word_sweep_single_rows():
    """Every N from 1 to 1024 and the long lengths, one row each."""
    assert _sweep(list(range(1, 1025)) + _LONG, 0, 11) == []


@pytest.mark.parametrize("band", ["1-64", "65-928", "929-1024", "long"])
def test_cost_word_sweep_batched_rows(band):
    """[C, N] rows: every C in 1, 4, 8 at N in 1-64 (the 8-lane rows),
    929-1024 (whose last tree level holds 30-32 window sums) and the
    long lengths; between them C cycles through 1, 4, 8."""
    if band == "65-928":
        bad = []
        for k, C in enumerate((1, 4, 8)):
            bad += _sweep(list(range(65 + k, 929, 3)), C, 20 + C)
    else:
        Ns = {"1-64": list(range(1, 65)),
              "929-1024": list(range(929, 1025)), "long": _LONG}[band]
        bad = [N for C in (1, 4, 8) for N in _sweep(Ns, C, 30 + C)]
    assert bad == []


def test_lane_rows_are_not_summed_left_to_right():
    """The sweep has teeth at 30-32: on these rows the 8-lane order and
    a left-to-right sum give different words, and the port gives the
    reference's."""
    rng = np.random.default_rng(5)
    for N in (30, 31, 32):
        prices = (rng.random((64, N)) * 10.0 ** rng.uniform(-3, 3, (64, N))
                  ).astype(np.float32)
        node = np.ascontiguousarray(
            np.broadcast_to(np.arange(N, dtype=np.int32), (64, N)))
        padded = np.pad(prices, ((0, 0), (0, 1)))
        want = bits(_word_rows(node, padded))
        seq = np.zeros(64, np.float32)
        for n in range(N):
            seq = (seq + prices[:, n]).astype(np.float32)
        assert np.count_nonzero(bits(seq) != want) > 0
        got = cost_word(torch.from_numpy(node), torch.from_numpy(padded))
        np.testing.assert_array_equal(bits(got.numpy()), want)


def _zone_window(pod_mod, req_mod, seed):
    """220 pods: a seeded mixed window, three apps of 10 with hostname
    anti-affinity and three of 10 with zone affinity."""
    pods = build_pods(mixed_specs(160, seed), pod_mod, req_mod)
    for kind in ("web", "za"):
        for a in range(3):
            app = f"{kind}{a}"
            if kind == "web":
                term = pod_mod.PodAffinityTerm(
                    (("app", app),), pod_mod.HOSTNAME_TOPOLOGY_KEY,
                    anti=True)
                req = pod_mod.ResourceRequests(500, 1024, 0, 1)
            else:
                term = pod_mod.PodAffinityTerm((("app", app),),
                                               req_mod.LABEL_ZONE)
                req = pod_mod.ResourceRequests(1000, 2048, 0, 1)
            pods += [pod_mod.PodSpec(f"{app}-{i}", requests=req,
                                     labels=(("app", app),),
                                     affinity=(term,))
                     for i in range(10)]
    return pods


@pytest.mark.parametrize("seed", [3004, 3024, 3046])
def test_zone_affinity_window_at_32_nodes_plans_as_reference(
        jcatalog, tcatalog, seed):  # noqa: F811
    """220-pod zone-affinity windows at ``max_nodes=32``: node rows of 32
    price every zone candidate, so the winner hangs on the 8-lane word.
    Summed left to right, seeds 3024 and 3046 picked another candidate
    and their plans split from the reference's; 3004 split on the word
    alone."""
    jplan = JaxSolver(SolverOptions(use_pallas="off", max_nodes=32)).solve(
        JSolveRequest(_zone_window(j_pod, j_req, seed), jcatalog))
    ts = TorchSolver(TSolverOptions(max_nodes=32), device="cpu")
    tplan = ts.solve(SolveRequest(_zone_window(t_pod, t_req, seed),
                                  tcatalog))
    assert ts.last_stats["N"] == 32
    assert ts.last_stats["path"] == "ffd-reference-batch"
    assert_plans_equal(jplan, tplan)
