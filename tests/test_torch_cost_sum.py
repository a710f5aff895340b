"""The order-fixed sums of the port against the reference's jitted sums.

``cost_sum`` (``solver/cost_sum.py``) must round each row of open-node
prices exactly as the reference's ``jnp.sum`` does on the CPU, single
and under ``jax.vmap``, at every N in ``NODE_BUCKETS``: random prices
with 30-70% of the nodes open, rows whose totals reach 2^24 (where a
float32 add starts to drop bits), and ragged lengths.  The flat
program's presence-averaged rank (``solver/flat.presence_rank_sum``,
summed class by class) must equal the reference's jitted ``jnp.dot`` at
the padded shapes the program runs: every U in ``CLASS_BUCKETS``, every
O in ``OFFERING_BUCKETS``, N from 64 to 8192.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.solver.flat import CLASS_BUCKETS
from karpenter_tpu.solver.types import NODE_BUCKETS, OFFERING_BUCKETS

from karpenter_tpu_torch.solver.cost_sum import (
    cost_sum, cost_sum_reference,
)
from karpenter_tpu_torch.solver.flat import presence_rank_sum

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
    rng = np.random.default_rng(7 + N)
    prices, is_open = price_rows(rng, 3, N)
    masked = np.where(is_open, prices, np.float32(0)).astype(np.float32)
    got = cost_sum(torch.from_numpy(masked)).numpy()
    want = np.asarray(_masked_sum_batch(prices, is_open)) if N \
        else np.zeros(3, np.float32)
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
    with pytest.raises(ValueError, match="float32"):
        cost_sum(torch.zeros(64, dtype=torch.float64))
    with pytest.raises(ValueError, match="float32"):
        cost_sum(torch.zeros((2, 2, 64)))
    x = torch.rand(4, 64)
    assert torch.equal(cost_sum(x), cost_sum_reference(x))


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
