"""Batched solves of the port against the reference and the single window.

``solve_packed_batch_torch`` must give, row for row and word for word,
what the reference's ``solve_packed_batch`` gives on the same stacked
packed buffers (every output mode; the float cost word to a relative
1e-5), and what ``solve_packed_torch`` gives on each row.
``TorchSolver(device="cpu").solve_encoded_batch`` must give the plans of
``JaxSolver(use_pallas="off").solve_encoded_batch`` on windows carried
over from the reference encoder — plain, with forced node escalation and
with forced COO growth — and ``solve_stream(depth=8, batch=4)`` the
plans of per-window ``solve_encoded`` and of the reference's
``solve_stream``, across a catalog change and a group-bucket change that
break batches.  Plans are compared as tests/test_torch_solver.py does.
"""

import warnings

import numpy as np
import pytest
import torch

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver.jax_backend import (
    _pad1, _pad2, clamp_output_opts, pack_input, solve_packed_batch,
)
from karpenter_tpu.solver.types import (
    GROUP_BUCKETS, LABELROW_BUCKETS, OFFERING_BUCKETS, bucket,
)

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch import carry
from karpenter_tpu_torch.solver import (
    SolverOptions as TSolverOptions, TorchSolver, validate_plan,
)
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.solver import torch_backend
from karpenter_tpu_torch.solver.types import BATCH_BUCKETS

from tests.test_torch_packed import MODES, assert_words_equal
from tests.test_torch_solver import (
    assert_plans_equal, build_pods, mixed_specs,
)


@pytest.fixture(scope="module")
def jcatalog():
    cloud = FakeCloud()
    pricing = PricingProvider(cloud)
    arrays = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return arrays


def port_catalog(jcatalog):
    """A port catalog (a new object with its own uid) of the same data."""
    return carry.catalog_from_numpy(
        **{f: getattr(jcatalog, f) for f in carry.CATALOG_FIELDS})


@pytest.fixture(scope="module")
def tcatalog(jcatalog):
    return port_catalog(jcatalog)


def carried(jprob, tcatalog):
    """The reference's encoded window as a port EncodedProblem."""
    return carry.problem_from_numpy(
        tcatalog, group_req=jprob.group_req, group_count=jprob.group_count,
        group_cap=jprob.group_cap, group_prio=jprob.group_prio,
        label_rows=jprob.label_rows, label_idx=jprob.label_idx,
        groups=[{"pod_names": g.pod_names, "pinned_zone": g.pinned_zone,
                 "cap_per_node": g.cap_per_node,
                 "requirements": [(r.key, r.operator.value, r.values)
                                  for r in g.requirements]}
                for g in jprob.groups],
        rejected=jprob.rejected, rejected_reasons=jprob.rejected_reasons)


def windows(jcatalog, tcatalog, specs_list):
    """(reference problems, port problems, port pods) per spec list."""
    jprobs, tprobs, tpods = [], [], []
    for specs in specs_list:
        jp = encode(build_pods(specs, j_pod, j_req), jcatalog)
        jprobs.append(jp)
        tprobs.append(carried(jp, tcatalog))
        tpods.append(build_pods(specs, t_pod, t_req))
    return jprobs, tprobs, tpods


def unique_specs(n, seed):
    """n pods of distinct cpu requests: n groups (a larger G bucket, and
    more assign nonzeros than a small COO tail holds)."""
    return [(f"u{seed}-{i}", 100 + 7 * i + seed, 256, None, None)
            for i in range(n)]


# -- the device program -------------------------------------------------------


def stacked_rows(jcatalog, seeds):
    """Packed problems of seeded windows stacked [C, Li] at one common
    (G, O, U) bucket, and the padded catalog."""
    probs = [encode(build_pods(mixed_specs(150, s), j_pod, j_req), jcatalog)
             for s in seeds]
    G = max(bucket(p.num_groups, GROUP_BUCKETS) for p in probs)
    O = bucket(jcatalog.num_offerings, OFFERING_BUCKETS)
    U = bucket(max(p.label_rows.shape[0] for p in probs), LABELROW_BUCKETS)
    rows = np.stack([pack_input(
        _pad2(p.group_req, G), _pad1(p.group_count, G),
        _pad1(p.group_cap, G), _pad1(p.label_idx, G),
        _pad2(p.label_rows, U, O), group_prio=_pad1(p.group_prio, G))
        for p in probs])
    cat = (_pad2(jcatalog.offering_alloc().astype(np.int32), O),
           _pad1(jcatalog.off_price.astype(np.float32), O),
           _pad1(jcatalog.offering_rank_price(), O))
    return rows, cat, G, O, U


@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_program_matches_reference_and_single_rows(jcatalog, mode):
    rows, (alloc, price, rank), G, O, U = stacked_rows(jcatalog, (0, 1, 2))
    C, N = rows.shape[0], 128
    K, dense16, coo16 = clamp_output_opts(*MODES[mode], G, N)
    kw = dict(G=G, O=O, U=U, N=N, compact=K, dense16=dense16, coo16=coo16)
    ref = np.asarray(solve_packed_batch(rows.copy(), alloc, price, rank,
                                        **kw))
    t = torch.from_numpy
    with warnings.catch_warnings():
        # a vmapped op without a batching rule would run as a loop over
        # the rows, with a warning: none may
        warnings.simplefilter("error")
        got = tp.solve_packed_batch_torch(t(rows.copy()), t(alloc),
                                          t(price), t(rank), C=C, **kw)
    got = got.numpy()
    assert got.shape == ref.shape
    for c in range(C):
        assert_words_equal(ref[c], got[c], G, N)
        one = tp.solve_packed_torch(t(rows[c].copy()), t(alloc), t(price),
                                    t(rank), **kw).numpy()
        np.testing.assert_array_equal(got[c], one)


# -- solve_encoded_batch ------------------------------------------------------


def jax_solver(**kw):
    return JaxSolver(SolverOptions(use_pallas="off", **kw))


def torch_solver(**kw):
    return TorchSolver(TSolverOptions(**kw), device="cpu")


def check_batch(jprobs, tprobs, tpods, tcatalog, js, ts):
    jplans = js.solve_encoded_batch(jprobs)
    tplans = ts.solve_encoded_batch(tprobs)
    assert ts.last_stats["path"] == "ffd-reference-batch"
    assert ts.last_stats["batch"] == len(tprobs)
    assert ts.last_stats["batch_pad"] == \
        BATCH_BUCKETS[np.searchsorted(BATCH_BUCKETS, len(tprobs))]
    for jplan, tplan, pods in zip(jplans, tplans, tpods):
        assert_plans_equal(jplan, tplan)
        assert validate_plan(tplan, pods, tcatalog) == []
    return tplans


def test_solve_encoded_batch_matches_reference(jcatalog, tcatalog):
    """C = 3 carried windows (C_pad = 4, the fourth row repeats row 0)
    against the reference's batch and the port's single-window solves."""
    jprobs, tprobs, tpods = windows(
        jcatalog, tcatalog, [mixed_specs(200, s) for s in (21, 22, 23)])
    ts = torch_solver()
    tplans = check_batch(jprobs, tprobs, tpods, tcatalog, jax_solver(), ts)
    assert ts.last_stats["batch_pad"] == 4
    single = torch_solver()
    for p, plan in zip(tprobs, tplans):
        assert_plans_equal(single.solve_encoded(p), plan)


def test_solve_encoded_batch_node_escalation(jcatalog, tcatalog,
                                             monkeypatch):
    """The first node axis is too small for every window: the whole
    batch re-dispatches at 4x N."""
    monkeypatch.setattr(JaxSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    monkeypatch.setattr(TorchSolver, "_estimate_nodes",
                        staticmethod(lambda problem, n_cap: 8))
    jprobs, tprobs, tpods = windows(
        jcatalog, tcatalog, [mixed_specs(400, s) for s in (31, 32, 33)])
    ts = torch_solver()
    check_batch(jprobs, tprobs, tpods, tcatalog, jax_solver(), ts)
    assert ts.last_stats["escalations"] >= 1
    assert ts.last_stats["N"] > 8


def test_solve_encoded_batch_coo_growth(jcatalog, tcatalog, monkeypatch):
    """A COO tail smaller than a window's nonzero count overflows; the
    whole batch grows it and re-dispatches."""
    monkeypatch.setattr(JaxSolver, "_compact_k",
                        lambda self, total, G: (64, 4096))
    monkeypatch.setattr(TorchSolver, "_compact_k",
                        lambda self, total, G: (64, 4096))
    jprobs, tprobs, tpods = windows(
        jcatalog, tcatalog, [unique_specs(90, s) for s in (1, 2, 3)])
    opts = dict(compact_assign="on", flat_solver="off")
    ts = torch_solver(**opts)
    check_batch(jprobs, tprobs, tpods, tcatalog, jax_solver(**opts), ts)
    assert ts.last_stats["coo_growths"] >= 1
    assert ts.last_stats["compact"]


def test_solve_encoded_batch_of_other_catalogs_solves_each(jcatalog):
    """Windows of two catalogs cannot share a batch: each is solved on
    its own (the reference's rule), with the single-window path."""
    tcat_a, tcat_b = port_catalog(jcatalog), port_catalog(jcatalog)
    _, ta, _ = windows(jcatalog, tcat_a, [mixed_specs(50, 41)])
    _, tb, _ = windows(jcatalog, tcat_b, [mixed_specs(50, 42)])
    ts = torch_solver()
    plans = ts.solve_encoded_batch(ta + tb)
    assert ts.last_stats["path"] == "ffd-reference"
    for p, plan in zip(ta + tb, plans):
        assert_plans_equal(torch_solver().solve_encoded(p), plan)


# -- solve_stream -------------------------------------------------------------


def test_solve_stream_batches_match_single_windows(jcatalog, tcatalog,
                                                   monkeypatch):
    """depth=8, batch=4: same-shape windows of one catalog batch; a
    window of another catalog and a window of another group bucket break
    the batch.  Every plan equals the per-window solve and the
    reference's stream."""
    tcat_b = port_catalog(jcatalog)
    small = [mixed_specs(120, s) for s in range(50, 58)]
    wide = [unique_specs(40, s) for s in (1, 2)]
    jp, tp_a, tpods = windows(jcatalog, tcatalog, small[:5] + wide)
    jp_b, tp_b, tpods_b = windows(jcatalog, tcat_b, small[5:7])
    jp_c, tp_c, tpods_c = windows(jcatalog, tcatalog, small[7:])
    # reference stream: the reference's windows share its one catalog
    jstream = jp[:5] + jp_b + jp[5:] + jp_c
    tstream = tp_a[:5] + tp_b + tp_a[5:] + tp_c
    pods = tpods[:5] + tpods_b + tpods[5:] + tpods_c
    assert len({torch_solver()._prepare(p).G_pad for p in tstream}) == 2

    sizes = []
    real = torch_backend.BatchPendingSolve

    class Counting(real):
        __slots__ = ()

        def __init__(self, solver, items):
            sizes.append(len(items))
            super().__init__(solver, items)

    monkeypatch.setattr(torch_backend, "BatchPendingSolve", Counting)
    ts = torch_solver()
    got = list(ts.solve_stream(iter(tstream), depth=8, batch=4))
    assert len(got) == len(tstream)
    # 4 of catalog A, then one left over (a single window) before the
    # catalog changes; 2 of catalog B; 2 wide windows; one last single
    assert sizes == [4, 2, 2]
    ref = list(jax_solver().solve_stream(iter(jstream), depth=8, batch=4))
    single = torch_solver()
    for plan, jplan, p, pp in zip(got, ref, tstream, pods):
        assert_plans_equal(jplan, plan)
        assert_plans_equal(single.solve_encoded(p), plan)
        assert validate_plan(plan, pp, p.catalog) == []


@pytest.mark.parametrize("depth,batch", [(2, 4), (8, "auto"), (8, 1)])
def test_solve_stream_without_batching(jcatalog, tcatalog, monkeypatch,
                                       depth, batch):
    """depth < 4 caps the batch at 1, and "auto" is 1 on the CPU: the
    stream is the plain per-window pipeline."""
    def refuse(*a, **k):
        raise AssertionError("no batch expected")

    monkeypatch.setattr(torch_backend, "BatchPendingSolve", refuse)
    _, tprobs, _ = windows(jcatalog, tcatalog,
                           [mixed_specs(60, s) for s in (71, 72, 73)])
    ts = torch_solver()
    got = list(ts.solve_stream(iter(tprobs), depth=depth, batch=batch))
    for p, plan in zip(tprobs, got):
        assert_plans_equal(torch_solver().solve_encoded(p), plan)
    assert ts.last_stats["path"] == "ffd-reference"
