"""The port's flat-regime solver against the reference's.

Heterogeneous windows (``bench.build_hetero_workload`` and the port's
copy, the same seed) go through the reference's ``flat_solve_kernel``
and the port's ``flat_solve_torch`` on the CPU, in the classic and the
slim layout, with and without soft preferences: the result buffers must
be equal word for word, the float cost word included.
``TorchSolver`` must take the flat route where ``JaxSolver`` does and
give its plans, through node escalation on spill, a tight node budget
and unplaceable items.  The float32 segment sums the program's plan
hangs on must add in the reference's order: checked against the
reference's ``segment_sum`` and a sequential ``np.add.at``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import ops as jax_ops

import bench
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
import karpenter_tpu.solver.flat as j_flat
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
import karpenter_tpu_torch.solver.flat as t_flat
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
    validate_plan,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.segment_sum import segment_sum

from tests.test_torch_solver import assert_plans_equal


def _view(p):
    return (p.name, p.requests.as_tuple(), p.node_selector,
            tuple(r.signature for r in p.required_requirements),
            tuple((w, r.signature) for w, r in p.preferred_requirements))


WINDOWS = {"plain": dict(seed=7), "constrained_pref": dict(
    seed=11, constrained_frac=0.3, pref_frac=0.15)}


def _hetero(n, types, **kw):
    return (bench.build_hetero_workload(n, types, **kw),
            workload.build_hetero_workload(n, types, **kw))


@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_workload_matches_bench(window):
    (jpods, jcat), (tpods, tcat) = _hetero(600, 30, **WINDOWS[window])
    assert [_view(p) for p in tpods] == [_view(p) for p in jpods]
    np.testing.assert_array_equal(jcat.offering_alloc(),
                                  tcat.offering_alloc())
    np.testing.assert_array_equal(jcat.offering_rank_price(),
                                  tcat.offering_rank_price())


def test_segment_sum_adds_in_reference_order():
    """Totals past 2^24 round by the order of the adds: the port's CPU
    segment sum, the reference's segment_sum and a sequential np.add.at
    agree bit for bit, and a reversed order does not."""
    rng = np.random.RandomState(0)
    I, S = 20000, 7
    vals = rng.randint(256, 32768, size=(I, 4)).astype(np.float32)
    vals *= rng.choice([1.0, 1.0001, 0.9999], size=(I, 4)).astype(
        np.float32)
    vals[rng.rand(I) < 0.2] = 0.0
    seg = rng.randint(0, S, size=I).astype(np.int32)
    want = np.zeros((S, 4), np.float32)
    np.add.at(want, seg, vals)
    assert want.max() > 2 ** 24
    ref = np.asarray(jax_ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                         num_segments=S))
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                      S).numpy()
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got, want)
    rev = np.zeros((S, 4), np.float32)
    np.add.at(rev, seg[::-1], vals[::-1])
    assert (rev != want).any()


def test_segment_sum_drops_out_of_range_ids():
    """Ids outside [0, S) drop, as in the reference's segment_sum (the
    card's kernel drops them too: test_torch_cuda.py)."""
    rng = np.random.RandomState(1)
    I, S = 500, 6
    vals = rng.randint(1, 1000, size=(I, 4)).astype(np.float32)
    seg = rng.randint(-2, S + 2, size=I).astype(np.int32)
    assert ((seg < 0) | (seg >= S)).any()
    ref = np.asarray(jax_ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                         num_segments=S))
    got = segment_sum(torch.from_numpy(vals), torch.from_numpy(seg),
                      S).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("I,S", [(500, 6), (4096, 129), (2000, 1)])
def test_segment_sum_without_sentinel_segment(I, S):
    """The flat program's calls pass S segments where the reference
    passes S + 1 and slices the sentinel off: with ids at S (the
    sentinel) and -1 among them, both give the same words."""
    rng = np.random.RandomState(I + S)
    vals = (rng.randint(100, 32768, size=(I, 4))
            * rng.choice([1.0, 1.0001, 0.9999], size=(I, 4))
            ).astype(np.float32)
    seg = rng.randint(0, S, size=I).astype(np.int32)
    stray = rng.rand(I)
    seg[stray < 0.3] = S
    seg[stray > 0.95] = -1
    v, s = torch.from_numpy(vals), torch.from_numpy(seg)
    got = segment_sum(v, s, S)
    want = segment_sum(v, s, S + 1)[:S]
    assert got.shape == (S, 4)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    ref = np.asarray(jax_ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg),
                                         num_segments=S + 1))[:S]
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  ref.view(np.int32))


def _templates(jprob, tprob, max_nodes=4096):
    js = JaxSolver(SolverOptions(use_pallas="off", max_nodes=max_nodes))
    ts = TorchSolver(TSolverOptions(max_nodes=max_nodes), device="cpu")
    ja = j_flat._flat_template(js, jprob)
    ta = t_flat.flat_template(ts, tprob)
    for f in ("item_req", "item_gid", "item_live", "rows", "item_row",
              "miss_rows"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f),
                                      err_msg=f)
    for f in ("G_pad", "O_pad", "I_pad", "U_pad", "N", "N_cap", "K", "slim"):
        assert getattr(ta, f) == getattr(ja, f), f
    return js, ts, ja, ta


def _both_programs(js, ts, ja, ta, catalog, slim, lam_bp=1500):
    off = js._device_offerings(catalog, ja.O_pad)
    kw = dict(I=ja.I_pad, O=ja.O_pad, G=ja.G_pad, N=ja.N, K=ja.K,
              U=ja.U_pad, lam_bp=lam_bp, slim=slim)
    ref = np.asarray(j_flat.flat_solve_kernel(
        ja.item_req, ja.item_gid, ja.item_live, ja.rows, ja.item_row,
        off[0], off[2], ja.miss_rows, off[1], **kw))
    t = [torch.from_numpy(np.array(x)) for x in
         (ta.item_req, ta.item_gid, ta.item_live, ta.rows, ta.item_row,
          off[0], off[2], ta.miss_rows, off[1])]
    got, info = t_flat.flat_solve_torch(*t, **kw)
    return ref, got.numpy(), info


def assert_flat_words_equal(ref, got, a, slim):
    assert ref.shape == got.shape
    cost_w = (a.N // 2 + a.G_pad // 2) if slim else a.N + a.G_pad
    bad = np.nonzero(ref != got)[0]
    assert bad.size == 0, (f"{bad.size} words differ, first at {bad[0]} "
                           f"(cost word at {cost_w}): {ref[bad[0]]} vs "
                           f"{got[bad[0]]}")


@pytest.mark.parametrize("slim", [False, True], ids=["classic", "slim"])
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_program_matches_reference(window, slim):
    (jpods, jcat), (tpods, tcat) = _hetero(1500, 60, **WINDOWS[window])
    jprob, tprob = encode(jpods, jcat), t_encode(tpods, tcat)
    js, ts, ja, ta = _templates(jprob, tprob)
    if window == "constrained_pref":
        assert ta.miss_rows.any() and ta.U_pad > 4
    ref, got, info = _both_programs(js, ts, ja, ta, jcat, slim)
    assert_flat_words_equal(ref, got, ja, slim)
    assert 1 <= info["rounds"] <= 12
    assert info["host_syncs"] in (info["rounds"], info["rounds"] + 1)


def test_program_with_unplaceable_items():
    """Pods no offering holds, and pods pinned to a zone that does not
    exist, stay unplaced; the rest places as in the reference."""
    (jpods, jcat), (tpods, tcat) = _hetero(800, 40, seed=3)
    for mod, req, pods in ((j_pod, j_req, jpods), (t_pod, t_req, tpods)):
        pods += [mod.PodSpec(f"huge{i}", requests=mod.ResourceRequests(
            900_000, 1024, 0, 1)) for i in range(3)]
        pods += [mod.PodSpec(f"mars{i}", requests=mod.ResourceRequests(
            500, 1024, 0, 1), node_selector=((req.LABEL_ZONE, "mars-1"),))
            for i in range(2)]
    jprob, tprob = encode(jpods, jcat), t_encode(tpods, tcat)
    js, ts, ja, ta = _templates(jprob, tprob)
    ref, got, _ = _both_programs(js, ts, ja, ta, jcat, ja.slim)
    assert_flat_words_equal(ref, got, ja, ja.slim)
    opts = dict(flat_solver="on")
    jplan = JaxSolver(SolverOptions(use_pallas="off", **opts)).solve(
        JSolveRequest(jpods, jcat))
    tplan = TorchSolver(TSolverOptions(**opts), device="cpu").solve(
        SolveRequest(tpods, tcat))
    assert {"default/huge0", "default/mars0"} <= set(tplan.unplaced_pods)
    assert_plans_equal(jplan, tplan)


def test_node_escalation_on_spill(monkeypatch):
    """A node axis far below the window's need spills; the attempt
    re-runs at 4x N until nothing spills, as in the reference."""
    monkeypatch.setattr(j_flat, "estimate_nodes", lambda *a, **k: 64)
    monkeypatch.setattr(t_flat, "estimate_nodes", lambda *a, **k: 64)
    (jpods, jcat), (tpods, tcat) = _hetero(3000, 60, seed=5)
    opts = dict(flat_solver="on")
    jplan = JaxSolver(SolverOptions(use_pallas="off", **opts)).solve(
        JSolveRequest(jpods, jcat))
    ts = TorchSolver(TSolverOptions(**opts), device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert ts.last_stats["escalations"] >= 1 and ts.last_stats["N"] > 64
    assert not tplan.unplaced_pods
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []


def test_tight_node_budget():
    """max_nodes below the window's need: the spill cannot escalate past
    the cap and the rest stays unplaced, with the reference's reasons."""
    (jpods, jcat), (tpods, tcat) = _hetero(2000, 40, seed=9)
    opts = dict(flat_solver="on", max_nodes=64)
    jplan = JaxSolver(SolverOptions(use_pallas="off", **opts)).solve(
        JSolveRequest(jpods, jcat))
    ts = TorchSolver(TSolverOptions(**opts), device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert ts.last_stats["path"] == "flat-cpu"
    assert tplan.unplaced_pods
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []
    # the synchronous entry point gives the same plan
    assert_plans_equal(jplan, t_flat.solve_flat(ts, t_encode(tpods, tcat)))


@pytest.mark.parametrize("n,types,kw,opts", [
    (400, 30, WINDOWS["plain"], dict(flat_solver="on")),
    (600, 40, WINDOWS["constrained_pref"], dict(flat_solver="on")),
    (600, 40, WINDOWS["constrained_pref"],
     dict(flat_solver="on", preference_lambda=0.5)),
    (2500, 60, dict(seed=21), {}),
], ids=["forced", "forced-constrained-pref", "pref-lambda", "auto"])
def test_solver_matches_jax(n, types, kw, opts):
    (jpods, jcat), (tpods, tcat) = _hetero(n, types, **kw)
    js = JaxSolver(SolverOptions(use_pallas="off", **opts))
    jplan = js.solve(JSolveRequest(jpods, jcat))
    assert js.last_stats["path"] == "flat"
    ts = TorchSolver(TSolverOptions(**opts), device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert ts.last_stats["path"] == "flat-cpu"
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []


def test_gate_matches_reference():
    """``flat_viable`` agrees with the reference's on windows below and
    above the threshold, forced on and off, with right-sizing off, with
    preferences and with an anti-affinity cap."""
    cases = []
    for n, kw in ((300, {}), (2500, {}), (400, WINDOWS["constrained_pref"])):
        (jpods, jcat), (tpods, tcat) = _hetero(n, 30, **kw)
        cases.append((encode(jpods, jcat), t_encode(tpods, tcat)))
    anti_j = [j_pod.PodSpec(f"a{i}", labels=(("app", "a"),),
                            affinity=(j_pod.PodAffinityTerm(
                                (("app", "a"),), anti=True),))
              for i in range(4)]
    anti_t = [t_pod.PodSpec(f"a{i}", labels=(("app", "a"),),
                            affinity=(t_pod.PodAffinityTerm(
                                (("app", "a"),), anti=True),))
              for i in range(4)]
    (_, jcat), (_, tcat) = _hetero(10, 30, seed=1)
    cases.append((encode(anti_j, jcat), t_encode(anti_t, tcat)))
    seen = set()
    for opts in (dict(), dict(flat_solver="on"), dict(flat_solver="off"),
                 dict(flat_solver="on", right_size=False)):
        for jprob, tprob in cases:
            want = j_flat.flat_viable(jprob, SolverOptions(**opts))
            assert t_flat.flat_viable(tprob, TSolverOptions(**opts)) == want
            seen.add(want)
    assert seen == {True, False}


@pytest.mark.slow
@pytest.mark.parametrize("window", sorted(WINDOWS))
def test_full_size_window_matches_reference(window):
    """10k pods x 500 types: the windows chip_smoke.py solves."""
    (jpods, jcat), (tpods, tcat) = _hetero(10_000, 500, **WINDOWS[window])
    jprob, tprob = encode(jpods, jcat), t_encode(tpods, tcat)
    js, ts, ja, ta = _templates(jprob, tprob)
    ref, got, _ = _both_programs(js, ts, ja, ta, jcat, ja.slim)
    assert_flat_words_equal(ref, got, ja, ja.slim)
