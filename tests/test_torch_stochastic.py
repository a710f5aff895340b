"""The port's stochastic (chance-constrained) route against the reference.

The same windows, built from a numpy seed, go through the reference's
``build_fit_grids`` / ``solve_packed_stochastic`` and the port's on the
CPU: the fit grids must be equal, the packed result word for word (the
float cost word included), and both must equal the numpy oracle
``stochastic/greedy.solve_stochastic_host`` (whose cost is a numpy sum:
its plan, priced in the reference's order, must give the cost word).  ``TorchSolver``
must route overcommitting-pool windows to the stochastic scan and give
``JaxSolver``'s plans; a zero-variance window packs exactly as the
deterministic scan; the port's ``validate_plan`` applies the chance rule
as the reference's does.  The port's workload builder is held against
the pod menu of ``bench.run_stochastic``, and no failure of the scan is
caught and re-run down another route.
"""

import numpy as np
import pytest
import torch

import bench
import karpenter_tpu.apis.nodeclaim as j_nodeclaim
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.solver as j_solver_pkg
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.jax_backend import unpack_reason_words, unpack_result
from karpenter_tpu.solver.validate import validate_plan as j_validate_plan
from karpenter_tpu.stochastic import z_bp_for, z_value, zsq_value
from karpenter_tpu.stochastic.encode import pack_stochastic
from karpenter_tpu.stochastic.greedy import solve_stochastic_host
from karpenter_tpu.stochastic.kernel import (
    build_fit_grids, solve_packed_stochastic,
)
from karpenter_tpu.stochastic.validate import (
    measured_violation_rate, violation_bound,
)

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.stochastic as t_sto
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
    validate_plan,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.cost_sum import cost_sum_reference
from karpenter_tpu_torch.solver import torch_backend
from karpenter_tpu_torch.stochastic import encode as t_sto_encode
from karpenter_tpu_torch.stochastic import kernel as t_kernel
from karpenter_tpu_torch.stochastic import validate as t_validate

from tests.test_torch_packed import assert_words_equal
from tests.test_torch_solver import assert_plans_equal

EPS = 0.05


def j_pool():
    return j_nodeclaim.NodePool(name="default", overcommit=EPS)


def t_pool():
    return t_nodeclaim.NodePool(name="default", overcommit=EPS)


def _usage_view(p):
    u = p.usage
    return (p.name, p.requests.as_tuple(),
            None if u is None else (u.mean.as_tuple(), tuple(u.var)))


def to_reference(pods):
    """The port's pods as the reference's (requests and usage only)."""
    out = []
    for p in pods:
        kw = {}
        if p.usage is not None:
            kw["usage"] = j_pod.UsageDistribution(
                mean=j_pod.ResourceRequests(*p.usage.mean.as_tuple()),
                var=tuple(p.usage.var))
        out.append(j_pod.PodSpec(
            p.name, requests=j_pod.ResourceRequests(*p.requests.as_tuple()),
            **kw))
    return out


@pytest.fixture(scope="module")
def catalogs():
    return bench.build_catalog(60), workload.build_catalog(60)


def bench_menu(monkeypatch, n):
    """The pods ``bench.run_stochastic`` builds, captured at its encode."""
    class Captured(Exception):
        pass

    got = {}

    def capture(pods, catalog, pool=None, *a, **k):
        got["pods"], got["pool"] = pods, pool
        raise Captured

    monkeypatch.setattr(j_solver_pkg, "encode", capture)
    with pytest.raises(Captured):
        bench.run_stochastic(num_pods=n, num_types=20)
    return got["pods"], got["pool"]


def test_menu_matches_bench(monkeypatch):
    jpods, pool = bench_menu(monkeypatch, 400)
    assert pool.overcommit == EPS
    tpods = workload.stochastic_pods(400, seed=13)
    assert [_usage_view(p) for p in tpods] == [_usage_view(p) for p in jpods]


@pytest.mark.parametrize("eps", [1e-9, 1e-4, 0.01, 0.05, 0.1, 0.3, 0.5])
def test_z_constants_match(eps):
    assert t_sto.z_value(eps) == z_value(eps)
    assert t_sto.z_bp_for(eps) == z_bp_for(eps)
    bp = z_bp_for(eps)
    assert t_sto.zsq_value(bp) == zsq_value(bp)


def _windows(catalogs, seed, n=200):
    jcat, tcat = catalogs
    tpods = workload.stochastic_pods(n, seed=seed)
    jprob = encode(to_reference(tpods), jcat, j_pool())
    tprob = t_encode(tpods, tcat, t_pool())
    assert t_sto.stochastic_enabled(tprob)
    assert not t_sto.stochastic_enabled(t_encode(tpods, tcat))
    return jprob, tprob


def _reference_run(problem):
    solver = JaxSolver(SolverOptions(use_pallas="off"))
    prep = solver._prepare(problem)
    off = solver._device_offerings(problem.catalog, prep.O_pad)
    kd, kc = build_fit_grids(prep.sto, off[0], G=prep.G_pad, z_bp=prep.z_bp)
    out = np.asarray(solve_packed_stochastic(
        prep.packed.copy(), prep.sto.copy(), kd, kc, *off, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, z_bp=prep.z_bp,
        right_size=True))
    return prep, off, (np.asarray(kd), np.asarray(kc)), out


def _port_run(problem, N):
    solver = TorchSolver(device="cpu")
    prep = solver._prepare(problem)
    assert prep.N == N
    off = solver.device_offerings(problem.catalog, prep.O_pad)
    sto = torch.from_numpy(prep.sto)
    kd, kc = t_kernel.build_fit_grids(sto, off[0], G=prep.G_pad,
                                      z_bp=prep.z_bp)
    out = t_kernel.solve_packed_stochastic(
        torch.from_numpy(prep.packed), sto, kd, kc, *off, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, z_bp=prep.z_bp,
        right_size=True).numpy()
    return prep, (kd.numpy(), kc.numpy()), out


@pytest.mark.parametrize("seed", range(8))
def test_scan_matches_reference_and_oracle(catalogs, seed):
    jprob, tprob = _windows(catalogs, seed)
    jprep, _, (kd, kc), ref = _reference_run(jprob)
    tprep, (tkd, tkc), got = _port_run(tprob, jprep.N)
    np.testing.assert_array_equal(tprep.packed, jprep.packed)
    np.testing.assert_array_equal(tprep.sto, jprep.sto)
    assert tprep.z_bp == jprep.z_bp
    np.testing.assert_array_equal(tkd, kd)
    np.testing.assert_array_equal(tkc, kc)
    G, N = jprep.G_pad, jprep.N
    assert_words_equal(ref, got, G, N)
    # and the numpy oracle
    g = jprob.num_groups
    node_off, assign, unplaced, cost = unpack_result(got, G, N, 0)
    words = unpack_reason_words(got, G, N, 0)
    h_off, h_assign, h_unp, h_cost, h_words = solve_stochastic_host(
        jprob, N, jprep.z_bp, right_size=True)
    np.testing.assert_array_equal(node_off, h_off)
    np.testing.assert_array_equal(assign[:g], h_assign)
    np.testing.assert_array_equal(unplaced[:g], h_unp)
    np.testing.assert_array_equal(words[:g], h_words)
    # the oracle sums its prices with numpy; its plan summed in the
    # reference's order is the cost word, to the bit
    price = np.asarray(jprob.catalog.off_price, dtype=np.float32)
    h_prices = np.where(h_off >= 0, price[np.clip(h_off, 0, None)],
                        np.float32(0)).astype(np.float32)
    want = cost_sum_reference(torch.from_numpy(h_prices)).numpy()
    assert np.float32(cost).view(np.int32) == want.view(np.int32)


def test_pack_stochastic_matches(catalogs):
    jprob, tprob = _windows(catalogs, 3)
    for G_pad in (jprob.num_groups, 64):
        np.testing.assert_array_equal(
            t_sto_encode.pack_stochastic(tprob.group_mean, tprob.group_var,
                                         G_pad),
            pack_stochastic(jprob.group_mean, jprob.group_var, G_pad))
    buf = t_sto_encode.pack_stochastic(tprob.group_mean, tprob.group_var, 64)
    mean, var = t_sto_encode.unpack_stochastic(buf, 64)
    np.testing.assert_array_equal(mean[:tprob.num_groups], tprob.group_mean)
    np.testing.assert_array_equal(var[:tprob.num_groups], tprob.group_var)


def test_zero_variance_packs_as_deterministic(catalogs):
    """Requests as means and no variance under an overcommit bound: the
    chance scan's result equals the deterministic scan's, word for
    word, and the plan equals the deterministic plan."""
    _, tcat = catalogs
    specs = [(f"zv{i}", 1000 + 500 * (i % 3), 2048 + 1024 * (i % 2))
             for i in range(60)]
    det = [t_pod.PodSpec(n, requests=t_pod.ResourceRequests(c, m, 0, 1))
           for n, c, m in specs]
    sto = [t_pod.PodSpec(n, requests=t_pod.ResourceRequests(c, m, 0, 1),
                         usage=t_pod.UsageDistribution(
                             mean=t_pod.ResourceRequests(c, m, 0, 1)))
           for n, c, m in specs]
    solver = TorchSolver(device="cpu")
    dprob, sprob = t_encode(det, tcat), t_encode(sto, tcat, t_pool())
    assert sprob.group_var is not None and not sprob.group_var.any()
    dprep, sprep = solver._prepare(dprob), solver._prepare(sprob)
    np.testing.assert_array_equal(dprep.packed, sprep.packed)
    dout = solver.dispatch_packed(dprep).numpy()
    sout = solver.dispatch_packed(sprep).numpy()
    assert (dprep.route, sprep.route) == ("ffd", "stochastic")
    assert_words_equal(dout, sout, dprep.G_pad, dprep.N)
    dplan = solver.solve(SolveRequest(det, tcat))
    splan = solver.solve(SolveRequest(sto, tcat, t_pool()))
    assert solver.last_stats["path"] == "stochastic-cpu"
    assert [(n.offering_index, n.pod_names) for n in splan.nodes] == \
        [(n.offering_index, n.pod_names) for n in dplan.nodes]


@pytest.mark.parametrize("seed", [0, 4])
def test_solver_matches_jax(catalogs, seed):
    jcat, tcat = catalogs
    tpods = workload.stochastic_pods(300, seed=seed)
    jpods = to_reference(tpods)
    jplan = JaxSolver(SolverOptions(use_pallas="off")).solve(
        JSolveRequest(jpods, jcat, j_pool()))
    ts = TorchSolver(device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat, t_pool()))
    assert ts.last_stats["path"] == "stochastic-cpu"
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat, t_pool()) == []
    assert validate_plan(tplan, tpods, tcat, t_pool()) == \
        j_validate_plan(jplan, jpods, jcat, j_pool())


def test_overcommit_risk_plan_matches(catalogs):
    """A variance-heavy window on a clamped node budget: unplaced pods
    carry the overcommit_risk reason and its p99-variance payload, as in
    the reference."""
    jcat, tcat = catalogs
    tpods = [t_pod.PodSpec(
        f"r{i}", requests=t_pod.ResourceRequests(4000, 8192, 0, 1),
        usage=t_pod.UsageDistribution(
            mean=t_pod.ResourceRequests(3000, 6000, 0, 1),
            var=(int((0.5 * 3000) ** 2), int((0.5 * 6000) ** 2), 0, 0)))
        for i in range(400)]
    jpods = to_reference(tpods)
    kw = dict(max_nodes=4, adaptive_nodes=False)
    jplan = JaxSolver(SolverOptions(use_pallas="off", **kw)).solve(
        JSolveRequest(jpods, jcat, j_pool()))
    tplan = TorchSolver(TSolverOptions(**kw), device="cpu").solve(
        SolveRequest(tpods, tcat, t_pool()))
    assert "overcommit_risk" in set(tplan.unplaced_reasons.values())
    assert_plans_equal(jplan, tplan)
    assert tplan.unplaced_nearest == jplan.unplaced_nearest


def test_validate_plan_applies_chance_rule(catalogs):
    """The chance rule on an overcommitting pool mirrors the reference:
    clean on the solver's plan, the same violations on a plan that
    crams every pod onto the first node."""
    jcat, tcat = catalogs
    tpods = workload.stochastic_pods(120, seed=2)
    jpods = to_reference(tpods)
    tplan = TorchSolver(device="cpu").solve(
        SolveRequest(tpods, tcat, t_pool()))
    assert validate_plan(tplan, tpods, tcat, t_pool()) == []
    crammed = tplan.nodes[0]
    crammed.pod_names = [n for node in tplan.nodes for n in node.pod_names]
    for node in tplan.nodes[1:]:
        node.pod_names = []
    got = validate_plan(tplan, tpods, tcat, t_pool())
    assert any("chance constraint violated" in e for e in got)
    assert got == j_validate_plan(tplan, jpods, jcat, j_pool())
    # and without overcommit the plain capacity rule applies instead
    plain = validate_plan(tplan, tpods, tcat)
    assert any("capacity exceeded" in e for e in plain)


def test_violation_probe_matches(catalogs):
    _, tcat = catalogs
    tpods = workload.stochastic_pods(150, seed=6)
    plan = TorchSolver(device="cpu").solve(
        SolveRequest(tpods, tcat, t_pool()))
    by = {f"{p.namespace}/{p.name}": p for p in tpods}
    jby = {p.name: p for p in to_reference(tpods)}
    alloc = tcat.offering_alloc()
    tnodes = [([by[n] for n in node.pod_names], alloc[node.offering_index])
              for node in plan.nodes]
    jnodes = [([jby[p.name] for p in pods], a) for pods, a in tnodes]
    rate, samples = t_validate.measured_violation_rate(tnodes, trials=64)
    assert (rate, samples) == measured_violation_rate(jnodes, trials=64)
    assert rate <= t_validate.violation_bound(EPS, samples) \
        == violation_bound(EPS, samples)


def test_scan_failure_is_not_caught(catalogs, monkeypatch):
    """The reference degrades a failed stochastic scan to the
    deterministic one; the port raises instead."""
    def boom(*a, **k):
        raise RuntimeError("injected stochastic scan fault")

    monkeypatch.setattr(torch_backend, "solve_packed_stochastic", boom)
    _, tcat = catalogs
    with pytest.raises(RuntimeError, match="injected"):
        TorchSolver(device="cpu").solve(SolveRequest(
            workload.stochastic_pods(40, seed=1), tcat, t_pool()))


@pytest.mark.slow
def test_full_size_window_matches_reference():
    """10k pods x 500 types, seed 13: the window chip_smoke.py solves."""
    tpods = workload.stochastic_pods(10_000, seed=13)
    jprob = encode(to_reference(tpods), bench.build_catalog(500), j_pool())
    tprob = t_encode(tpods, workload.build_catalog(500), t_pool())
    jprep, _, _, ref = _reference_run(jprob)
    _, _, got = _port_run(tprob, jprep.N)
    assert_words_equal(ref, got, jprep.G_pad, jprep.N)
