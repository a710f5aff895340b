"""The port's host oracles of the routes and planes against the reference's.

Each ported oracle runs beside its reference twin on the same inputs:
``stochastic/greedy`` (the chance-fit search, the risk words, the binding
mask and ``solve_stochastic_host``), ``affinity/greedy`` (the spread
allowance, the affinity words and ``solve_affinity_host``),
``explain/validate.check_plan_reasons``, and the greedy gang, preemption
and repack planners.  On the CPU each device planner of the port (its
torch grid forced on) must also equal the port's own oracle, as the
reference's planners equal theirs.
"""

from __future__ import annotations

import numpy as np
import pytest

from karpenter_tpu.affinity import greedy as j_aff_greedy
from karpenter_tpu.explain import validate as j_validate
from karpenter_tpu.gang.greedy import GreedyGangPlanner as JGreedyGang
from karpenter_tpu.preempt import PlannerOptions as JPlannerOptions
from karpenter_tpu.preempt.greedy import (
    GreedyPreemptionPlanner as JGreedyPreempt,
)
from karpenter_tpu.repack import encode_repack as j_encode_repack
from karpenter_tpu.repack.greedy import GreedyRepacker as JGreedyRepacker
from karpenter_tpu.solver import GreedySolver as JGreedySolver
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver import SolverOptions
from karpenter_tpu.solver import encode as j_encode
from karpenter_tpu.stochastic import greedy as j_sto_greedy

from karpenter_tpu_torch.affinity import greedy as t_aff_greedy
from karpenter_tpu_torch.explain import validate as t_validate
from karpenter_tpu_torch.gang import (
    GangOptions, GangPlanner, GreedyGangPlanner, encode_gangs,
)
from karpenter_tpu_torch.preempt import (
    GreedyPreemptionPlanner, PlannerOptions, PreemptionPlanner,
    encode_victims,
)
from karpenter_tpu_torch.repack import (
    GreedyRepacker, RepackOptions, RepackPlanner, encode_repack,
)
from karpenter_tpu_torch.solver import (
    GreedySolver, SolveRequest, SolverOptions as TSolverOptions,
    TorchSolver,
)
from karpenter_tpu_torch.solver.encode import encode as t_encode
from karpenter_tpu_torch.solver.torch_backend import unpack_result
from karpenter_tpu_torch.stochastic import greedy as t_sto_greedy

from tests import test_torch_affinity as aff_t
from tests import test_torch_gang as gang_t
from tests import test_torch_preempt as pre_t
from tests import test_torch_repack as rep_t
from tests import test_torch_stochastic as sto_t
from tests.test_torch_solver import (  # noqa: F401 (fixtures)
    both, jcatalog, mixed_specs, tcatalog,
)


def assert_tuples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


# -- stochastic ---------------------------------------------------------------

@pytest.fixture(scope="module")
def sto_catalogs():
    return sto_t.catalogs.__wrapped__()


def test_chance_fit_risk_words_and_binding_mask_match():
    rng = np.random.default_rng(3)
    G, O, R = 24, 40, 4
    mean = rng.integers(0, 900, (G, R)).astype(np.int32)
    mean[::5, 2] = 0
    var = rng.integers(0, 40000, (G, R)).astype(np.int32)
    var[::4] = 0
    alloc = rng.integers(1000, 64000, (O, R)).astype(np.int32)
    compat = rng.random((G, O)) < 0.6
    count = rng.integers(0, 50, G).astype(np.int64)
    unplaced = np.minimum(rng.integers(0, 5, G), count).astype(np.int64)
    for z_bp in (0, 16449, 23263):
        assert_tuples_equal(
            (t_sto_greedy.risk_words_np(mean, var, count, unplaced, compat,
                                        alloc, z_bp),),
            (j_sto_greedy.risk_words_np(mean, var, count, unplaced, compat,
                                        alloc, z_bp),))
        assert_tuples_equal(
            (t_sto_greedy.binding_mask_np(mean, var, compat, alloc, z_bp),),
            (j_sto_greedy.binding_mask_np(mean, var, compat, alloc, z_bp),))
        zsq = np.float32(z_bp * 1e-4) ** 2
        resid = alloc[:G] - mean * 3
        var_sum = (var * 2).astype(np.float32)
        hi = rng.integers(0, 2048, G).astype(np.int64)
        for g in range(0, G, 6):
            assert_tuples_equal(
                (t_sto_greedy.chance_fit_np(resid, var_sum, mean[g],
                                            var[g].astype(np.float32), zsq,
                                            hi),),
                (j_sto_greedy.chance_fit_np(resid, var_sum, mean[g],
                                            var[g].astype(np.float32), zsq,
                                            hi),))


@pytest.mark.parametrize("seed", [0, 3, 6])
def test_stochastic_host_matches_reference_and_port_scan(sto_catalogs, seed):
    jprob, tprob = sto_t._windows(sto_catalogs, seed)
    jprep, _, _, _ = sto_t._reference_run(jprob)
    N, z_bp = jprep.N, jprep.z_bp
    want = j_sto_greedy.solve_stochastic_host(jprob, N, z_bp)
    got = t_sto_greedy.solve_stochastic_host(tprob, N, z_bp)
    assert_tuples_equal(got, want)
    # the port's scan on the CPU equals the port's own oracle
    tprep, _, out = sto_t._port_run(tprob, N)
    G, g = tprep.G_pad, tprob.num_groups
    node_off, assign, unplaced, _ = unpack_result(out, G, N, 0)
    np.testing.assert_array_equal(node_off, got[0])
    np.testing.assert_array_equal(assign[:g], got[1])
    np.testing.assert_array_equal(unplaced[:g], got[2])


# -- affinity -----------------------------------------------------------------

@pytest.fixture(scope="module")
def aff_catalogs():
    return aff_t.catalogs.__wrapped__()


def test_spread_allowance_and_affinity_words_match(aff_catalogs):
    rng = np.random.default_rng(9)
    cnt = rng.integers(0, 6, (16, 32)).astype(np.int32)
    member = (rng.random(32) < 0.3).astype(np.int32)
    bounds = np.where(rng.random(32) < 0.5, rng.integers(1, 8, 32),
                      1 << 20).astype(np.int32)
    assert_tuples_equal(
        (t_aff_greedy.spread_allowance_np(cnt, member, bounds),),
        (j_aff_greedy.spread_allowance_np(cnt, member, bounds),))
    _, _, jprob, tprob = aff_t._bench_windows(aff_catalogs, 3)
    unplaced = rng.integers(0, 3, jprob.num_groups).astype(np.int32)
    assert_tuples_equal(
        (t_aff_greedy.affinity_words_np(tprob, unplaced),),
        (j_aff_greedy.affinity_words_np(jprob, unplaced),))


@pytest.mark.parametrize("seed", [0, 2, 5])
def test_affinity_host_matches_reference_and_port_scan(aff_catalogs, seed):
    _, _, jprob, tprob = aff_t._bench_windows(aff_catalogs, seed)
    tprep, out = aff_t._port_run(tprob)
    N = tprep.N
    want = j_aff_greedy.solve_affinity_host(jprob, N, right_size=True)
    got = t_aff_greedy.solve_affinity_host(tprob, N, right_size=True)
    assert_tuples_equal(got, want)
    G, g = tprep.G_pad, tprob.num_groups
    node_off, assign, unplaced, _ = unpack_result(out, G, N, 0)
    np.testing.assert_array_equal(node_off, got[0])
    np.testing.assert_array_equal(assign[:g], got[1])
    np.testing.assert_array_equal(unplaced[:g], got[2])


# -- explain -----------------------------------------------------------------

def test_check_plan_reasons_matches_reference(jcatalog, tcatalog):
    """Clean plans (the oracle's and the solver's, with unplaced pods of
    every static kind) give no violation in either package; a plan with
    lying, missing and non-canonical reasons gives the same strings."""
    specs = mixed_specs(80, 5) + [(f"huge-{i}", 10 ** 7, 10 ** 8, None,
                                   None) for i in range(2)]
    jpods, tpods = both(specs)
    jprob, tprob = j_encode(jpods, jcatalog), t_encode(tpods, tcatalog)
    jplan = JGreedySolver(SolverOptions(use_native="off")).solve(
        JSolveRequest(jpods, jcatalog))
    plans = [GreedySolver(TSolverOptions(use_native="off")).solve(
        SolveRequest(tpods, tcatalog)),
        TorchSolver(device="cpu").solve(SolveRequest(tpods, tcatalog))]
    assert t_validate.STATIC_REASONS == j_validate.STATIC_REASONS
    assert j_validate.check_plan_reasons(jprob, jplan) == []
    for plan in plans:
        assert len(plan.unplaced_pods) == 2
        assert t_validate.check_plan_reasons(tprob, plan) == []
    lie = plans[0]
    jlie = jplan
    for p in (lie, jlie):
        first, second = p.unplaced_pods
        p.unplaced_reasons = {first: "capacity_nodes", second: "bogus"}
        p.unplaced_pods.append(p.unplaced_pods[0].replace("huge", "x"))
    got = t_validate.check_plan_reasons(tprob, lie)
    assert got == j_validate.check_plan_reasons(jprob, jlie)
    assert len(got) == 3


# -- gang ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang_catalogs():
    return gang_t.catalogs.__wrapped__()


@pytest.mark.parametrize("seed", [17, 3, 8])
def test_greedy_gang_planner_matches_reference_and_grid(gang_catalogs, seed):
    jcat, tcat = gang_catalogs
    _, tpods, jprob = gang_t.window(gang_catalogs, seed)
    want = JGreedyGang().plan(jprob)
    tprob = gang_t.carried(jprob, tcat)
    got = GreedyGangPlanner().plan(tprob)
    assert got.backend == want.backend == "greedy"
    assert gang_t.fingerprint(got) == gang_t.fingerprint(want)
    assert gang_t.fingerprint(GreedyGangPlanner().plan(
        encode_gangs(tpods, tcat))) == gang_t.fingerprint(got)
    grid = GangPlanner(GangOptions(use_device="on"), device="cpu")
    assert gang_t.fingerprint(grid.plan(tprob)) == gang_t.fingerprint(got)
    assert grid.device_steps > 0


# -- preemption ----------------------------------------------------------------

@pytest.fixture(scope="module")
def pre_catalogs():
    return pre_t.catalogs.__wrapped__()


@pytest.mark.parametrize("seed", [31, 5])
def test_greedy_preemption_planner_matches_reference_and_grid(pre_catalogs,
                                                             seed):
    jcat, tcat = pre_catalogs
    (_, _, jprob, jv, jcompat), (tcl, tpods) = pre_t.window(pre_catalogs,
                                                            seed)
    budget = 60 * 3
    want = JGreedyPreempt(JPlannerOptions(max_evictions=budget)).plan(
        jprob, jv, jcompat)
    assert want.evictions and want.unplaced
    opts = PlannerOptions(max_evictions=budget)
    got = GreedyPreemptionPlanner(opts).plan(
        pre_t.carried_problem(jprob, tcat), pre_t.carried_victims(jv),
        jcompat)
    assert got.backend == want.backend == "greedy"
    assert pre_t.fingerprint(got) == pre_t.fingerprint(want)
    own = (t_encode(tpods, tcat), encode_victims(tcl, tcat))
    oracle = GreedyPreemptionPlanner(opts).plan(*own)
    assert pre_t.fingerprint(oracle) == pre_t.fingerprint(got)
    grid = PreemptionPlanner(PlannerOptions(use_device="on",
                                            max_evictions=budget),
                             device="cpu")
    assert pre_t.fingerprint(grid.plan(*own)) == pre_t.fingerprint(oracle)
    assert grid.device_steps > 0


# -- repack --------------------------------------------------------------------

@pytest.fixture(scope="module")
def rep_catalogs():
    return rep_t.catalogs.__wrapped__()


@pytest.mark.parametrize("fleet", ["defrag"] + [f"random{s}"
                                                for s in range(5)])
def test_greedy_repacker_matches_reference_and_grid(rep_catalogs, fleet):
    jcat, tcat = rep_catalogs
    f = rep_t.defrag_fleet() if fleet == "defrag" \
        else rep_t.random_fleet(int(fleet[6:]))
    jcl, tcl = f.both()
    jprob, tprob = j_encode_repack(jcl, jcat), encode_repack(tcl, tcat)
    want = JGreedyRepacker().plan(jprob)
    got = GreedyRepacker().plan(tprob)
    assert got.backend == want.backend == "greedy"
    assert rep_t.plan_view(got) == rep_t.plan_view(want)
    grid = RepackPlanner(RepackOptions(use_device="on"), device="cpu")
    assert rep_t.plan_view(grid.plan(tprob)) == rep_t.plan_view(got)
    assert grid.device_steps == 1


def test_oracles_never_run_inside_the_device_planners(gang_catalogs,
                                                      monkeypatch):
    """The planners' torch grids and TorchSolver reach no oracle: with
    every oracle made to raise, they still plan."""
    def never(*a, **k):
        raise AssertionError("an oracle was reached")

    for cls in (GreedyGangPlanner, GreedyPreemptionPlanner, GreedyRepacker):
        monkeypatch.setattr(cls, "plan", never)
    for mod, name in ((t_sto_greedy, "solve_stochastic_host"),
                      (t_aff_greedy, "solve_affinity_host"),
                      (GreedySolver, "solve_encoded")):
        monkeypatch.setattr(mod, name, never)
    _, tpods, jprob = gang_t.window(gang_catalogs, 17)
    GangPlanner(GangOptions(use_device="on"), device="cpu").plan(
        gang_t.carried(jprob, gang_catalogs[1]))
    pods = gang_t.build_pods(gang_t.gang_specs(4, 2, 1), gang_t.t_pod,
                             gang_t.t_pg)
    TorchSolver(device="cpu").solve(SolveRequest(pods, gang_catalogs[1]))
