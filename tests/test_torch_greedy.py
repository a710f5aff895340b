"""The port's host greedy oracle against the reference's.

``karpenter_tpu_torch/solver/greedy.py`` (``GreedySolver``, its grouped
python loop and its C++ per-pod twin ``csrc/ffd_host.cpp`` built by
``native.py``) must give the reference's plans node for node, pod names
and cost included, on the same windows: seeded mixed pods, zone
selectors and hostname anti-affinity caps, unplaceable pods, node
overflow that escalates, zone candidates.  The native path must equal
the python path, the per-pod expansion the grouped plan, and the port's
C++ twin the reference's word for word.  The card's solver keeps its
cost at or below the oracle's (the twin of the reference's
``test_parity_with_oracle_mixed``), ``make_solver`` hands the oracle out
only for ``backend="greedy"``, and a fault of the card's solver still
raises: nothing degrades to the oracle.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu import native as j_native
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver import SolverOptions, encode
from karpenter_tpu.solver.greedy import GreedySolver as JGreedy
from karpenter_tpu.solver.greedy import expand_per_pod as j_expand

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch import make_solver, native
from karpenter_tpu_torch.solver import (
    GreedySolver, SolveRequest, SolverOptions as TSolverOptions,
    TorchSolver, validate_plan,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver.greedy import (
    expand_per_pod, solve_per_pod_native,
)

from tests.test_torch_solver import (  # noqa: F401 (fixtures)
    assert_plans_equal, both, build_pods, jcatalog, mixed_specs, node_view,
    tcatalog,
)


@pytest.fixture(scope="module", autouse=True)
def reference_native():
    """The reference builds its native library with ``make`` into one
    path at first load; test workers building at once can leave one of
    them holding a half-written library, and its failed load is sticky,
    so its greedy would take the python loop.  Load once more, now that
    the library is whole, so both packages' greedy take the native loop
    (the reference's own code is not touched)."""
    if j_native.load() is None:
        j_native._load_failed = False
    assert j_native.load() is not None


def greedy_pair(use_native="auto", **kw):
    return (JGreedy(SolverOptions(backend="greedy", use_native=use_native,
                                  **kw)),
            GreedySolver(TSolverOptions(backend="greedy",
                                        use_native=use_native, **kw)))


def solve_both(jpods, tpods, jcat, tcat, use_native="auto", **kw):
    jg, tg = greedy_pair(use_native, **kw)
    jplan = jg.solve(JSolveRequest(jpods, jcat))
    tplan = tg.solve(SolveRequest(tpods, tcat))
    assert tplan.backend == jplan.backend
    assert_plans_equal(jplan, tplan)
    return jplan, tplan


def anti_window(pod_mod, req_mod, seed, apps=3, per_app=10):
    """A seeded mixed window plus ``apps`` apps of self-selecting hostname
    anti-affinity (a per-node cap of one) and zone-pinned pods."""
    pods = build_pods(mixed_specs(120, seed), pod_mod, req_mod)
    for a in range(apps):
        app = f"web{a}"
        term = pod_mod.PodAffinityTerm((("app", app),),
                                       pod_mod.HOSTNAME_TOPOLOGY_KEY,
                                       anti=True)
        pods += [pod_mod.PodSpec(
            f"{app}-{i}", requests=pod_mod.ResourceRequests(500, 1024, 0, 1),
            labels=(("app", app),), affinity=(term,),
            node_selector=((req_mod.LABEL_ZONE, f"us-south-{a % 3 + 1}"),))
            for i in range(per_app)]
    return pods


def zone_affinity_window(pod_mod, req_mod, seed):
    pods = build_pods(mixed_specs(80, seed), pod_mod, req_mod)
    for a in range(2):
        app = f"za{a}"
        pods += [pod_mod.PodSpec(
            f"{app}-{i}", requests=pod_mod.ResourceRequests(1000, 2048, 0, 1),
            labels=(("app", app),), affinity=(pod_mod.PodAffinityTerm(
                (("app", app),), req_mod.LABEL_ZONE),))
            for i in range(12)]
    return pods


@pytest.mark.parametrize("seed", [0, 1, 2, 9])
@pytest.mark.parametrize("use_native", ["auto", "off"])
def test_seeded_mixed_windows_match_reference(jcatalog, tcatalog, seed,
                                              use_native):
    jpods, tpods = both(mixed_specs(300, seed))
    jplan, tplan = solve_both(jpods, tpods, jcatalog, tcatalog, use_native)
    assert tplan.backend == ("greedy-native" if use_native == "auto"
                             else "greedy")
    assert validate_plan(tplan, tpods, tcatalog) == []
    assert tplan.unplaced_pods == []


@pytest.mark.parametrize("use_native", ["auto", "off"])
def test_zone_selectors_and_anti_affinity_caps(jcatalog, tcatalog,
                                               use_native):
    jpods = anti_window(j_pod, j_req, 4)
    tpods = anti_window(t_pod, t_req, 4)
    prob = t_encode(tpods, tcatalog)
    assert (prob.group_cap == 1).sum() == 3
    _, tplan = solve_both(jpods, tpods, jcatalog, tcatalog, use_native)
    assert validate_plan(tplan, tpods, tcatalog) == []
    for n in tplan.nodes:
        for a in range(3):
            assert sum(p.startswith(f"web{a}-") for p in n.pod_names) <= 1


@pytest.mark.parametrize("use_native", ["auto", "off"])
def test_unplaceable_pods(jcatalog, tcatalog, use_native):
    specs = mixed_specs(60, 2) + [(f"huge-{i}", 10 ** 7, 10 ** 8, None,
                                   None) for i in range(3)]
    jpods, tpods = both(specs)
    _, tplan = solve_both(jpods, tpods, jcatalog, tcatalog, use_native)
    assert sorted(tplan.unplaced_pods) == [f"default/huge-{i}"
                                           for i in range(3)]
    assert set(tplan.unplaced_reasons) == set(tplan.unplaced_pods)


def test_node_overflow_escalates_and_caps(jcatalog, tcatalog):
    """300 anti-affinity pods (one per node) against an estimate of
    ~2 x 300 / 1 nodes from a 64-node start: the native loop escalates;
    a budget of 100 nodes leaves the rest unplaced in both loops."""
    def pods(pod_mod):
        term = pod_mod.PodAffinityTerm((("app", "solo"),),
                                       pod_mod.HOSTNAME_TOPOLOGY_KEY,
                                       anti=True)
        return [pod_mod.PodSpec(
            f"solo-{i}", requests=pod_mod.ResourceRequests(250, 512, 0, 1),
            labels=(("app", "solo"),), affinity=(term,)) for i in range(300)]

    for use_native in ("auto", "off"):
        _, tplan = solve_both(pods(j_pod), pods(t_pod), jcatalog, tcatalog,
                              use_native)
        assert len(tplan.nodes) == 300
        _, capped = solve_both(pods(j_pod), pods(t_pod), jcatalog, tcatalog,
                               use_native, max_nodes=100)
        assert len(capped.nodes) == 100
        assert len(capped.unplaced_pods) == 200


def test_native_escalation_from_a_short_node_axis(tcatalog):
    """solve_per_pod_native starts at the demand estimate and escalates
    by x4 on overflow until every pod has a node."""
    prob = t_encode(build_pods(mixed_specs(400, 8), t_pod, t_req), tcatalog)
    grouped = native.ffd_solve(
        prob.group_req, prob.group_count, prob.group_cap, prob.compat,
        tcatalog.offering_alloc().astype(np.int32),
        tcatalog.offering_rank_price(), 8)
    assert grouped[3] == -1                        # 8 nodes overflow
    node_off, _, unplaced, n_open = solve_per_pod_native(prob)
    assert n_open > 8 and unplaced.sum() == 0


@pytest.mark.parametrize("seed", [6, 11])
def test_zone_candidates_solve_one_by_one(jcatalog, tcatalog, seed):
    jpods = zone_affinity_window(j_pod, j_req, seed)
    tpods = zone_affinity_window(t_pod, t_req, seed)
    for use_native in ("auto", "off"):
        _, tplan = solve_both(jpods, tpods, jcatalog, tcatalog, use_native)
        assert validate_plan(tplan, tpods, tcatalog) == []


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_native_path_equals_python_path(tcatalog, seed):
    pods = build_pods(mixed_specs(250, seed), t_pod, t_req)
    nat = GreedySolver(TSolverOptions(backend="greedy")).solve(
        SolveRequest(pods, tcatalog))
    py = GreedySolver(TSolverOptions(backend="greedy", use_native="off")
                      ).solve(SolveRequest(pods, tcatalog))
    assert (nat.backend, py.backend) == ("greedy-native", "greedy")
    assert node_view(nat) == node_view(py)
    assert nat.unplaced_pods == py.unplaced_pods
    assert nat.total_cost_per_hour == pytest.approx(py.total_cost_per_hour,
                                                    rel=1e-6)


@pytest.mark.parametrize("seed", [1, 4])
def test_per_pod_expansion_gives_the_grouped_plan(tcatalog, seed):
    pods = anti_window(t_pod, t_req, seed)
    prob = t_encode(pods, tcatalog)
    expanded = expand_per_pod(prob)
    assert len(expanded[0]) == len(pods) - len(prob.rejected)
    node_off, assign, unplaced, n_open = solve_per_pod_native(
        prob, expanded=expanded)
    g_off, g_assign, g_unp, g_open = native.ffd_solve(
        prob.group_req, prob.group_count, prob.group_cap, prob.compat,
        tcatalog.offering_alloc().astype(np.int32),
        tcatalog.offering_rank_price(), node_off.shape[0])
    assert n_open == g_open > 0
    np.testing.assert_array_equal(node_off, g_off)
    gid = expanded[4]
    regrouped = np.zeros_like(g_assign)
    np.add.at(regrouped, gid, assign)
    np.testing.assert_array_equal(regrouped, g_assign)
    per_group = np.zeros_like(g_unp)
    np.add.at(per_group, gid, unplaced)
    np.testing.assert_array_equal(per_group, g_unp)


@pytest.mark.parametrize("seed", [0, 5])
def test_ffd_host_equals_reference_native(jcatalog, tcatalog, seed):
    """The port's csrc/ffd_host.cpp against the reference's
    native/ffd.cpp on the same arrays, every output word, grouped and
    per pod (gid) at a node axis that fits and one that overflows."""
    pods = anti_window(j_pod, j_req, seed)
    prob = encode(pods, jcatalog)
    alloc = jcatalog.offering_alloc().astype(np.int32)
    rank = jcatalog.offering_rank_price()
    args = (prob.group_req, prob.group_count, prob.group_cap, prob.compat,
            alloc, rank)
    per_pod = j_expand(prob)
    for N in (16, 512):
        for a, gid in ((args, None), (per_pod[:4] + (alloc, rank),
                                      per_pod[4])):
            want = j_native.ffd_solve(*a, N, gid=gid)
            got = native.ffd_solve(*a, N, gid=gid)
            assert want is not None and got is not None
            assert got[3] == want[3]
            for x, y in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_card_solver_cost_at_most_greedy(tcatalog, seed):
    """The port's twin of the reference's test_parity_with_oracle_mixed:
    both plans validate and place every pod, and the solver's
    right-sized cost is at most the oracle's."""
    pods = build_pods(mixed_specs(300, seed), t_pod, t_req)
    greedy = GreedySolver().solve(SolveRequest(pods, tcatalog))
    plan = TorchSolver(device="cpu").solve(SolveRequest(pods, tcatalog))
    assert validate_plan(greedy, pods, tcatalog) == []
    assert validate_plan(plan, pods, tcatalog) == []
    assert len(plan.unplaced_pods) == len(greedy.unplaced_pods) == 0
    assert plan.total_cost_per_hour <= greedy.total_cost_per_hour + 1e-6


def test_make_solver_hands_out_the_oracle_only_when_asked(tcatalog,
                                                         monkeypatch):
    """``make_solver`` returns the oracle itself only for
    ``backend="greedy"``; otherwise the card's solver, wrapped in
    ``ResilientSolver`` as the reference's.  The card's solver never
    reaches the oracle: a failed kernel raises out of it, and only the
    wrapper degrades the solve (counted, tagged ``degraded:``)."""
    wrapped = make_solver(TSolverOptions(), device="cpu")
    solver = wrapped.primary
    assert isinstance(solver, TorchSolver)
    assert not isinstance(wrapped, GreedySolver)
    oracle = make_solver(TSolverOptions(backend="greedy"), device="cpu")
    assert isinstance(oracle, GreedySolver)

    def broken(self, prep):
        raise RuntimeError("kernel fault")

    def never(*a, **k):
        raise AssertionError("the oracle was reached")

    monkeypatch.setattr(TorchSolver, "dispatch_packed", broken)
    for name in ("solve_encoded", "_solve_python", "_solve_native"):
        monkeypatch.setattr(GreedySolver, name, never)
    monkeypatch.setattr(native, "ffd_solve", never)
    pods = build_pods(mixed_specs(40, 3), t_pod, t_req)
    with pytest.raises(RuntimeError, match="kernel fault"):
        solver.solve(SolveRequest(pods, tcatalog))
    monkeypatch.undo()
    monkeypatch.setattr(TorchSolver, "dispatch_packed", broken)
    plan = wrapped.solve(SolveRequest(pods, tcatalog))
    assert plan.backend.startswith("degraded:greedy")


def test_native_build_race_and_missing_toolchain(tmp_path, monkeypatch,
                                                 tcatalog):
    """Builds racing on one library name each land whole (a file of
    their own, then ``os.replace``); without a compiler ``load()`` is
    None and the oracle takes its python loop, with the same plan."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    out = native.library_path()
    assert out.parent == tmp_path
    errors = []

    def build():
        try:
            native._build(out)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    assert [p.name for p in tmp_path.iterdir()] == [out.name]

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "empty")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.load() is None
    pods = build_pods(mixed_specs(80, 2), t_pod, t_req)
    plan = GreedySolver().solve(SolveRequest(pods, tcatalog))
    assert plan.backend == "greedy"
    py = GreedySolver(TSolverOptions(use_native="off")).solve(
        SolveRequest(pods, tcatalog))
    assert node_view(plan) == node_view(py)
