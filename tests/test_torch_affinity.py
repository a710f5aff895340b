"""The port's affinity route, decode choke and validator against the reference.

The reference bench's parity windows (``_affinity_bench_pods`` over
seeds 190..197) go through the reference's ``solve_packed_affinity`` and
the port's on the CPU: the affinity leaf must be equal, the packed
result word for word (the float cost word included), and both
must equal the numpy oracle ``affinity/greedy.solve_affinity_host``.
The decode choke (``affinity/enforce.py``) is held against the
reference's on its own cases — anti conflict, the required fixpoint, the
spread clamp, the gang exemption — and the validator on the gang
exemption.  ``TorchSolver`` must route device-armed windows to the
affinity scan and windows over the class budget to the FFD route plus
the choke, giving ``JaxSolver``'s plans either way; a failed affinity
scan raises rather than re-running the window unconstrained.
"""

import numpy as np
import pytest
import torch

import bench
import karpenter_tpu.apis.pod as j_pod
from karpenter_tpu.affinity import MAX_SELECTOR_CLASSES
from karpenter_tpu.affinity.encode import pack_affinity
from karpenter_tpu.affinity.enforce import enforce_affinity
from karpenter_tpu.affinity.greedy import solve_affinity_host
from karpenter_tpu.affinity.kernel import solve_packed_affinity
from karpenter_tpu.affinity.validate import validate_affinity_plan
from karpenter_tpu.apis.podgroup import PodGroup as JPodGroup
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.jax_backend import unpack_reason_words, unpack_result
from karpenter_tpu.solver.types import Plan, PlannedNode

import karpenter_tpu_torch.affinity as t_aff
import karpenter_tpu_torch.apis.pod as t_pod
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.affinity import encode as t_aff_encode
from karpenter_tpu_torch.affinity import enforce as t_enforce
from karpenter_tpu_torch.affinity import kernel as t_kernel
from karpenter_tpu_torch.affinity import validate as t_validate
from karpenter_tpu_torch.apis.podgroup import PodGroup as TPodGroup
from karpenter_tpu_torch.solver import (
    SolveRequest, TorchSolver, validate_plan,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver import torch_backend
from karpenter_tpu_torch.solver.types import (
    Plan as TPlan, PlannedNode as TPlannedNode,
)

from tests.test_torch_packed import assert_words_equal
from tests.test_torch_solver import assert_plans_equal


def _view(p):
    return (p.name, p.namespace, p.requests.as_tuple(), p.labels,
            tuple((t.label_selector, t.topology_key, t.anti)
                  for t in p.affinity),
            tuple((c.max_skew, c.topology_key, c.when_unsatisfiable,
                   c.label_selector) for c in p.topology_spread),
            None if p.gang is None else (p.gang.name, p.gang.min_member))


@pytest.fixture(scope="module")
def catalogs():
    return bench.build_catalog(60), workload.build_catalog(60)


def _bench_windows(catalogs, seed, n=300, **kw):
    jcat, tcat = catalogs
    menu = dict(services=4, spread_sets=2) if n <= 300 else {}
    menu.update(kw)
    jpods = bench._affinity_bench_pods(
        f"ap{seed}", n, np.random.RandomState(190 + seed), **menu)
    tpods = workload.affinity_bench_pods(
        f"ap{seed}", n, np.random.RandomState(190 + seed), **menu)
    return jpods, tpods, encode(jpods, jcat), t_encode(tpods, tcat)


def test_workload_matches_bench(catalogs):
    for n, rng_seed in ((300, 190), (2000, 19)):
        jpods = bench._affinity_bench_pods("aff", n,
                                           np.random.RandomState(rng_seed))
        tpods = workload.affinity_bench_pods(
            "aff", n, np.random.RandomState(rng_seed))
        assert [_view(p) for p in tpods] == [_view(p) for p in jpods]


def _reference_run(problem):
    solver = JaxSolver(SolverOptions(use_pallas="off"))
    prep = solver._prepare(problem)
    off = solver._device_offerings(problem.catalog, prep.O_pad)
    out = np.asarray(solve_packed_affinity(
        prep.packed.copy(), prep.aff.copy(), *off, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, right_size=True))
    return prep, out


def _port_run(problem):
    solver = TorchSolver(device="cpu")
    prep = solver._prepare(problem)
    off = solver.device_offerings(problem.catalog, prep.O_pad)
    out = t_kernel.solve_packed_affinity(
        torch.from_numpy(prep.packed), torch.from_numpy(prep.aff), *off,
        G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
        right_size=True).numpy()
    return prep, out


@pytest.mark.parametrize("seed", range(8))
def test_scan_matches_reference_and_oracle(catalogs, seed):
    _, _, jprob, tprob = _bench_windows(catalogs, seed)
    assert tprob.aff is not None and tprob.aff.device_armed
    jprep, ref = _reference_run(jprob)
    tprep, got = _port_run(tprob)
    np.testing.assert_array_equal(tprep.packed, jprep.packed)
    np.testing.assert_array_equal(tprep.aff, jprep.aff)
    G, N = jprep.G_pad, jprep.N
    assert tprep.N == N
    assert_words_equal(ref, got, G, N)
    g = jprob.num_groups
    node_off, assign, unplaced, _ = unpack_result(got, G, N, 0)
    words = unpack_reason_words(got, G, N, 0)
    h_off, h_assign, h_unp, _hc, h_words = solve_affinity_host(
        jprob, N, right_size=True)
    np.testing.assert_array_equal(node_off, h_off)
    np.testing.assert_array_equal(assign[:g], h_assign)
    np.testing.assert_array_equal(unplaced[:g], h_unp)
    np.testing.assert_array_equal(words[:g], h_words)


def test_pack_affinity_matches(catalogs):
    _, _, jprob, tprob = _bench_windows(catalogs, 2)
    for G_pad in (jprob.num_groups, 64):
        np.testing.assert_array_equal(
            t_aff_encode.pack_affinity(tprob.aff, G_pad),
            pack_affinity(jprob.aff, G_pad))
    cols = t_aff_encode.unpack_affinity(
        t_aff_encode.pack_affinity(tprob.aff, 64), 64)
    G = tprob.num_groups
    for col, want in zip(cols, (tprob.aff.g_sel, tprob.aff.g_anti,
                                tprob.aff.g_req, tprob.aff.aff_flag,
                                tprob.aff.spread_flag)):
        np.testing.assert_array_equal(col[:G], want)
    np.testing.assert_array_equal(cols[5], tprob.aff.bounds)


@pytest.mark.parametrize("seed", [0, 5])
def test_solver_matches_jax(catalogs, seed):
    jcat, tcat = catalogs
    jpods, tpods, _, _ = _bench_windows(catalogs, seed)
    jplan = JaxSolver(SolverOptions(use_pallas="off")).solve(
        JSolveRequest(jpods, jcat))
    ts = TorchSolver(device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert ts.last_stats["path"] == "affinity-cpu"
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []
    assert t_validate.validate_affinity_plan(tplan, tpods) == []


def _overflow_pods(mod, classes):
    """A window past the device lane's class budget: ``classes`` - 1
    big pods each with an anti term toward a big pod of its own, and one
    anti pair of small pods (c against the two o pods) that fit together
    in the slack the big pods' nodes leave.  The encode keeps every edge
    but disarms the device lane, so the FFD route co-locates the pair
    and the decode choke must undo it."""
    big = mod.ResourceRequests(3000, 6144, 0, 1)
    pods = []
    for i in range(classes - 1):
        pods.append(mod.PodSpec(
            f"g{i}", requests=big, labels=(("carrier", f"{i}"),),
            affinity=(mod.PodAffinityTerm(
                label_selector=(("target", f"{i}"),), anti=True),)))
        pods.append(mod.PodSpec(f"m{i}", requests=big,
                                labels=(("target", f"{i}"),)))
    small = mod.ResourceRequests(100, 256, 0, 1)
    pods.append(mod.PodSpec(
        "c", requests=small, labels=(("pair", "c"),),
        affinity=(mod.PodAffinityTerm(label_selector=(("pair", "o"),),
                                      anti=True),)))
    pods += [mod.PodSpec(f"o{k}", requests=small, labels=(("pair", "o"),))
             for k in range(2)]
    return pods


def test_over_budget_window_takes_ffd_route_and_choke(catalogs):
    jcat, tcat = catalogs
    n = MAX_SELECTOR_CLASSES + 2
    jpods, tpods = _overflow_pods(j_pod, n), _overflow_pods(t_pod, n)
    tprob = t_encode(tpods, tcat)
    assert tprob.aff is not None and not tprob.aff.device_armed
    js = JaxSolver(SolverOptions(use_pallas="off"))
    jplan = js.solve(JSolveRequest(jpods, jcat))
    assert js.last_stats["path"] == "scan"
    ts = TorchSolver(device="cpu")
    tplan = ts.solve(SolveRequest(tpods, tcat))
    assert ts.last_stats["path"] == "ffd-reference"
    assert_plans_equal(jplan, tplan)
    # the choke dropped what the unconstrained scan co-located
    assert "affinity_unsatisfied" in set(tplan.unplaced_reasons.values())
    assert t_validate.validate_affinity_plan(tplan, tpods) == []
    assert validate_plan(tplan, tpods, tcat) == []


def test_scan_failure_is_not_caught(catalogs, monkeypatch):
    """The reference degrades a failed affinity scan to the
    unconstrained one; the port raises instead."""
    def boom(*a, **k):
        raise RuntimeError("injected affinity scan fault")

    monkeypatch.setattr(torch_backend, "solve_packed_affinity", boom)
    _, tpods, _, _ = _bench_windows(catalogs, 1)
    with pytest.raises(RuntimeError, match="injected"):
        TorchSolver(device="cpu").solve(SolveRequest(tpods, catalogs[1]))


# -- the decode choke ---------------------------------------------------------


def _term(mod, sel, anti=False):
    return mod.PodAffinityTerm(label_selector=sel,
                               topology_key=mod.HOSTNAME_TOPOLOGY_KEY,
                               anti=anti)


def _spread(mod, skew, sel):
    return mod.TopologySpreadConstraint(
        max_skew=skew, topology_key=mod.HOSTNAME_TOPOLOGY_KEY,
        label_selector=sel)


def _choke_case(mod, case):
    """(pods, entries) of the reference's choke tests: entries are
    (pod name, count) on node 0, and node_off is [0, -1]."""
    if case == "anti_conflict":
        return [mod.PodSpec("left", labels=(("anti", "l"),),
                            affinity=(_term(mod, (("anti", "r"),), True),)),
                mod.PodSpec("right", labels=(("anti", "r"),))], \
            [("left", 1), ("right", 1)]
    if case == "required_fixpoint":
        return [mod.PodSpec("fol1", labels=(("role", "mid"),),
                            affinity=(_term(mod, (("role", "anchor"),)),)),
                mod.PodSpec("fol2", labels=(("role", "leaf"),),
                            affinity=(_term(mod, (("role", "mid"),)),)),
                mod.PodSpec("anchor", labels=(("role", "anchor"),))], \
            [("fol1", 1), ("fol2", 1)]
    sel = (("tier", "web"),)
    if case == "spread_clamp":
        return [mod.PodSpec("w1", labels=sel,
                            topology_spread=(_spread(mod, 2, sel),)),
                mod.PodSpec("w2", namespace="other", labels=sel)], \
            [("w1", 2), ("w2", 2)]
    group = JPodGroup if mod is j_pod else TPodGroup
    return [mod.PodSpec("gmem", labels=sel,
                        topology_spread=(_spread(mod, 1, sel),),
                        gang=group(name="gg", min_member=1)),
            mod.PodSpec("plain", labels=sel,
                        topology_spread=(_spread(mod, 1, sel),))], \
        [("gmem", 3), ("plain", 1)]


@pytest.mark.parametrize("case", ["anti_conflict", "required_fixpoint",
                                  "spread_clamp", "gang_exemption"])
def test_choke_matches_reference(catalogs, case):
    jcat, tcat = catalogs
    out = []
    for mod, enc, cat, choke in ((j_pod, encode, jcat, enforce_affinity),
                                 (t_pod, t_encode, tcat,
                                  t_enforce.enforce_affinity)):
        pods, entries = _choke_case(mod, case)
        problem = enc(pods, cat)
        assert problem.aff is not None
        gi = {problem.groups[i].representative.name: i
              for i in range(problem.num_groups)}
        node_off = np.array([0, -1], dtype=np.int32)
        gis = np.array([gi[n] for n, _ in entries], dtype=np.int32)
        cnts = np.array([c for _, c in entries], dtype=np.int32)
        out.append(choke(problem, node_off, gis, np.zeros_like(gis), cnts,
                         float(cat.off_price[0])))
    (j_off, j_gis, j_ns, j_cnts, j_drop, j_cost), \
        (t_off, t_gis, t_ns, t_cnts, t_drop, t_cost) = out
    for a, b in ((j_off, t_off), (j_gis, t_gis), (j_ns, t_ns),
                 (j_cnts, t_cnts)):
        np.testing.assert_array_equal(a, b)
    assert t_cost == j_cost
    assert t_drop is not None
    np.testing.assert_array_equal(t_drop[0], j_drop[0])
    np.testing.assert_array_equal(t_drop[1], j_drop[1])
    if case == "required_fixpoint":
        assert t_off[0] == -1 and t_gis.size == 0   # emptied node closed
    if case == "gang_exemption":
        assert dict(zip(t_gis.tolist(), t_cnts.tolist()))[t_gis[0]] == 3


def test_validator_mirrors_gang_exemption():
    sel = (("app", "x"),)

    def plan(P, PN):
        return P(nodes=[PN(instance_type="bx2-2x8", zone="us-south-1",
                           capacity_type="on-demand", price=1.0,
                           pod_names=["default/g1", "default/p1"])])

    for mod, group, P, PN, check in (
            (j_pod, JPodGroup, Plan, PlannedNode, validate_affinity_plan),
            (t_pod, TPodGroup, TPlan, TPlannedNode,
             t_validate.validate_affinity_plan)):
        gang_pod = mod.PodSpec("g1", labels=sel,
                               topology_spread=(_spread(mod, 1, sel),),
                               gang=group(name="gg", min_member=1))
        plain = mod.PodSpec("g1", labels=sel,
                            topology_spread=(_spread(mod, 1, sel),))
        other = mod.PodSpec("p1", labels=sel)
        assert check(plan(P, PN), [gang_pod, other]) == []
        errs = check(plan(P, PN), [plain, other])
        assert errs and "spread bound" in errs[0]


def test_constants_match():
    from karpenter_tpu import affinity as j_aff

    assert (t_aff.MAX_SELECTOR_CLASSES, t_aff.C_PAD, t_aff.AFF_BIG) == \
        (j_aff.MAX_SELECTOR_CLASSES, j_aff.C_PAD, j_aff.AFF_BIG)


@pytest.mark.slow
def test_full_size_window_matches_reference():
    """10k pods x 500 types, RandomState(19): the window chip_smoke.py
    solves."""
    jprob = encode(bench._affinity_bench_pods(
        "aff", 10_000, np.random.RandomState(19)), bench.build_catalog(500))
    tprob = t_encode(workload.affinity_bench_pods(
        "aff", 10_000, np.random.RandomState(19)),
        workload.build_catalog(500))
    jprep, ref = _reference_run(jprob)
    tprep, got = _port_run(tprob)
    assert tprep.N == jprep.N
    assert_words_equal(ref, got, jprep.G_pad, jprep.N)
