"""Soft preferences below the flat regime: the port against the reference.

``solve_packed_pref_torch`` must return the words of the reference's
``solve_packed_pref`` (the scan with a rank row per group, and the
presence-averaged penalty right-size) on the same packed buffer and
preference leaf, the cost word included.  The windows mix two
preference terms per pod (capacity type at weight 100, zone at weight
50), so groups carry fractional misses (1/3, 2/3) and nodes hold several
such groups, at two shapes: (G=128, N=64) and (G=32, N=512), the shapes
queue 3 of the ROADMAP named for the flat program's rank sum, cut to the
bucket ladders.  The plain scan with a [G, O] rank
must equal ``solve_core``'s pref scan, and ``TorchSolver``'s plans must
equal ``JaxSolver``'s on the scenarios of tests/test_soft_constraints.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import karpenter_tpu.apis.nodeclaim as j_nodeclaim
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
from karpenter_tpu.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
)
from karpenter_tpu.cloud.fake import FakeCloud, generate_profiles
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.jax_backend import (
    _pad1, _pad2, pack_input, solve_core, solve_packed_pref,
)
from karpenter_tpu.solver.types import (
    GROUP_BUCKETS, LABELROW_BUCKETS, OFFERING_BUCKETS, bucket,
)

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch import carry
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
    validate_plan,
)
from karpenter_tpu_torch.solver import ffd_kernel, torch_backend
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.solver.torch_backend import (
    PREF_BUCKETS, pad_preferences,
)
from tests.test_torch_packed import assert_words_equal
from tests.test_torch_solver import assert_plans_equal

SIZES = ((250, 512), (500, 1024), (1000, 2048), (2000, 8192), (4000, 16384),
         (300, 768), (750, 1536), (1500, 3072))


def make_catalog(types):
    cloud = FakeCloud(profiles=generate_profiles(types)) if types \
        else FakeCloud()
    pricing = PricingProvider(cloud)
    arrays = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return arrays


@pytest.fixture(scope="module")
def catalogs():
    """(types or None for the default) -> (reference, port) catalogs."""
    out = {}
    for types in (None, 12):
        j = make_catalog(types)
        out[types] = (j, carry.catalog_from_numpy(
            **{f: getattr(j, f) for f in carry.CATALOG_FIELDS}))
    return out


def pref_specs(n, seed, distinct):
    """Seeded pods: ``distinct`` request sizes, each pod with a capacity
    type term (weight 100) and a zone term (weight 50), either or both."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        cpu, mem = SIZES[rng.randint(distinct)]
        terms = []
        r = rng.rand()
        if r < 0.75:
            terms.append((100, "ct", ("spot", "on-demand")[rng.randint(2)]))
        if r > 0.25:
            terms.append((50, "zone", f"us-south-{rng.randint(3) + 1}"))
        out.append((f"pf{seed}-{i}", cpu, mem, tuple(terms)))
    return out


def build_pods(specs, pod_mod, req_mod):
    keys = {"ct": req_mod.LABEL_CAPACITY_TYPE, "zone": req_mod.LABEL_ZONE}
    return [pod_mod.PodSpec(
        name, requests=pod_mod.ResourceRequests(cpu, mem, 0, 1),
        preferred_requirements=tuple(
            (w, req_mod.Requirement(keys[k], req_mod.Operator.IN, (v,)))
            for w, k, v in terms))
        for name, cpu, mem, terms in specs]


def pref_window(catalog, pods, N):
    """The reference's packed buffer, preference leaf and catalog tensors
    of a window, padded as ``JaxSolver._prepare`` pads them."""
    problem = encode(pods, catalog)
    assert problem.pref_rows is not None
    G = bucket(problem.num_groups, GROUP_BUCKETS)
    O = bucket(catalog.num_offerings, OFFERING_BUCKETS)
    rows, label_idx = problem.label_rows, problem.label_idx
    U = bucket(max(rows.shape[0], 1), LABELROW_BUCKETS)
    packed = pack_input(_pad2(problem.group_req, G),
                        _pad1(problem.group_count, G),
                        _pad1(problem.group_cap, G),
                        _pad1(label_idx, G), _pad2(rows, U, O),
                        group_prio=_pad1(problem.group_prio, G))
    pref_rows, pref_idx = pad_preferences(problem.pref_rows,
                                          problem.pref_idx, G, O)
    cat = (_pad2(catalog.offering_alloc().astype(np.int32), O),
           _pad1(catalog.off_price.astype(np.float32), O),
           _pad1(catalog.offering_rank_price(), O))
    return dict(packed=packed, pref_rows=pref_rows, pref_idx=pref_idx,
                cat=cat, G=G, O=O, U=U, N=N, problem=problem)


def both_programs(w, lam_bp, right_size=True):
    G, O, U, N = w["G"], w["O"], w["U"], w["N"]
    P = w["pref_rows"].shape[0]
    ref = np.asarray(solve_packed_pref(
        w["packed"].copy(), w["pref_rows"], w["pref_idx"], *w["cat"], G=G,
        O=O, U=U, N=N, P=P, right_size=right_size, lam_bp=lam_bp))
    t = torch.from_numpy
    got = tp.solve_packed_pref_torch(
        t(w["packed"].copy()), t(w["pref_rows"]), t(w["pref_idx"]),
        *(t(x) for x in w["cat"]), G=G, O=O, U=U, N=N, P=P,
        right_size=right_size, lam_bp=lam_bp).numpy()
    return ref, got


def fractional_groups_per_node(w, out):
    """Max over open nodes of the groups placed there whose miss row is
    fractional somewhere (0 < miss < 1)."""
    G, N = w["G"], w["N"]
    assign = out[N + G + 1:N + G + 1 + G * N].reshape(G, N)
    idx = w["pref_idx"]
    rows = w["pref_rows"][np.clip(idx, 0, None)]
    frac = (idx >= 0) & ((rows > 0) & (rows < 1)).any(axis=1)
    return int(((assign > 0) & frac[:, None]).sum(axis=0).max())


# (pods, distinct sizes, N, types): G padded to 128 at N = 64 and to 32
# at N = 512
SHAPES = {"G128-N64": (900, 8, 64), "G32-N512": (150, 2, 512)}


def shape_window(catalog, shape, seed):
    n, distinct, N = SHAPES[shape]
    pods = build_pods(pref_specs(n, seed, distinct), j_pod, j_req)
    if seed % 2:
        pods.append(j_pod.PodSpec(f"huge{seed}", requests=j_pod.
                                  ResourceRequests(40_000_000, 8192, 0, 1)))
    return pref_window(catalog, pods, N)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("seed", range(8))
def test_pref_words_match_reference(catalogs, shape, seed):
    w = shape_window(catalogs[None][0], shape, seed)
    G, N = w["G"], w["N"]
    assert (G, N) == {"G128-N64": (128, 64), "G32-N512": (32, 512)}[shape]
    for lam_bp in (1500, 5000):
        ref, got = both_programs(w, lam_bp)
        assert_words_equal(ref, got, G, N)
    if seed % 2:
        assert got[N:N + G].sum() >= 1      # the huge pod: unplaced


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_windows_mix_fractional_groups_on_nodes(catalogs, shape):
    """The parity windows exercise the presence-averaged sum: in most
    seeds some node holds three or more groups with fractional misses."""
    t = torch.from_numpy
    mixed = 0
    for seed in range(8):
        w = shape_window(catalogs[None][0], shape, seed)
        got = tp.solve_packed_pref_torch(
            t(w["packed"]), t(w["pref_rows"]), t(w["pref_idx"]),
            *(t(x) for x in w["cat"]), G=w["G"], O=w["O"], U=w["U"],
            N=w["N"], P=w["pref_rows"].shape[0]).numpy()
        mixed += fractional_groups_per_node(w, got) >= 3
    assert mixed >= 4


def test_right_size_off_matches(catalogs):
    pods = build_pods(pref_specs(600, 11, 5), j_pod, j_req)
    w = pref_window(catalogs[None][0], pods, 256)
    ref, got = both_programs(w, 1500, right_size=False)
    assert_words_equal(ref, got, w["G"], 256)


@pytest.mark.parametrize("seed", range(4))
def test_plain_scan_with_group_rank_matches_solve_core(catalogs, seed):
    """``ffd_scan_reference`` with a [G, O] rank against ``solve_core``'s
    pref scan (right-size off), and the prologue's per-group argmin
    against each group's row used as a shared rank."""
    pods = build_pods(pref_specs(700, 20 + seed, 8), j_pod, j_req)
    w = pref_window(catalogs[None][0], pods, 128)
    p = w["problem"]
    G, O, N = w["G"], w["O"], w["N"]
    req, count, cap = (_pad2(p.group_req, G), _pad1(p.group_count, G),
                       _pad1(p.group_cap, G))
    compat = _pad2(p.compat, G, O)
    alloc, price, rank = w["cat"]
    ref = solve_core(*(jnp.asarray(x) for x in (req, count, cap, compat,
                                                 alloc, price, rank)),
                     num_nodes=N, right_size=False,
                     pref_rows=jnp.asarray(w["pref_rows"]),
                     pref_idx=jnp.asarray(w["pref_idx"]), pref_lambda=0.15)
    meta = np.zeros((G, 8), np.int32)
    meta[:, :4], meta[:, 4], meta[:, 5] = req, count, cap
    t = torch.from_numpy
    _, rank_g = tp.pref_rank_rows(t(w["pref_rows"]), t(w["pref_idx"]),
                                  t(rank), 0.15)
    assert torch.equal(rank_g[w["pref_idx"] < 0],
                       t(rank)[None].expand(G, O)[w["pref_idx"] < 0])
    got = ffd_kernel.ffd_scan_reference(
        t(meta)[None], t(compat.astype(np.int32))[None], t(alloc), rank_g, N)
    for r, g in zip(ref[:3], got):
        np.testing.assert_array_equal(np.asarray(r), g[0].numpy())
    offers = ffd_kernel.ffd_offers_reference(
        t(meta)[None], t(compat.astype(np.int32))[None], t(alloc)[None],
        rank_g[None])
    for g in range(0, G, 7):
        one = ffd_kernel.ffd_offers_reference(
            t(meta[g:g + 1])[None], t(compat[g:g + 1].astype(np.int32))[None],
            t(alloc)[None], rank_g[g][None])
        assert int(offers[1][0, g]) == int(one[1][0, 0])


def test_fleet_plain_scan_with_group_rank(catalogs):
    """[C, G, O] ranks: each problem equals its own scan."""
    ws = [pref_window(catalogs[None][0],
                      build_pods(pref_specs(400, s, 4), j_pod, j_req), 128)
          for s in (31, 32)]
    G = max(w["G"] for w in ws)
    t = torch.from_numpy
    metas, compats, ranks = [], [], []
    for w in ws:
        meta, compat_i, _ = tp.unpack_problem(
            t(w["packed"]), t(w["cat"][0]), w["G"], w["O"], w["U"])
        _, rank_g = tp.pref_rank_rows(t(w["pref_rows"]), t(w["pref_idx"]),
                                      t(w["cat"][2]), 0.15)
        metas.append(meta)
        compats.append(compat_i)
        ranks.append(rank_g)
    assert all(w["G"] == G for w in ws)
    alloc = t(ws[0]["cat"][0])
    together = ffd_kernel.ffd_scan_fleet_reference(
        torch.stack(metas), torch.stack(compats),
        alloc.expand(2, -1, -1), torch.stack(ranks), 128)
    for c in range(2):
        one = ffd_kernel.ffd_scan_reference(metas[c][None], compats[c][None],
                                            alloc, ranks[c], 128)
        for x, y in zip(together, one):
            assert torch.equal(x[c], y[0])


def test_presence_sum_plain_version_adds_in_group_order():
    """The plain version of the presence-sum kernel equals a numpy fold
    of the present groups' rows in group order, and the reference's
    ``einsum("gn,go->no")`` on these shapes."""
    from karpenter_tpu_torch.solver.presence_sum import (
        presence_sum, presence_sum_reference,
    )

    rng = np.random.RandomState(3)
    for G, N, O in ((32, 64, 128), (128, 64, 300), (64, 512, 1)):
        present = (rng.rand(G, N) < 0.3).astype(np.float32)
        miss = rng.choice(np.float32([0, 1 / 3, 2 / 3, 0.1, 1]),
                          size=(G, O))
        want = np.zeros((N, O), np.float32)
        for g in range(G):
            want = np.where(present[g][:, None] > 0, want + miss[g][None, :],
                            want)
        got = presence_sum(torch.from_numpy(present), torch.from_numpy(miss))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            presence_sum_reference(torch.from_numpy(present),
                                   torch.from_numpy(miss)).numpy(), want)
        ref = np.asarray(jnp.einsum("gn,go->no", present, miss,
                                    preferred_element_type=jnp.float32))
        np.testing.assert_array_equal(ref, want)
    with pytest.raises(ValueError, match="present"):
        presence_sum(torch.zeros((3, 4), dtype=torch.int32),
                     torch.zeros((3, 5)))
    with pytest.raises(ValueError, match="miss"):
        presence_sum(torch.zeros((3, 4)), torch.zeros((2, 5)))


def test_pad_preferences_buckets():
    rows = np.full((5, 7), 0.5, np.float32)
    idx = np.array([0, -1, 4], np.int32)
    prow, pidx = pad_preferences(rows, idx, 32, 128)
    assert prow.shape == (16, 128) and 16 in PREF_BUCKETS
    assert (prow[:5, :7] == 0.5).all() and not prow[5:].any()
    assert pidx.tolist()[:3] == [0, -1, 4] and (pidx[3:] == -1).all()


# -- plans through TorchSolver against JaxSolver -----------------------------


def pods_pref_zone(mod, req, n, zone, weight=100):
    return [mod.PodSpec(
        f"p{i}", requests=mod.ResourceRequests(500, 1024, 0, 1),
        preferred_requirements=((weight, req.Requirement(
            req.LABEL_ZONE, req.Operator.IN, (zone,))),))
        for i in range(n)]


def pods_weak_on_demand(mod, req):
    return [mod.PodSpec(
        f"p{i}", requests=mod.ResourceRequests(500, 1024, 0, 1),
        preferred_requirements=((50, req.Requirement(
            req.LABEL_CAPACITY_TYPE, req.Operator.IN, ("on-demand",))),))
        for i in range(20)]


def pods_schedule_anyway(mod, req):
    return [mod.PodSpec(
        f"s{i}", requests=mod.ResourceRequests(500, 1024, 0, 1),
        topology_spread=(mod.TopologySpreadConstraint(
            max_skew=1, when_unsatisfiable="ScheduleAnyway"),))
        for i in range(30)]


def scenario_pods(name, mod, req, catalog):
    if name == "zone_preference":
        return pods_pref_zone(mod, req, 40, catalog.zones[1])
    if name == "weak_on_demand":
        return pods_weak_on_demand(mod, req)
    return pods_schedule_anyway(mod, req)


@pytest.mark.parametrize("scenario", ["zone_preference", "weak_on_demand",
                                      "schedule_anyway"])
def test_soft_constraint_plans_match_jax(catalogs, scenario):
    jcat, tcat = catalogs[12]
    jpods = scenario_pods(scenario, j_pod, j_req, jcat)
    tpods = scenario_pods(scenario, t_pod, t_req, tcat)
    jplan = JaxSolver(SolverOptions(use_pallas="off")).solve(
        JSolveRequest(jpods, jcat))
    solver = TorchSolver(TSolverOptions(), device="cpu")
    tplan = solver.solve(SolveRequest(tpods, tcat))
    assert solver.last_stats["path"] == "pref-cpu"
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []
    if scenario == "zone_preference":
        assert all(n.zone == tcat.zones[1] for n in tplan.nodes)
    elif scenario == "weak_on_demand":
        assert all(n.capacity_type == "spot" for n in tplan.nodes)
    else:
        assert len({n.zone for n in tplan.nodes}) >= 2


@pytest.mark.parametrize("lam", [0.15, 0.5])
def test_mixed_window_plan_matches_jax(catalogs, lam):
    jcat, tcat = catalogs[None]
    specs = pref_specs(400, 3, 6)
    jplan = JaxSolver(SolverOptions(use_pallas="off", preference_lambda=lam)
                      ).solve_encoded(encode(build_pods(specs, j_pod, j_req),
                                             jcat))
    tpods = build_pods(specs, t_pod, t_req)
    solver = TorchSolver(TSolverOptions(preference_lambda=lam), device="cpu")
    tplan = solver.solve_encoded(torch_backend_encode(tpods, tcat))
    assert solver.last_stats["path"] == "pref-cpu"
    assert_plans_equal(jplan, tplan)
    assert validate_plan(tplan, tpods, tcat) == []


def torch_backend_encode(pods, catalog, nodepool=None):
    from karpenter_tpu_torch.solver import encode as t_encode

    return t_encode(pods, catalog, nodepool)


def test_stochastic_wins_over_affinity_and_preferences(catalogs):
    """A window that overcommits, arms the affinity lane and carries a
    preference takes the stochastic route, as in the reference."""
    jcat, tcat = catalogs[None]
    plans = {}
    for side, mod, req, nc, cat in (("j", j_pod, j_req, j_nodeclaim, jcat),
                                    ("t", t_pod, t_req, t_nodeclaim, tcat)):
        pods = build_pods(pref_specs(30, 5, 3), mod, req) + [
            mod.PodSpec("a", labels=(("app", "a"),)),
            mod.PodSpec("b", affinity=(mod.PodAffinityTerm(
                (("app", "a"),), mod.HOSTNAME_TOPOLOGY_KEY, anti=True),))]
        pool = nc.NodePool(name="oc", overcommit=0.1)
        plans[side] = (pods, cat, pool)
    tpods, _, tpool = plans["t"]
    problem = torch_backend_encode(tpods, tcat, tpool)
    assert problem.pref_rows is not None and problem.group_var is not None
    assert problem.aff is not None and problem.aff.device_armed
    solver = TorchSolver(TSolverOptions(), device="cpu")
    assert solver._prepare(problem).route == "stochastic"
    tplan = solver.solve(SolveRequest(tpods, tcat, tpool))
    assert solver.last_stats["path"] == "stochastic-cpu"
    jpods, _, jpool = plans["j"]
    jplan = JaxSolver(SolverOptions(use_pallas="off")).solve(
        JSolveRequest(jpods, jcat, jpool))
    assert_plans_equal(jplan, tplan)


def test_failing_pref_program_raises(catalogs, monkeypatch):
    """No fallback: a pref program that fails fails the solve; no plan of
    another route comes back."""
    _, tcat = catalogs[12]
    tpods = pods_pref_zone(t_pod, t_req, 20, tcat.zones[0])
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise RuntimeError("pref program failed")

    monkeypatch.setattr(torch_backend, "solve_packed_pref_torch", broken)
    solver = TorchSolver(TSolverOptions(), device="cpu")
    with pytest.raises(RuntimeError, match="pref program failed"):
        solver.solve(SolveRequest(tpods, tcat))
    assert calls and "path" not in solver.last_stats


def add_preferences(pods, req_mod):
    """chip_smoke.py's pref window: pod i prefers spot (weight 100) when
    i % 7 == 0 and zone us-south-{i % 3 + 1} (weight 50) when
    i % 11 == 0."""
    out = []
    for i, p in enumerate(pods):
        terms = []
        if i % 7 == 0:
            terms.append((100, req_mod.Requirement(
                req_mod.LABEL_CAPACITY_TYPE, req_mod.Operator.IN,
                ("spot",))))
        if i % 11 == 0:
            terms.append((50, req_mod.Requirement(
                req_mod.LABEL_ZONE, req_mod.Operator.IN,
                (f"us-south-{i % 3 + 1}",))))
        out.append(dataclasses.replace(p, preferred_requirements=tuple(
            terms)) if terms else p)
    return out


def test_with_preferences_matches_the_reference_window():
    """The port's ``workload.with_preferences`` (chip_smoke.py's pref
    window) encodes the preference leaf of ``add_preferences`` on the
    reference's pods."""
    import bench

    from karpenter_tpu_torch import workload

    jpods, jcat = bench.build_workload(400, 30, seed=42)
    tpods, tcat = workload.build_workload(400, 30, seed=42)
    jprob = encode(add_preferences(jpods, j_req), jcat)
    tprob = torch_backend_encode(workload.with_preferences(tpods), tcat)
    np.testing.assert_array_equal(jprob.pref_rows, tprob.pref_rows)
    np.testing.assert_array_equal(jprob.pref_idx, tprob.pref_idx)
    assert ((jprob.pref_rows > 0) & (jprob.pref_rows < 1)).any()


@pytest.mark.slow
def test_full_size_pref_window_matches_reference():
    """10k pods x 500 types: the pref window chip_smoke.py solves."""
    import bench

    pods, catalog = bench.build_workload(10_000, 500, seed=42)
    pods = add_preferences(pods, j_req)
    solver = JaxSolver(SolverOptions(use_pallas="off"))
    prep = solver._prepare(encode(pods, catalog))
    w = dict(packed=prep.packed, pref_rows=prep.pref_rows,
             pref_idx=prep.pref_idx, G=prep.G_pad, O=prep.O_pad,
             U=prep.U_pad, N=prep.N,
             cat=(_pad2(catalog.offering_alloc().astype(np.int32),
                        prep.O_pad),
                  _pad1(catalog.off_price.astype(np.float32), prep.O_pad),
                  _pad1(catalog.offering_rank_price(), prep.O_pad)))
    ref, got = both_programs(w, 1500)
    assert_words_equal(ref, got, prep.G_pad, prep.N)
    assert fractional_groups_per_node(w, got) >= 3
