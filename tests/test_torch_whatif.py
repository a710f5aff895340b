"""The what-if plane of the port against the reference's.

One seeded window (``bench.build_workload`` and the port's copy, the same
seed) is lowered by both packages to the same packed baseline; a menu of
arrival waves, spot storm, zone blackout and quota clamp (the menu of
``bench.run_whatif``) is lowered to the same stacked deltas.  The port's
stacked solve must return the reference's ``solve_scenarios`` words,
every word and the float cost word included; the port's planner the
reference planner's words and outcomes on a baseline carried over from
the reference (``carry.baseline_from_numpy``); the port's numpy oracle
the reference oracle's words, and the device words up to the cost word.
``validate_whatif`` must come back clean and reject a garbage forecast;
a menu above ``max_k`` (and above ``WHATIF_MAX_K``) runs in chunks that
give the one-shot words; a stacked plan is one fleet-kernel call and one
cost-sum call.
"""

import numpy as np
import pytest
import torch

import bench
from karpenter_tpu.whatif import Scenario as JScenario
from karpenter_tpu.whatif import WhatIfPlanner as JWhatIfPlanner
from karpenter_tpu.whatif import build_baseline as j_build_baseline
from karpenter_tpu.whatif import kernels as j_kernels
from karpenter_tpu.whatif import oracle as j_oracle
from karpenter_tpu.whatif import scenario as j_scenario

from karpenter_tpu_torch import carry, workload
from karpenter_tpu_torch.solver import packed as t_packed
from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2
from karpenter_tpu_torch.whatif import (
    WHATIF_MAX_K, Scenario, WhatIfPlanner, build_baseline, validate_whatif,
)
from karpenter_tpu_torch.whatif import kernels as t_kernels
from karpenter_tpu_torch.whatif import oracle as t_oracle
from karpenter_tpu_torch.whatif import scenario as t_scenario


def build_menu(sc, scenario_cls, baseline, catalog, k, seed=5):
    """``bench.run_whatif``'s menu: a baseline scenario, then waves alone,
    with a spot storm, with a zone blackout, with a quota clamp."""
    rng = np.random.RandomState(seed)
    G = baseline.problem.num_groups
    menu = [scenario_cls("baseline")]
    storm = sc.spot_storm_mask(catalog)
    while len(menu) < k:
        i = len(menu)
        gis = rng.choice(G, size=min(8, G), replace=False)
        wave = sc.ArrivalWave(tuple(
            (int(g), int(rng.randint(1, 48))) for g in sorted(gis)))
        kind = i % 4
        if kind == 0:
            perts = (wave,)
        elif kind == 1:
            perts = (wave, storm)
        elif kind == 2:
            zone = catalog.zones[int(rng.randint(len(catalog.zones)))]
            perts = (wave, sc.zone_blackout_mask(catalog, zone))
        else:
            perts = (wave, sc.quota_clamp(baseline, int(rng.randint(2, 8))))
        menu.append(scenario_cls(f"s{i}", perts))
    return menu[:k]


@pytest.fixture(scope="module")
def windows():
    jpods, jcat = bench.build_workload(400, 40, seed=3)
    tpods, tcat = workload.build_workload(400, 40, seed=3)
    jb = j_build_baseline(jpods, jcat)
    tb = build_baseline(tpods, tcat)
    jmenu = build_menu(j_scenario, JScenario, jb, jcat, 9)
    tmenu = build_menu(t_scenario, Scenario, tb, tcat, 9)
    return jb, tb, jmenu, tmenu


@pytest.fixture(scope="module")
def jplan(windows):
    jb, _, jmenu, _ = windows
    return JWhatIfPlanner().plan(jb, jmenu)


def carried_baseline(jb):
    """The reference baseline as a port ``WhatIfBaseline``."""
    jp = jb.problem
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jb.catalog, f) for f in carry.CATALOG_FIELDS})
    tprob = carry.problem_from_numpy(
        tcat, group_req=jp.group_req, group_count=jp.group_count,
        group_cap=jp.group_cap, group_prio=jp.group_prio,
        group_gang=jp.group_gang, label_rows=jp.label_rows,
        label_idx=jp.label_idx,
        groups=[{"pod_names": g.pod_names, "pinned_zone": g.pinned_zone,
                 "cap_per_node": g.cap_per_node,
                 "requirements": [(r.key, r.operator.value, r.values)
                                  for r in g.requirements]}
                for g in jp.groups])
    return carry.baseline_from_numpy(tprob, packed=jb.packed, G_pad=jb.G_pad,
                                     O_pad=jb.O_pad, U_pad=jb.U_pad,
                                     pods=jb.pods)


def test_baseline_and_deltas_lower_as_reference(windows):
    jb, tb, jmenu, tmenu = windows
    assert (tb.G_pad, tb.O_pad, tb.U_pad) == (jb.G_pad, jb.O_pad, jb.U_pad)
    np.testing.assert_array_equal(tb.packed, jb.packed)
    js = j_scenario.lower_scenarios(jb, jmenu)
    ts = t_scenario.lower_scenarios(tb, tmenu)
    for name in ("didx", "dval", "counts", "caps"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    assert (ts.D, ts.delta_words) == (js.D, js.delta_words)
    # diff_words never names a word twice in a row: the scatter's order
    # cannot matter
    for row, n in zip(ts.didx, ts.delta_words):
        assert np.unique(row[:n]).size == n


@pytest.mark.parametrize("mode", ["dense", "coo"])
def test_stacked_solve_matches_reference_kernel(windows, jplan, mode):
    """The port's ``solve_scenarios`` on the CPU returns the reference's
    jitted ``solve_scenarios`` words, the cost word included."""
    jb, tb, jmenu, _ = windows
    stacked = j_scenario.lower_scenarios(jb, jmenu)
    N = jplan.N
    K_coo, coo16 = (jplan.K_coo, jplan.coo16) if mode == "coo" \
        else (0, False)
    cat = jb.catalog
    alloc = _pad2(cat.offering_alloc().astype(np.int32), jb.O_pad)
    price = _pad1(cat.off_price.astype(np.float32), jb.O_pad)
    rank = _pad1(cat.offering_rank_price(), jb.O_pad)
    kw = dict(G=jb.G_pad, O=jb.O_pad, U=jb.U_pad, N=N, compact=K_coo,
              coo16=coo16)
    ref = np.asarray(j_kernels.solve_scenarios(
        jb.packed.copy(), stacked.didx.copy(), stacked.dval.copy(),
        alloc, price, rank, **kw))
    got = t_kernels.solve_scenarios(
        *(torch.from_numpy(np.ascontiguousarray(a)) for a in (
            tb.packed, stacked.didx, stacked.dval, alloc, price, rank)),
        **kw).numpy()
    assert got.shape == ref.shape
    bad = np.nonzero(got != ref)
    assert bad[0].size == 0, (f"{bad[0].size} words differ, first at "
                              f"scenario {bad[0][0]} word {bad[1][0]}")


def test_planner_matches_reference_planner(windows, jplan):
    """Port planner on the port's own baseline and on one carried over
    from the reference: the reference planner's words and outcomes."""
    jb, tb, _, tmenu = windows
    for base in (tb, carried_baseline(jb)):
        tplan = WhatIfPlanner(device="cpu").plan(base, tmenu)
        assert (tplan.N, tplan.K_coo, tplan.coo16, tplan.dispatches) == \
            (jplan.N, jplan.K_coo, jplan.coo16, jplan.dispatches)
        np.testing.assert_array_equal(tplan.raw, jplan.raw)
        assert [o.to_dict() for o in tplan.outcomes] == \
            [o.to_dict() for o in jplan.outcomes]
        assert [o.offering_node_pods for o in tplan.outcomes] == \
            [o.offering_node_pods for o in jplan.outcomes]


def test_oracle_matches_reference_oracle_and_device(windows, jplan):
    jb, tb, jmenu, tmenu = windows
    js = j_scenario.lower_scenarios(jb, jmenu)
    ts = t_scenario.lower_scenarios(tb, tmenu)
    kw = dict(N=jplan.N, compact=jplan.K_coo, coo16=jplan.coo16)
    ref = j_oracle.solve_scenarios_np(jb, js, **kw)
    got = t_oracle.solve_scenarios_np(tb, ts, **kw)
    np.testing.assert_array_equal(got, ref)
    for k in range(ts.K):
        assert t_oracle.words_equal_except_cost(jplan.raw[k], got[k],
                                                tb.G_pad, jplan.N)
    host = WhatIfPlanner(device="cpu").plan_host(tb, tmenu)
    np.testing.assert_array_equal(host.raw, got)


def test_validate_clean_and_rejects_garbage(windows):
    _, tb, _, tmenu = windows
    planner = WhatIfPlanner(device="cpu")
    plan = planner.plan(tb, tmenu)
    assert validate_whatif(plan) == []
    assert validate_whatif(plan, use_device=False) == []
    assert validate_whatif(planner.plan_host(tb, tmenu)) == []
    garbage = Scenario("broken-forecast", (t_scenario.ArrivalWave(
        ((0, -10 ** 6),)),))
    bad = validate_whatif(planner.plan(tb, tmenu[:2] + [garbage]))
    assert len(bad) == 1 and "negative group count" in bad[0]
    # a plan whose words were tampered with fails the fresh-solve check
    plan.raw[1, 0] ^= 1
    bad = validate_whatif(plan, max_scenarios=2)
    assert len(bad) == 1 and "'s1'" in bad[0]


def test_stacked_plan_is_one_fleet_call_and_one_cost_sum(windows,
                                                         monkeypatch):
    _, tb, _, tmenu = windows
    calls = {"ffd_scan_fleet": 0, "cost_sum": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(t_packed, "ffd_scan_fleet",
                        counted("ffd_scan_fleet", t_packed.ffd_scan_fleet))
    monkeypatch.setattr(t_packed, "cost_sum",
                        counted("cost_sum", t_packed.cost_sum))
    plan = WhatIfPlanner(device="cpu").plan(tb, tmenu)
    assert plan.dispatches == 1
    assert calls == {"ffd_scan_fleet": 1, "cost_sum": 1}


def test_chunks_above_max_k_give_the_one_shot_words(windows):
    _, tb, _, tmenu = windows
    one = WhatIfPlanner(device="cpu").plan(tb, tmenu)
    planner = WhatIfPlanner(max_k=4, device="cpu")
    chunked = planner.plan(tb, tmenu)
    assert (chunked.dispatches, planner.chunked_plans) == (3, 1)
    np.testing.assert_array_equal(chunked.raw, one.raw)


def test_default_max_k_chunks_a_larger_menu():
    """Above ``WHATIF_MAX_K`` scenarios the default planner chunks too
    (a small window keeps the 2 x 128-row solve cheap on the CPU)."""
    pods, cat = workload.build_workload(40, 10, seed=1)
    base = build_baseline(pods, cat)
    menu = build_menu(t_scenario, Scenario, base, cat, WHATIF_MAX_K + 1)
    planner = WhatIfPlanner(device="cpu")
    assert planner.max_k == WHATIF_MAX_K == 128
    plan = planner.plan(base, menu)
    assert plan.dispatches == 2
    assert validate_whatif(plan, max_scenarios=4) == []
    one = WhatIfPlanner(max_k=2 * WHATIF_MAX_K, device="cpu").plan(base,
                                                                  menu)
    assert one.dispatches == 1
    np.testing.assert_array_equal(plan.raw, one.raw)


def test_default_planner_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WhatIfPlanner()
