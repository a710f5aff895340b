"""The sharded host route and the degraded wrappers of the sharded
service and the planes, against the reference's, on the CPU.

- the host route (``ShardedSolveService.solve_window_host``): windows
  with soft preferences, a stochastic pool or affinity, through the
  port's service and ``make_solver(SolverOptions(sharded=2))``, equal to
  the reference's service on a one-device shard mesh, with
  ``SHARDED_SOLVES{host}`` counted and the stacked state invalidated;
- ``ResilientShardedService``: a failed window (a raising service, an
  injected fault at the kick) degrades to the host route, a failed
  rebalance to ``rebalance_oracle``; the sharded serving loop's host
  failover at the kick and the fetch;
- ``ResilientGangPlanner``, the preemption ``ResilientPlanner``,
  ``ResilientRepacker`` and the what-if ``ResilientPlanner`` with a
  primary that raises or plans with a planted defect: the defect
  strings, the degraded plan, the ``ERRORS`` labels and counts and the
  backend tags as the reference's;
- on the card (a primary whose ``device`` is CUDA) every one of these
  wrappers raises the failure and degrades nothing: the port moves no
  window off the card;
- the package exports the reference's ``__init__`` files name.

Plans compare exactly (the greedy oracles' costs to 1e-9 relative).
"""

import dataclasses

import pytest
import torch

import karpenter_tpu.faulttol as jft
from karpenter_tpu.gang import ResilientGangPlanner as JResilientGang
from karpenter_tpu.gang import gang_plan_defects as j_gang_defects
from karpenter_tpu.gang.greedy import GreedyGangPlanner as JGreedyGang
from karpenter_tpu.preempt import PlannerOptions as JPlannerOptions
from karpenter_tpu.preempt.degraded import ResilientPlanner as JResilientPre
from karpenter_tpu.preempt.degraded import plan_defects as j_pre_defects
from karpenter_tpu.preempt.greedy import (
    GreedyPreemptionPlanner as JGreedyPreempt,
)
from karpenter_tpu.repack import encode_repack as j_encode_repack
from karpenter_tpu.repack.degraded import ResilientRepacker as JResilientRep
from karpenter_tpu.repack.degraded import (
    repack_plan_defects as j_repack_defects,
)
from karpenter_tpu.repack.greedy import GreedyRepacker as JGreedyRepacker
from karpenter_tpu.serving.service import (
    ShardedServingLoop as JShardedServingLoop,
)
from karpenter_tpu.sharded import ResilientShardedService as JResilientSvc
from karpenter_tpu.utils import metrics as j_metrics
from karpenter_tpu.whatif import ResilientPlanner as JResilientWhatIf
from karpenter_tpu.whatif import WhatIfPlanner as JWhatIfPlanner

import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
import karpenter_tpu_torch.faulttol as tft
from karpenter_tpu_torch import SolveRequest, SolverOptions, make_solver
from karpenter_tpu_torch.gang import (
    GangOptions, GangPlanner, GreedyGangPlanner, ResilientGangPlanner,
    gang_plan_defects,
)
from karpenter_tpu_torch.preempt import (
    GreedyPreemptionPlanner, PlannerOptions, PreemptionPlanner,
    ResilientPlanner,
)
from karpenter_tpu_torch.preempt.degraded import plan_defects
from karpenter_tpu_torch.repack import (
    GreedyRepacker, RepackOptions, RepackPlanner, ResilientRepacker,
    encode_repack, repack_plan_defects,
)
from karpenter_tpu_torch.serving.service import ShardedServingLoop
from karpenter_tpu_torch.sharded import (
    ResilientShardedService, ShardedSolveService, ShardedSolver,
)
from karpenter_tpu_torch.sharded.kernels import rebalance_oracle
from karpenter_tpu_torch.sharded.validate import rebalance_violations
from karpenter_tpu_torch.solver.degraded import (
    InvalidPlanError, breadcrumbs,
)
from karpenter_tpu_torch.utils import metrics as t_metrics
from karpenter_tpu_torch.whatif import ResilientPlanner as WhatIfResilient
from karpenter_tpu_torch.whatif import WhatIfPlanner
from tests import test_torch_gang as gang_t
from tests import test_torch_preempt as pre_t
from tests import test_torch_repack as rep_t
from tests.test_torch_degraded import (  # noqa: F401 (fixture)
    SiteInjector, _pristine_faulttol, errors, moved,
)
from tests.test_torch_pref import add_preferences
from tests.test_torch_sharded import (  # noqa: F401 (fixtures)
    catalogs, churn, j_service, reference_backlog_series, sharded_view,
)
from tests.test_torch_whatif import windows  # noqa: F401 (fixture)


def host_routed_windows(pod, nodeclaim, req):
    """(pods, nodepool) per host-routed kind, in one package's modules:
    soft preferences (chip_smoke.py's pref terms), a pool that
    overcommits, an anti-affinity pair."""
    base = [pod.PodSpec(f"h{i}", requests=pod.ResourceRequests(
        250 * (1 + i % 4), 512 * (1 + i % 3), 0, 1)) for i in range(24)]
    aff = base + [
        pod.PodSpec("a", labels=(("app", "a"),)),
        pod.PodSpec("b", affinity=(pod.PodAffinityTerm(
            (("app", "a"),), pod.HOSTNAME_TOPOLOGY_KEY, anti=True),))]
    return {"preferences": (add_preferences(base, req), None),
            "stochastic": (base, nodeclaim.NodePool(name="oc",
                                                    overcommit=0.1)),
            "affinity": (aff, None)}


def both_windows(route):
    import karpenter_tpu.apis.nodeclaim as j_nodeclaim
    import karpenter_tpu.apis.pod as j_pod
    import karpenter_tpu.apis.requirements as j_req

    return (host_routed_windows(j_pod, j_nodeclaim, j_req)[route],
            host_routed_windows(t_pod, t_nodeclaim, t_req)[route])


def solves(mod, label):
    return mod.SHARDED_SOLVES.get(label)


# -- the sharded host route ---------------------------------------------------

@pytest.mark.parametrize("route", ["preferences", "stochastic", "affinity"])
def test_host_route_matches_reference(catalogs, route):
    """The service's kick returns the finished host plan; the plans, the
    backend tag and ``SHARDED_SOLVES{host}`` as the reference's, through
    the service and through ``make_solver``; a stacked state from an
    earlier device window is dropped."""
    jcat, tcat = catalogs
    (jpods, jpool), (tpods, tpool) = both_windows(route)
    warm_j, warm_t = churn(5, rounds=2)
    jsvc, tsvc = j_service(2), ShardedSolveService(2, device="cpu")
    jsvc.solve_window(jcat, pods=warm_j[0])
    tsvc.solve_window(tcat, pods=warm_t[0])
    jh, th = solves(j_metrics, "host"), solves(t_metrics, "host")
    jplan = jsvc.solve_window(jcat, jpool, pods=jpods)
    tkick = tsvc._kick_window(tcat, tpool, pods=tpods)
    assert sharded_view(tkick) == sharded_view(jplan)
    assert tkick.backend == jplan.backend == "sharded-host"
    assert solves(t_metrics, "host") - th == \
        solves(j_metrics, "host") - jh == 1
    assert tsvc.invalidations == jsvc.invalidations == 1
    assert tsvc.snapshot_state() is None
    tsvc.solve_window(tcat, pods=warm_t[0])
    assert (tsvc.last_delta.mode, tsvc.last_delta.reason) == (
        "rebuild", "host-routed window")
    solver = make_solver(SolverOptions(sharded=2), device="cpu")
    plan = solver.solve(SolveRequest(tpods, tcat, tpool))
    assert plan.backend == "sharded-host"
    assert solver.last_stats["path"] == "sharded-host"
    merged = jplan.merged()
    assert [n.pod_names for n in plan.nodes] == \
        [n.pod_names for n in merged.nodes]
    assert plan.unplaced_pods == merged.unplaced_pods


def test_host_route_window_through_the_sharded_serving_loop(catalogs):
    jcat, tcat = catalogs
    (jpods, jpool), (tpods, tpool) = both_windows("stochastic")
    jloop = JShardedServingLoop(j_service(2), capacity=2)
    tloop = ShardedServingLoop(ShardedSolveService(2, device="cpu"),
                               capacity=2)
    jb = j_metrics.SERVING_WINDOWS.get("classic")
    tb = t_metrics.SERVING_WINDOWS.get("classic")
    jplan = jloop.submit(jcat, jpool, pods=jpods).result()
    tplan = tloop.submit(tcat, tpool, pods=tpods).result()
    assert sharded_view(tplan) == sharded_view(jplan)
    assert t_metrics.SERVING_WINDOWS.get("classic") - tb == \
        j_metrics.SERVING_WINDOWS.get("classic") - jb == 1
    assert tloop.stats()["kicks"] == jloop.stats()["kicks"] == 0


# -- ResilientShardedService --------------------------------------------------

@pytest.mark.parametrize("means", ["raising", "injected"])
def test_degraded_window_matches_reference(catalogs, means, monkeypatch):
    jcat, tcat = catalogs
    jstream, tstream = churn(14, rounds=2)
    jsvc = JResilientSvc(j_service(2))
    tsvc = ResilientShardedService(ShardedSolveService(2, device="cpu"))
    jsvc.solve_window(jcat, pods=jstream[0])
    tsvc.solve_window(tcat, pods=tstream[0])
    if means == "raising":
        def boom(*a, **k):
            raise RuntimeError("mesh died")

        monkeypatch.setattr(jsvc.primary, "solve_window", boom)
        monkeypatch.setattr(tsvc.primary, "solve_window", boom)
    jb, tb = errors(j_metrics, "sharded"), errors(t_metrics, "sharded")
    plans = []
    for ft, svc, cat, pods in ((jft, jsvc, jcat, jstream[1]),
                               (tft, tsvc, tcat, tstream[1])):
        if means == "injected":
            ft.install_injector(SiteInjector("sharded-solve"))
        plans.append(svc.solve_window(cat, pods=pods))
        ft.clear_injector()
    jplan, tplan = plans
    assert sharded_view(tplan) == sharded_view(jplan)
    assert tplan.backend == jplan.backend == "sharded-host"
    assert tsvc.degraded_windows == jsvc.degraded_windows == 1
    assert moved(tb, errors(t_metrics, "sharded")) == moved(
        jb, errors(j_metrics, "sharded")) == {"degraded_window": 1.0}
    assert tsvc.invalidations == jsvc.invalidations
    assert tsvc.snapshot_state() is None


def test_degraded_rebalance_matches_reference(catalogs, monkeypatch):
    from karpenter_tpu.sharded.router import (
        craft_hot_requests as j_craft,
    )
    import karpenter_tpu.apis.pod as j_pod

    jsvc = JResilientSvc(j_service(2))
    tsvc = ResilientShardedService(ShardedSolveService(2, device="cpu"))
    sizes = j_craft(2, 0, count=8)
    for mod, svc in ((j_pod, jsvc), (t_pod, tsvc)):
        svc.admit([mod.PodSpec(f"hot{i}-{k}", requests=mod.ResourceRequests(
            cpu, mem, 0, 1)) for i, (cpu, mem) in enumerate(sizes)
            for k in range(3)])

    def boom(*a, **k):
        raise RuntimeError("collective died")

    monkeypatch.setattr(jsvc.primary, "rebalance", boom)
    monkeypatch.setattr(tsvc.primary, "rebalance", boom)
    jb, tb = errors(j_metrics, "sharded"), errors(t_metrics, "sharded")
    jd, td = jsvc.rebalance(), tsvc.rebalance()
    assert (td.donor, td.receiver, td.amount, td.skew) == \
        (jd.donor, jd.receiver, jd.amount, jd.skew) == rebalance_oracle(
            td.pressure)
    assert td.skew > 0 and td.moved_keys == jd.moved_keys
    assert tsvc.degraded_rebalances == jsvc.degraded_rebalances == 1
    assert moved(tb, errors(t_metrics, "sharded")) == moved(
        jb, errors(j_metrics, "sharded")) == {"degraded_rebalance": 1.0}
    assert rebalance_violations(tsvc.primary, td) == []


def test_sharded_solver_degrades_inside_the_plane(catalogs):
    """Under ``make_solver`` a faulted sharded window degrades in the
    service (the host route), not at the solver layer."""
    _, tcat = catalogs
    _, tstream = churn(15, rounds=2)
    solver = make_solver(SolverOptions(sharded=2), device="cpu")
    assert type(solver.primary) is ShardedSolver
    assert type(solver.service) is ResilientShardedService
    solver.solve(SolveRequest(tstream[0], tcat))
    before = breadcrumbs()
    tft.install_injector(SiteInjector("sharded-fetch"))
    plan = solver.solve(SolveRequest(tstream[1], tcat))
    assert plan.backend == "sharded-host"
    assert solver.service.degraded_windows == 1
    assert moved(before, breadcrumbs()) == {
        "errors{sharded,degraded_window}": 1.0}


@pytest.mark.parametrize("site", ["sharded-solve", "sharded-fetch"])
def test_sharded_serving_failover_matches_reference(catalogs, site):
    jcat, tcat = catalogs
    jstream, tstream = churn(16, rounds=3)
    jloop = JShardedServingLoop(j_service(2), capacity=2)
    tloop = ShardedServingLoop(ShardedSolveService(2, device="cpu"),
                               capacity=2)
    jloop.submit(jcat, pods=jstream[0]).result()
    tloop.submit(tcat, pods=tstream[0]).result()
    jb = j_metrics.SERVING_WINDOWS.get("host_failover")
    tb = t_metrics.SERVING_WINDOWS.get("host_failover")
    plans = []
    for ft, loop, cat, pods in ((jft, jloop, jcat, jstream[2]),
                                (tft, tloop, tcat, tstream[2])):
        if site == "sharded-solve":
            ft.install_injector(SiteInjector(site))
            plans.append(loop.submit(cat, pods=pods).result())
        else:
            pend = loop.submit(cat, pods=pods)
            ft.install_injector(SiteInjector(site))
            plans.append(pend.result())
        ft.clear_injector()
    jplan, tplan = plans
    assert sharded_view(tplan) == sharded_view(jplan)
    assert tplan.backend == jplan.backend == "sharded-host"
    assert tloop.host_failovers == jloop.host_failovers == 1
    assert t_metrics.SERVING_WINDOWS.get("host_failover") - tb == \
        j_metrics.SERVING_WINDOWS.get("host_failover") - jb == 1
    assert tloop.stats()["inflight"] == 0
    tplan = tloop.submit(tcat, pods=tstream[1]).result()
    assert tplan.backend == "sharded"


def test_sharded_serving_failed_over_fetch_counts_as_reference(catalogs):
    """A fetch that faults over to the host route is counted as fetched
    (and overlapped) before the fetch, as the reference counts it: the
    loop's stats and the ``SERVING_OVERLAP`` sample equal the
    reference's, and so do the plans."""
    jcat, tcat = catalogs
    jstream, tstream = churn(17, rounds=3)
    jloop = JShardedServingLoop(j_service(2), capacity=2)
    tloop = ShardedServingLoop(ShardedSolveService(2, device="cpu"),
                               capacity=2)
    out = []
    for ft, loop, cat, stream, mod in (
            (jft, jloop, jcat, jstream, j_metrics),
            (tft, tloop, tcat, tstream, t_metrics)):
        first = loop.submit(cat, pods=stream[0])
        second = loop.submit(cat, pods=stream[1])
        ft.install_injector(SiteInjector("sharded-fetch"))
        plans = [first.result()]
        ft.clear_injector()
        plans.append(second.result())
        plans.append(loop.submit(cat, pods=stream[2]).result())
        out.append((plans, loop.stats(), mod.SERVING_OVERLAP.get()))
    (jplans, jstats, joverlap), (tplans, tstats, toverlap) = out
    assert [p.backend for p in jplans] == [p.backend for p in tplans] == [
        "sharded-host", "sharded", "sharded"]
    assert [sharded_view(p) for p in tplans] == \
        [sharded_view(p) for p in jplans]
    assert tstats == jstats
    assert (tstats["fetched"], tstats["overlapped"],
            tstats["host_failovers"]) == (3, 1, 1)
    assert toverlap == joverlap == tstats["overlap_fraction"]


# -- the planes' wrappers -----------------------------------------------------

class Boom:
    options = None

    def plan(self, *a, **k):
        raise RuntimeError("grid failed")


class Planting:
    """A primary whose plan is the oracle's with one defect planted."""

    def __init__(self, oracle, plant):
        self.oracle, self.plant = oracle, plant
        self.options = None

    def plan(self, *a, **k):
        plan = self.oracle.plan(*a, **k)
        self.plant(plan)
        return plan


def _degrade_both(jwrap, twrap, jargs, targs, component):
    jb, tb = errors(j_metrics, component), errors(t_metrics, component)
    jplan, tplan = jwrap.plan(*jargs), twrap.plan(*targs)
    return jplan, tplan, moved(jb, errors(j_metrics, component)), \
        moved(tb, errors(t_metrics, component))


def _plant_gang(plan):
    a = plan.nodes[0].assignments[0]
    plan.nodes[0].assignments[0] = dataclasses.replace(
        a, pod_names=a.pod_names[1:])


@pytest.mark.parametrize("means", ["raising", "invalid"])
def test_gang_wrapper_matches_reference(means):
    cats = gang_t.catalogs.__wrapped__()
    _, tpods, jprob = gang_t.window(cats, 3)
    tprob = gang_t.carried(jprob, cats[1])
    if means == "raising":
        jp, tp = Boom(), Boom()
    else:
        jp = Planting(JGreedyGang(), _plant_gang)
        tp = Planting(GreedyGangPlanner(), _plant_gang)
        assert gang_plan_defects(tp.plan(tprob), tprob) == \
            j_gang_defects(jp.plan(jprob), jprob) != []
    jplan, tplan, jm, tm = _degrade_both(
        JResilientGang(primary=jp), ResilientGangPlanner(primary=tp),
        (jprob,), (tprob,), "gang")
    kind = "degraded_backend_failure" if means == "raising" \
        else "degraded_invalid_plan"
    assert tm == jm == {kind: 1.0}
    assert tplan.backend == jplan.backend == "degraded:greedy"
    assert gang_t.fingerprint(tplan) == gang_t.fingerprint(jplan)
    clean = ResilientGangPlanner(GangPlanner(GangOptions(use_device="on"),
                                             device="cpu"))
    assert clean.plan(tprob).backend == "vector"


def _plant_preempt(plan):
    ev = plan.evictions[0]
    plan.evictions[0] = dataclasses.replace(
        ev, victim_priority=ev.beneficiary_priority)


@pytest.mark.parametrize("means", ["raising", "invalid"])
def test_preempt_wrapper_matches_reference(means):
    cats = pre_t.catalogs.__wrapped__()
    (_, _, jprob, jv, jcompat), _ = pre_t.window(cats, 5)
    tprob = pre_t.carried_problem(jprob, cats[1])
    tv = pre_t.carried_victims(jv)
    jopts = JPlannerOptions(max_evictions=180)
    topts = PlannerOptions(max_evictions=180)
    if means == "raising":
        jp, tp = Boom(), Boom()
    else:
        jp = Planting(JGreedyPreempt(jopts), _plant_preempt)
        tp = Planting(GreedyPreemptionPlanner(topts), _plant_preempt)
        assert plan_defects(tp.plan(tprob, tv, jcompat), tprob, tv) == \
            j_pre_defects(jp.plan(jprob, jv, jcompat), jprob, jv) != []
    jplan, tplan, jm, tm = _degrade_both(
        JResilientPre(primary=jp, options=jopts),
        ResilientPlanner(primary=tp, options=topts),
        (jprob, jv, jcompat), (tprob, tv, jcompat), "preempt")
    kind = "degraded_backend_failure" if means == "raising" \
        else "degraded_invalid_plan"
    assert tm == jm == {kind: 1.0}
    assert tplan.backend == jplan.backend == "degraded:greedy"
    assert pre_t.fingerprint(tplan) == pre_t.fingerprint(jplan)
    clean = ResilientPlanner(PreemptionPlanner(
        PlannerOptions(use_device="on", max_evictions=180), device="cpu"))
    assert clean.plan(tprob, tv, jcompat).backend == "vector"


def _plant_repack(plan):
    plan.drained.append("no-such-claim")


@pytest.mark.parametrize("means", ["raising", "invalid"])
def test_repack_wrapper_matches_reference(means):
    jcat, tcat = rep_t.catalogs.__wrapped__()
    jcl, tcl = rep_t.random_fleet(2).both()
    jprob, tprob = j_encode_repack(jcl, jcat), encode_repack(tcl, tcat)
    if means == "raising":
        jp, tp = Boom(), Boom()
    else:
        jp = Planting(JGreedyRepacker(), _plant_repack)
        tp = Planting(GreedyRepacker(), _plant_repack)
        assert repack_plan_defects(tp.plan(tprob), tprob) == \
            j_repack_defects(jp.plan(jprob), jprob) != []
    jplan, tplan, jm, tm = _degrade_both(
        JResilientRep(primary=jp), ResilientRepacker(primary=tp),
        (jprob,), (tprob,), "repack")
    kind = "degraded_backend_failure" if means == "raising" \
        else "degraded_invalid_plan"
    assert tm == jm == {kind: 1.0}
    assert tplan.backend == jplan.backend == "degraded:greedy"
    assert rep_t.plan_view(tplan) == rep_t.plan_view(jplan)
    clean = ResilientRepacker(RepackPlanner(RepackOptions(use_device="on"),
                                            device="cpu"))
    assert not clean.plan(tprob).backend.startswith("degraded")


def test_whatif_wrapper_matches_reference(windows, monkeypatch):  # noqa: F811
    jb, tb, jmenu, tmenu = windows
    jwrap = JResilientWhatIf(JWhatIfPlanner())
    twrap = WhatIfResilient(WhatIfPlanner(device="cpu"))

    def boom(*a, **k):
        raise MemoryError("stack too large")

    monkeypatch.setattr(jwrap.planner, "plan", boom)
    monkeypatch.setattr(twrap.planner, "plan", boom)
    jplan, tplan, jm, tm = _degrade_both(jwrap, twrap, (jb, jmenu),
                                         (tb, tmenu), "whatif")
    assert tm == jm == {"degraded_MemoryError": 1.0}
    assert tplan.backend == jplan.backend == "host-degraded"
    assert twrap.degraded_plans == jwrap.degraded_plans == 1
    assert [o.to_dict() for o in tplan.outcomes] == \
        [o.to_dict() for o in jplan.outcomes]
    host = WhatIfResilient(WhatIfPlanner(device="cpu"), device=False)
    assert host.plan(tb, tmenu).backend == "host"
    monkeypatch.undo()
    clean = WhatIfResilient(WhatIfPlanner(device="cpu"))
    assert clean.plan(tb, tmenu).backend == "device"
    assert clean.degraded_plans == 0


# -- on the card: raise, never degrade ----------------------------------------

CARD = torch.device("cuda")


class CardFault:
    """A primary on the card (its ``device`` is CUDA) whose every call
    raises a device fault; never launches anything."""

    options = None
    device = CARD

    def __init__(self, planted=None):
        self.planted = planted

    def _fault(self, *a, **k):
        raise tft.DeviceFaultError("kernel faulted", kind="error")

    def plan(self, *a, **k):
        if self.planted is None:
            self._fault()
        return self.planted.plan(*a, **k)

    solve_window = rebalance = _kick_window = _fault

    def backlog_pods(self):
        return []


def _card_wrapper(case):
    """(wrapper call, invalid-plan call or None) for one wrapper over a
    primary on the card."""
    if case in ("gang", "preempt", "repack"):
        if case == "gang":
            cats = gang_t.catalogs.__wrapped__()
            _, _, jprob = gang_t.window(cats, 3)
            args = (gang_t.carried(jprob, cats[1]),)
            wrap, oracle, plant = ResilientGangPlanner, GreedyGangPlanner(), \
                _plant_gang
        elif case == "preempt":
            cats = pre_t.catalogs.__wrapped__()
            (_, _, jprob, jv, jcompat), _ = pre_t.window(cats, 5)
            args = (pre_t.carried_problem(jprob, cats[1]),
                    pre_t.carried_victims(jv), jcompat)
            wrap, plant = ResilientPlanner, _plant_preempt
            oracle = GreedyPreemptionPlanner(PlannerOptions(
                max_evictions=180))
        else:
            jcat, tcat = rep_t.catalogs.__wrapped__()
            _, tcl = rep_t.random_fleet(2).both()
            args = (encode_repack(tcl, tcat),)
            wrap, oracle, plant = ResilientRepacker, GreedyRepacker(), \
                _plant_repack
        return (lambda: wrap(primary=CardFault()).plan(*args),
                lambda: wrap(primary=CardFault(Planting(oracle, plant)))
                .plan(*args))
    if case == "whatif":
        return lambda: WhatIfResilient(CardFault()).plan(None, []), None
    if case == "sharded-serving":
        return lambda: ShardedServingLoop(CardFault()).submit(None), None
    svc = ResilientShardedService(CardFault())
    if case == "sharded-window":
        return lambda: svc.solve_window(None), None
    return lambda: svc.rebalance(), None


@pytest.mark.parametrize("case", ["gang", "preempt", "repack", "whatif",
                                  "sharded-window", "sharded-rebalance",
                                  "sharded-serving"])
def test_wrappers_on_the_card_raise_and_never_degrade(case):
    """A primary on the card that faults, or plans with a planted defect,
    never reaches the host oracle: the wrapper raises the fault (an
    ``InvalidPlanError`` for the defect) and no breadcrumb moves."""
    before = breadcrumbs()
    call, invalid = _card_wrapper(case)
    with pytest.raises(tft.DeviceFaultError, match="kernel faulted"):
        call()
    if invalid is not None:
        with pytest.raises(InvalidPlanError):
            invalid()
    assert breadcrumbs() == before


def test_package_exports_name_the_reference_wrappers():
    import karpenter_tpu.gang as jg
    import karpenter_tpu.preempt as jp
    import karpenter_tpu.repack as jr
    import karpenter_tpu.sharded as js
    import karpenter_tpu.whatif as jw

    import karpenter_tpu_torch.gang as tg
    import karpenter_tpu_torch.preempt as tp
    import karpenter_tpu_torch.repack as tr
    import karpenter_tpu_torch.sharded as ts
    import karpenter_tpu_torch.whatif as tw

    for ref, port, names in (
            (jg, tg, ("ResilientGangPlanner", "gang_plan_defects")),
            (jr, tr, ("ResilientRepacker", "repack_plan_defects")),
            (jw, tw, ("ResilientPlanner",)),
            (js, ts, ("ResilientShardedService", "ShardedSolveService",
                      "ShardedSolver", "ShardedPlan", "RebalanceDecision",
                      "ShardRouter", "signature_key", "stable_shard")),
            (jp, tp, ("ResilientPlanner",))):
        for name in names:
            assert hasattr(ref, name) and hasattr(port, name), name
        if hasattr(ref, "__all__"):
            assert set(names) <= set(ref.__all__) & set(port.__all__)
