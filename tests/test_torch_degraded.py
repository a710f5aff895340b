"""The port's degraded modes of the solve path against the reference's,
on the CPU: ``ResilientSolver`` and ``plan_defects``
(``solver/degraded.py``), ``make_solver``'s wrapping, the stochastic and
affinity route strips, the resident re-run and the serving loop's host
failover.

Each wrapper runs beside the reference's on the same seeded inputs, with
the same failure injected by the reference tests' own means (a raising
primary, a monkeypatched route program, an injector scripted per guard
site).  Held: the plans (nodes, pods, unplaced pods and reasons exactly;
the cost to 1e-9 relative, since the greedy oracle's native twin may sum
in another order), the defect strings, the ``ERRORS`` labels and their
counts, and the backend tags.  A ``DeviceFaultError`` is never stripped
or absorbed by a route: a failed hand kernel surfaces from
``TorchSolver`` as ``DeviceFaultError(kind="error")`` and under
``make_solver`` on the CPU as one ``degraded_backend_failure``; a
solver on the card raises it out of ``ResilientSolver``, and an invalid
plan as ``InvalidPlanError``.  The never-fires
test drives ``make_solver(device="cpu")`` over a small window of every
route and holds every breadcrumb still.
"""

import importlib

import pytest
import torch

import karpenter_tpu.faulttol as jft
import karpenter_tpu.stochastic.kernel as j_sto_kernel
import karpenter_tpu.affinity.kernel as j_aff_kernel
from karpenter_tpu.resident import kernels as j_res_kernels
from karpenter_tpu.serving import kernels as j_srv_kernels
from karpenter_tpu.serving.service import ServingLoop as JServingLoop
from karpenter_tpu.serving.validate import _churn_stream as j_churn
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode
from karpenter_tpu.solver import SolveRequest as JSolveRequest
from karpenter_tpu.solver.degraded import ResilientSolver as JResilientSolver
from karpenter_tpu.solver.degraded import plan_defects as j_plan_defects
from karpenter_tpu.utils import metrics as j_metrics

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
import karpenter_tpu_torch.faulttol as tft
from karpenter_tpu_torch import cuda_build, make_solver, workload
from karpenter_tpu_torch.apis.podgroup import PodGroup as TPodGroup
from karpenter_tpu_torch.cuda_build import KernelLaunchError
from karpenter_tpu_torch.resident import kernels as t_res_kernels
from karpenter_tpu_torch.serving import kernels as t_srv_kernels
from karpenter_tpu_torch.serving.service import ServingLoop
from karpenter_tpu_torch.serving.validate import _churn_stream as t_churn
from karpenter_tpu_torch.sharded.solver import ShardedSolver
from karpenter_tpu_torch.solver import (
    SolveRequest, SolverOptions as TSolverOptions, TorchSolver,
)
from karpenter_tpu_torch.solver import encode as t_encode
from karpenter_tpu_torch.solver import packed as t_packed
from karpenter_tpu_torch.solver import torch_backend
from karpenter_tpu_torch.solver.degraded import (
    InvalidPlanError, ResilientSolver, breadcrumbs, plan_defects,
)
from karpenter_tpu_torch.solver.greedy import GreedySolver
from karpenter_tpu_torch.utils import metrics as t_metrics
from tests import test_torch_affinity as aff_t
from tests import test_torch_stochastic as sto_t
from tests.test_torch_solver import (  # noqa: F401 (fixtures)
    both, build_pods, jcatalog, mixed_specs, node_view, tcatalog,
)

# the modules, not the ``encode`` functions the solver packages re-export
j_encode_mod = importlib.import_module("karpenter_tpu.solver.encode")
t_encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")


@pytest.fixture(autouse=True)
def _pristine_faulttol():
    """Fresh injectors and health boards, and empty encode memos: a strip
    disarms the route on a window's cached template, and both packages
    memoize the encode of an unchanged window, so a stripped template
    must not reach another test."""
    memos = (j_encode_mod._ENCODE_MEMO, t_encode_mod._ENCODE_MEMO)
    for ft in (jft, tft):
        ft.clear_injector()
        ft.get_health_board().reset()
    for memo in memos:
        memo.clear()
    yield
    for ft in (jft, tft):
        ft.clear_injector()
        ft.get_health_board().reset()
    for memo in memos:
        memo.clear()


class SiteInjector:
    """Faults the next ``times`` dispatches of one guard site (``kernel``;
    None = any site) with ``kind``: the reference tests' per-site
    injector (tests/test_serving.py), duck-typing the injector at the
    guard's seam of either package."""

    def __init__(self, kernel=None, kind="error", times=1):
        self.kernel, self.kind, self.left = kernel, kind, times
        self.injected = 0

    def draw(self, kernel, candidates):
        if self.left and (self.kernel is None or kernel == self.kernel):
            self.left -= 1
            self.injected += 1
            return self.kind, candidates[0]
        return None

    def probe_faults(self, device):
        return False

    corrupt = staticmethod(tft.FaultyDeviceInjector.corrupt)


def errors(mod, component="solver"):
    """{kind: count} of one component's ERRORS samples."""
    return {k: v for (c, k), v in mod.ERRORS.samples().items()
            if c == component}


def moved(before, after):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def assert_same_plan(tplan, jplan):
    assert node_view(tplan) == node_view(jplan)
    assert tplan.unplaced_pods == jplan.unplaced_pods
    assert tplan.unplaced_reasons == jplan.unplaced_reasons
    assert tplan.total_cost_per_hour == pytest.approx(
        jplan.total_cost_per_hour, rel=1e-9)


class Boom:
    """A primary whose solve raises (the reference tests' means)."""

    options = None

    def solve(self, request):
        raise RuntimeError("backend died")


class Lying:
    """A primary whose plan is the greedy plan with one defect planted."""

    def __init__(self, greedy, corrupt):
        self.greedy, self.corrupt = greedy, corrupt
        self.options = None

    def solve(self, request):
        plan = self.greedy.solve(request)
        self.corrupt(plan)
        return plan


def _nan_cost(plan):
    plan.total_cost_per_hour = float("nan")


def _bad_offering(plan):
    plan.nodes[0].offering_index = 10 ** 6


def _dup_pod(plan):
    plan.unplaced_pods.append(plan.nodes[0].pod_names[0])


def _drop_pod(plan):
    plan.nodes[0].pod_names = plan.nodes[0].pod_names[1:]


def _neg_price(plan):
    plan.nodes[-1].price = -1.0


CORRUPTIONS = {"clean": lambda plan: None, "nan_cost": _nan_cost,
               "bad_offering": _bad_offering, "dup_pod": _dup_pod,
               "drop_pod": _drop_pod, "neg_price": _neg_price}


def _window(seed=4, n=60):
    return both(mixed_specs(n, seed))


@pytest.mark.parametrize("case", list(CORRUPTIONS))
def test_plan_defects_and_invalid_plan_degrade_match_reference(
        jcatalog, tcatalog, case):
    from karpenter_tpu.solver.greedy import GreedySolver as JGreedySolver

    jpods, tpods = _window()
    jreq, treq = JSolveRequest(jpods, jcatalog), SolveRequest(tpods, tcatalog)
    jplan = JGreedySolver().solve(jreq)
    tplan = GreedySolver().solve(treq)
    CORRUPTIONS[case](jplan)
    CORRUPTIONS[case](tplan)
    want = j_plan_defects(jplan, jreq)
    assert plan_defects(tplan, treq) == want
    assert bool(want) == (case != "clean")
    jb, tb = errors(j_metrics), errors(t_metrics)
    jout = JResilientSolver(Lying(JGreedySolver(), CORRUPTIONS[case]),
                            SolverOptions()).solve(jreq)
    tout = ResilientSolver(Lying(GreedySolver(), CORRUPTIONS[case]),
                           TSolverOptions()).solve(treq)
    assert moved(tb, errors(t_metrics)) == moved(jb, errors(j_metrics)) == (
        {} if case == "clean" else {"degraded_invalid_plan": 1.0})
    assert tout.backend == jout.backend
    assert tout.backend.startswith("degraded:") == (case != "clean")
    if case != "clean":
        assert_same_plan(tout, jout)


def test_partial_gang_defect_matches_reference(jcatalog, tcatalog):
    from karpenter_tpu.apis.podgroup import PodGroup as JPodGroup
    import karpenter_tpu.apis.pod as j_pod
    import karpenter_tpu.apis.requirements as j_req
    from karpenter_tpu.solver.greedy import GreedySolver as JGreedySolver

    specs = mixed_specs(12, 6)
    jpods = build_pods(specs, j_pod, j_req,
                       gang=JPodGroup("g1", min_member=12))
    tpods = build_pods(specs, t_pod, t_req,
                       gang=TPodGroup("g1", min_member=12))
    jreq, treq = JSolveRequest(jpods, jcatalog), SolveRequest(tpods, tcatalog)
    jplan, tplan = JGreedySolver().solve(jreq), GreedySolver().solve(treq)
    for plan in (jplan, tplan):
        gone = plan.nodes.pop()
        plan.unplaced_pods.extend(gone.pod_names)
    want = j_plan_defects(jplan, jreq)
    assert plan_defects(tplan, treq) == want
    assert any(d.startswith("partial gang g1") for d in want)


def test_backend_failure_degrades_as_reference(jcatalog, tcatalog):
    jpods, tpods = _window(seed=8)
    jb, tb = errors(j_metrics), errors(t_metrics)
    jout = JResilientSolver(Boom(), SolverOptions()).solve(
        JSolveRequest(jpods, jcatalog))
    tout = ResilientSolver(Boom(), TSolverOptions()).solve(
        SolveRequest(tpods, tcatalog))
    assert moved(tb, errors(t_metrics)) == moved(jb, errors(j_metrics)) == {
        "degraded_backend_failure": 1.0}
    assert tout.backend == jout.backend
    assert tout.backend.startswith("degraded:greedy")
    assert_same_plan(tout, jout)
    # the fallback's own solve span nests under solve.degraded
    from karpenter_tpu_torch import obs

    obs.reset_recorder()
    ResilientSolver(Boom(), TSolverOptions()).solve(
        SolveRequest(tpods, tcatalog))
    (_, _, root, spans), = obs.get_recorder().traces()
    assert root.name == "solve.degraded"
    assert [s.name for s in spans if s.parent_id == root.span_id] == [
        "solve"]


def test_degrade_invalidates_the_resident_store_as_reference(jcatalog,
                                                             tcatalog):
    """A degraded solve invalidates the primary's resident store once; the
    next window rebuilds with the degradation's reason."""
    jpods, tpods = _window(seed=9)
    jsolver = JaxSolver(SolverOptions(use_pallas="off", resident="on"))
    tsolver = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    jsolver.solve(JSolveRequest(jpods, jcatalog))
    tsolver.solve(SolveRequest(tpods, tcatalog))
    jw = JResilientSolver(jsolver, SolverOptions())
    tw = ResilientSolver(tsolver)
    for w in (jw, tw):
        w.primary.solve = Boom().solve
    jw.solve(JSolveRequest(jpods, jcatalog))
    tw.solve(SolveRequest(tpods, tcatalog))
    del jsolver.solve, tsolver.solve
    assert tsolver.resident.invalidations == jsolver.resident.invalidations \
        == 1
    jw.solve(JSolveRequest(jpods, jcatalog))
    tw.solve(SolveRequest(tpods, tcatalog))
    assert tsolver.resident.last_rebuild_reason == \
        jsolver.resident.last_rebuild_reason == "degraded_backend_failure"


def test_make_solver_wraps_as_the_reference(tcatalog, monkeypatch):
    monkeypatch.delenv("KARPENTER_ENABLE_SHARDED", raising=False)
    plain = make_solver(TSolverOptions(), device="cpu")
    assert type(plain) is ResilientSolver
    assert type(plain.primary) is TorchSolver
    assert plain.device == torch.device("cpu")     # delegated
    sharded = make_solver(TSolverOptions(sharded=2), device="cpu")
    assert type(sharded) is ResilientSolver
    assert type(sharded.primary) is ShardedSolver
    assert type(make_solver(TSolverOptions(backend="greedy"),
                            device="cpu")) is GreedySolver
    _, tpods = _window(seed=3, n=30)
    plan = plain.solve(SolveRequest(tpods, tcatalog))
    assert plan.backend == "torch" and plain.last_stats["path"]


class _Store:
    """The resident store's invalidation count, alone."""

    def __init__(self):
        self.invalidations = 0
        self.reasons = []

    def invalidate(self, reason):
        self.invalidations += 1
        self.reasons.append(reason)


class CardPrimary:
    """A solver on the card (its ``device`` is CUDA) that faults, or
    returns the greedy plan with one pod dropped from its accounting."""

    device = torch.device("cuda")
    options = None

    def __init__(self, means):
        self.means, self.resident = means, _Store()

    def solve(self, request):
        if self.means == "raising":
            raise tft.DeviceFaultError("kernel faulted", kind="error")
        plan = GreedySolver().solve(request)
        plan.nodes[0].pod_names.pop()
        return plan


@pytest.mark.parametrize("means", ["raising", "invalid"])
def test_solver_on_the_card_raises_and_never_degrades(tcatalog, means):
    """``ResilientSolver`` over a solver on the card hands no window to
    the greedy oracle: a fault raises as it is, an invalid plan raises
    ``InvalidPlanError`` and invalidates the store once; no breadcrumb
    moves."""
    _, tpods = _window(seed=6)
    primary = CardPrimary(means)
    before = breadcrumbs()
    if means == "raising":
        with pytest.raises(tft.DeviceFaultError, match="kernel faulted"):
            ResilientSolver(primary).solve(SolveRequest(tpods, tcatalog))
        assert primary.resident.invalidations == 0
    else:
        with pytest.raises(InvalidPlanError) as info:
            ResilientSolver(primary).solve(SolveRequest(tpods, tcatalog))
        assert any("pod accounting mismatch" in d
                   for d in info.value.defects)
        assert primary.resident.reasons == ["invalid_plan"]
    assert breadcrumbs() == before


def test_missing_card_or_failed_build_raises_out_of_make_solver(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for opts in (TSolverOptions(), TSolverOptions(sharded=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_solver(opts)

    def failed_build(names=cuda_build.KERNEL_SOURCES):
        raise RuntimeError("nvcc failed: ffd_scan.cu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(cuda_build, "build_all", failed_build)
    monkeypatch.setattr(cuda_build, "_ready", False)
    before = breadcrumbs()
    for opts in (TSolverOptions(), TSolverOptions(sharded=2)):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            make_solver(opts)
    assert breadcrumbs() == before


def _launch_error(*a, **k):
    raise KernelLaunchError("ffd_scan", 1, "invalid argument")


def test_kernel_launch_error_is_a_device_fault_no_route_absorbs(
        jcatalog, tcatalog, monkeypatch):
    """A failed hand-kernel launch surfaces from ``TorchSolver`` as
    ``DeviceFaultError(kind="error")``: nothing re-runs the window down
    another route.  Under ``make_solver`` it is one counted
    ``degraded_backend_failure`` with the greedy plan."""
    calls = []

    def failing(*a, **k):
        calls.append(1)
        _launch_error()

    monkeypatch.setattr(t_packed, "ffd_scan", failing)
    _, tpods = _window(seed=5)
    req = SolveRequest(tpods, tcatalog)
    before = breadcrumbs()
    with pytest.raises(tft.DeviceFaultError) as info:
        TorchSolver(device="cpu").solve(req)
    assert info.value.kind == "error"
    assert isinstance(info.value.__cause__, KernelLaunchError)
    assert len(calls) == 1 and breadcrumbs() == before
    plan = make_solver(TSolverOptions(), device="cpu").solve(req)
    assert moved(before, breadcrumbs()) == {
        "errors{solver,degraded_backend_failure}": 1.0}
    assert plan.backend.startswith("degraded:greedy")
    want = GreedySolver().solve(req)
    assert node_view(plan) == node_view(want)


# -- the route strips ---------------------------------------------------------

def _strip_windows(route, seed):
    """(reference problem, port problem, the reference's route program
    (module, name), the port's name in ``torch_backend``, the port's
    request)."""
    if route == "stochastic":
        jcat, tcat = sto_t.catalogs.__wrapped__()
        tpods = workload.stochastic_pods(120, seed=seed)
        jprob = encode(sto_t.to_reference(tpods), jcat, sto_t.j_pool())
        tprob = t_encode(tpods, tcat, sto_t.t_pool())
        return jprob, tprob, (j_sto_kernel, "solve_packed_stochastic"), \
            "solve_packed_stochastic", SolveRequest(tpods, tcat,
                                                    sto_t.t_pool())
    cats = aff_t.catalogs.__wrapped__()
    _, tpods, jprob, tprob = aff_t._bench_windows(cats, seed, n=150)
    return jprob, tprob, (j_aff_kernel, "solve_packed_affinity"), \
        "solve_packed_affinity", SolveRequest(tpods, cats[1])


@pytest.mark.parametrize("route", ["stochastic", "affinity"])
def test_route_strip_matches_reference(route, monkeypatch):
    """A host-side failure of the route's program strips the route on the
    window and its template and re-runs the same buffer on the FFD
    route: the plan, breadcrumbs and path as the reference's; the next
    solve of the window takes the scan with no second breadcrumb."""
    jprob, tprob, (jmod, jname), tname, _ = _strip_windows(route, 2)

    def boom(*a, **k):
        raise RuntimeError(f"injected {route} program fault")

    monkeypatch.setattr(jmod, jname, boom)
    monkeypatch.setattr(torch_backend, tname, boom)
    jsolver = JaxSolver(SolverOptions(use_pallas="off"))
    tsolver = TorchSolver(device="cpu")
    jb, tb = (errors(j_metrics), j_metrics.OVERCOMMIT_SOLVES.samples()), \
        (errors(t_metrics), t_metrics.OVERCOMMIT_SOLVES.samples())
    jplan, tplan = jsolver.solve_encoded(jprob), tsolver.solve_encoded(tprob)
    assert_same_plan(tplan, jplan)
    assert jsolver.last_stats["path"] == "scan"
    assert tsolver.last_stats["path"] == "ffd-reference"
    kind = f"{route}_fallback"
    assert moved(tb[0], errors(t_metrics)) == \
        moved(jb[0], errors(j_metrics)) == {kind: 1.0}
    assert moved(tb[1], t_metrics.OVERCOMMIT_SOLVES.samples()) == moved(
        jb[1], j_metrics.OVERCOMMIT_SOLVES.samples()) == (
        {("degraded",): 1.0} if route == "stochastic" else {})
    tmpl = next(iter(tprob._prep_cache.values()))
    assert getattr(tmpl, "sto" if route == "stochastic" else "aff") is None
    mid = errors(t_metrics)
    again = tsolver.solve_encoded(tprob)
    assert node_view(again) == node_view(tplan)
    assert errors(t_metrics) == mid
    assert tsolver.last_stats["path"] == "ffd-reference"


@pytest.mark.parametrize("route", ["stochastic", "affinity"])
def test_device_fault_is_never_stripped(route, monkeypatch):
    """A ``DeviceFaultError`` on the route (an injected fault, or a hand
    kernel's failed launch inside the program) propagates: the route
    stays armed and nothing is counted as a fallback; under
    ``make_solver`` it is one ``degraded_backend_failure``."""
    _, tprob, _, tname, req = _strip_windows(route, 4)
    before = breadcrumbs()
    tft.install_injector(SiteInjector(route))
    with pytest.raises(tft.DeviceFaultError):
        TorchSolver(device="cpu").solve_encoded(tprob)
    tmpl = next(iter(tprob._prep_cache.values()))
    leaf = "sto" if route == "stochastic" else "aff"
    assert getattr(tmpl, leaf) is not None
    assert breadcrumbs() == before
    tft.clear_injector()
    monkeypatch.setattr(torch_backend, tname, _launch_error)
    with pytest.raises(tft.DeviceFaultError) as info:
        TorchSolver(device="cpu").solve_encoded(tprob)
    assert isinstance(info.value.__cause__, KernelLaunchError)
    assert getattr(tmpl, leaf) is not None
    assert breadcrumbs() == before
    plan = make_solver(TSolverOptions(), device="cpu").solve(req)
    assert plan.backend.startswith("degraded:greedy")
    assert moved(before, breadcrumbs()) == {
        "errors{solver,degraded_backend_failure}": 1.0}


# -- the resident re-run ------------------------------------------------------

def test_resident_rerun_matches_reference(monkeypatch):
    seqs_t, tcat = t_churn(48, 6, 3, 21)
    seqs_j, jcat = j_churn(48, 6, 3, 21)
    jsolver = JaxSolver(SolverOptions(use_pallas="off", resident="on"))
    tsolver = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    jsolver.solve_encoded(encode(seqs_j[0], jcat))
    tsolver.solve_encoded(t_encode(seqs_t[0], tcat))

    def broken(*a, **k):
        raise RuntimeError("resident program failed")

    monkeypatch.setattr(j_res_kernels, "solve_resident", broken)
    monkeypatch.setattr(t_res_kernels, "solve_resident", broken)
    jb, tb = errors(j_metrics), errors(t_metrics)
    jplan = jsolver.solve_encoded(encode(seqs_j[1], jcat))
    tplan = tsolver.solve_encoded(t_encode(seqs_t[1], tcat))
    assert_same_plan(tplan, jplan)
    assert moved(tb, errors(t_metrics)) == moved(jb, errors(j_metrics)) == {
        "resident_fallback": 1.0}
    assert tsolver.resident.invalidations == \
        jsolver.resident.invalidations == 1
    assert tsolver.last_stats["path"] == "ffd-reference"
    monkeypatch.undo()
    jsolver.solve_encoded(encode(seqs_j[2], jcat))
    tsolver.solve_encoded(t_encode(seqs_t[2], tcat))
    assert tsolver.resident.last_delta.mode == "rebuild"
    assert tsolver.resident.last_rebuild_reason == \
        jsolver.resident.last_rebuild_reason == "dispatch_error"


def test_resident_device_fault_propagates():
    """A ``DeviceFaultError`` of the resident program is no fallback: it
    invalidates the store and raises, the next window rebuilds, and under
    ``make_solver`` on the CPU the degrade leaves the store invalidated
    once (the dispatch's invalidation, not a second one)."""
    seqs, cat = t_churn(48, 6, 3, 22)
    tsolver = TorchSolver(TSolverOptions(resident="on"), device="cpu")
    tsolver.solve_encoded(t_encode(seqs[0], cat))
    before = breadcrumbs()
    tft.install_injector(SiteInjector("resident"))
    with pytest.raises(tft.DeviceFaultError):
        tsolver.solve_encoded(t_encode(seqs[1], cat))
    assert breadcrumbs() == before
    tsolver.solve_encoded(t_encode(seqs[1], cat))
    assert tsolver.resident.invalidations == 1
    assert (tsolver.resident.last_delta.mode,
            tsolver.resident.last_delta.reason) == ("rebuild",
                                                     "dispatch_error")
    wrapped = make_solver(TSolverOptions(resident="on"), device="cpu")
    req = SolveRequest(seqs[2], cat)
    wrapped.solve(req)
    tft.install_injector(SiteInjector("resident"))
    plan = wrapped.solve(req)
    assert plan.backend.startswith("degraded:greedy")
    assert wrapped.resident.invalidations == 1
    assert moved(before, breadcrumbs()) == {
        "errors{solver,degraded_backend_failure}": 1.0}
    assert node_view(plan) == node_view(GreedySolver().solve(req))


# -- the serving loop's host failover -----------------------------------------

def _loops():
    return (JServingLoop(JaxSolver(SolverOptions(use_pallas="off",
                                                 serving="off"))),
            ServingLoop(TorchSolver(TSolverOptions(serving="off"),
                                    device="cpu")))


@pytest.mark.parametrize("site", ["serving-kick", "serving-fetch"])
def test_serving_host_failover_matches_reference(site):
    """A device fault at the kick or the fetch fails the window over to
    the classic path: the plan equals the classic one, host_failovers,
    ``SERVING_WINDOWS{host_failover}`` and the invalidation as the
    reference's; the next window rebuilds back on the ring."""
    seqs_t, tcat = t_churn(48, 6, 3, 31)
    seqs_j, jcat = j_churn(48, 6, 3, 31)
    jloop, tloop = _loops()
    jloop.submit(encode(seqs_j[0], jcat)).result()
    tloop.submit(t_encode(seqs_t[0], tcat)).result()
    jb = j_metrics.SERVING_WINDOWS.get("host_failover")
    tb = t_metrics.SERVING_WINDOWS.get("host_failover")
    plans = []
    for ft, loop, prob in ((jft, jloop, encode(seqs_j[1], jcat)),
                           (tft, tloop, t_encode(seqs_t[1], tcat))):
        if site == "serving-kick":
            ft.install_injector(SiteInjector(site))
            plans.append(loop.submit(prob).result())
        else:
            pend = loop.submit(prob)
            ft.install_injector(SiteInjector(site))
            plans.append(pend.result())
        ft.clear_injector()
    jplan, tplan = plans
    assert_same_plan(tplan, jplan)
    assert tloop.host_failovers == jloop.host_failovers == 1
    assert t_metrics.SERVING_WINDOWS.get("host_failover") - tb == \
        j_metrics.SERVING_WINDOWS.get("host_failover") - jb == 1
    assert tloop.invalidations == jloop.invalidations == 1
    assert tloop.last_reason == jloop.last_reason == "device_fault:error"
    assert tloop.buf.dev is None
    classic = TorchSolver(device="cpu").solve_encoded(
        t_encode(seqs_t[1], tcat))
    assert node_view(tplan) == node_view(classic)
    tloop.submit(t_encode(seqs_t[2], tcat)).result()
    assert tloop.last_mode == "rebuild" and tloop.host_failovers == 1


def test_serving_kick_error_falls_back_classic_as_reference(monkeypatch):
    seqs_t, tcat = t_churn(48, 6, 3, 32)
    seqs_j, jcat = j_churn(48, 6, 3, 32)
    jloop, tloop = _loops()
    jloop.submit(encode(seqs_j[0], jcat)).result()
    tloop.submit(t_encode(seqs_t[0], tcat)).result()

    def broken(*a, **k):
        raise RuntimeError("serving kick failed")

    monkeypatch.setattr(j_srv_kernels, "serve_window", broken)
    monkeypatch.setattr(t_srv_kernels, "serve_window", broken)
    jb, tb = errors(j_metrics), errors(t_metrics)
    jplan = jloop.submit(encode(seqs_j[1], jcat)).result()
    tplan = tloop.submit(t_encode(seqs_t[1], tcat)).result()
    assert_same_plan(tplan, jplan)
    assert moved(tb, errors(t_metrics)) == moved(jb, errors(j_metrics)) == {
        "serving_fallback": 1.0}
    assert tloop.last_reason == jloop.last_reason == "dispatch_error"
    assert tloop.host_failovers == jloop.host_failovers == 0


# -- never fires on the main path ---------------------------------------------

def test_breadcrumbs_never_move_on_clean_windows_of_every_route(
        tcatalog, monkeypatch):
    """``make_solver(device="cpu")`` over a small window of every route
    (ffd, pref, flat, affinity, stochastic, resident, serving, sharded,
    and the sharded host route): no breadcrumb moves, no backend is
    ``degraded:``."""
    monkeypatch.delenv("KARPENTER_ENABLE_SHARDED", raising=False)
    _, tpods = _window(seed=11, n=120)
    aff_cats = aff_t.catalogs.__wrapped__()
    _, aff_pods, _, _ = aff_t._bench_windows(aff_cats, 1, n=120)
    sto_cat = workload.build_catalog(30)
    sto_pods = workload.stochastic_pods(120, seed=3)
    cases = [
        ("ffd", TSolverOptions(), SolveRequest(tpods, tcatalog)),
        ("pref", TSolverOptions(),
         SolveRequest(workload.with_preferences(tpods), tcatalog)),
        ("flat", TSolverOptions(flat_solver="on"),
         SolveRequest(tpods, tcatalog)),
        ("affinity", TSolverOptions(), SolveRequest(aff_pods, aff_cats[1])),
        ("stochastic", TSolverOptions(),
         SolveRequest(sto_pods, sto_cat, sto_t.t_pool())),
        ("resident", TSolverOptions(resident="on"),
         SolveRequest(tpods, tcatalog)),
        ("serving", TSolverOptions(serving="on"),
         SolveRequest(tpods, tcatalog)),
        ("sharded", TSolverOptions(sharded=2), SolveRequest(tpods, tcatalog)),
        ("sharded-host", TSolverOptions(sharded=2),
         SolveRequest(workload.with_preferences(tpods), tcatalog)),
    ]
    before = breadcrumbs()
    errs = errors(t_metrics, "sharded")
    for label, opts, req in cases:
        solver = make_solver(opts, device="cpu")
        for _ in range(2):
            plan = solver.solve(req)
            assert not plan.backend.startswith("degraded"), label
        if label == "sharded":
            assert solver.service.degraded_windows == 0
            assert solver.last_stats["path"] == "sharded-cpu"
        if label == "sharded-host":
            assert plan.backend == "sharded-host"
    assert breadcrumbs() == before
    assert errors(t_metrics, "sharded") == errs
