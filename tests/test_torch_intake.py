"""The port's catalog intake against the reference, on the CPU.

``utils/cache.py``, ``catalog/unavailable.py``, ``catalog/pricing.py``
and ``stochastic/risk.py`` are copies of the reference's modules, and
the port's ``CatalogArrays.refresh_availability`` is the reference's
method: each test drives both packages through the same call script
under one injected clock and compares return values, masks and
generations.  The last tests hold the reference ``JaxSolver`` (no
Pallas) against the port's ``TorchSolver(device="cpu")`` on a
blacked-out catalog and on a risk-priced one: the plans must be equal,
and the port must upload the catalog exactly once per change and never
on a repeat.  The cross-cutting ``constants`` and ``version`` modules
are checked here too.
"""

import dataclasses

import numpy as np
import pytest

import bench
from karpenter_tpu import constants as j_constants
from karpenter_tpu import version as j_version
from karpenter_tpu.catalog.pricing import (
    PricingProvider as JPricing, StaticPricingProvider as JStatic,
)
from karpenter_tpu.catalog.unavailable import (
    UnavailableOfferings as JUnavail, offering_key as j_key,
)
from karpenter_tpu.obs.ledger import PlacementLedger as JLedger
from karpenter_tpu.solver import JaxSolver, SolverOptions
from karpenter_tpu.solver import SolveRequest as JRequest
from karpenter_tpu.stochastic import risk as j_risk
from karpenter_tpu.utils import metrics as j_metrics
from karpenter_tpu.utils.batcher import BatcherOptions as JBatcherOptions
from karpenter_tpu.utils.cache import TTLCache as JCache

from karpenter_tpu_torch import constants as t_constants
from karpenter_tpu_torch import version as t_version
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.carry import CATALOG_FIELDS
from karpenter_tpu_torch.catalog.pricing import (
    PricingProvider as TPricing, StaticPricingProvider as TStatic,
)
from karpenter_tpu_torch.catalog.unavailable import (
    UnavailableOfferings as TUnavail, offering_key as t_key,
)
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.ledger import PlacementLedger as TLedger
from karpenter_tpu_torch.solver import SolveRequest, TorchSolver
from karpenter_tpu_torch.stochastic import risk as t_risk
from karpenter_tpu_torch.utils import metrics as t_metrics
from karpenter_tpu_torch.utils.batcher import BatcherOptions as TBatcherOptions
from karpenter_tpu_torch.utils.cache import TTLCache as TCache


class Clock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def test_constants_and_version_match_reference():
    for name in ("LABEL_NODEPOOL", "GROUP", "NODECLASS_KIND",
                 "NODECLAIM_KIND", "LABEL_MANAGED", "CLAIM_FINALIZER",
                 "DEFAULT_CLIENT_CACHE_TTL_SECONDS"):
        assert getattr(t_constants, name) == getattr(j_constants, name), name
    assert t_version.get_version() == j_version.get_version() == \
        t_version.VERSION


# -- TTLCache ----------------------------------------------------------------

def _cache_script(cache_cls):
    clock = Clock(100.0)
    c = cache_cls(default_ttl=10.0, clock=clock)
    calls = []
    out = []
    c.set("a", 1)
    c.set("b", 2, ttl=3.0)
    out += [c.get("a"), c.get("b"), c.contains("b"), len(c), sorted(c.keys())]
    clock.t = 103.0                  # b expires exactly at its deadline
    out += [c.get("b", "gone"), c.contains("b"), sorted(c.keys())]
    out.append(c.get_or_set("x", lambda: calls.append("x") or "v1"))
    out.append(c.get_or_set("x", lambda: calls.append("x") or "v2"))
    c.set("short", 0, ttl=1.0)
    clock.t = 111.0                  # a (expires 110) and short are stale
    out += [c.cleanup(), sorted(c.keys()), len(c)]
    out.append(c.get_or_set("x", lambda: calls.append("x") or "v2"))
    clock.t = 113.0                  # x (set at 103) expires
    out.append(c.get_or_set("x", lambda: calls.append("x") or "v3", ttl=0.5))
    clock.t = 113.5
    out.append(c.get_or_set("x", lambda: calls.append("x") or "v4"))
    c.delete("x")
    out += [c.get("x"), len(c), calls]
    return out


def test_ttl_cache_clock_script_matches_reference():
    j, t = _cache_script(JCache), _cache_script(TCache)
    assert j == t
    assert t[-1] == ["x", "x", "x"]


# -- UnavailableOfferings and refresh_availability ------------------------------

@pytest.fixture(scope="module")
def catalogs():
    """The reference's bench catalog and the port's own, 40 types: equal
    field for field (tests/test_torch_workload.py)."""
    return bench.build_catalog(40), workload.build_catalog(40)


def _fresh(cat):
    return dataclasses.replace(cat, off_avail=cat.off_avail.copy(),
                               availability_generation=None)


def _blackout_script(unavail_cls, key_fn, cat):
    clock = Clock(0.0)
    u = unavail_cls(clock=clock)
    cat = _fresh(cat)
    out = []

    def step(label):
        changed = cat.refresh_availability(u)
        out.append((label, changed, np.flatnonzero(~cat.off_avail).tolist(),
                    sorted(cat.availability_generation)))

    step("empty")                   # generation None -> frozenset(): no change
    step("repeat")
    u.mark_unavailable("bx2-4x16", "us-south-1", "spot", ttl=30.0)
    u.mark_unavailable("cx2-8x16", "us-south-2", "on-demand")
    u.mark_unavailable("nope-1x1", "us-south-1", "spot")   # not in catalog
    step("marked")
    step("same")
    out.append(sorted(u.unavailable_keys()))
    out.append((u.is_unavailable("bx2-4x16", "us-south-1", "spot"),
                u.is_unavailable_key(key_fn("cx2-8x16", "us-south-2",
                                            "on-demand"))))
    clock.t = 30.0                  # the spot blackout expires
    step("expired")
    out.append(u.cleanup())
    u._cache.set("malformed-key", "x")   # a key of the wrong shape is skipped
    step("malformed")
    clock.t = 3600.0
    out.append(u.cleanup())
    step("all expired")
    return out


def test_refresh_availability_matches_reference(catalogs):
    jcat, tcat = catalogs
    j = _blackout_script(JUnavail, j_key, jcat)
    t = _blackout_script(TUnavail, t_key, tcat)
    assert j == t
    labels = {row[0]: row for row in t if isinstance(row, tuple)
              and len(row) == 4}
    assert labels["empty"][1] is False and labels["repeat"][1] is False
    assert labels["marked"][1] is True and len(labels["marked"][2]) == 2
    assert labels["same"][1] is False
    assert labels["expired"][1] is True and len(labels["expired"][2]) == 1
    # a new generation with the same mask is recorded but is no change
    assert labels["malformed"][1] is False
    assert labels["all expired"][2] == []
    o = tcat.find_offering("bx2-4x16", "us-south-1", "spot")
    assert o is not None and tcat.describe_offering(o) == \
        ("bx2-4x16", "us-south-1", "spot")
    assert tcat.find_offering("bx2-4x16", "mars-1", "spot") is None


# -- SpotRiskModel -----------------------------------------------------------

class Journal:
    """The two calls the risk model makes of the recovery journal."""

    def __init__(self):
        self.records = {}

    def state(self, key, value):
        self.records[key] = dict(value)

    def state_map(self):
        return dict(self.records)


RISK_SCRIPT = (
    ("bx2-4x16", "us-south-1", 3, 4),
    ("bx2-4x16", "us-south-2", 0, 9),
    ("cx2-2x4", "us-south-3", 2, 0),      # interrupted, never exposed
    ("mx2-8x64", "us-south-1", 1, 3),
    ("bx2-4x16", "us-south-1", 0, 4),     # more exposure on a pair
)


def _risk_script(risk, cat):
    m = risk.SpotRiskModel()
    for itype, zone, n, d in RISK_SCRIPT:
        m.observe(itype, zone, interrupted=n, exposure=d)
    cat = dataclasses.replace(cat, off_risk=None, risk_generation=0)
    col = m.risk_column(cat)
    m.price_catalog(cat)
    g1 = cat.risk_generation
    m.price_catalog(cat)               # same model: no bump
    g2 = cat.risk_generation
    m.observe("mx2-8x64", "us-south-1", interrupted=2)
    m.price_catalog(cat, lam=2.0)
    g3 = cat.risk_generation
    journal = Journal()
    m.save(journal)
    journal.records["other/key"] = {"x": 1}
    journal.records[risk.STATE_PREFIX + "no-zone"] = {"interrupted": 1}
    loaded = risk.SpotRiskModel.load(journal)
    return (m.rate("bx2-4x16", "us-south-1"), m.rate("cx2-2x4", "us-south-3"),
            m.rate("never", "seen"), m.counts(), m.snapshot(),
            col.tolist(), cat.off_risk.tolist(),
            cat.offering_rank_price().tolist(), (g1, g2, g3),
            journal.records, loaded.counts(), m.generation)


def test_spot_risk_model_matches_reference(catalogs):
    jcat, tcat = catalogs
    j = _risk_script(j_risk, jcat)
    t = _risk_script(t_risk, tcat)
    assert j == t
    rate, unexposed, never, _, _, col, *_rest = t
    assert rate == 3 / 8 and unexposed == 1.0 and never == 0.0
    assert t[8] == (1, 1, 2)
    o = tcat.find_offering("bx2-4x16", "us-south-1", "spot")
    assert col[o] == np.float32(3 / 8)
    assert col[tcat.find_offering("bx2-4x16", "us-south-1",
                                  "on-demand")] == 0.0


def test_risk_model_from_ledger_and_metrics_match_reference():
    out = []
    for ledger_cls, risk, metrics in ((JLedger, j_risk, j_metrics),
                                      (TLedger, t_risk, t_metrics)):
        ledger = ledger_cls()
        ledger.node_seen("bx2-4x16", "us-south-1", 8)
        ledger.node_seen("cx2-2x4", "us-south-2", 2)
        ledger.interruption("bx2-4x16", "us-south-1", 2)
        ledger.interruption("cx2-2x4", "us-south-2")
        m = risk.refresh_from_ledger(ledger)
        assert risk.get_risk_model() is m
        out.append((m.counts(), m.generation,
                    metrics.SPOT_RISK_RATE.get("bx2-4x16", "us-south-1"),
                    metrics.SPOT_RISK_RATE.get("cx2-2x4", "us-south-2")))
    assert out[0] == out[1]
    assert out[1][2:] == (0.25, 0.5)


# -- PricingProvider -----------------------------------------------------------

class PriceClient:
    """A cloud's two pricing calls; ``bad`` fails per item."""

    def __init__(self, names, bad=()):
        self.names, self.bad = list(names), set(bad)
        self.lists = 0
        self.fetched = []

    def list_instance_profiles(self):
        self.lists += 1
        return [type("P", (), {"name": n})() for n in self.names]

    def get_pricing(self, name):
        self.fetched.append(name)
        if name in self.bad:
            raise RuntimeError(f"no price for {name}")
        return round(0.05 * (1 + self.names.index(name)), 4)


def _pricing_script(pricing_cls, static_cls, options_cls):
    clock = Clock(0.0)
    names = [f"t{i}" for i in range(7)] + ["t3"]     # a duplicate entry
    client = PriceClient(names, bad={"t5"})
    p = pricing_cls(client, clock=clock, batcher_options=options_cls(
        idle_timeout=0.01, max_timeout=0.05, max_items=3, name="pricing"))
    try:
        out = [p.get_price("t1"), p.get_price("t5"), p.get_price("missing"),
               p.get_prices(), client.lists, sorted(client.fetched)]
        clock.t = pricing_cls.TTL - 1.0          # still fresh: no fetch
        out += [p.get_price("t2"), client.lists]
        clock.t = pricing_cls.TTL + 1.0          # stale: one re-fetch
        client.bad = set()
        out += [p.get_price("t5"), client.lists]
        p.refresh()                              # forced
        out.append(client.lists)
    finally:
        p.close()
    s = static_cls({"a": 1.5})
    s.refresh()
    s.close()
    out += [s.get_price("a"), s.get_price("b"), s.get_prices()]
    return out


def test_pricing_provider_matches_reference():
    j = _pricing_script(JPricing, JStatic, JBatcherOptions)
    t = _pricing_script(TPricing, TStatic, TBatcherOptions)
    assert j == t
    assert t[1] == 0.0 and "t5" not in t[3] and len(t[3]) == 6
    assert t[5] == sorted(f"t{i}" for i in range(7))   # deduped
    assert t[7] == 1 and t[8] == 0.3 and t[9] == 2 and t[10] == 3


# -- the solve on a blacked-out and a risk-priced catalog -------------------------

def plan_view(plan):
    return ([(n.instance_type, n.zone, n.capacity_type, n.offering_index,
              n.pod_names) for n in plan.nodes], plan.unplaced_pods,
            plan.unplaced_reasons, plan.total_cost_per_hour)


def _uploads(solver, request):
    before = get_devtel().catalog_uploads
    plan = solver.solve(request)
    return plan, get_devtel().catalog_uploads - before


@pytest.fixture
def window():
    """A fresh 400-pod x 40-type window in each package (fresh catalogs:
    the encode memo keys on the catalog's uid, which a copy would
    share)."""
    jpods, jcat = bench.build_workload(400, 40, seed=5)
    tpods, tcat = workload.build_workload(400, 40, seed=5)
    for f in CATALOG_FIELDS:
        a, b = getattr(jcat, f), getattr(tcat, f)
        assert (np.array_equal(a, b) if isinstance(a, np.ndarray)
                else list(a) == list(b)), f
    return jpods, jcat, tpods, tcat


def test_blackout_plans_match_reference_with_one_upload_per_change(window):
    jpods, jcat, tpods, tcat = window
    jsolver = JaxSolver(SolverOptions(use_pallas="off"))
    tsolver = TorchSolver(device="cpu")
    jreq, treq = JRequest(jpods, jcat), SolveRequest(tpods, tcat)
    base, n0 = _uploads(tsolver, treq)
    assert n0 == 1 and plan_view(base) == plan_view(jsolver.solve(jreq))
    assert _uploads(tsolver, treq)[1] == 0
    used = sorted({(n.instance_type, n.zone, n.capacity_type)
                   for n in base.nodes if n.zone == "us-south-1"})
    assert used
    clocks = Clock(0.0), Clock(0.0)
    jun, tun = JUnavail(clock=clocks[0]), TUnavail(clock=clocks[1])
    for u in (jun, tun):
        for key in used:
            u.mark_unavailable(*key, ttl=60.0)
    assert jcat.refresh_availability(jun) and tcat.refresh_availability(tun)
    np.testing.assert_array_equal(jcat.off_avail, tcat.off_avail)
    plan, n1 = _uploads(tsolver, treq)
    assert n1 == 1
    assert plan_view(plan) == plan_view(jsolver.solve(jreq))
    assert not {(n.instance_type, n.zone, n.capacity_type)
                for n in plan.nodes} & set(used)
    assert plan_view(TorchSolver(device="cpu").solve(treq)) == \
        plan_view(plan)
    assert _uploads(tsolver, treq)[1] == 0
    # the blackouts expire: the mask returns and the plan is the first one
    for c in clocks:
        c.t = 61.0
    assert jcat.refresh_availability(jun) and tcat.refresh_availability(tun)
    assert tcat.off_avail.all()
    plan, n2 = _uploads(tsolver, treq)
    assert n2 == 1 and plan_view(plan) == plan_view(base)
    assert plan_view(jsolver.solve(jreq)) == plan_view(base)


def test_risk_priced_plans_match_reference_with_one_upload_per_change(window):
    jpods, jcat, tpods, tcat = window
    jsolver = JaxSolver(SolverOptions(use_pallas="off"))
    tsolver = TorchSolver(device="cpu")
    jreq, treq = JRequest(jpods, jcat), SolveRequest(tpods, tcat)
    base, _ = _uploads(tsolver, treq)
    spot = sorted({(n.instance_type, n.zone) for n in base.nodes
                   if n.capacity_type == "spot"})
    assert spot
    models = j_risk.SpotRiskModel(), t_risk.SpotRiskModel()
    for m, cat in zip(models, (jcat, tcat)):
        for itype, zone in spot:
            m.observe(itype, zone, interrupted=3, exposure=4)
        m.price_catalog(cat)
    assert jcat.risk_generation == tcat.risk_generation == 1
    np.testing.assert_array_equal(jcat.off_risk, tcat.off_risk)
    plan, n1 = _uploads(tsolver, treq)
    assert n1 == 1
    assert plan_view(plan) == plan_view(jsolver.solve(jreq))
    assert plan_view(TorchSolver(device="cpu").solve(treq)) == \
        plan_view(plan)
    models[1].price_catalog(tcat)                # unchanged model
    assert tcat.risk_generation == 1
    assert _uploads(tsolver, treq)[1] == 0
    # ranking only: the cost of a node is its offering's real price
    prices = [tcat.off_price[n.offering_index] for n in plan.nodes]
    assert sum(p == n.price for p, n in zip(prices, plan.nodes)) == \
        len(plan.nodes)


def test_stochastic_window_on_risk_priced_catalog_matches_reference():
    """The stochastic route reads the risk-priced rank too (its cost
    word through ``cost_sum``): the chance scan's plan on a penalised
    catalog equals the reference's."""
    import karpenter_tpu.apis.nodeclaim as j_nodeclaim
    import karpenter_tpu.apis.pod as j_pod

    import karpenter_tpu_torch.apis.nodeclaim as t_nodeclaim

    tpods = workload.stochastic_pods(300, seed=13)
    jpods = [j_pod.PodSpec(p.name, requests=j_pod.ResourceRequests(
        *p.requests.as_tuple()), usage=j_pod.UsageDistribution(
            mean=j_pod.ResourceRequests(*p.usage.mean.as_tuple()),
            var=tuple(p.usage.var))) for p in tpods]
    jcat, tcat = bench.build_catalog(40), workload.build_catalog(40)
    jpool = j_nodeclaim.NodePool(name="default", overcommit=0.05)
    tpool = t_nodeclaim.NodePool(name="default", overcommit=0.05)
    tsolver = TorchSolver(device="cpu")
    base = tsolver.solve(SolveRequest(tpods, tcat, tpool))
    assert tsolver.last_stats["path"] == "stochastic-cpu"
    spot = sorted({(n.instance_type, n.zone) for n in base.nodes
                   if n.capacity_type == "spot"})
    models = j_risk.SpotRiskModel(), t_risk.SpotRiskModel()
    for m, cat in zip(models, (jcat, tcat)):
        for itype, zone in spot or [("bx2-2x8", "us-south-1")]:
            m.observe(itype, zone, interrupted=3, exposure=4)
        m.price_catalog(cat)
    plan, n1 = _uploads(tsolver, SolveRequest(tpods, tcat, tpool))
    assert n1 == 1 and tsolver.last_stats["path"] == "stochastic-cpu"
    jplan = JaxSolver(SolverOptions(use_pallas="off")).solve(
        JRequest(jpods, jcat, jpool))
    assert plan_view(plan) == plan_view(jplan)
