"""The port's what-if planning service against the reference's, on the CPU.

``karpenter_tpu_torch/whatif/{forecast,service,__main__}.py`` and the
rest of ``whatif/scenario.py`` run the same scripts as
``karpenter_tpu/whatif``: the arrival forecaster (rates, the diurnal
profile, ``expected_arrivals``, the snapshot, the journal round trip),
the scenario helpers (``base_counts``, ``group_signature``,
``wave_from_forecast``, ``perturbations_from_profile``), the planning
service (payload and ``digest()`` at seeds 1-4, the horizon clamp, the
single flight, the warm start and its expiry, the journal gate, the
gauge hygiene, the bounded registry), ``WhatIfController``'s counted
failure, and the command line's digests.  Each package reads its own
placement ledger, so every script seeds both ledgers with the same
arrivals under each package's ``obs.use_ledger`` and pins the hour.
Payloads compare exactly with the fields that read a clock taken out;
the port's service runs with ``device="cpu"``.

On the card a failed stacked plan raises out of ``evaluate`` and the
controller counts it once: shown here with ``whatif.degraded.holds_card``
patched to the card and a fault scripted at the ``whatif`` guard site.
"""

from __future__ import annotations

import dataclasses
import importlib
import random
import types

import numpy as np
import pytest
import torch

from tests.test_torch_degraded import (  # noqa: F401 (fixture)
    SiteInjector, _pristine_faulttol,
)

PKGS = ("karpenter_tpu", "karpenter_tpu_torch")

_MODS = dict(
    whatif="whatif", forecast="whatif.forecast", service="whatif.service",
    scenario="whatif.scenario", planner="whatif.planner",
    degraded="whatif.degraded", cli="whatif.__main__", obs="obs",
    ledger="obs.ledger", journal="recovery.journal",
    metrics="utils.metrics", pod="apis.pod", catalog="catalog",
    fake="cloud.fake", profile="chaos.profile", soak="chaos.soak",
    faulttol="faulttol")


def mods(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(
        pkg=pkg, torch=pkg.endswith("_torch"),
        **{k: importlib.import_module(f"{pkg}.{v}")
           for k, v in _MODS.items()})


SIDES = tuple(mods(p) for p in PKGS)
WALL_FIELDS = ("plan_seconds", "wall_seconds", "built_at", "created_at")


def dev(m) -> dict:
    return {"device": "cpu"} if m.torch else {}


def without_walls(obj):
    if isinstance(obj, dict):
        return {k: without_walls(v) for k, v in obj.items()
                if k not in WALL_FIELDS}
    if isinstance(obj, list):
        return [without_walls(v) for v in obj]
    return obj


def make_catalog(m, num_types: int = 12):
    """``tests/test_whatif.py::make_catalog`` in package ``m``."""
    cloud = m.fake.FakeCloud(profiles=m.fake.generate_profiles(num_types))
    pricing = m.catalog.PricingProvider(cloud)
    catalog = m.catalog.CatalogArrays.build(
        m.catalog.InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    return catalog


def make_pods(m, n: int, seed: int = 0) -> list:
    rng = np.random.RandomState(seed)
    sizes = [(100, 256), (250, 512), (500, 1024), (1000, 4096)]
    return [m.pod.PodSpec(f"wi{seed}-{i}", requests=m.pod.ResourceRequests(
        *sizes[int(rng.randint(len(sizes)))], 0, 1)) for i in range(n)]


def seeded_ledger(m, pods, per_hour: int = 2):
    ledger = m.ledger.PlacementLedger()
    for h in range(24):
        for p in pods:
            for _ in range(per_hour):
                ledger.arrival(p.signature_key(), t=h * 3600.0)
    return ledger


class StubCluster:
    """The reference tests' stub: a fixed pending set."""

    def __init__(self, pods):
        self._pods = list(pods)

    def pending_pods(self):
        return [types.SimpleNamespace(spec=p) for p in self._pods]

    def list(self, kind, predicate=None):
        return []

    def get_nodeclass(self, name):
        return None


def make_service(m, catalog, pods, **kw):
    return m.service.PlanningService(
        StubCluster(pods), catalog_fn=lambda: catalog, seed=7,
        **dev(m), **kw)


@pytest.fixture(scope="module")
def catalogs():
    return tuple(make_catalog(m) for m in SIDES)


def both(script):
    """``script(m, side_index)`` for each package; the two outcomes."""
    return [script(m, i) for i, m in enumerate(SIDES)]


def random_ledger(m, seed: int):
    """Arrivals of 5 signatures over 60 absolute hours (the recency walk
    spans more than a day), each 0-3 a hour."""
    rng = random.Random(seed)
    ledger = m.ledger.PlacementLedger()
    for h in range(60):
        for s in range(5):
            for _ in range(rng.randint(0, 3) if (h + s) % 7 else 0):
                ledger.arrival(f"sig{s}", t=h * 3600.0 + rng.random())
    return ledger


def forecast_view(f) -> dict:
    return {"rates": f.rates(), "diurnal": f.diurnal().tolist(),
            "generation": f.generation,
            "expected": {(h, s): f.expected_arrivals(h, s)
                         for h in (0, 1, 4, 24, 200) for s in (0, 9, 23)},
            "snapshot": without_walls(f.snapshot())}


# -- the forecaster -----------------------------------------------------------

def test_cold_ledger_forecast_equals_reference():
    j, t = both(lambda m, i: forecast_view(
        m.forecast.ArrivalForecaster.from_ledger(m.ledger.PlacementLedger())))
    assert t == j
    assert t["rates"] == {} and t["expected"][(4, 9)] == {}


def test_soak_prior_equals_reference():
    j, t = both(lambda m, i: m.forecast.soak_diurnal_prior())
    np.testing.assert_array_equal(t, j)
    loads = [s.load for s in SIDES[1].soak.PRODUCTION_DAY]
    assert float(t.max()) / float(t.min()) == pytest.approx(
        max(loads) / min(loads))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_forecast_equals_reference(seed):
    j, t = both(lambda m, i: forecast_view(
        m.forecast.ArrivalForecaster.from_ledger(random_ledger(m, seed))))
    assert t == j
    assert t["rates"] and all(v > 0 for v in t["rates"].values())


def test_merged_forecast_equals_reference():
    def script(m, i):
        a = m.forecast.ArrivalForecaster.from_ledger(random_ledger(m, 4))
        b = m.forecast.ArrivalForecaster.from_ledger(random_ledger(m, 5))
        merged = a.merged_with(b)
        return forecast_view(merged), forecast_view(merged.merged_with(b))

    j, t = both(script)
    assert t == j
    assert t[0] == t[1]            # merging the same snapshot twice


def test_journal_round_trip_equals_reference(tmp_path):
    """Each package saves to its own journal; the records, and the
    forecaster each loads (from its own file and from the other
    package's), are the reference's."""
    saved = []
    for m in SIDES:
        f = m.forecast.ArrivalForecaster.from_ledger(random_ledger(m, 6))
        journal = m.journal.IntentJournal(
            str(tmp_path / f"{m.pkg}.jsonl"), fsync=False)
        f.save(journal)
        saved.append((f, journal.state_map()))
    (jf, jstate), (tf, tstate) = saved
    assert tstate == jstate
    views = []
    for m in SIDES:
        for src in PKGS:
            journal = m.journal.IntentJournal(str(tmp_path / f"{src}.jsonl"),
                                              fsync=False)
            views.append(forecast_view(m.forecast.ArrivalForecaster.load(
                journal)))
    assert all(v == views[0] for v in views[1:])
    assert views[0]["generation"] == tf.generation == jf.generation


# -- the scenario helpers -----------------------------------------------------

def baselines(catalogs, n=40, seed=0):
    return both(lambda m, i: m.planner.build_baseline(
        make_pods(m, n, seed), catalogs[i]))


def test_baseline_counts_and_signatures_equal_reference(catalogs):
    jb, tb = baselines(catalogs)
    np.testing.assert_array_equal(tb.base_counts(), jb.base_counts())
    G = tb.problem.num_groups
    assert G == jb.problem.num_groups > 1
    assert [tb.group_signature(g) for g in range(G)] == \
        [jb.group_signature(g) for g in range(G)]


@pytest.mark.parametrize("scale", [1.0, 2.5])
def test_wave_from_forecast_lowers_as_reference(catalogs, scale):
    def script(m, i):
        pods = make_pods(m, 40, 1)
        baseline = m.planner.build_baseline(pods, catalogs[i])
        f = m.forecast.ArrivalForecaster.from_ledger(
            seeded_ledger(m, pods[:25], per_hour=1))
        expected = f.expected_arrivals(4, 9)
        expected["unknown-signature"] = 3
        wave = m.scenario.wave_from_forecast(baseline, expected, scale)
        st = m.scenario.lower_scenarios(baseline, [
            m.scenario.Scenario("baseline"),
            m.scenario.Scenario("wave", (wave,))])
        return wave.waves, st.didx.tolist(), st.dval.tolist(), \
            st.counts.tolist()

    j, t = both(script)
    assert t == j
    assert t[0]


@pytest.mark.parametrize("profile", [
    "calm", "spot-storm", "capacity-crunch", "overload", "fragmentation"])
def test_perturbations_from_profile_equal_reference(catalogs, profile):
    def script(m, i):
        baseline = m.planner.build_baseline(make_pods(m, 30, 2), catalogs[i])
        prof = m.profile.PROFILES[profile]
        perts = m.scenario.perturbations_from_profile(
            prof, catalogs[i], baseline, random.Random(11))
        return [(type(p).__name__, dataclasses.astuple(p)) for p in perts]

    assert both(script)[1] == both(script)[0]


# -- the planning service -----------------------------------------------------

def one_cycle(m, seed):
    """The command line's seeded cycle (``__main__._seeded_world``) on a
    fresh ledger: (payload, digest)."""
    cluster, catalog, seed_ledger = m.cli._seeded_world(seed)
    ledger = m.ledger.PlacementLedger()
    seed_ledger(ledger)
    with m.obs.use_ledger(ledger):
        svc = m.service.PlanningService(cluster, catalog_fn=lambda: catalog,
                                        seed=seed, validate=True, **dev(m))
        payload = svc.evaluate(record=True, hour=9)
    return payload, svc.digest()


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_service_payload_and_digest_equal_reference(seed):
    (jp, jd), (tp, td) = both(lambda m, i: one_cycle(m, seed))
    assert without_walls(tp) == without_walls(jp)
    assert td == jd
    assert tp["backend"] == jp["backend"] == "device"
    assert tp["dispatches"] == 1 and tp["recommendations"]
    assert tp["validation"] == {"checked": True, "violations": []}


def test_cli_digests_equal_reference(capsys):
    out = []
    for m in SIDES:
        argv = ["--determinism", "--seeds", "4"]
        assert m.cli.main(argv + (["--device", "cpu"] if m.torch
                                  else [])) == 0
        assert m.cli.main(["--demo"] + (["--device", "cpu"] if m.torch
                                        else [])) == 0
        out.append([ln for ln in capsys.readouterr().out.splitlines()
                    if ln.startswith(("ok", "FAIL", "whatif"))])
    assert out[1] == out[0]
    assert len(out[1]) == 5 and all(ln.startswith("ok") for ln in
                                     out[1][:4])


def test_horizon_clamp_and_single_flight_as_reference(catalogs):
    def script(m, i):
        pods = make_pods(m, 10, seed=4)
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            svc = make_service(m, catalogs[i], pods)
            wide = svc.evaluate(horizon_hours=10 ** 9, hour=9)
            below = svc.evaluate(horizon_hours=-5, hour=9)
            svc._flight.acquire()
            try:
                busy = svc.evaluate(hour=9)
            finally:
                svc._flight.release()
        return (without_walls(wide), without_walls(below), busy,
                svc.busy_rejections)

    j, t = both(script)
    assert t == j
    assert t[0]["horizon_hours"] == SIDES[1].whatif.WHATIF_MAX_HORIZON_HOURS
    assert t[1]["horizon_hours"] == 0 and t[2] is None and t[3] == 1


def test_warm_start_and_expiry_as_reference(catalogs, tmp_path):
    """A restarted service with a cold ring forecasts from the journal's
    snapshot; the snapshot expires once the live ring holds as much."""
    def script(m, i):
        pods = make_pods(m, 20, seed=12)
        path = str(tmp_path / f"{m.pkg}.jsonl")
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            svc = make_service(m, catalogs[i], pods,
                               journal=m.journal.IntentJournal(
                                   path, fsync=False))
            first = svc.evaluate(record=True, hour=9)
        journal = m.journal.IntentJournal(path, fsync=False)
        svc2 = make_service(m, catalogs[i], pods, journal=journal)
        with m.obs.use_ledger(m.ledger.PlacementLedger()):
            warm = svc2.evaluate(hour=9)
        kept = svc2._persisted is not None
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            live = svc2.evaluate(hour=9)
        return (without_walls(first), without_walls(warm), kept,
                without_walls(live), svc2._persisted is None)

    j, t = both(script)
    assert t == j
    assert t[2] and t[4]
    assert "forecast-peak" in [s["scenario"] for s in t[1]["scenarios"]]


def test_journal_writes_only_on_changed_recording_ticks_as_reference(
        catalogs, tmp_path):
    def script(m, i):
        pods = make_pods(m, 10, seed=2)
        journal = m.journal.IntentJournal(str(tmp_path / f"{m.pkg}.jsonl"),
                                          fsync=False)
        counts = []
        with m.obs.use_ledger(seeded_ledger(m, pods, per_hour=1)):
            svc = make_service(m, catalogs[i], pods, journal=journal)
            for record in (False, True, True):
                svc.evaluate(record=record, hour=9)
                counts.append((len(journal.state_map()),
                               journal.stats()["records"]))
        return counts

    j, t = both(script)
    assert t == j
    assert t[0][0] == 0 and t[1][0] > 0 and t[2][1] == t[1][1]


def test_horizon_risk_gauge_hygiene_as_reference(catalogs):
    def script(m, i):
        m.metrics.WHATIF_HORIZON_RISK.reset()
        pods = make_pods(m, 20, seed=13)
        rows = []
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            svc = make_service(m, catalogs[i], pods)
            svc.evaluate(record=True, hour=9)
            rows.append(m.metrics.WHATIF_HORIZON_RISK.samples())
            svc.evaluate(record=True, hour=9, scenario_names=["baseline"])
            rows.append(m.metrics.WHATIF_HORIZON_RISK.samples())
        m.metrics.WHATIF_HORIZON_RISK.reset()
        return rows

    j, t = both(script)
    assert t == j
    assert ("spot-storm",) in t[0] and set(t[1]) == {("baseline",)}


def test_registry_bounded_and_digest_pure_as_reference(catalogs):
    def script(m, i):
        pods = make_pods(m, 30, seed=8)
        sizes = []
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            svc = make_service(m, catalogs[i], pods, registry_cap=3)
            for _ in range(4):
                svc.evaluate(record=True, hour=9)
                sizes.append(len(svc.recommendations()))
        before = without_walls(svc.recommendations())
        digest = svc.digest()
        assert without_walls(svc.recommendations()) == before
        snap = svc.snapshot()
        snap["last"].pop("plan_seconds")
        return sizes, digest, before, snap

    j, t = both(script)
    assert t == j
    assert t[0][-1] == 3


def test_garbage_forecast_is_refused_as_reference(catalogs, monkeypatch):
    """A forecaster that returns negative arrivals: both validators
    refuse the scenarios and nothing reaches either registry."""
    for m in SIDES:
        class Broken(m.forecast.ArrivalForecaster):
            def expected_arrivals(self, horizon_hours, start_hour=0):
                return {sig: -50 for sig in self._counts}

        monkeypatch.setattr(m.service, "ArrivalForecaster", Broken)

    def script(m, i):
        pods = make_pods(m, 30, seed=6)
        with m.obs.use_ledger(seeded_ledger(m, pods)):
            svc = make_service(m, catalogs[i], pods, validate=True)
            payload = svc.evaluate(record=True, hour=9)
        return (without_walls(payload), svc.recommendations(),
                svc.validation_failures)

    j, t = both(script)
    assert t == j
    assert t[0]["validation"]["violations"] and t[1] == [] and t[2] == 1


# -- the controller and the card ----------------------------------------------

def whatif_errors(m) -> dict:
    return {k: v for (c, k), v in m.metrics.ERRORS.samples().items()
            if c == "whatif"}


def moved(before, after):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def test_controller_counts_a_failed_tick_as_reference(catalogs):
    def script(m, i):
        svc = make_service(m, catalogs[i], make_pods(m, 5, seed=9))

        def boom(*a, **k):
            raise RuntimeError("planning exploded")

        svc.evaluate = boom
        before = whatif_errors(m)
        ctrl = m.service.WhatIfController(svc, interval=0.1)
        result = ctrl.reconcile()
        return (moved(before, whatif_errors(m)), svc.last_error,
                result.requeue_after, ctrl.interval, ctrl.name)

    j, t = both(script)
    assert t == j
    assert t[0] == {"RuntimeError": 1.0}


def test_controller_on_the_card_counts_a_fault_once(catalogs, monkeypatch):
    """With the planner on the card (``holds_card`` patched), a fault at
    the ``whatif`` guard site raises out of ``evaluate``; a controller
    tick counts ``ERRORS{whatif, DeviceFaultError}`` once and records
    nothing, no host plan stands in; the next clean tick records."""
    m = SIDES[1]
    monkeypatch.setattr(m.degraded, "holds_card", lambda o: True)
    pods = make_pods(m, 30, seed=3)
    ledger = seeded_ledger(m, pods)
    with m.obs.use_ledger(ledger):
        svc = make_service(m, catalogs[1], pods)
        ctrl = m.service.WhatIfController(svc)
        m.faulttol.install_injector(SiteInjector("whatif"))
        with pytest.raises(m.faulttol.DeviceFaultError):
            svc.evaluate(record=True, hour=9)
        before = whatif_errors(m)
        inj = SiteInjector("whatif")
        m.faulttol.install_injector(inj)
        ctrl.reconcile()
        m.faulttol.clear_injector()
        assert inj.injected == 1
        assert moved(before, whatif_errors(m)) == {"DeviceFaultError": 1.0}
        assert svc.recommendations() == [] and svc.last_error
        assert svc.planner.degraded_plans == 0
        ctrl.reconcile()
    assert svc.recommendations() and svc.last_error == ""
    assert svc.last_payload["backend"] == "device"
    assert moved(before, whatif_errors(m)) == {"DeviceFaultError": 1.0}


def test_service_on_the_card_by_default(catalogs):
    """``PlanningService`` resolves ``device="cuda"`` at construction and
    hands it to the planner it builds; a planner passed in keeps its own
    device."""
    m = SIDES[1]
    pods = make_pods(m, 5)
    svc = make_service(m, catalogs[1], pods)
    assert svc.device == torch.device("cpu")
    assert svc.planner.planner.device == torch.device("cpu")
    planner = m.degraded.ResilientPlanner(planner_device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists here")
    with pytest.raises(RuntimeError, match="CUDA"):
        m.service.PlanningService(StubCluster(pods),
                                  catalog_fn=lambda: catalogs[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        m.service.PlanningService(StubCluster(pods), planner=planner,
                                  catalog_fn=lambda: catalogs[1])
    with pytest.raises(RuntimeError, match="CUDA"):
        m.cli.main(["--demo"])
