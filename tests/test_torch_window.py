"""The port's solve window, circuit breaker, explain registry and SLO
evaluation against the reference's, on the CPU.

``utils/batcher.py``, ``core/window.py``, ``core/circuitbreaker.py``,
``obs/slo.py`` and the registry half of ``explain/__init__.py`` are
copies of the reference's modules.  Each test runs the same call script
through both packages.  The batcher's window clock is frozen (its
``time`` module is swapped for a scripted one), so a window fires on
its item count, its idle timeout or its age only when the script says
so; the real waits stay at most 50 ms.
"""

import time

import numpy as np
import pytest

from karpenter_tpu import explain as j_explain
from karpenter_tpu import obs as j_obs
from karpenter_tpu.core import circuitbreaker as j_cb
from karpenter_tpu.core import window as j_window
from karpenter_tpu.obs import slo as j_slo
from karpenter_tpu.obs.ledger import PlacementLedger as JLedger
from karpenter_tpu.solver import JaxSolver, SolverOptions
from karpenter_tpu.solver import SolveRequest as JRequest
from karpenter_tpu.utils import batcher as j_batcher
from karpenter_tpu.utils import metrics as j_metrics

import bench
from karpenter_tpu_torch import explain as t_explain
from karpenter_tpu_torch import obs as t_obs
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.core import circuitbreaker as t_cb
from karpenter_tpu_torch.core import window as t_window
from karpenter_tpu_torch.obs import slo as t_slo
from karpenter_tpu_torch.obs.ledger import PlacementLedger as TLedger
from karpenter_tpu_torch.solver import SolveRequest, TorchSolver
from karpenter_tpu_torch.utils import batcher as t_batcher
from karpenter_tpu_torch.utils import metrics as t_metrics

SIDES = (
    (j_batcher, j_window, j_obs, JLedger, j_cb, j_metrics),
    (t_batcher, t_window, t_obs, TLedger, t_cb, t_metrics),
)


class FrozenTime:
    """The batcher module's ``time``: ``monotonic`` reads the script's
    clock, everything else is the real module."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def monotonic(self) -> float:
        return self.t

    def __getattr__(self, name):
        return getattr(time, name)


@pytest.fixture
def frozen(monkeypatch):
    clocks = []
    for batcher_mod, *_ in SIDES:
        clock = FrozenTime()
        monkeypatch.setattr(batcher_mod, "time", clock)
        clocks.append(clock)
    return clocks


def _opts(batcher_mod, **kw):
    base = dict(idle_timeout=0.02, max_timeout=0.05, max_items=4,
                name="window-test")
    base.update(kw)
    return batcher_mod.BatcherOptions(**base)


def _settle():
    """Long enough for the window loop to evaluate a frozen clock (its
    waits are at most the 50 ms window)."""
    time.sleep(0.06)


def _fire_script(batcher_mod, clock):
    batches = []
    b = batcher_mod.Batcher(lambda items: batches.append(list(items))
                            or [i.upper() for i in items],
                            _opts(batcher_mod))
    try:
        # (1) the item count: with the clock frozen nothing else can fire
        futs = [b.add(x) for x in ("a", "b", "c", "d")]
        got = [f.result(timeout=5) for f in futs]
        # (2) idle: two items 10 ms apart; the window waits 20 ms of quiet
        e = b.add("e")
        clock.t = 0.01
        f = b.add("f")
        clock.t = 0.025
        _settle()
        idle_early = e.done() or f.done()
        clock.t = 0.031
        got += [e.result(timeout=5), f.result(timeout=5)]
        # (3) the age cap: each add keeps the window from going idle
        clock.t = 1.0
        late = [b.add("g")]
        for t, x in ((1.018, "h"), (1.035, "i")):
            clock.t = t
            late.append(b.add(x))
        clock.t = 1.049
        _settle()
        max_early = any(f.done() for f in late)
        clock.t = 1.051                # born + 50 ms; idle would be 1.055
        got += [f.result(timeout=5) for f in late]
    finally:
        b.close()
    return batches, got, idle_early, max_early


def test_batcher_fires_at_count_idle_and_age(frozen):
    outs = [_fire_script(mod, clock)
            for (mod, *_), clock in zip(SIDES, frozen)]
    assert outs[0] == outs[1]
    batches, got, idle_early, max_early = outs[1]
    assert batches == [["a", "b", "c", "d"], ["e", "f"], ["g", "h", "i"]]
    assert got == ["A", "B", "C", "D", "E", "F", "G", "H", "I"]
    assert not idle_early and not max_early


def _error_script(batcher_mod):
    out = []
    for handler in (lambda items: 1 / 0,
                    lambda items: ["only one"],
                    lambda items: None):
        b = batcher_mod.Batcher(handler, _opts(batcher_mod, max_items=2))
        try:
            futs = [b.add(x) for x in ("p", "q")]
            errs = []
            for f in futs:
                with pytest.raises(Exception) as ei:
                    f.result(timeout=5)
                errs.append((type(ei.value).__name__, str(ei.value)))
            out.append(errs)
        finally:
            b.close()
    return out


def test_batcher_handler_errors_reach_every_caller():
    j, t = _error_script(j_batcher), _error_script(t_batcher)
    assert j == t
    assert t[0] == [("ZeroDivisionError", "division by zero")] * 2
    assert t[1] == [("ValueError", "batch handler returned 1 results for "
                                   "2 items")] * 2
    assert t[2][0] == ("ValueError", "batch handler returned 0 results "
                                     "for 2 items")


def _close_script(batcher_mod):
    calls = []
    b = batcher_mod.Batcher(lambda items: calls.append(len(items)) or
                            list(items), _opts(batcher_mod, max_items=10))
    pending = [b.add(x) for x in ("x", "y")]
    b.close()
    out = []
    for f in pending:
        with pytest.raises(RuntimeError) as ei:
            f.result(timeout=5)
        out.append(str(ei.value))
    with pytest.raises(RuntimeError, match="batcher closed"):
        b.add("z")
    return out, calls


def test_batcher_close_flushes_pending_callers(frozen):
    j, t = _close_script(j_batcher), _close_script(t_batcher)
    assert j == t
    assert t == (["batcher closed", "batcher closed"], [])


def _window_ledger_script(window_mod, obs_mod, ledger_cls, pods):
    ledger = ledger_cls(max_open=64)
    with obs_mod.use_ledger(ledger):
        for p in pods:
            ledger.first_seen(pod_key(p))
        seen = []
        win = window_mod.SolveWindow(
            lambda batch: seen.append(len(batch)) or
            [p.name.upper() for p in batch],
            window_mod.WindowOptions(idle_seconds=0.02, max_seconds=0.05,
                                     max_pods=len(pods)))
        try:
            got = [f.result(timeout=5) for f in win.add_all(pods)]
        finally:
            win.close()
        recs = [ledger.get(pod_key(p)) for p in pods]
    opts = window_mod.WindowOptions()
    return (seen, got, [r.stamp_names() for r in recs],
            len({r.trace_id for r in recs}), min(r.trace_id for r in recs),
            (opts.idle_seconds, opts.max_seconds, opts.max_pods),
            opts.to_batcher().name, opts.to_batcher().max_items)


@pytest.fixture(scope="module")
def five_pods():
    """Built before the window clock is frozen (the catalog's pricing
    batcher runs on the same module clock)."""
    return workload.build_workload(5, 4, seed=3)[0]


def test_solve_window_stamps_and_links_the_ledger(five_pods, frozen):
    pods = five_pods
    outs = [_window_ledger_script(win, o, led, pods)
            for _, win, o, led, *_ in SIDES]
    assert outs[0][:4] == outs[1][:4] and outs[0][5:] == outs[1][5:]
    seen, got, stamps, trace_ids, first_trace, defaults, name, cap = outs[1]
    assert seen == [5] and got == [p.name.upper() for p in pods]
    assert stamps == [["first_seen", "window_enqueue"]] * 5
    assert trace_ids == 1 and first_trace > 0
    assert defaults == (1.0, 10.0, 10000) and name == "solve-window"
    assert cap == 10000


def node_names(plan, pods):
    """Each pod's node, named by its place in the plan, or None."""
    where = {}
    for i, n in enumerate(plan.nodes):
        for name in n.pod_names:
            where[name] = f"{n.instance_type}/{n.zone}/{n.capacity_type}#{i}"
    return [where.get(pod_key(p)) for p in pods]


def test_solve_window_through_both_solvers():
    """One window of 300 pods through each package's ``SolveWindow`` and
    solver: each pod's future resolves to the node the direct plan gives
    it, and the two packages agree."""
    tpods, tcat = workload.build_workload(300, 20, seed=11)
    jpods, jcat = bench.build_workload(300, 20, seed=11)
    out = []
    for (_, window_mod, *_), pods, solve in (
            (SIDES[0], jpods, lambda ps: JaxSolver(SolverOptions(
                use_pallas="off")).solve(JRequest(ps, jcat))),
            (SIDES[1], tpods, lambda ps: TorchSolver(device="cpu").solve(
                SolveRequest(ps, tcat)))):
        fired = []

        def on_window(batch, solve=solve):
            fired.append(len(batch))
            return node_names(solve(list(batch)), batch)

        # the window fires at its count: a loaded host stalls the adds
        # past a short idle or max, which splits the window
        win = window_mod.SolveWindow(on_window, window_mod.WindowOptions(
            idle_seconds=60.0, max_seconds=60.0, max_pods=len(pods)))
        try:
            got = [f.result(timeout=120) for f in win.add_all(pods)]
        finally:
            win.close()
        out.append((fired, got, node_names(solve(pods), pods)))
    assert out[0] == out[1]
    fired, got, direct = out[1]
    assert fired == [300] and got == direct and None not in got


# -- the circuit breaker -------------------------------------------------------

def _cb_script(cb_mod, metrics):
    clock = [0.0]
    cfg = cb_mod.CircuitBreakerConfig(
        failure_threshold=2, failure_window=120.0, recovery_timeout=100.0,
        half_open_max_requests=1, rate_limit_per_minute=3,
        max_concurrent_instances=2)
    cb = cb_mod.CircuitBreaker(cfg, clock=lambda: clock[0],
                               key=("nc-a", "us-south"))
    out = []

    def attempt(label):
        try:
            cb.can_provision()
            out.append((label, "ok", cb.state))
            return True
        except cb_mod.CircuitBreakerOpenError as e:
            out.append((label, str(e), e.key, e.reason, cb.state))
            return False

    def gauge():
        out.append(metrics.CB_STATE.get("nc-a", "us-south"))

    gauge()
    attempt("1")
    attempt("2")
    attempt("concurrency")         # two in flight
    cb.record_success()
    cb.record_failure("boom")
    gauge()
    attempt("rate")                # 3 per minute spent
    clock[0] = 61.0
    attempt("3")
    cb.record_failure("boom")      # second failure in the window: OPEN
    gauge()
    attempt("open")
    clock[0] = 161.0
    attempt("probe")               # recovery: HALF_OPEN, one probe
    gauge()
    attempt("probe budget")
    cb.record_failure("again")     # a failed probe re-opens
    gauge()
    clock[0] = 262.0
    attempt("probe 2")
    cb.record_success()            # a good probe closes
    gauge()
    out.append(cb.state)
    return out


def test_circuit_breaker_state_machine_matches_reference():
    j = _cb_script(j_cb, j_metrics)
    t = _cb_script(t_cb, t_metrics)
    assert j == t
    assert [x for x in t if isinstance(x, float)] == [0.0, 0.0, 1.0, 2.0,
                                                      1.0, 0.0]
    assert t[-1] == "CLOSED"


def _manager_script(cb_mod, metrics):
    clock = [0.0]
    m = cb_mod.CircuitBreakerManager(cb_mod.CircuitBreakerConfig(
        failure_threshold=1), clock=lambda: clock[0])
    m.can_provision("a", "r1")
    m.record_failure("a", "r1", "x")
    m.can_provision("b", "r1")
    m.record_success("b", "r1")
    states = dict(m.states())
    with pytest.raises(cb_mod.CircuitBreakerOpenError):
        m.can_provision("a", "r1")
    clock[0] = 4000.0
    dropped = m.cleanup()          # b idle and closed; a stays (open)
    env = {"CIRCUIT_BREAKER_FAILURE_THRESHOLD": "7",
           "CIRCUIT_BREAKER_RATE_LIMIT_PER_MINUTE": "lots",
           "CIRCUIT_BREAKER_ENABLED": "FALSE"}
    cfg = cb_mod.CircuitBreakerConfig.from_env(env)
    off = cb_mod.CircuitBreaker(cfg, key=("off", "r"))
    for _ in range(10):
        off.can_provision()
        off.record_failure()
    return (states, dropped, sorted(m.states()), m.config.failure_threshold,
            cfg, off.state, metrics.CB_STATE.samples().get(("b", "r1")),
            metrics.CB_STATE.get("a", "r1"))


def test_circuit_breaker_manager_and_env_match_reference():
    j = _manager_script(j_cb, j_metrics)
    t = _manager_script(t_cb, t_metrics)
    assert repr(j) == repr(t).replace("karpenter_tpu_torch", "karpenter_tpu")
    states, dropped, left, _, cfg, off_state, b_series, a_gauge = t
    assert states == {("a", "r1"): "OPEN", ("b", "r1"): "CLOSED"}
    assert dropped == 1 and left == [("a", "r1")] and b_series is None
    assert cfg.failure_threshold == 7 and cfg.rate_limit_per_minute == 2
    assert not cfg.enabled and off_state == "CLOSED" and a_gauge == 1.0


# -- the explain registry ------------------------------------------------------

def _explain_script(ex, metrics):
    r = ex.ExplainRegistry(capacity=3)
    out = [r.note("p1", ex.word_for("insufficient_cpu"), "",
                  detail="cpu", nearest={"offering": 4}, trace_id=9),
           r.note("p1", ex.word_for("insufficient_cpu"), ""),
           r.stamp("p1", "gang_parked", detail="parked"),
           # a fresh solve verdict keeps the plane's bit
           r.note("p1", ex.word_for("taints"), "taints", merge=False),
           r.note("p2", ex.word_for("capacity_exhausted"), "",
                  trace_id=3),
           r.note("p3", 0, "")]
    r.clear_bits("p1", "gang_parked")
    out.append(r.get("p1").reason)
    r.note("p4", ex.word_for("zone_blackout", "availability"), "")
    out.append(r.get("p1") is None)             # evicted at capacity 3
    r.stamp("p2", "preemption_budget")
    r.clear_bits("p2", "preemption_budget", "capacity_exhausted")
    out.append(r.get("p2") is None)             # an emptied word drops
    out.append(r.summary())
    r.update_unplaced_gauge()
    out.append({reason: metrics.UNPLACED_PODS.get(reason)
                for reason in ex.CANONICAL_REASONS})
    out.append([{k: v for k, v in e.to_dict().items() if k != "updated_at"}
                for e in sorted(r.entries(), key=lambda e: e.pod)])
    r.resolve("p3")
    out.append((len(r.entries()), r.stamped_total))
    r.clear()
    out.append((r.entries(), r.stamped_total, ex.get_registry() is
                ex.get_registry()))
    out.append((sorted(ex.DEVICE_BITS), ex.PLANE_REASONS,
                ex.word_names(ex.word_for("taints", "spread_bound"))))
    return out


def test_explain_registry_call_script_matches_reference():
    j = _explain_script(j_explain, j_metrics)
    t = _explain_script(t_explain, t_metrics)
    assert j == t
    assert t[:6] == [True, False, True, False, True, True]
    assert t[6] == "taints" and t[7] and t[8]
    assert t[9] == {"capacity_exhausted": 1, "zone_blackout": 1}


# -- SLOs ----------------------------------------------------------------------

def _slo_inputs(slo):
    m = slo.Measurement
    return {
        "pod_placement_p99_s": m(value=12.0, samples=[
            (90.0, 1.0), (95.0, 50.0), (99.0, 2.0), (10.0, 99.0)],
            violators=[{"pod": "a/b", "duration_s": 50.0, "trace_id": 7}]),
        "pending_staleness_s": m(value=9000.0),
        "degraded_rate": m(value=0.1),
        "recorder_overhead_us": m(value=80.0),
    }


def test_quantile_and_evaluate_slos_match_reference():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0, 0.5, 9.0]
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert j_slo.quantile(xs, q) == t_slo.quantile(xs, q)
    assert t_slo.quantile([], 0.99) == 0.0
    reports = []
    for slo in (j_slo, t_slo):
        specs = list(slo.DEFAULT_SOAK_SLOS) + [
            slo.BROKEN_FIXTURE_SLO,
            slo.SLOSpec("fill", "telemetry_min_fill_fraction", 0.05,
                        comparison="ge")]
        rep = slo.evaluate_slos(specs, _slo_inputs(slo), at=100.0)
        reports.append((rep.to_dict(), rep.render(), rep.ok,
                        [r.spec.name for r in rep.burned]))
    assert reports[0] == reports[1]
    burned = reports[1][3]
    # the missing objectives burn loudly, as do the over-threshold ones
    assert burned == ["pending-staleness", "recorder-overhead",
                      "recorder-drops", "broken-fixture", "fill"]


def _ledger_script(ledger_cls, slo, obs_mod):
    ledger = ledger_cls(capacity=16, error_capacity=8)
    t0 = 1000.0
    for i in range(6):
        ledger.first_seen(f"ns/p{i}", t=t0 + i)
        ledger.stamp(f"ns/p{i}", "window_enqueue", t=t0 + i + 0.5)
    ledger.solve_start([f"ns/p{i}" for i in range(6)], t=t0 + 8)
    ledger.plan_decoded([f"ns/p{i}" for i in range(6)], t=t0 + 9)
    for i, outcome in enumerate(("placed", "placed", "placed_degraded",
                                 "placed", "released", "placed")):
        ledger.resolve(f"ns/p{i}", outcome, t=t0 + 10 + i * i, trace_id=i)
    meas = slo.ledger_measurements(ledger, measure_overhead=False,
                                   threshold_hint=20.0)
    rep = slo.evaluate_slos(list(slo.DEFAULT_SOAK_SLOS), meas, at=t0 + 40)
    summary = slo.slo_summary(ledger)
    rec = obs_mod.get_recorder()
    with_rec = slo.ledger_measurements(ledger, recorder=rec,
                                       measure_overhead=False)
    return ({k: (v.value, v.samples, v.violators) for k, v in meas.items()},
            rep.to_dict(), summary, sorted(with_rec))


def test_ledger_measurements_match_reference():
    j = _ledger_script(JLedger, j_slo, j_obs)
    t = _ledger_script(TLedger, t_slo, t_obs)
    assert j == t
    meas, _, summary, keys = t
    assert meas["degraded_rate"][0] == pytest.approx(2 / 6)
    # durations 10 + i * i - i: the slowest, p5, took 30 s
    assert meas["pod_placement_p99_s"][0] == 30.0
    assert summary["resolved"] == 6
    assert "recorder_dropped_fraction" in keys


def test_telemetry_measurements_after_the_same_windows(monkeypatch):
    """Nine small windows through each package's solver: the telemetry
    ring's SLO measurements agree (the scan plane passes the 8-window
    floor, so the fill fraction is measured, not the default)."""
    out = []
    for obs_mod, slo, solve in (
            (j_obs, j_slo, lambda pods, cat: JaxSolver(SolverOptions(
                use_pallas="off")).solve(JRequest(pods, cat))),
            (t_obs, t_slo, lambda pods, cat: TorchSolver(
                device="cpu").solve(SolveRequest(pods, cat)))):
        saved = obs_mod.get_tracer().recorder
        obs_mod.reset_recorder()
        try:
            for seed in range(9):
                build = bench.build_workload if obs_mod is j_obs \
                    else workload.build_workload
                pods, cat = build(60 + 10 * seed, 12, seed=seed)
                solve(pods, cat)
            meas = slo.telemetry_measurements()
        finally:
            obs_mod.get_tracer().recorder = saved
        out.append({k: (v.value, v.violators) for k, v in meas.items()})
    assert out[0] == out[1]
    assert sorted(out[1]) == ["telemetry_escalations_per_window",
                              "telemetry_min_fill_fraction"]
    fill = out[1]["telemetry_min_fill_fraction"]
    assert 0.0 < fill[0] < 1.0 and fill[1]
    assert np.isfinite(out[1]["telemetry_escalations_per_window"][0])
