"""The port's profiling plane (``karpenter_tpu_torch/obs``) on the CPU,
mirroring tests/test_prof.py and held against the reference where both
can run:

- the sampling cadence (every Nth dispatch per kernel, the first one
  sampled, interval 0 disables), the same decisions as the reference's
  profiler on one dispatch sequence, and the inactive probe's cost;
- probe measurement: the three phases tile the bracketed wall, a
  fetch-free probe copies nothing, a fault inside the bracket is
  swallowed, capture-forced samples stay out of the overhead, and the
  overhead fraction at the default interval stays under 1% on the real
  ``TorchSolver`` path;
- the watchdog: baselines, one rate-limited bundle per breach regime,
  recompile bursts after the grace, a bundle with the reference
  bundle's keys and files, the optional ``torch.profiler`` trace;
- the solve phase spans: the port's window records the reference's
  ``solve.*`` phases.
"""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from karpenter_tpu.chaos.clock import VirtualClock
from karpenter_tpu.obs import prof as j_prof
from karpenter_tpu.obs import watchdog as j_watchdog

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.obs import devtel as t_devtel
from karpenter_tpu_torch.obs import export as t_export
from karpenter_tpu_torch.obs.prof import (
    DEFAULT_INTERVAL, DeviceProfiler, aggregate_samples, get_profiler,
    samples_to_span_dicts,
)
from karpenter_tpu_torch.obs.watchdog import Watchdog, write_triage_bundle
from karpenter_tpu_torch.utils import metrics


@pytest.fixture(autouse=True)
def _reference_observability_untouched(monkeypatch):
    """The reference's process-wide profiler, watchdog and devtel hook as
    they were before each test, and a watchdog of the test's own while it
    runs: a ``JaxSolver`` dispatch here creates the profiler, which hooks
    devtel's recompiles into the watchdog's burst window for the rest of
    the worker's process."""
    from karpenter_tpu.obs import devtel as ref_devtel
    from karpenter_tpu.obs import prof as ref_prof
    from karpenter_tpu.obs import watchdog as ref_watchdog

    tel = ref_devtel.get_devtel()
    monkeypatch.setattr(ref_prof, "_PROFILER", ref_prof._PROFILER)
    monkeypatch.setattr(ref_watchdog, "_WATCHDOG", None)
    monkeypatch.setattr(tel, "recompile_sink", tel.recompile_sink)


def tiny_kernel(x):
    return x * 2 + 1


def dispatch_n(prof, n: int, kernel: str = "toy", fetch: bool = True):
    x = torch.ones(512, dtype=torch.int32)
    actives = 0
    for _ in range(n):
        with prof.sampled(kernel) as probe:
            out = tiny_kernel(x)
            probe.dispatched(out, fetch=fetch)
        actives += 1 if probe else 0
    return actives


# -- cadence ------------------------------------------------------------------

def test_every_nth_dispatch_per_kernel():
    prof = DeviceProfiler(interval=4)
    assert dispatch_n(prof, 16) == 4
    assert dispatch_n(prof, 8, kernel="other") == 2


def test_first_dispatch_is_sampled():
    prof = DeviceProfiler(interval=64)
    assert dispatch_n(prof, 1) == 1
    assert prof.samples == 1


def test_interval_zero_disables():
    prof = DeviceProfiler(interval=0)
    assert dispatch_n(prof, 8) == 0
    assert prof.samples == 0


@pytest.mark.parametrize("interval", [1, 3, 4, 256])
def test_cadence_decisions_equal_the_reference(interval):
    kernels = ["scan", "scan-batch", "scan", "whatif", "scan"] * 120
    tp, jp = DeviceProfiler(interval=interval), \
        j_prof.DeviceProfiler(interval=interval)
    got = [bool(tp.sampled(k)) for k in kernels]
    want = [bool(jp.sampled(k)) for k in kernels]
    assert got == want
    assert tp.dispatches_seen == jp.dispatches_seen == len(kernels)


def test_inactive_fast_path_is_cheap():
    prof = DeviceProfiler(interval=1_000_000)
    prof.sampled("warm")
    t0 = time.perf_counter()
    n = 5000
    for _ in range(n):
        with prof.sampled("warm") as probe:
            probe.dispatched(None)
    per = (time.perf_counter() - t0) / n
    assert per < 50e-6, f"inactive probe cost {per * 1e6:.1f}us"
    assert probe._ev0 is None          # no CUDA event when inactive


def test_reset_keeps_cadence_but_clears_stats():
    prof = DeviceProfiler(interval=4)
    dispatch_n(prof, 6)
    prof.reset()
    assert prof.samples == 0 and prof.dispatches_seen == 0
    assert dispatch_n(prof, 1) == 0
    assert dispatch_n(prof, 2) == 1


# -- measurement ---------------------------------------------------------------

def test_phases_measured_and_metered():
    prof = DeviceProfiler(interval=1)
    before = metrics.PROF_SAMPLES.get("toy")
    x = torch.ones(512, dtype=torch.int32)
    with prof.sampled("toy") as probe:
        out = tiny_kernel(x)
        probe.dispatched(out)
    assert probe.dispatch_s > 0.0
    assert probe.execute_s >= 0.0 and probe.fetch_s >= 0.0
    assert probe.device_s == 0.0            # no card: no device events
    assert prof.samples == 1
    assert metrics.PROF_SAMPLES.get("toy") == before + 1
    snap = prof.snapshot()
    assert snap["kernels"]["toy"]["samples"] == 1
    assert snap["kernels"]["toy"]["dispatch_ms"] > 0.0
    assert set(snap) == set(j_prof.DeviceProfiler(interval=1).snapshot())


def test_phases_tile_the_bracketed_wall():
    prof = DeviceProfiler(interval=1)
    a = torch.ones((256, 256))
    tiny = torch.mm(a, a)                    # warm outside the bracket
    t0 = time.perf_counter()
    with prof.sampled("agree") as probe:
        out = torch.mm(a, tiny)
        probe.dispatched((out, tiny))
    wall = time.perf_counter() - t0
    total = probe.dispatch_s + probe.execute_s + probe.fetch_s
    assert 0.0 < total <= wall
    assert wall - total < 0.05


def test_probe_swallows_faults():
    """A fault inside the bracket never leaves the probe: the caller's
    own fetch raises it again (a CUDA error is sticky)."""
    prof = DeviceProfiler(interval=1)

    class Exploding:
        def __array__(self, *a, **k):
            raise RuntimeError("CUDA error: an illegal memory access")

    with prof.sampled("faulty") as probe:
        probe.dispatched(Exploding())
    assert not probe.active
    assert prof.samples == 0


def test_fetch_false_copies_nothing():
    prof = DeviceProfiler(interval=1)
    assert dispatch_n(prof, 1, kernel="resident-update", fetch=False) == 1
    assert prof._kernels["resident-update"]["fetch_s"] == 0.0
    assert prof.samples == 1


def test_capture_forced_samples_excluded_from_overhead():
    prof = DeviceProfiler(interval=0)
    res: dict = {}
    t = threading.Thread(target=lambda: res.update(s=prof.capture(0.4)))
    t.start()
    time.sleep(0.1)
    dispatch_n(prof, 4)
    t.join()
    assert len(res["s"]) == 4
    assert all("device_s" in s for s in res["s"])
    assert prof.samples == 0 and prof.overhead_s == 0.0
    assert prof.overhead_fraction() == 0.0
    agg = aggregate_samples(res["s"])
    assert agg["toy"]["samples"] == 4
    chrome = t_export.dicts_to_chrome(samples_to_span_dicts(res["s"]))
    assert {e["name"] for e in chrome["traceEvents"]
            if e.get("ph") == "X"} == {"device.dispatch", "device.execute",
                                       "device.fetch"}


def test_overhead_under_one_percent_on_the_real_solver():
    """At the production cadence the profiler's overhead stays under 1%
    of the dispatch wall on ``TorchSolver``'s own dispatch path.  The
    514 small windows run on one intra-op thread: beside the other test
    workers a thread pool per small op slows each window many times
    over."""
    from karpenter_tpu_torch import workload
    from karpenter_tpu_torch.solver import SolveRequest, TorchSolver

    pods, catalog = workload.build_workload(16, 10, seed=4)
    solver = TorchSolver(device="cpu")
    request = SolveRequest(pods, catalog)
    solver.solve(request)
    prof = get_profiler()
    prof.reset()
    prev, threads = prof.interval, torch.get_num_threads()
    prof.interval = DEFAULT_INTERVAL
    torch.set_num_threads(1)
    try:
        for _ in range(2 * DEFAULT_INTERVAL + 2):
            solver.solve(request)
    finally:
        prof.interval = prev
        torch.set_num_threads(threads)
    assert prof.samples >= 2
    frac = prof.overhead_fraction()
    assert 0.0 <= frac < 0.01, f"profiler overhead {frac:.4f}"
    assert prof.snapshot()["overhead_fraction"] == round(frac, 6)


# -- watchdog ------------------------------------------------------------------

def warm(wd, n: int = 10, value: float = 0.010):
    for _ in range(n):
        wd.observe("scan", "execute", value)


def test_no_breach_during_warmup(tmp_path):
    wd = Watchdog(triage_dir=str(tmp_path), warmup=5)
    for _ in range(4):
        assert not wd.observe("scan", "execute", 5.0)
    assert wd.breaches == 0


def test_slow_kernel_fires_once_rate_limited(tmp_path):
    wd = Watchdog(triage_dir=str(tmp_path), rate_limit_s=600.0)
    with VirtualClock().installed():
        warm(wd)
        assert wd.observe("scan", "execute", 0.250)
        for _ in range(5):
            wd.observe("scan", "execute", 0.250)
        assert (wd.bundles, wd.breaches, wd.suppressed) == (1, 6, 5)
        time.sleep(601)
        assert wd.observe("scan", "execute", 0.250)
        assert wd.bundles == 2


def test_breach_does_not_poison_baseline(tmp_path):
    wd = Watchdog(triage_dir=str(tmp_path), rate_limit_s=1e9)
    with VirtualClock().installed():
        warm(wd)
        for _ in range(20):
            wd.observe("scan", "execute", 0.250)
        assert wd.breaches == 20


def test_bundle_fifo_cap(tmp_path):
    wd = Watchdog(triage_dir=str(tmp_path), rate_limit_s=0.0, max_bundles=3)
    with VirtualClock().installed():
        warm(wd)
        for _ in range(7):
            wd.observe("scan", "execute", 0.250)
            time.sleep(1)
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert len(dirs) == 3
    assert wd.last_bundle_path.endswith(dirs[-1])


def test_recompile_burst_after_grace(tmp_path):
    with VirtualClock().installed():
        wd = Watchdog(triage_dir=str(tmp_path))
        for _ in range(wd.RECOMPILE_BURST * 2):
            assert not wd.note_recompile("scan")
        time.sleep(wd.RECOMPILE_GRACE_S + wd.RECOMPILE_WINDOW_S)
        for _ in range(wd.RECOMPILE_BURST - 1):
            assert not wd.note_recompile("scan")
        assert wd.note_recompile("scan")


def test_devtel_recompile_sink_reaches_the_watchdog(monkeypatch):
    from karpenter_tpu_torch.obs import watchdog as t_watchdog

    wd = Watchdog(recompile_grace_s=0.0)
    monkeypatch.setattr(t_watchdog, "_WATCHDOG", wd)
    get_profiler()                          # installs the sink
    tel = t_devtel.get_devtel()
    assert tel.recompile_sink is not None
    tel.note_dispatch("sink-test", (len(wd._recompiles), 1, 2))
    assert len(wd._recompiles) == 1


def test_bundle_has_the_reference_bundle_keys(tmp_path):
    port = Path(write_triage_bundle("slow_kernel", {"kernel": "scan"},
                                    triage_dir=str(tmp_path / "port")))
    ref = Path(j_watchdog.write_triage_bundle(
        "slow_kernel", {"kernel": "scan"}, triage_dir=str(tmp_path / "ref")))
    pm = json.loads((port / "bundle.json").read_text())
    rm = json.loads((ref / "bundle.json").read_text())
    assert sorted(pm) == sorted(rm)
    assert sorted(pm["device_telemetry"]) == sorted(rm["device_telemetry"])
    assert sorted(pm["watchdog"]) == sorted(rm["watchdog"])
    assert sorted(p.name for p in port.iterdir()) == \
        sorted(p.name for p in ref.iterdir())


def test_triage_torch_trace_is_gated(tmp_path, monkeypatch):
    off = Path(write_triage_bundle("t", {}, triage_dir=str(tmp_path / "a")))
    assert not (off / "torch-trace.json").exists()
    monkeypatch.setenv("KARPENTER_TRIAGE_JAX_TRACE", "1")
    on = Path(write_triage_bundle("t", {}, triage_dir=str(tmp_path / "b")))
    assert (on / "torch-trace.json").exists()
    assert json.loads((on / "torch-trace.json").read_text())


# -- the solve phase spans -----------------------------------------------------

def test_solve_phase_spans_match_the_reference():
    import karpenter_tpu.apis.pod as j_pod
    import karpenter_tpu.apis.requirements as j_req
    from karpenter_tpu import obs as j_obs
    from karpenter_tpu.solver import JaxSolver, SolverOptions, encode

    import karpenter_tpu_torch.apis.pod as t_pod
    import karpenter_tpu_torch.apis.requirements as t_req
    from karpenter_tpu_torch import carry
    from karpenter_tpu_torch.solver import TorchSolver
    from karpenter_tpu_torch.solver import encode as t_encode
    from karpenter_tpu.catalog import (
        CatalogArrays, InstanceTypeProvider, PricingProvider,
    )
    from karpenter_tpu.cloud.fake import FakeCloud
    from tests.test_torch_solver import build_pods, mixed_specs

    cloud = FakeCloud()
    pricing = PricingProvider(cloud)
    jcat = CatalogArrays.build(InstanceTypeProvider(cloud, pricing).list())
    pricing.close()
    tcat = carry.catalog_from_numpy(
        **{f: getattr(jcat, f) for f in carry.CATALOG_FIELDS})
    specs = mixed_specs(30, 9)
    phases = {}
    for side, mod, req, cat, enc, solver, o in (
            ("ref", j_pod, j_req, jcat, encode,
             JaxSolver(SolverOptions(use_pallas="off")), j_obs),
            ("port", t_pod, t_req, tcat, t_encode, TorchSolver(device="cpu"),
             obs)):
        o.reset_recorder()
        with o.span("window"):
            solver.solve_encoded(enc(build_pods(specs, mod, req), cat))
        phases[side] = sorted(o.phase_durations("solve."))
    assert phases["port"] == phases["ref"]
    assert {"solve.encode", "solve.h2d", "solve.compute",
            "solve.d2h"} <= set(phases["port"])
    assert np.all([d >= 0 for ds in obs.phase_durations().values()
                   for d in ds])
