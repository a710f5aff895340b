"""The port's fault plane (``karpenter_tpu_torch/faulttol``) against the
reference's (``karpenter_tpu/faulttol``), on the CPU: the health board,
the injector and the guard.  The solver's sites, devtel parity, the
batch's OOM halving, the AOT manifest and warmup are in
``tests/test_torch_faulttol_sites.py``, which shares the helpers here.

- the health boards of both packages driven through one scripted list of
  faults, successes, clock advances and probe results: equal states,
  transitions and fault counts after every step;
- ``FaultyDeviceInjector`` of both packages on one ``random.Random(seed)``
  stream: identical (kind, victim) schedules over 1000 draws;
- ``device_guard``: injected error, hang, OOM and corrupt typed as the
  reference types them, a fetch-free corrupt as an error, a quarantined
  device refused before launch, a ``ValueError`` passed through
  unrecorded, and what only the port sees (a hand kernel's
  ``KernelLaunchError``, an allocator ``torch.cuda.OutOfMemoryError``,
  torch's CUDA error) typed as ``DeviceFaultError`` /
  ``DeviceResourceExhausted``; selecting the card builds the kernels
  before any guard opens.
"""

from __future__ import annotations

import random

import numpy as np
import pytest
import torch

import karpenter_tpu.faulttol as jft
from karpenter_tpu.faulttol import health as j_health

import karpenter_tpu_torch.faulttol as tft
from karpenter_tpu_torch import cuda_build
from karpenter_tpu_torch.cuda_build import KernelLaunchError
from karpenter_tpu_torch.faulttol import health as t_health
from karpenter_tpu_torch.obs import devtel as t_devtel

PKGS = {"ref": (jft, j_health), "port": (tft, t_health)}


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


@pytest.fixture(autouse=True)
def _pristine_faulttol():
    for ft, _ in PKGS.values():
        ft.clear_injector()
        ft.get_health_board().reset()
    yield
    for ft, health in PKGS.values():
        ft.clear_injector()
        ft.get_health_board().reset()
        health._BOARD = None


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class ScriptedInjector:
    """Per-dispatch fault script (None = clean), duck-typing the
    injector at the guard seam, as in tests/test_faulttol.py."""

    def __init__(self, script):
        self.script = list(script)
        self.injected = 0

    def draw(self, kernel, candidates):
        if not self.script:
            return None
        entry = self.script.pop(0)
        if entry is None:
            return None
        self.injected += 1
        return entry, candidates[0]

    def probe_faults(self, device):
        return False

    corrupt = staticmethod(tft.FaultyDeviceInjector.corrupt)


class Recorder(ScriptedInjector):
    """Injects nothing; records the kernel name of every guarded
    dispatch and the devices it names."""

    def __init__(self):
        super().__init__([])
        self.kernels: list[str] = []
        self.devices: set[str] = set()

    def draw(self, kernel, candidates):
        self.kernels.append(kernel)
        self.devices.update(candidates)
        return None


def make_board(pkg, clock, probe_runner=None):
    ft, health = PKGS[pkg]
    board = ft.HealthBoard(clock=clock, probe_runner=probe_runner,
                           triage_writer=lambda *a, **k: None)
    health._BOARD = board
    return board


# -- health board parity ------------------------------------------------------

BOARD_SCRIPT = [
    ("fault", "cpu:0", "error", "scan"),          # healthy -> suspect
    ("success", "cpu:0"),                         # -> healthy
    ("fault", "cpu:0", "error", "scan"),
    ("advance", 400.0),                           # the fault ages out
    ("fault", "cpu:0", "deadline", "scan"),
    ("fault", "cpu:0", "oom", "scan-batch"),
    ("fault", "cpu:0", "error", "resident"),      # 3 in window: quarantine
    ("fault", "cpu:1", "corrupt", "whatif"),
    ("fault", "cpu:0", "error", "scan"),          # raced the quarantine
    ("tick",),
    ("advance", 61.0), ("tick",),                 # probation, probe ok
    ("advance", 61.0), ("tick",),                 # probe fails: quarantine
    ("advance", 30.0), ("tick",),                 # still quarantined
    ("advance", 31.0), ("tick",),                 # probation, probe ok
    ("advance", 61.0), ("tick",),                 # probe ok: healthy
    ("success", "cpu:1"),
    ("fault", "cpu:1", "hang", "sharded-solve"),
    ("fault", "cpu:1", "deadline", "sharded-fetch"),
    ("fault", "cpu:1", "error", "rebalance"),     # cpu:1 quarantined
    ("advance", 60.0), ("tick",),
    ("advance", 60.0), ("tick",),
]
PROBES = [True, False, True, True, True, True, True, True]


def _board_view(board):
    snap = board.snapshot()
    return ({d: dict(v) for d, v in snap["devices"].items()},
            snap["faults_recorded"], snap["guards_entered"],
            snap["last_failover_reason"], board.quarantined_ids())


def test_health_boards_walk_the_same_script():
    views = {}
    for pkg in PKGS:
        clock = FakeClock()
        probes = list(PROBES)
        board = make_board(pkg, clock, probe_runner=lambda d: probes.pop(0))
        seq = []
        for step in BOARD_SCRIPT:
            if step[0] == "fault":
                board.record_fault(step[1], kind=step[2], kernel=step[3])
            elif step[0] == "success":
                board.record_success(step[1])
            elif step[0] == "advance":
                clock.advance(step[1])
            else:
                board.tick()
            seq.append(_board_view(board))
        views[pkg] = seq
    assert views["port"] == views["ref"]
    states = [{d: v["state"] for d, v in s[0].items()} for s in views["ref"]]
    # the script walks every state on both devices
    seen = {st for s in states for st in s.values()}
    assert seen == {"healthy", "suspect", "quarantined", "probation"}


def test_port_probe_runs_on_the_cpu():
    board = make_board("port", FakeClock())
    assert board._run_probe("cpu:0") is True
    assert t_health.device_ids([torch.device("cpu")]) == ["cpu:0"]
    assert t_health.device_id("cuda") == "cuda:0"


# -- injector parity ----------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_injector_schedules_are_identical(seed):
    rates = {"hang": 0.05, "error": 0.07, "oom": 0.03, "corrupt": 0.04}
    cands = ["cpu:0", "cpu:1", "cpu:2"]
    kernels = ["scan", "scan-batch", "resident", "whatif"]
    seqs = {}
    for pkg, (ft, _) in PKGS.items():
        inj = ft.FaultyDeviceInjector(random.Random(seed), rates)
        seq = []
        for i in range(1000):
            seq.append(inj.draw(kernels[i % 4],
                                cands[:1 + i % 3]))
            if i % 10 == 9:
                seq.append(("probe", inj.probe_faults("cpu:0")))
        seqs[pkg] = (seq, inj.injected)
    assert seqs["port"] == seqs["ref"]
    assert seqs["ref"][1] > 50


# -- the guard ----------------------------------------------------------------

def _guard_run(pkg, kind, fetch=True):
    """One guarded dispatch in ``pkg`` with ``kind`` injected: (error
    class name, error kind, fetched copy, faults recorded, state)."""
    ft, _ = PKGS[pkg]
    board = make_board(pkg, FakeClock())
    ft.install_injector(ScriptedInjector([kind]))
    out = (np.arange(4, dtype=np.int32) if pkg == "ref"
           else torch.arange(4, dtype=torch.int32))
    err = got = None
    try:
        with ft.device_guard("scan", devices=["cpu:0"]) as guard:
            if fetch:
                got = guard.fetch(out)
    except ft.DeviceFaultError as e:
        err = e
    return (type(err).__name__ if err else None,
            err.kind if err else None,
            None if got is None else got.tolist(), board.faults_recorded,
            board.state("cpu:0"))


@pytest.mark.parametrize("kind,fetch,want", [
    ("error", True, "DeviceFaultError"),
    ("hang", True, "DispatchDeadlineExceeded"),
    ("oom", True, "DeviceResourceExhausted"),
    ("corrupt", True, None),
    ("corrupt", False, "DeviceFaultError"),
    ("error", False, "DeviceFaultError"),
])
def test_guard_types_injected_faults_as_the_reference(kind, fetch, want):
    ref = _guard_run("ref", kind, fetch)
    port = _guard_run("port", kind, fetch)
    assert port == ref
    assert port[0] == want
    # a corrupt fetch is recorded, then the clean exit heals the suspect
    assert port[3] == 1
    assert port[4] == ("healthy" if kind == "corrupt" and fetch
                       else "suspect")
    if kind == "corrupt" and fetch:
        assert port[2][0] == np.iinfo(np.int32).min and port[2][1:] == \
            [1, 2, 3]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_guard_refuses_quarantined_device_before_launch(pkg):
    ft, _ = PKGS[pkg]
    board = make_board(pkg, FakeClock())
    for _ in range(3):
        board.record_fault("cpu:0", kind="error", kernel="scan")
    ran = []
    with pytest.raises(ft.DeviceQuarantinedError):
        with ft.device_guard("scan", devices=["cpu:0"]):
            ran.append(1)
    assert ran == []


@pytest.mark.parametrize("pkg", list(PKGS))
def test_guard_passes_value_error_unrecorded(pkg):
    ft, _ = PKGS[pkg]
    board = make_board(pkg, FakeClock())
    with pytest.raises(ValueError):
        with ft.device_guard("scan", devices=["cpu:0"]):
            raise ValueError("meta must be int32 [C, G, 8]")
    assert board.faults_recorded == 0
    assert board.state("cpu:0") == "healthy"


@pytest.mark.parametrize("exc,want,kind", [
    (KernelLaunchError("ffd_scan", 1, "invalid argument"),
     tft.DeviceFaultError, "error"),
    (KernelLaunchError("cost_word", 2, "out of memory"),
     tft.DeviceResourceExhausted, "oom"),
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"),
     tft.DeviceResourceExhausted, "oom"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     tft.DeviceFaultError, "error"),
    (getattr(torch, "AcceleratorError", RuntimeError)(
        "CUDA error: unspecified launch failure"),
     tft.DeviceFaultError, "error"),
])
def test_guard_types_cuda_failures(exc, want, kind):
    board = make_board("port", FakeClock())
    with pytest.raises(want) as info:
        with tft.device_guard("scan", devices=["cpu:0"]):
            raise exc
    assert type(info.value) is want
    assert info.value.kind == kind and info.value.__cause__ is exc
    assert board.faults_recorded == 1
    assert board.snapshot()["devices"]["cpu:0"]["last_kind"] == kind


def test_guard_fetch_failure_is_a_device_fault():
    board = make_board("port", FakeClock())

    class Broken:
        def synchronize(self):
            raise RuntimeError("CUDA error: misaligned address")

    with pytest.raises(tft.DeviceFaultError):
        with tft.device_guard("serving-fetch", devices=["cpu:0"]) as g:
            g.fetch(torch.zeros(2), event=Broken())
    assert board.faults_recorded == 1


def test_guard_builds_kernels_outside_its_window(monkeypatch):
    """Selecting the card builds every kernel once, before any guard
    opens: a build that takes longer than the cold deadline floor lands
    in no guard's window and faults nothing, and a guard on a CUDA
    device builds nothing itself."""
    import time as time_mod

    from karpenter_tpu_torch.device import resolve_device

    board = make_board("port", FakeClock())
    clock = FakeClock(5000.0)
    monkeypatch.setattr(time_mod, "monotonic", clock)
    builds = []

    def slow_build(names=cuda_build.KERNEL_SOURCES):
        builds.append(clock())
        clock.advance(600.0)       # ten minutes of nvcc, on this clock
        return {}

    monkeypatch.setattr(cuda_build, "build_all", slow_build)
    monkeypatch.setattr(cuda_build, "_ready", False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for _ in range(3):
        assert resolve_device("cuda") == torch.device("cuda", 0)
    assert len(builds) == 1
    monkeypatch.setattr(cuda_build, "_ready", False)
    for _ in range(3):
        with tft.device_guard("scan", devices=["cuda:0"]) as guard:
            assert guard._t0 >= builds[0] + 600.0
    assert len(builds) == 1
    assert board.faults_recorded == 0
    assert board.guard_overhead_s < 1.0


def test_cpu_guard_has_no_wall_deadline_but_an_explicit_one_fires():
    make_board("port", FakeClock())
    with tft.device_guard("scan", devices=["cpu:0"]) as guard:
        pass
    assert guard._deadline_s == float("inf")
    with pytest.raises(tft.DispatchDeadlineExceeded):
        with tft.device_guard("scan", devices=["cpu:0"],
                              deadline_s=0.0) as guard:
            guard.fetch(torch.zeros(3))


def test_guard_issues_no_dispatch_of_its_own():
    make_board("port", FakeClock())
    before = t_devtel.get_devtel().snapshot()["dispatches"]
    for _ in range(50):
        with tft.device_guard("t", devices=["cpu:0"]) as guard:
            guard.fetch(torch.zeros(8, dtype=torch.int32))
    assert t_devtel.get_devtel().snapshot()["dispatches"] == before
