"""Per-device health state machine: healthy -> suspect -> quarantined
-> probation -> healthy (port of ``karpenter_tpu/faulttol/health.py``).

The cloud circuit breaker (core/circuitbreaker.py) is the template:
a sliding window of fault timestamps, a threshold that opens the
breaker (quarantine), a recovery timeout that admits probes, and a
consecutive-success budget that closes it again.  Differences that
matter here:

- the protected resource is a *chip*, so quarantine gates dispatch
  ADMISSION (``device_guard`` raises ``DeviceQuarantinedError`` before
  the kernel launches) instead of failing calls after the fact;
- probation is driven by a cheap *probe solve* — ``arange(8) + 1`` on
  the quarantined device, read back — not by letting production traffic
  through: a flapping chip never sees a real window until it has paid
  ``probe_successes`` consecutive green probes;
- every transition INTO quarantined writes a watchdog triage bundle
  (obs/watchdog.py): by the time a human looks, the flight recorder
  window that caught the fault is already on disk.

All timestamps come from ``time.monotonic`` READ AT CALL TIME so the
chaos harness's virtual clock drives recovery timing deterministically;
only RELATIVE comparisons are ever made (the virtual clock starts at
the real monotonic value).  The board is process-global (one health
truth across solver/resident/sharded dispatch sites) and lock-protected;
``reset()`` restores a pristine board for scenario isolation.

Device ids are ``f"{dev.type}:{dev.index or 0}"`` of a ``torch.device``:
``cuda:0`` on the card, ``cpu:0`` on the CPU (the reference's CPU id
too, so the two boards' snapshots compare).  A sticky CUDA error (an
illegal address, a kernel trap) fails every later CUDA call of the
process, the probe included: such a card stays quarantined until the
process restarts.
"""

from __future__ import annotations

import threading
import time

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("faulttol.health")

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBATION = "probation"

# metric encoding for karpenter_tpu_device_health (gauge):
# 0=healthy 1=suspect 2=quarantined 3=probation
_STATE_CODE = {HEALTHY: 0, SUSPECT: 1, QUARANTINED: 2, PROBATION: 3}

# defaults mirror the cloud breaker's shape, scaled to dispatch cadence
FAULT_THRESHOLD = 3          # faults in window -> quarantine
FAULT_WINDOW_S = 300.0       # sliding fault window
RECOVERY_TIMEOUT_S = 60.0    # quarantined -> probation after this
PROBE_INTERVAL_S = 60.0      # min spacing between probation probes
PROBE_SUCCESSES = 2          # consecutive green probes -> healthy


def device_id(dev) -> str:
    """The board's id of one ``torch.device`` (or device string)."""
    import torch

    dev = torch.device(dev)
    return f"{dev.type}:{dev.index or 0}"


def default_device_id() -> str:
    """The identity of the default dispatch target: the current CUDA
    device when there is a card, else ``cpu:0``.  Stable per process;
    cheap after the first call.  The port's sites pass their own
    solver's device (:func:`device_ids`)."""
    global _DEFAULT_DEVICE
    if _DEFAULT_DEVICE is None:
        try:
            import torch

            _DEFAULT_DEVICE = (f"cuda:{torch.cuda.current_device()}"
                               if torch.cuda.is_available() else "cpu:0")
        except Exception:  # noqa: BLE001 — no runtime: host-only mode
            _DEFAULT_DEVICE = "cpu:0"
    return _DEFAULT_DEVICE


_DEFAULT_DEVICE: str | None = None


def device_ids(devices) -> list[str]:
    """``torch.device`` objects (or device strings) -> stable string ids."""
    return [device_id(d) for d in devices]


class _DeviceHealth:
    __slots__ = ("state", "faults", "since", "last_kind", "last_kernel",
                 "probe_streak", "last_probe_at", "quarantines")

    def __init__(self, now: float):
        self.state = HEALTHY
        self.faults: list[float] = []
        self.since = now
        self.last_kind = ""
        self.last_kernel = ""
        self.probe_streak = 0
        self.last_probe_at = -1e18
        self.quarantines = 0


class HealthBoard:
    """Process-global device health truth."""

    def __init__(self, *, fault_threshold: int = FAULT_THRESHOLD,
                 fault_window_s: float = FAULT_WINDOW_S,
                 recovery_timeout_s: float = RECOVERY_TIMEOUT_S,
                 probe_interval_s: float = PROBE_INTERVAL_S,
                 probe_successes: int = PROBE_SUCCESSES,
                 clock=None, probe_runner=None,
                 triage_writer=None):
        self.fault_threshold = fault_threshold
        self.fault_window_s = fault_window_s
        self.recovery_timeout_s = recovery_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_successes = probe_successes
        self._clock = clock
        self._probe_runner = probe_runner
        self._triage_writer = triage_writer
        self._lock = threading.Lock()
        self._devices: dict[str, _DeviceHealth] = {}
        self.last_failover_reason = ""
        # guard bookkeeping wall (real perf_counter, accumulated by
        # dispatch.py) — the numerator of healthy_overhead_fraction
        self.guard_overhead_s = 0.0
        self.guards_entered = 0
        self.faults_recorded = 0

    def _now(self) -> float:
        # time.monotonic looked up at call time: the chaos virtual
        # clock patches the module attribute, so recovery/probation
        # timing rides scenario time inside a scenario
        return self._clock() if self._clock is not None \
            else time.monotonic()

    def _dev(self, device: str, now: float) -> _DeviceHealth:
        d = self._devices.get(device)
        if d is None:
            d = self._devices[device] = _DeviceHealth(now)
            metrics.DEVICE_HEALTH.labels(device).set(0)
        return d

    # -- dispatch-side API (device_guard) ----------------------------------

    def admits(self, device: str) -> bool:
        """Dispatch admission: quarantined and probation devices take
        no production traffic (probation traffic is probes only)."""
        with self._lock:
            d = self._devices.get(device)
            return d is None or d.state in (HEALTHY, SUSPECT)

    def state(self, device: str) -> str:
        with self._lock:
            d = self._devices.get(device)
            return d.state if d is not None else HEALTHY

    def record_success(self, device: str) -> None:
        with self._lock:
            # materializes the entry so /statusz and the device_health
            # gauge show healthy devices, not just faulted ones
            d = self._dev(device, self._now())
            if d.state == SUSPECT:
                d.faults.clear()
                self._transition(d, device, HEALTHY, self._now())

    def record_fault(self, device: str, *, kind: str,
                     kernel: str) -> None:
        now = self._now()
        with self._lock:
            self.faults_recorded += 1
            d = self._dev(device, now)
            d.last_kind, d.last_kernel = kind, kernel
            if d.state in (QUARANTINED, PROBATION):
                # probe failures are recorded via note_probe; a fault
                # reaching here means a dispatch raced the quarantine
                return
            cutoff = now - self.fault_window_s
            d.faults = [t for t in d.faults if t > cutoff]
            d.faults.append(now)
            if len(d.faults) >= self.fault_threshold:
                self._quarantine(d, device, now)
            elif d.state == HEALTHY:
                self._transition(d, device, SUSPECT, now)

    # -- state machine ------------------------------------------------------

    def _transition(self, d: _DeviceHealth, device: str, state: str,
                    now: float) -> None:
        prev, d.state, d.since = d.state, state, now
        metrics.DEVICE_HEALTH.labels(device).set(_STATE_CODE[state])
        log.info("device health transition", device=device,
                 prev=prev, state=state, last_kind=d.last_kind,
                 last_kernel=d.last_kernel)
        from karpenter_tpu_torch import obs

        obs.instant("device.health", device=device, prev=prev,
                    state=state, kind=d.last_kind, kernel=d.last_kernel)

    def _quarantine(self, d: _DeviceHealth, device: str,
                    now: float) -> None:
        d.faults.clear()
        d.probe_streak = 0
        d.quarantines += 1
        self._transition(d, device, QUARANTINED, now)
        metrics.DEVICE_QUARANTINES.labels(device).inc()
        writer = self._triage_writer
        if writer is None:
            from karpenter_tpu_torch.obs.watchdog import write_triage_bundle

            writer = write_triage_bundle
        try:
            writer("device-quarantine", {
                "device": device, "kind": d.last_kind,
                "kernel": d.last_kernel, "quarantines": d.quarantines})
        except Exception as e:  # noqa: BLE001 — triage must not fail a solve
            log.warning("triage bundle write failed", error=str(e))

    # -- probation / probes --------------------------------------------------

    def tick(self) -> None:
        """Advance time-driven transitions.  Called on every guard
        entry; the healthy steady state is one lock + one dict scan of
        (usually zero) unhealthy devices — no dispatches, no probes."""
        probes: list[str] = []
        now = self._now()
        with self._lock:
            for device, d in self._devices.items():
                if d.state == QUARANTINED \
                        and now - d.since >= self.recovery_timeout_s:
                    d.probe_streak = 0
                    self._transition(d, device, PROBATION, now)
                if d.state == PROBATION \
                        and now - d.last_probe_at >= self.probe_interval_s:
                    d.last_probe_at = now
                    probes.append(device)
        for device in probes:
            self.note_probe(device, self._run_probe(device))

    def _run_probe(self, device: str) -> bool:
        """One cheap probe solve on the target device.  The injector is
        consulted first so an injected fault schedule keeps a dead chip
        dead — and a cleared schedule lets it heal — deterministically."""
        if self._probe_runner is not None:
            return bool(self._probe_runner(device))
        from karpenter_tpu_torch.faulttol.inject import get_injector

        inj = get_injector()
        if inj is not None and inj.probe_faults(device):
            return False
        try:
            import torch

            dev = torch.device(device)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", 0)
            out = (torch.arange(8, dtype=torch.int32, device=dev) + 1).cpu()
            return int(out[0]) == 1
        except Exception as e:  # noqa: BLE001 — a failing probe IS the signal
            log.warning("device probe failed", device=device, error=str(e))
            return False

    def note_probe(self, device: str, ok: bool) -> None:
        now = self._now()
        with self._lock:
            d = self._dev(device, now)
            if d.state != PROBATION:
                return
            if ok:
                d.probe_streak += 1
                if d.probe_streak >= self.probe_successes:
                    d.faults.clear()
                    self._transition(d, device, HEALTHY, now)
            else:
                d.last_kind = "probe_failure"
                self._quarantine(d, device, now)

    # -- guard bookkeeping ---------------------------------------------------

    def note_guard_entered(self, overhead_s: float) -> None:
        with self._lock:
            self.guards_entered += 1
            self.guard_overhead_s += overhead_s

    def add_overhead(self, overhead_s: float) -> None:
        with self._lock:
            self.guard_overhead_s += overhead_s

    # -- failover bookkeeping ------------------------------------------------

    def note_failover(self, reason: str) -> None:
        with self._lock:
            self.last_failover_reason = reason
        metrics.DEVICE_FAILOVERS.labels(reason).inc()

    def quarantined_ids(self) -> frozenset:
        with self._lock:
            return frozenset(
                dev for dev, d in self._devices.items()
                if d.state in (QUARANTINED, PROBATION))

    # -- readout -------------------------------------------------------------

    def healthy_overhead_fraction(self) -> float:
        """Guard bookkeeping wall over the profiler's estimated total
        dispatch wall — the <1% acceptance gate for the healthy path."""
        from karpenter_tpu_torch.obs.prof import get_profiler

        est_total = get_profiler().estimated_total_wall_s()
        with self._lock:
            return self.guard_overhead_s / est_total if est_total else 0.0

    def snapshot(self) -> dict:
        from karpenter_tpu_torch.faulttol.deadline import get_deadline_model
        from karpenter_tpu_torch.obs.prof import get_profiler

        prof_kernels = list(get_profiler().snapshot()["kernels"])
        with self._lock:
            devices = {
                dev: {"state": d.state, "faults_in_window": len(d.faults),
                      "last_kind": d.last_kind, "last_kernel": d.last_kernel,
                      "quarantines": d.quarantines,
                      "probe_streak": d.probe_streak}
                for dev, d in self._devices.items()}
            out = {
                "devices": devices,
                "last_failover_reason": self.last_failover_reason,
                "guards_entered": self.guards_entered,
                "faults_recorded": self.faults_recorded,
                "guard_overhead_s": round(self.guard_overhead_s, 6),
            }
        out["deadlines_s"] = get_deadline_model().snapshot(prof_kernels)
        out["healthy_overhead_fraction"] = round(
            self.healthy_overhead_fraction(), 6)
        return out

    def prune(self, live_devices) -> list[str]:
        """Series hygiene after a mesh remap: drop board entries — and
        their ``device_health{device}`` gauge rows — for devices no
        longer in the live set.  A pre-remap device's row would
        otherwise linger at its last state forever, exactly the stale-
        labelset class the LEADER/COST_PER_HOUR render round-trip test
        pinned in the operator build.  Quarantined devices are KEPT:
        quarantine is the board saying "this device exists and is
        sick" — pruning it would erase the recovery state machine."""
        live = set(live_devices)
        removed = []
        with self._lock:
            for device in list(self._devices):
                d = self._devices[device]
                if device in live or d.state in (QUARANTINED, PROBATION):
                    continue
                del self._devices[device]
                metrics.DEVICE_HEALTH.remove(device)
                removed.append(device)
        if removed:
            log.info("health board pruned stale devices",
                     removed=sorted(removed))
        return removed

    def reset(self) -> None:
        """Scenario isolation: pristine board, stale metric series
        removed (same idiom as the ledger history resets in the chaos
        harness build)."""
        with self._lock:
            for device in self._devices:
                metrics.DEVICE_HEALTH.remove(device)
            self._devices.clear()
            self.last_failover_reason = ""
            self.guard_overhead_s = 0.0
            self.guards_entered = 0
            self.faults_recorded = 0


_BOARD: HealthBoard | None = None
_SINGLETON_LOCK = threading.Lock()


def get_health_board() -> HealthBoard:
    global _BOARD
    if _BOARD is None:
        with _SINGLETON_LOCK:
            if _BOARD is None:
                _BOARD = HealthBoard()
    return _BOARD
