"""Deterministic device-fault injection at the dispatch-guard seam.
(Copy of ``karpenter_tpu/faulttol/inject.py``.)

``FaultyDeviceInjector`` draws one fault decision per guarded dispatch
from a dedicated seeded stream (``random.Random(f"{profile}:{seed}:device")``
in the chaos harness — same discipline as the cloud/solver streams), so
a (profile, seed) cell replays the exact hang/error/OOM/corrupt
schedule run-to-run.  Injection happens INSIDE the guard, never inside
a traced kernel:

- ``hang``   -> the guard raises ``DispatchDeadlineExceeded`` as if the
  dispatch->fetch wall blew its budget (no real stall: chaos rides the
  virtual clock);
- ``error``  -> ``DeviceFaultError`` at the fetch/exit edge (a Mosaic
  runtime fault surfacing at the caller's fetch);
- ``oom``    -> ``DeviceResourceExhausted`` (drives the batch-chunking
  / pad-ladder backoff before host fallback);
- ``corrupt``-> the FETCHED HOST COPY is mutated (first element becomes
  NaN / int-min).  Device state is untouched, so mirror==device parity
  invariants still hold; the bad plan must be caught by the existing
  independent validators (plan_defects, sharded decode checks) — which
  is the point: corruption proves the validators, not the injector.

The injector is installed process-globally (module seam consulted by
``device_guard`` and the health board's probe runner) and cleared at
chaos quiesce so health-converges can hold.
"""

from __future__ import annotations

import threading

import numpy as np

KINDS = ("hang", "error", "oom", "corrupt")


class FaultyDeviceInjector:
    def __init__(self, rng, rates: dict[str, float],
                 devices: list[str] | None = None, trace=None):
        unknown = set(rates) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown fault kinds: {sorted(unknown)}")
        self.rng = rng
        self.rates = dict(rates)
        self.devices = list(devices) if devices else None
        self.trace = trace
        self.armed = True
        self.injected = 0
        self._lock = threading.Lock()

    def disarm(self) -> None:
        self.armed = False

    # -- the per-dispatch draw ----------------------------------------------

    def draw(self, kernel: str, candidates: list[str]) -> tuple | None:
        """-> (kind, victim device id) or None.  One rng.random() per
        dispatch plus one choice draw per hit keeps the stream cheap
        and the schedule a pure function of the dispatch sequence."""
        if not self.armed or not candidates:
            return None
        with self._lock:
            r = self.rng.random()
            acc = 0.0
            for kind in KINDS:
                acc += self.rates.get(kind, 0.0)
                if r < acc:
                    victim = candidates[
                        self.rng.randrange(len(candidates))] \
                        if len(candidates) > 1 else candidates[0]
                    self.injected += 1
                    if self.trace is not None:
                        # EventTrace.add's first positional is ``kind``
                        # (the event type) — the fault kind rides as
                        # ``fault``
                        self.trace.add("device_fault", kernel=kernel,
                                       fault=kind, device=victim,
                                       n=self.injected)
                    return kind, victim
        return None

    def probe_faults(self, device: str) -> bool:
        """Probe-solve consultation: while armed, a probe on ``device``
        fails with the device's TOTAL fault probability — an injected
        fault schedule keeps the chip flapping until cleared."""
        if not self.armed:
            return False
        with self._lock:
            p = min(1.0, sum(self.rates.values()))
            failed = self.rng.random() < p
            if failed and self.trace is not None:
                self.trace.add("device_fault", kernel="health-probe",
                               fault="probe", device=device)
            return failed

    # -- corruption ---------------------------------------------------------

    @staticmethod
    def corrupt(out: np.ndarray) -> np.ndarray:
        """Mutate the fetched host copy only.  The sentinel (NaN for
        floats, int-min for ints) is chosen to trip the independent
        validators: non-finite cost words and out-of-range indices are
        exactly what plan_defects / the sharded decode checks reject."""
        bad = np.array(out, copy=True)
        if bad.size == 0:
            return bad
        flat = bad.reshape(-1)
        if np.issubdtype(bad.dtype, np.floating):
            flat[0] = np.nan
        elif np.issubdtype(bad.dtype, np.integer):
            flat[0] = np.iinfo(bad.dtype).min
        return bad


_INJECTOR: FaultyDeviceInjector | None = None


def install_injector(inj: FaultyDeviceInjector) -> None:
    global _INJECTOR
    _INJECTOR = inj


def clear_injector() -> None:
    global _INJECTOR
    _INJECTOR = None


def get_injector() -> FaultyDeviceInjector | None:
    return _INJECTOR
