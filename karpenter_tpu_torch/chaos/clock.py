"""Virtual clock for deterministic scenario time.

The controller plane reads wall time through ``time.time()`` /
``time.monotonic()`` at call time (never cached), so patching the
``time`` module attributes inside :meth:`VirtualClock.installed` puts
every age/TTL/backoff computation on scenario time: a 1-hour offering
blackout expires after ``advance(3600)``, not after an hour of CI.

Two deliberate boundaries:

- ``dataclass`` ``default_factory=time.time`` timestamps (NodeClaim,
  Instance, PendingPod creation stamps) bound the *original* function at
  class-definition time, so created objects carry real wall time.  The
  virtual clock therefore STARTS at the current wall time and only moves
  forward; ages come out as the virtual time elapsed since creation plus
  sub-second real drift.  Scenario thresholds are chosen rounds apart,
  never within drift of a boundary, so checks stay deterministic.
- ``time.sleep`` is replaced by a pure clock advance: injected
  Retry-After waits and backoff sleeps cost scenario time, not CI time.

Installation is process-global and NOT thread-safe by design — the
chaos harness runs strictly single-threaded (``sync()`` path, no
``start()``), which is what makes the event trace replayable at all.
"""

from __future__ import annotations

import time
from contextlib import contextmanager


class VirtualClock:
    def __init__(self, start: float | None = None):
        self._time = time.time() if start is None else start
        self._mono = time.monotonic()

    # -- readouts (bound methods double as injectable clocks) --------------

    def time(self) -> float:
        return self._time

    def monotonic(self) -> float:
        return self._mono

    # -- control ------------------------------------------------------------

    def advance(self, seconds: float) -> None:
        if seconds < 0:
            raise ValueError(f"virtual clock cannot rewind ({seconds})")
        self._time += seconds
        self._mono += seconds

    def sleep(self, seconds: float) -> None:
        """time.sleep stand-in: advancing costs scenario time only."""
        self.advance(max(0.0, seconds))

    @contextmanager
    def installed(self):
        """Patch ``time.time``/``time.monotonic``/``time.sleep`` to this
        clock for the duration of the block (single-threaded scenarios
        only; originals restored even on error)."""
        originals = (time.time, time.monotonic, time.sleep)
        time.time = self.time
        time.monotonic = self.monotonic
        time.sleep = self.sleep
        try:
            yield self
        finally:
            time.time, time.monotonic, time.sleep = originals
