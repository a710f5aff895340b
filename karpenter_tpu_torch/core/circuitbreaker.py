"""Provisioning circuit breaker: 3-state, per (nodeclass, region).

Parity with ``pkg/cloudprovider/circuitbreaker.go``:
- CLOSED / OPEN / HALF_OPEN (:29-38);
- failure threshold within a sliding window, recovery timeout, half-open
  probe budget, provision rate limit per minute, max concurrent instances
  (CircuitBreakerConfig :41-55; defaults 3 failures / 5 min window /
  15 min recovery / 2 half-open probes / 2 per min / 5 concurrent :57);
- ``can_provision`` (:113), ``record_success`` (:189), ``record_failure``
  (:217);
- a manager keyed per (nodeclass, region) with idle-entry cleanup
  (nodeclasscircuitbreaker.go:28-51, :233).

(Copy of ``karpenter_tpu/core/circuitbreaker.py``.)
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from collections.abc import Callable

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.circuitbreaker")

CLOSED, OPEN, HALF_OPEN = "CLOSED", "OPEN", "HALF_OPEN"


class CircuitBreakerOpenError(Exception):
    def __init__(self, key: tuple[str, str], reason: str):
        super().__init__(f"circuit breaker open for {key[0]}/{key[1]}: {reason}")
        self.key = key
        self.reason = reason


@dataclass
class CircuitBreakerConfig:
    failure_threshold: int = 3
    failure_window: float = 300.0
    recovery_timeout: float = 900.0
    half_open_max_requests: int = 2
    rate_limit_per_minute: int = 2
    max_concurrent_instances: int = 5
    enabled: bool = True

    @classmethod
    def from_env(cls, env=os.environ) -> "CircuitBreakerConfig":
        """Env-gated config (ref options.go:154-221, CIRCUIT_BREAKER_*)."""
        def geti(key, default):
            try:
                return int(env.get(key, default))
            except ValueError:
                return default

        return cls(
            failure_threshold=geti("CIRCUIT_BREAKER_FAILURE_THRESHOLD", 3),
            failure_window=geti("CIRCUIT_BREAKER_FAILURE_WINDOW_SECONDS", 300),
            recovery_timeout=geti("CIRCUIT_BREAKER_RECOVERY_TIMEOUT_SECONDS", 900),
            half_open_max_requests=geti("CIRCUIT_BREAKER_HALF_OPEN_MAX_REQUESTS", 2),
            rate_limit_per_minute=geti("CIRCUIT_BREAKER_RATE_LIMIT_PER_MINUTE", 2),
            max_concurrent_instances=geti("CIRCUIT_BREAKER_MAX_CONCURRENT_INSTANCES", 5),
            enabled=env.get("CIRCUIT_BREAKER_ENABLED", "true").lower() != "false",
        )


class CircuitBreaker:
    def __init__(self, config: CircuitBreakerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 key: tuple[str, str] = ("default", "default")):
        self.config = config or CircuitBreakerConfig()
        self._clock = clock
        self._key = key
        self._lock = threading.Lock()
        self.state = CLOSED
        self._failures: list[float] = []
        self._last_state_change = clock()
        self._half_open_requests = 0
        self._concurrent = 0
        self._minute_count = 0
        self._minute_start = clock()
        self.last_used = clock()
        # export the 0=CLOSED baseline immediately: dashboards must be
        # able to tell "closed" from "no breaker exists"
        metrics.CB_STATE.labels(key[0], key[1]).set(0.0)

    # -- public ------------------------------------------------------------

    def can_provision(self) -> None:
        """Raises CircuitBreakerOpenError when blocked; on success the
        caller MUST later call record_success or record_failure exactly once
        (concurrency accounting — ref deferred-record idiom,
        cloudprovider.go:375-383)."""
        if not self.config.enabled:
            return
        with self._lock:
            now = self._clock()
            self.last_used = now
            self._reset_minute_locked(now)
            if self.state == OPEN:
                if now - self._last_state_change >= self.config.recovery_timeout:
                    self._transition(HALF_OPEN, now)
                else:
                    raise CircuitBreakerOpenError(self._key, "recovery timeout pending")
            # rate/concurrency checks BEFORE consuming half-open budget: a
            # rejection here never reaches record_*, so a probe consumed now
            # would be burned with no provision attempted
            if self._minute_count >= self.config.rate_limit_per_minute:
                raise CircuitBreakerOpenError(self._key, "provision rate limit reached")
            if self._concurrent >= self.config.max_concurrent_instances:
                raise CircuitBreakerOpenError(self._key, "max concurrent provisions")
            if self.state == HALF_OPEN:
                if self._half_open_requests >= self.config.half_open_max_requests:
                    raise CircuitBreakerOpenError(self._key, "half-open probe budget spent")
                self._half_open_requests += 1
            self._minute_count += 1
            self._concurrent += 1

    def record_success(self) -> None:
        if not self.config.enabled:
            return
        with self._lock:
            now = self._clock()
            self._concurrent = max(0, self._concurrent - 1)
            if self.state == HALF_OPEN:
                self._transition(CLOSED, now)
                self._failures.clear()
                self._half_open_requests = 0

    def record_failure(self, error: str = "") -> None:
        if not self.config.enabled:
            return
        with self._lock:
            now = self._clock()
            self._concurrent = max(0, self._concurrent - 1)
            cutoff = now - self.config.failure_window
            self._failures = [t for t in self._failures if t > cutoff]
            self._failures.append(now)
            if self.state == HALF_OPEN:
                self._transition(OPEN, now)
                self._half_open_requests = 0
            elif self.state == CLOSED and \
                    len(self._failures) >= self.config.failure_threshold:
                self._transition(OPEN, now)
            if error:
                log.warning("provision failure recorded", key=self._key,
                            state=self.state, error=error)

    # -- internals ---------------------------------------------------------

    def _transition(self, state: str, now: float) -> None:
        if state != self.state:
            log.info("circuit breaker transition", key=self._key,
                     frm=self.state, to=state)
            # pure in-memory marker (instant span / span event) — safe
            # under self._lock, and it puts breaker flips on the same
            # timeline as the RPC spans they gate
            obs.instant("cb.transition", nodeclass=self._key[0],
                        region=self._key[1], frm=self.state, to=state)
            self.state = state
            self._last_state_change = now
            # 0=CLOSED 1=OPEN 2=HALF_OPEN — the PrometheusRule alert
            # (chart prometheusrule.yaml) fires on >= 1
            metrics.CB_STATE.labels(self._key[0], self._key[1]).set(
                {CLOSED: 0.0, OPEN: 1.0, HALF_OPEN: 2.0}[state])

    def _reset_minute_locked(self, now: float) -> None:
        # caller holds self._lock (the _locked contract)
        if now - self._minute_start >= 60.0:
            self._minute_start = now
            self._minute_count = 0


class CircuitBreakerManager:
    """Per-(nodeclass, region) breakers with idle cleanup
    (nodeclasscircuitbreaker.go:28-51; cleanup :233)."""

    IDLE_TTL = 3600.0

    def __init__(self, config: CircuitBreakerConfig | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._config = config or CircuitBreakerConfig()
        self._clock = clock
        self._lock = threading.Lock()
        self._breakers: dict[tuple[str, str], CircuitBreaker] = {}

    @property
    def config(self) -> CircuitBreakerConfig:
        """Public view of the shared config — budget-aware callers (the
        repack burst guard, disruption.py) size their plans against it;
        a private-only attribute silently disabled that guard."""
        return self._config

    def get(self, nodeclass: str, region: str) -> CircuitBreaker:
        key = (nodeclass, region)
        with self._lock:
            cb = self._breakers.get(key)
            if cb is None:
                cb = CircuitBreaker(self._config, self._clock, key)
                self._breakers[key] = cb
            return cb

    def can_provision(self, nodeclass: str, region: str) -> None:
        self.get(nodeclass, region).can_provision()

    def record_success(self, nodeclass: str, region: str) -> None:
        self.get(nodeclass, region).record_success()

    def record_failure(self, nodeclass: str, region: str, error: str = "") -> None:
        self.get(nodeclass, region).record_failure(error)

    def cleanup(self) -> int:
        """Drop breakers idle past the TTL; returns number dropped."""
        now = self._clock()
        with self._lock:
            dead = [k for k, cb in self._breakers.items()
                    if now - cb.last_used > self.IDLE_TTL and cb.state == CLOSED]
            for k in dead:
                del self._breakers[k]
                # drop the gauge series too — churned nodeclasses must
                # not accumulate stale label sets forever
                metrics.CB_STATE.remove(k[0], k[1])
            return len(dead)

    def states(self) -> dict[tuple[str, str], str]:
        with self._lock:
            return {k: cb.state for k, cb in self._breakers.items()}
