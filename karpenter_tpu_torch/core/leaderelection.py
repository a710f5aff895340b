"""Lease-based leader election: single-active-controller gate.

Parity with the reference's controller-runtime leader election
(coordination.k8s.io leases; RBAC at
pkg/controllers/controllers.go:37-41): multiple controller
replicas may run, but only the lease holder actuates — the others keep
their caches warm and take over when the holder stops renewing.

The lease lives in the cluster store (ClusterState) under the ``leases``
kind and every transition is a compare-and-swap on the record's
resourceVersion, so two electors racing on the same store can never both
hold the lease.  Self-demotion is time-fenced: a holder that cannot renew
within the lease duration reports ``is_leader() == False`` even before
another replica takes over — a network-partitioned leader must stop
actuating rather than split-brain with its successor.

(Copy of ``karpenter_tpu/core/leaderelection.py``.)
"""

from __future__ import annotations

import dataclasses
import threading
import time
import uuid
from dataclasses import dataclass
from collections.abc import Callable

from karpenter_tpu_torch.core.cluster import ClusterState, ConflictError
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.leaderelection")

LEASE_KIND = "leases"
DEFAULT_LEASE_NAME = "karpenter-tpu-leader"


@dataclass
class Lease:
    """coordination.k8s.io/v1 Lease analogue."""

    name: str
    holder: str = ""
    acquire_time: float = 0.0
    renew_time: float = 0.0
    lease_duration: float = 15.0
    resource_version: int = 0


class LeaderElector:
    """Acquire/renew loop with callbacks.

    ``is_leader()`` is the actuation gate: provisioner plan execution and
    write-path controllers consult it every cycle (reads/watches are NOT
    gated — followers keep state warm, exactly like controller-runtime's
    ``LeaderElectionReleaseOnCancel`` setup in the reference).
    """

    def __init__(self, store: ClusterState, identity: str = "",
                 lease_name: str = DEFAULT_LEASE_NAME,
                 lease_duration: float = 15.0,
                 renew_interval: float = 5.0,
                 retry_interval: float = 2.0,
                 on_started_leading: Callable[[], None] | None = None,
                 on_stopped_leading: Callable[[], None] | None = None,
                 clock=time.time):
        # clock is WALL time by default: renew_time in the lease record is
        # compared across replicas, and monotonic clocks have per-host
        # origins (Kubernetes leases use wall-clock timestamps for the
        # same reason).  Tests inject a fake clock.
        self.store = store
        self.identity = identity or f"karpenter-tpu-{uuid.uuid4().hex[:8]}"
        self.lease_name = lease_name
        self.lease_duration = lease_duration
        self.renew_interval = renew_interval
        self.retry_interval = retry_interval
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._clock = clock
        self._last_renew = 0.0
        self._leading = False
        self._transition_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- public --------------------------------------------------------------

    def is_leader(self) -> bool:
        """Time-fenced leadership check: holding the record is not enough,
        the last successful renewal must be within the lease duration.  An
        expired fence DEMOTES on read so the gauge and the
        on_stopped_leading callback reflect the loss as soon as any code
        observes it (a starved renew thread can't record it itself)."""
        if self._leading and \
                (self._clock() - self._last_renew) >= self.lease_duration:
            self._set_leading(False)
        return self._leading

    def start(self) -> "LeaderElector":
        if self._thread is not None:
            return self
        self._stop.clear()
        self.try_acquire_or_renew()   # fast first attempt before the loop
        self._thread = threading.Thread(target=self._run,
                                        name="leader-elector", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Release on cancel: a clean shutdown hands the lease off
        immediately instead of making the successor wait a full expiry."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.retry_interval + 1)
            self._thread = None
        if self._leading:
            self._release()
            self._set_leading(False)
        # series hygiene: a stopped elector's lease gauge must not linger
        # as a stale 0 row (replicas churn; the scrape joins on lease)
        metrics.LEADER.remove(self.lease_name)

    def try_acquire_or_renew(self) -> bool:
        """One CAS round.  Returns whether this identity holds the lease
        after the attempt."""
        now = self._clock()
        if self._leading and (now - self._last_renew) >= self.lease_duration:
            # record the fence expiry as a real transition before trying
            # to re-acquire — leadership may have changed hands meanwhile
            self._set_leading(False)
        lease = self.store.get(LEASE_KIND, self.lease_name)
        if lease is None:
            try:
                self.store.add(LEASE_KIND, self.lease_name, Lease(
                    name=self.lease_name, holder=self.identity,
                    acquire_time=now, renew_time=now,
                    lease_duration=self.lease_duration))
            except ConflictError:
                self._set_leading(False)
                return False          # another replica created it first
            self._last_renew = now
            self._set_leading(True)
            return True

        held_by_me = lease.holder == self.identity
        expired = (now - lease.renew_time) >= lease.lease_duration \
            or not lease.holder
        if not held_by_me and not expired:
            self._set_leading(False)
            return False
        new = dataclasses.replace(
            lease, holder=self.identity, renew_time=now,
            acquire_time=lease.acquire_time if held_by_me else now,
            lease_duration=self.lease_duration)
        try:
            self.store.update(LEASE_KIND, self.lease_name, new,
                              expect_rv=lease.resource_version)
        except ConflictError:
            # someone else renewed/acquired between the read and the CAS
            self._set_leading(False)
            return False
        self._last_renew = now
        self._set_leading(True)
        return True

    # -- internals -------------------------------------------------------

    def _release(self) -> None:
        lease = self.store.get(LEASE_KIND, self.lease_name)
        if lease is None or lease.holder != self.identity:
            return
        try:
            self.store.update(
                LEASE_KIND, self.lease_name,
                dataclasses.replace(lease, holder="", renew_time=0.0),
                expect_rv=lease.resource_version)
            log.info("lease released", lease=self.lease_name,
                     identity=self.identity)
        except ConflictError:
            pass                      # successor already took it

    def _set_leading(self, leading: bool) -> None:
        # flip under the lock; notify outside it (a callback calling
        # is_leader() must not deadlock on the transition lock)
        with self._transition_lock:
            if leading == self._leading:
                return
            self._leading = leading
        metrics.LEADER.labels(self.lease_name).set(1.0 if leading else 0.0)
        from karpenter_tpu_torch import obs

        obs.instant("leader.transition", lease=self.lease_name,
                    leading=leading)
        if leading:
            log.info("became leader", lease=self.lease_name,
                     identity=self.identity)
            if self.on_started_leading:
                self.on_started_leading()
        else:
            log.info("lost leadership", lease=self.lease_name,
                     identity=self.identity)
            if self.on_stopped_leading:
                self.on_stopped_leading()

    def _run(self) -> None:
        while not self._stop.is_set():
            leading = self.try_acquire_or_renew()
            interval = self.renew_interval if leading else self.retry_interval
            self._stop.wait(interval)


class AlwaysLeader:
    """Single-replica default: election disabled, always actuate."""

    identity = "single-replica"

    def is_leader(self) -> bool:
        return True

    def start(self) -> "AlwaysLeader":
        return self

    def stop(self) -> None:
        pass
