"""Controller runtime: watch-driven reconcilers + singleton pollers.

The reference's two controller shapes (SURVEY.md §2.5):

- **watch-driven** — controller-runtime ``Reconcile(ctx, req)`` fed by
  informer events; here a work queue with per-key dedup fed by
  ClusterState watch callbacks (the informer analogue), drained by worker
  threads.
- **singleton pollers** — ``Reconcile(ctx)`` + ``RequeueAfter``; here a
  poll loop whose interval the reconcile can adapt per-cycle (the GC
  controller's 10s/2m adaptive requeue, garbagecollection/controller.go:201).

``ControllerManager.sync()`` is the deterministic test entry: enqueue every
existing object, drain all queues, run every poller once — no threads.

(Copy of ``karpenter_tpu/controllers/runtime.py``.)
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from collections.abc import Callable, Sequence

from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("controllers.runtime")


@dataclass
class Result:
    """Reconcile outcome (controller-runtime's ctrl.Result analogue)."""

    requeue_after: float = 0.0     # >0: re-reconcile this key/poller later


class WatchController:
    """Base for watch-driven controllers.

    Subclasses set ``name`` and ``watch_kinds`` and implement
    ``reconcile(name) -> Result``; ``map_event`` can redirect an event on a
    watched object to a different reconcile key (the reference's event
    handlers mapping node events -> claims, startuptaint/nodehandler.go).
    """

    name = "watch"
    watch_kinds: Sequence[str] = ()

    def map_event(self, kind: str, event_type: str, obj) -> str | None:
        return getattr(obj, "name", None)

    def reconcile(self, key: str) -> Result:  # pragma: no cover - abstract
        raise NotImplementedError


class PollController:
    """Base for singleton pollers: ``reconcile() -> Result`` decides its own
    next interval via requeue_after (else ``interval``)."""

    name = "poll"
    interval = 60.0

    def reconcile(self) -> Result:  # pragma: no cover - abstract
        raise NotImplementedError


class _Queue:
    """Per-controller keyed work queue with dedup + delayed requeue."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: list[str] = []
        self._in_queue: set = set()
        self._delayed: dict[str, float] = {}   # key -> not-before monotonic
        self._closed = False

    def add(self, key: str, after: float = 0.0) -> None:
        with self._cv:
            if after > 0:
                due = time.monotonic() + after
                # keep the EARLIER due time if already delayed
                prev = self._delayed.get(key)
                self._delayed[key] = due if prev is None else min(prev, due)
            elif key not in self._in_queue:
                self._pending.append(key)
                self._in_queue.add(key)
            self._cv.notify()

    def _promote_due_locked(self, now: float) -> None:
        # caller holds self._cv (the _locked contract, docs/development.md)
        due = [k for k, t in self._delayed.items() if t <= now]
        for k in due:
            del self._delayed[k]
            if k not in self._in_queue:
                self._pending.append(k)
                self._in_queue.add(k)

    def get(self, timeout: float = 0.2) -> str | None:
        with self._cv:
            self._promote_due_locked(time.monotonic())
            if not self._pending and not self._closed:
                self._cv.wait(timeout)
                self._promote_due_locked(time.monotonic())
            if not self._pending:
                return None
            key = self._pending.pop(0)
            self._in_queue.discard(key)
            return key

    def drain(self) -> list[str]:
        """Take everything currently due (test/sync path)."""
        with self._cv:
            self._promote_due_locked(time.monotonic())
            keys, self._pending = self._pending, []
            self._in_queue.clear()
            return keys

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()


class ControllerManager:
    # crash backoff: a reconcile key whose handler keeps throwing backs
    # off 5s -> 10s -> ... -> 5min instead of hot-looping every 5s
    # forever (a poisoned object would otherwise burn a worker + error
    # log line every 5s for its whole life); any successful reconcile
    # of the key resets the schedule
    crash_backoff_initial = 5.0
    crash_backoff_cap = 300.0

    def __init__(self, cluster: ClusterState, leader=None):
        self.cluster = cluster
        # leader gate (core/leaderelection.py): non-leader replicas keep
        # watching (queues accumulate, caches stay warm) but do not
        # reconcile — controller-runtime's leader-election semantics.
        # Queued keys drain on failover; pollers just skip their tick.
        self.leader = leader if leader is not None else (lambda: True)
        self._watch: list[WatchController] = []
        self._poll: list[PollController] = []
        self._queues: dict[str, _Queue] = {}
        self._unsubs: list[Callable[[], None]] = []
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        self._crash_lock = threading.Lock()
        self._crash_counts: dict[tuple[str, str], int] = {}

    # -- registration ------------------------------------------------------

    def register(self, controller) -> None:
        if isinstance(controller, WatchController):
            self._watch.append(controller)
            self._queues[controller.name] = _Queue()
        elif isinstance(controller, PollController):
            self._poll.append(controller)
        else:
            raise TypeError(f"not a controller: {controller!r}")

    def controllers(self) -> list[str]:
        return [c.name for c in self._watch] + [c.name for c in self._poll]

    # -- live operation ----------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        for ctrl in self._watch:
            queue = self._queues[ctrl.name]
            for kind in ctrl.watch_kinds:
                self._unsubs.append(self.cluster.watch(
                    kind, self._make_handler(ctrl, kind, queue)))
            t = threading.Thread(target=self._watch_loop, args=(ctrl, queue),
                                 name=f"ctrl-{ctrl.name}", daemon=True)
            t.start()
            self._threads.append(t)
        for poller in self._poll:
            t = threading.Thread(target=self._poll_loop, args=(poller,),
                                 name=f"ctrl-{poller.name}", daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        for unsub in self._unsubs:
            unsub()
        self._unsubs.clear()
        for q in self._queues.values():
            q.close()
        for t in self._threads:
            t.join(timeout)
        self._threads.clear()
        self._queues = {c.name: _Queue() for c in self._watch}
        with self._crash_lock:
            self._crash_counts.clear()

    def _make_handler(self, ctrl: WatchController, kind: str, queue: _Queue):
        def handler(event_type: str, obj):
            key = ctrl.map_event(kind, event_type, obj)
            if key:
                queue.add(key)
        return handler

    def _watch_loop(self, ctrl: WatchController, queue: _Queue) -> None:
        while not self._stop.is_set():
            key = queue.get()
            if key is None:
                continue
            if not self.leader():
                # keep the key queued for the leader-to-be (small delay
                # so a follower doesn't spin on one hot key)
                queue.add(key, after=1.0)
                continue
            result = self._reconcile_one(ctrl, key)
            if result.requeue_after > 0:
                queue.add(key, after=result.requeue_after)

    def _poll_loop(self, poller: PollController) -> None:
        wait = 0.0   # first cycle immediately
        while not self._stop.wait(wait):
            if not self.leader():
                wait = min(poller.interval, 1.0)
                continue
            result = self._run_poller(poller)
            wait = result.requeue_after or poller.interval

    def _reconcile_one(self, ctrl: WatchController, key: str) -> Result:
        t0 = time.perf_counter()
        ck = (ctrl.name, key)
        try:
            result = ctrl.reconcile(key) or Result()
        except Exception as e:  # noqa: BLE001 — controllers must not die
            with self._crash_lock:
                crashes = self._crash_counts.get(ck, 0) + 1
                self._crash_counts[ck] = crashes
            # exponent clamp: 2**(crashes-1) overflows float conversion
            # after ~1024 consecutive crashes of one key — the cap is
            # reached long before, so bound the exponent, not the product
            delay = min(self.crash_backoff_cap,
                        self.crash_backoff_initial * (2 ** min(crashes - 1, 30)))
            log.error("reconcile failed", controller=ctrl.name, key=key,
                      error=str(e), crashes=crashes, requeue_after=delay)
            metrics.ERRORS.labels(f"controller.{ctrl.name}", "reconcile").inc()
            result = Result(requeue_after=delay)
        else:
            with self._crash_lock:
                self._crash_counts.pop(ck, None)
        metrics.RECONCILE_DURATION.labels(ctrl.name).observe(
            time.perf_counter() - t0)
        return result

    def _run_poller(self, poller: PollController) -> Result:
        t0 = time.perf_counter()
        try:
            result = poller.reconcile() or Result()
        except Exception as e:  # noqa: BLE001
            log.error("poll reconcile failed", controller=poller.name,
                      error=str(e))
            metrics.ERRORS.labels(f"controller.{poller.name}", "reconcile").inc()
            result = Result()
        metrics.RECONCILE_DURATION.labels(poller.name).observe(
            time.perf_counter() - t0)
        return result

    # -- deterministic sync (tests; also the resync on operator start) -----

    def sync(self, rounds: int = 3) -> None:
        """Reconcile every existing object through every watch controller
        and run every poller once, repeated ``rounds`` times so cascades
        (status -> autoplacement -> ...) settle.  No threads."""
        if not self.leader():
            return   # a follower's resync would actuate (GC deletes etc.)
        for _ in range(rounds):
            for ctrl in self._watch:
                keys: list[str] = []
                for kind in ctrl.watch_kinds:
                    for obj in self.cluster.list(kind):
                        key = ctrl.map_event(kind, "SYNC", obj)
                        if key and key not in keys:
                            keys.append(key)
                # plus anything queued by watch events since the last drain
                queue = self._queues.get(ctrl.name)
                if queue is not None:
                    for key in queue.drain():
                        if key not in keys:
                            keys.append(key)
                for key in keys:
                    self._reconcile_one(ctrl, key)
            for poller in self._poll:
                self._run_poller(poller)
