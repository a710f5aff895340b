"""Generic request batcher / solve-window coalescer.

Capability parity with the reference's ``pkg/batcher/batcher.go``: hash-
bucketed request coalescing with an idle-timeout / max-timeout / max-items
window (batcher.go:136-196), a bounded executor pool (:95), and per-caller
result delivery (:198-212).  This is the component SURVEY.md §2.7 identifies
as the ancestor of the TPU solve window: callers ``add()`` items, the batcher
fires one handler call per window, and each caller receives its own result.

Design differences from the Go original (deliberate, idiomatic Python):
- per-caller delivery uses Futures instead of channels;
- buckets are computed by a pluggable hasher exactly like DefaultHasher /
  OneBucketHasher (batcher.go:123-134).

(Copy of ``karpenter_tpu/utils/batcher.py``.)
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from collections.abc import Callable, Hashable, Sequence
from typing import Generic, TypeVar

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils import metrics

T = TypeVar("T")  # request item type
U = TypeVar("U")  # per-item result type

# per-item intake spans recorded under a fired window's root span; capped
# so a 10k-pod window costs 32 span slots, not 10k (the rest summarized
# in the root span's attributes)
_INTAKE_SPAN_CAP = 32


def _item_label(item) -> str:
    name = getattr(item, "name", "")
    return name if isinstance(name, str) and name \
        else type(item).__name__


@dataclass
class BatcherOptions:
    """Window semantics (ref batcher.go:33-41; pricing instance 200ms/2s/200
    at getpricing.go:42-46)."""

    idle_timeout: float = 0.2     # seconds of quiet before the window fires
    max_timeout: float = 2.0      # hard cap on window age
    max_items: int = 200          # fire immediately at this many items
    max_workers: int = 8          # executor pool bound (ref caps at 100)
    name: str = "batcher"
    # item -> placement-ledger key (None = this batcher carries items
    # the SLO ledger doesn't track).  The solve window sets pod_key so
    # enqueue is stamped per pod and each fired window links its trace
    # id to the pods it carried (obs/ledger.py).
    ledger_key: Callable | None = None


def one_bucket_hasher(item) -> Hashable:
    return 0


def default_hasher(item) -> Hashable:
    return item if isinstance(item, Hashable) else id(item)


@dataclass
class _Pending(Generic[T, U]):
    item: T
    future: "Future[U]" = field(default_factory=Future)
    # enqueue stamp on the obs clock: the fired window's root span is
    # backdated to the oldest item so the trace shows queueing time
    enqueued_at: float = field(default_factory=obs.now)


class Batcher(Generic[T, U]):
    """Coalesces concurrent ``add`` calls into batched handler invocations.

    ``handler(items) -> results`` is called once per fired window per bucket,
    with results positionally matched back to callers.  A handler exception
    propagates to every caller in the batch.
    """

    def __init__(
        self,
        handler: Callable[[Sequence[T]], Sequence[U]],
        options: BatcherOptions | None = None,
        hasher: Callable[[T], Hashable] = one_bucket_hasher,
    ):
        self._handler = handler
        self._opts = options or BatcherOptions()
        self._hasher = hasher
        self._cv = threading.Condition()
        self._buckets: dict[Hashable, list[_Pending[T, U]]] = {}
        self._bucket_born: dict[Hashable, float] = {}
        self._bucket_last: dict[Hashable, float] = {}
        self._pool = ThreadPoolExecutor(max_workers=self._opts.max_workers,
                                        thread_name_prefix=f"{self._opts.name}-exec")
        self._closed = False
        self._loop = threading.Thread(target=self._run, daemon=True,
                                      name=f"{self._opts.name}-window")
        self._loop.start()

    # -- public ------------------------------------------------------------

    def add(self, item: T) -> "Future[U]":
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher closed")
            bucket = self._hasher(item)
            now = time.monotonic()
            pendings = self._buckets.setdefault(bucket, [])
            if not pendings:
                self._bucket_born[bucket] = now
            self._bucket_last[bucket] = now
            p = _Pending(item)
            pendings.append(p)
            if self._opts.ledger_key is not None:
                obs.get_ledger().stamp(self._opts.ledger_key(item),
                                       "window_enqueue", t=p.enqueued_at)
            self._cv.notify()
            return p.future

    def add_and_wait(self, item: T, timeout: float | None = None) -> U:
        return self.add(item).result(timeout=timeout)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify()
        self._loop.join(timeout=5)
        self._flush_all()
        self._pool.shutdown(wait=True)

    # -- window loop -------------------------------------------------------

    def _run(self) -> None:
        opts = self._opts
        while True:
            with self._cv:
                if self._closed:
                    return
                now = time.monotonic()
                fire: list[Hashable] = []
                deadline = None
                for bucket, pendings in self._buckets.items():
                    if not pendings:
                        continue
                    idle_at = self._bucket_last[bucket] + opts.idle_timeout
                    max_at = self._bucket_born[bucket] + opts.max_timeout
                    fire_at = min(idle_at, max_at)
                    if len(pendings) >= opts.max_items or now >= fire_at:
                        fire.append(bucket)
                    else:
                        deadline = fire_at if deadline is None else min(deadline, fire_at)
                batches = []
                for bucket in fire:
                    batch = self._buckets.pop(bucket)
                    born = self._bucket_born.pop(bucket)
                    self._bucket_last.pop(bucket, None)
                    batches.append((batch, now - born))
                if not batches:
                    self._cv.wait(timeout=None if deadline is None else max(0.0, deadline - now))
                    continue
            for batch, age in batches:
                metrics.BATCH_WINDOW_SECONDS.labels(self._opts.name).observe(age)
                metrics.BATCH_SIZE.labels(self._opts.name).observe(len(batch))
                self._pool.submit(self._exec, batch)

    def _exec(self, batch: list[_Pending[T, U]]) -> None:
        # ONE trace per fired window, rooted at the oldest enqueue: the
        # handler (solve -> actuate -> cloud RPC) runs inside this span's
        # context, so the whole provisioning chain nests under it
        t_fire = obs.now()
        with obs.span(f"batch.window:{self._opts.name}",
                      start=min(p.enqueued_at for p in batch),
                      batcher=self._opts.name, items=len(batch)) as sp:
            if self._opts.ledger_key is not None:
                # the fired window's trace id becomes each pod's bundle
                # link: /debug/slo tail entries point at THIS trace
                obs.get_ledger().link_trace(
                    [self._opts.ledger_key(p.item) for p in batch],
                    sp.trace_id)
            for p in batch[:_INTAKE_SPAN_CAP]:
                obs.record("pod.intake", p.enqueued_at, t_fire, parent=sp,
                           item=_item_label(p.item))
            if len(batch) > _INTAKE_SPAN_CAP:
                sp.set("intake_spans_truncated",
                       len(batch) - _INTAKE_SPAN_CAP)
            try:
                results = self._handler([p.item for p in batch])
                if results is None or len(results) != len(batch):
                    raise ValueError(
                        f"batch handler returned "
                        f"{0 if results is None else len(results)} "
                        f"results for {len(batch)} items")
                for p, r in zip(batch, results):
                    p.future.set_result(r)
            except Exception as e:  # propagate to every caller
                sp.fail(e)
                for p in batch:
                    if not p.future.done():
                        p.future.set_exception(e)

    def _flush_all(self) -> None:
        with self._cv:
            remaining = [p for ps in self._buckets.values() for p in ps]
            self._buckets.clear()
        for p in remaining:
            if not p.future.done():
                p.future.set_exception(RuntimeError("batcher closed"))
