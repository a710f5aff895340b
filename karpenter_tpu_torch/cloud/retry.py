"""Retry stack: exponential backoff + decorrelated jitter + 429
Retry-After honoring.

Parity with the reference's two retry layers:
- exponential backoff 1s -> 15s cap, 10 steps for catalog listing
  (instancetype.go:440-446);
- generic rate-limit retry that honors Retry-After
  (ratelimit_retry.go:39).

On top of parity: **decorrelated jitter** (the AWS architecture-blog
schedule: ``wait = min(cap, uniform(initial, prev_wait * 3))``).  A pure
exponential schedule synchronizes retry storms — every controller that
failed in the same cloud brownout retries in the same instant, forever.
Jitter decorrelates the fleet while keeping the same bounds
(``min(initial, cap) <= wait <= cap``).  Pass a seeded ``random.Random``
as ``rng`` for a deterministic schedule (tests, the chaos harness);
``jitter=False`` pins the exact geometric ramp.

(Copy of ``karpenter_tpu/cloud/retry.py``.)
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from collections.abc import Callable
from typing import TypeVar

from karpenter_tpu_torch.cloud.errors import is_rate_limit, is_retryable, parse_error
from karpenter_tpu_torch import obs
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.retry")

T = TypeVar("T")


@dataclass
class RetryConfig:
    initial: float = 1.0
    factor: float = 2.0
    cap: float = 15.0
    steps: int = 10
    honor_retry_after: bool = True
    # decorrelated jitter on every backoff wait; False pins the pure
    # geometric ramp (pinned-schedule tests, lockstep simulations)
    jitter: bool = True


def retry_with_backoff(fn: Callable[[], T], config: RetryConfig = None,
                       sleep: Callable[[float], None] | None = None,
                       operation: str = "",
                       rng: random.Random | None = None,
                       budget: float | None = None) -> T:
    """Call ``fn`` with exponential backoff on retryable errors.

    Non-retryable errors raise immediately; the last error raises after
    ``steps`` attempts.  With ``config.jitter`` each wait is drawn
    decorrelated from the previous one (bounded by ``initial``/``cap``);
    a server Retry-After always overrides the drawn wait verbatim.

    ``budget`` is an overall wall-clock deadline in seconds that retries
    AND Retry-After sleeps must respect: a wait that would end at or
    past ``now + budget`` is never started — the last error raises
    instead (sleeping a clamped remainder would waste the whole wait,
    and retrying before a server-mandated Retry-After elapses would
    violate it).  A retry loop must never outlive its caller's requeue
    interval; the controller re-enters on its own schedule.
    """
    cfg = config or RetryConfig()
    if sleep is None:
        # resolved at call time, NOT bound as a default at import — the
        # chaos VirtualClock patches time.sleep so injected Retry-After
        # waits cost scenario time, and an import-time default would
        # capture the real sleep before the patch
        sleep = time.sleep
    # deadline resolved at call time for the same VirtualClock reason
    deadline = (time.monotonic() + budget) if budget is not None else None
    draw = (rng or random).uniform if cfg.jitter else None
    # the cap bounds EVERY wait, including the first (a misconfigured
    # initial > cap must not produce one over-cap sleep)
    floor = min(cfg.initial, cfg.cap)
    delay = floor
    last: Exception = RuntimeError("retry_with_backoff: no attempts")
    for attempt in range(cfg.steps):
        try:
            # one span per attempt: retried RPCs show up in a dumped
            # trace as N sibling spans with the backoff decisions as
            # events on the enclosing span
            with obs.span("rpc.attempt", operation=operation or "call",
                          attempt=attempt + 1):
                return fn()
        except Exception as e:  # noqa: BLE001 — classified below
            err = parse_error(e, operation)
            if not is_retryable(err):
                raise
            last = e
            wait = delay
            if cfg.honor_retry_after and is_rate_limit(err) and err.retry_after > 0:
                wait = err.retry_after
            if attempt < cfg.steps - 1:
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    # boundary clamp: wait == remaining is already too
                    # late (the post-sleep attempt would start at the
                    # deadline), so >= stops the loop here
                    if wait >= remaining:
                        obs.event("backoff.budget_exhausted",
                                  operation=operation, attempt=attempt + 1,
                                  wait=round(wait, 4),
                                  remaining=round(max(remaining, 0.0), 4))
                        raise last
                log.debug("retrying after error", operation=operation,
                          attempt=attempt + 1, wait=wait, error=str(e))
                obs.event("backoff", operation=operation,
                          attempt=attempt + 1, wait=round(wait, 4),
                          retry_after=err.retry_after > 0,
                          error=str(e)[:120])
                sleep(wait)
                if draw is not None:
                    # decorrelated: next draw ranges off the PREVIOUS
                    # drawn delay (not the server hint), clamped to
                    # [floor, cap]
                    delay = min(cfg.cap, max(floor, draw(floor, delay * 3)))
                else:
                    delay = min(delay * cfg.factor, cfg.cap)
    raise last
