"""Unavailable-offerings cache: TTL'd blackout set for (type, zone, capacity).

Parity with the reference's ``pkg/cache/unavailable_offerings.go:24-87`` —
the shared availability feedback channel between the catalog, interruption
controller, and spot-preemption controller (wired at operator.go:62-63).
In the TPU build this is the *writer* of the availability mask column of the
device-resident catalog tensors.

(Copy of ``karpenter_tpu/catalog/unavailable.py``.)
"""

from __future__ import annotations

import time
from collections.abc import Callable

from karpenter_tpu_torch.utils.cache import TTLCache


def offering_key(instance_type: str, zone: str, capacity_type: str) -> str:
    return f"{instance_type}:{zone}:{capacity_type}"


class UnavailableOfferings:
    DEFAULT_TTL = 3600.0  # spot preemption blacks out for 1h (preemption/controller.go:97)

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._cache = TTLCache(default_ttl=self.DEFAULT_TTL, clock=clock)

    def mark_unavailable(self, instance_type: str, zone: str, capacity_type: str,
                         ttl: float = None, reason: str = "") -> None:
        self._cache.set(offering_key(instance_type, zone, capacity_type),
                        reason or "unavailable", ttl)

    def is_unavailable(self, instance_type: str, zone: str, capacity_type: str) -> bool:
        return self._cache.contains(offering_key(instance_type, zone, capacity_type))

    def is_unavailable_key(self, key: str) -> bool:
        return self._cache.contains(key)

    def unavailable_keys(self) -> list[str]:
        return list(self._cache.keys())

    def cleanup(self) -> int:
        """Called by the hourly catalog-refresh singleton
        (controllers/providers/instancetype/instancetype.go:58)."""
        return self._cache.cleanup()

    @property
    def generation(self) -> frozenset:
        """The set of currently-live blackout keys.  Consumers (catalog
        arrays, availability-cached lists) compare generations for equality;
        any write *or* TTL expiry — including lazy expiry inside the cache —
        changes the value, so stale masks can never survive an expired
        blackout."""
        return frozenset(self._cache.keys())
