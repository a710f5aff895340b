"""TTL cache with anti-stampede get-or-set.

Capability parity with the reference's ``pkg/cache/cache.go`` (RW-mutex map
with janitor goroutine, ``GetOrSet`` anti-stampede at cache.go:160-196) —
re-designed for Python: a lock-striped dict with per-key in-flight locks so
concurrent misses on the same key compute once.

(Copy of ``karpenter_tpu/utils/cache.py``.)
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable
from typing import Any

_SENTINEL = object()


class TTLCache:
    """Thread-safe TTL cache.

    - ``get``/``set`` with per-entry TTL (or the default).
    - ``get_or_set(key, fn)`` computes at most once per expiry across
      concurrent callers (anti-stampede).
    - Expired entries are purged lazily on access and by ``cleanup()``
      (host pollers call it, mirroring the janitor goroutine).
    """

    def __init__(self, default_ttl: float = 300.0, clock: Callable[[], float] = time.monotonic):
        self._default_ttl = default_ttl
        self._clock = clock
        self._lock = threading.RLock()
        self._data: dict[Any, tuple[Any, float]] = {}  # key -> (value, expires_at)
        self._inflight: dict[Any, threading.Lock] = {}

    def set(self, key: Any, value: Any, ttl: float | None = None) -> None:
        expires = self._clock() + (self._default_ttl if ttl is None else ttl)
        with self._lock:
            self._data[key] = (value, expires)

    def get(self, key: Any, default: Any = None) -> Any:
        now = self._clock()
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return default
            value, expires = entry
            if now >= expires:
                del self._data[key]
                return default
            return value

    def contains(self, key: Any) -> bool:
        return self.get(key, _SENTINEL) is not _SENTINEL

    def delete(self, key: Any) -> None:
        with self._lock:
            self._data.pop(key, None)
            self._inflight.pop(key, None)

    def get_or_set(self, key: Any, fn: Callable[[], Any], ttl: float | None = None) -> Any:
        """Return cached value, computing ``fn()`` at most once per miss.

        Concurrent callers missing on the same key block on a per-key lock;
        only the first computes (the reference's lock-upgrade pattern,
        cache.go:160-196).
        """
        value = self.get(key, _SENTINEL)
        if value is not _SENTINEL:
            return value
        with self._lock:
            key_lock = self._inflight.setdefault(key, threading.Lock())
        with key_lock:
            # Double-check under the per-key lock.
            value = self.get(key, _SENTINEL)
            if value is not _SENTINEL:
                return value
            value = fn()
            self.set(key, value, ttl)
            return value

    def cleanup(self) -> int:
        """Purge expired entries; returns number purged."""
        now = self._clock()
        with self._lock:
            dead = [k for k, (_, exp) in self._data.items() if now >= exp]
            for k in dead:
                del self._data[k]
            # Drop in-flight locks with no live entry so churning key sets
            # don't leak lock objects — but never one currently held by a
            # computing thread, which would let a second caller race past
            # the anti-stampede guarantee.
            for k in list(self._inflight):
                if k not in self._data and not self._inflight[k].locked():
                    del self._inflight[k]
            return len(dead)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def keys(self):
        now = self._clock()
        with self._lock:
            return [k for k, (_, exp) in self._data.items() if now < exp]
