"""Cached cloud-client manager
(port of ``karpenter_tpu/cloud/client_manager.py``).

Parity with ``pkg/utils/vpcclient`` (manager.go:52-148): client
construction is expensive (auth handshake), so a TTL-cached instance is
shared, with explicit invalidation on auth failures and an error-logging
helper that classifies through the shared taxonomy.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable
from typing import Generic, TypeVar

from karpenter_tpu_torch.cloud.errors import is_auth, parse_error
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("cloud.client_manager")

C = TypeVar("C")


class ClientManager(Generic[C]):
    """TTL-cached client with invalidate-on-auth-failure."""

    def __init__(self, build: Callable[[], C], ttl: float | None = None,
                 clock: Callable[[], float] = time.monotonic):
        from karpenter_tpu_torch.constants import (
            DEFAULT_CLIENT_CACHE_TTL_SECONDS,
        )

        self._build = build
        self._ttl = float(DEFAULT_CLIENT_CACHE_TTL_SECONDS) if ttl is None \
            else ttl
        self._clock = clock
        self._lock = threading.Lock()
        self._client: C | None = None
        self._built_at = -float("inf")

    def get(self) -> C:
        with self._lock:
            if self._client is None or \
                    self._clock() - self._built_at >= self._ttl:
                self._client = self._build()
                self._built_at = self._clock()
            return self._client

    def invalidate(self) -> None:
        with self._lock:
            self._client = None
            self._built_at = -float("inf")

    def call(self, op: Callable[[C], object], operation: str = "call"):
        """Run ``op(client)``; on auth errors the cached client is dropped
        so the next call re-authenticates (manager.go invalidation +
        HandleVPCError logging semantics)."""
        try:
            return op(self.get())
        except Exception as e:
            err = parse_error(e, operation)
            if is_auth(err):
                log.warning("auth failure; invalidating cached client",
                            operation=operation, error=str(err))
                self.invalidate()
            raise
