"""Pricing provider with TTL map + batched fetch.

Parity with ``pkg/providers/common/pricing/``: 12h TTL price map with
double-checked refresh (ibm_provider.go:34-62, :115-137), per-entry fetches
deduped and coalesced through the generic batcher (the PricingBatcher
instance: 200ms idle / 2s max / 200 items, batcher/getpricing.go:38-92),
prices uniform across zones within a region (:156-171).

(Copy of ``karpenter_tpu/catalog/pricing.py``.)
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable, Sequence

from karpenter_tpu_torch.utils.batcher import Batcher, BatcherOptions
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("catalog.pricing")


class PricingProvider:
    TTL = 12 * 3600.0  # 12h (ibm_provider.go:34)

    def __init__(self, client, clock: Callable[[], float] = time.monotonic,
                 batcher_options: BatcherOptions | None = None):
        self._client = client
        self._clock = clock
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._prices: dict[str, float] = {}
        self._fetched_at: float = -1e18
        self._batcher: Batcher = Batcher(
            self._fetch_batch,
            batcher_options or BatcherOptions(idle_timeout=0.2, max_timeout=2.0,
                                              max_items=200, name="pricing"))

    # -- public (provider.go:26-35) ---------------------------------------

    def get_price(self, instance_type: str, zone: str = "") -> float:
        """$/h on-demand; zone-uniform within the region (:156-171).
        Returns 0.0 when unknown (callers rank price-less types by size)."""
        self._ensure_fresh()
        with self._lock:
            return self._prices.get(instance_type, 0.0)

    def get_prices(self, zone: str = "") -> dict[str, float]:
        self._ensure_fresh()
        with self._lock:
            return dict(self._prices)

    def refresh(self) -> None:
        """Force re-fetch regardless of TTL (12h singleton hook,
        controllers/providers/pricing/controller.go:62)."""
        self._fetch_all(force=True)

    def close(self) -> None:
        self._batcher.close()

    # -- internals ---------------------------------------------------------

    def _ensure_fresh(self) -> None:
        with self._lock:
            fresh = self._clock() - self._fetched_at < self.TTL
        if not fresh:
            self._fetch_all()

    def _fetch_all(self, force: bool = False) -> None:
        # Double-checked refresh: one thread fetches, concurrent callers
        # block on the refresh lock and see fresh data when it releases
        # (:115-137).
        with self._refresh_lock:
            with self._lock:
                if not force and self._clock() - self._fetched_at < self.TTL \
                        and self._prices:
                    return
            # deliberate: _refresh_lock serializes REFRESHERS across this
            # RPC (double-checked refresh); readers only take _lock and
            # never stall behind it
            names = [p.name for p in self._client.list_instance_profiles()]  # graftlint: disable=GL101
            # dedupe (getpricing.go dedups by catalog entry id)
            futures = {n: self._batcher.add(n) for n in dict.fromkeys(names)}
            prices = {}
            for name, fut in futures.items():
                try:
                    value = fut.result(timeout=30)
                    if value is not None:
                        prices[name] = value
                except Exception as e:  # batch-level failure is non-fatal too
                    log.warning("pricing fetch failed", type=name, error=str(e))
            with self._lock:
                self._prices.update(prices)
                self._fetched_at = self._clock()
            log.info("pricing refreshed", entries=len(prices))

    def _fetch_batch(self, names: Sequence[str]) -> list[float | None]:
        # Per-item isolation: one failing entry must not poison the whole
        # window (the batcher propagates a handler exception to every
        # caller in the batch).
        out: list[float | None] = []
        for n in names:
            try:
                out.append(self._client.get_pricing(n))
            except Exception as e:  # noqa: BLE001 — miss is non-fatal
                log.warning("pricing fetch failed", type=n, error=str(e))
                out.append(None)
        return out


class StaticPricingProvider:
    """NoOp/static fallback (ref pricing controller fallback,
    controllers/providers/pricing/controller.go:38-50)."""

    def __init__(self, prices: dict[str, float] | None = None):
        self._prices = dict(prices or {})

    def get_price(self, instance_type: str, zone: str = "") -> float:
        return self._prices.get(instance_type, 0.0)

    def get_prices(self, zone: str = "") -> dict[str, float]:
        return dict(self._prices)

    def refresh(self) -> None:
        pass

    def close(self) -> None:
        pass
