"""Device telemetry: recompiles, transfer bytes, donation misses (copy
of ``karpenter_tpu/obs/devtel.py``).

In the port a "recompile" is the first dispatch of a signature in the
process: the signatures stay the reference's tuples, so counts compare
across packages, and that first dispatch pays the hand kernel's first
load through ``ctypes``, ``cudaFuncSetAttribute`` on a new chain
instantiation and the caching allocator's growth — what
``solver/warmup.py`` pays at start instead.

BENCH_r05 shows the solve path is >98% transfer/dispatch overhead
(exec_fetch ~70 ms vs ~1.2 ms compute; encode_cold ~105-117 ms), but
those numbers were inferred from bench tails — nothing measured them
continuously on the LIVE solve path.  This module is the direct
instrumentation the device-resident-state refactor (ROADMAP item 1)
optimizes against:

- **Recompile events** — every dispatch carries a static-shape
  signature (kernel path + padded G/O/U/N + output layout); a signature
  this process has never dispatched implies an XLA trace+compile (the
  jit cache is keyed by exactly these static args).  Counted per kernel
  and per constraint-signature bucket in
  ``karpenter_tpu_jit_recompiles_total{kernel,bucket}``.
- **Executable-cache hit ratio** — hits/(hits+misses) over the same
  signatures (``karpenter_tpu_executable_cache_events_total{event}``),
  surfaced on ``/statusz`` and ``/debug/slo``.
- **H2D / D2H bytes** — packed-problem uploads, catalog tensor
  re-uploads, and fetched result buffers
  (``karpenter_tpu_device_transfer_bytes_total{direction}`` plus the
  per-window ``karpenter_tpu_solve_h2d_bytes`` histogram).
- **Donation misses** — dispatches whose input was a fresh host array
  instead of a donated device-resident buffer
  (``karpenter_tpu_donation_misses_total{site}``): the per-window
  re-upload debt ROADMAP-1 eliminates.

All accounting happens at DISPATCH level on the host — never inside a
jit-traced function, where a metric call would silently become a
trace-time no-op (graftlint GL107 enforces this over solver/, parallel/,
preempt/ and gang/).
"""

from __future__ import annotations

import threading

from karpenter_tpu_torch.utils import metrics

# distinct static-shape signatures are bounded by the bucket ladders;
# this cap is a leak backstop, far above any real combination count
MAX_SIGNATURES = 4096


class DeviceTelemetry:
    """Thread-safe counters for the live solve path's device traffic."""

    def __init__(self):
        self._lock = threading.Lock()
        # insertion-ordered so the cap evicts FIFO — a plain set would
        # stop admitting at the cap and then count every post-cap
        # signature as a fresh recompile on EVERY dispatch, permanently
        # inflating the exact counter ROADMAP-1 gates its before/after on
        self._signatures: dict[tuple, None] = {}
        self.dispatches = 0
        self.recompiles = 0
        self.cache_hits = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.catalog_uploads = 0
        self.catalog_upload_bytes = 0
        self.donation_misses = 0
        self.donation_miss_bytes = 0
        # explain reason-word share of the fetched result buffers: the
        # [G] int32 words karpenter_tpu/explain appends ride the D2H the
        # solve already pays; this counter makes the overhead auditable
        # (bench gates it < 5% of solve D2H)
        self.explain_d2h_bytes = 0
        # telemetry-word share of the fetched result buffers (the fixed
        # 16-word quality block obs/telemetry_words appends) — same
        # attribution contract as explain_d2h_bytes, same <5% bench gate
        self.telemetry_d2h_bytes = 0
        # resident-state accounting (karpenter_tpu/resident/): windows by
        # mode, delta traffic, last rebuild reason — the /statusz and
        # /debug/slo surface for the store's health
        self.resident_windows = 0
        self.resident_hits = 0
        self.resident_deltas = 0
        self.resident_rebuilds = 0
        self.resident_invalidations = 0
        self.resident_delta_bytes = 0
        self.resident_delta_words_last = 0
        self.resident_bytes = 0
        self.resident_last_rebuild_reason = ""
        self.resident_generation = ""
        # optional hook: called OUTSIDE the lock with (kernel, signature)
        # for every signature this process first dispatches — the AOT
        # executable cache (resident/aot.py) records its manifest here
        self.signature_sink = None
        # optional hook: called OUTSIDE the lock with (kernel,) per
        # recompile event — the anomaly watchdog's burst detector
        # (obs/watchdog.py), installed by obs/prof.get_profiler()
        self.recompile_sink = None

    # -- accounting ----------------------------------------------------------

    def note_dispatch(self, kernel: str, signature: tuple, *,
                      h2d_bytes: int = 0, donated: bool = True,
                      backend: str = "torch") -> bool:
        """One kernel dispatch.  Returns True when the signature was new
        (an executable-cache miss => recompile event)."""
        sig = (kernel, signature)
        with self._lock:
            new = sig not in self._signatures
            if new:
                while len(self._signatures) >= MAX_SIGNATURES:
                    self._signatures.pop(next(iter(self._signatures)))
                self._signatures[sig] = None
            self.dispatches += 1
            if new:
                self.recompiles += 1
            else:
                self.cache_hits += 1
            if h2d_bytes:
                self.h2d_bytes += h2d_bytes
            if not donated:
                self.donation_misses += 1
                self.donation_miss_bytes += h2d_bytes
        bucket = self._bucket(signature)
        if new:
            metrics.JIT_RECOMPILES.labels(kernel, bucket).inc()
            sink = self.signature_sink
            if sink is not None:
                try:
                    sink(kernel, signature)
                except Exception:  # noqa: BLE001 — telemetry must never fail a solve
                    pass
            rsink = self.recompile_sink
            if rsink is not None:
                try:
                    rsink(kernel)
                except Exception:  # noqa: BLE001 — telemetry must never fail a solve
                    pass
        metrics.EXEC_CACHE.labels("miss" if new else "hit").inc()
        if h2d_bytes:
            metrics.TRANSFER_BYTES.labels("h2d").inc(h2d_bytes)
            metrics.SOLVE_H2D_BYTES.labels(backend).observe(h2d_bytes)
        if not donated:
            metrics.DONATION_MISSES.labels(kernel).inc()
        return new

    def note_catalog_upload(self, nbytes: int) -> None:
        """Catalog tensors re-uploaded (device-catalog cache miss)."""
        with self._lock:
            self.catalog_uploads += 1
            self.catalog_upload_bytes += nbytes
            self.h2d_bytes += nbytes
        metrics.TRANSFER_BYTES.labels("h2d").inc(nbytes)

    def note_d2h(self, nbytes: int) -> None:
        with self._lock:
            self.d2h_bytes += nbytes
        metrics.TRANSFER_BYTES.labels("d2h").inc(nbytes)

    def note_explain_d2h(self, nbytes: int) -> None:
        """The explain reason-word slice of a fetched result buffer
        (already counted in note_d2h's total — this is the attribution,
        not an extra transfer)."""
        with self._lock:
            self.explain_d2h_bytes += nbytes

    def note_telemetry_d2h(self, nbytes: int) -> None:
        """The telemetry-word slice of a fetched result buffer (already
        counted in note_d2h's total — attribution, not an extra
        transfer)."""
        with self._lock:
            self.telemetry_d2h_bytes += nbytes

    def note_resident_window(self, mode: str, *, h2d_bytes: int = 0,
                             words: int = 0, reason: str = "",
                             resident_bytes: int = 0,
                             generation=None) -> None:
        """One window through the resident store: ``mode`` is hit (no
        change, zero-delta dispatch), delta (compact update tensors), or
        rebuild (full re-upload; ``reason`` says why)."""
        with self._lock:
            self.resident_windows += 1
            if mode == "hit":
                self.resident_hits += 1
            elif mode == "delta":
                self.resident_deltas += 1
            else:
                self.resident_rebuilds += 1
                self.resident_last_rebuild_reason = reason
            self.resident_delta_bytes += h2d_bytes
            self.resident_delta_words_last = words
            self.resident_bytes = resident_bytes
            if generation is not None:
                self.resident_generation = str(generation)
        metrics.RESIDENT_WINDOWS.labels(mode).inc()
        if mode == "rebuild":
            metrics.RESIDENT_REBUILDS.labels(reason or "unknown").inc()
        metrics.RESIDENT_DELTA_BYTES.observe(h2d_bytes)

    def note_resident_invalidation(self, reason: str) -> None:
        """An explicit store invalidation.  Deliberately NOT counted as
        a rebuild: the reason rides to the next window's actual rebuild
        (note_resident_window), so one logical rebuild is counted once —
        under its cause, not a generic "cold"."""
        with self._lock:
            self.resident_invalidations += 1
            self.resident_last_rebuild_reason = reason

    # -- readout -------------------------------------------------------------

    @staticmethod
    def _bucket(signature: tuple) -> str:
        """Constraint-signature bucket label: the padded problem shape
        (the jit cache key's dominant axis), kept low-cardinality."""
        dims = [str(v) for v in signature
                if isinstance(v, int) and not isinstance(v, bool)][:3]
        return "x".join(dims) if dims else "scalar"

    def hit_ratio(self) -> float:
        with self._lock:
            total = self.cache_hits + self.recompiles
            return self.cache_hits / total if total else 1.0

    def snapshot(self) -> dict:
        with self._lock:
            total = self.cache_hits + self.recompiles
            return {
                "dispatches": self.dispatches,
                "recompiles": self.recompiles,
                "executable_cache_hits": self.cache_hits,
                "executable_cache_hit_ratio":
                    round(self.cache_hits / total, 4) if total else 1.0,
                "h2d_bytes": self.h2d_bytes,
                "d2h_bytes": self.d2h_bytes,
                "catalog_uploads": self.catalog_uploads,
                "catalog_upload_bytes": self.catalog_upload_bytes,
                "donation_misses": self.donation_misses,
                "donation_miss_bytes": self.donation_miss_bytes,
                "explain_d2h_bytes": self.explain_d2h_bytes,
                "telemetry_d2h_bytes": self.telemetry_d2h_bytes,
                "resident": {
                    "windows": self.resident_windows,
                    "hits": self.resident_hits,
                    "deltas": self.resident_deltas,
                    "rebuilds": self.resident_rebuilds,
                    "invalidations": self.resident_invalidations,
                    "delta_h2d_bytes": self.resident_delta_bytes,
                    "last_delta_words": self.resident_delta_words_last,
                    "resident_bytes": self.resident_bytes,
                    "last_rebuild_reason": self.resident_last_rebuild_reason,
                    "generation": self.resident_generation,
                },
            }

    def reset(self) -> None:
        """Bench section isolation (signatures survive — the process's
        compiled executables don't evaporate between sections)."""
        with self._lock:
            self.dispatches = self.recompiles = self.cache_hits = 0
            self.h2d_bytes = self.d2h_bytes = 0
            self.catalog_uploads = self.catalog_upload_bytes = 0
            self.donation_misses = self.donation_miss_bytes = 0
            self.explain_d2h_bytes = 0
            self.telemetry_d2h_bytes = 0
            self.resident_windows = self.resident_hits = 0
            self.resident_deltas = self.resident_rebuilds = 0
            self.resident_invalidations = self.resident_delta_bytes = 0
            self.resident_delta_words_last = self.resident_bytes = 0


# process-wide singleton: dispatch sites are module functions/methods
# spread across solver/ and parallel/, and the refactor's before/after
# comparison needs ONE ledger of device traffic
DEVTEL = DeviceTelemetry()


def get_devtel() -> DeviceTelemetry:
    return DEVTEL
