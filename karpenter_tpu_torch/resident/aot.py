"""AOT signature manifest: persist dispatched-shape knowledge across
restarts (port of ``karpenter_tpu/resident/aot.py``).

Two layers, as in the reference:

1. **The kernels' build directory** (``solver/warmup.py``
   ``enable_persistent_compile_cache``): a restart rebuilds nothing it
   built before.
2. **The signature manifest** (this module): ``obs.devtel`` tracks every
   dispatch's signature (kernel path + bucket-padded G/O/U/N + output
   layout).  The cache records each NEW signature into
   ``aot_manifest.json`` next to the libraries, in the reference's JSON
   format, and :meth:`AOTExecutableCache.prewarm` replays the manifest
   through the port's entry points at start, so a restarted process pays
   each signature's first-dispatch costs (the kernel's first load, a new
   chain instantiation's attribute, the allocator's growth) before its
   first window.  A manifest written by either package reads in the
   other.

Replayed kernels: ``scan``, ``scan-batch`` and ``resident``; the
reference's ``pallas`` and ``pallas-batch`` entries replay on the port's
FFD route (``scan`` / ``scan-batch``), whose hand kernel computes what
those Pallas kernels computed.  The manifest is advisory: unknown
kernels, stale shapes (an O_pad smaller than the current catalog) and
failed replays are skipped, never fatal.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("resident.aot")

MANIFEST_NAME = "aot_manifest.json"
MAX_ENTRIES = 512

# kernels the prewarm replayer knows how to reconstruct dummy inputs
# for; others are recorded anyway (future replayers) but skipped
_PALLAS_KERNELS = {"pallas", "pallas-batch"}
_SUPPORTED = {"scan", "scan-batch", "resident"} | _PALLAS_KERNELS


class AOTExecutableCache:
    """Signature manifest + kernel build directory in one directory."""

    def __init__(self, directory: str):
        self.dir = directory
        self.path = os.path.join(directory, MANIFEST_NAME)
        self._entries: dict[tuple, None] = {}
        self._enabled = False
        self._load()

    # -- persistence -------------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self.path, encoding="utf-8") as f:
                doc = json.load(f)
            for e in doc.get("entries", []):
                sig = tuple(e["signature"])
                self._entries[(e["kernel"], sig)] = None
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 — a corrupt manifest is a cold start
            log.warning("aot manifest unreadable; starting cold",
                        error=str(e)[:200])
            self._entries = {}

    def _flush(self) -> None:
        os.makedirs(self.dir, exist_ok=True)
        doc = {"version": 1,
               "entries": [{"kernel": k, "signature": list(sig)}
                           for (k, sig) in self._entries]}
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # -- recording ---------------------------------------------------------

    def enable(self) -> "AOTExecutableCache":
        """Build the kernels into the directory and start recording new
        dispatch signatures from devtel."""
        from karpenter_tpu_torch.obs.devtel import get_devtel
        from karpenter_tpu_torch.solver.warmup import (
            enable_persistent_compile_cache,
        )

        enable_persistent_compile_cache(self.dir)
        get_devtel().signature_sink = self.record
        self._enabled = True
        return self

    def record(self, kernel: str, signature: tuple) -> None:
        """One new signature (devtel sink).  Only flat int/bool
        signatures round-trip through JSON."""
        if not all(isinstance(v, (int, bool)) for v in signature):
            return
        key = (kernel, tuple(signature))
        if key in self._entries:
            return
        # FIFO eviction at the cap: keep recording what production
        # dispatches now, not the first 512 shapes ever seen
        while len(self._entries) >= MAX_ENTRIES:
            self._entries.pop(next(iter(self._entries)))
        self._entries[key] = None
        try:
            self._flush()
        except OSError as e:
            log.warning("aot manifest write failed", error=str(e)[:200])

    def entries(self) -> list[tuple]:
        return list(self._entries)

    # -- replay ------------------------------------------------------------

    def prewarm(self, solver, catalog, *, block: bool = True) -> dict:
        """Replay every manifest signature through the port's entry
        points (zero-filled problems: the solve is trivial, the first
        dispatch's costs are the point).  Returns ``{"warmed",
        "skipped", "seconds"}``."""
        t0 = time.perf_counter()
        warmed = skipped = 0
        for kernel, sig in list(self._entries):
            if kernel not in _SUPPORTED:
                skipped += 1
                continue
            try:
                done = self._replay_one(solver, catalog, kernel, sig)
            except Exception as e:  # noqa: BLE001 — prewarm is best-effort
                log.warning("aot prewarm entry failed", kernel=kernel,
                            signature=sig, error=str(e)[:200])
                skipped += 1
                continue
            if done:
                warmed += 1
            else:
                skipped += 1
        if block and solver.device.type == "cuda":
            import torch

            torch.cuda.synchronize(solver.device)
        out = {"warmed": warmed, "skipped": skipped,
               "seconds": round(time.perf_counter() - t0, 3)}
        log.info("aot prewarm done", **out)
        return out

    def _replay_one(self, solver, catalog, kernel: str, sig: tuple) -> bool:
        from karpenter_tpu_torch.solver.torch_backend import (
            BatchPendingSolve, _Prepared, pack_input,
        )

        C = D = 0
        if kernel == "resident":
            G, O, U, N, D, K, d16, c16, rs = sig
        elif kernel in ("scan-batch", "pallas-batch"):
            G, O, U, N, C, K, d16, c16, rs = sig
        else:
            G, O, U, N, K, d16, c16, rs = sig
        if O % 32 or O < catalog.num_offerings:
            return False   # stale shape: this catalog no longer fits it
        if bool(rs) != bool(solver.options.right_size):
            return False   # a program this solver never dispatches
        packed = pack_input(np.zeros((G, 4), np.int32),
                            np.zeros(G, np.int32), np.zeros(G, np.int32),
                            np.zeros(G, np.int32), np.zeros((U, O), bool))
        # K is the clamped COO capacity of the recorded dispatch; the
        # dense layouts re-derive from dense16_ok at this shape
        prep = _Prepared(catalog=catalog, G_pad=G, O_pad=O, U_pad=U, N=N,
                         N_cap=N, K0=K, K_cap=K, packed=packed,
                         dense16_ok=bool(d16) or bool(c16))
        if kernel in ("scan", "pallas"):
            solver.dispatch_packed(prep)
            return True
        if kernel in ("scan-batch", "pallas-batch"):
            batch = BatchPendingSolve(solver, [(None, prep)] * C)
            if batch._event is not None:
                batch._event.synchronize()
            return True
        from karpenter_tpu_torch.resident.kernels import (
            new_state, solve_resident,
        )
        from karpenter_tpu_torch.solver.torch_backend import upload

        flat = packed.reshape(-1)
        off_alloc, off_price, off_rank = solver.device_offerings(catalog, O)
        solve_resident(
            new_state(flat, solver.device),
            upload(np.full(D, flat.size, np.int32), solver.device),
            upload(np.zeros(D, np.int32), solver.device),
            off_alloc, off_price, off_rank, G=G, O=O, U=U, N=N,
            right_size=bool(rs), compact=prep.K, dense16=prep.dense16,
            coo16=prep.coo16)
        return True
