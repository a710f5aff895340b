"""Generation-tracked device-resident state: the store itself (port of
``karpenter_tpu/resident/store.py``).

- :class:`ResidentStore` — the solver-side store.  ``TorchSolver`` sends
  every preference-free window of the FFD route through
  :meth:`ResidentStore.dispatch_solve` (delta-apply + solve, one device
  input of delta size); a host-side tracker rides
  :meth:`ResidentStore.track_window`, which keeps the same mirror and
  device buffer through the standalone update.
- :class:`ResidentBuffer` — one resident int32 buffer + its host mirror;
  the fleet keeps its stacked [C, Li] input resident with it.

A state's device tensor is used only while its recorded generation
equals the catalog's ``(generation, availability_generation)`` and the
window's padded shape matches; anything else rebuilds from the host,
with the reason recorded.  A window whose resident program fails on the
host side invalidates the store and re-runs on the classic route, which
launches the same hand kernel (``TorchSolver``, as the reference's
``_dispatch_resident``); a ``DeviceFaultError`` invalidates the store
and raises.

- :meth:`ResidentStore.occupancy_tensors` / :meth:`ResidentStore.
  occupancy_rows` — one int32 row per live claim (offering, pod count,
  residual capacity) kept resident through the same delta path; the
  repack plane's scoring grid reads the device rows directly.
- :class:`OccupancySnapshot` — one occupancy view per repack tick, in
  place of a scan of every pod per claim.

Every device update and solve runs inside ``faulttol.device_guard`` and
a sampled ``obs.prof`` bracket (kernels ``resident-update`` — or the
caller's name, ``fleet-resident`` — and ``resident``), and every window
is noted in ``obs.devtel`` (``note_resident_window``, ``note_dispatch``,
``note_resident_invalidation``) as the reference notes it.  Where the
reference catches a ``DeviceFaultError`` of the standalone update and
rebuilds from the host in silence, the port invalidates and raises, so
the fault reaches a caller that counts it (a deliberate difference,
listed in ROADMAP.md).
"""

from __future__ import annotations

import threading

import numpy as np

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.resident.delta import (
    DELTA_BUCKETS, REBUILD_FRACTION, WindowDelta, diff_words, empty_delta,
    pack_window, pad_delta, pod_churn,
)

def plan_update(buf, flat: np.ndarray, generation: tuple | None):
    """The one cold / generation / shape / oversized-delta ladder of every
    resident consumer.  ``buf`` has mirror/dev/generation/pending_reason.
    Returns ``(reason, idx)``: a non-empty reason means rebuild (a pending
    invalidation reason wins over "cold"); otherwise ``idx`` holds the
    changed words (empty = hit)."""
    if buf.dev is None or buf.mirror is None:
        return buf.pending_reason or "cold", None
    if buf.generation != generation:
        return "generation", None
    if buf.mirror.shape != flat.shape:
        return "shape", None
    idx = diff_words(buf.mirror, flat)
    if idx.size > max(64, flat.size * REBUILD_FRACTION):
        return "delta_too_large", None
    return "", idx


class ResidentBuffer:
    """One device-resident int32 buffer + its host mirror.

    ``update(host, device)`` returns the device buffer to use: a window
    with no change reuses it outright (no H2D), a small diff is scattered
    in place as a padded (idx, val) pair, and a shape, generation or
    device change or an oversized diff rebuilds from the host.  The
    mirror always equals the device content.  ``dev`` is the state
    tensor, L + 1 words with the spare word last
    (``resident/kernels.py``)."""

    __slots__ = ("name", "mirror", "dev", "generation", "stats",
                 "pending_reason")

    def __init__(self, name: str = "buffer"):
        self.name = name
        self.mirror: np.ndarray | None = None
        self.dev = None
        self.generation: tuple | None = None
        self.stats = {"hit": 0, "delta": 0, "rebuild": 0}
        # an invalidation's reason, reported by the next rebuild
        self.pending_reason = ""

    def invalidate(self, reason: str = "") -> None:
        self.mirror = None
        self.dev = None
        self.generation = None
        self.pending_reason = reason

    def rebuild(self, flat: np.ndarray, device, generation) -> None:
        """Replace the state with ``flat`` uploaded to ``device``."""
        from karpenter_tpu_torch.resident.kernels import new_state

        self.dev = new_state(flat, device)
        self.mirror = flat.copy()
        self.generation = generation
        self.pending_reason = ""
        self.stats["rebuild"] += 1

    def update(self, host: np.ndarray, device, generation=None,
               kernel: str = "resident-update"):
        """-> (device buffer of ``host``'s shape, WindowDelta).  ``host``
        must be int32.  The scatter runs under ``device_guard(kernel)``;
        a failed scatter invalidates the buffer and raises (the reference
        rebuilds from the host there, silently)."""
        from karpenter_tpu_torch.resident.kernels import update_resident
        from karpenter_tpu_torch.solver.torch_backend import upload

        dev = resolve_device(device)
        flat = host.reshape(-1)
        if self.dev is not None and self.dev.device != dev:
            self.invalidate("device")
        reason, idx = plan_update(self, flat, generation)
        if reason:
            self.rebuild(flat, dev, generation)
            delta = WindowDelta(mode="rebuild", words=int(flat.size),
                                h2d_bytes=int(host.nbytes), reason=reason)
        elif idx.size == 0:
            self.stats["hit"] += 1
            delta = WindowDelta(mode="hit", words=0, h2d_bytes=0)
        else:
            didx, dval = pad_delta(idx, flat[idx], flat.size)
            try:
                with device_guard(kernel, devices=[device_id(dev)]):
                    with get_profiler().sampled(kernel) as probe:
                        update_resident(self.dev, upload(didx, dev),
                                        upload(dval, dev))
                        # fetch=False: the updated state stays resident;
                        # fetching all of it would measure a transfer
                        # production never makes
                        probe.dispatched(self.dev, fetch=False)
            except Exception:
                self.invalidate("update_error")
                raise
            self.mirror[idx] = flat[idx]
            self.stats["delta"] += 1
            delta = WindowDelta(mode="delta", words=int(idx.size),
                                h2d_bytes=int(didx.nbytes + dval.nbytes))
        self._note(kernel, host, delta, generation)
        return self.dev[:-1].view(host.shape), delta

    @staticmethod
    def _note(kernel: str, host: np.ndarray, delta: WindowDelta,
              generation) -> None:
        get_devtel().note_resident_window(
            delta.mode, h2d_bytes=delta.h2d_bytes, words=delta.words,
            reason=delta.reason, resident_bytes=int(host.nbytes),
            generation=generation)
        if delta.mode != "hit":
            get_devtel().note_dispatch(
                kernel, (host.size, delta.mode == "rebuild"),
                h2d_bytes=delta.h2d_bytes, donated=delta.mode == "delta")


class _SolveState:
    """Per-(catalog uid, padded shape) resident solve state: the buffer
    plus the tracked window's pod-key set."""

    __slots__ = ("buf", "pod_keys")

    def __init__(self):
        self.buf = ResidentBuffer(name="solve")
        self.pod_keys: frozenset = frozenset()


class ResidentStore:
    """The solver-side store: keyed resident solve states + counters, on
    ``device`` (the card unless the CPU is asked for)."""

    MAX_STATES = 8   # distinct (catalog uid, shape) combinations kept

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._states: dict[tuple, _SolveState] = {}
        self.windows = 0
        self.rebuilds = 0
        self.invalidations = 0
        self.last_delta: WindowDelta | None = None
        self.last_rebuild_reason = ""
        self.last_key: tuple | None = None
        self._occ_buf: ResidentBuffer | None = None

    def _state_for(self, key: tuple) -> _SolveState:
        with self._lock:
            st = self._states.get(key)
            if st is None:
                while len(self._states) >= self.MAX_STATES:
                    self._states.pop(next(iter(self._states)))
                st = self._states[key] = _SolveState()
            return st

    def invalidate(self, reason: str = "invalidated") -> None:
        """Drop every resident state: the next window of each key
        rebuilds from the host, reporting ``reason``."""
        with self._lock:
            for st in self._states.values():
                st.buf.invalidate(reason)
            self.invalidations += 1
        get_devtel().note_resident_invalidation(reason)

    def _account(self, key: tuple, delta: WindowDelta) -> None:
        with self._lock:
            self.windows += 1
            if delta.mode == "rebuild":
                self.rebuilds += 1
                self.last_rebuild_reason = delta.reason
            self.last_delta = delta
            self.last_key = key

    def dispatch_solve(self, prep, packed: np.ndarray, catalog_tensors,
                       right_size: bool):
        """Delta-apply + solve of one prepared window on the store's
        device; returns the device result buffer (the layout of
        ``solve_packed_torch``).  The caller (``TorchSolver``)
        invalidates the store when this raises, and re-runs the window on
        the classic route unless it raised a ``DeviceFaultError``."""
        from karpenter_tpu_torch.resident.kernels import solve_resident
        from karpenter_tpu_torch.solver.torch_backend import upload

        catalog = prep.catalog
        key = (catalog.uid, prep.G_pad, prep.O_pad, prep.U_pad)
        gen = (catalog.generation, catalog.availability_generation)
        buf = self._state_for(key).buf
        flat = packed.reshape(-1)
        t0 = obs.now()
        reason, idx = plan_update(buf, flat, gen)
        if reason:
            buf.rebuild(flat, self.device, gen)
            didx, dval = empty_delta(flat.size)
            delta = WindowDelta(mode="rebuild", words=int(flat.size),
                                h2d_bytes=int(flat.nbytes), reason=reason)
        else:
            didx, dval = pad_delta(idx, flat[idx], flat.size)
            if idx.size:
                buf.mirror[idx] = flat[idx]
                buf.stats["delta"] += 1
                delta = WindowDelta(
                    mode="delta", words=int(idx.size),
                    h2d_bytes=int(didx.nbytes + dval.nbytes))
            else:
                # an unchanged window: the all-padding pair still rides,
                # so the program is the same, but it is a hit
                buf.stats["hit"] += 1
                delta = WindowDelta(mode="hit", words=0,
                                    h2d_bytes=int(didx.nbytes + dval.nbytes))
        off_alloc, off_price, off_rank = catalog_tensors
        get_devtel().note_dispatch(
            "resident", (prep.G_pad, prep.O_pad, prep.U_pad, prep.N,
                         didx.size, prep.K, prep.dense16, prep.coo16,
                         right_size),
            h2d_bytes=delta.h2d_bytes, donated=delta.mode != "rebuild")
        get_devtel().note_resident_window(
            delta.mode, h2d_bytes=delta.h2d_bytes, words=delta.words,
            reason=delta.reason, resident_bytes=int(flat.nbytes),
            generation=(catalog.uid,) + gen)
        with device_guard("resident", devices=[device_id(self.device)]):
            with get_profiler().sampled("resident") as probe:
                buf.dev, out = solve_resident(
                    buf.dev, upload(didx, self.device),
                    upload(dval, self.device), off_alloc, off_price,
                    off_rank, G=prep.G_pad, O=prep.O_pad, U=prep.U_pad,
                    N=prep.N, right_size=right_size, compact=prep.K,
                    dense16=prep.dense16, coo16=prep.coo16)
                probe.dispatched(out)
        self._account(key, delta)
        obs.record("resident.window", t0, obs.now(), mode=delta.mode,
                   words=delta.words, h2d_bytes=delta.h2d_bytes,
                   reason=delta.reason)
        return out

    def track_window(self, pods, catalog, nodepool=None) -> WindowDelta:
        """Keep the resident state of a window without solving it:
        encode, pack, and apply the delta through the standalone
        update."""
        from karpenter_tpu_torch.solver.encode import encode

        problem = encode(pods, catalog, nodepool)
        packed, (G_pad, O_pad, U_pad) = pack_window(problem)
        key = (catalog.uid, G_pad, O_pad, U_pad)
        gen = (catalog.generation, catalog.availability_generation)
        st = self._state_for(key)
        arrivals, departures, cur = pod_churn(st.pod_keys, pods)
        st.pod_keys = cur
        _, delta = st.buf.update(packed, self.device, gen)
        delta = WindowDelta(mode=delta.mode, words=delta.words,
                            h2d_bytes=delta.h2d_bytes, reason=delta.reason,
                            arrivals=arrivals, departures=departures)
        self._account(key, delta)
        return delta

    # -- device-resident claim occupancy -----------------------------------

    def occupancy_tensors(self, cluster, catalog):
        """The claim occupancy rows, resident on the store's device: one
        int32 row ``[offering, pod_count, resid_cpu, resid_mem,
        resid_gpu, resid_pods]`` per live launched claim (cluster
        insertion order, padded to a node bucket), kept through the
        delta path of the solve state, so claim churn and pod binds move
        a few rows per tick.  Returns ``(claim_names, device rows
        [Nn_pad, 6] int32, WindowDelta)``."""
        from karpenter_tpu_torch.apis.pod import NUM_RESOURCES
        from karpenter_tpu_torch.preempt.encode import (
            _pod_req_vec, claim_pods, occupancy_index,
        )
        from karpenter_tpu_torch.solver.types import NODE_BUCKETS, bucket

        idx = occupancy_index(cluster)
        alloc = catalog.offering_alloc().astype(np.int64)
        names: list[str] = []
        rows: list[tuple] = []
        for c in cluster.nodeclaims():
            if c.deleted or not c.launched:
                continue
            off = catalog.find_offering(c.instance_type, c.zone,
                                        c.capacity_type)
            if off is None:
                continue
            resid = alloc[off].copy()
            count = 0
            for p in claim_pods(cluster, c, index=idx):
                resid -= _pod_req_vec(p.spec)
                count += 1
            names.append(c.name)
            rows.append((off, count) + tuple(int(v) for v in resid))
        width = 2 + NUM_RESOURCES
        n_pad = bucket(max(len(rows), 1), NODE_BUCKETS)
        arr = np.zeros((n_pad, width), dtype=np.int32)
        if rows:
            arr[:len(rows)] = np.asarray(rows, dtype=np.int64).clip(
                np.iinfo(np.int32).min, np.iinfo(np.int32).max)
        with self._lock:
            buf = self._occ_buf
            if buf is None:
                buf = self._occ_buf = ResidentBuffer(name="occupancy")
        gen = (catalog.uid, catalog.generation,
               catalog.availability_generation)
        dev, delta = buf.update(arr, self.device, generation=gen,
                                kernel="resident-occupancy")
        return names, dev, delta

    def occupancy_rows(self) -> np.ndarray | None:
        """Host mirror of the occupancy rows, ``[Nn_pad, 6] int32`` (None
        before any :meth:`occupancy_tensors` call); it equals the device
        rows word for word."""
        from karpenter_tpu_torch.apis.pod import NUM_RESOURCES

        with self._lock:
            buf = self._occ_buf
        if buf is None or buf.mirror is None:
            return None
        return buf.mirror.reshape(-1, 2 + NUM_RESOURCES)

    def snapshot_state(self) -> dict | None:
        """The most recent state's key, generation, mirror and device
        words (fetched) — None before any window."""
        with self._lock:
            key = self.last_key
            st = self._states.get(key) if key is not None else None
        if st is None or st.buf.mirror is None or st.buf.dev is None:
            return None
        return {"key": key, "generation": st.buf.generation,
                "mirror": st.buf.mirror,
                "device": st.buf.dev[:-1].cpu().numpy()}

    def stats(self) -> dict:
        with self._lock:
            last = self.last_delta
            return {
                "states": len(self._states),
                "windows": self.windows,
                "rebuilds": self.rebuilds,
                "invalidations": self.invalidations,
                "last_mode": last.mode if last else "",
                "last_delta_words": last.words if last else 0,
                "last_delta_h2d_bytes": last.h2d_bytes if last else 0,
                "last_rebuild_reason": self.last_rebuild_reason,
            }


def resident_store_of(solver):
    """The ResidentStore of a solver, or None."""
    return getattr(solver, "resident", None)


class OccupancySnapshot:
    """One shared occupancy view per disruption tick.

    Reproduces ``DisruptionController._bound_pods`` EXACTLY — pods whose
    ``bound_node`` or ``nominated_node`` equals the queried name, in pod
    collection order — from ONE pass over the pod collection instead of
    one full scan per claim (the O(claims x pods) host rebuild the
    resident store removes from the repack tick).  In-pass mutations
    (consolidation rebinds, evictions) go through :meth:`rebind` /
    :meth:`unbind`, which preserve each pod's original collection order
    so results stay bit-identical to the per-call rescan path (pinned
    by the tests of both packages).
    """

    def __init__(self, cluster):
        from karpenter_tpu_torch.apis.pod import pod_key

        self._order: dict[str, int] = {}
        self._by_name: dict[str, dict[str, None]] = {}
        self._homes: dict[str, tuple[str, ...]] = {}
        for i, p in enumerate(cluster.list("pods")):
            key = pod_key(p.spec)
            self._order[key] = i
            names = []
            if p.bound_node:
                names.append(p.bound_node)
            if p.nominated_node and p.nominated_node != p.bound_node:
                names.append(p.nominated_node)
            for n in names:
                self._by_name.setdefault(n, {})[key] = None
            self._homes[key] = tuple(names)

    def pods_on(self, name: str) -> list[str]:
        if not name:
            return []
        keys = self._by_name.get(name)
        if not keys:
            return []
        return sorted(keys, key=self._order.__getitem__)

    def _drop(self, key: str) -> None:
        for n in self._homes.get(key, ()):
            bucket = self._by_name.get(n)
            if bucket is not None:
                bucket.pop(key, None)
        self._homes[key] = ()

    def rebind(self, key: str, bound_node: str,
               nominated_node: str = "") -> None:
        """A consolidation move changed ``key``'s binding: re-home it
        under its CURRENT (bound, nominated) pair — the same pair the
        per-call rescan would see — at its original collection order."""
        self._drop(key)
        names = []
        if bound_node:
            names.append(bound_node)
        if nominated_node and nominated_node != bound_node:
            names.append(nominated_node)
        for n in names:
            self._by_name.setdefault(n, {})[key] = None
        self._homes[key] = tuple(names)
        self._order.setdefault(key, len(self._order))

    def unbind(self, key: str) -> None:
        """An eviction returned ``key`` to pending (no node)."""
        self._drop(key)


__all__ = ["DELTA_BUCKETS", "OccupancySnapshot", "ResidentBuffer",
           "ResidentStore", "plan_update", "resident_store_of"]
