"""The sharded continuous-solve service (port of
``karpenter_tpu/sharded/service.py``), on one device.

The admission front-end (:class:`ShardRouter`) hashes pods to shards;
each shard's packed window stays resident on the device between windows
as one stacked ``[S, L + 1]`` state fed by the resident delta path
(``resident/store.plan_update`` over the flattened buffer: only the
changed int32 words move, padded to one shared ``DELTA_BUCKETS`` rung);
every window is one stacked solve (``sharded/kernels.solve_shards``: one
``ffd_scan_fleet`` launch over the S shards and one ``cost_sum``
launch); the periodic rebalance is a device reduction
(``rebalance_shards``) whose decision the host applies as
signature-group ownership migrations.

Parity: shard s's result words are those of ``solve_packed_torch`` on
shard s's buffer, so the union of the per-shard plans equals solving
each shard's partition alone, window after window.

A window is a kick (:meth:`ShardedSolveService._kick_window`: route,
encode, delta, solve, start the copy to pinned host memory with an
event) and a fetch (:meth:`ShardedSolveService._fetch_window`: wait on
the event, check and decode); :meth:`solve_window` does both, the
sharded serving loop (``serving/service.py``) defers the fetch.  All of
a kick runs on the device's current stream, so a later kick's scatter
into the state is ordered after every earlier solve that reads it.

Windows with soft preferences, a stochastic pool or affinity carry
semantics the stacked scan does not implement: they take the host route
(:meth:`ShardedSolveService.solve_window_host`, each shard solved by the
greedy oracle, counted as ``SHARDED_SOLVES{host}``, backend
``sharded-host``), as in the reference; the kick returns their finished
plan.  The same host route is the degraded contract of
``sharded/degraded.py::ResilientShardedService`` for a service on the
CPU.

On one card the shard mesh is one device wide (``mesh_devices`` 1); the
health-board failover onto fewer devices is not ported (ROADMAP queue 1
item 10).  The kick, the fetch and the rebalance run inside
``device_guard`` ("sharded-solve", "sharded-fetch", "rebalance"), the
kick and the rebalance in a sampled profiler bracket, each noted in
``obs.devtel`` as the reference notes it.  A failed kick or fetch
invalidates the resident state and raises; for a service on the CPU
the caller (``ResilientShardedService`` or the sharded serving loop)
re-solves the window on the host route, and on the card the fault
reaches the caller's caller.
"""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.obs.telemetry_words import note_rebalance_skew
from karpenter_tpu_torch.resident.delta import (
    DELTA_BUCKETS, WindowDelta, pad_delta,
)
from karpenter_tpu_torch.resident.kernels import new_state
from karpenter_tpu_torch.resident.store import plan_update
from karpenter_tpu_torch.sharded.encode import ShardedWindow, encode_shards
from karpenter_tpu_torch.sharded.kernels import (
    PRESSURE_COLUMNS, rebalance_shards, solve_shards,
)
from karpenter_tpu_torch.sharded.router import ShardRouter, signature_key
from karpenter_tpu_torch.sharded.types import RebalanceDecision, ShardedPlan
from karpenter_tpu_torch.solver.torch_backend import (
    _pad1, _pad2, start_fetch, unpack_result, upload,
)
from karpenter_tpu_torch.solver.types import bucket
from karpenter_tpu_torch.utils import metrics


class CorruptShardResult(RuntimeError):
    """A fetched shard result failed the decode checks (a non-finite
    cost, an offering index out of range or a negative unplaced count):
    it must never decode into bindings."""


class ShardKick:
    """One kicked window whose result is not fetched yet: what the fetch
    phase needs, and what a host re-solve of the window needs
    (``catalog``, ``nodepool``).  ``host`` / ``event`` are the pinned
    copy of the device result and the event that marks its end (None on
    the CPU)."""

    __slots__ = ("window", "delta", "host", "event", "t0", "catalog",
                 "nodepool")

    def __init__(self, window, delta, host, event, t0, catalog=None,
                 nodepool=None):
        self.window = window
        self.delta = delta
        self.host = host
        self.event = event
        self.t0 = t0
        self.catalog = catalog
        self.nodepool = nodepool


class ShardedSolveService:
    """Stacked resident state + per-shard solves, on ``device`` (the card
    unless the CPU is asked for)."""

    MAX_DEVICE_CATALOGS = 4

    def __init__(self, num_shards: int, *, right_size: bool = True,
                 device="cuda"):
        self.router = ShardRouter(num_shards)
        self.num_shards = num_shards
        self.right_size = right_size
        self.device = resolve_device(device)
        self.device_ids = [device_id(self.device)]
        self._lock = threading.Lock()
        # stacked resident state: host mirror [S, L] + device state
        # [S, L + 1], generation-tracked like resident/store
        self._mirror: np.ndarray | None = None
        self._dev: torch.Tensor | None = None
        self._generation: tuple | None = None
        self._shapes: tuple | None = None       # (G_pad, O_pad, U_pad, N)
        self._pending_reason = ""
        # admission backlog (keyed, deduped) + the last window's
        # per-shard accounting the rebalance pressure reads
        self._backlog: dict[str, object] = {}
        self._last_window: ShardedWindow | None = None
        self._last_unplaced: list[int] = [0] * num_shards
        self._device_catalog: dict[tuple, tuple] = {}
        self.windows = 0
        self.rebuilds = 0
        self.invalidations = 0
        self.rebalances = 0
        self.migrations = 0
        self.last_delta: WindowDelta | None = None
        self.last_decision: RebalanceDecision | None = None

    # -- catalog -----------------------------------------------------------

    def _catalog_tensors(self, catalog, O_pad: int):
        """(off_alloc, off_price, off_rank) on the device, cached by the
        catalog's generations; a bumped generation of a catalog drops its
        older tensors, foreign catalogs are capped by count."""
        key = (catalog.uid, catalog.generation,
               catalog.availability_generation, O_pad,
               getattr(catalog, "risk_generation", 0))
        cached = self._device_catalog.get(key)
        if cached is None:
            for k in [k for k in self._device_catalog
                      if k[0] == catalog.uid and k != key]:
                self._device_catalog.pop(k)
            while len(self._device_catalog) >= self.MAX_DEVICE_CATALOGS:
                self._device_catalog.pop(next(iter(self._device_catalog)))
            arrays = (_pad2(catalog.offering_alloc().astype(np.int32),
                            O_pad),
                      _pad1(catalog.off_price.astype(np.float32), O_pad),
                      _pad1(catalog.offering_rank_price(), O_pad))
            cached = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .to(self.device) for a in arrays)
            self._device_catalog[key] = cached
            get_devtel().note_catalog_upload(
                int(sum(a.nbytes for a in arrays)))
        return cached

    # -- admission front-end -----------------------------------------------

    def admit(self, pods) -> list[int]:
        """Enqueue pods into the backlog (deduped by pod key); returns the
        per-shard admitted counts of this call."""
        counts = [0] * self.num_shards
        with self._lock:
            for p in pods:
                key = pod_key(p)
                if key in self._backlog:
                    continue
                self._backlog[key] = p
                counts[self.router.shard_of(p)] += 1
        return counts

    def withdraw(self, pod_keys) -> int:
        """Drop resolved pods from the backlog (bound / deleted)."""
        n = 0
        with self._lock:
            for key in pod_keys:
                if self._backlog.pop(key, None) is not None:
                    n += 1
        return n

    def backlog_pods(self) -> list:
        with self._lock:
            return list(self._backlog.values())

    def backlog_keys(self) -> list[str]:
        with self._lock:
            return list(self._backlog)

    def sync_backlog(self, live_keys) -> int:
        """Withdraw every backlog entry not in ``live_keys`` (the
        caller's still-pending set)."""
        live = set(live_keys)
        return self.withdraw([k for k in self.backlog_keys()
                              if k not in live])

    # -- resident-state bookkeeping ----------------------------------------

    def invalidate(self, reason: str = "invalidated") -> None:
        with self._lock:
            self._mirror = None
            self._dev = None
            self._generation = None
            self._pending_reason = reason
            self.invalidations += 1

    def _plan_update(self, stacked: np.ndarray, generation: tuple,
                     shapes: tuple):
        """The resident ladder of ``resident/store.plan_update`` over the
        flat stacked buffer, its changed words split back into
        shard-local rows.  Returns ``(reason, per_shard_idx)``; a
        non-empty reason means rebuild."""
        if self._mirror is not None and self._shapes != shapes:
            # the pads are the shape key: a same-length buffer with other
            # pads must still rebuild
            return "shape", None
        buf = SimpleNamespace(
            mirror=None if self._mirror is None
            else self._mirror.reshape(-1),
            dev=self._dev, generation=self._generation,
            pending_reason=self._pending_reason)
        reason, idx = plan_update(buf, stacked.reshape(-1), generation)
        if reason:
            return reason, None
        L = stacked.shape[1]
        shard = idx // L
        return "", [idx[shard == s] - s * L
                    for s in range(stacked.shape[0])]

    # -- the window solve --------------------------------------------------

    def solve_window(self, catalog, nodepool=None, pods=None) -> ShardedPlan:
        """Route -> encode -> delta-update the stacked state -> one
        stacked solve -> per-shard decode.  ``pods`` defaults to the
        admitted backlog."""
        kick = self._kick_window(catalog, nodepool, pods)
        if isinstance(kick, ShardedPlan):
            return kick          # a host-routed (pref/sto/aff) window
        return self._fetch_window(kick)

    def _kick_window(self, catalog, nodepool=None, pods=None):
        """Phase 1: route, encode, delta-update, solve, and start the
        copy of the result to pinned host memory.  The stacked state
        advances here; the returned :class:`ShardKick` owes its fetch
        and decode.  A host-routed window returns its finished
        :class:`ShardedPlan` instead."""
        t0 = time.perf_counter()
        if pods is None:
            pods = self.backlog_pods()
        self.router.bind_components(pods)
        parts = self.router.partition(pods)
        window = encode_shards(parts, catalog, nodepool)
        if any(p.pref_rows is not None or p.group_var is not None
               or p.aff is not None for p in window.problems):
            # soft preferences, a chance-constrained pool and affinity
            # edges are semantics the stacked scan does not carry:
            # dropping them would void the preference ranking, the
            # overcommit bound or the edges.  The host oracle honours all
            # three.
            return self.solve_window_host(catalog, nodepool, pods,
                                          window=window)
        S = window.num_shards
        L = int(window.stacked.shape[1])
        stacked = window.stacked
        gen = (catalog.uid, catalog.generation,
               catalog.availability_generation)
        shapes = window.shapes
        with self._lock:
            reason, idx = self._plan_update(stacked, gen, shapes)
            if reason:
                self._dev = new_state(stacked, self.device)
                self._mirror = stacked.copy()
                self._generation = gen
                self._shapes = shapes
                self._pending_reason = ""
                self.rebuilds += 1
                didx = np.full((S, DELTA_BUCKETS[0]), L, dtype=np.int32)
                dval = np.zeros((S, DELTA_BUCKETS[0]), dtype=np.int32)
                delta = WindowDelta(mode="rebuild", words=int(stacked.size),
                                    h2d_bytes=int(stacked.nbytes),
                                    reason=reason)
            else:
                d_max = max(max(int(i.size) for i in idx), 1)
                pairs = [pad_delta(i, stacked[s][i], L,
                                   _shared_bucket(d_max))
                         for s, i in enumerate(idx)]
                didx = np.stack([p[0] for p in pairs])
                dval = np.stack([p[1] for p in pairs])
                words = sum(int(i.size) for i in idx)
                for s, i in enumerate(idx):
                    if i.size:
                        self._mirror[s][i] = stacked[s][i]
                delta = WindowDelta(
                    mode="delta" if words else "hit", words=words,
                    h2d_bytes=int(didx.nbytes + dval.nbytes))
            state = self._dev
        off_alloc, off_price, off_rank = self._catalog_tensors(
            catalog, window.O_pad)
        get_devtel().note_dispatch(
            "sharded-solve",
            (S, window.G_pad, window.O_pad, window.U_pad, window.N,
             didx.shape[1], self.right_size),
            h2d_bytes=delta.h2d_bytes, donated=True)
        try:
            with device_guard("sharded-solve", devices=self.device_ids):
                with get_profiler().sampled("sharded-solve") as probe:
                    _, out = solve_shards(
                        state, upload(didx, self.device),
                        upload(dval, self.device), off_alloc, off_price,
                        off_rank, G=window.G_pad, O=window.O_pad,
                        U=window.U_pad, N=window.N,
                        right_size=self.right_size)
                    probe.dispatched(out)
            host, event = start_fetch(out)
        except Exception:
            # the state took the scatter, or may have: it can no longer
            # be trusted; the host mirror can (on the CPU the caller
            # re-solves this window on the host route)
            self.invalidate("dispatch_error")
            raise
        return ShardKick(window=window, delta=delta, host=host, event=event,
                         t0=t0, catalog=catalog, nodepool=nodepool)

    def _fetch_window(self, kick: ShardKick) -> ShardedPlan:
        """Phase 2: wait for the copy, check and decode every shard, and
        account the window.  A failure invalidates and raises."""
        window, delta = kick.window, kick.delta
        try:
            with device_guard("sharded-fetch",
                              devices=self.device_ids) as guard:
                out_np = guard.fetch(kick.host, event=kick.event)
            get_devtel().note_d2h(int(out_np.nbytes))
            plan = self._decode(window, out_np, delta_words=delta.words)
        except Exception:
            self.invalidate("fetch_error")
            raise
        with self._lock:
            self.windows += 1
            self.last_delta = delta
            self._last_window = window
            self._last_unplaced = [len(p.unplaced_pods) for p in plan.plans]
        metrics.SHARDED_SOLVES.labels("device").inc()
        plan.solve_seconds = time.perf_counter() - kick.t0
        metrics.SHARDED_SOLVE_DURATION.labels("device").observe(
            plan.solve_seconds)
        return plan

    def _decode(self, window: ShardedWindow, out_np: np.ndarray,
                delta_words: int = 0) -> ShardedPlan:
        """Per-shard decode through the shared COO decode
        (``decode_plan_entries``), each shard's telemetry recorded and its
        result checked first."""
        from karpenter_tpu_torch.obs.telemetry_words import decode_and_record
        from karpenter_tpu_torch.solver.encode import decode_plan_entries
        from karpenter_tpu_torch.solver.result_layout import (
            TELEMETRY_LEN, unpack_reason_words,
        )

        G, N = window.G_pad, window.N
        get_devtel().note_telemetry_d2h(
            len(window.problems) * TELEMETRY_LEN * 4)
        plans = []
        for s, problem in enumerate(window.problems):
            node_off, assign, unplaced, cost = unpack_result(
                out_np[s], G, N, 0)
            words = unpack_reason_words(out_np[s], G, N, 0)
            decode_and_record(out_np[s], G, N, 0, plane="sharded",
                              delta_words=delta_words)
            if (not np.isfinite(cost)
                    or int(node_off.min(initial=0)) < -1
                    or int(node_off.max(initial=0)) > window.O_pad
                    or int(unplaced.min(initial=0)) < 0):
                raise CorruptShardResult(
                    f"shard {s} device result failed decode validation "
                    f"(cost={cost!r})")
            gis, ns = np.nonzero(assign)
            cnts = assign[gis, ns]
            plans.append(decode_plan_entries(
                problem, node_off, gis.astype(np.int64),
                ns.astype(np.int64), cnts.astype(np.int64), unplaced,
                float(cost), "sharded", reason_words=words))
        return ShardedPlan(plans=plans, shard_pods=list(window.shard_pods))

    # -- the host route (the degraded wrapper routes here too) -------------

    def solve_window_host(self, catalog, nodepool=None, pods=None,
                          window: ShardedWindow | None = None) -> ShardedPlan:
        """The host route: the same routing and encode, each shard solved
        in turn by the greedy oracle.  It serves windows with soft
        preferences, a stochastic pool or affinity, and every window the
        degraded wrapper (``sharded/degraded.py``) re-solves."""
        from karpenter_tpu_torch.solver.greedy import GreedySolver
        from karpenter_tpu_torch.solver.types import SolverOptions

        t0 = time.perf_counter()
        if window is None:
            if pods is None:
                pods = self.backlog_pods()
            self.router.bind_components(pods)
            parts = self.router.partition(pods)
            window = encode_shards(parts, catalog, nodepool)
        solver = GreedySolver(SolverOptions(backend="greedy"))
        plans = [solver.solve_encoded(p) for p in window.problems]
        # the stacked state no longer reflects the last solved window:
        # drop it so the next device window rebuilds
        if self._mirror is not None:
            self.invalidate("host-routed window")
        with self._lock:
            self._last_window = window
            self._last_unplaced = [len(p.unplaced_pods) for p in plans]
            self.windows += 1
        metrics.SHARDED_SOLVES.labels("host").inc()
        plan = ShardedPlan(plans=plans, shard_pods=list(window.shard_pods),
                           backend="sharded-host")
        plan.solve_seconds = time.perf_counter() - t0
        metrics.SHARDED_SOLVE_DURATION.labels("host").observe(
            plan.solve_seconds)
        return plan

    # -- rebalance ---------------------------------------------------------

    def pressure(self, pods=None) -> np.ndarray:
        """int32 [S, 3] pressure matrix: pods owned, groups owned,
        last-window unplaced."""
        if pods is None:
            pods = self.backlog_pods()
        mat = np.zeros((self.num_shards, PRESSURE_COLUMNS), dtype=np.int32)
        groups: list[set] = [set() for _ in range(self.num_shards)]
        for p in pods:
            s = self.router.shard_of(p)
            mat[s, 0] += 1
            groups[s].add(signature_key(p))
        for s, g in enumerate(groups):
            mat[s, 1] = len(g)
        with self._lock:
            for s, u in enumerate(self._last_unplaced[:self.num_shards]):
                mat[s, 2] = u
        return mat

    def rebalance(self, pods=None) -> RebalanceDecision:
        """Compute the decision on the device and apply it as
        group-ownership migrations (largest donor groups first, key
        ascending on ties)."""
        if pods is None:
            pods = self.backlog_pods()
        mat = self.pressure(pods)
        get_devtel().note_dispatch("rebalance", (self.num_shards,
                                                 mat.shape[1]),
                                   h2d_bytes=int(mat.nbytes), donated=False)
        with device_guard("rebalance", devices=self.device_ids) as guard:
            with get_profiler().sampled("rebalance") as probe:
                tile = rebalance_shards(torch.from_numpy(mat).to(self.device))
                probe.dispatched(tile)
            tile_np = guard.fetch(tile)
        get_devtel().note_d2h(int(tile_np.nbytes))
        donor, receiver, amount, skew = (int(tile_np[0, 0]),
                                         int(tile_np[0, 1]),
                                         int(tile_np[0, 2]),
                                         int(tile_np[0, 3]))
        decision = RebalanceDecision(donor=donor, receiver=receiver,
                                     amount=amount, skew=skew,
                                     pressure=mat, tile=tile_np)
        # the host-sourced telemetry slot: windows recorded after this
        # carry the skew in SLOT_REBALANCE_SKEW
        note_rebalance_skew(skew)
        if amount > 0 and donor != receiver:
            decision.moved_keys = self._apply_migration(pods, decision)
        with self._lock:
            self.rebalances += 1
            self.migrations += len(decision.moved_keys)
            self.last_decision = decision
        return decision

    def _apply_migration(self, pods, decision: RebalanceDecision):
        """Move whole signature groups (largest pod count first, key
        ascending on ties) from donor to receiver until the decision's
        amount is covered, never past the point where the next move
        would flip the imbalance."""
        sizes: dict[str, int] = {}
        for p in pods:
            if self.router.shard_of(p) == decision.donor:
                sizes[signature_key(p)] = sizes.get(signature_key(p), 0) + 1
        moved: list[str] = []
        budget = decision.amount
        for key, n in sorted(sizes.items(), key=lambda kv: (-kv[1], kv[0])):
            if budget <= 0:
                break
            if n > budget:
                # an over-budget move only as the first move, and only
                # if it still improves the imbalance (the new skew is
                # |skew - 2n|): n >= skew would move the group straight
                # back next tick
                if moved or n >= decision.skew:
                    continue
            if self.router.migrate(key, decision.receiver):
                moved.append(key)
                budget -= n
        if moved:
            # ownership changed: the per-shard buffers change next window
            # by design; the rebuild is accounted as a migration
            self.invalidate("rebalance")
        return moved

    # -- introspection -----------------------------------------------------

    def snapshot_state(self) -> dict | None:
        """(mirror, fetched device words, generation, shapes, overrides)
        for the state check; None before any window."""
        with self._lock:
            if self._mirror is None or self._dev is None:
                return None
            return {"mirror": self._mirror,
                    "device": self._dev[:, :-1].cpu().numpy(),
                    "generation": self._generation, "shapes": self._shapes,
                    "overrides": self.router.overrides()}

    def stats(self) -> dict:
        with self._lock:
            last = self.last_delta
            return {
                "shards": self.num_shards,
                "mesh_devices": 1,
                "windows": self.windows,
                "rebuilds": self.rebuilds,
                "invalidations": self.invalidations,
                "rebalances": self.rebalances,
                "migrations": self.migrations,
                "backlog": len(self._backlog),
                "router": self.router.stats(),
                "last_mode": last.mode if last else "",
                "last_delta_words": last.words if last else 0,
                "last_skew": self.last_decision.skew
                if self.last_decision else 0,
            }


def _shared_bucket(d_max: int) -> tuple[int]:
    """One delta rung for every shard, so the stacked (didx, dval) pair
    is rectangular; past the ladder's last rung ``bucket`` takes the next
    power of two."""
    return (bucket(max(d_max, 1), DELTA_BUCKETS),)
