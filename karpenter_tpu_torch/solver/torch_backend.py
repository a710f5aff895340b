"""The host half of the solve: pad, pack, dispatch, fetch, escalate, decode.

Port of the host wrapper of ``karpenter_tpu/solver/jax_backend.py``
(``JaxSolver`` / ``PendingSolve`` / ``BatchPendingSolve``) for the
deterministic default route: one packed int32 problem buffer goes to the
device, ``solve_packed_torch`` runs the window there (the CUDA FFD
kernel on the card), one packed result buffer comes back through pinned
memory, and the plan decodes from it.  The catalog tensors stay
device-resident between solves, keyed by catalog generation.

Batches of same-catalog, same-shape windows — ``solve_encoded_batch``
(the zone-candidate rounds) and the window-batching arm of
``solve_stream`` — stack their buffers into one [C, Li] upload, run
``solve_packed_batch_torch`` (one launch of the fleet FFD kernel) and
come back in one [C, Lo] copy.  A failed launch or an out-of-memory
error raises; no batch is halved or re-run down another route.

Windows that take another route in the reference — flat (G >=
``flat_min_groups``), stochastic, affinity, soft preferences — and the
resident, serving and sharded options are not served yet: the solver
raises ``NotImplementedError`` naming the ROADMAP item instead of
running such a window down another route.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.obs.telemetry_words import decode_window
from karpenter_tpu_torch.solver.encode import BIG_CAP, EncodedProblem
from karpenter_tpu_torch.solver.packed import (
    solve_packed_batch_torch, solve_packed_torch,
)
from karpenter_tpu_torch.solver.result_layout import unpack_reason_words
from karpenter_tpu_torch.solver.types import (
    BATCH_BUCKETS, COO_BUCKETS, GROUP_BUCKETS, LABELROW_BUCKETS,
    NODE_BUCKETS, OFFERING_BUCKETS, Plan, SolveRequest, SolverOptions,
    bucket,
)

# the reference's flat-regime gate constants (solver/flat.py)
_FLAT_MAX_CLASSES = 128
_FLAT_MAX_ITEMS = 32768


# ---------------------------------------------------------------------------
# Packed wire helpers (host side)
# ---------------------------------------------------------------------------

def dedup_rows(compat) -> tuple[np.ndarray, np.ndarray]:
    """Factor a raw [G, O] mask into (label_idx [G] int32, rows [U, O]
    bool) with U distinct rows — the fallback when the encoder's own
    factoring is unavailable.  Rows here still contain per-group fit;
    the device ANDs its recomputed fit on top, which is idempotent."""
    G = compat.shape[0]
    compat = np.ascontiguousarray(compat, dtype=bool)
    if G == 0 or compat.shape[1] == 0:
        return (np.zeros(G, dtype=np.int32),
                np.zeros((min(G, 1), compat.shape[1]), dtype=bool))
    blobs = compat.view(np.dtype((np.void, compat.shape[1]))).reshape(G)
    _, first, inverse = np.unique(blobs, return_index=True,
                                  return_inverse=True)
    return inverse.astype(np.int32), compat[first]


def pack_input(group_req, group_count, group_cap, label_idx,
               label_rows, group_prio=None) -> np.ndarray:
    """The single problem buffer (layout v2): meta rows [G, 8] (req x4,
    count, cap, label row, priority), then the label-row bits [U, O/32]
    little-endian.  O must be a multiple of 32."""
    G = group_req.shape[0]
    U, O = label_rows.shape
    buf = np.empty(G * 8 + U * (O // 32), dtype=np.int32)
    meta = buf[:G * 8].reshape(G, 8)
    meta[:] = 0
    meta[:, :4] = group_req
    meta[:, 4] = group_count
    meta[:, 5] = np.minimum(group_cap, np.iinfo(np.int32).max)
    meta[:, 6] = label_idx
    if group_prio is not None:
        meta[:, 7] = group_prio
    bits = np.packbits(np.ascontiguousarray(label_rows, dtype=np.uint8)
                       .reshape(U, O // 32, 32),
                       axis=-1, bitorder="little")
    buf[G * 8:] = bits.reshape(-1).view(np.int32)
    return buf


def clamp_output_opts(K0: int, dense16_ok: bool, G: int, N: int):
    """The (K, dense16, coo16) triple valid at node axis ``N``: K never
    exceeds G*N, int16 pair-packing needs an even G*N, COO word packing
    needs every flat index below 2^15."""
    K = min(K0, G * N)
    return (K, (dense16_ok and K == 0 and (G * N) % 2 == 0),
            (dense16_ok and K > 0 and G * N <= (1 << 15)))


def coo_buffer_full(out_np: np.ndarray, G: int, N: int, K: int,
                    coo16: bool = False) -> bool:
    """Sound overflow detector for the compacted assign: a dropped entry
    implies every one of the K slots is occupied."""
    if K <= 0:
        return False
    if coo16:
        cnt = out_np[N + G + 1:N + G + 1 + K] & 0xFFFF
    else:
        cnt = out_np[N + G + 1 + K:N + G + 1 + 2 * K]
    return bool((cnt > 0).all())


def grow_coo(K0: int, K_cap: int) -> int:
    return min(bucket(K0 * 4, COO_BUCKETS), K_cap)


def needs_node_escalation(node_off, unplaced, N: int, N_cap: int) -> bool:
    """Escalate only when the node budget itself was binding: every slot
    open AND pods left over."""
    return (N < N_cap and int(unplaced.sum()) > 0
            and int((node_off >= 0).sum()) >= N)


def unpack_coo_tail(out: np.ndarray, G: int, N: int, K: int,
                    coo16: bool = False):
    rest = out[N + G + 1:]
    if coo16:
        word = rest[:K]
        return word >> 16, word & 0xFFFF
    return rest[:K], rest[K:2 * K]


def expand_coo_assign(idx: np.ndarray, cnt: np.ndarray,
                      G: int, N: int) -> np.ndarray:
    assign = np.zeros((G, N), dtype=np.int32)
    live = cnt > 0
    flat = idx[live]
    assign[flat % G, flat // G] = cnt[live]
    return assign


def unpack_result(out: np.ndarray, G: int, N: int, K: int,
                  dense16: bool = False, coo16: bool = False):
    """Host inverse of ``pack_result`` -> (node_off [N], assign [G,N]
    int32, unplaced [G], cost float)."""
    node_off = out[:N]
    unplaced = out[N:N + G]
    cost = float(out[N + G:N + G + 1].view(np.float32)[0])
    rest = out[N + G + 1:]
    if K > 0:
        idx, cnt = unpack_coo_tail(out, G, N, K, coo16)
        assign = expand_coo_assign(idx, cnt, G, N)
    elif dense16:
        half = rest[:(G * N) // 2]
        assign = np.empty(G * N, dtype=np.int32)
        assign[0::2] = half & 0xFFFF
        assign[1::2] = (half >> 16) & 0xFFFF
        assign = assign.reshape(G, N)
    else:
        assign = rest[:G * N].reshape(G, N)
    return node_off, assign, unplaced, cost


def _pad1(a: np.ndarray, n: int) -> np.ndarray:
    if a.shape[0] == n:
        return a
    out = np.zeros((n,) + a.shape[1:], dtype=a.dtype)
    out[:a.shape[0]] = a
    return out


def _pad2(a: np.ndarray, n0: int, n1: int | None = None) -> np.ndarray:
    n1 = a.shape[1] if n1 is None else n1
    if a.shape == (n0, n1):
        return a
    out = np.zeros((n0, n1), dtype=a.dtype)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host buffer on ``device``: through pinned memory, without a
    wait, on the card; the array itself on the CPU."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def start_fetch(out: torch.Tensor):
    """Start the device->host copy of a result: (host tensor, CUDA event
    or None).  On the card the copy lands in pinned memory and the event
    marks its end; a CPU result is already on the host."""
    if out.device.type != "cuda":
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def _env_on(name: str) -> bool:
    import os

    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


def _flat_viable(problem: EncodedProblem, options) -> bool:
    """The reference's flat-regime gate (``solver/flat.flat_viable``):
    True for the windows ``JaxSolver`` routes to the flat solver."""
    mode = options.flat_solver
    if mode == "off" or problem.aff is not None or not options.right_size:
        return False
    if mode != "on" and problem.num_groups < options.flat_min_groups:
        return False
    if problem.label_rows is None or problem.label_idx is None \
            or not (1 <= problem.label_rows.shape[0] <= _FLAT_MAX_CLASSES):
        return False
    if problem.pref_rows is not None:
        if problem.pref_idx is None:
            return False
        pairs = (problem.label_idx.astype(np.int64) << 32) \
            | (problem.pref_idx.astype(np.int64) & 0xFFFFFFFF)
        if np.unique(pairs).size > _FLAT_MAX_CLASSES:
            return False
    if not (problem.group_cap >= np.minimum(
            problem.group_count, BIG_CAP)).all():
        return False
    total = int(problem.group_count.sum())
    if total == 0 or total > _FLAT_MAX_ITEMS:
        return False
    tot = (problem.group_req.astype(np.int64)
           * problem.group_count[:, None]).sum(axis=0)
    return not (tot >= (1 << 31) - 1).any()


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

class _Prepared:
    """Shapes + the packed problem buffer for one solve.  ``N`` escalates
    on node overflow and ``K0`` grows on COO overflow; each dispatch
    re-clamps (K, dense16, coo16) to the shapes it ran with.  Instances
    built by ``_prepare`` are cached per problem as templates; every
    dispatch works on a :meth:`clone`, and growth writes back to the
    template so later windows start grown."""

    __slots__ = ("catalog", "G_pad", "O_pad", "U_pad", "N", "N_cap", "K0",
                 "K_cap", "K", "dense16_ok", "dense16", "coo16", "packed",
                 "tmpl")

    def __init__(self, *, catalog, G_pad, O_pad, U_pad, N, N_cap, K0,
                 K_cap, packed, dense16_ok):
        self.catalog = catalog
        self.G_pad = G_pad
        self.O_pad = O_pad
        self.U_pad = U_pad
        self.N = N
        self.N_cap = N_cap
        self.K0 = K0
        self.K_cap = K_cap
        self.dense16_ok = dense16_ok
        self.K, self.dense16, self.coo16 = clamp_output_opts(
            K0, dense16_ok, G_pad, N)
        self.packed = packed
        self.tmpl = None

    def clone(self) -> "_Prepared":
        c = _Prepared.__new__(_Prepared)
        for s in _Prepared.__slots__:
            setattr(c, s, getattr(self, s))
        c.tmpl = self if self.tmpl is None else self.tmpl
        return c

    def grow_K0(self, k_new: int) -> None:
        self.K0 = min(k_new, self.K_cap)
        if self.tmpl is not None:
            self.tmpl.K0 = max(self.tmpl.K0, self.K0)

    def escalate_N(self, n_new: int) -> None:
        self.N = min(n_new, self.N_cap)
        if self.tmpl is not None:
            self.tmpl.N = max(self.tmpl.N, self.N)


class TorchSolver:
    """Pads, uploads, solves, decodes — on ``device`` ("cuda" by default;
    raises when no CUDA device exists; "cpu" runs the plain PyTorch
    path).  ``last_stats`` holds the route, shapes and phase times of
    the last window or batch; ``last_stats["path"]`` is ``"ffd-cuda"``
    when the FFD scan ran as the CUDA kernel and ``"ffd-reference"`` on
    the CPU, with ``"-batch"`` appended for a batch of windows."""

    MAX_DEVICE_CATALOGS = 16

    def __init__(self, options: SolverOptions | None = None,
                 device="cuda"):
        self.options = options or SolverOptions()
        self.device = resolve_device(device)
        self.path = "ffd-cuda" if self.device.type == "cuda" \
            else "ffd-reference"
        opts = self.options
        if opts.resident == "on" or (opts.resident == "auto"
                                     and _env_on("KARPENTER_ENABLE_RESIDENT")):
            raise NotImplementedError(
                "resident solves are not ported yet (ROADMAP queue 1 item 8)")
        if opts.serving == "on" or (opts.serving == "auto"
                                    and _env_on("KARPENTER_ENABLE_SERVING")):
            raise NotImplementedError(
                "the serving loop is not ported yet (ROADMAP queue 1 item 8)")
        if opts.sharded or _env_on("KARPENTER_ENABLE_SHARDED"):
            raise NotImplementedError(
                "sharded solves are not ported yet (ROADMAP queue 1 item 10)")
        self._device_catalog: dict[tuple, tuple] = {}
        self._coo_floor: dict[int, int] = {}
        self.last_stats: dict[str, object] = {}

    # -- public ------------------------------------------------------------

    def solve(self, request: SolveRequest) -> Plan:
        from karpenter_tpu_torch.solver.zonesplit import (
            solve_with_zone_candidates,
        )

        t0 = time.perf_counter()
        plan = solve_with_zone_candidates(self, request)
        plan.solve_seconds = time.perf_counter() - t0
        return plan

    def solve_encoded(self, problem: EncodedProblem) -> Plan:
        return self.solve_encoded_async(problem).result()

    def solve_encoded_async(self, problem: EncodedProblem) -> "PendingSolve":
        """Dispatch the window and start the result copy into pinned host
        memory; ``PendingSolve.result()`` waits for it and decodes."""
        if problem.num_groups == 0:
            done = Plan(nodes=[], unplaced_pods=list(problem.rejected),
                        backend="torch")
            if done.unplaced_pods:
                from karpenter_tpu_torch.explain.decode import attach

                attach(problem, done)
            return PendingSolve(self, problem, done=done)
        self.check_route(problem)
        t_enc = time.perf_counter()
        prep = self._prepare(problem)
        t0 = time.perf_counter()
        host, event = self._dispatch(prep)
        return PendingSolve(self, problem, prep=prep, host=host, event=event,
                            t_disp=t0, t_issued=time.perf_counter(),
                            prepare_s=t0 - t_enc)

    def check_route(self, problem: EncodedProblem) -> None:
        """Raise NotImplementedError for a window that takes a route in
        the reference which this package does not serve yet."""
        if problem.group_var is not None:
            raise NotImplementedError(
                "stochastic (overcommit) windows are not ported yet "
                "(ROADMAP queue 1 item 6)")
        if problem.aff is not None:
            raise NotImplementedError(
                "affinity windows are not ported yet (ROADMAP queue 1 "
                "item 7)")
        if _flat_viable(problem, self.options):
            raise NotImplementedError(
                "flat-regime windows (G >= flat_min_groups) are not ported "
                "yet (ROADMAP queue 1 item 5)")
        if problem.pref_rows is not None:
            raise NotImplementedError(
                "soft-preference windows are not ported yet (ROADMAP "
                "queue 1, unserved routes of the first slice)")

    def solve_stream(self, problems, depth: int = 2, batch: object = "auto"):
        """Solve an iterable of EncodedProblems through a depth-``depth``
        dispatch/fetch pipeline; yields Plans in order.

        With ``batch`` > 1 (``"auto"``: 16 on the card, 1 on the CPU),
        consecutive same-catalog windows that share padded shapes also
        ride ONE device program (:class:`BatchPendingSolve`), dividing
        the per-window launch cost by the batch width; other windows
        break the batch and go through the single-window path unchanged.
        The batch is capped at ``depth // 2``: accumulating a batch
        delays the first yield by its width, and a batch wider than the
        remaining depth would be awaited with nothing else in flight.  At
        the default depth=2 this disables batching."""
        from collections import deque

        if batch == "auto":
            batch = 16 if self.device.type == "cuda" else 1
        batch = min(batch if isinstance(batch, int) else 1,
                    max(1, depth // 2))
        q: deque = deque()      # (unit, n_windows)
        inflight = 0

        def drain_to(limit):
            nonlocal inflight
            while q and inflight > limit:
                unit, n = q.popleft()
                inflight -= n
                if n == 1:
                    yield unit.result()
                else:
                    yield from unit.results()

        buf: list = []          # [(problem, prep)] awaiting one batch

        def flush():
            nonlocal inflight
            if not buf:
                return
            if len(buf) == 1:
                unit, n = self.solve_encoded_async(buf[0][0]), 1
            else:
                unit, n = BatchPendingSolve(self, list(buf)), len(buf)
            buf.clear()
            q.append((unit, n))
            inflight += n

        for p in problems:
            batchable = (p.num_groups > 0 and p.pref_rows is None
                         and p.group_var is None and p.aff is None
                         and not _flat_viable(p, self.options))
            if not batchable:
                flush()
                q.append((self.solve_encoded_async(p), 1))
                inflight += 1
            else:
                prep = self._prepare(p)
                if buf and (buf[0][0].catalog is not p.catalog
                            or (buf[0][1].G_pad, buf[0][1].O_pad,
                                buf[0][1].U_pad)
                            != (prep.G_pad, prep.O_pad, prep.U_pad)):
                    flush()
                buf.append((p, prep))
                if len(buf) >= batch:
                    flush()
            yield from drain_to(depth)
        flush()
        yield from drain_to(0)

    def solve_encoded_batch(self, problems: list[EncodedProblem]
                            ) -> list[Plan]:
        """Solve C problems sharing one catalog in ONE dispatch and ONE
        fetch (the zone-candidate rounds: each problem is the base with
        one compat row re-pinned).  As in the reference, problems that
        cannot share one batch (another catalog, a route other than the
        default, another group bucket) are solved one by one."""
        if not problems:
            return []
        catalog = problems[0].catalog
        if any(p.catalog is not catalog for p in problems[1:]) \
                or any(p.pref_rows is not None or p.group_var is not None
                       or p.aff is not None for p in problems):
            return [self.solve_encoded(p) for p in problems]
        # one common label-row bucket across candidates (their U differs
        # by at most one appended row) so the stacked buffers share length
        u_max = max((p.label_rows.shape[0] if p.label_rows is not None
                     else p.num_groups) or 1 for p in problems)
        U_pad = bucket(u_max, LABELROW_BUCKETS)
        preps = [self._prepare(p, u_pad=U_pad) for p in problems]
        if any(pr.G_pad != preps[0].G_pad for pr in preps):
            return [self.solve_encoded(p) for p in problems]
        return BatchPendingSolve(self, list(zip(problems, preps))).results()

    # -- internals ---------------------------------------------------------

    def _prepare(self, problem: EncodedProblem,
                 u_pad: int | None = None) -> _Prepared:
        """A clone of the problem's cached template (an unchanged window
        never re-packs).  ``u_pad`` overrides the label-row bucket (a
        batch needs one common U across problems whose row counts
        differ)."""
        opts = self.options
        key = (u_pad, opts.bucket_groups, opts.max_nodes,
               opts.adaptive_nodes, opts.compact_assign)
        cache = problem._prep_cache
        if cache is None:
            cache = problem._prep_cache = {}
        tmpl = cache.get(key)
        if tmpl is not None:
            c = tmpl.clone()
            floor = self._coo_floor.get(c.G_pad, 0)
            if floor > c.K0:
                c.K0 = min(floor, c.K_cap)
            return c
        tmpl = self._prepare_impl(problem, u_pad)
        cache[key] = tmpl
        return tmpl.clone()

    @staticmethod
    def _estimate_nodes(problem: EncodedProblem, n_cap: int) -> int:
        from karpenter_tpu_torch.solver.encode import estimate_nodes

        return estimate_nodes(problem, n_cap, NODE_BUCKETS)

    def _prepare_impl(self, problem: EncodedProblem,
                      u_pad: int | None = None) -> _Prepared:
        catalog = problem.catalog
        G = problem.num_groups
        O = catalog.num_offerings
        total_pods = int(problem.group_count.sum())
        G_pad = bucket(G, GROUP_BUCKETS) if self.options.bucket_groups else G
        O_pad = bucket(O, OFFERING_BUCKETS) if self.options.bucket_groups \
            else -32 * (-O // 32)   # packed compat needs a 32-multiple O
        N_cap = min(self.options.max_nodes,
                    bucket(max(total_pods, 1), NODE_BUCKETS))
        N = self._estimate_nodes(problem, N_cap) \
            if self.options.adaptive_nodes else N_cap
        if problem.label_rows is not None and problem.label_idx is not None:
            rows, label_idx = problem.label_rows, problem.label_idx
        else:
            label_idx, rows = dedup_rows(problem.compat)
        U_pad = u_pad or bucket(max(rows.shape[0], 1), LABELROW_BUCKETS)
        packed = pack_input(_pad2(problem.group_req, G_pad),
                            _pad1(problem.group_count, G_pad),
                            _pad1(problem.group_cap, G_pad),
                            _pad1(label_idx, G_pad),
                            _pad2(rows, U_pad, O_pad),
                            group_prio=_pad1(problem.group_prio, G_pad))
        K0, K_cap = self._compact_k(total_pods, G_pad)
        max_slots = int(catalog.offering_alloc()[:, 3].max()) if O else 1
        return _Prepared(catalog=catalog, G_pad=G_pad, O_pad=O_pad,
                         U_pad=U_pad, N=N, N_cap=N_cap, K0=K0, K_cap=K_cap,
                         packed=packed, dense16_ok=max_slots < (1 << 15))

    def _compact_k(self, total_pods: int, G_pad: int) -> tuple[int, int]:
        """(initial, cap) COO capacity of the compacted assign; (0, 0) =
        dense.  "auto" is dense on cpu and cuda, as in the reference."""
        mode = self.options.compact_assign
        if mode != "on":
            return 0, 0
        cap = bucket(total_pods + G_pad, COO_BUCKETS)
        first = max(bucket(max(total_pods // 8, 256) + G_pad, COO_BUCKETS),
                    self._coo_floor.get(G_pad, 0))
        return min(first, cap), cap

    def _note_coo_growth(self, G_pad: int, K0: int) -> None:
        self._coo_floor[G_pad] = max(self._coo_floor.get(G_pad, 0), K0)

    def device_offerings(self, catalog, O_pad: int):
        """(off_alloc int32 [O,4], off_price f32 [O], off_rank f32 [O]) on
        the solver's device, cached by catalog generation; stale
        generations of a catalog are dropped, total residency bounded."""
        key = (catalog.uid, catalog.generation,
               catalog.availability_generation, O_pad,
               getattr(catalog, "risk_generation", 0))
        cached = self._device_catalog.get(key)
        if cached is None:
            self._device_catalog = {
                k: v for k, v in self._device_catalog.items()
                if k[0] != key[0] or k[1:3] == key[1:3]}
            while len(self._device_catalog) >= self.MAX_DEVICE_CATALOGS:
                self._device_catalog.pop(next(iter(self._device_catalog)))
            off_alloc = _pad2(catalog.offering_alloc().astype(np.int32), O_pad)
            off_price = _pad1(catalog.off_price.astype(np.float32), O_pad)
            off_rank = _pad1(catalog.offering_rank_price(), O_pad)
            cached = tuple(torch.from_numpy(np.ascontiguousarray(a))
                           .to(self.device)
                           for a in (off_alloc, off_price, off_rank))
            self._device_catalog[key] = cached
        return cached

    def dispatch_packed(self, prep: _Prepared) -> torch.Tensor:
        """Issue one window on the device; returns the device result."""
        prep.K, prep.dense16, prep.coo16 = clamp_output_opts(
            prep.K0, prep.dense16_ok, prep.G_pad, prep.N)
        off_alloc, off_price, off_rank = self.device_offerings(
            prep.catalog, prep.O_pad)
        return solve_packed_torch(
            upload(prep.packed, self.device), off_alloc, off_price, off_rank,
            G=prep.G_pad,
            O=prep.O_pad, U=prep.U_pad, N=prep.N,
            right_size=self.options.right_size, compact=prep.K,
            dense16=prep.dense16, coo16=prep.coo16)

    def _dispatch(self, prep: _Prepared):
        """Dispatch and start the device->host copy: (host tensor, CUDA
        event or None)."""
        return start_fetch(self.dispatch_packed(prep))

    @staticmethod
    def _decode(problem, out_np, G: int, N: int, K: int, dense16: bool,
                coo16: bool) -> Plan:
        """One window's plan from its packed result row."""
        from karpenter_tpu_torch.solver.encode import (
            decode_plan, decode_plan_entries,
        )

        words = unpack_reason_words(out_np, G, N, K, dense16, coo16)
        node_off = out_np[:N]
        unplaced = out_np[N:N + G]
        cost = float(out_np[N + G:N + G + 1].view(np.float32)[0])
        if K > 0:
            idx, cnt = unpack_coo_tail(out_np, G, N, K, coo16)
            live = cnt > 0
            flat_idx = idx[live]
            return decode_plan_entries(
                problem, node_off, flat_idx % G, flat_idx // G, cnt[live],
                unplaced, cost, "torch", reason_words=words)
        _, assign, _, _ = unpack_result(out_np, G, N, K, dense16, coo16)
        return decode_plan(problem, node_off, assign.astype(np.int32),
                           unplaced, cost, "torch", reason_words=words)


class PendingSolve:
    """One in-flight window.  ``result()`` waits for the result copy,
    re-dispatches on COO overflow or node escalation (both rare), and
    decodes.  Nothing here falls back to another route: a kernel that
    fails raises."""

    __slots__ = ("_solver", "_problem", "_prep", "_host", "_event",
                 "_t_disp", "_t_issued", "_prepare_s", "_done")

    def __init__(self, solver, problem, prep=None, host=None, event=None,
                 t_disp=0.0, t_issued=0.0, prepare_s=0.0, done=None):
        self._solver = solver
        self._problem = problem
        self._prep = prep
        self._host = host
        self._event = event
        self._t_disp = t_disp
        self._t_issued = t_issued
        self._prepare_s = prepare_s
        self._done = done

    def result(self) -> Plan:
        if self._done is not None:
            return self._done
        solver, prep = self._solver, self._prep
        host, event = self._host, self._event
        t_disp, t_issued = self._t_disp, self._t_issued
        escalations = coo_growths = 0
        while True:
            if event is not None:
                event.synchronize()
            out_np = host.numpy()
            t_fetch = time.perf_counter()
            G, N, K = prep.G_pad, prep.N, prep.K
            if coo_buffer_full(out_np, G, N, K, prep.coo16) \
                    and prep.K0 < prep.K_cap:
                prep.grow_K0(grow_coo(prep.K0, prep.K_cap))
                solver._note_coo_growth(G, prep.K0)
                coo_growths += 1
                t_disp = time.perf_counter()
                host, event = solver._dispatch(prep)
                t_issued = time.perf_counter()
                continue
            node_off = out_np[:N]
            unplaced = out_np[N:N + G]
            if needs_node_escalation(node_off, unplaced, N, prep.N_cap):
                prep.escalate_N(bucket(prep.N * 4, NODE_BUCKETS))
                escalations += 1
                t_disp = time.perf_counter()
                host, event = solver._dispatch(prep)
                t_issued = time.perf_counter()
                continue
            t_dec = time.perf_counter()
            self._done = solver._decode(self._problem, out_np, G, N, K,
                                        prep.dense16, prep.coo16)
            t_end = time.perf_counter()
            solver.last_stats = {
                "path": solver.path, "device": str(solver.device),
                "prepare_s": self._prepare_s, "wall_s": t_fetch - t_disp,
                "dispatch_s": t_issued - t_disp,
                "exec_fetch_s": t_fetch - t_issued,
                "decode_s": t_end - t_dec,
                "d2h_bytes": int(out_np.nbytes),
                "h2d_bytes": int(prep.packed.nbytes),
                "compact": bool(K), "G": G, "O": prep.O_pad, "N": N, "K": K,
                "escalations": escalations, "coo_growths": coo_growths,
                "telemetry": decode_window(
                    out_np, G, N, K, dense16=prep.dense16, coo16=prep.coo16,
                    escalations=escalations, coo_growths=coo_growths)}
            return self._done


class BatchPendingSolve:
    """C in-flight same-catalog, same-shape windows in one device program
    (the window-batching arm of ``solve_stream``, and
    ``solve_encoded_batch``).  The rows are stacked into one [C_pad, Li]
    upload (rows past C repeat row 0, so a handful of batch widths
    recur); ``solve_packed_batch_torch`` runs them with one launch of the
    fleet kernel and one [C_pad, Lo] copy comes back through pinned
    memory.  ``results()`` waits for it, handles COO growth and node
    escalation with a whole-batch re-dispatch (both rare, shared-shape by
    construction) and decodes each row.  Nothing falls back: a kernel
    that fails raises."""

    __slots__ = ("_solver", "_problems", "_preps", "_C", "_C_pad", "_rows",
                 "_N", "_N_cap", "_K0", "_K_cap", "_dense16_ok", "_K",
                 "_dense16", "_coo16", "_host", "_event", "_t_disp",
                 "_t_issued", "_done")

    def __init__(self, solver: TorchSolver, items):
        self._solver = solver
        self._problems = [p for p, _ in items]
        self._preps = [pr for _, pr in items]
        p0 = self._preps[0]
        self._C = len(items)
        self._C_pad = bucket(self._C, BATCH_BUCKETS)
        self._rows = np.stack([pr.packed for pr in self._preps]
                              + [p0.packed] * (self._C_pad - self._C))
        self._N = max(pr.N for pr in self._preps)
        self._N_cap = max(pr.N_cap for pr in self._preps)
        self._K0 = max(pr.K0 for pr in self._preps)
        self._K_cap = max(pr.K_cap for pr in self._preps)
        self._dense16_ok = all(pr.dense16_ok for pr in self._preps)
        self._done = None
        self._dispatch()

    def _dispatch(self) -> None:
        solver, p0 = self._solver, self._preps[0]
        self._t_disp = time.perf_counter()
        self._K, self._dense16, self._coo16 = clamp_output_opts(
            self._K0, self._dense16_ok, p0.G_pad, self._N)
        off_alloc, off_price, off_rank = solver.device_offerings(
            p0.catalog, p0.O_pad)
        out = solve_packed_batch_torch(
            upload(self._rows, solver.device), off_alloc, off_price,
            off_rank, C=self._C_pad, G=p0.G_pad, O=p0.O_pad, U=p0.U_pad,
            N=self._N, right_size=solver.options.right_size,
            compact=self._K, dense16=self._dense16, coo16=self._coo16)
        self._host, self._event = start_fetch(out)
        self._t_issued = time.perf_counter()

    def results(self) -> list[Plan]:
        if self._done is not None:
            return self._done
        solver, p0 = self._solver, self._preps[0]
        G = p0.G_pad
        escalations = coo_growths = 0
        while True:
            if self._event is not None:
                self._event.synchronize()
            out_np = self._host.numpy()
            t_fetch = time.perf_counter()
            N, K = self._N, self._K
            if self._K0 < self._K_cap and any(
                    coo_buffer_full(out_np[c], G, N, K, self._coo16)
                    for c in range(self._C)):
                self._K0 = grow_coo(self._K0, self._K_cap)
                for pr in self._preps:
                    pr.grow_K0(self._K0)
                solver._note_coo_growth(G, self._K0)
                coo_growths += 1
                self._dispatch()
                continue
            if any(needs_node_escalation(out_np[c, :N], out_np[c, N:N + G],
                                         N, self._N_cap)
                   for c in range(self._C)):
                self._N = min(self._N_cap, bucket(N * 4, NODE_BUCKETS))
                for pr in self._preps:
                    pr.escalate_N(self._N)
                escalations += 1
                self._dispatch()
                continue
            t_dec = time.perf_counter()
            self._done = [
                solver._decode(p, out_np[c], G, N, K, self._dense16,
                               self._coo16)
                for c, p in enumerate(self._problems)]
            solver.last_stats = {
                "path": solver.path + "-batch", "device": str(solver.device),
                "batch": self._C, "batch_pad": self._C_pad,
                "wall_s": t_fetch - self._t_disp,
                "dispatch_s": self._t_issued - self._t_disp,
                "exec_fetch_s": t_fetch - self._t_issued,
                "decode_s": time.perf_counter() - t_dec,
                "d2h_bytes": int(out_np.nbytes),
                "h2d_bytes": int(self._rows.nbytes),
                "compact": bool(K), "G": G, "O": p0.O_pad, "N": N, "K": K,
                "escalations": escalations, "coo_growths": coo_growths}
            return self._done
