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
come back in one [C, Lo] copy.  ``solve_encoded_batch`` halves a batch
that runs out of device memory (``DeviceResourceExhausted``) and solves
the halves on the card, as the reference does; any other failure
raises, and nothing is re-run down another route.

Every dispatch runs inside ``faulttol.device_guard`` and a sampled
``obs.prof`` bracket under the reference's kernel name ("scan" for the
FFD route on both devices, "scan-pref", "stochastic", "affinity",
"resident", "scan-batch"), with a ``obs.devtel`` note whose signature is
the reference's tuple.  The single window's fetch stays outside the
guard, as the reference's; the zone-candidate batch fetches inside it
(``guard.fetch``).

The routes the reference's dispatch takes on its own are served too,
each from the same packed buffer plus a small leaf: stochastic windows
(a pool that overcommits) through ``stochastic/kernel.py``, windows
whose encode arms the affinity lane through ``affinity/kernel.py``
(stochastic wins when both are armed), windows with soft preferences
through ``solve_packed_pref_torch`` (the FFD kernel with a rank row per
group), and flat-regime windows (G >= ``flat_min_groups``) through
``solver/flat.py``, routed before the packed buffer is built.  The
opt-in resident store (``resident/``) carries every preference-free
window as a word delta against a device-resident buffer, and the
serving loop (``serving/``, :meth:`TorchSolver.serve_stream`) streams
such deltas through a ring.  The reference's degraded re-runs are
ported: a host-side failure (not a ``DeviceFaultError``) of the
stochastic or affinity program strips that route from the window and its
template (``stochastic/degraded.py``, ``affinity/degraded.py``), and one
of the resident program invalidates the store; each leaves an
``ERRORS{solver, *_fallback}`` sample and re-runs the same base buffer
through the FFD scan route, whose kernel is the hand kernel
``ffd_scan`` on the card.  A ``DeviceFaultError`` is never absorbed
here: it propagates to the caller (under ``make_solver``,
``ResilientSolver``, which degrades it to the host only for a solver on
the CPU).
No plain PyTorch version ever stands in for a failed hand kernel on the
card.  The sharded option is not read here, as the reference's ``JaxSolver``
does not read it: ``core/provisioner.make_solver`` routes a shard count
above 1 to the sharded service (``sharded/``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.affinity.encode import pack_affinity
from karpenter_tpu_torch.affinity.kernel import solve_packed_affinity
from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import (
    DeviceFaultError, DeviceResourceExhausted, device_guard, device_id,
)
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.obs.telemetry_words import decode_and_record
from karpenter_tpu_torch.solver.encode import EncodedProblem
from karpenter_tpu_torch.solver.flat import dispatch_flat, flat_viable
from karpenter_tpu_torch.solver.packed import (
    solve_packed_batch_torch, solve_packed_pref_torch, solve_packed_torch,
)
from karpenter_tpu_torch.solver.result_layout import (
    TELEMETRY_LEN, unpack_reason_words,
)
from karpenter_tpu_torch.solver.types import (
    BATCH_BUCKETS, COO_BUCKETS, GROUP_BUCKETS, LABELROW_BUCKETS,
    NODE_BUCKETS, OFFERING_BUCKETS, Plan, SolveRequest, SolverOptions,
    bucket,
)
from karpenter_tpu_torch.stochastic import z_bp_for
from karpenter_tpu_torch.stochastic.encode import pack_stochastic
from karpenter_tpu_torch.stochastic.kernel import (
    build_fit_grids, solve_packed_stochastic,
)
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("solver.torch")

TELEMETRY_LEN_BYTES = TELEMETRY_LEN * 4

# the reference's kernel name of each route (devtel, guard, profiler)
ROUTE_KERNEL = {"ffd": "scan", "pref": "scan-pref",
                "stochastic": "stochastic", "affinity": "affinity",
                "resident": "resident"}


def _phase(name: str, t0: float, t1: float, parent=None, **attrs) -> None:
    """One measurement feeds both observability layers, as the
    reference's ``_phase``: a retroactive span ``solve.<name>`` in the
    flight recorder and the solve_phase histogram, with the span's
    trace id as its exemplar."""
    sp = obs.record("solve." + name, t0, t1, parent=parent, **attrs)
    metrics.SOLVE_PHASE.labels(name).observe(
        t1 - t0, exemplar={"trace_id": str(sp.trace_id)})


def note_fetched(path: str, out_np: np.ndarray, windows: int,
                 G: int) -> None:
    """The fetched result's accounting, where the reference writes it:
    the path counter, the D2H bytes, and the explain and telemetry
    shares of them (``windows`` rows of G reason words and one
    telemetry block each)."""
    nbytes = int(out_np.nbytes)
    metrics.SOLVE_PATH.labels(path).inc()
    metrics.SOLVE_D2H_BYTES.labels("torch").observe(nbytes)
    tel = get_devtel()
    tel.note_d2h(nbytes)
    tel.note_explain_d2h(windows * G * 4)
    tel.note_telemetry_d2h(windows * TELEMETRY_LEN_BYTES)


# ---------------------------------------------------------------------------
# Packed wire helpers (host side)
# ---------------------------------------------------------------------------

# padded bucket ladder of the preference rows (``jax_backend.py:1710``)
PREF_BUCKETS = (4, 16, 64, 256)


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


def pad_preferences(pref_rows: np.ndarray, pref_idx: np.ndarray, G_pad: int,
                    O_pad: int) -> tuple[np.ndarray, np.ndarray]:
    """The preference leaf of a window: rows float32 [P_pad, O_pad] (P
    padded to ``PREF_BUCKETS``) and pref_idx int32 [G_pad], -1 = none."""
    P_pad = bucket(pref_rows.shape[0], PREF_BUCKETS)
    rows = _pad2(pref_rows.astype(np.float32), P_pad, O_pad)
    idx = np.full(G_pad, -1, np.int32)
    idx[:pref_idx.shape[0]] = pref_idx
    return rows, idx


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

class _Prepared:
    """Shapes + the packed problem buffer for one solve.  ``N`` escalates
    on node overflow and ``K0`` grows on COO overflow; each dispatch
    re-clamps (K, dense16, coo16) to the shapes it ran with.  Instances
    built by ``_prepare`` are cached per problem as templates; every
    dispatch works on a :meth:`clone`, and growth writes back to the
    template so later windows start grown.  ``sto`` / ``z_bp`` (the
    stochastic leaf and z(eps) in basis points), ``aff`` (the affinity
    leaf, when the encode armed the device lane), ``pref_rows`` /
    ``pref_idx`` (the preference leaf) and ``resident`` (the dispatching
    solver keeps a resident store; set on every clone, never on the
    template a problem shares between solvers) pick the route
    (:attr:`route`); ``sto_grid`` keeps the stochastic fit grids of a
    device.  ``right_size`` / ``pref_lambda`` override the solver's
    options for this window (the sidecar's wire flags; None = the
    options')."""

    __slots__ = ("catalog", "G_pad", "O_pad", "U_pad", "N", "N_cap", "K0",
                 "K_cap", "K", "dense16_ok", "dense16", "coo16", "packed",
                 "sto", "z_bp", "sto_grid", "aff", "pref_rows", "pref_idx",
                 "resident", "tmpl", "right_size", "pref_lambda")

    def __init__(self, *, catalog, G_pad, O_pad, U_pad, N, N_cap, K0,
                 K_cap, packed, dense16_ok, sto=None, z_bp=0, aff=None,
                 pref_rows=None, pref_idx=None, right_size=None,
                 pref_lambda=None):
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
        self.sto = sto
        self.z_bp = z_bp
        self.sto_grid = None
        self.aff = aff
        self.pref_rows = pref_rows
        self.pref_idx = pref_idx
        self.resident = False
        self.tmpl = None
        self.right_size = right_size
        self.pref_lambda = pref_lambda

    @property
    def route(self) -> str:
        """The route a dispatch takes, in the reference's order
        (``jax_backend.py:1776-1882``): stochastic, then affinity, then
        the resident store (preference-free windows only), then soft
        preferences, then the FFD kernel."""
        if self.sto is not None:
            return "stochastic"
        if self.aff is not None:
            return "affinity"
        if self.pref_rows is not None:
            return "pref"
        return "resident" if self.resident else "ffd"

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
    the CPU, with ``"-batch"`` appended for a batch of windows, and
    ``"flat-"``, ``"stochastic-"``, ``"affinity-"``, ``"pref-"``,
    ``"resident-"`` or ``"serving-"`` followed by the device type
    ("cuda" or "cpu") on the other routes.  ``resident`` is the
    :class:`~karpenter_tpu_torch.resident.store.ResidentStore` when the
    resident option is on, ``serving`` the
    :class:`~karpenter_tpu_torch.serving.service.ServingLoop` when the
    serving option is on (None otherwise)."""

    MAX_DEVICE_CATALOGS = 16

    def __init__(self, options: SolverOptions | None = None,
                 device="cuda"):
        self.options = options or SolverOptions()
        self.device = resolve_device(device)
        self.device_ids = [device_id(self.device)]
        self.path = "ffd-cuda" if self.device.type == "cuda" \
            else "ffd-reference"
        opts = self.options
        self._device_catalog: dict[tuple, tuple] = {}
        self._coo_floor: dict[int, int] = {}
        self.last_stats: dict[str, object] = {}
        from karpenter_tpu_torch.resident import resident_enabled
        from karpenter_tpu_torch.serving import serving_enabled

        self.resident = None
        if resident_enabled(opts):
            from karpenter_tpu_torch.resident.store import ResidentStore

            self.resident = ResidentStore(self.device)
        self.serving = None
        if serving_enabled(opts):
            from karpenter_tpu_torch.serving.service import ServingLoop

            self.serving = ServingLoop(self)

    # -- public ------------------------------------------------------------

    def solve(self, request: SolveRequest) -> Plan:
        from karpenter_tpu_torch.solver.zonesplit import (
            solve_with_zone_candidates,
        )

        t0 = time.perf_counter()
        with obs.span("solve", backend="torch",
                      pods=len(request.pods)) as sp:
            # handles the zone_candidates gate internally (a single solve
            # when off or with no affinity groups)
            plan = solve_with_zone_candidates(self, request)
            sp.set("nodes", len(plan.nodes))
            sp.set("path", self.last_stats.get("path", ""))
        plan.solve_seconds = time.perf_counter() - t0
        metrics.SOLVE_DURATION.labels("torch").observe(plan.solve_seconds)
        metrics.SOLVE_PODS.labels("torch").observe(len(request.pods))
        metrics.SOLVE_COST.labels("torch").set(plan.total_cost_per_hour)
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
        if problem.group_var is None and flat_viable(problem, self.options):
            attempt = dispatch_flat(self, problem)
            if attempt is not None:
                return PendingSolve(self, problem, flat=attempt)
        par = obs.current_span()
        t_enc = obs.now()
        prep = self._prepare(problem)
        t0 = obs.now()
        _phase("encode", t_enc, t0, parent=par)
        host, event = self._dispatch(prep)
        t_iss = obs.now()
        _phase("h2d", t0, t_iss, parent=par, path=ROUTE_KERNEL[prep.route])
        return PendingSolve(self, problem, prep=prep, host=host, event=event,
                            t_disp=t0, t_issued=t_iss, prepare_s=t0 - t_enc,
                            span=par)

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
                         and not flat_viable(p, self.options))
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

    def serve_stream(self, problems, depth: int = 2):
        """Solve an iterable of EncodedProblems through the serving loop
        (``serving/``): eligible windows upload their word deltas and run
        one fused kick each, and each fetch overlaps a later window's
        kick.  Without the serving option this is
        :meth:`solve_stream`.  Yields Plans in order."""
        if self.serving is None:
            yield from self.solve_stream(problems, depth=depth)
            return
        yield from self.serving.serve(problems, depth=depth)

    def solve_encoded_batch(self, problems: list[EncodedProblem]
                            ) -> list[Plan]:
        """Solve C problems sharing one catalog in ONE dispatch and ONE
        fetch (the zone-candidate rounds: each problem is the base with
        one compat row re-pinned).  As in the reference, problems that
        cannot share one batch (another catalog, a route other than the
        default, another group bucket) are solved one by one, and a
        batch that runs out of device memory (``DeviceResourceExhausted``)
        is halved and each half solved the same way, on the card, down to
        one problem, which raises (``jax_backend.py:1551-1561``)."""
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
        try:
            return BatchPendingSolve(self, list(zip(problems, preps)),
                                     fetch_in_guard=True).results()
        except DeviceResourceExhausted:
            C = len(problems)
            if C <= 1:
                raise
            log.warning("scan-batch out of device memory; halving",
                        batch=C)
            mid = (C + 1) // 2
            return (self.solve_encoded_batch(problems[:mid])
                    + self.solve_encoded_batch(problems[mid:]))

    def prepare_arrays(self, catalog, group_req, group_count, group_cap,
                       compat, num_nodes: int, n_cap: int,
                       right_size=None, pref_rows=None, pref_idx=None,
                       pref_lambda=None) -> _Prepared:
        """A ``_Prepared`` from already-padded arrays (the sidecar's wire
        format) against any catalog-like object with ``uid`` /
        ``generation`` / ``availability_generation`` / ``num_offerings``
        / ``offering_alloc()`` / ``off_price`` / ``offering_rank_price()``.
        The raw compat is factored into deduped label rows here (the
        device recomputes fit on top, idempotently: ``dedup_rows``)."""
        G_pad, O_pad = compat.shape
        total_pods = int(group_count.sum())
        label_idx, rows = dedup_rows(compat)
        U_pad = bucket(max(rows.shape[0], 1), LABELROW_BUCKETS)
        packed = pack_input(group_req, group_count, group_cap, label_idx,
                            _pad2(rows, U_pad, O_pad))
        max_slots = int(catalog.offering_alloc()[:, 3].max()) \
            if catalog.num_offerings else 1
        K0, K_cap = self._compact_k(total_pods, G_pad)
        if pref_rows is not None:
            idx = np.full(G_pad, -1, np.int32)   # padding groups: no pref
            if pref_idx is not None:
                src = np.asarray(pref_idx, np.int32)
                idx[:src.shape[0]] = src
            pref_rows, pref_idx = pad_preferences(
                np.asarray(pref_rows, np.float32), idx, G_pad, O_pad)
        return _Prepared(catalog=catalog, G_pad=G_pad, O_pad=O_pad,
                         U_pad=U_pad, N=num_nodes, N_cap=n_cap, K0=K0,
                         K_cap=K_cap, packed=packed,
                         dense16_ok=max_slots < (1 << 15),
                         right_size=right_size, pref_rows=pref_rows,
                         pref_idx=pref_idx, pref_lambda=pref_lambda)

    def _solve_prepared(self, prep: _Prepared):
        """Dispatch a prepared window and run the shared fetch, COO growth
        and node escalation loop (:meth:`_fetch_prepared`) on it:
        (node_off [N], assign [G, N], unplaced [G], cost).  The sidecar's
        entry: it receives padded arrays and has no problem to decode
        against."""
        par = obs.current_span()
        t0 = obs.now()
        prep.resident = self.resident is not None
        host, event = self._dispatch(prep)
        t_iss = obs.now()
        _phase("h2d", t0, t_iss, parent=par, path=ROUTE_KERNEL[prep.route])
        out_np, t_dec = self._fetch_prepared(prep, host, event, t_disp=t0,
                                             t_issued=t_iss, span=par)
        res = unpack_result(out_np, prep.G_pad, prep.N, prep.K, prep.dense16,
                            prep.coo16)
        _phase("d2h", t_dec, obs.now(), parent=par, bytes=int(out_np.nbytes))
        return res

    def _fetch_prepared(self, prep: _Prepared, host, event, *,
                        t_disp: float, t_issued: float, span=None,
                        path: str | None = None, prepare_s: float = 0.0):
        """The one fetch loop of a single window: wait for the result
        copy, re-dispatch on COO overflow or node escalation (both rare),
        account the fetch, record the telemetry block and set
        ``last_stats``.  Returns (the packed result, the time its decode
        may start).  ``path`` names a window that did not come from a
        dispatch (a serving kick).  Nothing falls back: a program that
        fails raises."""
        kernel = "serving" if path else ROUTE_KERNEL[prep.route]
        # the telemetry plane is the path of the dispatch that gave the
        # result, as the reference's: a serving kick until a re-dispatch
        plane = kernel
        escalations = coo_growths = 0
        while True:
            # the fetch stays outside the guard, as the reference's
            # np.asarray fetch (jax_backend.py:1396-1402)
            if event is not None:
                event.synchronize()
            out_np = host.numpy()
            t_fetch = obs.now()
            _phase("compute", t_issued, t_fetch, parent=span, path=kernel)
            G, N, K = prep.G_pad, prep.N, prep.K
            if coo_buffer_full(out_np, G, N, K, prep.coo16) \
                    and prep.K0 < prep.K_cap:
                prep.grow_K0(grow_coo(prep.K0, prep.K_cap))
                self._note_coo_growth(G, prep.K0)
                coo_growths += 1
                t_disp = obs.now()
                host, event = self._dispatch(prep)
                plane = ROUTE_KERNEL[prep.route]
                t_issued = obs.now()
                _phase("h2d", t_disp, t_issued, parent=span, path=kernel,
                       retry="coo_growth")
                continue
            node_off = out_np[:N]
            unplaced = out_np[N:N + G]
            note_fetched(kernel, out_np, 1, G)
            if needs_node_escalation(node_off, unplaced, N, prep.N_cap):
                prep.escalate_N(bucket(prep.N * 4, NODE_BUCKETS))
                escalations += 1
                t_disp = obs.now()
                host, event = self._dispatch(prep)
                plane = ROUTE_KERNEL[prep.route]
                t_issued = obs.now()
                _phase("h2d", t_disp, t_issued, parent=span, path=kernel,
                       retry="node_escalation")
                continue
            t_dec = obs.now()
            telemetry = decode_and_record(
                out_np, G, N, K, dense16=prep.dense16, coo16=prep.coo16,
                plane=plane, escalations=escalations,
                coo_growths=coo_growths)
            self.last_stats = {
                "path": path or self.route_path(prep.route),
                "device": str(self.device),
                "prepare_s": prepare_s, "wall_s": t_fetch - t_disp,
                "dispatch_s": t_issued - t_disp,
                "exec_fetch_s": t_fetch - t_issued,
                "d2h_bytes": int(out_np.nbytes),
                "h2d_bytes": int(prep.packed.nbytes),
                "compact": bool(K), "G": G, "O": prep.O_pad, "N": N, "K": K,
                "escalations": escalations, "coo_growths": coo_growths,
                "telemetry": telemetry}
            if prep.route == "resident":
                delta = self.resident.last_delta
                self.last_stats.update(h2d_bytes=delta.h2d_bytes,
                                       resident_mode=delta.mode,
                                       delta_words=delta.words)
            return out_np, t_dec

    def compute_handle(self, problem: EncodedProblem):
        """A device-only probe of one window: returns a callable ``run(k=1)``
        that re-runs the window's device program ``k`` times back to back
        and returns once the last result is ready
        (``torch.cuda.synchronize`` on the card).  The FFD route runs on
        the packed buffer already on the device (no upload, no result
        copy); another route keeps its routed dispatch, as the reference
        keeps it for preference windows.  The resident route is bypassed.
        The callable is run once before it is returned."""
        prep = self._prepare(problem)
        prep.resident = False
        prep.K, prep.dense16, prep.coo16 = clamp_output_opts(
            prep.K0, prep.dense16_ok, prep.G_pad, prep.N)
        catalog_t = self.device_offerings(prep.catalog, prep.O_pad)
        route = prep.route
        if route == "ffd":
            packed = upload(prep.packed, self.device)
            kw = dict(G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
                      right_size=self._right_size(prep), compact=prep.K,
                      dense16=prep.dense16, coo16=prep.coo16)

            def fn():
                return solve_packed_torch(packed, *catalog_t, **kw)
        else:
            def fn():
                return self._dispatch_route(prep, route, catalog_t)

        def run(k: int = 1):
            outs = [fn() for _ in range(k)]
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return outs[-1]

        run()
        return run

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
        if tmpl is None:
            tmpl = cache[key] = self._prepare_impl(problem, u_pad)
        c = tmpl.clone()
        floor = self._coo_floor.get(c.G_pad, 0)
        if floor > c.K0:
            c.K0 = min(floor, c.K_cap)
        c.resident = self.resident is not None
        return c

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
        # the route's leaf rides beside the unchanged packed buffer: the
        # stochastic mean/var rows, or the affinity class words when the
        # encode armed the device lane (a window over the class budget
        # takes the FFD route; the decode choke still applies every edge)
        sto, z_bp, aff = None, 0, None
        if problem.group_var is not None:
            sto = pack_stochastic(problem.group_mean, problem.group_var,
                                  G_pad)
            z_bp = z_bp_for(problem.overcommit_eps)
        if problem.aff is not None and problem.aff.device_armed:
            aff = pack_affinity(problem.aff, G_pad)
        pref_rows = pref_idx = None
        if problem.pref_rows is not None and problem.pref_idx is not None:
            pref_rows, pref_idx = pad_preferences(
                problem.pref_rows, problem.pref_idx, G_pad, O_pad)
        return _Prepared(catalog=catalog, G_pad=G_pad, O_pad=O_pad,
                         U_pad=U_pad, N=N, N_cap=N_cap, K0=K0, K_cap=K_cap,
                         packed=packed, dense16_ok=max_slots < (1 << 15),
                         sto=sto, z_bp=z_bp, aff=aff, pref_rows=pref_rows,
                         pref_idx=pref_idx)

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
            get_devtel().note_catalog_upload(
                int(off_alloc.nbytes + off_price.nbytes + off_rank.nbytes))
        return cached

    def _note_dispatch(self, kernel: str, prep: _Prepared,
                       extra: tuple = ()) -> None:
        """Device telemetry of one dispatch (``jax_backend.py:1747``): the
        reference's signature tuple, and the packed host buffer as an H2D
        upload that no donated device buffer replaced."""
        get_devtel().note_dispatch(
            kernel, (prep.G_pad, prep.O_pad, prep.U_pad, prep.N, prep.K,
                     prep.dense16, prep.coo16) + tuple(extra),
            h2d_bytes=int(prep.packed.nbytes), donated=False)

    def dispatch_packed(self, prep: _Prepared) -> torch.Tensor:
        """Issue one window on the device; returns the device result.
        The route follows the prepared leaves (:attr:`_Prepared.route`),
        each inside ``device_guard`` and a sampled profiler bracket under
        the route's kernel name (:data:`ROUTE_KERNEL`).  The reference's
        degraded re-runs (``jax_backend.py:1776-1999``): a host-side
        failure of the stochastic or affinity program strips the route
        from the window and its template, one of the resident program
        invalidates the store, and the same base buffer re-runs down the
        next route; a ``DeviceFaultError`` propagates."""
        prep.K, prep.dense16, prep.coo16 = clamp_output_opts(
            prep.K0, prep.dense16_ok, prep.G_pad, prep.N)
        catalog_t = self.device_offerings(prep.catalog, prep.O_pad)
        while True:
            route = prep.route
            if route == "resident":
                out = self._dispatch_resident(prep, catalog_t)
                if out is not None:
                    return out
                continue
            try:
                return self._dispatch_route(prep, route, catalog_t)
            except DeviceFaultError:
                # a faulted device or a failed hand kernel, not a defect
                # of the route's program: never strip the route for it
                raise
            except Exception as e:  # noqa: BLE001 — degrade, never fail
                if route == "stochastic":
                    from karpenter_tpu_torch.stochastic.degraded import (
                        note_degraded,
                    )
                elif route == "affinity":
                    from karpenter_tpu_torch.affinity.degraded import (
                        note_degraded,
                    )
                else:
                    raise
                note_degraded(prep, e)

    def _dispatch_resident(self, prep: _Prepared, catalog_t):
        """One window through the resident store, or None after a
        host-side failure of its program: the store is invalidated, the
        window leaves an ``ERRORS{solver, resident_fallback}`` sample and
        takes the classic route (``jax_backend.py:1977-1999``).  A
        ``DeviceFaultError`` invalidates the store too, and propagates."""
        try:
            return self.resident.dispatch_solve(
                prep, prep.packed, catalog_t, self._right_size(prep))
        except DeviceFaultError:
            self.resident.invalidate("dispatch_error")
            raise
        except Exception as e:  # noqa: BLE001 — degrade to the classic route
            log.warning("resident dispatch failed; host path fallback",
                        error=str(e)[:300], G=prep.G_pad, O=prep.O_pad,
                        N=prep.N)
            metrics.ERRORS.labels("solver", "resident_fallback").inc()
            self.resident.invalidate("dispatch_error")
            prep.resident = False
            return None

    def _dispatch_route(self, prep: _Prepared, route: str, catalog_t):
        """One guarded dispatch of ``route``'s device program."""
        off_alloc, off_price, off_rank = catalog_t
        rs = self._right_size(prep)
        kw = dict(G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
                  right_size=rs, compact=prep.K, dense16=prep.dense16,
                  coo16=prep.coo16)
        kernel = ROUTE_KERNEL[route]
        if route == "pref":
            self._note_dispatch(kernel, prep, (prep.pref_rows.shape[0], rs))
        elif route == "stochastic":
            sto = upload(prep.sto, self.device)
            kd, kc = self._fit_grids(prep, sto, off_alloc)
            self._note_dispatch(kernel, prep, (prep.z_bp, rs))
        else:
            self._note_dispatch(kernel, prep, (rs,))
        with device_guard(kernel, devices=self.device_ids):
            with get_profiler().sampled(kernel) as probe:
                packed = upload(prep.packed, self.device)
                if route == "pref":
                    out = solve_packed_pref_torch(
                        packed, upload(prep.pref_rows, self.device),
                        upload(prep.pref_idx, self.device), off_alloc,
                        off_price, off_rank, P=prep.pref_rows.shape[0],
                        lam_bp=self._lam_bp(prep), **kw)
                elif route == "stochastic":
                    out = solve_packed_stochastic(
                        packed, sto, kd, kc, off_alloc, off_price, off_rank,
                        z_bp=prep.z_bp, **kw)
                elif route == "affinity":
                    out = solve_packed_affinity(
                        packed, upload(prep.aff, self.device), off_alloc,
                        off_price, off_rank, **kw)
                else:
                    out = solve_packed_torch(packed, off_alloc, off_price,
                                             off_rank, **kw)
                probe.dispatched(out)
        if route == "stochastic":
            metrics.OVERCOMMIT_SOLVES.labels("stochastic").inc()
            metrics.OVERCOMMIT_Z.set(prep.z_bp / 10000.0)
        return out

    def _right_size(self, prep: _Prepared) -> bool:
        return self.options.right_size if prep.right_size is None \
            else prep.right_size

    def _lam_bp(self, prep: _Prepared) -> int:
        lam = self.options.preference_lambda if prep.pref_lambda is None \
            else prep.pref_lambda
        return int(lam * 10000)

    def _fit_grids(self, prep: _Prepared, sto: torch.Tensor, off_alloc):
        """The stochastic fit grids (kd, kc) of the window on this
        solver's device and catalog: built at the first dispatch and
        kept on the problem's template for every later one."""
        cat = prep.catalog
        key = (str(self.device), cat.uid, cat.generation,
               cat.availability_generation, prep.O_pad, prep.z_bp)
        cached = prep.sto_grid
        if cached is None or cached[0] != key:
            cached = (key, build_fit_grids(sto, off_alloc, G=prep.G_pad,
                                           z_bp=prep.z_bp))
            prep.sto_grid = cached
            if prep.tmpl is not None:
                prep.tmpl.sto_grid = cached
        return cached[1]

    def route_path(self, route: str) -> str:
        """``last_stats["path"]`` of a single window on ``route``."""
        return self.path if route == "ffd" \
            else f"{route}-{self.device.type}"

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
    """One in-flight window.  ``result()`` runs the solver's one fetch
    loop (:meth:`TorchSolver._fetch_prepared`: the wait for the result
    copy, the re-dispatch on COO overflow or node escalation, both rare)
    and decodes; a flat window (``flat``) finishes through
    ``solver/flat.finalize_flat``.  The fetch falls back nowhere (the
    route strips sit at the dispatch, :meth:`TorchSolver.dispatch_packed`):
    a program that fails here raises."""

    __slots__ = ("_solver", "_problem", "_prep", "_flat", "_host", "_event",
                 "_t_disp", "_t_issued", "_prepare_s", "_done", "_path",
                 "_span")

    def __init__(self, solver, problem, prep=None, host=None, event=None,
                 t_disp=0.0, t_issued=0.0, prepare_s=0.0, done=None,
                 flat=None, path=None, span=None):
        self._solver = solver
        self._span = span
        self._problem = problem
        self._prep = prep
        self._flat = flat
        # the path a window reports when it did not come from dispatch
        # (a serving kick); None = the prepared route's
        self._path = path
        self._host = host
        self._event = event
        self._t_disp = t_disp
        self._t_issued = t_issued
        self._prepare_s = prepare_s
        self._done = done

    def result(self) -> Plan:
        if self._done is not None:
            return self._done
        if self._flat is not None:
            from karpenter_tpu_torch.solver.flat import finalize_flat

            self._done = finalize_flat(self._solver, self._problem,
                                       self._flat)
            return self._done
        solver, prep = self._solver, self._prep
        out_np, t_dec = solver._fetch_prepared(
            prep, self._host, self._event, t_disp=self._t_disp,
            t_issued=self._t_issued, span=self._span, path=self._path,
            prepare_s=self._prepare_s)
        self._done = solver._decode(self._problem, out_np, prep.G_pad,
                                    prep.N, prep.K, prep.dense16, prep.coo16)
        t_end = obs.now()
        _phase("d2h", t_dec, t_end, parent=self._span,
               bytes=int(out_np.nbytes))
        solver.last_stats["decode_s"] = t_end - t_dec
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
                 "_t_issued", "_done", "_in_guard", "_out_np", "_span")

    def __init__(self, solver: TorchSolver, items,
                 fetch_in_guard: bool = False):
        self._solver = solver
        self._in_guard = fetch_in_guard
        self._out_np = None
        self._span = obs.current_span()
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

    def _signature(self) -> tuple:
        p0 = self._preps[0]
        return (p0.G_pad, p0.O_pad, p0.U_pad, self._N, self._C_pad, self._K,
                self._dense16, self._coo16,
                self._solver.options.right_size)

    def _dispatch(self) -> None:
        """One guarded launch of the batch.  With ``fetch_in_guard`` (the
        zone-candidate batch, ``jax_backend.py:1525-1532``) the result is
        fetched inside the guard (``guard.fetch``); otherwise (the
        stream, ``:2317-2330``) its copy starts behind the launch and
        ``results()`` waits for it outside the guard."""
        solver, p0 = self._solver, self._preps[0]
        self._t_disp = obs.now()
        self._K, self._dense16, self._coo16 = clamp_output_opts(
            self._K0, self._dense16_ok, p0.G_pad, self._N)
        off_alloc, off_price, off_rank = solver.device_offerings(
            p0.catalog, p0.O_pad)
        with device_guard("scan-batch", devices=solver.device_ids) as guard:
            with get_profiler().sampled("scan-batch") as probe:
                out = solve_packed_batch_torch(
                    upload(self._rows, solver.device), off_alloc, off_price,
                    off_rank, C=self._C_pad, G=p0.G_pad, O=p0.O_pad,
                    U=p0.U_pad, N=self._N,
                    right_size=solver.options.right_size, compact=self._K,
                    dense16=self._dense16, coo16=self._coo16)
                probe.dispatched(out)
            self._t_issued = obs.now()
            if self._in_guard:
                self._out_np = guard.fetch(out)
            else:
                self._host, self._event = start_fetch(out)
        if not self._in_guard:
            # the zone-candidate batch notes its final shapes once, after
            # its loop, as the reference does
            get_devtel().note_dispatch(
                "scan-batch", self._signature(),
                h2d_bytes=int(self._rows.nbytes), donated=False)
            _phase("h2d", self._t_disp, self._t_issued, parent=self._span,
                   path="scan-batch", batch=self._C)

    def results(self) -> list[Plan]:
        if self._done is not None:
            return self._done
        solver, p0 = self._solver, self._preps[0]
        G = p0.G_pad
        escalations = coo_growths = 0
        while True:
            if self._in_guard:
                out_np = self._out_np
            else:
                if self._event is not None:
                    self._event.synchronize()
                out_np = self._host.numpy()
            t_fetch = obs.now()
            _phase("compute", self._t_issued, t_fetch, parent=self._span,
                   path="scan-batch", batch=self._C)
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
            note_fetched("scan-batch", out_np, self._C, G)
            for c in range(self._C):
                decode_and_record(
                    out_np[c], G, N, K, dense16=self._dense16,
                    coo16=self._coo16, plane="scan-batch",
                    escalations=escalations, coo_growths=coo_growths)
            if self._in_guard:
                get_devtel().note_dispatch(
                    "scan-batch", self._signature(),
                    h2d_bytes=int(self._rows.nbytes), donated=False)
            t_dec = obs.now()
            self._done = [
                solver._decode(p, out_np[c], G, N, K, self._dense16,
                               self._coo16)
                for c, p in enumerate(self._problems)]
            _phase("d2h", t_dec, obs.now(), parent=self._span,
                   bytes=int(out_np.nbytes), batch=self._C)
            solver.last_stats = {
                "path": solver.path + "-batch", "device": str(solver.device),
                "batch": self._C, "batch_pad": self._C_pad,
                "wall_s": t_fetch - self._t_disp,
                "dispatch_s": self._t_issued - self._t_disp,
                "exec_fetch_s": t_fetch - self._t_issued,
                "decode_s": obs.now() - t_dec,
                "d2h_bytes": int(out_np.nbytes),
                "h2d_bytes": int(self._rows.nbytes),
                "compact": bool(K), "G": G, "O": p0.O_pad, "N": N, "K": K,
                "escalations": escalations, "coo_growths": coo_growths}
            return self._done
