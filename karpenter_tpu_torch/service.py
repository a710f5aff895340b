"""Solver gRPC sidecar: host controllers <-> the card's solver over gRPC
(port of ``karpenter_tpu/service.py``).

The controller plane is a host process; the solver runs beside the card
and serves ``Solve`` over gRPC (a localhost sidecar, or across hosts).
The whole solve window crosses the wire as one message, and catalog
tensors are uploaded once per generation and stay on the device between
solves.

No protobuf codegen: messages are numpy ``.npz`` archives over raw-bytes
gRPC methods, so the wire is self-describing and the dependency surface
stays at grpcio + numpy.  The wire is the reference's, array for array:
a reference client talks to this server and this client to a reference
server.

Methods (service ``karpenter.tpu.Solver``):

- ``UploadCatalog``  npz{off_alloc,off_price,off_rank} + id/generation ->
  ``b"ok"``;
- ``Solve``          npz{group_req,group_count,group_cap,compat} +
  catalog key + options -> npz{node_off,assign,unplaced,cost} (or the
  flat route's COO pair);
- ``SolveBatch``     the zone-candidate batch: C compat matrices over one
  set of group arrays -> the stacked results, in one device dispatch.

:class:`SolverHandlers` holds the byte handlers (bytes in, bytes out) and
the solver, with no transport: a caller drives them in process.
:class:`SolverServer` adds the gRPC server.  The solver is a
``TorchSolver`` on ``device`` ("cuda" unless the caller asks for the
CPU; it raises without a card).  A failed upload or solve raises out of
its handler, and gRPC hands the client an error status.  Every reply of
:class:`SolverServer`, an error status included, names the server's
device in its trailing metadata (``solver-device``); a reference client
ignores it, and a reference server sends none.

The client (:class:`RemoteSolver`) has the ``solve_encoded(problem) ->
Plan`` surface of the local backends, so ``make_solver(SolverOptions(
backend="remote", address=...))`` drops it in.  ``RemoteSolver.device``
is the device the server named in its last reply, failed or not (None
until the first reply, behind a reference server, and while the server
cannot be reached): ``ResilientSolver`` degrades a failed remote solve
to the host oracle only when that device is not a CUDA device.
"""

from __future__ import annotations

import io
import threading
import time
from concurrent import futures

import numpy as np
import torch

from karpenter_tpu_torch.solver.encode import EncodedProblem, decode_plan
from karpenter_tpu_torch.solver.types import (
    BATCH_BUCKETS, GROUP_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, Plan,
    SolveRequest, SolverOptions, bucket,
)
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("service")

_SERVICE = "karpenter.tpu.Solver"
# the trailing-metadata key under which the server names its device
DEVICE_METADATA = "solver-device"


def _pack(**arrays) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _unpack(data: bytes) -> dict[str, np.ndarray]:
    return dict(np.load(io.BytesIO(data), allow_pickle=False))


def _identity(b: bytes) -> bytes:
    return b


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class _UploadedCatalog:
    """Catalog-like shim over uploaded tensors: satisfies the solver's
    device-catalog cache (``TorchSolver.device_offerings``), so the
    sidecar's catalogs stay on the device between solves."""

    def __init__(self, cat_id: str, generation: int, off_alloc, off_price,
                 off_rank):
        self.uid = cat_id
        self.generation = generation
        self.availability_generation = 0
        self.num_offerings = off_alloc.shape[0]
        self.off_price = off_price
        self._alloc = off_alloc
        self._rank = off_rank

    def offering_alloc(self):
        return self._alloc

    def offering_rank_price(self):
        return self._rank


class SolverHandlers:
    """The sidecar's byte handlers over one ``TorchSolver`` on
    ``device``: ``_upload``, ``_solve`` and ``_solve_batch`` take the
    request bytes (and a gRPC context, unused) and return the reply
    bytes.  Catalog tensors go to the device at upload and stay there,
    keyed by (catalog id, generation)."""

    def __init__(self, options: SolverOptions | None = None,
                 device="cuda"):
        from karpenter_tpu_torch.solver.torch_backend import TorchSolver

        self.options = options or SolverOptions()
        self.solver = TorchSolver(self.options, device=device)
        self.device = self.solver.device
        self._catalogs: dict[tuple[str, int], _UploadedCatalog] = {}
        self._lock = threading.Lock()
        # the solver's device-catalog dict, COO floors and last_stats are
        # not thread-safe, and the device serializes solves anyway: every
        # use of the solver from the gRPC worker threads takes this lock
        self._solver_lock = threading.Lock()

    # -- handlers ----------------------------------------------------------

    def _upload(self, request: bytes, context=None) -> bytes:
        arrays = _unpack(request)
        key = (str(arrays["catalog_id"]), int(arrays["generation"]))
        cat = _UploadedCatalog(
            key[0], key[1],
            arrays["off_alloc"].astype(np.int32),
            arrays["off_price"].astype(np.float32),
            arrays["off_rank"].astype(np.float32))
        with self._lock:
            # keep only the latest generation per catalog id
            self._catalogs = {k: v for k, v in self._catalogs.items()
                              if k[0] != key[0]}
            self._catalogs[key] = cat
        # the catalog goes to the device now, in the solver's one layout
        with self._solver_lock:
            self.solver.device_offerings(cat, cat.num_offerings)
        return b"ok"

    def _catalog_for(self, arrays):
        key = (str(arrays["catalog_id"]), int(arrays["generation"]))
        with self._lock:
            return self._catalogs.get(key)

    def _solve(self, request: bytes, context=None) -> bytes:
        t0 = time.perf_counter()
        arrays = _unpack(request)
        cat = self._catalog_for(arrays)
        if cat is None:
            return _pack(error=np.array("unknown catalog; re-upload"))
        N = int(arrays["num_nodes"])
        pref_rows = arrays.get("pref_rows")
        pref_idx = arrays.get("pref_idx")
        pref_lambda = (int(arrays["pref_lambda_bp"]) / 10000.0
                       if "pref_lambda_bp" in arrays else None)
        with self._solver_lock:
            out = self._solve_flat_maybe(cat, arrays, pref_rows, pref_idx,
                                         pref_lambda)
            if out is not None:
                metrics.SOLVE_DURATION.labels("sidecar").observe(
                    time.perf_counter() - t0)
                return out
            prep = self.solver.prepare_arrays(
                cat, arrays["group_req"], arrays["group_count"],
                arrays["group_cap"], arrays["compat"],
                num_nodes=N, n_cap=int(arrays.get("n_cap", N)),
                right_size=bool(arrays["right_size"]),
                pref_rows=pref_rows, pref_idx=pref_idx,
                pref_lambda=pref_lambda)
            node_off, assign, unplaced, cost = \
                self.solver._solve_prepared(prep)
        metrics.SOLVE_DURATION.labels("sidecar").observe(
            time.perf_counter() - t0)
        return _pack(node_off=node_off, assign=assign.astype(np.int32),
                     unplaced=unplaced, cost=np.float32(cost))

    def _solve_flat_maybe(self, cat, arrays, pref_rows=None,
                          pref_idx=None, pref_lambda=None):
        """Route heterogeneous wire solves to the flat program, as a
        local solve would route them.  Returns the reply bytes, or None
        for the packed route.  With a COO-capable client (``coo_ok``)
        the assignment ships as (idx, cnt): the dense [G, N] wire matrix
        is hundreds of MB at the 10k-group shape.  Soft preferences ride
        the flat program too."""
        from karpenter_tpu_torch.solver.flat import (
            dispatch_flat, finalize_flat_arrays, flat_viable,
        )
        from karpenter_tpu_torch.solver.torch_backend import (
            dedup_rows, expand_coo_assign,
        )

        opts = self.solver.options
        # cheap row-independent gates first; the wire's right_size flag
        # wins over the server's defaults, and the G threshold counts the
        # real groups, not the wire padding
        if opts.flat_solver == "off" or not bool(arrays["right_size"]):
            return None
        real_g = int((arrays["group_count"] > 0).sum())
        if opts.flat_solver != "on" and real_g < opts.flat_min_groups:
            return None
        compat = arrays["compat"]
        if "label_rows" in arrays and "label_idx" in arrays:
            # the client encoder's fit-free factoring: the flat classes
            # must not fragment on per-group fit patterns
            rows = arrays["label_rows"].astype(bool)
            label_idx = arrays["label_idx"]
        else:
            label_idx, rows = dedup_rows(compat)
        shim = _WireProblem(
            catalog=cat, group_req=arrays["group_req"],
            group_count=arrays["group_count"],
            group_cap=arrays["group_cap"],
            label_rows=rows, label_idx=label_idx,
            pref_rows=pref_rows, pref_idx=pref_idx)
        if not flat_viable(shim, opts):
            return None
        attempt = dispatch_flat(self.solver, shim, pref_lambda=pref_lambda)
        if attempt is None:
            return None
        node_off, unplaced, cost, idx, cnt = finalize_flat_arrays(
            self.solver, shim, attempt)
        G = compat.shape[0]
        if bool(arrays.get("coo_ok", False)):
            return _pack(node_off=node_off, unplaced=unplaced[:G],
                         cost=np.float32(cost), assign_coo_idx=idx,
                         assign_coo_cnt=cnt,
                         coo_g=np.int64(attempt.G_pad))
        assign = expand_coo_assign(idx, cnt, attempt.G_pad,
                                   node_off.shape[0])[:G]
        return _pack(node_off=node_off, assign=assign.astype(np.int32),
                     unplaced=unplaced[:G], cost=np.float32(cost))

    def _solve_batch(self, request: bytes, context=None) -> bytes:
        """The zone-candidate batch: C problems sharing req/count/cap and
        the catalog, each with its own compat, in one device dispatch
        (``solve_packed_batch_torch``, the fleet FFD kernel)."""
        from karpenter_tpu_torch.faulttol import device_guard
        from karpenter_tpu_torch.obs.prof import get_profiler
        from karpenter_tpu_torch.solver.packed import (
            solve_packed_batch_torch,
        )
        from karpenter_tpu_torch.solver.torch_backend import (
            _pad2, clamp_output_opts, coo_buffer_full, dedup_rows, grow_coo,
            needs_node_escalation, pack_input, unpack_result, upload,
        )
        from karpenter_tpu_torch.solver.types import LABELROW_BUCKETS

        t0 = time.perf_counter()
        arrays = _unpack(request)
        cat = self._catalog_for(arrays)
        if cat is None:
            return _pack(error=np.array("unknown catalog; re-upload"))
        compat = arrays["compat"]                      # [C, G, O]
        C, G, O = compat.shape
        # the batch axis is padded with row 0, so shrinking candidate
        # sets across refinement rounds reuse a handful of widths
        C_pad = bucket(C, BATCH_BUCKETS)
        # candidates are the base problem with one (or few) re-pinned
        # rows: the base is deduped once and each candidate patches only
        # its rows that differ
        factored = [dedup_rows(compat[0])]
        for c in range(1, C):
            diff = np.nonzero((compat[c] != compat[0]).any(axis=1))[0]
            if diff.size > max(8, G // 4):
                factored.append(dedup_rows(compat[c]))   # unusually different
                continue
            idx0, rows0 = factored[0]
            idx_c = idx0.copy()
            extra = []
            for gdx in diff:
                row = compat[c][gdx]
                hits = np.nonzero((rows0 == row[None, :]).all(axis=1))[0]
                if hits.size:
                    idx_c[gdx] = int(hits[0])
                    continue
                for j, er in enumerate(extra):
                    if (er == row).all():
                        idx_c[gdx] = rows0.shape[0] + j
                        break
                else:
                    extra.append(row)
                    idx_c[gdx] = rows0.shape[0] + len(extra) - 1
            rows_c = (np.concatenate([rows0, np.stack(extra)])
                      if extra else rows0)
            factored.append((idx_c, rows_c))
        U_pad = bucket(max(max(r.shape[0] for _, r in factored), 1),
                       LABELROW_BUCKETS)
        packed_rows = [pack_input(arrays["group_req"],
                                  arrays["group_count"],
                                  arrays["group_cap"], idx,
                                  _pad2(rws, U_pad, O))
                       for idx, rws in factored]
        rows = np.stack(packed_rows + [packed_rows[0]] * (C_pad - C))
        N = int(arrays["num_nodes"])
        n_cap = int(arrays.get("n_cap", N))
        total = int(arrays["group_count"].sum())
        solver = self.solver
        with self._solver_lock:
            off_alloc, off_price, off_rank = solver.device_offerings(cat, O)
            K0, K_cap = solver._compact_k(total, G)
            while True:
                K, _dense16, _coo16 = clamp_output_opts(K0, False, G, N)
                with device_guard("scan-batch",
                                  devices=solver.device_ids) as guard:
                    with get_profiler().sampled("scan-batch") as probe:
                        out = solve_packed_batch_torch(
                            upload(rows, solver.device), off_alloc,
                            off_price, off_rank, C=C_pad, G=G, O=O,
                            U=U_pad, N=N,
                            right_size=bool(arrays["right_size"]),
                            compact=K)
                        probe.dispatched(out)
                    out_np = guard.fetch(out)
                if any(coo_buffer_full(out_np[c], G, N, K)
                       for c in range(C)) and K0 < K_cap:
                    K0 = grow_coo(K0, K_cap)
                    continue
                parsed = [unpack_result(out_np[c], G, N, K)
                          for c in range(C)]
                if any(needs_node_escalation(no, u, N, n_cap)
                       for no, _, u, _ in parsed):
                    N = min(n_cap, bucket(N * 4, NODE_BUCKETS))
                    continue
                break
        metrics.SOLVE_DURATION.labels("sidecar-batch").observe(
            time.perf_counter() - t0)
        return _pack(
            node_off=np.stack([p[0] for p in parsed]),
            assign=np.stack([p[1] for p in parsed]).astype(np.int32),
            unplaced=np.stack([p[2] for p in parsed]),
            cost=np.array([p[3] for p in parsed], dtype=np.float32),
            num_nodes=np.int64(N))


class SolverServer(SolverHandlers):
    """The sidecar: the byte handlers behind a gRPC server on
    ``host:port`` (port 0 picks a free one: ``self.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 options: SolverOptions | None = None, device="cuda"):
        import grpc

        super().__init__(options, device=device)
        handler = grpc.method_handlers_generic_handler(_SERVICE, {
            name: grpc.unary_unary_rpc_method_handler(
                self._naming_device(fn), request_deserializer=_identity,
                response_serializer=_identity)
            for name, fn in (("Solve", self._solve),
                             ("SolveBatch", self._solve_batch),
                             ("UploadCatalog", self._upload))})
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4))
        self._server.add_generic_rpc_handlers((handler,))
        self.port = self._server.add_insecure_port(f"{host}:{port}")

    def _naming_device(self, fn):
        """``fn`` with the server's device set in the trailing metadata
        first, so an error status carries it too."""
        def handler(request, context):
            context.set_trailing_metadata(
                ((DEVICE_METADATA, str(self.device)),))
            return fn(request, context)
        return handler

    def start(self) -> "SolverServer":
        self._server.start()
        log.info("solver sidecar listening", port=self.port,
                 device=str(self.device))
        return self

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace).wait()


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

class _WireProblem:
    """EncodedProblem-shaped view over wire arrays, with the fields the
    flat program reads (``flat_viable`` / ``dispatch_flat`` /
    ``estimate_nodes``).  Decoding stays client-side: the server never
    sees pod names."""

    __slots__ = ("catalog", "group_req", "group_count", "group_cap",
                 "label_rows", "label_idx", "pref_rows", "pref_idx",
                 "aff", "_prep_cache")

    def __init__(self, *, catalog, group_req, group_count, group_cap,
                 label_rows, label_idx, pref_rows=None, pref_idx=None):
        self.catalog = catalog
        self.group_req = group_req
        self.group_count = group_count
        self.group_cap = group_cap
        self.label_rows = label_rows
        self.label_idx = label_idx
        self.pref_rows = pref_rows
        self.pref_idx = pref_idx
        self.aff = None              # the wire carries no affinity plane
        self._prep_cache = {}        # the flat template of this request

    @property
    def num_groups(self) -> int:
        return int(self.group_req.shape[0])


class RemoteSolver:
    """Drop-in solver backend speaking to a sidecar (the port's
    :class:`SolverServer` or the reference's)."""

    def __init__(self, address: str,
                 options: SolverOptions | None = None):
        import grpc

        self.options = options or SolverOptions(backend="remote")
        self._channel = grpc.insecure_channel(address)
        self._solve, self._solve_batch, self._upload = (
            self._learning_device(self._channel.unary_unary(
                f"/{_SERVICE}/{name}", request_serializer=_identity,
                response_deserializer=_identity))
            for name in ("Solve", "SolveBatch", "UploadCatalog"))
        self._uploaded: dict[str, int] = {}
        # the server's device, from its last reply (None: not known)
        self.device: torch.device | None = None

    def _learning_device(self, stub):
        """``stub`` that sets ``self.device`` from the device a reply or
        an error status names in its trailing metadata."""
        import grpc

        def learn(call) -> None:
            for key, value in call.trailing_metadata() or ():
                if key == DEVICE_METADATA:
                    self.device = torch.device(value)

        def call(request: bytes) -> bytes:
            try:
                reply, done = stub.with_call(request)
            except grpc.RpcError as e:
                learn(e)
                raise
            learn(done)
            return reply
        return call

    def close(self) -> None:
        self._channel.close()

    # -- Solver surface ----------------------------------------------------

    def solve(self, request: SolveRequest) -> Plan:
        from karpenter_tpu_torch.solver.zonesplit import (
            solve_with_zone_candidates,
        )

        t0 = time.perf_counter()
        # handles the zone_candidates gate internally (each candidate
        # round is one more sidecar round trip, capped by
        # zone_candidate_solves)
        plan = solve_with_zone_candidates(self, request)
        plan.solve_seconds = time.perf_counter() - t0
        metrics.SOLVE_DURATION.labels("remote").observe(plan.solve_seconds)
        return plan

    def solve_encoded(self, problem: EncodedProblem) -> Plan:
        from karpenter_tpu_torch.solver.encode import estimate_nodes
        from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2

        catalog = problem.catalog
        if problem.num_groups == 0:
            return Plan(nodes=[], unplaced_pods=list(problem.rejected),
                        backend="remote")
        G = bucket(problem.num_groups, GROUP_BUCKETS)
        O = bucket(catalog.num_offerings, OFFERING_BUCKETS)
        self._ensure_catalog(catalog, O)

        total = int(problem.group_count.sum())
        N_cap = min(self.options.max_nodes, bucket(max(total, 1),
                                                   NODE_BUCKETS))
        N = estimate_nodes(problem, N_cap, NODE_BUCKETS) \
            if self.options.adaptive_nodes else N_cap
        cat_id, gen = self._catalog_key(catalog)
        # the fit-free label factoring rides the wire, so the server's
        # flat route classes by constraint row, not fit pattern
        extra_kw = {}
        if problem.label_rows is not None and problem.label_idx is not None:
            U = problem.label_rows.shape[0]
            lidx = np.zeros(G, np.int32)
            lidx[:problem.label_idx.shape[0]] = problem.label_idx
            extra_kw = dict(
                label_rows=_pad2(problem.label_rows, U, O),
                label_idx=lidx)
        # soft preferences ride two extra (small) wire arrays
        pref_kw = {}
        if problem.pref_rows is not None and problem.pref_idx is not None:
            pidx = np.full(G, -1, np.int32)
            pidx[:problem.pref_idx.shape[0]] = problem.pref_idx
            pref_kw = dict(
                pref_rows=_pad2(problem.pref_rows.astype(np.float32),
                                problem.pref_rows.shape[0], O),
                pref_idx=pidx,
                pref_lambda_bp=np.int64(
                    int(self.options.preference_lambda * 10000)))
        reuploaded = False
        while True:
            # node escalation happens server-side within one call; this
            # loop exists for the restarted sidecar's catalog re-upload
            resp = _unpack(self._solve(_pack(
                catalog_id=np.array(cat_id), generation=np.int64(gen),
                group_req=_pad2(problem.group_req, G),
                group_count=_pad1(problem.group_count, G),
                group_cap=_pad1(problem.group_cap, G),
                compat=_pad2(problem.compat, G, O),
                num_nodes=np.int64(N),
                right_size=np.bool_(self.options.right_size),
                n_cap=np.int64(N_cap), coo_ok=np.bool_(True),
                **extra_kw, **pref_kw)))
            if "error" in resp:
                err = str(resp["error"])
                # a restarted sidecar loses its catalog cache: drop the
                # memo, re-upload, retry once
                if "unknown catalog" in err and not reuploaded:
                    self._uploaded.pop(cat_id, None)
                    self._ensure_catalog(catalog, O)
                    reuploaded = True
                    continue
                raise RuntimeError(err)
            # version skew: a sidecar that ignores n_cap answers at the
            # requested N without escalating; climb client-side
            node_off = resp["node_off"]
            server_n = int(node_off.shape[0])
            if (int(resp["unplaced"].sum()) > 0
                    and int((node_off >= 0).sum()) >= server_n
                    and server_n < N_cap and N < N_cap):
                N = min(N_cap, bucket(max(N, server_n) * 4, NODE_BUCKETS))
                continue
            break
        if "assign_coo_idx" in resp:
            # the flat route's COO wire: decode straight from entries
            from karpenter_tpu_torch.solver.encode import decode_plan_entries

            Gp = int(resp["coo_g"])
            cnt = resp["assign_coo_cnt"]
            live = cnt > 0
            fi = resp["assign_coo_idx"][live]
            return decode_plan_entries(
                problem, resp["node_off"].astype(np.int32), fi % Gp,
                fi // Gp, cnt[live].astype(np.int32), resp["unplaced"],
                float(resp["cost"]), "remote")
        return decode_plan(problem, resp["node_off"],
                           resp["assign"].astype(np.int32),
                           resp["unplaced"], float(resp["cost"]), "remote")

    def solve_encoded_batch(self, problems) -> list[Plan]:
        """The zone-candidate batch over one sidecar round trip.  Problems
        must share the catalog and group arrays and differ only in
        compat (what the zone refinement produces); otherwise each takes
        its own ``Solve``."""
        from karpenter_tpu_torch.solver.encode import estimate_nodes
        from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2

        if not problems:
            return []
        base = problems[0]
        catalog = base.catalog
        if base.pref_rows is not None:
            # the batch wire has no preference leaves
            return [self.solve_encoded(p) for p in problems]
        if any(p.catalog is not catalog
               or p.num_groups != base.num_groups
               or not (np.array_equal(p.group_req, base.group_req)
                       and np.array_equal(p.group_count, base.group_count)
                       and np.array_equal(p.group_cap, base.group_cap))
               for p in problems[1:]):
            # the wire sends one copy of req/count/cap for every
            # candidate: problems that differ beyond compat go one by one
            return [self.solve_encoded(p) for p in problems]
        G = bucket(base.num_groups, GROUP_BUCKETS)
        O = bucket(catalog.num_offerings, OFFERING_BUCKETS)
        self._ensure_catalog(catalog, O)
        total = int(base.group_count.sum())
        N_cap = min(self.options.max_nodes, bucket(max(total, 1),
                                                   NODE_BUCKETS))
        N = estimate_nodes(base, N_cap, NODE_BUCKETS) \
            if self.options.adaptive_nodes else N_cap
        cat_id, gen = self._catalog_key(catalog)
        compat = np.stack([_pad2(p.compat, G, O) for p in problems])
        reuploaded = False
        while True:
            try:
                raw = self._solve_batch(_pack(
                    catalog_id=np.array(cat_id), generation=np.int64(gen),
                    group_req=_pad2(base.group_req, G),
                    group_count=_pad1(base.group_count, G),
                    group_cap=_pad1(base.group_cap, G),
                    compat=compat,
                    num_nodes=np.int64(N), n_cap=np.int64(N_cap),
                    right_size=np.bool_(self.options.right_size)))
            except Exception as e:  # noqa: BLE001 — re-raised below
                code = getattr(e, "code", None)
                if callable(code) and \
                        getattr(code(), "name", "") == "UNIMPLEMENTED":
                    # a sidecar without SolveBatch: one Solve a candidate
                    log.warning("sidecar lacks SolveBatch; sequential "
                                "candidate solves engaged")
                    return [self.solve_encoded(p) for p in problems]
                raise
            resp = _unpack(raw)
            if "error" in resp:
                err = str(resp["error"])
                if "unknown catalog" in err and not reuploaded:
                    self._uploaded.pop(cat_id, None)
                    self._ensure_catalog(catalog, O)
                    reuploaded = True
                    continue
                raise RuntimeError(err)
            break
        return [decode_plan(p, resp["node_off"][c],
                            resp["assign"][c].astype(np.int32),
                            resp["unplaced"][c], float(resp["cost"][c]),
                            "remote")
                for c, p in enumerate(problems)]

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _catalog_key(catalog) -> tuple[str, int]:
        return (f"{catalog.uid}", hash(
            (catalog.generation, catalog.availability_generation)) & 0x7fffffff)

    def _ensure_catalog(self, catalog, O_pad: int) -> None:
        cat_id, gen = self._catalog_key(catalog)
        if self._uploaded.get(cat_id) == gen:
            return
        from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2

        self._upload(_pack(
            catalog_id=np.array(cat_id), generation=np.int64(gen),
            off_alloc=_pad2(catalog.offering_alloc().astype(np.int32), O_pad),
            off_price=_pad1(catalog.off_price.astype(np.float32), O_pad),
            off_rank=_pad1(catalog.offering_rank_price(), O_pad)))
        self._uploaded[cat_id] = gen


# ---------------------------------------------------------------------------
# Module entry: `python -m karpenter_tpu_torch.service --port 50061` runs
# the sidecar standalone, on the card unless `--device cpu`.
# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        description="karpenter-tpu solver sidecar (PyTorch/CUDA)")
    # localhost-only by default: the service is unauthenticated insecure
    # gRPC, meant to be reached from the controller container in the same
    # pod, never from the cluster network
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=50061)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    server = SolverServer(host=args.host, port=args.port,
                          device=args.device).start()
    done = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    server.stop()


if __name__ == "__main__":
    main()
