"""Fleet-scale solves: C independent cluster problems in one device program.

Port of the single-device fleet of ``karpenter_tpu/parallel/fleet.py``
(BASELINE config #5: many clusters, each with its own pending pods and
its own offering catalog, solved jointly).  The stacked problem is
packed into one [C, Li] buffer, uploaded once, solved by
``solver/packed.py::fleet_packed_torch`` (one launch of the fleet FFD
kernel, each block reading its cluster's catalog) and fetched as one
[C, Lo] buffer in the bare result layout.  Results equal a solve of each
cluster on its own, bit for bit.

With ``resident_buf`` (a ``resident.store.ResidentBuffer``) the stacked
input stays on the device across windows: an unchanged window reuses it
and a churned one moves only its word delta.

Each dispatch and each fetch runs inside ``device_guard("fleet-pallas")``
(the reference's name for this site), the dispatch inside a sampled
profiler bracket and a devtel note.

Not ported: ``fleet_solve`` / ``fleet_solve_pallas_sharded`` /
``fleet_solve_sharded_offerings``, which shard the fleet or the catalog
over a device mesh and need more than one device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.solver.packed import fleet_packed_torch
from karpenter_tpu_torch.solver.torch_backend import (
    _pad2, coo_buffer_full, dedup_rows, grow_coo, pack_input, start_fetch,
    unpack_result, upload,
)
from karpenter_tpu_torch.solver.types import LABELROW_BUCKETS, bucket


@dataclass
class FleetProblem:
    """Stacked multi-cluster problem: leading axis = cluster."""

    group_req: np.ndarray      # [C, G, R] int32
    group_count: np.ndarray    # [C, G] int32
    group_cap: np.ndarray      # [C, G] int32
    compat: np.ndarray         # [C, G, O] bool
    off_alloc: np.ndarray      # [C, O, R] int32
    off_price: np.ndarray      # [C, O] float32
    off_rank: np.ndarray       # [C, O] float32

    @property
    def num_clusters(self) -> int:
        return self.group_req.shape[0]


def fleet_device_catalog(problem: FleetProblem, device="cuda"):
    """Per-cluster catalog tensors on ``device``: (alloc int32 [C, O, 4],
    rank float32 [C, O], price float32 [C, O]).  Upload once and reuse
    across solve windows: catalogs are static between refreshes, only
    the per-window problem buffer should move."""
    dev = resolve_device(device)
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(dev)
        for a, dt in ((problem.off_alloc, np.int32),
                      (problem.off_rank, np.float32),
                      (problem.off_price, np.float32)))


def fleet_pack_inputs(problem: FleetProblem):
    """Stacked packed per-cluster buffers [C, Li] + the common label-row
    bucket they share."""
    C, G, O = problem.compat.shape
    factored = [dedup_rows(problem.compat[c]) for c in range(C)]
    U_pad = bucket(max(max(r.shape[0] for _, r in factored), 1),
                   LABELROW_BUCKETS)
    ins = np.stack([pack_input(problem.group_req[c], problem.group_count[c],
                               problem.group_cap[c], factored[c][0],
                               _pad2(factored[c][1], U_pad, O))
                    for c in range(C)])
    return ins, U_pad


def fleet_parse_outputs(out_np: np.ndarray, C: int, G: int, N: int, K: int):
    """[C, Lo] results -> (node_off [C, N], assign [C, G, N], unplaced
    [C, G], cost [C])."""
    node_off = np.empty((C, N), np.int32)
    assign = np.empty((C, G, N), np.int32)
    unplaced = np.empty((C, G), np.int32)
    cost = np.empty(C, np.float32)
    for c in range(C):
        node_off[c], assign[c], unplaced[c], cost[c] = unpack_result(
            out_np[c], G, N, K)
    return node_off, assign, unplaced, cost


class CooCapacity:
    """COO fetch capacity shared across solve windows: starts small,
    grows on the overflow signal, and stays grown, so later windows of
    an nnz-heavy workload do not pay the re-dispatch again."""

    __slots__ = ("k", "cap")

    def __init__(self, initial: int, cap: int):
        self.k = min(initial, cap)
        self.cap = cap


def fleet_solve_packed(problem: FleetProblem, *, num_nodes: int,
                       device="cuda", right_size: bool = True,
                       device_catalog=None,
                       coo_state: CooCapacity | None = None,
                       packed_inputs=None, async_only: bool = False,
                       resident_buf=None):
    """Single-dispatch fleet solve on ``device`` (the card unless
    ``"cpu"`` is asked for, where the kernel's plain version runs).
    Returns (node_off [C, N], assign [C, G, N], unplaced [C, G], cost
    [C]) numpy arrays, N = ``num_nodes``.

    ``device_catalog`` (from :func:`fleet_device_catalog`) keeps the
    catalog upload out of the per-window path; ``packed_inputs`` (from
    :func:`fleet_pack_inputs`) hoists host packing out of a timing loop;
    ``async_only`` returns a zero-arg finalizer (the result copy is
    already in flight) for pipelined window streams.  ``coo_state``
    fetches the assignment as COO with ``coo_state.k`` slots (dense
    without it): the finalizer re-dispatches at 4x, up to
    ``coo_state.cap``, on the sound full-buffer overflow signal, and the
    grown capacity persists across windows.  ``resident_buf`` (a
    ``resident.store.ResidentBuffer``) keeps the stacked [C, Li] input
    resident on the device: a window with no change uploads nothing, a
    churned one only its padded word delta (``resident_buf.stats`` and
    the returned delta of its ``update`` count which).  The resident
    buffer feeds the first dispatch only: a COO re-dispatch uploads this
    window's host buffer, since a later window's update may have
    rewritten the resident one by the time an ``async_only`` finalizer
    runs."""
    dev = resolve_device(device)
    C, G, O = problem.compat.shape
    N = num_nodes
    ins, U_pad = packed_inputs or fleet_pack_inputs(problem)
    if device_catalog is None:
        device_catalog = fleet_device_catalog(problem, dev)
    alloc_all, rank_all, price_all = device_catalog
    if coo_state is None:
        coo_state = CooCapacity(0, 0)

    ids = [device_id(dev)]

    def dispatch(dev_ins, K):
        # a host buffer is an H2D upload no donated device buffer
        # replaced; the resident buffer accounts its own delta
        host_input = dev_ins is None
        get_devtel().note_dispatch(
            "fleet-pallas", (C, G, O, U_pad, N, K, right_size),
            h2d_bytes=int(ins.nbytes) if host_input else 0,
            donated=not host_input)
        with device_guard("fleet-pallas", devices=ids):
            with get_profiler().sampled("fleet-pallas") as probe:
                out = fleet_packed_torch(
                    upload(ins, dev) if host_input else dev_ins, alloc_all,
                    rank_all, price_all, C=C, G=G, O=O, U=U_pad, N=N,
                    right_size=right_size, compact=K)
                probe.dispatched(out)
        return start_fetch(out)

    K0 = coo_state.k
    first = dispatch(None if resident_buf is None
                     else resident_buf.update(ins, dev,
                                              kernel="fleet-resident")[0],
                     K0)

    def finalize():
        K, (host, event) = K0, first
        while True:
            with device_guard("fleet-pallas", devices=ids) as guard:
                out_np = guard.fetch(host, event=event)
            get_devtel().note_d2h(int(out_np.nbytes))
            if 0 < K < coo_state.cap and any(
                    coo_buffer_full(out_np[c], G, N, K) for c in range(C)):
                K = grow_coo(K, coo_state.cap)
                coo_state.k = max(coo_state.k, K)   # persist across windows
                host, event = dispatch(None, K)
                continue
            return fleet_parse_outputs(out_np, C, G, N, K)

    return finalize if async_only else finalize()
