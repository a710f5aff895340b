"""Fleet-scale solves: C independent cluster problems in one device program.

Port of the single-device fleet of ``karpenter_tpu/parallel/fleet.py``
(BASELINE config #5: many clusters, each with its own pending pods and
its own offering catalog, solved jointly).  The stacked problem is
packed into one [C, Li] buffer, uploaded once, solved by
``solver/packed.py::fleet_packed_torch`` (one launch of the fleet FFD
kernel, each block reading its cluster's catalog) and fetched as one
[C, Lo] buffer in the bare result layout.  Results equal a solve of each
cluster on its own, bit for bit.

Not ported: ``fleet_solve`` / ``fleet_solve_pallas_sharded`` /
``fleet_solve_sharded_offerings``, which shard the fleet or the catalog
over a device mesh and need more than one device, and the resident
input buffer (``resident_buf``; ROADMAP queue 1 item 8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
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
    grown capacity persists across windows."""
    if resident_buf is not None:
        raise NotImplementedError(
            "the resident fleet input buffer is not ported yet (ROADMAP "
            "queue 1 item 8)")
    dev = resolve_device(device)
    C, G, O = problem.compat.shape
    N = num_nodes
    ins, U_pad = packed_inputs or fleet_pack_inputs(problem)
    if device_catalog is None:
        device_catalog = fleet_device_catalog(problem, dev)
    alloc_all, rank_all, price_all = device_catalog
    if coo_state is None:
        coo_state = CooCapacity(0, 0)

    def dispatch(K):
        out = fleet_packed_torch(upload(ins, dev), alloc_all, rank_all,
                                 price_all, C=C, G=G, O=O, U=U_pad, N=N,
                                 right_size=right_size, compact=K)
        return start_fetch(out)

    K0 = coo_state.k
    first = dispatch(K0)

    def finalize():
        K, (host, event) = K0, first
        while True:
            if event is not None:
                event.synchronize()
            out_np = host.numpy()
            if 0 < K < coo_state.cap and any(
                    coo_buffer_full(out_np[c], G, N, K) for c in range(C)):
                K = grow_coo(K, coo_state.cap)
                coo_state.k = max(coo_state.k, K)   # persist across windows
                host, event = dispatch(K)
                continue
            return fleet_parse_outputs(out_np, C, G, N, K)

    return finalize if async_only else finalize()
