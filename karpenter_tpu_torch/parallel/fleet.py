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

The mesh half (``parallel/mesh.py`` meshes, one slot per device):

- :func:`fleet_solve` and :func:`fleet_solve_pallas_sharded` split the
  C clusters into contiguous blocks of C / width (the reference's
  ``P(FLEET_AXIS)``); each slot solves its block through
  ``fleet_packed_torch`` on its device (one ``ffd_scan_fleet`` launch
  and one ``cost_sum`` launch per slot), every slot dispatched before
  any is fetched, all inside one guard over the mesh's devices
  ("fleet-scan", "fleet-pallas-sharded");
- :func:`fleet_solve_sharded_offerings` splits the clusters over the
  fleet axis and each cluster's catalog over the offer axis;
  :func:`sharded_solve_core` runs the reference's offer-sharded FFD scan
  (an XLA ``lax.scan`` there, no Pallas kernel) as torch ops on each
  slot, batched over the slot's clusters, with the node state
  replicated on every offer slot and combined through the collectives
  of ``parallel/collectives.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id, device_ids
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.parallel.collectives import (
    gather_global, pmin, psum,
)
from karpenter_tpu_torch.parallel.mesh import (
    FLEET_AXIS, OFFER_AXIS, Mesh, on_slot,
)
from karpenter_tpu_torch.solver.packed import fleet_packed_torch
from karpenter_tpu_torch.solver.torch_backend import (
    _pad1, _pad2, coo_buffer_full, dedup_rows, grow_coo, pack_input, start_fetch,
    unpack_result, upload,
)
from karpenter_tpu_torch.solver.types import FIT_BIG, LABELROW_BUCKETS, bucket


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


# ---------------------------------------------------------------------------
# Fleet axis over a mesh: clusters data-parallel
# ---------------------------------------------------------------------------

_BIG_I32 = 2 ** 31 - 1


def _axis_slots(mesh: Mesh, axis: str) -> list[torch.device]:
    """The slots along ``axis`` (index 0 on every other axis)."""
    arr = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(arr.reshape(arr.shape[0], -1)[:, 0])


def _blocks(C: int, n: int) -> int:
    if C % n:
        raise ValueError(f"clusters {C} not divisible by fleet axis {n}")
    return C // n


def _slice(problem: FleetProblem, lo: int, hi: int) -> FleetProblem:
    return FleetProblem(*(a[lo:hi] for a in (
        problem.group_req, problem.group_count, problem.group_cap,
        problem.compat, problem.off_alloc, problem.off_price,
        problem.off_rank)))


def _pad_offerings(problem: FleetProblem) -> FleetProblem:
    """The problem with its offering axis padded to a multiple of 32, the
    packed layout's label-row word (a padded offering is compatible with
    no group, so it is never opened nor picked when right-sizing)."""
    O = problem.compat.shape[2]
    O_pad = -(-O // 32) * 32
    if O_pad == O:
        return problem
    C, G = problem.compat.shape[:2]
    return FleetProblem(
        problem.group_req, problem.group_count, problem.group_cap,
        np.stack([_pad2(problem.compat[c], G, O_pad) for c in range(C)]),
        np.stack([_pad2(problem.off_alloc[c], O_pad) for c in range(C)]),
        np.stack([_pad1(problem.off_price[c], O_pad) for c in range(C)]),
        np.stack([_pad1(problem.off_rank[c], O_pad) for c in range(C)]))


def _slot_catalogs(problem: FleetProblem, slots, Cb: int):
    """Each slot's block of the per-cluster catalogs, on its device."""
    return [fleet_device_catalog(_slice(problem, w * Cb, (w + 1) * Cb), dev)
            for w, dev in enumerate(slots)]


def _dispatch_slots(ins: np.ndarray, catalogs, slots, *, Cb: int, G: int,
                    O: int, U: int, N: int, right_size: bool, K: int):
    """One ``fleet_packed_torch`` per slot over its block of the packed
    rows, every slot dispatched before any is fetched.  Returns the
    slots' device results and their (host copy, event) pairs."""
    outs, pending = [], []
    for w, (dev, cat) in enumerate(zip(slots, catalogs)):
        with on_slot(dev):
            out = fleet_packed_torch(
                upload(np.ascontiguousarray(ins[w * Cb:(w + 1) * Cb]), dev),
                *cat, C=Cb, G=G, O=O, U=U, N=N, right_size=right_size,
                compact=K)
            outs.append(out)
            pending.append(start_fetch(out))
    return tuple(outs), pending


def _fetch_slots(guard, pending) -> np.ndarray:
    """The slots' results, stacked in slot order, through the guard."""
    for _, event in pending[:-1]:
        if event is not None:
            event.synchronize()
    hosts = guard.fetch(tuple(h for h, _ in pending), event=pending[-1][1])
    return np.concatenate(hosts)


def fleet_solve(problem: FleetProblem, mesh: Mesh, *, num_nodes: int,
                right_size: bool = True):
    """Solve C cluster problems across the mesh's fleet axis, each slot
    its contiguous block of C / width clusters on its device.  C must be
    divisible by the fleet-axis width.  Returns numpy (node_off [C, N],
    assign [C, G, N], unplaced [C, G], cost [C]), N = ``num_nodes``."""
    slots = _axis_slots(mesh, FLEET_AXIS)
    C, G, _ = problem.compat.shape
    Cb = _blocks(C, len(slots))
    h2d = sum(int(a.nbytes) for a in (
        problem.group_req, problem.group_count, problem.group_cap,
        problem.compat, problem.off_alloc, problem.off_price,
        problem.off_rank) if isinstance(a, np.ndarray))
    get_devtel().note_dispatch(
        "fleet-scan", problem.compat.shape + (num_nodes, right_size),
        h2d_bytes=h2d, donated=h2d == 0)
    problem = _pad_offerings(problem)
    O = problem.compat.shape[2]
    ins, U_pad = fleet_pack_inputs(problem)
    with device_guard("fleet-scan",
                      devices=device_ids(mesh.devices.flat)) as guard:
        with get_profiler().sampled("fleet-scan") as probe:
            outs, pending = _dispatch_slots(
                ins, _slot_catalogs(problem, slots, Cb), slots, Cb=Cb, G=G,
                O=O, U=U_pad, N=num_nodes, right_size=right_size, K=0)
            probe.dispatched(outs)
        out_np = _fetch_slots(guard, pending)
    get_devtel().note_d2h(int(out_np.nbytes))
    return fleet_parse_outputs(out_np, C, G, num_nodes, 0)


def fleet_solve_pallas_sharded(problem: FleetProblem, mesh: Mesh, *,
                               num_nodes: int, right_size: bool = True,
                               compact: int = 0,
                               compact_cap: int | None = None):
    """The fleet axis over the mesh at N = max(num_nodes, 128), each slot
    one launch of the fleet kernel over its block of clusters.  C % width
    == 0 required; each cluster's result equals the single-device fleet
    path's.  An undersized ``compact`` escalates on the full-buffer
    overflow signal: if any slot's buffer is full, the whole mesh
    re-dispatches at ``grow_coo(K, K_cap)``.  The reference's
    ``interpret`` has no counterpart: CPU slots run the kernel's plain
    version."""
    slots = _axis_slots(mesh, FLEET_AXIS)
    n = len(slots)
    problem = _pad_offerings(problem)
    C, G, O = problem.compat.shape
    Cb = _blocks(C, n)
    N = max(num_nodes, 128)
    ins, U_pad = fleet_pack_inputs(problem)
    catalogs = _slot_catalogs(problem, slots, Cb)
    K = min(compact, G * N)
    K_cap = min(compact_cap if compact_cap is not None else compact, G * N)
    ids = device_ids(mesh.devices.flat)
    while True:
        get_devtel().note_dispatch(
            "fleet-pallas-sharded", (n, C, G, O, U_pad, N, K, right_size),
            h2d_bytes=int(ins.nbytes), donated=False)
        with device_guard("fleet-pallas-sharded", devices=ids) as guard:
            with get_profiler().sampled("fleet-pallas-sharded") as probe:
                outs, pending = _dispatch_slots(
                    ins, catalogs, slots, Cb=Cb, G=G, O=O, U=U_pad, N=N,
                    right_size=right_size, K=K)
                probe.dispatched(outs)
            out_np = _fetch_slots(guard, pending)
        get_devtel().note_d2h(int(out_np.nbytes))
        if 0 < K < K_cap and any(
                coo_buffer_full(out_np[c], G, N, K) for c in range(C)):
            K = grow_coo(K, K_cap)
            continue
        return fleet_parse_outputs(out_np, C, G, N, K)


# ---------------------------------------------------------------------------
# Offer axis: catalog model-parallel with pmin/psum collectives
# ---------------------------------------------------------------------------

def _fit_counts(resid: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[B, M, R] // [B, R] -> [B, M] pods that fit; dims with req == 0 are
    unconstrained."""
    per_dim = torch.where(
        req[:, None, :] > 0,
        torch.div(resid, torch.clamp(req, min=1)[:, None, :],
                  rounding_mode="floor"),
        FIT_BIG)
    return per_dim.min(dim=2).values


def _pick(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row b's entry ``idx[b]`` of ``t`` [B, M] (or its row [B, M, R] ->
    [B, R]), without a host read of the index."""
    i = idx.long()[:, None]
    if t.dim() == 2:
        return torch.gather(t, 1, i)[:, 0]
    return torch.gather(t, 1, i[:, :, None].expand(-1, 1, t.shape[2]))[:, 0]


def _ffd_step_sharded(slots, states, g: int, idx):
    """One FFD step (group ``g``) with the offering axis over the
    ``slots``: node state is replicated per slot; the cheapest-per-pod
    offering is picked by a two-stage :func:`pmin` (the global minimum
    cost, then the lowest global index among the slots that reach it)
    and the winner's fit and alloc row are broadcast by :func:`psum`.
    ``idx`` is each slot's arange(N).  Returns the slots' new states and
    (assign_g [B, N], unplaced_g [B]) per slot."""
    i32 = torch.int32
    N = idx[0].shape[0]
    node_compat = gather_global(
        [s.compat[:, g].to(i32) for s in slots],
        [st[0] for st in states], [s.base for s in slots])
    local = []
    for s, st, nc in zip(slots, states, node_compat):
        node_off, resid, _ = st
        req, count, cap = s.req[:, g], s.count[:, g], s.cap[:, g]
        fit = _fit_counts(resid, req)
        fit = torch.where((nc > 0) & (node_off >= 0), fit, 0)
        fit = torch.minimum(fit, cap[:, None])
        cumfit = torch.cumsum(fit, 1).to(i32) - fit          # exclusive
        take = torch.minimum(torch.clamp(count[:, None] - cumfit, min=0),
                             fit)
        placed = take.sum(1).to(i32)
        resid = (resid - take[:, :, None] * req[:, None, :]).to(i32)
        rem = count - placed
        # local cheapest-per-pod, capped by the pods remaining
        fe = _fit_counts(s.alloc, req)
        fe = torch.where(s.compat[:, g], fe, 0)
        fe = torch.minimum(torch.minimum(fe, cap[:, None]), rem[:, None])
        cpp = torch.where(fe > 0, s.rank / fe.to(torch.float32),
                          float("inf"))
        local_arg = torch.argmin(cpp, dim=1).to(i32)   # first index on ties
        local.append((resid, rem, take, fe, local_arg, _pick(cpp, local_arg)))
    global_min = pmin([lo[5] for lo in local])
    best = pmin([torch.where(lo[5] == gm, s.base + lo[4], _BIG_I32)
                 for s, lo, gm in zip(slots, local, global_min)])
    mine = [(b >= s.base) & (b < s.base + s.O_l) for s, b in zip(slots, best)]
    pos = [torch.clamp(b - s.base, 0, s.O_l - 1)
           for s, b in zip(slots, best)]
    bf = psum([torch.where(m, _pick(lo[3], p), 0).to(i32)
               for m, lo, p in zip(mine, local, pos)])
    best_alloc = psum([torch.where(m[:, None], _pick(s.alloc, p), 0).to(i32)
                       for s, m, p in zip(slots, mine, pos)])
    new_states, outs = [], []
    for s, st, lo, gm, b, f, ba, ar in zip(slots, states, local, global_min,
                                           best, bf, best_alloc, idx):
        node_off, _, ptr = st
        resid, rem, take = lo[0], lo[1], lo[2]
        req = s.req[:, g]
        f = torch.where(torch.isfinite(gm), f, 0)
        n_new = torch.where(
            f > 0, -torch.div(-rem, torch.clamp(f, min=1),
                              rounding_mode="floor"), 0).to(i32)
        n_new = torch.minimum(n_new, N - ptr)
        new_pos = ar[None, :] - ptr[:, None]
        is_new = (new_pos >= 0) & (new_pos < n_new[:, None])
        pods_new = torch.where(
            is_new, torch.minimum(
                torch.clamp(rem[:, None] - new_pos * f[:, None], min=0),
                f[:, None]), 0).to(i32)
        opened = is_new & (pods_new > 0)
        node_off = torch.where(opened, b[:, None], node_off)
        resid = torch.where(
            opened[:, :, None],
            ba[:, None, :] - pods_new[:, :, None] * req[:, None, :],
            resid).to(i32)
        ptr = (ptr + opened.sum(1)).to(i32)
        new_states.append((node_off, resid, ptr))
        outs.append((take + pods_new, rem - pods_new.sum(1).to(i32)))
    return new_states, outs


def _right_size_sharded(slots, node_off, resid, assign):
    """Sharded right-sizing (``_right_size_sharded``): each slot proposes
    its cheapest local candidate per node, the two-stage :func:`pmin`
    picks the global winner.  ``node_off`` / ``resid`` / ``assign`` are
    per slot (replicated); returns the slots' (node_off, resid)."""
    bases = [s.base for s in slots]
    alloc_at = gather_global([s.alloc for s in slots], node_off, bases)
    load = [a - r for a, r in zip(alloc_at, resid)]
    local = []
    for s, no, ld, asg in zip(slots, node_off, load, assign):
        is_open = no >= 0
        present = (asg > 0).to(torch.float32)                  # [B, G, N]
        incompat = (~s.compat).to(torch.float32)               # [B, G, O_l]
        incompat_count = present.transpose(1, 2) @ incompat    # [B, N, O_l]
        fits = (s.alloc[:, None, :, :] >= ld[:, :, None, :]).all(dim=3)
        candidate = (incompat_count < 0.5) & fits & is_open[:, :, None]
        cand_price = torch.where(candidate, s.rank[:, None, :],
                                 float("inf"))
        arg = torch.argmin(cand_price, dim=2).to(torch.int32)
        lmin = torch.gather(cand_price, 2, arg.long()[:, :, None])[:, :, 0]
        in_range = (no >= s.base) & (no < s.base + s.O_l)
        cur = torch.where(
            in_range, torch.gather(
                s.rank, 1, torch.clamp(no - s.base, 0, s.O_l - 1).long()),
            0.0)
        local.append((arg, lmin, cur))
    global_min = pmin([lo[1] for lo in local])
    best = pmin([torch.where(lo[1] == gm, s.base + lo[0], _BIG_I32)
                 for s, lo, gm in zip(slots, local, global_min)])
    cur_rank = psum([lo[2] for lo in local])
    improve = [(no >= 0) & torch.isfinite(gm) & (gm < cr - 1e-9)
               for no, gm, cr in zip(node_off, global_min, cur_rank)]
    new_off = [torch.where(im, b, no)
               for im, b, no in zip(improve, best, node_off)]
    new_alloc = gather_global([s.alloc for s in slots], new_off, bases)
    new_resid = [torch.where(im[:, :, None], na - ld, r)
                 for im, na, ld, r in zip(improve, new_alloc, load, resid)]
    return new_off, new_resid


def sharded_solve_core(group_req, group_count, group_cap, compat_l,
                       off_alloc_l, off_price_l, off_rank_l, *,
                       num_nodes: int, right_size: bool = True):
    """The offerings-sharded solve over one fleet row's offer slots
    (the body the reference runs inside ``shard_map``; its axis name is
    the slots' order here).  Every argument is a list with one tensor per
    offer slot, on that slot's device, batched over the row's B clusters
    (the reference's ``vmap``): ``group_req`` int32 [B, G, R],
    ``group_count`` / ``group_cap`` int32 [B, G] (replicated),
    ``compat_l`` bool [B, G, O_l], ``off_alloc_l`` int32 [B, O_l, R],
    ``off_price_l`` / ``off_rank_l`` float32 [B, O_l] (slot w holds the
    offerings ``[w * O_l, (w + 1) * O_l)``).  Returns per slot (node_off
    [B, N], assign [B, G, N], unplaced [B, G], cost [B]), equal on every
    slot.  The step loop reads nothing back to the host."""
    N = num_nodes
    i32 = torch.int32
    slots = [SimpleNamespace(req=rq, count=cn, cap=cp, compat=cm, alloc=al,
                             price=pr, rank=rk, O_l=int(rk.shape[1]),
                             base=w * int(rk.shape[1]))
             for w, (rq, cn, cp, cm, al, pr, rk) in enumerate(zip(
                 group_req, group_count, group_cap, compat_l, off_alloc_l,
                 off_price_l, off_rank_l))]
    B, G, R = group_req[0].shape
    states, idx = [], []
    for s in slots:
        dev = s.req.device
        states.append((torch.full((B, N), -1, dtype=i32, device=dev),
                       torch.zeros((B, N, R), dtype=i32, device=dev),
                       torch.zeros((B,), dtype=i32, device=dev)))
        idx.append(torch.arange(N, dtype=i32, device=dev))
    assign = [[] for _ in slots]
    unplaced = [[] for _ in slots]
    for g in range(G):
        states, outs = _ffd_step_sharded(slots, states, g, idx)
        for w, (a, u) in enumerate(outs):
            assign[w].append(a)
            unplaced[w].append(u)
    node_off = [st[0] for st in states]
    resid = [st[1] for st in states]
    assign = [torch.stack(a, dim=1) if a else
              torch.zeros((B, 0, N), dtype=i32, device=s.req.device)
              for a, s in zip(assign, slots)]
    unplaced = [torch.stack(u, dim=1) if u else
                torch.zeros((B, 0), dtype=i32, device=s.req.device)
                for u, s in zip(unplaced, slots)]
    if right_size:
        node_off, resid = _right_size_sharded(slots, node_off, resid, assign)
    local_cost = []
    for s, no in zip(slots, node_off):
        in_range = (no >= 0) & (no >= s.base) & (no < s.base + s.O_l)
        price = torch.gather(
            s.price, 1, torch.clamp(no - s.base, 0, s.O_l - 1).long())
        local_cost.append(torch.where(in_range, price, 0.0).sum(dim=1))
    cost = psum(local_cost)
    return [(no, a, u, c) for no, a, u, c in zip(node_off, assign, unplaced,
                                                   cost)]


def fleet_solve_sharded_offerings(problem: FleetProblem, mesh: Mesh, *,
                                  num_nodes: int, right_size: bool = True):
    """2D solve: clusters over FLEET_AXIS, offerings over OFFER_AXIS.
    C % fleet == 0 and O % offer == 0 required.  Each fleet row runs
    :func:`sharded_solve_core` over its offer slots; the results equal
    the unsharded solve's (ties go to the lowest global index).  Returns
    numpy (node_off [C, N], assign [C, G, N], unplaced [C, G], cost
    [C])."""
    n_offer = mesh.shape[OFFER_AXIS]
    O = problem.off_rank.shape[1]
    if O % n_offer:
        raise ValueError(f"offerings {O} not divisible by offer axis "
                         f"{n_offer}")
    grid = np.moveaxis(mesh.devices, [mesh.axis_names.index(FLEET_AXIS),
                                       mesh.axis_names.index(OFFER_AXIS)],
                       [0, 1])
    C = problem.num_clusters
    Cb = _blocks(C, grid.shape[0])
    O_l = O // n_offer

    def put(a, dev, lo, hi, olo=None, ohi=None, axis=None):
        blk = a[lo:hi]
        if axis is not None:
            blk = np.take(blk, np.arange(olo, ohi), axis=axis)
        return torch.from_numpy(np.ascontiguousarray(blk)).to(dev)

    rows = []
    for f in range(grid.shape[0]):
        lo, hi = f * Cb, (f + 1) * Cb
        slots = list(grid[f])
        args = [[put(a, d, lo, hi) for d in slots] for a in (
            problem.group_req.astype(np.int32),
            problem.group_count.astype(np.int32),
            problem.group_cap.astype(np.int32))]
        for a, axis in ((problem.compat.astype(bool), 2),
                        (problem.off_alloc.astype(np.int32), 1),
                        (problem.off_price.astype(np.float32), 1),
                        (problem.off_rank.astype(np.float32), 1)):
            args.append([put(a, d, lo, hi, w * O_l, (w + 1) * O_l, axis)
                         for w, d in enumerate(slots)])
        with on_slot(slots[0]):
            rows.append(sharded_solve_core(*args, num_nodes=num_nodes,
                                           right_size=right_size)[0])
    return tuple(np.concatenate([r[k].cpu().numpy() for r in rows])
                 for k in range(4))
