"""Batched atomic gang placement: one vectorized grid per step (port of
``karpenter_tpu/gang/planner.py``).

Gangs are visited in the encoded problem's order (priority DESC, chips
DESC, size DESC: ``gang/encode.py``).  For each gang:

1. **Open-node scan** — for every node the plan has opened, "host this
   whole gang" is evaluated at once over the ``[nodes, placements]``
   grid: the gang's slice fits iff some valid placement bitmask is
   chip-disjoint from the node's occupancy (``(mask & occ) == 0``), the
   node's offering is label-compatible, and the residual capacity
   covers the TOTAL member demand.  The oldest fitting node wins; among
   its free placements the one minimizing (rank-assignment max hop,
   placement index) is taken.
2. **New node** — otherwise the cheapest offering (price rank, ties by
   index) whose ``compat`` row admits the gang is opened; the gang
   takes that offering's best placement.
3. Otherwise the gang is **unplaced whole**: every member stays
   pending.  Members are only ever committed as one assignment row.

The grid step runs as torch ops on the planner's device (two int32 words
per chip bitmask) from ``_DEVICE_MIN_CELLS`` cells on, or when forced
with ``use_device="on"``; below that size the numpy grid is the route.
Both are integer/bool exact, so the route never changes the plan.  A
failure on the device raises; ``gang/degraded.ResilientGangPlanner``
degrades it onto the greedy oracle (``gang/greedy.py``) for a planner
on the CPU, and raises it for one on the card.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.gang.encode import GangProblem
from karpenter_tpu_torch.gang.topology import (
    best_placement, rank_assignment, split_mask_words,
)
from karpenter_tpu_torch.gang.types import (
    GangAssignment, GangNode, GangOptions, GangPlan,
)

# below this grid size (nodes x placements) the numpy grid is the route
_DEVICE_MIN_CELLS = 2048
_NO_PLACEMENT = 2 ** 30


def free_grid_torch(occ_lo, occ_hi, m_lo, m_hi, valid, resid, need,
                    label_ok, hops):
    """The [Nn, P] slice-fit grid as torch ops on the inputs' device:
    int32 mask words, ``valid`` bool [Nn, P], ``resid`` int32 [Nn, R],
    ``need`` int32 [R], ``label_ok`` bool [Nn], ``hops`` int32 [Nn, P]
    -> (fits bool [Nn], best free placement int32 [Nn], -1 = none)."""
    # chip-disjointness decomposes exactly over the two 32-bit mask
    # words: (mask & occ) == 0  <=>  both words AND to zero
    disjoint = ((m_lo & occ_lo[:, None]) | (m_hi & occ_hi[:, None])) == 0
    free = valid & disjoint                                    # [Nn, P]
    cap_ok = (resid >= need[None, :]).all(dim=1)               # [Nn]
    fits = label_ok & cap_ok & free.any(dim=1)
    P = valid.shape[1]
    idx = torch.arange(P, dtype=torch.int32, device=valid.device)[None, :]
    score = torch.where(free, hops * (P + 1) + idx,
                        torch.full_like(hops, _NO_PLACEMENT))
    first = torch.where(fits, torch.argmin(score, dim=1).to(torch.int32),
                        -1)
    return fits, first.to(torch.int32)


class GangPlanner:
    """Pure function over an encoded gang problem; the grid's torch
    route runs on ``device`` (``"cuda"`` by default, which raises
    without a card; ``"cpu"`` for the plain route of the tests)."""

    def __init__(self, options: GangOptions | None = None, device="cuda"):
        self.options = options or GangOptions()
        self.device = resolve_device(device)
        self.device_steps = 0           # grid steps taken by torch

    # -- grid step (the only route-switched code) --------------------------

    def _free_grid(self, occ, masks, valid, resid, need, label_ok, hops):
        """(fits bool [Nn], best free placement int [Nn]; -1 = none) —
        "best" minimizes (rank-assignment max hop, placement index)."""
        Nn, P = valid.shape
        use = self.options.use_device
        if use != "off" and (use == "on" or Nn * P >= _DEVICE_MIN_CELLS):
            occ_lo, occ_hi = split_mask_words(occ)
            m_lo, m_hi = split_mask_words(masks)
            dev = self.device

            def put(a, dtype):
                return torch.from_numpy(
                    np.ascontiguousarray(a, dtype=dtype)).to(dev)

            # a DeviceFaultError raises to the caller, whose Resilient*
            # wrapper degrades a plan on the CPU loudly and raises one on
            # the card (the reference's silent numpy grid after a fault is
            # not carried over, ROADMAP.md);
            # the reference notes no devtel here, the port notes the
            # grid's shape
            get_devtel().note_dispatch(
                "gang-grid", (Nn, P, resid.shape[1]),
                h2d_bytes=int(occ.nbytes + masks.nbytes + valid.nbytes
                              + resid.nbytes + need.nbytes
                              + label_ok.nbytes + hops.nbytes),
                donated=False)
            with device_guard("gang-grid",
                              devices=[device_id(dev)]) as guard:
                with get_profiler().sampled("gang-grid") as probe:
                    fits, first = free_grid_torch(
                        put(occ_lo, np.int32), put(occ_hi, np.int32),
                        put(m_lo, np.int32), put(m_hi, np.int32),
                        put(valid, np.bool_), put(resid, np.int32),
                        put(need, np.int32), put(label_ok, np.bool_),
                        put(hops, np.int32))
                    probe.dispatched((fits, first))
                fits, first = guard.fetch((fits, first))
            get_devtel().note_d2h(int(fits.nbytes + first.nbytes))
            self.device_steps += 1
            return fits, first.astype(np.int64)
        free = valid & ((masks & occ[:, None]) == 0)
        cap_ok = (resid >= need[None, :]).all(axis=1)
        fits = label_ok & cap_ok & free.any(axis=1)
        score = np.where(free,
                         hops.astype(np.int64) * (P + 1)
                         + np.arange(P, dtype=np.int64)[None, :],
                         _NO_PLACEMENT)
        first = np.where(fits, np.argmin(score, axis=1), -1)
        return fits, first.astype(np.int64)

    # -- the plan ----------------------------------------------------------

    def plan(self, problem: GangProblem) -> GangPlan:
        t0 = time.perf_counter()
        out = GangPlan(backend="vector")
        catalog = problem.catalog
        out.unplaced.extend(problem.rejected)
        if problem.num_gangs == 0:
            out.plan_seconds = time.perf_counter() - t0
            return out
        off_rank = catalog.offering_rank_price()
        off_alloc = catalog.offering_alloc().astype(np.int64)
        off_price = catalog.off_price

        node_off: list[int] = []
        node_occ: list[int] = []               # uint64 chip bitmask
        node_resid: list[np.ndarray] = []
        assignments: dict[int, list[GangAssignment]] = {}
        max_nodes = self.options.max_nodes

        def commit(gang, n: int, mask: int) -> None:
            out.placed_gangs.append(gang.name)
            for pn in gang.pod_names:
                out.placements[pn] = n
            chips, hop = rank_assignment(catalog, node_off[n], mask)
            assignments.setdefault(n, []).append(GangAssignment(
                gang=gang.name, placement_mask=mask,
                pod_names=tuple(gang.pod_names),
                rank_chips=chips, max_hop=hop))

        for gi, gang in enumerate(problem.gangs):
            size = int(problem.gang_size[gi])
            if size < int(problem.gang_min[gi]):
                # structural guard: a sub-min_member gang never places
                # (the controller parks these; reject if one leaks in)
                out.unplaced_gangs.append(gang.name)
                out.unplaced.extend(gang.pod_names)
                continue
            need = problem.gang_req[gi]
            table = problem.tables[gi]
            compat = problem.compat[gi]
            placed = False
            # 1. open nodes: one batched [nodes, placements] grid
            if node_off:
                offs = np.asarray(node_off, dtype=np.int64)
                occ = np.asarray(node_occ, dtype=np.uint64)
                resid = np.stack(node_resid)
                label_ok = compat[offs]
                if table is not None:
                    masks = table.masks[offs]
                    valid = table.valid[offs]
                    hops = table.hops[offs]
                else:
                    masks = np.zeros((len(offs), 1), dtype=np.uint64)
                    valid = np.ones((len(offs), 1), dtype=bool)
                    hops = np.zeros((len(offs), 1), dtype=np.int32)
                fits, first = self._free_grid(occ, masks, valid, resid,
                                              need, label_ok, hops)
                hit = np.nonzero(fits)[0]
                if hit.size:
                    n = int(hit[0])                   # oldest node first
                    p = int(first[n])
                    mask = int(masks[n, p]) if table is not None else 0
                    node_occ[n] = int(node_occ[n]) | mask
                    node_resid[n] = node_resid[n] - need
                    commit(gang, n, mask)
                    placed = True
            # 2. new node: cheapest compatible offering
            if not placed and compat.any() and len(node_off) < max_nodes:
                rank = np.where(compat, off_rank.astype(np.float64), np.inf)
                best = int(np.argmin(rank))           # first min: det. ties
                mask = int(table.masks[best, best_placement(table, best)]) \
                    if table is not None else 0
                node_off.append(best)
                node_occ.append(mask)
                node_resid.append(off_alloc[best] - need)
                commit(gang, len(node_off) - 1, mask)
                placed = True
            if not placed:
                out.unplaced_gangs.append(gang.name)
                out.unplaced.extend(gang.pod_names)

        total = 0.0
        for n, off in enumerate(node_off):
            itype, zone, captype = catalog.describe_offering(off)
            price = float(off_price[off])
            total += price
            out.nodes.append(GangNode(
                instance_type=itype, zone=zone, capacity_type=captype,
                price=price, offering_index=off,
                assignments=assignments.get(n, [])))
        out.total_cost_per_hour = total
        out.plan_seconds = time.perf_counter() - t0
        return out
