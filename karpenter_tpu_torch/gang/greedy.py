"""Host greedy gang planner: the parity oracle.

Port of ``karpenter_tpu/gang/greedy.py``.  Implements the exact
canonical algorithm of ``gang/planner.py`` (oldest-fitting-node first,
lowest free placement, cheapest new offering by (rank, index)) with
plain python loops: no numpy grids, no device.
``GreedyGangPlanner.plan`` must equal ``GangPlanner.plan`` on every
input.  The reference also routes single plans here when its batched
path fails (``gang/degraded.py``); the port has no such fallback.
"""

from __future__ import annotations

import time

from karpenter_tpu_torch.gang.encode import GangProblem
from karpenter_tpu_torch.gang.topology import best_placement, rank_assignment
from karpenter_tpu_torch.gang.types import GangAssignment, GangNode, GangOptions, GangPlan


class GreedyGangPlanner:
    def __init__(self, options: GangOptions | None = None):
        self.options = options or GangOptions()

    def plan(self, problem: GangProblem) -> GangPlan:
        t0 = time.perf_counter()
        out = GangPlan(backend="greedy")
        catalog = problem.catalog
        out.unplaced.extend(problem.rejected)
        if problem.num_gangs == 0:
            out.plan_seconds = time.perf_counter() - t0
            return out
        off_rank = catalog.offering_rank_price()
        off_alloc = catalog.offering_alloc()
        off_price = catalog.off_price
        R = problem.gang_req.shape[1]

        node_off: list[int] = []
        node_occ: list[int] = []
        node_resid: list[list[int]] = []
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
                out.unplaced_gangs.append(gang.name)
                out.unplaced.extend(gang.pod_names)
                continue
            need = [int(v) for v in problem.gang_req[gi]]
            table = problem.tables[gi]
            compat = problem.compat[gi]
            placed = False
            # 1. open nodes, oldest first; lowest free placement index
            for n in range(len(node_off)):
                o = node_off[n]
                if not compat[o]:
                    continue
                if any(node_resid[n][d] < need[d] for d in range(R)):
                    continue
                mask = -1
                if table is None:
                    mask = 0
                else:
                    # rank-aware pick: lowest (hop, index) free placement
                    # — the same scoring term the batched grid applies
                    row = table.masks[o]
                    hops = table.hops[o]
                    best_score = None
                    for p in range(int(table.count[o])):
                        if (int(row[p]) & node_occ[n]) == 0:
                            score = (int(hops[p]), p)
                            if best_score is None or score < best_score:
                                best_score = score
                                mask = int(row[p])
                if mask < 0:
                    continue
                node_occ[n] |= mask
                for d in range(R):
                    node_resid[n][d] -= need[d]
                commit(gang, n, mask)
                placed = True
                break
            # 2. new node: cheapest compatible offering (rank, index)
            if not placed and len(node_off) < max_nodes:
                best, best_rank = -1, None
                for o in range(catalog.num_offerings):
                    if not compat[o]:
                        continue
                    r = float(off_rank[o])
                    if best_rank is None or r < best_rank:
                        best, best_rank = o, r
                if best >= 0:
                    mask = int(table.masks[best, best_placement(table,
                                                                best)]) \
                        if table is not None else 0
                    node_off.append(best)
                    node_occ.append(mask)
                    node_resid.append([int(off_alloc[best, d]) - need[d]
                                       for d in range(R)])
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
