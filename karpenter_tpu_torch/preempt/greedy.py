"""Host greedy preemption planner: the parity oracle.

Port of ``karpenter_tpu/preempt/greedy.py``.  Implements the exact
canonical algorithm of ``preempt/planner.py`` (cheapest feasible
eviction prefix per node, rounds committed in ascending (weight, -fit,
node) order) with plain python loops: no numpy grids, no device.
``GreedyPreemptionPlanner.plan`` must equal ``PreemptionPlanner.plan``
on every input.  ``preempt/degraded.py`` also routes single plans here
when a batched planner on the CPU fails, as the reference's; a planner
on the card raises instead.
"""

from __future__ import annotations

import time

import numpy as np

from karpenter_tpu_torch.preempt.encode import PRIO_PAD, VictimSet, group_node_compat
from karpenter_tpu_torch.preempt.types import Eviction, PlannerOptions, PreemptionPlan
from karpenter_tpu_torch.solver.encode import EncodedProblem


class GreedyPreemptionPlanner:
    def __init__(self, options: PlannerOptions | None = None):
        self.options = options or PlannerOptions()

    def plan(self, problem: EncodedProblem, victims: VictimSet,
             compat: np.ndarray | None = None) -> PreemptionPlan:
        t0 = time.perf_counter()
        out = PreemptionPlan(backend="greedy",
                             candidate_count=victims.num_victims)
        G, Nn = problem.num_groups, victims.num_nodes
        if G == 0 or Nn == 0:
            out.unplaced = [pn for g in problem.groups for pn in g.pod_names]
            out.plan_seconds = time.perf_counter() - t0
            return out
        if compat is None:
            compat = group_node_compat(problem, victims)

        # identical rank weights to the vector path
        real = sorted({int(v) for row in victims.vict_prio for v in row
                       if int(v) != PRIO_PAD})
        rank = {p: i + 1 for i, p in enumerate(real)}
        Vc = [int(v) for v in victims.vict_count]
        wsum = [[0] for _ in range(Nn)]
        for n in range(Nn):
            for j in range(Vc[n]):
                wsum[n].append(wsum[n][-1]
                               + rank[int(victims.vict_prio[n, j])])
            wsum[n].extend([wsum[n][-1]]
                           * (victims.vict_prio.shape[1] + 1 - len(wsum[n])))

        R = victims.resid.shape[1]
        resid0 = [[int(v) for v in victims.resid[n]] for n in range(Nn)]
        freed = victims.freed_prefix
        consumed = [[0] * R for _ in range(Nn)]
        kstart = [0] * Nn
        budget = self.options.max_evictions \
            if self.options.max_evictions >= 0 else (1 << 60)

        for gi, group in enumerate(problem.groups):
            c = int(problem.group_count[gi])
            node_ok = compat[gi]
            if c == 0 or not node_ok.any():
                out.unplaced.extend(group.pod_names)
                continue
            p = int(problem.group_prio[gi])
            req = [int(v) for v in problem.group_req[gi]]
            cap_per = int(problem.group_cap[gi])
            klim = [sum(1 for j in range(Vc[n])
                        if int(victims.vict_prio[n, j]) < p)
                    for n in range(Nn)]
            placed_on = [0] * Nn
            cursor = 0
            while c > 0:
                cands = []   # (cost, -fit, n, k)
                for n in range(Nn):
                    if not node_ok[n] or placed_on[n] >= cap_per:
                        continue
                    # k == kstart (zero evictions) stays legal past this
                    # group's prefix — matches the vector path's
                    # max(klim, kstart) window
                    hi = max(kstart[n], min(klim[n], kstart[n] + budget))
                    for k in range(kstart[n], hi + 1):
                        fit = 1 << 40
                        for d in range(R):
                            if req[d] > 0:
                                cap = resid0[n][d] + int(freed[n, k, d]) \
                                    - consumed[n][d]
                                fit = min(fit, cap // req[d])
                        fit = max(fit, 0)
                        if fit >= 1:
                            cands.append((wsum[n][k] - wsum[n][kstart[n]],
                                          -fit, n, k))
                            break   # cheapest feasible prefix only
                if not cands:
                    break
                cands.sort()
                progressed = False
                for cost, negfit, n, k in cands:
                    if c <= 0:
                        break
                    extra = k - kstart[n]
                    if extra > budget:
                        continue
                    take = min(-negfit, c, cap_per - placed_on[n])
                    if take <= 0:
                        continue
                    for j in range(kstart[n], k):
                        out.evictions.append(Eviction(
                            claim_name=victims.claim_names[n],
                            pod_key=victims.vict_keys[n][j],
                            victim_priority=int(victims.vict_prio[n, j]),
                            beneficiary_priority=p,
                            beneficiary=group.pod_names[0]))
                    out.eviction_weight += cost
                    budget -= extra
                    kstart[n] = k
                    for d in range(R):
                        consumed[n][d] += req[d] * take
                    for pn in group.pod_names[cursor:cursor + take]:
                        out.placements[pn] = victims.claim_names[n]
                    cursor += take
                    placed_on[n] += take
                    c -= take
                    progressed = True
                if not progressed:
                    break
            if c:
                out.unplaced.extend(group.pod_names[cursor:])
        out.plan_seconds = time.perf_counter() - t0
        return out
