"""Batched preemption planner: one vectorized candidate grid per round
(port of ``karpenter_tpu/preempt/planner.py``).

Groups are visited in the encoded problem's order (priority DESC, then
dominant size: ``solver/encode.py``).  For each group, rounds repeat
until its pods are placed or nothing helps:

1. for every victim node, "evict the k cheapest victims" is evaluated
   for ALL k at once against the freed-capacity prefix tensors
   (``cap = resid + freed_prefix[k] - consumed``): one [Nn, K] grid;
2. each node's candidate is its CHEAPEST feasible k (the smallest
   eviction prefix that fits >= 1 pod); victims at or above the group's
   priority are never eligible (k stops below the node's first such
   victim, so no priority inversion can be written down);
3. candidates commit in ascending (eviction weight, -fit, node) order
   until the group is placed or the disruption budget runs out.  Weights
   are dense priority ranks, so evicting two prio-0 pods is cheaper than
   one prio-100 pod.

Evicting k=0 victims is a valid candidate: free capacity on existing
nodes is used before anything is evicted.

The grid step runs as int32 torch ops on the planner's device from
``_DEVICE_MIN_CELLS`` cells on (or forced with ``use_device="on"``), as
long as every tensor fits int32; otherwise the numpy grid is the route,
a rule of size and range, not a fallback.  Both are integer exact, so
the route never changes the plan.  A failure on the device raises.  The
greedy oracle (``preempt/greedy.py``) is ported; the reference's
degraded fallback onto it waits for ROADMAP queue 1 item 13.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.preempt.encode import VictimSet, group_node_compat
from karpenter_tpu_torch.preempt.types import (
    Eviction, PlannerOptions, PreemptionPlan,
)
from karpenter_tpu_torch.solver.encode import EncodedProblem

_FIT_BIG = np.int64(1) << 40
# below this grid size (nodes x prefix-k) the numpy grid is the route
_DEVICE_MIN_CELLS = 4096
_I32_MAX = int(np.iinfo(np.int32).max)


def fit_grid_torch(resid0, freed_prefix, consumed, req):
    """Pods of ``req`` that fit on each node after evicting its first k
    victims, int32 torch ops on the inputs' device: ``resid0`` [Nn, R],
    ``freed_prefix`` [Nn, K, R], ``consumed`` [Nn, R], ``req`` [R] ->
    [Nn, K] (floor division, a dimension with no request never binds)."""
    cap = resid0[:, None, :] + freed_prefix - consumed[:, None, :]
    per = torch.where(
        req[None, None, :] > 0,
        torch.div(cap, torch.clamp(req, min=1)[None, None, :],
                  rounding_mode="floor"),
        torch.full_like(cap, _I32_MAX))
    return torch.clamp(per.min(dim=2).values, min=0)


class PreemptionPlanner:
    """Pure function over (encoded pending problem, victim set); the
    grid's torch route runs on ``device`` (``"cuda"`` by default, which
    raises without a card; ``"cpu"`` for the plain route of the
    tests)."""

    def __init__(self, options: PlannerOptions | None = None,
                 device="cuda"):
        self.options = options or PlannerOptions()
        self.device = resolve_device(device)
        self.device_steps = 0           # grid steps taken by torch

    # -- grid step (the only route-switched code) --------------------------

    def _fit_grid(self, resid0, freed_prefix, consumed, req):
        Nn, K, _R = freed_prefix.shape
        use = self.options.use_device
        # int32 contract: a tensor past int32 would wrap on the device
        # and part from the numpy grid, so it takes the numpy route
        if use != "off" and (use == "on" or Nn * K >= _DEVICE_MIN_CELLS) \
                and all(np.abs(a).max(initial=0) < _I32_MAX
                        for a in (resid0, freed_prefix, consumed, req)):
            dev = self.device

            def put(a):
                return torch.from_numpy(
                    np.ascontiguousarray(a, dtype=np.int32)).to(dev)

            # a DeviceFaultError raises to the caller (the reference's numpy
            # grid after a fault is ROADMAP queue 1 item 13); the reference
            # notes no devtel here, the port notes the grid's shape
            get_devtel().note_dispatch(
                "preempt-grid", (Nn, K, _R),
                h2d_bytes=4 * int(resid0.size + freed_prefix.size
                                  + consumed.size + req.size),
                donated=False)
            with device_guard("preempt-grid",
                              devices=[device_id(dev)]) as guard:
                with get_profiler().sampled("preempt-grid") as probe:
                    out = fit_grid_torch(put(resid0), put(freed_prefix),
                                         put(consumed), put(req))
                    probe.dispatched(out)
                out = guard.fetch(out)
            get_devtel().note_d2h(int(out.nbytes))
            self.device_steps += 1
            return out.astype(np.int64)
        cap = resid0[:, None, :] + freed_prefix - consumed[:, None, :]
        per = np.where(req[None, None, :] > 0,
                       cap // np.maximum(req, 1)[None, None, :], _FIT_BIG)
        return np.clip(per.min(axis=2), 0, None)

    # -- the plan ----------------------------------------------------------

    def plan(self, problem: EncodedProblem, victims: VictimSet,
             compat: np.ndarray | None = None) -> PreemptionPlan:
        t0 = time.perf_counter()
        out = PreemptionPlan(backend="vector",
                             candidate_count=victims.num_victims)
        G, Nn = problem.num_groups, victims.num_nodes
        if G == 0 or Nn == 0:
            out.unplaced = [pn for g in problem.groups for pn in g.pod_names]
            out.plan_seconds = time.perf_counter() - t0
            return out
        if compat is None:
            compat = group_node_compat(problem, victims)

        # dense priority-rank weights (overflow-proof: raw priorities
        # span int32, ranks span the count of distinct values)
        real = victims.vict_prio[victims.vict_prio != np.iinfo(np.int32).max]
        ranks = np.unique(real)
        w = np.where(victims.vict_prio == np.iinfo(np.int32).max, 0,
                     np.searchsorted(ranks, victims.vict_prio) + 1)
        wsum = np.zeros((Nn, victims.vict_prio.shape[1] + 1), dtype=np.int64)
        np.cumsum(w, axis=1, out=wsum[:, 1:])

        freed_prefix = victims.freed_prefix              # [Nn, K, R]
        K = freed_prefix.shape[1]
        resid0 = victims.resid
        consumed = np.zeros_like(resid0)
        kstart = np.zeros(Nn, dtype=np.int64)
        budget = self.options.max_evictions \
            if self.options.max_evictions >= 0 else (1 << 60)
        krange = np.arange(K, dtype=np.int64)
        n_index = np.arange(Nn)

        for gi, group in enumerate(problem.groups):
            c = int(problem.group_count[gi])
            node_ok = compat[gi]
            if c == 0 or not node_ok.any():
                out.unplaced.extend(group.pod_names)
                continue
            p = int(problem.group_prio[gi])
            req = problem.group_req[gi].astype(np.int64)
            cap_per = int(problem.group_cap[gi])
            # victims eligible for THIS group: the sorted prefix strictly
            # below its priority (pads sit at int32 max, never counted)
            klim = (victims.vict_prio < p).sum(axis=1).astype(np.int64)
            placed_on = np.zeros(Nn, dtype=np.int64)
            cursor = 0
            while c > 0:
                fit = self._fit_grid(resid0, freed_prefix, consumed, req)
                # k == kstart evicts NOBODY, so it stays legal even when
                # earlier (higher-priority) groups already advanced the
                # node past this group's eligible prefix (klim < kstart)
                # — slack left after their placements is fair game
                feas = ((krange[None, :] >= kstart[:, None])
                        & (krange[None, :] <= np.maximum(klim,
                                                         kstart)[:, None])
                        & (krange[None, :] - kstart[:, None] <= budget)
                        & node_ok[:, None]
                        & (fit >= 1)
                        & (placed_on < cap_per)[:, None])
                has = feas.any(axis=1)
                if not has.any():
                    break
                kbest = np.argmax(feas, axis=1)          # first feasible k
                fitb = fit[n_index, kbest]
                cost = wsum[n_index, kbest] - wsum[n_index, kstart]
                cand = n_index[has]
                order = cand[np.lexsort((
                    -fitb[cand], cost[cand]))]           # stable: n asc last
                progressed = False
                for n in order.tolist():
                    if c <= 0:
                        break
                    k = int(kbest[n])
                    extra = k - int(kstart[n])
                    if extra > budget:
                        continue
                    take = min(int(fitb[n]), c, cap_per - int(placed_on[n]))
                    if take <= 0:
                        continue
                    for j in range(int(kstart[n]), k):
                        out.evictions.append(Eviction(
                            claim_name=victims.claim_names[n],
                            pod_key=victims.vict_keys[n][j],
                            victim_priority=int(victims.vict_prio[n, j]),
                            beneficiary_priority=p,
                            beneficiary=group.pod_names[0]))
                    out.eviction_weight += int(wsum[n, k] - wsum[n, kstart[n]])
                    budget -= extra
                    kstart[n] = k
                    consumed[n] += req * take
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
