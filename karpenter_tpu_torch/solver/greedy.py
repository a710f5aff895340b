"""Host greedy solver: the correctness/cost oracle and the CPU baseline.

Port of ``karpenter_tpu/solver/greedy.py``; the card never reaches it
(``make_solver`` returns it only for ``backend="greedy"``, and no solve
path degrades to it).  Semantics replicate the reference's provisioning path (the greedy
first-fit-decreasing over instance types that karpenter-core's
Scheduler.Solve performs per reconcile, consuming the compatibility filter
of cloudprovider.go:321-352 and the cost ranking of instancetype.go:88-110):

- pods are processed in the shared FFD order produced by ``encode`` (groups
  descending by dominant resource share);
- each pod first-fits onto an already-open node (oldest first) whose
  offering is compatible and has residual capacity;
- otherwise a new node is opened with the offering minimizing
  price / pods-that-fit (cost-per-pod on an empty node), ties broken by
  offering index.

Because pods within a group are identical, the implementation fills nodes a
group at a time (place min(fit, cap, remaining) pods on each open node in
age order, then open new nodes batch-filled to capacity) — bitwise
identical to per-pod first-fit, but O(G x N) instead of O(P x N).

The per-pod C++ twin (``csrc/ffd_host.cpp``, built by ``native.py``)
is the stand-in for karpenter-core's Go loop that the card's solve is
compared with (:func:`solve_per_pod_native`).
"""

from __future__ import annotations

import time

import numpy as np

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.solver.encode import EncodedProblem
from karpenter_tpu_torch.solver.types import (
    Plan, PlannedNode, SolveRequest, SolverOptions,
)
from karpenter_tpu_torch.utils import metrics


def expand_per_pod(problem: EncodedProblem):
    """Per-pod input arrays — signature compression UNDONE.

    One row per pod in the shared FFD order (groups are sorted descending
    by dominant size and pods within a group are identical, so repeating
    group rows reproduces the reference's per-pod sort exactly).  Feeding
    this to ``native.ffd_solve`` runs the loop shape karpenter-core's
    ``Scheduler.Solve`` actually executes per reconcile — for each pod,
    scan every offering for the cheapest fit and every open node for
    first-fit (SURVEY.md §3.2/§5.7: "O(pods x types) sequential Go") —
    which is the faithful host baseline for BASELINE.md's >=20x bar
    (VERDICT round 2: the grouped host FFD shares the encode's
    compression, so beating it 20x through a network link is structurally
    impossible and also not what BASELINE.json names).
    """
    order = np.repeat(np.arange(problem.num_groups), problem.group_count)
    preq = np.ascontiguousarray(problem.group_req[order])
    pcount = np.ones(len(order), dtype=np.int32)
    pcap = np.ascontiguousarray(problem.group_cap[order])
    pcompat = np.ascontiguousarray(problem.compat[order], dtype=np.uint8)
    # gid ties the per-node cap back to the ORIGINAL group: a per-pod row
    # holds one pod, so caps (hostname anti-affinity) must be accounted
    # across all rows of the group, exactly as the reference counts
    # existing same-group pods per node
    gid = np.ascontiguousarray(order, dtype=np.int32)
    return preq, pcount, pcap, pcompat, gid


def solve_per_pod_native(problem: EncodedProblem, expanded=None,
                         max_nodes: int = 16384):
    """Run the per-pod reference loop (C++, ``csrc/ffd_host.cpp``) on a
    per-pod expansion.  Returns (node_off, assign, unplaced, n_open) or
    None when the native library is unavailable.  ``expanded`` lets the
    caller hoist :func:`expand_per_pod` out of a timing loop.

    The node axis starts at the demand lower bound (the [P, N] assign
    output would be GBs at P=10k x N=16k) and escalates on overflow,
    mirroring every other backend."""
    from karpenter_tpu_torch import native
    from karpenter_tpu_torch.solver.encode import estimate_nodes
    from karpenter_tpu_torch.solver.types import NODE_BUCKETS

    preq, pcount, pcap, pcompat, gid = expanded or expand_per_pod(problem)
    catalog = problem.catalog
    off_alloc = catalog.offering_alloc().astype(np.int32)
    off_rank = catalog.offering_rank_price()
    N = estimate_nodes(problem, max_nodes, NODE_BUCKETS)
    while True:
        out = native.ffd_solve(preq, pcount, pcap, pcompat,
                               off_alloc, off_rank, N, gid=gid)
        if out is None:
            return None
        if out[3] < 0 and N < max_nodes:
            N = min(max_nodes, N * 4)
            continue
        return out


# shared zero-variance row for deterministic nodes (node_vars entries
# are REPLACED, never mutated, so one shared array is safe)
_NO_VAR = np.zeros(4, dtype=np.float64)


def _chance_cap(hi: int, resid: np.ndarray, var_sum: np.ndarray,
                mean: np.ndarray, var: np.ndarray, zsq) -> int:
    """Largest k <= hi passing the per-dimension quantile check for ONE
    node (``stochastic/`` semantics; the device twin is
    ``stochastic/kernel._chance_fit``)."""
    from karpenter_tpu_torch.stochastic import CHANCE_FIT_MAX
    from karpenter_tpu_torch.stochastic.greedy import chance_fit_np

    hi_a = np.asarray([min(int(hi), CHANCE_FIT_MAX)], dtype=np.int64)
    k = chance_fit_np(resid[None, :], var_sum[None, :].astype(np.float32),
                      mean, var.astype(np.float32), zsq, hi_a)
    return int(k[0])


def _chance_cap_empty(fit_empty: np.ndarray, off_alloc: np.ndarray,
                      mean: np.ndarray, var: np.ndarray, zsq) -> np.ndarray:
    """Chance-corrected empty-node fit over the offering axis."""
    from karpenter_tpu_torch.stochastic import CHANCE_FIT_MAX
    from karpenter_tpu_torch.stochastic.greedy import chance_fit_np

    hi = np.minimum(fit_empty, CHANCE_FIT_MAX).astype(np.int64)
    return chance_fit_np(off_alloc,
                         np.zeros_like(off_alloc, dtype=np.float32),
                         mean, var.astype(np.float32), zsq, hi)


class GreedySolver:
    """The host greedy oracle behind ``backend="greedy"``: the C++
    per-pod twin where the window allows it (``use_native``), else the
    grouped python loop; both give the same plan."""

    def __init__(self, options: SolverOptions | None = None):
        self.options = options or SolverOptions(backend="greedy")

    def solve(self, request: SolveRequest) -> Plan:
        from karpenter_tpu_torch.solver.zonesplit import (
            solve_with_zone_candidates,
        )

        t0 = time.perf_counter()
        with obs.span("solve", backend="greedy",
                      pods=len(request.pods)) as sp:
            # handles the zone_candidates gate internally
            plan = solve_with_zone_candidates(self, request)
            sp.set("nodes", len(plan.nodes))
            sp.set("unplaced", len(plan.unplaced_pods))
        plan.solve_seconds = time.perf_counter() - t0
        metrics.SOLVE_DURATION.labels("greedy").observe(plan.solve_seconds)
        metrics.SOLVE_PODS.labels("greedy").observe(len(request.pods))
        metrics.SOLVE_COST.labels("greedy").set(plan.total_cost_per_hour)
        return plan

    def solve_encoded(self, problem: EncodedProblem) -> Plan:
        if self.options.use_native != "off" \
                and problem.pref_rows is None \
                and problem.group_var is None \
                and problem.aff is None \
                and not problem.has_gangs:
            # the C++ twin has no preference-penalty ranking, no gang
            # transaction, and no affinity gates; those windows route
            # to the python oracle (a native partial gang or
            # edge-violating placement would only be stripped by the
            # decode choke point, wasting the opened nodes)
            plan = self._solve_native(problem)
            if plan is not None:
                return plan
        return self._solve_python(problem)

    def _solve_native(self, problem: EncodedProblem) -> Plan | None:
        """Per-pod FFD in C++ (``csrc/ffd_host.cpp``): the same plan as
        the python path; None when the library is unavailable."""
        from karpenter_tpu_torch import native
        from karpenter_tpu_torch.solver.encode import decode_plan

        if problem.num_groups == 0:
            plan = Plan(nodes=[], unplaced_pods=list(problem.rejected),
                        backend="greedy-native")
            if plan.unplaced_pods:
                from karpenter_tpu_torch.explain.decode import attach

                attach(problem, plan)
            return plan
        from karpenter_tpu_torch.solver.encode import estimate_nodes
        from karpenter_tpu_torch.solver.types import NODE_BUCKETS

        catalog = problem.catalog
        N = estimate_nodes(problem, self.options.max_nodes, NODE_BUCKETS)
        while True:
            out = native.ffd_solve(
                problem.group_req, problem.group_count, problem.group_cap,
                problem.compat, catalog.offering_alloc().astype(np.int32),
                catalog.offering_rank_price(), N)
            if out is None:
                return None
            node_off, assign, unplaced, n_open = out
            if n_open < 0 and N < self.options.max_nodes:
                N = min(self.options.max_nodes, N * 4)   # overflow: escalate
                continue
            break
        open_mask = node_off >= 0
        cost = float(catalog.off_price[node_off[open_mask]].sum())
        return decode_plan(problem, node_off, assign, unplaced, cost,
                           "greedy-native")

    def _solve_python(self, problem: EncodedProblem) -> Plan:
        catalog = problem.catalog
        off_alloc = catalog.offering_alloc().astype(np.int64)   # [O, R]
        off_price = catalog.off_price.astype(np.float64)
        off_rank = catalog.offering_rank_price().astype(np.float64)
        max_nodes = self.options.max_nodes

        # chance-constrained packing (stochastic/): when
        # the encoder attached usage tensors, capacity is consumed by
        # MEAN and every fit routes through the quantile check with the
        # node's accumulated variance — the host twin of the device
        # scan's semantics (no right-size pass here, same as ever)
        stochastic = problem.group_var is not None
        zsq = np.float32(0.0)
        if stochastic:
            from karpenter_tpu_torch.stochastic import z_bp_for, zsq_value

            zsq = np.float32(zsq_value(z_bp_for(problem.overcommit_eps)))

        node_offering: list[int] = []
        node_resid: list[np.ndarray] = []
        node_vars: list[np.ndarray] = []    # accumulated variance [R]
        node_pods: list[list[str]] = []

        unplaced: list[str] = list(problem.rejected)

        # gang transaction state: a gang group
        # places all-or-nothing — its placements are rolled back when
        # the group cannot fully place, and a multi-group gang that
        # fails in ANY group is stripped whole in the post-pass below
        gang_ids = problem.group_gang
        gang_total: dict[int, int] = {}
        gang_minm: dict[int, int] = {}
        if problem.has_gangs:
            for i in range(problem.num_groups):
                gid = int(gang_ids[i])
                if gid >= 0:
                    gang_total[gid] = gang_total.get(gid, 0) \
                        + int(problem.group_count[i])
                    gang_minm[gid] = max(gang_minm.get(gid, 0),
                                         int(problem.group_min[i]))
        failed_gangs: set[int] = set()

        # affinity gates (affinity/), mirroring the device
        # scan's per-node reductions: class-presence for required edges,
        # symmetric anti exclusion, bounded spread allowance.  Groups
        # arrive req_depth-sorted (encode's armed lexsort), so required
        # targets pack before their dependents.  The unarmed path below
        # is untouched — byte-identity for edge-free windows.
        aff = problem.aff
        if aff is not None:
            from karpenter_tpu_torch.affinity import AFF_BIG

            aff_member = aff.member.T.copy()        # [G, C_all] bool
            aff_req = aff.req_host                  # [G, C_all] bool
            aff_anti = aff.anti_host                # [G, C_all] bool
            aff_bound = aff.host_bound.astype(np.int64)   # [C_all]
            aff_bounded = aff_bound < AFF_BIG
            node_cls: list[np.ndarray] = []   # per node member count [C_all]
            node_anti: list[np.ndarray] = []  # per node accumulated anti

            def _aff_allow(gi: int, cnt: np.ndarray) -> int:
                """Max additional members of group gi a node with class
                counts ``cnt`` may take under the spread bounds."""
                mine = aff_member[gi] & aff_bounded
                if not mine.any():
                    return 1 << 40
                return int((aff_bound[mine] - cnt[mine]).min())

            def _aff_place(gi: int, ni: int, take: int) -> None:
                node_cls[ni] = node_cls[ni] + aff_member[gi] * take
                node_anti[ni] = node_anti[ni] | aff_anti[gi]

        for gi, group in enumerate(problem.groups):
            req = problem.group_req[gi].astype(np.int64)
            if stochastic:
                req = problem.group_mean[gi].astype(np.int64)
                gvar = problem.group_var[gi].astype(np.float64)
            cap = int(problem.group_cap[gi])
            compat = problem.compat[gi]
            gid = int(gang_ids[gi]) if problem.has_gangs else -1
            saved = None
            if gid >= 0:
                if gid in failed_gangs \
                        or gang_total[gid] < gang_minm[gid]:
                    failed_gangs.add(gid)
                    unplaced.extend(group.pod_names)
                    continue
                # shallow snapshots suffice: the placement loop REPLACES
                # node_resid / node_vars entries (never mutates in
                # place) and only ever extends node_pods, so rollback =
                # restore lists + truncate pod tails
                saved = (list(node_offering), list(node_resid),
                         [len(p) for p in node_pods], list(node_vars),
                         (list(node_cls), list(node_anti))
                         if aff is not None else None)
            # soft preferences: penalty-ranked pricing for the new-node
            # choice (same rank_g = rank * (1 + lambda * miss) blend the
            # device scan applies); real cost accounting untouched
            rank_g = off_rank
            if problem.pref_rows is not None \
                    and int(problem.pref_idx[gi]) >= 0:
                miss = problem.pref_rows[int(problem.pref_idx[gi])]
                lam = getattr(self.options, "preference_lambda", 0.15)
                rank_g = off_rank * (1.0 + lam * miss.astype(np.float64))
            remaining = list(group.pod_names)

            # fill open nodes in age order (first-fit)
            for ni in range(len(node_offering)):
                if not remaining:
                    break
                if not compat[node_offering[ni]]:
                    continue
                if aff is not None:
                    present = node_cls[ni] > 0
                    # symmetric anti: the node holds a class this group
                    # anti-selects, or a resident group anti-selects one
                    # of this group's classes
                    if (aff_anti[gi] & present).any() \
                            or (node_anti[ni] & aff_member[gi]).any():
                        continue
                    # required classes must already be present (the
                    # device scan's ok_req gate — own placement counts
                    # only on the node it opens)
                    if (aff_req[gi] & ~present).any():
                        continue
                resid = node_resid[ni]
                if req.max() > 0:
                    fit = int(np.min(np.where(req > 0, resid // np.maximum(req, 1),
                                              np.int64(1 << 40))))
                else:
                    fit = 1 << 40
                if stochastic:
                    fit = _chance_cap(fit, resid, node_vars[ni], req,
                                      gvar, zsq)
                take = min(fit, cap, len(remaining))
                if aff is not None:
                    take = min(take, _aff_allow(gi, node_cls[ni]))
                    # self-matching armed anti: one member per node
                    if (aff_anti[gi] & aff_member[gi]).any():
                        take = min(take, 1)
                if take <= 0:
                    continue
                node_resid[ni] = resid - req * take
                if stochastic:
                    node_vars[ni] = node_vars[ni] + gvar * take
                node_pods[ni].extend(remaining[:take])
                del remaining[:take]
                if aff is not None:
                    _aff_place(gi, ni, take)

            aff_can_open = True
            aff_node_cap = 1 << 40
            aff_extra = 0
            if aff is not None:
                # groups with a required edge INTO one of this group's
                # classes must co-locate here later — size the node for
                # that dependent closure, not just this batch (the fill
                # pass still enforces real capacity; a dependent that
                # does not fit stays honestly unplaced)
                dep = (aff_req & aff_member[gi][None, :]).any(axis=1)
                dep[gi] = False
                if dep.any():
                    aff_extra = int(np.asarray(problem.group_count)[dep].sum())
                # a group whose required classes its own members do not
                # cover can never open a node (the scan's can_open gate:
                # targets-first ordering makes its edges satisfiable
                # only by filling)
                aff_can_open = not (aff_req[gi] & ~aff_member[gi]).any()
                aff_node_cap = _aff_allow(
                    gi, np.zeros(aff_member.shape[1], dtype=np.int64))
                if (aff_anti[gi] & aff_member[gi]).any():
                    aff_node_cap = min(aff_node_cap, 1)
            if remaining and aff_can_open and aff_node_cap > 0:
                # open new nodes with the cheapest-per-pod offering; fit
                # is capped by the pods actually remaining so
                # cost-per-pod is judged on the pods a node will really
                # hold (karpenter sizes claims to their pod batch — a
                # huge node must not "win" for a tiny tail)
                fit_empty = np.where(
                    compat,
                    np.min(np.where(req[None, :] > 0,
                                    off_alloc // np.maximum(req[None, :], 1),
                                    np.int64(1 << 40)), axis=1),
                    0)
                if stochastic:
                    fit_empty = _chance_cap_empty(fit_empty, off_alloc,
                                                  req, gvar, zsq)
                fit_empty = np.minimum(
                    fit_empty,
                    min(cap, len(remaining) + aff_extra, aff_node_cap))
                with np.errstate(divide="ignore", invalid="ignore"):
                    cost_per_pod = np.where(fit_empty > 0,
                                            rank_g / fit_empty, np.inf)
                best_off = int(np.argmin(cost_per_pod))
                best_fit = int(fit_empty[best_off])
                if best_fit > 0:
                    while remaining and len(node_offering) < max_nodes:
                        take = min(best_fit, len(remaining))
                        node_offering.append(best_off)
                        node_resid.append(off_alloc[best_off] - req * take)
                        node_vars.append(gvar * take if stochastic
                                         else _NO_VAR)
                        node_pods.append(remaining[:take])
                        del remaining[:take]
                        if aff is not None:
                            node_cls.append(
                                aff_member[gi].astype(np.int64) * take)
                            node_anti.append(aff_anti[gi].copy())
            if gid >= 0 and remaining:
                # gang group could not fully place: roll the whole group
                # back — a partial gang must never survive the oracle
                node_offering[:] = saved[0]
                node_resid[:] = saved[1]
                node_vars[:] = saved[3]
                if aff is not None:
                    node_cls[:] = saved[4][0]
                    node_anti[:] = saved[4][1]
                del node_pods[len(saved[0]):]
                for i, n0 in enumerate(saved[2]):
                    del node_pods[i][n0:]
                failed_gangs.add(gid)
                unplaced.extend(group.pod_names)
            else:
                unplaced.extend(remaining)

        if failed_gangs:
            # a gang spanning several signature groups (heterogeneous
            # members) fails WHOLE: strip any sibling groups' placements
            # and close nodes the strip emptied
            doomed: dict[str, np.ndarray] = {}
            for i in range(problem.num_groups):
                if int(gang_ids[i]) in failed_gangs:
                    # stochastic windows packed by mean, so the strip
                    # returns MEAN capacity (variance is deliberately
                    # not restored — keeping the stripped pods' buffer
                    # only tightens the node, never violates it)
                    r = (problem.group_mean[i] if stochastic
                         else problem.group_req[i]).astype(np.int64)
                    for pn in problem.groups[i].pod_names:
                        doomed[pn] = r
            stripped = False
            for ni in range(len(node_offering)):
                if not any(pn in doomed for pn in node_pods[ni]):
                    continue
                kept = []
                for pn in node_pods[ni]:
                    if pn in doomed:
                        node_resid[ni] = node_resid[ni] + doomed[pn]
                        unplaced.append(pn)
                        stripped = True
                    else:
                        kept.append(pn)
                node_pods[ni] = kept
            if stripped:
                keep_idx = [ni for ni in range(len(node_offering))
                            if node_pods[ni]]
                node_offering = [node_offering[i] for i in keep_idx]
                node_resid = [node_resid[i] for i in keep_idx]
                node_pods = [node_pods[i] for i in keep_idx]

        if problem.aff is not None:
            # affinity windows decode through decode_plan_entries so
            # the affinity choke point (affinity/enforce.py) applies to
            # the greedy backend too; pod names re-derive correctly
            # because the loop above consumes each group's pod_names in
            # node-ascending order (the cursor contract).  The unarmed
            # path below stays byte-identical.
            from karpenter_tpu_torch.solver.encode import decode_plan_entries

            owner: dict[str, int] = {}
            for gi2, g2 in enumerate(problem.groups):
                for pn in g2.pod_names:
                    owner[pn] = gi2
            ent: dict[tuple[int, int], int] = {}
            for ni, pods in enumerate(node_pods):
                for pn in pods:
                    key = (owner[pn], ni)
                    ent[key] = ent.get(key, 0) + 1
            keys = sorted(ent)
            gis = np.array([k[0] for k in keys], dtype=np.int64)
            ns = np.array([k[1] for k in keys], dtype=np.int64)
            cnts = np.array([ent[k] for k in keys], dtype=np.int64)
            un = np.zeros(problem.num_groups, dtype=np.int64)
            for pn in unplaced:
                gi2 = owner.get(pn)
                if gi2 is not None:
                    un[gi2] += 1
            node_off_arr = np.asarray(node_offering, dtype=np.int64)
            total = 0.0
            for off in node_offering:
                total += float(off_price[off])
            return decode_plan_entries(problem, node_off_arr, gis, ns,
                                       cnts, un, total, "greedy")

        nodes = []
        total = 0.0
        for ni, off in enumerate(node_offering):
            itype, zone, captype = catalog.describe_offering(off)
            price = float(off_price[off])
            total += price
            nodes.append(PlannedNode(instance_type=itype, zone=zone,
                                     capacity_type=captype, price=price,
                                     pod_names=node_pods[ni], offering_index=off))
        plan = Plan(nodes=nodes, unplaced_pods=unplaced,
                    total_cost_per_hour=total, backend="greedy")
        if unplaced:
            # host-oracle explain fold: same words the device reduction
            # emits for this window (explain/greedy.py)
            from karpenter_tpu_torch.explain.decode import attach

            attach(problem, plan)
        return plan
