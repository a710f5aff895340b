"""Multi-zone candidate split for zone-affinity groups.

Port of ``karpenter_tpu/solver/zonesplit.py``.  The encoder pins a
zone-affinity (co-schedule) group to the zone with the most compatible
capacity; this refinement re-pins each such group to every other viable
zone, solves each candidate and keeps the cheapest plan that places at
least as many pods.  Groups are refined one at a time (greedy over
groups, exact over zones within a group), bounded by
``zone_candidate_solves``.  Each round's candidates are solved in one
``solve_encoded_batch`` call: one upload, one launch of the fleet FFD
kernel and one fetch per round, whatever the number of candidates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from karpenter_tpu_torch.apis.requirements import LABEL_ZONE
from karpenter_tpu_torch.solver.encode import (
    EncodedProblem, _allowed_mask, _fit_mask, _has_zone_affinity, encode,
    viable_zones,
)
from karpenter_tpu_torch.solver.types import Plan, SolveRequest
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("solver.zonesplit")


def affinity_candidates(problem: EncodedProblem
                        ) -> list[tuple[int, str, list[str]]]:
    """(group index, current pinned zone, viable zones) per zone-affinity
    group with a real choice (>1 viable zone)."""
    out = []
    for gi, g in enumerate(problem.groups):
        if g.spread_origin is not None or g.pinned_zone is None:
            continue
        rep = g.representative
        if not _has_zone_affinity(rep):
            continue
        zones = viable_zones(g.requirements, rep.requests.as_tuple(),
                             problem.catalog, nozone=g.nozone_mask)
        if len(zones) > 1:
            out.append((gi, g.pinned_zone, zones))
    return out


def _with_zone(problem: EncodedProblem, gi: int, zone: str
               ) -> EncodedProblem:
    """Candidate subproblem: the baseline with ONE group re-pinned.  Only
    that group's compat row changes (nozone_mask ∩ requirement zone mask ∩
    the new pin) — no re-grouping, no re-sort, no full re-encode; the FFD
    order is zone-independent, so the patched problem is exactly what
    encode() with the override would produce, ~O(O) instead of O(pods)."""
    catalog = problem.catalog
    g = problem.groups[gi]
    zone_mask = _allowed_mask(g.requirements, LABEL_ZONE, catalog.zones).copy()
    zone_mask &= np.array([z == zone for z in catalog.zones])
    row_label = (g.label_mask if g.label_mask is not None
                 else g.nozone_mask) & zone_mask[catalog.off_zone]
    compat = problem.compat.copy()
    # same label_row & fit(adjusted req) factoring as encode(), so host
    # compat and the device's recomputed compat stay bit-identical
    compat[gi] = row_label & _fit_mask(problem.group_req[gi], catalog)
    groups = list(problem.groups)
    groups[gi] = dataclasses.replace(g, pinned_zone=zone)
    # keep the device-path factoring in sync.  Reuse an identical existing
    # row if one exists; else overwrite the group's old slot when no other
    # group shares it; else append — chained refinements must not grow U
    # monotonically (a LABELROW_BUCKETS boundary crossing would force an
    # XLA recompile mid-refinement).
    label_rows, label_idx = problem.label_rows, problem.label_idx
    if label_rows is not None and g.label_mask is None:
        # no factored label mask to patch: drop the factoring so _prepare
        # falls back to dedup_rows(compat), which reflects the patched
        # row — keeping stale rows would rebuild compat WITHOUT the pin
        # on device
        label_rows = None
        label_idx = None
    elif label_rows is not None:
        label_idx = problem.label_idx.copy()
        hits = np.nonzero((label_rows == row_label[None, :]).all(axis=1))[0]
        old = label_idx[gi]
        if hits.size:
            label_idx[gi] = int(hits[0])
        elif int((label_idx == old).sum()) == 1:
            label_rows = label_rows.copy()
            label_rows[old] = row_label
        else:
            label_rows = np.concatenate([label_rows, row_label[None, :]])
            label_idx[gi] = label_rows.shape[0] - 1
    return problem.replace(groups=groups, compat=compat,
                           label_rows=label_rows, label_idx=label_idx)


def _wins(candidate: Plan, incumbent: Plan) -> bool:
    """Ordered win condition: placing MORE pods beats any cost; at equal
    placement, strictly lower cost wins."""
    if len(candidate.unplaced_pods) > len(incumbent.unplaced_pods):
        return False
    return (len(candidate.unplaced_pods) < len(incumbent.unplaced_pods)
            or candidate.total_cost_per_hour
            < incumbent.total_cost_per_hour - 1e-9)


def solve_with_zone_candidates(backend, request: SolveRequest) -> Plan:
    """Encode+solve with the v1 pin, then refine zone-affinity groups'
    zone choices against solved candidates.  ``backend`` is a solver
    exposing ``solve_encoded(problem) -> Plan`` and carrying ``options``
    (zone_candidates gate + zone_candidate_solves budget).

    Candidates are evaluated in batched rounds: every remaining (group,
    zone) candidate is solved against the current base in one
    ``solve_encoded_batch`` call where the backend has one
    (``TorchSolver``); a backend without it (the host greedy oracle)
    solves each candidate in turn inside the same rounds.  Each round
    fixes the single best improvement, then re-evaluates the remaining
    groups against the updated base.
    """
    problem = encode(request.pods, request.catalog, request.nodepool)
    plan = backend.solve_encoded(problem)
    opts = backend.options
    if opts.zone_candidates == "off":
        return plan
    candidates = affinity_candidates(problem)
    if not candidates:
        return plan

    budget = opts.zone_candidate_solves
    base = problem
    open_groups = {gi: (current, zones) for gi, current, zones in candidates}
    batch_solve = getattr(backend, "solve_encoded_batch", None)
    # the budget is charged per UNIQUE (group, zone) candidate, as the
    # reference charges it; re-evaluations of an already-seen candidate
    # against an updated base are free
    seen: set = set()
    while open_groups and (budget > 0 or seen):
        cand_keys: list[tuple[int, str]] = []
        for gi, (current, zones) in open_groups.items():
            cand_keys.extend((gi, z) for z in zones if z != current)
        fresh = [k for k in cand_keys if k not in seen]
        cand_keys = [k for k in cand_keys if k in seen] + fresh[:budget]
        budget -= len(fresh[:budget])
        seen.update(cand_keys)
        if not cand_keys:
            break
        probs = [_with_zone(base, gi, z) for gi, z in cand_keys]
        if batch_solve is not None:
            plans = batch_solve(probs)
        else:
            plans = [backend.solve_encoded(p) for p in probs]
        best_i: int | None = None
        for i, p in enumerate(plans):
            if _wins(p, plans[best_i] if best_i is not None else plan):
                best_i = i
        if best_i is None:
            break   # no candidate improves on the incumbent plan
        plan = plans[best_i]
        gi, zone = cand_keys[best_i]
        base = _with_zone(base, gi, zone)
        del open_groups[gi]   # the winning group's pin is fixed
        log.info("zone-affinity candidate won", zone=zone,
                 cost=round(plan.total_cost_per_hour, 4),
                 unplaced=len(plan.unplaced_pods))
    if open_groups and budget <= 0:
        log.warning("zone-candidate budget exhausted; remaining affinity "
                    "groups keep the capacity-heuristic pin",
                    remaining=len(open_groups))
    return plan
