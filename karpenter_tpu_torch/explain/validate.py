"""Explain-consistency oracle: a reason must match ground truth.

Port of ``karpenter_tpu/explain/validate.py``.  The chaos harness re-derives, from the request alone (pods + catalog +
nodepool — the cluster-state snapshot the solve consumed), what every
unplaced pod's reason SHOULD be, and flags plans whose attached reasons
contradict it.  The classic lie this catches: a pod blamed on
"availability" while a feasible, available offering sits open in the
catalog — or the inverse, a pod blamed on capacity when no offering
could ever host it.

Checks per unplaced pod:

- a reason is PRESENT (an unplaced pod with no reason is itself a
  violation — the whole point of the subsystem);
- the reason is in the canonical allowlist (cardinality bound);
- static reasons (requirements/zone/availability/insufficient-*/taints)
  imply the pod is NOT statically placeable: no available offering
  passes its label+zone requirements and fits its requests on an empty
  node;
- capacity reasons (capacity_* / priority_starved / preemption_budget)
  and the gang verdicts imply the pod IS statically placeable — blaming
  capacity while nothing could ever fit is the inverse lie.

The reference's chaos harness drains its violations into the
``explain-consistent`` invariant; here ``chip_smoke.py`` and the tests
call it on the card's plans.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.explain import CANONICAL_REASONS

# reasons asserting the pod could NEVER place on this catalog snapshot
STATIC_REASONS = frozenset({
    "requirements", "taints", "zone_affinity", "zone_blackout",
    "availability", "insufficient_cpu", "insufficient_mem",
    "insufficient_accel", "insufficient_pods"})
# reasons asserting the pod COULD place, but something dynamic stopped it
DYNAMIC_REASONS = frozenset({
    "capacity_exhausted", "capacity_higher_prio", "priority_starved",
    "preemption_budget", "gang_parked", "gang_geometry",
    # the variance buffer blocks DENSITY, not static fit: the pod is
    # placeable alone on an empty node, so the reason is dynamic
    "overcommit_risk"})


def _statically_placeable_all(problem) -> np.ndarray:
    """bool [G] ground truth recomputed from the encoded problem: does
    ANY available offering pass each group's packed label row AND fit
    its request on an empty node?  (The row already folds requirements,
    zone, and availability — the same mask the solve consumed.)
    Computed ONCE per plan — the per-pod loop below only indexes it."""
    from karpenter_tpu_torch.explain.greedy import label_rows_for

    G = problem.num_groups
    catalog = problem.catalog
    if G == 0 or catalog.num_offerings == 0:
        return np.zeros(G, dtype=bool)
    lbl = label_rows_for(problem)
    fit = (catalog.offering_alloc().astype(np.int64)[None, :, :]
           >= problem.group_req.astype(np.int64)[:, None, :]).all(axis=2)
    return (lbl & fit & catalog.off_avail[None, :]).any(axis=1)


def check_plan_reasons(problem, plan) -> list[str]:
    """Violation strings for reasons inconsistent with ground truth
    (empty list = consistent)."""
    out: list[str] = []
    reasons = getattr(plan, "unplaced_reasons", None) or {}
    owner: dict[str, int] = {}
    for gi, g in enumerate(problem.groups):
        for pn in g.pod_names:
            owner[pn] = gi
    rejected = set(problem.rejected)
    placeable_all = _statically_placeable_all(problem)
    for pn in plan.unplaced_pods:
        reason = reasons.get(pn, "")
        if not reason:
            out.append(f"unplaced pod {pn} carries no reason")
            continue
        if reason not in CANONICAL_REASONS:
            out.append(f"pod {pn} reason {reason!r} outside the "
                       f"canonical allowlist")
            continue
        if pn in rejected:
            # encoder rejects are static by construction; any static
            # reason is consistent for them
            if reason not in STATIC_REASONS:
                out.append(f"encoder-rejected pod {pn} blamed on dynamic "
                           f"reason {reason!r}")
            continue
        gi = owner.get(pn)
        if gi is None:
            out.append(f"unplaced pod {pn} belongs to no group of its "
                       f"own solve window")
            continue
        placeable = bool(placeable_all[gi])
        if reason in STATIC_REASONS and placeable:
            out.append(
                f"pod {pn} blamed on static {reason!r} while a feasible "
                f"available offering exists in the catalog")
        elif reason in DYNAMIC_REASONS and not placeable:
            out.append(
                f"pod {pn} blamed on dynamic {reason!r} while NO "
                f"available offering could ever host it")
    return out
