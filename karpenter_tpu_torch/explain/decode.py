"""Decode-side fold: per-group reason words -> per-pod canonical reasons.

The device's static bit is generic — it only sees the packed label row
(requirements, zone and availability folded into one mask).  Decode
refines it with the factors the host kept (each group's requirements
and pinned zone, the catalog availability mask) into the most specific
static cause:

    requirements   — the label requirements alone match no offering
    availability   — label matches exist, every one unavailable
    zone_affinity  — the zone requirement / pin eliminated them all
    zone_blackout  — zone candidates exist but are all blacked out

then folds the word through the most-specific-wins ladder and assigns
the reason to each unplaced pod (a group's unplaced pods are the tail
of its pod_names, as ``decode_plan_entries`` emits them).  Port of
``karpenter_tpu/explain/decode.py``; pure, it touches no registry.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.explain import BIT, fold_reason, word_for
from karpenter_tpu_torch.explain.greedy import (
    label_rows_for, nearest_miss, nearest_miss_index, reason_words,
)

_STATIC_BIT = 1 << BIT["requirements"]
_INSUFFICIENT_MASK = (1 << BIT["insufficient_cpu"]) \
    | (1 << BIT["insufficient_mem"]) \
    | (1 << BIT["insufficient_accel"]) \
    | (1 << BIT["insufficient_pods"])
_AFFINITY_MASK = (1 << BIT["affinity_unsatisfied"]) \
    | (1 << BIT["spread_bound"])


def refine_static(problem, gi: int, word: int) -> int:
    """Split the device's generic static bit into the most specific
    cause the encoder-side masks can prove.  Idempotent on words without
    the static bit."""
    if not word & _STATIC_BIT:
        return word
    g = problem.groups[gi]
    catalog = problem.catalog
    if g.requirements is None or catalog.num_offerings == 0:
        return word
    from karpenter_tpu_torch.apis.requirements import LABEL_ZONE
    from karpenter_tpu_torch.solver.encode import (
        _allowed_mask, _label_compat_noavail,
    )

    lbl_na = _label_compat_noavail(g.requirements, catalog)
    avail = catalog.off_avail
    zone_allowed = _allowed_mask(g.requirements, LABEL_ZONE,
                                 catalog.zones).copy()
    if g.pinned_zone is not None:
        zone_allowed &= np.array([z == g.pinned_zone
                                  for z in catalog.zones])
    zone = zone_allowed[catalog.off_zone]
    if not lbl_na.any():
        refined = "requirements"
    elif not (lbl_na & avail).any():
        refined = "availability"
    elif not (lbl_na & zone).any():
        refined = "zone_affinity"
    elif not (lbl_na & zone & avail).any():
        refined = "zone_blackout"
    else:
        refined = "requirements"
    return (word & ~_STATIC_BIT) | word_for(refined)


def overcommit_nearest(problem, gi: int) -> dict:
    """The "would fit at p99 variance X" payload for a group blocked by
    the chance constraint (stochastic plane): per dimension, the
    LARGEST per-pod variance at which one pod would still pass the
    quantile check on the group's best mean-fitting offering —
    ``X_r = ((alloc_r - mean_r) / z)^2`` — plus the buffer the group's
    ACTUAL variance demands (``z * sqrt(var)``)."""
    import math

    from karpenter_tpu_torch.apis.pod import RESOURCE_AXES
    from karpenter_tpu_torch.stochastic import z_value

    catalog = problem.catalog
    mean = problem.group_mean[gi].astype(np.int64)
    var = problem.group_var[gi].astype(np.int64)
    z = z_value(problem.overcommit_eps)
    alloc = catalog.offering_alloc().astype(np.int64)
    # best offering by mean headroom on variance-carrying dims
    fits = (alloc >= mean[None, :]).all(axis=1)
    slack = (alloc - mean[None, :]).clip(min=0).sum(axis=1)
    off = int(np.argmax(np.where(fits, slack, -1)))
    out = {"offering_index": off, "z": round(z, 4),
           "epsilon": problem.overcommit_eps, "buffer": {},
           "p99_fit_variance": {}}
    for r, axis in enumerate(RESOURCE_AXES):
        if var[r] <= 0:
            continue
        out["buffer"][axis] = round(z * math.sqrt(float(var[r])), 2)
        head = max(float(alloc[off, r] - mean[r]), 0.0)
        out["p99_fit_variance"][axis] = round((head / z) ** 2, 2) \
            if z > 0 else float("inf")
    return out


def group_miss_counts(problem, plan) -> np.ndarray:
    """int64 [G] unplaced-per-group derived from the plan's unplaced pod
    names — the fallback when the caller has no dense unplaced vector."""
    G = problem.num_groups
    miss = np.zeros(G, dtype=np.int64)
    if not plan.unplaced_pods:
        return miss
    owner: dict[str, int] = {}
    for gi, g in enumerate(problem.groups):
        for pn in g.pod_names:
            owner[pn] = gi
    for pn in plan.unplaced_pods:
        gi = owner.get(pn)
        if gi is not None:
            miss[gi] += 1
    return miss


def attach(problem, plan, reason_words_arr=None,
           miss: np.ndarray | None = None) -> None:
    """Populate ``plan.unplaced_reasons`` (pod key -> canonical reason),
    ``plan.unplaced_words`` (pod key -> raw bitmask) and
    ``plan.unplaced_nearest``.

    ``reason_words_arr`` is the device's [>=G] int32 word vector; groups
    the device reported no evidence for (word 0 with pods still
    unplaced, e.g. members a gang drop returned after the kernel ran)
    fall back to the host oracle, which recomputes from the decode-final
    unplaced counts."""
    if not plan.unplaced_pods:
        plan.unplaced_reasons = {}
        plan.unplaced_words = {}
        return
    t0 = obs.now()
    G = problem.num_groups
    if miss is None:
        miss = group_miss_counts(problem, plan)
    else:
        miss = np.asarray(miss[:G], dtype=np.int64)
    words = None
    if reason_words_arr is not None:
        words = np.asarray(reason_words_arr[:G], dtype=np.int64).copy()
    holes = np.nonzero(miss > 0)[0]
    # the [G,O] label/deficit tensors are built at most once per fold
    near_cache: list = []

    def near_pre() -> tuple:
        if not near_cache:
            lbl = label_rows_for(problem)
            near_cache.append((lbl,) + nearest_miss_index(problem, lbl))
        return near_cache[0]

    if words is None or (words[holes] == 0).any():
        oracle = reason_words(problem, miss, precomputed=near_pre())
        if words is None:
            words = oracle.astype(np.int64)
        else:
            fill = (words == 0) & (miss > 0)
            words[fill] = oracle[fill]
    reasons: dict[str, str] = {}
    raw: dict[str, int] = {}
    nearest: dict[str, dict] = {}
    for gi in holes.tolist():
        word = refine_static(problem, gi, int(words[gi]))
        reason = fold_reason(word)
        g = problem.groups[gi]
        m = int(miss[gi])
        near = None
        if word & (_INSUFFICIENT_MASK | _STATIC_BIT | _AFFINITY_MASK) \
                or reason in ("zone_affinity", "zone_blackout",
                              "availability", "requirements"):
            near = nearest_miss(problem, gi, precomputed=near_pre())
        if word & (1 << BIT["overcommit_risk"]):
            # "would fit at p99 variance X": the variance bound under
            # which the chance constraint would admit the pod on its
            # best mean-compatible offering
            near = dict(near or {})
            near["overcommit"] = overcommit_nearest(problem, gi)
        for pn in g.pod_names[len(g.pod_names) - m:]:
            reasons[pn] = reason
            raw[pn] = word
            if near is not None:
                nearest[pn] = near
    # pods the encoder rejected never reach the solve: pool taints or
    # statically-unsatisfiable requirements, recorded at rejection time
    rej = getattr(problem, "rejected_reasons", None) or {}
    for pn in problem.rejected:
        reason = rej.get(pn, "taints")
        reasons[pn] = reason
        raw[pn] = word_for(reason)
    plan.unplaced_reasons = reasons
    plan.unplaced_words = raw
    plan.unplaced_nearest = nearest
    obs.record("explain.fold", t0, obs.now(),
               unplaced=len(plan.unplaced_pods), groups=int(len(holes)))
