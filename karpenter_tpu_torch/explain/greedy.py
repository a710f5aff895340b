"""Host oracle for the device reason words.

``reason_words`` recomputes with numpy exactly the int32 per-group
reason bitmask the device reduction emits (``solver/packed.explain_words``)
from the same factored inputs the packed dispatch uploads.  The decode
fold (``explain/decode.attach``) falls back to it for groups the device
reported no evidence for.  Every formula — the deficit clip, the
first-index nearest-miss argmin, the placed-overlap test — mirrors the
device reduction; change one side, change both.

Stochastic windows add the overcommit_risk bit (from the scan's own fit
grids, run on the CPU) and affinity windows the affinity_unsatisfied /
spread_bound bits, as the reference oracle does.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.explain import (
    BIT, DEFICIT_CLIP, DEFICIT_MASKED, RESOURCE_BITS, RESOURCE_NAMES,
)


def label_rows_for(problem) -> np.ndarray:
    """bool [G, O] — the label rows the packed dispatch ships, gathered
    per group: the encoder's factoring when present, else the dedup of
    the dense compat (the same fallback ``TorchSolver`` takes)."""
    if problem.label_rows is not None and problem.label_idx is not None \
            and problem.label_rows.shape[0] > 0:
        return problem.label_rows[problem.label_idx].astype(bool)
    from karpenter_tpu_torch.solver.torch_backend import dedup_rows

    label_idx, rows = dedup_rows(problem.compat)
    if rows.shape[0] == 0:
        return np.zeros((problem.num_groups,
                         problem.catalog.num_offerings), dtype=bool)
    return rows[label_idx].astype(bool)


def nearest_miss_index(problem, lbl: np.ndarray | None = None) -> tuple:
    """(nearest int64 [G], deficit int64 [G, O]) — per group, the
    label-compatible offering minimizing the clipped total resource
    deficit (first index on ties), and the clipped deficit tensor."""
    catalog = problem.catalog
    if lbl is None:
        lbl = label_rows_for(problem)
    req = problem.group_req.astype(np.int64)                    # [G, R]
    alloc = catalog.offering_alloc().astype(np.int64)           # [O, R]
    per_dim = np.minimum(np.maximum(req[:, None, :] - alloc[None, :, :], 0),
                         DEFICIT_CLIP)                          # [G, O, R]
    deficit = per_dim.sum(axis=2)                               # [G, O]
    masked = np.where(lbl, deficit, DEFICIT_MASKED)
    nearest = masked.argmin(axis=1) if masked.shape[1] else \
        np.zeros(len(req), dtype=np.int64)
    return nearest, deficit


def reason_words(problem, unplaced: np.ndarray,
                 precomputed: tuple | None = None) -> np.ndarray:
    """int32 [G] reason words, bit-identical to the device reduction.

    ``unplaced`` is the per-group unplaced pod count of the solve whose
    words are reproduced.  ``precomputed`` is the ``(lbl, nearest,
    deficit)`` triple, so callers that also fold nearest-miss payloads
    build the [G, O] tensors once."""
    G = problem.num_groups
    catalog = problem.catalog
    O = catalog.num_offerings
    words = np.zeros(G, dtype=np.int32)
    if G == 0 or O == 0:
        if G and O == 0:
            un = np.asarray(unplaced[:G]) > 0
            words[un & (problem.group_count > 0)] = \
                np.int32(1 << BIT["requirements"])
        return words
    if precomputed is not None:
        lbl, nearest, _deficit = precomputed
    else:
        lbl = label_rows_for(problem)
        nearest, _deficit = nearest_miss_index(problem, lbl)
    req = problem.group_req.astype(np.int64)
    alloc = catalog.offering_alloc().astype(np.int64)
    fit = (alloc[None, :, :] >= req[:, None, :]).all(axis=2)    # [G, O]
    compat = lbl & fit
    count = problem.group_count.astype(np.int64)
    un = np.asarray(unplaced[:G], dtype=np.int64) > 0
    live = count > 0
    has_label = lbl.any(axis=1)
    has_fit = compat.any(axis=1)
    near_alloc = alloc[nearest]                                 # [G, R]
    insufficient = has_label & ~has_fit
    bits = np.zeros(G, dtype=np.int64)
    for r, bit_name in enumerate(RESOURCE_BITS):
        hit = insufficient & (req[:, r] > near_alloc[:, r])
        bits |= hit.astype(np.int64) << BIT[bit_name]
    bits |= (~has_label).astype(np.int64) << BIT["requirements"]
    bits |= has_fit.astype(np.int64) << BIT["capacity_exhausted"]
    # capacity consumed by strictly-higher-priority groups, in O(G*O):
    # per offering, the max priority among PLACED compatible groups
    placed = (count - np.minimum(np.asarray(unplaced[:G], dtype=np.int64),
                                 count)) > 0
    prio = problem.group_prio.astype(np.int64)
    max_placed_prio = np.where(compat & placed[:, None], prio[:, None],
                               np.iinfo(np.int64).min).max(axis=0)   # [O]
    cap_hp = (compat & (max_placed_prio[None, :] > prio[:, None])
              ).any(axis=1) & has_fit
    bits |= cap_hp.astype(np.int64) << BIT["capacity_higher_prio"]
    words[:] = np.where(un & live, bits, 0).astype(np.int32)
    if getattr(problem, "group_var", None) is not None:
        # the overcommit_risk bit, from the same fit grids the
        # stochastic scan computes (stochastic/kernel._risk_words)
        words |= _risk_words_host(problem, np.asarray(unplaced[:G]),
                                  compat)
    if getattr(problem, "aff", None) is not None:
        # the affinity bits of the affinity scan's fold
        # (affinity/kernel._affinity_words)
        aff = problem.aff
        live_un = live & un
        words |= np.where(live_un & (aff.aff_flag > 0),
                          np.int32(1 << BIT["affinity_unsatisfied"]),
                          np.int32(0)).astype(np.int32)
        words |= np.where(live_un & (aff.spread_flag > 0),
                          np.int32(1 << BIT["spread_bound"]),
                          np.int32(0)).astype(np.int32)
    return words


def _risk_words_host(problem, unplaced: np.ndarray,
                     compat: np.ndarray) -> np.ndarray:
    """int32 [G] overcommit_risk bits of a stochastic window: the
    scan's own grid functions run on CPU tensors."""
    import torch

    from karpenter_tpu_torch.stochastic import z_bp_for, zsq_value
    from karpenter_tpu_torch.stochastic.kernel import (
        _empty_fit_grids, _risk_words,
    )

    mean = torch.from_numpy(problem.group_mean.astype(np.int32))
    var = torch.from_numpy(problem.group_var.astype(np.int32))
    alloc = torch.from_numpy(
        problem.catalog.offering_alloc().astype(np.int32))
    kd, kc = _empty_fit_grids(mean, var, alloc,
                              zsq_value(z_bp_for(problem.overcommit_eps)))
    return _risk_words(
        var, torch.from_numpy(problem.group_count.astype(np.int64)),
        torch.from_numpy(np.asarray(unplaced, dtype=np.int64)),
        torch.from_numpy(compat), kd, kc).numpy()


def nearest_miss(problem, gi: int, precomputed: tuple | None = None
                 ) -> dict | None:
    """The "would fit if +X" payload for one group: the nearest-miss
    offering and its per-dimension deficits, and for a group flagged by
    affinity or spread whether it would fit without them.  None when the
    group has no label-compatible offering to be near."""
    if precomputed is not None:
        lbl, nearest, deficit = precomputed
    else:
        lbl = label_rows_for(problem)
        nearest, deficit = nearest_miss_index(problem, lbl)
    if gi >= len(lbl) or not lbl[gi].any():
        return None
    off = int(nearest[gi])
    catalog = problem.catalog
    itype, zone, captype = catalog.describe_offering(off)
    req = problem.group_req[gi].astype(np.int64)
    alloc = catalog.offering_alloc()[off].astype(np.int64)
    deficits = {name: int(max(req[r] - alloc[r], 0))
                for r, name in enumerate(RESOURCE_NAMES)
                if req[r] > alloc[r]}
    out = {
        "offering_index": off,
        "instance_type": itype,
        "zone": zone,
        "capacity_type": captype,
        "total_deficit": int(deficit[gi, off]),
        "deficits": deficits,
    }
    aff = getattr(problem, "aff", None)
    if aff is not None and gi < len(aff.aff_flag) \
            and (int(aff.aff_flag[gi]) or int(aff.spread_flag[gi])):
        # an affinity edge or a spread bound can mask the offering after
        # every resource check passes, so an empty deficit does not mean
        # the group would fit: the payload says which it is
        out["would_fit_absent_affinity"] = not deficits
    return out
