"""The decode choke point: host-side affinity enforcement on COO plans.

Port of ``karpenter_tpu/affinity/enforce.py``. Every plan of the port —
the affinity scan, or the FFD kernel route of a window over the class
budget — decodes through
``solver/encode.decode_plan_entries``, which routes COO entries through
:func:`enforce_affinity` whenever the problem carries the affinity plane
(the gang ``_enforce_gangs`` pattern, same tuple contract). Downstream
of this line an edge-violating placement is structurally impossible:
violating entries are dropped (their counts return to the per-group
unplaced tally, where the explain fold assigns the
``affinity_unsatisfied`` / ``spread_bound`` bits), bound excess is
clamped, and nodes emptied by a drop are closed with their price leaving
the plan.

Enforcement is a deterministic fixpoint: dropping a required-edge
target can strand its dependents, so passes repeat until stable
(bounded by the entry count — every pass that changes anything strictly
removes pods).  Order is canonical — nodes ascending, entries by
(group, entry) within a node, zones ascending — so reruns of the same
plan drop the same pods (the chaos digest-determinism contract).

Semantics per scope and kind (kube-faithful on the window):

- anti (both scopes): symmetric — a pod may not share the domain with
  any pod matching its anti selector, nor with a pod whose anti
  selector matches it.  A self-matching zone anti class ("one replica
  per zone") conflicts pods of the same group with each other.
- required (both scopes): each pod needs at least one OTHER matching
  pod co-resident in the domain (pods of the same entry count).
- hostname spread bounds: per node, per bounded class, matching pods
  are clamped to the bound; excess comes off the later entries.
- gang members are EXEMPT: gang atomicity supersedes affinity and
  spread at this choke (docs/design/gang.md).  The gang choke runs
  first in decode_plan_entries, so dropping a gang member here would
  reintroduce the partial gang it just made impossible — gang entries
  still occupy domain census and spread room (non-gang pods yield to
  them), but are never themselves dropped or clamped.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.affinity import AFF_BIG
from karpenter_tpu_torch.apis.pod import HOSTNAME_TOPOLOGY_KEY
from karpenter_tpu_torch.utils import metrics

# fixpoint guard: each productive pass removes >= 1 pod, so this only
# bounds adversarial plans
_MAX_PASSES = 64


def _anti_mats(aff):
    """(anti_node [G,G], anti_zone [G,G]) symmetric bool conflict
    matrices, diagonal included (self-matching anti classes conflict a
    group with itself)."""
    mem = aff.member.astype(np.int32)
    ah = (aff.anti_host.astype(np.int32) @ mem) > 0
    az = (aff.anti_zone.astype(np.int32) @ mem) > 0
    return ah | ah.T, az | az.T


def enforce_affinity(problem, node_off: np.ndarray, gis: np.ndarray,
                     ns: np.ndarray, cnts: np.ndarray, cost: float):
    """Returns ``(node_off, gis, ns, cnts, dropped_or_None, cost)`` —
    the ``_enforce_gangs`` contract.  ``dropped`` is ``(group indices,
    pod counts)`` ready for the caller's ``np.add.at`` unplaced tally.
    """
    aff = getattr(problem, "aff", None)
    if aff is None or gis.size == 0:
        return node_off, gis, ns, cnts, None, cost
    G = len(problem.groups)
    # gang atomicity supersedes the choke (see module docstring): gang
    # entries count toward census/room but are never dropped or clamped
    gang_g = np.asarray(problem.group_gang[:G]) >= 0
    anti_n, anti_z = _anti_mats(aff)
    member = aff.member                                     # [C, G]
    host_cls = [c for c in range(len(aff.classes))
                if aff.classes[c][1] == HOSTNAME_TOPOLOGY_KEY]
    bounded = [c for c in host_cls if aff.host_bound[c] < AFF_BIG]
    req_h = aff.req_host
    req_z = aff.req_zone
    has_req_h = req_h.any(axis=1)
    has_req_z = req_z.any(axis=1)
    off_zone = problem.catalog.off_zone

    g_l = gis.astype(np.int64).tolist()
    n_l = ns.astype(np.int64).tolist()
    c_l = cnts.astype(np.int64).tolist()
    E = len(g_l)
    alive = [True] * E
    drop_g: list[int] = []
    drop_c: list[int] = []
    spread_clamped = 0

    def _zone_of(n: int) -> int:
        return int(off_zone[int(node_off[n])])

    def _domains(by_zone: bool):
        """{domain key: [entry ids in canonical order]} over live
        entries."""
        doms: dict[int, list[int]] = {}
        for e in range(E):
            if alive[e]:
                doms.setdefault(_zone_of(n_l[e]) if by_zone else n_l[e],
                                []).append(e)
        for es in doms.values():
            es.sort(key=lambda e: (g_l[e], e))
        return dict(sorted(doms.items()))

    def _drop(e: int, pods: int) -> None:
        nonlocal spread_clamped
        drop_g.append(g_l[e])
        drop_c.append(pods)
        c_l[e] -= pods
        if c_l[e] <= 0:
            alive[e] = False

    for _ in range(_MAX_PASSES):
        changed = False
        # ---- anti + hostname spread bounds, per domain ---------------
        for by_zone, anti in ((False, anti_n), (True, anti_z)):
            for _dom, es in _domains(by_zone).items():
                kept: list[int] = []
                for e in es:
                    g = g_l[e]
                    if gang_g[g]:
                        kept.append(e)       # exempt, still in census
                        continue
                    if any(anti[g, g_l[k]] for k in kept):
                        _drop(e, c_l[e])
                        changed = True
                        continue
                    if anti[g, g] and c_l[e] > 1:
                        _drop(e, c_l[e] - 1)     # one survivor per domain
                        changed = True
                    kept.append(e)
                if not by_zone and bounded:
                    room = {c: int(aff.host_bound[c]) for c in bounded}
                    for e in kept:
                        if not alive[e]:
                            continue
                        for c in bounded:
                            if member[c, g_l[e]] and not gang_g[g_l[e]] \
                                    and c_l[e] > room[c]:
                                over = c_l[e] - max(room[c], 0)
                                _drop(e, over)
                                spread_clamped += over
                                changed = True
                            if member[c, g_l[e]]:
                                room[c] -= c_l[e]
        # ---- required edges, per domain ------------------------------
        for by_zone, req, has_req in ((False, req_h, has_req_h),
                                      (True, req_z, has_req_z)):
            if not has_req.any():
                continue
            for _dom, es in _domains(by_zone).items():
                # matching-pod totals per class in this domain
                tot: dict[int, int] = {}
                for e in es:
                    for c in np.nonzero(member[:, g_l[e]])[0].tolist():
                        tot[c] = tot.get(c, 0) + c_l[e]
                for e in es:
                    g = g_l[e]
                    if not has_req[g] or gang_g[g]:
                        continue
                    for c in np.nonzero(req[g])[0].tolist():
                        own = 1 if member[c, g] else 0
                        if tot.get(c, 0) - own < 1:
                            _drop(e, c_l[e])
                            changed = True
                            break
        if not changed:
            break

    if not drop_g:
        return node_off, gis, ns, cnts, None, cost
    if spread_clamped:
        metrics.AFFINITY_SPREAD_AVOIDED.inc(spread_clamped)
    keep = np.array(alive, dtype=bool)
    new_cnts = np.array(c_l, dtype=cnts.dtype)
    dropped = (np.array(drop_g, dtype=np.int64),
               np.array(drop_c, dtype=np.int64))
    dead = np.setdiff1d(np.unique(ns), np.unique(ns[keep]),
                        assume_unique=True)
    if dead.size:
        node_off = np.array(node_off, copy=True)
        cost = float(cost) - float(
            problem.catalog.off_price[node_off[dead]].sum())
        node_off[dead] = -1
    return (node_off, gis[keep], ns[keep], new_cnts[keep], dropped,
            cost)
