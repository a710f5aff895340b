"""Host-side preemption encoding: cluster state -> victim tensors
(port of ``karpenter_tpu/preempt/encode.py``).

The placement solve answers "where do pending pods fit on NEW nodes";
the preemption planner answers "which already-placed, lower-priority
pods must move so existing nodes can host pending high-priority pods".
Its inputs are dense per-node tensors built from the cluster's claims,
their bound pods and the catalog:

- ``resid``          int64 [Nn, R]        residual allocatable per node
- ``vict_prio``      int32 [Nn, Vmax]     per-node victims, sorted
                                          (priority asc, size desc)
- ``freed_prefix``   int64 [Nn, Vmax+1, R] cumulative resources freed by
                                          evicting the first k victims

"Evict the k cheapest victims of node n" is one gather into the prefix,
so the feasibility of every (node, k) pair is one batched grid.

Group-to-node compatibility ignores offering availability: a
blacked-out offering only blocks creates; the node exists and remains a
preemption target.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.apis.pod import (
    NUM_RESOURCES, pod_key, tolerates_all,
)
from karpenter_tpu_torch.apis.requirements import (
    LABEL_ARCH, LABEL_CAPACITY_TYPE, LABEL_INSTANCE_FAMILY,
    LABEL_INSTANCE_SIZE, LABEL_INSTANCE_TYPE, LABEL_ZONE,
)
from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES, CatalogArrays
from karpenter_tpu_torch.solver.encode import EncodedProblem, _allowed_mask

# vict_prio padding: above every parseable priority (PRIORITY_MAX is
# 1e9 < 2**31-1), so "victims with priority < p" never counts padding
PRIO_PAD = np.iinfo(np.int32).max


@dataclass
class VictimSet:
    """Dense per-node eviction-candidate tensors (see module docstring)."""

    claim_names: list[str]                       # [Nn] deterministic order
    claims: list = field(default_factory=list)   # [Nn] NodeClaim objects
    node_off: np.ndarray = None                  # int32 [Nn] offering index
    resid: np.ndarray = None                     # int64 [Nn, R]
    vict_keys: list[list[str]] = field(default_factory=list)
    vict_prio: np.ndarray = None                 # int32 [Nn, Vmax]
    vict_count: np.ndarray = None                # int32 [Nn]
    freed_prefix: np.ndarray = None              # int64 [Nn, Vmax+1, R]

    @property
    def num_nodes(self) -> int:
        return len(self.claim_names)

    @property
    def num_victims(self) -> int:
        return int(self.vict_count.sum()) if self.vict_count is not None \
            else 0


def _pod_req_vec(spec) -> np.ndarray:
    req = spec.requests.as_tuple()
    return np.array((req[0], req[1], req[2], max(req[3], 1)), dtype=np.int64)


def occupancy_index(cluster) -> dict[str, list]:
    """{node-or-claim name -> [PendingPod]} in ONE pass over the pod
    collection — encode_victims and the validator look up occupants per
    claim, and a per-claim linear scan is O(claims x pods) (30M python
    iterations at 10k pending x 2000 claims)."""
    idx: dict[str, list] = {}
    for p in cluster.list("pods"):
        b, n = p.bound_node, p.nominated_node
        if b:
            idx.setdefault(b, []).append(p)
        if n and n != b:
            idx.setdefault(n, []).append(p)
    return idx


def claim_pods(cluster, claim, index: dict[str, list] | None = None) -> list:
    """PendingPod records currently occupying ``claim``'s node: bound to
    the node OR nominated onto the claim (a nomination holds capacity the
    moment the provisioner stamps it, exactly like the disruption
    plane's accounting).  Pass a shared :func:`occupancy_index` when
    looking up many claims."""
    idx = index if index is not None else occupancy_index(cluster)
    seen: set[str] = set()
    out: list = []
    for name in (claim.node_name, claim.name):
        if not name:
            continue
        for p in idx.get(name, ()):
            key = pod_key(p.spec)
            if key not in seen:
                seen.add(key)
                out.append(p)
    return out


def encode_victims(cluster, catalog: CatalogArrays, claims=None,
                   occupancy: dict[str, list] | None = None) -> VictimSet:
    """Build the victim tensors from live claims (or an explicit subset —
    the controller passes one NodePool's claims so budgets stay
    per-pool).  Node order is the CALLER's order (cluster insertion
    order — the k8s list-order analogue): claim names carry random
    uuid hex, so sorting by name would make tie-breaks run-random and
    break determinism; insertion order means ties preempt the
    oldest claim first.  Victims within a node are ordered
    cheapest-first: priority ascending, then dominant size DESCENDING
    (fewest evictions for the capacity freed), then pod key — the
    canonical order both planner paths and the validator agree on."""
    if claims is None:
        claims = [c for c in cluster.nodeclaims()
                  if not c.deleted and c.launched]
    live = []
    for c in claims:
        if c.deleted or not c.launched:
            continue
        off = catalog.find_offering(c.instance_type, c.zone, c.capacity_type)
        if off is None:
            continue   # offering left the catalog: not a target we can size
        live.append((c, off))

    Nn = len(live)
    if occupancy is None:
        occupancy = occupancy_index(cluster)
    alloc = catalog.offering_alloc().astype(np.int64)
    resid = np.zeros((Nn, NUM_RESOURCES), dtype=np.int64)
    node_off = np.zeros(Nn, dtype=np.int32)
    claim_names: list[str] = []
    claim_objs: list = []
    vict_keys: list[list[str]] = []
    per_node: list[list[tuple]] = []
    for ni, (c, off) in enumerate(live):
        node_off[ni] = off
        resid[ni] = alloc[off]
        claim_names.append(c.name)
        claim_objs.append(c)
        rows = []
        for p in claim_pods(cluster, c, index=occupancy):
            req = _pod_req_vec(p.spec)
            resid[ni] -= req
            rows.append((int(p.spec.priority),
                         tuple(int(-v) for v in req),   # size DESC
                         pod_key(p.spec), req))
        rows.sort(key=lambda r: (r[0], r[1], r[2]))
        per_node.append(rows)

    Vmax = max((len(r) for r in per_node), default=0)
    vict_prio = np.full((Nn, Vmax), PRIO_PAD, dtype=np.int32)
    vict_count = np.zeros(Nn, dtype=np.int32)
    freed = np.zeros((Nn, Vmax, NUM_RESOURCES), dtype=np.int64)
    for ni, rows in enumerate(per_node):
        vict_count[ni] = len(rows)
        keys = []
        for j, (prio, _negreq, key, req) in enumerate(rows):
            vict_prio[ni, j] = prio
            freed[ni, j] = req
            keys.append(key)
        vict_keys.append(keys)
    freed_prefix = np.zeros((Nn, Vmax + 1, NUM_RESOURCES), dtype=np.int64)
    np.cumsum(freed, axis=1, out=freed_prefix[:, 1:, :])
    return VictimSet(claim_names=claim_names, claims=claim_objs,
                     node_off=node_off, resid=resid, vict_keys=vict_keys,
                     vict_prio=vict_prio, vict_count=vict_count,
                     freed_prefix=freed_prefix)


def _label_row_no_avail(reqs, pinned_zone: str | None,
                        catalog: CatalogArrays, cache: dict) -> np.ndarray:
    """bool [O]: label feasibility of a group WITHOUT the availability
    term (encode's ``_label_compat`` masks blacked-out offerings because
    they can't be *created*; an existing node's offering stays a valid
    preemption target)."""
    mask = _allowed_mask(reqs, LABEL_INSTANCE_TYPE, catalog.type_names,
                         cache)[catalog.off_type]
    mask = mask & _allowed_mask(reqs, LABEL_ARCH, catalog.archs,
                                cache)[catalog.type_arch[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_INSTANCE_FAMILY, catalog.families,
                          cache)[catalog.type_family[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_INSTANCE_SIZE, catalog.sizes,
                          cache)[catalog.type_size[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_CAPACITY_TYPE, list(CAPACITY_TYPES),
                          cache)[catalog.off_cap]
    zone_mask = _allowed_mask(reqs, LABEL_ZONE, catalog.zones, cache).copy()
    if pinned_zone is not None:
        zone_mask &= np.array([z == pinned_zone for z in catalog.zones])
    return mask & zone_mask[catalog.off_zone]


def group_node_compat(problem: EncodedProblem,
                      victims: VictimSet) -> np.ndarray:
    """bool [G, Nn]: may group g's pods land on victim node n —
    requirements vs the node's offering labels (availability ignored)
    plus the claim's taints."""
    G, Nn = problem.num_groups, victims.num_nodes
    out = np.zeros((G, Nn), dtype=bool)
    if G == 0 or Nn == 0:
        return out
    catalog = problem.catalog
    cache: dict = {}
    # claims sharing a taint tuple share one toleration verdict per group
    taint_sets: dict[tuple, np.ndarray] = {}
    for ni, c in enumerate(victims.claims):
        taint_sets.setdefault(tuple(c.taints), np.zeros(Nn, bool))[ni] = True
    for gi, group in enumerate(problem.groups):
        row = _label_row_no_avail(group.requirements, group.pinned_zone,
                                  catalog, cache)
        ok = row[victims.node_off]
        rep = group.representative
        for taints, nmask in taint_sets.items():
            if taints and not tolerates_all(rep.tolerations, taints):
                ok = ok & ~nmask
        out[gi] = ok
    return out
