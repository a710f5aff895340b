"""Host-side repack encoding: the live fleet as dense migration tensors
(port of ``karpenter_tpu/repack/encode.py``).

The repack planner answers "which existing nodes can be emptied so the
fleet shrinks (consolidation), and which accelerator nodes can shed their
chip-consuming singletons so a parked gang's contiguous slice reopens
(defragmentation)".  Its inputs are dense per-node tensors built from
ground truth (cluster claims + bound pods + catalog arrays) or, with a
``ResidentStore``, read off its resident occupancy rows:

- ``resid``       int64 [Nn, R]   residual allocatable per node (from
                                  ``ResidentStore.occupancy_tensors``
                                  when a store is given);
- ``maxpod``      int64 [Nn, R]   componentwise max pod request per node;
- ``sing_*``                      the defrag-movable singletons' share of
                                  the same quantities;
- ``occ_mask`` / ``sing_mask``    uint64 chip bitmasks per node under the
                                  canonical chip model below.

**Canonical chip model** (shared by both planner routes and the
validator): chips of an accelerator node are assigned from its occupant
list, placed gangs first (in first-appearance order), each taking the
lowest ``enumerate_placements`` mask disjoint from chips already
assigned; then every other accelerator-consuming pod, in occupant order,
takes its ``gpu``-count lowest free chips.  Gang members are never
movable; hostname-anti-affinity pods are conservatively immovable.

Group->node compatibility ignores offering availability: the target node
already exists.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import NUM_RESOURCES, pod_key, tolerates_all
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.gang.topology import (
    SliceTable, enumerate_placements, slice_table,
)
from karpenter_tpu_torch.preempt.encode import (
    _label_row_no_avail, _pod_req_vec, claim_pods, occupancy_index,
)
from karpenter_tpu_torch.solver.encode import (
    _has_hostname_anti_affinity, _has_zone_affinity, _zone_spread_constraints,
)


@dataclass(slots=True)
class PodRef:
    """One occupant pod's host-side record, in canonical move order."""

    key: str
    req: np.ndarray              # int64 [R]
    sig: int                     # index into sig_rows / sig_zone_pinned
    gpu: int
    movable: bool
    single: bool                 # defrag-movable chip consumer
    chip_mask: int = 0           # chips under the canonical model


@dataclass
class RepackProblem:
    """Dense consolidation/defrag input (see module docstring)."""

    claim_names: list[str]
    claims: list = field(default_factory=list)
    node_off: np.ndarray = None        # int32 [Nn]
    node_zone: np.ndarray = None       # int32 [Nn] catalog zone index
    resid: np.ndarray = None           # int64 [Nn, R]
    pod_count: np.ndarray = None       # int32 [Nn]
    # initialized, node-backed claims only: a launched-but-unready node
    # is neither a source (its pods are nominations in flight) nor a
    # target (unproven capacity) — but it stays a ROW so the node set
    # matches the resident occupancy tensor word-for-word
    eligible: np.ndarray = None        # bool [Nn]
    price_milli: np.ndarray = None     # int64 [Nn] claim $/h * 1000
    n_chips: np.ndarray = None         # int32 [Nn] torus chip count
    pods: list[list[PodRef]] = field(default_factory=list)
    movable_all: np.ndarray = None     # bool [Nn]
    maxpod: np.ndarray = None          # int64 [Nn, R]
    sing_demand: np.ndarray = None     # int64 [Nn, R]
    sing_max: np.ndarray = None        # int64 [Nn, R]
    sing_count: np.ndarray = None      # int32 [Nn]
    occ_mask: np.ndarray = None        # uint64 [Nn]
    sing_mask: np.ndarray = None       # uint64 [Nn]
    sig_rows: np.ndarray = None        # bool [Nsig, O]
    sig_zone_pinned: np.ndarray = None  # bool [Nsig]
    taint_ok: np.ndarray = None        # bool [Nsig, Nn]
    parked_shapes: list[tuple[int, ...]] = field(default_factory=list)
    tables: list[SliceTable] = field(default_factory=list)
    catalog: CatalogArrays = None
    # resident occupancy handoff: the delta-maintained device rows (the
    # torch grid reads these directly) + their host mirror; None when the
    # problem was encoded from a fresh ClusterState scan
    rows_dev: object = None
    rows_host: np.ndarray | None = None

    @property
    def num_nodes(self) -> int:
        return len(self.claim_names)


def lowest_free_chips(occ: int, n_chips: int, count: int) -> int:
    """The ``count`` lowest free chip bits under occupancy ``occ`` on an
    ``n_chips`` torus (clipped to availability) — THE deterministic chip
    assignment every path shares."""
    mask = 0
    taken = 0
    for c in range(n_chips):
        if taken >= count:
            break
        bit = 1 << c
        if not occ & bit:
            mask |= bit
            taken += 1
    return mask


def chip_layout(pods: list[PodRef], gang_shapes: list[tuple[str, tuple]],
                torus: tuple[int, ...]) -> tuple[int, int]:
    """Canonical per-node chip assignment -> ``(occ_mask, sing_mask)``.

    ``gang_shapes`` is [(gang name, slice shape)] in first-appearance
    order; each gang takes the lowest placement mask disjoint from chips
    already assigned.  Remaining accelerator consumers take lowest free
    chips in occupant order; the movable singletons among them form
    ``sing_mask`` (their ``chip_mask`` is stamped on the PodRef)."""
    n = 1
    for d in torus:
        n *= d
    if not torus:
        n = 0
    occ = 0
    for _name, shape in gang_shapes:
        placed = 0
        for m in enumerate_placements(torus, shape):
            if (m & occ) == 0:
                placed = m
                break
        occ |= placed
    sing = 0
    for ref in pods:
        if ref.gpu <= 0 or ref.chip_mask == -1:
            continue   # chip_mask -1 marks gang members (shape owns chips)
        mask = lowest_free_chips(occ, n, ref.gpu)
        ref.chip_mask = mask
        occ |= mask
        if ref.single:
            sing |= mask
    return occ, sing


def parked_gang_shapes(cluster) -> list[tuple[int, ...]]:
    """Distinct slice shapes of gangs currently parked (members pending,
    unbound, unnominated), ascending — the deterministic defrag demand
    set both planner paths and the validator score against."""
    shapes: set[tuple[int, ...]] = set()
    for p in cluster.pending_pods():
        if p.bound_node or p.nominated_node:
            continue
        g = p.spec.gang
        if g is not None and g.slice_shape:
            shapes.add(tuple(g.slice_shape))
    return sorted(shapes)


def _claim_pod_list(cluster, claim, snapshot, index):
    """Occupant PendingPods of ``claim`` in the canonical (collection)
    order — via the shared per-tick OccupancySnapshot when the resident
    path is on, via the per-call occupancy index otherwise.  Both
    reproduce ``preempt.encode.claim_pods`` exactly."""
    if snapshot is None:
        return claim_pods(cluster, claim, index=index)
    seen: set[str] = set()
    out = []
    for name in (claim.node_name, claim.name):
        if not name:
            continue
        for key in snapshot.pods_on(name):
            if key in seen:
                continue
            p = cluster.get("pods", key)
            if p is not None:
                seen.add(key)
                out.append(p)
    return out


def encode_repack(cluster, catalog: CatalogArrays,
                  nodepool: NodePool | None = None, *,
                  snapshot=None, store=None, claims=None,
                  parked: list[tuple[int, ...]] | None = None
                  ) -> RepackProblem:
    """Build the migration tensors from live claims.

    ``store`` (a ResidentStore) routes ``resid``/``pod_count`` through
    the delta-maintained occupancy rows (the device tensor the torch
    grid reads directly) instead of a fresh host rebuild; ``snapshot``
    (an OccupancySnapshot) replaces the per-call pod rescan.  Node order
    is cluster insertion order (the list order every other encoder
    shares), so plans from either path are comparable word for word.
    """
    nodepool = nodepool or NodePool(name="default")
    if claims is None:
        claims = [c for c in cluster.nodeclaims()
                  if not c.deleted and c.launched]
    live = []
    for c in claims:
        if c.deleted or not c.launched:
            continue
        off = catalog.find_offering(c.instance_type, c.zone, c.capacity_type)
        if off is None:
            continue   # offering left the catalog: not a node we can size
        live.append((c, off))

    Nn = len(live)
    R = NUM_RESOURCES
    index = None if snapshot is not None else occupancy_index(cluster)
    alloc = catalog.offering_alloc().astype(np.int64)
    prob = RepackProblem(claim_names=[], catalog=catalog)
    prob.node_off = np.zeros(Nn, dtype=np.int32)
    prob.node_zone = np.zeros(Nn, dtype=np.int32)
    prob.resid = np.zeros((Nn, R), dtype=np.int64)
    prob.pod_count = np.zeros(Nn, dtype=np.int32)
    prob.eligible = np.zeros(Nn, dtype=bool)
    prob.price_milli = np.zeros(Nn, dtype=np.int64)
    prob.n_chips = np.zeros(Nn, dtype=np.int32)
    prob.movable_all = np.zeros(Nn, dtype=bool)
    prob.maxpod = np.zeros((Nn, R), dtype=np.int64)
    prob.sing_demand = np.zeros((Nn, R), dtype=np.int64)
    prob.sing_max = np.zeros((Nn, R), dtype=np.int64)
    prob.sing_count = np.zeros(Nn, dtype=np.int32)
    prob.occ_mask = np.zeros(Nn, dtype=np.uint64)
    prob.sing_mask = np.zeros(Nn, dtype=np.uint64)

    shapes = parked if parked is not None else parked_gang_shapes(cluster)
    prob.parked_shapes = [tuple(s) for s in shapes]
    prob.tables = [slice_table(catalog, s) for s in prob.parked_shapes]

    # per-signature offering compat (labels, availability ignored) +
    # zone-pin flag; taint verdicts per (signature, claim taint tuple)
    sig_index: dict[tuple, int] = {}
    sig_rows: list[np.ndarray] = []
    sig_pinned: list[bool] = []
    sig_reps: list = []
    mask_cache: dict = {}
    pool_taints = tuple(nodepool.taints)

    def _sig_of(spec) -> int:
        # requests/priority/gang (the first three signature slots) do
        # not affect label compat, taints, or zone pinning — keying on
        # them would lower one label row PER POD at the 4k-pod bench
        # shape instead of one per distinct constraint set
        key = spec.constraint_signature()[3:]
        hit = sig_index.get(key)
        if hit is not None:
            return hit
        idx = len(sig_rows)
        sig_index[key] = idx
        sig_rows.append(_label_row_no_avail(
            spec.scheduling_requirements(), None, catalog, mask_cache))
        sig_pinned.append(bool(_has_zone_affinity(spec)
                               or _zone_spread_constraints(spec)))
        sig_reps.append(spec)
        return idx

    for ni, (c, off) in enumerate(live):
        prob.claim_names.append(c.name)
        prob.claims.append(c)
        prob.node_off[ni] = off
        t = int(catalog.off_type[off])
        prob.node_zone[ni] = int(catalog.off_zone[off])
        torus = tuple(catalog.type_torus[t]) if t < len(
            catalog.type_torus) else ()
        n_chips = 1
        for d in torus:
            n_chips *= d
        prob.n_chips[ni] = n_chips if torus else 0
        prob.eligible[ni] = bool(c.initialized and c.node_name)
        prob.price_milli[ni] = int(round(c.hourly_price * 1000.0))
        resid = alloc[off].copy()
        refs: list[PodRef] = []
        gang_shapes: list[tuple[str, tuple]] = []
        gangs_seen: set[str] = set()
        all_movable = True
        for p in _claim_pod_list(cluster, c, snapshot, index):
            spec = p.spec
            req = _pod_req_vec(spec)
            resid -= req
            gpu = int(spec.requests.gpu)
            in_gang = spec.gang is not None
            movable = not in_gang and not _has_hostname_anti_affinity(spec) \
                and tolerates_all(spec.tolerations, pool_taints)
            single = movable and gpu > 0
            ref = PodRef(key=pod_key(spec), req=req, sig=_sig_of(spec),
                         gpu=gpu, movable=movable, single=single)
            if in_gang:
                if spec.gang.slice_shape \
                        and spec.gang.name not in gangs_seen:
                    gangs_seen.add(spec.gang.name)
                    gang_shapes.append((spec.gang.name,
                                        tuple(spec.gang.slice_shape)))
                if spec.gang.slice_shape:
                    ref.chip_mask = -1   # shape owns the chips
            refs.append(ref)
            all_movable &= movable
            np.maximum(prob.maxpod[ni], req, out=prob.maxpod[ni])
            if single:
                prob.sing_demand[ni] += req
                np.maximum(prob.sing_max[ni], req, out=prob.sing_max[ni])
                prob.sing_count[ni] += 1
        occ, sing = chip_layout(refs, gang_shapes, torus)
        prob.occ_mask[ni] = np.uint64(occ)
        prob.sing_mask[ni] = np.uint64(sing)
        prob.pods.append(refs)
        prob.movable_all[ni] = all_movable
        prob.pod_count[ni] = len(refs)
        prob.resid[ni] = resid

    # the resident occupancy handoff: resid/pod_count served from the
    # delta-maintained rows (device tensor + host mirror).  A store that
    # serves stale rows makes the plan diverge from the fresh encode —
    # exactly the failure the pinned handoff test exists to catch.
    if store is not None:
        names, dev, _delta = store.occupancy_tensors(cluster, catalog)
        if names == prob.claim_names:
            mirror = store.occupancy_rows()
            if mirror is not None and mirror.shape[0] >= Nn:
                prob.rows_dev = dev
                prob.rows_host = mirror
                prob.resid = mirror[:Nn, 2:2 + R].astype(np.int64)
                prob.pod_count = mirror[:Nn, 1].astype(np.int32)

    Nsig = len(sig_rows)
    O = catalog.num_offerings
    prob.sig_rows = (np.stack(sig_rows) if Nsig
                     else np.zeros((0, O), dtype=bool))
    prob.sig_zone_pinned = np.asarray(sig_pinned, dtype=bool)
    prob.taint_ok = np.ones((Nsig, Nn), dtype=bool)
    # claims sharing a taint tuple share one toleration verdict per sig
    taint_sets: dict[tuple, np.ndarray] = {}
    for ni, c in enumerate(prob.claims):
        taint_sets.setdefault(tuple(c.taints),
                              np.zeros(Nn, bool))[ni] = True
    for si, rep in enumerate(sig_reps):
        for taints, nmask in taint_sets.items():
            if taints and not tolerates_all(rep.tolerations, taints):
                prob.taint_ok[si] &= ~nmask
    return prob
