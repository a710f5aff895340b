"""Affinity lowering: pod terms -> selector classes -> dense tensors.

Port of ``karpenter_tpu/affinity/encode.py``.  ``solver/encode.py``
calls :func:`build_affinity_index` over the final group list and
:func:`zone_pin_prepass` before per-signature lowering, so required
zone-scope components land in one zone; :func:`hostname_cap` lowers an
empty-selector hostname spread onto the per-node cap, and
:func:`pack_affinity` builds the suffix leaf the affinity scan
(``affinity/kernel.py``) consumes.

Every distinct label selector among the window's armed terms becomes
one selector class; group membership of a class is a [C, G] bool
matrix, and each group's hostname terms collapse to int32 class
bitmasks.  Arming is strictly-superset: a window whose terms produce no
live inter-group edge and no bounded class gets ``None``.  Legacy
lowerings do NOT arm the plane: self hostname anti-affinity (per-node
cap 1), self-only zone affinity (best-zone pin), zone-scope spread
(subgroup split).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.affinity import AFF_BIG, C_PAD, MAX_SELECTOR_CLASSES
from karpenter_tpu_torch.apis.pod import (
    HOSTNAME_TOPOLOGY_KEY, ZONE_TOPOLOGY_KEY, PodSpec,
)
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("affinity.encode")

# required-edge depth ranks are resolved by fixed-point iteration; real
# dependency chains are shallow (a service and its cache), so the cap
# only guards against adversarial/cyclic windows
_DEPTH_ITERS = 64


def _matches(selector, labels_dict) -> bool:
    return all(labels_dict.get(k) == v for k, v in selector)


@dataclass
class AffinityIndex:
    """The per-window affinity lowering, aligned with the encoded group
    order.  ``member[c, g]`` is the one matrix everything else derives
    from; the int32 bitmask lane (``g_sel``/``g_anti``/``g_req``/
    ``bounds``) is the device subset — hostname-scope classes only,
    disarmed wholesale when the window exceeds
    ``MAX_SELECTOR_CLASSES`` (the choke and validator still enforce
    every edge host-side)."""

    classes: tuple          # ((selector, topology_key), ...) [C_all]
    member: np.ndarray      # bool [C_all, G]
    req_host: np.ndarray    # bool [G, C_all] — carrier of required host term
    anti_host: np.ndarray   # bool [G, C_all]
    req_zone: np.ndarray    # bool [G, C_all]
    anti_zone: np.ndarray   # bool [G, C_all]
    host_bound: np.ndarray  # int32 [C_all]; AFF_BIG = unbounded
    comp: np.ndarray        # int32 [G] — connected-component id
    req_depth: np.ndarray   # int32 [G] — FFD sort key (targets first)
    edge_count: int         # live directed (carrier -> member) edges
    device_armed: bool
    g_sel: np.ndarray       # int32 [G] — device class bitmasks
    g_anti: np.ndarray      # int32 [G]
    g_req: np.ndarray       # int32 [G]
    aff_flag: np.ndarray    # int32 [G] 0/1 — explain bit 'affinity_unsatisfied'
    spread_flag: np.ndarray  # int32 [G] 0/1 — explain bit 'spread_bound'
    bounds: np.ndarray      # int32 [C_PAD] — device per-node class bounds

    @property
    def num_classes(self) -> int:
        return len(self.classes)

    @property
    def num_groups(self) -> int:
        return int(self.member.shape[1])

    @property
    def req_mat(self) -> np.ndarray:
        """Dense int32 [G, G]: ``req_mat[g, h]`` = 1 when g carries a
        required edge targeting h (any scope), the validator's view."""
        req = self.req_host | self.req_zone                 # [G, C]
        return (req.astype(np.int32) @ self.member.astype(np.int32)
                > 0).astype(np.int32)

    @property
    def anti_mat(self) -> np.ndarray:
        """Dense int32 [G, G]: anti edges, symmetric closure (kube
        enforces anti-affinity in both directions at schedule time)."""
        anti = self.anti_host | self.anti_zone
        m = (anti.astype(np.int32) @ self.member.astype(np.int32)
             > 0).astype(np.int32)
        return (m | m.T).astype(np.int32)

    def permute(self, order: np.ndarray) -> "AffinityIndex":
        """Re-align every per-group axis with a sorted group order
        (``new[i] = old[order[i]]``) — called once, after the FFD
        lexsort that consumed ``req_depth``."""
        inv_comp = self.comp[order]
        # relabel component ids to the min NEW index per component so
        # ids stay order-canonical after the permutation
        relabel: dict[int, int] = {}
        comp_new = np.empty_like(inv_comp)
        for i, c in enumerate(inv_comp.tolist()):
            comp_new[i] = relabel.setdefault(c, i)
        return AffinityIndex(
            classes=self.classes,
            member=self.member[:, order],
            req_host=self.req_host[order], anti_host=self.anti_host[order],
            req_zone=self.req_zone[order], anti_zone=self.anti_zone[order],
            host_bound=self.host_bound, comp=comp_new,
            req_depth=self.req_depth[order], edge_count=self.edge_count,
            device_armed=self.device_armed,
            g_sel=self.g_sel[order], g_anti=self.g_anti[order],
            g_req=self.g_req[order],
            aff_flag=self.aff_flag[order],
            spread_flag=self.spread_flag[order],
            bounds=self.bounds,
        )


class _UnionFind:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, a: int) -> int:
        while self.p[a] != a:
            self.p[a] = self.p[self.p[a]]
            a = self.p[a]
        return a

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # smaller root wins: component ids stay deterministic
            if rb < ra:
                ra, rb = rb, ra
            self.p[rb] = ra


def group_terms(rep: PodSpec):
    """(armed affinity terms, bounded hostname spread constraints) for
    one representative — the single place that knows which terms the
    legacy lowerings already consumed.  Excluded here, preserved there:
    self hostname anti-affinity (encode's per-node cap 1), zone-scope
    spread (the subgroup split), ScheduleAnyway hostname spread (soft —
    a cost term would be the honest lowering; currently a documented
    no-op, matching the pre-affinity encoder)."""
    own = rep.labels_dict
    terms = []
    for t in rep.affinity:
        if t.topology_key == HOSTNAME_TOPOLOGY_KEY and t.anti \
                and _matches(t.label_selector, own):
            continue                      # legacy: self anti -> cap 1
        terms.append(t)
    spreads = [c for c in rep.topology_spread
               if c.topology_key == HOSTNAME_TOPOLOGY_KEY
               and c.when_unsatisfiable == "DoNotSchedule"
               and c.label_selector]
    return terms, spreads


def hostname_cap(rep: PodSpec) -> int | None:
    """Per-node cap from EMPTY-selector hostname spread (DoNotSchedule):
    the constraint self-selects the pod's own group, so 'at most
    max_skew matching pods per node' lowers exactly onto the existing
    cap_per_node machinery — no plane arming, no kernel change.
    ``None`` when the pod carries no such constraint (the caller's
    BIG_CAP sentinel semantics must stay untouched)."""
    caps = [c.max_skew for c in rep.topology_spread
            if c.topology_key == HOSTNAME_TOPOLOGY_KEY
            and c.when_unsatisfiable == "DoNotSchedule"
            and not c.label_selector]
    return min(caps) if caps else None


def build_affinity_index(reps: list[PodSpec]) -> AffinityIndex | None:
    """Lower one window's affinity surface to the dense index, or
    ``None`` when nothing arms (the strict-superset gate).

    A term arms the plane only when it reaches BEYOND its own group:
    an anti/required selector matching at least one other group, or a
    required selector matching nothing (the honest lowering is 'cannot
    place', not a silent drop).  A bounded spread class arms when any
    group is a member.  Self-only zone affinity and self-only zone
    anti-affinity keep their legacy behavior (best-zone pin / no-op).
    """
    G = len(reps)
    if G == 0:
        return None
    labels = [rep.labels_dict for rep in reps]
    per_group = [group_terms(rep) for rep in reps]
    if not any(ts or ss for ts, ss in per_group):
        return None

    # ---- selector-class universe (deterministic first-seen order) ----
    classes: list[tuple] = []
    cls_of: dict[tuple, int] = {}

    def _cls(selector, key) -> int:
        k = (tuple(selector), key)
        if k not in cls_of:
            cls_of[k] = len(classes)
            classes.append(k)
        return cls_of[k]

    # pass 1: which (term, class) pairs are LIVE (arm the plane)?
    # membership is evaluated against every group's labels up front.
    def _members(selector) -> list[int]:
        return [g for g in range(G) if _matches(selector, labels[g])]

    entries = []       # (g, term, cls_idx, members)
    spread_entries = []  # (g, constraint, cls_idx, members)
    for g, (terms, spreads) in enumerate(per_group):
        for t in terms:
            mem = _members(t.label_selector)
            others = [h for h in mem if h != g]
            if t.topology_key == ZONE_TOPOLOGY_KEY and not others:
                # legacy paths own the self-only / empty zone terms:
                # _has_zone_affinity pins, self zone-anti is a no-op
                continue
            if t.anti and not others:
                continue                      # anti matching nothing: no-op
            c = _cls(t.label_selector, t.topology_key)
            entries.append((g, t, c, mem))
        for s in spreads:
            mem = _members(s.label_selector)
            if not mem:
                continue                      # vacuous bound: no members
            c = _cls(s.label_selector, HOSTNAME_TOPOLOGY_KEY)
            spread_entries.append((g, s, c, mem))
    if not entries and not spread_entries:
        return None

    C_all = len(classes)
    member = np.zeros((C_all, G), dtype=bool)
    for (sel, _key), c in cls_of.items():
        for g in range(G):
            if _matches(sel, labels[g]):
                member[c, g] = True
    req_host = np.zeros((G, C_all), dtype=bool)
    anti_host = np.zeros((G, C_all), dtype=bool)
    req_zone = np.zeros((G, C_all), dtype=bool)
    anti_zone = np.zeros((G, C_all), dtype=bool)
    host_bound = np.full(C_all, AFF_BIG, dtype=np.int32)
    edge_count = 0
    uf = _UnionFind(G)
    for g, t, c, mem in entries:
        if t.topology_key == HOSTNAME_TOPOLOGY_KEY:
            (anti_host if t.anti else req_host)[g, c] = True
        else:
            (anti_zone if t.anti else req_zone)[g, c] = True
        for h in mem:
            if h != g:
                edge_count += 1
                uf.union(g, h)
    for g, s, c, mem in spread_entries:
        host_bound[c] = min(int(host_bound[c]), int(s.max_skew))
        for h in mem:
            uf.union(g, h)
            if mem:
                uf.union(mem[0], h)
    comp = np.array([uf.find(g) for g in range(G)], dtype=np.int32)

    # ---- required-edge depth ranks (targets pack first) --------------
    has_req = req_host.any(axis=1)
    depth = np.zeros(G, dtype=np.int32)
    if has_req.any():
        tgt = (req_host.astype(np.int32) @ member.astype(np.int32)) > 0
        np.fill_diagonal(tgt, False)
        for _ in range(min(G, _DEPTH_ITERS)):
            td = np.where(tgt, depth[None, :], -1).max(axis=1)
            new = np.where(has_req, np.minimum(td + 1, _DEPTH_ITERS),
                           0).astype(np.int32)
            if (new == depth).all():
                break
            depth = new

    # ---- device lane: hostname classes -> int32 bitmasks -------------
    host_cls = [c for c in range(C_all)
                if classes[c][1] == HOSTNAME_TOPOLOGY_KEY
                and (req_host[:, c].any() or anti_host[:, c].any()
                     or host_bound[c] < AFF_BIG)]
    device_armed = len(host_cls) <= MAX_SELECTOR_CLASSES
    if not device_armed:
        log.warning("affinity device lane disarmed: selector classes "
                    "exceed budget (choke-point enforcement only)",
                    classes=len(host_cls), budget=MAX_SELECTOR_CLASSES)
        host_cls = []
    bit_of = {c: i for i, c in enumerate(host_cls)}
    g_sel = np.zeros(G, dtype=np.int32)
    g_anti = np.zeros(G, dtype=np.int32)
    g_req = np.zeros(G, dtype=np.int32)
    bounds = np.full(C_PAD, AFF_BIG, dtype=np.int32)
    for c, i in bit_of.items():
        g_sel |= np.where(member[c], np.int32(1 << i), 0).astype(np.int32)
        g_req |= np.where(req_host[:, c], np.int32(1 << i), 0) \
            .astype(np.int32)
        g_anti |= np.where(anti_host[:, c], np.int32(1 << i), 0) \
            .astype(np.int32)
        bounds[i] = host_bound[c]

    # explain flags: a group can be dropped as a CARRIER of a term or
    # as a MEMBER another group's term targets — both get the bit
    any_aff_cls = np.zeros(C_all, dtype=bool)
    for g, _t, c, _mem in entries:
        any_aff_cls[c] = True
    aff_carrier = (req_host | anti_host | req_zone | anti_zone).any(axis=1)
    aff_member = member[any_aff_cls].any(axis=0) if any_aff_cls.any() \
        else np.zeros(G, dtype=bool)
    bounded_cls = host_bound < AFF_BIG
    spread_member = member[bounded_cls].any(axis=0) if bounded_cls.any() \
        else np.zeros(G, dtype=bool)
    return AffinityIndex(
        classes=tuple(classes), member=member,
        req_host=req_host, anti_host=anti_host,
        req_zone=req_zone, anti_zone=anti_zone,
        host_bound=host_bound, comp=comp, req_depth=depth,
        edge_count=edge_count, device_armed=device_armed,
        g_sel=g_sel, g_anti=g_anti, g_req=g_req,
        aff_flag=(aff_carrier | aff_member).astype(np.int32),
        spread_flag=spread_member.astype(np.int32),
        bounds=bounds,
    )



def pack_affinity(index: AffinityIndex, G_pad: int) -> np.ndarray:
    """The int32 suffix leaf of an affinity dispatch — O(G) class
    bitmasks plus the C_PAD bound row, zero-padded to the group bucket
    (padding groups carry empty masks and place nothing):

        [0,    G)        g_sel
        [G,    2G)       g_anti
        [2G,   3G)       g_req
        [3G,   4G)       aff_flag
        [4G,   5G)       spread_flag
        [5G,   5G+C_PAD) bounds   (AFF_BIG = unbounded)
    """
    G = index.num_groups
    buf = np.zeros(5 * G_pad + C_PAD, dtype=np.int32)
    for i, col in enumerate((index.g_sel, index.g_anti, index.g_req,
                             index.aff_flag, index.spread_flag)):
        buf[i * G_pad:i * G_pad + G] = col
    buf[5 * G_pad:] = index.bounds
    return buf


def unpack_affinity(buf: np.ndarray, G_pad: int):
    """Host-side inverse of :func:`pack_affinity`."""
    cols = [np.asarray(buf[i * G_pad:(i + 1) * G_pad]) for i in range(5)]
    return (*cols, np.asarray(buf[5 * G_pad:5 * G_pad + C_PAD]))

def zone_pin_prepass(entries) -> dict:
    """Co-pin required zone-scope components to one zone.

    ``entries``: list of ``(sig, labels_dict, terms, viable_zones)``
    per signature group, in deterministic encode order.  Returns
    ``{sig: zone}`` for every signature that must be pinned — required
    components land on the lexicographically-first zone viable for ALL
    members (an empty intersection leaves the component unpinned; the
    decode choke then drops carriers honestly), then anti-zone carriers
    greedily take their first viable zone not already pinned to a
    matching member (graph-coloring in entry order)."""
    n = len(entries)
    if n == 0:
        return {}

    def members_of(selector):
        return [j for j in range(n)
                if _matches(selector, entries[j][1])]

    uf = _UnionFind(n)
    any_req = False
    for i, (_sig, _labels, terms, _vz) in enumerate(entries):
        for t in terms:
            if t.topology_key != ZONE_TOPOLOGY_KEY or t.anti:
                continue
            for j in members_of(t.label_selector):
                if j != i:
                    any_req = True
                    uf.union(i, j)
    pins: dict = {}
    pin_by_idx: dict[int, str] = {}
    if any_req:
        comps: dict[int, list[int]] = {}
        for i in range(n):
            comps.setdefault(uf.find(i), []).append(i)
        for root in sorted(comps):
            idxs = comps[root]
            if len(idxs) < 2:
                continue
            common = set(entries[idxs[0]][3])
            for j in idxs[1:]:
                common &= set(entries[j][3])
            if not common:
                continue              # unpinnable: the choke is honest
            zone = sorted(common)[0]
            for j in idxs:
                pins[entries[j][0]] = zone
                pin_by_idx[j] = zone
    # anti-zone carriers: avoid every matching member's pinned zone
    for i, (sig, _labels, terms, vz) in enumerate(entries):
        taken = set()
        for t in terms:
            if t.topology_key != ZONE_TOPOLOGY_KEY or not t.anti:
                continue
            for j in members_of(t.label_selector):
                if j != i and j in pin_by_idx:
                    taken.add(pin_by_idx[j])
        if not taken:
            continue
        cur = pin_by_idx.get(i)
        if cur is not None and cur not in taken:
            continue
        free = [z for z in sorted(vz) if z not in taken]
        if free:
            pins[sig] = free[0]
            pin_by_idx[i] = free[0]
    return pins
