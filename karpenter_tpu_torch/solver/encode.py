"""Host-side problem encoding: pods -> dense group tensors + masks.

Port of ``karpenter_tpu/solver/encode.py`` (numpy, no JAX): the bridge
between the relational scheduling world (requirements, taints, spread,
affinity) and the dense solve.  Strategy: *hard masks + host-side group
splitting*, so the device solve only ever sees

- ``group_req``   int32 [G, R]   resource vector per pod of the group
- ``group_count`` int32 [G]      pods in the group
- ``group_cap``   int32 [G]      max pods of the group per node
                                 (1 for hostname anti-affinity)
- ``compat``      bool  [G, O]   group x offering feasibility, factored
                                 as label rows [U, O] + label_idx [G]

Relational constraints are lowered as:
- **node selectors / required node affinity** -> per-label allowed-value
  masks over the catalog vocabularies, intersected into ``compat``;
- **nodepool taints** -> pods that do not tolerate them are rejected
  before grouping (unschedulable for this pool);
- **topology spread over zones (DoNotSchedule)** -> the group is split
  into per-zone pinned subgroups with counts as even as possible;
- **zone affinity (co-schedule)** -> the group is pinned to the zone with
  the most compatible capacity (``solver/zonesplit.py`` refines the pin);
- **hostname anti-affinity (self)** -> per-node cap 1.

Identical pods collapse into one group row; the device scan is over
groups, not pods.  Plans decode through :func:`decode_plan_entries`.
"""

from __future__ import annotations

from dataclasses import dataclass
from operator import attrgetter
from collections.abc import Sequence

import numpy as np

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.affinity.encode import (
    build_affinity_index, hostname_cap, zone_pin_prepass,
)
from karpenter_tpu_torch.apis.pod import (
    NUM_RESOURCES, PodSpec, ZONE_TOPOLOGY_KEY,
    fingerprint_token as _fp_token, pod_key, tolerates_all,
)
from karpenter_tpu_torch.apis.requirements import (
    LABEL_ARCH, LABEL_CAPACITY_TYPE, LABEL_HOSTNAME, LABEL_INSTANCE_FAMILY,
    LABEL_INSTANCE_SIZE, LABEL_INSTANCE_TYPE, LABEL_ZONE, Requirements,
)
from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES, CatalogArrays
from karpenter_tpu_torch.stochastic.encode import usage_rows

BIG_CAP = 1 << 30  # "no per-node cap"


@dataclass
class PodGroup:
    representative: PodSpec
    pod_names: list[str]           # canonical 'namespace/name' keys
    count: int
    requirements: Requirements
    cap_per_node: int = BIG_CAP
    pinned_zone: str | None = None
    spread_origin: tuple | None = None   # signature of the pre-split group
    nozone_mask: np.ndarray | None = None  # bool [O], computed once in encode
    label_mask: np.ndarray | None = None   # bool [O], nozone WITHOUT the
                                              # resource-fit term (device
                                              # recomputes fit from group_req)


class EncodedProblem:
    """Dense solve input.  ``compat`` (bool [G, O]) is LAZY: the device
    path ships only the factored form — ``label_rows`` (bool [U, O],
    deduped label masks WITHOUT the per-group resource-fit term) plus a
    [G] ``label_idx`` — and the device recomputes
    ``compat[g] = label_rows[label_idx[g]] & fit(group_req[g])`` from the
    resident catalog, so the full [G, O] mask is never materialized on
    the hot path.  Host consumers (validator, explain oracle) force it
    on first access.

    Group order is descending dominant-resource size; both backends
    consume the same order, so plans are comparable."""

    __slots__ = ("groups", "group_req", "group_count", "group_cap",
                 "group_prio", "group_gang", "group_min", "gang_names",
                 "catalog", "rejected", "rejected_reasons", "label_rows",
                 "label_idx", "pref_rows", "pref_idx", "group_mean",
                 "group_var", "overcommit_eps", "aff", "_compat",
                 "_names_idx", "_prep_cache")

    def __init__(self, groups: list[PodGroup], group_req: np.ndarray,
                 group_count: np.ndarray, group_cap: np.ndarray,
                 compat: np.ndarray | None = None,
                 catalog: CatalogArrays | None = None,
                 rejected: list[str] | None = None,
                 label_rows: np.ndarray | None = None,
                 label_idx: np.ndarray | None = None,
                 pref_rows: np.ndarray | None = None,
                 pref_idx: np.ndarray | None = None,
                 group_prio: np.ndarray | None = None,
                 group_gang: np.ndarray | None = None,
                 group_min: np.ndarray | None = None,
                 gang_names: list[str] | None = None,
                 rejected_reasons: dict[str, str] | None = None,
                 group_mean: np.ndarray | None = None,
                 group_var: np.ndarray | None = None,
                 overcommit_eps: float = 0.0,
                 aff=None):
        self.groups = groups
        self.group_req = group_req
        self.group_count = group_count
        self.group_cap = group_cap
        # int32 [G] per-group pod priority (parse_priority-validated) —
        # the preemption plane's ranking tensor; zeros when absent
        self.group_prio = group_prio if group_prio is not None \
            else np.zeros(len(groups), dtype=np.int32)
        # gang plane (apis/podgroup.py): int32 [G] gang id (-1 = no
        # gang; ids index gang_names) + int32 [G] min_member.  Groups of
        # one gang place all-or-nothing — enforced in the decode choke
        # point every dense backend shares (decode_plan_entries), the
        # greedy host oracle's transactional pass, and the independent
        # validator's no-partial-gang check (docs/design/gang.md).
        self.group_gang = group_gang if group_gang is not None \
            else np.full(len(groups), -1, dtype=np.int32)
        self.group_min = group_min if group_min is not None \
            else np.zeros(len(groups), dtype=np.int32)
        self.gang_names = gang_names if gang_names is not None else []
        self.catalog = catalog
        self.rejected = rejected if rejected is not None else []
        # pod key -> canonical explain reason for encoder-time rejects
        # ("taints" = pool taints not tolerated, "requirements" =
        # statically-unsatisfiable requirement keys); consumed by the
        # explain decode fold (karpenter_tpu/explain/decode.py)
        self.rejected_reasons = rejected_reasons \
            if rejected_reasons is not None else {}
        self.label_rows = label_rows
        self.label_idx = label_idx
        # soft preferences, factored like label rows: pref_rows float32
        # [P, O] (weighted miss fraction, 0 = fully preferred) + pref_idx
        # int32 [G] (-1 = no preferences).  None when NO group carries
        # preferences — the common case, and the gate for the
        # pallas/flat fast paths (the scan path owns penalty ranking).
        self.pref_rows = pref_rows
        self.pref_idx = pref_idx
        # stochastic plane (karpenter_tpu/stochastic): int32 [G, R]
        # usage mean/variance per pod of the group, attached ONLY when
        # the nodepool overcommits (NodePool.overcommit > 0) — None is
        # the strict-superset gate every deterministic path checks.
        # overcommit_eps is the pool's violation-probability bound.
        self.group_mean = group_mean
        self.group_var = group_var
        self.overcommit_eps = overcommit_eps
        # affinity plane (karpenter_tpu/affinity): the per-window
        # AffinityIndex (selector classes, group bitmasks, spread
        # bounds, components) — attached ONLY when at least one
        # inter-group edge or bounded spread class arms.  None is the
        # strict-superset gate every edge-free path checks.
        self.aff = aff
        self._compat = compat
        self._names_idx = None      # (names_arr object [P], gstart int64 [G+1])
        self._prep_cache = None     # torch_backend packed-template cache

    @property
    def has_preferences(self) -> bool:
        return self.pref_rows is not None

    @property
    def has_gangs(self) -> bool:
        return len(self.gang_names) > 0

    @property
    def compat(self) -> np.ndarray:
        if self._compat is None:
            G = len(self.groups)
            O = self.catalog.num_offerings
            if G == 0:
                self._compat = np.zeros((0, O), dtype=bool)
            else:
                fit = (self.catalog.offering_alloc()[None, :, :]
                       >= self.group_req.astype(np.int64)[:, None, :]
                       ).all(axis=2)
                self._compat = self.label_rows[self.label_idx] & fit
        return self._compat

    def replace(self, **kw) -> "EncodedProblem":
        """Shallow-copy with overrides (the dataclasses.replace of the
        pre-lazy-compat dataclass).  ``compat`` passes through to the
        lazy slot; omitting it keeps the current (possibly unforced)
        state."""
        fields = dict(groups=self.groups, group_req=self.group_req,
                      group_count=self.group_count, group_cap=self.group_cap,
                      compat=self._compat, catalog=self.catalog,
                      rejected=self.rejected, label_rows=self.label_rows,
                      label_idx=self.label_idx, pref_rows=self.pref_rows,
                      pref_idx=self.pref_idx, group_prio=self.group_prio,
                      group_gang=self.group_gang, group_min=self.group_min,
                      gang_names=self.gang_names,
                      rejected_reasons=self.rejected_reasons,
                      group_mean=self.group_mean, group_var=self.group_var,
                      overcommit_eps=self.overcommit_eps, aff=self.aff)
        fields.update(kw)
        return EncodedProblem(**fields)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    @property
    def num_pods(self) -> int:
        return int(self.group_count.sum()) + len(self.rejected)


def _split_counts(total: int, ways: int) -> list[int]:
    """Split ``total`` into ``ways`` parts as evenly as possible."""
    base, rem = divmod(total, ways)
    return [base + (1 if i < rem else 0) for i in range(ways)]


def _allowed_mask(reqs: Requirements, key: str, vocab: list[str],
                  cache: dict | None = None) -> np.ndarray:
    """bool [len(vocab)] — which vocabulary values every requirement on
    ``key`` admits.  With ``cache``, masks are shared across groups whose
    requirements on ``key`` are identical (the common case: none)."""
    key_reqs = tuple(sorted(r.signature for r in reqs.get(key)))
    if cache is not None:
        hit = cache.get((key, key_reqs))
        if hit is not None:
            return hit
    allowed = set(reqs.allowed_values(key, vocab))
    mask = np.array([v in allowed for v in vocab], dtype=bool)
    if cache is not None:
        cache[(key, key_reqs)] = mask
    return mask


def _has_zone_affinity(pod: PodSpec) -> bool:
    return any(not t.anti and t.topology_key == LABEL_ZONE for t in pod.affinity)


def _has_hostname_anti_affinity(pod: PodSpec) -> bool:
    """Self anti-affinity: the term's selector matches the pod's own labels."""
    own = pod.labels_dict
    for t in pod.affinity:
        if t.anti and t.topology_key == LABEL_HOSTNAME:
            if all(own.get(k) == v for k, v in t.label_selector):
                return True
    return False


def _zone_spread_constraints(pod: PodSpec):
    return [c for c in pod.topology_spread
            if c.topology_key == LABEL_ZONE and c.when_unsatisfiable == "DoNotSchedule"]


_LABEL_KEYS = (LABEL_INSTANCE_TYPE, LABEL_ARCH, LABEL_INSTANCE_FAMILY,
               LABEL_INSTANCE_SIZE, LABEL_CAPACITY_TYPE)


def _label_compat_noavail(reqs: Requirements, catalog: CatalogArrays,
                          cache: dict | None = None) -> np.ndarray:
    """bool [O]: the five label masks WITHOUT the availability term —
    the factor the explain refinement splits on (a pod whose labels
    match offerings that are all unavailable is "availability", not
    "requirements"; karpenter_tpu/explain/decode.py)."""
    if cache is not None:
        key = ("__label_row_noavail__",) + tuple(
            tuple(sorted(r.signature for r in reqs.get(k)))
            for k in _LABEL_KEYS)
        hit = cache.get(key)
        if hit is not None:
            return hit
    mask = _allowed_mask(reqs, LABEL_INSTANCE_TYPE,
                         catalog.type_names, cache)[catalog.off_type]
    mask &= _allowed_mask(reqs, LABEL_ARCH,
                          catalog.archs, cache)[catalog.type_arch[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_INSTANCE_FAMILY,
                          catalog.families, cache)[catalog.type_family[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_INSTANCE_SIZE,
                          catalog.sizes, cache)[catalog.type_size[catalog.off_type]]
    mask &= _allowed_mask(reqs, LABEL_CAPACITY_TYPE,
                          list(CAPACITY_TYPES), cache)[catalog.off_cap]
    if cache is not None:
        cache[key] = mask
    return mask


def _label_compat(reqs: Requirements, catalog: CatalogArrays,
                  cache: dict | None = None) -> np.ndarray:
    """bool [O]: the LABEL part of offering feasibility (zone-independent):
    type/arch/family/size/capacity-type masks and availability — no
    resource-fit term (the device recomputes fit from group_req, so only
    these rows cross the host->device boundary).

    The COMBINED row is memoized by its five requirement signatures, so
    signatures with identical label constraints (the common case: none)
    share one array object — the label-row dedup in encode() keys on
    identity, making U the number of truly distinct constraint sets, not
    the number of request-size groups."""
    if cache is not None:
        combined_key = ("__label_row__",) + tuple(
            tuple(sorted(r.signature for r in reqs.get(k)))
            for k in _LABEL_KEYS)
        hit = cache.get(combined_key)
        if hit is not None:
            return hit
    mask = _label_compat_noavail(reqs, catalog, cache) & catalog.off_avail
    if cache is not None:
        cache[combined_key] = mask
    return mask


# weight of one ScheduleAnyway zone-spread term in the soft-preference
# blend (kube's scoring plugins weigh spread comparably to the strongest
# preferred-affinity term, which caps at 100)
SOFT_SPREAD_WEIGHT = 100


def _req_offering_mask(r, catalog: CatalogArrays,
                       cache: dict | None = None) -> np.ndarray | None:
    """bool [O]: offerings satisfying ONE requirement, for preference
    scoring.  Keys the catalog cannot express return None (constant over
    offerings — irrelevant to ranking within a solve)."""
    one = Requirements([r])
    if r.key == LABEL_INSTANCE_TYPE:
        return _allowed_mask(one, r.key, catalog.type_names,
                             cache)[catalog.off_type]
    if r.key == LABEL_ARCH:
        return _allowed_mask(one, r.key, catalog.archs,
                             cache)[catalog.type_arch[catalog.off_type]]
    if r.key == LABEL_INSTANCE_FAMILY:
        return _allowed_mask(one, r.key, catalog.families,
                             cache)[catalog.type_family[catalog.off_type]]
    if r.key == LABEL_INSTANCE_SIZE:
        return _allowed_mask(one, r.key, catalog.sizes,
                             cache)[catalog.type_size[catalog.off_type]]
    if r.key == LABEL_CAPACITY_TYPE:
        return _allowed_mask(one, r.key, list(CAPACITY_TYPES),
                             cache)[catalog.off_cap]
    if r.key == LABEL_ZONE:
        return _allowed_mask(one, r.key, catalog.zones,
                             cache)[catalog.off_zone]
    return None


def _lower_preferred(preferred, catalog: CatalogArrays,
                     cache: dict | None = None):
    """(terms, total_weight) where terms = [(weight, satisfied_mask)] —
    the per-signature half of the preference penalty; the per-subgroup
    soft-spread term joins in :func:`_pref_miss_row`."""
    terms = []
    total = 0
    for w, r in preferred:
        sat = _req_offering_mask(r, catalog, cache)
        if sat is None:
            continue
        terms.append((int(w), sat))
        total += int(w)
    return terms, total


def _pref_miss_row(terms, total_w: int, soft_zone: str | None,
                   catalog: CatalogArrays) -> np.ndarray | None:
    """float32 [O] in [0,1]: weighted fraction of UNSATISFIED preference
    terms per offering (0 = fully preferred).  None when the group has
    no scoreable preferences."""
    tw = total_w + (SOFT_SPREAD_WEIGHT if soft_zone is not None else 0)
    if tw == 0:
        return None
    miss = np.zeros(catalog.num_offerings, np.float32)
    for w, sat in terms:
        miss += w * (~sat)
    if soft_zone is not None:
        zi = catalog.zones.index(soft_zone) if soft_zone in catalog.zones \
            else -1
        miss += SOFT_SPREAD_WEIGHT * (catalog.off_zone != zi)
    return miss / tw


def _soft_zone_spread(pod: PodSpec):
    return [c for c in pod.topology_spread
            if c.topology_key == LABEL_ZONE
            and c.when_unsatisfiable == "ScheduleAnyway"]


def _fit_mask(req_vec, catalog: CatalogArrays) -> np.ndarray:
    """bool [O]: empty-node resource fit (alloc >= req, every dimension)."""
    return (catalog.offering_alloc() >=
            np.asarray(req_vec, dtype=np.int64)[None, :]).all(axis=1)


def _nozone_compat(reqs: Requirements, req_vec, catalog: CatalogArrays,
                   cache: dict | None = None) -> np.ndarray:
    """bool [O]: offering feasibility for a group ignoring the zone axis —
    label masks, availability, and empty-node resource fit."""
    return _label_compat(reqs, catalog, cache) & _fit_mask(req_vec, catalog)


def viable_zones(reqs: Requirements, req_vec, catalog: CatalogArrays,
                 nozone: np.ndarray | None = None,
                 cache: dict | None = None) -> list[str]:
    """Zones (within the requirement-allowed set) where the group has at
    least one available, resource-fitting offering.  Spread subgroups are
    only pinned to viable zones — pinning to a dead zone would strand pods
    AND violate the skew the split was meant to guarantee."""
    zone_allowed = _allowed_mask(reqs, LABEL_ZONE, catalog.zones, cache)
    if nozone is None:
        nozone = _nozone_compat(reqs, req_vec, catalog, cache)
    out = []
    for zi, z in enumerate(catalog.zones):
        if zone_allowed[zi] and (nozone & (catalog.off_zone == zi)).any():
            out.append(z)
    return out


_DEFAULT_POOL = NodePool(name="default")
# cross-encode memo of per-signature lowering (requirements, nozone mask,
# viable zones) — valid only for the default pool, keyed by catalog
# generation so availability changes invalidate it.  The provisioner
# re-encodes the same pending set every window; this skips the per-group
# mask construction entirely on repeats.
_SIG_LOWER_CACHE: dict[tuple, tuple] = {}
# cap on distinct catalog generations kept in the sig-lowering cache: a
# flat namespace cleared on any generation change gives ZERO reuse when
# catalogs alternate in one process (multi-NodeClass pools; pool-limit
# views) — instead stale generations are evicted only past this bound
_SIG_CACHE_MAX_GENS = 8
_SIG_CACHE_GENS: list[tuple] = []   # insertion-ordered live generations


def clear_sig_cache() -> None:
    """Test/bench hook: drop every cached signature lowering."""
    _SIG_LOWER_CACHE.clear()
    _SIG_CACHE_GENS.clear()


def _sig_cache_admit(gen_key: tuple) -> None:
    """Track ``gen_key`` as live (LRU).  A NEW generation of a uid
    evicts that uid's older generations immediately — generations are
    monotonic per catalog, so their entries can never be hit again and
    would otherwise pile up 8x in the single-catalog steady state.  The
    cap then only bounds DISTINCT catalogs (the alternation case the
    per-generation structure exists for)."""
    if gen_key in _SIG_CACHE_GENS:
        if _SIG_CACHE_GENS[-1] != gen_key:        # LRU refresh
            _SIG_CACHE_GENS.remove(gen_key)
            _SIG_CACHE_GENS.append(gen_key)
        return
    uid = gen_key[0]
    # drain this uid's dead generations FIRST: they must not count
    # toward the cap, or a generation bump at exactly MAX_GENS live
    # catalogs would evict a LIVE distinct catalog instead
    dead = [g for g in _SIG_CACHE_GENS if g[0] == uid]
    for g in dead:
        _SIG_CACHE_GENS.remove(g)
    _SIG_CACHE_GENS.append(gen_key)
    while len(_SIG_CACHE_GENS) > _SIG_CACHE_MAX_GENS:
        dead.append(_SIG_CACHE_GENS.pop(0))
    for g in dead:
        for k in [k for k in _SIG_LOWER_CACHE if k[1:] == g]:
            del _SIG_LOWER_CACHE[k]

# whole-encode memo: the provisioner's repack loop re-encodes an
# unchanged pending set every window (10 s period), and the pipelined
# solve path amortizes everything EXCEPT host encode — so an unchanged
# (pods, catalog) window must pay ~0 here.
# Keyed by a fingerprint over (pod identity, constraint signature), the
# nodepool's content signature, and the catalog generations; each entry
# stores (token tuple, problem) so hits are equality-verified.  Entries
# are immutable by convention (no caller mutates an EncodedProblem —
# zonesplit derives via .replace()).
_ENCODE_MEMO: dict[tuple, tuple[tuple, EncodedProblem]] = {}
_ENCODE_MEMO_MAX = 8


_FPT_GETTER = attrgetter("_fpt")


def _pods_fingerprint(pods: Sequence[PodSpec]) -> tuple:
    """Order-sensitive identity of a solve window: pod key + interned
    constraint-signature id per pod, memoized as one `_fpt` attribute on
    the frozen PodSpec so the steady-state cost is a single C-level
    attrgetter pass.  The full token tuple is
    returned (not just its hash): the memo stores it and verifies
    equality on hit, so a 64-bit tuple-hash collision can never serve a
    different window's problem."""
    try:
        return tuple(map(_FPT_GETTER, pods))
    except AttributeError:
        return tuple(_fp_token(p) for p in pods)


def _pool_signature(pool: NodePool) -> tuple:
    """Content identity of a NodePool for the encode memo: every field
    that influences lowering (taint rejection, requirement merging,
    static-label satisfaction).  The production provisioner passes a
    fresh NodePool object each window, so identity alone never hits."""
    return (pool.name, pool.nodeclass_name,
            tuple(sorted(r.signature for r in pool.requirements)),
            pool.taints, pool.startup_taints,
            tuple(sorted(pool.labels.items())), pool.resource_version,
            # overcommit epsilon changes which tensors the encoder
            # attaches (stochastic plane) — part of lowering identity
            getattr(pool, "overcommit", 0.0))


def encode(pods: Sequence[PodSpec], catalog: CatalogArrays,
           nodepool: NodePool | None = None,
           zone_overrides: dict[int, str] | None = None) -> EncodedProblem:
    """Group, split, and lower the scheduling problem to dense tensors.

    ``zone_overrides`` maps a signature id -> forced pinned zone for its
    zone-affinity group — the mechanism behind the multi-zone candidate
    split (solver/zonesplit.py): candidates re-encode with each viable
    zone and the cost-minimizing solve wins (replaces the v1
    most-capacity heuristic when enabled).

    Unchanged windows are memoized: same pods (by key + constraint
    signature), same catalog generations, default pool, no overrides ->
    the previous EncodedProblem is returned as-is."""
    nodepool = nodepool or _DEFAULT_POOL
    zone_overrides = zone_overrides or {}
    memo_key = None
    toks = None
    if not zone_overrides:
        toks = _pods_fingerprint(pods)
        memo_key = (len(toks), hash(toks), _pool_signature(nodepool),
                    catalog.uid, catalog.generation,
                    catalog.availability_generation)
        hit = _ENCODE_MEMO.get(memo_key)
        # equality check against the stored token tuple: a tuple-hash
        # collision must never serve a different window's problem
        if hit is not None and hit[0] == toks:
            return hit[1]
    problem = _encode_impl(pods, catalog, nodepool, zone_overrides)
    if memo_key is not None:
        while len(_ENCODE_MEMO) >= _ENCODE_MEMO_MAX:
            _ENCODE_MEMO.pop(next(iter(_ENCODE_MEMO)))
        _ENCODE_MEMO[memo_key] = (toks, problem)
    return problem


def _encode_impl(pods: Sequence[PodSpec], catalog: CatalogArrays,
                 nodepool: NodePool,
                 zone_overrides: dict[int, str]) -> EncodedProblem:
    pool_labels = dict(nodepool.labels)

    # 1. Reject pods that cannot run in this pool at all (taints).
    rejected: list[str] = []
    rej_reasons: dict[str, str] = {}   # explain taxonomy, decode fold
    eligible: list[PodSpec] = []
    for pod in pods:
        if nodepool.taints and not tolerates_all(pod.tolerations, nodepool.taints):
            key = pod_key(pod)
            rejected.append(key)
            rej_reasons[key] = "taints"
        else:
            eligible.append(pod)

    # 2. Group by constraint signature (interned int ids: no tuple
    # re-hashing at 10k pods).
    by_sig: dict[int, list[PodSpec]] = {}
    for pod in eligible:
        by_sig.setdefault(pod.signature_id(), []).append(pod)

    # 3. Per-group requirement lowering + splitting.  The zone-independent
    # offering mask is computed ONCE per signature group (shared by split
    # subgroups), label masks are cached across groups, and the factored
    # label ROW (label mask ∩ zone requirement ∩ pin) is resolved inline —
    # the per-group work after this loop is pure vectorized numpy, which
    # is what keeps a 10k-signature heterogeneous encode in the low
    # hundreds of ms instead of seconds.
    known_keys = {LABEL_INSTANCE_TYPE, LABEL_ARCH, LABEL_INSTANCE_FAMILY,
                  LABEL_INSTANCE_SIZE, LABEL_ZONE, LABEL_CAPACITY_TYPE}
    mask_cache: dict = {}
    groups: list[PodGroup] = []
    g_req: list[tuple[int, ...]] = []      # per-group scalar columns,
    g_count: list[int] = []                # assembled vectorized below
    g_cap: list[int] = []
    g_label: list[int] = []
    g_pref: list[int] = []                 # index into pref row set; -1 = none
    g_prio: list[int] = []
    g_gang: list[int] = []                 # gang id; -1 = no gang
    g_min: list[int] = []                  # gang min_member; 0 = no gang
    g_name: list[str] = []
    # stochastic columns (karpenter_tpu/stochastic): collected only when
    # the pool overcommits — the deterministic encode allocates nothing
    overcommit_eps = float(getattr(nodepool, "overcommit", 0.0) or 0.0)
    stochastic = overcommit_eps > 0.0
    g_mean: list[tuple[int, ...]] = []
    g_var: list[tuple[int, ...]] = []
    gang_ids: dict[str, int] = {}          # gang name -> interned id
    row_keys: dict[tuple, int] = {}
    rows: list[np.ndarray] = []
    pref_row_keys: dict[bytes, int] = {}
    pref_rows_l: list[np.ndarray] = []

    def pref_for(terms, total_w, soft_zone) -> int:
        row = _pref_miss_row(terms, total_w, soft_zone, catalog)
        if row is None:
            return -1
        key = row.tobytes()
        pi = pref_row_keys.get(key)
        if pi is None:
            pi = len(pref_rows_l)
            pref_rows_l.append(row)
            pref_row_keys[key] = pi
        return pi
    cache_ok = nodepool is _DEFAULT_POOL
    gen_key = (catalog.uid, catalog.generation, catalog.availability_generation)
    if cache_ok:
        _sig_cache_admit(gen_key)

    def row_for(label, zone_sig, pinned_zone, requirements) -> int:
        # the label-row dedup key is CONTENT-keyed on the label mask
        # (id() keys would emit duplicate rows when
        # _SIG_LOWER_CACHE serves older array objects); label masks are
        # interned per constraint set within an encode, so tobytes() runs
        # once per distinct combination, not per group
        key = (id(label), zone_sig, pinned_zone)
        ui = row_keys.get(key)
        if ui is None:
            zone_mask = _allowed_mask(requirements, LABEL_ZONE,
                                      catalog.zones, mask_cache).copy()
            if pinned_zone is not None:
                zone_mask &= np.array([z == pinned_zone
                                       for z in catalog.zones])
            row = label & zone_mask[catalog.off_zone]
            ckey = (row.tobytes(),)
            ui = row_keys.get(ckey)
            if ui is None:
                ui = len(rows)
                rows.append(row)
                row_keys[ckey] = ui
            row_keys[key] = ui
        return ui

    # affinity plane, zone scope: inter-group required/anti zone edges
    # need their co-pin decided BEFORE per-signature lowering (the pin
    # feeds the zone-affinity branch below).  Windows with no zone-scope
    # affinity term skip this entirely, so the legacy encode stays
    # byte-identical.  Gang and hard-spread signatures are never pinned
    # here (all-or-nothing / split semantics win; the decode choke keeps
    # any surviving zone edge honest).
    aff_zone_pins: dict[int, str] = {}
    if any(t.topology_key == ZONE_TOPOLOGY_KEY
           for mem in by_sig.values() for t in mem[0].affinity):
        zone_sels = [t.label_selector for mem in by_sig.values()
                     for t in mem[0].affinity
                     if t.topology_key == ZONE_TOPOLOGY_KEY]
        pin_entries = []
        for s, mem in by_sig.items():
            rep0 = mem[0]
            lab0 = rep0.labels_dict
            involved = any(t.topology_key == ZONE_TOPOLOGY_KEY
                           for t in rep0.affinity) \
                or any(sel and all(lab0.get(k) == v for k, v in sel)
                       for sel in zone_sels)
            if not involved or rep0.gang is not None \
                    or _zone_spread_constraints(rep0):
                continue
            reqs0 = rep0.scheduling_requirements().merged(
                nodepool.requirements)
            if any(r.key not in known_keys and not r.matches(pool_labels)
                   for r in reqs0):
                continue          # unschedulable here; rejected below
            req_vec0 = rep0.requests.as_tuple()
            label0 = _label_compat(reqs0, catalog, mask_cache)
            nozone0 = label0 & _fit_mask(req_vec0, catalog)
            vz0 = viable_zones(reqs0, req_vec0, catalog, nozone=nozone0,
                               cache=mask_cache)
            pin_entries.append((s, lab0, list(rep0.affinity), list(vz0)))
        aff_zone_pins = zone_pin_prepass(pin_entries)

    for sig, members in by_sig.items():
        rep = members[0]
        hit = _SIG_LOWER_CACHE.get((sig,) + gen_key) if cache_ok else None
        if hit is not None:
            (reqs, unsat_flag, cap, label, nozone, live_zones, zone_sig,
             pref) = hit
            if unsat_flag:
                for p in members:
                    key = pod_key(p)
                    rejected.append(key)
                    rej_reasons[key] = "requirements"
                continue
        else:
            reqs = rep.scheduling_requirements().merged(nodepool.requirements)
            # requirements on keys the catalog can't express must be
            # satisfied by static nodepool labels, else the group is
            # unschedulable here
            unsat = [r for r in reqs
                     if r.key not in known_keys and not r.matches(pool_labels)]
            cap = 1 if _has_hostname_anti_affinity(rep) else BIG_CAP
            # empty-selector hostname spread (DoNotSchedule) self-selects
            # the group: lower straight onto cap_per_node (no plane)
            hcap = hostname_cap(rep)
            if hcap is not None:
                cap = min(cap, hcap)
            req_vec = rep.requests.as_tuple()
            if unsat:
                if cache_ok:
                    _SIG_LOWER_CACHE[(sig,) + gen_key] = (reqs, True, cap,
                                                          None, None, None,
                                                          None, None)
                for p in members:
                    key = pod_key(p)
                    rejected.append(key)
                    rej_reasons[key] = "requirements"
                continue
            label = _label_compat(reqs, catalog, mask_cache)
            nozone = label & _fit_mask(req_vec, catalog)
            live_zones = viable_zones(reqs, req_vec, catalog, nozone=nozone,
                                      cache=mask_cache)
            zone_sig = tuple(sorted(r.signature
                                    for r in reqs.get(LABEL_ZONE)))
            pref = _lower_preferred(rep.preferred_requirements, catalog,
                                    mask_cache) \
                if rep.preferred_requirements else ([], 0)
            if cache_ok:
                _SIG_LOWER_CACHE[(sig,) + gen_key] = (reqs, False, cap,
                                                      label, nozone,
                                                      live_zones, zone_sig,
                                                      pref)
        req = rep.requests.as_tuple()
        # every pod occupies >=1 pod slot: keeps per-node assignment
        # counts bounded by the offering's pod-slot allocatable
        req_row = (req[0], req[1], req[2], max(req[3], 1))
        if stochastic:
            mean_row, var_row = usage_rows(rep)
        else:
            mean_row = var_row = ()   # never appended
        cap_i32 = min(cap, np.iinfo(np.int32).max)
        pref_terms, pref_w = pref
        if rep.gang is not None:
            gang_id = gang_ids.setdefault(rep.gang.name, len(gang_ids))
            gang_min = rep.gang.min_member
        else:
            gang_id, gang_min = -1, 0

        def split_subgroups(zones, pinned: bool):
            """Per-zone even split (skew <= 1) shared by the HARD spread
            (DoNotSchedule: subgroups zone-PINNED into compat) and the
            SOFT spread (ScheduleAnyway: subgroups zone-PREFERRED via a
            penalty term — capacity shortfall degrades spread instead of
            stranding pods; soft terms become cost)."""
            counts = _split_counts(len(members), len(zones))
            offset = 0
            for zone, cnt in zip(zones, counts):
                if cnt == 0:
                    continue
                sub = members[offset:offset + cnt]
                offset += cnt
                groups.append(PodGroup(
                    representative=rep, pod_names=[pod_key(p) for p in sub],
                    count=cnt,
                    requirements=Requirements(list(reqs.items)) if pinned
                    else reqs,
                    cap_per_node=cap,
                    pinned_zone=zone if pinned else None,
                    spread_origin=sig, nozone_mask=nozone,
                    label_mask=label))
                g_req.append(req_row)
                g_count.append(cnt)
                g_cap.append(cap_i32)
                g_label.append(row_for(label, zone_sig,
                                       zone if pinned else None, reqs))
                g_pref.append(pref_for(pref_terms, pref_w,
                                       None if pinned else zone))
                g_prio.append(rep.priority)
                g_gang.append(gang_id)
                g_min.append(gang_min)
                g_name.append(groups[-1].pod_names[0])
                if stochastic:
                    g_mean.append(mean_row)
                    g_var.append(var_row)

        spread = _zone_spread_constraints(rep)
        aff_pin = aff_zone_pins.get(sig)
        if aff_pin is not None and aff_pin not in live_zones:
            aff_pin = None        # stale pin: catalog moved under us
        if rep.gang is not None:
            # gang members place all-or-nothing: never spread-split or
            # zone-candidate-split a gang — co-placement is the contract
            # (zone requirements still apply through the label row)
            groups.append(PodGroup(
                representative=rep, pod_names=[pod_key(p) for p in members],
                count=len(members), requirements=reqs, cap_per_node=cap,
                nozone_mask=nozone, label_mask=label))
            g_req.append(req_row)
            g_count.append(len(members))
            g_cap.append(cap_i32)
            g_label.append(row_for(label, zone_sig, None, reqs))
            g_pref.append(pref_for(pref_terms, pref_w, None))
            g_prio.append(rep.priority)
            g_gang.append(gang_id)
            g_min.append(gang_min)
            g_name.append(groups[-1].pod_names[0])
            if stochastic:
                g_mean.append(mean_row)
                g_var.append(var_row)
        elif spread and len(live_zones) > 1:
            split_subgroups(live_zones, pinned=True)
        elif (aff_pin is not None or _has_zone_affinity(rep)) \
                and len(live_zones) > 1:
            # co-schedule in one zone: an affinity-plane component pin
            # wins (inter-group zone edges co-route through one zone),
            # then an explicit candidate override (zonesplit refinement);
            # default pin is the zone with the most compatible offering
            # capacity (v1 heuristic; validator checks zone purity
            # either way)
            override = zone_overrides.get(sig)
            if aff_pin is not None:
                best = aff_pin
            else:
                best = override if override in live_zones else \
                    _best_zone_for(rep, reqs, live_zones, catalog)
            groups.append(PodGroup(
                representative=rep, pod_names=[pod_key(p) for p in members],
                count=len(members), requirements=reqs, cap_per_node=cap,
                pinned_zone=best, nozone_mask=nozone, label_mask=label))
            g_req.append(req_row)
            g_count.append(len(members))
            g_cap.append(cap_i32)
            g_label.append(row_for(label, zone_sig, best, reqs))
            g_pref.append(pref_for(pref_terms, pref_w, None))
            g_prio.append(rep.priority)
            g_gang.append(gang_id)
            g_min.append(gang_min)
            g_name.append(groups[-1].pod_names[0])
            if stochastic:
                g_mean.append(mean_row)
                g_var.append(var_row)
        elif _soft_zone_spread(rep) and len(live_zones) > 1:
            # soft spread ranks BELOW hard spread and below zone
            # co-scheduling affinity (a hard term must never be diluted
            # into a preference by the presence of a soft one)
            split_subgroups(live_zones, pinned=False)
        else:
            groups.append(PodGroup(
                representative=rep, pod_names=[pod_key(p) for p in members],
                count=len(members), requirements=reqs, cap_per_node=cap,
                nozone_mask=nozone, label_mask=label))
            g_req.append(req_row)
            g_count.append(len(members))
            g_cap.append(cap_i32)
            g_label.append(row_for(label, zone_sig, None, reqs))
            g_pref.append(pref_for(pref_terms, pref_w, None))
            g_prio.append(rep.priority)
            g_gang.append(gang_id)
            g_min.append(gang_min)
            g_name.append(groups[-1].pod_names[0])
            if stochastic:
                g_mean.append(mean_row)
                g_var.append(var_row)

    # 4. FFD order: descending PRIORITY first (preemption semantics:
    # under scarcity, every backend spends capacity on high-priority
    # groups before lower ones — placement becomes priority-aware with
    # no extra device work), then descending dominant size, deterministic
    # tie-break on first pod name — one vectorized lexsort over per-group
    # arrays.  All-default-priority windows sort exactly as before.
    G, O = len(groups), catalog.num_offerings
    mean_alloc = catalog.type_alloc.mean(axis=0) if catalog.num_types else \
        np.ones(NUM_RESOURCES)
    group_req = np.asarray(g_req, dtype=np.int32).reshape(G, NUM_RESOURCES)
    group_count = np.asarray(g_count, dtype=np.int32)
    group_cap = np.asarray(g_cap, dtype=np.int32)
    label_idx = np.asarray(g_label, dtype=np.int32)
    pref_idx = np.asarray(g_pref, dtype=np.int32)
    group_prio = np.asarray(g_prio, dtype=np.int32)
    group_gang = np.asarray(g_gang, dtype=np.int32)
    group_min = np.asarray(g_min, dtype=np.int32)
    group_mean = group_var = None
    if stochastic:
        from karpenter_tpu_torch.stochastic.encode import stack_usage

        group_mean, group_var = stack_usage(g_mean, g_var)
    # affinity plane: lower the window's (anti-)affinity terms and
    # bounded hostname spread classes to the dense index.  None for
    # edge-free windows — every path below then matches the legacy
    # encode byte for byte.
    aff_index = build_affinity_index(
        [g.representative for g in groups]) if G else None
    if G:
        shares = np.where(mean_alloc[None, :] > 0,
                          group_req.astype(np.float64)
                          / np.maximum(mean_alloc, 1e-12)[None, :],
                          0.0).max(axis=1)
        if aff_index is not None:
            # required-edge TARGETS place first (ascending req_depth as
            # the primary key): required groups never open nodes in the
            # kernel, so their targets must already be resident by the
            # time the scan reaches them
            order = np.lexsort((np.asarray(g_name), -shares,
                                -group_prio.astype(np.int64),
                                aff_index.req_depth))
        else:
            order = np.lexsort((np.asarray(g_name), -shares,
                                -group_prio.astype(np.int64)))
        groups = [groups[i] for i in order]
        group_req = np.ascontiguousarray(group_req[order])
        group_count = group_count[order]
        group_cap = group_cap[order]
        label_idx = label_idx[order]
        pref_idx = pref_idx[order]
        group_prio = np.ascontiguousarray(group_prio[order])
        group_gang = np.ascontiguousarray(group_gang[order])
        group_min = np.ascontiguousarray(group_min[order])
        if stochastic:
            group_mean = np.ascontiguousarray(group_mean[order])
            group_var = np.ascontiguousarray(group_var[order])
        if aff_index is not None:
            aff_index = aff_index.permute(order)
            from karpenter_tpu_torch.utils import metrics as _metrics
            _metrics.AFFINITY_EDGES.set(aff_index.edge_count)
            _vals, _sizes = np.unique(aff_index.comp, return_counts=True)
            _metrics.AFFINITY_COMPONENTS.set(int((_sizes > 1).sum()))

    label_rows = (np.stack(rows) if rows
                  else np.zeros((0, O), dtype=bool))
    has_pref = bool(pref_rows_l)
    # compat (label row & per-group resource fit) stays LAZY — the
    # device rebuilds it from this exact factoring, and host consumers
    # force it on demand (EncodedProblem.compat)
    return EncodedProblem(
        groups=groups, group_req=group_req, group_count=group_count,
        group_cap=group_cap, compat=None, catalog=catalog,
        rejected=rejected, label_rows=label_rows, label_idx=label_idx,
        pref_rows=np.stack(pref_rows_l) if has_pref else None,
        pref_idx=pref_idx if has_pref else None, group_prio=group_prio,
        group_gang=group_gang, group_min=group_min,
        gang_names=list(gang_ids), rejected_reasons=rej_reasons,
        group_mean=group_mean, group_var=group_var,
        overcommit_eps=overcommit_eps if stochastic else 0.0,
        aff=aff_index)


def estimate_nodes(problem: EncodedProblem, n_cap: int,
                   buckets: Sequence[int]) -> int:
    """Static node-axis size: 2x the bin-packing lower bound (total demand
    / best single-node capacity) plus headroom; FFD never exceeds ~1.7x LB,
    and solver backends escalate on overflow anyway."""
    from karpenter_tpu_torch.solver.types import bucket

    catalog = problem.catalog
    if catalog.num_offerings == 0:
        return min(64, n_cap)
    tot = (problem.group_req.astype(np.int64)
           * problem.group_count[:, None]).sum(axis=0)            # [R]
    best = catalog.offering_alloc().max(axis=0).astype(np.int64)  # [R]
    lb = int(np.max(np.ceil(tot / np.maximum(best, 1))))
    # per-node-capped groups (anti-affinity) need >= count/cap nodes;
    # cap == 0 rows are padding (count 0), not a real constraint
    capped = (problem.group_cap < BIG_CAP) & (problem.group_cap > 0)
    if capped.any():
        lb = max(lb, int(np.max(np.ceil(
            problem.group_count[capped] / problem.group_cap[capped]))))
    return min(n_cap, bucket(max(2 * lb + 32, 64), buckets))


def decode_plan(problem: EncodedProblem, node_off: np.ndarray,
                assign: np.ndarray, unplaced: np.ndarray, cost: float,
                backend: str, reason_words: np.ndarray | None = None):
    """Shared dense-result -> Plan decoding (every backend emits the same
    (node_off, assign, unplaced) contract).

    Vectorized over the assign nonzeros: the naive per-node x per-group
    cursor walk is O(nodes x groups) Python — 20M iterations at the
    heterogeneous 10k-group regime (measured 12.4 s, dominating the
    solve wall).  The cursor semantics (each group's pod_names consumed
    in node-ascending order) reproduce exactly: entry offsets are
    per-group exclusive cumsums over the node-ascending entry order."""
    G = len(problem.groups)
    gis, ns = np.nonzero((assign[:G] > 0) & (node_off >= 0)[None, :])
    cnts = assign[gis, ns].astype(np.int64)
    return decode_plan_entries(problem, node_off, gis, ns, cnts, unplaced,
                               cost, backend, reason_words=reason_words)


def _names_index(problem: EncodedProblem):
    """(names_arr object [P], gstart int64 [G+1]): every group's
    pod_names concatenated group-major, with per-group start offsets —
    built once per problem so decode gathers pod names with numpy fancy
    indexing instead of per-entry Python list slicing."""
    cached = problem._names_idx
    if cached is None:
        sizes = np.fromiter((len(g.pod_names) for g in problem.groups),
                            np.int64, len(problem.groups))
        gstart = np.zeros(len(problem.groups) + 1, np.int64)
        np.cumsum(sizes, out=gstart[1:])
        names_arr = np.empty(int(gstart[-1]), object)
        for gi, g in enumerate(problem.groups):
            names_arr[gstart[gi]:gstart[gi + 1]] = g.pod_names
        cached = (names_arr, gstart)
        problem._names_idx = cached
    return cached


def _enforce_gangs(problem: EncodedProblem, node_off: np.ndarray,
                   gis: np.ndarray, ns: np.ndarray, cnts: np.ndarray,
                   cost: float):
    """Vectorized all-or-nothing gang enforcement over COO entries.

    A gang is *partial* when its placed member count is positive but
    below its total pending membership (or its membership never reached
    ``min_member``).  Partial gangs' entries are dropped — their counts
    return to the caller as ``(group indices, counts)`` for the
    per-group unplaced tally — and any node left with NO entries is
    closed (``node_off`` -1) with its price subtracted from ``cost``:
    a node opened solely for a half-placed gang must not be created.

    Returns ``(node_off, gis, ns, cnts, dropped_or_None, cost)``.
    """
    G = len(problem.groups)
    gg = problem.group_gang
    gmask = gg[:G] >= 0
    if not gmask.any():
        return node_off, gis, ns, cnts, None, cost
    ngang = len(problem.gang_names)
    gang_of = gg[:G][gmask].astype(np.int64)
    total = np.zeros(ngang, np.int64)
    np.add.at(total, gang_of, problem.group_count[:G][gmask].astype(np.int64))
    minm = np.zeros(ngang, np.int64)
    np.maximum.at(minm, gang_of, problem.group_min[:G][gmask].astype(np.int64))
    entry_gang = gg[gis]
    e = entry_gang >= 0
    placed = np.zeros(ngang, np.int64)
    np.add.at(placed, entry_gang[e], cnts[e].astype(np.int64))
    bad = (placed > 0) & ((placed < total) | (total < minm))
    if not bad.any():
        return node_off, gis, ns, cnts, None, cost
    drop = e & bad[np.clip(entry_gang, 0, None)]
    dropped = (gis[drop], cnts[drop].astype(np.int64))
    dead = np.setdiff1d(np.unique(ns), np.unique(ns[~drop]),
                        assume_unique=True)
    if dead.size:
        node_off = np.array(node_off, copy=True)
        cost = float(cost) - float(
            problem.catalog.off_price[node_off[dead]].sum())
        node_off[dead] = -1
    return node_off, gis[~drop], ns[~drop], cnts[~drop], dropped, cost


def decode_plan_entries(problem: EncodedProblem, node_off: np.ndarray,
                        gis: np.ndarray, ns: np.ndarray, cnts: np.ndarray,
                        unplaced: np.ndarray, cost: float, backend: str,
                        reason_words: np.ndarray | None = None):
    """COO form of :func:`decode_plan`: assignment entries (group gi,
    node n, pod count) in any order.  The flat solver and the pipelined
    solve path decode straight from device COO without densifying the
    [G, N] matrix (a 256 MB allocation per solve at the heterogeneous
    10k-group shape); the classic sync path (`unpack_result`) still
    densifies for its dense-contract consumers (sidecar wire format).

    Fully vectorized: pod names are gathered through the per-problem
    names index (one object-array fancy index), split per node by a
    stable node sort that preserves the gi-major cursor order the
    reference's walk produced."""
    from karpenter_tpu_torch.solver.types import Plan, PlannedNode

    catalog = problem.catalog
    groups = problem.groups
    G = len(groups)
    keep = (gis < G) & (node_off[ns] >= 0) & (cnts > 0)
    if not keep.all():
        gis, ns, cnts = gis[keep], ns[keep], cnts[keep]
    if problem.has_gangs and gis.size:
        # no-partial-gang choke point: every dense backend decodes
        # through here, so a plan carrying a strict subset of a gang's
        # members (or a sub-min_member gang) is structurally impossible
        # downstream of this line — the dropped members return to
        # unplaced and nodes emptied by the drop are closed (their cost
        # leaves the plan).  The greedy host oracle enforces the same
        # invariant transactionally; solver/validate.py re-checks it
        # independently (the three-layer pattern, docs/design/gang.md).
        node_off, gis, ns, cnts, cnts_dropped, cost = _enforce_gangs(
            problem, node_off, gis, ns, cnts, cost)
        if cnts_dropped is not None:
            up = np.zeros(G, dtype=np.int64)
            m = min(G, len(unplaced))
            up[:m] = np.asarray(unplaced[:m], dtype=np.int64)
            np.add.at(up, cnts_dropped[0], cnts_dropped[1])
            unplaced = up
    if problem.aff is not None and gis.size:
        # affinity choke point (same contract as the gang choke above):
        # edge-violating entries are dropped and hostname spread bounds
        # clamped, whichever route produced the plan
        from karpenter_tpu_torch.affinity.enforce import enforce_affinity

        node_off, gis, ns, cnts, aff_dropped, cost = enforce_affinity(
            problem, node_off, gis, ns, cnts, cost)
        if aff_dropped is not None:
            up = np.zeros(G, dtype=np.int64)
            m = min(G, len(unplaced))
            up[:m] = np.asarray(unplaced[:m], dtype=np.int64)
            np.add.at(up, aff_dropped[0], aff_dropped[1])
            unplaced = up
    open_idx = np.nonzero(node_off >= 0)[0]
    per_node: dict[int, list[str]] = {}
    if gis.size:
        # per-group exclusive cumsum = each entry's start offset into its
        # group's pod_names; entries must be gi-major with node-ascending
        # order within a group for the offsets to reproduce the
        # reference's cursor walk — lexsort makes that true for any order
        reorder = np.lexsort((ns, gis))
        g_s = gis[reorder]
        cnt_s = cnts[reorder].astype(np.int64)
        csum_s = np.cumsum(cnt_s) - cnt_s             # exclusive, global
        first = np.zeros(g_s.size, dtype=bool)
        first[0] = True
        first[1:] = g_s[1:] != g_s[:-1]
        group_base = np.repeat(csum_s[first], np.diff(
            np.concatenate([np.nonzero(first)[0], [g_s.size]])))
        starts_s = csum_s - group_base                # offset within group
        names_arr, gstart = _names_index(problem)
        src_start_s = gstart[g_s] + starts_s          # into names_arr
        key = ns.astype(np.int64) * G + gis           # input entry order
        if key.size < 2 or (np.diff(key) > 0).all():
            # fast path — the device COO is emitted n-major already
            # (idx = n*G + g ascending): invert the ENTRY permutation
            # (nnz-sized) instead of re-sorting at POD granularity, and
            # node boundaries fall out of the ns runs.  Within a node,
            # entries are gi-ascending either way, so pod order matches
            # the general path exactly.
            src_start = np.empty_like(src_start_s)
            src_start[reorder] = src_start_s
            cnt64 = cnts.astype(np.int64)
            ecs = np.cumsum(cnt64) - cnt64
            total = int(ecs[-1] + cnt64[-1])
            flat_src = np.repeat(src_start - ecs, cnt64) \
                + np.arange(total, dtype=np.int64)
            names_sorted = names_arr[flat_src]
            efirst = np.zeros(ns.size, dtype=bool)
            efirst[0] = True
            efirst[1:] = ns[1:] != ns[:-1]
            fidx = np.nonzero(efirst)[0]
            uniq = ns[fidx]
            bounds = np.append(ecs[fidx], total)
        else:
            total = int(csum_s[-1] + cnt_s[-1])
            # entry e covers names_arr[src_start_s[e]:...+cnt_s[e]]
            flat_src = np.repeat(src_start_s - csum_s, cnt_s) \
                + np.arange(total, dtype=np.int64)
            pod_node = np.repeat(ns[reorder], cnt_s)
            order2 = np.argsort(pod_node, kind="stable")  # keeps gi order
            names_sorted = names_arr[flat_src[order2]]
            node_sorted = pod_node[order2]
            uniq, firsts = np.unique(node_sorted, return_index=True)
            bounds = np.append(firsts, total)
        # ONE object-array -> list conversion, then C-speed list slices
        # per node (240 per-node .tolist() calls cost ~3x more)
        all_names = names_sorted.tolist()
        bl = bounds.tolist()
        per_node = {n: all_names[bl[i]:bl[i + 1]]
                    for i, n in enumerate(uniq.tolist())}
    offs = node_off[open_idx]
    num_off = catalog.num_offerings
    in_range = offs < num_off
    itypes, zones, captypes, prices = catalog.describe_offerings(
        np.minimum(offs, max(num_off - 1, 0)))
    get = per_node.get
    in_range_l = in_range.tolist()
    offs_l = offs.tolist()
    nodes: list = [
        PlannedNode(it, z, ct, pr if ok else 0.0, get(n, []), off)
        for n, off, it, z, ct, pr, ok in zip(
            open_idx.tolist(), offs_l, itypes, zones, captypes, prices,
            in_range_l)]
    unplaced_names: list[str] = list(problem.rejected)
    miss = np.asarray(unplaced[:G])
    for gi in np.nonzero(miss > 0)[0].tolist():
        g = groups[gi]
        m = int(miss[gi])
        unplaced_names.extend(g.pod_names[len(g.pod_names) - m:])
    plan = Plan(nodes=nodes, unplaced_pods=unplaced_names,
                total_cost_per_hour=float(cost), backend=backend)
    if unplaced_names:
        # fold the device reason words (or the host oracle, when the
        # path carries none) into per-pod canonical reasons — the
        # explain fold is a no-op for fully-placed windows
        from karpenter_tpu_torch.explain.decode import attach

        attach(problem, plan, reason_words, miss=miss)
    return plan


def _best_zone_for(pod: PodSpec, reqs: Requirements, zones: list[str],
                   catalog: CatalogArrays) -> str:
    """Zone with the most offering capacity compatible with the pod."""
    req = np.asarray(pod.requests.as_tuple(), dtype=np.int64)
    off_alloc = catalog.offering_alloc().astype(np.int64)
    fits = (off_alloc >= req[None, :]).all(axis=1) & catalog.off_avail
    best, best_cap = zones[0], -1
    for z in zones:
        zi = catalog.zones.index(z)
        cap = int((fits & (catalog.off_zone == zi)).sum())
        if cap > best_cap:
            best, best_cap = z, cap
    return best
