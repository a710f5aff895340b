"""Slice topology: per-type torus dims -> placement bitmask tables
(port of ``karpenter_tpu/gang/topology.py``).

The catalog carries each instance type's accelerator torus dims
(``CatalogArrays.type_torus``).  This module lowers a gang's
``slice_shape`` against those tori once into dense bitmask tensors:

- every *placement* of shape ``s`` in torus ``t`` (axis-aligned
  contiguous sub-block, every distinct axis permutation of ``s`` that
  fits, no wraparound) becomes one uint64 chip bitmask;
- per catalog + shape, the placements of every offering stack into a
  padded ``masks uint64 [O, Pmax]`` + ``valid bool [O, Pmax]`` table
  (:class:`SliceTable`), cached per catalog generation.

"Does offering ``o`` still fit shape ``s`` under occupancy ``occ``" is
then one batched AND over the ``[offerings, placements]`` grid, which
the planner's torch route runs as two int32 words per mask
(:func:`split_mask_words`).  Tori are capped at 64 chips so one mask
word covers any placement; a larger torus exposes no placements.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.catalog.arrays import CatalogArrays

MAX_TORUS_CHIPS = 64

# (torus dims, shape) -> tuple of placement masks; both keys are tiny
# tuples, and distinct (torus, shape) pairs number in the dozens — the
# enumeration is pure combinatorics, valid forever
_PLACEMENT_CACHE: dict[tuple, tuple[int, ...]] = {}
# (torus dims, mask) -> rank-ordered global chip ids (pure geometry)
_RANK_CACHE: dict[tuple, tuple[int, ...]] = {}
_RANK_CACHE_MAX = 4096
# (catalog uid, generation, shape) -> SliceTable
_TABLE_CACHE: dict[tuple, "SliceTable"] = {}
_TABLE_CACHE_MAX = 32


@dataclass(frozen=True)
class SliceTable:
    """Padded per-offering placement bitmasks for ONE slice shape."""

    shape: tuple[int, ...]
    masks: np.ndarray        # uint64 [O, Pmax]; 0 where invalid
    valid: np.ndarray        # bool   [O, Pmax]
    count: np.ndarray        # int32  [O] valid placements per offering
    # optimal rank-assignment max-hop per placement (the rank-aware
    # scoring term: the planner picks the free placement minimizing
    # (hop, index) — one more batched column over the same grid, zero
    # extra dispatches); 0 where invalid (masked by ``valid`` first)
    hops: np.ndarray = None  # int32 [O, Pmax]

    @property
    def pmax(self) -> int:
        return int(self.masks.shape[1])

    def free_grid(self, occupancy: np.ndarray) -> np.ndarray:
        """bool [O, Pmax]: placement p of offering o is valid and chip-
        disjoint from ``occupancy`` (uint64 [O]), the batched fit test."""
        return self.valid & ((self.masks & occupancy[:, None]) == 0)

    def fits(self, occupancy: np.ndarray) -> np.ndarray:
        """bool [O]: some placement is still free under ``occupancy``."""
        return self.free_grid(occupancy).any(axis=1)


def _chip_index(dims: tuple[int, ...]) -> np.ndarray:
    """Row-major chip numbering of the torus grid."""
    return np.arange(math.prod(dims)).reshape(dims)


def enumerate_placements(torus: tuple[int, ...],
                         shape: tuple[int, ...]) -> tuple[int, ...]:
    """Every contiguous axis-aligned placement of ``shape`` in ``torus``
    as chip bitmasks, deduplicated, ascending — the deterministic order
    every planner path and the validator share.

    Distinct axis permutations of ``shape`` count as distinct
    orientations (a 2x4 job fits a 4x2 window); wraparound placements
    are excluded (a production slice must be physically contiguous).
    """
    if not torus or math.prod(torus) > MAX_TORUS_CHIPS:
        return ()
    key = (torus, shape)
    hit = _PLACEMENT_CACHE.get(key)
    if hit is not None:
        return hit
    idx = _chip_index(torus)
    masks: set[int] = set()
    for perm in sorted(set(itertools.permutations(shape))):
        if len(perm) > len(torus):
            continue
        # right-align the shape onto the torus axes, leading axes size 1
        full = (1,) * (len(torus) - len(perm)) + perm
        if any(s > t for s, t in zip(full, torus)):
            continue
        origins = [range(t - s + 1) for s, t in zip(full, torus)]
        for origin in itertools.product(*origins):
            block = idx[tuple(slice(o, o + s)
                              for o, s in zip(origin, full))]
            mask = 0
            for c in block.ravel().tolist():
                mask |= 1 << c
            masks.add(mask)
    out = tuple(sorted(masks))
    _PLACEMENT_CACHE[key] = out
    return out


def type_placements(catalog: CatalogArrays, t: int,
                    shape: tuple[int, ...]) -> tuple[int, ...]:
    """Placement masks of ``shape`` on type ``t``'s torus (possibly ())."""
    tori = catalog.type_torus
    torus = tori[t] if t < len(tori) else ()
    return enumerate_placements(tuple(torus), shape)


def slice_table(catalog: CatalogArrays,
                shape: tuple[int, ...]) -> SliceTable:
    """The ``[offerings, placements]`` bitmask table for ``shape``,
    memoized per catalog generation (offerings of one type share that
    type's placements; the table is availability-independent — blackouts
    gate *creates*, not geometry)."""
    key = (catalog.uid, catalog.generation, shape)
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    per_type = [type_placements(catalog, t, shape)
                for t in range(catalog.num_types)]
    tori = catalog.type_torus
    # hop bounds memoized PER TYPE (offerings of one type share its
    # placement list — recomputing per offering would multiply the cold
    # build by zones x capacity-types)
    per_type_hops = []
    for t, plc in enumerate(per_type):
        torus = tuple(tori[t]) if t < len(tori) else ()
        per_type_hops.append([optimal_max_hop(_block_dims(torus, m))
                              for m in plc])
    pmax = max((len(p) for p in per_type), default=0)
    O = catalog.num_offerings
    masks = np.zeros((O, max(pmax, 1)), dtype=np.uint64)
    valid = np.zeros((O, max(pmax, 1)), dtype=bool)
    hops = np.zeros((O, max(pmax, 1)), dtype=np.int32)
    for o in range(O):
        t = int(catalog.off_type[o])
        plc = per_type[t]
        if plc:
            masks[o, :len(plc)] = np.array(plc, dtype=np.uint64)
            valid[o, :len(plc)] = True
            hops[o, :len(plc)] = per_type_hops[t]
    table = SliceTable(shape=shape, masks=masks, valid=valid,
                       count=valid.sum(axis=1).astype(np.int32),
                       hops=hops)
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.pop(next(iter(_TABLE_CACHE)))
    _TABLE_CACHE[key] = table
    return table


def clear_topology_cache() -> None:
    """Test hook: drop every cached placement table."""
    _PLACEMENT_CACHE.clear()
    _TABLE_CACHE.clear()
    _RANK_CACHE.clear()


# ---------------------------------------------------------------------------
# Rank-aware placement: rank -> chip assignment within a chosen slice
# ---------------------------------------------------------------------------
#
# MPI-style gangs communicate ring-wise (rank i <-> rank i±1, wrapping
# n-1 <-> 0 for n >= 3); the assignment quality metric is the MAXIMUM
# hop distance (Manhattan, on the physical grid — placements are
# contiguous sub-blocks, never wrapped) between any communicating rank
# pair.  The constructive optimum over an a×b×[c] block:
#
# - n <= 2 chips: hop = n - 1 trivially;
# - >= 2 effective axes AND n even: a Hamiltonian cycle of the block
#   exists (grid graphs: cycle iff the vertex count is even) -> every
#   hop is 1, which is minimal;
# - otherwise (one effective axis with n >= 3, or all axes odd — note
#   all-odd => n odd): the block's grid graph is bipartite with unequal
#   color classes (or a path), so no Hamiltonian cycle exists and some
#   hop must be >= 2; the even/odd skip ordering over the snake path
#   achieves exactly 2.
#
# So the construction below is provably optimal, and the
# independent validator recounts the hop bound from the emitted
# assignment (solver/validate.py).


def _snake_path(dims: tuple[int, ...]) -> list[tuple[int, ...]]:
    """Boustrophedon Hamiltonian PATH over the block: consecutive
    coords are always grid-adjacent (hop 1); no wrap guarantee."""
    coords = [()]
    for d in dims:
        nxt = []
        for i, prefix in enumerate(coords):
            rng = range(d) if i % 2 == 0 else range(d - 1, -1, -1)
            nxt.extend(prefix + (k,) for k in rng)
        coords = nxt
    return coords


def _ham_cycle_2d(a: int, b: int) -> list[tuple[int, int]]:
    """Hamiltonian cycle of the a×b grid, ``a`` even: down column 0,
    then boustrophedon back up through columns 1..b-1 (ends at (0, 1),
    adjacent to the start)."""
    cyc = [(r, 0) for r in range(a)]
    for i, r in enumerate(range(a - 1, -1, -1)):
        cols = range(1, b) if i % 2 == 0 else range(b - 1, 0, -1)
        cyc.extend((r, c) for c in cols)
    return cyc


def _ham_cycle(dims: tuple[int, ...]) -> list[tuple[int, ...]]:
    """Hamiltonian cycle of the block (every dim >= 2, even vertex
    count).  2D: direct construction; 3D: a 2D cycle over the two axes
    whose product is even, extruded as alternating up/down columns
    along the third."""
    if len(dims) == 2:
        a, b = dims
        if a % 2 == 0:
            return _ham_cycle_2d(a, b)
        return [(r, c) for c, r in _ham_cycle_2d(b, a)]
    # 3D: rotate axes so the LAST TWO have an even product
    order = (0, 1, 2)
    if dims[1] * dims[2] % 2:
        order = (1, 0, 2) if dims[0] * dims[2] % 2 == 0 else (2, 0, 1)
    d = tuple(dims[i] for i in order)
    plane = _ham_cycle(d[1:])                       # even length m
    cyc3 = []
    for j, p in enumerate(plane):
        zs = range(d[0]) if j % 2 == 0 else range(d[0] - 1, -1, -1)
        cyc3.extend((z,) + p for z in zs)
    inv = [0] * 3
    for i, o in enumerate(order):
        inv[o] = i
    return [tuple(c[inv[i]] for i in range(3)) for c in cyc3]


def rank_order_coords(dims: tuple[int, ...]) -> list[tuple[int, ...]]:
    """Block coords in rank order, minimizing the max ring hop (the
    constructive optimum documented above)."""
    import math

    n = math.prod(dims) if dims else 1
    if n <= 2:
        return _snake_path(dims)
    eff = [d for d in dims if d > 1]
    if len(eff) >= 2 and n % 2 == 0:
        cyc = _ham_cycle(tuple(eff))
        # re-embed collapsed size-1 axes
        out = []
        for c in cyc:
            it = iter(c)
            out.append(tuple(next(it) if d > 1 else 0 for d in dims))
        return out
    # skip ordering over the snake path: consecutive ranks are path
    # distance <= 2 apart, both junctions are path neighbors -> max 2
    path = _snake_path(dims)
    return path[0::2] + path[1::2][::-1]


def optimal_max_hop(dims: tuple[int, ...]) -> int:
    """The provable optimum of the max ring hop for a block of ``dims``
    (see the construction notes above)."""
    import math

    n = math.prod(dims) if dims else 1
    if n <= 1:
        return 0
    if n == 2:
        return 1
    eff = sum(1 for d in dims if d > 1)
    return 1 if (eff >= 2 and n % 2 == 0) else 2


def _block_dims(torus: tuple[int, ...], mask: int) -> tuple[int, ...]:
    """Axis extents of a placement mask's bounding block (placements
    are contiguous axis-aligned blocks, so the bound IS the block)."""
    if not torus or mask == 0:
        return ()
    chips = [c for c in range(math.prod(torus)) if (mask >> c) & 1]
    coords = np.stack([np.unravel_index(c, torus) for c in chips])
    return tuple(int(hi - lo + 1)
                 for lo, hi in zip(coords.min(axis=0), coords.max(axis=0)))


def rank_chips(torus: tuple[int, ...], mask: int) -> tuple[int, ...]:
    """Global chip ids of ``mask``'s block in RANK ORDER (rank r runs
    on chip ``rank_chips[r]``): the optimal-hop ordering of the local
    block mapped back onto the torus grid.  Pure geometry, memoized."""
    key = (torus, mask)
    hit = _RANK_CACHE.get(key)
    if hit is not None:
        return hit
    if not torus or mask == 0:
        return ()
    chips = [c for c in range(math.prod(torus)) if (mask >> c) & 1]
    coords = np.stack([np.unravel_index(c, torus) for c in chips])
    origin = coords.min(axis=0)
    dims = tuple(int(v) for v in coords.max(axis=0) - origin + 1)
    if math.prod(dims) != len(chips):
        # not a solid block (foreign mask): identity order, still a
        # bijection — the validator's recount covers the hop claim
        out = tuple(chips)
    else:
        out = tuple(int(np.ravel_multi_index(
            tuple(origin + np.asarray(local)), torus))
            for local in rank_order_coords(dims))
    while len(_RANK_CACHE) >= _RANK_CACHE_MAX:
        _RANK_CACHE.pop(next(iter(_RANK_CACHE)))
    _RANK_CACHE[key] = out
    return out


def max_hop_of_chips(torus: tuple[int, ...], chips: tuple[int, ...]) -> int:
    """Recount the max ring hop of a rank->chip assignment: Manhattan
    distance on the grid between consecutive ranks, wrap included for
    n >= 3 — the independent recount the validator and a brute-force oracle
    share with NO planner code in the loop."""
    n = len(chips)
    if n <= 1 or not torus:
        return 0
    coords = [np.unravel_index(c, torus) for c in chips]
    pairs = n if n > 2 else n - 1
    worst = 0
    for i in range(pairs):
        a, b = coords[i], coords[(i + 1) % n]
        worst = max(worst, sum(abs(int(x) - int(y))
                               for x, y in zip(a, b)))
    return worst


def best_placement(table: SliceTable, o: int) -> int:
    """The empty-node placement pick both planner paths share: the
    valid placement of offering ``o`` minimizing (rank-assignment max
    hop, index).  Axis-permuted orientations of one shape share a hop
    bound, so this coincides with index 0 today — the term exists so a
    shape whose orientations ever diverge scores correctly."""
    c = int(table.count[o])
    if c <= 0:
        return 0
    row = table.hops[o, :c].astype(np.int64)
    return int(np.argmin(row * (table.pmax + 1)
                         + np.arange(c, dtype=np.int64)))


def rank_assignment(catalog: CatalogArrays, o: int,
                    mask: int) -> tuple[tuple[int, ...], int]:
    """(rank-ordered chips, achieved max hop) for offering ``o``'s
    placement ``mask`` — the planner's commit helper."""
    if mask == 0:
        return (), 0
    t = int(catalog.off_type[o])
    tori = catalog.type_torus
    torus = tuple(tori[t]) if t < len(tori) else ()
    chips = rank_chips(torus, mask)
    return chips, max_hop_of_chips(torus, chips)


def mask_chips(mask: int) -> int:
    """Chip count of a placement bitmask (host-side popcount)."""
    return int(mask).bit_count()


def split_mask_words(masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint64 masks -> (lo, hi) int32 word pairs for the torch grid
    (two int32 words a mask; AND is word-local, so the disjointness test
    decomposes exactly)."""
    lo = (masks & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (masks >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi
