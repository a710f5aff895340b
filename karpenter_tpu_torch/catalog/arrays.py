"""Dense catalog tensors: the device-resident offering matrix.

SURVEY.md §3.5: periodic refreshers "write the device-resident catalog
tensors (types x zones x {cpu, mem, gpu, price_ondemand, price_spot,
avail})".  This module flattens the host ``InstanceType`` catalog into
structure-of-arrays form over the *offering* axis (type x zone x
capacity-type) that the solver consumes directly:

- integer allocatable capacity (milliCPU, MiB, gpu, pod slots) — exact
  integer arithmetic on device, no float floor hazards;
- float32 price vector with spot discounting already applied;
- boolean availability mask, refreshable in O(O) from the
  UnavailableOfferings blackout set without rebuilding the catalog;
- vocabularies (type/zone/arch/family/size names -> indices) so host-side
  requirements can be lowered to per-offering boolean masks.

Arrays are numpy on host; the solver moves them to device once per catalog
generation and keeps them resident between solves (SURVEY.md §7.4
"host<->device boundary").
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from collections.abc import Sequence

import numpy as np

from karpenter_tpu_torch.apis.pod import NUM_RESOURCES
from karpenter_tpu_torch.apis.requirements import (
    CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT,
    LABEL_ARCH, LABEL_CAPACITY_TYPE, LABEL_INSTANCE_FAMILY, LABEL_INSTANCE_SIZE,
    LABEL_INSTANCE_TYPE, LABEL_ZONE,
)
from karpenter_tpu_torch.catalog.instancetype import InstanceType

CAPACITY_TYPES = (CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT)

_uid_counter = itertools.count(1)


@dataclass
class CatalogArrays:
    """Structure-of-arrays catalog over the offering axis."""

    # per-type
    type_names: list[str]
    type_alloc: np.ndarray          # int32 [T, R] allocatable (cpu_m, mem_mib, gpu, pods)
    type_arch: np.ndarray           # int32 [T] -> arch vocab index
    type_family: np.ndarray         # int32 [T] -> family vocab index
    type_size: np.ndarray           # int32 [T] -> size vocab index
    # per-offering (flattened type x zone x captype, only existing offerings)
    off_type: np.ndarray            # int32 [O]
    off_zone: np.ndarray            # int32 [O] -> zone vocab index
    off_cap: np.ndarray             # int32 [O] 0=on-demand 1=spot
    off_price: np.ndarray           # float32 [O] $/h (0 = unknown)
    off_avail: np.ndarray           # bool [O]
    # vocabularies
    zones: list[str]
    archs: list[str]
    families: list[str]
    sizes: list[str]
    # per-type accelerator torus dims (gang slice placement;
    # gang/topology.py lowers these to placement bitmask tables).  Host
    # list, not a device tensor: only the gang encoder consumes it.
    type_torus: list[tuple[int, ...]] = field(default_factory=list)
    # spot-risk ranking column (karpenter_tpu/stochastic/risk.py):
    # float32 [O] expected-eviction penalty per offering (0 = no
    # observed risk / on-demand).  Enters RANKING only — real cost
    # accounting (off_price) never moves.  risk_generation keys the
    # solver's device-resident rank tensors, so a re-priced model
    # re-uploads instead of serving stale ranks.
    off_risk: np.ndarray | None = None
    risk_generation: int = 0
    # provenance
    generation: int = 0
    availability_generation: object = None
    uid: int = -1                   # unique per build() — device-cache key
    _offering_index: dict[tuple[str, str, str], int] = field(default_factory=dict)

    # -- construction ------------------------------------------------------

    @classmethod
    def build(cls, instance_types: Sequence[InstanceType],
              generation: int = 0) -> "CatalogArrays":
        type_names = [it.name for it in instance_types]
        zones = sorted({o.zone for it in instance_types for o in it.offerings})
        archs = sorted({it.architecture for it in instance_types})
        families = sorted({it.family for it in instance_types})
        sizes = sorted({it.size for it in instance_types})
        zone_idx = {z: i for i, z in enumerate(zones)}
        arch_idx = {a: i for i, a in enumerate(archs)}
        family_idx = {f: i for i, f in enumerate(families)}
        size_idx = {s: i for i, s in enumerate(sizes)}

        T = len(instance_types)
        type_alloc = np.zeros((T, NUM_RESOURCES), dtype=np.int32)
        type_arch = np.zeros(T, dtype=np.int32)
        type_family = np.zeros(T, dtype=np.int32)
        type_size = np.zeros(T, dtype=np.int32)
        off_type, off_zone, off_cap, off_price, off_avail = [], [], [], [], []
        offering_index: dict[tuple[str, str, str], int] = {}

        for t, it in enumerate(instance_types):
            type_alloc[t] = (it.allocatable_cpu_milli, it.allocatable_memory_mib,
                             it.gpu, it.pods)
            type_arch[t] = arch_idx[it.architecture]
            type_family[t] = family_idx[it.family]
            type_size[t] = size_idx[it.size]
            for o in it.offerings:
                offering_index[(it.name, o.zone, o.capacity_type)] = len(off_type)
                off_type.append(t)
                off_zone.append(zone_idx[o.zone])
                off_cap.append(CAPACITY_TYPES.index(o.capacity_type))
                off_price.append(o.price)
                off_avail.append(o.available)

        return cls(
            type_names=type_names,
            type_alloc=type_alloc,
            type_arch=type_arch, type_family=type_family, type_size=type_size,
            off_type=np.asarray(off_type, dtype=np.int32),
            off_zone=np.asarray(off_zone, dtype=np.int32),
            off_cap=np.asarray(off_cap, dtype=np.int32),
            off_price=np.asarray(off_price, dtype=np.float32),
            off_avail=np.asarray(off_avail, dtype=bool),
            zones=zones, archs=archs, families=families, sizes=sizes,
            type_torus=[it.torus_dims for it in instance_types],
            generation=generation, uid=next(_uid_counter),
            _offering_index=offering_index,
        )

    # -- views -------------------------------------------------------------

    @property
    def num_types(self) -> int:
        return len(self.type_names)

    @property
    def num_offerings(self) -> int:
        return int(self.off_type.shape[0])

    def offering_alloc(self) -> np.ndarray:
        """int32 [O, R] allocatable capacity per offering.  Memoized:
        type_alloc/off_type are immutable after build(), and encode calls
        this once per pod-signature group."""
        cached = getattr(self, "_alloc_cache", None)
        if cached is None:
            cached = self.type_alloc[self.off_type]
            self._alloc_cache = cached
        return cached

    def offering_rank_price(self) -> np.ndarray:
        """float32 [O] price used for *ranking only*: real price when known,
        else a size-proportional pseudo-price (cpu cores + mem GiB), mirroring
        the reference's fallback ranking for unpriced types
        (instancetype.go:88-110).  Plan cost accounting still uses
        ``off_price`` (0 for unknown), matching the reference's Offering
        semantics."""
        alloc = self.offering_alloc().astype(np.float32)
        pseudo = alloc[:, 0] / 1000.0 + alloc[:, 1] / 1024.0
        rank = np.where(self.off_price > 0, self.off_price,
                        pseudo).astype(np.float32)
        if self.off_risk is not None:
            # expected eviction cost (stochastic/risk.py): an offering
            # observed interrupted r of the time ranks as if its price
            # carried the replacement churn — ranking only, cost
            # accounting untouched
            rank = (rank * (1.0 + self.off_risk)).astype(np.float32)
        return rank

    def offering_label_values(self, o: int) -> dict[str, str]:
        """Node label values an offering would produce — the host-side
        bridge for lowering Requirements into masks."""
        t = int(self.off_type[o])
        return {
            LABEL_INSTANCE_TYPE: self.type_names[t],
            LABEL_ARCH: self.archs[int(self.type_arch[t])],
            LABEL_INSTANCE_FAMILY: self.families[int(self.type_family[t])],
            LABEL_INSTANCE_SIZE: self.sizes[int(self.type_size[t])],
            LABEL_ZONE: self.zones[int(self.off_zone[o])],
            LABEL_CAPACITY_TYPE: CAPACITY_TYPES[int(self.off_cap[o])],
        }

    def describe_offering(self, o: int) -> tuple[str, str, str]:
        t = int(self.off_type[o])
        return (self.type_names[t], self.zones[int(self.off_zone[o])],
                CAPACITY_TYPES[int(self.off_cap[o])])

    def find_offering(self, instance_type: str, zone: str,
                      capacity_type: str) -> int | None:
        """The offering index of (type, zone, capacity type), or None."""
        return self._offering_index.get((instance_type, zone, capacity_type))

    def describe_offerings(self, offs: np.ndarray):
        """Vectorized :meth:`describe_offering` over an index array —
        returns (type_names, zones, captypes, prices) as host lists.
        The per-offering string columns are materialized once per
        catalog (object arrays; ~O strings) so a decode touching
        hundreds of nodes costs four fancy-index gathers instead of
        per-node Python lookups (the decode hot path, VERDICT round 4
        item 1: host-side Python overhead rivals chip time)."""
        cached = getattr(self, "_desc_cache", None)
        if cached is None:
            cached = (np.array(self.type_names, object)[self.off_type],
                      np.array(self.zones, object)[self.off_zone],
                      np.array(CAPACITY_TYPES, object)[self.off_cap])
            self._desc_cache = cached
        tn, zn, cn = cached
        return (tn[offs].tolist(), zn[offs].tolist(), cn[offs].tolist(),
                self.off_price[offs].tolist())

    # -- availability refresh ---------------------------------------------

    def refresh_availability(self, unavailable) -> bool:
        """Re-derive the availability column from the blackout set; returns
        True when the mask changed (caller re-uploads to device)."""
        # capture the generation ONCE and derive the mask from that same
        # frozenset — reading keys and generation separately lets a TTL
        # expire in between, recording a generation the mask doesn't match
        gen = unavailable.generation
        if gen == self.availability_generation:
            return False
        mask = np.ones(self.num_offerings, dtype=bool)
        for key in gen:
            parts = key.split(":")
            if len(parts) != 3:
                continue
            idx = self._offering_index.get((parts[0], parts[1], parts[2]))
            if idx is not None:
                mask[idx] = False
        changed = not np.array_equal(mask, self.off_avail)
        self.off_avail = mask
        self.availability_generation = gen
        return changed
