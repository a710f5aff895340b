"""Instance-type catalog: profiles -> InstanceTypes with offerings.

Capability parity with ``pkg/providers/common/instancetype/instancetype.go``:
- profile -> capacity conversion with the pods heuristic (30/60/110 by cpu,
  instancetype.go:711-718) and family/size labels (:862-880);
- per-zone x per-capacity-type offerings with spot price = on-demand x
  discount% and availability from UnavailableOfferings (:749-773);
- kubelet-config-driven overhead (defaults kube/system-reserved 100m+1Gi
  each, eviction 500Mi — :792-858);
- FilterInstanceTypes by InstanceRequirements incl. price ceiling (:259-356);
- cost-efficiency ranking score = avg(price/cpu, price/memGB), lower better,
  falling back to cpu+memGB when price unknown (:88-110);
- exponential-backoff retry around the cloud list call (:440-446).

(Copy of ``karpenter_tpu/catalog/instancetype.py``.)
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from collections.abc import Sequence

from karpenter_tpu_torch.apis.nodeclass import InstanceRequirements, KubeletConfig, NodeClass
from karpenter_tpu_torch.apis.pod import parse_cpu_milli, parse_memory_mib
from karpenter_tpu_torch.apis.requirements import (
    CAPACITY_TYPE_ON_DEMAND, CAPACITY_TYPE_SPOT,
    LABEL_ARCH, LABEL_CAPACITY_TYPE, LABEL_INSTANCE_FAMILY, LABEL_INSTANCE_SIZE,
    LABEL_INSTANCE_TYPE, LABEL_ZONE, Requirements,
)
from karpenter_tpu_torch.cloud.profile import InstanceProfile
from karpenter_tpu_torch.cloud.retry import retry_with_backoff
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("catalog.instancetype")

DEFAULT_SPOT_DISCOUNT_PERCENT = 60  # options.go:76


def profile_family(name: str) -> str:
    """"bx2-4x16" -> "bx2" (instancetype.go:862-868)."""
    head = name.split("-", 1)[0]
    return head if head else "balanced"


def profile_size(name: str) -> str:
    """"bx2-4x16" -> "4x16" (instancetype.go:871-880)."""
    i = name.find("-")
    return name[i + 1:] if 0 <= i < len(name) - 1 else "small"


def pods_capacity(cpu: int) -> int:
    """Pods-per-node heuristic (instancetype.go:711-718)."""
    if cpu <= 2:
        return 30
    if cpu <= 4:
        return 60
    return 110


def default_torus(chips: int) -> tuple[int, ...]:
    """Deterministic torus dims for a type exposing ``chips``
    accelerators, following real TPU slice geometry: perfect-square
    power-of-two counts are 2-D meshes (4 -> (2, 2), 16 -> (4, 4),
    64 -> (8, 8) — the v5e shapes), other powers of two factor into
    <= 3 near-cubic axes largest-first (8 -> (2, 2, 2), 32 -> (4, 4, 2)),
    and non-power-of-two counts fall back to a 1-D ring.  The gang
    plane's topology layer (gang/topology.py) enumerates contiguous
    sub-slices against these dims; a type with no accelerators has no
    torus and can never host a slice-shaped gang."""
    if chips <= 0:
        return ()
    if chips & (chips - 1):          # not a power of two: 1-D ring
        return (chips,)
    root = math.isqrt(chips)
    if root * root == chips and root >= 2:
        return (root, root)
    dims = [1, 1, 1]
    i = 0
    n = chips
    while n > 1:
        dims[i % 3] *= 2
        n //= 2
        i += 1
    dims = sorted((d for d in dims if d > 1), reverse=True)
    return tuple(dims) if dims else (1,)


@dataclass(frozen=True)
class Offering:
    zone: str
    capacity_type: str           # on-demand | spot
    price: float                 # $/hour
    available: bool = True


@dataclass
class InstanceType:
    """A schedulable instance type: capacity + requirements + offerings."""

    name: str
    cpu_milli: int
    memory_mib: int
    gpu: int
    pods: int
    architecture: str
    family: str
    size: str
    offerings: list[Offering] = field(default_factory=list)
    # overhead (reserved out of capacity before pods fit)
    overhead_cpu_milli: int = 0
    overhead_memory_mib: int = 0
    # accelerator torus dims (gang slice placement); None = derive from
    # the accelerator count via default_torus(), () = no torus
    torus: tuple[int, ...] | None = None

    @property
    def torus_dims(self) -> tuple[int, ...]:
        return self.torus if self.torus is not None else default_torus(self.gpu)

    @property
    def allocatable_cpu_milli(self) -> int:
        return max(0, self.cpu_milli - self.overhead_cpu_milli)

    @property
    def allocatable_memory_mib(self) -> int:
        return max(0, self.memory_mib - self.overhead_memory_mib)

    def label_values(self) -> dict[str, str]:
        return {
            LABEL_INSTANCE_TYPE: self.name,
            LABEL_ARCH: self.architecture,
            LABEL_INSTANCE_FAMILY: self.family,
            LABEL_INSTANCE_SIZE: self.size,
        }

    def cheapest_offering(self) -> Offering | None:
        avail = [o for o in self.offerings if o.available and o.price > 0]
        return min(avail, key=lambda o: o.price) if avail else None


def compute_overhead(kubelet: KubeletConfig | None) -> tuple[int, int]:
    """-> (cpu_milli, memory_mib) reserved (instancetype.go:792-858).

    Defaults: kubeReserved 100m/1Gi + systemReserved 100m/1Gi +
    evictionHard memory 500Mi.
    """
    def parse_or(d, key, parser, default):
        # Per-field fallback (the reference keeps the default for each
        # malformed quantity individually, instancetype.go:801-843).
        if key not in d:
            return default
        try:
            return parser(d[key])
        except ValueError as e:
            log.warning("invalid kubelet reservation, using default",
                        key=key, value=d[key], error=str(e))
            return default

    kube = dict(kubelet.kube_reserved) if kubelet else {}
    system = dict(kubelet.system_reserved) if kubelet else {}
    evict = dict(kubelet.eviction_hard) if kubelet else {}
    kube_cpu = parse_or(kube, "cpu", parse_cpu_milli, 100)
    kube_mem = parse_or(kube, "memory", parse_memory_mib, 1024)
    sys_cpu = parse_or(system, "cpu", parse_cpu_milli, 100)
    sys_mem = parse_or(system, "memory", parse_memory_mib, 1024)
    evict_mem = parse_or(evict, "memory.available", parse_memory_mib, 500)
    return kube_cpu + sys_cpu, kube_mem + sys_mem + evict_mem


def instance_type_score(it: InstanceType, price: float) -> float:
    """Cost-efficiency rank, lower better (instancetype.go:88-110)."""
    cpu = it.cpu_milli / 1000.0
    mem_gb = it.memory_mib / 1024.0
    if price <= 0:
        return cpu + mem_gb
    return (price / max(cpu, 1e-9) + price / max(mem_gb, 1e-9)) / 2.0


def filter_instance_types(types: Sequence[InstanceType],
                          reqs: InstanceRequirements) -> list[InstanceType]:
    """Auto-selection filter (instancetype.go:259-356): architecture, minCPU,
    minMemory, maxHourlyPrice (vs cheapest available offering), gpu."""
    out = []
    for it in types:
        if reqs.architecture and it.architecture != reqs.architecture:
            continue
        if reqs.min_cpu and it.cpu_milli < reqs.min_cpu * 1000:
            continue
        if reqs.min_memory_gib and it.memory_mib < reqs.min_memory_gib * 1024:
            continue
        if reqs.gpu and it.gpu == 0:
            continue
        if reqs.max_hourly_price > 0:
            cheapest = it.cheapest_offering()
            if cheapest is None or cheapest.price > reqs.max_hourly_price:
                continue
        out.append(it)
    # Rank by cost efficiency (instancetype.go:359).
    def key(it: InstanceType):
        o = it.cheapest_offering()
        return instance_type_score(it, o.price if o else 0.0)
    out.sort(key=key)
    return out


class InstanceTypeProvider:
    """Builds and caches the InstanceType catalog from the cloud client.

    Ref ``NewProvider`` instancetype.go:71; list retry :440-446; zone cache
    1h :594-648; 30m catalog TTL.
    """

    def __init__(self, client, pricing_provider, unavailable: "UnavailableOfferings" = None,
                 spot_discount_percent: int = DEFAULT_SPOT_DISCOUNT_PERCENT,
                 catalog_ttl: float = 1800.0, clock=None):
        from karpenter_tpu_torch.catalog.unavailable import UnavailableOfferings
        self._client = client
        self._pricing = pricing_provider
        self._unavailable = unavailable or UnavailableOfferings()
        self._spot_discount = spot_discount_percent or DEFAULT_SPOT_DISCOUNT_PERCENT
        self._clock = clock
        self._cache = TTLCache(default_ttl=catalog_ttl,
                               **({"clock": clock} if clock else {}))
        self._zone_cache = TTLCache(default_ttl=3600.0,
                                    **({"clock": clock} if clock else {}))
        self._avail_cache: dict = {}

    @property
    def unavailable_offerings(self):
        return self._unavailable

    def zones(self) -> list[str]:
        return self._zone_cache.get_or_set(
            "zones", lambda: retry_with_backoff(self._client.list_zones))

    def list(self, nodeclass: NodeClass | None = None) -> list[InstanceType]:
        """Full catalog with offerings; availability is re-applied whenever
        the blackout set changes (cheap equality check on its generation, so
        steady-state list() calls return the cached objects)."""
        kubelet = nodeclass.spec.kubelet if nodeclass else None
        key = ("catalog", self._kubelet_key(kubelet))
        base: list[InstanceType] = self._cache.get_or_set(
            key, lambda: self._build(kubelet))
        gen = self._unavailable.generation
        cached = self._avail_cache.get(key)
        if cached is not None and cached[0] == gen and cached[1] is base:
            return cached[2]
        applied = [self._with_fresh_availability(it) for it in base]
        self._avail_cache[key] = (gen, base, applied)
        return applied

    def get(self, name: str, nodeclass: NodeClass | None = None) -> InstanceType | None:
        for it in self.list(nodeclass):
            if it.name == name:
                return it
        return None

    def refresh(self) -> None:
        """Hourly singleton hook (controllers/providers/instancetype)."""
        self._cache = TTLCache(default_ttl=self._cache._default_ttl,
                               **({"clock": self._clock} if self._clock else {}))
        self._unavailable.cleanup()

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _kubelet_key(kubelet: KubeletConfig | None):
        return kubelet if kubelet is None else (
            kubelet.max_pods, kubelet.system_reserved, kubelet.kube_reserved,
            kubelet.eviction_hard)

    def _build(self, kubelet: KubeletConfig | None) -> list[InstanceType]:
        profiles: list[InstanceProfile] = retry_with_backoff(
            self._client.list_instance_profiles)
        zones = self.zones()
        if not zones:
            raise RuntimeError(f"no zones found for region {self._client.region}")
        oh_cpu, oh_mem = compute_overhead(kubelet)
        out = []
        for p in profiles:
            pods = kubelet.max_pods if (kubelet and kubelet.max_pods) else pods_capacity(p.cpu)
            it = InstanceType(
                name=p.name,
                cpu_milli=p.cpu * 1000,
                memory_mib=p.memory_gib * 1024,
                gpu=p.gpu,
                pods=pods,
                architecture=p.architecture,
                family=profile_family(p.name),
                size=profile_size(p.name),
                overhead_cpu_milli=oh_cpu,
                overhead_memory_mib=oh_mem,
            )
            caps = [CAPACITY_TYPE_ON_DEMAND] + (
                [CAPACITY_TYPE_SPOT] if p.supports_spot else [])
            for zone in zones:
                od_price = self._pricing.get_price(p.name, zone)
                for cap in caps:
                    price = od_price
                    if cap == CAPACITY_TYPE_SPOT:
                        price = od_price * self._spot_discount / 100.0
                    it.offerings.append(Offering(zone=zone, capacity_type=cap,
                                                 price=price, available=True))
            out.append(it)
        log.info("built instance-type catalog", types=len(out), zones=len(zones))
        return out

    def _with_fresh_availability(self, it: InstanceType) -> InstanceType:
        offerings = [
            Offering(o.zone, o.capacity_type, o.price,
                     available=not self._unavailable.is_unavailable(
                         it.name, o.zone, o.capacity_type))
            for o in it.offerings
        ]
        return InstanceType(
            name=it.name, cpu_milli=it.cpu_milli, memory_mib=it.memory_mib,
            gpu=it.gpu, pods=it.pods, architecture=it.architecture,
            family=it.family, size=it.size, offerings=offerings,
            overhead_cpu_milli=it.overhead_cpu_milli,
            overhead_memory_mib=it.overhead_memory_mib, torus=it.torus)
