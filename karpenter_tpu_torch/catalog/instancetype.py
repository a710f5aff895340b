"""Instance types and offerings, with the pure catalog helpers.

Port of the host half of ``karpenter_tpu/catalog/instancetype.py``:
``InstanceType``, ``Offering`` and the profile helpers (family/size
labels, the pods-per-node heuristic, kubelet overhead).  The
cloud-backed provider that lists profiles and prices them is not part
of this package; ``karpenter_tpu_torch.workload`` builds a catalog from
a seed instead.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.pod import parse_cpu_milli, parse_memory_mib

DEFAULT_SPOT_DISCOUNT_PERCENT = 60


def profile_family(name: str) -> str:
    """"bx2-4x16" -> "bx2"."""
    head = name.split("-", 1)[0]
    return head if head else "balanced"


def profile_size(name: str) -> str:
    """"bx2-4x16" -> "4x16"."""
    i = name.find("-")
    return name[i + 1:] if 0 <= i < len(name) - 1 else "small"


def pods_capacity(cpu: int) -> int:
    """Pods-per-node heuristic: 30 / 60 / 110 by vCPU count."""
    if cpu <= 2:
        return 30
    if cpu <= 4:
        return 60
    return 110


def default_torus(chips: int) -> tuple[int, ...]:
    """Deterministic torus dims for a type exposing ``chips``
    accelerators: perfect-square powers of two are 2-D meshes, other
    powers of two factor into <= 3 near-cubic axes largest-first, and
    other counts fall back to a 1-D ring."""
    if chips <= 0:
        return ()
    if chips & (chips - 1):
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
    overhead_cpu_milli: int = 0
    overhead_memory_mib: int = 0
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


def compute_overhead(kubelet=None) -> tuple[int, int]:
    """-> (cpu_milli, memory_mib) reserved by the kubelet.

    ``kubelet`` is any object with ``kube_reserved``, ``system_reserved``
    and ``eviction_hard`` mappings (or None).  Defaults: kubeReserved
    100m/1Gi + systemReserved 100m/1Gi + evictionHard memory 500Mi; a
    malformed quantity keeps its default."""
    def parse_or(d, key, parser, default):
        if key not in d:
            return default
        try:
            return parser(d[key])
        except ValueError:
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
