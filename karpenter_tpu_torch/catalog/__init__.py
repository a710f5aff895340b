from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES, CatalogArrays
from karpenter_tpu_torch.catalog.instancetype import (
    InstanceType, Offering, compute_overhead, pods_capacity, profile_family,
    profile_size,
)

__all__ = [
    "CAPACITY_TYPES", "CatalogArrays", "InstanceType", "Offering",
    "compute_overhead", "pods_capacity", "profile_family", "profile_size",
]
