from karpenter_tpu_torch.catalog.arrays import CAPACITY_TYPES, CatalogArrays
from karpenter_tpu_torch.catalog.instancetype import (
    InstanceProfile, InstanceType, InstanceTypeProvider, Offering,
    compute_overhead, filter_instance_types, instance_type_score,
    pods_capacity, profile_family, profile_size,
)
from karpenter_tpu_torch.catalog.pricing import (
    PricingProvider, StaticPricingProvider,
)
from karpenter_tpu_torch.catalog.unavailable import (
    UnavailableOfferings, offering_key,
)

__all__ = [
    "CAPACITY_TYPES", "CatalogArrays", "InstanceProfile", "InstanceType",
    "InstanceTypeProvider", "Offering", "PricingProvider",
    "StaticPricingProvider", "UnavailableOfferings", "compute_overhead",
    "filter_instance_types", "instance_type_score", "offering_key",
    "pods_capacity", "profile_family", "profile_size",
]
