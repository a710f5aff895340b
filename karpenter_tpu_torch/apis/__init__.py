from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import (
    PodAffinityTerm, PodSpec, ResourceRequests, Taint, Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.apis.requirements import (
    Operator, Requirement, Requirements,
)

__all__ = [
    "NodePool", "PodAffinityTerm", "PodGroup", "PodSpec", "ResourceRequests",
    "Taint", "Toleration", "TopologySpreadConstraint", "Operator",
    "Requirement", "Requirements",
]
