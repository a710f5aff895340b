from karpenter_tpu_torch.apis.nodeclaim import Node, NodeClaim, NodePool
from karpenter_tpu_torch.apis.nodeclass import (
    BlockDeviceMapping, Condition, DynamicPoolConfig, ImageSelector,
    InstanceRequirements, KubeletConfig, LoadBalancerIntegration,
    LoadBalancerTarget, NodeClass, NodeClassSpec, NodeClassStatus,
    PlacementStrategy, SubnetSelectionCriteria, ValidationError, VolumeSpec,
)
from karpenter_tpu_torch.apis.pod import (
    PodAffinityTerm, PodSpec, ResourceRequests, Taint, Toleration,
    TopologySpreadConstraint,
)
from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.apis.requirements import (
    Operator, Requirement, Requirements,
)

__all__ = [
    "BlockDeviceMapping", "Condition", "DynamicPoolConfig", "ImageSelector",
    "InstanceRequirements", "KubeletConfig", "LoadBalancerIntegration",
    "LoadBalancerTarget", "NodeClass", "NodeClassSpec", "NodeClassStatus",
    "PlacementStrategy", "SubnetSelectionCriteria", "ValidationError",
    "VolumeSpec",
    "Node", "NodeClaim", "NodePool", "PodAffinityTerm", "PodGroup", "PodSpec", "ResourceRequests",
    "Taint", "Toleration", "TopologySpreadConstraint", "Operator",
    "Requirement", "Requirements",
]
