"""CloudProvider facade: the karpenter-core-facing interface (L3).

Capability parity with ``pkg/cloudprovider/cloudprovider.go:64`` —
Create / Delete / Get / List / GetInstanceTypes / IsDrifted / Name /
RepairPolicies / GetSupportedNodeClasses — re-centered on the solver: Create
takes a PlannedNode from the solve instead of re-running a greedy pick, but
keeps the reference's gates (Ready condition :282-301, compatible-type
filter :321-352, circuit breaker :356-373) which live in the Actuator.

(Copy of ``karpenter_tpu/core/cloudprovider.py``.)
"""

from __future__ import annotations


from karpenter_tpu_torch.apis.nodeclaim import NodeClaim, parse_provider_id
from karpenter_tpu_torch.apis.nodeclass import NodeClass
from karpenter_tpu_torch.catalog.arrays import CatalogArrays
from karpenter_tpu_torch.catalog.instancetype import InstanceType, InstanceTypeProvider
from karpenter_tpu_torch.cloud.errors import CloudError, NodeClaimNotFoundError, is_not_found
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.drift import RepairPolicy, is_drifted, repair_policies
from karpenter_tpu_torch.solver.types import PlannedNode
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.cloudprovider")

PROVIDER_NAME = "karpenter-tpu"


class CloudProvider:
    def __init__(self, cluster: ClusterState, actuator: Actuator,
                 instance_types: InstanceTypeProvider, factory=None):
        self.cluster = cluster
        self.actuator = actuator
        # optional ProviderFactory for per-NodeClass VPC/IKS routing
        self.factory = factory
        self.instance_types = instance_types

    # -- identity ----------------------------------------------------------

    def name(self) -> str:
        return PROVIDER_NAME

    def get_supported_node_classes(self) -> list[str]:
        return ["NodeClass"]

    # -- lifecycle ---------------------------------------------------------

    def create(self, planned: PlannedNode, nodeclass: NodeClass,
               catalog: CatalogArrays, nodepool_name: str = "default") -> NodeClaim:
        """(cloudprovider.go:249-501 — gates live in Actuator.create_node)"""
        actuator = self.factory.get_actuator(nodeclass) \
            if self.factory is not None else self.actuator
        return actuator.create_node(planned, nodeclass, catalog, nodepool_name)

    def delete(self, claim: NodeClaim) -> None:
        """Raises NodeClaimNotFoundError once the instance is verifiably
        gone — the finalizer-release contract (cloudprovider.go:503)."""
        actuator = self.factory.get_actuator_for_claim(claim) \
            if self.factory is not None else self.actuator
        actuator.delete_node(claim)

    def get(self, provider_id: str) -> NodeClaim | None:
        """Resolve a providerID back to a live NodeClaim
        (cloudprovider.go:106): verify the instance exists, then find the
        claim tracking it."""
        parsed = parse_provider_id(provider_id)
        if parsed is None:
            return None
        _, instance_id = parsed
        try:
            self.actuator.cloud.get_instance(instance_id)
        except CloudError as e:
            if is_not_found(e):
                raise NodeClaimNotFoundError(provider_id)
            raise
        for claim in self.cluster.nodeclaims():
            if claim.provider_id == provider_id:
                return claim
        return None

    def list(self) -> list[NodeClaim]:
        """All NodeClaims with live provider IDs (cloudprovider.go:172 lists
        nodes with ibm:// providerIDs; claims are this framework's ledger)."""
        return [c for c in self.cluster.nodeclaims()
                if c.provider_id and not c.deleted]

    def get_instance_types(self, nodeclass: NodeClass | None = None
                           ) -> list[InstanceType]:
        """Per-NodeClass filtered catalog (cloudprovider.go:553)."""
        types = self.instance_types.list(nodeclass)
        if nodeclass is not None and nodeclass.status.selected_instance_types:
            allowed = set(nodeclass.status.selected_instance_types)
            types = [t for t in types if t.name in allowed]
        return types

    # -- drift / repair ----------------------------------------------------

    def is_drifted(self, claim: NodeClaim) -> str:
        """Six-check drift chain; "" = not drifted (cloudprovider.go:585)."""
        nodeclass = self.cluster.get_nodeclass(claim.nodeclass_name)
        return is_drifted(claim, nodeclass)

    def repair_policies(self) -> list[RepairPolicy]:
        return repair_policies()
