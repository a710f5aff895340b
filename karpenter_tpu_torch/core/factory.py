"""ProviderFactory: per-NodeClass VPC vs IKS actuation selection
(port of ``karpenter_tpu/core/factory.py``).

Capability parity with ``pkg/providers/factory.go``: shared providers built
once (:49), instance provider selected per NodeClass by
``determineProviderMode`` (:124-158): explicit bootstrapMode=iks-api ->
IKS; spec.iksClusterID -> IKS; ``IKS_CLUSTER_ID`` env -> IKS; default VPC.
"""

from __future__ import annotations

import os

from karpenter_tpu_torch.apis.nodeclass import NodeClass
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.workerpool import WorkerPoolActuator
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("core.factory")

MODE_VPC = "vpc"
MODE_IKS = "iks"


def determine_mode(nodeclass: NodeClass, env=os.environ) -> str:
    """(ref factory.go:124-158)"""
    if nodeclass.spec.bootstrap_mode == "iks-api":
        return MODE_IKS
    if nodeclass.spec.iks_cluster_id:
        return MODE_IKS
    if env.get("IKS_CLUSTER_ID"):
        return MODE_IKS
    return MODE_VPC


class ProviderFactory:
    def __init__(self, vpc_actuator: Actuator,
                 iks_actuator: WorkerPoolActuator | None = None,
                 env=os.environ):
        self.vpc = vpc_actuator
        self.iks = iks_actuator
        self.env = env

    def get_actuator(self, nodeclass: NodeClass):
        mode = determine_mode(nodeclass, self.env)
        if mode == MODE_IKS:
            if self.iks is None:
                log.warning("IKS mode requested but no IKS actuator wired; "
                            "falling back to VPC", nodeclass=nodeclass.name)
                return self.vpc
            return self.iks
        return self.vpc

    def get_actuator_for_claim(self, claim):
        """Delete-path routing: a claim created through the worker-pool path
        carries the pool annotations, which outlive its NodeClass — deleting
        an IKS worker via the VPC path would strand the pool's bookkeeping
        (worker record + size) and keep the empty-pool reaper from firing."""
        from karpenter_tpu_torch.core.workerpool import ANNOTATION_POOL_ID
        if claim.annotations.get(ANNOTATION_POOL_ID) and self.iks is not None:
            return self.iks
        return self.vpc
