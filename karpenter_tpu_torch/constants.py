"""Cross-cutting constants (reference: pkg/constants/constants.go —
the API group + client cache TTLs the provider shares across packages).

This module is the INDEX of values that already have an owner — it
re-exports the canonical definitions instead of minting second copies
(two same-named constants with different values is how label-selector
bugs are born).  Only values used by more than one subsystem appear;
subsystem-local tunables stay next to their owner.

(Copy of ``karpenter_tpu/constants.py``.)
"""

from __future__ import annotations

# karpenter-core-owned label keys (the scheduler contract, shared with
# upstream karpenter tooling) — canonical home: apis/requirements.py
from karpenter_tpu_torch.apis.requirements import LABEL_NODEPOOL  # noqa: F401

# provider-owned API group of the CRDs (reference Group =
# "karpenter-ibm.sh"; deploy/crds/tpunodeclass.yaml anchors this value)
GROUP = "karpenter-tpu.sh"

# CRD kind names (apis/nodeclass.py + charts render from these)
NODECLASS_KIND = "TPUNodeClass"
NODECLAIM_KIND = "TPUNodeClaim"

# the tag/label marking instances this operator owns (core/actuator.py
# KARPENTER_TAGS stamps it on every create; orphan sweeps select by it)
LABEL_MANAGED = "karpenter.sh/managed"

# the finalizer the claim lifecycle controller owns (consumed by the
# nodeclaim controller, the actuator, and the IKS worker-pool actuator)
CLAIM_FINALIZER = f"{GROUP}/termination"

# default client-cache TTL for cloud API clients (reference
# DefaultVPCClientCacheTTL = 30 min; cloud/client_manager.py default)
DEFAULT_CLIENT_CACHE_TTL_SECONDS = 30 * 60
