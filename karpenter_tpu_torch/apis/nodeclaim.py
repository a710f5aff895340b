"""NodeClaim / Node / NodePool typed objects.

Capability parity with karpenter-core's NodeClaim lifecycle as driven by the
reference (pkg/cloudprovider/cloudprovider.go:420-494 builds NodeClaims with
labels from requirements + instance type; registration controller syncs
node<->claim, registration/controller.go:67).

(Copy of ``karpenter_tpu/apis/nodeclaim.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.pod import Taint
from karpenter_tpu_torch.apis.requirements import Requirements


@dataclass
class NodeClaim:
    name: str
    nodeclass_name: str = ""
    nodepool_name: str = ""
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = "on-demand"
    provider_id: str = ""            # "tpu:///<region>/<instance-id>" once launched
    node_name: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    taints: tuple[Taint, ...] = ()
    startup_taints: tuple[Taint, ...] = ()
    requirements: Requirements = field(default_factory=Requirements)
    # lifecycle
    created_at: float = field(default_factory=time.time)
    # stamped once by the registration controller; anchors the
    # never-ready grace window (a node object recreated by re-adoption
    # must NOT reset it — interruption suppression keys on the claim)
    registered_at: float = 0.0
    registered: bool = False
    initialized: bool = False
    launched: bool = False
    deleted: bool = False
    finalizers: list[str] = field(default_factory=list)
    resource_version: int = 0
    uid: str = ""
    # resolved placement (written by the actuator from the solve plan)
    subnet_id: str = ""
    image_id: str = ""
    security_group_ids: tuple[str, ...] = ()
    hourly_price: float = 0.0


@dataclass
class Node:
    """A registered cluster node (the k8s Node analogue)."""

    name: str
    provider_id: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    ready: bool = False
    conditions: dict[str, str] = field(default_factory=dict)  # type -> status
    addresses: list[str] = field(default_factory=list)
    created_at: float = field(default_factory=time.time)
    deleted: bool = False
    resource_version: int = 0
    uid: str = ""


# epsilon ceiling: an overcommit bound at or above 0.5 means z(eps) <= 0
# — "pack with no variance buffer at all", which is never what a
# violation-probability bound is for; larger values clamp here
OVERCOMMIT_MAX = 0.45


def parse_overcommit(q) -> float:
    """Strict overcommit epsilon: number (or None) -> clamped float.

    None/0 -> 0.0 (stochastic plane off).  bools, strings, and
    non-finite floats are rejected — epsilon gates the solver's
    chance-constraint feasibility term, so a lenient parse would let a
    malformed pool spec silently drop the violation bound."""
    if q is None:
        return 0.0
    if isinstance(q, bool) or not isinstance(q, (int, float)):
        raise ValueError(f"bad overcommit {q!r}: must be a number")
    q = float(q)
    if q != q or q in (float("inf"), float("-inf")):
        raise ValueError(f"bad overcommit {q!r}: must be finite")
    return max(0.0, min(OVERCOMMIT_MAX, q))


@dataclass
class NodePool:
    """Provisioning pool: requirements + nodeclass ref + disruption policy
    (karpenter-core NodePool analogue; the reference consumes these through
    GetInstanceTypes per-NodePool filtering, cloudprovider.go:553)."""

    name: str
    nodeclass_name: str = ""
    requirements: Requirements = field(default_factory=Requirements)
    taints: tuple[Taint, ...] = ()
    startup_taints: tuple[Taint, ...] = ()
    labels: dict[str, str] = field(default_factory=dict)
    weight: int = 10
    cpu_limit_milli: int = 0         # 0 = unlimited
    memory_limit_mib: int = 0
    consolidation_policy: str = "WhenEmptyOrUnderutilized"
    consolidate_after_seconds: float = 30.0
    # priority-preemption disruption budget: max pod evictions the
    # PreemptionController may execute against this pool's nodes per
    # reconcile round (karpenter's spec.disruption.budgets analogue).
    # 0 disables preemption for the pool; -1 = unbounded.
    preemption_budget: int = 16
    # chance-constrained overcommit (karpenter_tpu/stochastic): the
    # per-node violation-probability bound epsilon.  0 disables the
    # stochastic plane for this pool (every solve stays deterministic —
    # strict superset); with epsilon > 0, pods carrying a usage
    # distribution pack by mean + z(epsilon)*sqrt(sum variance) instead
    # of by request.  Validated at construction: non-numbers REJECT
    # (a typo'd manifest must not silently disable the violation
    # bound), out-of-range values CLAMP into [0, OVERCOMMIT_MAX].
    overcommit: float = 0.0
    resource_version: int = 0

    def __post_init__(self):
        self.overcommit = parse_overcommit(self.overcommit)


def provider_id(region: str, instance_id: str) -> str:
    """(ref builds 'ibm:///<region>/<id>', vpc/instance/provider.go:841-880)"""
    return f"tpu:///{region}/{instance_id}"


def parse_provider_id(pid: str) -> tuple[str, str] | None:
    """-> (region, instance_id) or None (ref extractInstanceIDFromProviderID,
    vpc/instance/provider.go:1176)."""
    if not pid or not pid.startswith("tpu:///"):
        return None
    rest = pid[len("tpu:///"):]
    parts = rest.split("/", 1)
    if len(parts) != 2 or not parts[0] or not parts[1]:
        return None
    return parts[0], parts[1]
