"""NodeClaim, Node and NodePool: the objects the solve and the planners read.

Port of ``karpenter_tpu/apis/nodeclaim.py`` restricted to what the
encoders and validators read: ``NodePool`` and its overcommit parse,
and the ``NodeClaim`` / ``Node`` records that the preemption plane's
victim encoder and validator walk (``core/cluster.py``; ``Node`` is
the registered node a claim's ``node_name`` names).  The lifecycle
fields the controllers write (registration, finalizers, resolved
placement) belong to the controller layer, which this package does not
carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.pod import Taint
from karpenter_tpu_torch.apis.requirements import Requirements

@dataclass
class NodeClaim:
    """A node the provisioner asked for: its offering, its node, its
    taints and whether it is launched or deleted."""

    name: str
    instance_type: str = ""
    zone: str = ""
    capacity_type: str = "on-demand"
    node_name: str = ""
    taints: tuple[Taint, ...] = ()
    launched: bool = False
    deleted: bool = False
    resource_version: int = 0
    # read by the repack plane: a claim whose node is not initialized is
    # neither a migration source nor a target; the price is what a
    # drain saves
    initialized: bool = False
    hourly_price: float = 0.0


@dataclass
class Node:
    """A registered cluster node (the k8s Node analogue)."""

    name: str
    provider_id: str = ""
    labels: dict[str, str] = field(default_factory=dict)
    taints: list[Taint] = field(default_factory=list)
    ready: bool = False
    deleted: bool = False
    resource_version: int = 0


# epsilon ceiling: an overcommit bound at or above 0.5 means z(eps) <= 0
# — "pack with no variance buffer at all", which is never what a
# violation-probability bound is for; larger values clamp here
OVERCOMMIT_MAX = 0.45


def parse_overcommit(q) -> float:
    """Strict overcommit epsilon: number (or None) -> clamped float.

    None/0 -> 0.0 (stochastic plane off).  bools, strings, and
    non-finite floats are rejected."""
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
    """Provisioning pool: requirements, taints, static labels and the
    overcommit bound — every field the encoder's lowering reads."""

    name: str
    nodeclass_name: str = ""
    requirements: Requirements = field(default_factory=Requirements)
    taints: tuple[Taint, ...] = ()
    startup_taints: tuple[Taint, ...] = ()
    labels: dict[str, str] = field(default_factory=dict)
    # chance-constrained overcommit epsilon; 0 keeps every solve
    # deterministic.  Windows with epsilon > 0 take the stochastic route
    # (``stochastic/``).
    overcommit: float = 0.0
    resource_version: int = 0

    def __post_init__(self):
        self.overcommit = parse_overcommit(self.overcommit)
