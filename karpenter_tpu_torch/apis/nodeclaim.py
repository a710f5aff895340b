"""NodePool: the provisioning pool a solve window targets.

Port of ``karpenter_tpu/apis/nodeclaim.py`` restricted to what the solve
path reads (``NodePool`` and its overcommit parse).  The NodeClaim /
Node lifecycle objects belong to the controller layer, which this
package does not carry yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from karpenter_tpu_torch.apis.pod import Taint
from karpenter_tpu_torch.apis.requirements import Requirements

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
    # deterministic.  Windows with epsilon > 0 take the stochastic route,
    # which this package does not serve yet.
    overcommit: float = 0.0
    resource_version: int = 0

    def __post_init__(self):
        self.overcommit = parse_overcommit(self.overcommit)
