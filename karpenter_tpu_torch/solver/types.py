"""Solver interface types: request, plan, options, bucket ladders.

Port of ``karpenter_tpu/solver/types.py``.  The solver is a pure
function (pods, catalog, nodepool) -> Plan; the bucket ladders pad the
group, offering and node axes so repeated windows reuse one set of
shapes (and, on the card, one set of allocations).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from collections.abc import Sequence

from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.apis.pod import PodSpec
from karpenter_tpu_torch.catalog.arrays import CatalogArrays


@dataclass
class SolverOptions:
    """Solver configuration: the reference's options that the served
    route reads, plus the route gates (flat, resident, serving, sharded)
    so a window the reference would send elsewhere raises here."""

    max_nodes: int = 4096           # static bound on nodes per solve
    right_size: bool = True         # post-pass: re-pick cheapest fitting offering
    bucket_groups: bool = True      # pad G/O/N to bucket ladders
    adaptive_nodes: bool = True     # size the node axis from the demand lower
                                    # bound; escalate on in-kernel overflow
    compact_assign: str = "auto"    # COO-compact the [G,N] assign matrix
                                    # before the device->host copy; "auto" =
                                    # off on cpu and cuda, as the reference
    zone_candidates: str = "on"     # zone-affinity groups: solve per-zone
                                    # candidates and keep the cheapest
    zone_candidate_solves: int = 8  # extra-solve budget for the refinement
    flat_solver: str = "auto"       # heterogeneous-regime solve: not served
                                    # by this package yet (raises)
    flat_min_groups: int = 2048     # G threshold of the flat regime
    resident: str = "auto"          # device-resident state: not served yet
    serving: str = "auto"           # persistent serving loop: not served yet
    sharded: int = 0                # sharded service: not served yet


@dataclass
class SolveRequest:
    pods: list[PodSpec]
    catalog: CatalogArrays
    nodepool: NodePool | None = None


@dataclass(slots=True)
class PlannedNode:
    """One node the plan wants created."""

    instance_type: str
    zone: str
    capacity_type: str
    price: float
    pod_names: list[str] = field(default_factory=list)
    offering_index: int = -1

    @property
    def pod_count(self) -> int:
        return len(self.pod_names)


@dataclass
class Plan:
    """Placement result: nodes to create + pod assignment + leftovers."""

    nodes: list[PlannedNode] = field(default_factory=list)
    unplaced_pods: list[str] = field(default_factory=list)
    total_cost_per_hour: float = 0.0
    backend: str = ""
    solve_seconds: float = 0.0
    # explainability: per-unplaced-pod canonical reason, raw elimination
    # bitmask, and the nearest-miss offering for statically-eliminated pods
    unplaced_reasons: dict[str, str] = field(default_factory=dict)
    unplaced_words: dict[str, int] = field(default_factory=dict)
    unplaced_nearest: dict[str, dict] = field(default_factory=dict)

    @property
    def placed_count(self) -> int:
        return sum(n.pod_count for n in self.nodes)

    def summary(self) -> dict[str, object]:
        return {
            "nodes": len(self.nodes),
            "placed": self.placed_count,
            "unplaced": len(self.unplaced_pods),
            "cost_per_hour": round(self.total_cost_per_hour, 4),
            "backend": self.backend,
            "solve_seconds": round(self.solve_seconds, 6),
        }


def bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (next power of two past the ladder)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] if n <= buckets[-1] else _next_pow2(n)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


GROUP_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048)
OFFERING_BUCKETS = (128, 256, 512, 1024, 2048, 3072, 4096)
NODE_BUCKETS = (64, 128, 256, 384, 512, 1024, 2048, 4096, 8192, 16384)
COO_BUCKETS = (256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536)
LABELROW_BUCKETS = (4, 16, 64, 256, 1024, 4096)
# padded widths of a batch of windows (its rows past C repeat row 0)
BATCH_BUCKETS = (2, 4, 8, 16, 32)

# The shared fit-count sentinel: "no capacity constraint" in the
# per-resource fit division, on both sides of every parity pair (the
# CUDA kernel receives it from the wrapper, never as its own literal).
FIT_BIG = 1 << 30
