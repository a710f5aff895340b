"""Sharded-plane interface types: the plan union and the rebalance
decision (port of ``karpenter_tpu/sharded/types.py``)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.solver.types import Plan


@dataclass
class ShardedPlan:
    """The union of per-shard plans for one window.

    Shard plans are independent by construction (disjoint pod
    partitions, each shard opening its own nodes), so the merged view is
    a plain concatenation: node indices in shard order, costs summed.
    The per-shard plans stay addressable for the parity checks."""

    plans: list[Plan] = field(default_factory=list)
    shard_pods: list[int] = field(default_factory=list)
    backend: str = "sharded"
    solve_seconds: float = 0.0

    @property
    def num_shards(self) -> int:
        return len(self.plans)

    def merged(self) -> Plan:
        nodes = [n for p in self.plans for n in p.nodes]
        unplaced = [pn for p in self.plans for pn in p.unplaced_pods]
        out = Plan(nodes=nodes, unplaced_pods=unplaced,
                   total_cost_per_hour=sum(p.total_cost_per_hour
                                           for p in self.plans),
                   backend=self.backend, solve_seconds=self.solve_seconds)
        for p in self.plans:
            out.unplaced_reasons.update(p.unplaced_reasons)
            out.unplaced_words.update(p.unplaced_words)
            out.unplaced_nearest.update(p.unplaced_nearest)
        return out

    def summary(self) -> dict:
        return {
            "shards": self.num_shards,
            "shard_pods": list(self.shard_pods),
            "nodes": sum(len(p.nodes) for p in self.plans),
            "unplaced": sum(len(p.unplaced_pods) for p in self.plans),
            "cost_per_hour": round(sum(p.total_cost_per_hour
                                       for p in self.plans), 4),
            "backend": self.backend,
            "solve_seconds": round(self.solve_seconds, 6),
        }


@dataclass
class RebalanceDecision:
    """One rebalance tick's outcome: the device-computed pick plus the
    host-applied ownership moves."""

    donor: int
    receiver: int
    amount: int                     # pods the decision asked to move
    skew: int                       # max - min pods over shards
    pressure: np.ndarray            # int32 [S, K] input matrix
    tile: np.ndarray                # int32 [S, 7] device decision tile
    moved_keys: list[str] = field(default_factory=list)

    @property
    def migrated(self) -> bool:
        return bool(self.moved_keys)
