"""Lower a routed window to stacked per-shard packed buffers (port of
``karpenter_tpu/sharded/encode.py``).

Each shard's partition encodes through the ordinary ``solver/encode``
path, then packs with ``torch_backend.pack_input`` exactly as
``resident/delta.pack_window`` does, except that the pad buckets are the
maximum over the shards, so the per-shard buffers stack into one
``[S, L]`` array.  Padding is zero fill past each shard's real rows, so
a shard's padded buffer is what ``pack_window`` would give at the same
forced buckets, and the stacked solve equals the single-window solve of
each shard's buffer.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from karpenter_tpu_torch.solver.encode import (
    EncodedProblem, encode, estimate_nodes,
)
from karpenter_tpu_torch.solver.torch_backend import (
    _pad1, _pad2, dedup_rows, pack_input,
)
from karpenter_tpu_torch.solver.types import (
    GROUP_BUCKETS, LABELROW_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, bucket,
)


@dataclass
class ShardedWindow:
    """One admitted window, routed and lowered for the stacked solve."""

    problems: list[EncodedProblem]        # one per shard (may be empty)
    parts: list[list]                     # per-shard PodSpec partitions
    stacked: np.ndarray                   # int32 [S, L]
    G_pad: int
    O_pad: int
    U_pad: int
    N: int
    N_cap: int
    shard_pods: list[int] = field(default_factory=list)

    @property
    def num_shards(self) -> int:
        return int(self.stacked.shape[0])

    @property
    def shapes(self) -> tuple[int, int, int, int]:
        return (self.G_pad, self.O_pad, self.U_pad, self.N)


def pack_shard_window(problem: EncodedProblem, G_pad: int, O_pad: int,
                      U_pad: int) -> np.ndarray:
    """One shard's packed buffer at forced pad buckets."""
    if problem.label_rows is not None and problem.label_idx is not None:
        rows, label_idx = problem.label_rows, problem.label_idx
    else:
        label_idx, rows = dedup_rows(problem.compat)
    return pack_input(_pad2(problem.group_req, G_pad),
                      _pad1(problem.group_count, G_pad),
                      _pad1(problem.group_cap, G_pad),
                      _pad1(label_idx, G_pad),
                      _pad2(rows, U_pad, O_pad),
                      group_prio=_pad1(problem.group_prio, G_pad))


def encode_shards(parts: list[list], catalog, nodepool=None) -> ShardedWindow:
    """Encode every shard's partition and stack the packed buffers at the
    common pad buckets: G, O and U at the max over the shards, N at the
    max of the per-shard node estimates."""
    problems = [encode(part, catalog, nodepool) for part in parts]
    G_max = U_max = 1
    for prob in problems:
        G_max = max(G_max, prob.num_groups)
        rows = prob.label_rows if prob.label_rows is not None \
            else dedup_rows(prob.compat)[1]
        U_max = max(U_max, rows.shape[0])
    G_pad = bucket(G_max, GROUP_BUCKETS)
    O_pad = bucket(catalog.num_offerings, OFFERING_BUCKETS)
    U_pad = bucket(U_max, LABELROW_BUCKETS)
    N_cap = bucket(max(sum(len(p) for p in parts), 1), NODE_BUCKETS)
    N = max(estimate_nodes(prob, N_cap, NODE_BUCKETS) for prob in problems)
    stacked = np.stack([pack_shard_window(prob, G_pad, O_pad, U_pad)
                        for prob in problems])
    return ShardedWindow(problems=problems, parts=parts, stacked=stacked,
                         G_pad=G_pad, O_pad=O_pad, U_pad=U_pad, N=N,
                         N_cap=N_cap, shard_pods=[len(p) for p in parts])
