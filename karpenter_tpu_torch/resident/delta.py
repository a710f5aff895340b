"""Delta encoder: a window as the words that changed against the resident
buffer (port of ``karpenter_tpu/resident/delta.py``).

The packed problem buffer (``pack_input``: [G, 8] meta rows, then the
label-row bits) is a content-addressed lowering of a window: pod
arrivals and departures change a few meta rows, constraint changes flip
label-row words.  The least correct delta between two windows is the set
of int32 words that differ, found with one vectorized comparison against
the host mirror and padded to a ladder of sizes.  Applying the delta on
the device reproduces the host buffer word for word, so a resident solve
equals a solve of the freshly packed buffer by construction.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from karpenter_tpu_torch.apis.pod import pod_key
from karpenter_tpu_torch.solver.types import (
    GROUP_BUCKETS, LABELROW_BUCKETS, OFFERING_BUCKETS, bucket,
)

# delta-size rungs: the (didx, dval) pair is padded up to one of these.
# Padding entries carry an index one past the buffer, which the device
# scatter writes into a spare word that the solve never reads.
DELTA_BUCKETS = (64, 256, 1024, 4096, 16384, 65536)

# a delta larger than this fraction of the buffer loses to a plain
# re-upload; the window rebuilds instead
REBUILD_FRACTION = 0.5


@dataclass(frozen=True)
class WindowDelta:
    """What one window cost against the resident state."""

    mode: str              # "hit" (no change) | "delta" | "rebuild"
    words: int             # changed int32 words (0 for a hit; the buffer
                           # size for a rebuild)
    h2d_bytes: int         # bytes this window moved host -> device
    reason: str = ""       # rebuild reason ("" unless mode == "rebuild")
    arrivals: int = 0      # pod churn, when the caller tracked pod keys
    departures: int = 0


def diff_words(mirror: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """int64 indices of the words that differ between the mirror and the
    window's packed buffer (both flat int32, same length)."""
    return np.nonzero(mirror != packed)[0]


def pad_delta(idx: np.ndarray, val: np.ndarray, drop_index: int,
              buckets=DELTA_BUCKETS) -> tuple[np.ndarray, np.ndarray]:
    """Pad ``(idx, val)`` up to the smallest bucket; padding rows carry
    ``drop_index`` (one past the buffer's end), which the device drops."""
    d_pad = bucket(max(int(idx.size), 1), buckets)
    didx = np.full(d_pad, drop_index, dtype=np.int32)
    dval = np.zeros(d_pad, dtype=np.int32)
    didx[:idx.size] = idx
    dval[:idx.size] = val
    return didx, dval


def empty_delta(drop_index: int) -> tuple[np.ndarray, np.ndarray]:
    """The all-padding pair of a window with no words to move (a rebuild,
    which uploads the whole buffer, or a hit)."""
    return pad_delta(np.empty(0, np.int64), np.empty(0, np.int32),
                     drop_index)


def pod_churn(prev_keys: frozenset, pods) -> tuple[int, int, frozenset]:
    """(arrivals, departures, current key set) between two windows."""
    cur = frozenset(pod_key(p) for p in pods)
    return len(cur - prev_keys), len(prev_keys - cur), cur


def pack_window(problem) -> tuple[np.ndarray, tuple[int, int, int]]:
    """An EncodedProblem as its bucket-padded packed buffer + shape key
    (G_pad, O_pad, U_pad): the padding and packing of
    ``TorchSolver._prepare`` (the same ``pack_input`` / ``dedup_rows`` /
    ``_pad*``), so a host tracker and the solver agree word for word."""
    from karpenter_tpu_torch.solver.torch_backend import (
        _pad1, _pad2, dedup_rows, pack_input,
    )

    G = problem.num_groups
    O = problem.catalog.num_offerings
    G_pad = bucket(G, GROUP_BUCKETS)
    O_pad = bucket(O, OFFERING_BUCKETS)
    if problem.label_rows is not None and problem.label_idx is not None:
        rows, label_idx = problem.label_rows, problem.label_idx
    else:
        label_idx, rows = dedup_rows(problem.compat)
    U_pad = bucket(max(rows.shape[0], 1), LABELROW_BUCKETS)
    packed = pack_input(_pad2(problem.group_req, G_pad),
                        _pad1(problem.group_count, G_pad),
                        _pad1(problem.group_cap, G_pad),
                        _pad1(label_idx, G_pad),
                        _pad2(rows, U_pad, O_pad),
                        group_prio=_pad1(problem.group_prio, G_pad))
    return packed, (G_pad, O_pad, U_pad)
