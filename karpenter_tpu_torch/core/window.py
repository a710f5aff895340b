"""Solve-window coalescer: pending-pod intake -> one batched solve.

SURVEY.md §2.7: the reference's generic Batcher (idle / max-timeout /
max-items window, pkg/batcher/batcher.go:136-196) "is the component the
north star widens into the TPU solve window".  This wraps the shared
Batcher so concurrent pod arrivals coalesce into a single solver
invocation per window, mirroring karpenter-core's provisioner batching.

(Copy of ``karpenter_tpu/core/window.py``.)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from collections.abc import Callable, Sequence

from karpenter_tpu_torch.apis.pod import PodSpec
from karpenter_tpu_torch.utils.batcher import Batcher, BatcherOptions


@dataclass
class WindowOptions:
    idle_seconds: float = 1.0       # quiet time before solving
    max_seconds: float = 10.0       # hard cap on window age
    max_pods: int = 10000           # solve immediately at this many

    def to_batcher(self) -> BatcherOptions:
        from karpenter_tpu_torch.apis.pod import pod_key

        # ledger_key: every pod added to the solve window gets its
        # window_enqueue stamp, and each fired window links its trace id
        # into the placement ledger (obs/ledger.py)
        return BatcherOptions(idle_timeout=self.idle_seconds,
                              max_timeout=self.max_seconds,
                              max_items=self.max_pods,
                              name="solve-window",
                              ledger_key=pod_key)


class SolveWindow:
    """Accumulates pods; fires ``on_window(pods)`` once per window.

    ``add`` returns a Future resolving to the per-pod outcome the handler
    reports (e.g. node name or None)."""

    def __init__(self, on_window: Callable[[Sequence[PodSpec]], Sequence[object]],
                 options: WindowOptions | None = None):
        self.options = options or WindowOptions()
        self._batcher: Batcher = Batcher(on_window, self.options.to_batcher())

    def add(self, pod: PodSpec):
        return self._batcher.add(pod)

    def add_all(self, pods: Sequence[PodSpec]) -> list:
        return [self._batcher.add(p) for p in pods]

    def close(self) -> None:
        self._batcher.close()
