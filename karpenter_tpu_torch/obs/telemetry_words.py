"""Telemetry words: the per-window solver-quality slots on the result wire.

Port of the wire half of ``karpenter_tpu/obs/telemetry_words.py``: the
slot registry (wire order), the strict decode of a packed result's
telemetry block, and the host-slot fill.  The device reduction that
writes the block is ``solver/packed.telemetry_words``.  The metric
families and the flight-recorder ring the reference feeds belong to its
observability plane, which this package does not carry; decoded slots
land in ``TorchSolver.last_stats["telemetry"]`` instead.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.solver.result_layout import (
    SLOT_COO_GROWTHS, SLOT_ESCALATIONS, SuffixLayoutError,
    unpack_telemetry_words,
)

# The slot registry: (name, source) in WIRE ORDER — must enumerate
# identically to result_layout's SLOT_* indices.  "device" slots are
# masked reductions inside the solve; "host" slots are zero on the wire
# and filled at decode time.
TELEMETRY_SLOTS = (
    ("fill_cpu_bp", "device"),
    ("fill_mem_bp", "device"),
    ("fill_accel_bp", "device"),
    ("fill_pods_bp", "device"),
    ("slack_min_bp", "device"),
    ("slack_mean_bp", "device"),
    ("nodes_open", "device"),
    ("groups_placed", "device"),
    ("groups_unplaced", "device"),
    ("pods_unplaced", "device"),
    ("binding_groups", "device"),
    ("escalations", "host"),
    ("coo_growths", "host"),
    ("delta_words", "host"),
    ("rebalance_skew", "host"),
)

SLOT_NAMES = tuple(name for name, _ in TELEMETRY_SLOTS)


def decode_window(out_np: np.ndarray, G: int, N: int, K: int, *,
                  dense16: bool = False, coo16: bool = False,
                  escalations: int = 0,
                  coo_growths: int = 0) -> dict | None:
    """Slot name -> value for one packed result, host slots filled.
    Telemetry never fails a solve: a buffer without the expected suffix
    decodes to None."""
    try:
        slots = unpack_telemetry_words(np.asarray(out_np), G, N, K,
                                       dense16, coo16)
    except SuffixLayoutError:
        return None
    s = np.asarray(slots, np.int32).copy()
    s[SLOT_ESCALATIONS] = escalations
    s[SLOT_COO_GROWTHS] = coo_growths
    return {name: int(s[i]) for i, name in enumerate(SLOT_NAMES)}
