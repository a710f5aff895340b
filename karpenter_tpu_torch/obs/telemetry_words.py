"""Telemetry words: the per-window solver-quality slots on the result wire.

Port of the wire half of ``karpenter_tpu/obs/telemetry_words.py``: the
slot registry (wire order), the strict decode of a packed result's
telemetry block, the host-slot fill, and the numpy oracle of the block
(:func:`telemetry_words_np`, which the what-if oracle packs).  The device
reduction that writes the block is ``solver/packed.telemetry_words``.  The metric
families and the flight-recorder ring the reference feeds belong to its
observability plane, which this package does not carry; decoded slots
land in ``TorchSolver.last_stats["telemetry"]`` instead.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.solver.result_layout import (
    BP_SCALE, SLOT_BINDING_GROUPS, SLOT_COO_GROWTHS, SLOT_ESCALATIONS,
    SLOT_FILL_ACCEL_BP, SLOT_FILL_CPU_BP, SLOT_FILL_MEM_BP,
    SLOT_FILL_PODS_BP, SLOT_GROUPS_PLACED, SLOT_GROUPS_UNPLACED,
    SLOT_NODES_OPEN, SLOT_PODS_UNPLACED, SLOT_SLACK_MEAN_BP,
    SLOT_SLACK_MIN_BP, TELEMETRY_MAGIC, TELEMETRY_SLOT_COUNT,
    SuffixLayoutError, unpack_telemetry_words,
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


# -- numpy oracle (the device twin is solver/packed.telemetry_words) ---------


def _addmod_np(a: np.ndarray, b: np.ndarray,
               den: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``((a + b) mod den, carry)`` without forming ``a + b`` (both are
    below ``den``, which may be near int32 max; ``den - b`` never
    overflows)."""
    room = (den - b).astype(np.int32)
    wrap = a >= room
    out = np.where(wrap, a - room, a + b).astype(np.int32)
    return out, wrap.astype(np.int32)


def frac_bp_np(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """``floor(clip(num, 0, den) * BP_SCALE / den)`` in pure int32 by
    base-10 long division (``solver/packed.frac_bp``); ``den <= 0``
    reads as empty -> 0."""
    num = np.asarray(num, np.int32)
    den = np.asarray(den, np.int32)
    den1 = np.maximum(den, np.int32(1))
    num1 = np.clip(num, np.int32(0), den1)
    bp = (num1 // den1).astype(np.int32)
    r = (num1 - bp * den1).astype(np.int32)
    for _ in range(4):
        r0 = r
        r, c = _addmod_np(r, r, den1)               # 2r
        q = c
        r, c = _addmod_np(r, r, den1)               # 4r
        q = (q * np.int32(2) + c).astype(np.int32)
        r, c = _addmod_np(r, r0, den1)              # 5r
        q = (q + c).astype(np.int32)
        r, c = _addmod_np(r, r, den1)               # 10r
        q = (q * np.int32(2) + c).astype(np.int32)
        bp = (bp * np.int32(10) + q).astype(np.int32)
    return np.clip(bp, np.int32(0), np.int32(BP_SCALE))


def telemetry_words_np(meta: np.ndarray, node_off: np.ndarray,
                       assign: np.ndarray, unplaced: np.ndarray,
                       off_alloc: np.ndarray,
                       binding=None) -> np.ndarray:
    """Host oracle for the device telemetry reduction: the full
    [1 + TELEMETRY_SLOT_COUNT] int32 block (magic word first), equal to
    ``solver/packed.telemetry_words``.  Every reduction carries an
    explicit int32 dtype, so numpy cannot widen to int64 and part from
    the device's wraparound."""
    meta = np.asarray(meta, np.int32)
    node_off = np.asarray(node_off, np.int32)
    assign = np.asarray(assign, np.int32)
    unplaced = np.asarray(unplaced, np.int32)
    off_alloc = np.asarray(off_alloc, np.int32)
    req = meta[:, :4]
    count = meta[:, 4]
    open_mask = node_off >= 0                                       # [N]
    safe = np.where(open_mask, node_off, 0)
    caps = (off_alloc[safe]
            * open_mask[:, None].astype(np.int32))                  # [N,4]
    load = np.einsum("gn,gr->nr", assign, req,
                     dtype=np.int32).astype(np.int32)
    load = load * open_mask[:, None].astype(np.int32)
    cap_tot = caps.sum(axis=0, dtype=np.int32)                      # [4]
    load_tot = load.sum(axis=0, dtype=np.int32)
    fill = frac_bp_np(load_tot, cap_tot)
    fill = np.where(cap_tot > 0, fill, np.int32(0))
    resid = (caps - load).astype(np.int32)
    node_bp = np.where(caps > 0, frac_bp_np(resid, caps),
                       np.int32(BP_SCALE)).min(axis=1).astype(np.int32)
    nodes_open = open_mask.sum(dtype=np.int32)
    any_open = nodes_open > 0
    slack_min = np.where(open_mask, node_bp,
                         np.int32(BP_SCALE)).min().astype(np.int32)
    slack_sum = np.where(open_mask, node_bp,
                         np.int32(0)).sum(dtype=np.int32)
    slack_mean = slack_sum // np.maximum(nodes_open, np.int32(1))
    live = count > 0
    placed_g = live & ((count - unplaced) > 0)
    unplaced_g = live & (unplaced > 0)
    binding_n = np.int32(0) if binding is None \
        else (np.asarray(binding, bool) & live).sum(dtype=np.int32)
    words = np.zeros(1 + TELEMETRY_SLOT_COUNT, np.int32)
    words[0] = TELEMETRY_MAGIC
    s = words[1:]
    s[SLOT_FILL_CPU_BP] = fill[0]
    s[SLOT_FILL_MEM_BP] = fill[1]
    s[SLOT_FILL_ACCEL_BP] = fill[2]
    s[SLOT_FILL_PODS_BP] = fill[3]
    s[SLOT_SLACK_MIN_BP] = slack_min if any_open else np.int32(0)
    s[SLOT_SLACK_MEAN_BP] = slack_mean if any_open else np.int32(0)
    s[SLOT_NODES_OPEN] = nodes_open
    s[SLOT_GROUPS_PLACED] = placed_g.sum(dtype=np.int32)
    s[SLOT_GROUPS_UNPLACED] = unplaced_g.sum(dtype=np.int32)
    s[SLOT_PODS_UNPLACED] = np.where(live, unplaced,
                                     0).sum(dtype=np.int32)
    s[SLOT_BINDING_GROUPS] = binding_n
    return words
