"""Telemetry words: the per-window solver-quality slots on the result wire.

Port of ``karpenter_tpu/obs/telemetry_words.py``: the slot registry
(wire order), the strict decode of a packed result's telemetry block,
the record step every solve plane's decode site calls
(:func:`decode_and_record`: fill the host-sourced slots, set the
``solve_quality_*`` metric families, append to the flight recorder's
telemetry ring, feed the watchdog's quality detector), the sharded
plane's rebalance-skew note, the ring's :func:`summary`, and the numpy
oracle of the block (:func:`telemetry_words_np`, which the what-if
oracle packs).  The device reduction that writes the block is
``solver/packed.telemetry_words``.
"""

from __future__ import annotations

import threading

import numpy as np

from karpenter_tpu_torch.solver.result_layout import (
    BP_SCALE, SLOT_BINDING_GROUPS, SLOT_COO_GROWTHS, SLOT_DELTA_WORDS,
    SLOT_ESCALATIONS, SLOT_FILL_ACCEL_BP, SLOT_FILL_CPU_BP, SLOT_FILL_MEM_BP,
    SLOT_FILL_PODS_BP, SLOT_GROUPS_PLACED, SLOT_GROUPS_UNPLACED,
    SLOT_NODES_OPEN, SLOT_PODS_UNPLACED, SLOT_REBALANCE_SKEW,
    SLOT_SLACK_MEAN_BP,
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


HOST_SLOTS = (SLOT_ESCALATIONS, SLOT_COO_GROWTHS, SLOT_DELTA_WORDS,
              SLOT_REBALANCE_SKEW)

_FILL_SLOTS = ((SLOT_FILL_CPU_BP, "cpu"), (SLOT_FILL_MEM_BP, "mem"),
               (SLOT_FILL_ACCEL_BP, "accel"), (SLOT_FILL_PODS_BP, "pods"))


# -- host edge: decode, fill host slots, record ------------------------------

# the last rebalance skew the sharded plane observed: a plane-level fact
# (not per-window device data), stamped into SLOT_REBALANCE_SKEW of the
# windows recorded after it
_SKEW_LOCK = threading.Lock()
_LAST_REBALANCE_SKEW = 0


def note_rebalance_skew(skew: int) -> None:
    """The sharded rebalance's observed pod-count skew, stamped into the
    host-sourced rebalance_skew slot of later recorded windows."""
    global _LAST_REBALANCE_SKEW
    with _SKEW_LOCK:
        _LAST_REBALANCE_SKEW = int(skew)


def decode_slots(out_np: np.ndarray, G: int, N: int, K: int,
                 dense16: bool = False,
                 coo16: bool = False) -> np.ndarray:
    """Strict telemetry decode of a packed result buffer (raises
    ``SuffixLayoutError`` on an old-layout buffer, see
    ``solver/result_layout.py``)."""
    return unpack_telemetry_words(np.asarray(out_np), G, N, K,
                                  dense16, coo16)


def record_window(plane: str, slots: np.ndarray, *,
                  escalations: int = 0, coo_growths: int = 0,
                  delta_words: int = 0) -> dict:
    """One decoded window's telemetry: fill the host-sourced slots, set
    the solve_quality metric families, append to the flight recorder's
    telemetry ring and feed the watchdog's quality detector.  Returns
    the entry (``plane`` and every slot by name)."""
    # lazy imports: obs' package __init__ and the watchdog both reach
    # back into obs modules, so a module-top import could meet the
    # package half-built
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.obs.watchdog import get_watchdog
    from karpenter_tpu_torch.utils import metrics

    s = np.asarray(slots, np.int32).copy()
    s[SLOT_ESCALATIONS] = escalations
    s[SLOT_COO_GROWTHS] = coo_growths
    s[SLOT_DELTA_WORDS] = delta_words
    with _SKEW_LOCK:
        s[SLOT_REBALANCE_SKEW] = _LAST_REBALANCE_SKEW
    for idx, resource in _FILL_SLOTS:
        metrics.SOLVE_QUALITY_FILL.labels(plane, resource).set(
            int(s[idx]) / BP_SCALE)
    metrics.SOLVE_QUALITY_SLACK.labels(plane, "min").set(
        int(s[SLOT_SLACK_MIN_BP]) / BP_SCALE)
    metrics.SOLVE_QUALITY_SLACK.labels(plane, "mean").set(
        int(s[SLOT_SLACK_MEAN_BP]) / BP_SCALE)
    for idx, kind in ((SLOT_NODES_OPEN, "nodes_open"),
                      (SLOT_GROUPS_PLACED, "groups_placed"),
                      (SLOT_GROUPS_UNPLACED, "groups_unplaced"),
                      (SLOT_PODS_UNPLACED, "pods_unplaced"),
                      (SLOT_BINDING_GROUPS, "binding_groups")):
        metrics.SOLVE_QUALITY_COUNT.labels(plane, kind).set(int(s[idx]))
    metrics.SOLVE_QUALITY_WINDOWS.labels(plane).inc()
    if escalations:
        metrics.SOLVE_QUALITY_ESCALATIONS.labels(plane, "node").inc(
            escalations)
    if coo_growths:
        metrics.SOLVE_QUALITY_ESCALATIONS.labels(plane, "coo").inc(
            coo_growths)
    entry = {"plane": plane}
    entry.update({name: int(s[i]) for i, name in enumerate(SLOT_NAMES)})
    obs.get_recorder().add_telemetry(entry)
    fill_bp = max(int(s[idx]) for idx, _ in _FILL_SLOTS)
    get_watchdog().note_quality(plane, fill_bp,
                               escalations=escalations + coo_growths)
    return entry


def decode_and_record(out_np: np.ndarray, G: int, N: int, K: int, *,
                      dense16: bool = False, coo16: bool = False,
                      plane: str = "scan", escalations: int = 0,
                      coo_growths: int = 0,
                      delta_words: int = 0) -> dict | None:
    """Decode and record in one call, as every solve plane's decode site
    does.  Telemetry never fails a solve: a buffer without the expected
    suffix records nothing and returns None."""
    try:
        slots = decode_slots(out_np, G, N, K, dense16, coo16)
    except SuffixLayoutError:
        return None
    return record_window(plane, slots, escalations=escalations,
                         coo_growths=coo_growths, delta_words=delta_words)


def summary() -> dict:
    """The recorder's telemetry ring by plane: the window count, the
    latest slots, and the mean fill and unplaced pods over the retained
    ring."""
    from karpenter_tpu_torch import obs

    entries = obs.get_recorder().telemetry()
    planes: dict[str, dict] = {}
    for e in entries:
        p = planes.setdefault(e["plane"], {
            "windows": 0, "fill_bp_sum": 0, "pods_unplaced_sum": 0,
            "escalations": 0, "coo_growths": 0, "last": None})
        p["windows"] += 1
        p["fill_bp_sum"] += max(e["fill_cpu_bp"], e["fill_mem_bp"],
                                e["fill_accel_bp"], e["fill_pods_bp"])
        p["pods_unplaced_sum"] += e["pods_unplaced"]
        p["escalations"] += e["escalations"]
        p["coo_growths"] += e["coo_growths"]
        p["last"] = {k: v for k, v in e.items() if k != "plane"}
    out = {}
    for plane, p in planes.items():
        n = p["windows"]
        out[plane] = {
            "windows": n,
            "mean_fill_fraction": round(p["fill_bp_sum"] / n / BP_SCALE, 4),
            "mean_pods_unplaced": round(p["pods_unplaced_sum"] / n, 2),
            "escalations": p["escalations"],
            "coo_growths": p["coo_growths"],
            "last": p["last"],
        }
    return {
        "slots": [{"index": i, "name": name, "source": source}
                  for i, (name, source) in enumerate(TELEMETRY_SLOTS)],
        "host_slot_indices": list(HOST_SLOTS),
        "windows_recorded": len(entries),
        "planes": out,
    }


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
