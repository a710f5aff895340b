"""Numpy twins of the serving programs and the host replay of the ring
(port of ``karpenter_tpu/serving/oracle.py``).

``apply_ring_np`` drops out-of-range indices as the device scatter does
(which writes them into its spare word); ``serve_window_np`` is
slot-apply then a solve of the caller's choosing.  ``RingOracle`` replays
every admitted slot in sequence order: its mirror must equal the device
state word for word.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.resident.delta import DELTA_BUCKETS


def apply_ring_np(state: np.ndarray, didx: np.ndarray,
                  dval: np.ndarray) -> np.ndarray:
    """Scatter one padded slot into a copy of ``state``; indices outside
    the buffer (the padding) are dropped."""
    flat = np.asarray(state, dtype=np.int32).reshape(-1).copy()
    didx = np.asarray(didx, dtype=np.int64).reshape(-1)
    dval = np.asarray(dval, dtype=np.int32).reshape(-1)
    live = (didx >= 0) & (didx < flat.size)
    flat[didx[live]] = dval[live]
    return flat.reshape(np.asarray(state).shape)


def serve_window_np(state: np.ndarray, didx: np.ndarray,
                    dval: np.ndarray, solve_fn):
    """Slot-apply, then ``solve_fn`` of the updated state: returns
    ``(new_state, solve_fn(new_state))``."""
    new_state = apply_ring_np(state, didx, dval)
    return new_state, solve_fn(new_state)


class RingOracle:
    """Replay of every admitted ring slot, in sequence order; a slot seen
    twice or out of order, or off the wire format, raises."""

    __slots__ = ("mirror", "applied", "last_seq")

    def __init__(self):
        self.mirror: np.ndarray | None = None
        self.applied = 0
        self.last_seq = -1

    def reset(self) -> None:
        self.mirror = None
        self.applied = 0
        self.last_seq = -1

    def _check_seq(self, seq: int) -> None:
        if seq <= self.last_seq:
            raise AssertionError(f"ring slot {seq} replayed out of order "
                                 f"(last {self.last_seq})")

    def rebuild(self, seq: int, flat: np.ndarray) -> None:
        """A rebuild slot replaces the whole mirror."""
        self._check_seq(seq)
        self.mirror = np.asarray(flat, dtype=np.int32).reshape(-1).copy()
        self.applied += 1
        self.last_seq = seq

    def apply(self, seq: int, didx: np.ndarray, dval: np.ndarray) -> None:
        if self.mirror is None:
            raise AssertionError("ring oracle saw a delta slot before any "
                                 "rebuild")
        self._check_seq(seq)
        if np.asarray(didx).size not in DELTA_BUCKETS:
            raise AssertionError(f"ring slot {seq} width "
                                 f"{np.asarray(didx).size} is not a "
                                 f"DELTA_BUCKETS rung")
        self.mirror = apply_ring_np(self.mirror, didx, dval)
        self.applied += 1
        self.last_seq = seq

    def diverges(self, device_state: np.ndarray) -> int:
        """Words that differ between the replay and a fetched device state
        (0 = converged, -1 = no replay yet)."""
        if self.mirror is None:
            return -1
        dev = np.asarray(device_state, dtype=np.int32).reshape(-1)
        if dev.size != self.mirror.size:
            return max(dev.size, self.mirror.size)
        return int(np.count_nonzero(dev != self.mirror))


__all__ = ["DELTA_BUCKETS", "apply_ring_np", "serve_window_np",
           "RingOracle"]
