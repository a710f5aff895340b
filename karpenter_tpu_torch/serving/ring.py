"""The serving loop's staging and output ring (port of
``karpenter_tpu/serving/ring.py``).

- ``Staging`` — uploads each admitted window's padded ``(word index,
  word value)`` pair.  On the card it stages the pair through
  ``RING_SLOTS`` pinned host pairs used in rotation, each refilled only
  after its last copy has finished (a CUDA event recorded behind it), so
  a fill never waits on the window just kicked.
- ``OutputRing`` — kicked results between kick and fetch, sequence
  numbered, indexed by ``seq % capacity`` with monotonic ``head`` (next
  unfetched) and ``tail`` (next assigned) counters.  ``push`` starts the
  device-to-host copy at once (``torch_backend.start_fetch``: pinned
  memory and a CUDA event on the current stream, behind the kick), so
  the copy of window k overlaps the kick of window k + 1.

The reference also queues admitted deltas in an input ring; its loop
pops each slot in the call that pushed it, so the port uploads the pair
and kicks at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.serving import RING_SLOTS


class Staging:
    """The upload of admitted deltas to ``device``: on the card through
    ``slots`` pinned host pairs in rotation; on the CPU a copy."""

    __slots__ = ("device", "uploads", "_pairs")

    def __init__(self, slots: int = RING_SLOTS, device="cuda"):
        if slots < 1:
            raise ValueError(f"staging needs >= 1 slot, got {slots}")
        self.device = resolve_device(device)
        self.uploads = 0
        # per slot on the card: (pinned didx, pinned dval, event after the
        # last copy out of them)
        self._pairs: list = [None] * slots

    def upload(self, didx: np.ndarray, dval: np.ndarray):
        """The int32 pair on the device, staged through the next slot's
        pinned buffers on the card."""
        host_didx = np.ascontiguousarray(didx, dtype=np.int32)
        host_dval = np.ascontiguousarray(dval, dtype=np.int32)
        i = self.uploads % len(self._pairs)
        self.uploads += 1
        if self.device.type != "cuda":
            return (torch.from_numpy(host_didx.copy()),
                    torch.from_numpy(host_dval.copy()))
        staged = self._pairs[i]
        if staged is not None:
            staged[2].synchronize()        # the slot's last copy is done
        if staged is None or staged[0].shape[0] != host_didx.size:
            staged = (torch.empty(host_didx.size, dtype=torch.int32,
                                  pin_memory=True),
                      torch.empty(host_dval.size, dtype=torch.int32,
                                  pin_memory=True),
                      torch.cuda.Event())
        staged[0].numpy()[:] = host_didx
        staged[1].numpy()[:] = host_dval
        pair = (staged[0].to(self.device, non_blocking=True),
                staged[1].to(self.device, non_blocking=True))
        staged[2].record()
        self._pairs[i] = staged
        return pair


@dataclass(slots=True)
class OutputSlot:
    """One kicked result: its device buffer, the host copy in flight and
    the event that marks the copy's end."""

    seq: int
    dev: Any                     # device int32 packed result
    prep: Any                    # the _Prepared the decode needs
    problem: Any
    mode: str
    t_disp: float = 0.0
    t_issued: float = 0.0
    kick_seq: int = 0            # the loop's kick count at the kick
    host: Any = None             # host copy of ``dev`` (pinned on the card)
    event: Any = None            # CUDA event after the copy, or None
    done: bool = False


class OutputRing:
    """Kicked results awaiting their fetch: fixed capacity, monotonic
    head/tail, slots indexed ``seq % capacity``."""

    __slots__ = ("capacity", "head", "tail", "_slots")

    def __init__(self, capacity: int = RING_SLOTS):
        if capacity < 1:
            raise ValueError(f"ring capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.head = 0            # next seq to fetch
        self.tail = 0            # next seq to assign
        self._slots: list = [None] * capacity

    @property
    def occupancy(self) -> int:
        return self.tail - self.head

    @property
    def full(self) -> bool:
        return self.occupancy >= self.capacity

    def __len__(self) -> int:
        return self.occupancy

    def push(self, slot: OutputSlot) -> int | None:
        """Park one kicked result and start its device-to-host copy.
        None when full (the kick must check before it dispatches)."""
        if self.full:
            return None
        from karpenter_tpu_torch.solver.torch_backend import start_fetch

        slot.host, slot.event = start_fetch(slot.dev)
        seq = slot.seq = self.tail
        self._slots[seq % self.capacity] = slot
        self.tail = seq + 1
        return seq

    def take(self, seq: int) -> OutputSlot | None:
        """Claim slot ``seq`` for fetching; out of order is allowed, and
        head advances over the fetched prefix."""
        if not (self.head <= seq < self.tail):
            return None
        slot = self._slots[seq % self.capacity]
        if slot is None or slot.done:
            return None
        slot.done = True
        while self.head < self.tail:
            s = self._slots[self.head % self.capacity]
            if s is None or s.done:
                self._slots[self.head % self.capacity] = None
                self.head += 1
            else:
                break
        return slot

    def pending(self) -> list[OutputSlot]:
        """Unfetched slots oldest-first (the drain path)."""
        out = []
        for s in range(self.head, self.tail):
            slot = self._slots[s % self.capacity]
            if slot is not None and not slot.done:
                out.append(slot)
        return out


__all__ = ["RING_SLOTS", "OutputRing", "OutputSlot", "Staging"]
