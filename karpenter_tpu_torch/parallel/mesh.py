"""Device meshes (port of ``karpenter_tpu/parallel/mesh.py``).

The fleet axis (clusters) is the data-parallel dimension; the offer axis
(one cluster's catalog split across devices, combined with the
collectives of ``parallel/collectives.py``) the model-parallel one; the
shard axis carries the sharded service's shards.

A :class:`Mesh` is a numpy object array of ``torch.device`` slots with
named axes: ``mesh.shape[AXIS]`` is an axis's width and
``mesh.devices.flat`` walks the slots in order, the two things the
reference reads of its ``jax.sharding.Mesh``.  The default slots are
every CUDA device (each through ``device.resolve_device``, so a machine
without a card raises); there is no CPU default.  The tests pass CPU
slots ``torch.device("cpu", i)``: tensors placed on one land on the CPU,
and the health board's id of slot i is ``cpu:i``, the reference's id of
its i-th virtual CPU device.
"""

from __future__ import annotations

from collections.abc import Sequence
from contextlib import nullcontext

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device

FLEET_AXIS = "fleet"
OFFER_AXIS = "offer"
SHARD_AXIS = "shard"


class Mesh:
    """Slots (``torch.device``) laid out over named axes."""

    __slots__ = ("devices", "axis_names", "shape")

    def __init__(self, devices, axis_names: tuple[str, ...]):
        arr = np.empty(np.shape(devices), dtype=object)
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).flat]
        arr.reshape(-1)[:] = flat
        if arr.ndim != len(axis_names):
            raise ValueError(f"mesh of rank {arr.ndim} needs as many axis "
                             f"names, got {axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in flat}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh's slots are all cuda or all cpu, got "
                             f"{sorted(kinds)}")
        if len(set(flat)) != len(flat):
            raise ValueError(f"a mesh repeats a slot: {flat}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))


def on_slot(dev: torch.device):
    """The slot's device as the current CUDA device, so that its current
    stream takes the slot's work (a kernel launch, a copy's event);
    nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def default_devices() -> list[torch.device]:
    """Every CUDA device, each resolved (a machine without a card
    raises)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        resolve_device("cuda")          # raises: no card
    return [resolve_device(torch.device("cuda", i)) for i in range(n)]


def fleet_mesh(n_devices: int | None = None,
               devices: Sequence | None = None) -> Mesh:
    """1D mesh over clusters (the fleet config of BASELINE.json #5)."""
    if devices is None:
        devices = default_devices()
    devices = list(devices)[:n_devices] if n_devices else list(devices)
    return Mesh(np.array(devices, dtype=object), (FLEET_AXIS,))


def shard_mesh(num_shards: int, devices: Sequence | None = None) -> Mesh:
    """1D mesh for the sharded continuous-solve service: ``num_shards``
    logical shards on up to ``num_shards`` devices.

    With fewer devices than shards the mesh spans the largest divisor of
    ``num_shards`` that fits the device count, and each slot carries
    ``num_shards / width`` shards; the shards' plans are the same either
    way, only the parallel width changes."""
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    devices = list(devices) if devices is not None else default_devices()
    width = 1
    for d in range(min(num_shards, len(devices)), 0, -1):
        if num_shards % d == 0:
            width = d
            break
    return Mesh(np.array(devices[:width], dtype=object), (SHARD_AXIS,))


def solver_mesh(fleet: int, offer: int,
                devices: Sequence | None = None) -> Mesh:
    """2D mesh: fleet (cluster data-parallel) x offer (catalog
    model-parallel)."""
    devices = list(devices) if devices is not None else default_devices()
    if fleet * offer > len(devices):
        raise ValueError(f"mesh {fleet}x{offer} needs {fleet * offer} "
                         f"devices, have {len(devices)}")
    arr = np.array(devices[:fleet * offer], dtype=object).reshape(fleet,
                                                                 offer)
    return Mesh(arr, (FLEET_AXIS, OFFER_AXIS))
