"""Collectives over a mesh axis's slots: the reference's ``lax.psum`` /
``lax.pmin`` / ``lax.pmax`` and ``parallel/fleet.py::_gather_global``.

Each takes one tensor per slot (a list, in slot order, each on its
slot's device), gathers the values to the first slot's device, reduces
them in slot order and returns the result on every slot's device.  Sums
keep the operands' dtype: int32 sums wrap as the reference's, and float
sums add slot 0, then slot 1, and so on.  On one card these are plain
copies; across cards each gather is a peer copy.
"""

from __future__ import annotations

import torch


def _reduce(values, op) -> list[torch.Tensor]:
    """``op`` folded over the slots' values in slot order on the first
    slot's device, the result copied back to every slot's device."""
    dev = values[0].device
    total = values[0]
    for v in values[1:]:
        total = op(total, v if v.device == dev else v.to(dev))
    return [total if v.device == dev else total.to(v.device)
            for v in values]


def psum(values) -> list[torch.Tensor]:
    """Elementwise sum over the slots, in slot order."""
    return _reduce(values, torch.add)


def pmin(values) -> list[torch.Tensor]:
    """Elementwise minimum over the slots."""
    return _reduce(values, torch.minimum)


def pmax(values) -> list[torch.Tensor]:
    """Elementwise maximum over the slots."""
    return _reduce(values, torch.maximum)


def gather_global(values_local, global_idx, bases) -> list[torch.Tensor]:
    """Values at global offering indices from an offering-sharded
    ``[B, O_l, ...]`` array: slot w holds indices ``[bases[w], bases[w] +
    O_l)``; each slot contributes its in-range entries (zero elsewhere)
    and :func:`psum` combines them.  ``global_idx`` [B, N] per slot;
    returns [B, N, ...] per slot."""
    local = []
    for vals, idx, base in zip(values_local, global_idx, bases):
        O_l = vals.shape[1]
        pos = torch.clamp(idx - base, 0, O_l - 1).long()
        in_range = (idx >= base) & (idx < base + O_l)
        picked = torch.gather(
            vals, 1, pos.reshape(pos.shape + (1,) * (vals.dim() - 2))
            .expand(pos.shape + vals.shape[2:]))
        mask = in_range.reshape(in_range.shape + (1,) * (vals.dim() - 2))
        local.append(torch.where(mask, picked, torch.zeros_like(picked)))
    return psum(local)
