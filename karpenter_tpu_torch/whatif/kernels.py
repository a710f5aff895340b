"""The stacked K-scenario solve on the device.

Port of ``karpenter_tpu/whatif/kernels.py``.  The reference vmaps, over
the scenario axis, a delta-apply (``base.at[didx].set(dval,
mode="drop")``), ``_unpack_problem``, ``solve_core`` and the result
packer.  Here the deltas are applied into K copies of the baseline in
one scatter (:func:`apply_deltas`), and the K buffers go through
``solve_packed_batch_torch`` with the catalog shared (stride 0): one
``ffd_scan_fleet`` launch and one ``cost_sum`` launch for all K
scenarios.  Each row is then word for word the single-window solve of
the perturbed buffer, which is what ``validate_whatif`` replays.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.solver.packed import solve_packed_batch_torch


def apply_deltas(base: torch.Tensor, didx: torch.Tensor,
                 dval: torch.Tensor) -> torch.Tensor:
    """``base`` int32 [L] and padded deltas ``didx``/``dval`` int32
    [K, D] -> the K perturbed buffers [K, L].  The copies carry one
    spare word (index L): padding entries, and any index outside
    [0, L), land there and are cut off, as the reference's
    ``mode="drop"`` drops them.  ``diff_words`` never repeats an index
    within a row, so the scatter's order cannot matter."""
    K = didx.shape[0]
    L = base.shape[0]
    bufs = torch.zeros((K, L + 1), dtype=torch.int32, device=base.device)
    bufs[:, :L] = base
    idx = didx.long()
    idx = torch.where((idx >= 0) & (idx < L), idx, L)
    bufs.scatter_(1, idx, dval)
    return bufs[:, :L]


def solve_scenarios(base, didx, dval, off_alloc, off_price, off_rank, *,
                    G: int, O: int, U: int, N: int,
                    right_size: bool = True, compact: int = 0,
                    dense16: bool = False, coo16: bool = False):
    """The stacked scenario solve on the device the inputs lie on:
    ``base`` int32 [L] (the packed baseline), ``didx``/``dval`` int32
    [K, D] (per-scenario word deltas, drop-index padded) -> the stacked
    result buffer [K, Lo], still on the device."""
    bufs = apply_deltas(base, didx, dval)
    return solve_packed_batch_torch(
        bufs, off_alloc, off_price, off_rank, C=int(didx.shape[0]), G=G,
        O=O, U=U, N=N, right_size=right_size, compact=compact,
        dense16=dense16, coo16=coo16)
