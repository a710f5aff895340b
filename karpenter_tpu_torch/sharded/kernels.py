"""Device programs of the sharded solve service (port of
``karpenter_tpu/sharded/kernels.py``).

- :func:`solve_shards` — every shard's delta-apply and packed solve in
  one program.  The reference runs one ``shard_map`` over a shard mesh
  and vmaps the shards each device holds; on one card the mesh is one
  device wide and every shard folds into that vmapped axis, so the shards
  are the problem axis of the fleet kernel: the stacked state ``[S,
  L + 1]`` takes each shard's word delta in place
  (``resident/kernels.update_resident``: the padding lands in the row's
  spare word L), then
  ``solve_packed_batch_torch`` solves the S rows with the catalog shared
  (stride 0): one ``ffd_scan_fleet`` launch and one ``cost_sum`` launch
  per window.  Each result row is ``solve_packed_torch`` of that shard's
  buffer, word for word.
- :func:`rebalance_shards` — the rebalance decision: the reference's
  ``psum`` / ``pmax`` / ``pmin`` collective over the shard axis, here
  reductions over the rows of the ``[S, K]`` pressure tensor on its
  device.  Donor and receiver are the lowest shard ids among the max and
  min ties; the amount is half the imbalance (floor).
- :func:`rebalance_oracle` — the numpy oracle of that decision.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.resident.kernels import update_resident
from karpenter_tpu_torch.solver.packed import solve_packed_batch_torch

_BIG_I32 = 2 ** 31 - 1

# pressure columns (int32): [0] pending pods owned by the shard, [1]
# signature groups owned, [2] unplaced pods in the last window.  The
# donor/receiver pick keys on pods owned; the rest rides along.
PRESSURE_COLUMNS = 3


def solve_shards(state, didx, dval, off_alloc, off_price, off_rank, *,
                 G: int, O: int, U: int, N: int, right_size: bool = True):
    """The stacked sharded solve on the device the inputs lie on:
    ``state`` int32 [S, L + 1] (updated in place), ``didx`` / ``dval``
    int32 [S, D] each shard's padded delta, the catalog tensors of
    ``solve_packed_torch``.  Returns ``(state, results [S, Lo])``, both
    on the device; row s of the results is ``solve_packed_torch`` of
    ``state[s, :L]``."""
    S, L1 = state.shape
    update_resident(state, didx, dval)
    return state, solve_packed_batch_torch(
        state[:, :L1 - 1], off_alloc, off_price, off_rank, C=S, G=G, O=O,
        U=U, N=N, right_size=right_size)


def rebalance_shards(pressure: torch.Tensor) -> torch.Tensor:
    """The rebalance decision of an int32 [S, K] pressure tensor, as
    torch ops on its device: the int32 [S, 7] tile ``(donor, receiver,
    amount, skew, max, min, mean)``, every row identical.  Integer
    arithmetic in int32, as the reference's (sums wrap the same way)."""
    S = pressure.shape[0]
    dev = pressure.device
    my = pressure[:, 0]
    total0 = pressure[:, 0].sum().to(torch.int32)
    ids = torch.arange(S, dtype=torch.int32, device=dev)
    big = torch.full((), _BIG_I32, dtype=torch.int32, device=dev)
    gmax = my.max()
    gmin = my.min()
    donor = torch.where(my == gmax, ids, big).min()
    receiver = torch.where(my == gmin, ids, big).min()
    skew = gmax - gmin
    # move half the imbalance (floor): converges geometrically and never
    # overshoots into a reverse migration next tick
    amount = torch.div(torch.clamp(skew, min=0), 2, rounding_mode="floor")
    mean = torch.div(total0, S, rounding_mode="floor")
    row = torch.stack([donor, receiver, amount, skew, gmax, gmin,
                       mean]).to(torch.int32)
    return row[None, :].expand(S, row.shape[0]).contiguous()


def rebalance_oracle(pressure: np.ndarray) -> tuple[int, int, int, int]:
    """Numpy oracle of the decision: ``(donor, receiver, amount, skew)``,
    integer-exact, first-max / first-min tie-breaks."""
    my = pressure[:, 0].astype(np.int64)
    gmax, gmin = int(my.max()), int(my.min())
    donor = int(np.nonzero(my == gmax)[0][0])
    receiver = int(np.nonzero(my == gmin)[0][0])
    return donor, receiver, max(gmax - gmin, 0) // 2, gmax - gmin
