"""Device programs of the sharded solve service (port of
``karpenter_tpu/sharded/kernels.py``).

- :func:`solve_shards` — every shard's delta-apply and packed solve in
  one program.  The reference runs one ``shard_map`` over a shard mesh
  and vmaps the shards each device holds; here, with ``mesh=None``, the
  shards are the problem axis of the fleet kernel on one device: the
  stacked state ``[S, L + 1]`` takes each shard's word delta in place
  (``resident/kernels.update_resident``: the padding lands in the row's
  spare word L), then
  ``solve_packed_batch_torch`` solves the S rows with the catalog shared
  (stride 0): one ``ffd_scan_fleet`` launch and one ``cost_sum`` launch
  per window.  Each result row is ``solve_packed_torch`` of that shard's
  buffer, word for word.  With a shard mesh of width W, slot w holds
  shards ``[w * S / W, (w + 1) * S / W)``: its rows of the state, its
  delta and one launch of each kernel over its shards, on its device.
- :func:`rebalance_shards` — the rebalance decision: the reference's
  ``psum`` / ``pmax`` / ``pmin`` collective over the shard axis, here
  each mesh slot's reductions over its rows of the ``[S, K]`` pressure
  tensor combined by the collectives of ``parallel/collectives.py`` (one
  slot, the pressure's device, without a mesh).  Donor and receiver
  are the lowest shard ids among the max and min ties; the amount is
  half the imbalance (floor).
- :func:`rebalance_oracle` — the numpy oracle of that decision.
"""

from __future__ import annotations

import numpy as np
import torch

from karpenter_tpu_torch.parallel.collectives import pmax, pmin, psum
from karpenter_tpu_torch.parallel.mesh import SHARD_AXIS, on_slot
from karpenter_tpu_torch.resident.kernels import update_resident
from karpenter_tpu_torch.solver.packed import solve_packed_batch_torch

_BIG_I32 = 2 ** 31 - 1

# pressure columns (int32): [0] pending pods owned by the shard, [1]
# signature groups owned, [2] unplaced pods in the last window.  The
# donor/receiver pick keys on pods owned; the rest rides along.
PRESSURE_COLUMNS = 3


def solve_shards(state, didx, dval, off_alloc, off_price, off_rank, *,
                 G: int, O: int, U: int, N: int, right_size: bool = True,
                 mesh=None):
    """The stacked sharded solve on the device the inputs lie on:
    ``state`` int32 [S, L + 1] (updated in place), ``didx`` / ``dval``
    int32 [S, D] each shard's padded delta, the catalog tensors of
    ``solve_packed_torch``.  Returns ``(state, results [S, Lo])``, both
    on the device; row s of the results is ``solve_packed_torch`` of
    ``state[s, :L]``.

    With a shard ``mesh``, every argument is a list with one entry per
    slot, on that slot's device: its rows of the state, of ``didx`` and
    ``dval``, and its copy of each catalog tensor.  Returns ``(the slots'
    states, results [S, Lo] on the first slot's device)``."""
    if mesh is None:
        S, L1 = state.shape
        update_resident(state, didx, dval)
        return state, solve_packed_batch_torch(
            state[:, :L1 - 1], off_alloc, off_price, off_rank, C=S, G=G,
            O=O, U=U, N=N, right_size=right_size)
    slots = list(mesh.devices.flat)
    S = sum(int(st.shape[0]) for st in state)
    width = mesh.shape[SHARD_AXIS]
    if S % width or len(state) != width:
        raise ValueError(f"shards {S} not divisible by mesh width {width}")
    outs = []
    for w, dev in enumerate(slots):
        with on_slot(dev):
            _, out = solve_shards(state[w], didx[w], dval[w], off_alloc[w],
                                  off_price[w], off_rank[w], G=G, O=O, U=U,
                                  N=N, right_size=right_size)
            outs.append(out)
    dev0 = slots[0]
    return state, (outs[0] if width == 1
                   else torch.cat([o.to(dev0) for o in outs]))


def rebalance_shards(pressure: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rebalance decision of an int32 [S, K] pressure tensor, as
    torch ops: the int32 [S, 7] tile ``(donor, receiver, amount, skew,
    max, min, mean)``, every row identical.  Integer arithmetic in int32,
    as the reference's (sums wrap the same way).  Slot w of the shard
    ``mesh`` (by default the pressure's device alone) reduces its rows on
    its device, the collectives combine the slots and the tile lands on
    the first slot's device."""
    slots = [pressure.device] if mesh is None else list(mesh.devices.flat)
    S, W = pressure.shape[0], len(slots)
    if S % W:
        raise ValueError(f"shards {S} not divisible by mesh width {W}")
    Sl = S // W
    i32 = torch.int32
    parts = [pressure[w * Sl:(w + 1) * Sl].to(dev)
             for w, dev in enumerate(slots)]
    my = [p[:, 0] for p in parts]
    total0 = psum([m.sum().to(i32) for m in my])
    gmax = pmax([m.max() for m in my])
    gmin = pmin([m.min() for m in my])
    ids = [torch.arange(w * Sl, (w + 1) * Sl, dtype=i32, device=dev)
           for w, dev in enumerate(slots)]
    donor = pmin([torch.where(m == g, i, _BIG_I32).min()
                  for m, g, i in zip(my, gmax, ids)])
    receiver = pmin([torch.where(m == g, i, _BIG_I32).min()
                     for m, g, i in zip(my, gmin, ids)])
    tiles = []
    for d, r, hi, lo, tot in zip(donor, receiver, gmax, gmin, total0):
        skew = hi - lo
        # move half the imbalance (floor): converges geometrically and
        # never overshoots into a reverse migration next tick
        amount = torch.div(torch.clamp(skew, min=0), 2,
                           rounding_mode="floor")
        mean = torch.div(tot, S, rounding_mode="floor")
        row = torch.stack([d, r, amount, skew, hi, lo, mean]).to(i32)
        tiles.append(row[None, :].expand(Sl, row.shape[0]))
    dev0 = slots[0]
    return torch.cat([t.to(dev0) for t in tiles]).contiguous()


def rebalance_oracle(pressure: np.ndarray) -> tuple[int, int, int, int]:
    """Numpy oracle of the decision: ``(donor, receiver, amount, skew)``,
    integer-exact, first-max / first-min tie-breaks."""
    my = pressure[:, 0].astype(np.int64)
    gmax, gmin = int(my.max()), int(my.min())
    donor = int(np.nonzero(my == gmax)[0][0])
    receiver = int(np.nonzero(my == gmin)[0][0])
    return donor, receiver, max(gmax - gmin, 0) // 2, gmax - gmin
