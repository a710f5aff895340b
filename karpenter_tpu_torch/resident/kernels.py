"""The resident store's device programs (port of
``karpenter_tpu/resident/kernels.py``).

The reference donates the state buffer to a jitted ``.at[idx].set(val,
mode="drop")`` so that the update aliases in place.  Here the state is
one persistent device tensor, updated in place by ``scatter_``.  It
holds L + 1 words for a packed buffer of L (per row, for the sharded
service's stacked [S, L + 1] state): the padding entries of a delta
carry the index L and land in the row's spare last word, which no solve
reads (``state[..., :L]``), so no index is ever out of range.

- :func:`update_resident` applies one padded word delta in place (the
  fleet's resident input, host-side window tracking).
- :func:`solve_resident` applies the delta, then runs the packed solve of
  the main path (``solve_packed_torch``: the FFD kernel on the card) on
  the updated buffer, on one stream — the reference's ``solve_resident``
  body (``solve_core`` with the window's own node axis N).
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.solver.packed import solve_packed_torch


def new_state(flat, device) -> torch.Tensor:
    """A resident state tensor on ``device`` for the int32 buffer ``flat``
    (numpy [L], or [S, L] stacked rows): each row's L words and one spare
    word, in memory of its own (never a view of the host mirror)."""
    host = torch.zeros(flat.shape[:-1] + (flat.shape[-1] + 1,),
                       dtype=torch.int32)
    host[..., :-1] = torch.from_numpy(flat)
    if torch.device(device).type == "cuda":
        return host.pin_memory().to(device, non_blocking=True)
    return host


def update_resident(state: torch.Tensor, didx: torch.Tensor,
                    dval: torch.Tensor) -> torch.Tensor:
    """Scatter a padded word delta into ``state`` (int32 [L + 1], or
    [S, L + 1] with ``didx`` / ``dval`` [S, D], a delta per row) in
    place: entry i writes ``dval[i]`` at ``didx[i]``; an index outside
    [0, L), the padding, writes the row's spare word L and never another
    row.  Returns ``state``."""
    L = state.shape[-1] - 1
    idx = didx.long()
    idx = torch.where((idx >= 0) & (idx < L), idx, L)
    return state.scatter_(-1, idx, dval)


def solve_resident(state, didx, dval, off_alloc, off_price, off_rank, *,
                   G: int, O: int, U: int, N: int, right_size: bool = True,
                   compact: int = 0, dense16: bool = False,
                   coo16: bool = False):
    """Delta-apply + packed solve: ``state`` int32 [L + 1] (updated in
    place), ``didx`` / ``dval`` int32 [D] a padded word delta, catalog
    tensors as in ``solve_packed_torch``.  Returns ``(state, result)``;
    the result buffer is ``solve_packed_torch`` of ``state[:L]``."""
    update_resident(state, didx, dval)
    return state, solve_packed_torch(
        state[:-1], off_alloc, off_price, off_rank, G=G, O=O, U=U, N=N,
        right_size=right_size, compact=compact, dense16=dense16,
        coo16=coo16)
