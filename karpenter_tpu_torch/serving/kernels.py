"""The serving loop's device programs (port of
``karpenter_tpu/serving/kernels.py``).

One loop iteration is one kick: :func:`serve_window` applies a ring
slot's word delta to the resident state in place and solves the updated
buffer — the body of ``resident.kernels.solve_resident`` (on the card,
the FFD kernel), so a ring-fed window equals a classic solve of the same
buffer word for word.  :func:`apply_ring` is the scatter alone.  Both
take only slots padded to a ``DELTA_BUCKETS`` rung, the ring's wire
format.
"""

from __future__ import annotations

from karpenter_tpu_torch.resident.delta import DELTA_BUCKETS
from karpenter_tpu_torch.resident.kernels import (
    solve_resident, update_resident,
)


def _check_rung(didx) -> None:
    if didx.shape[0] not in DELTA_BUCKETS:
        raise ValueError(f"ring slot width {didx.shape[0]} is not a "
                         f"DELTA_BUCKETS rung")


def apply_ring(state, didx, dval):
    """Scatter one ring slot into the state (int32 [L + 1]) in place;
    padding entries land in the spare word.  Returns the state."""
    _check_rung(didx)
    return update_resident(state, didx, dval)


def serve_window(state, didx, dval, off_alloc, off_price, off_rank, *,
                 G: int, O: int, U: int, N: int, right_size: bool = True,
                 compact: int = 0, dense16: bool = False,
                 coo16: bool = False):
    """One serving-loop iteration: slot apply + packed solve.  Returns
    ``(state, result)``; the result is ``solve_packed_torch`` of the
    updated ``state[:L]``."""
    _check_rung(didx)
    return solve_resident(state, didx, dval, off_alloc, off_price,
                          off_rank, G=G, O=O, U=U, N=N,
                          right_size=right_size, compact=compact,
                          dense16=dense16, coo16=coo16)
