"""The order-fixed cost word: the CUDA kernel and its plain twins.

The cost word of a packed result is the float32 sum of the open nodes'
prices.  The reference takes it with ``jnp.sum(jnp.where(node_off >= 0,
off_price[clip(node_off, 0)], 0.0))`` (``karpenter_tpu/solver/
jax_backend.py:746``, ``:984``), which XLA on the CPU fuses with its
gather and mask and sums in this order:

1. a row of 30, 31 or 32 values: the first 8 * floor(n / 8) values go
   into 8 lane accumulators (value i into lane i mod 8, each lane left
   to right from 0), the lanes are combined by halving (lane l plus
   lane l + 4, then l + 2, then l + 1), and the n mod 8 values left
   over are added to that, left to right;
2. any other row of at most 32 values: left to right from 0;
3. a longer row: while more than 32 values are left, pad them with
   zeros to a whole number of 32-wide windows (half the padding before
   the values, the other half, rounded up, after them) and replace
   each window by its sum, taken left to right from 0; then add the
   last <= 32 values left to right from 0 (the 8-lane order of rule 1
   is never taken at an inner level: 929-1024 values end left to
   right over their 30-32 window sums).

The same rule holds row by row for a ``[C, N]`` sum and under
``jax.vmap``.  A plan can hang on one ulp of this word (a zone candidate
wins only by more than 1e-9, ``solver/zonesplit.py``), so the port sums
in exactly that order on every device.  Every solve path forms its cost
word with :func:`cost_word`, straight from the scan's ``node_off`` and
the catalog's prices: on a CUDA tensor one launch of
``csrc/cost_sum.cu`` (one warp per row) gathers, masks and sums, with no
masked-price row and no gather or ``where`` launch before it; on a CPU
tensor :func:`cost_word_reference` forms the masked row and sums it with
:func:`cost_sum_reference`, the same order as loops over the columns.
The choice follows the tensor's device, never a failure: on a CUDA
tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch import cuda_build

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = {"cost_sum": 0}

WINDOW = 32
# rows of these lengths are summed in 8 lanes (rule 1 of the header)
LANES = 8
LANE_ROWS = (30, 31, 32)


def _window_sums(v: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., ceil(n / 32)]: each zero-padded 32-wide window
    summed left to right from 0."""
    n = v.shape[-1]
    m = -(-n // WINDOW)
    pad = m * WINDOW - n
    if pad:
        v = torch.nn.functional.pad(v, (pad // 2, pad - pad // 2))
    w = v.reshape(*v.shape[:-1], m, WINDOW)
    acc = torch.zeros(w.shape[:-1], dtype=torch.float32, device=v.device)
    for j in range(WINDOW):
        acc = acc + w[..., j]
    return acc


def _lane_sum(v: torch.Tensor) -> torch.Tensor:
    """[..., n] (n in 30-32) -> [...]: rule 1 of the header."""
    n = v.shape[-1]
    k = LANES * (n // LANES)
    acc = torch.zeros((*v.shape[:-1], LANES), dtype=torch.float32,
                      device=v.device)
    for j in range(0, k, LANES):
        acc = acc + v[..., j:j + LANES]
    half = LANES // 2
    while half:
        acc = acc[..., :half] + acc[..., half:2 * half]
        half //= 2
    acc = acc[..., 0]
    for j in range(k, n):
        acc = acc + v[..., j]
    return acc


def cost_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: float32 ``[N]`` -> ``[]`` or
    ``[C, N]`` -> ``[C]``, each row summed in the reference's order."""
    if x.shape[-1] in LANE_ROWS:
        return _lane_sum(x)
    v = x
    while v.shape[-1] > WINDOW:
        v = _window_sums(v)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


# the kernel's C functions and row limit, bound once per process
_BOUND = None


def _bound():
    global _BOUND
    if _BOUND is None:
        lib = cuda_build.load("cost_sum")
        _BOUND = (lib.cost_word_launch, lib.cost_sum_max_len(),
                  lib.cost_sum_error_string)
    return _BOUND


def masked_prices(node_off: torch.Tensor,
                  off_price: torch.Tensor) -> torch.Tensor:
    """The masked price row(s): ``off_price[node_off]`` where a node is
    open (``node_off >= 0``), 0 where it is closed.  An index past the
    catalog clamps, as the reference's gather does."""
    idx = torch.clamp(node_off, 0, off_price.shape[-1] - 1).long()
    prices = off_price[idx] if off_price.dim() == 1 \
        else torch.gather(off_price, 1, idx)
    return torch.where(node_off >= 0, prices, torch.zeros_like(prices))


def cost_word_reference(node_off: torch.Tensor,
                        off_price: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`cost_word` on any device: the masked
    prices summed by :func:`cost_sum_reference`."""
    return cost_sum_reference(masked_prices(node_off, off_price))


def cost_word(node_off: torch.Tensor,
              off_price: torch.Tensor) -> torch.Tensor:
    """The cost word from the scan's output: ``node_off`` int32 ``[N]``
    or ``[C, N]`` (-1 = closed), ``off_price`` float32 ``[O]`` (one
    catalog for every row) or ``[C, O]`` (a catalog per row) -> ``[]``
    or ``[C]``, the open nodes' prices summed in the reference's order
    (``jnp.sum(jnp.where(node_off >= 0, off_price[clip(node_off, 0)],
    0))``, as ``finish_pallas_solve`` forms it).  On a CUDA tensor one
    launch, counted as ``LAUNCHES["cost_sum"]``."""
    ns, ps = node_off.shape, off_price.shape
    nd, pd = len(ns), len(ps)
    if node_off.dtype is not torch.int32 or not 0 < nd < 3:
        raise ValueError(f"cost_word takes node_off int32 [N] or [C, N], "
                         f"got {node_off.dtype} {tuple(ns)}")
    if off_price.dtype is not torch.float32 or not 0 < pd < 3 \
            or ps[-1] == 0 or (pd == 2 and (nd != 2 or ps[0] != ns[0])):
        raise ValueError(f"cost_word takes off_price float32 [O] or [C, O] "
                         f"matching node_off {tuple(ns)}, got "
                         f"{off_price.dtype} {tuple(ps)}")
    index = node_off.get_device()
    if off_price.get_device() != index:
        raise ValueError(f"off_price on {off_price.device}, node_off on "
                         f"{node_off.device}")
    if not node_off.is_cuda:
        if node_off.device.type != "cpu":
            raise ValueError(f"cost_word runs on cpu or cuda, not "
                             f"{node_off.device}")
        return cost_word_reference(node_off, off_price)
    launch, max_len, error_string = _BOUND or _bound()
    N, O = ns[-1], ps[-1]
    if N > max_len:
        raise ValueError(f"cost_word takes rows of at most {max_len} "
                         f"nodes, got {N}")
    if not node_off.is_contiguous():
        node_off = node_off.contiguous()
    if not off_price.is_contiguous():
        off_price = off_price.contiguous()
    C = ns[0] if nd == 2 else 1
    out = off_price.new_empty((C,) if nd == 2 else ())
    if C:
        err = launch(node_off.data_ptr(), off_price.data_ptr(),
                     out.data_ptr(), C, N, O, O if pd == 2 else 0,
                     cuda_build.stream_handle(index))
        cuda_build.check_launch("cost_word", err, error_string)
        LAUNCHES["cost_sum"] += 1
    return out
