"""The order-fixed cost sum: the CUDA kernel and its plain twin.

The cost word of a packed result is the float32 sum of the open nodes'
prices.  The reference takes it with ``jnp.sum``
(``karpenter_tpu/solver/jax_backend.py:746``, ``:984``), which XLA on
the CPU rewrites into a tree of 32-wide windows:

1. while more than 32 values are left, pad them with zeros to a whole
   number of 32-wide windows (half the padding before the values, the
   other half, rounded up, after them) and replace each window by its
   sum, taken left to right from 0;
2. add the last <= 32 values left to right from 0.

The same rule holds row by row for a ``[C, N]`` sum and under
``jax.vmap``.  A plan can hang on one ulp of this word (a zone candidate
wins only by more than 1e-9, ``solver/zonesplit.py``), so the port sums
in exactly that order on every device: on a CUDA tensor
:func:`cost_sum` launches ``csrc/cost_sum.cu`` (one warp per row), on a
CPU tensor it runs :func:`cost_sum_reference`, the same windows as a
loop over the 32 columns.  The choice follows the tensor's device, never
a failure: on a CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = {"cost_sum": 0}

WINDOW = 32


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


def cost_sum_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: float32 ``[N]`` -> ``[]`` or
    ``[C, N]`` -> ``[C]``, each row summed in the reference's order."""
    v = x
    while v.shape[-1] > WINDOW:
        v = _window_sums(v)
    acc = torch.zeros(v.shape[:-1], dtype=torch.float32, device=x.device)
    for j in range(v.shape[-1]):
        acc = acc + v[..., j]
    return acc


def _launch(rows: torch.Tensor) -> torch.Tensor:
    from karpenter_tpu_torch import cuda_build

    lib = cuda_build.load("cost_sum")
    C, N = rows.shape
    if N > lib.cost_sum_max_len():
        raise ValueError(f"cost_sum takes rows of at most "
                         f"{lib.cost_sum_max_len()} values, got {N}")
    out = torch.empty(C, dtype=torch.float32, device=rows.device)
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = lib.cost_sum_launch(rows.data_ptr(), out.data_ptr(), C, N, stream)
    if err != 0:
        msg = lib.cost_sum_error_string(err).decode()
        raise RuntimeError(f"cost_sum launch failed: cudaError {err} "
                           f"({msg})")
    return out


def cost_sum(prices_masked: torch.Tensor) -> torch.Tensor:
    """float32 ``[N]`` -> ``[]`` or ``[C, N]`` -> ``[C]``: the open-node
    prices (0 where a node is closed) summed in the reference's order."""
    x = prices_masked
    if x.dtype != torch.float32 or x.dim() not in (1, 2):
        raise ValueError(f"cost_sum takes float32 [N] or [C, N], got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device.type == "cpu":
        return cost_sum_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"cost_sum runs on cpu or cuda, not {x.device}")
    rows = (x if x.dim() == 2 else x[None]).contiguous()
    out = _launch(rows)
    LAUNCHES["cost_sum"] += 1
    return out if x.dim() == 2 else out[0]
