"""Order-fixed presence sums: the CUDA kernel and its plain twin.

The right-size with soft preferences ranks an offering on a node by the
mean miss of the groups placed there.  Its sum, ``out[n, o] = sum over
g of present[g, n] * miss[g, o]`` (the reference's
``jnp.einsum("gn,go->no")``, ``jax_backend.py:281``), must round as the
CPU program the card is held against does: group by group, in group
order.  :func:`presence_sum` gives that order on any device: on a CUDA
tensor it launches ``csrc/presence_sum.cu`` once (a block per 32 nodes
and one tile of offerings; the blocks of a node tile form a cluster that
reads the tile's flags once into per-node presence bitmaps, the node's
ordered list, whose rows each warp then folds in that order); on a CPU
tensor it runs :func:`presence_sum_reference`, one ``addcmul_`` per
group in order.  The choice follows the tensor's device, never a
failure: on a CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch import cuda_build

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = {"presence_sum": 0}


def presence_sum_reference(present: torch.Tensor,
                           miss: torch.Tensor) -> torch.Tensor:
    """Plain version on any device: float32 [N, O], the rows of ``miss``
    [G, O] of the groups present on each node (``present`` [G, N], 0/1)
    added group by group in order.  ``present * miss`` is exact, so the
    fused multiply-add adds each present group's row once."""
    G, N = present.shape
    acc = torch.zeros((N, miss.shape[1]), dtype=torch.float32,
                      device=present.device)
    for g in range(G):
        acc.addcmul_(present[g][:, None], miss[g][None, :])
    return acc


# the kernel's C functions and group limit, bound once per process
_BOUND = None


def _bound():
    global _BOUND
    if _BOUND is None:
        lib = cuda_build.load("presence_sum")
        _BOUND = (lib.presence_sum_launch, lib.presence_sum_max_groups(),
                  lib.presence_sum_error_string)
    return _BOUND


def _launch(present: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    launch, max_groups, error_string = _BOUND or _bound()
    G, N = present.shape
    if G > max_groups:
        raise ValueError(f"presence_sum takes G <= {max_groups}, got {G}")
    O = miss.shape[1]
    out = torch.empty((N, O), dtype=torch.float32, device=present.device)
    index = present.get_device()
    err = launch(present.data_ptr(), miss.data_ptr(), out.data_ptr(), G, N,
                 O, index, cuda_build.stream_handle(index))
    if err != 0:
        raise RuntimeError(f"presence_sum launch failed: cudaError {err} "
                           f"({error_string(err).decode()})")
    return out


def presence_sum(present: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    """float32 [N, O]: for each node, the ``miss`` [G, O] rows of the
    groups ``present`` [G, N] (0/1) on it, added in group order."""
    if present.dim() != 2 or present.dtype != torch.float32:
        raise ValueError(f"present must be float32 [G, N], got "
                         f"{present.dtype} {tuple(present.shape)}")
    if miss.dim() != 2 or miss.dtype != torch.float32 \
            or miss.shape[0] != present.shape[0] \
            or miss.device != present.device:
        raise ValueError(f"miss must be float32 [{present.shape[0]}, O] on "
                         f"{present.device}, got {miss.dtype} "
                         f"{tuple(miss.shape)} on {miss.device}")
    if present.device.type == "cpu":
        return presence_sum_reference(present, miss)
    if present.device.type != "cuda":
        raise ValueError(f"presence_sum runs on cpu or cuda, not "
                         f"{present.device}")
    out = _launch(present.contiguous(), miss.contiguous())
    LAUNCHES["presence_sum"] += 1
    return out
