"""Order-fixed presence sums: the CUDA kernel and its plain twin.

The right-size with soft preferences ranks an offering on a node by the
mean miss of the groups placed there.  Its sum, ``out[n, o] = sum over
g of present[g, n] * miss[g, o]`` (the reference's
``jnp.einsum("gn,go->no")``, ``jax_backend.py:281``), must round as the
CPU program the card is held against does: group by group, in group
order.  :func:`presence_sum` gives that order on any device: on a CUDA
tensor it launches ``csrc/presence_sum.cu`` (one block per node and 256
offerings: the node's present groups listed in order, their rows folded
in that order); on a CPU tensor it
runs :func:`presence_sum_reference`, one ``addcmul_`` per group in
order.  The choice follows the tensor's device, never a failure: on a
CUDA tensor the kernel launches or the call raises.
"""

from __future__ import annotations

import torch

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


def _launch(present: torch.Tensor, miss: torch.Tensor) -> torch.Tensor:
    from karpenter_tpu_torch import cuda_build

    lib = cuda_build.load("presence_sum")
    G, N = present.shape
    if G > lib.presence_sum_max_groups():
        raise ValueError(f"presence_sum takes G <= "
                         f"{lib.presence_sum_max_groups()}, got {G}")
    O = miss.shape[1]
    out = torch.empty((N, O), dtype=torch.float32, device=present.device)
    stream = torch.cuda.current_stream(present.device).cuda_stream
    err = lib.presence_sum_launch(present.data_ptr(), miss.data_ptr(),
                                  out.data_ptr(), G, N, O, stream)
    if err != 0:
        msg = lib.presence_sum_error_string(err).decode()
        raise RuntimeError(f"presence_sum launch failed: cudaError {err} "
                           f"({msg})")
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
    if present.shape[1] > 65535:
        raise ValueError(f"presence_sum takes N <= 65535, got "
                         f"{present.shape[1]}")
    out = _launch(present.contiguous(), miss.contiguous())
    LAUNCHES["presence_sum"] += 1
    return out
