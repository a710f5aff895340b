"""Order-fixed float32 segment sums: the CUDA kernel and its plain twin.

The flat solver's float32 totals (``T_u`` and ``T_act`` in
``solver/flat.py``) must round exactly as the reference's
``jax.ops.segment_sum`` does on its CPU, which adds the items one by one
in index order.  :func:`segment_sum` gives that order on any device: on
a CUDA tensor it launches ``csrc/segment_sum.cu``, one kernel with no
sort (each block lists the items of its 32 segments in index order and
folds each segment's rows left to right); on a CPU tensor it runs
:func:`segment_sum_reference`, ``index_add_`` on the CPU, which adds in
index order too (``tests/test_torch_flat.py`` holds both against
``np.add.at`` and the reference).  The choice follows the tensor's
device, never a failure: on a CUDA tensor the kernel launches or the
call raises.  Ids outside [0, S) drop on both, so a caller passes only
the segments it reads: no sentinel segment to slice off.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch import cuda_build

# Kernel launches, counted where the kernel is launched and nowhere else.
LAUNCHES = {"segment_sum": 0}


def segment_sum_reference(vals: torch.Tensor, seg: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Plain version: float32 [I, R] rows summed per segment in index
    order, on the CPU (``index_add_`` there is a sequential loop over the
    index), returned on the device ``vals`` came from.  Rows whose id
    lies outside [0, num_segments) are dropped."""
    out = torch.zeros((num_segments,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype)
    seg = seg.cpu().long()
    keep = (seg >= 0) & (seg < num_segments)
    out.index_add_(0, seg[keep], vals.cpu()[keep])
    return out.to(vals.device)


# the kernel's C functions and limits, bound once per process
_BOUND = None


def _bound():
    global _BOUND
    if _BOUND is None:
        lib = cuda_build.load("segment_sum")
        _BOUND = (lib.segment_sum_launch, lib.segment_sum_max_cols(),
                  lib.segment_sum_max_items(), lib.segment_sum_error_string)
    return _BOUND


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """float32 [I, R] rows summed per segment (``seg`` int32 or int64
    [I]) in index order: [num_segments, R].  Rows whose id lies outside
    [0, num_segments) are dropped on every device, as the reference's
    ``jax.ops.segment_sum`` drops them.  On a CUDA tensor one launch and
    nothing else: the output is the only allocation."""
    shape = vals.shape
    if vals.dtype is not torch.float32 or len(shape) != 2:
        raise ValueError(f"vals must be float32 [I, R], got {vals.dtype} "
                         f"{tuple(shape)}")
    items, cols = shape
    index = vals.get_device()
    if seg.shape != shape[:1] or seg.get_device() != index:
        raise ValueError(f"seg must be [I] on {vals.device}, got "
                         f"{tuple(seg.shape)} on {seg.device}")
    if seg.dtype is not torch.int32 and seg.dtype is not torch.int64:
        raise ValueError(f"seg must be int32 or int64, got {seg.dtype}")
    if not vals.is_cuda:
        if vals.device.type != "cpu":
            raise ValueError(f"segment_sum runs on cpu or cuda, not "
                             f"{vals.device}")
        return segment_sum_reference(vals, seg, num_segments)
    launch, max_cols, max_items, error_string = _BOUND or _bound()
    if cols > max_cols:
        raise ValueError(f"segment_sum takes at most {max_cols} columns, "
                         f"got {cols}")
    if items > max_items:
        raise ValueError(f"segment_sum takes at most {max_items} items, "
                         f"got {items}")
    out = vals.new_empty((num_segments, cols))
    if num_segments == 0:
        return out
    if not vals.is_contiguous():
        vals = vals.contiguous()
    if not seg.is_contiguous():
        seg = seg.contiguous()
    err = launch(vals.data_ptr(), seg.data_ptr(), out.data_ptr(), items,
                 num_segments, cols, seg.element_size(),
                 cuda_build.stream_handle(index))
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {err} "
                           f"({error_string(err).decode()})")
    LAUNCHES["segment_sum"] += 1
    return out
