"""Order-fixed float32 segment sums: the CUDA kernel and its plain twin.

The flat solver's float32 totals (``T_u`` and ``T_act`` in
``solver/flat.py``) must round exactly as the reference's
``jax.ops.segment_sum`` does on its CPU, which adds the items one by one
in index order.  :func:`segment_sum` gives that order on any device: on
a CUDA tensor it launches ``csrc/segment_sum.cu`` (items stably sorted
by segment, one block per segment folding its rows left to right); on a
CPU tensor it runs :func:`segment_sum_reference`, ``index_add_`` on the
CPU, which adds in index order too (``tests/test_torch_flat.py`` holds
both against ``np.add.at`` and the reference).  The choice follows the
tensor's device, never a failure: on a CUDA tensor the kernel launches
or the call raises.
"""

from __future__ import annotations

import torch

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


def _launch(vals: torch.Tensor, seg: torch.Tensor,
            num_segments: int) -> torch.Tensor:
    from karpenter_tpu_torch import cuda_build

    lib = cuda_build.load("segment_sum")
    cols = vals.shape[1]
    if cols > lib.segment_sum_max_cols():
        raise ValueError(f"segment_sum takes at most "
                         f"{lib.segment_sum_max_cols()} columns, got {cols}")
    # a stable sort keeps each segment's rows in index order; the
    # segment bounds come from a search of the sorted ids (bincount
    # would read its maximum back to the host), so ids outside
    # [0, num_segments) sort outside every segment and are dropped
    sorted_seg, order = torch.sort(seg.to(torch.int32), stable=True)
    sorted_vals = vals.index_select(0, order).contiguous()
    bounds = torch.searchsorted(
        sorted_seg, torch.arange(num_segments + 1, dtype=torch.int32,
                                 device=vals.device), out_int32=True)
    start = bounds[:-1].contiguous()
    length = (bounds[1:] - bounds[:-1]).contiguous()
    out = torch.empty((num_segments, cols), dtype=torch.float32,
                      device=vals.device)
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    err = lib.segment_sum_launch(sorted_vals.data_ptr(), start.data_ptr(),
                                 length.data_ptr(), out.data_ptr(),
                                 num_segments, cols, stream)
    if err != 0:
        msg = lib.segment_sum_error_string(err).decode()
        raise RuntimeError(f"segment_sum launch failed: cudaError {err} "
                           f"({msg})")
    return out


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """float32 [I, R] rows summed per segment (``seg`` [I]) in index
    order: [num_segments, R].  Rows whose id lies outside
    [0, num_segments) are dropped on every device, as the reference's
    ``jax.ops.segment_sum`` drops them."""
    if vals.dim() != 2 or vals.dtype != torch.float32:
        raise ValueError(f"vals must be float32 [I, R], got {vals.dtype} "
                         f"{tuple(vals.shape)}")
    if seg.shape != vals.shape[:1] or seg.device != vals.device:
        raise ValueError(f"seg must be [I] on {vals.device}, got "
                         f"{tuple(seg.shape)} on {seg.device}")
    if vals.device.type == "cpu":
        return segment_sum_reference(vals, seg, num_segments)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum runs on cpu or cuda, not "
                         f"{vals.device}")
    out = _launch(vals.contiguous(), seg, num_segments)
    LAUNCHES["segment_sum"] += 1
    return out
