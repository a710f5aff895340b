"""The FFD placement scan: CUDA kernel wrapper and its plain PyTorch twin.

Replaces ``karpenter_tpu/solver/pallas_kernel.py`` (``ffd_scan_pallas``
and its fleet grid).  :func:`ffd_scan` launches ``csrc/ffd_scan.cu`` on
CUDA tensors and runs :func:`ffd_scan_reference` on CPU tensors — the
choice follows the tensors' device, never a failure: on a CUDA tensor
the kernel launches or the call raises.

Contract (C problems that share one catalog; C = 1 on the single-window
path)::

    meta     int32 [C, G, 8]  req_cpu, req_mem, req_gpu, req_pods,
                              count, cap, (label row), (priority)
    compat   int32 or uint8 [C, G, O]   group x offering feasibility
    alloc    int32 [O, 4]     per-offering allocatable
    rank     float32 [O]      ranking price
    -> node_off int32 [C, N] (-1 = unused slot), assign int32 [C, G, N],
       unplaced int32 [C, G]

bit-identical to the reference's ``_ffd_step`` scan.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.solver.types import FIT_BIG

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else; a caller resets an entry to 0 before a run and reads it
# after to prove the run went through the kernel.
LAUNCHES = {"ffd_scan": 0}


def _fit_counts(resid: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[N, R] // [R] -> [N] pods that fit; dims with req == 0 are
    unconstrained (FIT_BIG), never a division by zero."""
    per_dim = torch.where(
        req[None, :] > 0,
        torch.div(resid, torch.clamp(req, min=1)[None, :],
                  rounding_mode="floor"),
        FIT_BIG)
    return per_dim.min(dim=1).values


def _ffd_scan_one(meta, compat, alloc, rank, N: int):
    """One problem, op for op the reference's ``_ffd_step`` scan.
    int32 sums are taken wider and cast back, which wraps exactly as the
    reference's int32 arithmetic does."""
    dev = meta.device
    G = meta.shape[0]
    i32 = torch.int32
    node_off = torch.full((N,), -1, dtype=i32, device=dev)
    resid = torch.zeros((N, 4), dtype=i32, device=dev)
    ptr = torch.zeros((), dtype=i32, device=dev)
    idx = torch.arange(N, dtype=i32, device=dev)
    assign = torch.empty((G, N), dtype=i32, device=dev)
    unplaced = torch.empty((G,), dtype=i32, device=dev)
    for g in range(G):
        req = meta[g, :4]
        count = meta[g, 4]
        cap = meta[g, 5]
        compat_g = compat[g] > 0
        is_open = node_off >= 0
        node_compat = torch.where(
            is_open, compat_g[torch.clamp(node_off, min=0).long()], False)
        # ---- fill open nodes, first-fit in age order ------------------
        fit = _fit_counts(resid, req)
        fit = torch.where(node_compat, fit, 0)
        fit = torch.minimum(fit, cap)
        cumfit = torch.cumsum(fit, 0).to(i32) - fit            # exclusive
        take = torch.minimum(torch.maximum(count - cumfit,
                                           torch.zeros_like(fit)), fit)
        placed = take.sum().to(i32)
        resid = resid - take[:, None] * req[None, :]
        rem = count - placed
        # ---- open new nodes with the cheapest-per-pod offering --------
        fit_e = _fit_counts(alloc, req)
        fit_e = torch.where(compat_g, fit_e, 0)
        fit_e = torch.minimum(fit_e, cap)
        fit_e = torch.minimum(fit_e, rem)
        cpp = torch.where(fit_e > 0, rank / fit_e.to(torch.float32),
                          float("inf"))
        best = torch.argmin(cpp)                      # first index on ties
        bf = fit_e[best]
        n_new = torch.where(
            bf > 0,
            -torch.div(-rem, torch.clamp(bf, min=1), rounding_mode="floor"),
            0).to(i32)
        n_new = torch.minimum(n_new, N - ptr)
        new_pos = idx - ptr
        is_new = (new_pos >= 0) & (new_pos < n_new)
        pods_new = torch.where(
            is_new,
            torch.minimum(torch.maximum(rem - new_pos * bf,
                                        torch.zeros_like(idx)), bf),
            0).to(i32)
        opened = is_new & (pods_new > 0)
        node_off = torch.where(opened, best.to(i32), node_off)
        resid = torch.where(opened[:, None],
                            alloc[best][None, :] - pods_new[:, None]
                            * req[None, :], resid)
        ptr = (ptr + opened.sum()).to(i32)
        unplaced[g] = rem - pods_new.sum().to(i32)
        assign[g] = take + pods_new
    return node_off, assign, unplaced


def ffd_scan_reference(meta: torch.Tensor, compat: torch.Tensor,
                       alloc: torch.Tensor, rank: torch.Tensor, N: int):
    """Plain PyTorch version of the kernel, on any device: a loop over
    the C problems and, inside, over the G groups."""
    outs = [_ffd_scan_one(meta[c], compat[c], alloc, rank, N)
            for c in range(meta.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def _check(meta, compat, alloc, rank, N: int):
    if meta.dim() != 3 or meta.shape[2] != 8 or meta.dtype != torch.int32:
        raise ValueError(f"meta must be int32 [C, G, 8], got "
                         f"{meta.dtype} {tuple(meta.shape)}")
    C, G, _ = meta.shape
    if compat.dim() != 3 or compat.shape[:2] != (C, G) \
            or compat.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"compat must be int32/uint8 [C, G, O], got "
                         f"{compat.dtype} {tuple(compat.shape)}")
    O = compat.shape[2]
    if alloc.shape != (O, 4) or alloc.dtype != torch.int32:
        raise ValueError(f"alloc must be int32 [{O}, 4], got "
                         f"{alloc.dtype} {tuple(alloc.shape)}")
    if rank.shape != (O,) or rank.dtype != torch.float32:
        raise ValueError(f"rank must be float32 [{O}], got "
                         f"{rank.dtype} {tuple(rank.shape)}")
    if O == 0 or N <= 0:
        raise ValueError(f"need O > 0 and N > 0 (O={O}, N={N})")
    devs = {t.device for t in (meta, compat, alloc, rank)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    return C, G, O


def ffd_scan(meta: torch.Tensor, compat: torch.Tensor, alloc: torch.Tensor,
             rank: torch.Tensor, N: int):
    """The FFD scan: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors.  Returns (node_off [C, N], assign [C, G, N],
    unplaced [C, G]), all int32."""
    C, G, O = _check(meta, compat, alloc, rank, N)
    dev = meta.device
    if dev.type == "cpu":
        return ffd_scan_reference(meta, compat, alloc, rank, N)
    if dev.type != "cuda":
        raise ValueError(f"ffd_scan runs on cpu or cuda, not {dev}")
    from karpenter_tpu_torch import cuda_build

    lib = cuda_build.load("ffd_scan")
    if N > lib.ffd_scan_max_nodes():
        raise ValueError(f"ffd_scan takes N <= {lib.ffd_scan_max_nodes()}, "
                         f"got {N}")
    for name, t in (("meta", meta), ("compat", compat), ("alloc", alloc),
                    ("rank", rank)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if alloc.data_ptr() % 16:
        raise ValueError("alloc must be 16-byte aligned (read as int4)")
    node_off = torch.empty((C, N), dtype=torch.int32, device=dev)
    assign = torch.empty((C, G, N), dtype=torch.int32, device=dev)
    unplaced = torch.empty((C, G), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ffd_scan_launch(
        meta.data_ptr(), compat.data_ptr(),
        int(compat.dtype == torch.uint8), alloc.data_ptr(),
        rank.data_ptr(), node_off.data_ptr(), assign.data_ptr(),
        unplaced.data_ptr(), C, G, O, N, FIT_BIG, dev.index, stream)
    if err != 0:
        msg = lib.ffd_scan_error_string(err).decode()
        raise RuntimeError(f"ffd_scan launch failed: cudaError {err} ({msg})")
    LAUNCHES["ffd_scan"] += 1
    return node_off, assign, unplaced
