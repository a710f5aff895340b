"""The FFD placement scan: CUDA kernel wrappers and their plain PyTorch twins.

Replaces ``karpenter_tpu/solver/pallas_kernel.py``: :func:`ffd_scan`
is ``ffd_scan_pallas`` (C problems sharing one catalog; C = 1 on the
single-window path) and :func:`ffd_scan_fleet` is
``ffd_scan_pallas_fleet`` (every problem with its own catalog).  Both
launch the one kernel of ``csrc/ffd_scan.cu`` on CUDA tensors and run
the plain version on CPU tensors — the choice follows the tensors'
device, never a failure: on a CUDA tensor the kernel launches or the
call raises.

Contract::

    meta     int32 [C, G, 8]  req_cpu, req_mem, req_gpu, req_pods,
                              count, cap, (label row), (priority)
    compat   int32 or uint8 [C, G, O]   group x offering feasibility
    alloc    int32 [O, 4] (ffd_scan) or [C, O, 4] (ffd_scan_fleet)
                              per-offering allocatable
    rank     float32 [O] or [C, O]      ranking price, or one row per
             group: [G, O] or [C, G, O] (soft preferences)
    -> node_off int32 [C, N] (-1 = unused slot), assign int32 [C, G, N],
       unplaced int32 [C, G]

bit-identical to the reference's ``_ffd_step`` scan; with one rank row
per group, to the pref scan of ``solve_core`` (``jax_backend.py:958``),
whose step g ranks by ``rank_g = rank * (1 + lambda * miss_g)``.  The
kernel takes that form through a group stride beside the problem stride
(0 = one row shared by the groups).

The kernel runs in two launches (see the note in ``csrc/ffd_scan.cu``):
an offering prologue over all C x G groups, whose plain version is
:func:`ffd_offers_reference`, writes one row per group into a scratch
the wrapper allocates; then one block per problem runs the sequential
chain, which reads the rows from shared memory and sweeps the offerings
only on the steps where the pods left cap some offering
(:func:`chain_branches` counts the steps of each branch).  With a rank
row per group, each group's row rides the chain's ring beside its
prologue row where shared memory holds it (with the catalog at the
pref window and up to N = 1024 at O = 4096, without it up to N = 4096
at O = 4096), so the capped sweep reads it from shared memory too;
elsewhere it reads the row from L2.  That form
takes O % 4 == 0 on the card (every offering bucket is a multiple of
128).
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.solver.types import FIT_BIG

# A fit at or above this on an open node sends the kernel's step to the
# exact sum of the takes (csrc/ffd_scan.cu, kFitSafe): below it, 8192
# node slots cannot wrap an int32 prefix sum.
WIDE_FIT = 1 << 18

# Kernel launches per wrapper, counted where the kernel is launched and
# nowhere else; a caller resets an entry to 0 before a run and reads it
# after to prove the run went through the kernel.
LAUNCHES = {"ffd_scan": 0, "ffd_scan_fleet": 0, "ffd_scan_pref": 0}


def _fit_counts(resid: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[N, R] // [R] -> [N] pods that fit; dims with req == 0 are
    unconstrained (FIT_BIG), never a division by zero."""
    per_dim = torch.where(
        req[None, :] > 0,
        torch.div(resid, torch.clamp(req, min=1)[None, :],
                  rounding_mode="floor"),
        FIT_BIG)
    return per_dim.min(dim=1).values


def _offer_fits(meta, compat, alloc):
    """fe0 [C, G, O] = max(0, min(compat ? fit(alloc, req) : 0, cap)) for
    C problems each with its own catalog (``alloc`` [C, O, 4])."""
    req = meta[..., None, :4]                             # [C, G, 1, 4]
    per_dim = torch.where(
        req > 0,
        torch.div(alloc[:, None], torch.clamp(req, min=1),
                  rounding_mode="floor"),
        FIT_BIG)
    fe0 = torch.where(compat > 0, per_dim.min(dim=-1).values, 0)
    return torch.clamp(torch.minimum(fe0, meta[..., 5:6]), min=0)


def ffd_offers_reference(meta: torch.Tensor, compat: torch.Tensor,
                         alloc: torch.Tensor, rank: torch.Tensor):
    """Plain version of the kernel's offering prologue, for C problems
    each with its own catalog (``alloc`` [C, O, 4], ``rank`` [C, O], or
    [C, G, O] with a row per group).
    Per group: ``fe0`` [C, G, O] = max(0, min(compat ? fit(alloc, req) :
    0, cap)), which does not depend on node state; ``best0`` [C, G], the
    first-index argmin of rank / fe0 over fe0 > 0 (0 when there is
    none); ``bf0`` = fe0 at best0; ``maxfe`` = max fe0.  A step whose
    pods left (rem) are at least maxfe caps no offering, so its (best,
    bf) is (best0, bf0)."""
    fe0 = _offer_fits(meta, compat, alloc)
    rank_g = rank if rank.dim() == 3 else rank[:, None]
    cpp = torch.where(fe0 > 0, rank_g / fe0.to(torch.float32),
                      float("inf"))
    best0 = torch.argmin(cpp, dim=-1)                   # first index on ties
    bf0 = torch.gather(fe0, -1, best0[..., None])[..., 0]
    return fe0, best0.to(torch.int32), bf0, fe0.max(dim=-1).values


def chain_branches(meta: torch.Tensor, compat: torch.Tensor,
                   alloc: torch.Tensor, node_off: torch.Tensor,
                   assign: torch.Tensor, unplaced: torch.Tensor) -> dict:
    """How many group steps of a scan took each branch of the kernel's
    chain, from the inputs (``alloc`` [O, 4] or [C, O, 4]) and the scan's
    outputs: rem_g, the pods the open nodes did not take, is unplaced_g
    plus the pods of the nodes first opened at step g.  ``opens_nothing``
    (rem <= 0), ``uncapped`` (rem >= maxfe: the prologue's argmin) and
    ``capped`` (the chain's own sweep).  ``summed_takes`` counts the
    steps of groups with no request at all and a cap of at least
    WIDE_FIT whose fill met a compatible open node: their fits are
    FIT_BIG, prefix sums may wrap, and the chain sums the takes behind a
    second barrier (other, rarer causes of that path are not counted)."""
    C, G, _ = meta.shape
    if G == 0:
        return {"opens_nothing": 0, "uncapped": 0, "capped": 0,
                "summed_takes": 0}
    if alloc.dim() == 2:
        alloc = alloc.expand(C, -1, -1)
    mask = assign > 0                                     # [C, G, N]
    first = torch.where(mask.any(dim=1), mask.int().argmax(dim=1), G)
    first = torch.where(node_off >= 0, first, G)          # [C, N]
    steps = torch.arange(G, device=meta.device)
    opened_at = first[:, None, :] == steps[None, :, None]
    rem = unplaced.long() + (assign.long() * opened_at).sum(dim=2)
    maxfe = torch.cat([
        _offer_fits(meta[c:c + 1], compat[c:c + 1], alloc[c:c + 1]).amax(-1)
        for c in range(C)]).long()
    # a compatible node open before step g: first < g, compat[g, off]
    off = node_off.clamp(min=0).long()[:, None, :].expand(C, G, -1)
    met = (torch.gather(compat, 2, off) != 0) \
        & (first[:, None, :] < steps[None, :, None])
    wide = (meta[..., :4] == 0).all(dim=-1) & (meta[..., 5] >= WIDE_FIT)
    return {"opens_nothing": int((rem <= 0).sum()),
            "uncapped": int(((rem > 0) & (rem >= maxfe)).sum()),
            "capped": int(((rem > 0) & (rem < maxfe)).sum()),
            "summed_takes": int((wide & met.any(dim=2)).sum())}


def open_nodes(rem, bf, ptr, idx):
    """The new-node half of an FFD step: ``rem`` pods left, ``bf`` of
    them per node of the chosen offering, free slots from ``ptr`` on
    (``idx`` = arange(N)).  Returns (pods_new [N], opened [N]): the pods
    each slot receives and which slots open (ceil(rem / bf) of them,
    as many as fit below N)."""
    N = idx.shape[0]
    n_new = torch.where(
        bf > 0,
        -torch.div(-rem, torch.clamp(bf, min=1), rounding_mode="floor"),
        0).to(torch.int32)
    n_new = torch.minimum(n_new, N - ptr)
    new_pos = idx - ptr
    is_new = (new_pos >= 0) & (new_pos < n_new)
    pods_new = torch.where(
        is_new,
        torch.minimum(torch.maximum(rem - new_pos * bf,
                                    torch.zeros_like(idx)), bf),
        0).to(torch.int32)
    return pods_new, is_new & (pods_new > 0)


def _ffd_scan_one(meta, compat, alloc, rank, N: int):
    """One problem, op for op the reference's ``_ffd_step`` scan; a
    ``rank`` of [G, O] ranks step g by its row ``rank[g]``.  int32 sums
    are taken wider and cast back, which wraps exactly as the reference's
    int32 arithmetic does."""
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
        rank_g = rank[g] if rank.dim() == 2 else rank
        cpp = torch.where(fit_e > 0, rank_g / fit_e.to(torch.float32),
                          float("inf"))
        best = torch.argmin(cpp)                      # first index on ties
        bf = fit_e[best]
        pods_new, opened = open_nodes(rem, bf, ptr, idx)
        node_off = torch.where(opened, best.to(i32), node_off)
        resid = torch.where(opened[:, None],
                            alloc[best][None, :] - pods_new[:, None]
                            * req[None, :], resid)
        ptr = (ptr + opened.sum()).to(i32)
        unplaced[g] = rem - pods_new.sum().to(i32)
        assign[g] = take + pods_new
    return node_off, assign, unplaced


def ffd_scan_fleet_reference(meta: torch.Tensor, compat: torch.Tensor,
                             alloc: torch.Tensor, rank: torch.Tensor,
                             N: int):
    """Plain PyTorch version of the kernel, on any device: a loop over
    the C problems, each with its own catalog ``alloc[c]``, ``rank[c]``,
    and inside it over the G groups."""
    outs = [_ffd_scan_one(meta[c], compat[c], alloc[c], rank[c], N)
            for c in range(meta.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))


def ffd_scan_reference(meta: torch.Tensor, compat: torch.Tensor,
                       alloc: torch.Tensor, rank: torch.Tensor, N: int):
    """Plain version of :func:`ffd_scan`: the fleet's with the one
    catalog expanded over the C problems."""
    C = meta.shape[0]
    return ffd_scan_fleet_reference(meta, compat, alloc.expand(C, -1, -1),
                                    rank.expand(C, *rank.shape), N)


def _check(meta, compat, alloc, rank, N: int, fleet: bool):
    if meta.dim() != 3 or meta.shape[2] != 8 or meta.dtype != torch.int32:
        raise ValueError(f"meta must be int32 [C, G, 8], got "
                         f"{meta.dtype} {tuple(meta.shape)}")
    C, G, _ = meta.shape
    if compat.dim() != 3 or compat.shape[:2] != (C, G) \
            or compat.dtype not in (torch.int32, torch.uint8):
        raise ValueError(f"compat must be int32/uint8 [C, G, O], got "
                         f"{compat.dtype} {tuple(compat.shape)}")
    O = compat.shape[2]
    lead = (C,) if fleet else ()
    if alloc.shape != lead + (O, 4) or alloc.dtype != torch.int32:
        raise ValueError(f"alloc must be int32 {list(lead + (O, 4))}, got "
                         f"{alloc.dtype} {tuple(alloc.shape)}")
    if rank.shape not in (lead + (O,), lead + (G, O)) \
            or rank.dtype != torch.float32:
        raise ValueError(f"rank must be float32 {list(lead + (O,))} or "
                         f"{list(lead + (G, O))}, got {rank.dtype} "
                         f"{tuple(rank.shape)}")
    if O == 0 or N <= 0:
        raise ValueError(f"need O > 0 and N > 0 (O={O}, N={N})")
    devs = {t.device for t in (meta, compat, alloc, rank)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    dev = meta.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the FFD scan runs on cpu or cuda, not {dev}")
    return C, G, O


def _problem_stride(t: torch.Tensor, name: str) -> int:
    """Element stride between the problems' catalogs in a per-problem
    tensor ([C, O, 4] or [C, O]) whose rows are contiguous: its own
    stride for C stacked catalogs, 0 for one catalog expanded over C."""
    inner = t[0]
    if not inner.is_contiguous():
        raise ValueError(f"{name}[c] must be contiguous")
    if t.shape[0] == 1 or t.stride(0) == 0:
        return 0
    if t.stride(0) != inner.numel():
        raise ValueError(f"{name} must be contiguous or one catalog "
                         f"expanded over C (stride 0), got strides "
                         f"{t.stride()}")
    return t.stride(0)


def _launch(meta, compat, alloc, alloc_stride, rank, rank_stride,
            rank_gstride, N, C, G, O):
    from karpenter_tpu_torch import cuda_build

    lib = cuda_build.load("ffd_scan")
    if N > lib.ffd_scan_max_nodes():
        raise ValueError(f"the FFD scan takes N <= "
                         f"{lib.ffd_scan_max_nodes()}, got {N}")
    for name, t in (("meta", meta), ("compat", compat)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if alloc.data_ptr() % 16:
        raise ValueError("alloc must be 16-byte aligned (read as int4)")
    if rank_gstride and (O % 4 or rank.data_ptr() % 16):
        # each group's row rides the chain's ring as one TMA bulk copy
        raise ValueError(f"a rank row per group needs O % 4 == 0 and a "
                         f"16-byte aligned rank (O={O}, address "
                         f"{rank.data_ptr():#x})")
    dev = meta.device
    # the prologue's rows: scratch the chain reads, 16-byte aligned rows
    rows = torch.empty((C, G, lib.ffd_scan_row_words(O)), dtype=torch.int32,
                       device=dev)
    node_off = torch.empty((C, N), dtype=torch.int32, device=dev)
    assign = torch.empty((C, G, N), dtype=torch.int32, device=dev)
    unplaced = torch.empty((C, G), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.ffd_scan_launch(
        meta.data_ptr(), compat.data_ptr(),
        int(compat.dtype == torch.uint8), alloc.data_ptr(), alloc_stride,
        rank.data_ptr(), rank_stride, rank_gstride, rows.data_ptr(),
        node_off.data_ptr(),
        assign.data_ptr(), unplaced.data_ptr(), C, G, O, N, FIT_BIG,
        dev.index, stream)
    if err != 0:
        msg = lib.ffd_scan_error_string(err).decode()
        raise RuntimeError(f"ffd_scan launch failed: cudaError {err} ({msg})")
    return node_off, assign, unplaced


VARIANTS = ("rows and catalog read from global memory",
            "rows staged in shared memory, catalog from global memory",
            "rows and catalog staged in shared memory",
            "rows, catalog and the groups' rank rows staged in shared memory",
            "rows and the groups' rank rows staged in shared memory, "
            "catalog from global memory")
# the instantiations each form takes
SHARED_ROW_VARIANTS = VARIANTS[:3]
GROUP_RANK_VARIANTS = (VARIANTS[0], VARIANTS[1], VARIANTS[3], VARIANTS[4])


def scan_variant(O: int, N: int, group_rank: bool = False) -> str:
    """The chain kernel's instantiation for offerings O and node slots N,
    with one rank row shared by the groups or (``group_rank``) a row per
    group, as the launcher picks it from the shapes and the form alone
    (needs the built library): the shared-memory budget rule of
    ``csrc/ffd_scan.cu``, where the per-group form's ring slots also
    hold the group's rank row where that fits."""
    from karpenter_tpu_torch import cuda_build

    return VARIANTS[cuda_build.load("ffd_scan").ffd_scan_variant(
        O, N, int(group_rank))]


def _group_stride(rank: torch.Tensor, per_problem: bool, O: int) -> int:
    """Element stride between the groups' rank rows: O for a row per
    group (rows contiguous), 0 for one row shared by the groups."""
    if rank.dim() == (2 if per_problem else 1):
        return 0
    if rank.stride(-1) != 1 or rank.stride(-2) != O:
        raise ValueError(f"the per-group rank rows must be contiguous, got "
                         f"strides {rank.stride()}")
    return O


def _count(name: str, gstride: int) -> None:
    LAUNCHES["ffd_scan_pref" if gstride else name] += 1


def ffd_scan(meta: torch.Tensor, compat: torch.Tensor, alloc: torch.Tensor,
             rank: torch.Tensor, N: int):
    """The FFD scan of C problems sharing one catalog (``rank`` [O], or
    [G, O] with a row per group): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.  Returns (node_off [C, N], assign
    [C, G, N], unplaced [C, G]), all int32.  A launch with a row per
    group counts as ``ffd_scan_pref``."""
    C, G, O = _check(meta, compat, alloc, rank, N, fleet=False)
    if meta.device.type == "cpu":
        return ffd_scan_reference(meta, compat, alloc, rank, N)
    for name, t in (("alloc", alloc), ("rank", rank)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    gstride = _group_stride(rank, False, O)
    out = _launch(meta, compat, alloc, 0, rank, 0, gstride, N, C, G, O)
    _count("ffd_scan", gstride)
    return out


def ffd_scan_fleet(meta: torch.Tensor, compat: torch.Tensor,
                   alloc: torch.Tensor, rank: torch.Tensor, N: int):
    """The FFD scan of C problems, each with its own catalog (``alloc``
    [C, O, 4], ``rank`` [C, O] or [C, G, O] with a row per group; a
    catalog expanded over C with stride 0 is one catalog shared by all):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Returns (node_off [C, N], assign [C, G, N], unplaced [C, G]), all
    int32.  A launch with a row per group counts as ``ffd_scan_pref``."""
    C, G, O = _check(meta, compat, alloc, rank, N, fleet=True)
    if meta.device.type == "cpu":
        return ffd_scan_fleet_reference(meta, compat, alloc, rank, N)
    gstride = _group_stride(rank, True, O)
    out = _launch(meta, compat, alloc, _problem_stride(alloc, "alloc"),
                  rank, _problem_stride(rank, "rank"), gstride, N, C, G, O)
    _count("ffd_scan_fleet", gstride)
    return out
