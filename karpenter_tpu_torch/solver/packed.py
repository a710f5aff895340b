"""The device half of a solve: packed buffers in, packed results out.

PyTorch twins of the device programs of ``karpenter_tpu/solver/
jax_backend.py``: unpack the problem (``_unpack_problem``), run the FFD
scan (the CUDA kernel of ``solver/ffd_kernel.py`` on the card, its plain
version on the CPU), right-size and cost (``finish_pallas_solve`` /
``_right_size``), and pack the result with its explain words and
telemetry block (``_pack_result_telemetry``).  :func:`solve_packed_torch`
returns the same int32 buffer as the reference's ``solve_packed``, word
for word (the cost word too: ``solver/cost_sum.py`` sums the open-node
prices in the reference's order), and :func:`solve_packed_pref_torch`
the buffer of ``solve_packed_pref``: the same program with soft
preferences, which rank each group by its own row (the FFD kernel with
a [G, O] rank) and right-size by the presence-averaged penalty.

The batched programs run C problems at once: :func:`solve_packed_batch_torch`
(C windows sharing one catalog: ``solve_packed_batch`` /
``solve_packed_pallas_batch``) and :func:`fleet_packed_torch` (C
clusters, each with its own catalog: ``parallel/fleet.py::
fleet_packed_pallas``).  Each unpacks and finishes every row with
``torch.func.vmap`` over the single-window functions (``jax.vmap`` in
the reference) around ONE launch of the fleet kernel and ONE launch of
the cost sum (taken outside vmap over the [C, N] masked prices), so a
batch costs one window's launches, never C times as many.

Everything here is shape-static and issues no host synchronization (no
``.item()``, no boolean-mask indexing, no tensors built from Python
scalars), so a whole window is enqueued on the device stream at once.  int32
arithmetic follows the reference: torch widens integer sums to int64,
so every sum the reference takes in int32 is cast back (which wraps the
same way), and integer contractions are written as broadcast-multiply
sums in int64 rather than matrix products (CUDA has no integer matmul).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from karpenter_tpu_torch.explain import (
    BIT, DEFICIT_CLIP, DEFICIT_MASKED, RESOURCE_BITS,
)
from karpenter_tpu_torch.solver.cost_sum import cost_sum
from karpenter_tpu_torch.solver.ffd_kernel import ffd_scan, ffd_scan_fleet
from karpenter_tpu_torch.solver.presence_sum import presence_sum
from karpenter_tpu_torch.solver.result_layout import (
    BP_SCALE, SLOT_BINDING_GROUPS, SLOT_FILL_ACCEL_BP, SLOT_FILL_CPU_BP,
    SLOT_FILL_MEM_BP, SLOT_FILL_PODS_BP, SLOT_GROUPS_PLACED,
    SLOT_GROUPS_UNPLACED, SLOT_NODES_OPEN, SLOT_PODS_UNPLACED,
    SLOT_SLACK_MEAN_BP, SLOT_SLACK_MIN_BP, TELEMETRY_MAGIC,
    TELEMETRY_SLOT_COUNT,
)

I32 = torch.int32
I64 = torch.int64
INT32_MIN = -(1 << 31)


def _i32(x: torch.Tensor) -> torch.Tensor:
    """Wrap a wider integer tensor to int32 (two's complement)."""
    return x.to(I32)


def unpack_problem(packed: torch.Tensor, off_alloc: torch.Tensor,
                   G: int, O: int, U: int):
    """Inverse of the host ``pack_input`` -> (meta [G,8], compat [G,O]
    int32 0/1, label rows_g [G,O] int32 0/1).  compat is rebuilt on the
    device: each group's label row AND the resource fit of its request
    against the resident catalog.  Bits are little-endian, as numpy's
    ``packbits(..., bitorder="little")`` wrote them."""
    meta = packed[:G * 8].reshape(G, 8)
    cw = packed[G * 8:].reshape(U, O // 32)
    shifts = torch.arange(32, dtype=I32, device=packed.device)
    rows = ((cw[:, :, None] >> shifts) & 1).reshape(U, O)      # [U, O]
    rows_g = rows[torch.clamp(meta[:, 6], 0, U - 1).long()]
    fit = (off_alloc[None, :, :] >= meta[:, None, :4]).all(dim=2)
    return meta, rows_g * fit.to(I32), rows_g


def _load(assign: torch.Tensor, req: torch.Tensor) -> torch.Tensor:
    """[G,N] x [G,R] -> [N,R] int32, the reference's
    einsum("gn,gr->nr") with int32 accumulation: summed in int64 one
    resource at a time and wrapped back."""
    a = assign.to(I64)
    cols = [(a * req[:, r].to(I64)[:, None]).sum(dim=0)
            for r in range(req.shape[1])]
    return _i32(torch.stack(cols, dim=1))


def right_size(node_off, load, assign, compat, off_alloc, off_rank,
               fits=None, miss_g=None, pref_lambda: float = 0.0):
    """Per open node, the cheapest offering that fits its final ``load``
    [N,R] and admits every group placed on it (``_right_size``).
    ``fits`` [N,O] replaces the plain capacity test (the stochastic
    route's chance check).  With soft preferences (``miss_g`` float32
    [G,O]) an offering ranks at rank * (1 + lambda * the mean miss of
    the groups on the node)."""
    N = node_off.shape[0]
    is_open = node_off >= 0
    safe_off = torch.clamp(node_off, min=0).long()
    # group presence [G,N] -> incompat counts [N,O]: a float product of
    # 0/1 values with float32 accumulation, exact (counts <= G < 2^24)
    # whether or not the card rounds the 0/1 inputs to TF32
    present = (assign > 0).to(torch.float32)
    incompat = (~compat).to(torch.float32)
    incompat_count = present.t() @ incompat                    # [N, O]
    all_compat = incompat_count < 0.5
    if fits is None:
        fits = (off_alloc[None, :, :] >= load[:, None, :]).all(dim=2)
    candidate = all_compat & fits & is_open[:, None]
    if miss_g is not None:
        rank_eff = off_rank[None, :] * (
            1.0 + pref_lambda * _presence_mean(present, miss_g))
    else:
        rank_eff = off_rank[None, :].expand(N, off_rank.shape[0])
    cand_price = torch.where(candidate, rank_eff, float("inf"))
    best = torch.argmin(cand_price, dim=1).to(I32)   # first index on ties
    best_price = cand_price.min(dim=1).values
    cur_price = torch.gather(rank_eff, 1, safe_off[:, None])[:, 0]
    # float32 throughout, as the reference: a python float scalar does
    # not promote the float32 tensor
    improve = is_open & (best_price < cur_price - 1e-9)
    return torch.where(improve, best, node_off)


def _presence_mean(present, miss_g):
    """[N, O] mean of ``miss_g`` [G, O] over the groups present on each
    node (``present`` [G, N] 0/1), summed group by group in order
    (``presence_sum``: the order of the CPU program the card is held
    against, which a matrix product on the card does not keep)."""
    return presence_sum(present, miss_g) \
        / torch.clamp(present.sum(dim=0), min=1.0)[:, None]


def finish_solve(meta, compat_i, node_off, assign, off_alloc, off_price,
                 off_rank, right_size_on: bool, miss_g=None,
                 pref_lambda: float = 0.0):
    """Right-sizing on the exact integer load + the open-node prices
    (``finish_pallas_solve``; with ``miss_g`` the pref branch of
    ``_right_size``) -> (node_off [N], prices [N], 0 where a node is
    closed).  The caller sums the prices with :func:`cost_sum`, outside
    any vmap (a kernel launched through ctypes has no batching rule)."""
    if right_size_on:
        load = _load(assign, meta[:, :4])
        node_off = right_size(node_off, load, assign, compat_i > 0,
                              off_alloc, off_rank, miss_g=miss_g,
                              pref_lambda=pref_lambda)
    is_open = node_off >= 0
    prices = off_price[torch.clamp(node_off, min=0).long()]
    return node_off, torch.where(is_open, prices, torch.zeros_like(prices))


def compact_assign(assign: torch.Tensor, K: int):
    """[G,N] -> COO in n-major order: (flat_idx int32 [K], cnt [K]).
    The reference scatters with mode="drop"; torch has none, so every
    out-of-range target (a zero cell, or a nonzero past slot K) is
    routed to a dump slot K that is cut off afterwards.  The scatter is
    out of place so that ``torch.func.vmap`` batches it."""
    flat = assign.t().reshape(-1)                      # n-major [N*G]
    mask = flat > 0
    pos = torch.cumsum(mask.to(I32), 0) - 1
    tgt = torch.where(mask & (pos < K), pos, K).long()
    src = torch.arange(flat.shape[0], dtype=I32, device=assign.device)
    idx = torch.zeros(K + 1, dtype=I32, device=assign.device).scatter(
        0, tgt, src)
    cnt = torch.zeros(K + 1, dtype=flat.dtype, device=assign.device).scatter(
        0, tgt, flat)
    return idx[:K], cnt[:K]


def pack16_pairs(a: torch.Tensor) -> torch.Tensor:
    """int32 [2n] -> int32 [n] of int16 pairs (low half = even element).
    The shift is taken in int64 and wrapped, as the reference's int32
    shift wraps."""
    pairs = a.reshape(-1, 2).to(I64)
    return _i32((pairs[:, 0] & 0xFFFF) | (pairs[:, 1] << 16))


def pack_result(node_off, assign, unplaced, cost, K: int,
                dense16: bool = False, coo16: bool = False):
    """Flatten the solve result into the one result buffer
    (``_pack_result``).  ``cost`` is the float cost or, from a caller
    under ``vmap``, its int32 bit pattern already (not every torch has a
    batching rule for the dtype view that bit-casts it)."""
    cost_i = cost.reshape(1) if cost.dtype == I32 \
        else cost.to(torch.float32).reshape(1).view(I32)     # bit cast
    if K > 0:
        idx, cnt = compact_assign(assign.to(I32), K)
        if coo16:
            tail = [_i32((idx.to(I64) << 16) | cnt.to(I64))]
        else:
            tail = [idx, cnt]
    elif dense16:
        tail = [pack16_pairs(assign.to(I32))]
    else:
        tail = [assign.to(I32).reshape(-1)]
    return torch.cat([node_off, unplaced.to(I32), cost_i] + tail)


def explain_words(meta, rows_g, compat_i, unplaced, off_alloc):
    """Per-group explain reason words int32 [G] (``_explain_words``);
    bit-identical to the host oracle ``explain.greedy.reason_words``."""
    req = meta[:, :4]
    count = meta[:, 4]
    prio = meta[:, 7]
    lbl = rows_g > 0
    compat = compat_i > 0
    has_label = lbl.any(dim=1)
    has_fit = compat.any(dim=1)
    per_dim = torch.clamp(req[:, None, :] - off_alloc[None, :, :],
                          min=0, max=DEFICIT_CLIP)
    deficit = _i32(per_dim.sum(dim=2))                       # [G, O]
    masked = torch.where(lbl, deficit, DEFICIT_MASKED)
    nearest = torch.argmin(masked, dim=1)                    # first index
    near_alloc = off_alloc[nearest]                          # [G, R]
    insufficient = has_label & ~has_fit
    bits = torch.zeros(req.shape[0], dtype=I32, device=meta.device)
    for r, bit_name in enumerate(RESOURCE_BITS):
        hit = insufficient & (req[:, r] > near_alloc[:, r])
        bits = bits | torch.where(hit, 1 << BIT[bit_name], 0).to(I32)
    bits = bits | torch.where(~has_label, 1 << BIT["requirements"],
                              0).to(I32)
    bits = bits | torch.where(has_fit, 1 << BIT["capacity_exhausted"],
                              0).to(I32)
    # consumed by higher priority, in O(G*O): per offering, the max
    # priority among PLACED compatible groups
    placed = (count - unplaced) > 0
    max_placed_prio = torch.where(compat & placed[:, None], prio[:, None],
                                  INT32_MIN).max(dim=0).values     # [O]
    cap_hp = (compat & (max_placed_prio[None, :] > prio[:, None])
              ).any(dim=1) & has_fit
    bits = bits | torch.where(cap_hp, 1 << BIT["capacity_higher_prio"],
                              0).to(I32)
    live_un = (count > 0) & (unplaced > 0)
    return torch.where(live_un, bits, 0).to(I32)


def _addmod(a, b, den):
    """((a + b) mod den, carry) without forming a + b (both < den, which
    may be near int32 max); den - b never overflows."""
    room = den - b
    wrap = a >= room
    return torch.where(wrap, a - room, a + b), wrap.to(I32)


def frac_bp(num, den):
    """floor(clip(num, 0, den) * BP_SCALE / den) in pure int32 by base-10
    long division (``_frac_bp``); den <= 0 reads as empty -> 0."""
    den1 = torch.clamp(den, min=1)
    num1 = torch.minimum(torch.clamp(num, min=0), den1)
    bp = torch.div(num1, den1, rounding_mode="floor")
    r = num1 - bp * den1
    for _ in range(4):
        r0 = r
        r, c = _addmod(r, r, den1)                  # 2r
        q = c
        r, c = _addmod(r, r, den1)                  # 4r
        q = q * 2 + c
        r, c = _addmod(r, r0, den1)                 # 5r
        q = q + c
        r, c = _addmod(r, r, den1)                  # 10r
        q = q * 2 + c
        bp = bp * 10 + q
    return torch.clamp(bp, 0, BP_SCALE)


def telemetry_words(meta, node_off, assign, unplaced, off_alloc,
                    binding=None):
    """The [1 + TELEMETRY_SLOT_COUNT] telemetry block, magic word first
    (``_telemetry_words``); host-sourced slots ride the wire as zero.
    ``binding`` [G] bool is the constrained-group mask of the stochastic
    and affinity routes, counted over live groups."""
    dev = meta.device
    req = meta[:, :4]
    count = meta[:, 4]
    unp = unplaced.to(I32)
    open_mask = node_off >= 0
    open_i = open_mask.to(I32)
    safe = torch.where(open_mask, node_off, 0).long()
    caps = off_alloc[safe] * open_i[:, None]                    # [N, R]
    load = _load(assign.to(I32), req) * open_i[:, None]         # [N, R]
    cap_tot = _i32(caps.sum(dim=0))
    load_tot = _i32(load.sum(dim=0))
    fill = torch.where(cap_tot > 0, frac_bp(load_tot, cap_tot), 0)
    resid = caps - load
    node_bp = torch.where(caps > 0, frac_bp(resid, caps),
                          BP_SCALE).min(dim=1).values            # [N]
    nodes_open = _i32(open_i.sum())
    any_open = nodes_open > 0
    slack_min = torch.where(
        any_open, torch.where(open_mask, node_bp, BP_SCALE).min(), 0)
    slack_sum = _i32(torch.where(open_mask, node_bp, 0).sum())
    slack_mean = torch.where(
        any_open,
        torch.div(slack_sum, torch.clamp(nodes_open, min=1),
                  rounding_mode="floor"), 0)
    live = count > 0
    placed_g = live & ((count - unp) > 0)
    unplaced_g = live & (unp > 0)
    zero = torch.zeros((), dtype=I32, device=dev)
    slots = [zero] * TELEMETRY_SLOT_COUNT
    slots[SLOT_FILL_CPU_BP] = fill[0]
    slots[SLOT_FILL_MEM_BP] = fill[1]
    slots[SLOT_FILL_ACCEL_BP] = fill[2]
    slots[SLOT_FILL_PODS_BP] = fill[3]
    slots[SLOT_SLACK_MIN_BP] = slack_min
    slots[SLOT_SLACK_MEAN_BP] = slack_mean
    slots[SLOT_NODES_OPEN] = nodes_open
    slots[SLOT_GROUPS_PLACED] = _i32(placed_g.to(I32).sum())
    slots[SLOT_GROUPS_UNPLACED] = _i32(unplaced_g.to(I32).sum())
    slots[SLOT_PODS_UNPLACED] = _i32(torch.where(live, unp, 0).sum())
    slots[SLOT_BINDING_GROUPS] = zero if binding is None \
        else _i32((binding & live).to(I32).sum())
    magic = torch.full((), int(TELEMETRY_MAGIC), dtype=I32, device=dev)
    return torch.stack([magic] + [s.to(I32) for s in slots])


def pack_result_telemetry(meta, rows_g, compat_i, node_off, assign,
                          unplaced, cost, off_alloc, compact, dense16,
                          coo16, extra_words=None, binding=None):
    """Packed result + the [G] explain words + the telemetry block — the
    one finisher of the port's packed entry points.  ``extra_words`` [G]
    are OR-ed into the explain words (a route's own reason bits);
    ``binding`` feeds the telemetry's binding-groups slot."""
    out = pack_result(node_off, assign, unplaced, cost, compact, dense16,
                      coo16)
    words = explain_words(meta, rows_g, compat_i, unplaced.to(I32),
                          off_alloc)
    if extra_words is not None:
        words = words | extra_words
    tele = telemetry_words(meta, node_off, assign, unplaced, off_alloc,
                           binding=binding)
    return torch.cat([out, words, tele])


def solve_packed_torch(packed, off_alloc, off_price, off_rank, *, G: int,
                       O: int, U: int, N: int, right_size: bool = True,
                       compact: int = 0, dense16: bool = False,
                       coo16: bool = False) -> torch.Tensor:
    """One window: packed int32 problem buffer -> packed int32 result
    buffer, on the device the inputs lie on.  ``off_alloc`` int32 [O, 4]
    (contiguous), ``off_price`` / ``off_rank`` float32 [O]."""
    meta, compat_i, rows_g = unpack_problem(packed, off_alloc, G, O, U)
    node_off, assign, unplaced = ffd_scan(
        meta[None].contiguous(), compat_i[None].contiguous(), off_alloc,
        off_rank, N)
    node_off, assign, unplaced = node_off[0], assign[0], unplaced[0]
    node_off, prices = finish_solve(meta, compat_i, node_off, assign,
                                    off_alloc, off_price, off_rank,
                                    right_size)
    return pack_result_telemetry(meta, rows_g, compat_i, node_off, assign,
                                 unplaced, cost_sum(prices), off_alloc,
                                 compact, dense16, coo16)


def pref_rank_rows(pref_rows, pref_idx, off_rank, lam: float):
    """(miss_g [G, O], rank_g [G, O]) of the pref scan (``solve_core``,
    ``jax_backend.py:958-966``): a group's weighted miss row (0 for a
    group with no preference, ``pref_idx`` < 0) and its ranking price
    rank * (1 + lam * miss), in the reference's op order.  A group with
    no preference ranks at ``off_rank`` exactly."""
    P = pref_rows.shape[0]
    rows = pref_rows[torch.clamp(pref_idx, 0, P - 1).long()]
    miss_g = torch.where((pref_idx >= 0)[:, None], rows,
                         torch.zeros((), dtype=torch.float32,
                                     device=rows.device))
    return miss_g, (off_rank[None, :] * (1.0 + lam * miss_g)).contiguous()


def solve_packed_pref_torch(packed, pref_rows, pref_idx, off_alloc,
                            off_price, off_rank, *, G: int, O: int, U: int,
                            N: int, P: int, right_size: bool = True,
                            compact: int = 0, dense16: bool = False,
                            coo16: bool = False,
                            lam_bp: int = 1500) -> torch.Tensor:
    """One window with soft preferences (``solve_packed_pref``):
    ``pref_rows`` float32 [P, O] weighted miss fractions, ``pref_idx``
    int32 [G] (-1 = none), ``lam_bp`` the penalty weight in basis points.
    The FFD kernel ranks each group by its own row (one launch, counted
    as ``ffd_scan_pref``); right-sizing ranks by the presence-averaged
    penalty, whose sum is the order-fixed ``presence_sum`` kernel."""
    if pref_rows.shape[0] != P:
        raise ValueError(f"pref_rows has {pref_rows.shape[0]} rows, P={P}")
    lam = lam_bp / 10000.0
    meta, compat_i, rows_g = unpack_problem(packed, off_alloc, G, O, U)
    miss_g, rank_g = pref_rank_rows(pref_rows, pref_idx, off_rank, lam)
    node_off, assign, unplaced = ffd_scan(
        meta[None].contiguous(), compat_i[None].contiguous(), off_alloc,
        rank_g, N)
    node_off, assign, unplaced = node_off[0], assign[0], unplaced[0]
    node_off, prices = finish_solve(meta, compat_i, node_off, assign,
                                    off_alloc, off_price, off_rank,
                                    right_size, miss_g=miss_g,
                                    pref_lambda=lam)
    return pack_result_telemetry(meta, rows_g, compat_i, node_off, assign,
                                 unplaced, cost_sum(prices), off_alloc,
                                 compact, dense16, coo16)


def _cost_words(cost: torch.Tensor) -> torch.Tensor:
    """[C] float costs -> their int32 bit patterns, cast outside vmap."""
    return cost.to(torch.float32).view(I32)


def solve_packed_batch_torch(packed_rows, off_alloc, off_price, off_rank, *,
                             C: int, G: int, O: int, U: int, N: int,
                             right_size: bool = True, compact: int = 0,
                             dense16: bool = False,
                             coo16: bool = False) -> torch.Tensor:
    """C same-catalog windows: packed int32 problems [C, Li] -> packed
    int32 results [C, Lo], each row equal to :func:`solve_packed_torch`
    of that row.  One fleet-kernel launch with the catalog expanded over
    the C problems (stride 0), and one cost-sum launch."""
    metas, compats, rows = vmap(
        lambda p: unpack_problem(p, off_alloc, G, O, U))(packed_rows)
    node_off, assign, unplaced = ffd_scan_fleet(
        metas.contiguous(), compats.contiguous(),
        off_alloc.expand(C, O, 4), off_rank.expand(C, O), N)
    node_off, prices = vmap(
        lambda m, ci, no, a: finish_solve(m, ci, no, a, off_alloc,
                                          off_price, off_rank, right_size)
    )(metas, compats, node_off, assign)
    return vmap(
        lambda m, r, ci, no, a, u, cw: pack_result_telemetry(
            m, r, ci, no, a, u, cw, off_alloc, compact, dense16, coo16)
    )(metas, rows, compats, node_off, assign, unplaced,
      _cost_words(cost_sum(prices)))


def fleet_packed_torch(packed_rows, alloc_all, rank_all, price_all, *,
                       C: int, G: int, O: int, U: int, N: int,
                       right_size: bool = True,
                       compact: int = 0) -> torch.Tensor:
    """C clusters, each with its own catalog (``alloc_all`` int32
    [C, O, 4], ``rank_all`` / ``price_all`` float32 [C, O]): packed
    problems [C, Li] -> packed results [C, Lo] in the bare
    :func:`pack_result` layout (no explain words, no telemetry: the
    fleet wire's parser is ``fleet_parse_outputs``).  One fleet-kernel
    launch and one cost-sum launch."""
    metas, compats, _ = vmap(
        lambda p, a: unpack_problem(p, a, G, O, U))(packed_rows, alloc_all)
    node_off, assign, unplaced = ffd_scan_fleet(
        metas.contiguous(), compats.contiguous(), alloc_all, rank_all, N)
    node_off, prices = vmap(
        lambda m, ci, no, a, alloc, price, rank: finish_solve(
            m, ci, no, a, alloc, price, rank, right_size)
    )(metas, compats, node_off, assign, alloc_all, price_all, rank_all)
    return vmap(lambda no, a, u, cw: pack_result(no, a, u, cw, compact))(
        node_off, assign, unplaced, _cost_words(cost_sum(prices)))
