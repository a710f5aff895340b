"""Flat-regime solver: parallel-in-G placement for heterogeneous windows.

Port of ``karpenter_tpu/solver/flat.py``.  The FFD scan is sequential in
G: right when signature compression folds 10k pods into ~50 groups, and
wrong when it does not (near-unique request shapes, thousands of
groups).  This program places every pod ("item") at once with sorts,
cumsums and segment reductions, in a bounded loop of at most 12 rounds:

1. **Per-item class**: each constraint class (a label row, or a (label
   row, preference row) pair) gets ONE covering offering by fluid
   economics; items it cannot hold fall back to their own cheapest
   fitting offering.
2. **Fill pass** (per round): remaining items are dealt snake-order over
   the open bins ranked by slack, gated on the item's row allowing the
   bin's offering; each bin keeps the largest-first prefix that fits.
3. **Open pass** (per round): per class, ``ceil(fluid x (1 + beta))``
   fresh bins of the class offering, items dealt snake-order, the
   fitting prefix kept; overflow goes to the next round.
4. **Right-sizing**: every open bin is re-priced to the cheapest
   offering that fits its load and that every class on the bin allows,
   ranked by the presence-averaged penalty rank.

Everything but the loop's condition stays on the device.  The reference
runs the loop as a ``lax.while_loop`` whose condition is ``t < 12 &
any(active) & bins_used < N``; here the host reads that condition once
per round (one synchronization, counted in ``info["host_syncs"]``), so a
window that settles in three rounds runs three.

Where the port has to work to give the reference's words:

- float32 segment sums (``T_u``, ``T_act``) add in index order, as the
  reference's CPU does: ``solver/segment_sum.py`` (a CUDA kernel on the
  card, ``index_add_`` on the CPU), never atomics;
- every sort is stable (``jnp.argsort`` is);
- scatters with the reference's ``mode="drop"`` targets, and segment
  reductions whose sentinel segment lies past the end, write into one
  spare slot that is cut off; empty ``segment_min`` / ``segment_max``
  segments take JAX's identities (INT32_MAX / INT32_MIN);
- int32 arithmetic wraps as the reference's does (torch widens integer
  sums and cumsums to int64; they are cast back);
- the presence-averaged rank ``hrow @ rank_rows`` is summed class by
  class in a fixed order on every device, so the card and the CPU agree
  bit for bit (the reference's CPU dot picks its order by shape; bins
  hosting one or two classes, the common case, are exact either way).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.solver.cost_sum import cost_word
from karpenter_tpu_torch.solver.encode import (
    BIG_CAP, EncodedProblem, estimate_nodes,
)
from karpenter_tpu_torch.solver.packed import pack16_pairs
from karpenter_tpu_torch.solver.segment_sum import segment_sum
from karpenter_tpu_torch.solver.types import (
    COO_BUCKETS, GROUP_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, Plan, bucket,
)

ITEM_BUCKETS = (1024, 2048, 4096, 8192, 16384, 32768)
_MAX_ROUNDS = 12
# distinct (label row, pref row) classes a window may carry on the flat
# path: each bin's class-set is a [N, U] one-hot block
MAX_CLASSES = 128
CLASS_BUCKETS = (4, 8, 16, 32, 64, 128)

I32 = torch.int32
I64 = torch.int64
F32 = torch.float32
INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Device program
# ---------------------------------------------------------------------------

def _seg_add(vals: torch.Tensor, seg: torch.Tensor, S: int) -> torch.Tensor:
    """Integer segment sum over S segments (exact in any order)."""
    out = torch.zeros((S,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, seg.long(), vals)


def _seg_reduce(vals: torch.Tensor, seg: torch.Tensor, S: int,
                reduce: str) -> torch.Tensor:
    """int32 segment min ("amin") or max ("amax") over S segments; an
    empty segment holds JAX's identity (INT32_MAX / INT32_MIN)."""
    fill = INT32_MAX if reduce == "amin" else INT32_MIN
    out = torch.full((S,) + tuple(vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    idx = seg.long()
    if vals.dim() > 1:
        idx = idx[:, None].expand(vals.shape)
    return out.scatter_reduce_(0, idx, vals, reduce, include_self=True)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    """int32 cumsum along axis 0, wrapping as the reference's does.  An
    [I, R] operand is scanned as [R, I] rows: PyTorch scans a leading
    axis of a narrow matrix with one thread per column on the card
    (~0.6 ms at [16384, 4]), an innermost axis in parallel."""
    if x.dim() == 2:
        return torch.cumsum(x.t().contiguous(), 1).to(I32).t()
    return torch.cumsum(x, 0).to(I32)


def _segmented_prefix(req2: torch.Tensor, bin2: torch.Tensor,
                      I: int) -> torch.Tensor:
    """Exclusive per-bin prefix sums of ``req2`` [I, R] whose rows are
    grouped by ``bin2`` (ascending): the exclusive global cumsum minus
    its value at each segment's head (its per-segment min)."""
    cum = _cumsum32(req2)
    excl = cum - req2
    isfirst = torch.ones_like(bin2, dtype=torch.bool)
    isfirst[1:] = bin2[1:] != bin2[:-1]
    seg_id = _cumsum32(isfirst.to(I32)) - 1
    base = _seg_reduce(excl, seg_id, I, "amin")
    return excl - base[seg_id.long()]


def _snake(k: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Snake-order position of rank ``k`` over ``n`` slots."""
    j = torch.remainder(k, 2 * n)
    return torch.where(j < n, j, 2 * n - 1 - j)


def _scatter_perm(perm: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out[perm] = vals for a permutation ``perm``."""
    out = torch.empty_like(vals)
    out[perm] = vals
    return out


def _flat_body(item_req, item_gid, item_live, rows, item_row, off_alloc,
               off_rank, miss_rows, off_price, *, I: int, O: int, G: int,
               N: int, K: int, U: int, beta_bp: int, lam_bp: int):
    dev = item_req.device
    R = item_req.shape[1]
    reqf = item_req.to(F32)
    allocf = torch.clamp(off_alloc.to(F32), min=1.0)
    Cmax = torch.clamp(off_alloc.max(dim=0).values.to(F32), min=1.0)
    rank_rows = off_rank[None, :] * (1.0 + (lam_bp / 10000.0) * miss_rows)

    # exact per-item placeability: resource fit AND the item's label row
    fits = (off_alloc[None, :, :] >= item_req[:, None, :]).all(dim=2)
    rc = torch.clamp(item_row, 0, U - 1).long()
    okoff = fits & rows[rc]                                       # [I, O]
    fit_any = okoff.any(dim=1) & item_live

    # per-item bin class: the class's covering offering by fluid
    # economics, else the item's own cheapest fitting offering
    price_fit = torch.where(okoff, rank_rows[rc], float("inf"))
    exact_cls = torch.argmin(price_fit, dim=1).to(I32)
    seg_row = torch.where(fit_any, item_row, U)
    # the reference sums into num_segments=U + 1 and drops the sentinel
    # segment U; segment_sum drops ids outside [0, U) itself, so U
    # segments give the same words without the sentinel's add chain
    T_u = segment_sum(torch.where(fit_any[:, None], reqf, 0.0), seg_row,
                      U)                                          # [U, R]
    max_u = _seg_reduce(torch.where(fit_any[:, None], item_req, 0), seg_row,
                        U + 1, "amax")[:U]
    covers_u = rows & (off_alloc[None, :, :] >= max_u[:, None, :]).all(dim=2)
    fluid_u = (T_u[:, None, :] / allocf[None, :, :]).max(dim=2).values
    score_u = torch.where(covers_u,
                          rank_rows * torch.clamp(fluid_u, min=1.0),
                          float("inf"))
    ostar_u = torch.argmin(score_u, dim=1).to(I32)                # [U]
    has_cover_u = covers_u.any(dim=1)
    star_i = ostar_u[rc]
    fits_star = torch.gather(okoff, 1, star_i.long()[:, None])[:, 0]
    cls = torch.where(has_cover_u[rc] & fits_star, star_i, exact_cls)
    Ci = off_alloc[cls.long()]

    # static order: class-major, dominant share descending; unplaceable
    # items last
    share = (reqf / torch.clamp(Ci.to(F32), min=1.0)).max(dim=1).values
    skey = torch.where(fit_any,
                       cls.to(F32) * 2.0 - torch.clamp(share, max=1.0),
                       torch.full_like(share, 3e9))
    order = torch.argsort(skey, stable=True)
    sreq = item_req[order]
    scls = cls[order]
    scls_l = scls.long()
    active = fit_any[order]
    sCap = off_alloc[scls_l]
    sok = okoff[order]
    soh = (torch.arange(U, dtype=I32, device=dev)[None, :]
           == item_row[order][:, None]).to(I32)                   # [I, U]
    beta = beta_bp / 10000.0

    bins_used = torch.zeros((), dtype=I32, device=dev)
    bin_of = torch.full((I,), N, dtype=I32, device=dev)
    load = torch.zeros((N, R), dtype=I32, device=dev)
    obin = torch.zeros((N,), dtype=I32, device=dev)
    npods = torch.zeros((N,), dtype=I32, device=dev)
    hrow = torch.zeros((N, U), dtype=I32, device=dev)
    syncs = rounds = 0
    for _ in range(_MAX_ROUNDS):
        syncs += 1
        if not bool((active.any() & (bins_used < N)).item()):
            break
        rounds += 1
        open_b = npods > 0
        n_open = open_b.to(I32).sum().to(I32)

        # ---- fill pass: open bins ranked by slack, snake-dealt
        capb = off_alloc[obin.long()]
        slack = torch.where(open_b[:, None], capb - load, -1)
        slack_key = torch.where(
            open_b, -(slack.to(F32) / Cmax[None, :]).max(dim=1).values,
            torch.full((N,), 3e9, dtype=F32, device=dev))
        blist = torch.argsort(slack_key, stable=True).to(I32)
        na = torch.clamp(n_open, min=1)
        local = _snake(_cumsum32(active.to(I32)) - 1, na)
        binf = torch.where(active & (n_open > 0), blist[local.long()], N)
        tgt_off = obin[torch.clamp(binf, 0, N - 1).long()]
        ok_t = torch.gather(sok, 1, tgt_off.long()[:, None])[:, 0]
        binf = torch.where(ok_t, binf, N)
        ord2 = torch.argsort(binf, stable=True)
        req2 = torch.where(active[:, None], sreq, 0)[ord2]
        bin2 = binf[ord2]
        slack2 = slack[torch.clamp(bin2, 0, N - 1).long()]
        prefix = _segmented_prefix(req2, bin2, I)
        keep2 = (prefix + req2 <= slack2).all(dim=1) & (bin2 < N)
        keepf = _scatter_perm(ord2, keep2)
        segf = torch.where(keepf, binf, N)
        load = load + _seg_add(torch.where(keepf[:, None], sreq, 0), segf,
                               N + 1)[:N]
        npods = npods + _seg_add(keepf.to(I32), segf, N + 1)[:N]
        hrow = torch.maximum(hrow, _seg_reduce(
            torch.where(keepf[:, None], soh, 0), segf, N + 1, "amax")[:N])
        bin_of = torch.where(keepf & active, binf, bin_of)
        active = active & ~keepf

        # ---- open pass: per class, ceil(fluid x (1+beta)) fresh bins
        af = active[:, None].to(F32)
        seg = torch.where(active, scls, O)
        # the reference's num_segments=O + 1, sentinel O dropped (as T_u)
        T_act = segment_sum(sreq.to(F32) * af, seg, O)             # [O, R]
        need = (T_act / allocf).max(dim=1).values
        hasa = _seg_add(active.to(I32), seg, O + 1)[:O] > 0
        n_new = torch.where(hasa, torch.ceil(need * (1.0 + beta)).to(I32),
                            0).to(I32)
        off_o = bins_used + _cumsum32(n_new) - n_new
        k2 = _cumsum32(active.to(I32)) - 1
        base = _seg_reduce(torch.where(active, k2, 1 << 30), seg, O + 1,
                           "amin")[:O]
        ka = k2 - base[scls_l]
        nb = torch.clamp(n_new[scls_l], min=1)
        loc2 = _snake(ka, nb)
        bino = torch.where(active & (n_new[scls_l] > 0),
                           off_o[scls_l] + loc2, N)
        bino = torch.clamp(bino, max=N)
        ord3 = torch.argsort(bino, stable=True)
        req3 = torch.where(active[:, None], sreq, 0)[ord3]
        bin3 = bino[ord3]
        cap3 = sCap[ord3]
        prefix3 = _segmented_prefix(req3, bin3, I)
        keep3 = (prefix3 + req3 <= cap3).all(dim=1) & (bin3 < N)
        keepo = _scatter_perm(ord3, keep3)
        sego = torch.where(keepo, bino, N)
        load = load + _seg_add(torch.where(keepo[:, None], sreq, 0), sego,
                               N + 1)[:N]
        npods = npods + _seg_add(keepo.to(I32), sego, N + 1)[:N]
        hrow = torch.maximum(hrow, _seg_reduce(
            torch.where(keepo[:, None], soh, 0), sego, N + 1, "amax")[:N])
        # every item of a fresh bin carries the bin's class, so duplicate
        # targets write one value; slot N is the dropped sentinel
        obin_x = torch.cat([obin, obin.new_zeros(1)])
        obin_x[sego.long()] = scls
        obin = obin_x[:N]
        bin_of = torch.where(keepo & active, bino, bin_of)
        active = active & ~keepo
        used = bins_used.to(I64) + n_new.to(I64).sum()
        bins_used = torch.clamp(used.to(I32), max=1 << 29)

    # leftover actives (normally none): one bin of the item's class each
    solo = bins_used + _cumsum32(active.to(I32)) - 1
    ok = active & (solo < N)
    bin_of = torch.where(ok, solo, bin_of)
    segs = torch.where(ok, solo, N)
    load = load + _seg_add(torch.where(ok[:, None], sreq, 0), segs,
                           N + 1)[:N]
    npods = npods + _seg_add(ok.to(I32), segs, N + 1)[:N]
    hrow = torch.maximum(hrow, _seg_reduce(
        torch.where(ok[:, None], soh, 0), segs, N + 1, "amax")[:N])
    obin_x = torch.cat([obin, obin.new_zeros(1)])
    obin_x[segs.long()] = scls
    obin = obin_x[:N]
    spilled = (active & ~ok).to(I32).sum().to(I32)

    placed_s = bin_of < N
    open_b = npods > 0

    # right-size: cheapest offering fitting the final load AND allowed by
    # every class on the bin; the class-set intersection is a 0/1
    # product, exact in float32 (and under TF32, whose inputs 0/1 are)
    hrow_f = hrow.to(F32)
    viol = hrow_f @ (~rows).to(F32)                               # [N, O]
    cand = (viol < 0.5) & (off_alloc[None, :, :]
                           >= load[:, None, :]).all(dim=2)
    # presence-averaged penalty rank, summed class by class in order
    cnt_u = torch.clamp(hrow_f.sum(dim=1, keepdim=True), min=1.0)
    rank_eff = presence_rank_sum(hrow_f, rank_rows) / cnt_u
    cand_price = torch.where(cand, rank_eff, float("inf"))
    node_off = torch.where(open_b, torch.argmin(cand_price, dim=1).to(I32),
                           -1).to(I32)
    cost = cost_word(node_off, off_price)

    # back to item space -> per-group unplaced + COO assign entries
    placed_i = _scatter_perm(order, placed_s)
    bin_i = _scatter_perm(order, bin_of)
    unplaced_g = _seg_add((item_live & ~placed_i).to(I32), item_gid, G)

    # COO in n-major order (idx = n*G + g ascending), merged per (bin,
    # group): sort the per-item keys, count segment sizes
    keymax = N * G
    keys = torch.where(placed_i, bin_i * G + item_gid, keymax).to(I32)
    sk = torch.sort(keys).values
    valid = sk < keymax
    isfirst = torch.ones_like(valid)
    isfirst[1:] = sk[1:] != sk[:-1]
    isfirst = valid & isfirst
    uidx = _cumsum32(isfirst.to(I32)) - 1
    idx_x = torch.zeros(K + 1, dtype=I32, device=dev)
    idx_x[torch.where(isfirst, uidx, K).long()] = sk
    cnt_arr = _seg_add(torch.ones_like(sk), torch.where(valid, uidx, K),
                       K + 1)[:K]
    info = {"rounds": rounds, "host_syncs": syncs}
    return node_off, unplaced_g, cost, idx_x[:K], cnt_arr, spilled, info


def presence_rank_sum(hrow_f: torch.Tensor,
                      rank_rows: torch.Tensor) -> torch.Tensor:
    """``hrow_f @ rank_rows`` ([N, U] 0/1 presence x [U, O] float32 rank
    rows -> [N, O]) summed class by class in order, as the reference's
    ``jnp.dot`` rounds on its CPU at the padded shapes the program runs
    (``tests/test_torch_cost_sum.py`` pins it).  A 0/1 times a rank is
    exact, so each present class adds its row once."""
    acc = torch.zeros((hrow_f.shape[0], rank_rows.shape[1]), dtype=F32,
                      device=hrow_f.device)
    for u in range(rank_rows.shape[0]):
        acc = acc + hrow_f[:, u:u + 1] * rank_rows[u][None, :]
    return acc


def flat_solve_torch(item_req, item_gid, item_live, rows, item_row,
                     off_alloc, off_rank, miss_rows, off_price, *, I: int,
                     O: int, G: int, N: int, K: int, U: int,
                     beta_bp: int = 300, lam_bp: int = 1500,
                     slim: bool = False):
    """One flat solve on the device the inputs lie on -> (int32 result
    buffer, info).  The buffer is ``flat_solve_kernel``'s:

    - classic (length N + G + 1 + 2K + 1): node_off [N] | unplaced [G] |
      cost (f32 bits) | COO idx [K] | COO cnt [K] | spilled;
    - ``slim`` (length N/2 + G/2 + 1 + K + K/2 + 1): node_off, unplaced
      and cnt as int16 pairs.

    ``info`` holds the rounds the loop ran and its host syncs."""
    node_off, unplaced_g, cost, idx_arr, cnt_arr, spilled, info = \
        _flat_body(item_req, item_gid, item_live, rows, item_row, off_alloc,
                   off_rank, miss_rows, off_price, I=I, O=O, G=G, N=N, K=K,
                   U=U, beta_bp=beta_bp, lam_bp=lam_bp)
    cost_i = cost.to(F32).reshape(1).view(I32)
    if slim:
        parts = [pack16_pairs(node_off), pack16_pairs(unplaced_g), cost_i,
                 idx_arr, pack16_pairs(cnt_arr), spilled.reshape(1)]
    else:
        parts = [node_off, unplaced_g, cost_i, idx_arr, cnt_arr,
                 spilled.reshape(1)]
    return torch.cat(parts), info


# ---------------------------------------------------------------------------
# Host wrapper
# ---------------------------------------------------------------------------

def flat_viable(problem: EncodedProblem, options) -> bool:
    """The flat-regime gate, host side, no [G, O] materialization: True
    for the windows the reference routes to the flat solver."""
    mode = options.flat_solver
    if mode == "off" or problem.aff is not None or not options.right_size:
        # affinity windows own their route; with right-sizing off the
        # scan path owns the solve (the flat program always re-prices)
        return False
    if mode != "on" and problem.num_groups < options.flat_min_groups:
        return False
    if problem.label_rows is None or problem.label_idx is None \
            or not (1 <= problem.label_rows.shape[0] <= MAX_CLASSES):
        return False
    if problem.pref_rows is not None:
        # preferences ride per-class penalty ranking: classes are
        # (label row, pref row) pairs, within the one-hot budget
        if problem.pref_idx is None:
            return False
        pairs = (problem.label_idx.astype(np.int64) << 32) \
            | (problem.pref_idx.astype(np.int64) & 0xFFFFFFFF)
        if np.unique(pairs).size > MAX_CLASSES:
            return False
    if not (problem.group_cap >= np.minimum(
            problem.group_count, BIG_CAP)).all():
        return False   # per-node caps (anti-affinity) need the scan path
    total = int(problem.group_count.sum())
    if total == 0 or total > ITEM_BUCKETS[-1]:
        return False
    # totals must fit int32 prefix sums
    tot = (problem.group_req.astype(np.int64)
           * problem.group_count[:, None]).sum(axis=0)
    return not (tot >= (1 << 31) - 1).any()


class FlatAttempt:
    """One flat dispatch: the host arrays (shared with the problem's
    cached template), their device copies, the node axis (which
    escalates on spill) and the pending result copy."""

    __slots__ = ("catalog", "item_req", "item_gid", "item_live", "rows",
                 "item_row", "miss_rows", "G_pad", "O_pad", "I_pad",
                 "U_pad", "N", "N_cap", "K", "slim", "dev_inputs",
                 "host", "event", "info", "t_disp", "t_issued", "tmpl")

    def __init__(self, **kw):
        self.tmpl = None
        self.dev_inputs = None
        self.host = self.event = self.info = None
        self.t_disp = self.t_issued = 0.0
        for k, v in kw.items():
            setattr(self, k, v)

    def clone(self) -> "FlatAttempt":
        c = FlatAttempt(**{s: getattr(self, s) for s in (
            "catalog", "item_req", "item_gid", "item_live", "rows", "item_row",
            "miss_rows", "G_pad", "O_pad", "I_pad", "U_pad", "N", "N_cap",
            "K", "slim")})
        c.tmpl = self
        return c


_FLAT_UNSUITABLE = "unsuitable"


def flat_template(solver, problem: EncodedProblem):
    """Host arrays of the flat program for a problem, built once and
    cached on the problem: a template ``FlatAttempt`` (never dispatched
    itself), or None when the window cannot take the flat program."""
    cache = problem._prep_cache
    if cache is None:
        cache = problem._prep_cache = {}
    key = ("flat", solver.options.max_nodes)
    tmpl = cache.get(key)
    if tmpl is _FLAT_UNSUITABLE:
        return None
    if tmpl is not None:
        return tmpl

    catalog = problem.catalog
    G = problem.num_groups
    O = catalog.num_offerings
    G_pad = bucket(G, GROUP_BUCKETS)
    O_pad = bucket(O, OFFERING_BUCKETS)
    total = int(problem.group_count.sum())
    I_pad = bucket(total, ITEM_BUCKETS)

    order = np.repeat(np.arange(G, dtype=np.int32), problem.group_count)
    item_req = np.zeros((I_pad, problem.group_req.shape[1]), np.int32)
    item_req[:total] = problem.group_req[order]
    item_gid = np.zeros(I_pad, np.int32)
    item_gid[:total] = order
    item_live = np.zeros(I_pad, bool)
    item_live[:total] = True
    # classes: distinct label rows, or distinct (label, pref) pairs when
    # soft preferences are present, each with its own penalty row
    if problem.pref_rows is not None and problem.pref_idx is not None:
        pairs = (problem.label_idx.astype(np.int64) << 32) \
            | (problem.pref_idx.astype(np.int64) & 0xFFFFFFFF)
        uniq, class_of_group = np.unique(pairs, return_inverse=True)
        U = uniq.size
        cls_label = (uniq >> 32).astype(np.int32)
        cls_pref = (uniq & 0xFFFFFFFF).astype(np.int64).astype(np.int32)
    else:
        U = problem.label_rows.shape[0]
        class_of_group = problem.label_idx
        cls_label = np.arange(U, dtype=np.int32)
        cls_pref = np.full(U, -1, np.int32)
    U_pad = bucket(U, CLASS_BUCKETS)
    rows = np.zeros((U_pad, O_pad), bool)
    src_w = min(problem.label_rows.shape[1], O_pad)
    rows[:U, :src_w] = problem.label_rows[cls_label, :src_w]
    miss_rows = np.zeros((U_pad, O_pad), np.float32)
    if problem.pref_rows is not None:
        has = cls_pref >= 0
        pw = min(problem.pref_rows.shape[1], O_pad)
        miss_rows[np.nonzero(has)[0], :pw] = \
            problem.pref_rows[cls_pref[has], :pw]
    item_row = np.zeros(I_pad, np.int32)
    item_row[:total] = np.asarray(class_of_group, np.int32)[order]

    N_cap = min(solver.options.max_nodes,
                bucket(max(total, 1), NODE_BUCKETS))
    N = estimate_nodes(problem, N_cap, NODE_BUCKETS)
    # every placed item contributes at most one COO entry
    K = bucket(total, COO_BUCKETS)
    if N * G_pad >= (1 << 31) - 1:
        cache[key] = _FLAT_UNSUITABLE
        return None
    # slim wire: offerings and per-group counts fit int16, and every
    # pair-packed axis is even
    slim = bool(O_pad < (1 << 15)
                and N % 2 == 0 and N_cap % 2 == 0
                and int(problem.group_count.max()) < (1 << 15))
    tmpl = FlatAttempt(catalog=catalog, item_req=item_req, item_gid=item_gid,
                       item_live=item_live, rows=rows, item_row=item_row,
                       miss_rows=miss_rows, G_pad=G_pad, O_pad=O_pad,
                       I_pad=I_pad, U_pad=U_pad, N=N, N_cap=N_cap, K=K,
                       slim=slim)
    cache[key] = tmpl
    return tmpl


def dispatch_flat(solver, problem: EncodedProblem) -> FlatAttempt | None:
    """Run the flat program and start the result copy; None when the
    window turns out unsuitable (the caller takes the scan path)."""
    tmpl = flat_template(solver, problem)
    if tmpl is None:
        return None
    a = tmpl.clone()
    _dispatch_attempt(solver, a)
    return a


def _device_inputs(solver, tmpl: FlatAttempt):
    """The template's host arrays on the solver's device, uploaded once
    per template and device."""
    cached = tmpl.dev_inputs
    if cached is None or cached[0] != solver.device:
        from karpenter_tpu_torch.solver.torch_backend import upload

        cached = (solver.device, tuple(
            upload(np.ascontiguousarray(x), solver.device)
            for x in (tmpl.item_req, tmpl.item_gid, tmpl.item_live,
                      tmpl.rows, tmpl.item_row, tmpl.miss_rows)))
        tmpl.dev_inputs = cached
    return cached[1]


def _dispatch_attempt(solver, a: FlatAttempt) -> None:
    from karpenter_tpu_torch.solver.torch_backend import start_fetch

    tmpl = a.tmpl if a.tmpl is not None else a
    off_alloc, off_price, off_rank = solver.device_offerings(a.catalog,
                                                             a.O_pad)
    lam_bp = int(solver.options.preference_lambda * 10000)
    a.t_disp = time.perf_counter()
    item_req, item_gid, item_live, rows, item_row, miss_rows = \
        _device_inputs(solver, tmpl)
    out, a.info = flat_solve_torch(
        item_req, item_gid, item_live, rows, item_row, off_alloc, off_rank,
        miss_rows, off_price, I=a.I_pad, O=a.O_pad, G=a.G_pad, N=a.N,
        K=a.K, U=a.U_pad, lam_bp=lam_bp, slim=a.slim)
    a.host, a.event = start_fetch(out)
    a.t_issued = time.perf_counter()


def finalize_flat_arrays(solver, problem: EncodedProblem, a: FlatAttempt):
    """Wait for a flat attempt, escalating the node axis on spill
    (synchronous re-dispatch; spill is rare by construction).  Returns
    (node_off [N], unplaced [G_pad], cost, COO idx, COO cnt)."""
    escalations = 0
    while True:
        if a.event is not None:
            a.event.synchronize()
        out_np = a.host.numpy()
        t_fetch = time.perf_counter()
        N, G_pad, K = a.N, a.G_pad, a.K
        if a.slim:
            node_off = out_np[:N // 2].view(np.int16)
            unplaced = out_np[N // 2:N // 2 + G_pad // 2].view(np.int16)
            base = N // 2 + G_pad // 2
            cost = float(out_np[base:base + 1].view(np.float32)[0])
            idx = out_np[base + 1:base + 1 + K]
            cnt = out_np[base + 1 + K:base + 1 + K + K // 2].view(np.int16)
        else:
            node_off = out_np[:N]
            unplaced = out_np[N:N + G_pad]
            cost = float(out_np[N + G_pad:N + G_pad + 1]
                         .view(np.float32)[0])
            idx = out_np[N + G_pad + 1:N + G_pad + 1 + K]
            cnt = out_np[N + G_pad + 1 + K:N + G_pad + 1 + 2 * K]
        spilled = int(out_np[-1])
        solver.last_stats = {
            "path": f"flat-{solver.device.type}",
            "device": str(solver.device), "wall_s": t_fetch - a.t_disp,
            "dispatch_s": a.t_issued - a.t_disp,
            "exec_fetch_s": t_fetch - a.t_issued,
            "d2h_bytes": int(out_np.nbytes),
            "G": G_pad, "O": a.O_pad, "N": N, "I": a.I_pad, "K": K,
            "U": a.U_pad, "slim": a.slim, "rounds": a.info["rounds"],
            "host_syncs": a.info["host_syncs"], "escalations": escalations}
        if spilled > 0 and a.N < a.N_cap:
            a.N = min(a.N_cap, bucket(a.N * 4, NODE_BUCKETS))
            if a.tmpl is not None:      # later windows start escalated
                a.tmpl.N = max(a.tmpl.N, a.N)
            escalations += 1
            _dispatch_attempt(solver, a)
            continue
        return node_off, unplaced, cost, idx, cnt


def finalize_flat(solver, problem: EncodedProblem, a: FlatAttempt) -> Plan:
    from karpenter_tpu_torch.solver.encode import decode_plan_entries

    node_off, unplaced, cost, idx, cnt = finalize_flat_arrays(
        solver, problem, a)
    t_dec = time.perf_counter()
    live = cnt > 0
    flat_idx = idx[live]
    plan = decode_plan_entries(
        problem, node_off.astype(np.int32), flat_idx % a.G_pad,
        flat_idx // a.G_pad, cnt[live].astype(np.int32), unplaced, cost,
        "torch")
    solver.last_stats["decode_s"] = time.perf_counter() - t_dec
    return plan


def solve_flat(solver, problem: EncodedProblem) -> Plan | None:
    """Synchronous flat solve: dispatch + finalize in one call."""
    a = dispatch_flat(solver, problem)
    if a is None:
        return None
    return finalize_flat(solver, problem, a)
