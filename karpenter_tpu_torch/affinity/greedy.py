"""Host oracle for the affinity-gated scan: the parity twin.

Port of ``karpenter_tpu/affinity/greedy.py`` (numpy in both packages,
copied op for op).  Recomputes, with numpy on the host, exactly what
``affinity/kernel.solve_packed_affinity`` computes on device: node_off
/ assign / unplaced bit-identical, explain words bit-identical (base
words via the established ``explain/greedy`` oracle, the two affinity
bits via the same flag test), cost equal up to float-reduction order.

Bit-identity holds STRUCTURALLY: every affinity gate is exact int32
arithmetic in the identical order as the kernel — shared ``AFF_BIG``
sentinel, shared ``C_PAD`` class width, no float enters the affinity
terms at all.  Change one side, change both.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.affinity import AFF_BIG, C_PAD
from karpenter_tpu_torch.solver.types import FIT_BIG as _BIG


def _fit_counts_np(resid: np.ndarray, req: np.ndarray) -> np.ndarray:
    per_dim = np.where(req[None, :] > 0,
                       resid // np.maximum(req[None, :], 1), _BIG)
    return per_dim.min(axis=1).astype(np.int32)


def spread_allowance_np(node_cnt: np.ndarray, member: np.ndarray,
                        bounds: np.ndarray) -> np.ndarray:
    """numpy mirror of kernel._spread_allowance."""
    live = (member[None, :] > 0) & (bounds[None, :] < AFF_BIG)
    room = np.where(live, bounds[None, :] - node_cnt, AFF_BIG)
    return room.min(axis=1).astype(np.int32)


def affinity_words_np(problem, unplaced) -> np.ndarray:
    """int32 [G] with only the two affinity reason bits — the host
    mirror of kernel._affinity_words, consumed by
    explain/greedy.reason_words for every affinity-armed problem."""
    from karpenter_tpu_torch.explain import BIT

    aff = getattr(problem, "aff", None)
    G = problem.num_groups
    if aff is None or G == 0:
        return np.zeros(G, dtype=np.int32)
    count = np.asarray(problem.group_count, dtype=np.int64)
    un = np.asarray(unplaced, dtype=np.int64)
    live_un = (count > 0) & (un > 0)
    bits = np.where(live_un & (aff.aff_flag > 0),
                    np.int32(1 << BIT["affinity_unsatisfied"]),
                    np.int32(0))
    bits = bits | np.where(live_un & (aff.spread_flag > 0),
                           np.int32(1 << BIT["spread_bound"]),
                           np.int32(0))
    return bits.astype(np.int32)


def solve_affinity_host(problem, N: int, right_size: bool = True):
    """Run the affinity-gated FFD on the host.

    Returns ``(node_off [N], assign [G, N], unplaced [G], cost, words
    [G])`` — the first four bit-identical to the device kernel's packed
    result (cost up to reduction order), the words identical to the
    device's appended reason words.  ``problem`` is an EncodedProblem
    with the affinity index attached (``problem.aff``)."""
    G = problem.num_groups
    catalog = problem.catalog
    off_alloc = catalog.offering_alloc().astype(np.int32)
    off_price = catalog.off_price.astype(np.float32)
    off_rank = catalog.offering_rank_price().astype(np.float32)
    compat = np.ascontiguousarray(problem.compat, dtype=bool)
    req_g = problem.group_req.astype(np.int32)
    count_g = problem.group_count.astype(np.int32)
    cap_g = np.minimum(problem.group_cap,
                       np.iinfo(np.int32).max).astype(np.int32)
    aff = problem.aff
    g_sel = aff.g_sel
    g_anti = aff.g_anti
    g_req = aff.g_req
    bounds = aff.bounds

    R = off_alloc.shape[1]
    node_off = np.full(N, -1, dtype=np.int32)
    node_resid = np.zeros((N, R), dtype=np.int32)
    node_sel = np.zeros(N, dtype=np.int32)
    node_anti = np.zeros(N, dtype=np.int32)
    node_cnt = np.zeros((N, C_PAD), dtype=np.int32)
    ptr = 0
    assign = np.zeros((G, N), dtype=np.int32)
    unplaced = np.zeros(G, dtype=np.int32)

    for gi in range(G):
        req = req_g[gi]
        count = int(count_g[gi])
        cap = int(cap_g[gi])
        compat_g = compat[gi]
        sel, anti, reqm = int(g_sel[gi]), int(g_anti[gi]), int(g_req[gi])
        member = ((sel >> np.arange(C_PAD, dtype=np.int32)) & 1) \
            .astype(np.int32)

        is_open = node_off >= 0
        node_compat = np.where(is_open,
                               compat_g[np.clip(node_off, 0, None)], False)
        fit = _fit_counts_np(node_resid, req)
        fit = np.where(node_compat, fit, 0)
        fit = np.minimum(fit, cap)
        ok_anti = ((node_sel & anti) == 0) & ((node_anti & sel) == 0)
        ok_req = (reqm & ~node_sel) == 0
        fit = np.where(ok_anti & ok_req, fit, 0)
        allow = spread_allowance_np(node_cnt, member, bounds)
        fit = np.minimum(fit, np.clip(allow, 0, None))
        cumfit = np.cumsum(fit) - fit
        take = np.clip(count - cumfit, 0, fit).astype(np.int32)
        placed = int(take.sum())
        node_resid = node_resid - take[:, None] * req[None, :]
        node_cnt = node_cnt + take[:, None] * member[None, :]
        node_sel = np.where(take > 0, node_sel | sel,
                            node_sel).astype(np.int32)
        node_anti = np.where(take > 0, node_anti | anti,
                             node_anti).astype(np.int32)
        rem = count - placed

        can_open = (reqm & ~sel) == 0
        bound_new = int(np.min(np.where((member > 0) & (bounds < AFF_BIG),
                                        bounds, AFF_BIG)))
        fit_empty = _fit_counts_np(off_alloc, req)
        fit_empty = np.where(compat_g, fit_empty, 0)
        fit_empty = np.minimum(fit_empty, cap)
        fit_empty = np.minimum(fit_empty, rem)
        fit_empty = np.where(can_open, fit_empty, 0)
        fit_empty = np.minimum(fit_empty, bound_new)
        with np.errstate(divide="ignore", invalid="ignore"):
            cpp = np.where(fit_empty > 0,
                           off_rank / fit_empty.astype(np.float32), np.inf)
        best = int(np.argmin(cpp))
        bf = int(fit_empty[best])

        n_new = -(-rem // max(bf, 1)) if bf > 0 else 0
        n_new = min(n_new, N - ptr)
        new_pos = np.arange(N, dtype=np.int32) - ptr
        is_new = (new_pos >= 0) & (new_pos < n_new)
        pods_new = np.where(is_new, np.clip(rem - new_pos * bf, 0, bf),
                            0).astype(np.int32)
        opened = is_new & (pods_new > 0)
        node_off = np.where(opened, best, node_off).astype(np.int32)
        node_resid = np.where(opened[:, None],
                              off_alloc[best][None, :]
                              - pods_new[:, None] * req[None, :],
                              node_resid)
        node_cnt = np.where(opened[:, None],
                            pods_new[:, None] * member[None, :], node_cnt)
        node_sel = np.where(opened, sel, node_sel).astype(np.int32)
        node_anti = np.where(opened, anti, node_anti).astype(np.int32)
        ptr += int(opened.sum())
        unplaced[gi] = rem - int(pods_new.sum())
        assign[gi] = take + pods_new

    if right_size and G:
        load = off_alloc[np.clip(node_off, 0, None)] - node_resid
        node_off = _right_size_np(node_off, load, assign, compat,
                                  off_alloc, off_rank)
    is_open = node_off >= 0
    # the cost word in numpy's order, as the reference's oracle sums it
    # (the device's word follows solver/cost_sum.py)
    cost = float(np.where(
        is_open, off_price[np.clip(node_off, 0, None)],
        np.float32(0.0)).sum())
    from karpenter_tpu_torch.explain.greedy import reason_words

    # reason_words already folds the two affinity bits for armed
    # problems (via affinity_words_np) — no second flag pass here
    words = reason_words(problem, unplaced)
    return node_off, assign, unplaced, cost, words


def _right_size_np(node_off, load, assign, compat, off_alloc, off_rank):
    """numpy mirror of kernel._right_size_affinity."""
    N = node_off.shape[0]
    is_open = node_off >= 0
    safe_off = np.clip(node_off, 0, None)
    present = (assign > 0).astype(np.float32)
    incompat = (~compat).astype(np.float32)
    incompat_count = np.einsum("gn,go->no", present, incompat)
    all_compat = incompat_count < 0.5
    fits = (off_alloc[None, :, :] >= load[:, None, :]).all(axis=2)
    candidate = all_compat & fits & is_open[:, None]
    rank_eff = np.broadcast_to(off_rank[None, :], (N, off_rank.shape[0]))
    cand_price = np.where(candidate, rank_eff, np.inf)
    best = cand_price.argmin(axis=1).astype(np.int32)
    best_price = cand_price.min(axis=1)
    cur_price = np.take_along_axis(rank_eff, safe_off[:, None],
                                   axis=1)[:, 0]
    improve = is_open & (best_price < cur_price - np.float32(1e-9))
    return np.where(improve, best, node_off).astype(np.int32)
