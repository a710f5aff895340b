"""The affinity-gated FFD scan, in PyTorch ops on the device.

Port of ``karpenter_tpu/affinity/kernel.py``.  One packed problem buffer
plus the affinity leaf (``affinity/encode.pack_affinity``) in, one
packed result buffer out, in the layout of ``solve_packed_torch``.  The
scan carries three more pieces of per-node state:

    node_sel   int32 [N]        bitmask of selector classes present
    node_anti  int32 [N]        union of the anti masks of its groups
    node_cnt   int32 [N, C_PAD] per-class pod counts

and gates every fill with them:

    anti ok    (node_sel & g_anti) == 0 and (node_anti & g_sel) == 0
    req ok     (g_req & ~node_sel) == 0
    spread     fit clipped to min over the group's bounded classes of
               (bound_c - node_cnt[n, c])

A group whose own labels do not satisfy its required classes never opens
a node (``can_open``), and a new node takes at most the group's tightest
class bound.  Every gate is int32 bit arithmetic; the float terms are
the deterministic scan's.  On the card every op is its own launch, about
50 per group step.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.affinity import AFF_BIG, C_PAD
from karpenter_tpu_torch.apis.pod import NUM_RESOURCES
from karpenter_tpu_torch.explain import BIT
from karpenter_tpu_torch.solver.cost_sum import cost_sum
from karpenter_tpu_torch.solver.ffd_kernel import _fit_counts, open_nodes
from karpenter_tpu_torch.solver.packed import (
    pack_result_telemetry, right_size as _right_size, unpack_problem,
)

I32 = torch.int32
F32 = torch.float32


def _spread_allowance(node_cnt, member, bounds):
    """int32 [N]: how many more pods of a group whose member classes are
    ``member`` ([C] 0/1) each node admits under the per-class bounds —
    AFF_BIG when no member class is bounded."""
    live = (member[None, :] > 0) & (bounds[None, :] < AFF_BIG)
    room = torch.where(live, bounds[None, :] - node_cnt, AFF_BIG)
    return room.min(dim=1).values


def _affinity_scan(req, count, cap, compat, g_sel, g_anti, g_req, bounds,
                   off_alloc, off_rank, N: int):
    """The scan over the G groups, step for step the reference's
    ``_ffd_step_affinity``.  Returns (node_off [N], node_resid [N, R],
    assign [G, N], unplaced [G])."""
    dev = req.device
    G = req.shape[0]
    node_off = torch.full((N,), -1, dtype=I32, device=dev)
    node_resid = torch.zeros((N, NUM_RESOURCES), dtype=I32, device=dev)
    node_sel = torch.zeros((N,), dtype=I32, device=dev)
    node_anti = torch.zeros((N,), dtype=I32, device=dev)
    node_cnt = torch.zeros((N, C_PAD), dtype=I32, device=dev)
    ptr = torch.zeros((), dtype=I32, device=dev)
    idx = torch.arange(N, dtype=I32, device=dev)
    shifts = torch.arange(C_PAD, dtype=I32, device=dev)
    assign = torch.empty((G, N), dtype=I32, device=dev)
    unplaced = torch.empty((G,), dtype=I32, device=dev)
    # per-group class membership [G, C] 0/1 and new-node bound [G],
    # neither depends on node state
    members = (g_sel[:, None] >> shifts[None, :]) & 1
    bound_new = torch.where((members > 0) & (bounds[None, :] < AFF_BIG),
                            bounds[None, :], AFF_BIG).min(dim=1).values
    can_open = (g_req & ~g_sel) == 0
    for g in range(G):
        req_g, compat_g, member = req[g], compat[g], members[g]
        sel, anti = g_sel[g], g_anti[g]
        is_open = node_off >= 0
        node_compat = torch.where(
            is_open, compat_g[torch.clamp(node_off, min=0).long()], False)
        # ---- fill open nodes, first-fit in age order ------------------
        fit = _fit_counts(node_resid, req_g)
        fit = torch.where(node_compat, fit, 0)
        fit = torch.minimum(fit, cap[g])
        ok_anti = ((node_sel & anti) == 0) & ((node_anti & sel) == 0)
        ok_req = (g_req[g] & ~node_sel) == 0
        fit = torch.where(ok_anti & ok_req, fit, 0)
        allow = _spread_allowance(node_cnt, member, bounds)
        fit = torch.minimum(fit, torch.clamp(allow, min=0))
        cumfit = torch.cumsum(fit, 0).to(I32) - fit
        take = torch.minimum(torch.clamp(count[g] - cumfit, min=0), fit)
        placed = take.sum().to(I32)
        node_resid = node_resid - take[:, None] * req_g[None, :]
        node_cnt = node_cnt + take[:, None] * member[None, :]
        took = take > 0
        node_sel = torch.where(took, node_sel | sel, node_sel)
        node_anti = torch.where(took, node_anti | anti, node_anti)
        rem = count[g] - placed
        # ---- open new nodes with the cheapest-per-pod offering --------
        fit_e = _fit_counts(off_alloc, req_g)
        fit_e = torch.where(compat_g, fit_e, 0)
        fit_e = torch.minimum(fit_e, cap[g])
        fit_e = torch.minimum(fit_e, rem)
        fit_e = torch.where(can_open[g], fit_e, 0)
        fit_e = torch.minimum(fit_e, bound_new[g])
        cpp = torch.where(fit_e > 0, off_rank / fit_e.to(F32),
                          float("inf"))
        best = torch.argmin(cpp)                    # first index on ties
        bf = fit_e[best]
        pods_new, opened = open_nodes(rem, bf, ptr, idx)
        node_off = torch.where(opened, best.to(I32), node_off)
        node_resid = torch.where(
            opened[:, None],
            off_alloc[best][None, :] - pods_new[:, None] * req_g[None, :],
            node_resid)
        node_cnt = torch.where(opened[:, None],
                               pods_new[:, None] * member[None, :], node_cnt)
        node_sel = torch.where(opened, sel, node_sel)
        node_anti = torch.where(opened, anti, node_anti)
        ptr = (ptr + opened.sum()).to(I32)
        unplaced[g] = rem - pods_new.sum().to(I32)
        assign[g] = take + pods_new
    return node_off, node_resid, assign, unplaced


def _affinity_words(aff_flag, spread_flag, count, unplaced):
    """int32 [G] with the two affinity reason bits of a live unplaced
    group that carries (or is targeted by) an armed edge / a bounded
    spread class."""
    live_un = (count > 0) & (unplaced > 0)
    bits = torch.where(live_un & (aff_flag > 0),
                       1 << BIT["affinity_unsatisfied"], 0)
    bits = bits | torch.where(live_un & (spread_flag > 0),
                              1 << BIT["spread_bound"], 0)
    return bits.to(I32)


def solve_packed_affinity(packed, aff, off_alloc, off_price, off_rank, *,
                          G: int, O: int, U: int, N: int,
                          right_size: bool = True, compact: int = 0,
                          dense16: bool = False,
                          coo16: bool = False) -> torch.Tensor:
    """Packed-I/O affinity-gated solve on the device the inputs lie on:
    the problem buffer of ``solve_packed_torch`` and the affinity leaf
    ``aff`` -> the packed result buffer (explain words with the affinity
    bits, telemetry with the binding-groups slot)."""
    meta, compat_i, rows_g = unpack_problem(packed, off_alloc, G, O, U)
    g_sel, g_anti, g_req = aff[:G], aff[G:2 * G], aff[2 * G:3 * G]
    aff_flag, spread_flag = aff[3 * G:4 * G], aff[4 * G:5 * G]
    bounds = aff[5 * G:5 * G + C_PAD]
    compat = compat_i > 0
    count, cap = meta[:, 4], meta[:, 5]
    node_off, node_resid, assign, unplaced = _affinity_scan(
        meta[:, :4], count, cap, compat, g_sel, g_anti, g_req, bounds,
        off_alloc, off_rank, N)
    if right_size:
        load = off_alloc[torch.clamp(node_off, min=0).long()] - node_resid
        node_off = _right_size(node_off, load, assign, compat, off_alloc,
                               off_rank)
    is_open = node_off >= 0
    prices = off_price[torch.clamp(node_off, min=0).long()]
    cost = cost_sum(torch.where(is_open, prices, torch.zeros_like(prices)))
    return pack_result_telemetry(
        meta, rows_g, compat_i, node_off, assign, unplaced, cost, off_alloc,
        compact, dense16, coo16,
        extra_words=_affinity_words(aff_flag, spread_flag, count, unplaced),
        binding=(aff_flag | spread_flag) > 0)
