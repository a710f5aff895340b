"""Numpy oracle of the stacked scenario solve (port of
``karpenter_tpu/whatif/oracle.py``, a copy of its own).

Recomputes on the host, with numpy, what ``kernels.solve_scenarios``
computes on the device for each scenario: the delta-apply, the unpack,
the FFD scan, the right-size and the packed result with its explain
words and telemetry block, all word for word except the float32 cost
word, which numpy sums in its own order (``words_equal_except_cost``).
Integer ops mirror the device's, float comparisons use the same single
IEEE-rounded float32 operations in the same order (the ranking divide,
the 1e-9 right-size hysteresis), and argmin ties go to the first index
on both sides.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.explain import (
    BIT, DEFICIT_CLIP, DEFICIT_MASKED, RESOURCE_BITS,
)
from karpenter_tpu_torch.obs.telemetry_words import telemetry_words_np
from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2
# the fit sentinel of the device scan (solver/ffd_kernel.py)
from karpenter_tpu_torch.solver.types import FIT_BIG as _BIG


def unpack_problem_np(packed: np.ndarray, off_alloc: np.ndarray,
                      G: int, O: int, U: int):
    """numpy mirror of ``solver/packed.unpack_problem``: (meta [G,8], compat
    [G,O] 0/1, label rows_g [G,O] 0/1)."""
    meta = packed[:G * 8].reshape(G, 8)
    cw = packed[G * 8:].reshape(U, O // 32)
    b = (cw[:, :, None] >> np.arange(32, dtype=np.int32)[None, None, :]) & 1
    rows = b.reshape(U, O).astype(np.int32)
    rows_g = rows[np.clip(meta[:, 6], 0, U - 1)]
    fit = (off_alloc[None, :, :] >= meta[:, None, :4]).all(axis=2)
    return meta, rows_g * fit.astype(np.int32), rows_g


def _fit_counts_np(resid: np.ndarray, req: np.ndarray) -> np.ndarray:
    per_dim = np.where(req[None, :] > 0,
                       resid // np.maximum(req[None, :], 1), _BIG)
    return per_dim.min(axis=1).astype(np.int32)


def solve_core_np(meta: np.ndarray, compat_i: np.ndarray,
                  off_alloc: np.ndarray, off_price: np.ndarray,
                  off_rank: np.ndarray, N: int,
                  right_size: bool = True):
    """numpy mirror of the deterministic ``solve_core`` (the scan over
    ``_ffd_step`` + ``_right_size``): returns ``(node_off [N], assign
    [G,N], unplaced [G], cost)`` with the first three integer-exact."""
    G = meta.shape[0]
    R = 4
    compat = compat_i > 0
    node_off = np.full(N, -1, dtype=np.int32)
    node_resid = np.zeros((N, R), dtype=np.int32)
    ptr = 0
    assign = np.zeros((G, N), dtype=np.int32)
    unplaced = np.zeros(G, dtype=np.int32)
    idx_n = np.arange(N, dtype=np.int32)
    for gi in range(G):
        req = meta[gi, :4]
        count = int(meta[gi, 4])
        cap = int(meta[gi, 5])
        compat_g = compat[gi]

        is_open = node_off >= 0
        node_compat = np.where(is_open,
                               compat_g[np.clip(node_off, 0, None)], False)
        fit = _fit_counts_np(node_resid, req)
        fit = np.where(node_compat, fit, 0)
        fit = np.minimum(fit, cap)
        cumfit = np.cumsum(fit) - fit
        take = np.clip(count - cumfit, 0, fit).astype(np.int32)
        placed = int(take.sum())
        node_resid = node_resid - take[:, None] * req[None, :]
        rem = count - placed

        fit_empty = _fit_counts_np(off_alloc, req)
        fit_empty = np.where(compat_g, fit_empty, 0)
        fit_empty = np.minimum(fit_empty, cap)
        fit_empty = np.minimum(fit_empty, rem)
        with np.errstate(divide="ignore", invalid="ignore"):
            cpp = np.where(fit_empty > 0,
                           off_rank / fit_empty.astype(np.float32),
                           np.float32(np.inf))
        best = int(np.argmin(cpp))
        bf = int(fit_empty[best])

        n_new = -(-rem // max(bf, 1)) if bf > 0 else 0
        n_new = min(n_new, N - ptr)
        new_pos = idx_n - ptr
        is_new = (new_pos >= 0) & (new_pos < n_new)
        pods_new = np.where(is_new, np.clip(rem - new_pos * bf, 0, bf),
                            0).astype(np.int32)
        opened = is_new & (pods_new > 0)
        node_off = np.where(opened, best, node_off).astype(np.int32)
        node_resid = np.where(
            opened[:, None],
            off_alloc[best][None, :] - pods_new[:, None] * req[None, :],
            node_resid)
        ptr += int(opened.sum())
        unplaced[gi] = rem - int(pods_new.sum())
        assign[gi] = take + pods_new

    if right_size and G:
        node_off = _right_size_np(node_off, node_resid, assign, compat,
                                  off_alloc, off_rank)
    is_open = node_off >= 0
    # the cost word: numpy's sum, equal to the device's only up to the
    # order of the adds (words_equal_except_cost)
    cost = float(np.where(
        is_open, off_price[np.clip(node_off, 0, None)],
        np.float32(0.0)).sum())
    return node_off, assign, unplaced, cost


def _right_size_np(node_off, node_resid, assign, compat, off_alloc,
                   off_rank):
    """numpy mirror of ``solver/packed.right_size`` (deterministic form):
    cheapest compatible offering that fits each node's final load.  The
    einsum is integer-valued float32 math (0/1 presence counts), so
    reduction order cannot change the result."""
    N = node_off.shape[0]
    is_open = node_off >= 0
    safe_off = np.clip(node_off, 0, None)
    load = off_alloc[safe_off] - node_resid
    present = (assign > 0).astype(np.float32)
    incompat = (~compat).astype(np.float32)
    incompat_count = np.einsum("gn,go->no", present, incompat)
    all_compat = incompat_count < 0.5
    fits = (off_alloc[None, :, :] >= load[:, None, :]).all(axis=2)
    candidate = all_compat & fits & is_open[:, None]
    rank_eff = np.broadcast_to(off_rank[None, :], (N, off_rank.shape[0]))
    cand_price = np.where(candidate, rank_eff, np.float32(np.inf))
    best = cand_price.argmin(axis=1).astype(np.int32)
    best_price = cand_price.min(axis=1)
    cur_price = np.take_along_axis(rank_eff, safe_off[:, None],
                                   axis=1)[:, 0]
    improve = is_open & (best_price < cur_price - np.float32(1e-9))
    return np.where(improve, best, node_off).astype(np.int32)


def explain_words_np(meta, rows_g, compat_i, unplaced, off_alloc):
    """numpy mirror of ``solver/packed.explain_words`` at the word level
    (the packed-buffer form; explain/greedy.reason_words is the
    EncodedProblem form of the same reduction)."""
    G = meta.shape[0]
    req = meta[:, :4]
    count = meta[:, 4]
    prio = meta[:, 7]
    lbl = rows_g > 0
    compat = compat_i > 0
    has_label = lbl.any(axis=1)
    has_fit = compat.any(axis=1)
    per_dim = np.minimum(
        np.maximum(req[:, None, :] - off_alloc[None, :, :], 0),
        DEFICIT_CLIP)
    deficit = per_dim.sum(axis=2, dtype=np.int32)
    masked = np.where(lbl, deficit, DEFICIT_MASKED)
    nearest = masked.argmin(axis=1)
    near_alloc = off_alloc[nearest]
    insufficient = has_label & ~has_fit
    bits = np.zeros(G, dtype=np.int32)
    for r, bit_name in enumerate(RESOURCE_BITS):
        hit = insufficient & (req[:, r] > near_alloc[:, r])
        bits = bits | np.where(hit, np.int32(1 << BIT[bit_name]),
                               np.int32(0))
    bits = bits | np.where(~has_label,
                           np.int32(1 << BIT["requirements"]), np.int32(0))
    bits = bits | np.where(has_fit,
                           np.int32(1 << BIT["capacity_exhausted"]),
                           np.int32(0))
    placed = (count - unplaced) > 0
    int_min = np.iinfo(np.int32).min
    max_placed_prio = np.where(compat & placed[:, None], prio[:, None],
                               int_min).max(axis=0)
    cap_hp = (compat & (max_placed_prio[None, :] > prio[:, None])
              ).any(axis=1) & has_fit
    bits = bits | np.where(cap_hp,
                           np.int32(1 << BIT["capacity_higher_prio"]),
                           np.int32(0))
    live_un = (count > 0) & (unplaced > 0)
    return np.where(live_un, bits, 0).astype(np.int32)


def compact_assign_np(assign: np.ndarray, K: int):
    """numpy mirror of ``solver/packed.compact_assign`` (n-major COO)."""
    flat = assign.T.reshape(-1)
    mask = flat > 0
    pos = np.cumsum(mask.astype(np.int32)) - 1
    tgt = np.where(mask, pos, K)
    src = np.arange(flat.shape[0], dtype=np.int32)
    idx = np.zeros(K, dtype=np.int32)
    cnt = np.zeros(K, dtype=np.int32)
    valid = tgt < K
    idx[tgt[valid]] = src[valid]
    cnt[tgt[valid]] = flat[valid]
    return idx, cnt


def pack_result_np(node_off, assign, unplaced, cost, words, telemetry,
                   K: int, dense16: bool = False,
                   coo16: bool = False) -> np.ndarray:
    """numpy mirror of ``solver/packed.pack_result`` + the reason words (the
    dense16 pair packing mirrors ``solver/packed.pack16_pairs``) + the
    telemetry block (obs/telemetry_words.telemetry_words_np, the full
    magic-word-led block) — every oracle buffer carries the identical
    v1 suffix the device finisher emits (solver/result_layout.py)."""
    cost_i = np.asarray([cost], dtype=np.float32).view(np.int32)
    if K > 0:
        idx, cnt = compact_assign_np(assign.astype(np.int32), K)
        tail = [(idx << 16) | cnt] if coo16 else [idx, cnt]
    elif dense16:
        pairs = assign.astype(np.int32).reshape(-1, 2)
        tail = [(pairs[:, 0] & 0xFFFF) | (pairs[:, 1] << 16)]
    else:
        tail = [assign.astype(np.int32).reshape(-1)]
    return np.concatenate([node_off.astype(np.int32),
                           unplaced.astype(np.int32), cost_i]
                          + tail + [words.astype(np.int32),
                                    telemetry.astype(np.int32)])


def solve_packed_np(packed: np.ndarray, off_alloc, off_price, off_rank, *,
                    G: int, O: int, U: int, N: int,
                    right_size: bool = True, compact: int = 0,
                    dense16: bool = False, coo16: bool = False
                    ) -> np.ndarray:
    """One scenario's full packed result buffer, from the host — the
    scenario-at-a-time body of the oracle (``WhatIfPlanner.plan_host``)."""
    off_alloc = np.asarray(off_alloc, dtype=np.int32)
    off_price = np.asarray(off_price, dtype=np.float32)
    off_rank = np.asarray(off_rank, dtype=np.float32)
    meta, compat_i, rows_g = unpack_problem_np(packed, off_alloc, G, O, U)
    node_off, assign, unplaced, cost = solve_core_np(
        meta, compat_i, off_alloc, off_price, off_rank, N,
        right_size=right_size)
    words = explain_words_np(meta, rows_g, compat_i,
                             unplaced.astype(np.int32), off_alloc)
    telemetry = telemetry_words_np(meta, node_off, assign,
                                   unplaced.astype(np.int32), off_alloc)
    return pack_result_np(node_off, assign, unplaced, cost, words,
                          telemetry, compact, dense16, coo16)


def solve_scenarios_np(baseline, stacked, *, N: int,
                       right_size: bool = True, compact: int = 0,
                       dense16: bool = False, coo16: bool = False
                       ) -> np.ndarray:
    """The stacked oracle: apply each scenario's padded delta to a host
    copy of the baseline (drop-index rows ignored, exactly like the
    device scatter) and solve scenario-at-a-time.  Returns [K, Lo]."""
    catalog = baseline.catalog
    alloc = _pad2(catalog.offering_alloc().astype(np.int32),
                  baseline.O_pad)
    price = _pad1(catalog.off_price.astype(np.float32), baseline.O_pad)
    rank = _pad1(catalog.offering_rank_price(), baseline.O_pad)
    outs = []
    L = baseline.L
    for k in range(stacked.K):
        buf = baseline.packed.copy()
        live = stacked.didx[k] < L
        buf[stacked.didx[k][live]] = stacked.dval[k][live]
        outs.append(solve_packed_np(
            buf, alloc, price, rank,
            G=baseline.G_pad, O=baseline.O_pad, U=baseline.U_pad, N=N,
            right_size=right_size, compact=compact, dense16=dense16,
            coo16=coo16))
    return np.stack(outs)


def cost_word_index(G: int, N: int) -> int:
    """Offset of the single float32 cost word in a packed result — the
    one word the oracle matches only up to reduction order."""
    return N + G


def words_equal_except_cost(a: np.ndarray, b: np.ndarray, G: int, N: int,
                            rtol: float = 1e-5) -> bool:
    """Bit-equality on every word but the cost word; the cost floats
    must still agree to ``rtol``."""
    ci = cost_word_index(G, N)
    if a.shape != b.shape:
        return False
    mask = np.ones(a.shape[0], dtype=bool)
    mask[ci] = False
    if not np.array_equal(a[mask], b[mask]):
        return False
    ca = float(a[ci:ci + 1].view(np.float32)[0])
    cb = float(b[ci:ci + 1].view(np.float32)[0])
    return bool(np.isclose(ca, cb, rtol=rtol, atol=1e-4))
