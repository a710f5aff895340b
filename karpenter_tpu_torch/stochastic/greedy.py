"""Host oracle for the chance-constrained scan: the parity twin.

Port of ``karpenter_tpu/stochastic/greedy.py`` (numpy in both packages,
copied op for op).  Recomputes, with numpy on the host, exactly what
``stochastic/kernel.solve_packed_stochastic`` computes on the device:
node_off / assign / unplaced bit-identical, explain words bit-identical
(base words via the established ``explain/greedy`` oracle, the
overcommit_risk bit via the same fixed-iteration grid search), cost
equal up to float-reduction order.

Bit-identity holds STRUCTURALLY, not by luck: every float op in the
quantile check is a single IEEE-rounded elementwise float32
mul/add/compare in the identical order as the kernel (the shared
``zsq_value`` constant, the shared ``CHANCE_ITERS`` trip count, the
square-compare form with no sqrt and no float reductions).  Change one
side, change both.
"""

from __future__ import annotations

import numpy as np

from karpenter_tpu_torch.solver.types import FIT_BIG as _BIG
from karpenter_tpu_torch.stochastic import CHANCE_FIT_MAX, CHANCE_ITERS, zsq_value


def _fit_counts_np(resid: np.ndarray, req: np.ndarray) -> np.ndarray:
    per_dim = np.where(req[None, :] > 0,
                       resid // np.maximum(req[None, :], 1), _BIG)
    return per_dim.min(axis=1).astype(np.int32)


def chance_fit_np(resid: np.ndarray, var_sum: np.ndarray, mean: np.ndarray,
                  var_f: np.ndarray, zsq: np.float32,
                  hi: np.ndarray) -> np.ndarray:
    """numpy mirror of kernel._chance_fit — same fixed iteration count,
    same float32 op order."""
    lo = np.zeros_like(hi)
    hi = hi.copy()
    for _ in range(CHANCE_ITERS):
        mid = (lo + hi + 1) // 2
        diff = resid - mid[:, None] * mean[None, :]
        diff_f = diff.astype(np.float32)
        lhs = zsq * (var_sum + mid[:, None].astype(np.float32)
                     * var_f[None, :])
        feas = (lhs <= diff_f * diff_f).all(axis=1)
        lo = np.where(feas, mid, lo)
        hi = np.where(feas, hi, mid - 1)
    return lo.astype(np.int32)


def _chance_fit_grid_np(alloc: np.ndarray, mean: np.ndarray,
                        var_f: np.ndarray, zsq: np.float32,
                        kd: np.ndarray) -> np.ndarray:
    """numpy mirror of kernel._chance_fit_grid (closed form in
    sqrt-space + the 4-point monotone correction window, identical
    float32 op order)."""
    A = alloc[None, :, :].astype(np.float32)
    m = mean[:, None, :].astype(np.float32)
    bv = zsq * var_f[:, None, :]
    den = np.sqrt(bv + np.float32(4.0) * m * A) + np.sqrt(bv)
    with np.errstate(divide="ignore", invalid="ignore"):
        s = np.where(den > 0, (np.float32(2.0) * A) / den,
                     np.float32(0.0))
    k_dim = np.where(mean[:, None, :] > 0, np.floor(s * s),
                     np.float32(CHANCE_FIT_MAX))
    k_hat = np.clip(k_dim.min(axis=2).astype(np.int32), 0, kd)
    k0 = np.maximum(k_hat - 2, 0)
    k = k0.copy()
    for j in range(1, 5):
        mid = k0 + j
        diff = alloc[None, :, :] - mid[:, :, None] * mean[:, None, :]
        diff_f = diff.astype(np.float32)
        lhs = zsq * (mid[:, :, None].astype(np.float32)
                     * var_f[:, None, :])
        feas = (mid <= kd) & (lhs <= diff_f * diff_f).all(axis=2)
        k = k + feas.astype(np.int32)
    return k


def risk_words_np(mean: np.ndarray, var: np.ndarray, count: np.ndarray,
                  unplaced: np.ndarray, compat: np.ndarray,
                  off_alloc: np.ndarray, z_bp: int) -> np.ndarray:
    """int32 [G] with only the overcommit_risk bit — the host mirror of
    kernel._risk_words."""
    from karpenter_tpu_torch.explain import BIT

    G = mean.shape[0]
    if G == 0 or off_alloc.shape[0] == 0:
        return np.zeros(G, dtype=np.int32)
    zsq = np.float32(zsq_value(z_bp))
    var_f = var.astype(np.float32)
    per_dim = np.where(mean[:, None, :] > 0,
                       off_alloc[None, :, :]
                       // np.maximum(mean[:, None, :], 1), _BIG)
    kd = np.minimum(per_dim.min(axis=2), CHANCE_FIT_MAX).astype(np.int32)
    kc = _chance_fit_grid_np(off_alloc, mean, var_f, zsq, kd)
    has_var = (var > 0).any(axis=1)
    hit = (compat & (kc < kd)).any(axis=1) & has_var \
        & (np.asarray(count) > 0) & (np.asarray(unplaced) > 0)
    return np.where(hit, np.int32(1 << BIT["overcommit_risk"]),
                    np.int32(0)).astype(np.int32)


def binding_mask_np(mean: np.ndarray, var: np.ndarray,
                    compat: np.ndarray, off_alloc: np.ndarray,
                    z_bp: int) -> np.ndarray:
    """bool [G]: groups whose chance constraint BINDS — the variance
    term shrinks the per-node fit below the deterministic bound
    (kc < kd) on at least one compatible offering, and the group
    carries variance at all.  Host twin of the kernel's telemetry
    binding mask (``kernel.py``: same kd/kc grids that feed the risk
    words), counted into SLOT_BINDING_GROUPS by the telemetry oracle."""
    G = mean.shape[0]
    if G == 0 or off_alloc.shape[0] == 0:
        return np.zeros(G, dtype=bool)
    zsq = np.float32(zsq_value(z_bp))
    per_dim = np.where(mean[:, None, :] > 0,
                       off_alloc[None, :, :]
                       // np.maximum(mean[:, None, :], 1), _BIG)
    kd = np.minimum(per_dim.min(axis=2), CHANCE_FIT_MAX).astype(np.int32)
    kc = _chance_fit_grid_np(off_alloc, mean, var.astype(np.float32),
                             zsq, kd)
    return (compat & (kc < kd)).any(axis=1) & (var > 0).any(axis=1)


def solve_stochastic_host(problem, N: int, z_bp: int,
                          right_size: bool = True):
    """Run the chance-constrained FFD on the host.

    Returns ``(node_off [N], assign [G, N], unplaced [G], cost, words
    [G])`` — the first four bit-identical to the device kernel's packed
    result (cost up to reduction order), the words identical to the
    device's appended reason words.  ``problem`` is an EncodedProblem
    with the stochastic tensors attached (group_mean / group_var)."""
    G = problem.num_groups
    catalog = problem.catalog
    off_alloc = catalog.offering_alloc().astype(np.int32)
    off_price = catalog.off_price.astype(np.float32)
    off_rank = catalog.offering_rank_price().astype(np.float32)
    zsq = np.float32(zsq_value(z_bp))
    compat = np.ascontiguousarray(problem.compat, dtype=bool)
    mean_g = problem.group_mean.astype(np.int32)
    var_g = problem.group_var.astype(np.int32)
    count_g = problem.group_count.astype(np.int32)
    cap_g = problem.group_cap.astype(np.int32)

    R = off_alloc.shape[1]
    # the empty-offering fit grids, once per solve — the mirror of
    # kernel._empty_fit_grids (kc feeds the new-node branch, kd/kc
    # together feed the risk words)
    per_dim = np.where(mean_g[:, None, :] > 0,
                       off_alloc[None, :, :]
                       // np.maximum(mean_g[:, None, :], 1), _BIG)
    kd_grid = np.minimum(per_dim.min(axis=2),
                         CHANCE_FIT_MAX).astype(np.int32)
    kc_grid = _chance_fit_grid_np(off_alloc, mean_g,
                                  var_g.astype(np.float32), zsq, kd_grid)
    node_off = np.full(N, -1, dtype=np.int32)
    node_resid = np.zeros((N, R), dtype=np.int32)
    node_var = np.zeros((N, R), dtype=np.float32)
    ptr = 0
    assign = np.zeros((G, N), dtype=np.int32)
    unplaced = np.zeros(G, dtype=np.int32)

    for gi in range(G):
        mean = mean_g[gi]
        var_f = var_g[gi].astype(np.float32)
        count = int(count_g[gi])
        cap = int(cap_g[gi])
        compat_g = compat[gi]

        is_open = node_off >= 0
        node_compat = np.where(is_open, compat_g[np.clip(node_off, 0, None)],
                               False)
        hi = np.minimum(_fit_counts_np(node_resid, mean),
                        np.int32(CHANCE_FIT_MAX))
        fit = chance_fit_np(node_resid, node_var, mean, var_f, zsq, hi)
        fit = np.where(node_compat, fit, 0)
        fit = np.minimum(fit, cap)
        cumfit = np.cumsum(fit) - fit
        take = np.clip(count - cumfit, 0, fit).astype(np.int32)
        placed = int(take.sum())
        node_resid = node_resid - take[:, None] * mean[None, :]
        node_var = node_var + take[:, None].astype(np.float32) \
            * var_f[None, :]
        rem = count - placed

        fit_empty = np.where(compat_g, kc_grid[gi], 0)
        fit_empty = np.minimum(fit_empty, cap)
        fit_empty = np.minimum(fit_empty, rem)
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
                              - pods_new[:, None] * mean[None, :],
                              node_resid)
        node_var = np.where(opened[:, None],
                            pods_new[:, None].astype(np.float32)
                            * var_f[None, :],
                            node_var)
        ptr += int(opened.sum())
        unplaced[gi] = rem - int(pods_new.sum())
        assign[gi] = take + pods_new

    if right_size and G:
        load_mean = off_alloc[np.clip(node_off, 0, None)] - node_resid
        node_off = _right_size_np(node_off, load_mean, node_var, assign,
                                  compat, off_alloc, off_rank, zsq)
    is_open = node_off >= 0
    # the cost word in numpy's order, as the reference's oracle sums it
    # (the device's word follows solver/cost_sum.py)
    cost = float(np.where(
        is_open, off_price[np.clip(node_off, 0, None)],
        np.float32(0.0)).sum())
    from karpenter_tpu_torch.explain.greedy import reason_words

    # reason_words already folds the overcommit_risk bit for stochastic
    # problems (via risk_words_np) — no second grid build here
    words = reason_words(problem, unplaced)
    return node_off, assign, unplaced, cost, words


def _right_size_np(node_off, load_mean, load_var, assign, compat,
                   off_alloc, off_rank, zsq):
    """numpy mirror of kernel._right_size_stochastic."""
    N = node_off.shape[0]
    is_open = node_off >= 0
    safe_off = np.clip(node_off, 0, None)
    present = (assign > 0).astype(np.float32)
    incompat = (~compat).astype(np.float32)
    incompat_count = np.einsum("gn,go->no", present, incompat)
    all_compat = incompat_count < 0.5
    diff = off_alloc[None, :, :] - load_mean[:, None, :]
    diff_f = diff.astype(np.float32)
    chance_ok = ((diff >= 0)
                 & (zsq * load_var[:, None, :] <= diff_f * diff_f)
                 ).all(axis=2)
    candidate = all_compat & chance_ok & is_open[:, None]
    rank_eff = np.broadcast_to(off_rank[None, :], (N, off_rank.shape[0]))
    cand_price = np.where(candidate, rank_eff, np.inf)
    best = cand_price.argmin(axis=1).astype(np.int32)
    best_price = cand_price.min(axis=1)
    cur_price = np.take_along_axis(rank_eff, safe_off[:, None],
                                   axis=1)[:, 0]
    improve = is_open & (best_price < cur_price - np.float32(1e-9))
    return np.where(improve, best, node_off).astype(np.int32)
