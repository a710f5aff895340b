"""The chance-constrained FFD scan, in PyTorch ops on the device.

Port of ``karpenter_tpu/stochastic/kernel.py``.  One packed problem
buffer plus the mean/var leaf (``stochastic/encode.pack_stochastic``) in,
one packed result buffer out, in the layout of ``solve_packed_torch``.
The only change from the deterministic scan is the fit count: capacity
is consumed by MEAN, and a fit on an open node passes the quantile check

    zsq * (node_var + k * var) <= (resid_mean - k * mean)^2   per dim

resolved by a fixed ``CHANCE_ITERS``-step integer binary search.  The
empty-node fits ``kc`` (and the deterministic mean fits ``kd``) are
per-problem constants built once by :func:`build_fit_grids`.

Parity with the reference rests on every float op being one IEEE-rounded
elementwise op in the reference's order: each is a separate PyTorch op
here (eager mode never fuses a multiply into an add), ``zsq`` is the
float32 value both sides share, nothing is compiled, and integers stay
int32 where the reference's are (``mid * mean`` wraps as it does).
On the card every op is its own launch: a step is about 150 launches
(12 search iterations of 9), a window of G steps several thousand.
"""

from __future__ import annotations

import torch

from karpenter_tpu_torch.apis.pod import NUM_RESOURCES
from karpenter_tpu_torch.explain import BIT
from karpenter_tpu_torch.solver.cost_sum import cost_sum
from karpenter_tpu_torch.solver.ffd_kernel import _fit_counts, open_nodes
from karpenter_tpu_torch.solver.packed import (
    pack_result_telemetry, right_size as _right_size, unpack_problem,
)
from karpenter_tpu_torch.solver.types import FIT_BIG
from karpenter_tpu_torch.stochastic import (
    CHANCE_FIT_MAX, CHANCE_ITERS, zsq_value,
)

I32 = torch.int32
F32 = torch.float32


def _chance_fit(resid, var_sum, mean, var_f, zsq: float, hi):
    """Max k per row of ``resid`` [X, R] (accumulated variance
    ``var_sum`` [X, R]) such that every dimension passes the quantile
    check; ``hi`` [X] is the integer mean-fit bound."""
    lo = torch.zeros_like(hi)
    for _ in range(CHANCE_ITERS):
        mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
        diff = resid - mid[:, None] * mean[None, :]
        diff_f = diff.to(F32)
        lhs = zsq * (var_sum + mid[:, None].to(F32) * var_f[None, :])
        feas = (lhs <= diff_f * diff_f).all(dim=1)
        lo = torch.where(feas, mid, lo)
        hi = torch.where(feas, hi, mid - 1)
    return lo


def _chance_fit_grid(alloc, mean, var_f, zsq: float, kd):
    """Empty-node chance fit over the [G, O] grid: a closed form in
    sqrt-space (cancellation-free), refined by a 4-point correction
    window under the exact predicate, so rounding in the closed form
    never changes the result."""
    A = alloc[None, :, :].to(F32)                           # [1, O, R]
    m = mean[:, None, :].to(F32)                            # [G, 1, R]
    bv = zsq * var_f[:, None, :]                            # z^2 v
    den = torch.sqrt(bv + 4.0 * m * A) + torch.sqrt(bv)
    s = torch.where(den > 0, (2.0 * A) / den, 0.0)
    k_dim = torch.where(mean[:, None, :] > 0, torch.floor(s * s),
                        float(CHANCE_FIT_MAX))
    k_hat = torch.minimum(torch.clamp(
        k_dim.min(dim=2).values.to(I32), min=0), kd)
    k = torch.clamp(k_hat - 2, min=0)
    k0 = k
    for j in range(1, 5):
        mid = k0 + j
        diff = alloc[None, :, :] - mid[:, :, None] * mean[:, None, :]
        diff_f = diff.to(F32)
        lhs = zsq * (mid[:, :, None].to(F32) * var_f[:, None, :])
        feas = (mid <= kd) & (lhs <= diff_f * diff_f).all(dim=2)
        k = k + feas.to(I32)
    return k


def _empty_fit_grids(mean, var, off_alloc, zsq: float):
    """(kd [G, O], kc [G, O]): the deterministic mean fit and the chance
    fit of each group on each empty offering."""
    var_f = var.to(F32)
    per_dim = torch.where(
        mean[:, None, :] > 0,
        torch.div(off_alloc[None, :, :],
                  torch.clamp(mean[:, None, :], min=1),
                  rounding_mode="floor"),
        FIT_BIG)
    kd = torch.clamp(per_dim.min(dim=2).values, max=CHANCE_FIT_MAX)
    kc = _chance_fit_grid(off_alloc, mean, var_f, zsq, kd)
    return kd, kc


def _mean_var(sto, G: int):
    half = G * NUM_RESOURCES
    return (sto[:half].reshape(G, NUM_RESOURCES),
            sto[half:2 * half].reshape(G, NUM_RESOURCES))


def build_fit_grids(sto, off_alloc, *, G: int, z_bp: int):
    """The per-problem fit grids (kd, kc) from the packed stochastic
    leaf, on the device the inputs lie on; built once per problem and
    catalog and kept for every later solve of the window."""
    mean, var = _mean_var(sto, G)
    return _empty_fit_grids(mean, var, off_alloc, zsq_value(z_bp))


def _stochastic_scan(mean, var, count, cap, compat, kc, off_alloc,
                     off_rank, zsq: float, N: int):
    """The scan over the G groups, step for step the reference's
    ``_ffd_step_stochastic``.  Returns (node_off [N], node_resid [N, R],
    node_var [N, R], assign [G, N], unplaced [G])."""
    dev = mean.device
    G = mean.shape[0]
    node_off = torch.full((N,), -1, dtype=I32, device=dev)
    node_resid = torch.zeros((N, NUM_RESOURCES), dtype=I32, device=dev)
    node_var = torch.zeros((N, NUM_RESOURCES), dtype=F32, device=dev)
    ptr = torch.zeros((), dtype=I32, device=dev)
    idx = torch.arange(N, dtype=I32, device=dev)
    assign = torch.empty((G, N), dtype=I32, device=dev)
    unplaced = torch.empty((G,), dtype=I32, device=dev)
    var_all = var.to(F32)
    for g in range(G):
        mean_g, var_f = mean[g], var_all[g]
        compat_g = compat[g]
        is_open = node_off >= 0
        node_compat = torch.where(
            is_open, compat_g[torch.clamp(node_off, min=0).long()], False)
        # ---- fill open nodes, first-fit in age order ------------------
        hi = torch.clamp(_fit_counts(node_resid, mean_g),
                         max=CHANCE_FIT_MAX)
        fit = _chance_fit(node_resid, node_var, mean_g, var_f, zsq, hi)
        fit = torch.where(node_compat, fit, 0)
        fit = torch.minimum(fit, cap[g])
        cumfit = torch.cumsum(fit, 0).to(I32) - fit
        take = torch.minimum(torch.clamp(count[g] - cumfit, min=0), fit)
        placed = take.sum().to(I32)
        node_resid = node_resid - take[:, None] * mean_g[None, :]
        node_var = node_var + take[:, None].to(F32) * var_f[None, :]
        rem = count[g] - placed
        # ---- open new nodes with the cheapest-per-pod offering --------
        fit_e = torch.where(compat_g, kc[g], 0)
        fit_e = torch.minimum(fit_e, cap[g])
        fit_e = torch.minimum(fit_e, rem)
        cpp = torch.where(fit_e > 0, off_rank / fit_e.to(F32),
                          float("inf"))
        best = torch.argmin(cpp)                    # first index on ties
        bf = fit_e[best]
        pods_new, opened = open_nodes(rem, bf, ptr, idx)
        node_off = torch.where(opened, best.to(I32), node_off)
        node_resid = torch.where(
            opened[:, None],
            off_alloc[best][None, :] - pods_new[:, None] * mean_g[None, :],
            node_resid)
        node_var = torch.where(opened[:, None],
                               pods_new[:, None].to(F32) * var_f[None, :],
                               node_var)
        ptr = (ptr + opened.sum()).to(I32)
        unplaced[g] = rem - pods_new.sum().to(I32)
        assign[g] = take + pods_new
    return node_off, node_resid, node_var, assign, unplaced


def _chance_ok(load_mean, load_var, off_alloc, zsq: float):
    """[N, O]: offering o's capacity passes the quantile check for node
    n's final (mean, variance) load."""
    diff = off_alloc[None, :, :] - load_mean[:, None, :]
    diff_f = diff.to(F32)
    return ((diff >= 0)
            & (zsq * load_var[:, None, :] <= diff_f * diff_f)).all(dim=2)


def _risk_words(var, count, unplaced, compat, kd, kc):
    """int32 [G] with only the overcommit_risk bit: a live unplaced
    group with variance whose chance fit is strictly below its mean fit
    on some compatible offering."""
    has_var = (var > 0).any(dim=1)
    hit = (compat & (kc < kd)).any(dim=1) & has_var \
        & (count > 0) & (unplaced > 0)
    return torch.where(hit, 1 << BIT["overcommit_risk"], 0).to(I32)


def solve_packed_stochastic(packed, sto, kd, kc, off_alloc, off_price,
                            off_rank, *, G: int, O: int, U: int, N: int,
                            z_bp: int, right_size: bool = True,
                            compact: int = 0, dense16: bool = False,
                            coo16: bool = False) -> torch.Tensor:
    """Packed-I/O chance-constrained solve on the device the inputs lie
    on: the problem buffer of ``solve_packed_torch``, the stochastic leaf
    ``sto`` and the fit grids ``kd`` / ``kc`` of :func:`build_fit_grids`
    -> the packed result buffer (explain words with the overcommit_risk
    bit, telemetry with the binding-groups slot)."""
    zsq = zsq_value(z_bp)
    meta, compat_i, rows_g = unpack_problem(packed, off_alloc, G, O, U)
    mean, var = _mean_var(sto, G)
    compat = compat_i > 0
    count, cap = meta[:, 4], meta[:, 5]
    node_off, node_resid, node_var, assign, unplaced = _stochastic_scan(
        mean, var, count, cap, compat, kc, off_alloc, off_rank, zsq, N)
    if right_size:
        load_mean = off_alloc[torch.clamp(node_off, min=0).long()] \
            - node_resid
        node_off = _right_size(
            node_off, load_mean, assign, compat, off_alloc, off_rank,
            fits=_chance_ok(load_mean, node_var, off_alloc, zsq))
    is_open = node_off >= 0
    prices = off_price[torch.clamp(node_off, min=0).long()]
    cost = cost_sum(torch.where(is_open, prices, torch.zeros_like(prices)))
    binding = (compat & (kc < kd)).any(dim=1) & (var > 0).any(dim=1)
    return pack_result_telemetry(
        meta, rows_g, compat_i, node_off, assign, unplaced, cost, off_alloc,
        compact, dense16, coo16,
        extra_words=_risk_words(var, count, unplaced, compat, kd, kc),
        binding=binding)
