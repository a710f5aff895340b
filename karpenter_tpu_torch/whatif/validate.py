"""Independent what-if validator (port of
``karpenter_tpu/whatif/validate.py``).

Two layers, both independent of the planner's own code paths:

1. **Perturbed-state well-formedness.**  Each scenario's delta is
   replayed onto a fresh copy of the baseline and the buffer checked as
   a solve problem: delta indices in range, group counts and caps
   non-negative and bounded.  Scenario lowering does not sanitize, so a
   broken forecaster's garbage counts are rejected here.

2. **Fresh-solve equality.**  Every scenario's result words must equal
   a fresh single-window solve of the perturbed state: the port's
   ``solve_packed_torch`` on the planner's device (every word, the cost
   word included: same kernels, same order of adds), or the numpy
   oracle (every word but the float cost, which must still agree to a
   tolerance).  A stacked solve that mixes scenarios, a delta that
   lands on the wrong words or a decode that reads the wrong row all
   show as a word mismatch.
"""

from __future__ import annotations

import numpy as np

_I32_MAX = 2 ** 31 - 1

# sanity ceiling on a single group's pod count (~134M): the lowering
# saturates huge garbage at int32 max (the buffer is int32), so a pure
# "> int32" check could never fire — anything at or above this ceiling
# is a broken forecast, not a supported workload (the biggest bench
# regime is 4 orders of magnitude below it)
COUNT_CEILING = 1 << 27


def validate_whatif(plan, *, use_device: bool = True,
                    max_scenarios: int | None = None,
                    replay: bool = True) -> list[str]:
    """Validate a :class:`WhatIfPlan`.  Returns a list of violation
    strings (empty = valid).  ``use_device`` replays each scenario with
    ``solve_packed_torch`` on the plan's device (else with the numpy
    oracle); ``max_scenarios`` bounds the replay for large menus
    (well-formedness always checks every scenario); ``replay=False``
    runs only the well-formedness layer.

    The comparison is exact, the cost word included, only when both
    sides come from the device; a host plan's cost word is a numpy sum
    that matches the device only up to the order of the adds, so it
    compares through ``words_equal_except_cost``."""
    baseline = plan.baseline
    stacked = plan.stacked
    L = baseline.L
    G = baseline.G_pad
    violations: list[str] = []

    bufs: list[np.ndarray | None] = []
    for k, scenario in enumerate(stacked.scenarios):
        name = scenario.name
        didx, dval = stacked.didx[k], stacked.dval[k]
        bad_idx = (didx < 0) | (didx > L)
        if bad_idx.any():
            violations.append(
                f"scenario {name!r}: delta index out of range "
                f"(min={int(didx.min())}, max={int(didx.max())}, L={L})")
            bufs.append(None)
            continue
        buf = baseline.packed.copy()
        live = didx < L
        buf[didx[live]] = dval[live]
        meta = buf[:G * 8].reshape(G, 8).astype(np.int64)
        counts = meta[:, 4]
        caps = meta[:, 5]
        if (counts < 0).any():
            violations.append(
                f"scenario {name!r}: negative group count "
                f"(min={int(counts.min())}) — garbage forecast or "
                f"corrupt delta")
            bufs.append(None)
            continue
        if (counts >= COUNT_CEILING).any():
            violations.append(
                f"scenario {name!r}: absurd group count "
                f"(max={int(counts.max())} >= {COUNT_CEILING}) — "
                f"garbage forecast (huge rates saturate at int32 in "
                f"the lowering)")
            bufs.append(None)
            continue
        if (caps < 0).any():
            violations.append(
                f"scenario {name!r}: negative group cap")
            bufs.append(None)
            continue
        bufs.append(buf)

    if not replay:
        return violations
    n_replay = len(stacked.scenarios) if max_scenarios is None \
        else min(max_scenarios, len(stacked.scenarios))
    # exact equality (cost word included) only holds device against
    # device; a host plan's float cost differs by the order of the adds
    exact = use_device and plan.backend == "device"
    # padded catalog tensors, the same for every scenario
    catalog = baseline.catalog
    tensors = (_pad_host(catalog.offering_alloc().astype(np.int32),
                         baseline.O_pad),
               _pad_host(catalog.off_price.astype(np.float32),
                         baseline.O_pad),
               _pad_host(catalog.offering_rank_price(), baseline.O_pad))
    for k in range(n_replay):
        if bufs[k] is None:
            continue
        name = stacked.scenarios[k].name
        ref = _reference_solve(baseline, bufs[k], plan, use_device,
                               tensors)
        got = plan.raw[k]
        if exact:
            ok = got.shape == ref.shape and np.array_equal(got, ref)
        else:
            from karpenter_tpu_torch.whatif.oracle import (
                words_equal_except_cost,
            )

            ok = words_equal_except_cost(got, ref, G, plan.N)
        if not ok:
            diff = int(np.sum(got != ref)) if got.shape == ref.shape \
                else -1
            violations.append(
                f"scenario {name!r}: result words differ from a fresh "
                f"single-scenario solve ({diff} word(s); "
                f"reference={'device' if use_device else 'oracle'})")
    return violations


def _reference_solve(baseline, buf: np.ndarray, plan,
                     use_device: bool, tensors) -> np.ndarray:
    """One fresh single-window solve of the perturbed buffer at the
    plan's shapes.  ``tensors`` is the (alloc, price, rank) triple the
    caller padded once for the whole replay."""
    alloc, price, rank = tensors
    if use_device:
        import torch

        from karpenter_tpu_torch.solver.packed import solve_packed_torch

        dev = plan.device if plan.device is not None \
            else torch.device("cpu")
        out = solve_packed_torch(
            *(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (buf, alloc, price, rank)),
            G=baseline.G_pad, O=baseline.O_pad, U=baseline.U_pad,
            N=plan.N, right_size=plan.right_size, compact=plan.K_coo,
            dense16=False, coo16=plan.coo16)
        return out.cpu().numpy()
    from karpenter_tpu_torch.whatif.oracle import solve_packed_np

    return solve_packed_np(
        buf, alloc, price, rank,
        G=baseline.G_pad, O=baseline.O_pad, U=baseline.U_pad, N=plan.N,
        right_size=plan.right_size, compact=plan.K_coo, dense16=False,
        coo16=plan.coo16)


def _pad_host(a: np.ndarray, n: int) -> np.ndarray:
    from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2

    return _pad2(a, n) if a.ndim == 2 else _pad1(a, n)
