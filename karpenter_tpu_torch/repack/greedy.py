"""Pure-python repack oracle: the differential-parity reference.

Port of ``karpenter_tpu/repack/greedy.py``.  Implements the canonical
repack algorithm (``repack/planner.py`` module docstring) with scalar
host loops, no vectorized grids and no device, so the batched planner
has an independent implementation to be bit-identical against (the
same role ``preempt/greedy.py`` and ``gang/greedy.py`` play for their
planes).  The reference's degraded mode (``ResilientRepacker``) also
rides it when its batched path fails; the port has no such fallback.
"""

from __future__ import annotations

import time

import numpy as np

from karpenter_tpu_torch.repack.encode import RepackProblem, lowest_free_chips
from karpenter_tpu_torch.repack.types import (
    KIND_DEFRAG, KIND_DRAIN, Migration, ReopenedSlice, RepackOptions,
    RepackPlan,
)


def _fits_any(table_masks, table_valid, occ: int) -> bool:
    for m, ok in zip(table_masks.tolist(), table_valid.tolist()):
        if ok and (int(m) & occ) == 0:
            return True
    return False


class GreedyRepacker:
    """Scalar-loop implementation of the canonical repack algorithm."""

    def __init__(self, options: RepackOptions | None = None):
        self.options = options or RepackOptions()

    # -- scoring (the loop twin of the batched grid) -----------------------

    def _score(self, p: RepackProblem):
        Nn = p.num_nodes
        alloc = p.catalog.offering_alloc().astype(np.int64)
        tables = p.tables if self.options.defrag else []
        kind = [0] * Nn
        score = [0] * Nn
        reopened = [0] * Nn
        tot_pos = [0] * p.resid.shape[1]
        for ni in range(Nn):
            for ri in range(len(tot_pos)):
                v = int(p.resid[ni, ri])
                if v > 0:
                    tot_pos[ri] += v
        for s in range(Nn):
            off = int(p.node_off[s])
            resid_s = p.resid[s]
            demand = [int(alloc[off, ri]) - int(resid_s[ri])
                      for ri in range(len(tot_pos))]
            excl = [tot_pos[ri] - max(int(resid_s[ri]), 0)
                    for ri in range(len(tot_pos))]
            full_relax = all(demand[ri] <= excl[ri]
                             for ri in range(len(excl)))
            sing_relax = all(int(p.sing_demand[s, ri]) <= excl[ri]
                             for ri in range(len(excl)))
            pair_full = pair_sing = False
            for t in range(Nn):
                if t == s or not bool(p.eligible[t]):
                    continue
                if all(int(p.resid[t, ri]) >= int(p.maxpod[s, ri])
                       for ri in range(len(excl))):
                    pair_full = True
                if all(int(p.resid[t, ri]) >= int(p.sing_max[s, ri])
                       for ri in range(len(excl))):
                    pair_sing = True
            occ = int(p.occ_mask[s])
            vac = occ & ~int(p.sing_mask[s])
            open_parked = False
            reopen = 0
            for table in tables:
                before = _fits_any(table.masks[off], table.valid[off], occ)
                after = _fits_any(table.masks[off], table.valid[off], vac)
                open_parked |= before
                if after and not before:
                    reopen += 1
            price = int(p.price_milli[s])
            if not bool(p.eligible[s]):
                pass
            elif int(p.sing_count[s]) > 0 and reopen > 0 and sing_relax \
                    and pair_sing:
                kind[s] = KIND_DEFRAG
                score[s] = reopen * max(price, 1)
            elif bool(p.movable_all[s]) and int(p.pod_count[s]) > 0 \
                    and full_relax and pair_full and not open_parked:
                kind[s] = KIND_DRAIN
                score[s] = price
            reopened[s] = reopen
        return kind, score, reopened

    # -- rounding (the loop twin of planner.round_plan) --------------------

    def plan(self, problem: RepackProblem) -> RepackPlan:
        t0 = time.perf_counter()
        out = RepackPlan(backend="greedy")
        Nn = problem.num_nodes
        current = sum(int(v) for v in problem.price_milli) / 1000.0
        out.current_cost = out.proposed_cost = current
        if Nn < 2:
            out.plan_seconds = time.perf_counter() - t0
            return out
        kind, score, _reopened = self._score(problem)
        out.candidate_count = Nn
        order = sorted(range(Nn), key=lambda i: (-score[i], i))
        alloc = problem.catalog.offering_alloc().astype(np.int64)
        frac = []
        for ni in range(Nn):
            a = alloc[int(problem.node_off[ni])]
            frac.append(max(
                (max(int(problem.resid[ni, ri]), 0) * 1024
                 // max(int(a[ri]), 1)) if int(a[ri]) > 0 else 0
                for ri in range(problem.resid.shape[1])))
        torder = sorted(range(Nn), key=lambda i: (frac[i], i))
        work = [[int(v) for v in problem.resid[ni]] for ni in range(Nn)]
        occ = [int(x) for x in problem.occ_mask]
        role = [0] * Nn
        budget = self.options.max_migrations \
            if self.options.max_migrations >= 0 else (1 << 60)
        names = problem.claim_names
        R = problem.resid.shape[1]

        for s in order:
            k = kind[s]
            if k == 0 or score[s] <= 0 or role[s] != 0:
                continue
            refs = [r for r in problem.pods[s]
                    if (r.movable if k == KIND_DRAIN else r.single)]
            if not refs or len(refs) > budget:
                continue
            trial_res: dict[int, list[int]] = {}
            trial_occ: dict[int, int] = {}
            moves: list[tuple] = []
            ok = True
            # whole-batch fast path first (the same two-phase rule the
            # batched planner's rounding applies): one target hosting
            # the ENTIRE movable set, min tightest-first rank
            batch = self._batch_target(problem, s, refs, work, occ,
                                       role, torder)
            if batch is not None:
                t, split = batch
                for ref, chips in zip(refs, split):
                    req = [int(v) for v in ref.req]
                    trial_res[t] = [a + b for a, b in zip(
                        trial_res.get(t, [0] * R), req)]
                    if chips:
                        trial_occ[t] = trial_occ.get(t, 0) | chips
                    moves.append((ref, t, chips, req))
                refs = []
            for ref in refs:
                placed = False
                req = [int(v) for v in ref.req]
                for t in torder:
                    if t == s or role[t] == 1 \
                            or not bool(problem.eligible[t]):
                        continue
                    if not bool(problem.sig_rows[ref.sig][
                            int(problem.node_off[t])]) \
                            or not bool(problem.taint_ok[ref.sig][t]):
                        continue
                    if bool(problem.sig_zone_pinned[ref.sig]) and \
                            int(problem.node_zone[t]) != \
                            int(problem.node_zone[s]):
                        continue
                    used = trial_res.get(t, [0] * R)
                    if any(work[t][ri] - used[ri] < req[ri]
                           for ri in range(R)):
                        continue
                    chips = 0
                    if ref.gpu > 0:
                        occ_t = occ[t] | trial_occ.get(t, 0)
                        chips = lowest_free_chips(
                            occ_t, int(problem.n_chips[t]), ref.gpu)
                        if chips.bit_count() < ref.gpu:
                            continue
                        if self._closes_open(problem, t, occ_t, chips):
                            continue
                    trial_res[t] = [used[ri] + req[ri] for ri in range(R)]
                    if chips:
                        trial_occ[t] = trial_occ.get(t, 0) | chips
                    moves.append((ref, t, chips, req))
                    placed = True
                    break
                if not placed:
                    ok = False
                    break
            if not ok:
                continue
            for ref, t, chips, req in moves:
                out.migrations.append(Migration(
                    pod_key=ref.key, src_claim=names[s],
                    dst_claim=names[t], kind=k))
                for ri in range(R):
                    work[t][ri] -= req[ri]
                occ[t] |= chips
                role[t] = 2
            role[s] = 1
            budget -= len(moves)
            if k == KIND_DRAIN:
                out.drained.append(names[s])
                out.proposed_cost -= int(problem.price_milli[s]) / 1000.0
            else:
                pre = occ[s]
                post = pre & ~int(problem.sing_mask[s])
                occ[s] = post
                for ri in range(R):
                    work[s][ri] += int(problem.sing_demand[s, ri])
                off = int(problem.node_off[s])
                for shape, table in zip(problem.parked_shapes,
                                        problem.tables):
                    fit_pre = _fits_any(table.masks[off],
                                        table.valid[off], pre)
                    fit_post = _fits_any(table.masks[off],
                                         table.valid[off], post)
                    if fit_post and not fit_pre:
                        out.reopened.append(ReopenedSlice(
                            claim_name=names[s], offering=off,
                            shape=shape, pre_mask=pre, post_mask=post))
        out.plan_seconds = time.perf_counter() - t0
        return out

    def _batch_target(self, problem: RepackProblem, s: int, refs,
                      work, occ, role, torder):
        """Scalar twin of ``planner._batch_target``: min-rank node that
        hosts every movable pod of ``s`` at once, or None."""
        R = problem.resid.shape[1]
        total = [0] * R
        gpu_total = 0
        sigs = set()
        pinned = False
        for ref in refs:
            for ri in range(R):
                total[ri] += int(ref.req[ri])
            gpu_total += ref.gpu
            sigs.add(ref.sig)
            pinned |= bool(problem.sig_zone_pinned[ref.sig])
        for t in torder:
            if t == s or role[t] == 1 or not bool(problem.eligible[t]):
                continue
            if any(work[t][ri] < total[ri] for ri in range(R)):
                continue
            if any(not bool(problem.sig_rows[sig][
                    int(problem.node_off[t])])
                   or not bool(problem.taint_ok[sig][t])
                   for sig in sigs):
                continue
            if pinned and int(problem.node_zone[t]) != \
                    int(problem.node_zone[s]):
                continue
            if gpu_total == 0:
                return t, [0] * len(refs)
            mask = lowest_free_chips(occ[t], int(problem.n_chips[t]),
                                     gpu_total)
            if mask.bit_count() < gpu_total:
                continue
            if self._closes_open(problem, t, occ[t], mask):
                continue
            split = []
            remaining = mask
            for ref in refs:
                ch = 0
                taken = 0
                while taken < ref.gpu:
                    low = remaining & -remaining
                    ch |= low
                    remaining &= ~low
                    taken += 1
                split.append(ch)
            return t, split
        return None

    @staticmethod
    def _closes_open(problem: RepackProblem, t: int, occ_t: int,
                     chips: int) -> bool:
        off = int(problem.node_off[t])
        for table in problem.tables:
            if not _fits_any(table.masks[off], table.valid[off], occ_t):
                continue
            if not _fits_any(table.masks[off], table.valid[off],
                             occ_t | chips):
                return True
        return False
