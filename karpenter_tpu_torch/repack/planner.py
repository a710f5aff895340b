"""Batched fleet repack: one LP-relaxed scoring grid per round (port of
``karpenter_tpu/repack/planner.py``).

1. **Score grid** — every live node is evaluated at once as a
   migration-source candidate (the integral bin packing of "evacuate
   node s into the rest of the fleet" relaxed to its fractional
   feasibility, which vectorizes):

   - *drain* (``KIND_DRAIN``): every occupant is movable, the node's
     total demand fits the fleet's aggregate positive residual excluding
     itself, its largest pod fits some other node whole, and no parked
     gang shape is currently open on it.  Score = the node's price
     (milli-$/h saved).
   - *defrag* (``KIND_DEFRAG``): the node's movable chip-consuming
     singletons can relocate, and vacating their chips reopens >= 1
     parked gang shape on the node's torus: one batched AND over the
     ``[shapes, nodes, placements]`` bitmask grid (``gang/topology.py``
     SliceTables).  Score = reopened x price.  Defrag outranks drain on
     the same node.

2. **Rounding** — candidates commit in score-descending order (ties:
   node index ascending): each source's movable pods first-fit into
   targets in tightest-first order, with chip-aware placement (lowest
   free chips; a move may never close a parked shape's open placement on
   its target).  A source that fails rounding is skipped; a node that
   received a migration is locked as a target.

The grid runs as int32 / bool torch ops on the planner's device
(:func:`score_grid_torch`, the reference's jitted body) from
``_DEVICE_MIN_CELLS`` pairwise cells on (or forced with
``use_device="on"``), as long as every tensor fits int32; otherwise the
numpy grid is the route, a rule of size and range, not a fallback.  The
torch grid reads the resident occupancy rows directly when the problem
carries them (``ResidentStore.occupancy_tensors``).  Both grids are
integer exact, so the route never changes the plan.  A failure on the
device raises.  The greedy oracle (``repack/greedy.py``) is ported; the
reference's degraded wrapper onto it waits for ROADMAP queue 1 item 13.

Chip masks are uint64, split into two int32 words (``split_mask_words``)
for the torch grid; only ``&``, ``|``, ``~`` and ``== 0`` touch them,
so a word whose bit 31 is set (negative as int32) is never compared by
order or sign-extended.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from karpenter_tpu_torch.device import resolve_device
from karpenter_tpu_torch.faulttol import device_guard, device_id
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.gang.topology import split_mask_words
from karpenter_tpu_torch.repack.encode import RepackProblem, lowest_free_chips
from karpenter_tpu_torch.repack.types import (
    KIND_DEFRAG, KIND_DRAIN, Migration, ReopenedSlice, RepackOptions,
    RepackPlan,
)
from karpenter_tpu_torch.solver.types import NODE_BUCKETS, bucket

# bucket rungs of the torch grid: parked shapes and placements per
# shape; nodes ride the resident store's NODE_BUCKETS so the occupancy
# rows are read as they are
_SHAPE_PAD = (1, 2, 4, 8)
_PLACE_PAD = (2, 4, 8, 16, 32, 64)
# below this pairwise-grid size the numpy grid is the route
_DEVICE_MIN_CELLS = 4096
_I32_MAX = int(np.iinfo(np.int32).max)

_ROLE_FREE, _ROLE_SOURCE, _ROLE_TARGET = 0, 1, 2


def score_grid_torch(rows, alloc, price_n, movable, maxpod, sing_ok,
                     sing_demand, sing_max, occ_lo, occ_hi, sing_lo,
                     sing_hi, m_lo, m_hi, valid, tot_pos, real, elig):
    """Per-node (kind, score, reopened), int32 [Np] each, as int32 / bool
    torch ops on the inputs' device.  ``rows`` int32 [Np, 2 + R] are the
    occupancy rows (offering, pod count, residual); ``m_lo`` / ``m_hi`` /
    ``valid`` [S, O, P] the parked shapes' placement masks (two int32
    words each) and validity per offering; the other per-node inputs are
    [Np] or [Np, R] (int32 or bool), ``tot_pos`` int32 [R]."""
    off = rows[:, 0].long()
    count = rows[:, 1]
    resid = rows[:, 2:]
    demand = alloc[off] - resid                                # [Np, R]
    pos = torch.where(real[:, None], torch.clamp(resid, min=0),
                      torch.zeros_like(resid))
    excl = tot_pos[None, :] - pos                              # [Np, R]
    full_relax = (demand <= excl).all(dim=1)
    eye = torch.eye(resid.shape[0], dtype=torch.bool, device=rows.device)
    tgt = (real & elig)[None, :] & ~eye                        # [Np, Np]
    pair_full = ((resid[None, :, :] >= maxpod[:, None, :]).all(dim=2)
                 & tgt).any(dim=1)
    pair_sing = ((resid[None, :, :] >= sing_max[:, None, :]).all(dim=2)
                 & tgt).any(dim=1)
    # defrag term: [S, Np, P] placement grids gathered by the node's
    # offering; chip disjointness decomposes exactly over the two words
    nm_lo, nm_hi = m_lo[:, off, :], m_hi[:, off, :]
    nv = valid[:, off, :]
    a_lo, a_hi = occ_lo & ~sing_lo, occ_hi & ~sing_hi
    dis_b = ((nm_lo & occ_lo[None, :, None])
             | (nm_hi & occ_hi[None, :, None])) == 0
    dis_a = ((nm_lo & a_lo[None, :, None])
             | (nm_hi & a_hi[None, :, None])) == 0
    before = (nv & dis_b).any(dim=2)                           # [S, Np]
    after = (nv & dis_a).any(dim=2)
    open_parked = before.any(dim=0)
    reopened = (after & ~before).sum(dim=0).to(torch.int32)
    sing_relax = (sing_demand <= excl).all(dim=1)
    full_ok = real & elig & movable & (count > 0) & full_relax \
        & pair_full & ~open_parked
    defrag_ok = real & elig & sing_ok & (reopened > 0) & sing_relax \
        & pair_sing
    zero = torch.zeros_like(reopened)
    kind = torch.where(defrag_ok, KIND_DEFRAG,
                       torch.where(full_ok, KIND_DRAIN, zero))
    score = torch.where(
        kind == KIND_DEFRAG, reopened * torch.clamp(price_n, min=1),
        torch.where(kind == KIND_DRAIN, price_n, zero))
    return (kind.to(torch.int32), score.to(torch.int32),
            reopened.to(torch.int32))


class RepackPlanner:
    """Pure function over an encoded repack problem; the torch grid runs
    on ``device`` (the card by default, which raises without one;
    ``"cpu"`` for the plain route of the tests).  ``device_steps``
    counts the grids taken by torch."""

    def __init__(self, options: RepackOptions | None = None,
                 device="cuda"):
        self.options = options or RepackOptions()
        self.device = resolve_device(device)
        self.device_steps = 0

    # -- grid step (the only route-switched code) --------------------------

    def _score_grid(self, p: RepackProblem):
        """(kind, score, reopened) int64 [Nn] + the backend tag."""
        Nn = p.num_nodes
        tables = p.tables if self.options.defrag else []
        use = self.options.use_device
        if use != "off" and (use == "on" or Nn * Nn >= _DEVICE_MIN_CELLS) \
                and self._i32_safe(p):
            return self._grid_device(p, tables)
        return (*self._grid_numpy(p, tables), "vector")

    @staticmethod
    def _i32_safe(p: RepackProblem) -> bool:
        """Every tensor of the torch grid fits int32 (its arithmetic
        would wrap otherwise, and diverge from the numpy grid)."""
        alloc = p.catalog.offering_alloc()
        tot = np.clip(p.resid, 0, None).sum(axis=0)
        return all(int(np.abs(np.asarray(a)).max(initial=0)) < _I32_MAX
                   for a in (p.resid, p.maxpod, p.sing_demand, p.sing_max,
                             p.price_milli, alloc, tot))

    def _grid_device(self, p: RepackProblem, tables):
        dev = self.device
        Nn = p.num_nodes
        if p.rows_host is not None:
            Np = p.rows_host.shape[0]
            rows = p.rows_dev if p.rows_dev is not None \
                else torch.from_numpy(p.rows_host)
        else:
            Np = bucket(max(Nn, 1), NODE_BUCKETS)
            host_rows = np.zeros((Np, 2 + p.resid.shape[1]), np.int32)
            host_rows[:Nn, 0] = p.node_off
            host_rows[:Nn, 1] = p.pod_count
            host_rows[:Nn, 2:] = p.resid
            rows = torch.from_numpy(host_rows)
        alloc = p.catalog.offering_alloc().astype(np.int32)
        O = alloc.shape[0]
        Sp = bucket(max(len(tables), 1), _SHAPE_PAD)
        Pmax = max((t.pmax for t in tables), default=1)
        Pp = bucket(max(Pmax, 1), _PLACE_PAD)
        m = np.zeros((Sp, O, Pp), np.uint64)
        v = np.zeros((Sp, O, Pp), bool)
        for i, t in enumerate(tables):
            m[i, :, :t.pmax] = t.masks
            v[i, :, :t.pmax] = t.valid
        m_lo, m_hi = split_mask_words(m)
        occ_lo, occ_hi = split_mask_words(p.occ_mask)
        sing_lo, sing_hi = split_mask_words(p.sing_mask)

        def padn(a, dtype):
            out = np.zeros((Np,) + a.shape[1:], dtype)
            out[:Nn] = a
            return torch.from_numpy(out).to(dev)

        real = np.zeros(Np, bool)
        real[:Nn] = True
        tot_pos = np.clip(p.resid, 0, None).sum(axis=0).astype(np.int32)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # a DeviceFaultError raises to the caller (the reference's numpy
        # grid after a fault is ROADMAP queue 1 item 13); the reference
        # notes no devtel here, the port notes the grid's shape
        get_devtel().note_dispatch(
            "repack-grid", (Np, O, Sp, Pp),
            h2d_bytes=int(m_lo.nbytes + m_hi.nbytes + v.nbytes),
            donated=p.rows_dev is not None)
        with device_guard("repack-grid", devices=[device_id(dev)]) as guard:
            with get_profiler().sampled("repack-grid") as probe:
                kind, score, reopened = score_grid_torch(
                    rows.to(dev), up(alloc), padn(p.price_milli, np.int32),
                    padn(p.movable_all, bool), padn(p.maxpod, np.int32),
                    padn(p.sing_count > 0, bool),
                    padn(p.sing_demand, np.int32),
                    padn(p.sing_max, np.int32), padn(occ_lo, np.int32),
                    padn(occ_hi, np.int32), padn(sing_lo, np.int32),
                    padn(sing_hi, np.int32), up(m_lo), up(m_hi), up(v),
                    up(tot_pos), up(real), padn(p.eligible, bool))
                out = torch.stack([kind, score, reopened])
                probe.dispatched(out)
            out = guard.fetch(out)
        get_devtel().note_d2h(int(out.nbytes))
        self.device_steps += 1
        return (out[0, :Nn].astype(np.int64), out[1, :Nn].astype(np.int64),
                out[2, :Nn].astype(np.int64), "device")

    def _grid_numpy(self, p: RepackProblem, tables):
        Nn = p.num_nodes
        resid = p.resid
        alloc = p.catalog.offering_alloc().astype(np.int64)
        demand = alloc[p.node_off] - resid
        pos = np.clip(resid, 0, None)
        tot_pos = pos.sum(axis=0)
        excl = tot_pos[None, :] - pos
        full_relax = (demand <= excl).all(axis=1)
        eye = np.eye(Nn, dtype=bool)
        tgt = p.eligible[None, :] & ~eye
        pair_full = ((resid[None, :, :] >= p.maxpod[:, None, :])
                     .all(axis=2) & tgt).any(axis=1)
        pair_sing = ((resid[None, :, :] >= p.sing_max[:, None, :])
                     .all(axis=2) & tgt).any(axis=1)
        before = np.zeros((len(tables), Nn), dtype=bool)
        after = np.zeros((len(tables), Nn), dtype=bool)
        occ = p.occ_mask
        vac = p.occ_mask & ~p.sing_mask
        for i, t in enumerate(tables):
            masks = t.masks[p.node_off]              # [Nn, P]
            valid = t.valid[p.node_off]
            before[i] = (valid & ((masks & occ[:, None]) == 0)).any(axis=1)
            after[i] = (valid & ((masks & vac[:, None]) == 0)).any(axis=1)
        open_parked = before.any(axis=0)
        reopened = (after & ~before).sum(axis=0).astype(np.int64)
        sing_relax = (p.sing_demand <= excl).all(axis=1)
        full_ok = p.eligible & p.movable_all & (p.pod_count > 0) \
            & full_relax & pair_full & ~open_parked
        defrag_ok = p.eligible & (p.sing_count > 0) & (reopened > 0) \
            & sing_relax & pair_sing
        kind = np.where(defrag_ok, KIND_DEFRAG,
                        np.where(full_ok, KIND_DRAIN, 0)).astype(np.int64)
        score = np.where(
            kind == KIND_DEFRAG, reopened * np.maximum(p.price_milli, 1),
            np.where(kind == KIND_DRAIN, p.price_milli, 0)).astype(np.int64)
        return kind, score, reopened

    # -- the plan ----------------------------------------------------------

    def plan(self, problem: RepackProblem) -> RepackPlan:
        t0 = time.perf_counter()
        out = RepackPlan(backend="vector")
        Nn = problem.num_nodes
        current = float(problem.price_milli.sum()) / 1000.0 if Nn else 0.0
        out.current_cost = out.proposed_cost = current
        if Nn < 2:
            out.plan_seconds = time.perf_counter() - t0
            return out
        kind, score, reopened, backend = self._score_grid(problem)
        out.backend = backend
        out.candidate_count = Nn
        round_plan(problem, kind, score, out,
                   max_migrations=self.options.max_migrations)
        out.plan_seconds = time.perf_counter() - t0
        return out


def target_order(problem: RepackProblem) -> list[int]:
    """Static tightest-first target order: ascending dominant free
    fraction (integer 0..1024 of the node's allocatable), index ASC —
    the deterministic first-fit order every planner path shares (packing
    into the fullest node first is the consolidation-friendly fill)."""
    alloc = problem.catalog.offering_alloc().astype(np.int64)[
        problem.node_off]
    frac = np.where(alloc > 0,
                    np.clip(problem.resid, 0, None) * 1024
                    // np.maximum(alloc, 1), 0).max(axis=1)
    return np.lexsort((np.arange(problem.num_nodes), frac)).tolist()


def closes_open_slice(problem: RepackProblem, t: int, occ_t: int,
                      chips: int) -> bool:
    """Would landing ``chips`` on node ``t`` close a parked shape's
    currently-open placement there?  The anti-ping-pong guard: defrag
    must never re-fragment its own targets."""
    off = int(problem.node_off[t])
    for table in problem.tables:
        masks = table.masks[off]
        valid = table.valid[off]
        open_before = (valid & ((masks & np.uint64(occ_t)) == 0)).any()
        if not open_before:
            continue
        open_after = (valid
                      & ((masks & np.uint64(occ_t | chips)) == 0)).any()
        if not open_after:
            return True
    return False


def _batch_target(problem: RepackProblem, s: int, refs, work, occ, role,
                  sig_node_ok, rank, rank_inf):
    """The whole-batch fast path's target: the min-rank node that hosts
    EVERY movable pod of source ``s`` at once (combined demand, every
    pod's compat/zone pin, combined chip count, closure guard), or None
    — then the per-pod scan decides.  Returns ``(t, per-pod chip
    masks)``; chips split lowest-first in pod order, exactly what the
    sequential per-pod assignment onto one node would produce."""
    total = refs[0].req.copy()
    gpu_total = refs[0].gpu
    sigs = {refs[0].sig}
    pinned = bool(problem.sig_zone_pinned[refs[0].sig])
    for ref in refs[1:]:
        total = total + ref.req
        gpu_total += ref.gpu
        sigs.add(ref.sig)
        pinned |= bool(problem.sig_zone_pinned[ref.sig])
    feas = (role != _ROLE_SOURCE) & problem.eligible \
        & (work >= total[None, :]).all(axis=1)
    for sig in sigs:
        feas &= sig_node_ok[sig]
    if pinned:
        feas &= problem.node_zone == problem.node_zone[s]
    feas[s] = False
    if not feas.any():
        return None
    if gpu_total == 0:
        t = int(np.argmin(np.where(feas, rank, rank_inf)))
        return t, [0] * len(refs)
    cand = np.nonzero(feas)[0]
    cand = cand[np.argsort(rank[cand], kind="stable")]
    for tc in cand.tolist():
        mask = lowest_free_chips(occ[tc], int(problem.n_chips[tc]),
                                 gpu_total)
        if mask.bit_count() < gpu_total:
            continue
        if closes_open_slice(problem, tc, occ[tc], mask):
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
        return tc, split
    return None


def round_plan(problem: RepackProblem, kind: np.ndarray, score: np.ndarray,
               out: RepackPlan, max_migrations: int = -1) -> None:
    """Integral rounding of the relaxed candidate scores (see module
    docstring), host code shared by both grid routes, which give it
    identical grid outputs, so their plans are identical.  The per-pod
    target search is vectorized (the min tightest-first rank over the
    feasibility mask, the outcome of an ordered scan) so rounding stays
    sub-linear in Python operations at 2000 claims."""
    Nn = problem.num_nodes
    order = np.lexsort((np.arange(Nn), -score))
    torder = target_order(problem)
    rank = np.empty(Nn, dtype=np.int64)
    rank[np.asarray(torder, dtype=np.int64)] = np.arange(Nn)
    if problem.sig_rows.shape[0]:
        sig_node_ok = problem.sig_rows[:, problem.node_off] \
            & problem.taint_ok
    else:
        sig_node_ok = np.zeros((0, Nn), dtype=bool)
    work = problem.resid.astype(np.int64).copy()
    occ = [int(x) for x in problem.occ_mask]
    role = np.zeros(Nn, dtype=np.int8)
    budget = max_migrations if max_migrations >= 0 else (1 << 60)
    names = problem.claim_names
    _RANK_INF = np.int64(1) << 60

    for s in order.tolist():
        k = int(kind[s])
        if k == 0 or int(score[s]) <= 0 or role[s] != _ROLE_FREE:
            continue
        refs = [r for r in problem.pods[s]
                if (r.movable if k == KIND_DRAIN else r.single)]
        if not refs or len(refs) > budget:
            continue
        moves: list[tuple] = []
        journal: list[tuple] = []
        ok = True
        # whole-batch fast path: one target hosting the source's ENTIRE
        # movable set (the common drain shape) costs one vectorized
        # probe instead of one per pod; per-pod first-fit decides
        # otherwise (the reference's two-phase rule).
        batch = _batch_target(problem, s, refs, work, occ, role,
                              sig_node_ok, rank, _RANK_INF)
        if batch is not None:
            t, chip_split = batch
            for ref, chips in zip(refs, chip_split):
                work[t] -= ref.req
                occ[t] |= chips
                journal.append((t, ref.req, chips))
                moves.append((ref, t, chips))
        else:
            for ref in refs:
                feas = (role != _ROLE_SOURCE) & problem.eligible \
                    & (work >= ref.req[None, :]).all(axis=1) \
                    & sig_node_ok[ref.sig]
                feas[s] = False
                if problem.sig_zone_pinned[ref.sig]:
                    feas &= problem.node_zone == problem.node_zone[s]
                chips = 0
                if ref.gpu > 0:
                    cand = np.nonzero(feas)[0]
                    cand = cand[np.argsort(rank[cand], kind="stable")]
                    t = -1
                    for tc in cand.tolist():
                        ch = lowest_free_chips(occ[tc],
                                               int(problem.n_chips[tc]),
                                               ref.gpu)
                        if ch.bit_count() < ref.gpu:
                            continue
                        if closes_open_slice(problem, tc, occ[tc], ch):
                            continue
                        t, chips = tc, ch
                        break
                    if t < 0:
                        ok = False
                        break
                else:
                    if not feas.any():
                        ok = False
                        break
                    t = int(np.argmin(np.where(feas, rank, _RANK_INF)))
                work[t] -= ref.req
                occ[t] |= chips
                journal.append((t, ref.req, chips))
                moves.append((ref, t, chips))
        if not ok:
            # residuals only shrink: retrying later cannot help.  Undo
            # the trial deltas (chips were free before the OR, so the
            # AND-NOT restores exactly).
            for t, req, chips in journal:
                work[t] += req
                occ[t] &= ~chips
            continue
        # commit (work/occ already applied by the trial)
        for ref, t, chips in moves:
            out.migrations.append(Migration(
                pod_key=ref.key, src_claim=names[s], dst_claim=names[t],
                kind=k))
            role[t] = _ROLE_TARGET
        role[s] = _ROLE_SOURCE
        budget -= len(moves)
        if k == KIND_DRAIN:
            out.drained.append(names[s])
            out.proposed_cost -= float(problem.price_milli[s]) / 1000.0
        else:
            pre = occ[s]
            post = pre & ~int(problem.sing_mask[s])
            occ[s] = post
            work[s] += problem.sing_demand[s]
            off = int(problem.node_off[s])
            for shape, table in zip(problem.parked_shapes, problem.tables):
                masks = table.masks[off]
                valid = table.valid[off]
                fit_pre = (valid
                           & ((masks & np.uint64(pre)) == 0)).any()
                fit_post = (valid
                            & ((masks & np.uint64(post)) == 0)).any()
                if fit_post and not fit_pre:
                    out.reopened.append(ReopenedSlice(
                        claim_name=names[s], offering=off, shape=shape,
                        pre_mask=pre, post_mask=post))
