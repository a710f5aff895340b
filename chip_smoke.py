"""Chip smoke test of the PyTorch/CUDA port (``karpenter_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the default provisioning solve of the
headline window, 10k pending pods x 500 instance types (seed 42) —
through ``TorchSolver(device="cuda").solve``, then the batched paths:
the multi-cluster fleet (8 clusters x 10k pods, each with its own
catalog) through ``fleet_solve_packed``, the window stream through
``solve_stream`` and a zone-candidate window through ``solve``, then the
routes the default dispatch takes on its own, each through ``solve`` at
10k pods x 500 types: the flat regime (two heterogeneous windows), the
affinity plane and the stochastic plane; then the soft-preference window
(the FFD kernel with a rank row per group), the resident store's churn
stream, the serving loop's churn stream and the fleet with its resident
input, then the what-if plane (64 scenarios in one stacked plan), the
gang plane and the preemption plane at the shapes of bench.py's
``run_whatif``, ``run_gang`` and ``run_preempt``, then the sharded
service (the headline window, ``run_sharded``'s churn and hash-skewed
streams, its serving loop) and the repack plane at ``run_repack``'s
fleet; and checks that each
path ran through its hand-written CUDA kernels (the order-fixed cost sum
on every path that writes a cost word, the flat program's order-fixed
segment sum, the pref right-size's order-fixed presence sum; the
affinity and stochastic scans and the gang, preemption and repack
grids are PyTorch ops).  Phases, in order; any failure exits non-zero and prints
no result line:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from ``karpenter_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``karpenter_tpu_torch/_build/``;
3. hold each kernel against its plain PyTorch version on the card, with
   exact int32 equality: ``ffd_scan`` over seeds at the headline shape,
   the largest scan shape and edge cases; ``ffd_scan_fleet`` with eight
   distinct catalogs at the headline shape, with one catalog expanded
   over 16 problems (stride 0, also against the problems launched one
   by one) and with distinct catalogs at the largest shape; then the
   shapes the kernel's design has to get right: offering counts that
   are not multiples of 4, 16 or 128 (int32 and uint8 compat, one
   problem and a fleet of three catalogs), N = 8192, G = 0 and G below
   the row ring's depth, and a rank tie that only division by a small
   rem makes; then a rank row per group (the soft-preference scan) at one
   shape per instantiation that form takes (the headline shape, N = 4096
   at O = 4096, N = 8192 at O = 4096 and 5000), one problem and a fleet
   of three, windows shorter than the ring or not a whole number of its
   slots, and on the pref window's own tensors.  Over all these checks,
   every instantiation of
   the chain kernel must have run, and the uncapped branch, the capped
   branch and the summed takes (groups that request nothing) of its
   step, counted on the host from the plain version's outputs; with a
   rank row per group, every instantiation and both branches; then
   ``cost_sum`` bit for bit against its plain version over C in {1, 8,
   64}, every N in NODE_BUCKETS and ragged lengths, with 30-70% of the
   nodes open and totals small and near 2^24, and ``cost_word`` (the
   gather, mask and sum in one launch) over the same shapes with a
   price row per problem, one shared row and one row;
4. the paths, each with every launch count set to 0 just before and
   read just after, each needing its kernels launched and no pod left
   unplaced: (a) the main path, whose plan must validate clean and
   whose packed result must equal the plain CPU solve word for word
   (the float cost word included); (b) the fleet, whose
   [C, Lo] result must equal the plain CPU fleet program word for word;
   (c) the stream of 64 windows at depth 32, batch 16, each plan equal
   to its single-window plan and clean; (d) the zone-candidate window,
   whose plan must equal the CPU solver's, with its candidate rounds
   batched; (e) the two flat windows, (f) the affinity window and (g)
   the stochastic window, each plan equal to the CPU solver's and clean
   (validate_plan, validate_affinity_plan, the chance rule), its placed
   count the CPU's, ``last_stats["path"]`` naming the route and the
   card, and its raw result equal to the plain CPU program word for
   word; ``segment_sum`` held bit for bit against its plain version on
   every call of the flat program (calls per window printed), and on the
   largest call its wrapper beside ``index_add_`` (medians of rounds in
   turns), its device time alone and its device kernels per call from
   ``torch.profiler`` (at most 2, or the run fails); for each route the
   cold wall, the p50
   of 20 warm windows, the device program's CUDA-event time, kernels per
   window from ``torch.profiler`` and, for flat, host syncs per window;
   (h) the pref window (the headline pods with soft preferences, G below
   the flat gate, a node holding three or more groups with fractional
   misses): ``ffd_scan_pref`` and ``presence_sum`` launched, the plan
   equal to the CPU solver's and clean, the raw result equal to the
   plain CPU program word for word, ``presence_sum`` bit for bit against
   its plain version (the window's tensors and seeded ones: ragged O, G
   not a multiple of 32, a node holding every group, an all-closed node
   axis, one node, G at its maximum), the same timings plus the kernel
   beside its shared-rank form in turns (with the window's capped
   sweeps, the extra time per capped sweep and the chain instantiation)
   and the pref right-size beside the shared-rank one, and
   ``presence_sum`` beside its plain version and ``torch.matmul`` in
   turns, its device time alone, its device kernels per call (at most
   2, or the run fails) and its bound as the data needs it; (i) the
   resident stream
   (bench.py's ``run_resident`` churn at 10k x 500), resident on and off
   alternately, every plan equal, each resident solve launching one
   ``ffd_scan``, one ``cost_sum`` and nothing else (counts zeroed
   before it and read after it), its raw result equal to the classic
   dispatch's word for word,
   the device state equal to the mirror after every window, the modes
   rebuild, delta and hit all seen; (j)
   the serving stream (``run_serving``'s churn at 10k x 500, depth 2, a
   cold and a warm pass): every window on the ring, no backpressure,
   ``ring_state_violations`` empty, every plan and raw ring result equal
   to the classic one, and the port's 8-seed parity checks empty; (k)
   the fleet with ``resident_buf``: a rebuild, a hit on the same window
   and a delta with one cluster churned, each equal to the fleet without
   it; (l) the what-if plane at ``run_whatif``'s shape (10k pods x 500
   types, K = 64 from its menu of arrival waves, spot storm, zone
   blackout and quota clamp): one ``ffd_scan_fleet`` and one
   ``cost_sum`` launch for the stacked plan and nothing else, every
   scenario's words equal to ``solve_packed_torch`` of its perturbed
   buffer on the card (cost word included) and to the numpy oracle up to
   the cost word, ``validate_whatif`` clean, ``ffd_scan_fleet`` exact
   against its plain version at C = 64 and C = 128, ``cost_sum`` on the
   plan's own prices, and the stacked p50 beside 64 sequential single
   solves and ``plan_host``; (m) the gang plane at ``run_gang``'s shape
   (64 gangs x 16 members, 500 accelerator types, seed 17): the torch
   grid on the card equal to the numpy grid, ``validate_gang_plan``
   clean, no partial gang; (n) the preemption plane at ``run_preempt``'s
   shape (10k pending, 2000 claims, seed 31): the torch fit grid on the
   card equal to the numpy grid, ``validate_preemption_plan`` clean;
   (o) the headline window through ``make_solver(SolverOptions(
   sharded=2))`` (the sharded service: the shards are the fleet kernel's
   problem axis): one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
   window over 21 windows, each shard's raw row equal to the plain CPU
   solve of its buffer word for word, the plan equal to the CPU sharded
   solver's and clean, its warm p50 beside ``TorchSolver``'s; then the
   window through ``ShardedSolveService(4)``; (p) ``run_sharded``'s churn
   at 10k pods x 500 types (4 seeds x 4 rounds): every window one launch
   of each, its rows equal to single solves of its shards' buffers on the
   card, the state and partition checks clean, the resident modes and
   delta words; the hash-skewed stream migrating, every decision equal to
   ``rebalance_oracle``; aggregate and single-shard pods/s; (q) seed 0's
   churn through ``ShardedServingLoop(capacity=2)``: plans equal to
   ``solve_window``'s, the overlap fraction, the port's sharded parity
   checks, the wall of every submit, result and window with the garbage
   collections of each pass, and a ``cProfile`` of warm windows; (r) ``run_repack``'s fleet (2000 claims x 500 types): the
   repack grid as torch ops on the card reading the resident occupancy
   rows, its plan equal to the numpy grid's and
   ``validate_repack_plan`` clean, both warm p50s; and the torus-defrag
   case reopening a slice on both routes;
5. timings (taken after path (d) and before paths (e)-(g) run): p50
   wall of 20 warm windows, the device phases of one
   window, launches and device busy share of warm windows from a
   ``torch.profiler`` trace, each kernel's own time beside its plain
   version and its bound, with the time per group step, and the scan
   at the largest shape (G=2048, O=4096, N=4096); the fleet's
   single-shot and pipelined walls;
   the stream's amortized per-window wall at batch 1 and 16 beside the
   single-window p50, and its kernels per batch and device busy share
   (none of these gates the run).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  With ``--json-out PATH`` everything
measured also lands in the JSON file PATH.
"""

from __future__ import annotations

import argparse
import cProfile
import gc
import importlib
import json
import pstats
import random
import subprocess
import sys
import time
import warnings
from collections import deque
from pathlib import Path

import numpy as np
import torch

from karpenter_tpu_torch import (
    SolveRequest, SolverOptions, TorchSolver, validate_plan,
)
from karpenter_tpu_torch import cuda_build, workload
from karpenter_tpu_torch.apis import pod as pod_api
from karpenter_tpu_torch.apis.requirements import LABEL_ZONE
from karpenter_tpu_torch.parallel import (
    FleetProblem, fleet_device_catalog, fleet_pack_inputs,
    fleet_solve_packed,
)
from karpenter_tpu_torch.affinity.kernel import solve_packed_affinity
from karpenter_tpu_torch.affinity.validate import validate_affinity_plan
from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.solver import (
    cost_sum, ffd_kernel, presence_sum, segment_sum,
)
from karpenter_tpu_torch.solver import flat as flat_mod
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.resident import delta as resident_delta
from karpenter_tpu_torch.resident.store import ResidentBuffer
from karpenter_tpu_torch.solver.torch_backend import (
    _pad1, _pad2, unpack_result,
)
from karpenter_tpu_torch.solver.types import (
    FIT_BIG, GROUP_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, bucket,
)
from karpenter_tpu_torch.stochastic.kernel import solve_packed_stochastic
from karpenter_tpu_torch import whatif
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.gang import GangOptions, GangPlanner, encode_gangs
from karpenter_tpu_torch.preempt import (
    PlannerOptions, PreemptionPlanner, encode_victims, group_node_compat,
)
from karpenter_tpu_torch.solver.validate import (
    validate_gang_plan, validate_preemption_plan,
)
from karpenter_tpu_torch.whatif import kernels as whatif_kernels
from karpenter_tpu_torch.whatif import oracle as whatif_oracle
from karpenter_tpu_torch.whatif import scenario as whatif_scenario

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# rate, and the float32 rate outside the tensor cores, used for the
# scan's scalar integer/float operations.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# scalar operations per (group, open node) and per (group, offering) in
# the FFD step: four floor divisions with their guards and mins, the
# compat read, the cap/rem clamps, the scan/take arithmetic or the
# rank / fit divide and compare
OPS_PER_NODE = 16
OPS_PER_OFFERING = 16

HEADLINE = dict(pods=10_000, types=500, seed=42)
# BASELINE config #5 as bench.py runs it: clusters x build_workload(pods,
# types, seed=seed0 + c)
FLEET = dict(clusters=8, pods=10_000, types=500, seed0=100)
# the window stream: `distinct` headline-size windows (seeds seed0...)
# cycled to `windows`, through solve_stream(depth, batch)
STREAM = dict(windows=64, distinct=16, depth=32, batch=16, seed0=42)
# the zone-candidate window: the headline pods plus `apps` co-scheduled
# apps of `pods` pods, each with a self PodAffinityTerm on the zone key
ZONE = dict(apps=3, pods=200)
# the routes the default dispatch takes on its own, at the headline size:
# the flat regime (bench.py::build_hetero_workload, plain and with 30%
# hard constraints and 15% soft preferences), the affinity plane
# (bench.py::_affinity_bench_pods, RandomState(19)) and the stochastic
# plane (bench.py::run_stochastic's menu, seed 13, overcommit 0.05)
FLAT_WINDOWS = (dict(seed=7),
                dict(seed=11, constrained_frac=0.3, pref_frac=0.15))
AFFINITY = dict(tag="aff", rng_seed=19)
STOCHASTIC = dict(seed=13, overcommit=0.05)
ROUTE_WARM = 20
# bench.py::run_resident / run_serving's churn streams at the headline
# size: 1-5 departures and 1-5 arrivals of 500m/1Gi pods per window
RESIDENT = dict(seed=77, windows=10, rng="bench-resident", tag="rw")
SERVING = dict(seed=78, windows=8, rng="bench-serving", tag="sw", depth=2)
# bench.py::run_whatif (10k pods x 500 types, K = 64 from the menu seeded
# 5), run_gang (64 gangs x 16 members, 500 accelerator types, seed 17)
# and run_preempt (10k pending, 2000 claims, 500 types, seed 31)
WHATIF = dict(pods=10_000, types=500, K=64, menu_seed=5, iters=6)
GANG = dict(gangs=64, members=16, types=500, seed=17, iters=10)
PREEMPT = dict(pending=10_000, claims=2000, types=500, seed=31, iters=5)
# the sharded service: the headline window through make_solver(sharded=2)
# (20 warm windows) and ShardedSolveService(4); bench.py::run_sharded's
# churn (pods of 100-900m / 256-2048 Mi, per round 1-15 departures and
# 8-24 arrivals) at 10k pods x 500 types, 4 rounds, 4 seeds, and its
# hash-skewed stream (24 hot sizes on shard 0, 2-5 pods each, seed 7, 4
# windows); the serving loop over seed 0's stream at capacity 2
SHARDED = dict(shards=2, warm=20, wide=4, pods=10_000, types=500, rounds=4,
               seeds=4, seed0=1000, hot=24, hot_seed=7, hot_windows=4,
               tput_windows=10, capacity=2)
# bench.py::run_repack's fleet (2000 bx2-16x64 claims at 0.8 $/h, 2 pods
# each of 100-1000m / 256-2048 Mi, seed 13, 500 types) and
# _run_repack_defrag's torus case (two gx3-64x512 nodes, gpu=2
# singletons 3 and 1, a parked 2x2x2 gang)
REPACK = dict(claims=2000, types=500, pods_per_claim=2, seed=13, iters=8)
KERNELS = {
    "ffd_scan": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:253"),
    "ffd_scan_fleet": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:304"),
    "segment_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/segment_sum.cu",
        replaces="karpenter_tpu/solver/flat.py:231"),
    "ffd_scan_pref": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:958"),
    "presence_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/presence_sum.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:281"),
    "cost_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/cost_sum.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:746"),
}
# the module, not the ``encode`` function the solver package re-exports
encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")


def say(*parts) -> None:
    print(*parts, flush=True)


COUNTERS = (ffd_kernel.LAUNCHES, segment_sum.LAUNCHES, presence_sum.LAUNCHES,
            cost_sum.LAUNCHES)


def reset_launches() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return {k: v for counts in COUNTERS for k, v in counts.items()}


def require_no_launches(launches: dict, path: str) -> None:
    if any(launches.values()):
        raise AssertionError(f"the {path} launched a kernel of another "
                             f"route: {launches}")


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}: {launches}")


def first_diff(label: str, got, want) -> None:
    """Raise naming the first differing cell of (node_off, assign,
    unplaced) when any differs."""
    for name, a, b in zip(("node_off", "assign", "unplaced"), got, want):
        bad = torch.nonzero(a != b)
        if bad.numel():
            raise AssertionError(f"{label}: {name} differs at "
                                 f"{bad[0].tolist()} ({bad.shape[0]} "
                                 f"cells)")


def max_abs_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def words_equal(label: str, card: np.ndarray, plain: np.ndarray,
                cost_word: int) -> tuple[float, float]:
    """A packed result row against its plain CPU twin: every word equal,
    the float cost word (at ``cost_word``) included."""
    if card.shape != plain.shape:
        raise AssertionError(f"{label}: result lengths {card.shape} vs "
                             f"{plain.shape}")
    bad = np.nonzero(card != plain)[0]
    if bad.size:
        raise AssertionError(f"{label}: packed result differs from the CPU "
                             f"in {bad.size} words, first at {bad[0]} "
                             f"(cost word at {cost_word})")
    c_card = float(card[cost_word:cost_word + 1].view(np.float32)[0])
    c_cpu = float(plain[cost_word:cost_word + 1].view(np.float32)[0])
    return c_card, c_cpu


def plan_view(plan):
    return ([(n.offering_index, n.pod_names) for n in plan.nodes],
            plan.unplaced_pods)


def plans_equal(label: str, got, want) -> None:
    if plan_view(got) != plan_view(want):
        raise AssertionError(f"{label}: plan differs from the reference "
                             f"plan")
    if got.total_cost_per_hour != want.total_cost_per_hour:
        raise AssertionError(f"{label}: cost {got.total_cost_per_hour} vs "
                             f"{want.total_cost_per_hour}")


def clean_and_placed(label: str, plan, pods, catalog, nodepool=None,
                     placed: int | None = None) -> None:
    """validate_plan clean, and every pod placed (or, with ``placed``,
    exactly that many: a window whose reference leaves pods unplaced)."""
    errors = validate_plan(plan, pods, catalog, nodepool)
    if errors:
        raise AssertionError(f"{label}: validate_plan: {errors[:5]}")
    want = len(pods) if placed is None else placed
    if plan.placed_count != want or \
            plan.placed_count + len(plan.unplaced_pods) != len(pods):
        raise AssertionError(f"{label}: placed {plan.placed_count} of "
                             f"{len(pods)}, want {want}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls,
    bracketed by CUDA events after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(fns: dict, reps: int, rounds: int = 5) -> dict:
    """Median over ``rounds`` of each callable's :func:`cuda_ms` (``reps``
    back-to-back calls), the callables taken in turns, the order reversed
    every other round: a comparison that the host's drift within the
    process does not tilt."""
    for fn in fns.values():
        cuda_ms(fn, 2)
    runs = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            runs[name].append(cuda_ms(fns[name], reps, warm=0))
    return {name: float(np.median(v)) for name, v in runs.items()}


# -- phase 3: kernel against its plain version -------------------------------


def scan_inputs(seed: int, G: int, O: int, alloc_np=None, rank_np=None,
                case: str = ""):
    """FFD inputs at [G, O] from a seed: request rows from the headline
    size classes (zero-request dimensions in the "zero_req" case), group
    counts, caps (cap = 1 rows in the "cap1" case), label-like compat
    rows ANDed with the resource fit."""
    rng = np.random.RandomState(seed)
    if alloc_np is None:
        alloc_np = np.zeros((O, 4), np.int32)
        live = O - O // 8                       # padded tail stays zero
        alloc_np[:live, 0] = rng.choice([1800, 3800, 7800, 15800, 63800],
                                        live)
        alloc_np[:live, 1] = rng.choice([1548, 5644, 13836, 62988], live)
        alloc_np[:live, 3] = rng.choice([30, 60, 110], live)
        rank_np = np.zeros(O, np.float32)
        rank_np[:live] = (rng.rand(live) * 5 + 0.05).astype(np.float32)
        rank_np[1:live:9] = rank_np[0]          # price ties
    sizes = np.array([(250, 512), (500, 1024), (1000, 4096), (2000, 8192),
                      (4000, 16384), (8000, 32768)], np.int32)
    meta = np.zeros((G, 8), np.int32)
    meta[:, :2] = sizes[rng.randint(len(sizes), size=G)]
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 400 if G <= 64 else 30, G)
    meta[:, 5] = FIT_BIG
    if case == "zero_req":
        meta[rng.rand(G) < 0.5, 0] = 0
        meta[rng.rand(G) < 0.5, 1] = 0
    if case == "cap1":
        meta[rng.rand(G) < 0.5, 5] = 1
    labels = rng.rand(6, O) < np.array([1.0, 0.5, 0.33, 0.33, 0.33, 0.6]
                                       )[:, None]
    lbl = labels[rng.randint(6, size=G)]
    fit = (alloc_np[None, :, :] >= meta[:, None, :4]).all(axis=2)
    compat = (lbl & fit).astype(np.int32)
    if case == "unplaceable":
        compat[0] = 0
        meta[0, 4] = 37
    if case == "no_request":
        # groups that request nothing: every compatible open node fits
        # FIT_BIG of them, and the fill's int32 prefix sums wrap
        free = rng.rand(G) < 0.35
        free[0] = False
        meta[free, :4] = 0
    return meta, compat, alloc_np, rank_np


def new_tally(pref: bool = True) -> dict:
    """Over the kernel checks: the steps of each branch of the chain (from
    the plain version's outputs) and the checked scans of each
    instantiation of the chain kernel; ``pref`` holds the same for the
    scans with a rank row per group."""
    tally = {"branches": {"opens_nothing": 0, "uncapped": 0, "capped": 0,
                          "summed_takes": 0},
             "variants": {}}
    if pref:
        tally["pref"] = new_tally(pref=False)
    return tally


def add_to_tally(tally: dict, label: str, meta, compat, alloc, want,
                 N: int, group_rank: bool = False) -> None:
    for k, v in ffd_kernel.chain_branches(meta, compat, alloc,
                                          *want).items():
        tally["branches"][k] += v
    variant = ffd_kernel.scan_variant(compat.shape[-1], N, group_rank)
    tally["variants"].setdefault(variant, []).append(label)


def check_scan(dev, label: str, N: int, inputs,
               tally: dict) -> tuple[int, dict]:
    """Kernel vs plain version on the card; returns (max |diff|, info)."""
    meta, compat, alloc, rank = (
        x.contiguous() if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in inputs)
    got = ffd_kernel.ffd_scan(meta[None], compat[None], alloc, rank, N)
    want = ffd_kernel.ffd_scan_reference(meta[None], compat[None], alloc,
                                         rank, N)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    node_off, _, unplaced = (x.cpu().numpy()[0] for x in want)
    info = {"nodes_open": int((node_off >= 0).sum()),
            "unplaced": int(unplaced.sum())}
    if err:
        first_diff(f"ffd_scan {label}", got, want)
    add_to_tally(tally, label, meta[None], compat[None], alloc, want, N,
                 group_rank=rank.dim() == 2)
    return err, info


def phase_kernel_checks(dev, catalog, tally: dict) -> dict:
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    cases = []
    for seed in range(8):
        cases.append(("headline G=64 O=3072 N=512", 512,
                      scan_inputs(seed, 64, O_h, alloc_h, rank_h)))
    for seed in range(8):
        cases.append(("largest G=2048 O=4096 N=4096", 4096,
                      scan_inputs(100 + seed, 2048, 4096)))
    for case in ("unplaceable", "cap1", "zero_req", "no_request"):
        for seed in range(2):
            cases.append((f"edge {case} G=64 O=3072 N=512", 512,
                          scan_inputs(200 + seed, 64, O_h, alloc_h, rank_h,
                                      case=case)))
    for seed in range(2):
        # N exhausted: far more pods than 64 slots hold
        cases.append(("edge exhausted G=64 O=3072 N=64", 64,
                      scan_inputs(300 + seed, 64, O_h, alloc_h, rank_h)))
    worst = 0
    summary: dict[str, dict] = {}
    for label, N, inputs in cases:
        err, info = check_scan(dev, label, N, inputs, tally)
        worst = max(worst, err)
        s = summary.setdefault(label, {"runs": 0, "nodes_open": [],
                                       "unplaced": []})
        s["runs"] += 1
        s["nodes_open"].append(info["nodes_open"])
        s["unplaced"].append(info["unplaced"])
        if label.startswith("edge unplaceable") and info["unplaced"] < 37:
            raise AssertionError("unplaceable group was placed")
        if label.startswith("edge exhausted") and not (
                info["nodes_open"] == N and info["unplaced"] > 0):
            raise AssertionError(f"exhaustion case did not exhaust: {info}")
    for label, s in summary.items():
        say(f"kernel check ffd_scan {label}: {s['runs']} runs exact "
            f"(nodes open {s['nodes_open']}, pods unplaced "
            f"{s['unplaced']})")
    return {"max_abs_err": worst, "cases": summary}


def check_fleet_scan(dev, label: str, N: int, meta, compat, alloc, rank,
                     tally: dict) -> tuple[int, dict]:
    """``ffd_scan_fleet`` against its plain version on the card (numpy or
    tensor inputs, [C, ...]); returns (max |diff|, info)."""
    meta, compat, alloc, rank = (
        x if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (meta, compat, alloc, rank))
    got = ffd_kernel.ffd_scan_fleet(meta, compat, alloc, rank, N)
    want = ffd_kernel.ffd_scan_fleet_reference(meta, compat, alloc, rank, N)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        first_diff(f"ffd_scan_fleet {label}", got, want)
    add_to_tally(tally, label, meta, compat, alloc, want, N,
                 group_rank=rank.dim() == 3)
    node_off, _, unplaced = (x.cpu().numpy() for x in want)
    return err, {"nodes_open": (node_off >= 0).sum(axis=1).tolist(),
                 "unplaced": unplaced.sum(axis=1).tolist()}


def stacked_scan_inputs(seeds, G: int, O: int, alloc_np=None, rank_np=None):
    """[C, ...] FFD inputs, one seed per problem; each problem draws its
    own catalog unless one is given."""
    probs = [scan_inputs(s, G, O, alloc_np, rank_np) for s in seeds]
    return tuple(np.stack([p[i] for p in probs]) for i in range(4))


def phase_fleet_kernel_checks(dev, catalog, tally: dict) -> dict:
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    worst = 0
    summary = {}

    # C = 8, eight distinct catalogs at the headline shape: the headline
    # catalog with its offerings shuffled and its prices scaled per problem
    probs = []
    live = catalog.num_offerings
    for c in range(8):
        rng = np.random.RandomState(400 + c)
        perm = rng.permutation(live)
        a_c, r_c = alloc_h.copy(), rank_h.copy()
        a_c[:live], r_c[:live] = alloc_h[perm], rank_h[perm] * np.float32(
            0.8 + 0.4 * rng.rand())
        probs.append(scan_inputs(400 + c, 64, O_h, a_c, r_c))
    meta, compat, alloc, rank = (np.stack([p[i] for p in probs])
                                 for i in range(4))
    if len({a.tobytes() + r.tobytes() for a, r in zip(alloc, rank)}) != 8:
        raise AssertionError("the eight catalogs are not distinct")
    err, info = check_fleet_scan(dev, "C=8 distinct catalogs", 512, meta,
                                 compat, alloc, rank, tally)
    worst = max(worst, err)
    summary["C=8 distinct catalogs G=64 O=3072 N=512"] = info

    # C = 16, the headline catalog expanded over the problems (stride 0):
    # equal to the plain version and to each problem launched on its own
    meta, compat, _, _ = stacked_scan_inputs(range(500, 516), 64, O_h,
                                             alloc_h, rank_h)
    a1 = torch.from_numpy(alloc_h).to(dev)
    r1 = torch.from_numpy(rank_h).to(dev)
    C = meta.shape[0]
    a_exp, r_exp = a1.expand(C, O_h, 4), r1.expand(C, O_h)
    err, info = check_fleet_scan(dev, "C=16 expanded catalog", 512, meta,
                                 compat, a_exp, r_exp, tally)
    worst = max(worst, err)
    m_d = torch.from_numpy(meta).to(dev)
    c_d = torch.from_numpy(compat).to(dev)
    together = ffd_kernel.ffd_scan_fleet(m_d, c_d, a_exp, r_exp, 512)
    for c in range(C):
        one = ffd_kernel.ffd_scan_fleet(m_d[c:c + 1], c_d[c:c + 1],
                                        a1.expand(1, O_h, 4),
                                        r1.expand(1, O_h), 512)
        e = max_abs_err([x[c:c + 1] for x in together], one)
        if e:
            first_diff(f"ffd_scan_fleet C=16 problem {c} alone",
                       [x[c:c + 1] for x in together], one)
    torch.cuda.synchronize()
    summary["C=16 expanded headline catalog G=64 O=3072 N=512 (and one "
            "by one)"] = info

    # distinct catalogs at the largest shape
    meta, compat, alloc, rank = stacked_scan_inputs((600, 601), 2048, 4096)
    err, info = check_fleet_scan(dev, "largest", 4096, meta, compat, alloc,
                                 rank, tally)
    worst = max(worst, err)
    summary["C=2 distinct catalogs G=2048 O=4096 N=4096"] = info
    for label, info in summary.items():
        say(f"kernel check ffd_scan_fleet {label}: exact (nodes open "
            f"{info['nodes_open']}, pods unplaced {info['unplaced']})")
    return {"max_abs_err": worst, "cases": summary}


def ulp_tie_inputs(seed: int, G: int, O: int):
    """``scan_inputs`` with a rank tie that only rounding makes: the
    first group (3 pods, an empty window, so rem = 3) fits two large
    offerings whose ranks are one ulp apart, the higher at index 0, and
    that divide by 3 to the same float but not by their full fit.  The
    capped sweep must take index 0."""
    meta, compat, alloc, rank = scan_inputs(seed, G, O)
    rng = np.random.RandomState(seed)
    three = np.float32(3)
    while True:
        lo = np.float32(rng.rand() * 5 + 0.05)
        hi = np.nextafter(lo, np.float32(np.inf), dtype=np.float32)
        if hi / three == lo / three and hi / np.float32(110) != \
                lo / np.float32(110):
            break
    rank[:2] = (hi, lo)
    rank[2:] = np.maximum(rank[2:], hi * 2)
    alloc[:2] = (63800, 62988, 0, 110)
    meta[0, :6] = (500, 512, 0, 1, 3, FIT_BIG)
    compat[0, :2] = 1
    return meta, compat, alloc, rank


def phase_design_checks(dev, tally: dict) -> dict:
    """The shapes the kernel's design has to get right, each against the
    plain version: ragged O (int32 and uint8 compat; one problem and a
    fleet of three catalogs), N = 8192 at O = 4096 and 5000 (the
    instantiations that read the catalog, or rows and catalog, from
    global memory), G = 0 and G below the ring depth, and the ulp tie."""
    worst = 0
    lines = []

    def one(label, N, inputs, u8=False):
        nonlocal worst
        meta, compat, alloc, rank = inputs
        if u8:
            compat = compat.astype(np.uint8)
        err, info = check_scan(dev, label, N, (meta, compat, alloc, rank),
                               tally)
        worst = max(worst, err)
        lines.append((label, info))
        return info

    for O in (1, 129, 3000):
        for u8 in (False, True):
            one(f"ragged O={O} G=64 N=512 {'uint8' if u8 else 'int32'}",
                512, scan_inputs(700 + O, 64, O), u8)
        meta, compat, alloc, rank = stacked_scan_inputs(
            (710 + O, 711 + O, 712 + O), 64, O)
        for u8 in (False, True):
            label = (f"ragged fleet C=3 O={O} G=64 N=512 "
                     f"{'uint8' if u8 else 'int32'}")
            err, info = check_fleet_scan(
                dev, label, 512, meta,
                compat.astype(np.uint8) if u8 else compat, alloc, rank, tally)
            worst = max(worst, err)
            lines.append((label, info))
    for O in (4096, 5000):
        one(f"N=8192 O={O} G=64", 8192, scan_inputs(720 + O, 64, O))
    for G in (0, 1, 2, 3):
        info = one(f"short G={G} O=3072 N=512", 512,
                   scan_inputs(730 + G, G, 3072))
        if G == 0 and info["nodes_open"]:
            raise AssertionError("G=0 opened nodes")
    tie = ulp_tie_inputs(740, 64, 3072)
    one("ulp tie G=64 O=3072 N=512", 512, tie)
    got = ffd_kernel.ffd_scan(*(torch.from_numpy(x).to(dev)[None]
                                for x in tie[:2]),
                              *(torch.from_numpy(x).to(dev)
                                for x in tie[2:]), 512)
    if int(got[0][0, 0]) != 0:
        raise AssertionError("ulp tie: the first node is not offering 0")
    for label, info in lines:
        say(f"kernel check {label}: exact ({info})")
    return {"max_abs_err": worst, "cases": dict(lines)}


def group_rank(rank_np: np.ndarray, G: int, seed: int) -> np.ndarray:
    """A rank row per group, formed as the pref scan forms it
    (rank * (1 + lambda * miss), lambda 0.5): fractional misses, and some
    groups with no preference (the shared row itself)."""
    rng = np.random.RandomState(seed)
    miss = rng.choice(np.float32([0, 1 / 3, 2 / 3, 1]),
                      size=(G, rank_np.shape[0]))
    miss[rng.rand(G) < 0.3] = 0
    return rank_np[None, :] * (np.float32(1) + np.float32(0.5) * miss)


# (O, N) -> the chain instantiation the per-group form takes there: its
# ring slots hold the group's rank row too where that fits, with the
# catalog or without it, else the rows or nothing (csrc/ffd_scan.cu)
PREF_VARIANTS = {(3072, 512): 3, (4096, 4096): 4, (4096, 8192): 1,
                 (5000, 8192): 0}


def phase_pref_kernel_checks(dev, catalog, tally: dict) -> dict:
    """``ffd_scan`` with a rank row per group against its plain version,
    at one shape per instantiation the per-group form takes
    (``PREF_VARIANTS``: rows, catalog and rank rows staged at the
    headline shape, with its cap = 1 edge; rows and rank rows at N = 4096
    and O = 4096; rows only at N = 8192 and O = 4096; neither at N = 8192
    and O = 5000), each as one problem and as a fleet of three catalogs with
    [C, G, O] ranks; and windows shorter than the ring (G = 1, 2) or not
    a whole number of its slots (G = 7, 63), single and fleet."""
    for (O, N), v in PREF_VARIANTS.items():
        got = ffd_kernel.scan_variant(O, N, group_rank=True)
        if got != ffd_kernel.VARIANTS[v]:
            raise AssertionError(f"per-group form at O={O} N={N}: '{got}', "
                                 f"want '{ffd_kernel.VARIANTS[v]}'")
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    cases = []
    for seed in range(4):
        for case in ("", "cap1"):
            cases.append((f"pref G=64 O=3072 N=512 {case}".strip(), 512,
                          scan_inputs(800 + seed, 64, O_h, alloc_h, rank_h,
                                      case=case)))
    for O, N in PREF_VARIANTS:
        if O != O_h:
            cases.append((f"pref N={N} O={O} G=64", N,
                          scan_inputs(820 + O + N, 64, O)))
    for G in (1, 2, 7, 63):
        cases.append((f"pref short G={G} O=3072 N=512", 512,
                      scan_inputs(840 + G, G, O_h, alloc_h, rank_h)))
    worst = 0
    for k, (label, N, (meta, compat, alloc, rank)) in enumerate(cases):
        err, info = check_scan(dev, label, N, (
            meta, compat, alloc, group_rank(rank, meta.shape[0], k)),
            tally["pref"])
        worst = max(worst, err)
        say(f"kernel check ffd_scan, a rank row per group, {label}: exact "
            f"({info}, '{ffd_kernel.scan_variant(compat.shape[-1], N, True)}"
            f"')")
    fleets = [(f"pref fleet C=3 G=64 O={O} N={N}", 64, O, N)
              for O, N in PREF_VARIANTS]
    fleets += [(f"pref fleet short C=3 G={G} O=3072 N=512", G, O_h, 512)
               for G in (1, 7)]
    for k, (label, G, O, N) in enumerate(fleets):
        meta, compat, alloc, rank = stacked_scan_inputs(
            range(860 + 3 * k, 863 + 3 * k), G, O)
        ranks = np.stack([group_rank(r, G, 50 + 3 * k + c)
                          for c, r in enumerate(rank)])
        err, info = check_fleet_scan(dev, label, N, meta, compat, alloc,
                                     ranks, tally["pref"])
        worst = max(worst, err)
        say(f"kernel check ffd_scan_fleet, a rank row per group, {label}: "
            f"exact ({info})")
    return {"max_abs_err": worst, "cases": len(cases) + len(fleets)}


def require_design_coverage(tally: dict) -> dict:
    """Every instantiation of the chain kernel ran in the checks, and
    the uncapped branch, the capped branch and the summed takes of its
    step; with a rank row per group, every instantiation and the
    uncapped and capped branches."""
    out = {}
    for form, t, need, variants in (
            ("shared rank", tally, ("uncapped", "capped", "summed_takes"),
             ffd_kernel.SHARED_ROW_VARIANTS),
            ("rank row per group", tally["pref"], ("uncapped", "capped"),
             ffd_kernel.GROUP_RANK_VARIANTS)):
        b, v = t["branches"], t["variants"]
        say(f"chain branches over the kernel checks, {form} (host count "
            f"from the plain outputs): {b}")
        for variant, labels in v.items():
            say(f"chain instantiation '{variant}', {form}: {len(labels)} "
                f"checked scans, e.g. {labels[0]!r}")
        if min(b[k] for k in need) <= 0:
            raise AssertionError(f"a branch of the chain never ran ({form}):"
                                 f" {b}")
        missing = set(variants) - set(v)
        if missing:
            raise AssertionError(f"instantiations never checked ({form}): "
                                 f"{missing}")
        out[form] = {"branches": dict(b),
                     "variants": {k: len(x) for k, x in v.items()}}
    return out


# -- phase 4: the main path ---------------------------------------------------


def phase_main_path(dev, pods, catalog, tally: dict):
    solver = TorchSolver(device=dev)
    request = SolveRequest(pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan", "cost_sum"], "main path")
    if stats["path"] != solver.path:          # "ffd-cuda" on the card
        raise AssertionError(f"main path took {stats['path']!r}")
    clean_and_placed("main path", plan, pods, catalog)
    say(f"main path: {len(plan.nodes)} nodes, {plan.placed_count} pods "
        f"placed, {len(plan.unplaced_pods)} unplaced, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
        f"G={stats['G']} O={stats['O']} N={stats['N']}, launches "
        f"{launches}, validate_plan clean, cold solve {cold_s * 1e3:.3f} ms")

    # the card's packed result against the plain solve on the CPU
    problem = encode_mod.encode(pods, catalog)
    prep = solver._prepare(problem)
    card = solver.dispatch_packed(prep).cpu().numpy()
    cpu_cat = [t.cpu() for t in solver.device_offerings(catalog,
                                                        prep.O_pad)]
    plain = tp.solve_packed_torch(
        torch.from_numpy(prep.packed.copy()), *cpu_cat, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, right_size=True,
        compact=prep.K, dense16=prep.dense16, coo16=prep.coo16).numpy()
    c_card, c_cpu = words_equal("main path", card, plain,
                                prep.N + prep.G_pad)
    say(f"main path result buffer: {card.shape[0]} words equal to the "
        f"plain CPU solve (cost {c_card} vs {c_cpu})")
    # the kernel on the window's own unpacked tensors, against its plain
    # version on the card
    off_alloc, _, off_rank = solver.device_offerings(catalog, prep.O_pad)
    packed = torch.from_numpy(prep.packed).to(dev)
    meta, compat_i, _ = tp.unpack_problem(packed, off_alloc, prep.G_pad,
                                          prep.O_pad, prep.U_pad)
    err, info = check_scan(dev, "main-path window", prep.N,
                           (meta, compat_i, off_alloc, off_rank), tally)
    say(f"kernel check ffd_scan on the main-path window G={prep.G_pad} "
        f"O={prep.O_pad} N={prep.N}: exact ({info})")
    return solver, request, problem, launches, stats, cold_s, err


def build_fleet():
    """BASELINE config #5 as bench.py builds it: FLEET["clusters"]
    clusters, each ``build_workload(pods, types, seed=seed0 + c)`` with
    its own catalog, padded to common buckets and stacked.  Returns the
    stacked problem, the per-cluster (pods, catalog, problem), and the
    node axis sized by ``estimate_nodes`` with its cap."""
    encode = encode_mod.encode
    clusters = []
    for c in range(FLEET["clusters"]):
        pods, catalog = workload.build_workload(
            FLEET["pods"], FLEET["types"], seed=FLEET["seed0"] + c)
        clusters.append((pods, catalog, encode(pods, catalog)))
    G = max(bucket(p.num_groups, GROUP_BUCKETS) for _, _, p in clusters)
    O = max(bucket(cat.num_offerings, OFFERING_BUCKETS)
            for _, cat, _ in clusters)
    per = [(_pad2(p.group_req, G), _pad1(p.group_count, G),
            _pad1(p.group_cap, G), _pad2(p.compat, G, O),
            _pad2(cat.offering_alloc().astype(np.int32), O),
            _pad1(cat.off_price.astype(np.float32), O),
            _pad1(cat.offering_rank_price(), O))
           for _, cat, p in clusters]
    stacked = FleetProblem(*[np.stack([x[i] for x in per])
                             for i in range(7)])
    N_cap = bucket(FLEET["pods"], NODE_BUCKETS)
    N = max(encode_mod.estimate_nodes(p, N_cap, NODE_BUCKETS)
            for _, _, p in clusters)
    return stacked, clusters, N, N_cap


def phase_fleet(dev) -> dict:
    """(b) The fleet through ``fleet_solve_packed`` on the card; every
    cluster's plan decodes and validates clean; the card's [C, Lo]
    result equals the plain CPU fleet program word for word."""
    t0 = time.perf_counter()
    stacked, clusters, N, N_cap = build_fleet()
    build_s = time.perf_counter() - t0
    C, G, O = stacked.compat.shape
    dev_catalog = fleet_device_catalog(stacked, dev)
    packed = fleet_pack_inputs(stacked)
    reset_launches()
    t0 = time.perf_counter()
    while True:
        out = fleet_solve_packed(stacked, num_nodes=N, device=dev,
                                 device_catalog=dev_catalog,
                                 packed_inputs=packed)
        if (out[2] == 0).all() or N >= N_cap:
            break
        N = min(N_cap, bucket(N * 4, NODE_BUCKETS))    # escalate, as bench
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"], "fleet path")
    node_off, assign, unplaced, cost = out
    if unplaced.sum():
        raise AssertionError(f"fleet left {int(unplaced.sum())} pods "
                             f"unplaced at N={N}")
    nodes = []
    for c, (pods, catalog, problem) in enumerate(clusters):
        plan = encode_mod.decode_plan(problem, node_off[c], assign[c],
                                      unplaced[c], float(cost[c]), "torch")
        clean_and_placed(f"fleet cluster {c}", plan, pods, catalog)
        nodes.append(len(plan.nodes))

    ins, U = packed
    kw = dict(C=C, G=G, O=O, U=U, N=N)
    card = tp.fleet_packed_torch(torch.from_numpy(ins).to(dev),
                                 *dev_catalog, **kw).cpu().numpy()
    plain = tp.fleet_packed_torch(torch.from_numpy(ins),
                                  *(t.cpu() for t in dev_catalog),
                                  **kw).numpy()
    for c in range(C):
        words_equal(f"fleet cluster {c}", card[c], plain[c], N + G)
    say(f"fleet path: {C} clusters x {FLEET['pods']} pods (each its own "
        f"catalog, G={G} O={O} U={U} N={N}), every pod placed, nodes per "
        f"cluster {nodes}, total cost {float(cost.sum()):.4f} $/h, "
        f"validate_plan clean per cluster, launches {launches}; [C, Lo] = "
        f"{list(card.shape)} equal to the plain CPU fleet program word for "
        f"word (cost words included); build+encode {build_s:.3f} s, cold "
        f"fleet solve {cold_s * 1e3:.3f} ms")
    return {"stacked": stacked, "N": N, "U": U, "packed": packed,
            "dev_catalog": dev_catalog, "launches": launches,
            "nodes": nodes, "cold_s": cold_s}


def stream_windows(catalog):
    """STREAM["distinct"] headline-size windows (seeds seed0...) encoded
    against one catalog, so that they can share a batch."""
    out = []
    for i in range(STREAM["distinct"]):
        pods, _ = workload.build_workload(
            HEADLINE["pods"], HEADLINE["types"], seed=STREAM["seed0"] + i)
        out.append((pods, encode_mod.encode(pods, catalog)))
    return out


def phase_stream(dev, catalog) -> dict:
    """(c) ``solve_stream`` of STREAM["windows"] windows at depth 32,
    batch 16: each plan equal to its window's single-window plan, clean,
    every pod placed."""
    windows = stream_windows(catalog)
    solver = TorchSolver(device=dev)
    singles = [solver.solve_encoded(p) for _, p in windows]
    n = STREAM["windows"]
    order = [i % len(windows) for i in range(n)]
    reset_launches()
    t0 = time.perf_counter()
    plans = list(solver.solve_stream((windows[i][1] for i in order),
                                     depth=STREAM["depth"],
                                     batch=STREAM["batch"]))
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"],
                     "stream path")
    if stats["path"] != solver.path + "-batch" or len(plans) != n:
        raise AssertionError(f"stream: path {stats['path']!r}, "
                             f"{len(plans)} plans of {n}")
    for k, (i, plan) in enumerate(zip(order, plans)):
        plans_equal(f"stream window {k}", plan, singles[i])
        clean_and_placed(f"stream window {k}", plan, windows[i][0], catalog)
    say(f"stream path: {n} windows ({len(windows)} distinct, seeds "
        f"{STREAM['seed0']}..{STREAM['seed0'] + len(windows) - 1}) at depth "
        f"{STREAM['depth']}, batch {STREAM['batch']}: every plan equal to "
        f"its single-window plan, validate_plan clean, every pod placed; "
        f"path {stats['path']}, batch {stats['batch']} (padded "
        f"{stats['batch_pad']}), launches {launches}, first run "
        f"{wall_s * 1e3:.3f} ms")
    return {"solver": solver, "windows": windows, "order": order,
            "launches": launches, "first_wall_s": wall_s}


def zone_window(pods):
    """The headline pods plus ZONE["apps"] co-scheduled apps, each pod
    with a self PodAffinityTerm on the zone key."""
    extra = []
    for a in range(ZONE["apps"]):
        app = (("app", f"za{a}"),)
        extra += [pod_api.PodSpec(
            f"za{a}-{i}", requests=pod_api.ResourceRequests(1000, 2048, 0, 1),
            affinity=(pod_api.PodAffinityTerm(app, LABEL_ZONE),),
            labels=app) for i in range(ZONE["pods"])]
    return list(pods) + extra


def phase_zone(dev, pods, catalog) -> dict:
    """(d) A zone-candidate window: the plan equals the CPU solver's, is
    clean, places every pod, and its candidate rounds ran as batches."""
    zpods = zone_window(pods)
    request = SolveRequest(zpods, catalog)
    solver = TorchSolver(device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan", "ffd_scan_fleet", "cost_sum"],
                     "zone-candidate path")
    if stats["path"] != solver.path + "-batch":
        raise AssertionError(f"zone-candidate rounds took {stats['path']!r}"
                             f", not solve_encoded_batch")
    plans_equal("zone-candidate window", plan,
                TorchSolver(device="cpu").solve(request))
    clean_and_placed("zone-candidate window", plan, zpods, catalog)
    say(f"zone-candidate path: {len(zpods)} pods ({ZONE['apps']} apps x "
        f"{ZONE['pods']} zone-affine pods), {len(plan.nodes)} nodes, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, equal to the CPU solver's "
        f"plan, validate_plan clean; last candidate round a batch of "
        f"{stats['batch']} (padded {stats['batch_pad']}), launches "
        f"{launches}, solve {wall_s * 1e3:.3f} ms")
    return {"launches": launches, "wall_s": wall_s,
            "last_batch": stats["batch"]}


# -- phase 4 (e-g): the routes the default dispatch takes on its own --------


def warm_walls(solver, request, n: int = ROUTE_WARM) -> list[float]:
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
    return walls


def route_run(dev, label: str, route: str, request, need=()):
    """The window through ``TorchSolver(device=dev).solve`` with the launch
    counts reset just before and read just after, and once through the
    CPU solver: (solver, plan, cpu plan, launches, stats, cold s, cpu s).
    The card's plan must equal the CPU's and name the route and the
    card; the kernels in ``need`` must have run, and no other."""
    solver = TorchSolver(device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    if need:
        require_launches(launches, need, label)
    require_no_launches({k: v for k, v in launches.items() if k not in need},
                        label)
    if stats["path"] != f"{route}-cuda":
        raise AssertionError(f"{label} took {stats['path']!r}")
    t0 = time.perf_counter()
    cpu_plan = TorchSolver(device="cpu").solve(request)
    cpu_s = time.perf_counter() - t0
    plans_equal(label, plan, cpu_plan)
    return solver, plan, cpu_plan, launches, stats, cold_s, cpu_s


def top_device_ops(run, n: int = 8) -> list | None:
    """The ``n`` PyTorch ops of one call of ``run`` with the most device
    time of their own, from ``torch.profiler``: [(op, calls, device
    ms)], or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("aten::")]
    rows.sort(key=lambda r: -r[2])
    if not rows or rows[0][2] <= 0:
        return None
    return rows[:n]


def route_timings(dev, card: str, label: str, solver, request, program,
                  reps: int, spans: int, tag: str) -> dict:
    """p50 warm wall over ROUTE_WARM windows, the device program's CUDA
    event time (``program`` run back to back), kernels per window and
    device busy share from ``torch.profiler``, and the ops of one window
    with the most device time."""
    walls = warm_walls(solver, request)
    p50 = float(np.percentile(walls, 50)) * 1e3
    dev_ms = cuda_ms(program, reps, warm=1)
    prof = profile_spans(lambda: solver.solve(request), spans, tag)
    top = top_device_ops(lambda: solver.solve(request))
    say(f"timing [{card}]: {label}: p50 wall of {ROUTE_WARM} warm windows "
        f"{p50:.4f} ms (min {min(walls) * 1e3:.4f}, max "
        f"{max(walls) * 1e3:.4f}); device program back to back {dev_ms:.4f}"
        f" ms (CUDA events, {reps} runs)")
    if prof is None:
        say(f"profile [{card}]: {label}: torch.profiler recorded no device "
            f"events; kernels per window not measured")
    else:
        say(f"profile [{card}]: {label}: {prof['spans']} warm windows under "
            f"torch.profiler: {prof['kernels_per_span']:.1f} kernels per "
            f"window; device busy {prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled window (busy share "
            f"{prof['device_busy_share']:.4f})")
    if top is None:
        say(f"profile [{card}]: {label}: device time per op not measured")
    else:
        say(f"profile [{card}]: {label}: ops with the most device time in "
            f"one window: " + ", ".join(f"{k} x{c} {ms:.4f} ms"
                                        for k, c, ms in top))
    return {"p50_wall_ms": p50, "walls_ms": [w * 1e3 for w in walls],
            "device_program_ms": dev_ms, "profile": prof,
            "top_device_ops": top}


def flat_inputs(tmpl, dev):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (tmpl.item_req, tmpl.item_gid, tmpl.item_live,
                      tmpl.rows, tmpl.item_row, tmpl.miss_rows)]


def flat_program(tmpl, inputs, catalog_t, N: int):
    """``flat_solve_torch`` of a template on given inputs (the catalog
    tensors: off_alloc, off_price, off_rank)."""
    off_alloc, off_price, off_rank = catalog_t
    item_req, item_gid, item_live, rows, item_row, miss_rows = inputs
    return flat_mod.flat_solve_torch(
        item_req, item_gid, item_live, rows, item_row, off_alloc, off_rank,
        miss_rows, off_price, I=tmpl.I_pad, O=tmpl.O_pad, G=tmpl.G_pad, N=N,
        K=tmpl.K, U=tmpl.U_pad, slim=tmpl.slim)


def phase_flat(dev, card: str) -> dict:
    """(e) The flat regime: both FLAT_WINDOWS through ``solve`` on the
    card (segment_sum launched, no FFD kernel), each plan equal to the
    CPU solver's, clean, every pod placed; the card's raw result equal to
    the plain CPU program word for word.  Then the segment-sum kernel
    against its plain version on every call the program made."""
    windows, calls = [], []
    for w in FLAT_WINDOWS:
        label = f"flat window (seed {w['seed']}" + (
            f", {w['constrained_frac']:.0%} constrained, "
            f"{w['pref_frac']:.0%} preferences)" if len(w) > 1 else ")")
        pods, catalog = workload.build_hetero_workload(
            HEADLINE["pods"], HEADLINE["types"], **w)
        request = SolveRequest(pods, catalog)
        solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
            dev, label, "flat", request, need=("segment_sum", "cost_sum"))
        clean_and_placed(label, plan, pods, catalog)
        problem = encode_mod.encode(pods, catalog)
        tmpl = flat_mod.flat_template(solver, problem)
        dev_cat = solver.device_offerings(catalog, tmpl.O_pad)
        cpu_cat = [t.cpu() for t in dev_cat]
        dev_in = flat_inputs(tmpl, dev)
        card_out, info = flat_program(tmpl, dev_in, dev_cat, stats["N"])
        plain_out, _ = flat_program(tmpl, flat_inputs(tmpl, "cpu"), cpu_cat,
                                    stats["N"])
        cost_word = (stats["N"] // 2 + tmpl.G_pad // 2) if tmpl.slim \
            else stats["N"] + tmpl.G_pad
        c_card, c_cpu = words_equal(label, card_out.cpu().numpy(),
                                    plain_out.numpy(), cost_word)
        say(f"{label}: G={problem.num_groups} (padded {stats['G']}) "
            f"I={stats['I']} O={stats['O']} U={stats['U']} N={stats['N']} "
            f"K={stats['K']} slim={stats['slim']}: {len(plan.nodes)} nodes, "
            f"{plan.placed_count} pods placed, cost "
            f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
            f"launches {launches}, {stats['rounds']} rounds, "
            f"{stats['host_syncs']} host syncs per window, "
            f"{stats['escalations']} escalations; plan equal to the CPU "
            f"solver's, validate_plan clean; result buffer "
            f"{card_out.shape[0]} words equal to the plain CPU program "
            f"(cost {c_card} vs {c_cpu}); cold solve {cold_s * 1e3:.3f} ms, "
            f"CPU solve {cpu_s * 1e3:.3f} ms")
        # every segment sum of one program run, for the kernel check
        orig = flat_mod.segment_sum
        before = len(calls)

        def record(v, s, S, orig=orig):
            calls.append((v.clone(), s.clone(), S))
            return orig(v, s, S)

        flat_mod.segment_sum = record
        try:
            flat_program(tmpl, dev_in, dev_cat, stats["N"])
        finally:
            flat_mod.segment_sum = orig
        say(f"{label}: {len(calls) - before} segment_sum calls in one "
            f"window (" + ", ".join(f"[{v.shape[0]}, {v.shape[1]}] -> {S}"
                                    for v, _, S in calls[before:]) + ")")
        t = route_timings(
            dev, card, label, solver, request,
            lambda: flat_program(tmpl, dev_in, dev_cat, stats["N"]), 10, 5,
            "flat_window")
        t.update(segment_sum_calls=len(calls) - before,
                 host_syncs=stats["host_syncs"], rounds=stats["rounds"],
                 cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
                 launches=launches, nodes=len(plan.nodes),
                 shape={k: stats[k] for k in ("G", "I", "O", "U", "N", "K")},
                 groups=problem.num_groups, cost=plan.total_cost_per_hour)
        windows.append(t)
    return {"windows": windows, "segment_sum": segment_sum_checks(calls,
                                                                  card),
            "launches": {k: sum(w["launches"][k] for w in windows)
                         for k in windows[0]["launches"]}}


def segment_sum_checks(calls, card: str) -> dict:
    """``segment_sum`` against its plain version (index-order adds on the
    CPU) on every call the flat program made, bit for bit.  On every call
    the wrapper's time back to back beside ``index_add_`` (the PyTorch
    call for the same sums, in atomic order; medians of rounds taken in
    turns) and the kernel's device time alone, with the call's kept rows
    and longest segment (the chain of dependent adds that sets the
    kernel's time); on the largest call also the device kernels per call
    (``torch.profiler``, exact), the plain version and the bound."""
    err = 0.0
    rows = []
    for v, s, S in calls:
        got = segment_sum.segment_sum(v, s, S)
        want = segment_sum.segment_sum_reference(v, s, S)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            diff = (got - want).abs()
            raise AssertionError(f"segment_sum differs from its plain "
                                 f"version on [{v.shape[0]}, {v.shape[1]}] "
                                 f"-> {S}: max |diff| {float(diff.max())}")
        err = max(err, float((got - want).abs().max()))
        keep = (s >= 0) & (s < S)
        kept = int(keep.sum())
        longest = int(torch.bincount(s[keep].long()).max()) if kept else 0
        call = lambda v=v, s=s, S=S: segment_sum.segment_sum(  # noqa: E731
            v, s, S)
        # index_add_ takes no id outside its rows: dropped ids go to a
        # spare row S (mapped before the timing), as the flat program's
        # sentinel did
        idx = torch.where(keep, s, S).long()
        paired = paired_ms({"kernel": call, "index_add_": lambda v=v, S=S,
                            idx=idx: torch.zeros(
                                (S + 1, v.shape[1]),
                                device=v.device).index_add_(0, idx, v)}, 50)
        rows.append({"shape": [v.shape[0], v.shape[1], S], "kept_rows": kept,
                     "longest_segment": longest, "ms": paired["kernel"],
                     "library_ms": paired["index_add_"],
                     "device_ms": kernel_device_ms(call,
                                                   "segment_sum_kernel")})
    say(f"timing [{card}]: segment_sum on each call of the flat program "
        f"(wrapper back to back / index_add_ in turns / kernel device time "
        f"alone): " + "; ".join(
            f"[{r['shape'][0]}, {r['shape'][1]}] -> {r['shape'][2]}, "
            f"{r['kept_rows']} rows kept, longest segment "
            f"{r['longest_segment']}: {r['ms']:.4f} / {r['library_ms']:.4f}"
            f" / {r['device_ms']:.4f} ms" for r in rows))
    at = max(range(len(calls)),
             key=lambda i: (calls[i][0].shape[0], calls[i][2]))
    v, s, S = calls[at]
    big = rows[at]
    call = lambda: segment_sum.segment_sum(v, s, S)  # noqa: E731
    ms, lib_ms, device_ms = big["ms"], big["library_ms"], big["device_ms"]
    per_call = kernels_per_call(call, "segment_sum_call",
                                segment_sum.LAUNCHES, "segment_sum")
    if per_call > 2:
        raise AssertionError(f"segment_sum issues {per_call} device "
                             f"kernels per call (at most 2)")
    plain_ms = cuda_ms(lambda: segment_sum.segment_sum_reference(v, s, S), 5,
                       warm=1)
    # what this call's data needs: every id, the rows that are kept, the
    # output; one add per kept value
    kept = big["kept_rows"]
    nbytes = s.numel() * s.element_size() + kept * v.shape[1] * 4 \
        + S * v.shape[1] * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kept * v.shape[1] / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"kernel check segment_sum: {len(calls)} calls of the flat program, "
        f"exact against the plain version; timing [{card}]: "
        f"[{v.shape[0]}, {v.shape[1]}] -> {S} segments ({kept} rows kept, "
        f"longest segment {big['longest_segment']}): wrapper {ms:.4f} ms "
        f"back to back, kernel device time alone {device_ms:.4f} ms, "
        f"{per_call} device kernels per call, plain version "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms (wrapper / index_add_ "
        f"x{ms / lib_ms:.3f}), bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes)")
    return {"calls": len(calls), "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "kernels_per_call": per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "kept_rows": kept,
            "longest_segment": big["longest_segment"],
            "shape": [v.shape[0], v.shape[1], S], "by_call": rows}


def packed_route_check(dev, label: str, solver, problem, program_of):
    """The card's packed result of a window against the CPU solver's on
    the same template, word for word (the cost word too); returns the device
    program (a zero-argument callable on the card's tensors) for timing,
    and the prepared shapes."""
    prep = solver._prepare(problem)
    card = solver.dispatch_packed(prep).cpu().numpy()
    cpu_solver = TorchSolver(device="cpu")
    cpu_prep = cpu_solver._prepare(problem)
    plain = cpu_solver.dispatch_packed(cpu_prep).numpy()
    c_card, c_cpu = words_equal(label, card, plain, prep.N + prep.G_pad)
    say(f"{label}: result buffer {card.shape[0]} words equal to the plain "
        f"CPU program (cost {c_card} vs {c_cpu})")
    return program_of(prep), prep, card


def phase_affinity(dev, card: str) -> dict:
    """(f) The affinity plane: the bench's 10k-pod window through
    ``solve`` on the card (the affinity scan, no hand kernel), the plan
    equal to the CPU solver's, clean under validate_plan and
    validate_affinity_plan, with the CPU's placed count; the raw result
    equal to the plain CPU program word for word."""
    label = "affinity window"
    catalog = workload.build_catalog(HEADLINE["types"])
    pods = workload.affinity_bench_pods(
        AFFINITY["tag"], HEADLINE["pods"],
        np.random.RandomState(AFFINITY["rng_seed"]))
    request = SolveRequest(pods, catalog)
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "affinity", request, need=("cost_sum",))
    clean_and_placed(label, plan, pods, catalog,
                     placed=cpu_plan.placed_count)
    errors = validate_affinity_plan(plan, pods)
    if errors:
        raise AssertionError(f"{label}: validate_affinity_plan: "
                             f"{errors[:5]}")
    problem = encode_mod.encode(pods, catalog)
    if problem.aff is None or not problem.aff.device_armed:
        raise AssertionError(f"{label} does not arm the affinity lane")

    def program_of(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        packed = torch.from_numpy(prep.packed).to(dev)
        aff = torch.from_numpy(prep.aff).to(dev)
        return lambda: solve_packed_affinity(
            packed, aff, off_alloc, off_price, off_rank, G=prep.G_pad,
            O=prep.O_pad, U=prep.U_pad, N=prep.N)

    program, prep, _ = packed_route_check(dev, label, solver, problem,
                                          program_of)
    say(f"{label}: G={problem.num_groups} (padded {prep.G_pad}) "
        f"O={prep.O_pad} N={prep.N}, {problem.aff.edge_count} edges: "
        f"{len(plan.nodes)} nodes, {plan.placed_count} placed, "
        f"{len(plan.unplaced_pods)} unplaced (as on the CPU), cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, launches "
        f"{launches}; plan equal to the CPU solver's, validate_plan and "
        f"validate_affinity_plan clean; cold solve {cold_s * 1e3:.3f} ms, "
        f"CPU solve {cpu_s * 1e3:.3f} ms")
    t = route_timings(dev, card, label, solver, request, program, 3, 2,
                      "affinity_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             placed=plan.placed_count, unplaced=len(plan.unplaced_pods),
             shape={"G": prep.G_pad, "O": prep.O_pad, "N": prep.N},
             groups=problem.num_groups, cost=plan.total_cost_per_hour)
    return t


def phase_stochastic(dev, card: str) -> dict:
    """(g) The stochastic plane: run_stochastic's 10k-pod menu on an
    overcommitting pool through ``solve`` on the card (the chance scan,
    no hand kernel), the plan equal to the CPU solver's, clean under the
    chance rule, every pod placed; the raw result equal to the plain CPU
    program word for word."""
    label = "stochastic window"
    catalog = workload.build_catalog(HEADLINE["types"])
    pods = workload.stochastic_pods(HEADLINE["pods"],
                                    seed=STOCHASTIC["seed"])
    pool = NodePool(name="default", overcommit=STOCHASTIC["overcommit"])
    request = SolveRequest(pods, catalog, pool)
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "stochastic", request, need=("cost_sum",))
    clean_and_placed(label, plan, pods, catalog, pool)
    problem = encode_mod.encode(pods, catalog, pool)

    def program_of(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        packed = torch.from_numpy(prep.packed).to(dev)
        sto = torch.from_numpy(prep.sto).to(dev)
        kd, kc = solver._fit_grids(prep, sto, off_alloc)
        return lambda: solve_packed_stochastic(
            packed, sto, kd, kc, off_alloc, off_price, off_rank,
            G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
            z_bp=prep.z_bp)

    program, prep, _ = packed_route_check(dev, label, solver, problem,
                                          program_of)
    say(f"{label}: G={problem.num_groups} (padded {prep.G_pad}) "
        f"O={prep.O_pad} N={prep.N}, z_bp={prep.z_bp}: {len(plan.nodes)} "
        f"nodes, {plan.placed_count} pods placed, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, launches "
        f"{launches}; plan equal to the CPU solver's, validate_plan (chance "
        f"rule) clean; cold solve {cold_s * 1e3:.3f} ms, CPU solve "
        f"{cpu_s * 1e3:.3f} ms")
    t = route_timings(dev, card, label, solver, request, program, 3, 2,
                      "stochastic_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             placed=plan.placed_count,
             shape={"G": prep.G_pad, "O": prep.O_pad, "N": prep.N},
             groups=problem.num_groups, cost=plan.total_cost_per_hour)
    return t


# -- phase 4 (h-k): soft preferences, the resident store, the serving loop --


def fractional_groups_per_node(prep, out_np: np.ndarray) -> int:
    """Most groups with a fractional miss (0 < miss < 1 somewhere) that
    one open node of a pref window's result holds."""
    _, assign, _, _ = unpack_result(out_np, prep.G_pad, prep.N, prep.K,
                                    prep.dense16, prep.coo16)
    idx = prep.pref_idx
    rows = prep.pref_rows[np.clip(idx, 0, None)]
    frac = (idx >= 0) & ((rows > 0) & (rows < 1)).any(axis=1)
    return int(((assign > 0) & frac[:, None]).sum(axis=0).max())


def phase_pref(dev, card: str, tally: dict) -> dict:
    """(h) The pref window: the headline pods with soft preferences
    (``workload.with_preferences``) through ``solve`` on the card, the FFD
    kernel with a rank row per group; the plan equal to the CPU solver's
    and clean, the raw result equal to the plain CPU program word for
    word, a node holding three or more groups with fractional misses;
    the kernel on the window's tensors against its plain version; the
    route's timings, the kernel beside its shared-rank form and the pref
    right-size beside the plain one."""
    label = "pref window"
    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    pods = workload.with_preferences(pods)
    request = SolveRequest(pods, catalog)
    problem = encode_mod.encode(pods, catalog)
    gate = SolverOptions().flat_min_groups
    if problem.pref_rows is None or problem.num_groups >= gate:
        raise AssertionError(f"{label}: G={problem.num_groups} (flat gate "
                             f"{gate}), preferences "
                             f"{problem.pref_rows is not None}")
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "pref", request,
        need=("ffd_scan_pref", "presence_sum", "cost_sum"))
    clean_and_placed(label, plan, pods, catalog)
    lam_bp = int(solver.options.preference_lambda * 10000)

    def tensors(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        return (torch.from_numpy(prep.packed).to(dev),
                torch.from_numpy(prep.pref_rows).to(dev),
                torch.from_numpy(prep.pref_idx).to(dev), off_alloc,
                off_price, off_rank)

    def program_of(prep):
        args = tensors(prep)
        return lambda: tp.solve_packed_pref_torch(
            *args, G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
            P=prep.pref_rows.shape[0], lam_bp=lam_bp)

    program, prep, card_out = packed_route_check(dev, label, solver,
                                                 problem, program_of)
    shared = fractional_groups_per_node(prep, card_out)
    if shared < 3:
        raise AssertionError(f"{label}: no node holds three groups with "
                             f"fractional misses (at most {shared})")
    G, O, U, N = prep.G_pad, prep.O_pad, prep.U_pad, prep.N
    packed, pref_rows, pref_idx, off_alloc, off_price, off_rank = \
        tensors(prep)
    meta, compat_i, _ = tp.unpack_problem(packed, off_alloc, G, O, U)
    lam = lam_bp / 10000.0
    miss_g, rank_g = tp.pref_rank_rows(pref_rows, pref_idx, off_rank, lam)
    err, info = check_scan(dev, label, N, (meta, compat_i, off_alloc,
                                           rank_g), tally["pref"])
    say(f"{label}: G={problem.num_groups} (padded {G}) O={O} U={U} N={N} "
        f"P={prep.pref_rows.shape[0]}: {len(plan.nodes)} nodes, "
        f"{plan.placed_count} pods placed, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
        f"launches {launches}; up to {shared} groups with fractional misses "
        f"on one node; plan equal to the CPU solver's, validate_plan clean; "
        f"kernel check on the window's tensors exact ({info}); cold solve "
        f"{cold_s * 1e3:.3f} ms, CPU solve {cpu_s * 1e3:.3f} ms")

    # the kernel with its rank rows beside the same scan on the shared
    # row, in turns; the capped sweeps of each (the steps that read the
    # rank row on the chain) from the plain outputs
    m3, c3 = meta[None].contiguous(), compat_i[None].contiguous()
    out_pref = ffd_kernel.ffd_scan(m3, c3, off_alloc, rank_g, N)
    out_shared = ffd_kernel.ffd_scan(m3, c3, off_alloc, off_rank, N)
    node_off, assign, _ = (x[0] for x in out_pref)
    branches = ffd_kernel.chain_branches(m3, c3, off_alloc, *out_pref)
    shared_branches = ffd_kernel.chain_branches(m3, c3, off_alloc,
                                                *out_shared)
    variant = ffd_kernel.scan_variant(O, N, group_rank=True)
    turns = paired_ms({
        "pref": lambda: ffd_kernel.ffd_scan(m3, c3, off_alloc, rank_g, N),
        "shared": lambda: ffd_kernel.ffd_scan(m3, c3, off_alloc, off_rank,
                                              N)}, 20)
    ms, shared_ms = turns["pref"], turns["shared"]
    capped = branches["capped"]
    extra_us = (ms - shared_ms) * 1e3 / capped if capped else None
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        m3, c3, off_alloc, rank_g, N), 3, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        m3, c3, off_alloc, rank_g, N, assign.cpu().numpy()[None],
        node_off.cpu().numpy()[None])
    rs_pref_ms = cuda_ms(lambda: tp.cost_word(tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True,
        miss_g=miss_g, pref_lambda=lam), off_price), 20)
    rs_ms = cuda_ms(lambda: tp.cost_word(tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True),
        off_price), 20)
    rank_ms = cuda_ms(lambda: tp.pref_rank_rows(pref_rows, pref_idx,
                                                off_rank, lam), 50)
    extra_txt = "no capped step" if extra_us is None \
        else f"{extra_us:.4f} us per capped step"
    say(f"ffd_scan_pref on the pref window: chain instantiation "
        f"'{variant}'; chain branches (host count from the outputs) "
        f"{branches}, {capped} capped sweeps; the shared-row scan's "
        f"{shared_branches}")
    say(f"timing [{card}]: ffd_scan_pref on the pref window G={G} O={O} "
        f"N={N}: kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group step), "
        f"the same scan on the shared rank row {shared_ms:.4f} ms (x"
        f"{ms / shared_ms:.4f}, medians of 5 rounds of 20 in turns; "
        f"{extra_txt} over the shared row), plain PyTorch version "
        f"{plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, {ops} scalar "
        f"ops); forming rank_g {rank_ms:.4f} ms; right-size + cost with "
        f"preferences {rs_pref_ms:.4f} ms against {rs_ms:.4f} ms without; "
        f"no single PyTorch call computes the scan (library_ms null)")
    psum = presence_sum_checks(dev, card, (assign > 0).to(torch.float32),
                               miss_g)
    t = route_timings(dev, card, label, solver, request, program, 10, 5,
                      "pref_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             shape={"G": G, "O": O, "U": U, "N": N,
                    "P": prep.pref_rows.shape[0]},
             groups=problem.num_groups, cost=plan.total_cost_per_hour,
             fractional_groups_per_node=shared)
    return {"route": t, "max_abs_err": err,
            "ffd_scan_pref": {"ms": ms, "shared_rank_ms": shared_ms,
                              "ratio_to_shared": ms / shared_ms,
                              "capped_steps": capped,
                              "branches": branches,
                              "shared_branches": shared_branches,
                              "us_per_capped_step": extra_us,
                              "variant": variant,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "bytes": nbytes,
                              "ops": ops, "library_ms": None,
                              "us_per_step": ms / G * 1e3},
            "presence_sum": psum,
            "right_size_pref_ms": rs_pref_ms, "right_size_ms": rs_ms,
            "rank_rows_ms": rank_ms}


def presence_cases(dev, present, miss) -> list:
    """(label, present, miss): the pref window's own tensors, then seeded
    ones: fractional misses, 2% presence, ragged O, G not a multiple of
    32, a node holding every group, an all-closed node axis, one node,
    and G at the kernel's maximum (with a node holding all of them)."""
    cases = [("pref window", present, miss)]
    top = presence_sum._bound()[1]
    for G, N, O, edge in ((512, 512, 3072, ""), (64, 64, 129, ""),
                          (341, 384, 1, ""), (77, 200, 3071, ""),
                          (341, 64, 3072, "full node"),
                          (512, 512, 3072, "all closed"),
                          (45, 1, 256, ""), (top, 40, 132, "full node")):
        rng = np.random.RandomState(G + N + O)
        p = (rng.rand(G, N) < 0.02).astype(np.float32)
        if edge == "full node":
            p[:, N // 2] = 1
        if edge == "all closed":
            p[:] = 0
        m = rng.choice(np.float32([0, 1 / 3, 2 / 3, 1, 0.1]), size=(G, O))
        cases.append((f"seeded G={G} N={N} O={O} {edge}".strip(),
                      torch.from_numpy(p).to(dev),
                      torch.from_numpy(m).to(dev)))
    return cases


def presence_bound_ms(present, miss) -> tuple[float, str, int, int, int]:
    """The presence sum's least time on the card for this call's data:
    the flags read once, the miss rows of the groups present on some
    node read once, the [N, O] output written once; against the adds
    (present pairs x O) at the float32 scalar rate.  Also returns the
    earlier count of whole tensors (every miss row read)."""
    G, N = present.shape
    O = miss.shape[1]
    on = present != 0
    rows = int(on.any(1).sum())
    nbytes = 4 * (G * N + rows * O + N * O)
    adds = int(on.sum()) * O
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, adds, 4 * (G * N + G * O + N * O))


def presence_sum_checks(dev, card: str, present, miss) -> dict:
    """``presence_sum`` against its plain version (one ordered
    ``addcmul_`` per group) bit for bit on every ``presence_cases`` case;
    on the pref window, in turns, its time beside ``torch.matmul`` (the
    same sums in another order), the plain version, the device time
    alone, the device kernels per call (at most 2) and the bound as the
    data needs it."""
    cases = presence_cases(dev, present, miss)
    for label, p, m in cases:
        got = presence_sum.presence_sum(p, m)
        want = presence_sum.presence_sum_reference(p, m)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"presence_sum differs from its plain "
                                 f"version on {label}: max |diff| "
                                 f"{float((got - want).abs().max())}")
    call = lambda: presence_sum.presence_sum(present, miss)  # noqa: E731
    turns = paired_ms({"presence_sum": call,
                       "torch.matmul": lambda: present.t() @ miss}, 50)
    ms, lib_ms = turns["presence_sum"], turns["torch.matmul"]
    device_ms = kernel_device_ms(call, "presence_sum_kernel")
    per_call = kernels_per_call(call, "presence_sum_call",
                                presence_sum.LAUNCHES, "presence_sum")
    if per_call > 2:
        raise AssertionError(f"presence_sum: {per_call} device kernels per "
                             f"call, more than 2")
    plain_ms = cuda_ms(lambda: presence_sum.presence_sum_reference(
        present, miss), 5, warm=1)
    bound_ms, bound_by, nbytes, adds, whole = presence_bound_ms(present,
                                                                miss)
    G, N = present.shape
    O = miss.shape[1]
    counts = (present != 0).sum(0)
    say(f"kernel check presence_sum: {len(cases)} cases exact against the "
        f"plain version ({', '.join(c[0] for c in cases)})")
    say(f"timing [{card}]: presence_sum on the pref window's [G={G}, N={N}] "
        f"x [G, O={O}] ({int(counts.sum())} present pairs, "
        f"{int((counts > 0).sum())} nodes holding a group, at most "
        f"{int(counts.max())} on one): kernel {ms:.4f} ms back to back "
        f"(medians of 5 rounds of 50 in turns), device time alone "
        f"{device_ms:.4f} ms, {per_call} device kernels per call; "
        f"torch.matmul {lib_ms:.4f} ms "
        f"(presence_sum / torch.matmul x{ms / lib_ms:.4f}); plain version "
        f"({G} ordered addcmul_) {plain_ms:.4f} ms; bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes as the data needs them, {whole} as "
        f"whole tensors, {adds} adds)")
    return {"max_abs_err": 0.0, "cases": len(cases), "ms": ms,
            "device_ms": device_ms, "kernels_per_call": per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "whole_tensor_bytes": whole, "ops": adds,
            "present_pairs": int(counts.sum()),
            "max_groups_per_node": int(counts.max())}


def churn_stream(cfg: dict):
    """bench.py's resident / serving churn at the headline size: the
    seed's 10k-pod window, then per window 1-5 departures and 1-5
    arrivals of 500m/1Gi pods from ``random.Random(cfg["rng"])``."""
    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=cfg["seed"])
    rng = random.Random(cfg["rng"])
    seqs, cur = [], list(pods)
    for w in range(cfg["windows"]):
        if w:
            for _ in range(rng.randrange(1, 6)):
                cur.pop(rng.randrange(len(cur)))
            cur.extend(pod_api.PodSpec(
                f"{cfg['tag']}{w}n{i}",
                requests=pod_api.ResourceRequests(500, 1024, 0, 1))
                for i in range(rng.randrange(1, 6)))
        seqs.append(list(cur))
    return seqs, catalog


def p50_ms(xs) -> float:
    return float(np.percentile(xs, 50)) * 1e3


def fmt_ms(xs) -> str:
    return "/".join(f"{x:.4f}" for x in xs)


def phase_resident(dev, card: str) -> dict:
    """(i) The resident stream: resident on and off alternately (the
    order flips each window), every plan equal, the device state equal
    to the mirror and to the window's packed buffer after every window;
    the last window re-solved for a hit; rebuild, delta and hit seen.
    The counts are zeroed before each resident solve and read after it:
    one ``ffd_scan`` per dispatch and no other kernel.  Each resident
    dispatch's raw result is held word for word against the classic
    dispatch of the same prepared window.  Each window is encoded before
    its timed solves, so both arms' walls read the encode memo, not the
    encode."""
    seqs, catalog = churn_stream(RESIDENT)
    on = TorchSolver(SolverOptions(resident="on"), device=dev)
    off = TorchSolver(SolverOptions(resident="off"), device=dev)
    walls = {"on": [], "off": []}
    modes, h2d, words = [], [], []
    kept = []                       # (prep, device result) per dispatch
    dispatch_solve = on.resident.dispatch_solve

    def keep(prep, packed, catalog_t, right_size):
        out = dispatch_solve(prep, packed, catalog_t, right_size)
        kept.append((prep, out))
        return out

    on.resident.dispatch_solve = keep
    launches: dict = {}
    for w, pods_w in enumerate(seqs + seqs[-1:]):
        request = SolveRequest(pods_w, catalog)
        problem = encode_mod.encode(pods_w, catalog)
        plans = {}
        for arm in (("off", "on") if w % 2 == 0 else ("on", "off")):
            solver = on if arm == "on" else off
            if arm == "on":
                kept.clear()
                reset_launches()
            t0 = time.perf_counter()
            plans[arm] = solver.solve(request)
            walls[arm].append(time.perf_counter() - t0)
            if arm == "on":
                got = {k: v for k, v in launch_counts().items() if v}
        plans_equal(f"resident window {w}", plans["on"], plans["off"])
        st = on.last_stats
        if st["path"] != "resident-cuda":
            raise AssertionError(f"resident window {w} took {st['path']!r}")
        dispatches = 1 + st["escalations"] + st["coo_growths"]
        if got != {"ffd_scan": dispatches, "cost_sum": dispatches} \
                or len(kept) != dispatches:
            raise AssertionError(f"resident window {w}: {len(kept)} resident "
                                 f"dispatches launched {got}, want one "
                                 f"ffd_scan and one cost_sum each of "
                                 f"{dispatches}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        prep, out = kept[-1]
        classic = prep.clone()
        classic.resident = False
        words_equal(f"resident window {w}", out.cpu().numpy(),
                    off.dispatch_packed(classic).cpu().numpy(),
                    prep.N + prep.G_pad)
        modes.append(st["resident_mode"])
        h2d.append(st["h2d_bytes"])
        words.append(st["delta_words"])
        snap = on.resident.snapshot_state()
        want = resident_delta.pack_window(problem)[0]
        if not (np.array_equal(snap["mirror"], snap["device"])
                and np.array_equal(snap["device"], want)):
            raise AssertionError(f"resident window {w}: device state != "
                                 f"mirror != packed window")
    if not {"rebuild", "delta", "hit"} <= set(modes) or modes[-1] != "hit":
        raise AssertionError(f"resident modes {modes}")
    warm = slice(1, len(seqs))
    out = {"modes": modes, "h2d_bytes": h2d, "delta_words": words,
           "full_packed_bytes": int(want.nbytes),
           "on_p50_ms": p50_ms(walls["on"][warm]),
           "off_p50_ms": p50_ms(walls["off"][warm]),
           "on_walls_ms": [x * 1e3 for x in walls["on"]],
           "off_walls_ms": [x * 1e3 for x in walls["off"]],
           "warm_h2d_p50_bytes": float(np.percentile(h2d[warm], 50)),
           "warm_delta_words_p50": float(np.percentile(words[warm], 50)),
           "launches": launches, "stats": on.resident.stats()}
    say(f"resident path: {len(seqs)} windows of {RESIDENT['seed']}'s "
        f"10k-pod churn (+1 repeat), resident on/off alternately: every "
        f"plan equal, every resident raw result equal to the classic raw "
        f"result word for word, device state == mirror == packed window "
        f"after every window; modes {modes}; launches of the resident "
        f"solves alone {launches}")
    say(f"timing [{card}]: resident stream warm p50 wall: on "
        f"{out['on_p50_ms']:.4f} ms, off {out['off_p50_ms']:.4f} ms; H2D "
        f"per warm window p50 {out['warm_h2d_p50_bytes']:.0f} B (full "
        f"packed buffer {out['full_packed_bytes']} B), delta words p50 "
        f"{out['warm_delta_words_p50']:.0f}")
    return out


def phase_serving(dev, card: str) -> dict:
    """(j) The serving stream: a cold pass and a warm pass of
    ``serve``-style submits at depth 2; every window on the ring, none
    backpressured, ``ring_state_violations`` empty, every plan equal to
    the classic plan and every raw ring result equal to the classic raw
    result word for word; then the port's 8-seed parity checks."""
    from karpenter_tpu_torch.serving.ring import OutputRing
    from karpenter_tpu_torch.serving.validate import (
        plan_parity_violations, raw_parity_violations,
        ring_state_violations,
    )

    seqs, catalog = churn_stream(SERVING)
    problems = [encode_mod.encode(p, catalog) for p in seqs]
    on = TorchSolver(SolverOptions(serving="on"), device=dev)
    off = TorchSolver(SolverOptions(serving="off"), device=dev)
    loop = on.serving
    slots = {}

    class KeepingRing(OutputRing):
        """The loop's output ring, keeping every slot it hands out."""

        def take(self, seq):
            slot = slots[seq] = super().take(seq)
            return slot

    loop.output = KeepingRing(loop.capacity)
    reset_launches()
    cold = list(loop.serve(iter(problems), depth=SERVING["depth"]))
    kick_s, plans = [], []
    pending = deque()
    t0 = time.perf_counter()
    for problem in problems:
        t1 = time.perf_counter()
        pending.append(loop.submit(problem))
        kick_s.append(time.perf_counter() - t1)
        while len(pending) >= SERVING["depth"]:
            plans.append(pending.popleft().result())
    while pending:
        plans.append(pending.popleft().result())
    ring_ms = (time.perf_counter() - t0) * 1e3 / len(problems)
    launches = launch_counts()
    require_launches(launches, ["ffd_scan", "cost_sum"], "serving path")
    st = loop.stats()
    n = 2 * len(problems)
    if (st["ring_windows"], st["classic_windows"], st["backpressured"]) \
            != (n, 0, 0):
        raise AssertionError(f"serving: not every window rode the ring: "
                             f"{st}")
    violations = ring_state_violations(loop, catalog)
    if violations:
        raise AssertionError(f"serving ring state: {violations}")
    classic_s = []
    first = len(problems)
    for k, (problem, plan, cplan) in enumerate(zip(problems, plans, cold)):
        t1 = time.perf_counter()
        classic = off.solve_encoded(problem)
        classic_s.append(time.perf_counter() - t1)
        plans_equal(f"serving window {k} (warm)", plan, classic)
        plans_equal(f"serving window {k} (cold)", cplan, classic)
        prep = off._prepare(problem)
        raw = off.dispatch_packed(prep).cpu().numpy()
        for seq in (k, first + k):
            words_equal(f"serving window {k} slot {seq}",
                        slots[seq].host.numpy(), raw, prep.N + prep.G_pad)
    modes = [slots[s].mode for s in sorted(slots)]
    parity = raw_parity_violations(seeds=8, device=dev) \
        + plan_parity_violations(seeds=8, device=dev)
    if parity:
        raise AssertionError(f"serving parity checks: {parity[:3]}")
    out = {"kick_p50_ms": p50_ms(kick_s), "ring_p50_ms": ring_ms,
           "classic_p50_ms": p50_ms(classic_s),
           "overlap_fraction": loop.overlap_fraction, "modes": modes,
           "kick_ms": [x * 1e3 for x in kick_s],
           "classic_ms": [x * 1e3 for x in classic_s], "stats": st,
           "launches": launches}
    say(f"serving path: {len(problems)} windows of {SERVING['seed']}'s "
        f"10k-pod churn, a cold and a warm pass at depth {SERVING['depth']}:"
        f" {st['ring_windows']} ring windows, 0 classic, 0 backpressured, "
        f"ring state clean, every plan equal to the classic plan, every raw "
        f"ring result equal to the classic raw result word for word; modes "
        f"{modes}; the port's 8-seed raw and plan parity checks clean; "
        f"launches {launches}")
    say(f"timing [{card}]: serving warm pass: kick p50 "
        f"{out['kick_p50_ms']:.4f} ms, amortized ring p50 {ring_ms:.4f} ms "
        f"per window, classic p50 {out['classic_p50_ms']:.4f} ms, overlap "
        f"fraction {loop.overlap_fraction:.4f}")
    return out


def phase_fleet_resident(dev, fleet: dict) -> dict:
    """(k) The fleet with ``resident_buf``: window 0 rebuilds, window 1
    (the same window) is a hit, window 2 (one cluster churned) a delta;
    each equal to the fleet without the buffer."""
    import copy

    stacked, N = fleet["stacked"], fleet["N"]
    kw = dict(num_nodes=N, device=dev, device_catalog=fleet["dev_catalog"])
    churned = copy.deepcopy(stacked)
    churned.group_count[3, 0] = max(0, int(churned.group_count[3, 0]) - 3)
    buf = ResidentBuffer("fleet")
    reset_launches()
    runs = []
    for label, problem in (("rebuild", stacked), ("hit", stacked),
                           ("delta", churned)):
        t0 = time.perf_counter()
        got = fleet_solve_packed(problem, resident_buf=buf, **kw)
        runs.append((label, time.perf_counter() - t0, problem, got))
    launches = launch_counts()
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"],
                     "fleet resident path")
    for label, _, problem, got in runs:
        want = fleet_solve_packed(problem, **kw)
        for name, a, b in zip(("node_off", "assign", "unplaced", "cost"),
                              got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"fleet resident {label}: {name} "
                                     f"differs from the plain fleet")
    if buf.stats != {"rebuild": 1, "hit": 1, "delta": 1}:
        raise AssertionError(f"fleet resident ladder {buf.stats}")
    say(f"fleet resident path: rebuild, hit, delta ({buf.stats}) each equal "
        f"to the fleet without the buffer; walls "
        + ", ".join(f"{lb} {s * 1e3:.3f} ms" for lb, s, _, _ in runs)
        + f"; launches {launches}")
    return {"stats": dict(buf.stats), "launches": launches,
            "walls_ms": {lb: s * 1e3 for lb, s, _, _ in runs}}


# -- phase 3 (cost sum) and phase 4 (l-n): the what-if, gang and preempt planes


def node_rows(N: int, C: int, device) -> torch.Tensor:
    """node_off int32 [N] (C = 1) or [C, N] opening node n on offering n:
    the cost word of it over a masked price row is that row's sum."""
    idx = torch.arange(N, dtype=torch.int32, device=device)
    return idx if C == 1 else idx.expand(C, N).contiguous()


def check_masked_sum(label: str, prices: torch.Tensor) -> float:
    """The cost word over a masked price row (every node open on its own
    offering) against the plain order-fixed sum of that row on the same
    card tensor, bit for bit; returns max |diff| (0.0)."""
    C = prices.shape[0] if prices.dim() == 2 else 1
    got = cost_sum.cost_word(node_rows(prices.shape[-1], C, prices.device),
                             prices)
    want = cost_sum.cost_sum_reference(prices)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"cost_word differs from the plain sum of the "
                             f"masked row on {label}: max |diff| "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def phase_cost_sum_checks(dev) -> dict:
    """The cost-word kernel bit for bit against its plain version: C in
    {1, 8, 64}, every N in NODE_BUCKETS and three ragged lengths; masked
    price rows (30-70% of the nodes open, small totals and rows near
    2^24) summed as they lie, then node offerings gathered from one
    price row per problem, one shared row and one row."""
    rng = np.random.RandomState(7)
    cases = 0
    for C in (1, 8, 64):
        for N in NODE_BUCKETS + (33, 1000, 4097):
            for scale in (4.0, 2.0 ** 25 / N):
                prices = (rng.rand(C, N) * scale).astype(np.float32)
                closed = rng.rand(C, N) >= rng.uniform(0.3, 0.7, (C, 1))
                prices[closed] = 0
                x = torch.from_numpy(prices).to(dev)
                check_masked_sum(f"C={C} N={N}", x if C > 1 else x[0])
                cases += 1
    say(f"kernel check cost_word on masked rows: {cases} cases (C in 1, 8, "
        f"64; N in {list(NODE_BUCKETS)} and 33, 1000, 4097; 30-70% open, "
        f"totals small and near 2^24) bit for bit against the plain sum")
    words = 0
    O = 3072
    for C in (1, 8, 64):
        for N in NODE_BUCKETS + (33, 1000, 4097):
            node = rng.randint(0, O, size=(C, N)).astype(np.int32)
            node[rng.rand(C, N) >= rng.uniform(0.3, 0.7, (C, 1))] = -1
            price = torch.from_numpy(
                (rng.rand(C, O) * 2.0 ** 27 / N).astype(np.float32)).to(dev)
            no = torch.from_numpy(node).to(dev)
            for args in ((no, price), (no, price[0]), (no[0], price[0])):
                got = cost_sum.cost_word(*args)
                want = cost_sum.cost_word_reference(*args)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(
                        f"cost_word differs from its plain version at C={C} "
                        f"N={N}, price {tuple(args[1].shape)}")
                words += 1
    say(f"kernel check cost_word: {words} cases (C in 1, 8, 64; the same "
        f"N; a price row per problem, one shared row, one row; 30-70% "
        f"open, totals past 2^24) bit for bit against the plain version")
    return {"max_abs_err": 0.0, "cases": cases, "cost_word_cases": words}


def kernel_device_ms(fn, kernel: str, reps: int = 50,
                     tries: int = 5) -> float:
    """Mean device time of the one CUDA kernel (name holding ``kernel``)
    that each call of ``fn`` launches, from a ``torch.profiler`` trace of
    ``reps`` calls, each a range on the host, after ``reps`` calls
    outside any range (the trace drops the device records of the first
    launches it sees).  A device record counts only when its launch
    record lies inside a call's range (joined by correlation id, as
    ``profile_spans`` does; a record the trace repeats counts once), and
    every call must have exactly one: a trace that falls short is taken
    again, up to ``tries`` times; then the call raises, naming the calls
    without a record.  Back-to-back CUDA events time a tiny kernel's
    host issue instead; this reads the kernel alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = f"{kernel}_call"
    fn()
    why = ""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            for _ in range(reps):
                with record_function(tag):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events
                        if e.name == tag and e.device_type == DeviceType.CPU)
        call_of = {}                    # launch correlation id -> call
        for e in events:
            if e.device_type == DeviceType.CPU and _is_launch(e):
                for i, (lo, hi) in enumerate(ranges):
                    if lo <= e.time_range.start <= hi:
                        call_of[e.id] = i
        kernels = {e.id: e for e in events
                   if e.device_type == DeviceType.CUDA and kernel in e.name
                   and e.id in call_of}
        calls = sorted(call_of[i] for i in kernels)
        if len(ranges) == reps and calls == list(range(reps)):
            return sum(e.time_range.end - e.time_range.start
                       for e in kernels.values()) / reps / 1e3
        more = sorted({c for c in calls if calls.count(c) > 1})
        why = (f"{len(ranges)} call ranges; {len(kernels)} {kernel} records "
               f"joined to a launch inside them; calls without one: "
               f"{sorted(set(range(len(ranges))) - set(calls))}; calls "
               f"with more: {more}")
    raise AssertionError(f"{kernel}: device time not read from "
                         f"torch.profiler in {tries} traces of {reps} "
                         f"calls: {why}")


def cost_word_bound_ms(node_off: torch.Tensor, off_price: torch.Tensor
                       ) -> tuple[float, str, int, int]:
    """The cost word's least time on the card for this call's data: the
    C x N node offerings read once, each price word an open node needs
    read once (the distinct open offerings of each price row; of the one
    shared row when the rows share it), C words written; against the
    C x N adds of the windows at the float32 scalar rate."""
    C = 1 if node_off.dim() == 1 else node_off.shape[0]
    N, O = node_off.shape[-1], off_price.shape[-1]
    rows = node_off.reshape(C, N).long()
    is_open = rows >= 0
    off = rows.clamp(max=O - 1)
    if off_price.dim() == 2:
        off = off + O * torch.arange(C, device=off.device)[:, None]
    prices = int(torch.unique(off[is_open]).numel())
    nbytes = 4 * (C * N + prices + C)
    adds = C * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, adds


def cost_sum_timing(label: str, node_off: torch.Tensor,
                    off_price: torch.Tensor, card: str) -> dict:
    """The cost word of ``node_off`` [N] or [C, N] over ``off_price``:
    ``cost_word`` (one fused launch) bit for bit against its plain
    version and against the plain sum of the masked row; then, back to
    back (the wrapper's host issue; medians of 5 rounds taken in turns)
    ``cost_word``, ``torch.sum`` on the premasked row (the same sum in
    another order) and the chain the paths ran before this kernel took
    the gather in (clamp, gather, ``where``, then one order-fixed sum
    launch over the masked row); the device time alone (profiler), the
    plain version, the bound, and the device kernels per call of
    ``cost_word`` (exact) and of the chain."""
    prices = cost_sum.masked_prices(node_off, off_price)
    err = check_masked_sum(label, prices)
    word = cost_sum.cost_word(node_off, off_price)
    plain = cost_sum.cost_word_reference(node_off, off_price)
    torch.cuda.synchronize()
    if not torch.equal(word.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"cost_word differs from its plain version on "
                             f"{label}")
    C = 1 if node_off.dim() == 1 else node_off.shape[0]
    N = node_off.shape[-1]
    every = node_rows(N, C, node_off.device)
    call = lambda: cost_sum.cost_word(node_off, off_price)  # noqa: E731
    chain = lambda: cost_sum.cost_word(  # noqa: E731
        every, cost_sum.masked_prices(node_off, off_price))
    paired = paired_ms({"cost_word": call,
                        "torch.sum": lambda: prices.sum(dim=-1),
                        "chain": chain}, 100)
    ms, lib_ms, chain_ms = (paired["cost_word"], paired["torch.sum"],
                            paired["chain"])
    device_ms = kernel_device_ms(call, "cost_word_kernel")
    per_call = kernels_per_call(call, "cost_word_call", cost_sum.LAUNCHES,
                                "cost_sum")
    chain_per_call = kernels_per_call(chain, "cost_chain_call",
                                      cost_sum.LAUNCHES, "cost_sum")
    plain_ms = cuda_ms(lambda: cost_sum.cost_word_reference(
        node_off, off_price), 20)
    bound_ms, bound_by, nbytes, adds = cost_word_bound_ms(node_off,
                                                          off_price)
    say(f"timing [{card}]: cost word on {label} [C={C}, N={N}, O="
        f"{off_price.shape[-1]}, {'shared' if off_price.dim() == 1 else 'a'}"
        f" price row{'' if off_price.dim() == 1 else ' per problem'}]: "
        f"cost_word {ms:.4f} ms back to back, device time alone "
        f"{device_ms:.4f} ms, {per_call} device kernels per call; the "
        f"earlier chain (clamp, gather, where, one sum launch) "
        f"{chain_ms:.4f} ms, {chain_per_call} device kernels per call; "
        f"plain version {plain_ms:.4f} ms; torch.sum on the premasked "
        f"row {lib_ms:.4f} ms (cost_word / torch.sum "
        f"x{ms / lib_ms:.3f}); bound {bound_ms:.7f} ms ({bound_by}: "
        f"{nbytes} bytes, {adds} adds); bit-exact against the plain "
        f"version and the plain sum of the masked row")
    return {"ms": ms, "device_ms": device_ms, "kernels_per_call": per_call,
            "chain_ms": chain_ms, "chain_kernels_per_call": chain_per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": adds, "max_abs_err": err, "shape": [C, N]}


def whatif_menu(baseline, catalog, k: int, rng) -> list:
    """``bench.run_whatif``'s menu: the baseline, then arrival waves on 8
    groups alone, with a spot storm, with a zone blackout, with a quota
    clamp."""
    G = baseline.problem.num_groups
    menu = [whatif.Scenario("baseline")]
    storm = whatif_scenario.spot_storm_mask(catalog)
    while len(menu) < k:
        i = len(menu)
        gis = rng.choice(G, size=min(8, G), replace=False)
        wave = whatif.ArrivalWave(tuple(
            (int(g), int(rng.randint(1, 48))) for g in sorted(gis)))
        kind = i % 4
        if kind == 0:
            perts: tuple = (wave,)
        elif kind == 1:
            perts = (wave, storm)
        elif kind == 2:
            zone = catalog.zones[int(rng.randint(len(catalog.zones)))]
            perts = (wave, whatif_scenario.zone_blackout_mask(catalog, zone))
        else:
            perts = (wave, whatif_scenario.quota_clamp(
                baseline, int(rng.randint(2, 8))))
        menu.append(whatif.Scenario(f"s{i}", perts))
    return menu[:k]


def stacked_scan_tensors(dev, baseline, menu, ct):
    """(metas, compats) of a lowered menu on the card: the stacked delta
    apply and the unpack of every row, as the stacked solve forms them."""
    st = whatif.lower_scenarios(baseline, menu)
    bufs = whatif_kernels.apply_deltas(
        torch.from_numpy(baseline.packed).to(dev),
        torch.from_numpy(st.didx).to(dev), torch.from_numpy(st.dval).to(dev))
    G, O, U = baseline.G_pad, baseline.O_pad, baseline.U_pad
    metas, compats, _ = torch.func.vmap(
        lambda p: tp.unpack_problem(p, ct[0], G, O, U))(bufs)
    return metas.contiguous(), compats.contiguous()


def phase_whatif(dev, card: str) -> dict:
    """(l) ``bench.run_whatif``: 10k pods x 500 types, K = 64 scenarios
    in one stacked plan on the card."""
    pods, catalog = workload.build_workload(WHATIF["pods"], WHATIF["types"])
    t0 = time.perf_counter()
    baseline = whatif.build_baseline(pods, catalog)
    build_s = time.perf_counter() - t0
    menu = whatif_menu(baseline, catalog, WHATIF["K"],
                       np.random.RandomState(WHATIF["menu_seed"]))
    K = len(menu)
    planner = whatif.WhatIfPlanner(max_k=K, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = planner.plan(baseline, menu)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    if {k: v for k, v in launches.items() if v} != \
            {"ffd_scan_fleet": 1, "cost_sum": 1} or plan.dispatches != 1:
        raise AssertionError(f"the stacked what-if plan of {K} scenarios "
                             f"took {plan.dispatches} solves and launched "
                             f"{launches}, want one ffd_scan_fleet and one "
                             f"cost_sum")
    G, N = baseline.G_pad, plan.N
    if plan.outcomes[0].unplaced:
        raise AssertionError(f"what-if baseline scenario left "
                             f"{plan.outcomes[0].unplaced} pods unplaced")

    # every scenario's words: a fresh single-window solve of its
    # perturbed buffer on the card (the cost word included), and the
    # numpy oracle up to the cost word
    ct = planner._catalog_tensors(catalog, baseline.O_pad)
    bufs = [whatif_scenario.perturbed_buffer(baseline, s) for s in menu]
    kw = dict(G=G, O=baseline.O_pad, U=baseline.U_pad, N=N,
              compact=plan.K_coo, coo16=plan.coo16)

    def sequential():
        return [tp.solve_packed_torch(torch.from_numpy(b).to(dev), *ct,
                                      **kw).cpu().numpy() for b in bufs]

    for k, single in enumerate(sequential()):
        words_equal(f"what-if scenario {menu[k].name}", plan.raw[k], single,
                    N + G)
    t0 = time.perf_counter()
    host = planner.plan_host(baseline, menu)
    host_s = time.perf_counter() - t0
    for k in range(K):
        if not whatif_oracle.words_equal_except_cost(plan.raw[k],
                                                     host.raw[k], G, N):
            raise AssertionError(f"what-if scenario {menu[k].name}: the "
                                 f"card's words differ from the numpy "
                                 f"oracle's")
    violations = whatif.validate_whatif(plan)
    if violations:
        raise AssertionError(f"validate_whatif: {violations[:3]}")

    # the fleet kernel at the stacked shapes: C = K and C = WHATIF_MAX_K
    # (the largest chunk), against its plain version on the card
    scan = {}
    alloc, _, rank = ct
    for C in (K, whatif.WHATIF_MAX_K):
        big = menu if C == K else whatif_menu(
            baseline, catalog, C, np.random.RandomState(WHATIF["menu_seed"]))
        metas, compats = stacked_scan_tensors(dev, baseline, big, ct)
        allocs, ranks = alloc.expand(C, *alloc.shape), rank.expand(C, -1)
        got = ffd_kernel.ffd_scan_fleet(metas, compats, allocs, ranks, N)
        want = ffd_kernel.ffd_scan_fleet_reference(metas, compats, allocs,
                                                   ranks, N)
        torch.cuda.synchronize()
        if max_abs_err(got, want):
            first_diff(f"ffd_scan_fleet what-if C={C}", got, want)
        scan[C] = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(
            metas, compats, allocs, ranks, N), 20)
    # the cost sum on the stacked plan's own masked prices
    metas, compats = stacked_scan_tensors(dev, baseline, menu, ct)
    node_off, assign, _ = ffd_kernel.ffd_scan_fleet(
        metas, compats, alloc.expand(K, *alloc.shape), rank.expand(K, -1), N)
    node_off = torch.func.vmap(lambda m, c, no, a: tp.finish_solve(
        m, c, no, a, ct[0], ct[2], True))(metas, compats, node_off, assign)
    cs = cost_sum_timing("the stacked what-if plan", node_off, ct[1], card)

    walls = []
    for _ in range(WHATIF["iters"]):
        t0 = time.perf_counter()
        planner.plan(baseline, menu)
        walls.append(time.perf_counter() - t0)
    sequential()
    t0 = time.perf_counter()
    sequential()
    seq_s = time.perf_counter() - t0
    stacked_ms = p50_ms(walls)
    outcomes = plan.outcomes
    say(f"what-if path: {K} scenarios of {WHATIF['pods']} pods x "
        f"{WHATIF['types']} types (G={G} O={baseline.O_pad} "
        f"U={baseline.U_pad} N={N}, delta rung {plan.stacked.D}), one "
        f"stacked plan: launches {launches}; every scenario's words equal "
        f"to a single-window solve_packed_torch of its perturbed buffer on "
        f"the card (cost words included) and to the numpy oracle up to "
        f"the cost word; validate_whatif clean; baseline {outcomes[0].pods} "
        f"pods all placed; placed min/max over scenarios "
        f"{min(o.placed for o in outcomes)}/{max(o.placed for o in outcomes)}"
        f"; ffd_scan_fleet exact against its plain version at C={K} and "
        f"C={whatif.WHATIF_MAX_K}")
    say(f"timing [{card}]: what-if stacked plan warm p50 {stacked_ms:.4f} "
        f"ms (cold {cold_s * 1e3:.3f} ms, baseline build {build_s:.3f} s); "
        f"{K} sequential single-window solves {seq_s * 1e3:.3f} ms; "
        f"plan_host (numpy oracle) {host_s * 1e3:.3f} ms; ffd_scan_fleet at "
        f"C={K} {scan[K]:.4f} ms, at C={whatif.WHATIF_MAX_K} "
        f"{scan[whatif.WHATIF_MAX_K]:.4f} ms")
    return {"launches": launches, "K": K, "N": N, "G": G,
            "O": baseline.O_pad, "U": baseline.U_pad, "D": plan.stacked.D,
            "stacked_p50_ms": stacked_ms, "walls_ms": [w * 1e3 for w in walls],
            "cold_ms": cold_s * 1e3, "sequential_ms": seq_s * 1e3,
            "plan_host_ms": host_s * 1e3, "baseline_build_s": build_s,
            "ffd_scan_fleet_ms": {str(c): v for c, v in scan.items()},
            "cost_sum": cs,
            "outcomes": [o.to_dict() for o in outcomes[:4]]}


def gang_pods(cfg: dict) -> list:
    """``bench.run_gang``'s gangs: ``gangs`` jobs of ``members`` replicas,
    slice shapes 4x4 / 2x2x2 / 2x2 / none."""
    rng = np.random.RandomState(cfg["seed"])
    shapes = ["4x4", "2x2x2", "2x2", ""]
    pods = []
    for g in range(cfg["gangs"]):
        shape = shapes[int(rng.randint(len(shapes)))]
        gang = PodGroup(name=f"job-{g:03d}", min_member=cfg["members"],
                        slice_shape=shape or None)
        for m in range(cfg["members"]):
            pods.append(pod_api.PodSpec(
                f"job-{g:03d}-{m}", requests=pod_api.ResourceRequests(
                    int(rng.randint(100, 500)), int(rng.randint(256, 1024)),
                    0, 1), gang=gang))
    return pods


def gang_fingerprint(plan):
    return (plan.placements, plan.unplaced, plan.total_cost_per_hour,
            [(n.offering_index, [(a.gang, a.placement_mask, a.pod_names,
                                  a.rank_chips, a.max_hop)
                                 for a in n.assignments])
             for n in plan.nodes])


def timed_p50(fn, iters: int) -> float:
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return p50_ms(walls)


def phase_gang(dev, card: str) -> dict:
    """(m) ``bench.run_gang``: 64 gangs x 16 members over 500 accelerator
    types, the torch grid on the card against the numpy grid."""
    catalog = workload.build_catalog(GANG["types"], workload.ACCEL_FAMILIES)
    pods = gang_pods(GANG)
    problem = encode_gangs(pods, catalog)
    on = GangPlanner(GangOptions(use_device="on"), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(problem)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "gang path")
    steps = on.device_steps
    off = GangPlanner(GangOptions(use_device="off"), device="cpu")
    ref = off.plan(problem)
    if steps < 1 or gang_fingerprint(plan) != gang_fingerprint(ref):
        raise AssertionError(f"gang plan on the card ({steps} torch grid "
                             f"steps) differs from the numpy grid's")
    errors = validate_gang_plan(plan, pods, catalog)
    if errors:
        raise AssertionError(f"validate_gang_plan: {errors[:3]}")
    placed = {pn for n in plan.nodes for pn in n.pod_names}
    partial = sum(1 for g in problem.gangs
                  if 0 < sum(pn in placed for pn in g.pod_names)
                  < len(g.pod_names))
    if partial:
        raise AssertionError(f"gang plan has {partial} partial gangs")
    on_ms = timed_p50(lambda: on.plan(problem), GANG["iters"])
    off_ms = timed_p50(lambda: off.plan(problem), GANG["iters"])
    say(f"gang path: {problem.num_gangs} gangs x {GANG['members']} members "
        f"over {GANG['types']} accelerator types: {len(plan.placed_gangs)} "
        f"placed on {len(plan.nodes)} nodes, {len(plan.unplaced_gangs)} "
        f"unplaced, 0 partial; {steps} torch grid steps on the card, plan "
        f"equal to the numpy grid's; validate_gang_plan clean; launches "
        f"{launches} (the grid is PyTorch ops)")
    say(f"timing [{card}]: gang plan warm p50 {on_ms:.4f} ms on the card "
        f"(cold {cold_s * 1e3:.3f} ms), numpy grid {off_ms:.4f} ms")
    return {"launches": launches, "gangs": problem.num_gangs,
            "placed_gangs": len(plan.placed_gangs), "nodes": len(plan.nodes),
            "device_steps": steps, "partial": partial,
            "card_p50_ms": on_ms, "numpy_p50_ms": off_ms,
            "cold_ms": cold_s * 1e3}


def preempt_cluster(cfg: dict):
    """``bench.run_preempt``'s overload: ``claims`` nodes, each ~96% full
    with three low-priority victims, and ``pending`` pods of mixed sizes
    and priorities.  Returns (catalog, cluster, pending pods)."""
    catalog = workload.build_catalog(cfg["types"])
    rng = np.random.RandomState(cfg["seed"])
    alloc = catalog.type_alloc
    hostable = [t for t in range(catalog.num_types)
                if alloc[t, 0] >= 2000 and alloc[t, 1] >= 4096]
    cluster = ClusterState()
    for i in range(cfg["claims"]):
        t = hostable[rng.randint(len(hostable))]
        cluster.add_nodeclaim(NodeClaim(
            name=f"pc{i}", instance_type=catalog.type_names[t],
            zone=catalog.zones[rng.randint(len(catalog.zones))],
            node_name=f"node-pc{i}", launched=True))
        for j in range(3):
            name = f"v{i}-{j}"
            cluster.add_pod(pod_api.PodSpec(
                name, requests=pod_api.ResourceRequests(
                    int(alloc[t, 0] * 0.32), int(alloc[t, 1] * 0.32), 0, 1),
                priority=int(rng.choice([0, 0, 0, 100]))))
            cluster.bind_pod(f"default/{name}", f"node-pc{i}")
    sizes = [(500, 1024), (1000, 2048), (2000, 4096)]
    prios = [0, 0, 100, 100, 100, 1000]
    pending = []
    for k in range(cfg["pending"]):
        cpu, mem = sizes[rng.randint(len(sizes))]
        pending.append(pod_api.PodSpec(
            f"p{k}", requests=pod_api.ResourceRequests(cpu, mem, 0, 1),
            priority=prios[rng.randint(len(prios))]))
    return catalog, cluster, pending


def preempt_fingerprint(plan):
    return ([(e.claim_name, e.pod_key, e.victim_priority,
              e.beneficiary_priority) for e in plan.evictions],
            plan.placements, plan.unplaced, plan.eviction_weight)


def phase_preempt(dev, card: str) -> dict:
    """(n) ``bench.run_preempt``: 10k pending pods against 2000 full
    claims, the torch fit grid on the card against the numpy grid."""
    catalog, cluster, pending = preempt_cluster(PREEMPT)
    problem = encode_mod.encode(pending, catalog)
    t0 = time.perf_counter()
    victims = encode_victims(cluster, catalog)
    victims_ms = (time.perf_counter() - t0) * 1e3
    compat = group_node_compat(problem, victims)
    budget = PREEMPT["claims"] * 3
    on = PreemptionPlanner(PlannerOptions(use_device="on",
                                          max_evictions=budget), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(problem, victims, compat)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "preemption path")
    steps = on.device_steps
    off = PreemptionPlanner(PlannerOptions(use_device="off",
                                           max_evictions=budget),
                            device="cpu")
    ref = off.plan(problem, victims, compat)
    if steps < 1 or preempt_fingerprint(plan) != preempt_fingerprint(ref):
        raise AssertionError(f"preemption plan on the card ({steps} torch "
                             f"grid steps) differs from the numpy grid's")
    errors = validate_preemption_plan(plan, pending, cluster, catalog)
    if errors:
        raise AssertionError(f"validate_preemption_plan: {errors[:3]}")
    if not plan.evictions or not plan.placements:
        raise AssertionError("the overload window evicted or placed nothing")
    on_ms = timed_p50(lambda: on.plan(problem, victims, compat),
                      PREEMPT["iters"])
    off_ms = timed_p50(lambda: off.plan(problem, victims, compat),
                       PREEMPT["iters"])
    say(f"preemption path: {PREEMPT['pending']} pending x "
        f"{victims.num_nodes} claims ({victims.num_victims} victims, "
        f"{problem.num_groups} groups): {plan.eviction_count} evictions, "
        f"{plan.placed_count} placed, {len(plan.unplaced)} unplaced; "
        f"{steps} torch grid steps on the card, plan equal to the numpy "
        f"grid's; validate_preemption_plan clean; launches {launches} "
        f"(the grid is PyTorch ops)")
    say(f"timing [{card}]: preemption plan warm p50 {on_ms:.4f} ms on the "
        f"card (cold {cold_s * 1e3:.3f} ms), numpy grid {off_ms:.4f} ms; "
        f"encode_victims {victims_ms:.3f} ms")
    return {"launches": launches, "evictions": plan.eviction_count,
            "placed": plan.placed_count, "unplaced": len(plan.unplaced),
            "device_steps": steps, "card_p50_ms": on_ms,
            "numpy_p50_ms": off_ms, "cold_ms": cold_s * 1e3,
            "encode_victims_ms": victims_ms}


# -- phase 4 (o-r): the sharded service, its serving loop, the repack plane --


def keep_kicks(svc) -> list:
    """Keep every kick of a sharded service (its window and its pinned
    result buffer, read after the fetch)."""
    kicks = []
    kick = svc._kick_window

    def keep(*args, **kwargs):
        out = kick(*args, **kwargs)
        kicks.append(out)
        return out

    svc._kick_window = keep
    return kicks


def single_rows(window, catalog_t, device) -> list:
    """``solve_packed_torch`` of each shard's buffer on ``device``."""
    kw = dict(G=window.G_pad, O=window.O_pad, U=window.U_pad, N=window.N)
    ct = [t.to(device) for t in catalog_t]
    return [tp.solve_packed_torch(torch.from_numpy(window.stacked[s])
                                  .to(device), *ct, **kw).cpu().numpy()
            for s in range(window.num_shards)]


def rows_equal_singles(label: str, kick, catalog_t, device) -> None:
    """A kicked window's raw rows, fetched, against the single solves of
    its shards' buffers on ``device`` (the cost words included)."""
    w = kick.window
    rows = kick.host.numpy()
    for s, single in enumerate(single_rows(w, catalog_t, device)):
        words_equal(f"{label} shard {s}", rows[s], single, w.N + w.G_pad)


def shard_scan_check(dev, label: str, window, ct, card: str) -> dict:
    """The fleet kernel on a sharded window's own unpacked tensors (C =
    S, the catalog expanded with stride 0), exact against its plain
    version on the card, with both timed and the bound."""
    alloc, _, rank = ct
    S, N = window.num_shards, window.N
    metas, compats, _ = torch.func.vmap(lambda p: tp.unpack_problem(
        p, alloc, window.G_pad, window.O_pad, window.U_pad))(
        torch.from_numpy(window.stacked).to(dev))
    metas, compats = metas.contiguous(), compats.contiguous()
    allocs, ranks = alloc.expand(S, *alloc.shape), rank.expand(S, -1)
    got = ffd_kernel.ffd_scan_fleet(metas, compats, allocs, ranks, N)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ffd_kernel.ffd_scan_fleet_reference(metas, compats, allocs,
                                               ranks, N)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    err = max_abs_err(got, want)
    if err:
        first_diff(f"ffd_scan_fleet {label}", got, want)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(metas, compats, allocs,
                                                   ranks, N), 10)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        metas, compats, allocs, ranks, N, got[1].cpu().numpy(),
        got[0].cpu().numpy())
    G, O = compats.shape[1:]
    say(f"kernel check ffd_scan_fleet on the {label} (C={S} stride 0, "
        f"G={G} O={O} N={N}): exact against its plain version; timing "
        f"[{card}]: kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group "
        f"step), plain PyTorch version {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, {ops} scalar "
        f"ops)")
    return {"C": S, "G": G, "O": O, "N": N, "ms": ms, "plain_ms": plain_ms,
            "us_per_step": ms / G * 1e3, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def require_window_launches(launches: dict, label: str,
                            windows: int = 1) -> None:
    """Exactly one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
    sharded window, and no other kernel."""
    got = {k: v for k, v in launches.items() if v}
    if got != {"ffd_scan_fleet": windows, "cost_sum": windows}:
        raise AssertionError(f"{label}: {windows} sharded window(s) "
                             f"launched {got}, want one ffd_scan_fleet and "
                             f"one cost_sum each")


def phase_sharded(dev, card: str, pods, catalog) -> dict:
    """(o) The headline window through ``make_solver(SolverOptions(
    sharded=2))``: one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
    window, each shard's raw row equal to the plain CPU solve of its
    buffer, the plan equal to the CPU sharded solver's and clean; warm
    p50 of 20 windows beside ``TorchSolver``'s; then the same window
    through ``ShardedSolveService(4)``."""
    from karpenter_tpu_torch import make_solver
    from karpenter_tpu_torch.sharded.service import ShardedSolveService
    from karpenter_tpu_torch.sharded.solver import ShardedSolver

    S = SHARDED["shards"]
    solver = make_solver(SolverOptions(sharded=S), device=dev)
    if type(solver) is not ShardedSolver or solver.service.num_shards != S:
        raise AssertionError(f"make_solver(sharded={S}) gave {solver!r}")
    kicks = keep_kicks(solver.service)
    request = SolveRequest(pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_window_launches(launches, "sharded window")
    window = kicks[-1].window
    cpu_ct = [t.cpu() for t in solver.service._catalog_tensors(
        catalog, window.O_pad)]
    rows_equal_singles("sharded window", kicks[-1], cpu_ct, "cpu")
    plans_equal("sharded window", plan, ShardedSolver(
        S, device="cpu").solve(request))
    scan = shard_scan_check(dev, "sharded headline window", window,
                            solver.service._catalog_tensors(
                                catalog, window.O_pad), card)
    clean_and_placed("sharded window", plan, pods, catalog,
                     placed=plan.placed_count)
    walls = []
    for _ in range(SHARDED["warm"]):
        reset_launches()
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
        require_window_launches(launch_counts(), "warm sharded window")
    mode = solver.last_stats["resident_mode"]
    if mode != "hit":
        raise AssertionError(f"warm sharded window took mode {mode!r}")
    single = TorchSolver(device=dev)
    single.solve(request)
    torch_walls = warm_walls(single, request, SHARDED["warm"])

    wide = ShardedSolveService(SHARDED["wide"], device=dev)
    wkicks = keep_kicks(wide)
    reset_launches()
    t0 = time.perf_counter()
    wplan = wide.solve_window(catalog, pods=pods)
    wide_cold_s = time.perf_counter() - t0
    wl = launch_counts()
    require_window_launches(wl, f"ShardedSolveService({SHARDED['wide']})")
    rows_equal_singles(f"{SHARDED['wide']}-shard window", wkicks[-1],
                       cpu_ct, "cpu")
    merged = wplan.merged()
    clean_and_placed(f"{SHARDED['wide']}-shard window", merged, pods,
                     catalog, placed=merged.placed_count)
    wide_walls = []
    for _ in range(SHARDED["warm"] // 2):
        t0 = time.perf_counter()
        wide.solve_window(catalog, pods=pods)
        wide_walls.append(time.perf_counter() - t0)
    out = {"launches": {k: launches.get(k, 0) + wl.get(k, 0)
                        for k in set(launches) | set(wl)},
           "p50_ms": p50_ms(walls), "torch_p50_ms": p50_ms(torch_walls),
           "cold_ms": cold_s * 1e3, "walls_ms": [x * 1e3 for x in walls],
           "shapes": window.shapes, "shard_pods": window.shard_pods,
           "nodes": len(plan.nodes), "placed": plan.placed_count,
           "cost": plan.total_cost_per_hour, "scan": scan,
           "wide": {"shards": SHARDED["wide"],
                    "shapes": wkicks[-1].window.shapes,
                    "shard_pods": wkicks[-1].window.shard_pods,
                    "cold_ms": wide_cold_s * 1e3,
                    "p50_ms": p50_ms(wide_walls),
                    "placed": merged.placed_count}}
    say(f"sharded window: the headline through make_solver(sharded={S}) "
        f"(G, O, U, N = {window.shapes}, pods per shard "
        f"{window.shard_pods}): {len(plan.nodes)} nodes, "
        f"{plan.placed_count} placed, cost {plan.total_cost_per_hour:.4f} "
        f"$/h; one ffd_scan_fleet and one cost_sum per window over "
        f"{1 + SHARDED['warm']} windows; every shard row equal to the plain "
        f"CPU solve of its buffer word for word; plan equal to the CPU "
        f"sharded solver's and clean; ShardedSolveService({SHARDED['wide']}"
        f"): pods per shard {out['wide']['shard_pods']}, rows equal, "
        f"{merged.placed_count} placed, clean")
    say(f"timing [{card}]: sharded window warm p50 {out['p50_ms']:.4f} ms "
        f"(cold {out['cold_ms']:.3f} ms) against TorchSolver "
        f"{out['torch_p50_ms']:.4f} ms on the same window; "
        f"{SHARDED['wide']} shards {out['wide']['p50_ms']:.4f} ms (cold "
        f"{out['wide']['cold_ms']:.3f} ms)")
    return out


def sharded_stream_pods(rng, n: int, tag: str) -> list:
    """``bench.py::run_sharded``'s pods: 100-900m CPU, 256-2048 Mi."""
    return [pod_api.PodSpec(f"{tag}{rng.randint(1 << 30)}-{i}",
                            requests=pod_api.ResourceRequests(
                                int(rng.randint(100, 900)),
                                int(rng.randint(256, 2048)), 0, 1))
            for i in range(n)]


def sharded_churn(seed: int) -> list:
    """One seed's churn: ``rounds`` windows of SHARDED["pods"] pods, each
    round dropping 1-15 pods and adding 8-24."""
    rng = np.random.RandomState(seed)
    pods = sharded_stream_pods(rng, SHARDED["pods"], "s")
    seqs = []
    for _ in range(SHARDED["rounds"]):
        seqs.append(list(pods))
        pods = pods[int(rng.randint(1, 16)):] \
            + sharded_stream_pods(rng, int(rng.randint(8, 24)), "s")
    return seqs


def phase_sharded_churn(dev, card: str, catalog) -> dict:
    """(p) ``bench.py::run_sharded`` at 10k pods x 500 types: 4 seeds of
    4 churn rounds through one ``ShardedSolveService(2)`` each, every
    window's rows equal to single solves of its shards' buffers on the
    card, its resident mode and delta words; the hash-skewed stream's
    decisions against ``rebalance_oracle``; aggregate and single-shard
    pods/s."""
    from karpenter_tpu_torch.resident.kernels import new_state
    from karpenter_tpu_torch.sharded.kernels import (
        rebalance_oracle, solve_shards,
    )
    from karpenter_tpu_torch.sharded.router import craft_hot_requests
    from karpenter_tpu_torch.sharded.service import ShardedSolveService
    from karpenter_tpu_torch.sharded.validate import (
        partition_violations, rebalance_violations, state_violations,
    )

    S = SHARDED["shards"]
    launches: dict = {}
    modes, words, walls, shapes = [], [], [], set()
    windows = 0
    for k in range(SHARDED["seeds"]):
        svc = ShardedSolveService(S, device=dev)
        kicks = keep_kicks(svc)
        for r, pods in enumerate(sharded_churn(SHARDED["seed0"] + k)):
            reset_launches()
            t0 = time.perf_counter()
            svc.solve_window(catalog, pods=pods)
            walls.append(time.perf_counter() - t0)
            got = launch_counts()
            require_window_launches(got, f"churn seed {k} round {r}")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
            kick = kicks[-1]
            rows_equal_singles(f"churn seed {k} round {r}", kick,
                               svc._catalog_tensors(catalog,
                                                    kick.window.O_pad), dev)
            modes.append(kick.delta.mode)
            words.append(kick.delta.words)
            shapes.add(kick.window.shapes)
            errors = state_violations(svc, pods, catalog) \
                + partition_violations(svc, pods)
            if errors:
                raise AssertionError(f"churn seed {k} round {r}: "
                                     f"{errors[:3]}")
            windows += 1
    if "rebuild" not in modes or "delta" not in modes:
        raise AssertionError(f"sharded churn modes {modes}")

    # the hash-skewed stream: must migrate, every decision the oracle's
    rng = np.random.RandomState(SHARDED["hot_seed"])
    skewed = [pod_api.PodSpec(f"hot{made}-{i}",
                              requests=pod_api.ResourceRequests(
                                  hcpu, hmem, 0, 1))
              for made, (hcpu, hmem) in enumerate(
                  craft_hot_requests(S, 0, count=SHARDED["hot"]))
              for i in range(int(rng.randint(2, 6)))]
    hot = ShardedSolveService(S, device=dev)
    hot.admit(skewed)
    migrations, decisions = 0, []
    for _ in range(SHARDED["hot_windows"]):
        hot.solve_window(catalog)
        dec = hot.rebalance()
        bad = rebalance_violations(hot, dec)
        if bad or tuple(int(v) for v in dec.tile[0, :4]) \
                != rebalance_oracle(dec.pressure):
            raise AssertionError(f"rebalance decision: {bad}")
        migrations += len(dec.moved_keys)
        decisions.append((dec.donor, dec.receiver, dec.amount, dec.skew,
                          len(dec.moved_keys)))
    if migrations <= 0:
        raise AssertionError("the hash-skewed stream migrated nothing")

    # throughput: the stacked solve of one window against shard 0 alone
    pods = sharded_stream_pods(np.random.RandomState(11), SHARDED["pods"],
                               "t")
    svc = ShardedSolveService(S, device=dev)
    kicks = keep_kicks(svc)
    svc.solve_window(catalog, pods=pods)
    w = kicks[-1].window
    ct = svc._catalog_tensors(catalog, w.O_pad)
    L = w.stacked.shape[1]
    didx = torch.full((S, 64), L, dtype=torch.int32, device=dev)
    dval = torch.zeros((S, 64), dtype=torch.int32, device=dev)
    kw = dict(G=w.G_pad, O=w.O_pad, U=w.U_pad, N=w.N)
    scan = shard_scan_check(dev, "10k-pod churn window", w, ct, card)

    def agg_once():
        _, out = solve_shards(new_state(w.stacked, dev), didx, dval,
                              *ct, **kw)
        out.cpu()

    def single_once():
        tp.solve_packed_torch(torch.from_numpy(w.stacked[0]).to(dev), *ct,
                              **kw).cpu()

    agg_once()
    single_once()
    agg_s, single_s = [], []
    for _ in range(SHARDED["tput_windows"]):
        t0 = time.perf_counter()
        agg_once()
        agg_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        single_once()
        single_s.append(time.perf_counter() - t0)
    agg_rate = len(pods) / (p50_ms(agg_s) / 1e3)
    single_rate = w.shard_pods[0] / (p50_ms(single_s) / 1e3)
    warm = [x for x, m in zip(walls, modes) if m != "rebuild"]
    out = {"launches": launches, "windows": windows, "modes": modes,
           "delta_words": words, "shapes": sorted(shapes),
           "window_p50_ms": p50_ms(walls),
           "warm_window_p50_ms": p50_ms(warm) if warm else None,
           "migrations": migrations, "decisions": decisions,
           "agg_pods_per_s": agg_rate, "single_pods_per_s": single_rate,
           "linearity": agg_rate / (S * single_rate),
           "agg_p50_ms": p50_ms(agg_s), "single_p50_ms": p50_ms(single_s),
           "tput_shapes": w.shapes, "tput_shard_pods": w.shard_pods,
           "scan": scan}
    say(f"sharded churn: {SHARDED['seeds']} seeds x {SHARDED['rounds']} "
        f"rounds of {SHARDED['pods']} pods x {SHARDED['types']} types "
        f"(shapes {sorted(shapes)}): every window one ffd_scan_fleet and "
        f"one cost_sum, every shard row equal to a single solve of its "
        f"buffer on the card word for word, state and partition checks "
        f"clean; modes {modes}; delta words {words}; hash-skewed stream: "
        f"{migrations} migrations, decisions {decisions}, each equal to "
        f"rebalance_oracle")
    say(f"timing [{card}]: sharded churn window p50 {out['window_p50_ms']:.4f}"
        f" ms (warm {out['warm_window_p50_ms']} ms); stacked solve "
        f"{out['agg_p50_ms']:.4f} ms for {len(pods)} pods = "
        f"{agg_rate:.1f} pods/s, shard 0 alone {out['single_p50_ms']:.4f} "
        f"ms for {w.shard_pods[0]} pods = {single_rate:.1f} pods/s, ratio "
        f"{out['linearity']:.4f} of {S} x single (one card: not gated)")
    return out


class GcCount:
    """Python garbage collections (count and seconds) while it is on."""

    def __init__(self):
        self.n, self.s, self._t0 = 0, 0.0, 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.n += 1
            self.s += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def read(self) -> dict:
        return {"collections": self.n, "seconds": self.s}


def host_profile(fn, top: int = 16) -> list:
    """``cProfile`` of ``fn()``: the port's ``top`` functions by
    cumulative seconds, as ``[file:line(function), seconds]``."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(((v[3], f"{k[0].rsplit('karpenter_tpu_torch/', 1)[-1]}:"
                          f"{k[1]}({k[2]})")
                   for k, v in pstats.Stats(prof).stats.items()
                   if "karpenter_tpu_torch" in k[0]), reverse=True)
    return [[name, t] for t, name in rows[:top]]


def phase_sharded_serving(dev, card: str, catalog) -> dict:
    """(q) Seed 0's churn stream through ``ShardedServingLoop(capacity=
    2)``: every plan equal to ``solve_window``'s on a second service, the
    overlap fraction, and the port's sharded parity checks.  Both timed
    passes follow an untimed one over the same windows; each reads the
    wall of every submit, result or window and the garbage collections
    inside it.  Then a ``cProfile`` of one more service's warm windows
    says where the host's time goes."""
    from karpenter_tpu_torch.serving.service import ShardedServingLoop
    from karpenter_tpu_torch.serving.validate import (
        sharded_parity_violations,
    )
    from karpenter_tpu_torch.sharded.service import ShardedSolveService

    S = SHARDED["shards"]
    seqs = sharded_churn(SHARDED["seed0"])
    # one untimed pass first, so that both timed passes read the encode
    # memo and the pods' cached signatures
    warm = ShardedSolveService(S, device=dev)
    for pods in seqs:
        warm.solve_window(catalog, pods=pods)
    loop = ShardedServingLoop(ShardedSolveService(S, device=dev),
                              capacity=SHARDED["capacity"])
    reset_launches()
    submit_ms, result_ms = [], []
    with GcCount() as loop_gc:
        t0 = time.perf_counter()
        handles = []
        for pods in seqs:
            t1 = time.perf_counter()
            handles.append(loop.submit(catalog, pods=pods))
            submit_ms.append((time.perf_counter() - t1) * 1e3)
        plans = []
        for h in handles:
            t1 = time.perf_counter()
            plans.append(h.result())
            result_ms.append((time.perf_counter() - t1) * 1e3)
        served_ms = (time.perf_counter() - t0) * 1e3 / len(seqs)
    launches = launch_counts()
    require_window_launches(launches, "sharded serving loop", len(seqs))
    classic = ShardedSolveService(S, device=dev)
    walls = []
    with GcCount() as classic_gc:
        for r, (pods, plan) in enumerate(zip(seqs, plans)):
            t0 = time.perf_counter()
            want = classic.solve_window(catalog, pods=pods)
            walls.append(time.perf_counter() - t0)
            for s, (a, b) in enumerate(zip(plan.plans, want.plans)):
                plans_equal(f"sharded serving round {r} shard {s}", a, b)
    # profiled before the parity checks, whose windows would evict these
    # windows' shard problems from the encode memo (8 entries)
    profiled = ShardedSolveService(S, device=dev)
    profiled.solve_window(catalog, pods=seqs[0])

    def warm_windows():
        for pods in seqs[1:]:
            profiled.solve_window(catalog, pods=pods)

    profile = host_profile(warm_windows)
    parity = sharded_parity_violations(seeds=4, device=dev)
    if parity:
        raise AssertionError(f"sharded serving parity: {parity[:3]}")
    st = loop.stats()
    out = {"launches": launches, "stats": st,
           "overlap_fraction": loop.overlap_fraction,
           "served_ms_per_window": served_ms,
           "submit_ms": submit_ms, "result_ms": result_ms,
           "served_gc": loop_gc.read(),
           "classic_mean_ms": sum(walls) * 1e3 / len(walls),
           "classic_p50_ms": p50_ms(walls),
           "classic_ms": [x * 1e3 for x in walls],
           "classic_gc": classic_gc.read(),
           "profile_windows": len(seqs) - 1,
           "profile_cumulative_s": profile}
    say(f"sharded serving: {len(seqs)} windows of seed "
        f"{SHARDED['seed0']}'s churn through ShardedServingLoop(capacity="
        f"{SHARDED['capacity']}): every plan equal to solve_window's, "
        f"launches {launches}, {st}; the port's 4-seed sharded parity "
        f"checks clean")
    say(f"timing [{card}]: sharded serving {served_ms:.4f} ms per window "
        f"(amortized; submits {fmt_ms(submit_ms)}, results "
        f"{fmt_ms(result_ms)} ms; {loop_gc.n} collections, "
        f"{loop_gc.s * 1e3:.4f} ms) against solve_window "
        f"{out['classic_mean_ms']:.4f} ms per window (amortized; windows "
        f"{fmt_ms(out['classic_ms'])} ms, p50 {out['classic_p50_ms']:.4f} "
        f"ms; {classic_gc.n} collections, {classic_gc.s * 1e3:.4f} ms); "
        f"overlap fraction {loop.overlap_fraction:.4f}")
    say(f"host profile [{card}]: {len(seqs) - 1} warm solve_window calls, "
        f"cumulative seconds: " + "; ".join(
            f"{name} {t:.4f}" for name, t in profile))
    return out


def repack_fleet(cfg: dict):
    """``bench.py::run_repack``'s fleet: (catalog, cluster)."""
    catalog = workload.build_catalog(cfg["types"])
    rng = np.random.RandomState(cfg["seed"])
    cluster = ClusterState()
    pod_i = 0
    for i in range(cfg["claims"]):
        cluster.add_nodeclaim(NodeClaim(
            name=f"rc{i}", instance_type="bx2-16x64", zone="us-south-1",
            node_name=f"node-rc{i}", hourly_price=0.8, launched=True,
            initialized=True))
        for _ in range(cfg["pods_per_claim"]):
            name = f"rp{pod_i}"
            pod_i += 1
            cluster.add_pod(pod_api.PodSpec(name, requests=pod_api.
                                            ResourceRequests(
                                                int(rng.randint(100, 1000)),
                                                int(rng.randint(256, 2048)),
                                                0, 1)))
            cluster.bind_pod(f"default/{name}", f"node-rc{i}")
    return catalog, cluster


def defrag_fleet():
    """``bench.py::_run_repack_defrag``'s torus case: (catalog,
    cluster)."""
    catalog = workload.build_catalog(24, ("gx3", "bx2", "cx2"))
    cluster = ClusterState()
    pk = 0
    for i in range(2):
        cluster.add_nodeclaim(NodeClaim(
            name=f"dz{i}", instance_type="gx3-64x512", zone="us-south-1",
            node_name=f"node-dz{i}", hourly_price=3.0, launched=True,
            initialized=True))
        for _ in range(3 if i == 0 else 1):
            cluster.add_pod(pod_api.PodSpec(
                f"dsg{pk}", requests=pod_api.ResourceRequests(500, 1024, 2,
                                                              1)))
            cluster.bind_pod(f"default/dsg{pk}", f"node-dz{i}")
            pk += 1
    gang = PodGroup(name="bench-parked", min_member=4, slice_shape="2x2x2",
                    deadline_seconds=1e9)
    for j in range(4):
        cluster.add_pod(pod_api.PodSpec(
            f"dgm{j}", requests=pod_api.ResourceRequests(250, 512, 0, 1),
            gang=gang))
    return catalog, cluster


def repack_fingerprint(plan):
    return ([(m.pod_key, m.src_claim, m.dst_claim, m.kind)
             for m in plan.migrations], plan.drained,
            [(r.claim_name, r.shape, r.pre_mask, r.post_mask)
             for r in plan.reopened], plan.proposed_cost)


def phase_repack(dev, card: str) -> dict:
    """(r) ``bench.py::run_repack``'s fleet through the repack planner:
    the torch grid on the card reading the resident occupancy rows, and
    the numpy grid; equal plans, ``validate_repack_plan`` clean; then the
    torus-defrag case on both routes."""
    from karpenter_tpu_torch.repack import (
        RepackOptions, RepackPlanner, encode_repack,
    )
    from karpenter_tpu_torch.resident.store import (
        OccupancySnapshot, ResidentStore,
    )
    from karpenter_tpu_torch.solver.validate import validate_repack_plan

    catalog, cluster = repack_fleet(REPACK)
    store = ResidentStore(device=dev)
    t0 = time.perf_counter()
    prob = encode_repack(cluster, catalog,
                         snapshot=OccupancySnapshot(cluster), store=store)
    encode_ms = (time.perf_counter() - t0) * 1e3
    if prob.rows_dev is None or prob.rows_dev.device.type != "cuda":
        raise AssertionError("the repack problem did not take the resident "
                             "occupancy rows on the card")
    t0 = time.perf_counter()
    fresh = encode_repack(cluster, catalog)
    fresh_ms = (time.perf_counter() - t0) * 1e3
    on = RepackPlanner(RepackOptions(use_device="on"), device=dev)
    off = RepackPlanner(RepackOptions(use_device="off"), device="cpu")
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(prob)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "repack path")
    ref = off.plan(fresh)
    if on.device_steps != 1 or plan.backend != "device" \
            or repack_fingerprint(plan) != repack_fingerprint(ref):
        raise AssertionError(f"repack plan on the card ({on.device_steps} "
                             f"torch grids, backend {plan.backend}) differs "
                             f"from the numpy grid's")
    errors = validate_repack_plan(plan, cluster, catalog)
    if errors:
        raise AssertionError(f"validate_repack_plan: {errors[:3]}")
    if not plan.migrations or plan.savings <= 0:
        raise AssertionError("the oversized fleet repacked nothing")
    on_ms = timed_p50(lambda: on.plan(prob), REPACK["iters"])
    off_ms = timed_p50(lambda: off.plan(fresh), REPACK["iters"])

    dcat, dcl = defrag_fleet()
    dprob = encode_repack(dcl, dcat)
    dplans = [RepackPlanner(RepackOptions(use_device=u), device=d).plan(
        dprob) for u, d in (("on", dev), ("off", "cpu"))]
    if repack_fingerprint(dplans[0]) != repack_fingerprint(dplans[1]) \
            or dplans[0].slices_reopened < 1 \
            or validate_repack_plan(dplans[0], dcl, dcat):
        raise AssertionError(f"torus defrag: reopened "
                             f"{[p.slices_reopened for p in dplans]}")
    out = {"launches": launches, "migrations": plan.migration_count,
           "drained": len(plan.drained), "savings": plan.savings,
           "savings_fraction": plan.savings_fraction,
           "card_p50_ms": on_ms, "numpy_p50_ms": off_ms,
           "cold_ms": cold_s * 1e3, "encode_store_ms": encode_ms,
           "encode_fresh_ms": fresh_ms,
           "defrag": {"slices_reopened": dplans[0].slices_reopened,
                      "migrations": dplans[0].migration_count}}
    say(f"repack path: {REPACK['claims']} claims x {REPACK['types']} types "
        f"({REPACK['pods_per_claim']} pods each): {plan.migration_count} "
        f"migrations, {len(plan.drained)} drained, savings "
        f"{plan.savings:.4f} $/h ({plan.savings_fraction:.4f}); the torch "
        f"grid on the card read the resident occupancy rows, plan equal to "
        f"the numpy grid's on a fresh encode; validate_repack_plan clean; "
        f"launches {launches} (the grid is PyTorch ops); torus defrag: "
        f"{dplans[0].slices_reopened} slice(s) reopened by "
        f"{dplans[0].migration_count} migrations, equal on both routes, "
        f"clean")
    say(f"timing [{card}]: repack plan warm p50 {on_ms:.4f} ms with the "
        f"grid on the card (cold {cold_s * 1e3:.3f} ms), numpy grid "
        f"{off_ms:.4f} ms; encode through the store {encode_ms:.3f} ms, "
        f"fresh {fresh_ms:.3f} ms")
    return out


# -- phase 5: timings ---------------------------------------------------------


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of an input read once: a catalog expanded over the problems
    (stride 0) is one catalog."""
    n = int(t.numel() * t.element_size())
    if t.dim() > 1 and t.stride(0) == 0:
        n //= t.shape[0]
    return n


def scan_bound_ms(meta, compat, alloc, rank, N: int, assign, node_off):
    """The least time the card could take for the scan of C problems:
    the larger of the bytes it must move (inputs read once, outputs
    written once) over the HBM rate, and the scalar operations this run's
    data needs (open nodes at each group's step, every offering, per
    problem) over the scalar rate."""
    G, O = compat.shape[-2:]
    assign = assign.reshape(-1, G, N)
    node_off = node_off.reshape(-1, N)
    C = assign.shape[0]
    nbytes = sum(_read_bytes(t) for t in (meta, compat, alloc, rank)) \
        + 4 * C * (N + G * N + G)
    ops = 0
    for a, no in zip(assign, node_off):
        first = np.where((a > 0).any(axis=0), (a > 0).argmax(axis=0),
                         G)[no >= 0]
        open_before = np.searchsorted(np.sort(first), np.arange(G), "left")
        ops += OPS_PER_NODE * int(open_before.sum()) \
            + OPS_PER_OFFERING * G * O
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _is_launch(e) -> bool:
    """A host-side CUDA API record that starts one kernel
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``,
    ...); its id is the CUPTI correlation id its kernel carries."""
    return e.name.startswith("cu") and "Launch" in e.name \
        and "HostFunc" not in e.name


def profile_spans(run, spans: int, tag: str) -> dict | None:
    """Device kernels and busy share of ``spans`` warm calls of ``run``,
    from a ``torch.profiler`` trace: each call is a ``tag`` range on the
    host.  A span's kernels are the kernel launches the host issued
    inside its range (any thread), each joined to its device kernel by
    correlation id; a launch whose device record the trace lost still
    counts, and a device kernel whose launch record it lost counts apart
    (``unattributed``).  The device's kernel/copy intervals inside the
    ranges are merged into busy time.  The profiler slows the host, so
    the busy share read here is a lower bound on the unprofiled one.
    Returns None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(spans):
            with record_function(tag):
                run()
        # the last span's kernels end inside the trace
        torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == tag and e.device_type == DeviceType.CPU)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != tag]
    if not device or len(ranges) != spans:
        return None
    launches = [e for e in events
                if e.device_type == DeviceType.CPU and _is_launch(e)]
    kernel_ids = {e.id for e in device
                  if not e.name.startswith(("Memcpy", "Memset"))}
    per_span = [sorted({e.id for e in launches
                        if lo <= e.time_range.start <= hi})
                for lo, hi in ranges]
    in_spans = {i for ids in per_span for i in ids}
    launch_ids = {e.id for e in launches}
    busy = 0.0
    for lo, hi in ranges:
        cut = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                     for e in device)
        end = lo
        for s, t in cut:
            if t > max(s, end):
                busy += t - max(s, end)
                end = t
    span_us = sum(hi - lo for lo, hi in ranges)
    unattributed = len(kernel_ids - launch_ids)
    return {"spans": spans,
            "kernels_by_span": [len(ids) for ids in per_span],
            "kernels_per_span": (len(in_spans) + unattributed) / spans,
            "device_records_lost": len(in_spans - kernel_ids),
            "unattributed": unattributed,
            "device_events_per_span": len(device) / spans,
            "profiled_span_ms": span_us / spans / 1e3,
            "device_busy_ms": busy / spans / 1e3,
            "device_busy_share": busy / span_us}


def kernels_per_call(run, tag: str, counter: dict, key: str,
                     spans: int = 20, tries: int = 3) -> int:
    """The device kernels one call of ``run`` issues, an exact integer
    read from ``profile_spans``: every span must hold the same count, no
    device kernel may lack its launch record, and the spans must hold at
    least as many launches as ``counter[key]`` (a wrapper's LAUNCHES)
    grew by over the same calls.  A trace that falls short is taken
    again, up to ``tries`` times; then the call raises."""
    why = ""
    for _ in range(tries):
        before = counter[key]
        prof = profile_spans(run, spans, tag)
        grew = counter[key] - before
        if prof is None:
            why = "the trace holds no device events"
            continue
        counts = prof["kernels_by_span"]
        if prof["unattributed"] or len(set(counts)) != 1 \
                or sum(counts) < grew:
            why = (f"kernels by span {counts}, {prof['unattributed']} "
                   f"device kernels without a launch record, {grew} "
                   f"{key} launches counted")
            continue
        return counts[0]
    raise AssertionError(f"{tag}: kernels per call not read exactly from "
                         f"torch.profiler in {tries} traces: {why}")


def phase_timings(dev, solver, request, problem, card: str) -> dict:
    walls, stats = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
        stats.append(dict(solver.last_stats))
    p50 = float(np.percentile(walls, 50)) * 1e3
    host = {k: float(np.median([s[k] for s in stats])) * 1e3
            for k in ("prepare_s", "dispatch_s", "exec_fetch_s",
                      "decode_s", "wall_s")}

    # device phases of one window, on the window's own tensors
    prep = solver._prepare(problem)
    G, O, U, N = prep.G_pad, prep.O_pad, prep.U_pad, prep.N
    off_alloc, off_price, off_rank = solver.device_offerings(
        request.catalog, O)
    pinned = torch.from_numpy(prep.packed).pin_memory()
    packed = pinned.to(dev)
    meta, compat_i, rows_g = tp.unpack_problem(packed, off_alloc, G, O, U)
    meta3, compat3 = meta[None].contiguous(), compat_i[None].contiguous()
    node_off, assign, unplaced = (x[0] for x in ffd_kernel.ffd_scan(
        meta3, compat3, off_alloc, off_rank, N))
    out = tp.solve_packed_torch(packed, off_alloc, off_price, off_rank,
                                G=G, O=O, U=U, N=N, compact=prep.K,
                                dense16=prep.dense16, coo16=prep.coo16)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    phases = {
        "h2d": cuda_ms(lambda: packed.copy_(pinned, non_blocking=True), 50),
        "unpack": cuda_ms(lambda: tp.unpack_problem(packed, off_alloc, G, O,
                                                    U), 50),
        "kernel": cuda_ms(lambda: ffd_kernel.ffd_scan(
            meta3, compat3, off_alloc, off_rank, N), 50),
        "right_size_cost": cuda_ms(lambda: tp.cost_word(tp.finish_solve(
            meta, compat_i, node_off, assign, off_alloc, off_rank, True),
            off_price), 20),
        "pack_explain_telemetry": cuda_ms(lambda: tp.pack_result_telemetry(
            meta, rows_g, compat_i, node_off, assign, unplaced,
            off_price.sum(), off_alloc, prep.K, prep.dense16, prep.coo16),
            20),
        "d2h": cuda_ms(lambda: host_out.copy_(out, non_blocking=True), 50),
        "solve_packed_total": cuda_ms(lambda: tp.solve_packed_torch(
            packed, off_alloc, off_price, off_rank, G=G, O=O, U=U, N=N,
            compact=prep.K, dense16=prep.dense16, coo16=prep.coo16), 20),
    }
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        meta3, compat3, off_alloc, off_rank, N), 3, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        meta3, compat3, off_alloc, off_rank, N, assign.cpu().numpy(),
        node_off.cpu().numpy())
    cs = cost_sum_timing("the main-path window", tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True),
        off_price, card)

    # encode, cold (memo and signature caches cleared) and warm
    encode_mod._ENCODE_MEMO.clear()
    encode_mod.clear_sig_cache()
    t0 = time.perf_counter()
    encode_mod.encode(request.pods, request.catalog)
    enc_cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    encode_mod.encode(request.pods, request.catalog)
    enc_warm = (time.perf_counter() - t0) * 1e3

    say(f"timing [{card}]: p50 wall of 20 warm windows {p50:.4f} ms "
        f"(min {min(walls) * 1e3:.4f}, max {max(walls) * 1e3:.4f}); host "
        f"medians: prepare {host['prepare_s']:.4f} ms, dispatch "
        f"{host['dispatch_s']:.4f} ms, exec+fetch "
        f"{host['exec_fetch_s']:.4f} ms, decode {host['decode_s']:.4f} ms")
    say(f"timing [{card}]: encode cold {enc_cold:.3f} ms, warm (memo) "
        f"{enc_warm:.4f} ms")
    say(f"timing [{card}]: device phases of one window (CUDA events, "
        f"G={G} O={O} U={U} N={N}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in phases.items()))
    prof = profile_spans(lambda: solver.solve(request), 5, "solve_window")
    if prof is None:
        say(f"profile [{card}]: torch.profiler recorded no device events; "
            f"launches and device busy share not measured")
    else:
        say(f"profile [{card}]: {prof['spans']} warm windows under "
            f"torch.profiler: {prof['kernels_per_span']:.1f} kernels and "
            f"{prof['device_events_per_span']:.1f} device events (kernels "
            f"+ copies) per window; device busy "
            f"{prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled window (busy "
            f"share {prof['device_busy_share']:.4f})")
    say(f"timing [{card}]: ffd_scan kernel {phases['kernel']:.4f} ms "
        f"({phases['kernel'] / G * 1e3:.4f} us per group step, G={G}), "
        f"plain PyTorch version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes, {ops} scalar ops); no single "
        f"PyTorch call computes the scan (library_ms null)")
    return {"p50_wall_ms": p50, "walls_ms": [w * 1e3 for w in walls],
            "host_ms": host, "device_phases_ms": phases, "profile": prof,
            "encode_cold_ms": enc_cold, "encode_warm_ms": enc_warm,
            "shape": {"G": G, "O": O, "U": U, "N": N},
            "ffd_scan": {"ms": phases["kernel"], "plain_ms": plain_ms,
                         "us_per_step": phases["kernel"] / G * 1e3,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": ops},
            "cost_sum": cs,
            "ffd_scan_largest": largest_scan_ms(dev, card)}


def largest_scan_ms(dev, card: str) -> dict:
    """``ffd_scan``'s own time at the largest shape the checks run, G=2048
    O=4096 N=4096 (C=1), beside its plain version (one run) and bound."""
    G, O, N = 2048, 4096, 4096
    meta, compat, alloc, rank = (torch.from_numpy(x).to(dev) for x in
                                 scan_inputs(100, G, O))
    m, c = meta[None], compat[None]
    node_off, assign, _ = ffd_kernel.ffd_scan(m, c, alloc, rank, N)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan(m, c, alloc, rank, N), 10)
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        m, c, alloc, rank, N), 1, warm=0)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        m, c, alloc, rank, N, assign.cpu().numpy(), node_off.cpu().numpy())
    say(f"timing [{card}]: ffd_scan at the largest shape G={G} O={O} N={N}: "
        f"kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group step), plain "
        f"PyTorch version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes, {ops} scalar ops)")
    return {"G": G, "O": O, "N": N, "ms": ms, "us_per_step": ms / G * 1e3,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops}


def fleet_scan_ms(dev, fleet: dict, card: str) -> dict:
    """``ffd_scan_fleet``'s own time at C = 8 on the fleet's unpacked
    tensors (a catalog per cluster), beside its plain version and bound."""
    stacked, N, U = fleet["stacked"], fleet["N"], fleet["U"]
    C, G, O = stacked.compat.shape
    alloc, rank, _ = fleet["dev_catalog"]
    ins = torch.from_numpy(fleet["packed"][0]).to(dev)
    metas, compats, _ = torch.func.vmap(
        lambda p, a: tp.unpack_problem(p, a, G, O, U))(ins, alloc)
    metas = metas.contiguous()
    return scan_times(dev, f"fleet C={C} (a catalog per cluster)", N,
                      metas, compats, alloc, rank, card)


def stream_scan_ms(dev, solver, windows, card: str) -> dict:
    """``ffd_scan_fleet``'s own time at C = 16 on one stream batch's
    unpacked tensors (the headline catalog expanded, stride 0)."""
    preps = [solver._prepare(p) for _, p in windows[:STREAM["batch"]]]
    p0 = preps[0]
    G, O, U = p0.G_pad, p0.O_pad, p0.U_pad
    N = max(pr.N for pr in preps)
    off_alloc, _, off_rank = solver.device_offerings(windows[0][1].catalog,
                                                     O)
    rows = torch.from_numpy(np.stack([pr.packed for pr in preps])).to(dev)
    metas, compats, _ = torch.func.vmap(
        lambda p: tp.unpack_problem(p, off_alloc, G, O, U))(rows)
    C = rows.shape[0]
    return scan_times(dev, f"stream batch C={C} (one catalog, stride 0)",
                      N, metas.contiguous(), compats,
                      off_alloc.expand(C, O, 4), off_rank.expand(C, O),
                      card)


def scan_times(dev, label, N, metas, compats, alloc, rank, card) -> dict:
    node_off, assign, _ = ffd_kernel.ffd_scan_fleet(metas, compats, alloc,
                                                    rank, N)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(metas, compats, alloc,
                                                   rank, N), 20)
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet_reference(
        metas, compats, alloc, rank, N), 1, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        metas, compats, alloc, rank, N, assign.cpu().numpy(),
        node_off.cpu().numpy())
    C, G, O = compats.shape
    say(f"timing [{card}]: ffd_scan_fleet {label}, G={G} O={O} N={N}: "
        f"kernel {ms:.4f} ms ({ms / C:.4f} ms per problem, "
        f"{ms / G * 1e3:.4f} us per group step), plain PyTorch "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} scalar ops); no single PyTorch call "
        f"computes the scan (library_ms null)")
    return {"C": C, "G": G, "O": O, "N": N, "ms": ms,
            "us_per_step": ms / G * 1e3, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


def phase_batched_timings(dev, fleet: dict, stream: dict, card: str) -> dict:
    """The fleet's single-shot and pipelined walls; the stream's
    amortized per-window wall at batch 1 and 16 beside the single-window
    p50 (turns ABBA, one process); the fleet kernel's own times; the
    stream's kernels per batch and device busy share."""
    stacked, N = fleet["stacked"], fleet["N"]
    kw = dict(num_nodes=N, device=dev, device_catalog=fleet["dev_catalog"],
              packed_inputs=fleet["packed"])
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        fleet_solve_packed(stacked, **kw)
        walls.append(time.perf_counter() - t0)
    fleet_p50 = float(np.percentile(walls, 50)) * 1e3

    def fleet_pipelined(n: int, depth: int = 8) -> float:
        fins = []
        t0 = time.perf_counter()
        for _ in range(n):
            fins.append(fleet_solve_packed(stacked, async_only=True, **kw))
            if len(fins) > depth:
                fins.pop(0)()
        while fins:
            fins.pop(0)()
        return (time.perf_counter() - t0) / n * 1e3

    fleet_pipelined(8)
    fleet_pipe = fleet_pipelined(24)
    C = stacked.num_clusters
    say(f"timing [{card}]: fleet {C} x {FLEET['pods']} pods: single-shot "
        f"p50 wall {fleet_p50:.4f} ms (min {min(walls) * 1e3:.4f}, max "
        f"{max(walls) * 1e3:.4f}, 10 solves); pipelined (async_only, depth "
        f"8, 24 windows) {fleet_pipe:.4f} ms per fleet window, "
        f"{C * FLEET['pods'] / fleet_pipe * 1e3:.1f} pods/s")

    solver, windows, order = (stream["solver"], stream["windows"],
                              stream["order"])
    problem = windows[0][1]
    single = []
    for _ in range(20):
        t0 = time.perf_counter()
        solver.solve_encoded(problem)
        single.append(time.perf_counter() - t0)
    single_p50 = float(np.percentile(single, 50)) * 1e3

    def stream_ms(batch: int) -> float:
        t0 = time.perf_counter()
        n = sum(1 for _ in solver.solve_stream(
            (windows[i][1] for i in order), depth=STREAM["depth"],
            batch=batch))
        return (time.perf_counter() - t0) / n * 1e3

    runs = {1: [], STREAM["batch"]: []}
    batch_phases = []            # host phases of each run's last batch
    for b in (1, STREAM["batch"], STREAM["batch"], 1):
        runs[b].append(stream_ms(b))
        if b > 1:
            batch_phases.append({k: solver.last_stats[k] * 1e3 for k in (
                "wall_s", "dispatch_s", "exec_fetch_s", "decode_s")})
    amort = {b: float(np.mean(v)) for b, v in runs.items()}
    say(f"timing [{card}]: stream of {len(order)} windows at depth "
        f"{STREAM['depth']}: amortized per-window wall batch=1 "
        f"{amort[1]:.4f} ms (runs {', '.join(f'{x:.4f}' for x in runs[1])})"
        f", batch={STREAM['batch']} {amort[STREAM['batch']]:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in runs[STREAM['batch']])}); "
        f"single-window solve_encoded p50 {single_p50:.4f} ms (20 solves)")
    say(f"timing [{card}]: the last batch of {STREAM['batch']} of each "
        f"batched run, host clock: " + "; ".join(
            f"dispatch {p['dispatch_s']:.4f} ms, exec+fetch "
            f"{p['exec_fetch_s']:.4f} ms, decode of the plans "
            f"{p['decode_s']:.4f} ms" for p in batch_phases))

    half = STREAM["batch"] * 2           # two batches per profiled stream
    sub = order[:half]
    profiles = {}
    for b in (1, STREAM["batch"]):
        prof = profile_spans(lambda: list(solver.solve_stream(
            (windows[i][1] for i in sub), depth=STREAM["depth"], batch=b)),
            1, f"stream_batch{b}")
        profiles[b] = prof
        if prof is None:
            say(f"profile [{card}]: stream batch={b}: torch.profiler "
                f"recorded no device events; not measured")
            continue
        units = len(sub) // b
        say(f"profile [{card}]: stream of {len(sub)} windows at batch={b} "
            f"under torch.profiler: "
            f"{prof['kernels_per_span'] / units:.1f} kernels per "
            f"{'batch' if b > 1 else 'window'} "
            f"({prof['kernels_per_span'] / len(sub):.1f} per window); "
            f"device busy {prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled stream (busy share "
            f"{prof['device_busy_share']:.4f})")
    fleet_kernel = fleet_scan_ms(dev, fleet, card)
    stream_kernel = stream_scan_ms(dev, solver, windows, card)
    return {"fleet_p50_ms": fleet_p50, "fleet_walls_ms": [w * 1e3
                                                          for w in walls],
            "fleet_pipelined_ms": fleet_pipe,
            "single_window_p50_ms": single_p50,
            "stream_amortized_ms": amort, "stream_runs_ms": runs,
            "stream_batch_phases_ms": batch_phases,
            "stream_profiles": profiles,
            "ffd_scan_fleet": fleet_kernel,
            "ffd_scan_fleet_stream": stream_kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-out", type=Path, default=None,
                        help="also write every measurement to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the batched paths run their rows through torch.func.vmap: an op with
    # no batching rule in this torch would fall back to a loop over the
    # rows, with this warning, which those paths must never do
    warnings.filterwarnings(
        "error", message=".*not yet implemented the batching rule")
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    say(f"build: {len(build_s)} kernel(s) in "
        f"{time.perf_counter() - t0:.3f} s wall: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in build_s.items()))
    for name in build_s:
        report = cuda_build.library_path(name).with_suffix(".ptxas.txt")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")

    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    tally = new_tally()
    checks = {"ffd_scan": phase_kernel_checks(dev, catalog, tally),
              "ffd_scan_fleet": phase_fleet_kernel_checks(dev, catalog,
                                                          tally)}
    design = phase_design_checks(dev, tally)
    checks["ffd_scan_pref"] = phase_pref_kernel_checks(dev, catalog, tally)
    checks["cost_sum"] = phase_cost_sum_checks(dev)
    solver, request, problem, launches, stats, cold_s, err = \
        phase_main_path(dev, pods, catalog, tally)
    checks["ffd_scan"]["max_abs_err"] = max(
        checks["ffd_scan"]["max_abs_err"], err, design["max_abs_err"])
    checks["ffd_scan_fleet"]["max_abs_err"] = max(
        checks["ffd_scan_fleet"]["max_abs_err"], design["max_abs_err"])
    checks["design"] = design
    fleet = phase_fleet(dev)
    stream = phase_stream(dev, catalog)
    zone = phase_zone(dev, pods, catalog)
    # the timings come before the routes' phases, as in the earlier
    # slices; the order does not move them beyond the host's drift
    # (tools/torch_headline_aftereffect.py)
    timing = phase_timings(dev, solver, request, problem, card)
    timing.update(phase_batched_timings(dev, fleet, stream, card))
    flat = phase_flat(dev, card)
    affinity = phase_affinity(dev, card)
    stochastic = phase_stochastic(dev, card)
    pref = phase_pref(dev, card, tally)
    checks["ffd_scan_pref"]["max_abs_err"] = max(
        checks["ffd_scan_pref"]["max_abs_err"], pref["max_abs_err"])
    # the pref window's own scan counts toward the per-group coverage
    checks["coverage"] = require_design_coverage(tally)
    resident = phase_resident(dev, card)
    serving = phase_serving(dev, card)
    fleet_resident = phase_fleet_resident(dev, fleet)
    whatif_run = phase_whatif(dev, card)
    gang = phase_gang(dev, card)
    preempt = phase_preempt(dev, card)
    sharded = phase_sharded(dev, card, pods, catalog)
    sharded_churn = phase_sharded_churn(dev, card, catalog)
    sharded_serving = phase_sharded_serving(dev, card, catalog)
    repack = phase_repack(dev, card)
    checks["ffd_scan_fleet"]["max_abs_err"] = max(
        checks["ffd_scan_fleet"]["max_abs_err"], sharded["scan"]
        ["max_abs_err"], sharded_churn["scan"]["max_abs_err"])
    checks["cost_sum"]["max_abs_err"] = max(
        checks["cost_sum"]["max_abs_err"],
        timing["cost_sum"]["max_abs_err"],
        whatif_run["cost_sum"]["max_abs_err"])
    checks["segment_sum"] = {"max_abs_err": flat["segment_sum"]["max_abs_err"],
                             "calls": flat["segment_sum"]["calls"]}
    timing["segment_sum"] = flat["segment_sum"]
    timing["ffd_scan_pref"] = pref["ffd_scan_pref"]
    timing["presence_sum"] = pref["presence_sum"]
    checks["presence_sum"] = {"max_abs_err": pref["presence_sum"]
                              ["max_abs_err"],
                              "cases": pref["presence_sum"]["cases"]}
    # launches per kernel over the paths that run it
    path_launches = {"main": launches, "fleet": fleet["launches"],
                     "stream": stream["launches"], "zone": zone["launches"],
                     "flat": flat["launches"],
                     "affinity": affinity["launches"],
                     "stochastic": stochastic["launches"],
                     "pref": pref["route"]["launches"],
                     "resident": resident["launches"],
                     "serving": serving["launches"],
                     "fleet_resident": fleet_resident["launches"],
                     "whatif": whatif_run["launches"],
                     "gang": gang["launches"],
                     "preempt": preempt["launches"],
                     "sharded": sharded["launches"],
                     "sharded_churn": sharded_churn["launches"],
                     "sharded_serving": sharded_serving["launches"],
                     "repack": repack["launches"]}
    total = {name: sum(pl.get(name, 0) for pl in path_launches.values())
             for name in KERNELS}
    say(f"launches per path: {path_launches}; over all paths {total}")

    record = []
    for name, meta in KERNELS.items():
        t = timing[name]
        record.append({"name": name, **meta, "launches": total[name],
                       "max_abs_err": checks[name]["max_abs_err"],
                       "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": t.get("library_ms"),
                       "device_ms": t.get("device_ms"),
                       "kernels_per_call": t.get("kernels_per_call")})
    if args.json_out is not None:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps({
            "card": card, "torch": torch.__version__, "build_s": build_s,
            "checks": checks, "launches": path_launches,
            "main_path_stats": {
                k: v for k, v in stats.items() if k != "telemetry"},
            "telemetry": stats.get("telemetry"), "cold_solve_s": cold_s,
            "fleet": {"N": fleet["N"], "nodes": fleet["nodes"],
                      "cold_s": fleet["cold_s"]},
            "stream_first_wall_s": stream["first_wall_s"],
            "zone": {"wall_s": zone["wall_s"],
                     "last_batch": zone["last_batch"]},
            "routes": {"flat": flat["windows"], "affinity": affinity,
                       "stochastic": stochastic, "pref": pref},
            "resident": resident, "serving": serving,
            "fleet_resident": fleet_resident, "whatif": whatif_run,
            "gang": gang, "preempt": preempt, "sharded": sharded,
            "sharded_churn": sharded_churn,
            "sharded_serving": sharded_serving, "repack": repack,
            "timing": timing, "kernels": record}, indent=1, default=str))
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
