"""Chip smoke test of the PyTorch/CUDA port (``karpenter_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the default provisioning solve of the
headline window, 10k pending pods x 500 instance types (seed 42) —
through ``TorchSolver(device="cuda").solve``, then the batched paths:
the multi-cluster fleet (8 clusters x 10k pods, each with its own
catalog) through ``fleet_solve_packed``, the window stream through
``solve_stream`` and a zone-candidate window through ``solve``, and
checks that each ran through the hand-written CUDA kernels.  Phases, in
order; any failure exits non-zero and prints no result line:

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
   rem makes.  Over all these checks, every instantiation of the chain
   kernel must have run, and the uncapped branch, the capped branch and
   the summed takes (groups that request nothing) of its step, counted
   on the host from the plain version's outputs;
4. the paths, each with every launch count set to 0 just before and
   read just after, each needing its kernels launched and no pod left
   unplaced: (a) the main path, whose plan must validate clean and
   whose packed result must equal the plain CPU solve word for word
   (the float cost word to a relative 1e-5); (b) the fleet, whose
   [C, Lo] result must equal the plain CPU fleet program word for word;
   (c) the stream of 64 windows at depth 32, batch 16, each plan equal
   to its single-window plan and clean; (d) the zone-candidate window,
   whose plan must equal the CPU solver's, with its candidate rounds
   batched;
5. timings: p50 wall of 20 warm windows, the device phases of one
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
import importlib
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from karpenter_tpu_torch import SolveRequest, TorchSolver, validate_plan
from karpenter_tpu_torch import cuda_build, workload
from karpenter_tpu_torch.apis import pod as pod_api
from karpenter_tpu_torch.apis.requirements import LABEL_ZONE
from karpenter_tpu_torch.parallel import (
    FleetProblem, fleet_device_catalog, fleet_pack_inputs,
    fleet_solve_packed,
)
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.solver.torch_backend import _pad1, _pad2
from karpenter_tpu_torch.solver.types import (
    FIT_BIG, GROUP_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, bucket,
)

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
KERNELS = {
    "ffd_scan": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:253"),
    "ffd_scan_fleet": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:304"),
}
# the module, not the ``encode`` function the solver package re-exports
encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")


def say(*parts) -> None:
    print(*parts, flush=True)


def reset_launches() -> None:
    for name in ffd_kernel.LAUNCHES:
        ffd_kernel.LAUNCHES[name] = 0


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
    """A packed result row against its plain CPU twin: every word equal
    but the float cost word, which must agree to a relative 1e-5."""
    if card.shape != plain.shape:
        raise AssertionError(f"{label}: result lengths {card.shape} vs "
                             f"{plain.shape}")
    mask = np.ones(card.shape[0], bool)
    mask[cost_word] = False
    bad = np.nonzero((card != plain) & mask)[0]
    if bad.size:
        raise AssertionError(f"{label}: packed result differs from the CPU "
                             f"in {bad.size} words, first at {bad[0]}")
    c_card = float(card[cost_word:cost_word + 1].view(np.float32)[0])
    c_cpu = float(plain[cost_word:cost_word + 1].view(np.float32)[0])
    if abs(c_card - c_cpu) > 1e-5 * max(abs(c_cpu), 1e-30):
        raise AssertionError(f"{label}: cost word {c_card} vs {c_cpu}")
    return c_card, c_cpu


def plan_view(plan):
    return ([(n.offering_index, n.pod_names) for n in plan.nodes],
            plan.unplaced_pods)


def plans_equal(label: str, got, want) -> None:
    if plan_view(got) != plan_view(want):
        raise AssertionError(f"{label}: plan differs from the reference "
                             f"plan")
    if abs(got.total_cost_per_hour - want.total_cost_per_hour) > \
            1e-5 * max(abs(want.total_cost_per_hour), 1e-30):
        raise AssertionError(f"{label}: cost {got.total_cost_per_hour} vs "
                             f"{want.total_cost_per_hour}")


def clean_and_placed(label: str, plan, pods, catalog) -> None:
    errors = validate_plan(plan, pods, catalog)
    if errors:
        raise AssertionError(f"{label}: validate_plan: {errors[:5]}")
    if plan.unplaced_pods or plan.placed_count != len(pods):
        raise AssertionError(f"{label}: placed {plan.placed_count} of "
                             f"{len(pods)}")


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


def new_tally() -> dict:
    """Over the kernel checks: the steps of each branch of the chain (from
    the plain version's outputs) and the checked scans of each
    instantiation of the chain kernel."""
    return {"branches": {"opens_nothing": 0, "uncapped": 0, "capped": 0,
                         "summed_takes": 0},
            "variants": {}}


def add_to_tally(tally: dict, label: str, meta, compat, alloc, want,
                 N: int) -> None:
    for k, v in ffd_kernel.chain_branches(meta, compat, alloc,
                                          *want).items():
        tally["branches"][k] += v
    variant = ffd_kernel.scan_variant(compat.shape[-1], N)
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
    add_to_tally(tally, label, meta[None], compat[None], alloc, want, N)
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
    add_to_tally(tally, label, meta, compat, alloc, want, N)
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


def require_design_coverage(tally: dict) -> dict:
    """Every instantiation of the chain kernel ran in the checks, and
    the uncapped branch, the capped branch and the summed takes of its
    step."""
    b, v = tally["branches"], tally["variants"]
    say(f"chain branches over the kernel checks (host count from the plain "
        f"outputs): {b}")
    for variant, labels in v.items():
        say(f"chain instantiation '{variant}': {len(labels)} checked scans, "
            f"e.g. {labels[0]!r}")
    if min(b["uncapped"], b["capped"], b["summed_takes"]) <= 0:
        raise AssertionError(f"a branch of the chain never ran: {b}")
    missing = set(ffd_kernel.VARIANTS) - set(v)
    if missing:
        raise AssertionError(f"instantiations never checked: {missing}")
    return {"branches": dict(b), "variants": {k: len(x) for k, x in
                                              v.items()}}


# -- phase 4: the main path ---------------------------------------------------


def phase_main_path(dev, pods, catalog, tally: dict):
    solver = TorchSolver(device=dev)
    request = SolveRequest(pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = dict(ffd_kernel.LAUNCHES)
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan"], "main path")
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
    launches = dict(ffd_kernel.LAUNCHES)
    require_launches(launches, ["ffd_scan_fleet"], "fleet path")
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
        f"word (cost words to 1e-5); build+encode {build_s:.3f} s, cold "
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
    launches = dict(ffd_kernel.LAUNCHES)
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan_fleet"], "stream path")
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
    launches = dict(ffd_kernel.LAUNCHES)
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan", "ffd_scan_fleet"],
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


def profile_spans(run, spans: int, tag: str) -> dict | None:
    """Device launches and busy share of ``spans`` warm calls of ``run``,
    from a ``torch.profiler`` trace: each call is a ``tag`` range on the
    host, and the device's kernel/copy intervals inside those ranges are
    merged into busy time.  The profiler slows the host, so the busy
    share read here is a lower bound on the unprofiled one.  Returns None
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(spans):
            with record_function(tag):
                run()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == tag and e.device_type == DeviceType.CPU)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != tag]
    if not device or len(ranges) != spans:
        return None
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
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
    return {"spans": spans,
            "kernels_per_span": len(kernels) / spans,
            "device_events_per_span": len(device) / spans,
            "profiled_span_ms": span_us / spans / 1e3,
            "device_busy_ms": busy / spans / 1e3,
            "device_busy_share": busy / span_us}


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
        "right_size_cost": cuda_ms(lambda: tp.finish_solve(
            meta, compat_i, node_off, assign, off_alloc, off_price,
            off_rank, True), 20),
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
    solver, request, problem, launches, stats, cold_s, err = \
        phase_main_path(dev, pods, catalog, tally)
    checks["ffd_scan"]["max_abs_err"] = max(
        checks["ffd_scan"]["max_abs_err"], err, design["max_abs_err"])
    checks["ffd_scan_fleet"]["max_abs_err"] = max(
        checks["ffd_scan_fleet"]["max_abs_err"], design["max_abs_err"])
    checks["design"] = design
    checks["coverage"] = require_design_coverage(tally)
    fleet = phase_fleet(dev)
    stream = phase_stream(dev, catalog)
    zone = phase_zone(dev, pods, catalog)
    # launches per kernel over the paths that run it
    path_launches = {"main": launches, "fleet": fleet["launches"],
                     "stream": stream["launches"], "zone": zone["launches"]}
    total = {name: sum(pl.get(name, 0) for pl in path_launches.values())
             for name in KERNELS}
    say(f"launches per path: {path_launches}; over all paths {total}")

    timing = phase_timings(dev, solver, request, problem, card)
    timing.update(phase_batched_timings(dev, fleet, stream, card))

    record = []
    for name, meta in KERNELS.items():
        t = timing[name]
        record.append({"name": name, **meta, "launches": total[name],
                       "max_abs_err": checks[name]["max_abs_err"],
                       "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": None})
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
            "timing": timing, "kernels": record}, indent=1, default=str))
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
