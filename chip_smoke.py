"""Chip smoke test of the PyTorch/CUDA port (``karpenter_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the default provisioning solve of the
headline window, 10k pending pods x 500 instance types (seed 42) —
through ``TorchSolver(device="cuda").solve`` and checks that it ran
through the hand-written CUDA kernels.  Phases, in order; any failure
exits non-zero and prints no result line:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from ``karpenter_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``karpenter_tpu_torch/_build/``;
3. hold each kernel against its plain PyTorch version on the card, with
   exact int32 equality, over seeds at the headline shape, the largest
   scan shape and edge cases;
4. the main path, with every launch count set to 0 just before and read
   just after; the plan must place all 10000 pods and validate clean,
   and the packed result must equal the plain CPU solve word for word
   (the float cost word to a relative 1e-5);
5. timings: p50 wall of 20 warm windows, the device phases of one
   window, launches and device busy share of warm windows from a
   ``torch.profiler`` trace, and each kernel's own time beside its plain
   version and its bound (none of these gates the run).

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
from pathlib import Path

import numpy as np
import torch

from karpenter_tpu_torch import SolveRequest, TorchSolver, validate_plan
from karpenter_tpu_torch import cuda_build, workload
from karpenter_tpu_torch.solver import ffd_kernel
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.solver.types import FIT_BIG

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
KERNELS = {
    "ffd_scan": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:253"),
}
# the module, not the ``encode`` function the solver package re-exports
encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")


def say(*parts) -> None:
    print(*parts, flush=True)


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
    return meta, compat, alloc_np, rank_np


def check_scan(dev, label: str, N: int, inputs) -> tuple[int, dict]:
    """Kernel vs plain version on the card; returns (max |diff|, info)."""
    meta, compat, alloc, rank = (
        x.contiguous() if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in inputs)
    got = ffd_kernel.ffd_scan(meta[None], compat[None], alloc, rank, N)
    want = ffd_kernel.ffd_scan_reference(meta[None], compat[None], alloc,
                                         rank, N)
    torch.cuda.synchronize()
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, want))
    node_off, _, unplaced = (x.cpu().numpy()[0] for x in want)
    info = {"nodes_open": int((node_off >= 0).sum()),
            "unplaced": int(unplaced.sum())}
    if err:
        for name, a, b in zip(("node_off", "assign", "unplaced"), got, want):
            bad = torch.nonzero(a != b)
            if bad.numel():
                raise AssertionError(
                    f"ffd_scan {label}: {name} differs at "
                    f"{bad[0].tolist()} ({bad.shape[0]} cells)")
    return err, info


def phase_kernel_checks(dev, catalog) -> dict:
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
    for case in ("unplaceable", "cap1", "zero_req"):
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
        err, info = check_scan(dev, label, N, inputs)
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


# -- phase 4: the main path ---------------------------------------------------


def phase_main_path(dev, pods, catalog):
    solver = TorchSolver(device="cuda")
    request = SolveRequest(pods, catalog)
    for name in ffd_kernel.LAUNCHES:
        ffd_kernel.LAUNCHES[name] = 0
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = dict(ffd_kernel.LAUNCHES)
    stats = dict(solver.last_stats)
    for name in KERNELS:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path: {launches}")
    if stats["path"] != "ffd-cuda":
        raise AssertionError(f"main path took {stats['path']!r}")
    errors = validate_plan(plan, pods, catalog)
    if errors:
        raise AssertionError(f"validate_plan: {errors[:5]}")
    if plan.placed_count != len(pods) or plan.unplaced_pods:
        raise AssertionError(f"placed {plan.placed_count} of {len(pods)}")
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
    cw = prep.N + prep.G_pad
    if card.shape != plain.shape:
        raise AssertionError(f"result lengths {card.shape} vs {plain.shape}")
    mask = np.ones(card.shape[0], bool)
    mask[cw] = False
    bad = np.nonzero((card != plain) & mask)[0]
    if bad.size:
        raise AssertionError(f"packed result differs from the CPU solve in "
                             f"{bad.size} words, first at {bad[0]}")
    c_card = float(card[cw:cw + 1].view(np.float32)[0])
    c_cpu = float(plain[cw:cw + 1].view(np.float32)[0])
    if abs(c_card - c_cpu) > 1e-5 * max(abs(c_cpu), 1e-30):
        raise AssertionError(f"cost word {c_card} vs {c_cpu}")
    say(f"main path result buffer: {card.shape[0]} words equal to the "
        f"plain CPU solve (cost {c_card} vs {c_cpu})")
    # the kernel on the window's own unpacked tensors, against its plain
    # version on the card
    off_alloc, _, off_rank = solver.device_offerings(catalog, prep.O_pad)
    packed = torch.from_numpy(prep.packed).to(dev)
    meta, compat_i, _ = tp.unpack_problem(packed, off_alloc, prep.G_pad,
                                          prep.O_pad, prep.U_pad)
    err, info = check_scan(dev, "main-path window", prep.N,
                           (meta, compat_i, off_alloc, off_rank))
    say(f"kernel check ffd_scan on the main-path window G={prep.G_pad} "
        f"O={prep.O_pad} N={prep.N}: exact ({info})")
    return solver, request, problem, launches, stats, cold_s, err


# -- phase 5: timings ---------------------------------------------------------


def scan_bound_ms(meta, compat, alloc, rank, N: int, assign, node_off):
    """The least time the card could take for the scan: the larger of
    the bytes it must move (inputs read once, outputs written once) over
    the HBM rate, and the scalar operations this run's data needs (open
    nodes at each group's step, every offering) over the scalar rate."""
    G, O = compat.shape[-2:]
    nbytes = sum(int(t.numel() * t.element_size())
                 for t in (meta, compat, alloc, rank)) + 4 * (N + G * N + G)
    first = np.where((assign > 0).any(axis=0), (assign > 0).argmax(axis=0),
                     G)[node_off >= 0]
    open_before = np.searchsorted(np.sort(first), np.arange(G), "left")
    ops = OPS_PER_NODE * int(open_before.sum()) + OPS_PER_OFFERING * G * O
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def profile_windows(solver, request, windows: int = 5) -> dict | None:
    """Device launches and busy share of warm windows, from a
    ``torch.profiler`` trace: each window is a ``solve_window`` range on
    the host, and the device's kernel/copy intervals inside those ranges
    are merged into busy time.  The profiler slows the host, so the busy
    share read here is a lower bound on the unprofiled one.  Returns None
    when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = "solve_window"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(windows):
            with record_function(tag):
                solver.solve(request)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.name == tag and e.device_type == DeviceType.CPU)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != tag]
    if not device or len(spans) != windows:
        return None
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    busy = 0.0
    for lo, hi in spans:
        cut = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                     for e in device)
        end = lo
        for s, t in cut:
            if t > max(s, end):
                busy += t - max(s, end)
                end = t
    window_us = sum(hi - lo for lo, hi in spans)
    return {"windows": windows,
            "kernels_per_window": len(kernels) / windows,
            "device_events_per_window": len(device) / windows,
            "profiled_window_ms": window_us / windows / 1e3,
            "device_busy_ms": busy / windows / 1e3,
            "device_busy_share": busy / window_us}


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
    prof = profile_windows(solver, request)
    if prof is None:
        say(f"profile [{card}]: torch.profiler recorded no device events; "
            f"launches and device busy share not measured")
    else:
        say(f"profile [{card}]: {prof['windows']} warm windows under "
            f"torch.profiler: {prof['kernels_per_window']:.1f} kernels and "
            f"{prof['device_events_per_window']:.1f} device events (kernels "
            f"+ copies) per window; device busy "
            f"{prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_window_ms']:.4f} ms profiled window (busy "
            f"share {prof['device_busy_share']:.4f})")
    say(f"timing [{card}]: ffd_scan kernel {phases['kernel']:.4f} ms, plain "
        f"PyTorch version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes, {ops} scalar ops); no single "
        f"PyTorch call computes the scan (library_ms null)")
    return {"p50_wall_ms": p50, "walls_ms": [w * 1e3 for w in walls],
            "host_ms": host, "device_phases_ms": phases, "profile": prof,
            "encode_cold_ms": enc_cold, "encode_warm_ms": enc_warm,
            "shape": {"G": G, "O": O, "U": U, "N": N},
            "ffd_scan": {"ms": phases["kernel"], "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": ops}}


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
    checks = phase_kernel_checks(dev, catalog)
    solver, request, problem, launches, stats, cold_s, err = \
        phase_main_path(dev, pods, catalog)
    checks["max_abs_err"] = max(checks["max_abs_err"], err)
    timing = phase_timings(dev, solver, request, problem, card)

    record = []
    for name, meta in KERNELS.items():
        t = timing[name]
        record.append({"name": name, **meta, "launches": launches[name],
                       "max_abs_err": checks["max_abs_err"],
                       "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": None})
    if args.json_out is not None:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps({
            "card": card, "torch": torch.__version__, "build_s": build_s,
            "checks": checks, "launches": launches, "main_path_stats": {
                k: v for k, v in stats.items() if k != "telemetry"},
            "telemetry": stats.get("telemetry"), "cold_solve_s": cold_s,
            "timing": timing, "kernels": record}, indent=1, default=str))
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
