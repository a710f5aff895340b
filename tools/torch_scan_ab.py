"""A/B of the FFD kernel's shared-rank scan between two checkouts.

Run from the repository root on a machine with one CUDA card, with the
base checkout unpacked into a directory that .gitignore lists:

    mkdir -p .archive/base
    git archive <base commit> | tar -x -C .archive/base
    python3 tools/torch_scan_ab.py --base .archive/base

Each checkout runs in a worker process of its own.  The worker imports
that checkout's ``karpenter_tpu_torch``, which builds its own
``csrc/ffd_scan.cu`` with its own ``cuda_build``, and times that
checkout's ``solver.ffd_kernel.ffd_scan``: the public wrapper, whose
signature every version of the port keeps, so the two sources may differ
in their launch interface.  This script writes the inputs once and both
workers read them: the headline window's shape (G=64, O=3072, N=512, the
headline catalog, ``chip_smoke.scan_inputs`` seeds 0-3) and the largest
(G=2048, O=4096, N=4096).  Both workers' outputs must be equal.  The
workers are then timed in turns, base, change, change, base, for
``--rounds`` rounds; each time is the mean of ``--reps`` back-to-back
wrapper calls between CUDA events.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SHAPES = ("headline G=64 O=3072 N=512", "largest G=2048 O=4096 N=4096")


def write_inputs(path: Path) -> None:
    """The two shapes' inputs, from this checkout's ``chip_smoke``."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from karpenter_tpu_torch import workload

    catalog = workload.build_catalog(500)
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    cases = {SHAPES[0]: [chip_smoke.scan_inputs(s, 64, O_h, alloc_h, rank_h)
                         + (512,) for s in range(4)],
             SHAPES[1]: [chip_smoke.scan_inputs(100, 2048, 4096) + (4096,)]}
    arrays = {}
    for i, label in enumerate(SHAPES):
        for j, (meta, compat, alloc, rank, N) in enumerate(cases[label]):
            for name, a in (("meta", meta), ("compat", compat),
                            ("alloc", alloc), ("rank", rank),
                            ("N", np.int64(N))):
                arrays[f"{i}_{j}_{name}"] = a
    np.savez(path, **arrays)


def worker(inputs: Path, outputs: Path) -> int:
    """Load the inputs onto the card, run each case once through this
    checkout's wrapper and save the outputs, then answer ``time i reps``
    lines on stdin with one JSON line each until ``quit``."""
    import torch

    from karpenter_tpu_torch.solver.ffd_kernel import ffd_scan

    dev = torch.device("cuda", 0)
    data = np.load(inputs)
    cases = {}
    for key in data.files:
        i, j, name = key.split("_", 2)
        case = cases.setdefault(int(i), {}).setdefault(int(j), {})
        case[name] = int(data[key]) if name == "N" else \
            torch.from_numpy(np.ascontiguousarray(data[key])).to(dev)

    def call(c):
        return ffd_scan(c["meta"][None], c["compat"][None], c["alloc"],
                        c["rank"], c["N"])

    saved = {}
    for i, by_j in cases.items():
        for j, c in by_j.items():
            for name, t in zip(("node_off", "assign", "unplaced"), call(c)):
                saved[f"{i}_{j}_{name}"] = t.cpu().numpy()
    np.savez(outputs, **saved)
    print("ready", flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "quit":
            return 0
        fns = list(cases[int(cmd[1])].values())
        reps = int(cmd[2])
        for c in fns:
            call(c)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            for c in fns:
                call(c)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / reps / len(fns)
        print(json.dumps({"ms": ms}), flush=True)
    return 0


def start_worker(tree: Path, inputs: Path, outputs: Path):
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(inputs), str(outputs)],
        cwd=tree, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    line = proc.stdout.readline().strip()
    if line != "ready":
        proc.kill()
        raise RuntimeError(f"the worker of {tree} did not start: {line!r}")
    return proc


def ask(proc, shape: int, reps: int) -> float:
    proc.stdin.write(f"time {shape} {reps}\n")
    proc.stdin.flush()
    return json.loads(proc.stdout.readline())["ms"]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path)
    parser.add_argument("--rounds", type=int, default=6)
    parser.add_argument("--reps", type=int, default=200)
    parser.add_argument("--worker", nargs=2, type=Path,
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker(*args.worker)
    if args.base is None:
        parser.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from karpenter_tpu_torch import cuda_build

    card = chip_smoke.card_line()
    print(card, flush=True)
    work = cuda_build.BUILD_DIR / "scan_ab"
    work.mkdir(parents=True, exist_ok=True)
    inputs = work / "inputs.npz"
    write_inputs(inputs)
    trees = {"base": args.base.resolve(), "change": ROOT}
    procs = {}
    try:
        for arm, tree in trees.items():
            procs[arm] = start_worker(tree, inputs, work / f"{arm}.npz")
        outs = {arm: np.load(work / f"{arm}.npz") for arm in trees}
        for key in outs["base"].files:
            if not np.array_equal(outs["base"][key], outs["change"][key]):
                raise AssertionError(f"base and change differ in {key}")
        result = {"card": card, "shapes": {}}
        for i, label in enumerate(SHAPES):
            reps = args.reps if i == 0 else max(args.reps // 20, 3)
            times = {"base": [], "change": []}
            for _ in range(args.rounds):
                for arm in ("base", "change", "change", "base"):
                    times[arm].append(ask(procs[arm], i, reps))
            med = {k: float(np.median(v)) for k, v in times.items()}
            print(f"timing [{card}]: ffd_scan shared rank, {label}: base "
                  f"median {med['base']:.5f} ms, change median "
                  f"{med['change']:.5f} ms (x{med['change'] / med['base']:.4f}"
                  f"); base " + ", ".join(f"{x:.5f}" for x in times["base"])
                  + "; change "
                  + ", ".join(f"{x:.5f}" for x in times["change"]),
                  flush=True)
            result["shapes"][label] = {"median_ms": med, "ms": times}
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.stdin.write("quit\n")
                proc.stdin.close()
                proc.wait(timeout=60)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
