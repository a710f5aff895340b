"""A/B of the port's solve walls between two checkouts, on the card.

Run from the repository root on a machine with one CUDA card, with the
base checkout unpacked into a directory that .gitignore lists:

    mkdir -p .archive/base
    git archive <base commit> | tar -x -C .archive/base
    python3 tools/torch_route_ab.py --base .archive/base

Each checkout runs in a worker process of its own, which imports that
checkout's ``karpenter_tpu_torch`` (building its own kernels) and serves
three windows through ``TorchSolver(device="cuda").solve``: the headline
window (10k pods x 500 types, seed 42) and the two flat windows of
``chip_smoke.FLAT_WINDOWS`` (``build_hetero_workload`` seeds 7 and 11).
Both workers' plans must be equal.  The workers are then timed in turns,
base, change, change, base, for ``--rounds`` rounds: each turn is the
median wall of ``--solves`` warm solves of one window.  The last line is
one JSON object with every turn's median.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CASES = ("headline", "flat seed 7", "flat seed 11")


def worker() -> int:
    """Build the three windows with this checkout's package, solve each
    once and print its plan's fingerprint, then answer ``time i n`` lines
    on stdin with the median wall of n solves until ``quit``."""
    import torch

    from karpenter_tpu_torch import SolveRequest, TorchSolver, workload

    requests = [SolveRequest(*workload.build_workload(10_000, 500, seed=42)),
                SolveRequest(*workload.build_hetero_workload(
                    10_000, 500, seed=7)),
                SolveRequest(*workload.build_hetero_workload(
                    10_000, 500, seed=11, constrained_frac=0.3,
                    pref_frac=0.15))]
    solver = TorchSolver(device=torch.device("cuda", 0))
    prints = []
    for request in requests:
        plan = solver.solve(request)
        prints.append([[n.offering_index, list(n.pod_names)]
                       for n in plan.nodes])
    print(json.dumps({"plans": prints}), flush=True)
    for line in sys.stdin:
        cmd = line.split()
        if cmd[0] == "quit":
            return 0
        request = requests[int(cmd[1])]
        walls = []
        for _ in range(int(cmd[2])):
            t0 = time.perf_counter()
            solver.solve(request)
            walls.append(time.perf_counter() - t0)
        print(json.dumps({"ms": float(np.median(walls)) * 1e3,
                          "path": solver.last_stats["path"]}), flush=True)
    return 0


def start_worker(tree: Path):
    env = dict(os.environ, PYTHONPATH=str(tree))
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--worker"],
        cwd=tree, env=env, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        text=True)
    for line in proc.stdout:
        if line.startswith("{"):
            return proc, json.loads(line)["plans"]
    proc.kill()
    raise RuntimeError(f"the worker of {tree} ended before its plans")


def ask(proc, case: int, solves: int) -> dict:
    proc.stdin.write(f"time {case} {solves}\n")
    proc.stdin.flush()
    return json.loads(proc.stdout.readline())


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path)
    parser.add_argument("--rounds", type=int, default=4)
    parser.add_argument("--solves", type=int, default=10)
    parser.add_argument("--worker", action="store_true",
                        help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        return worker()
    if args.base is None:
        parser.error("--base is required")
    import torch

    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    root = Path(__file__).resolve().parents[1]
    workers = {}
    try:
        workers["base"] = start_worker(args.base.resolve())
        workers["change"] = start_worker(root)
        if workers["base"][1] != workers["change"][1]:
            raise AssertionError("the two checkouts' plans differ")
        runs = {side: {c: [] for c in CASES} for side in workers}
        for _ in range(args.rounds):
            for case, label in enumerate(CASES):
                for side in ("base", "change", "change", "base"):
                    got = ask(workers[side][0], case, args.solves)
                    runs[side][label].append(got["ms"])
        summary = {}
        for label in CASES:
            b = float(np.median(runs["base"][label]))
            c = float(np.median(runs["change"][label]))
            summary[label] = {"base_ms": b, "change_ms": c,
                              "change_over_base": c / b}
            print(f"{label}: median of {2 * args.rounds} turns, each the "
                  f"median of {args.solves} warm solves: base {b:.4f} ms, "
                  f"change {c:.4f} ms (x{c / b:.4f}); base turns "
                  f"{[round(x, 4) for x in runs['base'][label]]}, change "
                  f"turns {[round(x, 4) for x in runs['change'][label]]}",
                  flush=True)
    finally:
        for proc, _ in workers.values():
            if proc.poll() is None:
                proc.stdin.write("quit\n")
                proc.stdin.flush()
                proc.wait(timeout=60)
    print(json.dumps({"card": card, "summary": summary, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
