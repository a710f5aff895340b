"""What slows the port's headline solve after the route windows ran?

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_headline_aftereffect.py [--json-out PATH]

``chip_smoke.py`` once read the headline window's warm wall ~50% slower
when its route phases (flat, affinity, stochastic) had run earlier in
the same process.  Those phases do two things a serving process may or
may not do: they solve 10k-pod windows on the three routes (on the card
and on the CPU), and they trace with ``torch.profiler``.  This script
separates the two.  Each arm is a fresh process on one card that solves
the headline window (10k pods x 500 types, seed 42) once cold, takes the
wall of ``WINDOWS`` warm windows, runs its intervention, and takes them
again with the same solver:

- ``none``: nothing in between;
- ``routes``: ``chip_smoke``'s three route phases, every check kept,
  with its two ``torch.profiler`` helpers replaced by no-ops;
- ``profiler``: the eight ``torch.profiler`` sessions those phases open
  (``profile_spans`` with 5, 5, 2, 2 spans and ``top_device_ops`` four
  times), over the headline window instead;
- ``both``: the route phases as ``chip_smoke.py`` runs them.

The arms run in the order none, routes, profiler, both, both, profiler,
routes, none.  Beside each measurement: the host medians of
``last_stats`` (dispatch, exec+fetch, decode), Python's garbage
collections inside the timed windows and their time (``gc.callbacks``),
the collector's tracked objects, and the CUDA allocator's reserved
bytes.  The last line of the output is one JSON object with every arm.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARMS = ("none", "routes", "profiler", "both")
ORDER = ("none", "routes", "profiler", "both",
         "both", "profiler", "routes", "none")
WINDOWS = 40
# the spans of each profile_spans call the route phases make, in order
ROUTE_PROFILE_SPANS = (5, 5, 2, 2)


class GcClock:
    """Collections per generation and their seconds, while armed."""

    def __init__(self):
        self.armed = False
        self.t0 = 0.0
        self.count = [0, 0, 0]
        self.seconds = 0.0
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if not self.armed:
            return
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.count[info["generation"]] += 1
            self.seconds += time.perf_counter() - self.t0

    def take(self):
        out = {"collections": list(self.count),
               "ms": self.seconds * 1e3}
        self.count, self.seconds = [0, 0, 0], 0.0
        return out


def measure(solver, request, clock: GcClock) -> dict:
    import numpy as np
    import torch

    walls, stats = [], []
    clock.take()
    clock.armed = True
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
        stats.append(solver.last_stats)
    clock.armed = False
    host = {k: float(np.median([s[k] for s in stats])) * 1e3
            for k in ("dispatch_s", "exec_fetch_s", "decode_s")}
    return {"p50_ms": float(np.percentile(walls, 50)) * 1e3,
            "min_ms": min(walls) * 1e3, "max_ms": max(walls) * 1e3,
            "host_ms": host, "gc": clock.take(),
            "gc_tracked": len(gc.get_objects()),
            "cuda_reserved_bytes": int(torch.cuda.memory_reserved())}


def run_arm(arm: str) -> dict:
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from karpenter_tpu_torch import SolveRequest, TorchSolver, workload

    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False; this script "
                         "needs one CUDA card")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = cs.card_line()
    pods, catalog = workload.build_workload(
        cs.HEADLINE["pods"], cs.HEADLINE["types"], seed=cs.HEADLINE["seed"])
    request = SolveRequest(pods, catalog)
    solver = TorchSolver(device=dev)
    solver.solve(request)
    clock = GcClock()
    before = measure(solver, request, clock)

    t0 = time.perf_counter()
    if arm in ("routes", "both"):
        if arm == "routes":
            cs.profile_spans = lambda *a, **k: None
            cs.top_device_ops = lambda *a, **k: None
        cs.phase_flat(dev, card)
        cs.phase_affinity(dev, card)
        cs.phase_stochastic(dev, card)
    elif arm == "profiler":
        for spans in ROUTE_PROFILE_SPANS:
            cs.profile_spans(lambda: solver.solve(request), spans, "window")
            cs.top_device_ops(lambda: solver.solve(request))
    between_s = time.perf_counter() - t0

    after = measure(solver, request, clock)
    return {"arm": arm, "card": card, "torch": torch.__version__,
            "between_s": between_s, "before": before, "after": after,
            "ratio": after["p50_ms"] / before["p50_ms"]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arm", choices=ARMS, default=None,
                        help="run one arm in this process (internal)")
    parser.add_argument("--json-out", type=Path, default=None,
                        help="also write every arm's record to this file")
    args = parser.parse_args()
    if args.arm is not None:
        print(json.dumps(run_arm(args.arm)), flush=True)
        return 0

    sys.path.insert(0, str(ROOT))
    import torch

    from karpenter_tpu_torch import cuda_build

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False; this script needs one "
              "CUDA card", file=sys.stderr)
        return 2
    cuda_build.build_all()       # each arm then loads the built kernels
    records = []
    for arm in ORDER:
        out = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--arm", arm],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"arm {arm} failed with code {out.returncode}")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        records.append(rec)
        b, a = rec["before"], rec["after"]
        print(f"[{rec['card']}] {arm:8s}: headline p50 {b['p50_ms']:.4f} -> "
              f"{a['p50_ms']:.4f} ms (x{rec['ratio']:.3f}); dispatch "
              f"{b['host_ms']['dispatch_s']:.4f} -> "
              f"{a['host_ms']['dispatch_s']:.4f} ms, decode "
              f"{b['host_ms']['decode_s']:.4f} -> "
              f"{a['host_ms']['decode_s']:.4f} ms; gc in {WINDOWS} windows "
              f"{b['gc']['collections']} {b['gc']['ms']:.3f} ms -> "
              f"{a['gc']['collections']} {a['gc']['ms']:.3f} ms; tracked "
              f"objects {b['gc_tracked']} -> {a['gc_tracked']}; "
              f"intervention {rec['between_s']:.1f} s", flush=True)
    if args.json_out is not None:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps(records, indent=1))
    print(json.dumps({"arms": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
