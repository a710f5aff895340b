"""A/B of the cost-word kernel (``csrc/cost_sum.cu``) between two checkouts.

Run from the repository root on a machine with one CUDA card, with the
base checkout unpacked into a directory that .gitignore lists:

    mkdir -p .archive/base
    git archive <base commit> | tar -x -C .archive/base
    python3 tools/torch_cost_ab.py --base .archive/base

Both sources keep the C entry ``cost_word_launch``, so this script
compiles each with this checkout's ``nvcc`` flags into a library of its
own and calls both through ``ctypes`` on the same card tensors: the
main path's shape [1, 512] and the what-if plan's [64, 1024] (O = 3072,
about half the nodes open, a shared price row), and rows of 31 and 32
nodes (the 8-lane branch of the newer source).  Outputs must be equal
bit for bit at every shape whose order both sources share.  Then each
shape's device time alone (``chip_smoke.kernel_device_ms``: one kernel
a call, read from ``torch.profiler``) is taken in turns, base, change,
change, base, for ``--rounds`` rounds; medians are printed beside the
card's name and power limit.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from karpenter_tpu_torch import cuda_build  # noqa: E402

SHAPES = ((1, 512), (64, 1024), (1, 31), (1, 32))
O = 3072


def build(source: Path, name: str) -> ctypes.CDLL:
    out = cuda_build.BUILD_DIR / f"lib{name}.so"
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(out), str(source)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    restype, argtypes = cuda_build._SIGNATURES["cost_sum"][
        "cost_word_launch"]
    lib.cost_word_launch.restype = restype
    lib.cost_word_launch.argtypes = argtypes
    return lib


def launcher(lib, node, price, out):
    C, N = node.shape
    stream = cuda_build.stream_handle(node.get_device())

    def run():
        err = lib.cost_word_launch(node.data_ptr(), price.data_ptr(),
                                   out.data_ptr(), C, N, O, 0, stream)
        if err:
            raise RuntimeError(f"cost_word_launch returned {err}")
    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base", type=Path, required=True)
    parser.add_argument("--rounds", type=int, default=5)
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_cost_ab: needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(card, flush=True)
    libs = {"base": build(args.base / "karpenter_tpu_torch" / "csrc"
                          / "cost_sum.cu", "cost_sum_ab_base"),
            "change": build(cuda_build.CSRC_DIR / "cost_sum.cu",
                            "cost_sum_ab_change")}
    rng = np.random.RandomState(11)
    price = torch.from_numpy((rng.rand(O) * 4.0).astype(np.float32)).to(dev)
    times: dict[str, dict[str, list[float]]] = {}
    for C, N in SHAPES:
        label = f"[{C}, {N}]"
        node = rng.randint(0, O, size=(C, N)).astype(np.int32)
        node[rng.rand(C, N) < 0.5] = -1
        node_t = torch.from_numpy(node).to(dev)
        outs = {side: torch.empty(C, device=dev) for side in libs}
        runs = {side: launcher(lib, node_t, price, outs[side])
                for side, lib in libs.items()}
        for run in runs.values():
            run()
        torch.cuda.synchronize()
        same = torch.equal(outs["base"].view(torch.int32),
                           outs["change"].view(torch.int32))
        if not same and not 30 <= N <= 32:
            raise AssertionError(f"{label}: the two sources' words differ")
        times[label] = {side: [] for side in libs}
        for _ in range(args.rounds):
            for side in ("base", "change", "change", "base"):
                times[label][side].append(chip_smoke.kernel_device_ms(
                    runs[side], "cost_word_kernel", reps=args.reps))
        med = {side: float(np.median(v)) for side, v in times[label].items()}
        print(f"cost_word A/B [{card}] {label}: device time alone, median "
              f"of {2 * args.rounds} turns each: base {med['base']:.5f} ms, "
              f"change {med['change']:.5f} ms (x"
              f"{med['change'] / med['base']:.4f}); words "
              f"{'equal' if same else 'differ (the 8-lane order)'}",
              flush=True)
    print(json.dumps({"card": card, "times_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
