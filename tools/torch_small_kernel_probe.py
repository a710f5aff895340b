"""What chip_smoke.py does not measure of the two small hand kernels.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_small_kernel_probe.py

1. The floor of an ordered float32 add chain on this card, the bound of
   ``segment_sum`` on a long segment (its adds in index order are one
   dependent chain): one lane adding 2^20 values held in registers, and
   adding them from shared memory four to a vector load, as the
   kernel's consumer warps do (a kernel built here from the source
   below, with the port's nvcc flags), in ns per add.
2. The host cost of the cost word's wrapper beside ``torch.sum`` on the
   premasked row, and of its parts: the output's allocation and the
   ctypes launch (``timeit``, a mean over 20000 calls each).

Prints the card's name and power limit first; the last line is one JSON
object with every number.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import timeit
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from karpenter_tpu_torch import cuda_build  # noqa: E402
from karpenter_tpu_torch.solver import cost_sum  # noqa: E402

CHAIN_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void chain_reg(const float* x, float* out, int n) {
  float r[8];
  for (int u = 0; u < 8; ++u) r[u] = x[u];
  float acc = 0.0f;
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, r[u]);
  }
  out[0] = acc;
}
__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}
__global__ void chain_smem4(const float* x, float* out, int n) {
  __shared__ float4 s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x)
    s[i] = reinterpret_cast<const float4*>(x)[i];
  __syncthreads();
  if (threadIdx.x != 0) return;
  float acc = 0.0f;
  float4 r[4];
  for (int u = 0; u < 4; ++u) r[u] = s[u];
  for (int q = 4; q + 4 <= n / 4; q += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 v = r[u];
      r[u] = s[(q + u) & 1023];
      acc = add4(acc, v);
    }
  }
  for (int u = 0; u < 4; ++u) acc = add4(acc, r[u]);
  out[0] = acc;
}
extern "C" int chain(int kind, const void* x, void* out, int n, void* st) {
  if (kind == 0)
    chain_reg<<<1, 32, 0, (cudaStream_t)st>>>((const float*)x, (float*)out,
                                              n);
  else
    chain_smem4<<<1, 128, 0, (cudaStream_t)st>>>((const float*)x,
                                                 (float*)out, n);
  return (int)cudaGetLastError();
}
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def event_ms(fn, reps: int) -> float:
    """Mean ms per call of ``reps`` back-to-back calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def chain_floor(dev) -> dict:
    build = cuda_build.BUILD_DIR
    build.mkdir(parents=True, exist_ok=True)
    src, lib_path = build / "add_chain.cu", build / "libadd_chain.so"
    src.write_text(CHAIN_SOURCE)
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib_path), str(src)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib_path)).chain
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    x = torch.rand(4096, device=dev)
    out = torch.empty(1, device=dev)
    stream = cuda_build.stream_handle(dev.index)
    n = 1 << 20
    res = {}
    for kind, name in ((0, "registers"), (1, "shared memory, float4")):
        ms = event_ms(
            lambda: fn(kind, x.data_ptr(), out.data_ptr(), n, stream), 10)
        res[name] = ms * 1e6 / n
    print(json.dumps({"ns_per_add": res}), flush=True)
    return res


def host_costs(dev) -> dict:
    rng = np.random.RandomState(0)
    node_off = torch.from_numpy(np.where(
        rng.rand(512) < 0.5, rng.randint(0, 3000, 512), -1).astype(
            np.int32)).to(dev)
    price = torch.rand(3072, device=dev)
    prices = cost_sum.masked_prices(node_off, price)
    cost_sum.cost_word(node_off, price)
    launch = cost_sum._bound()[0]
    out = price.new_empty(())
    stream = cuda_build.stream_handle(dev.index)
    args = (node_off.data_ptr(), price.data_ptr(), out.data_ptr(), 1, 512,
            3072, 0, stream)
    fns = {"cost_word": lambda: cost_sum.cost_word(node_off, price),
           "torch.sum": lambda: prices.sum(dim=-1),
           "new_empty": lambda: price.new_empty(()),
           "ctypes launch": lambda: launch(*args)}
    res = {}
    for name, f in fns.items():
        f()
        torch.cuda.synchronize()
        res[name] = timeit.timeit(f, number=20000) / 20000 * 1e3
        torch.cuda.synchronize()
    print(json.dumps({"host_ms": res}), flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("needs one CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    cuda_build.build_all(("cost_sum",))
    print(json.dumps({"card": card, "chain_ns_per_add": chain_floor(dev),
                      "cost_word_host_ms": host_costs(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
