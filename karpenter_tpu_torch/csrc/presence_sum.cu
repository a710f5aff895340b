// Order-fixed presence sums for Hopper (sm_90a): the soft-preference
// right-size's per-node miss total.
//
// The right-size with soft preferences (karpenter_tpu_torch/solver/
// packed.py::right_size) ranks an offering on node n by the mean miss of
// the groups placed there: out[n, o] = sum over g of present[g, n] *
// miss[g, o], then divided by the count.  The reference takes it as
// jnp.einsum("gn,go->no") (karpenter_tpu/solver/jax_backend.py:281),
// which on its CPU adds the groups one by one in group order.  The card
// is held against that CPU program word for word, and a one-ulp change
// in the mean can flip the chosen offering, so the order of the adds is
// part of the result: cuBLAS (a tiled product) and atomics are ruled
// out.
//
// One block per (node, 256 offerings): the block stages its node's
// presence flags in shared memory and one warp compacts them, in group
// order, into the list of the groups present (a ballot per 32 flags);
// then thread o folds miss[g, o] of the listed groups in order, one IEEE
// round-to-nearest add at a time (__fadd_rn, never contracted), from
// 0.0f.  An absent group adds nothing, as present * miss = +0 adds
// nothing to the plain version's non-negative sum.
//
// What bounds it: instructions, not bytes.  The data is a few MB, but
// every block reads its node's G flags; a node holds a few groups, so
// after the compaction each thread's fold is a few loads and adds.  (A
// first version scanned all G flags in every thread: 0.21 ms at the pref
// window, G = N = 512, O = 3072, issue-bound.)

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroups = 16384;     // 3 bytes of shared memory a group
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
presence_sum_kernel(const float* __restrict__ present,
                    const float* __restrict__ miss, float* __restrict__ out,
                    int G, int N, int O) {
  // [G flags][G group indices, uint16]
  extern __shared__ __align__(4) unsigned char smem[];
  unsigned short* list = reinterpret_cast<unsigned short*>(smem);
  unsigned char* on = smem + 2 * static_cast<size_t>(G);
  __shared__ int count;
  const int n = blockIdx.y;
  for (int g = threadIdx.x; g < G; g += kThreads)
    on[g] = __ldg(present + static_cast<long long>(g) * N + n) != 0.0f;
  __syncthreads();
  if (threadIdx.x < 32) {               // compact in group order
    const int lane = threadIdx.x;
    int base = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const bool here = g0 + lane < G && on[g0 + lane];
      const unsigned mask = __ballot_sync(kFull, here);
      if (here)
        list[base + __popc(mask & ((1u << lane) - 1u))] =
            static_cast<unsigned short>(g0 + lane);
      base += __popc(mask);
    }
    if (lane == 0) count = base;
  }
  __syncthreads();
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= O) return;
  float acc = 0.0f;
  for (int k = 0; k < count; ++k)
    acc = __fadd_rn(acc, __ldg(miss + static_cast<long long>(list[k]) * O
                               + o));
  out[static_cast<long long>(n) * O + o] = acc;
}

}  // namespace

extern "C" {

// Largest group count the kernel takes.
int presence_sum_max_groups() { return kMaxGroups; }

// out float32 [N, O] = sum over g in order of miss[g, :] where
// present[g, n] != 0; present float32 [G, N], miss float32 [G, O], all
// contiguous on the current device.  Returns a cudaError_t (0 =
// launched).
int presence_sum_launch(const void* present, const void* miss, void* out,
                        int G, int N, int O, void* stream) {
  if (N <= 0 || O <= 0) return 0;
  if (G < 0 || G > kMaxGroups || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((O + kThreads - 1) / kThreads, N);
  presence_sum_kernel<<<grid, kThreads, 3 * static_cast<size_t>(G) + 4,
                        (cudaStream_t)stream>>>(
      static_cast<const float*>(present), static_cast<const float*>(miss),
      static_cast<float*>(out), G, N, O);
  return (int)cudaGetLastError();
}

const char* presence_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
