// Order-fixed cost sums for Hopper (sm_90a): the cost word of a plan.
//
// The cost word is the float32 sum of the open nodes' prices (0 for a
// closed node).  The reference takes it with jnp.sum
// (karpenter_tpu/solver/jax_backend.py:746, :984), and XLA on the CPU
// rewrites that reduction into a tree of 32-wide windows: while more
// than 32 values are left, they are zero-padded to whole windows (half
// the padding in front, the rest behind) and each window is replaced by
// its sum taken left to right from 0; the last <= 32 values are then
// added left to right from 0.  A zone candidate wins only by more than
// 1e-9 (solver/zonesplit.py), so one ulp of this word can change a
// plan: the order of the adds is part of the result.  A warp shuffle
// tree, a library reduction or atomics would each add in another order.
//
// One warp per row (one row per block).  At every level lane l sums the
// windows l, l + 32, ... of the level's input, one IEEE round-to-nearest
// add at a time (__fadd_rn, never contracted, no fast math), into a
// buffer in shared memory that the next level reads; lane 0 adds the
// last <= 32 values.  The first level reads the row from device memory.
//
// What bounds it: nothing on this card at the sizes the solver gives it
// (N <= 16384 prices a row, C <= 128 rows): a launch's fixed cost.  Its
// byte bound is 4 (N + 1) C bytes at 3.35 TB/s.  Each level is a
// dependent chain of 32 adds per lane, and level 1 reads 32 consecutive
// floats per lane (served from L1 after the first touch of each line).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;
constexpr int kMaxLen = kWindow * 8192;   // level-1 partials fit 32 KB

// dst[m] = the m-th zero-padded window of src[0, n) summed in order;
// returns the number of windows
__device__ int window_level(const float* src, int n, float* dst,
                            int lane) {
  const int m_count = (n + kWindow - 1) / kWindow;
  const int lo = (m_count * kWindow - n) / 2;
  for (int m = lane; m < m_count; m += kWindow) {
    float acc = 0.0f;
    const int base = m * kWindow - lo;
    for (int j = 0; j < kWindow; ++j) {
      const int i = base + j;
      acc = __fadd_rn(acc, (i >= 0 && i < n) ? src[i] : 0.0f);
    }
    dst[m] = acc;
  }
  __syncwarp();
  return m_count;
}

__global__ void __launch_bounds__(kWindow)
cost_sum_kernel(const float* __restrict__ x, float* __restrict__ out,
                int N, int buf_a) {
  extern __shared__ float smem[];
  float* a = smem;            // [buf_a]
  float* b = smem + buf_a;    // [ceil(buf_a / 32)]
  const int lane = threadIdx.x;
  const float* src = x + static_cast<long long>(blockIdx.x) * N;
  int n = N;
  float* dst = a;
  while (n > kWindow) {
    n = window_level(src, n, dst, lane);
    src = dst;
    dst = (dst == a) ? b : a;
  }
  if (lane == 0) {
    float acc = 0.0f;
    for (int i = 0; i < n; ++i) acc = __fadd_rn(acc, src[i]);
    out[blockIdx.x] = acc;
  }
}

}  // namespace

extern "C" {

// Longest row the kernel takes.
int cost_sum_max_len() { return kMaxLen; }

// out float32 [C] = each row of x float32 [C, N] (contiguous, on the
// current device) summed in the reference's window order.  Returns a
// cudaError_t (0 = launched).
int cost_sum_launch(const void* x, void* out, int C, int N, void* stream) {
  if (C <= 0) return 0;
  if (N < 0 || N > kMaxLen)
    return (int)cudaErrorInvalidValue;
  const int buf_a = (N + kWindow - 1) / kWindow;
  const int buf_b = (buf_a + kWindow - 1) / kWindow;
  const size_t smem = sizeof(float) * static_cast<size_t>(buf_a + buf_b + 1);
  cost_sum_kernel<<<C, kWindow, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(out), N, buf_a);
  return (int)cudaGetLastError();
}

const char* cost_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
