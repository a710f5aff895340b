// Order-fixed float32 segment sum for Hopper (sm_90a).
//
// The flat solver (karpenter_tpu_torch/solver/flat.py) sums float32
// request totals per segment: T_u, the per-class totals that pick each
// class's offering, and T_act, the per-offering totals that size the
// bins each round opens.  The reference takes both with
// jax.ops.segment_sum (karpenter_tpu/solver/flat.py:140 and :231), which
// on its CPU adds the items one by one in index order.  Past 2^24 the
// float32 partial sums round, so the order of the adds decides the
// totals and, through ceil(need * (1 + beta)), the plan.  index_add_ and
// scatter_add_ on the card add with atomics in whatever order the
// threads arrive, so they are ruled out.
//
// This kernel adds in index order.  The wrapper stably sorts the items
// by segment (so each segment's items stay in index order and lie
// contiguously) and passes each segment's start and length.  One block
// per segment stages chunks of its rows in shared memory; thread r < R
// then folds column r of the chunk left to right, one IEEE
// round-to-nearest add at a time (__fadd_rn, never contracted), starting
// from 0.0f exactly as a zero-initialised scatter-add does.
//
// What bounds it: the longest segment.  Its adds are one dependent chain
// per column (a float add's latency each, the loads issued ahead in
// groups of kUnroll), so the longest segment sets the time however many
// segments there are.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 1024;   // rows staged per pass
constexpr int kMaxCols = 8;
constexpr int kUnroll = 8;     // rows loaded ahead of the add chain

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ vals,
                   const int* __restrict__ start,
                   const int* __restrict__ length,
                   float* __restrict__ out, int cols) {
  extern __shared__ float buf[];                 // kChunk x cols
  const int s = blockIdx.x;
  const long long base = start[s];
  const int n = length[s];
  float acc = 0.0f;
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    const float* src = vals + (base + c0) * cols;
    for (int k = threadIdx.x; k < m * cols; k += kThreads) buf[k] = src[k];
    __syncthreads();
    if (threadIdx.x < cols) {
      // kUnroll loads issued ahead of their adds, so the chain waits on
      // the adds alone; the adds stay one by one, in row order
      const float* col = buf + threadIdx.x;
      int i = 0;
      for (; i + kUnroll <= m; i += kUnroll) {
        float v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) v[u] = col[(i + u) * cols];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
      }
      for (; i < m; ++i) acc = __fadd_rn(acc, col[i * cols]);
    }
    __syncthreads();
  }
  if (threadIdx.x < cols) out[(long long)s * cols + threadIdx.x] = acc;
}

}  // namespace

extern "C" {

// Largest number of columns (resources) a row may have.
int segment_sum_max_cols() { return kMaxCols; }

// out[s, :] = sum over the rows of segment s, in row order, of
// vals[row, :].  vals float32 [rows, cols] holds the rows sorted by
// segment (stably); start / length int32 [segments] give each segment's
// first row and row count.  Returns a cudaError_t (0 = launched).
int segment_sum_launch(const void* vals, const void* start,
                       const void* length, void* out, int segments,
                       int cols, void* stream) {
  if (segments <= 0) return 0;
  if (cols <= 0 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kChunk * cols;
  segment_sum_kernel<<<segments, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(start),
      static_cast<const int*>(length), static_cast<float*>(out), cols);
  return (int)cudaGetLastError();
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
