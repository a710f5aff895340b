// The order-fixed cost word for Hopper (sm_90a).
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
// last <= 32 values.
//
// The word's gather and mask are fused into the first level: it reads
// each node's offering (node_off, int32, -1 = closed) and adds
// off_price[node_off] for an open node, 0.0f for a closed one (the
// reference's jnp.where(node_off >= 0, off_price[clip(node_off, 0)],
// 0.0)), so the word is one launch from the scan's own output with no
// masked-price row in device memory.  Over node_off = 0, 1, ..., N - 1
// it sums a masked price row as it lies.
//
// What bounds it: nothing on this card at the sizes the solver gives it
// (N <= 16384 nodes a row, C <= 128 rows): a launch's fixed cost.  Its
// byte bound is 4 (N + 1) C bytes plus the open nodes' price words at
// 3.35 TB/s.  Each level is a
// dependent chain of 32 adds per lane, and level 1 reads 32 consecutive
// floats per lane (served from L1 after the first touch of each line).

#include <cuda_runtime.h>

namespace {

constexpr int kWindow = 32;
constexpr int kMaxLen = kWindow * 8192;   // level-1 partials fit 32 KB

// The values of a level: the partials of the level before ...
struct RowValues {
  const float* x;
  __device__ float operator()(int i) const { return x[i]; }
};

// ... or, at the first level, formed from the nodes' offerings:
// off_price[o] for an open node (o >= 0; an index past the catalog
// clamps, as the reference's gather does), 0 for a closed one
struct NodePrices {
  const int* node_off;
  const float* price;
  int O;
  __device__ float operator()(int i) const {
    const int o = node_off[i];
    return o >= 0 ? price[min(o, O - 1)] : 0.0f;
  }
};

// src(base), ..., src(base + 31) added left to right from 0, a value
// outside [0, n) read as 0 (pad) or skipped (!pad); all 32 loads are
// issued before the adds, so a gathered price costs one latency per
// window, not one per add
template <bool kPad, class Src>
__device__ float window_sum(Src src, int base, int n) {
  float v[kWindow];
#pragma unroll
  for (int j = 0; j < kWindow; ++j) {
    const int i = base + j;
    v[j] = (i >= 0 && i < n) ? src(i) : 0.0f;
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kWindow; ++j)
    if (kPad || base + j < n) acc = __fadd_rn(acc, v[j]);
  return acc;
}

// dst[m] = the m-th zero-padded window of src[0, n) summed in order;
// returns the number of windows
template <class Src>
__device__ int window_level(Src src, int n, float* dst, int lane) {
  const int m_count = (n + kWindow - 1) / kWindow;
  const int lo = (m_count * kWindow - n) / 2;
  for (int m = lane; m < m_count; m += kWindow)
    dst[m] = window_sum<true>(src, m * kWindow - lo, n);
  __syncwarp();
  return m_count;
}

// The row's sum in the reference's order into *out; the first level
// reads the row through src, the later ones the partials in a / b; the
// last <= 32 values are added by lane 0, unpadded.
template <class Src>
__device__ void row_sum(Src src, int N, float* a, float* b, float* out,
                        int lane) {
  if (N <= kWindow) {
    if (lane == 0) *out = window_sum<false>(src, 0, N);
    return;
  }
  int n = window_level(src, N, a, lane);
  const float* from = a;
  float* to = b;
  while (n > kWindow) {
    n = window_level(RowValues{from}, n, to, lane);
    from = to;
    to = (to == a) ? b : a;
  }
  if (lane == 0) *out = window_sum<false>(RowValues{from}, 0, n);
}

__global__ void __launch_bounds__(kWindow)
cost_word_kernel(const int* __restrict__ node_off,
                 const float* __restrict__ price, float* __restrict__ out,
                 int N, int O, long long price_stride, int buf_a) {
  extern __shared__ float smem[];
  const long long row = blockIdx.x;
  row_sum(NodePrices{node_off + row * N, price + row * price_stride, O}, N,
          smem, smem + buf_a, out + row, threadIdx.x);
}

// shared memory of a row of N values: both levels' partials, + 1
size_t smem_bytes(int N, int* buf_a) {
  *buf_a = (N + kWindow - 1) / kWindow;
  const int buf_b = (*buf_a + kWindow - 1) / kWindow;
  return sizeof(float) * static_cast<size_t>(*buf_a + buf_b + 1);
}

}  // namespace

extern "C" {

// Longest row the kernel takes.
int cost_sum_max_len() { return kMaxLen; }

// out float32 [C] = the cost word of each row of node_off int32 [C, N]
// (contiguous; -1 = closed node): the prices off_price[node_off] of its
// open nodes, 0 for the closed ones, summed in the reference's window
// order.  Row c reads the prices at price + c * price_stride (O floats;
// price_stride 0 = one catalog for every row).  Returns a cudaError_t
// (0 = launched).
int cost_word_launch(const void* node_off, const void* price, void* out,
                     int C, int N, int O, int price_stride, void* stream) {
  if (C <= 0) return 0;
  if (N < 0 || N > kMaxLen || O <= 0 || price_stride < 0)
    return (int)cudaErrorInvalidValue;
  int buf_a = 0;
  const size_t smem = smem_bytes(N, &buf_a);
  cost_word_kernel<<<C, kWindow, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(node_off), static_cast<const float*>(price),
      static_cast<float*>(out), N, O, price_stride, buf_a);
  return (int)cudaGetLastError();
}

const char* cost_sum_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
