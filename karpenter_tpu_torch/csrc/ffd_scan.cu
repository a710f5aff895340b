// FFD placement scan for Hopper (sm_90a), one thread block per problem.
//
// Replaces the TPU kernel karpenter_tpu/solver/pallas_kernel.py
// (_ffd_kernel, called through ffd_scan_pallas and, with a problem grid,
// ffd_scan_pallas_fleet).  It ports the semantics of _ffd_step
// (karpenter_tpu/solver/jax_backend.py): for each pod group in FFD order,
// fill the open nodes first-fit in age order, then open ceil(rem / bf)
// nodes of the offering with the least rank-per-pod.  None of the Mosaic
// layout carries over: no lane-wide tensors, no masked lane picks, no
// log-step roll cumsum, no gcompat scratch rebuilt by a one-hot matmul,
// no VMEM group-block tiling.  compat[g, node_off[n]] is read straight
// from global memory, which is the gather the TPU could not do.
//
// Design.  The scan over groups is sequential by definition, so one
// block owns one problem (gridDim.x = C, the fleet grid of the
// reference; the single-window path runs C = 1).  Every problem may
// carry its own catalog: block c reads alloc + c * alloc_stride and
// rank + c * rank_stride, and a stride of 0 is one catalog shared by all
// C problems (a batch of windows).  Node state
// (node_off[N] and resid[4][N], 20 B per slot) lives in shared memory;
// each thread owns a contiguous run of k = ceil(N / 1024) node slots and
// is the only thread that reads or writes them, so node state needs no
// barrier.  Per group the block does one exclusive scan (the take
// values), one sum (placed) and one (value, index) argmin over the
// offerings (rank / fit, first index on ties).
//
// What bounds it on the H100: neither bytes nor operations.  One window
// at the headline shape moves about 1 MB and does a few million integer
// operations; the kernel is latency-bound by the G sequential steps,
// each a chain of block barriers.  A faster design (several groups in
// flight, warp-level argmin over O with fewer barriers) is later work.
//
// Arithmetic mirrors the reference's int32 semantics: sums and
// differences wrap (computed in uint32), divisions by a request are
// floor divisions, and a resource with req = 0 is unconstrained.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPerThread = 8;          // N <= 8192
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// Floor division for b > 0 (jnp's // on int32); C's / truncates toward
// zero, which differs for a negative dividend.
__device__ __forceinline__ int floor_div(int a, int b) {
  int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Pods of a group that fit in `cap4` (one resource vector).  Zero
// requests: a resource with req = 0 is unconstrained, so it contributes
// fit_big (the reference's FIT_BIG) instead of a division by zero.
__device__ __forceinline__ int fit_count(int c0, int c1, int c2, int c3,
                                         const int req[4], int fit_big) {
  int f = fit_big;
  if (req[0] > 0) f = min(f, floor_div(c0, req[0]));
  if (req[1] > 0) f = min(f, floor_div(c1, req[1]));
  if (req[2] > 0) f = min(f, floor_div(c2, req[2]));
  if (req[3] > 0) f = min(f, floor_div(c3, req[3]));
  return f;
}

// Exclusive block scan of one uint32 per thread (mod 2^32, which is the
// reference's wrapping int32 cumsum).  Every thread gets its exclusive
// prefix; s_scan must hold kWarps + 1 words.
__device__ unsigned block_exclusive_scan(unsigned x, unsigned* s_scan) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    unsigned y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_scan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned w = s_scan[lane];
    unsigned wi = w;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      unsigned y = __shfl_up_sync(0xffffffffu, wi, d);
      if (lane >= d) wi += y;
    }
    s_scan[lane] = wi - w;
  }
  __syncthreads();
  unsigned out = s_scan[warp] + inc - x;
  __syncthreads();
  return out;
}

// Block sum mod 2^32, broadcast to every thread.
__device__ unsigned block_sum(unsigned x, unsigned* s_scan) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if (lane == 0) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned w = s_scan[lane];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) w += __shfl_xor_sync(0xffffffffu, w, d);
    if (lane == 0) s_scan[kWarps] = w;
  }
  __syncthreads();
  unsigned out = s_scan[kWarps];
  __syncthreads();
  return out;
}

// First-index argmin.  The reference takes jnp.argmin, which returns the
// FIRST index of the minimum, and index 0 when every entry is inf (then
// bf = fit_e[0] <= 0 and no node opens).  Comparing values alone would
// lose the tie-break across threads, so (value, index) pairs are
// reduced: the smaller value wins, and on equal values (inf included)
// the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

template <typename CT>
__global__ void __launch_bounds__(kThreads, 1)
ffd_scan_kernel(const int* __restrict__ meta, const CT* __restrict__ compat,
                const int* __restrict__ alloc_all, long long alloc_stride,
                const float* __restrict__ rank, long long rank_stride,
                int* __restrict__ node_off_out, int* __restrict__ assign,
                int* __restrict__ unplaced, int G, int O, int N, int k,
                int fit_big) {
  extern __shared__ int s_node[];           // node_off[N], resid[4][N]
  int* s_off = s_node;
  int* s_res = s_node + N;
  __shared__ unsigned s_scan[kWarps + 1];
  __shared__ float s_bv[kWarps];
  __shared__ int s_bi[kWarps];
  __shared__ int s_bf[kWarps];
  __shared__ int s_best[2];

  const int c = blockIdx.x;
  // this problem's catalog (stride 0: the catalog every problem shares);
  // the launcher checked that every row start is 16-byte aligned
  const int4* __restrict__ alloc = reinterpret_cast<const int4*>(
      alloc_all + static_cast<long long>(c) * alloc_stride);
  rank += static_cast<long long>(c) * rank_stride;
  meta += static_cast<size_t>(c) * G * 8;
  compat += static_cast<size_t>(c) * G * O;
  node_off_out += static_cast<size_t>(c) * N;
  assign += static_cast<size_t>(c) * G * N;
  unplaced += static_cast<size_t>(c) * G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = tid * k;
  const int nn = max(0, min(k, N - n0));    // node slots this thread owns

  for (int i = 0; i < nn; ++i) {
    s_off[n0 + i] = -1;
#pragma unroll
    for (int r = 0; r < 4; ++r) s_res[r * N + n0 + i] = 0;
  }
  int ptr = 0;                              // next free slot (uniform)

  for (int g = 0; g < G; ++g) {
    const int* mg = meta + static_cast<size_t>(g) * 8;
    int req[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) req[r] = __ldg(mg + r);
    const int count = __ldg(mg + 4);
    const int cap = __ldg(mg + 5);
    const CT* cg = compat + static_cast<size_t>(g) * O;

    // ---- fill open nodes, first-fit in age order ----------------------
    int fit[kMaxPerThread];
    unsigned local = 0;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      int f = 0;
      if (i < nn) {
        const int n = n0 + i;
        const int off = s_off[n];
        int v = 0;
        if (off >= 0 && cg[off] != 0)
          v = fit_count(s_res[n], s_res[N + n], s_res[2 * N + n],
                        s_res[3 * N + n], req, fit_big);
        f = min(v, cap);
      }
      fit[i] = f;
      local += static_cast<unsigned>(f);
    }
    unsigned cum = block_exclusive_scan(local, s_scan);
    unsigned ltake = 0;
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      if (i < nn) {
        // take = clip(count - cumfit, 0, fit)
        int t = wrap_sub(count, static_cast<int>(cum));
        t = min(max(t, 0), fit[i]);
        cum += static_cast<unsigned>(fit[i]);
        fit[i] = t;                         // fit[] now holds take
        ltake += static_cast<unsigned>(t);
        const int n = n0 + i;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          s_res[r * N + n] = wrap_sub(s_res[r * N + n], wrap_mul(t, req[r]));
      }
    }
    const int placed = static_cast<int>(block_sum(ltake, s_scan));
    const int rem = wrap_sub(count, placed);

    // ---- open new nodes with the cheapest-per-pod offering ------------
    float bv = INFINITY;
    int bi = kNoIndex;
    int bfit = 0;
    for (int o = tid; o < O; o += kThreads) {
      const int4 a = __ldg(alloc + o);
      int fe = fit_count(a.x, a.y, a.z, a.w, req, fit_big);
      fe = (cg[o] != 0) ? fe : 0;
      fe = min(min(fe, cap), rem);
      // IEEE division: the reference divides rank by fit in f32 with
      // round-to-nearest.  __fdiv_rn keeps that even if the file is ever
      // compiled with fast math (which it must not be: a one-ulp
      // difference flips the chosen offering).
      const float cpp = fe > 0
          ? __fdiv_rn(__ldg(rank + o), __int2float_rn(fe))
          : INFINITY;
      if (better(cpp, o, bv, bi)) {
        bv = cpp;
        bi = o;
        bfit = fe;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, d);
      const int oi = __shfl_down_sync(0xffffffffu, bi, d);
      const int of = __shfl_down_sync(0xffffffffu, bfit, d);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        bfit = of;
      }
    }
    if (lane == 0) {
      s_bv[warp] = bv;
      s_bi[warp] = bi;
      s_bf[warp] = bfit;
    }
    __syncthreads();
    if (warp == 0) {
      bv = s_bv[lane];
      bi = s_bi[lane];
      bfit = s_bf[lane];
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, d);
        const int oi = __shfl_down_sync(0xffffffffu, bi, d);
        const int of = __shfl_down_sync(0xffffffffu, bfit, d);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
          bfit = of;
        }
      }
      if (lane == 0) {
        s_best[0] = bi;
        s_best[1] = bfit;
      }
    }
    __syncthreads();
    const int best = s_best[0];
    const int bf = s_best[1];

    // Ceiling division: the reference writes -(-rem // bf), a
    // floor-based ceiling; C's truncating / on a negated operand would
    // round the wrong way.  Under bf > 0 we have rem >= bf > 0 (fit_e is
    // capped by rem), so (rem + bf - 1) / bf is exact; it is taken in
    // 64 bits so rem near INT_MAX cannot overflow.  Then clamp by the
    // free slots N - ptr.
    int n_new = 0;
    if (bf > 0)
      n_new = static_cast<int>((static_cast<long long>(rem) + bf - 1) / bf);
    n_new = min(n_new, N - ptr);

    // Every slot in [ptr, ptr + n_new) receives clip(rem - j*bf, 0, bf)
    // pods, which is > 0 for j < ceil(rem / bf): all n_new slots open.
    const int4 ab = best < O ? __ldg(alloc + best) : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kMaxPerThread; ++i) {
      if (i < nn) {
        const int n = n0 + i;
        const int j = n - ptr;
        int pods = 0;
        if (j >= 0 && j < n_new) {
          const long long p = static_cast<long long>(rem)
              - static_cast<long long>(j) * bf;
          pods = static_cast<int>(p < 0 ? 0 : (p > bf ? bf : p));
        }
        if (pods > 0) {
          s_off[n] = best;
          s_res[n] = wrap_sub(ab.x, wrap_mul(pods, req[0]));
          s_res[N + n] = wrap_sub(ab.y, wrap_mul(pods, req[1]));
          s_res[2 * N + n] = wrap_sub(ab.z, wrap_mul(pods, req[2]));
          s_res[3 * N + n] = wrap_sub(ab.w, wrap_mul(pods, req[3]));
        }
        assign[static_cast<size_t>(g) * N + n] = wrap_add(fit[i], pods);
      }
    }
    if (tid == 0) {
      long long placed_new = 0;
      if (n_new > 0) {
        placed_new = static_cast<long long>(n_new) * bf;
        if (placed_new > rem) placed_new = rem;
      }
      unplaced[g] = wrap_sub(rem, static_cast<int>(placed_new));
    }
    ptr += max(n_new, 0);
  }
  for (int i = 0; i < nn; ++i) node_off_out[n0 + i] = s_off[n0 + i];
}

template <typename CT>
cudaError_t launch(const int* meta, const void* compat, const int* alloc,
                   long long alloc_stride, const float* rank,
                   long long rank_stride, int* node_off, int* assign,
                   int* unplaced, int C, int G, int O, int N, int fit_big,
                   cudaStream_t stream) {
  // Shared memory: node_off + resid is 20 B per slot, 80 KB at N = 4096,
  // above the 48 KB a launch gets by default.  The opt-in must precede
  // the launch, or the launch is refused (and the caller's
  // cudaGetLastError check reports it).
  const size_t smem = static_cast<size_t>(N) * 5 * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      ffd_scan_kernel<CT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int k = (N + kThreads - 1) / kThreads;
  ffd_scan_kernel<CT><<<C, kThreads, smem, stream>>>(
      meta, static_cast<const CT*>(compat), alloc, alloc_stride, rank,
      rank_stride, node_off, assign, unplaced, G, O, N, k, fit_big);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest node axis the kernel takes (threads x slots per thread).
int ffd_scan_max_nodes() { return kThreads * kMaxPerThread; }

// meta int32 [C, G, 8]; compat [C, G, O] int32 (compat_u8 = 0) or uint8
// (compat_u8 = 1); alloc int32 [C, O, 4] with problem stride
// alloc_stride (in int32 elements, a multiple of 4; 0 = one catalog
// shared by all problems), 16-byte aligned; rank f32 [C, O] with problem
// stride rank_stride (0 = shared); outputs node_off int32 [C, N], assign
// int32 [C, G, N], unplaced int32 [C, G], all on CUDA device `device`.
// Launches on `stream` and returns the launch's cudaError_t.
int ffd_scan_launch(const int* meta, const void* compat, int compat_u8,
                    const int* alloc, long long alloc_stride,
                    const float* rank, long long rank_stride, int* node_off,
                    int* assign, int* unplaced, int C, int G, int O, int N,
                    int fit_big, int device, void* stream) {
  if (C <= 0 || G < 0 || O <= 0 || N <= 0 || N > kThreads * kMaxPerThread
      || alloc_stride < 0 || rank_stride < 0 || alloc_stride % 4 != 0
      || reinterpret_cast<uintptr_t>(alloc) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  // in it (the caller's runtime may have another current device)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = compat_u8
      ? launch<uint8_t>(meta, compat, alloc, alloc_stride, rank,
                        rank_stride, node_off, assign, unplaced, C, G, O, N,
                        fit_big, s)
      : launch<int>(meta, compat, alloc, alloc_stride, rank, rank_stride,
                    node_off, assign, unplaced, C, G, O, N, fit_big, s);
  return static_cast<int>(err);
}

const char* ffd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
