// Order-fixed float32 segment sum for Hopper (sm_90a), one launch.
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
// out[s, :] = the rows of segment s added in index order, from 0.0f, one
// IEEE round-to-nearest add at a time (__fadd_rn, never contracted).
// Ids outside [0, S) drop.
//
// Design: no global sort, and the add chains overlap the listing.  Each
// block owns kSegs = 32 consecutive segments.  First all its threads
// read every id (many loads in flight each) and keep each item's local
// segment, a byte, in shared memory (-1 = not owned).  Then it walks the
// items in windows of W consecutive indices (W = 4096 for up to 4
// columns), in index order, its warps split into two roles that hand
// each window over through a pair of staging buffers and named barriers:
// - 16 producer warps, each taking a contiguous span of the window:
//   1. each warp counts, per owned segment, its items (a ballot per
//      distinct segment of a 32-item chunk, the first ballots of every
//      chunk issued together; lane l keeps segment l's count: integer
//      counts, so their order is free);
//   2. the counts are scanned (over warps, then over segments): each
//      warp gets its first slot per segment in a list grouped by segment;
//   3. each item's index goes to its slot: its rank among its chunk's
//      peers (the same ballots) plus its warp's running slot, held by
//      the segment's lane, so the list keeps index order inside every
//      segment;
//   4. once the consumers have freed the window's buffer, all producer
//      threads copy the listed rows into it, a row per thread, column by
//      column, several rows' loads in flight at once, and signal it full;
// - COLS consumer warps: warp c, lane l adds column c of segment l's
//   staged rows to its running total, in list order, four rows per
//   vector load, then frees the buffer.
// While the consumers add window w, the producers list window w + 1 and
// stage it into the other buffer.  Each total stays in a register from
// window to window: one chain from 0.0f over the segment's rows in index
// order.  Dropped ids never enter a list, so a sentinel segment costs
// nothing.  The column count is a template argument (1-8).
//
// What bounds it: the longest segment, one dependent add per row in each
// column's chain (an add's latency, ~4 cycles: on an H100 at 700 W
// ~2.9 ns a row in place, 2.1 ns for the chain alone, from
// tools/torch_small_kernel_probe.py); then each window's listing (~3 us
// a window there even when the block owns no item: the ballots and
// barriers), which the adds hide only when the segment is long.  The
// byte bound (each input read once, each output written once, at 3.35
// TB/s) is a fraction of a microsecond at the flat program's shapes.  A segment of all I rows is a chain of I adds, where the
// atomics of index_add_ spread over the threads (and lose the order).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProducers = 16;         // producer warps
constexpr int kProducerThreads = kProducers * 32;
constexpr int kSegs = 32;              // segments a block: a warp's lanes
constexpr int kMaxCols = 8;
constexpr int kMaxItems = 32768;
constexpr int kStageFloats = 16384;    // staged values per buffer
constexpr int kMaxWindow = 4096;       // items per window
constexpr unsigned kFull = 0xffffffffu;
// named barriers: 0 is __syncthreads, 1 the producers', then full / empty
// per buffer
constexpr int kBarProducers = 1;
constexpr int kBarFull = 2;            // + buffer
constexpr int kBarEmpty = 4;           // + buffer

// items per window for rows of `cols` values: a whole number of 32-item
// chunks per producer warp, at most kMaxWindow
__host__ __device__ constexpr int window_items(int cols) {
  return kStageFloats / cols / kProducerThreads * kProducerThreads
                 < kMaxWindow
             ? kStageFloats / cols / kProducerThreads * kProducerThreads
             : kMaxWindow;
}

// dynamic shared memory: every item's local segment (a byte each), the
// window's list, two staging buffers
__host__ __device__ constexpr int smem_bytes(int cols) {
  return kMaxItems + window_items(cols) * 4 * (1 + 2 * cols);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// inclusive warp scan
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += t;
  }
  return v;
}

// The first group of each of a warp's chunks, all chunks' ballots issued
// together: any[u] = the lanes holding an owned segment, key[u] = the
// segment of the lowest of them (-1: none), peers[u] = the lanes holding
// key[u].
template <int N>
__device__ __forceinline__ void first_groups(const int (&ls)[N],
                                             unsigned (&any)[N],
                                             int (&key)[N],
                                             unsigned (&peers)[N]) {
#pragma unroll
  for (int u = 0; u < N; ++u) any[u] = __ballot_sync(kFull, ls[u] >= 0);
#pragma unroll
  for (int u = 0; u < N; ++u)
    key[u] = __shfl_sync(kFull, ls[u], any[u] ? __ffs(any[u]) - 1 : 0);
#pragma unroll
  for (int u = 0; u < N; ++u) peers[u] = __ballot_sync(kFull, ls[u] == key[u]);
}

// Calls f(key, peers) once per distinct owned segment of a chunk, in
// order of the lowest lane holding it, starting from its first group; a
// ballot per further segment (sorted ids give one or two per chunk).
template <typename F>
__device__ __forceinline__ void for_each_group(int ls, unsigned any, int key,
                                               unsigned peers, F f) {
  if (key < 0) return;
  f(key, peers);
  for (unsigned rest = any & ~peers; rest; rest &= ~peers) {
    key = __shfl_sync(kFull, ls, __ffs(rest) - 1);
    peers = __ballot_sync(kFull, ls == key);
    f(key, peers);
  }
}

// acc + x.x + x.y + x.z + x.w, one rounded add at a time, in order
__device__ __forceinline__ float add4(float acc, float4 x) {
  acc = __fadd_rn(acc, x.x);
  acc = __fadd_rn(acc, x.y);
  acc = __fadd_rn(acc, x.z);
  return __fadd_rn(acc, x.w);
}

template <typename Id, int COLS>
__global__ void __launch_bounds__((kProducers + COLS) * 32)
segment_sum_kernel(const float* __restrict__ vals,
                   const Id* __restrict__ seg, float* __restrict__ out,
                   int items, int segments) {
  constexpr int W = window_items(COLS);
  constexpr int kSpan = W / kProducers;        // a warp's items per window
  constexpr int kChunks = kSpan / 32;
  constexpr int kAll = (kProducers + COLS) * 32;
  constexpr int kGatherRows = COLS <= 4 ? 8 : 4;  // rows in flight
  constexpr int kFold = 4;                     // quads of rows ahead
  constexpr int kIdRounds = 8;                 // id loads in flight
  extern __shared__ int smem[];
  int* list = smem;                                       // [W]
  float* staged = reinterpret_cast<float*>(smem + W);     // [2][COLS][W]
  signed char* local =                                    // [items]
      reinterpret_cast<signed char*>(staged + 2 * COLS * W);
  __shared__ int slot[kProducers][kSegs];      // count, then next slot
  __shared__ int total[kSegs];
  __shared__ int pstart[kSegs + 1];            // the producers' window
  __shared__ int cstart[2][kSegs + 1];         // each buffer's window

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long s0 = static_cast<long long>(blockIdx.x) * kSegs;
  const long long s_end = min(s0 + kSegs, static_cast<long long>(segments));
  const int windows = (items + W - 1) / W;

  // 0. every thread of the block: each item's local segment (-1 = not
  // owned), its id loads issued kIdRounds at a time
  for (int i0 = threadIdx.x; i0 < items; i0 += kAll * kIdRounds) {
    long long id[kIdRounds];
#pragma unroll
    for (int r = 0; r < kIdRounds; ++r) {
      const int i = i0 + r * kAll;
      id[r] = i < items ? static_cast<long long>(seg[i]) : -1;
    }
#pragma unroll
    for (int r = 0; r < kIdRounds; ++r) {
      const int i = i0 + r * kAll;
      if (i < items)
        local[i] = id[r] >= s0 && id[r] < s_end
                       ? static_cast<signed char>(id[r] - s0) : -1;
    }
  }
  __syncthreads();

  if (warp >= kProducers) {
    // consumer: column c of segment `lane`
    const int c = warp - kProducers;
    float acc = 0.0f;
    for (int w = 0; w < windows; ++w) {
      const int b = w & 1;
      bar_sync(kBarFull + b, kAll);
      const float* col = staged + (b * COLS + c) * W;
      int k = cstart[b][lane];
      const int end = cstart[b][lane + 1];
      for (; k < end && (k & 3); ++k) acc = __fadd_rn(acc, col[k]);
      // whole quads of rows, one vector load each, kFold quads loaded
      // ahead: each load issues in the add chain's latency and lands
      // before its adds
      const float4* quad = reinterpret_cast<const float4*>(col);
      int q = k >> 2;
      const int qend = end >> 2;
      if (qend - q >= kFold) {
        float4 r[kFold];
#pragma unroll
        for (int u = 0; u < kFold; ++u) r[u] = quad[q + u];
        for (q += kFold; qend - q >= kFold; q += kFold) {
#pragma unroll
          for (int u = 0; u < kFold; ++u) {
            const float4 x = r[u];
            r[u] = quad[q + u];
            acc = add4(acc, x);
          }
        }
#pragma unroll
        for (int u = 0; u < kFold; ++u) acc = add4(acc, r[u]);
      }
      for (; q < qend; ++q) acc = add4(acc, quad[q]);
      for (k = max(k, qend * 4); k < end; ++k) acc = __fadd_rn(acc, col[k]);
      bar_arrive(kBarEmpty + b, kAll);
    }
    if (s0 + lane < s_end) out[(s0 + lane) * COLS + c] = acc;
    return;
  }

  // producer warps
  const unsigned lower = (1u << lane) - 1u;
  for (int w = 0; w < windows; ++w) {
    const int b = w & 1;
    const int lo = w * W + warp * kSpan;

    // 1. the span's local segments (-1 = not owned or past the end),
    // counted per warp: lane l counts segment l
    int ls[kChunks];
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int i = lo + 32 * u + lane;
      ls[u] = i < items ? local[i] : -1;
    }
    unsigned any[kChunks], peers[kChunks];
    int key[kChunks];
    first_groups(ls, any, key, peers);
    int count = 0;
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
      for_each_group(ls[u], any[u], key[u], peers[u],
                     [&](int k, unsigned m) {
                       if (lane == k) count += __popc(m);
                     });
    slot[warp][lane] = count;
    bar_sync(kBarProducers, kProducerThreads);

    // 2. exclusive scan over the warps, per segment (warp w takes the
    // segments w, w + kProducers, ...), then over the segments
    for (int l = warp; l < kSegs; l += kProducers) {
      const int v = lane < kProducers ? slot[lane][l] : 0;
      const int inc = warp_scan(v, lane);
      if (lane < kProducers) slot[lane][l] = inc - v;
      if (lane == 31) total[l] = inc;
    }
    bar_sync(kBarProducers, kProducerThreads);
    if (warp == 0) {
      const int v = total[lane];
      const int inc = warp_scan(v, lane);
      pstart[lane] = inc - v;
      if (lane == 31) pstart[kSegs] = inc;
    }
    bar_sync(kBarProducers, kProducerThreads);

    // 3. each item's index into its slot, in index order per segment:
    // lane l holds the warp's next slot of segment l
    int next = slot[warp][lane] + pstart[lane];
#pragma unroll
    for (int u = 0; u < kChunks; ++u)
      for_each_group(ls[u], any[u], key[u], peers[u],
                     [&](int k, unsigned m) {
                       const int base = __shfl_sync(kFull, next, k);
                       if (ls[u] == k)
                         list[base + __popc(m & lower)] = lo + 32 * u + lane;
                       if (lane == k) next += __popc(m);
                     });
    const int n = pstart[kSegs];
    // 4. the listed rows into buffer b once its last window is added
    if (w >= 2) bar_sync(kBarEmpty + b, kAll);
    bar_sync(kBarProducers, kProducerThreads);
    float* buf = staged + b * COLS * W;
    for (int k0 = threadIdx.x; k0 < n;
         k0 += kProducerThreads * kGatherRows) {
      float v[kGatherRows][COLS];
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        const int k = k0 + r * kProducerThreads;
        const long long at = k < n ? list[k] : 0;
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          v[r][c] = k < n ? vals[at * COLS + c] : 0.0f;
      }
      // every load issues before the first store waits on one
      asm volatile("" ::: "memory");
#pragma unroll
      for (int r = 0; r < kGatherRows; ++r) {
        const int k = k0 + r * kProducerThreads;
        if (k < n) {
#pragma unroll
          for (int c = 0; c < COLS; ++c) buf[c * W + k] = v[r][c];
        }
      }
    }
    if (warp == 0) {
      cstart[b][lane] = pstart[lane];
      if (lane == 0) cstart[b][kSegs] = n;
    }
    __threadfence_block();
    bar_arrive(kBarFull + b, kAll);
  }
  // the last windows' frees, so every arrival meets its wait
  for (int w = max(windows - 2, 0); w < windows; ++w)
    bar_sync(kBarEmpty + (w & 1), kAll);
}

template <typename Id, int COLS>
int launch(const void* vals, const void* seg, void* out, int items,
           int segments, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes(COLS);
  // the list and buffers pass the 48 KB default: raise the limit once
  // per device
  static unsigned long long sized = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (device & 63);
  if (!(sized & bit)) {
    err = cudaFuncSetAttribute(segment_sum_kernel<Id, COLS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized |= bit;
  }
  const int blocks = (segments + kSegs - 1) / kSegs;
  segment_sum_kernel<Id, COLS>
      <<<blocks, (kProducers + COLS) * 32, kSmem, stream>>>(
          static_cast<const float*>(vals), static_cast<const Id*>(seg),
          static_cast<float*>(out), items, segments);
  return static_cast<int>(cudaGetLastError());
}

template <typename Id>
int launch_cols(const void* vals, const void* seg, void* out, int items,
                int segments, int cols, cudaStream_t stream) {
  switch (cols) {
    case 1: return launch<Id, 1>(vals, seg, out, items, segments, stream);
    case 2: return launch<Id, 2>(vals, seg, out, items, segments, stream);
    case 3: return launch<Id, 3>(vals, seg, out, items, segments, stream);
    case 4: return launch<Id, 4>(vals, seg, out, items, segments, stream);
    case 5: return launch<Id, 5>(vals, seg, out, items, segments, stream);
    case 6: return launch<Id, 6>(vals, seg, out, items, segments, stream);
    case 7: return launch<Id, 7>(vals, seg, out, items, segments, stream);
    case 8: return launch<Id, 8>(vals, seg, out, items, segments, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Largest number of columns (resources) a row may have.
int segment_sum_max_cols() { return kMaxCols; }

// Largest number of items (rows) a call may have.
int segment_sum_max_items() { return kMaxItems; }

// out float32 [segments, cols] = per segment, the rows of vals float32
// [items, cols] (contiguous) whose id seg[row] equals it, added in row
// order from 0; rows with an id outside [0, segments) drop.  seg is
// int32 (id_bytes 4) or int64 (id_bytes 8) [items].  One kernel launch
// on the stream.  Returns a cudaError_t (0 = launched).
int segment_sum_launch(const void* vals, const void* seg, void* out,
                       int items, int segments, int cols, int id_bytes,
                       void* stream) {
  if (segments <= 0) return 0;
  if (items < 0 || items > kMaxItems || cols <= 0 || cols > kMaxCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (id_bytes == 4)
    return launch_cols<int32_t>(vals, seg, out, items, segments, cols, s);
  if (id_bytes == 8)
    return launch_cols<int64_t>(vals, seg, out, items, segments, cols, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* segment_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
