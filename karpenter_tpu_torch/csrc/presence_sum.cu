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
// out.  Every add is one IEEE round-to-nearest add (__fadd_rn, never
// contracted) from 0.0f, in group order; an absent group adds nothing, as
// present * miss = +0 adds nothing to the plain version's sum (miss is
// finite).
//
// What bounds it: latency, not bytes.  At the pref window (G = N = 512,
// O = 3072) a node holds a few groups (a mean of 5, at most 13): 1837
// present pairs x 3072 adds, and as data the flags (1 MB), the miss rows
// of the groups present somewhere and the [N, O] output (6.3 MB), 3.4 us
// at the HBM rate.  So the design reads the flags once, coalesced, and
// keeps each warp's row loads in flight in batches; one launch:
// 1. A block owns 32 nodes (one per lane) and one tile of offerings; the
//    blocks of a node tile's offering tiles form a thread block cluster
//    of kCluster, and the cluster reads the tile's flags once,
//    coalesced: a warp loads present[g, n0 : n0 + 32] for 8 groups (a
//    byte of each lane's presence bitmap), and each block loads the
//    chunks of 32 groups c with c % kCluster == its rank.  The bitmaps
//    [32 nodes][G / 32 words] live in shared memory (4 bytes per 32
//    groups per node); each block then copies the chunks the others
//    loaded through distributed shared memory.  A node's ordered list
//    is its bitmap: the set bits in chunk order, then bit order.
// 2. Each warp folds its nodes (two per warp): a cursor over the node's
//    bitmap (a ballot over 32 words finds the nonzero ones) yields its
//    groups in order, kBatch at a time across words; the warp issues
//    all of a batch's row loads (kV float4 per lane, 16-byte loads),
//    then adds them in order, and stores the node's tile with 16-byte
//    stores.  O not a multiple of 4 takes the scalar form of the same
//    kernel (rows are then not 16-byte aligned).
// The cluster's last barrier keeps every block resident until the
// others have read its part of the bitmap.
//
// What bounds it now: the fold, whose warps each wait on one L2 round
// trip per batch of rows, two nodes in turn, then the cluster's barrier
// and its copy through distributed shared memory; the flags take one
// round trip.  chip_smoke.py reads its device time alone beside the
// bound.  Staging the tile's union of rows in shared memory once per
// block (one round of loads) was tried and took longer: building the
// union's list and the staging round cost more than the fold saved.
//
// Limits: G <= kMaxGroups (shared memory: 128 B per 32 groups, past 48
// KB above G = 12256 with the opt-in), N < 2^31 (node tiles on the grid's
// x axis), O <= 65535 / kCluster * kCluster * 512 offerings (tiles on y).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <mutex>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kNodes = 32;            // a block's nodes: one per lane
constexpr int kCluster = 8;           // offering tiles sharing one bitmap
constexpr int kBatch = 4;             // groups whose rows load at once
constexpr int kMaxV = 4;              // 4-float units per lane and node
constexpr int kMaxGroups = 16384;
constexpr int kMaxDevices = 64;
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

__device__ __forceinline__ float4 add_rn(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

template <typename T>
__device__ __forceinline__ T zero();

template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }

template <>
__device__ __forceinline__ float4 zero<float4>() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kWidth 4: elements are float4 (O % 4 == 0); 1: floats.  A lane holds
// kE elements of each node's tile, lane-strided so that a warp's loads
// and stores are contiguous; the tile is 128 * kV offerings.
template <int kWidth, int kV>
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kThreads)
presence_sum_kernel(const float* __restrict__ present,
                    const float* __restrict__ miss, float* __restrict__ out,
                    int G, int N, int O) {
  using T = typename std::conditional<kWidth == 4, float4, float>::type;
  constexpr int kE = kV * 4 / kWidth;
  extern __shared__ unsigned s_bits[];  // [kNodes][NC + 1]: node bitmaps
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int NC = (G + 31) >> 5;         // 32-group chunks
  const int W = NC + 1;                 // padded: lanes hit distinct banks
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kNodes;

  // 1. this block's chunks of the tile's flags, a byte (8 groups) a warp
  unsigned char* bytes = reinterpret_cast<unsigned char*>(s_bits);
  const int units = (NC - rank + kCluster - 1) / kCluster * 4;
  const int n = n0 + lane;
  for (int u = warp; u < units; u += kWarps) {
    const int c = rank + kCluster * (u >> 2);
    const int g0 = c * 32 + (u & 3) * 8;
    float f[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      f[k] = g0 + k < G && n < N
          ? __ldg(present + static_cast<long long>(g0 + k) * N + n) : 0.0f;
    unsigned m = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) m |= (f[k] != 0.0f ? 1u : 0u) << k;
    bytes[(lane * W + c) * 4 + (u & 3)] = static_cast<unsigned char>(m);
  }
  cluster_arrive();
  cluster_wait();
  // the chunks the other blocks of the cluster loaded
  for (int i = tid; i < kNodes * NC; i += kThreads) {
    const int j = i / NC;
    const int c = i - j * NC;
    const int owner = c % kCluster;
    if (owner != rank)
      s_bits[j * W + c] = cluster.map_shared_rank(s_bits, owner)[j * W + c];
  }
  __syncthreads();
  // done reading the others' bitmaps; they wait for this before exiting
  cluster_arrive();

  // 2. fold, a warp per node
  const int tile0 = blockIdx.y * 128 * kV / kWidth;   // in elements
  const int elems = O / kWidth;
  const T* rows = reinterpret_cast<const T*>(miss);
  T* dst = reinterpret_cast<T*>(out);
  if (tile0 < elems) {
    for (int j = warp; j < kNodes && n0 + j < N; j += kWarps) {
      T acc[kE];
#pragma unroll
      for (int i = 0; i < kE; ++i) acc[i] = zero<T>();
      // a cursor over the node's bitmap (uniform in the warp): the
      // nonzero words by a ballot over 32 of them, then their set bits;
      // it yields the groups in order, kBatch at a time across words
      const unsigned* bits = s_bits + j * W;
      int cb = 0;
      unsigned word = lane < NC ? bits[lane] : 0u;
      unsigned live = __ballot_sync(kFull, word != 0u);
      unsigned m = 0;
      int gbase = 0;
      while (true) {
        int gs[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          while (m == 0u && (live != 0u || cb + 32 < NC)) {
            if (live != 0u) {
              const int src = __ffs(live) - 1;
              live &= live - 1;
              m = __shfl_sync(kFull, word, src);
              gbase = (cb + src) * 32;
            } else {
              cb += 32;
              word = cb + lane < NC ? bits[cb + lane] : 0u;
              live = __ballot_sync(kFull, word != 0u);
            }
          }
          gs[k] = m != 0u ? gbase + __ffs(m) - 1 : -1;
          m &= m - 1;
        }
        if (gs[0] < 0) break;
        T v[kBatch][kE];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const T* row = rows + static_cast<long long>(max(gs[k], 0)) * elems;
#pragma unroll
          for (int i = 0; i < kE; ++i) {
            const int e = tile0 + lane + 32 * i;
            v[k][i] = gs[k] >= 0 && e < elems ? __ldg(row + e) : zero<T>();
          }
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          if (gs[k] >= 0) {
#pragma unroll
            for (int i = 0; i < kE; ++i) acc[i] = add_rn(acc[i], v[k][i]);
          }
        }
      }
      T* node_out = dst + static_cast<long long>(n0 + j) * elems;
#pragma unroll
      for (int i = 0; i < kE; ++i) {
        const int e = tile0 + lane + 32 * i;
        if (e < elems) node_out[e] = acc[i];
      }
    }
  }
  cluster_wait();
}

// The opt-in past 48 KB of dynamic shared memory, per instantiation and
// device, raised once to the most any G takes.
std::mutex g_attr_mutex;
bool g_attr_set[2][kMaxV][kMaxDevices];

size_t smem_bytes(int G) {
  return sizeof(unsigned) * kNodes * (static_cast<size_t>((G + 31) >> 5) + 1);
}

template <int kWidth, int kV>
cudaError_t launch(const float* present, const float* miss, float* out,
                   int G, int N, int O, int device, cudaStream_t stream) {
  const auto kernel = presence_sum_kernel<kWidth, kV>;
  const size_t smem = smem_bytes(G);
  if (smem > kDefaultSmem) {
    std::lock_guard<std::mutex> lock(g_attr_mutex);
    bool& set = g_attr_set[kWidth == 4][kV - 1][device];
    if (!set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem_bytes(kMaxGroups)));
      if (err != cudaSuccess) return err;
      set = true;
    }
  }
  const int tiles = (O + 128 * kV - 1) / (128 * kV);
  const dim3 grid((N + kNodes - 1) / kNodes,
                  (tiles + kCluster - 1) / kCluster * kCluster);
  kernel<<<grid, kThreads, smem, stream>>>(present, miss, out, G, N, O);
  return cudaGetLastError();
}

template <int kWidth>
cudaError_t launch_width(const float* present, const float* miss,
                         float* out, int G, int N, int O, int device,
                         cudaStream_t stream) {
  // the least tile that spreads O over one cluster, at most kMaxV units
  int v = (O + 128 * kCluster - 1) / (128 * kCluster);
  v = v < 1 ? 1 : v > kMaxV ? kMaxV : v;
  switch (v) {
    case 1: return launch<kWidth, 1>(present, miss, out, G, N, O, device,
                                     stream);
    case 2: return launch<kWidth, 2>(present, miss, out, G, N, O, device,
                                     stream);
    case 3: return launch<kWidth, 3>(present, miss, out, G, N, O, device,
                                     stream);
    default: return launch<kWidth, 4>(present, miss, out, G, N, O, device,
                                      stream);
  }
}

}  // namespace

extern "C" {

// Largest group count the kernel takes.
int presence_sum_max_groups() { return kMaxGroups; }

// out float32 [N, O] = sum over g in order of miss[g, :] where
// present[g, n] != 0; present float32 [G, N], miss float32 [G, O], out,
// all contiguous on CUDA device `device`; miss and out 16-byte aligned
// when O % 4 == 0.  One kernel launch on `stream`.  Returns a
// cudaError_t (0 = launched).
int presence_sum_launch(const void* present, const void* miss, void* out,
                        int G, int N, int O, int device, void* stream) {
  if (N <= 0 || O <= 0) return 0;
  if (G < 0 || G > kMaxGroups || device < 0 || device >= kMaxDevices
      || (O + 128 * kMaxV - 1) / (128 * kMaxV) > 65535 / kCluster * kCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  // in it when it is not the current one
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* p = static_cast<const float*>(present);
  const float* m = static_cast<const float*>(miss);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = O % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0
      && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  err = vec ? launch_width<4>(p, m, o, G, N, O, device, s)
            : launch_width<1>(p, m, o, G, N, O, device, s);
  return static_cast<int>(err);
}

const char* presence_sum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
