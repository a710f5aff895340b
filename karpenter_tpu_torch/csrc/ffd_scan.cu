// FFD placement scan for Hopper (sm_90a): an offering prologue over the
// whole card, then one thread block per problem for the sequential chain.
//
// Replaces the TPU kernel karpenter_tpu/solver/pallas_kernel.py
// (_ffd_kernel, called through ffd_scan_pallas and, with a problem grid,
// ffd_scan_pallas_fleet).  It ports the semantics of _ffd_step
// (karpenter_tpu/solver/jax_backend.py): for each pod group in FFD order,
// fill the open nodes first-fit in age order, then open ceil(rem / bf)
// nodes of the offering with the least rank-per-pod.  None of the Mosaic
// layout carries over: no lane-wide tensors, no masked lane picks, no
// log-step roll cumsum, no gcompat scratch rebuilt by a one-hot matmul,
// no VMEM group-block tiling.
//
// What bounds it on the H100: neither bytes nor operations.  One window
// at the headline shape moves about 1 MB and does a few million integer
// operations; the scan is G dependent steps, and a step costs what its
// block issues between two barriers: every warp runs the step's scalar
// part, the warps holding open nodes fill them, and the scheduler shares
// its issue slots among them.  So the design takes work off the step:
//
// 1. Offering work leaves the chain.  For group g, fe0[o] = max(0,
//    min(compat[g,o] ? fit_count(alloc[o], req_g) : 0, cap_g)) does not
//    depend on node state.  ffd_offer_kernel computes it for all C x G
//    groups at once (one block per group, the whole card), together with
//    best0 (the first-index argmin of rank / fe0 over fe0 > 0), bf0 =
//    fe0[best0] and maxfe = max fe0, and writes one row per group:
//    fe0 with the compat bit in bit 31, then a 16-word tail (best0, bf0,
//    maxfe, count, cap, req, and per request a magic multiplier and
//    shift for the floor division).  It also zeroes the group's assign
//    row, so the chain stores only nonzero words.  On the chain, with rem
//    the pods the open nodes did not take: rem <= 0 opens nothing; rem >=
//    maxfe caps no offering, so min(fe0, rem) == fe0 everywhere and
//    (best, bf) = (best0, bf0) exactly; only 0 < rem < maxfe sweeps the
//    offerings (rank / min(fe0, rem), the same first-index argmin).
// 2. No global load on the chain.  The chain is the prologue's
//    programmatic dependent launch: it stages its catalog (alloc int4[O],
//    rank f32[O], with cp.async) and sets up node state while the
//    prologue runs, then waits for the rows.  Rows stream through a ring
//    of kStages shared-memory slots, kAhead ahead of the step, each a 1-D
//    TMA bulk copy issued by one thread onto the slot's mbarrier.  The
//    gather compat[g, node_off[n]], the sweep and alloc[best] are then
//    shared-memory reads.
// 3. Fewer barriers and less work per step.  A step has one block barrier
//    (the exclusive scan of the fits: every warp reads the warp totals
//    and takes its prefix and the total with redux.sync; placed =
//    min(count, total) when no fit can wrap a prefix), plus one only on
//    the capped branch (the argmin) or for fits that could wrap; the old
//    kernel had eight.  The slots below ptr are the open nodes, so a warp
//    whose slots are all at or above it skips the fill; node state is one
//    int4 per slot and the fill divides by multiply and shift.  Each
//    thread owns kSlots slots, strided by the block size (the least power
//    of two that lets 1024 threads hold N; a template parameter, so the
//    per-slot loops unroll to exactly that), and the block has max(256,
//    N / kSlots) threads.  A slot is read and written by its thread only,
//    so node state needs no barrier.
// 4. One SM per problem stays: the G steps are sequential.
//
// Soft preferences (the reference's solve_core pref scan) rank each group
// by its own row, rank_g = rank * (1 + lambda * miss_g): rank then has a
// group stride beside its problem stride (group stride 0 is the shared
// row).  The prologue reads the group's row.  The chain reads it only in
// the capped sweep, and a capped sweep is a chain of dependent argmin
// folds: read from L2 there, each thread's O / T offerings cost as many
// L2 round trips on the chain (~1.25 us a capped step at the pref window,
// G = 512, O = 3072, N = 512, on an H100 80GB HBM3 at 700 W; chip_smoke.py
// times the two forms in turns).  So where shared memory holds it, the
// group's row rides the ring (kCatRowsRank, kRowsRank): each ring slot
// holds the group's rank row behind its prologue row, brought by a
// second TMA bulk copy that completes on the slot's mbarrier (its bytes
// added to the expected count), kAhead steps early, and the capped sweep
// reads it from shared memory as the shared-row form reads s_rank.  The
// row must be 16-byte aligned with a whole number of 16-byte words (O %
// 4 == 0, checked by the launcher).  Where the ring cannot hold it, the
// rows stay staged if they fit (kRows) and the sweep reads the row from
// L2, one load per offering: at N = 8192 and O = 4096 that took 0.83x
// the time of reading rows and rank row from L2 with a batch of four
// loads in flight per thread (tools/torch_scan_ab.py).  The two forms
// are separate instantiations (kGroupRank), so the shared-row path
// compiles to the code it had before the group stride: a uniform
// run-time branch measured 14% slower there (tools/torch_scan_ab.py).
//
// Shared memory decides the instantiation, from the shapes and the form
// (ffd_scan_variant): node state is 20 B per slot, a ring slot is a row
// of 4 x (round_up(O, 4) + 16) bytes (plus 4 x round_up(O, 4) for the
// group's rank row in kCatRowsRank and kRowsRank), the catalog 20 B per
// offering (16 B in the per-group form, which stages no shared rank),
// and a block has 227 KB with its static arrays.  kCatRows stages rows
// and catalog, kRows rows only, kGlobal reads both from global memory,
// through L2; kCatRowsRank and kRowsRank (per-group form only) add the
// groups' rank rows to kCatRows and kRows.  Shared row: kCatRows up to
// N = 4096 at O = 4096, kRows at N = 8192 and O = 4096, kGlobal above O
// = 4100 at N = 8192.  A rank row per group, in the order kCatRowsRank,
// kRowsRank, kRows, kGlobal: kCatRowsRank at the pref window (O = 3072,
// N = 512) and up to N = 1024 at O = 4096, kRowsRank at N = 2048-4096
// and O = 4096 (0.98x the time of staging the catalog instead there),
// kRows at N = 8192 and O = 4096, kGlobal at N = 8192 and O = 5000.
//
// Arithmetic mirrors the reference's int32 semantics: sums and
// differences wrap (computed in uint32), divisions by a request are
// floor divisions, and a resource with req = 0 is unconstrained.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMinThreads = 256;
constexpr int kMaxPerThread = 8;          // N <= 8192
constexpr int kOfferThreads = 512;
constexpr int kNoIndex = 0x7fffffff;
constexpr int kStages = 4;                // ring slots
constexpr int kAhead = kStages - 1;       // rows in flight ahead of the step
constexpr int kTail = 16;                 // words after a row's offerings
constexpr int kSmemLimit = 232448;        // a block's opt-in maximum, sm_90
constexpr int kMaxDevices = 64;
constexpr unsigned kCompatBit = 0x80000000u;
constexpr int kFitSafe = 1 << 18;         // kMaxThreads * kMaxPerThread fits
                                          // below it sum below 2^31
constexpr unsigned kFull = 0xffffffffu;

// tail words of a row, after round_up(O, 4) offering words: the
// prologue's argmin, the group's meta, and per request a magic multiplier
// with its shift (four shifts packed in one word) for the floor division
enum {
  kTBest = 0, kTBf = 1, kTMaxFe = 2, kTCount = 3, kTCap = 4, kTReq = 5,
  kTMag = 9, kTShift = 13
};

enum Variant {
  kGlobal = 0, kRows = 1, kCatRows = 2,
  kCatRowsRank = 3, kRowsRank = 4       // per-group form only
};

__host__ __device__ constexpr int round_up4(int x) { return (x + 3) & ~3; }

__host__ __device__ constexpr int row_words(int O) {
  return round_up4(O) + kTail;
}

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

// The first-index argmin as one unsigned 64-bit minimum.  The reference
// takes jnp.argmin, which returns the FIRST index of the minimum, and
// index 0 when every entry is inf (then bf <= 0 and no node opens).  The
// high word maps the float to an unsigned key with the same order (+0
// and -0 equal), the low word is the index, so the smaller value wins
// and on equal values (inf included) the smaller index.  A NaN never
// wins: its candidate is skipped.
__device__ __forceinline__ unsigned long long arg_key(float v, int i) {
  unsigned b = __float_as_uint(v);
  if ((b << 1) == 0u) b = 0u;
  b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return (static_cast<unsigned long long>(b) << 32) | static_cast<unsigned>(i);
}

// (inf, no index): the argmin of an empty or all-NaN set
constexpr unsigned long long kNoArg =
    (static_cast<unsigned long long>(0xff800000u) << 32) | kNoIndex;

// rank / fe in IEEE round-to-nearest, inf where fe <= 0: the reference
// divides rank by fit in f32.  __fdiv_rn keeps that even if the file is
// ever compiled with fast math (which it must not be: a one-ulp
// difference flips the chosen offering).
__device__ __forceinline__ unsigned long long candidate(
    unsigned long long best, float r, int fe, int o) {
  const float cpp = fe > 0 ? __fdiv_rn(r, __int2float_rn(fe)) : INFINITY;
  if (isnan(cpp)) return best;
  const unsigned long long key = arg_key(cpp, o);
  return key < best ? key : best;
}

// Warp minimum of a 64-bit key with two 32-bit redux.sync: the least
// high word, then the least low word among the lanes that hold it.
__device__ __forceinline__ unsigned long long warp_min_key(
    unsigned long long x) {
  const unsigned hi = static_cast<unsigned>(x >> 32);
  const unsigned lo = static_cast<unsigned>(x);
  const unsigned mhi = __reduce_min_sync(kFull, hi);
  const unsigned mlo = __reduce_min_sync(kFull, hi == mhi ? lo : kFull);
  return (static_cast<unsigned long long>(mhi) << 32) | mlo;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Pods of a group that fit in `c` (an allocatable or a node's residual).
// A resource with req = 0 is unconstrained, so it contributes fit_big
// (the reference's FIT_BIG) instead of a division by zero.  The floor
// divisions by the group's requests are a multiply and a shift (mag, sh
// from group_magic: exact for c >= 0; a negative c, which only wrapped
// arithmetic makes, takes the division).
__device__ __forceinline__ int fit_count_mag(const int c[4], const int req[4],
                                             const unsigned mag[4],
                                             unsigned shifts, int fit_big) {
  int f = fit_big;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (req[r] > 0) {
      // the shift is 31 + l >= 31; 31 only for b = 1, where q = a
      const unsigned sh = (shifts >> (8 * r)) & 0xffu;
      const int q = c[r] < 0 ? floor_div(c[r], req[r])
          : sh == 31 ? c[r]
          : static_cast<int>(__umulhi(static_cast<unsigned>(c[r]), mag[r])
                             >> (sh - 32));
      f = min(f, q);
    }
  }
  return f;
}

// The magic multiplier and shift of a floor division by b > 0:
// floor(a / b) = (a * m) >> (31 + l) for 0 <= a < 2^31, with
// l = ceil(log2 b) and m = floor(2^(31+l) / b) + 1 < 2^32 (Granlund and
// Montgomery's round-up multiplier for 31-bit dividends).  b <= 0 gives
// (0, 0): fit_count_mag never divides by it.
__device__ __forceinline__ void group_magic(int b, unsigned* m,
                                            unsigned* sh) {
  *m = 0;
  *sh = 0;
  if (b > 0) {
    const unsigned u = static_cast<unsigned>(b);
    const int l = u > 1 ? 32 - __clz(u - 1) : 0;
    *m = static_cast<unsigned>((1ull << (31 + l)) / u + 1);
    *sh = 31 + l;
  }
}

// Programmatic dependent launch: the prologue lets the chain's grid start
// early; the chain stages what does not come from the prologue (its
// catalog, node state), then waits for the prologue's rows.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- prologue: one block per (problem, group), over the whole card ------

template <typename CT, bool kGroupRank>
__global__ void __launch_bounds__(kOfferThreads)
ffd_offer_kernel(const int* __restrict__ meta, const CT* __restrict__ compat,
                 const int* __restrict__ alloc_all, long long alloc_stride,
                 const float* __restrict__ rank_all, long long rank_stride,
                 long long rank_gstride, int* __restrict__ rows,
                 int* __restrict__ assign, int G, int O, int N,
                 int fit_big) {
  __shared__ unsigned long long s_key[kOfferThreads / 32];
  __shared__ unsigned s_max[kOfferThreads / 32];
  __shared__ unsigned s_mag[4];
  __shared__ unsigned s_sh[4];
  allow_dependents();
  const long long cg = blockIdx.x;          // c * G + g
  const long long c = cg / G;
  const int4* __restrict__ alloc = reinterpret_cast<const int4*>(
      alloc_all + c * alloc_stride);
  const float* __restrict__ rank = rank_all + c * rank_stride
      + (kGroupRank ? (cg - c * G) * rank_gstride : 0);
  const int* mg = meta + cg * 8;
  const CT* crow = compat + cg * O;
  int* row = rows + cg * row_words(O);
  int req[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) req[r] = __ldg(mg + r);
  const int cap = __ldg(mg + 5);

  const int tid = threadIdx.x;
  if (tid < 4) group_magic(req[tid], &s_mag[tid], &s_sh[tid]);
  // the chain stores only the nonzero words of assign[c, g, :]
  int* assign_g = assign + cg * N;
  for (int n = tid; n < N; n += kOfferThreads) assign_g[n] = 0;
  __syncthreads();
  const unsigned mag[4] = {s_mag[0], s_mag[1], s_mag[2], s_mag[3]};
  const unsigned shifts = s_sh[0] | s_sh[1] << 8 | s_sh[2] << 16
      | s_sh[3] << 24;
  unsigned long long best = kNoArg;
  unsigned maxfe = 0;
  // unrolled so that the loads of several offerings are in flight at once
#pragma unroll 4
  for (int o = tid; o < O; o += kOfferThreads) {
    const int4 a = __ldg(alloc + o);
    const bool ok = crow[o] != 0;
    const int av[4] = {a.x, a.y, a.z, a.w};
    int fe = ok ? fit_count_mag(av, req, mag, shifts, fit_big) : 0;
    fe = max(min(fe, cap), 0);
    row[o] = static_cast<int>(ok ? (kCompatBit | fe) : fe);
    maxfe = max(maxfe, static_cast<unsigned>(fe));
    best = candidate(best, __ldg(rank + o), fe, o);
  }
  best = warp_min_key(best);
  maxfe = __reduce_max_sync(kFull, maxfe);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    s_key[warp] = best;
    s_max[warp] = maxfe;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kOfferThreads / 32;
    best = warp_min_key(lane < kWarps ? s_key[lane] : kNoArg);
    maxfe = __reduce_max_sync(kFull, lane < kWarps ? s_max[lane] : 0u);
    if (lane == 0) {
      const int b = static_cast<int>(static_cast<unsigned>(best));
      int bf = 0;
      if (b != kNoIndex) {                  // fe0[b], recomputed
        const int4 a = __ldg(alloc + b);
        const int av[4] = {a.x, a.y, a.z, a.w};
        bf = crow[b] != 0 ? fit_count_mag(av, req, mag, shifts, fit_big) : 0;
        bf = max(min(bf, cap), 0);
      }
      int* tail = row + round_up4(O);
      tail[kTBest] = b;
      tail[kTBf] = bf;
      tail[kTMaxFe] = static_cast<int>(maxfe);
      tail[kTCount] = __ldg(mg + 4);
      tail[kTCap] = cap;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        tail[kTReq + r] = req[r];
        tail[kTMag + r] = static_cast<int>(mag[r]);
      }
      tail[kTShift] = static_cast<int>(shifts);
    }
  }
}

// ---- the chain: one block per problem ------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One row (row_words(O) words: a multiple of 16 bytes, 16-byte aligned at
// both ends) into a ring slot with a 1-D TMA bulk copy issued by one
// thread; the slot's mbarrier completes when the bytes have landed.  The
// fence orders the block's earlier generic reads of the slot (done before
// the barrier that precedes this call) before the async-proxy write.
__device__ __forceinline__ void load_row(int* dst, const int* src,
                                         unsigned bytes,
                                         unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The per-group form's slot: the prologue row as above and, behind it,
// the group's rank row (rank_bytes, a multiple of 16, from a 16-byte
// aligned address), both completing on the slot's one mbarrier.
__device__ __forceinline__ void load_row_rank(int* dst, const int* src,
                                              unsigned bytes,
                                              float* rank_dst,
                                              const float* rank_src,
                                              unsigned rank_bytes,
                                              unsigned long long* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      :: "r"(smem_addr(bar)), "r"(bytes + rank_bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(rank_dst)), "l"(rank_src), "r"(rank_bytes),
         "r"(smem_addr(bar))
      : "memory");
}

// Wait until the mbarrier's phase with this parity has completed: the
// row is then visible to the waiting thread.
__device__ __forceinline__ void wait_row(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// The chain.  Thread tid owns node slots n = i * T + tid for i < kSlots
// (a compile-time count, so the per-slot loops unroll to exactly that:
// a loop unrolled to the most slots any N needs, 8, and guarded measured
// 2.2 us per step at one slot each).  Slot order is the FFD age order;
// the slots below ptr are the open nodes, so a (round i, warp) chunk of
// 32 slots at or above ptr has nothing to fill and skips the work.
template <int kVariant, int kSlots, bool kGroupRank>
__global__ void __launch_bounds__(kMaxThreads, 1)
ffd_chain_kernel(const int* __restrict__ rows,
                 const int* __restrict__ alloc_all, long long alloc_stride,
                 const float* __restrict__ rank_all, long long rank_stride,
                 long long rank_gstride, int* __restrict__ node_off_out,
                 int* __restrict__ assign, int* __restrict__ unplaced, int G,
                 int O, int N, int fit_big) {
  constexpr bool kRowsSmem = kVariant != kGlobal;
  constexpr bool kCatSmem = kVariant == kCatRows || kVariant == kCatRowsRank;
  // one rank row per group: s_rank is not staged; the group's row rides
  // its ring slot in kCatRowsRank, else it is read from L2
  constexpr bool kRankSmem = kCatSmem && !kGroupRank;
  constexpr bool kRankRing = kVariant == kCatRowsRank || kVariant == kRowsRank;
  static_assert(!kRankRing || kGroupRank, "the ring holds per-group rows");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned s_scan[2][kSlots][32];  // chunk totals, by parity
  __shared__ unsigned s_odd[2][32];           // warp "a fit may wrap"
  __shared__ unsigned s_take[32];             // warp sums of the takes
  __shared__ unsigned long long s_arg[32];    // warp argmin keys
  __shared__ unsigned long long s_full[kStages];  // ring slot mbarriers

  const int RS = row_words(O);
  const int OR = round_up4(O);
  // a ring slot: the prologue row, then (kRankRing) the group's rank row
  const int SS = kRankRing ? RS + OR : RS;
  // [ring kStages x SS][alloc int4 O][rank f32 OR, shared row only]
  // [resid int4 N][node_off N]
  int* ring = reinterpret_cast<int*>(smem);
  unsigned char* p = smem + (kRowsSmem ? kStages * SS * 4 : 0);
  int4* s_alloc = reinterpret_cast<int4*>(p);
  float* s_rank = reinterpret_cast<float*>(p + 16 * static_cast<size_t>(O));
  if (kCatSmem) p += 16 * static_cast<size_t>(O) + (kRankSmem ? 4 * OR : 0);
  int4* s_res = reinterpret_cast<int4*>(p);
  int* s_off = reinterpret_cast<int*>(p + 16 * static_cast<size_t>(N));

  const long long c = blockIdx.x;
  const int* crows = rows + c * G * RS;
  const int4* __restrict__ g_alloc = reinterpret_cast<const int4*>(
      alloc_all + c * alloc_stride);
  const float* __restrict__ g_rank = rank_all + c * rank_stride;
  node_off_out += c * N;
  assign += c * G * N;                      // zeroed by the prologue
  unplaced += c * G;

  const int T = blockDim.x;
  const int nwarps = T >> 5;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // The block's scalar side jobs (row loads, unplaced) go to lane 0 of
  // the last warp, whose slots open last: thread 0's fill of slot 0 is
  // on every step's critical path.
  const bool steward = tid == T - 32;

  // The catalog and node state do not come from the prologue: they are
  // set up before the wait for its rows.  Row r goes to slot r % kStages;
  // the slot's mbarrier completes phase r / kStages when it lands.
  const unsigned row_bytes = static_cast<unsigned>(RS) * 4u;
  const unsigned rank_bytes = static_cast<unsigned>(O) * 4u;
  // kRankRing: row r and group r's rank row into slot r % kStages
  auto load_rank_slot = [&](int r) {
    int* slot = ring + (r % kStages) * SS;
    load_row_rank(slot, crows + static_cast<long long>(r) * RS, row_bytes,
                  reinterpret_cast<float*>(slot + RS),
                  g_rank + static_cast<long long>(r) * rank_gstride,
                  rank_bytes, &s_full[r % kStages]);
  };
  if (kCatSmem) {
    for (int o = tid; o < O; o += T) {
      cp_async16(s_alloc + o, g_alloc + o);
      if (kRankSmem) cp_async4(s_rank + o, g_rank + o);
    }
  }
  if (kRowsSmem && steward) {
    for (int i = 0; i < kStages; ++i)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_addr(&s_full[i])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int n = i * T + tid;
    if (n < N) {
      s_off[n] = -1;
      s_res[n] = make_int4(0, 0, 0, 0);
    }
  }
  wait_primary();
  if (kRowsSmem && steward) {
    for (int r = 0; r < kAhead && r < G; ++r) {
      if constexpr (kRankRing)
        load_rank_slot(r);
      else
        load_row(ring + r * RS, crows + r * RS, row_bytes, &s_full[r]);
    }
  }
  if (kCatSmem) cp_async_wait_all();
  __syncthreads();

  int ptr = 0;                              // open slots (uniform)
  for (int g = 0; g < G; ++g) {
    const int* row = kRowsSmem ? ring + (g % kStages) * SS
                               : crows + static_cast<long long>(g) * RS;
    if (kRowsSmem) wait_row(&s_full[g % kStages], (g / kStages) & 1);
    // the tail as four 16-byte words: (best0, bf0, maxfe, count),
    // (cap, req0, req1, req2), (req3, mag0, mag1, mag2), (mag3, shifts)
    const int4* tail = reinterpret_cast<const int4*>(row + OR);
    const int4 t0 = tail[0];
    const int4 t1 = tail[1];
    const int4 t2 = tail[2];
    const int4 t3 = tail[3];
    const int req[4] = {t1.y, t1.z, t1.w, t2.x};
    const unsigned mag[4] = {static_cast<unsigned>(t2.y),
                             static_cast<unsigned>(t2.z),
                             static_cast<unsigned>(t2.w),
                             static_cast<unsigned>(t3.x)};
    const unsigned shifts = static_cast<unsigned>(t3.y);
    const int count = t0.w;
    const int cap = t1.x;
    // A closed slot's fit is min(0, cap): 0, unless cap < 0, when every
    // slot takes part (uniform)
    const int active = cap >= 0 ? ptr : N;

    // ---- fill open nodes, first-fit in age order ----------------------
    int fit[kSlots];
    unsigned inc[kSlots];
    bool odd = false;                       // a fit outside [0, kFitSafe)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      fit[i] = 0;
      inc[i] = 0;
      if (i * T + warp * 32 < active) {     // warp-uniform
        const int n = i * T + tid;
        int f = 0;
        if (n < active) {
          const int off = s_off[n];
          int v = 0;
          if (off >= 0 && row[off] < 0) {   // compat bit
            const int4 rv = s_res[n];
            const int res[4] = {rv.x, rv.y, rv.z, rv.w};
            v = fit_count_mag(res, req, mag, shifts, fit_big);
          }
          f = min(v, cap);
        }
        fit[i] = f;
        odd |= f < 0 || f >= kFitSafe;
        // inclusive warp scan, mod 2^32 (the reference's wrapping cumsum)
        unsigned x = static_cast<unsigned>(f);
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const unsigned y = __shfl_up_sync(kFull, x, d);
          if (lane >= d) x += y;
        }
        inc[i] = x;
        if (lane == 31) s_scan[g & 1][i][warp] = x;
      }
    }
    const bool warp_odd = __any_sync(kFull, odd);
    if (lane == 0) s_odd[g & 1][warp] = warp_odd;
    __syncthreads();
    if (kRowsSmem && steward && g + kAhead < G) {
      // the slot of row g + kAhead held row g - 1 (and its rank row),
      // read before the barrier
      const int r = g + kAhead;
      if constexpr (kRankRing)
        load_rank_slot(r);
      else
        load_row(ring + (r % kStages) * RS,
                 crows + static_cast<long long>(r) * RS, row_bytes,
                 &s_full[r % kStages]);
    }
    // every warp reads the chunk totals of the rounds with open slots and
    // takes its exclusive prefix and the total with redux.sync
    unsigned total = 0;
    unsigned cum[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      cum[i] = 0;
      const int live = active - i * T;      // uniform
      if (live > 0) {
        const int chunks = min(nwarps, (live + 31) >> 5);
        const unsigned w = lane < chunks ? s_scan[g & 1][i][lane] : 0u;
        cum[i] = total + __reduce_add_sync(kFull, lane < warp ? w : 0u)
            + inc[i] - static_cast<unsigned>(fit[i]);
        total += __reduce_add_sync(kFull, w);
      }
    }
    const bool block_odd = count < 0 || __any_sync(
        kFull, lane < nwarps && s_odd[g & 1][lane] != 0u);
    unsigned ltake = 0;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int n = i * T + tid;
      if (n < active) {
        // take = clip(count - cumfit, 0, fit)
        int t = wrap_sub(count, static_cast<int>(cum[i]));
        t = min(max(t, 0), fit[i]);
        fit[i] = t;                         // fit[] now holds take
        ltake += static_cast<unsigned>(t);
        if (t != 0) {
          const int4 rv = s_res[n];
          s_res[n] = make_int4(wrap_sub(rv.x, wrap_mul(t, req[0])),
                               wrap_sub(rv.y, wrap_mul(t, req[1])),
                               wrap_sub(rv.z, wrap_mul(t, req[2])),
                               wrap_sub(rv.w, wrap_mul(t, req[3])));
        }
      }
    }
    // placed = the sum of the takes.  With count >= 0 and every fit in
    // [0, kFitSafe), no prefix wraps (N * kFitSafe <= 2^31), the takes
    // fill first-fit and their sum is min(count, total fit): no second
    // exchange.  Otherwise (a fit near FIT_BIG from all-zero requests, a
    // negative count or fit) the block sums the takes themselves, mod
    // 2^32, behind a second barrier.
    int placed;
    if (!block_odd) {
      placed = min(count, static_cast<int>(total));
    } else {
      const unsigned sw = __reduce_add_sync(kFull, ltake);
      if (lane == 0) s_take[warp] = sw;
      __syncthreads();
      placed = static_cast<int>(__reduce_add_sync(
          kFull, lane < nwarps ? s_take[lane] : 0u));
    }
    const int rem = wrap_sub(count, placed);

    // ---- open new nodes with the cheapest-per-pod offering ------------
    // rem and maxfe are uniform, so every branch is taken by the block
    int best = 0;
    int bf = 0;                             // <= 0: no node opens
    if (rem > 0) {
      if (rem >= t0.z) {                    // rem >= maxfe
        best = t0.x;
        bf = t0.y;
      } else {
        unsigned long long key = kNoArg;
        if constexpr (kRankRing) {
          // the group's row, staged in its ring slot behind the row
          const float* rank_s = reinterpret_cast<const float*>(row + RS);
          for (int o = tid; o < O; o += T)
            key = candidate(key, rank_s[o], min(row[o] & 0x7fffffff, rem),
                            o);
        } else {
          const float* __restrict__ rank_row = kGroupRank
              ? g_rank + static_cast<long long>(g) * rank_gstride : g_rank;
          for (int o = tid; o < O; o += T) {
            const float r = kRankSmem ? s_rank[o] : __ldg(rank_row + o);
            key = candidate(key, r, min(row[o] & 0x7fffffff, rem), o);
          }
        }
        key = warp_min_key(key);
        if (lane == 0) s_arg[warp] = key;
        __syncthreads();
        key = warp_min_key(lane < nwarps ? s_arg[lane] : kNoArg);
        best = static_cast<int>(static_cast<unsigned>(key));
        if (best != kNoIndex) bf = min(row[best] & 0x7fffffff, rem);
      }
    }

    // Ceiling division: the reference writes -(-rem // bf), a
    // floor-based ceiling; C's truncating / on a negated operand would
    // round the wrong way.  Under bf > 0 we have rem >= bf > 0 (fit_e is
    // capped by rem), so (rem + bf - 1) / bf is exact, and in unsigned 32
    // bits it cannot overflow (both are below 2^31): no 64-bit division
    // on the chain.  Then clamp by the free slots N - ptr.
    int n_new = 0;
    if (bf > 0)
      n_new = static_cast<int>(
          (static_cast<unsigned>(rem) + static_cast<unsigned>(bf) - 1u)
          / static_cast<unsigned>(bf));
    n_new = min(n_new, N - ptr);

    // Every slot in [ptr, ptr + n_new) receives clip(rem - j*bf, 0, bf)
    // pods, which is > 0 for j < ceil(rem / bf): all n_new slots open.
    // There j * bf < rem, so rem - j * bf is exact in 32 bits.  assign
    // was zeroed by the prologue: only nonzero words are stored.
    int4 ab = make_int4(0, 0, 0, 0);
    if (n_new > 0) ab = kCatSmem ? s_alloc[best] : __ldg(g_alloc + best);
    int* assign_g = assign + static_cast<long long>(g) * N;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int n = i * T + tid;
      const int j = n - ptr;
      int pods = 0;
      if (j >= 0 && j < n_new) {
        pods = min(rem - j * bf, bf);
        s_off[n] = best;
        s_res[n] = make_int4(wrap_sub(ab.x, wrap_mul(pods, req[0])),
                             wrap_sub(ab.y, wrap_mul(pods, req[1])),
                             wrap_sub(ab.z, wrap_mul(pods, req[2])),
                             wrap_sub(ab.w, wrap_mul(pods, req[3])));
      }
      const int a = wrap_add(n < active ? fit[i] : 0, pods);
      if (a != 0) assign_g[n] = a;
    }
    if (steward) {
      long long placed_new = 0;
      if (n_new > 0) {
        placed_new = static_cast<long long>(n_new) * bf;
        if (placed_new > rem) placed_new = rem;
      }
      unplaced[g] = wrap_sub(rem, static_cast<int>(placed_new));
    }
    ptr += n_new;
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int n = i * T + tid;
    if (n < N) node_off_out[n] = s_off[n];
  }
}

// ---- host side ------------------------------------------------------------

// Slots per thread: the least power of two that lets 1024 threads hold N.
int chain_slots(int N) {
  int k = 1;
  while (k * kMaxThreads < N) k *= 2;
  return k;
}

// Threads of the chain's block: N / slots, at least 256 (the capped
// sweep over the offerings runs on every thread).
int chain_threads(int N) {
  const int k = chain_slots(N);
  const int t = ((N + k - 1) / k + 31) / 32 * 32;
  return t < kMinThreads ? kMinThreads : t;
}

// Dynamic shared memory of the chain: node state, the ring (a slot holds
// the group's rank row too in kCatRowsRank and kRowsRank), the catalog
// (with the shared rank row in the shared-row form).
size_t chain_smem(int variant, int O, int N, bool group_rank) {
  size_t s = static_cast<size_t>(N) * 5 * sizeof(int);
  const size_t rank_words = static_cast<size_t>(round_up4(O));
  const bool ring = variant == kCatRowsRank || variant == kRowsRank;
  if (variant != kGlobal)
    s += static_cast<size_t>(kStages)
        * (row_words(O) + (ring ? rank_words : 0)) * sizeof(int);
  if (variant == kCatRows || variant == kCatRowsRank)
    s += 16 * static_cast<size_t>(O) + (group_rank ? 0 : 4 * rank_words);
  return s;
}

// Static shared memory of the chain kernel: s_scan, s_odd, s_take, s_arg,
// s_full.
size_t chain_static_smem(int N) {
  return 4 * (2 * 32 * static_cast<size_t>(chain_slots(N)) + 2 * 32 + 32)
      + 8 * (32 + kStages);
}

int choose_variant(int O, int N, bool group_rank) {
  const size_t room = kSmemLimit - chain_static_smem(N);
  if (group_rank) {
    for (const int v : {kCatRowsRank, kRowsRank, kRows})
      if (chain_smem(v, O, N, true) <= room) return v;
    return kGlobal;
  }
  if (chain_smem(kCatRows, O, N, false) <= room) return kCatRows;
  if (chain_smem(kRows, O, N, false) <= room) return kRows;
  return kGlobal;
}

// The opt-in to more than 48 KB of dynamic shared memory must precede a
// launch, or the launch is refused.  It is per device and per kernel:
// set once per (instantiation, device) to the largest size asked for.
std::mutex g_attr_mutex;
// [variant][log2 slots][group rank][device]
int g_attr_bytes[5][4][2][kMaxDevices];

template <int kVariant, int kSlots, bool kGroupRank>
cudaError_t launch_chain(const int* rows, const int* alloc,
                         long long alloc_stride, const float* rank,
                         long long rank_stride, long long rank_gstride,
                         int* node_off, int* assign,
                         int* unplaced, int C, int G, int O, int N,
                         int fit_big, int device, cudaStream_t stream) {
  const auto kernel = ffd_chain_kernel<kVariant, kSlots, kGroupRank>;
  const size_t smem = chain_smem(kVariant, O, N, kGroupRank);
  {
    std::lock_guard<std::mutex> lock(g_attr_mutex);
    int& have =
        g_attr_bytes[kVariant][__builtin_ctz(kSlots)][kGroupRank][device];
    if (static_cast<size_t>(have) < smem) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      have = static_cast<int>(smem);
    }
  }
  // launched as the prologue's programmatic dependent when there is one
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(chain_threads(N));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = G > 0 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, rows, alloc, alloc_stride, rank,
                            rank_stride, rank_gstride, node_off, assign,
                            unplaced, G, O, N, fit_big);
}

template <int kVariant, int kSlots>
cudaError_t launch_chain_rank(const int* rows, const int* alloc,
                              long long alloc_stride, const float* rank,
                              long long rank_stride, long long rank_gstride,
                              int* node_off, int* assign, int* unplaced,
                              int C, int G, int O, int N, int fit_big,
                              int device, cudaStream_t stream) {
  // the ring layouts are per-group only, kCatRows shared-row only
  if constexpr (kVariant == kCatRowsRank || kVariant == kRowsRank)
    return launch_chain<kVariant, kSlots, true>(
        rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
        node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
  else if constexpr (kVariant == kCatRows)
    return launch_chain<kVariant, kSlots, false>(
        rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
        node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
  else
    return rank_gstride != 0
        ? launch_chain<kVariant, kSlots, true>(
              rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
              node_off, assign, unplaced, C, G, O, N, fit_big, device,
              stream)
        : launch_chain<kVariant, kSlots, false>(
              rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
              node_off, assign, unplaced, C, G, O, N, fit_big, device,
              stream);
}

template <int kVariant>
cudaError_t launch_chain_slots(const int* rows, const int* alloc,
                               long long alloc_stride, const float* rank,
                               long long rank_stride, long long rank_gstride,
                               int* node_off, int* assign, int* unplaced,
                               int C, int G, int O, int N, int fit_big,
                               int device, cudaStream_t stream) {
  switch (chain_slots(N)) {
    case 1:
      return launch_chain_rank<kVariant, 1>(
          rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
          node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
    case 2:
      return launch_chain_rank<kVariant, 2>(
          rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
          node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
    case 4:
      return launch_chain_rank<kVariant, 4>(
          rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
          node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
    default:
      return launch_chain_rank<kVariant, 8>(
          rows, alloc, alloc_stride, rank, rank_stride, rank_gstride,
          node_off, assign, unplaced, C, G, O, N, fit_big, device, stream);
  }
}

template <typename CT>
void launch_offers(const int* meta, const void* compat, const int* alloc,
                   long long alloc_stride, const float* rank,
                   long long rank_stride, long long rank_gstride, int* rows,
                   int* assign, int C, int G, int O, int N, int fit_big,
                   cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>(C) * G;
  const CT* compat_t = static_cast<const CT*>(compat);
  if (rank_gstride != 0)
    ffd_offer_kernel<CT, true><<<blocks, kOfferThreads, 0, stream>>>(
        meta, compat_t, alloc, alloc_stride, rank, rank_stride,
        rank_gstride, rows, assign, G, O, N, fit_big);
  else
    ffd_offer_kernel<CT, false><<<blocks, kOfferThreads, 0, stream>>>(
        meta, compat_t, alloc, alloc_stride, rank, rank_stride,
        rank_gstride, rows, assign, G, O, N, fit_big);
}

}  // namespace

extern "C" {

// Largest node axis the kernel takes (threads x slots per thread).
int ffd_scan_max_nodes() { return kMaxThreads * kMaxPerThread; }

// int32 words of one group's row in the scratch the caller allocates:
// the scratch is int32 [C, G, ffd_scan_row_words(O)], 16-byte aligned.
int ffd_scan_row_words(int O) { return row_words(O); }

// The chain kernel's instantiation for a shape and form (group_rank = 1:
// a rank row per group): 4 = rows and the groups' rank rows in shared
// memory, 3 = rows, catalog and rank rows (4 and 3: per-group form only),
// 2 = rows and catalog (shared-row form only), 1 = rows only, 0 = both
// read from global memory.
int ffd_scan_variant(int O, int N, int group_rank) {
  return choose_variant(O, N, group_rank != 0);
}

// meta int32 [C, G, 8]; compat [C, G, O] int32 (compat_u8 = 0) or uint8
// (compat_u8 = 1); alloc int32 [C, O, 4] with problem stride
// alloc_stride (in int32 elements, a multiple of 4; 0 = one catalog
// shared by all problems), 16-byte aligned; rank f32 [C, O] with problem
// stride rank_stride (0 = shared), or one row per group, [C, G, O], with
// group stride rank_gstride (0 = one row shared by the groups; else O %
// 4 == 0, both strides multiples of 4 and rank 16-byte aligned, so that
// each group's row is a whole number of 16-byte words for its TMA copy);
// rows int32 scratch [C, G, ffd_scan_row_words(O)], 16-byte aligned;
// outputs node_off int32 [C,
// N], assign int32 [C, G, N], unplaced int32 [C, G], all on CUDA device
// `device`.  Launches the prologue (when G > 0) and the chain on
// `stream` and returns the first cudaError_t.
int ffd_scan_launch(const int* meta, const void* compat, int compat_u8,
                    const int* alloc, long long alloc_stride,
                    const float* rank, long long rank_stride,
                    long long rank_gstride, int* rows, int* node_off,
                    int* assign, int* unplaced, int C, int G, int O, int N,
                    int fit_big, int device, void* stream) {
  if (C <= 0 || G < 0 || O <= 0 || N <= 0 || N > kMaxThreads * kMaxPerThread
      || alloc_stride < 0 || rank_stride < 0 || rank_gstride < 0
      || alloc_stride % 4 != 0
      || reinterpret_cast<uintptr_t>(alloc) % 16 != 0
      || reinterpret_cast<uintptr_t>(rows) % 16 != 0
      || (rank_gstride != 0
          && (O % 4 != 0 || rank_gstride % 4 != 0 || rank_stride % 4 != 0
              || reinterpret_cast<uintptr_t>(rank) % 16 != 0))
      || device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  // in it (the caller's runtime may have another current device)
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G > 0) {
    if (compat_u8)
      launch_offers<uint8_t>(meta, compat, alloc, alloc_stride, rank,
                             rank_stride, rank_gstride, rows, assign, C, G, O,
                             N, fit_big, s);
    else
      launch_offers<int>(meta, compat, alloc, alloc_stride, rank,
                         rank_stride, rank_gstride, rows, assign, C, G, O, N,
                         fit_big, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  switch (choose_variant(O, N, rank_gstride != 0)) {
    case kCatRowsRank:
      err = launch_chain_slots<kCatRowsRank>(rows, alloc, alloc_stride, rank,
                                             rank_stride, rank_gstride,
                                             node_off, assign, unplaced, C,
                                             G, O, N, fit_big, device, s);
      break;
    case kRowsRank:
      err = launch_chain_slots<kRowsRank>(rows, alloc, alloc_stride, rank,
                                          rank_stride, rank_gstride,
                                          node_off, assign, unplaced, C, G,
                                          O, N, fit_big, device, s);
      break;
    case kCatRows:
      err = launch_chain_slots<kCatRows>(rows, alloc, alloc_stride, rank,
                                         rank_stride, rank_gstride, node_off,
                                         assign, unplaced, C, G, O, N,
                                         fit_big, device, s);
      break;
    case kRows:
      err = launch_chain_slots<kRows>(rows, alloc, alloc_stride, rank,
                                      rank_stride, rank_gstride, node_off,
                                      assign, unplaced, C, G, O, N, fit_big,
                                      device, s);
      break;
    default:
      err = launch_chain_slots<kGlobal>(rows, alloc, alloc_stride, rank,
                                        rank_stride, rank_gstride, node_off,
                                        assign, unplaced, C, G, O, N,
                                        fit_big, device, s);
  }
  return static_cast<int>(err);
}

const char* ffd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
