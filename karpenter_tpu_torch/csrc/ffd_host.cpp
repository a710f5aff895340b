// Per-pod first-fit-decreasing placement on the host: the
// reference-semantics twin of the greedy oracle.
//
// karpenter-core's Scheduler.Solve walks pods one at a time: try every
// open node in age order (compatibility filter + residual-capacity fit),
// else open a new node with the offering minimizing price per pod that
// fits (the cost ranking of the reference's instancetype provider,
// instancetype.go:88-110, consumed by the compatibility filter of
// cloudprovider.go:321-352).  This file reproduces that *per-pod* loop
// shape in C++: it is the stand-in for the Go loop that the solve is
// compared with (solver/greedy.py solve_per_pod_native), and its parity
// oracle is the grouped python loop (solver/greedy.py), which must
// produce identical plans.  It is host code for g++, not a CUDA kernel,
// and the same function as the JAX package's native/ffd.cpp.
//
// Build: karpenter_tpu_torch/native.py runs
// `g++ -O2 -fPIC -shared -std=c++17` on this file at first use, into
// karpenter_tpu_torch/_build/ under a name carrying a digest of the
// source and flags, and loads it with ctypes.

#include <cstdint>
#include <cmath>
#include <limits>
#include <vector>

namespace {

constexpr int R = 4;  // cpu_milli, memory_mib, gpu, pods

inline bool fits(const int32_t* resid, const int32_t* req) {
  for (int r = 0; r < R; ++r)
    if (req[r] > 0 && resid[r] < req[r]) return false;
  return true;
}

}  // namespace

extern "C" {

// Returns the number of open nodes, or -1 if max_nodes was exhausted with
// placeable pods remaining (caller escalates, mirroring the JAX path).
//
// ``gid`` (optional, may be null): per-row ORIGINAL group id for per-pod
// expansions (solver/greedy.py expand_per_pod).  With one row per pod the
// per-node cap (hostname anti-affinity etc.) cannot be enforced through
// the row's own assign count — each row holds a single pod — so the cap
// accounting runs against ``gid_count`` ([n_gids, N], zeroed by caller)
// keyed by the original group.  Null gid keeps the grouped behavior
// (cap counted on the row itself).
int ffd_solve_gid(int G, int O, int N,
                  const int32_t* group_req,    // [G,R]
                  const int32_t* group_count,  // [G]
                  const int32_t* group_cap,    // [G]
                  const uint8_t* compat,       // [G,O]
                  const int32_t* off_alloc,    // [O,R]
                  const float* off_rank,       // [O]
                  const int32_t* gid,          // [G] or null
                  int32_t* gid_count,          // [n_gids,N] or null
                  int32_t* node_off,           // out [N]  (-1 = unused)
                  int32_t* assign,             // out [G,N] (zeroed by caller)
                  int32_t* unplaced) {         // out [G]
  std::vector<int32_t> resid(static_cast<size_t>(N) * R, 0);
  int open = 0;
  bool overflow = false;

  // Per-ORIGINAL-group state for per-pod expansions.  The grouped
  // backends choose the new-node offering once per group with fit capped
  // by the pods remaining at the first open; a per-pod row (count=1)
  // must use its GID's remaining at the gid's first open — frozen there
  // — or every tail pod would open a 1-pod node.  The offering scan
  // itself is deliberately REPEATED per row (it is a pure function of
  // the frozen remaining, so plans stay bit-identical to the grouped
  // batch-fill): this loop is the reference-cost baseline, and
  // karpenter-core pays instance-type work per pod, not per group.
  int n_gids = 0;
  if (gid) {
    for (int g = 0; g < G; ++g)
      if (gid[g] + 1 > n_gids) n_gids = gid[g] + 1;
  }
  std::vector<int32_t> gid_left(n_gids, 0);
  std::vector<int32_t> gid_frozen_rem(n_gids, -1);   // -1 = not frozen yet
  if (gid) {
    for (int g = 0; g < G; ++g) gid_left[gid[g]] += group_count[g];
  }

  for (int g = 0; g < G; ++g) {
    const int32_t* req = group_req + static_cast<size_t>(g) * R;
    const int32_t cap = group_cap[g];
    const uint8_t* cg = compat + static_cast<size_t>(g) * O;
    int32_t* capcnt = gid ? gid_count + static_cast<size_t>(gid[g]) * N
                          : assign + static_cast<size_t>(g) * N;
    unplaced[g] = 0;

    // best-offering choice at the first node open of this row — see the
    // gid-state comment above the group loop
    int best = -1;
    int32_t best_fit = 0;
    bool best_ready = false;
    const int slot = gid ? gid[g] : -1;

    for (int32_t p = 0; p < group_count[g]; ++p) {
      // first-fit over open nodes in age order — the per-pod hot loop
      bool placed = false;
      for (int n = 0; n < open; ++n) {
        if (!cg[node_off[n]]) continue;
        if (capcnt[n] >= cap) continue;
        int32_t* rn = resid.data() + static_cast<size_t>(n) * R;
        if (!fits(rn, req)) continue;
        for (int r = 0; r < R; ++r) rn[r] -= req[r];
        assign[static_cast<size_t>(g) * N + n] += 1;
        if (gid) {
          capcnt[n] += 1;
          gid_left[slot] -= 1;
        }
        placed = true;
        break;
      }
      if (placed) continue;

      if (!best_ready) {
        best_ready = true;
        int32_t remaining;
        if (slot >= 0) {
          if (gid_frozen_rem[slot] < 0) gid_frozen_rem[slot] = gid_left[slot];
          remaining = gid_frozen_rem[slot];
        } else {
          remaining = group_count[g] - p;
        }
        float best_cpp = std::numeric_limits<float>::infinity();
        for (int o = 0; o < O; ++o) {
          if (!cg[o]) continue;
          const int32_t* alloc = off_alloc + static_cast<size_t>(o) * R;
          int32_t f = std::numeric_limits<int32_t>::max();
          for (int r = 0; r < R; ++r)
            if (req[r] > 0) {
              int32_t q = alloc[r] / req[r];
              if (q < f) f = q;
            }
          if (f == std::numeric_limits<int32_t>::max()) f = 1 << 30;
          if (f > cap) f = cap;
          if (f > remaining) f = remaining;
          if (f <= 0) continue;
          float cpp = off_rank[o] / static_cast<float>(f);
          if (cpp < best_cpp) {
            best_cpp = cpp;
            best = o;
            best_fit = f;
          }
        }
      }
      if (best < 0 || best_fit <= 0) {  // no offering can ever host it
        unplaced[g] = group_count[g] - p;
        break;
      }
      if (open >= N) {
        overflow = true;
        unplaced[g] = group_count[g] - p;
        break;
      }
      int n = open++;
      node_off[n] = best;
      const int32_t* alloc = off_alloc + static_cast<size_t>(best) * R;
      int32_t* rn = resid.data() + static_cast<size_t>(n) * R;
      for (int r = 0; r < R; ++r) rn[r] = alloc[r] - req[r];
      assign[static_cast<size_t>(g) * N + n] = 1;
      if (gid) {
        capcnt[n] += 1;
        gid_left[slot] -= 1;
      }
    }
  }
  return overflow ? -1 : open;
}

// Grouped entry point (original ABI): cap accounting on the row itself.
int ffd_solve(int G, int O, int N,
              const int32_t* group_req, const int32_t* group_count,
              const int32_t* group_cap, const uint8_t* compat,
              const int32_t* off_alloc, const float* off_rank,
              int32_t* node_off, int32_t* assign, int32_t* unplaced) {
  return ffd_solve_gid(G, O, N, group_req, group_count, group_cap, compat,
                       off_alloc, off_rank, nullptr, nullptr,
                       node_off, assign, unplaced);
}

}  // extern "C"
