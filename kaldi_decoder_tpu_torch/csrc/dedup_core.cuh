// The dedup by state and the frontier select, shared by K6 (dedup.cu)
// and K2 (dedup_rec.cu): steps 1-3 of dedup.cu's header (the min pass,
// the winner pass, the select of the K smallest (cost, state) keys).
// dedup.cu's header gives the design; this file holds its code.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"
#include "select_core.cuh"

namespace kdtorch {
namespace dedup {

namespace cg = cooperative_groups;
namespace sel = kdtorch::select;

constexpr int UNROLL = 8;        // lanes a thread has in flight
constexpr int MIN_LANES = 1024;  // a block of a cluster has at least these lanes
// Scratch rows are N + SCRATCH_PAD long: a block's spill region holds its
// chunks of 32 lanes, which round up.
constexpr int SCRATCH_PAD = 32 * sel::MAX_CLUSTER;
constexpr unsigned long long EMPTY = ~0ull;

// The most blocks a cluster of N lanes takes: the power of two, up to
// MAX_CLUSTER, that leaves every block MIN_LANES lanes (a smaller call
// spends less on cluster barriers); kdtorch::pick_cluster's cap.
inline int cluster_cap(int N) {
  int most = 1;
  while (most < sel::MAX_CLUSTER && (long)(2 * most) * MIN_LANES <= N) most *= 2;
  return most;
}

__device__ __forceinline__ bool lane_valid(float c, int d, int S) {
  return isfinite(c) && d >= 0 && d < S;
}

// A lane's word in the winner table: the smallest is its state's winner.
__device__ __forceinline__ unsigned long long min_key(float c, int lane) {
  return ((unsigned long long)kdtorch::ordered_key(c) << 32) | (unsigned)lane;
}

// The lanes a block of the cluster owns: chunks of 32, round robin (K1
// puts the active slots' lanes first, so a split into C ranges would give
// the first block most of the finite lanes).  Local lane li is lane
// lane_of(li); a block has `mine` of them (the last chunk may pass N),
// and at most `most`, the size of its spill region in a scratch row.
struct LaneSplit {
  int C, rank, mine, most;
  __device__ LaneSplit(int C_, int rank_, int N) : C(C_), rank(rank_) {
    const int chunks = (N + 31) / 32;
    mine = (chunks - rank + C - 1) / C * 32;
    most = (chunks + C - 1) / C * 32;
  }
  __device__ __forceinline__ int lane_of(int li) const {
    return ((li >> 5) * C + rank) * 32 + (li & 31);
  }
};

// The lanes of one row as the dedup call reads them: a lane's (state,
// cost), its cost again (K2's tie rule), its payload (K2's records).
// FlatLanes: the row's (B, N) columns.  RoutedLanes: a sharded eps
// iteration's incumbents and received entries, read in place through
// common.cuh:routed_entry.
struct FlatLanes {
  const int* dst;     // the row's
  const float* cost;
  const int* pay0;    // or null (K6)
  const int* pay1;
  __device__ __forceinline__ void load(int i, int* d, float* c) const {
    *c = __ldg(cost + i);
    *d = __ldg(dst + i);
  }
  __device__ __forceinline__ float cost_of(int i) const { return cost[i]; }
  __device__ __forceinline__ int2 payload(int i) const {
    return make_int2(__ldg(pay0 + i), __ldg(pay1 + i));
  }
};

struct RoutedLanes {
  const kdtorch::Routed* r;  // the kernel's __grid_constant__ parameter: read in place
  int b;
  __device__ __forceinline__ void load(int i, int* d, float* c) const {
    kdtorch::routed_state_cost(*r, b, i, d, c);
  }
  __device__ __forceinline__ float cost_of(int i) const { return kdtorch::routed_cost(*r, b, i); }
  __device__ __forceinline__ int2 payload(int i) const {
    return kdtorch::routed_payload(*r, b, i);
  }
};

// Row b's lanes: the routed ones of `r`, or the (B, N) columns' row `row`
// (payload columns may be null).
template <bool ROUTED>
__device__ __forceinline__ auto row_lanes(const int* dst, const float* cost, const int* pay0,
                                          const int* pay1, long row, const kdtorch::Routed& r,
                                          int b) {
  if constexpr (ROUTED) {
    return RoutedLanes{&r, b};
  } else {
    return FlatLanes{dst + row, cost + row, pay0 != nullptr ? pay0 + row : nullptr,
                     pay1 != nullptr ? pay1 + row : nullptr};
  }
}

// A block's list of (key, lane) entries: the first `cap` in shared
// memory, the rest at the same index in the block's spill region.
struct List {
  unsigned long long* sk;
  int* sv;
  int cap;
  unsigned long long* gk;
  int* gv;
  __device__ __forceinline__ void put(int pos, unsigned long long k, int v) const {
    if (pos < cap) {
      sk[pos] = k;
      sv[pos] = v;
    } else {
      gk[pos] = k;
      gv[pos] = v;
    }
  }
  __device__ __forceinline__ unsigned long long key(int e) const {
    return e < cap ? sk[e] : gk[e];
  }
  __device__ __forceinline__ int val(int e) const { return e < cap ? sv[e] : gv[e]; }
  __device__ __forceinline__ sel::Entries entries(int n) const {
    return sel::Entries{sk, sv, cap, gk, gv, n};
  }
};

// Steps 1-3 for one row (`lanes`, N of them), by every thread of the
// row's cluster.  `fin`
// receives the block's finite lanes as (cost bits << 32 | state, lane),
// *s_fin their count; `win` its winners as (total-order cost << 32 |
// state, lane).  With `restore`, each winner restores its table word in
// the winner pass (K6); else the table keeps every touched state's
// (ordered cost << 32 | winning lane) word and the caller restores it
// from `win` once no lane reads it (K2).  With fin_total, thread 0 writes
// the cluster's count of finite lanes there.  emit(rank, key, lane) as in
// sel::select_smallest, whose buffers, stage, sort tables and
// SORT_CROWDED these are.  Returns the row's number of winners once this
// block's emits are done; no lane reads the table after the select's
// first cluster barrier.
template <int THREADS, bool SORT_CROWDED, class Lanes, class Emit>
__device__ int frontier(sel::Shared& sh, cg::cluster_group& cluster, const LaneSplit& ls,
                        const Lanes& lanes, int N, int S, int K,
                        unsigned long long* __restrict__ tab, bool restore, const List& fin,
                        const List& win, int* s_fin, int* fin_total,
                        unsigned long long* keys0, int* vals0, unsigned long long* keys1,
                        int* vals1, unsigned long long* stage, int* stage_v, int stage_cap,
                        sel::SortTables* tables, Emit emit) {
  const int C = ls.C;
  const int tid = threadIdx.x;
  sel::mark_step(0, true);
  for (int q = tid; q < sel::NB; q += THREADS) sh.hist[q] = 0;
  if (tid == 0) {
    sh.count = 0;
    *s_fin = 0;
    sh.mm[0] = ~0ull;
    sh.mm[1] = 0;
  }
  __syncthreads();

  // 1. Per-state minima; this block's finite lanes and cost-key range.
  unsigned tlo = 0xffffffffu, thi = 0;
  for (int l0 = 0; l0 < ls.mine; l0 += THREADS * UNROLL) {
    float c[UNROLL];
    int d[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = ls.lane_of(l0 + u * THREADS + tid);
      const bool here = l0 + u * THREADS + tid < ls.mine && i < N;
      c[u] = INFINITY;
      d[u] = -1;
      if (here) lanes.load(i, &d[u], &c[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = ls.lane_of(l0 + u * THREADS + tid);
      const bool ok = lane_valid(c[u], d[u], S);
      const int pos = sel::append_slot(s_fin, ok);
      if (ok) {
        atomicMin(&tab[d[u]], min_key(c[u], i));
        const unsigned t = kdtorch::total_order_key(c[u]);
        tlo = min(tlo, t);
        thi = max(thi, t);
        fin.put(pos, ((unsigned long long)__float_as_uint(c[u]) << 32) | (unsigned)d[u], i);
      }
    }
  }
  sel::mark_step(1);
  tlo = __reduce_min_sync(0xffffffffu, tlo);
  thi = __reduce_max_sync(0xffffffffu, thi);
  if ((tid & 31) == 0 && tlo <= thi) {
    atomicMin(&sh.mm[0], (unsigned long long)tlo);
    atomicMax(&sh.mm[1], (unsigned long long)thi);
  }
  sel::sync_blocks(C);  // every lane's atomicMin is done; every range is set
  sel::mark_step(2);

  // The first digit: keys from the cheapest cost's onwards, the cost
  // range (and the state bits below it) shifted into NB buckets.
  unsigned long long tmin, tmax;
  sel::cluster_min_max(sh, cluster, &tmin, &tmax);
  if (fin_total != nullptr && tid == 0) {
    int total = 0;
    for (int i = 0; i < C; ++i) total += *cluster.map_shared_rank(s_fin, i);
    *fin_total = total;
  }
  sel::Digit dig{0, 0};
  if (tmin <= tmax) {
    dig.base = tmin << 32;
    dig.shift = sel::digit_shift(0, ((tmax - tmin) << 32) | (unsigned)(S - 1));
  }
  sel::mark_step(3);

  // 2. Winners among the finite lanes: appended to the block's list,
  // counted by digit.
  const int nfin = *s_fin;
  for (int e0 = 0; e0 < nfin; e0 += THREADS * UNROLL) {
    unsigned long long f[UNROLL], w[UNROLL];
    int lane[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * THREADS + tid;
      f[u] = e >= nfin ? EMPTY : fin.key(e);
      lane[u] = e >= nfin ? -1 : fin.val(e);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) w[u] = f[u] != EMPTY ? tab[(unsigned)f[u]] : EMPTY;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const float c = __uint_as_float((unsigned)(f[u] >> 32));
      const int d = (int)(unsigned)f[u];
      const bool is_win = f[u] != EMPTY && w[u] == min_key(c, lane[u]);
      const int pos = sel::append_slot(&sh.count, is_win);
      int q = 0;
      if (is_win) {
        if (restore) tab[d] = EMPTY;
        const unsigned long long key =
            ((unsigned long long)kdtorch::total_order_key(c) << 32) | (unsigned)d;
        q = dig.of(key);
        win.put(pos, key, lane[u]);
      }
      sel::run_add(sh.hist, q, is_win);
    }
  }
  sel::mark_step(4);
  __syncthreads();
  sel::mark_step(5);

  // 3. The K smallest keys, in order.
  return sel::select_smallest<THREADS, SORT_CROWDED>(sh, cluster, win.entries(sh.count), keys0,
                                                     vals0, keys1, vals1, stage, stage_v,
                                                     stage_cap, tables, dig, K, emit);
}

}  // namespace dedup
}  // namespace kdtorch
