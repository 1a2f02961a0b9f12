// A row's reduce over its cluster of G blocks: the smallest (ordered
// cost, slot) key with that slot's cost bits, the finite and link counts
// and a changed bit, from every block's partials, in rank 0's warp 0.
//
// Used by the kernels that reduce a row's K frontier slots beside their
// copies: the eps step's shard mode (eps.cu), whose last iteration gives
// the frame's local values, and K3's shard first-frame mode (frame.cu),
// which gives K8's local half of the chunk's start state.  Either was a
// launch of its own before (the shard mode's reduce mode; K8's local
// half, csrc/cutoff.cu, a block a row), each some 0.003-0.005 ms on an
// H100 against a bound under 0.0002 ms (PERF.md): the reduce itself moves
// a few hundred bytes, so what bounds it is one cluster barrier and rank
// 0's wait for the stores.
//
// The design: each block reduces its partials over its warps (warp
// shuffles, then warp 0 over the warps' shared-memory slots) and stores
// them into rank 0's shared memory with st.async as two 16-byte stores,
// completing on rank 0's mbarrier (common.cuh:store_remote), once the
// cluster barrier's wait tells that rank 0 runs with its mbarrier set; no
// remote atomic (a 64-bit atomicMin on another block's shared memory lost
// updates at 8 blocks a row, PERF.md).  Rank 0's warp 0 waits on its
// mbarrier and reduces the G partials.  A key holds its slot, so one lane
// holds the smallest, and the first smallest in slot order is the same
// whatever the split: the key of a cost is common.cuh:ordered_key (-0.0
// and +0.0 one key, as torch's argmin compares them), so the row's first
// smallest in slot order keeps its own bits, whichever sign its zero has.
#pragma once

#include "common.cuh"

namespace kdtorch {
namespace rowred {

constexpr int MOST = 8;  // the most blocks a row

// A block's partials, stored into rank 0's shared memory as two 16-byte
// stores: its smallest (ordered cost, slot) key (~0: no finite cost) and
// that slot's cost bits, its finite and link counts, its changed bit.
struct __align__(16) Part {
  unsigned key_hi, key_lo, bits;
  int finite, links, changed, unused0, unused1;
};

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// A slot's key: its cost's ordered key above the slot.
__device__ __forceinline__ unsigned long long slot_key(float c, int k) {
  return (unsigned long long)ordered_key(c) << 32 | (unsigned)k;
}

// The shared memory of a row's reduce, in every block of blocks of WARPS
// warps.
template <int WARPS>
struct RowReduce {
  Part part[MOST];  // rank 0's: every block's partials
  uint64_t parts;   // rank 0's: complete when they have landed
  unsigned long long w_key[WARPS];
  unsigned w_bits[WARPS];
  int4 w_sums[WARPS];  // each warp's finite, links, changed
};

// The row's totals.
struct RowTotals {
  unsigned long long key;  // the smallest (ordered cost, slot); ~0: no finite cost
  unsigned bits;           // that slot's cost bits
  int finite, links;
  bool changed;
};

// Rank 0's thread 0, before the cluster barrier's arrive: the mbarrier
// that the G blocks' partials complete on.
template <int WARPS>
__device__ __forceinline__ void row_reduce_init(RowReduce<WARPS>& r, int G) {
  mbar_init(&r.parts, 1);
  mbar_arrive_expect_tx(&r.parts, G * (unsigned)sizeof(Part));
}

// Every thread of every block of the row, after the cluster barrier's
// arrive, with its partials (mn its smallest key, mbits that slot's bits):
// each warp's, then warp 0's over the warps, stored into rank 0's shared
// memory with st.async once the cluster barrier's wait tells that every
// block runs (rank 0's mbarrier is set); rank 0's warp 0 waits for them all
// and reduces them.  True in rank 0's warp 0, each lane then holding the
// row's totals in `t`.
template <int WARPS>
__device__ __forceinline__ bool row_reduce(RowReduce<WARPS>& r, int G, int rank,
                                           unsigned long long mn, unsigned mbits, int finite,
                                           int links, bool changed, RowTotals& t) {
  static_assert(WARPS <= 32, "a warp reduces the warps' partials");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long wm = warp_min(mn);
  const int wf = __reduce_add_sync(0xffffffffu, finite);
  const int wl = __reduce_add_sync(0xffffffffu, links);
  const int wc = (int)__reduce_or_sync(0xffffffffu, changed ? 1u : 0u);
  if (mn == wm && wm != ~0ull) r.w_bits[warp] = mbits;
  if (lane == 0) {
    r.w_key[warp] = wm;
    r.w_sums[warp] = make_int4(wf, wl, wc, 0);
  }
  __syncthreads();
  cluster_wait();  // every block runs: rank 0's mbarrier is set
  if (warp == 0) {
    const unsigned long long k = lane < WARPS ? r.w_key[lane] : ~0ull;
    const int4 v = lane < WARPS ? r.w_sums[lane] : make_int4(0, 0, 0, 0);
    const unsigned long long bm = warp_min(k);
    const int at = __ffs(__ballot_sync(0xffffffffu, k == bm)) - 1;
    const unsigned bits = __shfl_sync(0xffffffffu, lane < WARPS ? r.w_bits[lane] : 0u, at);
    const int bf = __reduce_add_sync(0xffffffffu, v.x);
    const int bl = __reduce_add_sync(0xffffffffu, v.y);
    const int bc = (int)__reduce_or_sync(0xffffffffu, (unsigned)v.z);
    int4* to = reinterpret_cast<int4*>(r.part + rank);
    if (lane == 0)
      store_remote(to, make_int4((int)(bm >> 32), (int)(unsigned)bm, (int)bits, bf), &r.parts, 0);
    if (lane == 1) store_remote(to + 1, make_int4(bl, bc, 0, 0), &r.parts, 0);
  }
  if (rank != 0 || warp != 0) return false;

  // Rank 0: the row's totals, from every block's partials.
  mbar_wait_cluster(&r.parts, 0);
  Part q{~0u, ~0u, 0u, 0, 0, 0, 0, 0};
  if (lane < G) q = r.part[lane];
  const unsigned long long key = (unsigned long long)q.key_hi << 32 | q.key_lo;
  const unsigned long long rm = warp_min(key);
  const int at = __ffs(__ballot_sync(0xffffffffu, key == rm)) - 1;
  t.key = rm;
  t.bits = __shfl_sync(0xffffffffu, q.bits, at);
  t.finite = __reduce_add_sync(0xffffffffu, q.finite);
  t.links = __reduce_add_sync(0xffffffffu, q.links);
  t.changed = __reduce_or_sync(0xffffffffu, (unsigned)q.changed) != 0;
  return true;
}

// The row's smallest finite cost from its totals: that slot's bits, +inf
// for none.
__device__ __forceinline__ float row_min(const RowTotals& t) {
  return t.key == ~0ull ? INFINITY : __uint_as_float(t.bits);
}

}  // namespace rowred
}  // namespace kdtorch
