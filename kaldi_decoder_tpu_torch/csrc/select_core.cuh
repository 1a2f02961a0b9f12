// The select core: the m smallest of n 64-bit keys, written in ascending
// order, by one thread block cluster (up to 8 blocks) per row.
//
// K6 (dedup.cu) calls it for the frontier by (cost, state); the lattice
// frame's K2 (dedup_rec.cu) calls it twice, for the frontier and for the
// records by slack.  Each key carries a 32-bit value (K6: the winning
// lane).  Keys need not be unique when the caller gives a tie order on
// the values of equal keys (`Tie`; K2's records): equal keys then rank by
// it.  Without one (`NoTie`), the keys of one row must be unique.
//
// The method is a most-significant-digit bucket select:
//   level 1  the caller gives each block its entries (in shared memory up
//            to a capacity, the rest in device memory) and, in sh.hist,
//            their histogram by a digit: a monotone function of the key
//            onto at most NB buckets, (key - base) >> shift (Digit) or the
//            caller's own (K2's records), built where the entries were
//            found.  The blocks' histograms are
//            merged through distributed shared memory: every block reads
//            all of them at once, so every block knows the bucket sizes,
//            their starts (an exclusive scan) and its own offset in each
//            bucket without another barrier.  The bucket b* holding the
//            m-th key is found; every entry of a bucket at or below b* is
//            scattered to its bucket's range in device memory (a counting
//            scatter: a shared-memory cursor per bucket, one add per run of
//            equal buckets in a warp), so buckets below b* hold the next
//            ranks and b* follows them.  After one cluster barrier each
//            block takes a contiguous 1/C of those places.  A place whose
//            bucket holds at most SORT_ABOVE keys gets the count of the
//            smaller keys of its bucket: the block brings the keys of the
//            buckets its places lie in to shared memory when they fit its
//            stage, crowded buckets left out, else counts in device
//            memory.  A bucket of more keys (a crowded one: K2's records
//            hold thousands of extras of one slack) is ranked whole by the
//            block that owns its first place, once every level is done
//            (a chain of them is kept in the spare buffer): sorted alone
//            by an LSD radix sort over the few bits in which its keys
//            differ (sort_bucket), in the stage or, where the stage does
//            not hold it, in device memory, then equal keys ordered by the
//            caller's tie order within their run (rank_crowded).  A rank
//            costs at most SORT_ABOVE compares or a share of a sort linear
//            in the bucket's size (runs of equal keys aside).  A caller
//            that cannot spare the sort's registers (SORT_CROWDED false:
//            K6, at 64 a thread) counts in crowded buckets too.
//   level 2+ only while b* holds more than half the stage (at least SMALL)
//            and not all of its keys are kept: b*'s keys are the
//            next input, with the digit taken
//            afresh from their own minimum and range (a cluster min/max),
//            so each level narrows the key range by about NB, until the
//            keys left are all equal.  When b* is small, kept whole or of
//            one key, it is ranked like the others and only ranks below m
//            emitted.
// No size limit: what does not fit in shared memory lives in device
// memory (two buffers of n per row, used in turns; a crowded bucket that
// the stage does not hold is sorted in its range of the spare one);
// shared memory holds four NB-bucket arrays, the sort's tables (9 KB,
// SortTables) and the caller's stage.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace kdtorch {
namespace select {

namespace cg = cooperative_groups;

constexpr int LOG_NB = 10;
constexpr int NB = 1 << LOG_NB;  // buckets of one digit
constexpr int SMALL = 256;       // a boundary bucket this small is ranked directly
constexpr int SORT_ABOVE = 128;  // a bucket of more keys is sorted (SORT_CROWDED), not counted
constexpr int MAX_CLUSTER = 8;
constexpr int SORT_BITS = 8;  // the widest digit of a pass of sort_bucket
constexpr int SORT_DIGITS = 1 << SORT_BITS;
constexpr int SORT_WARPS = 16;    // the most warps a block of the select has
constexpr int SORT_CHUNK = 4064;  // the most keys a warp takes in one tile of a pass
constexpr int HIGH_SLOTS = 64;    // distinct high halves sort_bucket ranks (a power of two)

struct Shared {
  alignas(16) int hist[NB];    // this block's entries per bucket (read by the cluster)
  alignas(16) int tot[NB];     // the cluster's entries per bucket
  alignas(16) int start[NB];   // exclusive prefix of tot
  alignas(16) int cursor[NB];  // this block's next position in each bucket
  unsigned long long mm[2];    // this block's smallest and largest input key
  int scan_tmp[32];
  int count;                   // entries appended by this block
  int bstar;
  int span[2];                 // the buckets' places this block ranks
  int qspan[2];                // and those buckets
  int ncrowd;                  // buckets of more than SORT_ABOVE keys this block sorts
};

// sort_bucket's tables, in the caller's dynamic shared memory (16-byte
// aligned): the keys' smallest and largest high and low halves, the next
// place of each digit, and each warp's count, then place, of each digit
// in a tile of the pass (16-bit: a tile gives a warp at most SORT_CHUNK
// keys).
struct SortTables {
  unsigned mm[4];  // min high, min low, max high, max low
  alignas(16) int digit_at[SORT_DIGITS];
  alignas(16) unsigned short row[SORT_WARPS][SORT_DIGITS];
  // The distinct high halves (open addressing; ~0ull is empty), the rank
  // of each among them, their count, and whether some found no slot.
  unsigned long long slot[HIGH_SLOTS];
  int slot_rank[HIGH_SLOTS];
  int distinct, full;
};

// A high half's slot in SortTables::slot, probed from here.
__device__ __forceinline__ int high_slot(unsigned h) { return (h * 0x9E3779B1u) >> 26; }

// One block's input entries: the first `cap` in shared memory (sk, sv),
// the rest at the same index in device memory (gk, gv); n in all.
struct Entries {
  const unsigned long long* sk;
  const int* sv;
  int cap;
  const unsigned long long* gk;
  const int* gv;
  int n;
  __device__ __forceinline__ unsigned long long key(int e) const {
    return e < cap ? sk[e] : gk[e];
  }
  __device__ __forceinline__ int val(int e) const { return e < cap ? sv[e] : gv[e]; }
};

// The SM clock at each of the caller's step marks (at most MARKS) of the
// last launch, taken by thread 0 of each of the grid's first 1024 blocks,
// and the global timer (ns) at the first and the last mark: what the
// caller's host side reads for the split of one call into its steps and
// for how the clusters spread in time.
constexpr int MARKED_BLOCKS = 1024;
constexpr int MARKS = 24;
namespace {
__device__ long long step_clock[MARKS * MARKED_BLOCKS];
__device__ unsigned long long block_ns[2 * MARKED_BLOCKS];

// The host side's read of this source file's marks after the last launch:
// the global timer at the start and end of each of the first `blocks`
// blocks (at most MARKED_BLOCKS) into ns[2 * blocks], the SM clock at their
// MARKS marks into clock[MARKS * blocks], and the SM's rated clock in kHz.
// Synchronises with the device; returns the CUDA error.
inline int read_marks(unsigned long long* ns, long long* clock, int* clock_khz, int blocks) {
  const int n = blocks < MARKED_BLOCKS ? blocks : MARKED_BLOCKS;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev);
  if (e == cudaSuccess) {
    e = cudaMemcpyFromSymbol(ns, block_ns, sizeof(unsigned long long) * 2 * n);
  }
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clock, step_clock, sizeof(long long) * MARKS * n);
  return (int)e;
}
}  // namespace
__device__ __forceinline__ void mark_step(int i, bool first = false, bool last = false) {
  if (threadIdx.x != 0 || blockIdx.x >= MARKED_BLOCKS) return;
  step_clock[MARKS * blockIdx.x + i] = clock64();
  if (first || last) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    block_ns[2 * blockIdx.x + last] = t;
  }
}

// A barrier of the cluster's blocks (of the block alone when C == 1, where
// __syncthreads orders shared and device memory for the block).
__device__ __forceinline__ void sync_blocks(int C) {
  if (C == 1) {
    __syncthreads();
  } else {
    cluster_sync();
  }
}

// Bits needed for x (0 for 0).
__device__ __forceinline__ int bit_length(unsigned long long x) { return 64 - __clzll(x); }

// The shift that maps keys in [lo, hi] onto at most NB buckets.
__device__ __forceinline__ int digit_shift(unsigned long long lo, unsigned long long hi) {
  return max(0, bit_length(hi - lo) - LOG_NB);
}

// The bucket of a key, (key - base) >> shift; the caller makes it below
// NB for every key it gives.
struct Digit {
  unsigned long long base;
  int shift;
  __device__ __forceinline__ int of(unsigned long long k) const {
    return (int)((k - base) >> shift);
  }
};

// No tie order: the keys of a row are unique.
struct NoTie {
  static constexpr bool on = false;
  __device__ bool operator()(int, int) const { return false; }
};

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// arr[bucket] += 1 for each active lane of the warp, aggregated over runs:
// the active lanes next to each other with the same bucket add once, by
// the run's first lane.  Candidates next to each other are mostly arcs of
// one frontier slot with close costs, so runs are common, and lanes that
// share a bucket otherwise serialise their adds; a run costs two
// shuffles and two ballots whatever its length (where __match_any_sync,
// tried first, grows with the number of distinct buckets).  Returns, for
// an active lane, arr[bucket]'s value before the warp's adds plus the
// lane's place in its run: a position, when arr is a cursor.  Every lane
// of the warp must call it.
__device__ __forceinline__ int run_add(int* arr, int bucket, bool active) {
  const int lane = threadIdx.x & 31;
  const unsigned act = __ballot_sync(0xffffffffu, active);
  if (act == 0) return 0;  // the whole warp idle
  const int key = active ? bucket : -1 - lane;  // an idle lane is a run of its own
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const bool head = active && (lane == 0 || prev != key);
  const unsigned heads = __ballot_sync(0xffffffffu, head);
  const unsigned breaks = heads | ~act;
  int first = 0;
  if (head) {
    const unsigned after = lane == 31 ? 0u : breaks & (0xffffffffu << (lane + 1));
    const int len = (after ? __ffs(after) - 1 : 32) - lane;
    first = atomicAdd(&arr[bucket], len);
  }
  const int h = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));  // this lane's run head
  return __shfl_sync(0xffffffffu, first, h & 31) + lane - h;
}

// A position in the block's append list for each active lane, one
// shared-memory add per warp.  Every lane of the warp must call it.
__device__ __forceinline__ int append_slot(int* count, bool active) {
  const unsigned act = __ballot_sync(0xffffffffu, active);
  if (act == 0) return 0;  // the whole warp idle
  int first = 0;
  if ((threadIdx.x & 31) == 0) first = atomicAdd(count, __popc(act));
  return __shfl_sync(0xffffffffu, first, 0) + __popc(act & lanemask_lt());
}

// The block of a cluster of C that owns the most of the places [s0, s0 +
// sn) when the places [0, end) are split into C contiguous ranges (the
// first of equals).
__device__ __forceinline__ int most_places_of(int s0, int sn, int end, int C) {
  int best = 0, most = -1;
  for (int r = 0; r < C; ++r) {
    const int lo = (int)((long)end * r / C), hi = (int)((long)end * (r + 1) / C);
    const int o = min(hi, s0 + sn) - max(lo, s0);
    if (o > most) {
      best = r;
      most = o;
    }
  }
  return best;
}

// The cluster's smallest mm[0] and largest mm[1] over every block's sh.mm
// (each block's own set before a cluster barrier that all have passed).
__device__ __forceinline__ void cluster_min_max(Shared& sh, cg::cluster_group& cluster,
                                                unsigned long long* lo, unsigned long long* hi) {
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  unsigned long long a[MAX_CLUSTER], z[MAX_CLUSTER];
#pragma unroll
  for (int i = 0; i < MAX_CLUSTER; ++i) {  // every load issued before any is used
    const unsigned long long* r = cluster.map_shared_rank(sh.mm, i < C ? i : rank);
    a[i] = r[0];
    z[i] = r[1];
  }
  *lo = a[0];
  *hi = z[0];
#pragma unroll
  for (int i = 1; i < MAX_CLUSTER; ++i) {
    *lo = min(*lo, a[i]);
    *hi = max(*hi, z[i]);
  }
}

// The active lanes of the warp whose d, of `bits` bits, equals this
// lane's: one ballot a bit (__match_any_sync's time grows with the number
// of distinct values).  Every lane of the warp must call it.
__device__ __forceinline__ unsigned same_digit(int d, int bits, bool active) {
  unsigned m = __ballot_sync(0xffffffffu, active);
  for (int i = 0; i < bits; ++i) {
    const unsigned ones = __ballot_sync(0xffffffffu, (d >> i) & 1);
    m &= (d >> i) & 1 ? ones : ~ones;
  }
  return m;
}

// The order of a crowded bucket: its n keys at keys[0, n) (shared or
// device memory) sorted by a least-significant-digit radix sort over the
// bits in which they differ, the high and the low halves apart (a
// bucket's keys often share a few high halves far apart, K2's slacks, and
// low halves close together, the states): high << lbits | (low - smallest
// low), lbits the bit length of the low halves' range, where high is the
// high half's rank among the distinct ones (when at most HIGH_SLOTS, found
// in a small hash table) or else its distance from the smallest, in the
// fewest passes of at most SORT_BITS bits.  A
// pass gives each warp a contiguous chunk of the keys: the warp counts
// its chunk's digits in its own row (the lanes of one digit add once,
// same_digit), a thread a digit turns the rows into each warp's
// place in the digit and the digits' totals into their first places (a
// block scan), and each warp scatters its chunk in order: stable, with
// three block barriers a pass (a tile of up to SORT_WARPS * SORT_CHUNK
// keys; past one tile, a histogram first).  Returns the indices 0..n-1
// in ascending key order, equal keys in index order, in a or b (each of
// n entries, 16-bit or 32-bit).  Every thread of the block calls it.
template <int THREADS, class P>
__device__ const P* sort_bucket(Shared& sh, SortTables& st, const unsigned long long* keys, int n,
                                P* a, P* b) {
  constexpr int W = THREADS / 32;
  constexpr int TILE = W * SORT_CHUNK;
  static_assert(W <= SORT_WARPS && SORT_DIGITS <= THREADS, "the sort's tables");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned h_lo = ~0u, l_lo = ~0u, h_hi = 0, l_hi = 0;
  for (int i = tid; i < n; i += THREADS) {
    const unsigned long long k = keys[i];
    h_lo = min(h_lo, (unsigned)(k >> 32));
    h_hi = max(h_hi, (unsigned)(k >> 32));
    l_lo = min(l_lo, (unsigned)k);
    l_hi = max(l_hi, (unsigned)k);
  }
  if (tid == 0) {
    st.mm[0] = st.mm[1] = ~0u;
    st.mm[2] = st.mm[3] = 0;
    st.full = 0;
  }
  if (tid < HIGH_SLOTS) st.slot[tid] = ~0ull;
  h_lo = __reduce_min_sync(0xffffffffu, h_lo);
  l_lo = __reduce_min_sync(0xffffffffu, l_lo);
  h_hi = __reduce_max_sync(0xffffffffu, h_hi);
  l_hi = __reduce_max_sync(0xffffffffu, l_hi);
  __syncthreads();
  if (lane == 0) {
    atomicMin(&st.mm[0], h_lo);
    atomicMin(&st.mm[1], l_lo);
    atomicMax(&st.mm[2], h_hi);
    atomicMax(&st.mm[3], l_hi);
  }
  __syncthreads();
  const unsigned h0 = st.mm[0], l0 = st.mm[1];
  const int lbits = bit_length(st.mm[3] - l0);
  int hbits = bit_length(st.mm[2] - h0);
  bool ranked = false;  // the high halves by their rank among the distinct ones
  if (hbits > 0) {
    for (int i = tid; i < n; i += THREADS) {
      const unsigned long long h = keys[i] >> 32;
      int s = high_slot((unsigned)h);
      for (int t = 0;; ++t) {
        if (t == HIGH_SLOTS) {
          st.full = 1;
          break;
        }
        unsigned long long cur = st.slot[s];
        if (cur == ~0ull) cur = atomicCAS(&st.slot[s], ~0ull, h);
        if (cur == ~0ull || cur == h) break;
        s = (s + 1) & (HIGH_SLOTS - 1);
      }
    }
    __syncthreads();
    if (warp == 0) {
      static_assert(HIGH_SLOTS == 64, "two slots a lane");
      const unsigned long long x = st.slot[lane], y = st.slot[lane + 32];
      int rx = 0, ry = 0;  // ~0ull, the empty slot, is above every high half
      for (int t = 0; t < 32; ++t) {
        const unsigned long long u = __shfl_sync(0xffffffffu, x, t);
        const unsigned long long v = __shfl_sync(0xffffffffu, y, t);
        rx += (u < x) + (v < x);
        ry += (u < y) + (v < y);
      }
      st.slot_rank[lane] = rx;
      st.slot_rank[lane + 32] = ry;
      const int d = __popc(__ballot_sync(0xffffffffu, x != ~0ull)) +
                    __popc(__ballot_sync(0xffffffffu, y != ~0ull));
      if (lane == 0) st.distinct = d;
    }
    __syncthreads();
    const int rbits = bit_length((unsigned long long)(st.distinct - 1));
    ranked = !st.full && rbits < hbits;
    if (ranked) hbits = rbits;
  }
  const int bits = hbits + lbits;
  const int passes = (bits + SORT_BITS - 1) / SORT_BITS;
  if (passes == 0) {  // all keys equal: index order
    for (int i = tid; i < n; i += THREADS) a[i] = (P)i;
    __syncthreads();
    return a;
  }
  const int width = (bits + passes - 1) / passes;
  const unsigned long long mask = (1ull << width) - 1;
  const bool tiles = n > TILE;  // the same for the whole block
  unsigned short* const row = st.row[warp];
  const P* src = nullptr;  // the first pass reads the keys in index order
  P* dst = a;
  for (int pass = 0; pass < passes; ++pass) {
    const int shift = pass * width;
    auto index = [&](int i) { return src == nullptr ? i : (int)src[i]; };
    auto digit = [&](int idx) {
      const unsigned long long k = keys[idx];
      unsigned h = (unsigned)(k >> 32) - h0;
      if (ranked) {
        int s = high_slot((unsigned)(k >> 32));
        while (st.slot[s] != k >> 32) s = (s + 1) & (HIGH_SLOTS - 1);
        h = st.slot_rank[s];
      }
      const unsigned long long c = (unsigned long long)h << lbits | ((unsigned)k - l0);
      return (int)((c >> shift) & mask);
    };
    if (tiles) {  // the digits' first places, before the first tile
      if (tid < SORT_DIGITS) st.digit_at[tid] = 0;
      __syncthreads();
      for (int i0 = 0; i0 < n; i0 += THREADS) {
        const bool act = i0 + tid < n;
        run_add(st.digit_at, act ? digit(index(i0 + tid)) : 0, act);
      }
      __syncthreads();
      int total;
      const int s = block_exclusive_scan(tid < SORT_DIGITS ? st.digit_at[tid] : 0, sh.scan_tmp,
                                         &total);
      if (tid < SORT_DIGITS) st.digit_at[tid] = s;
    }
    for (int t0 = 0; t0 < n; t0 += TILE) {
      const int tn = min(TILE, n - t0), ch = (tn + W - 1) / W;
      const int c_lo = t0 + min(tn, warp * ch), c_hi = t0 + min(tn, (warp + 1) * ch);
      for (int d = lane; d < SORT_DIGITS; d += 32) row[d] = 0;
      __syncwarp();
      for (int e0 = c_lo; e0 < c_hi; e0 += 32) {
        const bool act = e0 + lane < c_hi;
        const int d = act ? digit(index(e0 + lane)) : 0;
        const unsigned peers = same_digit(d, width, act);
        if (act && lane == __ffs(peers) - 1) row[d] += __popc(peers);
        __syncwarp();
      }
      __syncthreads();
      // Each warp's place in each digit, and the digits' first places.
      int run = 0;
      if (tid < SORT_DIGITS) {
        for (int w = 0; w < W; ++w) {
          const int c = st.row[w][tid];
          st.row[w][tid] = (unsigned short)run;
          run += c;
        }
      }
      if (!tiles) {
        int total;
        const int s = block_exclusive_scan(run, sh.scan_tmp, &total);
        if (tid < SORT_DIGITS) st.digit_at[tid] = s;
      }
      __syncthreads();
      for (int e0 = c_lo; e0 < c_hi; e0 += 32) {
        const bool act = e0 + lane < c_hi;
        const int idx = act ? index(e0 + lane) : 0;
        const int d = act ? digit(idx) : 0;
        const unsigned peers = same_digit(d, width, act);
        const int head = act ? __ffs(peers) - 1 : lane;
        int at = 0;
        if (act && lane == head) {
          at = st.digit_at[d] + row[d];
          row[d] += __popc(peers);
        }
        at = __shfl_sync(0xffffffffu, at, head);
        if (act) dst[at + __popc(peers & lanemask_lt())] = (P)idx;
        __syncwarp();
      }
      __syncthreads();  // the pass's output is complete, the rows free
      if (tiles && tid < SORT_DIGITS) st.digit_at[tid] += run;
    }
    src = dst;
    dst = dst == a ? b : a;
  }
  return src;
}

// Emits a sorted bucket: the key at sorted place j (keys[perm[j]], its
// value vals[perm[j]]) has rank rank0 + j and is emitted when j < limit.
// Equal keys (a run of them is in index order) are ordered by `tie`
// within their run, which is read only there: runs are short (K2: extras
// of one state at one slack).
template <int THREADS, class P, class Emit, class Tie>
__device__ __forceinline__ void emit_sorted(const unsigned long long* keys, const P* perm,
                                            const int* vals, int n, int rank0, int limit,
                                            Emit& emit, Tie& tie) {
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const int i = perm[j];
    const unsigned long long k = keys[i];
    int r = j;
    if constexpr (Tie::on) {
      int r0 = j, r1 = j + 1;
      while (r0 > 0 && keys[perm[r0 - 1]] == k) --r0;
      while (r1 < n && keys[perm[r1]] == k) ++r1;
      if (r1 - r0 > 1) {
        const int v = vals[i];
        r = r0;
        for (int t = r0; t < r1; ++t) r += tie(vals[perm[t]], v);
      }
    }
    if (r < limit) emit(rank0 + r, k, vals[i]);
  }
}

// Ranks a crowded bucket, its n keys and values at keys and vals in
// device memory: brings the keys to the stage when they fit (the sort's
// two 16-bit permutations in stage_v), else sorts them where they are
// (two 32-bit permutations in `scratch`, 2n ints), and emits them
// (emit_sorted).  Every thread of the block calls it, with the stage
// free.
template <int THREADS, class Emit, class Tie>
__device__ __forceinline__ void rank_crowded(Shared& sh, SortTables& st,
                                          const unsigned long long* keys, const int* vals, int n,
                                          unsigned long long* stage, int* stage_v, int stage_cap,
                                          int* scratch, int rank0, int limit, Emit& emit,
                                          Tie& tie) {
  if (n <= stage_cap) {
    for (int i = threadIdx.x; i < n; i += THREADS) stage[i] = keys[i];
    __syncthreads();
    unsigned short* pa = reinterpret_cast<unsigned short*>(stage_v);
    const unsigned short* perm = sort_bucket<THREADS>(sh, st, stage, n, pa, pa + stage_cap);
    emit_sorted<THREADS>(stage, perm, vals, n, rank0, limit, emit, tie);
  } else {
    const int* perm = sort_bucket<THREADS>(sh, st, keys, n, scratch, scratch + n);
    emit_sorted<THREADS>(keys, perm, vals, n, rank0, limit, emit, tie);
  }
}

// Every thread of every block of the cluster calls it, with the same
// arguments but its own `in` (level 1's entries).  Buffers are one row's,
// n entries each: keys0/vals0 and keys1/vals1, scratch used in turns;
// `stage` is shared memory for stage_cap keys and `stage_v` for as many
// ints (the sort's two 16-bit permutations; stage_cap at most 65536),
// free once the level-1 entries are scattered (they may hold them before);
// `tables` is shared memory for the sort's tables (SORT_CROWDED; else
// unused).
// sh.hist holds this block's histogram of `in` under `dig0` (a Digit or
// any type whose of(key) is monotone and below NB).  For each of the
// min(m, n) smallest keys, emit(rank, key, value) is called once, by
// some thread of the cluster.  Equal keys rank by tie(value_a, value_b)
// (true when a comes first; Tie::on false: no equal keys).  Level 1's
// steps are marked from mark0 on (a caller that selects twice in one
// launch marks each select apart).  Returns n, the cluster's number of
// entries.  Its last cluster barrier comes before the last level's
// ranks: no block reads another's shared memory after it, but the emits
// of other blocks may still be running.
template <int THREADS, bool SORT_CROWDED, class Emit, class Tie = NoTie, class Dig0 = Digit>
__device__ int select_smallest(Shared& sh, cg::cluster_group& cluster, Entries in,
                               unsigned long long* keys0, int* vals0,
                               unsigned long long* keys1, int* vals1,
                               unsigned long long* stage, int* stage_v, int stage_cap,
                               SortTables* tables, Dig0 dig0, int m, Emit emit, Tie tie = Tie(),
                               int mark0 = 6) {
  static_assert(NB % THREADS == 0, "whole buckets a thread");
  // A boundary bucket the stage holds twice over is ranked at once, not
  // split by further levels.
  const int whole = max(SMALL, stage_cap / 2);
  constexpr int BPT = NB / THREADS;
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  unsigned long long* out_k = keys1;
  int* out_v = vals1;
  unsigned long long* spare_k = keys0;
  int* spare_v = vals0;
  int lo = 0;    // rank of the first key of this level's input
  int need = 0;  // ranks this level still owes: min(m, n) - lo
  int n = 0;
  Digit dig{0, 0};  // the digit of levels 2+
  int crowd = -1;   // the last crowded bucket this block listed (place << 1 | level parity)
  int level = 0;
  for (;; ++level) {
    auto bucket = [&](unsigned long long k) { return level == 0 ? dig0.of(k) : dig.of(k); };
    bool flat = false;  // this level's keys are all equal
    if (level > 0) {
      // The input is the previous boundary bucket, split evenly: its own
      // key range gives the digit.
      unsigned long long kmin = ~0ull, kmax = 0;
      for (int e = tid; e < in.n; e += THREADS) {
        const unsigned long long k = in.key(e);
        kmin = min(kmin, k);
        kmax = max(kmax, k);
      }
      for (int o = 16; o > 0; o >>= 1) {
        kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
        kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
      }
      if (tid == 0) {
        sh.mm[0] = ~0ull;
        sh.mm[1] = 0;
      }
      __syncthreads();
      if ((tid & 31) == 0) {
        atomicMin(&sh.mm[0], kmin);
        atomicMax(&sh.mm[1], kmax);
      }
      for (int q = tid; q < NB; q += THREADS) sh.hist[q] = 0;
      sync_blocks(C);  // every block's min and max are in place
      unsigned long long lo_k, hi_k;
      cluster_min_max(sh, cluster, &lo_k, &hi_k);
      dig = Digit{lo_k, digit_shift(lo_k, hi_k)};
      flat = lo_k == hi_k;
      for (int e0 = 0; e0 < in.n; e0 += THREADS) {
        const int e = e0 + tid;
        const bool act = e < in.n;
        const int q = act ? bucket(in.key(e)) : 0;
        run_add(sh.hist, q, act);
      }
    }
    sync_blocks(C);  // every block's histogram is complete
    if (level == 0) mark_step(mark0);

    // Merge: the cluster's count per bucket, and this block's offset in
    // each bucket (the counts of the blocks before it); every block's
    // bins are read at once.
    int t[BPT], before[BPT], mine = 0;
#pragma unroll
    for (int q = 0; q < BPT; ++q) t[q] = before[q] = 0;
    // Every load of a group issued before any is used; two groups where
    // one would hold too many registers.
    constexpr int GROUP = BPT <= 2 ? MAX_CLUSTER : MAX_CLUSTER / 2;
#pragma unroll
    for (int half = 0; half < MAX_CLUSTER; half += GROUP) {
      int v[GROUP][BPT];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const int src = half + i < C ? half + i : rank;
        const int* h = cluster.map_shared_rank(sh.hist, src) + tid * BPT;
        if constexpr (BPT == 4) {
          const int4 x = *reinterpret_cast<const int4*>(h);
          v[i][0] = x.x;
          v[i][1] = x.y;
          v[i][2] = x.z;
          v[i][3] = x.w;
        } else if constexpr (BPT == 2) {
          const int2 x = *reinterpret_cast<const int2*>(h);
          v[i][0] = x.x;
          v[i][1] = x.y;
        } else {
#pragma unroll
          for (int q = 0; q < BPT; ++q) v[i][q] = h[q];
        }
      }
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
#pragma unroll
        for (int q = 0; q < BPT; ++q) {
          if (half + i < C) t[q] += v[i][q];
          if (half + i < rank) before[q] += v[i][q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < BPT; ++q) mine += t[q];
    if (tid == 0) sh.bstar = -1;  // before the scan's barriers, so no write of b* precedes it
    int total;
    int s = block_exclusive_scan(mine, sh.scan_tmp, &total);
    if (level == 0) {
      n = total;
      need = min(m, n);
    }
#pragma unroll
    for (int q = 0; q < BPT; ++q) {
      const int beta = tid * BPT + q;
      sh.tot[beta] = t[q];
      sh.start[beta] = s;
      sh.cursor[beta] = lo + s + before[q];
      if (need > 0 && s < need && need <= s + t[q]) sh.bstar = beta;
      s += t[q];
    }
    __syncthreads();
    if (level == 0) mark_step(mark0 + 1);
    const int bstar = sh.bstar;
    if (bstar < 0) {  // nothing to keep: n == 0 or m == 0
      sync_blocks(C);
      return n;
    }
    const int b0 = sh.start[bstar], bn = sh.tot[bstar];
    const bool last = bn <= whole || need == b0 + bn || flat;

    // Counting scatter of every entry at or below b*.
    for (int e0 = 0; e0 < in.n; e0 += THREADS) {
      const int e = e0 + tid;
      bool act = e < in.n;
      unsigned long long k = 0;
      int q = 0;
      if (act) {
        k = in.key(e);
        q = bucket(k);
        act = q <= bstar;
      }
      const int pos = run_add(sh.cursor, q, act);
      if (act) {
        out_k[pos] = k;
        out_v[pos] = in.val(e);
      }
    }
    if (level == 0) mark_step(mark0 + 2);
    sync_blocks(C);  // the scattered entries are visible to the cluster
    if (level == 0) mark_step(mark0 + 3);

    // The places below b* (and b*'s when it is the last level) are ranked
    // by the block that owns them, a contiguous 1/C of them.  A place in a
    // bucket of at most SORT_ABOVE keys gets the count of the smaller keys
    // of its bucket, from shared memory where the keys of the buckets this
    // block's places lie in fit in `stage` (they are brought there first,
    // the crowded buckets among them left out), else from device memory.
    // A bucket of more keys is ranked whole, once the levels are done
    // (rank_crowded), by the block that owns most of its places (the least
    // else to count: a block whose places lie mostly in crowded buckets
    // counts few).  Its size and the ranks it owes are kept in the spare
    // buffer's values at its place (free: a later level writes only past
    // b0), chained to the block's previous crowded bucket.
    const int end = b0 + (last ? bn : 0);
    const int p_lo = (int)((long)end * rank / C), p_hi = (int)((long)end * (rank + 1) / C);
    const bool owns = p_lo < p_hi;  // the same for the whole block
    if (tid == 0) {
      sh.ncrowd = 0;
      if (owns) {
        const int q0 = bucket(out_k[lo + p_lo]);
        const int q1 = bucket(out_k[lo + p_hi - 1]);
        sh.span[0] = sh.start[q0];
        sh.span[1] = sh.start[q1] + sh.tot[q1];
        sh.qspan[0] = q0;
        sh.qspan[1] = q1;
      }
    }
    __syncthreads();
    const int u_lo = sh.span[0], u_hi = sh.span[1];
    bool compact = false;  // the span holds crowded buckets, which the stage leaves out
    if (SORT_CROWDED && owns) {
      bool any = false;
      for (int q = sh.qspan[0] + tid; q <= sh.qspan[1]; q += THREADS) any |= sh.tot[q] > SORT_ABOVE;
      compact = __syncthreads_or(any);
    }
    int left_out = 0;  // the span's keys in crowded buckets
    if (compact) {
      // sh.hist (free since the merge): the keys of the span's crowded
      // buckets before each bucket; sh.cursor (free since the scatter): the
      // crowded buckets this block ranks.
      const int q0 = sh.qspan[0], nq = sh.qspan[1] - q0 + 1;
      int c[BPT], sum = 0;
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        const int j = tid * BPT + i;
        c[i] = j < nq && sh.tot[q0 + j] > SORT_ABOVE ? sh.tot[q0 + j] : 0;
        sum += c[i];
        if (c[i] > 0 && most_places_of(sh.start[q0 + j], c[i], end, C) == rank) {
          sh.cursor[atomicAdd(&sh.ncrowd, 1)] = q0 + j;
        }
      }
      int x = block_exclusive_scan(sum, sh.scan_tmp, &left_out);
#pragma unroll
      for (int i = 0; i < BPT; ++i) {
        if (tid * BPT + i < nq) sh.hist[q0 + tid * BPT + i] = x;
        x += c[i];
      }
      __syncthreads();
    }
    const bool staged = owns && u_hi - u_lo - left_out <= stage_cap;
    if (staged) {
      for (int j = u_lo + tid; j < u_hi; j += THREADS) {
        const unsigned long long k = out_k[lo + j];
        if (!compact) {
          stage[j - u_lo] = k;
        } else {
          const int q = bucket(k);
          if (sh.tot[q] <= SORT_ABOVE) stage[j - u_lo - sh.hist[q]] = k;
        }
      }
    }
    __syncthreads();
    if (staged) {
      // Place p's key, from the stage or (compact) device memory, and its
      // bucket's keys in the stage.
      for (int p = p_lo + tid; p < p_hi; p += THREADS) {
        const unsigned long long k = compact ? out_k[lo + p] : stage[p - u_lo];
        const int q = bucket(k);
        const int s0 = sh.start[q], sn = sh.tot[q];
        if (SORT_CROWDED && sn > SORT_ABOVE) continue;  // ranked by its owner's sort
        const int v = out_v[lo + p];
        const unsigned long long* seg = stage + (s0 - u_lo - (compact ? sh.hist[q] : 0));
        int r = 0;
        if constexpr (Tie::on) {
          for (int j = 0; j < sn; ++j) {
            const unsigned long long y = seg[j];
            r += y < k || (y == k && tie(out_v[lo + s0 + j], v));
          }
        } else {
#pragma unroll 4
          for (int j = 0; j < sn; ++j) r += seg[j] < k;
        }
        if (s0 + r < need) emit(lo + s0 + r, k, v);
      }
    } else if (owns) {
      for (int p = p_lo + tid; p < p_hi; p += THREADS) {
        const unsigned long long k = out_k[lo + p];
        const int q = bucket(k);
        const int s0 = sh.start[q], sn = sh.tot[q];
        if (SORT_CROWDED && sn > SORT_ABOVE) continue;  // ranked by its owner's sort
        const int v = out_v[lo + p];
        const unsigned long long* seg = out_k + lo + s0;
        int r = 0;
#pragma unroll 8
        for (int j = 0; j < sn; ++j) {
          const unsigned long long y = seg[j];
          if constexpr (Tie::on) {
            r += y < k || (y == k && tie(out_v[lo + s0 + j], v));
          } else {
            r += y < k;
          }
        }
        if (s0 + r < need) emit(lo + s0 + r, k, v);
      }
    }
    const int ncrowd = compact ? sh.ncrowd : 0;
    for (int c = 0; c < ncrowd; ++c) {
      const int q = sh.cursor[c];
      const int s0 = sh.start[q], sn = sh.tot[q];
      const int at = lo + s0;
      if (tid == 0) {
        spare_v[at] = crowd;
        spare_v[at + 1] = sn;
        spare_v[at + 2] = need - s0;
      }
      crowd = at << 1 | (level & 1);
    }
    if (last) break;  // ended on the scatter's barrier

    // The boundary bucket is the next level's input, in the buffer it was
    // scattered to, split evenly; the other buffer takes the next scatter.
    lo += b0;
    need -= b0;
    const int split0 = (int)((long)bn * rank / C), split1 = (int)((long)bn * (rank + 1) / C);
    in = Entries{nullptr, nullptr, 0, out_k + lo + split0, out_v + lo + split0, split1 - split0};
    unsigned long long* tk = out_k;
    int* tv = out_v;
    out_k = spare_k;
    out_v = spare_v;
    spare_k = tk;
    spare_v = tv;
  }
  // The crowded buckets this block ranks, the last listed first: a
  // level of the last one's parity scattered to out_k/out_v, the others to
  // spare_k/spare_v.
  if constexpr (SORT_CROWDED) {
    for (int h = crowd; h >= 0;) {
      __syncthreads();  // the chain is visible; the stage is free
      const int at = h >> 1;
      const bool now = (h & 1) == (level & 1);  // scattered to out_k/out_v
      const int* e = (now ? spare_v : out_v) + at;
      const int next = e[0], sn = e[1], limit = e[2];
      rank_crowded<THREADS>(sh, *tables, (now ? out_k : spare_k) + at,
                            (now ? out_v : spare_v) + at, sn, stage, stage_v, stage_cap,
                            reinterpret_cast<int*>((now ? spare_k : out_k) + at), at, limit,
                            emit, tie);
      h = next;
    }
  }
  mark_step(mark0 + 4);  // the ranks: the first level's, any later level's and the sorts
  return n;
}

}  // namespace select
}  // namespace kdtorch
