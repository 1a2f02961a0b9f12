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
//            block takes a contiguous 1/C of those places, brings the keys
//            of the buckets they lie in to shared memory, and each thread
//            counts the smaller keys of its place's bucket: its rank, which
//            the caller's `emit` writes; the count grows with the square of
//            a bucket's size.  A block whose staged buckets hold one of
//            more than SORT_ABOVE keys sorts them instead (keys and their
//            places, a bitonic sort in shared memory): a key's rank is then
//            its index in the sorted stage.  (Where those buckets do not
//            fit, a warp takes 32 places at a time, reads their buckets'
//            keys once from device memory and compares through shuffles.)
//   level 2+ only while b* holds more than half the stage (at least SMALL)
//            and not all of its keys are kept: b*'s keys are the
//            next input, with the digit taken
//            afresh from their own minimum and range (a cluster min/max),
//            so each level narrows the key range by about NB, until the
//            keys left are all equal.  When b* is small, kept whole or of
//            one key, it is ranked like the others and only ranks below m
//            emitted.
// No size limit: what does not fit in shared memory lives in device
// memory (two buffers of n per row, used in turns); shared memory holds
// four NB-bucket arrays and the caller's stage.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace kdtorch {
namespace select {

namespace cg = cooperative_groups;

constexpr int LOG_NB = 10;
constexpr int NB = 1 << LOG_NB;  // buckets of one digit
constexpr int SMALL = 256;       // a boundary bucket this small is ranked directly
constexpr int SORT_ABOVE = 128;  // a block sorts its stage when one of its buckets is larger
constexpr int MAX_CLUSTER = 8;

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
};

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

// Every thread of every block of the cluster calls it, with the same
// arguments but its own `in` (level 1's entries).  Buffers are one row's,
// n entries each: keys0/vals0 and keys1/vals1, scratch used in turns;
// `stage` is shared memory for stage_cap keys and `stage_v` for as many
// ints (stage_cap a power of two, for the sort), free once the level-1
// entries are scattered (they may hold them before).
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
template <int THREADS, class Emit, class Tie = NoTie, class Dig0 = Digit>
__device__ int select_smallest(Shared& sh, cg::cluster_group& cluster, Entries in,
                               unsigned long long* keys0, int* vals0,
                               unsigned long long* keys1, int* vals1,
                               unsigned long long* stage, int* stage_v, int stage_cap,
                               Dig0 dig0, int m, Emit emit, Tie tie = Tie(), int mark0 = 6) {
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
  for (int level = 0;; ++level) {
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
    // by the block that owns them, a contiguous 1/C of them.  Where the
    // keys of the buckets they lie in fit in `stage`, they are brought
    // there first and each thread counts the smaller keys of its place's
    // bucket in shared memory; else a warp takes 32 places at a time, reads
    // every key of their buckets once from device memory and compares
    // through shuffles.
    const int end = b0 + (last ? bn : 0);
    const int p_lo = (int)((long)end * rank / C), p_hi = (int)((long)end * (rank + 1) / C);
    if (tid == 0 && p_lo < p_hi) {
      const int q0 = bucket(out_k[lo + p_lo]);
      const int q1 = bucket(out_k[lo + p_hi - 1]);
      sh.span[0] = sh.start[q0];
      sh.span[1] = sh.start[q1] + sh.tot[q1];
      sh.qspan[0] = q0;
      sh.qspan[1] = q1;
    }
    __syncthreads();
    const int u_lo = sh.span[0], u_hi = sh.span[1];
    bool sort = false;
    if (p_lo < p_hi && u_hi - u_lo <= stage_cap) {  // the same for the whole block
      bool over = false;
      for (int q = sh.qspan[0] + tid; q <= sh.qspan[1]; q += THREADS) over |= sh.tot[q] > SORT_ABOVE;
      sort = __syncthreads_or(over);
    }
    if (sort) {
      // The staged buckets sorted by (key, tie), padded with all-ones keys
      // to a power of two P, each key with its place: the key at j of the
      // sorted stage has rank lo + u_lo + j, and this block emits it when
      // its place is one of this block's (as the count does, so blocks
      // that share a bucket may sort or count).  Each thread takes pairs
      // (i, i + jj) of a step.
      const int un = u_hi - u_lo;
      int P = 1;
      while (P < un) P <<= 1;
      for (int j = tid; j < P; j += THREADS) {
        stage[j] = j < un ? out_k[lo + u_lo + j] : ~0ull;
        stage_v[j] = j < un ? j : -1;
      }
      __syncthreads();
      for (int k2 = 2; k2 <= P; k2 <<= 1) {
        for (int jj = k2 >> 1; jj > 0; jj >>= 1) {
          const int lg = __ffs(jj) - 1;  // jj is a power of two
          for (int t = tid; t < P / 2; t += THREADS) {
            const int i = ((t >> lg) << (lg + 1)) | (t & (jj - 1));
            const unsigned long long ka = stage[i], kb = stage[i + jj];
            const int pa = stage_v[i], pb = stage_v[i + jj];
            bool b_first = kb < ka;  // does the key at i + jj come before the one at i?
            if constexpr (Tie::on) {
              if (ka == kb && ka != ~0ull) b_first = tie(out_v[lo + u_lo + pb], out_v[lo + u_lo + pa]);
            }
            if (b_first == ((i & k2) == 0)) {
              stage[i] = kb;
              stage[i + jj] = ka;
              stage_v[i] = pb;
              stage_v[i + jj] = pa;
            }
          }
          __syncthreads();
        }
      }
      for (int j = tid; j < un; j += THREADS) {
        const int p = u_lo + stage_v[j];
        if (p >= p_lo && p < p_hi && u_lo + j < need) emit(lo + u_lo + j, stage[j], out_v[lo + p]);
      }
    } else if (p_lo < p_hi && u_hi - u_lo <= stage_cap) {
      for (int j = tid; j < u_hi - u_lo; j += THREADS) stage[j] = out_k[lo + u_lo + j];
      __syncthreads();
      for (int p = p_lo + tid; p < p_hi; p += THREADS) {
        const unsigned long long k = stage[p - u_lo];
        const int v = out_v[lo + p];
        const int q = bucket(k);
        const int s0 = sh.start[q], sn = sh.tot[q];
        const unsigned long long* seg = stage + (s0 - u_lo);
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
    } else {
      constexpr int W = THREADS / 32;
      const int lane = tid & 31;
      for (int p0 = p_lo + (tid >> 5) * 32; p0 < p_hi; p0 += W * 32) {
        const int p = p0 + lane;
        const bool act = p < p_hi;
        const unsigned long long k = act ? out_k[lo + p] : 0;
        const int v = act ? out_v[lo + p] : 0;
        const int q = act ? bucket(k) : 0;
        const int s0 = act ? sh.start[q] : 0x7fffffff;
        const int s1 = act ? s0 + sh.tot[q] : 0;
        const int u0 = __reduce_min_sync(0xffffffffu, s0);
        const int u1 = __reduce_max_sync(0xffffffffu, s1);
        int r = 0;
        for (int j0 = u0; j0 < u1; j0 += 32) {
          const bool in_row = j0 + lane < u1;
          const unsigned long long yj = in_row ? out_k[lo + j0 + lane] : ~0ull;
          if constexpr (Tie::on) {
            const int vj = in_row ? out_v[lo + j0 + lane] : 0;
            for (int t = 0; t < 32; ++t) {
              const unsigned long long yt = __shfl_sync(0xffffffffu, yj, t);
              const int vt = __shfl_sync(0xffffffffu, vj, t);
              const int jt = j0 + t;
              if (jt >= s0 && jt < s1) r += yt < k || (yt == k && tie(vt, v));
            }
          } else {
#pragma unroll 8
            for (int t = 0; t < 32; ++t) {
              const unsigned long long yt = __shfl_sync(0xffffffffu, yj, t);
              const int jt = j0 + t;
              r += (jt >= s0) & (jt < s1) & (yt < k);
            }
          }
        }
        if (act && s0 + r < need) emit(lo + s0 + r, k, v);
      }
    }
    if (level == 0) mark_step(mark0 + 4);
    if (last) return n;  // ended on the scatter's barrier

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
}

}  // namespace select
}  // namespace kdtorch
