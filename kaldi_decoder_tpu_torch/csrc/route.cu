// K7: the shard route, its send side (kd_route_send) and its receive side
// (kd_route_recv).
//
// Replaces the XLA-compiled region of the JAX package's sharded frame
// kaldi_decoder_tpu/parallel/graph_shard.py:213 _route (per row a 3-key
// lax.sort by (owner, local state, cost), two associative_scans and a
// scatter into the (P, cap) send buffer, under shard_map), with what the
// frame applies to the lanes before it: the global beam filter of the
// emitting call (cost < cutoff, else +inf) and the payload's global
// offsets (slot + slot_add, or slot_states[slot] + slot_add; arc +
// arc_add).  The receive side replaces the reshape after the all_to_all
// of the emitting call.  On an eps iteration the dedup call reads the
// received buffer and the K incumbents in place (common.cuh:routed_entry,
// the concatenation of graph_shard.py:395-398 as a map), so the receive
// side has no launch there.  Plain versions: kaldi_decoder_tpu_torch/kernels/
// route.py route_send_plain and route_recv_plain; every output is bitwise
// equal to theirs (a float is only compared, copied, or subtracted once
// in the lattice slack test, c - run_min, round to nearest, as plain).
//
// What bounds them: bytes.  The send side reads each lane's destination
// and cost, the kept lanes' payload, and writes the whole (P, B, cap, 4)
// int32 send buffer: at the emitting shard shape (B 16, N 30,720, cap
// 30,720) about 12 MB at P = 1 and 20 MB a rank at P = 2, 0.004-0.006 ms
// at 3.35 TB/s.  The receive side reads that buffer and writes four int32
// or float columns of the same lanes.
//
// The send side's design: a cluster of G blocks of 1024 threads a row
// (G = 8, 4, 2 or 1: the largest that fits, at most one block per
// MIN_LANES lanes; 8 at the emitting shard shape, 4 at the eps shape).
// Block r takes lanes and sorted positions [r*C, (r+1)*C), C = ceil(N /
// G).  Its arrays live in its own shared memory when C <= SMEM_LANES (the
// others' reached by DSMEM), else in the row's device scratch, which L2
// holds.  No step's work grows with the length of a run (a thread's
// search for its first run's head takes log2 of it):
//   1. Each warp counts the valid lanes of its segment (finite cost under
//      the cutoff, destination in [0, P*Sp)), 32 lanes a round, coalesced;
//      a scan of the warps' counts places them, and each warp writes them
//      in lane order, a ballot a round: as (destination << 32 | lane) on a
//      leaders-only call, as (cost key << 32 | lane) on a lattice call
//      (common.cuh:ordered_key, -0.0 and +0.0 one key), whose block keeps
//      the least and the largest key.
//   2. A stable LSD radix sort.  A lattice call first sorts on the cost
//      key: 8 bits a pass, as many passes as the bits in which the row's
//      least and largest keys differ (the cluster's least and largest are
//      read in the first pass's exchange); its last key pass turns each
//      element into (destination << 32 | lane).  Then both calls sort on
//      the destination's bits alone: ceil(log2(P*Sp)) of them, from the
//      call's shape (17 at the shard shapes), in ceil(bits / 8) passes of
//      equal digits (3 of 6 bits).  So a lattice call's order is (owner,
//      state, cost key, lane) and a leaders-only call's (owner, state,
//      lane).  A pass: each warp counts the digits of its contiguous share
//      of the block's elements in its own column of shared memory, a warp
//      a digit scans the 32 warps' counts, the block's digit totals go
//      through DSMEM to the cluster (one cluster barrier), every block
//      takes its places from them, and each warp scatters its share in
//      order, 32 at a time (a digit's lanes ranked by one ballot a digit
//      bit, four rounds' loads in flight), into the owning block's next
//      buffer (a second cluster barrier).  The last pass also writes each
//      position's cost key.
//   3. Each thread takes a contiguous share of the block's positions.  Its
//      first position's (owner, state) run begins where a search back
//      from it (steps of 1, 2, 4, ..., then halving) finds the destination
//      change; a later position begins a run where its destination differs
//      from the one before.  A lattice call's run is in (cost key, lane)
//      order, so its head holds the run's least cost, a position's rank is
//      its distance from the head, and the lanes within the slack of the
//      head's cost (on the canonical costs, which answer the test as the
//      lanes' own bits do) are a prefix of the run.
//      A leaders-only call keeps each run's least (cost key, lane): a
//      thread takes the least of each piece of a run it holds and stores
//      it at the run's head when it holds the whole run; else, after the
//      warp's pieces of the same run are reduced (__match_any_sync, __reduce_min_sync), it takes it into
//      its own block's shared memory with a 64-bit atomic minimum, at the
//      run's head or, for the run that entered the block from the one
//      before, into the block's entering slot.  No block writes another's
//      shared memory (remote 64-bit atomic minima lost updates on the
//      card).  Each run counts once, at its head.  The kept lanes before a
//      run are one block scan of the threads' counts plus the earlier
//      blocks' totals; each owner's kept lanes are summed in a thread while
//      the owner holds, then over a warp (__reduce_add_sync) and the
//      cluster (one cluster barrier for both).
//   4. A leaders-only call's run least is its head block's piece and, while
//      the run is the last of its block and goes on, the entering pieces
//      of the blocks after it (read across the cluster after the barrier).
//      Kept lanes under cap are written with their payload (a thread's
//      next four positions' loads issued before their stores) at the kept
//      lanes before their run in the owner plus their rank; the rest of
//      each owner's bucket gets the fill [0, INF_BITS, 0, NO_ARC], shared
//      by the cluster's blocks, so no byte of the buffer is written twice;
//      an owner with more kept lanes than cap flags the row.
// Blocks hand data to each other behind cluster barriers, not by st.async
// onto an mbarrier: a pass's totals are read by every block and its
// scatter lands anywhere in the cluster (PERF.md: what that costs).  The
// receive side: one thread an output lane.

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int DIGITS = 256;       // the most digits of a pass (8 bits)
constexpr int MAX_PARTS = 64;     // kernels/route.py MAX_PARTS
constexpr int MIN_LANES = 768;    // kernels/route.py MIN_LANES: the fewest lanes a block takes
constexpr int SMEM_LANES = 7936;  // kernels/route.py SMEM_LANES: the most lanes a block keeps
                                  // in shared memory
constexpr int LANE_BYTES = 24;    // a position's two elements (in turns), cost key and kept count
constexpr size_t COUNT_BYTES = (size_t)DIGITS * (WARPS + 1) * sizeof(int);
constexpr int UNROLL = 4;         // rounds of 32 elements a warp loads before it scatters them
constexpr int WRITES = 4;         // kept lanes a thread loads before it writes them
constexpr int INF_BITS = 0x7f800000;
constexpr int NO_ARC = -1;
constexpr int RECV_THREADS = 256;

// K7 send's step marks: the global timer (ns) at each, by thread 0 of
// block 0 of the first MARKED rows' clusters: 0-6 the start and the ends
// of the compaction, the sort, the runs and kept counts, the kept counts'
// exchange, the writes and the fill; 7 + 3p.. the ends of pass p's count,
// its totals' exchange and its scatter; then the row's valid lanes, its
// sort passes and of them the cost key's.  Built only with KD_STEP_MARKS
// (scripts/profile_torch_k7_steps.py).
#ifdef KD_STEP_MARKS
constexpr int MARKED = 16;
constexpr int STEP_MARKS = 7 + 3 * 8;
__device__ unsigned long long k7_marks[MARKED][STEP_MARKS + 3];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K7_MARK(i) \
  if (tid == 0 && rank == 0 && b < MARKED) k7_marks[b][i] = globaltimer()
#define K7_NOTE(i, v) \
  if (tid == 0 && rank == 0 && b < MARKED) k7_marks[b][STEP_MARKS + (i)] = (v)
#else
#define K7_MARK(i)
#define K7_NOTE(i, v)
#endif

struct SendArgs {
  const int* dst;                // (B, N) global destination states
  const float* cost;             // (B, N)
  const int* src;                // (B, N) the payload's slot, or a slot of slot_states
  const int* arc;                // (B, N)
  const float* cutoff;           // (B,) or null
  const int* slot_states;        // (B, K) or null
  int B, N, K, sp, P, cap, slot_add, arc_add, lattice;
  float slack;
  int C;                         // lanes and sorted positions a block takes
  int passes, bits;              // the sort's passes over the destination, bits a pass
  unsigned long long* elems[2];  // (B, N) each: the sort's buffers, in device scratch
  unsigned* ckey;                // (B, N) each position's cost key
  int* kept;                     // (B, N) the kept lanes before a position, in its block
  int4* send;                    // (P, B, cap)
  unsigned char* overflow;       // (B,)
};

__device__ __forceinline__ unsigned lanemask_lt() { return (1u << (threadIdx.x & 31)) - 1u; }

// The row's arrays, by sorted position: in shared memory, block q's chunk
// [q*C, (q+1)*C) in block q's (its own directly, the others' by DSMEM);
// else the row's scratch in device memory.
template <bool SMEM>
struct RowArrays {
  cg::cluster_group cluster;
  int C, rank;
  template <typename T>
  __device__ __forceinline__ T* at(T* base, int pos) const {
    if (!SMEM) return base + pos;
    const int off = pos - rank * C;
    if ((unsigned)off < (unsigned)C) return base + off;
    const int q = pos / C;
    return cluster.map_shared_rank(const_cast<std::remove_const_t<T>*>(base + (pos - q * C)), q);
  }
  // This block's chunk.
  template <typename T>
  __device__ __forceinline__ T* mine(T* base) const {
    return SMEM ? base : base + (size_t)rank * C;
  }
};

// The lanes of the warp whose digit (of `bits` bits) and activity are
// this lane's: one ballot a bit, as a multisplit ranks a warp's keys.
__device__ __forceinline__ unsigned same_digit(int dg, int bits, bool act) {
  const unsigned on = __ballot_sync(0xffffffffu, act);
  unsigned peers = act ? on : ~on;
  for (int i = 0; i < bits; ++i) {
    const bool set = (dg >> i) & 1;
    const unsigned v = __ballot_sync(0xffffffffu, set);
    peers &= set ? v : ~v;
  }
  return peers;
}

// Thread tid's contiguous share [x, y) of n items.
__device__ __forceinline__ int2 thread_share(int n, int tid) {
  const int e = (n + THREADS - 1) / THREADS;
  return make_int2(min(n, tid * e), min(n, (tid + 1) * e));
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) route_send_kernel(SendArgs a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  int(*cnt)[WARPS + 1] = reinterpret_cast<int(*)[WARPS + 1]>(dyn);  // [digit][warp], padded
  __shared__ int smem[32];
  __shared__ int s_tot[DIGITS];        // this block's count of each digit (the cluster reads it)
  __shared__ int s_first[DIGITS];      // each digit's first place in this block's share
  __shared__ int s_own[MAX_PARTS];     // this block's kept lanes of each owner (read likewise)
  __shared__ int s_kept;               // this block's kept lanes (likewise)
  __shared__ unsigned s_key[2];        // this block's least and largest cost key (likewise)
  __shared__ unsigned long long s_enter;  // leaders: the least (key, position) of the run that
                                          // entered this block from the one before (likewise)
  __shared__ int s_last_head;          // leaders: this block's last run head, or -1 (likewise)
  __shared__ int s_warp[WARPS];        // the warps' valid lanes, then their first places
  __shared__ int s_n;                  // this block's valid lanes
  __shared__ int s_kpasses;            // lattice: the sort's passes on the cost key
  __shared__ int s_owner_kept[MAX_PARTS];  // the row's kept lanes of each owner
  __shared__ int s_owner_base[MAX_PARTS];  // the row's kept lanes of the owners before each
  __shared__ int s_block_base[8];          // the kept lanes of the blocks before each

  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / G, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * a.N;
  const int C = a.C;
  const bool lattice = a.lattice != 0;
  const RowArrays<SMEM> arr{cluster, C, rank};
  unsigned long long* E[2];
  unsigned* CK;
  int* KX;
  if (SMEM) {
    E[0] = reinterpret_cast<unsigned long long*>(dyn + COUNT_BYTES);
    E[1] = E[0] + C;
    CK = reinterpret_cast<unsigned*>(E[1] + C);
    KX = reinterpret_cast<int*>(CK + C);
  } else {
    E[0] = a.elems[0] + row;
    E[1] = a.elems[1] + row;
    CK = a.ckey + row;
    KX = a.kept + row;
  }
  const int l0 = rank * C, l1 = min(a.N, l0 + C);
  if (tid < MAX_PARTS) s_own[tid] = 0;
  if (tid == 0) {
    s_key[0] = 0xffffffffu;
    s_key[1] = 0u;
    s_enter = ~0ull;
    s_last_head = -1;
  }
  K7_MARK(0);

  // 1. This block's valid lanes in lane order: each warp takes a
  // contiguous segment, 32 lanes a round (coalesced), counts its valid
  // lanes, one block scan of the warps' counts places them, and the warp
  // writes them in order (a ballot ranks a round's lanes).
  const unsigned limit = (unsigned)(a.P * a.sp);
  const float cut = a.cutoff != nullptr ? a.cutoff[b] : INFINITY;
  const int* dst = a.dst + row;
  const float* cost = a.cost + row;
  int m = 0;  // the elements this block holds
  {
    const int len = max(0, l1 - l0);
    const int w0 = l0 + (int)((long long)len * warp / WARPS);
    const int w1 = l0 + (int)((long long)len * (warp + 1) / WARPS);
    auto valid = [&](int i, unsigned* d, float* c) {
      if (i >= w1) return false;
      *c = __ldg(cost + i);
      *d = (unsigned)__ldg(dst + i);
      return isfinite(*c) && *c < cut && *d < limit;
    };
    int count = 0;
#pragma unroll 4
    for (int i = w0 + lane; i - lane < w1; i += 32) {
      unsigned d;
      float c;
      count += __popc(__ballot_sync(0xffffffffu, valid(i, &d, &c)));
    }
    if (lane == 0) s_warp[warp] = count;
    __syncthreads();
    int at = 0;
    if (warp == 0) {
      const int v = s_warp[lane];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      s_warp[lane] = x - v;
      if (lane == 31) s_n = x;
    }
    __syncthreads();
    at = s_warp[warp];
    m = s_n;
    unsigned long long* out = arr.mine(E[0]);
    unsigned lo = 0xffffffffu, hi = 0u;  // this thread's least and largest cost key
#pragma unroll 4
    for (int i = w0 + lane; i - lane < w1; i += 32) {
      unsigned d;
      float c;
      const bool v = valid(i, &d, &c);
      const unsigned ball = __ballot_sync(0xffffffffu, v);
      if (v) {
        unsigned hi32 = d;
        if (lattice) {
          hi32 = kdtorch::ordered_key(c);
          lo = min(lo, hi32);
          hi = max(hi, hi32);
        }
        out[at + __popc(ball & lanemask_lt())] = (unsigned long long)hi32 << 32 | (unsigned)i;
      }
      at += __popc(ball);
    }
    if (lattice) {
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        atomicMin(&s_key[0], lo);
        atomicMax(&s_key[1], hi);
      }
    }
  }
  __syncthreads();  // the first pass reads what other threads wrote
  K7_MARK(1);

  // 2. The stable LSD radix sort: a lattice call's cost key (8 bits a
  // pass, as many passes as the cluster's keys need: settled in the first
  // pass), then the destination.
  int kpasses = lattice ? 4 : 0;
  int passes = kpasses + a.passes;
  int n = 0, cur = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const bool keyp = pass < kpasses;
    const int bits = keyp ? 8 : a.bits;
    const int shift = 32 + (keyp ? pass * 8 : (pass - kpasses) * a.bits);
    const int ndig = 1 << bits;
    const unsigned mask = (unsigned)ndig - 1u;
    const unsigned long long* src = arr.mine(E[cur]);
    unsigned long long* to = E[cur ^ 1];
    const int lo = (int)((long long)m * warp / WARPS);
    const int hi = (int)((long long)m * (warp + 1) / WARPS);
    for (int dg = lane; dg < ndig; dg += 32) cnt[dg][warp] = 0;
    __syncwarp();
    for (int j = lo + lane; j < hi; j += 32)
      atomicAdd(&cnt[(unsigned)(src[j] >> shift) & mask][warp], 1);
    __syncthreads();
    // Each warp turns its digits' counts into the warps' places (a warp
    // scan over the 32 warps' counts) and the digits' totals.
    for (int dg = warp; dg < ndig; dg += WARPS) {
      const int v = cnt[dg][lane];
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      cnt[dg][lane] = x - v;
      if (lane == 31) s_tot[dg] = x;
    }
    K7_MARK(7 + 3 * pass);
    kdtorch::cluster_sync();  // every block's digit totals
    if (lattice && pass == 0 && warp == WARPS - 1) {  // the bits in which the row's keys differ
      const unsigned klo = __reduce_min_sync(
          0xffffffffu, lane < G ? *cluster.map_shared_rank(&s_key[0], lane) : 0xffffffffu);
      const unsigned khi =
          __reduce_max_sync(0xffffffffu, lane < G ? *cluster.map_shared_rank(&s_key[1], lane) : 0u);
      const int kbits = klo < khi ? 32 - __clz(klo ^ khi) : 0;
      if (lane == 0) s_kpasses = max(1, (kbits + 7) / 8);
    }
    int before = 0, all = 0;
    if (tid < ndig) {
      for (int q = 0; q < G; ++q) {
        const int v = *cluster.map_shared_rank(&s_tot[tid], q);
        all += v;
        before += q < rank ? v : 0;
      }
    }
    const int start = kdtorch::block_exclusive_scan(tid < ndig ? all : 0, smem, &n);
    if (tid < ndig) s_first[tid] = start + before;
    if (lattice && pass == 0) {  // written before the scan's barriers
      kpasses = s_kpasses;
      passes = kpasses + a.passes;
    }
    const bool last = pass + 1 == passes;
    const bool to_dst = keyp && pass + 1 == kpasses;  // the key's last pass
    __syncthreads();
    for (int dg = warp; dg < ndig; dg += WARPS) cnt[dg][lane] += s_first[dg];
    __syncthreads();
    K7_MARK(8 + 3 * pass);
    for (int j0 = lo; j0 < hi; j0 += 32 * UNROLL) {
      unsigned long long e[UNROLL];
      unsigned key[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        e[u] = j < hi ? src[j] : 0ull;
      }
      if (last || to_dst) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const unsigned l = (unsigned)e[u];
          key[u] = j0 + u * 32 + lane >= hi ? 0u
                   : last                   ? kdtorch::ordered_key(__ldg(cost + l))
                                            : (unsigned)__ldg(dst + l);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (j0 + u * 32 >= hi) break;  // warp-uniform
        const bool act = j0 + u * 32 + lane < hi;
        const int dg = (int)((unsigned)(e[u] >> shift) & mask);
        const unsigned peers = same_digit(dg, bits, act);
        const int pos = act ? cnt[dg][warp] + __popc(peers & lanemask_lt()) : 0;
        __syncwarp();
        if (act && (peers >> lane) == 1u) cnt[dg][warp] = pos + 1;  // its digit's last lane
        __syncwarp();
        if (act) {
          *arr.at(to, pos) = to_dst ? (unsigned long long)key[u] << 32 | (unsigned)e[u] : e[u];
          if (last) *arr.at(CK, pos) = key[u];
        }
      }
    }
    K7_MARK(9 + 3 * pass);
    cur ^= 1;
    m = max(0, min(C, n - l0));
    if (last && !lattice) {
      // The buffer just read becomes the least (cost key, position) of
      // each run's piece in this block, at its head; set to the largest.
      __syncthreads();
      unsigned long long* least = arr.mine(E[cur ^ 1]);
      for (int li = tid; li < m; li += THREADS) least[li] = ~0ull;
    }
    kdtorch::cluster_sync();  // the pass has landed; s_tot is free
  }
  K7_MARK(2);
  K7_NOTE(0, n);
  K7_NOTE(1, passes);
  K7_NOTE(2, lattice ? kpasses : 0);

  // 3. Runs, kept lanes and the kept lanes before each position, each
  // thread on its contiguous share of the block's positions.
  const unsigned long long* S = E[cur];
  unsigned long long* X = E[cur ^ 1];  // lattice: a kept position's (run head, rank), else ~0;
                                       // leaders: at a run's head, the least (key, position)
                                       // of the run's piece in the head's block
  const unsigned long long* mS = arr.mine(S);
  const unsigned* mCK = arr.mine(CK);
  unsigned long long* mX = arr.mine(X);
  const int2 sh = thread_share(m, tid);
  auto dst_at = [&](int j) -> unsigned {
    return (unsigned)(((unsigned)(j - l0) < (unsigned)m ? mS[j - l0] : *arr.at(S, j)) >> 32);
  };
  // The head of the run of the thread's first position.
  int h0 = l0 + sh.x;
  if (sh.x < sh.y) {
    const unsigned d = dst_at(h0);
    int hi = h0, lo = -1;  // dst_at(hi) == d; lo < 0 or dst_at(lo) != d
    for (int step = 1; hi > 0; step <<= 1) {
      const int j = max(hi - step, 0);
      if (dst_at(j) != d) {
        lo = j;
        break;
      }
      hi = j;
    }
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      if (dst_at(mid) == d)
        hi = mid;
      else
        lo = mid;
    }
    h0 = hi;
  }
  {
    int kept = 0, owner = -1, owned = 0, h = h0;
    unsigned lead = sh.x < sh.y && lattice ? *arr.at(CK, h0) : 0u;
    unsigned long long least = ~0ull, first = ~0ull;  // leaders: the piece's least; the first
    int first_h = -1;                                 // piece's, when its run began earlier
    for (int li = sh.x; li < sh.y; ++li) {
      const int i = l0 + li;
      const unsigned d = (unsigned)(mS[li] >> 32), key = mCK[li];
      if (li > sh.x && d != (unsigned)(mS[li - 1] >> 32)) {  // a run begins
        if (!lattice) {
          if (h < l0 + sh.x) {
            first_h = h;
            first = least;
          } else {
            mX[h - l0] = least;  // the whole run is this thread's
          }
          least = ~0ull;
        }
        h = i;
        lead = key;
      }
      bool keep;
      if (lattice) {
        // The slack test on the canonical costs: -0.0 and +0.0 give it the
        // same answer as the lanes' own bits.
        keep = __fsub_rn(kdtorch::from_ordered_key(key), kdtorch::from_ordered_key(lead)) <=
               a.slack;
        mX[li] = keep ? (unsigned long long)(unsigned)h << 32 | (unsigned)(i - h) : ~0ull;
      } else {
        least = min(least, (unsigned long long)key << 32 | (unsigned)i);
        keep = h == i;  // the run counts once, at its head
      }
      if (keep) {
        const int p = (int)(d / (unsigned)a.sp);
        if (p != owner) {
          if (owned) atomicAdd(&s_own[owner], owned);
          owner = p;
          owned = 0;
        }
        ++owned;
        ++kept;
      }
    }
    if (!lattice) {
      // The pieces of runs this thread does not wholly hold: its first
      // (begun before its share) and its last (which may go on past it),
      // each reduced over the warp's pieces of the same run (if another
      // lane holds one), then taken into this block's shared memory only
      // (at the run's head, or into s_enter when the run began in an
      // earlier block): other blocks read them after the next cluster
      // barrier.
      const int last_h = sh.x < sh.y ? h : -1;
      for (int r = 0; r < 2; ++r) {
        const int hd = r == 0 ? first_h : last_h;
        unsigned long long v = r == 0 ? first : least;
        const unsigned peers = __match_any_sync(0xffffffffu, hd);
        if (hd < 0) continue;
        if (__popc(peers) > 1) {
          const unsigned k = __reduce_min_sync(peers, (unsigned)(v >> 32));
          const unsigned at = __reduce_min_sync(peers, (unsigned)(v >> 32) == k ? (unsigned)v
                                                                               : 0xffffffffu);
          v = (unsigned long long)k << 32 | at;
        }
        if (lane == __ffs(peers) - 1) atomicMin(hd >= l0 ? &mX[hd - l0] : &s_enter, v);
      }
      const int lh = __reduce_max_sync(0xffffffffu, last_h >= l0 ? last_h : -1);
      if (lane == 0 && lh >= 0) atomicMax(&s_last_head, lh);
    }
    // The last owner's count, summed over the warp's threads of that owner.
    const unsigned peers = __match_any_sync(0xffffffffu, owner);
    const int sum = __reduce_add_sync(peers, owned);
    if (owner >= 0 && lane == __ffs(peers) - 1 && sum) atomicAdd(&s_own[owner], sum);
    int all;
    int k = kdtorch::block_exclusive_scan(kept, smem, &all);
    int* mKX = arr.mine(KX);
    for (int li = sh.x; li < sh.y; ++li) {
      mKX[li] = k;
      if (lattice)
        k += mX[li] != ~0ull;
      else
        k += li == sh.x ? h0 == l0 + li : mS[li] >> 32 != mS[li - 1] >> 32;
    }
    if (tid == 0) s_kept = all;
  }
  K7_MARK(3);
  kdtorch::cluster_sync();  // every block's kept counts, places, runs and leaders
  if (tid < a.P) {
    int total = 0;
    for (int q = 0; q < G; ++q) total += *cluster.map_shared_rank(&s_own[tid], q);
    s_owner_kept[tid] = total;
  }
  if (tid == 32 * (WARPS - 1)) {
    int base = 0;
    for (int q = 0; q < G; ++q) {
      s_block_base[q] = base;
      base += *cluster.map_shared_rank(&s_kept, q);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int base = 0;
    bool ovf = false;
    for (int p = 0; p < a.P; ++p) {
      s_owner_base[p] = base;
      base += s_owner_kept[p];
      ovf |= s_owner_kept[p] > a.cap;
    }
    if (rank == 0) a.overflow[b] = ovf;
  }
  __syncthreads();
  K7_MARK(4);

  // 4. The kept lanes under cap (WRITES at a time, their loads issued
  // before their stores), then the rest of each owner's bucket.
  auto run_least = [&](int hd) {
    int q = hd / C;
    unsigned long long v = *arr.at(X, hd);
    if (hd != (q == rank ? s_last_head : *cluster.map_shared_rank(&s_last_head, q))) return v;
    for (++q; q < G; ++q) {
      const unsigned long long e = *cluster.map_shared_rank(&s_enter, q);
      if (e == ~0ull) break;
      v = min(v, e);
      if (*cluster.map_shared_rank(&s_last_head, q) >= 0) break;
    }
    return v;
  };
  int h = h0;  // leaders: the run head of the position at hand and its least
  unsigned long long rmin = !lattice && sh.x < sh.y ? run_least(h0) : 0ull;
  for (int l0w = sh.x; l0w < sh.y; l0w += WRITES) {
    int4 v[WRITES];
    long long at[WRITES];
#pragma unroll
    for (int u = 0; u < WRITES; ++u) {
      const int li = l0w + u;
      at[u] = -1;
      if (li >= sh.y) continue;
      const unsigned long long e = mS[li];
      const int d = (int)(e >> 32), l = (int)(unsigned)e, i = l0 + li;
      int s, rk;
      if (lattice) {
        const unsigned long long r = mX[li];
        if (r == ~0ull) continue;
        s = (int)(r >> 32);
        rk = (int)(unsigned)r;
      } else {
        if (li > sh.x && e >> 32 != mS[li - 1] >> 32) {
          h = i;
          rmin = run_least(h);
        }
        if (rmin != ((unsigned long long)mCK[li] << 32 | (unsigned)i)) continue;
        s = h;
        rk = 0;
      }
      const int owner = d / a.sp;
      const int within = *arr.at(KX, s) + s_block_base[s / C] - s_owner_base[owner] + rk;
      if (within >= a.cap) continue;
      at[u] = ((long long)owner * a.B + b) * a.cap + within;
      v[u] = make_int4(d - owner * a.sp, __float_as_int(__ldg(cost + l)), __ldg(a.src + row + l),
                       __ldg(a.arc + row + l) + a.arc_add);
    }
#pragma unroll
    for (int u = 0; u < WRITES; ++u) {
      if (at[u] < 0) continue;
      if (a.slot_states != nullptr)
        v[u].z = __ldg(a.slot_states + (size_t)b * a.K + min(max(v[u].z, 0), a.K - 1));
      v[u].z += a.slot_add;
      a.send[at[u]] = v[u];
    }
  }
  K7_MARK(5);
  kdtorch::cluster_arrive();  // done with the other blocks' shared memory
  for (int p = 0; p < a.P; ++p) {
    int4* bucket = a.send + ((size_t)p * a.B + b) * a.cap;
    for (int j = min(s_owner_kept[p], a.cap) + rank * THREADS + tid; j < a.cap; j += G * THREADS)
      bucket[j] = make_int4(0, INF_BITS, 0, NO_ARC);
  }
  kdtorch::cluster_wait();  // and they with this block's
#ifdef KD_STEP_MARKS
  __syncthreads();
  K7_MARK(6);
#endif
}

__global__ void __launch_bounds__(RECV_THREADS) route_recv_kernel(
    const int4* recv, int B, int P, int cap, int sp, int* state, float* cost, int* gslot,
    int* arc) {
  const int L = P * cap;
  const int idx = blockIdx.x * RECV_THREADS + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L, q = idx - b * L, p = q / cap;
  const int4 v = recv[((size_t)p * B + b) * cap + (q - p * cap)];
  const float c = __int_as_float(v.y);
  state[idx] = isfinite(c) ? v.x : sp;
  cost[idx] = c;
  gslot[idx] = v.z;
  arc[idx] = v.w;
}

// The dynamic shared memory a block of the send side takes at G blocks a
// row of N lanes, and whether its arrays live there.
size_t send_smem(int G, int N, bool* in_smem) {
  const long C = ((long)N + G - 1) / G;
  *in_smem = C <= SMEM_LANES;
  return COUNT_BYTES + (*in_smem ? (size_t)C * LANE_BYTES : 0);
}

}  // namespace

// The blocks a row (a cluster) K7's send side launches with for rows of N
// lanes: the largest of 8, 4, 2, 1 with at most one block per MIN_LANES
// lanes (and at least one) of which one cluster fits (kdtorch::pick_cluster
// for a single row), whether or not every row's cluster runs at once: on
// the sharded frame's lanes 8 blocks a row beat 4 at B = 16 though not all
// 16 clusters of 8 fit at once (PERF.md); 0 when none fits.
extern "C" int kd_route_send_cluster(int N) {
  int most = 1;
  while (most < 8 && (long)N >= 2l * most * MIN_LANES) most *= 2;
  return kdtorch::pick_cluster(
      route_send_kernel<true>, 1, THREADS, N,
      [N](int c) {
        bool in_smem;
        return send_smem(c, N, &in_smem);
      },
      most);
}

// Launches K7's send side on `stream`: B clusters of G blocks of THREADS
// (G = `clusters`, or kd_route_send_cluster's choice when 0).  Shapes:
// dst/cost/src/arc (B, N) int32/float32/int32/int32; cutoff (B,) float32
// or null; slot_states (B, K) int32 or null; keys0/keys1 (B, N) int64 and
// vals0/vals1 (B, N) int32 scratch (read only when a block's share of a
// row exceeds SMEM_LANES); send (P, B, cap, 4) int32; overflow (B,) bool.
// `lattice` keeps every lane within `slack` of its run's leader, else only
// the leaders.  Returns the launch's CUDA error.
extern "C" int kd_route_send(const void* dst, const void* cost, const void* src, const void* arc,
                             const void* cutoff, const void* slot_states, int B, int N, int K,
                             int sp, int P, int cap, int slot_add, int arc_add, int lattice,
                             float slack, void* keys0, void* keys1, void* vals0, void* vals1,
                             void* send, void* overflow, int clusters, void* stream) {
  if (B < 0 || N < 1 || sp < 1 || cap < 1 || P < 1 || P > MAX_PARTS ||
      (long long)P * sp >= (1ll << 31) || (slot_states != nullptr && K < 1) ||
      !(clusters == 0 || clusters == 1 || clusters == 2 || clusters == 4 || clusters == 8))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int G = clusters != 0 ? clusters : kd_route_send_cluster(N);
  if (G == 0) return (int)cudaErrorInvalidConfiguration;
  const unsigned span = (unsigned)(P * sp - 1);
  const int bits = span == 0 ? 0 : 32 - __builtin_clz(span);  // the destination's bits
  const int passes = bits > 8 ? (bits + 7) / 8 : 1;
  bool in_smem;
  const size_t smem = send_smem(G, N, &in_smem);
  SendArgs a{static_cast<const int*>(dst), static_cast<const float*>(cost),
             static_cast<const int*>(src), static_cast<const int*>(arc),
             static_cast<const float*>(cutoff), static_cast<const int*>(slot_states),
             B, N, K, sp, P, cap, slot_add, arc_add, lattice, slack, (N + G - 1) / G, passes,
             (bits + passes - 1) / passes,
             {static_cast<unsigned long long*>(keys0), static_cast<unsigned long long*>(keys1)},
             static_cast<unsigned*>(vals0), static_cast<int*>(vals1),
             static_cast<int4*>(send), static_cast<unsigned char*>(overflow)};
  return (int)kdtorch::launch_cluster(in_smem ? route_send_kernel<true> : route_send_kernel<false>,
                                      B * G, G, THREADS, smem, static_cast<cudaStream_t>(stream),
                                      a);
}

// Launches K7's receive side on `stream`, one thread an output lane.
// Shapes: recv (P, B, cap, 4) int32; outputs (B, P*cap) int32 / float32 /
// int32 / int32, B * P * cap < 2^31.  Returns the launch's CUDA error.
extern "C" int kd_route_recv(const void* recv, int B, int P, int cap, int sp, void* state,
                             void* cost, void* gslot, void* arc, void* stream) {
  const long long total = (long long)B * P * cap;
  if (B < 0 || P < 1 || cap < 1 || total >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int blocks = (int)((total + RECV_THREADS - 1) / RECV_THREADS);
  route_recv_kernel<<<blocks, RECV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(recv), B, P, cap, sp, static_cast<int*>(state),
      static_cast<float*>(cost), static_cast<int*>(gslot), static_cast<int*>(arc));
  return (int)cudaGetLastError();
}

#ifdef KD_STEP_MARKS
// The last send launch's marks: MARKED rows of STEP_MARKS timer readings
// (ns), then the row's valid lanes, its sort passes and of them the cost
// key's, as int64.
extern "C" int kd_route_send_marks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k7_marks, sizeof(k7_marks));
}
#endif
