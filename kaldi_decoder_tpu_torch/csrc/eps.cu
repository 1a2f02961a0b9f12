// K5: the eps iteration's candidate lanes; and the eps step's shard mode.
//
// Replaces the XLA-compiled region of one eps relaxation that the JAX
// package runs inside its frame before the dedup call (kaldi_decoder_tpu/
// decoders/frontier.py eps_iteration and its eps_closure_batched loop
// body; lattice_dev.py eps_iteration_rec and eps_closure_rec_batched):
//   - K5 (kd_expand_eps): frontier.py:366 expand_eps with _owner_of_lanes
//     and the candidate assembly of eps_iteration / eps_iteration_rec: the
//     active slots (finite cost <= cutoff), optionally the K incumbents
//     first as lanes (state, cost, slot, -1, -1), then K*We block lanes,
//     then R remainder lanes of one arc each through the owner map, each
//     lane's cost (alpha + w) set to +inf above the cutoff.
// The rest of the iteration, the eps step, runs as the last step of the
// dedup call that follows (K6 on the 1-best paths, K2's eps call on the
// lattice paths; eps_step.cuh); the sharded closure's step is a mode of
// its own, at the end of this file.  Their plain versions are
// kaldi_decoder_tpu_torch/kernels/eps.py expand_eps_lanes_plain and
// eps_step_shard_plain.  A float is only added (alpha + w, round to
// nearest, no contraction), compared or copied, so every output is
// bitwise equal to plain.
//
// What bounds them: bytes, and before that the latency of dependent
// loads.  K5 at the unfolded lattice frame (B=16, K 4096, We 1, R 2048,
// with incumbents: 10,240 lanes a row) reads the frontier (32 KB a row)
// and the active slots' eps_block rows and eps_flat arcs (L2 hits) and
// writes four int32/float columns of 10,240 lanes: about 2.8 MB, 0.0008
// ms at 3.35 TB/s.  A lane is a chain (its slot's state, then the row's
// arc; or the owner's place, then the eps_flat arc), so expect a few µs.
//
// K5's design: one cluster of C blocks a row (C = 8, 4, 2 or 1: the
// largest whose B clusters all run at once with at least MIN_LANES lanes a
// block).  A lane is at most three dependent loads deep (its slot's cost
// and state, that state's eps_block header or row, the arc), and a
// remainder lane also needs the row's scan of remainder degrees up to its
// owner; the design keeps everything else off that chain.  The row's
// slots, its incumbent and block lanes and its lanes past the total are
// each cut into C equal shares (shifts: C is a power of two); the
// remainder lanes that a block's slots own are written by that block.
//   1. Every block issues the loads of its first incumbent and block lanes
//      (each a chain of its slot's cost and state, then its word of the
//      slot's row; an inactive slot reads row 0 of eps_block, as the
//      reference's `safe` index does) and of its slots together, then
//      scans its slots as K1 does (csrc/expand.cu steps 1-2): PER
//      consecutive slots a thread, costs and states first, then the eps_
//      block headers, the remainder degrees max(deg - We, 0) of the active
//      slots; a block scan gives each slot its start in the block and the
//      block's total.  The block's part (its total, its last slot with
//      remainder arcs with that slot's state, row_lo and degree, its first
//      slot's) goes into the shared memory of every block of the cluster
//      as two 16-byte st.async stores, which complete on the receiver's
//      mbarrier: no cluster barrier but the one each block arrives at when
//      it starts (so that every block runs, its mbarrier set, before any
//      store reaches it).
//   2. While the parts land, the block places its own owners in its shared
//      memory by their start in the block (each at its first position in a
//      window of TILE, with the start, slot, cost, safe state and row_lo)
//      and runs a running max over the positions (the reference's
//      scatter-max and running max: a lane's owner is the last slot with
//      remainder arcs whose start is <= the lane), and writes its first
//      incumbent and block lanes.
//   3. Once its mbarrier has the C parts, each warp reduces them: the
//      block's first start, the row's total (overflow = total > R) and the
//      pad owner, the last slot with remainder arcs (slot 0 when none has),
//      which the reference's lane map gives every lane past the total.  The
//      block writes its owned remainder lanes (below min(total, R)): the
//      owner in one shared-memory lookup, then its eps_flat arc; then the
//      rest of its incumbent and block lanes and its share of the lanes
//      past the total.
// No block reads another's shared memory, and each waits for every part
// stored into its own.  A block whose slots own more than TILE remainder
// lanes places and writes them a window at a time; a block keeps its
// slots' registers from step 1 to 2 unless they take more than one round
// of the scan (K/C > CHUNK), and reloads them otherwise.  Each thread
// takes UNROLL lanes at a time, in rounds of loads before coalesced
// writes.  Measured (PERF.md, scripts/profile_torch_k5_steps.py): a
// cluster barrier costs some 0.5 µs on the H100 and a release before it
// as much; the two dependent loads take half a block's time at B = 1.

#include <cooperative_groups.h>

#include "common.cuh"
#include "row_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EPS_FIELDS = 2;  // weight bits, next state
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER = 4;                // the most consecutive slots a thread reads per round
constexpr int CHUNK = PER * THREADS;  // the most slots per round
constexpr int TILE = 2048;            // remainder lane positions a block resolves at a time
constexpr int POS = TILE / THREADS;   // positions per thread in the running max
constexpr int MARK = 1 << 12;         // tags an owner's position placed for the window at hand
constexpr int UNROLL = 8;             // lanes in flight per thread
constexpr int MIN_LANES = 512;        // the fewest lanes a block of K5 takes
constexpr int MOST = 8;               // the most blocks a row

__device__ __forceinline__ bool slot_active(float c, float cutoff) {
  return isfinite(c) && c <= cutoff;
}

// K5's step marks: the SM clock at each, by thread 0 of row 0's blocks.
// Built only with KD_STEP_MARKS (scripts/profile_torch_k5_steps.py).
#ifdef KD_STEP_MARKS
constexpr int STEP_MARKS = 9;
__device__ long long k5_marks[MOST * STEP_MARKS];
#define K5_MARK(i) \
  if (tid == 0 && b == 0) k5_marks[rank * STEP_MARKS + (i)] = clock64()
#else
#define K5_MARK(i)
#endif

// A block's part of the row's slot scan, as every block of the cluster
// receives it (two 16-byte stores): its slots' remainder arcs; its last
// slot with some (-1: none) and that slot's safe state, row_lo and
// remainder arcs; its first slot's safe state and row_lo.
struct __align__(16) Part {
  int units, last, state, lo, nu, state0, lo0, unused;
};

// Block `rank` of a cluster of 2^lg blocks: its share [x, y) of n items.
__device__ __forceinline__ int2 even_share(int n, int lg, int rank) {
  return make_int2((int)(((long)n * rank) >> lg), (int)(((long)n * (rank + 1)) >> lg));
}

__global__ void __launch_bounds__(THREADS, 2) expand_eps_kernel(
    const int* __restrict__ states, const float* __restrict__ costs,
    const float* __restrict__ cutoff, const int* __restrict__ eps_block,
    const int* __restrict__ eps_flat, int K, int We, int R, int inc, int* __restrict__ dst,
    float* __restrict__ cost, int* __restrict__ src_slot, int* __restrict__ src_state,
    int* __restrict__ arc_id, unsigned char* __restrict__ overflow) {
  const int row_w = We * EPS_FIELDS + 2;
  // A window's owners by the block's remainder position: s_own maps a
  // position to its owner's, where the owner's arc base (row_lo + We less
  // its start in the block), slot, cost and safe state are.
  __shared__ int s_own[TILE], o_base[TILE], o_slot[TILE], o_state[TILE];
  __shared__ float o_cost[TILE];
  __shared__ int scan_tmp[32];
  __shared__ int4 s_wlast[WARPS];  // each warp's last slot with remainder arcs: slot, state, lo, nu
  __shared__ int2 s_first;         // the block's first slot's safe state and row_lo
  __shared__ Part s_part[MOST];    // every block's part, pushed by that block
  __shared__ uint64_t s_parts;     // its phase completes when the C parts have landed

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();  // 1, 2, 4 or 8
  const int lg = __ffs(C) - 1;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x >> lg;
  const int tid = threadIdx.x;
  const int rbase = inc + K * We;  // the first remainder lane
  const int N = rbase + R;
  const long slot0 = (long)b * K;
  const long lane_row = (long)b * N;
  const float cut = cutoff[b];
  const int2 kr = even_share(K, lg, rank);     // the block's slots
  const int2 lr = even_share(rbase, lg, rank);  // its incumbent and block lanes
  const int2 pr = even_share(R, lg, rank);      // its share of the lanes past the total
  // Block lane q's slot and arc in its slot's row (We is 1 on every path).
  const auto slot_of = [We](int q) { return We == 1 ? q : q / We; };
  const int per = max(1, min(PER, (kr.y - kr.x + THREADS - 1) / THREADS));
  const int chunk = per * THREADS;
  const bool one_round = kr.y - kr.x <= chunk;

  K5_MARK(0);
  for (int p = tid; p < TILE; p += THREADS) s_own[p] = -1;
  if (tid == 0) {
    kdtorch::mbar_init(&s_parts, 1);
    kdtorch::mbar_arrive_expect_tx(&s_parts, C * (unsigned)sizeof(Part));
  }
  kdtorch::cluster_arrive();  // the block runs, its barrier is set
  const int d0 = eps_flat[1];  // the lanes past the total: row 0 of eps_flat

  // The block's incumbent and block lanes base + u*THREADS (c: the lane's
  // source cost, +inf when it has no arc; w: its arc weight), in two
  // rounds of loads (the slots, then the arcs; an inactive slot reads row
  // 0 of eps_block, as the reference's `safe` index does) before
  // coalesced writes.
  int ld[UNROLL], lss[UNROLL], larc[UNROLL], lw[UNROLL];
  float lc[UNROLL];
  auto lanes_slots = [&](int base) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      lc[u] = INFINITY;
      lss[u] = 0;
      if (i < lr.y) {
        const long k = slot0 + (i < inc ? i : slot_of(i - inc));
        lc[u] = costs[k];
        lss[u] = states[k];
      }
    }
  };
  auto lanes_arcs = [&](int base) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      lw[u] = 0;
      if (i >= lr.y) continue;
      if (i < inc) {  // an incumbent: the token itself, no arc
        ld[u] = lss[u];
        larc[u] = -1;
        lss[u] = -1;
      } else {
        const int e = i - inc - slot_of(i - inc) * We;
        const bool act = slot_active(lc[u], cut);
        if (!act) {
          lc[u] = INFINITY;
          lss[u] = 0;
        }
        const int* row = eps_block + (long)lss[u] * row_w;
        ld[u] = row[e * EPS_FIELDS + 1];
        larc[u] = row[We * EPS_FIELDS] + e;
        lw[u] = act ? row[e * EPS_FIELDS] : 0;
      }
    }
  };
  // An arc lane's cost is alpha + w, +inf above the cutoff (+inf plus a
  // weight stays +inf); an incumbent's its own.
  auto lanes_store = [&](int base) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = base + u * THREADS;
      if (i >= lr.y) continue;
      float cc = lc[u];
      if (i >= inc) {
        cc = __fadd_rn(cc, __int_as_float(lw[u]));
        if (!(cc <= cut)) cc = INFINITY;
      }
      const long o = lane_row + i;
      dst[o] = ld[u];
      cost[o] = cc;
      arc_id[o] = larc[u];
      if (src_slot != nullptr) src_slot[o] = i < inc ? i : slot_of(i - inc);
      if (src_state != nullptr) src_state[o] = lss[u];
    }
  };

  // The slots kr.x + cb + [tid*per, + per): costs, safe states (0 when
  // inactive), row_lo (row 0's when inactive) and remainder degrees (0
  // when inactive or past the block's slots).
  float a[PER];
  int st[PER], lo[PER], nu[PER];
  auto load_slots = [&](int cb) {
    const int k0 = kr.x + cb + tid * per;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const long k = slot0 + min(k0 + m, K - 1);
      if (m < per) {
        a[m] = costs[k];
        st[m] = states[k];
      }
    }
  };
  auto load_heads = [&](int cb) {
    const int k0 = kr.x + cb + tid * per;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const bool act = m < per && k0 + m < kr.y && slot_active(a[m], cut);
      if (!act) st[m] = 0;
      const int* hdr = eps_block + (long)st[m] * row_w + We * EPS_FIELDS;
      lo[m] = hdr[0];
      nu[m] = act ? max(hdr[1] - We, 0) : 0;
    }
  };

  // 1. The block's first lanes and its slots, loads in flight together;
  // then the block's remainder arcs, its last slot with some, and (one
  // round) each thread's first start in the block.
  const int lb0 = lr.x + tid;
  lanes_slots(lb0);
  load_slots(0);
  lanes_arcs(lb0);
  int pre = 0, units = 0;
  int4 last = make_int4(-1, 0, 0, 0);  // the thread's last slot with remainder arcs
  {
    int sum = 0, cb = 0;
    do {  // once at least, so that a block with no slots has no remainder degrees
      if (cb > 0) load_slots(cb);
      load_heads(cb);
      if (cb == 0 && tid == 0) s_first = make_int2(st[0], lo[0]);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        sum += nu[m];
        if (nu[m] > 0) last = make_int4(kr.x + cb + tid * per + m, st[m], lo[m], nu[m]);
      }
      cb += chunk;
    } while (cb < kr.y - kr.x);
    K5_MARK(1);
    const int wl = __reduce_max_sync(0xffffffffu, last.x);
    if (wl < 0 ? (tid & 31) == 0 : last.x == wl) s_wlast[tid >> 5] = last;
    pre = kdtorch::block_exclusive_scan(sum, scan_tmp, &units);  // its barriers publish s_wlast
  }

  K5_MARK(2);
  // The block's part, into every block of the cluster.
  kdtorch::cluster_wait();  // every block runs
  K5_MARK(3);
  if (tid < 32) {  // the block's last slot with remainder arcs, from its warps'
    const int4 w = tid < WARPS ? s_wlast[tid] : make_int4(-1, 0, 0, 0);
    const int top = __reduce_max_sync(0xffffffffu, w.x);
    const int at = __ffs(__ballot_sync(0xffffffffu, w.x == top)) - 1;
    const int4 l = make_int4(top, __shfl_sync(0xffffffffu, w.y, at),
                             __shfl_sync(0xffffffffu, w.z, at), __shfl_sync(0xffffffffu, w.w, at));
    if (tid < C) {
      int4* to = reinterpret_cast<int4*>(s_part + rank);
      kdtorch::store_remote(to, make_int4(units, l.x, l.y, l.z), &s_parts, tid);
      kdtorch::store_remote(to + 1, make_int4(l.w, s_first.x, s_first.y, 0), &s_parts, tid);
    }
  }

  K5_MARK(4);
  // 2. While the parts land: the owners of the block's first window of
  // remainder positions [w0, w0 + TILE), each slot's arcs at its start in
  // the block.  An owner's span [start, start + n) is placed at its first
  // position in the window (0 when it owns the window's first position)
  // with MARK added, so that what an earlier window left (below MARK)
  // loses every max to this window's; a running max gives every position
  // its owner (the reference's scatter-max and running max: the last slot
  // with remainder arcs whose start is <= the lane).
  auto place_slots = [&](int w0, int start, int cb) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int n = nu[m];
      if (n > 0 && start < w0 + TILE && start + n > w0) {
        const int p = max(start, w0) - w0;
        s_own[p] = MARK + p;
        o_base[p] = lo[m] + We - start;
        o_slot[p] = kr.x + cb + tid * per + m;
        o_cost[p] = a[m];
        o_state[p] = st[m];
      }
      start += n;
    }
  };
  auto place_window = [&](int w0, int L) {
    if (one_round) {
      place_slots(w0, pre, 0);
    } else {
      int before = 0;
      for (int cb = 0; cb < kr.y - kr.x && before < w0 + TILE; cb += chunk) {
        load_slots(cb);
        load_heads(cb);
        int sum = 0;
#pragma unroll
        for (int m = 0; m < PER; ++m) sum += nu[m];
        int round_units;
        const int start = before + kdtorch::block_exclusive_scan(sum, scan_tmp, &round_units);
        place_slots(w0, start, cb);
        before += round_units;
      }
    }
    __syncthreads();
    int mark[POS], top = -1;
#pragma unroll
    for (int q = 0; q < POS; ++q) {
      const int p = tid * POS + q;
      mark[q] = p < L ? s_own[p] : -1;
      top = max(top, mark[q]);
    }
    int whole;
    int run = kdtorch::block_exclusive_scan(
        top, scan_tmp, &whole, [](int x, int y) { return max(x, y); }, -1);
#pragma unroll
    for (int q = 0; q < POS; ++q) {
      const int p = tid * POS + q;
      run = max(run, mark[q]);
      if (p < L) s_own[p] = run - MARK;
    }
    __syncthreads();
  };
  if (units > 0) place_window(0, min(units, TILE));
  lanes_store(lb0);

  K5_MARK(5);
  // 3. The row's totals, from every block's part (each warp reads them).
  kdtorch::mbar_wait_cluster(&s_parts, 0);
  K5_MARK(6);
  const int lane = tid & 31;
  Part q{0, -1, 0, 0, 0, 0, 0, 0};
  if (lane < C) q = s_part[lane];
  const int total = __reduce_add_sync(0xffffffffu, q.units);
  const int first = __reduce_add_sync(0xffffffffu, lane < rank ? q.units : 0);
  const int last_all = __reduce_max_sync(0xffffffffu, q.last);
  // The pad owner's part: the block of the last slot with remainder arcs,
  // else the block of slot 0.
  const bool holds0 = lane < C && even_share(K, lg, lane).x == 0 && even_share(K, lg, lane).y > 0;
  const int hp = __ffs(__ballot_sync(0xffffffffu, last_all >= 0 ? q.last == last_all && lane < C
                                                               : holds0)) - 1;
  const int p_state = __shfl_sync(0xffffffffu, last_all >= 0 ? q.state : q.state0, hp);
  const int p_lo = __shfl_sync(0xffffffffu, last_all >= 0 ? q.lo : q.lo0, hp);
  const int p_nu = __shfl_sync(0xffffffffu, q.nu, hp);
  if (rank == 0 && tid == 0) overflow[b] = total > R;
  const int owned = min(total, R);  // remainder lanes [0, owned) have an owner's arc

  // 4. The block's owned remainder lanes first + [0, span), a window at a
  // time: the owner in one shared-memory lookup, then its eps_flat arc.
  const int span = min(units, max(owned - first, 0));
  for (int w0 = 0; w0 < span; w0 += TILE) {
    if (w0 > 0) place_window(w0, min(units - w0, TILE));
    const int L = min(span - w0, TILE);
    for (int p00 = tid; p00 < L; p00 += UNROLL * THREADS) {
      int d[UNROLL], w[UNROLL], o[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = p00 + u * THREADS;
        if (p < L) {
          o[u] = s_own[p];
          const int* fr = eps_flat + (long)(o_base[o[u]] + w0 + p) * EPS_FIELDS;
          d[u] = fr[1];
          w[u] = fr[0];
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int p = p00 + u * THREADS;
        if (p >= L) continue;
        float cc = __fadd_rn(o_cost[o[u]], __int_as_float(w[u]));
        if (!(cc <= cut)) cc = INFINITY;
        const long at = lane_row + rbase + first + w0 + p;
        dst[at] = d[u];
        cost[at] = cc;
        arc_id[at] = o_base[o[u]] + w0 + p;
        if (src_slot != nullptr) src_slot[at] = o_slot[o[u]];
        if (src_state != nullptr) src_state[at] = o_state[o[u]];
      }
    }
    __syncthreads();  // every thread is done with the window's owners
  }

  K5_MARK(7);
  // 5. The rest of the block's incumbent and block lanes; its share of the
  // lanes past the total: the pad owner's arcs (its start is the total
  // less its arcs; slot 0's from 0 when no slot has remainder arcs), row 0
  // of eps_flat, +inf.
  for (int base = lb0 + UNROLL * THREADS; base < lr.y; base += UNROLL * THREADS) {
    lanes_slots(base);
    lanes_arcs(base);
    lanes_store(base);
  }
  const int pad_base = p_lo + We - (last_all >= 0 ? total - p_nu : 0);
  const int pad_slot = max(last_all, 0);
  for (int j = max(pr.x, owned) + tid; j < pr.y; j += THREADS) {
    const long at = lane_row + rbase + j;
    dst[at] = d0;
    cost[at] = INFINITY;
    arc_id[at] = pad_base + j;
    if (src_slot != nullptr) src_slot[at] = pad_slot;
    if (src_state != nullptr) src_state[at] = p_state;
  }
  K5_MARK(8);
}

}  // namespace

// The blocks a row (a cluster) K5 launches with for B rows of N lanes:
// kdtorch::pick_cluster's choice, at most the largest of 8, 4, 2, 1 with
// N/C >= MIN_LANES; 0 when none fits.
extern "C" int kd_expand_eps_blocks(int B, int N) {
  int most = MOST;
  while (most > 1 && N / most < MIN_LANES) most /= 2;
  return kdtorch::pick_cluster(expand_eps_kernel, B, THREADS, N, [](int) { return (size_t)0; },
                               most);
}

#ifdef KD_STEP_MARKS
// The last K5 launch's marks, row 0's blocks in rank order (MOST *
// STEP_MARKS int64), and the SM's rated clock in kHz.
extern "C" int kd_expand_eps_marks(long long* clock, int* clock_khz) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clock, k5_marks, sizeof(k5_marks));
  return (int)e;
}
#endif

// Launches K5 on `stream`: B clusters of C blocks (C = `blocks`, or
// kd_expand_eps_blocks when 0).  Shapes: states/costs (B, K), cutoff (B,),
// eps_block (S, We*2+2), eps_flat (E, 2) int32; outputs dst/cost/arc_id
// (B, N) with N = inc + K*We + R (inc: 0, or K for the incumbents first),
// src_slot and src_state (B, N) or null (then not written), overflow (B,)
// bytes.  Returns the launch's CUDA error (0 on success; a refused cluster
// launch is reported).
extern "C" int kd_expand_eps(const void* states, const void* costs, const void* cutoff,
                             const void* eps_block, const void* eps_flat, int B, int K, int We,
                             int R, int inc, int blocks, void* dst, void* cost, void* src_slot,
                             void* src_state, void* arc_id, void* overflow, void* stream) {
  if (B < 1 || K < 1 || We < 1 || R < 1 || (inc != 0 && inc != K) || blocks < 0 ||
      blocks > MOST || (blocks & (blocks - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int N = inc + K * We + R;
  const int C = blocks > 0 ? blocks : kd_expand_eps_blocks(B, N);
  if (C < 1) return (int)cudaErrorInvalidConfiguration;
  return (int)kdtorch::launch_cluster(
      expand_eps_kernel, B * C, C, THREADS, 0, static_cast<cudaStream_t>(stream),
      static_cast<const int*>(states), static_cast<const float*>(costs),
      static_cast<const float*>(cutoff), static_cast<const int*>(eps_block),
      static_cast<const int*>(eps_flat), K, We, R, inc, static_cast<int*>(dst),
      static_cast<float*>(cost), static_cast<int*>(src_slot), static_cast<int*>(src_state),
      static_cast<int*>(arc_id), static_cast<unsigned char*>(overflow));
}


// ---- The eps step's shard mode ----------------------------------------------
//
// Replaces the bookkeeping of the JAX package's sharded closure, which runs
// between the exchanges (kaldi_decoder_tpu/parallel/graph_shard.py:380-445
// _sharded_eps_iteration / _sharded_eps_closure, :834-920 the lattice
// ones): the backpointers with global slots (or the first r_eps record
// links and the spill test), the local `changed`, the carry under the
// batch-wide stop (state kept, identity or -1 rows), the running overflow
// and saturation.  Plain version: kernels/eps.py eps_step_shard_plain.
// Unlike the unsharded step, `stop` is batch-wide and not masked by the
// rows still decoding: stop_d = stop_{d-1} | !changed_d, where changed_d is
// the MAX over the ranks of the local flag this step writes, reduced by
// the caller between two steps; the step of iteration d applies stop_{d-1}
// (the carried stop, or the reduced flag of d - 1 zero).  At the closure's
// last iteration (`reduce`) it also writes what the frame then reduces over
// the ranks: each row's smallest finite cost (its first smallest in slot
// order, the bits of that slot) and count of finite costs, and the flag
// pair (the emitting call's flags are folded in at d = 0, where no stop
// masks them).  A value is only copied or compared: bitwise equal to plain.
// (The unsharded step runs as the last step of the eps dedup call,
// eps_step.cuh.)
//
// What bounds it: bytes, the K winning lanes' routed slot and arc (1-best:
// read in place, the dedup call's routed lanes, common.cuh:routed_entry)
// or the records (lattice), the selection and the carried frontier, one
// iteration's row of backpointers or links: 1.1-1.9 MB at B = 16, K 2048,
// some 0.0003-0.0006 ms at 3.35 TB/s; at these sizes what is left is a
// launch and a chain of dependent loads.
//
// The design: a cluster of G blocks a row (G = 8, 4, 2 or 1: the largest
// whose B clusters all run at once with at least STEP_MIN_SLOTS slots a
// block), so that at B = 16 some 128 SMs move the bytes.  Block r takes
// its 1/G of the row's K slots and of its R_rec records (ranges of a
// multiple of 32, in rank order; a block may own none) and writes the
// backpointer or link rows and carried slots it owns.  Every thread issues
// its loads at its start, beside the two flag loads that give `stop`
// (cand_idx then the routed lanes' gslot and arc, the selection, the
// carried costs, the records) and selects by `stop` afterwards: when the
// batch has stopped no block writes the carried frontier, so reading it
// early is safe.  Each block reduces its partials (the changed bit, the
// link and finite counts, the 64-bit (ordered cost, slot) min key and that
// slot's cost bits; row_reduce.cuh, which K3's shard first-frame mode
// shares) and stores them into rank 0's shared memory with
// st.async, completing on rank 0's mbarrier, after the one cluster barrier
// that tells that rank 0 runs with its mbarrier set: no remote atomic (a
// 64-bit atomicMin on another block's shared memory lost updates at 8
// blocks a row, PERF.md).  The min key carries the slot, so the first
// smallest in slot order is the same whatever the split.  Rank 0 alone
// writes the row's scalars (red_min, red_count) and does the batch-wide
// part: one acquire-release 64-bit add on ShardFlags.count that counts its
// cluster done and carries whether its row changed, overflowed or
// saturated (16 bits each), whose answer tells the last of the B clusters
// the batch's three flags: it writes stop, the running overflow and
// saturation, `changed` and clears the count.  The hazard: flags.stop is
// overwritten by the last cluster, so every block of every row must have
// read it first; each block stores its partials only after it has used
// `stop`, and rank 0 counts its row done only once its mbarrier holds
// every block's partials.

namespace {

constexpr int STEP_THREADS = 256;
constexpr int STEP_WARPS = STEP_THREADS / 32;
constexpr int STEP_UNROLL = 4;        // slots and records in flight a thread
constexpr int STEP_MIN_SLOTS = 256;   // the fewest slots a block of the step takes
constexpr unsigned long long ROW_DONE = 1ull, ROW_CHANGED = 1ull << 16,
                             ROW_OVF = 1ull << 32, ROW_SAT = 1ull << 48;
constexpr int STEP_MAX_ROWS = (1 << 16) - 1;  // each 16-bit field of the count holds up to B

// kernels/eps.py ShardEpsCarry.flags (SHARD_FLAG_WORDS int32 words; the
// plain version writes words 0, 5 and 6, the kernel leaves the rest 0).
struct ShardFlags {
  int stop;                  // the batch has stopped before this iteration
  int unused1;
  unsigned long long count;  // this iteration: ROW_DONE, ROW_CHANGED, ROW_OVF, ROW_SAT each
  int unused4;
  int ovf, sat;              // running over the iterations, unless stopped
};
static_assert(offsetof(ShardFlags, count) == 8 && offsetof(ShardFlags, ovf) == 20 &&
                  offsetof(ShardFlags, sat) == 24,
              "ShardFlags' words");

struct ShardStepArgs {
  int B, K, D, d, width, R_rec, slot_base, reduce;
  const int* cand_idx;              // (B, K)
  const int* num_unique;            // (B,)
  const int* sel_states;            // (B, K)
  const float* sel_costs;           // (B, K)
  const unsigned char* rec_ovf;     // (B,) lattice
  const int4* records;              // (B, R_rec) lattice
  kdtorch::Routed routed;           // the dedup call's routed lanes (1-best)
  const unsigned char* exp_ovf;     // (B,) K5's
  const unsigned char* route_ovf;   // (B,) the route's
  const unsigned char* em_ovf[3];   // (B,) each or null: the emitting call's
  const int* em_num_unique;         // (B,) or null
  const int* changed_prev;          // (1,) the reduced flag of iteration d - 1
  ShardFlags* flags;
  int* changed;                     // (1,) this iteration's local flag
  int* states;                      // (B, K) the carried frontier, in place
  float* costs;
  int2* out;                        // (B, D, width)
  float* red_min;                   // (B,)
  int* red_count;                   // (B,)
  int* red_flags;                   // (2,)
};

template <bool LATTICE>
__global__ void __launch_bounds__(STEP_THREADS) eps_step_shard_kernel(ShardStepArgs a) {
  __shared__ kdtorch::rowred::RowReduce<STEP_WARPS> red;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();  // 1, 2, 4 or 8
  const int lg = __ffs(G) - 1;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x >> lg;
  const int tid = threadIdx.x;
  const bool lead = rank == 0 && tid == 0;  // writes the row's scalars and counts it done
  if (lead) kdtorch::rowred::row_reduce_init(red, G);

  // What does not wait: the flags that give `stop` (every thread, a
  // broadcast load); rank 0's row flags.
  const bool later = a.d > 0;
  int f_stop = 0, f_prev = 1;
  if (later) {
    f_stop = __ldcg(&a.flags->stop);
    f_prev = __ldcg(a.changed_prev);
  }
  const int K = a.K;
  bool o = false, s = false;
  if (lead) {
    o = a.exp_ovf[b] || a.route_ovf[b];
    if (LATTICE) o = o || a.rec_ovf[b];
    for (int i = 0; i < 3; ++i)
      if (a.em_ovf[i] != nullptr) o = o || a.em_ovf[i][b];
    s = a.num_unique[b] > K;
    if (a.em_num_unique != nullptr) s = s || a.em_num_unique[b] > K;
  }
  kdtorch::cluster_arrive();  // the block runs (rank 0: its mbarrier is set)

  // The block's slots and records, a round of loads before any store.
  const size_t row = (size_t)b * K;
  const int4* rec = a.records + (size_t)b * a.R_rec;
  int2* dst = a.out + ((size_t)b * a.D + a.d) * a.width;
  const int2 kr = kdtorch::share(K, lg, rank);
  const int2 rr = LATTICE ? kdtorch::share(a.R_rec, lg, rank) : make_int2(0, 0);
  const int nk = kr.y - kr.x, nr = rr.y - rr.x;
  bool changed = false;
  int finite = 0, links = 0;
  unsigned long long mn = ~0ull;  // the thread's smallest (ordered cost, slot)
  unsigned mbits = 0;             // that slot's cost bits
  for (int i0 = tid; i0 < max(nk, nr); i0 += STEP_UNROLL * STEP_THREADS) {
    int ci[STEP_UNROLL], ss[STEP_UNROLL];
    float sc[STEP_UNROLL], oc[STEP_UNROLL];
    int2 bp[STEP_UNROLL];
    int4 rv[STEP_UNROLL];
#pragma unroll
    for (int u = 0; u < STEP_UNROLL; ++u) {
      const int i = i0 + u * STEP_THREADS;
      if (i < nk) {
        const size_t k = row + kr.x + i;
        ci[u] = a.cand_idx[k];
        ss[u] = a.sel_states[k];
        sc[u] = a.sel_costs[k];
        oc[u] = a.costs[k];
      }
      if (LATTICE && i < nr) rv[u] = rec[rr.x + i];
    }
    if (!LATTICE) {
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        if (i0 + u * STEP_THREADS < nk)
          bp[u] = ci[u] >= 0 ? kdtorch::routed_payload(a.routed, b, ci[u]) : make_int2(0, -1);
      }
    }
    const bool stop = later && (kdtorch::pin(f_stop) != 0 || kdtorch::pin(f_prev) == 0);
#pragma unroll
    for (int u = 0; u < STEP_UNROLL; ++u) {
      const int i = i0 + u * STEP_THREADS;
      if (i < nk) {
        const int k = kr.x + i;
        if (LATTICE) {
          changed |= ci[u] >= K && isfinite(sc[u]);
        } else {
          changed |= ci[u] >= 0 && bp[u].y != -1;
          dst[k] = stop ? make_int2(a.slot_base + k, -1) : bp[u];
        }
        float c = oc[u];
        if (!stop) {  // the carried frontier: the selection's unless stopped
          a.states[row + k] = ss[u];
          a.costs[row + k] = sc[u];
          c = sc[u];
        }
        if (isfinite(c)) {
          const unsigned long long key =
              (unsigned long long)kdtorch::ordered_key(c) << 32 | (unsigned)k;
          if (key < mn) {
            mn = key;
            mbits = __float_as_uint(c);
          }
          ++finite;
        }
      }
      if (LATTICE && i < nr) {
        const int r = rr.x + i;
        links += rv[u].z >= 0;
        if (r < a.width) dst[r] = stop ? make_int2(-1, -1) : make_int2(rv[u].x, rv[u].y);
      }
    }
  }

  // The row's totals, in rank 0's warp 0: its lane 0 writes them.
  kdtorch::rowred::RowTotals t;
  if (!kdtorch::rowred::row_reduce(red, G, rank, mn, mbits, finite, links, changed, t) || !lead)
    return;
  if (LATTICE) o = o || t.links > a.width;  // the spill: links past the rows kept
  if (a.reduce) {
    a.red_min[b] = kdtorch::rowred::row_min(t);
    a.red_count[b] = t.finite;
  }
  // The count, acquire-release at device scope: the last cluster's reads
  // and writes after every other's count.
  const unsigned long long mine =
      ROW_DONE + (t.changed ? ROW_CHANGED : 0) + (o ? ROW_OVF : 0) + (s ? ROW_SAT : 0);
  unsigned long long seen;
  asm volatile("atom.acq_rel.gpu.add.u64 %0, [%1], %2;\n"
               : "=l"(seen)
               : "l"(&a.flags->count), "l"(mine)
               : "memory");
  seen += mine;
  if ((seen & 0xffffu) != (unsigned)a.B) return;
  // The last cluster: every block of every row has read `stop`.
  const bool stop = later && (f_stop != 0 || f_prev == 0);
  const bool go = ((seen >> 16) & 0xffffu) != 0;
  const bool any_o = ((seen >> 32) & 0xffffu) != 0;
  const bool any_s = (seen >> 48) != 0;
  const bool ovf = (later && a.flags->ovf != 0) || (!stop && any_o);
  const bool sat = (later && a.flags->sat != 0) || (!stop && any_s);
  a.flags->stop = stop;
  a.flags->ovf = ovf;
  a.flags->sat = sat;
  a.flags->count = 0;
  *a.changed = go;
  if (a.reduce) {
    a.red_flags[0] = ovf;
    a.red_flags[1] = sat;
  }
}

// The most blocks a row's cluster takes for K slots: at least STEP_MIN_SLOTS a block.
int step_cluster_cap(int K) {
  int c = MOST;
  while (c > 1 && K / c < STEP_MIN_SLOTS) c /= 2;
  return c;
}

}  // namespace

// The blocks a row (a cluster) the eps step's shard mode launches with for
// B rows of K slots (kdtorch::pick_cluster, at most step_cluster_cap(K));
// 0 when none fits.  The 1-best instance takes what the lattice one is given.
extern "C" int kd_eps_step_shard_cluster(int B, int K) {
  return kdtorch::pick_cluster(eps_step_shard_kernel<true>, B, STEP_THREADS, K,
                               [](int) { return (size_t)0; }, step_cluster_cap(K));
}

// Launches the eps step's shard mode for iteration d of D on `stream`: B
// clusters of G blocks (G = `clusters`, or kd_eps_step_shard_cluster's when
// 0), the lattice instance when `lattice` is set.  B < 2^16.  Shapes:
// cand_idx, sel_states (B, K) int32, sel_costs (B, K) float32, num_unique
// (B,) int32; exp_ovf, route_ovf and the em_ovf given (B,) bool,
// em_num_unique (B,) int32 or null; changed_prev (1,) int32 (read when
// d > 0); flags 7 int32 words (ShardFlags, 8-byte aligned), changed (1,)
// int32; states/costs (B, K) the carried frontier; out (B, D, width, 2)
// int32; red_min (B,) float32, red_count (B,) int32, red_flags (2,) int32
// (written when `reduce`).  1-best: `routed`, a host pointer to
// kdtorch::Routed (the dedup call's lanes, read in place), width = K;
// lattice: rec_ovf (B,) bool, records (B, R_rec, 4) int32 with R_rec >=
// width.  Returns the launch's CUDA error (a refused cluster launch is
// reported).
extern "C" int kd_eps_step_shard(int lattice, int B, int K, int D, int d, int width,
                                 int R_rec, int slot_base, int reduce, const void* cand_idx,
                                 const void* num_unique, const void* sel_states,
                                 const void* sel_costs, const void* rec_ovf, const void* records,
                                 const void* routed, const void* exp_ovf,
                                 const void* route_ovf, const void* em_ovf0, const void* em_ovf1,
                                 const void* em_ovf2, const void* em_num_unique,
                                 const void* changed_prev, void* flags, void* changed,
                                 void* states, void* costs, void* out, void* red_min,
                                 void* red_count, void* red_flags, int clusters, void* stream) {
  if (B < 1 || B > STEP_MAX_ROWS || K < 1 || D < 1 || d < 0 || d >= D || width < 1 ||
      (lattice && R_rec < width) || (!lattice && (width != K || routed == nullptr)) ||
      (d > 0 && changed_prev == nullptr) || reinterpret_cast<uintptr_t>(flags) % 8 != 0 ||
      clusters < 0 || clusters > MOST || (clusters & (clusters - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int G = clusters > 0 ? clusters : kd_eps_step_shard_cluster(B, K);
  if (G < 1) return (int)cudaErrorInvalidConfiguration;
  using U8 = const unsigned char*;
  const kdtorch::Routed rt = kdtorch::routed_of(routed);
  if (routed != nullptr && !kdtorch::routed_fits(rt, B, rt.K + rt.P * rt.cap))
    return (int)cudaErrorInvalidValue;
  const ShardStepArgs a{B, K, D, d, width, R_rec, slot_base, reduce,
                        static_cast<const int*>(cand_idx), static_cast<const int*>(num_unique),
                        static_cast<const int*>(sel_states), static_cast<const float*>(sel_costs),
                        static_cast<U8>(rec_ovf), static_cast<const int4*>(records),
                        rt,
                        static_cast<U8>(exp_ovf), static_cast<U8>(route_ovf),
                        {static_cast<U8>(em_ovf0), static_cast<U8>(em_ovf1),
                         static_cast<U8>(em_ovf2)},
                        static_cast<const int*>(em_num_unique),
                        static_cast<const int*>(changed_prev), static_cast<ShardFlags*>(flags),
                        static_cast<int*>(changed), static_cast<int*>(states),
                        static_cast<float*>(costs), static_cast<int2*>(out),
                        static_cast<float*>(red_min), static_cast<int*>(red_count),
                        static_cast<int*>(red_flags)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(lattice ? kdtorch::launch_cluster(eps_step_shard_kernel<true>, B * G, G,
                                                 STEP_THREADS, 0, st, a)
                       : kdtorch::launch_cluster(eps_step_shard_kernel<false>, B * G, G,
                                                 STEP_THREADS, 0, st, a));
}
