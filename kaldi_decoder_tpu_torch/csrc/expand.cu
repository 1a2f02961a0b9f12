// K1: emitting arc expansion + acoustic lookup + beam filter, one frame.
//
// Replaces the XLA-compiled region of the JAX package's lattice frame
// made of kaldi_decoder_tpu/decoders/frontier.py:expand_emitting (with
// _owner_of_lanes), ops/segment.py:score_lookup and the beam filter of
// decoders/lattice_dev.py:lattice_emit_stage.  Its plain torch version is
// kaldi_decoder_tpu_torch/kernels/expand.py:expand_filter_plain, and the
// two agree lane for lane, bitwise.
//
// With a src_slot buffer it also writes each lane's source frontier slot
// (block lane: its slot; remainder lane: its owner), the first half of
// the Viterbi backpointer (decoders/frontier.py:frame_emit_stage).
//
// The row gather of the reference (`row = pg.em_block[safe]`) is folded
// into this launch: K1 takes no gathered `rows` buffer.  It reads the
// em_block row of each active slot among the first KE straight from
// em_block[states[k]], and never reads the state of an inactive slot or
// of a slot at KE or beyond, which may hold anything: such a slot takes
// its fields from row 0 of em_block (staged in shared memory), as the
// reference's `safe` index does.
//
// What bounds it: per frame and utterance it writes N = KE*W + Ru*G
// candidate lanes of 16 bytes (20 with src_slot): 56,832 lanes, 14.5 MB
// for B=16 at the bench shape, against reads of a few MB (the active
// slots' rows, the em_flat units in use, the scores).  But a lane is a
// chain of dependent loads (its slot's state, then its arc from a row or
// from em_flat, then the arc's score), so the kernel is bound by the
// latency of those loads and of its cluster barriers, not by bytes.  The
// rows are L2 hits: the 4.5 MB em_block stays in the 50 MB L2.
//
// The design: one launch, one cluster of C blocks per utterance (C = 8,
// 4, 2 or 1: the largest whose B clusters all run at once).  A block's
// shared memory does not grow with the frontier or the lane count.
//   1. Totals.  Every block reads the KE slots' costs and states, PER
//      consecutive slots a thread, then the row headers of the active
//      ones (all of a thread's state loads first, then all its header
//      loads), and counts their remainder units: the utterance's total
//      (overflow = total > Ru) and its last slot with units, the owner of
//      every padding lane.
//   2. Lanes.  Each block takes a contiguous range of lanes of equal
//      weight (2 per block or padding lane, 3 per valid remainder lane),
//      in tiles of TILE_UNITS*G lanes.  For a tile's units [j0, j1] the
//      block places the owners by unit position in shared memory: a block
//      scan of the unit counts gives each slot its start, a slot whose
//      units meet the tile writes its fields at its first unit (at 0 for
//      the owner of j0), and a running max over the positions gives each
//      unit its owner.  That is the reference's scatter-max + running max,
//      and its owner rule: the last slot whose start is <= the unit.  A
//      remainder lane then reads its owner in one shared-memory lookup; a
//      block lane reads its slot's cost and state, then its word of the
//      slot's row.  Each thread takes UNROLL lanes at a time, in rounds
//      of loads: the block lanes' slots, then every lane's arc (row or
//      em_flat), then every lane's score, so that each round's loads are
//      in flight together; writes are coalesced.  The cost is
//      (alpha + w) + (-score) with round-to-nearest adds, no contraction.
//      A block keeps its first COST_CACHE lane costs in shared memory and
//      writes the rest to the output, where the same thread reads them
//      back.
//   3. Filter.  One cluster barrier; warp 0 of each block reads the
//      cluster's minima through distributed shared memory; every block
//      filters its own costs (cost < min + adaptive_beam).  A final
//      cluster barrier keeps each block's shared memory alive until the
//      others have read its minimum.
// Padding lanes compute what the reference computes (row 0 of em_flat,
// the owner's state), so even masked lanes agree.

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EM_FIELDS = 3;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;              // lanes in flight per thread
constexpr int PER = 5;                 // consecutive slots a thread reads per round
constexpr int CHUNK = PER * THREADS;   // slots per round
constexpr int TILE_UNITS = 2048;       // a lane tile is TILE_UNITS*G lanes
// A tile that starts inside a unit meets TILE_UNITS + 1 units.
constexpr int TILE_POS = TILE_UNITS + 1;
constexpr int POS = (TILE_POS + THREADS - 1) / THREADS;  // unit positions per thread
constexpr int MARK = 1 << 12;  // tags an owner's position placed for the tile at hand
constexpr int COST_CACHE = 10240;      // lane costs a block keeps in shared memory

__device__ __forceinline__ bool slot_active(float c, float cutoff) {
  return isfinite(c) && c < cutoff;
}

__device__ __forceinline__ int n_units(int lo, int deg, int W, int G) {
  return deg > W ? (lo + deg - 1) / G - (lo + W) / G + 1 : 0;
}

// Two blocks fit on an SM, so that B clusters of 8 fit on the card at once.
__global__ void __launch_bounds__(THREADS, 2) expand_kernel(
    const int* __restrict__ states, const float* __restrict__ costs,
    const float* __restrict__ cutoff, const float* __restrict__ adaptive_beam,
    const float* __restrict__ scores, const int* __restrict__ em_block,
    const int* __restrict__ em_flat, int K_full, int KE, int W, int G, int Ru, int V,
    int ccap, int* __restrict__ dst, float* __restrict__ cost, int* __restrict__ src_state,
    int* __restrict__ arc_id, int* __restrict__ src_slot, unsigned char* __restrict__ overflow,
    float* __restrict__ next_cutoff) {
  const int row_w = W * EM_FIELDS + 2;
  // A tile's owners by unit position: s_own maps a position to its
  // owner's, where the owner's start, slot, cost, state, row_lo and
  // degree are.  Then em_block's row 0 and this block's lane costs.
  extern __shared__ int smem[];
  int* const s_own = smem;
  int* const o_start = s_own + TILE_POS;
  int* const o_slot = o_start + TILE_POS;
  float* const o_cost = reinterpret_cast<float*>(o_slot + TILE_POS);
  int* const o_state = reinterpret_cast<int*>(o_cost + TILE_POS);
  int* const o_lo = o_state + TILE_POS;
  int* const o_deg = o_lo + TILE_POS;
  int* const s_row0 = o_deg + TILE_POS;
  float* const s_cc = reinterpret_cast<float*>(s_row0 + ((row_w + 3) & ~3));
  __shared__ int scan_tmp[32];
  __shared__ unsigned s_wmin[WARPS];
  __shared__ int s_total, s_last;  // remainder units; the last slot with units (-1: none)
  __shared__ int s_pad[5];         // padding lanes' owner: start, slot, state, row_lo, degree
  __shared__ unsigned s_min;       // this block's minimum key, read by the cluster
  __shared__ float s_nc;

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int NB = KE * W;
  const int N = NB + Ru * G;
  const long slot0 = (long)b * K_full;
  const float cut = cutoff[b];

  for (int i = tid; i < row_w; i += THREADS) s_row0[i] = em_block[i];
  for (int p = tid; p < TILE_POS; p += THREADS) s_own[p] = -1;
  if (tid == 0) {
    s_total = 0;
    s_last = -1;
  }
  __syncthreads();

  // The slots [cb + tid*PER, + PER): costs, states, row headers and
  // remainder unit counts.  Only an active slot's header is read; an
  // inactive one keeps 0 units (its header is never used).
  float a[PER];
  int st[PER], lo[PER], deg[PER], nu[PER];
  auto load = [&](int cb) {
    const int k0 = cb + tid * PER;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const long k = slot0 + min(k0 + m, KE - 1);
      a[m] = costs[k];
      st[m] = states[k];
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const bool act = k0 + m < KE && slot_active(a[m], cut);
      const int* hdr = em_block + (long)(act ? st[m] : 0) * row_w + W * EM_FIELDS;
      lo[m] = act ? hdr[0] : 0;
      deg[m] = act ? hdr[1] : 0;
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) nu[m] = n_units(lo[m], deg[m], W, G);
  };

  // 1. Totals.
  {
    int units = 0, last = -1;
    for (int cb = 0; cb < KE; cb += CHUNK) {
      load(cb);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        units += nu[m];
        if (nu[m] > 0) last = cb + tid * PER + m;
      }
    }
    units = __reduce_add_sync(0xffffffffu, units);
    last = __reduce_max_sync(0xffffffffu, last);
    if ((tid & 31) == 0) {
      atomicAdd(&s_total, units);
      atomicMax(&s_last, last);
    }
  }
  __syncthreads();
  const int total = s_total;
  // Padding lanes' owner: the last slot with units (its start is the
  // total less its units), else slot 0; written by the thread that holds
  // it after one round, else read again.
  const int o_pad = max(s_last, 0);
  auto set_pad = [&](float c, int s, int l, int d) {
    const bool act = slot_active(c, cut);
    s_pad[0] = s_last >= 0 ? total - n_units(l, d, W, G) : 0;
    s_pad[1] = o_pad;
    s_pad[2] = act ? s : 0;
    s_pad[3] = act ? l : s_row0[W * EM_FIELDS];
    s_pad[4] = act ? d : 0;
  };
  if (KE <= CHUNK) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      if (tid * PER + m == o_pad) set_pad(a[m], st[m], lo[m], deg[m]);
    }
  } else if (tid == 0) {
    const long k = slot0 + o_pad;
    const float c = costs[k];
    const int s = states[k];
    const bool act = slot_active(c, cut);
    const int* hdr = em_block + (long)(act ? s : 0) * row_w + W * EM_FIELDS;
    set_pad(c, s, act ? hdr[0] : 0, act ? hdr[1] : 0);
  }
  __syncthreads();

  // 2. The lanes.  Block lanes and padding remainder lanes (units past
  // the total) cost about the same; a valid remainder lane, whose arc
  // comes from em_flat, costs about 3/2 of one.  Each block takes a
  // contiguous range of lanes of equal weight (2 per cheap lane, 3 per
  // valid remainder lane).
  const int NV = NB + min(total, Ru) * G;  // lanes [NB, NV) are valid remainder lanes
  const long weight = 2L * N + (NV - NB);
  auto lane_at = [&](long w) {  // the first lane at or past weight w
    const long wb = 2L * NB, wv = wb + 3L * (NV - NB);
    if (w <= wb) return (int)((w + 1) / 2);
    if (w <= wv) return NB + (int)((w - wb + 2) / 3);
    return min(NV + (int)((w - wv + 1) / 2), N);
  };
  const int lane0 = lane_at(weight * rank / C);
  const int lane_end = lane_at(weight * (rank + 1) / C);
  const int TL = TILE_UNITS * G;  // a multiple of THREADS
  const int n_tiles = (lane_end - lane0 + TL - 1) / TL;
  // Tile n's lanes [t0, t1) and valid units [j0, j1] (none: j0 > j1).
  auto tile = [&](int n, int& t0, int& t1, int& j0, int& j1) {
    t0 = lane0 + n * TL;
    t1 = min(t0 + TL, lane_end);
    j0 = 0;
    j1 = -1;
    if (t1 > NB) {
      j0 = (max(t0, NB) - NB) / G;
      j1 = min((t1 - 1 - NB) / G, total - 1);
    }
  };
  // The owners of units [j0, j1] by position j - j0.  With `fresh`, the
  // registers still hold the totals' round, when there was only one.  An
  // owner's position is marked with MARK added, so that what an earlier
  // tile left (positions below MARK) loses every max to this tile's marks.
  auto place = [&](int j0, int j1, bool fresh) {
    const int L = j1 - j0 + 1;
    int before = 0;  // units of the rounds before
    for (int cb = 0; cb < KE && before <= j1; cb += CHUNK) {
      if (!fresh || KE > CHUNK) load(cb);
      int sum = 0;
#pragma unroll
      for (int m = 0; m < PER; ++m) sum += nu[m];
      int round_units;
      int start = before + kdtorch::block_exclusive_scan(sum, scan_tmp, &round_units);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        if (nu[m] > 0 && start <= j1 && start + nu[m] > j0) {
          const int p = max(start, j0) - j0;
          s_own[p] = MARK + p;
          o_start[p] = start;
          o_slot[p] = cb + tid * PER + m;
          o_cost[p] = a[m];
          o_state[p] = st[m];
          o_lo[p] = lo[m];
          o_deg[p] = deg[m];
        }
        start += nu[m];
      }
      before += round_units;
    }
    __syncthreads();
    // A running max gives each position its owner's.
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

  unsigned key = 0xffffffffu;
  int t0, t1, j0, j1;
  tile(0, t0, t1, j0, j1);
  if (n_tiles > 0 && j0 <= j1) place(j0, j1, true);
  for (int n = 0; n < n_tiles; ++n) {
    tile(n, t0, t1, j0, j1);
    if (n > 0 && j0 <= j1) {
      __syncthreads();  // every thread is done with the tile before's owners
      place(j0, j1, false);
    }
    for (int base = t0 + tid; base < t1; base += UNROLL * THREADS) {
      // cst is the lane's source cost (+inf: no arc), wt its arc weight.
      int d[UNROLL], sidx[UNROLL], sst[UNROLL], arc[UNROLL], slot[UNROLL], wt[UNROLL];
      float cst[UNROLL];
      // Round one: the block lanes' slots (cost and state).
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        cst[u] = INFINITY;
        sst[u] = 0;
        if (i < t1 && i < NB) {
          const long ks = slot0 + i / W;
          cst[u] = costs[ks];
          sst[u] = states[ks];
        }
      }
      // Round two: every lane's arc, from its slot's row or from em_flat.
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        sidx[u] = 0;
        wt[u] = 0;
        if (i >= t1) continue;
        if (i < NB) {
          const int k = i / W;
          const int w = i - k * W;
          const bool act = slot_active(cst[u], cut);
          const int* row = em_block + (long)(act ? sst[u] : 0) * row_w;
          d[u] = act ? row[w * EM_FIELDS + 1] : s_row0[w * EM_FIELDS + 1];
          sidx[u] = act ? row[w * EM_FIELDS + 2] : s_row0[w * EM_FIELDS + 2];
          arc[u] = (act ? row[W * EM_FIELDS] : s_row0[W * EM_FIELDS]) + w;
          wt[u] = act ? row[w * EM_FIELDS] : 0;
          if (!act) {
            cst[u] = INFINITY;
            sst[u] = 0;
          }
          slot[u] = k;
        } else {
          const int j = (i - NB) / G;
          const int g = i - NB - j * G;
          const bool valid = j < total;
          int ostart, o, ostate, olo, odeg;
          float oc = INFINITY;
          if (valid) {
            const int p = s_own[j - j0];
            ostart = o_start[p];
            o = o_slot[p];
            oc = o_cost[p];
            ostate = o_state[p];
            olo = o_lo[p];
            odeg = o_deg[p];
          } else {
            ostart = s_pad[0];
            o = s_pad[1];
            ostate = s_pad[2];
            olo = s_pad[3];
            odeg = s_pad[4];
          }
          const int tail_lo = olo + W, tail_hi = olo + odeg;
          const int u_first = odeg > W ? tail_lo / G : 0;
          const int unit = u_first - ostart + j;
          const int* fr = em_flat + (long)(valid ? unit : 0) * (G * EM_FIELDS) + g * EM_FIELDS;
          d[u] = fr[1];
          sidx[u] = fr[2];
          arc[u] = unit * G + g;
          const bool in_range = valid && arc[u] >= tail_lo && arc[u] < tail_hi;
          cst[u] = in_range ? oc : INFINITY;
          wt[u] = in_range ? fr[0] : 0;
          sst[u] = ostate;
          slot[u] = o;
        }
      }
      // Round three: every lane's score.  +inf plus a weight stays +inf.
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i >= t1) continue;
        const float cc = __fadd_rn(__fadd_rn(cst[u], __int_as_float(wt[u])),
                                   -scores[(long)b * V + sidx[u]]);
        const long o = (long)b * N + i;
        dst[o] = d[u];
        src_state[o] = sst[u];
        arc_id[o] = arc[u];
        if (src_slot != nullptr) src_slot[o] = slot[u];
        if (i - lane0 < ccap) s_cc[i - lane0] = cc; else cost[o] = cc;
        key = min(key, kdtorch::ordered_key(cc));
      }
    }
  }
  key = __reduce_min_sync(0xffffffffu, key);
  if ((tid & 31) == 0) s_wmin[tid >> 5] = key;
  __syncthreads();
  if (tid < 32) {
    const unsigned v = __reduce_min_sync(0xffffffffu, tid < WARPS ? s_wmin[tid] : 0xffffffffu);
    if (tid == 0) s_min = v;
  }

  // 3. The utterance's minimum across the cluster, then the filter.  Lane
  // i is handled by thread (i - lane0) % THREADS in both loops, so a cost
  // past the cache is read back by the thread that wrote it.
  kdtorch::cluster_sync();
  if (tid < 32) {
    unsigned v = 0xffffffffu;
    if (tid < C) v = *cluster.map_shared_rank(&s_min, tid);
    v = __reduce_min_sync(0xffffffffu, v);
    if (tid == 0) s_nc = __fadd_rn(kdtorch::from_ordered_key(v), adaptive_beam[b]);
  }
  kdtorch::cluster_arrive();  // this block is done reading the others' minima
  __syncthreads();
  const float nc = s_nc;
  for (int i = lane0 + tid; i < lane_end; i += THREADS) {
    const long o = (long)b * N + i;
    const float cc = i - lane0 < ccap ? s_cc[i - lane0] : cost[o];
    cost[o] = (isfinite(cc) && cc < nc) ? cc : INFINITY;
  }
  if (rank == 0 && tid == 0) {
    next_cutoff[b] = nc;
    overflow[b] = total > Ru;
  }
  kdtorch::cluster_wait();
}

// A block's cost cache in a cluster of c blocks: its lanes weigh at most
// 1/c of the total weight (at most 3N) plus a lane, and at least 2 each.
int cost_cache(int N, int c) { return (int)std::min(3L * N / (2 * c) + 2, (long)COST_CACHE); }

size_t expand_smem(int W, int ccap) {
  return (size_t)7 * TILE_POS * sizeof(int) + (((W * EM_FIELDS + 2) + 3) & ~3) * sizeof(int) +
         (size_t)ccap * sizeof(float);
}

}  // namespace

// The cluster size K1 launches with for B utterances of N = KE*W + Ru*G
// lanes (kdtorch::pick_cluster); 0 when none fits.
extern "C" int kd_expand_cluster(int B, int KE, int W, int G, int Ru) {
  const int N = KE * W + Ru * G;
  return kdtorch::pick_cluster(expand_kernel, B, THREADS, (long)W << 32 | N,
                               [W, N](int c) { return expand_smem(W, cost_cache(N, c)); });
}

// Launches K1 on `stream`: B clusters of kd_expand_cluster blocks.  Shapes:
// states/costs (B, K_full), cutoff/adaptive_beam (B,), scores (B, V),
// em_block (S, W*3+2), em_flat (U, G*3); outputs dst/cost/src_state/arc_id
// (B, N), overflow (B,) bytes, next_cutoff (B,); src_slot (B, N) or null
// (then not written: the lattice path does not read it).  Only the states
// of active slots among the first KE are read.  Returns the launch's
// CUDA error (0 on success).
extern "C" int kd_expand(
    const void* states, const void* costs, const void* cutoff,
    const void* adaptive_beam, const void* scores, const void* em_block,
    const void* em_flat, int B, int K_full, int KE, int W, int G, int Ru, int V, void* dst,
    void* cost, void* src_state, void* arc_id, void* src_slot, void* overflow, void* next_cutoff,
    void* stream) {
  const int C = kd_expand_cluster(B, KE, W, G, Ru);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  const int N = KE * W + Ru * G;
  const int ccap = cost_cache(N, C);
  return (int)kdtorch::launch_cluster(
      expand_kernel, B * C, C, THREADS, expand_smem(W, ccap),
      static_cast<cudaStream_t>(stream), states, costs, cutoff, adaptive_beam, scores,
      em_block, em_flat, K_full, KE, W, G, Ru, V, ccap, dst, cost, src_state, arc_id, src_slot,
      overflow, next_cutoff);
}
