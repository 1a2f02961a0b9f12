// K4: the windowed backward extra-cost sweep of one chunk.
//
// Replaces the XLA-compiled reverse scan of the JAX package's
// kaldi_decoder_tpu/decoders/sweep.py:_sweep_one (with _join_min,
// _compact_rows and _append), with and without eps links (the eps
// Bellman and the eps rows, sweep.py:168-241, are the kernel's kEps
// instance; the eps-free instance has none of their code).  Its plain
// torch version is kaldi_decoder_tpu_torch/decoders/sweep.py:sweep_plain;
// survivor counts, overflow flags and rows[:count] agree exactly.
//
// What bounds it: the sweep is sequential over the chunk's T frames; per
// frame and utterance it reads the K frontier slots (8 bytes each) and R
// lattice records (16 bytes each), 160 KB at the bench shape.  Inside a
// frame the work is parallel but small and made of dependent phases
// (join by state, keep, compact, join back), so the loop is bound by the
// latency of those phases and of the barriers between them, not by bytes.
// Eps records add two barriers a Bellman pass and one for the counts to
// each frame: on the bench's unfolded decode (D 1, Re 2048) a 500-frame
// chunk takes 6.25 ms against 3.06 without (H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 2), for 1 MB more of eps records read.
//
// The design:
//   * one thread block cluster of C blocks per utterance (C = 8, 4, 2 or
//     1: the largest whose B clusters all run at once; two 512-thread
//     blocks fit on an SM).  Each block owns a contiguous range of the
//     frame's K slots (a multiple of 4) and of its R records, the same in
//     every frame;
//   * the block's slab of each frame (its slots' states and costs, its
//     records) is staged in shared memory by bulk asynchronous copies
//     (cp.async.bulk, the TMA's 1-D form) completing on an mbarrier, three
//     slabs in flight: frame t-2's slab is requested as frame t starts.
//     Every phase reads records and slots from shared memory; the slot
//     extras and the link extras stay in shared memory too.  Shared memory
//     holds at most SMEM_BUDGET bytes a block: when a block's ranges are
//     larger, only their first Ks slots and Rs records are staged, and the
//     rest are read from device memory and their extras kept there, each
//     by the one thread that owns it (the kernel's kSpill instance, which
//     the launch takes only for such shapes);
//   * the join by state is a per-utterance table of S entries in device
//     memory (L2-resident), two of them: table A takes the slot extras of
//     frame t+1 (scatter-min) and is gathered by each record's
//     destination; table B takes the kept links' extras by source state
//     and is gathered on the previous frontier's slots.  An entry holds
//     the frame beside the value's bits, so an entry of an earlier-swept
//     frame loses every atomicMin to this frame's and reads as absent:
//     no table is ever reset.  All joined values are >= 0 or +inf, so an
//     integer atomicMin is exact once -0.0 is canonicalised; every slot
//     is scattered, dead ones included, exactly as the reference's
//     compare sees them; record padding (-1 states) never touches a table;
//   * two cluster barriers per frame order the phases across the
//     cluster: (1) table A complete, (2) table B complete.  Each is split
//     into arrival and wait, and the survivor rows, which no block of
//     the cluster reads, are written in between, so that a barrier's
//     release does not wait for their stores.  The stable
//     compactions (tokens, then records, in row order) are a warp scan, a
//     block scan of the warp totals, and the block totals of the lower
//     ranks read through distributed shared memory, so the row order and
//     the appends, clamped at the caps as the reference's
//     dynamic_update_slice appends are, stay exactly those of the
//     reference;
//   * with eps links (kEps), a frame's slot extras are refined, before any
//     token or link is kept, by Bellman passes over the frame's D x Re eps
//     records, which each block reads from device memory (a contiguous
//     range of them a block, as for the emitting records).  Table A
//     already holds the slot extras joined by state; a pass (a) takes each
//     record's le = A[dst] + slack and joins max(le, 0) by source state
//     into table E, the third table, whose entries never mix with table
//     B's emitting links; (b) after a cluster barrier, lowers each slot's
//     extra to E[its state] where that is smaller, joins the lowered
//     value into table A and raises the block's "lowered" flag; (c) after
//     a second barrier every block reads the cluster's flags.  Extras only
//     fall from one pass to the next, so neither table is reset between
//     passes: the min over the passes of an entry is the latest pass's
//     value.  Passes stop when none lowers an extra, or at the bound (D +
//     2 when the eps graph is exact, else min(K, D * Re) + 2); a frame
//     still changing at the bound inside the emitted range sets the
//     overflow flag.  Table A then holds the final extras for the
//     emitting records; the tokens and the eps links within the beam are
//     counted, and after one more barrier the eps links are appended to
//     their own rows (stable, clamped at eps_cap, as the tokens are).

#include <cooperative_groups.h>

#include <algorithm>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NBUF = 3;  // frame slabs in flight
constexpr int SMEM_BUDGET = 100 * 1024;  // dynamic shared bytes a block: two fit on an SM

// A join table entry: the frame in the high word, so that an entry of an
// earlier-swept frame (a larger t) loses every atomicMin to one of this
// frame and reads as absent; the value's bits (>= 0 or +inf, -0.0 folded)
// in the low word, so that the min of two entries of one frame is the
// min of their values.
// Every lane of the warp calls it; lanes with `on` set join v into entry
// s.  Lanes of the warp that hit one entry are combined first, so each
// entry takes one atomic per warp (dead slots, and links out of one
// state, would otherwise queue on one address).  A +inf value is not
// joined at all: an entry this frame did not write reads as +inf.
__device__ __forceinline__ void table_min(unsigned long long* tab, int s, int t, float v,
                                          bool on) {
  on = on && s >= 0 && v < INFINITY;
  const unsigned grp = __match_any_sync(0xffffffffu, on ? (unsigned)s : 0xffffffffu);
  if (!on) return;
  const unsigned m = __reduce_min_sync(grp, __float_as_uint(kdtorch::canon_zero(v)));
  if ((int)(threadIdx.x & 31) == __ffs(grp) - 1) {
    atomicMin(tab + s, ((unsigned long long)t << 32) | m);
  }
}
__device__ __forceinline__ float table_get(const unsigned long long* tab, int s, int t) {
  const unsigned long long e = __ldcg(tab + s);
  return (unsigned)(e >> 32) == (unsigned)t ? __uint_as_float((unsigned)e) : INFINITY;
}

// Each thread's keep count -> its exclusive prefix within its warp; the
// block's warp prefixes go to pre[0..WARPS), its total to pre[32].  The
// block total is read by the cluster after the next cluster barrier.
__device__ __forceinline__ int publish_counts(int cnt, int* pre) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) pre[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < WARPS ? pre[lane] : 0;
    int s = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    if (lane < WARPS) pre[lane] = s - v;
    if (lane == 31) pre[32] = s;
  }
  return x - cnt;
}

// The cluster's count before this block (lower ranks) and in all, from
// the block totals published by publish_counts.
__device__ __forceinline__ int2 cluster_counts(cg::cluster_group& cluster, int* pre, int rank,
                                               int C) {
  const int lane = threadIdx.x & 31;
  int v = 0;
  if (lane < C) v = *cluster.map_shared_rank(pre + 32, lane);
  return make_int2(__reduce_add_sync(0xffffffffu, lane < rank ? v : 0),
                   __reduce_add_sync(0xffffffffu, v));
}

// Two blocks fit on an SM, so that B clusters of 8 fit on the card at once.
// kSpill: some block's ranges are larger than what it stages (the launch
// chooses by shape); without it the kernel has no device-memory branch.
// kEps: the frames carry eps records (D > 0).
template <bool kSpill, bool kEps>
__global__ void __launch_bounds__(THREADS, 2) sweep_kernel(
    const int* __restrict__ fstates, const float* __restrict__ fcosts,
    const int* __restrict__ em, const int* __restrict__ init_states,
    const int* __restrict__ rem, int T, int B, int K, int R, int S, int Kb, int Rb, int Ks,
    int Rs, int tok_cap, int em_cap, float tok_thr, float em_thr,
    unsigned long long* __restrict__ table, float* __restrict__ spill,
    int* __restrict__ tok_rows, int* __restrict__ em_rows, int* __restrict__ tok_count,
    int* __restrict__ em_count, unsigned char* __restrict__ overflow,
    const int* __restrict__ eps, int DRe, int eps_bound, int eps_cap,
    int* __restrict__ eps_rows, int* __restrict__ eps_count) {
  // NBUF slabs of [states (Ks) | costs (Ks) | records (Rs x int4)], then
  // the slot extras (Ks) and the link extras (Rs).
  extern __shared__ int4 smem4[];
  __shared__ uint64_t slab_full[NBUF];
  __shared__ int tok_pre[33], em_pre[33], eps_pre[33];
  __shared__ int lowered;  // the block lowered a slot extra in this Bellman pass

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int kb0 = min(rank * Kb, K), nk = min(kb0 + Kb, K) - kb0;
  const int rb0 = min(rank * Rb, R), nr = min(rb0 + Rb, R) - rb0;
  const int sk = min(nk, Ks), sr = min(nr, Rs);  // staged slots and records
  const int slab_ints = 2 * Ks + 4 * Rs;
  int* const base = reinterpret_cast<int*>(smem4);
  float* const extra = reinterpret_cast<float*>(base + NBUF * slab_ints);
  float* const le = extra + Ks;
  // The extras of the slots and records past the staged ones.
  float* const extra_d = spill + (long)b * K + kb0;
  float* const le_d = spill + (long)B * K + (long)b * R + rb0;
  unsigned long long* const tab_a = table + (long)b * S;
  unsigned long long* const tab_b = table + ((long)B + b) * S;
  unsigned long long* const tab_e = table + (2L * B + b) * S;  // kEps only
  int* const tok_out = tok_rows + (long)b * (tok_cap + K) * 3;
  int* const em_out = em_rows + (long)b * (em_cap + R) * 3;
  int* const eps_out = eps_rows + (long)b * (eps_cap + DRe) * 3;

  // Contiguous per-thread ranges of the block's slots and records, so
  // that thread order is row order.  Only the thread that owns a slot or
  // record reads or writes its extra.
  const int perK = (nk + THREADS - 1) / THREADS;
  const int k0 = min(tid * perK, nk), k1 = min(k0 + perK, nk);
  const int perR = (nr + THREADS - 1) / THREADS;
  const int r0 = min(tid * perR, nr), r1 = min(r0 + perR, nr);
  // The block's eps records (kEps): a contiguous range, in contiguous
  // per-thread ranges, read from device memory.
  const int Eb = (DRe + C - 1) / C;
  const int eb0 = min(rank * Eb, DRe), ne = min(eb0 + Eb, DRe) - eb0;
  const int perE = (ne + THREADS - 1) / THREADS;
  const int j0 = min(tid * perE, ne), j1 = min(j0 + perE, ne);
  auto eps_record = [&](int t, int j) {
    return reinterpret_cast<const int4*>(eps)[((long)t * B + b) * DRe + eb0 + j];
  };
  // An eps record's le = extra(dst) + slack, from table A (+inf on padding).
  auto eps_le = [&](int t, int4 q) {
    return q.y >= 0 ? __fadd_rn(q.z >= 0 ? table_get(tab_a, q.z, t) : INFINITY,
                                __int_as_float(q.w))
                    : INFINITY;
  };

  // Frame t's slab into buffer t % NBUF (one thread).
  auto load_slab = [&](int t) {
    int* const slab = base + (t % NBUF) * slab_ints;
    uint64_t* const bar = &slab_full[t % NBUF];
    kdtorch::mbar_arrive_expect_tx(bar, (unsigned)(sk * 8 + sr * 16));
    const long s0 = ((long)t * B + b) * K + kb0;
    if (sk > 0) {
      kdtorch::bulk_load(slab, fstates + s0, sk * 4, bar);
      kdtorch::bulk_load(slab + Ks, fcosts + s0, sk * 4, bar);
    }
    if (sr > 0) {
      kdtorch::bulk_load(slab + 2 * Ks, em + (((long)t * B + b) * R + rb0) * 4, sr * 16, bar);
    }
  };
  unsigned parity = 0;  // bit i: the phase parity of the next wait on buffer i
  auto wait_slab = [&](int t) {
    kdtorch::mbar_wait(&slab_full[t % NBUF], (parity >> (t % NBUF)) & 1);
    parity ^= 1u << (t % NBUF);
  };
  // Slot k's state and cost, record r of frame t: staged, or in device memory.
  auto slot_state = [&](int t, int k) {
    return !kSpill || k < sk ? base[(t % NBUF) * slab_ints + k]
                             : fstates[((long)t * B + b) * K + kb0 + k];
  };
  auto slot_cost = [&](int t, int k) {
    return !kSpill || k < sk ? __int_as_float(base[(t % NBUF) * slab_ints + Ks + k])
                             : fcosts[((long)t * B + b) * K + kb0 + k];
  };
  auto record = [&](int t, int r) {
    return !kSpill || r < sr
               ? reinterpret_cast<const int4*>(base + (t % NBUF) * slab_ints + 2 * Ks)[r]
               : reinterpret_cast<const int4*>(em)[((long)t * B + b) * R + rb0 + r];
  };
  auto get_extra = [&](int k) { return !kSpill || k < sk ? extra[k] : extra_d[k]; };
  auto set_extra = [&](int k, float v) {
    if (!kSpill || k < sk) extra[k] = v; else extra_d[k] = v;
  };
  auto get_le = [&](int r) { return !kSpill || r < sr ? le[r] : le_d[r]; };
  auto set_le = [&](int r, float v) {
    if (!kSpill || r < sr) le[r] = v; else le_d[r] = v;
  };

  for (long s = (long)rank * THREADS + tid; s < S; s += (long)C * THREADS) {
    tab_a[s] = ~0ull;
    tab_b[s] = ~0ull;
    if (kEps) tab_e[s] = ~0ull;
  }
  if (tid == 0) {
    for (int i = 0; i < NBUF; ++i) kdtorch::mbar_init(&slab_full[i], 1);
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = T - 1; t >= max(T - NBUF, 0); --t) load_slab(t);
  }
  kdtorch::cluster_sync();  // the tables are initialised across the cluster
  wait_slab(T - 1);

  const int boundary = min(rem[b], T);  // token frame with extra == 0
  int tok_off = 0, em_off = 0, eps_off = 0;  // the same in every thread of the cluster
  bool ovf = false;
  int em_pos = 0;  // where this thread's first kept link of frame t+1 goes

  // Frame t's kept links as em rows, in this thread's record range.
  auto write_em_rows = [&](int t) {
    int pos = em_pos;
    for (int r = r0; r < r1; ++r) {
      if (get_le(r) < INFINITY) {
        const int4 q = record(t, r);
        int* row = em_out + (long)pos * 3;
        row[0] = t;
        row[1] = q.x;
        row[2] = q.y;
        ++pos;
      }
    }
  };

  for (int t = T - 1; t >= 0; --t) {
    const int f = t + 1;  // token-frame index of frontier[t]
    const bool at_boundary = f >= boundary;
    const bool emit = f <= boundary;  // frames past the boundary are frozen

    // Extras of frame f and its surviving tokens; the extras joined by
    // state into table A.  With eps links the tokens are counted once the
    // Bellman passes have refined the extras.
    int cnt = 0;
    for (int m = 0; m < perK; ++m) {  // the same trip count in every lane
      const int k = k0 + m;
      const bool mine = k < k1;
      const bool live = mine && isfinite(slot_cost(t, k));
      const float e = !mine ? INFINITY : at_boundary ? (live ? 0.0f : INFINITY) : get_extra(k);
      if (mine) set_extra(k, e);
      if (!kEps) cnt += emit && live && e <= tok_thr;
      table_min(tab_a, mine ? slot_state(t, k) : -1, t, e, mine);
    }
    int tok_pos = kEps ? 0 : publish_counts(cnt, tok_pre);
    // (1) table A complete, token counts published.  The output rows of
    // frame t+1's links go out between arrival and wait, so that the
    // barrier's release does not wait for them.
    kdtorch::cluster_arrive();
    if (t + 1 < T) write_em_rows(t + 1);
    kdtorch::cluster_wait();

    if constexpr (kEps) {
      // The eps Bellman within frame f.
      bool changed = true;  // the same in every thread of the cluster
      for (int it = 0; changed && it < eps_bound; ++it) {
        // (a) Each eps record's max(le, 0) joined by source state into E.
        for (int m = 0; m < perE; ++m) {  // the same trip count in every lane
          const int j = j0 + m;
          const int4 q = j < j1 ? eps_record(t, j) : make_int4(-1, -1, -1, 0);
          table_min(tab_e, q.x, t, fmaxf(eps_le(t, q), 0.0f), q.y >= 0);
        }
        kdtorch::cluster_sync();
        // (b) Slot extras lowered to E; the lowered ones joined into A.
        bool low = false;
        for (int m = 0; m < perK; ++m) {
          const int k = k0 + m;
          const bool mine = k < k1;
          const int s = mine ? slot_state(t, k) : -1;
          const float u = s >= 0 ? table_get(tab_e, s, t) : INFINITY;
          const bool lower = mine && u < get_extra(k);
          if (lower) set_extra(k, u);
          low |= lower;
          table_min(tab_a, s, t, u, lower);
        }
        const int any = __syncthreads_or(low);
        if (tid == 0) lowered = any;
        // (c) A complete for the next pass; the cluster's flags.
        kdtorch::cluster_sync();
        const int lane = tid & 31;
        changed = __any_sync(0xffffffffu, lane < C && *cluster.map_shared_rank(&lowered, lane));
      }
      ovf |= changed && emit;
      // The frame's tokens and eps links within the beam, counted.
      for (int k = k0; k < k1; ++k) {
        cnt += emit && isfinite(slot_cost(t, k)) && get_extra(k) <= tok_thr;
      }
      tok_pos = publish_counts(cnt, tok_pre);
      int ecnt = 0;
      for (int j = j0; j < j1; ++j) ecnt += emit && eps_le(t, eps_record(t, j)) <= em_thr;
      int eps_pos = publish_counts(ecnt, eps_pre);
      kdtorch::cluster_sync();
      const int2 ce = cluster_counts(cluster, eps_pre, rank, C);
      const int eoff_w = min(eps_off, eps_cap);
      eps_pos += eoff_w + ce.x + eps_pre[warp];
      const int enew = eoff_w + ce.y;
      ovf |= enew > eps_cap;
      eps_off = min(enew, eps_cap + DRe);
      for (int j = j0; j < j1; ++j) {
        const int4 q = eps_record(t, j);
        if (emit && eps_le(t, q) <= em_thr) {
          int* row = eps_out + (long)eps_pos * 3;
          row[0] = f;
          row[1] = q.x;
          row[2] = q.y;
          ++eps_pos;
        }
      }
    }

    int2 cc = cluster_counts(cluster, tok_pre, rank, C);
    int off_w = min(tok_off, tok_cap);
    tok_pos += off_w + cc.x + tok_pre[warp];
    int new_off = off_w + cc.y;
    ovf |= new_off > tok_cap;
    tok_off = min(new_off, tok_cap + K);

    // Each record's extra: its destination's, joined from table A, plus
    // its slack; a kept link's extra joined by source state into table B.
    cnt = 0;
#pragma unroll 4
    for (int m = 0; m < perR; ++m) {  // the same trip count in every lane
      const int r = r0 + m;
      const bool mine = r < r1;
      const int4 q = mine ? record(t, r) : make_int4(-1, -1, -1, 0);  // src, arc, dst, slack bits
      float v = INFINITY;
      if (q.y >= 0) v = __fadd_rn(q.z >= 0 ? table_get(tab_a, q.z, t) : INFINITY,
                                  __int_as_float(q.w));
      const bool keep = emit && v <= em_thr;
      const float l = keep ? fmaxf(v, 0.0f) : INFINITY;
      if (mine) set_le(r, l);
      table_min(tab_b, q.x, t, l, keep);
      cnt += keep;
    }
    em_pos = publish_counts(cnt, em_pre);
    // Every thread of the block is done with frame t+1's slab (its em rows
    // went out above): frame t-2's slab goes into its buffer.
    if (tid == 0 && t + 1 < T && t >= 2) {
      kdtorch::fence_proxy_async();
      load_slab(t - 2);
    }
    // (2) table B complete, record counts published; frame t's tokens go
    // out between arrival and wait.
    kdtorch::cluster_arrive();
    for (int k = k0; k < k1; ++k) {
      const float co = slot_cost(t, k);
      if (emit && isfinite(co) && get_extra(k) <= tok_thr) {
        int* row = tok_out + (long)tok_pos * 3;
        row[0] = f;
        row[1] = slot_state(t, k);
        row[2] = __float_as_int(co);
        ++tok_pos;
      }
    }
    kdtorch::cluster_wait();

    cc = cluster_counts(cluster, em_pre, rank, C);
    off_w = min(em_off, em_cap);
    em_pos += off_w + cc.x + em_pre[warp];
    new_off = off_w + cc.y;
    ovf |= new_off > em_cap;
    em_off = min(new_off, em_cap + R);

    // Base extras of frame t, joined on the previous frontier's slots.
    if (t > 0) wait_slab(t - 1);
    for (int k = k0; k < k1; ++k) {
      const int s = t > 0 ? slot_state(t - 1, k) : init_states[(long)b * K + kb0 + k];
      set_extra(k, s >= 0 ? table_get(tab_b, s, t) : INFINITY);
    }
  }
  // The others may still read this block's counts: its shared memory
  // stays until every block has arrived.
  kdtorch::cluster_arrive();
  write_em_rows(0);
  if (rank == 0 && tid == 0) {
    tok_count[b] = min(tok_off, tok_cap);
    em_count[b] = min(em_off, em_cap);
    eps_count[b] = min(eps_off, eps_cap);  // 0 without eps links
    overflow[b] = ovf;
  }
  kdtorch::cluster_wait();
}

// A block's ranges in a cluster of c blocks (Kb slots, a multiple of 4,
// and Rb records) and the part of them staged in shared memory: all of
// it when it fits in SMEM_BUDGET, else the slots first.
struct Ranges {
  int Kb, Rb, Ks, Rs;
  Ranges(int K, int R, int c) {
    Kb = ((K + c - 1) / c + 3) & ~3;
    Rb = (R + c - 1) / c;
    const int ints = SMEM_BUDGET / (int)sizeof(int);
    Ks = std::min(Kb, (ints / (2 * NBUF + 1)) & ~3);
    Rs = std::min(Rb, (ints - (2 * NBUF + 1) * Ks) / (4 * NBUF + 1));
  }
  size_t smem() const { return (size_t)(NBUF * (2 * Ks + 4 * Rs) + Ks + Rs) * sizeof(int); }
};

}  // namespace

// The cluster size K4 launches with for B utterances of K slots and R
// records a frame (kdtorch::pick_cluster); 0 when none fits.
extern "C" int kd_sweep_cluster(int B, int K, int R) {
  return kdtorch::pick_cluster(sweep_kernel<true, false>, B, THREADS, (long)K << 32 | R,
                               [K, R](int c) { return Ranges(K, R, c).smem(); });
}

// Launches the sweep of one chunk on `stream`, one cluster per utterance.
// Shapes: fstates/fcosts (T, B, K) with K a multiple of 4, em (T, B, R,
// 4), all three 16-byte aligned; init_states (B, K), rem (B,); scratch
// table (2, B, S) of 64-bit entries ((3, B, S) with eps records) and
// spill (B*K + B*R) floats; outputs tok_rows (B, tok_cap + K, 3), em_rows
// (B, em_cap + R, 3), tok_count/em_count (B,), overflow (B,) bytes.  With
// DRe = D * Re > 0 eps records, eps (T, B, D, Re, 4), 16-byte aligned, is
// read and eps_rows (B, eps_cap + DRe, 3) written; with DRe = 0 eps is
// not read and eps_rows not written.  eps_count (B,) is written either
// way (0 without eps links).  Returns the launch's CUDA error (0 on
// success).
extern "C" int kd_sweep(
    const void* fstates, const void* fcosts, const void* em,
    const void* init_states, const void* rem, int T, int B, int K, int R,
    int S, int tok_cap, int em_cap, float tok_thr, float em_thr, void* table, void* spill,
    void* tok_rows, void* em_rows, void* tok_count, void* em_count, void* overflow,
    const void* eps, int DRe, int eps_bound, int eps_cap, void* eps_rows, void* eps_count,
    void* stream) {
  const int C = kd_sweep_cluster(B, K, R);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  const Ranges g(K, R, C);
  const bool past_smem = g.Ks < g.Kb || g.Rs < g.Rb;
  auto kernel = DRe > 0 ? (past_smem ? sweep_kernel<true, true> : sweep_kernel<false, true>)
                        : (past_smem ? sweep_kernel<true, false> : sweep_kernel<false, false>);
  return (int)kdtorch::launch_cluster(
      kernel, B * C, C, THREADS, g.smem(), static_cast<cudaStream_t>(stream),
      fstates, fcosts, em, init_states, rem, T, B, K, R, S, g.Kb, g.Rb, g.Ks, g.Rs, tok_cap,
      em_cap, tok_thr, em_thr, table, spill, tok_rows, em_rows, tok_count, em_count, overflow,
      eps, DRe, eps_bound, eps_cap, eps_rows, eps_count);
}
