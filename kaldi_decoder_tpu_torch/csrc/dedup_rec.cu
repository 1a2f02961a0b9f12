// K2: the lattice frame's dedup by state, top-K frontier and lattice
// records, in one launch.
//
// Replaces the XLA-compiled region of the JAX package's lattice frame made
// of kaldi_decoder_tpu/ops/segment.py:dedup_select_rec (:177) with its
// _sort_by_state (:101) and _select (:136), in its two calls: the lattice
// emitting stage's (decoders/lattice_dev.py:257: need_idx=False,
// sweep_cols=True, no incumbents, payload (src_state, arc_id)) and each
// record-emitting eps iteration's (lattice_dev.py:164: num_incumbents=K,
// need_idx=True): the stable sort by (state, cost), top_k over the run
// leaders, the segmented fill of each run's minimum, the slack filter and
// the stable sort of the record keys.  Its plain torch version is
// kaldi_decoder_tpu_torch/ops/segment.py:dedup_select_rec; the two agree
// bitwise in every field.
//
// What it computes, per utterance of N lanes:
//   frontier  K6's (dedup.cu), from the same code (dedup_core.cuh): a
//             state's winner is its cheapest lane, the lowest among equal
//             costs, -0.0 equal to +0.0; the K cheapest winners in
//             (total-order cost, state) order, padded (0, +inf);
//             num_unique.  c_K is slot K-1's cost, +inf when fewer than K
//             states are live.
//   records   (R > K) a finite lane whose state's winner cost m (the
//             table word) is <= c_K is a winner link if it is the winner,
//             else an extra link if its slack fl(c - m) is <= slack_beam
//             (float32) and finite.  States tied with c_K that top-K
//             dropped keep their records (the original's boundary quirk,
//             segment.py:260-267).  Records are the winners in state
//             order, then the extras by (slack, state, cost, lane), -0.0
//             equal to +0.0 in slack and cost; the first min(R, eligible)
//             are written, the rest padded (-1, -1, -1, +inf);
//             rec_overflow is eligible > R.  (R <= K) the records are the
//             first R slots' winners, slack 0, and rec_overflow is
//             finite lanes > R.
//   Record rows are (src_state, arc_id, dst state, slack bits), written
//   straight into the (B, R, 4) int32 buffer the lattice frame emits;
//   slack is +0.0 for winners and for a -0.0 slack.
//   The eps call (the kernel's INCUMBENTS instance; the emitting call's
//   instance is compiled without any of it): lanes below num_incumbents
//   are the carried tokens.  They take part in the dedup and the frontier
//   as any lane (the lowest lane wins a tie, so an incumbent keeps its
//   slot against an equal-cost eps lane) but are never records: the
//   record pass skips them, and with R <= K a slot an incumbent won is a
//   padding row.  It also writes each slot's winning lane (cand_idx, -1 on
//   an empty slot).  On an unsharded eps iteration its STEP instance runs
//   the eps step (eps_step.cuh) as its last step: `changed` from each slot
//   it emits, each record row it writes copied into the iteration's row
//   (the block that writes row r_eps notes the spill), and after one more
//   cluster barrier the row's flags.  The sharded eps calls launch the
//   instance without it, whose registers the step would crowd, in its
//   ROUTED form: the lanes, their costs for the tie rule and the records'
//   payload read where the all_to_all left them (the K incumbents, then
//   the received (P, B, cap) entries; common.cuh:routed_entry), so that an
//   eps iteration has no receive launch.
//
// The record key.  A record's order is (class, slack, state, cost, lane),
// wider than 64 bits.  The key is (class, slack, state): a winner's is its
// state, an extra's 1 << 63 | folded slack bits << 32 | state; only an
// extra that shares its slack and state with another can tie, and the
// select core ranks equal keys by (cost with -0.0 folded, lane), which it
// reads from the lane costs only on a tie (RecTie).  So the keys of the
// (slack, state) groups of distinct costs, the case where the original's
// order differs from (slack, state, lane), come out in its order: cost
// 1.0 before nextafter(1.0, 2.0) when both have slack 1001.0 against a
// leader of -1000.0.
//
// The record digit (RecDigit).  The record pass sorts the keys into 1024
// fine bins (winners: 256 by state; extras: 768 of equal width in slack
// from 0 to slack_beam) and keeps each bin's count and key range (from
// 32-bit shared-memory atomics on the keys' halves); after a cluster
// barrier the blocks' bins are merged through distributed shared memory.
// A key's bucket is (keys in the bins below + its place in its bin,
// interpolated linearly in the bin's key range) * 1024 / records, monotone
// in the key.  The select core ranks a key by counting the smaller keys
// of its bucket, which grows with the square of the bucket's size, and
// the bench's keys are skewed in both halves: up to 2,644 extras of an
// utterance share one slack value (a bigram weight difference, over the
// word-start states), and their states crowd a few thousand ids under
// outliers tens of thousands away; no interpolating digit splits them
// (measured: buckets of up to 2,226 keys).  The select core ranks such a
// crowded bucket (more than sel::SORT_ABOVE = 128 keys) by sorting it
// alone: the block that owns its first place radix-sorts its keys over
// the bits in which they differ, the slack's and the state's apart (a
// bucket of a few slacks over a few thousand states takes two to four
// passes of 8 bits; sel::sort_bucket), then orders each run of equal
// keys by RecTie, the only place the lane costs are read.  A boundary
// bucket of up to half the stage, here 4096 of 8192 keys, is ranked at
// once rather than refined by further levels.  A crowded bucket larger
// than the stage (one the level's digit leaves whole below the boundary)
// is radix-sorted in device memory, in its own range of the select's
// spare buffer: the sort is linear in its size there too, where a
// further level would have to refine every bucket below the boundary and
// not only the boundary one.

// c_K.  The select core's emits come after its last cluster barrier, so
// slot K-1, written by whichever block ranks it, is read after one more.
//
// The winner table.  It is K6's table, kept per device and stream and all
// ones between calls (kernels/dedup.py); K2 shares it and leaves it all
// ones too.  Unlike K6, the winner pass does not restore a word: the
// record pass reads every touched state's word (m and the winning lane)
// after the frontier select.  Each block restores its winners' words
// after the cluster barrier that ends the record pass (with R <= K, after
// the frontier select), which every block passes only once every lane of
// the cluster has read the table; that frees the winners' cache for the
// record select's stage.
//
// What bounds it: it reads the N lanes' costs and the finite lanes'
// states once, and the payload of the records it writes
// (chip_smoke.k2_work); at the bench shape (B 16, N 56,832, K 4096,
// R 8192) at most 10.9 MB, 3.3 µs at the memory rate, and 6.74 MB, 2.0 µs
// on the lanes of the bench's lattice frame 150.  The eps call at the
// bench's unfolded shape (N 10,240, K 4096, R 6144) moves 3.13 MB, 0.9 µs,
// and takes 0.035 ms (H100 80GB HBM3 at 700 W, chip_smoke.py phase 2).  What holds it is its chain of dependent steps, each 1-3 µs (K6's
// min pass, barrier, winner pass and select; a barrier for c_K; the
// record pass over the block's compacted finite lanes, from shared memory
// and not the lane arrays again; two barriers for the bins; the record
// select), and on frames with large groups of equal slack the sort of the
// crowded buckets, by the blocks that own them.  One cluster launch per call, the cluster sized
// as K6's (common.cuh:pick_cluster, at least 1024 lanes a block, here at
// one block an SM); a launch the card refuses returns its CUDA error.
//
// Size: the finite lanes and winners are in shared memory up to 2048 each
// a block and the records up to 4096, the rest in device memory ((B, N + 256) scratch:
// four 64-bit and four 32-bit buffers); shared memory is 154 KB a block
// (one block an SM) whatever K, R, N and S.
//
// A sharded lattice frame without eps iterations (eps_iters 0, as on H)
// gives its emitting call the frame's local values to write
// (shard_reduce.cuh), as K6's emitting call takes them: slot 0's cost
// where the select emits slot 0 and, in rank 0's thread 0 beside
// rec_overflow, the row's count and its share of the batch's flag pair,
// with the row's own rec_overflow ORed into the emitting flags.  They had
// a launch of their own after the call.  It is an instance of its own
// (REDUCE): as a tail on a null pointer it cost the emitting instance a
// 4-byte spill (ptxas -v, scripts/ptxas_report.py).

#include <cooperative_groups.h>

#include "common.cuh"
#include "dedup_core.cuh"
#include "eps_step.cuh"
#include "select_core.cuh"
#include "shard_reduce.cuh"

namespace {

namespace cg = cooperative_groups;
namespace sel = kdtorch::select;
namespace dd = kdtorch::dedup;
namespace ep = kdtorch::eps;
namespace sr = kdtorch::shard_reduce;

constexpr int THREADS = 512;
constexpr int VCACHE = 2048;  // finite lanes a block keeps in shared memory
constexpr int CACHE = 2048;   // winners a block keeps in shared memory
constexpr int RCACHE = 4096;  // records a block keeps in shared memory
// The three caches' keys are one stage of STAGE keys for the record
// select, once the finite lanes and winners are done with.
constexpr int STAGE = VCACHE + CACHE + RCACHE;
constexpr int WBINS = 256;   // the record digit's fine bins for winners
constexpr int XBINS = 768;   // and for extras
constexpr int FINE = WBINS + XBINS;
constexpr int FPT = FINE / THREADS;  // fine bins a thread merges
constexpr size_t SMEM =
    (size_t)STAGE * (sizeof(unsigned long long) + sizeof(int)) + sizeof(sel::SortTables);
constexpr unsigned long long EXTRA = 1ull << 63;
constexpr unsigned INF_BITS = 0x7f800000u;

// The record digit.  A key's fine bin: a winner's (its key is its state)
// state >> shift_w; an extra's WBINS + its slack's bin of width 1 /
// scale_x.  Its bucket: (at[f] + its place in bin f, interpolated between
// the bin's smallest key lo[f] and largest) * NB / total.  Monotone in the
// key: an extra's key orders by slack first, the bins are monotone in it,
// and within a bin the place is.
struct RecDigit {
  int shift_w;
  float scale_x;
  double per_bucket;                  // NB / the row's records
  const int* n;                       // records per bin
  const int* at;                      // records in the bins below
  const unsigned long long* lo;       // the lower end of the bin's key range
  const unsigned long long* per_key;  // bits of the double n / (key range + 1)
  __device__ __forceinline__ int fine(unsigned long long k) const {
    if (!(k & EXTRA)) return (int)(k >> shift_w);
    const float slack = __uint_as_float((unsigned)(k >> 32) & 0x7fffffffu);
    return WBINS + min(XBINS - 1, (int)(slack * scale_x));
  }
  __device__ __forceinline__ int of(unsigned long long k) const {
    const int f = fine(k);
    const double x = (double)(k - lo[f]) * __longlong_as_double((long long)per_key[f]);
    const int place = at[f] + min(n[f] - 1, (int)x);
    return min(sel::NB - 1, (int)(place * per_bucket));
  }
};

// Equal record keys (extras of one slack and state) rank by (cost with
// -0.0 folded, lane).
template <class Lanes>
struct RecTie {
  Lanes lanes;  // the row's
  static constexpr bool on = true;
  __device__ bool operator()(int a, int b) const {
    const unsigned ka = kdtorch::ordered_key(lanes.cost_of(a));
    const unsigned kb = kdtorch::ordered_key(lanes.cost_of(b));
    return ka < kb || (ka == kb && a < b);
  }
};

template <bool INCUMBENTS, bool STEP, bool ROUTED, bool REDUCE>
__global__ void __launch_bounds__(THREADS, 1) dedup_rec_kernel(
    const int* __restrict__ dst, const float* __restrict__ cost, const int* __restrict__ pay0,
    const int* __restrict__ pay1, const __grid_constant__ kdtorch::Routed routed, int N, int S,
    int K, int R,
    float slack_beam,
    int num_incumbents, int* __restrict__ out_cand_idx,
    unsigned long long* __restrict__ table, unsigned long long* __restrict__ keys0,
    int* __restrict__ vals0, unsigned long long* __restrict__ keys1, int* __restrict__ vals1,
    unsigned long long* __restrict__ keys_fin, int* __restrict__ vals_fin,
    unsigned long long* __restrict__ keys_win, int* __restrict__ vals_win,
    int* __restrict__ out_states, float* __restrict__ out_costs, int* __restrict__ num_unique,
    int* __restrict__ rec, unsigned char* __restrict__ rec_overflow, const ep::Step step,
    const sr::Reduce red) {
  // Three lists, each (key, lane) in shared memory up to its cache and past
  // it in the block's region of a scratch buffer: the finite lanes (cost
  // bits << 32 | state), the winners (total-order cost << 32 | state), the
  // records (the record key).
  extern __shared__ unsigned long long smem_k[];
  unsigned long long* const fin_k = smem_k;
  unsigned long long* const win_k = fin_k + VCACHE;
  unsigned long long* const rec_k = win_k + CACHE;
  int* const fin_v = reinterpret_cast<int*>(rec_k + RCACHE);
  int* const win_v = fin_v + VCACHE;
  int* const rec_v = win_v + CACHE;
  sel::SortTables* const tables = reinterpret_cast<sel::SortTables*>(rec_v + RCACHE);
  __shared__ sel::Shared sh;
  // The record digit's fine bins: this block's count per bin and the
  // smallest and largest high and low halves of its keys (native 32-bit
  // atomics; (min high, min low) is at most the smallest key and (max
  // high, max low) at least the largest); then the cluster's count, keys
  // below, the lower end of the key range and the per-key scale
  // (RecDigit), the last two over the halves' arrays.
  __shared__ alignas(16) int bin_n[FINE];
  __shared__ alignas(16) int bin_at[FINE];
  __shared__ alignas(16) unsigned bin_half[4][FINE];  // min high, min low, max high, max low
  unsigned long long* const bin_lo = reinterpret_cast<unsigned long long*>(bin_half[0]);
  unsigned long long* const bin_scale = reinterpret_cast<unsigned long long*>(bin_half[2]);
  __shared__ int s_fin, s_total, s_rec;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const long row = (long)b * N;
  const long srow = (long)b * (N + dd::SCRATCH_PAD);
  const dd::LaneSplit ls(C, rank, N);
  const long spill = srow + (long)rank * ls.most;
  // The finite lanes and winners spill to buffers of their own: both
  // outlive the frontier select.  The records, the record select's input,
  // spill where K6's winners do.
  const dd::List fin{fin_k, fin_v, VCACHE, keys_fin + spill, vals_fin + spill};
  const dd::List win{win_k, win_v, CACHE, keys_win + spill, vals_win + spill};
  const dd::List recs{rec_k, rec_v, RCACHE, keys0 + spill, vals0 + spill};
  unsigned long long* const tab = table + (long)b * S;
  const long out0 = (long)b * K;
  const bool winners_only = R <= K;
  // The eps step's (the STEP instance, an eps call): `ran`, read before
  // anything is written; the block's `changed` and spill flags; the
  // cluster's, in rank 0's parts.
  static_assert(INCUMBENTS || !STEP, "the eps step follows an eps call");
  static_assert(INCUMBENTS || !ROUTED, "routed lanes are a sharded eps call's");
  static_assert(!(STEP && ROUTED), "the sharded eps calls run no step");
  static_assert(!(REDUCE && INCUMBENTS), "the local values are the emitting call's");
  const auto lanes = dd::row_lanes<ROUTED>(dst, cost, pay0, pay1, row, routed, b);
  __shared__ int s_any[2], s_parts[ep::MAX_CLUSTER];
  const bool ran = STEP ? ep::read_ran(step) : true;
  if (STEP && tid == 0) s_any[0] = s_any[1] = 0;  // before the core's first barrier
  // This block's winners restore their table words, once every lane of
  // the cluster has read the table.
  auto restore_table = [&]() {
    const int nwin = sh.count;
    for (int e = tid; e < nwin; e += THREADS) tab[(unsigned)win.key(e)] = dd::EMPTY;
  };
  auto put_rec = [&](int r, int p0, int p1, int d, unsigned slack_bits) {
    const int4 v = make_int4(p0, p1, d, (int)slack_bits);
    *reinterpret_cast<int4*>(rec + ((long)b * R + r) * 4) = v;
    if constexpr (STEP) ep::record(step, b, r, v, ran, s_any);
  };

  // 1-3. The frontier; with R <= K its first R slots are the records.
  auto emit = [&](int r, unsigned long long key, int lane) {
    const int d = (int)(key & 0xffffffffull);
    const float c = kdtorch::from_ordered_key((unsigned)(key >> 32));
    out_states[out0 + r] = d;
    out_costs[out0 + r] = c;
    if constexpr (REDUCE) {
      if (r == 0) sr::first_slot(red, b, c);
    }
    if constexpr (INCUMBENTS) {
      out_cand_idx[out0 + r] = lane;
      if (STEP && lane >= K && isfinite(c)) s_any[0] = 1;  // won by an eps lane
    }
    if (winners_only && r < R) {
      if (INCUMBENTS && lane < num_incumbents) {
        put_rec(r, -1, -1, -1, INF_BITS);
      } else {
        const int2 p = lanes.payload(lane);
        put_rec(r, p.x, p.y, d, 0u);
      }
    }
  };
  // The record list's cache is free until the record pass: the stage.
  const int n = dd::frontier<THREADS, true>(sh, cluster, ls, lanes, N, S, K, tab, false,
                                            fin, win, &s_fin, &s_total, keys0 + srow,
                                            vals0 + srow, keys1 + srow, vals1 + srow, rec_k,
                                            rec_v, RCACHE, tables, emit);
  for (int r = min(n, K) + rank * THREADS + tid; r < K; r += C * THREADS) {
    out_states[out0 + r] = 0;
    out_costs[out0 + r] = INFINITY;
    if constexpr (INCUMBENTS) out_cand_idx[out0 + r] = -1;
  }
  if (rank == 0 && tid == 0) num_unique[b] = n;
  sel::mark_step(11);

  int taken, eligible;
  if (winners_only) {
    taken = min(n, R);
    eligible = s_total;
  } else {
    // 4. The record pass over this block's finite lanes.  The select's
    // emits come after its last cluster barrier, so one more makes slot
    // K-1 visible to every block; no block reads this block's histogram
    // any more.
    sel::sync_blocks(C);
    sel::mark_step(12);
    const float c_k = n >= K && K > 0 ? out_costs[out0 + K - 1] : INFINITY;
    for (int q = tid; q < sel::NB; q += THREADS) sh.hist[q] = 0;
    for (int f = tid; f < FINE; f += THREADS) {
      bin_n[f] = 0;
      bin_half[0][f] = bin_half[1][f] = 0xffffffffu;
      bin_half[2][f] = bin_half[3][f] = 0;
    }
    if (tid == 0) s_rec = 0;
    RecDigit dig{max(0, sel::bit_length((unsigned long long)(S - 1)) - 8), 0.0f, 0.0,
                 bin_n, bin_at, bin_lo, bin_scale};
    const float scale_x = (float)XBINS / slack_beam;
    dig.scale_x = slack_beam > 0.0f && isfinite(scale_x) ? scale_x : 0.0f;
    __syncthreads();
    const int nfin = s_fin;
    for (int e0 = 0; e0 < nfin; e0 += THREADS * dd::UNROLL) {
      unsigned long long f[dd::UNROLL], w[dd::UNROLL];
      int lane[dd::UNROLL];
#pragma unroll
      for (int u = 0; u < dd::UNROLL; ++u) {
        const int e = e0 + u * THREADS + tid;
        f[u] = e >= nfin ? dd::EMPTY : fin.key(e);
        lane[u] = e >= nfin ? -1 : fin.val(e);
      }
#pragma unroll
      for (int u = 0; u < dd::UNROLL; ++u) w[u] = f[u] != dd::EMPTY ? tab[(unsigned)f[u]] : 0;
#pragma unroll
      for (int u = 0; u < dd::UNROLL; ++u) {
        const float c = __uint_as_float((unsigned)(f[u] >> 32));
        const int d = (int)(unsigned)f[u];
        const float m = kdtorch::from_ordered_key((unsigned)(w[u] >> 32));
        const bool is_win = w[u] == dd::min_key(c, lane[u]);
        const float slack = __fsub_rn(c, m);
        const bool take = f[u] != dd::EMPTY && m <= c_k &&
                          (!INCUMBENTS || lane[u] >= num_incumbents) &&
                          (is_win || (slack <= slack_beam && isfinite(slack)));
        const unsigned long long key =
            is_win ? (unsigned long long)(unsigned)d
                   : EXTRA | ((unsigned long long)__float_as_uint(kdtorch::canon_zero(slack)) << 32) |
                         (unsigned)d;
        const int pos = sel::append_slot(&s_rec, take);
        const int bin = take ? dig.fine(key) : 0;
        if (take) {
          recs.put(pos, key, lane[u]);
          atomicMin(&bin_half[0][bin], (unsigned)(key >> 32));
          atomicMin(&bin_half[1][bin], (unsigned)key);
          atomicMax(&bin_half[2][bin], (unsigned)(key >> 32));
          atomicMax(&bin_half[3][bin], (unsigned)key);
        }
        sel::run_add(bin_n, bin, take);
      }
    }
    sel::mark_step(13);
    sel::sync_blocks(C);  // every lane has read the table; every block's bins are counted
    sel::mark_step(14);
    restore_table();

    // The cluster's bins: every block's counts and key halves read at
    // once (two bins a thread), the counts' exclusive prefix; after a
    // second barrier (no block reads this block's bins any more) they
    // replace this block's own.
    static_assert(FPT == 2, "two bins a thread");
    int2 tot = make_int2(0, 0);
    uint2 half[4] = {make_uint2(~0u, ~0u), make_uint2(~0u, ~0u), make_uint2(0, 0),
                     make_uint2(0, 0)};
    {
      int2 vn[sel::MAX_CLUSTER];
      uint2 vh[sel::MAX_CLUSTER][4];
#pragma unroll
      for (int i = 0; i < sel::MAX_CLUSTER; ++i) {  // every load issued before any is used
        const int src = i < C ? i : rank;
        vn[i] = *reinterpret_cast<const int2*>(cluster.map_shared_rank(bin_n, src) + tid * FPT);
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          vh[i][h] = *reinterpret_cast<const uint2*>(
              cluster.map_shared_rank(bin_half[h], src) + tid * FPT);
        }
      }
#pragma unroll
      for (int i = 0; i < sel::MAX_CLUSTER; ++i) {
        if (i < C) {
          tot.x += vn[i].x;
          tot.y += vn[i].y;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            half[h] = make_uint2(min(half[h].x, vh[i][h].x), min(half[h].y, vh[i][h].y));
            half[h + 2] =
                make_uint2(max(half[h + 2].x, vh[i][h + 2].x), max(half[h + 2].y, vh[i][h + 2].y));
          }
        }
      }
    }
    int total;
    int p = kdtorch::block_exclusive_scan(tot.x + tot.y, sh.scan_tmp, &total);
    dig.per_bucket = (double)sel::NB / max(1, total);
    sel::mark_step(15);
    sel::sync_blocks(C);
#pragma unroll
    for (int j = 0; j < FPT; ++j) {
      const int f = tid * FPT + j;
      const int cnt = j == 0 ? tot.x : tot.y;
      const unsigned long long lo =
          ((unsigned long long)(j == 0 ? half[0].x : half[0].y) << 32) | (j == 0 ? half[1].x : half[1].y);
      const unsigned long long hi =
          ((unsigned long long)(j == 0 ? half[2].x : half[2].y) << 32) | (j == 0 ? half[3].x : half[3].y);
      bin_n[f] = cnt;
      bin_at[f] = p;
      p += cnt;
      // bin_lo and bin_scale overlay the halves, which no block reads now.
      bin_lo[f] = lo;
      bin_scale[f] = (unsigned long long)__double_as_longlong(
          cnt > 0 ? cnt / ((double)(hi - lo) + 1.0) : 0.0);
    }
    __syncthreads();
    sel::mark_step(16);
    // This block's histogram of its records under the digit.
    const int nrec = s_rec;
    for (int e0 = 0; e0 < nrec; e0 += THREADS) {
      const int e = e0 + tid;
      sel::run_add(sh.hist, e < nrec ? dig.of(recs.key(e)) : 0, e < nrec);
    }
    __syncthreads();
    sel::mark_step(17);

    // 5. The R smallest record keys, in order.  The three caches are the
    // stage (the records' own is free once they are scattered), so a
    // boundary bucket of up to STAGE / 2 keys is ranked at once, and a
    // crowded one sorted in shared memory: the digit can leave one slack
    // value of thousands of extras (and a few others) in one bucket, which
    // further levels would split only a few keys at a time.  The select's
    // steps are marked from 18 on.
    auto remit = [&](int r, unsigned long long key, int lane) {
      const unsigned slack_bits = key & EXTRA ? (unsigned)(key >> 32) & 0x7fffffffu : 0u;
      const int2 p = lanes.payload(lane);
      put_rec(r, p.x, p.y, (int)(unsigned)key, slack_bits);
    };
    eligible = sel::select_smallest<THREADS, true>(
        sh, cluster, recs.entries(s_rec), keys0 + srow, vals0 + srow, keys1 + srow, vals1 + srow,
        fin_k, fin_v, STAGE, tables, dig, R, remit, RecTie<decltype(lanes)>{lanes}, 18);
    taken = min(eligible, R);
  }
  for (int r = taken + rank * THREADS + tid; r < R; r += C * THREADS) put_rec(r, -1, -1, -1, INF_BITS);
  if (rank == 0 && tid == 0) {
    rec_overflow[b] = eligible > R;
    if constexpr (REDUCE) sr::finish(red, b, (int)(gridDim.x / C), n, K, eligible > R);
  }
  if (winners_only) restore_table();  // the frontier select's first barrier is passed
  if constexpr (STEP) {
    ep::finish(step, cluster, b, (int)(gridDim.x / C), ran, s_any, s_parts, n > K,
               eligible > R);
  }
  sel::mark_step(23, false, true);
}

// The instance of K2 a call launches: with incumbents (the eps call) or
// without; with incumbents, with the eps step as its last step (an
// unsharded eps call), on routed lanes (a sharded eps call) or neither;
// without, with a sharded frame's local values as its last step (`reduce`:
// an instance of its own, since the tail cost the emitting instance a
// 4-byte spill) or not.
decltype(&dedup_rec_kernel<false, false, false, false>) rec_instance(bool incumbents, bool step,
                                                                     bool routed, bool reduce) {
  return !incumbents ? (reduce ? dedup_rec_kernel<false, false, false, true>
                               : dedup_rec_kernel<false, false, false, false>)
         : step      ? dedup_rec_kernel<true, true, false, false>
         : routed    ? dedup_rec_kernel<true, false, true, false>
                     : dedup_rec_kernel<true, false, false, false>;
}

}  // namespace

// The cluster size K2 launches with for B utterances of N lanes, in the
// instance that `incumbents`, `step` and `routed` (nonzero: the eps call,
// and with it the eps step or routed lanes) or `reduce` (nonzero: an
// emitting call with a sharded frame's local values) pick: K6's rule
// (dedup.cu:kd_dedup_cluster) with K2's shared memory; 0 when none fits.
extern "C" int kd_dedup_rec_cluster(int B, int N, int incumbents, int step, int routed,
                                    int reduce) {
  const int most = dd::cluster_cap(N);
  return kdtorch::pick_cluster(rec_instance(incumbents, step, routed, reduce), B, THREADS, most,
                               [](int) { return SMEM; }, most);
}

// The last K2 launch's step marks (sel::read_marks; the steps are
// kernels/dedup_rec.py STEPS).
extern "C" int kd_dedup_rec_marks(unsigned long long* ns, long long* clock, int* clock_khz,
                                  int blocks) {
  return sel::read_marks(ns, clock, clock_khz, blocks);
}

// Launches K2 on `stream`.  Shapes: dst/cost/pay0/pay1 (B, N); table
// (B, S) 64-bit words, all ones on entry and restored on return; scratch
// keys0/keys1/keys_fin/keys_win (B, N + 256) 64-bit and the four vals
// (B, N + 256) 32-bit; outputs states/costs (B, K), num_unique (B,),
// rec (B, R, 4) int32, rec_overflow (B,) bool.  num_incumbents > 0 (the
// eps call: the first lanes are carried tokens, not links) launches the
// INCUMBENTS instance, which also writes cand_idx (B, K) int32; with 0,
// cand_idx is not touched and may be null.  `step`: null, or (with
// num_incumbents == K) a host pointer to the eps step of an eps iteration
// (kdtorch::eps::Step; width r_eps < R, out (B, D, r_eps, 4) int32), which
// the INCUMBENTS instance then runs as its last step; `routed`: null, or
// (with num_incumbents the routed lanes' K) a host pointer to
// kdtorch::Routed, a sharded eps call's lanes and payload, N = K + P *
// cap, read in place (dst, cost, pay0, pay1 may then be null).
// `reduce`: null, or (an emitting call: no incumbents) a host pointer to
// the sharded frame's local values (kdtorch::shard_reduce::Reduce, as
// kd_dedup takes it; the call's own rec_overflow is folded into the
// flags).  `clusters`: 0 (kd_dedup_rec_cluster's choice) or 1, 2, 4, 8
// blocks a row, at most dd::cluster_cap(N).  Returns the launch's CUDA
// error (0 on success).
extern "C" int kd_dedup_rec(const void* dst, const void* cost, const void* pay0,
                            const void* pay1, int B, int N, int S, int K, int R, float slack_beam,
                            int num_incumbents, void* table, void* keys0, void* vals0,
                            void* keys1, void* vals1, void* keys_fin, void* vals_fin,
                            void* keys_win, void* vals_win, void* states, void* costs,
                            void* num_unique, void* rec, void* rec_overflow, void* cand_idx,
                            const void* routed, const void* step, const void* reduce,
                            int clusters, void* stream) {
  const ep::Step st = ep::step_of(step);
  if (st.on() && (routed != nullptr || num_incumbents != K || B > ep::MAX_ROWS ||
                  st.width < 1 || st.width >= R || st.d < 0 || st.d >= st.D))
    return (int)cudaErrorInvalidValue;
  const kdtorch::Routed rt = kdtorch::routed_of(routed);
  if (routed != nullptr && (num_incumbents != rt.K || num_incumbents == 0 ||
                            !kdtorch::routed_fits(rt, B, N)))
    return (int)cudaErrorInvalidValue;
  const sr::Reduce rd = sr::reduce_of(reduce);
  if (rd.on() && (num_incumbents != 0 || B > sr::MAX_ROWS || rd.count == nullptr ||
                  reinterpret_cast<uintptr_t>(rd.count) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (clusters < 0 || clusters > dd::cluster_cap(N) || (clusters & (clusters - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int C = clusters > 0 ? clusters
                             : kd_dedup_rec_cluster(B, N, num_incumbents != 0, st.on(),
                                                    routed != nullptr, rd.on());
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  return (int)kdtorch::launch_cluster(
      rec_instance(num_incumbents != 0, st.on(), routed != nullptr, rd.on()), B * C, C, THREADS,
      SMEM,
      static_cast<cudaStream_t>(stream),
      (const int*)dst, (const float*)cost, (const int*)pay0, (const int*)pay1, rt, N, S, K, R,
      slack_beam, num_incumbents, (int*)cand_idx, (unsigned long long*)table,
      (unsigned long long*)keys0, (int*)vals0,
      (unsigned long long*)keys1, (int*)vals1, (unsigned long long*)keys_fin, (int*)vals_fin,
      (unsigned long long*)keys_win, (int*)vals_win, (int*)states, (float*)costs,
      (int*)num_unique, (int*)rec, (unsigned char*)rec_overflow, st, rd);
}
