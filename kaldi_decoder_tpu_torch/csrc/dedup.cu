// K6: Viterbi dedup by state + top-K frontier selection, with the winning
// candidate lane of each slot.
//
// Replaces the XLA-compiled region of the JAX package's Viterbi frame made
// of kaldi_decoder_tpu/ops/segment.py:dedup_select (:160) with its
// _sort_by_state (:101, need_idx=True) and _select (:136): the stable
// 2-key sort by (state, cost) with the candidate index riding along, the
// run leaders, and lax.top_k over the leader costs.  It serves the
// emitting stage (decoders/frontier.py:frame_emit_stage) and every eps
// iteration (eps_iteration, with the K incumbents as the first lanes).
// Its plain torch version is kaldi_decoder_tpu_torch/ops/segment.py:
// dedup_select, and the two agree slot for slot, bitwise.  Steps 1-3
// below are dedup_core.cuh's code, which K2 (dedup_rec.cu) shares.
//
// The tie rules are the original's: a state's winner is its cheapest
// lane, the lowest lane among equal costs, with -0.0 equal to +0.0 (the
// stable sort, whose comparator folds -0.0 onto +0.0; it is also what
// lets incumbents win ties); the frontier is ordered by (cost, state)
// ascending (top_k keeps the lower index among equal values, and an index
// of the state-sorted array ranks by state), where top_k's float order
// puts -0.0 below +0.0.  So a winner's key is (total-order cost bits << 32
// | state): unique, its order is the frontier's, and it holds the winning
// lane's cost bit for bit.
//
// What bounds it: per utterance it reads the N candidate lanes (8 bytes
// each), does one 8-byte atomicMin per finite lane into a per-utterance
// table of S words (held in L2), and moves the winners (12 bytes each)
// through shared and device memory; at the bench shape (B=16, N = 56,832,
// K 4096) a few MB, mostly L2 traffic (the bound is about 1.4 µs), so what
// holds it is the chain of dependent steps, each about 1-3 µs on the H100:
// memory round trips, warp collectives and barriers.  One launch: a thread
// block cluster of C blocks per utterance (csrc/common.cuh:pick_cluster,
// at most 8 and at most the count that leaves a block 1024 lanes).  The
// lanes go to the blocks in chunks of 32, round robin: K1 writes the
// active slots' lanes first, so C ranges would give the first block most
// of the finite lanes (measured: 4615 of 6958 in one utterance).
//   1. min     — a finite lane does a 64-bit atomicMin of (ordered cost
//                bits << 32 | lane) into table[b, dst] and is appended to
//                its block's list of finite lanes; the block keeps their
//                smallest and largest total-order cost key.  A cluster
//                barrier, and every block reads the cluster's range
//                through distributed shared memory.
//   2. winners — a finite lane (from the list, not the lane arrays again)
//                whose key is its state's table word is the winner: it
//                restores the word to all ones, appends (key, lane) to its
//                block's list and adds to the block's histogram of the
//                first digit.
//   3. select  — the select core (csrc/select_core.cuh) keeps the K
//                smallest keys in order; the slots get the states, the
//                costs decoded from the keys and the lanes, and are padded
//                with (0, +inf, -1).
// Both lists are in shared memory up to 2048 entries a block, the rest in
// device memory.  How the design meets what held the one-block design back:
//   * SMs: C blocks per utterance (8 at B=16's emitting call), the
//     histograms merged through distributed shared memory; a launch the
//     card refuses returns its CUDA error.
//   * Passes and contention: the first digit is (key - key of the
//     utterance's cheapest cost) >> shift, with the shift that fits the
//     utterance's cost range (and, for one cost, its states) into 1024
//     buckets: a monotone function of the key, so the buckets hold few keys
//     (measured on the bench's calls: at most 110, the K-th key's at most
//     65).  Its histogram is built where the winners are found,
//     private to each block in shared memory, and a warp's neighbouring
//     lanes with the same digit add once (select_core.cuh:run_add), so
//     equal digits do not serialise.  Only the boundary bucket is refined,
//     and only while it holds more than half the 4096-key stage and is not
//     kept whole; each refining level takes its digit from the bucket's own
//     key range, so all-equal costs resolve by state at once and any input
//     in a few levels.
//   * Order: a counting scatter by the digit's prefix puts every kept key
//     in its bucket's range; each key's place inside its bucket is the
//     number of smaller keys there, counted in shared memory by the block
//     that owns the place, in every bucket: K6 does not sort a crowded one
//     (over 128 keys) as K2 does, whose sort's registers cost K6, at 64 a
//     thread for two blocks an SM, 3.5-6% a call (measured); the count
//     grows with the square of a bucket's size, and the bench's calls have
//     buckets of at most 110 keys at frame 150.
//   * Size: what passes the shared-memory lists, and the scattered keys,
//     live in device memory ((B, N + 256) scratch, two buffers used in
//     turns); shared memory is 65 KB a block whatever K, N and S.
//   * The table is not filled per call: every state touched has exactly
//     one winner, which restores its word, so the wrapper keeps the table
//     per device and stream, filled once (kernels/dedup.py).
// Lanes with +inf (or NaN) cost never touch the table, so their dst may
// be anything.  N may be smaller than K, and than S.
//
// The eps call's instance (STEP) also runs the eps step (eps_step.cuh) as
// its last step: each slot's backpointer where the slot is written, then
// the row's flags after one more cluster barrier.  The emitting calls
// launch the instance without it.  The sharded closure's eps calls launch
// the ROUTED instance, which reads its lanes where the all_to_all left
// them (the K incumbents, then the received (P, B, cap) entries;
// common.cuh:routed_entry): the layout K7's receive side wrote for it, so
// that an eps iteration has no receive launch.  A routed lane reads 8 of
// its entry's 16 bytes, (state, cost), and the winners' K of them.
//
// A sharded frame without eps iterations (eps_iters 0, as on H) gives its
// emitting call the frame's local values to write (shard_reduce.cuh): the
// emitting instance, on a null-pointer test, writes slot 0's cost where it
// emits slot 0 and, in rank 0's thread 0 beside num_unique, the row's
// count and its share of the batch's flag pair, which had a launch of
// their own after the call.  The eps instances are compiled without it.

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
constexpr size_t SMEM = (size_t)(VCACHE + CACHE) * (sizeof(unsigned long long) + sizeof(int));

template <bool STEP, bool ROUTED>
__global__ void __launch_bounds__(THREADS, 2) dedup_kernel(
    const int* __restrict__ dst, const float* __restrict__ cost,
    const __grid_constant__ kdtorch::Routed routed,
    int N, int S, int K,
    unsigned long long* __restrict__ table, unsigned long long* __restrict__ keys0,
    int* __restrict__ vals0, unsigned long long* __restrict__ keys1, int* __restrict__ vals1,
    int* __restrict__ out_states, float* __restrict__ out_costs, int* __restrict__ out_idx,
    int* __restrict__ num_unique, const ep::Step step, const sr::Reduce red) {
  // The block's finite lanes (cost bits << 32 | state, lane) and its
  // winners (key, lane), each in shared memory up to its cache and past it
  // in the block's region of a scratch buffer.
  extern __shared__ unsigned long long smem_k[];
  int* const smem_v = reinterpret_cast<int*>(smem_k + VCACHE + CACHE);
  __shared__ sel::Shared sh;
  __shared__ int s_fin;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const long row = (long)b * N;
  const long srow = (long)b * (N + dd::SCRATCH_PAD);
  const dd::LaneSplit ls(C, rank, N);
  const long spill = srow + (long)rank * ls.most;
  // The finite lanes' spill is free until the scatter, which is done with it.
  const dd::List fin{smem_k, smem_v, VCACHE, keys1 + spill, vals1 + spill};
  const dd::List win{smem_k + VCACHE, smem_v + VCACHE, CACHE, keys0 + spill, vals0 + spill};

  // The eps step's: `ran`, read before anything is written; the block's
  // `changed`; the cluster's, in rank 0's parts.
  __shared__ int s_any[2], s_parts[ep::MAX_CLUSTER];
  const bool ran = STEP ? ep::read_ran(step) : true;
  if (STEP && tid == 0) s_any[0] = s_any[1] = 0;  // before the core's first barrier

  const long out0 = (long)b * K;
  auto emit = [&](int r, unsigned long long key, int lane) {
    const float c = kdtorch::from_ordered_key((unsigned)(key >> 32));
    out_states[out0 + r] = (int)(key & 0xffffffffull);
    out_costs[out0 + r] = c;
    out_idx[out0 + r] = lane;
    if constexpr (STEP) ep::backpointer(step, b, K, N, r, lane, ran, s_any);
    if constexpr (!STEP && !ROUTED) {
      if (r == 0 && red.on()) sr::first_slot(red, b, c);
    }
  };
  // Both caches are free once the winners are scattered: the core's stage.
  static_assert(!(STEP && ROUTED), "the sharded eps calls run no step");
  const auto lanes = dd::row_lanes<ROUTED>(dst, cost, nullptr, nullptr, row, routed, b);
  const int n = dd::frontier<THREADS, false>(sh, cluster, ls, lanes, N, S, K,
                                             table + (long)b * S, true, fin, win, &s_fin, nullptr,
                                             keys0 + srow, vals0 + srow, keys1 + srow,
                                             vals1 + srow, smem_k, smem_v, VCACHE + CACHE,
                                             nullptr, emit);
  for (int r = min(n, K) + rank * THREADS + tid; r < K; r += C * THREADS) {
    out_states[out0 + r] = 0;
    out_costs[out0 + r] = INFINITY;
    out_idx[out0 + r] = -1;
    if constexpr (STEP) ep::empty_slot(step, b, K, r, ran);
  }
  if (rank == 0 && tid == 0) {
    num_unique[b] = n;
    if constexpr (!STEP && !ROUTED) {
      if (red.on()) sr::finish(red, b, (int)(gridDim.x / C), n, K, false);
    }
  }
  if constexpr (STEP) {
    ep::finish(step, cluster, b, (int)(gridDim.x / C), ran, s_any, s_parts, n > K, false);
  }
  sel::mark_step(11, false, true);
}

// The instance of K6 a call launches: with the eps step as its last step
// (an unsharded eps call), on routed lanes (a sharded eps call), or on
// flat lanes without the step.
decltype(&dedup_kernel<false, false>) instance(bool step, bool routed) {
  return step ? dedup_kernel<true, false> : routed ? dedup_kernel<false, true>
                                                   : dedup_kernel<false, false>;
}

}  // namespace

// The cluster size K6 launches with for B utterances of N lanes, in the
// instance that `step` (nonzero: with the eps step) and `routed` (nonzero:
// on routed lanes) pick (kdtorch::pick_cluster, at most
// dd::cluster_cap(N)); 0 when none fits.  The emitting instance takes the
// same whether or not it writes a sharded frame's local values.
extern "C" int kd_dedup_cluster(int B, int N, int step, int routed) {
  const int most = dd::cluster_cap(N);
  return kdtorch::pick_cluster(instance(step, routed), B, THREADS, most,
                               [](int) { return SMEM; }, most);
}

// The last K6 launch's step marks (sel::read_marks; the steps are
// kernels/dedup.py STEPS).
extern "C" int kd_dedup_marks(unsigned long long* ns, long long* clock, int* clock_khz,
                              int blocks) {
  return sel::read_marks(ns, clock, clock_khz, blocks);
}

// Launches K6 on `stream`.  Shapes: dst/cost (B, N), or null with `routed`
// (a host pointer to kdtorch::Routed: a sharded eps call's lanes, N = K +
// P * cap, read in place); table (B, S) 64-bit words, all ones on entry
// and restored on return; scratch keys0/keys1 (B, N + 256) 64-bit and
// vals0/vals1 (B, N + 256); outputs states/costs/cand_idx (B, K),
// num_unique (B,).  `step`: null, or a host pointer to the eps
// step of an eps iteration (kdtorch::eps::Step; its src_slot/arc_id are
// the (B, N) lanes' and its out (B, D, K, 2) int32), which the STEP
// instance runs as its last step.  `reduce`: null, or with neither step
// nor routed lanes (an emitting call) a host pointer to the sharded
// frame's local values (kdtorch::shard_reduce::Reduce: red_min (B,)
// float32, red_count (B,) int32, red_flags (2,) int32, its count word
// (1,) 64-bit, 0 on entry and on return, 8-byte aligned; up to three
// (B,) bool overflow flags or null), written as the call's last step;
// B < 2^16.  `clusters`: 0 (kd_dedup_cluster's choice) or 1, 2, 4, 8
// blocks a row, at most dd::cluster_cap(N).  Returns the launch's CUDA
// error (0 on success).
extern "C" int kd_dedup(const void* dst, const void* cost, int B, int N, int S, int K,
                        void* table, void* keys0, void* vals0, void* keys1, void* vals1,
                        void* states, void* costs, void* cand_idx, void* num_unique,
                        const void* routed, const void* step, const void* reduce, int clusters,
                        void* stream) {
  const ep::Step st = ep::step_of(step);
  if (st.on() && (routed != nullptr || B > ep::MAX_ROWS || st.width != K || st.d < 0 ||
                  st.d >= st.D))
    return (int)cudaErrorInvalidValue;
  const sr::Reduce rd = sr::reduce_of(reduce);
  if (rd.on() && (st.on() || routed != nullptr || B > sr::MAX_ROWS || rd.count == nullptr ||
                  reinterpret_cast<uintptr_t>(rd.count) % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (clusters < 0 || clusters > dd::cluster_cap(N) || (clusters & (clusters - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const kdtorch::Routed rt = kdtorch::routed_of(routed);
  if (routed != nullptr && !kdtorch::routed_fits(rt, B, N)) return (int)cudaErrorInvalidValue;
  const int C = clusters > 0 ? clusters : kd_dedup_cluster(B, N, st.on(), routed != nullptr);
  if (C == 0) return (int)cudaErrorInvalidConfiguration;
  return (int)kdtorch::launch_cluster(
      instance(st.on(), routed != nullptr), B * C, C, THREADS, SMEM,
      static_cast<cudaStream_t>(stream), (const int*)dst, (const float*)cost, rt, N, S, K,
      (unsigned long long*)table, (unsigned long long*)keys0, (int*)vals0,
      (unsigned long long*)keys1, (int*)vals1, (int*)states, (float*)costs, (int*)cand_idx,
      (int*)num_unique, st, rd);
}
