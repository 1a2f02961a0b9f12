// K3: the frame tail of the chunk loop, and the chunk's first-frame set-up.
//
// Replaces the XLA-compiled glue of the JAX package's frame, which the
// jitted lax.scan over a chunk ran without the host:
//   - GetCutoff on the sorted frontier (kaldi_decoder_tpu/ops/cutoff.py:36
//     get_cutoff): the count of finite costs, the best cost, the
//     max_active / min_active / beam branch, cutoff and adaptive_beam;
//   - the rebase and the freeze (decoders/lattice_dev.py:394-405; Viterbi
//     decoders/frontier.py:639 _frame_finish): m_safe is the row's best
//     cost, or 0 when it is not finite; costs - m_safe, base + m_safe; a
//     row whose utterance has ended (t >= lengths) keeps its state;
//   - the frame's outputs (lattice_dev.py:406-424; frontier.py:695
//     frame_step_batched's tail, with its backpointer gather _backpointers):
//     each written into row t of the chunk's stacked (C, B, ...) buffers.
// Its plain version is kaldi_decoder_tpu_torch/kernels/frame.py
// frame_tail_plain (and get_cutoff for the first-frame mode); the two are
// bitwise equal: every float operation is the plain version's, in its
// order (mid.costs - m_safe, base + m_safe, base + costs, base + cutoff,
// best + beam, (cut - best) + beam_delta).
//
// The frame index lives in device memory (FrameArgs), so that one captured
// CUDA graph of a frame (K1, K2 or K6, the eps closure, then this kernel)
// serves every frame and every chunk length: the start kernel writes the
// chunk's tensors and t = 0 there; each frame's tail reads t, writes row t
// and the next frame's inputs of K1 (cutoff, adaptive_beam, the scores
// row t + 1, and the rows still active), and the last row to finish
// advances t.
//
// What bounds it: bytes at B = 16, latency at B = 1.  A row's frontier (K
// states and costs), its records (R rows of 16 bytes; eps records D * Re
// rows; on the 1-best path the K backpointers gathered from K1's lanes and
// D * K eps backpointers) are read and written once into the chunk's
// buffers and the carried state: about 6 MB at B = 16, K 4096, R 8192,
// under 2 µs at the card's 3.35 TB/s.  At B = 1 the bytes take well under
// 0.1 µs, and what is left is the chain of dependent steps.
//
// The design: a cluster of G blocks of THREADS a row (G = 8, 4, 2 or 1:
// the largest whose B clusters all run at once with at least MIN_SLOTS
// slots a block; the shares by shifts), so that at B = 16 some 128 SMs
// move the bytes.  Block r takes its 1/G of each of the row's arrays
// (ranges of a multiple of 32 items, in rank order; a block may own none):
// its frontier slots, its records or backpointers, its part of the next
// scores row.  Nothing of
// that waits on another block.  A thread issues its loads before it needs
// to know whether the row is live: the frame's frontier, records and
// backpointer inputs are read at once (a frozen row then reads its
// carried slots), the scores row as soon as t is known.  The counts of
// finite costs (final and before the rebase) are one packed sum a warp,
// which each block stores into rank 0's shared memory with st.async (after
// the one cluster barrier, which tells that rank 0 runs with its mbarrier
// set); the other blocks are then done, and rank 0 waits on its mbarrier
// for the G * WARPS counts and adds them in its own shared memory.  Rank
// 0 runs GetCutoff from the row's inputs, loaded at its start beside t (a
// live row's costs at 0, max_active and min_active less m_safe, the
// subtraction the copy makes; a frozen row's carried costs, which no block
// writes), so no block reads back what another has just written.  What a
// row's blocks read and the tail writes in place is written only by the
// block that reads it (the old cutoff, the carried best cost of a frozen
// row) or by rank 0 once every block has stored its counts, which it does
// after it has read it (the base).  The frame index: every thread reads t
// at its start and arrives at the cluster barrier with it in hand; rank
// 0's second warp waits there at once and counts the row done with an
// atomic whose answer it reads at its end, so the round trip overlaps the
// copies; the last of the B rows writes t + 1 and clears the count, so no
// block sees the new t before every block has read the old one.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int START_THREADS = 512;  // the first-frame mode: one block a row
constexpr int THREADS = 256;        // a block of the tail's cluster
constexpr int WARPS = THREADS / 32;
constexpr int MIN_SLOTS = 256;      // the fewest frontier slots a block of the tail takes
constexpr int MOST = 8;             // the most blocks a row
constexpr int OUTS = 9;  // the lattice frame's outputs; the 1-best frame has 7

// The frame's arguments in device memory, as int64 words (kernels/frame.py
// ARGS_WORDS): written by the start kernel, read by each frame's tail.
struct FrameArgs {
  long long t;               // the frame to run
  long long frames;          // the chunk's frame count C
  unsigned long long done;   // rows done with frame t
  const float* scores;       // (C, B, V)
  const int* lengths;        // (B,) frames still to decode from t = 0
  void* out[OUTS];           // the stacked outputs, in LatticeStepOut / StepOut order
};

struct Cut {
  float cutoff, adaptive;
};

// GetCutoff of one cost-sorted row with `count` finite costs, given its
// costs at 0, min(max_active, K-1) and min(min_active, K-1), with the
// plain version's branch order and float arithmetic (ops/cutoff.py).
__device__ Cut get_cutoff(float best, float at_max, float at_min, int count, float beam,
                          int max_active, int min_active, float beam_delta) {
  const float beam_cutoff = best + beam;
  const float max_cut = count > max_active ? at_max : INFINITY;
  const float min_cut = count > min_active ? (min_active == 0 ? best : at_min) : INFINITY;
  const bool use_max = max_cut < beam_cutoff;
  const bool use_min = !use_max && min_cut > beam_cutoff;
  Cut c;
  c.cutoff = use_max ? max_cut : (use_min ? min_cut : beam_cutoff);
  c.adaptive = use_max ? (max_cut - best) + beam_delta
                       : (use_min ? (min_cut - best) + beam_delta : beam);
  return c;
}

// Loads a thread keeps in flight before its stores: a frontier's slots,
// a row's records or backpointers, the scores row.
constexpr int UNROLL = 8;

// dst[i] = live ? src[i] : fill(i) for i in [r.x, r.y), by the block:
// UNROLL loads a thread issued before any of its stores.  The loads do
// not wait for `live`: a frozen row's inputs are read and dropped.
template <typename T, typename Fill>
__device__ __forceinline__ void copy_share(T* dst, const T* src, int2 r, bool live, Fill fill) {
  for (int i0 = r.x + (int)threadIdx.x; i0 < r.y; i0 += UNROLL * THREADS) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < r.y) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < r.y) dst[i] = live ? v[u] : fill(i);
    }
  }
}

using kdtorch::pin;
using kdtorch::share;

__device__ __forceinline__ int block_sum(int v, int* smem) {
  int total;
  kdtorch::block_exclusive_scan(v, smem, &total);
  return total;
}

struct Config {
  int B, K, V;
  float beam;
  int max_active, min_active;
  float beam_delta;
};

// The carried state and K1's inputs, static across frames.
struct Slots {
  int* states;              // (B, K)
  float* costs;             // (B, K)
  float* base;              // (B,)
  float* cutoff;            // (B,) the frame's cutoff, relative to base
  float* adaptive_beam;     // (B,)
  unsigned char* active;    // (B,) the frame's rows still decoding (the eps closure's)
  float* scores_t;          // (B, V) the frame's scores
};

struct StartIn {
  const int* st0_states;    // (B, K); may be the slots themselves
  const float* st0_costs;
  const float* st0_base;
  const float* scores;      // (C, B, V)
  const int* lengths;       // (B,)
  long long frames;
  void* out[OUTS];
};

// The first-frame mode, once a chunk: one block a row.  The chunk's start
// state into the slots, its GetCutoff, scores row 0, the active rows;
// block 0 writes FrameArgs.
__global__ void __launch_bounds__(START_THREADS) frame_start_kernel(FrameArgs* args, Config cfg,
                                                                    Slots s, StartIn in) {
  __shared__ int smem[32];
  const int b = blockIdx.x;
  const size_t row = (size_t)b * cfg.K;
  int n = 0;
  for (int k = threadIdx.x; k < cfg.K; k += blockDim.x) {
    const int st = in.st0_states[row + k];
    const float c = in.st0_costs[row + k];
    s.states[row + k] = st;
    s.costs[row + k] = c;
    n += isfinite(c);
  }
  n = block_sum(n, smem);  // its barriers make the row's costs visible to thread 0
  const int len = in.lengths[b];
  if (threadIdx.x == 0) {
    s.base[b] = in.st0_base[b];
    const float* c = s.costs + row;
    const Cut cut = get_cutoff(c[0], c[min(cfg.max_active, cfg.K - 1)],
                               c[min(cfg.min_active, cfg.K - 1)], n, cfg.beam, cfg.max_active,
                               cfg.min_active, cfg.beam_delta);
    s.cutoff[b] = cut.cutoff;
    s.adaptive_beam[b] = cut.adaptive;
    s.active[b] = 0 < len;
  }
  if (in.frames > 0) {
    const float* src = in.scores + (size_t)b * cfg.V;
    float* dst = s.scores_t + (size_t)b * cfg.V;
    for (int i = threadIdx.x; i < cfg.V; i += blockDim.x) dst[i] = src[i];
  }
  if (b == 0 && threadIdx.x == 0) {
    args->t = 0;
    args->frames = in.frames;
    args->done = 0;
    args->scores = in.scores;
    args->lengths = in.lengths;
    for (int i = 0; i < OUTS; ++i) args->out[i] = in.out[i];
  }
}

// The frame's results from K1, K2 or K6 and the eps closure.
struct TailIn {
  const int* mid_states;          // (B, K) the frame's frontier, cost-sorted
  const float* mid_costs;         // (B, K)
  const unsigned char* em_ovf;    // (B,) K1's overflow
  const int* num_unique;          // (B,) the emitting dedup's distinct states
  const unsigned char* eps_ovf;   // (B,) or null (no eps closure)
  const unsigned char* eps_sat;   // (B,) or null
  int D;                          // eps iterations (0: no eps outputs)
  // Lattice: K2's records.
  const unsigned char* rec_ovf;   // (B,)
  const int4* em_rec;             // (B, R) records
  const int4* eps_rec;            // (B, D, Re) records
  int R, Re;
  // 1-best: the backpointer gather's inputs.
  const int* cand_idx;            // (B, K) K6's winning lane per slot, -1 if empty
  const int* src_slot;            // (B, N) K1's source slot per lane
  const int* arc_id;              // (B, N)
  const int2* bp_eps;             // (B, D, K) eps backpointers
  int N;
};

template <bool LATTICE>
__global__ void __launch_bounds__(THREADS) frame_tail_kernel(FrameArgs* args, Config cfg,
                                                             Slots s, TailIn in) {
  __shared__ unsigned s_part[MOST * WARPS];  // rank 0's: every warp's counts, packed
  __shared__ uint64_t s_counts;               // rank 0's: complete when they have landed
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();  // 1, 2, 4 or 8
  const int lg = __ffs(G) - 1;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x >> lg;
  const int tid = threadIdx.x;
  const int K = cfg.K;
  const size_t row = (size_t)b * K;
  const bool lead = rank == 0 && tid == 0;  // writes the row's scalars
  const bool counter = rank == 0 && (tid >> 5) == 1;  // the warp that counts the row done
  if (lead) {
    kdtorch::mbar_init(&s_counts, 1);
    kdtorch::mbar_arrive_expect_tx(&s_counts, G * WARPS * (unsigned)sizeof(unsigned));
  }

  // What does not wait: the frame index and the chunk's tensors, the row's
  // length, best cost and base (every thread, a broadcast load); rank 0's
  // GetCutoff inputs and flags.
  const long long t = __ldcg(&args->t);
  const long long frames = args->frames;
  const float* scores = args->scores;
  const int* lengths = args->lengths;
  const float m = in.mid_costs[row];
  const float base_old = s.base[b];
  const int i_max = min(cfg.max_active, K - 1), i_min = min(cfg.min_active, K - 1);
  float at_max = 0.0f, at_min = 0.0f, cut_old = 0.0f;
  bool ovf = false, sat = false;
  if (lead) {
    at_max = in.mid_costs[row + i_max];
    at_min = in.mid_costs[row + i_min];
    cut_old = s.cutoff[b];
    ovf = in.em_ovf[b];
    if (LATTICE) ovf = ovf || in.rec_ovf[b];
    if (in.eps_ovf) ovf = ovf || in.eps_ovf[b];
    sat = in.num_unique[b] > K;
    if (in.eps_sat) sat = sat || in.eps_sat[b];
  }
  const int len = lengths[b];
  // The block's part of the next scores row: its first loads, once t is known.
  const int2 vr = share(cfg.V, lg, rank);
  const bool next = t + 1 < frames;
  const float* vsrc = scores + ((size_t)(t + 1) * cfg.B + b) * cfg.V;
  float* vdst = s.scores_t + (size_t)b * cfg.V;
  constexpr int VU = 2;
  float sv[VU];
#pragma unroll
  for (int u = 0; u < VU; ++u) {
    const int i = vr.x + tid + u * THREADS;
    if (next && i < vr.y) sv[u] = vsrc[i];
  }
  if (t < 0) __trap();  // t in hand (a branch on it) before the barrier
  kdtorch::cluster_arrive();  // the one cluster barrier: the block runs and has read t
  // Every block of the row has read t: rank 0's second warp counts the row
  // done at once, and reads the count at its end.
  unsigned long long seen = 0;
  if (counter) {
    kdtorch::cluster_wait();
    if (tid == 32) seen = atomicAdd(&args->done, 1ull);
  }

  // The block's slots of the frontier the row keeps: the frame's, read at
  // once; the carried one when the row is frozen.
  const size_t orow = (size_t)t * cfg.B + b;  // row (t, b) of the stacked outputs
  const int2 kr = share(K, lg, rank);
  int n_final = 0, n_mid = 0;
  bool fa = false;
  float m_safe = 0.0f, base_new = base_old;
  int* out_states = LATTICE ? static_cast<int*>(args->out[2]) + orow * K : nullptr;
  float* out_costs = LATTICE ? static_cast<float*>(args->out[3]) + orow * K : nullptr;
  int2* out_bp = LATTICE ? nullptr : static_cast<int2*>(args->out[0]) + orow * K;
  for (int k0 = kr.x + tid; k0 < kr.y; k0 += UNROLL * THREADS) {
    int st[UNROLL], ci[UNROLL];
    float c[UNROLL];
    int2 bp[UNROLL];  // 1-best: each slot's winning lane's (source slot, arc)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      if (k < kr.y) {
        st[u] = in.mid_states[row + k];
        c[u] = in.mid_costs[row + k];
        ci[u] = LATTICE ? -1 : in.cand_idx[row + k];
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      if (!LATTICE && k < kr.y) {
        const size_t lane = (size_t)b * in.N + (ci[u] >= 0 ? ci[u] : 0);
        bp[u] = ci[u] >= 0 ? make_int2(in.src_slot[lane], in.arc_id[lane]) : make_int2(0, -1);
      }
    }
    fa = t < pin(len);
    m_safe = isfinite(m) ? m : 0.0f;
    base_new = fa ? base_old + m_safe : base_old;
    if (!fa) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int k = k0 + u * THREADS;
        if (k < kr.y) {
          st[u] = s.states[row + k];
          c[u] = s.costs[row + k];
          bp[u] = make_int2(k, -1);  // a frozen row carries every token over
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * THREADS;
      if (k >= kr.y) continue;
      if (fa) {
        n_mid += isfinite(c[u]);
        c[u] = c[u] - m_safe;
        s.states[row + k] = st[u];
        s.costs[row + k] = c[u];
      }
      n_final += isfinite(c[u]);
      if (LATTICE) {
        out_states[k] = st[u];
        out_costs[k] = base_new + c[u];
      } else {
        out_bp[k] = bp[u];
      }
    }
  }
  fa = t < len;
  m_safe = isfinite(m) ? m : 0.0f;
  base_new = fa ? base_old + m_safe : base_old;
  // A frozen row's GetCutoff reads its carried costs, which no block writes.
  float best = m - m_safe;
  if (lead) {
    if (fa) {
      at_max = at_max - m_safe;
      at_min = at_min - m_safe;
    } else {
      best = s.costs[row];
      at_max = s.costs[row + i_max];
      at_min = s.costs[row + i_min];
    }
  }
  if (LATTICE) {
    const auto none = [](int) { return make_int4(-1, -1, -1, -1); };
    copy_share(static_cast<int4*>(args->out[0]) + orow * in.R, in.em_rec + (size_t)b * in.R,
               share(in.R, lg, rank), fa, none);
    const int n_eps = in.D * in.Re;
    copy_share(static_cast<int4*>(args->out[1]) + orow * n_eps,
               in.eps_rec + (size_t)b * n_eps, share(n_eps, lg, rank), fa, none);
  } else {
    const int n_eps = in.D * K;
    copy_share(static_cast<int2*>(args->out[1]) + orow * n_eps, in.bp_eps + (size_t)b * n_eps,
               share(n_eps, lg, rank), fa, [K](int i) { return make_int2(i % K, -1); });
  }
  if (next) {
#pragma unroll
    for (int u = 0; u < VU; ++u) {
      const int i = vr.x + tid + u * THREADS;
      if (i < vr.y) vdst[i] = sv[u];
    }
    for (int i = vr.x + tid + VU * THREADS; i < vr.y; i += THREADS) vdst[i] = vsrc[i];
  }

  // The counts: one packed sum a warp (each at most K < 2^16), into rank
  // 0's shared memory.  The other blocks are then done: nothing reads
  // their shared memory.
  const unsigned packed = __reduce_add_sync(0xffffffffu, (unsigned)n_final | (unsigned)n_mid << 16);
  if (!counter) kdtorch::cluster_wait();  // rank 0 runs, its barrier is set
  if ((tid & 31) == 0)
    kdtorch::store_remote(s_part + rank * WARPS + (tid >> 5), packed, &s_counts, 0);
  if (rank != 0) return;
  kdtorch::mbar_wait_cluster(&s_counts, 0);  // every block has read t and base_old; its counts
  if (tid < 32) {
    unsigned v = 0;
    for (int i = tid; i < G * WARPS; i += 32) v += s_part[i];
    v = __reduce_add_sync(0xffffffffu, v);
    if (tid == 0) {
      const int nf = (int)(v & 0xffffu), nm = (int)(v >> 16);
      // The stacked outputs' common tail: num_active, best_cost, cutoff,
      // overflow, saturated (LatticeStepOut from index 4, StepOut from 2).
      constexpr int o = LATTICE ? 4 : 2;
      static_cast<int*>(args->out[o])[orow] = LATTICE ? nf : (fa ? nm : nf);
      static_cast<float*>(args->out[o + 1])[orow] =
          LATTICE || fa ? base_new : base_old + (isfinite(best) ? best : 0.0f);
      static_cast<float*>(args->out[o + 2])[orow] = base_old + cut_old;
      static_cast<unsigned char*>(args->out[o + 3])[orow] = fa && ovf;
      static_cast<unsigned char*>(args->out[o + 4])[orow] = fa && sat;
      s.base[b] = base_new;
      // The next frame's K1 inputs: GetCutoff of the row as the copy wrote it.
      const Cut c = get_cutoff(best, at_max, at_min, nf, cfg.beam, cfg.max_active,
                               cfg.min_active, cfg.beam_delta);
      s.cutoff[b] = c.cutoff;
      s.adaptive_beam[b] = c.adaptive;
      s.active[b] = t + 1 < len;
    }
  } else if (tid == 32 && seen == (unsigned long long)cfg.B - 1) {
    // The last row counted: every block of every row has read t.
    args->t = t + 1;
    args->done = 0;
  }
}

Slots slots(void* states, void* costs, void* base, void* cutoff, void* adaptive_beam,
            void* active, void* scores_t) {
  return Slots{static_cast<int*>(states), static_cast<float*>(costs), static_cast<float*>(base),
               static_cast<float*>(cutoff), static_cast<float*>(adaptive_beam),
               static_cast<unsigned char*>(active), static_cast<float*>(scores_t)};
}

// The most blocks a row's cluster takes for K slots: at least MIN_SLOTS a block.
int cluster_cap(int K) {
  int c = MOST;
  while (c > 1 && K / c < MIN_SLOTS) c /= 2;
  return c;
}

}  // namespace

// The first-frame mode on `stream`: B blocks.  Shapes: the slots states/
// costs (B, K), base/cutoff/adaptive_beam/active (B,), scores_t (B, V);
// st0 (B, K), (B, K), (B,); scores (frames, B, V) float32; lengths (B,)
// int32; out0..out8 the chunk's stacked outputs (the 1-best frame's seven,
// then null).  Returns the launch's CUDA error (0 on success).
extern "C" int kd_frame_start(void* args, int B, int K, int V, long long frames, float beam,
                              int max_active, int min_active, float beam_delta, void* states,
                              void* costs, void* base, void* cutoff, void* adaptive_beam,
                              void* active, void* scores_t, const void* st0_states,
                              const void* st0_costs, const void* st0_base, const void* scores,
                              const void* lengths, void* out0, void* out1, void* out2, void* out3,
                              void* out4, void* out5, void* out6, void* out7, void* out8,
                              void* stream) {
  if (B < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const Config cfg{B, K, V, beam, max_active, min_active, beam_delta};
  StartIn in{static_cast<const int*>(st0_states), static_cast<const float*>(st0_costs),
             static_cast<const float*>(st0_base), static_cast<const float*>(scores),
             static_cast<const int*>(lengths), frames,
             {out0, out1, out2, out3, out4, out5, out6, out7, out8}};
  frame_start_kernel<<<B, START_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<FrameArgs*>(args), cfg,
      slots(states, costs, base, cutoff, adaptive_beam, active, scores_t), in);
  return (int)cudaGetLastError();
}

// The cluster size the tail launches with for B rows of K slots
// (kdtorch::pick_cluster, at most cluster_cap(K)); 0 when none fits.  The
// 1-best instance takes what the lattice one is given.
extern "C" int kd_frame_tail_cluster(int B, int K) {
  return kdtorch::pick_cluster(frame_tail_kernel<true>, B, THREADS, K,
                               [](int) { return (size_t)0; }, cluster_cap(K));
}

// One frame's tail on `stream`: B clusters of G blocks (G = `clusters`, or
// kd_frame_tail_cluster's when 0), the lattice instance when `lattice` is
// set.  K < 2^16.  Shapes as kd_frame_start's slots; mid states/costs
// (B, K); em_ovf, eps_ovf, eps_sat, rec_ovf (B,) bool (eps_ovf and eps_sat
// null without an eps closure); num_unique (B,) int32.  Lattice: em_rec
// (B, R, 4) int32, eps_rec (B, D, Re, 4).  1-best: cand_idx (B, K),
// src_slot and arc_id (B, N) int32, bp_eps (B, D, K, 2).  The frame index,
// the chunk's scores, lengths and outputs come from `args`.  Returns the
// launch's CUDA error (0 on success; a refused cluster launch is reported).
extern "C" int kd_frame_tail(void* args, int lattice, int B, int K, int V, int R, int D, int Re,
                             int N, float beam, int max_active, int min_active, float beam_delta,
                             void* states, void* costs, void* base, void* cutoff,
                             void* adaptive_beam, void* active, void* scores_t,
                             const void* mid_states, const void* mid_costs, const void* em_ovf,
                             const void* num_unique, const void* eps_ovf, const void* eps_sat,
                             const void* rec_ovf, const void* em_rec, const void* eps_rec,
                             const void* cand_idx, const void* src_slot, const void* arc_id,
                             const void* bp_eps, int clusters, void* stream) {
  if (B < 1 || K < 1 || K >= (1 << 16) || clusters < 0 || clusters > MOST ||
      (clusters & (clusters - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const int G = clusters > 0 ? clusters : kd_frame_tail_cluster(B, K);
  if (G < 1) return (int)cudaErrorInvalidConfiguration;
  const Config cfg{B, K, V, beam, max_active, min_active, beam_delta};
  const TailIn in{static_cast<const int*>(mid_states), static_cast<const float*>(mid_costs),
                  static_cast<const unsigned char*>(em_ovf), static_cast<const int*>(num_unique),
                  static_cast<const unsigned char*>(eps_ovf),
                  static_cast<const unsigned char*>(eps_sat), D,
                  static_cast<const unsigned char*>(rec_ovf), static_cast<const int4*>(em_rec),
                  static_cast<const int4*>(eps_rec), R, Re, static_cast<const int*>(cand_idx),
                  static_cast<const int*>(src_slot), static_cast<const int*>(arc_id),
                  static_cast<const int2*>(bp_eps), N};
  const Slots s = slots(states, costs, base, cutoff, adaptive_beam, active, scores_t);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  FrameArgs* a = static_cast<FrameArgs*>(args);
  return (int)(lattice ? kdtorch::launch_cluster(frame_tail_kernel<true>, B * G, G, THREADS, 0,
                                                 st, a, cfg, s, in)
                       : kdtorch::launch_cluster(frame_tail_kernel<false>, B * G, G, THREADS, 0,
                                                 st, a, cfg, s, in));
}

// ---- The shard mode -----------------------------------------------------------
//
// Replaces the sharded frame's tail in the JAX package
// (kaldi_decoder_tpu/parallel/graph_shard.py: _rebase's wheres, the step
// outputs' wheres of _sharded_frame and _sharded_lattice_frame, and the
// stacking of lax.scan's outputs over a chunk), after the rebase's
// reductions over the ranks: m_safe is the global best cost, or 0 where
// no rank holds a token; a live row's frontier becomes the closure's less
// m_safe and its base base + m_safe; a row whose utterance has ended keeps
// its state, its outputs the identity backpointers or -1 links; every
// output goes into row t of the chunk's stacked buffers, t read from the
// table in device memory and advanced by the last row done.  No GetCutoff:
// the sharded cutoff is global and computed before the frame.  Plain
// version: kernels/frame.py frame_tail_shard_plain; bitwise equal (the
// float operations are its own: mid - m_safe, base + m_safe, base + costs,
// base + cutoff).
//
// The table (ShardTable, kernels/frame.py SHARD_ARGS_WORDS) holds t, the
// rows done with it, the chunk's frame count, its scores and its stacked
// outputs: the shard mode's first-frame mode (frame_start_shard_kernel,
// below, once a chunk) writes them, with the chunk's start state, row
// lengths and scores row 0 into static slots; each frame's tail writes row
// t through the table's pointers and copies scores row t + 1 into the
// slot that K1 reads.  No launch argument changes from one frame or chunk
// to the next, so one captured CUDA graph of the sharded frame serves
// every frame and chunk (parallel/shard_driver.py), as the JAX package's
// lax.scan in shard_map runs the chunk on the device.
//
// What bounds it: bytes, each output written once and each input read
// once: 1.6-2.6 MB at B = 16, K 2048, R 4096 / 3072, some 0.0005-0.0008 ms
// at 3.35 TB/s (the next scores row, V floats a row, adds 64 KB at V 500);
// at these sizes what is left is a launch, the frame index
// and, on the 1-best path, the backpointer gather's two dependent loads
// (cand_idx, then the winning lane's slot and arc).
//
// The design is the unsharded tail's (above): a cluster of G blocks of
// THREADS a row (G = 8, 4, 2 or 1, the largest whose B clusters all run at
// once with at least MIN_SLOTS slots a block), so that at B = 16 some 128
// SMs move the bytes.  Block r takes its 1/G of the row's K frontier slots
// (the carried state, the frontier or backpointer outputs), of its R em
// records, of its D * Re eps links or D * K eps backpointers and of the
// next scores row (ranges of a multiple of 32 in rank order; a block may
// own none), the first three in one round
// of loads a thread before its stores: the loads do not wait for the row's
// liveness, a frozen row then reads its carried slots, which no block
// writes.  Every thread reads t at its start, beside the row's length,
// base and global best cost, and arrives at the one cluster barrier with t
// in hand; rank 0's second warp waits there at once and counts the row
// done with an atomic whose answer it reads at its end, so the round trip
// overlaps the copies; the last of the B rows writes t + 1 and clears the
// count, so no block sees the new t before every block has read the old
// one.  The counts of the outputs are the reductions' (num_active), so no
// block hands anything to another.  Only rank 0 writes the row's scalars
// (num_active, best_cost, cutoff, the flags) and the base, after the
// cluster barrier: every block of its row has read the old base.
//
// Its last step is K8's local half of the next frame's GetCutoff (csrc/
// cutoff.cu, which then runs once a chunk, on the chunk's start state):
// for a live row, the smallest finite cost is red_min - m_safe and the
// finite count red_count, where red_min and red_count are the eps
// closure's local values that the rebase reduced (its first smallest
// finite cost in slot order, that slot's bits; graph_shard.py:_reduced
// reduces copies), and the prefix is the new costs of slots k < m, written
// as they are written.  Exact: x -> RN(x - m_safe) is monotone, and a
// difference of finite floats is 0 only where they are equal, so the
// first slot with the smallest rebased cost holds red_min - m_safe bit for
// bit (-0.0 beside +0.0 included), and no finite cost turns infinite while
// a row's costs lie within a beam of the global best.  A frozen row keeps
// last frame's values, which are its kept costs'.  So no block reduces
// anything more: rank 0's thread 0 writes the two scalars beside the
// row's others, each block its prefix slots.

namespace {

// The shard mode's table in device memory, as int64 words.
struct ShardTable {
  long long t;               // the frame to run
  unsigned long long done;   // rows done with frame t
  long long frames;          // the chunk's frame count
  const float* scores;       // (frames, B, V) the chunk's scores
  void* out[8];              // its stacked outputs, ShardLatticeStepOut / ShardStepOut order
};

struct ShardTailArgs {
  ShardTable* tab;
  int B, K, N, D, R, Re, V, slot_base;
  const int* lengths;        // (B,) the chunk's, in a static slot
  int* states;               // (B, K) the carried state, in place
  float* costs;
  float* base;               // (B,)
  float* scores_t;           // (B, V) K1's scores row: the next frame's is copied in
  const float* cutoff;       // (B,) the frame's, relative to base
  const int* mid_states;     // (B, K)
  const float* mid_costs;
  const float* best;         // (B,) reduced MIN
  const int* num_active;     // (B,) reduced SUM
  const int* flags;          // (2,) reduced MAX
  const int4* em_rec;        // (B, R) lattice
  const int2* eps_rec;       // (B, D, Re) lattice
  const int* cand_idx;       // (B, K) 1-best
  const int* gslot;          // (B, N)
  const int* arc;            // (B, N)
  const int2* bp_eps;        // (B, D, K)
  // The next frame's GetCutoff, its local half (K8's, kernels/cutoff.py
  // CutoffLocal), from the eps closure's local values: null for none.
  const float* red_min;      // (B,) the closure's smallest finite cost (local)
  const int* red_count;      // (B,) its finite costs (local)
  float* loc_best;           // (B,)
  int* loc_count;            // (B,)
  float* loc_prefix;         // (B, m), m < K, or null (m == K: the costs are the prefix)
  int m;
};

// Loads a thread keeps in flight of each of the block's arrays.
constexpr int SHARD_UNROLL = 4;

template <bool LATTICE>
__global__ void __launch_bounds__(THREADS) frame_tail_shard_kernel(ShardTailArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  const int G = (int)cluster.num_blocks();  // 1, 2, 4 or 8
  const int lg = __ffs(G) - 1;
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x >> lg;
  const int tid = threadIdx.x;
  const bool lead = rank == 0 && tid == 0;  // writes the row's scalars
  const bool counter = rank == 0 && (tid >> 5) == 1;  // the warp that counts the row done
  ShardTable* tab = a.tab;

  // What does not wait: the frame index, the chunk's frame count and
  // scores, the row's length, base and global best cost (every thread,
  // broadcast loads); rank 0's scalars' inputs.
  const long long t = __ldcg(&tab->t);
  const long long frames = tab->frames;
  const float* scores = tab->scores;
  const int len = a.lengths[b];
  const float base = a.base[b];
  const float m = a.best[b];
  float cut = 0.0f, rmin = 0.0f;
  int na = 0, rcount = 0;
  bool f0 = false, f1 = false;
  if (lead) {
    cut = a.cutoff[b];
    na = a.num_active[b];
    f0 = a.flags[0] > 0;
    f1 = a.flags[1] > 0;
    if (a.loc_best != nullptr) {
      rmin = a.red_min[b];
      rcount = a.red_count[b];
    }
  }
  if (t < 0 || t >= frames) __trap();  // t in hand (a branch on it) before the barrier
  kdtorch::cluster_arrive();  // the one cluster barrier: the block runs and has read t, base
  // Every block of the row has read t: rank 0's second warp counts the row
  // done at once, and reads the count at its end.
  unsigned long long seen = 0;
  if (counter) {
    kdtorch::cluster_wait();
    if (tid == 32) seen = atomicAdd(&tab->done, 1ull);
  }

  // The block's shares: its slots; its em records (lattice) or eps
  // backpointers (1-best); its eps links (lattice).
  const int K = a.K;
  const size_t row = (size_t)b * K;
  const size_t trow = (size_t)t * a.B + b;  // row (t, b) of the stacked outputs
  const float ms = isfinite(m) ? m : 0.0f;
  const int n1 = LATTICE ? a.R : a.D * K;
  const int n2 = LATTICE ? a.D * a.Re : 0;
  const int2 kr = share(K, lg, rank), r1 = share(n1, lg, rank), r2 = share(n2, lg, rank);
  const int nk = kr.y - kr.x, m1 = r1.y - r1.x, m2 = r2.y - r2.x;
  const size_t lanes = (size_t)b * a.N;
  const int4* em_src = LATTICE ? a.em_rec + (size_t)b * n1 : nullptr;
  const int2* eps_src = LATTICE ? a.eps_rec + (size_t)b * n2 : a.bp_eps + (size_t)b * n1;
  void* const* out = tab->out;
  int* fs = LATTICE ? static_cast<int*>(out[2]) + trow * K : nullptr;  // the frontier
  float* fc = LATTICE ? static_cast<float*>(out[3]) + trow * K : nullptr;
  int2* o0 = static_cast<int2*>(out[0]) + trow * (LATTICE ? n1 : K);  // em links / backpointers
  int2* o1 = static_cast<int2*>(out[1]) + trow * (LATTICE ? n2 : n1);  // eps links / bps
  float* prefix = a.loc_prefix != nullptr ? a.loc_prefix + (size_t)b * a.m : nullptr;
  bool fa = false;
  float nbase = base;
  for (int i0 = tid; i0 < max(nk, max(m1, m2)); i0 += SHARD_UNROLL * THREADS) {
    int st[SHARD_UNROLL], ci[SHARD_UNROLL];
    float c[SHARD_UNROLL];
    int2 bp[SHARD_UNROLL], e1[SHARD_UNROLL], e2[SHARD_UNROLL];
    int4 v1[SHARD_UNROLL];
#pragma unroll
    for (int u = 0; u < SHARD_UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nk) {
        st[u] = a.mid_states[row + kr.x + i];
        c[u] = a.mid_costs[row + kr.x + i];
        if (!LATTICE) ci[u] = a.cand_idx[row + kr.x + i];
      }
      if (i < m1) {
        if (LATTICE)
          v1[u] = em_src[r1.x + i];
        else
          e1[u] = eps_src[r1.x + i];
      }
      if (LATTICE && i < m2) e2[u] = eps_src[r2.x + i];
    }
    if (!LATTICE) {  // each slot's winning lane's (global slot, global arc)
#pragma unroll
      for (int u = 0; u < SHARD_UNROLL; ++u) {
        if (i0 + u * THREADS < nk)
          bp[u] = ci[u] >= 0 ? make_int2(a.gslot[lanes + ci[u]], a.arc[lanes + ci[u]])
                             : make_int2(0, -1);
      }
    }
    fa = t < pin(len);
    nbase = fa ? __fadd_rn(base, ms) : base;
    if (!fa) {  // a frozen row keeps its carried slots
#pragma unroll
      for (int u = 0; u < SHARD_UNROLL; ++u) {
        const int i = i0 + u * THREADS;
        if (i < nk) {
          st[u] = a.states[row + kr.x + i];
          c[u] = a.costs[row + kr.x + i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SHARD_UNROLL; ++u) {
      const int i = i0 + u * THREADS;
      if (i < nk) {
        const int k = kr.x + i;
        if (fa) {
          c[u] = __fsub_rn(c[u], ms);
          a.states[row + k] = st[u];
          a.costs[row + k] = c[u];
          if (prefix != nullptr && k < a.m) prefix[k] = c[u];
        }
        if (LATTICE) {
          fs[k] = st[u];
          fc[k] = __fadd_rn(nbase, c[u]);
        } else {
          o0[k] = fa ? bp[u] : make_int2(a.slot_base + k, -1);
        }
      }
      if (i < m1) {
        const int j = r1.x + i;
        if (LATTICE)
          o0[j] = fa ? make_int2(v1[u].x, v1[u].y) : make_int2(-1, -1);
        else
          o1[j] = fa ? e1[u] : make_int2(a.slot_base + j % K, -1);
      }
      if (LATTICE && i < m2) {
        const int j = r2.x + i;
        o1[j] = fa ? e2[u] : make_int2(-1, -1);
      }
    }
  }
  // The block's share of the next frame's scores row, into K1's slot.
  if (t + 1 < frames) {
    const int2 vr = share(a.V, lg, rank);
    const float* vsrc = scores + ((size_t)(t + 1) * a.B + b) * a.V;
    float* vdst = a.scores_t + (size_t)b * a.V;
    for (int i = vr.x + tid; i < vr.y; i += THREADS) vdst[i] = vsrc[i];
  }
  if (!counter) kdtorch::cluster_wait();  // rank 0: every block of the row has read base
  if (rank != 0) return;
  fa = t < len;
  nbase = fa ? __fadd_rn(base, ms) : base;
  if (lead) {
    const int at = LATTICE ? 4 : 2;  // num_active, then (1-best) best_cost, cutoff, flags
    static_cast<int*>(out[at])[trow] = fa ? na : 0;
    if (!LATTICE) static_cast<float*>(out[3])[trow] = nbase;
    static_cast<float*>(out[at + (LATTICE ? 1 : 2)])[trow] = __fadd_rn(base, cut);
    static_cast<unsigned char*>(out[at + (LATTICE ? 2 : 3)])[trow] = fa && f0;
    static_cast<unsigned char*>(out[at + (LATTICE ? 3 : 4)])[trow] = fa && f1;
    a.base[b] = nbase;
    if (fa && a.loc_best != nullptr) {  // a frozen row keeps its local half
      a.loc_best[b] = __fsub_rn(rmin, ms);
      a.loc_count[b] = rcount;
    }
  } else if (tid == 32 && seen == (unsigned long long)a.B - 1) {
    // The last row counted: every block of every row has read t.
    tab->t = t + 1;
    tab->done = 0;
  }
}

// The shard mode's first-frame mode, once a chunk: one block a row.  The
// chunk's start state, the row's length and scores row 0 into the static
// slots; block 0 writes the table (t = 0, the frame count, the scores and
// output pointers).  Plain version: kernels/frame.py
// frame_start_shard_plain, bitwise equal (it copies).
struct ShardStartIn {
  const int* st0_states;    // (B, K)
  const float* st0_costs;
  const float* st0_base;    // (B,)
  const int* lengths;       // (B,)
  const float* scores;      // (frames, B, V)
  long long frames;
  void* out[8];
};

__global__ void __launch_bounds__(START_THREADS) frame_start_shard_kernel(
    ShardTable* tab, int K, int V, int* states, float* costs, float* base, int* lengths,
    float* scores_t, ShardStartIn in) {
  const int b = blockIdx.x;
  const size_t row = (size_t)b * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    states[row + k] = in.st0_states[row + k];
    costs[row + k] = in.st0_costs[row + k];
  }
  if (in.frames > 0) {
    const float* src = in.scores + (size_t)b * V;
    for (int i = threadIdx.x; i < V; i += blockDim.x) scores_t[(size_t)b * V + i] = src[i];
  }
  if (threadIdx.x == 0) {
    base[b] = in.st0_base[b];
    lengths[b] = in.lengths[b];
  }
  if (b == 0 && threadIdx.x == 0) {
    tab->t = 0;
    tab->done = 0;
    tab->frames = in.frames;
    tab->scores = in.scores;
    for (int i = 0; i < 8; ++i) tab->out[i] = in.out[i];
  }
}

}  // namespace

// The shard mode's first-frame mode on `stream`: B blocks.  args: the table
// (SHARD_ARGS_WORDS int64 words); the slots: states/costs (B, K), base
// (B,) float32, lengths (B,) int32, scores_t (B, V) float32; the chunk:
// st0 (B, K), (B, K), (B,), lengths (B,) int32, scores (frames, B, V)
// float32, out0..7 its stacked outputs (the 1-best frame's seven, then
// null).  Returns the launch's CUDA error (0 on success).
extern "C" int kd_frame_start_shard(void* args, int B, int K, int V, long long frames,
                                    void* states, void* costs, void* base, void* lengths,
                                    void* scores_t, const void* st0_states, const void* st0_costs,
                                    const void* st0_base, const void* chunk_lengths,
                                    const void* scores, void* out0, void* out1, void* out2,
                                    void* out3, void* out4, void* out5, void* out6, void* out7,
                                    void* stream) {
  if (B < 1 || K < 1 || V < 0 || frames < 0) return (int)cudaErrorInvalidValue;
  const ShardStartIn in{static_cast<const int*>(st0_states), static_cast<const float*>(st0_costs),
                        static_cast<const float*>(st0_base),
                        static_cast<const int*>(chunk_lengths),
                        static_cast<const float*>(scores), frames,
                        {out0, out1, out2, out3, out4, out5, out6, out7}};
  frame_start_shard_kernel<<<B, START_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<ShardTable*>(args), K, V, static_cast<int*>(states), static_cast<float*>(costs),
      static_cast<float*>(base), static_cast<int*>(lengths), static_cast<float*>(scores_t), in);
  return (int)cudaGetLastError();
}

// The cluster size K3's shard mode launches with for B rows of K slots
// (kdtorch::pick_cluster, at most cluster_cap(K)); 0 when none fits.  The
// 1-best instance takes what the lattice one is given.
extern "C" int kd_frame_tail_shard_cluster(int B, int K) {
  return kdtorch::pick_cluster(frame_tail_shard_kernel<true>, B, THREADS, K,
                               [](int) { return (size_t)0; }, cluster_cap(K));
}

// K3's shard mode on `stream`: B clusters of G blocks (G = `clusters`, or
// kd_frame_tail_shard_cluster's when 0), the lattice instance when
// `lattice` is set.  args: the table (SHARD_ARGS_WORDS int64 words, from
// kd_frame_start_shard: t, rows done, the chunk's frame count, scores and
// outputs); lengths (B,) int32, the carried states/costs (B, K), base (B,)
// and scores_t (B, V) float32, the static slots; cutoff (B,) float32; mid
// states/costs (B, K); best (B,) float32, num_active (B,) int32, flags (2,)
// int32 (the reductions over the ranks).  Lattice: em_rec (B, R, 4),
// eps_rec (B, D, Re, 2) int32; the table's outputs ShardLatticeStepOut's
// stacked (frames, B, ...) buffers.  1-best: cand_idx (B, K), gslot/arc (B,
// N), bp_eps (B, D, K, 2) int32; the outputs ShardStepOut's.  An input of
// no elements (D = 0) may be null.  The next frame's local half of
// GetCutoff (K8's): red_min (B,) float32 and red_count (B,) int32, the eps
// closure's local values, in; loc_best (B,) float32, loc_count (B,) int32
// and, when m < K, loc_prefix (B, m) float32, out, for the rows still
// decoding (all null: none written).  Returns the launch's CUDA error (a
// refused cluster launch is reported).
extern "C" int kd_frame_tail_shard(void* args, int lattice, int B, int K, int N, int D, int R,
                                   int Re, int V, int slot_base, const void* lengths, void* states,
                                   void* costs, void* base, void* scores_t, const void* cutoff,
                                   const void* mid_states, const void* mid_costs,
                                   const void* best, const void* num_active, const void* flags,
                                   const void* em_rec, const void* eps_rec, const void* cand_idx,
                                   const void* gslot, const void* arc, const void* bp_eps,
                                   const void* red_min, const void* red_count, void* loc_best,
                                   void* loc_count, void* loc_prefix, int m, int clusters,
                                   void* stream) {
  const bool local = loc_best != nullptr;
  if (B < 1 || K < 1 || D < 0 || R < 0 || Re < 0 || V < 0 || clusters < 0 || clusters > MOST ||
      (clusters & (clusters - 1)) != 0 ||
      (local && (red_min == nullptr || red_count == nullptr || loc_count == nullptr)) ||
      (loc_prefix != nullptr && !(local && 1 <= m && m < K)))
    return (int)cudaErrorInvalidValue;
  const int G = clusters > 0 ? clusters : kd_frame_tail_shard_cluster(B, K);
  if (G < 1) return (int)cudaErrorInvalidConfiguration;
  const ShardTailArgs a{static_cast<ShardTable*>(args), B, K, N, D, R, Re, V, slot_base,
                        static_cast<const int*>(lengths), static_cast<int*>(states),
                        static_cast<float*>(costs), static_cast<float*>(base),
                        static_cast<float*>(scores_t), static_cast<const float*>(cutoff),
                        static_cast<const int*>(mid_states), static_cast<const float*>(mid_costs),
                        static_cast<const float*>(best), static_cast<const int*>(num_active),
                        static_cast<const int*>(flags), static_cast<const int4*>(em_rec),
                        static_cast<const int2*>(eps_rec), static_cast<const int*>(cand_idx),
                        static_cast<const int*>(gslot), static_cast<const int*>(arc),
                        static_cast<const int2*>(bp_eps), static_cast<const float*>(red_min),
                        static_cast<const int*>(red_count), static_cast<float*>(loc_best),
                        static_cast<int*>(loc_count), static_cast<float*>(loc_prefix),
                        loc_prefix != nullptr ? m : 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(lattice ? kdtorch::launch_cluster(frame_tail_shard_kernel<true>, B * G, G,
                                                 THREADS, 0, st, a)
                       : kdtorch::launch_cluster(frame_tail_shard_kernel<false>, B * G, G,
                                                 THREADS, 0, st, a));
}
