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
// row t + 1, and the rows still active), and the last block to finish
// advances t.
//
// What bounds it: bytes.  A block reads the row's frontier (K states and
// costs) and its records (R rows of 16 bytes; eps records D * Re rows; on
// the 1-best path the K backpointers gathered from K1's lanes and D * K
// eps backpointers) and writes them once into the chunk's buffers and the
// carried state: about 6 MB at B = 16, K 4096, R 8192, under 2 µs at the
// card's 3.35 TB/s.  With one block a row and B = 16 it runs on 16 SMs, so
// what it reaches is what 16 SMs can move, a few µs; that is well under
// the frame, and the loop's launches, which it replaces, cost far more.
//
// The design: one block of THREADS a row, K <= 4096 slots a row (8 slots
// a thread at K 4096).  The frontier, the records (one int4 a record) and
// the backpointers (one int2 a slot) are copied with coalesced loads and
// stores, UNROLL loads in flight a thread before its stores, so that 16
// blocks still keep many bytes in flight; the counts of finite costs are
// block sums; one thread then runs GetCutoff on the row it has just
// written (visible to it after the block's barrier).  Every block reads
// the frame index once, at its start; each counts itself done with an
// atomic after a fence, and the last one writes t + 1 and clears the
// count, so no block can see the new t before every block has read the
// old one.

#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int OUTS = 9;  // the lattice frame's outputs; the 1-best frame has 7

// The frame's arguments in device memory, as int64 words (kernels/frame.py
// ARGS_WORDS): written by the start kernel, read by each frame's tail.
struct FrameArgs {
  long long t;               // the frame to run
  long long frames;          // the chunk's frame count C
  unsigned long long done;   // blocks done with frame t
  const float* scores;       // (C, B, V)
  const int* lengths;        // (B,) frames still to decode from t = 0
  void* out[OUTS];           // the stacked outputs, in LatticeStepOut / StepOut order
};

struct Cut {
  float cutoff, adaptive;
};

// GetCutoff of one cost-sorted row with `count` finite costs, with the
// plain version's branch order and float arithmetic (ops/cutoff.py).
__device__ Cut get_cutoff(const float* costs, int count, int K, float beam, int max_active,
                          int min_active, float beam_delta) {
  const float best = costs[0];
  const float beam_cutoff = best + beam;
  const float max_cut = count > max_active ? costs[min(max_active, K - 1)] : INFINITY;
  const float min_cut =
      count > min_active ? (min_active == 0 ? best : costs[min(min_active, K - 1)]) : INFINITY;
  const bool use_max = max_cut < beam_cutoff;
  const bool use_min = !use_max && min_cut > beam_cutoff;
  Cut c;
  c.cutoff = use_max ? max_cut : (use_min ? min_cut : beam_cutoff);
  c.adaptive = use_max ? (max_cut - best) + beam_delta
                       : (use_min ? (min_cut - best) + beam_delta : beam);
  return c;
}

// Loads a thread keeps in flight before its stores: a frontier's slots,
// a row's records or backpointers.
constexpr int UNROLL = 8;

// dst[i] = live ? src[i] : fill(i) for i < n, by the block: UNROLL loads a
// thread issued before any of its stores.
template <typename T, typename Fill>
__device__ __forceinline__ void copy_row(T* dst, const T* src, int n, bool live, Fill fill) {
  for (int i0 = threadIdx.x; i0 < n; i0 += UNROLL * blockDim.x) {
    T v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) v[u] = live ? src[i] : fill(i);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n) dst[i] = v[u];
    }
  }
}

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

// The first-frame mode: the chunk's start state into the slots, its
// GetCutoff, scores row 0, the active rows; block 0 writes FrameArgs.
__global__ void __launch_bounds__(THREADS) frame_start_kernel(FrameArgs* args, Config cfg,
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
    const Cut c = get_cutoff(s.costs + row, n, cfg.K, cfg.beam, cfg.max_active, cfg.min_active,
                             cfg.beam_delta);
    s.cutoff[b] = c.cutoff;
    s.adaptive_beam[b] = c.adaptive;
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
  __shared__ int smem[32];
  __shared__ long long sh_t;
  const int b = blockIdx.x;
  const int K = cfg.K;
  if (threadIdx.x == 0) sh_t = args->t;
  __syncthreads();
  const long long t = sh_t;
  const int len = args->lengths[b];
  const bool fa = t < len;
  const size_t row = (size_t)b * K;
  const size_t orow = (size_t)t * cfg.B + b;  // row (t, b) of the stacked outputs
  const float m = in.mid_costs[row];
  const float m_safe = isfinite(m) ? m : 0.0f;
  const float base_old = s.base[b];
  const float base_new = fa ? base_old + m_safe : base_old;
  const float s0 = s.costs[row];  // the carried best cost (read before any write)
  __syncthreads();

  int n_final = 0, n_mid = 0;
  int* out_states = LATTICE ? static_cast<int*>(args->out[2]) + orow * K : nullptr;
  float* out_costs = LATTICE ? static_cast<float*>(args->out[3]) + orow * K : nullptr;
  int2* out_bp = LATTICE ? nullptr : static_cast<int2*>(args->out[0]) + orow * K;
  for (int k0 = threadIdx.x; k0 < K; k0 += UNROLL * blockDim.x) {
    // The thread's slots of the frontier the row keeps (the frame's, or
    // the carried one when frozen), loads first.
    int st[UNROLL], ci[UNROLL];
    float c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k < K) {
        st[u] = fa ? in.mid_states[row + k] : s.states[row + k];
        c[u] = fa ? in.mid_costs[row + k] : s.costs[row + k];
        ci[u] = LATTICE || !fa ? -1 : in.cand_idx[row + k];
      }
    }
    int2 bp[UNROLL];  // 1-best: each slot's winning lane's (source slot, arc)
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * blockDim.x;
      if (!LATTICE && k < K) {
        const size_t lane = (size_t)b * in.N + (ci[u] >= 0 ? ci[u] : 0);
        bp[u] = !fa ? make_int2(k, -1)  // a frozen row carries every token over
                    : ci[u] >= 0 ? make_int2(in.src_slot[lane], in.arc_id[lane])
                                 : make_int2(0, -1);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * blockDim.x;
      if (k >= K) continue;
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
  if (LATTICE) {
    const auto none = [](int) { return make_int4(-1, -1, -1, -1); };
    copy_row(static_cast<int4*>(args->out[0]) + orow * in.R, in.em_rec + (size_t)b * in.R,
             in.R, fa, none);
    const int n_eps = in.D * in.Re;
    copy_row(static_cast<int4*>(args->out[1]) + orow * n_eps, in.eps_rec + (size_t)b * n_eps,
             n_eps, fa, none);
  } else {
    const int n_eps = in.D * K;
    copy_row(static_cast<int2*>(args->out[1]) + orow * n_eps, in.bp_eps + (size_t)b * n_eps,
             n_eps, fa, [K](int i) { return make_int2(i % K, -1); });
  }
  n_final = block_sum(n_final, smem);  // its barriers make the row visible to thread 0
  n_mid = block_sum(n_mid, smem);

  if (threadIdx.x == 0) {
    // The stacked outputs' common tail: num_active, best_cost, cutoff,
    // overflow, saturated (LatticeStepOut from index 4, StepOut from 2).
    constexpr int o = LATTICE ? 4 : 2;
    static_cast<int*>(args->out[o])[orow] = LATTICE ? n_final : (fa ? n_mid : n_final);
    static_cast<float*>(args->out[o + 1])[orow] =
        LATTICE || fa ? base_new : base_old + (isfinite(s0) ? s0 : 0.0f);
    static_cast<float*>(args->out[o + 2])[orow] = base_old + s.cutoff[b];
    bool ovf = in.em_ovf[b];
    if (LATTICE) ovf = ovf || in.rec_ovf[b];
    if (in.eps_ovf) ovf = ovf || in.eps_ovf[b];
    bool sat = in.num_unique[b] > K;
    if (in.eps_sat) sat = sat || in.eps_sat[b];
    static_cast<unsigned char*>(args->out[o + 3])[orow] = fa && ovf;
    static_cast<unsigned char*>(args->out[o + 4])[orow] = fa && sat;
    s.base[b] = base_new;
    // The next frame's K1 inputs: GetCutoff on the row just written.
    const Cut c = get_cutoff(s.costs + row, n_final, K, cfg.beam, cfg.max_active,
                             cfg.min_active, cfg.beam_delta);
    s.cutoff[b] = c.cutoff;
    s.adaptive_beam[b] = c.adaptive;
    s.active[b] = t + 1 < len;
  }
  if (t + 1 < args->frames) {
    const float* src = args->scores + ((size_t)(t + 1) * cfg.B + b) * cfg.V;
    float* dst = s.scores_t + (size_t)b * cfg.V;
    for (int i = threadIdx.x; i < cfg.V; i += blockDim.x) dst[i] = src[i];
  }
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&args->done, 1ull) == gridDim.x - 1) {  // every block has read t
      args->t = t + 1;
      args->done = 0;
    }
  }
}

Slots slots(void* states, void* costs, void* base, void* cutoff, void* adaptive_beam,
            void* active, void* scores_t) {
  return Slots{static_cast<int*>(states), static_cast<float*>(costs), static_cast<float*>(base),
               static_cast<float*>(cutoff), static_cast<float*>(adaptive_beam),
               static_cast<unsigned char*>(active), static_cast<float*>(scores_t)};
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
  frame_start_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<FrameArgs*>(args), cfg,
      slots(states, costs, base, cutoff, adaptive_beam, active, scores_t), in);
  return (int)cudaGetLastError();
}

// One frame's tail on `stream`: B blocks, the lattice instance when
// `lattice` is set.  Shapes as kd_frame_start's slots; mid states/costs
// (B, K); em_ovf, eps_ovf, eps_sat, rec_ovf (B,) bool (eps_ovf and eps_sat
// null without an eps closure); num_unique (B,) int32.  Lattice: em_rec
// (B, R, 4) int32, eps_rec (B, D, Re, 4).  1-best: cand_idx (B, K),
// src_slot and arc_id (B, N) int32, bp_eps (B, D, K, 2).  The frame index,
// the chunk's scores, lengths and outputs come from `args`.  Returns the
// launch's CUDA error (0 on success).
extern "C" int kd_frame_tail(void* args, int lattice, int B, int K, int V, int R, int D, int Re,
                             int N, float beam, int max_active, int min_active, float beam_delta,
                             void* states, void* costs, void* base, void* cutoff,
                             void* adaptive_beam, void* active, void* scores_t,
                             const void* mid_states, const void* mid_costs, const void* em_ovf,
                             const void* num_unique, const void* eps_ovf, const void* eps_sat,
                             const void* rec_ovf, const void* em_rec, const void* eps_rec,
                             const void* cand_idx, const void* src_slot, const void* arc_id,
                             const void* bp_eps, void* stream) {
  if (B < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const Config cfg{B, K, V, beam, max_active, min_active, beam_delta};
  TailIn in{static_cast<const int*>(mid_states), static_cast<const float*>(mid_costs),
            static_cast<const unsigned char*>(em_ovf), static_cast<const int*>(num_unique),
            static_cast<const unsigned char*>(eps_ovf), static_cast<const unsigned char*>(eps_sat),
            D, static_cast<const unsigned char*>(rec_ovf), static_cast<const int4*>(em_rec),
            static_cast<const int4*>(eps_rec), R, Re, static_cast<const int*>(cand_idx),
            static_cast<const int*>(src_slot), static_cast<const int*>(arc_id),
            static_cast<const int2*>(bp_eps), N};
  const Slots s = slots(states, costs, base, cutoff, adaptive_beam, active, scores_t);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lattice)
    frame_tail_kernel<true><<<B, THREADS, 0, st>>>(static_cast<FrameArgs*>(args), cfg, s, in);
  else
    frame_tail_kernel<false><<<B, THREADS, 0, st>>>(static_cast<FrameArgs*>(args), cfg, s, in);
  return (int)cudaGetLastError();
}
