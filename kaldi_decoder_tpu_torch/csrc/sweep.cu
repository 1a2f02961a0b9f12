// K4: the windowed backward extra-cost sweep of one chunk (no eps links).
//
// Replaces the XLA-compiled reverse scan of the JAX package's
// kaldi_decoder_tpu/decoders/sweep.py:_sweep_one (with _join_min,
// _compact_rows and _append) for graphs whose device side has no eps
// arcs.  Its plain torch version is
// kaldi_decoder_tpu_torch/decoders/sweep.py:sweep_plain; survivor counts,
// overflow flags and rows[:count] agree exactly.
//
// What bounds it: the sweep is sequential over the chunk's T frames; per
// frame and utterance it reads the K frontier slots (8 bytes each) and R
// lattice records (16 bytes each): 160 KB per frame at the bench shape,
// 80 MB per utterance-chunk, 1.3 GB per chunk of B=16.  The work inside a
// frame is parallel but small, so the loop is bound by the latency of its
// dependent phases more than by bandwidth.  The design:
//   * one persistent block per utterance walks t = T-1 .. 0, with the
//     carried extras of the frame's K slots in shared memory;
//   * the join of the reference (a dense R x K compare, a TPU choice)
//     becomes a per-utterance table of S floats in device memory: a
//     scatter-min of the slot extras, a gather per record, and a second
//     scatter that resets the touched entries to +inf.  All joined values
//     are >= 0 or +inf, so an int atomicMin on the float bits is exact
//     once -0.0 is canonicalised.  Every frontier slot is scattered, dead
//     ones (state 0) included, exactly as the compare sees them; record
//     padding rows (-1 states) never touch the table;
//   * the stable compactions become block-wide prefix sums over
//     contiguous per-thread ranges, which keep the original row order;
//   * the appends are clamped at the caps exactly as the reference's
//     dynamic_update_slice appends are.

#include "common.cuh"

namespace {

constexpr int SWEEP_THREADS = 1024;

__device__ __forceinline__ void table_min(float* tab, int s, float v) {
  atomicMin(reinterpret_cast<int*>(tab + s), __float_as_int(kdtorch::canon_zero(v)));
}

__global__ void __launch_bounds__(SWEEP_THREADS) sweep_kernel(
    const int* __restrict__ fstates, const float* __restrict__ fcosts,
    const int* __restrict__ em, const int* __restrict__ init_states,
    const int* __restrict__ rem, int T, int B, int K, int R, int S,
    int tok_cap, int em_cap, float tok_thr, float em_thr,
    float* __restrict__ table, float* __restrict__ lebuf,
    int* __restrict__ tok_rows, int* __restrict__ em_rows,
    int* __restrict__ tok_count, int* __restrict__ em_count,
    unsigned char* __restrict__ overflow) {
  extern __shared__ float extra[];  // (K,) extras in the slot layout of frame t+1
  __shared__ int smem[32];
  const int b = blockIdx.x;
  float* tab = table + (long)b * S;
  float* le_b = lebuf + (long)b * R;
  int* tok_out = tok_rows + (long)b * (tok_cap + K) * 3;
  int* em_out = em_rows + (long)b * (em_cap + R) * 3;

  for (int s = threadIdx.x; s < S; s += blockDim.x) tab[s] = INFINITY;
  const int perK = (K + blockDim.x - 1) / blockDim.x;
  const int k0 = min((int)threadIdx.x * perK, K), k1 = min(k0 + perK, K);
  const int perR = (R + blockDim.x - 1) / blockDim.x;
  const int r0 = min((int)threadIdx.x * perR, R), r1 = min(r0 + perR, R);
  for (int k = k0; k < k1; ++k) extra[k] = INFINITY;
  __syncthreads();

  const int boundary = min(rem[b], T);  // token frame with extra == 0
  int tok_off = 0, em_off = 0;          // block-uniform
  bool ovf = false;

  for (int t = T - 1; t >= 0; --t) {
    const int f = t + 1;  // token-frame index of frontier[t]
    const bool at_boundary = f >= boundary;
    const bool emit = f <= boundary;  // frames past the boundary are frozen
    const int* st1 = fstates + ((long)t * B + b) * K;
    const float* al1 = fcosts + ((long)t * B + b) * K;
    const int* emt = em + ((long)t * B + b) * R * 4;

    // Extras of frame f, and its surviving tokens.
    int cnt = 0;
    for (int k = k0; k < k1; ++k) {
      const float a = al1[k];
      const bool live = isfinite(a);
      const float e = at_boundary ? (live ? 0.0f : INFINITY) : extra[k];
      extra[k] = e;
      cnt += (emit && live && e <= tok_thr);
    }
    int tot;
    int pos = kdtorch::block_exclusive_scan(cnt, smem, &tot);
    int off_w = min(tok_off, tok_cap);
    for (int k = k0; k < k1; ++k) {
      const float a = al1[k];
      if (emit && isfinite(a) && extra[k] <= tok_thr) {
        int* row = tok_out + (long)(off_w + pos) * 3;
        row[0] = f;
        row[1] = st1[k];
        row[2] = __float_as_int(a);
        ++pos;
      }
    }
    int new_off = off_w + tot;
    ovf |= new_off > tok_cap;
    tok_off = min(new_off, tok_cap + K);

    // Join: extra of each record's destination state.
    for (int k = k0; k < k1; ++k) {
      const int s = st1[k];
      if (s >= 0) table_min(tab, s, extra[k]);
    }
    __syncthreads();
    cnt = 0;
    for (int r = r0; r < r1; ++r) {
      const int* rec = emt + (long)r * 4;
      float le = INFINITY;
      if (rec[1] >= 0) {
        const int d = rec[2];
        const float ex = d >= 0 ? __ldcg(tab + d) : INFINITY;
        le = __fadd_rn(ex, __int_as_float(rec[3]));
      }
      const bool keep = emit && le <= em_thr;
      le_b[r] = keep ? fmaxf(le, 0.0f) : INFINITY;
      cnt += keep;
    }
    pos = kdtorch::block_exclusive_scan(cnt, smem, &tot);
    off_w = min(em_off, em_cap);
    for (int r = r0; r < r1; ++r) {
      if (le_b[r] < INFINITY) {
        const int* rec = emt + (long)r * 4;
        int* row = em_out + (long)(off_w + pos) * 3;
        row[0] = t;
        row[1] = rec[0];
        row[2] = rec[1];
        ++pos;
      }
    }
    new_off = off_w + tot;
    ovf |= new_off > em_cap;
    em_off = min(new_off, em_cap + R);
    for (int k = k0; k < k1; ++k) {
      const int s = st1[k];
      if (s >= 0) tab[s] = INFINITY;
    }
    __syncthreads();

    // Base extras of frame t: min over kept links per source state,
    // joined on the previous frontier's slots.
    for (int r = r0; r < r1; ++r) {
      const float v = le_b[r];
      if (v < INFINITY) {
        const int src = emt[(long)r * 4];
        if (src >= 0) table_min(tab, src, v);
      }
    }
    __syncthreads();
    const int* prev = t > 0 ? fstates + ((long)(t - 1) * B + b) * K
                            : init_states + (long)b * K;
    for (int k = k0; k < k1; ++k) {
      const int s = prev[k];
      extra[k] = s >= 0 ? __ldcg(tab + s) : INFINITY;
    }
    __syncthreads();
    for (int r = r0; r < r1; ++r) {
      if (le_b[r] < INFINITY) {
        const int src = emt[(long)r * 4];
        if (src >= 0) tab[src] = INFINITY;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    tok_count[b] = min(tok_off, tok_cap);
    em_count[b] = min(em_off, em_cap);
    overflow[b] = ovf;
  }
}

}  // namespace

// Launches the sweep of one chunk on `stream`, one block per utterance.
// Shapes: fstates/fcosts (T, B, K), em (T, B, R, 4), init_states (B, K),
// rem (B,); scratch table (B, S), lebuf (B, R); outputs tok_rows (B,
// tok_cap + K, 3), em_rows (B, em_cap + R, 3), tok_count/em_count (B,),
// overflow (B,) bytes.  Returns cudaGetLastError() after the launch.
extern "C" int kd_sweep(
    const void* fstates, const void* fcosts, const void* em,
    const void* init_states, const void* rem, int T, int B, int K, int R,
    int S, int tok_cap, int em_cap, float tok_thr, float em_thr, void* table,
    void* lebuf, void* tok_rows, void* em_rows, void* tok_count,
    void* em_count, void* overflow, void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<B, SWEEP_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      (const int*)fstates, (const float*)fcosts, (const int*)em,
      (const int*)init_states, (const int*)rem, T, B, K, R, S, tok_cap, em_cap,
      tok_thr, em_thr, (float*)table, (float*)lebuf, (int*)tok_rows,
      (int*)em_rows, (int*)tok_count, (int*)em_count, (unsigned char*)overflow);
  return (int)cudaGetLastError();
}
