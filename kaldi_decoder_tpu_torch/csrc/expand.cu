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
// Each slot's em_block row arrives already gathered, (B, K, W*3+2), by
// the row gather (gather.cu) that runs just before; an inactive slot
// reads row 0 of em_block, as the reference's `safe` index does.
//
// What bounds it: per frame and utterance it writes N = KE*W + Ru*G
// candidate lanes of 16 bytes (56,832 lanes, about 0.9 MB, at the bench
// shape; 14.5 MB for B=16) and reads one row header and arc per block
// lane, one em_flat arc per remainder lane and one score per lane; the
// reads hit rows of a few MB of tables, mostly in L2.  So it is bound by
// the bytes of its output and by the scattered reads, not by arithmetic.
// The design keeps the work to one pass over the lanes:
//   1. scan   — one block per utterance: each active slot's remainder
//               unit count from its row header, an exclusive scan
//               over the slots (starts, total, overflow = total > Ru);
//   2. lanes  — one thread per lane: a block lane reads its slot's arc;
//               a remainder lane finds its owner slot by binary search
//               over the starts (the last slot with start <= lane, which
//               is what the scatter-max + running max of the reference
//               computes) and reads its arc from em_flat.  The cost is
//               (alpha + w) + (-score) with round-to-nearest adds, no
//               contraction.  The utterance minimum is a warp min, then
//               one atomicMin per warp on an order-preserving encoding;
//   3. filter — cost < best + adaptive_beam ? cost : +inf.
// Padding lanes compute what the reference computes (row 0 of em_flat,
// the owner's state), so even masked lanes agree.

#include "common.cuh"

namespace {

constexpr int EM_FIELDS = 3;
constexpr int SCAN_THREADS = 1024;
constexpr int LANE_THREADS = 256;

__device__ __forceinline__ bool slot_active(float c, float cutoff) {
  return isfinite(c) && c < cutoff;
}

__global__ void __launch_bounds__(SCAN_THREADS) expand_scan_kernel(
    const int* __restrict__ states, const float* __restrict__ costs,
    const float* __restrict__ cutoff, const int* __restrict__ rows,
    int K_full, int KE, int W, int G, int Ru,
    int* __restrict__ starts, int* __restrict__ n_units,
    int* __restrict__ total_out, int* __restrict__ last_nz,
    unsigned int* __restrict__ minkey, unsigned char* __restrict__ overflow) {
  __shared__ int smem[32];
  __shared__ int last_sh;
  const int b = blockIdx.x;
  const int row_w = W * EM_FIELDS + 2;
  const float cut = cutoff[b];
  const int per = (KE + blockDim.x - 1) / blockDim.x;
  const int k0 = min(threadIdx.x * per, KE);
  const int k1 = min(k0 + per, KE);
  if (threadIdx.x == 0) last_sh = -1;

  int local = 0, my_last = -1;
  for (int k = k0; k < k1; ++k) {
    const float a = costs[(long)b * K_full + k];
    int nu = 0;
    if (slot_active(a, cut)) {
      const int* row = rows + ((long)b * K_full + k) * row_w;
      const int row_lo = row[W * EM_FIELDS];
      const int deg = row[W * EM_FIELDS + 1];
      if (deg > W) {
        const int u_first = (row_lo + W) / G;
        nu = (row_lo + deg - 1) / G - u_first + 1;
      }
    }
    n_units[(long)b * KE + k] = nu;
    if (nu > 0) my_last = k;
    local += nu;
  }
  int total;
  int run = kdtorch::block_exclusive_scan(local, smem, &total);
  for (int k = k0; k < k1; ++k) {
    starts[(long)b * KE + k] = run;
    run += n_units[(long)b * KE + k];
  }
  if (my_last >= 0) atomicMax(&last_sh, my_last);
  __syncthreads();
  if (threadIdx.x == 0) {
    total_out[b] = total;
    last_nz[b] = last_sh < 0 ? 0 : last_sh;
    overflow[b] = total > Ru;
    minkey[b] = 0xffffffffu;
  }
}

__global__ void __launch_bounds__(LANE_THREADS) expand_lanes_kernel(
    const int* __restrict__ states, const float* __restrict__ costs,
    const float* __restrict__ cutoff, const float* __restrict__ scores,
    const int* __restrict__ rows, const int* __restrict__ em_block,
    const int* __restrict__ em_flat, const int* __restrict__ starts, const int* __restrict__ total_in,
    const int* __restrict__ last_nz, int K_full, int KE, int W, int G,
    int Ru, int V, int* __restrict__ dst, float* __restrict__ cost,
    int* __restrict__ src_state, int* __restrict__ arc_id,
    int* __restrict__ src_slot, unsigned int* __restrict__ minkey) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int NB = KE * W;
  const int N = NB + Ru * G;
  const int row_w = W * EM_FIELDS + 2;
  const float cut = cutoff[b];
  unsigned int key = 0xffffffffu;
  if (i < N) {
    int d, sidx, st, arc, slot;
    float c;
    if (i < NB) {
      const int k = i / W;
      slot = k;
      const int w = i - k * W;
      const float a = costs[(long)b * K_full + k];
      const bool act = slot_active(a, cut);
      st = act ? states[(long)b * K_full + k] : 0;
      const int* row = act ? rows + ((long)b * K_full + k) * row_w : em_block;
      d = row[w * EM_FIELDS + 1];
      sidx = row[w * EM_FIELDS + 2];
      arc = row[W * EM_FIELDS] + w;
      c = act ? __fadd_rn(a, __int_as_float(row[w * EM_FIELDS])) : INFINITY;
    } else {
      const int r = i - NB;
      const int j = r / G;
      const int g = r - j * G;
      const bool valid = j < total_in[b];
      int owner;
      if (valid) {
        // Last slot whose first lane is <= j; it owns units (see header).
        const int* sb = starts + (long)b * KE;
        int lo = 0, hi = KE - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sb[mid] <= j) lo = mid; else hi = mid - 1;
        }
        owner = lo;
      } else {
        owner = last_nz[b];
      }
      slot = owner;
      const float a = costs[(long)b * K_full + owner];
      const bool act = slot_active(a, cut);
      st = act ? states[(long)b * K_full + owner] : 0;
      const int* row = act ? rows + ((long)b * K_full + owner) * row_w : em_block;
      const int row_lo = row[W * EM_FIELDS];
      const int deg = act ? row[W * EM_FIELDS + 1] : 0;
      const int tail_lo = row_lo + W;
      const int tail_hi = row_lo + deg;
      const int u_first = deg > W ? tail_lo / G : 0;
      const int unit = u_first - starts[(long)b * KE + owner] + j;
      const int* fr = em_flat + (long)(valid ? unit : 0) * (G * EM_FIELDS) + g * EM_FIELDS;
      d = fr[1];
      sidx = fr[2];
      arc = unit * G + g;
      const bool in_range = valid && arc >= tail_lo && arc < tail_hi;
      c = in_range ? __fadd_rn(a, __int_as_float(fr[0])) : INFINITY;
    }
    c = __fadd_rn(c, -scores[(long)b * V + sidx]);
    const long o = (long)b * N + i;
    dst[o] = d;
    cost[o] = c;
    src_state[o] = st;
    arc_id[o] = arc;
    if (src_slot != nullptr) src_slot[o] = slot;
    key = kdtorch::ordered_key(c);
  }
  key = __reduce_min_sync(0xffffffffu, key);
  if ((threadIdx.x & 31) == 0 && key != 0xffffffffu) atomicMin(&minkey[b], key);
}

__global__ void __launch_bounds__(LANE_THREADS) expand_filter_kernel(
    const unsigned int* __restrict__ minkey,
    const float* __restrict__ adaptive_beam, int N, float* __restrict__ cost,
    float* __restrict__ next_cutoff) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float nc = __fadd_rn(kdtorch::from_ordered_key(minkey[b]), adaptive_beam[b]);
  if (i < N) {
    const long o = (long)b * N + i;
    const float c = cost[o];
    cost[o] = (isfinite(c) && c < nc) ? c : INFINITY;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) next_cutoff[b] = nc;
}

}  // namespace

// Launches the three passes on `stream`.  Shapes: states/costs (B,
// K_full), cutoff/adaptive_beam (B,), scores (B, V), rows (B, K_full,
// W*3+2) = em_block[states], em_block (S, W*3+2), em_flat (U, G*3);
// scratch starts/n_units (B, KE), total/last_nz/minkey (B,); outputs
// dst/cost/src_state/arc_id (B, N), overflow (B,) bytes, next_cutoff
// (B,); src_slot (B, N) or null (then not written: the lattice path
// does not read it).  Returns cudaGetLastError() after the launches.
extern "C" int kd_expand(
    const void* states, const void* costs, const void* cutoff,
    const void* adaptive_beam, const void* scores, const void* rows,
    const void* em_block, const void* em_flat, int B, int K_full, int KE,
    int W, int G, int Ru, int V, void* starts, void* n_units, void* total,
    void* last_nz, void* minkey, void* dst, void* cost, void* src_state, void* arc_id,
    void* src_slot, void* overflow, void* next_cutoff, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int N = KE * W + Ru * G;
  expand_scan_kernel<<<B, SCAN_THREADS, 0, s>>>(
      (const int*)states, (const float*)costs, (const float*)cutoff,
      (const int*)rows, K_full, KE, W, G, Ru, (int*)starts, (int*)n_units,
      (int*)total, (int*)last_nz, (unsigned int*)minkey,
      (unsigned char*)overflow);
  const dim3 grid((N + LANE_THREADS - 1) / LANE_THREADS, B);
  expand_lanes_kernel<<<grid, LANE_THREADS, 0, s>>>(
      (const int*)states, (const float*)costs, (const float*)cutoff,
      (const float*)scores, (const int*)rows, (const int*)em_block,
      (const int*)em_flat, (const int*)starts, (const int*)total,
      (const int*)last_nz, K_full, KE, W, G, Ru, V, (int*)dst, (float*)cost, (int*)src_state, (int*)arc_id,
      (int*)src_slot, (unsigned int*)minkey);
  expand_filter_kernel<<<grid, LANE_THREADS, 0, s>>>(
      (const unsigned int*)minkey, (const float*)adaptive_beam, N,
      (float*)cost, (float*)next_cutoff);
  return (int)cudaGetLastError();
}
