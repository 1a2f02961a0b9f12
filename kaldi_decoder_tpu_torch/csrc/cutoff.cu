// K8: the sharded frame's GetCutoff, its local half before the collectives
// (kd_cutoff_local) and its merge after them (kd_cutoff_merge).
//
// Replaces the XLA-compiled region of the JAX package's sharded frame
// kaldi_decoder_tpu/parallel/graph_shard.py:447 _global_cutoff around its
// collectives (the MIN of the rows' best costs, the SUM of their finite
// counts, the all-gather of each shard's cost prefix): before them each
// row's smallest finite cost (jnp.min of the masked costs), its count of
// finite costs and the prefix costs[:, :m]; after them the order
// statistics of the merged prefixes (jnp.sort, two reads) and GetCutoff's
// three-way branch with the adaptive beam (faster-decoder.cc:244-336),
// or, where neither bound can bind, best + beam and the full beam.  Plain
// versions: kaldi_decoder_tpu_torch/kernels/cutoff.py
// global_cutoff_local_plain and global_cutoff_merge_plain; every output is
// bitwise equal to theirs: a row's smallest cost is its first smallest in
// slot order, the bits of that slot; the merged order is the plain
// version's stable sort (-0.0 and +0.0 one key, ties by shard, then
// position), each element keeping its bits; best + beam, (cut - best) +
// beam_delta in float32, rounded to nearest, uncontracted.
//
// What bounds it: launches.  The local half reads a row's K costs and
// writes m of them, the merge reads the P*m merged costs: about 0.3 MB a
// call at B = 16, K 2048, P = 1, 0.0001 ms at 3.35 TB/s, far under a
// launch.
//
// The design: one block a row.  The local half: a thread a slot, the
// minimum of (cost key << 32 | slot) and the count reduced in the block,
// the prefix copied on the way.  The merge does not sort: each shard's
// prefix is already in order (the frontier's select orders by IEEE total
// order, so by the canonical key too; kaldi_decoder_tpu/parallel/
// graph_shard.py:470 relies on it as well), so the element that the
// stable sort puts at rank r is the one whose rank in (key, shard,
// position) order is r: a thread an element takes its position plus, for
// each other shard q, a binary search of q's prefix (upper bound for the
// shards before it, lower bound for those after), and the threads at
// ranks max_active and min_active (clamped to P*m - 1) leave their
// element's bits in shared memory for thread 0's branch.

#include "common.cuh"

namespace {

constexpr int LOCAL_THREADS = 256;
constexpr int MERGE_THREADS = 1024;

__global__ void __launch_bounds__(LOCAL_THREADS) cutoff_local_kernel(
    const float* __restrict__ costs, int K, int m, float* __restrict__ best,
    int* __restrict__ count, float* __restrict__ prefix) {
  __shared__ unsigned long long s_min;
  __shared__ int smem[32];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* row = costs + (size_t)b * K;
  if (tid == 0) s_min = ~0ull;
  unsigned long long mn = ~0ull;
  int finite = 0;
  for (int k = tid; k < K; k += LOCAL_THREADS) {
    const float c = row[k];
    if (k < m) prefix[(size_t)b * m + k] = c;
    if (isfinite(c)) {
      ++finite;
      mn = min(mn, (unsigned long long)kdtorch::ordered_key(c) << 32 | (unsigned)k);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mn = min(mn, __shfl_xor_sync(0xffffffffu, mn, o));
  __syncthreads();  // s_min set
  if ((tid & 31) == 0) atomicMin(&s_min, mn);
  int total;
  kdtorch::block_exclusive_scan(finite, smem, &total);  // its barriers close the atomics
  if (tid == 0) {
    best[b] = s_min == ~0ull ? INFINITY : row[(unsigned)(s_min & 0xffffffffu)];
    count[b] = total;
  }
}

struct MergeArgs {
  const float* best;    // (B,) the reduced best costs
  const int* count;     // (B,) the reduced finite counts, or null (the early return)
  const float* merged;  // (P, B, m) the gathered prefixes, or null (the early return)
  int B, P, m, max_active, min_active;
  float beam, beam_delta;
  float* cutoff;        // (B,)
  float* adaptive;      // (B,)
};

__global__ void __launch_bounds__(MERGE_THREADS) cutoff_merge_kernel(MergeArgs a) {
  __shared__ float s_at[2];  // the merged costs at ranks max_active and min_active
  const int b = blockIdx.x, tid = threadIdx.x;
  const float best = a.best[b];
  const float beam_cutoff = __fadd_rn(best, a.beam);
  if (a.merged == nullptr) {
    if (tid == 0) {
      a.cutoff[b] = beam_cutoff;
      a.adaptive[b] = a.beam;
    }
    return;
  }
  const int m = a.m, PM = a.P * m;
  const int r_max = min(a.max_active, PM - 1), r_min = min(a.min_active, PM - 1);
  for (int e = tid; e < PM; e += MERGE_THREADS) {
    const int q = e / m, j = e - q * m;
    const float v = a.merged[((size_t)q * a.B + b) * m + j];
    const unsigned key = kdtorch::ordered_key(v);
    int rank = j;
    for (int q2 = 0; q2 < a.P; ++q2) {
      if (q2 == q) continue;
      const float* pre = a.merged + ((size_t)q2 * a.B + b) * m;
      const bool upper = q2 < q;  // an earlier shard's equal keys come first
      int lo = 0, hi = m;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const unsigned k = kdtorch::ordered_key(pre[mid]);
        if (upper ? k <= key : k < key)
          lo = mid + 1;
        else
          hi = mid;
      }
      rank += lo;
    }
    if (rank == r_max) s_at[0] = v;
    if (rank == r_min) s_at[1] = v;
  }
  __syncthreads();
  if (tid != 0) return;
  const int count = a.count[b];
  const float max_cut = count > a.max_active ? s_at[0] : INFINITY;
  const float min_cut = count > a.min_active ? (a.min_active == 0 ? best : s_at[1]) : INFINITY;
  const bool use_max = max_cut < beam_cutoff;
  const bool use_min = !use_max && min_cut > beam_cutoff;
  a.cutoff[b] = use_max ? max_cut : (use_min ? min_cut : beam_cutoff);
  a.adaptive[b] = use_max ? __fadd_rn(__fsub_rn(max_cut, best), a.beam_delta)
                          : (use_min ? __fadd_rn(__fsub_rn(min_cut, best), a.beam_delta) : a.beam);
}

}  // namespace

// Launches K8's local half on `stream`, a block a row.  Shapes: costs (B,
// K) float32; best (B,) float32, count (B,) int32, prefix (B, m) float32,
// 1 <= m <= K.  Returns the launch's CUDA error.
extern "C" int kd_cutoff_local(const void* costs, int B, int K, int m, void* best, void* count,
                               void* prefix, void* stream) {
  if (B < 0 || K < 1 || m < 1 || m > K) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cutoff_local_kernel<<<B, LOCAL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), K, m, static_cast<float*>(best),
      static_cast<int*>(count), static_cast<float*>(prefix));
  return (int)cudaGetLastError();
}

// Launches K8's merge on `stream`, a block a row.  Shapes: best (B,)
// float32; count (B,) int32 and merged (P, B, m) float32, each shard's
// prefix in order, or both null for the early return (best + beam, the
// full beam); cutoff and adaptive (B,) float32.  Returns the launch's CUDA
// error.
extern "C" int kd_cutoff_merge(const void* best, const void* count, const void* merged, int B,
                               int P, int m, int max_active, int min_active, float beam,
                               float beam_delta, void* cutoff, void* adaptive, void* stream) {
  if (B < 0 || (merged != nullptr && (P < 1 || m < 1 || count == nullptr)) || max_active < 0 ||
      min_active < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  MergeArgs a{static_cast<const float*>(best), static_cast<const int*>(count),
              static_cast<const float*>(merged), B, P, m, max_active, min_active, beam,
              beam_delta, static_cast<float*>(cutoff), static_cast<float*>(adaptive)};
  cutoff_merge_kernel<<<B, MERGE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
