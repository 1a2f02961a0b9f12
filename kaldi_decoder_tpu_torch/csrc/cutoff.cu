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
// writes m of them: about 0.3 MB a call at B = 16, K 2048, 0.0001 ms at
// 3.35 TB/s.  The merge needs a row's four scalars and, for each of its
// two order statistics, one key at P = 1 and some P*log2(m) keys past it:
// a few KB a call.  Both are far under a launch.
//
// The design: one block a row.  The local half: a thread a slot, the
// minimum of (cost key << 32 | slot) and the count reduced in the block,
// the prefix copied on the way.  It runs once a chunk, on the chunk's
// start state: every later frame's local half is the last step of the
// frame before's K3 shard mode (frame.cu), from the eps closure's local
// values, with no launch of its own.  The merge does not sort: each shard's
// prefix is already in order (the frontier's select orders by IEEE total
// order, so by the canonical key too; kaldi_decoder_tpu/parallel/
// graph_shard.py:470 relies on it as well), so the element that the
// stable sort puts at rank r is the one whose rank in (key, shard,
// position) order is r.  At P = 1 that is position r: thread 0 reads the
// two elements.  At P >= 2 the block first loads the row's P prefixes
// into dynamic shared memory in one coalesced round (P*m*4 bytes: 16 KB at
// P = 2, m 2048), so that no search step waits on device memory (a step
// from L2 took some 0.6 µs).  At P = 2 one warp a target rank finds its
// element by a merge-path search of the two prefixes, 32 candidates a
// round: three rounds of two shared-memory loads at m 2048.  At P > 2 one
// warp a (target rank, shard) pair finds the shard's element at that
// rank, if it holds it, by a 32-ary search over the shard's positions:
// each lane takes one of 32 evenly spaced candidates and ranks it (its
// position plus, for each other shard, a branchless binary search of that
// shard's prefix: upper bound for the shards before it, lower bound for
// those after), and a ballot narrows the range to the gap between the last
// candidate ranked at or below the target and the next; three rounds at
// m 2048, each P - 1 searches deep.  Ranking every element instead (an
// earlier design: four a thread, each a search of every shard) took
// 0.0175 ms at P = 2 on an H100 SXM at 700 W; the 32-ary search 0.0079 ms
// there, a one-thread merge path 0.0051.  A target that GetCutoff's
// branch does not read (its count not past the rank) is not searched.
// The thread or warp that finds an element leaves its bits in shared
// memory for thread 0's branch.  A row whose P*m*4 bytes pass the card's opt-in
// limit of shared memory (227 KB on an H100) is refused with the CUDA
// error of the shared-memory setting.

#include "common.cuh"

namespace {

constexpr int LOCAL_THREADS = 256;
constexpr int MERGE_THREADS = 1024;
constexpr int MERGE_UNROLL = 4;  // costs a thread of the merge loads at once

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

__device__ __forceinline__ unsigned key_at(const float* s_pre, int e) {
  return kdtorch::ordered_key(s_pre[e]);
}

// P = 2: the element at rank r by one warp, a merge-path search of the
// two prefixes (shard 0's equal keys first) for i, shard 0's elements
// among the first r + 1: the first i at which shard 0's i-th element does
// not come before shard 1's (r - i)-th.  Each round the lanes test 32
// evenly spaced i and a ballot keeps the gap between the last that comes
// before and the next; three rounds at m 2048.  Then the later of shard
// 0's (i - 1)-th and shard 1's (r - i)-th.
__device__ float rank_of_two(const float* s_pre, int m, int r) {
  const int lane = threadIdx.x & 31;
  const int k = r + 1;
  int lo = max(0, k - m), hi = min(k, m);
  while (lo < hi) {
    const int gap = hi - lo;
    const int c = gap > 32 ? lo + (int)((long)lane * gap / 32) : lo + lane;
    const bool valid = c < hi;
    const bool before = valid && key_at(s_pre, c) <= key_at(s_pre, m + k - 1 - c);
    const unsigned yes = __ballot_sync(0xffffffffu, before);
    const unsigned no = __ballot_sync(0xffffffffu, valid) & ~yes;  // all above the yes lanes
    if (yes != 0) lo = __shfl_sync(0xffffffffu, c, 31 - __clz(yes)) + 1;
    if (no != 0) hi = __shfl_sync(0xffffffffu, c, __ffs(no) - 1);
  }
  if (lo == 0) return s_pre[m + k - 1];
  if (lo == k) return s_pre[k - 1];
  const int a = lo - 1, b = m + k - lo - 1;
  return key_at(s_pre, a) <= key_at(s_pre, b) ? s_pre[b] : s_pre[a];
}

// P > 2: shard q's element at rank r of the merged order, if it holds
// it, by one warp: a 32-ary search over the shard's positions (module
// header).  Lane 0 writes the element's bits to *at.
__device__ void find_rank(const float* s_pre, int P, int m, int top, int q, int r, float* at) {
  const int lane = threadIdx.x & 31;
  int lo = -1, hi = m;  // the last position known ranked <= r (or -1), the first known above
  int lo_rank = -1;
  while (hi - lo > 1) {
    const int gap = hi - lo;
    const int c = gap > 33 ? lo + (int)((long)(lane + 1) * gap / 33) : lo + 1 + lane;
    const bool valid = c < hi;
    int rank = c;
    if (valid) {
      const unsigned key = key_at(s_pre, q * m + c);
      for (int q2 = 0; q2 < P; ++q2) {
        if (q2 == q) continue;
        int pos = 0;  // q2's keys below this one (at or below: an earlier shard)
        for (int step = top; step > 0; step >>= 1) {
          const int next = pos + step;
          if (next <= m) {
            const unsigned k = key_at(s_pre, q2 * m + next - 1);
            if (q2 < q ? k <= key : k < key) pos = next;
          }
        }
        rank += pos;
      }
    }
    const unsigned yes = __ballot_sync(0xffffffffu, valid && rank <= r);
    const unsigned no = __ballot_sync(0xffffffffu, valid) & ~yes;  // all above the yes lanes
    if (yes != 0) {
      const int l = 31 - __clz(yes);
      lo = __shfl_sync(0xffffffffu, c, l);
      lo_rank = __shfl_sync(0xffffffffu, rank, l);
    }
    if (no != 0) hi = __shfl_sync(0xffffffffu, c, __ffs(no) - 1);
  }
  if (lane == 0 && lo >= 0 && lo_rank == r) *at = s_pre[q * m + lo];
}

__global__ void __launch_bounds__(MERGE_THREADS) cutoff_merge_kernel(MergeArgs a) {
  extern __shared__ float s_pre[];  // P >= 2: the row's P prefixes, shard after shard
  __shared__ float s_at[2];         // the merged costs at ranks max_active and min_active
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
  const int m = a.m, P = a.P, PM = P * m;
  const int count = a.count[b];
  // The targets GetCutoff's branch reads: max_active's, min_active's.
  const bool want[2] = {count > a.max_active, count > a.min_active && a.min_active != 0};
  const int r_at[2] = {min(a.max_active, PM - 1), min(a.min_active, PM - 1)};
  if (P == 1) {
    if (tid != 0) return;
    const float* row = a.merged + (size_t)b * m;  // rank = position
    s_at[0] = row[r_at[0]];  // both loads at once; the branch reads only what it wants
    s_at[1] = row[r_at[1]];
  } else {
    // 1. The prefixes into shared memory: MERGE_UNROLL loads a thread in
    // flight, neighbouring threads on neighbouring costs.
    for (int e0 = 0; e0 < PM; e0 += MERGE_UNROLL * MERGE_THREADS) {
      float v[MERGE_UNROLL];
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u) {
        const int e = e0 + u * MERGE_THREADS + tid;
        const int q = e / m;
        v[u] = e < PM ? a.merged[((size_t)q * a.B + b) * m + (e - q * m)] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < MERGE_UNROLL; ++u) {
        const int e = e0 + u * MERGE_THREADS + tid;
        if (e < PM) s_pre[e] = v[u];
      }
    }
    __syncthreads();
    // 2. P = 2: a warp a target; else a warp a (target, shard) pair.
    if (P == 2) {
      const int t = tid >> 5;
      if (t < 2 && want[t]) {
        const float v = rank_of_two(s_pre, m, r_at[t]);
        if ((tid & 31) == 0) s_at[t] = v;
      }
    } else {
      int top = 1;  // the largest power of two <= m
      while (2 * top <= m) top *= 2;
      for (int w = tid >> 5; w < 2 * P; w += MERGE_THREADS / 32) {
        const int t = w / P;
        if (want[t]) find_rank(s_pre, P, m, top, w - t * P, r_at[t], &s_at[t]);
      }
    }
    __syncthreads();
    if (tid != 0) return;
  }
  const float max_cut = want[0] ? s_at[0] : INFINITY;
  const float min_cut =
      count > a.min_active ? (a.min_active == 0 ? best : s_at[1]) : INFINITY;
  const bool use_max = max_cut < beam_cutoff;
  const bool use_min = !use_max && min_cut > beam_cutoff;
  a.cutoff[b] = use_max ? max_cut : (use_min ? min_cut : beam_cutoff);
  a.adaptive[b] = use_max ? __fadd_rn(__fsub_rn(max_cut, best), a.beam_delta)
                          : (use_min ? __fadd_rn(__fsub_rn(min_cut, best), a.beam_delta) : a.beam);
}

}  // namespace

// Launches K8's local half on `stream`, a block a row.  Shapes: costs (B,
// K) float32; best (B,) float32, count (B,) int32, prefix (B, m) float32
// or null (no prefix copied), 1 <= m <= K.  Returns the launch's CUDA
// error.
extern "C" int kd_cutoff_local(const void* costs, int B, int K, int m, void* best, void* count,
                               void* prefix, void* stream) {
  if (B < 0 || K < 1 || m < 1 || m > K) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cutoff_local_kernel<<<B, LOCAL_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(costs), K, prefix != nullptr ? m : 0, static_cast<float*>(best),
      static_cast<int*>(count), static_cast<float*>(prefix));
  return (int)cudaGetLastError();
}

// Launches K8's merge on `stream`, a block a row.  Shapes: best (B,)
// float32; count (B,) int32 and merged (P, B, m) float32, each shard's
// prefix in order, or both null for the early return (best + beam, the
// full beam); cutoff and adaptive (B,) float32.  At P >= 2 a block takes
// P*m*4 bytes of shared memory; a row larger than the card allows returns
// the CUDA error of that setting.  Returns the launch's CUDA error.
extern "C" int kd_cutoff_merge(const void* best, const void* count, const void* merged, int B,
                               int P, int m, int max_active, int min_active, float beam,
                               float beam_delta, void* cutoff, void* adaptive, void* stream) {
  if (B < 0 || (merged != nullptr && (P < 1 || m < 1 || count == nullptr)) || max_active < 0 ||
      min_active < 0 || (merged != nullptr && (long)P * m > (1l << 30)))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = merged != nullptr && P >= 2 ? (size_t)P * m * sizeof(float) : 0;
  if (smem > 48 * 1024) {  // the default limit; past it the kernel must opt in
    const cudaError_t e = cudaFuncSetAttribute(
        cutoff_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) {
      cudaGetLastError();  // not left for a later launch to report
      return (int)e;
    }
  }
  MergeArgs a{static_cast<const float*>(best), static_cast<const int*>(count),
              static_cast<const float*>(merged), B, P, m, max_active, min_active, beam,
              beam_delta, static_cast<float*>(cutoff), static_cast<float*>(adaptive)};
  cutoff_merge_kernel<<<B, MERGE_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
