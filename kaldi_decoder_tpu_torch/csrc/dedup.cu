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
// dedup_select, and the two agree slot for slot, bitwise.
//
// The tie rules are the original's: a state's winner is its cheapest
// lane, the lowest lane among equal costs, with -0.0 equal to +0.0 (the
// stable sort, whose comparator folds -0.0 onto +0.0; it is also what
// lets incumbents win ties); the frontier is ordered by (cost, state)
// ascending (top_k keeps the lower index among equal values, and an index
// of the state-sorted array ranks by state), where top_k's float order
// puts -0.0 below +0.0.
//
// What bounds it: per utterance it reads the N candidate lanes (8 bytes
// each) twice, does one 8-byte atomicMin per finite lane into a
// per-utterance table of S words (13 MB for B=16 at the bench's S, held
// in L2, filled with all ones by the wrapper before each call), and
// compacts the winners (12 bytes each).  At the bench shape (N = 56,832
// lanes per utterance) that is a few tens of MB of mostly L2 traffic, so
// it is bound by the lanes' bytes and the scattered atomics, not by
// arithmetic; the select step is one block per utterance, bound by its
// passes over the winner list.  The design:
//   1. min     — one thread per lane: a finite lane does a 64-bit
//                atomicMin of (ordered cost bits << 32 | lane) into
//                table[b, dst], all ones on entry;
//   2. winners — one thread per lane: a lane whose key is its state's
//                table word is that state's winner; an atomicAdd counts
//                num_unique and compacts (total-order cost bits << 32 |
//                state) and the lane into a per-utterance list (order is
//                free here);
//   3. select  — one block per utterance: when more than K winners, a
//                radix select (8 passes of 8 bits) finds the K-th
//                smallest key; the keys at or under it (exactly
//                min(K, n), since keys are unique) are bitonic-sorted in
//                shared memory, and the block writes states, the winning
//                lanes' original costs and the lanes, padding with
//                (0, +inf, -1).
// The table is not restored: a fresh fill per call costs one memset and
// leaves no state between calls.  Lanes with +inf (or NaN) cost never
// touch the table, so their dst may be anything.  N may be smaller than
// K, and than S.

#include "common.cuh"

namespace {

constexpr int LANE_THREADS = 256;
constexpr int SELECT_THREADS = 1024;
constexpr unsigned long long EMPTY = ~0ull;

__device__ __forceinline__ bool lane_valid(float c, int d, int S) {
  return isfinite(c) && d >= 0 && d < S;
}

__global__ void __launch_bounds__(LANE_THREADS) dedup_min_kernel(
    const int* __restrict__ dst, const float* __restrict__ cost, int N, int S,
    unsigned long long* __restrict__ table) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long o = (long)b * N + i;
  const float c = cost[o];
  const int d = dst[o];
  if (!lane_valid(c, d, S)) return;
  const unsigned long long key =
      ((unsigned long long)kdtorch::ordered_key(c) << 32) | (unsigned int)i;
  atomicMin(&table[(long)b * S + d], key);
}

__global__ void __launch_bounds__(LANE_THREADS) dedup_winners_kernel(
    const int* __restrict__ dst, const float* __restrict__ cost, int N, int S,
    const unsigned long long* __restrict__ table,
    unsigned long long* __restrict__ keys, int* __restrict__ lanes,
    int* __restrict__ count) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const long o = (long)b * N + i;
  const float c = cost[o];
  const int d = dst[o];
  if (!lane_valid(c, d, S)) return;
  const unsigned long long won =
      ((unsigned long long)kdtorch::ordered_key(c) << 32) | (unsigned int)i;
  if (table[(long)b * S + d] != won) return;
  const int pos = atomicAdd(&count[b], 1);
  keys[(long)b * N + pos] =
      ((unsigned long long)kdtorch::total_order_key(c) << 32) | (unsigned int)d;
  lanes[(long)b * N + pos] = i;
}

// Dynamic shared memory: P keys (8 bytes) then P lanes (4 bytes), with P
// the power of two at or above min(K, N).
__global__ void __launch_bounds__(SELECT_THREADS) dedup_select_kernel(
    const float* __restrict__ cost, const unsigned long long* __restrict__ keys,
    const int* __restrict__ lanes, const int* __restrict__ count, int N, int K,
    int* __restrict__ out_states, float* __restrict__ out_costs,
    int* __restrict__ out_idx) {
  extern __shared__ unsigned long long sk[];
  __shared__ int hist[256];
  __shared__ unsigned long long prefix_sh;
  __shared__ int remaining_sh, taken_sh;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n = count[b];
  const int kk = min(n, K);
  int P = 1;
  while (P < kk) P <<= 1;
  int* sl = reinterpret_cast<int*>(sk + P);
  const unsigned long long* kb = keys + (long)b * N;
  const int* lb = lanes + (long)b * N;

  // Radix select of the K-th smallest key (keys are unique).
  unsigned long long thresh = EMPTY;
  if (n > K) {
    if (tid == 0) {
      prefix_sh = 0;
      remaining_sh = K;
    }
    unsigned long long mask = 0;
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int h = tid; h < 256; h += blockDim.x) hist[h] = 0;
      __syncthreads();
      const unsigned long long prefix = prefix_sh;
      for (int j = tid; j < n; j += blockDim.x) {
        const unsigned long long k = kb[j];
        if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255], 1);
      }
      __syncthreads();
      if (tid < 32) {
        // Each lane of warp 0 owns 8 consecutive bins; find the bin where
        // the running count reaches `remaining`.
        const int rem = remaining_sh;
        int local[8];
        int sum = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          local[q] = hist[tid * 8 + q];
          sum += local[q];
        }
        int incl = sum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, incl, o);
          if (tid >= o) incl += y;
        }
        const int excl = incl - sum;
        if (excl < rem && rem <= incl) {
          int run = excl, digit = tid * 8 + 7;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            if (run + local[q] >= rem) {
              digit = tid * 8 + q;
              break;
            }
            run += local[q];
          }
          prefix_sh = prefix | ((unsigned long long)digit << shift);
          remaining_sh = rem - run;
        }
      }
      mask |= 255ull << shift;
      __syncthreads();
    }
    thresh = prefix_sh;
  }

  // Gather the kk keys at or under the threshold, pad, bitonic sort.
  if (tid == 0) taken_sh = 0;
  __syncthreads();
  for (int j = tid; j < n; j += blockDim.x) {
    const unsigned long long k = kb[j];
    if (k <= thresh) {
      const int pos = atomicAdd(&taken_sh, 1);
      sk[pos] = k;
      sl[pos] = lb[j];
    }
  }
  for (int j = kk + tid; j < P; j += blockDim.x) {
    sk[j] = EMPTY;
    sl[j] = -1;
  }
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (P >> 1); t += blockDim.x) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool up = (i & size) == 0;
        const unsigned long long a = sk[i], c = sk[j];
        if ((a > c) == up) {
          sk[i] = c;
          sk[j] = a;
          const int la = sl[i];
          sl[i] = sl[j];
          sl[j] = la;
        }
      }
      __syncthreads();
    }
  }

  for (int j = tid; j < K; j += blockDim.x) {
    const long o = (long)b * K + j;
    if (j < kk) {
      const int lane = sl[j];
      out_states[o] = (int)(sk[j] & 0xffffffffull);
      out_costs[o] = cost[(long)b * N + lane];
      out_idx[o] = lane;
    } else {
      out_states[o] = 0;
      out_costs[o] = INFINITY;
      out_idx[o] = -1;
    }
  }
}

}  // namespace

// Shared memory the select step needs for K slots from N lanes.
extern "C" long long kd_dedup_smem_bytes(int N, int K) {
  const int kk = N < K ? N : K;
  long long P = 1;
  while (P < kk) P <<= 1;
  return P * (long long)(sizeof(unsigned long long) + sizeof(int));
}

// Launches the three steps on `stream`.  Shapes: dst/cost (B, N); table
// (B, S) 64-bit words, all ones on entry (scratch: changed on return);
// scratch keys (B, N) 64-bit and lanes (B, N); outputs
// states/costs/cand_idx (B, K), num_unique (B,).  Returns
// cudaGetLastError() after the launches.
extern "C" int kd_dedup(const void* dst, const void* cost, int B, int N, int S,
                        int K, void* table, void* keys, void* lanes,
                        void* states, void* costs, void* cand_idx,
                        void* num_unique, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(num_unique, 0, sizeof(int) * (size_t)B, s);
  const dim3 grid((N + LANE_THREADS - 1) / LANE_THREADS, B);
  if (N > 0) {
    dedup_min_kernel<<<grid, LANE_THREADS, 0, s>>>(
        (const int*)dst, (const float*)cost, N, S, (unsigned long long*)table);
    dedup_winners_kernel<<<grid, LANE_THREADS, 0, s>>>(
        (const int*)dst, (const float*)cost, N, S,
        (const unsigned long long*)table, (unsigned long long*)keys,
        (int*)lanes, (int*)num_unique);
  }
  const size_t smem = (size_t)kd_dedup_smem_bytes(N, K);
  // The opt-in limit is an attribute of the current device, and the
  // kernel's static arrays count against the default 48 KB too, so it is
  // set on every launch (a cheap call).
  const cudaError_t e = cudaFuncSetAttribute(
      dedup_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dedup_select_kernel<<<B, SELECT_THREADS, smem, s>>>(
      (const float*)cost, (const unsigned long long*)keys, (const int*)lanes,
      (const int*)num_unique, N, K, (int*)states, (float*)costs, (int*)cand_idx);
  return (int)cudaGetLastError();
}
