// K7: the shard route, its send side (kd_route_send) and its receive side
// (kd_route_recv).
//
// Replaces the XLA-compiled region of the JAX package's sharded frame
// kaldi_decoder_tpu/parallel/graph_shard.py:213 _route (per row a 3-key
// lax.sort by (owner, local state, cost), two associative_scans and a
// scatter into the (P, cap) send buffer, under shard_map), with what the
// frame applies to the lanes before it: the global beam filter of the
// emitting call (cost < cutoff, else +inf) and the payload's global
// offsets (slot + slot_add, or slot_states[slot] + slot_add; arc +
// arc_add).  The receive side replaces the reshape after the all_to_all
// and, on an eps iteration, the concatenation of the K incumbents before
// the routed lanes.  Plain versions: kaldi_decoder_tpu_torch/kernels/
// route.py route_send_plain and route_recv_plain; every output is bitwise
// equal to theirs (a float is only compared, copied, or subtracted once
// in the lattice slack test, c - run_min, round to nearest, as plain).
//
// What bounds them: bytes.  The send side reads each lane's destination
// and cost, the kept lanes' payload, and writes the whole (P, B, cap, 4)
// int32 send buffer: at the emitting shard shape (B 16, N 30,720, cap
// 30,720) about 12 MB at P = 1 and 20 MB a rank at P = 2, 0.004-0.006 ms
// at 3.35 TB/s.  The receive side reads that buffer and writes four int32
// or float columns of the same lanes (and the incumbents).
//
// The send side's design (a simple one: one block of 1024 threads a row):
//   1. The row's valid lanes (finite cost under the cutoff, destination in
//      [0, P*Sp)) are compacted in lane order into device scratch, each
//      keyed with 64 bits: the destination in the high half (ordering by
//      it is ordering by (owner, local state): owner*Sp + local is
//      monotone) and common.cuh:ordered_key(cost) in the low half (-0.0
//      and +0.0 one key).  The block ORs and ANDs the keys.
//   2. A stable LSD radix sort of the keys with the lane as value, 8-bit
//      digits, skipping each digit that is constant over the row (OR and
//      AND agree on it).  A pass gives each warp a contiguous chunk: the
//      warp counts its chunk's digits in its own row of shared memory, a
//      thread a digit turns the rows into each warp's place in the digit
//      and a block scan the digits' totals into their first places, and
//      each warp scatters its chunk in order, 32 keys at a time (the lanes
//      of one digit ranked by __match_any_sync): stable, so equal keys
//      keep lane order.  Keys and values live in two (B, N) buffers of
//      device memory used in turns (a row's 30,720 keys and lanes, 368 KB,
//      exceed a block's shared memory), which L2 holds.
//   3. One pass over the sorted lanes in tiles of the block: the run
//      leaders (a new destination), the run minimum (the cost at the last
//      leader, a block max scan of leader positions), the keep test, the
//      exclusive count of kept lanes in the owner run (a block sum scan
//      and a max scan of owner-run starts), each kept lane with a place
//      under cap written to (owner, b, place) with its payload, which only
//      a kept lane reads; the owners' kept counts.
//   4. The rest of each owner's bucket gets the fill [0, INF_BITS, 0,
//      NO_ARC], so no byte of the buffer is written twice.
// The receive side: one thread an output lane.  Measured (PERF.md,
// scripts/profile_torch_k7_steps.py): the sort's passes take most of a
// call, each some 30 µs over 23,000 keys, a block a row leaving most SMs
// idle at B = 16.

#include "common.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int DIGITS = 256;     // 8-bit digits
constexpr int UNROLL = 8;       // keys a lane loads before it counts or scatters them
constexpr int MAX_PARTS = 64;   // kernels/route.py MAX_PARTS
constexpr int INF_BITS = 0x7f800000;
constexpr int NO_ARC = -1;
constexpr int RECV_THREADS = 256;

// K7 send's step marks: the global timer (ns) at each, by thread 0 of the
// first MARKED rows' blocks, then the row's valid lanes and sort passes.
// Built only with KD_STEP_MARKS (scripts/profile_torch_k7_steps.py).
#ifdef KD_STEP_MARKS
constexpr int MARKED = 16;
constexpr int STEP_MARKS = 5;
__device__ unsigned long long k7_marks[MARKED][STEP_MARKS + 2];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// The bytes of v that are not zero: the sort's passes.
__device__ __forceinline__ int varying_bytes(unsigned long long v) {
  int n = 0;
  for (int i = 0; i < 64; i += 8) n += ((v >> i) & 0xff) != 0;
  return n;
}
#define K7_MARK(i) \
  if (tid == 0 && b < MARKED) k7_marks[b][i] = globaltimer()
#define K7_NOTE(i, v) \
  if (tid == 0 && b < MARKED) k7_marks[b][STEP_MARKS + (i)] = (v)
#else
#define K7_MARK(i)
#define K7_NOTE(i, v)
#endif

struct SendArgs {
  const int* dst;               // (B, N) global destination states
  const float* cost;            // (B, N)
  const int* src;               // (B, N) the payload's slot, or a slot of slot_states
  const int* arc;               // (B, N)
  const float* cutoff;          // (B,) or null
  const int* slot_states;       // (B, K) or null
  int B, N, K, sp, P, cap, slot_add, arc_add, lattice;
  float slack;
  unsigned long long* keys[2];  // (B, N) each, used in turns
  int* vals[2];                 // (B, N) each
  int4* send;                   // (P, B, cap)
  unsigned char* overflow;      // (B,)
};

__device__ __forceinline__ unsigned lanemask_lt() { return (1u << (threadIdx.x & 31)) - 1u; }

// Inclusive max scan of one int a thread, in thread order.
__device__ __forceinline__ int block_max_scan(int v, int* smem) {
  int total;
  const int ex = kdtorch::block_exclusive_scan(
      v, smem, &total, [](int x, int y) { return x > y ? x : y; }, -1);
  return ex > v ? ex : v;
}

__global__ void __launch_bounds__(THREADS) route_send_kernel(SendArgs a) {
  __shared__ int cnt[WARPS][DIGITS];
  __shared__ int smem[32];
  __shared__ unsigned long long s_or, s_and;
  __shared__ int s_kept[MAX_PARTS];
  __shared__ float s_cost[THREADS];
  __shared__ int s_g[THREADS];
  __shared__ int s_carry_kept, s_carry_obase;
  __shared__ float s_carry_min;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * a.N;
  const unsigned limit = (unsigned)(a.P * a.sp);
  const float cut = a.cutoff != nullptr ? a.cutoff[b] : INFINITY;
  if (tid < a.P) s_kept[tid] = 0;
  if (tid == 0) {
    s_or = 0;
    s_and = ~0ull;
    s_carry_kept = s_carry_obase = 0;
    s_carry_min = 0.f;
  }
  __syncthreads();
  K7_MARK(0);

  // 1. The valid lanes in lane order, keyed.
  unsigned long long k_or = 0, k_and = ~0ull;
  int n = 0;
  {
    unsigned long long* keys = a.keys[0] + row;
    int* vals = a.vals[0] + row;
    for (int i0 = 0; i0 < a.N; i0 += THREADS) {
      const int i = i0 + tid;
      bool valid = false;
      unsigned long long key = 0;
      if (i < a.N) {
        const int d = a.dst[row + i];
        const float c = a.cost[row + i];
        valid = isfinite(c) && c < cut && (unsigned)d < limit;
        key = (unsigned long long)(unsigned)d << 32 | kdtorch::ordered_key(c);
      }
      int total;
      const int at = n + kdtorch::block_exclusive_scan(valid ? 1 : 0, smem, &total);
      if (valid) {
        keys[at] = key;
        vals[at] = i;
        k_or |= key;
        k_and &= key;
      }
      n += total;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    k_or |= __shfl_xor_sync(0xffffffffu, k_or, o);
    k_and &= __shfl_xor_sync(0xffffffffu, k_and, o);
  }
  if (lane == 0) {
    atomicOr(&s_or, k_or);
    atomicAnd(&s_and, k_and);
  }
  __syncthreads();
  const unsigned long long varying = s_or ^ s_and;
  K7_MARK(1);
  K7_NOTE(0, n);

  // 2. The stable LSD radix sort over the digits that vary.
  int cur = 0;
  const int lo = (int)((long long)n * warp / WARPS), hi = (int)((long long)n * (warp + 1) / WARPS);
  for (int shift = 0; n > 1 && shift < 64; shift += 8) {
    if (((varying >> shift) & 0xff) == 0) continue;
    const unsigned long long* ks = a.keys[cur] + row;
    const int* vs = a.vals[cur] + row;
    unsigned long long* kd = a.keys[cur ^ 1] + row;
    int* vd = a.vals[cur ^ 1] + row;
    for (int dg = lane; dg < DIGITS; dg += 32) cnt[warp][dg] = 0;
    __syncwarp();
    for (int j0 = lo; j0 < hi; j0 += 32 * UNROLL) {
      unsigned long long kk[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        kk[u] = j < hi ? ks[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 + u * 32 + lane < hi) atomicAdd(&cnt[warp][(int)(kk[u] >> shift) & 0xff], 1);
    }
    __syncthreads();
    int total = 0;
    if (tid < DIGITS) {
      for (int w = 0; w < WARPS; ++w) {
        const int c = cnt[w][tid];
        cnt[w][tid] = total;
        total += c;
      }
    }
    int all;
    const int start = kdtorch::block_exclusive_scan(tid < DIGITS ? total : 0, smem, &all);
    if (tid < DIGITS)
      for (int w = 0; w < WARPS; ++w) cnt[w][tid] += start;
    __syncthreads();
    for (int j0 = lo; j0 < hi; j0 += 32 * UNROLL) {
      unsigned long long kk[UNROLL];
      int vv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u * 32 + lane;
        kk[u] = j < hi ? ks[j] : 0;
        vv[u] = j < hi ? vs[j] : 0;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool act = j0 + u * 32 + lane < hi;
        const int dg = act ? (int)(kk[u] >> shift) & 0xff : DIGITS + lane;
        const unsigned peers = __match_any_sync(0xffffffffu, dg);
        const int pos = act ? cnt[warp][dg] + __popc(peers & lanemask_lt()) : 0;
        __syncwarp();
        if (act && (peers >> lane) == 1u) cnt[warp][dg] = pos + 1;  // its digit's last lane
        __syncwarp();
        if (act) {
          kd[pos] = kk[u];
          vd[pos] = vv[u];
        }
      }
    }
    cur ^= 1;
    __syncthreads();
  }
  K7_MARK(2);
  K7_NOTE(1, n > 1 ? varying_bytes(varying) : 0);

  // 3. Leaders, run minima, the within-owner count and the kept lanes.
  const unsigned long long* ks = a.keys[cur] + row;
  const int* vs = a.vals[cur] + row;
  bool ovf = false;
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const int i = i0 + tid;
    const bool act = i < n;
    const int carry_kept = s_carry_kept, carry_obase = s_carry_obase;
    const float carry_min = s_carry_min;
    unsigned long long key = 0, prev = 0, next = 0;
    int li = 0;
    if (act) {
      key = ks[i];
      li = vs[i];
      if (i > 0) prev = ks[i - 1];
      if (i + 1 < n) next = ks[i + 1];
    }
    const int d = (int)(key >> 32), owner = d / a.sp;
    const int pd = (int)(prev >> 32), nd = (int)(next >> 32);
    const bool state_leader = act && (i == 0 || pd != d);
    const bool owner_leader = act && (i == 0 || pd / a.sp != owner);
    const bool owner_last = act && (i + 1 == n || nd / a.sp != owner);
    const float c = act ? a.cost[row + li] : 0.f;
    bool keep = state_leader;
    float run_min = 0.f;
    if (a.lattice) {
      s_cost[tid] = c;
      const int at = block_max_scan(state_leader ? i : -1, smem);
      run_min = at >= i0 ? s_cost[at - i0] : carry_min;
      keep = act && __fsub_rn(c, run_min) <= a.slack;
    }
    int kept_total;
    const int g = carry_kept + kdtorch::block_exclusive_scan(keep ? 1 : 0, smem, &kept_total);
    s_g[tid] = g;
    const int oat = block_max_scan(owner_leader ? i : -1, smem);
    const int obase = oat >= i0 ? s_g[oat - i0] : carry_obase;
    const int within = g - obase;
    if (keep && within < a.cap) {
      const int s0 = a.src[row + li];
      const int slot = (a.slot_states != nullptr
                            ? a.slot_states[(size_t)b * a.K + min(max(s0, 0), a.K - 1)]
                            : s0) + a.slot_add;
      a.send[((size_t)owner * a.B + b) * a.cap + within] =
          make_int4(d - owner * a.sp, __float_as_int(c), slot, a.arc[row + li] + a.arc_add);
    }
    ovf |= keep && within >= a.cap;
    if (owner_last) s_kept[owner] = within + (keep ? 1 : 0);
    if (i == min(n, i0 + THREADS) - 1) {  // the tile's last lane carries into the next
      s_carry_kept = g + (keep ? 1 : 0);
      s_carry_obase = obase;
      s_carry_min = run_min;
    }
    __syncthreads();
  }
  ovf = __syncthreads_or(ovf);
  if (tid == 0) a.overflow[b] = ovf;
  K7_MARK(3);

  // 4. The rest of each owner's bucket.
  for (int p = 0; p < a.P; ++p) {
    int4* bucket = a.send + ((size_t)p * a.B + b) * a.cap;
    for (int j = min(s_kept[p], a.cap) + tid; j < a.cap; j += THREADS)
      bucket[j] = make_int4(0, INF_BITS, 0, NO_ARC);
  }
#ifdef KD_STEP_MARKS
  __syncthreads();
  K7_MARK(4);
#endif
}

__global__ void __launch_bounds__(RECV_THREADS) route_recv_kernel(
    const int4* recv, const int* inc_states, const float* inc_costs, int B, int P, int cap, int K,
    int sp, int has_base, int base, int* state, float* cost, int* gslot, int* arc) {
  const int L = K + P * cap;
  const int idx = blockIdx.x * RECV_THREADS + threadIdx.x;
  if (idx >= B * L) return;
  const int b = idx / L, j = idx - b * L;
  if (j < K) {  // an incumbent: the frontier token itself
    state[idx] = inc_states[b * K + j];
    cost[idx] = inc_costs[b * K + j];
    gslot[idx] = has_base ? base + j : -1;
    arc[idx] = NO_ARC;
    return;
  }
  const int q = j - K, p = q / cap;
  const int4 v = recv[((size_t)p * B + b) * cap + (q - p * cap)];
  const float c = __int_as_float(v.y);
  state[idx] = isfinite(c) ? v.x : sp;
  cost[idx] = c;
  gslot[idx] = v.z;
  arc[idx] = v.w;
}

}  // namespace

// Launches K7's send side on `stream`: B blocks of THREADS.  Shapes:
// dst/cost/src/arc (B, N) int32/float32/int32/int32; cutoff (B,) float32
// or null; slot_states (B, K) int32 or null; keys0/keys1 (B, N) int64 and
// vals0/vals1 (B, N) int32 scratch; send (P, B, cap, 4) int32; overflow
// (B,) bool.  `lattice` keeps every lane within `slack` of its run's
// leader, else only the leaders.  Returns the launch's CUDA error.
extern "C" int kd_route_send(const void* dst, const void* cost, const void* src, const void* arc,
                             const void* cutoff, const void* slot_states, int B, int N, int K,
                             int sp, int P, int cap, int slot_add, int arc_add, int lattice,
                             float slack, void* keys0, void* keys1, void* vals0, void* vals1,
                             void* send, void* overflow, void* stream) {
  if (B < 0 || N < 0 || sp < 1 || cap < 1 || P < 1 || P > MAX_PARTS ||
      (long long)P * sp >= (1ll << 31) || (slot_states != nullptr && K < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  SendArgs a{static_cast<const int*>(dst), static_cast<const float*>(cost),
             static_cast<const int*>(src), static_cast<const int*>(arc),
             static_cast<const float*>(cutoff), static_cast<const int*>(slot_states),
             B, N, K, sp, P, cap, slot_add, arc_add, lattice, slack,
             {static_cast<unsigned long long*>(keys0), static_cast<unsigned long long*>(keys1)},
             {static_cast<int*>(vals0), static_cast<int*>(vals1)},
             static_cast<int4*>(send), static_cast<unsigned char*>(overflow)};
  route_send_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Launches K7's receive side on `stream`, one thread an output lane.
// Shapes: recv (P, B, cap, 4) int32; inc_states/inc_costs (B, K) int32 /
// float32 or null (K = 0); outputs (B, K + P*cap) int32 / float32 / int32
// / int32, B * (K + P*cap) < 2^31.  The incumbents' slots are base + k
// when has_base, else -1.  Returns the launch's CUDA error.
extern "C" int kd_route_recv(const void* recv, const void* inc_states, const void* inc_costs,
                             int B, int P, int cap, int K, int sp, int has_base, int base,
                             void* state, void* cost, void* gslot, void* arc, void* stream) {
  const long long total = (long long)B * (K + (long long)P * cap);
  if (B < 0 || P < 1 || cap < 1 || K < 0 || total >= (1ll << 31) ||
      (K > 0 && (inc_states == nullptr || inc_costs == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const int blocks = (int)((total + RECV_THREADS - 1) / RECV_THREADS);
  route_recv_kernel<<<blocks, RECV_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(recv), static_cast<const int*>(inc_states),
      static_cast<const float*>(inc_costs), B, P, cap, K, sp, has_base, base,
      static_cast<int*>(state), static_cast<float*>(cost), static_cast<int*>(gslot),
      static_cast<int*>(arc));
  return (int)cudaGetLastError();
}

#ifdef KD_STEP_MARKS
// The last send launch's marks: MARKED rows of STEP_MARKS timer readings
// (ns), then the row's valid lanes and its sort passes, as int64.
extern "C" int kd_route_send_marks(void* out) {
  return (int)cudaMemcpyFromSymbol(out, k7_marks, sizeof(k7_marks));
}
#endif
