// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace kdtorch {

// Exclusive prefix of one int per thread across the block, in thread
// order, under the associative `op` with `identity` (a sum by default).
// blockDim.x must be a multiple of 32 (at most 1024); every thread of the
// block must call it.  `smem` holds 32 ints.  Returns the thread's
// exclusive prefix and writes the block's whole reduction to *total.
template <typename Op>
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem, int* total, Op op,
                                                    int identity) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = op(y, x);
  }
  const int before_in_warp = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? smem[lane] : identity;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = op(y, s);
    }
    smem[lane] = s;  // inclusive prefix of the warp reductions
  }
  __syncthreads();
  const int before = warp > 0 ? smem[warp - 1] : identity;
  *total = smem[nwarps - 1];
  __syncthreads();  // smem may be reused by the next call
  return op(before, lane > 0 ? before_in_warp : identity);
}
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem, int* total) {
  return block_exclusive_scan(v, smem, total, [](int a, int b) { return a + b; }, 0);
}

// Block `rank` of 2^lg's share [x, y) of n items: ranges of a multiple of
// 32 items in rank order (a block may own none).
__device__ __forceinline__ int2 share(int n, int lg, int rank) {
  const int per = (((n + (1 << lg) - 1) >> lg) + 31) & ~31;
  const int lo = min(n, rank * per);
  return make_int2(lo, min(n, lo + per));
}

// x as the compiler must have it here: its first use, and the wait for the
// load that gives it, stay after the loads issued before this point.
__device__ __forceinline__ int pin(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// -0.0 and +0.0 compare equal in the sorts of the reference; give them
// one bit pattern before any bitwise min.
__device__ __forceinline__ float canon_zero(float x) { return x == 0.0f ? 0.0f : x; }

// Float -> uint key in IEEE total order (unsigned compare = float
// compare, with -0.0 below +0.0), for non-NaN floats.
__device__ __forceinline__ unsigned int total_order_key(float c) {
  unsigned int u = __float_as_uint(c);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The same with -0.0 made +0.0 first: unsigned compare = float compare.
__device__ __forceinline__ unsigned int ordered_key(float c) {
  return total_order_key(canon_zero(c));
}

__device__ __forceinline__ float from_ordered_key(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// ---- The routed lane source (a sharded eps iteration's lanes) ---------------
// A sharded eps iteration's dedup call reads its lanes where they lie: the
// K incumbents (the carried frontier) and the (P, B, cap) entries [local
// state, cost bits, slot, arc] that the all_to_all delivered, slice p from
// rank p (kernels/route.py RoutedArgs).  Lane j < K of row b is incumbent
// j: its state and cost, slot base + j (-1 when !has_base) and arc -1;
// lane j >= K is recv[p, b, c], p, c = divmod(j - K, cap), its state sp
// where its cost is not finite.  This is the layout K7's receive side
// wrote for the dedup call (kernels/route.py route_recv_plain, the
// concatenation of kaldi_decoder_tpu/parallel/graph_shard.py:395-398), read
// in place: the dedup calls of K6 and K2 and the eps step's shard mode
// resolve a lane through routed_entry, so the receive side has no launch
// on an eps iteration.
struct RoutedArgs {         // kernels/route.py RoutedArgs
  const int4* recv;        // (P, B, cap)
  const int* inc_states;   // (B, K)
  const float* inc_costs;  // (B, K)
  int B, P, cap, K, sp, has_base, base;
};
struct Routed : RoutedArgs {
  unsigned magic;  // min(floor(2^32 / cap), 2^32 - 1): q / cap by a multiply-high
};

// The routed lanes a launch's host pointer to RoutedArgs gives (null:
// none, all zeros).
inline Routed routed_of(const void* p) {
  Routed r{};
  if (p != nullptr) {
    static_cast<RoutedArgs&>(r) = *static_cast<const RoutedArgs*>(p);
    r.magic = r.cap > 1 ? (unsigned)((1ull << 32) / (unsigned)r.cap) : 0xffffffffu;
  }
  return r;
}

// Whether `r` is the lanes of B rows of N: N = K + P * cap, the entries
// and, with K, the incumbents given, every index in int range.
inline bool routed_fits(const Routed& r, int B, int N) {
  return r.recv != nullptr && r.B == B && r.P >= 1 && r.cap >= 1 && r.K >= 0 && r.sp >= 1 &&
         (long long)r.K + (long long)r.P * r.cap == N &&
         (long long)r.P * r.B * r.cap < (1ll << 31) &&
         (r.K == 0 || (r.inc_states != nullptr && r.inc_costs != nullptr));
}

// Where lane j of row b lies: recv's entry, or null for incumbent j.
// p = q / cap without a division: the multiply-high is p or p - 1 (q <
// 2^31), and one compare settles it.
__device__ __forceinline__ const int4* routed_entry(const Routed& r, int b, int j) {
  if (j < r.K) return nullptr;
  const unsigned q = (unsigned)(j - r.K);
  unsigned p = __umulhi(q, r.magic), c = q - p * (unsigned)r.cap;
  if (c >= (unsigned)r.cap) {
    ++p;
    c -= (unsigned)r.cap;
  }
  return r.recv + ((size_t)p * r.B + b) * r.cap + c;
}

// Lane j of row b's (state, cost): the entry's first 8 bytes.
__device__ __forceinline__ void routed_state_cost(const Routed& r, int b, int j, int* state,
                                                  float* cost) {
  const int4* e = routed_entry(r, b, j);
  if (e == nullptr) {
    *state = r.inc_states[(size_t)b * r.K + j];
    *cost = r.inc_costs[(size_t)b * r.K + j];
    return;
  }
  const int2 v = *reinterpret_cast<const int2*>(e);
  *cost = __int_as_float(v.y);
  *state = isfinite(*cost) ? v.x : r.sp;
}

// Lane j of row b's cost.
__device__ __forceinline__ float routed_cost(const Routed& r, int b, int j) {
  const int4* e = routed_entry(r, b, j);
  return e == nullptr ? r.inc_costs[(size_t)b * r.K + j]
                      : __int_as_float(reinterpret_cast<const int*>(e)[1]);
}

// Lane j of row b's payload (slot, arc): the entry's last 8 bytes.
__device__ __forceinline__ int2 routed_payload(const Routed& r, int b, int j) {
  const int4* e = routed_entry(r, b, j);
  if (e == nullptr) return make_int2(r.has_base ? r.base + j : -1, -1);
  return *reinterpret_cast<const int2*>(reinterpret_cast<const int*>(e) + 2);
}

// ---- Thread block clusters (sm_90) ----------------------------------------
// A cluster barrier split in two: arrive (release: this thread's earlier
// writes, shared and global, become visible to the cluster) and wait
// (acquire).  Every thread of every block of the cluster takes part.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// ---- Asynchronous bulk copies (TMA, 1-D) completing on an mbarrier --------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// One thread initialises; the fence makes the barrier visible to the
// async proxy before any copy completes on it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// The issuing thread's arrival, announcing the bytes the copies will bring.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// global to this block's shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Wait for the completion of the barrier's phase of parity `parity`, with
// acquire at cluster scope: what other blocks' stores (store_remote)
// completed on the phase is visible after it.  A phase still open after
// some 2^34 cycles (seconds) traps: a store that never came is a fault.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, unsigned parity) {
  const long long start = clock64();
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}

// ---- Stores into another block's shared memory (sm_90 st.async) ----------
// The address of *p in block `rank` of the cluster, as a shared::cluster
// address.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, unsigned rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_addr(p)), "r"(rank));
  return a;
}
// Block `rank`'s copy of *dst = v, a store that completes its bytes on
// that block's copy of the mbarrier *bar (whose phase expects them), so
// that the receiver waits on its own barrier and on no cluster barrier.
// The receiver must run (a cluster barrier after its mbar_init) first.
__device__ __forceinline__ void store_remote(int4* dst, int4 v, uint64_t* bar, unsigned rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(cluster_addr(dst, rank)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
      "r"(cluster_addr(bar, rank))
      : "memory");
}
__device__ __forceinline__ void store_remote(unsigned* dst, unsigned v, uint64_t* bar,
                                             unsigned rank) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               ::"r"(cluster_addr(dst, rank)), "r"(v), "r"(cluster_addr(bar, rank))
               : "memory");
}

// Order this thread's earlier shared-memory accesses (generic proxy)
// before bulk copies it issues next into the same memory (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The launch configuration of `grid` blocks in clusters of `cluster`
// blocks with `smem` bytes of dynamic shared memory.  Not copyable: the
// configuration points at its own attribute.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int grid, int cluster, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// The most clusters of `cluster` blocks of `kernel` the card runs at once
// (0 when one cluster does not fit).  Opts the kernel into `smem` bytes
// of dynamic shared memory (needed above 48 KB; the setting is per device).
template <typename... KArgs>
int max_active_clusters(void (*kernel)(KArgs...), int cluster, int threads, size_t smem) {
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  ClusterLaunch l(cluster, cluster, threads, smem, 0);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(kernel), &l.cfg) !=
      cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

// The cluster size for B independent clusters (one per utterance) of
// `kernel`: the largest of 8, 4, 2, 1 (at most `most`) at which all B
// clusters run at once, else the largest that runs at all (0: none
// fits).  `smem(c)` is the dynamic shared memory a block needs in a
// cluster of c blocks, a function of the call's `shape` alone (which
// `most` must be too).  The occupancy queries run once per kernel,
// device, B and shape; later calls read the answer kept.
template <typename Smem, typename... KArgs>
int pick_cluster(void (*kernel)(KArgs...), int B, int threads, long shape, Smem smem,
                 int most = 8) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, long>, int> picked;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const auto key = std::make_tuple(reinterpret_cast<const void*>(kernel), dev, B, shape);
  std::lock_guard<std::mutex> hold(mu);
  const auto it = picked.find(key);
  if (it != picked.end()) return it->second;
  int best = 0;
  for (int c = 8; c >= 1; c /= 2) {
    if (c > most) continue;
    const int n = max_active_clusters(kernel, c, threads, smem(c));
    if (n >= B) {
      best = c;
      break;
    }
    if (n > 0 && best == 0) best = c;
  }
  if (best > 0) picked[key] = best;
  return best;
}

// Launch `kernel` as `grid` blocks in clusters of `cluster` blocks on
// `stream`.  Returns the launch's error: a refused cluster launch is
// reported, not retried.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), int grid, int cluster, int threads,
                           size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  ClusterLaunch l(grid, cluster, threads, smem, stream);
  e = cudaLaunchKernelEx(&l.cfg, kernel, static_cast<KArgs>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace kdtorch
