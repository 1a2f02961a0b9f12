// Shared device helpers for the port's kernels.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kdtorch {

// Exclusive prefix sum of one int per thread across the block, in thread
// order.  blockDim.x must be a multiple of 32 (at most 1024); every thread
// of the block must call it.  `smem` holds 32 ints.  Returns the thread's
// exclusive prefix and writes the block total to *total.
__device__ __forceinline__ int block_exclusive_scan(int v, int* smem, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? smem[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    smem[lane] = s;  // inclusive prefix of the warp sums
  }
  __syncthreads();
  const int before = warp > 0 ? smem[warp - 1] : 0;
  *total = smem[nwarps - 1];
  __syncthreads();  // smem may be reused by the next call
  return before + x - v;
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

}  // namespace kdtorch
