// Row gather: out[i, :] = table[idx[i], :] for an int32 table.
//
// The CUDA counterpart of the six Pallas row gathers under scripts/
// (gather_bench.py pallas_gather / pallas_gather_b, gather2_bench.py
// pallas_block_gather, gather3_bench.py block_gather, gather4_bench.py
// pallas_gather, gather5_bench.py mk_take).  All six gather rows of the
// packed em_block table for a frontier's states, the gather of
// kaldi_decoder_tpu/decoders/frontier.py:expand_emitting
// (`row = pg.em_block[safe]`), either from an (S, 16) table or from the
// lane-packed (ceil(S/8), 128) form.  The main path no longer calls it:
// K1 (expand.cu) reads each active slot's em_block row itself and takes
// no gathered `rows` buffer.  This kernel stays as the standalone
// counterpart of P1-P6.  Its plain version is
// kaldi_decoder_tpu_torch/kernels/gather.py:row_gather_plain.
//
// What bounds it: it moves n*W*4 bytes out and reads as many from rows
// scattered over the table (4.5 MB at the bench's S=102,298 and W=11, so
// the table stays in the 50 MB L2 after the first touch).  The TPU
// experiments copied the table into VMEM first to make the scattered
// reads cheap; here L2 plays that part and nothing is staged.  At the
// main path's 65,536 rows the bytes take about a microsecond, so what
// bounds it is latency: how many loads are in flight and how many round
// trips each thread waits for.
//
// The design: one wave of blocks (the SMs times the blocks resident on
// each), grid-stride over units of 32 rows, one unit a warp at a time.
// Each lane loads one index, so a unit's indices come in one coalesced
// load.  The unit's 32*W output words are dealt across the lanes, word e
// to lane e % 32; a word's row index comes from a warp shuffle.  A lane
// issues all of its table loads (11 at W=11) before it stores any, so a
// unit costs two round trips (index, rows), and a unit's stores are
// contiguous.  Rows of a multiple of four words move as 16-byte vectors.
// A row wider than BATCH elements a lane (16 words or 8 vectors) is cut
// into column groups, one unit each, so that a lane still waits for one
// round of loads: the lane-packed table's 512-byte rows make four units
// of 32 rows by 128 bytes.  An index outside [0, rows) reads nothing and
// writes zeros (the caller's fault; the plain version raises).

#include <limits.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// Table loads a lane keeps in flight before it stores: 16 words, or 8
// 16-byte vectors.  A unit of work, a tile of 32 rows by at most BATCH
// columns, is at most 32 * BATCH elements: at most BATCH a lane.
template <typename T>
constexpr int BATCH = sizeof(T) == 4 ? 16 : 8;

// One warp a unit: the rows [r0, r0 + 32) of the table's rows idx[...]
// by the columns [c0, c0 + w) of the row's wv elements, where the
// columns are cut into groups of cw (the last may be narrower).  launch()
// refuses a call of 2^31 rows or units or more.
template <typename T>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, int n, int rows, int wv, int cw,
    T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int groups = (wv + cw - 1) / cw;
  const int units = (n + 31) / 32 * groups;
  for (int u = blockIdx.x * WARPS + (threadIdx.x >> 5); u < units; u += gridDim.x * WARPS) {
    const int tile = u / groups;
    const int c0 = (u - tile * groups) * cw;
    const int w = min(cw, wv - c0);
    const int r0 = tile * 32;
    const int nr = min(32, n - r0);
    const int mine = lane < nr ? __ldg(idx + r0 + lane) : -1;
    const int words = nr * w;
    // Element e = lane + 32*q of the unit is column c0 + e % w of row
    // e / w; a lane's next one is step_row rows and step_col columns on.
    const int step_row = 32 / w, step_col = 32 % w;
    const int row0 = lane / w, col0 = lane - row0 * w;
    T v[BATCH<T>];
    int row = row0, col = col0;
#pragma unroll
    for (int q = 0; q < BATCH<T>; ++q) {
      // Every lane takes part in every shuffle.
      const int r = __shfl_sync(0xffffffffu, mine, row & 31);
      v[q] = T{};
      if (lane + 32 * q < words && r >= 0 && r < rows) {
        v[q] = __ldg(table + (long long)r * wv + c0 + col);
      }
      row += step_row;
      col += step_col;
      if (col >= w) {
        col -= w;
        ++row;
      }
    }
    if (groups == 1) {  // the unit's elements are contiguous in the output
      T* const o = out + (long long)r0 * wv + lane;
#pragma unroll
      for (int q = 0; q < BATCH<T>; ++q) {
        if (lane + 32 * q < words) o[32 * q] = v[q];
      }
      continue;
    }
    row = row0;
    col = col0;
#pragma unroll
    for (int q = 0; q < BATCH<T>; ++q) {
      if (lane + 32 * q < words) out[(long long)(r0 + row) * wv + c0 + col] = v[q];
      row += step_row;
      col += step_col;
      if (col >= w) {
        col -= w;
        ++row;
      }
    }
  }
}

// Blocks of row_gather_kernel<T> in one wave on the current device: the
// SMs times the blocks each holds at once.  Queried once per device.
template <typename T>
int wave_blocks() {
  static std::mutex mu;
  static std::map<int, int> known;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> hold(mu);
  const auto it = known.find(dev);
  if (it != known.end()) return it->second;
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, row_gather_kernel<T>, THREADS, 0) !=
          cudaSuccess) {
    return 0;
  }
  return known[dev] = sms * per_sm;
}

template <typename T>
int launch(const void* table, const void* idx, long long n, int rows, int wv, void* out,
           cudaStream_t s) {
  if (n > 0 && wv > 0) {
    const int wave = wave_blocks<T>();
    if (wave == 0) {
      const cudaError_t e = cudaGetLastError();
      return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    // The fewest column groups of at most BATCH, of widths as equal as can be.
    const int groups = (wv + BATCH<T> - 1) / BATCH<T>;
    const int cw = (wv + groups - 1) / groups;
    const long long units = (n + 31) / 32 * groups;
    if (n > INT_MAX || units > INT_MAX) return (int)cudaErrorInvalidValue;
    const int blocks = (int)std::min<long long>((units + WARPS - 1) / WARPS, wave);
    row_gather_kernel<T><<<blocks, THREADS, 0, s>>>((const T*)table, (const int*)idx, (int)n,
                                                    rows, wv, cw, (T*)out);
  }
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

}  // namespace

// table (rows, width) int32, idx (n,) int32, out (n, width) int32, all
// contiguous, on `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int kd_row_gather(const void* table, const void* idx, long long n,
                             int rows, int width, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) return launch<int4>(table, idx, n, rows, width / 4, out, s);
  return launch<int>(table, idx, n, rows, width, out, s);
}

// One empty block on `stream`: its device time over launches queued back
// to back is the floor under any one launch's time.
extern "C" int kd_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
