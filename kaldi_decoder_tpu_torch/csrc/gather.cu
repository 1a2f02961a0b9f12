// Row gather: out[i, :] = table[idx[i], :] for an int32 table.
//
// The CUDA counterpart of the six Pallas row gathers under scripts/
// (gather_bench.py pallas_gather / pallas_gather_b, gather2_bench.py
// pallas_block_gather, gather3_bench.py block_gather, gather4_bench.py
// pallas_gather, gather5_bench.py mk_take).  All six gather rows of the
// packed em_block table for a frontier's states, the gather of
// kaldi_decoder_tpu/decoders/frontier.py:expand_emitting
// (`row = pg.em_block[safe]`), either from an (S, 16) table or from the
// lane-packed (ceil(S/8), 128) form.  On the main path it gathers one
// em_block row per frontier slot, (B*K) rows, ahead of K1 (expand.cu).
// Its plain version is kaldi_decoder_tpu_torch/kernels/gather.py:
// row_gather_plain.
//
// What bounds it: it moves n*W*4 bytes out and reads as many from rows
// scattered over the table (4.5 MB at the bench's S=102,298 and W=11, so
// the table stays in the 50 MB L2 after the first touch).  The TPU
// experiments copied the table into VMEM first to make the scattered
// reads cheap; here L2 plays that part and nothing is staged.  One thread
// per output word keeps the writes coalesced; rows of a multiple of four
// words move as 16-byte vectors.  An index outside [0, rows) reads
// nothing and writes zeros (the caller's fault; the plain version raises).

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS) row_gather_kernel(
    const T* __restrict__ table, const int* __restrict__ idx, long long n,
    int rows, int wv, T* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * wv) return;
  const long long i = e / wv;
  const int c = (int)(e - i * wv);
  const int r = idx[i];
  T v{};
  if (r >= 0 && r < rows) v = __ldg(table + (long long)r * wv + c);
  out[e] = v;
}

template <typename T>
int launch(const void* table, const void* idx, long long n, int rows, int wv,
           void* out, cudaStream_t s) {
  const long long total = n * wv;
  if (total > 0) {
    const long long blocks = (total + THREADS - 1) / THREADS;
    row_gather_kernel<T><<<(unsigned)blocks, THREADS, 0, s>>>(
        (const T*)table, (const int*)idx, n, rows, wv, (T*)out);
  }
  return (int)cudaGetLastError();
}

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
