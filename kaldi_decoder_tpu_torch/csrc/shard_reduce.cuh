// The sharded frame's local values at eps_iters 0, as the last step of the
// emitting dedup call (K6, dedup.cu; K2, dedup_rec.cu).
//
// Replaces the eps step's shard mode's reduce mode, a launch of its own
// after the emitting call (csrc/eps.cu until it was folded here; its
// plain version stays kaldi_decoder_tpu_torch/kernels/dedup.py
// eps_reduce_shard_plain, the oracle), which in turn replaced the torch
// reductions of a sharded frame without eps iterations (the JAX package's
// local half of the rebase, kaldi_decoder_tpu/parallel/graph_shard.py
// :427-429 and :901-903): what the frame reduces over the ranks when no
// eps step writes it, from the frontier the emitting call has just
// selected: each row's smallest finite cost (its first smallest in slot
// order, the bits of that slot; +inf for none) and count of finite costs,
// and the batch's flag pair (any of the emitting overflow flags in any
// row, the call's own record overflow included; any num_unique > K),
// written whole.
//
// Why no reduction is left: the frontier is the K smallest winners in
// (total-order cost, state) order, padded with +inf (dedup.cu's header),
// and a winner's cost is finite.  So slot 0 holds the row's smallest cost
// in total order, which is -0.0 where -0.0 and +0.0 tie, the first in
// slot order under first_min_count's argmin too (it compares them equal
// and keeps the first), bit for bit; +inf when num_unique is 0.  The
// finite costs are the first min(num_unique, K) slots.  The call already
// holds both: slot 0's key where the select core emits rank 0, and the
// winner count where rank 0's thread 0 writes num_unique.
//
// What bounds it: a scalar pair a row and the flag pair, some 8 * B + 8
// bytes written and 3 * B read; as a launch of its own it took 0.0039-
// 0.0049 ms on an H100 against a bound of 0.00001 ms (PERF.md).  Folded,
// it adds one store where slot 0 is written, and rank 0's thread 0's
// flag loads, two stores and one atomic after the select.
//
// The design: the thread that emits slot 0 writes red_min; rank 0's
// thread 0, beside num_unique, writes +inf there when the row has no
// winner, red_count = min(n, K), and counts its row done on the kept
// 64-bit word `count` with one acquire-release add at device scope that
// also carries whether the row overflowed or saturated (16 bits each, as
// the eps step's shard mode counts, eps.cu).  The row whose add completes
// the count (the last of the B) writes both flag words and clears the
// word, so nothing is carried from the last call and a captured frame
// replays as any other.  Every row adds exactly once, a row of no winner
// and a frozen one included, so the word is 0 between calls.
#pragma once

#include "common.cuh"

namespace kdtorch {
namespace shard_reduce {

constexpr unsigned long long ROW_DONE = 1ull, ROW_OVF = 1ull << 16, ROW_SAT = 1ull << 32;
constexpr int MAX_ROWS = (1 << 16) - 1;  // each 16-bit field of the count holds up to B

// The local values' outputs (kernels/dedup.py ReduceArgs; red_min null:
// the call writes none).
struct Reduce {
  const unsigned char* em_ovf[3];  // (B,) each or null: the emitting overflow flags
  float* red_min;                  // (B,)
  int* red_count;                  // (B,)
  int* red_flags;                  // (2,)
  unsigned long long* count;       // (1,): rows done, 0 between calls
  __host__ __device__ bool on() const { return red_min != nullptr; }
};

// Slot 0 of row b is written with cost c.
__device__ __forceinline__ void first_slot(const Reduce& r, int b, float c) {
  r.red_min[b] = c;
}

// Rank 0's thread 0 of row b's cluster, once the call's winners are
// counted (n of them, K slots; own_ovf the call's own overflow): the
// row's count, +inf where it has no winner, and the batch's flag pair
// from the last of the B rows.
__device__ __forceinline__ void finish(const Reduce& r, int b, int B, int n, int K,
                                       bool own_ovf) {
  bool o = own_ovf;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (r.em_ovf[i] != nullptr) o = o || r.em_ovf[i][b];
  if (n == 0) r.red_min[b] = INFINITY;
  r.red_count[b] = min(n, K);
  const unsigned long long mine = ROW_DONE + (o ? ROW_OVF : 0) + (n > K ? ROW_SAT : 0);
  unsigned long long seen;
  asm volatile("atom.acq_rel.gpu.add.u64 %0, [%1], %2;\n"
               : "=l"(seen)
               : "l"(r.count), "l"(mine)
               : "memory");
  seen += mine;
  if ((seen & 0xffffu) != (unsigned)B) return;
  r.red_flags[0] = ((seen >> 16) & 0xffffu) != 0;
  r.red_flags[1] = ((seen >> 32) & 0xffffu) != 0;
  *r.count = 0;
}

// The host side: the launch's Reduce from the wrapper's (a host pointer
// to a Reduce, or null for none).
inline Reduce reduce_of(const void* p) {
  return p != nullptr ? *static_cast<const Reduce*>(p) : Reduce{};
}

}  // namespace shard_reduce
}  // namespace kdtorch
