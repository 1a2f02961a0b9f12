// The eps step: an eps iteration's closing step, run as the last step of
// the iteration's dedup call (K6's eps call, dedup.cu, on the 1-best
// paths; K2's incumbents instance, dedup_rec.cu, on the lattice paths), so
// that it has no launch of its own.
//
// Replaces the rest of the JAX package's eps iteration and its closure's
// loop body after the dedup call (kaldi_decoder_tpu/decoders/frontier.py
// :530-573 eps_iteration / eps_closure_batched; lattice_dev.py:276-321
// eps_iteration_rec / eps_closure_rec_batched).  1-best: each slot's
// (source slot, arc) backpointer from its winning lane, `changed` (a slot
// won by an eps lane's arc), the backpointers into iteration d's row
// (identity once the batch has stopped).  Lattice: the first r_eps
// records into iteration d's row (-1 once stopped), `changed` (a finite
// slot won by an eps lane, lane >= K), the spill row r_eps.  Both: the
// running overflow and saturation of the active rows, the batch-wide
// `go`, `ran &= go`, and at the last iteration of a cyclic eps budget the
// overflow of every active row when some active row still changed.  Its
// plain version is kaldi_decoder_tpu_torch/kernels/eps.py eps_step_plain,
// after the dedup call's plain version; the fused call equals the two
// bitwise (a value is only copied or compared).
//
// What bounds it: the bytes of the K winning lanes' source slot and arc
// (1-best) and of iteration d's row of backpointers or records, under 1 MB
// at B = 16; far under what the dedup call moves.  As a launch of its own
// it was a launch and two dependent loads (its winning lane, then that
// lane's slot and arc): 4.3-5.6 µs on an H100 SXM at 700 W, at B = 1
// within 1 µs of the launch floor.
//
// The design: each block of the dedup call's cluster does the step for
// the slots it writes itself, inside the select core's emit (which holds
// the slot's winning lane: the load of cand_idx goes away) and its padding
// loop; on the lattice path it copies each record row it writes into
// iteration d's row as it writes it.  Every thread reads `ran` when the
// kernel starts, before anything is written, and holds it in a register.
// At the end, each block ORs its `changed` in shared memory and stores it
// into rank 0's shared memory (a plain store a block, no remote atomic);
// one cluster barrier then orders every block's slot and record writes
// and those stores before rank 0's thread 0 (the block that writes the
// spill row r_eps notes it among its flags), which updates the row's
// flags and counts its cluster done with one acquire-release atomic on
// Flags.done that also carries the row's `go` (low half: the clusters
// done, high half: the active rows that changed).  The last of
// the B clusters writes `ran &= go`, clears the count and sets the cyclic
// budget's overflow, as the standalone step's last block did.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace kdtorch {
namespace eps {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 8;
constexpr unsigned GO_ONE = 1u << 16;  // Flags.done: a row that changed, in the high half
constexpr int MAX_ROWS = (1 << 16) - 1;  // rows a call: each half of Flags.done counts up to B

// The closure's state in device memory (kernels/eps.py EpsCarry.flags).
struct Flags {
  int ran;        // the closure has not stopped before this iteration
  unsigned done;  // this iteration: clusters done (low half), active rows changed (high half)
};

// The step of iteration d of D (kernels/eps.py StepArgs); flags null: the
// dedup call runs no step (an emitting call, a sharded eps call).
struct Step {
  int d, D, exact, width;           // width: K backpointers (1-best) or r_eps records (lattice)
  const int* src_slot;              // (B, N) K5's lanes (1-best)
  const int* arc_id;                // (B, N)
  const unsigned char* row_active;  // (B,)
  const unsigned char* exp_ovf;     // (B,) K5's overflow
  Flags* flags;
  unsigned char* ovf;               // (B,) running overflow
  unsigned char* sat;               // (B,) running saturation
  unsigned char* changed;           // (B,) this iteration's
  void* out;                        // (B, D, width) int2 backpointers or int4 records
  __host__ __device__ bool on() const { return flags != nullptr; }
};

// `ran` as the iteration finds it (true at d = 0): every thread reads it
// when the kernel starts.
__device__ __forceinline__ bool read_ran(const Step& s) {
  return !s.on() || s.d == 0 || __ldcg(&s.flags->ran) != 0;
}

// 1-best: slot k of row b was won by lane `lane` (of N a row): its
// backpointer, or the identity once stopped; an arc sets the block's
// `changed` (any[0], shared).
__device__ __forceinline__ void backpointer(const Step& s, int b, int K, int N, int k, int lane,
                                            bool ran, int* any) {
  const size_t at = (size_t)b * N + lane;
  const int2 bp = make_int2(s.src_slot[at], s.arc_id[at]);
  if (bp.y != -1) any[0] = 1;
  static_cast<int2*>(s.out)[((size_t)b * s.D + s.d) * K + k] = ran ? bp : make_int2(k, -1);
}

// 1-best: slot k of row b is empty: (0, -1), or the identity once stopped.
__device__ __forceinline__ void empty_slot(const Step& s, int b, int K, int k, bool ran) {
  static_cast<int2*>(s.out)[((size_t)b * s.D + s.d) * K + k] = make_int2(ran ? 0 : k, -1);
}

// Lattice: record row r of row b, as the dedup call writes it, into
// iteration d's row when it is one of the first r_eps (-1 once stopped);
// a valid row r_eps (its arc >= 0) is the spill, noted in the block's
// any[1] (shared).
__device__ __forceinline__ void record(const Step& s, int b, int r, int4 v, bool ran,
                                       int* any) {
  if (r < s.width) {
    static_cast<int4*>(s.out)[((size_t)b * s.D + s.d) * s.width + r] =
        ran ? v : make_int4(-1, -1, -1, -1);
  } else if (r == s.width && v.y >= 0) {
    any[1] = 1;
  }
}

// The step's end, by every thread of every block of row b's cluster once
// its slot and record writes are issued; `any` is the block's shared
// `changed` and spill flags (0 or 1 each, set by its threads), `parts` a
// shared array of MAX_CLUSTER ints.  `sat_row`: the dedup call saw more
// distinct states than K; `ovf_row`: the call's own overflow (lattice: the
// records').
__device__ __forceinline__ void finish(const Step& s, cg::cluster_group& cluster, int b, int B,
                                       bool ran, const int* any, int* parts, bool sat_row,
                                       bool ovf_row) {
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const bool lead = rank == 0 && threadIdx.x == 0;
  // The row's own flags, loaded while the cluster meets.
  bool ra = false, o = false, ovf0 = false, sat0 = false;
  if (lead) {
    ra = s.row_active[b];
    o = s.exp_ovf[b];
    ovf0 = s.d > 0 && s.ovf[b];
    sat0 = s.d > 0 && s.sat[b];
  }
  __syncthreads();  // the block's `any`
  if (threadIdx.x == 0) *cluster.map_shared_rank(parts + rank, 0) = any[0] | any[1] << 1;
  if (C > 1) {
    cluster_sync();  // every block's writes and parts
  } else {
    __syncthreads();
  }
  if (!lead) return;
  int flags = 0;
  for (int i = 0; i < C; ++i) flags |= parts[i];
  const bool changed = flags & 1;
  o = o || ovf_row || (flags & 2);
  s.ovf[b] = ovf0 || (o && ra);
  s.sat[b] = sat0 || (sat_row && ra);
  s.changed[b] = changed;
  // The count, acquire-release at device scope: the row's flags land
  // before it, and the last cluster's writes after every other's count.
  const unsigned mine = 1u + (changed && ra ? GO_ONE : 0u);
  unsigned seen;
  asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], %2;\n"
               : "=r"(seen)
               : "l"(&s.flags->done), "r"(mine)
               : "memory");
  seen += mine;
  if ((seen & (GO_ONE - 1)) == (unsigned)B) {  // every cluster has read `ran`
    const bool go = (seen >> 16) != 0;
    s.flags->ran = ran && go;
    s.flags->done = 0;
    if (s.d == s.D - 1 && !s.exact && go) {  // a cyclic eps budget: possibly unconverged
      for (int r = 0; r < B; ++r)
        if (s.row_active[r]) s.ovf[r] = 1;
    }
  }
}

// The host side: the launch's Step from the wrapper's (a host pointer to
// a Step, or null for none).
inline Step step_of(const void* p) {
  return p != nullptr ? *static_cast<const Step*>(p) : Step{};
}

}  // namespace eps
}  // namespace kdtorch
