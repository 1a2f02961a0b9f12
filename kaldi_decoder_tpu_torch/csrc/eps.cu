// K5: the eps iteration's candidate lanes; and the eps step, its closing
// step after the dedup call.
//
// Replaces the XLA-compiled region of one eps relaxation that the JAX
// package runs inside its frame (kaldi_decoder_tpu/decoders/frontier.py
// eps_iteration and its eps_closure_batched loop body; lattice_dev.py
// eps_iteration_rec and eps_closure_rec_batched), around the dedup call
// (K6 on the 1-best paths, K2's eps call on the lattice paths), which is
// a kernel of its own:
//   - K5 (kd_expand_eps): frontier.py:366 expand_eps with _owner_of_lanes
//     and the candidate assembly of eps_iteration / eps_iteration_rec: the
//     active slots (finite cost <= cutoff), optionally the K incumbents
//     first as lanes (state, cost, slot, -1, -1), then K*We block lanes,
//     then R remainder lanes of one arc each through the owner map, each
//     lane's cost (alpha + w) set to +inf above the cutoff;
//   - the eps step (kd_eps_step): the rest of the iteration and of the
//     closure's loop body.  1-best: each slot's (source slot, arc)
//     backpointer from its winning lane, `changed`, `saturated`, the
//     backpointers into iteration d's row (identity once the batch has
//     stopped).  Lattice: the spill row past r_eps, `changed` (a slot won
//     by an eps lane), the records into iteration d's row (-1 once
//     stopped).  Both: the running overflow and saturation of the active
//     rows, the batch-wide `go`, `ran &= go`, and at the last iteration of
//     a cyclic eps budget the overflow of every active row when some
//     active row still changed.
// Their plain versions are kaldi_decoder_tpu_torch/kernels/eps.py
// expand_eps_lanes_plain and eps_step_plain.  A float is only added
// (alpha + w, round to nearest, no contraction), compared or copied, so
// every output is bitwise equal to plain.
//
// What bounds them: bytes, and before that the latency of dependent
// loads.  K5 at the unfolded lattice frame (B=16, K 4096, We 1, R 2048,
// with incumbents: 10,240 lanes a row) reads the frontier (32 KB a row)
// and the active slots' eps_block rows and eps_flat arcs (L2 hits) and
// writes four int32/float columns of 10,240 lanes: about 2.8 MB, 0.0008
// ms at 3.35 TB/s.  A lane is a chain (its slot's state, then the row's
// arc; or the owner's place, then the eps_flat arc), so expect a few µs.
// The eps step reads the K winning lanes (and on the 1-best path their
// source slots and arcs) or the records, and writes one iteration's row
// of backpointers (K int2) or records (r_eps int4): under 1 MB at B=16.
//
// K5's design: B*C blocks, C per row (8, 4, 2 or 1; the most with B*C
// blocks on the card's SMs and at least MIN_LANES lanes a block).  A
// row's lanes are cut into C equal ranges; no block needs another's
// results (the cutoff is given: there is no min pass and no filter
// barrier, unlike K1), so the C blocks are not a cluster and never wait
// for each other.  A block whose range holds no remainder lane writes its
// incumbent and block lanes at once.  A block with remainder lanes first
// scans the row's K slots as K1 does (csrc/expand.cu steps 1-2, at
// G = 1): PER consecutive slots a thread, costs and states first, then
// the active slots' eps_block headers, the remainder degrees
// max(deg - We, 0) and their block scan; then, for each tile of TILE of
// its remainder lanes, it places the owners by lane position in shared
// memory (a slot whose lanes meet the tile writes its start, slot, cost,
// state and row_lo at its first lane in the tile, and a running max over
// the positions gives every lane its owner: the reference's scatter-max
// and running max, whose owner is the last slot with remainder arcs
// whose start is <= the lane).  Lanes past the total take the last slot
// with remainder arcs as their owner (slot 0 when none has), as the
// reference's lane map gives them.  An inactive slot reads row 0 of
// eps_block, staged in shared memory, as the reference's `safe` index
// does.  Each thread takes UNROLL lanes at a time, in rounds of loads
// (the slots, then the arcs) before coalesced writes.  The last block of
// a row writes its overflow (total > R).
//
// The eps step's design: one block of STEP_THREADS a row.  The 1-best
// instance loads UNROLL winning lanes a thread, then their source slots
// and arcs, then writes the backpointers; the lattice instance checks
// the K slots and copies r_eps records as int4.  `changed` is a block
// OR.  The closure's state lives in device memory (flags: `ran`, the
// batch's `go` accumulator and a count of blocks done), so the step
// replays in a captured frame: every block reads `ran` first; a block
// whose row is active and changed ORs into the accumulator; each counts
// itself done with an atomic after a fence (K3's idiom), and the last one
// writes `ran &= go`, the last iteration's budget flags, and clears the
// accumulator and the count.

#include "common.cuh"

namespace {

constexpr int EPS_FIELDS = 2;  // weight bits, next state
constexpr int THREADS = 512;
constexpr int PER = 8;                // consecutive slots a thread reads per round
constexpr int CHUNK = PER * THREADS;  // slots per round
constexpr int TILE = 1024;            // remainder lanes whose owners are placed at a time
constexpr int POS = TILE / THREADS;   // positions per thread in the running max
constexpr int MARK = 1 << 12;         // tags an owner's position placed for the tile at hand
constexpr int UNROLL = 4;             // lanes in flight per thread
constexpr int MIN_LANES = 512;        // the fewest lanes a block of K5 takes

__device__ __forceinline__ bool slot_active(float c, float cutoff) {
  return isfinite(c) && c <= cutoff;
}

__global__ void __launch_bounds__(THREADS) expand_eps_kernel(
    const int* __restrict__ states, const float* __restrict__ costs,
    const float* __restrict__ cutoff, const int* __restrict__ eps_block,
    const int* __restrict__ eps_flat, int K, int We, int R, int inc, int C,
    int* __restrict__ dst, float* __restrict__ cost, int* __restrict__ src_slot,
    int* __restrict__ src_state, int* __restrict__ arc_id, unsigned char* __restrict__ overflow) {
  const int row_w = We * EPS_FIELDS + 2;
  // A tile's owners by lane position: s_own maps a position to its
  // owner's, where the owner's start, slot, cost, safe state and row_lo
  // are.  Then eps_block's row 0.
  __shared__ int s_own[TILE];
  __shared__ int o_start[TILE], o_slot[TILE], o_state[TILE], o_lo[TILE];
  __shared__ float o_cost[TILE];
  __shared__ int scan_tmp[32];
  __shared__ int s_total, s_last;  // remainder arcs; the last slot with some (-1: none)
  __shared__ int s_pad[4];         // lanes past the total: their owner's start, slot, state, row_lo
  extern __shared__ int s_row0[];

  const int b = blockIdx.x / C;
  const int rank = blockIdx.x % C;
  const int tid = threadIdx.x;
  const int NB = K * We;
  const int rbase = inc + NB;  // the first remainder lane
  const int N = rbase + R;
  const long slot0 = (long)b * K;
  const long lane_row = (long)b * N;
  const float cut = cutoff[b];
  const int lane0 = (int)((long)N * rank / C);
  const int lane_end = (int)((long)N * (rank + 1) / C);

  for (int i = tid; i < row_w; i += THREADS) s_row0[i] = eps_block[i];
  for (int p = tid; p < TILE; p += THREADS) s_own[p] = -1;
  if (tid == 0) {
    s_total = 0;
    s_last = -1;
  }
  __syncthreads();

  // The slots [cb + tid*PER, + PER): costs, safe states (0 when inactive),
  // row_lo (row 0's when inactive) and remainder degrees (0 when inactive).
  float a[PER];
  int st[PER], lo[PER], nu[PER];
  auto load = [&](int cb) {
    const int k0 = cb + tid * PER;
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const long k = slot0 + min(k0 + m, K - 1);
      a[m] = costs[k];
      st[m] = states[k];
    }
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const bool act = k0 + m < K && slot_active(a[m], cut);
      const int* hdr = eps_block + (long)(act ? st[m] : 0) * row_w + We * EPS_FIELDS;
      lo[m] = act ? hdr[0] : s_row0[We * EPS_FIELDS];
      nu[m] = act ? max(hdr[1] - We, 0) : 0;
      if (!act) st[m] = 0;
    }
  };

  int total = 0;
  const bool has_rem = lane_end > rbase;
  if (has_rem) {
    // Totals: the row's remainder arcs and its last slot with some.
    int units = 0, last = -1;
    for (int cb = 0; cb < K; cb += CHUNK) {
      load(cb);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        units += nu[m];
        if (nu[m] > 0) last = cb + tid * PER + m;
      }
    }
    units = __reduce_add_sync(0xffffffffu, units);
    last = __reduce_max_sync(0xffffffffu, last);
    if ((tid & 31) == 0) {
      atomicAdd(&s_total, units);
      atomicMax(&s_last, last);
    }
    __syncthreads();
    total = s_total;
    // The lanes past the total: owned by the last slot with remainder
    // arcs (its start is the total less its arcs), else slot 0.
    const int o_pad = max(s_last, 0);
    auto set_pad = [&](int s, int l, int n) {
      s_pad[0] = s_last >= 0 ? total - n : 0;
      s_pad[1] = o_pad;
      s_pad[2] = s;
      s_pad[3] = l;
    };
    if (K <= CHUNK) {
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        if (tid * PER + m == o_pad) set_pad(st[m], lo[m], nu[m]);
      }
    } else if (tid == 0) {
      const long k = slot0 + o_pad;
      const float c = costs[k];
      const int s = states[k];
      const bool act = slot_active(c, cut);
      const int* hdr = eps_block + (long)(act ? s : 0) * row_w + We * EPS_FIELDS;
      set_pad(act ? s : 0, act ? hdr[0] : s_row0[We * EPS_FIELDS],
              act ? max(hdr[1] - We, 0) : 0);
    }
    __syncthreads();
    if (rank == C - 1 && tid == 0) overflow[b] = total > R;
  }

  // The owners of remainder lanes [j0, j1] by position j - j0.  With
  // `fresh`, the registers still hold the totals' round, when there was
  // only one.  An owner's position is marked with MARK added, so that what
  // an earlier tile left (positions below MARK) loses every max to this
  // tile's marks; position 0 is always marked (by the owner of j0).
  auto place = [&](int j0, int j1, bool fresh) {
    const int L = j1 - j0 + 1;
    int before = 0;  // remainder arcs of the rounds before
    for (int cb = 0; cb < K && before <= j1; cb += CHUNK) {
      if (!fresh || K > CHUNK) load(cb);
      int sum = 0;
#pragma unroll
      for (int m = 0; m < PER; ++m) sum += nu[m];
      int round_units;
      int start = before + kdtorch::block_exclusive_scan(sum, scan_tmp, &round_units);
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        if (nu[m] > 0 && start <= j1 && start + nu[m] > j0) {
          const int p = max(start, j0) - j0;
          s_own[p] = MARK + p;
          o_start[p] = start;
          o_slot[p] = cb + tid * PER + m;
          o_cost[p] = a[m];
          o_state[p] = st[m];
          o_lo[p] = lo[m];
        }
        start += nu[m];
      }
      before += round_units;
    }
    __syncthreads();
    int mark[POS], top = -1;
#pragma unroll
    for (int q = 0; q < POS; ++q) {
      const int p = tid * POS + q;
      mark[q] = p < L ? s_own[p] : -1;
      top = max(top, mark[q]);
    }
    int whole;
    int run = kdtorch::block_exclusive_scan(
        top, scan_tmp, &whole, [](int x, int y) { return max(x, y); }, -1);
#pragma unroll
    for (int q = 0; q < POS; ++q) {
      const int p = tid * POS + q;
      run = max(run, mark[q]);
      if (p < L) s_own[p] = run - MARK;
    }
    __syncthreads();
  };

  bool placed = false;
  for (int t0 = lane0; t0 < lane_end; t0 += TILE) {
    const int t1 = min(t0 + TILE, lane_end);
    // The tile's valid remainder lanes [j0, j1] (none: j0 > j1).
    const int j0 = max(t0, rbase) - rbase;
    const int j1 = min(t1 - 1 - rbase, total - 1);
    if (t1 > rbase && j0 <= j1) {
      if (placed) __syncthreads();  // every thread is done with the tile before's owners
      place(j0, j1, !placed);
      placed = true;
    }
    for (int base = t0 + tid; base < t1; base += UNROLL * THREADS) {
      // c is the lane's source cost (+inf: no arc), w its arc weight.
      int d[UNROLL], ss[UNROLL], sl[UNROLL], arc[UNROLL], w[UNROLL];
      float c[UNROLL];
      // Round one: the incumbent and block lanes' slots.
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        c[u] = INFINITY;
        ss[u] = 0;
        if (i < t1 && i < rbase) {
          const long k = slot0 + (i < inc ? i : (i - inc) / We);
          c[u] = costs[k];
          ss[u] = states[k];
        }
      }
      // Round two: every arc lane's arc, from its slot's row or eps_flat.
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        w[u] = 0;
        if (i >= t1) continue;
        if (i < inc) {  // an incumbent: the token itself, no arc
          d[u] = ss[u];
          sl[u] = i;
          arc[u] = -1;
          ss[u] = -1;
        } else if (i < rbase) {
          const int q = i - inc;
          const int k = q / We;
          const int e = q - k * We;
          const bool act = slot_active(c[u], cut);
          const int* row = eps_block + (long)(act ? ss[u] : 0) * row_w;
          d[u] = act ? row[e * EPS_FIELDS + 1] : s_row0[e * EPS_FIELDS + 1];
          arc[u] = (act ? row[We * EPS_FIELDS] : s_row0[We * EPS_FIELDS]) + e;
          w[u] = act ? row[e * EPS_FIELDS] : 0;
          if (!act) {
            c[u] = INFINITY;
            ss[u] = 0;
          }
          sl[u] = k;
        } else {
          const int j = i - rbase;
          const bool valid = j < total;
          int ostart, o, ostate, olo;
          float oc = INFINITY;
          if (valid) {
            const int p = s_own[j - j0];
            ostart = o_start[p];
            o = o_slot[p];
            oc = o_cost[p];
            ostate = o_state[p];
            olo = o_lo[p];
          } else {
            ostart = s_pad[0];
            o = s_pad[1];
            ostate = s_pad[2];
            olo = s_pad[3];
          }
          arc[u] = olo + We - ostart + j;
          const int* fr = eps_flat + (long)(valid ? arc[u] : 0) * EPS_FIELDS;
          d[u] = fr[1];
          w[u] = valid ? fr[0] : 0;
          c[u] = oc;
          ss[u] = ostate;
          sl[u] = o;
        }
      }
      // The writes: an arc lane's cost is alpha + w, +inf above the
      // cutoff (+inf plus a weight stays +inf); an incumbent's its own.
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = base + u * THREADS;
        if (i >= t1) continue;
        float cc = c[u];
        if (i >= inc) {
          cc = __fadd_rn(cc, __int_as_float(w[u]));
          if (!(cc <= cut)) cc = INFINITY;
        }
        const long o = lane_row + i;
        dst[o] = d[u];
        cost[o] = cc;
        arc_id[o] = arc[u];
        if (src_slot != nullptr) src_slot[o] = sl[u];
        if (src_state != nullptr) src_state[o] = ss[u];
      }
    }
  }
}

// ---- The eps step -----------------------------------------------------------

constexpr int STEP_THREADS = 512;
constexpr int STEP_UNROLL = 4;

// The closure's state in device memory (kernels/eps.py EpsCarry.flags).
struct Flags {
  int ran;            // the closure has not stopped before this iteration
  int go;             // OR of the active rows' `changed`, this iteration
  unsigned done;      // blocks done with this iteration
};

struct StepArgs {
  int B, K, N, D, d, exact, R_rec, r_eps;
  const int* cand_idx;              // (B, K) the dedup call's winning lane per slot
  const int* num_unique;            // (B,)
  const float* sel_costs;           // (B, K) the dedup call's frontier costs (lattice)
  const unsigned char* exp_ovf;     // (B,) K5's overflow
  const unsigned char* rec_ovf;     // (B,) K2's record overflow (lattice)
  const int4* records;              // (B, R_rec) K2's records (lattice)
  const int* src_slot;              // (B, N) K5's lanes (1-best)
  const int* arc_id;                // (B, N)
  const unsigned char* row_active;  // (B,)
  Flags* flags;
  unsigned char* ovf;               // (B,) running overflow
  unsigned char* sat;               // (B,) running saturation
  unsigned char* changed;           // (B,) this iteration's
  void* out;                        // (B, D, K) int2 backpointers or (B, D, r_eps) int4 records
};

template <bool LATTICE>
__global__ void __launch_bounds__(STEP_THREADS) eps_step_kernel(StepArgs a) {
  __shared__ int s_ran;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) s_ran = a.d == 0 ? 1 : __ldcg(&a.flags->ran);
  __syncthreads();
  const bool ran = s_ran != 0;
  const int K = a.K;
  const size_t row = (size_t)b * K;
  bool changed = false;
  if (LATTICE) {
    for (int k = tid; k < K; k += STEP_THREADS)
      changed |= a.cand_idx[row + k] >= K && isfinite(a.sel_costs[row + k]);
    const int4* src = a.records + (size_t)b * a.R_rec;
    int4* dst = static_cast<int4*>(a.out) + ((size_t)b * a.D + a.d) * a.r_eps;
    for (int r0 = tid; r0 < a.r_eps; r0 += STEP_UNROLL * STEP_THREADS) {
      int4 v[STEP_UNROLL];
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        const int r = r0 + u * STEP_THREADS;
        if (r < a.r_eps) v[u] = ran ? src[r] : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        const int r = r0 + u * STEP_THREADS;
        if (r < a.r_eps) dst[r] = v[u];
      }
    }
  } else {
    int2* dst = static_cast<int2*>(a.out) + ((size_t)b * a.D + a.d) * K;
    const size_t lanes = (size_t)b * a.N;
    for (int k0 = tid; k0 < K; k0 += STEP_UNROLL * STEP_THREADS) {
      int ci[STEP_UNROLL];
      int2 bp[STEP_UNROLL];
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        const int k = k0 + u * STEP_THREADS;
        ci[u] = k < K ? a.cand_idx[row + k] : -1;
      }
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        bp[u] = ci[u] >= 0 ? make_int2(a.src_slot[lanes + ci[u]], a.arc_id[lanes + ci[u]])
                           : make_int2(0, -1);
      }
#pragma unroll
      for (int u = 0; u < STEP_UNROLL; ++u) {
        const int k = k0 + u * STEP_THREADS;
        if (k >= K) continue;
        changed |= ci[u] >= 0 && bp[u].y != -1;
        dst[k] = ran ? bp[u] : make_int2(k, -1);
      }
    }
  }
  changed = __syncthreads_or(changed);
  if (tid != 0) return;
  const bool ra = a.row_active[b];
  bool o = a.exp_ovf[b];
  if (LATTICE) o = o || a.rec_ovf[b] || a.records[(size_t)b * a.R_rec + a.r_eps].y >= 0;
  const bool s = a.num_unique[b] > K;
  a.ovf[b] = (a.d > 0 && a.ovf[b]) || (o && ra);
  a.sat[b] = (a.d > 0 && a.sat[b]) || (s && ra);
  a.changed[b] = changed;
  if (changed && ra) atomicOr(&a.flags->go, 1);
  __threadfence();
  if (atomicAdd(&a.flags->done, 1u) == gridDim.x - 1) {  // every block has read `ran`
    __threadfence();
    const bool go = atomicOr(&a.flags->go, 0) != 0;
    a.flags->ran = ran && go;
    a.flags->go = 0;
    a.flags->done = 0;
    if (a.d == a.D - 1 && !a.exact && go) {  // a cyclic eps budget: possibly unconverged
      for (int r = 0; r < a.B; ++r)
        if (a.row_active[r]) a.ovf[r] = 1;
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return n;
}

}  // namespace

// The blocks a row K5 launches with for B rows of N lanes: the largest of
// 8, 4, 2, 1 with B*C blocks on the card's SMs and N/C >= MIN_LANES.
extern "C" int kd_expand_eps_blocks(int B, int N) {
  const int sms = sm_count();
  int c = 8;
  while (c > 1 && ((long)B * c > sms || N / c < MIN_LANES)) c /= 2;
  return c;
}

// Launches K5 on `stream`: B*C blocks (C = `blocks`, or
// kd_expand_eps_blocks when 0).  Shapes: states/costs (B, K), cutoff (B,),
// eps_block (S, We*2+2), eps_flat (E, 2) int32; outputs dst/cost/arc_id
// (B, N) with N = inc + K*We + R (inc: 0, or K for the incumbents first),
// src_slot and src_state (B, N) or null (then not written), overflow (B,)
// bytes.  Returns the launch's CUDA error (0 on success).
extern "C" int kd_expand_eps(const void* states, const void* costs, const void* cutoff,
                             const void* eps_block, const void* eps_flat, int B, int K, int We,
                             int R, int inc, int blocks, void* dst, void* cost, void* src_slot,
                             void* src_state, void* arc_id, void* overflow, void* stream) {
  if (B < 1 || K < 1 || We < 1 || R < 1 || (inc != 0 && inc != K))
    return (int)cudaErrorInvalidValue;
  const int N = inc + K * We + R;
  const int C = blocks > 0 ? blocks : kd_expand_eps_blocks(B, N);
  const size_t smem = (size_t)(We * EPS_FIELDS + 2) * sizeof(int);
  expand_eps_kernel<<<B * C, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(states), static_cast<const float*>(costs),
      static_cast<const float*>(cutoff), static_cast<const int*>(eps_block),
      static_cast<const int*>(eps_flat), K, We, R, inc, C, static_cast<int*>(dst),
      static_cast<float*>(cost), static_cast<int*>(src_slot), static_cast<int*>(src_state),
      static_cast<int*>(arc_id), static_cast<unsigned char*>(overflow));
  return (int)cudaGetLastError();
}

// Launches the eps step of iteration d of D on `stream`: B blocks, the
// lattice instance when `lattice` is set.  Shapes: cand_idx (B, K) int32,
// num_unique (B,) int32, exp_ovf/row_active (B,) bool; flags 3 int32
// words; ovf/sat/changed (B,) bool; 1-best: src_slot/arc_id (B, N) int32,
// out (B, D, K, 2) int32; lattice: sel_costs (B, K) float32, rec_ovf (B,)
// bool, records (B, R_rec, 4) int32 with R_rec > r_eps, out (B, D, r_eps,
// 4) int32.  Returns the launch's CUDA error (0 on success).
extern "C" int kd_eps_step(int lattice, int B, int K, int N, int D, int d, int exact, int R_rec,
                           int r_eps, const void* cand_idx, const void* num_unique,
                           const void* sel_costs, const void* exp_ovf, const void* rec_ovf,
                           const void* records, const void* src_slot, const void* arc_id,
                           const void* row_active, void* flags, void* ovf, void* sat,
                           void* changed, void* out, void* stream) {
  if (B < 1 || K < 1 || D < 1 || d < 0 || d >= D || (lattice && R_rec <= r_eps))
    return (int)cudaErrorInvalidValue;
  const StepArgs a{B, K, N, D, d, exact, R_rec, r_eps,
                   static_cast<const int*>(cand_idx), static_cast<const int*>(num_unique),
                   static_cast<const float*>(sel_costs), static_cast<const unsigned char*>(exp_ovf),
                   static_cast<const unsigned char*>(rec_ovf), static_cast<const int4*>(records),
                   static_cast<const int*>(src_slot), static_cast<const int*>(arc_id),
                   static_cast<const unsigned char*>(row_active), static_cast<Flags*>(flags),
                   static_cast<unsigned char*>(ovf), static_cast<unsigned char*>(sat),
                   static_cast<unsigned char*>(changed), out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lattice)
    eps_step_kernel<true><<<B, STEP_THREADS, 0, st>>>(a);
  else
    eps_step_kernel<false><<<B, STEP_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}
