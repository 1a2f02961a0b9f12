#!/usr/bin/env python3
"""K5's steps on the card: where a launch's time goes, and what a cluster
launch and a cluster barrier cost, on one NVIDIA card.

Builds ``kaldi_decoder_tpu_torch/csrc/eps.cu`` with its step marks on
(``-DKD_STEP_MARKS``: thread 0 of each of row 0's blocks stores the SM
clock at K5's nine marks) into a library of its own under
``kaldi_decoder_tpu_torch/_build/steps/``, beside two kernels of this
script's (an empty kernel; one that only takes cluster barriers).  Then,
on the frames ``chip_smoke.py`` phase 2 times K5 on (the streaming
decoder's frame 60, B=1; the unfolded lattice decode's frame 150, B=16),
it holds the marked K5 bitwise against its plain version at each cluster
size, times it (device ms per call, 10 calls queued back to back, CUDA
events; the marks cost a little) and splits the last launch's blocks into
their steps (µs at the SM's rated clock).  Last, the device ms per launch
of the empty kernel and of 1, 2 and 4 cluster barriers, as one cluster of
8 blocks and as 16.  Prints one JSON line and writes it to
``chiprun_out/profile_k5_steps.json``:

    python3 scripts/profile_torch_k5_steps.py
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# The steps between K5's marks (csrc/eps.cu K5_MARK).
STEPS = ("loads", "block scan", "wait to push", "push", "owners and first lanes",
         "parts wait", "totals and owned lanes", "rest and pad lanes")
MOST = 8  # csrc/eps.cu MOST
MARKS = len(STEPS) + 1

BENCH_CU = r"""
#include "common.cuh"
namespace {
__global__ void empty_kernel() {}
__global__ void barrier_kernel(int n) {
  for (int i = 0; i < n; ++i) kdtorch::cluster_sync();
}
}  // namespace
extern "C" int kx_empty(int blocks, int cluster, int threads, void* stream) {
  return (int)kdtorch::launch_cluster(empty_kernel, blocks, cluster, threads, 0,
                                      static_cast<cudaStream_t>(stream));
}
extern "C" int kx_barriers(int blocks, int cluster, int threads, int n, void* stream) {
  return (int)kdtorch::launch_cluster(barrier_kernel, blocks, cluster, threads, 0,
                                      static_cast<cudaStream_t>(stream), n);
}
"""


def build():
    """The marked library, built from this checkout's sources."""
    from kaldi_decoder_tpu_torch.kernels._build import CSRC_DIR, _nvcc

    out_dir = os.path.join(REPO, "kaldi_decoder_tpu_torch", "_build", "steps")
    os.makedirs(out_dir, exist_ok=True)
    bench = os.path.join(out_dir, "bench.cu")
    with open(bench, "w") as f:
        f.write(BENCH_CU)
    lib = os.path.join(out_dir, "k5_steps.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-DKD_STEP_MARKS", "-I", CSRC_DIR, "-o", lib,
           os.path.join(CSRC_DIR, "eps.cu"), bench]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the marked K5 failed:\n{proc.stderr}")
    P, I = ctypes.c_void_p, ctypes.c_int
    dll = ctypes.CDLL(lib)
    dll.kd_expand_eps.restype = I
    dll.kd_expand_eps.argtypes = [P] * 5 + [I] * 6 + [P] * 6 + [P]
    dll.kd_expand_eps_marks.argtypes = [P, P]
    dll.kx_empty.argtypes = [I, I, I, P]
    dll.kx_barriers.argtypes = [I, I, I, I, P]
    return dll


def frames(cs):
    """K5's inputs on the two frames: (name, states, costs, cutoff, pg, fc, lattice)."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.decoders.frontier import frame_step_batched
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
        lattice_emit_stage,
        lattice_frame_step_batched,
    )

    graph, scores, lengths, refs = cs.bench_workload()
    vref = cs.load_reference("torch_port_viterbi_ref.json", scores, lengths, refs)
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    fd = cs.streaming_decoder(graph, vref)
    cfg, pg, S = fd._cfg, fd._pg, fd._graph.num_states
    fd.init_decoding()
    st = fd._state
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    for t in range(cs.STREAM_FRAME):
        st, _ = frame_step_batched(st, scores_tm[t, :1], one, pg, cfg, S)
    where = f"streaming frame {cs.STREAM_FRAME}"
    _, _, _, _, ex, sel = cs.check_emit_kernels(st, scores_tm[cs.STREAM_FRAME, :1], pg, cfg, S,
                                                where)
    out = [(where, sel.states, sel.costs, ex.next_cutoff, pg, cfg, False)]
    udec = cs.unfolded_lattice_decoder(graph)
    ucfg, fc, US = udec.cfg, udec.cfg.frontier, udec._dev_graph.num_states
    st = udec._init(cs.B)[0]
    act = torch.ones(cs.B, dtype=torch.bool, device="cuda")
    t5 = cs.K2_EPS_FRAMES[0]
    for t in range(t5):
        st, _ = lattice_frame_step_batched(st, scores_tm[t], act, udec._pg, ucfg, US)
    mid, _, cut, _, _, _ = lattice_emit_stage(st, scores_tm[t5], udec._pg, fc, US,
                                              ucfg.em_records, ucfg.lattice_beam + 1e-4)
    out.append((f"unfolded lattice frame {t5}", mid.states, mid.costs, cut, udec._pg, fc, True))
    return out


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k5_steps: no CUDA device")
    import chip_smoke as cs
    from kaldi_decoder_tpu_torch.kernels._build import kernels, ptr, stream
    from kaldi_decoder_tpu_torch.kernels.eps import (
        blocks_per_row,
        empty_eps_lanes,
        eps_lane_count,
        expand_eps_lanes_plain,
    )

    card = cs.card_line()
    cs.log(card)
    kernels()
    dll = build()
    res = {"card": card, "steps": STEPS, "k5": {}}
    for where, states, costs, cut, pg, fc, lattice in frames(cs):
        B, K = states.shape
        kw = dict(with_src_slot=not lattice, with_src_state=lattice)
        ref = expand_eps_lanes_plain(states, costs, cut, pg, fc, True, **kw)
        N = eps_lane_count(fc, True)
        out = empty_eps_lanes(B, N, states.device, **kw)
        own = blocks_per_row(B, N)
        rows = res["k5"][where] = {"B": B, "K": K, "N": N, "clusters": own, "ms_by_blocks": {}}
        for C in sorted({own, *cs.CLUSTER_SIZES}, reverse=True):
            def call():
                rc = dll.kd_expand_eps(
                    ptr(states), ptr(costs), ptr(cut), ptr(pg.eps_block), ptr(pg.eps_flat), B, K,
                    fc.eps_block_width, fc.eps_rem_budget, K, C, ptr(out.dst), ptr(out.cost),
                    ptr(out.src_slot) if out.src_slot is not None else None,
                    ptr(out.src_state) if out.src_state is not None else None,
                    ptr(out.arc_id), ptr(out.overflow), stream(states.device))
                if rc != 0:
                    raise RuntimeError(f"the marked K5 failed to launch: {rc}")
            call()
            torch.cuda.synchronize()
            cs.same_fields(ref, out, f"the marked K5 at {C} blocks a row", where)
            rows["ms_by_blocks"][C] = cs.device_ms(call)
            if C != own:
                continue
            call()
            torch.cuda.synchronize()
            clock = np.zeros(MOST * MARKS, np.int64)
            khz = ctypes.c_int()
            rc = dll.kd_expand_eps_marks(clock.ctypes.data, ctypes.byref(khz))
            if rc != 0:
                raise RuntimeError(f"reading K5's marks failed: {rc}")
            marks = clock.reshape(MOST, MARKS)[:C]
            rows["steps_us_by_rank"] = [
                {s: float((m[i + 1] - m[i]) * 1e3 / khz.value) for i, s in enumerate(STEPS)}
                for m in marks]
            rows["block_us_by_rank"] = [float((m[-1] - m[0]) * 1e3 / khz.value) for m in marks]
            rows["sm_clock_khz"] = khz.value
        slow = max(range(len(rows["block_us_by_rank"])), key=lambda r: rows["block_us_by_rank"][r])
        cs.log(f"marked K5 on {where} (B={B}, K={K}, N={N}): device ms by blocks a row "
               + ", ".join(f"{c}: {ms:.4f}" for c, ms in rows["ms_by_blocks"].items())
               + f"; at {own}, each block {min(rows['block_us_by_rank']):.2f}-"
               f"{max(rows['block_us_by_rank']):.2f} µs from its start; the slowest "
               f"(rank {slow}): "
               + ", ".join(f"{s} {us:.2f}" for s, us in rows["steps_us_by_rank"][slow].items()))
    s = stream(torch.device("cuda"))
    launch = res["launch_ms"] = {}
    for blocks in (8, 128):
        launch[f"empty, {blocks} blocks in clusters of 8"] = cs.device_ms(
            lambda: dll.kx_empty(blocks, 8, 256, s))
        launch[f"empty, {blocks} blocks, no cluster"] = cs.device_ms(
            lambda: dll.kx_empty(blocks, 1, 256, s))
        for n in (1, 2, 4):
            launch[f"{n} cluster barriers, {blocks} blocks in clusters of 8"] = cs.device_ms(
                lambda: dll.kx_barriers(blocks, 8, 256, n, s))
    for name, ms in launch.items():
        cs.log(f"  {name}: {ms:.4f} ms per launch")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_k5_steps.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
