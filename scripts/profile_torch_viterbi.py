#!/usr/bin/env python3
"""Where the time of the torch port's 1-best decodes goes, on one card.

Builds the bench workload exactly as ``chip_smoke.py`` does (cached HLG,
16 utterances from the seed) and runs two frame loops with the scheme of
``scripts/profile_torch_frame.py`` (WARM frames of warm-up, WALL frames
unprofiled for the wall time, PROF frames under ``torch.profiler`` for
device time by kernel, device activities per frame and the busy share):

* the batched Viterbi frame, B=16, on the folded graph with
  ``chip_smoke.VITERBI_CONFIG`` (phase 4's decoder);
* the streaming frame, B=1, on the unfolded graph with the eps closure,
  with the capacities ``FasterDecoder`` derives (phase 5's decoder; the
  per-call downloads of ``advance_decoding`` are not in it).

Then the device time of one call of each hand-written kernel's wrapper
and of its plain torch version, on the same inputs: K1 with its source
slots and K6 on the Viterbi frontier after its frames, and K6 on one eps
iteration's candidates of the unfolded graph at B=16; and the K1 call
split by device activity (``chip_smoke.kernel_split``).

Prints a summary and writes the profiler's full tables to
``<out>/profile_torch_viterbi.txt`` and ``<out>/profile_torch_streaming.txt``.

    python3 scripts/profile_torch_viterbi.py [--out chiprun_out]
"""

import argparse
import os
import sys
import time

from profile_torch_frame import (
    PROF,
    REPO,
    WALL,
    WARM,
    _device_events,
    _self_device_us,
    _sort_key,
    kernel_ms,
)

sys.path.insert(0, REPO)


def profile_frames(step, st):
    """Frames 0..WARM-1 warm up, the next WALL run unprofiled, the next
    PROF under the profiler; ``step(st, t)`` returns the next state.
    Returns (state, wall ms/frame, device ms/frame, device activities per
    frame, profiler, device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for t in range(WARM):
        st = step(st, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(WARM, WARM + WALL):
        st = step(st, t)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / WALL
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(WARM + WALL, WARM + WALL + PROF):
            st = step(st, t)
        torch.cuda.synchronize()
    dev = _device_events(prof)
    dev_ms = sum(_self_device_us(e) for e in dev) / 1e3 / PROF
    acts = sum(e.count for e in dev) / PROF
    return st, wall_ms, dev_ms, acts, prof, dev


def report(name, wall_ms, dev_ms, acts, prof, dev, out, table):
    print(f"{name} frames {WARM}..{WARM + WALL - 1}: wall {wall_ms:.4f} ms/frame "
          "(unprofiled)")
    print(f"{name} frames {WARM + WALL}..{WARM + WALL + PROF - 1} (profiled): device "
          f"{dev_ms:.4f} ms/frame, busy share {dev_ms / wall_ms:.3f} of the unprofiled "
          f"wall, {acts:.1f} device activities/frame")
    if not dev:
        print("the profiler saw no device time (no CUPTI trace)")
    print(f"{name}: device time per frame by kernel (ms/frame, calls/frame):")
    for e in sorted(dev, key=_self_device_us, reverse=True)[:12]:
        ms = _self_device_us(e) / 1e3 / PROF
        print(f"  {ms:9.4f}  {e.count / PROF:6.2f}  {e.key[:100]}")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, table)
    with open(path, "w") as f:
        f.write(f"{PROF} frames of the {name} decode, from frame {WARM + WALL}\n")
        f.write(prof.key_averages().table(sort_by=_sort_key(prof), row_limit=120))
    print(f"table written to {path}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_viterbi: needs a CUDA card")
    from chip_smoke import (
        B,
        EPS_FRAME,
        VITERBI_CONFIG,
        bench_workload,
        card_line,
        format_split,
        kernel_split,
    )
    from kaldi_decoder_tpu_torch import (
        BatchedViterbiDecoder,
        FasterDecoder,
        FasterDecoderOptions,
        config_for_graph,
    )
    from kaldi_decoder_tpu_torch.decoders.frontier import (
        eps_candidates,
        frame_emit_stage,
        frame_step_batched,
        init_closure,
    )
    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    print(card_line())
    graph, scores, lengths, _ = bench_workload()
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    rem = torch.from_numpy(lengths).cuda()
    vfc = config_for_graph(graph, **VITERBI_CONFIG)

    vdec = BatchedViterbiDecoder(graph, vfc, device="cuda")
    fc, S = vdec.cfg, vdec._dev_graph.num_states
    st, _ = vdec._init(B)

    def step(st, t):
        return frame_step_batched(st, scores_tm[t], rem > t, vdec._pg, fc, S)[0]

    st, *res = profile_frames(step, st)
    report("batched Viterbi", *res, args.out, "profile_torch_viterbi.txt")
    t = WARM + WALL + PROF
    cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    k1_args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_tm[t],
               vdec._pg, fc)
    ex = expand_filter(*k1_args, with_src_slot=True)
    em_args = (ex.dst, ex.cost, fc.frontier_size, S)

    edec = BatchedViterbiDecoder(graph, vfc, fold=False, device="cuda")
    ec, Se = edec.cfg, edec._dev_graph.num_states
    est, _ = edec._init(B)
    for u in range(EPS_FRAME):
        est = frame_step_batched(est, scores_tm[u], rem > u, edec._pg, ec, Se)[0]
    mid, _, next_cutoff, _, _, _ = frame_emit_stage(
        est, scores_tm[EPS_FRAME], edec._pg, ec, Se)
    cs, cc, _, _, _ = eps_candidates(mid, next_cutoff, edec._pg, ec)
    eps_args = (cs, cc, ec.frontier_size, Se)
    pairs = [
        ("expand_filter with src_slot (K1, row gather folded in)",
         lambda: expand_filter(*k1_args, with_src_slot=True),
         lambda: expand_filter_plain(*k1_args, with_src_slot=True)),
        (f"K6 dedup_select, emitting candidates (N={ex.cost.shape[1]})",
         lambda: dedup_select(*em_args), lambda: dedup_select_plain(*em_args)),
        (f"K6 dedup_select, eps iteration of the unfolded graph (N={cc.shape[1]})",
         lambda: dedup_select(*eps_args), lambda: dedup_select_plain(*eps_args)),
    ]
    print("device ms per call, kernel vs plain torch, same inputs:")
    for name, kern, plain in pairs:
        print(f"  {name}: kernel {kernel_ms(kern, 20):.4f} ms, "
              f"plain {kernel_ms(plain, 20):.4f} ms")
    print("device activities of one call of expand_filter with src_slot, queued back to back:")
    print("  " + format_split(kernel_split(pairs[0][1], 20)))
    del vdec, edec, ex, em_args, eps_args, cs, cc, mid, est
    torch.cuda.empty_cache()

    fd = FasterDecoder(graph, FasterDecoderOptions(
        beam=VITERBI_CONFIG["beam"], max_active=VITERBI_CONFIG["max_active"],
        min_active=VITERBI_CONFIG["min_active"]), device="cuda")
    sfc, Ss = fd._cfg, graph.num_states
    one = rem[:1]
    sst, _ = init_closure(fd._pg, graph.start_state, Ss, sfc, fd.device)

    def sstep(st, t):
        return frame_step_batched(st, scores_tm[t, :1], one > t, fd._pg, sfc, Ss)[0]

    _, *res = profile_frames(sstep, sst)
    report("streaming (B=1, eps closure)", *res, args.out, "profile_torch_streaming.txt")


if __name__ == "__main__":
    main()
