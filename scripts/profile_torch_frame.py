#!/usr/bin/env python3
"""Where the time of the torch port's lattice decode goes, on one card.

Builds the bench workload exactly as ``chip_smoke.py`` does (cached HLG,
16 utterances from the seed, the bench config) and runs the port's frame
step on the first chunk:

* frames 0..WARM-1 warm up (kernel build, allocator);
* the next WALL frames run unprofiled: wall milliseconds per frame, with
  the card synchronised at both ends;
* the next PROF frames run under ``torch.profiler``: device time per frame
  by kernel name, device activities (kernels, memsets, copies) per frame,
  and the device's busy share (device time per frame over the unprofiled
  wall time per frame);
* the device time of one call of each hand-written kernel's wrapper
  and of its plain torch version, on the same inputs: the row gather and
  K1 on the frontier after those frames, K2 on the lanes K1 gives there,
  K4 on the first 500-frame chunk;
* the K1, K2 and K4 calls split by device activity, in launch order (the
  calls queued back to back): each kernel's time and the device's idle
  time before it.

With ``--unfolded`` the decoder keeps the graph's eps arcs on the device
(``fold=False``): each frame also runs the record-emitting eps closure
(K5's plain-torch expansion and K2's eps call), K2's eps call is timed
beside its emitting call, and K4 runs with the chunk's eps records.

Prints a summary and writes the profiler's full table of those frames to
``<out>/profile_torch_frame.txt``.

    python3 scripts/profile_torch_frame.py [--out DIR] [--unfolded]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARM, WALL, PROF = 100, 100, 50


def _self_device_us(evt):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return getattr(evt, name)
    return 0.0


def _sort_key(prof):
    evts = prof.key_averages()
    return "self_device_time_total" if evts and hasattr(evts[0], "self_device_time_total") \
        else "self_cuda_time_total"


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def kernel_ms(fn, reps):
    """Device milliseconds per call of ``fn`` (all kernels, memsets and
    copies it launches, without the gaps between them), from the
    profiler, after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # The trace can miss a window's first device activity: let it be
        # a short sleep kernel, left out of the sum.
        torch.cuda._sleep(1000)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(_self_device_us(e) for e in _device_events(prof)
               if "spin_kernel" not in e.key) / 1e3 / reps


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"))
    ap.add_argument("--unfolded", action="store_true",
                    help="keep the eps arcs on the device (fold=False): the eps path")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame: needs a CUDA card")
    from chip_smoke import (
        B,
        BENCH_CONFIG,
        CHUNK,
        DECODER_KW,
        bench_workload,
        card_line,
        format_split,
        kernel_split,
    )
    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
        eps_rec_candidates,
        lattice_chunk,
        lattice_emit_stage,
        lattice_frame_step_batched,
    )
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec, stack_records
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    print(card_line())
    graph, scores, lengths, _ = bench_workload()
    dec = BatchedLatticeDecoder(graph, config_for_graph(graph, **BENCH_CONFIG),
                                fold=not args.unfolded, device="cuda", **DECODER_KW)
    print(f"device graph: {'unfolded' if args.unfolded else 'folded'}, eps_iters "
          f"{dec.cfg.frontier.eps_iters}")
    S = dec._dev_graph.num_states
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    rem = torch.from_numpy(lengths).cuda()
    st, _, _, _ = dec._init(B)

    def frames(lo, hi):
        nonlocal st
        for t in range(lo, hi):
            st, _ = lattice_frame_step_batched(
                st, scores_tm[t], rem > t, dec._pg, dec.cfg, S)

    frames(0, WARM)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames(WARM, WARM + WALL)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / WALL

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames(WARM + WALL, WARM + WALL + PROF)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / PROF
    dev = _device_events(prof)
    dev_ms = sum(_self_device_us(e) for e in dev) / 1e3 / PROF
    acts = sum(e.count for e in dev) / PROF

    fc = dec.cfg.frontier
    t = WARM + WALL + PROF
    cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    k1_args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_tm[t],
               dec._pg, fc)
    ex = expand_filter(*k1_args)
    k2_args = (ex.dst, ex.cost, fc.frontier_size, S, dec.cfg.em_records,
               dec.cfg.lattice_beam + 1e-4, (ex.src_state, ex.arc_id))
    st0, _, _, _ = dec._init(B)
    _, o = lattice_chunk(dec._pg, scores_tm[:CHUNK], rem, st0, dec.cfg, S)
    k4_args = (o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem,
               sweep_config(dec.cfg, CHUNK), S)
    if args.unfolded:
        k4_args += (o.eps_records,)
    pairs = []
    if args.unfolded:
        sb = dec.cfg.lattice_beam + 1e-4
        mid, _, next_cutoff, _, _, _ = lattice_emit_stage(
            st, scores_tm[t], dec._pg, fc, S, dec.cfg.em_records, sb)
        cs_, cc_, pay_, _ = eps_rec_candidates(mid, next_cutoff, dec._pg, fc)
        K = fc.frontier_size
        eps_args = (cs_, cc_, K, S, K + dec.cfg.eps_records, sb, pay_)
        pairs.append(("K2 dedup_select_rec, eps call (incumbents first)", 20,
                      lambda: dedup_select_rec(*eps_args, num_incumbents=K),
                      lambda: stack_records(
                          dedup_select_rec_plain(*eps_args, num_incumbents=K))))
    pairs += [
        ("row gather, em_block row per slot", 20,
         lambda: row_gather(dec._pg.em_block, st.states),
         lambda: row_gather_plain(dec._pg.em_block, st.states)),
        ("expand_filter (K1, row gather folded in)", 20,
         lambda: expand_filter(*k1_args), lambda: expand_filter_plain(*k1_args)),
        ("K2 dedup_select_rec (dedup + top-K + records)", 20,
         lambda: dedup_select_rec(*k2_args),
         lambda: stack_records(dedup_select_rec_plain(*k2_args))),
        (f"K4 sweep of one {CHUNK}-frame chunk", 1,
         lambda: sweep_chunk(*k4_args), lambda: sweep_plain(*k4_args)),
    ]
    per_call = [(name, kernel_ms(kern, reps), kernel_ms(plain, reps))
                for name, reps, kern, plain in pairs]

    print(f"frames {WARM}..{WARM + WALL - 1}: wall {wall_ms:.4f} ms/frame (unprofiled)")
    print(f"frames {WARM + WALL}..{WARM + WALL + PROF - 1} (profiled): wall "
          f"{prof_wall_ms:.4f} ms/frame, device {dev_ms:.4f} ms/frame, busy share "
          f"{dev_ms / wall_ms:.3f} of the unprofiled wall, {acts:.1f} device "
          "activities/frame")
    if not dev:
        print("the profiler saw no device time (no CUPTI trace)")
    def row(e):
        ms = _self_device_us(e) / 1e3 / PROF
        return f"  {ms:9.4f}  {e.count / PROF:6.2f}  {e.key[:110]}"

    print("device time per frame by kernel (ms/frame, calls/frame):")
    for e in sorted(dev, key=_self_device_us, reverse=True)[:20]:
        print(row(e))
    print("the port's own kernels in those frames (ms/frame, calls/frame):")
    for e in dev:
        if any(k in e.key for k in ("row_gather_kernel", "expand_", "dedup_rec_kernel",
                                    "sweep_kernel")):
            print(row(e))
    print("device ms per call, kernel vs plain torch, same inputs:")
    for name, kern_ms, plain_ms in per_call:
        print(f"  {name}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms")
    print("device activities of one call, queued back to back:")
    for name, reps, kern, _ in pairs:
        if not name.startswith("row gather"):
            print(f"  {name}: {format_split(kernel_split(kern, reps))}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "profile_torch_frame.txt")
    with open(path, "w") as f:
        f.write(f"{PROF} frames of the bench's first chunk, from frame {WARM + WALL}\n")
        f.write(prof.key_averages().table(sort_by=_sort_key(prof), row_limit=120))
    print(f"tables written to {path}")


if __name__ == "__main__":
    main()
