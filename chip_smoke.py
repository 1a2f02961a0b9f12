#!/usr/bin/env python3
"""Smoke run of the torch port on one NVIDIA card (H100).

Drives ``kaldi_decoder_tpu_torch`` (never the JAX package) through its
main path at the bench's full size: the cached native HLG
(``.bench_cache/hlg_v500_w5000_s0.npz``, 102,298 states), 16 utterances of
1000 frames rebuilt from the bench's seed, beam 15, max_active 2560,
K 4096, rem_budget 49152, em_records 8192, lattice beam 8, chunks of 500
frames, ``device_prune=True``.  The bench also asks for flat_group 8, but
the JAX decoder runs the folded device graph at the default 4 (ROADMAP
Queue 3), and so does the port; the smoke sets only what takes effect.

The 1-best path runs on the same graph, utterances and beam settings:
``BatchedViterbiDecoder`` (folded, K 4096, rem_budget 49152, B=16) and
the streaming ``FasterDecoder`` on the unfolded graph (its own capacities,
eps closure of depth 1 on every frame, B=1, 100 frames per call).  The
lattice decoder's eps path runs on the unfolded graph too:
``BatchedLatticeDecoder(fold=False)`` with the lattice config above, and
the streaming ``LatticeFasterDecoder`` and ``LatticeSimpleDecoder``.

Phases (any failure raises, and the process exits non-zero):
  0. device: a CUDA card must be present; prints its ``nvidia-smi`` name
     and power limit;
  1. build: the CUDA kernels (K1 ``csrc/expand.cu``, which reads each
     active slot's em_block row itself, K2 ``csrc/dedup_rec.cu``, K3
     ``csrc/frame.cu``, the frame driver's tail, K4 ``csrc/sweep.cu``, K5
     ``csrc/eps.cu``, K6 ``csrc/dedup.cu``, the eps step
     ``csrc/eps_step.cuh`` (the last step of K6's and K2's eps calls), and
     the
     standalone row
     gather ``csrc/gather.cu``, the counterpart of the TPU experiments'
     gathers, which no path calls) and the C++ host library, from the
     checkout's sources;
  2. kernels: K1 on real frontiers, K2 on the lanes K1 gives there and on
     lattice frame 250's (every field bitwise: frontier, ``num_unique``,
     record rows, overflow; timed on frames 150 and 250), the
     row gather on a real frontier's
     states (and on the lane-packed table of the TPU experiments), K4 on
     one real chunk, K1 with its source-slot output and K6 on the
     emitting candidates of real Viterbi frames, and K6 on one eps
     iteration's incumbent-first candidates of the unfolded graph, all at
     bench shapes; then the row gather, K1 with its source slots and K6
     (emitting and eps candidates) on a frame run by phase 5's own
     streaming decoder, at its shapes (B=1); each held against its plain
     torch version (bitwise:
     every float operation on the path is an add, subtract, compare or
     min in the same order) and timed: device time per call (calls queued
     back to back, CUDA events), wrapper time (CUDA events around one
     call, host enqueue included), the call's bound (bytes over the
     memory rate, operations over the float32 rate) and the share of it
     reached; the row gather also against ``torch.index_select`` and an
     empty kernel's time (the launch floor), and
     K1's, K2's and each K6 call's split by device activity (profiler),
     with K2's and K6's split of their slowest cluster into the kernel's
     steps, K6's winners per utterance (the count that sizes its select)
     and their cluster sizes;
  3. lattice path: ``BatchedLatticeDecoder.decode`` with the launch
     counters set to 0 just before; K1 (row gather folded in) and K2 must
     launch once per frame, K4 once per chunk and the row gather never;
     the 1-best labels, per-frame ``num_active`` and overflow and
     saturation counts must equal the JAX reference (``tests/data/torch_port_bench_ref.json``); prints the WER
     and the decode's wall time;
  4. batched 1-best path: ``BatchedViterbiDecoder.decode`` with the
     counters set to 0 just before; K1 and K6 must launch once per frame
     and the row gather, K5 and the eps step never (a folded graph); per
     utterance the 1-best output labels, the float32 bits of the best
     path's total cost, per-frame ``num_active``, a hash of the per-frame
     best costs and the overflow and saturation counts
     must equal the JAX reference
     (``tests/data/torch_port_viterbi_ref.json``); prints the decode wall
     time, the host 1-best time and the WER;
  5. streaming API: ``FasterDecoder`` over the first utterances, the
     counters set to 0 just before; K1 must launch once per frame, K6
     (1 + eps_iters) times per frame plus eps_iters times per
     ``init_decoding``, K5 and the eps step (inside K6's eps calls, none
     alone) eps_iters times per frame and per ``init_decoding``, the row
     gather never; the same fields must equal
     the JAX reference; prints ms per frame;
  6. the lattice decode without folding: ``BatchedLatticeDecoder(graph,
     config, fold=False)`` on the unfolded graph (eps depth 1), B=16,
     chunks of 500, ``device_prune=True``, the counters set to 0 just
     before; K1 must launch once per frame, K2 (1 + eps_iters) times per
     frame plus eps_iters for the start closure, K5 and the eps step
     (inside K2's eps calls, none alone) eps_iters times per frame and for
     the start closure, K4 once per
     chunk, K6 and the row gather never; per utterance the 1-best labels, the
     float32 bits of the best path's cost, ``num_active``, the overflow
     and saturation counts, the raw lattice's size and a sha256 of its
     arcs and of its finals, ``reached_final`` and
     ``final_relative_cost`` must equal the JAX reference
     (``tests/data/torch_port_lattice_eps_ref.json``);
  7. the streaming lattice API on the unfolded graph:
     ``LatticeFasterDecoder`` over the first 2 utterances, 100 frames per
     ``advance_decoding``, then ``LatticeSimpleDecoder.decode`` of the
     first, each counted (K1 once a frame, K2 (1 + eps_iters) times a
     frame plus eps_iters per ``init_decoding``, K5 and the eps step (inside
     K2's eps calls)
     eps_iters times a frame and per ``init_decoding``, K4, K6 and the row
     gather never) and checked as phase 6 against the same reference;
     prints ms per frame;
  8. the graph file and the CLI: the unfolded bench graph (102,298
     states, 4,266,835 emitting and 5,282 eps arcs) built as a
     ``StdVectorFst`` from its CSR arrays, written with ``write_fst`` and
     read back with ``load_graph``, which must equal the ``.npz`` graph
     array for array; then ``cli.main(["decode", "--graph", <file>, ...,
     "--device", "cuda"])`` on phase 7's two utterances saved as ``.npy``:
     the lattice decoder (phase 7's config, lattice files, n-best of 5),
     whose hyps must equal the ``LatticeFasterDecoder`` labels and whose
     lattice files, read back with ``read_fst``, the raw lattices of
     ``tests/data/torch_port_lattice_eps_ref.json``; then the faster
     decoder with phase 5's options, whose hyps must equal the streaming
     labels of ``tests/data/torch_port_viterbi_ref.json``; the CLI's
     decoders must derive phases 7's and 5's device configs from the
     file's graph; each run counted (as phases 7 and 5); prints the
     seconds to build, write and read the graph and per utterance;
  9. the CTC encoder: ``CtcEncoder`` at its default config (80 features,
     hidden 256, 4 layers, vocab 500, subsampling 4), seeded numpy weights
     carried across by ``encoder_from_numpy``, on 16 utterances of 4000
     feature frames (1000 posterior frames each), TF32 off; the
     posteriors must be within 1e-4 of the same module in float64 on the
     CPU; then decoded by ``BatchedLatticeDecoder`` at phase 3's config,
     counted as phase 3 (K1 and K2 once a frame, K4 once a chunk); then
     K1 and K2 on frames ``ENCODER_FRAMES`` of that decode and K4 on its
     first chunk held against their plain versions (the untrained
     scores overflow far more often than the bench's);
  10. link recall: the port's ``OracleLatticeDecoder`` (host) against
     ``BatchedLatticeDecoder(device_prune=False)`` on utterance 0 trimmed
     to the reference's frames, at em_records 4096, 8192 and 16384 (the
     bench's decoder config, ``kaldi_decoder_tpu_torch.lattice.recall``);
     recall, link counts, extra links, overflow and saturated frames,
     best-path match and device config must equal
     ``tests/data/torch_port_recall_ref.json`` (the JAX decoder and
     oracle); each decode counted (K1 and K2 once a frame, no K4).
  11-13. more than one rank, each phase at P = 1 in this process over
     NCCL (``initialize_distributed(backend="nccl")``, ``make_mesh(1)``)
     and at P = 2 in two spawned ranks sharing ``cuda:0`` over gloo (NCCL
     refuses two ranks on one card; gloo stages each exchange through the
     host), each rank building the workload itself and loading the
     kernels the parent built:
  11. data parallel: ``BatchedLatticeDecoder`` at phase 3's config with
     ``mesh=make_mesh(P)``, each rank decoding its 16 / P utterances and
     gathering the rest (one collective first makes the group's
     communicator, outside the timed decode); checked on every rank as
     phase 3 (launch counts per rank, every utterance against
     ``torch_port_bench_ref.json``); then rank 0 holds K1 and K2 on its
     rows' frames 0-250 and K4 on its rows' first chunk against plain and
     times them, while the other rank waits: phase 2's checks at a rank's
     shapes (B = 16 / P);
  12. ``ShardedViterbiDecoder`` on a ``("model",)`` mesh of the P ranks,
     the unfolded graph, ``SHARD_CONFIG`` (K 2048 a shard), the first
     ``SHARD_FRAMES`` frames, through the sharded frame driver
     (``parallel/shard_driver.py``): at P = 1 over NCCL every frame but
     its first replayed from one captured CUDA graph (``SHARD_FRAMES`` -
     1 replays, counted), at P = 2 over gloo the host loop (0 replays);
     per rank K8's merge, K1 and K3's shard mode once a frame, K3's shard
     first-frame mode and K8's local half once a chunk, K6 and K7's send
     side (1 + eps_iters) times a frame plus eps_iters, K7's receive side
     once a frame, K5 and the eps step's shard mode eps_iters times a
     frame plus eps_iters (the start closure's); the collectives by kind
     exactly (10.01 a frame, a replay counting what the graph holds); per
     utterance the 1-best labels, the best path cost's bits,
     ``num_active``, a hash of the per-frame best costs and the overflow
     and saturation counts against ``tests/data/torch_port_shard_ref.json``
     (the JAX sharded decoders on the CPU at P = 1 and 2), on every rank;
  13. ``ShardedLatticeDecoder`` on the same shards, lattice beam 8: as 12
     with K2 in K6's place; per utterance as phase 6, and utterance 0's
     pruned links (``pruned_links``), against the same reference.
     Each of 11-13 prints its collectives by kind and per frame; 12-13
     also their wall and device (profiled run) ms a frame, busy share,
     launches a frame, and device activities a frame split into the
     port's kernels, collectives and copies, and other (their names are
     printed; none may run once a frame or more); at P = 1 also the
     decode replayed from the graph against the host loop
     (``loop_walls``) and the graph's pool.  Rank 0 of 12 and 13 holds
     K5, K1, K6 or K2 (emitting and eps calls), K7's send (at every
     cluster size too) and receive sides (emitting and eps calls), the eps
     step's shard mode, K3's shard mode, its first-frame mode and K8's
     halves on frame ``SHARD_FRAME``'s inputs (the chunk's start for the
     first-frame mode and K8's local half), kept (``CallCapture``) from a
     decode run as the host loop (``driver.eager_frames``: a replayed
     frame's calls do not pass through the wrappers' Python), against
     plain (bitwise) and times them, while the other rank waits: phase
     2's checks at the shard shapes.
Every chunk loop of phases 3-13 runs through a frame driver
(``decoders/driver.py``; the sharded ones ``parallel/shard_driver.py``,
under NCCL only: over gloo each exchange is staged through the host, and
the same frame runs from the host loop): each frame is replayed from one
captured CUDA graph of K1, K2 or K6, the eps closure and K3 (the sharded
frame's with its collectives), and K3 launches once a frame and its
first-frame mode once a chunk or call, which the launch counts check,
with the frames replayed.  Phases 3-7, 11 and 12-13 at P = 1 also measure
their loop replayed from the graph and as the loop before the frame driver
(``driver.eager_frames``), in turns: wall ms a frame, device ms and
activities a frame (profiler), busy share; phases 3-4 also the whole
decode's seconds both ways.  Phase 2 holds K3 (its first-frame mode
against ``get_cutoff``, its frame tail against ``frame_tail_plain``,
bitwise) on a frame of each path's own driver: the lattice, unfolded
lattice and 1-best frames at B=16 and the streaming decoders' at B=1,
at its own cluster size and at 8, 4, 2 and 1 blocks a row, and times it
at each.
Phase 2 also holds K5, K2's eps call (incumbents first, on K5's lanes)
and that call with the eps step as its last step (against K2's plain
version then ``eps_step_plain``) on the eps iterations of the unfolded
lattice decode at frames 150 and 250 (each timed, K5 and the fused call
with their bound and share, the fused call beside the same call without
the step; K5 held and timed at each cluster size), K5, K6 and K6 with the
eps step on the streaming ``FasterDecoder``'s frame 60 and on its start
closure (cutoff +inf), K5 and K2 with the eps step on
the streaming ``LatticeFasterDecoder``'s frame 60, and K4
with eps records on its first 500-frame chunk, against their plain
versions, bitwise, and times them; K2's emitting and eps calls at the
streaming lattice decoder's B=1 shapes (phase 7's decoder, frame 60);
and K1 and K2 at phase 10's recall shapes (B=1, K 4096, each em_records
budget) on every frame of the recall utterance, timed on the frame with
the most records.
A line ``{"frame_loops": ...}`` gives those loop measurements.  The line
before the last is a JSON object with each kernel's launches
(summed over the counted runs of phases 3-13, and by phase), error,
times, bound and library-call time; the last is ``{"ok": true,
"device": {...}}``.

    python3 chip_smoke.py
"""

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
V = 500
B = 16
T = 1000
CHUNK = 500
HLG_WORDS = 5000
BENCH_CONFIG = dict(
    beam=15.0, max_active=2560, min_active=200, frontier_size=4096, rem_budget=49152,
)
DECODER_KW = dict(lattice_beam=8.0, em_records=8192, pad_time_to=CHUNK)
K1_FRAMES = (0, 1, 5, 20, 60, 150)  # frames whose frontiers K1 is checked on
K2_FRAMES = (150, 250)  # lattice frames on whose lanes K2 is timed (and checked, with K1's)
# Frames of the unfolded lattice decode on whose eps iteration K2's eps call
# is checked and timed.
K2_EPS_FRAMES = (150, 250)
TIMING_REPS = 10
CLUSTER_SIZES = (8, 4, 2, 1)  # the blocks a row K3, K5 and the shard modes are held and timed at
VITERBI_CONFIG = dict(
    beam=15.0, max_active=2560, min_active=200, frontier_size=4096, rem_budget=49152,
)
K6_FRAMES = (0, 5, 60, 150)  # Viterbi frames whose emitting candidates K6 is checked on
EPS_FRAME = 60  # frame of the unfolded decode whose eps iteration K6 is checked on
STREAM_FRAME = 60  # frame of the streaming decode its kernels are checked on
FRAMES_PER_CALL = 100  # advance_decoding(max_num_frames=...) in phase 5
# Frames over which each path's loop is measured replayed from the frame
# driver's graph and as the loop before the frame driver (loop_walls): the
# batched paths' first chunk's first frames, the streaming decoders'
# first calls on utterance 0.
WALL_FRAMES = 200
WALL_STREAM_FRAMES = 300
# The recall measurement (phase 10, scripts/measure_recall_torch.py):
# bench.make_decoder's lattice decoder (bench.py:170-187; the device
# re-derives flat_group 4, ROADMAP Queue 3) at each em_records budget, and
# the oracle at the same beams (scripts/measure_recall.py:59-62).
RECALL_CONFIG = dict(BENCH_CONFIG, eps_rem_budget=2048, flat_group=8)
RECALL_KW = dict(lattice_beam=8.0, eps_records=1024, pad_time_to=CHUNK)
RECALL_BUDGETS = (4096, 8192, 16384)
ENCODER_FRAMES = (1, 150, 600)  # frames of phase 9's decode whose K1 and K2 calls it holds
# Phases 12-13: the sharded decoders on the unfolded graph, per shard half
# the bench's K and rem_budget (P = 2 holds the bench's capacity), on the
# first SHARD_FRAMES frames (the JAX reference's cut,
# scripts/make_torch_shard_reference.py).
SHARD_CONFIG = dict(beam=15.0, max_active=2560, min_active=200, frontier_size=2048,
                    rem_budget=24576)
SHARD_FRAMES = 250
SHARD_LATTICE_BEAM = 8.0
SHARD_FRAME = 150  # frame whose K1, K6 and K2 calls phase 2 holds at the shard shapes
PARALLEL_TIMEOUT = 900  # seconds phases 11-13's two ranks may take


# Set in phases 11-13's spawned ranks: their lines say whose they are.
LOG_PREFIX = ""


def log(*a):
    print(*((LOG_PREFIX,) if LOG_PREFIX else ()), *a, flush=True)


def bench_workload():
    """The bench's graph, scores, lengths and transcripts, rebuilt from
    the seed exactly as ``bench.py:build_hlg_workload`` builds them."""
    import numpy as np

    from kaldi_decoder_tpu_torch.fst.csr import load_graph_npz
    from kaldi_decoder_tpu_torch.fst.hlg import (
        random_lexicon,
        sample_corpus,
        synth_posteriors,
        words_to_tokens,
    )

    graph = load_graph_npz(os.path.join(REPO, ".bench_cache", f"hlg_v{V}_w{HLG_WORDS}_s{SEED}.npz"))
    rng = np.random.default_rng(SEED)
    lex = random_lexicon(HLG_WORDS, V, rng, 3, 8)
    corpus = sample_corpus(HLG_WORDS, 2500, rng, mean_len=12.0)
    corpus += sample_corpus(HLG_WORDS, 400, rng, mean_len=75.0)
    rng2 = np.random.default_rng(SEED + 1)
    pron = dict(lex)
    longs = [s for s in corpus if len(s) >= 40]
    scores = np.full((B, T, V), np.log(1.0 / V), np.float32)
    lengths = np.zeros(B, np.int32)
    refs = []
    for b in range(B):
        words = list(longs[int(rng2.integers(len(longs)))])
        while True:
            toks = words_to_tokens(words, pron)
            sc = synth_posteriors(toks, V, np.random.default_rng(SEED + 10 + b))
            if sc.shape[0] <= T or len(words) <= 1:
                break
            words = words[: max(1, int(len(words) * 0.9))]
        refs.append(words)
        L = min(sc.shape[0], T)
        scores[b, :L] = sc[:L]
        lengths[b] = L
    return graph, scores, lengths, refs


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=TIMING_REPS):
    """Median milliseconds of one call of ``fn`` on the current stream (CUDA
    events around the call, so host enqueue and allocation are included),
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _queue_calls(fn, reps):
    """Hold the stream with a sleep kernel long enough for the host to
    queue ``reps`` calls of ``fn`` behind it, so that the device runs them
    back to back and no host time shows between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # About 2e6 cycles per ms at the card's boost clock; a slower clock
    # only sleeps longer.
    torch.cuda._sleep(int((1.5 * host_ms * reps + 1.0) * 2e6))


def device_ms(fn, reps=TIMING_REPS):
    """Device milliseconds per call of ``fn``, the calls run back to back
    (CUDA events around ``reps`` queued calls): kernel time and the gaps
    between the call's kernels, without host enqueue."""
    import torch

    _queue_calls(fn, reps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_split(fn, reps=TIMING_REPS):
    """The device activities of one call of ``fn`` in launch order, the
    calls queued back to back as in :func:`device_ms`, from the profiler's
    trace: ``[(name, mean µs, mean µs idle before it), ...]``; the first
    entry's idle time is the gap after the previous call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _queue_calls(fn, reps)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name),
                 key=lambda e: e.time_range.start)
    # The queued calls are the trace's last activities, and a call's
    # activities are the period of their names.  What comes before them
    # is not counted on: the trace can miss its first activities, so the
    # period is looked for over the last calls it kept, at least half.
    names = [e.name for e in evs]
    n = calls = 0
    for p in range(1, len(evs) + 1):
        m = min(reps, len(evs) // p)
        if m < max(2, reps // 2):
            break
        tail = names[len(names) - p * m:]
        if all(tail[i] == tail[i + p] for i in range(p * (m - 1))):
            n, calls = p, m
            break
    if n == 0:
        raise AssertionError(f"no call of repeating activities in {len(evs)} for {reps} "
                             "calls: " + ", ".join(e.name[:30] for e in evs[-12:]))
    evs = evs[-n * calls:]
    out = []
    for p in range(n):
        us = [evs[c * n + p].time_range.end - evs[c * n + p].time_range.start
              for c in range(calls)]
        gaps = [evs[c * n + p].time_range.start - evs[c * n + p - 1].time_range.end
                for c in range(calls) if c * n + p > 0]
        out.append((evs[p].name, statistics.mean(us), statistics.mean(gaps) if gaps else 0.0))
    return out


def format_split(split):
    return "; ".join(f"{name[:40]} {us:.2f} µs (idle before {gap:.2f})"
                     for name, us, gap in split)


# The least time the card could take for a call's work: the larger of its
# bytes (each input read once, each output written once) over the memory
# rate and its operations over the float32 rate.  H100 SXM peaks at the
# 700 W limit (NVIDIA's data sheet): 3.35 TB/s, 67 TFLOP/s float32 outside
# the tensor cores.
HBM_BYTES_PER_MS = 3.35e9
FP32_OPS_PER_MS = 67e9


def bound_ms(nbytes, nops):
    """(ms, "bytes" or "operations") for a call's bytes and operations."""
    b, o = nbytes / HBM_BYTES_PER_MS, nops / FP32_OPS_PER_MS
    return (b, "bytes") if b >= o else (o, "operations")


def gather_work(table, idx):
    """Bytes and operations of a row gather: the indices, each distinct
    row read once, every gathered row written."""
    import torch

    width = table.shape[1] * table.element_size()
    rows = int(torch.unique(idx).numel())
    return idx.numel() * 4 + rows * width + idx.numel() * width, 0


def k1_work(states, costs, cutoff, adaptive_beam, scores_t, pg, fc, with_src_slot=False):
    """Bytes and operations of one K1 call (its row reads included): the
    frontier prefix it reads, the em_block rows of the active slots, the
    em_flat units the active slots' remainders use (capped at the budget),
    the scores; every output lane written."""
    import torch

    from kaldi_decoder_tpu_torch.fst.pack import EM_FIELDS
    from kaldi_decoder_tpu_torch.kernels.expand import remainder_units

    KE, G, Ru, N = fc.expand_lanes, fc.flat_group, fc.rem_units, fc.num_candidates
    B, V = scores_t.shape
    c = costs[:, :KE]
    n_act = int((torch.isfinite(c) & (c < cutoff[:, None])).sum())
    units = int(remainder_units(states, costs, cutoff, pg, fc).clamp(max=Ru).sum())
    outs = 5 if with_src_slot else 4
    nbytes = (B * KE * 4 + n_act * 4 + B * 8 + B * V * 4 + n_act * pg.em_block.shape[1] * 4
              + units * G * EM_FIELDS * 4 + outs * B * N * 4 + B * 5)
    return nbytes, 3 * B * N  # two adds and a compare per lane


def k4_work(fstates, fcosts, em, init_states, rem, out, eps=None):
    """Bytes and operations of one K4 chunk: of the frames an utterance
    still emits (t < min(rem, T)), the live frontier slots (state and
    cost), the valid records and, with ``eps``, the valid eps records
    (one Bellman pass over them); the chunk-entry states; the survivor
    rows and counts written."""
    import torch

    T, B, K = fstates.shape
    need = torch.arange(T, device=rem.device)[:, None] < rem.clamp(max=T)[None, :]
    live = int((torch.isfinite(fcosts) & need[..., None]).sum())
    valid = int(((em[..., 1] >= 0) & need[..., None]).sum())
    kept = int(out.tok_count.sum()) + int(out.em_count.sum()) + int(out.eps_count.sum())
    veps = 0 if eps is None else int(((eps[..., 1] >= 0) & need[..., None, None]).sum())
    nbytes = live * 8 + (valid + veps) * 16 + B * K * 4 + B * 4 + kept * 12 + B * 13
    return nbytes, live + 3 * valid + 3 * veps


def k6_work(costs, K):
    """Bytes and operations of one K6 call on (B, N) lane costs: every
    lane's cost, the state of every finite lane, the (B, K) frontier and
    winning lanes written."""
    import torch

    B, N = costs.shape
    fin = int(torch.isfinite(costs).sum())
    return B * N * 4 + fin * 4 + 3 * B * K * 4 + B * 4, 2 * fin


def k2_work(cand_state, cand_cost, k, num_states, r, slack_beam, payload, num_incumbents=0):
    """Bytes and operations of one K2 call on (B, N) lanes: every lane's
    cost, the state of every finite lane and the two payload columns of
    each record written (the plain version's count) read; the (B, K)
    frontier (and, for the eps call, its winning lanes), the counts, the
    (B, R, 4) record rows and the overflow flags written; a compare, a
    subtract and a compare per finite lane."""
    import torch

    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    B, N = cand_cost.shape
    fin = int(torch.isfinite(cand_cost).sum())
    sel = dedup_select_rec_plain(cand_state, cand_cost, k, num_states, r, slack_beam, payload,
                                 num_incumbents)
    taken = int((sel.rec_dst >= 0).sum())
    idx = B * k * 4 if num_incumbents else 0
    return (B * N * 4 + fin * 4 + taken * 8 + B * k * 8 + idx + B * 4 + B * r * 16 + B,
            3 * fin)


def k5_work(lanes, states, costs, cutoff_rel, pg, fc):
    """Bytes and operations of one K5 call: the frontier (states and
    costs) and the cutoffs read, the eps_block rows of the active slots and
    the eps_flat arcs of the remainder lanes in use (capped at the budget);
    every output lane's columns (those asked for) and the overflow flags
    written; an add and a compare an arc lane."""
    import torch

    B, K = states.shape
    We, R = fc.eps_block_width, fc.eps_rem_budget
    act = torch.isfinite(costs) & (costs <= cutoff_rel[:, None])
    deg = pg.eps_block[torch.where(act, states, 0).long(), -1]
    rem = torch.where(act, (deg - We).clamp(min=0), 0).sum(dim=1).clamp(max=R)
    N = lanes.dst.shape[1]
    cols = sum(x is not None for x in lanes[:5])
    nbytes = (B * K * 8 + B * 4 + int(act.sum()) * pg.eps_block.shape[1] * 4 + int(rem.sum()) * 8
              + cols * B * N * 4 + B)
    return nbytes, 2 * B * (K * We + R)


def eps_step_work(sel, carry):
    """Bytes and operations of the eps step as the last step of its dedup
    call: on the 1-best path the source slot and arc of each slot's
    winning lane read, on the lattice path the spill row; the iteration's
    backpointers or records and the row and batch flags written; a compare
    a slot.  (The winning lanes and records it takes are the call's own,
    in registers.)"""
    B, K = sel.states.shape
    if getattr(sel, "records", None) is not None:
        nbytes = B * 16 + B * carry.out.shape[2] * 16
    else:
        nbytes = int((sel.cand_idx >= 0).sum()) * 8 + B * K * 8
    return nbytes + B * 5 + 8, B * K


def same_fields(ref, got, what, where):
    """Raise unless two tuples of tensors (fields None in both allowed)
    are equal field by field, floats by their raw bits."""
    import torch

    for name, r, g in zip(ref._fields, ref, got):
        if (r is None) != (g is None):
            raise AssertionError(f"{what} and plain differ in which fields they give: {name}")
        if r is None:
            continue
        if r.dtype == torch.float32:
            r, g = r.view(torch.int32), g.view(torch.int32)
        if not torch.equal(r, g):
            raise AssertionError(f"{what} differs from plain on {where}: {name}")


def hold_k5(st, cutoff_rel, pg, fc, lattice, where, timed=False):
    """K5 (the K incumbents first; the lattice paths' columns when
    ``lattice``) against its plain version on a frontier, bitwise in every
    column; with ``timed`` also timed.  Returns (K5's lanes, the
    time_kernel fields or None)."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.eps import (
        blocks_per_row,
        expand_eps_lanes,
        expand_eps_lanes_plain,
    )

    args = (st.states, st.costs, cutoff_rel, pg, fc, True)
    kw = dict(with_src_slot=not lattice, with_src_state=lattice)
    ref = expand_eps_lanes_plain(*args, **kw)
    got = expand_eps_lanes(*args, **kw)
    torch.cuda.synchronize()
    same_fields(ref, got, "K5", where)
    if not timed:
        return got, None
    B, N = got.dst.shape
    log(f"K5 expand_eps_lanes on {where} (B={B}, K={fc.frontier_size}, We="
        f"{fc.eps_block_width}, R={fc.eps_rem_budget}, N={N}, "
        f"{int((ref.cost[:, fc.frontier_size:] < float('inf')).sum())} arc lanes under the "
        f"cutoff, overflow rows {int(ref.overflow.sum())}; {blocks_per_row(B, N)} blocks a "
        "row): equal to plain, bitwise; timed there:")
    out = got
    t = time_kernel(f"K5, {where}", lambda: expand_eps_lanes(*args, **kw, out=out),
                    lambda: expand_eps_lanes_plain(*args, **kw),
                    k5_work(got, st.states, st.costs, cutoff_rel, pg, fc))
    # The cluster sizes (blocks a row): each equal to plain, bitwise, and
    # timed against the kernel's choice.
    for c in CLUSTER_SIZES:
        same_fields(ref, expand_eps_lanes(*args, **kw, out=out, blocks=c),
                    f"K5 at {c} blocks a row", where)
    torch.cuda.synchronize()
    t["ms_by_blocks"] = {c: device_ms(lambda: expand_eps_lanes(*args, **kw, out=out, blocks=c))
                         for c in CLUSTER_SIZES}
    t["share_by_blocks"] = {c: t["bound_ms"] / ms for c, ms in t["ms_by_blocks"].items()}
    log("  K5 at each cluster size, equal to plain: device ms (share of the bound) "
        + ", ".join(f"{c}: {ms:.4f} ({t['share_by_blocks'][c]:.1%})"
                    for c, ms in t["ms_by_blocks"].items()))
    return got, t


def hold_eps_step(lanes, args, iters, exact, where, timed=False):
    """The eps dedup call on K5's ``lanes`` (``args``: the dedup call's
    arguments, K6's ``(dst, cost, K, S)`` or K2's ``(dst, cost, K, S, R,
    slack_beam, payload)`` with the K incumbents first), which runs the eps
    step as its last step (iteration 0 of ``iters``, every row active),
    against its plain composition (the dedup call's plain version, then
    ``eps_step_plain``), bitwise in every field of the selection and of the
    carry; with ``timed`` also timed, beside the same dedup call without
    the step (``dedup_alone_ms``; ``step_ms`` the difference).  Returns the
    time_kernel fields or None."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        LatticeSelection,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.kernels.eps import empty_eps_carry, eps_dedup, eps_step_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    lattice = len(args) > 4
    K, S = args[2], args[3]
    B = lanes.dst.shape[0]
    width = args[4] - K if lattice else K
    dev = lanes.dst.device
    ref_c, got_c = (empty_eps_carry(B, iters, width, lattice, dev) for _ in range(2))
    active = torch.ones((B,), dtype=torch.bool, device=dev)

    def plain(carry):
        if lattice:
            p = dedup_select_rec_plain(*args, num_incumbents=K)
            sel = LatticeSelection(p.states, p.costs, p.num_unique, stack_records(p),
                                   p.rec_overflow, p.cand_idx)
        else:
            sel = dedup_select_plain(*args)
        eps_step_plain(0, carry, active, lanes.overflow, sel, exact, lanes)
        return sel

    def fused(carry, out=None):
        return eps_dedup(0, carry, active, lanes, exact, K, S, args[5] if lattice else None,
                         out=out)

    ref = plain(ref_c)
    got = fused(got_c)
    torch.cuda.synchronize()
    same_fields(ref, got, "the eps dedup call", where)
    ref_c.out[:, 1:] = got_c.out[:, 1:]  # rows of the iterations not run: unwritten in both
    same_fields(ref_c, got_c, "the eps step inside the eps dedup call", where)
    if not timed:
        return None
    log(f"eps step inside the eps dedup call ({'K2' if lattice else 'K6'}) on {where} (B={B}, "
        f"K={K}, {'records ' + str(width) if lattice else 'backpointers'}, "
        f"{int(got_c.changed.sum())} rows changed): equal to the dedup call's plain version "
        "then eps_step_plain, bitwise; timed there:")
    dedup_work = (k2_work(*args, num_incumbents=K) if lattice else k6_work(args[1], K))
    step_work = eps_step_work(got, got_c)
    t = time_kernel(f"eps dedup call with the eps step, {where}", lambda: fused(got_c, got),
                    lambda: plain(ref_c), (dedup_work[0] + step_work[0],
                                           dedup_work[1] + step_work[1]))
    alone = (lambda: dedup_select_rec(*args, num_incumbents=K, out=got)) if lattice else \
        (lambda: dedup_select(*args, out=got))
    t["dedup_alone_ms"] = device_ms(alone)
    t["step_ms"] = t["ms"] - t["dedup_alone_ms"]
    t["step_bound_ms"], _ = bound_ms(*step_work)
    log(f"  the same dedup call without the step: {t['dedup_alone_ms']:.4f} ms; the step adds "
        f"{t['step_ms']:.4f} ms (its own bound {t['step_bound_ms']:.5f} ms)")
    return t


def same_records(ref, got, where):
    """Raise unless K2's result equals the plain version's (``ref``, an
    ``ops.segment.SelectionRec``) in every field, costs and slacks by raw
    bits; returns the largest frontier cost difference."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup_rec import stack_records

    want = stack_records(ref)
    fields = dict(states=(ref.states, got.states), num_unique=(ref.num_unique, got.num_unique),
                  costs=(ref.costs.view(torch.int32), got.costs.view(torch.int32)),
                  rec_overflow=(ref.rec_overflow, got.rec_overflow),
                  **({} if ref.cand_idx is None else {"cand_idx": (ref.cand_idx, got.cand_idx)}),
                  **{name: (want[..., c], got.records[..., c]) for c, name in
                     enumerate(("src_state", "arc_id", "rec_dst", "rec_slack"))})
    for name, (r, g) in fields.items():
        if not torch.equal(r, g):
            raise AssertionError(f"K2 differs from plain on {where}: {name}")
    fin = torch.isfinite(ref.costs)
    return float((ref.costs[fin] - got.costs[fin]).abs().max()) if fin.any() else 0.0


def time_kernel(name, kern, plain, work, reps=TIMING_REPS, library=None):
    """A kernel's wrapper against its plain version on the same inputs:
    device time per call (:func:`device_ms`) and wrapper time
    (:func:`cuda_ms`, host enqueue included) of each, the bound of the
    call's ``work`` (bytes, operations) and, where one PyTorch call
    computes the same function, that call's device time.  Logs them and
    returns the kernels line's fields."""
    t = dict(ms=device_ms(kern, reps), plain_ms=device_ms(plain, reps),
             wrapper_ms=cuda_ms(kern, reps), plain_wrapper_ms=cuda_ms(plain, reps),
             library_ms=device_ms(library, reps) if library else None)
    t["bound_ms"], t["bound_by"] = bound_ms(*work)
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    lib = f", one PyTorch call {t['library_ms']:.4f}" if library else ""
    log(f"  {name}: device {t['ms']:.4f} ms per call (plain {t['plain_ms']:.4f}{lib}); "
        f"bound {t['bound_ms']:.4f} ms by {t['bound_by']} ({work[0] / 1e6:.2f} MB), "
        f"{t['share_of_bound']:.1%} of it reached; wrapper {t['wrapper_ms']:.4f} ms "
        f"(plain {t['plain_wrapper_ms']:.4f})")
    return t


def float_bits_equal(a, b):
    import torch

    za = torch.where(a == 0, 0.0, a).view(torch.int32)
    zb = torch.where(b == 0, 0.0, b).view(torch.int32)
    return torch.equal(za, zb)


def same_expansion(ref, got, where):
    """Raise unless two K1 results are equal lane for lane (fields not
    asked for are None in both); returns the largest cost difference."""
    import torch

    for name, r, g in zip(ref._fields, ref, got):
        if r is None or g is None:
            if r is not g:
                raise AssertionError(f"K1 and plain differ in which fields they give: {name}")
            continue
        same = float_bits_equal(r, g) if r.dtype == torch.float32 else torch.equal(r, g)
        if not same:
            raise AssertionError(f"K1 differs from plain at {where}: {name}")
    fin = torch.isfinite(ref.cost)
    return float((ref.cost[fin] - got.cost[fin]).abs().max()) if fin.any() else 0.0


def check_unread_states(ref, args, num_states, where, with_src_slot=False):
    """K1 on the frontier of ``args`` with every state it must not read
    (an inactive slot's, or a slot's at ``expand_lanes`` or beyond) set to
    -1 and to ``num_states + 7`` must equal ``ref``, the plain version on
    the frontier as it is."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter

    states, costs, cutoff, fc = args[0], args[1], args[2], args[6]
    k = torch.arange(states.shape[1], device=states.device)
    read = torch.isfinite(costs) & (costs < cutoff[:, None]) & (k < fc.expand_lanes)
    for value in (-1, num_states + 7):
        got = expand_filter(torch.where(read, states, value), *args[1:],
                            with_src_slot=with_src_slot)
        same_expansion(ref, got, f"{where}, unread states set to {value}")


def same_selection(ref, got, where):
    """Raise unless two K6 results are equal slot for slot, costs by their
    raw bits (a -0.0 stays -0.0); returns the largest cost difference."""
    import torch

    for name, r, g in zip(ref._fields, ref, got):
        if r.dtype == torch.float32:
            r, g = r.view(torch.int32), g.view(torch.int32)
        same = torch.equal(r, g)
        if not same:
            raise AssertionError(f"K6 differs from plain on {where}: {name}")
    fin = torch.isfinite(ref.costs)
    return float((ref.costs[fin] - got.costs[fin]).abs().max()) if fin.any() else 0.0


def k1_clusters(fc, nb):
    """The blocks per cluster K1 launches with for ``nb`` utterances."""
    from kaldi_decoder_tpu_torch.kernels._build import kernels

    return kernels().kd_expand_cluster(nb, fc.expand_lanes, fc.block_width, fc.flat_group,
                                       fc.rem_units)


def k6_winners(args):
    """The winners (distinct in-beam states) of each utterance in one K6
    call: the count that sizes its select."""
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    return dedup_select_plain(*args).num_unique.tolist()


def time_k6(name, args):
    """K6 against its plain version on one call's arguments (time_kernel),
    with its split by device activity and the split of its slowest
    cluster into the kernel's steps; logs the winners per utterance and
    the cluster size."""
    from kaldi_decoder_tpu_torch.kernels.dedup import cluster_size, cluster_steps, dedup_select
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    n = k6_winners(args)
    log(f"  {name}: winners per utterance {n} (K {args[2]}); clusters of "
        f"{cluster_size(*args[0].shape)} blocks")
    t = time_kernel(name, lambda: dedup_select(*args), lambda: dedup_select_plain(*args),
                    k6_work(*args[1:3]))
    log(f"  device activities of one call: {format_split(kernel_split(lambda: dedup_select(*args)))}")
    dedup_select(*args)
    c = cluster_steps(*args[0].shape)
    t["steps_us"] = c["steps_us"]
    log(f"  clusters end at (µs) {', '.join(f'{x:.2f}' for x in c['ends_us'])}; the slowest, "
        f"utterance {c['slowest']}, in steps (µs): "
        + ", ".join(f"{k} {v:.2f}" for k, v in t["steps_us"].items()))
    t["winners"] = n
    return t


def lattice_frontiers(dec, scores_tm, frames):
    """Step ``dec``'s lattice frame over ``scores_tm`` (T, B, V) from the
    start, and before each frame of ``frames`` yield (t, K1's arguments
    there) as the frame would call K1."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_frame_step_batched
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

    fc, S, Bn = dec.cfg.frontier, dec._dev_graph.num_states, scores_tm.shape[1]
    st, _, _, _ = dec._init(Bn)
    active = torch.ones(Bn, dtype=torch.bool, device=dec.device)
    for t in range(max(frames) + 1):
        if t in frames:
            cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active,
                             fc.beam_delta, costs_sorted=True)
            yield t, (st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_tm[t],
                      dec._pg, fc)
        st, _ = lattice_frame_step_batched(st, scores_tm[t], active, dec._pg, dec.cfg, S)


def k2_lanes(dec, ex):
    """K2's arguments on K1's lanes ``ex`` in ``dec``'s lattice frame."""
    sb = dec.cfg.lattice_beam + 1e-4  # lattice_frame_step_batched's slack beam
    return (ex.dst, ex.cost, dec.cfg.frontier.frontier_size, dec._dev_graph.num_states,
            dec.cfg.em_records, sb, (ex.src_state, ex.arc_id))


def check_k1(dec, scores_tm):
    """K1 against its plain version on the frontiers of real frames."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain

    fc = dec.cfg.frontier
    S = dec._dev_graph.num_states
    max_err, timed_args, overflowed = 0.0, None, 0
    k2_args = []  # K2's arguments on K1's lanes, frame by frame
    for t, args in lattice_frontiers(dec, scores_tm, set(K1_FRAMES + K2_FRAMES)):
        got = expand_filter(*args)
        if t in K1_FRAMES:
            ref = expand_filter_plain(*args)
            torch.cuda.synchronize()
            max_err = max(max_err, same_expansion(ref, got, f"frame {t}"))
            check_unread_states(ref, args, S, f"frame {t}")
            overflowed += int(ref.overflow.sum())
            timed_args = args
        k2_args.append((t, k2_lanes(dec, got)))
    log(f"K1 expand (row gather folded in): equal to plain on frames {list(K1_FRAMES)}, "
        "also with the states it must not read set to -1 and to S + 7 "
        f"(B={B}, lanes/utt={fc.num_candidates}, remainder overflows seen={overflowed}, "
        f"clusters of {k1_clusters(fc, B)} blocks); timed on frame {max(K1_FRAMES)}:")
    t = time_kernel("K1 (row gather folded in)", lambda: expand_filter(*timed_args),
                    lambda: expand_filter_plain(*timed_args), k1_work(*timed_args))
    log(f"  device activities of one call: "
        f"{format_split(kernel_split(lambda: expand_filter(*timed_args)))}")
    return max_err, t, timed_args[0], k2_args


def hold_lattice_frames(dec, scores_tm, frames, what):
    """K1 and K2 held against their plain versions on ``dec``'s own
    ``frames`` of ``scores_tm`` (T, B, V): K1 bitwise, also with the states
    it must not read set to -1 and to S + 7, then K2 on K1's lanes, every
    field.  Returns the two largest errors, the remainder overflows and
    the record overflows seen, the most records an utterance took (and
    the frame), and that frame's K1 and K2 arguments."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    S = dec._dev_graph.num_states
    k1_err = k2_err = 0.0
    seen = dict(remainder_overflows=0, record_overflows=0, most_records=-1, at_frame=None)
    for t, k1_args in lattice_frontiers(dec, scores_tm, frames):
        where = f"{what} frame {t}"
        ref = expand_filter_plain(*k1_args)
        got = expand_filter(*k1_args)
        torch.cuda.synchronize()
        k1_err = max(k1_err, same_expansion(ref, got, where))
        check_unread_states(ref, k1_args, S, where)
        k2_args = k2_lanes(dec, got)
        rref = dedup_select_rec_plain(*k2_args)
        rgot = dedup_select_rec(*k2_args)
        torch.cuda.synchronize()
        k2_err = max(k2_err, same_records(rref, rgot, f"the lanes of {where}"))
        seen["remainder_overflows"] += int(ref.overflow.sum())
        seen["record_overflows"] += int(rref.rec_overflow.sum())
        taken = int((rref.rec_dst >= 0).sum(dim=1).max())
        if taken >= seen["most_records"]:
            seen.update(most_records=taken, at_frame=t)
            busiest = k1_args, k2_args
    return k1_err, k2_err, seen, *busiest


def check_recall_kernels(graph, scores_tm, frames):
    """K1 and K2 at the shapes of phase 10's recall decodes (B=1, K 4096,
    em_records 4096, 8192 and 16384): each budget's decoder's own frames
    of utterance 0, every one that phase 10 decodes (``frames``), held
    against the plain versions (:func:`hold_lattice_frames`); K1 and each
    budget's K2 timed on the frame where K2 takes the most records.
    Returns the two largest errors and the timings."""
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        cluster_size,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    k1_err = k2_err = 0.0
    timed = {}
    for r in RECALL_BUDGETS:
        dec = recall_decoder(graph, r, "cuda")
        e1, e2, seen, k1_args, k2_args = hold_lattice_frames(
            dec, scores_tm[:, :1], frames, f"recall (em_records {r})")
        k1_err, k2_err = max(k1_err, e1), max(k2_err, e2)
        N = k2_args[1].shape[1]
        log(f"K1 and K2 at the recall decode's shapes (B=1, K={k2_args[2]}, em_records={r}, "
            f"flat_group {dec.cfg.frontier.flat_group}, N={N}; K2 clusters of "
            f"{cluster_size(1, N)} blocks): equal to plain on utterance 0's frames "
            f"0-{max(frames)} ({seen}); timed on frame {seen['at_frame']}:")
        if "k1" not in timed:
            timed["k1"] = time_kernel("K1, recall decode", lambda: expand_filter(*k1_args),
                                      lambda: expand_filter_plain(*k1_args), k1_work(*k1_args))
        timed[r] = time_kernel(f"K2, recall decode, em_records {r}",
                               lambda: dedup_select_rec(*k2_args),
                               lambda: stack_records(dedup_select_rec_plain(*k2_args)),
                               k2_work(*k2_args))
        timed[r].update(frame=seen["at_frame"], records=seen["most_records"])
        del dec
    return k1_err, k2_err, timed


def check_k2(k2_args):
    """K2 against its plain version (the lattice path's region before K2,
    records stacked as the frame emits them) on K1's lanes of each checked
    frame, then timed on each of ``K2_FRAMES`` with its split by device
    activity and the split of its slowest cluster into the kernel's steps.
    Returns the largest cost difference and the timings by frame."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        cluster_size,
        cluster_steps,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    max_err, eligible = 0.0, []
    for t, args in k2_args:
        ref = dedup_select_rec_plain(*args)
        got = dedup_select_rec(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, same_records(ref, got, f"the lanes of lattice frame {t}"))
        eligible.append(int((ref.rec_dst >= 0).sum(dim=1).max()))
    frames = [t for t, _ in k2_args]
    Bk, N = k2_args[-1][1][1].shape
    a = k2_args[-1][1]
    log(f"K2 dedup_select_rec: equal to plain on lattice frames {frames} (B={Bk}, N={N}, "
        f"K={a[2]}, R={a[4]}, slack beam {a[5]}; most records per utterance "
        f"{eligible}; clusters of {cluster_size(Bk, N)} blocks); timed on frames "
        f"{list(K2_FRAMES)}:")
    timed = {}
    for t, args in k2_args:
        if t not in K2_FRAMES:
            continue

        def kern():
            return dedup_select_rec(*args)

        def plain():
            return stack_records(dedup_select_rec_plain(*args))

        log(f" lattice frame {t}:")
        timed[t] = time_kernel("K2", kern, plain, k2_work(*args))
        log(f"  device activities of one call: {format_split(kernel_split(kern))}")
        kern()
        c = cluster_steps(Bk, N)
        timed[t]["steps_us"] = c["steps_us"]
        log(f"  clusters end at (µs) {', '.join(f'{x:.2f}' for x in c['ends_us'])}; the "
            f"slowest, utterance {c['slowest']}, in steps (µs): "
            + ", ".join(f"{k} {v:.2f}" for k, v in c["steps_us"].items()))
    return max_err, timed


def launch_floor(device):
    """Device milliseconds per launch of an empty kernel, launches queued
    back to back (:func:`device_ms`): the floor under any launch's time."""
    from kaldi_decoder_tpu_torch.kernels._build import cuda_error, kernels, stream

    lib = kernels()

    def empty():
        rc = lib.kd_empty(stream(device))
        if rc != 0:
            raise RuntimeError(f"kd_empty launch failed: {cuda_error(rc)}")

    return device_ms(empty)


LANE_GROUP, LANE_WIDTH = 8, 16  # the lane-packed table: 8 rows of 16 words a group row


def gather_tables(em_block, states):
    """(name, table, indices) of the two row gathers phase 2 checks: em_block
    rows at ``states``, and the group rows of the lane-packed (ceil(S/8),
    128) table that two of the TPU experiments gathered from."""
    import torch

    S, width = em_block.shape
    G = LANE_GROUP
    packed = torch.zeros((-(-S // G) * G, LANE_WIDTH), dtype=torch.int32, device=em_block.device)
    packed[:S, :width] = em_block
    group_idx = torch.div(states, G, rounding_mode="floor").reshape(-1)
    return (("em_block", em_block, states), ("lane-packed", packed.view(-1, G * LANE_WIDTH),
                                             group_idx))


def check_gather(dec, states):
    """The row gather against plain indexing: em_block rows of a real
    frontier's B*K states (the rows K1 reads itself on the main path, and
    the (B, 4096) row gather of the TPU experiments), and the group rows
    of the lane-packed (ceil(S/8), 128) table that two of them gathered
    from; then the launch floor."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain

    em_block = dec._pg.em_block
    width = em_block.shape[1]
    max_err, times, rows = 0, {}, {}
    for name, table, idx in gather_tables(em_block, states):
        got, want = row_gather(table, idx), row_gather_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"row gather differs from plain on the {name} table")
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        rows[name] = got
        log(f"row gather, {name} table {tuple(table.shape)}, {idx.numel()} rows: "
            "equal to plain")
        times[name] = time_kernel(
            f"row gather, {name}", lambda: row_gather(table, idx),
            lambda: row_gather_plain(table, idx), gather_work(table, idx),
            library=lambda: torch.index_select(table, 0, idx.flatten()))
    flat = states.reshape(-1)
    sub = rows["lane-packed"].view(-1, LANE_GROUP, LANE_WIDTH)[
        torch.arange(flat.numel(), device=flat.device), (flat % LANE_GROUP).long(), :width]
    if not torch.equal(sub, rows["em_block"].view(-1, width)):
        raise AssertionError("lane-packed group rows do not hold the em_block rows")
    floor = launch_floor(em_block.device)
    log(f"launch floor: an empty kernel takes {floor:.4f} ms per launch, queued back to back")
    times["em_block"]["launch_floor_ms"] = floor
    return max_err, times["em_block"], times["lane-packed"]


def same_sweep(ref, got, what):
    """Raise unless K4's result equals the plain sweep's in every count,
    flag and survivor row; returns the largest row difference."""
    import torch

    for name in ("tok_count", "em_count", "eps_count", "overflow"):
        if not torch.equal(getattr(ref, name), getattr(got, name)):
            raise AssertionError(f"{what} differs from plain: {name}")
    max_err = 0
    for b in range(ref.tok_count.shape[0]):
        for rows, count in (("tok_rows", "tok_count"), ("em_rows", "em_count"),
                            ("eps_rows", "eps_count")):
            n = int(getattr(ref, count)[b])
            r, g = getattr(ref, rows)[b, :n], getattr(got, rows)[b, :n]
            if not torch.equal(r, g):
                raise AssertionError(f"{what} differs from plain: {rows}[{b}]")
            if n:
                max_err = max(max_err, int((r.long() - g.long()).abs().max()))
    return max_err


def hold_k4(dec, scores_tm, lengths, what):
    """K4 against the plain sweep on ``dec``'s first chunk of ``scores_tm``
    (T, B, V), every count, flag and survivor row.  Returns the largest
    row difference, the call's arguments, and the plain and kernel
    results."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    S = dec._dev_graph.num_states
    st0, _, _, _ = dec._init(scores_tm.shape[1])
    rem = torch.from_numpy(lengths).to(dec.device)
    _, o = lattice_chunk(dec._pg, scores_tm[:CHUNK], rem, st0, dec.cfg, S)
    args = (o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem,
            sweep_config(dec.cfg, CHUNK), S)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    return same_sweep(ref, got, what), args, ref, got


def check_k4(dec, scores_tm, lengths):
    """K4 against the plain sweep on the first real chunk."""
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_plain
    from kaldi_decoder_tpu_torch.kernels._build import kernels
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    max_err, args, ref, got = hold_k4(dec, scores_tm, lengths, "K4")
    sc = args[5]
    C = kernels().kd_sweep_cluster(B, -(-sc.frontier_size // 4) * 4, sc.em_records)
    log(f"K4 sweep: equal to plain on chunk 0 (T={CHUNK}, B={B}; survivors tok "
        f"{ref.tok_count.sum().item()}, em {ref.em_count.sum().item()}; clusters of {C} "
        "blocks):")
    t = time_kernel("K4, one chunk", lambda: sweep_chunk(*args), lambda: sweep_plain(*args),
                    k4_work(*args[:5], got), reps=2)
    del ref, got
    return float(max_err), t


def check_emit_kernels(st, scores_t, pg, cfg, S, where):
    """K1 with its source slots, then K6 on K1's candidates, each held
    against its plain version on one real frame's frontier.  Returns the
    two errors, the two calls' arguments, K1's lanes and the plain
    selection."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    cut = get_cutoff(st.costs, cfg.beam, cfg.max_active, cfg.min_active,
                     cfg.beam_delta, costs_sorted=True)
    k1_args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_t, pg, cfg)
    ref = expand_filter_plain(*k1_args, with_src_slot=True)
    ex = expand_filter(*k1_args, with_src_slot=True)
    torch.cuda.synchronize()
    k1_err = same_expansion(ref, ex, where)
    check_unread_states(ref, k1_args, S, where, with_src_slot=True)
    em_args = (ex.dst, ex.cost, cfg.frontier_size, S)
    sel = dedup_select_plain(*em_args)
    got = dedup_select(*em_args)
    torch.cuda.synchronize()
    k6_err = same_selection(sel, got, f"the candidates of {where}")
    return k1_err, k6_err, k1_args, em_args, ex, sel


def check_eps_kernel(mid, next_cutoff, pg, cfg, S, where, timed=False):
    """K5, then K6 on its lanes (incumbents first), then K6 with the eps
    step as its last step, each held against its plain version on one eps
    iteration after a frame's emitting stage (``timed``: K5 and the fused
    call timed there).
    Returns K6's error, its arguments, the slots won by eps lanes and K5's
    and the eps step's time_kernel fields (None untimed)."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    lanes, k5 = hold_k5(mid, next_cutoff, pg, cfg, False, where, timed)
    eps_args = (lanes.dst, lanes.cost, cfg.frontier_size, S)
    ref = dedup_select_plain(*eps_args)
    got = dedup_select(*eps_args)
    torch.cuda.synchronize()
    err = same_selection(ref, got, f"the eps candidates of {where}")
    step = hold_eps_step(lanes, eps_args, cfg.eps_iters, cfg.eps_exact, where, timed)
    return err, eps_args, int((got.cand_idx >= cfg.frontier_size).sum()), k5, step


def viterbi_k6_calls(vdec, edec, scores_tm):
    """K1 with its source slots, and K6, held against their plain versions
    on the emitting candidates of real frames of the batched Viterbi
    decode, and K6 on one eps iteration's candidates (incumbents first) of
    the unfolded graph's decode.  Returns the errors, K1's and K6's
    arguments on the last checked frame, the eps call's and what the log
    reports of them."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.frontier import frame_emit_stage, frame_step_batched

    fc, S = vdec.cfg, vdec._dev_graph.num_states
    active = torch.ones(B, dtype=torch.bool, device=vdec.device)
    st, _ = vdec._init(B)
    k1_err = k6_err = 0.0
    uniq = []
    for t in range(max(K6_FRAMES) + 1):
        if t in K6_FRAMES:
            e1, e6, k1_args, em_args, ex, sel = check_emit_kernels(
                st, scores_tm[t], vdec._pg, fc, S, f"Viterbi frame {t}")
            k1_err, k6_err = max(k1_err, e1), max(k6_err, e6)
            uniq.append(int(sel.num_unique.max()))
        st, _ = frame_step_batched(st, scores_tm[t], active, vdec._pg, fc, S)

    ec, Se = edec.cfg, edec._dev_graph.num_states
    st, _ = edec._init(B)
    for t in range(EPS_FRAME):
        st, _ = frame_step_batched(st, scores_tm[t], active, edec._pg, ec, Se)
    mid, _, next_cutoff, _, _, _ = frame_emit_stage(st, scores_tm[EPS_FRAME], edec._pg, ec, Se)
    err, eps_args, won, _, _ = check_eps_kernel(mid, next_cutoff, edec._pg, ec, Se,
                                                f"frame {EPS_FRAME}")
    return dict(k1_err=k1_err, k6_err=max(k6_err, err), k1_args=k1_args, em_args=em_args,
                eps_args=eps_args, uniq=uniq, won=won, eps_iters=ec.eps_iters)


def check_k6(vdec, edec, scores_tm):
    """:func:`viterbi_k6_calls`, then K1 with its source slots and the two
    K6 calls timed."""
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain

    c = viterbi_k6_calls(vdec, edec, scores_tm)
    k1_args, em_args, eps_args = c["k1_args"], c["em_args"], c["eps_args"]
    log(f"K1 with src_slot: equal to plain on Viterbi frames {list(K6_FRAMES)}; "
        f"timed on frame {max(K6_FRAMES)}:")
    k1 = time_kernel("K1 (row gather folded in) with src_slot",
                     lambda: expand_filter(*k1_args, with_src_slot=True),
                     lambda: expand_filter_plain(*k1_args, with_src_slot=True),
                     k1_work(*k1_args, with_src_slot=True))
    log(f"K6 dedup_select, emitting candidates (B={B}, N={em_args[1].shape[1]}, "
        f"K={em_args[2]}; most distinct states per frame {c['uniq']}): equal to plain; "
        f"timed on frame {max(K6_FRAMES)}:")
    k6 = time_k6("K6, emitting candidates", em_args)
    log(f"K6 dedup_select, eps iteration of the unfolded graph (B={B}, "
        f"N={eps_args[1].shape[1]}, K={eps_args[2]}, eps_iters={c['eps_iters']}, "
        f"{c['won']} slots won by eps lanes): equal to plain; timed on frame {EPS_FRAME}:")
    eps = time_k6("K6, eps candidates", eps_args)
    return dict(k1_err=c["k1_err"], k6_err=c["k6_err"], k1=k1, k6=k6, eps=eps)


def streaming_k6_calls(fd, scores_tm):
    """The row gather, K1 with its source slots and K6 held against their
    plain versions at the shapes of the streaming decoder that phase 5
    drives (B=1, its own K and budgets, the unfolded graph): the decoder's
    own frames of utterance 0 up to ``STREAM_FRAME``, then that frame's
    em_block rows, emitting candidates and first eps iteration (K5, K6,
    the eps step, K5 and the eps step timed), and the first iteration of
    the decoder's start closure.  Returns the errors, the calls' arguments,
    the frontier's states and K5's and the eps step's timings."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.frontier import (
        StepState,
        frame_step_batched,
        start_state,
    )
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain

    cfg, pg, S = fd._cfg, fd._pg, fd._graph.num_states
    fd.init_decoding()
    st = fd._state
    scores_u = scores_tm[:, :1]
    active = torch.ones(1, dtype=torch.bool, device=st.states.device)
    for t in range(STREAM_FRAME):
        st, _ = frame_step_batched(st, scores_u[t], active, pg, cfg, S)
    got, want = row_gather(pg.em_block, st.states), row_gather_plain(pg.em_block, st.states)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"row gather differs from plain on streaming frame {STREAM_FRAME}")
    where = f"streaming frame {STREAM_FRAME}"
    k1_err, k6_err, k1_args, em_args, ex, sel = check_emit_kernels(
        st, scores_u[STREAM_FRAME], pg, cfg, S, where)
    mid = StepState(sel.states, sel.costs, st.base)
    eps_err, eps_args, won, k5, step = check_eps_kernel(mid, ex.next_cutoff, pg, cfg, S, where,
                                                        timed=True)
    # InitDecoding's closure: the start token alone, cutoff +inf.
    st0 = start_state(fd._graph.start_state, cfg, st.states.device)
    inf = torch.full((1,), float("inf"), dtype=torch.float32, device=st.states.device)
    init_err, _, _, k5_init, step_init = check_eps_kernel(
        st0, inf, pg, cfg, S, "the streaming decoder's start closure (cutoff +inf)", timed=True)
    return dict(k1_err=k1_err, k6_err=max(k6_err, eps_err, init_err), k1_args=k1_args,
                em_args=em_args, eps_args=eps_args, won=won, states=st.states, where=where,
                k5=k5, eps_step=step, k5_init=k5_init, eps_step_init=step_init)


def check_streaming_kernels(fd, scores_tm):
    """:func:`streaming_k6_calls`, then each kernel timed at those shapes."""
    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    c = streaming_k6_calls(fd, scores_tm)
    cfg, pg, states = fd._cfg, fd._pg, c["states"]
    k1_args, em_args, eps_args = c["k1_args"], c["em_args"], c["eps_args"]
    times = dict(
        gather=(cuda_ms(lambda: row_gather(pg.em_block, states)),
                cuda_ms(lambda: row_gather_plain(pg.em_block, states))),
        k1=(cuda_ms(lambda: expand_filter(*k1_args, with_src_slot=True)),
            cuda_ms(lambda: expand_filter_plain(*k1_args, with_src_slot=True))),
        k6=(cuda_ms(lambda: dedup_select(*em_args)),
            cuda_ms(lambda: dedup_select_plain(*em_args))),
        k6_eps=(cuda_ms(lambda: dedup_select(*eps_args)),
                cuda_ms(lambda: dedup_select_plain(*eps_args))),
    )
    log(f"streaming shapes (B=1, K={cfg.frontier_size}, rem_budget={cfg.rem_budget}, "
        f"eps N={eps_args[1].shape[1]}, {c['won']} slots won by eps lanes) on {c['where']}: "
        f"row gather, K1 with src_slot and K6 (emitting N={em_args[1].shape[1]}, eps) "
        f"equal to plain; kernel/plain ms: "
        + ", ".join(f"{k} {a:.4f}/{p:.4f}" for k, (a, p) in times.items()))
    log(f"  K1 at B=1: clusters of {k1_clusters(cfg, 1)} blocks")
    k1_dev = time_kernel("K1 (row gather folded in) with src_slot, streaming",
                         lambda: expand_filter(*k1_args, with_src_slot=True),
                         lambda: expand_filter_plain(*k1_args, with_src_slot=True),
                         k1_work(*k1_args, with_src_slot=True))
    k6 = time_k6("K6, emitting candidates, streaming", em_args)
    k6_eps = time_k6("K6, eps candidates, streaming", eps_args)
    return dict(k1_err=c["k1_err"], k6_err=c["k6_err"], times=times, k1=k1_dev, k6=k6,
                k6_eps=k6_eps, k5=c["k5"], eps_step=c["eps_step"], k5_init=c["k5_init"],
                eps_step_init=c["eps_step_init"])


def streaming_lattice_decoder(graph, lref):
    """The streaming lattice decoder of phase 7, with the reference's config."""
    from kaldi_decoder_tpu_torch import LatticeFasterDecoder, LatticeFasterDecoderConfig

    return LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(**lref["faster"]["config"]),
                                device="cuda")


def check_streaming_k2(ld, scores_tm):
    """K2's emitting and eps calls held against their plain versions at
    the shapes of the streaming lattice decoder that phase 7 drives (B=1,
    K 2048, em_records 4096, eps_records 1280, the unfolded graph): the
    decoder's own frames of utterance 0 up to ``STREAM_FRAME``, then that
    frame's emitting lanes (K1's) and its first eps iteration's
    (incumbents first, K5's), each timed; and K5 and the eps step of that
    iteration held against plain and timed.  Returns the largest error and
    the calls' timings."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
        lattice_emit_stage,
        lattice_frame_step_batched,
    )
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        cluster_size,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    cfg, pg, S = ld._dev_cfg, ld._pg, ld._graph.num_states
    fc, K = cfg.frontier, cfg.frontier.frontier_size
    sb = cfg.lattice_beam + 1e-4
    ld.init_decoding()
    st = ld._state
    scores_u = scores_tm[:, :1]
    active = torch.ones(1, dtype=torch.bool, device=st.states.device)
    for t in range(STREAM_FRAME):
        st, _ = lattice_frame_step_batched(st, scores_u[t], active, pg, cfg, S)
    cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    ex = expand_filter(st.states, st.costs, cut.cutoff, cut.adaptive_beam,
                       scores_u[STREAM_FRAME], pg, fc)
    em_args = (ex.dst, ex.cost, K, S, cfg.em_records, sb, (ex.src_state, ex.arc_id))
    mid, _, next_cutoff, _, _, _ = lattice_emit_stage(st, scores_u[STREAM_FRAME], pg, fc, S,
                                                      cfg.em_records, sb)
    where = f"streaming lattice frame {STREAM_FRAME}"
    lanes, k5 = hold_k5(mid, next_cutoff, pg, fc, True, where, timed=True)
    cc = lanes.cost
    eps_args = (lanes.dst, cc, K, S, K + cfg.eps_records, sb, (lanes.src_state, lanes.arc_id))
    err = 0.0
    for args, inc, what in ((em_args, 0, "the emitting lanes"), (eps_args, K, "the eps lanes")):
        ref = dedup_select_rec_plain(*args, num_incumbents=inc)
        got = dedup_select_rec(*args, num_incumbents=inc)
        torch.cuda.synchronize()
        err = max(err, same_records(ref, got, f"{what} of {where}"))
    step = hold_eps_step(lanes, eps_args, fc.eps_iters, fc.eps_exact, where, timed=True)
    log(f"K2 at the streaming lattice decoder's shapes (B=1, K={K}, em_records="
        f"{cfg.em_records}, eps_records={cfg.eps_records}; emitting N={ex.cost.shape[1]}, "
        f"eps N={cc.shape[1]}; clusters of {cluster_size(1, ex.cost.shape[1])} and "
        f"{cluster_size(1, cc.shape[1], incumbents=True)} blocks): equal to plain on {where}; "
        f"timed there:")
    timed = {}
    for key, args, inc in (("em", em_args, 0), ("eps", eps_args, K)):
        timed[key] = time_kernel(
            f"K2, {'emitting' if key == 'em' else 'eps'} call, streaming",
            lambda: dedup_select_rec(*args, num_incumbents=inc),
            lambda: stack_records(dedup_select_rec_plain(*args, num_incumbents=inc)),
            k2_work(*args, num_incumbents=inc))
    timed["k5"], timed["eps_step"] = k5, step
    return err, timed


def check_utterance(what, b, u, lat, num_active, best_costs, overflows, saturations):
    """Raise unless one utterance's 1-best result equals its JAX reference."""
    import hashlib

    import numpy as np

    from kaldi_decoder_tpu_torch.fst.ops import path_labels, path_total_cost

    L = u["length"]
    if lat is None:
        raise AssertionError(f"{what}, utterance {b}: no best path")
    if path_labels(lat) != u["olabels"]:
        raise AssertionError(f"{what}, utterance {b}: 1-best differs from the JAX reference")
    cost_bits = int(np.float32(path_total_cost(lat)).view(np.int32))
    if cost_bits != u["path_cost_f32_bits"]:
        raise AssertionError(f"{what}, utterance {b}: best path cost differs")
    if [int(x) for x in num_active[:L]] != u["num_active"]:
        bad = int(np.flatnonzero(num_active[:L] != np.asarray(u["num_active"]))[0])
        raise AssertionError(f"{what}, utterance {b}: num_active differs first at frame {bad}")
    digest = hashlib.sha256(np.ascontiguousarray(best_costs[:L], np.float32).tobytes())
    if digest.hexdigest() != u["best_costs_sha256"]:
        raise AssertionError(f"{what}, utterance {b}: per-frame best costs differ")
    for key, arr in (("overflow_frames", overflows), ("saturated_frames", saturations)):
        if int(arr[:L].sum()) != u[key]:
            raise AssertionError(f"{what}, utterance {b}: {key} {int(arr[:L].sum())} != {u[key]}")


def reset_counts():
    """Every kernel wrapper's launch count, and the frame driver's replay
    count, set to 0."""
    import torch

    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.kernels.cutoff import global_cutoff_local, global_cutoff_merge
    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
    from kaldi_decoder_tpu_torch.kernels.eps import eps_dedup, eps_step_shard, expand_eps_lanes
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
    from kaldi_decoder_tpu_torch.kernels.frame import frame_start, frame_tail
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather
    from kaldi_decoder_tpu_torch.kernels.route import route_recv, route_send
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    torch.cuda.synchronize()
    for fn in (row_gather, expand_filter, dedup_select_rec, sweep_chunk, expand_eps_lanes,
               dedup_select, eps_dedup, eps_step_shard, frame_tail, frame_start, route_send,
               route_recv, global_cutoff_local, global_cutoff_merge):
        fn.launches = 0
    driver.replays = 0


def read_counts():
    """The launch counts since :func:`reset_counts`: K3's frame tail (and
    its shard mode) as ``k3``, its first-frame mode as ``k3_start``, K5 as
    ``k5``, the standalone eps step (its shard mode, the only one left) as
    ``eps_step``, the eps steps run as the last step of an eps dedup call
    (each also a K6 or K2 launch) as ``eps_dedup``, K7's send and receive
    sides as ``k7_send`` and ``k7_recv``, K8's local half and merge as
    ``k8_local`` and ``k8_merge``."""
    from kaldi_decoder_tpu_torch.kernels.cutoff import global_cutoff_local, global_cutoff_merge
    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
    from kaldi_decoder_tpu_torch.kernels.eps import eps_dedup, eps_step_shard, expand_eps_lanes
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
    from kaldi_decoder_tpu_torch.kernels.frame import frame_start, frame_tail
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather
    from kaldi_decoder_tpu_torch.kernels.route import route_recv, route_send
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    return dict(gather=row_gather.launches, k1=expand_filter.launches,
                k2=dedup_select_rec.launches, k4=sweep_chunk.launches,
                k5=expand_eps_lanes.launches, k6=dedup_select.launches,
                eps_step=eps_step_shard.launches, eps_dedup=eps_dedup.launches,
                k3=frame_tail.launches,
                k3_start=frame_start.launches, k7_send=route_send.launches,
                k7_recv=route_recv.launches, k8_local=global_cutoff_local.launches,
                k8_merge=global_cutoff_merge.launches)


def launch_counts(**want):
    """A dict of launch counts as :func:`read_counts` gives them: ``want``,
    the eps steps inside a dedup call, K7's sides and K8's halves 0 unless
    given."""
    return dict(dict(eps_dedup=0, k7_send=0, k7_recv=0, k8_local=0, k8_merge=0), **want)


def read_replays(what, frames):
    """The frames the frame driver replayed from its captured graph since
    :func:`reset_counts`; raises unless some were, and every frame but a
    driver's first (run before its capture) was."""
    from kaldi_decoder_tpu_torch.decoders import driver

    n = driver.replays
    if not 0 < n <= frames:
        raise AssertionError(f"{what}: {n} replays for {frames} frames")
    return n


def k3_work(tin, fa, width):
    """Bytes and operations of one K3 frame tail: of a row still decoding,
    its frontier (states and costs) and records or backpointer inputs
    read (on the 1-best path the winning lanes' source slots and arcs
    once each) and its carried state written; of a frozen row, the
    carried state read; of every row, its rows of the stacked outputs
    written, the next scores row read and written and some 48 bytes of
    per-row scalars; a subtract and a compare a slot."""
    B, K = tin.mid_states.shape
    act = int(fa.sum())
    row = K * 8  # a frontier row: states and costs
    if tin.em_records is not None:
        recs = (tin.em_records[0].numel() + tin.eps_records[0].numel()) * 4
        nbytes = act * (row + recs + row) + (B - act) * row + B * (row + recs)
    else:
        eps = tin.bp_eps[0].numel() * 4
        won = int((tin.cand_idx[fa] >= 0).sum())
        nbytes = (act * (row + K * 4 + eps + row) + won * 8 + (B - act) * row
                  + B * (K * 8 + eps))
    return nbytes + B * (2 * width * 4 + 48), 2 * B * K


def check_k3(what, lattice, pg, cfg, num_states, scores_tm, lengths, st0, frame):
    """K3 on a chunk of a path's own driver (its frames before ``frame``
    run by the frame driver's frame, launched from the host): the first-frame
    mode against ``get_cutoff`` and frame ``frame``'s tail against
    ``frame_tail_plain``, bitwise in every field (the state written in
    place, row ``frame`` of every stacked output, the next frame's K1
    inputs, ``t``); then timed on that frame's inputs, on a chunk of its
    own whose rows the timed calls fill.  Returns the kernels line's
    fields."""
    import torch

    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.decoders.frontier import StepState
    from kaldi_decoder_tpu_torch.kernels.frame import cluster_size, frame_tail, frame_tail_plain
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

    def same(ref, got):
        if ref.dtype == torch.float32:
            ref, got = ref.view(torch.int32), got.view(torch.int32)
        return torch.equal(ref, got)

    C, Bn, Vn = scores_tm.shape
    drv = driver.driver_for(lattice, pg, cfg, num_states, Bn, Vn, scores_tm.device)
    fc, s = drv.fc, drv.slots
    io = drv.begin(scores_tm, lengths, st0)
    cut = get_cutoff(st0.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    torch.cuda.synchronize()
    if not (same(cut.cutoff, s.cutoff) and same(cut.adaptive_beam, s.adaptive_beam)
            and same(io.scores[0], s.scores_t) and same(lengths > 0, s.active)
            and all(same(a, b) for a, b in zip(st0, s.state))):
        raise AssertionError(f"K3's first-frame mode differs from plain on {what}")
    for _ in range(frame):
        drv.frame()
    tin = drv.body()
    st = StepState(*(x.clone() for x in s.state))
    cut_t, fa = s.cutoff.clone(), lengths > frame
    final, out, nxt = frame_tail_plain(st, cut_t, tin, fa, fc)
    # The kernel's choice, then each cluster size, on the same slots.
    kept = (*s.state, s.cutoff, s.adaptive_beam, s.active, s.scores_t, s.args)
    snap = [x.clone() for x in kept]
    for clusters in (0, *CLUSTER_SIZES):
        for x, y in zip(kept, snap):
            x.copy_(y)
        frame_tail(s, tin, fc, clusters=clusters)
        torch.cuda.synchronize()
        fields = dict(zip(("states", "costs", "base"), zip(final, s.state)),
                      **{f: (r, getattr(io.outs, f)[frame]) for f, r in zip(out._fields, out)},
                      next_cutoff=(nxt.cutoff, s.cutoff),
                      next_adaptive_beam=(nxt.adaptive_beam, s.adaptive_beam),
                      next_scores=(io.scores[frame + 1], s.scores_t),
                      next_active=(lengths > frame + 1, s.active))
        for name, (r, g) in fields.items():
            if not same(r, g):
                raise AssertionError(f"K3 at {clusters or 'its own'} blocks a row differs from "
                                     f"plain on {what}, frame {frame}: {name}")
        if s.args[0].item() != frame + 1 or s.args[2].item() != 0:
            raise AssertionError(f"K3 on {what}: t {s.args[0].item()}, done "
                                 f"{s.args[2].item()} after frame {frame}")
    chosen = cluster_size(Bn, fc.frontier_size)
    log(f"K3 frame tail on {what} (B={Bn}, K={fc.frontier_size}, "
        f"{'records ' + str(tuple(tin.em_records.shape[1:])) if lattice else 'backpointers'}, "
        f"eps_iters {fc.eps_iters}; clusters of {chosen} blocks a row): the first-frame mode "
        f"and frame {frame} equal to plain at its own and every cluster size, "
        f"{int((~fa).sum())} of {Bn} rows frozen; timed on frame {frame}:")
    # The timed calls fill the rows of a chunk of their own from the same
    # state, begun again for each cluster size.
    n = 2 * TIMING_REPS + 8

    def begin():
        drv.begin(scores_tm[frame:frame + n].contiguous(), (lengths - frame).clamp(min=0), st)
    begin()
    t = time_kernel(f"K3 ({what})", lambda: frame_tail(s, tin, fc),
                    lambda: frame_tail_plain(st, cut_t, tin, fa, fc), k3_work(tin, fa, Vn))
    t["clusters"] = chosen
    t["ms_by_clusters"] = {}
    for c in CLUSTER_SIZES:
        begin()
        t["ms_by_clusters"][c] = device_ms(lambda: frame_tail(s, tin, fc, clusters=c))
    t["share_by_clusters"] = {c: t["bound_ms"] / ms for c, ms in t["ms_by_clusters"].items()}
    log("  K3 at each cluster size: device ms (share of the bound) " + ", ".join(
        f"{c}: {ms:.4f} ({t['share_by_clusters'][c]:.1%})"
        for c, ms in t["ms_by_clusters"].items()))
    s.io = None
    return t


def graph_pool(lattice, pg, cfg, num_states, batch):
    """(allocated, reserved) bytes that the capture of the frame driver of
    these arguments kept: its graph's private memory pool."""
    from kaldi_decoder_tpu_torch.decoders import driver

    return driver.driver_for(lattice, pg, cfg, num_states, batch, V, "cuda:0").pool_bytes


def stream_run(dec, logp):
    """A streaming decode of ``logp`` as phases 5 and 7 call it:
    ``init_decoding``, then ``advance_decoding`` of FRAMES_PER_CALL frames
    until every frame is decoded."""
    from kaldi_decoder_tpu_torch import DecodableCtc

    def run():
        dec.init_decoding()
        decodable = DecodableCtc(logp)
        while dec.num_frames_decoded() < len(logp):
            dec.advance_decoding(decodable, max_num_frames=FRAMES_PER_CALL)
    return run


def eager_decode_s(run):
    """Seconds of one ``run`` as the loop before the frame driver ran it."""
    from kaldi_decoder_tpu_torch.decoders import driver

    with driver.eager_frames():
        t0 = time.perf_counter()
        run()
        return time.perf_counter() - t0


def loop_walls(what, run, frames):
    """A path's ``run`` (a chunk or a decode as the phase calls it, of
    ``frames`` frames) replayed from the frame driver's captured graph and
    as the loop before the frame driver ran it (``driver.eager_frames``), in
    turns (graph, loop, loop, graph): wall ms a frame (the card
    synchronised around a run; both runs of a mode), device ms and
    activities a frame (one profiled run of each mode) and the busy share
    (device over the unprofiled wall, the mean of the two).  Logs them;
    returns {"graph": ..., "loop": ...}."""
    import contextlib

    import torch

    from kaldi_decoder_tpu_torch.decoders import driver

    walls = {"graph": [], "loop": []}
    replays = 0
    for mode in ("graph", "loop", "loop", "graph"):
        with driver.eager_frames() if mode == "loop" else contextlib.nullcontext():
            torch.cuda.synchronize()
            r0 = driver.replays
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[mode].append((time.perf_counter() - t0) * 1e3 / frames)
            replays += driver.replays - r0 if mode == "graph" else 0
    out = {}
    for mode in ("graph", "loop"):
        with driver.eager_frames() if mode == "loop" else contextlib.nullcontext():
            kern, copies, by_name, _ = profiled_device_ms(run, top=None)
        dev, acts = kern + copies, sum(n for _, _, n in by_name)
        wall = statistics.mean(walls[mode])
        out[mode] = dict(wall_ms=walls[mode], device_ms=dev / frames, activities=acts / frames,
                         busy=dev / frames / wall if acts else None)
    if replays == 0:
        raise AssertionError(f"{what}: no frame replayed from the captured graph")
    out["graph"]["replays"] = replays // 2

    def fmt(m):
        busy = "not measured (no device activity in the trace)" if out[m]["busy"] is None \
            else f"{out[m]['busy']:.3f}"
        return (f"wall {', '.join(f'{w:.4f}' for w in out[m]['wall_ms'])} ms a frame, device "
                f"{out[m]['device_ms']:.4f} ms and {out[m]['activities']:.1f} activities a "
                f"frame, busy {busy}")
    log(f"  {what}, {frames} frames: graph ({out['graph']['replays']} replays a run): "
        f"{fmt('graph')}; the loop before the frame driver: {fmt('loop')}")
    return out


def viterbi_path(vdec, scores, lengths, refs, vref):
    """Phase 4: the batched 1-best decode as a user calls it, counted,
    then checked against the JAX reference."""
    from kaldi_decoder_tpu_torch.fst.ops import path_labels
    from kaldi_decoder_tpu_torch.utils.wer import wer

    want = vref["viterbi"]["device_config"]
    got_cfg = {f: getattr(vdec.cfg, f) for f in want}
    if got_cfg != want:
        raise AssertionError(f"Viterbi device config {got_cfg} != the reference's {want}")
    reset_counts()
    t0 = time.perf_counter()
    res = vdec.decode(scores, lengths)
    t_dec = time.perf_counter() - t0
    n = read_counts()
    frames = res.bp_emit.shape[0]
    D = vdec.cfg.eps_iters
    if (n["gather"] != 0 or n["k1"] != frames or n["k2"] != 0
            or n["k6"] != frames * (1 + D) or n["k5"] != frames * D
            or n["eps_step"] != 0 or n["eps_dedup"] != frames * D or n["k3"] != frames
            or n["k3_start"] != 1):
        raise AssertionError(f"launch counts {n} for {frames} frames")
    replays = read_replays("Viterbi path", frames)
    t1 = time.perf_counter()
    lats = [res.best_path(b) for b in range(B)]
    t_host = time.perf_counter() - t1
    utts = vref["viterbi"]["utts"][:B]
    for b, u in enumerate(utts):
        check_utterance("Viterbi", b, u, lats[b], res.num_active[:, b], res.best_costs[:, b],
                        res.overflows[:, b], res.saturations[:, b])
    checked = len(utts)
    st = wer(refs, [path_labels(lat) if lat is not None else [] for lat in lats])
    audio_s = float(lengths.sum()) * 0.04
    log(f"Viterbi path: decode {t_dec:.3f} s ({frames} frames, bp_emit download included; "
        f"{audio_s / t_dec:.1f} audio-s/s), host 1-best (backtrace, fold expansion, "
        f"RemoveEpsLocal) {t_host:.3f} s; row gather launches {n['gather']}, K1 {n['k1']}, "
        f"K6 {n['k6']}, K3 {n['k3']} (first-frame mode {n['k3_start']}), {replays} frames "
        f"replayed from the captured graph; matches the JAX reference on {checked} "
        f"utterances; overflow frames {int(res.overflows.sum())}, saturated frames {int(res.saturations.sum())}; {st}")
    return n, t_dec, t_host


def streaming_decoder(graph, vref, device="cuda"):
    """The streaming decoder of phase 5, with the reference's options."""
    from kaldi_decoder_tpu_torch import FasterDecoder, FasterDecoderOptions

    return FasterDecoder(graph, FasterDecoderOptions(**vref["streaming"]["options"]),
                         device=device)


def streaming_path(fd, scores, vref):
    """Phase 5: the streaming API on the unfolded graph, counted, then
    checked against the JAX reference."""
    import numpy as np

    from kaldi_decoder_tpu_torch import DecodableCtc

    sref = vref["streaming"]
    want = sref["device_config"]
    got_cfg = {f: getattr(fd._cfg, f) for f in want}
    if got_cfg != want:
        raise AssertionError(f"streaming config {got_cfg} != the reference's {want}")
    D = fd._cfg.eps_iters
    reset_counts()
    t_dec = t_host = 0.0
    frames = calls = 0
    for b, u in enumerate(sref["utts"]):
        L = u["length"]
        calls += -(-L // FRAMES_PER_CALL)
        t0 = time.perf_counter()
        fd.init_decoding()
        decodable = DecodableCtc(scores[b, :L])
        while fd.num_frames_decoded() < L:
            fd.advance_decoding(decodable, max_num_frames=FRAMES_PER_CALL)
        t1 = time.perf_counter()
        ok, lat = fd.get_best_path()
        t_host += time.perf_counter() - t1
        t_dec += t1 - t0
        frames += L
        r = fd._result()
        if not ok:
            raise AssertionError(f"streaming, utterance {b}: get_best_path failed")
        check_utterance("streaming", b, u, lat, r.num_active[:, 0], r.best_costs[:, 0],
                        r.overflows[:, 0], r.saturations[:, 0])
        if not np.array_equal(r.lengths, [L]):
            raise AssertionError("streaming result lengths")
    n = read_counts()
    utts = len(sref["utts"])
    want_k6 = frames * (1 + D) + utts * D
    # As many eps steps as K5 launches (each frame's and each start
    # closure's), each the last step of a K6 launch: none alone.
    want_k5 = frames * D + utts * D
    if (n["gather"] != 0 or n["k1"] != frames or n["k2"] != 0 or n["k6"] != want_k6
            or n["k5"] != want_k5 or n["eps_step"] != 0 or n["eps_dedup"] != want_k5
            or n["k3"] != frames or n["k3_start"] != calls):
        raise AssertionError(f"launch counts {n}: want no gather and no standalone eps step, "
                             f"{frames} K1 and K3, {want_k6} K6, {want_k5} K5 and eps steps "
                             f"inside K6, {calls} K3 first frames")
    replays = read_replays("streaming path", frames)
    log(f"streaming path: FasterDecoder, {utts} utterances, {frames} frames, "
        f"{FRAMES_PER_CALL} per advance_decoding, eps_iters={D}, K={fd._cfg.frontier_size}: "
        f"{1000 * t_dec / frames:.3f} ms per frame (init + advance, downloads included), "
        f"get_best_path {t_host:.3f} s; row gather launches {n['gather']}, K1 {n['k1']}, "
        f"K6 {n['k6']}, K5 {n['k5']}, eps steps {n['eps_dedup']} inside K6 and "
        f"{n['eps_step']} alone, K3 {n['k3']} (first-frame "
        f"mode {n['k3_start']}), {replays} frames replayed from the captured graph; matches "
        "the JAX reference")
    return n, 1000 * t_dec / frames


def unfolded_lattice_decoder(graph, device="cuda"):
    """The lattice decoder of phase 6: the bench's lattice config on the
    unfolded graph (``fold=False``), so that the device runs the eps path."""
    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph

    return BatchedLatticeDecoder(graph, config_for_graph(graph, **BENCH_CONFIG), fold=False,
                                 device=device, **DECODER_KW)


def check_k2_eps(udec, scores_tm):
    """K2's eps call (the K incumbents first) against its plain version on
    the eps iteration of the unfolded lattice decode at each of
    ``K2_EPS_FRAMES``, then timed there; K5, whose lanes it takes, and the
    eps call with the eps step as its last step, held against their plain
    versions and timed on the
    same iterations.  Returns the largest cost difference, K2's timings by
    frame and K5's and the eps step's by frame."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
        lattice_emit_stage,
        lattice_frame_step_batched,
    )
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        cluster_size,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    cfg, fc, S = udec.cfg, udec.cfg.frontier, udec._dev_graph.num_states
    K = fc.frontier_size
    sb = cfg.lattice_beam + 1e-4
    st, _, _, _ = udec._init(B)
    active = torch.ones(B, dtype=torch.bool, device=udec.device)
    calls, max_err, won, eps_kernels = [], 0.0, [], {}
    for t in range(max(K2_EPS_FRAMES) + 1):
        if t in K2_EPS_FRAMES:
            mid, _, next_cutoff, _, _, _ = lattice_emit_stage(
                st, scores_tm[t], udec._pg, fc, S, cfg.em_records, sb)
            where = f"unfolded lattice frame {t}"
            lanes, k5 = hold_k5(mid, next_cutoff, udec._pg, fc, True, where, timed=True)
            args = (lanes.dst, lanes.cost, K, S, K + cfg.eps_records, sb,
                    (lanes.src_state, lanes.arc_id))
            ref = dedup_select_rec_plain(*args, num_incumbents=K)
            got = dedup_select_rec(*args, num_incumbents=K)
            torch.cuda.synchronize()
            max_err = max(max_err, same_records(ref, got, f"the eps lanes of unfolded frame {t}"))
            step = hold_eps_step(lanes, args, fc.eps_iters, fc.eps_exact, where, timed=True)
            eps_kernels[t] = dict(k5=k5, eps_step=step)
            won.append(int((ref.cand_idx >= K).sum()))
            calls.append((t, args))
        st, _ = lattice_frame_step_batched(st, scores_tm[t], active, udec._pg, cfg, S)
    N = calls[0][1][1].shape[1]
    log(f"K2 dedup_select_rec, eps call (B={B}, N={N}, K={K}, R={K + cfg.eps_records}, "
        f"{K} incumbents; slots won by eps lanes {won}; clusters of "
        f"{cluster_size(B, N, incumbents=True)} blocks): equal to plain on unfolded "
        f"frames {list(K2_EPS_FRAMES)}; timed there:")
    timed = {}
    for t, args in calls:
        log(f" unfolded frame {t}:")
        timed[t] = time_kernel(
            "K2, eps call", lambda: dedup_select_rec(*args, num_incumbents=K),
            lambda: stack_records(dedup_select_rec_plain(*args, num_incumbents=K)),
            k2_work(*args, num_incumbents=K))
    return max_err, timed, eps_kernels


def check_k4_eps(udec, scores_tm, lengths):
    """K4 with eps records against the plain sweep on the first 500-frame
    chunk of the unfolded lattice decode, then timed."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
    from kaldi_decoder_tpu_torch.kernels._build import kernels
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    S = udec._dev_graph.num_states
    st0, _, _, _ = udec._init(B)
    rem = torch.from_numpy(lengths).to(udec.device)
    _, o = lattice_chunk(udec._pg, scores_tm[:CHUNK], rem, st0, udec.cfg, S)
    sc = sweep_config(udec.cfg, CHUNK)
    args = (o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem, sc, S,
            o.eps_records)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    max_err = same_sweep(ref, got, "K4 with eps")
    log(f"K4 sweep with eps records: equal to plain on chunk 0 of the unfolded decode "
        f"(T={CHUNK}, B={B}, D={sc.eps_iters}, Re={sc.eps_records}, Bellman bound "
        f"{sc.eps_bound}; survivors tok {ref.tok_count.sum().item()}, em "
        f"{ref.em_count.sum().item()}, eps {ref.eps_count.sum().item()}; overflow "
        f"{int(ref.overflow.sum())}; clusters of "
        f"{kernels().kd_sweep_cluster(B, -(-sc.frontier_size // 4) * 4, sc.em_records)} blocks):")
    t = time_kernel("K4 with eps, one chunk", lambda: sweep_chunk(*args),
                    lambda: sweep_plain(*args), k4_work(*args[:5], got, eps=o.eps_records),
                    reps=2)
    del o, ref, got
    return float(max_err), t


def lattice_digest(lat):
    """(states, arcs, sha256 of the arcs in state order as int32 rows
    (src, dst, ilabel, olabel, graph weight bits, acoustic weight bits),
    sha256 of the start state and the final weights' bits) of a Lattice of
    either package, or (0, 0, "", "") for None."""
    import hashlib

    import numpy as np

    if lat is None:
        return 0, 0, "", ""
    a = lat.to_arrays()
    S = len(a["final"])
    src = np.repeat(np.arange(S, dtype=np.int32), np.diff(a["row_ptr"]))
    w = np.ascontiguousarray(a["weight"], np.float32).reshape(-1, 2).view(np.int32)
    arcs = np.stack([src, a["nextstate"], a["ilabel"], a["olabel"], w[:, 0], w[:, 1]], axis=1)
    fin = np.ascontiguousarray(a["final"], np.float32).reshape(-1, 2).view(np.int32)
    head = np.array([a["start"]], np.int32)
    return (S, int(arcs.shape[0]),
            hashlib.sha256(np.ascontiguousarray(arcs, np.int32).tobytes()).hexdigest(),
            hashlib.sha256(head.tobytes() + fin.tobytes()).hexdigest())


def pruned_links(pl):
    """(count, sha256) of a PrunedLattice's kept links (of either
    package), each as the int32 row (frame, source state, frame of the
    destination, destination state, ilabel, olabel, graph cost bits,
    acoustic cost bits), the rows sorted; (0, "") for None."""
    import hashlib

    import numpy as np

    if pl is None:
        return 0, ""
    rows = []
    for f in range(pl.num_frames + 1):
        for lk, fd in ((pl.eps_links[f], f),
                       (pl.em_links[f] if f < pl.num_frames else None, f + 1)):
            if lk is None or not len(lk.src):
                continue
            keep = np.asarray(lk.keep, bool)
            src = np.asarray(pl.tokens[f].states)[np.asarray(lk.src)[keep]]
            dst = np.asarray(pl.tokens[fd].states)[np.asarray(lk.dst)[keep]]
            n = len(src)
            rows.append(np.stack([
                np.full(n, f), src, np.full(n, fd), dst,
                np.asarray(lk.ilabel)[keep], np.asarray(lk.olabel)[keep],
                np.asarray(lk.graph_cost, np.float32)[keep].view(np.int32),
                np.asarray(lk.ac_cost, np.float32)[keep].view(np.int32),
            ], axis=1).astype(np.int32))
    if not rows:
        return 0, hashlib.sha256(b"").hexdigest()
    links = np.concatenate(rows)
    links = links[np.lexsort(links.T[::-1])]
    return int(len(links)), hashlib.sha256(np.ascontiguousarray(links).tobytes()).hexdigest()


def check_lattice_utterance(what, b, u, raw, best, stats, reached, frc):
    """Raise unless one utterance's lattice result equals its JAX
    reference (``scripts/make_torch_lattice_eps_reference.py``)."""
    import numpy as np

    from kaldi_decoder_tpu_torch.fst.ops import path_labels, path_total_cost

    L = u["length"]
    if best is None or path_labels(best) != u["olabels"]:
        raise AssertionError(f"{what}, utterance {b}: 1-best differs from the JAX reference")
    if int(np.float32(path_total_cost(best)).view(np.int32)) != u["path_cost_f32_bits"]:
        raise AssertionError(f"{what}, utterance {b}: best path cost differs")
    na = np.asarray(stats.active_per_frame[:L])
    if [int(x) for x in na] != u["num_active"]:
        bad = int(np.flatnonzero(na != np.asarray(u["num_active"]))[0])
        raise AssertionError(f"{what}, utterance {b}: num_active differs first at frame {bad}")
    got = dict(overflow_frames=stats.arc_budget_overflows,
               saturated_frames=stats.frontier_saturated_frames,
               reached_final=bool(reached), final_relative_cost=float(frc).hex())
    got.update(zip(("lattice_states", "lattice_arcs", "lattice_arcs_sha256",
                    "lattice_finals_sha256"), lattice_digest(raw)))
    for key, val in got.items():
        if val != u[key]:
            raise AssertionError(f"{what}, utterance {b}: {key} {val} != {u[key]}")


def lattice_eps_path(udec, scores, lengths, refs, lref):
    """Phase 6: the batched lattice decode without folding as a user calls
    it, counted, then checked against the JAX reference."""
    from kaldi_decoder_tpu_torch.utils.wer import wer

    want = lref["batched"]["device_config"]
    got_cfg = dict({f: getattr(udec.cfg.frontier, f) for f in want
                    if hasattr(udec.cfg.frontier, f)},
                   em_records=udec.cfg.em_records, eps_records=udec.cfg.eps_records,
                   lattice_beam=udec.cfg.lattice_beam)
    if got_cfg != want:
        raise AssertionError(f"unfolded lattice config {got_cfg} != the reference's {want}")
    D = udec.cfg.frontier.eps_iters
    reset_counts()
    t0 = time.perf_counter()
    res = udec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True)
    t_dec = time.perf_counter() - t0
    n = read_counts()
    if res.survivors is None:
        raise AssertionError("the device sweep overflowed and the decode fell back")
    frames = res.num_active.shape[0]
    want_n = launch_counts(gather=0, k1=frames, k2=frames * (1 + D) + D,
                           k4=len(res.survivors), k5=frames * D + D, k6=0, eps_step=0,
                           eps_dedup=frames * D + D, k3=frames, k3_start=len(res.survivors))
    if n != want_n:
        raise AssertionError(f"launch counts {n}, want {want_n}")
    replays = read_replays("lattice path without folding", frames)
    t1 = time.perf_counter()
    hyps = []
    for b, u in enumerate(lref["batched"]["utts"][:B]):
        hyps.append(res.best_path_labels(b))
        if hyps[-1] != u["labels"]:
            raise AssertionError(f"unfolded lattice, utterance {b}: labels differ")
        check_lattice_utterance("unfolded lattice", b, u, res.raw_lattice(b), res.best_path(b),
                                res.stats(b), res.reached_final(b), res.final_relative_cost(b))
    t_host = time.perf_counter() - t1
    eps_rows = sum(int(c["eps_count"].sum()) for c in res.survivors)
    audio_s = float(lengths.sum()) * 0.04
    log(f"lattice path without folding: decode {t_dec:.3f} s (forward + sweep + survivor "
        f"download, {audio_s:.0f} audio-s, {audio_s / t_dec:.1f} audio-s/s), host lattices, "
        f"best paths and checks {t_host:.3f} s; eps_iters={D}, eps survivor rows {eps_rows}; "
        f"launches {n}, {replays} frames replayed from the captured graph; matches the JAX "
        f"reference (labels, cost bits, num_active, lattice "
        f"digests) on {len(hyps)} utterances; overflow frames {int(res.overflows.sum())}, "
        f"saturated frames {int(res.saturations.sum())}; {wer(refs, hyps)}")
    return n, t_dec


def lattice_device_config(dec):
    """The streaming lattice decoder's device config, as the reference records it."""
    c = dec._dev_cfg
    return dict({f: getattr(c.frontier, f) for f in (
        "beam", "max_active", "min_active", "beam_delta", "frontier_size", "block_width",
        "rem_budget", "flat_group", "eps_block_width", "eps_rem_budget", "eps_iters",
        "eps_exact")}, em_records=c.em_records, eps_records=c.eps_records,
        lattice_beam=c.lattice_beam)


def streaming_lattice_path(graph, scores, lref, device="cuda"):
    """Phase 7: ``LatticeFasterDecoder`` over the reference's utterances,
    100 frames per ``advance_decoding``, then ``LatticeSimpleDecoder`` on
    the first; each counted, then checked against the JAX reference.
    Returns the launch counts of each and the faster decoder's ms per
    frame."""
    from kaldi_decoder_tpu_torch import (
        DecodableCtc,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
        LatticeSimpleDecoder,
        LatticeSimpleDecoderConfig,
    )

    out = {}
    for kind, make, cfg_cls in (("faster", LatticeFasterDecoder, LatticeFasterDecoderConfig),
                                ("simple", LatticeSimpleDecoder, LatticeSimpleDecoderConfig)):
        part = lref[kind]
        dec = make(graph, cfg_cls(**part["config"]), device=device)
        if lattice_device_config(dec) != part["device_config"]:
            raise AssertionError(f"{kind}: config {lattice_device_config(dec)} != the reference's")
        D = dec._dev_cfg.frontier.eps_iters
        reset_counts()
        t_dec = t_host = 0.0
        frames = calls = 0
        for b, u in enumerate(part["utts"]):
            L = u["length"]
            calls += -(-L // FRAMES_PER_CALL) if kind == "faster" else 1
            t0 = time.perf_counter()
            if kind == "faster":
                dec.init_decoding()
                decodable = DecodableCtc(scores[b, :L])
                while dec.num_frames_decoded() < L:
                    dec.advance_decoding(decodable, max_num_frames=FRAMES_PER_CALL)
                dec.finalize_decoding()
            else:
                dec.decode(DecodableCtc(scores[b, :L]))
            t1 = time.perf_counter()
            ok_raw, raw = dec.get_raw_lattice()
            ok, best = dec.get_best_path()
            if not (ok and ok_raw):
                raise AssertionError(f"{kind} lattice, utterance {b}: no lattice")
            check_lattice_utterance(f"{kind} lattice", b, u, raw, best, dec.stats(),
                                    dec.reached_final(), dec.final_relative_cost())
            t_host += time.perf_counter() - t1
            t_dec += t1 - t0
            frames += L
        n = read_counts()
        utts = len(part["utts"])
        want_n = launch_counts(gather=0, k1=frames, k2=frames * (1 + D) + utts * D, k4=0,
                               k5=frames * D + utts * D, k6=0, eps_step=0,
                               eps_dedup=frames * D + utts * D, k3=frames, k3_start=calls)
        if n != want_n:
            raise AssertionError(f"{kind} lattice: launch counts {n}, want {want_n}")
        replays = read_replays(f"{kind} lattice", frames)
        log(f"streaming lattice path: {type(dec).__name__}, {utts} utterance(s), {frames} "
            f"frames{f', {FRAMES_PER_CALL} per advance_decoding' if kind == 'faster' else ''}, "
            f"eps_iters={D}, K={dec._dev_cfg.frontier.frontier_size}: "
            f"{1000 * t_dec / frames:.3f} ms per frame (init + advance + finalize, downloads "
            f"and the host lattice's folding and pruning included), lattice and best path "
            f"{t_host:.3f} s; launches {n}, {replays} frames replayed from the captured graph; "
            f"matches the JAX reference")
        walls = None
        if kind == "faster":
            walls = loop_walls("phase 7, LatticeFasterDecoder on utterance 0",
                               stream_run(dec, scores[0, :WALL_STREAM_FRAMES]),
                               WALL_STREAM_FRAMES)
            walls["graph_pool_bytes"] = graph_pool(True, dec._pg, dec._dev_cfg,
                                                   dec._graph.num_states, 1)
        out[kind] = (n, 1000 * t_dec / frames, walls)
    return out


def csr_to_fst(graph):
    """A ``StdVectorFst`` built from a compiled graph's CSR arrays, each
    state's emitting arcs before its eps arcs, so that compiling it gives
    the graph back (``compile_fst`` partitions stably)."""
    import numpy as np

    from kaldi_decoder_tpu_torch.fst.fst import StdVectorFst

    ga, S = graph.arrays, graph.num_states
    em_deg, eps_deg = np.diff(ga.em_row_ptr), np.diff(ga.eps_row_ptr)
    row = np.zeros(S + 1, np.int64)
    row[1:] = np.cumsum(em_deg + eps_deg)
    E = int(row[-1])
    pos_em = np.repeat(row[:-1], em_deg) + (np.arange(graph.num_emitting_arcs)
                                           - np.repeat(ga.em_row_ptr[:-1], em_deg))
    pos_eps = np.repeat(row[:-1] + em_deg, eps_deg) + (np.arange(graph.num_eps_arcs)
                                                      - np.repeat(ga.eps_row_ptr[:-1], eps_deg))
    il, ol, ns = (np.zeros(E, np.int32) for _ in range(3))
    w = np.zeros(E, np.float32)
    il[pos_em], ol[pos_em], w[pos_em], ns[pos_em] = (ga.em_ilabel, ga.em_olabel, ga.em_weight,
                                                     ga.em_next)
    ol[pos_eps], w[pos_eps], ns[pos_eps] = ga.eps_olabel, ga.eps_weight, ga.eps_next
    return StdVectorFst.from_arrays(row, il, ol, w, ns, ga.final_cost, graph.start_state)


def same_graph(want, got, what):
    import numpy as np

    for name in want.arrays._fields:
        a, b = getattr(want.arrays, name), getattr(got.arrays, name)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{what}: {name} differs")
    for f in ("num_states", "num_emitting_arcs", "num_eps_arcs", "start_state", "eps_depth",
              "max_em_out_degree", "max_eps_out_degree", "max_score_idx"):
        if getattr(want, f) != getattr(got, f):
            raise AssertionError(f"{what}: {f} {getattr(got, f)} != {getattr(want, f)}")


def run_cli(argv):
    """``kaldi_decoder_tpu_torch.cli.main(argv)``, its JSON lines parsed."""
    import contextlib
    import io

    from kaldi_decoder_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"cli exited {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def graph_file_path(graph, scores, vref, lref, tmp):
    """Phase 8: the bench graph written as an OpenFst binary and read back
    with ``load_graph``; then the CLI as a user runs it on that file, the
    lattice decoder with lattice files and n-best, then the faster
    decoder, each counted and checked against the JAX references."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch import cli
    from kaldi_decoder_tpu_torch.fst import load_graph, read_fst, write_fst

    t0 = time.perf_counter()
    fst = csr_to_fst(graph)
    t_build = time.perf_counter() - t0
    path = os.path.join(tmp, "HLG.fst")
    t0 = time.perf_counter()
    write_fst(fst, path)
    t_write = time.perf_counter() - t0
    del fst
    t0 = time.perf_counter()
    fgraph = load_graph(path)
    t_read = time.perf_counter() - t0
    same_graph(graph, fgraph, "load_graph of the written file")
    log(f"graph file: {graph.num_states} states, {graph.num_emitting_arcs} emitting + "
        f"{graph.num_eps_arcs} eps arcs, {os.path.getsize(path)} bytes; StdVectorFst from the "
        f"CSR arrays {t_build:.3f} s, write_fst {t_write:.3f} s, load_graph {t_read:.3f} s; "
        "equal to the .npz graph array for array")

    lutts, sutts = lref["faster"]["utts"], vref["streaming"]["utts"]
    npys = []
    for b, u in enumerate(lutts):
        if sutts[b]["length"] != u["length"]:
            raise AssertionError("the two references' utterances differ in length")
        npys.append(os.path.join(tmp, f"utt{b}.npy"))
        np.save(npys[-1], scores[b, : u["length"]])
    lat_dir = os.path.join(tmp, "lats")
    os.makedirs(lat_dir)
    lcfg, sopt = lref["faster"]["config"], vref["streaming"]["options"]
    lattice_argv = ["decode", "--graph", path, "--logits", *npys, "--decoder", "lattice",
                    "--beam", f"{lcfg['beam']:g}", "--max-active", str(lcfg["max_active"]),
                    "--min-active", str(lcfg["min_active"]),
                    "--lattice-beam", f"{lcfg['lattice_beam']:g}", "--nbest", "5",
                    "--lattice-dir", lat_dir, "--device", "cuda"]
    faster_argv = ["decode", "--graph", path, "--logits", *npys, "--decoder", "faster",
                   "--beam", f"{sopt['beam']:g}", "--max-active", str(sopt["max_active"]),
                   "--min-active", str(sopt["min_active"]), "--device", "cuda"]
    parser, dev = cli.build_parser(), torch.device("cuda")
    ld = cli.make_decoder(parser.parse_args(lattice_argv), fgraph, dev)
    if lattice_device_config(ld) != lref["faster"]["device_config"]:
        raise AssertionError(f"cli lattice config {lattice_device_config(ld)} != phase 7's")
    fd = cli.make_decoder(parser.parse_args(faster_argv), fgraph, dev)
    want = vref["streaming"]["device_config"]
    if {f: getattr(fd._cfg, f) for f in want} != want:
        raise AssertionError("cli faster decoder config != phase 5's")
    D = ld._dev_cfg.frontier.eps_iters
    del ld, fd, fgraph
    frames = sum(u["length"] for u in lutts)

    out = {}
    for kind, argv, utts in (("lattice", lattice_argv, lutts), ("faster", faster_argv, sutts)):
        reset_counts()
        t0 = time.perf_counter()
        lines = run_cli(argv)
        secs = time.perf_counter() - t0
        n = read_counts()
        k2 = frames * (1 + D) + len(utts) * D if kind == "lattice" else 0
        k6 = frames * (1 + D) + len(utts) * D if kind == "faster" else 0
        k5 = frames * D + len(utts) * D  # both decoders; as many eps steps inside K2 or K6
        want_n = launch_counts(gather=0, k1=frames, k2=k2, k4=0, k5=k5, k6=k6, eps_step=0,
                               eps_dedup=k5, k3=frames, k3_start=len(utts))
        if n != want_n:
            raise AssertionError(f"cli {kind}: launch counts {n}, want {want_n}")
        read_replays(f"cli {kind}", frames)
        if len(lines) != len(utts):
            raise AssertionError(f"cli {kind}: {len(lines)} lines for {len(utts)} utterances")
        for b, (rec, u) in enumerate(zip(lines, utts)):
            if rec.get("hyp") != " ".join(map(str, u["olabels"])):
                raise AssertionError(f"cli {kind}, utterance {b}: hyp differs from the JAX "
                                     "reference")
            if kind == "lattice":
                if rec["reached_final"] != u["reached_final"]:
                    raise AssertionError(f"cli lattice, utterance {b}: reached_final")
                digest = lattice_digest(read_fst(rec["lattice"]))
                want_d = tuple(u[k] for k in ("lattice_states", "lattice_arcs",
                                              "lattice_arcs_sha256", "lattice_finals_sha256"))
                if digest != want_d:
                    raise AssertionError(f"cli lattice, utterance {b}: the lattice file read "
                                         "back differs from the reference's raw lattice")
                nb = rec["nbest"]
                if nb[0]["hyp"] != rec["hyp"] or [x["cost"] for x in nb] != sorted(
                        x["cost"] for x in nb):
                    raise AssertionError(f"cli lattice, utterance {b}: n-best malformed")
        log(f"cli decode --decoder {kind} on the graph file ({len(utts)} utterances, {frames} "
            f"frames): {secs:.3f} s, {secs / len(utts):.3f} s per utterance (the cli's own "
            f"seconds: {[rec['seconds'] for rec in lines]}); launches {n}; hyps equal the JAX "
            "reference" + ("; lattice files read back equal the reference's raw lattices, "
                           f"n-best of {[len(rec['nbest']) for rec in lines]}"
                           if kind == "lattice" else ""))
        out[kind] = (n, secs / len(utts))
    return out, dict(build_s=t_build, write_s=t_write, read_s=t_read)


def encoder_params(cfg, rng):
    """Encoder weights in the layout of ``kaldi_decoder_tpu.models.ctc.init_params``,
    drawn from the numpy generator ``rng`` with its scales."""
    import numpy as np

    F_in, H, V = cfg.num_features * cfg.subsampling, cfg.hidden_dim, cfg.vocab_size

    def normal(rows, cols):
        return (rng.standard_normal((rows, cols)) / np.sqrt(rows)).astype(np.float32)

    params = {"in_proj": normal(F_in, H), "out_proj": normal(H, V),
              "out_bias": np.zeros(V, np.float32), "layers": []}
    for _ in range(cfg.num_layers):
        params["layers"].append({"w1": normal(H, 4 * H), "w2": normal(4 * H, H),
                                 "scale": np.ones(H, np.float32)})
    return params


def encoder_path(graph, fc):
    """Phase 9: ``CtcEncoder`` (the default config, seeded numpy weights
    carried across by ``encoder_from_numpy``) on B utterances of 4T feature
    frames on the card, held against the same module in float64 on the
    CPU; then its posteriors decoded by ``BatchedLatticeDecoder`` at phase
    3's config, counted as phase 3 is; then K1 and K2 on frames
    ``ENCODER_FRAMES`` of that decode, and K4 on its first chunk, held
    against their plain versions."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder
    from kaldi_decoder_tpu_torch.models import CtcEncoderConfig, encoder_from_numpy

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    cfg = CtcEncoderConfig()
    if cfg.vocab_size != V:
        raise AssertionError(f"encoder vocabulary {cfg.vocab_size} != the graph's {V}")
    rng = np.random.default_rng(SEED + 100)
    params = encoder_params(cfg, rng)
    feats = rng.standard_normal((B, T * cfg.subsampling, cfg.num_features)).astype(np.float32)
    enc = encoder_from_numpy(params, cfg, "cuda")
    feats_d = torch.from_numpy(feats).cuda()
    with torch.no_grad():
        post = enc(feats_d)
        ms = device_ms(lambda: enc(feats_d))
        t0 = time.perf_counter()
        ref = encoder_from_numpy(params, cfg, "cpu").double()(torch.from_numpy(feats).double())
        t_cpu = time.perf_counter() - t0
    err = float((post.cpu().double() - ref).abs().max())
    if post.shape != (B, T, V) or not torch.isfinite(post).all() or err > 1e-4:
        raise AssertionError(f"encoder posteriors {tuple(post.shape)}, max |err| {err} against "
                             "float64 on the CPU (limit 1e-4)")
    log(f"encoder: {cfg} on {B} x {T * cfg.subsampling} "
        f"feature frames -> {tuple(post.shape)} posteriors in {ms:.3f} ms (device, CUDA events, "
        f"TF32 off); max |err| {err:.3e} against float64 on the CPU ({t_cpu:.1f} s there)")
    scores = post.cpu().numpy()
    lengths = np.full(B, T, np.int32)
    del ref, enc, feats_d
    dec = BatchedLatticeDecoder(graph, fc, device="cuda", **DECODER_KW)
    reset_counts()
    t0 = time.perf_counter()
    res = dec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True)
    t_dec = time.perf_counter() - t0
    n = read_counts()
    if res.survivors is None:
        raise AssertionError("the device sweep overflowed and the decode fell back")
    frames = res.num_active.shape[0]
    want_n = launch_counts(gather=0, k1=frames, k2=frames, k4=len(res.survivors), k5=0,
                           k6=0, eps_step=0, k3=frames, k3_start=len(res.survivors))
    if n != want_n:
        raise AssertionError(f"encoder decode: launch counts {n}, want {want_n}")
    read_replays("encoder decode", frames)
    hyps = [res.best_path_labels(b) for b in range(B)]
    if not all(isinstance(h, list) for h in hyps):
        raise AssertionError("an encoder utterance produced no 1-best")
    if not all(((res.num_active[:, b] >= 1) & (res.num_active[:, b] <= fc.frontier_size)).all()
               for b in range(B)):
        raise AssertionError("encoder decode: per-frame stats malformed")
    log(f"encoder -> lattice decode: {t_dec:.3f} s (B={B}, T={T}); launches {n}; words per "
        f"utterance {[len(h) for h in hyps]}; overflow frames {int(res.overflows.sum())}, "
        f"saturated frames {int(res.saturations.sum())}")
    post_tm = post.transpose(0, 1).contiguous()
    k1_err, k2_err, seen, _, _ = hold_lattice_frames(dec, post_tm, ENCODER_FRAMES,
                                                     "the encoder decode's")
    k4_err, _, sref, _ = hold_k4(dec, post_tm, lengths, "K4 on the encoder decode's chunk 0")
    log(f"  K1 and K2 equal to plain on the encoder decode's frames {list(ENCODER_FRAMES)} "
        f"({seen}); K4 on its chunk 0 (survivors tok {sref.tok_count.sum().item()}, em "
        f"{sref.em_count.sum().item()}, overflow {sref.overflow.sum().item()})")
    del post, post_tm, sref
    return n, dict(encoder_ms=ms, decode_s=t_dec, max_abs_err=err,
                   kernel_errs=dict(k1=k1_err, k2=k2_err, k4=float(k4_err)))


def recall_decoder(graph, em_records, device):
    """The recall measurement's lattice decoder at ``em_records``."""
    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph

    return BatchedLatticeDecoder(graph, config_for_graph(graph, **RECALL_CONFIG),
                                 em_records=em_records, device=device, **RECALL_KW)


def recall_oracle(graph):
    """The recall measurement's oracle: deterministic cutoff, GetCutoff's
    max_active, on the compiled graph through ``CsrFstView``."""
    from kaldi_decoder_tpu_torch.decoders.ref_lattice import OracleLatticeDecoder
    from kaldi_decoder_tpu_torch.fst.csr import CsrFstView

    return OracleLatticeDecoder(
        CsrFstView(graph), beam=RECALL_CONFIG["beam"], lattice_beam=RECALL_KW["lattice_beam"],
        deterministic_cutoff=True, max_active=RECALL_CONFIG["max_active"],
        min_active=RECALL_CONFIG["min_active"])


def recall_path(graph, scores, rref):
    """Phase 10: link recall of the port's ``BatchedLatticeDecoder``
    (``device_prune=False``) against the port's oracle on utterance 0,
    trimmed to the reference's frames, at each em_records budget; every
    field must equal the JAX reference's (``tests/data/torch_port_recall_ref.json``)."""
    import hashlib

    import numpy as np

    from kaldi_decoder_tpu_torch.lattice.recall import device_recall, oracle_lattice

    Tr = rref["workload"]["frames"]
    sc = np.ascontiguousarray(scores[0, :Tr])
    if hashlib.sha256(sc.tobytes()).hexdigest() != rref["workload"]["scores_sha256"]:
        raise AssertionError("recall: the rebuilt utterance differs from the reference's")
    if [b["em_records"] for b in rref["budgets"]] != list(RECALL_BUDGETS):
        raise AssertionError("recall: the reference's budgets are not RECALL_BUDGETS")
    olinks, olabels, t_oracle = oracle_lattice(recall_oracle(graph), sc)
    if len(olinks) != rref["oracle"]["links"] or olabels != rref["oracle"]["labels"]:
        raise AssertionError(f"recall: the oracle's {len(olinks)} links or best path differ "
                             "from the JAX oracle's")
    log(f"recall: oracle on utterance 0, T={Tr}: {len(olinks)} links, {t_oracle:.1f} s on the "
        "host; equal to the JAX oracle's")
    counts, rows = [], []
    for want in rref["budgets"]:
        dec = recall_decoder(graph, want["em_records"], "cuda")
        reset_counts()
        got = device_recall(dec, sc, olinks, olabels, CHUNK)
        counts.append(read_counts())
        del dec
        frames = -(-Tr // CHUNK) * CHUNK
        want_n = launch_counts(gather=0, k1=frames, k2=frames, k4=0, k5=0, k6=0, eps_step=0,
                               k3=frames, k3_start=frames // CHUNK)
        if counts[-1] != want_n:
            raise AssertionError(f"recall: launch counts {counts[-1]}, want {want_n}")
        read_replays("recall", frames)
        for key, val in want.items():
            if key != "seconds" and got[key] != val:
                raise AssertionError(f"recall at em_records {want['em_records']}: {key} "
                                     f"{got[key]} != {val}")
        rows.append(got)
        log(f"  em_records {got['em_records']}: recall {got['recall']} ({got['common_links']} of "
            f"{got['oracle_links']} links), extra {got['extra']}, overflow frames "
            f"{got['overflow_frames']}, saturated {got['saturated_frames']}, best path match "
            f"{got['best_path_match']}; decode + host prune {got['seconds']:.2f} s; launches "
            f"{counts[-1]}; equal to the JAX reference")
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    return total, dict(oracle_s=t_oracle, rows=rows)


def check_workload(utts, scores, lengths, refs):
    """Raise unless the rebuilt workload is the one a reference was
    computed on (lengths, transcripts, score hashes)."""
    import hashlib

    for b, u in enumerate(utts):
        L = u["length"]
        if (L != int(lengths[b]) or u["ref_words"] != [int(w) for w in refs[b]]
                or u["scores_sha256"] != hashlib.sha256(scores[b, :L].tobytes()).hexdigest()):
            raise AssertionError(f"utterance {b}: the rebuilt workload differs from the reference's")


def load_reference(name, scores, lengths, refs):
    """A committed JAX reference, after checking that the rebuilt workload
    is the one it was computed on."""
    with open(os.path.join(REPO, "tests", "data", name)) as f:
        ref = json.load(f)
    for part, val in ref.items():
        if part == "utts" or (isinstance(val, dict) and "utts" in val):
            check_workload((val if part == "utts" else val["utts"])[:B], scores, lengths, refs)
    return ref


def main_path(dec, scores, lengths, refs, ref):
    """The decode as a user calls it, counted; then checks against the
    JAX reference.  Returns the launch counts and the decode's seconds."""
    import numpy as np

    from kaldi_decoder_tpu_torch.utils.wer import wer

    reset_counts()
    t0 = time.perf_counter()
    res = dec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True)
    t_dec = time.perf_counter() - t0
    n = read_counts()
    gat, k1, k2, k4 = n["gather"], n["k1"], n["k2"], n["k4"]
    if res.survivors is None:
        raise AssertionError("the device sweep overflowed and the decode fell back")
    frames = res.num_active.shape[0]
    chunks = len(res.survivors)
    if (gat or k1 != frames or k2 != frames or k4 != chunks or n["k6"] or n["k3"] != frames
            or n["k3_start"] != chunks or n["k5"] or n["eps_step"] or n["eps_dedup"]):
        raise AssertionError(
            f"launch counts gather={gat} (want 0), K1={k1}, K2={k2}, K3={n['k3']} (want "
            f"{frames} each), K4={k4}, K3's first-frame mode {n['k3_start']} (want {chunks} "
            f"each), K6={n['k6']}, K5={n['k5']}, eps step {n['eps_step']} alone and "
            f"{n['eps_dedup']} inside a dedup call (want 0 each)"
        )
    replays = read_replays("main path", frames)
    t1 = time.perf_counter()
    hyps = [res.best_path_labels(b) for b in range(B)]
    t_host = time.perf_counter() - t1
    if not all(isinstance(h, list) and h for h in hyps):
        raise AssertionError("an utterance produced no 1-best")
    # Per-frame stats: the shape of the padded decode, 1..K live tokens
    # in every frame of every utterance, no NaN cutoff (+inf is GetCutoff's
    # answer when fewer than min_active tokens are live).
    K = dec.cfg.frontier.frontier_size
    live = [res.num_active[: int(lengths[b]), b] for b in range(B)]
    if (res.num_active.shape != (frames, B) or np.isnan(res.cutoffs).any()
            or not all(((x >= 1) & (x <= K)).all() for x in live)):
        raise AssertionError("per-frame stats malformed")
    for b, u in enumerate(ref["utts"][:B]):
        L = u["length"]
        if hyps[b] != u["labels"]:
            raise AssertionError(f"utterance {b}: 1-best differs from the JAX reference")
        if res.num_active[:L, b].tolist() != u["num_active"]:
            bad = int(np.flatnonzero(res.num_active[:L, b] != np.asarray(u["num_active"]))[0])
            raise AssertionError(f"utterance {b}: num_active differs first at frame {bad}")
        for key, arr in (("overflow_frames", res.overflows), ("saturated_frames", res.saturations)):
            if int(arr[:L, b].sum()) != u[key]:
                raise AssertionError(f"utterance {b}: {key} {int(arr[:L, b].sum())} != {u[key]}")
    st = wer(refs, hyps)
    audio_s = float(lengths.sum()) * 0.04
    log(f"main path: decode {t_dec:.3f} s (forward + sweep + survivor download, "
        f"{audio_s:.0f} audio-s, {audio_s / t_dec:.1f} audio-s/s), host 1-best "
        f"{t_host:.3f} s; row gather launches {gat}, K1 launches {k1}, K2 launches {k2}, "
        f"K4 launches {k4}, K3 launches {n['k3']} (first-frame mode {n['k3_start']}), "
        f"{replays} frames replayed from the captured graph; matches the JAX "
        f"reference on {len(ref['utts'][:B])} utterances; overflow frames "
        f"{int(res.overflows.sum())}, saturated frames {int(res.saturations.sum())}; {st}")
    return n, t_dec


class CallCapture:
    """While active, the kernel wrappers ``names`` of ``module`` (the
    names the module calls them by) keep the arguments of their calls at
    the given indices, tensors cloned; every call still goes to the
    wrapper, which counts its launch as always."""

    def __init__(self, module, want):
        self.module, self.want = module, want  # name -> call indices to keep
        self.calls = {n: 0 for n in want}
        self.kept = {}
        self.orig = {n: getattr(module, n) for n in want}

    def __enter__(self):
        for n in self.want:
            setattr(self.module, n, self._wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.module, n, f)

    def _wrap(self, n):
        def call(*args, **kw):
            i = self.calls[n]
            self.calls[n] += 1
            if i in self.want[n]:
                self.kept[n, i] = (clone(args), {k: clone(v) for k, v in kw.items()})
            return self.orig[n](*args, **kw)

        return call


def clone(x):
    """``x`` with every tensor in it (in tuples and named tuples) cloned;
    sharded frame slots copied (``ShardSlots.copy``: the same chunk)."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if type(x).__name__ == "ShardSlots":  # by name: a tree before the slots has none
        return x.copy()
    if isinstance(x, tuple):
        items = [clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def bit_complement(x):
    """``x`` with every bit flipped (a bool tensor negated)."""
    import torch

    if x.dtype == torch.bool:
        return ~x
    if x.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        return (~x.view(ints)).view(x.dtype)
    return ~x


def shard_call_index(frame, eps_iters, eps=False):
    """The index of a frame's K6 (Viterbi), K2 (lattice) or K7 call in a
    sharded decode: the start closure's ``eps_iters`` calls first, then
    per frame the emitting call and one per eps iteration."""
    return eps_iters + frame * (1 + eps_iters) + (1 if eps else 0)


def k7_send_work(args, got):
    """Bytes and operations of K7's send side: each lane's destination and
    cost read, each kept lane's payload (and its slot's state, when the
    call maps slots to states) read, the whole send buffer and the flags
    written, the cutoff read; a compare a lane."""
    from kaldi_decoder_tpu_torch.fst.pack import INF_BITS

    B, N = args[0].shape
    kept = int((got.buf[..., 1] != INF_BITS).sum())
    cutoff, slot_states = args[8], args[9]
    nbytes = (B * N * 8 + kept * (8 + (4 if slot_states is not None else 0))
              + got.buf.numel() * 4 + B + (B * 4 if cutoff is not None else 0))
    return nbytes, B * N


def k7_recv_work(recv, got):
    """Bytes and operations of K7's receive side: the received buffer and
    the incumbents read, four columns of every lane written; a compare a
    lane."""
    B, L = got.cost.shape
    inc = L - recv.shape[0] * recv.shape[2]
    return recv.numel() * 4 + B * inc * 8 + B * L * 16, B * L


def eps_step_shard_work(sel, carry, lanes, stopped):
    """Bytes and operations of one eps step's shard mode: the winning lanes
    and their routed slot and arc (1-best) or the frontier's costs and the
    records (lattice), the per-row flags read; the iteration's
    backpointers or links, and, unless stopped, the selection's frontier
    read and written as the carried one; a compare a slot."""
    B, K = sel.states.shape
    rows = carry.out.shape[2]
    if getattr(sel, "records", None) is not None:
        nbytes = B * K * 8 + sel.records[:, :, 0].numel() * 16
    else:
        nbytes = B * K * 4 + int((sel.cand_idx >= 0).sum()) * 8
    nbytes += B * rows * 8 + (0 if stopped else B * K * 16) + B * 24 + 64
    return nbytes, B * K


def k3_shard_work(tin, fa, local=None, width=0):
    """Bytes and operations of K3's shard mode: of a live row, the
    closure's frontier read and the carried one written; of every row its
    stacked outputs written (the frontier, the records or backpointers) and
    their inputs read (records; the winning lanes' slots and arcs once
    each and the eps backpointers); some 40 bytes of per-row scalars and
    the table's words; the next scores row of ``width`` read and written;
    with ``local``, the next frame's local half of a live row (two scalars
    in, two out, its prefix of m written); a subtract and an add a slot."""
    B, K = tin.mid_states.shape
    act = int(fa.sum())
    nbytes = act * K * 16 + B * 40 + 96 + B * width * 8
    if local is not None:
        m = local.prefix.shape[1] if local.prefix is not None else 0
        nbytes += act * (16 + m * 4)
    if tin.em_records is not None:
        nbytes += B * (tin.em_records[0, :, 0].numel() * 24 + tin.eps_records[0].numel() * 8
                       + K * 8)
    else:
        won = int((tin.cand_idx[fa] >= 0).sum())
        nbytes += B * K * 12 + won * 8 + B * tin.bp_eps[0].numel() * 8
    return nbytes, 2 * B * K


def k3_start_shard_work(io):
    """Bytes and operations of K3's shard first-frame mode: the chunk's
    start state (states, costs, base), row lengths and scores row 0 read
    and written into the slots, the table's 12 words written; no
    arithmetic (1 operation a row, so the bound is the bytes')."""
    B, K = io.st0.states.shape
    V_ = io.scores.shape[2] if io.scores.shape[0] else 0
    return 2 * B * (K * 8 + 8 + V_ * 4) + 96, B


def hold_shard_kernels(kept, kind, eps_iters, tag):
    """K5 (its first eps iteration's call), K1 and K6 (Viterbi) or K2
    (lattice) on the calls of frame SHARD_FRAME that a sharded decode made
    (``kept``, a CallCapture's), held against their plain versions
    (bitwise) and timed; returns ({kernel: max |err|}, {kernel_call:
    time_kernel fields})."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
    from kaldi_decoder_tpu_torch.kernels.eps import expand_eps_lanes, expand_eps_lanes_plain
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    errs, times = hold_shard_route(kept, eps_iters, tag)
    where = f"{tag}, frame {SHARD_FRAME}"
    if eps_iters:
        args, kw = kept["expand_eps_lanes", eps_iters + SHARD_FRAME * eps_iters]
        ref = expand_eps_lanes_plain(*args, **kw)
        got = expand_eps_lanes(*args, **kw)
        torch.cuda.synchronize()
        same_fields(ref, got, "K5", where)
        errs["k5"] = 0.0
        out = got
        times["k5"] = time_kernel(
            f"K5 at {where} (B={args[0].shape[0]}, K {args[0].shape[1]}, no incumbents, N "
            f"{got.dst.shape[1]})", lambda: expand_eps_lanes(*args, **kw, out=out),
            lambda: expand_eps_lanes_plain(*args, **kw), k5_work(got, *args[:5]))
    args, kw = kept["expand_filter", SHARD_FRAME]
    errs["k1"] = same_expansion(expand_filter_plain(*args, **kw), expand_filter(*args, **kw),
                                where)
    times["k1"] = time_kernel(f"K1 at {where} (B={args[0].shape[0]}, K {args[0].shape[1]})",
                              lambda: expand_filter(*args, **kw),
                              lambda: expand_filter_plain(*args, **kw), k1_work(*args, **kw))
    name = "dedup_select" if kind == "viterbi" else "dedup_select_rec"
    args, kw = kept[name, shard_call_index(SHARD_FRAME, eps_iters)]
    shape = f"B={args[0].shape[0]}, N {args[0].shape[1]}, K {args[2]}, S {args[3]}"
    for sfx in ("",):
        if kind == "viterbi":
            got = dedup_select(*args)
            errs["k6" + sfx] = same_selection(dedup_select_plain(*args), got, where + sfx)
            times["k6" + sfx] = time_kernel(f"K6{sfx} at {where} ({shape})",
                                            lambda: dedup_select(*args),
                                            lambda: dedup_select_plain(*args), k6_work(*args[1:3]))
        else:
            got = dedup_select_rec(*args, **kw)
            errs["k2" + sfx] = same_records(dedup_select_rec_plain(*args, **kw), got, where + sfx)
            times["k2" + sfx] = time_kernel(f"K2{sfx} at {where} ({shape}, R {args[4]})",
                                            lambda: dedup_select_rec(*args, **kw),
                                            lambda: dedup_select_rec_plain(*args, **kw),
                                            k2_work(*args, **kw))
    if eps_iters:
        k = "k6_eps" if kind == "viterbi" else "k2_eps"
        args, kw = kept[name, shard_call_index(SHARD_FRAME, eps_iters, True)]
        errs[k], times[k] = hold_routed_call(args, kw, kind, where + "_eps")
    return errs, times


def hold_routed_call(args, kw, kind, where):
    """A sharded eps call with K7's receive side folded in (K6, or K2's eps
    call, on ``kw["routed"]``, the K incumbents and the received buffer
    read in place): held bitwise against its plain version on CPU copies
    (the lanes laid out by ``routed_lanes_plain``, the dedup call's plain
    version) and against the flat instance on the lanes laid out on the
    card; timed (the plain version: the layout and the dedup call's plain
    version on the card), beside the flat instance on the laid-out lanes
    (``dedup_alone_ms``, what the call cost before the fold, whose
    receive launch laid the lanes out; ``fold_ms`` the difference).
    Returns (max |err|, the time_kernel fields)."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
    from kaldi_decoder_tpu_torch.kernels.route import routed_lanes_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    src = kw["routed"]
    lanes = routed_lanes_plain(src)
    B, N = lanes.cost.shape
    K, S = args[2], args[3]
    cpu = to_cpu(kw)
    if kind == "viterbi":
        got = dedup_select(*args, **kw)
        flat = dedup_select(lanes.state_local, lanes.cost, K, S)
        ref = dedup_select(*args, **cpu)
        err = same_selection(ref, to_cpu(got), where)
        same_selection(flat, got, where + " (the flat instance on the lanes laid out)")
        t = time_kernel(f"K6_eps at {where} (B={B}, routed lanes {N}, K {K}, S {S}; the receive "
                        f"side folded in)", lambda: dedup_select(*args, **kw),
                        lambda: dedup_select_plain(*routed_lanes_plain(src)[:2], K, S),
                        k6_work(lanes.cost, K))
        t["dedup_alone_ms"] = device_ms(lambda: dedup_select(lanes.state_local, lanes.cost, K, S))
    else:
        R, sb = args[4], args[5]
        inc = kw["num_incumbents"]
        got = dedup_select_rec(*args, **kw)
        pay = (lanes.gslot, lanes.arc)
        flat = dedup_select_rec(lanes.state_local, lanes.cost, K, S, R, sb, pay,
                                num_incumbents=inc)
        ref = dedup_select_rec(*args, **cpu)
        same_fields(ref, to_cpu(got), "K2's eps call on routed lanes", where)
        same_fields(flat, got, "K2's eps call on routed lanes",
                    where + " (the flat instance on the lanes laid out)")
        err = 0.0

        def plain():
            ln = routed_lanes_plain(src)
            return dedup_select_rec_plain(ln.state_local, ln.cost, K, S, R, sb,
                                          (ln.gslot, ln.arc), inc)

        t = time_kernel(f"K2_eps at {where} (B={B}, routed lanes {N}, K {K}, S {S}, R {R}; the "
                        f"receive side folded in)", lambda: dedup_select_rec(*args, **kw), plain,
                        k2_work(lanes.state_local, lanes.cost, K, S, R, sb, pay, inc))
        t["dedup_alone_ms"] = device_ms(lambda: dedup_select_rec(
            lanes.state_local, lanes.cost, K, S, R, sb, pay, num_incumbents=inc))
    t["fold_ms"] = t["ms"] - t["dedup_alone_ms"]
    log(f"    the flat instance on the lanes laid out: {t['dedup_alone_ms']:.4f} ms; the fold "
        f"{t['fold_ms']:+.4f} ms")
    return err, t


def to_cpu(x):
    """``x`` with every tensor in it (in dicts, tuples and named tuples)
    copied to the CPU."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [to_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def k8_local_work(costs, m):
    """Bytes and operations of K8's local half: a row's costs read, its
    best cost, count and m-cost prefix written (m 0: none); a compare a
    slot."""
    B, K = costs.shape
    return B * K * 4 + B * m * 4 + B * 8, B * K


def k8_merge_work(best, count, merged, beam, beam_delta, max_active, min_active):
    """Bytes and operations of K8's merge (its wrapper's arguments), as
    the function needs them: a row's best cost and count read and its
    cutoff and adaptive beam written (the early return: no count), and,
    for each order statistic that GetCutoff's branch reads on this call's
    counts (max_active's where the count passes it, min_active's where it
    passes that and min_active is not 0), the keys that finding one
    order statistic of P sorted prefixes of m must read: 1 at P = 1
    (rank = position), P * ceil(log2 m) past it; a compare a key (the
    early return: an add a row)."""
    B = best.shape[0]
    if merged is None:
        return B * 12, B
    P, _, m = merged.shape
    c = count.cpu()
    targets = int((c > max_active).sum()) + (int((c > min_active).sum()) if min_active else 0)
    keys = targets * (1 if P == 1 else P * max(1, math.ceil(math.log2(m))))
    return B * 16 + keys * 4, max(keys, B)


def hold_shard_route(kept, eps_iters, tag):
    """K7's send and receive sides (the emitting call and the first eps
    iteration's; the send side at each cluster size too), the eps step's
    shard mode (that iteration's step), K3's shard mode and K8's local
    half and merge on frame SHARD_FRAME's calls of a sharded decode
    (``kept``, a CallCapture's), each against its plain version (K8's on
    CPU copies, as the JAX package is held to it), bitwise, and timed;
    returns ({kernel: max |err|}, {kernel_call: time_kernel fields})."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        empty_cutoff_local,
        global_cutoff_local,
        global_cutoff_local_plain,
        global_cutoff_merge,
        global_cutoff_merge_plain,
    )
    from kaldi_decoder_tpu_torch.kernels.eps import (
        eps_step_shard,
        eps_step_shard_plain,
        shard_step_cluster_size,
    )
    from kaldi_decoder_tpu_torch.kernels.frame import (
        FrameIO,
        ShardSlots,
        empty_shard_outs,
        frame_start_shard,
        frame_start_shard_plain,
        frame_tail_shard,
        frame_tail_shard_plain,
        shard_cluster_size,
    )
    from kaldi_decoder_tpu_torch.kernels.route import (
        route_recv,
        route_recv_plain,
        route_send,
        route_send_plain,
        send_cluster_size,
    )

    errs, times = {}, {}
    where = f"{tag}, frame {SHARD_FRAME}"
    calls = [("", False)] + ([("_eps", True)] if eps_iters else [])
    for sfx, eps in calls:
        i = shard_call_index(SHARD_FRAME, eps_iters, eps)
        args, kw = kept["route_send", i]
        out = kw["out"]
        ref = route_send_plain(*args)
        got = route_send(*args, out=out)
        torch.cuda.synchronize()
        same_fields(ref, got._replace(scratch=None), "K7's send side", where + sfx)
        B, N = args[0].shape
        P, cap = args[5], args[6]
        t = time_kernel(
            f"K7 send{sfx} at {where} (B={B}, N {N}, P {P}, cap {cap}, "
            f"{'slack ' + str(args[7]) if args[7] is not None else 'leaders'}, "
            f"{send_cluster_size(N)} blocks a row)",
            lambda: route_send(*args, out=out), lambda: route_send_plain(*args),
            k7_send_work(args, got))
        t["clusters"], t["ms_by_clusters"] = send_cluster_size(N), {}
        for g in (1, 2, 4, 8):
            got = route_send(*args, out=out, clusters=g)
            torch.cuda.synchronize()
            same_fields(ref, got._replace(scratch=None), f"K7's send side at {g} blocks a row",
                        where + sfx)
            t["ms_by_clusters"][g] = device_ms(lambda: route_send(*args, out=out, clusters=g))
        log(f"    at 1, 2, 4, 8 blocks a row: " + ", ".join(
            f"{ms:.4f}" for ms in t["ms_by_clusters"].values()) + " ms, each equal to plain")
        times["k7_send" + sfx] = t
    # The receive side runs for the emitting call alone (an eps iteration's
    # dedup call reads the received buffer in place: hold_routed_call).
    args, kw = kept["route_recv", SHARD_FRAME]
    out = kw["out"]
    ref = route_recv_plain(*args)
    got = route_recv(*args, out=out)
    torch.cuda.synchronize()
    same_fields(ref, got, "K7's receive side", where)
    times["k7_recv"] = time_kernel(
        f"K7 receive at {where} (B={got.cost.shape[0]}, lanes {got.cost.shape[1]})",
        lambda: route_recv(*args, out=out), lambda: route_recv_plain(*args),
        k7_recv_work(args[0], got))
    errs["k7_send"] = errs["k7_recv"] = 0.0
    if eps_iters:
        args, kw = kept["eps_step_shard", eps_iters + SHARD_FRAME * eps_iters]
        ref_args = clone(args)
        eps_step_shard_plain(*ref_args, **kw)
        sel = args[4]
        B, K = sel.states.shape
        chosen = shard_step_cluster_size(B, K)

        def held(g):
            """The step on a fresh copy of the captured arguments at g blocks
            a row (0: its own choice), held bitwise; returns the copy."""
            got_args = clone(args)
            eps_step_shard(*got_args, **kw, clusters=g)
            torch.cuda.synchronize()
            same_fields(ref_args[1], got_args[1],
                        f"the eps step's shard mode (carry) at {g or chosen} blocks a row", where)
            for name, r, gt in zip(("states", "costs"), ref_args[2:4], got_args[2:4]):
                if not torch.equal(r.view(torch.int32), gt.view(torch.int32)):
                    raise AssertionError(f"the eps step's shard mode differs from plain on "
                                         f"{where} at {g or chosen} blocks a row: the carried "
                                         f"{name}")
            return got_args

        got_args = held(0)
        t = time_kernel(
            f"eps step, shard mode, at {where} (B={B}, K {K}, width {args[1].out.shape[2]}, "
            f"{chosen} blocks a row)",
            lambda: eps_step_shard(*got_args, **kw), lambda: eps_step_shard_plain(*ref_args, **kw),
            eps_step_shard_work(sel, args[1], kw.get("lanes"), False))
        t["clusters"], t["ms_by_clusters"] = chosen, {}
        for g in CLUSTER_SIZES:
            g_args = held(g)
            t["ms_by_clusters"][g] = device_ms(lambda: eps_step_shard(*g_args, **kw, clusters=g))
        t["share_by_clusters"] = {g: t["bound_ms"] / ms for g, ms in t["ms_by_clusters"].items()}
        log(f"    chosen {chosen} blocks a row; at 8, 4, 2, 1: device ms (share of the bound) "
            + ", ".join(f"{g}: {ms:.4f} ({t['share_by_clusters'][g]:.1%})"
                        for g, ms in t["ms_by_clusters"].items()) + ", each equal to plain")
        times["eps_step_shard"] = t
        errs["eps_step_shard"] = 0.0
    args, kw = kept["frame_tail_shard", SHARD_FRAME]
    slots, cutoff, tin, slot_base = args  # the slots as the call found them (a copy)
    local = kw["local"]
    io, st = slots.io, slots.state
    t = int(slots.args[0])
    T = io.scores.shape[0]
    fa = slots.lengths > t
    final, ref, nxt = frame_tail_shard_plain(st, cutoff, tin, fa, slot_base, local)
    B, K = st.states.shape
    m = local.prefix.shape[1] if local.prefix is not None else K
    # The folded local half is K8's local half of the new costs, bit for bit.
    fresh = global_cutoff_local_plain(final.costs.cpu(), m)
    same_fields(fresh._replace(prefix=None if local.prefix is None else fresh.prefix),
                to_cpu(nxt), "K3's shard mode's local half (plain)", where)
    chosen = shard_cluster_size(B, K)
    lattice = tin.em_records is not None
    V_ = io.scores.shape[2]

    def chunk_from_t(rows):
        """A chunk of its own from frame t's state: its rows' lengths
        moved to t, its scores ``rows``, new outputs."""
        return FrameIO(rows, (slots.lengths - t).clamp(min=0), st, empty_shard_outs(
            rows.shape[0], B, K, io.outs[1].shape[2], lattice, st.states.device,
            *((io.outs[0].shape[2], io.outs[1].shape[3]) if lattice else ())))

    # Each cluster size begins a chunk of its own at frame t, whose row 0
    # differs from plain's in every bit before the call: each output the
    # call does not write through the table's pointers stays different.
    for g in (0,) + CLUSTER_SIZES:
        at = f"{where}, {g or chosen} blocks a row"
        g_io = chunk_from_t(io.scores[t:].contiguous())
        for x, r in zip(g_io.outs, ref):
            x[0].copy_(bit_complement(r))
        g_slots, g_local = ShardSlots(B, K, V_, st.states.device), clone(local)
        frame_start_shard(g_slots, g_io)
        frame_tail_shard(g_slots, clone(cutoff), clone(tin), slot_base, clusters=g,
                         local=g_local)
        torch.cuda.synchronize()
        same_fields(final, g_slots.state, "K3's shard mode (state)", at)
        same_fields(ref, type(ref)(*(x[0] for x in g_io.outs)), "K3's shard mode (outputs)", at)
        same_fields(nxt, g_local, "K3's shard mode (the next frame's local half)", at)
        if t + 1 < T and not torch.equal(io.scores[t + 1], g_slots.scores_t):
            raise AssertionError(f"K3's shard mode on {at}: the next scores row")
        if g_slots.args[:3].tolist() != [1, 0, T - t]:
            raise AssertionError(f"K3's shard mode on {at}: t, the count and the frame count "
                                 f"{g_slots.args[:3].tolist()}")
    # Timed on a chunk of its own of 64 frames from frame t's state (its
    # scores the chunk's from t), into outputs of 64 rows (the calls timed
    # are fewer), begun again for each timing.
    rows = io.scores[t:]
    t_io = chunk_from_t(rows.repeat(-(-64 // rows.shape[0]), 1, 1)[:64].contiguous())
    t_slots, t_local = ShardSlots(B, K, V_, st.states.device), clone(local)

    def begun(fn):
        frame_start_shard(t_slots, t_io)
        return fn

    tk = time_kernel(
        f"K3 shard mode at {where} (B={B}, K {K}, {'lattice' if lattice else '1-best'}, "
        f"{chosen} blocks a row, K8's local half folded in, m {m}, the next scores row)",
        begun(lambda: frame_tail_shard(t_slots, cutoff, tin, slot_base, local=t_local)),
        lambda: frame_tail_shard_plain(st, cutoff, tin, fa, slot_base, local),
        k3_shard_work(tin, fa, local, V_))
    tk["clusters"], tk["ms_by_clusters"] = chosen, {}
    for g in CLUSTER_SIZES:
        tk["ms_by_clusters"][g] = device_ms(begun(
            lambda: frame_tail_shard(t_slots, cutoff, tin, slot_base, clusters=g,
                                     local=t_local)))
    tk["share_by_clusters"] = {g: tk["bound_ms"] / ms for g, ms in tk["ms_by_clusters"].items()}
    # Beside it, what the fold replaced: the same call without the local
    # half, and K8's local half as a launch of its own on the new costs.
    tk["alone_ms"] = device_ms(begun(
        lambda: frame_tail_shard(t_slots, cutoff, tin, slot_base)))
    l_out = empty_cutoff_local(B, m, st.states.device)
    tk["k8_local_ms"] = device_ms(lambda: global_cutoff_local(final.costs, m, out=l_out))
    tk["fold_ms"] = tk["ms"] - tk["alone_ms"]
    log(f"    chosen {chosen} blocks a row; at 8, 4, 2, 1: device ms (share of the bound) "
        + ", ".join(f"{g}: {ms:.4f} ({tk['share_by_clusters'][g]:.1%})"
                    for g, ms in tk["ms_by_clusters"].items()) + ", each equal to plain; "
        f"without the local half {tk['alone_ms']:.4f} ms (the fold {tk['fold_ms']:+.4f}), "
        f"K8's local half alone on the new costs {tk['k8_local_ms']:.4f}")
    times["k3_shard"] = tk
    errs["k3_shard"] = 0.0
    # K3's shard mode's first-frame mode, once a chunk: the chunk's start.
    (slots0, io0), _ = kept["frame_start_shard", 0]
    want = frame_start_shard_plain(io0)
    got = slots0.copy()
    frame_start_shard(got, io0)
    torch.cuda.synchronize()
    same_fields(want.state, got.state, "K3's shard first-frame mode (state)",
                f"{tag}, the chunk's start")
    if not (torch.equal(want.lengths, got.lengths) and torch.equal(want.scores_t, got.scores_t)
            and got.args.tolist() == want.args.tolist()):
        raise AssertionError(f"K3's shard first-frame mode differs from plain on {tag}: the "
                             "lengths, scores row or table")
    times["k3_start_shard"] = time_kernel(
        f"K3 shard first-frame mode at {tag}, the chunk's start (B={B}, K {K}, V {V_}, "
        f"{io0.scores.shape[0]} frames)", lambda: frame_start_shard(got, io0),
        lambda: frame_start_shard_plain(io0), k3_start_shard_work(io0))
    errs["k3_start_shard"] = 0.0
    # K8's local half runs once a chunk, on the chunk's start state.
    (costs, m), kw = kept["global_cutoff_local", 0]
    out = kw.get("out")
    own = out is None or out.prefix is not None  # a prefix of its own, or the costs
    ref = global_cutoff_local_plain(costs.cpu(), m)
    if not own:
        ref = ref._replace(prefix=None)
    got = global_cutoff_local(costs, m, out=out)
    torch.cuda.synchronize()
    same_fields(ref, to_cpu(got), "K8's local half", f"{tag}, the chunk's start")
    times["k8_local"] = time_kernel(
        f"K8 local half at {tag}, the chunk's start (B={costs.shape[0]}, K {costs.shape[1]}, "
        f"m {m}{'' if own else ', no prefix of its own'})",
        lambda: global_cutoff_local(costs, m, out=out),
        lambda: global_cutoff_local_plain(costs, m), k8_local_work(costs, m if own else 0))
    args, kw = kept["global_cutoff_merge", SHARD_FRAME]
    out = kw["out"]
    best, merged = args[0], args[2]
    ref = global_cutoff_merge_plain(*(x.cpu() if torch.is_tensor(x) else x for x in args))
    got = global_cutoff_merge(*args, out=out)
    torch.cuda.synchronize()
    same_fields(ref, type(got)(*(x.cpu() for x in got)), "K8's merge", where)
    shape = (f"P {merged.shape[0]}, m {merged.shape[2]}" if merged is not None
             else "the early return")
    times["k8_merge"] = time_kernel(
        f"K8 merge at {where} (B={best.shape[0]}, {shape}, max_active {args[5]}, "
        f"min_active {args[6]})", lambda: global_cutoff_merge(*args, out=out),
        lambda: global_cutoff_merge_plain(*args), k8_merge_work(*args))
    errs["k8_local"] = errs["k8_merge"] = 0.0
    return errs, times


def profiled_device_ms(fn, top=6):
    """One run of ``fn`` under the profiler: its device milliseconds in
    kernels and in copies (a gloo exchange stages through the host), the
    ``top`` activities by device time [(name, ms, count)] (all with
    None), and the run's wall seconds (profiled)."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name][1] += 1
    copies = sum(ms for name, (ms, _) in by_name.items() if is_copy(name))
    kernels = sum(ms for ms, _ in by_name.values()) - copies
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return kernels, copies, [(name[:60], ms, n) for name, (ms, n) in ranked], wall


def is_copy(name):
    """True for a copy's or a fill's device activity: a memcpy or memset
    (``Memcpy DtoD``; inside a replayed CUDA graph its copy nodes run as
    ``memcpy32_post``, ``memcpy128`` and the like)."""
    return name.lower().startswith(("memcpy", "memset"))


def port_kernel_names(root):
    """The names of the ``__global__`` functions of the port's CUDA
    sources under ``root``."""
    import glob
    import re

    names = set()
    for src in glob.glob(os.path.join(root, "kaldi_decoder_tpu_torch", "csrc", "*.cu*")):
        with open(src) as f:
            names.update(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)", f.read()))
    return names


def activity_split(acts, kernel_names):
    """A profiled run's device activities ``acts`` [(name, ms, count)]
    grouped: the port's kernels (a name of ``kernel_names``), collectives
    and copies (NCCL's kernels, memcpy and memset), other.  Returns
    {group: (ms, count, [(name, count), ...])}."""
    import re

    out = {g: [0.0, 0, []] for g in ("port_kernels", "collectives_copies", "other")}
    for name, ms, cnt in acts:
        if any(re.search(rf"\b{k}\b", name) for k in kernel_names):
            g = "port_kernels"
        elif is_copy(name) or "nccl" in name.lower():
            g = "collectives_copies"
        else:
            g = "other"
        out[g][0] += ms
        out[g][1] += cnt
        out[g][2].append((name, cnt))
    return {g: tuple(v) for g, v in out.items()}


def shard_reference(scores, lengths, refs):
    """The JAX sharded decoders' reference and the workload cut to its
    frames, after checking that the cut workload is the reference's."""
    import numpy as np

    with open(os.path.join(REPO, "tests", "data", "torch_port_shard_ref.json")) as f:
        sref = json.load(f)
    F = sref["workload"]["frames"]
    if F != SHARD_FRAMES or sref["requested"] != dict(SHARD_CONFIG, lattice_beam=SHARD_LATTICE_BEAM):
        raise AssertionError("the shard reference was made for another cut or config")
    sc = np.ascontiguousarray(scores[:, :F])
    sl = np.minimum(lengths, F).astype(np.int32)
    for part in sref["parts"].values():
        check_workload(part["viterbi"][:B], sc, sl, refs)
        check_workload(part["lattice"][:B], sc, sl, refs)
    return sref, sc, sl


def shard_path(kind, graph, sc, sl, refs, sref, P, rank):
    """Phase 12 (``kind`` "viterbi") or 13 ("lattice"): the sharded decoder
    on a ``("model",)`` mesh of the P ranks, counted (kernel launches,
    collectives and the frames replayed: under NCCL every frame but the
    sharded frame driver's first, over gloo none), checked against the JAX
    reference on this rank's whole result; then a profiled run for the
    device time; under NCCL the frame replayed from the driver's graph
    against the host loop (``loop_walls``); then a decode as the host
    loop (``driver.eager_frames``), whose calls of frame SHARD_FRAME (and
    the chunk's first-frame mode) rank 0 holds against their plain
    versions.  Returns (launch counts, the phase's numbers, kernel errors,
    kernel times)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch import config_for_graph
    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.parallel import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
        make_mesh,
    )
    from kaldi_decoder_tpu_torch.parallel import graph_shard
    from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

    what = f"phase {12 if kind == 'viterbi' else 13} (P={P})"
    want = sref["parts"][str(P)]
    mesh = make_mesh(P, "model", device_type="cuda")
    fc = config_for_graph(graph, **SHARD_CONFIG)
    if kind == "viterbi":
        dec = ShardedViterbiDecoder(graph, fc, mesh=mesh, pad_time_to=SHARD_FRAMES, device="cuda")
        sh = dec.cfg
    else:
        dec = ShardedLatticeDecoder(graph, fc, lattice_beam=SHARD_LATTICE_BEAM, mesh=mesh,
                                    pad_time_to=SHARD_FRAMES, device="cuda")
        sh = dec.cfg.shard
    got_cfg = dict({k: getattr(sh.frontier, k) for k in want["shard_config"]
                    if hasattr(sh.frontier, k)}, num_parts=sh.num_parts, part_size=sh.part_size,
                   route_cap=sh.route_cap, eps_route_cap=sh.eps_route_cap)
    if kind == "lattice":
        got_cfg.update(em_records=dec.cfg.em_records, eps_records=dec.cfg.eps_records,
                       lattice_beam=dec.cfg.lattice_beam)
    if got_cfg != {k: want["shard_config"][k] for k in got_cfg}:
        raise AssertionError(f"{what}: shard config {got_cfg} != the reference's "
                             f"{want['shard_config']}")
    D = sh.frontier.eps_iters
    kname = "dedup_select" if kind == "viterbi" else "dedup_select_rec"
    graphed = dist.get_backend(dec._sh.group) == "nccl"
    dist.barrier()
    reset_counts()
    collective_calls.clear()
    t0 = time.perf_counter()
    with CallCapture(graph_shard, {"sharded_chunk": {0}}) as chunk:  # for loop_walls
        res = dec.decode(sc, sl)
    t_dec = time.perf_counter() - t0
    n = read_counts()
    coll = dict(collective_calls)
    replays = driver.replays
    frames = res.num_active.shape[0]
    k = "k6" if kind == "viterbi" else "k2"
    # The sharded frame driver's first decode: under NCCL its first frame
    # eagerly, then the capture, every later frame a replay (counted as the
    # launches and collectives the graph holds); over gloo the host loop.
    if replays != (frames - 1 if graphed else 0):
        raise AssertionError(f"{what}: {replays} frames replayed of {frames} "
                             f"({'NCCL' if graphed else 'gloo'})")
    # K3's shard mode and K8's merge once a frame, its first-frame mode and
    # K8's local half once a chunk (one a decode: each frame's local half
    # is K3's shard mode's last step); K7's send side and the dedup call
    # once an emitting call and an eps iteration, the eps step's shard mode
    # once an eps iteration, the start closure's included; K7's receive
    # side once an emitting call (an eps call reads the received buffer in
    # place).
    routes = D + frames * (1 + D)
    want_n = launch_counts(gather=0, k1=frames, k2=0, k4=0, k5=D + frames * D, k6=0,
                           eps_step=D + frames * D, k3=frames, k3_start=1, k7_send=routes,
                           k7_recv=frames, k8_local=1, k8_merge=frames)
    want_n[k] = routes
    if n != want_n:
        raise AssertionError(f"{what}: launch counts {n}, want {want_n}")
    # A frame's collectives: GetCutoff's MIN, SUM and all-gather, K1's MIN,
    # the route's all-to-all, per eps iteration an all-to-all and the MAX of
    # changed, the rebase's MIN, SUM and MAX; the start closure's eps
    # iterations; the results' gather.
    want_c = dict(all_to_all=routes, all_reduce_max=routes, all_reduce_min=3 * frames,
                  all_reduce_sum=2 * frames, all_gather=frames, all_gather_object=1)
    if coll != want_c:
        raise AssertionError(f"{what}: collectives {coll}, want {want_c}")
    t1 = time.perf_counter()
    for b, u in enumerate(want[kind][:B]):
        if kind == "viterbi":
            check_utterance(what, b, u, res.best_path(b), res.num_active[:, b],
                            res.best_costs[:, b], res.overflows[:, b], res.saturations[:, b])
        else:
            check_lattice_utterance(what, b, u, res.raw_lattice(b), res.best_path(b),
                                    res.stats(b), res.reached_final(b),
                                    res.final_relative_cost(b))
            if res.best_path_labels(b) != u["labels"]:
                raise AssertionError(f"{what}, utterance {b}: best_path_labels differ")
    if kind == "lattice":
        links = pruned_links(res._prune(0))
        if list(links) != [want["links0"]["count"], want["links0"]["sha256"]]:
            raise AssertionError(f"{what}: utterance 0's pruned links {links} != the "
                                 f"reference's {want['links0']}")
    t_host = time.perf_counter() - t1
    k_ms, c_ms, acts, t_prof = profiled_device_ms(lambda: dec.decode(sc, sl), top=None)
    names = port_kernel_names(REPO)
    split = activity_split(acts, names)
    ranked = acts[:6]
    # A frame runs the port's kernels, the collectives and copies only.
    stray = [(name, cnt / frames) for name, cnt in split["other"][2] if cnt >= frames]
    if stray:
        raise AssertionError(f"{what}: device activities a frame that are neither the port's "
                             f"kernels, collectives nor copies: {stray}")
    n_coll = sum(coll.values())
    wall_ms = t_dec * 1e3 / frames
    dev_ms = (k_ms + c_ms) / frames
    out = dict(P=P, decode_s=t_dec, host_s=t_host, frames=frames, wall_ms_per_frame=wall_ms,
               device_ms_per_frame=dev_ms, kernel_ms_per_frame=k_ms / frames,
               copy_ms_per_frame=c_ms / frames, busy=dev_ms / wall_ms,
               top_activities_ms_per_frame=[(name, ms / frames, cnt / frames)
                                            for name, ms, cnt in ranked],
               collectives=coll, collectives_per_frame=n_coll / frames,
               launches_per_frame=sum(n.values()) / frames,
               activities_per_frame=sum(v[1] for v in split.values()) / frames,
               split_per_frame={g: (ms / frames, cnt / frames)
                                for g, (ms, cnt, _) in split.items()},
               other_activities=split["other"][2],
               overflow_frames=int(res.overflows.sum()),
               saturated_frames=int(res.saturations.sum()))
    out["replays"] = replays
    log(f"{what}: decode {t_dec:.3f} s for {frames} frames ({wall_ms:.3f} ms a frame; "
        f"{replays} frames replayed from the sharded frame driver's captured graph), device "
        f"{dev_ms:.4f} ms a frame ({k_ms / frames:.4f} in kernels, {c_ms / frames:.4f} in "
        f"copies; profiled run, {t_prof:.3f} s), busy {out['busy']:.3f}; launches {n}; "
        f"collectives {coll} ({n_coll / frames:.2f} a frame, counted per replay); checks "
        f"{t_host:.2f} s; equal to the JAX reference on {B} utterances"
        + ("" if kind == "viterbi" else f" and utterance 0's {links[0]} pruned links"))
    log("  device time a frame by activity: " + "; ".join(
        f"{name} {ms:.4f} ms ({cnt:.1f} calls)" for name, ms, cnt in out["top_activities_ms_per_frame"]))
    log(f"  a frame: {out['launches_per_frame']:.2f} launches of the port's kernels; "
        f"{out['activities_per_frame']:.2f} device activities: " + "; ".join(
            f"{g} {cnt:.2f} ({ms:.4f} ms)" for g, (ms, cnt) in out["split_per_frame"].items())
        + "; other activities, each under once a frame: " + ("; ".join(
            f"{name} ({cnt / frames:.2f} a frame)" for name, cnt in split["other"][2])
            or "none"))
    if graphed:
        # The chunk's frames replayed from the graph against the host loop, in
        # turns (the counted decode's chunk again: its first-frame mode, K8's
        # local half and frames); the graph's pool.
        args, _ = chunk.kept["sharded_chunk", 0]
        out["frame_loops"] = loop_walls(f"{what}, the sharded chunk",
                                        lambda: graph_shard.sharded_chunk(*args), frames)
        drv = graph_shard.frame_driver(kind == "lattice", dec._pg, dec.cfg, dec._sh, B, V,
                                       dec.device)
        out["frame_loops"]["graph_pool_bytes"] = drv.pool_bytes
        log(f"  {what}: the captured frame's memory pool: {drv.pool_bytes[0]} bytes allocated, "
            f"{drv.pool_bytes[1]} reserved")
    # The holds' inputs: a decode as the host loop (a captured frame's calls
    # do not pass through the wrappers' Python), its calls of frame
    # SHARD_FRAME and the chunk's first-frame mode kept.
    routed = {shard_call_index(SHARD_FRAME, D), shard_call_index(SHARD_FRAME, D, True)}
    # K7's receive side runs for the emitting calls alone (once a frame), K8's
    # local half once a chunk (the frames' own are K3's shard mode's last step).
    capture = {"expand_filter": {SHARD_FRAME}, kname: routed, "route_send": routed,
               "route_recv": {SHARD_FRAME}, "expand_eps_lanes": {D + SHARD_FRAME * D},
               "eps_step_shard": {D + SHARD_FRAME * D}, "frame_tail_shard": {SHARD_FRAME},
               "frame_start_shard": {0}, "global_cutoff_local": {0},
               "global_cutoff_merge": {SHARD_FRAME}}
    dist.barrier()
    t0 = time.perf_counter()
    with driver.eager_frames(), CallCapture(graph_shard, capture) as cap:
        dec.decode(sc, sl)
    out["decode_loop_s"] = time.perf_counter() - t0
    log(f"  {what}: decode {t_dec:.3f} s as the user calls it, {out['decode_loop_s']:.3f} s as "
        "the host loop (its calls of frame SHARD_FRAME kept, cloned)")
    errs, times = {}, {}
    if rank == 0:  # the other rank waits at the barrier: the card is this rank's alone
        errs, times = hold_shard_kernels(cap.kept, kind, D, f"P={P} {kind} shard 0")
    dist.barrier()
    del cap, chunk, res, dec
    torch.cuda.empty_cache()
    return n, out, errs, times


def hold_rank_kernels(dec, scores, lengths, rows, tag):
    """K1, K2 and K4 at the shapes of a data-parallel rank (its rows of
    the batch): K1 and K2 on the rank's frames K1_FRAMES and K2_FRAMES
    (:func:`hold_lattice_frames`), K4 on its first chunk (:func:`hold_k4`),
    each held against its plain version and timed, K1 and K2 on the frame
    where K2 takes the most records.  Returns ({kernel: max |err|},
    {kernel: time_kernel fields})."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_plain
    from kaldi_decoder_tpu_torch.kernels._build import kernels
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import (
        cluster_size,
        dedup_select_rec,
        stack_records,
    )
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

    scores_tm = torch.from_numpy(np.ascontiguousarray(scores[rows].transpose(1, 0, 2))).cuda()
    Bl = scores_tm.shape[1]
    fc = dec.cfg.frontier
    frames = sorted(set(K1_FRAMES + K2_FRAMES))
    k1_err, k2_err, seen, k1_args, k2_args = hold_lattice_frames(dec, scores_tm, set(frames), tag)
    N = k2_args[1].shape[1]
    log(f"K1 and K2 at {tag}'s shapes (B={Bl}, K={fc.frontier_size}, em_records "
        f"{dec.cfg.em_records}, N={N}; K1 clusters of {k1_clusters(fc, Bl)} blocks, K2 of "
        f"{cluster_size(Bl, N)}): equal to plain on the rank's frames {frames} ({seen}); "
        f"timed on frame {seen['at_frame']}:")
    times = {"k1": time_kernel(f"K1, {tag}", lambda: expand_filter(*k1_args),
                               lambda: expand_filter_plain(*k1_args), k1_work(*k1_args)),
             "k2": time_kernel(f"K2, {tag}", lambda: dedup_select_rec(*k2_args),
                               lambda: stack_records(dedup_select_rec_plain(*k2_args)),
                               k2_work(*k2_args))}
    k4_err, args, ref, got = hold_k4(dec, scores_tm, lengths[rows], f"K4 at {tag}")
    sc = args[5]
    C = kernels().kd_sweep_cluster(Bl, -(-sc.frontier_size // 4) * 4, sc.em_records)
    log(f"K4 at {tag}'s shapes: equal to plain on the rank's chunk 0 (T={CHUNK}, B={Bl}; "
        f"survivors tok {ref.tok_count.sum().item()}, em {ref.em_count.sum().item()}; clusters "
        f"of {C} blocks):")
    times["k4"] = time_kernel(f"K4, {tag}, one chunk", lambda: sweep_chunk(*args),
                              lambda: sweep_plain(*args), k4_work(*args[:5], got), reps=2)
    del ref, got, scores_tm
    torch.cuda.empty_cache()
    return dict(k1=k1_err, k2=k2_err, k4=float(k4_err)), times


def data_parallel_path(graph, scores, lengths, refs, ref, P, rank):
    """Phase 11: ``BatchedLatticeDecoder`` at phase 3's config on a
    ``("data",)`` mesh of the P ranks, each decoding its rows; checked as
    phase 3 (main_path) on this rank's whole result; then a profiled run
    for the device time; rank 0 holds K1, K2 and K4 at its rows' shapes.
    Returns (launch counts, numbers, kernel errors, kernel times)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.parallel import make_mesh
    from kaldi_decoder_tpu_torch.parallel.mesh import all_gather_object, collective_calls

    dec = BatchedLatticeDecoder(graph, config_for_graph(graph, **BENCH_CONFIG),
                                mesh=make_mesh(P, device_type="cuda"), device="cuda", **DECODER_KW)
    # The group's first collective creates its communicator: not in the
    # timed decode.
    all_gather_object(None, dec._rows.group)
    collective_calls.clear()
    t0 = time.perf_counter()
    n, t_dec = main_path(dec, scores, lengths, refs, ref)
    t_all = time.perf_counter() - t0
    coll = dict(collective_calls)
    k_ms, c_ms, _, t_prof = profiled_device_ms(
        lambda: dec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True))
    frames = n["k1"]
    out = dict(P=P, decode_s=t_dec, seconds=t_all, collectives=coll,
               wall_ms_per_frame=t_dec * 1e3 / frames,
               device_ms_per_frame=(k_ms + c_ms) / frames, kernel_ms_per_frame=k_ms / frames,
               copy_ms_per_frame=c_ms / frames)
    log(f"phase 11 (P={P}): rows {dec._rows.rows(B)} of {B} on this rank; decode (gather "
        f"included) {t_dec:.3f} s, {out['wall_ms_per_frame']:.3f} ms a frame; device "
        f"{out['device_ms_per_frame']:.4f} ms a frame ({out['kernel_ms_per_frame']:.4f} in "
        f"kernels; profiled run, {t_prof:.3f} s); collectives {coll} (none in the frame loop); "
        f"decode, gather and checks {t_all:.2f} s")
    rows = dec._rows.rows(B)
    sc_tm = torch.from_numpy(np.ascontiguousarray(
        scores[rows, :WALL_FRAMES].transpose(1, 0, 2))).cuda()
    rem, st0 = torch.from_numpy(lengths[rows]).cuda(), dec._init(rows.stop - rows.start)[0]
    out["frame_loops"] = loop_walls(
        f"phase 11 (P={P}) rank {rank}, its rows' chunk loop",
        lambda: lattice_chunk(dec._pg, sc_tm, rem, st0, dec.cfg, dec._dev_graph.num_states),
        WALL_FRAMES)
    errs, times = {}, {}
    if rank == 0:  # the other rank waits at the barrier: the card is this rank's alone
        errs, times = hold_rank_kernels(dec, scores, lengths, dec._rows.rows(B),
                                        f"phase 11 (P={P}) rank 0")
    dist.barrier()
    del dec
    torch.cuda.empty_cache()
    return n, out, errs, times


def parallel_phases(P, rank, workload=None):
    """Phases 11-13 on this rank of a group of P ranks (the default
    group, already made), on ``workload`` (bench_workload()'s, rebuilt
    when not given).  Returns {phase: (launches, numbers, kernel errors,
    kernel times)}."""
    graph, scores, lengths, refs = workload or bench_workload()
    ref = load_reference("torch_port_bench_ref.json", scores, lengths, refs)
    sref, sc, sl = shard_reference(scores, lengths, refs)
    out = {}
    t0 = time.perf_counter()
    out["data_parallel"] = data_parallel_path(graph, scores, lengths, refs, ref, P, rank)
    log(f"phase 11 (P={P}): {time.perf_counter() - t0:.1f} s")
    for phase, kind in ((12, "viterbi"), (13, "lattice")):
        t0 = time.perf_counter()
        out[f"shard_{kind}"] = shard_path(kind, graph, sc, sl, refs, sref, P, rank)
        log(f"phase {phase} (P={P}): {time.perf_counter() - t0:.1f} s")
    return out


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def parallel_rank(rank, port, queue):
    """One of phases 11-13's two ranks (a spawned process): both on
    ``cuda:0``, over a gloo group (NCCL refuses two ranks on one card),
    which stages each exchange through the host.  Puts (rank, "ok",
    results) or (rank, "error", traceback) on ``queue``."""
    global LOG_PREFIX
    LOG_PREFIX = f"[rank {rank}]"
    try:
        sys.path.insert(0, REPO)
        import torch

        from kaldi_decoder_tpu_torch.parallel import initialize_distributed, shutdown_distributed

        torch.cuda.set_device(0)
        initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                               rank=rank, world_size=2)
        try:
            out = parallel_phases(2, rank)
        finally:
            shutdown_distributed()
        queue.put((rank, "ok", out))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def run_parallel_ranks():
    """Phases 11-13 at P = 2: two spawned ranks on ``cuda:0`` over gloo.
    Returns each rank's results; raises if a rank fails or time runs out,
    and ends both processes either way."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=parallel_rank, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        deadline = time.time() + PARALLEL_TIMEOUT
        while len(results) < 2:
            try:
                rank, status, out = q.get(timeout=max(1.0, deadline - time.time()))
            except queue_mod.Empty:
                raise AssertionError(f"phases 11-13 at P=2: no result within "
                                     f"{PARALLEL_TIMEOUT} s") from None
            if status != "ok":
                raise AssertionError(f"phases 11-13 at P=2, rank {rank} failed:\n{out}")
            results[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"phases 11-13 at P=2: exit codes {[p.exitcode for p in procs]}")
    return [results[0], results[1]]


def run_parallel_nccl(workload):
    """Phases 11-13 at P = 1 in this process, over NCCL, on ``workload``."""
    import torch
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    torch.cuda.set_device(0)
    initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{free_port()}",
                           rank=0, world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, expected nccl")
        return parallel_phases(1, 0, workload)
    finally:
        shutdown_distributed()


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    import numpy as np

    from kaldi_decoder_tpu_torch import (
        BatchedLatticeDecoder,
        BatchedViterbiDecoder,
        config_for_graph,
    )
    from kaldi_decoder_tpu_torch.kernels import _build
    from kaldi_decoder_tpu_torch.native import host_library

    # 0. Device.
    kind = torch.cuda.get_device_name(0)
    if "H100" not in kind:
        raise AssertionError(f"expected an H100, found {kind}")
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, Python {sys.version.split()[0]}")

    # 1. Build.
    t0 = time.perf_counter()
    _build.kernels()
    t_cuda = time.perf_counter() - t0
    host_library()
    t_all = time.perf_counter() - t0
    log(f"build: CUDA kernels {t_cuda:.1f} s, host library {t_all - t_cuda:.1f} s")
    for line in _build.build_logs.get("kdtorch_kernels", "").splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())

    # 2. Kernels at bench shapes.
    t0 = time.perf_counter()
    graph, scores, lengths, refs = bench_workload()
    ref = load_reference("torch_port_bench_ref.json", scores, lengths, refs)
    vref = load_reference("torch_port_viterbi_ref.json", scores, lengths, refs)
    lref = load_reference("torch_port_lattice_eps_ref.json", scores, lengths, refs)
    with open(os.path.join(REPO, "tests", "data", "torch_port_recall_ref.json")) as f:
        rref = json.load(f)
    fc = config_for_graph(graph, **BENCH_CONFIG)
    dec = BatchedLatticeDecoder(graph, fc, device="cuda", **DECODER_KW)
    # The device config re-derives flat_group (ROADMAP Queue 3).
    if dec.cfg.frontier.flat_group != 4:
        raise AssertionError(f"device flat_group {dec.cfg.frontier.flat_group}, expected 4")
    log(f"workload: {graph.num_states} states, {graph.num_emitting_arcs} emitting + "
        f"{graph.num_eps_arcs} eps arcs; folded device graph "
        f"{dec._dev_graph.num_emitting_arcs} arcs; device config {dec.cfg.frontier}; "
        f"set-up {time.perf_counter() - t0:.1f} s")
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    rem = torch.from_numpy(lengths).cuda()
    k1_err, k1, states, k2_args = check_k1(dec, scores_tm)
    k2_err, k2_by_frame = check_k2(k2_args)
    k2 = k2_by_frame[K2_FRAMES[0]]
    del k2_args
    gat_err, gat, gat_packed = check_gather(dec, states)
    k4_err, k4 = check_k4(dec, scores_tm, lengths)
    k3 = {"lattice": check_k3("the lattice frame (phase 3)", True, dec._pg, dec.cfg,
                              dec._dev_graph.num_states, scores_tm[:CHUNK], rem,
                              dec._init(B)[0], K2_FRAMES[0])}
    udec = unfolded_lattice_decoder(graph)
    k2e_err, k2e_by_frame, eps_by_frame = check_k2_eps(udec, scores_tm)
    k4e_err, k4e = check_k4_eps(udec, scores_tm, lengths)
    k3["unfolded"] = check_k3("the unfolded lattice frame (phase 6)", True, udec._pg, udec.cfg,
                              udec._dev_graph.num_states, scores_tm[:CHUNK], rem,
                              udec._init(B)[0], K2_EPS_FRAMES[0])
    del udec
    vfc = config_for_graph(graph, **VITERBI_CONFIG)
    vdec = BatchedViterbiDecoder(graph, vfc, device="cuda")
    edec = BatchedViterbiDecoder(graph, vfc, fold=False, device="cuda")
    k6 = check_k6(vdec, edec, scores_tm)
    del edec
    k3["viterbi"] = check_k3("the 1-best frame (phase 4)", False, vdec._pg, vdec.cfg,
                             vdec._dev_graph.num_states, scores_tm[:CHUNK], rem,
                             vdec._init(B)[0], K6_FRAMES[-1])
    fd = streaming_decoder(graph, vref)
    sk = check_streaming_kernels(fd, scores_tm)
    one_call = torch.tensor([FRAMES_PER_CALL], dtype=torch.int32, device="cuda")
    fd.init_decoding()
    k3["streaming"] = check_k3("the streaming 1-best frame (phase 5)", False, fd._pg, fd._cfg,
                               fd._graph.num_states, scores_tm[:FRAMES_PER_CALL, :1], one_call,
                               fd._state, STREAM_FRAME)
    k2s_err, k2s = check_streaming_k2(streaming_lattice_decoder(graph, lref), scores_tm)
    ld = streaming_lattice_decoder(graph, lref)
    ld.init_decoding()
    k3["streaming_lattice"] = check_k3("the streaming lattice frame (phase 7)", True, ld._pg,
                                       ld._dev_cfg, ld._graph.num_states,
                                       scores_tm[:FRAMES_PER_CALL, :1], one_call, ld._state,
                                       STREAM_FRAME)
    del ld
    k1r_err, k2r_err, kr = check_recall_kernels(graph, scores_tm,
                                                range(rref["workload"]["frames"]))
    del states
    torch.cuda.empty_cache()

    # 3-7: each path's loop also measured replayed from the frame driver's
    # graph against the loop before the frame driver (loop_walls).
    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.decoders.viterbi import viterbi_chunk

    loops = {}
    sc_w = scores_tm[:WALL_FRAMES]

    # 3. Lattice path.
    n3, t3 = main_path(dec, scores, lengths, refs, ref)
    st0, S = dec._init(B)[0], dec._dev_graph.num_states
    loops["lattice"] = loop_walls("phase 3, the lattice chunk loop", lambda: lattice_chunk(
        dec._pg, sc_w, rem, st0, dec.cfg, S), WALL_FRAMES)
    loops["lattice"]["decode_s"] = {"graph": t3, "loop": eager_decode_s(
        lambda: dec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True))}
    pool = loops["lattice"]["graph_pool_bytes"] = graph_pool(True, dec._pg, dec.cfg, S, B)
    log(f"  phase 3 decode: {t3:.3f} s replayed from the graph (the counted run), "
        f"{loops['lattice']['decode_s']['loop']:.3f} s as the loop before the frame driver; the "
        f"captured frame's memory pool: {pool[0]} bytes allocated, {pool[1]} reserved")
    del dec
    torch.cuda.empty_cache()

    # 4. Batched 1-best path.
    vn, t4, _ = viterbi_path(vdec, scores, lengths, refs, vref)
    st0, S = vdec._init(B)[0], vdec._dev_graph.num_states
    loops["viterbi"] = loop_walls("phase 4, the 1-best chunk loop", lambda: viterbi_chunk(
        vdec._pg, sc_w, rem, st0, vdec.cfg, S), WALL_FRAMES)
    loops["viterbi"]["decode_s"] = {"graph": t4,
                                    "loop": eager_decode_s(lambda: vdec.decode(scores, lengths))}
    pool = loops["viterbi"]["graph_pool_bytes"] = graph_pool(False, vdec._pg, vdec.cfg, S, B)
    log(f"  phase 4 decode: {t4:.3f} s replayed from the graph (the counted run), "
        f"{loops['viterbi']['decode_s']['loop']:.3f} s as the loop before the frame driver; the "
        f"captured frame's memory pool: {pool[0]} bytes allocated, {pool[1]} reserved")
    del vdec, st0
    torch.cuda.empty_cache()

    # 5. Streaming API.
    sn, _ = streaming_path(fd, scores, vref)
    loops["streaming"] = loop_walls("phase 5, FasterDecoder on utterance 0",
                                    stream_run(fd, scores[0, :WALL_STREAM_FRAMES]),
                                    WALL_STREAM_FRAMES)
    pool = loops["streaming"]["graph_pool_bytes"] = graph_pool(
        False, fd._pg, fd._cfg, fd._graph.num_states, 1)
    log(f"  phase 5: the captured frame's memory pool: {pool[0]} bytes allocated, {pool[1]} "
        "reserved")
    del fd
    torch.cuda.empty_cache()

    # 6. Lattice path without folding (the device eps path).
    udec = unfolded_lattice_decoder(graph)
    un, _ = lattice_eps_path(udec, scores, lengths, refs, lref)
    st0, S = udec._init(B)[0], udec._dev_graph.num_states
    loops["lattice_unfolded"] = loop_walls(
        "phase 6, the unfolded lattice chunk loop",
        lambda: lattice_chunk(udec._pg, sc_w, rem, st0, udec.cfg, S), WALL_FRAMES)
    pool = loops["lattice_unfolded"]["graph_pool_bytes"] = graph_pool(True, udec._pg, udec.cfg,
                                                                      S, B)
    log(f"  phase 6: the captured frame's memory pool: {pool[0]} bytes allocated, {pool[1]} "
        "reserved")
    del udec, st0, sc_w, scores_tm
    torch.cuda.empty_cache()

    # 7. Streaming lattice API.
    ln = streaming_lattice_path(graph, scores, lref)
    fn, sln = ln["faster"][0], ln["simple"][0]
    loops["streaming_lattice"] = ln["faster"][2]
    torch.cuda.empty_cache()

    # 8. The graph file and the CLI.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cn, gio = graph_file_path(graph, scores, vref, lref, tmp)
    log(f"phase 8 (graph file and CLI): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 9. The CTC encoder into the lattice decoder.
    t0 = time.perf_counter()
    en, enc = encoder_path(graph, fc)
    log(f"phase 9 (encoder and its decode): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 10. Link recall.
    t0 = time.perf_counter()
    rn, rec = recall_path(graph, scores, rref)
    log(f"phase 10 (link recall): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # 11-13. Data parallel and the sharded decoders: P = 1 in this process
    # over NCCL, then P = 2 in two spawned ranks on cuda:0 over gloo.
    t0 = time.perf_counter()
    par = {1: [run_parallel_nccl((graph, scores, lengths, refs))]}
    torch.cuda.empty_cache()
    par[2] = run_parallel_ranks()
    log(f"phases 11-13: {time.perf_counter() - t0:.1f} s")

    later = {"lattice_unfolded": un, "faster_lattice": fn, "simple_lattice": sln,
             "cli_lattice": cn["lattice"][0], "cli_faster": cn["faster"][0], "encoder": en,
             "recall": rn}
    for P, ranks in par.items():  # a P = 2 path's launches are its two ranks' sum
        for phase in ranks[0]:
            later[f"{phase}_p{P}"] = {k: sum(r[phase][0][k] for r in ranks)
                                      for k in ranks[0][phase][0]}
    # Phase 2 at the data-parallel rank's and the shard shapes: rank 0's holds.
    sk_err = {}
    for P in par:
        for ph in ("data_parallel", "shard_viterbi", "shard_lattice"):
            for k, v in par[P][0][ph][2].items():
                sk_err[k] = max(sk_err.get(k, 0.0), v)

    def shard_times(kernel, phase, but=None):
        return {f"{f}_{phase}{sfx}_p{P}": par[P][0][phase][3][kernel + sfx][f]
                for P in par for sfx in ("", "_eps") if kernel + sfx in par[P][0][phase][3]
                and (P, phase, sfx) != but
                for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                          "wrapper_ms", "plain_wrapper_ms", "clusters", "ms_by_clusters",
                          "share_by_clusters")
                if f in par[P][0][phase][3][kernel + sfx]}

    def shard_entry(name, source, replaces, key, by, **extra):
        """A kernel of the sharded phases alone: its fields from P = 1's
        phase 12 (its emitting call), the other calls beside them."""
        first = (1, "shard_viterbi", "")
        t = par[1][0]["shard_viterbi"][3][by]
        return entry(name, source, replaces, key, t, sk_err[by],
                     **shard_times(by, "shard_viterbi", but=first),
                     **shard_times(by, "shard_lattice"), **extra)
    by_path = {
        "gather": {"lattice": n3["gather"], "viterbi": vn["gather"], "streaming": sn["gather"]},
        "k1": {"lattice": n3["k1"], "viterbi": vn["k1"], "streaming": sn["k1"]},
        "k2": {"lattice": n3["k2"]},
        "k3": {"lattice": n3["k3"], "viterbi": vn["k3"], "streaming": sn["k3"]},
        "k3_start": {"lattice": n3["k3_start"], "viterbi": vn["k3_start"],
                     "streaming": sn["k3_start"]},
        "k4": {"lattice": n3["k4"]},
        "k6": {"viterbi": vn["k6"], "streaming": sn["k6"]},
        "k5": {"lattice": n3["k5"], "viterbi": vn["k5"], "streaming": sn["k5"]},
        "eps_step": {"lattice": n3["eps_step"], "viterbi": vn["eps_step"],
                     "streaming": sn["eps_step"]},
        "eps_dedup": {"lattice": n3["eps_dedup"], "viterbi": vn["eps_dedup"],
                      "streaming": sn["eps_dedup"]},
        **{k: {"lattice": n3[k], "viterbi": vn[k], "streaming": sn[k]}
           for k in ("k7_send", "k7_recv", "k8_local", "k8_merge")},
    }
    # The sharded phases' eps steps and K3 launches (its first-frame mode's
    # too) are the shard modes'.
    shard_phases = [p for p in later if p.startswith("shard_")]
    for key, paths in by_path.items():
        paths.update({p: n[key] for p, n in later.items()
                      if key not in ("eps_step", "k3", "k3_start") or p not in shard_phases})
    by_path["eps_step_shard"] = {p: later[p]["eps_step"] for p in shard_phases}
    by_path["k3_shard"] = {p: later[p]["k3"] for p in shard_phases}
    by_path["k3_start_shard"] = {p: later[p]["k3_start"] for p in shard_phases}

    st = sk["times"]
    fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "share_of_bound",
              "wrapper_ms", "plain_wrapper_ms")

    def entry(name, source, replaces, key, t, err, **extra):
        return dict(name=name, route="cuda", source=f"kaldi_decoder_tpu_torch/csrc/{source}",
                    replaces=replaces, launches=sum(by_path[key].values()),
                    launches_by_path=by_path[key], max_abs_err=err,
                    **{f: t[f] for f in fields}, **extra)

    def eps_timed(kernel):
        """K5's or the eps step's timings at the shapes other than the
        unfolded lattice frame K2_EPS_FRAMES[0]'s, by where they were taken."""
        return {f"frame{t}": eps_by_frame[t][kernel] for t in K2_EPS_FRAMES[1:]} | {
            "streaming": sk[kernel], "streaming_init": sk[kernel + "_init"],
            "streaming_lattice": k2s[kernel]}

    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    for P, ranks in par.items():  # the sharded chunks' graph against the loop (NCCL only)
        for ph in ("shard_viterbi", "shard_lattice"):
            if "frame_loops" in ranks[0][ph][1]:
                loops[f"{ph}_p{P}"] = ranks[0][ph][1]["frame_loops"]
    log(json.dumps({"frame_loops": loops}))
    log(json.dumps({"graph_file": gio, "encoder": enc, "recall": rec,
                    "parallel": {f"{ph}_p{P}": [r[ph][1] for r in ranks]
                                 for P, ranks in par.items() for ph in ranks[0]}}))
    log(json.dumps({"kernels": [
        entry("row_gather (standalone, em_block row per frontier slot; folded into K1 on "
              "the paths)", "gather.cu", "scripts/gather_bench.py:139", "gather", gat, gat_err,
              launch_floor_ms=gat["launch_floor_ms"],
              ms_lane_packed=gat_packed["ms"], plain_ms_lane_packed=gat_packed["plain_ms"],
              wrapper_ms_streaming=st["gather"][0], plain_wrapper_ms_streaming=st["gather"][1]),
        entry("K1 expand_filter (row gather folded in + arc expansion + score lookup + "
              "beam filter)",
              "expand.cu", "kaldi_decoder_tpu/decoders/frontier.py:266", "k1", k1,
              max(k1_err, k6["k1_err"], sk["k1_err"], k1r_err, enc["kernel_errs"]["k1"],
                  sk_err["k1"]),
              **shard_times("k1", "data_parallel"), **shard_times("k1", "shard_viterbi"),
              **shard_times("k1", "shard_lattice"),
              ms_src_slot=k6["k1"]["ms"], plain_ms_src_slot=k6["k1"]["plain_ms"],
              bound_ms_src_slot=k6["k1"]["bound_ms"], ms_streaming=sk["k1"]["ms"],
              bound_ms_streaming=sk["k1"]["bound_ms"],
              **{f"{f}_recall": kr["k1"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                      "share_of_bound")},
              wrapper_ms_streaming=st["k1"][0], plain_wrapper_ms_streaming=st["k1"][1]),
        entry("K2 dedup_select_rec (lattice dedup by state + top-K + records; emitting and "
              "eps calls)", "dedup_rec.cu",
              "kaldi_decoder_tpu/ops/segment.py:177", "k2", k2,
              max(k2_err, k2e_err, k2s_err, k2r_err, enc["kernel_errs"]["k2"], sk_err["k2"],
                  sk_err.get("k2_eps", 0.0)),
              frame=K2_FRAMES[0], steps_us=k2["steps_us"], **shard_times("k2", "data_parallel"),
              **shard_times("k2", "shard_lattice"),
              **{f"{f}_frame{t}": k2_by_frame[t][f] for t in K2_FRAMES[1:]
                 for f in ("ms", "plain_ms", "bound_ms", "share_of_bound", "steps_us")},
              **{f"{f}_eps_frame{t}": k2e_by_frame[t][f] for t in K2_EPS_FRAMES
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                           "wrapper_ms", "plain_wrapper_ms")},
              **{f"{f}_streaming{sfx}": k2s[key][f] for key, sfx in (("em", ""), ("eps", "_eps"))
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                           "wrapper_ms", "plain_wrapper_ms")},
              **{f"{f}_recall_em{r}": kr[r][f] for r in RECALL_BUDGETS
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "frame",
                           "records")}),
        entry("K3 frame_tail (GetCutoff, rebase, freeze, each frame's outputs into the chunk's "
              "rows, the next frame's K1 inputs; the frame driver's tail, replayed from its "
              "captured CUDA graph)", "frame.cu",
              "kaldi_decoder_tpu/decoders/lattice_dev.py:394", "k3", k3["lattice"], 0.0,
              first_frame_launches=sum(by_path["k3_start"].values()),
              first_frame_launches_by_path=by_path["k3_start"],
              clusters=k3["lattice"]["clusters"], ms_by_clusters=k3["lattice"]["ms_by_clusters"],
              **{f"{f}_{p}": k3[p][f] for p in ("viterbi", "unfolded", "streaming",
                                                  "streaming_lattice")
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                           "wrapper_ms", "plain_wrapper_ms", "clusters", "ms_by_clusters")}),
        entry("K4 sweep_chunk (backward extra-cost sweep; with eps records, the eps Bellman)",
              "sweep.cu", "kaldi_decoder_tpu/decoders/sweep.py:141", "k4", k4,
              max(k4_err, k4e_err, enc["kernel_errs"]["k4"], sk_err["k4"]),
              **shard_times("k4", "data_parallel"),
              **{f"{f}_eps": k4e[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                              "share_of_bound", "wrapper_ms",
                                              "plain_wrapper_ms")}),
        entry("K6 dedup_select (Viterbi dedup by state + top-K + winning lane)", "dedup.cu",
              "kaldi_decoder_tpu/ops/segment.py:160", "k6", k6["k6"],
              max(k6["k6_err"], sk["k6_err"], sk_err["k6"], sk_err.get("k6_eps", 0.0)),
              **shard_times("k6", "shard_viterbi"),
              ms_eps=k6["eps"]["ms"], plain_ms_eps=k6["eps"]["plain_ms"],
              bound_ms_eps=k6["eps"]["bound_ms"],
              **{f"{f}{sfx}": t[f] for sfx, t in (
                  ("_streaming", sk["k6"]), ("_streaming_eps", sk["k6_eps"]))
                 for f in ("ms", "plain_ms", "bound_ms", "share_of_bound")},
              winners={"emitting": k6["k6"]["winners"], "eps": k6["eps"]["winners"],
                       "streaming": sk["k6"]["winners"] + sk["k6_eps"]["winners"]},
              wrapper_ms_streaming=st["k6"][0], plain_wrapper_ms_streaming=st["k6"][1],
              wrapper_ms_streaming_eps=st["k6_eps"][0],
              plain_wrapper_ms_streaming_eps=st["k6_eps"][1]),
        entry("K5 expand_eps_lanes (an eps iteration's candidate lanes: the incumbents, the "
              "eps block lanes and the remainder lanes through the owner map, under the cutoff)",
              "eps.cu", "kaldi_decoder_tpu/decoders/frontier.py:366", "k5",
              eps_by_frame[K2_EPS_FRAMES[0]]["k5"], 0.0, frame=K2_EPS_FRAMES[0],
              ms_by_blocks=eps_by_frame[K2_EPS_FRAMES[0]]["k5"]["ms_by_blocks"],
              ms_by_blocks_streaming=sk["k5"]["ms_by_blocks"],
              **{f"{f}_{key}": t[f] for key, t in eps_timed("k5").items()
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                           "wrapper_ms", "plain_wrapper_ms")},
              **shard_times("k5", "shard_viterbi"), **shard_times("k5", "shard_lattice")),
        entry("eps step (an eps iteration's closing step, the last step of its dedup call, "
              "K6 or K2's eps call: backpointers or records, changed, the running overflow and "
              "saturation, ran and the batch's go; timed as the whole call, dedup_alone_ms the "
              "same call without it, step_ms the difference)",
              "eps_step.cuh", "kaldi_decoder_tpu/decoders/frontier.py:530", "eps_dedup",
              eps_by_frame[K2_EPS_FRAMES[0]]["eps_step"], 0.0, frame=K2_EPS_FRAMES[0],
              standalone_launches_by_path={p: n for p, n in by_path["eps_step"].items()
                                           if p not in shard_phases},
              **{f: eps_by_frame[K2_EPS_FRAMES[0]]["eps_step"][f]
                 for f in ("dedup_alone_ms", "step_ms", "step_bound_ms")},
              **{f"{f}_{key}": t[f] for key, t in eps_timed("eps_step").items()
                 for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                           "wrapper_ms", "plain_wrapper_ms", "dedup_alone_ms", "step_ms",
                           "step_bound_ms")}),
        shard_entry("K7 route_send (the shard route's send side: the beam filter and payload "
                    "offsets, the stable (owner, state, cost) order, the local dedup or slack "
                    "keep, the within-owner places, the (P, B, cap, 4) send buffer, overflow; "
                    "a cluster of blocks a row)",
                    "route.cu", "kaldi_decoder_tpu/parallel/graph_shard.py:213", "k7_send",
                    "k7_send", **{f: par[1][0]["shard_viterbi"][3]["k7_send"][f]
                                  for f in ("clusters", "ms_by_clusters")}),
        shard_entry("K7 route_recv (the shard route's receive side: the received buffer as the "
                    "emitting dedup call's lanes; on an eps iteration folded into the dedup "
                    "call, which reads the incumbents and the received buffer in place through "
                    "common.cuh:routed_entry: its fields *_eps_*, that call with the fold, "
                    "dedup_alone_ms the same call on the lanes laid out, fold_ms the "
                    "difference)", "route.cu",
                    "kaldi_decoder_tpu/parallel/graph_shard.py:313", "k7_recv", "k7_recv",
                    **{f"{f}_eps_{ph}_p{P}": par[P][0][ph][3][k][f]
                       for P in par for ph, k in (("shard_viterbi", "k6_eps"),
                                                  ("shard_lattice", "k2_eps"))
                       if k in par[P][0][ph][3]
                       for f in ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound",
                                 "dedup_alone_ms", "fold_ms")}),
        shard_entry("eps step, shard mode (a sharded eps iteration's closing step: backpointers "
                    "or links, the batch-wide stop, the carry, the local changed, the frame's "
                    "local values; a cluster of blocks a row)", "eps.cu",
                    "kaldi_decoder_tpu/parallel/graph_shard.py:422", "eps_step_shard",
                    "eps_step_shard", **{f: par[1][0]["shard_viterbi"][3]["eps_step_shard"][f]
                                         for f in ("clusters", "ms_by_clusters",
                                                   "share_by_clusters")}),
        shard_entry("K3 frame_tail, shard mode (the sharded frame's rebase, freeze and outputs "
                    "into row t, and the next frame's local half of GetCutoff, K8's, from the "
                    "eps closure's local values; a cluster of blocks a row; alone_ms the same "
                    "call without the local half, k8_local_ms K8's local half as a launch of "
                    "its own on the new costs)", "frame.cu",
                    "kaldi_decoder_tpu/parallel/graph_shard.py:540", "k3_shard", "k3_shard",
                    **{f: par[1][0]["shard_viterbi"][3]["k3_shard"][f]
                       for f in ("clusters", "ms_by_clusters", "share_by_clusters")},
                    **{f"{f}_{ph}_p{P}": par[P][0][ph][3]["k3_shard"][f]
                       for P in par for ph in ("shard_viterbi", "shard_lattice")
                       for f in ("alone_ms", "k8_local_ms", "fold_ms")}),
        shard_entry("K3 frame_start_shard, the shard mode's first-frame mode (once a chunk: the "
                    "chunk's start state, row lengths and scores row 0 into the sharded frame "
                    "driver's static slots, its frame count, scores and output pointers into "
                    "K3's table, t 0; one block a row)", "frame.cu",
                    "kaldi_decoder_tpu/parallel/graph_shard.py:609", "k3_start_shard",
                    "k3_start_shard"),
        shard_entry("K8 global_cutoff_local (the sharded GetCutoff's local half: each row's "
                    "best cost, finite count and cost prefix, before the collectives; once a "
                    "chunk, on its start state: each frame's is K3's shard mode's last step)",
                    "cutoff.cu", "kaldi_decoder_tpu/parallel/graph_shard.py:447", "k8_local",
                    "k8_local"),
        shard_entry("K8 global_cutoff_merge (the sharded GetCutoff's merge: the order "
                    "statistics of the gathered prefixes without a sort, GetCutoff's branch "
                    "and the adaptive beam)", "cutoff.cu",
                    "kaldi_decoder_tpu/parallel/graph_shard.py:447", "k8_merge", "k8_merge"),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
