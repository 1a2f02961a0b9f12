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

Phases (any failure raises, and the process exits non-zero):
  0. device: a CUDA card must be present; prints its ``nvidia-smi`` name
     and power limit;
  1. build: the CUDA kernels (the row gather ``csrc/gather.cu``, K1
     ``csrc/expand.cu``, K4 ``csrc/sweep.cu``) and the C++ host library,
     from the checkout's sources;
  2. kernels: K1 on real frontiers, the row gather on a real frontier's
     states (and on the lane-packed table of the TPU experiments), and K4
     on one real chunk at bench shapes, each held against its plain torch
     version (bitwise: every float operation on the path is an add,
     subtract, compare or min in the same order) and timed with CUDA
     events around the wrapper call (median of 10; host enqueue
     included);
  3. main path: ``BatchedLatticeDecoder.decode`` with the launch counters
     set to 0 just before; the row gather and K1 must launch once per
     frame and K4 once per chunk; the 1-best labels, per-frame ``num_active`` and overflow and
     saturation counts must equal the JAX reference
     (``tests/data/torch_port_bench_ref.json``); prints the WER and the
     decode's wall time.
The line before the last is a JSON object with each kernel's launches,
error and times; the last is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py
"""

import json
import os
import statistics
import subprocess
import sys
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
TIMING_REPS = 10


def log(*a):
    print(*a, flush=True)


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


def cuda_ms(fn, reps=TIMING_REPS):
    """Median milliseconds of ``fn`` on the current stream (CUDA events),
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


def float_bits_equal(a, b):
    import torch

    za = torch.where(a == 0, 0.0, a).view(torch.int32)
    zb = torch.where(b == 0, 0.0, b).view(torch.int32)
    return torch.equal(za, zb)


def check_k1(dec, scores_tm):
    """K1 against its plain version on the frontiers of real frames."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_frame_step_batched
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

    fc = dec.cfg.frontier
    S = dec._dev_graph.num_states
    st, _, _ = dec._init(B)
    active = torch.ones(B, dtype=torch.bool, device=dec.device)
    max_err, timed_args, overflowed = 0.0, None, 0
    for t in range(max(K1_FRAMES) + 1):
        if t in K1_FRAMES:
            cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active,
                             fc.beam_delta, costs_sorted=True)
            args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam,
                    scores_tm[t], dec._pg, fc)
            ref = expand_filter_plain(*args)
            got = expand_filter(*args)
            torch.cuda.synchronize()
            for name, r, g in zip(ref._fields, ref, got):
                same = float_bits_equal(r, g) if r.dtype == torch.float32 else torch.equal(r, g)
                if not same:
                    raise AssertionError(f"K1 differs from plain at frame {t}: {name}")
            fin = torch.isfinite(ref.cost)
            if fin.any():
                max_err = max(max_err, float((ref.cost[fin] - got.cost[fin]).abs().max()))
            overflowed += int(ref.overflow.sum())
            timed_args = args
        st, _ = lattice_frame_step_batched(st, scores_tm[t], active, dec._pg, dec.cfg, S)
    ms = cuda_ms(lambda: expand_filter(*timed_args))
    plain_ms = cuda_ms(lambda: expand_filter_plain(*timed_args))
    log(f"K1 expand (row gather + K1): equal to plain on frames {list(K1_FRAMES)} "
        f"(B={B}, lanes/utt={fc.num_candidates}, remainder overflows seen={overflowed}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (frame {max(K1_FRAMES)})")
    return max_err, ms, plain_ms, timed_args[0]


def check_gather(dec, states):
    """The row gather against plain indexing: em_block rows of a real
    frontier's B*K states (the main path's call, and the (B, 4096) row
    gather of the TPU experiments), and the group rows of the lane-packed
    (ceil(S/8), 128) table that two of them gathered from."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain

    em_block = dec._pg.em_block
    S, width = em_block.shape
    G, WID = 8, 16
    packed = torch.zeros((-(-S // G) * G, WID), dtype=torch.int32, device=em_block.device)
    packed[:S, :width] = em_block
    packed = packed.view(-1, G * WID)
    group_idx = torch.div(states, G, rounding_mode="floor").reshape(-1)
    max_err, times, rows = 0, {}, {}
    for name, table, idx in (("em_block", em_block, states), ("lane-packed", packed, group_idx)):
        got, want = row_gather(table, idx), row_gather_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"row gather differs from plain on the {name} table")
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        rows[name] = got
        times[name] = (cuda_ms(lambda: row_gather(table, idx)),
                       cuda_ms(lambda: row_gather_plain(table, idx)))
        log(f"row gather, {name} table {tuple(table.shape)}, {idx.numel()} rows: "
            f"equal to plain; kernel {times[name][0]:.4f} ms, plain {times[name][1]:.4f} ms")
    flat = states.reshape(-1)
    sub = rows["lane-packed"].view(-1, G, WID)[
        torch.arange(flat.numel(), device=flat.device), (flat % G).long(), :width]
    if not torch.equal(sub, rows["em_block"].view(-1, width)):
        raise AssertionError("lane-packed group rows do not hold the em_block rows")
    return (max_err,) + times["em_block"]


def check_k4(dec, scores_tm, lengths):
    """K4 against the plain sweep on the first real chunk."""
    import torch

    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk

    S = dec._dev_graph.num_states
    st0, _, _ = dec._init(B)
    rem = torch.from_numpy(lengths).to(dec.device)
    _, o = lattice_chunk(dec._pg, scores_tm[:CHUNK], rem, st0, dec.cfg, S)
    sc = sweep_config(dec.cfg, CHUNK)
    args = (o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem, sc, S)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    for name in ("tok_count", "em_count", "overflow"):
        if not torch.equal(getattr(ref, name), getattr(got, name)):
            raise AssertionError(f"K4 differs from plain: {name}")
    max_err = 0
    for b in range(B):
        for rows, count in (("tok_rows", "tok_count"), ("em_rows", "em_count")):
            n = int(getattr(ref, count)[b])
            r, g = getattr(ref, rows)[b, :n], getattr(got, rows)[b, :n]
            if not torch.equal(r, g):
                raise AssertionError(f"K4 differs from plain: {rows}[{b}]")
            if n:
                max_err = max(max_err, int((r.long() - g.long()).abs().max()))
    ms = cuda_ms(lambda: sweep_chunk(*args))
    plain_ms = cuda_ms(lambda: sweep_plain(*args))
    log(f"K4 sweep: equal to plain on chunk 0 (T={CHUNK}, B={B}; survivors tok "
        f"{ref.tok_count.sum().item()}, em {ref.em_count.sum().item()}); "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per chunk")
    del o, ref, got
    return float(max_err), ms, plain_ms


def load_reference(scores, lengths, refs):
    """The JAX reference, after checking that the rebuilt workload is the
    one it was computed on (lengths, transcripts, score hashes)."""
    import hashlib

    with open(os.path.join(REPO, "tests", "data", "torch_port_bench_ref.json")) as f:
        ref = json.load(f)
    for b, u in enumerate(ref["utts"][:B]):
        L = u["length"]
        if (L != int(lengths[b]) or u["ref_words"] != [int(w) for w in refs[b]]
                or u["scores_sha256"] != hashlib.sha256(scores[b, :L].tobytes()).hexdigest()):
            raise AssertionError(f"utterance {b}: the rebuilt workload differs from the reference's")
    return ref


def main_path(dec, scores, lengths, refs, ref):
    """The decode as a user calls it, counted; then checks against the
    JAX reference."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather
    from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
    from kaldi_decoder_tpu_torch.utils.wer import wer

    torch.cuda.synchronize()
    row_gather.launches = 0
    expand_filter.launches = 0
    sweep_chunk.launches = 0
    t0 = time.perf_counter()
    res = dec.decode(scores, lengths, chunk_frames=CHUNK, device_prune=True)
    t_dec = time.perf_counter() - t0
    gat, k1, k4 = row_gather.launches, expand_filter.launches, sweep_chunk.launches
    if res.survivors is None:
        raise AssertionError("the device sweep overflowed and the decode fell back")
    frames = res.num_active.shape[0]
    if gat != frames or k1 != frames or k4 != len(res.survivors):
        raise AssertionError(
            f"launch counts gather={gat}, K1={k1} (want {frames} each), "
            f"K4={k4} (want {len(res.survivors)})"
        )
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
        f"{t_host:.3f} s; row gather launches {gat}, K1 launches {k1}, K4 launches "
        f"{k4}; matches the JAX "
        f"reference on {len(ref['utts'][:B])} utterances; overflow frames "
        f"{int(res.overflows.sum())}, saturated frames {int(res.saturations.sum())}; {st}")
    return gat, k1, k4


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: FAILED: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    import numpy as np

    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.kernels import _build
    from kaldi_decoder_tpu_torch.native import host_library

    # 0. Device.
    kind = torch.cuda.get_device_name(0)
    if "H100" not in kind:
        raise AssertionError(f"expected an H100, found {kind}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
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
    ref = load_reference(scores, lengths, refs)
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
    k1_err, k1_ms, k1_plain, states = check_k1(dec, scores_tm)
    gat_err, gat_ms, gat_plain = check_gather(dec, states)
    k4_err, k4_ms, k4_plain = check_k4(dec, scores_tm, lengths)
    del scores_tm, states
    torch.cuda.empty_cache()

    # 3. Main path.
    gat_n, k1_n, k4_n = main_path(dec, scores, lengths, refs, ref)

    log(json.dumps({"kernels": [
        {"name": "row_gather (em_block row per frontier slot)",
         "route": "cuda", "source": "kaldi_decoder_tpu_torch/csrc/gather.cu",
         "replaces": "scripts/gather_bench.py:139",
         "launches": gat_n, "max_abs_err": gat_err, "ms": gat_ms, "plain_ms": gat_plain},
        {"name": "K1 expand_filter (arc expansion + score lookup + beam filter)",
         "route": "cuda", "source": "kaldi_decoder_tpu_torch/csrc/expand.cu",
         "replaces": "kaldi_decoder_tpu/decoders/frontier.py:266",
         "launches": k1_n, "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K4 sweep_chunk (backward extra-cost sweep)",
         "route": "cuda", "source": "kaldi_decoder_tpu_torch/csrc/sweep.cu",
         "replaces": "kaldi_decoder_tpu/decoders/sweep.py:141",
         "launches": k4_n, "max_abs_err": k4_err, "ms": k4_ms, "plain_ms": k4_plain},
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
