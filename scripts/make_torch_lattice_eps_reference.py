#!/usr/bin/env python
"""Write the JAX lattice decoders' reference results on the unfolded bench
graph, for the torch port's check on the card (``chip_smoke.py`` phases 6
and 7).

Runs of the JAX package on the CPU, on the bench's graph, seed and
utterances (``bench.py``), with the graph left unfolded so that the
device keeps its eps arcs and the lattice decoder's eps path runs (the eps
records of every frame's closure and of the start closure, and the
sweep's eps Bellman):

* ``batched``: ``BatchedLatticeDecoder(graph, config, fold=False,
  em_records=8192, lattice_beam=8, pad_time_to=500)`` with the bench
  config (beam 15, max_active 2560, min_active 200, K 4096, rem_budget
  49152), the first ``--utts`` utterances in one batch, chunks of 500
  frames, ``device_prune=False`` (the device sweep does not change the
  lattice, ``tests/test_sweep.py``);
* ``faster``: ``LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(
  beam=15, max_active=2560, min_active=200, lattice_beam=8))`` over the
  first ``--stream-utts`` utterances, ``advance_decoding`` 100 frames at
  a time, then ``finalize_decoding``;
* ``simple``: ``LatticeSimpleDecoder(graph, LatticeSimpleDecoderConfig(
  beam=15, lattice_beam=8)).decode`` of the first utterance.

Per utterance it records the 1-best output labels, the float32 bits of
the best path's total cost, ``num_active`` per frame, the overflow and
saturation counts, the raw lattice's state and arc counts, a sha256 of
its arcs in state order (src, dst, ilabel, olabel and the bits of the
two float32 weights, as int32) and one of its final weights' bits and
start state, ``reached_final`` and ``final_relative_cost`` (as
``float.hex``), with the transcript and a hash of the scores (so that a
rebuilt workload can be checked to be the same).  The lattice digest is
what shows the eps links: the labels alone would not.

    JAX_PLATFORMS=cpu python scripts/make_torch_lattice_eps_reference.py --utts 16
"""

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_lattice_eps_ref.json"
FRAMES_PER_CALL = 100
LATTICE_BEAM = 8.0


def utt_record(L, scores, refs_b, raw, best, stats, reached, frc):
    """One utterance's fields, as ``chip_smoke.check_lattice_utterance``
    reads them; the lattice digest is ``chip_smoke.lattice_digest``."""
    import numpy as np

    from chip_smoke import lattice_digest
    from kaldi_decoder_tpu.fst.ops import path_labels, path_total_cost

    n_states, n_arcs, arcs_sha, finals_sha = lattice_digest(raw)
    return {
        "length": L,
        "ref_words": [int(w) for w in refs_b],
        "scores_sha256": hashlib.sha256(scores[:L].tobytes()).hexdigest(),
        "olabels": [] if best is None else [int(x) for x in path_labels(best)],
        "path_cost_f32_bits": (None if best is None else
                               int(np.float32(path_total_cost(best)).view(np.int32))),
        "num_active": [int(x) for x in stats.active_per_frame[:L]],
        "overflow_frames": int(stats.arc_budget_overflows),
        "saturated_frames": int(stats.frontier_saturated_frames),
        "lattice_states": n_states,
        "lattice_arcs": n_arcs,
        "lattice_arcs_sha256": arcs_sha,
        "lattice_finals_sha256": finals_sha,
        "reached_final": bool(reached),
        "final_relative_cost": float(frc).hex(),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--stream-utts", type=int, default=2)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["KDTPU_BENCH_B"] = str(max(args.utts, args.stream_utts))
    sys.path.insert(0, str(REPO))
    import bench
    from kaldi_decoder_tpu.decodable import DecodableCtc
    from kaldi_decoder_tpu.decoders.frontier import config_for_graph
    from kaldi_decoder_tpu.decoders.lattice import (
        BatchedLatticeDecoder,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
        LatticeSimpleDecoder,
        LatticeSimpleDecoderConfig,
    )

    graph, scores, lengths, refs = bench.build_hlg_workload()
    kw = dict(beam=bench.BEAM, max_active=bench.MAX_ACTIVE, min_active=200)

    fc = config_for_graph(graph, frontier_size=bench.FRONTIER, rem_budget=bench.REM_BUDGET,
                          **kw)
    dec = BatchedLatticeDecoder(graph, fc, fold=False, em_records=bench.EM_RECORDS,
                                lattice_beam=LATTICE_BEAM, pad_time_to=bench.CHUNK_FRAMES)
    n = args.utts
    t0 = time.time()
    res = dec.decode(scores[:n], lengths[:n], chunk_frames=bench.CHUNK_FRAMES,
                     device_prune=False)
    t_dec = time.time() - t0
    batched = []
    for b in range(n):
        raw = res.raw_lattice(b)
        batched.append(utt_record(
            int(lengths[b]), scores[b], refs[b], raw, res.best_path(b), res.stats(b),
            res.reached_final(b), res.final_relative_cost(b)))
        batched[-1]["labels"] = res.best_path_labels(b)
    t_host = time.time() - t0 - t_dec

    t0 = time.time()
    faster = []
    for b in range(args.stream_utts):
        L = int(lengths[b])
        ld = LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(
            lattice_beam=LATTICE_BEAM, **kw))
        ld.init_decoding()
        decodable = DecodableCtc(scores[b, :L])
        while ld.num_frames_decoded() < L:
            ld.advance_decoding(decodable, max_num_frames=FRAMES_PER_CALL)
        ld.finalize_decoding()
        ok_raw, raw = ld.get_raw_lattice()
        ok, best = ld.get_best_path()
        assert ok and ok_raw
        faster.append(utt_record(L, scores[b], refs[b], raw, best, ld.stats(),
                                 ld.reached_final(), ld.final_relative_cost()))
    t_faster = time.time() - t0
    faster_cfg = ld._dev_cfg

    t0 = time.time()
    L = int(lengths[0])
    sd = LatticeSimpleDecoder(graph, LatticeSimpleDecoderConfig(beam=bench.BEAM,
                                                                lattice_beam=LATTICE_BEAM))
    sd.decode(DecodableCtc(scores[0, :L]))
    ok_raw, raw = sd.get_raw_lattice()
    ok, best = sd.get_best_path()
    assert ok and ok_raw
    simple = [utt_record(L, scores[0], refs[0], raw, best, sd.stats(), sd.reached_final(),
                         sd.final_relative_cost())]
    t_simple = time.time() - t0
    simple_cfg = sd._dev_cfg

    def cfg_dict(c):
        f = c.frontier
        return dict({k: getattr(f, k) for k in (
            "beam", "max_active", "min_active", "beam_delta", "frontier_size",
            "block_width", "rem_budget", "flat_group", "eps_block_width",
            "eps_rem_budget", "eps_iters", "eps_exact")},
            em_records=c.em_records, eps_records=c.eps_records, lattice_beam=c.lattice_beam)

    out = {
        "source": "JAX BatchedLatticeDecoder(fold=False), LatticeFasterDecoder and "
        "LatticeSimpleDecoder on the CPU (scripts/make_torch_lattice_eps_reference.py)",
        "workload": {
            "graph": f".bench_cache/hlg_v{bench.V}_w{bench.HLG_WORDS}_s{bench.SEED}.npz",
            "seed": bench.SEED, "T": bench.T, "V": bench.V,
            "note": "the first utterances of bench.py's batch, on the unfolded graph",
        },
        "batched": {
            "decoder": "BatchedLatticeDecoder(graph, config, fold=False, em_records="
            f"{bench.EM_RECORDS}, lattice_beam={LATTICE_BEAM}, pad_time_to="
            f"{bench.CHUNK_FRAMES}).decode(chunk_frames={bench.CHUNK_FRAMES}, "
            "device_prune=False)",
            "requested": dict(kw, frontier_size=bench.FRONTIER,
                              rem_budget=bench.REM_BUDGET),
            "chunk_frames": bench.CHUNK_FRAMES,
            "device_config": cfg_dict(dec.cfg),
            "utterances": n,
            "seconds": {"decode": t_dec, "host": t_host},
            "utts": batched,
        },
        "faster": {
            "decoder": "LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(...)), "
            f"advance_decoding(max_num_frames={FRAMES_PER_CALL}) until the utterance ends, "
            "finalize_decoding",
            "config": dict(kw, lattice_beam=LATTICE_BEAM),
            "frames_per_call": FRAMES_PER_CALL,
            "device_config": cfg_dict(faster_cfg),
            "utterances": args.stream_utts,
            "seconds": t_faster,
            "utts": faster,
        },
        "simple": {
            "decoder": "LatticeSimpleDecoder(graph, "
            "LatticeSimpleDecoderConfig(...)).decode",
            "config": dict(beam=bench.BEAM, lattice_beam=LATTICE_BEAM),
            "device_config": cfg_dict(simple_cfg),
            "utterances": 1,
            "seconds": t_simple,
            "utts": simple,
        },
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} ({n} batched utterances, CPU decode {t_dec:.1f} s + host "
          f"{t_host:.1f} s; {args.stream_utts} streamed, {t_faster:.1f} s; simple "
          f"{t_simple:.1f} s)")


if __name__ == "__main__":
    main()
