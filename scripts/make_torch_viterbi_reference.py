#!/usr/bin/env python
"""Write the JAX 1-best decoders' reference results on the bench workload,
for the torch port's check on the card (``chip_smoke.py`` phases 4 and 5).

Two runs of the JAX package on the CPU, on the bench's graph, seed and
utterances (``bench.py``):

* ``viterbi``: ``BatchedViterbiDecoder(fold=True).decode`` of the first
  ``--utts`` utterances with the bench config (beam 15, max_active 2560,
  min_active 200, K 4096, rem_budget 49152);
* ``streaming``: ``FasterDecoder`` on the unfolded graph (so the device
  eps closure runs every frame) with ``FasterDecoderOptions(beam=15,
  max_active=2560, min_active=200)``, B = 1, over the first
  ``--stream-utts`` utterances, ``advance_decoding`` 100 frames at a time.

Per utterance it records the 1-best output labels, the float32 bits of
``path_total_cost`` of the best path, ``num_active`` per frame, a sha256
of the per-frame best costs (float32 bytes), the overflow and saturation
counts, the transcript and a hash of the scores (so that a rebuilt
workload can be checked to be the same).  Results per utterance do not
depend on the batch, and ``bench.py`` generates its first n utterances
identically for any batch size, so the first ``--utts`` utterances are a
prefix of the bench batch.

    JAX_PLATFORMS=cpu python scripts/make_torch_viterbi_reference.py --utts 16
"""

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_viterbi_ref.json"
FRAMES_PER_CALL = 100


def _utt_record(lat, L, scores, refs_b, num_active, best_costs, overflows, saturations):
    import numpy as np

    from kaldi_decoder_tpu.fst.ops import path_labels, path_total_cost

    return {
        "length": L,
        "ref_words": [int(w) for w in refs_b],
        "scores_sha256": hashlib.sha256(scores[:L].tobytes()).hexdigest(),
        "olabels": [int(x) for x in path_labels(lat)],
        "path_cost_f32_bits": int(np.float32(path_total_cost(lat)).view(np.int32)),
        "num_active": [int(x) for x in num_active[:L]],
        "best_costs_sha256": hashlib.sha256(
            np.ascontiguousarray(best_costs[:L], np.float32).tobytes()
        ).hexdigest(),
        "overflow_frames": int(np.sum(overflows[:L])),
        "saturated_frames": int(np.sum(saturations[:L])),
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
    from kaldi_decoder_tpu.decoders.api import FasterDecoder, FasterDecoderOptions
    from kaldi_decoder_tpu.decoders.frontier import config_for_graph
    from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder

    graph, scores, lengths, refs = bench.build_hlg_workload()
    kw = dict(beam=bench.BEAM, max_active=bench.MAX_ACTIVE, min_active=200)

    fc = config_for_graph(graph, frontier_size=bench.FRONTIER,
                          rem_budget=bench.REM_BUDGET, **kw)
    dec = BatchedViterbiDecoder(graph, fc, fold=True)
    n = args.utts
    t0 = time.time()
    res = dec.decode(scores[:n], lengths[:n])
    t_dec = time.time() - t0
    viterbi = []
    for b in range(n):
        viterbi.append(_utt_record(
            res.best_path(b), int(lengths[b]), scores[b], refs[b], res.num_active[:, b],
            res.best_costs[:, b], res.overflows[:, b], res.saturations[:, b],
        ))
    vc = dec.cfg

    t0 = time.time()
    streaming = []
    for b in range(args.stream_utts):
        L = int(lengths[b])
        fd = FasterDecoder(graph, FasterDecoderOptions(**kw))
        fd.init_decoding()
        decodable = DecodableCtc(scores[b, :L])
        while fd.num_frames_decoded() < L:
            fd.advance_decoding(decodable, max_num_frames=FRAMES_PER_CALL)
        ok, lat = fd.get_best_path()
        assert ok
        r = fd._result()
        streaming.append(_utt_record(
            lat, L, scores[b], refs[b], r.num_active[:, 0], r.best_costs[:, 0],
            r.overflows[:, 0], r.saturations[:, 0],
        ))
    t_stream = time.time() - t0
    sc = fd._cfg

    def cfg_dict(c):
        return {f: getattr(c, f) for f in (
            "beam", "max_active", "min_active", "beam_delta", "frontier_size",
            "block_width", "rem_budget", "flat_group", "eps_block_width",
            "eps_rem_budget", "eps_iters", "eps_exact")}

    out = {
        "source": "JAX BatchedViterbiDecoder and FasterDecoder on the CPU "
        "(scripts/make_torch_viterbi_reference.py)",
        "workload": {
            "graph": f".bench_cache/hlg_v{bench.V}_w{bench.HLG_WORDS}_s{bench.SEED}.npz",
            "seed": bench.SEED,
            "T": bench.T, "V": bench.V,
            "note": "the first utterances of bench.py's batch; per-utterance "
            "results do not depend on the batch size",
        },
        "viterbi": {
            "decoder": "BatchedViterbiDecoder(graph, config, fold=True), pad_time_to 128",
            "requested": dict(kw, frontier_size=bench.FRONTIER,
                              rem_budget=bench.REM_BUDGET),
            "device_config": cfg_dict(vc),
            "utterances": n,
            "utts": viterbi,
        },
        "streaming": {
            "decoder": "FasterDecoder(graph, FasterDecoderOptions(...)) on the unfolded "
            f"graph, B = 1, advance_decoding(max_num_frames={FRAMES_PER_CALL}) until the "
            "utterance ends",
            "options": kw,
            "frames_per_call": FRAMES_PER_CALL,
            "device_config": cfg_dict(sc),
            "utterances": args.stream_utts,
            "utts": streaming,
        },
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} ({n} batched utterances, CPU decode {t_dec:.1f} s; "
          f"{args.stream_utts} streamed, {t_stream:.1f} s)")


if __name__ == "__main__":
    main()
