#!/usr/bin/env python
"""Write the JAX decoder's reference results on the bench workload, for
the torch port's check on the card (``chip_smoke.py``).

Decodes the bench's utterances (``bench.py``: the cached HLG, its config
and its seed) with the JAX ``BatchedLatticeDecoder`` on the CPU, with
``device_prune=False`` (the device sweep does not change the lattice,
``tests/test_sweep.py``, and the plain host prune needs no R x K sweep),
and writes ``tests/data/torch_port_bench_ref.json``: per utterance the
1-best word labels, ``num_active`` per frame and the overflow and
saturation counts, the transcript and a hash of the scores (so that a
rebuilt workload can be checked to be the same), plus the config.

Results per utterance do not depend on the batch, and ``bench.py``
generates its first n utterances identically for any batch size, so the
first ``--utts`` utterances are a prefix of the bench batch.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_reference.py --utts 16
"""

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_bench_ref.json"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["KDTPU_BENCH_B"] = str(args.utts)
    sys.path.insert(0, str(REPO))
    import numpy as np

    import bench

    graph, scores, lengths, refs = bench.build_hlg_workload()
    dec = bench.make_decoder(graph)
    t0 = time.time()
    res = dec.decode(scores, lengths, chunk_frames=bench.CHUNK_FRAMES, device_prune=False)
    t_dec = time.time() - t0
    utts = []
    for b in range(args.utts):
        L = int(lengths[b])
        utts.append(
            {
                "length": L,
                "labels": res.best_path_labels(b),
                "ref_words": [int(w) for w in refs[b]],
                "scores_sha256": hashlib.sha256(scores[b, :L].tobytes()).hexdigest(),
                "num_active": [int(x) for x in res.num_active[:L, b]],
                "overflow_frames": int(np.sum(res.overflows[:L, b])),
                "saturated_frames": int(np.sum(res.saturations[:L, b])),
            }
        )
    fc = dec.cfg.frontier
    out = {
        "source": "JAX BatchedLatticeDecoder on the CPU, device_prune=False "
        "(scripts/make_torch_port_reference.py)",
        "workload": {
            "graph": f".bench_cache/hlg_v{bench.V}_w{bench.HLG_WORDS}_s{bench.SEED}.npz",
            "seed": bench.SEED,
            "utterances": args.utts,
            "note": "the first utterances of bench.py's batch; per-utterance "
            "results do not depend on the batch size",
        },
        "config": {
            "T": bench.T, "V": bench.V, "beam": bench.BEAM,
            "max_active": bench.MAX_ACTIVE, "min_active": 200,
            "frontier_size": bench.FRONTIER, "rem_budget": bench.REM_BUDGET,
            "flat_group_requested": bench.FLAT_GROUP, "em_records": bench.EM_RECORDS,
            "eps_records": 1024, "lattice_beam": bench.LATTICE_BEAM,
            "chunk_frames": bench.CHUNK_FRAMES, "pad_time_to": bench.CHUNK_FRAMES,
            "device_config": {
                "frontier_size": fc.frontier_size, "block_width": fc.block_width,
                "rem_budget": fc.rem_budget, "flat_group": fc.flat_group,
                "expand_lanes": fc.expand_lanes, "num_candidates": fc.num_candidates,
                "em_records": dec.cfg.em_records, "eps_iters": fc.eps_iters,
            },
        },
        "utts": utts,
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {OUT} ({args.utts} utterances, CPU decode {t_dec:.1f} s)")


if __name__ == "__main__":
    main()
