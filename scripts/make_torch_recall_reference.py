#!/usr/bin/env python
"""Write the JAX package's link recall on a bench utterance, for the torch
port's check on the card (``chip_smoke.py`` phase 10).

Runs ``scripts/measure_recall.py``'s measurement with the JAX package on
the CPU: utterance 0 of the bench workload (``bench.build_hlg_workload``)
trimmed to ``--frames`` frames, the JAX ``OracleLatticeDecoder``
(deterministic cutoff, max_active 2560, min_active 200, beam 15, lattice
beam 8, through ``CsrFstView``) against the JAX ``BatchedLatticeDecoder``
of ``bench.make_decoder`` (``device_prune=False``, chunks of 500) at each
em_records budget.  Per budget it records the recall (unrounded), the
device's, the oracle's and the common link counts, the extra links,
the overflow and saturated frames, whether the best paths match, and the
device config; plus the oracle's link count and best-path labels, and a
hash of the scores (so that a rebuilt workload can be checked).

    JAX_PLATFORMS=cpu python scripts/make_torch_recall_reference.py --frames 250
"""

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_recall_ref.json"
BUDGETS = (4096, 8192, 16384)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=250)
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["KDTPU_BENCH_B"] = "1"
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    import numpy as np

    import bench
    from _lattice_util import device_link_set, oracle_link_set
    from kaldi_decoder_tpu.decodable import DecodableCtc
    from kaldi_decoder_tpu.decoders.ref_lattice import OracleLatticeDecoder
    from kaldi_decoder_tpu.fst import path_labels
    from kaldi_decoder_tpu.fst.csr import CsrFstView

    graph, scores, lengths, refs = bench.build_hlg_workload()
    T = min(int(lengths[0]), args.frames)
    sc = np.ascontiguousarray(scores[0, :T])

    t0 = time.time()
    oracle = OracleLatticeDecoder(
        CsrFstView(graph), beam=bench.BEAM, lattice_beam=bench.LATTICE_BEAM,
        deterministic_cutoff=True, max_active=bench.MAX_ACTIVE, min_active=200,
    )
    oracle.decode(DecodableCtc(sc))
    olinks = oracle_link_set(oracle)
    olat = oracle.get_best_path()
    olabels = path_labels(olat) if olat is not None else None
    t_oracle = time.time() - t0

    budgets = []
    for r in BUDGETS:
        bench.EM_RECORDS = r
        dec = bench.make_decoder(graph)
        t0 = time.time()
        res = dec.decode(sc[None], np.array([T], np.int32), chunk_frames=bench.CHUNK_FRAMES,
                         device_prune=False)
        dlat = res.best_path(0)
        dlinks = device_link_set(res)
        st = res.stats(0)
        hit = len(olinks & dlinks)
        f = dec.cfg.frontier
        budgets.append({
            "em_records": r,
            "recall": hit / max(len(olinks), 1),
            "device_links": len(dlinks),
            "oracle_links": len(olinks),
            "common_links": hit,
            "extra": len(dlinks - olinks),
            "overflow_frames": int(st.arc_budget_overflows),
            "saturated_frames": int(st.frontier_saturated_frames),
            "best_path_match": bool(dlat is not None and path_labels(dlat) == olabels),
            "seconds": time.time() - t0,
            "device_config": dict({k: getattr(f, k) for k in (
                "beam", "max_active", "min_active", "beam_delta", "frontier_size",
                "block_width", "rem_budget", "flat_group", "eps_iters")},
                em_records=dec.cfg.em_records, lattice_beam=dec.cfg.lattice_beam),
        })
        print(json.dumps(budgets[-1]), flush=True)

    out = {
        "source": "JAX OracleLatticeDecoder and BatchedLatticeDecoder on the CPU "
        "(scripts/make_torch_recall_reference.py)",
        "workload": {
            "graph": f".bench_cache/hlg_v{bench.V}_w{bench.HLG_WORDS}_s{bench.SEED}.npz",
            "seed": bench.SEED, "utterance": 0, "frames": T, "V": bench.V,
            "scores_sha256": hashlib.sha256(sc.tobytes()).hexdigest(),
        },
        "oracle": {
            "links": len(olinks),
            "labels": None if olabels is None else [int(x) for x in olabels],
            "seconds": t_oracle,
        },
        "budgets": budgets,
    }
    OUT.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {OUT} (oracle {t_oracle:.1f} s)")


if __name__ == "__main__":
    main()
