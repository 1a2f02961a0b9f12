#!/usr/bin/env python
"""Lattice-link recall of the torch port at bench scale.

The port-only counterpart of ``scripts/measure_recall.py`` (which imports
jax and ``bench``): one bench utterance (the cached 102,298-state HLG,
utterances rebuilt from the bench's seed as ``chip_smoke.bench_workload``
does), trimmed to ``--frames`` frames, decoded by the port's
``OracleLatticeDecoder`` on the host and by ``BatchedLatticeDecoder``
(``device_prune=False``) at each ``--budgets`` em_records, on
``--device``; the two lattices' link sets are compared
(``kaldi_decoder_tpu_torch.lattice.recall``).  The decoders are the
bench's, as ``chip_smoke.py`` phase 10 builds them (``recall_decoder``,
``recall_oracle``).  Imports nothing of jax.

Prints the card (or CPU) it ran on, one line for the oracle, then one
JSON line per budget:
  {"em_records": N, "recall": r, "device_links": .., "oracle_links": ..,
   "common_links": .., "extra": n, "overflow_frames": m,
   "saturated_frames": k, "best_path_match": true, "seconds": s}

    python3 scripts/measure_recall_torch.py --device cuda --frames 1000
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    CHUNK,
    RECALL_BUDGETS,
    bench_workload,
    recall_decoder,
    recall_oracle,
)
from kaldi_decoder_tpu_torch.lattice.recall import device_recall, oracle_lattice  # noqa: E402


def device_name(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("measure_recall_torch: no CUDA device; pass --device cpu")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--frames", type=int, default=1000, help="trim utterance 0 to this many frames")
    p.add_argument("--budgets", default=",".join(map(str, RECALL_BUDGETS)))
    args = p.parse_args()
    print(device_name(args.device), flush=True)
    graph, scores, lengths, _ = bench_workload()
    T = min(int(lengths[0]), args.frames)
    sc = scores[0, :T]
    olinks, olabels, secs = oracle_lattice(recall_oracle(graph), sc)
    print(json.dumps({"oracle_links": len(olinks), "frames": T,
                      "best_path_words": len(olabels or []), "seconds": secs}), flush=True)
    for r in (int(x) for x in args.budgets.split(",")):
        dec = recall_decoder(graph, r, args.device)
        print(json.dumps(device_recall(dec, sc, olinks, olabels, CHUNK)), flush=True)


if __name__ == "__main__":
    main()
