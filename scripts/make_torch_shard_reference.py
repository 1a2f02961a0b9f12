#!/usr/bin/env python
"""Write the JAX sharded decoders' reference results on the unfolded bench
graph, for the torch port's check on the card (``chip_smoke.py`` phases 12
and 13).

Runs of the JAX package on the CPU, on the bench's graph, seed and
utterances (``bench.py``), cut to their first ``--frames`` frames, for
each number of parts P in (1, 2), on a ``("model",)`` mesh of P CPU
devices:

* ``viterbi``: ``ShardedViterbiDecoder(graph, config, mesh, pad_time_to=
  --frames).decode``;
* ``lattice``: ``ShardedLatticeDecoder(graph, config, lattice_beam=8,
  mesh, pad_time_to=--frames).decode``;

with the default route caps and record budgets and ``config`` the bench's
beam, max_active and min_active (15, 2560, 200) at ``frontier_size`` 2048
a shard and ``rem_budget`` 24576 a shard (half of the bench's 4096 and
49152, so P = 2 holds the bench's capacity).  The sharded decoders never
fold eps arcs.

Per utterance it records what ``make_torch_viterbi_reference.py`` and
``make_torch_lattice_eps_reference.py`` record (1-best labels, the float32
bits of the best path's cost, ``num_active`` per frame, the overflow and
saturation counts, and for the lattice the raw lattice's size and digests,
``reached_final`` and ``final_relative_cost``; the Viterbi decode also a
sha256 of the per-frame best costs), and for utterance 0 of the lattice
decode the count and a sha256 of its pruned lattice's kept links
(``chip_smoke.pruned_links``).

    JAX_PLATFORMS=cpu python scripts/make_torch_shard_reference.py --utts 16 --frames 250
"""

import argparse
import hashlib
import json
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_shard_ref.json"
PARTS = (1, 2)
SHARD_FRONTIER = 2048
SHARD_REM_BUDGET = 24576
LATTICE_BEAM = 8.0


def shard_config_kw(bench):
    """The requested config of every sharded decode (per shard)."""
    return dict(beam=bench.BEAM, max_active=bench.MAX_ACTIVE, min_active=200,
                frontier_size=SHARD_FRONTIER, rem_budget=SHARD_REM_BUDGET)


def viterbi_record(res, b, L, scores, refs_b):
    import numpy as np

    from kaldi_decoder_tpu.fst.ops import path_labels, path_total_cost

    lat = res.best_path(b)
    return {
        "length": L,
        "ref_words": [int(w) for w in refs_b],
        "scores_sha256": hashlib.sha256(scores[:L].tobytes()).hexdigest(),
        "olabels": None if lat is None else [int(x) for x in path_labels(lat)],
        "path_cost_f32_bits": (None if lat is None else
                               int(np.float32(path_total_cost(lat)).view(np.int32))),
        "num_active": [int(x) for x in res.num_active[:L, b]],
        "best_costs_sha256": hashlib.sha256(
            np.ascontiguousarray(res.best_costs[:L, b], np.float32).tobytes()).hexdigest(),
        "overflow_frames": int(np.sum(res.overflows[:L, b])),
        "saturated_frames": int(np.sum(res.saturations[:L, b])),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--frames", type=int, default=250)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={max(PARTS)}")
    os.environ["KDTPU_BENCH_B"] = str(args.utts)
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "scripts"))
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import bench
    from chip_smoke import pruned_links
    from kaldi_decoder_tpu.decoders.frontier import config_for_graph
    from kaldi_decoder_tpu.parallel.graph_shard import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
    )
    from make_torch_lattice_eps_reference import utt_record

    graph, scores, lengths, refs = bench.build_hlg_workload()
    n, F = args.utts, args.frames
    scores = np.ascontiguousarray(scores[:n, :F])
    lengths = np.minimum(lengths[:n], F).astype(np.int32)
    kw = shard_config_kw(bench)
    fc = config_for_graph(graph, **kw)

    def cfg_dict(f):
        return {k: getattr(f, k) for k in (
            "beam", "max_active", "min_active", "beam_delta", "frontier_size",
            "block_width", "rem_budget", "flat_group", "eps_block_width",
            "eps_rem_budget", "eps_iters", "eps_exact")}

    runs = {}
    for P in PARTS:
        mesh = Mesh(np.array(jax.devices()[:P]), ("model",))
        vdec = ShardedViterbiDecoder(graph, fc, mesh=mesh, pad_time_to=F)
        t0 = time.time()
        vres = vdec.decode(scores, lengths)
        t_v = time.time() - t0
        viterbi = [viterbi_record(vres, b, int(lengths[b]), scores[b], refs[b])
                   for b in range(n)]
        t_vh = time.time() - t0 - t_v

        ldec = ShardedLatticeDecoder(graph, fc, lattice_beam=LATTICE_BEAM, mesh=mesh,
                                     pad_time_to=F)
        t0 = time.time()
        lres = ldec.decode(scores, lengths)
        t_l = time.time() - t0
        lattice = []
        for b in range(n):
            lattice.append(utt_record(
                int(lengths[b]), scores[b], refs[b], lres.raw_lattice(b), lres.best_path(b),
                lres.stats(b), lres.reached_final(b), lres.final_relative_cost(b)))
            lattice[-1]["labels"] = lres.best_path_labels(b)
        count, sha = pruned_links(lres._prune(0))
        t_lh = time.time() - t0 - t_l
        sc = ldec.cfg.shard
        runs[str(P)] = {
            "shard_config": dict(cfg_dict(sc.frontier), num_parts=sc.num_parts,
                                 part_size=sc.part_size, route_cap=sc.route_cap,
                                 eps_route_cap=sc.eps_route_cap,
                                 em_records=ldec.cfg.em_records,
                                 eps_records=ldec.cfg.eps_records,
                                 lattice_beam=ldec.cfg.lattice_beam),
            "seconds": {"viterbi": t_v, "viterbi_host": t_vh, "lattice": t_l,
                        "lattice_host": t_lh},
            "viterbi": viterbi,
            "lattice": lattice,
            "links0": {"count": count, "sha256": sha},
        }
        print(f"P={P}: viterbi {t_v:.1f} s + {t_vh:.1f} s, lattice {t_l:.1f} s + "
              f"{t_lh:.1f} s", flush=True)

    out = {
        "source": "JAX ShardedViterbiDecoder and ShardedLatticeDecoder on the CPU "
        "(scripts/make_torch_shard_reference.py)",
        "workload": {
            "graph": f".bench_cache/hlg_v{bench.V}_w{bench.HLG_WORDS}_s{bench.SEED}.npz",
            "seed": bench.SEED, "T": bench.T, "V": bench.V, "frames": F, "utterances": n,
            "note": "the first utterances of bench.py's batch, cut to their first "
            "`frames` frames, on the unfolded graph",
        },
        "requested": dict(kw, lattice_beam=LATTICE_BEAM),
        "decoders": f"ShardedViterbiDecoder(graph, config, mesh=Mesh(devices[:P], "
        f"('model',)), pad_time_to={F}); ShardedLatticeDecoder(graph, config, "
        f"lattice_beam={LATTICE_BEAM}, mesh=..., pad_time_to={F})",
        "parts": runs,
    }
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
