#!/usr/bin/env python
"""Write the JAX decoders' reference results on the CTC topology H, for
the torch port's check on the card (``chip_smoke.py`` phase 14).

H is ``ctc_topo(V)`` over the bench's V tokens (500 states, 250,000
emitting arcs, no eps arcs, so every decoder derives ``eps_iters`` 0).
The scores are the bench's utterances (``bench.py``: its seed, T <= 1000).
Runs of the JAX package on the CPU, with ``chip_smoke.py``'s phase-14
config (``H_CONFIG``, ``H_SHARD_CONFIG``, ``H_LATTICE_KW``,
``H_ROUTE_CAP``, ``H_SHARD_FRAMES``, ``H8_LATTICE_KW``, ``H8_FRAMES``,
``H8_ROUTE_CAP``):

* ``batched.viterbi``: ``BatchedViterbiDecoder(H, config).decode``;
* ``batched.lattice``: ``BatchedLatticeDecoder(H, config, **H_LATTICE_KW,
  pad_time_to=CHUNK).decode(chunk_frames=CHUNK, device_prune=False)`` (the
  device sweep does not change the lattice, ``tests/test_sweep.py``);
* ``parts[P]``, P in (1, 2), on a ``("model",)`` mesh of P CPU devices:
  ``ShardedViterbiDecoder`` and ``ShardedLatticeDecoder`` at the shard
  config, ``route_cap=H_ROUTE_CAP``, on the first ``H_SHARD_FRAMES``
  frames;
* ``lattice8``: both lattice decoders again at ``H8_LATTICE_KW`` (lattice
  beam 8, em_records 2^18) on the first ``H8_FRAMES`` frames, the batched
  one in one chunk of that length, the sharded ones with route buckets of
  ``H8_ROUTE_CAP``.

Per utterance it records what the other references record (1-best
labels, the float32 bits of the best path's cost, ``num_active`` per
frame, the overflow and saturation counts; the 1-best decodes a sha256 of
the per-frame best costs; the lattice decodes the raw lattice's size and
digests, ``reached_final`` and ``final_relative_cost``), and for
utterance 0 of each sharded lattice decode its pruned lattice's kept
links.  Every decode must show no overflow and no saturation, or the
script fails.

Each utterance is decoded alone (B = 1): per-utterance results do not
depend on the batch, and the decodes run ``--procs`` at a time.

    JAX_PLATFORMS=cpu python scripts/make_torch_h_reference.py --procs 6

``--only lattice8`` writes that section alone into the existing file.
"""

import argparse
import json
import multiprocessing as mp
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_h_ref.json"
PARTS = (1, 2)
KINDS = ("viterbi", "lattice")
SECTIONS = ("all", "lattice8")

_work = {}


def _setup():
    """The workload and the H graph, once a process."""
    if not _work:
        sys.path.insert(0, str(REPO))
        sys.path.insert(0, str(REPO / "scripts"))
        import bench
        from kaldi_decoder_tpu.fst import compile_fst, ctc_topo

        _, scores, lengths, refs = bench.build_hlg_workload()
        _work.update(bench=bench, graph=compile_fst(ctc_topo(bench.V)), scores=scores,
                     lengths=lengths, refs=refs)
    return _work


def cfg_dict(f):
    return {k: getattr(f, k) for k in (
        "beam", "max_active", "min_active", "beam_delta", "frontier_size", "block_width",
        "rem_budget", "flat_group", "eps_block_width", "eps_rem_budget", "eps_iters",
        "eps_exact")}


def run(job):
    """One decode of one utterance: ``job`` (where, kind, b, frames) with
    where "batched" or a part count, kind "viterbi", "lattice" or
    "lattice8" (the lattice decoder at ``H8_LATTICE_KW``), the scores cut
    to ``frames`` (None: the decode's own length).  Returns (job, its
    record, config, seconds)."""
    where, kind, b, frames = job
    w = _setup()
    import jax
    import numpy as np
    from jax.sharding import Mesh

    import chip_smoke as cs
    from kaldi_decoder_tpu.decoders.frontier import config_for_graph
    from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder
    from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder
    from kaldi_decoder_tpu.parallel.graph_shard import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
    )
    from make_torch_lattice_eps_reference import utt_record
    from make_torch_shard_reference import viterbi_record

    g = w["graph"]
    t0 = time.time()
    if where == "batched":
        F = frames or w["scores"].shape[1]
        fc = config_for_graph(g, **cs.H_CONFIG)
    else:
        F = frames or cs.H_SHARD_FRAMES
        fc = config_for_graph(g, **cs.H_SHARD_CONFIG)
        mesh = Mesh(np.array(jax.devices()[:where]), ("model",))
    scores = np.ascontiguousarray(w["scores"][b:b + 1, :F])
    lengths = np.minimum(w["lengths"][b:b + 1], F).astype(np.int32)
    L = int(lengths[0])
    cfg = None
    lattice_kw = cs.H8_LATTICE_KW if kind == "lattice8" else cs.H_LATTICE_KW
    chunk = F if kind == "lattice8" else cs.CHUNK
    route_cap = cs.H8_ROUTE_CAP if kind == "lattice8" else cs.H_ROUTE_CAP
    if kind == "viterbi":
        if where == "batched":
            dec = BatchedViterbiDecoder(g, fc)
            cfg = cfg_dict(dec.cfg)
        else:
            dec = ShardedViterbiDecoder(g, fc, mesh=mesh, route_cap=route_cap,
                                        pad_time_to=F)
        res = dec.decode(scores, lengths)
        rec = viterbi_record(res, 0, L, scores[0], w["refs"][b])
    else:
        if where == "batched":
            dec = BatchedLatticeDecoder(g, fc, pad_time_to=chunk, **lattice_kw)
            res = dec.decode(scores, lengths, chunk_frames=chunk, device_prune=False)
            cfg = dict(cfg_dict(dec.cfg.frontier), em_records=dec.cfg.em_records,
                       eps_records=dec.cfg.eps_records, lattice_beam=dec.cfg.lattice_beam)
        else:
            dec = ShardedLatticeDecoder(g, fc, mesh=mesh, route_cap=route_cap,
                                        pad_time_to=F, **lattice_kw)
            res = dec.decode(scores, lengths)
        rec = utt_record(L, scores[0], w["refs"][b], res.raw_lattice(0), res.best_path(0),
                         res.stats(0), res.reached_final(0), res.final_relative_cost(0))
        rec["labels"] = res.best_path_labels(0)
        if where != "batched" and b == 0:
            count, sha = cs.pruned_links(res._prune(0))
            rec["links0"] = {"count": count, "sha256": sha}
    if where != "batched":
        sc = dec.cfg if kind == "viterbi" else dec.cfg.shard
        cfg = dict(cfg_dict(sc.frontier), num_parts=sc.num_parts, part_size=sc.part_size,
                   route_cap=sc.route_cap, eps_route_cap=sc.eps_route_cap)
        if kind != "viterbi":
            cfg.update(em_records=dec.cfg.em_records, eps_records=dec.cfg.eps_records,
                       lattice_beam=dec.cfg.lattice_beam)
    if rec["overflow_frames"] or rec["saturated_frames"]:
        raise AssertionError(f"{job}: {rec['overflow_frames']} overflow and "
                             f"{rec['saturated_frames']} saturated frames")
    return job, rec, cfg, time.time() - t0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=None,
                    help="cut every decode to its first frames (a quick check of the script)")
    ap.add_argument("--out", default=str(OUT))
    ap.add_argument("--only", choices=SECTIONS, default="all",
                    help="lattice8: write that section alone into the existing --out")
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={max(PARTS)}")
    os.environ["KDTPU_BENCH_B"] = str(args.utts)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    n = args.utts
    # The longest decodes first: the batched lattice, then the rest.
    f = args.frames
    f8 = f or cs.H8_FRAMES
    jobs = ([("batched", "lattice8", b, f8) for b in range(n)]
            + [(P, "lattice8", b, f8) for P in PARTS for b in range(n)])
    if args.only == "all":
        jobs = ([("batched", "lattice", b, f) for b in range(n)]
                + [(P, "lattice", b, f) for P in PARTS for b in range(n)]
                + jobs
                + [("batched", "viterbi", b, f) for b in range(n)]
                + [(P, "viterbi", b, f) for P in PARTS for b in range(n)])
    got, cfgs, secs = {}, {}, {}
    t0 = time.time()
    with mp.get_context("spawn").Pool(args.procs, maxtasksperchild=8) as pool:
        for job, rec, cfg, s in pool.imap_unordered(run, jobs):
            got[job[:3]], secs[job[:3]] = rec, s
            cfgs.setdefault(job[:2], cfg)
            if cfgs[job[:2]] != cfg:
                raise AssertionError(f"{job}: config {cfg} != {cfgs[job[:2]]}")
            print(f"{job}: {s:.1f} s ({len(got)} of {len(jobs)}, {time.time() - t0:.0f} s)",
                  flush=True)

    def utts(where, kind):
        out = [got[where, kind, b] for b in range(n)]
        for u in out:
            u.pop("links0", None)
        return out

    def shard_config(P, *kinds):
        return dict(cfgs[P, kinds[0]], **{k: v for kind in kinds[1:]
                                          for k, v in cfgs[P, kind].items()
                                          if k not in cfgs[P, kinds[0]]})

    lattice8 = {
        "frames": f8,
        "requested": {"batched": dict(cs.H_CONFIG, **cs.H8_LATTICE_KW),
                      "shard": dict(cs.H_SHARD_CONFIG, **cs.H8_LATTICE_KW,
                                    route_cap=cs.H8_ROUTE_CAP)},
        "batched": {"lattice_config": cfgs["batched", "lattice8"],
                    "seconds": sum(secs["batched", "lattice8", b] for b in range(n)),
                    "lattice": utts("batched", "lattice8")},
        "parts": {str(P): {"shard_config": shard_config(P, "lattice8"),
                           "seconds": sum(secs[P, "lattice8", b] for b in range(n)),
                           "links0": got[P, "lattice8", 0]["links0"],
                           "lattice": utts(P, "lattice8")} for P in PARTS},
    }
    path = pathlib.Path(args.out)
    if args.only == "lattice8":
        out = json.loads(path.read_text())
        if out["workload"]["utterances"] != n or out["workload"]["frames"] != f:
            raise AssertionError(f"{path} holds another workload: {out['workload']}")
        out["lattice8"] = lattice8
        path.write_text(json.dumps(out, separators=(",", ":")) + "\n")
        print(f"wrote the lattice8 section of {path} in {time.time() - t0:.0f} s")
        return
    parts = {}
    for P in PARTS:
        links0 = got[P, "lattice", 0]["links0"]
        parts[str(P)] = {
            "shard_config": shard_config(P, "lattice", "viterbi"),
            "viterbi_route_cap": cfgs[P, "viterbi"]["route_cap"],
            "seconds": {k: sum(secs[P, k, b] for b in range(n)) for k in KINDS},
            "viterbi": utts(P, "viterbi"),
            "lattice": utts(P, "lattice"),
            "links0": links0,
        }
    bench = _setup()["bench"]
    out = {
        "source": "JAX BatchedViterbiDecoder, BatchedLatticeDecoder, ShardedViterbiDecoder "
        "and ShardedLatticeDecoder on the CPU (scripts/make_torch_h_reference.py)",
        "workload": {
            "graph": f"ctc_topo({bench.V})", "seed": bench.SEED, "T": bench.T, "V": bench.V,
            "utterances": n, "shard_frames": f or cs.H_SHARD_FRAMES, "frames": f,
            "note": "the bench's first utterances (bench.py), each decoded alone; the "
            "sharded decodes cut to their first shard_frames frames",
        },
        "requested": {"batched": dict(cs.H_CONFIG, **cs.H_LATTICE_KW),
                      "shard": dict(cs.H_SHARD_CONFIG, **cs.H_LATTICE_KW,
                                    route_cap=cs.H_ROUTE_CAP)},
        "batched": {
            "viterbi_config": cfgs["batched", "viterbi"],
            "lattice_config": cfgs["batched", "lattice"],
            "seconds": {k: sum(secs["batched", k, b] for b in range(n)) for k in KINDS},
            "viterbi": utts("batched", "viterbi"),
            "lattice": utts("batched", "lattice"),
        },
        "parts": parts,
        "lattice8": lattice8,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {path} in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
