#!/usr/bin/env python
"""Write the JAX decoders' reference results on Hm, k2's modified CTC
topology, for the torch port's check on the card (``chip_smoke.py``
phase 15).

Hm is ``ctc_topo(V, modified=True)`` over the bench's V tokens (500
states, 999 emitting and 499 eps arcs, eps depth 1).  The scores are the
bench's utterances (``bench.py``: its seed, T <= 1000), each at full
length.  Runs of the JAX package on the CPU, at ``chip_smoke.py``'s
phase-15 config (``HM_CONFIG``, ``HM_LATTICE_KW``, ``HM_ROUTE_CAP``,
``HM_SHARD_FRAMES``, ``STREAM_OPTIONS``, ``HM_STREAM_UTTS``):

* ``batched.viterbi``: ``BatchedViterbiDecoder(Hm, config).decode`` (folded,
  the default: eps_iters 0);
* ``batched.lattice``: ``BatchedLatticeDecoder(Hm, config, **HM_LATTICE_KW,
  pad_time_to=CHUNK).decode(chunk_frames=CHUNK, device_prune=True)``
  (folded); ``batched.lattice_unfolded``: the same with ``fold=False``
  (eps_iters 1).  At lattice beam 8 the device sweep's survivor buffers
  overflow and the decoder falls back to the host prune: each utterance
  records whether it did (``sweep_fell_back``);
* ``streaming``: on utterances 0 to HM_STREAM_UTTS - 1, 100 frames an
  ``advance_decoding``: ``faster``, ``FasterDecoder`` with phase 5's
  options; ``lattice_faster``, ``LatticeFasterDecoder`` with phase 7's
  config (lattice beam 8), then ``finalize_decoding``; ``faster_h``,
  ``FasterDecoder`` with phase 5's options on the standard H
  (``ctc_topo(V)``), whose derived arc budget truncates the expansion
  (ROADMAP Queue 3);
* ``parts[P]``, P in (1, 2), on a ``("model",)`` mesh of P CPU devices:
  ``ShardedViterbiDecoder`` and ``ShardedLatticeDecoder`` (never folded:
  the routed eps closure) on the first ``HM_SHARD_FRAMES`` frames, route
  buckets of ``HM_ROUTE_CAP``.

Per utterance it records what the other references record (1-best
labels, the float32 bits of the best path's cost, ``num_active`` per
frame, the overflow and saturation counts; the 1-best decodes a sha256 of
the per-frame best costs; the lattice decodes the raw lattice's size and
digests, ``reached_final`` and ``final_relative_cost``), and for
utterance 0 of each sharded lattice decode its pruned lattice's kept
links.  Every decode must show no overflow and no saturation, or the
script fails, except the kept faults of ``KEPT_FAULTS``, whose counts it
records: ``faster_h`` must overflow, ``lattice_faster`` may.

Each utterance is decoded alone (B = 1): per-utterance results do not
depend on the batch, and the decodes run ``--procs`` at a time.

    JAX_PLATFORMS=cpu python scripts/make_torch_hmod_reference.py --procs 6
"""

import argparse
import json
import multiprocessing as mp
import os
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
OUT = REPO / "tests" / "data" / "torch_port_hmod_ref.json"
PARTS = (1, 2)
BATCHED = ("viterbi", "lattice", "lattice_unfolded")
STREAMING = ("faster", "lattice_faster", "faster_h")
SHARDED = ("viterbi", "lattice")
# Decodes whose overflow the reference keeps (ROADMAP Queue 3): which must
# overflow (True) and which may (False).
KEPT_FAULTS = {"faster_h": True, "lattice_faster": False}

_work = {}


def _setup():
    """The workload and the graphs, once a process."""
    if not _work:
        sys.path.insert(0, str(REPO))
        sys.path.insert(0, str(REPO / "scripts"))
        import bench
        from kaldi_decoder_tpu.fst import compile_fst, ctc_topo

        _, scores, lengths, refs = bench.build_hlg_workload()
        _work.update(bench=bench, graph=compile_fst(ctc_topo(bench.V, modified=True)),
                     h=compile_fst(ctc_topo(bench.V)), scores=scores, lengths=lengths,
                     refs=refs)
    return _work


def lattice_cfg(c):
    from make_torch_h_reference import cfg_dict

    return dict(cfg_dict(c.frontier), em_records=c.em_records, eps_records=c.eps_records,
                lattice_beam=c.lattice_beam)


def streaming(kind, b):
    """One streaming decode of utterance ``b``: (record, device config)."""
    w = _setup()
    import chip_smoke as cs
    from kaldi_decoder_tpu.decodable import DecodableCtc
    from kaldi_decoder_tpu.decoders.api import FasterDecoder, FasterDecoderOptions
    from kaldi_decoder_tpu.decoders.lattice import (
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
    )
    from make_torch_h_reference import cfg_dict
    from make_torch_lattice_eps_reference import utt_record
    from make_torch_viterbi_reference import _utt_record

    L = int(w["lengths"][b])
    logp = w["scores"][b, :L]
    graph = w["h"] if kind == "faster_h" else w["graph"]
    if kind == "lattice_faster":
        dec = LatticeFasterDecoder(graph, LatticeFasterDecoderConfig(
            lattice_beam=cs.HM_LATTICE_KW["lattice_beam"], **cs.STREAM_OPTIONS))
    else:
        dec = FasterDecoder(graph, FasterDecoderOptions(**cs.STREAM_OPTIONS))
    dec.init_decoding()
    decodable = DecodableCtc(logp)
    while dec.num_frames_decoded() < L:
        dec.advance_decoding(decodable, max_num_frames=cs.FRAMES_PER_CALL)
    if kind == "lattice_faster":
        dec.finalize_decoding()
        ok_raw, raw = dec.get_raw_lattice()
        ok, best = dec.get_best_path()
        assert ok and ok_raw, (kind, b)
        rec = utt_record(L, w["scores"][b], w["refs"][b], raw, best, dec.stats(),
                         dec.reached_final(), dec.final_relative_cost())
        return rec, lattice_cfg(dec._dev_cfg)
    ok, lat = dec.get_best_path()
    assert ok, (kind, b)
    r = dec._result()
    rec = _utt_record(lat, L, w["scores"][b], w["refs"][b], r.num_active[:, 0],
                      r.best_costs[:, 0], r.overflows[:, 0], r.saturations[:, 0])
    return rec, cfg_dict(dec._cfg)


def run(job):
    """One decode of one utterance: ``job`` (where, kind, b, frames) with
    where "batched", "streaming" or a part count, the scores cut to
    ``frames`` (None: the decode's own length).  Returns (job, its record,
    config, seconds)."""
    where, kind, b, frames = job
    w = _setup()
    t0 = time.time()
    if where == "streaming":
        rec, cfg = streaming(kind, b)
    else:
        rec, cfg = decode(where, kind, b, frames)
    must = KEPT_FAULTS.get(kind) if where == "streaming" else None
    if must and not rec["overflow_frames"]:
        raise AssertionError(f"{job}: the kept fault did not overflow")
    if rec["saturated_frames"] or (rec["overflow_frames"] and must is None):
        raise AssertionError(f"{job}: {rec['overflow_frames']} overflow and "
                             f"{rec['saturated_frames']} saturated frames")
    del w
    return job, rec, cfg, time.time() - t0


def decode(where, kind, b, frames):
    """A batched or sharded decode of utterance ``b``: (record, config)."""
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
    from make_torch_h_reference import cfg_dict
    from make_torch_lattice_eps_reference import utt_record
    from make_torch_shard_reference import viterbi_record

    g = w["graph"]
    fc = config_for_graph(g, **cs.HM_CONFIG)
    F = frames or (w["scores"].shape[1] if where == "batched" else cs.HM_SHARD_FRAMES)
    scores = np.ascontiguousarray(w["scores"][b:b + 1, :F])
    lengths = np.minimum(w["lengths"][b:b + 1], F).astype(np.int32)
    L = int(lengths[0])
    if where == "batched":
        if kind == "viterbi":
            dec = BatchedViterbiDecoder(g, fc)
            res = dec.decode(scores, lengths)
            return viterbi_record(res, 0, L, scores[0], w["refs"][b]), cfg_dict(dec.cfg)
        dec = BatchedLatticeDecoder(g, fc, fold=kind == "lattice", pad_time_to=cs.CHUNK,
                                    **cs.HM_LATTICE_KW)
        res = dec.decode(scores, lengths, chunk_frames=cs.CHUNK, device_prune=True)
        cfg = lattice_cfg(dec.cfg)
    else:
        mesh = Mesh(np.array(jax.devices()[:where]), ("model",))
        kw = dict(mesh=mesh, route_cap=cs.HM_ROUTE_CAP, pad_time_to=F)
        if kind == "viterbi":
            dec = ShardedViterbiDecoder(g, fc, **kw)
            res = dec.decode(scores, lengths)
            rec = viterbi_record(res, 0, L, scores[0], w["refs"][b])
        else:
            dec = ShardedLatticeDecoder(g, fc, **kw, **cs.HM_LATTICE_KW)
            res = dec.decode(scores, lengths)
        sc = dec.cfg if kind == "viterbi" else dec.cfg.shard
        cfg = dict(cfg_dict(sc.frontier), num_parts=sc.num_parts, part_size=sc.part_size,
                   route_cap=sc.route_cap, eps_route_cap=sc.eps_route_cap)
        if kind == "viterbi":
            return rec, cfg
        cfg.update(em_records=dec.cfg.em_records, eps_records=dec.cfg.eps_records,
                   lattice_beam=dec.cfg.lattice_beam)
    rec = utt_record(L, scores[0], w["refs"][b], res.raw_lattice(0), res.best_path(0),
                     res.stats(0), res.reached_final(0), res.final_relative_cost(0))
    rec["labels"] = res.best_path_labels(0)
    if where == "batched":
        rec["sweep_fell_back"] = res.survivors is None
    elif b == 0:
        count, sha = cs.pruned_links(res._prune(0))
        rec["links0"] = {"count": count, "sha256": sha}
    return rec, cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--utts", type=int, default=16)
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--frames", type=int, default=None,
                    help="cut every batched and sharded decode to its first frames (a quick "
                    "check of the script)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={max(PARTS)}")
    os.environ["KDTPU_BENCH_B"] = str(args.utts)
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    n, f = args.utts, args.frames
    ns = min(n, cs.HM_STREAM_UTTS)
    # The longest decodes first.
    jobs = ([("batched", k, b, f) for k in ("lattice", "lattice_unfolded") for b in range(n)]
            + [("streaming", k, b, None) for k in STREAMING for b in range(ns)]
            + [(P, k, b, f) for P in PARTS for k in SHARDED for b in range(n)]
            + [("batched", "viterbi", b, f) for b in range(n)])
    got, cfgs, secs = {}, {}, {}
    t0 = time.time()
    with mp.get_context("spawn").Pool(args.procs, maxtasksperchild=4) as pool:
        for job, rec, cfg, s in pool.imap_unordered(run, jobs):
            got[job[:3]], secs[job[:3]] = rec, s
            cfgs.setdefault(job[:2], cfg)
            if cfgs[job[:2]] != cfg:
                raise AssertionError(f"{job}: config {cfg} != {cfgs[job[:2]]}")
            print(f"{job}: {s:.1f} s ({len(got)} of {len(jobs)}, {time.time() - t0:.0f} s)",
                  flush=True)

    def utts(where, kind, count=n):
        out = [got[where, kind, b] for b in range(count)]
        for u in out:
            u.pop("links0", None)
        return out

    def seconds(where, kind, count=n):
        return sum(secs[where, kind, b] for b in range(count))

    bench = _setup()["bench"]
    stream = {}
    for k in STREAMING:
        sec = {"device_config": cfgs["streaming", k], "frames_per_call": cs.FRAMES_PER_CALL,
               "utterances": ns, "seconds": seconds("streaming", k, ns),
               "utts": utts("streaming", k, ns)}
        if k == "lattice_faster":
            sec["config"] = dict(cs.STREAM_OPTIONS, lattice_beam=cs.HM_LATTICE_KW["lattice_beam"])
        else:
            sec["options"] = dict(cs.STREAM_OPTIONS)
        sec["graph"] = f"ctc_topo({bench.V}{'' if k == 'faster_h' else ', modified=True'})"
        stream[k] = sec
    parts = {}
    for P in PARTS:
        parts[str(P)] = {
            "shard_config": dict(cfgs[P, "viterbi"], **{
                k: v for k, v in cfgs[P, "lattice"].items() if k not in cfgs[P, "viterbi"]}),
            "viterbi_config": cfgs[P, "viterbi"],
            "seconds": {k: seconds(P, k) for k in SHARDED},
            "links0": got[P, "lattice", 0]["links0"],
            "viterbi": utts(P, "viterbi"),
            "lattice": utts(P, "lattice"),
        }
    out = {
        "source": "JAX BatchedViterbiDecoder, BatchedLatticeDecoder (folded and fold=False), "
        "FasterDecoder, LatticeFasterDecoder, ShardedViterbiDecoder and ShardedLatticeDecoder "
        "on the CPU (scripts/make_torch_hmod_reference.py)",
        "workload": {
            "graph": f"ctc_topo({bench.V}, modified=True)", "seed": bench.SEED, "T": bench.T,
            "V": bench.V, "utterances": n, "shard_frames": f or cs.HM_SHARD_FRAMES,
            "frames": f, "stream_utterances": ns,
            "note": "the bench's first utterances (bench.py), each decoded alone; the "
            "sharded decodes cut to their first shard_frames frames",
        },
        "requested": {"config": dict(cs.HM_CONFIG), "lattice": dict(cs.HM_LATTICE_KW),
                      "route_cap": cs.HM_ROUTE_CAP, "chunk_frames": cs.CHUNK,
                      "stream_options": dict(cs.STREAM_OPTIONS)},
        "kept_faults": {k: {"must_overflow": v,
                            "overflow_frames": [u["overflow_frames"] for u in stream[k]["utts"]]}
                        for k, v in KEPT_FAULTS.items()},
        "batched": dict(
            viterbi_config=cfgs["batched", "viterbi"],
            lattice_config=cfgs["batched", "lattice"],
            lattice_unfolded_config=cfgs["batched", "lattice_unfolded"],
            seconds={k: seconds("batched", k) for k in BATCHED},
            **{k: utts("batched", k) for k in BATCHED}),
        "streaming": stream,
        "parts": parts,
    }
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, separators=(",", ":")) + "\n")
    print(f"wrote {path} in {time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
