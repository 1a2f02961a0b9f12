#!/usr/bin/env python3
"""The sharded decoders over NCCL on P cards, one rank a card: the sharded
frame driver's captured graph against the host loop, and how a rank ends
its group.

Builds the port's kernels, then spawns ``--ranks`` processes (default:
every visible card), rank r on ``cuda:r``, meeting over NCCL at
``tcp://localhost``.  Each rank rebuilds the bench workload from its seed,
takes the sharded workload of ``--graph`` (``chip_smoke.shard_cells``:
"bench", phases 12-13's unfolded bench graph at ``SHARD_CONFIG``; "h",
phase 14's CTC topology H at ``H_SHARD_CONFIG``, where the sharded frame
has no eps iteration and its emitting dedup call writes the frame's local
values as its last step; "hmod", phase 15's modified CTC topology Hm at
``HM_CONFIG``, the routed eps closure at K 512), cut to its
frames, and, for ``ShardedViterbiDecoder`` and ``ShardedLatticeDecoder``
(``--kinds``) on a ``("model",)`` mesh of the P ranks:

- decodes through the sharded frame driver (every frame after the
  driver's first replayed from its captured graph, all ranks in
  lockstep), counted (kernel launches, collective calls by kind, frames
  replayed), then the same decode as the host loop
  (``decoders.driver.eager_frames()``), counted; every field of the two
  results must be equal, floats by their bits, and so must the counts;
  where the cell's JAX reference has a part of P shards (P = 1 and 2),
  the replayed decode must also equal the JAX sharded decoders there, as
  in the smoke (labels, best-path cost bits, ``num_active``, the flags;
  lattices, held whole on the cell's utterances as the smoke holds them,
  and utterance 0's pruned links);
- times the driver's chunk alone (the first decode's
  ``graph_shard.sharded_chunk`` call again) replayed and as the loop, in
  turns (graph, loop, loop, graph): wall ms a frame, host clock around a
  chunk that ends in a synchronise, after a barrier of every rank.

Prints each rank's numbers and writes every rank's checks to
``chiprun_out/shard_nccl_<tag>.json``.  A rank hands its numbers over
before its teardown (``--teardown``, :data:`TEARDOWNS`) and reports each
step of it.  Exits non-zero if a check fails on any rank, or if a rank
has not ended ``TEARDOWN_S`` seconds after the last results: such a rank
is ended and named with the last step it reported.

    python3 scripts/check_torch_shard_nccl.py [--ranks P] [--graph bench|h|hmod] \
        [--teardown shutdown|close|destroy|none] [--tag T]
"""

import argparse
import contextlib
import importlib.util
import json
import os
import queue as queue_mod
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 1200  # seconds the ranks may take for their results
TEARDOWN_S = 60  # seconds, after the last results, for every rank to end
# How a rank ends its group after its results: ``parallel.shutdown_distributed()``
# (the kept sharded frame drivers released, then the groups destroyed);
# each decoder closed (its ``with`` block: its kept drivers released), then
# a barrier and ``torch.distributed.destroy_process_group()``; a barrier
# then ``destroy_process_group()`` alone, the decoders' drivers kept; or no
# call (the rank function returns and the process exits).
TEARDOWNS = ("shutdown", "close", "destroy", "none")
# --graph: the sharded cell of chip_smoke.shard_cells it names.
CELLS = {"bench": "bench", "h": "h", "hmod": "hm"}
ENDED = "ended its teardown"
FIELDS = {
    "viterbi": ("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
                "num_active", "best_costs", "cutoffs", "overflows", "saturations"),
    "lattice": ("init_states", "init_costs", "init_eps_records", "frame_states", "frame_costs",
                "em_records", "eps_records", "num_active", "cutoffs", "overflows",
                "saturations"),
}


def smoke():
    """``chip_smoke.py`` of this checkout, for its helpers."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def same_results(kind, a, b):
    """The first field of two results of ``kind`` that differs, or None."""
    import numpy as np

    for f in FIELDS[kind]:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        if x.shape != y.shape or not np.array_equal(x, y):
            return f
    return None


def counted(cs, decode):
    """``decode()`` with the launch counts, collective calls and replays
    set to 0 before it: (its result, launches, collectives, replays)."""
    import torch

    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

    cs.reset_counts()
    collective_calls.clear()
    res = decode()
    torch.cuda.synchronize()
    return res, cs.read_counts(), dict(collective_calls), driver.replays


def rank_run(rank, P, port, queue, kinds=("viterbi", "lattice"), teardown="shutdown",
             graph_name="bench"):
    """One rank: the sharded decoders' (``kinds``) checks and chunk walls;
    puts (rank, "ok", numbers) or (rank, "error", traceback) on ``queue``,
    then ends its group as ``teardown`` says (:data:`TEARDOWNS`), reporting
    each step as (rank, "step", name).  ``graph_name`` names the sharded
    workload (``chip_smoke.shard_cells``)."""
    try:
        sys.path.insert(0, REPO)
        import torch
        import torch.distributed as dist

        from kaldi_decoder_tpu_torch.decoders import driver
        from kaldi_decoder_tpu_torch.parallel import (
            graph_shard,
            initialize_distributed,
            make_mesh,
            shutdown_distributed,
        )

        torch.cuda.set_device(rank)
        initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{port}",
                               rank=rank, world_size=P)
        cs = smoke()
        name = CELLS[graph_name]
        cell = cs.shard_cells(cs.bench_workload(), (name,))[0]
        sc, sl = cell.sc, cell.sl
        want = cell.ref["parts"].get(str(P))
        mesh = make_mesh(P, "model", device_type="cuda")
        out, decs = {}, []
        for kind in kinds:
            dec = cs.sharded_decoder(kind, cell, mesh)
            decs.append(dec)
            dist.barrier()
            with cs.CallCapture(graph_shard, {"sharded_chunk": {0}}) as chunk:
                graph_run = counted(cs, lambda: dec.decode(sc, sl))
            dist.barrier()
            with driver.eager_frames():
                loop_run = counted(cs, lambda: dec.decode(sc, sl))
            frames = graph_run[0].num_active.shape[0]
            checks = dict(differs=same_results(kind, graph_run[0], loop_run[0]),
                          launches=(graph_run[1], loop_run[1]),
                          collectives=(graph_run[2], loop_run[2]),
                          replays=(graph_run[3], loop_run[3]))
            ok = (checks["differs"] is None and graph_run[1] == loop_run[1]
                  and graph_run[2] == loop_run[2] and graph_run[3] == frames - 1
                  and loop_run[3] == 0)
            if want is not None:  # raises where the replayed decode differs from JAX
                res = graph_run[0]
                what = f"[rank {rank}] P={P} {kind} over NCCL"
                if kind == "viterbi":
                    for b, u in enumerate(want[kind][:cs.B]):
                        cs.check_utterance(what, b, u, res.best_path(b), res.num_active[:, b],
                                           res.best_costs[:, b], res.overflows[:, b],
                                           res.saturations[:, b])
                else:
                    cs.check_lattice_result(what, res, want[kind][:cs.B], cell.held,
                                            labels=name == "hm")
                if kind == "lattice" and list(cs.pruned_links(res._prune(0))) != [
                        want["links0"]["count"], want["links0"]["sha256"]]:
                    raise AssertionError(f"{what}: utterance 0's pruned links differ")
            checks["jax_reference"] = want is not None
            args, _ = chunk.kept["sharded_chunk", 0]
            walls = {"graph": [], "loop": []}
            for mode in ("graph", "loop", "loop", "graph"):
                with driver.eager_frames() if mode == "loop" else contextlib.nullcontext():
                    dist.barrier()
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    graph_shard.sharded_chunk(*args)
                    torch.cuda.synchronize()
                    walls[mode].append((time.perf_counter() - t0) * 1e3 / frames)
            out[kind] = dict(ok=ok, checks=checks, frames=frames, chunk_wall_ms=walls,
                             pool_bytes=graph_shard.frame_driver(
                                 kind == "lattice", dec._pg, dec.cfg, dec._sh, cs.B, cs.V,
                                 dec.device).pool_bytes,
                             overflow_frames=int(graph_run[0].overflows.sum()),
                             saturated_frames=int(graph_run[0].saturations.sum()))
            cs.log(f"[rank {rank}] P={P} {graph_name} {kind}: graph equal to the loop: {ok} "
                   f"({checks['differs'] or 'every field'}; replays {graph_run[3]} of {frames} "
                   f"frames; launches {graph_run[1]}; collectives {graph_run[2]}); chunk wall "
                   f"ms a frame: graph {walls['graph']}, loop {walls['loop']}")
            del dec, chunk, args
            torch.cuda.empty_cache()
        # The numbers go out before the teardown, and each step of it is
        # reported, so that a rank stuck there is named with the step.
        queue.put((rank, "ok", out))
        if teardown == "none":  # the process ends with the group and the kept drivers alive
            queue.put((rank, "step", ENDED))
            return
        if teardown == "close":
            for dec in decs:
                with dec:  # its end closes the decoder: its kept drivers released
                    pass
            queue.put((rank, "step", "closed"))
        del decs
        dist.barrier()
        queue.put((rank, "step", "barrier"))
        if teardown == "shutdown":
            shutdown_distributed()  # the kept drivers' graphs released, then the groups
        else:
            dist.destroy_process_group()
        queue.put((rank, "step", ENDED))
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=0, help="ranks, one a card (0: every card)")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    ap.add_argument("--kinds", default="viterbi,lattice",
                    help="the sharded decoders to run, comma-separated")
    ap.add_argument("--teardown", choices=TEARDOWNS, default="shutdown",
                    help="how each rank ends its group after its results")
    ap.add_argument("--graph", choices=tuple(CELLS), default="bench",
                    help="the sharded workload: the bench graph (phases 12-13), H (phase 14) "
                    "or Hm, the modified CTC topology (phase 15)")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import multiprocessing as mp

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("check_torch_shard_nccl: no CUDA device")
    from kaldi_decoder_tpu_torch.kernels import _build

    P = args.ranks or torch.cuda.device_count()
    if P > torch.cuda.device_count():
        raise SystemExit(f"{P} ranks need {P} cards, {torch.cuda.device_count()} visible")
    cs = smoke()
    _build.kernels()  # once, before the ranks load it
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = cs.free_port()
    kinds = tuple(args.kinds.split(","))
    procs = [ctx.Process(target=rank_run, args=(r, P, port, q, kinds, args.teardown, args.graph))
             for r in range(P)]
    for p in procs:
        p.start()
    got, step = {}, {r: "decoding" for r in range(P)}
    ended_s = last = None
    try:
        deadline = time.time() + TIMEOUT
        while len(got) < P or any(s != ENDED for s in step.values()):
            if len(got) == P:  # the teardown: TEARDOWN_S for every rank to end
                deadline = min(deadline, end_by)
            try:
                rank, status, out = q.get(timeout=max(0.1, deadline - time.time()))
            except queue_mod.Empty:
                break
            if status == "error":
                raise SystemExit(f"rank {rank} failed:\n{out}")
            if status == "ok":
                got[rank], step[rank] = out, "results"
                last = time.time()
                end_by = last + TEARDOWN_S
            else:
                step[rank] = out
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.time()))
        ended_s = time.time() - last if not any(p.is_alive() for p in procs) else None
    finally:
        stuck = {r: step[r] for r, p in enumerate(procs) if p.is_alive()}
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode and r not in stuck}
    if len(got) < P:
        raise SystemExit(f"check_torch_shard_nccl: no results from ranks "
                         f"{sorted(set(range(P)) - set(got))} within {TIMEOUT} s")
    line = json.dumps({"tag": args.tag, "card": cs.card_line(), "ranks": P,
                       "graph": args.graph, "teardown_mode": args.teardown,
                       "teardown": {str(r): step[r] for r in range(P)},
                       "stuck": {str(r): s for r, s in stuck.items()},
                       "exit_codes": [p.exitcode for p in procs],
                       "ended_s_after_results": ended_s,
                       "by_rank": [got[r] for r in range(P)]})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"shard_nccl_{args.tag}.json"), "w") as f:
        f.write(line + "\n")
    print(line)
    if not all(got[r][k]["ok"] for r in got for k in got[r]):
        raise SystemExit("check_torch_shard_nccl: the graph and the loop differ")
    if stuck or failed:
        raise SystemExit(f"check_torch_shard_nccl: ranks did not end within {TEARDOWN_S} s of "
                         f"the last results (ended, each after the step named): {stuck}; "
                         f"exit codes of the ranks that ended with one: {failed}")


if __name__ == "__main__":
    main()
