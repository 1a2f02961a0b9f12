#!/usr/bin/env python3
"""The sharded decoders' frame (``chip_smoke.py`` phases 12-13) of one tree
of the torch port, measured on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed, cuts it as phases 12-13 do
(``SHARD_FRAMES`` frames, ``SHARD_CONFIG``) and runs the
``ShardedViterbiDecoder`` and the ``ShardedLatticeDecoder`` of the tree's
package at P = 1 in this process over NCCL and at P = 2 in two spawned
ranks sharing ``cuda:0`` over gloo.  For each: one decode to warm up,
``--reps`` timed decodes (wall ms a frame, host clock around a decode
that ends in a synchronise), then one decode under the profiler: device
ms a frame (kernels and copies), busy share (device over wall), device
activities a frame split into the tree's own kernels (the ``__global__``
functions of its ``csrc``), collectives and copies, and other (with their
names), and the collectives a frame by kind.  Rank 0 also times the eps
step's shard mode and K3's shard mode on the inputs of frame
``SHARD_FRAME`` that the warm-up decode passed them (kept by the smoke's
``CallCapture``), while the other rank waits: held bitwise against their
plain versions, device ms by CUDA events over calls back to back, bound
and share of the bound (the smoke's work counts), at the kernel's own
cluster size and, where the tree's wrappers take ``clusters``, at 8, 4,
2 and 1 blocks a row (with K8's local half folded into K3's shard mode
where the tree folds it, beside the same call without it), and the first
eps iteration's dedup call: on the routed lanes where the tree folds K7's
receive side into it, else K7's receive launch and the call on its
lanes, each apart and back to back.  With ``--runs`` it times
nothing: one decode of each at P = 1 records, for every K7 send call,
the (owner, state) runs of its valid lanes (the lanes of a row with one
destination: what the send side dedups): how many, the longest, the
99th and 99.9th percentiles by run, the run length of the 99th
percentile lane, and the bits in which a row's cost keys differ (the
passes a sort on the cost would take), for the emitting and the eps
calls apart.  The decodes' results are not checked here
(``chip_smoke.py`` does that).  Prints one JSON line and
writes it to ``chiprun_out/profile_shard_<tag>.json``.  To compare two
trees on one card, run both in one command, in turns:

    python3 scripts/profile_torch_shard.py --tree build/parent --tag parent
    python3 scripts/profile_torch_shard.py --tag new
"""

import argparse
import importlib.util
import json
import os
import sys
import time
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 900  # seconds the two ranks may take


def smoke():
    """``chip_smoke.py`` of this checkout, for its helpers (the package
    they import at call time is the tree's, first on the path)."""
    path = os.path.join(REPO, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def run_lengths(decode):
    """The (owner, state) run lengths of every K7 send call's valid lanes
    in one ``decode()``: {lanes a row: summary}."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.parallel import graph_shard

    hist, kbits = {}, {}
    inner = graph_shard.route_send

    def counted(*args, **kw):
        dst, cost, sp, parts = args[0], args[1], args[4], args[5]
        cutoff = args[8] if len(args) > 8 else kw.get("cutoff")
        valid = torch.isfinite(cost) & (dst >= 0) & (dst < parts * sp)
        if cutoff is not None:
            valid &= cost < cutoff[:, None]
        rows = torch.arange(dst.shape[0], device=dst.device)[:, None] * (parts * sp)
        _, counts = torch.unique((rows + dst)[valid], return_counts=True)
        h = torch.bincount(counts).cpu().numpy()
        u = torch.where(cost == 0, 0.0, cost).view(torch.int32).long() & 0xFFFFFFFF
        key = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | 1 << 31)  # common.cuh:ordered_key
        lo = torch.where(valid, key, 1 << 32).amin(dim=1)
        hi = torch.where(valid, key, -1).amax(dim=1)
        diff = torch.where(hi > lo, lo ^ hi, 0).cpu().tolist()
        row_bits = kbits.setdefault(dst.shape[1], {})
        for x in diff:
            row_bits[int(x).bit_length()] = row_bits.get(int(x).bit_length(), 0) + 1
        old = hist.get(dst.shape[1], np.zeros(1, np.int64))
        n = max(len(old), len(h))
        hist[dst.shape[1]] = np.pad(old, (0, n - len(old))) + np.pad(h, (0, n - len(h)))
        return inner(*args, **kw)

    graph_shard.route_send = counted
    try:
        decode()
    finally:
        graph_shard.route_send = inner
    out = {}
    for lanes, h in sorted(hist.items()):
        length = np.arange(len(h))
        by_run = np.cumsum(h) / h.sum()
        by_lane = np.cumsum(h * length) / (h * length).sum()
        out[lanes] = dict(runs=int(h.sum()), longest=int(length[h > 0].max()),
                          p99=int(np.searchsorted(by_run, 0.99)),
                          p999=int(np.searchsorted(by_run, 0.999)),
                          lane_p99=int(np.searchsorted(by_lane, 0.99)),
                          over_32=int(h[33:].sum()), over_256=int(h[257:].sum()),
                          key_bits=dict(sorted(kbits[lanes].items())))
    return out


def runs_main(tree):
    """``--runs``: each sharded decoder once at P = 1 (after a warm-up
    decode) with K7's send calls recorded: {kind: run_lengths}."""
    import torch

    from kaldi_decoder_tpu_torch import config_for_graph
    from kaldi_decoder_tpu_torch.parallel import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
        make_mesh,
    )

    cs = smoke()
    graph, scores, lengths, refs = cs.bench_workload()
    _, sc, sl = cs.shard_reference(scores, lengths, refs)
    mesh = make_mesh(1, "model", device_type="cuda")
    fc = config_for_graph(graph, **cs.SHARD_CONFIG)
    out = {}
    for kind in ("viterbi", "lattice"):
        if kind == "viterbi":
            dec = ShardedViterbiDecoder(graph, fc, mesh=mesh, pad_time_to=cs.SHARD_FRAMES,
                                        device="cuda")
        else:
            dec = ShardedLatticeDecoder(graph, fc, lattice_beam=cs.SHARD_LATTICE_BEAM,
                                        mesh=mesh, pad_time_to=cs.SHARD_FRAMES, device="cuda")
        dec.decode(sc, sl)
        out[kind] = run_lengths(lambda: dec.decode(sc, sl))
        del dec
        torch.cuda.empty_cache()
    return out


def time_shard_kernels(cs, kept, eps_iters):
    """The eps step's shard mode and K3's shard mode on frame SHARD_FRAME's
    captured calls (``kept``, a CallCapture's), each held against its plain
    version and timed: {kernel: {ms, ms_by_clusters, clusters, bound_ms,
    bound_by, share_of_bound}}."""
    import inspect

    import torch

    from kaldi_decoder_tpu_torch.kernels import eps as keps
    from kaldi_decoder_tpu_torch.kernels import frame as kframe

    def sizes(fn):
        """(clusters argument, label) of each timed size: the default, and
        8, 4, 2, 1 where the wrapper takes ``clusters``."""
        if "clusters" not in inspect.signature(fn).parameters:
            return [({}, "default")]
        return [({}, "default")] + [(dict(clusters=g), g) for g in (8, 4, 2, 1)]

    out = {}
    if eps_iters:
        args, kw = kept["eps_step_shard", eps_iters + cs.SHARD_FRAME * eps_iters]
        ref = cs.clone(args)
        keps.eps_step_shard_plain(*ref, **kw)
        sel = args[4]
        chosen = getattr(keps, "shard_step_cluster_size", None)
        t = dict(clusters=chosen(*sel.states.shape) if chosen else 1, ms_by_clusters={})
        for extra, label in sizes(keps.eps_step_shard):
            got = cs.clone(args)
            keps.eps_step_shard(*got, **kw, **extra)
            torch.cuda.synchronize()
            cs.same_fields(ref[1], got[1], "the eps step's shard mode", f"{label} blocks")
            for r, g in zip(ref[2:4], got[2:4]):
                if not torch.equal(r.view(torch.int32), g.view(torch.int32)):
                    raise AssertionError(f"the eps step's shard mode at {label}: carried frontier")
            t["ms_by_clusters"][label] = cs.device_ms(
                lambda: keps.eps_step_shard(*got, **kw, **extra))
        t["ms"] = t["ms_by_clusters"].pop("default")
        t["bound_ms"], t["bound_by"] = cs.bound_ms(
            *cs.eps_step_shard_work(sel, args[1], kw.get("lanes"), False))
        t["share_of_bound"] = t["bound_ms"] / t["ms"]
        out["eps_step_shard"] = t
    args, kw = kept["frame_tail_shard", cs.SHARD_FRAME]
    targs, st, cutoff, tin, lengths, outs, slot_base = args
    local = kw.get("local")  # K8's local half folded in (this PR's trees)
    lkw = {} if local is None else dict(local=local)
    row = int(targs[0])
    fa = lengths > row
    B, K = st.states.shape
    lattice = tin.em_records is not None
    final, ref = kframe.frame_tail_shard_plain(st, cutoff, tin, fa, slot_base, **lkw)[:2]
    chosen = getattr(kframe, "shard_cluster_size", None)
    t = dict(clusters=chosen(B, K) if chosen else 1, ms_by_clusters={}, folded=local is not None)
    t_outs = kframe.empty_shard_outs(
        64, B, K, outs[1].shape[2], lattice, st.states.device,
        *((outs[0].shape[2], outs[1].shape[3]) if lattice else ()))
    for extra, label in sizes(kframe.frame_tail_shard):
        got = cs.clone(args)
        kframe.frame_tail_shard(*got, **extra, **cs.clone(lkw))
        torch.cuda.synchronize()
        cs.same_fields(final, got[1], "K3's shard mode (state)", f"{label} blocks")
        cs.same_fields(ref, type(ref)(*(x[row] for x in got[5])), "K3's shard mode (outputs)",
                       f"{label} blocks")
        # Timed on a table of its own from t = 0, into outputs of 64 rows.
        t_args, t_st, t_kw = kframe.shard_args(st.states.device), cs.clone(st), cs.clone(lkw)
        t["ms_by_clusters"][label] = cs.device_ms(lambda: kframe.frame_tail_shard(
            t_args, t_st, cutoff, tin, lengths, t_outs, slot_base, **extra, **t_kw))
    t["ms"] = t["ms_by_clusters"].pop("default")
    t["bound_ms"], t["bound_by"] = cs.bound_ms(*cs.k3_shard_work(tin, fa, local))
    t["share_of_bound"] = t["bound_ms"] / t["ms"]
    if local is not None:  # the same call without the local half
        t_args, t_st = kframe.shard_args(st.states.device), cs.clone(st)
        t["alone_ms"] = cs.device_ms(lambda: kframe.frame_tail_shard(
            t_args, t_st, cutoff, tin, lengths, t_outs, slot_base))
    out["k3_shard"] = t
    return out


def time_eps_call(cs, kept, kind, eps_iters):
    """The first eps iteration's dedup call of frame SHARD_FRAME (K6, or
    K2's eps call) as the tree runs it: on a tree with K7's receive side
    folded in, the call on the routed lanes; else K7's receive launch
    (the incumbents first) and the call on its lanes.  Device ms by CUDA
    events, each apart and the pair back to back: {dedup_ms, recv_ms
    (None when folded), ms}."""
    from kaldi_decoder_tpu_torch.kernels import dedup as kdedup
    from kaldi_decoder_tpu_torch.kernels import dedup_rec as kdrec
    from kaldi_decoder_tpu_torch.kernels import route as kroute

    fn = kdedup.dedup_select if kind == "viterbi" else kdrec.dedup_select_rec
    name = "dedup_select" if kind == "viterbi" else "dedup_select_rec"
    i = cs.shard_call_index(cs.SHARD_FRAME, eps_iters, True)
    args, kw = kept[name, i]
    t = dict(dedup_ms=cs.device_ms(lambda: fn(*args, **kw)), recv_ms=None)
    if kw.get("routed") is None:
        (rargs, rkw) = kept["route_recv", i]
        t["recv_ms"] = cs.device_ms(lambda: kroute.route_recv(*rargs, **rkw))

        def pair():
            kroute.route_recv(*rargs, **rkw)
            fn(*args, **kw)

        t["ms"] = cs.device_ms(pair)
    else:
        t["ms"] = t["dedup_ms"]
    return t


def measure(tree, P, rank, reps):
    """Both sharded decoders on this rank of a group of P (the default
    group, made), and on rank 0 the two shard-mode kernels on frame
    SHARD_FRAME's inputs: {kind: numbers}."""
    import torch
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch import config_for_graph
    from kaldi_decoder_tpu_torch.parallel import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
        make_mesh,
    )
    from kaldi_decoder_tpu_torch.parallel import graph_shard
    from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

    cs = smoke()
    graph, scores, lengths, refs = cs.bench_workload()
    _, sc, sl = cs.shard_reference(scores, lengths, refs)
    mesh = make_mesh(P, "model", device_type="cuda")
    fc = config_for_graph(graph, **cs.SHARD_CONFIG)
    names = cs.port_kernel_names(tree)
    out = {}
    for kind in ("viterbi", "lattice"):
        if kind == "viterbi":
            dec = ShardedViterbiDecoder(graph, fc, mesh=mesh, pad_time_to=cs.SHARD_FRAMES,
                                        device="cuda")
        else:
            dec = ShardedLatticeDecoder(graph, fc, lattice_beam=cs.SHARD_LATTICE_BEAM,
                                        mesh=mesh, pad_time_to=cs.SHARD_FRAMES, device="cuda")
        D = (dec.cfg if kind == "viterbi" else dec.cfg.shard).frontier.eps_iters
        eps_i = cs.shard_call_index(cs.SHARD_FRAME, D, True)
        kname = "dedup_select" if kind == "viterbi" else "dedup_select_rec"
        capture = {"eps_step_shard": {D + cs.SHARD_FRAME * D},
                   "frame_tail_shard": {cs.SHARD_FRAME}, kname: {eps_i},
                   "route_recv": {eps_i}}
        with cs.CallCapture(graph_shard, capture) as cap:
            res = dec.decode(sc, sl)
        frames = res.num_active.shape[0]
        walls = []
        for _ in range(reps):
            dist.barrier()
            torch.cuda.synchronize()
            collective_calls.clear()
            t0 = time.perf_counter()
            dec.decode(sc, sl)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3 / frames)
        coll = dict(collective_calls)
        dist.barrier()
        k_ms, c_ms, acts, _ = cs.profiled_device_ms(lambda: dec.decode(sc, sl), top=None)
        split = cs.activity_split(acts, names)
        dev = (k_ms + c_ms) / frames
        out[kind] = dict(
            frames=frames, wall_ms_per_frame=walls, device_ms_per_frame=dev,
            kernel_ms_per_frame=k_ms / frames, copy_ms_per_frame=c_ms / frames,
            busy=dev / (sum(walls) / len(walls)),
            activities_per_frame=sum(v[1] for v in split.values()) / frames,
            split_per_frame={g: dict(ms=ms / frames, activities=n / frames)
                             for g, (ms, n, _) in split.items()},
            other=[(name, n / frames) for name, n in split["other"][2]],
            collectives_per_frame={k: v / frames for k, v in coll.items()},
            collectives_a_frame=sum(coll.values()) / frames)
        if rank == 0:  # the other rank waits at the barrier: the card is this rank's alone
            out[kind]["kernels"] = time_shard_kernels(cs, cap.kept, D)
            if D:
                out[kind]["kernels"]["eps_call"] = time_eps_call(cs, cap.kept, kind, D)
        dist.barrier()
        del dec, res, cap
        torch.cuda.empty_cache()
    return out


def rank_main(tree, rank, port, reps, queue):
    """One of the two P = 2 ranks (a spawned process) on ``cuda:0`` over gloo."""
    try:
        sys.path.insert(0, tree)
        import torch
        import torch.distributed as dist

        from kaldi_decoder_tpu_torch.parallel import initialize_distributed

        torch.cuda.set_device(0)
        initialize_distributed(backend="gloo", init_method=f"tcp://localhost:{port}",
                               rank=rank, world_size=2)
        try:
            queue.put((rank, "ok", measure(tree, 2, rank, reps)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        queue.put((rank, "error", traceback.format_exc()))
        raise


def two_ranks(tree, reps):
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = smoke().free_port()
    procs = [ctx.Process(target=rank_main, args=(tree, r, port, reps, q)) for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        deadline = time.time() + TIMEOUT
        while len(got) < 2:
            rank, status, out = q.get(timeout=max(1.0, deadline - time.time()))
            if status != "ok":
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [got[0], got[1]]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO,
                    help="root of the checkout whose port is measured")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    ap.add_argument("--reps", type=int, default=2, help="timed decodes of each")
    ap.add_argument("--runs", action="store_true",
                    help="record K7's (owner, state) run lengths at P = 1 instead of timing")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_shard: no CUDA device")
    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch.kernels import _build
    from kaldi_decoder_tpu_torch.parallel import initialize_distributed

    if not kaldi_decoder_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {kaldi_decoder_tpu_torch.__file__}, not the tree's")
    cs = smoke()
    t0 = time.perf_counter()
    _build.kernels()
    build_s = time.perf_counter() - t0
    torch.cuda.set_device(0)
    initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{cs.free_port()}",
                           rank=0, world_size=1)
    try:
        if args.runs:
            runs = runs_main(tree)
        else:
            p1 = measure(tree, 1, 0, args.reps)
    finally:
        dist.destroy_process_group()
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    if args.runs:
        line = json.dumps({"tag": args.tag, "tree": args.tree, "card": cs.card_line(),
                           "k7_send_runs": runs})
        with open(os.path.join(REPO, "chiprun_out", f"k7_runs_{args.tag}.json"), "w") as f:
            f.write(line + "\n")
        for kind, r in runs.items():
            for lanes, v in r.items():
                print(f"{args.tag} {kind}, K7 send calls of {lanes} lanes a row: {v}", flush=True)
        print(line)
        return
    torch.cuda.empty_cache()
    p2 = two_ranks(tree, args.reps)
    line = json.dumps({"tag": args.tag, "tree": args.tree, "card": cs.card_line(),
                       "build_s": build_s, "p1": p1, "p2": p2})
    name = os.path.join(REPO, "chiprun_out", f"profile_shard_{args.tag}.json")
    with open(name, "w") as f:
        f.write(line + "\n")
    for P, ranks in ((1, [p1]), (2, p2)):
        for kind in ("viterbi", "lattice"):
            r = ranks[0][kind]
            split = ", ".join(f"{g} {v['activities']:.2f}"
                              for g, v in r["split_per_frame"].items())
            print(f"{args.tag} P={P} {kind}: wall {r['wall_ms_per_frame']} ms a frame, device "
                  f"{r['device_ms_per_frame']:.4f}, busy {r['busy']:.3f}, activities "
                  f"{r['activities_per_frame']:.2f} a frame {split}; collectives "
                  f"{r['collectives_a_frame']:.2f} a frame", flush=True)
            for name, k in r["kernels"].items():
                if name == "eps_call":
                    print(f"{args.tag} P={P} {kind} frame {cs.SHARD_FRAME}: the first eps "
                          f"iteration's dedup call {k['dedup_ms']:.4f} ms, K7's receive "
                          f"{k['recv_ms']} ms, the two back to back {k['ms']:.4f}", flush=True)
                    continue
                print(f"{args.tag} P={P} {kind} frame {cs.SHARD_FRAME}: {name} {k['ms']:.4f} ms "
                      f"at {k['clusters']} blocks a row (bound {k['bound_ms']:.4f} by "
                      f"{k['bound_by']}, {k['share_of_bound']:.1%}); by blocks a row "
                      f"{k['ms_by_clusters']}" + (f"; without the local half {k['alone_ms']:.4f}"
                                                  if "alone_ms" in k else ""), flush=True)
    print(line)


if __name__ == "__main__":
    main()
