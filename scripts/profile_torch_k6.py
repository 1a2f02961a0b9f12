#!/usr/bin/env python3
"""K6 (``dedup_select``) of one tree of the torch port, at its four calls
on the main paths, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed and takes K6's arguments from
real frames exactly as ``chip_smoke.py`` phase 2 does: the emitting
candidates of batched Viterbi frame 150 (B=16), one eps iteration of the
unfolded graph's frame 60 (B=16), the streaming decoder's emitting and
eps candidates on frame 60 of utterance 0 (B=1), and, as ``chip_smoke.py``
phase 14 takes them, the emitting candidates of the batched Viterbi decode
on H (the CTC topology over the bench's tokens) at frame 150 (B=16).  Each call is held
against the plain version, then timed: device ms per call (10 calls queued
back to back, CUDA events), the plain version's device ms, the sizes of
the first digit's buckets (emulated), the call's split by device
activity (profiler) and, where the tree's K6 reports them
(``kernels.dedup.cluster_steps``), each cluster's end and the slowest
cluster's split into the kernel's steps.  Prints one JSON line and writes
it to ``chiprun_out/profile_k6_<tag>.json``.  To compare two trees on one
card, run both in one command, in turns:

    python3 scripts/profile_torch_k6.py --tree build/parent --tag parent
    python3 scripts/profile_torch_k6.py --tag new
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOG_NB = 10  # K6's first digit: 1024 buckets (csrc/select_core.cuh)


def first_digit_buckets(args):
    """Per utterance of one K6 call, emulated on the card with torch: the
    largest bucket of K6's first digit over the winners, and the bucket
    that holds the K-th key (what the select core ranks or refines)."""
    import torch

    dst, cost, K, S = args
    largest, kth = [], []
    for b in range(dst.shape[0]):
        fin = torch.isfinite(cost[b]) & (dst[b] >= 0) & (dst[b] < S)
        if not bool(fin.any()):
            largest.append(0)
            kth.append(0)
            continue
        c, d = cost[b][fin], dst[b][fin].long()

        def tok(x):
            u = x.contiguous().view(torch.int32).long() & 0xFFFFFFFF
            return torch.where(u >= 2**31, (~u) & 0xFFFFFFFF, u | 2**31)

        t = tok(c)
        tmin, tmax = int(t.min()), int(t.max())
        best = torch.full((S,), 2**40, dtype=torch.long, device=c.device)
        best = best.scatter_reduce(0, d, t, "amin")
        st = torch.nonzero(best < 2**40).squeeze(1)
        dt = best[st] - tmin
        shift = max(0, (((tmax - tmin) << 32) | (S - 1)).bit_length() - LOG_NB)
        q = dt >> (shift - 32) if shift >= 32 else (dt << (32 - shift)) | (st >> shift)
        counts = torch.bincount(q)
        order = torch.argsort(dt * (1 << 20) + st) if shift >= 32 else torch.argsort(q)
        largest.append(int(counts.max()))
        kth.append(int(counts[q[order[min(K, len(st)) - 1]]]))
    return largest, kth


def h_emitting_args(cs, scores_tm):
    """K6's arguments on the emitting candidates of frame max(K6_FRAMES)
    of the batched Viterbi decode on H at ``H_CONFIG``, each frame of
    K6_FRAMES held against the plain version on the way."""
    import torch

    from kaldi_decoder_tpu_torch import BatchedViterbiDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.decoders.frontier import frame_step_batched

    hg = cs.h_graph()
    vdec = BatchedViterbiDecoder(hg, config_for_graph(hg, **cs.H_CONFIG), device="cuda")
    S = vdec._dev_graph.num_states
    active = torch.ones(cs.B, dtype=torch.bool, device="cuda")
    st, _ = vdec._init(cs.B)
    for t in range(max(cs.K6_FRAMES) + 1):
        if t in cs.K6_FRAMES:
            em_args = cs.check_emit_kernels(st, scores_tm[t], vdec._pg, vdec.cfg, S,
                                            f"H, frame {t}")[3]
        st, _ = frame_step_batched(st, scores_tm[t], active, vdec._pg, vdec.cfg, S)
    return em_args


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k6: no CUDA device")
    # The smoke's helpers come from this checkout; the package they import
    # at call time is the tree's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch import BatchedViterbiDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.kernels import dedup as k6
    from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    graph, scores, _, _ = cs.bench_workload()
    with open(os.path.join(REPO, "tests", "data", "torch_port_viterbi_ref.json")) as f:
        vref = json.load(f)
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    vfc = config_for_graph(graph, **cs.VITERBI_CONFIG)
    vdec = BatchedViterbiDecoder(graph, vfc, device="cuda")
    edec = BatchedViterbiDecoder(graph, vfc, fold=False, device="cuda")
    v = cs.viterbi_k6_calls(vdec, edec, scores_tm)
    del vdec, edec
    s = cs.streaming_k6_calls(cs.streaming_decoder(graph, vref), scores_tm)
    calls = {"emitting B=16": v["em_args"], "eps B=16": v["eps_args"],
             "emitting B=1": s["em_args"], "eps B=1": s["eps_args"],
             "emitting H B=16": h_emitting_args(cs, scores_tm)}
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "calls": {}}
    for name, a in calls.items():
        t = dict(
            B=a[0].shape[0], N=a[0].shape[1], K=a[2], winners=cs.k6_winners(a),
            ms=cs.device_ms(lambda: dedup_select(*a)),
            plain_ms=cs.device_ms(lambda: dedup_select_plain(*a)),
            split=[(n, us, gap) for n, us, gap in cs.kernel_split(lambda: dedup_select(*a))],
        )
        t["bound_ms"], t["bound_by"] = cs.bound_ms(*cs.k6_work(*a[1:3]))
        t["largest_bucket"], t["kth_bucket"] = first_digit_buckets(a)
        cs.log(f"  first-digit buckets: largest {t['largest_bucket']}, "
               f"holding the K-th key {t['kth_bucket']}")
        if hasattr(k6, "cluster_steps"):  # the kernel's own steps
            dedup_select(*a)
            c = k6.cluster_steps(t["B"], t["N"])
            t.update(clusters=c["clusters"], cluster_end_us=c["ends_us"],
                     slowest_cluster=c["slowest"], steps_us=c["steps_us"])
            cs.log(f"  clusters of {c['clusters']}, ends (µs) "
                   + ", ".join(f"{x:.2f}" for x in c["ends_us"])
                   + f"; the slowest, utterance {c['slowest']}, in steps (µs): "
                   + ", ".join(f"{k} {v:.2f}" for k, v in c["steps_us"].items()))
        cs.log(f"{args.tag} K6 {name} (N {t['N']}, K {t['K']}, winners {t['winners']}): "
               f"device {t['ms']:.4f} ms per call, plain {t['plain_ms']:.4f}, bound "
               f"{t['bound_ms']:.4f} ({t['bound_by']}); {cs.format_split(t['split'])}")
        out["calls"][name] = t
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_k6_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
