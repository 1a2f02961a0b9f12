#!/usr/bin/env python3
"""K2 (``dedup_select_rec``) of one tree of the torch port, on the lanes of
the bench's lattice frames 150 and 250, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed and runs that tree's lattice
frame step from the start; on each frame of ``FRAMES`` it takes the lanes
K1 gives there (the arguments the frame passes to K2, as ``chip_smoke.py``
phase 2 does), holds K2 against the plain version bitwise, and times it:
device ms per call (10 calls queued back to back, CUDA events), the plain
version's device ms, the bound (``chip_smoke.k2_work``), the call's split
by device activity (profiler), the records per utterance and the largest
group of extras that share one slack, each cluster's end, the split of the
slowest cluster's first block into the kernel's steps
(``kernels.dedup_rec.cluster_steps``) and the block with the longest
"record ranks" step with its split.  Prints one JSON line and writes it to
``chiprun_out/profile_k2_<tag>.json``.  To compare two trees on one card,
run both in one command, in turns:

    python3 scripts/profile_torch_k2.py --tree build/parent --tag parent
    python3 scripts/profile_torch_k2.py --tag new
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = (150, 250)


def equal_slack_groups(ref):
    """Per utterance of the plain result: the size of the largest group of
    extras (records of nonzero slack) that share one slack value."""
    import torch

    out = []
    for b in range(ref.rec_dst.shape[0]):
        s = ref.rec_slack[b][(ref.rec_dst[b] >= 0) & (ref.rec_slack[b] > 0)]
        out.append(int(torch.unique(s, return_counts=True)[1].max()) if s.numel() else 0)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k2: no CUDA device")
    # The smoke's helpers come from this checkout; the package they import
    # at call time is the tree's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, config_for_graph
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_frame_step_batched
    from kaldi_decoder_tpu_torch.kernels import dedup as k6
    from kaldi_decoder_tpu_torch.kernels import dedup_rec as k2
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
    from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as plain

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    graph, scores, lengths, _ = cs.bench_workload()
    dec = BatchedLatticeDecoder(graph, config_for_graph(graph, **cs.BENCH_CONFIG),
                                device="cuda", **cs.DECODER_KW)
    fc, S = dec.cfg.frontier, dec._dev_graph.num_states
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    rem = torch.from_numpy(lengths).cuda()
    st, _, _, _ = dec._init(cs.B)
    calls = {}
    for t in range(max(FRAMES) + 1):
        if t in FRAMES:
            cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                             costs_sorted=True)
            ex = expand_filter(st.states, st.costs, cut.cutoff, cut.adaptive_beam,
                               scores_tm[t], dec._pg, fc)
            calls[t] = (ex.dst, ex.cost, fc.frontier_size, S, dec.cfg.em_records,
                        dec.cfg.lattice_beam + 1e-4, (ex.src_state, ex.arc_id))
        st, _ = lattice_frame_step_batched(st, scores_tm[t], rem > t, dec._pg, dec.cfg, S)
    del st, dec
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "frames": {}}
    for t, a in calls.items():
        Bk, N = a[1].shape
        ref = plain(*a)
        got = k2.dedup_select_rec(*a)
        torch.cuda.synchronize()
        cs.same_records(ref, got, f"the lanes of lattice frame {t}")
        r = dict(B=Bk, N=N, K=a[2], R=a[4],
                 records=(ref.rec_dst >= 0).sum(dim=1).tolist(),
                 rec_overflow=ref.rec_overflow.tolist(),
                 largest_equal_slack=equal_slack_groups(ref),
                 ms=cs.device_ms(lambda: k2.dedup_select_rec(*a)),
                 plain_ms=cs.device_ms(lambda: plain(*a)),
                 split=cs.kernel_split(lambda: k2.dedup_select_rec(*a)))
        r["bound_ms"], r["bound_by"] = cs.bound_ms(*cs.k2_work(*a))
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        k2.dedup_select_rec(*a)
        c = k2.cluster_steps(Bk, N)
        marks = k6.launch_marks(Bk * c["clusters"], "kd_dedup_rec_marks", k2.STEPS)
        ranks = [m["steps_us"]["record ranks"] for m in marks]
        worst = max(range(len(marks)), key=ranks.__getitem__)
        r.update(clusters=c["clusters"], cluster_end_us=c["ends_us"], slowest_cluster=c["slowest"],
                 steps_us=c["steps_us"], slowest_ranks_block=worst,
                 slowest_ranks_block_steps_us=marks[worst]["steps_us"],
                 record_ranks_us=ranks)
        cs.log(f"{args.tag} K2 lattice frame {t} (N {N}, K {a[2]}, R {a[4]}; records per "
               f"utterance {r['records']}; largest equal-slack group {r['largest_equal_slack']}): "
               f"device {r['ms']:.4f} ms per call, plain {r['plain_ms']:.4f}, bound "
               f"{r['bound_ms']:.4f} ({r['bound_by']}), {r['share_of_bound']:.1%} of it; "
               f"{cs.format_split(r['split'])}")
        cs.log(f"  clusters of {c['clusters']}, ends (µs) "
               + ", ".join(f"{x:.2f}" for x in c["ends_us"])
               + f"; the slowest, utterance {c['slowest']}, in steps (µs): "
               + ", ".join(f"{k} {v:.2f}" for k, v in c["steps_us"].items()))
        cs.log(f"  longest record ranks: block {worst} (utterance {worst // c['clusters']}), "
               "in steps (µs): "
               + ", ".join(f"{k} {v:.2f}" for k, v in marks[worst]["steps_us"].items()))
        out["frames"][str(t)] = r
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_k2_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
