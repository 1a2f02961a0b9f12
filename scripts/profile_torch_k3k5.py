#!/usr/bin/env python3
"""K3 (the frame tail) and K5 (the eps lanes) of one tree of the torch port,
at the main paths' shapes and at each cluster size, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed and holds and times, with
``chip_smoke.py``'s own helpers, what its phase 2 holds and times of the
two kernels: K3 on a frame of each path's own driver (the lattice,
unfolded lattice and 1-best frames at B=16, the streaming 1-best and
lattice frames at B=1; ``check_k3``) and K5 on the unfolded lattice
decode's frame 150 (B=16; ``hold_k5``) and on the streaming decoder's
frame 60 (B=1; ``streaming_k6_calls``).  Each is bitwise equal to its
plain version at its own and every cluster size, and timed at each
(device ms per call, 10 calls queued back to back, CUDA events), with its
bound.  A tree whose K3 takes no cluster size is timed at its own launch
alone.  Then an empty kernel's time.  Prints one JSON line and writes it
to ``chiprun_out/profile_k3k5_<tag>.json``.  To compare two trees on one
card, run both in one command, in turns:

    python3 scripts/profile_torch_k3k5.py --tree build/parent --tag parent
    python3 scripts/profile_torch_k3k5.py --tag new
"""

import argparse
import importlib.util
import inspect
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pick(t):
    """The timing fields kept of a ``time_kernel`` result."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound", "clusters",
            "ms_by_clusters", "share_by_clusters", "ms_by_blocks", "share_by_blocks")
    return {k: t[k] for k in keys if k in t}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k3k5: no CUDA device")
    # The smoke's helpers come from this checkout; the package they import
    # at call time is the tree's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch import (
        BatchedLatticeDecoder,
        BatchedViterbiDecoder,
        config_for_graph,
    )
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
        lattice_emit_stage,
        lattice_frame_step_batched,
    )
    from kaldi_decoder_tpu_torch.kernels import frame as kf
    from kaldi_decoder_tpu_torch.kernels._build import kernels

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    kernels()
    sizes = cs.CLUSTER_SIZES
    has_clusters = "clusters" in inspect.signature(kf.frame_tail).parameters
    if not has_clusters:
        # A tree whose K3 is one launch shape: its own launch alone.
        tail = kf.frame_tail

        def one_shape(s, tin, fc, clusters=0):
            tail(s, tin, fc)
        one_shape.launches = 0  # the tree's K3 counts on the name it calls itself by
        kf.frame_tail = one_shape
        kf.cluster_size = lambda b, k: 1

    def k3(*a):
        cs.CLUSTER_SIZES = sizes if has_clusters else ()
        try:
            return pick(cs.check_k3(*a))
        finally:
            cs.CLUSTER_SIZES = sizes

    graph, scores, lengths, refs = cs.bench_workload()
    vref = cs.load_reference("torch_port_viterbi_ref.json", scores, lengths, refs)
    lref = cs.load_reference("torch_port_lattice_eps_ref.json", scores, lengths, refs)
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    rem = torch.from_numpy(lengths).cuda()
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "k3": {}, "k5": {}}
    B, CH, F = cs.B, cs.CHUNK, cs.K2_FRAMES[0]

    dec = BatchedLatticeDecoder(graph, config_for_graph(graph, **cs.BENCH_CONFIG),
                                device="cuda", **cs.DECODER_KW)
    out["k3"]["lattice"] = k3("the lattice frame", True, dec._pg, dec.cfg,
                              dec._dev_graph.num_states, scores_tm[:CH], rem, dec._init(B)[0], F)
    del dec

    udec = cs.unfolded_lattice_decoder(graph)
    cfg, fc, S = udec.cfg, udec.cfg.frontier, udec._dev_graph.num_states
    st = udec._init(B)[0]
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    t5 = cs.K2_EPS_FRAMES[0]
    for t in range(t5):
        st, _ = lattice_frame_step_batched(st, scores_tm[t], active, udec._pg, cfg, S)
    mid, _, next_cutoff, _, _, _ = lattice_emit_stage(
        st, scores_tm[t5], udec._pg, fc, S, cfg.em_records, cfg.lattice_beam + 1e-4)
    out["k5"]["unfolded"] = pick(cs.hold_k5(mid, next_cutoff, udec._pg, fc, True,
                                            f"unfolded lattice frame {t5}", timed=True)[1])
    out["k3"]["unfolded"] = k3("the unfolded lattice frame", True, udec._pg, cfg, S,
                               scores_tm[:CH], rem, udec._init(B)[0], t5)
    del udec

    vdec = BatchedViterbiDecoder(graph, config_for_graph(graph, **cs.VITERBI_CONFIG),
                                 device="cuda")
    out["k3"]["viterbi"] = k3("the 1-best frame", False, vdec._pg, vdec.cfg,
                              vdec._dev_graph.num_states, scores_tm[:CH], rem,
                              vdec._init(B)[0], cs.K6_FRAMES[-1])
    del vdec

    fd = cs.streaming_decoder(graph, vref)
    sk = cs.streaming_k6_calls(fd, scores_tm)
    out["k5"]["streaming"] = pick(sk["k5"])
    out["k5"]["streaming_init"] = pick(sk["k5_init"])
    one_call = torch.tensor([cs.FRAMES_PER_CALL], dtype=torch.int32, device="cuda")
    fd.init_decoding()
    out["k3"]["streaming"] = k3("the streaming 1-best frame", False, fd._pg, fd._cfg,
                                fd._graph.num_states, scores_tm[:cs.FRAMES_PER_CALL, :1],
                                one_call, fd._state, cs.STREAM_FRAME)
    ld = cs.streaming_lattice_decoder(graph, lref)
    ld.init_decoding()
    out["k3"]["streaming_lattice"] = k3("the streaming lattice frame", True, ld._pg,
                                        ld._dev_cfg, ld._graph.num_states,
                                        scores_tm[:cs.FRAMES_PER_CALL, :1], one_call,
                                        ld._state, cs.STREAM_FRAME)
    if hasattr(kernels(), "kd_empty"):
        out["launch_floor_ms"] = cs.launch_floor(torch.device("cuda"))
        cs.log(f"  empty kernel: {out['launch_floor_ms']:.4f} ms per launch")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_k3k5_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
