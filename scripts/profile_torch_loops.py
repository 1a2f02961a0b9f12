#!/usr/bin/env python3
"""The eps paths' frame loops of one tree of the torch port, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed and measures, with
``chip_smoke.py``'s own ``loop_walls``, the loops its phases 5, 6 and 7
measure: ``FasterDecoder`` over utterance 0's first 300 frames, 100 a
call (S); the unfolded lattice decoder's chunk loop over its first 200
frames at B=16 (U); ``LatticeFasterDecoder`` over utterance 0's first 300
frames (LF).  Each is replayed from the frame driver's captured graph and
run as the loop before the driver, in turns: wall ms a frame, device ms
and device activities a frame (one profiled run of each), busy share.
Prints one JSON line and writes it to
``chiprun_out/profile_loops_<tag>.json``.  To compare two trees on one
card, run both in one command, in turns:

    python3 scripts/profile_torch_loops.py --tree build/parent --tag parent
    python3 scripts/profile_torch_loops.py --tag new
    python3 scripts/profile_torch_loops.py --tag new2
    python3 scripts/profile_torch_loops.py --tree build/parent --tag parent2
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_loops: no CUDA device")
    # The smoke's helpers come from this checkout; the package they import
    # at call time is the tree's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk
    from kaldi_decoder_tpu_torch.kernels._build import kernels

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    kernels()
    graph, scores, lengths, refs = cs.bench_workload()
    vref = cs.load_reference("torch_port_viterbi_ref.json", scores, lengths, refs)
    lref = cs.load_reference("torch_port_lattice_eps_ref.json", scores, lengths, refs)
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "loops": {}}
    first = scores[0, :cs.WALL_STREAM_FRAMES]

    fd = cs.streaming_decoder(graph, vref)
    out["loops"]["S"] = cs.loop_walls("S, FasterDecoder on utterance 0", cs.stream_run(fd, first),
                                      cs.WALL_STREAM_FRAMES)
    del fd

    udec = cs.unfolded_lattice_decoder(graph)
    sc_w = torch.from_numpy(np.ascontiguousarray(
        scores.transpose(1, 0, 2)[:cs.WALL_FRAMES])).cuda()
    rem = torch.from_numpy(lengths).cuda()
    st0, S = udec._init(cs.B)[0], udec._dev_graph.num_states
    out["loops"]["U"] = cs.loop_walls(
        "U, the unfolded lattice chunk loop",
        lambda: lattice_chunk(udec._pg, sc_w, rem, st0, udec.cfg, S), cs.WALL_FRAMES)
    del udec, st0, sc_w

    ld = cs.streaming_lattice_decoder(graph, lref)
    out["loops"]["LF"] = cs.loop_walls("LF, LatticeFasterDecoder on utterance 0",
                                       cs.stream_run(ld, first), cs.WALL_STREAM_FRAMES)
    del ld

    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_loops_{args.tag}.json"), "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
