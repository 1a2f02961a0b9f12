#!/usr/bin/env python3
"""K1 (``expand_filter``) and the row gather of one tree of the torch port,
at the main paths' shapes, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout),
rebuilds the bench workload from its seed and times that tree's K1 call
as the main paths make it (where the tree gathers each slot's row before
K1, the call is the gather and K1): the lattice call on lattice frame 150
(B=16), the call with source slots on batched Viterbi frame 150 (B=16)
and on frame 60 of the streaming decoder (B=1, its own frames of
utterance 0), the frames ``chip_smoke.py`` phase 2 times.  Each call is
held against the plain version bitwise and timed: device ms per call (10
calls queued back to back, CUDA events, the gaps between a call's kernels
included), its bound (``chip_smoke.k1_work``) and its split by device
activity.  Then the standalone row gather on the lattice frame's B*K
states and on the lane-packed table (against ``torch.index_select``, with
its split), and an empty kernel's time where the tree has one.  Prints
one JSON line and writes it to ``chiprun_out/profile_k1_<tag>.json``.  To
compare two trees on one card, run both in one command, in turns:

    python3 scripts/profile_torch_k1.py --tree build/parent --tag parent
    python3 scripts/profile_torch_k1.py --tag new
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frontier_at(step, st, frames):
    """The frontier after ``frames`` calls of ``step``."""
    for t in range(frames):
        st = step(st, t)
    return st


def k1_call(cs, name, st, scores_t, pg, cfg, with_src_slot):
    """One K1 call on frontier ``st``: checked against plain, timed, split."""
    import torch

    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
    from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

    cut = get_cutoff(st.costs, cfg.beam, cfg.max_active, cfg.min_active, cfg.beam_delta,
                     costs_sorted=True)
    args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_t, pg, cfg)

    def kern():
        return expand_filter(*args, with_src_slot=with_src_slot)

    ref = expand_filter_plain(*args, with_src_slot=with_src_slot)
    got = kern()
    torch.cuda.synchronize()
    cs.same_expansion(ref, got, name)
    r = dict(ms=cs.device_ms(kern), split=cs.kernel_split(kern))
    r["bound_ms"], r["bound_by"] = cs.bound_ms(*cs.k1_work(*args, with_src_slot=with_src_slot))
    r["share_of_bound"] = r["bound_ms"] / r["ms"]
    cs.log(f"  {name}: device {r['ms']:.4f} ms per call, bound {r['bound_ms']:.4f} "
           f"({r['share_of_bound']:.1%} of it); {cs.format_split(r['split'])}")
    return r


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k1: no CUDA device")
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
    from kaldi_decoder_tpu_torch.decoders.frontier import frame_step_batched
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_frame_step_batched
    from kaldi_decoder_tpu_torch.kernels._build import kernels
    from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    graph, scores, lengths, refs = cs.bench_workload()
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2))).cuda()
    on = torch.ones(cs.B, dtype=torch.bool, device="cuda")
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "calls": {}}

    lat_t = max(cs.K1_FRAMES)
    dec = BatchedLatticeDecoder(graph, config_for_graph(graph, **cs.BENCH_CONFIG),
                                device="cuda", **cs.DECODER_KW)
    S = dec._dev_graph.num_states
    st = frontier_at(lambda s, t: lattice_frame_step_batched(
        s, scores_tm[t], on, dec._pg, dec.cfg, S)[0], dec._init(cs.B)[0], lat_t)
    out["calls"]["lattice"] = k1_call(cs, f"lattice frame {lat_t}", st, scores_tm[lat_t],
                                      dec._pg, dec.cfg.frontier, False)
    states = st.states

    vit_t = max(cs.K6_FRAMES)
    vdec = BatchedViterbiDecoder(graph, config_for_graph(graph, **cs.VITERBI_CONFIG),
                                 device="cuda")
    Sv = vdec._dev_graph.num_states
    st = frontier_at(lambda s, t: frame_step_batched(
        s, scores_tm[t], on, vdec._pg, vdec.cfg, Sv)[0], vdec._init(cs.B)[0], vit_t)
    out["calls"]["viterbi"] = k1_call(cs, f"Viterbi frame {vit_t}, src_slot", st,
                                      scores_tm[vit_t], vdec._pg, vdec.cfg, True)
    del vdec

    vref = cs.load_reference("torch_port_viterbi_ref.json", scores, lengths, refs)
    fd = cs.streaming_decoder(graph, vref)
    fd.init_decoding()
    one = torch.ones(1, dtype=torch.bool, device="cuda")
    scores_u = scores_tm[:, :1]
    Sf = fd._graph.num_states
    st = frontier_at(lambda s, t: frame_step_batched(
        s, scores_u[t], one, fd._pg, fd._cfg, Sf)[0], fd._state, cs.STREAM_FRAME)
    out["calls"]["streaming"] = k1_call(cs, f"streaming frame {cs.STREAM_FRAME}, src_slot", st,
                                        scores_u[cs.STREAM_FRAME], fd._pg, fd._cfg, True)

    em_block = dec._pg.em_block
    out["gather"] = {}
    for name, table, idx in cs.gather_tables(em_block, states):
        if not torch.equal(row_gather(table, idx), row_gather_plain(table, idx)):
            raise AssertionError(f"row gather differs from plain on the {name} table")
        t = out["gather"][name] = cs.time_kernel(
            f"row gather, {name} {tuple(table.shape)}, {idx.numel()} rows",
            lambda: row_gather(table, idx), lambda: row_gather_plain(table, idx),
            cs.gather_work(table, idx), library=lambda: torch.index_select(table, 0, idx.flatten()))
        t["split"] = cs.kernel_split(lambda: row_gather(table, idx))
        cs.log(f"    {cs.format_split(t['split'])}")
    if hasattr(kernels(), "kd_empty"):
        out["launch_floor_ms"] = cs.launch_floor(em_block.device)
        cs.log(f"  empty kernel: {out['launch_floor_ms']:.4f} ms per launch")
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_k1_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
