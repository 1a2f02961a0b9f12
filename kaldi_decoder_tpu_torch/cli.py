"""Command-line decoding on the card, mirroring the icefall decode-script
workflow (the reference's `README.md:16-20`: load graph, load posteriors,
decode, map output labels to words).

The port of ``kaldi_decoder_tpu/cli.py``: the same ``decode`` and ``info``
subcommands, flags and JSON output lines, plus ``--device`` (default
``cuda``; without a card the command exits non-zero unless given
``--device cpu``).  The graph is loaded with :func:`load_graph` (parsed
and compiled in C++), where the original builds a Python FST with
``read_fst`` and compiles it; both give the same ``CsrGraph``.

Usage:
  python -m kaldi_decoder_tpu_torch.cli decode --graph HLG.fst --logits utt.npy
  python -m kaldi_decoder_tpu_torch.cli decode --graph H.fst --logits a.npy b.npy \\
      --decoder lattice --lattice-dir lats/ --words words.txt --nbest 10 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _load_words(path):
    """OpenFst symbol table text format: '<word> <id>' per line."""
    table = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                table[int(parts[1])] = parts[0]
    return table


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"kaldi_decoder_tpu_torch: --device {name}: no CUDA device "
            "(torch.cuda.is_available() is false); pass --device cpu to decode on the CPU"
        )
    return device


def make_decoder(args, graph, device):
    """The streaming decoder ``decode`` runs: ``FasterDecoder`` or
    ``LatticeFasterDecoder`` with the command's options, on ``device``."""
    from kaldi_decoder_tpu_torch import (
        FasterDecoder,
        FasterDecoderOptions,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
    )

    if args.decoder == "faster":
        opts = FasterDecoderOptions(
            beam=args.beam, max_active=args.max_active, min_active=args.min_active
        )
        return FasterDecoder(graph, opts, device=device)
    cfg = LatticeFasterDecoderConfig(
        beam=args.beam,
        max_active=args.max_active,
        min_active=args.min_active,
        lattice_beam=args.lattice_beam,
    )
    return LatticeFasterDecoder(graph, cfg, device=device)


def _words(labels, words):
    return " ".join(words.get(l, f"<{l}>") for l in labels) if words else " ".join(
        map(str, labels))


def cmd_decode(args) -> int:
    from kaldi_decoder_tpu_torch.decodable import DecodableCtc
    from kaldi_decoder_tpu_torch.fst import load_graph, path_labels, write_fst
    from kaldi_decoder_tpu_torch.lattice.post import nbest

    device = _device(args.device)
    dec = make_decoder(args, load_graph(args.graph), device)
    words = _load_words(args.words) if args.words else None

    for path in args.logits:
        t0 = time.time()
        logits = np.load(path)
        if args.apply_log_softmax:
            m = logits - logits.max(axis=-1, keepdims=True)
            logits = m - np.log(np.exp(m).sum(axis=-1, keepdims=True))
        dec.decode(DecodableCtc(logits.astype(np.float32)))
        ok, best = dec.get_best_path()
        elapsed = time.time() - t0
        if not ok:
            print(json.dumps({"utt": path, "error": "no tokens survived"}))
            continue
        out = {
            "utt": path,
            "hyp": _words(path_labels(best), words),
            "reached_final": bool(dec.reached_final()),
            "seconds": round(elapsed, 3),
        }
        if args.decoder == "lattice":
            if args.lattice_dir:
                okl, lat = dec.get_raw_lattice()
                if okl:
                    dst = os.path.join(args.lattice_dir, os.path.basename(path) + ".lat.fst")
                    write_fst(lat, dst)
                    out["lattice"] = dst
            if args.nbest > 1:
                okl, lat = dec.get_raw_lattice()
                if okl:
                    out["nbest"] = [
                        {"hyp": _words(ols, words), "cost": round(g + a, 4)}
                        for _, ols, g, a in nbest(lat, args.nbest, unique_word_sequences=True)
                    ]
        print(json.dumps(out))
    return 0


def cmd_info(args) -> int:
    from kaldi_decoder_tpu_torch.fst import load_graph

    g = load_graph(args.graph)
    print(
        json.dumps(
            {
                "num_states": g.num_states,
                "num_emitting_arcs": g.num_emitting_arcs,
                "num_eps_arcs": g.num_eps_arcs,
                "start_state": g.start_state,
                "eps_depth": g.eps_depth,
                "max_em_out_degree": g.max_em_out_degree,
                "max_score_idx": g.max_score_idx,
            }
        )
    )
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kaldi_decoder_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("decode", help="decode CTC log-probs through a WFST")
    d.add_argument("--graph", required=True, help="OpenFst binary H/HL/HLG")
    d.add_argument("--logits", nargs="+", required=True, help=".npy (T, V) files")
    d.add_argument("--decoder", choices=["faster", "lattice"], default="lattice")
    d.add_argument("--beam", type=float, default=16.0)
    d.add_argument("--max-active", type=int, default=7000)
    d.add_argument("--min-active", type=int, default=200)
    d.add_argument("--lattice-beam", type=float, default=10.0)
    d.add_argument("--words", help="words.txt symbol table for olabels")
    d.add_argument("--lattice-dir", help="write raw lattices here")
    d.add_argument("--nbest", type=int, default=1)
    d.add_argument(
        "--apply-log-softmax",
        action="store_true",
        help="logits are unnormalized; apply log-softmax first",
    )
    d.add_argument("--device", default="cuda", help="torch device to decode on (cuda or cpu)")
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("info", help="print compiled graph statistics")
    i.add_argument("--graph", required=True)
    i.set_defaults(fn=cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
