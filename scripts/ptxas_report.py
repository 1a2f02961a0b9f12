#!/usr/bin/env python3
"""The register, spill and shared-memory report of ``ptxas -v`` for the
port's CUDA kernels of one tree, one line a kernel instance.

Builds the kernel library of the port under ``--tree`` (default: this
checkout) as the port builds it (``kernels/_build.py``: ``nvcc -Xptxas -v``
for ``sm_90a``, one compiler a source) and prints, for every kernel whose
mangled name holds one of ``--match`` (default: the dedup calls K6 and
K2, the shard modes of the eps step and K3, K8), its registers, its
spill stores and loads and its stack frame, and writes the lines to
``chiprun_out/ptxas_<tag>.txt``.  Needs ``nvcc``; to compare two trees,
run it for both in one command:

    python3 scripts/ptxas_report.py --tree build/parent --tag parent
    python3 scripts/ptxas_report.py --tag new
"""

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MATCH = ("dedup_kernel", "dedup_rec_kernel", "eps_step_shard_kernel", "eps_reduce_shard_kernel",
         "frame_start_shard_kernel", "frame_tail_shard_kernel", "cutoff_local_kernel")


def report(log: str, match) -> list:
    """(entry, registers, spill stores, spill loads, stack bytes) of each
    kernel of ``log`` (ptxas -v output) whose name holds one of ``match``."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1) if any(x in m.group(1) for x in match) else None
            spill = (0, 0)
            stack = 0
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            stack, spill = int(m.group(1)), (int(m.group(2)), int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((entry, int(m.group(1)), spill[0], spill[1], stack))
            entry = None
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose kernels are built")
    ap.add_argument("--tag", default="new", help="name of the output file")
    ap.add_argument("--match", nargs="*", default=list(MATCH),
                    help="substrings of the kernel names to report")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from kaldi_decoder_tpu_torch.kernels import _build

    if not _build.__file__.startswith(tree):
        raise SystemExit(f"imported {_build.__file__}, not the tree's")
    _build.kernels()
    log = _build.build_logs.get("kdtorch_kernels")
    if log is None:
        raise SystemExit("the library was built before this process: delete the tree's "
                         "kaldi_decoder_tpu_torch/_build and run again")
    lines = [f"{args.tag} {e}: {r} registers, {ss} B spill stores, {sl} B spill loads, "
             f"{st} B stack" for e, r, ss, sl, st in report(log, args.match)]
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"ptxas_{args.tag}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    main()
