#!/usr/bin/env python3
"""K8's merge (the sharded GetCutoff after its collectives) of one tree of the torch port, on one NVIDIA card.

Builds the kernels of the port under ``--tree`` (default: this checkout)
and runs its ``global_cutoff_merge`` on synthetic shards at the sharded
phases' config (B=16, m 2048, max_active 2560, min_active 200; each
prefix in order, with ties within and across shards, -0.0 beside +0.0
and +inf tails) at P = 1, 2, 4 and 8: bitwise against its plain version,
then timed with ``chip_smoke.py``'s own ``time_kernel`` (device ms per
call, CUDA events; the bound from ``chip_smoke.py``'s ``k8_merge_work``).
Prints one JSON line and writes it to
``chiprun_out/profile_k8_merge_<tag>.json``.  To compare two trees on
one card, run both in one command, in turns:

    python3 scripts/profile_torch_k8_merge.py --tree build/parent --tag parent
    python3 scripts/profile_torch_k8_merge.py --tag new
    python3 scripts/profile_torch_k8_merge.py --tag new2
    python3 scripts/profile_torch_k8_merge.py --tree build/parent --tag parent2
"""

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("ms", "plain_ms", "bound_ms", "bound_by", "share_of_bound")


def merge_shards(P, nb, m, seed):
    """(P, nb, m) float32 prefixes in IEEE total order: costs on a 0.25
    grid (ties within and across shards), a run of -0.0 and +0.0 in
    turn, +inf tails of different lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 120, size=(P, nb, m)) * 0.25).astype(np.float32)
    rows[:, :, : m // 16] = np.where(np.arange(m // 16) % 2, -0.0, 0.0).astype(np.float32)
    for q in range(P):
        rows[q, :, m - int(rng.integers(0, m // 4)):] = np.inf
    u = rows.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000)
    return np.take_along_axis(rows, np.argsort(key, axis=2, kind="stable"), axis=2)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=REPO, help="root of the checkout whose port is timed")
    ap.add_argument("--tag", default="new", help="name of the output file's run")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k8_merge: no CUDA device")
    # The smoke's helpers come from this checkout; the package timed is
    # the tree's.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    import kaldi_decoder_tpu_torch
    from kaldi_decoder_tpu_torch.kernels._build import kernels
    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        global_cutoff_merge,
        global_cutoff_merge_plain,
    )

    card = cs.card_line()
    cs.log(card)
    cs.log(f"port under test: {os.path.dirname(kaldi_decoder_tpu_torch.__file__)}")
    kernels()
    out = {"tag": args.tag, "card": card, "tree": os.path.abspath(args.tree), "k8_merge": {}}
    nb, m, max_active, min_active, beam, delta = 16, 2048, 2560, 200, 15.0, 0.5
    for P in (1, 2, 4, 8):
        merged = torch.from_numpy(np.ascontiguousarray(merge_shards(P, nb, m, P)))
        count = torch.isfinite(merged).sum(dim=(0, 2), dtype=torch.int32)
        best = torch.where(torch.isfinite(merged), merged, np.inf).amin(dim=(0, 2))
        a = (best, count, merged, beam, delta, max_active, min_active)
        want = global_cutoff_merge_plain(*a)
        ca = tuple(x.cuda() if torch.is_tensor(x) else x for x in a)
        got = global_cutoff_merge(*ca)
        torch.cuda.synchronize()
        for f, w, g in zip(want._fields, want, got):
            if not torch.equal(w.view(torch.int32), g.cpu().view(torch.int32)):
                raise AssertionError(f"K8 merge at P={P}: {f} differs from plain")
        t = cs.time_kernel(f"K8 merge, synthetic shards, P={P}", lambda: global_cutoff_merge(*ca),
                           lambda: global_cutoff_merge_plain(*ca), cs.k8_merge_work(*ca))
        out["k8_merge"][f"P{P}"] = {k: t[k] for k in FIELDS}
    line = json.dumps(out)
    print(line)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", f"profile_k8_merge_{args.tag}.json"), "w") as f:
        f.write(line + "\n")


if __name__ == "__main__":
    main()
