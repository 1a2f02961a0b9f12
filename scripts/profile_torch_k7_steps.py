#!/usr/bin/env python3
"""K7's send side on the card: where a launch's time goes, on one NVIDIA card.

Builds ``kaldi_decoder_tpu_torch/csrc/route.cu`` with its step marks on
(``-DKD_STEP_MARKS``: thread 0 of block 0 of each of the first 16 rows'
clusters stores the global timer at the kernel's start and after each of
its four steps, and each row's valid lanes, sort passes and key passes)
into a
library of its own under ``kaldi_decoder_tpu_torch/_build/steps/``.
Then, on seeded lanes at the sharded frame's shapes (B=16, N 30,720 and
3,072, P = 1 and 2, leaders only and the lattice slack beam; the bench
graph's 102,298 states split over the parts, about four lanes a
destination, a fifth of the lanes +inf, costs on a 0.25 grid; and at P =
1 the same lanes with one run of 4,096 lanes a row (2,048 at N 3,072) to
one state, their costs falling in lane order, and lanes drawn from N / 100
states, runs of about 80 lanes),
it holds the marked kernel bitwise against ``route_send_plain`` at its
chosen cluster size, times it there and at each cluster size (device ms
per call, 10 calls queued back to back, CUDA events; the marks cost a
little) and splits the chosen size's last launch's rows into their steps
(µs, in the kernel's order: the compaction of the valid lanes; each
radix pass's count, totals' exchange through the cluster and scatter, on
the cost key first on a lattice call, then on the destination; the runs
and kept counts; the kept counts' exchange; the kept lanes' writes; the
fill).
With ``--tree DIR`` it builds that checkout's ``route.cu`` instead,
without the marks (so an older send side, whose marks may differ, can be
timed on the same lanes: held against plain and timed, no steps), and
tags the output ``--tag``.  Prints one JSON line and writes it to
``chiprun_out/profile_k7_steps[_<tag>].json``:

    python3 scripts/profile_torch_k7_steps.py
    python3 scripts/profile_torch_k7_steps.py --tree build/parent --tag parent
"""

import argparse

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MARKED, STEP_MARKS = 16, 7 + 3 * 8  # csrc/route.cu
# csrc/route.cu's marks by index: what ends at each.
MARK_NAMES = (["start", "compaction", "sort's last barrier", "runs and kept counts",
               "kept counts' exchange", "kept lanes' writes", "fill"]
              + [f"pass {p} {s}" for p in range(8)
                 for s in ("count (with the last pass's barrier)", "totals' exchange",
                           "scatter")])
SLACK = 8.0 + 1e-4  # the sharded lattice path's slack beam at lattice beam 8
STATES = 102298  # the bench graph's states (chip_smoke.py's sharded phases)
REPS = 10


def build(tree=None):
    """The marked library, built from this checkout's sources; or the
    unmarked one of ``tree``'s."""
    from kaldi_decoder_tpu_torch.kernels._build import CSRC_DIR, _nvcc

    csrc = CSRC_DIR if tree is None else os.path.join(tree, "kaldi_decoder_tpu_torch", "csrc")
    out_dir = os.path.join(REPO, "kaldi_decoder_tpu_torch", "_build", "steps")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "k7_steps.so" if tree is None else "k7_tree.so")
    marks = ["-DKD_STEP_MARKS"] if tree is None else []
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC"] + marks + ["-I", csrc, "-o", lib,
                                                       os.path.join(csrc, "route.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the marked K7 failed:\n{proc.stderr}")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    dll.kd_route_send.restype = I
    dll.kd_route_send.argtypes = [P] * 6 + [I] * 9 + [F] + [P] * 6 + [I, P]
    dll.kd_route_send_cluster.restype = I
    dll.kd_route_send_cluster.argtypes = [I]
    if tree is None:
        dll.kd_route_send_marks.argtypes = [P]
    return dll


def lanes(seed, nb, N, P, hub=0, per_state=4):
    """Seeded (dst, cost, src, arc, Sp) lanes of one send call: the bench
    graph's 102,298 states split over P parts (17 bits of destination),
    the lanes' destinations drawn from N / ``per_state`` of them; with
    ``hub``, that many lanes a row go to one state, their costs falling in
    lane order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sp = -(-STATES // P)
    states = rng.choice(P * sp, size=N // per_state, replace=False)
    dst = rng.choice(states, size=(nb, N)).astype(np.int32)
    cost = (rng.integers(-4, 60, size=(nb, N)) * 0.25).astype(np.float32)
    cost[:, 3::5] = np.inf
    src = rng.integers(0, 2048, size=(nb, N)).astype(np.int32)
    arc = rng.integers(0, 1 << 20, size=(nb, N)).astype(np.int32)
    if hub:
        at = np.sort(rng.choice(N, size=hub, replace=False))
        dst[:, at] = states[0]
        cost[:, at] = np.linspace(40.0, -2.0, hub, dtype=np.float32)
    return dst, cost, src, arc, sp


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def measure(dll, N, P, beam, hub=0, per_state=4, marked=True):
    """The marked send side on one set of lanes: held against plain, timed
    and split into its steps."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.kernels.route import empty_route_send, route_send_plain

    dst, cost, src, arc, sp = lanes(N + P, 16, N, P, hub, per_state)
    t = [torch.from_numpy(x).cuda() for x in (dst, cost, src, arc)]
    want = route_send_plain(*t, sp, P, N, beam)
    out = empty_route_send(16, N, P, N, "cuda")
    args = [ctypes.c_void_p(x.data_ptr()) for x in t] + [None, None, 16, N, 0, sp, P, N, 0, 0,
                                                         int(beam is not None),
                                                         ctypes.c_float(beam or 0.0)]
    args += [ctypes.c_void_p(x.data_ptr()) for x in out.scratch + (out.buf, out.overflow)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def call(clusters=0):
        rc = dll.kd_route_send(*args, clusters, stream)
        if rc != 0:
            raise RuntimeError(f"kd_route_send: CUDA error {rc}")

    def timed(clusters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            call(clusters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / REPS

    by_clusters = {}
    for g in (1, 2, 4, 8):
        call(g)
        torch.cuda.synchronize()
        if not (torch.equal(out.buf, want.buf) and torch.equal(out.overflow, want.overflow)):
            raise AssertionError(f"the marked K7 differs from plain at N {N}, P {P}, G {g}")
        by_clusters[g] = timed(g)
    call()
    torch.cuda.synchronize()
    if not (torch.equal(out.buf, want.buf) and torch.equal(out.overflow, want.overflow)):
        raise AssertionError(f"the marked K7 differs from plain at N {N}, P {P}")
    ms = timed(0)
    row = dict(N=N, P=P, slack=beam, hub=hub, per_state=per_state, clusters=dll.kd_route_send_cluster(N), ms=ms,
               ms_by_clusters=by_clusters)
    if not marked:
        return row
    marks = np.zeros((MARKED, STEP_MARKS + 3), np.int64)
    if dll.kd_route_send_marks(marks.ctypes.data) != 0:
        raise RuntimeError("reading the marks failed")
    passes = int(marks[0, STEP_MARKS + 1])
    used = list(range(7)) + list(range(7, 7 + 3 * passes))
    order = sorted(used, key=lambda i: marks[0, i])  # the marks in the kernel's order
    us = (np.diff(marks[:, order], axis=1) / 1e3).mean(axis=0)
    return dict(row, valid_lanes=float(marks[:, STEP_MARKS].mean()), sort_passes=passes,
                key_passes=int(marks[0, STEP_MARKS + 2]),
                steps_us={MARK_NAMES[i]: float(u) for i, u in zip(order[1:], us)})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="root of a checkout whose send side is timed instead (no marks)")
    ap.add_argument("--tag", default="", help="name of the output file's run")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k7_steps: no CUDA device")
    tree = os.path.abspath(args.tree) if args.tree else None
    dll = build(tree)
    out = []
    for N, hub, per_state in ((30720, 0, 4), (3072, 0, 4), (30720, 4096, 4), (3072, 2048, 4),
                              (30720, 0, 100)):
        for P in (1, 2) if (hub, per_state) == (0, 4) else (1,):
            for beam in (None, SLACK):
                row = measure(dll, N, P, beam, hub, per_state, marked=tree is None)
                out.append(row)
                by = ", ".join(f"G {g} {t:.4f}" for g, t in row["ms_by_clusters"].items())
                head = (f"K7 send{' ' + args.tag if args.tag else ''}, N {N}, P {P}, "
                        f"{'slack' if beam else 'leaders'}, hub {hub}, {per_state} lanes a state: "
                        f"{row['ms']:.4f} ms a call "
                        f"at G {row['clusters']} ({by})")
                if tree is not None:
                    print(head, flush=True)
                    continue
                steps = ", ".join(f"{s} {u:.1f}" for s, u in row["steps_us"].items())
                print(f"{head}; {row['valid_lanes']:.0f} valid lanes a row, "
                      f"{row['sort_passes']} sort passes ({row['key_passes']} on the cost key); "
                      f"µs a row: {steps}", flush=True)
    line = json.dumps({"card": card_line(), "tree": tree, "k7_send_steps": out})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    name = f"profile_k7_steps{'_' + args.tag if args.tag else ''}.json"
    with open(os.path.join(REPO, "chiprun_out", name), "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
