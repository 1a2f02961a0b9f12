#!/usr/bin/env python3
"""K7's send side on the card: where a launch's time goes, on one NVIDIA card.

Builds ``kaldi_decoder_tpu_torch/csrc/route.cu`` with its step marks on
(``-DKD_STEP_MARKS``: thread 0 of each of the first 16 rows' blocks stores
the global timer at the kernel's start and after each of its four steps,
and each row's valid lanes and sort passes) into a library of its own
under ``kaldi_decoder_tpu_torch/_build/steps/``.  Then, on seeded lanes
at the sharded frame's shapes (B=16, N 30,720 and 3,072, P = 1 and 2,
leaders only and the lattice slack beam; about four lanes a destination,
a fifth of the lanes +inf, costs on a 0.25 grid), it holds the marked
kernel bitwise against ``route_send_plain``, times it (device ms per
call, 10 calls queued back to back, CUDA events; the marks cost a little)
and splits the last launch's rows into their steps (µs: the compaction of
the valid lanes, the radix sort's passes, the pass of leaders, counts and
writes, the fill).  Prints one JSON line and writes it to
``chiprun_out/profile_k7_steps.json``:

    python3 scripts/profile_torch_k7_steps.py
"""

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

STEPS = ("compaction", "sort", "leaders, counts and writes", "fill")
MARKED, STEP_MARKS = 16, 5  # csrc/route.cu
SLACK = 8.0 + 1e-4  # the sharded lattice path's slack beam at lattice beam 8
REPS = 10


def build():
    """The marked library, built from this checkout's sources."""
    from kaldi_decoder_tpu_torch.kernels._build import CSRC_DIR, _nvcc

    out_dir = os.path.join(REPO, "kaldi_decoder_tpu_torch", "_build", "steps")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "k7_steps.so")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-DKD_STEP_MARKS", "-I", CSRC_DIR, "-o", lib,
           os.path.join(CSRC_DIR, "route.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the marked K7 failed:\n{proc.stderr}")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll = ctypes.CDLL(lib)
    dll.kd_route_send.restype = I
    dll.kd_route_send.argtypes = [P] * 6 + [I] * 9 + [F] + [P] * 6 + [P]
    dll.kd_route_send_marks.argtypes = [P]
    return dll


def lanes(seed, nb, N, P):
    """Seeded (dst, cost, src, arc, Sp) lanes of one send call."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sp = max(16, N // (4 * P))
    dst = rng.integers(0, P * sp, size=(nb, N)).astype(np.int32)
    cost = (rng.integers(-4, 60, size=(nb, N)) * 0.25).astype(np.float32)
    cost[:, 3::5] = np.inf
    src = rng.integers(0, 2048, size=(nb, N)).astype(np.int32)
    arc = rng.integers(0, 1 << 20, size=(nb, N)).astype(np.int32)
    return dst, cost, src, arc, sp


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def measure(dll, N, P, beam):
    """The marked send side on one set of lanes: held against plain, timed
    and split into its steps."""
    import numpy as np
    import torch

    from kaldi_decoder_tpu_torch.kernels.route import empty_route_send, route_send_plain

    dst, cost, src, arc, sp = lanes(N + P, 16, N, P)
    t = [torch.from_numpy(x).cuda() for x in (dst, cost, src, arc)]
    want = route_send_plain(*t, sp, P, N, beam)
    out = empty_route_send(16, N, P, N, "cuda")
    args = [ctypes.c_void_p(x.data_ptr()) for x in t] + [None, None, 16, N, 0, sp, P, N, 0, 0,
                                                         int(beam is not None),
                                                         ctypes.c_float(beam or 0.0)]
    args += [ctypes.c_void_p(x.data_ptr()) for x in out.scratch + (out.buf, out.overflow)]
    args.append(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def call():
        rc = dll.kd_route_send(*args)
        if rc != 0:
            raise RuntimeError(f"kd_route_send: CUDA error {rc}")

    call()
    torch.cuda.synchronize()
    if not (torch.equal(out.buf, want.buf) and torch.equal(out.overflow, want.overflow)):
        raise AssertionError(f"the marked K7 differs from plain at N {N}, P {P}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    end.synchronize()
    marks = np.zeros((MARKED, STEP_MARKS + 2), np.int64)
    if dll.kd_route_send_marks(marks.ctypes.data) != 0:
        raise RuntimeError("reading the marks failed")
    us = np.diff(marks[:, :STEP_MARKS], axis=1).mean(axis=0) / 1e3
    return dict(N=N, P=P, slack=beam, ms=start.elapsed_time(end) / REPS,
                valid_lanes=float(marks[:, STEP_MARKS].mean()),
                sort_passes=int(marks[0, STEP_MARKS + 1]),
                steps_us={s: float(u) for s, u in zip(STEPS, us)})


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_k7_steps: no CUDA device")
    dll = build()
    out = []
    for N in (30720, 3072):
        for P in (1, 2):
            for beam in (None, SLACK):
                row = measure(dll, N, P, beam)
                out.append(row)
                steps = ", ".join(f"{s} {u:.1f}" for s, u in row["steps_us"].items())
                print(f"K7 send, N {N}, P {P}, {'slack' if beam else 'leaders'}: "
                      f"{row['ms']:.4f} ms a call; {row['valid_lanes']:.0f} valid lanes a "
                      f"row, {row['sort_passes']} sort passes; µs a row: {steps}", flush=True)
    line = json.dumps({"card": card_line(), "k7_send_steps": out})
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_k7_steps.json"), "w") as f:
        f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
