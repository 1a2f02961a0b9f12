"""Build the port's native libraries at first use and load them with ctypes.

Each library's sources are compiled one process per source, all started
together, and linked into one shared library with a plain C interface:
the CUDA sources (``kaldi_decoder_tpu_torch/csrc/*.cu``) by ``nvcc`` for
``sm_90a``, every pointer and the stream crossing as ``c_void_p``; the
host library (``native.py``) by ``g++``.  Output goes to
``kaldi_decoder_tpu_torch/_build/`` under a name keyed by a hash of the
sources and the commands, so a changed source rebuilds and an unchanged
one loads the library already there.  A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from typing import List

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "csrc")

_lock = threading.Lock()
# Compiler output of the builds made by this process (``-Xptxas -v``
# register and shared-memory reports for the CUDA library).
build_logs: dict = {}


def build_library(name: str, sources: List[str], compile_cmd: List[str],
                  link_cmd: List[str]) -> str:
    """Build ``sources`` into ``_build/lib<name>-<hash>.so`` unless it is
    there; returns its path.  Every source is compiled on its own, all at
    once (``compile_cmd + ["-c", "-o", obj, src]``), and the objects are
    linked with ``link_cmd + ["-o", out] + objects``."""
    h = hashlib.sha256(" ".join(compile_cmd + link_cmd).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    for hdr in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(hdr, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    with _lock:
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
        cmds = [compile_cmd + ["-c", "-o", o, s] for s, o in zip(sources, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        logs = [p.communicate()[1] for p in procs]  # every compiler has ended
        try:
            for c, p, err in zip(cmds, procs, logs):
                if p.returncode != 0:
                    raise RuntimeError(f"building {name} failed ({' '.join(c)}):\n{err}")
            proc = subprocess.run(link_cmd + ["-o", tmp] + objs, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"linking {name} failed ({' '.join(link_cmd)}):\n{proc.stderr}")
        finally:
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        build_logs[name] = "".join(logs)
        os.replace(tmp, out)
    return out


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def check(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has this dtype, shape and device and is contiguous."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_like(got, want, name: str, device) -> None:
    """Raise unless each tensor of the tuple ``got`` has the dtype and
    shape of ``want``'s (a template, e.g. on the meta device) and lies
    contiguous on ``device``; fields that ``want`` leaves None are not
    checked."""
    for field, g, w in zip(got._fields, got, want):
        if w is not None:
            check(g, f"{name}.{field}", w.dtype, w.shape, device)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current CUDA stream of ``device``, for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


@functools.lru_cache(maxsize=None)
def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (row gather, K1 expansion, K2 lattice
    dedup and records, K3 frame tail and its shard mode (each with its first-frame
    mode), K4 sweep, K5 eps
    lanes and the eps step's shard mode, K6 dedup, the eps step as the
    last step of K6's and K2's eps calls, K7 shard route, K8 sharded
    GetCutoff), built on first use."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    path = build_library(
        "kdtorch_kernels",
        sources,
        [_nvcc()] + arch + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"],
        [_nvcc()] + arch + ["-shared"],
    )
    lib = ctypes.CDLL(path)
    lib.kd_row_gather.restype = _I
    lib.kd_row_gather.argtypes = [_P, _P, _L, _I, _I, _P, _P]
    lib.kd_empty.restype = _I
    lib.kd_empty.argtypes = [_P]
    lib.kd_expand.restype = _I
    lib.kd_expand.argtypes = [_P] * 7 + [_I] * 7 + [_P] * 7 + [_P]
    lib.kd_expand_cluster.restype = _I
    lib.kd_expand_cluster.argtypes = [_I] * 5
    lib.kd_sweep.restype = _I
    lib.kd_sweep.argtypes = ([_P] * 5 + [_I] * 7 + [_F, _F] + [_P] * 7 + [_P] + [_I] * 3
                             + [_P, _P] + [_P])
    lib.kd_sweep_cluster.restype = _I
    lib.kd_sweep_cluster.argtypes = [_I] * 3
    lib.kd_dedup.restype = _I
    lib.kd_dedup.argtypes = [_P, _P] + [_I] * 4 + [_P] * 11 + [_P]
    lib.kd_dedup_cluster.restype = _I
    lib.kd_dedup_cluster.argtypes = [_I] * 4
    lib.kd_dedup_marks.restype = _I
    lib.kd_dedup_marks.argtypes = [_P, _P, _P, _I]
    lib.kd_dedup_rec.restype = _I
    lib.kd_dedup_rec.argtypes = [_P] * 4 + [_I] * 5 + [_F, _I] + [_P] * 17 + [_P]
    lib.kd_dedup_rec_cluster.restype = _I
    lib.kd_dedup_rec_cluster.argtypes = [_I] * 5
    lib.kd_dedup_rec_marks.restype = _I
    lib.kd_dedup_rec_marks.argtypes = [_P, _P, _P, _I]
    lib.kd_frame_start.restype = _I
    lib.kd_frame_start.argtypes = ([_P] + [_I] * 3 + [_L, _F, _I, _I, _F] + [_P] * 7 + [_P] * 5
                                   + [_P] * 9 + [_P])
    lib.kd_frame_tail.restype = _I
    lib.kd_frame_tail.argtypes = ([_P] + [_I] * 8 + [_F, _I, _I, _F] + [_P] * 7 + [_P] * 13
                                  + [_I, _P])
    lib.kd_frame_tail_cluster.restype = _I
    lib.kd_frame_tail_cluster.argtypes = [_I, _I]
    lib.kd_expand_eps.restype = _I
    lib.kd_expand_eps.argtypes = [_P] * 5 + [_I] * 6 + [_P] * 6 + [_P]
    lib.kd_expand_eps_blocks.restype = _I
    lib.kd_expand_eps_blocks.argtypes = [_I, _I]
    lib.kd_eps_step_shard.restype = _I
    lib.kd_eps_step_shard.argtypes = [_I] * 9 + [_P] * 22 + [_I, _P]
    lib.kd_eps_step_shard_cluster.restype = _I
    lib.kd_eps_step_shard_cluster.argtypes = [_I, _I]
    lib.kd_frame_start_shard.restype = _I
    lib.kd_frame_start_shard.argtypes = [_P] + [_I] * 3 + [_L] + [_P] * 10 + [_P] * 8 + [_P]
    lib.kd_frame_tail_shard.restype = _I
    lib.kd_frame_tail_shard.argtypes = [_P] + [_I] * 9 + [_P] * 17 + [_P] * 5 + [_I, _I, _P]
    lib.kd_frame_tail_shard_cluster.restype = _I
    lib.kd_frame_tail_shard_cluster.argtypes = [_I, _I]
    lib.kd_route_send.restype = _I
    lib.kd_route_send.argtypes = [_P] * 6 + [_I] * 9 + [_F] + [_P] * 6 + [_I, _P]
    lib.kd_route_send_cluster.restype = _I
    lib.kd_route_send_cluster.argtypes = [_I]
    lib.kd_cutoff_local.restype = _I
    lib.kd_cutoff_local.argtypes = [_P] + [_I] * 3 + [_P] * 3 + [_P]
    lib.kd_cutoff_merge.restype = _I
    lib.kd_cutoff_merge.argtypes = [_P] * 3 + [_I] * 5 + [_F, _F] + [_P] * 2 + [_P]
    lib.kd_route_recv.restype = _I
    lib.kd_route_recv.argtypes = [_P] + [_I] * 4 + [_P] * 4 + [_P]
    lib.kd_error_string.restype = ctypes.c_char_p
    lib.kd_error_string.argtypes = [_I]
    return lib


def cuda_error(code: int) -> str:
    """``CUDA error <code> (<its text>)``, for a wrapper's exception."""
    return f"CUDA error {code} ({kernels().kd_error_string(code).decode()})"
