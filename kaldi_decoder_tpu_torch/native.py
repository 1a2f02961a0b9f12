"""The C++ ShortestPath and backpointer walk of the host library.

The JAX package's host library is compiled here with ``g++`` into
``kaldi_decoder_tpu_torch/_build/`` at first use, from the port's own
copy of its source, ``csrc/host/kdtpu_host.cc`` (a copy of
``kaldi_decoder_tpu/native/csrc/kdtpu_host.cc``, line for line under a
header but for one comment, held equal to it by
``tests/test_torch_host.py``); nothing of the JAX package is read or
imported.  Two entry points are
bound: ``kd_shortest_path``, so the lattice decoder's 1-best is the same
ShortestPath (with the LatticeWeight natural-order tie-break) as the JAX
decoder's, and ``kd_backtrace``, the Viterbi decoder's walk of its
backpointers (`faster-decoder.cc:393-406`).  A failed build raises; there
is no Python fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional

import numpy as np

from kaldi_decoder_tpu_torch.kernels._build import PKG_DIR, build_library

# Copies kaldi_decoder_tpu/native/csrc/kdtpu_host.cc (see its header).
HOST_SOURCE = os.path.join(PKG_DIR, "csrc", "host", "kdtpu_host.cc")

_i64 = ctypes.c_int64
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    path = build_library(
        "kdtpu_host", [HOST_SOURCE], ["g++", "-O3", "-std=c++17", "-fPIC"], ["g++", "-shared"]
    )
    lib = ctypes.CDLL(path)
    lib.kd_shortest_path.restype = _i64
    lib.kd_shortest_path.argtypes = [
        _i64, _i64, _i32p, _f32p, _f32p, _i32p, _f32p, _f32p, _i64, _i32p, _i64,
    ]
    lib.kd_backtrace.restype = _i64
    lib.kd_backtrace.argtypes = [_i64, _i64, _i64, _i64, _i64, _i32p, _i32p, _i32p, _i32p, _i64]
    return lib


def backtrace(
    slot0: int,
    bp_init: np.ndarray,  # (D_init, K, 2) int32
    bp_emit: np.ndarray,  # (T, K, 2) int32
    bp_eps: np.ndarray,  # (T, D, K, 2) int32
) -> Optional[np.ndarray]:
    """Walk backpointers from frontier slot ``slot0`` of the last frame;
    returns (n, 3) int32 ``(is_eps, arc_id, frame)`` in forward order, or
    None on a dead slot (search failure).  The signature and capacity rule
    of ``kaldi_decoder_tpu.native.backtrace``."""
    lib = host_library()
    T, K = bp_emit.shape[0], bp_emit.shape[1]
    D = bp_eps.shape[1] if bp_eps.ndim == 4 else 0
    D_init = bp_init.shape[0] if bp_init.size else 0
    cap = 3 * (T + D_init + T * D + 1)
    out = np.empty((cap, 3), np.int32)

    def flat(a):
        return np.ascontiguousarray(a, np.int32).reshape(-1) if a.size else np.zeros(1, np.int32)

    n = lib.kd_backtrace(
        T, K, D, D_init, slot0, flat(bp_init), flat(bp_emit), flat(bp_eps),
        out.reshape(-1), cap,
    )
    if n == -1:
        return None
    if n < 0:
        raise RuntimeError("kd_backtrace capacity error")
    return out[:n]


def shortest_path_arrays(
    num_states: int,
    src: np.ndarray,
    w_total: np.ndarray,
    dst: np.ndarray,
    final_total: np.ndarray,
    start: int,
    w_graph: Optional[np.ndarray] = None,
    final_graph: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """Best-path arc indices (forward order) over flat lattice arrays, or
    None if no successful path; raises on cyclic input (the signature of
    ``kaldi_decoder_tpu.native.shortest_path_arrays``)."""
    lib = host_library()
    A = int(len(src))
    cap = max(A, 1)
    out = np.empty(cap, np.int32)
    if w_graph is None:
        w_graph = np.zeros(A, np.float32)
    if final_graph is None:
        final_graph = np.zeros(num_states, np.float32)
    n = lib.kd_shortest_path(
        num_states, A,
        np.ascontiguousarray(src, np.int32),
        np.ascontiguousarray(w_total, np.float32),
        np.ascontiguousarray(w_graph, np.float32),
        np.ascontiguousarray(dst, np.int32),
        np.ascontiguousarray(final_total, np.float32),
        np.ascontiguousarray(final_graph, np.float32),
        start, out, cap,
    )
    if n == -1:
        return None
    if n == -2:
        raise ValueError("shortest_path requires an acyclic FST")
    if n < 0:
        raise RuntimeError("kd_shortest_path capacity error")
    return out[:n]
