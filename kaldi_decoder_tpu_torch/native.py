"""The port's bindings of the C++ host library.

The JAX package's host library is compiled here with ``g++`` into
``kaldi_decoder_tpu_torch/_build/`` at first use, from the port's own
copy of its source, ``csrc/host/kdtpu_host.cc`` (a copy of
``kaldi_decoder_tpu/native/csrc/kdtpu_host.cc``, line for line under a
header but for one comment, held equal to it by
``tests/test_torch_host.py``); nothing of the JAX package is read or
imported.  The entry points are those of
``kaldi_decoder_tpu/native/__init__.py`` (declarations :64-111): the
OpenFst binary and text parsers (``read_fst_arrays``,
``parse_fst_text_arrays``) and the CSR compile (``load_csr``), the
ShortestPath with the LatticeWeight natural-order tie-break
(``shortest_path_arrays``), the Viterbi decoder's backpointer walk
(``backtrace``, `faster-decoder.cc:393-406`), the single-thread C++
decoders (``decode_faster``, ``decode_lattice``) and GetCutoff
(``get_cutoff``).  A failed build raises; there is no Python fallback.
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
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _declare(lib: ctypes.CDLL) -> None:
    """Argument and result types of every entry point (the declarations of
    ``kaldi_decoder_tpu/native/__init__.py:64-111``)."""
    c_char_p, c_int, c_void_p, c_float = (ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                                          ctypes.c_float)
    lib.kd_fst_open.restype = c_void_p
    lib.kd_fst_open.argtypes = [c_char_p, c_char_p, c_int]
    lib.kd_fst_open_text.restype = c_void_p
    lib.kd_fst_open_text.argtypes = [c_char_p, _i64, c_int, c_char_p, c_int]
    lib.kd_fst_free.restype = None
    lib.kd_fst_free.argtypes = [c_void_p]
    lib.kd_fst_info.restype = None
    lib.kd_fst_info.argtypes = [c_void_p, _i64p]
    lib.kd_fst_fill.restype = None
    lib.kd_fst_fill.argtypes = [c_void_p, _i64p, _i32p, _i32p, _f32p, _i32p, _f32p]
    lib.kd_csr_sizes.restype = c_int
    lib.kd_csr_sizes.argtypes = [c_void_p, _i64p]
    lib.kd_csr_fill.restype = c_int
    lib.kd_csr_fill.argtypes = [
        c_void_p, _i32p, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p, _i32p, _f32p, _i32p, _f32p,
        _i64p,
    ]
    lib.kd_backtrace.restype = _i64
    lib.kd_backtrace.argtypes = [_i64, _i64, _i64, _i64, _i64, _i32p, _i32p, _i32p, _i32p, _i64]
    lib.kd_shortest_path.restype = _i64
    lib.kd_shortest_path.argtypes = [
        _i64, _i64, _i32p, _f32p, _f32p, _i32p, _f32p, _f32p, _i64, _i32p, _i64,
    ]
    graph_args = [_i64, _i32p, _i32p, _f32p, _i32p, _i32p, _i32p, _f32p, _f32p, _i64, _i64, _i64,
                  _f32p, c_float, _i64, _i64, c_float]
    lib.kd_decode_faster.restype = ctypes.c_double
    lib.kd_decode_faster.argtypes = graph_args + [_i64p]
    lib.kd_decode_lattice.restype = ctypes.c_double
    lib.kd_decode_lattice.argtypes = graph_args + [c_float, _i64, _i64p]
    lib.kd_get_cutoff.restype = None
    lib.kd_get_cutoff.argtypes = [_f32p, _i64, c_float, _i64, _i64, c_float, _f64p]


@functools.lru_cache(maxsize=None)
def host_library() -> ctypes.CDLL:
    path = build_library(
        "kdtpu_host", [HOST_SOURCE], ["g++", "-O3", "-std=c++17", "-fPIC"], ["g++", "-shared"]
    )
    lib = ctypes.CDLL(path)
    _declare(lib)
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


# ---------------------------------------------------------------------------
# Graph files (kaldi_decoder_tpu/native/__init__.py:130-309)
# ---------------------------------------------------------------------------


class _Handle:
    """Owns an FST handle of the host library."""

    def __init__(self, lib, ptr):
        self._lib = lib
        self.ptr = ptr

    def __del__(self):
        if getattr(self, "ptr", None):
            self._lib.kd_fst_free(self.ptr)
            self.ptr = None


def _open_path(path: str) -> _Handle:
    lib = host_library()
    err = ctypes.create_string_buffer(256)
    ptr = lib.kd_fst_open(os.fsencode(path), err, len(err))
    if not ptr:
        raise ValueError(err.value.decode() or f"cannot read FST {path}")
    return _Handle(lib, ptr)


def _open_text(text: str, weight_dim: int) -> _Handle:
    lib = host_library()
    err = ctypes.create_string_buffer(256)
    raw = text.encode()
    ptr = lib.kd_fst_open_text(raw, len(raw), weight_dim, err, len(err))
    if not ptr:
        raise ValueError(err.value.decode() or "cannot parse FST text")
    return _Handle(lib, ptr)


def _fst_arrays(h: _Handle) -> dict:
    lib = h._lib
    info = np.zeros(4, np.int64)
    lib.kd_fst_info(h.ptr, info)
    S, A, start, wd = (int(x) for x in info)
    row_ptr = np.empty(S + 1, np.int64)
    il = np.empty(A, np.int32)
    ol = np.empty(A, np.int32)
    w = np.empty(A * wd, np.float32)
    ns = np.empty(A, np.int32)
    fin = np.empty(S * wd, np.float32)
    lib.kd_fst_fill(h.ptr, row_ptr, il, ol, w, ns, fin)
    return {
        "row_ptr": row_ptr,
        "ilabel": il,
        "olabel": ol,
        "weight": w if wd == 1 else w.reshape(A, 2),
        "nextstate": ns,
        "final": fin if wd == 1 else fin.reshape(S, 2),
        "start": start,
        "weight_dim": wd,
    }


def read_fst_arrays(path: str) -> dict:
    """Parse an OpenFst binary VectorFst or ConstFst file into flat numpy
    arrays (``row_ptr``, ``ilabel``, ``olabel``, ``weight``, ``nextstate``,
    ``final``, ``start``, ``weight_dim``)."""
    return _fst_arrays(_open_path(path))


def parse_fst_text_arrays(text: str, weight_dim: int) -> dict:
    """Parse the OpenFst text format into the arrays of :func:`read_fst_arrays`."""
    return _fst_arrays(_open_text(text, weight_dim))


def _csr_from_handle(h: _Handle):
    """A :class:`~kaldi_decoder_tpu_torch.fst.csr.CsrGraph` compiled by the
    host library from an FST handle (tropical FSTs only)."""
    from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays

    lib = h._lib
    info = np.zeros(4, np.int64)
    lib.kd_fst_info(h.ptr, info)
    S, _A, start, wd = (int(x) for x in info)
    if wd != 1:
        raise ValueError("CSR compile requires a tropical (StdArc) FST")
    if start < 0:
        raise ValueError("FST has no start state")
    sizes = np.zeros(2, np.int64)
    lib.kd_csr_sizes(h.ptr, sizes)
    n_em, n_eps = int(sizes[0]), int(sizes[1])
    ga = GraphArrays(
        em_row_ptr=np.empty(S + 1, np.int32),
        em_ilabel=np.empty(n_em, np.int32),
        em_olabel=np.empty(n_em, np.int32),
        em_weight=np.empty(n_em, np.float32),
        em_next=np.empty(n_em, np.int32),
        em_score_idx=np.empty(n_em, np.int32),
        eps_row_ptr=np.empty(S + 1, np.int32),
        eps_olabel=np.empty(n_eps, np.int32),
        eps_weight=np.empty(n_eps, np.float32),
        eps_next=np.empty(n_eps, np.int32),
        final_cost=np.empty(S, np.float32),
    )
    meta = np.zeros(4, np.int64)
    if lib.kd_csr_fill(h.ptr, *ga, meta) != 0:
        raise ValueError("native CSR compile failed")
    return CsrGraph(
        arrays=ga,
        num_states=S,
        num_emitting_arcs=n_em,
        num_eps_arcs=n_eps,
        start_state=start,
        eps_depth=None if meta[0] < 0 else int(meta[0]),
        max_em_out_degree=int(meta[1]),
        max_eps_out_degree=int(meta[2]),
        max_score_idx=int(meta[3]),
    )


def load_csr(path: str):
    """OpenFst binary file -> CsrGraph, parsed and compiled in C++ without
    a Python FST (the graph-load path for million-arc HLGs)."""
    return _csr_from_handle(_open_path(path))


# ---------------------------------------------------------------------------
# The C++ decoders and GetCutoff (kaldi_decoder_tpu/native/__init__.py:312-408)
# ---------------------------------------------------------------------------


def _graph_args(graph, scores):
    ga = graph.arrays
    scores = np.ascontiguousarray(scores, np.float32)
    T, V = scores.shape
    return [
        graph.num_states,
        np.ascontiguousarray(ga.em_row_ptr, np.int32),
        np.ascontiguousarray(ga.em_next, np.int32),
        np.ascontiguousarray(ga.em_weight, np.float32),
        np.ascontiguousarray(ga.em_score_idx, np.int32),
        np.ascontiguousarray(ga.eps_row_ptr, np.int32),
        np.ascontiguousarray(ga.eps_next, np.int32),
        np.ascontiguousarray(ga.eps_weight, np.float32),
        np.ascontiguousarray(ga.final_cost, np.float32),
        graph.start_state, T, V, scores.reshape(-1),
    ]


def decode_faster(
    graph,
    scores: np.ndarray,  # (T, V) float32 log-probs
    beam: float = 16.0,
    max_active: int = 2**63 - 1,
    min_active: int = 20,
    beam_delta: float = 0.5,
):
    """Single-threaded C++ decode with the reference FasterDecoder's
    algorithmics over a CsrGraph (``kd_decode_faster``).  Returns
    (best_final_cost, frames_decoded, tokens_created)."""
    stats = np.zeros(2, np.int64)
    best = host_library().kd_decode_faster(
        *_graph_args(graph, scores), float(beam), int(max_active), int(min_active),
        float(beam_delta), stats,
    )
    return float(best), int(stats[0]), int(stats[1])


def decode_lattice(
    graph,
    scores: np.ndarray,  # (T, V) float32 log-probs
    beam: float = 16.0,
    max_active: int = 2**63 - 1,
    min_active: int = 20,
    beam_delta: float = 0.5,
    lattice_beam: float = 10.0,
    prune_interval: int = 25,
):
    """Single-threaded C++ lattice decode: LatticeSimpleDecoder's tokens
    and forward links with windowed backward pruning, under
    FasterDecoder's max-active cutoffs (``kd_decode_lattice``).  Returns
    (best_final_cost, {frames, tokens, links, tokens_live, links_live})."""
    stats = np.zeros(5, np.int64)
    best = host_library().kd_decode_lattice(
        *_graph_args(graph, scores), float(beam), int(max_active), int(min_active),
        float(beam_delta), float(lattice_beam), int(prune_interval), stats,
    )
    keys = ("frames", "tokens", "links", "tokens_live", "links_live")
    return float(best), dict(zip(keys, (int(x) for x in stats)))


def get_cutoff(
    costs: np.ndarray,
    beam: float,
    max_active: int,
    min_active: int,
    beam_delta: float,
):
    """C++ GetCutoff (`faster-decoder.cc:244-336`) over a vector of finite
    token costs; returns (cutoff, adaptive_beam)."""
    costs = np.ascontiguousarray(costs, np.float32)
    out = np.zeros(2, np.float64)
    host_library().kd_get_cutoff(
        costs, len(costs), float(beam), int(max_active), int(min_active), float(beam_delta), out,
    )
    return float(out[0]), float(out[1])
