"""Flattened CSR decoding-graph representation (host side, numpy).

A jax-free copy of ``kaldi_decoder_tpu/fst/csr.py`` (``GraphArrays``,
``CsrGraph``, ``compile_fst``, ``load_graph`` (:135), ``save_graph_npz``
(:152), ``load_graph_npz``, ``_ArcView`` and ``CsrFstView`` (:189-239) and
``_eps_depth``), kept because importing the original imports jax.
``tests/test_torch_host.py``, ``tests/test_torch_viterbi.py`` and
``tests/test_torch_fst_io.py`` hold the copy equal to the original.
:func:`load_graph` always compiles in the port's host library and raises
if it cannot be built; the original falls back to
``compile_fst(read_fst(path))`` when its library is unavailable.

Arcs are partitioned into emitting (ilabel > 0) and epsilon sub-CSRs;
``score_idx = ilabel - 1`` is stored per emitting arc, so the acoustic
lookup is a single gather ``scores[t, score_idx]``; final weights are a
dense ``final_cost[S]`` array (+inf == not final).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from kaldi_decoder_tpu_torch.fst.fst import EPSILON, StdVectorFst


class GraphArrays(NamedTuple):
    """Graph arrays (numpy)."""

    em_row_ptr: object  # (S+1,) int32
    em_ilabel: object  # (E_em,) int32
    em_olabel: object  # (E_em,) int32
    em_weight: object  # (E_em,) float32
    em_next: object  # (E_em,) int32
    em_score_idx: object  # (E_em,) int32  == ilabel - 1
    eps_row_ptr: object  # (S+1,) int32
    eps_olabel: object  # (E_eps,) int32
    eps_weight: object  # (E_eps,) float32
    eps_next: object  # (E_eps,) int32
    final_cost: object  # (S,) float32 (INF == not final)


@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Host-compiled decoding graph: sizes and metadata as plain ints,
    array payload in ``arrays`` (numpy)."""

    arrays: GraphArrays
    num_states: int
    num_emitting_arcs: int
    num_eps_arcs: int
    start_state: int
    # Longest epsilon chain if the eps subgraph is acyclic, else None.
    eps_depth: Optional[int]
    max_em_out_degree: int
    max_eps_out_degree: int
    # Max score index referenced (== max ilabel - 1).
    max_score_idx: int

    @property
    def has_eps(self) -> bool:
        return self.num_eps_arcs > 0


def compile_fst(fst: StdVectorFst) -> CsrGraph:
    """Flatten a ``StdVectorFst`` into a :class:`CsrGraph`."""
    if fst.start < 0:
        raise ValueError("FST has no start state")
    arrays = fst.to_arrays()
    S = fst.num_states
    row_ptr = arrays["row_ptr"]
    il = arrays["ilabel"]
    ol = arrays["olabel"]
    w = arrays["weight"].astype(np.float32)
    ns = arrays["nextstate"]

    is_em = il != EPSILON
    # Per-state counts for each partition.
    state_of_arc = np.repeat(np.arange(S, dtype=np.int64), np.diff(row_ptr))
    em_counts = np.bincount(state_of_arc[is_em], minlength=S)
    eps_counts = np.bincount(state_of_arc[~is_em], minlength=S)

    em_row_ptr = np.zeros(S + 1, dtype=np.int32)
    em_row_ptr[1:] = np.cumsum(em_counts)
    eps_row_ptr = np.zeros(S + 1, dtype=np.int32)
    eps_row_ptr[1:] = np.cumsum(eps_counts)

    # Stable partition keeps within-state arc order (same order the
    # reference's ArcIterator sees them in).
    em_sel = np.flatnonzero(is_em)
    eps_sel = np.flatnonzero(~is_em)

    em_ilabel = il[em_sel].astype(np.int32)
    ga = GraphArrays(
        em_row_ptr=em_row_ptr,
        em_ilabel=em_ilabel,
        em_olabel=ol[em_sel].astype(np.int32),
        em_weight=w[em_sel],
        em_next=ns[em_sel].astype(np.int32),
        em_score_idx=(em_ilabel - 1).astype(np.int32),
        eps_row_ptr=eps_row_ptr,
        eps_olabel=ol[eps_sel].astype(np.int32),
        eps_weight=w[eps_sel],
        eps_next=ns[eps_sel].astype(np.int32),
        final_cost=arrays["final"].astype(np.float32),
    )

    eps_depth = _eps_depth(S, eps_row_ptr, ga.eps_next)
    em_deg = np.diff(em_row_ptr)
    eps_deg = np.diff(eps_row_ptr)
    return CsrGraph(
        arrays=ga,
        num_states=S,
        num_emitting_arcs=int(len(em_sel)),
        num_eps_arcs=int(len(eps_sel)),
        start_state=int(fst.start),
        eps_depth=eps_depth,
        max_em_out_degree=int(em_deg.max()) if S else 0,
        max_eps_out_degree=int(eps_deg.max()) if S else 0,
        max_score_idx=int(em_ilabel.max() - 1) if len(em_sel) else -1,
    )


def load_graph(path) -> CsrGraph:
    """OpenFst binary file -> CsrGraph, the production graph-load path: the
    host library parses the file and compiles the emitting/epsilon CSR in
    C++ without a Python FST."""
    from kaldi_decoder_tpu_torch import native

    return native.load_csr(str(path))


def save_graph_npz(graph: CsrGraph, path) -> None:
    """Serialize a compiled graph to ``.npz`` (fast reload for large
    graphs: skips FST parsing, partitioning and eps-depth analysis)."""
    meta = np.array(
        [
            graph.num_states,
            graph.num_emitting_arcs,
            graph.num_eps_arcs,
            graph.start_state,
            -1 if graph.eps_depth is None else graph.eps_depth,
            graph.max_em_out_degree,
            graph.max_eps_out_degree,
            graph.max_score_idx,
        ],
        dtype=np.int64,
    )
    np.savez_compressed(path, meta=meta, **graph.arrays._asdict())


def load_graph_npz(path) -> CsrGraph:
    """Inverse of :func:`save_graph_npz` (reads the JAX package's files too)."""
    with np.load(path) as z:
        meta = z["meta"]
        ga = GraphArrays(**{k: z[k] for k in GraphArrays._fields})
    return CsrGraph(
        arrays=ga,
        num_states=int(meta[0]),
        num_emitting_arcs=int(meta[1]),
        num_eps_arcs=int(meta[2]),
        start_state=int(meta[3]),
        eps_depth=None if meta[4] < 0 else int(meta[4]),
        max_em_out_degree=int(meta[5]),
        max_eps_out_degree=int(meta[6]),
        max_score_idx=int(meta[7]),
    )


def graph_from_numpy(graph) -> CsrGraph:
    """The port's :class:`CsrGraph` from any object with the same fields
    (the JAX package's ``CsrGraph``), each array carried as numpy."""
    ga = GraphArrays(
        **{k: np.asarray(getattr(graph.arrays, k)) for k in GraphArrays._fields}
    )
    return CsrGraph(
        arrays=ga,
        num_states=int(graph.num_states),
        num_emitting_arcs=int(graph.num_emitting_arcs),
        num_eps_arcs=int(graph.num_eps_arcs),
        start_state=int(graph.start_state),
        eps_depth=graph.eps_depth,
        max_em_out_degree=int(graph.max_em_out_degree),
        max_eps_out_degree=int(graph.max_eps_out_degree),
        max_score_idx=int(graph.max_score_idx),
    )


class _ArcView(NamedTuple):
    ilabel: int
    olabel: int
    weight: float
    nextstate: int


class CsrFstView:
    """Read-only FST interface over a compiled :class:`CsrGraph`.

    Lets FST-consuming host code (the oracle decoders, graph inspectors)
    run directly on a compiled graph without materializing a
    ``StdVectorFst``.  Arc order: emitting arcs first, then epsilon arcs
    (the partition order of ``compile_fst``).
    """

    def __init__(self, graph: CsrGraph):
        self._g = graph
        self._ga = graph.arrays

    @property
    def start(self) -> int:
        return self._g.start_state

    @property
    def num_states(self) -> int:
        return self._g.num_states

    def final(self, state: int) -> float:
        return float(self._ga.final_cost[state])

    def num_input_epsilons(self, state: int) -> int:
        ga = self._ga
        return int(ga.eps_row_ptr[state + 1] - ga.eps_row_ptr[state])

    def arcs(self, state: int):
        ga = self._ga
        for a in range(int(ga.em_row_ptr[state]), int(ga.em_row_ptr[state + 1])):
            yield _ArcView(
                int(ga.em_ilabel[a]), int(ga.em_olabel[a]),
                float(ga.em_weight[a]), int(ga.em_next[a]),
            )
        for a in range(
            int(ga.eps_row_ptr[state]), int(ga.eps_row_ptr[state + 1])
        ):
            yield _ArcView(
                0, int(ga.eps_olabel[a]),
                float(ga.eps_weight[a]), int(ga.eps_next[a]),
            )


def _eps_depth(S: int, eps_row_ptr: np.ndarray, eps_next: np.ndarray) -> Optional[int]:
    """Longest chain length in the epsilon subgraph; None if cyclic
    (Kahn's algorithm)."""
    if len(eps_next) == 0:
        return 0
    indeg = np.zeros(S, dtype=np.int64)
    np.add.at(indeg, eps_next, 1)
    depth = np.zeros(S, dtype=np.int64)
    queue = list(np.flatnonzero(indeg == 0))
    processed = 0
    while queue:
        s = queue.pop()
        processed += 1
        lo, hi = int(eps_row_ptr[s]), int(eps_row_ptr[s + 1])
        for a in range(lo, hi):
            t = int(eps_next[a])
            if depth[t] < depth[s] + 1:
                depth[t] = depth[s] + 1
            indeg[t] -= 1
            if indeg[t] == 0:
                queue.append(t)
    if processed != S:
        return None  # epsilon cycle
    return int(depth.max())
