"""Vectorized synthetic decoding-graph generator for benchmarks.

A jax-free copy of ``kaldi_decoder_tpu/fst/synthetic.py`` (lines 14-112,
``synthetic_graph``), kept because importing the original imports jax;
``tests/test_torch_fst_io.py`` holds the copy equal to the original.

Builds an HLG-shaped :class:`CsrGraph` directly from numpy arrays
(bypassing the per-arc ``VectorFst`` API, which is too slow for
million-arc graphs): a heavy-tailed emitting out-degree, a small fraction
of epsilon arcs with a bounded closure depth, sparse final states, weights
on the scale of -log probabilities.
"""

from __future__ import annotations

import numpy as np

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays

INF = np.float32(np.inf)


def synthetic_graph(
    num_states: int,
    num_emitting_arcs: int,
    num_symbols: int,
    seed: int = 0,
    eps_arcs: int = 0,
    final_fraction: float = 0.02,
    max_weight: float = 8.0,
) -> CsrGraph:
    """Random CSR graph with HLG-like statistics.

    Epsilon arcs go from "layer 0" states (s % 4 == 0) to layer-1
    (s % 4 == 1) or from layer-1 to layer-2 (s % 4 == 2), giving an exact
    epsilon-closure depth of 2 — typical of real HLG graphs.
    """
    rng = np.random.default_rng(seed)
    S, E, V = num_states, num_emitting_arcs, num_symbols

    # Emitting arcs: heavy-tailed out-degree via random src with a few hubs.
    src = rng.integers(0, S, E, dtype=np.int64)
    hub = rng.integers(0, max(S // 1000, 1), E // 20, dtype=np.int64)
    src[: len(hub)] = hub
    src.sort(kind="stable")
    em_ilabel = rng.integers(1, V + 1, E).astype(np.int32)
    em_next = rng.integers(0, S, E).astype(np.int32)
    em_weight = rng.uniform(0.0, max_weight, E).astype(np.float32)
    em_olabel = np.where(
        rng.random(E) < 0.3, rng.integers(1, 30_000, E), 0
    ).astype(np.int32)
    em_row_ptr = np.zeros(S + 1, dtype=np.int32)
    em_row_ptr[1:] = np.cumsum(np.bincount(src, minlength=S))

    # Epsilon arcs: depth-2 layered DAG.
    if eps_arcs > 0:
        Ee = eps_arcs
        lvl = rng.integers(0, 2, Ee)
        esrc = (rng.integers(0, S // 4, Ee, dtype=np.int64) * 4 + lvl)
        esrc = np.minimum(esrc, S - 1)
        esrc.sort(kind="stable")
        lvl_of_src = esrc % 4
        edst = np.minimum(
            (rng.integers(0, S // 4, Ee, dtype=np.int64) * 4 + lvl_of_src + 1),
            S - 1,
        ).astype(np.int32)
        eps_weight = rng.uniform(0.0, max_weight / 2, Ee).astype(np.float32)
        eps_olabel = np.where(
            rng.random(Ee) < 0.5, rng.integers(1, 30_000, Ee), 0
        ).astype(np.int32)
        eps_row_ptr = np.zeros(S + 1, dtype=np.int32)
        eps_row_ptr[1:] = np.cumsum(np.bincount(esrc, minlength=S))
        eps_depth = 2
    else:
        edst = np.zeros(0, np.int32)
        eps_weight = np.zeros(0, np.float32)
        eps_olabel = np.zeros(0, np.int32)
        eps_row_ptr = np.zeros(S + 1, dtype=np.int32)
        eps_depth = 0

    final_cost = np.full(S, INF, np.float32)
    nf = max(1, int(S * final_fraction))
    fin = rng.choice(S, nf, replace=False)
    final_cost[fin] = rng.uniform(0.0, 2.0, nf).astype(np.float32)

    ga = GraphArrays(
        em_row_ptr=em_row_ptr,
        em_ilabel=em_ilabel,
        em_olabel=em_olabel,
        em_weight=em_weight,
        em_next=em_next,
        em_score_idx=(em_ilabel - 1).astype(np.int32),
        eps_row_ptr=eps_row_ptr,
        eps_olabel=eps_olabel,
        eps_weight=eps_weight,
        eps_next=edst,
        final_cost=final_cost,
    )
    em_deg = np.diff(em_row_ptr)
    eps_deg = np.diff(eps_row_ptr)
    return CsrGraph(
        arrays=ga,
        num_states=S,
        num_emitting_arcs=E,
        num_eps_arcs=int(len(edst)),
        start_state=0,
        eps_depth=eps_depth,
        max_em_out_degree=int(em_deg.max()) if S else 0,
        max_eps_out_degree=int(eps_deg.max()) if S else 0,
        max_score_idx=V - 1,
    )
