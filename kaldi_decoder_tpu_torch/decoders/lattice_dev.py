"""Lattice frame step and chunk loop on the device, batched over B.

The torch counterpart of ``kaldi_decoder_tpu/decoders/lattice_dev.py``
(``LatticeDevConfig``, ``lattice_config_for_graph``, ``lattice_emit_stage``,
``lattice_frame_step_batched`` and the chunk scan) for device graphs with
no eps arcs.  Each frame runs GetCutoff, the expansion region K1
(:func:`kaldi_decoder_tpu_torch.kernels.expand.expand_filter`), the dedup /
top-K / records region K2
(:func:`kaldi_decoder_tpu_torch.kernels.dedup_rec.dedup_select_rec`) and
the cost rebase; record rows are
``[src_state, arc_id, dst_state, slack_bits]``.  On the card K1 and K2
are the hand-written kernels; their plain torch versions
(``kernels.expand.expand_filter_plain``, ``ops.segment.dedup_select_rec``)
run for CPU tensors and are the kernels' oracles.  The JAX ``lax.scan`` over
a chunk's frames is a Python loop here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, StepState
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.pack import PackedGraph
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class LatticeDevConfig:
    """Lattice-decode parameters: frontier config + record buffers."""

    frontier: FrontierConfig
    # Per-frame emitting-record buffer size.
    em_records: int = 4096
    # Lattice beam, also the device-side link slack filter.
    lattice_beam: float = 10.0


def lattice_config_for_graph(
    graph: CsrGraph, frontier: FrontierConfig, em_records=None,
    lattice_beam: float = 10.0,
) -> LatticeDevConfig:
    em_r = em_records or min(
        frontier.num_candidates, max(4096, frontier.frontier_size + 2048)
    )
    em_r = min(em_r, frontier.num_candidates)
    return LatticeDevConfig(
        frontier=frontier, em_records=em_r, lattice_beam=float(lattice_beam)
    )


class LatticeStepOut(NamedTuple):
    """Per-frame outputs; stacked over a chunk they gain a leading T."""

    em_records: torch.Tensor  # (B, R_em, 4): links of frame t -> t+1
    frontier_states: torch.Tensor  # (B, K) tokens of frame t+1
    frontier_costs: torch.Tensor  # (B, K) absolute costs (alpha values)
    num_active: torch.Tensor  # (B,) int32
    best_cost: torch.Tensor  # (B,) float32
    cutoff: torch.Tensor  # (B,) float32
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool — more in-beam states than K


def lattice_emit_stage(
    st: StepState,
    scores_t: torch.Tensor,  # (B, V)
    pg: PackedGraph,
    fc: FrontierConfig,
    num_states: int,
    r_em: int,
    slack_beam: float,
):
    """GetCutoff, expansion with the beam filter (K1), then dedup,
    frontier selection and records (K2)."""
    K = fc.frontier_size
    cut = get_cutoff(
        st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
        costs_sorted=True,
    )
    ex = expand_filter(
        st.states, st.costs, cut.cutoff, cut.adaptive_beam, scores_t, pg, fc
    )
    sel = dedup_select_rec(
        ex.dst, ex.cost, K, num_states, r_em, slack_beam,
        payload=(ex.src_state, ex.arc_id),
    )
    mid = StepState(sel.states, sel.costs, st.base)
    ovf = ex.overflow | sel.rec_overflow
    sat = sel.num_unique > K
    return mid, sel.records, st.base + cut.cutoff, ovf, sat


def lattice_frame_step_batched(
    st: StepState,  # (B, K)
    scores_t: torch.Tensor,  # (B, V)
    frame_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """One whole-batch lattice frame: emit stage, rebase by each row's
    best cost, and the freeze of rows whose utterance has ended."""
    fc = cfg.frontier
    sb = cfg.lattice_beam + 1e-4  # headroom: host prune re-checks in f64
    mid, em_rec, cutoff_abs, ovf, sat = lattice_emit_stage(
        st, scores_t, pg, fc, num_states, cfg.em_records, sb
    )
    m = mid.costs[:, 0]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    fa = frame_active
    final = StepState(
        states=torch.where(fa[:, None], mid.states, st.states),
        costs=torch.where(fa[:, None], mid.costs - m_safe[:, None], st.costs),
        base=torch.where(fa, mid.base + m_safe, st.base),
    )
    out = LatticeStepOut(
        em_records=torch.where(fa[:, None, None], em_rec, -1),
        frontier_states=final.states,
        frontier_costs=final.base[:, None] + final.costs,
        num_active=torch.isfinite(final.costs).sum(dim=1, dtype=torch.int32),
        best_cost=final.base,
        cutoff=cutoff_abs,
        overflow=fa & ovf,
        saturated=fa & sat,
    )
    return final, out


def lattice_chunk(
    pg: PackedGraph,
    scores_tm: torch.Tensor,  # (C, B, V) time-major
    lengths: torch.Tensor,  # (B,) int32 — frames still to decode from t=0
    st0: StepState,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """C frames from ``st0``; frames t >= lengths are no-ops for that row.
    Returns the final state and the per-frame outputs stacked (C, B, ...)."""
    C = scores_tm.shape[0]
    st = st0
    outs = None
    for t in range(C):
        st, o = lattice_frame_step_batched(
            st, scores_tm[t], lengths > t, pg, cfg, num_states
        )
        if outs is None:
            outs = LatticeStepOut(
                *(torch.empty((C,) + x.shape, dtype=x.dtype, device=x.device) for x in o)
            )
        for buf, x in zip(outs, o):
            buf[t].copy_(x)
    return st, outs
