"""Lattice frame step and chunk loop on the device, batched over B.

The torch counterpart of ``kaldi_decoder_tpu/decoders/lattice_dev.py``
(``LatticeDevConfig``, ``lattice_config_for_graph``, ``lattice_emit_stage``,
the record-emitting eps closures ``eps_iteration_rec``,
``eps_closure_rec`` and ``eps_closure_rec_batched``,
``lattice_frame_step_batched``, ``init_closure_rec`` and the chunk scan).
Each frame runs GetCutoff, the expansion region K1
(:func:`kaldi_decoder_tpu_torch.kernels.expand.expand_filter`), the dedup /
top-K / records region K2
(:func:`kaldi_decoder_tpu_torch.kernels.dedup_rec.dedup_select_rec`), then,
on a device graph with eps arcs, ``eps_iters`` eps iterations (K5, the plain
torch ``frontier.expand_eps``, then K2's eps call with the K incumbents
first), and the cost rebase; record rows are
``[src_state, arc_id, dst_state, slack_bits]``.  On the card K1 and K2
are the hand-written kernels; their plain torch versions
(``kernels.expand.expand_filter_plain``, ``ops.segment.dedup_select_rec``)
run for CPU tensors and are the kernels' oracles.  A frame ends with its
tail, K3 (``kernels.frame``: the rebase, the freeze, the outputs, the next
frame's GetCutoff).  The JAX ``lax.scan`` over a chunk's frames is the
frame driver here (:mod:`kaldi_decoder_tpu_torch.decoders.driver`): on a
card one captured CUDA graph of a frame, replayed once a frame.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepState,
    expand_eps,
    start_state,
)
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.pack import PackedGraph
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

INF = float("inf")

# Record-row columns: [src_state, arc_id, dst_state, slack_bits].
REC_COLS = 4


@dataclasses.dataclass(frozen=True)
class LatticeDevConfig:
    """Lattice-decode parameters: frontier config + record buffers."""

    frontier: FrontierConfig
    # Per-frame emitting-record buffer size.
    em_records: int = 4096
    # Per-eps-iteration record buffer size.
    eps_records: int = 1024
    # Lattice beam, also the device-side link slack filter.
    lattice_beam: float = 10.0


def lattice_config_for_graph(
    graph: CsrGraph, frontier: FrontierConfig, em_records=None, eps_records=None,
    lattice_beam: float = 10.0,
) -> LatticeDevConfig:
    """Record buffers sized as the original sizes them: every frontier
    winner plus a slack-selected pool of extras a frame, and a quarter of
    an eps iteration's candidates (8 to 2048) per iteration."""
    em_r = em_records or min(
        frontier.num_candidates, max(4096, frontier.frontier_size + 2048)
    )
    em_r = min(em_r, frontier.num_candidates)
    eps_cands = (
        frontier.frontier_size * (frontier.eps_block_width + 1) + frontier.eps_rem_budget
    )
    eps_r = eps_records or min(max(eps_cands // 4, 8), 2048)
    eps_r = min(eps_r, eps_cands)
    return LatticeDevConfig(
        frontier=frontier, em_records=em_r, eps_records=eps_r,
        lattice_beam=float(lattice_beam),
    )


class LatticeStepOut(NamedTuple):
    """Per-frame outputs; stacked over a chunk they gain a leading T."""

    em_records: torch.Tensor  # (B, R_em, 4): links of frame t -> t+1
    eps_records: torch.Tensor  # (B, D, R_eps, 4): eps links within frame t+1
    frontier_states: torch.Tensor  # (B, K) tokens of frame t+1
    frontier_costs: torch.Tensor  # (B, K) absolute costs (alpha values)
    num_active: torch.Tensor  # (B,) int32
    best_cost: torch.Tensor  # (B,) float32
    cutoff: torch.Tensor  # (B,) float32
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool — more in-beam states than K


def _lattice_emit(st: StepState, cutoff, adaptive_beam, scores_t, pg: PackedGraph,
                  fc: FrontierConfig, num_states: int, r_em: int, slack_beam: float,
                  bufs=None):
    """K1 under the frame's GetCutoff (``cutoff``, ``adaptive_beam``), then
    dedup, frontier selection and records (K2).  ``bufs``: on a card, K1's
    and K2's output buffers and K2's scratch, or None."""
    ex_out, sel_out, scratch = bufs or (None, None, None)
    ex = expand_filter(st.states, st.costs, cutoff, adaptive_beam, scores_t, pg, fc,
                       out=ex_out)
    sel = dedup_select_rec(
        ex.dst, ex.cost, fc.frontier_size, num_states, r_em, slack_beam,
        payload=(ex.src_state, ex.arc_id), out=sel_out, scratch=scratch,
    )
    return ex, sel


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
    cut = get_cutoff(
        st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
        costs_sorted=True,
    )
    ex, sel = _lattice_emit(st, cut.cutoff, cut.adaptive_beam, scores_t, pg, fc, num_states,
                            r_em, slack_beam)
    mid = StepState(sel.states, sel.costs, st.base)
    ovf = ex.overflow | sel.rec_overflow
    sat = sel.num_unique > fc.frontier_size
    return mid, sel.records, ex.next_cutoff, st.base + cut.cutoff, ovf, sat


def eps_rec_candidates(st: StepState, cutoff_rel: torch.Tensor, pg: PackedGraph,
                       cfg: FrontierConfig):
    """The lanes of K2's eps call: the K incumbents (payload -1), then the
    eps arcs (K5, ``expand_eps``) of the tokens at or under the cutoff,
    +inf above it.  Returns (state, cost, (src_state, arc_id)) of shape
    (B, K + N_eps) and the expansion's overflow (B,)."""
    cut = cutoff_rel[:, None]
    active = torch.isfinite(st.costs) & (st.costs <= cut)
    cand = expand_eps(st, active, pg, cfg)
    ncost = torch.where(cand.cost <= cut, cand.cost, INF)
    none = torch.full_like(st.states, NO_ARC)
    return (
        torch.cat([st.states, cand.dst], dim=1),
        torch.cat([st.costs, ncost], dim=1),
        (torch.cat([none, cand.src_state], dim=1), torch.cat([none, cand.arc_id], dim=1)),
        cand.overflow,
    )


def eps_iteration_rec(
    st: StepState,
    cutoff_rel: torch.Tensor,  # (B,)
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float,
):
    """One eps relaxation of every row that also emits link records: every
    in-beam eps candidate may become a record (the reference creates a
    ForwardLink per eps arc under the cutoff,
    `lattice-simple-decoder.cc:170-186`), while the frontier keeps only
    per-state minima.  K2's eps call: the K incumbents go first, with
    payload -1, and the record budget is K + ``r_eps``, so that fresh
    winner links never crowd out the slack extras; the first ``r_eps``
    rows are the iteration's records and a valid row just past them means
    links were dropped.  Returns (state, records (B, r_eps, 4), changed,
    overflow, saturated), the last three (B,) bool; a row changed when a
    slot was won by an eps lane."""
    K = cfg.frontier_size
    cand_state, cand_cost, payload, exp_ovf = eps_rec_candidates(st, cutoff_rel, pg, cfg)
    sel = dedup_select_rec(
        cand_state, cand_cost, K, num_states, K + r_eps, slack_beam, payload, num_incumbents=K
    )
    spill = sel.records[:, r_eps, 1] >= 0
    changed = ((sel.cand_idx >= K) & torch.isfinite(sel.costs)).any(dim=1)
    ovf = exp_ovf | sel.rec_overflow | spill
    sat = sel.num_unique > K
    return StepState(sel.states, sel.costs, st.base), sel.records[:, :r_eps], changed, ovf, sat


def eps_closure_rec(
    st: StepState,
    cutoff_rel: torch.Tensor,  # (B,)
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float,
):
    """The record-emitting eps closure that stops each row on its own (the
    start closure's): once an iteration leaves a row unchanged, the row's
    frontier stays and its later iterations' records are -1.  With
    ``eps_exact=False`` a row still changing at the last iteration is
    flagged as an overflow.  Returns (state, records (B, D, r_eps, 4),
    overflow, saturated)."""
    D = cfg.eps_iters
    B = st.states.shape[0]
    dev = st.states.device
    recs = torch.full((B, D, r_eps, REC_COLS), -1, dtype=torch.int32, device=dev)
    stop = torch.zeros((B,), dtype=torch.bool, device=dev)
    ovf, sat = stop, stop
    if D == 0:
        return st, recs, ovf, sat
    for d in range(D):
        nxt, rec, changed, o, s = eps_iteration_rec(
            st, cutoff_rel, pg, cfg, num_states, r_eps, slack_beam
        )
        keep = stop[:, None]
        st = StepState(torch.where(keep, st.states, nxt.states),
                       torch.where(keep, st.costs, nxt.costs), st.base)
        recs[:, d] = torch.where(keep[..., None], -1, rec)
        ovf = ovf | (~stop & o)
        sat = sat | (~stop & s)
        stop = stop | ~changed
    if not cfg.eps_exact:
        ovf = ovf | ~stop  # cyclic-eps budget: possibly unconverged
    return st, recs, ovf, sat


def eps_closure_rec_batched(
    st: StepState,  # (B, K)
    cutoff_rel: torch.Tensor,  # (B,)
    row_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    fc: FrontierConfig,
    num_states: int,
    r_eps: int,
    slack_beam: float,
):
    """The frame's record-emitting eps closure, ``eps_iters`` iterations,
    no host sync.  The original's ``while_loop`` stops the whole batch once
    no active row changed; as in ``frontier.eps_closure_batched`` every
    iteration runs here and gives the early exit's results: a row an
    iteration leaves unchanged is at a fixed point, so a later iteration
    gives it the same frontier, records and flags.  What the early exit
    leaves is kept: an iteration the original never ran writes records of
    -1 on every row (``ran``, on the device); one that ran keeps the
    records of rows that had already converged, as the original's loop
    writes them; with ``eps_exact=False`` every active row is flagged when
    some active row still changed at the last iteration.  Returns (state,
    records (B, D, r_eps, 4), overflow (B,), saturated (B,))."""
    D = fc.eps_iters
    B = st.states.shape[0]
    dev = st.states.device
    z = torch.zeros((B,), dtype=torch.bool, device=dev)
    recs = torch.empty((B, D, r_eps, REC_COLS), dtype=torch.int32, device=dev)
    if D == 0:
        return st, recs, z, z
    ovf, sat = z, z
    ran = torch.ones((), dtype=torch.bool, device=dev)
    go = ran
    for d in range(D):
        st, rec, changed, o, s = eps_iteration_rec(
            st, cutoff_rel, pg, fc, num_states, r_eps, slack_beam
        )
        recs[:, d] = torch.where(ran, rec, -1)
        ovf = ovf | (o & row_active)
        sat = sat | (s & row_active)
        go = (changed & row_active).any()
        ran = ran & go
    if not fc.eps_exact:
        ovf = ovf | (go & row_active)  # cyclic-eps budget: unconverged
    return st, recs, ovf, sat


def lattice_frame_body(
    st: StepState,  # (B, K)
    cutoff: torch.Tensor,  # (B,) the frame's GetCutoff, relative to st.base
    adaptive_beam: torch.Tensor,  # (B,)
    scores_t: torch.Tensor,  # (B, V)
    frame_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    cfg: LatticeDevConfig,
    num_states: int,
    bufs=None,
):
    """The lattice frame before its tail: K1 and K2, then, on a device
    graph with eps arcs, the record-emitting eps closure under K1's next
    cutoff.  ``bufs`` as :func:`_lattice_emit`'s.  Returns the
    :class:`kaldi_decoder_tpu_torch.kernels.frame.TailInputs` of the
    frame's tail (K3)."""
    # Imported here: kernels.frame imports this module.
    from kaldi_decoder_tpu_torch.kernels.frame import TailInputs

    fc = cfg.frontier
    sb = cfg.lattice_beam + 1e-4  # headroom: host prune re-checks in f64
    ex, sel = _lattice_emit(st, cutoff, adaptive_beam, scores_t, pg, fc, num_states,
                            cfg.em_records, sb, bufs)
    mid = StepState(sel.states, sel.costs, st.base)
    eps_rec = sel.records.new_empty((st.states.shape[0], 0, cfg.eps_records, REC_COLS))
    eps_ovf = eps_sat = None  # an eps-free device graph: no closure, no eps records
    if fc.eps_iters:
        mid, eps_rec, eps_ovf, eps_sat = eps_closure_rec_batched(
            mid, ex.next_cutoff, frame_active, pg, fc, num_states, cfg.eps_records, sb
        )
    return TailInputs(mid.states, mid.costs, ex.overflow, sel.num_unique, eps_ovf, eps_sat,
                      rec_overflow=sel.rec_overflow, em_records=sel.records,
                      eps_records=eps_rec)


def lattice_frame_step_batched(
    st: StepState,  # (B, K)
    scores_t: torch.Tensor,  # (B, V)
    frame_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """One whole-batch lattice frame: GetCutoff, :func:`lattice_frame_body`,
    then its tail (the rebase by each row's best cost and the freeze of
    rows whose utterance has ended, their records -1;
    ``kernels.frame.frame_tail_plain``)."""
    from kaldi_decoder_tpu_torch.kernels.frame import frame_tail_plain

    fc = cfg.frontier
    cut = get_cutoff(
        st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
        costs_sorted=True,
    )
    tin = lattice_frame_body(st, cut.cutoff, cut.adaptive_beam, scores_t, frame_active, pg,
                             cfg, num_states)
    final, out, _ = frame_tail_plain(st, cut.cutoff, tin, frame_active, fc)
    return final, out


def init_closure_rec(pg: PackedGraph, start: int, num_states: int, cfg: LatticeDevConfig,
                     device) -> Tuple[StepState, torch.Tensor]:
    """InitDecoding and its eps closure, emitting records
    (`lattice-simple-decoder.cc:17-34`): the start token, then the
    row-by-row closure with cutoff +inf.  Returns the (1, K) frontier and
    its records (D, R_eps, 4)."""
    st = start_state(start, cfg.frontier, device)
    cut = torch.full((1,), INF, dtype=torch.float32, device=device)
    st, recs, _, _ = eps_closure_rec(
        st, cut, pg, cfg.frontier, num_states, cfg.eps_records, cfg.lattice_beam + 1e-4
    )
    return st, recs[0]


def lattice_chunk(
    pg: PackedGraph,
    scores_tm: torch.Tensor,  # (C, B, V) time-major
    lengths: torch.Tensor,  # (B,) int32 — frames still to decode from t=0
    st0: StepState,
    cfg: LatticeDevConfig,
    num_states: int,
) -> Tuple[StepState, LatticeStepOut]:
    """C frames from ``st0`` (the original's jitted ``lax.scan``); frames
    t >= lengths are no-ops for that row.  Returns the final state and the
    per-frame outputs stacked (C, B, ...).  The frames run through
    :mod:`kaldi_decoder_tpu_torch.decoders.driver`: on a card one captured
    CUDA graph of a frame is replayed for each."""
    # Imported here: the frame driver imports this module.
    from kaldi_decoder_tpu_torch.decoders.driver import run_chunk

    return run_chunk(True, pg, scores_tm, lengths, st0, cfg, num_states)
