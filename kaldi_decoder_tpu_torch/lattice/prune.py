"""Host lattice construction: backward extra-cost pruning + flat arcs.

A jax-free copy of ``kaldi_decoder_tpu/lattice/prune.py`` (its
``prune_lattice``, ``prune_token_structure``, ``raw_lattice_to_fst``,
``flat_arc_arrays``, the streaming ``IncrementalLattice`` and their
helpers).  Importing any module of ``kaldi_decoder_tpu`` imports jax,
which the port must run without, so the port carries this copy;
``tests/test_torch_host.py`` holds it equal to the original.

Consumes the device lattice decoder's outputs (per-frame token frontiers =
alpha values, and arc records) and reproduces the reference's finalization
pipeline on (frame, state)-keyed tokens:

* ``FinalizeDecoding`` — full backward sweep over frames
  (`kaldi-decoder/csrc/lattice-simple-decoder.cc:407-420`);
* ``PruneForwardLinksFinal`` — final-prob folding into extra costs on the
  last frame (`lattice-simple-decoder.cc:425-520`), including the
  "no final state reached → treat all as final" fallback;
* ``PruneForwardLinks`` — per-token
  ``extra = min over links (extra(next) + link_slack)`` with
  ``link_slack = alpha(src) + graph + acoustic - alpha(dst)``, links pruned
  above ``lattice_beam``, negative slack clamped to 0
  (`lattice-simple-decoder.cc:228-305`); intra-frame epsilon links are
  iterated to a fixed point exactly like the reference's repeat-until-
  unchanged loop (`:262-264` comment: links are not in topological order);
* ``PruneTokensForFrame`` — tokens with infinite extra cost vanish
  (`lattice-simple-decoder.cc:310-334`);
* ``GetRawLattice`` — surviving tokens become states, links become arcs
  with (graph_cost, acoustic_cost) weights, final frame tokens get their
  final weights (`lattice-simple-decoder.cc:584-657`).

Everything is vectorized numpy per frame; the lattice after pruning is
small, so host time is negligible next to the device scan.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.fst import Lattice
from kaldi_decoder_tpu_torch.utils.math import approx_equal_array

INF = float("inf")

NEG_CLAMP_WARN = -0.01  # lattice-simple-decoder.cc:287 warning threshold


@dataclasses.dataclass
class FrameTokens:
    states: np.ndarray  # (n,) int32, sorted unique
    alpha: np.ndarray  # (n,) float32 absolute forward costs
    extra: np.ndarray  # (n,) float32, filled by the backward sweep

    def index_of(self, state_ids: np.ndarray) -> np.ndarray:
        """Map state ids -> token indices; -1 when absent."""
        pos = np.searchsorted(self.states, state_ids)
        pos = np.clip(pos, 0, max(len(self.states) - 1, 0))
        ok = (
            (len(self.states) > 0)
            & (self.states[pos] == state_ids)
        )
        return np.where(ok, pos, -1)


@dataclasses.dataclass
class FrameLinks:
    """Links out of frame f: emitting (to f+1) or epsilon (within f)."""

    src: np.ndarray  # (m,) token index in frame f
    dst: np.ndarray  # (m,) token index in target frame
    ilabel: np.ndarray
    olabel: np.ndarray
    graph_cost: np.ndarray
    ac_cost: np.ndarray
    keep: np.ndarray  # (m,) bool, updated by pruning


def _frame_tokens(states_k: np.ndarray, costs_k: np.ndarray) -> FrameTokens:
    ok = np.isfinite(costs_k)
    states = states_k[ok].astype(np.int64)
    alpha = costs_k[ok].astype(np.float64)
    order = np.argsort(states, kind="stable")
    states, alpha = states[order], alpha[order]
    # States are unique within a frontier by construction (dedup_select).
    return FrameTokens(states=states, alpha=alpha, extra=np.full(len(states), INF))


def _collect_em_links(
    records: np.ndarray,  # (R, >=2) int32; cols (src_state, arc_id), -1 padded
    toks_src: FrameTokens,
    toks_dst: FrameTokens,
    graph: CsrGraph,
    scores_t: np.ndarray,
) -> FrameLinks:
    ga = graph.arrays
    ok = records[:, 1] >= 0
    src_state = records[ok, 0]
    arc = records[ok, 1]
    # Dedup (src_state, arc): the device record buffer may repeat a link
    # (frontier winners are emitted in addition to the fill prefix).
    if len(arc):
        key = src_state.astype(np.int64) * (graph.num_emitting_arcs + 1) + arc
        _, first = np.unique(key, return_index=True)
        src_state, arc = src_state[first], arc[first]
    dst_state = ga.em_next[arc]
    si = toks_src.index_of(src_state)
    di = toks_dst.index_of(dst_state)
    keep = (si >= 0) & (di >= 0)
    src, dst, arc = si[keep], di[keep], arc[keep]
    return FrameLinks(
        src=src,
        dst=dst,
        ilabel=ga.em_ilabel[arc],
        olabel=ga.em_olabel[arc],
        graph_cost=ga.em_weight[arc].astype(np.float64),
        ac_cost=(-scores_t[ga.em_score_idx[arc]]).astype(np.float64),
        keep=np.ones(len(src), dtype=bool),
    )


def _collect_eps_links(
    records: np.ndarray,  # (D, R, >=2) int32; cols (src_state, arc_id)
    toks: FrameTokens,
    graph: CsrGraph,
) -> FrameLinks:
    ga = graph.arrays
    recs = records.reshape(-1, records.shape[-1])
    ok = recs[:, 1] >= 0
    src_state = recs[ok, 0]
    arc = recs[ok, 1]
    # Dedup (src_state, arc): closure iterations re-emit unchanged links,
    # like the reference's DeleteForwardLinks+regenerate pattern
    # (lattice-simple-decoder.cc:160-163) nets out to one link per arc.
    if len(arc):
        key = src_state.astype(np.int64) * (graph.num_eps_arcs + 1) + arc
        _, first = np.unique(key, return_index=True)
        src_state, arc = src_state[first], arc[first]
    dst_state = ga.eps_next[arc]
    si = toks.index_of(src_state)
    di = toks.index_of(dst_state)
    keep = (si >= 0) & (di >= 0)
    src, dst, arc = si[keep], di[keep], arc[keep]
    return FrameLinks(
        src=src,
        dst=dst,
        ilabel=np.zeros(len(src), np.int32),
        olabel=ga.eps_olabel[arc],
        graph_cost=ga.eps_weight[arc].astype(np.float64),
        ac_cost=np.zeros(len(src)),
        keep=np.ones(len(src), dtype=bool),
    )


@dataclasses.dataclass
class PrunedLattice:
    """Tokens + links after the backward sweep, pre-FST."""

    tokens: List[FrameTokens]  # frames 0..L
    em_links: List[FrameLinks]  # frame f -> f+1, f in 0..L-1
    eps_links: List[FrameLinks]  # within frame f, f in 0..L
    final_costs: Dict[int, float]  # frame-L token index -> final cost
    final_best_cost: float
    final_relative_cost: float
    num_frames: int
    start_state: int  # graph start state (its frame-0 token = lattice start)


def prune_lattice(
    frame_states: np.ndarray,  # (L+1, K) int32 frontier states per frame
    frame_costs: np.ndarray,  # (L+1, K) float32 absolute alphas
    init_eps_records: np.ndarray,  # (D, R, >=2)
    em_records,  # (L, R_em, 2) array or length-L list of (R_t, 2)
    eps_records,  # (L, D, R_eps, 2) array or length-L list of (.., 2)
    scores: np.ndarray,  # (L, V)
    graph: CsrGraph,
    lattice_beam: float,
    use_final_probs: bool = True,
) -> Optional[PrunedLattice]:
    L = len(em_records)
    tokens = [
        _frame_tokens(frame_states[f], frame_costs[f]) for f in range(L + 1)
    ]
    if any(len(t.states) == 0 for t in tokens):
        # GetRawLattice warns and bails on empty frames
        # (lattice-simple-decoder.cc:598-603).
        return None

    em_links = [
        _collect_em_links(em_records[t], tokens[t], tokens[t + 1], graph, scores[t])
        for t in range(L)
    ]
    eps_links = [
        _collect_eps_links(
            init_eps_records if f == 0 else eps_records[f - 1], tokens[f], graph
        )
        for f in range(L + 1)
    ]
    return prune_token_structure(
        tokens, em_links, eps_links, graph, lattice_beam, use_final_probs
    )


def prune_token_structure(
    tokens: List[FrameTokens],
    em_links: List[FrameLinks],
    eps_links: List[FrameLinks],
    graph: CsrGraph,
    lattice_beam: float,
    use_final_probs: bool = True,
) -> Optional[PrunedLattice]:
    """FinalizeDecoding over pre-collected tokens/links (mutates them):
    final-prob folding, full backward extra-cost sweep, token pruning,
    PrunedLattice assembly (`lattice-simple-decoder.cc:407-520`)."""
    L = len(tokens) - 1
    if any(len(t.states) == 0 for t in tokens):
        return None

    # ---- final frame: fold final-probs (PruneForwardLinksFinal) ----------
    last = tokens[L]
    fc = graph.arrays.final_cost[last.states].astype(np.float64)
    best_cost = float(np.min(last.alpha))
    with np.errstate(invalid="ignore"):
        best_with_final = float(np.min(last.alpha + fc))
    have_final = np.isfinite(best_with_final)
    if have_final:
        final_best = best_with_final
        final_term = last.alpha + fc - final_best  # inf for non-final tokens
        final_relative = best_with_final - best_cost
    else:
        # No final state reached: treat all tokens as final
        # (lattice-simple-decoder.cc:461-472 final_costs empty branch).
        final_best = best_cost
        final_term = last.alpha - final_best
        final_relative = INF

    # ---- backward sweep -------------------------------------------------
    for f in range(L, -1, -1):
        toks = tokens[f]
        base = np.full(len(toks.states), INF)
        if f == L:
            base = final_term.copy()
        else:
            lk = em_links[f]
            nxt = tokens[f + 1]
            if len(lk.src):
                slack = (
                    toks.alpha[lk.src]
                    + lk.graph_cost
                    + lk.ac_cost
                    - nxt.alpha[lk.dst]
                )
                if np.any(np.isnan(slack)):
                    raise FloatingPointError(
                        "NaN link extra cost in lattice pruning (bad "
                        "acoustic scores or graph weights)"
                    )
                le = nxt.extra[lk.dst] + slack
                lk.keep = le <= lattice_beam
                le = np.maximum(le, 0.0)  # negative-slack clamp (:286-291)
                kept = lk.keep & np.isfinite(le)
                np.minimum.at(base, lk.src[kept], le[kept])

        # Intra-frame eps fixed point.  Convergence test matches the
        # reference: the final frame uses ApproxEqual at delta=1e-5
        # (`lattice-simple-decoder.cc:505-514`), non-final frames iterate
        # until exactly unchanged (FinalizeDecoding passes delta=0.0,
        # `lattice-simple-decoder.cc:411-414` + `:290-293`).
        ek = eps_links[f]
        extra = base.copy()
        if len(ek.src):
            slack = (
                toks.alpha[ek.src] + ek.graph_cost - toks.alpha[ek.dst]
            )
            if np.any(np.isnan(slack)):
                # NaN link cost: the reference asserts
                # (`lattice-simple-decoder.cc:261-262`).
                raise FloatingPointError(
                    "NaN link extra cost in lattice pruning (bad acoustic "
                    "scores or graph weights)"
                )
            for _ in range(len(ek.src) + 1):
                le = extra[ek.dst] + slack
                ek.keep = le <= lattice_beam
                le = np.maximum(le, 0.0)
                new_extra = base.copy()
                kept = ek.keep & np.isfinite(le)
                np.minimum.at(new_extra, ek.src[kept], le[kept])
                if f == L:
                    converged = np.all(
                        approx_equal_array(new_extra, extra, 1e-5)
                    )
                else:
                    converged = np.array_equal(new_extra, extra)
                extra = new_extra
                if converged:
                    break
        if f == L:
            # Final-frame tokens beyond the lattice beam die outright
            # (lattice-simple-decoder.cc:496-502).
            extra = np.where(extra > lattice_beam, INF, extra)
        toks.extra = extra

    # ---- token pruning ---------------------------------------------------
    for f in range(L + 1):
        toks = tokens[f]
        alive = np.isfinite(toks.extra) & (toks.extra <= lattice_beam)
        if not np.any(alive):
            return None
        # Reindex tokens; remap links.
        new_index = np.cumsum(alive) - 1
        remap = np.where(alive, new_index, -1)
        toks.states = toks.states[alive]
        toks.alpha = toks.alpha[alive]
        toks.extra = toks.extra[alive]

        def _remap_links(lk: FrameLinks, side: str):
            idx = getattr(lk, side)
            if len(idx) == 0:
                return
            mapped = remap[idx]
            lk.keep &= mapped >= 0
            setattr(lk, side, np.where(mapped >= 0, mapped, 0))

        _remap_links(eps_links[f], "src")
        _remap_links(eps_links[f], "dst")
        if f < L:
            _remap_links(em_links[f], "src")
        if f > 0:
            _remap_links(em_links[f - 1], "dst")

    final_costs = {}
    last = tokens[L]
    if use_final_probs and have_final:
        fc = graph.arrays.final_cost[last.states].astype(np.float64)
        for i in range(len(last.states)):
            if np.isfinite(fc[i]):
                final_costs[i] = float(fc[i])

    return PrunedLattice(
        tokens=tokens,
        em_links=em_links,
        eps_links=eps_links,
        final_costs=final_costs,
        final_best_cost=float(final_best),
        final_relative_cost=float(final_relative),
        num_frames=L,
        start_state=graph.start_state,
    )


def raw_lattice_to_fst(
    pl: PrunedLattice, use_final_probs: bool = True
) -> Optional[Lattice]:
    """GetRawLattice (`lattice-simple-decoder.cc:584-657`): tokens→states,
    links→arcs; returns None if the lattice is empty."""
    lat = Lattice()
    offsets = []
    n = 0
    for f in range(pl.num_frames + 1):
        offsets.append(n)
        n += len(pl.tokens[f].states)
    if n == 0:
        return None
    lat.add_states(n)

    def add_links(lk: FrameLinks, src_off: int, dst_off: int):
        for i in range(len(lk.src)):
            if not lk.keep[i]:
                continue
            lat.add_arc(
                src_off + int(lk.src[i]),
                int(lk.ilabel[i]),
                int(lk.olabel[i]),
                (float(lk.graph_cost[i]), float(lk.ac_cost[i])),
                dst_off + int(lk.dst[i]),
            )

    for f in range(pl.num_frames + 1):
        add_links(pl.eps_links[f], offsets[f], offsets[f])
        if f < pl.num_frames:
            add_links(pl.em_links[f], offsets[f], offsets[f + 1])

    # Final weights (lattice-simple-decoder.cc:640-648).
    last_off = offsets[pl.num_frames]
    nlast = len(pl.tokens[pl.num_frames].states)
    if use_final_probs and pl.final_costs:
        for i, c in pl.final_costs.items():
            lat.set_final(last_off + int(i), (c, 0.0))
    else:
        for i in range(nlast):
            lat.set_final(last_off + i, (0.0, 0.0))

    # Start state: the frame-0 token sitting on the graph's start state.
    # (The reference relies on insertion order, :612-617; we look it up.)
    start_tok = pl.tokens[0].index_of(np.array([pl.start_state], dtype=np.int64))[0]
    if start_tok < 0:
        return None
    lat.set_start(int(start_tok))
    return lat


def flat_arc_arrays(pl: PrunedLattice, use_final_probs: bool = True):
    """PrunedLattice -> flat CSR-free arc arrays (vectorized, no Python
    FST object): the production serving path feeds these straight into
    ``native.shortest_path_arrays`` for 1-best extraction, skipping the
    per-arc ``add_arc`` loop of :func:`raw_lattice_to_fst` (same
    semantics: `lattice-simple-decoder.cc:574-657` state/arc mapping,
    `:574-580` ShortestPath).

    Returns (num_states, src, dst, ilabel, olabel, w_graph, w_ac,
    final_graph (S,), start) or None if the lattice is empty."""
    offsets = []
    n = 0
    for f in range(pl.num_frames + 1):
        offsets.append(n)
        n += len(pl.tokens[f].states)
    if n == 0:
        return None

    srcs, dsts, ils, ols, wgs, was = [], [], [], [], [], []

    def take(lk: FrameLinks, src_off: int, dst_off: int):
        k = lk.keep
        if not np.any(k):
            return
        srcs.append(lk.src[k] + src_off)
        dsts.append(lk.dst[k] + dst_off)
        ils.append(lk.ilabel[k])
        ols.append(lk.olabel[k])
        wgs.append(lk.graph_cost[k])
        was.append(lk.ac_cost[k])

    for f in range(pl.num_frames + 1):
        take(pl.eps_links[f], offsets[f], offsets[f])
        if f < pl.num_frames:
            take(pl.em_links[f], offsets[f], offsets[f + 1])

    cat = lambda xs, dt: (
        np.concatenate(xs).astype(dt) if xs else np.zeros(0, dt)
    )
    src = cat(srcs, np.int32)
    dst = cat(dsts, np.int32)
    il = cat(ils, np.int32)
    ol = cat(ols, np.int32)
    wg = cat(wgs, np.float32)
    wa = cat(was, np.float32)

    last_off = offsets[pl.num_frames]
    nlast = len(pl.tokens[pl.num_frames].states)
    final_graph = np.full(n, np.inf, np.float32)
    if use_final_probs and pl.final_costs:
        for i, c in pl.final_costs.items():
            final_graph[last_off + int(i)] = np.float32(c)
    else:
        final_graph[last_off : last_off + nlast] = 0.0

    start_tok = pl.tokens[0].index_of(
        np.array([pl.start_state], dtype=np.int64)
    )[0]
    if start_tok < 0:
        return None
    return n, src, dst, il, ol, wg, wa, final_graph, int(start_tok)


def _links_compact(lk: FrameLinks, keep: np.ndarray) -> FrameLinks:
    return FrameLinks(
        src=lk.src[keep],
        dst=lk.dst[keep],
        ilabel=lk.ilabel[keep],
        olabel=lk.olabel[keep],
        graph_cost=lk.graph_cost[keep],
        ac_cost=lk.ac_cost[keep],
        keep=np.ones(int(keep.sum()), dtype=bool),
    )


def _links_copy(lk: FrameLinks) -> FrameLinks:
    return FrameLinks(
        src=lk.src.copy(),
        dst=lk.dst.copy(),
        ilabel=lk.ilabel.copy(),
        olabel=lk.olabel.copy(),
        graph_cost=lk.graph_cost.copy(),
        ac_cost=lk.ac_cost.copy(),
        keep=lk.keep.copy(),
    )


class IncrementalLattice:
    """Streaming host lattice with windowed pruning (the ``prune_interval``
    capability, `lattice-simple-decoder.cc:198-223` PruneActiveTokens).

    Frames are appended as device chunks arrive (scores are consumed at
    append time and not retained); ``prune_active_tokens`` runs the
    backward extra-cost sweep from the live frontier — whose tokens carry
    extra 0, the reference's Token-constructor initialisation — pruning
    links whose extra lower bound already exceeds ``lattice_beam`` and
    deleting unreachable tokens.  Because true extra costs only grow as
    more audio arrives, everything pruned here is provably outside the
    final lattice: ``finalize`` yields the identical lattice to a
    one-shot decode.  The sweep stops early once a frame's extras settle
    within ``delta = lattice_beam * prune_scale``
    (`lattice-simple-decoder.cc:228-305` delta semantics).
    """

    def __init__(
        self,
        graph: CsrGraph,
        lattice_beam: float,
        prune_scale: float = 0.1,
    ):
        self.graph = graph
        self.lattice_beam = float(lattice_beam)
        self.delta = float(lattice_beam) * float(prune_scale)
        self.tokens: List[FrameTokens] = []
        self.em_links: List[FrameLinks] = []  # frame f -> f+1
        self.eps_links: List[FrameLinks] = []  # within frame f
        self.dead = False  # an empty frontier was appended

    @property
    def num_frames(self) -> int:
        return max(len(self.tokens) - 1, 0)

    def live_links(self) -> int:
        return sum(len(l.src) for l in self.em_links) + sum(
            len(l.src) for l in self.eps_links
        )

    def live_tokens(self) -> int:
        return sum(len(t.states) for t in self.tokens)

    def init_frame(self, states, costs, init_eps_records) -> None:
        toks = _frame_tokens(np.asarray(states), np.asarray(costs))
        self.tokens = [toks]
        self.em_links = []
        self.eps_links = [
            _collect_eps_links(np.asarray(init_eps_records), toks, self.graph)
        ]
        self.dead = len(toks.states) == 0

    def append_frame(self, states, costs, em_records, eps_records, scores_t):
        """Add the frame whose frontier is (states, costs); ``em_records``
        link the previous frame to it, ``eps_records`` are its intra-frame
        epsilon links, ``scores_t`` the acoustic row that produced it."""
        toks = _frame_tokens(np.asarray(states), np.asarray(costs))
        self.em_links.append(
            _collect_em_links(
                np.asarray(em_records), self.tokens[-1], toks, self.graph,
                np.asarray(scores_t),
            )
        )
        self.tokens.append(toks)
        self.eps_links.append(
            _collect_eps_links(np.asarray(eps_records), toks, self.graph)
        )
        self.dead = self.dead or len(toks.states) == 0

    # -- windowed pruning ---------------------------------------------------

    def _sweep_frame(self, f: int, base: np.ndarray) -> np.ndarray:
        """extra = min over links of (extra(next) + slack), links above the
        lattice beam dropped; intra-frame eps fixed point (mirrors the
        backward loop in prune_token_structure, without final folding)."""
        toks = self.tokens[f]
        lb = self.lattice_beam
        if f < len(self.tokens) - 1:
            lk = self.em_links[f]
            nxt = self.tokens[f + 1]
            if len(lk.src):
                slack = (
                    toks.alpha[lk.src]
                    + lk.graph_cost
                    + lk.ac_cost
                    - nxt.alpha[lk.dst]
                )
                le = nxt.extra[lk.dst] + slack
                lk.keep = le <= lb
                le = np.maximum(le, 0.0)
                kept = lk.keep & np.isfinite(le)
                np.minimum.at(base, lk.src[kept], le[kept])
                self.em_links[f] = _links_compact(lk, lk.keep)
        extra = base.copy()
        ek = self.eps_links[f]
        if len(ek.src):
            slack = toks.alpha[ek.src] + ek.graph_cost - toks.alpha[ek.dst]
            for _ in range(len(ek.src) + 1):
                le = extra[ek.dst] + slack
                ek.keep = le <= lb
                le = np.maximum(le, 0.0)
                new_extra = base.copy()
                kept = ek.keep & np.isfinite(le)
                np.minimum.at(new_extra, ek.src[kept], le[kept])
                converged = np.all(
                    approx_equal_array(
                        np.minimum(new_extra, 1e30),
                        np.minimum(extra, 1e30),
                        1e-6,
                    )
                )
                extra = new_extra
                if converged:
                    break
            self.eps_links[f] = _links_compact(ek, ek.keep)
        return extra

    def _delete_dead(self, f: int) -> None:
        toks = self.tokens[f]
        alive = np.isfinite(toks.extra)
        if np.all(alive):
            return
        new_index = np.cumsum(alive) - 1
        remap = np.where(alive, new_index, -1)
        toks.states = toks.states[alive]
        toks.alpha = toks.alpha[alive]
        toks.extra = toks.extra[alive]

        def _remap(lk: FrameLinks, side: str):
            idx = getattr(lk, side)
            if len(idx) == 0:
                return lk
            mapped = remap[idx]
            keep = mapped >= 0
            setattr(lk, side, np.where(keep, mapped, 0))
            return _links_compact(lk, lk.keep & keep)

        self.eps_links[f] = _remap(_remap(self.eps_links[f], "src"), "dst")
        if f < len(self.tokens) - 1:
            self.em_links[f] = _remap(self.em_links[f], "src")
        if f > 0:
            self.em_links[f - 1] = _remap(self.em_links[f - 1], "dst")

    def prune_active_tokens(self) -> None:
        """PruneActiveTokens(lattice_beam * prune_scale): backward sweep
        from the live frontier with early stop, then dead-token deletion
        (`lattice-simple-decoder.cc:198-223`, `:310-334`)."""
        L = len(self.tokens) - 1
        if L < 0 or self.dead:
            return
        # Frontier tokens are alive by definition: extra = 0
        # (lattice-simple-decoder.h:200 Token ctor).
        first_changed = L
        for f in range(L, -1, -1):
            toks = self.tokens[f]
            base = (
                np.zeros(len(toks.states))
                if f == L
                else np.full(len(toks.states), INF)
            )
            extra = self._sweep_frame(f, base)
            changed = not np.all(
                np.abs(np.minimum(extra, 1e30) - np.minimum(toks.extra, 1e30))
                <= self.delta
            )
            toks.extra = extra
            first_changed = f
            if not changed:
                break
        for f in range(first_changed, L):  # never delete the live frontier
            self._delete_dead(f)

    # -- finalization ---------------------------------------------------------

    def finalize(self, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        """FinalizeDecoding on a copy of the retained structure (the
        incremental state stays valid for further appends)."""
        if self.dead or not self.tokens:
            return None
        tokens = [
            FrameTokens(t.states.copy(), t.alpha.copy(), np.full(len(t.states), INF))
            for t in self.tokens
        ]
        em = [_links_copy(l) for l in self.em_links]
        eps = [_links_copy(l) for l in self.eps_links]
        return prune_token_structure(
            tokens, em, eps, self.graph, self.lattice_beam, use_final_probs
        )
