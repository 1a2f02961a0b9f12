"""Pure-Python oracle lattice decoder with exact LatticeSimpleDecoder
semantics (`kaldi-decoder/csrc/lattice-simple-decoder.cc`).

A jax-free copy of ``kaldi_decoder_tpu/decoders/ref_lattice.py`` (lines
15-350, ``OracleLatticeDecoder``), kept because importing the original
imports jax; ``tests/test_torch_oracle.py`` holds the copy equal to the
original, and ``scripts/measure_recall_torch.py`` measures the device
lattice's link recall against it.

Forward-linked tokens per frame (`lattice-simple-decoder.h:164-230`),
FindOrAddToken scatter-min (`lattice-simple-decoder.cc:82-120`),
eps-closure link regeneration (`:122-191`), beam pruning of current
tokens (`:339-362`), and the FinalizeDecoding backward extra-cost sweep
with final-prob folding (`:407-520`), ending in GetRawLattice
(`:584-657`).  Slow and literal; host-only.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from kaldi_decoder_tpu_torch.decodable import DecodableInterface
from kaldi_decoder_tpu_torch.fst.fst import EPSILON, INF, Lattice, StdVectorFst
from kaldi_decoder_tpu_torch.fst.ops import shortest_path


class _Link:
    __slots__ = ("next_tok", "ilabel", "olabel", "graph_cost", "ac_cost")

    def __init__(self, next_tok, ilabel, olabel, graph_cost, ac_cost):
        self.next_tok = next_tok
        self.ilabel = ilabel
        self.olabel = olabel
        self.graph_cost = graph_cost
        self.ac_cost = ac_cost


class _Tok:
    __slots__ = ("tot_cost", "extra_cost", "links")

    def __init__(self, tot_cost):
        self.tot_cost = tot_cost
        self.extra_cost = 0.0
        self.links: List[_Link] = []


class OracleLatticeDecoder:
    """``deterministic_cutoff``: the reference's ProcessEmitting creates a
    link whenever the token total beats the *evolving* cutoff
    (`lattice-simple-decoder.cc:375-390` starts at +inf and tightens as
    better tokens appear), so links in ``[frame_best + beam, evolving)``
    survive or die depending on hash-iteration order — not semantics.
    With the flag set, the cutoff is computed first (two passes) and every
    link is judged against the final ``frame_best + beam``, which is the
    deterministic behavior the device decoder implements; its link set is
    a subset of any evolving-cutoff run's."""

    def __init__(
        self,
        fst: StdVectorFst,
        beam: float = 16.0,
        lattice_beam: float = 10.0,
        deterministic_cutoff: bool = False,
        max_active: Optional[int] = None,
        min_active: int = 0,
        beam_delta: float = 0.5,
    ):
        self.fst = fst
        self.beam = float(beam)
        self.lattice_beam = float(lattice_beam)
        self.deterministic_cutoff = bool(deterministic_cutoff)
        # GetCutoff parity (`faster-decoder.cc:244-336`): max_active gives
        # the union capability (LatticeFasterDecoder) the device implements;
        # it requires the deterministic two-pass mode since the C++
        # evolving-cutoff order-dependence has no array analogue.
        if max_active is not None and not deterministic_cutoff:
            raise ValueError("max_active requires deterministic_cutoff=True")
        self.max_active = max_active
        self.min_active = int(min_active)
        self.beam_delta = float(beam_delta)
        # Link-admission cutoff of the frame being processed (deterministic
        # mode): best_new + adaptive_beam, also used by the subsequent
        # current-token prune and eps closure (lattice_dev.lattice_emit_stage
        # passes next_cutoff to eps_closure_rec the same way).
        self._frame_cutoff = INF
        self.active_toks: List[Dict[int, _Tok]] = []  # per frame: state -> tok
        self.cur_toks: Dict[int, _Tok] = {}
        self.final_costs: Dict[int, float] = {}  # state -> final cost (last frame)
        self.final_best_cost = INF
        self.final_relative_cost_ = INF
        self.decoding_finalized = False

    # -- forward pass --------------------------------------------------------

    def decode(self, decodable: DecodableInterface) -> bool:
        self.init_decoding()
        t = 0
        while t < decodable.num_frames_ready():
            self._process_emitting(decodable, t)
            self._prune_current_tokens()
            self._process_nonemitting(t + 1)
            t += 1
        self._finalize()
        return bool(self.final_costs)

    def init_decoding(self):
        self.active_toks = [dict()]
        start = self.fst.start
        tok = _Tok(0.0)
        self.active_toks[0][start] = tok
        self.cur_toks = {start: tok}
        self._process_nonemitting(0)

    def _find_or_add(self, frame: int, state: int, tot_cost: float) -> Tuple[_Tok, bool]:
        toks = self.active_toks[frame]
        if state not in toks:
            tok = _Tok(tot_cost)
            toks[state] = tok
            self.cur_toks[state] = tok
            return tok, True
        tok = toks[state]
        if tok.tot_cost > tot_cost:
            tok.tot_cost = tot_cost
            return tok, True
        return tok, False

    def _process_emitting(self, decodable, frame: int):
        self.active_toks.append(dict())
        prev_toks = self.cur_toks
        self.cur_toks = {}
        cutoff = INF
        self._frame_cutoff = INF
        expand_cutoff, adaptive = self._get_cutoff(prev_toks)
        if self.deterministic_cutoff:
            # Pass 1: final cutoff = best_new + adaptive_beam (see class
            # docstring; adaptive_beam == beam unless max_active binds).
            for state, tok in prev_toks.items():
                if tok.tot_cost >= expand_cutoff:
                    continue
                for arc in self.fst.arcs(state):
                    if arc.ilabel == EPSILON:
                        continue
                    ac = -decodable.log_likelihood(frame, arc.ilabel)
                    tot = tok.tot_cost + arc.weight + ac
                    cutoff = min(cutoff, tot + adaptive)
            self._frame_cutoff = cutoff
        for state, tok in prev_toks.items():
            if tok.tot_cost >= expand_cutoff:
                continue
            for arc in self.fst.arcs(state):
                if arc.ilabel == EPSILON:
                    continue
                ac = -decodable.log_likelihood(frame, arc.ilabel)
                tot = tok.tot_cost + arc.weight + ac
                if tot >= cutoff:
                    continue
                if not self.deterministic_cutoff and tot + self.beam < cutoff:
                    cutoff = tot + self.beam
                nxt, _ = self._find_or_add(frame + 1, arc.nextstate, tot)
                tok.links.append(
                    _Link(nxt, arc.ilabel, arc.olabel, arc.weight, ac)
                )

    def _get_cutoff(self, toks: Dict[int, "_Tok"]) -> Tuple[float, float]:
        """GetCutoff over the previous frontier (`faster-decoder.cc:244-336`):
        (expansion cutoff, adaptive_beam).  Identity when max_active is off
        (the frontier was already beam-pruned last frame)."""
        if self.max_active is None or not toks:
            return INF, self.beam
        costs = sorted(t.tot_cost for t in toks.values())
        best = costs[0]
        beam_cutoff = best + self.beam
        if len(costs) > self.max_active:
            max_cut = costs[self.max_active]
            if max_cut < beam_cutoff:
                return max_cut, max_cut - best + self.beam_delta
        if len(costs) > self.min_active > 0:
            min_cut = costs[self.min_active]
            if min_cut > beam_cutoff:
                return min_cut, min_cut - best + self.beam_delta
        return beam_cutoff, self.beam

    def _prune_current_tokens(self):
        if not self.cur_toks:
            return
        best = min(t.tot_cost for t in self.cur_toks.values())
        cutoff = best + self.beam
        if self.deterministic_cutoff and self._frame_cutoff != INF:
            # Device parity: the new generation was admitted at
            # best_new + adaptive_beam and gets no second beam prune
            # (lattice_dev.lattice_emit_stage -> next_cutoff).
            cutoff = self._frame_cutoff
        self.cur_toks = {
            s: t for s, t in self.cur_toks.items() if t.tot_cost < cutoff
        }

    def _process_nonemitting(self, frame: int):
        queue = [
            s for s in self.cur_toks if self.fst.num_input_epsilons(s) != 0
        ]
        if not self.cur_toks:
            return
        best = min(t.tot_cost for t in self.cur_toks.values())
        cutoff = best + self.beam
        if self.deterministic_cutoff and self._frame_cutoff != INF:
            cutoff = self._frame_cutoff
        while queue:
            state = queue.pop()
            tok = self.cur_toks[state]
            # DeleteForwardLinks + regenerate (:160-163).  At this point a
            # current-frame token can only hold eps links from this same
            # closure (emitting links out of it are created next frame), so
            # dropping everything is exactly the reference behavior.
            tok.links = []
            for arc in self.fst.arcs(state):
                if arc.ilabel != EPSILON:
                    continue
                tot = tok.tot_cost + arc.weight
                if tot < cutoff:
                    nxt, changed = self._find_or_add(frame, arc.nextstate, tot)
                    tok.links.append(
                        _Link(nxt, 0, arc.olabel, arc.weight, 0.0)
                    )
                    if changed and self.fst.num_input_epsilons(arc.nextstate) != 0:
                        queue.append(arc.nextstate)

    # -- finalization --------------------------------------------------------

    def _compute_final_costs(self):
        self.final_costs = {}
        best = INF
        best_with_final = INF
        for state, tok in self.cur_toks.items():
            fc = self.fst.final(state)
            best = min(best, tok.tot_cost)
            best_with_final = min(best_with_final, tok.tot_cost + fc)
            if fc != INF:
                self.final_costs[state] = fc
        if best == INF and best_with_final == INF:
            self.final_relative_cost_ = INF
        else:
            self.final_relative_cost_ = best_with_final - best
        self.final_best_cost = (
            best_with_final if best_with_final != INF else best
        )

    def _finalize(self):
        L = len(self.active_toks) - 1
        self._compute_final_costs()
        self.decoding_finalized = True
        tok_final = {}
        for state, tok in self.active_toks[L].items():
            if self.final_costs:
                fc = self.final_costs.get(state, INF)
            else:
                fc = 0.0
            tok_final[id(tok)] = fc

        # Final-frame extra costs with final-prob folding (:449-516).
        changed = True
        while changed:
            changed = False
            for tok in self.active_toks[L].values():
                extra = tok.tot_cost + tok_final[id(tok)] - self.final_best_cost
                kept = []
                for l in tok.links:
                    le = l.next_tok.extra_cost + (
                        tok.tot_cost + l.ac_cost + l.graph_cost - l.next_tok.tot_cost
                    )
                    if le > self.lattice_beam:
                        continue
                    le = max(le, 0.0)
                    extra = min(extra, le)
                    kept.append(l)
                tok.links = kept
                if extra > self.lattice_beam:
                    extra = INF
                if abs(min(extra, 1e30) - min(tok.extra_cost, 1e30)) > 1e-5:
                    changed = True
                tok.extra_cost = extra

        # Backward over earlier frames (:411-417): fixed point per frame.
        for f in range(L - 1, -1, -1):
            changed = True
            while changed:
                changed = False
                for tok in self.active_toks[f].values():
                    extra = INF
                    kept = []
                    for l in tok.links:
                        le = l.next_tok.extra_cost + (
                            tok.tot_cost + l.ac_cost + l.graph_cost
                            - l.next_tok.tot_cost
                        )
                        if le > self.lattice_beam:
                            continue
                        le = max(le, 0.0)
                        extra = min(extra, le)
                        kept.append(l)
                    tok.links = kept
                    if abs(min(extra, 1e30) - min(tok.extra_cost, 1e30)) > 1e-5:
                        changed = True
                    tok.extra_cost = extra
            # PruneTokensForFrame(f+1)
            self.active_toks[f + 1] = {
                s: t
                for s, t in self.active_toks[f + 1].items()
                if t.extra_cost != INF
            }
        self.active_toks[0] = {
            s: t for s, t in self.active_toks[0].items() if t.extra_cost != INF
        }

    # -- outputs -------------------------------------------------------------

    def final_relative_cost(self) -> float:
        return self.final_relative_cost_

    def get_raw_lattice(self, use_final_probs: bool = True) -> Optional[Lattice]:
        L = len(self.active_toks) - 1
        lat = Lattice()
        tok_state = {}
        for f in range(L + 1):
            if not self.active_toks[f]:
                return None
            for tok in self.active_toks[f].values():
                tok_state[id(tok)] = lat.add_state()
        for f in range(L + 1):
            for state, tok in self.active_toks[f].items():
                s = tok_state[id(tok)]
                for l in tok.links:
                    if id(l.next_tok) not in tok_state:
                        continue
                    lat.add_arc(
                        s, l.ilabel, l.olabel, (l.graph_cost, l.ac_cost),
                        tok_state[id(l.next_tok)],
                    )
                if f == L:
                    if use_final_probs and self.final_costs:
                        if state in self.final_costs:
                            lat.set_final(s, (self.final_costs[state], 0.0))
                    else:
                        lat.set_final(s, (0.0, 0.0))
                if f == 0 and state == self.fst.start:
                    lat.set_start(s)
        return lat

    def get_best_path(self, use_final_probs: bool = True) -> Optional[Lattice]:
        raw = self.get_raw_lattice(use_final_probs)
        if raw is None:
            return None
        sp = shortest_path(raw)
        return sp if sp.num_states > 0 else None
