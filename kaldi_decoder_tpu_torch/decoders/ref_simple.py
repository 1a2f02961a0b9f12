"""Pure-Python/numpy oracle decoder with exact SimpleDecoder semantics.

A jax-free copy of ``kaldi_decoder_tpu/decoders/ref_simple.py`` (lines
21-212, ``OracleSimpleDecoder``), kept because importing the original
imports jax; ``tests/test_torch_oracle.py`` holds the copy equal to the
original.

It reimplements the reference ``SimpleDecoder``
(`kaldi-decoder/csrc/simple-decoder.cc`) step for step on host
dictionaries: per frame, swap frontiers, ``process_emitting`` with a
running cutoff (`simple-decoder.cc:150-193`), the
``process_nonemitting`` epsilon-closure worklist (`:195-241`) and the
``prune_toks`` beam prune (`:252-281`); a backpointer token chain storing
each arc's (graph_cost, acoustic_cost) (`simple-decoder.h:81-116`);
``get_best_path`` walks the chain, reverses it and applies RemoveEpsLocal
(`simple-decoder.cc:104-148`).  Slow and obvious; never on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

from kaldi_decoder_tpu_torch.decodable import DecodableInterface
from kaldi_decoder_tpu_torch.fst.fst import EPSILON, INF, Lattice, StdVectorFst
from kaldi_decoder_tpu_torch.fst.ops import remove_eps_local


class _Token:
    """Backpointer token: arc taken to get here + accumulated cost.

    ``arc`` fields mirror SimpleDecoder::Token's LatticeArc storage
    (`simple-decoder.h:81-116`): (ilabel, olabel, graph_cost,
    acoustic_cost, nextstate).
    """

    __slots__ = ("ilabel", "olabel", "graph_cost", "ac_cost", "state", "cost", "prev")

    def __init__(self, ilabel, olabel, graph_cost, ac_cost, state, cost, prev):
        self.ilabel = ilabel
        self.olabel = olabel
        self.graph_cost = graph_cost
        self.ac_cost = ac_cost
        self.state = state  # arc.nextstate == the state this token sits on
        self.cost = cost
        self.prev = prev


class OracleSimpleDecoder:
    """Reference-exact Viterbi beam decoder over a host ``StdVectorFst``."""

    def __init__(self, fst: StdVectorFst, beam: float = 16.0):
        if beam <= 0:
            raise ValueError("beam must be positive")
        self.fst = fst
        self.beam = float(beam)
        self.cur_toks: Dict[int, _Token] = {}
        self.prev_toks: Dict[int, _Token] = {}
        self.num_frames_decoded = -1

    # -- reference API -------------------------------------------------------

    def decode(self, decodable: DecodableInterface) -> bool:
        self.init_decoding()
        self.advance_decoding(decodable)
        return bool(self.cur_toks)

    def init_decoding(self) -> None:
        self.cur_toks.clear()
        self.prev_toks.clear()
        start = self.fst.start
        assert start >= 0
        # Dummy start token (simple-decoder.cc:36-38): epsilon arc into start.
        self.cur_toks[start] = _Token(EPSILON, EPSILON, 0.0, 0.0, start, 0.0, None)
        self.num_frames_decoded = 0
        self._process_nonemitting()

    def advance_decoding(
        self, decodable: DecodableInterface, max_num_frames: int = -1
    ) -> None:
        assert self.num_frames_decoded >= 0, "call init_decoding() first"
        num_frames_ready = decodable.num_frames_ready()
        assert num_frames_ready >= self.num_frames_decoded
        target = num_frames_ready
        if max_num_frames >= 0:
            target = min(target, self.num_frames_decoded + max_num_frames)
        while self.num_frames_decoded < target:
            self.prev_toks = self.cur_toks
            self.cur_toks = {}
            self._process_emitting(decodable)
            self._process_nonemitting()
            self._prune_toks()

    def reached_final(self) -> bool:
        return any(
            tok.cost != INF and self.fst.is_final(s)
            for s, tok in self.cur_toks.items()
        )

    def final_relative_cost(self) -> float:
        """simple-decoder.cc:78-100 parity (INF on empty/NaN)."""
        if not self.cur_toks:
            return INF
        best = INF
        best_with_final = INF
        for s, tok in self.cur_toks.items():
            best = min(best, tok.cost)
            best_with_final = min(best_with_final, tok.cost + self.fst.final(s))
        extra = best_with_final - best
        if math.isnan(extra):
            return INF
        return extra

    def get_best_path(self, use_final_probs: bool = True) -> Optional[Lattice]:
        """Best path as a linear lattice; None if no tokens survived."""
        best_tok = None
        is_final = self.reached_final()
        if not is_final:
            for tok in self.cur_toks.values():
                if best_tok is None or tok.cost < best_tok.cost:
                    best_tok = tok
        else:
            best_cost = INF
            for s, tok in self.cur_toks.items():
                c = tok.cost + self.fst.final(s)
                if c != INF and c < best_cost:
                    best_cost, best_tok = c, tok
        if best_tok is None:
            return None

        arcs_reverse = []
        tok = best_tok
        while tok is not None:
            arcs_reverse.append(tok)
            tok = tok.prev
        # Last entry is the dummy start token (simple-decoder.cc:131-133).
        assert arcs_reverse[-1].state == self.fst.start
        arcs_reverse.pop()

        out = Lattice()
        cur = out.add_state()
        out.set_start(cur)
        for tok in reversed(arcs_reverse):
            nxt = out.add_state()
            out.add_arc(cur, tok.ilabel, tok.olabel, (tok.graph_cost, tok.ac_cost), nxt)
            cur = nxt
        if is_final and use_final_probs:
            out.set_final(cur, (self.fst.final(best_tok.state), 0.0))
        else:
            out.set_final(cur, (0.0, 0.0))
        return remove_eps_local(out)

    # -- internals -----------------------------------------------------------

    def _process_emitting(self, decodable: DecodableInterface) -> None:
        frame = self.num_frames_decoded
        cutoff = INF
        for state, tok in self.prev_toks.items():
            for arc in self.fst.arcs(state):
                if arc.ilabel == EPSILON:
                    continue
                ac_cost = -decodable.log_likelihood(frame, arc.ilabel)
                total = tok.cost + arc.weight + ac_cost
                if total >= cutoff:
                    continue
                if total + self.beam < cutoff:
                    cutoff = total + self.beam
                new_tok = _Token(
                    arc.ilabel, arc.olabel, arc.weight, ac_cost,
                    arc.nextstate, total, tok,
                )
                old = self.cur_toks.get(arc.nextstate)
                if old is None or old.cost > new_tok.cost:
                    self.cur_toks[arc.nextstate] = new_tok
        self.num_frames_decoded += 1

    def _process_nonemitting(self) -> None:
        queue = list(self.cur_toks.keys())
        best = min((t.cost for t in self.cur_toks.values()), default=INF)
        cutoff = best + self.beam
        while queue:
            state = queue.pop()
            tok = self.cur_toks[state]
            for arc in self.fst.arcs(state):
                if arc.ilabel != EPSILON:
                    continue
                new_cost = tok.cost + arc.weight
                if new_cost > cutoff:
                    continue
                old = self.cur_toks.get(arc.nextstate)
                if old is None or old.cost > new_cost:
                    self.cur_toks[arc.nextstate] = _Token(
                        EPSILON, arc.olabel, arc.weight, 0.0,
                        arc.nextstate, new_cost, tok,
                    )
                    queue.append(arc.nextstate)

    def _prune_toks(self) -> None:
        if not self.cur_toks:
            return
        best = min(t.cost for t in self.cur_toks.values())
        cutoff = best + self.beam
        self.cur_toks = {s: t for s, t in self.cur_toks.items() if t.cost < cutoff}

    # -- oracle-only introspection (for differential tests) ------------------

    def frontier(self) -> Dict[int, float]:
        """Current {state: cost} frontier."""
        return {s: t.cost for s, t in self.cur_toks.items()}
