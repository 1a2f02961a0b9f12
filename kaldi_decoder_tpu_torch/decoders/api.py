"""Reference-compatible decoder API on a device.

The torch counterpart of ``kaldi_decoder_tpu/decoders/api.py``: the
classes, method names, arguments and defaults the reference exports to
Python (`kaldi-decoder/python/kaldi_decoder/__init__.py:1-9` and the
pybind registrations in `kaldi-decoder/python/csrc/*.cc`), so
icefall-style scripts port 1:1:

* ``SimpleDecoder(fst, beam, device=...)`` — `python/csrc/simple-decoder.cc:14-38`
* ``FasterDecoder(fst, config, device=...)`` + ``FasterDecoderOptions``
  — `python/csrc/faster-decoder.cc:14-58`
* ``decode`` / ``init_decoding`` / ``advance_decoding(decodable,
  max_num_frames=-1)`` / ``reached_final`` / ``final_relative_cost`` /
  ``get_best_path(use_final_probs=True) -> (ok, Lattice)`` /
  ``num_frames_decoded`` / ``set_options``

The one difference from the JAX signatures is the required ``device=``
keyword.  Both classes drive the Viterbi frame loop
(:func:`kaldi_decoder_tpu_torch.decoders.viterbi.viterbi_chunk`) with
batch size 1 on the graph as given (no eps folding, so the device eps
closure runs every frame), carrying the frontier between
``advance_decoding`` calls: the reference's in-memory streaming resume
(`faster-decoder.h:96-104`).  Each call runs exactly the new frames (the
original pads them to 64 to bound recompiles; the results are the same).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decodable import DecodableInterface, scores_from_decodable
from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepState,
    config_for_graph,
    init_closure,
)
from kaldi_decoder_tpu_torch.decoders.viterbi import ViterbiResult, viterbi_chunk
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, compile_fst
from kaldi_decoder_tpu_torch.fst.fst import Lattice, StdVectorFst
from kaldi_decoder_tpu_torch.fst.pack import pack_graph_device

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class FasterDecoderOptions:
    """faster-decoder.h:24-63 parity (same fields, same defaults).

    ``hash_ratio`` controlled the C++ hash table's load factor
    (`faster-decoder.cc:338-345`); the decoder has no hash, so it is
    accepted and validated for compatibility but has no effect.
    """

    beam: float = 16.0
    max_active: int = INT32_MAX
    min_active: int = 20
    beam_delta: float = 0.5
    hash_ratio: float = 2.0

    def __str__(self) -> str:  # ToString() parity
        return (
            f"FasterDecoderOptions(beam={self.beam:g}, "
            f"max_active={self.max_active}, min_active={self.min_active}, "
            f"beam_delta={self.beam_delta:g}, hash_ratio={self.hash_ratio:g})"
        )


def _as_graph(fst) -> CsrGraph:
    if isinstance(fst, CsrGraph):
        return fst
    if isinstance(fst, StdVectorFst):
        return compile_fst(fst)
    raise TypeError(f"expected StdVectorFst or CsrGraph, got {type(fst)!r}")


class _StreamingViterbi:
    """Shared streaming machinery for SimpleDecoder/FasterDecoder."""

    def __init__(self, fst, cfg: FrontierConfig, *, device, **cfg_overrides):
        self.device = torch.device(device)
        self._graph = _as_graph(fst)
        self._cfg = config_for_graph(self._graph, base=cfg, **cfg_overrides)
        self._pg = pack_graph_device(
            self._graph, self._cfg.block_width, self._cfg.eps_block_width,
            self._cfg.flat_group, self.device,
        )
        self._reset()

    def _reset(self):
        self._num_frames_decoded = -1  # matches C++ pre-init sentinel
        self._state: Optional[StepState] = None
        self._bp_init: Optional[np.ndarray] = None
        self._bp_emit_chunks = []
        self._bp_eps_chunks = []
        self._score_chunks = []
        self._stat_chunks = []

    # -- reference API -------------------------------------------------------

    def init_decoding(self) -> None:
        self._reset()
        st, bp_init = init_closure(
            self._pg, self._graph.start_state, self._graph.num_states, self._cfg,
            self.device,
        )
        self._state = st
        self._bp_init = bp_init.cpu().numpy()
        self._num_frames_decoded = 0

    def advance_decoding(
        self, decodable: DecodableInterface, max_num_frames: int = -1
    ) -> None:
        assert self._num_frames_decoded >= 0, (
            "You must call init_decoding() before advance_decoding()"
        )
        num_frames_ready = decodable.num_frames_ready()
        assert num_frames_ready >= self._num_frames_decoded, (
            "decodable shrank between calls (decodable-itf.h:44-52 contract)"
        )
        target = num_frames_ready
        if max_num_frames >= 0:
            target = min(target, self._num_frames_decoded + max_num_frames)
        n_new = target - self._num_frames_decoded
        if n_new <= 0:
            return
        scores = scores_from_decodable(decodable, self._num_frames_decoded, target)
        self._check_v(scores.shape[1])
        scores_tm = torch.from_numpy(np.ascontiguousarray(scores, np.float32)[:, None])
        lengths = torch.full((1,), n_new, dtype=torch.int32, device=self.device)
        stf, outs = viterbi_chunk(
            self._pg, scores_tm.to(self.device), lengths, self._state, self._cfg,
            self._graph.num_states,
        )
        self._state = stf
        self._bp_emit_chunks.append(outs.bp_emit.cpu().numpy())
        self._bp_eps_chunks.append(outs.bp_eps.cpu().numpy())
        self._score_chunks.append(scores)
        self._stat_chunks.append(
            tuple(
                x.cpu().numpy()
                for x in (outs.num_active, outs.best_cost, outs.cutoff, outs.overflow,
                          outs.saturated)
            )
        )
        self._num_frames_decoded = target

    def decode(self, decodable: DecodableInterface) -> None:
        """Decode() = InitDecoding + AdvanceDecoding (faster-decoder.cc:121)."""
        self.init_decoding()
        self.advance_decoding(decodable)

    def num_frames_decoded(self) -> int:
        return self._num_frames_decoded

    def reached_final(self) -> bool:
        return self._result().reached_final(0)

    def final_relative_cost(self) -> float:
        return self._result().final_relative_cost(0)

    def get_best_path(self, use_final_probs: bool = True) -> Tuple[bool, Lattice]:
        """Returns (ok, best_path_lattice) like the pybind wrapper
        (`python/csrc/faster-decoder.cc:46-54`): ok is False (with an empty
        lattice) only if no tokens survived."""
        lat = self._result().best_path(0, use_final_probs)
        if lat is None:
            return False, Lattice()
        return True, lat

    # -- internals -----------------------------------------------------------

    def _check_v(self, v: int) -> None:
        if self._graph.max_score_idx >= v:
            raise ValueError(
                f"graph references score index {self._graph.max_score_idx} "
                f"but decodable has only {v} indices"
            )

    def _result(self) -> ViterbiResult:
        assert self._state is not None, "call init_decoding() first"
        T = self._num_frames_decoded
        K, D = self._cfg.frontier_size, self._cfg.eps_iters
        if self._bp_emit_chunks:
            bp_emit = np.concatenate(self._bp_emit_chunks, axis=0)
            bp_eps = np.concatenate(self._bp_eps_chunks, axis=0)
            scores = np.concatenate(self._score_chunks, axis=0)[None]
            stats = [np.concatenate(s, axis=0) for s in zip(*self._stat_chunks)]
        else:
            bp_emit = np.zeros((0, 1, K, 2), np.int32)
            bp_eps = np.zeros((0, 1, D, K, 2), np.int32)
            scores = np.zeros((1, 0, 0), np.float32)
            stats = [
                np.zeros((0, 1), np.int32),
                np.zeros((0, 1), np.float32),
                np.zeros((0, 1), np.float32),
                np.zeros((0, 1), bool),
                np.zeros((0, 1), bool),
            ]
        return ViterbiResult(
            graph=self._graph,
            cfg=self._cfg,
            scores=scores,
            lengths=np.array([T], np.int32),
            bp_init=self._bp_init,
            bp_emit=bp_emit,
            bp_eps=bp_eps,
            frontier_states=self._state.states.cpu().numpy(),
            frontier_costs=(self._state.base[:, None] + self._state.costs).cpu().numpy(),
            num_active=stats[0],
            best_costs=stats[1],
            cutoffs=stats[2],
            overflows=stats[3],
            saturations=stats[4],
        )


class SimpleDecoder(_StreamingViterbi):
    """Beam-only Viterbi decoder (`simple-decoder.h:24-134` parity).

    ``decode`` returns True if any token survived (simple-decoder.cc:24-28).
    """

    def __init__(self, fst, beam: float, *, device):
        super().__init__(
            fst,
            FrontierConfig(),
            device=device,
            beam=float(beam),
            max_active=INT32_MAX,
            min_active=0,
        )
        self.beam = float(beam)

    def decode(self, decodable: DecodableInterface) -> bool:
        self.init_decoding()
        self.advance_decoding(decodable)
        return bool(torch.isfinite(self._state.costs).any())


class FasterDecoder(_StreamingViterbi):
    """Adaptive-beam/max-active decoder (`faster-decoder.h:65-200` parity)."""

    def __init__(self, fst, config: Optional[FasterDecoderOptions] = None, *, device):
        config = config or FasterDecoderOptions()
        self._validate_options(config)
        self._options = config
        super().__init__(
            fst,
            FrontierConfig(),
            device=device,
            beam=config.beam,
            max_active=config.max_active,
            min_active=config.min_active,
            beam_delta=config.beam_delta,
        )

    @staticmethod
    def _validate_options(config: FasterDecoderOptions) -> None:
        # faster-decoder.cc:24-30 constructor checks.
        if config.hash_ratio < 1.0:
            raise ValueError("hash_ratio must be >= 1.0")
        if config.max_active <= 1:
            raise ValueError("max_active must be > 1")
        if not (0 <= config.min_active < config.max_active):
            raise ValueError("need 0 <= min_active < max_active")

    def set_options(self, config: FasterDecoderOptions) -> None:
        """SetOptions parity (`faster-decoder.h:78`): new beam settings
        with the capacities kept, so a mid-utterance change keeps the
        decoded state, like the C++."""
        self._validate_options(config)
        self._options = config
        self._cfg = config_for_graph(
            self._graph,
            base=self._cfg,
            beam=config.beam,
            max_active=config.max_active,
            min_active=config.min_active,
            beam_delta=config.beam_delta,
            frontier_size=self._cfg.frontier_size,
            block_width=self._cfg.block_width,
            rem_budget=self._cfg.rem_budget,
            eps_block_width=self._cfg.eps_block_width,
            eps_rem_budget=self._cfg.eps_rem_budget,
            eps_iters=self._cfg.eps_iters,
        )

    @property
    def options(self) -> FasterDecoderOptions:
        return self._options
