"""Batched Viterbi decoder (the FasterDecoder capability) on a device.

The torch counterpart of ``kaldi_decoder_tpu/decoders/viterbi.py``
(``_batched_init``, ``_maybe_fold``, ``ViterbiResult``,
``BatchedViterbiDecoder``).  A Python loop over frames advances B
utterances in lockstep; each frame runs
:func:`kaldi_decoder_tpu_torch.decoders.frontier.frame_step_batched`
(GetCutoff, the row gather and K1, K6 and the backpointer gather, the eps
closure, the rebase).  Per-frame backpointers ``(prev_slot, arc_id)`` stay
on the device and are downloaded once; the host walks them backwards with
the C++ backtrace of the host library, exactly like the reference's
``Token::prev_`` chain walk (`kaldi-decoder/csrc/faster-decoder.cc:356-424`)
including the (graph_cost, acoustic_cost) split per arc and the
final-prob preference rules, and finishes with RemoveEpsLocal
(`faster-decoder.cc:422`).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepOut,
    StepState,
    _cfg_for_device_graph,
    _folded_init,
    frame_step_batched,
    init_closure,
)
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.fst.fst import INF, Lattice
from kaldi_decoder_tpu_torch.fst.ops import remove_eps_local
from kaldi_decoder_tpu_torch.fst.pack import PackedGraph, pack_graph_device
from kaldi_decoder_tpu_torch.parallel.mesh import (
    all_gather_object,
    batch_sharding,
    check_device,
    local_batch,
)
from kaldi_decoder_tpu_torch.utils.logging import DecodeStats
from kaldi_decoder_tpu_torch.utils.profiling import WallTimer, annotate

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def viterbi_chunk(
    pg: PackedGraph,
    scores_tm: torch.Tensor,  # (T, B, V) time-major
    lengths: torch.Tensor,  # (B,) int32 — frames t >= lengths are no-ops
    st0: StepState,
    cfg: FrontierConfig,
    num_states: int,
) -> Tuple[StepState, StepOut]:
    """T frames from ``st0`` (the original's jitted ``lax.scan``).
    Returns the final state and the per-frame outputs stacked (T, B, ...)."""
    T = scores_tm.shape[0]
    st = st0
    outs = None
    for t in range(T):
        st, o = frame_step_batched(st, scores_tm[t], lengths > t, pg, cfg, num_states)
        if outs is None:
            outs = StepOut(
                *(torch.empty((T,) + x.shape, dtype=x.dtype, device=x.device) for x in o)
            )
        for buf, x in zip(outs, o):
            buf[t].copy_(x)
    return st, outs


def _batched_init(pg, graph: CsrGraph, cfg: FrontierConfig, batch: int, device):
    """Initial frontier (start state + eps closure) broadcast over B, and
    the closure's backpointers (D, K, 2) on the host."""
    st, bp_init = init_closure(pg, graph.start_state, graph.num_states, cfg, device)
    stb = StepState(
        states=st.states.expand(batch, -1).contiguous(),
        costs=st.costs.expand(batch, -1).contiguous(),
        base=st.base.expand(batch).contiguous(),
    )
    return stb, bp_init.cpu().numpy()


def _maybe_fold(graph: CsrGraph, fold: bool):
    """Eps precomposition when possible (acyclic, nonneg, bounded)."""
    if not fold or not graph.has_eps:
        return None
    return fold_eps(graph)


@dataclasses.dataclass
class ViterbiResult:
    """Host-side decode result for a batch (numpy).

    Backpointer layout per utterance: the init closure's (D, K, 2) block,
    then per frame an emitting (K, 2) block and a (D, K, 2) eps block.

    With ``fold`` set (eps-precomposed decode, :mod:`kaldi_decoder_tpu_torch.fst.fold`),
    D == 0, arcs in ``bp_emit`` are folded ids, and ``graph`` is the
    ORIGINAL graph: the backtrace expands each folded arc into its
    original arc path.
    """

    graph: CsrGraph
    cfg: FrontierConfig
    scores: np.ndarray  # (B, T, V) float32 (unpadded view)
    lengths: np.ndarray  # (B,) int32
    bp_init: np.ndarray  # (D, K, 2)
    bp_emit: np.ndarray  # (T, B, K, 2)
    bp_eps: np.ndarray  # (T, B, D, K, 2)
    frontier_states: np.ndarray  # (B, K) int32
    frontier_costs: np.ndarray  # (B, K) float32, absolute
    num_active: np.ndarray  # (T, B)
    best_costs: np.ndarray  # (T, B) absolute best cost per frame
    cutoffs: np.ndarray  # (T, B)
    overflows: np.ndarray  # (T, B) bool
    saturations: np.ndarray  # (T, B) bool — frontier capacity hit
    fold: object = None  # Optional[FoldedGraph]
    # Wall-clock seconds of the batch device decode incl. the download of
    # bp_emit (the other downloads happen outside the timer).
    wall_seconds: float = 0.0

    @property
    def batch_size(self) -> int:
        return self.scores.shape[0]

    # -- final-frame semantics (faster-decoder.cc:347-390) -------------------

    def _final_costs(self, b: int) -> np.ndarray:
        return self.graph.arrays.final_cost[self.frontier_states[b]]

    def reached_final(self, b: int = 0) -> bool:
        costs = self.frontier_costs[b]
        return bool(np.any(np.isfinite(costs) & np.isfinite(self._final_costs(b))))

    def final_relative_cost(self, b: int = 0) -> float:
        """simple-decoder.cc:78-100 semantics (INF when nothing survived)."""
        costs = self.frontier_costs[b]
        if not np.any(np.isfinite(costs)):
            return INF
        best = float(np.min(costs))
        with np.errstate(invalid="ignore"):
            best_final = float(np.min(costs + self._final_costs(b)))
        extra = best_final - best
        return INF if np.isnan(extra) else extra

    def best_cost(self, b: int = 0, use_final_probs: bool = True) -> float:
        costs = self.frontier_costs[b].copy()
        if use_final_probs and self.reached_final(b):
            costs = costs + self._final_costs(b)
        return float(np.min(costs))

    def _best_slot(self, b: int, use_final_probs: bool) -> Optional[int]:
        costs = self.frontier_costs[b].copy()
        if not np.any(np.isfinite(costs)):
            return None
        if use_final_probs and self.reached_final(b):
            costs = costs + self._final_costs(b)
            if not np.any(np.isfinite(costs)):
                return None
        return int(np.argmin(costs))

    # -- backtrace ------------------------------------------------------------

    def best_path(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        """Best path as a linear lattice (GetBestPath parity,
        `faster-decoder.cc:356-424`), or None if no tokens survived."""
        from kaldi_decoder_tpu_torch import native

        slot = self._best_slot(b, use_final_probs)
        if slot is None:
            return None
        ga = self.graph.arrays
        L = int(self.lengths[b])
        is_final = use_final_probs and self.reached_final(b)
        final_state = int(self.frontier_states[b, slot])

        fwd = native.backtrace(
            slot,
            self.bp_init,
            np.ascontiguousarray(self.bp_emit[:L, b]),
            np.ascontiguousarray(self.bp_eps[:L, b]),
        )
        if fwd is None:
            logger.warning("backtrace hit a dead slot (utt %d)", b)
            return None
        fwd_arcs = [(bool(e[0]), int(e[1]), int(e[2])) for e in fwd]
        if self.fold is not None:
            fwd_arcs = self._expand_folded(fwd_arcs, final_state)

        out = Lattice()
        cur = out.add_state()
        out.set_start(cur)
        for is_eps, arc, t in fwd_arcs:
            nxt = out.add_state()
            if is_eps:
                out.add_arc(
                    cur, 0, int(ga.eps_olabel[arc]), (float(ga.eps_weight[arc]), 0.0), nxt
                )
            else:
                g = float(ga.em_weight[arc])
                ac = -float(self.scores[b, t, int(ga.em_score_idx[arc])])
                out.add_arc(
                    cur, int(ga.em_ilabel[arc]), int(ga.em_olabel[arc]), (g, ac), nxt
                )
            cur = nxt
        if is_final:
            out.set_final(cur, (float(ga.final_cost[final_state]), 0.0))
        else:
            out.set_final(cur, (0.0, 0.0))
        return remove_eps_local(out)

    def _expand_folded(self, fwd_arcs, final_state: int):
        """Map folded arc ids back to original-arc sequences and prepend
        the start state's eps path (see fst/fold.py)."""
        f = self.fold
        orig = f.orig.arrays
        out = []
        # Initial eps path: from start to the first emitting arc's source
        # state (or to the final state when no frames were decoded).
        if fwd_arcs:
            first_em = f.em_arc_of(np.int64(fwd_arcs[0][1]))
            s0 = int(np.searchsorted(orig.em_row_ptr, int(first_em), side="right") - 1)
        else:
            s0 = final_state
        where = np.flatnonzero(f.start.states == s0)
        if len(where):
            for a in f.start.paths[int(where[0])]:
                out.append((True, int(a), -1))
        for is_eps, arc, t in fwd_arcs:
            assert not is_eps, "folded decode emits no device eps arcs"
            lo, hi = int(f.path_ptr[arc]), int(f.path_ptr[arc + 1])
            out.append((False, int(f.path_arcs[lo]), t))
            for a in f.path_arcs[lo + 1 : hi]:
                out.append((True, int(a), t))
        return out

    def stats(self, b: int = 0) -> DecodeStats:
        L = int(self.lengths[b])
        return DecodeStats(
            num_frames=L,
            active_per_frame=self.num_active[:L, b],
            best_cost_per_frame=self.best_costs[:L, b],
            cutoff_per_frame=self.cutoffs[:L, b],
            arc_budget_overflows=int(np.sum(self.overflows[:L, b])),
            frontier_saturated_frames=int(np.sum(self.saturations[:L, b])),
            wall_seconds=self.wall_seconds,
            batch_frames=int(np.sum(self.lengths)),
        )


class BatchedViterbiDecoder:
    """Best-path WFST decoder over a device-resident graph: the
    reference's ``FasterDecoder`` (`faster-decoder.h:65-200`) with
    utterance batching.  Construct once per graph; ``decode`` accepts
    ``(T, V)`` or ``(B, T, V)`` log-prob arrays.

    With ``fold`` the eps arcs of an acyclic, non-negative eps subgraph are
    folded into the emitting arcs on the host, and the device graph is
    eps-free; otherwise the device runs the eps closure every frame.

    With ``mesh`` (a :func:`kaldi_decoder_tpu_torch.parallel.make_mesh`
    mesh, every rank of it constructing the decoder and calling ``decode``
    with the same arguments) the batch is padded to a multiple of the
    mesh's size and split over its ``data_axis`` dimension: each rank
    decodes its rows on ``device`` with the whole graph, with no
    collective in the frame loop, and the downloaded results are gathered,
    so that every rank's result holds every row."""

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        pad_time_to: int = 128,
        mesh=None,
        data_axis: str = "data",
        fold: bool = True,
        *,
        device,
    ):
        if not isinstance(graph, CsrGraph):
            raise TypeError(f"expected a kaldi_decoder_tpu_torch CsrGraph, got {type(graph)!r}")
        self.device = torch.device(device)
        self.mesh = mesh
        self._rows = None
        self._batch_multiple = 1
        if mesh is not None:
            self.device = check_device(mesh, device)
            self._rows = batch_sharding(mesh, data_axis)
            self._batch_multiple = mesh.size()
        self.graph = graph
        self.fold = _maybe_fold(graph, fold)
        dev_graph = self.fold.device if self.fold is not None else graph
        self._dev_graph = dev_graph
        self.cfg = _cfg_for_device_graph(dev_graph, config)
        self.pad_time_to = pad_time_to
        self._pg = pack_graph_device(
            dev_graph, self.cfg.block_width, self.cfg.eps_block_width,
            self.cfg.flat_group, self.device,
        )

    def _init(self, batch: int):
        """Initial frontier (B, K) and the init closure's backpointers."""
        if self.fold is not None:
            st = _folded_init(self.fold, self.cfg, batch, self.device)
            return st, np.zeros((0, self.cfg.frontier_size, 2), np.int32)
        return _batched_init(self._pg, self.graph, self.cfg, batch, self.device)

    def decode(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
    ) -> ViterbiResult:
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if self.graph.max_score_idx >= V:
            raise ValueError(
                f"graph references score index {self.graph.max_score_idx} but "
                f"scores have only {V} columns (graph ilabels are 1-based: "
                f"need V >= max ilabel - 1; decodable-ctc.cc:22-29)"
            )
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)

        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        scores_tm, lengths_p = local_batch(scores, lengths, Tp, self._rows, self._batch_multiple)

        st0, bp_init = self._init(lengths_p.shape[0])
        with WallTimer() as timer, annotate("kdtpu.viterbi_decode", device=self.device):
            stf, outs = viterbi_chunk(
                self._pg,
                torch.from_numpy(scores_tm).to(self.device),
                torch.from_numpy(lengths_p).to(self.device),
                st0, self.cfg, self._dev_graph.num_states,
            )
            # The download doubles as the device sync; keep it in the timer.
            bp_emit = outs.bp_emit.cpu().numpy()
        out = dict(
            bp_emit=bp_emit,
            bp_eps=outs.bp_eps.cpu().numpy(),
            frontier_states=stf.states.cpu().numpy(),
            frontier_costs=(stf.base[:, None] + stf.costs).cpu().numpy(),
            num_active=outs.num_active.cpu().numpy(),
            best_costs=outs.best_cost.cpu().numpy(),
            cutoffs=outs.cutoff.cpu().numpy(),
            overflows=outs.overflow.cpu().numpy(),
            saturations=outs.saturated.cpu().numpy(),
        )
        if self._rows is not None:
            # Every rank's rows: the frontiers are (B, K), the rest (T, B, ...).
            parts = all_gather_object(out, self._rows.group)
            out = {k: np.concatenate([p[k] for p in parts],
                                     axis=0 if k in ("frontier_states", "frontier_costs") else 1)
                   for k in out}
        return ViterbiResult(
            graph=self.graph,
            cfg=self.cfg,
            scores=scores,
            lengths=lengths,
            bp_init=bp_init,
            fold=self.fold,
            wall_seconds=timer.elapsed,
            **out,
        )
