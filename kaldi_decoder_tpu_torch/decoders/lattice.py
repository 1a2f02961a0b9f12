"""Batched lattice decoder: the device frame loop, the sweep, the host finalize.

The torch counterpart of ``BatchedLatticeDecoder``, ``PendingDecode`` and
the host class ``LatticeResult`` of ``kaldi_decoder_tpu/decoders/lattice.py``,
for graphs whose device side is eps-free (every eps-folded HLG).  Per
chunk of frames: the forward frame loop
(:func:`kaldi_decoder_tpu_torch.decoders.lattice_dev.lattice_chunk`), then
with ``device_prune`` the backward sweep K4
(:func:`kaldi_decoder_tpu_torch.kernels.sweep.sweep_chunk`).  The result
then downloads the three survivor counts of each chunk in one small copy,
and exactly that many rows of each survivor buffer.  A sweep overflow
falls back to ``device_prune=False`` on the same device, which downloads
every record and prunes on the host.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    _cfg_for_device_graph,
    _folded_init,
    start_frontier,
)
from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
    LatticeDevConfig,
    LatticeStepOut,
    lattice_chunk,
    lattice_config_for_graph,
)
from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.fst.pack import pack_graph_device
from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
from kaldi_decoder_tpu_torch.lattice.prune import (
    PrunedLattice,
    flat_arc_arrays,
    prune_lattice,
)

logger = logging.getLogger(__name__)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _merge_tokens(
    frontier_states: np.ndarray,
    frontier_costs: np.ndarray,
    extra_states: np.ndarray,
    extra_alphas: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted-unique union of the device frontier with synthesized tokens;
    frontier alphas win on collision (they are true per-state minima)."""
    ok = np.isfinite(frontier_costs)
    fst_states = frontier_states[ok].astype(np.int64)
    fst_costs = frontier_costs[ok].astype(np.float64)
    states = np.concatenate([fst_states, np.asarray(extra_states, np.int64)])
    costs = np.concatenate([fst_costs, np.asarray(extra_alphas, np.float64)])
    order = np.lexsort((costs, states))
    states, costs = states[order], costs[order]
    first = np.ones(len(states), bool)
    first[1:] = states[1:] != states[:-1]
    return states[first], costs[first]


@dataclasses.dataclass
class LatticeResult:
    """Host-side batched lattice decode result (numpy).

    Full mode (``device_prune=False``) holds every frame's frontier and
    records; swept mode holds only the survivor rows the device sweep kept
    (``survivors``).  Both give the same final lattice."""

    graph: CsrGraph
    cfg: LatticeDevConfig
    lattice_beam: float
    scores: np.ndarray  # (B, T, V)
    lengths: np.ndarray  # (B,)
    init_states: np.ndarray  # (K,)
    init_costs: np.ndarray  # (K,)
    num_active: np.ndarray  # (T, B)
    cutoffs: np.ndarray  # (T, B)
    overflows: np.ndarray  # (T, B)
    saturations: np.ndarray  # (T, B) bool — frontier capacity hit
    frame_states: Optional[np.ndarray] = None  # (T, B, K)
    frame_costs: Optional[np.ndarray] = None  # (T, B, K)
    em_records: Optional[np.ndarray] = None  # (T, B, R_em, 4)
    # Swept mode: per chunk a dict with frame0, tok_rows (B, _, 3),
    # tok_count (B,), em_rows, em_count, overflow (B,).
    survivors: Optional[List[dict]] = None
    fold: object = None  # Optional[FoldedGraph] — records carry folded ids
    wall_seconds: float = 0.0

    def __post_init__(self):
        self._pruned: dict = {}

    @property
    def batch_size(self) -> int:
        return self.scores.shape[0]

    def sweep_overflowed(self, b: int) -> bool:
        """True if the device sweep's survivor buffers overflowed for
        utterance ``b``."""
        if self.survivors is None:
            return False
        return bool(any(np.asarray(c["overflow"])[b] for c in self.survivors))

    def _survivor_frames(self, b: int, L: int):
        """Group survivor rows into per-frame structures: (frame_states
        list (L+1), frame_costs list, em_records list (L))."""
        tok_f = [None] * (L + 1)
        tok_c = [None] * (L + 1)
        em = [np.zeros((0, 2), np.int32) for _ in range(L)]
        tok_f[0] = self.init_states
        tok_c[0] = self.init_costs
        for chunk in self.survivors:
            f0 = chunk["frame0"]
            tr = chunk["tok_rows"][b][: int(chunk["tok_count"][b])]
            if len(tr):
                frames = tr[:, 0]
                alphas = tr[:, 2].view(np.float32)
                order = np.argsort(frames, kind="stable")
                frames, states, alphas = frames[order], tr[order, 1], alphas[order]
                bounds = np.searchsorted(frames, np.arange(frames[0], frames[-1] + 2))
                for i, f in enumerate(range(int(frames[0]), int(frames[-1]) + 1)):
                    gf = f0 + f
                    if gf > L:
                        continue
                    sl = slice(bounds[i], bounds[i + 1])
                    if sl.start == sl.stop:
                        continue
                    # Min-alpha dedup by state (duplicates only after an
                    # overflow clobbered rows).
                    order2 = np.lexsort((alphas[sl], states[sl]))
                    ss, aa = states[sl][order2], alphas[sl][order2]
                    first = np.ones(len(ss), bool)
                    first[1:] = ss[1:] != ss[:-1]
                    tok_f[gf] = ss[first]
                    tok_c[gf] = aa[first]
            er = chunk["em_rows"][b][: int(chunk["em_count"][b])]
            if len(er):
                for t in np.unique(er[:, 0]):
                    gt = f0 + int(t)
                    if gt >= L:
                        continue
                    em[gt] = er[er[:, 0] == t][:, 1:3]
        for f in range(L + 1):
            if tok_f[f] is None:
                tok_f[f] = np.zeros((0,), np.int32)
                tok_c[f] = np.zeros((0,), np.float32)
        return tok_f, tok_c, em

    def _prune(self, b: int, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        key = (b, use_final_probs)
        if key not in self._pruned:
            L = int(self.lengths[b])
            if self.survivors is not None:
                frame_states, frame_costs, em_recs = self._survivor_frames(b, L)
            else:
                frame_states = np.concatenate(
                    [self.init_states[None], self.frame_states[:L, b]], axis=0
                )
                frame_costs = np.concatenate(
                    [self.init_costs[None], self.frame_costs[:L, b]], axis=0
                )
                em_recs = self.em_records[:L, b]
            if self.fold is not None:
                # Expand folded records back to original-graph records,
                # synthesizing eps-intermediate tokens the frontier evicted.
                sc = self.fold.start
                fs: list = [None] * (L + 1)
                fc: list = [None] * (L + 1)
                fs[0], fc[0] = _merge_tokens(
                    frame_states[0], frame_costs[0], sc.states,
                    sc.costs.astype(np.float64),
                )
                em_list, eps_list = [], []
                for t in range(L):
                    em, eps, ts, ta = self.fold.expand_with_alphas(
                        em_recs[t], fs[t], fc[t], self.scores[b, t],
                    )
                    em_list.append(em)
                    eps_list.append(eps)
                    fs[t + 1], fc[t + 1] = _merge_tokens(
                        frame_states[t + 1], frame_costs[t + 1], ts, ta
                    )
                init_eps = sc.eps_records
                em_records, eps_records = em_list, eps_list
                frame_states, frame_costs = fs, fc
            else:
                # The device graph has no eps arcs, so no eps links.
                init_eps = np.zeros((0, 0, 2), np.int32)
                em_records, eps_records = em_recs, [init_eps] * L
            self._pruned[key] = prune_lattice(
                frame_states=frame_states,
                frame_costs=frame_costs,
                init_eps_records=init_eps,
                em_records=em_records,
                eps_records=eps_records,
                scores=self.scores[b, :L],
                graph=self.graph,
                lattice_beam=self.lattice_beam,
                use_final_probs=use_final_probs,
            )
        return self._pruned[key]

    def best_path_labels(
        self, b: int = 0, use_final_probs: bool = True, side: str = "olabel"
    ) -> Optional[list]:
        """1-best label sequence from the pruned lattice's flat arc arrays
        by the C++ ShortestPath (`lattice-simple-decoder.cc:574-580`
        semantics incl. the LatticeWeight tie-break); None when decoding
        failed (no lattice)."""
        from kaldi_decoder_tpu_torch import native

        pl = self._prune(b, use_final_probs)
        if pl is None:
            return None
        flat = flat_arc_arrays(pl, use_final_probs)
        if flat is None:
            return None
        n, src, dst, il, ol, wg, wa, final_graph, start = flat
        path = native.shortest_path_arrays(
            n, src, wg + wa, dst,
            final_graph,  # acoustic final component is 0
            start,
            w_graph=wg,
            final_graph=np.where(np.isfinite(final_graph), final_graph, 0.0).astype(
                np.float32
            ),
        )
        if path is None:
            return None
        labels = (il if side == "ilabel" else ol)[path]
        return [int(x) for x in labels[labels != 0]]


class BatchedLatticeDecoder:
    """Batched lattice-generating decoder over a device-resident graph:
    LatticeSimpleDecoder's lattice generation (`lattice-simple-decoder.cc`)
    with FasterDecoder's adaptive-beam and max-active pruning
    (`faster-decoder.cc:244-336`).

    The device graph must be eps-free: a graph with eps arcs is folded
    (``fold=True``); one that cannot be folded, or ``fold=False`` on a
    graph with eps arcs, raises ``NotImplementedError``."""

    def __init__(
        self,
        graph: CsrGraph,
        frontier: Optional[FrontierConfig] = None,
        lattice_beam: float = 10.0,
        em_records: Optional[int] = None,
        pad_time_to: int = 128,
        fold: bool = True,
        *,
        device,
    ):
        if not isinstance(graph, CsrGraph):
            raise TypeError(f"expected a kaldi_decoder_tpu_torch CsrGraph, got {type(graph)!r}")
        self.device = torch.device(device)
        self.graph = graph
        self.fold = fold_eps(graph) if fold and graph.has_eps else None
        dev_graph = self.fold.device if self.fold is not None else graph
        if dev_graph.has_eps:
            raise NotImplementedError(
                "the device graph keeps eps arcs (cyclic or negative eps, or "
                "fold=False); the lattice decoder's eps path (the eps records "
                "of the closure and the sweep's eps Bellman) is not ported "
                "(ROADMAP Queue 1 item 10)"
            )
        fc = _cfg_for_device_graph(dev_graph, frontier)
        self._dev_graph = dev_graph
        self.lattice_beam = float(lattice_beam)
        self.cfg = lattice_config_for_graph(
            dev_graph, fc, em_records=em_records, lattice_beam=self.lattice_beam
        )
        self.pad_time_to = pad_time_to
        self._pg = pack_graph_device(
            dev_graph, fc.block_width, fc.eps_block_width, fc.flat_group, self.device
        )

    def _init(self, batch: int):
        """Initial frontier (B, K) and its host copies (states, costs)."""
        fc = self.cfg.frontier
        if self.fold is not None:
            st = _folded_init(self.fold, fc, batch, self.device)
        else:
            st = start_frontier(
                np.array([self.graph.start_state], np.int32),
                np.zeros(1, np.float32), fc, batch, self.device,
            )
        return st, st.states[0].cpu().numpy(), st.costs[0].cpu().numpy()

    def decode(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
        chunk_frames: Optional[int] = None,
        device_prune: bool = True,
    ) -> "LatticeResult":
        """Batched lattice decode of (B, T, V) log-probs (or one (T, V)).

        ``chunk_frames``: decode in chunks of that many frames (rounded up
        to ``pad_time_to``; the last chunk is padded).  ``device_prune``:
        run the backward sweep on the device per chunk and download only
        the surviving tokens and links; the final lattice is the same as
        with ``device_prune=False``."""
        return self.decode_async(scores, lengths, chunk_frames, device_prune).result()

    def decode_async(
        self,
        scores: np.ndarray,
        lengths: Optional[np.ndarray] = None,
        chunk_frames: Optional[int] = None,
        device_prune: bool = True,
    ) -> "PendingDecode":
        """Enqueue a batched decode; :meth:`PendingDecode.result`
        downloads and assembles it."""
        scores = np.asarray(scores, dtype=np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, V = scores.shape
        if self.graph.max_score_idx >= V:
            raise ValueError(
                f"graph references score index {self.graph.max_score_idx} but "
                f"scores have only {V} columns"
            )
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)

        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        C = Tp
        if chunk_frames is not None:
            # Whole chunks only: the last chunk is padded, not shortened.
            C = max(_round_up(chunk_frames, self.pad_time_to), 1)
            Tp = _round_up(Tp, C)
        scores_tm = np.zeros((Tp, B, V), np.float32)
        scores_tm[:T] = scores.transpose(1, 0, 2)

        t0 = time.perf_counter()
        st0, init_states, init_costs = self._init(B)
        scores_dev = torch.from_numpy(scores_tm).to(self.device)
        rem = torch.from_numpy(lengths).to(self.device)
        S = self._dev_graph.num_states
        sc = sweep_config(self.cfg, C) if device_prune else None
        stc = st0
        chunks = []
        for lo in range(0, Tp, C):
            chunk_init = stc.states
            stc, o = lattice_chunk(self._pg, scores_dev[lo : lo + C], rem, stc, self.cfg, S)
            sw = None
            if device_prune:
                sw = sweep_chunk(
                    o.frontier_states, o.frontier_costs, o.em_records,
                    chunk_init, rem, sc, S,
                )
                # The sweep consumed the big per-frame buffers; keep the
                # small per-frame stats only.
                o = o._replace(em_records=None, frontier_states=None, frontier_costs=None)
            else:
                # Full-record mode: fetch each chunk as it is produced, so
                # device memory holds one chunk's buffers at a time.
                o = LatticeStepOut(*(x.cpu().numpy() for x in o))
            rem = (rem - C).clamp(min=0)
            chunks.append((lo, o, sw))
        return PendingDecode(
            decoder=self,
            scores=scores,
            lengths=lengths,
            chunk_frames=chunk_frames,
            device_prune=device_prune,
            chunks=chunks,
            init_states=init_states,
            init_costs=init_costs,
            t0=t0,
        )

    def _finish(self, pending: "PendingDecode") -> LatticeResult:
        chunks = pending.chunks
        survivors = None
        frame_states = frame_costs = em_records = None
        if pending.device_prune:
            survivors = []
            for lo, o, sw in chunks:
                counts = torch.stack(
                    [sw.tok_count, sw.em_count, sw.overflow.to(torch.int32)]
                ).cpu().numpy()
                tc, ec, ovf = counts
                survivors.append(
                    {
                        "frame0": lo,
                        "tok_rows": sw.tok_rows[:, : int(tc.max())].cpu().numpy(),
                        "tok_count": tc,
                        "em_rows": sw.em_rows[:, : int(ec.max())].cpu().numpy(),
                        "em_count": ec,
                        "overflow": ovf.astype(bool),
                    }
                )
            if any(c["overflow"].any() for c in survivors):
                # The windowed sweep kept more than its buffers hold: take
                # the full records and prune on the host instead.
                logger.warning(
                    "device sweep survivor buffers overflowed; "
                    "falling back to full host pruning"
                )
                return self.decode(
                    pending.scores, pending.lengths,
                    chunk_frames=pending.chunk_frames, device_prune=False,
                )
            stats = [
                [x.cpu().numpy() for x in (o.num_active, o.cutoff, o.overflow, o.saturated)]
                for _, o, _ in chunks
            ]
        else:
            outs = LatticeStepOut(
                *(
                    np.concatenate([o[i] for _, o, _ in chunks], axis=0)
                    for i in range(len(LatticeStepOut._fields))
                )
            )
            frame_states, frame_costs = outs.frontier_states, outs.frontier_costs
            em_records = outs.em_records
            stats = [[outs.num_active, outs.cutoff, outs.overflow, outs.saturated]]
        num_active, cutoffs, overflows, saturations = (
            np.concatenate([s[i] for s in stats], axis=0) for i in range(4)
        )
        return LatticeResult(
            graph=self.graph,
            cfg=self.cfg,
            lattice_beam=self.lattice_beam,
            scores=pending.scores,
            lengths=pending.lengths,
            init_states=pending.init_states,
            init_costs=pending.init_costs,
            frame_states=frame_states,
            frame_costs=frame_costs,
            em_records=em_records,
            survivors=survivors,
            num_active=num_active,
            cutoffs=cutoffs,
            overflows=overflows,
            saturations=saturations,
            fold=self.fold,
            wall_seconds=time.perf_counter() - pending.t0,
        )


@dataclasses.dataclass
class PendingDecode:
    """An enqueued batched decode; ``result()`` downloads and assembles it."""

    decoder: BatchedLatticeDecoder
    scores: np.ndarray
    lengths: np.ndarray
    chunk_frames: Optional[int]
    device_prune: bool
    chunks: list
    init_states: np.ndarray
    init_costs: np.ndarray
    t0: float

    def result(self) -> LatticeResult:
        return self.decoder._finish(self)
