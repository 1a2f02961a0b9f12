"""Lattice decoder API: the batched decoder and the reference's streaming classes.

The torch counterpart of ``kaldi_decoder_tpu/decoders/lattice.py``:

* :class:`BatchedLatticeDecoder` (with ``PendingDecode`` and the host
  result :class:`LatticeResult`): per chunk of frames, the forward frame
  loop (:func:`kaldi_decoder_tpu_torch.decoders.lattice_dev.lattice_chunk`),
  then with ``device_prune`` the backward sweep K4
  (:func:`kaldi_decoder_tpu_torch.kernels.sweep.sweep_chunk`).  The result
  downloads the survivor counts of each chunk in one small copy, and
  exactly that many rows of each survivor buffer.  A sweep overflow falls
  back to ``device_prune=False`` on the same device, which downloads every
  record and prunes on the host.  A graph with eps arcs is folded to an
  eps-free device graph unless ``fold=False`` or it cannot be folded (cyclic
  or negative eps); then the device keeps the eps arcs and runs the
  record-emitting eps closure every frame, the start closure, and the
  sweep's eps Bellman.
* :class:`LatticeSimpleDecoder` + :class:`LatticeSimpleDecoderConfig`
  (`kaldi-decoder/python/csrc/lattice-simple-decoder.cc:11-68`) and
  :class:`LatticeFasterDecoder` + :class:`LatticeFasterDecoderConfig`
  (the fields of `lattice-faster-decoder.h:23-134`): B = 1 on the graph as
  given, each ``advance_decoding`` chunk folded into an
  :class:`~kaldi_decoder_tpu_torch.lattice.prune.IncrementalLattice`,
  pruned every ``prune_interval`` frames.  Each call runs exactly the new
  frames (the original pads them to 64; the results are the same).

Every constructor takes the required ``device=`` keyword.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decodable import DecodableInterface, scores_from_decodable
from kaldi_decoder_tpu_torch.decoders.api import _as_graph
from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepState,
    _cfg_for_device_graph,
    _folded_init,
    config_for_graph,
)
from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
    REC_COLS,
    LatticeDevConfig,
    LatticeStepOut,
    init_closure_rec,
    lattice_chunk,
    lattice_config_for_graph,
)
from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.fst.fst import INF, Lattice
from kaldi_decoder_tpu_torch.fst.ops import shortest_path
from kaldi_decoder_tpu_torch.fst.pack import pack_graph_device
from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
from kaldi_decoder_tpu_torch.parallel.mesh import (
    all_gather_object,
    batch_sharding,
    check_device,
    concat_parts,
    local_batch,
)
from kaldi_decoder_tpu_torch.lattice.prune import (
    IncrementalLattice,
    PrunedLattice,
    flat_arc_arrays,
    prune_lattice,
    raw_lattice_to_fst,
)
from kaldi_decoder_tpu_torch.utils.logging import DecodeStats
from kaldi_decoder_tpu_torch.utils.profiling import annotate

logger = logging.getLogger(__name__)

INT32_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# Configs (reference field names and defaults)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LatticeSimpleDecoderConfig:
    """lattice-simple-decoder.h:24-84 parity."""

    beam: float = 16.0
    lattice_beam: float = 10.0
    prune_interval: int = 25
    determinize_lattice: bool = True
    prune_lattice: bool = True
    beam_ratio: float = 0.9
    prune_scale: float = 0.1

    def check(self) -> None:
        if not (self.beam > 0 and self.lattice_beam > 0 and self.prune_interval > 0):
            raise ValueError("need beam > 0, lattice_beam > 0, prune_interval > 0")

    def __str__(self) -> str:
        return (
            f"LatticeSimpleDecoderConfig(beam={self.beam:g}, "
            f"lattice_beam={self.lattice_beam:g}, "
            f"prune_interval={self.prune_interval}, "
            f"determinize_lattice={self.determinize_lattice}, "
            f"prune_lattice={self.prune_lattice}, "
            f"beam_ratio={self.beam_ratio:g}, prune_scale={self.prune_scale:g})"
        )


@dataclasses.dataclass
class LatticeFasterDecoderConfig:
    """lattice-faster-decoder.h:23-134 parity (the memory-pool block sizes
    are accepted for compatibility; the decoder has no token pools)."""

    beam: float = 16.0
    max_active: int = INT32_MAX
    min_active: int = 200
    lattice_beam: float = 10.0
    prune_interval: int = 25
    determinize_lattice: bool = True
    beam_delta: float = 0.5
    hash_ratio: float = 2.0
    prune_scale: float = 0.1
    memory_pool_tokens_block_size: int = 256
    memory_pool_links_block_size: int = 256

    def check(self) -> None:
        # lattice-faster-decoder.h:120-127 Check().
        if not (
            self.beam > 0.0
            and self.max_active > 1
            and self.lattice_beam > 0.0
            and self.min_active <= self.max_active
            and self.prune_interval > 0
            and self.beam_delta > 0.0
            and self.hash_ratio >= 1.0
            and self.prune_scale > 0.0
            and self.prune_scale < 1.0
        ):
            raise ValueError("invalid LatticeFasterDecoderConfig")

    def __str__(self) -> str:
        return (
            f"LatticeFasterDecoderConfig(beam={self.beam:g}, "
            f"max_active={self.max_active}, min_active={self.min_active}, "
            f"lattice_beam={self.lattice_beam:g}, "
            f"prune_interval={self.prune_interval}, "
            f"determinize_lattice={self.determinize_lattice}, "
            f"beam_delta={self.beam_delta:g}, hash_ratio={self.hash_ratio:g}, "
            f"prune_scale={self.prune_scale:g})"
        )


# ---------------------------------------------------------------------------
# Batched decoder
# ---------------------------------------------------------------------------


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
    init_eps_records: np.ndarray  # (D, R_eps, 4) records of the start closure
    num_active: np.ndarray  # (T, B)
    cutoffs: np.ndarray  # (T, B)
    overflows: np.ndarray  # (T, B)
    saturations: np.ndarray  # (T, B) bool — frontier capacity hit
    frame_states: Optional[np.ndarray] = None  # (T, B, K)
    frame_costs: Optional[np.ndarray] = None  # (T, B, K)
    em_records: Optional[np.ndarray] = None  # (T, B, R_em, 4)
    eps_records: Optional[np.ndarray] = None  # (T, B, D, R_eps, 4)
    # Swept mode: per chunk a dict with frame0, tok_rows (B, _, 3),
    # tok_count (B,), em_rows, em_count, eps_rows, eps_count, overflow (B,).
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
        list (L+1), frame_costs list, em_records list (L), eps_records list
        (L))."""
        tok_f = [None] * (L + 1)
        tok_c = [None] * (L + 1)
        em = [np.zeros((0, 2), np.int32) for _ in range(L)]
        eps = [np.zeros((1, 0, 2), np.int32) for _ in range(L)]
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
            zr = chunk["eps_rows"][b][: int(chunk["eps_count"][b])]
            if len(zr):
                for f in np.unique(zr[:, 0]):
                    gf = f0 + int(f)
                    if gf > L or gf < 1:
                        continue
                    eps[gf - 1] = zr[zr[:, 0] == f][None, :, 1:3]
        for f in range(L + 1):
            if tok_f[f] is None:
                tok_f[f] = np.zeros((0,), np.int32)
                tok_c[f] = np.zeros((0,), np.float32)
        return tok_f, tok_c, em, eps

    def _prune(self, b: int, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        key = (b, use_final_probs)
        if key not in self._pruned:
            L = int(self.lengths[b])
            if self.survivors is not None:
                frame_states, frame_costs, em_recs, eps_recs = self._survivor_frames(b, L)
            else:
                frame_states = np.concatenate(
                    [self.init_states[None], self.frame_states[:L, b]], axis=0
                )
                frame_costs = np.concatenate(
                    [self.init_costs[None], self.frame_costs[:L, b]], axis=0
                )
                em_recs = self.em_records[:L, b]
                eps_recs = self.eps_records[:L, b]
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
                init_eps = self.init_eps_records
                em_records, eps_records = em_recs, eps_recs
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

    def raw_lattice(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        """GetRawLattice (`lattice-simple-decoder.cc:584-657`); None when
        decoding failed."""
        pl = self._prune(b, use_final_probs)
        if pl is None:
            return None
        return raw_lattice_to_fst(pl, use_final_probs)

    def best_path(self, b: int = 0, use_final_probs: bool = True) -> Optional[Lattice]:
        """GetBestPath == ShortestPath(GetRawLattice)
        (`lattice-simple-decoder.cc:574-580`)."""
        lat = self.raw_lattice(b, use_final_probs)
        if lat is None:
            return None
        sp = shortest_path(lat)
        return sp if sp.num_states > 0 else None

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

    def reached_final(self, b: int = 0) -> bool:
        pl = self._prune(b)
        return pl is not None and np.isfinite(pl.final_relative_cost)

    def final_relative_cost(self, b: int = 0) -> float:
        pl = self._prune(b)
        return INF if pl is None else pl.final_relative_cost

    def stats(self, b: int = 0) -> DecodeStats:
        L = int(self.lengths[b])
        return DecodeStats(
            num_frames=L,
            active_per_frame=self.num_active[:L, b],
            cutoff_per_frame=self.cutoffs[:L, b],
            arc_budget_overflows=int(np.sum(self.overflows[:L, b])),
            frontier_saturated_frames=int(np.sum(self.saturations[:L, b])),
            wall_seconds=self.wall_seconds,
            batch_frames=int(np.sum(self.lengths)),
        )


class BatchedLatticeDecoder:
    """Batched lattice-generating decoder over a device-resident graph:
    LatticeSimpleDecoder's lattice generation (`lattice-simple-decoder.cc`)
    with FasterDecoder's adaptive-beam and max-active pruning
    (`faster-decoder.cc:244-336`).

    ``graph`` is a ``CsrGraph`` or a ``StdVectorFst``, which is compiled.
    A graph with eps arcs is folded to an eps-free device graph
    (``fold=True``, where it can be folded); otherwise the device keeps the
    eps arcs and runs the eps path.

    With ``mesh`` (a :func:`kaldi_decoder_tpu_torch.parallel.make_mesh`
    mesh, every rank of it constructing the decoder and decoding the same
    batch) the batch is padded to a multiple of the mesh's size and split
    over its ``data_axis`` dimension: each rank decodes its rows on
    ``device`` with the whole graph, with no collective in the frame loop,
    and the downloaded results are gathered, so that every rank's result
    holds every row."""

    def __init__(
        self,
        graph,
        frontier: Optional[FrontierConfig] = None,
        lattice_beam: float = 10.0,
        em_records: Optional[int] = None,
        eps_records: Optional[int] = None,
        pad_time_to: int = 128,
        mesh=None,
        data_axis: str = "data",
        fold: bool = True,
        *,
        device,
    ):
        self.device = torch.device(device)
        self.mesh = mesh
        self._rows = None
        self._batch_multiple = 1
        if mesh is not None:
            self.device = check_device(mesh, device)
            self._rows = batch_sharding(mesh, data_axis)
            self._batch_multiple = mesh.size()
        graph = _as_graph(graph)
        self.graph = graph
        self.fold = fold_eps(graph) if fold and graph.has_eps else None
        dev_graph = self.fold.device if self.fold is not None else graph
        fc = _cfg_for_device_graph(dev_graph, frontier)
        self._dev_graph = dev_graph
        self.lattice_beam = float(lattice_beam)
        self.cfg = lattice_config_for_graph(
            dev_graph, fc, em_records=em_records, eps_records=eps_records,
            lattice_beam=self.lattice_beam,
        )
        self.pad_time_to = pad_time_to
        self._pg = pack_graph_device(
            dev_graph, fc.block_width, fc.eps_block_width, fc.flat_group, self.device
        )
        self._init_cache: dict = {}

    def _init(self, batch: int):
        """Initial frontier (B, K), its host copies (states, costs) and the
        start closure's records (D, R_eps, 4); kept per batch size."""
        cached = self._init_cache.get(batch)
        if cached is None:
            cached = self._init_cache[batch] = self._init_uncached(batch)
        return cached

    def _init_uncached(self, batch: int):
        fc = self.cfg.frontier
        if self.fold is not None:
            st = _folded_init(self.fold, fc, batch, self.device)
            recs = np.full((fc.eps_iters, self.cfg.eps_records, REC_COLS), -1, np.int32)
            return st, st.states[0].cpu().numpy(), st.costs[0].cpu().numpy(), recs
        st1, recs = init_closure_rec(
            self._pg, self.graph.start_state, self.graph.num_states, self.cfg, self.device
        )
        K = fc.frontier_size
        st = StepState(
            states=st1.states.expand(batch, K).contiguous(),
            costs=st1.costs.expand(batch, K).contiguous(),
            base=st1.base.expand(batch).contiguous(),
        )
        return st, st1.states[0].cpu().numpy(), st1.costs[0].cpu().numpy(), recs.cpu().numpy()

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
        scores_tm, lengths_p = local_batch(scores, lengths, Tp, self._rows, self._batch_multiple)

        t0 = time.perf_counter()
        st0, init_states, init_costs, init_recs = self._init(scores_tm.shape[1])
        scores_dev = torch.from_numpy(scores_tm).to(self.device)
        rem = torch.from_numpy(lengths_p).to(self.device)
        S = self._dev_graph.num_states
        sc = sweep_config(self.cfg, C) if device_prune else None
        eps = self.cfg.frontier.eps_iters > 0
        stc = st0
        chunks = []
        with annotate("kdtpu.lattice_decode", device=self.device):
            for lo in range(0, Tp, C):
                chunk_init = stc.states
                stc, o = lattice_chunk(self._pg, scores_dev[lo : lo + C], rem, stc, self.cfg, S)
                sw = None
                if device_prune:
                    sw = sweep_chunk(
                        o.frontier_states, o.frontier_costs, o.em_records,
                        chunk_init, rem, sc, S, o.eps_records if eps else None,
                    )
                    # The sweep consumed the big per-frame buffers; keep the
                    # small per-frame stats only.
                    o = o._replace(em_records=None, eps_records=None, frontier_states=None,
                                   frontier_costs=None)
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
            init_recs=init_recs,
            t0=t0,
        )

    def _finish(self, pending: "PendingDecode") -> LatticeResult:
        chunks = pending.chunks
        survivors = None
        frame_states = frame_costs = em_records = eps_records = None
        if pending.device_prune:
            survivors = []
            for lo, o, sw in chunks:
                counts = torch.stack(
                    [sw.tok_count, sw.em_count, sw.eps_count, sw.overflow.to(torch.int32)]
                ).cpu().numpy()
                tc, ec, zc, ovf = counts
                survivors.append(
                    {
                        "frame0": lo,
                        "tok_rows": sw.tok_rows[:, : int(tc.max())].cpu().numpy(),
                        "tok_count": tc,
                        "em_rows": sw.em_rows[:, : int(ec.max())].cpu().numpy(),
                        "em_count": ec,
                        "eps_rows": sw.eps_rows[:, : int(zc.max())].cpu().numpy(),
                        "eps_count": zc,
                        "overflow": ovf.astype(bool),
                    }
                )
            stats = [
                [x.cpu().numpy() for x in (o.num_active, o.cutoff, o.overflow, o.saturated)]
                for _, o, _ in chunks
            ]
            if self._rows is not None:
                survivors, stats = self._gather_swept(survivors, stats)
            if any(c["overflow"].any() for c in survivors):
                # The windowed sweep kept more than its buffers hold (or a
                # frame's eps Bellman had not settled at its bound): take
                # the full records and prune on the host instead.
                logger.warning(
                    "device sweep survivor buffers overflowed; "
                    "falling back to full host pruning"
                )
                return self.decode(
                    pending.scores, pending.lengths,
                    chunk_frames=pending.chunk_frames, device_prune=False,
                )
        else:
            outs = LatticeStepOut(
                *(
                    np.concatenate([o[i] for _, o, _ in chunks], axis=0)
                    for i in range(len(LatticeStepOut._fields))
                )
            )
            if self._rows is not None:
                parts = all_gather_object(outs, self._rows.group)
                outs = LatticeStepOut(*(np.concatenate(f, axis=1) for f in zip(*parts)))
            frame_states, frame_costs = outs.frontier_states, outs.frontier_costs
            em_records, eps_records = outs.em_records, outs.eps_records
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
            init_eps_records=pending.init_recs,
            frame_states=frame_states,
            frame_costs=frame_costs,
            em_records=em_records,
            eps_records=eps_records,
            survivors=survivors,
            num_active=num_active,
            cutoffs=cutoffs,
            overflows=overflows,
            saturations=saturations,
            fold=self.fold,
            wall_seconds=time.perf_counter() - pending.t0,
        )

    def _gather_swept(self, survivors, stats):
        """Every rank's survivor chunks and per-frame stats, rows in rank
        order (row buffers padded with -1 past their counts)."""
        parts = all_gather_object((survivors, stats), self._rows.group)
        merged = []
        for i, chunk in enumerate(survivors):
            c = {k: concat_parts([p[0][i][k] for p in parts], axis=0)
                 for k in chunk if k != "frame0"}
            merged.append(dict(c, frame0=chunk["frame0"]))
        stats = [[np.concatenate([p[1][i][j] for p in parts], axis=1) for j in range(4)]
                 for i in range(len(stats))]
        return merged, stats


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
    init_recs: np.ndarray
    t0: float

    def result(self) -> LatticeResult:
        return self.decoder._finish(self)


# ---------------------------------------------------------------------------
# Reference-parity streaming classes
# ---------------------------------------------------------------------------


class _StreamingLattice:
    """Shared streaming machinery for the lattice decoder API classes.

    Host memory is bounded: each ``advance_decoding`` chunk's records are
    folded into an :class:`IncrementalLattice` at once (acoustic scores are
    consumed, not retained) and every ``prune_interval`` frames the
    backward extra-cost sweep discards provably dead tokens and links —
    the reference's PruneActiveTokens loop
    (`lattice-simple-decoder.cc:53-73`, `:198-223`).  The final lattice is
    the one-shot decode's."""

    def __init__(self, fst, frontier_kw: dict, lattice_beam: float, config, *, device):
        self.device = torch.device(device)
        self._graph = _as_graph(fst)
        fc = config_for_graph(self._graph, **frontier_kw)
        self._lattice_beam = float(lattice_beam)
        self._dev_cfg = lattice_config_for_graph(
            self._graph, fc, lattice_beam=self._lattice_beam
        )
        self._config = config
        self._prune_interval = int(getattr(config, "prune_interval", 25))
        self._prune_scale = float(getattr(config, "prune_scale", 0.1))
        fcw = self._dev_cfg.frontier
        self._pg = pack_graph_device(
            self._graph, fcw.block_width, fcw.eps_block_width, fcw.flat_group, self.device
        )
        self._reset()

    def _reset(self):
        self._num_frames_decoded = -1
        self._state: Optional[StepState] = None
        self._inc: Optional[IncrementalLattice] = None
        self._stats: List[dict] = []
        self._wall_s = 0.0
        self._since_prune = 0
        self._finalized = False
        self._pruned_cache: dict = {}

    def get_config(self):
        return self._config

    def init_decoding(self) -> None:
        self._reset()
        st, recs = init_closure_rec(
            self._pg, self._graph.start_state, self._graph.num_states, self._dev_cfg,
            self.device,
        )
        self._state = st
        self._inc = IncrementalLattice(self._graph, self._lattice_beam, self._prune_scale)
        self._inc.init_frame(
            st.states[0].cpu().numpy(), st.costs[0].cpu().numpy(), recs.cpu().numpy()
        )
        self._num_frames_decoded = 0

    def advance_decoding(
        self, decodable: DecodableInterface, max_num_frames: int = -1
    ) -> None:
        assert self._num_frames_decoded >= 0, "call init_decoding() first"
        assert not self._finalized, "cannot advance after finalize_decoding()"
        num_frames_ready = decodable.num_frames_ready()
        assert num_frames_ready >= self._num_frames_decoded
        target = num_frames_ready
        if max_num_frames >= 0:
            target = min(target, self._num_frames_decoded + max_num_frames)
        n_new = target - self._num_frames_decoded
        if n_new <= 0:
            return
        scores = scores_from_decodable(decodable, self._num_frames_decoded, target)
        if self._graph.max_score_idx >= scores.shape[1]:
            raise ValueError(
                f"graph references score index {self._graph.max_score_idx} but "
                f"decodable has only {scores.shape[1]} indices"
            )
        t0 = time.perf_counter()
        with annotate("kdtpu.advance_decoding", step=self._num_frames_decoded,
                      device=self.device):
            scores_tm = torch.from_numpy(np.ascontiguousarray(scores, np.float32)[:, None])
            lengths = torch.full((1,), n_new, dtype=torch.int32, device=self.device)
            stf, outs = lattice_chunk(
                self._pg, scores_tm.to(self.device), lengths, self._state, self._dev_cfg,
                self._graph.num_states,
            )
            frame_states = outs.frontier_states[:, 0].cpu().numpy()
        self._wall_s += time.perf_counter() - t0
        self._state = stf
        frame_costs = outs.frontier_costs[:, 0].cpu().numpy()
        em_records = outs.em_records[:, 0].cpu().numpy()
        eps_records = outs.eps_records[:, 0].cpu().numpy()
        for t in range(n_new):
            self._inc.append_frame(
                frame_states[t], frame_costs[t], em_records[t], eps_records[t], scores[t],
            )
            self._since_prune += 1
            if self._since_prune >= self._prune_interval:
                self._inc.prune_active_tokens()
                self._since_prune = 0
        self._stats.append(
            {
                "num_active": outs.num_active[:, 0].cpu().numpy(),
                "cutoffs": outs.cutoff[:, 0].cpu().numpy(),
                "overflows": outs.overflow[:, 0].cpu().numpy(),
                "saturations": outs.saturated[:, 0].cpu().numpy(),
            }
        )
        self._pruned_cache.clear()
        self._num_frames_decoded = target

    def decode(self, decodable: DecodableInterface) -> bool:
        """Full decode + FinalizeDecoding; True iff final costs exist
        (`lattice-simple-decoder.cc:53-73`)."""
        self.init_decoding()
        self.advance_decoding(decodable)
        self.finalize_decoding()
        return self.reached_final()

    def finalize_decoding(self) -> None:
        """FinalizeDecoding parity (`lattice-simple-decoder.cc:407-420`).

        The full backward prune happens on the host when a lattice is
        asked for; this locks in final-probs semantics (`:588-591` forbids
        use_final_probs=False after)."""
        self._finalized = True

    def num_frames_decoded(self) -> int:
        return self._num_frames_decoded

    def _pruned(self, use_final_probs: bool = True) -> Optional[PrunedLattice]:
        assert self._inc is not None, "call init_decoding() first"
        if use_final_probs not in self._pruned_cache:
            self._pruned_cache[use_final_probs] = self._inc.finalize(use_final_probs)
        return self._pruned_cache[use_final_probs]

    def stats(self) -> DecodeStats:
        T = self._num_frames_decoded

        def cat(k):
            if not self._stats:
                return np.zeros((0,))
            return np.concatenate([c[k] for c in self._stats], axis=0)

        return DecodeStats(
            num_frames=T,
            active_per_frame=cat("num_active"),
            cutoff_per_frame=cat("cutoffs"),
            arc_budget_overflows=int(np.sum(cat("overflows"))),
            frontier_saturated_frames=int(np.sum(cat("saturations"))),
            wall_seconds=self._wall_s,
            batch_frames=T,
        )

    def reached_final(self) -> bool:
        pl = self._pruned(True)
        return pl is not None and np.isfinite(pl.final_relative_cost)

    def final_relative_cost(self) -> float:
        """ComputeFinalCosts semantics (`lattice-simple-decoder.cc:522-560`)."""
        st = self._state
        if st is None:
            return INF
        costs = (st.base.cpu().numpy()[:, None] + st.costs.cpu().numpy())[0]
        if not np.any(np.isfinite(costs)):
            return INF
        fc = self._graph.arrays.final_cost[st.states.cpu().numpy()[0]]
        best = float(np.min(costs))
        with np.errstate(invalid="ignore"):
            best_final = float(np.min(costs + fc))
        if not np.isfinite(best_final):
            return INF
        return best_final - best

    def get_raw_lattice(self, use_final_probs: bool = True) -> Tuple[bool, Lattice]:
        if self._finalized and not use_final_probs:
            raise RuntimeError(
                "You cannot call finalize_decoding() and then call "
                "get_raw_lattice() with use_final_probs == false"
            )  # lattice-simple-decoder.cc:588-591
        pl = self._pruned(use_final_probs)
        lat = raw_lattice_to_fst(pl, use_final_probs) if pl is not None else None
        if lat is None:
            return False, Lattice()
        return True, lat

    def get_best_path(self, use_final_probs: bool = True) -> Tuple[bool, Lattice]:
        ok, lat = self.get_raw_lattice(use_final_probs)
        if not ok:
            return False, Lattice()
        sp = shortest_path(lat)
        return sp.num_states > 0, sp


class LatticeSimpleDecoder(_StreamingLattice):
    """LatticeSimpleDecoder parity (`lattice-simple-decoder.h:90-320`):
    beam-only pruning, lattice output."""

    def __init__(self, fst, config: Optional[LatticeSimpleDecoderConfig] = None, *, device):
        config = config or LatticeSimpleDecoderConfig()
        config.check()
        super().__init__(
            fst,
            dict(beam=config.beam, max_active=INT32_MAX, min_active=0),
            config.lattice_beam,
            config,
            device=device,
        )


class LatticeFasterDecoder(_StreamingLattice):
    """Lattice generation with max-active and adaptive-beam pruning: the
    decoder the reference declares (`lattice-faster-decoder.h:23-134`)."""

    def __init__(self, fst, config: Optional[LatticeFasterDecoderConfig] = None, *, device):
        config = config or LatticeFasterDecoderConfig()
        config.check()
        super().__init__(
            fst,
            dict(
                beam=config.beam,
                max_active=config.max_active,
                min_active=config.min_active,
                beam_delta=config.beam_delta,
            ),
            config.lattice_beam,
            config,
            device=device,
        )
