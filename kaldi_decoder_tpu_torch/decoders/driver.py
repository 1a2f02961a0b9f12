"""The frame driver: a chunk's frames on static buffers, replayed on a card
from one captured CUDA graph.

The original runs a chunk as one compiled program, a jitted ``lax.scan``
over its batched frame step (``kaldi_decoder_tpu/decoders/lattice_dev.py``
``build_lattice_chunk_fn``, ``decoders/viterbi.py`` ``build_chunk_fn``),
so the device never waits on the host between frames.  Here a
:class:`FrameDriver` keeps one batch's frame on static buffers
(:class:`kaldi_decoder_tpu_torch.kernels.frame.FrameSlots` and K1's, K2's
or K6's outputs and scratch): a frame is the body (K1, then K2 or K6, then
on a graph with eps arcs the eps closure, plain torch around K2's or K6's
eps calls) and K3, the frame tail, which rebases, writes row ``t`` of the
chunk's outputs, prepares the next frame's K1 inputs and advances ``t`` on
the device.  So on a card the frame is captured once into a
``torch.cuda.CUDAGraph`` per (batch, config, device graph, score width)
and replayed once a frame, for every chunk and every chunk length (the
streaming decoders' calls too): a chunk is K3's first-frame mode (which
loads the chunk's start state, scores, lengths and output buffers) and C
replays.  The first frame a driver runs is run eagerly before the capture,
so that every kernel is loaded and sized; a capture or replay that fails
raises, and nothing falls back to another loop.  On the CPU the same frame
runs eagerly, with the plain versions of every kernel.  Only within
:func:`eager_frames` does a chunk run the loop the frame driver replaced, as the
yardstick of the graph.

Launch counters: a capture launches nothing, so the wrappers' counts are
put back after it, and each replay adds the launches the graph holds.
``replays`` counts the frames replayed.  The graph of a frame shares one
winner table (``kernels.dedup``) with the frame driver's capture stream, made
before the capture and kept by the frame driver.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Optional, Union

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepOut,
    StepState,
    frame_body,
    frame_step_batched,
)
from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
    REC_COLS,
    LatticeDevConfig,
    LatticeStepOut,
    lattice_frame_body,
    lattice_frame_step_batched,
)
from kaldi_decoder_tpu_torch.fst.pack import PackedGraph
from kaldi_decoder_tpu_torch.kernels import dedup as k6
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec, empty_lattice_selection
from kaldi_decoder_tpu_torch.kernels.expand import empty_expansion, expand_filter
from kaldi_decoder_tpu_torch.kernels.frame import FrameIO, FrameSlots, frame_start, frame_tail

# The wrappers whose launches a captured frame holds.
COUNTED = (expand_filter, dedup_select_rec, k6.dedup_select, frame_tail)
# Drivers kept (each holds its static buffers, graph and device graph).
MAX_DRIVERS = 4

replays = 0  # frames replayed from a captured graph, by every driver
_eager = False
_drivers: "collections.OrderedDict" = collections.OrderedDict()


@contextlib.contextmanager
def eager_frames():
    """Within it, a chunk runs as the loop did before the frame driver: the
    frame steps (``lattice_frame_step_batched``, ``frame_step_batched``:
    K1, K2 or K6 and the eps closure, then the plain-torch tail) launched
    from the host frame after frame, each frame's outputs copied into the
    chunk's buffers.  It is the yardstick the graph is measured against;
    nothing else runs it."""
    global _eager
    before, _eager = _eager, True
    try:
        yield
    finally:
        _eager = before


class FrameDriver:
    """One batch's frames on static buffers: the lattice frame when
    ``lattice``, else the Viterbi frame, of ``batch`` rows of scores
    ``width`` wide on ``device``."""

    def __init__(self, lattice: bool, pg: PackedGraph,
                 cfg: Union[LatticeDevConfig, FrontierConfig], num_states: int, batch: int,
                 width: int, device):
        self.lattice = lattice
        self.pg, self.cfg, self.num_states = pg, cfg, num_states
        self.fc = cfg.frontier if lattice else cfg
        self.device = dev = torch.device(device)
        K = self.fc.frontier_size
        self.slots = FrameSlots(batch, K, width, dev)
        self.bufs = None
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.per_replay = None  # launches of COUNTED a replay holds
        self.pool_bytes = None  # (allocated, reserved) bytes the capture kept
        if dev.type == "cuda":
            N = self.fc.num_candidates
            if lattice:
                sel = empty_lattice_selection(batch, K, cfg.em_records, dev)
                scratch = k6.empty_scratch(batch, N, dev, pairs=4)
            else:
                sel = k6.empty_selection(batch, K, dev)
                scratch = k6.empty_scratch(batch, N, dev)
            self.bufs = (empty_expansion(batch, N, dev, with_src_slot=not lattice), sel, scratch)
            # The capture stream's winner table, made before any capture.
            self.stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(self.stream):
                self.table, _ = k6._held_table(dev, batch, num_states)
            self.stream.synchronize()

    def body(self):
        """The frame's K1, K2 or K6 and eps closure on the slots; returns
        the tail's inputs."""
        s = self.slots
        fn = lattice_frame_body if self.lattice else frame_body
        return fn(s.state, s.cutoff, s.adaptive_beam, s.scores_t, s.active, self.pg, self.cfg,
                  self.num_states, self.bufs)

    def frame(self) -> None:
        """One frame of the chunk being run: its body, then K3."""
        frame_tail(self.slots, self.body(), self.fc)

    def begin(self, scores_tm: torch.Tensor, lengths: torch.Tensor, st0: StepState) -> FrameIO:
        """K3's first-frame mode for a chunk: its output buffers, its start
        state and frame 0's K1 inputs into the slots, ``t`` 0."""
        C, B, _ = scores_tm.shape
        io = FrameIO(scores_tm.contiguous(), lengths, st0,
                     chunk_outputs(self.lattice, self.cfg, C, B, self.device))
        frame_start(self.slots, io, self.fc)
        return io

    def _capture(self) -> None:
        before = [fn.launches for fn in COUNTED]
        # The capture empties the allocator's cache first; so does this, so
        # that the bytes reserved after it are the graph's private pool's.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        alloc = torch.cuda.memory_allocated(self.device), torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.frame()
        finally:
            held = [fn.launches - b for fn, b in zip(COUNTED, before)]
            for fn, b in zip(COUNTED, before):
                fn.launches = b  # the capture launched nothing
        self.pool_bytes = (torch.cuda.memory_allocated(self.device) - alloc[0],
                           torch.cuda.memory_reserved(self.device) - alloc[1])
        self.graph, self.per_replay = graph, held

    def run(self, scores_tm: torch.Tensor, lengths: torch.Tensor, st0: StepState):
        """The chunk's frames from ``st0``: the final state (a copy) and the
        per-frame outputs stacked (C, B, ...)."""
        global replays
        C = scores_tm.shape[0]
        io = self.begin(scores_tm, lengths, st0)
        if self.device.type == "cuda":
            t = 0
            if self.graph is None:
                self.frame()  # eagerly: every kernel loaded and sized before the capture
                t = 1
                if C > 1:
                    self._capture()
            for _ in range(t, C):
                self.graph.replay()
            if C > t:
                for fn, n in zip(COUNTED, self.per_replay):
                    fn.launches += n * (C - t)
                replays += C - t
        else:
            for _ in range(C):
                self.frame()
        self.slots.io = None  # the chunk's tensors are the caller's now
        return StepState(*(x.clone() for x in self.slots.state)), io.outs


def chunk_outputs(lattice: bool, cfg, C: int, B: int, device):
    """Uninitialised stacked outputs of a chunk of C frames of B rows: a
    ``LatticeStepOut`` when ``lattice`` (``cfg`` a ``LatticeDevConfig``),
    else a ``StepOut`` (``cfg`` a ``FrontierConfig``)."""
    fc = cfg.frontier if lattice else cfg
    K, D = fc.frontier_size, fc.eps_iters

    def empty(*shape, dtype=torch.int32):
        return torch.empty((C, B) + shape, dtype=dtype, device=device)

    tail = (empty(), empty(dtype=torch.float32), empty(dtype=torch.float32),
            empty(dtype=torch.bool), empty(dtype=torch.bool))
    if lattice:
        return LatticeStepOut(empty(cfg.em_records, REC_COLS),
                              empty(D, cfg.eps_records, REC_COLS), empty(K),
                              empty(K, dtype=torch.float32), *tail)
    return StepOut(empty(K, 2), empty(D, K, 2), *tail)


def driver_for(lattice: bool, pg: PackedGraph, cfg, num_states: int, batch: int, width: int,
               device) -> FrameDriver:
    """The kept driver of these arguments, or a new one (the least
    recently used of ``MAX_DRIVERS`` is dropped, after its card has
    finished with it)."""
    dev = torch.device(device)
    key = (lattice, tuple(id(x) for x in pg), cfg, num_states, batch, width, str(dev))
    drv = _drivers.pop(key, None)
    if drv is None:
        while len(_drivers) >= MAX_DRIVERS:
            _, old = _drivers.popitem(last=False)
            if old.device.type == "cuda":
                torch.cuda.synchronize(old.device)
        drv = FrameDriver(lattice, pg, cfg, num_states, batch, width, dev)
    _drivers[key] = drv  # holds pg, so the ids in its key stay its tables'
    return drv


def step_loop(lattice: bool, pg: PackedGraph, scores_tm: torch.Tensor, lengths: torch.Tensor,
              st0: StepState, cfg, num_states: int):
    """The chunk as the loop before the frame driver ran it (:func:`eager_frames`)."""
    C, B, _ = scores_tm.shape
    step = lattice_frame_step_batched if lattice else frame_step_batched
    outs = chunk_outputs(lattice, cfg, C, B, scores_tm.device)
    st = st0
    for t in range(C):
        st, o = step(st, scores_tm[t], lengths > t, pg, cfg, num_states)
        for buf, x in zip(outs, o):
            buf[t].copy_(x)
    return st, outs


def run_chunk(lattice: bool, pg: PackedGraph, scores_tm: torch.Tensor, lengths: torch.Tensor,
              st0: StepState, cfg, num_states: int):
    """``lattice_dev.lattice_chunk`` (``lattice``) or
    ``viterbi.viterbi_chunk``: (final state, stacked outputs), or (``st0``,
    None) for no frames."""
    C, B, V = scores_tm.shape
    if C == 0:
        return st0, None
    if _eager:
        return step_loop(lattice, pg, scores_tm, lengths, st0, cfg, num_states)
    drv = driver_for(lattice, pg, cfg, num_states, B, V, scores_tm.device)
    return drv.run(scores_tm, lengths, st0)
