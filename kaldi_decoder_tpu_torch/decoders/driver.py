"""The frame driver: a chunk's frames on static buffers, replayed on a card
from one captured CUDA graph.

The original runs a chunk as one compiled program, a jitted ``lax.scan``
over its batched frame step (``kaldi_decoder_tpu/decoders/lattice_dev.py``
``build_lattice_chunk_fn``, ``decoders/viterbi.py`` ``build_chunk_fn``),
so the device never waits on the host between frames.  Here a
:class:`FrameDriver` keeps one batch's frame on static buffers
(:class:`kaldi_decoder_tpu_torch.kernels.frame.FrameSlots` and K1's, K2's
or K6's outputs and scratch, and on a graph with eps arcs the eps
closure's: K5's lanes, the eps calls' outputs and scratch, the closure's
carry): a frame is the body (K1, then K2 or K6, then on a graph with eps
arcs the eps closure, each iteration K5, K6 or K2's eps call and the eps
step) and K3, the frame tail, which rebases, writes row ``t`` of the
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
from typing import NamedTuple, Optional, Union

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
from kaldi_decoder_tpu_torch.kernels.eps import (
    EpsBufs,
    empty_eps_carry,
    empty_eps_lanes,
    eps_dedup,
    eps_lane_count,
    expand_eps_lanes,
)
from kaldi_decoder_tpu_torch.kernels.expand import Expansion, empty_expansion, expand_filter
from kaldi_decoder_tpu_torch.kernels.frame import FrameIO, FrameSlots, frame_start, frame_tail

# The wrappers whose launches a captured frame holds.
COUNTED = (expand_filter, dedup_select_rec, k6.dedup_select, expand_eps_lanes, eps_dedup,
           frame_tail)
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


class FrameBufs(NamedTuple):
    """A frame's static buffers on a card: K1's outputs, K2's or K6's
    outputs and scratch, and the eps closure's (None without one)."""

    expansion: Expansion
    selection: object
    scratch: tuple
    eps: Optional[EpsBufs]


def frame_buffers(lattice: bool, cfg, batch: int, device) -> FrameBufs:
    """Uninitialised static buffers of one frame of ``batch`` rows: the
    lattice frame's when ``lattice`` (``cfg`` a ``LatticeDevConfig``),
    else the Viterbi frame's."""
    fc = cfg.frontier if lattice else cfg
    K, N = fc.frontier_size, fc.num_candidates
    if lattice:
        sel = empty_lattice_selection(batch, K, cfg.em_records, device)
        scratch = k6.empty_scratch(batch, N, device, pairs=4)
    else:
        sel = k6.empty_selection(batch, K, device)
        scratch = k6.empty_scratch(batch, N, device)
    eps = None
    if fc.eps_iters:
        Ne = eps_lane_count(fc, incumbents=True)
        lanes = empty_eps_lanes(batch, Ne, device, with_src_slot=not lattice,
                                with_src_state=lattice)
        if lattice:
            r_eps = cfg.eps_records
            eps = EpsBufs(lanes, empty_lattice_selection(batch, K, K + r_eps, device, True),
                          k6.empty_scratch(batch, Ne, device, pairs=4),
                          empty_eps_carry(batch, fc.eps_iters, r_eps, True, device))
        else:
            eps = EpsBufs(lanes, k6.empty_selection(batch, K, device),
                          k6.empty_scratch(batch, Ne, device),
                          empty_eps_carry(batch, fc.eps_iters, K, False, device))
    return FrameBufs(empty_expansion(batch, N, device, with_src_slot=not lattice), sel, scratch,
                     eps)


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
        self.graphed: Optional[GraphedFrame] = None
        if dev.type == "cuda":
            self.bufs = frame_buffers(lattice, cfg, batch, dev)
            self.graphed = GraphedFrame(self.frame, dev, batch, num_states)

    def body(self):
        """The frame's K1, K2 or K6 and eps closure (K5, then K6 or K2's
        eps call with the eps step as its last step) on the slots; returns
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

    @property
    def pool_bytes(self):
        """(allocated, reserved) bytes the capture kept, None before it."""
        return None if self.graphed is None else self.graphed.pool_bytes

    def run(self, scores_tm: torch.Tensor, lengths: torch.Tensor, st0: StepState):
        """The chunk's frames from ``st0``: the final state (a copy) and the
        per-frame outputs stacked (C, B, ...)."""
        C = scores_tm.shape[0]
        io = self.begin(scores_tm, lengths, st0)
        if self.graphed is not None:
            self.graphed.run(C)
        else:
            for _ in range(C):
                self.frame()
        self.slots.io = None  # the chunk's tensors are the caller's now
        return StepState(*(x.clone() for x in self.slots.state)), io.outs

    def release(self) -> None:
        """Wait for the card and destroy the graph (:meth:`GraphedFrame.release`)."""
        if self.graphed is not None:
            self.graphed.release()


class GraphedFrame:
    """A frame replayed on a card from one captured CUDA graph, the runner
    of both frame drivers (this module's and ``parallel/shard_driver.py``'s).

    ``run(n)`` runs ``frame()`` (one frame on its driver's static buffers)
    n times: the runner's first frame eagerly, so that every kernel is
    loaded and sized and every NCCL communicator made, then the frame is
    captured once, on the runner's own stream, and replayed for every
    frame after it.  ``counted`` are the wrappers whose launches a frame
    makes and ``calls``, where given, the Counter of the collective calls
    it makes by kind: a capture launches and exchanges nothing, so those
    counts are put back after it, and each replay adds what the graph
    holds (:func:`held_counts`, :func:`add_replays`).  ``batch`` rows of
    ``num_states`` states size the winner table (``kernels.dedup``) made
    for the capture stream before any capture.  The capture's error mode
    is ``thread_local``: an NCCL process group's watchdog thread queries
    its own events meanwhile.  A capture or replay that fails raises."""

    def __init__(self, frame, device: torch.device, batch: int, num_states: int,
                 counted: tuple = COUNTED, calls: Optional[collections.Counter] = None):
        self.frame, self.device = frame, device
        self.counted, self.calls = counted, calls
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.held = None  # (launches of counted, collective calls) a replay holds
        self.pool_bytes = None  # (allocated, reserved) bytes the capture kept
        self.stream = torch.cuda.Stream(device)
        with torch.cuda.stream(self.stream):
            self.table, _ = k6._held_table(device, batch, num_states)
        self.stream.synchronize()

    def _capture(self) -> None:
        # The capture empties the allocator's cache first; so does this, so
        # that the bytes reserved after it are the graph's private pool's.
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        alloc = torch.cuda.memory_allocated(self.device), torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()

        def capture():
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                self.frame()
        self.held = held_counts(capture, self.counted, self.calls)
        self.pool_bytes = (torch.cuda.memory_allocated(self.device) - alloc[0],
                           torch.cuda.memory_reserved(self.device) - alloc[1])
        self.graph = graph

    def run(self, frames: int) -> None:
        """``frames`` frames of the chunk begun on the driver's buffers."""
        t = 0
        if self.graph is None:
            self.frame()  # eagerly: every kernel loaded and sized before the capture
            t = 1
            if frames > 1:
                self._capture()
        for _ in range(t, frames):
            self.graph.replay()
        if frames > t:
            add_replays(*self.held, frames - t, self.counted, self.calls)

    def release(self) -> None:
        """Wait for the card, then destroy the graph (its pool goes back to
        the allocator; the next run captures again).  NCCL does not destroy
        a communicator while a graph that holds its collectives lives."""
        torch.cuda.synchronize(self.device)
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


def held_counts(run, counted: tuple = COUNTED, calls: Optional[collections.Counter] = None):
    """Run ``run()`` and put back what it counted, also when it raises:
    the launches of ``counted`` and, given ``calls``, that Counter's
    counts.  Returns (the launches it counted, in ``counted``'s order; the
    calls it counted, a Counter by kind, empty without ``calls``)."""
    before = [fn.launches for fn in counted]
    calls_before = collections.Counter(calls or ())
    try:
        run()
    finally:
        launches = [fn.launches - b for fn, b in zip(counted, before)]
        for fn, b in zip(counted, before):
            fn.launches = b
        held_calls = collections.Counter()
        if calls is not None:
            held_calls = calls - calls_before
            calls.clear()
            calls.update(calls_before)
    return launches, held_calls


def add_replays(launches, held_calls, n: int, counted: tuple = COUNTED,
                calls: Optional[collections.Counter] = None) -> None:
    """Count ``n`` replays of a graph that holds ``launches`` (in
    ``counted``'s order) and ``held_calls`` (by kind): each wrapper's
    launches and, given ``calls``, each kind's count there grow by n times
    the graph's, and :data:`replays` by n."""
    global replays
    for fn, k in zip(counted, launches):
        fn.launches += k * n
    if calls is not None:
        for kind, k in held_calls.items():
            calls[kind] += k * n
    replays += n


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


def kept_driver(cache: "collections.OrderedDict", key, make):
    """The driver of ``key`` in ``cache``, or ``make()``'s, kept there (the
    least recently used of ``MAX_DRIVERS`` is dropped, released)."""
    drv = cache.pop(key, None)
    if drv is None:
        while len(cache) >= MAX_DRIVERS:
            cache.popitem(last=False)[1].release()
        drv = make()
    cache[key] = drv
    return drv


def release(cache: "Optional[collections.OrderedDict]" = None) -> None:
    """Drop every driver kept in ``cache`` (the frame drivers' when None),
    each released: its card finished with it and its graph destroyed."""
    cache = _drivers if cache is None else cache
    while cache:
        cache.popitem(last=False)[1].release()


def driver_for(lattice: bool, pg: PackedGraph, cfg, num_states: int, batch: int, width: int,
               device) -> FrameDriver:
    """The kept driver of these arguments, or a new one (:func:`kept_driver`)."""
    dev = torch.device(device)
    key = (lattice, tuple(id(x) for x in pg), cfg, num_states, batch, width, str(dev))
    # The driver holds pg, so the ids in its key stay its tables'.
    return kept_driver(_drivers, key,
                       lambda: FrameDriver(lattice, pg, cfg, num_states, batch, width, dev))


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
