"""K3: the frame tail of the chunk loop (GetCutoff, rebase, freeze, outputs).

A chunk's frames run on static buffers, :class:`FrameSlots`: the carried
frontier, K1's inputs (this frame's cutoff, adaptive beam and scores row)
and the rows still active, plus a small table in device memory that holds
the frame index ``t`` and the chunk's tensors (:class:`FrameIO`).
:func:`frame_start` (the first-frame mode) loads a chunk's start state,
runs GetCutoff on it and sets ``t = 0``; after each frame's K1, K2 or K6
and eps closure, :func:`frame_tail` rebases the frontier, freezes the rows
whose utterance has ended, writes row ``t`` of every stacked output, runs
GetCutoff on the new frontier for the next frame, loads its scores row and
advances ``t``.  Nothing of it depends on the host, so a frame can be
captured once in a CUDA graph and replayed for every frame of every chunk
(:mod:`kaldi_decoder_tpu_torch.decoders.driver`).

:func:`frame_tail_plain` is the plain torch version of one frame's tail
(the tail of the original's ``lattice_frame_step_batched`` and of its
``frame_step_batched``); on CPU tensors the wrappers run it and
``get_cutoff``, on CUDA tensors they launch ``csrc/frame.cu`` or raise.
On a card the tail is a cluster of blocks a row (:func:`cluster_size`),
and so is its shard mode (:func:`shard_cluster_size`).

The sharded decoders' frame (``parallel/graph_shard.py``) runs on static
buffers too, :class:`ShardSlots`: the carried frontier, the chunk's row
lengths, K1's scores row and a table in device memory that holds ``t``
and the chunk's scores and stacked outputs.  Its first-frame mode,
:func:`frame_start_shard`, loads a chunk's start state, lengths and
scores row 0, writes the table and, as its last step, K8's local half of
the start state (a cluster of blocks a row, :func:`start_cluster_size`);
each frame ends with K3's shard mode,
:func:`frame_tail_shard`, after the rebase's reductions over the ranks:
the rebase by the global best cost, the freeze of ended rows, the frame's
outputs into row ``t`` of the chunk's stacked :class:`ShardStepOut` or
:class:`ShardLatticeStepOut` through the table, the next scores row and
``t`` advanced.  So the sharded frame, too, can be captured once and
replayed (``parallel/shard_driver.py``).  It runs no GetCutoff: the
sharded cutoff is global (``graph_shard._global_cutoff``).  The plain
versions are :func:`frame_start_shard_plain` (then
``kernels.cutoff.global_cutoff_local_plain``) and
:func:`frame_tail_shard_plain`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Union

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepOut,
    StepState,
    _backpointers,
    _identity_bp,
)
from kaldi_decoder_tpu_torch.decoders.lattice_dev import LatticeStepOut
from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_clusters,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)
from kaldi_decoder_tpu_torch.kernels.cutoff import CutoffLocal, global_cutoff_local_plain
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

# csrc/frame.cu FrameArgs: t, frames, done (rows done with frame t),
# scores, lengths, then the nine output pointers, each one int64 word.
ARGS_WORDS = 14
OUTS = 9
# csrc/frame.cu ShardTable: t, rows done with it, the chunk's frame count,
# its scores, then its eight output pointers, each one int64 word.
SHARD_ARGS_WORDS = 12
SHARD_OUTS = 8


class TailInputs(NamedTuple):
    """One frame's results that the tail reads: the frontier after K2 or
    K6 and the eps closure, the overflow and saturation flags, and the
    lattice records or the 1-best backpointer inputs."""

    mid_states: torch.Tensor  # (B, K) int32, cost-sorted
    mid_costs: torch.Tensor  # (B, K) float32, relative to the carried base
    em_overflow: torch.Tensor  # (B,) bool — K1's remainder overflow
    num_unique: torch.Tensor  # (B,) int32 — the emitting dedup's distinct states
    eps_overflow: Optional[torch.Tensor] = None  # (B,) bool; None: no eps closure
    eps_saturated: Optional[torch.Tensor] = None  # (B,) bool
    # Lattice: K2's records.
    rec_overflow: Optional[torch.Tensor] = None  # (B,) bool
    em_records: Optional[torch.Tensor] = None  # (B, R, 4) int32
    eps_records: Optional[torch.Tensor] = None  # (B, D, Re, 4) int32 (D may be 0)
    # 1-best: the backpointer gather's inputs.
    cand_idx: Optional[torch.Tensor] = None  # (B, K) int32, K6's winning lane
    src_slot: Optional[torch.Tensor] = None  # (B, N) int32, K1's
    arc_id: Optional[torch.Tensor] = None  # (B, N) int32, K1's
    bp_eps: Optional[torch.Tensor] = None  # (B, D, K, 2) int32 (D may be 0)


class FrameIO(NamedTuple):
    """A chunk's tensors: its scores, lengths and start state, and the
    stacked outputs its frames fill, row t each."""

    scores: torch.Tensor  # (C, B, V) float32, time-major
    lengths: torch.Tensor  # (B,) int32 — frames t >= lengths are no-ops
    st0: StepState
    # (C, B, ...) each; a sharded chunk's: ShardStepOut or ShardLatticeStepOut
    outs: Union[LatticeStepOut, StepOut, "ShardStepOut", "ShardLatticeStepOut"]


class FrameSlots:
    """The static buffers of a batch's frames on one device: the carried
    frontier ``state``, K1's inputs ``cutoff``, ``adaptive_beam`` and
    ``scores_t``, the rows still decoding ``active`` (the eps closure's),
    and ``args`` (``csrc/frame.cu`` FrameArgs: ``t`` is ``args[0]``, the
    chunk's frame count ``args[1]``).  ``io`` is the chunk being run."""

    def __init__(self, batch: int, k: int, width: int, device):
        dev = torch.device(device)
        f32 = dict(dtype=torch.float32, device=dev)
        self.state = StepState(
            torch.zeros((batch, k), dtype=torch.int32, device=dev),
            torch.full((batch, k), float("inf"), **f32),
            torch.zeros((batch,), **f32),
        )
        self.cutoff = torch.zeros((batch,), **f32)
        self.adaptive_beam = torch.zeros((batch,), **f32)
        self.active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        self.scores_t = torch.zeros((batch, width), **f32)
        self.args = torch.zeros((ARGS_WORDS,), dtype=torch.int64, device=dev)
        self.io: Optional[FrameIO] = None


def frame_tail_plain(st: StepState, cutoff: torch.Tensor, tin: TailInputs,
                     frame_active: torch.Tensor, fc: FrontierConfig):
    """One frame's tail: the rebase by each row's best cost, the freeze of
    rows with ``frame_active`` False (their state kept, their records -1,
    their backpointers the identity), the frame's outputs and GetCutoff of
    the new frontier.  ``st`` is the state the frame started from and
    ``cutoff`` (B,) its GetCutoff, relative to ``st.base``.  Returns (the
    new state, the frame's outputs (a ``LatticeStepOut`` when ``tin`` has
    records, else a ``StepOut``), the next frame's ``Cutoff``)."""
    K = fc.frontier_size
    fa = frame_active
    m = tin.mid_costs[:, 0]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    final = StepState(
        states=torch.where(fa[:, None], tin.mid_states, st.states),
        costs=torch.where(fa[:, None], tin.mid_costs - m_safe[:, None], st.costs),
        base=torch.where(fa, st.base + m_safe, st.base),
    )
    ovf = tin.em_overflow
    if tin.rec_overflow is not None:
        ovf = ovf | tin.rec_overflow
    sat = tin.num_unique > K
    if tin.eps_overflow is not None:
        ovf, sat = ovf | tin.eps_overflow, sat | tin.eps_saturated
    if tin.em_records is not None:
        out = LatticeStepOut(
            em_records=torch.where(fa[:, None, None], tin.em_records, -1),
            eps_records=torch.where(fa[:, None, None, None], tin.eps_records, -1),
            frontier_states=final.states,
            frontier_costs=final.base[:, None] + final.costs,
            num_active=torch.isfinite(final.costs).sum(dim=1, dtype=torch.int32),
            best_cost=final.base,
            cutoff=st.base + cutoff,
            overflow=fa & ovf,
            saturated=fa & sat,
        )
    else:
        ident = _identity_bp(K, st.states.device)
        s0 = st.costs[:, 0]
        out = StepOut(
            bp_emit=torch.where(fa[:, None, None],
                                _backpointers(tin.cand_idx, tin.src_slot, tin.arc_id), ident),
            bp_eps=torch.where(fa[:, None, None, None], tin.bp_eps, ident),
            # Counts the frontier before the rebase, as the original does.
            num_active=torch.where(
                fa,
                torch.isfinite(tin.mid_costs).sum(dim=1, dtype=torch.int32),
                torch.isfinite(st.costs).sum(dim=1, dtype=torch.int32),
            ),
            best_cost=torch.where(
                fa, st.base + m_safe, st.base + torch.where(torch.isfinite(s0), s0, 0.0)
            ),
            cutoff=st.base + cutoff,
            overflow=fa & ovf,
            saturated=fa & sat,
        )
    nxt = get_cutoff(final.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    return final, out, nxt


def _config_args(fc: FrontierConfig):
    return (ctypes.c_float(fc.beam), min(fc.max_active, 2**31 - 1), fc.min_active,
            ctypes.c_float(fc.beam_delta))


def _check_slots(slots: FrameSlots, B: int, K: int, dev) -> int:
    """Raise unless the slots hold a (B, K) frontier on ``dev``; returns V."""
    st = slots.state
    check(st.states, "state.states", torch.int32, (B, K), dev)
    check(st.costs, "state.costs", torch.float32, (B, K), dev)
    for name, x in (("base", st.base), ("cutoff", slots.cutoff),
                    ("adaptive_beam", slots.adaptive_beam)):
        check(x, name, torch.float32, (B,), dev)
    check(slots.active, "active", torch.bool, (B,), dev)
    V = slots.scores_t.shape[1]
    check(slots.scores_t, "scores_t", torch.float32, (B, V), dev)
    check(slots.args, "args", torch.int64, (ARGS_WORDS,), dev)
    return V


def frame_start(slots: FrameSlots, io: FrameIO, fc: FrontierConfig) -> None:
    """K3's first-frame mode: ``io`` becomes the chunk being run, its start
    state the slots' state, its GetCutoff and scores row 0 K1's inputs, and
    ``t`` 0.  ``frame_start.launches`` counts its launches."""
    slots.io = io
    st = slots.state
    dev = st.states.device
    C = io.scores.shape[0]
    if dev.type == "cpu":
        for dst, src in zip(st, io.st0):
            dst.copy_(src)
        cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                         costs_sorted=True)
        slots.cutoff.copy_(cut.cutoff)
        slots.adaptive_beam.copy_(cut.adaptive_beam)
        slots.active.copy_(io.lengths > 0)
        if C:
            slots.scores_t.copy_(io.scores[0])
        slots.args[0], slots.args[1] = 0, C
        return
    if dev.type != "cuda":
        raise ValueError(f"frame_start runs on cpu or cuda tensors, not {dev}")
    B, K = st.states.shape
    V = _check_slots(slots, B, K, dev)
    check(io.scores, "scores", torch.float32, (C, B, V), dev)
    check(io.lengths, "lengths", torch.int32, (B,), dev)
    for name, x, dtype, shape in zip(("st0.states", "st0.costs", "st0.base"), io.st0,
                                     (torch.int32, torch.float32, torch.float32),
                                     ((B, K), (B, K), (B,))):
        check(x, name, dtype, shape, dev)
    for name, x in zip(io.outs._fields, io.outs):
        if x.shape[:2] != (C, B) or x.device != dev or not x.is_contiguous():
            raise ValueError(f"output {name}: expected ({C}, {B}, ...) contiguous on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    outs = [ptr(x) for x in io.outs] + [None] * (OUTS - len(io.outs))
    rc = kernels().kd_frame_start(
        ptr(slots.args), B, K, V, C, *_config_args(fc),
        ptr(st.states), ptr(st.costs), ptr(st.base), ptr(slots.cutoff),
        ptr(slots.adaptive_beam), ptr(slots.active), ptr(slots.scores_t),
        ptr(io.st0.states), ptr(io.st0.costs), ptr(io.st0.base), ptr(io.scores),
        ptr(io.lengths), *outs, stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_frame_start launch failed: {cuda_error(rc)}")
    frame_start.launches += 1


frame_start.launches = 0


def cluster_size(batch: int, k: int) -> int:
    """The blocks a row (a cluster) K3's tail launches with for ``batch``
    rows of ``k`` slots."""
    return kernels().kd_frame_tail_cluster(batch, k)


def frame_tail(slots: FrameSlots, tin: TailInputs, fc: FrontierConfig,
               clusters: int = 0) -> None:
    """K3 on the slots' device: the tail of frame ``t`` (``slots.args[0]``)
    of the chunk ``slots.io``, in place; see :func:`frame_tail_plain`.  On
    a card ``t`` is read and advanced on the device, so a captured frame
    replays as any frame, and ``clusters`` (8, 4, 2 or 1) sets the blocks a
    row instead of :func:`cluster_size`'s choice.  ``frame_tail.launches``
    counts K3 launches."""
    st = slots.state
    dev = st.states.device
    if dev.type == "cpu":
        io = slots.io
        t = int(slots.args[0])
        final, out, nxt = frame_tail_plain(st, slots.cutoff, tin, io.lengths > t, fc)
        for dst, src in zip(st, final):
            dst.copy_(src)
        for buf, x in zip(io.outs, out):
            buf[t].copy_(x)
        slots.cutoff.copy_(nxt.cutoff)
        slots.adaptive_beam.copy_(nxt.adaptive_beam)
        slots.active.copy_(io.lengths > t + 1)
        if t + 1 < io.scores.shape[0]:
            slots.scores_t.copy_(io.scores[t + 1])
        slots.args[0] = t + 1
        return
    if dev.type != "cuda":
        raise ValueError(f"frame_tail runs on cpu or cuda tensors, not {dev}")
    B, K = st.states.shape
    if K != fc.frontier_size:
        raise ValueError(f"frontier has {K} slots, config says {fc.frontier_size}")
    if K >= 1 << 16:
        raise ValueError(f"K3 takes fewer than 65536 slots a row, not {K}")
    check_clusters(clusters)
    V = _check_slots(slots, B, K, dev)
    check(tin.mid_states, "mid_states", torch.int32, (B, K), dev)
    check(tin.mid_costs, "mid_costs", torch.float32, (B, K), dev)
    check(tin.em_overflow, "em_overflow", torch.bool, (B,), dev)
    check(tin.num_unique, "num_unique", torch.int32, (B,), dev)
    if (tin.eps_overflow is None) != (tin.eps_saturated is None):
        raise ValueError("eps_overflow and eps_saturated come together")
    if tin.eps_overflow is not None:
        check(tin.eps_overflow, "eps_overflow", torch.bool, (B,), dev)
        check(tin.eps_saturated, "eps_saturated", torch.bool, (B,), dev)
    lattice = tin.em_records is not None
    R = D = Re = N = 0
    if lattice:
        R = tin.em_records.shape[1]
        D, Re = tin.eps_records.shape[1:3]
        check(tin.rec_overflow, "rec_overflow", torch.bool, (B,), dev)
        check(tin.em_records, "em_records", torch.int32, (B, R, 4), dev)
        check(tin.eps_records, "eps_records", torch.int32, (B, D, Re, 4), dev)
    else:
        N = tin.src_slot.shape[1]
        D = tin.bp_eps.shape[1]
        check(tin.cand_idx, "cand_idx", torch.int32, (B, K), dev)
        check(tin.src_slot, "src_slot", torch.int32, (B, N), dev)
        check(tin.arc_id, "arc_id", torch.int32, (B, N), dev)
        check(tin.bp_eps, "bp_eps", torch.int32, (B, D, K, 2), dev)
    if D and tin.eps_overflow is None:
        raise ValueError("a frame with eps outputs needs the eps closure's flags")

    def opt(x):
        return None if x is None or x.numel() == 0 else ptr(x)

    rc = kernels().kd_frame_tail(
        ptr(slots.args), int(lattice), B, K, V, R, D, Re, N, *_config_args(fc),
        ptr(st.states), ptr(st.costs), ptr(st.base), ptr(slots.cutoff),
        ptr(slots.adaptive_beam), ptr(slots.active), ptr(slots.scores_t),
        ptr(tin.mid_states), ptr(tin.mid_costs), ptr(tin.em_overflow), ptr(tin.num_unique),
        opt(tin.eps_overflow), opt(tin.eps_saturated), opt(tin.rec_overflow),
        opt(tin.em_records), opt(tin.eps_records), opt(tin.cand_idx), opt(tin.src_slot),
        opt(tin.arc_id), opt(tin.bp_eps), clusters, stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_frame_tail launch failed: {cuda_error(rc)}")
    frame_tail.launches += 1


frame_tail.launches = 0


# ---------------------------------------------------------------------------
# The shard mode
# ---------------------------------------------------------------------------


class ShardStepOut(NamedTuple):
    """Per-frame outputs of the sharded Viterbi frame, (B, ...) each, the
    slot axes local; stacked over a chunk they gain a leading T."""

    bp_emit: torch.Tensor  # (B, K, 2) int32 (global slot, global arc)
    bp_eps: torch.Tensor  # (B, D, K, 2) int32
    num_active: torch.Tensor  # (B,) int32, global
    best_cost: torch.Tensor  # (B,) float32, absolute
    cutoff: torch.Tensor  # (B,) float32, absolute
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool


class ShardLatticeStepOut(NamedTuple):
    """Per-frame outputs of the sharded lattice frame, (B, ...) each, the
    record and slot axes local; stacked over a chunk they gain a leading T."""

    em_records: torch.Tensor  # (B, R_em, 2) (global src state, global arc)
    eps_records: torch.Tensor  # (B, D, R_eps, 2)
    frontier_states: torch.Tensor  # (B, K) local state ids
    frontier_costs: torch.Tensor  # (B, K) absolute costs
    num_active: torch.Tensor  # (B,) int32, global
    cutoff: torch.Tensor  # (B,) float32
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool


class ShardTailInputs(NamedTuple):
    """What K3's shard mode reads of a sharded frame: the frontier after
    the eps closure, the rebase's reductions over the ranks, and the
    lattice records or the 1-best backpointer inputs."""

    mid_states: torch.Tensor  # (B, K) int32
    mid_costs: torch.Tensor  # (B, K) float32, relative to the carried base
    best: torch.Tensor  # (B,) float32, the MIN over the ranks of each row's best cost
    num_active: torch.Tensor  # (B,) int32, the SUM over the ranks of the finite costs
    flags: torch.Tensor  # (2,) int32, the MAX over the ranks of (overflow, saturated)
    # Lattice.
    em_records: Optional[torch.Tensor] = None  # (B, R, 4) int32, K2's emitting call's
    eps_records: Optional[torch.Tensor] = None  # (B, D, Re, 2) int32, the closure's links
    # 1-best.
    cand_idx: Optional[torch.Tensor] = None  # (B, K) int32, K6's winning routed lane
    gslot: Optional[torch.Tensor] = None  # (B, N) int32, the routed lanes' global slots
    arc: Optional[torch.Tensor] = None  # (B, N) int32, their global arcs
    bp_eps: Optional[torch.Tensor] = None  # (B, D, K, 2) int32, the closure's
    # The eps closure's local values before the reductions (the next
    # frame's local half of GetCutoff is folded into the tail).
    red_min: Optional[torch.Tensor] = None  # (B,) float32, each row's first smallest cost
    red_count: Optional[torch.Tensor] = None  # (B,) int32, its finite costs


def empty_shard_outs(frames: int, batch: int, k: int, eps_iters: int, lattice: bool,
                     device, em_records: int = 0, eps_records: int = 0):
    """A chunk's stacked outputs of ``frames`` sharded frames (uninitialised)."""
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    b8 = dict(dtype=torch.bool, device=device)
    T, B, K, D = frames, batch, k, eps_iters
    if lattice:
        return ShardLatticeStepOut(
            torch.empty((T, B, em_records, 2), **i32),
            torch.empty((T, B, D, eps_records, 2), **i32),
            torch.empty((T, B, K), **i32), torch.empty((T, B, K), **f32),
            torch.empty((T, B), **i32), torch.empty((T, B), **f32),
            torch.empty((T, B), **b8), torch.empty((T, B), **b8))
    return ShardStepOut(
        torch.empty((T, B, K, 2), **i32), torch.empty((T, B, D, K, 2), **i32),
        torch.empty((T, B), **i32), torch.empty((T, B), **f32), torch.empty((T, B), **f32),
        torch.empty((T, B), **b8), torch.empty((T, B), **b8))


class ShardSlots:
    """The static buffers of a sharded batch's frames on one device: the
    carried frontier ``state``, the chunk's row ``lengths``, K1's scores
    row ``scores_t`` and ``args`` (``csrc/frame.cu`` ShardTable: ``t`` is
    ``args[0]``, the chunk's frame count ``args[2]``, then the pointers of
    its scores and outputs).  ``io`` is the chunk being run (a
    :class:`FrameIO` whose outputs are a :class:`ShardStepOut` or
    :class:`ShardLatticeStepOut`)."""

    def __init__(self, batch: int, k: int, width: int, device):
        dev = torch.device(device)
        self.state = StepState(
            torch.zeros((batch, k), dtype=torch.int32, device=dev),
            torch.full((batch, k), float("inf"), dtype=torch.float32, device=dev),
            torch.zeros((batch,), dtype=torch.float32, device=dev),
        )
        self.lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
        self.scores_t = torch.zeros((batch, width), dtype=torch.float32, device=dev)
        self.args = torch.zeros((SHARD_ARGS_WORDS,), dtype=torch.int64, device=dev)
        self.io: Optional[FrameIO] = None

    def copy(self) -> "ShardSlots":
        """A copy of the slots, every tensor cloned, running the same chunk."""
        out = ShardSlots.__new__(ShardSlots)
        out.state = StepState(*(x.clone() for x in self.state))
        out.lengths, out.scores_t, out.args = (
            x.clone() for x in (self.lengths, self.scores_t, self.args))
        out.io = self.io
        return out


class ShardStart(NamedTuple):
    """What the shard mode's first-frame mode writes into the slots."""

    state: StepState  # the chunk's start state
    lengths: torch.Tensor  # (B,) int32
    scores_t: Optional[torch.Tensor]  # (B, V) scores row 0; None: no frame, the slot kept
    args: torch.Tensor  # (SHARD_ARGS_WORDS,) int64: t 0, done 0, C, the pointers


def frame_start_shard_plain(io: FrameIO) -> ShardStart:
    """The slots of the chunk ``io`` at its start (copies): its start
    state, row lengths and scores row 0, and the table: ``t`` 0, no row
    done, its frame count and the device addresses of its scores and
    stacked outputs (0 for an output of no elements and past the last)."""
    C = io.scores.shape[0]
    words = [0, 0, C, io.scores.data_ptr()] + [x.data_ptr() for x in io.outs]
    words += [0] * (SHARD_ARGS_WORDS - len(words))
    return ShardStart(StepState(*(x.clone() for x in io.st0)), io.lengths.clone(),
                      io.scores[0].clone() if C else None,
                      torch.tensor(words, dtype=torch.int64))


def start_cluster_size(batch: int, k: int) -> int:
    """The blocks a row (a cluster) K3's shard first-frame mode launches
    with for ``batch`` rows of ``k`` slots."""
    return kernels().kd_frame_start_shard_cluster(batch, k)


def _check_local(local: CutoffLocal, B: int, K: int, dev) -> int:
    """Raise unless ``local`` holds K8's local half of B rows of K slots on
    ``dev``; its prefix's m (0 for none)."""
    check(local.best, "local.best", torch.float32, (B,), dev)
    check(local.count, "local.count", torch.int32, (B,), dev)
    if local.prefix is None:
        return 0
    m = local.prefix.shape[1]
    if not 1 <= m < K:
        raise ValueError(f"a prefix of its own takes 1 to {K - 1} costs, not {m}")
    check(local.prefix, "local.prefix", torch.float32, (B, m), dev)
    return m


def frame_start_shard(slots: ShardSlots, io: FrameIO, local: Optional[CutoffLocal] = None,
                      clusters: int = 0) -> None:
    """K3's shard mode's first-frame mode: ``io`` becomes the chunk being
    run, its start state, row lengths and scores row 0 the slots', and its
    frame count, scores and outputs the table's, ``t`` 0; see
    :func:`frame_start_shard_plain`.  With ``local`` (``kernels.cutoff``'s
    ``CutoffLocal`` buffers, its prefix None where the all-gather reads the
    costs), K8's local half of the start state into it too
    (``global_cutoff_local_plain`` of the start costs at m, the prefix's
    width).  On a card one launch of ``csrc/frame.cu`` (a cluster of
    blocks a row; ``clusters``, 8, 4, 2 or 1, sets the blocks a row
    instead of :func:`start_cluster_size`'s choice), counted in
    ``frame_start.launches``."""
    st = slots.state
    dev = st.states.device
    B, K = st.states.shape
    check_clusters(clusters)
    m = _check_local(local, B, K, dev) if local is not None else 0
    if dev.type == "cpu":
        slots.io = io
        want = frame_start_shard_plain(io)
        for dst, src in zip(st, want.state):
            dst.copy_(src)
        slots.lengths.copy_(want.lengths)
        if want.scores_t is not None:
            slots.scores_t.copy_(want.scores_t)
        slots.args.copy_(want.args)
        if local is not None:
            loc = global_cutoff_local_plain(st.costs, m or K)
            for dst, src in zip(local, loc):
                if dst is not None:
                    dst.copy_(src)
        return
    if dev.type != "cuda":
        raise ValueError(f"frame_start_shard runs on cpu or cuda tensors, not {dev}")
    V = slots.scores_t.shape[1]
    C = io.scores.shape[0]
    check(slots.args, "args", torch.int64, (SHARD_ARGS_WORDS,), dev)
    check(slots.lengths, "lengths", torch.int32, (B,), dev)
    check(slots.scores_t, "scores_t", torch.float32, (B, V), dev)
    check(st.costs, "state.costs", torch.float32, (B, K), dev)
    check(st.base, "state.base", torch.float32, (B,), dev)
    check(io.scores, "scores", torch.float32, (C, B, V), dev)
    check(io.lengths, "chunk lengths", torch.int32, (B,), dev)
    for name, x, dtype, shape in zip(("st0.states", "st0.costs", "st0.base"), io.st0,
                                     (torch.int32, torch.float32, torch.float32),
                                     ((B, K), (B, K), (B,))):
        check(x, name, dtype, shape, dev)
    if len(io.outs) > SHARD_OUTS:
        raise ValueError(f"a sharded chunk has at most {SHARD_OUTS} outputs, not {len(io.outs)}")
    for name, x in zip(io.outs._fields, io.outs):
        if x.shape[:2] != (C, B) or x.device != dev or not x.is_contiguous():
            raise ValueError(f"output {name}: expected ({C}, {B}, ...) contiguous on {dev}, "
                             f"got {tuple(x.shape)} on {x.device}")
    outs = [ptr(x) for x in io.outs] + [None] * (SHARD_OUTS - len(io.outs))
    loc = ((ptr(local.best), ptr(local.count),
            ptr(local.prefix) if local.prefix is not None else None)
           if local is not None else (None,) * 3)
    slots.io = io
    rc = kernels().kd_frame_start_shard(
        ptr(slots.args), B, K, V, C, ptr(st.states), ptr(st.costs), ptr(st.base),
        ptr(slots.lengths), ptr(slots.scores_t), ptr(io.st0.states), ptr(io.st0.costs),
        ptr(io.st0.base), ptr(io.lengths), ptr(io.scores), *outs, *loc, m, clusters,
        stream(dev))
    if rc != 0:
        raise RuntimeError(f"kd_frame_start_shard launch failed: {cuda_error(rc)}")
    frame_start.launches += 1


def frame_tail_shard_plain(st: StepState, cutoff: torch.Tensor, tin: ShardTailInputs,
                           frame_active: torch.Tensor, slot_base: int,
                           local: Optional[CutoffLocal] = None):
    """One sharded frame's tail: the rebase by the global best cost (0
    where no rank holds a token), the freeze of rows with ``frame_active``
    False (their state kept, their records -1, their backpointers the
    identity ``(slot_base + k, NO_ARC)``) and the frame's outputs.
    ``st`` is the state the frame started from, ``cutoff`` (B,) its global
    cutoff relative to ``st.base``.  With ``local`` (the local half of
    GetCutoff on ``st``'s costs, its prefix None where the costs are the
    prefix), the next frame's local half too: a live row's best cost
    ``tin.red_min - m_safe``, its count ``tin.red_count`` and its prefix
    the new costs' first m, a frozen row's kept.  Returns (the new state,
    the frame's ``ShardLatticeStepOut`` when ``tin`` has records, else
    ``ShardStepOut``, the next frame's ``CutoffLocal`` or None)."""
    K = tin.mid_states.shape[1]
    fa = frame_active
    m = tin.best
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    final = StepState(
        states=torch.where(fa[:, None], tin.mid_states, st.states),
        costs=torch.where(fa[:, None], tin.mid_costs - m_safe[:, None], st.costs),
        base=torch.where(fa, st.base + m_safe, st.base),
    )
    nxt = None
    if local is not None:
        prefix = local.prefix
        if prefix is not None:
            prefix = torch.where(fa[:, None], final.costs[:, :prefix.shape[1]], prefix)
        nxt = CutoffLocal(torch.where(fa, tin.red_min - m_safe, local.best),
                          torch.where(fa, tin.red_count, local.count), prefix)
    flags = tin.flags > 0
    num_active = torch.where(fa, tin.num_active, 0)
    if tin.em_records is not None:
        out = ShardLatticeStepOut(
            em_records=torch.where(fa[:, None, None], tin.em_records[..., :2], -1),
            eps_records=torch.where(fa[:, None, None, None], tin.eps_records, -1),
            frontier_states=final.states,
            frontier_costs=final.base[:, None] + final.costs,
            num_active=num_active,
            cutoff=st.base + cutoff,
            overflow=fa & flags[0],
            saturated=fa & flags[1],
        )
    else:
        ident = _identity_bp(K, st.states.device)
        ident[:, 0] += slot_base
        out = ShardStepOut(
            bp_emit=torch.where(fa[:, None, None],
                                _backpointers(tin.cand_idx, tin.gslot, tin.arc), ident),
            bp_eps=torch.where(fa[:, None, None, None], tin.bp_eps, ident),
            num_active=num_active,
            best_cost=torch.where(fa, st.base + m_safe, st.base),
            cutoff=st.base + cutoff,
            overflow=fa & flags[0],
            saturated=fa & flags[1],
        )
    return final, out, nxt


def shard_cluster_size(batch: int, k: int) -> int:
    """The blocks a row (a cluster) K3's shard mode launches with for
    ``batch`` rows of ``k`` slots."""
    return kernels().kd_frame_tail_shard_cluster(batch, k)


def frame_tail_shard(slots: ShardSlots, cutoff: torch.Tensor, tin: ShardTailInputs,
                     slot_base: int, clusters: int = 0,
                     local: Optional[CutoffLocal] = None) -> None:
    """K3's shard mode on the slots' device: the tail of frame ``t``
    (``slots.args[0]``) of the chunk ``slots.io`` (begun by
    :func:`frame_start_shard`), in place: the slots' state becomes the new
    state, row t of the chunk's outputs the frame's outputs, the scores
    slot row t + 1 of the chunk's scores, and ``t`` advances.  On a card
    one launch of ``csrc/frame.cu`` (a cluster of blocks a row;
    ``clusters``, 8, 4, 2 or 1, sets the blocks a row instead of
    :func:`shard_cluster_size`'s choice), which reads ``t`` and the chunk's
    tensors from the table, so a captured frame replays as any frame,
    counted in ``frame_tail.launches``; with ``local`` (``kernels.cutoff``'s
    ``CutoffLocal`` buffers, its prefix None where m is K) and
    ``tin.red_min``, ``tin.red_count``, the next frame's local half of
    GetCutoff in place; see :func:`frame_tail_shard_plain`."""
    st = slots.state
    dev = st.states.device
    io = slots.io
    if io is None:
        raise ValueError("frame_tail_shard needs a chunk begun by frame_start_shard")
    if dev.type == "cpu":
        t = int(slots.args[0])
        final, out, nxt = frame_tail_shard_plain(st, cutoff, tin, slots.lengths > t, slot_base,
                                                 local)
        for dst, src in zip(st, final):
            dst.copy_(src)
        for buf, x in zip(io.outs, out):
            buf[t].copy_(x)
        if local is not None:
            for dst, src in zip(local, nxt):
                if dst is not None:
                    dst.copy_(src)
        if t + 1 < io.scores.shape[0]:
            slots.scores_t.copy_(io.scores[t + 1])
        slots.args[0] = t + 1
        return
    if dev.type != "cuda":
        raise ValueError(f"frame_tail_shard runs on cpu or cuda tensors, not {dev}")
    B, K = st.states.shape
    V = slots.scores_t.shape[1]
    check_clusters(clusters)
    check(slots.args, "args", torch.int64, (SHARD_ARGS_WORDS,), dev)
    check(slots.lengths, "lengths", torch.int32, (B,), dev)
    check(slots.scores_t, "scores_t", torch.float32, (B, V), dev)
    check(st.states, "state.states", torch.int32, (B, K), dev)
    check(st.costs, "state.costs", torch.float32, (B, K), dev)
    check(st.base, "state.base", torch.float32, (B,), dev)
    check(cutoff, "cutoff", torch.float32, (B,), dev)
    check(tin.mid_states, "mid_states", torch.int32, (B, K), dev)
    check(tin.mid_costs, "mid_costs", torch.float32, (B, K), dev)
    check(tin.best, "best", torch.float32, (B,), dev)
    check(tin.num_active, "num_active", torch.int32, (B,), dev)
    check(tin.flags, "flags", torch.int32, (2,), dev)
    lattice = tin.em_records is not None
    T = io.outs[0].shape[0]
    N = R = Re = 0
    if lattice:
        R = tin.em_records.shape[1]
        D, Re = tin.eps_records.shape[1:3]
        check(tin.em_records, "em_records", torch.int32, (B, R, 4), dev)
        check(tin.eps_records, "eps_records", torch.int32, (B, D, Re, 2), dev)
        want = empty_shard_outs(T, B, K, D, True, "meta", R, Re)
    else:
        N = tin.gslot.shape[1]
        D = tin.bp_eps.shape[1]
        check(tin.cand_idx, "cand_idx", torch.int32, (B, K), dev)
        check(tin.gslot, "gslot", torch.int32, (B, N), dev)
        check(tin.arc, "arc", torch.int32, (B, N), dev)
        check(tin.bp_eps, "bp_eps", torch.int32, (B, D, K, 2), dev)
        want = empty_shard_outs(T, B, K, D, False, "meta")
    check_like(io.outs, want, "outs", dev)
    check(io.scores, "scores", torch.float32, (T, B, V), dev)
    m = 0
    if local is not None:
        check(tin.red_min, "red_min", torch.float32, (B,), dev)
        check(tin.red_count, "red_count", torch.int32, (B,), dev)
        m = _check_local(local, B, K, dev)

    def opt(x):
        return None if x is None or x.numel() == 0 else ptr(x)

    rc = kernels().kd_frame_tail_shard(
        ptr(slots.args), int(lattice), B, K, N, D, R, Re, V, slot_base,
        ptr(slots.lengths), ptr(st.states), ptr(st.costs), ptr(st.base), ptr(slots.scores_t),
        ptr(cutoff), ptr(tin.mid_states), ptr(tin.mid_costs), ptr(tin.best),
        ptr(tin.num_active), ptr(tin.flags), opt(tin.em_records), opt(tin.eps_records),
        opt(tin.cand_idx), opt(tin.gslot), opt(tin.arc), opt(tin.bp_eps),
        *((ptr(tin.red_min), ptr(tin.red_count), ptr(local.best), ptr(local.count),
           opt(local.prefix)) if local is not None else (None,) * 5), m, clusters, stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_frame_tail_shard launch failed: {cuda_error(rc)}")
    frame_tail.launches += 1
