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
from kaldi_decoder_tpu_torch.kernels._build import check, cuda_error, kernels, ptr, stream
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

# csrc/frame.cu FrameArgs: t, frames, done, scores, lengths, then the
# nine output pointers, each one int64 word.
ARGS_WORDS = 14
OUTS = 9


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
    outs: Union[LatticeStepOut, StepOut]  # (C, B, ...) each


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


def frame_tail(slots: FrameSlots, tin: TailInputs, fc: FrontierConfig) -> None:
    """K3 on the slots' device: the tail of frame ``t`` (``slots.args[0]``)
    of the chunk ``slots.io``, in place; see :func:`frame_tail_plain`.  On
    a card ``t`` is read and advanced on the device, so a captured frame
    replays as any frame.  ``frame_tail.launches`` counts K3 launches."""
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
        opt(tin.arc_id), opt(tin.bp_eps), stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_frame_tail launch failed: {cuda_error(rc)}")
    frame_tail.launches += 1


frame_tail.launches = 0
