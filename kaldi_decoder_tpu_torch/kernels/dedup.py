"""K6: Viterbi dedup by state and top-K frontier selection.

:func:`dedup_select` keeps each state's cheapest candidate lane (the
lowest lane among equal costs) and the K cheapest states in (cost, state)
order, with each slot's winning lane.  On a CPU tensor it runs the plain
torch version, :func:`kaldi_decoder_tpu_torch.ops.segment.dedup_select`;
on a CUDA tensor it launches ``csrc/dedup.cu`` or raises.

The kernel's per-state winner table ((B, S) 64-bit words, all ones) comes
back from every call as it went in: each state's winner restores its
word.  So it is made once per device and stream (:func:`_held_table`) and
not filled per call; calls on one stream run in order, so they never
share it at once.

A sharded frame without eps iterations hands its emitting call
``reduce=(carry, em_overflow)``: the call then also writes the frame's
local values into the ``kernels.eps.ShardEpsCarry`` (each row's first
smallest finite cost and finite count, the batch's flag pair), on the CPU
by :func:`eps_reduce_shard_plain` after the plain call, on a card
as the kernel's last step (``csrc/shard_reduce.cuh``); K2's wrapper takes
it the same way (:func:`shard_reduce`).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_clusters,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)
from kaldi_decoder_tpu_torch.kernels.cutoff import first_min_count
from kaldi_decoder_tpu_torch.kernels.route import RoutedLanes, routed_args, routed_lanes_plain
from kaldi_decoder_tpu_torch.ops.segment import Selection
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

SCRATCH_PAD = 256  # csrc/dedup.cu: SCRATCH_PAD
MAX_REDUCE_ROWS = (1 << 16) - 1  # csrc/shard_reduce.cuh: MAX_ROWS

# (device index, stream) -> the winner table, at least as large as the
# largest call seen on that stream.
_held: dict = {}


def _held_table(dev: torch.device, B: int, S: int):
    """The winner table (>= B*S int64, all ones) kept for the current
    stream of ``dev``, and its key in the cache."""
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    table = _held.get(key)
    if table is None or table.numel() < B * S:
        table = _held[key] = torch.full((B * S,), -1, dtype=torch.int64, device=dev)
    return table, key


def empty_selection(batch: int, k: int, device) -> Selection:
    """Uninitialised output buffers of K6 (``dedup_select``'s ``out``)."""
    i32 = dict(dtype=torch.int32, device=device)
    return Selection(
        states=torch.empty((batch, k), **i32),
        costs=torch.empty((batch, k), dtype=torch.float32, device=device),
        cand_idx=torch.empty((batch, k), **i32),
        num_unique=torch.empty((batch,), **i32),
    )


def empty_scratch(batch: int, lanes: int, device, pairs: int = 2):
    """K6's (``pairs`` = 2) or K2's (4) scratch rows for ``batch`` rows of
    ``lanes`` lanes: a tuple of ``pairs`` int64 key rows, then as many
    int32 value rows, each (batch, lanes + SCRATCH_PAD)."""
    shape = (batch, lanes + SCRATCH_PAD)
    return (tuple(torch.empty(shape, dtype=torch.int64, device=device) for _ in range(pairs))
            + tuple(torch.empty(shape, dtype=torch.int32, device=device) for _ in range(pairs)))


def check_scratch(scratch, batch: int, lanes: int, device, pairs: int = 2) -> None:
    """Raise unless ``scratch`` is :func:`empty_scratch`'s layout."""
    if len(scratch) != 2 * pairs:
        raise ValueError(f"scratch: expected {2 * pairs} rows, got {len(scratch)}")
    for i, x in enumerate(scratch):
        check(x, f"scratch[{i}]", torch.int64 if i < pairs else torch.int32,
              (batch, lanes + SCRATCH_PAD), device)


class ReduceArgs(ctypes.Structure):
    """A sharded frame's local values as the emitting dedup calls write
    them (``csrc/shard_reduce.cuh`` Reduce)."""

    _fields_ = [("em_ovf", ctypes.c_void_p * 3)] + [
        (name, ctypes.c_void_p) for name in ("red_min", "red_count", "red_flags", "count")]


def _reduce_parts(reduce):
    """(carry, em_overflow) of a dedup call's ``reduce``, its flags checked
    in number."""
    carry, em_overflow = reduce
    if not 1 <= len(em_overflow) <= 3:
        raise ValueError(f"one to three emitting overflow flags, not {len(em_overflow)}")
    return carry, tuple(em_overflow)


def eps_reduce_shard_plain(carry, costs: torch.Tensor, em_overflow,
                           em_num_unique: torch.Tensor) -> None:
    """The frame's local values of a sharded closure of no iterations (D =
    0: no eps step writes them) into ``carry`` (a
    ``kernels.eps.ShardEpsCarry``): ``red_min`` and
    ``red_count`` of ``costs`` (B, K), the frontier of the emitting dedup
    call (``kernels.cutoff.first_min_count``), and ``red_flags`` the
    emitting call's overflow (any of the ``em_overflow`` flags, (B,) bool
    each, in any row) and saturation (any ``em_num_unique > K``).  On a
    card the emitting call writes them as its last step
    (:func:`shard_reduce`)."""
    K = costs.shape[1]
    red_min, red_count = first_min_count(costs)
    carry.red_min.copy_(red_min)
    carry.red_count.copy_(red_count)
    ovf = torch.stack([x.any() for x in em_overflow]).any()
    carry.red_flags.copy_(torch.stack([ovf, (em_num_unique > K).any()]).to(torch.int32))



def reduce_plain(reduce, costs: torch.Tensor, num_unique: torch.Tensor, own=()) -> None:
    """The CPU side of an emitting call's ``reduce``: the frame's local
    values of its frontier (``costs``, ``num_unique``) by
    :func:`eps_reduce_shard_plain`, the call's ``own`` overflow flags
    beside the given ones."""
    carry, em_overflow = _reduce_parts(reduce)
    eps_reduce_shard_plain(carry, costs, em_overflow + tuple(own), num_unique)


def shard_reduce(reduce, batch: int, dev) -> ReduceArgs:
    """The kernels' :class:`ReduceArgs` of an emitting call's ``reduce``
    (``(carry, em_overflow)``: a ``kernels.eps.ShardEpsCarry`` and one to
    three (B,) bool flags), checked.  ``shard_reduce.launches`` counts the
    dedup launches that write them (each is counted as a K6 or K2 launch
    too)."""
    carry, em_overflow = _reduce_parts(reduce)
    if batch > MAX_REDUCE_ROWS:
        raise ValueError(f"the local values take at most {MAX_REDUCE_ROWS} rows, not {batch}")
    for i, x in enumerate(em_overflow):
        check(x, f"em_overflow[{i}]", torch.bool, (batch,), dev)
    check(carry.red_min, "carry.red_min", torch.float32, (batch,), dev)
    check(carry.red_count, "carry.red_count", torch.int32, (batch,), dev)
    check(carry.red_flags, "carry.red_flags", torch.int32, (2,), dev)
    check(carry.red_done, "carry.red_done", torch.int64, (1,), dev)
    em = [x.data_ptr() for x in em_overflow] + [None] * (3 - len(em_overflow))
    return ReduceArgs((ctypes.c_void_p * 3)(*em), carry.red_min.data_ptr(),
                      carry.red_count.data_ptr(), carry.red_flags.data_ptr(),
                      carry.red_done.data_ptr())


shard_reduce.launches = 0


def dedup_select(
    cand_state: Optional[torch.Tensor],  # (B, N) int32
    cand_cost: Optional[torch.Tensor],  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
    out: Optional[Selection] = None,
    scratch=None,
    step=None,
    routed: Optional[RoutedLanes] = None,
    reduce=None,
    clusters: int = 0,
) -> Selection:
    """K6 on the tensors' device.  Finite lanes must have a state in
    ``[0, num_states)``.  On a card, ``out`` (from
    :func:`empty_selection`) and ``scratch`` (from :func:`empty_scratch`)
    are used instead of fresh buffers, so that a captured frame allocates
    nothing, and ``step`` (``kernels.eps.StepArgs``, from
    ``kernels.eps.eps_dedup``, which checks it) makes the call run the eps
    step as its last step.  With ``routed`` (a sharded eps call's lanes,
    ``cand_state`` and ``cand_cost`` None) the lanes are its
    (:func:`kaldi_decoder_tpu_torch.kernels.route.routed_lanes_plain` on
    the CPU; read in place on a card).  With ``reduce`` (an emitting
    call's: no step, no routed lanes) the call also writes a sharded
    frame's local values (:func:`shard_reduce`; :func:`reduce_plain` on
    the CPU); ``clusters`` (8, 4, 2 or 1, at most what the lanes allow)
    then sets the blocks a row instead of :func:`cluster_size`'s choice.
    ``dedup_select.launches`` counts K6 launches."""
    check_clusters(clusters)
    if clusters and reduce is None:
        raise ValueError("clusters is set on a call with reduce only")
    if reduce is not None and (routed is not None or step is not None):
        raise ValueError("the local values are an emitting call's: no step, no routed lanes")
    if routed is not None:
        if cand_state is not None or cand_cost is not None or step is not None:
            raise ValueError("routed lanes come alone, with no step")
        dev = routed.recv.device
        if dev.type == "cpu":
            lanes = routed_lanes_plain(routed)
            return dedup_select_plain(lanes.state_local, lanes.cost, k, num_states)
        B, N = routed.recv.shape[1], routed.lanes
    else:
        dev = cand_state.device
        if dev.type == "cpu":
            if step is not None:
                raise ValueError("the eps step runs inside K6 on a card only: on the CPU call "
                                 "kernels.eps.eps_dedup")
            sel = dedup_select_plain(cand_state, cand_cost, k, num_states)
            if reduce is not None:
                reduce_plain(reduce, sel.costs, sel.num_unique)
            return sel
        B, N = cand_cost.shape
    if dev.type != "cuda":
        raise ValueError(f"dedup_select runs on cpu or cuda tensors, not {dev}")
    if routed is not None:
        rargs = routed_args(routed)
    else:
        check(cand_state, "cand_state", torch.int32, (B, N), dev)
        check(cand_cost, "cand_cost", torch.float32, (B, N), dev)
    rd = shard_reduce(reduce, B, dev) if reduce is not None else None
    lib = kernels()
    table, key = _held_table(dev, B, num_states)
    # Scratch rows: N and the pad the kernel's spill regions round up to.
    if scratch is None:
        scratch = empty_scratch(B, N, dev)
    else:
        check_scratch(scratch, B, N, dev)
    keys0, keys1, vals0, vals1 = scratch
    if out is None:
        out = empty_selection(B, k, dev)
    else:
        check_like(out, empty_selection(B, k, "meta"), "out", dev)
    rc = lib.kd_dedup(
        None if routed is not None else ptr(cand_state),
        None if routed is not None else ptr(cand_cost), B, N, num_states, k,
        ptr(table), ptr(keys0), ptr(vals0), ptr(keys1), ptr(vals1),
        ptr(out.states), ptr(out.costs), ptr(out.cand_idx), ptr(out.num_unique),
        ctypes.c_void_p(ctypes.addressof(rargs)) if routed is not None else None,
        ctypes.c_void_p(ctypes.addressof(step)) if step is not None else None,
        ctypes.c_void_p(ctypes.addressof(rd)) if rd is not None else None, clusters, stream(dev),
    )
    if rc != 0:
        _held.pop(key, None)  # a launch may have run: the next call starts afresh
        raise RuntimeError(f"kd_dedup launch failed: {cuda_error(rc)}")
    dedup_select.launches += 1
    if rd is not None:
        shard_reduce.launches += 1
    return out


dedup_select.launches = 0


def cluster_size(batch: int, lanes: int, step: bool = False, routed: bool = False) -> int:
    """The blocks per cluster K6 launches with for ``batch`` utterances of
    ``lanes`` candidate lanes each, with the eps step as its last step
    (``step``, the fused eps call), on routed lanes (``routed``, a sharded
    eps call) or neither (0: none fits)."""
    return kernels().kd_dedup_cluster(batch, lanes, int(step), int(routed))


# The kernel's steps, between its 12 marks (csrc/dedup.cu, select_core.cuh).
STEPS = ("min pass", "min barrier", "range", "winner pass", "winner sync", "histogram barrier",
         "bucket starts", "scatter pass", "scatter barrier", "ranks", "padding")
MARKS = 24  # csrc/select_core.cuh: MARKS


def launch_marks(blocks: int, reader: str = "kd_dedup_marks", steps=STEPS) -> list:
    """For each of the last launch's first ``blocks`` blocks (at most
    1024; blocks ``c*C .. c*C + C-1`` are utterance c's cluster): its start
    and end in µs of the global timer from the earliest start, and its time
    per step in µs at the SM's rated clock (``steps`` in order; the
    histogram step is mostly the wait at the cluster barrier, "ranks"
    holds any later level, K2's sorts of crowded buckets and writing the
    slots).  ``reader`` is the library function that reads the kernel's
    marks (K6's by default).  Synchronises with the
    device."""
    n = min(blocks, 1024)
    ns = (ctypes.c_ulonglong * (2 * n))()
    clock = (ctypes.c_longlong * (MARKS * n))()
    khz = ctypes.c_int()
    rc = getattr(kernels(), reader)(ctypes.byref(ns), ctypes.byref(clock), ctypes.byref(khz), n)
    if rc != 0:
        raise RuntimeError(f"{reader} failed: {cuda_error(rc)}")
    t0 = min(ns[0::2])
    out = []
    for i in range(n):
        c = clock[MARKS * i: MARKS * i + len(steps) + 1]
        times = {name: (c[j + 1] - c[j]) * 1e3 / khz.value for j, name in enumerate(steps)}
        out.append(dict(start_us=(ns[2 * i] - t0) / 1e3, end_us=(ns[2 * i + 1] - t0) / 1e3,
                        steps_us=times))
    return out


def cluster_steps(batch: int, lanes: int, clusters: int = 0, reader: str = "kd_dedup_marks",
                  steps=STEPS) -> dict:
    """The last launch's clusters (it had ``batch`` utterances of ``lanes``
    lanes, in clusters of ``clusters`` blocks, K6's size by default): their
    size, each one's end in µs from the first block's start, the slowest
    one's utterance and the split of its first block into ``steps``.
    Synchronises with the device."""
    C = clusters or cluster_size(batch, lanes)
    marks = launch_marks(batch * C, reader, steps)
    ends = [max(m["end_us"] for m in marks[c * C:(c + 1) * C]) for c in range(batch)]
    slow = max(range(batch), key=lambda c: ends[c])
    return dict(clusters=C, ends_us=ends, slowest=slow, steps_us=marks[slow * C]["steps_us"])
