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
"""

from __future__ import annotations

from typing import Optional

import torch

from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)
from kaldi_decoder_tpu_torch.ops.segment import Selection
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

SCRATCH_PAD = 256  # csrc/dedup.cu: SCRATCH_PAD

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


def dedup_select(
    cand_state: torch.Tensor,  # (B, N) int32
    cand_cost: torch.Tensor,  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
    out: Optional[Selection] = None,
    scratch=None,
) -> Selection:
    """K6 on the tensors' device.  Finite lanes must have a state in
    ``[0, num_states)``.  On a card, ``out`` (from
    :func:`empty_selection`) and ``scratch`` (from :func:`empty_scratch`)
    are used instead of fresh buffers, so that a captured frame allocates
    nothing.  ``dedup_select.launches`` counts K6 launches."""
    dev = cand_state.device
    if dev.type == "cpu":
        return dedup_select_plain(cand_state, cand_cost, k, num_states)
    if dev.type != "cuda":
        raise ValueError(f"dedup_select runs on cpu or cuda tensors, not {dev}")
    B, N = cand_cost.shape
    check(cand_state, "cand_state", torch.int32, (B, N), dev)
    check(cand_cost, "cand_cost", torch.float32, (B, N), dev)
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
        ptr(cand_state), ptr(cand_cost), B, N, num_states, k,
        ptr(table), ptr(keys0), ptr(vals0), ptr(keys1), ptr(vals1),
        ptr(out.states), ptr(out.costs), ptr(out.cand_idx), ptr(out.num_unique),
        stream(dev),
    )
    if rc != 0:
        _held.pop(key, None)  # a launch may have run: the next call starts afresh
        raise RuntimeError(f"kd_dedup launch failed: {cuda_error(rc)}")
    dedup_select.launches += 1
    return out


dedup_select.launches = 0


def cluster_size(batch: int, lanes: int) -> int:
    """The blocks per cluster K6 launches with for ``batch`` utterances of
    ``lanes`` candidate lanes each (0: none fits)."""
    return kernels().kd_dedup_cluster(batch, lanes)


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
    import ctypes

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
