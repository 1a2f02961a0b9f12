"""K2: the lattice frame's dedup by state, top-K frontier and records.

:func:`dedup_select_rec` is the lattice path's two calls of
:func:`kaldi_decoder_tpu_torch.ops.segment.dedup_select_rec` (payload
``(src_state, arc_id)``): the emitting stage's, with no incumbents, and
each eps iteration's, whose first ``num_incumbents`` lanes are the carried
tokens and which also gives each slot's winning lane.  The records come
as one (B, R, 4) int32 array of rows ``[src_state, arc_id, dst_state,
slack_bits]``.  On a CPU tensor it runs the plain version and stacks its
columns; on a CUDA tensor it launches ``csrc/dedup_rec.cu`` (the eps call
in the kernel's incumbents instance) or raises.

K2 shares K6's winner table (:mod:`kaldi_decoder_tpu_torch.kernels.dedup`),
kept per device and stream, and leaves it all ones as K6 does.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from kaldi_decoder_tpu_torch.kernels import dedup as k6
from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)
from kaldi_decoder_tpu_torch.ops.segment import SelectionRec
from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain


class LatticeSelection(NamedTuple):
    states: torch.Tensor  # (B, K) int32 — new frontier, cost-sorted
    costs: torch.Tensor  # (B, K) float32 — +inf for empty slots
    num_unique: torch.Tensor  # (B,) int32 — distinct in-beam states
    records: torch.Tensor  # (B, R, 4) int32 — [src_state, arc_id, dst, slack bits], -1 padded
    rec_overflow: torch.Tensor  # (B,) bool — eligible links exceeded R
    # (B, K) int32 winning lane per slot, -1 if empty; the eps call's only.
    cand_idx: Optional[torch.Tensor] = None


def stack_records(sel: SelectionRec) -> torch.Tensor:
    """The plain version's record columns as (B, R, 4) rows: the payload
    columns, ``rec_dst`` and the bits of ``rec_slack``."""
    return torch.stack(sel.recs + (sel.rec_dst, sel.rec_slack.view(torch.int32)), dim=-1)


def empty_lattice_selection(batch: int, k: int, r: int, device,
                            with_cand_idx: bool = False) -> LatticeSelection:
    """Uninitialised output buffers of K2 (``dedup_select_rec``'s ``out``);
    ``with_cand_idx`` for the eps call's."""
    i32 = dict(dtype=torch.int32, device=device)
    return LatticeSelection(
        states=torch.empty((batch, k), **i32),
        costs=torch.empty((batch, k), dtype=torch.float32, device=device),
        num_unique=torch.empty((batch,), **i32),
        records=torch.empty((batch, r, 4), **i32),
        rec_overflow=torch.empty((batch,), dtype=torch.bool, device=device),
        cand_idx=torch.empty((batch, k), **i32) if with_cand_idx else None,
    )


def dedup_select_rec(
    cand_state: torch.Tensor,  # (B, N) int32
    cand_cost: torch.Tensor,  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
    r: int,
    slack_beam: float,
    payload: Tuple[torch.Tensor, ...],  # (src_state, arc_id), each (B, N) int32
    num_incumbents: int = 0,
    out: Optional[LatticeSelection] = None,
    scratch=None,
) -> LatticeSelection:
    """K2 on the tensors' device.  Finite lanes must have a state in
    ``[0, num_states)``; ``slack_beam`` is compared in float32, as the
    plain version compares it.  With ``num_incumbents`` the first lanes
    are carried tokens, never records, and ``cand_idx`` is given.  On a
    card, ``out`` (from :func:`empty_lattice_selection`) and ``scratch``
    (``kernels.dedup.empty_scratch(B, N, device, pairs=4)``) are used
    instead of fresh buffers, so that a captured frame allocates nothing.
    ``dedup_select_rec.launches`` counts K2 launches."""
    dev = cand_state.device
    if dev.type == "cpu":
        sel = dedup_select_rec_plain(cand_state, cand_cost, k, num_states, r, slack_beam, payload,
                                     num_incumbents)
        return LatticeSelection(sel.states, sel.costs, sel.num_unique, stack_records(sel),
                                sel.rec_overflow, sel.cand_idx)
    if dev.type != "cuda":
        raise ValueError(f"dedup_select_rec runs on cpu or cuda tensors, not {dev}")
    if len(payload) != 2:
        raise ValueError(f"K2 records two payload columns (src_state, arc_id), got {len(payload)}")
    B, N = cand_cost.shape
    check(cand_state, "cand_state", torch.int32, (B, N), dev)
    check(cand_cost, "cand_cost", torch.float32, (B, N), dev)
    for i, p in enumerate(payload):
        check(p, f"payload[{i}]", torch.int32, (B, N), dev)
    lib = kernels()
    table, key = k6._held_table(dev, B, num_states)
    # Scratch rows: N and the pad the kernel's spill regions round up to.
    if scratch is None:
        scratch = k6.empty_scratch(B, N, dev, pairs=4)
    else:
        k6.check_scratch(scratch, B, N, dev, pairs=4)
    keys, vals = scratch[:4], scratch[4:]
    if out is None:
        out = empty_lattice_selection(B, k, r, dev, bool(num_incumbents))
    else:
        check_like(out, empty_lattice_selection(B, k, r, "meta", bool(num_incumbents)), "out",
                   dev)
    rc = lib.kd_dedup_rec(
        ptr(cand_state), ptr(cand_cost), ptr(payload[0]), ptr(payload[1]),
        B, N, num_states, k, r, ctypes.c_float(slack_beam), num_incumbents, ptr(table),
        ptr(keys[0]), ptr(vals[0]), ptr(keys[1]), ptr(vals[1]),
        ptr(keys[2]), ptr(vals[2]), ptr(keys[3]), ptr(vals[3]),
        ptr(out.states), ptr(out.costs), ptr(out.num_unique), ptr(out.records),
        ptr(out.rec_overflow), ptr(out.cand_idx) if num_incumbents else None, stream(dev),
    )
    if rc != 0:
        k6._held.pop(key, None)  # a launch may have run: the next call starts afresh
        raise RuntimeError(f"kd_dedup_rec launch failed: {cuda_error(rc)}")
    dedup_select_rec.launches += 1
    return out


dedup_select_rec.launches = 0


def cluster_size(batch: int, lanes: int) -> int:
    """The blocks per cluster K2 launches with for ``batch`` utterances of
    ``lanes`` candidate lanes each (0: none fits)."""
    return kernels().kd_dedup_rec_cluster(batch, lanes)


# The kernel's steps, between its 24 marks (csrc/dedup_rec.cu); the
# record steps are marked only when R > K.
STEPS = k6.STEPS + ("c_K barrier", "record pass", "bin barrier", "restore and bin merge",
                    "second bin barrier", "record histogram", "record histogram barrier",
                    "record bucket starts", "record scatter pass", "record scatter barrier",
                    "record ranks", "record padding")


def cluster_steps(batch: int, lanes: int) -> dict:
    """:func:`kaldi_decoder_tpu_torch.kernels.dedup.cluster_steps` of the
    last K2 launch."""
    return k6.cluster_steps(batch, lanes, cluster_size(batch, lanes), "kd_dedup_rec_marks",
                            STEPS)
