"""K8: the sharded frame's GetCutoff, cut at its collectives.

``parallel/graph_shard.py:_global_cutoff`` reduces each row's best cost
(MIN) over the model group and, where max_active or min_active can bind,
its finite count (SUM) and gathers every shard's cost prefix; around
those collectives it runs the two halves here:

- :func:`global_cutoff_local` (before them): each row's smallest finite
  cost (its first smallest in slot order, the bits of that slot; +inf for
  a row with none), its count of finite costs (int32), and its prefix
  ``costs[:, :m]`` in a contiguous buffer that the all-gather reads.  It
  runs on a chunk's start state only: every later frame's local half is
  written by the frame before's K3 shard mode
  (``kernels.frame.frame_tail_shard``, its ``local``), from the eps
  closure's local values, and where ``m`` is K the all-gather reads the
  costs themselves;
- :func:`global_cutoff_merge` (after them): the order statistics at
  ``max_active`` and ``min_active`` of the gathered prefixes ``(P, B,
  m)``, merged as one stable sort in shard order with -0.0 and +0.0 equal
  (indices clamped to ``P*m - 1``), then GetCutoff's three-way branch and
  the adaptive beam in float32 (``ops/cutoff.py``); with ``merged`` None
  (neither bound can bind) ``best + beam`` and the full beam.

On CPU tensors the wrappers run the plain torch versions,
:func:`global_cutoff_local_plain` and :func:`global_cutoff_merge_plain`;
on CUDA tensors they launch ``csrc/cutoff.cu`` or raise.  On a card the
merge reads each shard's prefix as sorted, as the frontier's select
leaves it (by IEEE total order, so by the canonical key too).  Each
wrapper takes ``out=`` buffers (:func:`empty_cutoff_local`,
:func:`empty_cutoff`) sized once a decode.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)

INF = float("inf")


class CutoffLocal(NamedTuple):
    """The local half's values, which the collectives reduce and gather."""

    best: torch.Tensor  # (B,) float32: the row's first smallest finite cost, or +inf
    count: torch.Tensor  # (B,) int32: the row's finite costs
    prefix: Optional[torch.Tensor]  # (B, m) float32: the row's first m costs (or None)


class GlobalCutoff(NamedTuple):
    cutoff: torch.Tensor  # (B,) float32
    adaptive_beam: torch.Tensor  # (B,) float32


def first_min_count(costs: torch.Tensor):
    """Each row of ``costs`` (B, K): its first smallest finite cost in slot
    order, that slot's bits (+inf for a row with none; ``argmin`` takes
    the first, where ``amin`` leaves open which of -0.0 and +0.0 it
    returns), and its count of finite costs (int32)."""
    masked = torch.where(torch.isfinite(costs), costs, INF)
    best = masked.gather(1, masked.argmin(dim=1, keepdim=True))[:, 0]
    return best, torch.isfinite(costs).sum(dim=1, dtype=torch.int32)


def global_cutoff_local_plain(costs: torch.Tensor, m: int) -> CutoffLocal:
    """The local half of ``costs`` (B, K) (:func:`first_min_count`, the
    prefix copied)."""
    best, count = first_min_count(costs)
    return CutoffLocal(best, count, costs[:, :m].clone(memory_format=torch.contiguous_format))


def global_cutoff_merge_plain(best: torch.Tensor, count: Optional[torch.Tensor],
                              merged: Optional[torch.Tensor], beam: float, beam_delta: float,
                              max_active: int, min_active: int) -> GlobalCutoff:
    """GetCutoff over the union of the shards' frontiers: ``best`` and
    ``count`` reduced over the shards, ``merged`` (P, B, m) their
    gathered prefixes (each a shard's m smallest costs: the global n-th
    smallest lies within the union of the n+1-prefixes), read off one
    stable sort keyed with -0.0 and +0.0 equal, as the original's sort
    compares them; ``merged`` None: ``best + beam`` and the full beam."""
    beam_cutoff = best + beam
    if merged is None:
        return GlobalCutoff(beam_cutoff, torch.full_like(best, beam))
    P, B, m = merged.shape
    merged = merged.permute(1, 0, 2).reshape(B, P * m)
    order = torch.sort(torch.where(merged == 0, 0.0, merged), dim=1, stable=True).indices
    merged = merged.gather(1, order)
    PM = P * m
    max_cut = torch.where(count > max_active, merged[:, min(max_active, PM - 1)], INF)
    min_cut = torch.where(
        count > min_active,
        best if min_active == 0 else merged[:, min(min_active, PM - 1)],
        INF,
    )
    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)
    cutoff = torch.where(use_max, max_cut, torch.where(use_min, min_cut, beam_cutoff))
    adaptive = torch.where(
        use_max,
        max_cut - best + beam_delta,
        torch.where(use_min, min_cut - best + beam_delta, beam),
    ).to(torch.float32)
    return GlobalCutoff(cutoff, adaptive)


def empty_cutoff_local(batch: int, m: int, device) -> CutoffLocal:
    """Uninitialised output buffers of :func:`global_cutoff_local`."""
    f32 = dict(dtype=torch.float32, device=device)
    return CutoffLocal(torch.empty((batch,), **f32),
                       torch.empty((batch,), dtype=torch.int32, device=device),
                       torch.empty((batch, m), **f32))


def empty_cutoff(batch: int, device) -> GlobalCutoff:
    """Uninitialised output buffers of :func:`global_cutoff_merge`."""
    return GlobalCutoff(*(torch.empty((batch,), dtype=torch.float32, device=device)
                          for _ in range(2)))


def global_cutoff_local(costs: torch.Tensor, m: int,
                        out: Optional[CutoffLocal] = None) -> CutoffLocal:
    """K8's local half on ``costs``' device: :func:`global_cutoff_local_plain`
    on the CPU, one launch of ``csrc/cutoff.cu`` on a card (a block a row),
    into ``out`` (from :func:`empty_cutoff_local`; its prefix None: no
    prefix copied) when given.  ``global_cutoff_local.launches`` counts its
    launches."""
    dev = costs.device
    if dev.type == "cpu":
        return global_cutoff_local_plain(costs, m)
    if dev.type != "cuda":
        raise ValueError(f"global_cutoff_local runs on cpu or cuda tensors, not {dev}")
    B, K = costs.shape
    if not 1 <= m <= K:
        raise ValueError(f"the prefix takes 1 to {K} costs, not {m}")
    check(costs, "costs", torch.float32, (B, K), dev)
    if out is None:
        out = empty_cutoff_local(B, m, dev)
    else:
        want = empty_cutoff_local(B, m, "meta")
        check_like(out, want if out.prefix is not None else want._replace(prefix=None), "out",
                   dev)
    rc = kernels().kd_cutoff_local(ptr(costs), B, K, m, ptr(out.best), ptr(out.count),
                                   ptr(out.prefix) if out.prefix is not None else None,
                                   stream(dev))
    if rc != 0:
        raise RuntimeError(f"kd_cutoff_local launch failed: {cuda_error(rc)}")
    global_cutoff_local.launches += 1
    return out


global_cutoff_local.launches = 0


def global_cutoff_merge(best: torch.Tensor, count: Optional[torch.Tensor],
                        merged: Optional[torch.Tensor], beam: float, beam_delta: float,
                        max_active: int, min_active: int,
                        out: Optional[GlobalCutoff] = None) -> GlobalCutoff:
    """K8's merge on ``best``'s device: :func:`global_cutoff_merge_plain`
    on the CPU, one launch of ``csrc/cutoff.cu`` on a card (a block a
    row), into ``out`` (from :func:`empty_cutoff`) when given.
    ``global_cutoff_merge.launches`` counts its launches."""
    dev = best.device
    if dev.type == "cpu":
        return global_cutoff_merge_plain(best, count, merged, beam, beam_delta, max_active,
                                         min_active)
    if dev.type != "cuda":
        raise ValueError(f"global_cutoff_merge runs on cpu or cuda tensors, not {dev}")
    (B,) = best.shape
    check(best, "best", torch.float32, (B,), dev)
    if (count is None) != (merged is None):
        raise ValueError("count and merged come together")
    P = m = 0
    if merged is not None:
        P, _, m = merged.shape
        check(merged, "merged", torch.float32, (P, B, m), dev)
        check(count, "count", torch.int32, (B,), dev)
        if P < 1 or m < 1:
            raise ValueError(f"merged must hold a cost a row, not {tuple(merged.shape)}")
    if not (0 <= max_active < 1 << 31 and 0 <= min_active < 1 << 31):
        raise ValueError(f"max_active {max_active} and min_active {min_active} must be int32s "
                         "at least 0")
    if out is None:
        out = empty_cutoff(B, dev)
    else:
        check_like(out, empty_cutoff(B, "meta"), "out", dev)
    rc = kernels().kd_cutoff_merge(
        ptr(best), ptr(count) if count is not None else None,
        ptr(merged) if merged is not None else None, B, P, m, max_active, min_active,
        ctypes.c_float(beam), ctypes.c_float(beam_delta), ptr(out.cutoff), ptr(out.adaptive_beam),
        stream(dev))
    if rc != 0:
        raise RuntimeError(f"kd_cutoff_merge launch failed: {cuda_error(rc)}")
    global_cutoff_merge.launches += 1
    return out


global_cutoff_merge.launches = 0
