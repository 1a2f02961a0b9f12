"""K1: emitting arc expansion with the acoustic lookup and the beam filter.

:func:`expand_filter` is the frame's expansion region: the active slots
of a cost-sorted frontier (cost < cutoff) expand into candidate lanes
with cost ``(alpha + w) + (-score)``, and lanes at or above
``min(cost) + adaptive_beam`` are set to +inf.  With ``with_src_slot`` it
also gives each lane's source frontier slot (the Viterbi backpointer's
first half); the lattice path leaves it out.  On a CPU tensor it runs
the plain torch version, :func:`expand_filter_plain`; on a CUDA tensor it
launches ``csrc/expand.cu`` or raises.  The kernel reads each active
slot's ``em_block`` row itself (the reference's row gather, folded into
the launch) and never reads the state of an inactive slot.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepState,
    expand_emitting,
)
from kaldi_decoder_tpu_torch.fst.pack import EM_FIELDS, PackedGraph
from kaldi_decoder_tpu_torch.kernels._build import check, cuda_error, kernels, ptr, stream

INF = float("inf")


class Expansion(NamedTuple):
    dst: torch.Tensor  # (B, N) int32
    cost: torch.Tensor  # (B, N) float32, +inf outside the beam
    src_state: torch.Tensor  # (B, N) int32
    arc_id: torch.Tensor  # (B, N) int32
    overflow: torch.Tensor  # (B,) bool — remainder lane budget exceeded
    next_cutoff: torch.Tensor  # (B,) float32 — min(cost) + adaptive_beam
    src_slot: Optional[torch.Tensor] = None  # (B, N) int32 with with_src_slot


def expand_filter_plain(
    states: torch.Tensor,  # (B, K) int32, cost-sorted frontier
    costs: torch.Tensor,  # (B, K) float32, relative costs
    cutoff: torch.Tensor,  # (B,) float32 — expand slots with cost < cutoff
    adaptive_beam: torch.Tensor,  # (B,) float32
    scores_t: torch.Tensor,  # (B, V) float32
    pg: PackedGraph,
    fc: FrontierConfig,
    with_src_slot: bool = False,
) -> Expansion:
    active = torch.isfinite(costs) & (costs < cutoff[:, None])
    cand = expand_emitting(StepState(states, costs, None), active, scores_t, pg, fc)
    next_cutoff = cand.cost.amin(dim=1) + adaptive_beam
    keep = torch.isfinite(cand.cost) & (cand.cost < next_cutoff[:, None])
    return Expansion(
        dst=cand.dst,
        cost=torch.where(keep, cand.cost, INF),
        src_state=cand.src_state,
        arc_id=cand.arc_id,
        overflow=cand.overflow,
        next_cutoff=next_cutoff,
        src_slot=cand.src_slot if with_src_slot else None,
    )


def remainder_units(states, costs, cutoff, pg: PackedGraph, fc: FrontierConfig) -> torch.Tensor:
    """(B,) int64: the em_flat units the active slots' remainder arcs ask
    for (the ``total`` of the expansion's scan; more than
    ``fc.rem_units`` means overflow)."""
    KE, W, G = fc.expand_lanes, fc.block_width, fc.flat_group
    c = costs[:, :KE]
    active = torch.isfinite(c) & (c < cutoff[:, None])
    row = pg.em_block[torch.where(active, states[:, :KE], 0).long()]
    lo, deg = row[..., W * EM_FIELDS].long(), row[..., W * EM_FIELDS + 1].long()
    n = torch.where(active & (deg > W), (lo + deg - 1) // G - (lo + W) // G + 1, 0)
    return n.sum(dim=1)


def expand_filter(
    states, costs, cutoff, adaptive_beam, scores_t, pg, fc, with_src_slot: bool = False
) -> Expansion:
    """K1 on the tensors' device: plain torch on the CPU, one launch of
    ``csrc/expand.cu`` on a card, which reads each active slot's em_block
    row itself (the reference's row gather, folded in).
    ``expand_filter.launches`` counts K1 launches."""
    dev = states.device
    if dev.type == "cpu":
        return expand_filter_plain(
            states, costs, cutoff, adaptive_beam, scores_t, pg, fc, with_src_slot
        )
    if dev.type != "cuda":
        raise ValueError(f"expand_filter runs on cpu or cuda tensors, not {dev}")
    B, K = states.shape
    V = scores_t.shape[1]
    KE, W, G, Ru = fc.expand_lanes, fc.block_width, fc.flat_group, fc.rem_units
    if K != fc.frontier_size:
        raise ValueError(f"frontier has {K} slots, config says {fc.frontier_size}")
    check(states, "states", torch.int32, (B, K), dev)
    check(costs, "costs", torch.float32, (B, K), dev)
    check(cutoff, "cutoff", torch.float32, (B,), dev)
    check(adaptive_beam, "adaptive_beam", torch.float32, (B,), dev)
    check(scores_t, "scores_t", torch.float32, (B, V), dev)
    check(pg.em_block, "em_block", torch.int32,
           (pg.em_block.shape[0], W * EM_FIELDS + 2), dev)
    check(pg.em_flat, "em_flat", torch.int32, (pg.em_flat.shape[0], G * EM_FIELDS), dev)

    N = KE * W + Ru * G
    i32 = dict(dtype=torch.int32, device=dev)
    out = Expansion(
        dst=torch.empty((B, N), **i32),
        cost=torch.empty((B, N), dtype=torch.float32, device=dev),
        src_state=torch.empty((B, N), **i32),
        arc_id=torch.empty((B, N), **i32),
        overflow=torch.empty((B,), dtype=torch.bool, device=dev),
        next_cutoff=torch.empty((B,), dtype=torch.float32, device=dev),
        src_slot=torch.empty((B, N), **i32) if with_src_slot else None,
    )
    rc = kernels().kd_expand(
        ptr(states), ptr(costs), ptr(cutoff), ptr(adaptive_beam),
        ptr(scores_t), ptr(pg.em_block), ptr(pg.em_flat),
        B, K, KE, W, G, Ru, V, ptr(out.dst), ptr(out.cost), ptr(out.src_state), ptr(out.arc_id),
        ptr(out.src_slot) if with_src_slot else None,
        ptr(out.overflow), ptr(out.next_cutoff), stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_expand launch failed: {cuda_error(rc)}")
    expand_filter.launches += 1
    return out


expand_filter.launches = 0
