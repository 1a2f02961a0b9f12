"""Beam / max-active / min-active cutoff (GetCutoff), batched over B.

The torch counterpart of ``kaldi_decoder_tpu/ops/cutoff.py:get_cutoff``,
with the same branch order and float arithmetic, on a (B, K) frontier
instead of a vmapped (K,) one.  Decision logic of
``FasterDecoder::GetCutoff`` (`kaldi-decoder/csrc/faster-decoder.cc:244-336`):

* no constraints → cutoff = best + beam, adaptive_beam = beam;
* more than ``max_active`` tokens: the (max_active+1)-th smallest cost
  wins when tighter than the beam cutoff, with
  ``adaptive_beam = max_active_cutoff - best + beam_delta``;
* else more than ``min_active`` tokens: the (min_active+1)-th smallest
  cost loosens the cutoff when the beam would keep fewer than
  ``min_active`` tokens, with the analogous adaptive beam.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")


class Cutoff(NamedTuple):
    cutoff: torch.Tensor  # (B,) f32 — expand tokens with cost < cutoff
    adaptive_beam: torch.Tensor  # (B,) f32 — beam for the next generation
    best_cost: torch.Tensor  # (B,) f32
    count: torch.Tensor  # (B,) int32 — number of live tokens


def get_cutoff(
    costs: torch.Tensor,  # (B, K) f32, +inf for empty slots
    beam: float,
    max_active: int,
    min_active: int,
    beam_delta: float,
    costs_sorted: bool = False,
) -> Cutoff:
    K = costs.shape[1]
    count = torch.isfinite(costs).sum(dim=1, dtype=torch.int32)
    sorted_costs = costs if costs_sorted else torch.sort(costs, dim=1).values
    best = sorted_costs[:, 0]
    beam_cutoff = best + beam

    if max_active >= K and min_active == 0:
        return Cutoff(beam_cutoff, torch.full_like(best, beam), best, count)

    max_cut = torch.where(
        count > max_active, sorted_costs[:, min(max_active, K - 1)], INF
    )
    min_cut = torch.where(
        count > min_active,
        best if min_active == 0 else sorted_costs[:, min(min_active, K - 1)],
        INF,
    )
    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)
    cutoff = torch.where(
        use_max, max_cut, torch.where(use_min, min_cut, beam_cutoff)
    )
    adaptive = torch.where(
        use_max,
        max_cut - best + beam_delta,
        torch.where(use_min, min_cut - best + beam_delta, beam),
    )
    return Cutoff(cutoff, adaptive, best, count)
