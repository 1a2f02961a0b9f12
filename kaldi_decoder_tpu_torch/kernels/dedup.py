"""K6: Viterbi dedup by state and top-K frontier selection.

:func:`dedup_select` keeps each state's cheapest candidate lane (the
lowest lane among equal costs) and the K cheapest states in (cost, state)
order, with each slot's winning lane.  On a CPU tensor it runs the plain
torch version, :func:`kaldi_decoder_tpu_torch.ops.segment.dedup_select`;
on a CUDA tensor it launches ``csrc/dedup.cu`` or raises.

The kernel's per-state winner table, (B, S) 64-bit words, is scratch
filled with all ones for each call, so no state is kept between calls.
"""

from __future__ import annotations

import torch

from kaldi_decoder_tpu_torch.kernels._build import check, cuda_error, kernels, ptr, stream
from kaldi_decoder_tpu_torch.ops.segment import Selection
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

# Shared memory a block may take on sm_90 (232,448 bytes), less the
# select step's own static arrays.
MAX_SELECT_SMEM = 232448 - 2048

def dedup_select(
    cand_state: torch.Tensor,  # (B, N) int32
    cand_cost: torch.Tensor,  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
) -> Selection:
    """K6 on the tensors' device.  Finite lanes must have a state in
    ``[0, num_states)``.  ``dedup_select.launches`` counts K6 launches."""
    dev = cand_state.device
    if dev.type == "cpu":
        return dedup_select_plain(cand_state, cand_cost, k, num_states)
    if dev.type != "cuda":
        raise ValueError(f"dedup_select runs on cpu or cuda tensors, not {dev}")
    B, N = cand_cost.shape
    check(cand_state, "cand_state", torch.int32, (B, N), dev)
    check(cand_cost, "cand_cost", torch.float32, (B, N), dev)
    lib = kernels()
    if lib.kd_dedup_smem_bytes(N, k) > MAX_SELECT_SMEM:
        raise ValueError(f"frontier size {k} needs more shared memory than a block has")
    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.full((B, num_states), -1, dtype=torch.int64, device=dev)
    keys = torch.empty((B, N), dtype=torch.int64, device=dev)
    lanes = torch.empty((B, N), **i32)
    out = Selection(
        states=torch.empty((B, k), **i32),
        costs=torch.empty((B, k), dtype=torch.float32, device=dev),
        cand_idx=torch.empty((B, k), **i32),
        num_unique=torch.empty((B,), **i32),
    )
    rc = lib.kd_dedup(
        ptr(cand_state), ptr(cand_cost), B, N, num_states, k,
        ptr(table), ptr(keys), ptr(lanes),
        ptr(out.states), ptr(out.costs), ptr(out.cand_idx), ptr(out.num_unique),
        stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_dedup launch failed: {cuda_error(rc)}")
    dedup_select.launches += 1
    return out


dedup_select.launches = 0
