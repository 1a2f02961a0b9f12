"""K4: the backward extra-cost sweep of one chunk.

:func:`sweep_chunk` runs the plain torch sweep
(:func:`kaldi_decoder_tpu_torch.decoders.sweep.sweep_plain`) on CPU
tensors and launches ``csrc/sweep.cu`` on CUDA tensors, or raises: its
eps instance when the config has eps iterations (the eps Bellman and the
eps rows), else the eps-free one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from kaldi_decoder_tpu_torch.decoders.sweep import (
    MARGIN,
    SweepConfig,
    SweepOut,
    sweep_plain,
)
from kaldi_decoder_tpu_torch.kernels._build import check, cuda_error, kernels, ptr, stream


def sweep_chunk(
    frontier_states: torch.Tensor,  # (T, B, K) int32
    frontier_costs: torch.Tensor,  # (T, B, K) float32
    em_records: torch.Tensor,  # (T, B, R, 4) int32
    init_states: torch.Tensor,  # (B, K) int32
    rem: torch.Tensor,  # (B,) int32
    sc: SweepConfig,
    num_states: int,
    eps_records: Optional[torch.Tensor] = None,  # (T, B, D, Re, 4) int32; D > 0 only
) -> SweepOut:
    """K4 on the tensors' device; ``sweep_chunk.launches`` counts kernel
    launches."""
    dev = frontier_states.device
    if dev.type == "cpu":
        return sweep_plain(
            frontier_states, frontier_costs, em_records, init_states, rem, sc,
            num_states, eps_records,
        )
    if dev.type != "cuda":
        raise ValueError(f"sweep_chunk runs on cpu or cuda tensors, not {dev}")
    T, K, R = sc.chunk_frames, sc.frontier_size, sc.em_records
    B = init_states.shape[0]
    check(frontier_states, "frontier_states", torch.int32, (T, B, K), dev)
    check(frontier_costs, "frontier_costs", torch.float32, (T, B, K), dev)
    check(em_records, "em_records", torch.int32, (T, B, R, 4), dev)
    check(init_states, "init_states", torch.int32, (B, K), dev)
    check(rem, "rem", torch.int32, (B,), dev)
    D, Re = sc.eps_iters, sc.eps_records
    DRe = D * Re
    if DRe:
        check(eps_records, "eps_records", torch.int32, (T, B, D, Re, 4), dev)
    # The kernel stages each frame's slab with 16-byte bulk copies, so its
    # frontier has a multiple of 4 slots: another size is padded with dead
    # slots (state -1, cost +inf), which join no table and emit no row.
    K4 = -(-K // 4) * 4
    if K4 != K:
        pad = (0, K4 - K)
        frontier_states = F.pad(frontier_states, pad, value=-1)
        frontier_costs = F.pad(frontier_costs, pad, value=float("inf"))
        init_states = F.pad(init_states, pad, value=-1)
    for name, t in (("frontier_states", frontier_states), ("frontier_costs", frontier_costs),
                    ("em_records", em_records)) + ((("eps_records", eps_records),) if DRe else ()):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")

    i32 = dict(dtype=torch.int32, device=dev)
    table = torch.empty((3 if DRe else 2, B, num_states), dtype=torch.int64, device=dev)
    # Extras of the slots and records a block does not stage.
    spill = torch.empty((B * (K4 + R),), dtype=torch.float32, device=dev)
    out = SweepOut(
        # A frame appends at most K rows, so none lands in the padding's.
        tok_rows=torch.empty((B, sc.tok_cap + K4, 3), **i32)[:, : sc.tok_cap + K],
        tok_count=torch.empty((B,), **i32),
        em_rows=torch.empty((B, sc.em_cap + R, 3), **i32),
        em_count=torch.empty((B,), **i32),
        eps_rows=torch.empty((B, sc.eps_cap + max(D, 1) * Re, 3), **i32),
        eps_count=torch.empty((B,), **i32),
        overflow=torch.empty((B,), dtype=torch.bool, device=dev),
    )
    # The thresholds as float32, as the plain version's comparisons of
    # float32 tensors with Python floats round them.
    tok_thr = float(np.float32(sc.lattice_beam + 2 * MARGIN))
    em_thr = float(np.float32(sc.lattice_beam + MARGIN))
    rc = kernels().kd_sweep(
        ptr(frontier_states), ptr(frontier_costs), ptr(em_records),
        ptr(init_states), ptr(rem), T, B, K4, R, num_states, sc.tok_cap,
        sc.em_cap, tok_thr, em_thr, ptr(table), ptr(spill), ptr(out.tok_rows), ptr(out.em_rows),
        ptr(out.tok_count), ptr(out.em_count), ptr(out.overflow),
        ptr(eps_records) if DRe else None, DRe, sc.eps_bound, sc.eps_cap, ptr(out.eps_rows),
        ptr(out.eps_count), stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_sweep launch failed: {cuda_error(rc)}")
    sweep_chunk.launches += 1
    return out


sweep_chunk.launches = 0
