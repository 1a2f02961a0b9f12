"""Row gather of an int32 table: ``out[..., :] = table[idx[...], :]``.

The counterpart of the Pallas row gathers under ``scripts/gather*_bench.py``,
which gather rows of the packed ``em_block`` table for a frontier's states
(``kaldi_decoder_tpu/decoders/frontier.py:expand_emitting``).  The main
path does not call it: K1 (:func:`kaldi_decoder_tpu_torch.kernels.expand.expand_filter`)
reads each active slot's row inside its own launch.  On a CPU tensor
:func:`row_gather` runs the plain torch version, :func:`row_gather_plain`;
on a CUDA tensor it launches ``csrc/gather.cu`` or raises.
"""

from __future__ import annotations

import torch

from kaldi_decoder_tpu_torch.kernels._build import check, cuda_error, kernels, ptr, stream


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table[idx.long()]


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` (R, W) int32 at ``idx`` (any shape) int32 in
    [0, R), as ``idx.shape + (W,)``.  ``row_gather.launches`` counts
    kernel launches."""
    dev = table.device
    if dev.type == "cpu":
        return row_gather_plain(table, idx)
    if dev.type != "cuda":
        raise ValueError(f"row_gather runs on cpu or cuda tensors, not {dev}")
    R, W = table.shape
    check(table, "table", torch.int32, (R, W), dev)
    check(idx, "idx", torch.int32, idx.shape, dev)
    out = torch.empty(tuple(idx.shape) + (W,), dtype=torch.int32, device=dev)
    rc = kernels().kd_row_gather(
        ptr(table), ptr(idx), idx.numel(), R, W, ptr(out), stream(dev)
    )
    if rc != 0:
        raise RuntimeError(f"kd_row_gather launch failed: {cuda_error(rc)}")
    row_gather.launches += 1
    return out


row_gather.launches = 0
