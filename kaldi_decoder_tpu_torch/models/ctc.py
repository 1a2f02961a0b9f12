"""Minimal CTC acoustic encoder for end-to-end demos and tests.

The torch port of ``kaldi_decoder_tpu/models/ctc.py``.  The reference has
no model layer (its acoustic model lives in icefall behind
``DecodableInterface``); this small frame-stacking + RMSNorm/MLP encoder
lets the decoder run end to end from features: features -> log-softmax
posteriors -> ``DecodableCtc`` or a batched decoder.  It is not a
competitive ASR model.

The arithmetic is the original's: frames stacked by ``subsampling``, an
input projection, per layer ``x + gelu(rmsnorm(x) * scale @ w1) @ w2``
with the tanh form of GELU (``jax.nn.gelu``'s default) and
``rsqrt(mean(x²) + 1e-6)``, then an output projection and a log-softmax
over the vocabulary.  The products are ``torch.matmul``: the original
computes them outside any Pallas kernel, and the module has no kernel of
its own.  :func:`encoder_from_numpy` carries the weights across: it takes
the original's ``init_params`` tree as numpy arrays.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class CtcEncoderConfig:
    num_features: int = 80
    hidden_dim: int = 256
    num_layers: int = 4
    vocab_size: int = 500
    subsampling: int = 4  # conformer-style 4x time reduction
    context: int = 3  # conv kernel width per subsample stage


class CtcEncoder(nn.Module):
    """(B, T, F) features -> (B, T // subsampling, V) log-softmax
    posteriors.  Weights are drawn from ``generator`` with the original's
    scales (normal / sqrt(fan_in), zero output bias, unit RMSNorm scales)
    and placed on ``device``."""

    def __init__(self, cfg: CtcEncoderConfig, generator: torch.Generator, *, device):
        super().__init__()
        self.cfg = cfg
        F_in, H, V = cfg.num_features * cfg.subsampling, cfg.hidden_dim, cfg.vocab_size

        def normal(rows, cols):
            w = torch.randn(rows, cols, generator=generator) / math.sqrt(rows)
            return nn.Parameter(w.to(device))

        self.in_proj = normal(F_in, H)
        self.out_proj = normal(H, V)
        self.out_bias = nn.Parameter(torch.zeros(V, device=device))
        self.layers = nn.ModuleList()
        for _ in range(cfg.num_layers):
            layer = nn.Module()
            layer.w1 = normal(H, 4 * H)
            layer.w2 = normal(4 * H, H)
            layer.scale = nn.Parameter(torch.ones(H, device=device))
            self.layers.append(layer)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        B, T, Fd = feats.shape
        cfg = self.cfg
        Ts = T // cfg.subsampling
        # Subsample by stacking frames (the compute shape of a conv
        # subsampling, kept a matmul).
        x = feats[:, : Ts * cfg.subsampling].reshape(B, Ts, Fd * cfg.subsampling)
        x = x @ self.in_proj
        for layer in self.layers:
            # RMSNorm -> MLP -> residual.
            h = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
            h = h * layer.scale
            h = F.gelu(h @ layer.w1, approximate="tanh") @ layer.w2
            x = x + h
        logits = x @ self.out_proj + self.out_bias
        return torch.log_softmax(logits, dim=-1)


def encoder_from_numpy(params: dict, cfg: CtcEncoderConfig, device) -> CtcEncoder:
    """A :class:`CtcEncoder` holding the weights of ``params``, the tree
    ``kaldi_decoder_tpu.models.ctc.init_params`` returns (``in_proj``,
    ``out_proj``, ``out_bias``, ``layers[i]`` with ``w1``, ``w2``,
    ``scale``), each given as a numpy array, in float32 on ``device``."""
    enc = CtcEncoder(cfg, torch.Generator().manual_seed(0), device="meta")
    tensors = {
        "in_proj": params["in_proj"],
        "out_proj": params["out_proj"],
        "out_bias": params["out_bias"],
    }
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"{len(params['layers'])} layers given, the config has {cfg.num_layers}")
    for i, layer in enumerate(params["layers"]):
        for k in ("w1", "w2", "scale"):
            tensors[f"layers.{i}.{k}"] = layer[k]
    state = {k: torch.tensor(np.asarray(v, np.float32)) for k, v in tensors.items()}
    enc.load_state_dict(state, assign=True)
    return enc.to(device)
