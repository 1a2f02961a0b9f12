"""Acoustic-score sources (jax-free copy of ``kaldi_decoder_tpu.decodable``)."""

from kaldi_decoder_tpu_torch.decodable.decodable import (
    DecodableCtc,
    DecodableInterface,
    DecodableMatrix,
    scores_from_decodable,
)

__all__ = [
    "DecodableCtc",
    "DecodableInterface",
    "DecodableMatrix",
    "scores_from_decodable",
]
