"""Utilities: math helpers, logging and decode statistics, WER and profiling hooks.

The exports are the JAX package's (``kaldi_decoder_tpu/utils/__init__.py``).
"""

from kaldi_decoder_tpu_torch.utils.logging import DecodeStats, get_logger
from kaldi_decoder_tpu_torch.utils.math import approx_equal

__all__ = ["approx_equal", "get_logger", "DecodeStats"]
