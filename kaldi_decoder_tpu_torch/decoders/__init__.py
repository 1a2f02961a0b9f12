"""Decoders: the oracles, the batched device decoders and the reference's
streaming API.  The names are the JAX package's
(``kaldi_decoder_tpu/decoders/__init__.py``)."""

from kaldi_decoder_tpu_torch.decoders.ref_simple import OracleSimpleDecoder
from kaldi_decoder_tpu_torch.decoders.ref_lattice import OracleLatticeDecoder
from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, config_for_graph
from kaldi_decoder_tpu_torch.decoders.viterbi import BatchedViterbiDecoder, ViterbiResult
from kaldi_decoder_tpu_torch.decoders.api import (
    FasterDecoder,
    FasterDecoderOptions,
    SimpleDecoder,
)
from kaldi_decoder_tpu_torch.decoders.lattice import (
    BatchedLatticeDecoder,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeResult,
    LatticeSimpleDecoder,
    LatticeSimpleDecoderConfig,
)

__all__ = [
    "OracleSimpleDecoder",
    "OracleLatticeDecoder",
    "FrontierConfig",
    "config_for_graph",
    "BatchedViterbiDecoder",
    "ViterbiResult",
    "FasterDecoder",
    "FasterDecoderOptions",
    "SimpleDecoder",
    "BatchedLatticeDecoder",
    "LatticeFasterDecoder",
    "LatticeFasterDecoderConfig",
    "LatticeResult",
    "LatticeSimpleDecoder",
    "LatticeSimpleDecoderConfig",
]
