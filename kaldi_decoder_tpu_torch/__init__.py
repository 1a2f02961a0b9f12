"""kaldi_decoder_tpu_torch: the decoders ported to PyTorch and CUDA.

The port of ``kaldi_decoder_tpu`` (JAX) to PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (``sm_90a``).  It mirrors the JAX
package's layout (``fst/``, ``ops/``, ``decoders/``, ``decodable/``,
``lattice/``, ``utils/``) and imports no jax: the host modules it needs
are carried as tested copies.  Every public entry takes an explicit
``device``; nothing picks one on its own.

The ported slices are :class:`BatchedLatticeDecoder`, on an eps-folded
graph or one that keeps its eps arcs on the device, with the device
backward sweep (``device_prune=True``); the reference's streaming
lattice API, :class:`LatticeSimpleDecoder` and
:class:`LatticeFasterDecoder`; and the 1-best path:
:class:`BatchedViterbiDecoder` and the streaming :class:`SimpleDecoder`
and :class:`FasterDecoder`, with the device eps closure.  The public names are the JAX package's
(``kaldi_decoder_tpu/__init__.py``) for what is ported.
"""

__version__ = "0.1.0"

from kaldi_decoder_tpu_torch.decodable import (
    DecodableCtc,
    DecodableInterface,
    DecodableMatrix,
)
from kaldi_decoder_tpu_torch.decoders.api import (
    FasterDecoder,
    FasterDecoderOptions,
    SimpleDecoder,
)
from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, config_for_graph
from kaldi_decoder_tpu_torch.decoders.lattice import (
    BatchedLatticeDecoder,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeResult,
    LatticeSimpleDecoder,
    LatticeSimpleDecoderConfig,
    PendingDecode,
)
from kaldi_decoder_tpu_torch.decoders.viterbi import BatchedViterbiDecoder, ViterbiResult
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, compile_fst, load_graph_npz

__all__ = [
    "BatchedLatticeDecoder",
    "BatchedViterbiDecoder",
    "CsrGraph",
    "DecodableCtc",
    "DecodableInterface",
    "DecodableMatrix",
    "FasterDecoder",
    "FasterDecoderOptions",
    "FrontierConfig",
    "LatticeFasterDecoder",
    "LatticeFasterDecoderConfig",
    "LatticeResult",
    "LatticeSimpleDecoder",
    "LatticeSimpleDecoderConfig",
    "PendingDecode",
    "SimpleDecoder",
    "ViterbiResult",
    "compile_fst",
    "config_for_graph",
    "load_graph_npz",
    "__version__",
]
