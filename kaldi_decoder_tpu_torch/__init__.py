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
and :class:`FasterDecoder`, with the device eps closure.  Around them:
the OpenFst graph files (``fst.read_fst``, ``fst.write_fst``,
``fst.load_graph``), the graph builders (``fst.ctc_topo``, ...), the
oracle decoders (:class:`OracleSimpleDecoder`,
:class:`OracleLatticeDecoder`), lattice post-processing
(``lattice.post``), the CTC encoder (``models``), the profiling hooks
(``utils.profiling``) and the command line (``python -m
kaldi_decoder_tpu_torch.cli``).  The public names are the JAX package's
(``kaldi_decoder_tpu/__init__.py``) for what is ported.
"""

__version__ = "0.1.0"

from kaldi_decoder_tpu_torch.decodable import (
    DecodableCtc,
    DecodableInterface,
    DecodableMatrix,
)
from kaldi_decoder_tpu_torch.decoders import (
    BatchedLatticeDecoder,
    BatchedViterbiDecoder,
    FasterDecoder,
    FasterDecoderOptions,
    FrontierConfig,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeResult,
    LatticeSimpleDecoder,
    LatticeSimpleDecoderConfig,
    OracleLatticeDecoder,
    OracleSimpleDecoder,
    SimpleDecoder,
    ViterbiResult,
    config_for_graph,
)
from kaldi_decoder_tpu_torch.decoders.lattice import PendingDecode
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, compile_fst, load_graph, load_graph_npz

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
    "OracleLatticeDecoder",
    "OracleSimpleDecoder",
    "PendingDecode",
    "SimpleDecoder",
    "ViterbiResult",
    "compile_fst",
    "config_for_graph",
    "load_graph",
    "load_graph_npz",
    "__version__",
]
