"""kaldi_decoder_tpu_torch: the lattice decoder ported to PyTorch and CUDA.

The port of ``kaldi_decoder_tpu`` (JAX) to PyTorch, with hand-written
CUDA kernels for an NVIDIA H100 (``sm_90a``).  It mirrors the JAX
package's layout (``fst/``, ``ops/``, ``decoders/``, ``lattice/``,
``utils/``) and imports no jax: the host modules it needs are carried as
tested copies.  Every public entry takes an explicit ``device``; nothing
picks one on its own.

The ported slice is :class:`BatchedLatticeDecoder` on an eps-folded graph,
with the device backward sweep (``device_prune=True``).
"""

__version__ = "0.1.0"

from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, config_for_graph
from kaldi_decoder_tpu_torch.decoders.lattice import (
    BatchedLatticeDecoder,
    LatticeResult,
    PendingDecode,
)
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, load_graph_npz

__all__ = [
    "BatchedLatticeDecoder",
    "CsrGraph",
    "FrontierConfig",
    "LatticeResult",
    "PendingDecode",
    "config_for_graph",
    "load_graph_npz",
    "__version__",
]
