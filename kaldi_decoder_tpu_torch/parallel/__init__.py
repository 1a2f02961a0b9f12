"""Multi-device decoding over ``torch.distributed``: data parallelism
(:mod:`.mesh`) and state-sharded graphs (:mod:`.graph_shard`).  The names
are the JAX package's (``kaldi_decoder_tpu/parallel/__init__.py``), with
``ShardedLatticeDecoder``."""

from kaldi_decoder_tpu_torch.parallel.mesh import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    pad_batch,
    replicated,
)
from kaldi_decoder_tpu_torch.parallel.graph_shard import (
    ShardedGraph,
    ShardedLatticeDecoder,
    ShardedViterbiDecoder,
    shard_graph,
)

__all__ = [
    "ShardedGraph",
    "ShardedLatticeDecoder",
    "ShardedViterbiDecoder",
    "batch_sharding",
    "initialize_distributed",
    "make_mesh",
    "pad_batch",
    "replicated",
    "shard_graph",
]
