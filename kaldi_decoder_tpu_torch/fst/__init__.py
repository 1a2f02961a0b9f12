"""Graph representation, file formats, builders, eps folding and packing.

The names are the JAX package's (``kaldi_decoder_tpu/fst/__init__.py``).
"""

from kaldi_decoder_tpu_torch.fst.fst import (
    EPSILON,
    NO_STATE,
    Arc,
    Lattice,
    LatticeArc,
    LatticeWeight,
    StdVectorFst,
    TropicalWeight,
    VectorFst,
)
from kaldi_decoder_tpu_torch.fst.io import (
    fst_from_text,
    fst_to_text,
    read_fst,
    read_fst_text,
    write_const_fst,
    write_fst,
    write_fst_text,
)
from kaldi_decoder_tpu_torch.fst.topo import ctc_topo, linear_acceptor, random_fst
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays, compile_fst, load_graph
from kaldi_decoder_tpu_torch.fst.ops import (
    connect,
    path_labels,
    path_total_cost,
    remove_eps_local,
    shortest_path,
    topological_order,
)

__all__ = [
    "EPSILON",
    "NO_STATE",
    "Arc",
    "Lattice",
    "LatticeArc",
    "LatticeWeight",
    "StdVectorFst",
    "TropicalWeight",
    "VectorFst",
    "fst_from_text",
    "fst_to_text",
    "read_fst",
    "read_fst_text",
    "write_const_fst",
    "write_fst",
    "write_fst_text",
    "ctc_topo",
    "linear_acceptor",
    "random_fst",
    "CsrGraph",
    "GraphArrays",
    "compile_fst",
    "load_graph",
    "connect",
    "path_labels",
    "path_total_cost",
    "remove_eps_local",
    "shortest_path",
    "topological_order",
]
