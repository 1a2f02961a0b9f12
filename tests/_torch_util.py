"""Shared inputs for the port's twin tests (JAX package vs torch port).

Graphs and scores are made with numpy from fixed seeds and handed to both
packages; the JAX side runs on the CPU as the rest of the suite does.
"""

import functools

import numpy as np
import pytest

from kaldi_decoder_tpu.decoders.frontier import config_for_graph as jax_config_for_graph
from kaldi_decoder_tpu.fst.csr import compile_fst
from kaldi_decoder_tpu.fst.hlg import make_hlg, make_utterances
from kaldi_decoder_tpu.fst.synthetic import synthetic_graph
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy


@functools.lru_cache(maxsize=None)
def small_hlg():
    """(HlgGraph, JAX CsrGraph, port CsrGraph) of a small HLG with
    acyclic eps backoff arcs (foldable)."""
    g = make_hlg(num_words=40, num_tokens=12, num_sentences=120, seed=3)
    cg = compile_fst(g.hlg)
    return g, cg, graph_from_numpy(cg)


@functools.lru_cache(maxsize=None)
def small_noeps():
    """(JAX CsrGraph, port CsrGraph) of a random graph with no eps arcs."""
    cg = synthetic_graph(300, 1500, 20, seed=11)
    return cg, graph_from_numpy(cg)


def hlg_batch(batch: int, seed: int):
    g, _, _ = small_hlg()
    rng = np.random.default_rng(seed)
    scores, lengths, refs = make_utterances(
        g, batch, rng, words_per_utt=(3, 6), peak=2.0, noise_alpha=0.6
    )
    return scores, lengths, refs


def noeps_batch(batch: int, T: int, seed: int):
    rng = np.random.default_rng(seed)
    V = 20
    scores = np.log(rng.dirichlet(np.ones(V), size=(batch, T))).astype(np.float32)
    lengths = np.array([T - 5 * b for b in range(batch)], np.int32)
    return scores, lengths


def jax_host_library():
    """The JAX package's C++ host library, loaded.

    Five sites of the JAX package take a Python fallback when
    ``kaldi_decoder_tpu.native.available()`` is false, and one of them
    (``LatticeResult.best_path_labels`` on a cyclic lattice) answers
    where the C++ route, and the port's, raise.  When test workers build
    the library at once, the loser of the race caches the failure in
    ``native._tried``; by then the winner's library is on disk, so the
    cache flag is reset and the load tried once more.  A twin test calls
    this before it computes an expected value through one of those
    sites, and fails, never skips, if the library still does not load."""
    from kaldi_decoder_tpu import native

    if native.get_lib() is None:
        native._tried = False
        if native.get_lib() is None:
            pytest.fail("the JAX package's host library did not build or load (twice); "
                        "its Python fallbacks would give the expected values")
    return native.get_lib()


def twin_configs(jax_graph, port_graph, **kw):
    """The same frontier config built by both packages."""
    return jax_config_for_graph(jax_graph, **kw), config_for_graph(port_graph, **kw)


def assert_same_config(jfc, pfc, eps=False):
    """Every field of the port's config equals the JAX one's, and the
    config runs an eps closure exactly when ``eps`` (a device graph that
    keeps its eps arcs)."""
    for f in (
        "beam", "max_active", "min_active", "beam_delta", "frontier_size",
        "block_width", "rem_budget", "eps_block_width", "eps_rem_budget",
        "flat_group", "eps_iters", "eps_exact",
    ):
        assert getattr(jfc, f) == getattr(pfc, f), f
    assert (jfc.eps_iters > 0) == eps


def bits(x):
    """float32 array as int32 bits with -0.0 folded onto +0.0."""
    x = np.asarray(x, np.float32).copy()
    x[x == 0] = 0.0
    return x.view(np.int32)


def port_fst(fst):
    """The port's FST class of the same kind, from a JAX FST's arrays."""
    from kaldi_decoder_tpu_torch.fst import fst as pfst

    cls = getattr(pfst, type(fst).__name__)
    return cls.from_arrays(**fst.to_arrays())


def same_fst(a, b):
    """Two FSTs (of either package, or both None) with the same arrays,
    float32 weights by their raw bits."""
    if a is None or b is None:
        assert a is None and b is None
        return
    x, y = a.to_arrays(), b.to_arrays()
    assert x.keys() == y.keys() and type(a).__name__ == type(b).__name__
    for k in x:
        xa, ya = np.asarray(x[k]), np.asarray(y[k])
        if xa.dtype == np.float32:
            xa, ya = xa.view(np.int32), ya.view(np.int32)
        assert np.array_equal(xa, ya), k
