"""Twin tests of the port's host-library entry points against the JAX
package's (``kaldi_decoder_tpu/native/__init__.py:201, 206, 273, 312,
350, 393``), on the inputs of ``tests/test_native.py``: the same files,
texts, graphs and scores go to both, and every result must be exact."""

import numpy as np
import pytest

from kaldi_decoder_tpu import native as jnat
from kaldi_decoder_tpu.fst.csr import compile_fst as jax_compile_fst
from kaldi_decoder_tpu.fst.io import fst_to_text, write_fst
from kaldi_decoder_tpu.fst.topo import random_fst
from kaldi_decoder_tpu_torch import native
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy

from _torch_util import jax_host_library


def _random_graph(seed):
    rng = np.random.default_rng(seed)
    return random_fst(
        num_states=int(rng.integers(2, 300)),
        num_symbols=int(rng.integers(1, 40)),
        rng=rng,
        eps_prob=float(rng.uniform(0, 0.4)),
    )


def _same_arrays(want, got):
    assert want.keys() == got.keys()
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert w.dtype == g.dtype and w.tobytes() == g.tobytes(), k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_read_fst_arrays_and_load_csr_match_jax(seed, tmp_path):
    path = str(tmp_path / "g.fst")
    write_fst(_random_graph(seed), path)
    jax_host_library()
    _same_arrays(jnat.read_fst_arrays(path), native.read_fst_arrays(path))
    want, got = jnat.load_csr(path), native.load_csr(path)
    for name in want.arrays._fields:
        assert np.array_equal(getattr(want.arrays, name), getattr(got.arrays, name)), name
    for f in ("num_states", "num_emitting_arcs", "num_eps_arcs", "start_state", "eps_depth",
              "max_em_out_degree", "max_eps_out_degree", "max_score_idx"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("weight_dim", [1, 2])
def test_parse_fst_text_arrays_matches_jax(weight_dim):
    jax_host_library()
    if weight_dim == 1:
        text = fst_to_text(_random_graph(3))
    else:
        text = "0\t1\t3\t7\t1.25,-2.5\n1\t2\t0\t3\t0.25,0\n2\t1,2\n"
    _same_arrays(jnat.parse_fst_text_arrays(text, weight_dim),
                 native.parse_fst_text_arrays(text, weight_dim))


def _graph_and_scores(seed):
    rng = np.random.default_rng(40 + seed)
    cg = jax_compile_fst(random_fst(num_states=120, num_symbols=12, rng=rng, eps_prob=0.25))
    scores = np.log(rng.dirichlet(np.ones(12), size=30)).astype(np.float32)
    return cg, graph_from_numpy(cg), scores


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_faster_and_lattice_match_jax(seed):
    """The single-thread C++ decoders give the same best cost bits and
    counts through both bindings."""
    jax_host_library()
    cg, pg, scores = _graph_and_scores(seed)
    for kw in (dict(beam=10.0), dict(beam=12.0, max_active=30, min_active=5, beam_delta=0.25)):
        want, got = jnat.decode_faster(cg, scores, **kw), native.decode_faster(pg, scores, **kw)
        assert np.float64(want[0]).tobytes() == np.float64(got[0]).tobytes()
        assert want[1:] == got[1:]
        assert got[1] == scores.shape[0]
        lkw = dict(kw, lattice_beam=6.0, prune_interval=7)
        want, got = jnat.decode_lattice(cg, scores, **lkw), native.decode_lattice(pg, scores, **lkw)
        assert np.float64(want[0]).tobytes() == np.float64(got[0]).tobytes()
        assert want[1] == got[1]


def test_get_cutoff_matches_jax():
    """GetCutoff (faster-decoder.cc:244-336) through both bindings, on the
    random frontiers of ``tests/test_native.py::test_get_cutoff_pins_cpp``."""
    jax_host_library()
    rng = np.random.default_rng(11)
    for _ in range(60):
        K = int(rng.choice([64, 256]))
        n = int(rng.integers(1, K + 1))
        costs = rng.uniform(0.0, 30.0, n).astype(np.float32)
        beam = float(rng.uniform(0.5, 20.0))
        max_active = int(rng.choice([2, max(2, n // 3), max(2, n - 1), n + 4, 2**31 - 1]))
        min_active = int(rng.integers(0, min(max_active, n + 2)))
        beam_delta = float(rng.uniform(0.1, 1.0))
        args = (costs, beam, max_active, min_active, beam_delta)
        assert jnat.get_cutoff(*args) == native.get_cutoff(*args)


def test_read_fst_arrays_reports_a_bad_file(tmp_path):
    path = tmp_path / "bad.fst"
    path.write_bytes(b"\x00" * 64)
    with pytest.raises(ValueError):
        native.read_fst_arrays(str(path))
