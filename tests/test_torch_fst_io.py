"""Twin tests of the port's graph file layer and graph builders against
the JAX package: ``fst/io.py`` (binary, const and text formats), the
builders of ``fst/topo.py``, ``fst/ops.py:compose``, ``fst/csr.py``
(``load_graph``, ``save_graph_npz``) and ``fst/synthetic.py``.

Inputs are the cases of ``tests/test_fst.py`` and ``tests/test_compose.py``,
made from fixed seeds with numpy and given to both packages; the written
bytes must be identical and the FSTs read back equal array for array
(float32 weights by their raw bits).
"""

import io

import numpy as np
import pytest

from kaldi_decoder_tpu.fst import csr as jcsr
from kaldi_decoder_tpu.fst import io as jio
from kaldi_decoder_tpu.fst import ops as jops
from kaldi_decoder_tpu.fst import synthetic as jsyn
from kaldi_decoder_tpu.fst import topo as jtopo
from kaldi_decoder_tpu.fst.fst import Lattice as JaxLattice
from kaldi_decoder_tpu_torch import native
from kaldi_decoder_tpu_torch.fst import csr as pcsr
from kaldi_decoder_tpu_torch.fst import io as pio
from kaldi_decoder_tpu_torch.fst import ops as pops
from kaldi_decoder_tpu_torch.fst import synthetic as psyn
from kaldi_decoder_tpu_torch.fst import topo as ptopo

from _torch_util import jax_host_library, port_fst, same_fst
from test_compose import random_acyclic_transducer


def _lattice():
    lat = JaxLattice()
    s = [lat.add_state() for _ in range(3)]
    lat.set_start(s[0])
    lat.add_arc(s[0], 3, 7, (1.25, -2.5), s[1])
    lat.add_arc(s[1], 0, 3, (0.25, 0.0), s[2])
    lat.set_final(s[2], (1.0, 2.0))
    return lat


def _fsts():
    """(name, JAX FST) of the formats' cases."""
    out = [(f"random{seed}", jtopo.random_fst(50, 6, np.random.default_rng(seed)))
           for seed in (0, 1, 2)]
    out.append(("cyclic-eps", jtopo.random_fst(30, 5, np.random.default_rng(4), eps_prob=0.4,
                                               acyclic_eps=False)))
    out.append(("lattice", _lattice()))
    return out


FSTS = dict(_fsts())


def _written(write, fst):
    buf = io.BytesIO()
    write(fst, buf)
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(FSTS))
@pytest.mark.parametrize("kind", ["vector", "const"])
def test_binary_bytes_and_read_match_jax(name, kind, tmp_path):
    """The same FST written by both packages gives the same bytes; the
    file read back by both packages' ``read_fst`` (the port's through its
    host library) and by the port's Python parser gives the same FST."""
    jf = FSTS[name]
    pf = port_fst(jf)
    jw, pw = (jio.write_fst, pio.write_fst) if kind == "vector" else (
        jio.write_const_fst, pio.write_const_fst)
    data = _written(pw, pf)
    assert data == _written(jw, jf)
    path = tmp_path / f"{name}.fst"
    pw(pf, path)
    assert path.read_bytes() == data
    jax_host_library()
    want = jio.read_fst(str(path))
    got = pio.read_fst(str(path))
    same_fst(want, got)
    same_fst(want, pio.read_fst(io.BytesIO(data)))
    assert type(got).__name__ == type(jf).__name__


@pytest.mark.parametrize("name", ["random0", "random2", "lattice"])
def test_text_format_matches_jax(name, tmp_path):
    """``fst_to_text`` gives the same text; ``fst_from_text``,
    ``read_fst_text`` and ``write_fst_text`` the same FSTs and files."""
    jf = FSTS[name]
    pf = port_fst(jf)
    text = pio.fst_to_text(pf)
    assert text == jio.fst_to_text(jf)
    arc_type = jf.arc_type
    same_fst(jio.fst_from_text(text, arc_type), pio.fst_from_text(text, arc_type))
    pio.write_fst_text(pf, tmp_path / "p.txt")
    jio.write_fst_text(jf, tmp_path / "j.txt")
    assert (tmp_path / "p.txt").read_text() == (tmp_path / "j.txt").read_text()
    same_fst(jio.read_fst_text(tmp_path / "j.txt", arc_type),
             pio.read_fst_text(tmp_path / "p.txt", arc_type))


def test_text_defaults_and_bad_magic():
    same_fst(jio.fst_from_text("0 1 5 6\n1\n"), pio.fst_from_text("0 1 5 6\n1\n"))
    with pytest.raises(ValueError, match="magic"):
        pio.read_fst(io.BytesIO(b"\x00" * 64))
    with pytest.raises(ValueError, match="Bad FST text line"):
        pio.fst_from_text("0 1 2\n")


def test_read_fst_raises_without_host_library(monkeypatch, tmp_path):
    """No fallback: with the host library unbuildable, ``read_fst`` and
    ``load_graph`` of a path raise."""
    path = tmp_path / "g.fst"
    pio.write_fst(port_fst(FSTS["random0"]), path)

    def unbuildable():
        raise RuntimeError("the host library did not build")

    monkeypatch.setattr(native, "host_library", unbuildable)
    with pytest.raises(RuntimeError, match="did not build"):
        pio.read_fst(str(path))
    with pytest.raises(RuntimeError, match="did not build"):
        pcsr.load_graph(str(path))


TOPOS = {
    "ctc": lambda m: m.ctc_topo(7),
    "ctc-modified": lambda m: m.ctc_topo(7, modified=True),
    "linear": lambda m: m.linear_acceptor([3, 1, 4, 1, 5], shift_ilabel=1),
    "random": lambda m: m.random_fst(40, 9, np.random.default_rng(5), eps_prob=0.3),
    "random-cyclic": lambda m: m.random_fst(40, 9, np.random.default_rng(6),
                                            acyclic_eps=False, olabel_symbols=3),
    "ngram": lambda m: m.ngram_fst([[1, 2, 3], [2, 3], [3, 1, 1, 4]], discount=0.3),
    "lexicon": lambda m: m.lexicon_fst([(10, [1, 2]), (11, [3]), (12, [2, 3, 1])],
                                       word_weights=[0.5, 1.0, 0.25]),
}


@pytest.mark.parametrize("name", sorted(TOPOS))
def test_topo_builders_match_jax(name):
    same_fst(TOPOS[name](jtopo), TOPOS[name](ptopo))


@pytest.mark.parametrize("seed", range(6))
def test_compose_matches_jax(seed):
    """``compose`` of the random acyclic transducers of
    ``tests/test_compose.py`` gives the same FST."""
    rng = np.random.default_rng(seed)
    a = random_acyclic_transducer(rng, 6, 3)
    b = random_acyclic_transducer(rng, 6, 3)
    same_fst(jops.compose(a, b), pops.compose(port_fst(a), port_fst(b)))


def test_compose_hl_graph_matches_jax():
    """The HL graph of a CTC topology and a lexicon, and the empty case."""
    lex = [(100, [1, 2]), (101, [3]), (102, [2, 3, 1])]
    want = jops.compose(jtopo.ctc_topo(6), jtopo.lexicon_fst(lex))
    got = pops.compose(ptopo.ctc_topo(6), ptopo.lexicon_fst(lex))
    same_fst(want, got)
    assert got.num_states > 0
    assert pops.compose(ptopo.StdVectorFst(), ptopo.StdVectorFst()).num_states == 0


def _same_graph(want, got):
    for name in want.arrays._fields:
        assert np.array_equal(np.asarray(getattr(want.arrays, name)),
                              getattr(got.arrays, name)), name
    for f in ("num_states", "num_emitting_arcs", "num_eps_arcs", "start_state", "eps_depth",
              "max_em_out_degree", "max_eps_out_degree", "max_score_idx"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_load_graph_matches_jax(seed, tmp_path):
    """``load_graph`` (C++ parse and compile) equals the JAX package's, and
    the port's ``compile_fst`` of the FST read back."""
    rng = np.random.default_rng(seed)
    jf = jtopo.random_fst(int(rng.integers(2, 300)), int(rng.integers(1, 40)), rng,
                          eps_prob=float(rng.uniform(0, 0.4)), acyclic_eps=seed != 2)
    path = tmp_path / "g.fst"
    pio.write_fst(port_fst(jf), path)
    jax_host_library()
    want = jcsr.load_graph(str(path))
    got = pcsr.load_graph(str(path))
    _same_graph(want, got)
    _same_graph(want, pcsr.compile_fst(pio.read_fst(str(path))))


def test_save_graph_npz_matches_jax(tmp_path):
    """A graph saved by either package loads in the other one unchanged."""
    jg = jsyn.synthetic_graph(500, 3000, 20, seed=1, eps_arcs=200)
    pg = pcsr.graph_from_numpy(jg)
    pcsr.save_graph_npz(pg, tmp_path / "p.npz")
    jcsr.save_graph_npz(jg, tmp_path / "j.npz")
    _same_graph(jg, jcsr.load_graph_npz(tmp_path / "p.npz"))
    _same_graph(jg, pcsr.load_graph_npz(tmp_path / "j.npz"))


@pytest.mark.parametrize("eps_arcs", [0, 400])
def test_synthetic_graph_matches_jax(eps_arcs):
    _same_graph(jsyn.synthetic_graph(2000, 12000, 30, seed=3, eps_arcs=eps_arcs),
                psyn.synthetic_graph(2000, 12000, 30, seed=3, eps_arcs=eps_arcs))
