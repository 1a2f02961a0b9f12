"""The port's host-side copies against their originals, and its import
without jax.

The port carries jax-free copies of the JAX package's host modules
(CSR graph, eps folding, packing, lattice pruning, workload synthesis,
WER); each must give exactly what the original gives.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxDecoder
from kaldi_decoder_tpu.fst import fold as jfold
from kaldi_decoder_tpu.fst import hlg as jhlg
from kaldi_decoder_tpu.fst import pack as jpack
from kaldi_decoder_tpu.fst.csr import _eps_depth as jax_eps_depth
from kaldi_decoder_tpu.fst.csr import save_graph_npz
from kaldi_decoder_tpu.lattice import prune as jprune
from kaldi_decoder_tpu.utils.wer import wer as jax_wer
from kaldi_decoder_tpu_torch.fst import fold as pfold
from kaldi_decoder_tpu_torch.fst import hlg as phlg
from kaldi_decoder_tpu_torch.fst import pack as ppack
from kaldi_decoder_tpu_torch.fst.csr import GraphArrays, _eps_depth, load_graph_npz
from kaldi_decoder_tpu_torch.lattice import prune as pprune
from kaldi_decoder_tpu_torch.utils.wer import wer

from _torch_util import hlg_batch, jax_host_library, port_fst, same_fst, small_hlg, small_noeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graphs():
    _, jg, pg = small_hlg()
    jn, pn = small_noeps()
    return {"hlg": (jg, pg), "noeps": (jn, pn)}


def _assert_graph_equal(a, b):
    for f in GraphArrays._fields:
        x, y = np.asarray(getattr(a.arrays, f)), np.asarray(getattr(b.arrays, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("num_states", "num_emitting_arcs", "num_eps_arcs", "start_state",
              "eps_depth", "max_em_out_degree", "max_eps_out_degree", "max_score_idx"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", ["hlg", "noeps"])
def test_csr_load_and_eps_depth(name, tmp_path):
    jg, _ = _graphs()[name]
    save_graph_npz(jg, tmp_path / "g.npz")
    pg = load_graph_npz(tmp_path / "g.npz")
    _assert_graph_equal(jg, pg)
    ga = jg.arrays
    assert _eps_depth(jg.num_states, ga.eps_row_ptr, ga.eps_next) == jax_eps_depth(
        jg.num_states, ga.eps_row_ptr, ga.eps_next
    )


@pytest.mark.parametrize("name,w_em,w_eps,group", [
    ("hlg", 3, 1, 4), ("hlg", 5, 2, 8), ("noeps", 4, 1, 4),
])
def test_pack_matches_jax(name, w_em, w_eps, group):
    """The port packs the original's emitting and eps tables."""
    jg, pg = _graphs()[name]
    ref = jpack.pack_graph(jg, w_em, w_eps, group)
    host = ppack.pack_graph(pg, w_em, w_eps, group)
    dev = ppack.pack_graph_device(pg, w_em, w_eps, group, "cpu")
    jdev = ppack.packed_from_numpy(jpack.pack_graph_device(jg, w_em, w_eps, group), "cpu")
    for f, h, d, j in zip(ppack.PackedGraph._fields, host, dev, jdev):
        r = np.asarray(getattr(ref, f))
        assert np.array_equal(r, np.asarray(h)), f
        assert np.array_equal(r.astype(d.numpy().dtype), d.numpy()), f
        assert np.array_equal(j.numpy(), d.numpy()), f


def test_fold_matches_jax():
    _, jg, pg = small_hlg()
    ref, got = jfold.fold_eps(jg), pfold.fold_eps(pg)
    _assert_graph_equal(ref.device, got.device)
    for f in ("path_ptr", "path_arcs", "eps_src"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), f
    for f in ("states", "costs", "eps_records"):
        assert np.array_equal(getattr(ref.start, f), getattr(got.start, f)), f
    assert ref.start.paths == got.start.paths
    recs = np.array([[0, 0], [3, 7], [-1, -1], [5, 40]], np.int32)
    for x, y in zip(ref.expand_em_records(recs), got.expand_em_records(recs)):
        assert np.array_equal(x, y)


def test_prune_matches_jax():
    """Both copies of prune_lattice + flat_arc_arrays on the full records
    of a JAX decode of the small HLG (unfolded, so eps links too)."""
    _, jg, pg = small_hlg()
    scores, lengths, _ = hlg_batch(2, seed=3)
    dec = JaxDecoder(jg, None, lattice_beam=5.0, em_records=256, eps_records=64,
                     pad_time_to=8, fold=False)
    res = dec.decode(scores, lengths, device_prune=False)
    for b in range(2):
        L = int(lengths[b])
        kw = dict(
            frame_states=np.concatenate([res.init_states[None], res.frame_states[:L, b]]),
            frame_costs=np.concatenate([res.init_costs[None], res.frame_costs[:L, b]]),
            init_eps_records=res.init_eps_records,
            em_records=res.em_records[:L, b],
            eps_records=res.eps_records[:L, b],
            scores=scores[b, :L],
            lattice_beam=5.0,
        )
        ref = jprune.flat_arc_arrays(jprune.prune_lattice(graph=jg, **kw))
        got = pprune.flat_arc_arrays(pprune.prune_lattice(graph=pg, **kw))
        assert len(ref) == len(got)
        for x, y in zip(ref, got):
            assert np.array_equal(x, y)


def _unfolded_decode(batch=2, seed=3):
    """A JAX decode of the small HLG on its unfolded graph (eps links in
    every frame), full records."""
    _, jg, pg = small_hlg()
    scores, lengths, _ = hlg_batch(batch, seed=seed)
    dec = JaxDecoder(jg, None, lattice_beam=5.0, em_records=256, eps_records=64,
                     pad_time_to=8, fold=False)
    return jg, pg, scores, lengths, dec.decode(scores, lengths, device_prune=False)


def _prune_inputs(res, scores, b, L):
    return dict(
        frame_states=np.concatenate([res.init_states[None], res.frame_states[:L, b]]),
        frame_costs=np.concatenate([res.init_costs[None], res.frame_costs[:L, b]]),
        init_eps_records=res.init_eps_records,
        em_records=res.em_records[:L, b],
        eps_records=res.eps_records[:L, b],
        scores=scores[b, :L],
        lattice_beam=5.0,
    )


@pytest.mark.parametrize("use_final_probs", [True, False])
def test_raw_lattice_and_shortest_path_match_jax(use_final_probs):
    """raw_lattice_to_fst of both copies' pruned lattices, then both
    ShortestPath copies on it and both topological orders."""
    from kaldi_decoder_tpu.fst.ops import shortest_path as jshortest
    from kaldi_decoder_tpu.fst.ops import topological_order as jtopo
    from kaldi_decoder_tpu_torch.fst.ops import shortest_path, topological_order

    jg, pg, scores, lengths, res = _unfolded_decode()
    jax_host_library()
    for b in range(2):
        kw = _prune_inputs(res, scores, b, int(lengths[b]))
        jl = jprune.raw_lattice_to_fst(
            jprune.prune_lattice(graph=jg, use_final_probs=use_final_probs, **kw),
            use_final_probs)
        pl = pprune.raw_lattice_to_fst(
            pprune.prune_lattice(graph=pg, use_final_probs=use_final_probs, **kw),
            use_final_probs)
        same_fst(jl, pl)
        assert any(a.ilabel == 0 for s in range(pl.num_states) for a in pl.arcs(s))
        same_fst(jshortest(jl), shortest_path(pl))
        assert jtopo(jl) == topological_order(pl) is not None


def test_shortest_path_of_a_cyclic_fst_matches_jax():
    """A cyclic FST goes through the Dijkstra fallback in both copies."""
    from kaldi_decoder_tpu.fst.ops import shortest_path as jshortest
    from kaldi_decoder_tpu.fst.ops import topological_order as jtopo
    from kaldi_decoder_tpu.fst.topo import random_fst
    from kaldi_decoder_tpu_torch.fst.ops import shortest_path, topological_order

    jax_host_library()
    for seed in range(3):
        jf = random_fst(30, 5, np.random.default_rng(seed), eps_prob=0.4,
                        acyclic_eps=False)
        pf = port_fst(jf)
        assert jtopo(jf) is None and topological_order(pf) is None
        same_fst(jshortest(jf), shortest_path(pf))


def test_incremental_lattice_matches_jax():
    """Both IncrementalLattice copies fed the same frames, pruned every 5
    frames: the same live counts after each prune, and the same finalized
    lattice with and without final probs."""
    jg, pg, scores, lengths, res = _unfolded_decode(batch=1, seed=4)
    L = int(lengths[0])
    incs = [jprune.IncrementalLattice(jg, 5.0, 0.1),
            pprune.IncrementalLattice(pg, 5.0, 0.1)]
    for inc in incs:
        inc.init_frame(res.init_states, res.init_costs, res.init_eps_records)
    for t in range(L):
        for inc in incs:
            inc.append_frame(res.frame_states[t, 0], res.frame_costs[t, 0],
                             res.em_records[t, 0], res.eps_records[t, 0], scores[0, t])
            if t % 5 == 4:
                inc.prune_active_tokens()
        assert incs[0].live_links() == incs[1].live_links()
        assert incs[0].live_tokens() == incs[1].live_tokens()
    for ufp in (True, False):
        j, p = incs[0].finalize(ufp), incs[1].finalize(ufp)
        same_fst(jprune.raw_lattice_to_fst(j, ufp), pprune.raw_lattice_to_fst(p, ufp))
        assert j.final_relative_cost == p.final_relative_cost


def test_workload_and_wer_copies():
    for seed in (0, 1):
        a, b = np.random.default_rng(seed), np.random.default_rng(seed)
        lex = jhlg.random_lexicon(60, 12, a, 2, 5)
        assert lex == phlg.random_lexicon(60, 12, b, 2, 5)
        corpus = jhlg.sample_corpus(60, 20, a, mean_len=6.0)
        assert corpus == phlg.sample_corpus(60, 20, b, mean_len=6.0)
        toks = jhlg.words_to_tokens(corpus[0], dict(lex))
        assert toks == phlg.words_to_tokens(corpus[0], dict(lex))
        assert np.array_equal(
            jhlg.synth_posteriors(toks, 12, a), phlg.synth_posteriors(toks, 12, b)
        )
        hyps = [c[1:] + [3] for c in corpus]
        assert str(jax_wer(corpus, hyps)) == str(wer(corpus, hyps))


def test_math_and_logging_copies():
    """``approx_equal``, ``approx_equal_array`` and ``get_logger`` are the
    JAX package's, exported alike; each logger is its package's root."""
    import itertools
    import logging

    from kaldi_decoder_tpu import utils as jutils
    from kaldi_decoder_tpu.utils import math as jmath
    from kaldi_decoder_tpu_torch import utils as putils
    from kaldi_decoder_tpu_torch.utils import math as pmath

    assert putils.__all__ == jutils.__all__
    vals = [0.0, -0.0, 1.0, 1.0005, 1.002, -1.0, 1e-30, 3.5e8, 3.5003e8, np.inf, -np.inf,
            np.nan]
    for a, b in itertools.product(vals, vals):
        for tol in (0.001, 1e-5):
            assert putils.approx_equal(a, b, tol) == jutils.approx_equal(a, b, tol), (a, b, tol)
    a, b = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    for tol in (0.001, 1e-5):
        assert np.array_equal(pmath.approx_equal_array(a, b, tol),
                              jmath.approx_equal_array(a, b, tol))
    assert pprune.approx_equal_array is pmath.approx_equal_array
    for utils, pkg in ((jutils, "kaldi_decoder_tpu"), (putils, "kaldi_decoder_tpu_torch")):
        root = utils.get_logger()
        assert isinstance(root, logging.Logger) and root.name == pkg
        assert logging.getLogger(f"{pkg}.decoders.lattice").parent is root


def test_make_hlg_and_utterances_copies():
    """``make_hlg`` (``build_hlg`` of the same lexicon and corpus) and
    ``make_utterances`` equal the JAX package's from the same seeds."""
    for kw in (dict(num_words=30, num_tokens=10, num_sentences=50, seed=1),
               dict(num_words=40, num_tokens=12, num_sentences=120, seed=3,
                    modified_topo=True)):
        j, p = jhlg.make_hlg(**kw), phlg.make_hlg(**kw)
        assert type(p).__module__ == "kaldi_decoder_tpu_torch.fst.hlg"
        assert (p.lexicon, p.num_tokens, p.corpus) == (j.lexicon, j.num_tokens, j.corpus)
        same_fst(j.hlg, p.hlg)
        assert p.pron == j.pron
        for seed in (0, 5):
            a = jhlg.make_utterances(j, 3, np.random.default_rng(seed), words_per_utt=(2, 5))
            b = phlg.make_utterances(p, 3, np.random.default_rng(seed), words_per_utt=(2, 5))
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]


def test_host_source_copy_matches_original():
    """The port builds its host library from its own copy of the JAX
    package's C++ source.  Under a two-line header naming the original,
    the copy is that source byte for byte, but for one comment line (the
    fifth) that names a file of the reference without its checkout path."""
    from kaldi_decoder_tpu_torch.native import HOST_SOURCE

    original = os.path.join(REPO, "kaldi_decoder_tpu", "native", "csrc", "kdtpu_host.cc")
    assert os.path.dirname(HOST_SOURCE).startswith(os.path.join(REPO, "kaldi_decoder_tpu_torch"))
    with open(HOST_SOURCE, "rb") as f, open(original, "rb") as g:
        copy, orig = f.read().split(b"\n"), g.read().split(b"\n")
    assert copy[0].startswith(b"// A copy of kaldi_decoder_tpu/native/csrc/kdtpu_host.cc")
    body = copy[2:]
    assert len(body) == len(orig)
    differ = [i for i, (a, b) in enumerate(zip(body, orig)) if a != b]
    assert differ == [4] and body[4].startswith(b"//") and orig[4].startswith(b"//")


def test_port_imports_and_decodes_without_jax():
    """With jax unimportable, every module of the port (the graph files,
    oracles, post-processing, encoder, profiling and the CLI included) and
    ``chip_smoke.py`` and ``scripts/measure_recall_torch.py`` import, and a
    small eps-free graph decodes to a 1-best on the CPU."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import importlib, pkgutil
        import numpy as np
        import kaldi_decoder_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        for name in ("cli", "fst.io", "fst.topo", "fst.synthetic", "decoders.ref_simple",
                     "decoders.ref_lattice", "lattice.post", "lattice.recall", "models.ctc",
                     "utils.profiling"):
            assert "kaldi_decoder_tpu_torch." + name in names, name
        import chip_smoke
        sys.path.insert(0, "scripts")
        import measure_recall_torch
        assert not any(n == "jax" or n.startswith(("jax.", "kaldi_decoder_tpu."))
                       for n in sys.modules if sys.modules[n] is not None)
        from kaldi_decoder_tpu_torch import BatchedLatticeDecoder
        from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays
        rng = np.random.default_rng(0)
        S, E, V = 40, 200, 6
        src = np.sort(rng.integers(0, S, E))
        row = np.zeros(S + 1, np.int32); row[1:] = np.cumsum(np.bincount(src, minlength=S))
        il = rng.integers(1, V + 1, E).astype(np.int32)
        ga = GraphArrays(row, il, rng.integers(0, 9, E).astype(np.int32),
                         rng.uniform(0, 3, E).astype(np.float32),
                         rng.integers(0, S, E).astype(np.int32), il - 1,
                         np.zeros(S + 1, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.float32), np.zeros(0, np.int32),
                         np.where(rng.random(S) < 0.3, 0.5, np.inf).astype(np.float32))
        deg = np.diff(row)
        g = CsrGraph(ga, S, E, 0, 0, 0, int(deg.max()), 0, V - 1)
        scores = np.log(rng.dirichlet(np.ones(V), size=(2, 12))).astype(np.float32)
        dec = BatchedLatticeDecoder(g, None, lattice_beam=4.0, pad_time_to=4, device="cpu")
        res = dec.decode(scores, chunk_frames=4)
        labels = [res.best_path_labels(b) for b in range(2)]
        assert all(isinstance(x, list) for x in labels), labels
        print("OK")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
