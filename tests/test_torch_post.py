"""Twin tests of the port's lattice post-processing against the JAX
package's (``lattice/post.py``): n-best, paths_to_fst, determinization
(with and without token alignments, with and without a beam), scaling
and LM rescoring, on oracle lattices of seeded random graphs and of the
small HLG.  Every result must be exact."""

import functools

import numpy as np
import pytest

from kaldi_decoder_tpu.decodable import DecodableCtc
from kaldi_decoder_tpu.decoders.ref_lattice import OracleLatticeDecoder
from kaldi_decoder_tpu.fst.topo import random_fst
from kaldi_decoder_tpu.lattice import post as jpost
from kaldi_decoder_tpu_torch.lattice import post as ppost

from _torch_util import hlg_batch, port_fst, same_fst, small_hlg


@functools.lru_cache(maxsize=None)
def _lattice(name):
    if name == "hlg":
        g, _, _ = small_hlg()
        fst = g.hlg
        scores, lengths, _ = hlg_batch(1, seed=5)
        logp = scores[0, : int(lengths[0])]
    else:
        rng = np.random.default_rng(int(name[-1]))
        fst = random_fst(40, 8, rng, eps_prob=0.25)
        logp = np.log(rng.dirichlet(np.ones(8), size=10)).astype(np.float32)
    # A lattice beam of 3 keeps the rescoring's per-history expansion small.
    d = OracleLatticeDecoder(fst, beam=10.0, lattice_beam=3.0, deterministic_cutoff=True)
    d.decode(DecodableCtc(logp))
    lat = d.get_raw_lattice()
    assert lat is not None and lat.num_states > 0
    return lat


LATTICES = ("random0", "random1", "hlg")


@pytest.mark.parametrize("name", LATTICES)
def test_nbest_and_paths_to_fst_match_jax(name):
    jl = _lattice(name)
    pl = port_fst(jl)
    for unique in (False, True):
        want = jpost.nbest(jl, 6, unique_word_sequences=unique)
        got = ppost.nbest(pl, 6, unique_word_sequences=unique)
        assert want == got and len(got) > 0
        same_fst(jpost.paths_to_fst(want), ppost.paths_to_fst(got))


@pytest.mark.parametrize("name", LATTICES)
def test_determinize_lattice_matches_jax(name):
    jl = _lattice(name)
    pl = port_fst(jl)
    for beam in (None, 2.0):
        same_fst(jpost.determinize_lattice(jl, beam=beam),
                 ppost.determinize_lattice(pl, beam=beam))
        jd, ja = jpost.determinize_lattice(jl, beam=beam, with_alignments=True)
        pd, pa = ppost.determinize_lattice(pl, beam=beam, with_alignments=True)
        same_fst(jd, pd)
        assert (ja.arcs, ja.finals) == (pa.arcs, pa.finals)
        for _, words, _, _ in ppost.nbest(pl, 3, unique_word_sequences=True):
            assert jpost.alignment_of(jd, ja, words) == ppost.alignment_of(pd, pa, words)


@pytest.mark.parametrize("name", LATTICES)
def test_scale_and_rescore_match_jax(name):
    jl = _lattice(name)
    pl = port_fst(jl)
    same_fst(jpost.scale_lattice(jl, acoustic_scale=0.1, lm_scale=1.5),
             ppost.scale_lattice(pl, acoustic_scale=0.1, lm_scale=1.5))

    def lm(hist, word):
        return 0.5 * len(hist) + 0.125 * (word % 7)

    same_fst(jpost.rescore_lattice_with_lm(jl, lm, lm_scale=0.75, old_lm_scale=0.5),
             ppost.rescore_lattice_with_lm(pl, lm, lm_scale=0.75, old_lm_scale=0.5))
