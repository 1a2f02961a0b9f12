"""Twin tests of the port's oracle decoders and ``CsrFstView`` against
the JAX package's (``decoders/ref_simple.py``, ``decoders/ref_lattice.py``,
``fst/csr.py:189-239``), on the graphs and scores of ``tests/test_oracle.py``
made from fixed seeds: frontiers, link sets, raw lattices, best paths and
costs must be exact."""

import numpy as np
import pytest

from kaldi_decoder_tpu.decodable import DecodableCtc as JaxDecodableCtc
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxLatticeDecoder
from kaldi_decoder_tpu.decoders.ref_lattice import OracleLatticeDecoder as JaxOracleLattice
from kaldi_decoder_tpu.decoders.ref_simple import OracleSimpleDecoder as JaxOracleSimple
from kaldi_decoder_tpu.fst.csr import CsrFstView as JaxCsrFstView
from kaldi_decoder_tpu.fst.csr import compile_fst as jax_compile_fst
from kaldi_decoder_tpu.fst.ops import path_labels as jax_path_labels
from kaldi_decoder_tpu.fst.topo import ctc_topo, random_fst
from kaldi_decoder_tpu_torch import (
    BatchedLatticeDecoder,
    DecodableCtc,
    OracleLatticeDecoder,
    OracleSimpleDecoder,
)
from kaldi_decoder_tpu_torch.fst.csr import CsrFstView, graph_from_numpy
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.lattice.recall import device_recall, oracle_lattice, oracle_link_set

from _lattice_util import device_link_set as jax_device_link_set
from _lattice_util import oracle_link_set as jax_oracle_link_set
from _torch_util import (
    hlg_batch,
    jax_host_library,
    port_fst,
    same_fst,
    small_hlg,
    twin_configs,
)


def _case(seed, V=8, T=12):
    rng = np.random.default_rng(seed)
    fst = random_fst(int(rng.integers(10, 60)), V, rng, eps_prob=0.25)
    logp = np.log(rng.dirichlet(np.ones(V), size=T)).astype(np.float32)
    return fst, logp


@pytest.mark.parametrize("seed", range(4))
def test_oracle_simple_matches_jax(seed):
    """Frontier, best path (with and without final probs), reached_final
    and final_relative_cost after a whole decode and after a streamed
    one in pieces of 5 frames."""
    fst, logp = _case(seed)
    jd, pd = JaxOracleSimple(fst, beam=8.0), OracleSimpleDecoder(port_fst(fst), beam=8.0)
    assert jd.decode(JaxDecodableCtc(logp)) == pd.decode(DecodableCtc(logp))
    for ufp in (True, False):
        same_fst(jd.get_best_path(ufp), pd.get_best_path(ufp))
    assert jd.frontier() == pd.frontier()
    assert jd.reached_final() == pd.reached_final()
    assert jd.final_relative_cost() == pd.final_relative_cost()

    js, ps = JaxOracleSimple(fst, beam=8.0), OracleSimpleDecoder(port_fst(fst), beam=8.0)
    for d, dec in ((js, JaxDecodableCtc(logp)), (ps, DecodableCtc(logp))):
        d.init_decoding()
        while d.num_frames_decoded < logp.shape[0]:
            d.advance_decoding(dec, max_num_frames=5)
    assert js.frontier() == ps.frontier() == pd.frontier()
    same_fst(js.get_best_path(), ps.get_best_path())


def test_oracle_simple_on_ctc_topo_matches_jax():
    """The peaked-posterior H decode of ``tests/test_oracle.py``."""
    V, T = 10, 40
    rng = np.random.default_rng(42)
    ids = rng.integers(0, V, size=T)
    logp = np.full((T, V), -12.0, np.float32)
    logp[np.arange(T), ids] = -0.05
    H = ctc_topo(V)
    jd, pd = JaxOracleSimple(H, beam=16.0), OracleSimpleDecoder(port_fst(H), beam=16.0)
    jd.decode(JaxDecodableCtc(logp))
    pd.decode(DecodableCtc(logp))
    same_fst(jd.get_best_path(), pd.get_best_path())


LATTICE_KW = {
    "evolving": dict(beam=8.0, lattice_beam=5.0),
    "deterministic": dict(beam=8.0, lattice_beam=5.0, deterministic_cutoff=True),
    "max-active": dict(beam=10.0, lattice_beam=6.0, deterministic_cutoff=True, max_active=6,
                       min_active=2, beam_delta=0.25),
}


def _decode(d, decodable):
    """``decode``'s result, or the KeyError both copies raise when the
    evolving-cutoff mode's eps closure pops a state that the beam prune
    took out of ``cur_toks`` (ROADMAP Queue 3)."""
    try:
        return d.decode(decodable)
    except KeyError as e:
        return f"KeyError: {e}"


@pytest.mark.parametrize("kind", sorted(LATTICE_KW))
@pytest.mark.parametrize("seed", [0, 1])
def test_oracle_lattice_matches_jax(kind, seed):
    """The pruned link set (the canonical set ``scripts/measure_recall.py``
    counts), the raw lattice and the best path, with and without final
    probs, and final_relative_cost."""
    fst, logp = _case(10 + seed, T=15)
    kw = LATTICE_KW[kind]
    jd, pd = JaxOracleLattice(fst, **kw), OracleLatticeDecoder(port_fst(fst), **kw)
    ok = _decode(jd, JaxDecodableCtc(logp))
    assert ok == _decode(pd, DecodableCtc(logp))
    if isinstance(ok, str):
        assert kind == "evolving"
        return
    assert jax_oracle_link_set(jd) == oracle_link_set(pd)
    assert len(oracle_link_set(pd)) > 0
    jax_host_library()
    for ufp in (True, False):
        same_fst(jd.get_raw_lattice(ufp), pd.get_raw_lattice(ufp))
        same_fst(jd.get_best_path(ufp), pd.get_best_path(ufp))
    assert jd.final_relative_cost() == pd.final_relative_cost()


def test_oracle_max_active_requires_deterministic_cutoff():
    fst, _ = _case(0)
    with pytest.raises(ValueError, match="deterministic_cutoff"):
        OracleLatticeDecoder(port_fst(fst), max_active=5)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_fst_view_matches_jax(seed):
    """Every state's arcs, final weight and input-eps count through both
    views of the same compiled graph, and the lattice oracle run on the
    views (the recall measurement's route)."""
    fst, logp = _case(20 + seed, T=10)
    cg = jax_compile_fst(fst)
    jv, pv = JaxCsrFstView(cg), CsrFstView(graph_from_numpy(cg))
    assert (jv.start, jv.num_states) == (pv.start, pv.num_states)
    for s in range(pv.num_states):
        assert list(jv.arcs(s)) == [tuple(a) for a in pv.arcs(s)]
        assert jv.final(s) == pv.final(s)
        assert jv.num_input_epsilons(s) == pv.num_input_epsilons(s)
    kw = LATTICE_KW["max-active"]
    jd, pd = JaxOracleLattice(jv, **kw), OracleLatticeDecoder(pv, **kw)
    jd.decode(JaxDecodableCtc(logp))
    pd.decode(DecodableCtc(logp))
    assert jax_oracle_link_set(jd) == oracle_link_set(pd)


@pytest.mark.parametrize("em_records", [64, 512])
def test_device_recall_matches_jax(em_records):
    """The recall measurement of ``lattice.recall`` (the oracle on the
    compiled graph through ``CsrFstView``, the device lattice with
    ``device_prune=False``) against ``scripts/measure_recall.py``'s with
    the JAX oracle, decoder and link sets, on the small HLG: every field
    but the seconds.  em_records 64 overflows the records, 512 does not."""
    _, jg, pg = small_hlg()
    scores, lengths, _ = hlg_batch(1, seed=11)
    T = int(lengths[0])
    sc = np.ascontiguousarray(scores[0, :T])
    okw = dict(beam=12.0, lattice_beam=5.0, deterministic_cutoff=True, max_active=48,
               min_active=5)
    jax_host_library()
    jo = JaxOracleLattice(JaxCsrFstView(jg), **okw)
    jo.decode(JaxDecodableCtc(sc))
    jlinks, jlabels = jax_oracle_link_set(jo), jax_path_labels(jo.get_best_path())
    olinks, olabels, _ = oracle_lattice(OracleLatticeDecoder(CsrFstView(pg), **okw), sc)
    assert (olinks, olabels) == (jlinks, jlabels)

    fkw = dict(beam=12.0, frontier_size=64, max_active=48, min_active=5)
    jdev = JaxLatticeDecoder(jg, None, pad_time_to=8)._dev_graph
    jfc, pfc = twin_configs(jdev, fold_eps(pg).device, **fkw)
    dkw = dict(lattice_beam=5.0, em_records=em_records, pad_time_to=8)
    got = device_recall(BatchedLatticeDecoder(pg, pfc, device="cpu", **dkw), sc, olinks,
                        olabels, 8)
    jres = JaxLatticeDecoder(jg, jfc, **dkw).decode(sc[None], np.array([T], np.int32),
                                                    chunk_frames=8, device_prune=False)
    jdl, st, jbest = jax_device_link_set(jres), jres.stats(0), jres.best_path(0)
    want = {
        "em_records": em_records, "recall": len(jlinks & jdl) / len(jlinks),
        "device_links": len(jdl), "oracle_links": len(jlinks),
        "common_links": len(jlinks & jdl), "extra": len(jdl - jlinks),
        "overflow_frames": int(st.arc_budget_overflows),
        "saturated_frames": int(st.frontier_saturated_frames),
        "best_path_match": bool(jbest is not None and jax_path_labels(jbest) == jlabels),
    }
    assert {k: got[k] for k in want} == want
    assert (want["overflow_frames"] > 0) == (em_records == 64)
    assert want["common_links"] > 0
