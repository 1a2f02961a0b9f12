"""Decoding with Hm, k2's modified CTC topology: the port against the JAX
package, on the CPU.

Hm (``ctc_topo(V, modified=True)``) has a blank loop state, a state a
token with a self-loop that emits its repeats, and a free eps arc from each
token state back to the blank state: O(V) arcs, eps depth 1.  The batched
decoders fold its eps arcs (``eps_iters`` 0) or keep them (``fold=False``,
one eps iteration a frame), the streaming decoders keep them, and the
sharded decoders never fold (the routed eps closure).  Inputs are made
with numpy from fixed seeds and handed to both packages.

- ``fold_eps`` of Hm against the JAX fold, array for array, and the
  folded records expanded back (``expand_em_records``,
  ``expand_with_alphas``).
- ``BatchedViterbiDecoder`` and ``BatchedLatticeDecoder``, folded and
  ``fold=False``, against the JAX batched decoders: every result field,
  floats by their bits, best paths, lattices and labels.
- ``FasterDecoder`` and ``LatticeFasterDecoder``, streamed in pieces,
  against the JAX streaming decoders.
- ``ShardedViterbiDecoder`` and ``ShardedLatticeDecoder`` at P = 1 and 2,
  ranks over gloo (``tests/_torch_dist_worker.py``), against the JAX
  sharded decoders on P virtual CPU devices.
- The two faults of the reference that the port keeps (ROADMAP Queue 3):
  the streaming ``FasterDecoder`` on the standard H truncates its
  expansion at its derived arc budget (6 K), and the streaming
  ``LatticeFasterDecoder`` on Hm derives fewer eps records than a row has
  eps lanes; the port and JAX overflow on the same frames.
- ``tests/data/torch_port_hmod_ref.json`` was made at ``chip_smoke.py``'s
  phase-15 config.
"""

import json
import os
import tempfile
import threading

import numpy as np
import pytest

from kaldi_decoder_tpu.decodable import DecodableCtc as JaxDecodableCtc
from kaldi_decoder_tpu.decoders import lattice as jlattice
from kaldi_decoder_tpu.decoders.api import FasterDecoder as JaxFasterDecoder
from kaldi_decoder_tpu.decoders.api import FasterDecoderOptions as JaxOptions
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxLattice
from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import ctc_topo
from kaldi_decoder_tpu.fst import fold as jfold
from kaldi_decoder_tpu.fst.ops import path_labels as jax_path_labels
from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch import (
    BatchedLatticeDecoder,
    BatchedViterbiDecoder,
    DecodableCtc,
    FasterDecoder,
    FasterDecoderOptions,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
)
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.fst import fold as pfold
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.fst.ops import path_labels

from _torch_dist_worker import run_ranks
from _torch_util import assert_same_config, jax_host_library, same_fst, twin_configs
from test_torch_graph_shard import (
    LATTICE_FIELDS,
    VITERBI_FIELDS,
    jax_mesh,
    links,
    rand_logp,
    same_array,
)
from test_torch_host import _assert_graph_equal
from test_torch_lattice_eps import _same_stats
from test_torch_viterbi import _api_result_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V = 24  # Hm(24): 24 states, 47 emitting and 23 eps arcs


def _hm(V=V):
    """(JAX graph, port graph) of ``ctc_topo(V, modified=True)``."""
    g = jax_compile(ctc_topo(V, modified=True))
    return g, graph_from_numpy(g)


def _batch(seed, T=30, B=3, V=V):
    rng = np.random.default_rng(seed)
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return scores, np.array([T, T - 11, T - 5][:B], np.int32)


# ---------------------------------------------------------------------------
# The fold
# ---------------------------------------------------------------------------


def test_fold_of_hm_matches_jax():
    """``fold_eps`` of Hm: the folded device graph (each token state's
    return to the blank state folded into the arcs that enter it), its
    paths, eps sources and start closure, and folded records expanded back
    with and without alphas, equal JAX's array for array."""
    jg, pg = _hm()
    assert (jg.num_states, jg.num_emitting_arcs, jg.num_eps_arcs, jg.eps_depth) == (
        V, 2 * V - 1, V - 1, 1)
    ref, got = jfold.fold_eps(jg), pfold.fold_eps(pg)
    _assert_graph_equal(ref.device, got.device)
    assert got.device.num_eps_arcs == 0
    for f in ("path_ptr", "path_arcs", "eps_src"):
        assert np.array_equal(getattr(ref, f), getattr(got, f)), f
    for f in ("states", "costs", "eps_records"):
        assert np.array_equal(getattr(ref.start, f), getattr(got.start, f)), f
    assert ref.start.paths == got.start.paths
    rng = np.random.default_rng(7)
    A = got.device.num_emitting_arcs
    arcs = rng.integers(-1, A, size=40).astype(np.int32)
    src = np.where(arcs >= 0, rng.integers(0, V, size=40), -1).astype(np.int32)
    recs = np.stack([src, arcs], axis=1)
    for x, y in zip(ref.expand_em_records(recs), got.expand_em_records(recs)):
        assert np.array_equal(x, y)
    states = np.arange(V, dtype=np.int32)
    alphas = (rng.integers(0, 40, size=V) * 0.25).astype(np.float32)
    scores_t = rand_logp(rng, 1, V)[0]
    for x, y in zip(ref.expand_with_alphas(recs, states, alphas, scores_t),
                    got.expand_with_alphas(recs, states, alphas, scores_t)):
        same_array(x, y, "expand_with_alphas")


# ---------------------------------------------------------------------------
# The batched decoders, folded and not
# ---------------------------------------------------------------------------


CONFIG = dict(beam=9.0, max_active=14, min_active=3, frontier_size=32)


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_batched_viterbi_on_hm_matches_jax(fold):
    """``BatchedViterbiDecoder`` on Hm: the device config (eps_iters 0
    folded, 1 not), every result field, the flags and the best paths equal
    JAX's."""
    jg, pg = _hm()
    scores, lengths = _batch(3)
    jfc, pfc = twin_configs(jg, pg, **CONFIG)
    jd = JaxViterbi(jg, jfc, fold=fold, pad_time_to=8)
    pd = BatchedViterbiDecoder(pg, pfc, fold=fold, pad_time_to=8, device="cpu")
    assert_same_config(jd.cfg, pd.cfg, eps=not fold)
    jr, pr = jd.decode(scores, lengths), pd.decode(scores, lengths)
    for f in VITERBI_FIELDS + ("lengths",):
        same_array(getattr(jr, f), getattr(pr, f), f)
    jax_host_library()
    for b in range(scores.shape[0]):
        same_fst(jr.best_path(b), pr.best_path(b))


@pytest.mark.parametrize("fold", [True, False], ids=["folded", "unfolded"])
def test_batched_lattice_on_hm_matches_jax(fold):
    """``BatchedLatticeDecoder`` on Hm at a wide lattice beam, swept on the
    device in chunks: the config, the per-frame stats, the survivors or
    the full records, the raw lattices, best paths and labels equal
    JAX's."""
    jg, pg = _hm()
    scores, lengths = _batch(4)
    jfc, pfc = twin_configs(jg, pg, **CONFIG)
    kw = dict(lattice_beam=8.0, em_records=256, eps_records=64, pad_time_to=8, fold=fold)
    jd, pd = JaxLattice(jg, jfc, **kw), BatchedLatticeDecoder(pg, pfc, device="cpu", **kw)
    assert_same_config(jd.cfg.frontier, pd.cfg.frontier, eps=not fold)
    assert (jd.cfg.em_records, jd.cfg.eps_records) == (pd.cfg.em_records, pd.cfg.eps_records)
    jr = jd.decode(scores, lengths, chunk_frames=8)
    pr = pd.decode(scores, lengths, chunk_frames=8)
    for f in ("num_active", "cutoffs", "overflows", "saturations"):
        same_array(getattr(jr, f), getattr(pr, f), f)
    assert not pr.overflows.any() and not pr.saturations.any()
    assert (jr.survivors is None) == (pr.survivors is None)
    jax_host_library()
    for b in range(scores.shape[0]):
        same_fst(jr.raw_lattice(b), pr.raw_lattice(b))
        same_fst(jr.best_path(b), pr.best_path(b))
        assert jr.best_path_labels(b) == pr.best_path_labels(b), b
        assert jr.final_relative_cost(b) == pr.final_relative_cost(b)


# ---------------------------------------------------------------------------
# The streaming decoders
# ---------------------------------------------------------------------------


STREAM = dict(beam=12.0, max_active=40, min_active=5)


def _stream(dec, decodable, L, piece, finalize=False):
    dec.init_decoding()
    while dec.num_frames_decoded() < L:
        dec.advance_decoding(decodable, max_num_frames=piece)
    if finalize:
        dec.finalize_decoding()


def test_faster_decoder_on_hm_matches_jax():
    """``FasterDecoder`` on Hm (unfolded: one eps iteration a frame and its
    start closure), streamed in pieces of 7 frames: its config and every
    field of its result equal the JAX decoder's."""
    jg, pg = _hm()
    scores, lengths = _batch(5, T=40, B=1)
    L = int(lengths[0])
    jd = JaxFasterDecoder(jg, JaxOptions(**STREAM))
    pd = FasterDecoder(pg, FasterDecoderOptions(**STREAM), device="cpu")
    assert_same_config(jd._cfg, pd._cfg, eps=True)
    _stream(jd, JaxDecodableCtc(scores[0, :L]), L, 7)
    _stream(pd, DecodableCtc(scores[0, :L]), L, 7)
    _api_result_equal(jd, pd)
    assert not pd._result().overflows.any()


def test_lattice_faster_decoder_on_hm_matches_jax():
    """``LatticeFasterDecoder`` on Hm with eps records enough for a row's
    eps lanes (``prune_interval`` 10), streamed in pieces of 9 frames and
    finalized: raw lattice, best path, ``reached_final``,
    ``final_relative_cost`` and stats equal JAX's, with no overflow."""
    jg, pg = _hm()
    scores, lengths = _batch(6, T=40, B=1)
    L = int(lengths[0])
    kw = dict(STREAM, lattice_beam=6.0, prune_interval=10)
    jd = jlattice.LatticeFasterDecoder(jg, jlattice.LatticeFasterDecoderConfig(**kw))
    pd = LatticeFasterDecoder(pg, LatticeFasterDecoderConfig(**kw), device="cpu")
    assert_same_config(jd._dev_cfg.frontier, pd._dev_cfg.frontier, eps=True)
    _stream(jd, JaxDecodableCtc(scores[0, :L]), L, 9, finalize=True)
    _stream(pd, DecodableCtc(scores[0, :L]), L, 9, finalize=True)
    jax_host_library()
    same_fst(jd.get_raw_lattice()[1], pd.get_raw_lattice()[1])
    jok, jbest = jd.get_best_path()
    pok, pbest = pd.get_best_path()
    assert jok == pok is True
    same_fst(jbest, pbest)
    assert jd.reached_final() == pd.reached_final()
    assert jd.final_relative_cost() == pd.final_relative_cost()
    _same_stats(jd.stats(), pd.stats())


# ---------------------------------------------------------------------------
# The kept faults of the reference (ROADMAP Queue 3)
# ---------------------------------------------------------------------------


PHASE5 = dict(beam=15.0, max_active=2560, min_active=200)  # chip_smoke.STREAM_OPTIONS


def test_kept_fault_faster_decoder_on_h_truncates_like_jax():
    """Fault 3: ``FasterDecoder`` with phase 5's options on the standard H
    over 300 tokens derives K 512 and an arc budget of 6 K = 3072
    remainder lanes a row, far below the ~80,000 a frame of flat
    posteriors needs; the port truncates on the same frames as JAX, and
    every other field agrees."""
    jg = jax_compile(ctc_topo(300))
    pg = graph_from_numpy(jg)
    rng = np.random.default_rng(8)
    logp = rand_logp(rng, 12, 300)
    jd = JaxFasterDecoder(jg, JaxOptions(**PHASE5))
    pd = FasterDecoder(pg, FasterDecoderOptions(**PHASE5), device="cpu")
    assert_same_config(jd._cfg, pd._cfg)
    assert (pd._cfg.frontier_size, pd._cfg.rem_budget) == (512, 6 * 512)
    _stream(jd, JaxDecodableCtc(logp), 12, 5)
    _stream(pd, DecodableCtc(logp), 12, 5)
    _api_result_equal(jd, pd)
    ovf = pd._result().overflows[:, 0]
    assert ovf[1:].all(), ovf  # every frame after the first, in both packages


def test_kept_fault_lattice_faster_eps_records_overflow_like_jax():
    """Fault 1: ``LatticeFasterDecoder`` with phase 7's config on Hm
    derives eps_records below the eps lanes of a row (a quarter of the eps
    iteration's candidates); the port's records overflow on the same
    frames as JAX's, and the lattices still agree."""
    jg, pg = _hm()
    rng = np.random.default_rng(9)
    L = 20
    logp = rand_logp(rng, L, V)
    kw = dict(PHASE5, lattice_beam=8.0)
    jd = jlattice.LatticeFasterDecoder(jg, jlattice.LatticeFasterDecoderConfig(**kw))
    pd = LatticeFasterDecoder(pg, LatticeFasterDecoderConfig(**kw), device="cpu")
    c = pd._dev_cfg
    assert (jd._dev_cfg.eps_records, jd._dev_cfg.em_records) == (c.eps_records, c.em_records)
    assert c.eps_records < c.frontier.eps_rem_budget == V - 1
    _stream(jd, JaxDecodableCtc(logp), L, 9, finalize=True)
    _stream(pd, DecodableCtc(logp), L, 9, finalize=True)
    _same_stats(jd.stats(), pd.stats())
    jovf, povf = (np.concatenate([c["overflows"] for c in d._stats]) for d in (jd, pd))
    same_array(jovf, povf, "the overflow flag of each frame")
    assert pd.stats().arc_budget_overflows >= L // 2
    jax_host_library()
    same_fst(jd.get_raw_lattice()[1], pd.get_raw_lattice()[1])


# ---------------------------------------------------------------------------
# The sharded decoders: the routed eps closure, ranks over gloo
# ---------------------------------------------------------------------------


def _shard_case(kind):
    """Hm(24) at K 32 a shard (a part of 12 states at P = 2), 3
    utterances of 12 frames and fewer; min_active and max_active bind."""
    jg, _ = _hm()
    rng = np.random.default_rng(23)
    scores = np.stack([rand_logp(rng, 12, V) for _ in range(3)])
    dkw = dict(pad_time_to=8, route_cap=64)
    if kind == "lattice":
        dkw.update(lattice_beam=6.0, em_records=256, eps_records=64)
    return jg, dict(CONFIG, max_active=10), dkw, scores, np.array([12, 7, 10], np.int32)


SHARD_RUNS = [(kind, P) for P in (1, 2) for kind in ("viterbi", "lattice")]


@pytest.fixture(scope="module")
def shard_results():
    """{P: [rank results]}: both sharded decoders on Hm decoded by P ranks
    over gloo, P = 1 and 2 at once."""
    jobs = {P: dict(world=P, cases={}) for P in (1, 2)}
    for kind, P in SHARD_RUNS:
        jg, ckw, dkw, scores, lengths = _shard_case(kind)
        pg = graph_from_numpy(jg)
        jobs[P]["cases"][kind] = dict(
            decoder="ShardedViterbiDecoder" if kind == "viterbi" else "ShardedLatticeDecoder",
            mesh=((P,), ("model",)), args=(pg, config_for_graph(pg, **ckw)), kw=dkw,
            scores=scores, lengths=lengths)
    out, errors = {}, []

    def go(P, tmp):
        try:
            out[P] = run_ranks(jobs[P], tmp)
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    with tempfile.TemporaryDirectory() as t1, tempfile.TemporaryDirectory() as t2:
        threads = [threading.Thread(target=go, args=(P, t)) for P, t in ((1, t1), (2, t2))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return out


@pytest.mark.parametrize("kind,P", SHARD_RUNS, ids=[f"{k}_p{P}" for k, P in SHARD_RUNS])
def test_sharded_on_hm_matches_jax(shard_results, kind, P):
    """Every field of the port's sharded decode on Hm (eps_iters 1: the
    routed eps closure) equals the JAX sharded decode's on a mesh of P
    devices, on every rank, floats by their bits; so do the 1-best labels
    and, for the lattice, the pruned links."""
    jg, ckw, dkw, scores, lengths = _shard_case(kind)
    jfc, pfc = twin_configs(jg, graph_from_numpy(jg), **ckw)
    assert jfc.eps_iters == pfc.eps_iters == 1
    cls = jgs.ShardedViterbiDecoder if kind == "viterbi" else jgs.ShardedLatticeDecoder
    want = cls(jg, jfc, mesh=jax_mesh((P,), ("model",)), **dkw).decode(scores, lengths)
    fields = VITERBI_FIELDS if kind == "viterbi" else LATTICE_FIELDS
    ranks = shard_results[P]
    for r, got in enumerate(r[kind] for r in ranks):
        for f in fields:
            same_array(getattr(want, f), getattr(got, f), f"rank {r}: {f}")
    got = ranks[0][kind]
    assert not got.overflows.any() and not got.saturations.any()
    jax_host_library()
    for b in range(scores.shape[0]):
        lw, lg = want.best_path(b), got.best_path(b)
        assert (lw is None) == (lg is None)
        if lw is not None:
            assert path_labels(lg) == [int(x) for x in jax_path_labels(lw)], f"utt {b}"
        if kind == "lattice":
            pw, pp = want._prune(b), got._prune(b)
            assert (pw is None) == (pp is None)
            if pw is not None:
                assert links(pw) == links(pp), f"utt {b}"


# ---------------------------------------------------------------------------
# Phase 15's reference
# ---------------------------------------------------------------------------


def test_hmod_reference_matches_its_script():
    """``tests/data/torch_port_hmod_ref.json`` (the reference of
    ``chip_smoke.py`` phase 15) was made by
    ``scripts/make_torch_hmod_reference.py`` at the smoke's config and cut,
    on every utterance; its configs are the ones the port derives on Hm
    for each decoder; only the kept faults overflow, the 1-best decodes
    and the sharded and batched lattices nowhere, and nothing saturates."""
    import chip_smoke as cs
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_config_for_graph
    from kaldi_decoder_tpu_torch.decoders.frontier import _cfg_for_device_graph
    from kaldi_decoder_tpu_torch.parallel import graph_shard as pgs

    with open(os.path.join(REPO, "tests", "data", "torch_port_hmod_ref.json")) as f:
        ref = json.load(f)
    assert ref["requested"] == dict(config=cs.HM_CONFIG, lattice=cs.HM_LATTICE_KW,
                                    route_cap=cs.HM_ROUTE_CAP, chunk_frames=cs.CHUNK,
                                    stream_options=cs.STREAM_OPTIONS)
    w = ref["workload"]
    assert (w["V"], w["utterances"], w["shard_frames"], w["frames"], w["stream_utterances"]) == (
        cs.V, cs.B, cs.HM_SHARD_FRAMES, None, cs.HM_STREAM_UTTS)
    hm = cs.hm_graph()
    assert (hm.num_states, hm.num_emitting_arcs, hm.num_eps_arcs, hm.eps_depth) == (
        500, 999, 499, 1)
    fc = config_for_graph(hm, **cs.HM_CONFIG)
    bat = ref["batched"]
    folded = _cfg_for_device_graph(pfold.fold_eps(hm).device, fc)
    for key, cfg in (("viterbi", folded), ("lattice", folded), ("lattice_unfolded", fc)):
        want = bat[key + "_config"]
        got = {k: getattr(cfg, k) for k in want if hasattr(cfg, k)}
        if key != "viterbi":
            lc = lattice_config_for_graph(hm, cfg, **cs.HM_LATTICE_KW)
            got.update(em_records=lc.em_records, eps_records=lc.eps_records,
                       lattice_beam=lc.lattice_beam)
        assert got == want, key
        assert len(bat[key]) == cs.B
    assert bat["viterbi_config"]["eps_iters"] == 0 and fc.eps_iters == 1
    assert bat["lattice_unfolded_config"]["eps_records"] == 512
    for key in ("lattice", "lattice_unfolded"):
        assert any(u["sweep_fell_back"] for u in bat[key])  # the survivor buffers overflow
    for P, part in ref["parts"].items():
        own = pgs.local_part(hm, int(P), 0, fc.block_width, fc.eps_block_width, fc.flat_group,
                             "cpu")
        lc = pgs.shard_lattice_config_for(own, fc, route_cap=cs.HM_ROUTE_CAP,
                                          **cs.HM_LATTICE_KW)
        sc = lc.shard
        got = {k: getattr(sc.frontier, k) for k in part["viterbi_config"]
               if hasattr(sc.frontier, k)}
        got.update(num_parts=sc.num_parts, part_size=sc.part_size, route_cap=sc.route_cap,
                   eps_route_cap=sc.eps_route_cap, em_records=lc.em_records,
                   eps_records=lc.eps_records, lattice_beam=lc.lattice_beam)
        assert got == part["shard_config"], P
        assert sc.frontier.eps_iters == 1
    runs = [bat[k] for k in ("viterbi", "lattice", "lattice_unfolded")] + [
        part[k] for part in ref["parts"].values() for k in ("viterbi", "lattice")]
    for utts in runs:
        assert len(utts) == cs.B
        assert all(u["overflow_frames"] == u["saturated_frames"] == 0 for u in utts)
    stream = ref["streaming"]
    assert stream["faster"]["options"] == cs.STREAM_OPTIONS
    assert all(u["overflow_frames"] == 0 for u in stream["faster"]["utts"])
    assert stream["faster_h"]["device_config"]["rem_budget"] == 6 * 512
    assert stream["lattice_faster"]["device_config"]["eps_records"] < 499
    for key, must in (("faster_h", True), ("lattice_faster", True)):
        ovf = [u["overflow_frames"] for u in stream[key]["utts"]]
        assert ref["kept_faults"][key]["overflow_frames"] == ovf
        assert all(o > 0 for o in ovf) == must, key
        assert all(u["saturated_frames"] == 0 for u in stream[key]["utts"])
