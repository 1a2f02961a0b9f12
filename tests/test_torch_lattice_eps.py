"""The lattice decoder's eps path and the streaming lattice API against JAX.

On the CPU, the same graphs, numpy-seeded scores and configs go through the
JAX package and the port; everything compared is exact, floats by their
raw bits:

* K2's eps call (``dedup_select_rec`` with ``num_incumbents``): every
  field, ``cand_idx`` included, against the original's vmapped call;
* the sweep with eps records (``sweep_plain``) against ``_sweep_one``: on
  real chunks of the synthetic eps graph and of the cyclic ring, and on
  records whose negative slacks keep the Bellman changing to its bound;
* ``BatchedLatticeDecoder(fold=False)`` on the small HLG, the synthetic
  eps graph and the ring (converged, and unconverged with the flag set),
  swept and full, chunked and one-shot;
* ``LatticeResult``'s lattice API with fold on and off;
* ``BatchedLatticeDecoder`` built from a ``StdVectorFst`` read from an
  OpenFst file, as the reference takes one, folded and not;
* ``LatticeSimpleDecoder`` and ``LatticeFasterDecoder``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decodable import DecodableCtc as JaxDecodableCtc
from kaldi_decoder_tpu.decoders import lattice as jlattice
from kaldi_decoder_tpu.decoders.frontier import config_for_graph as jax_config_for_graph
from kaldi_decoder_tpu.decoders.sweep import SweepConfig as JaxSweepConfig
from kaldi_decoder_tpu.decoders.sweep import build_sweep_fn as jax_build_sweep_fn
from kaldi_decoder_tpu.fst.csr import compile_fst
from kaldi_decoder_tpu.fst.fst import EPSILON, StdVectorFst
from kaldi_decoder_tpu.fst.synthetic import synthetic_graph
from kaldi_decoder_tpu.ops.segment import dedup_select_rec as jax_dedup_select_rec
from kaldi_decoder_tpu_torch import (
    BatchedLatticeDecoder,
    DecodableCtc,
    LatticeFasterDecoder,
    LatticeFasterDecoderConfig,
    LatticeSimpleDecoder,
    LatticeSimpleDecoderConfig,
)
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.decoders.sweep import SweepConfig, sweep_plain
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec, stack_records
from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

from _torch_util import assert_same_config, hlg_batch, jax_host_library, same_fst, small_hlg

V_RING = 3


def _eps_ring(n: int) -> StdVectorFst:
    """The n-state eps ring of ``tests/test_cyclic_eps.py``: one eps arc a
    state to the next, emitting arcs back to state 0."""
    fst = StdVectorFst()
    for _ in range(n):
        fst.add_state()
    fst.set_start(0)
    for i in range(n):
        fst.add_arc(i, EPSILON, 0, 0.0, (i + 1) % n)
        for v in range(1, V_RING + 1):
            fst.add_arc(i, v, v, 0.1 * i, 0)
        fst.set_final(i, 0.05 * i)
    return fst


@functools.lru_cache(maxsize=None)
def _graph(name):
    """(JAX graph, port graph, scores (B, T, V), lengths, frontier kwargs,
    decoder kwargs) of a workload whose device graph keeps eps arcs."""
    if name == "hlg":
        _, jg, pg = small_hlg()
        scores, lengths, _ = hlg_batch(3, seed=11)
        return jg, pg, scores, lengths, dict(frontier_size=64, max_active=48), dict(
            em_records=512, lattice_beam=5.0)
    if name == "synthetic":
        jg = synthetic_graph(300, 1500, 20, seed=11, eps_arcs=150)
        rng = np.random.default_rng(2)
        scores = np.log(rng.dirichlet(np.ones(20), size=(2, 37))).astype(np.float32)
        return jg, graph_from_numpy(jg), scores, np.array([37, 28], np.int32), dict(
            beam=8.0, max_active=64), dict(em_records=512, eps_records=128,
                                           lattice_beam=4.0)
    n, T = {"ring8": (8, 6), "ring24": (24, 4)}[name]
    jg = compile_fst(_eps_ring(n))
    rng = np.random.default_rng(0)
    scores = np.log(rng.dirichlet(np.ones(V_RING), size=(1, T))).astype(np.float32)
    return jg, graph_from_numpy(jg), scores, np.array([T], np.int32), dict(
        beam=50.0, min_active=0, frontier_size=16 if n == 8 else 32), dict(
        em_records=256, eps_records=64, lattice_beam=30.0)


@functools.lru_cache(maxsize=None)
def _decoders(name, fold=False, pad=8):
    jg, pg, _, _, fkw, dkw = _graph(name)
    jdev = jlattice.BatchedLatticeDecoder(jg, None, pad_time_to=pad, fold=fold)._dev_graph
    pdev = BatchedLatticeDecoder(pg, None, pad_time_to=pad, fold=fold,
                                 device="cpu")._dev_graph
    jfc, pfc = jax_config_for_graph(jdev, **fkw), config_for_graph(pdev, **fkw)
    jdec = jlattice.BatchedLatticeDecoder(jg, jfc, pad_time_to=pad, fold=fold, **dkw)
    pdec = BatchedLatticeDecoder(pg, pfc, pad_time_to=pad, fold=fold, device="cpu", **dkw)
    assert_same_config(jdec.cfg.frontier, pdec.cfg.frontier, eps=not fold)
    assert (jdec.cfg.em_records, jdec.cfg.eps_records) == (pdec.cfg.em_records,
                                                          pdec.cfg.eps_records)
    return jdec, pdec


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same_stats(j, p):
    for f in ("num_frames", "arc_budget_overflows", "frontier_saturated_frames",
              "batch_frames"):
        assert getattr(j, f) == getattr(p, f), f
    for f in ("active_per_frame", "cutoff_per_frame"):
        assert np.array_equal(_bits(getattr(j, f)), _bits(getattr(p, f))), f


# ---------------------------------------------------------------------------
# K2's eps call
# ---------------------------------------------------------------------------


def _eps_lanes(seed, B, K, n_eps, S, case):
    """K incumbents (a dedup-sorted frontier, some slots empty) then n_eps
    eps lanes on a 0.25 grid, some tied with the incumbent of their state,
    and their payload."""
    rng = np.random.default_rng(seed)
    st = np.zeros((B, K), np.int32)
    co = np.full((B, K), np.inf, np.float32)
    for b in range(B):
        live = K - 3 * b
        ids = np.sort(rng.choice(S, live, replace=False))
        c = rng.integers(0, 24, live) * 0.25
        order = np.lexsort((ids, c))
        st[b, :live], co[b, :live] = ids[order], c[order]
    dst = rng.integers(0, S, (B, n_eps)).astype(np.int32)
    cost = (rng.integers(0, 40, (B, n_eps)) * 0.25).astype(np.float32)
    if case == "no-eps-winner":
        # Every eps lane on a live incumbent's state, dearer than it.
        for b in range(B):
            dst[b] = st[b, rng.integers(0, K - 3 * b, n_eps)]
        cost += 50.0
    else:
        # Ties: an eps lane on an incumbent's state at its exact cost.
        for b in range(B):
            dst[b, :4] = st[b, :4]
            cost[b, :4] = co[b, :4]
        cost[:, 5] = -0.0
    cost[rng.random((B, n_eps)) < 0.2] = np.inf
    src = rng.integers(0, S, (B, n_eps)).astype(np.int32)
    arc = rng.integers(0, 1000, (B, n_eps)).astype(np.int32)
    none = np.full((B, K), -1, np.int32)
    return (np.concatenate([st, dst], 1), np.concatenate([co, cost], 1),
            (np.concatenate([none, src], 1), np.concatenate([none, arc], 1)))


@pytest.mark.parametrize("case,K,n_eps,r_eps", [
    ("ties", 16, 48, 12),
    ("r-near-n", 16, 48, 47),
    ("winners-only", 16, 48, -4),
    ("no-eps-winner", 16, 24, 8),
])
def test_dedup_select_rec_incumbents_matches_jax(case, K, n_eps, r_eps):
    """The eps iteration's call, bitwise in every field against the
    original's: incumbents first, ties of an incumbent and an eps lane kept
    by the incumbent, the record budget K + r_eps up to N (and, with a
    negative r_eps, below K: the winners-only branch, whose incumbent rows
    are padding)."""
    B, S, sb = 3, 60, 3.0 + 1e-4
    R = K + r_eps
    cs, cc, pay = _eps_lanes(7, B, K, n_eps, S, case)
    ref = jax.vmap(lambda s, c, p0, p1: jax_dedup_select_rec(
        s, c, K, S, R, slack_beam=sb, num_incumbents=K, payload=(p0, p1), sweep_cols=True,
    ))(jnp.asarray(cs), jnp.asarray(cc), jnp.asarray(pay[0]), jnp.asarray(pay[1]))
    args = (torch.from_numpy(cs), torch.from_numpy(cc), K, S, R, sb,
            tuple(torch.from_numpy(p) for p in pay))
    got = dedup_select_rec_plain(*args, num_incumbents=K)
    for name, r, g in (("states", ref.states, got.states), ("costs", ref.costs, got.costs),
                       ("cand_idx", ref.cand_idx, got.cand_idx),
                       ("num_unique", ref.num_unique, got.num_unique),
                       ("src", ref.recs[0], got.recs[0]), ("arc", ref.recs[1], got.recs[1]),
                       ("rec_dst", ref.rec_dst, got.rec_dst),
                       ("rec_slack", ref.rec_slack, got.rec_slack),
                       ("rec_overflow", ref.rec_overflow, got.rec_overflow)):
        assert np.array_equal(_bits(r), _bits(g.numpy())), name
    won = got.cand_idx.numpy()
    if case == "no-eps-winner":
        assert (won < K).all()
    else:
        assert (won >= K).any()
    # An eps lane tied with the incumbent of its state never wins its slot.
    assert not np.isin(np.arange(K, K + 4), won).any()
    # Incumbents never become records.
    assert ((got.recs[1].numpy() >= 0) == (got.rec_dst.numpy() >= 0)).all()
    wrapped = dedup_select_rec(*args, num_incumbents=K)
    assert torch.equal(wrapped.records, stack_records(got))
    assert torch.equal(wrapped.cand_idx, got.cand_idx)


# ---------------------------------------------------------------------------
# The sweep with eps records
# ---------------------------------------------------------------------------


def _jax_sweep_config(sc: SweepConfig) -> JaxSweepConfig:
    return JaxSweepConfig(**{f.name: getattr(sc, f.name)
                             for f in dataclasses.fields(JaxSweepConfig)})


def _same_sweep(ref, got):
    B = got.tok_count.shape[0]
    for name in ("tok", "em", "eps"):
        rc = np.asarray(getattr(ref, f"{name}_count"))
        assert np.array_equal(rc, getattr(got, f"{name}_count").numpy()), name
        for b in range(B):
            want = np.asarray(getattr(ref, f"{name}_rows"))[b, : rc[b]]
            assert np.array_equal(want, getattr(got, f"{name}_rows")[b, : rc[b]].numpy()), (
                name, b)
    assert np.array_equal(np.asarray(ref.overflow), got.overflow.numpy())


def _sweep_both(fs, fc, em, eps, init, rem, sc, S):
    ref = jax_build_sweep_fn(_jax_sweep_config(sc))(
        jnp.asarray(fs), jnp.asarray(fc), jnp.asarray(em), jnp.asarray(eps),
        jnp.asarray(init), jnp.asarray(rem))
    got = sweep_plain(*(torch.from_numpy(np.array(x)) for x in (fs, fc, em, init, rem)),
                      sc, S, torch.from_numpy(np.array(eps)))
    return ref, got


@pytest.mark.parametrize("name", ["synthetic", "ring24"])
def test_sweep_plain_eps_matches_jax(name):
    """The sweep of a real chunk of the JAX decode (its frontiers, emitting
    and eps records), an utterance ending inside it: the port's plain
    sweep equals ``_sweep_one`` in every survivor row, count and flag."""
    from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config

    jdec, pdec = _decoders(name)
    jg, _, scores, lengths, _, _ = _graph(name)
    B, C = scores.shape[0], min(8, scores.shape[1])
    st0, _, _, _ = jdec._init(B)
    rem = np.asarray(lengths, np.int32) - 1
    _, o = jdec._chunk_fn(jdec._pg_dev, jnp.asarray(scores[:, :C]), jnp.asarray(rem), st0)
    sc = sweep_config(pdec.cfg, C)
    assert sc.eps_iters > 0 and sc.eps_exact == (name != "ring24")
    ref, got = _sweep_both(o.frontier_states, o.frontier_costs, o.em_records, o.eps_records,
                           st0.states, rem, sc, jg.num_states)
    _same_sweep(ref, got)
    assert int(got.eps_count.sum()) > 0


@pytest.mark.parametrize("exact", [True, False])
def test_sweep_plain_eps_bellman_bound_matches_jax(exact):
    """Records of a two-state eps cycle with slack -1 (the forward closure
    under-relaxed) lower the extras by 1 a pass, so the Bellman is still
    changing at its bound (D + 2, or min(K, D * Re) + 2 with a cyclic eps
    graph) on the frames that hold them: overflow is set, as in JAX, and
    the other rows are equal."""
    rng = np.random.default_rng(3)
    T, B, K, R, D, Re, S = 6, 2, 8, 16, 2, 4, 20
    fs = np.stack([np.stack([rng.choice(S, K, replace=False) for _ in range(B)])
                   for _ in range(T)]).astype(np.int32)
    fc = np.sort(rng.uniform(0, 3, (T, B, K)), axis=-1).astype(np.float32)
    fc[:, :, -2:] = np.inf
    em = np.full((T, B, R, 4), -1, np.int32)
    slack = rng.uniform(10, 20, (T, B, R)).astype(np.float32)
    em[..., 0] = rng.integers(0, S, (T, B, R))  # sources (mostly absent from the frontier)
    em[:, :, :, 1] = rng.integers(0, 100, (T, B, R))
    for t in range(1, T):
        em[t, :, :8, 0] = fs[t - 1, :, :8]
    em[..., 2] = fs[:, :, rng.integers(0, K, R)][:, :, :R]
    em[..., 3] = slack.view(np.int32)
    eps = np.full((T, B, D, Re, 4), -1, np.int32)
    for t in range(T):
        for b in range(B):
            a, c = fs[t, b, 0], fs[t, b, 1]
            neg = np.float32(-1.0).view(np.int32)
            eps[t, b, 0, 0] = (a, 7, c, neg)
            eps[t, b, 0, 1] = (c, 8, a, neg)
            eps[t, b, 1, 0] = (fs[t, b, 2], 9, a, np.float32(0.5).view(np.int32))
    init = rng.choice(S, (B, K)).astype(np.int32)
    rem = np.array([T, 3], np.int32)
    sc = SweepConfig(frontier_size=K, em_records=R, chunk_frames=T, lattice_beam=60.0,
                     tok_cap=200, em_cap=200, eps_records=Re, eps_iters=D, eps_exact=exact,
                     eps_cap=100)
    assert sc.eps_bound == (D + 2 if exact else min(K, D * Re) + 2)
    ref, got = _sweep_both(fs, fc, em, eps, init, rem, sc, S)
    _same_sweep(ref, got)
    assert got.overflow.all()
    assert int(got.eps_count.min()) > 0


# ---------------------------------------------------------------------------
# The batched decoder on a device graph with eps arcs
# ---------------------------------------------------------------------------


def _same_field(jres, pres, field):
    assert np.array_equal(_bits(getattr(jres, field)), _bits(getattr(pres, field))), field


def _same_results(jres, pres, B):
    jax_host_library()
    for field in ("num_active", "cutoffs", "overflows", "saturations", "init_states",
                  "init_costs", "init_eps_records"):
        _same_field(jres, pres, field)
    if jres.survivors is None:
        assert pres.survivors is None
        for field in ("frame_states", "frame_costs", "em_records", "eps_records"):
            _same_field(jres, pres, field)
    else:
        assert len(jres.survivors) == len(pres.survivors)
        for jc, pc in zip(jres.survivors, pres.survivors):
            assert jc["frame0"] == pc["frame0"]
            assert np.array_equal(jc["overflow"], pc["overflow"])
            for name in ("tok", "em", "eps"):
                cnt = np.asarray(jc[f"{name}_count"])
                assert np.array_equal(cnt, pc[f"{name}_count"]), name
                for b in range(B):
                    assert np.array_equal(np.asarray(jc[f"{name}_rows"])[b, : cnt[b]],
                                          pc[f"{name}_rows"][b, : cnt[b]]), (name, b)
    for b in range(B):
        same_fst(jres.raw_lattice(b), pres.raw_lattice(b))
        same_fst(jres.best_path(b), pres.best_path(b))
        assert _labels(jres, b) == _labels(pres, b), b


def _labels(res, b):
    """best_path_labels, or the error both C++ ShortestPath copies raise
    on a cyclic lattice (an eps ring within a frame)."""
    try:
        return res.best_path_labels(b)
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize("name", ["hlg", "synthetic", "ring8", "ring24"])
def test_batched_unfolded_matches_jax(name):
    """``fold=False``: swept in chunks of 8 and full one-shot, every
    survivor row and count (eps rows included), per-frame stats, the
    records of the full decode, labels, raw lattice and best path equal
    the JAX decoder's.  The 8-ring's closure converges; the 24-ring's
    cannot within its 16 iterations, and every frame is flagged."""
    jdec, pdec = _decoders(name)
    _, _, scores, lengths, _, _ = _graph(name)
    B = scores.shape[0]
    for chunk, prune in ((8, True), (None, False)):
        jres = jdec.decode(scores, lengths, chunk_frames=chunk, device_prune=prune)
        pres = pdec.decode(scores, lengths, chunk_frames=chunk, device_prune=prune)
        # The 24-ring's records outgrow the sweep's eps buffer, so its
        # swept decode falls back to the full one, in both packages.
        assert (pres.survivors is not None) == (prune and name != "ring24")
        _same_results(jres, pres, B)
    if name == "ring24":
        assert pres.overflows[: int(lengths[0]), 0].all()
    elif name == "ring8":
        assert not pres.overflows.any()
    assert pres.eps_records[pres.eps_records[..., 1] >= 0].shape[0] > 0


@pytest.mark.parametrize("fold", [True, False])
def test_batched_decoder_takes_an_fst(fold, tmp_path):
    """``BatchedLatticeDecoder`` compiles a ``StdVectorFst`` as the
    reference does (``_as_graph``): the HLG of ``make_hlg(num_words=30,
    num_tokens=10, num_sentences=50, seed=1)``, written by ``write_fst``
    and read back by the port's ``read_fst``, against the JAX decoder
    given the FST itself, ``lattice_beam`` 5 and ``pad_time_to`` 8; every
    field, survivor row, lattice and label of the decodes are equal."""
    from kaldi_decoder_tpu.fst.hlg import make_hlg, make_utterances
    from kaldi_decoder_tpu.fst.io import write_fst
    from kaldi_decoder_tpu_torch.fst import StdVectorFst as PortFst
    from kaldi_decoder_tpu_torch.fst import read_fst

    g = make_hlg(num_words=30, num_tokens=10, num_sentences=50, seed=1)
    path = str(tmp_path / "hlg.fst")
    write_fst(g.hlg, path)
    fst = read_fst(path)
    assert isinstance(fst, PortFst)
    scores, lengths, _ = make_utterances(g, 3, np.random.default_rng(0))
    jdec = jlattice.BatchedLatticeDecoder(g.hlg, lattice_beam=5.0, pad_time_to=8, fold=fold)
    pdec = BatchedLatticeDecoder(fst, lattice_beam=5.0, pad_time_to=8, fold=fold, device="cpu")
    assert (pdec.fold is None) == (not fold)
    _same_results(jdec.decode(scores, lengths), pdec.decode(scores, lengths), 3)


@pytest.mark.parametrize("fold", [True, False])
def test_lattice_result_api_matches_jax(fold):
    """raw_lattice, best_path, reached_final, final_relative_cost and stats
    (every field but the wall time), with and without final probs."""
    jdec, pdec = _decoders("hlg", fold=fold)
    _, _, scores, lengths, _, _ = _graph("hlg")
    jres = jdec.decode(scores, lengths, chunk_frames=8)
    pres = pdec.decode(scores, lengths, chunk_frames=8)
    jax_host_library()
    for b in range(scores.shape[0]):
        for ufp in (True, False):
            same_fst(jres.raw_lattice(b, ufp), pres.raw_lattice(b, ufp))
            same_fst(jres.best_path(b, ufp), pres.best_path(b, ufp))
            assert jres.best_path_labels(b, ufp) == pres.best_path_labels(b, ufp)
        assert jres.reached_final(b) == pres.reached_final(b)
        assert jres.final_relative_cost(b) == pres.final_relative_cost(b)
        _same_stats(jres.stats(b), pres.stats(b))


# ---------------------------------------------------------------------------
# The streaming lattice API
# ---------------------------------------------------------------------------


def _streaming_pair(kind, **kw):
    _, jg, pg = small_hlg()
    if kind == "simple":
        jcfg = jlattice.LatticeSimpleDecoderConfig(**kw)
        return (jlattice.LatticeSimpleDecoder(jg, jcfg),
                LatticeSimpleDecoder(pg, LatticeSimpleDecoderConfig(**kw), device="cpu"))
    return (jlattice.LatticeFasterDecoder(jg, jlattice.LatticeFasterDecoderConfig(**kw)),
            LatticeFasterDecoder(pg, LatticeFasterDecoderConfig(**kw), device="cpu"))


def _stream(dec, decodable, L, piece):
    dec.init_decoding()
    while dec.num_frames_decoded() < L:
        dec.advance_decoding(decodable, max_num_frames=piece)
    dec.finalize_decoding()


@pytest.mark.parametrize("kind,kw", [
    ("simple", dict(beam=12.0, lattice_beam=5.0, prune_interval=7)),
    ("faster", dict(beam=12.0, max_active=40, min_active=5, lattice_beam=5.0,
                    prune_interval=10)),
])
def test_streaming_lattice_matches_jax(kind, kw):
    """Streamed in pieces of 9 frames, the port equals the JAX decoder in
    raw lattice, best path, reached_final, final_relative_cost and stats;
    and equals its own one-shot ``decode``."""
    scores, lengths, _ = hlg_batch(1, seed=11)
    L = int(lengths[0])
    jd, pd = _streaming_pair(kind, **kw)
    assert pd._dev_cfg.frontier.eps_iters > 0
    _stream(jd, JaxDecodableCtc(scores[0, :L]), L, 9)
    _stream(pd, DecodableCtc(scores[0, :L]), L, 9)
    jax_host_library()
    same_fst(jd.get_raw_lattice()[1], pd.get_raw_lattice()[1])
    jok, jbest = jd.get_best_path()
    pok, pbest = pd.get_best_path()
    assert jok == pok is True
    same_fst(jbest, pbest)
    assert jd.reached_final() == pd.reached_final()
    assert jd.final_relative_cost() == pd.final_relative_cost()
    _same_stats(jd.stats(), pd.stats())
    assert pd.num_frames_decoded() == L
    assert str(pd.get_config()) == str(jd.get_config())

    _, one = _streaming_pair(kind, **kw)
    assert one.decode(DecodableCtc(scores[0, :L])) == pd.reached_final()
    same_fst(one.get_raw_lattice()[1], pd.get_raw_lattice()[1])


def test_streaming_lattice_without_final_probs_matches_jax():
    """Before ``finalize_decoding`` the lattice without final probs equals
    JAX's; after it, asking for one raises, as the reference does."""
    scores, lengths, _ = hlg_batch(1, seed=12)
    L = int(lengths[0])
    jd, pd = _streaming_pair("simple", beam=12.0, lattice_beam=5.0)
    for dec, decodable in ((jd, JaxDecodableCtc(scores[0, :L])),
                           (pd, DecodableCtc(scores[0, :L]))):
        dec.init_decoding()
        dec.advance_decoding(decodable)
    jax_host_library()
    same_fst(jd.get_raw_lattice(False)[1], pd.get_raw_lattice(False)[1])
    same_fst(jd.get_best_path(False)[1], pd.get_best_path(False)[1])
    pd.finalize_decoding()
    with pytest.raises(RuntimeError, match="use_final_probs"):
        pd.get_raw_lattice(use_final_probs=False)
    with pytest.raises(AssertionError):
        pd.advance_decoding(DecodableCtc(scores[0, :L]))


def test_lattice_config_validation():
    with pytest.raises(ValueError):
        LatticeFasterDecoderConfig(prune_scale=1.5).check()
    with pytest.raises(ValueError):
        LatticeSimpleDecoderConfig(lattice_beam=-1.0).check()
    _, _, pg = small_hlg()
    with pytest.raises(ValueError):
        LatticeFasterDecoder(pg, LatticeFasterDecoderConfig(max_active=1), device="cpu")
    with pytest.raises(TypeError):
        LatticeSimpleDecoder(pg)  # the device is required
