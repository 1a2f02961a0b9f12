"""The port's 1-best path against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
the JAX side runs on the CPU as the rest of the suite does.  Exactness:
every float operation on the path is an add, subtract, compare or min in
the JAX order, so integers (backpointers, states, counts, flags) are
equal and floats are bitwise equal with -0.0 folded onto +0.0.

Cases: K6's plain version (``dedup_select``) with forced cost ties, with
and without leading incumbents; ``expand_eps`` and one ``eps_iteration``;
the frame step with D = 0 and D >= 1; ``BatchedViterbiDecoder.decode`` on
a folded and an unfolded small HLG and on the cyclic eps rings of
``tests/test_cyclic_eps.py`` (one converges inside the 16-iteration
budget, one does not); the streaming API; the host copies.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decodable import DecodableCtc as JaxDecodableCtc
from kaldi_decoder_tpu.decoders import frontier as jfrontier
from kaldi_decoder_tpu.decoders.api import FasterDecoder as JaxFasterDecoder
from kaldi_decoder_tpu.decoders.api import FasterDecoderOptions as JaxOptions
from kaldi_decoder_tpu.decoders.api import SimpleDecoder as JaxSimpleDecoder
from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.fst import fst as jfst
from kaldi_decoder_tpu.fst import ops as jops
from kaldi_decoder_tpu.fst.csr import compile_fst as jax_compile_fst
from kaldi_decoder_tpu.fst.pack import pack_graph_device as jax_pack
from kaldi_decoder_tpu.fst.synthetic import synthetic_graph
from kaldi_decoder_tpu.ops.segment import dedup_select as jax_dedup_select
from kaldi_decoder_tpu_torch import (
    BatchedViterbiDecoder,
    DecodableCtc,
    FasterDecoder,
    FasterDecoderOptions,
    SimpleDecoder,
)
from kaldi_decoder_tpu_torch.decoders import frontier as pfrontier
from kaldi_decoder_tpu_torch.fst import fst as pfst
from kaldi_decoder_tpu_torch.fst import ops as pops
from kaldi_decoder_tpu_torch.fst.csr import compile_fst, graph_from_numpy
from kaldi_decoder_tpu_torch.fst.pack import packed_from_numpy
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter_plain
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

from _torch_util import bits, hlg_batch, jax_host_library, small_hlg, twin_configs
from test_cyclic_eps import eps_ring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INF = float("inf")


def _eq(a, b, msg=""):
    """Exact equality; float32 arrays compared as bits."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (msg, a.shape, b.shape)
    if a.dtype == np.float32:
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=msg)
    else:
        np.testing.assert_array_equal(a, b, err_msg=msg)


def _eq_tuple(ref, got, fields):
    for f, r, g in zip(fields, ref, got):
        _eq(r, g.numpy() if isinstance(g, torch.Tensor) else g, f)


def _lattice_rows(lat):
    return (
        lat.start,
        [
            (s, lat.final(s),
             [(a.ilabel, a.olabel, a.weight, a.nextstate) for a in lat.arcs(s)])
            for s in range(lat.num_states)
        ],
    )


# ---------------------------------------------------------------------------
# K6's plain version
# ---------------------------------------------------------------------------


def _candidates(rng, B, K, N, S, incumbents: bool, n_valid: int):
    """(B, N) candidate lanes, ``n_valid`` of them finite, with costs on a
    0.5 grid (forced ties) and few states (forced duplicates); with
    ``incumbents`` the first K lanes are a dedup-sorted frontier, as an
    eps iteration passes them, and the finite lanes follow them."""
    states = rng.integers(0, S, (B, N)).astype(np.int32)
    costs = np.full((B, N), np.inf, np.float32)
    lo = K if incumbents else 0
    for b in range(B):
        lanes = lo + rng.choice(N - lo, size=n_valid, replace=False)
        costs[b, lanes] = rng.integers(0, 12, n_valid) * 0.5
        costs[b, lanes[0]] = -0.0  # ties with +0.0 lanes
    if incumbents:
        for b in range(B):
            n = K // 2 + b
            st = rng.choice(S, size=n, replace=False)
            co = np.sort((rng.integers(0, 8, n) * 0.5).astype(np.float32))
            order = np.lexsort((st, co))
            states[b, :K], costs[b, :K] = 0, np.inf
            states[b, :n], costs[b, :n] = st[order], co[order]
    return states, costs


@pytest.mark.parametrize("incumbents", [False, True])
@pytest.mark.parametrize("n_valid", [10, 300])  # fewer / more states than K
def test_dedup_select_matches_jax(incumbents, n_valid):
    rng = np.random.default_rng(int(incumbents) * 1000 + n_valid)
    B, K, N, S = 3, 32, 400, 90
    states, costs = _candidates(rng, B, K, N, S, incumbents, n_valid)
    ref = jax.vmap(lambda s, c: jax_dedup_select(s, c, K, S))(
        jnp.asarray(states), jnp.asarray(costs)
    )
    st, co = torch.from_numpy(states), torch.from_numpy(costs)
    before = dedup_select.launches
    got = dedup_select(st, co, K, S)
    assert dedup_select.launches == before  # CPU tensors: the plain version
    _eq_tuple(ref, got, got._fields)
    nu = got.num_unique.numpy()
    assert (nu < K).all() if n_valid == 10 else (nu > K).all()


def test_dedup_select_pads_when_fewer_lanes_than_k():
    rng = np.random.default_rng(5)
    states, costs = _candidates(rng, 2, 8, 20, 30, False, 14)
    st, co = torch.from_numpy(states), torch.from_numpy(costs)
    full = dedup_select_plain(st, co, 20, 30)
    wide = dedup_select_plain(st, co, 28, 30)
    for f, a, w in zip(full._fields, full, wide):
        if f == "num_unique":
            assert torch.equal(a, w)
            continue
        assert torch.equal(w[:, :20], a), f
    assert (wide.states[:, 20:] == 0).all() and (wide.cand_idx[:, 20:] == -1).all()
    assert torch.isinf(wide.costs[:, 20:]).all()


# ---------------------------------------------------------------------------
# Eps expansion, eps iteration, frame step
# ---------------------------------------------------------------------------


def _eps_twins(graph, **kw):
    """JAX and port configs and packed tables of a graph as it is (eps
    arcs on the device): the small HLG (eps depth 1) or a random graph
    whose states have several eps arcs each."""
    if graph == "hlg":
        _, cg, pg = small_hlg()
    else:
        cg = synthetic_graph(300, 1500, 12, seed=11, eps_arcs=900)
        pg = graph_from_numpy(cg)
    jfc, pfc = twin_configs(cg, pg, **kw)
    for f in ("eps_block_width", "eps_rem_budget", "eps_iters", "eps_exact"):
        assert getattr(jfc, f) == getattr(pfc, f), f
    jpg = jax_pack(cg, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
    return cg, jfc, pfc, jpg, packed_from_numpy(jpg, "cpu")


def _frontier(rng, B, K, S):
    """Cost-sorted, (cost, state)-ordered frontier rows, some half empty."""
    states = np.zeros((B, K), np.int32)
    costs = np.full((B, K), np.inf, np.float32)
    for b in range(B):
        n = K if b == 0 else K // (b + 1)
        st = rng.choice(S, size=n, replace=False)
        co = (rng.integers(0, 20, n) * 0.25).astype(np.float32)
        order = np.lexsort((st, co))
        states[b, :n], costs[b, :n] = st[order], co[order]
    return states, costs


@pytest.mark.parametrize("graph,eps_rem_budget", [
    ("hlg", None), ("synthetic", 512), ("synthetic", 8),  # 8: eps remainder overflow
])
def test_expand_eps_and_eps_iteration_match_jax(graph, eps_rem_budget):
    kw = dict(frontier_size=64, max_active=48)
    if eps_rem_budget:
        kw.update(eps_rem_budget=eps_rem_budget, eps_block_width=1)
    cg, jfc, pfc, jpg, ppg = _eps_twins(graph, **kw)
    S = cg.num_states
    rng = np.random.default_rng(7)
    B, K = 3, pfc.frontier_size
    states, costs = _frontier(rng, B, K, S)
    cutoff = np.array([3.0, 1.5, np.inf], np.float32)
    jst = jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.zeros(B))
    pst = pfrontier.StepState(torch.from_numpy(states), torch.from_numpy(costs),
                              torch.zeros(B))
    active = np.isfinite(costs) & (costs <= cutoff[:, None])

    ref = jax.vmap(lambda s, a: jfrontier.expand_eps(s, a, jpg, jfc))(
        jst, jnp.asarray(active))
    got = pfrontier.expand_eps(pst, torch.from_numpy(active), ppg, pfc)
    _eq_tuple(ref, got, got._fields)
    assert bool(got.overflow.any()) == (eps_rem_budget == 8)

    ref = jax.vmap(lambda s, c: jfrontier.eps_iteration(s, c, jpg, jfc, S))(
        jst, jnp.asarray(cutoff)
    )
    got = pfrontier.eps_iteration(pst, torch.from_numpy(cutoff), ppg, pfc, S)
    _eq_tuple(ref[0], got[0], ("states", "costs", "base"))
    _eq_tuple(ref[1:], got[1:], ("bp", "changed", "overflow", "saturated"))
    assert got[2].any()


@pytest.mark.parametrize("fold", [True, False])  # D = 0 and D = 1
def test_frame_step_matches_jax(fold):
    _, cg, pg = small_hlg()
    jdev = JaxViterbi(cg, None, pad_time_to=8, fold=fold)._dev_graph
    pdev = BatchedViterbiDecoder(pg, None, pad_time_to=8, fold=fold,
                                 device="cpu")._dev_graph
    jfc, pfc = twin_configs(jdev, pdev, frontier_size=64, max_active=48)
    pdec = BatchedViterbiDecoder(pg, pfc, pad_time_to=8, fold=fold, device="cpu")
    assert jfc.eps_iters == pdec.cfg.eps_iters == (0 if fold else 1)
    pfc, ppg = pdec.cfg, pdec._pg
    jpg = jax_pack(jdev, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
    S = pdev.num_states
    scores, _, _ = hlg_batch(3, seed=4)
    B = scores.shape[0]
    step = jax.jit(lambda s, sc, fa: jfrontier.frame_step_batched(s, sc, fa, jpg, jfc, S))
    pst, bp_init = pdec._init(B)
    jst = jfrontier.StepState(*(jnp.asarray(x.numpy()) for x in pst))
    if not fold:
        # The init closure of both packages.
        jinit, jbp = jfrontier.init_closure(jpg, cg.start_state, S, jfc)
        _eq(np.asarray(jbp), bp_init)
        _eq(np.asarray(jinit.costs), pst.costs[0].numpy())
    lengths = np.array([12, 3, 9], np.int32)
    for t in range(12):
        fa = lengths > t
        jst, jout = step(jst, jnp.asarray(scores[:, t]), jnp.asarray(fa))
        pst, pout = pfrontier.frame_step_batched(
            pst, torch.from_numpy(scores[:, t]), torch.from_numpy(fa), ppg, pfc, S
        )
        _eq_tuple(jst, pst, ("states", "costs", "base"))
        _eq_tuple(jout, pout, pout._fields)


# ---------------------------------------------------------------------------
# The decoder
# ---------------------------------------------------------------------------


def _ring_case(n, T, K):
    fst = eps_ring(n)
    rng = np.random.default_rng(0)
    scores = np.log(rng.dirichlet(np.ones(3), size=T)).astype(np.float32)
    return fst, scores[None], None, dict(beam=50.0, min_active=0, frontier_size=K)


def _hlg_case():
    g, _, _ = small_hlg()
    scores, lengths, _ = hlg_batch(3, seed=11)
    return g.hlg, scores, lengths, dict(frontier_size=64, max_active=48)


DECODE_CASES = {
    # name: (make the case, fold, expect overflow on every frame of utterance 0)
    "hlg_folded": (_hlg_case, True, False),
    "hlg_unfolded": (_hlg_case, False, False),
    "ring8": (lambda: _ring_case(8, 6, 16), True, False),
    "ring24": (lambda: _ring_case(24, 4, 32), True, True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_viterbi_decode_matches_jax(case):
    make, fold, flagged = DECODE_CASES[case]
    fst, scores, lengths, kw = make()
    cg = jax_compile_fst(fst)
    pg = graph_from_numpy(cg)
    jfc, pfc = twin_configs(cg, pg, **kw)
    jdec = JaxViterbi(cg, jfc, pad_time_to=8, fold=fold)
    pdec = BatchedViterbiDecoder(pg, pfc, pad_time_to=8, fold=fold, device="cpu")
    for f in pfc.__dataclass_fields__:
        if f != "explicit":
            assert getattr(jdec.cfg, f) == getattr(pdec.cfg, f), f
    jr, pr = jdec.decode(scores, lengths), pdec.decode(scores, lengths)
    for f in ("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
              "num_active", "best_costs", "cutoffs", "overflows", "saturations", "lengths"):
        _eq(getattr(jr, f), getattr(pr, f), f)
    B = scores.shape[0]
    jax_host_library()
    for b in range(B):
        js, ps = jr.stats(b), pr.stats(b)
        assert (js.arc_budget_overflows, js.frontier_saturated_frames) == (
            ps.arc_budget_overflows, ps.frontier_saturated_frames)
        assert jr.reached_final(b) == pr.reached_final(b)
        assert jr.final_relative_cost(b) == pr.final_relative_cost(b)
        for final in (True, False):
            want, got = jr.best_path(b, final), pr.best_path(b, final)
            assert _lattice_rows(want) == _lattice_rows(got)
    L = int(pr.lengths[0])
    if flagged:
        assert pr.stats(0).arc_budget_overflows == L
    elif case.startswith("ring"):
        assert pdec.cfg.eps_iters == 16 and not pdec.cfg.eps_exact
        assert pr.stats(0).arc_budget_overflows == 0


def test_expand_src_slot_matches_jax():
    """K1's plain version gives each lane's source slot as the JAX
    expansion does."""
    _, cg, pg = small_hlg()
    pdec = BatchedViterbiDecoder(pg, None, pad_time_to=8, device="cpu")
    jdec = JaxViterbi(cg, None, pad_time_to=8)
    jfc, pfc = twin_configs(jdec._dev_graph, pdec._dev_graph, frontier_size=64,
                            max_active=40)
    jpg = jax_pack(jdec._dev_graph, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
    rng = np.random.default_rng(3)
    states, costs = _frontier(rng, 3, 64, cg.num_states)
    scores = np.log(rng.dirichlet(np.ones(12), size=3)).astype(np.float32)
    cut = get_cutoff(torch.from_numpy(costs), pfc.beam, pfc.max_active, pfc.min_active,
                     pfc.beam_delta, costs_sorted=True)
    active = np.isfinite(costs) & (costs < cut.cutoff.numpy()[:, None])
    jst = jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.zeros(3))
    ref = jax.vmap(lambda s, a, sc: jfrontier.expand_emitting(s, a, sc, jpg, jfc))(
        jst, jnp.asarray(active), jnp.asarray(scores))
    got = expand_filter_plain(
        torch.from_numpy(states), torch.from_numpy(costs), cut.cutoff, cut.adaptive_beam,
        torch.from_numpy(scores), packed_from_numpy(jpg, "cpu"), pfc, with_src_slot=True)
    _eq(ref.src_slot, got.src_slot.numpy())
    assert expand_filter_plain(
        torch.from_numpy(states), torch.from_numpy(costs), cut.cutoff, cut.adaptive_beam,
        torch.from_numpy(scores), packed_from_numpy(jpg, "cpu"), pfc).src_slot is None


# ---------------------------------------------------------------------------
# The streaming API
# ---------------------------------------------------------------------------


def _api_result_equal(jd, pd):
    jax_host_library()
    jr, pr = jd._result(), pd._result()
    for f in ("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
              "num_active", "best_costs", "cutoffs", "overflows", "saturations"):
        _eq(getattr(jr, f), getattr(pr, f), f)
    assert jd.num_frames_decoded() == pd.num_frames_decoded()
    assert jd.reached_final() == pd.reached_final()
    assert jd.final_relative_cost() == pd.final_relative_cost()
    jok, jlat = jd.get_best_path()
    pok, plat = pd.get_best_path()
    assert jok == pok
    assert _lattice_rows(jlat) == _lattice_rows(plat)
    assert pops.path_labels(plat) == jops.path_labels(jlat)


def test_faster_decoder_streaming_matches_jax():
    """Pieces of ``max_num_frames`` and a growing decodable, then
    ``set_options`` mid-utterance, against the JAX ``FasterDecoder``."""
    g, cg, pg = small_hlg()
    scores, lengths, _ = hlg_batch(1, seed=2)
    logp = scores[0, : int(lengths[0])]
    opts = dict(beam=12.0, max_active=40, min_active=5)
    jd = JaxFasterDecoder(cg, JaxOptions(**opts))
    jd.chunk_pad = 8
    pd = FasterDecoder(pg, FasterDecoderOptions(**opts), device="cpu")
    assert pd._cfg.eps_iters == 1
    for d in (jd, pd):
        d.init_decoding()
    _api_result_equal(jd, pd)  # get_best_path before any frame
    half = len(logp) // 2
    for d, dec_cls in ((jd, JaxDecodableCtc), (pd, DecodableCtc)):
        d.advance_decoding(dec_cls(logp[:half]), max_num_frames=5)
        assert d.num_frames_decoded() == 5
        d.advance_decoding(dec_cls(logp[:half]))
        assert d.num_frames_decoded() == half
    _api_result_equal(jd, pd)
    jd.set_options(JaxOptions(beam=9.0, max_active=24, min_active=3))
    pd.set_options(FasterDecoderOptions(beam=9.0, max_active=24, min_active=3))
    assert pd.options.beam == 9.0 and pd._cfg.max_active == 24
    for d, dec_cls in ((jd, JaxDecodableCtc), (pd, DecodableCtc)):
        while d.num_frames_decoded() < len(logp):
            d.advance_decoding(dec_cls(logp[half:], offset=half), max_num_frames=8)
    _api_result_equal(jd, pd)


def test_simple_decoder_matches_jax():
    g, cg, pg = small_hlg()
    scores, lengths, _ = hlg_batch(1, seed=5)
    logp = scores[0, : int(lengths[0])]
    jd = JaxSimpleDecoder(cg, beam=10.0)
    pd = SimpleDecoder(pg, beam=10.0, device="cpu")
    ok = jd.decode(JaxDecodableCtc(logp))
    assert pd.decode(DecodableCtc(logp)) is ok is True
    _api_result_equal(jd, pd)


def test_api_errors():
    _, _, pg = small_hlg()
    dec = SimpleDecoder(pg, beam=10.0, device="cpu")
    with pytest.raises(ValueError, match="score index"):
        dec.decode(DecodableCtc(np.zeros((5, 4), np.float32)))
    with pytest.raises(ValueError):
        FasterDecoder(pg, FasterDecoderOptions(max_active=1), device="cpu")
    with pytest.raises(TypeError):
        FasterDecoder(pg, FasterDecoderOptions())  # the device is required
    assert "beam=16" in str(FasterDecoderOptions())


# ---------------------------------------------------------------------------
# Host copies
# ---------------------------------------------------------------------------


def _copy_fst(src, cls):
    a = src.to_arrays()
    return cls.from_arrays(a["row_ptr"], a["ilabel"], a["olabel"], a["weight"],
                           a["nextstate"], a["final"], a["start"])


def _random_lattice(mod, rng, n=12):
    lat = mod.Lattice()
    lat.add_states(n)
    lat.set_start(0)
    for s in range(n - 1):
        for _ in range(1 + int(rng.integers(0, 2))):
            t = int(rng.integers(s + 1, n))
            il = int(rng.integers(0, 3)) * int(rng.random() < 0.6)
            ol = int(rng.integers(0, 3)) * int(rng.random() < 0.6)
            lat.add_arc(s, il, ol, (float(rng.uniform(0, 2)), float(rng.uniform(0, 2))), t)
    lat.set_final(n - 1, (0.5, 0.0))
    return lat


@pytest.mark.parametrize("name", ["hlg", "ring8"])
def test_compile_fst_copy(name):
    fst = small_hlg()[0].hlg if name == "hlg" else eps_ring(8)
    ref = jax_compile_fst(fst)
    got = compile_fst(_copy_fst(fst, pfst.StdVectorFst))
    want = graph_from_numpy(ref)
    for f in want.arrays._fields:
        a, b = getattr(want.arrays, f), getattr(got.arrays, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in ("num_states", "num_emitting_arcs", "num_eps_arcs", "start_state",
              "eps_depth", "max_em_out_degree", "max_eps_out_degree", "max_score_idx"):
        assert getattr(want, f) == getattr(got, f), f


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fst_and_remove_eps_local_copies(seed):
    rng = np.random.default_rng(seed)
    jl = _random_lattice(jfst, rng)
    pl = _copy_fst(jl, pfst.Lattice)
    assert _lattice_rows(jl) == _lattice_rows(pl) and repr(jl) == repr(pl)
    assert pfst.LatticeWeight.plus((1.0, 2.0), (2.0, 1.0)) == jfst.LatticeWeight.plus(
        (1.0, 2.0), (2.0, 1.0))
    ref, got = jops.remove_eps_local(jl), pops.remove_eps_local(pl)
    assert _lattice_rows(ref) == _lattice_rows(got)
    # A linear path: labels and total cost.
    path = jfst.Lattice()
    path.add_states(4)
    path.set_start(0)
    for s, (il, ol) in enumerate(((1, 0), (0, 0), (2, 5))):
        path.add_arc(s, il, ol, (0.25 * s, 0.5), s + 1)
    path.set_final(3, (0.125, 0.0))
    ppath = _copy_fst(path, pfst.Lattice)
    assert pops.path_labels(ppath) == jops.path_labels(path)
    assert pops.path_total_cost(ppath) == jops.path_total_cost(path)
    assert _lattice_rows(pops.remove_eps_local(ppath)) == _lattice_rows(
        jops.remove_eps_local(path))


def test_decodes_without_jax():
    """With jax unimportable, the 1-best path imports and decodes on the
    CPU through both entry points, and the graph written and read back
    through the port's file layer decodes the same with its oracle."""
    code = textwrap.dedent(
        """
        import sys
        sys.modules["jax"] = None
        import numpy as np
        from kaldi_decoder_tpu_torch import (
            BatchedViterbiDecoder, DecodableCtc, FasterDecoder, FasterDecoderOptions,
            compile_fst)
        from kaldi_decoder_tpu_torch.fst.fst import StdVectorFst
        from kaldi_decoder_tpu_torch.fst.ops import path_labels
        fst = StdVectorFst()
        fst.add_states(3)
        fst.set_start(0)
        for s in range(3):
            for v in (1, 2):
                fst.add_arc(s, v, v, 0.1 * s, (s + v) % 3)
            fst.set_final(s, 0.0)
        fst.add_arc(0, 0, 3, 0.5, 1)  # acyclic eps arcs, depth 2
        fst.add_arc(1, 0, 4, 0.25, 2)
        g = compile_fst(fst)
        assert g.eps_depth == 2
        rng = np.random.default_rng(0)
        logp = np.log(rng.dirichlet(np.ones(2), size=10)).astype(np.float32)
        res = BatchedViterbiDecoder(g, None, pad_time_to=4, device="cpu").decode(logp)
        assert res.fold is not None and isinstance(path_labels(res.best_path(0)), list)
        d = FasterDecoder(g, FasterDecoderOptions(beam=8.0), device="cpu")
        d.decode(DecodableCtc(logp))
        ok, lat = d.get_best_path()
        assert ok and d._cfg.eps_iters == 2 and isinstance(path_labels(lat), list)
        import tempfile, os
        from kaldi_decoder_tpu_torch import OracleSimpleDecoder, load_graph
        from kaldi_decoder_tpu_torch.fst import read_fst, write_fst
        with tempfile.TemporaryDirectory() as tmp:
            write_fst(fst, os.path.join(tmp, "g.fst"))
            assert read_fst(os.path.join(tmp, "g.fst")) == fst
            assert load_graph(os.path.join(tmp, "g.fst")).num_eps_arcs == 2
        o = OracleSimpleDecoder(fst, beam=8.0)
        o.decode(DecodableCtc(logp))
        assert path_labels(o.get_best_path()) == path_labels(lat)
        assert not any(n == "jax" or n.startswith(("jax.", "kaldi_decoder_tpu."))
                       for n in sys.modules if sys.modules[n] is not None)
        print("OK")
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("OK")
