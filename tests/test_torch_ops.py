"""Twin tests of the port's frame ops against the JAX package, on the CPU.

Each case makes its inputs with numpy from a seed, runs the JAX function
(plain ``jnp``, vmapped over the batch) and the port's plain torch
counterpart, and requires exact agreement: integers equal, floats equal
bit for bit once -0.0 is folded onto +0.0.  Every float operation on this
path is an add, a subtract, a compare or a min in the same order, so no
tolerance is needed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decoders import frontier as jfrontier
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxDecoder
from kaldi_decoder_tpu.decoders.sweep import build_sweep_fn as jax_build_sweep_fn
from kaldi_decoder_tpu.decoders.sweep import sweep_config as jax_sweep_config
from kaldi_decoder_tpu.ops.cutoff import get_cutoff as jax_get_cutoff
from kaldi_decoder_tpu.ops.segment import dedup_select_rec as jax_dedup_select_rec
from kaldi_decoder_tpu_torch.decoders.frontier import _cfg_for_device_graph
from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_config_for_graph
from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.fst.pack import packed_from_numpy
from kaldi_decoder_tpu_torch.kernels import dedup_rec
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec

from _torch_util import (
    assert_same_config,
    bits,
    hlg_batch,
    small_hlg,
    twin_configs,
)

INF = np.float32(np.inf)


def _frontier(rng, B, K, S, n_live):
    """Cost-sorted frontier rows with n_live[b] finite slots."""
    states = np.zeros((B, K), np.int32)
    costs = np.full((B, K), INF, np.float32)
    for b in range(B):
        n = n_live[b]
        states[b, :n] = rng.choice(S, size=n, replace=False)
        costs[b, :n] = np.sort(rng.uniform(0.0, 12.0, n).astype(np.float32))
        costs[b, 0] = 0.0
    return states, costs


@pytest.mark.parametrize(
    "max_active,min_active,sort_first",
    [
        (64, 0, True),  # unconstrained fast path
        (10, 0, True),  # max-active binds
        (40, 30, True),  # min-active loosens the beam
        (5000, 20, False),  # beam only; unsorted input
    ],
)
def test_get_cutoff_branches(max_active, min_active, sort_first):
    rng = np.random.default_rng(max_active + min_active)
    B, K = 4, 64
    costs = np.full((B, K), INF, np.float32)
    for b, n in enumerate((64, 45, 20, 3)):
        costs[b, :n] = rng.uniform(0, 25, n).astype(np.float32)
    if sort_first:
        costs = np.sort(costs, axis=1)
    beam, delta = 7.5, 0.5
    ref = jax.vmap(
        lambda c: jax_get_cutoff(c, beam, max_active, min_active, delta,
                                 costs_sorted=sort_first)
    )(jnp.asarray(costs))
    got = get_cutoff(torch.from_numpy(costs), beam, max_active, min_active, delta,
                     costs_sorted=sort_first)
    for r, g in zip(ref, got):
        assert r.shape == tuple(g.shape)
        if g.dtype == torch.float32:
            np.testing.assert_array_equal(bits(r), bits(g.numpy()))
        else:
            np.testing.assert_array_equal(np.asarray(r), g.numpy())


def _jax_expand_filter(states, costs, cutoff, adaptive, scores, pg, fc, with_src_slot=False):
    """The expansion region of the JAX lattice emit stage, vmapped; with
    ``with_src_slot``, each lane's source slot last."""

    def one(s, c, cu, ab, sc):
        active = jnp.isfinite(c) & (c < cu)
        cand = jfrontier.expand_emitting(
            jfrontier.StepState(s, c, jnp.float32(0)), active, sc, pg, fc
        )
        nc = jnp.min(cand.cost) + ab
        ok = jnp.isfinite(cand.cost) & (cand.cost < nc)
        out = (cand.dst, jnp.where(ok, cand.cost, jnp.inf), cand.src_state,
               cand.arc_id, cand.overflow, nc)
        return out + (cand.src_slot,) if with_src_slot else out

    return jax.jit(jax.vmap(one))(states, costs, cutoff, adaptive, scores)


def _hub_graph(seed=2, S=200, E=900, hub=600, V=12):
    """(JAX CsrGraph, port CsrGraph) of a random eps-free graph whose
    state 0 has ``hub`` emitting arcs: a fat state whose remainder lanes
    span several lane blocks of the CUDA kernel."""
    from kaldi_decoder_tpu.fst.csr import CsrGraph as JaxCsrGraph
    from kaldi_decoder_tpu.fst.csr import GraphArrays as JaxGraphArrays
    from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy

    rng = np.random.default_rng(seed)
    src = np.sort(np.concatenate([np.zeros(hub, np.int64), rng.integers(1, S, E - hub)]))
    row = np.zeros(S + 1, np.int32)
    row[1:] = np.cumsum(np.bincount(src, minlength=S))
    il = rng.integers(1, V + 1, E).astype(np.int32)
    ga = JaxGraphArrays(
        row, il, rng.integers(0, 50, E).astype(np.int32),
        rng.uniform(0, 4, E).astype(np.float32), rng.integers(0, S, E).astype(np.int32),
        il - 1, np.zeros(S + 1, np.int32), np.zeros(0, np.int32), np.zeros(0, np.float32),
        np.zeros(0, np.int32), np.full(S, 1.0, np.float32),
    )
    cg = JaxCsrGraph(ga, S, E, 0, 0, 0, int(np.diff(row).max()), 0, V - 1)
    return cg, graph_from_numpy(cg)


@pytest.mark.parametrize("graph,budget,flat_group,inactive", [
    pytest.param("hlg", 4096, 4, False, id="4096"),
    pytest.param("hlg", 24, 4, False, id="24"),  # remainder overflow
    # The active slots fill the remainder budget exactly, or one unit short.
    pytest.param("hlg", "exact", 4, False, id="budget-exact"),
    pytest.param("hlg", "short", 4, False, id="budget-one-unit-short"),
    pytest.param("hlg", 4096, 4, True, id="all-inactive"),  # cutoff -inf
    pytest.param("hub", 1024, 4, False, id="fat-state"),
    pytest.param("hlg", 4096, 1, False, id="flat-group-1"),
    pytest.param("hlg", 4096, 8, False, id="flat-group-8"),
])
def test_expand_filter_matches_jax(graph, budget, flat_group, inactive):
    from kaldi_decoder_tpu.fst.pack import pack_graph_device as jax_pack
    from kaldi_decoder_tpu_torch.kernels.expand import remainder_units

    rng = np.random.default_rng(budget if isinstance(budget, int) else 7)
    B, K, V = 3, 64, 12
    if graph == "hlg":
        _, cg, pgraph = small_hlg()
        jgraph = JaxDecoder(cg, None, pad_time_to=8)._dev_graph
        pdev = fold_eps(pgraph).device
        states, costs = _frontier(rng, B, K, cg.num_states, (64, 30, 1))
    else:
        jgraph, pdev = _hub_graph()
        states, costs = _frontier(rng, B, K, pdev.num_states, (64, 30, 1))
        states[:, 0] = 0  # the hub, active in every row
    kw = dict(frontier_size=64, max_active=40, flat_group=flat_group)

    def configs(rem_budget):
        jfc, pfc = twin_configs(jgraph, pdev, rem_budget=rem_budget, **kw)
        assert_same_config(jfc, pfc)
        jpg = jax_pack(jgraph, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
        return jfc, pfc, jpg, packed_from_numpy(jpg, "cpu")

    jfc, pfc, jpg, ppg = configs(budget if isinstance(budget, int) else 4096)
    scores = np.log(rng.dirichlet(np.ones(V), size=B)).astype(np.float32)
    cut = get_cutoff(torch.from_numpy(costs), pfc.beam, pfc.max_active,
                     pfc.min_active, pfc.beam_delta, costs_sorted=True)
    cutoff = torch.full_like(cut.cutoff, -INF) if inactive else cut.cutoff
    totals = remainder_units(torch.from_numpy(states), torch.from_numpy(costs), cutoff, ppg, pfc)
    if isinstance(budget, str):
        units = int(totals.max()) - (budget == "short")
        jfc, pfc, jpg, ppg = configs(units * flat_group)
        assert pfc.rem_units == units
    ref = _jax_expand_filter(
        jnp.asarray(states), jnp.asarray(costs), jnp.asarray(cutoff.numpy()),
        jnp.asarray(cut.adaptive_beam.numpy()), jnp.asarray(scores), jpg, jfc,
    )
    args = (torch.from_numpy(states), torch.from_numpy(costs), cutoff,
            cut.adaptive_beam, torch.from_numpy(scores), ppg, pfc)
    got = expand_filter_plain(*args)
    for name, r, g in zip(got._fields, ref, got):
        r = np.asarray(r)
        assert r.shape == tuple(g.shape), name
        if r.dtype == np.float32:
            np.testing.assert_array_equal(bits(r), bits(g.numpy()), err_msg=name)
        else:
            np.testing.assert_array_equal(r, g.numpy(), err_msg=name)
    np.testing.assert_array_equal(got.overflow.numpy(), (totals > pfc.rem_units).numpy())
    if budget == 24 or budget == "short":
        assert bool(got.overflow.any())
    else:
        assert not bool(got.overflow.any())
    if inactive:
        assert not torch.isfinite(got.cost).any()
    if graph == "hub":  # the hub's remainder spans more than a kernel block's lanes
        assert pdev.max_em_out_degree - pfc.block_width > -(-pfc.num_candidates // 8)
    # The wrapper runs the plain version on CPU tensors and launches nothing.
    before = expand_filter.launches
    wrapped = expand_filter(*args)
    assert expand_filter.launches == before == 0
    for a, b in zip(wrapped, got):
        # src_slot is None unless asked for (the lattice path's call).
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("r", [12, 40, 400])  # r <= k, r > k, r > n
def test_dedup_select_rec_ties(r):
    rng = np.random.default_rng(r)
    B, N, K, S = 3, 160, 16, 30
    states = rng.integers(0, S, size=(B, N)).astype(np.int32)
    # Quantised costs force equal (state, cost) pairs and equal slacks.
    costs = (rng.integers(0, 12, size=(B, N)) * 0.5).astype(np.float32)
    costs[rng.random((B, N)) < 0.2] = INF
    costs[2] = INF  # an utterance with no candidates
    pay = (rng.integers(0, 1000, size=(B, N)).astype(np.int32),
           np.tile(np.arange(N, dtype=np.int32), (B, 1)))
    slack_beam = 2.0
    ref = jax.vmap(
        lambda s, c, p0, p1: jax_dedup_select_rec(
            s, c, K, S, r, slack_beam=slack_beam, payload=(p0, p1),
            sweep_cols=True, need_idx=False,
        )
    )(jnp.asarray(states), jnp.asarray(costs), jnp.asarray(pay[0]), jnp.asarray(pay[1]))
    got = dedup_select_rec(
        torch.from_numpy(states), torch.from_numpy(costs), K, S, r, slack_beam,
        payload=tuple(torch.from_numpy(p) for p in pay),
    )
    np.testing.assert_array_equal(np.asarray(ref.states), got.states.numpy())
    np.testing.assert_array_equal(bits(ref.costs), bits(got.costs.numpy()))
    np.testing.assert_array_equal(np.asarray(ref.num_unique), got.num_unique.numpy())
    for rr, gg in zip(ref.recs, got.recs):
        np.testing.assert_array_equal(np.asarray(rr), gg.numpy())
    np.testing.assert_array_equal(np.asarray(ref.rec_overflow), got.rec_overflow.numpy())
    np.testing.assert_array_equal(np.asarray(ref.rec_dst), got.rec_dst.numpy())
    np.testing.assert_array_equal(bits(ref.rec_slack), bits(got.rec_slack.numpy()))


def test_dedup_select_rec_negative_zero_slack():
    """An extra link of cost -0.0 in the state of a +0.0 leader that comes
    earlier in candidate order has slack -0.0 - (+0.0) = -0.0; the
    original's ``maximum(key, 0.0)`` records it as +0.0.  Compared by raw
    bits, without folding -0.0 onto +0.0."""
    states = np.array([[5, 5, 7, 7, 9, 3]], np.int32)
    costs = np.array([[0.0, -0.0, 1.0, 1.5, 2.0, INF]], np.float32)
    pay = (np.arange(6, dtype=np.int32)[None],)
    K, S, R, slack_beam = 4, 10, 8, 2.0
    ref = jax.vmap(
        lambda s, c, p: jax_dedup_select_rec(
            s, c, K, S, R, slack_beam=slack_beam, payload=(p,), sweep_cols=True,
            need_idx=False,
        )
    )(jnp.asarray(states), jnp.asarray(costs), jnp.asarray(pay[0]))
    got = dedup_select_rec(
        torch.from_numpy(states), torch.from_numpy(costs), K, S, R, slack_beam,
        payload=(torch.from_numpy(pay[0]),),
    )
    np.testing.assert_array_equal(np.asarray(ref.recs[0]), got.recs[0].numpy())
    assert got.recs[0][0, 3].item() == 1  # the -0.0 lane, recorded as an extra
    np.testing.assert_array_equal(
        np.asarray(ref.rec_slack, np.float32).view(np.int32),
        got.rec_slack.numpy().view(np.int32),
    )


def _rec_twins(states, costs, pay, K, S, R, slack_beam):
    """The JAX and the port's ``dedup_select_rec`` (the lattice call) on
    the same numpy input, every field compared by raw bits (-0.0 not
    folded).  Returns the port's result."""
    ref = jax.vmap(
        lambda s, c, *p: jax_dedup_select_rec(
            s, c, K, S, R, slack_beam=slack_beam, payload=p, sweep_cols=True, need_idx=False,
        )
    )(jnp.asarray(states), jnp.asarray(costs), *(jnp.asarray(p) for p in pay))
    got = dedup_select_rec(
        torch.from_numpy(states), torch.from_numpy(costs), K, S, R, slack_beam,
        payload=tuple(torch.from_numpy(p) for p in pay),
    )

    def raw(x):
        x = np.asarray(x)
        return x.view(np.int32) if x.dtype == np.float32 else x

    for name in ("states", "costs", "num_unique", "rec_overflow", "rec_dst", "rec_slack"):
        np.testing.assert_array_equal(raw(getattr(ref, name)), raw(getattr(got, name).numpy()),
                                      err_msg=name)
    for rr, gg in zip(ref.recs, got.recs):
        np.testing.assert_array_equal(np.asarray(rr), gg.numpy())
    return got


NEXT_1 = np.nextafter(np.float32(1.0), np.float32(2.0))


@pytest.mark.parametrize("case", ["equal-slack", "negative-zero-leader", "boundary-quirk"])
def test_dedup_select_rec_tie_rules(case):
    """K2's tie rules, pinned against JAX on raw bits.  equal-slack: state
    5's leader costs -1000, and lanes of cost nextafter(1, 2) (lane 0) and
    1 (lane 2) both get slack 1001 after float32 rounding; they keep the
    (state, cost, lane) order, so lane 2 is recorded before lane 0.
    negative-zero-leader: a -0.0 leader with a +0.0 extra of slack +0.0.
    boundary-quirk: state 8 ties the K-th frontier cost, top-K drops it
    (state 6 comes first), and its links are recorded all the same."""
    if case == "equal-slack":
        states = np.array([[5, 5, 5, 7, 9]], np.int32)
        costs = np.array([[NEXT_1, -1000.0, 1.0, 3.0, INF]], np.float32)
        K, S, R, beam = 2, 10, 6, 3000.0
        want = [1, 3, 2, 0, -1, -1]
    elif case == "negative-zero-leader":
        states = np.array([[4, 4, 6, 6, 4, 9]], np.int32)
        costs = np.array([[-0.0, 0.0, 0.5, 0.5, 0.25, INF]], np.float32)
        K, S, R, beam = 4, 10, 8, 2.0
        want = [0, 2, 1, 3, 4, -1, -1, -1]
    else:
        states = np.array([[3, 8, 6, 8, 6, 3, 1]], np.int32)
        costs = np.array([[1.0, 2.0, 2.0, 2.5, 3.0, 1.5, INF]], np.float32)
        K, S, R, beam = 2, 10, 8, 5.0
        want = [0, 2, 1, 5, 3, 4, -1, -1]
    lanes = np.arange(states.shape[1], dtype=np.int32)[None]
    got = _rec_twins(states, costs, (lanes, lanes + 100), K, S, R, beam)
    assert got.recs[0][0].tolist() == want
    if case == "boundary-quirk":
        assert 8 not in got.states[0].tolist() and 8 in got.rec_dst[0].tolist()
    if case == "negative-zero-leader":
        assert np.signbit(got.costs[0, 0].item())  # the -0.0 leader keeps its sign


def test_dedup_select_rec_crowded_matches_jax():
    """The plain ``dedup_select_rec`` against JAX on raw bits at the shape
    that sets K2's speed: states 4..2646 (eight moved near S-1), each with
    a leader and three extras of one slack, 5.0 (leader -4.0 and extras
    1.0, 1.0 + 2^-23, 1.0 + 2^-22, or leader -5.0 and extras -0.0, +0.0,
    2^-30: runs of equal (slack, state) keys with distinct costs, and
    equal costs ranked by lane), in random lane order, and R cutting
    inside the extras (overflow)."""
    rng = np.random.default_rng(7)
    B, N, S, G = 2, 16384, 102298, 2643
    one = np.float32(1.0).view(np.int32)
    a = np.array([-4.0, *np.array([one, one + 1, one + 2], np.int32).view(np.float32)],
                 np.float32)
    z = np.array([-5.0, -0.0, 0.0, 2.0 ** -30], np.float32)
    states = rng.integers(0, S, (B, N)).astype(np.int32)
    costs = np.full((B, N), INF, np.float32)
    for b in range(B):
        lanes = rng.permutation(N)[: 4 * G].reshape(G, 4)
        st = np.arange(G) + 4
        st[rng.choice(G, size=8, replace=False)] = S - 1 - np.arange(8)
        states[b, lanes] = st[:, None]
        costs[b, lanes] = np.where(rng.random(G)[:, None] < 0.5, a, z)
    lanes = np.tile(np.arange(N, dtype=np.int32), (B, 1))
    got = _rec_twins(states, costs, (lanes, lanes + 100), 2048, S, 8192, 8.0 + 1e-4)
    slack = got.rec_slack[got.rec_dst >= 0]
    assert int((slack == 5.0).sum()) == B * (8192 - G) and bool(got.rec_overflow.all())


@pytest.mark.parametrize("r", [12, 40, 400])  # r <= k, r > k, r > n
def test_dedup_rec_wrapper_on_cpu(r):
    """K2's wrapper on CPU tensors runs the plain version, launches
    nothing, and gives its record columns as (B, R, 4) rows."""
    rng = np.random.default_rng(100 + r)
    B, N, K, S = 3, 160, 16, 30
    states = torch.from_numpy(rng.integers(0, S, size=(B, N)).astype(np.int32))
    costs = (rng.integers(0, 12, size=(B, N)) * 0.5).astype(np.float32)
    costs[rng.random((B, N)) < 0.2] = INF
    costs = torch.from_numpy(costs)
    pay = tuple(torch.from_numpy(rng.integers(0, 1000, size=(B, N)).astype(np.int32))
                for _ in range(2))
    ref = dedup_select_rec(states, costs, K, S, r, 2.0, payload=pay)
    before = dedup_rec.dedup_select_rec.launches
    got = dedup_rec.dedup_select_rec(states, costs, K, S, r, 2.0, payload=pay)
    assert dedup_rec.dedup_select_rec.launches == before == 0
    assert torch.equal(got.states, ref.states) and torch.equal(got.num_unique, ref.num_unique)
    assert torch.equal(got.costs.view(torch.int32), ref.costs.view(torch.int32))
    assert torch.equal(got.rec_overflow, ref.rec_overflow)
    assert got.records.shape == (B, r, 4) and got.records.dtype == torch.int32
    assert torch.equal(got.records[..., 0], ref.recs[0])
    assert torch.equal(got.records[..., 1], ref.recs[1])
    assert torch.equal(got.records[..., 2], ref.rec_dst)
    assert torch.equal(got.records[..., 3], ref.rec_slack.view(torch.int32))


@pytest.mark.parametrize("caps,rems", [
    pytest.param("default", "mixed", id="False"),
    pytest.param("small", "mixed", id="True"),  # buffers overflow
    # One utterance has no frame left (every frame frozen), one runs past
    # the chunk.
    pytest.param("default", "frozen", id="rem-0-and-past-chunk"),
    # Caps equal to the largest survivor counts (no overflow), and one
    # below them (overflow).
    pytest.param("exact", "mixed", id="caps-equal-counts"),
    pytest.param("one-below", "mixed", id="caps-one-below-counts"),
])
def test_sweep_matches_jax_chunk(caps, rems):
    """The port's sweep on a real JAX chunk (frontiers and records of a
    decode of the small HLG) equals JAX's ``_sweep_one`` vmapped; with
    small caps the clamped appends and overflow flags must agree too."""
    _, cg, pgraph = small_hlg()
    scores, lengths, _ = hlg_batch(3, seed=5)
    C, B = 16, 3
    kw = dict(lattice_beam=5.0, em_records=512, pad_time_to=8)
    jdec = JaxDecoder(cg, None, **kw)
    dev_graph = fold_eps(pgraph).device
    jfc, pfc = twin_configs(jdec._dev_graph, dev_graph, frontier_size=64, max_active=48)
    jdec = JaxDecoder(cg, jfc, **kw)
    st0, _, _, _ = jdec._init(B)
    rem = np.asarray(lengths, np.int32) - 4  # an utterance ends inside the chunk
    rem[0] = 40  # and one runs past it
    if rems == "frozen":
        rem[1] = 0
    _, o = jdec._chunk_fn(jdec._pg_dev, jnp.asarray(scores[:, :C]), jnp.asarray(rem), st0)
    jsc = jax_sweep_config(jdec.cfg, C)
    pcfg = lattice_config_for_graph(
        dev_graph, _cfg_for_device_graph(dev_graph, pfc), em_records=512,
        lattice_beam=5.0,
    )
    psc = sweep_config(pcfg, C)
    assert (psc.tok_cap, psc.em_cap, psc.em_records) == (
        jsc.tok_cap, jsc.em_cap, jsc.em_records)
    args = [
        torch.from_numpy(np.asarray(o.frontier_states)),
        torch.from_numpy(np.asarray(o.frontier_costs)),
        torch.from_numpy(np.asarray(o.em_records)),
        torch.from_numpy(np.asarray(st0.states)),
        torch.from_numpy(rem),
        psc,
        cg.num_states,
    ]
    if caps == "small":
        tok_cap, em_cap = 70, 90
    elif caps in ("exact", "one-below"):
        full = sweep_plain(*args)
        tok_cap = int(full.tok_count.max()) - (caps == "one-below")
        em_cap = int(full.em_count.max()) - (caps == "one-below")
    if caps != "default":
        jsc = dataclasses.replace(jsc, tok_cap=tok_cap, em_cap=em_cap)
        args[5] = psc = dataclasses.replace(psc, tok_cap=tok_cap, em_cap=em_cap)
    ref = jax_build_sweep_fn(jsc)(
        o.frontier_states, o.frontier_costs, o.em_records, o.eps_records,
        st0.states, jnp.asarray(rem),
    )
    got = sweep_plain(*args)
    for name in ("tok", "em"):
        rc = np.asarray(getattr(ref, f"{name}_count"))
        np.testing.assert_array_equal(rc, getattr(got, f"{name}_count").numpy())
        for b in range(B):
            np.testing.assert_array_equal(
                np.asarray(getattr(ref, f"{name}_rows"))[b, : rc[b]],
                getattr(got, f"{name}_rows")[b, : rc[b]].numpy(),
                err_msg=f"{name} b={b}",
            )
    assert not np.asarray(ref.eps_count).any()  # eps-free device graph
    np.testing.assert_array_equal(np.asarray(ref.overflow), got.overflow.numpy())
    assert bool(got.overflow.any()) == (caps in ("small", "one-below"))
    if rems == "frozen":
        assert int(got.tok_count[1]) == int(got.em_count[1]) == 0
    before = sweep_chunk.launches
    wrapped = sweep_chunk(*args)
    assert sweep_chunk.launches == before == 0
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
