"""K5's and the eps step's plain versions against the JAX package, on the CPU.

``kernels.eps.expand_eps_lanes_plain`` is held against the candidate
arrays of the JAX eps iterations themselves: ``frontier.eps_iteration``
and ``lattice_dev.eps_iteration_rec`` run eagerly, one row at a time,
with their ``expand_eps`` and dedup calls wrapped so that the arrays
they are given are kept (the lanes without incumbents are the same
arrays past the K incumbents, as the sharded decoders build them).
``kernels.eps.eps_step_plain``, composed with K5's and the dedup call's
plain versions over D = 2 iterations, is held against the JAX
``eps_closure_batched`` and ``eps_closure_rec_batched`` on the cyclic
eps ring; so is ``kernels.eps.eps_dedup`` on the CPU (the dedup call's
plain version, then ``eps_step_plain``: the plain version of the card's
dedup call with the eps step as its last step) over whole closures of
D = 2 and 3: a batch that stops at iteration 0, inactive rows in the
middle of the batch, the last iteration of a cyclic budget, a lattice row
whose spill row is hit.  Inputs are made with numpy; every comparison is
exact (float32 by its bits, -0.0 folded onto +0.0 where the JAX sorts
fold it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decoders import frontier as jfrontier
from kaldi_decoder_tpu.decoders import lattice_dev as jlattice_dev
from kaldi_decoder_tpu.fst.csr import compile_fst as jax_compile_fst
from kaldi_decoder_tpu.fst.pack import pack_graph_device as jax_pack
from kaldi_decoder_tpu_torch.decoders.frontier import StepState
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.fst.pack import packed_from_numpy
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.eps import (
    EpsLanes,
    empty_eps_carry,
    eps_dedup,
    eps_step_plain,
    expand_eps_lanes_plain,
)
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

from _torch_util import bits, twin_configs
from test_torch_lattice_eps import _eps_ring
from test_torch_viterbi import _eps_twins, _frontier

INF = float("inf")
R_EPS = 16
SLACK = 3.0 + 1e-4


def _eq(ref, got, msg):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (msg, ref.shape, got.shape)
    if ref.dtype == np.float32:
        ref, got = bits(ref), bits(got)
    np.testing.assert_array_equal(ref, got, err_msg=msg)


def _jax_lanes(monkeypatch, jst, cutoff, jpg, jfc, S, rec):
    """The candidate lanes (state, cost, src_slot, src_state, arc_id) of
    the JAX eps iteration of each row (``eps_iteration_rec`` when ``rec``,
    else ``eps_iteration``), as numpy (B, K + N_eps), and each row's
    expansion overflow: what its expansion gave and its dedup call was
    given."""
    K = jfc.frontier_size
    kept = {}
    mod = jlattice_dev if rec else jfrontier
    expand = mod.expand_eps

    def keep_expand(*a, **kw):
        kept["cand"] = expand(*a, **kw)
        return kept["cand"]

    def keep_dedup(fn):
        def call(cand_state, cand_cost, *a, **kw):
            kept["lanes"] = (cand_state, cand_cost, kw.get("payload"))
            return fn(cand_state, cand_cost, *a, **kw)
        return call

    monkeypatch.setattr(mod, "expand_eps", keep_expand)
    if rec:
        monkeypatch.setattr(mod, "dedup_select_rec", keep_dedup(jlattice_dev.dedup_select_rec))
    else:
        monkeypatch.setattr(mod, "dedup_select", keep_dedup(jfrontier.dedup_select))
    rows = []
    for b in range(jst.states.shape[0]):
        st = jfrontier.StepState(jst.states[b], jst.costs[b], jnp.float32(0.0))
        if rec:
            jlattice_dev.eps_iteration_rec(st, jnp.float32(cutoff[b]), jpg, jfc, S, R_EPS, SLACK)
        else:
            jfrontier.eps_iteration(st, jnp.float32(cutoff[b]), jpg, jfc, S)
        cand = kept["cand"]
        state, cost, payload = kept["lanes"]
        none = np.full(K, -1, np.int32)
        slot = np.concatenate([np.arange(K, dtype=np.int32), np.asarray(cand.src_slot)])
        if rec:
            src_state, arc = (np.asarray(p) for p in payload)
        else:
            src_state = np.concatenate([none, np.asarray(cand.src_state)])
            arc = np.concatenate([none, np.asarray(cand.arc_id)])
        rows.append((np.asarray(state), np.asarray(cost), slot, src_state, arc,
                     bool(cand.overflow)))
    monkeypatch.undo()
    return [np.stack([r[i] for r in rows]) for i in range(6)]


@pytest.mark.parametrize("rec", [False, True], ids=["viterbi", "lattice"])
@pytest.mark.parametrize("incumbents", [True, False])
@pytest.mark.parametrize("graph,eps_rem_budget", [
    ("hlg", None), ("synthetic", 512), ("synthetic", 8),  # 8: the remainder lanes overflow
])
def test_expand_eps_lanes_plain_matches_jax(monkeypatch, graph, eps_rem_budget, incumbents,
                                           rec):
    """K5's plain version against the lanes of the JAX eps iteration,
    exactly, column by column: eps block width 1 on the random graph, so
    its states have more eps arcs than the block (remainder lanes); a
    budget of 8 that overflows; a row with no slot under its cutoff; a
    cutoff of +inf; with the incumbents first and without; and the
    remainder lanes past the total (their owner, source state and arc as
    the lane map gives them, cost +inf) field by field."""
    kw = dict(frontier_size=64, max_active=48)
    if eps_rem_budget:
        kw.update(eps_rem_budget=eps_rem_budget, eps_block_width=1)
    cg, jfc, pfc, jpg, ppg = _eps_twins(graph, **kw)
    S, K = cg.num_states, pfc.frontier_size
    rng = np.random.default_rng(7)
    states, costs = _frontier(rng, 3, K, S)
    cutoff = np.array([3.0, -1.0, np.inf], np.float32)  # row 1: no slot under its cutoff
    jst = jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.zeros(3))
    want = _jax_lanes(monkeypatch, jst, cutoff, jpg, jfc, S, rec)
    got = expand_eps_lanes_plain(torch.from_numpy(states), torch.from_numpy(costs),
                                 torch.from_numpy(cutoff), ppg, pfc, incumbents)
    lo = 0 if incumbents else K
    for f, w, g in zip(EpsLanes._fields, want, got):
        _eq(w if f == "overflow" else w[:, lo:], g.numpy(), f)
    assert got.overflow.any().item() == (eps_rem_budget == 8)
    assert not np.isfinite(got.cost.numpy()[1, K if incumbents else 0:]).any()
    # The remainder lanes past each row's total, field by field.
    rem0 = got.dst.shape[1] - pfc.eps_rem_budget
    padding = 0
    for b in range(3):
        act = np.isfinite(costs[b]) & (costs[b] <= cutoff[b])
        deg = np.diff(cg.arrays.eps_row_ptr)[states[b]]
        total = int(np.maximum(deg - pfc.eps_block_width, 0)[act].sum())
        if total >= pfc.eps_rem_budget:
            continue
        pad = slice(rem0 + total, None)
        padding += got.dst.shape[1] - pad.start
        assert np.isinf(got.cost.numpy()[b, pad]).all()
        for f, w, g in zip(EpsLanes._fields[:5], want[:5], got[:5]):
            _eq(w[b, lo:][pad], g.numpy()[b, pad], f"padding lanes of row {b}: {f}")
    assert padding > 0


def _ring_twins(exact, iters=2):
    """The 8-state eps ring's JAX and port configs (K 8, D = ``iters``,
    eps_exact as given) and packed tables."""
    cg = jax_compile_fst(_eps_ring(8))
    pg = graph_from_numpy(cg)
    jfc, pfc = twin_configs(cg, pg, beam=50.0, min_active=0, frontier_size=8,
                            eps_iters=iters, eps_exact=exact)
    assert (pfc.frontier_size, pfc.eps_iters, pfc.eps_exact) == (8, iters, exact)
    jpg = jax_pack(cg, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
    return cg, jfc, pfc, jpg, packed_from_numpy(jpg, "cpu")


# case: rows' tokens {state: cost} and the rows still decoding.  "stops":
# the active rows' eps lanes only tie their incumbents, so no active row
# changes and `ran` turns false after the first iteration (the inactive
# row 1 changes, which must not count); "runs": the tokens keep moving
# round the ring, so some active row still changes at the last iteration.
RING_CASES = {
    "stops": ([{s: 0.0 for s in range(8)}, {0: 0.0, 1: 5.0}, {}], [True, False, True]),
    "runs": ([{0: 0.0}, {3: 1.0, 5: 0.5}, {}], [True, True, False]),
}


@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_eps_step_plain_closure_matches_jax(case, exact, lattice):
    """``eps_step_plain`` after K5's and the dedup call's plain versions,
    over D = 2 iterations, against the JAX batched closure: the frontier,
    each iteration's backpointers or records, the overflow and saturation
    flags, exactly (the frontier of the rows still decoding); and ``ran``
    as the JAX loop leaves it."""
    cg, jfc, pfc, jpg, ppg = _ring_twins(exact)
    S, K, D = cg.num_states, pfc.frontier_size, pfc.eps_iters
    tokens, active = RING_CASES[case]
    states = np.zeros((3, K), np.int32)
    costs = np.full((3, K), np.inf, np.float32)
    for b, row in enumerate(tokens):
        order = sorted(row, key=lambda s: (row[s], s))
        states[b, :len(order)] = order
        costs[b, :len(order)] = [row[s] for s in order]
    cutoff = np.array([10.0, np.inf, 10.0], np.float32)
    row_active = np.array(active)
    jst = jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.zeros(3))
    args = (jst, jnp.asarray(cutoff), jnp.asarray(row_active), jpg, jfc, S)
    if lattice:
        jres = jlattice_dev.eps_closure_rec_batched(*args, R_EPS, SLACK)
    else:
        jres = jfrontier.eps_closure_batched(*args)

    st = StepState(torch.from_numpy(states), torch.from_numpy(costs), None)
    cut, ra = torch.from_numpy(cutoff), torch.from_numpy(row_active)
    carry = empty_eps_carry(3, D, R_EPS if lattice else K, lattice, "cpu")
    ran = []
    for d in range(D):
        lanes = expand_eps_lanes_plain(st.states, st.costs, cut, ppg, pfc, True,
                                       with_src_slot=not lattice, with_src_state=lattice)
        if lattice:
            sel = dedup_select_rec(lanes.dst, lanes.cost, K, S, K + R_EPS, SLACK,
                                   (lanes.src_state, lanes.arc_id), num_incumbents=K)
        else:
            sel = dedup_select_plain(lanes.dst, lanes.cost, K, S)
        eps_step_plain(d, carry, ra, lanes.overflow, sel, exact, lanes)
        st = StepState(sel.states, sel.costs, None)
        ran.append(bool(carry.flags[0]))
    # A row no longer decoding may go on changing after the JAX loop has
    # stopped (the frame discards it): the frontiers of the active rows.
    _eq(np.asarray(jres[0].states)[row_active], st.states.numpy()[row_active], "states")
    _eq(np.asarray(jres[0].costs)[row_active], st.costs.numpy()[row_active], "costs")
    _eq(np.swapaxes(np.asarray(jres[1]), 0, 1), carry.out.numpy(),
        "records" if lattice else "backpointers")
    _eq(jres[2], carry.overflow.numpy(), "overflow")
    _eq(jres[3], carry.saturated.numpy(), "saturated")
    assert carry.flags[1:].tolist() == [0]
    if case == "stops":
        assert ran == [False, False]
        assert bool(carry.changed[1])  # the inactive row changed, and did not count
        assert (carry.out[:, 1] == (-1 if lattice else torch.stack(
            [torch.arange(K, dtype=torch.int32), torch.full((K,), -1, dtype=torch.int32)],
            dim=-1))).all()
    else:
        assert ran == [True, True]
        assert carry.overflow[0].item() == (not exact)


# case: rows' tokens {state: cost}, their cutoffs, the rows still
# decoding, D and r_eps.  "stop0": no active row changes at iteration 0
# (rows closed under the ring's eps arcs, a row above its cutoff, an empty
# row), so the batch stops there and iterations 1 and 2 write the identity
# or -1; "inactive": rows 1 and 3 no longer decode (they change, and do
# not count) between rows that do; "cyclic": RING_CASES' "runs" at D = 3,
# a cyclic budget whose last iteration still changes; "spill": every token
# on the ring at one cost, whose eps lanes tie their incumbents and are all
# links, past r_eps = 2 (lattice only).
EDGE_CASES = {
    "stop0": ([{s: 0.0 for s in range(8)}, {0: 5.0}, {}, {s: 0.5 for s in range(8)}],
              [10.0, 1.0, 10.0, 10.0], [True] * 4, 3, R_EPS),
    "inactive": ([{0: 0.0}, {0: 0.0, 4: 1.0}, {3: 1.0, 5: 0.5}, {2: 0.25}, {}],
                 [10.0] * 5, [True, False, True, False, True], 3, R_EPS),
    "cyclic": (RING_CASES["runs"][0], [10.0, np.inf, 10.0], RING_CASES["runs"][1], 3, R_EPS),
    "spill": ([{s: 0.0 for s in range(8)}, {0: 0.0}, {s: 0.0 for s in range(4)}],
              [10.0] * 3, [True] * 3, 2, 2),
}
EDGE = [(c, lat) for c in sorted(EDGE_CASES) for lat in (False, True)
        if lat or c != "spill"]


@pytest.mark.parametrize("case,lattice", EDGE,
                         ids=[f"{c}-{'lattice' if lat else 'viterbi'}" for c, lat in EDGE])
def test_eps_dedup_plain_closure_matches_jax(case, lattice):
    """``kernels.eps.eps_dedup`` on the CPU, over a whole closure (K5's
    plain lanes, then the dedup call's plain version and the eps step's,
    as one call), against the JAX batched closure: the frontier of the
    rows still decoding, each iteration's backpointers or records, the
    overflow and saturation flags, exactly; ``ran`` as the JAX loop leaves
    it.  The cyclic budget (``eps_exact`` False) throughout, so that its
    last iteration's overflow is in every case."""
    tokens, cutoff, active, D, r_eps = EDGE_CASES[case]
    cg, jfc, pfc, jpg, ppg = _ring_twins(False, D)
    S, K, B = cg.num_states, pfc.frontier_size, len(tokens)
    states = np.zeros((B, K), np.int32)
    costs = np.full((B, K), np.inf, np.float32)
    for b, row in enumerate(tokens):
        order = sorted(row, key=lambda s: (row[s], s))
        states[b, :len(order)] = order
        costs[b, :len(order)] = [row[s] for s in order]
    cutoff = np.array(cutoff, np.float32)
    row_active = np.array(active)
    jst = jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.zeros(B))
    args = (jst, jnp.asarray(cutoff), jnp.asarray(row_active), jpg, jfc, S)
    if lattice:
        jres = jlattice_dev.eps_closure_rec_batched(*args, r_eps, SLACK)
    else:
        jres = jfrontier.eps_closure_batched(*args)

    st = StepState(torch.from_numpy(states), torch.from_numpy(costs), None)
    cut, ra = torch.from_numpy(cutoff), torch.from_numpy(row_active)
    carry = empty_eps_carry(B, D, r_eps if lattice else K, lattice, "cpu")
    ran = []
    for d in range(D):
        lanes = expand_eps_lanes_plain(st.states, st.costs, cut, ppg, pfc, True,
                                       with_src_slot=not lattice, with_src_state=lattice)
        sel = eps_dedup(d, carry, ra, lanes, False, K, S, SLACK if lattice else None)
        st = StepState(sel.states, sel.costs, None)
        ran.append(bool(carry.flags[0]))
    _eq(np.asarray(jres[0].states)[row_active], st.states.numpy()[row_active], "states")
    _eq(np.asarray(jres[0].costs)[row_active], st.costs.numpy()[row_active], "costs")
    _eq(np.swapaxes(np.asarray(jres[1]), 0, 1), carry.out.numpy(),
        "records" if lattice else "backpointers")
    _eq(jres[2], carry.overflow.numpy(), "overflow")
    _eq(jres[3], carry.saturated.numpy(), "saturated")
    assert carry.flags[1:].tolist() == [0]
    stopped = -1 if lattice else torch.stack(
        [torch.arange(K, dtype=torch.int32), torch.full((K,), -1, dtype=torch.int32)], dim=-1)
    if case == "stop0":
        assert ran == [False] * D
        assert all((carry.out[:, d] == stopped).all() for d in range(1, D))
        assert not carry.overflow.any()
    elif case == "inactive":
        assert ran[0] and carry.changed[1] and carry.changed[3]
    elif case == "cyclic":
        assert ran == [True] * D and bool(carry.overflow[0]) and not bool(carry.overflow[2])
    else:
        assert carry.overflow[[0, 2]].all(), "rows 0 and 2 have more links than r_eps"
