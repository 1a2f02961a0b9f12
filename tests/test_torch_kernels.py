"""The CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA card with ``nvcc`` (the kernels are built for
``sm_90a``; a CUDA kernel has no CPU interpret mode), so they carry the
``cuda`` marker and skip elsewhere.  The file imports nothing of JAX, so
on a machine without it run
``python -m pytest --noconftest tests/test_torch_kernels.py -q``.  The CPU
side of the same wrappers is covered by ``tests/test_torch_ops.py`` and
``tests/test_torch_gather.py``.
"""

import contextlib
import functools

import numpy as np
import pytest
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.decoders.lattice import BatchedLatticeDecoder
from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
    lattice_chunk,
    lattice_frame_step_batched,
)
from kaldi_decoder_tpu_torch.decoders.sweep import SweepConfig, sweep_config, sweep_plain
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays, _eps_depth
from kaldi_decoder_tpu_torch.fst.pack import pack_graph_device
from kaldi_decoder_tpu_torch.kernels._build import kernels
from kaldi_decoder_tpu_torch.kernels.dedup import cluster_size as dedup_cluster_size
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.dedup_rec import cluster_size as rec_cluster_size
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec, stack_records
from kaldi_decoder_tpu_torch.kernels.eps import (
    EpsLanes,
    empty_eps_carry,
    eps_dedup,
    expand_eps_lanes,
    expand_eps_lanes_plain,
)
from kaldi_decoder_tpu_torch.kernels.expand import (
    expand_filter,
    expand_filter_plain,
    remainder_units,
)
from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain
from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain
from kaldi_decoder_tpu_torch.ops.segment import dedup_select_rec as dedup_select_rec_plain

B, T, V = 3, 24, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _graph(seed=0, S=400, E=3000, fat=0):
    """Random eps-free graph with a few hub states, so fat states use the
    remainder lanes; with ``fat``, state 0 has ``fat`` more arcs."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, E)
    src[: E // 5] = rng.integers(0, 8, E // 5)
    if fat:
        src = np.concatenate([src, np.zeros(fat, src.dtype)])
        E += fat
    src.sort()
    row = np.zeros(S + 1, np.int32)
    row[1:] = np.cumsum(np.bincount(src, minlength=S))
    il = rng.integers(1, V + 1, E).astype(np.int32)
    ga = GraphArrays(
        row, il, rng.integers(0, 50, E).astype(np.int32),
        rng.uniform(0, 4, E).astype(np.float32), rng.integers(0, S, E).astype(np.int32),
        il - 1, np.zeros(S + 1, np.int32), np.zeros(0, np.int32),
        np.zeros(0, np.float32), np.zeros(0, np.int32),
        np.where(rng.random(S) < 0.1, 1.0, np.inf).astype(np.float32),
    )
    return CsrGraph(ga, S, E, 0, 0, 0, int(np.diff(row).max()), 0, V - 1)


def _decoder(device, rem_budget, frontier_size=64, g=None, max_active=48, em_records=512):
    g = g or _graph()
    fc = config_for_graph(g, frontier_size=frontier_size, max_active=max_active, beam=10.0,
                          rem_budget=rem_budget)
    return BatchedLatticeDecoder(g, fc, lattice_beam=5.0, em_records=em_records,
                                 pad_time_to=8, device=device)


def _scores(device, nb=B):
    rng = np.random.default_rng(1)
    s = np.log(rng.dirichlet(np.ones(V), size=(T, nb))).astype(np.float32)
    return torch.from_numpy(s).to(device)  # time-major (T, nb, V)


def _batch_for_cluster(query, want):
    """The smallest batch at which ``query(B)``, a kernel's cluster-size
    picker, answers ``want``."""
    for nb in range(1, 1025):
        if query(nb) == want:
            return nb
    raise AssertionError(f"no batch up to 1024 gets clusters of {want}")


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = torch.where(x == 0, 0.0, x)
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [11, 128])  # 128: the 16-byte vector path
def test_row_gather_kernel_matches_plain(card, width):
    rng = np.random.default_rng(width)
    table = rng.integers(-(1 << 30), 1 << 30, size=(1000, width)).astype(np.int32)
    idx = rng.integers(0, 1000, size=(B, 64)).astype(np.int32)
    table, idx = torch.from_numpy(table).to(card), torch.from_numpy(idx).to(card)
    before = row_gather.launches
    got = row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(got, row_gather_plain(table, idx))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [11, 16, 128])  # 16 and 128: the 16-byte vector path
@pytest.mark.parametrize("case", ["n-below-32", "n-not-a-multiple-of-32", "out-of-range"])
def test_row_gather_kernel_shapes(card, width, case):
    """The gather's warp tiles of 32 rows: a single partial tile, a
    partial last tile after full ones (over more tiles than one wave of
    blocks holds), and indices outside the table, whose rows the kernel
    writes as zeros (the plain version raises on them)."""
    rng = np.random.default_rng(width)
    R = 1000
    table = rng.integers(-(1 << 30), 1 << 30, size=(R, width)).astype(np.int32)
    n = {"n-below-32": 7, "n-not-a-multiple-of-32": 300_011}.get(case, 4133)
    idx = rng.integers(0, R, size=n).astype(np.int32)
    bad = np.zeros(n, bool)
    if case == "out-of-range":
        bad[rng.choice(n, 200, replace=False)] = True
        idx[bad] = rng.choice([-1, -(1 << 31), R, R + 5, (1 << 31) - 1], bad.sum())
    want = np.where(bad[:, None], 0, table[np.where(bad, 0, idx)])
    table, idx = torch.from_numpy(table).to(card), torch.from_numpy(idx).to(card)
    before = row_gather.launches
    for _ in range(2):
        got = row_gather(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert row_gather.launches == before + 2


def _read_only_where_active(card, S, nb, K, n_active):
    """A cost-sorted frontier of ``nb`` utterances and K distinct states,
    the best at cost 0: ``n_active`` slots (None: all) within a beam of
    10, then slots far outside it, and the second half dead."""
    rng = np.random.default_rng(nb + K)
    states = np.stack([rng.choice(S, K, replace=False) for _ in range(nb)]).astype(np.int32)
    costs = np.sort(rng.uniform(0, 12, (nb, K)), axis=1).astype(np.float32)
    costs[:, 0] = 0.0
    if n_active is not None:
        costs[:, n_active:] = 100.0 + costs[:, n_active:]
        costs[:, K // 2:] = np.inf
    return torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card)


@pytest.mark.cuda
@pytest.mark.parametrize("active", [None, 1, 3], ids=["many", "one", "three"])
@pytest.mark.parametrize("batch", ["B1", "B16", "C8", "C4", "C2", "C1"])
@pytest.mark.parametrize("K,max_active,S,E", [
    pytest.param(64, 40, 400, 3000, id="K64-KE40"),
    # KE 3000: past one round of PER slots a thread (2560), so the
    # padding lanes' owner is read by one thread.
    pytest.param(8192, 3000, 9000, 90000, id="K8192-KE3000"),
])
def test_expand_kernel_reads_only_active_states(card, K, max_active, S, E, batch, active):
    """K1 reads the em_block row of each active slot among the first KE
    itself: with every other state set to -1 or to S + 7 it must equal the
    plain version on the frontier as it is, bitwise, at B=1 and 16 and at
    every cluster size, with KE not a multiple of 32 times the cluster
    size, and with sparse active sets of one and of three slots."""
    g = _graph(S=S, E=E)
    fc = config_for_graph(g, frontier_size=K, max_active=max_active, min_active=0, beam=10.0,
                          rem_budget=4096)
    assert fc.expand_lanes == max_active and fc.expand_lanes % 32
    pg = pack_graph_device(g, fc.block_width, fc.eps_block_width, fc.flat_group, card)
    shape = (fc.expand_lanes, fc.block_width, fc.flat_group, fc.rem_units)
    if batch.startswith("B"):
        nb = int(batch[1:])
    else:
        nb = _batch_for_cluster(lambda n: kernels().kd_expand_cluster(n, *shape), int(batch[1:]))
    states, costs = _read_only_where_active(card, S, nb, K, active)
    cut = get_cutoff(costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    k = torch.arange(K, device=card)
    read = torch.isfinite(costs) & (costs < cut.cutoff[:, None]) & (k < fc.expand_lanes)
    if active is not None:
        assert bool((read.sum(dim=1) == active).all())
    args = (states, costs, cut.cutoff, cut.adaptive_beam, _scores(card, nb)[0], pg, fc)
    for with_src_slot in (False, True):
        ref = expand_filter_plain(*args, with_src_slot=with_src_slot)
        for value in (-1, S + 7):
            before = expand_filter.launches
            got = expand_filter(torch.where(read, states, value), *args[1:],
                                with_src_slot=with_src_slot)
            torch.cuda.synchronize()
            assert expand_filter.launches == before + 1
            _same_expansion(ref, got)
    if batch.startswith("C"):
        assert kernels().kd_expand_cluster(nb, *shape) == int(batch[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("rem_budget", [4096, 16])  # 16: remainder overflow
def test_expand_kernel_matches_plain(card, rem_budget):
    dec = _decoder(card, rem_budget)
    fc = dec.cfg.frontier
    st, _, _, _ = dec._init(B)
    sc = _scores(card)
    for t in range(T):
        cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active,
                         fc.beam_delta, costs_sorted=True)
        args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, sc[t], dec._pg, fc)
        ref = expand_filter_plain(*args)
        got = expand_filter(*args)
        torch.cuda.synchronize()
        for name, r, g in zip(ref._fields, ref, got):
            if r is None:  # src_slot: not asked for
                assert g is None
                continue
            if r.dtype == torch.float32:
                r, g = _bits(r), _bits(g)
            assert torch.equal(r, g), (t, name)
        st, _ = lattice_frame_step_batched(
            st, sc[t], torch.ones(B, dtype=torch.bool, device=card), dec._pg,
            dec.cfg, dec._dev_graph.num_states,
        )


@pytest.mark.cuda
@pytest.mark.parametrize("small_caps", [False, True])
def test_sweep_kernel_matches_plain(card, small_caps):
    dec = _decoder(card, 4096)
    st0, _, _, _ = dec._init(B)
    rem = torch.tensor([40, 9, 13], dtype=torch.int32, device=card)
    S = dec._dev_graph.num_states
    _, o = lattice_chunk(dec._pg, _scores(card), rem, st0, dec.cfg, S)
    swc = sweep_config(dec.cfg, T)
    if small_caps:
        import dataclasses

        swc = dataclasses.replace(swc, tok_cap=70, em_cap=90)
    args = (o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem, swc, S)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    assert torch.equal(ref.tok_count, got.tok_count)
    assert torch.equal(ref.em_count, got.em_count)
    assert torch.equal(ref.overflow, got.overflow)
    assert bool(got.overflow.any()) == small_caps
    for b in range(B):
        n, m = int(ref.tok_count[b]), int(ref.em_count[b])
        assert torch.equal(ref.tok_rows[b, :n], got.tok_rows[b, :n])
        assert torch.equal(ref.em_rows[b, :m], got.em_rows[b, :m])


@pytest.mark.cuda
def test_expand_kernel_src_slot_matches_plain(card):
    """K1 with the source-slot output (the Viterbi path's call)."""
    dec = _decoder(card, 16)  # remainder overflow: invalid remainder lanes too
    fc = dec.cfg.frontier
    st, _, _, _ = dec._init(B)
    sc = _scores(card)
    for t in range(6):
        cut = get_cutoff(st.costs, fc.beam, fc.max_active, fc.min_active,
                         fc.beam_delta, costs_sorted=True)
        args = (st.states, st.costs, cut.cutoff, cut.adaptive_beam, sc[t], dec._pg, fc)
        ref = expand_filter_plain(*args, with_src_slot=True)
        got = expand_filter(*args, with_src_slot=True)
        torch.cuda.synchronize()
        assert torch.equal(ref.src_slot, got.src_slot), t
        assert torch.equal(_bits(ref.cost), _bits(got.cost)), t
        st, _ = lattice_frame_step_batched(
            st, sc[t], torch.ones(B, dtype=torch.bool, device=card), dec._pg,
            dec.cfg, dec._dev_graph.num_states,
        )


def _frontier(card, S, nb, K):
    """A cost-sorted frontier of ``nb`` utterances and K distinct states,
    the best at cost 0, and utterance 2's slots past 20 dead."""
    rng = np.random.default_rng(3)
    states = torch.from_numpy(
        np.stack([rng.choice(S, K, replace=False) for _ in range(nb)]).astype(np.int32))
    costs = torch.from_numpy(np.sort(rng.uniform(0, 12, (nb, K)), axis=1).astype(np.float32))
    costs[:, 0] = 0.0
    costs[2, 20:] = float("inf")
    return states.to(card), costs.to(card)


def _same_expansion(ref, got):
    for name, r, g in zip(ref._fields, ref, got):
        if r is None:  # src_slot: not asked for
            assert g is None
            continue
        if r.dtype == torch.float32:
            r, g = _bits(r), _bits(g)
        assert torch.equal(r, g), name


@pytest.mark.cuda
@pytest.mark.parametrize("with_src_slot", [False, True])
@pytest.mark.parametrize("case", [
    "budget-exact", "budget-one-unit-short", "all-inactive", "fat-state",
    "flat-group-1", "flat-group-8",
])
def test_expand_kernel_edge_cases(card, case, with_src_slot):
    """K1 against plain where the kernel's partition of lanes over a
    cluster's blocks could go wrong: a remainder budget filled exactly or
    one unit short, no active slot, one state whose remainder spans
    several blocks' lanes, one and eight arcs per remainder unit."""
    fat = case == "fat-state"
    g = _graph(fat=1500 if fat else 0)
    G = {"flat-group-1": 1, "flat-group-8": 8}.get(case, 4)
    kw = dict(frontier_size=64, max_active=48, beam=10.0, flat_group=G)

    def setup(rem_budget):
        fc = config_for_graph(g, rem_budget=rem_budget, **kw)
        return fc, pack_graph_device(g, fc.block_width, fc.eps_block_width, G, card)

    fc, pg = setup(4096)
    states, costs = _frontier(card, g.num_states, B, 64)
    if fat:
        states[:, 0] = 0
    cut = get_cutoff(costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    cutoff = torch.full_like(cut.cutoff, -float("inf")) if case == "all-inactive" else cut.cutoff
    totals = remainder_units(states, costs, cutoff, pg, fc)
    if case.startswith("budget"):
        units = int(totals.max()) - (case == "budget-one-unit-short")
        fc, pg = setup(units * G)
        assert fc.rem_units == units
    if fat:  # the hub's remainder lanes outnumber one block's lanes
        assert g.max_em_out_degree - fc.block_width > -(-fc.num_candidates // 8)
    args = (states, costs, cutoff, cut.adaptive_beam, _scores(card)[0], pg, fc)
    ref = expand_filter_plain(*args, with_src_slot=with_src_slot)
    got = expand_filter(*args, with_src_slot=with_src_slot)
    torch.cuda.synchronize()
    _same_expansion(ref, got)
    assert torch.equal(got.overflow, totals > fc.rem_units)
    assert bool(got.overflow.any()) == (case == "budget-one-unit-short")


def _sweep_inputs(card, frontier_size, rem, **kw):
    dec = _decoder(card, 4096, frontier_size, **kw)
    st0, _, _, _ = dec._init(len(rem))
    rem = torch.tensor(rem, dtype=torch.int32, device=card)
    S = dec._dev_graph.num_states
    _, o = lattice_chunk(dec._pg, _scores(card, len(rem)), rem, st0, dec.cfg, S)
    return [o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem,
            sweep_config(dec.cfg, T), S]


def _same_sweep(ref, got):
    assert got.tok_rows.shape == ref.tok_rows.shape
    assert torch.equal(ref.tok_count, got.tok_count)
    assert torch.equal(ref.em_count, got.em_count)
    assert torch.equal(ref.overflow, got.overflow)
    for b in range(ref.tok_count.shape[0]):
        n, m = int(ref.tok_count[b]), int(ref.em_count[b])
        assert torch.equal(ref.tok_rows[b, :n], got.tok_rows[b, :n])
        assert torch.equal(ref.em_rows[b, :m], got.em_rows[b, :m])


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    "rem-0-and-past-chunk", "caps-equal-counts", "caps-one-below-counts",
    "blocks-without-slots", "frontier-size-10",
])
def test_sweep_kernel_edge_cases(card, case):
    """K4 against plain: an utterance with every frame frozen beside one
    running past the chunk; caps equal to the survivor counts and one
    below; a frontier of 12 slots, so that most blocks of a cluster own no
    slot (slots go to blocks in fours); a frontier of 10, which the
    wrapper pads to 12 for the kernel's 16-byte copies."""
    import dataclasses

    rem = [0, 40, 13] if case == "rem-0-and-past-chunk" else [40, 9, 13]
    K = {"blocks-without-slots": 12, "frontier-size-10": 10}.get(case, 64)
    args = _sweep_inputs(card, K, rem)
    assert args[0].shape[2] == K
    if case.startswith("caps"):
        full = sweep_plain(*args)
        less = case == "caps-one-below-counts"
        args[5] = dataclasses.replace(
            args[5], tok_cap=int(full.tok_count.max()) - less,
            em_cap=int(full.em_count.max()) - less)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    _same_sweep(ref, got)
    assert bool(got.overflow.any()) == (case == "caps-one-below-counts")
    if case == "rem-0-and-past-chunk":
        assert int(got.tok_count[0]) == int(got.em_count[0]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("with_src_slot", [False, True])
@pytest.mark.parametrize("rem_budget,flat_group", [(49152, 4), (131072, 4), (32768, 1)])
def test_expand_kernel_large_frontier(card, rem_budget, flat_group, with_src_slot):
    """K1 against plain at a frontier of 8192 slots, all expanded (max_active
    8192, block width 8): 65,536 block lanes plus the remainder's, so that
    a block's lane costs outgrow its shared-memory cache at the larger
    budget, and, with one arc per unit, a block's remainder lanes span
    several tiles of owners."""
    g = _graph(S=9000, E=90000)
    fc = config_for_graph(g, frontier_size=8192, max_active=8192, beam=10.0,
                          block_width=8, rem_budget=rem_budget, flat_group=flat_group)
    assert (fc.expand_lanes, fc.block_width) == (8192, 8)
    pg = pack_graph_device(g, fc.block_width, fc.eps_block_width, fc.flat_group, card)
    states, costs = _frontier(card, g.num_states, B, 8192)
    cut = get_cutoff(costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    args = (states, costs, cut.cutoff, cut.adaptive_beam, _scores(card)[0], pg, fc)
    ref = expand_filter_plain(*args, with_src_slot=with_src_slot)
    got = expand_filter(*args, with_src_slot=with_src_slot)
    torch.cuda.synchronize()
    _same_expansion(ref, got)
    assert int(remainder_units(*args[:3], pg, fc).max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [4, 2, 1])
def test_expand_kernel_cluster_sizes(card, clusters):
    """K1 against plain at a batch for which the cluster picker gives
    clusters of 4, 2 and 1 blocks (all B clusters must run at once)."""
    g = _graph()
    fc = config_for_graph(g, frontier_size=64, max_active=48, beam=10.0, rem_budget=4096)
    pg = pack_graph_device(g, fc.block_width, fc.eps_block_width, fc.flat_group, card)
    shape = (fc.expand_lanes, fc.block_width, fc.flat_group, fc.rem_units)
    nb = _batch_for_cluster(lambda n: kernels().kd_expand_cluster(n, *shape), clusters)
    states, costs = _frontier(card, g.num_states, nb, 64)
    cut = get_cutoff(costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    args = (states, costs, cut.cutoff, cut.adaptive_beam, _scores(card, nb)[0], pg, fc)
    for with_src_slot in (False, True):
        ref = expand_filter_plain(*args, with_src_slot=with_src_slot)
        got = expand_filter(*args, with_src_slot=with_src_slot)
        torch.cuda.synchronize()
        _same_expansion(ref, got)
    assert kernels().kd_expand_cluster(nb, *shape) == clusters


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [4, 2, 1])
def test_sweep_kernel_cluster_sizes(card, clusters):
    """K4 against plain at a batch for which the cluster picker gives
    clusters of 4, 2 and 1 blocks."""
    K, R = 64, 512
    nb = _batch_for_cluster(lambda n: kernels().kd_sweep_cluster(n, K, R), clusters)
    rem = [(7 * b) % 30 for b in range(nb)]
    args = _sweep_inputs(card, K, rem)
    assert tuple(args[2].shape[2:]) == (R, 4)
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    _same_sweep(ref, got)
    assert kernels().kd_sweep_cluster(nb, K, R) == clusters


@pytest.mark.cuda
@pytest.mark.parametrize("K,R", [(4096, 16384), (32768, 8192)])
def test_sweep_kernel_past_shared_memory(card, K, R):
    """K4 against plain where a block's ranges outgrow its shared memory:
    at K 4096 and R 16384 (clusters of 8) part of each block's records are
    read from device memory; at K 32768 part of its slots and all of its
    records."""
    g = _graph(S=K + 1000, E=6 * K)
    args = _sweep_inputs(card, K, [40, 9, 13], g=g, max_active=2**31 - 1, em_records=R)
    assert args[0].shape[2] == K and args[2].shape[2] == R
    assert kernels().kd_sweep_cluster(B, K, R) == 8
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    _same_sweep(ref, got)
    assert int(ref.em_count.min()) > 0


def _dedup_inputs(seed, N, K, S, n_valid, incumbents, nb=B, costs_of="grid"):
    """(nb, N) lanes with a -0.0 cost, garbage states on invalid lanes and,
    with ``incumbents``, a sorted frontier in the first K lanes.  Costs:
    "grid" quantised to 0.25 (ties), "uniform" in [0, 15), "equal" all
    3.5, "ulps" 500 neighbouring floats above 1.0 and one of 1e30, "front"
    uniform on lanes in the first eighth only (K1 writes the active slots'
    lanes first), "two" 1.0 (three in ten) or 2.0, "spike" 1.0 on 1000
    lanes of distinct states and uniform in [2, 15) elsewhere (a bucket of
    1000 keys below the K-th)."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, S, (nb, N)).astype(np.int32)
    costs = np.full((nb, N), np.inf, np.float32)
    lo = K if incumbents else 0
    span = (N - lo) // 8 if costs_of == "front" else N - lo
    for b in range(nb):
        lanes = lo + rng.choice(span, size=min(n_valid, span), replace=False)
        if costs_of == "grid":
            costs[b, lanes] = rng.integers(0, 40, len(lanes)) * 0.25
        elif costs_of in ("uniform", "front"):
            costs[b, lanes] = rng.uniform(0, 15, len(lanes))
        elif costs_of == "equal":
            costs[b, lanes] = 3.5
        elif costs_of == "two":
            costs[b, lanes] = np.where(rng.random(len(lanes)) < 0.3, 1.0, 2.0)
        elif costs_of == "spike":
            costs[b, lanes] = rng.uniform(2, 15, len(lanes))
            costs[b, lanes[:1000]] = 1.0
            states[b, lanes[:1000]] = rng.choice(S, size=1000, replace=False)
        else:
            one = np.float32(1.0).view(np.int32)
            costs[b, lanes] = (one + rng.integers(0, 500, len(lanes))).astype(np.int32).view(
                np.float32)
            costs[b, lanes[1]] = 1e30
        if costs_of != "equal":
            costs[b, lanes[0]] = -0.0
    states[~np.isfinite(costs)] = rng.integers(-5, 10 * S, int((~np.isfinite(costs)).sum()))
    if incumbents:
        for b in range(nb):
            n = K // 2 + b
            st = rng.choice(S, size=n, replace=False)
            co = np.sort(rng.integers(0, 20, n) * 0.25).astype(np.float32)
            order = np.lexsort((st, co))
            states[b, :K], costs[b, :K] = 0, np.inf
            states[b, :n], costs[b, :n] = st[order], co[order]
    return states, costs


def _k6_clusters(N):
    """The cluster size K6 picks for N lanes when occupancy does not bind:
    the most blocks, up to 8, that leave every block 1024 lanes."""
    c = 1
    while c < 8 and 2 * c * 1024 <= N:
        c *= 2
    return c


def _same_dedup(card, states, costs, K, S):
    """K6 twice against its plain version, bitwise (costs by raw bits, so
    a -0.0 stays -0.0): the second call checks that the first left the
    kept winner table and cost ranges as it found them."""
    st, co = torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card)
    ref = dedup_select_plain(st, co, K, S)
    before = dedup_select.launches
    for _ in range(2):
        got = dedup_select(st, co, K, S)
        torch.cuda.synchronize()
        assert torch.equal(ref.states, got.states)
        assert torch.equal(ref.costs.view(torch.int32), got.costs.view(torch.int32))
        assert torch.equal(ref.cand_idx, got.cand_idx)
        assert torch.equal(ref.num_unique, got.num_unique)
    assert dedup_select.launches == before + 2
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,S,n_valid,incumbents", [
    (3000, 64, 500, 2500, False),  # more states than K: a select
    (3000, 64, 500, 40, False),  # fewer states than K
    (3000, 64, 500, 2500, True),  # incumbents first (an eps iteration)
    (20, 64, 500, 15, False),  # fewer lanes than K
    (5000, 4096, 100, 4000, False),  # fewer states than lanes, K > S
    (60000, 4096, 102298, 50000, False),  # the bench's emitting shape
])
def test_dedup_kernel_matches_plain(card, N, K, S, n_valid, incumbents):
    states, costs = _dedup_inputs(N + K, N, K, S, n_valid, incumbents)
    _same_dedup(card, states, costs, K, S)
    assert dedup_cluster_size(B, N) == _k6_clusters(N)


@pytest.mark.cuda
@pytest.mark.parametrize("case,nb,N,K,S,n_valid,incumbents,costs_of", [
    # Every finite cost equal: one cost bucket holds every key.
    ("all-costs-equal", 3, 60000, 4096, 102298, 50000, False, "equal"),
    # Costs on a 0.25 grid with a -0.0 lane: buckets of ~1000 keys, the
    # boundary one ranked whole by the stage's sort.
    ("grid-and-negative-zero", 3, 60000, 4096, 102298, 50000, False, "grid"),
    # Costs a few ulps apart under one far outlier: the boundary bucket
    # is refined twice (by cost ulps, then by state).
    ("refined-twice", 3, 60000, 4096, 102298, 50000, False, "ulps"),
    # Two costs: a kept bucket of ~21,000 keys, more than a block can
    # stage, so its places are ranked from device memory; the K-th key's
    # bucket is refined by state.
    ("two-costs", 3, 131072, 32768, 102298, 120000, False, "two"),
    # Past the one-block design's limit of 16,384.
    ("K-32768", 3, 131072, 32768, 102298, 120000, False, "uniform"),
    # The streaming decoder's emitting shape.
    ("streaming-B1", 1, 18432, 2048, 102298, 15000, False, "uniform"),
    # Fewer winners than K, and fewer lanes than K.
    ("n-below-K", 3, 6000, 4096, 102298, 3000, False, "uniform"),
    ("N-below-K", 3, 2000, 4096, 102298, 1800, False, "uniform"),
    # Every finite lane in the first eighth, which the lane split must
    # spread over the cluster's blocks.
    ("front-loaded", 3, 60000, 4096, 102298, 7000, False, "front"),
    # Incumbents first, at the batched eps iteration's shape.
    ("incumbents-first", 3, 10240, 4096, 102298, 5000, True, "uniform"),
    # A bucket of 1000 keys below the K-th: its owner's radix sort.
    ("crowded-bucket", 3, 60000, 4096, 102298, 50000, False, "spike"),
])
def test_dedup_kernel_edge_cases(card, case, nb, N, K, S, n_valid, incumbents, costs_of):
    """K6 against plain where the select core's buckets, levels and sizes
    could go wrong, each called twice in a row."""
    states, costs = _dedup_inputs(N + K + nb, N, K, S, n_valid, incumbents, nb, costs_of)
    ref = _same_dedup(card, states, costs, K, S)
    n = ref.num_unique.cpu()
    assert bool((n < K).all()) == (case in ("n-below-K", "N-below-K"))
    assert dedup_cluster_size(nb, N) == _k6_clusters(N)


@pytest.mark.cuda
@pytest.mark.parametrize("case,K,n_valid,clusters", [
    *(pytest.param("uniform", 256, 3000, c, id=str(c)) for c in (4, 2, 1)),
    # test_dedup_kernel_edge_cases' crowded-bucket at each cluster size.
    *(pytest.param("spike", 4096, 30000, c, id=f"crowded-bucket-{c}") for c in (8, 4, 2, 1)),
])
def test_dedup_kernel_cluster_sizes(card, case, K, n_valid, clusters):
    """K6 against plain at a batch for which the cluster picker gives
    clusters of 8, 4, 2 and 1 blocks (all B clusters must run at once)
    where the lanes would allow 8."""
    N = 40000
    nb = _batch_for_cluster(lambda n: dedup_cluster_size(n, N), clusters)
    states, costs = _dedup_inputs(nb, N, K, 20000, n_valid, False, nb, case)
    _same_dedup(card, states, costs, K, 20000)
    assert _k6_clusters(N) == 8 and dedup_cluster_size(nb, N) == clusters


LATTICE_BEAM = 8.0 + 1e-4  # the lattice path's slack beam at lattice beam 8


def _rec_inputs(seed, nb, N, S, n_valid, costs_of):
    """(nb, N) lanes for K2: those of :func:`_dedup_inputs` (no
    incumbents), or "motivation": groups of four lanes of one state in
    random lane order, a leader of -1000 or -999.5 and three extras of
    cost 1.0, nextafter(1.0, 2.0) and 1.0 + 2 ulps, whose slacks round to
    one float (equal slack, equal state, distinct costs); or "empty-and-
    equal": row 0 uniform, row 1 without a finite lane, row 2 every cost
    equal."""
    if costs_of == "motivation":
        rng = np.random.default_rng(seed)
        G = n_valid // 4
        states = rng.integers(-5, 10 * S, (nb, N)).astype(np.int32)
        costs = np.full((nb, N), np.inf, np.float32)
        one = np.float32(1.0).view(np.int32)
        extra = np.array([one, one + 1, one + 2], np.int32).view(np.float32)
        for b in range(nb):
            lanes = rng.permutation(N)[: 4 * G].reshape(G, 4)
            st = rng.choice(S, size=G, replace=False)
            states[b, lanes] = st[:, None]
            costs[b, lanes[:, 0]] = -1000.0 + 0.5 * rng.integers(0, 2, G)
            costs[b, lanes[:, 1:]] = rng.permuted(np.tile(extra, (G, 1)), axis=1)
        return states, costs
    if costs_of == "crowded":
        # One slack value over a run of neighbouring states with a few far
        # away (the LM's word-start arcs): the record digit cannot split
        # it, and the blocks that share its bucket sort their stage.
        rng = np.random.default_rng(seed)
        states = rng.integers(-5, 10 * S, (nb, N)).astype(np.int32)
        costs = np.full((nb, N), np.inf, np.float32)
        G = n_valid // 2
        for b in range(nb):
            lanes = rng.permutation(N)[: 2 * G].reshape(G, 2)
            st = np.arange(G) + 4
            st[rng.choice(G, size=8, replace=False)] = S - 1 - np.arange(8)
            states[b, lanes] = st[:, None]
            costs[b, lanes[:, 0]] = rng.uniform(0, 4, G).astype(np.float32)
            costs[b, lanes[:, 1]] = costs[b, lanes[:, 0]] + np.float32(2.5)
        return states, costs
    if costs_of == "crowded-ties":
        # A quarter of n_valid states (4 up, a few near S-1), each with a
        # leader and three extras of one slack, 5.0, and distinct costs:
        # leader -4.0 and extras 1.0, 1.0 + 2^-23, 1.0 + 2^-22, or leader
        # -5.0 and extras -0.0, +0.0 (equal costs: lane order), 2^-30.
        # Crowded buckets of runs of three equal keys.
        rng = np.random.default_rng(seed)
        states = rng.integers(-5, 10 * S, (nb, N)).astype(np.int32)
        costs = np.full((nb, N), np.inf, np.float32)
        G = n_valid // 4
        one = np.float32(1.0).view(np.int32)
        a = np.array([-4.0, *np.array([one, one + 1, one + 2], np.int32).view(np.float32)],
                     np.float32)
        z = np.array([-5.0, -0.0, 0.0, 2.0 ** -30], np.float32)
        for b in range(nb):
            lanes = rng.permutation(N)[: 4 * G].reshape(G, 4)
            st = np.arange(G) + 4
            st[rng.choice(G, size=8, replace=False)] = S - 1 - np.arange(8)
            states[b, lanes] = st[:, None]
            costs[b, lanes] = np.where(rng.random(G)[:, None] < 0.5, a, z)
        return states, costs
    if costs_of in ("crowded-exact", "crowded-huge"):
        # A third of n_valid states (4 up, a few near S-1), each with a
        # leader on a 1/8 grid ("huge": all 0.0, so every state ties c_K)
        # and two extras of its cost + 2.5 (slack 2.5 exactly, equal costs:
        # lane order), and 16 of them a third extra of slack
        # nextafter(2.5, 3): the record digit's bin spans two slacks, so
        # every extra of slack 2.5 lands in one bucket.
        rng = np.random.default_rng(seed)
        states = rng.integers(-5, 10 * S, (nb, N)).astype(np.int32)
        costs = np.full((nb, N), np.inf, np.float32)
        G = n_valid // 3
        for b in range(nb):
            lanes = rng.permutation(N)[: 3 * G + 16]
            st = np.arange(G) + 4
            st[rng.choice(G, size=8, replace=False)] = S - 1 - np.arange(8)
            lead = (rng.integers(0, 32, G) / 8 * (costs_of == "crowded-exact")).astype(np.float32)
            lead[:16] = 0.0  # lead + nextafter(2.5, 3) is exact
            states[b, lanes[: 3 * G]] = np.repeat(st, 3)
            costs[b, lanes[: 3 * G]] = (lead[:, None] + np.float32([0.0, 2.5, 2.5])).ravel()
            states[b, lanes[3 * G:]] = st[:16]
            costs[b, lanes[3 * G:]] = lead[:16] + np.nextafter(np.float32(2.5), np.float32(3))
        return states, costs
    if costs_of == "empty-and-equal":
        states, costs = _dedup_inputs(seed, N, 0, S, n_valid, False, nb, "uniform")
        costs[1] = np.inf
        costs[2][np.isfinite(costs[2])] = 3.5
        return states, costs
    return _dedup_inputs(seed, N, 0, S, n_valid, False, nb, costs_of)


def _same_rec(card, states, costs, K, S, R, beam=LATTICE_BEAM, calls=2):
    """K2 ``calls`` times against its plain version, every field by raw
    bits (a -0.0 stays -0.0): a later call checks that the one before left
    the shared winner table as it found it.  Returns the plain result."""
    nb, N = costs.shape
    rng = np.random.default_rng(N + K + R)
    pay = tuple(torch.from_numpy(x).to(card) for x in (
        rng.integers(0, S, (nb, N)).astype(np.int32),
        np.tile(np.arange(N, dtype=np.int32), (nb, 1))))
    st, co = torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card)
    ref = dedup_select_rec_plain(st, co, K, S, R, beam, pay)
    want = stack_records(ref)
    before = dedup_select_rec.launches
    for _ in range(calls):
        got = dedup_select_rec(st, co, K, S, R, beam, pay)
        torch.cuda.synchronize()
        assert torch.equal(ref.states, got.states)
        assert torch.equal(ref.costs.view(torch.int32), got.costs.view(torch.int32))
        assert torch.equal(ref.num_unique, got.num_unique)
        for col, name in enumerate(("src_state", "arc_id", "rec_dst", "rec_slack")):
            assert torch.equal(want[..., col], got.records[..., col]), name
        assert torch.equal(ref.rec_overflow, got.rec_overflow)
    assert dedup_select_rec.launches == before + calls
    return ref


# Crowded buckets of the record select (case: nb, N, K, S, R, n_valid,
# costs_of): runs of equal keys with distinct costs and -0.0; 10,000
# extras of one slack, so the boundary bucket exceeds half the 8192-key
# stage (R 12000) or a kept bucket exceeds the stage (R 16384, sorted in
# device memory); the recall point's capacities.
CROWDED = {
    "crowded-ties": ("crowded-ties", 3, 60000, 4096, 102298, 8192, 6000, "crowded-ties"),
    "crowded-past-stage": ("crowded-past-stage", 3, 60000, 8192, 102298, 12000, 15000,
                           "crowded-exact"),
    "crowded-kept-past-stage": ("crowded-kept-past-stage", 3, 60000, 8192, 102298, 16384,
                                15000, "crowded-exact"),
    "crowded-recall": ("crowded-recall", 2, 131072, 8192, 102298, 16384, 24000,
                       "crowded-exact"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,nb,N,K,S,R,n_valid,costs_of", [
    # The bench's shape: R > K, R <= K, and a budget past the lanes (padding).
    ("bench-r-above-k", 3, 60000, 4096, 102298, 8192, 50000, "uniform"),
    ("bench-r-below-k", 3, 60000, 4096, 102298, 2048, 50000, "uniform"),
    ("r-above-n", 3, 3000, 64, 500, 4096, 2500, "uniform"),
    # Quantised costs with a -0.0 lane: equal (state, cost) pairs, equal
    # slacks, and states tied with the K-th cost that top-K drops but that
    # keep their records (the boundary quirk).
    ("quantised", 3, 60000, 4096, 102298, 8192, 50000, "grid"),
    ("quantised-few-states", 3, 20000, 256, 2000, 8192, 15000, "grid"),
    # Equal slack and state, distinct costs, at scale (and overflow).
    ("equal-slack", 3, 60000, 4096, 102298, 8192, 48000, "motivation"),
    # More eligible links than R.
    ("overflow", 3, 60000, 4096, 102298, 4200, 50000, "ulps"),
    # A row with no finite lane and a row with every cost equal.
    ("empty-and-equal", 3, 60000, 4096, 102298, 8192, 50000, "empty-and-equal"),
    # Finite lanes in the first eighth only (K1's layout).
    ("front-loaded", 3, 60000, 4096, 102298, 8192, 7000, "front"),
    # The recall point's capacities.
    ("recall-point", 2, 131072, 8192, 102298, 16384, 120000, "uniform"),
    # Thousands of extras of one slack over crowded states: the record
    # select's sort, with and without overflow.
    ("crowded", 3, 60000, 4096, 102298, 8192, 12000, "crowded"),
    ("crowded-overflow", 3, 60000, 2048, 102298, 3000, 12000, "crowded"),
    *(pytest.param(*CROWDED[c], id=c) for c in CROWDED),
    # 70,000 extras of one slack kept whole: a bucket sorted in device
    # memory past one tile of the sort (16 warps of 4064 keys).
    ("crowded-huge", 2, 131072, 4096, 102298, 131072, 105000, "crowded-huge"),
])
def test_dedup_rec_kernel_matches_plain(card, case, nb, N, K, S, R, n_valid, costs_of):
    """K2 against plain, bitwise, each called twice."""
    states, costs = _rec_inputs(N + K + R, nb, N, S, n_valid, costs_of)
    beam = 3000.0 if costs_of == "motivation" else LATTICE_BEAM
    ref = _same_rec(card, states, costs, K, S, R, beam)
    assert rec_cluster_size(nb, N) == _k6_clusters(N)
    if case == "quantised":  # the boundary quirk: a record into a state not kept
        kept = set(ref.states[0].tolist())
        assert any(d >= 0 and d not in kept for d in ref.rec_dst[0].tolist())
    if case in ("overflow", "equal-slack", "crowded-overflow", "crowded-past-stage",
                "crowded-recall"):
        assert bool(ref.rec_overflow.all())
    if case == "crowded-kept-past-stage":
        assert not bool(ref.rec_overflow.any())
    if case == "empty-and-equal":
        assert int(ref.num_unique[1]) == 0 and not bool(ref.rec_overflow[1])
    if case == "r-above-n":
        assert bool((ref.rec_dst[:, N:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case,clusters", [
    *(pytest.param("grid", c, id=str(c)) for c in (8, 4, 2, 1)),
    *(pytest.param(k, c, id=f"{k}-{c}") for k in CROWDED for c in (8, 4, 2, 1)),
])
def test_dedup_rec_kernel_cluster_sizes(card, case, clusters):
    """K2 against plain at a batch for which the cluster picker gives
    clusters of 8, 4, 2 and 1 blocks where the lanes would allow 8: grid
    costs, and each crowded case of test_dedup_rec_kernel_matches_plain."""
    if case == "grid":
        _, N, K, S, R, n_valid, costs_of = None, 40000, 256, 20000, 1024, 3000, "grid"
    else:
        _, _, N, K, S, R, n_valid, costs_of = CROWDED[case]
    nb = _batch_for_cluster(lambda n: rec_cluster_size(n, N), clusters)
    states, costs = _rec_inputs(nb, nb, N, S, n_valid, costs_of)
    _same_rec(card, states, costs, K, S, R)
    assert _k6_clusters(N) == 8 and rec_cluster_size(nb, N) == clusters


@pytest.mark.cuda
def test_dedup_rec_and_dedup_share_the_table(card):
    """K6 and K2 in turn on one stream share the kept winner table: each
    must find it all ones, at two sizes."""
    for nb, S in ((3, 102298), (5, 20000), (3, 102298)):
        states, costs = _rec_inputs(nb + S, nb, 20000, S, 15000, "grid")
        _same_dedup(card, states, costs, 1024, S)
        _same_rec(card, states, costs, 1024, S, 4096, calls=1)
        _same_dedup(card, states, costs, 1024, S)


# ---------------------------------------------------------------------------
# K2's eps call and K4 with eps records
# ---------------------------------------------------------------------------


def _eps_graph(depth, seed=0, S=400, E=3000, E_eps=300):
    """:func:`_graph` with eps arcs: with ``depth`` D, from each layer of
    the states to the next of D + 1 layers (an eps graph of depth D);
    with ``depth=None``, a ring through the states 0, 1, ... (cyclic)."""
    g = _graph(seed, S, E)
    rng = np.random.default_rng(seed + 1)
    if depth is None:
        src = np.arange(S, dtype=np.int64)
        nxt = (src + 1) % S
    else:
        layer = rng.integers(0, depth + 1, S)
        src = rng.choice(np.flatnonzero(layer < depth), E_eps)
        nxt = np.array([rng.choice(np.flatnonzero(layer == layer[s] + 1)) for s in src])
    order = np.argsort(src, kind="stable")
    src, nxt = src[order], nxt[order].astype(np.int32)
    row = np.zeros(S + 1, np.int32)
    row[1:] = np.cumsum(np.bincount(src, minlength=S))
    ga = g.arrays._replace(
        eps_row_ptr=row, eps_olabel=rng.integers(0, 50, len(src)).astype(np.int32),
        eps_weight=rng.uniform(0, 2, len(src)).astype(np.float32), eps_next=nxt)
    d = _eps_depth(S, row, nxt)
    assert d == depth
    return CsrGraph(ga, S, g.num_emitting_arcs, len(src), 0, d, g.max_em_out_degree,
                    int(np.diff(row).max()), g.max_score_idx)


def _eps_sweep_inputs(card, depth, rem, frontier_size=64, eps_records=None):
    """A real chunk of the lattice decode on :func:`_eps_graph` (fold=False):
    the sweep's arguments, eps records last."""
    g = _eps_graph(depth)
    fc = config_for_graph(g, frontier_size=frontier_size, max_active=48, beam=10.0,
                          rem_budget=4096)
    dec = BatchedLatticeDecoder(g, fc, lattice_beam=5.0, em_records=512,
                                eps_records=eps_records, pad_time_to=8, fold=False,
                                device=card)
    assert dec.cfg.frontier.eps_iters == (depth or 16)
    st0, _, _, _ = dec._init(len(rem))
    rem = torch.tensor(rem, dtype=torch.int32, device=card)
    S = g.num_states
    _, o = lattice_chunk(dec._pg, _scores(card, len(rem)), rem, st0, dec.cfg, S)
    return [o.frontier_states, o.frontier_costs, o.em_records, st0.states, rem,
            sweep_config(dec.cfg, T), S, o.eps_records]


def _same_eps_sweep(ref, got):
    _same_sweep(ref, got)
    assert torch.equal(ref.eps_count, got.eps_count)
    for b in range(ref.eps_count.shape[0]):
        n = int(ref.eps_count[b])
        assert torch.equal(ref.eps_rows[b, :n], got.eps_rows[b, :n])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["D1", "D3", "D3-small-caps", "cyclic", "empty-eps"])
def test_sweep_eps_kernel_matches_plain(card, case):
    """K4's eps instance against plain on real chunks of an eps graph of
    depth 1 and 3 (and the cyclic ring, eps_exact False), an utterance
    ending inside the chunk and one past it; with caps small enough that
    the eps rows overflow; and with every eps record padding."""
    import dataclasses

    depth = {"D1": 1, "cyclic": None}.get(case, 3)
    args = _eps_sweep_inputs(card, depth, [40, 9, 13])
    if case == "D3-small-caps":
        args[5] = dataclasses.replace(args[5], eps_cap=5)
    if case == "empty-eps":
        args[7] = torch.full_like(args[7], -1)
    assert args[5].eps_exact == (depth is not None)
    ref = sweep_plain(*args)
    before = sweep_chunk.launches
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    assert sweep_chunk.launches == before + 1
    _same_eps_sweep(ref, got)
    assert bool(got.overflow.any()) == (case == "D3-small-caps")
    assert (int(got.eps_count.sum()) == 0) == (case == "empty-eps")


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("K", [64, 32768])  # 32768: the shared-memory spill instance
def test_sweep_eps_kernel_bellman_bound(card, exact, K):
    """Records of a two-state eps cycle with slack -1 lower the extras by 1
    a pass, so the Bellman is still changing at its bound (D + 2, or
    min(K, D * Re) + 2 with eps_exact False) on every frame that holds
    them: kernel and plain agree on the rows and set the overflow flag.
    At K 32768 part of each block's slots are read from device memory."""
    rng = np.random.default_rng(3)
    Tn, nb, R, D, Re, S = 6, 2, 16, 2, 4, max(2 * K, 20)
    fs = np.stack([np.stack([rng.choice(S, K, replace=False) for _ in range(nb)])
                   for _ in range(Tn)]).astype(np.int32)
    fc = np.sort(rng.uniform(0, 3, (Tn, nb, K)), axis=-1).astype(np.float32)
    fc[:, :, -2:] = np.inf
    em = np.full((Tn, nb, R, 4), -1, np.int32)
    em[..., 0] = rng.integers(0, S, (Tn, nb, R))
    em[..., 1] = rng.integers(0, 100, (Tn, nb, R))
    for t in range(1, Tn):
        em[t, :, :8, 0] = fs[t - 1, :, :8]
    em[..., 2] = fs[:, :, rng.integers(0, K, R)]
    em[..., 3] = rng.uniform(10, 20, (Tn, nb, R)).astype(np.float32).view(np.int32)
    eps = np.full((Tn, nb, D, Re, 4), -1, np.int32)
    neg = np.float32(-1.0).view(np.int32)
    for t in range(Tn):
        for b in range(nb):
            a, c = fs[t, b, 0], fs[t, b, 1]
            eps[t, b, 0, 0] = (a, 7, c, neg)
            eps[t, b, 0, 1] = (c, 8, a, neg)
            eps[t, b, 1, 0] = (fs[t, b, 2], 9, a, np.float32(0.5).view(np.int32))
    init = rng.choice(S, (nb, K)).astype(np.int32)
    sc = SweepConfig(frontier_size=K, em_records=R, chunk_frames=Tn, lattice_beam=60.0,
                     tok_cap=200 + K, em_cap=200, eps_records=Re, eps_iters=D,
                     eps_exact=exact, eps_cap=100)
    args = [torch.from_numpy(x).to(card) for x in (fs, fc, em, init)]
    args += [torch.tensor([Tn, 3], dtype=torch.int32, device=card), sc, S,
             torch.from_numpy(eps).to(card)]
    ref = sweep_plain(*args)
    got = sweep_chunk(*args)
    torch.cuda.synchronize()
    _same_eps_sweep(ref, got)
    assert bool(got.overflow.all())


def _same_rec_eps(card, states, costs, K, S, R, beam=LATTICE_BEAM, calls=2):
    """K2's eps call (the first K lanes incumbents, payload -1 there)
    ``calls`` times against its plain version, every field by raw bits,
    ``cand_idx`` included.  Returns the plain result."""
    nb, N = costs.shape
    rng = np.random.default_rng(N + K + R)
    src = rng.integers(0, S, (nb, N)).astype(np.int32)
    arc = np.tile(np.arange(N, dtype=np.int32), (nb, 1))
    src[:, :K] = arc[:, :K] = -1
    pay = (torch.from_numpy(src).to(card), torch.from_numpy(arc).to(card))
    st, co = torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card)
    ref = dedup_select_rec_plain(st, co, K, S, R, beam, pay, num_incumbents=K)
    want = stack_records(ref)
    before = dedup_select_rec.launches
    for _ in range(calls):
        got = dedup_select_rec(st, co, K, S, R, beam, pay, num_incumbents=K)
        torch.cuda.synchronize()
        assert torch.equal(ref.states, got.states)
        assert torch.equal(ref.costs.view(torch.int32), got.costs.view(torch.int32))
        assert torch.equal(ref.num_unique, got.num_unique)
        assert torch.equal(ref.cand_idx, got.cand_idx)
        assert torch.equal(want, got.records)
        assert torch.equal(ref.rec_overflow, got.rec_overflow)
    assert dedup_select_rec.launches == before + calls
    return ref


def _eps_call_inputs(seed, nb, N, K, S, n_valid, case):
    """(nb, N) lanes of an eps iteration: a sorted frontier of incumbents
    in the first K lanes, then eps lanes (grid costs with a -0.0).  "ties":
    the first eps lanes on the incumbents' states at their costs; "no-eps-
    winner": every eps lane on a live incumbent's state and dearer;
    "all-incumbents": a full frontier of K incumbents cheaper than every
    eps lane."""
    states, costs = _dedup_inputs(seed, N, K, S, n_valid, True, nb, "grid")
    rng = np.random.default_rng(seed + 1)
    for b in range(nb):
        live = int(np.isfinite(costs[b, :K]).sum())
        if case == "ties":
            states[b, K:K + 8], costs[b, K:K + 8] = states[b, :8], costs[b, :8]
        elif case == "no-eps-winner":
            fin = np.isfinite(costs[b, K:])
            states[b, K:][fin] = states[b, rng.integers(0, live, int(fin.sum()))]
            costs[b, K:][fin] += 100.0
        elif case == "all-incumbents":
            states[b, :K] = rng.choice(S, K, replace=False)
            costs[b, :K] = np.sort(rng.integers(0, 8, K) * 0.25)
            costs[b, K:][np.isfinite(costs[b, K:])] += 10.0
    return states, costs


@pytest.mark.cuda
@pytest.mark.parametrize("case,nb,N,K,S,R,n_valid", [
    # The bench's eps call: K 4096, N = 2K + 2048, R = K + 2048.
    ("bench", 16, 10240, 4096, 102298, 6144, 5000),
    ("ties", 3, 10240, 4096, 102298, 6144, 5000),
    ("no-eps-winner", 3, 10240, 4096, 102298, 6144, 5000),
    ("all-incumbents", 3, 10240, 4096, 102298, 6144, 5000),
    # More eligible links than r_eps = 8: the caller's spill row is valid.
    ("spill", 3, 10240, 4096, 102298, 4104, 5000),
    # The winners-only budget (R <= K): incumbent winners are padding.
    ("winners-only", 3, 10240, 4096, 102298, 2048, 5000),
    # More eligible links than R: rec_overflow.
    ("small-overflow", 3, 3000, 64, 500, 96, 2500),
])
def test_dedup_rec_eps_kernel_matches_plain(card, case, nb, N, K, S, R, n_valid):
    """K2's eps call against plain, bitwise, each called twice."""
    states, costs = _eps_call_inputs(N + K + R, nb, N, K, S, n_valid, case)
    ref = _same_rec_eps(card, states, costs, K, S, R)
    won = ref.cand_idx
    if case in ("no-eps-winner", "all-incumbents"):
        assert bool((won < K).all())
    else:
        assert bool((won >= K).any())
    if case == "ties":
        assert not bool(torch.isin(torch.arange(K, K + 8, device=card), won).any())
    if case == "spill":
        assert bool((ref.recs[1][:, R - K] >= 0).all())
    assert bool(ref.rec_overflow.all()) == (case in ("winners-only", "small-overflow"))


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [8, 4, 2, 1])
def test_dedup_rec_eps_kernel_cluster_sizes(card, clusters):
    """K2's eps call at a batch for which the cluster picker gives clusters
    of 8, 4, 2 and 1 blocks."""
    N, K, S, R = 20480, 4096, 102298, 6144
    nb = _batch_for_cluster(lambda n: rec_cluster_size(n, N), clusters)
    states, costs = _eps_call_inputs(nb, nb, N, K, S, 9000, "ties")
    _same_rec_eps(card, states, costs, K, S, R)
    assert rec_cluster_size(nb, N) == clusters



# ---------------------------------------------------------------------------
# K3, the frame tail, and the frame driver's captured graph
# ---------------------------------------------------------------------------

TAIL_CASES = {
    # name: (lattice, B, K, R, D, Re, N, V): the bench's lattice and 1-best
    # frames (B=16, K 4096, R 8192), the unfolded lattice frame, and the
    # streaming decoders' B=1 frames with an eps closure of depth 1.
    "lattice": (True, 16, 4096, 8192, 0, 1024, 0, 500),
    "lattice-eps": (True, 16, 4096, 8192, 1, 2048, 0, 500),
    "viterbi": (False, 16, 4096, 0, 0, 0, 56832, 500),
    "streaming-viterbi": (False, 1, 2048, 0, 1, 0, 18432, 500),
    "streaming-lattice": (True, 1, 2048, 4096, 1, 3328, 0, 500),
    # K < G * 32: some blocks of a row's cluster own no slot (nor record).
    "small-K-lattice": (True, 16, 64, 96, 1, 40, 0, 50),
    "small-K-viterbi": (False, 5, 64, 0, 1, 0, 300, 50),
}
TAIL_CFG = dict(beam=15.0, max_active=2560, min_active=200, beam_delta=0.5)


def _sorted_costs(rng, nb, K, live):
    """(nb, K) cost-sorted rows, row b with ``live[b % len(live)]`` finite
    costs (duplicates and a -0.0 among them), +inf after."""
    costs = np.full((nb, K), np.inf, np.float32)
    for b in range(nb):
        n = min(K, live[b % len(live)])
        c = np.sort(np.round(rng.uniform(-3, 3 + 30 * (b % 3), n), 1)).astype(np.float32)
        if n > 2:
            c[1] = -0.0 if c[1] == 0 else c[1]
        costs[b, :n] = c
    return costs


def _tail_case(card, name, t, seed=0):
    """A chunk of t + 3 frames on the card (scores, lengths ending at t + 1,
    t + 2, t + 3 and t in turn, a start state, empty outputs), slots for
    it, and one frame's tail inputs: random frontiers (a full row, rows of
    3000, 300, 150 and 0 live tokens, duplicates and a -0.0 among them),
    records or backpointer inputs, flags."""
    from kaldi_decoder_tpu_torch.decoders.driver import chunk_outputs
    from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, StepState
    from kaldi_decoder_tpu_torch.decoders.lattice_dev import LatticeDevConfig
    from kaldi_decoder_tpu_torch.kernels.frame import FrameIO, FrameSlots, TailInputs

    lattice, nb, K, R, D, Re, N, Vs = TAIL_CASES[name]
    rng = np.random.default_rng(seed)
    fc = FrontierConfig(frontier_size=K, eps_iters=D, **TAIL_CFG)
    cfg = LatticeDevConfig(fc, em_records=R, eps_records=Re) if lattice else fc
    live = [K, 3000, 300, 150, 0]

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(card)

    def ints(*shape, lo=-1, hi=1 << 20):
        return dev(rng.integers(lo, hi, shape).astype(np.int32))

    def flags():
        return dev(rng.random(nb) < 0.4)

    C = t + 3
    st0 = StepState(ints(nb, K, lo=0), dev(_sorted_costs(rng, nb, K, live[::-1])),
                    dev(rng.uniform(-50, 50, nb).astype(np.float32)))
    lengths = dev(np.array([t + (b + 1) % 4 for b in range(nb)], np.int32))
    io = FrameIO(dev(rng.normal(size=(C, nb, Vs)).astype(np.float32)), lengths, st0,
                 chunk_outputs(lattice, cfg, C, nb, card))
    tin = TailInputs(
        ints(nb, K, lo=0), dev(_sorted_costs(rng, nb, K, live)), flags(),
        dev(rng.choice([K - 5, K, K + 1, 9000], nb).astype(np.int32)),
        flags() if D else None, flags() if D else None,
        rec_overflow=flags() if lattice else None,
        em_records=ints(nb, R, 4) if lattice else None,
        eps_records=ints(nb, D, Re, 4) if lattice else None,
        cand_idx=None if lattice else ints(nb, K, lo=-1, hi=N),
        src_slot=None if lattice else ints(nb, N, lo=0, hi=K),
        arc_id=None if lattice else ints(nb, N),
        bp_eps=None if lattice else ints(nb, D, K, 2),
    )
    return FrameSlots(nb, K, Vs, card), io, tin, fc


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [0, 8, 4, 2, 1])
@pytest.mark.parametrize("name", sorted(TAIL_CASES))
def test_frame_tail_kernel_matches_plain(card, name, clusters):
    """K3's first-frame mode against ``get_cutoff`` and its frame mode
    against ``frame_tail_plain``, bitwise, at the paths' shapes and at each
    cluster size (0: its own choice, more than one block a row at the
    paths' shapes): three frames in a row on the same slots, so that ``t``,
    the base and the cutoff each frame leaves are the next one's; each
    frame the state written in place, row t of every stacked output
    (frozen rows' records -1 and backpointers the identity), the next
    frame's cutoff, adaptive beam, scores row and active rows, t advanced
    and the done count cleared.  At B > 1 every frame has a frozen row
    beside a live one; at B = 1 the row is live, then frozen; from B = 5 a
    row has no finite cost (slot 0 +inf); the chunk's last frame loads no
    scores row."""
    from kaldi_decoder_tpu_torch.decoders.frontier import StepState
    from kaldi_decoder_tpu_torch.kernels.frame import (
        cluster_size,
        frame_start,
        frame_tail,
        frame_tail_plain,
    )

    t = 5
    s, io, tin, fc = _tail_case(card, name, t)
    nb, K = tin.mid_states.shape
    if clusters == 0 and K >= 2048:
        assert cluster_size(nb, K) > 1
    before = frame_start.launches, frame_tail.launches
    frame_start(s, io, fc)
    torch.cuda.synchronize()
    cut = get_cutoff(io.st0.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    for ref, got, what in ((cut.cutoff, s.cutoff, "cutoff"),
                           (cut.adaptive_beam, s.adaptive_beam, "adaptive_beam"),
                           (io.scores[0], s.scores_t, "scores_t"),
                           (io.lengths > 0, s.active, "active")):
        assert torch.equal(ref.view(torch.int32) if ref.dtype == torch.float32 else ref,
                           got.view(torch.int32) if got.dtype == torch.float32 else got), what
    for ref, got in zip(io.st0, s.state):
        assert torch.equal(ref, got)
    assert s.args[:3].tolist() == [0, io.scores.shape[0], 0]
    if nb >= 5:
        assert not bool(torch.isfinite(tin.mid_costs[:, 0]).all())  # a row with slot 0 +inf
    s.args[0] = t
    for frame in range(t, io.scores.shape[0]):
        fa = io.lengths > frame
        if nb > 1:
            assert bool(fa.any()) and not bool(fa.all())  # a frozen row beside a live one
        else:
            assert bool(fa[0]) == (frame == t)
        st = [x.clone() for x in s.state]
        final, out, nxt = frame_tail_plain(StepState(*st), s.cutoff.clone(), tin, fa, fc)
        scores_t = s.scores_t.clone()
        frame_tail(s, tin, fc, clusters=clusters)
        torch.cuda.synchronize()
        for ref, got in zip(final, s.state):
            assert torch.equal(ref.view(torch.int32), got.view(torch.int32)), frame
        for f, ref in zip(out._fields, out):
            got = getattr(io.outs, f)[frame]
            if ref.dtype == torch.float32:
                ref, got = ref.view(torch.int32), got.view(torch.int32)
            assert torch.equal(ref, got), (frame, f)
        assert torch.equal(nxt.cutoff.view(torch.int32), s.cutoff.view(torch.int32)), frame
        assert torch.equal(nxt.adaptive_beam.view(torch.int32),
                           s.adaptive_beam.view(torch.int32)), frame
        want = io.scores[frame + 1] if frame + 1 < io.scores.shape[0] else scores_t
        assert torch.equal(want, s.scores_t), frame
        assert torch.equal(io.lengths > frame + 1, s.active), frame
        assert s.args[0].item() == frame + 1 and s.args[2].item() == 0
    assert (frame_start.launches, frame_tail.launches) == (before[0] + 1, before[1] + 3)


def _chunks(card, nb, lengths_per_decode, C):
    """Scores (C, nb, V) and lengths for each decode, from one seed each."""
    out = []
    for i, lens in enumerate(lengths_per_decode):
        rng = np.random.default_rng(40 + i)
        s = np.log(rng.dirichlet(np.ones(V), size=(C, nb))).astype(np.float32)
        out.append((torch.from_numpy(s).to(card), torch.tensor(lens, dtype=torch.int32,
                                                                 device=card)))
    return out


def _same_outputs(ref, got, what):
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        if r.dtype == torch.float32:
            r, g = r.view(torch.int32), g.view(torch.int32)
        assert torch.equal(r, g), (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lattice", "lattice-eps", "viterbi", "viterbi-eps"])
def test_graph_driver_matches_eager_loop(card, kind):
    """The frame driver's captured graph against the loop it replaced
    (``driver.eager_frames``: the frame steps launched from the host, the
    plain-torch tail), bitwise, over two decodes of other lengths and
    scores on one driver (and a chunk from the first one's final state);
    K1, K2 or K6 launch as often as in that loop, K3 once a frame, its
    first-frame mode once a chunk, and every frame but the frame driver's first
    is a replay."""
    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.decoders.viterbi import BatchedViterbiDecoder, viterbi_chunk
    from kaldi_decoder_tpu_torch.kernels.frame import frame_start, frame_tail

    eps = kind.endswith("eps")
    g = _eps_graph(1) if eps else _graph()
    fc = config_for_graph(g, frontier_size=64, max_active=48, beam=10.0, rem_budget=4096)
    if kind.startswith("lattice"):
        dec = BatchedLatticeDecoder(g, fc, lattice_beam=5.0, em_records=512, pad_time_to=8,
                                    fold=False, device=card)
        st0, cfg, run = dec._init(B)[0], dec.cfg, lattice_chunk
    else:
        dec = BatchedViterbiDecoder(g, fc, pad_time_to=8, fold=False, device=card)
        st0, cfg, run = dec._init(B)[0], dec.cfg, viterbi_chunk
    S = g.num_states
    counted = (expand_filter, dedup_select_rec, dedup_select, expand_eps_lanes, eps_dedup,
               frame_tail, frame_start)
    decodes = _chunks(card, B, [[20, 7, 13], [11, 20, 3]], 20)
    results = []
    for eager in (True, False):
        n0, r0 = [f.launches for f in counted], driver.replays
        got = []
        with driver.eager_frames() if eager else contextlib.nullcontext():
            for scores, lengths in decodes:
                got.append(run(dec._pg, scores, lengths, st0, cfg, S))
            stf = got[0][0]
            got.append(run(dec._pg, decodes[1][0][:9], decodes[1][1], stf, cfg, S))
        torch.cuda.synchronize()
        results.append((got, [f.launches - n for f, n in zip(counted, n0)],
                        driver.replays - r0))
    (eager, n_eager, _), (graph, n_graph, replays) = results
    for i, ((se, oe), (sg, og)) in enumerate(zip(eager, graph)):
        _same_outputs(oe, og, i)
        for r, g_ in zip(se, sg):
            assert torch.equal(r.view(torch.int32), g_.view(torch.int32)), i
    frames = 20 + 20 + 9
    assert n_graph[:5] == n_eager[:5], (n_graph, n_eager)  # K1, K2, K6, K5, the eps step
    assert (n_graph[3] > 0) == eps and (n_graph[4] > 0) == eps
    assert n_graph[5:] == [frames, 3] and n_eager[5:] == [0, 0]  # K3: the eager tail is plain
    assert replays == frames - 1  # the frame driver's first frame ran eagerly, then the capture


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", [False, True])
def test_graph_driver_streaming_calls(card, lattice):
    """The streaming decoders on one captured frame: a call of 100 frames,
    then one of 37, then one of 1, equal to the same calls run eagerly,
    bitwise (their results and the frames' stats)."""
    from kaldi_decoder_tpu_torch import (
        DecodableCtc,
        FasterDecoder,
        FasterDecoderOptions,
        LatticeFasterDecoder,
        LatticeFasterDecoderConfig,
    )
    from kaldi_decoder_tpu_torch.decoders import driver

    g = _eps_graph(1)
    rng = np.random.default_rng(7)
    logp = np.log(rng.dirichlet(np.ones(V), size=138)).astype(np.float32)
    results = []
    for eager in (True, False):
        if lattice:
            d = LatticeFasterDecoder(
                g, LatticeFasterDecoderConfig(beam=10.0, max_active=48, min_active=20), device=card)
        else:
            d = FasterDecoder(g, FasterDecoderOptions(beam=10.0, max_active=48), device=card)
        r0 = driver.replays
        with driver.eager_frames() if eager else contextlib.nullcontext():
            d.init_decoding()
            for end in (100, 137, 138):
                d.advance_decoding(DecodableCtc(logp[:end]))
        torch.cuda.synchronize()
        results.append((d, driver.replays - r0))
    (de, _), (dg, replays) = results
    assert replays > 0
    if lattice:
        (oke, le), (okg, lg) = de.get_raw_lattice(), dg.get_raw_lattice()
        assert oke and okg
        assert le.to_arrays().keys() == lg.to_arrays().keys()
        for k, v in le.to_arrays().items():
            assert np.array_equal(np.asarray(v), np.asarray(lg.to_arrays()[k])), k
    else:
        re_, rg = de._result(), dg._result()
        for f in ("bp_emit", "bp_eps", "num_active", "best_costs", "cutoffs", "overflows",
                  "saturations", "frontier_states", "frontier_costs"):
            a, b = getattr(re_, f), getattr(rg, f)
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            assert np.array_equal(a, b), f


# ---------------------------------------------------------------------------
# K5 and the eps step
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fat_eps_graph(S=600, E_eps=4000, seed=0):
    """:func:`_graph` with eps arcs, half of them from six hub states
    (hundreds each, far more than an eps block), the rest scattered;
    cyclic."""
    g = _graph(seed, S, 3000)
    rng = np.random.default_rng(seed + 2)
    src = np.concatenate([rng.integers(0, 6, E_eps // 2),
                          rng.integers(0, S, E_eps - E_eps // 2)])
    src.sort()
    row = np.zeros(S + 1, np.int32)
    row[1:] = np.cumsum(np.bincount(src, minlength=S))
    nxt = rng.integers(0, S, E_eps).astype(np.int32)
    ga = g.arrays._replace(
        eps_row_ptr=row, eps_olabel=rng.integers(0, 50, E_eps).astype(np.int32),
        eps_weight=rng.uniform(0, 2, E_eps).astype(np.float32), eps_next=nxt)
    return CsrGraph(ga, S, g.num_emitting_arcs, E_eps, 0, _eps_depth(S, row, nxt),
                    g.max_em_out_degree, int(np.diff(row).max()), g.max_score_idx)


@functools.lru_cache(maxsize=None)
def _hub_eps_graph(S=600, E_eps=1000, hub=3000, seed=0):
    """:func:`_graph` with ``hub`` eps arcs from state 0 and ``E_eps``
    scattered ones, so that state 0's remainder lanes span thousands."""
    g = _graph(seed, S, 3000)
    rng = np.random.default_rng(seed + 2)
    src = np.sort(np.concatenate([np.zeros(hub, np.int64), rng.integers(0, S, E_eps)]))
    E = hub + E_eps
    row = np.zeros(S + 1, np.int32)
    row[1:] = np.cumsum(np.bincount(src, minlength=S))
    nxt = rng.integers(0, S, E).astype(np.int32)
    ga = g.arrays._replace(
        eps_row_ptr=row, eps_olabel=rng.integers(0, 50, E).astype(np.int32),
        eps_weight=rng.uniform(0, 2, E).astype(np.float32), eps_next=nxt)
    return CsrGraph(ga, S, g.num_emitting_arcs, E, 0, _eps_depth(S, row, nxt),
                    g.max_em_out_degree, int(np.diff(row).max()), g.max_score_idx)


def _eps_frontier(card, S, K, nb, seed=0, hubs=0):
    """Cost-sorted frontier rows (costs on a 0.25 grid, one -0.0): row b
    holds K, K/2, 0 and K/3 tokens in turn (row 0 with the first ``hubs``
    states among them)."""
    rng = np.random.default_rng(seed)
    states = np.zeros((nb, K), np.int32)
    costs = np.full((nb, K), np.inf, np.float32)
    for b in range(nb):
        n = (K, K // 2, 0, K // 3)[b % 4]
        if n == 0:
            continue
        if b == 0 and hubs:
            st = np.concatenate([np.arange(hubs), rng.choice(np.arange(hubs, S), n - hubs,
                                                             replace=False)])
        else:
            st = rng.choice(S, n, replace=False)
        co = (rng.integers(0, 20, n) * 0.25).astype(np.float32)
        co[0] = -0.0
        order = np.lexsort((st, co))
        states[b, :n], costs[b, :n] = st[order], co[order]
    return (torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card))


def _same_lanes(ref, got, what):
    for f in ref._fields:
        r, g = getattr(ref, f), getattr(got, f)
        assert (r is None) == (g is None), (what, f)
        if r is None:
            continue
        if r.dtype == torch.float32:
            r, g = r.view(torch.int32), g.view(torch.int32)  # raw bits: -0.0 stays -0.0
        assert torch.equal(r, g), (what, f)


# case: (states, frontier size, eps block width, eps remainder budget, cutoffs)
EPS_LANE_CASES = {
    "many": (600, 256, 2, 2500, (3.0, 1.5, 2.0, -1.0)),  # past one tile of owners
    "overflow": (600, 256, 1, 8, (3.0, 1.5, 2.0, -1.0)),
    "inf-cutoff": (600, 256, 2, 2500, (np.inf,) * 4),
    "big-K": (10000, 8192, 1, 5000, (4.0, 2.0, 2.0, -1.0)),  # two rounds of the slot scan
    # Row 0's slot of state 0 owns some 3000 remainder lanes: more than one
    # window of owners (csrc/eps.cu TILE, 2048 positions) of the block of
    # the row's cluster that writes them.
    "span-crosses": (600, 256, 1, 4000, (3.0, 1.5, 2.0, -1.0)),
}
# case: (its graph, the hub states in row 0), when not _fat_eps_graph's six
EPS_LANE_GRAPHS = {"span-crosses": (_hub_eps_graph, 1)}
EPS_TILE = 2048  # csrc/eps.cu TILE: the remainder positions a block places at a time


def _longest_span(g, states, costs, cut, We):
    """The most remainder lanes one slot under its row's cutoff owns: its
    eps arcs past the block width."""
    row = torch.as_tensor(np.asarray(g.arrays.eps_row_ptr), device=states.device).long()
    deg = row[states.long() + 1] - row[states.long()]
    act = torch.isfinite(costs) & (costs <= cut[:, None])
    return int(torch.where(act, (deg - We).clamp(min=0), torch.zeros_like(deg)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("blocks", [0, 8, 4, 2, 1])
@pytest.mark.parametrize("incumbents", [True, False])
@pytest.mark.parametrize("case", sorted(EPS_LANE_CASES))
def test_expand_eps_kernel_matches_plain(card, case, incumbents, blocks):
    """K5 against its plain version, every column bitwise (raw cost bits),
    at each cluster size (blocks a row) it can launch with (0: its own
    choice), with and without the incumbents first: hub states with far
    more eps arcs than the block width, a remainder budget that overflows,
    an empty row, a row with no slot under its cutoff, a cutoff of +inf, a
    frontier larger than one round of the slot scan, blocks holding more
    remainder lanes than one window of owners, an owner whose remainder
    lanes span more than one window."""
    S, K, We, R, cuts = EPS_LANE_CASES[case]
    graph, hubs = EPS_LANE_GRAPHS.get(case, (_fat_eps_graph, 6))
    g = graph(S)
    fc = config_for_graph(g, frontier_size=K, max_active=K, beam=10.0, eps_block_width=We,
                          eps_rem_budget=R)
    assert (fc.frontier_size, fc.eps_block_width, fc.eps_rem_budget) == (K, We, R)
    pg = pack_graph_device(g, fc.block_width, We, fc.flat_group, card)
    states, costs = _eps_frontier(card, S, K, 4, hubs=hubs)
    cut = torch.tensor(cuts, dtype=torch.float32, device=card)
    ref = expand_eps_lanes_plain(states, costs, cut, pg, fc, incumbents)
    assert bool(ref.overflow.any()) == (case == "overflow")
    if case == "span-crosses":
        assert _longest_span(g, states, costs, cut, We) > EPS_TILE
    for _ in range(2):
        got = expand_eps_lanes(states, costs, cut, pg, fc, incumbents, blocks=blocks)
        torch.cuda.synchronize()
        _same_lanes(ref, got, case)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [(True, False), (False, True)])
def test_expand_eps_kernel_columns(card, cols):
    """K5 writes only the source columns asked for, into ``out``."""
    from kaldi_decoder_tpu_torch.kernels.eps import empty_eps_lanes, eps_lane_count

    S, K, We, R, cuts = EPS_LANE_CASES["many"]
    g = _fat_eps_graph(S)
    fc = config_for_graph(g, frontier_size=K, max_active=K, beam=10.0, eps_block_width=We,
                          eps_rem_budget=R)
    pg = pack_graph_device(g, fc.block_width, We, fc.flat_group, card)
    states, costs = _eps_frontier(card, S, K, 4, hubs=6)
    cut = torch.tensor(cuts, dtype=torch.float32, device=card)
    ref = expand_eps_lanes_plain(states, costs, cut, pg, fc, True, *cols)
    out = empty_eps_lanes(4, eps_lane_count(fc, True), card, *cols)
    got = expand_eps_lanes(states, costs, cut, pg, fc, True, *cols, out=out)
    torch.cuda.synchronize()
    assert got is out
    _same_lanes(ref, got, cols)


def _eps_closures(card, graph, lattice, exact, nb, eps_rem_budget=None, D=3):
    """Two closures of D iterations on one carry (``ran`` and the count
    word carried in device memory, reset by each closure's first
    iteration), each iteration's lanes K5's of the frontier the one before
    left: the fused call (``eps_dedup``: K6, or K2's eps call with the K
    incumbents first, whose last step is the eps step) against its plain
    composition on CPU copies of the same lanes (the dedup call's plain
    version, then ``eps_step_plain``), bitwise after every iteration: the
    selection (costs by raw bits) and every field of the carry.  Rows
    cycle through 64, 32, 0 and 21 tokens; every fourth from the third is
    inactive.  On the depth-1 graph the batch stops after its first
    iteration (``ran`` turns false, later rows the identity or -1); on the
    ring it never stops, so without ``exact`` the last iteration flags
    every active row.  Returns the eps lanes a row."""
    g = _eps_graph(1 if graph == "depth1" else None)
    kw = dict(eps_rem_budget=eps_rem_budget) if eps_rem_budget else {}
    fc = config_for_graph(g, frontier_size=64, max_active=48, beam=10.0, rem_budget=4096, **kw)
    dec = BatchedLatticeDecoder(g, fc, lattice_beam=5.0, em_records=512, pad_time_to=8,
                                fold=False, device=card)
    fc, pg, S, K = dec.cfg.frontier, dec._pg, g.num_states, dec.cfg.frontier.frontier_size
    r_eps = dec.cfg.eps_records
    width = r_eps if lattice else K
    carry_k = empty_eps_carry(nb, D, width, lattice, card)
    carry_p = empty_eps_carry(nb, D, width, lattice, "cpu")
    row_active = torch.arange(nb) % 4 != 2
    cut = torch.tensor([(3.0, 1.5, 2.0, 2.5)[b % 4] for b in range(nb)], dtype=torch.float32)
    sb = dec.cfg.lattice_beam + 1e-4 if lattice else None
    counter = dedup_select_rec if lattice else dedup_select
    before = (counter.launches, eps_dedup.launches)
    for closure in range(2):
        states, costs = _eps_frontier(card, S, K, nb, seed=closure)
        for d in range(D):
            lanes = expand_eps_lanes(states, costs, cut.to(card), pg, fc, True,
                                     with_src_slot=not lattice, with_src_state=lattice)
            got = eps_dedup(d, carry_k, row_active.to(card), lanes, exact, K, S, sb)
            cpu = EpsLanes(*(x.cpu() if x is not None else None for x in lanes))
            want = eps_dedup(d, carry_p, row_active, cpu, exact, K, S, sb)
            torch.cuda.synchronize()
            where = (closure, d)
            for f, w, x in zip(want._fields, want, got):
                if w is not None:
                    _same_bits(w, x.cpu(), (where, f))
            assert carry_k.flags[1:].tolist() == [0], where  # the count word, cleared
            assert bool(carry_k.flags[0]) == bool(carry_p.flags[0]), where
            for f in ("overflow", "saturated", "changed"):
                assert torch.equal(getattr(carry_k, f).cpu(), getattr(carry_p, f)), (where, f)
            assert torch.equal(carry_k.out[:, d].cpu(), carry_p.out[:, d]), where
            states, costs = got.states, got.costs
        if graph == "depth1":
            assert not bool(carry_k.flags[0])
        elif not exact:
            assert bool(carry_k.overflow.cpu()[row_active].all())
    assert (counter.launches, eps_dedup.launches) == (before[0] + 2 * D, before[1] + 2 * D)
    return lanes.dst.shape[1]


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("graph", ["depth1", "ring"])
def test_eps_step_kernel_matches_plain(card, graph, lattice, exact):
    """The eps step, run as the last step of the eps dedup call, against
    the dedup call's plain version followed by ``eps_step_plain``
    (:func:`_eps_closures`) at four rows, one inactive, ``eps_exact``
    both ways."""
    _eps_closures(card, graph, lattice, exact, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", [8, 4, 2, 1])
@pytest.mark.parametrize("lattice", [False, True])
@pytest.mark.parametrize("nb", [1, 16])
def test_eps_dedup_kernel_cluster_sizes(card, nb, lattice, clusters):
    """The fused eps call (:func:`_eps_closures`, on the ring and on the
    depth-1 graph where the batch stops) at B 1 and 16 with eps lanes of
    each cluster size's width: at B = 1 the call runs clusters of 8, 4, 2
    and 1 blocks (a row of N lanes takes at most the power of two that
    leaves every block 1024 lanes); at B = 16 at most that many."""
    R = {8: 9216, 4: 6144, 2: 3072, 1: 1024}[clusters]
    for graph in ("ring", "depth1"):
        N = _eps_closures(card, graph, lattice, False, nb, eps_rem_budget=R)
        size = (rec_cluster_size(nb, N, incumbents=True, step=True) if lattice
                else dedup_cluster_size(nb, N, step=True))
        assert size == clusters if nb == 1 else 1 <= size <= clusters, (N, size)


# ---------------------------------------------------------------------------
# K7, the shard route, and the shard modes of the eps step and K3
# ---------------------------------------------------------------------------

SHARD_SLACK = 8.0 + 1e-4  # the sharded lattice path's slack beam at lattice beam 8


def _route_lanes(seed, nb, N, P):
    """(dst, cost, src, arc, sp) numpy lanes of a route call: about four
    lanes a state, costs on a 0.25 grid (ties), -0.0 beside +0.0, +inf
    lanes, a run minimum beside its slack-beam neighbours (the floats
    either side of min + slack), row nb-1 all +inf when nb > 1."""
    rng = np.random.default_rng(seed)
    sp = max(16, N // (4 * P))
    dst = rng.integers(0, P * sp, size=(nb, N)).astype(np.int32)
    cost = (rng.integers(-4, 60, size=(nb, N)) * 0.25).astype(np.float32)
    cost[:, ::7] = -0.0
    cost[:, 3::5] = np.inf
    for i in range(8, N - 4, 97):
        m = np.float32(rng.uniform(-2.0, 10.0))
        near = np.float32(m + np.float32(SHARD_SLACK))
        dst[:, i:i + 4] = dst[:, i:i + 1]
        cost[:, i:i + 4] = (m, near, np.nextafter(near, np.float32(np.inf)),
                            np.nextafter(near, np.float32(-np.inf)))
    if nb > 1:
        cost[nb - 1] = np.inf
    src = rng.integers(0, 2048, size=(nb, N)).astype(np.int32)
    arc = rng.integers(0, 1 << 20, size=(nb, N)).astype(np.int32)
    return dst, cost, src, arc, sp


def _same_bits(want, got, what):
    if want.dtype == torch.float32:
        want, got = want.view(torch.int32), got.view(torch.int32)
    assert torch.equal(want, got), what


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [None, SHARD_SLACK], ids=["leaders", "slack"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("N", [30720, 3072])
@pytest.mark.parametrize("nb", [16, 1])
def test_route_send_kernel_matches_plain(card, nb, N, P, beam):
    """K7's send side against ``route_send_plain``, every int32 of the send
    buffer and the overflow flag, at the shard shapes: with the cap at N,
    at exactly the fullest bucket's kept lanes (no overflow) and one under
    it (overflow); plain and with the beam filter, the slot map and the
    offsets folded in; the same out buffers reused call after call."""
    from kaldi_decoder_tpu_torch.kernels.route import (
        empty_route_send,
        route_send,
        route_send_plain,
    )

    dst, cost, src, arc, sp = _route_lanes(nb * 1000 + N + P, nb, N, P)
    t = [torch.from_numpy(x).to(card) for x in (dst, cost, src, arc)]
    rng = np.random.default_rng(N)
    cutoff = torch.from_numpy(rng.uniform(0.0, 12.0, size=nb).astype(np.float32)).to(card)
    cutoff[0] = float("inf")
    states = torch.from_numpy(rng.integers(0, sp, size=(nb, 2048)).astype(np.int32))
    states = states.to(card)
    full = route_send_plain(*t, sp, P, N, beam)
    kept = (full.buf[..., 1] != np.float32(np.inf).view(np.int32)).sum(dim=2)  # (P, B)
    most = int(kept.max())
    for cap in (N, most, most - 1):
        out = empty_route_send(nb, N, P, cap, card)
        for folded in (False, True):
            kw = dict(cutoff=cutoff, slot_states=states, slot_add=7 * P, arc_add=-3) \
                if folded else {}
            want = route_send_plain(*t, sp, P, cap, beam, **kw)
            before = route_send.launches
            got = route_send(*t, sp, P, cap, beam, **kw, out=out)
            torch.cuda.synchronize()
            assert route_send.launches == before + 1
            where = f"cap {cap}, folded {folded}"
            _same_bits(want.buf, got.buf, f"send buffer, {where}")
            _same_bits(want.overflow, got.overflow, f"overflow, {where}")
            if cap == most - 1 and not folded:
                assert bool(got.overflow.any()), "a bucket must overflow"
            if cap == most and not folded:
                assert not bool(got.overflow.any()), "the fullest bucket fits exactly"


@pytest.mark.cuda
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("nb", [16, 1])
def test_route_recv_kernel_matches_plain(card, nb, P):
    """K7's receive side (the emitting call's: no incumbents; the eps
    calls read them in place, :func:`test_routed_eps_calls_match_plain`)
    against ``route_recv_plain``: a received buffer with +inf and -0.0
    costs."""
    from kaldi_decoder_tpu_torch.kernels.route import route_recv, route_recv_plain

    rng = np.random.default_rng(nb + P)
    cap, sp = 3072 // P * 2, 5000
    recv = rng.integers(-5, 1 << 20, size=(P, nb, cap, 4)).astype(np.int32)
    c = (rng.integers(-4, 60, size=(P, nb, cap)) * 0.25).astype(np.float32)
    c[..., ::3] = np.inf
    c[..., 1::7] = -0.0
    recv[..., 1] = c.view(np.int32)
    recv = torch.from_numpy(recv).to(card)
    want = route_recv_plain(recv, sp)
    before = route_recv.launches
    got = route_recv(recv, sp)
    torch.cuda.synchronize()
    assert route_recv.launches == before + 1
    for name, w, g in zip(want._fields, want, got):
        _same_bits(w, g, name)


def _routed_lanes(rng, card, nb, P, cap, K, sp, base):
    """A sharded eps call's lanes as the all_to_all leaves them, a
    ``RoutedLanes`` on the card: the received (P, nb, cap, 4) buffer (a
    few states a part, so runs; costs on a 0.25 grid with -0.0 and +inf
    entries, some under the incumbents' costs; random slots and arcs) and
    K cost-sorted incumbents with a +inf tail, their slots ``base + k``
    (None: -1)."""
    from kaldi_decoder_tpu_torch.kernels.route import RoutedLanes

    recv = np.empty((P, nb, cap, 4), np.int32)
    recv[..., 0] = rng.integers(0, sp, size=(P, nb, cap))
    c = (rng.integers(-8, 60, size=(P, nb, cap)) * 0.25).astype(np.float32)
    c[..., ::3] = np.inf
    c[..., 1::7] = -0.0
    recv[..., 1] = c.view(np.int32)
    recv[..., 2] = rng.integers(0, 1 << 20, size=(P, nb, cap))
    recv[..., 3] = rng.integers(0, 1 << 20, size=(P, nb, cap))
    states = rng.integers(0, sp, size=(nb, K)).astype(np.int32)
    costs = np.sort((rng.integers(0, 40, size=(nb, K)) * 0.25).astype(np.float32), axis=1)
    costs[:, K - K // 8:] = np.inf
    return RoutedLanes(torch.from_numpy(recv).to(card), sp, torch.from_numpy(states).to(card),
                       torch.from_numpy(costs).to(card), base)


def _cpu(x):
    """``x`` with every tensor in it (in tuples and named tuples) on the CPU."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        items = [_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _routed_calls(card, src, K, lattice, r_eps=1536, slack=SHARD_SLACK):
    """The folded eps call on the routed lanes ``src``: K6 (1-best) or K2's
    eps call with K incumbents (lattice), each called twice (the winner
    table comes back all ones) and held bitwise, every field, against its
    plain version on CPU copies (the lanes laid out by
    ``routed_lanes_plain``) and against the flat instance on the same
    lanes laid out on the card.  Returns the kernel's selection."""
    from kaldi_decoder_tpu_torch.kernels.route import routed_lanes_plain

    sp = src.sp
    flat = routed_lanes_plain(src)
    if lattice:
        def call(s, **kw):
            return dedup_select_rec(None, None, K, sp, K + r_eps, slack, None, num_incumbents=K,
                                    routed=s, **kw)

        want = call(_cpu(src))
        alt = dedup_select_rec(flat.state_local, flat.cost, K, sp, K + r_eps, slack,
                               (flat.gslot, flat.arc), num_incumbents=K)
        counter = dedup_select_rec
    else:
        def call(s, **kw):
            return dedup_select(None, None, K, sp, routed=s, **kw)

        want = call(_cpu(src))
        alt = dedup_select(flat.state_local, flat.cost, K, sp)
        counter = dedup_select
    for rep in range(2):
        before = counter.launches
        got = call(src)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        for name, w, a, g in zip(want._fields, want, alt, got):
            if w is None:
                continue
            _same_bits(w, g.cpu(), f"call {rep}: {name} against plain")
            _same_bits(a, g, f"call {rep}: {name} against the flat instance")
    return got


def _routed_step(card, src, sel, K, my_base, clusters):
    """The 1-best eps step's shard mode after K6's call ``sel`` on the
    routed lanes ``src`` (its incumbents the carried frontier), reducing,
    at ``clusters`` blocks a row (0: its own choice): its backpointers
    the winners' (slot, arc) read through the lane map; every field of the
    carry and the carried frontier bitwise against plain on CPU copies."""
    from kaldi_decoder_tpu_torch.kernels.eps import (
        empty_shard_eps_carry,
        eps_step_shard,
        eps_step_shard_plain,
    )

    nb = sel.states.shape[0]
    carries = [empty_shard_eps_carry(nb, 1, K, dev) for dev in ("cpu", card)]
    fronts = [(src.inc_states.clone(), src.inc_costs.clone()) for _ in range(2)]
    fronts[0] = _cpu(fronts[0])
    no = torch.zeros((nb,), dtype=torch.bool, device=card)
    eps_step_shard_plain(0, carries[0], *fronts[0], _cpu(sel), no.cpu(), no.cpu(), None,
                         my_base, lanes=_cpu(src), reduce=True)
    before = eps_step_shard.launches
    eps_step_shard(0, carries[1], *fronts[1], sel, no, no, None, my_base, lanes=src,
                   reduce=True, clusters=clusters)
    torch.cuda.synchronize()
    assert eps_step_shard.launches == before + 1
    for name, w, g in zip(carries[0]._fields, *carries):
        _same_bits(w, g.cpu(), f"carry.{name}")
    for w, g, name in zip(fronts[0], fronts[1], ("states", "costs")):
        _same_bits(w, g.cpu(), f"carried {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("inc", ["slots", "links"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("nb", [16, 1])
def test_routed_eps_calls_match_plain(card, nb, P, inc):
    """The sharded eps call with K7's receive side folded in, on the
    shapes the receive side's incumbent cases had (K 2048 incumbents, cap
    6144 / P a rank, -0.0 and +inf costs): ``inc`` "slots", K6 on the
    routed lanes (the incumbents' slots my_base + k) and the eps step's
    shard mode reading each winner's (slot, arc) through the same map;
    "links", K2's eps call (the incumbents' slots -1), its records'
    payload read in place; each bitwise against its plain version on CPU
    copies and against the flat instance on the lanes laid out."""
    rng = np.random.default_rng(nb + P + (inc == "links"))
    cap, K, sp, my_base = 3072 // P * 2, 2048, 5000, 4096
    lattice = inc == "links"
    src = _routed_lanes(rng, card, nb, P, cap, K, sp, None if lattice else my_base)
    sel = _routed_calls(card, src, K, lattice)
    if lattice:
        return
    # The eps step's shard mode on that selection, reducing: its backpointers
    # are the winners' routed (slot, arc).
    _routed_step(card, src, sel, K, my_base, 0)
    won = sel.cand_idx >= K
    assert bool(won.any()) and bool((sel.cand_idx[sel.cand_idx >= 0] < K).any()), \
        "incumbents and routed lanes both win slots"


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
@pytest.mark.parametrize("clusters", [8, 4, 2, 1])
@pytest.mark.parametrize("nb", [16, 1])
def test_routed_eps_calls_cluster_sizes(card, nb, clusters, lattice):
    """The folded eps calls (K6, K2's eps call) at each cluster size: rows
    of K + P * cap routed lanes as wide as make a cluster of 8, 4, 2 and
    1 blocks (at B = 1 exactly that, at B = 16 at most that), bitwise
    against plain and the flat instance; with K6 the eps step's shard mode
    at the same number of blocks a row."""
    K, P, cap = {8: (2048, 2, 7168), 4: (1024, 2, 1536), 2: (512, 2, 768),
                 1: (512, 2, 512)}[clusters]
    N = K + P * cap
    rng = np.random.default_rng(clusters * 10 + nb + lattice)
    my_base = 2 * K
    src = _routed_lanes(rng, card, nb, P, cap, K, 3000, None if lattice else my_base)
    assert src.lanes == N
    size = (rec_cluster_size(nb, N, incumbents=True, routed=True) if lattice
            else dedup_cluster_size(nb, N, routed=True))
    assert size == clusters if nb == 1 else 1 <= size <= clusters, (N, size)
    sel = _routed_calls(card, src, K, lattice, r_eps=K // 2)
    if lattice:
        return
    _routed_step(card, src, sel, K, my_base, clusters)


def _shard_selection(rng, card, nb, K, N, lattice, r_eps):
    """A dedup call's result as the sharded eps iteration gives it: a
    cost-sorted frontier (+inf tail), winning lanes in [0, N) or -1, the
    distinct counts; on the lattice path records (K + r_eps rows, links a
    prefix, -1 after) and their overflow."""
    from kaldi_decoder_tpu_torch.kernels.dedup_rec import LatticeSelection
    from kaldi_decoder_tpu_torch.ops.segment import Selection

    costs = np.sort((rng.integers(0, 40, size=(nb, K)) * 0.25).astype(np.float32), axis=1)
    live = rng.integers(K // 2, K + 1, size=nb)
    for b in range(nb):
        costs[b, live[b]:] = np.inf
    cand = rng.integers(0, N, size=(nb, K)).astype(np.int32)
    cand[~np.isfinite(costs)] = -1
    cand[:, ::5] = np.minimum(cand[:, ::5], K - 1)  # incumbents win some slots
    t = dict(states=torch.from_numpy(rng.integers(0, 9000, size=(nb, K)).astype(np.int32)),
             costs=torch.from_numpy(costs),
             num_unique=torch.from_numpy(rng.integers(K - 8, K + 8, size=nb)
                                         .astype(np.int32)),
             cand_idx=torch.from_numpy(cand))
    t = {k: v.to(card) for k, v in t.items()}
    if not lattice:
        return Selection(t["states"], t["costs"], t["cand_idx"], t["num_unique"])
    R = K + r_eps
    rec = rng.integers(0, 1 << 20, size=(nb, R, 4)).astype(np.int32)
    links = rng.integers(r_eps - 20, r_eps + 20, size=nb)
    for b in range(nb):
        rec[b, links[b]:] = -1
    return LatticeSelection(t["states"], t["costs"], t["num_unique"],
                            torch.from_numpy(rec).to(card),
                            torch.from_numpy(rng.random(nb) < 0.2).to(card), t["cand_idx"])


SHARD_CLUSTERS = [0, 8, 4, 2, 1]  # the chosen size, then each size forced


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", SHARD_CLUSTERS)
@pytest.mark.parametrize("stops", [True, False], ids=["stops", "runs-on"])
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
@pytest.mark.parametrize("nb", [16, 1])
def test_eps_step_shard_kernel_matches_plain(card, nb, lattice, stops, clusters):
    """The eps step's shard mode against ``eps_step_shard_plain`` over a
    D = 2 closure on one carry: iteration 0 with the emitting call's flags
    folded in, iteration 1 given the reduced flag 0 (the batch stops: the
    frontier kept, identity or -1 rows) or 1, and reducing: after each
    step every field of the carry and the carried frontier bitwise; at
    the kernel's own cluster size (more than one block a row at B = 16)
    and at 8, 4, 2 and 1 blocks a row."""
    from kaldi_decoder_tpu_torch.kernels.eps import (
        empty_shard_eps_carry,
        eps_step_shard,
        eps_step_shard_plain,
        shard_step_cluster_size,
    )
    rng = np.random.default_rng(nb * 10 + lattice)
    K, P, cap, r_eps, my_base = 2048, 2, 3072, 1536, 2048
    N = K + P * cap
    width = r_eps if lattice else K
    if nb == 16 and clusters == 0:
        assert shard_step_cluster_size(nb, K) > 1
    carries = [empty_shard_eps_carry(nb, 2, width, card) for _ in range(2)]
    st = torch.from_numpy(rng.integers(0, 9000, size=(nb, K)).astype(np.int32)).to(card)
    co = torch.from_numpy(np.sort(rng.uniform(0, 5, size=(nb, K)).astype(np.float32),
                                  axis=1)).to(card)
    fronts = [(st.clone(), co.clone()) for _ in range(2)]
    # The dedup call's routed lanes, read in place: the incumbents' slots
    # my_base + k and NO_ARC, the received entries' own.
    lanes = _routed_lanes(rng, card, nb, P, cap, K, 9000, my_base)

    def flags(p):
        return torch.from_numpy(rng.random(nb) < p).to(card)

    em = (flags(0.1), flags(0.1))
    em_nu = torch.from_numpy(rng.integers(K - 4, K + 2, size=nb).astype(np.int32)).to(card)
    red = torch.tensor([0 if stops else 1], dtype=torch.int32, device=card)
    for d in range(2):
        sel = _shard_selection(rng, card, nb, K, N, lattice, r_eps)
        exp_ovf, route_ovf = flags(0.05), flags(0.05)
        kw = dict(lanes=lanes, em_overflow=em if d == 0 else (),
                  em_num_unique=em_nu if d == 0 else None, reduce=d == 1)
        args = (sel, exp_ovf, route_ovf, red if d else None, my_base)
        eps_step_shard_plain(d, carries[0], *fronts[0], *args, **kw)
        before = eps_step_shard.launches
        eps_step_shard(d, carries[1], *fronts[1], *args, **kw, clusters=clusters)
        torch.cuda.synchronize()
        assert eps_step_shard.launches == before + 1
        for name, w, g in zip(carries[0]._fields, *carries):
            if name == "out":
                w, g = w[:, : d + 1], g[:, : d + 1]
            if name in ("red_min", "red_count") and not kw["reduce"]:
                continue  # written by the reducing step alone
            _same_bits(w, g, f"iteration {d}: carry.{name}")
        for w, g, name in zip(*fronts, ("states", "costs")):
            _same_bits(w, g, f"iteration {d}: carried {name}")
    if stops:  # the second row of every row: the identity or -1
        out = carries[1].out[:, 1]
        if lattice:
            assert bool((out == -1).all())
        else:
            slots = (my_base + torch.arange(K, device=card)).expand(nb, K)
            assert torch.equal(out[..., 0], slots.to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("clusters", SHARD_CLUSTERS)
@pytest.mark.parametrize("zero", [False, True], ids=["equal-bits", "signed-zero"])
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
def test_eps_step_shard_kernel_min_ties(card, lattice, zero, clusters):
    """The reducing step's smallest finite cost when it ties across two
    blocks' slot ranges (slots 1000 and 1100 of K 2048: blocks 3 and 4 at 8
    blocks a row, 1 and 2 at 4, 0 and 1 at 2; two warps of one block at 1),
    every other finite cost larger: the same bits at both, or -0.0 and
    +0.0, which slot first alternating by row: red_min has the bits of the
    first in slot order, the rule the kernel and plain keep (the local
    half that K3's shard mode derives from it must be first in slot
    order); every field of the carry bitwise against
    ``eps_step_shard_plain``."""
    from kaldi_decoder_tpu_torch.kernels.eps import (
        empty_shard_eps_carry,
        eps_step_shard,
        eps_step_shard_plain,
    )

    nb, K, P, cap, r_eps, my_base = 16, 2048, 2, 3072, 1536, 0
    N = K + P * cap
    rng = np.random.default_rng(7 + lattice + 2 * zero)
    sel = _shard_selection(rng, card, nb, K, N, lattice, r_eps)
    costs = rng.uniform(1, 5, size=(nb, K)).astype(np.float32)
    costs[:, 1900:] = np.inf
    first, second = (np.float32(-0.0), np.float32(0.0)) if zero else (0.5, 0.5)
    costs[0::2, 1000], costs[0::2, 1100] = first, second
    costs[1::2, 1000], costs[1::2, 1100] = second, first
    sel.costs.copy_(torch.from_numpy(costs))
    width = r_eps if lattice else K
    carries = [empty_shard_eps_carry(nb, 1, width, card) for _ in range(2)]
    fronts = [(torch.zeros((nb, K), dtype=torch.int32, device=card),
               torch.zeros((nb, K), dtype=torch.float32, device=card)) for _ in range(2)]
    lanes = _routed_lanes(rng, card, nb, P, cap, K, 9000, my_base)
    no = torch.zeros((nb,), dtype=torch.bool, device=card)
    args = (sel, no, no, None, my_base)
    eps_step_shard_plain(0, carries[0], *fronts[0], *args, lanes=lanes, reduce=True)
    eps_step_shard(0, carries[1], *fronts[1], *args, lanes=lanes, reduce=True,
                   clusters=clusters)
    torch.cuda.synchronize()
    canon = np.where(costs == 0, np.float32(0.0), costs)
    at = np.argmin(np.where(np.isfinite(costs), canon, np.inf), axis=1)  # first smallest
    want = torch.from_numpy(costs[np.arange(nb), at].copy())
    _same_bits(want, carries[1].red_min.cpu(), "red_min: the first smallest in slot order")
    for name, w, g in zip(carries[0]._fields, *carries):
        _same_bits(w, g, f"carry.{name}")
    for w, g, name in zip(*fronts, ("states", "costs")):
        _same_bits(w, g, f"carried {name}")


# The local values' flag cases: each emitting overflow word of the last
# row, its states past K, K2's own record overflow, and all of them; the
# want of its flag pair.
REDUCE_FLAGS = {"overflow0": [1, 0], "overflow1": [1, 0], "overflow2": [1, 0],
                "saturated": [0, 1], "rec": [1, 0], "all": [1, 1]}
REDUCE_LANES = 16384  # lanes a row: room for 8 blocks a row (dedup_core.cuh cluster_cap)


def _reduce_inputs(rng, nb, K, flag):
    """Lanes (nb, REDUCE_LANES) for an emitting call whose frontier the
    local values read: lane k < K of a row at state k, its cost in [1, 5)
    (its last eighth +inf); the smallest tied across two blocks' slot
    ranges of the lanes (K/2 - 24 and K/2 + 24) as -0.0 and +0.0 on even
    rows (which first alternating by pairs) and as equal bits on odd rows;
    row 1 all +inf, row 2 one finite cost (at B > 2); the other lanes
    +inf, but for ``saturated`` (or ``all``) the last row's, finite at
    states past K; the last row's overflow flags set as ``flag`` names
    (``REDUCE_FLAGS``), none when None.  Returns (states, costs, three
    flags)."""
    N = REDUCE_LANES
    costs = np.full((nb, N), np.inf, np.float32)
    costs[:, :K] = rng.uniform(1, 5, size=(nb, K)).astype(np.float32)
    costs[:, K - K // 8:K] = np.inf
    lo, hi = K // 2 - 24, K // 2 + 24
    for b in range(nb):
        first, second = ((np.float32(-0.0), np.float32(0.0)) if b % 2 == 0
                         else (np.float32(0.75), np.float32(0.75)))
        if b % 4 == 2:
            first, second = second, first
        costs[b, lo], costs[b, hi] = first, second
    if nb > 2:
        costs[1] = np.inf
        costs[2] = np.inf
        costs[2, K - 200] = 3.5
    ovf = [np.zeros(nb, bool) for _ in range(3)]
    if flag in ("overflow0", "overflow1", "overflow2", "all"):
        for i in (range(3) if flag == "all" else [int(flag[-1])]):
            ovf[i][nb - 1] = True
    if flag in ("saturated", "all"):
        extra = K // 4 + 100
        costs[nb - 1, K:K + extra] = rng.uniform(5, 6, size=extra).astype(np.float32)
    states = np.tile(np.arange(N, dtype=np.int32), (nb, 1))
    return states, costs, ovf


@pytest.mark.cuda
@pytest.mark.parametrize("kind,flag", [("k6", f) for f in sorted(REDUCE_FLAGS) if f != "rec"]
                         + [("k2", f) for f in sorted(REDUCE_FLAGS)])
@pytest.mark.parametrize("clusters", SHARD_CLUSTERS)
@pytest.mark.parametrize("K", [2048, 512])
@pytest.mark.parametrize("nb", [16, 1])
def test_fused_reduce_kernel_matches_plain(card, nb, K, clusters, kind, flag):
    """The emitting K6 and K2 calls with ``reduce=`` (a sharded frame's
    local values at eps_iters 0 as the call's last step) against the
    plain call then ``eps_reduce_shard_plain`` on CPU copies, bitwise, at
    B 16 and 1 (its one row completes the count word at once), at the
    call's own cluster size and at 8, 4, 2 and 1 blocks a
    row, with outputs that start as the bit complement of plain's: the
    selection, red_min the first smallest finite cost in slot order of
    the frontier with that slot's bits (-0.0 before +0.0, lanes of two
    blocks), +inf for a row without one, red_count, and the flag pair
    written whole, word by word.  Three calls on one carry (``flag``'s
    flags, none, ``flag``'s again), as replays of a captured frame make
    them: the count word is 0 after each.  K2's ``rec`` case has fewer
    record rows than finite lanes (its own rec_overflow); its other cases
    keep every record."""
    from kaldi_decoder_tpu_torch.kernels.dedup import eps_reduce_shard_plain, shard_reduce
    from kaldi_decoder_tpu_torch.kernels.eps import empty_shard_eps_carry

    rng = np.random.default_rng(11 + K + (kind == "k2") + nb)
    N, S = REDUCE_LANES, REDUCE_LANES
    got = empty_shard_eps_carry(nb, 0, K, card)
    for flagged in (flag, None, flag):
        R = 64 if flagged == "rec" else K + 128
        states, costs, ovf = _reduce_inputs(rng, nb, K, flagged)
        st, co = torch.from_numpy(states), torch.from_numpy(costs)
        pay = (torch.from_numpy(rng.integers(0, 1 << 20, size=(nb, N)).astype(np.int32)),
               torch.arange(N, dtype=torch.int32).repeat(nb, 1))
        em = tuple(torch.from_numpy(x) for x in ovf)
        if kind == "k6":
            want_sel = dedup_select_plain(st, co, K, S)
            own = ()
        else:
            plain = dedup_select_rec_plain(st, co, K, S, R, LATTICE_BEAM, pay)
            want_sel, own = plain, (plain.rec_overflow,)
        want = empty_shard_eps_carry(nb, 0, K, "cpu")
        eps_reduce_shard_plain(want, want_sel.costs, em + own, want_sel.num_unique)
        for name in ("red_min", "red_count", "red_flags"):
            w = getattr(want, name)
            getattr(got, name).view(torch.int32).copy_(~w.view(torch.int32))
        n0, r0 = (dedup_select if kind == "k6" else dedup_select_rec).launches, \
            shard_reduce.launches
        dev_em = tuple(x.to(card) for x in em)
        if kind == "k6":
            sel = dedup_select(st.to(card), co.to(card), K, S, reduce=(got, dev_em),
                               clusters=clusters)
        else:
            sel = dedup_select_rec(st.to(card), co.to(card), K, S, R, LATTICE_BEAM,
                                   tuple(p.to(card) for p in pay), reduce=(got, dev_em),
                                   clusters=clusters)
        torch.cuda.synchronize()
        assert (dedup_select if kind == "k6" else dedup_select_rec).launches == n0 + 1
        assert shard_reduce.launches == r0 + 1
        assert got.red_done.tolist() == [0], "the count word is 0 between calls"
        _same_bits(want_sel.costs, sel.costs.cpu(), "the frontier's costs")
        _same_bits(want_sel.num_unique, sel.num_unique.cpu(), "num_unique")
        for name in ("red_min", "red_count", "red_flags"):
            _same_bits(getattr(want, name), getattr(got, name).cpu(), f"carry.{name}")
        fc = want_sel.costs.numpy()
        canon = np.where(fc == 0, np.float32(0.0), fc)
        at = np.argmin(np.where(np.isfinite(fc), canon, np.inf), axis=1)
        first = fc[np.arange(nb), at].copy()
        first[~np.isfinite(fc).any(axis=1)] = np.inf
        _same_bits(torch.from_numpy(first), got.red_min.cpu(),
                   "red_min: the first smallest in slot order")
        assert got.red_flags.tolist() == (REDUCE_FLAGS[flagged] if flagged else [0, 0])
    size = dedup_cluster_size(nb, N) if kind == "k6" else rec_cluster_size(nb, N, reduce=True)
    assert size == (dedup_cluster_size(nb, N) if kind == "k6" else rec_cluster_size(nb, N))


@pytest.mark.cuda
@pytest.mark.parametrize("fold", ["prefix", "costs", "one"])
@pytest.mark.parametrize("clusters", SHARD_CLUSTERS)
@pytest.mark.parametrize("nb", [16, 1])
def test_frame_start_shard_local_kernel_matches_plain(card, nb, clusters, fold):
    """K3's shard first-frame mode with K8's local half of the start state
    as its last step against ``frame_start_shard_plain`` then
    ``global_cutoff_local_plain`` on CPU copies, bitwise, at its own
    cluster size (more than one block a row at B = 16) and at 8, 4, 2 and
    1 blocks a row, from outputs set to the bit complement of plain's: the
    slots, the table, the local half's best cost and count and its prefix
    (m 700: ``prefix``; m 1: ``one``; none of its own at m == K:
    ``costs``).  The start costs are unsorted: +0.0 in one block's slot
    range before -0.0 in a later block's (the first keeps its +0.0 bits)
    on even rows, -0.0 before +0.0 on odd rows, one row all +inf and one
    with a single finite cost; one launch counted, K8's local half none."""
    from kaldi_decoder_tpu_torch.decoders.frontier import StepState
    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        empty_cutoff_local,
        global_cutoff_local,
        global_cutoff_local_plain,
    )
    from kaldi_decoder_tpu_torch.kernels.frame import (
        FrameIO,
        ShardSlots,
        empty_shard_outs,
        frame_start,
        frame_start_shard,
        frame_start_shard_plain,
        start_cluster_size,
    )

    rng = np.random.default_rng(nb + 7 * clusters + len(fold))
    K, Vs, T = 2048, 500, 3
    m = {"prefix": 700, "costs": K, "one": 1}[fold]
    costs = rng.uniform(0.5, 9, size=(nb, K)).astype(np.float32)
    costs[rng.random((nb, K)) < 0.3] = np.inf
    for b in range(nb):
        zeros = (0.0, -0.0) if b % 2 == 0 else (-0.0, 0.0)
        costs[b, K // 8], costs[b, K - K // 8] = np.float32(zeros[0]), np.float32(zeros[1])
    if nb > 2:
        costs[1] = np.inf
        costs[2] = np.inf
        costs[2, K - 5] = 4.25
    st0 = StepState(torch.from_numpy(rng.integers(0, 9000, (nb, K)).astype(np.int32)),
                    torch.from_numpy(costs),
                    torch.from_numpy(rng.uniform(-50, 0, nb).astype(np.float32)))
    io_cpu = FrameIO(torch.from_numpy(rng.uniform(-9, 0, (T, nb, Vs)).astype(np.float32)),
                     torch.from_numpy(rng.integers(0, T + 1, nb).astype(np.int32)), st0,
                     empty_shard_outs(T, nb, K, 1, False, "cpu"))
    want = frame_start_shard_plain(io_cpu)
    ref = global_cutoff_local_plain(st0.costs, m)
    if fold == "costs":
        ref = ref._replace(prefix=None)
    io = FrameIO(io_cpu.scores.to(card), io_cpu.lengths.to(card),
                 StepState(*(x.to(card) for x in st0)),
                 empty_shard_outs(T, nb, K, 1, False, card))
    slots = ShardSlots(nb, K, Vs, card)
    for dst, src in zip(slots.state, want.state):
        dst.view(torch.int32).copy_(~src.view(torch.int32))
    local = empty_cutoff_local(nb, m, card)
    if fold == "costs":
        local = local._replace(prefix=None)
    for dst, src in zip(local, ref):
        if dst is not None:
            dst.view(torch.int32).copy_(~src.view(torch.int32))
    before, k8 = frame_start.launches, global_cutoff_local.launches
    frame_start_shard(slots, io, local=local, clusters=clusters)
    torch.cuda.synchronize()
    assert frame_start.launches == before + 1 and global_cutoff_local.launches == k8
    for name, w, g in zip(want.state._fields, want.state, slots.state):
        _same_bits(w, g.cpu(), f"state.{name}")
    _same_bits(want.lengths, slots.lengths.cpu(), "lengths")
    _same_bits(want.scores_t, slots.scores_t.cpu(), "scores row 0")
    words = slots.args.tolist()
    assert words[:3] == [0, 0, T] and words[3] == io.scores.data_ptr()
    assert words[4:4 + len(io.outs)] == [x.data_ptr() for x in io.outs]
    for name, w, g in zip(ref._fields, ref, local):
        if w is not None:
            _same_bits(w, g.cpu(), f"local.{name}")
    assert not np.signbit(local.best[0].item()) and local.best[0].item() == 0.0
    if nb > 1:
        assert np.signbit(local.best[-1].item())
    if nb == 16 and clusters == 0:
        assert start_cluster_size(nb, K) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("fold", [None, "prefix", "costs"])
@pytest.mark.parametrize("clusters", SHARD_CLUSTERS)
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
@pytest.mark.parametrize("nb", [16, 1])
def test_frame_tail_shard_kernel_matches_plain(card, nb, lattice, clusters, fold):
    """K3's shard mode against ``frame_tail_shard_plain`` over two frames
    of one chunk begun by its first-frame mode on the slots: row t of every
    stacked output (written through the table's pointers) and the state
    written in place, bitwise, the next scores row copied into the slot, t
    advanced and the count cleared; row 0 freezes after the first frame
    (at B = 1 it is live, then frozen), row 1 has no token on any rank (best +inf); at
    the kernel's own cluster size (more than one block a row at B = 16)
    and at 8, 4, 2 and 1 blocks a row.  With ``fold``, K8's local half of
    the next frame folded in (from the eps closure's first smallest
    costs, with -0.0 against +0.0 and a row with none), bitwise against
    plain's and against K8's plain local half of the new costs: its best
    cost and count, and a prefix of m 700 (``prefix``) or none, the costs
    being the prefix at m == K (``costs``)."""
    from kaldi_decoder_tpu_torch.decoders.frontier import StepState
    from kaldi_decoder_tpu_torch.kernels.cutoff import first_min_count, global_cutoff_local_plain
    from kaldi_decoder_tpu_torch.kernels.frame import (
        FrameIO,
        ShardSlots,
        ShardTailInputs,
        empty_shard_outs,
        frame_start_shard,
        frame_tail,
        frame_tail_shard,
        frame_tail_shard_plain,
        shard_cluster_size,
    )

    rng = np.random.default_rng(nb + 100 * lattice)
    K, D, R, Re, T, my_base, Vs = 2048, 1, 4096, 1536, 4, 2048, 500
    N = 2 * 30720
    if nb == 16 and clusters == 0:
        assert shard_cluster_size(nb, K) > 1
    f32 = dict(dtype=torch.float32, device=card)

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, size=shape).astype(np.int32)).to(card)

    st0 = StepState(ints(0, 9000, (nb, K)),
                    torch.from_numpy(np.sort(rng.uniform(0, 9, size=(nb, K)), axis=1)
                                     .astype(np.float32)).to(card),
                    torch.from_numpy(rng.uniform(-50, 0, size=nb).astype(np.float32))
                    .to(card))
    ref_st = StepState(*(x.clone() for x in st0))  # plain's carried state
    outs = empty_shard_outs(T, nb, K, D, lattice, card, R, Re)
    for x in outs:
        x.zero_()
    lengths = torch.full((nb,), T, dtype=torch.int32, device=card)
    lengths[0] = 1
    scores = torch.from_numpy(rng.uniform(-9, 0, size=(T, nb, Vs)).astype(np.float32)).to(card)
    slots = ShardSlots(nb, K, Vs, card)
    frame_start_shard(slots, FrameIO(scores, lengths, st0, outs))
    m = {None: 0, "prefix": 700, "costs": K}[fold]
    locs = [None, None]
    if fold:
        loc = global_cutoff_local_plain(st0.costs, m)
        if fold == "costs":
            loc = loc._replace(prefix=None)
        locs = [type(loc)(*(None if x is None else x.clone() for x in loc)) for _ in range(2)]
    for t in range(2):
        mid_c = np.sort(rng.uniform(-1, 9, size=(nb, K)).astype(np.float32), axis=1)
        mid_c[:, K - 300:] = np.inf
        if nb > 2:
            mid_c[2, :40] = np.where(rng.random(40) < 0.5, -0.0, 0.0)  # zeros of both signs
            mid_c[2, 0] = -0.0 if t == 0 else 0.0
            mid_c[2, 40:K - 300] = np.sort(rng.uniform(0.25, 9, size=K - 340))
            mid_c[3] = np.inf  # no finite cost on this rank
        best = mid_c[:, 0] + rng.uniform(-0.5, 0, size=nb).astype(np.float32)
        if nb > 2:
            best[2] = 0.0
            best[3] = mid_c[0, 0]
        if nb > 1:
            best[1] = np.inf
        extra = {}
        if lattice:
            extra = dict(em_records=ints(-1, 1 << 20, (nb, R, 4)),
                         eps_records=ints(-1, 1 << 20, (nb, D, Re, 2)))
        else:
            cand = ints(-1, N, (nb, K))
            extra = dict(cand_idx=cand, gslot=ints(0, 4096, (nb, N)),
                         arc=ints(-1, 1 << 20, (nb, N)),
                         bp_eps=ints(-1, 4096, (nb, D, K, 2)))
        if fold:
            red_min, red_count = first_min_count(torch.from_numpy(mid_c))
            extra.update(red_min=red_min.to(card), red_count=red_count.to(card))
        tin = ShardTailInputs(ints(0, 9000, (nb, K)), torch.from_numpy(mid_c).to(card),
                              torch.from_numpy(best).to(card), ints(0, 4 * K, (nb,)),
                              torch.tensor([t, 1 - t], dtype=torch.int32, device=card),
                              **extra)
        cutoff = torch.from_numpy(rng.uniform(5, 15, size=nb).astype(np.float32)).to(card)
        final, want, nxt = frame_tail_shard_plain(ref_st, cutoff, tin, lengths > t, my_base,
                                                  locs[0])
        before = frame_tail.launches
        frame_tail_shard(slots, cutoff, tin, my_base, clusters=clusters, local=locs[1])
        torch.cuda.synchronize()
        assert frame_tail.launches == before + 1
        for name, w, g in zip(final._fields, final, slots.state):
            _same_bits(w, g, f"frame {t}: state.{name}")
        for name, w, g in zip(want._fields, want, outs):
            _same_bits(w, g[t], f"frame {t}: {name}")
        _same_bits(scores[t + 1], slots.scores_t, f"frame {t}: the next scores row")
        assert slots.args[:3].tolist() == [t + 1, 0, T]
        if fold:
            fresh = global_cutoff_local_plain(final.costs, m)
            for name, w, g, f in zip(nxt._fields, nxt, locs[1], fresh):
                if w is not None:
                    _same_bits(w, g, f"frame {t}: local.{name}")
                    _same_bits(f, g, f"frame {t}: local.{name} against K8's local half")
            locs[0] = nxt
        for dst, src in zip(ref_st, final):
            dst.copy_(src)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [5, 1, 0])
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
@pytest.mark.parametrize("nb", [16, 1])
def test_frame_start_shard_kernel_matches_plain(card, nb, lattice, frames):
    """K3's shard mode's first-frame mode against
    ``frame_start_shard_plain``, bitwise: the slots' state, row lengths
    and scores row (kept where the chunk has no frame) and every word of
    the table (t 0, no row done, the frame count, the scores' and each
    output's address, 0 past the last); one launch counted."""
    from kaldi_decoder_tpu_torch.decoders.frontier import StepState
    from kaldi_decoder_tpu_torch.kernels.frame import (
        FrameIO,
        ShardSlots,
        empty_shard_outs,
        frame_start,
        frame_start_shard,
        frame_start_shard_plain,
    )

    rng = np.random.default_rng(nb + 10 * frames + lattice)
    K, D, Vs = 2048, 1, 500
    slots = ShardSlots(nb, K, Vs, card)
    slots.args.fill_(-7)  # a table left by an earlier chunk
    slots.scores_t.fill_(3.5)
    costs = rng.uniform(0, 9, size=(nb, K)).astype(np.float32)
    costs[:, 5] = -0.0
    costs[:, K // 2:] = np.inf
    st0 = StepState(torch.from_numpy(rng.integers(0, 9000, (nb, K)).astype(np.int32)).to(card),
                    torch.from_numpy(costs).to(card),
                    torch.from_numpy(rng.uniform(-50, 0, nb).astype(np.float32)).to(card))
    io = FrameIO(torch.from_numpy(rng.uniform(-9, 0, (frames, nb, Vs)).astype(np.float32)).to(card),
                 torch.from_numpy(rng.integers(0, frames + 1, nb).astype(np.int32)).to(card), st0,
                 empty_shard_outs(frames, nb, K, D, lattice, card, 4096, 1536))
    want = frame_start_shard_plain(io)
    before = frame_start.launches
    frame_start_shard(slots, io)
    torch.cuda.synchronize()
    assert frame_start.launches == before + 1
    for name, w, g in zip(want.state._fields, want.state, slots.state):
        _same_bits(w, g, f"state.{name}")
    _same_bits(want.lengths, slots.lengths, "lengths")
    _same_bits(want.scores_t if frames else torch.full_like(slots.scores_t, 3.5),
               slots.scores_t, "scores row 0")
    assert slots.args.tolist() == want.args.tolist()
    assert slots.io is io


@pytest.fixture
def nccl_group(card):
    """A process group of this process alone over NCCL (P = 1), shut down
    after the test (the sharded frame drivers released first)."""
    import socket

    import torch.distributed as dist

    from kaldi_decoder_tpu_torch.parallel import initialize_distributed, shutdown_distributed

    if dist.is_initialized():
        pytest.skip("a process group is already made in this process")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    initialize_distributed(backend="nccl", init_method=f"tcp://localhost:{port}", rank=0,
                           world_size=1)
    yield
    shutdown_distributed()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["viterbi", "lattice"])
def test_shard_driver_graph_matches_loop(card, nccl_group, kind):
    """The sharded decoders at P = 1 over NCCL: two decodes of other
    lengths on one decoder replayed from the sharded frame driver's
    captured graph, against the same decodes as the host loop
    (``driver.eager_frames``), bitwise in every field of the results; the
    graph's decodes count the loop's launches of every kernel and its
    collective calls by kind (a replay adds what the capture holds), and
    every frame but the driver's first is a replay."""
    from kaldi_decoder_tpu_torch.decoders import driver
    from kaldi_decoder_tpu_torch.kernels.cutoff import global_cutoff_local
    from kaldi_decoder_tpu_torch.kernels.frame import frame_start
    from kaldi_decoder_tpu_torch.parallel import (
        ShardedLatticeDecoder,
        ShardedViterbiDecoder,
        make_mesh,
    )
    from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls
    from kaldi_decoder_tpu_torch.parallel.shard_driver import COUNTED

    g = _eps_graph(1)
    fc = config_for_graph(g, frontier_size=64, max_active=48, beam=10.0, rem_budget=4096)
    mesh = make_mesh(1, "model", device_type="cuda")
    rng = np.random.default_rng(3)
    decodes = [(np.log(rng.dirichlet(np.ones(V), size=(4, T))).astype(np.float32),
                np.array(lens, np.int32)) for T, lens in ((20, [20, 7, 13, 0]), (11, [3, 11, 11, 9]))]
    counted = COUNTED + (frame_start, global_cutoff_local)
    fields = (("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
               "num_active", "best_costs", "cutoffs", "overflows", "saturations")
              if kind == "viterbi" else
              ("init_states", "init_costs", "init_eps_records", "frame_states", "frame_costs",
               "em_records", "eps_records", "num_active", "cutoffs", "overflows", "saturations"))
    runs = []
    for eager in (True, False):
        if kind == "viterbi":
            dec = ShardedViterbiDecoder(g, fc, mesh=mesh, pad_time_to=8, device=card)
        else:
            dec = ShardedLatticeDecoder(g, fc, lattice_beam=5.0, mesh=mesh, em_records=512,
                                        eps_records=256, pad_time_to=8, device=card)
        per = []
        for scores, lengths in decodes:
            n0, r0 = [f.launches for f in counted], driver.replays
            collective_calls.clear()
            with driver.eager_frames() if eager else contextlib.nullcontext():
                res = dec.decode(scores, lengths)
            torch.cuda.synchronize()
            per.append((res, [f.launches - n for f, n in zip(counted, n0)],
                        dict(collective_calls), driver.replays - r0))
        runs.append(per)
    for i, ((re_, ne, ce, _), (rg, ng, cg, replays)) in enumerate(zip(*runs)):
        for f in fields:
            a, b = np.asarray(getattr(re_, f)), np.asarray(getattr(rg, f))
            if a.dtype == np.float32:
                a, b = a.view(np.int32), b.view(np.int32)
            assert np.array_equal(a, b), (i, f)
        assert ng == ne, (i, ng, ne)
        assert cg == ce, (i, cg, ce)
        frames = rg.num_active.shape[0]
        assert replays == frames - (1 if i == 0 else 0), (i, replays, frames)
        # The first-frame mode once a chunk, with K8's local half of the
        # start state as its last step: K8's local half never alone.
        assert ng[-2:] == [1, 0]


def _route_cluster_cases():
    """(clusters, N) for K7's send side forced to each cluster size: the
    shard shapes, and N at and one past the lanes a cluster of that size
    keeps in shared memory (the switch to the scratch rows)."""
    from kaldi_decoder_tpu_torch.kernels.route import SMEM_LANES

    return [(g, n) for g in (1, 2, 4, 8) for n in (3072, 30720, SMEM_LANES * g, SMEM_LANES * g + 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [None, SHARD_SLACK], ids=["leaders", "slack"])
@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("clusters,N", _route_cluster_cases(),
                         ids=[f"G{g}-N{n}" for g, n in _route_cluster_cases()])
def test_route_send_kernel_every_cluster_size(card, clusters, N, P, beam):
    """K7's send side at each cluster size it can take (forced), against
    ``route_send_plain`` bitwise at B=16: ±0 and exact-cost ties, lanes
    either side of the slack beam, an all-invalid row; cap at N, at the
    fullest bucket exactly and one under; the filter and offsets folded
    or not."""
    from kaldi_decoder_tpu_torch.kernels.route import (
        empty_route_send,
        route_send,
        route_send_plain,
    )

    nb = 16
    dst, cost, src, arc, sp = _route_lanes(7 * N + P + clusters, nb, N, P)
    t = [torch.from_numpy(x).to(card) for x in (dst, cost, src, arc)]
    rng = np.random.default_rng(N + clusters)
    cutoff = torch.from_numpy(rng.uniform(0.0, 12.0, size=nb).astype(np.float32)).to(card)
    cutoff[0] = float("inf")
    states = torch.from_numpy(rng.integers(0, sp, size=(nb, 2048)).astype(np.int32)).to(card)
    full = route_send_plain(*t, sp, P, N, beam)
    most = int((full.buf[..., 1] != np.float32(np.inf).view(np.int32)).sum(dim=2).max())
    for cap in (N, most, most - 1):
        out = empty_route_send(nb, N, P, cap, card)
        for folded in (False, True):
            kw = dict(cutoff=cutoff, slot_states=states, slot_add=7 * P, arc_add=-3) \
                if folded else {}
            want = route_send_plain(*t, sp, P, cap, beam, **kw)
            before = route_send.launches
            got = route_send(*t, sp, P, cap, beam, **kw, out=out, clusters=clusters)
            torch.cuda.synchronize()
            assert route_send.launches == before + 1
            where = f"cap {cap}, folded {folded}"
            _same_bits(want.buf, got.buf, f"send buffer, {where}")
            _same_bits(want.overflow, got.overflow, f"overflow, {where}")
            if cap == most - 1 and not folded:
                assert bool(got.overflow.any()), "a bucket must overflow"
            if cap == most and not folded:
                assert not bool(got.overflow.any()), "the fullest bucket fits exactly"


def _hub_lanes(seed, nb, N, P):
    """(dst, cost, src, arc, sp) lanes with long (owner, state) runs:
    row 0 sends ``hub`` lanes (4,096 at N 30,720) to one state with costs
    falling in lane order, row 1 the same lanes at -0.0 and +0.0 (every
    fifth at 1.5), row 2 every lane to one state, row 3 all lanes to eight
    states, interleaved (N / 8 lanes a run), row 4 the hub with costs
    rising by a step that keeps every lane within the slack beam, and rows
    5 and 6 one run of 128 lanes and one of 129, their costs shuffled
    within the slack beam (ranks out of lane order); the other rows as
    ``_route_lanes``."""
    dst, cost, src, arc, sp = _route_lanes(seed, nb, N, P)
    rng = np.random.default_rng(seed + 1)
    hub = min(4096, 2 * N // 3)
    at = np.sort(rng.choice(N, size=hub, replace=False))
    state = P * sp - 3  # the last owner's
    dst[0, at] = state
    cost[0, at] = np.linspace(40.0, -2.0, hub, dtype=np.float32)
    dst[1, at] = state
    cost[1, at] = np.where(at % 3 == 0, -0.0, 0.0)
    cost[1, at[::5]] = 1.5
    dst[2] = 7
    cost[2] = np.where(np.isfinite(cost[2]), cost[2], 3.0)
    dst[3] = rng.integers(0, 8, size=N) * (P * sp // 8)
    dst[4, at] = state // 2
    cost[4, at] = np.float32(1.0) + np.arange(hub, dtype=np.float32) * np.float32(SHARD_SLACK / hub)
    for r, run in ((5, 128), (6, 129)):
        dst[r, dst[r] == state] = 0
        lanes = np.sort(rng.choice(N, size=run, replace=False))
        dst[r, lanes] = state
        cost[r, lanes] = rng.permutation(np.linspace(0.5, 0.5 + SHARD_SLACK, run, dtype=np.float32))
    return dst, cost, src, arc, sp


@pytest.mark.cuda
@pytest.mark.parametrize("beam", [None, SHARD_SLACK], ids=["leaders", "slack"])
@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("N", [30720, 3072])
@pytest.mark.parametrize("clusters", [1, 2, 4, 8])
def test_route_send_kernel_long_runs(card, clusters, N, P, beam):
    """K7's send side on (owner, state) runs of thousands of lanes (a hub
    state: falling costs, exact and ±0 ties, a whole row, runs crossing
    every block of the cluster, a run wholly within the slack beam) at
    each cluster size, against ``route_send_plain`` bitwise at B=8: cap at
    N, at the fullest bucket exactly and one under; filter folded or not."""
    from kaldi_decoder_tpu_torch.kernels.route import (
        empty_route_send,
        route_send,
        route_send_plain,
    )

    nb = 8
    dst, cost, src, arc, sp = _hub_lanes(11 * N + P + clusters, nb, N, P)
    t = [torch.from_numpy(x).to(card) for x in (dst, cost, src, arc)]
    cutoff = torch.full((nb,), 30.0, dtype=torch.float32, device=card)
    full = route_send_plain(*t, sp, P, N, beam)
    most = int((full.buf[..., 1] != np.float32(np.inf).view(np.int32)).sum(dim=2).max())
    for cap in (N, most, most - 1):
        out = empty_route_send(nb, N, P, cap, card)
        for folded in (False, True):
            kw = dict(cutoff=cutoff, slot_add=5, arc_add=2) if folded else {}
            want = route_send_plain(*t, sp, P, cap, beam, **kw)
            got = route_send(*t, sp, P, cap, beam, **kw, out=out, clusters=clusters)
            torch.cuda.synchronize()
            where = f"cap {cap}, folded {folded}"
            _same_bits(want.buf, got.buf, f"send buffer, {where}")
            _same_bits(want.overflow, got.overflow, f"overflow, {where}")
            if cap == most - 1 and not folded:
                assert bool(got.overflow.any()), "a bucket must overflow"


@pytest.mark.cuda
def test_route_send_cluster_choice(card):
    """The cluster sizes K7's send side picks: the largest that fits, at
    most one block per MIN_LANES lanes (4 at the eps shape, N 3,072; 8 at
    the emitting shape, N 30,720)."""
    from kaldi_decoder_tpu_torch.kernels.route import MIN_LANES, send_cluster_size

    assert send_cluster_size(3072) == 4
    assert send_cluster_size(2 * MIN_LANES - 1) == 1
    assert send_cluster_size(30720) == 8


def _cutoff_shards(rng, P, nb, K, max_active):
    """P shards' (nb, K) cost rows, each in IEEE total order: random costs
    on a 0.25 grid with +inf tails; -0.0 and +0.0 ties at the order
    statistics; an all-+inf row; counts of exactly max_active and one
    above; negative costs with ties."""
    rows = np.full((P, nb, K), np.inf, np.float32)
    for q in range(P):
        n = int(rng.integers(K // 2, K + 1))
        rows[q, :, :n] = rng.integers(-8, 80, size=(nb, n)) * 0.25
        z = int(rng.integers(min(K - 1, max_active // P + 2), K))
        rows[q, 1 % nb, :z] = np.where(rng.random(z) < 0.5, -0.0, 0.0)
    if nb > 2:
        rows[:, 2] = np.inf
    for r, total in ((3, max_active), (4, max_active + 1)):
        if r < nb:
            total = min(total, P * K)
            rows[:, r] = np.inf
            for q in range(P):
                c = total // P + (q < total % P)
                rows[q, r, :c] = rng.uniform(-1.0, 8.0, size=c)
    u = rows.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000)
    return np.take_along_axis(rows, np.argsort(key, axis=2, kind="stable"), axis=2)


CUTOFF_CONFIGS = {  # name -> (beam, max_active, min_active, beam_delta), given P and K
    "max_active": lambda P, K: (15.0, min(2560, P * K - 1), 200, 0.5),
    "min_active": lambda P, K: (0.5, P * K - 1, min(200, K - 2), 0.25),
    "min_active_0": lambda P, K: (15.0, min(2560, P * K - 1), 0, 0.5),
    "clamp": lambda P, K: (30.0, P * K + 3, 4, 0.5),
    "early": lambda P, K: (15.0, P * K, 0, 0.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUTOFF_CONFIGS))
@pytest.mark.parametrize("P,K", [(1, 2048), (2, 2048), (4, 2048), (64, 128)])
@pytest.mark.parametrize("nb", [16, 1])
def test_global_cutoff_kernels_match_plain(card, nb, P, K, name):
    """K8's local half (each shard) and merge against their plain versions
    run on CPU copies of the same inputs, bitwise: the best cost, count
    and prefix; the cutoff and adaptive beam, the early return included."""
    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        empty_cutoff,
        empty_cutoff_local,
        global_cutoff_local,
        global_cutoff_local_plain,
        global_cutoff_merge,
        global_cutoff_merge_plain,
    )

    beam, max_active, min_active, beam_delta = CUTOFF_CONFIGS[name](P, K)
    early = max_active >= P * K and min_active == 0
    m = 1 if early else min(max(max_active, min_active) + 1, K)
    rng = np.random.default_rng(P * 1000 + K + nb + len(name))
    shards = _cutoff_shards(rng, P, nb, K, max_active)
    locs = []
    out = empty_cutoff_local(nb, m, card)
    for q in range(P):
        costs = torch.from_numpy(shards[q])
        want = global_cutoff_local_plain(costs, m)
        before = global_cutoff_local.launches
        got = global_cutoff_local(costs.to(card), m, out=out)
        torch.cuda.synchronize()
        assert global_cutoff_local.launches == before + 1
        for field, w, g in zip(want._fields, want, got):
            _same_bits(w, g.cpu(), f"shard {q}: {field}")
        locs.append(want)
    best = locs[0].best
    for loc in locs[1:]:
        best = torch.minimum(best, loc.best)
    count = merged = None
    if not early:
        count = sum(loc.count for loc in locs).to(torch.int32)
        merged = torch.stack([loc.prefix for loc in locs])
    want = global_cutoff_merge_plain(best, count, merged, beam, beam_delta, max_active,
                                     min_active)
    before = global_cutoff_merge.launches
    got = global_cutoff_merge(best.to(card), None if early else count.to(card),
                              None if early else merged.to(card), beam, beam_delta, max_active,
                              min_active, out=empty_cutoff(nb, card))
    torch.cuda.synchronize()
    assert global_cutoff_merge.launches == before + 1
    _same_bits(want.cutoff, got.cutoff.cpu(), "cutoff")
    _same_bits(want.adaptive_beam, got.adaptive_beam.cpu(), "adaptive beam")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["max_active", "min_active", "clamp"])
@pytest.mark.parametrize("m", [4096, 2048, 1000, 3])
@pytest.mark.parametrize("P", [1, 2, 4, 8])
def test_global_cutoff_merge_kernel_shapes(card, P, m, name):
    """K8's merge (staged in shared memory at P >= 2) against
    ``global_cutoff_merge_plain`` on CPU copies, bitwise, at B 16, P 1 to
    8 and prefixes of up to 4096 costs (128 KB a row at P = 8): the shards
    of :func:`_cutoff_shards` (-0.0 and +0.0 ties at the order statistics,
    an all-+inf row, counts at max_active and one above) with every key of
    row 0 in every shard (ties across shards)."""
    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        global_cutoff_merge,
        global_cutoff_merge_plain,
    )

    beam, max_active, min_active, beam_delta = CUTOFF_CONFIGS[name](P, m)
    rng = np.random.default_rng(P * 7 + m)
    merged = _cutoff_shards(rng, P, 16, m, max_active)
    merged[:, 0] = merged[0, 0]
    merged = torch.from_numpy(np.ascontiguousarray(merged))
    count = torch.isfinite(merged).sum(dim=(0, 2), dtype=torch.int32)
    best = torch.where(torch.isfinite(merged), merged, np.inf).amin(dim=(0, 2))
    want = global_cutoff_merge_plain(best, count, merged, beam, beam_delta, max_active,
                                     min_active)
    got = global_cutoff_merge(best.to(card), count.to(card), merged.to(card), beam, beam_delta,
                              max_active, min_active)
    torch.cuda.synchronize()
    _same_bits(want.cutoff, got.cutoff.cpu(), "cutoff")
    _same_bits(want.adaptive_beam, got.adaptive_beam.cpu(), "adaptive beam")


@pytest.mark.cuda
def test_global_cutoff_merge_kernel_refuses_past_shared_memory(card):
    """A row of P*m costs past what a block's shared memory holds (P = 2,
    m 32,768: 256 KB) raises, and launches nothing; P = 1 at that width
    needs no stage and runs."""
    from kaldi_decoder_tpu_torch.kernels.cutoff import (
        global_cutoff_merge,
        global_cutoff_merge_plain,
    )

    m = 32768
    rng = np.random.default_rng(5)
    merged = torch.from_numpy(np.ascontiguousarray(_cutoff_shards(rng, 2, 2, m, 100)))
    count = torch.isfinite(merged).sum(dim=(0, 2), dtype=torch.int32)
    best = torch.where(torch.isfinite(merged), merged, np.inf).amin(dim=(0, 2))
    before = global_cutoff_merge.launches
    with pytest.raises(RuntimeError, match="kd_cutoff_merge launch failed"):
        global_cutoff_merge(best.to(card), count.to(card), merged.to(card), 15.0, 0.5, 100, 20)
    torch.cuda.synchronize()
    assert global_cutoff_merge.launches == before
    one = merged[:1]
    want = global_cutoff_merge_plain(best, count, one, 15.0, 0.5, 100, 20)
    got = global_cutoff_merge(best.to(card), count.to(card), one.to(card), 15.0, 0.5, 100, 20)
    torch.cuda.synchronize()
    _same_bits(want.cutoff, got.cutoff.cpu(), "cutoff")
    _same_bits(want.adaptive_beam, got.adaptive_beam.cpu(), "adaptive beam")
