"""The CUDA kernels against their plain torch versions, on the card.

These need an NVIDIA card with ``nvcc`` (the kernels are built for
``sm_90a``; a CUDA kernel has no CPU interpret mode), so they carry the
``cuda`` marker and skip elsewhere.  The file imports nothing of JAX, so
on a machine without it run
``python -m pytest --noconftest tests/test_torch_kernels.py -q``.  The CPU
side of the same wrappers is covered by ``tests/test_torch_ops.py`` and
``tests/test_torch_gather.py``.
"""

import numpy as np
import pytest
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.decoders.lattice import BatchedLatticeDecoder
from kaldi_decoder_tpu_torch.decoders.lattice_dev import (
    lattice_chunk,
    lattice_frame_step_batched,
)
from kaldi_decoder_tpu_torch.decoders.sweep import sweep_config, sweep_plain
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain
from kaldi_decoder_tpu_torch.kernels.sweep import sweep_chunk
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
from kaldi_decoder_tpu_torch.ops.segment import dedup_select as dedup_select_plain

B, T, V = 3, 24, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _graph(seed=0, S=400, E=3000):
    """Random eps-free graph with a few hub states, so fat states use the
    remainder lanes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, S, E)
    src[: E // 5] = rng.integers(0, 8, E // 5)
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


def _decoder(device, rem_budget):
    g = _graph()
    fc = config_for_graph(g, frontier_size=64, max_active=48, beam=10.0,
                          rem_budget=rem_budget)
    return BatchedLatticeDecoder(g, fc, lattice_beam=5.0, em_records=512,
                                 pad_time_to=8, device=device)


def _scores(device):
    rng = np.random.default_rng(1)
    s = np.log(rng.dirichlet(np.ones(V), size=(T, B))).astype(np.float32)
    return torch.from_numpy(s).to(device)  # time-major (T, B, V)


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
@pytest.mark.parametrize("rem_budget", [4096, 16])  # 16: remainder overflow
def test_expand_kernel_matches_plain(card, rem_budget):
    dec = _decoder(card, rem_budget)
    fc = dec.cfg.frontier
    st, _, _ = dec._init(B)
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
    st0, _, _ = dec._init(B)
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
    st, _, _ = dec._init(B)
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


def _dedup_inputs(seed, N, K, S, n_valid, incumbents):
    """(B, N) lanes with quantised costs (ties), a -0.0 cost, garbage
    states on invalid lanes and, with ``incumbents``, a sorted frontier
    in the first K lanes."""
    rng = np.random.default_rng(seed)
    states = rng.integers(0, S, (B, N)).astype(np.int32)
    costs = np.full((B, N), np.inf, np.float32)
    lo = K if incumbents else 0
    for b in range(B):
        lanes = lo + rng.choice(N - lo, size=min(n_valid, N - lo), replace=False)
        costs[b, lanes] = rng.integers(0, 40, len(lanes)) * 0.25
        costs[b, lanes[0]] = -0.0
    states[~np.isfinite(costs)] = rng.integers(-5, 10 * S, int((~np.isfinite(costs)).sum()))
    if incumbents:
        for b in range(B):
            n = K // 2 + b
            st = rng.choice(S, size=n, replace=False)
            co = np.sort(rng.integers(0, 20, n) * 0.25).astype(np.float32)
            order = np.lexsort((st, co))
            states[b, :K], costs[b, :K] = 0, np.inf
            states[b, :n], costs[b, :n] = st[order], co[order]
    return states, costs


@pytest.mark.cuda
@pytest.mark.parametrize("N,K,S,n_valid,incumbents", [
    (3000, 64, 500, 2500, False),  # more states than K: radix select
    (3000, 64, 500, 40, False),  # fewer states than K
    (3000, 64, 500, 2500, True),  # incumbents first (an eps iteration)
    (20, 64, 500, 15, False),  # fewer lanes than K
    (5000, 4096, 100, 4000, False),  # fewer states than lanes, K > S
    (60000, 4096, 102298, 50000, False),  # the bench's emitting shape
])
def test_dedup_kernel_matches_plain(card, N, K, S, n_valid, incumbents):
    states, costs = _dedup_inputs(N + K, N, K, S, n_valid, incumbents)
    st, co = torch.from_numpy(states).to(card), torch.from_numpy(costs).to(card)
    ref = dedup_select_plain(st, co, K, S)
    before = dedup_select.launches
    for _ in range(2):  # a second call gives the same result
        got = dedup_select(st, co, K, S)
        torch.cuda.synchronize()
        assert torch.equal(ref.states, got.states)
        assert torch.equal(_bits(ref.costs), _bits(got.costs))
        assert torch.equal(ref.cand_idx, got.cand_idx)
        assert torch.equal(ref.num_unique, got.num_unique)
    assert dedup_select.launches == before + 2
