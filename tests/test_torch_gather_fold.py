"""The contract that lets K1 read em_block rows itself, on the CPU.

K1 (``csrc/expand.cu``) no longer takes a gathered row per frontier slot:
it reads the row of each active slot among the first ``expand_lanes``
itself, and never the state of an inactive slot or of a slot at
``expand_lanes`` or beyond.  That is sound only if no output depends on
those states, which the reference's ``safe = where(active, states, 0)``
promises.  Here the frontier's unread states are set to -1 and to S + 7:
the port's plain version must give what it gives on the frontier as it is,
and both must equal the JAX package's ``expand_emitting`` and beam filter
on the same poisoned inputs.  The ``cuda`` twins of these cases are in
``tests/test_torch_kernels.py``.

The standalone row gather's plain version, the CPU side of
``csrc/gather.cu``, is held against ``torch.index_select`` and against the
Pallas gathers of ``scripts/`` in interpret mode, at the row widths of
em_block (11) and of the TPU experiments' (S, 16) table, and at row counts
below, just under and just over one warp's tile of 32 rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxDecoder
from kaldi_decoder_tpu.fst.pack import pack_graph_device as jax_pack
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.fst.pack import packed_from_numpy
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter, expand_filter_plain
from kaldi_decoder_tpu_torch.kernels.gather import row_gather, row_gather_plain
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

from _torch_util import assert_same_config, bits, small_hlg, twin_configs
from test_torch_gather import _script
from test_torch_ops import _frontier, _jax_expand_filter

K = 64
V = 12
# Live slots per utterance, cycled: full rows (slots past max_active, or
# past the beam, are live but inactive), half rows, and sparse active sets
# of one and of three slots.
N_LIVE = (64, 30, 1, 3, 50, 64, 3, 1)


def _unread(states, costs, cutoff, fc, value):
    """``states`` with every slot K1 must not read set to ``value``: an
    inactive slot's (dead, or at or past the cutoff) and any at
    ``expand_lanes`` or beyond."""
    k = np.arange(states.shape[1])
    read = np.isfinite(costs) & (costs < cutoff[:, None]) & (k < fc.expand_lanes)
    return np.where(read, states, np.int32(value)).astype(np.int32)


@pytest.mark.parametrize("poison", ["minus-one", "past-the-table"])
@pytest.mark.parametrize("with_src_slot", [False, True], ids=["lattice", "src-slot"])
@pytest.mark.parametrize("nb", [1, 16])
@pytest.mark.parametrize("max_active", [40, 64], ids=["ke-below-k", "ke-equal-k"])
def test_expand_filter_unread_states(max_active, nb, with_src_slot, poison):
    rng = np.random.default_rng(max_active + nb)
    _, cg, pgraph = small_hlg()
    jgraph = JaxDecoder(cg, None, pad_time_to=8)._dev_graph
    pdev = fold_eps(pgraph).device
    S = cg.num_states
    jfc, pfc = twin_configs(jgraph, pdev, frontier_size=K, max_active=max_active, beam=8.0,
                            rem_budget=4096)
    assert_same_config(jfc, pfc)
    assert (pfc.expand_lanes < K) == (max_active < K)
    jpg = jax_pack(jgraph, jfc.block_width, jfc.eps_block_width, jfc.flat_group)
    ppg = packed_from_numpy(jpg, "cpu")
    states, costs = _frontier(rng, nb, K, S, [N_LIVE[b % len(N_LIVE)] for b in range(nb)])
    scores = np.log(rng.dirichlet(np.ones(V), size=nb)).astype(np.float32)
    cut = get_cutoff(torch.from_numpy(costs), pfc.beam, pfc.max_active, pfc.min_active,
                     pfc.beam_delta, costs_sorted=True)
    bad = _unread(states, costs, cut.cutoff.numpy(), pfc, -1 if poison == "minus-one" else S + 7)
    assert (bad != states).any()

    def args(st):
        return (torch.from_numpy(st), torch.from_numpy(costs), cut.cutoff, cut.adaptive_beam,
                torch.from_numpy(scores), ppg, pfc)

    want = expand_filter_plain(*args(states), with_src_slot=with_src_slot)
    got = expand_filter_plain(*args(bad), with_src_slot=with_src_slot)
    ref = _jax_expand_filter(
        jnp.asarray(bad), jnp.asarray(costs), jnp.asarray(cut.cutoff.numpy()),
        jnp.asarray(cut.adaptive_beam.numpy()), jnp.asarray(scores), jpg, jfc,
        with_src_slot=with_src_slot,
    )
    ref = dict(zip(("dst", "cost", "src_state", "arc_id", "overflow", "next_cutoff",
                    "src_slot"), ref))
    for name, w, g in zip(got._fields, want, got):
        if w is None:  # src_slot: not asked for
            assert g is None and name not in ref
            continue
        r = np.asarray(ref[name])
        if g.dtype == torch.float32:
            np.testing.assert_array_equal(bits(w.numpy()), bits(g.numpy()), err_msg=name)
            np.testing.assert_array_equal(bits(r), bits(g.numpy()), err_msg=name)
        else:
            np.testing.assert_array_equal(w.numpy(), g.numpy(), err_msg=name)
            np.testing.assert_array_equal(r, g.numpy(), err_msg=name)
    assert torch.isfinite(got.cost).any()
    # The wrapper runs the plain version on CPU tensors and launches nothing.
    before = expand_filter.launches
    wrapped = expand_filter(*args(bad), with_src_slot=with_src_slot)
    assert expand_filter.launches == before == 0
    for a, b in zip(wrapped, got):
        assert (a is None and b is None) or torch.equal(a, b)


def _pallas_block_gather(table, idx):
    """``scripts/gather3_bench.py:block_gather`` (P4) in interpret mode on
    this table: its table shape set to ours, the indices padded to its
    2048-row grid step."""
    g3 = _script("gather3_bench")
    g3.S, g3.WID = table.shape
    pad = np.zeros(-(-len(idx) // 2048) * 2048, np.int32)
    pad[: len(idx)] = idx
    out = g3.block_gather(jnp.asarray(table), jnp.asarray(pad), interpret=True)
    return np.asarray(out)[: len(idx)]


def _pallas_lane_packed(table, idx):
    """``scripts/gather4_bench.py:pallas_gather`` (P5) in interpret mode on
    this table packed eight rows to a group row: (group rows of ``idx``,
    the packed table, its rows per group)."""
    g4 = _script("gather4_bench")
    g4.S, g4.WID = table.shape
    g4.SP = -(-g4.S // g4.G)
    packed = g4.pack_table(table)
    groups = g4.pallas_gather(jnp.asarray(packed), jnp.asarray(idx), ch=len(idx),
                              interpret=True)
    picked = g4.lane_select(groups, jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(picked), table[idx])
    return np.asarray(groups), packed, g4.G


@pytest.mark.parametrize("n", [1, 31, 33])
@pytest.mark.parametrize("width", [11, 16])
def test_row_gather_plain_matches_library_and_pallas(width, n):
    rng = np.random.default_rng(width * 100 + n)
    table = rng.integers(-(1 << 30), 1 << 30, size=(300, width)).astype(np.int32)
    idx = rng.integers(0, 300, size=n).astype(np.int32)
    idx[0] = 299  # the last row
    t, i = torch.from_numpy(table), torch.from_numpy(idx)
    got = row_gather_plain(t, i)
    assert got.dtype == torch.int32 and tuple(got.shape) == (n, width)
    assert torch.equal(got, torch.index_select(t, 0, i))
    np.testing.assert_array_equal(_pallas_block_gather(table, idx), got.numpy())
    groups, packed, G = _pallas_lane_packed(table, idx)
    np.testing.assert_array_equal(
        row_gather_plain(torch.from_numpy(packed), torch.from_numpy(idx // G)).numpy(), groups)
    before = row_gather.launches
    assert torch.equal(row_gather(t, i.reshape(1, n)), got.reshape(1, n, width))
    assert row_gather.launches == before == 0
