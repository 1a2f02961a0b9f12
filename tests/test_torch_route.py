"""K7, the shard route, on the CPU: the port's plain versions against JAX.

``kernels.route.route_send`` and ``route_recv`` on CPU tensors (their
plain versions) against the JAX package's ``parallel.graph_shard._route``
run under ``shard_map`` on the suite's virtual CPU devices, at P = 1, 2
and 4, best-path (no slack beam) and lattice (slack beam 0.5).  The
port's side exchanges in process: rank r receives slice r of every
rank's send buffer, in rank order, as the ``all_to_all`` delivers it.
Inputs are made with numpy from fixed seeds: costs on a 0.25 grid (exact
ties, equal keys in lane order), -0.0 beside +0.0, +inf lanes, a row of
+inf only, costs one float step either side of a run minimum plus the
slack beam (the float32 slack test), one owner's bucket filled to
exactly ``cap`` kept lanes in one row and past it in another.  Every
receive buffer and the overflow flag are compared by raw bits
(tolerance 0).  Also: the beam filter and the payload offsets that the
send side folds in, against JAX's ``_route`` on the lanes the frame used
to filter and offset first; the incumbents-first receive layout
against the concatenation the sharded eps iterations used to build; and
the lane-source map through which a sharded eps iteration's dedup call
reads the received buffer in place (``routed_lanes_plain``) against the
JAX eps iterations' concatenation at P = 1, 2 and 4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch.decoders.frontier import NO_ARC
from kaldi_decoder_tpu_torch.kernels.route import (
    RoutedLanes,
    route_recv,
    route_recv_plain,
    route_send,
    routed_lanes_plain,
)

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

B, N, SP, CAP = 5, 96, 12, 10
SLACK = 0.5


def route_inputs(P, seed=7):
    """Per rank (dst_g, cost, gslot, arc_g), each (B, N): a few states a
    part (long runs), row 0's first lanes crowding owner 0, row 1's owner 0
    holding exactly CAP distinct states, row 2 one more, row B-1 all +inf
    on rank 0."""
    rng = np.random.default_rng(seed + P)
    out = []
    for p in range(P):
        dst = rng.integers(0, P * SP - 3, size=(B, N)).astype(np.int32)
        dst[0, : N // 2] = rng.integers(0, SP, size=N // 2)  # crowd owner 0
        cost = (rng.integers(-2, 6, size=(B, N)) * 0.25).astype(np.float32)
        cost[:, ::7] = -0.0
        cost[:, 3::11] = np.inf
        # Near the slack beam: a run minimum m at lane 1, and m + SLACK and
        # the floats either side of it on the same state.
        for b in range(B):
            m = np.float32(rng.uniform(-1.0, 1.0))
            near = np.float32(m + np.float32(SLACK))
            dst[b, 1:5] = dst[b, 1]
            cost[b, 1:5] = (m, near, np.nextafter(near, np.float32(np.inf)),
                            np.nextafter(near, np.float32(-np.inf)))
        # Owner 0's bucket at exactly CAP kept lanes (row 1), and CAP + 1 (row 2),
        # on every rank: as many distinct states, the row's other lanes +inf.
        for b, n in ((1, CAP), (2, CAP + 1)):
            dst[b, :n] = rng.permutation(SP)[:n]
            cost[b, :n] = rng.integers(0, 6, size=n) * 0.25
            cost[b, n:] = np.inf
        if p == 0:
            cost[B - 1] = np.inf
        gslot = rng.integers(0, 100, size=(B, N)).astype(np.int32)
        arc = rng.integers(0, 1000, size=(B, N)).astype(np.int32)
        out.append((dst, cost, gslot, arc))
    return out


def jax_route(ins, P, beam):
    """JAX's ``_route`` under shard_map over P virtual devices: the five
    fields of ``Routed``, each (P, ...) by rank."""
    mesh = Mesh(np.array(jax.devices()[:P]), ("model",))
    stacked = [np.stack(x) for x in zip(*ins)]  # each (P, B, N)

    def f(d, c, s, a):
        rt = jgs._route(d[0], c[0], s[0], a[0], SP, P, CAP, "model", local_slack_beam=beam)
        return jax.tree.map(lambda x: x[None], tuple(rt))

    spec = JP("model")
    fn = shard_map(f, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 5,
                   check_vma=False)
    return [np.asarray(x) for x in jax.jit(fn)(*map(jnp.asarray, stacked))]


def port_route(sends, P):
    """Each rank's received lanes and overflow from every rank's send."""
    out = []
    for r in range(P):
        recv = torch.stack([s.buf[r] for s in sends])  # slice r of rank p's, p in order
        out.append(tuple(route_recv(recv, SP)) + (sends[r].overflow,))
    return out


def same_bits(want, got, what):
    want, got = np.asarray(want), np.asarray(got)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    if want.dtype == np.float32:
        want, got = want.view(np.int32), got.view(np.int32)
    assert np.array_equal(want, got), what


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("beam", [None, SLACK])
def test_route_matches_jax(P, beam):
    ins = route_inputs(P)
    want = jax_route(ins, P, beam)
    sends = [route_send(*(torch.from_numpy(x) for x in r), SP, P, CAP, beam) for r in ins]
    for r, got in enumerate(port_route(sends, P)):
        for i, name in enumerate(jgs.Routed._fields):
            same_bits(want[i][r], got[i].numpy(), f"rank {r}: {name}")
    # The hard cases are there: both zeros, a full and an overflowing bucket.
    c = ins[0][1]
    assert ((c == 0) & np.signbit(c)).any() and ((c == 0) & ~np.signbit(c)).any()
    ovf = np.stack([s.overflow.numpy() for s in sends])
    assert not ovf[:, 1].any() and ovf[:, 2].all(), ovf
    full = [(s.buf[0, 1, :, 1] != np.float32(np.inf).view(np.int32)).sum() for s in sends]
    assert all(int(x) == CAP for x in full), full


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("beam", [None, SLACK])
def test_route_folds_filter_and_offsets(P, beam):
    """The beam filter (``cost < cutoff``, else +inf) and the payload's
    offsets (``slot_states[src] + slot_add`` or ``src + slot_add``; ``arc +
    arc_add``) folded into the send side equal JAX's ``_route`` on the
    lanes filtered and offset first, as the frame did."""
    rng = np.random.default_rng(21 + P)
    ins = route_inputs(P, seed=3)
    K = 16
    cut = [np.array([0.75, np.inf, 0.0, 1.25, -0.5], np.float32)[:B] for _ in range(P)]
    slot_states = [rng.integers(0, SP, size=(B, K)).astype(np.int32) for _ in range(P)]
    for gather in (False, True):
        jins, sends = [], []
        for p, (dst, cost, _, arc) in enumerate(ins):
            src = rng.integers(0, K, size=(B, N)).astype(np.int32)
            slot_add, arc_add = 100 * p + 3, 1000 * p + 7
            fcost = np.where(cost < cut[p][:, None], cost, np.float32(np.inf))
            slot = np.take_along_axis(slot_states[p], src, axis=1) if gather else src
            jins.append((dst, fcost.astype(np.float32), (slot + slot_add).astype(np.int32),
                         (arc + arc_add).astype(np.int32)))
            sends.append(route_send(
                torch.from_numpy(dst), torch.from_numpy(cost), torch.from_numpy(src),
                torch.from_numpy(arc), SP, P, CAP, beam, cutoff=torch.from_numpy(cut[p]),
                slot_states=torch.from_numpy(slot_states[p]) if gather else None,
                slot_add=slot_add, arc_add=arc_add))
        want = jax_route(jins, P, beam)
        for r, got in enumerate(port_route(sends, P)):
            for i, name in enumerate(jgs.Routed._fields):
                same_bits(want[i][r], got[i].numpy(), f"gather={gather}, rank {r}: {name}")


@pytest.mark.parametrize("lattice", [False, True])
def test_route_recv_incumbents_first(lattice):
    """The receive side with the K incumbents first equals the sharded eps
    iterations' old concatenation: (states, costs, slots my_base + k and
    NO_ARC) on the 1-best path, (states, costs, -1, -1) on the lattice
    path, then the routed lanes."""
    rng = np.random.default_rng(5)
    P, K, my_base = 2, 8, 16
    recv = rng.integers(0, 50, size=(P, B, CAP, 4)).astype(np.int32)
    costs = (rng.integers(0, 8, size=(P, B, CAP)) * 0.5).astype(np.float32)
    costs[..., ::3] = np.inf
    recv[..., 1] = costs.view(np.int32)
    states = rng.integers(0, SP, size=(B, K)).astype(np.int32)
    inc_costs = np.sort((rng.integers(0, 8, size=(B, K)) * 0.5).astype(np.float32), axis=1)
    inc_costs[:, K - 2:] = np.inf
    recv_t, st, ct = (torch.from_numpy(x) for x in (recv, states, inc_costs))
    base = None if lattice else my_base
    got = route_recv_plain(recv_t, SP, st, ct, base)
    rt = route_recv(recv_t, SP)
    if lattice:
        slots = torch.full((B, K), -1, dtype=torch.int32)
        arcs = torch.full((B, K), -1, dtype=torch.int32)
    else:
        slots = (my_base + torch.arange(K, dtype=torch.int32)).expand(B, K)
        arcs = torch.full((B, K), NO_ARC, dtype=torch.int32)
    want = (torch.cat([st, rt.state_local], dim=1), torch.cat([ct, rt.cost], dim=1),
            torch.cat([slots, rt.gslot], dim=1), torch.cat([arcs, rt.arc], dim=1))
    for name, w, g in zip(got._fields, want, got):
        same_bits(w.numpy(), g.numpy(), name)
    # The routed lanes: rank p's slice in order, the dedup sentinel where +inf.
    flat = recv.transpose(1, 0, 2, 3).reshape(B, P * CAP, 4)
    fin = np.isfinite(flat[..., 1].view(np.float32))
    same_bits(np.where(fin, flat[..., 0], SP), rt.state_local.numpy(), "state_local")
    same_bits(flat[..., 2], rt.gslot.numpy(), "gslot")


@pytest.mark.parametrize("P", [1, 2, 4])
@pytest.mark.parametrize("lattice", [False, True])
def test_routed_lane_map_matches_jax_concatenation(P, lattice):
    """The lane-source map that a sharded eps iteration's dedup call reads
    its lanes through (``routed_lanes_plain``: lane j < K the incumbent,
    lane j >= K the entry ``recv[p, b, c]``, ``p, c = divmod(j - K,
    cap)``; ``csrc/common.cuh:routed_entry``) equals the JAX eps
    iterations' concatenation of the incumbents before ``_route``'s lanes
    (``graph_shard.py:395-398``; the lattice path concatenates states and
    costs, and reads a lane j >= K's payload at ``rt.gslot[j - K]``,
    ``_rec_from_idx``), on every rank, and ``route_recv_plain``'s layout."""
    ins = route_inputs(P, seed=11)
    beam = SLACK if lattice else None
    want = jax_route(ins, P, beam)
    sends = [route_send(*(torch.from_numpy(x) for x in r), SP, P, CAP, beam) for r in ins]
    rng = np.random.default_rng(31 + P)
    K, my_base = 8, 16
    for r in range(P):
        recv = torch.stack([s.buf[r] for s in sends])
        states = rng.integers(0, SP, size=(B, K)).astype(np.int32)
        costs = np.sort((rng.integers(-2, 8, size=(B, K)) * 0.5).astype(np.float32), axis=1)
        costs[:, K - 2:] = np.inf
        costs[0, 0] = -0.0
        base = None if lattice else my_base + r * K
        src = RoutedLanes(recv, SP, torch.from_numpy(states), torch.from_numpy(costs), base)
        got = routed_lanes_plain(src)
        assert src.lanes == K + P * CAP == got.cost.shape[1]
        state_l, cost_l, gslot_l, arc_l = (want[i][r] for i in range(4))
        same_bits(np.concatenate([states, state_l], axis=1), got.state_local.numpy(),
                  f"rank {r}: state")
        same_bits(np.concatenate([costs, cost_l], axis=1), got.cost.numpy(), f"rank {r}: cost")
        if lattice:
            same_bits(gslot_l, got.gslot[:, K:].numpy(), f"rank {r}: routed source states")
            same_bits(arc_l, got.arc[:, K:].numpy(), f"rank {r}: routed arcs")
        else:
            slots = np.broadcast_to(base + np.arange(K, dtype=np.int32), (B, K))
            same_bits(np.concatenate([slots, gslot_l], axis=1), got.gslot.numpy(),
                      f"rank {r}: slot")
            same_bits(np.concatenate([np.full((B, K), NO_ARC, np.int32), arc_l], axis=1),
                      got.arc.numpy(), f"rank {r}: arc")
        ref = route_recv_plain(recv, SP, src.inc_states, src.inc_costs, base)
        for name, w, g in zip(got._fields, ref, got):
            same_bits(w.numpy(), g.numpy(), f"rank {r}: {name} against route_recv_plain")
