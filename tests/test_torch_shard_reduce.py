"""The sharded frame's two folded reductions, on the CPU, against the JAX
package and the routes they replace.

1. The local values at eps_iters 0 as the emitting dedup call's last step
   (``kernels.dedup.dedup_select`` / ``kernels.dedup_rec.dedup_select_rec``
   with ``reduce=(carry, em_overflow)``).  The fold rests on an identity:
   the frontier is ordered by (total-order cost, state) and padded with
   +inf, so the first smallest finite cost in slot order
   (``kernels.cutoff.first_min_count``, the oracle that
   ``kernels.dedup.eps_reduce_shard_plain`` uses) is slot 0's, or +inf when
   no state won, and the finite count is ``min(num_unique, K)``.  Held
   here: the plain dedup then ``eps_reduce_shard_plain`` against slot 0
   and ``min(num_unique, K)`` on raw bits, the frontier against the JAX
   package's dedup call and the local values against JAX's own (the
   masked ``jnp.min`` and count of the frontier, the flags), over seeded
   lanes with -0.0 beside +0.0 (at one state and at two), +inf lanes, a
   row with no finite lane, fewer lanes than K (K6), and each flag
   (an emitting overflow flag, K2's record overflow, num_unique > K);
   then the fused wrappers' CPU route against the unfused one, into
   outputs that start as garbage.
2. K8's local half of a chunk's start state as the last step of K3's
   shard first-frame mode (``kernels.frame.frame_start_shard`` with
   ``local=``) against ``frame_start_shard_plain`` then
   ``global_cutoff_local_plain``, and against JAX's masked minimum and
   count, on unsorted start states with +0.0 before -0.0 in slot order,
   an all-+inf row and a row with one finite cost, at m of 1, 5, K - 1
   (a prefix of its own) and K (the costs are the prefix).

Tolerance: none; floats by their raw bits where the port is held to its
oracle, as floats (-0.0 == +0.0) against ``jnp.min``, which leaves the
sign of a zero open.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.ops.segment import dedup_select as jax_dedup_select
from kaldi_decoder_tpu.ops.segment import dedup_select_rec as jax_dedup_select_rec
from kaldi_decoder_tpu_torch.decoders.frontier import StepState
from kaldi_decoder_tpu_torch.kernels.cutoff import empty_cutoff_local, global_cutoff_local_plain
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select, eps_reduce_shard_plain, shard_reduce
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.eps import empty_shard_eps_carry
from kaldi_decoder_tpu_torch.kernels.frame import (
    FrameIO,
    ShardSlots,
    empty_shard_outs,
    frame_start_shard,
    frame_start_shard_plain,
)

B, K, S, N = 4, 16, 40, 48
R, SLACK = 24, 2.0  # K2's records and slack beam (R > K)


def raw(x):
    x = torch.as_tensor(x)
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def same_bits(want, got, what):
    want, got = torch.as_tensor(want), torch.as_tensor(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (what, want.shape, got.shape)
    assert torch.equal(raw(want), raw(got)), what


# ---------------------------------------------------------------------------
# 1. The local values as the emitting call's last step
# ---------------------------------------------------------------------------

K6_CASES = ("signed-zeros", "inf-lanes", "empty-row", "n-below-K", "em-overflow",
            "saturated")
K2_CASES = ("signed-zeros", "inf-lanes", "empty-row", "em-overflow", "rec-overflow",
            "saturated")
ROUTE_CASES = ("no-flag", "flags")


def lanes_for(case: str, kind: str, seed: int):
    """(states (B, n), costs (B, n), payload, em_overflow flags, r) of one
    case: costs on a 0.25 grid over S states, a fifth of the lanes +inf,
    no flag set; ``case`` shapes rows 0-3 (``r``: K2's record rows)."""
    rng = np.random.default_rng(seed)
    n = 10 if case == "n-below-K" else N
    states = rng.integers(0, S, size=(B, n)).astype(np.int32)
    costs = (rng.integers(1, 30, size=(B, n)) * 0.25).astype(np.float32)
    costs[rng.random((B, n)) < 0.2] = np.inf
    em = [np.zeros(B, bool), np.zeros(B, bool)]
    r = R
    if case == "signed-zeros":
        # Row 0: +0.0 and -0.0 at two states (the frontier puts -0.0
        # first); row 1: both at one state, +0.0 the lower lane (its
        # winner, so slot 0 holds +0.0); row 2: every finite lane -0.0.
        states[0, 3], costs[0, 3] = 7, 0.0
        states[0, 9], costs[0, 9] = 11, -0.0
        states[1, 2], costs[1, 2] = 5, 0.0
        states[1, 6], costs[1, 6] = 5, -0.0
        costs[2, :] = np.where(np.isfinite(costs[2]), -0.0, np.inf)
    elif case == "inf-lanes":
        costs[rng.random((B, n)) < 0.7] = np.inf
        costs[3, 1:] = np.inf  # one finite lane
    elif case == "empty-row":
        costs[1] = np.inf
        costs[3] = np.inf
    elif case == "em-overflow":
        em[0][2] = True
        em[1][0] = True
    elif case == "rec-overflow":
        r = K + 2  # fewer record rows than the eligible links
    elif case == "saturated":
        states[3] = rng.permutation(S)[:n] if n <= S else np.arange(n) % S
        costs[3] = (rng.integers(1, 30, size=n) * 0.25).astype(np.float32)
    pay = (rng.integers(0, 1000, size=(B, n)).astype(np.int32),
           np.tile(np.arange(n, dtype=np.int32), (B, 1)))
    return states, costs, pay, em, r


def port_select(kind, states, costs, pay, r, reduce=None, **kw):
    st, co = torch.from_numpy(states), torch.from_numpy(costs)
    if kind == "k6":
        return dedup_select(st, co, K, S, reduce=reduce, **kw)
    return dedup_select_rec(st, co, K, S, r, SLACK, tuple(torch.from_numpy(p) for p in pay),
                            reduce=reduce, **kw)


def jax_select(kind, states, costs, pay, r):
    """The JAX package's dedup call on the same lanes; fewer lanes than K
    (which its top_k refuses) padded with +inf lanes, which change no
    winner."""
    pad = max(0, K - states.shape[1])
    if pad:
        states = np.pad(states, ((0, 0), (0, pad)))
        costs = np.pad(costs, ((0, 0), (0, pad)), constant_values=np.inf)
    if kind == "k6":
        return jax.vmap(lambda s, c: jax_dedup_select(s, c, K, S))(jnp.asarray(states),
                                                                   jnp.asarray(costs))
    return jax.vmap(lambda s, c, p0, p1: jax_dedup_select_rec(
        s, c, K, S, r, slack_beam=SLACK, payload=(p0, p1), sweep_cols=True,
        need_idx=False))(jnp.asarray(states), jnp.asarray(costs), jnp.asarray(pay[0]),
                         jnp.asarray(pay[1]))


def garbage_carry():
    """A carry of no eps iteration whose local values are garbage."""
    carry = empty_shard_eps_carry(B, 0, K, "cpu")
    carry.red_min.view(torch.int32).fill_(-1)  # a NaN
    carry.red_count.fill_(-7)
    carry.red_flags.fill_(5)
    return carry


@pytest.mark.parametrize("kind,case", [("k6", c) for c in K6_CASES]
                         + [("k2", c) for c in K2_CASES])
def test_local_values_identity_matches_jax(kind, case):
    """The plain dedup call, then ``eps_reduce_shard_plain`` on its
    frontier: red_min is slot 0's cost bits (+inf with no winner),
    red_count ``min(num_unique, K)``, the flag pair each flag's; the
    frontier equals JAX's dedup call's on raw bits, the local values JAX's
    masked minimum (as floats) and count."""
    states, costs, pay, em, r = lanes_for(case, kind, 31 + K6_CASES.index(case)
                                          if case in K6_CASES else 47)
    sel = port_select(kind, states, costs, pay, r)
    ref = jax_select(kind, states, costs, pay, r)
    same_bits(torch.from_numpy(np.array(ref.costs)), sel.costs, "frontier costs against JAX")
    assert np.array_equal(np.asarray(ref.num_unique), sel.num_unique.numpy())
    em_t = tuple(torch.from_numpy(x) for x in em)
    own = (sel.rec_overflow,) if kind == "k2" else ()
    carry = garbage_carry()
    eps_reduce_shard_plain(carry, sel.costs, em_t + own, sel.num_unique)

    n = sel.num_unique
    slot0 = torch.where(n > 0, sel.costs[:, 0], torch.tensor(float("inf")))
    same_bits(slot0, carry.red_min, "red_min against slot 0")
    same_bits(torch.clamp(n, max=K), carry.red_count, "red_count against min(num_unique, K)")
    ovf = any(x.any() for x in em) or bool(own and own[0].any())
    assert carry.red_flags.tolist() == [int(ovf), int((n > K).any())]

    c = jnp.asarray(np.asarray(ref.costs))
    jmin = np.asarray(jnp.min(jnp.where(jnp.isfinite(c), c, jnp.inf), axis=1))
    jcount = np.asarray(jnp.sum(jnp.isfinite(c), axis=1).astype(jnp.int32))
    assert np.array_equal(jmin, carry.red_min.numpy())  # as floats: -0.0 == +0.0
    assert np.array_equal(jcount, carry.red_count.numpy())
    jsat = bool(jnp.any(jnp.asarray(ref.num_unique) > K))
    assert carry.red_flags[1].item() == int(jsat)
    if kind == "k2":
        assert carry.red_flags[0].item() == int(
            ovf or bool(np.asarray(ref.rec_overflow).any()))

    # The cases are what they say.
    if case == "signed-zeros":
        assert np.signbit(carry.red_min[0].item()) and np.signbit(carry.red_min[2].item())
        assert not np.signbit(carry.red_min[1].item())  # state 5's winner is +0.0
        assert carry.red_min[1].item() == 0.0
    if case == "empty-row":
        assert n[1].item() == n[3].item() == 0 and carry.red_count[1].item() == 0
    if case == "n-below-K":
        assert costs.shape[1] < K
    if case == "rec-overflow":
        assert sel.rec_overflow.any() and carry.red_flags[0].item() == 1
    if case == "saturated":
        assert n[3].item() > K and carry.red_count[3].item() == K
    if case in ("em-overflow",):
        assert carry.red_flags[0].item() == 1


@pytest.mark.parametrize("flags", ROUTE_CASES)
@pytest.mark.parametrize("kind", ["k6", "k2"])
def test_fused_cpu_route_matches_unfused(kind, flags):
    """``reduce=(carry, em_overflow)`` on CPU tensors writes what the
    unfused route (the plain call, then ``eps_reduce_shard_plain`` with
    K2's own ``rec_overflow`` beside the flags) writes, bit for bit, into
    outputs that start as garbage; the selection is the plain call's and
    the count word stays 0.  The wrappers take one to three emitting
    flags."""
    case = "em-overflow" if flags == "flags" else "inf-lanes"
    states, costs, pay, em, r = lanes_for(case, kind, 5 + (kind == "k2"))
    if flags == "flags":
        states[2, :K + 4] = np.arange(K + 4)  # row 2 saturates too
        costs[2, :K + 4] = 1.5
    em_t = tuple(torch.from_numpy(x) for x in em)
    fused = garbage_carry()
    got = port_select(kind, states, costs, pay, r, reduce=(fused, em_t))
    want = port_select(kind, states, costs, pay, r)
    for name, w, g in zip(want._fields, want, got):
        if w is not None:
            same_bits(w, g, f"selection.{name}")
    unfused = garbage_carry()
    own = (want.rec_overflow,) if kind == "k2" else ()
    eps_reduce_shard_plain(unfused, want.costs, em_t + own, want.num_unique)
    for name in ("red_min", "red_count", "red_flags", "red_done"):
        same_bits(getattr(unfused, name), getattr(fused, name), f"carry.{name}")
    assert fused.red_done.tolist() == [0]
    if flags == "flags":
        assert fused.red_flags.tolist() == [1, 1]
    for bad in ((), em_t * 2):
        with pytest.raises(ValueError, match="one to three"):
            port_select(kind, states, costs, pay, r, reduce=(garbage_carry(), bad))
    with pytest.raises(ValueError, match="one to three"):
        shard_reduce((garbage_carry(), ()), B, torch.device("cpu"))


@pytest.mark.parametrize("kind", ["k6", "k2"])
def test_clusters_only_with_reduce(kind):
    """``clusters`` sets the blocks a row of a call with ``reduce=`` only,
    and only to 8, 4, 2 or 1; with it the CPU route is the one without."""
    states, costs, pay, em, r = lanes_for("inf-lanes", kind, 7)
    em_t = tuple(torch.from_numpy(x) for x in em)
    with pytest.raises(ValueError, match="with reduce only"):
        port_select(kind, states, costs, pay, r, clusters=2)
    with pytest.raises(ValueError, match="clusters must be"):
        port_select(kind, states, costs, pay, r, reduce=(garbage_carry(), em_t), clusters=3)
    a, b = garbage_carry(), garbage_carry()
    port_select(kind, states, costs, pay, r, reduce=(a, em_t))
    port_select(kind, states, costs, pay, r, reduce=(b, em_t), clusters=2)
    for name in ("red_min", "red_count", "red_flags", "red_done"):
        same_bits(getattr(a, name), getattr(b, name), f"carry.{name}")


# ---------------------------------------------------------------------------
# 2. K8's local half of a chunk's start state in the first-frame mode
# ---------------------------------------------------------------------------


def start_chunk(seed: int, lattice: bool, frames: int = 3) -> FrameIO:
    """A chunk on the CPU whose start state is unsorted: row 0 +0.0 at
    slot 3 before -0.0 at slot 9 (its first smallest keeps +0.0's bits),
    row 1 all +inf, row 2 one finite cost at its last slot, row 3 -0.0
    before +0.0."""
    rng = np.random.default_rng(seed)
    costs = rng.permutation((rng.integers(1, 40, size=(B, K)) * 0.25).astype(np.float32),
                            axis=1)
    costs[rng.random((B, K)) < 0.25] = np.inf
    costs[0, 3], costs[0, 9] = 0.0, -0.0
    costs[1] = np.inf
    costs[2] = np.inf
    costs[2, K - 1] = 6.5
    costs[3, 1], costs[3, 12] = -0.0, 0.0
    st0 = StepState(torch.from_numpy(rng.integers(0, S, size=(B, K)).astype(np.int32)),
                    torch.from_numpy(costs),
                    torch.from_numpy(rng.uniform(-20, 0, size=B).astype(np.float32)))
    scores = torch.from_numpy(rng.uniform(-9, 0, size=(frames, B, 7)).astype(np.float32))
    lengths = torch.tensor([frames, 1, frames, 2], dtype=torch.int32)
    return FrameIO(scores, lengths, st0, empty_shard_outs(frames, B, K, 1, lattice, "cpu", R, 8))


@pytest.mark.parametrize("m", [1, 5, K - 1, K])
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
def test_first_frame_local_half_matches_plain_route(lattice, m):
    """``frame_start_shard(slots, io, local=...)`` on the CPU leaves the
    slots as ``frame_start_shard_plain`` and the local half as
    ``global_cutoff_local_plain`` of the start costs at m (its prefix
    where m < K; none of its own at m == K), bit for bit, into buffers
    that start as garbage; the best costs and counts equal JAX's masked
    minimum (as floats) and count of the start costs."""
    io = start_chunk(3 + m + 100 * lattice, lattice)
    slots = ShardSlots(B, K, 7, "cpu")
    slots.args.fill_(-3)
    local = empty_cutoff_local(B, m, "cpu")
    if m == K:
        local = local._replace(prefix=None)
    for x in local:
        if x is not None:
            raw(x).fill_(-9)
    frame_start_shard(slots, io, local=local)
    want = frame_start_shard_plain(io)
    for name, w, g in zip(want.state._fields, want.state, slots.state):
        same_bits(w, g, f"state.{name}")
    same_bits(want.lengths, slots.lengths, "lengths")
    same_bits(want.scores_t, slots.scores_t, "scores row 0")
    assert slots.args.tolist() == want.args.tolist()
    ref = global_cutoff_local_plain(io.st0.costs, m)
    same_bits(ref.best, local.best, "local best")
    same_bits(ref.count, local.count, "local count")
    if m < K:
        same_bits(ref.prefix, local.prefix, "local prefix")
    assert not np.signbit(local.best[0].item()) and np.signbit(local.best[3].item())
    assert local.best[1].item() == float("inf") and local.count[1].item() == 0
    assert local.best[2].item() == 6.5 and local.count[2].item() == 1
    c = jnp.asarray(io.st0.costs.numpy())
    jmin = np.asarray(jnp.min(jnp.where(jnp.isfinite(c), c, jnp.inf), axis=1))
    assert np.array_equal(jmin, local.best.numpy())
    assert np.array_equal(np.asarray(jnp.sum(jnp.isfinite(c), axis=1)), local.count.numpy())
