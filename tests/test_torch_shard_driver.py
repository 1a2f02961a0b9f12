"""The sharded frame driver on the CPU: K3's shard mode's first-frame mode
and its table, the sharded decoders reused through the driver, and the
count of a replay.

K3's shard mode now runs on static slots (``kernels.frame.ShardSlots``):
its first-frame mode (``frame_start_shard``) loads a chunk's start state,
row lengths and scores row 0 and writes the table (t, the frame count, the
chunk's scores and output pointers), and each frame's tail
(``frame_tail_shard``) writes row t through the table and copies the next
scores row.  These tests hold the CPU side (the plain versions) against
what the sharded loop did before the slots: the chunk's start state
cloned, K8's local half on it, t 0 and scores row ``t`` read from the
chunk; the tail's plain version and row t written into the chunk's
outputs.  Exact: the new paths copy what the old ones computed, so every
field is compared by its raw bits.

The decoders: one ``ShardedViterbiDecoder`` and one
``ShardedLatticeDecoder`` at P = 1 and P = 2 (ranks of
``tests/_torch_dist_worker.py`` over gloo, as in
``tests/test_torch_graph_shard.py``), each reused for two decodes of other
lengths through the driver, against the JAX sharded decoders on the
suite's virtual CPU devices and against the same decodes within
``driver.eager_frames()``, bit for bit.  On the CPU the driver runs the
frame from the host loop (no graph: 0 replays); on a card under NCCL it
replays a captured graph (``tests/test_torch_kernels.py``
``test_shard_driver_graph_matches_loop``, marked ``cuda``).

The count of a replay: ``shard_driver.held_counts`` puts back what a
captured frame counted and ``add_replays`` adds it once a replay; held
around a whole decode and added twice, the counts grow by twice the
decode's launches and collective calls.

Releasing: a dropped driver is released (its card finished with it, its
graph destroyed), and ``parallel.shutdown_distributed`` releases the kept
sharded frame drivers before it destroys the groups; off the card a
sharded frame driver keeps no graph and runs the host loop.
"""

import tempfile
import threading
from collections import Counter

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kaldi_decoder_tpu.decoders.frontier import config_for_graph as jax_config
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import random_fst
from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, StepState
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.kernels.cutoff import (
    CutoffLocal,
    first_min_count,
    global_cutoff_local_plain,
)
from kaldi_decoder_tpu_torch.kernels.frame import (
    SHARD_ARGS_WORDS,
    FrameIO,
    ShardSlots,
    ShardTailInputs,
    empty_shard_outs,
    frame_start_shard,
    frame_start_shard_plain,
    frame_tail_shard,
    frame_tail_shard_plain,
)
from kaldi_decoder_tpu_torch.kernels.route import route_send
from kaldi_decoder_tpu_torch.parallel import graph_shard as pgs
from kaldi_decoder_tpu_torch.parallel import shard_driver
from kaldi_decoder_tpu_torch.parallel.mesh import collective_calls

from _torch_dist_worker import run_ranks

B, K, V, D, R, RE, N = 3, 16, 7, 1, 24, 12, 40
SLOT_BASE = 16


def same_bits(want, got, what):
    want, got = torch.as_tensor(want), torch.as_tensor(got)
    assert want.shape == got.shape and want.dtype == got.dtype, (what, want.shape, got.shape)
    if want.dtype == torch.float32:
        want, got = want.view(torch.int32), got.view(torch.int32)
    assert torch.equal(want, got), what


def sorted_costs(rng, rows, k, inf_from):
    """Cost-sorted rows with -0.0 beside +0.0 and +inf from ``inf_from``."""
    c = np.sort(rng.integers(0, 30, size=(rows, k)) * 0.5, axis=1).astype(np.float32)
    c[:, 0] = -0.0
    c[:, 1] = 0.0
    c[:, inf_from:] = np.inf
    return torch.from_numpy(c)


def chunk(seed: int, lattice: bool, frames: int) -> FrameIO:
    """A chunk of ``frames`` frames on the CPU: its start state, scores,
    row lengths (row 0 ends after one frame) and zeroed outputs."""
    rng = np.random.default_rng(seed)
    st0 = StepState(torch.from_numpy(rng.integers(0, 50, size=(B, K)).astype(np.int32)),
                    sorted_costs(rng, B, K, K - 4),
                    torch.from_numpy(rng.uniform(-20, 0, size=B).astype(np.float32)))
    scores = torch.from_numpy(rng.uniform(-9, 0, size=(frames, B, V)).astype(np.float32))
    lengths = torch.full((B,), frames, dtype=torch.int32)
    lengths[0] = 1
    outs = empty_shard_outs(frames, B, K, D, lattice, "cpu", R, RE)
    for x in outs:
        x.zero_()
    return FrameIO(scores, lengths, st0, outs)


def shard_config(max_active: int) -> pgs.ShardConfig:
    """A ShardConfig of K 16 a shard, 2 shards, min_active 2 (so GetCutoff
    gathers): m = min(max_active + 1, K)."""
    fc = FrontierConfig(beam=9.0, max_active=max_active, min_active=2, beam_delta=0.5,
                        frontier_size=K)
    return pgs.ShardConfig(frontier=fc, num_parts=2, part_size=50, route_cap=64,
                           eps_route_cap=64)


# m < K: K8's local half keeps a prefix of its own; m == K: the costs are it.
M_CASES = {"prefix": 5, "costs": 40}


# ---------------------------------------------------------------------------
# (a) The first-frame mode against the loop's chunk start
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m_case", list(M_CASES))
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
def test_first_frame_mode_matches_chunk_start(lattice, m_case):
    """``frame_start_shard`` (its plain version on the CPU) leaves the
    slots as the sharded loop began a chunk: the state a clone of the
    start state, the row lengths and scores row 0 the chunk's, t 0 with no
    row done, the frame count and the addresses of the chunk's scores and
    outputs in the table; K8's local half of the slots' state
    (``_start_cutoff``) equal to its plain local half of the start state."""
    io = chunk(1 + lattice, lattice, frames=4)
    sc = shard_config(M_CASES[m_case])
    slots = ShardSlots(B, K, V, "cpu")
    slots.args.fill_(-3)  # a table left by an earlier chunk
    frame_start_shard(slots, io)
    assert slots.io is io
    for name, w, g in zip(io.st0._fields, io.st0, slots.state):
        same_bits(w, g, f"state.{name}")
        assert g.data_ptr() != w.data_ptr(), "the slots hold a copy"
    same_bits(io.lengths, slots.lengths, "lengths")
    same_bits(io.scores[0], slots.scores_t, "scores row 0")
    words = [0, 0, 4, io.scores.data_ptr()] + [x.data_ptr() for x in io.outs]
    assert slots.args.tolist() == words + [0] * (SHARD_ARGS_WORDS - len(words))
    want = frame_start_shard_plain(io)
    assert slots.args.tolist() == want.args.tolist()
    bufs = pgs._bufs(sc, B, K, V, "cpu")
    pgs._start_cutoff(slots.state, sc, bufs)
    early, m = pgs._cutoff_m(sc)
    assert not early and (m < K) == (m_case == "prefix")
    ref = global_cutoff_local_plain(io.st0.costs, m)
    got = bufs.cutoff["local"]
    same_bits(ref.best, got.best, "local best")
    same_bits(ref.count, got.count, "local count")
    if m < K:
        same_bits(ref.prefix, got.prefix, "local prefix")
    else:
        assert got.prefix is None  # the all-gather reads the costs


# ---------------------------------------------------------------------------
# (b) K3's shard mode on the slots against the call before the slots
# ---------------------------------------------------------------------------


def tail_inputs(rng, lattice: bool, live_costs: torch.Tensor) -> ShardTailInputs:
    """A frame's ShardTailInputs: the closure's frontier, the reduced best
    (row 1: no token on any rank), counts and flags, records or the
    backpointer inputs, and the closure's first smallest costs."""
    mid = StepState(torch.from_numpy(rng.integers(0, 50, size=(B, K)).astype(np.int32)),
                    live_costs, None)
    best = (live_costs[:, 0] - 0.25).clone()
    best[1] = float("inf")
    extra = {}
    if lattice:
        extra = dict(em_records=torch.from_numpy(rng.integers(-1, 500, (B, R, 4)).astype(np.int32)),
                     eps_records=torch.from_numpy(
                         rng.integers(-1, 500, (B, D, RE, 2)).astype(np.int32)))
    else:
        extra = dict(cand_idx=torch.from_numpy(rng.integers(-1, N, (B, K)).astype(np.int32)),
                     gslot=torch.from_numpy(rng.integers(0, 64, (B, N)).astype(np.int32)),
                     arc=torch.from_numpy(rng.integers(-1, 900, (B, N)).astype(np.int32)),
                     bp_eps=torch.from_numpy(rng.integers(-1, 64, (B, D, K, 2)).astype(np.int32)))
    red_min, red_count = first_min_count(live_costs)
    return ShardTailInputs(mid.states, live_costs, best,
                           torch.from_numpy(rng.integers(0, 2 * K, B).astype(np.int32)),
                           torch.tensor([1, 0], dtype=torch.int32), red_min=red_min,
                           red_count=red_count, **extra)


@pytest.mark.parametrize("fold", [False, True], ids=["no-local", "local"])
@pytest.mark.parametrize("lattice", [False, True], ids=["1-best", "lattice"])
def test_shard_tail_on_slots_matches_the_call_before(lattice, fold):
    """Three frames of a chunk through ``frame_tail_shard`` on the slots
    against ``frame_tail_shard_plain`` on a state of its own with row t
    written into the chunk's outputs, as the call before the slots did:
    the same state, rows and (with ``fold``) K8's local half, bitwise; the
    scores slot holds row t + 1 of the chunk's scores after frame t (the
    last frame's leaves it), and t advances; row 0 freezes after frame 0."""
    T = 3
    rng = np.random.default_rng(7 + 2 * lattice + fold)
    io = chunk(11 + lattice, lattice, frames=T)
    slots = ShardSlots(B, K, V, "cpu")
    frame_start_shard(slots, io)
    st = StepState(*(x.clone() for x in io.st0))
    outs = empty_shard_outs(T, B, K, D, lattice, "cpu", R, RE)
    loc_new = loc_old = None
    if fold:
        ref = global_cutoff_local_plain(io.st0.costs, 5)
        loc_new = CutoffLocal(*(x.clone() for x in ref))
        loc_old = CutoffLocal(*(x.clone() for x in ref))
    for t in range(T):
        tin = tail_inputs(rng, lattice, sorted_costs(rng, B, K, K - 3 - t))
        cutoff = torch.from_numpy(rng.uniform(5, 15, size=B).astype(np.float32))
        final, out, nxt = frame_tail_shard_plain(st, cutoff, tin, io.lengths > t, SLOT_BASE,
                                                 loc_old)
        for dst, src in zip(st, final):
            dst.copy_(src)
        for buf, x in zip(outs, out):
            buf[t].copy_(x)
        if fold:
            loc_old = nxt
        frame_tail_shard(slots, cutoff, tin, SLOT_BASE, local=loc_new)
        for name, w, g in zip(st._fields, st, slots.state):
            same_bits(w, g, f"frame {t}: state.{name}")
        for name, w, g in zip(outs._fields, outs, io.outs):
            same_bits(w[: t + 1], g[: t + 1], f"frame {t}: {name}")
        if fold:
            for name, w, g in zip(CutoffLocal._fields, loc_old, loc_new):
                same_bits(w, g, f"frame {t}: local.{name}")
        same_bits(io.scores[min(t + 1, T - 1)], slots.scores_t, f"frame {t}: scores slot")
        assert slots.args[:3].tolist() == [t + 1, 0, T]


# ---------------------------------------------------------------------------
# (c), (d) The decoders through the driver, and the count of a replay
# ---------------------------------------------------------------------------


def rand_logp(rng, T, V_):
    return np.log(rng.dirichlet(np.ones(V_), size=T)).astype(np.float32)


def decoder_case(kind: str):
    """(JAX graph, config kwargs, decoder kwargs, two (scores, lengths)
    decodes of other lengths): a random graph with eps arcs (eps depth 5
    and 4), K 16 a shard, max_active 6 (so GetCutoff gathers)."""
    rng = np.random.default_rng(21 if kind == "viterbi" else 22)
    Vg = 5
    g = jax_compile(random_fst(50, Vg, rng, mean_arcs_per_state=4.0))
    decodes = []
    for T, lens in ((12, [12, 7]), (20, [13, 20])):
        scores = np.stack([rand_logp(rng, T, Vg) for _ in lens])
        decodes.append((scores, np.array(lens, np.int32)))
    ckw = dict(beam=20.0, max_active=6, min_active=2, frontier_size=16)
    if kind == "viterbi":
        return g, ckw, dict(pad_time_to=8), decodes
    return g, ckw, dict(lattice_beam=6.0, pad_time_to=8, em_records=128, eps_records=64), decodes


KINDS = ("viterbi", "lattice")
# Each case: decodes 0 and 1 through the driver, 2 and 3 the same as the
# loop, 4 decode 0 held and counted as two replays.
MODES = ("driver", "driver", "loop", "loop", "held")


@pytest.fixture(scope="module")
def driven():
    """{P: [rank results]} for P = 1 and 2, both worlds at once."""
    jobs = {P: dict(world=P, cases={}) for P in (1, 2)}
    for P in jobs:
        for kind in KINDS:
            g, ckw, dkw, decodes = decoder_case(kind)
            pg = graph_from_numpy(g)
            jobs[P]["cases"][kind] = dict(
                decoder="ShardedViterbiDecoder" if kind == "viterbi" else "ShardedLatticeDecoder",
                mesh=((P,), ("model",)), args=(pg, config_for_graph(pg, **ckw)), kw=dkw,
                decodes=[(*decodes[i % 2], mode) for i, mode in enumerate(MODES)])
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


def fields(kind):
    return (("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs", "num_active",
             "best_costs", "cutoffs", "overflows", "saturations") if kind == "viterbi" else
            ("init_states", "init_costs", "init_eps_records", "frame_states", "frame_costs",
             "em_records", "eps_records", "num_active", "cutoffs", "overflows", "saturations"))


def same_result(kind, want, got, what):
    for f in fields(kind):
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.shape == b.shape, (what, f, a.shape, b.shape)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        assert np.array_equal(a, b), (what, f)


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_reused_sharded_decoder_matches_jax_and_loop(driven, kind, P):
    """One sharded decoder per rank, reused for two decodes of other
    lengths through the driver: each equal to the JAX sharded decoder's
    decode of the same input on a mesh of P devices, and to the same
    decode within ``driver.eager_frames()``, in every field, on every
    rank; the CPU runs the host loop (no frame replayed)."""
    g, ckw, dkw, decodes = decoder_case(kind)
    cls = jgs.ShardedViterbiDecoder if kind == "viterbi" else jgs.ShardedLatticeDecoder
    jdec = cls(g, jax_config(g, **ckw), mesh=Mesh(np.array(jax.devices()[:P]), ("model",)),
               **dkw)
    ranks = driven[P]
    for i, (scores, lengths) in enumerate(decodes):
        want = jdec.decode(scores, lengths)
        assert want.num_active.shape[0] == (16 if i == 0 else 24)
        for r, res in enumerate(ranks):
            runs = res[kind]
            same_result(kind, want, runs[i]["result"], f"rank {r}, decode {i} (driver) vs JAX")
            same_result(kind, runs[i + 2]["result"], runs[i]["result"],
                        f"rank {r}, decode {i}: driver vs loop")
            assert runs[i]["replays"] == runs[i + 2]["replays"] == 0
            assert runs[i]["launches"] == runs[i + 2]["launches"]
            assert runs[i]["calls"] == runs[i + 2]["calls"]


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_replays_count_what_a_capture_holds(driven, kind, P):
    """A decode within ``held_counts`` counts nothing and returns what it
    counted, which is the same decode's launches (every wrapper a captured
    frame holds; on the CPU none launches) and collective calls by kind as
    the loop; ``add_replays`` of it twice grows every count by twice that,
    the replays by 2.  A sharded frame with D eps iterations exchanges MIN
    3, SUM 2, MAX 1 + D, one all-gather and 1 + D all-to-alls (10 at the
    bench's D = 1), and the start closure D MAX and D all-to-alls."""
    g, ckw, _, _ = decoder_case(kind)
    D = config_for_graph(graph_from_numpy(g), **ckw).eps_iters
    assert D > 1
    for r, res in enumerate(driven[P]):
        loop, held = res[kind][2], res[kind][4]
        n = len(shard_driver.COUNTED)
        want_launches, want_calls = loop["launches"][:n], loop["calls"]
        assert held["held"] == (want_launches, want_calls), r
        assert held["launches"][:n] == [2 * k for k in want_launches], r
        assert held["launches"][n:] == loop["launches"][n:]  # the first-frame mode, K8 local
        assert held["calls"] == {k: 2 * v for k, v in want_calls.items()}, r
        assert held["replays"] == 2
        same_result(kind, loop["result"], held["result"], f"rank {r}: held vs loop")
        frames = loop["result"].num_active.shape[0]
        assert want_calls == dict(all_reduce_min=3 * frames, all_reduce_sum=2 * frames,
                                  all_reduce_max=(1 + D) * frames + D, all_gather=frames,
                                  all_to_all=(1 + D) * frames + D, all_gather_object=1), r


def test_held_counts_puts_back_on_error():
    """``held_counts`` puts the counts back also when its run raises, and
    ``add_replays`` of nothing held counts the replays alone."""
    before_launch, before_calls = route_send.launches, Counter(collective_calls)

    def run():
        route_send.launches += 3
        collective_calls["all_to_all"] += 2
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        shard_driver.held_counts(run)
    assert route_send.launches == before_launch and collective_calls == before_calls
    from kaldi_decoder_tpu_torch.decoders import driver

    r0 = driver.replays
    shard_driver.add_replays([0] * len(shard_driver.COUNTED), Counter(), 5)
    assert driver.replays == r0 + 5
    assert route_send.launches == before_launch and collective_calls == before_calls


# ---------------------------------------------------------------------------
# Releasing the kept drivers
# ---------------------------------------------------------------------------


class FakeDriver:
    """A kept driver that records its release."""

    def __init__(self, name, released):
        self.name, self.released = name, released

    def release(self):
        self.released.append(self.name)


def test_kept_drivers_are_released_when_dropped():
    """``kept_driver`` releases the least recently used driver it drops
    past ``MAX_DRIVERS``, and ``driver.release`` every driver it keeps,
    oldest first, leaving the cache empty."""
    from collections import OrderedDict

    from kaldi_decoder_tpu_torch.decoders import driver

    cache, released = OrderedDict(), []
    n = driver.MAX_DRIVERS
    for i in range(n):
        driver.kept_driver(cache, i, lambda i=i: FakeDriver(i, released))
    driver.kept_driver(cache, 0, lambda: FakeDriver("again", released))  # kept: 0 is used last
    driver.kept_driver(cache, n, lambda: FakeDriver(n, released))
    assert released == [1]
    driver.release(cache)
    assert released == [1, *range(2, n), 0, n] and not cache


@pytest.fixture
def lone_gloo_rank(tmp_path):
    """A gloo default group of this process alone, shut down by the test
    (or after it, where the test failed first)."""
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch import parallel

    if dist.is_initialized():
        pytest.skip("a process group is already made in this process")
    parallel.initialize_distributed(device_type="cpu", init_method=f"file://{tmp_path}/store",
                                    rank=0, world_size=1)
    yield dist.group.WORLD
    if dist.is_initialized():
        dist.destroy_process_group()
    shard_driver._drivers.clear()


def test_shard_driver_runs_the_host_loop_off_the_card(lone_gloo_rank):
    """On the CPU, over gloo, a sharded frame driver keeps no graph and
    runs its frame from the host loop, once a frame; within
    ``eager_frames()`` too."""
    from kaldi_decoder_tpu_torch.decoders import driver

    frames = []
    drv = shard_driver.ShardDriver(lambda: frames.append(1), None, (lone_gloo_rank,), "cpu",
                                   B, K)
    assert drv.graphed is None and drv.pool_bytes is None
    r0 = driver.replays
    drv.run(5)
    with driver.eager_frames():
        drv.run(2)
    drv.release()
    assert len(frames) == 7 and driver.replays == r0


def test_shutdown_distributed_releases_the_sharded_drivers(lone_gloo_rank):
    """``shutdown_distributed`` releases every kept sharded frame driver
    (their graphs hold the communicators) before it destroys the groups."""
    import torch.distributed as dist

    from kaldi_decoder_tpu_torch import parallel

    released = []

    class Watched(FakeDriver):
        def release(self):
            assert dist.is_initialized(), "released after the groups went"
            super().release()

    for name in ("a", "b"):
        shard_driver.driver_for(("test", name), lambda name=name: Watched(name, released))
    parallel.shutdown_distributed()
    assert released == ["a", "b"] and not shard_driver._drivers and not dist.is_initialized()
