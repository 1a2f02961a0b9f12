"""K8, the sharded frame's GetCutoff (``kernels.cutoff``), against the JAX
``_global_cutoff`` on the CPU.

The JAX side runs ``kaldi_decoder_tpu.parallel.graph_shard._global_cutoff``
under ``shard_map`` on P of the suite's virtual CPU devices; the port
composes K8's two plain halves in one process, with the collectives
between them done in place (a MIN of the shards' best costs, a SUM of
their counts, their prefixes stacked in shard order).  Inputs are made
with numpy from fixed seeds, each shard's rows in IEEE total order as
the frontier's select leaves them.  Exactness: cutoff and adaptive beam
equal by their raw bits.

Cases at P = 1, 2 and 4: max_active binding, min_active binding,
min_active 0, max_active past the merged prefixes (the ``P*m - 1``
clamp) and the early return; each on rows with -0.0 and +0.0 tied within
a shard and across shards at the order statistics, an all-+inf row, a
count exactly at max_active and one above, negative costs with ties.
Edge cases of the merge at P = 2, 3, 4 and 8 (``EDGE_CASES``): keys
equal across every shard, -0.0 beside +0.0 at the order statistics,
prefixes all +inf, ranks clamped to ``P*m - 1``.  Beside them: the local
half's values; a model of the kernel's merge in plain numpy and torch
(``search_merge``: what ``csrc/cutoff.cu`` computes step for step, no
sort: a direct read at P = 1, its warp's merge-path search at P = 2, its
co-rank searches at P > 2) against the sort-based plain version on every
case and on wide synthetic shards (m 2048, where the searches take
several rounds); the states a sharded decode (P = 2,
both decoders, over gloo) hands ``_global_cutoff``: each shard's row in
order under the canonical key, as the kernel needs, the merge's inputs
(the local half folded into the frame before's K3 shard mode, reduced and
gathered) equal to the plain local half of those states, and the composed
halves equal to JAX on them; and the local half folded into K3's shard
mode (``frame_tail_shard_plain`` with ``local``) against the plain local
half of the rebased costs and, composed with the merge, the JAX
``_global_cutoff`` of the next frame, at P = 1, 2 and 4, m == 1, 1 < m <
K and m == K (``FOLD_CASES``).
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from kaldi_decoder_tpu.decoders.frontier import FrontierConfig as JaxFrontierConfig
from kaldi_decoder_tpu.decoders.frontier import StepState as JaxStepState
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import random_fst
from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig, StepState, config_for_graph
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.kernels.cutoff import (
    GlobalCutoff,
    first_min_count,
    global_cutoff_local,
    global_cutoff_local_plain,
    global_cutoff_merge,
    global_cutoff_merge_plain,
)
from kaldi_decoder_tpu_torch.kernels.frame import ShardTailInputs, frame_tail_shard_plain

from _torch_dist_worker import run_ranks

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

K, B = 16, 6
INF = np.float32(np.inf)

# name -> config kwargs, given P (max_active past P*K for the clamp, at
# P*K with min_active 0 for the early return).
CONFIGS = {
    "max_active": lambda P: dict(beam=9.0, max_active=5, min_active=3, beam_delta=0.5),
    "min_active": lambda P: dict(beam=0.75, max_active=12, min_active=6, beam_delta=0.25),
    "min_active_0": lambda P: dict(beam=9.0, max_active=5, min_active=0, beam_delta=0.5),
    "clamp": lambda P: dict(beam=30.0, max_active=P * K + 3, min_active=4, beam_delta=0.5),
    "early": lambda P: dict(beam=9.0, max_active=P * K, min_active=0, beam_delta=0.5),
}


def total_order(a: np.ndarray) -> np.ndarray:
    """``a``'s rows sorted in IEEE total order (-0.0 before +0.0), as the
    frontier's select leaves a shard's costs."""
    u = a.view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | 0x80000000)
    return np.take_along_axis(a, np.argsort(key, axis=1, kind="stable"), axis=1)


def shard_costs(seed: int, P: int, kw: dict) -> list:
    """P (B, K) float32 cost rows, one per shard: 0 random costs on a 0.5
    grid with +inf tails; 1 -0.0 and +0.0 ties within and across shards
    at the order statistics; 2 all +inf; 3 and 4 a count of exactly
    max_active and one above (where the shards can hold it); 5 negative
    costs with exact ties across shards."""
    rng = np.random.default_rng(seed)
    rows = np.full((P, B, K), INF, np.float32)
    lo = min(K - 5, max(4, kw["max_active"] // P + 2))  # zeros enough to hold rank max_active
    for q in range(P):
        n = int(rng.integers(K // 2, K + 1))
        rows[q, 0, :n] = rng.integers(0, 40, size=n) * 0.5
        z = int(rng.integers(lo, K - 4))
        rows[q, 1, :z] = np.where(rng.random(z) < 0.5, -0.0, 0.0)
        rows[q, 1, z:] = rng.integers(1, 20, size=K - z) * 0.25
        rows[q, 5, :] = rng.integers(-6, 3, size=K) * 0.5
        rows[q, 5, K - 3:] = INF
    for r, total in ((3, kw["max_active"]), (4, kw["max_active"] + 1)):
        total = min(total, P * K)
        cuts = np.sort(rng.choice(np.arange(1, total), size=P - 1, replace=False)) \
            if P > 1 and total > P else np.array([], np.int64)
        counts = np.diff(np.concatenate([[0], cuts, [total]])).astype(int)
        if counts.max() > K:  # spread evenly where a random split overfills a shard
            counts = np.array([total // P + (q < total % P) for q in range(P)])
        for q in range(P):
            rows[q, r, :counts[q]] = rng.uniform(-1.0, 8.0, size=counts[q]).astype(np.float32)
    return [total_order(rows[q]) for q in range(P)]


def port_global_cutoff(costs: list, kw: dict, merge=global_cutoff_merge, k: int = K):
    """The port's ``_global_cutoff`` over the shards ``costs`` (frontiers
    of ``k`` slots) in one process: K8's local half per shard, the
    collectives in place, the merge (``merge``: the wrapper, or the
    kernel's method, :func:`search_merge`)."""
    P = len(costs)
    fc = FrontierConfig(frontier_size=k, **kw)
    early = fc.max_active >= P * k and fc.min_active == 0
    m = 1 if early else int(min(max(fc.max_active, fc.min_active) + 1, k))
    locs = [global_cutoff_local(torch.from_numpy(c), m) for c in costs]
    best = locs[0].best
    for loc in locs[1:]:
        best = torch.minimum(best, loc.best)
    count = merged = None
    if not early:
        count = sum(loc.count for loc in locs).to(torch.int32)
        merged = torch.stack([loc.prefix for loc in locs])
    return merge(best, count, merged, fc.beam, fc.beam_delta, fc.max_active, fc.min_active)


def _keys(vals: np.ndarray) -> np.ndarray:
    """The kernel's ordered keys (``common.cuh:ordered_key``): -0.0 as
    +0.0, then IEEE total order as unsigned integers."""
    u = np.where(vals == 0, np.float32(0.0), vals).astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.int64)


LANES = np.arange(32)


def _rank_of_two(key, val, m: int, r: int):
    """``csrc/cutoff.cu:rank_of_two``, lane for lane: the element at rank
    ``r`` of one row's two prefixes (``key``/``val``, shard after shard)
    by a merge-path search, 32 candidates a round and a ballot keeping
    the gap between the last that comes before and the next."""
    k = r + 1
    lo, hi = max(0, k - m), min(k, m)
    for _ in range(64):
        if lo >= hi:
            break
        gap = hi - lo
        c = lo + LANES * gap // 32 if gap > 32 else lo + LANES
        valid = c < hi
        cv = np.where(valid, c, lo)
        yes = np.flatnonzero(valid & (key[cv] <= key[m + k - 1 - cv]))
        no = np.flatnonzero(valid & ~np.isin(LANES, yes))
        if yes.size:
            lo = int(c[yes[-1]]) + 1
        if no.size:
            hi = int(c[no[0]])
    else:
        raise AssertionError("the merge-path search does not end")
    if lo == 0:
        return val[m + k - 1]
    if lo == k:
        return val[k - 1]
    a, b = lo - 1, m + k - lo - 1
    return val[b] if key[a] <= key[b] else val[a]


def _find_rank(key, val, P: int, m: int, q: int, r: int):
    """``csrc/cutoff.cu:find_rank``, lane for lane: shard ``q``'s element
    at rank ``r`` of the merged order, or None where another shard holds
    it, by a 32-ary search over q's positions; each candidate ranked by
    its position plus a branchless binary search of every other shard
    (upper bound for the shards before q, lower bound for those after)."""
    top = 1
    while 2 * top <= m:
        top *= 2
    lo, hi, lo_rank = -1, m, -1
    for _ in range(64):
        if hi - lo <= 1:
            break
        gap = hi - lo
        c = lo + (LANES + 1) * gap // 33 if gap > 33 else lo + 1 + LANES
        valid = c < hi
        kc = key[q * m + np.where(valid, c, 0)]
        rank = c.copy()
        for q2 in range(P):
            if q2 == q:
                continue
            pos = np.zeros(32, np.int64)
            step = top
            while step > 0:
                nxt = pos + step
                kk = key[q2 * m + np.minimum(nxt, m) - 1]
                pos = np.where((nxt <= m) & ((kk <= kc) if q2 < q else (kk < kc)), nxt, pos)
                step >>= 1
            rank = rank + pos
        yes = np.flatnonzero(valid & (rank <= r))
        no = np.flatnonzero(valid & (rank > r))
        if yes.size:
            lo, lo_rank = int(c[yes[-1]]), int(rank[yes[-1]])
        if no.size:
            hi = int(c[no[0]])
    else:
        raise AssertionError("the co-rank search does not end")
    return val[q * m + lo] if lo >= 0 and lo_rank == r else None


def search_merge(best, count, merged, beam, beam_delta, max_active, min_active):
    """What ``csrc/cutoff.cu``'s merge computes, step for step, in plain
    numpy and torch: no sort; for each target rank that GetCutoff's branch
    reads (max_active's, min_active's; clamped to ``P*m - 1``) the element
    there, read directly at P = 1 (rank = position), found by the
    merge-path search at P = 2 (:func:`_rank_of_two`) and by the co-rank
    search of every shard at P > 2 (:func:`_find_rank`, exactly one shard
    holding it); then the branch."""
    beam_cutoff = best + beam
    if merged is None:
        return GlobalCutoff(beam_cutoff, torch.full_like(best, beam))
    P, Bn, m = merged.shape
    vals = merged.permute(1, 0, 2).reshape(Bn, P * m).numpy()
    keys = _keys(vals)
    r_at = (min(max_active, P * m - 1), min(min_active, P * m - 1))
    at = np.zeros((2, Bn), np.float32)
    for b in range(Bn):
        want = (int(count[b]) > max_active, int(count[b]) > min_active and min_active != 0)
        for t in (0, 1):
            if not want[t]:
                continue
            if P == 1:
                at[t, b] = vals[b, r_at[t]]
            elif P == 2:
                at[t, b] = _rank_of_two(keys[b], vals[b], m, r_at[t])
            else:
                found = [_find_rank(keys[b], vals[b], P, m, q, r_at[t]) for q in range(P)]
                hits = [v for v in found if v is not None]
                assert len(hits) == 1, (b, t, found)
                at[t, b] = hits[0]
    at = torch.from_numpy(at)
    max_cut = torch.where(count > max_active, at[0], np.inf)
    min_cut = torch.where(count > min_active, best if min_active == 0 else at[1], np.inf)
    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)
    return GlobalCutoff(
        torch.where(use_max, max_cut, torch.where(use_min, min_cut, beam_cutoff)),
        torch.where(use_max, max_cut - best + beam_delta,
                    torch.where(use_min, min_cut - best + beam_delta, beam)))


def jax_global_cutoff(costs: list, kw: dict, k: int = K) -> list:
    """The JAX ``_global_cutoff`` on P virtual devices, one shard each:
    [cutoff (P, B), adaptive beam (P, B)] as numpy."""
    P = len(costs)
    cfg = jgs.ShardConfig(frontier=JaxFrontierConfig(frontier_size=k, **kw), num_parts=P,
                          part_size=50, route_cap=64, eps_route_cap=64)
    mesh = Mesh(np.array(jax.devices()[:P]), ("model",))

    def f(c):
        st = JaxStepState(jnp.zeros(c.shape[1:], jnp.int32), c[0],
                          jnp.zeros((c.shape[1],), jnp.float32))
        return tuple(x[None] for x in jgs._global_cutoff(st, cfg, "model"))

    spec = JP("model")
    fn = shard_map(f, mesh=mesh, in_specs=(spec,), out_specs=(spec, spec), check_vma=False)
    return [np.asarray(x) for x in jax.jit(fn)(jnp.asarray(np.stack(costs)))]


def same_bits(want, got, what):
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    assert want.shape == got.shape, (what, want.shape, got.shape)
    assert np.array_equal(want.view(np.int32), got.view(np.int32)), (what, want, got)


CASES = [(P, name) for P in (1, 2, 4) for name in CONFIGS]


@pytest.mark.parametrize("P,name", CASES, ids=[f"P{P}-{n}" for P, n in CASES])
def test_global_cutoff_halves_match_jax(P, name):
    """K8's plain halves, composed around the collectives, equal the JAX
    ``_global_cutoff`` bit for bit on every shard's result."""
    kw = CONFIGS[name](P)
    costs = shard_costs(100 * P + len(name), P, kw)
    got = port_global_cutoff(costs, kw)
    want = jax_global_cutoff(costs, kw)
    for q in range(P):
        same_bits(want[0][q], got.cutoff.numpy(), f"shard {q}: cutoff")
        same_bits(want[1][q], got.adaptive_beam.numpy(), f"shard {q}: adaptive beam")
    finite = sum(np.isfinite(c).sum(axis=1) for c in costs)
    if name == "max_active":
        assert (finite > kw["max_active"]).any() and (finite == kw["max_active"]).any()
        assert np.isinf(got.cutoff.numpy()[2]), "the all-+inf row keeps an infinite cutoff"
    zeros = got.cutoff.numpy()[1]
    if name in ("max_active", "min_active_0"):
        assert zeros == 0.0, "row 1's order statistic is a zero"


@pytest.mark.parametrize("P,name", CASES, ids=[f"P{P}-{n}" for P, n in CASES])
def test_rank_select_merge_matches_sort(P, name):
    """The kernel's method, step for step (:func:`search_merge`), equals
    the sort-based plain merge bit for bit."""
    kw = CONFIGS[name](P)
    costs = shard_costs(100 * P + len(name), P, kw)
    want = port_global_cutoff(costs, kw, merge=global_cutoff_merge_plain)
    got = port_global_cutoff(costs, kw, merge=search_merge)
    same_bits(want.cutoff, got.cutoff, "cutoff")
    same_bits(want.adaptive_beam, got.adaptive_beam, "adaptive beam")


@pytest.mark.parametrize("width", [16, 128, 2048])
def test_local_half(width):
    """The local half: a row's first smallest finite cost in slot order
    (its bits: -0.0 and +0.0 mixed past the widths ``amin`` vectorises),
    the finite count, the prefix copied; +inf for a row with none."""
    rng = np.random.default_rng(width)
    c = rng.choice(np.array([0.0, -0.0, 1.5, -2.0, np.inf], np.float32), size=(5, width))
    c[1] = rng.choice(np.array([0.0, -0.0, np.inf], np.float32), size=width)
    c[2] = np.inf
    c[3, 0], c[3, 1:] = 0.0, rng.choice(np.array([-0.0, 3.0], np.float32), size=width - 1)
    m = min(width, 7)
    got = global_cutoff_local_plain(torch.from_numpy(c), m)
    masked = np.where(np.isfinite(c), c, INF)
    first = np.array([r[np.flatnonzero(r == r.min())[0]] for r in masked], np.float32)
    same_bits(first, got.best, "best")
    assert not np.signbit(got.best[3].item()), "row 3's first zero is +0.0"
    assert got.count.dtype == torch.int32
    assert got.count.tolist() == np.isfinite(c).sum(axis=1).tolist()
    same_bits(c[:, :m], got.prefix, "prefix")
    assert got.prefix.is_contiguous()


def _decoder_cases():
    """A Viterbi and a lattice decode at P = 2 with max_active binding,
    each keeping the states it hands ``_global_cutoff`` and the inputs of
    K8's merge (the local half folded into the frame before's K3 shard
    mode, then reduced and gathered)."""
    rng = np.random.default_rng(9)
    V, T = 5, 12
    g = graph_from_numpy(jax_compile(random_fst(60, V, rng, mean_arcs_per_state=5.0)))
    scores = np.log(rng.dirichlet(np.ones(V), size=(2, T))).astype(np.float32)
    ckw = dict(beam=20.0, max_active=6, min_active=2, frontier_size=16)
    cases = {}
    for kind, dkw in (("ShardedViterbiDecoder", dict(pad_time_to=8)),
                      ("ShardedLatticeDecoder", dict(lattice_beam=6.0, pad_time_to=8,
                                                     em_records=128, eps_records=64))):
        cases[kind] = dict(decoder=kind, mesh=((2,), ("model",)),
                           args=(g, config_for_graph(g, **ckw)), kw=dkw, scores=scores,
                           lengths=None, capture=("_global_cutoff", "global_cutoff_merge"))
    return cases, ckw


@pytest.fixture(scope="module")
def decoded():
    cases, ckw = _decoder_cases()
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(dict(world=2, cases=cases), tmp), ckw


@pytest.mark.parametrize("kind", ["ShardedViterbiDecoder", "ShardedLatticeDecoder"])
def test_decoder_states_suit_the_merge(decoded, kind):
    """On the states a sharded decode hands ``_global_cutoff`` (every
    frame, both shards): each row in order under the canonical key, as
    the kernel's merge reads it; the merge's inputs (the local half that
    the frame before's K3 shard mode wrote from the eps closure's values,
    reduced and gathered) equal to K8's plain local half of those states
    composed around the collectives, bit for bit; the composed halves
    equal to JAX and the kernel's method (:func:`search_merge`) to the
    sort-based one."""
    ranks, ckw = decoded
    calls = [r[kind][1]["_global_cutoff"] for r in ranks]
    merges = [r[kind][1]["global_cutoff_merge"] for r in ranks]
    assert len(calls[0]) == len(calls[1]) == len(merges[0]) == len(merges[1]) > 8
    kw = {k: v for k, v in ckw.items() if k != "frontier_size"}
    k = ckw["frontier_size"]
    m = min(max(kw["max_active"], kw["min_active"]) + 1, k)
    bound = 0
    for i, (a, b) in enumerate(zip(*calls)):
        costs = [a[0].costs.numpy(), b[0].costs.numpy()]
        for q, c in enumerate(costs):
            assert (c[:, 1:] >= c[:, :-1]).all(), f"call {i}, shard {q}: a row out of order"
        locs = [global_cutoff_local_plain(torch.from_numpy(c), m) for c in costs]
        for q in range(2):
            best, count, merged = merges[q][i][:3]
            same_bits(torch.minimum(locs[0].best, locs[1].best), best, f"call {i}: best")
            assert torch.equal(locs[0].count + locs[1].count, count), f"call {i}: count"
            same_bits(torch.stack([loc.prefix for loc in locs]), merged, f"call {i}: prefixes")
        want = jax_global_cutoff(costs, kw, k)
        got = port_global_cutoff(costs, kw, k=k)
        alt = port_global_cutoff(costs, kw, search_merge, k)
        for q in range(2):
            same_bits(want[0][q], got.cutoff, f"call {i}: cutoff")
            same_bits(want[1][q], got.adaptive_beam, f"call {i}: adaptive beam")
        same_bits(got.cutoff, alt.cutoff, f"call {i}: search-merge cutoff")
        same_bits(got.adaptive_beam, alt.adaptive_beam, f"call {i}: search-merge adaptive beam")
        bound += int((sum(np.isfinite(c).sum(axis=1) for c in costs) > kw["max_active"]).sum())
    assert bound > 0, "max_active must bind on some frame"


def edge_costs(seed: int, P: int, case: str) -> list:
    """P (B, K) shards for the merge's edge cases.  "equal": every shard
    holds the same costs (each key once in every shard, ties by shard
    only), row 1 a few values many times; "zeros": -0.0 and +0.0 in turn
    at the front of every shard, row 1 a shard of -0.0 beside one of
    +0.0; "inf": row 0 all +inf in shard 0 only, row 1 in every shard but
    the last, row 2 everywhere; "clamp": full shards, so that the ranks
    past P*m - 1 read the last element."""
    rng = np.random.default_rng(seed)
    rows = np.full((P, B, K), INF, np.float32)
    base = (rng.integers(0, 40, size=(B, K)) * 0.25).astype(np.float32)
    for q in range(P):
        rows[q] = base if case == "equal" else rng.integers(0, 40, size=(B, K)) * 0.25
    if case == "equal":
        rows[:, 1] = rng.choice(np.array([0.5, 1.0, 2.0], np.float32), size=K)
    elif case == "zeros":
        n = min(K - 2, 10)
        for q in range(P):
            rows[q, :, :n] = np.where(np.arange(n) % 2 == q % 2, -0.0, 0.0)
            rows[q, 1, :n] = -0.0 if q % 2 else 0.0
    elif case == "inf":
        rows[0, 0] = INF
        rows[:P - 1, 1] = INF
        rows[:, 2] = INF
    return [total_order(rows[q]) for q in range(P)]


EDGE_CONFIGS = {
    "equal": lambda P: dict(beam=9.0, max_active=5, min_active=3, beam_delta=0.5),
    "zeros": lambda P: dict(beam=9.0, max_active=P + 3, min_active=2, beam_delta=0.5),
    "inf": lambda P: dict(beam=0.75, max_active=12, min_active=6, beam_delta=0.25),
    "clamp": lambda P: dict(beam=30.0, max_active=P * K + 3, min_active=P * K - 1,
                            beam_delta=0.5),
}
EDGE_CASES = [(P, c) for P in (2, 3, 4, 8) for c in EDGE_CONFIGS]


@pytest.mark.parametrize("P,case", EDGE_CASES, ids=[f"P{P}-{c}" for P, c in EDGE_CASES])
def test_global_cutoff_merge_edges_match_jax(P, case):
    """The merge's edge cases: K8's plain halves composed around the
    collectives, and the kernel's method (:func:`search_merge`), equal the
    JAX ``_global_cutoff`` bit for bit on every shard's result."""
    kw = EDGE_CONFIGS[case](P)
    costs = edge_costs(1000 * P + len(case), P, case)
    want = jax_global_cutoff(costs, kw)
    for merge in (global_cutoff_merge, search_merge):
        got = port_global_cutoff(costs, kw, merge=merge)
        for q in range(P):
            same_bits(want[0][q], got.cutoff.numpy(), f"{merge.__name__}, shard {q}: cutoff")
            same_bits(want[1][q], got.adaptive_beam.numpy(),
                      f"{merge.__name__}, shard {q}: adaptive beam")
    got = got.cutoff.numpy()
    if case == "zeros":
        assert got[1] == 0.0, "row 1's order statistic is a zero"
    elif case == "inf":
        assert np.isinf(got[2]) and np.isfinite(got[0])
    elif case == "clamp":
        assert np.isfinite(got).all(), "min_active at P*K - 1 binds on full shards"


def wide_shards(seed: int, P: int, nb: int, m: int) -> torch.Tensor:
    """(P, nb, m) prefixes as wide as the sharded phases' (m 2048), each
    row in IEEE total order: costs on a 0.25 grid (ties within and across
    shards), a run of -0.0 and +0.0 in turn at the front, +inf tails of
    different lengths."""
    rng = np.random.default_rng(seed)
    rows = (rng.integers(-8, 120, size=(P, nb, m)) * 0.25).astype(np.float32)
    rows[:, :, :m // 16] = np.where(np.arange(m // 16) % 2, -0.0, 0.0).astype(np.float32)
    for q in range(P):
        rows[q, :, m - int(rng.integers(0, m // 4)):] = INF
    return torch.from_numpy(np.stack([total_order(rows[q]) for q in range(P)]))


@pytest.mark.parametrize("P", [2, 3, 4, 8])
def test_search_merge_wide_matches_sort(P):
    """The kernel's method (:func:`search_merge`) against the sort-based
    plain merge, bit for bit, on rows of m 2048, where each search takes
    several rounds: at the sharded phases' targets (max_active 2560,
    min_active 200), at the ends of the merged order and past it (the
    clamp); rows whose count leaves a target unread and rows that read
    both."""
    m, nb = 2048, 4
    merged = wide_shards(P, P, nb, m)
    finite = torch.isfinite(merged).sum(dim=(0, 2), dtype=torch.int32)
    count = torch.where(torch.arange(nb) % 2 == 1, 1 << 20, finite).to(torch.int32)
    best = torch.where(torch.isfinite(merged), merged, INF).amin(dim=(0, 2))
    for max_active, min_active in ((2560, 200), (P * m - 1, 1), (P * m + 5, P * m - 1)):
        a = (best, count, merged, 15.0, 0.5, max_active, min_active)
        want, got = global_cutoff_merge_plain(*a), search_merge(*a)
        same_bits(want.cutoff, got.cutoff, (max_active, min_active, "cutoff"))
        same_bits(want.adaptive_beam, got.adaptive_beam,
                  (max_active, min_active, "adaptive beam"))


# name -> (config kwargs given P, what m is): the early return (m == 1, the
# best alone), 1 < m < K (a prefix of its own), m == K (the costs are the
# prefix: the all-gather reads them in place).
FOLD_CONFIGS = {
    "m1": (lambda P: dict(beam=9.0, max_active=P * K, min_active=0, beam_delta=0.5), 1),
    "mid": (lambda P: dict(beam=9.0, max_active=5, min_active=3, beam_delta=0.5), 6),
    "mK": (lambda P: dict(beam=30.0, max_active=K + 4, min_active=3, beam_delta=0.5), K),
}
FOLD_CASES = [(P, name) for P in (1, 2, 4) for name in FOLD_CONFIGS]


def fold_frame(seed: int, P: int):
    """One sharded frame's tail inputs on P shards: per shard the carried
    costs (the frame's start state) and the eps closure's frontier (each
    row in IEEE total order), the rows still decoding, and each row's
    reduced best cost.  Row 0 random; row 1 a minimum of 0 whose first
    slot is -0.0 on even shards and +0.0 on odd ones, the reduced best
    +0.0 (so the rebased first slot keeps -0.0); row 2 no finite cost on
    any shard; row 3 frozen; row 4 negative costs, ties across shards;
    row 5 a minimum of -0.0 and +0.0, the reduced best -0.0; row 6 frozen
    with zeros of both signs carried; row 7 finite on shard 0 alone."""
    rng = np.random.default_rng(seed)
    old = np.full((P, B + 2, K), INF, np.float32)
    mid = np.full((P, B + 2, K), INF, np.float32)
    for q in range(P):
        for x in (old, mid):
            n = int(rng.integers(K // 2, K + 1))
            x[q, 0, :n] = rng.integers(0, 40, size=n) * 0.5 - 3.0
            x[q, 3, :] = rng.integers(0, 30, size=K) * 0.25
            x[q, 4, :] = rng.integers(-6, 3, size=K) * 0.5
            x[q, 4, K - 3:] = INF
        z = int(rng.integers(3, K - 3))
        signs = np.where(rng.random(z) < 0.5, -0.0, 0.0).astype(np.float32)
        signs[0] = -0.0 if q % 2 == 0 else 0.0
        for r in (1, 5):
            mid[q, r, :z] = signs
            mid[q, r, z:] = rng.integers(1, 20, size=K - z) * 0.25
        old[q, 6, :z] = signs
        old[q, 6, z:] = rng.integers(1, 20, size=K - z) * 0.25
        if q == 0:
            mid[q, 7, :5] = rng.integers(0, 8, size=5) * 0.5
    old = np.stack([total_order(old[q]) for q in range(P)])
    mid = np.stack([total_order(mid[q]) for q in range(P)])
    active = np.ones(B + 2, bool)
    active[[3, 6]] = False
    best = np.min(np.where(np.isfinite(mid), mid, INF), axis=(0, 2)).astype(np.float32)
    best[1], best[5] = np.float32(0.0), np.float32(-0.0)
    return old, mid, active, best


@pytest.mark.parametrize("P,name", FOLD_CASES, ids=[f"P{P}-{n}" for P, n in FOLD_CASES])
def test_folded_local_half_matches_jax(P, name):
    """K8's local half folded into K3's shard mode (``frame_tail_shard_plain``
    with ``local``: a live row's best ``red_min - m_safe`` and count
    ``red_count`` from the eps closure's values, its prefix the new costs'
    first m, a frozen row's kept) equals K8's plain local half of the new
    costs bit for bit, -0.0 beside +0.0 included; composed with the plain
    merge it equals the JAX ``_global_cutoff`` of the next frame, on the
    costs that the JAX rebase (``jnp.where(fa, mid - m_safe, st.costs)``)
    gives, bit for bit, at m == 1 (the early return), 1 < m < K and m ==
    K, with frozen rows, a row with no finite cost and a row whose
    minimum is -0.0 against +0.0."""
    make, m = FOLD_CONFIGS[name]
    kw = make(P)
    old, mid, active, best = fold_frame(7 * P + len(name), P)
    nb = old.shape[1]
    early = kw["max_active"] >= P * K and kw["min_active"] == 0
    assert (m == 1) == early and (m == K) == (name == "mK")
    m_safe = np.where(np.isfinite(best), best, np.float32(0.0)).astype(np.float32)
    fa = torch.from_numpy(active)
    nxt, new = [], []
    for q in range(P):
        red_min, red_count = first_min_count(torch.from_numpy(mid[q]))
        zeros = torch.zeros((nb, K), dtype=torch.int32)
        st = StepState(zeros, torch.from_numpy(old[q]), torch.zeros(nb))
        loc = global_cutoff_local_plain(st.costs, m)
        if early or m == K:
            loc = loc._replace(prefix=None)
        tin = ShardTailInputs(zeros, torch.from_numpy(mid[q]), torch.from_numpy(best),
                              red_count * 0, torch.zeros(2, dtype=torch.int32),
                              em_records=torch.zeros((nb, 4, 4), dtype=torch.int32),
                              eps_records=torch.zeros((nb, 1, 2, 2), dtype=torch.int32),
                              red_min=red_min, red_count=red_count)
        final, _, got = frame_tail_shard_plain(st, torch.zeros(nb), tin, fa, 0, loc)
        want_costs = np.where(active[:, None], mid[q] - m_safe[:, None], old[q])
        same_bits(want_costs, final.costs, f"shard {q}: the rebased costs")
        want = global_cutoff_local_plain(final.costs, m)
        same_bits(want.best, got.best, f"shard {q}: best")
        assert torch.equal(want.count, got.count), f"shard {q}: count"
        if got.prefix is not None:
            same_bits(want.prefix, got.prefix, f"shard {q}: prefix")
        nxt.append(got)
        new.append(want_costs.astype(np.float32))
    zero = [g.best[1].item() for g in nxt]
    assert any(z == 0.0 and np.signbit(z) for z in zero), "row 1 keeps a -0.0 first slot"
    fc = FrontierConfig(frontier_size=K, **kw)
    bst = nxt[0].best
    for g in nxt[1:]:
        bst = torch.minimum(bst, g.best)
    count = merged = None
    if not early:
        count = sum(g.count for g in nxt).to(torch.int32)
        merged = torch.stack([g.prefix if g.prefix is not None else torch.from_numpy(c)[:, :m]
                              for g, c in zip(nxt, new)])
    got = global_cutoff_merge_plain(bst, count, merged, fc.beam, fc.beam_delta, fc.max_active,
                                    fc.min_active)
    want = jax_global_cutoff(new, kw)
    for q in range(P):
        same_bits(want[0][q], got.cutoff.numpy(), f"shard {q}: cutoff")
        same_bits(want[1][q], got.adaptive_beam.numpy(), f"shard {q}: adaptive beam")
