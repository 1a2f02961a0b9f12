"""The port's state-sharded decoders against the JAX package's, on the CPU.

The JAX side runs ``kaldi_decoder_tpu.parallel.graph_shard`` on the
suite's virtual 8-device CPU mesh; the port runs
``kaldi_decoder_tpu_torch.parallel.graph_shard`` in P spawned processes
that exchange over gloo (``tests/_torch_dist_worker.py``), one shard a
rank.  Inputs are made with numpy from fixed seeds and handed to both.

Exactness: every float operation of the sharded frame is an add,
subtract, compare or min in the JAX order, and the reductions over the
shards are min, max, sum of integers and a gather, so every field of the
results is equal, floats by their raw bits: backpointers, frontiers,
records, per-frame counts, best costs, cutoffs and flags.  On top of that
the 1-best labels and the pruned lattices' links are compared.

Cases: ``shard_graph`` at P = 2 and 4 (parts, offsets, a rank's own part);
``_route`` on a seeded batch with -0.0, exact-cost ties and an
overflowing bucket, best-path and lattice; ``_global_cutoff`` with
max_active binding; the seven decoder cases of
``tests/test_graph_shard.py`` at P = 2 and P = 4 (the HL-scale one at the
original's P = 4), and a 2 x 2 ``("data", "model")`` mesh.
"""

import os
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from kaldi_decoder_tpu.decoders.frontier import StepState as JaxStepState
from kaldi_decoder_tpu.decoders.frontier import config_for_graph as jax_config
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import ctc_topo, random_fst
from kaldi_decoder_tpu.fst.ops import compose
from kaldi_decoder_tpu.fst.topo import lexicon_fst
from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch.decoders.frontier import StepState
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.fst.ops import path_labels
from kaldi_decoder_tpu_torch.parallel import graph_shard as pgs

from _torch_dist_worker import run_ranks
from _torch_util import small_hlg

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

VITERBI_FIELDS = ("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
                  "num_active", "best_costs", "cutoffs", "overflows", "saturations")
LATTICE_FIELDS = ("init_states", "init_costs", "init_eps_records", "frame_states",
                  "frame_costs", "em_records", "eps_records", "num_active", "cutoffs",
                  "overflows", "saturations")


def rand_logp(rng, T, V):
    return np.log(rng.dirichlet(np.ones(V), size=T)).astype(np.float32)


def same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    assert np.array_equal(a, b), what


def jax_mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


# ---------------------------------------------------------------------------
# The decoder cases of tests/test_graph_shard.py, each a (JAX graph, kind,
# config kwargs, decoder kwargs, scores, lengths) made from its seed.
# ---------------------------------------------------------------------------


def _ctc_topo():
    rng = np.random.default_rng(0)
    V, T, B = 6, 12, 4
    g = jax_compile(ctc_topo(V))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=16.0, min_active=0), dict(pad_time_to=8), scores, \
        np.array([12, 9, 5, 12], np.int32)


def _random_fst():
    rng = np.random.default_rng(3)
    V, T, B = 5, 10, 4
    g = jax_compile(random_fst(30, V, rng))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=1000.0, min_active=0, frontier_size=16), \
        dict(pad_time_to=8), scores, None


def _model_plus_data():
    rng = np.random.default_rng(5)
    V, T, B = 6, 8, 4
    g = jax_compile(ctc_topo(V))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=16.0, min_active=0), dict(pad_time_to=8), scores, None


def _max_active():
    rng = np.random.default_rng(9)
    V, T, B = 5, 12, 2
    g = jax_compile(random_fst(60, V, rng, mean_arcs_per_state=5.0))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=20.0, max_active=6, min_active=2, frontier_size=16), \
        dict(pad_time_to=8), scores, None


def _lattice(seed):
    rng = np.random.default_rng(seed)
    V, T, B = 5, 10, 2
    g = jax_compile(random_fst(40, V, rng, mean_arcs_per_state=4.0))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "lattice", dict(beam=12.0, min_active=0, frontier_size=16), \
        dict(lattice_beam=6.0, pad_time_to=8, em_records=128, eps_records=64), scores, None


def _hl_scale():
    rng = np.random.default_rng(0)
    V, T = 50, 30
    lex = []
    for w in range(600):
        ln = int(rng.integers(3, 9))
        lex.append((1000 + w, rng.integers(1, V, size=ln).tolist()))
    L = lexicon_fst(lex, word_weights=rng.uniform(0, 4, len(lex)).tolist())
    g = jax_compile(compose(ctc_topo(V), L))
    ids = []
    srng = np.random.default_rng(42)
    while len(ids) < T:
        _, toks = lex[int(srng.integers(len(lex)))]
        ids.extend(toks)
        ids.append(0)
    logp = np.log(srng.dirichlet(np.ones(V) * 0.3, size=T))
    logp[np.arange(T), np.array(ids[:T])] += 3.2
    logp -= np.log(np.exp(logp).sum(1, keepdims=True))
    return g, "lattice", dict(beam=8.0, max_active=1500, min_active=100, frontier_size=2048), \
        dict(lattice_beam=5.0, pad_time_to=T, em_records=8192, eps_records=1024), \
        logp.astype(np.float32)[None], None


def _lattice_max_active():
    rng = np.random.default_rng(2)
    V, T = 5, 10
    g = jax_compile(random_fst(60, V, rng, mean_arcs_per_state=5.0))
    scores = rand_logp(rng, T, V)[None]
    return g, "lattice", dict(beam=20.0, max_active=6, min_active=2, frontier_size=16), \
        dict(lattice_beam=6.0, pad_time_to=8, em_records=128, eps_records=64), scores, None


MODEL_CASES = {
    "ctc_topo": _ctc_topo,
    "random_fst": _random_fst,
    "max_active": _max_active,
    "lattice1": lambda: _lattice(1),
    "lattice4": lambda: _lattice(4),
    "lattice_max_active": _lattice_max_active,
}
# (case, mesh shape, mesh axes): every model case at P = 2 and 4, the
# HL-scale one at P = 4 only (as the original), and the 2 x 2 mesh.
RUNS = (
    [(c, (p,), ("model",)) for p in (2, 4) for c in MODEL_CASES]
    + [("hl_scale", (4,), ("model",)), ("model_plus_data", (2, 2), ("data", "model"))]
)
CASES = dict(MODEL_CASES, hl_scale=_hl_scale, model_plus_data=_model_plus_data)


def run_name(case, shape):
    return f"{case}_{'x'.join(map(str, shape))}"


# ---------------------------------------------------------------------------
# The unit cases: _route and _global_cutoff, per rank
# ---------------------------------------------------------------------------

ROUTE_P, ROUTE_B, ROUTE_N, ROUTE_SP = 2, 2, 64, 12


def route_inputs():
    """Per rank (dst_g, cost, gslot, arc_g) (B, N): a few states (so runs
    are long), costs on a 0.25 grid (exact ties) with -0.0 and +0.0, +inf
    lanes, one owner's bucket past the cap."""
    rng = np.random.default_rng(7)
    P, B, N, sp = ROUTE_P, ROUTE_B, ROUTE_N, ROUTE_SP
    out = []
    for _ in range(P):
        dst = rng.integers(0, P * sp - 3, size=(B, N)).astype(np.int32)
        dst[:, : N // 2] = rng.integers(0, sp, size=(B, N // 2))  # crowd owner 0
        cost = (rng.integers(-2, 6, size=(B, N)) * 0.25).astype(np.float32)
        cost[:, ::7] = -0.0
        cost[:, 3::11] = np.inf
        gslot = rng.integers(0, 100, size=(B, N)).astype(np.int32)
        arc = rng.integers(0, 1000, size=(B, N)).astype(np.int32)
        out.append((dst, cost, gslot, arc))
    return out


ROUTE_CAP = 10  # owner 0's crowd has more distinct states: its bucket overflows


def cutoff_inputs():
    """Per rank a cost-sorted (B, K) frontier, with ties across ranks."""
    rng = np.random.default_rng(11)
    P, B, K = 2, 3, 16
    out = []
    for p in range(P):
        c = np.sort((rng.integers(0, 40, size=(B, K)) * 0.5).astype(np.float32), axis=1)
        c[1, 10:] = np.inf
        c[2, 3 + p:] = np.inf
        out.append((rng.integers(0, 50, size=(B, K)).astype(np.int32), c))
    return out


def cutoff_config():
    """A ShardConfig-like config (K 16 a shard, 2 shards) with max_active
    binding, for both packages."""
    kw = dict(beam=9.0, max_active=5, min_active=3, beam_delta=0.5, frontier_size=16)
    from kaldi_decoder_tpu.decoders.frontier import FrontierConfig as JaxFrontierConfig
    from kaldi_decoder_tpu_torch.decoders.frontier import FrontierConfig

    j = jgs.ShardConfig(frontier=JaxFrontierConfig(**kw), num_parts=2, part_size=50,
                        route_cap=64, eps_route_cap=64)
    p = pgs.ShardConfig(frontier=FrontierConfig(**kw), num_parts=2, part_size=50,
                        route_cap=64, eps_route_cap=64)
    return j, p


def _unit_cases():
    routes = route_inputs()
    _, pcfg = cutoff_config()
    cuts = cutoff_inputs()
    cases = {}
    for beam in (None, 0.5):
        cases[f"route_{beam}"] = dict(
            call="_route", mesh=((ROUTE_P,), ("model",)),
            rank_args=[tuple(torch.from_numpy(x) for x in r) + (ROUTE_SP, ROUTE_P, ROUTE_CAP)
                       for r in routes],
            kw=dict(local_slack_beam=beam))
    cases["global_cutoff"] = dict(
        call="_global_cutoff", mesh=((2,), ("model",)),
        rank_args=[(StepState(torch.from_numpy(s), torch.from_numpy(c),
                              torch.zeros(c.shape[0])), pcfg) for s, c in cuts],
        kw={})
    return cases


# ---------------------------------------------------------------------------
# One run of the port's ranks per world size, and the JAX results
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def port_results():
    """{world: [rank results]}: the P = 2 world runs the P = 2 cases and the
    unit cases, the 4-rank world the P = 4 and 2 x 2 cases; both at once."""
    jobs = {2: dict(world=2, cases=_unit_cases()), 4: dict(world=4, cases={})}
    for case, shape, names in RUNS:
        g, kind, ckw, dkw, scores, lengths = CASES[case]()
        pg = graph_from_numpy(g)
        jobs[int(np.prod(shape))]["cases"][run_name(case, shape)] = dict(
            decoder="ShardedViterbiDecoder" if kind == "viterbi" else "ShardedLatticeDecoder",
            mesh=(shape, names), args=(pg, config_for_graph(pg, **ckw)), kw=dkw,
            scores=scores, lengths=lengths)
    out, errors = {}, []

    def go(world, tmp):
        try:
            out[world] = run_ranks(jobs[world], tmp)
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)

    with tempfile.TemporaryDirectory() as t2, tempfile.TemporaryDirectory() as t4:
        threads = [threading.Thread(target=go, args=(w, t)) for w, t in ((2, t2), (4, t4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    if errors:
        raise errors[0]
    return out


def port_run(port_results, name, world):
    """Rank 0's result of run ``name``, after checking that every rank
    got the same."""
    ranks = port_results[world]
    first = ranks[0][name]
    for r in ranks[1:]:
        other = r[name]
        fields = VITERBI_FIELDS if hasattr(first, "bp_emit") else LATTICE_FIELDS
        for f in fields:
            same_array(getattr(first, f), getattr(other, f), f"{name}: {f} of another rank")
    return first


def jax_decode(case, shape, names):
    g, kind, ckw, dkw, scores, lengths = CASES[case]()
    cls = jgs.ShardedViterbiDecoder if kind == "viterbi" else jgs.ShardedLatticeDecoder
    dec = cls(g, jax_config(g, **ckw), mesh=jax_mesh(shape, names), **dkw)
    return kind, dec.decode(scores, lengths)


def links(pl):
    """The kept links of a PrunedLattice of either package, as in
    ``tests/test_graph_shard.py``, costs by their float32 bits."""
    out = set()
    for f in range(pl.num_frames + 1):
        toks = pl.tokens[f]
        for lk, fd in ((pl.eps_links[f], f),
                       (pl.em_links[f] if f < pl.num_frames else None, f + 1)):
            if lk is None:
                continue
            dtoks = pl.tokens[fd]
            for i in range(len(lk.src)):
                if lk.keep[i]:
                    out.add((f, int(toks.states[lk.src[i]]), fd, int(dtoks.states[lk.dst[i]]),
                             int(lk.ilabel[i]), int(lk.olabel[i]),
                             int(np.float32(lk.graph_cost[i]).view(np.int32)),
                             int(np.float32(lk.ac_cost[i]).view(np.int32))))
    return out


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_parts", [2, 4])
def test_shard_graph_matches_jax(num_parts):
    """Parts, offsets and packed tables equal JAX's, and a rank's own part
    (``local_part``: ``pack_graph_device`` of its slice) equals its slice
    of the stacked tables up to the pad rows, which hold +inf weights."""
    _, jg, pg = small_hlg()
    fc = config_for_graph(pg)
    args = (num_parts, fc.block_width, fc.eps_block_width, fc.flat_group)
    jsg, psg = jgs.shard_graph(jg, *args), pgs.shard_graph(pg, *args)
    assert (psg.num_parts, psg.part_size) == (jsg.num_parts, jsg.part_size)
    same_array(jsg.em_arc_offset, psg.em_arc_offset, "em_arc_offset")
    same_array(jsg.eps_arc_offset, psg.eps_arc_offset, "eps_arc_offset")
    for f in psg.packed._fields:
        same_array(getattr(jsg.packed, f), getattr(psg.packed, f), f)
    for p in range(num_parts):
        own = pgs.local_part(pg, num_parts, p, *args[1:], "cpu")
        assert (own.num_parts, own.part_size) == (jsg.num_parts, jsg.part_size)
        assert (own.em_arc_offset, own.eps_arc_offset) == (
            int(jsg.em_arc_offset[p]), int(jsg.eps_arc_offset[p]))
        for f in own.packed._fields:
            got = getattr(own.packed, f).numpy()
            want = getattr(jsg.packed, f)[p]
            same_array(want[: got.shape[0]], got, f"part {p}: {f}")
            fields = pgs.EM_FIELDS if f == "em_flat" else pgs.EPS_FIELDS
            pad = want[got.shape[0]:]
            assert (pad[:, ::fields] == pgs.INF_BITS).all(), f"part {p}: {f} pad rows"
        lo = min(p * psg.part_size, jg.num_states)
        hi = min((p + 1) * psg.part_size, jg.num_states)
        jpart = jgs._slice_part(jg.arrays, lo, hi, jsg.part_size)
        ppart = pgs._slice_part(pg.arrays, lo, hi, psg.part_size)
        for f in jpart.arrays._fields:
            same_array(getattr(jpart.arrays, f), getattr(ppart.arrays, f), f"part {p}: {f}")


def _jax_route(beam):
    P = ROUTE_P
    mesh = jax_mesh((P,), ("model",))
    ins = [np.stack(x) for x in zip(*route_inputs())]  # each (P, B, N)

    def f(d, c, s, a):
        rt = jgs._route(d[0], c[0], s[0], a[0], ROUTE_SP, P, ROUTE_CAP, "model",
                        local_slack_beam=beam)
        return jax.tree.map(lambda x: x[None], tuple(rt))

    spec = JP("model")
    fn = shard_map(f, mesh=mesh, in_specs=(spec,) * 4, out_specs=(spec,) * 5, check_vma=False)
    return [np.asarray(x) for x in jax.jit(fn)(*map(jnp.asarray, ins))]


@pytest.mark.parametrize("beam", [None, 0.5])
def test_route_matches_jax(port_results, beam):
    """``_route`` at P = 2, exchanged over gloo, is bit-equal to JAX's:
    every receive buffer and the overflow flag, which this batch raises."""
    want = _jax_route(beam)
    assert want[4].any(), "the batch must overflow a bucket"
    c = route_inputs()[0][1]
    assert ((c == 0) & np.signbit(c)).any() and ((c == 0) & ~np.signbit(c)).any()
    for r in range(ROUTE_P):
        got = port_results[2][r][f"route_{beam}"]
        for i, name in enumerate(pgs.Routed._fields):
            same_array(want[i][r], got[i].numpy(), f"rank {r}: {name}")


def test_global_cutoff_matches_jax(port_results):
    """``_global_cutoff`` with max_active binding (the order statistics of
    the union of the shards' frontiers) equals JAX's on every rank."""
    jcfg, _ = cutoff_config()
    cuts = cutoff_inputs()
    mesh = jax_mesh((2,), ("model",))

    def f(s, c):
        st = JaxStepState(s[0], c[0], jnp.zeros((c.shape[1],), jnp.float32))
        return tuple(x[None] for x in jgs._global_cutoff(st, jcfg, "model"))

    spec = JP("model")
    fn = shard_map(f, mesh=mesh, in_specs=(spec, spec), out_specs=(spec, spec), check_vma=False)
    want = [np.asarray(x) for x in jax.jit(fn)(*(jnp.asarray(np.stack(x)) for x in zip(*cuts)))]
    count = sum(np.isfinite(c).sum(axis=1) for _, c in cuts)
    assert (count > jcfg.frontier.max_active).any(), "max_active must bind"
    for r in range(2):
        got = port_results[2][r]["global_cutoff"]
        same_array(want[0][r], got[0].numpy(), f"rank {r}: cutoff")
        same_array(want[1][r], got[1].numpy(), f"rank {r}: adaptive beam")


@pytest.mark.parametrize("case,shape,names", RUNS, ids=[run_name(c, s) for c, s, _ in RUNS])
def test_sharded_decode_matches_jax(port_results, case, shape, names):
    """Every field of the port's sharded decode equals JAX's, on every
    rank; so do the 1-best labels and, for the lattice, the pruned links."""
    kind, want = jax_decode(case, shape, names)
    got = port_run(port_results, run_name(case, shape), int(np.prod(shape)))
    for f in VITERBI_FIELDS if kind == "viterbi" else LATTICE_FIELDS:
        same_array(getattr(want, f), getattr(got, f), f)
    for b in range(want.scores.shape[0]):
        lw, lg = want.best_path(b), got.best_path(b)
        assert (lw is None) == (lg is None)
        if lw is not None:
            assert path_labels(lg) == [int(x) for x in jax_path_labels(lw)], f"utt {b}"
        if kind == "lattice":
            pw, pg_ = want._prune(b), got._prune(b)
            assert (pw is None) == (pg_ is None)
            if pw is not None:
                assert links(pw) == links(pg_), f"utt {b}"
    if case == "hl_scale":  # the original's guard that the case is hard enough
        assert float(np.max(got.stats(0).active_per_frame)) >= 1000


def jax_path_labels(lat):
    from kaldi_decoder_tpu.fst.ops import path_labels as jpl

    return jpl(lat)


def test_sharded_decoders_need_a_mesh():
    _, _, pg = small_hlg()
    for cls in (pgs.ShardedViterbiDecoder, pgs.ShardedLatticeDecoder):
        with pytest.raises(ValueError, match="requires a mesh"):
            cls(pg, device="cpu")


def test_worker_imports_no_jax():
    """The rank worker and the parallel package load without jax."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.modules['jax'] = None; sys.path.insert(0, %r); "
            "sys.path.insert(0, %r); import _torch_dist_worker; "
            "import kaldi_decoder_tpu_torch.parallel; "
            "assert not any(m.startswith('kaldi_decoder_tpu.') or m == 'kaldi_decoder_tpu' "
            "for m in sys.modules)" % (os.path.dirname(here), here))
    subprocess.run([sys.executable, "-c", code], check=True)


def test_shard_reference_matches_its_script():
    """``tests/data/torch_port_shard_ref.json`` (the reference of
    ``chip_smoke.py`` phases 12-13) was made by
    ``scripts/make_torch_shard_reference.py`` at the smoke's config, cut
    and parts, and each part's shard config is the one the port derives
    for the bench graph."""
    import importlib.util
    import json

    import chip_smoke as cs
    from kaldi_decoder_tpu_torch.fst.csr import load_graph_npz

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "make_torch_shard_reference", os.path.join(repo, "scripts", "make_torch_shard_reference.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    with open(os.path.join(repo, "tests", "data", "torch_port_shard_ref.json")) as f:
        ref = json.load(f)
    bench = type("bench", (), dict(BEAM=cs.SHARD_CONFIG["beam"],
                                   MAX_ACTIVE=cs.SHARD_CONFIG["max_active"]))
    assert ref["requested"] == dict(script.shard_config_kw(bench), lattice_beam=script.LATTICE_BEAM)
    assert ref["requested"] == dict(cs.SHARD_CONFIG, lattice_beam=cs.SHARD_LATTICE_BEAM)
    assert ref["workload"]["frames"] == cs.SHARD_FRAMES and ref["workload"]["utterances"] == cs.B
    assert sorted(ref["parts"]) == [str(p) for p in script.PARTS]
    graph = load_graph_npz(os.path.join(repo, ref["workload"]["graph"]))
    fc = config_for_graph(graph, **cs.SHARD_CONFIG)
    for P, part in ref["parts"].items():
        sg = pgs.shard_graph(graph, int(P), fc.block_width, fc.eps_block_width, fc.flat_group)
        lc = pgs.shard_lattice_config_for(sg, fc, cs.SHARD_LATTICE_BEAM)
        sc = lc.shard
        want = part["shard_config"]
        got = {k: getattr(sc.frontier, k) for k in want if hasattr(sc.frontier, k)}
        got.update(num_parts=sc.num_parts, part_size=sc.part_size, route_cap=sc.route_cap,
                   eps_route_cap=sc.eps_route_cap, em_records=lc.em_records,
                   eps_records=lc.eps_records, lattice_beam=lc.lattice_beam)
        assert got == want, P
        assert len(part["viterbi"]) == len(part["lattice"]) == cs.B
