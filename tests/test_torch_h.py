"""Decoding with the CTC topology H, and sharded frames without eps
iterations: the port against the JAX package, on the CPU.

H (``ctc_topo``) has no eps arcs, so every decoder derives ``eps_iters``
0 on it: a batched frame is K1, K6 or K2, then K3; a sharded frame has no
eps step to write the local values its rebase reduces, and its emitting
dedup call writes them as its last step (``reduce=`` of
``kernels.dedup.dedup_select`` and ``kernels.dedup_rec.dedup_select_rec``).
Inputs are made with numpy from fixed seeds and handed to both packages.

- The emitting K6 call's local values on the CPU (the plain call, then
  ``kernels.dedup.eps_reduce_shard_plain``) against the torch ops of the
  sharded frame's ``D == 0`` branch that the reduction replaced, on raw
  bits, and against JAX's local values (``jnp.min`` of the finite
  frontier costs, their count, the flags): -0.0 and +0.0 at two states
  either way round, an all-+inf row, a row with one finite cost, each
  flag set alone, at B = 1 and 16; its outputs start as garbage, so every
  one is written.
- ``ShardedLatticeDecoder`` (and ``ShardedViterbiDecoder``) on
  ``ctc_topo`` at P = 1 and 2, ranks over gloo (``tests/_torch_dist_worker.py``),
  against the JAX sharded decoders on P virtual CPU devices: every field,
  floats by their bits, the 1-best labels and the pruned links.
- Both sharded decoders with ``eps_iters=0`` set by the caller on a
  ``random_fst`` with eps arcs, at P = 1 and 2, the same way.
- ``BatchedViterbiDecoder`` and ``BatchedLatticeDecoder`` on ``ctc_topo``
  against the JAX batched decoders.
- The teardown (ROADMAP Queue 3): a sharded decoder's ``close()`` and its
  ``with`` block release its kept frame drivers, and a process that ends
  without a teardown call releases every one left at its exit, in a
  subprocess over gloo that imports no jax.
"""

import os
import subprocess
import sys
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxLattice
from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import ctc_topo, random_fst
from kaldi_decoder_tpu.fst.ops import path_labels as jax_path_labels
from kaldi_decoder_tpu.parallel import graph_shard as jgs
from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, BatchedViterbiDecoder
from kaldi_decoder_tpu_torch.decoders.frontier import config_for_graph
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.fst.ops import path_labels
from kaldi_decoder_tpu_torch.kernels.cutoff import first_min_count
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.eps import empty_shard_eps_carry

from _torch_dist_worker import run_ranks
from _torch_util import assert_same_config, jax_host_library, same_fst, twin_configs
from test_torch_graph_shard import (
    LATTICE_FIELDS,
    VITERBI_FIELDS,
    jax_mesh,
    links,
    rand_logp,
    same_array,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# The emitting call's local values (the reduction's plain version)
# ---------------------------------------------------------------------------

REDUCE_CASES = ("neg-zero-first", "pos-zero-first", "all-inf", "one-finite", "overflow0",
                "overflow1", "overflow2", "saturated", "no-flag")


def reduce_inputs(case, B, K=64):
    """(lane states (B, 2K), lane costs (B, 2K), three overflow flags
    (B,)), numpy: lane k of a row at state k, its first K lanes' costs
    positive on a 0.25 grid, a fifth +inf, the rest +inf, nothing
    flagged; ``case`` shapes the last row (a flag of any row counts;
    ``saturated``: its last K lanes finite, so more than K states win)."""
    rng = np.random.default_rng(REDUCE_CASES.index(case) + 10 * B)
    costs = (rng.integers(1, 40, size=(B, K)) * 0.25).astype(np.float32)
    costs[rng.random((B, K)) < 0.2] = np.inf
    ovf = [np.zeros(B, bool) for _ in range(3)]
    extra = np.full((B, K), np.inf, np.float32)
    r = B - 1
    if case.endswith("zero-first"):  # the row's smallest, tied as -0.0 and +0.0
        first, second = (-0.0, 0.0) if case.startswith("neg") else (0.0, -0.0)
        costs[r, 5], costs[r, 9] = np.float32(first), np.float32(second)
    elif case == "all-inf":
        costs[r] = np.inf
    elif case == "one-finite":
        costs[r] = np.inf
        costs[r, K - 3] = 2.5
    elif case.startswith("overflow"):
        ovf[int(case[-1])][r] = True
    elif case == "saturated":
        extra[r] = 10.5
    states = np.tile(np.arange(2 * K, dtype=np.int32), (B, 1))
    return states, np.concatenate([costs, extra], axis=1), ovf


def replaced_ops(costs, ovf, num_unique):
    """The torch ops of the sharded frame's ``D == 0`` branch before the
    reduce mode (``parallel/graph_shard.py`` ``_sharded_eps_closure``)."""
    K = costs.shape[1]
    red_min, red_count = first_min_count(costs)
    o = torch.stack([x.any() for x in ovf]).any()
    flags = torch.stack([x.reshape(()) for x in (o, (num_unique > K).any())]).to(torch.int32)
    return red_min, red_count, flags


@pytest.mark.parametrize("B", [1, 16])
@pytest.mark.parametrize("case", REDUCE_CASES)
def test_reduce_plain_matches_replaced_ops_and_jax(case, B):
    """The emitting K6 call with ``reduce=`` on CPU tensors (the plain
    call, then the reduction's plain version) writes the replaced ops'
    values of its frontier bit for bit into outputs that start as
    garbage; the smallest cost is the first in slot order with that
    slot's bits, and equals JAX's local minimum, count and flags."""
    states, lanes, ovf = reduce_inputs(case, B)
    K = lanes.shape[1] // 2
    flags = tuple(torch.from_numpy(x) for x in ovf)
    carry = empty_shard_eps_carry(B, 0, K, "cpu")
    carry.red_min.view(torch.int32).fill_(-1)  # a NaN
    carry.red_count.fill_(-7)
    carry.red_flags.fill_(5)
    sel = dedup_select(torch.from_numpy(states), torch.from_numpy(lanes), K, 2 * K,
                       reduce=(carry, flags))
    costs, num_unique = sel.costs.numpy(), sel.num_unique.numpy()
    args = (sel.costs, flags, sel.num_unique)
    want = replaced_ops(*args)
    for name, w in zip(("red_min", "red_count", "red_flags"), want):
        same_array(w.numpy(), getattr(carry, name).numpy(), name)
    canon = np.where(costs == 0, np.float32(0.0), costs)
    at = np.argmin(np.where(np.isfinite(costs), canon, np.inf), axis=1)
    first = np.where(np.isfinite(costs).any(axis=1), costs[np.arange(B), at], np.float32(np.inf))
    same_array(first.astype(np.float32), carry.red_min.numpy(), "first smallest in slot order")
    c = jnp.asarray(costs)
    jmin = np.asarray(jnp.min(jnp.where(jnp.isfinite(c), c, jnp.inf), axis=1))
    jcount = np.asarray(jnp.sum(jnp.isfinite(c), axis=1).astype(jnp.int32))
    jflags = [bool(jnp.any(jnp.asarray(ovf[0] | ovf[1] | ovf[2]))),
              bool(jnp.any(jnp.asarray(num_unique) > costs.shape[1]))]
    assert np.array_equal(jmin, carry.red_min.numpy())  # as floats: -0.0 == +0.0
    same_array(jcount, carry.red_count.numpy(), "count")
    assert carry.red_flags.tolist() == [int(f) for f in jflags]
    if case.endswith("zero-first"):  # the frontier puts -0.0 first, whichever lane held it
        assert np.signbit(carry.red_min[-1].item()) and carry.red_min[-1].item() == 0.0
    flagged = {"overflow0": [1, 0], "overflow1": [1, 0], "overflow2": [1, 0],
               "saturated": [0, 1]}.get(case, [0, 0])
    assert carry.red_flags.tolist() == flagged


def test_reduce_wrapper_checks_its_flags():
    """The emitting call's ``reduce`` takes one to three emitting
    overflow flags."""
    states, lanes, ovf = reduce_inputs("no-flag", 2)
    K = lanes.shape[1] // 2
    carry = empty_shard_eps_carry(2, 0, K, "cpu")
    for flags in ((), tuple(torch.from_numpy(x) for x in ovf * 2)):
        with pytest.raises(ValueError, match="one to three"):
            dedup_select(torch.from_numpy(states), torch.from_numpy(lanes), K, 2 * K,
                         reduce=(carry, flags))


# ---------------------------------------------------------------------------
# The sharded decoders at eps_iters 0, ranks over gloo
# ---------------------------------------------------------------------------


def _h_case(kind):
    """ctc_topo(6): 6 states, 36 emitting arcs; K 8 a shard, wider than a
    part at P = 2; min_active and max_active both bind somewhere."""
    rng = np.random.default_rng(21)
    V, T, B = 6, 12, 3
    g = jax_compile(ctc_topo(V))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    dkw = dict(pad_time_to=8)
    if kind == "lattice":
        dkw.update(lattice_beam=6.0, em_records=64, eps_records=16)
    return g, kind, dict(beam=9.0, max_active=4, min_active=2), dkw, scores, \
        np.array([12, 7, 10], np.int32)


def _eps0_case(kind):
    """A random graph with eps arcs, its eps closure turned off by the
    caller's ``eps_iters=0``."""
    rng = np.random.default_rng(4)
    V, T, B = 5, 10, 2
    g = jax_compile(random_fst(40, V, rng, mean_arcs_per_state=4.0))
    assert g.num_eps_arcs > 0
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    dkw = dict(pad_time_to=8)
    if kind == "lattice":
        dkw.update(lattice_beam=6.0, em_records=128, eps_records=64)
    return g, kind, dict(beam=12.0, min_active=0, frontier_size=16, eps_iters=0), dkw, \
        scores, None


SHARD_CASES = {f"{name}_{kind}": (make, kind) for name, make in (("h", _h_case),
                                                                  ("eps0", _eps0_case))
               for kind in ("viterbi", "lattice")}
SHARD_RUNS = [(case, P) for P in (1, 2) for case in SHARD_CASES]


def _shard_case(case):
    make, kind = SHARD_CASES[case]
    return make(kind)


@pytest.fixture(scope="module")
def shard_results():
    """{P: [rank results]}: every case of SHARD_CASES decoded by P ranks
    over gloo, P = 1 and 2 at once."""
    jobs = {P: dict(world=P, cases={}) for P in (1, 2)}
    for case, P in SHARD_RUNS:
        g, kind, ckw, dkw, scores, lengths = _shard_case(case)
        pg = graph_from_numpy(g)
        jobs[P]["cases"][case] = dict(
            decoder="ShardedViterbiDecoder" if kind == "viterbi" else "ShardedLatticeDecoder",
            mesh=((P,), ("model",)), args=(pg, config_for_graph(pg, **ckw)), kw=dkw,
            scores=scores, lengths=lengths)
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


@pytest.mark.parametrize("case,P", SHARD_RUNS, ids=[f"{c}_p{P}" for c, P in SHARD_RUNS])
def test_sharded_eps_iters_0_matches_jax(shard_results, case, P):
    """Every field of the port's sharded decode at eps_iters 0 equals the
    JAX sharded decode's on a mesh of P devices, on every rank, floats by
    their bits; so do the 1-best labels and, for the lattice, the pruned
    links.  The eps outputs have no iteration."""
    g, kind, ckw, dkw, scores, lengths = _shard_case(case)
    jfc, pfc = twin_configs(g, graph_from_numpy(g), **ckw)
    assert jfc.eps_iters == pfc.eps_iters == 0
    cls = jgs.ShardedViterbiDecoder if kind == "viterbi" else jgs.ShardedLatticeDecoder
    want = cls(g, jfc, mesh=jax_mesh((P,), ("model",)), **dkw).decode(scores, lengths)
    fields = VITERBI_FIELDS if kind == "viterbi" else LATTICE_FIELDS
    ranks = shard_results[P]
    for r, got in enumerate(r[case] for r in ranks):
        for f in fields:
            same_array(getattr(want, f), getattr(got, f), f"rank {r}: {f}")
    got = ranks[0][case]
    assert (got.bp_eps if kind == "viterbi" else got.eps_records).size == 0
    jax_host_library()
    for b in range(scores.shape[0]):
        lw, lg = want.best_path(b), got.best_path(b)
        assert (lw is None) == (lg is None)
        if lw is not None:
            assert path_labels(lg) == [int(x) for x in jax_path_labels(lw)], f"utt {b}"
        if kind == "lattice":
            pw, pp = want._prune(b), got._prune(b)
            assert (pw is None) == (pp is None)
            if pw is not None:
                assert links(pw) == links(pp), f"utt {b}"


# ---------------------------------------------------------------------------
# The batched decoders on H
# ---------------------------------------------------------------------------

BATCHED_CASES = {
    # name: (config kwargs, decode kwargs of the lattice decoder)
    "min_active": (dict(beam=6.0, min_active=12, frontier_size=32), dict(chunk_frames=8)),
    "max_active": (dict(beam=14.0, max_active=7, min_active=2, frontier_size=32),
                   dict(chunk_frames=None, device_prune=False)),
}


def _h_batch():
    rng = np.random.default_rng(33)
    V, T, B = 20, 30, 3
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return jax_compile(ctc_topo(V)), scores, np.array([30, 17, 24], np.int32)


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_viterbi_on_h_matches_jax(case):
    """``BatchedViterbiDecoder`` on ``ctc_topo(20)``: the config (eps_iters
    0), every result field, the flags and the best paths equal JAX's."""
    cg, scores, lengths = _h_batch()
    pg = graph_from_numpy(cg)
    jfc, pfc = twin_configs(cg, pg, **BATCHED_CASES[case][0])
    assert_same_config(jfc, pfc)
    jr = JaxViterbi(cg, jfc, pad_time_to=8).decode(scores, lengths)
    pr = BatchedViterbiDecoder(pg, pfc, pad_time_to=8, device="cpu").decode(scores, lengths)
    for f in ("bp_init", "bp_emit", "bp_eps", "frontier_states", "frontier_costs",
              "num_active", "best_costs", "cutoffs", "overflows", "saturations", "lengths"):
        same_array(getattr(jr, f), getattr(pr, f), f)
    assert not pr.overflows.any()
    jax_host_library()
    for b in range(scores.shape[0]):
        same_fst(jr.best_path(b), pr.best_path(b))


@pytest.mark.parametrize("case", sorted(BATCHED_CASES))
def test_batched_lattice_on_h_matches_jax(case):
    """``BatchedLatticeDecoder`` on ``ctc_topo(20)``, swept in chunks on
    the device or whole: the per-frame stats and records, raw lattices,
    best paths and labels equal JAX's."""
    cg, scores, lengths = _h_batch()
    pg = graph_from_numpy(cg)
    ckw, dkw = BATCHED_CASES[case]
    jfc, pfc = twin_configs(cg, pg, **ckw)
    kw = dict(lattice_beam=5.0, em_records=256, pad_time_to=8)
    jr = JaxLattice(cg, jfc, **kw).decode(scores, lengths, **dkw)
    pr = BatchedLatticeDecoder(pg, pfc, device="cpu", **kw).decode(scores, lengths, **dkw)
    for f in ("num_active", "cutoffs", "overflows", "saturations"):
        same_array(getattr(jr, f), getattr(pr, f), f)
    assert (jr.survivors is None) == (pr.survivors is None)
    if pr.survivors is None:
        for f in ("frame_states", "frame_costs", "em_records", "eps_records"):
            same_array(getattr(jr, f), getattr(pr, f), f)
    jax_host_library()
    for b in range(scores.shape[0]):
        same_fst(jr.raw_lattice(b), pr.raw_lattice(b))
        same_fst(jr.best_path(b), pr.best_path(b))
        assert jr.best_path_labels(b) == pr.best_path_labels(b), b


# ---------------------------------------------------------------------------
# The teardown: close(), the with block, no teardown call
# ---------------------------------------------------------------------------

TEARDOWN = r"""
import atexit, os, sys
sys.modules["jax"] = None
sys.path.insert(0, {repo!r})
import numpy as np, torch
from kaldi_decoder_tpu_torch.fst import compile_fst, ctc_topo
from kaldi_decoder_tpu_torch.parallel import (ShardedLatticeDecoder, ShardedViterbiDecoder,
                                              initialize_distributed, make_mesh, shard_driver)
torch.set_num_threads(1)

def at_exit():
    print("left at exit:", len(shard_driver._drivers), flush=True)

atexit.register(at_exit)
initialize_distributed(device_type="cpu", init_method="file://{store}", rank=0, world_size=1)
mesh = make_mesh(1, "model", device_type="cpu")
g = compile_fst(ctc_topo(5))
rng = np.random.default_rng(0)
scores = np.log(rng.dirichlet(np.ones(5), size=(2, 9))).astype(np.float32)
v = ShardedViterbiDecoder(g, mesh=mesh, pad_time_to=8, device="cpu")
with ShardedLatticeDecoder(g, lattice_beam=4.0, mesh=mesh, pad_time_to=8,
                           device="cpu") as lat:
    v.decode(scores)
    lat.decode(scores)
    print("kept:", len(shard_driver._drivers), flush=True)
print("after the with block:", len(shard_driver._drivers), flush=True)
v.decode(scores)
{ending}
"""


def _teardown_run(ending, tmp_path):
    code = TEARDOWN.format(repo=REPO, store=str(tmp_path / "store"), ending=ending)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_close_releases_the_decoders_drivers(tmp_path):
    """A sharded decoder's ``with`` block and ``close()`` drop its own kept
    frame drivers (the other decoder's stay); then a plain
    ``destroy_process_group`` ends the process."""
    out = _teardown_run('print("before close:", len(shard_driver._drivers))\n'
                        'v.close()\n'
                        'print("after close:", len(shard_driver._drivers))\n'
                        'torch.distributed.destroy_process_group()', tmp_path)
    assert out == ["kept: 2", "after the with block: 1", "before close: 1", "after close: 0",
                   "left at exit: 0"]


def test_process_without_teardown_exits(tmp_path):
    """A process that ends without a teardown call exits with rc 0: the
    kept drivers it leaves go with the interpreter, and no hook of the
    package runs first."""
    out = _teardown_run('print("returning with", len(shard_driver._drivers))', tmp_path)
    assert out == ["kept: 2", "after the with block: 1", "returning with 1", "left at exit: 1"]


# ---------------------------------------------------------------------------
# Phase 14's reference
# ---------------------------------------------------------------------------


def test_h_reference_matches_its_script():
    """``tests/data/torch_port_h_ref.json`` (the reference of
    ``chip_smoke.py`` phase 14) was made by
    ``scripts/make_torch_h_reference.py`` at the smoke's config and cut, on
    every utterance, with no overflow or saturation; its configs are the
    ones the port derives on H for the batched decoders and each part."""
    import json

    import chip_smoke as cs
    from kaldi_decoder_tpu_torch.parallel import graph_shard as pgs

    with open(os.path.join(REPO, "tests", "data", "torch_port_h_ref.json")) as f:
        ref = json.load(f)
    assert ref["requested"] == {
        "batched": dict(cs.H_CONFIG, **cs.H_LATTICE_KW),
        "shard": dict(cs.H_SHARD_CONFIG, **cs.H_LATTICE_KW, route_cap=cs.H_ROUTE_CAP)}
    w = ref["workload"]
    assert (w["V"], w["utterances"], w["shard_frames"], w["frames"]) == (
        cs.V, cs.B, cs.H_SHARD_FRAMES, None)
    hg = cs.h_graph()
    assert (hg.num_states, hg.num_emitting_arcs, hg.num_eps_arcs) == (500, 250000, 0)
    fc = config_for_graph(hg, **cs.H_CONFIG)
    fields = ref["batched"]["viterbi_config"]
    assert {k: getattr(fc, k) for k in fields} == fields
    assert fc.eps_iters == 0 and fc.frontier_size == 512
    lat = ref["batched"]["lattice_config"]
    assert lat == dict(fields, eps_records=lat["eps_records"], **cs.H_LATTICE_KW)
    sfc = config_for_graph(hg, **cs.H_SHARD_CONFIG)
    for P, part in ref["parts"].items():
        own = pgs.local_part(hg, int(P), 0, sfc.block_width, sfc.eps_block_width,
                             sfc.flat_group, "cpu")
        lc = pgs.shard_lattice_config_for(own, sfc, route_cap=cs.H_ROUTE_CAP, **cs.H_LATTICE_KW)
        sc = lc.shard
        got = {k: getattr(sc.frontier, k) for k in fields}
        got.update(num_parts=sc.num_parts, part_size=sc.part_size, route_cap=sc.route_cap,
                   eps_route_cap=sc.eps_route_cap, em_records=lc.em_records,
                   eps_records=lc.eps_records, lattice_beam=lc.lattice_beam)
        assert got == part["shard_config"], P
        assert part["viterbi_route_cap"] == cs.H_ROUTE_CAP
    runs = [ref["batched"][k] for k in ("viterbi", "lattice")] + [
        part[k] for part in ref["parts"].values() for k in ("viterbi", "lattice")]
    for utts in runs:
        assert len(utts) == cs.B
        assert all(u["overflow_frames"] == u["saturated_frames"] == 0 for u in utts)


def test_h_lattice8_reference_matches_its_script():
    """The ``lattice8`` section of the same file: both lattice decoders at
    ``H8_LATTICE_KW`` (lattice beam 8, em_records 2^18) on the first
    ``H8_FRAMES`` frames, route buckets of ``H8_ROUTE_CAP``, made at the
    configs the port derives, with no overflow or saturation and, in the
    busiest utterance, more than 2^16 lattice arcs a frame."""
    import json

    import chip_smoke as cs
    from kaldi_decoder_tpu_torch.parallel import graph_shard as pgs

    with open(os.path.join(REPO, "tests", "data", "torch_port_h_ref.json")) as f:
        l8 = json.load(f)["lattice8"]
    assert l8["frames"] == cs.H8_FRAMES
    assert l8["requested"] == {
        "batched": dict(cs.H_CONFIG, **cs.H8_LATTICE_KW),
        "shard": dict(cs.H_SHARD_CONFIG, **cs.H8_LATTICE_KW, route_cap=cs.H8_ROUTE_CAP)}
    assert cs.H8_LATTICE_KW == dict(lattice_beam=8.0, em_records=1 << 18)
    hg = cs.h_graph()
    fc = config_for_graph(hg, **cs.H_CONFIG)
    lat = l8["batched"]["lattice_config"]
    assert {k: getattr(fc, k) for k in lat if hasattr(fc, k)} == {
        k: v for k, v in lat.items() if hasattr(fc, k)}
    assert (lat["em_records"], lat["lattice_beam"]) == (1 << 18, 8.0)
    sfc = config_for_graph(hg, **cs.H_SHARD_CONFIG)
    for P, part in l8["parts"].items():
        own = pgs.local_part(hg, int(P), 0, sfc.block_width, sfc.eps_block_width,
                             sfc.flat_group, "cpu")
        lc = pgs.shard_lattice_config_for(own, sfc, route_cap=cs.H8_ROUTE_CAP,
                                          **cs.H8_LATTICE_KW)
        sc = lc.shard
        got = {k: getattr(sc.frontier, k) for k in lat if hasattr(sc.frontier, k)}
        got.update(num_parts=sc.num_parts, part_size=sc.part_size, route_cap=sc.route_cap,
                   eps_route_cap=sc.eps_route_cap, em_records=lc.em_records,
                   eps_records=lc.eps_records, lattice_beam=lc.lattice_beam)
        assert got == part["shard_config"], P
    for utts in [l8["batched"]["lattice"]] + [p["lattice"] for p in l8["parts"].values()]:
        assert len(utts) == cs.B
        assert all(u["overflow_frames"] == u["saturated_frames"] == 0 for u in utts)
        assert max(u["lattice_arcs"] / u["length"] for u in utts) > 1 << 16
