"""The port's data-parallel decode and mesh helpers against the JAX package's.

Twins of ``tests/test_parallel.py`` and ``tests/test_multihost.py``: the
JAX decoders run with a 2-device ``data`` mesh of the suite's virtual CPU
devices; the port's run in 2 spawned processes that meet over gloo
(``tests/_torch_dist_worker.py``), each decoding its half of the padded
batch and gathering the rest.  Inputs are made with numpy from fixed
seeds and handed to both.

Exactness: every row is decoded as the unsharded decoder decodes it, so
each field of the Viterbi result equals JAX's (floats by their raw bits),
on every rank, padded rows included; the lattice results (swept survivor
rows, whose download caps differ between the packages) are compared per
utterance on their per-frame statistics, 1-best labels and pruned links,
and each rank's equals the port's decode without a mesh.
"""

import os
import tempfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kaldi_decoder_tpu.decoders import BatchedLatticeDecoder as JaxLattice
from kaldi_decoder_tpu.decoders import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.decoders import config_for_graph as jax_config
from kaldi_decoder_tpu.fst import compile_fst as jax_compile
from kaldi_decoder_tpu.fst import ctc_topo, random_fst
from kaldi_decoder_tpu.fst.ops import path_labels as jax_path_labels
from kaldi_decoder_tpu.parallel import make_mesh as jax_make_mesh
from kaldi_decoder_tpu.parallel import pad_batch as jax_pad_batch
from kaldi_decoder_tpu_torch import parallel
from kaldi_decoder_tpu_torch.decoders import (
    BatchedLatticeDecoder,
    BatchedViterbiDecoder,
    config_for_graph,
)
from kaldi_decoder_tpu_torch.fst.csr import graph_from_numpy
from kaldi_decoder_tpu_torch.fst.ops import path_labels
from kaldi_decoder_tpu_torch.parallel import mesh as pmesh

from _torch_dist_worker import run_ranks
from _torch_util import jax_host_library
from test_torch_graph_shard import VITERBI_FIELDS, links, same_array

WORLD = 2


def rand_logp(rng, T, V):
    return np.log(rng.dirichlet(np.ones(V), size=T)).astype(np.float32)


def _viterbi_b8():
    rng = np.random.default_rng(0)
    V, T, B = 6, 12, 8
    g = jax_compile(ctc_topo(V))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=16.0, min_active=0), dict(pad_time_to=8), scores, \
        np.array([12, 10, 8, 12, 5, 12, 3, 12], np.int32)


def _viterbi_b3():
    rng = np.random.default_rng(1)
    V, T, B = 5, 10, 3
    g = jax_compile(ctc_topo(V))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "viterbi", dict(beam=16.0, min_active=0), dict(pad_time_to=8), scores, None


def _multihost():
    """``tests/_multihost_worker.py``'s batch."""
    V, T, B = 5, 8, 4
    g = jax_compile(ctc_topo(V))
    rng = np.random.default_rng(0)
    scores = np.log(rng.dirichlet(np.ones(V), size=(B, T))).astype(np.float32)
    return g, "viterbi", dict(beam=16.0, min_active=0), dict(pad_time_to=8), scores, None


def _lattice(B):
    rng = np.random.default_rng(2)
    V, T = 4, 8
    g = jax_compile(random_fst(12, V, rng))
    scores = np.stack([rand_logp(rng, T, V) for _ in range(B)])
    return g, "lattice", dict(beam=1000.0, min_active=0, frontier_size=16), \
        dict(lattice_beam=4.0, pad_time_to=8), scores, None


CASES = {
    "viterbi_b8": _viterbi_b8,
    "viterbi_b3": _viterbi_b3,
    "multihost": _multihost,
    "lattice_b8": lambda: _lattice(8),
    "lattice_b3": lambda: _lattice(3),
}


@pytest.fixture(scope="module")
def port_results():
    cases = {}
    for name, make in CASES.items():
        g, kind, ckw, dkw, scores, lengths = make()
        pg = graph_from_numpy(g)
        cases[name] = dict(
            decoder="BatchedViterbiDecoder" if kind == "viterbi" else "BatchedLatticeDecoder",
            mesh=((WORLD,), ("data",)), args=(pg, config_for_graph(pg, **ckw)), kw=dkw,
            scores=scores, lengths=lengths)
    with tempfile.TemporaryDirectory() as tmp:
        return run_ranks(dict(world=WORLD, cases=cases), tmp)


def _decoders(name):
    """(kind, JAX meshed decoder, the port's decoder without a mesh, scores, lengths)."""
    g, kind, ckw, dkw, scores, lengths = CASES[name]()
    pg = graph_from_numpy(g)
    jcls, pcls = (JaxViterbi, BatchedViterbiDecoder) if kind == "viterbi" else \
        (JaxLattice, BatchedLatticeDecoder)
    jdec = jcls(g, jax_config(g, **ckw), mesh=jax_make_mesh(WORLD), **dkw)
    pdec = pcls(pg, config_for_graph(pg, **ckw), device="cpu", **dkw)
    return kind, jdec, pdec, scores, lengths


@pytest.mark.parametrize("name", ["viterbi_b8", "viterbi_b3", "multihost"])
def test_data_parallel_viterbi_matches_jax(port_results, name):
    """Every field equals the JAX meshed decode's on every rank (B = 3 and
    4 are padded to the mesh as JAX pads them), and each utterance's 1-best
    equals the port's decode without a mesh."""
    kind, jdec, pdec, scores, lengths = _decoders(name)
    want = jdec.decode(scores, lengths)
    plain = pdec.decode(scores, lengths)
    for r in range(WORLD):
        got = port_results[r][name]
        for f in VITERBI_FIELDS:
            same_array(getattr(want, f), getattr(got, f), f"rank {r}: {f}")
        for b in range(scores.shape[0]):
            lw, lg, lp = want.best_path(b), got.best_path(b), plain.best_path(b)
            assert (lw is None) == (lg is None) == (lp is None)
            if lw is not None:
                labels = [int(x) for x in jax_path_labels(lw)]
                assert path_labels(lg) == labels == path_labels(lp), f"rank {r}, utt {b}"


@pytest.mark.parametrize("name", ["lattice_b8", "lattice_b3"])
def test_data_parallel_lattice_matches_jax(port_results, name):
    """Per utterance, on every rank: the per-frame statistics, the 1-best
    labels and the pruned lattice's links equal the JAX meshed decode's
    and the port's decode without a mesh."""
    jax_host_library()  # the JAX best_path_labels' C++ route
    kind, jdec, pdec, scores, lengths = _decoders(name)
    want = jdec.decode(scores, lengths)
    plain = pdec.decode(scores, lengths)
    B = scores.shape[0]
    for r in range(WORLD):
        got = port_results[r][name]
        assert got.survivors is not None
        for f in ("num_active", "cutoffs", "overflows", "saturations"):
            same_array(getattr(want, f)[:, :B], getattr(got, f)[:, :B], f"rank {r}: {f}")
        for b in range(B):
            assert got.best_path_labels(b) == want.best_path_labels(b) \
                == plain.best_path_labels(b), f"rank {r}, utt {b}"
            pw, pg_, pp = want._prune(b), got._prune(b), plain._prune(b)
            assert (pw is None) == (pg_ is None) == (pp is None)
            if pw is not None:
                assert links(pw) == links(pg_) == links(pp), f"rank {r}, utt {b}"


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(3)
    scores = rng.standard_normal((3, 5, 4)).astype(np.float32)
    lengths = np.array([5, 2, 4], np.int32)
    for multiple in (1, 2, 4, 8):
        want, got = jax_pad_batch(scores, lengths, multiple), parallel.pad_batch(
            scores, lengths, multiple)
        assert want[2] == got[2]
        same_array(want[0], got[0], "scores")
        same_array(want[1], got[1], "lengths")


@pytest.fixture
def one_rank_group(tmp_path):
    """A gloo default group of one rank for the life of a test."""
    parallel.initialize_distributed(device_type="cpu", init_method=f"file://{tmp_path}/store",
                                    rank=0, world_size=1)
    yield
    parallel.shutdown_distributed()


def test_mesh_helpers(one_rank_group):
    """``make_mesh`` builds named 1-D and 2-D meshes over the default
    group, ``batch_sharding``/``replicated`` say which rows a rank holds,
    ``initialize_distributed`` is a no-op on an existing group, and the
    collective helpers count their calls."""
    parallel.initialize_distributed(device_type="cpu", init_method="file:///nonexistent",
                                    rank=0, world_size=1)
    assert dist.get_backend() == pmesh.BACKENDS["cpu"] == "gloo"
    assert pmesh.BACKENDS["cuda"] == "nccl"
    m1 = parallel.make_mesh(device_type="cpu")
    assert m1.mesh_dim_names == ("data",) and m1.size() == 1
    m2 = parallel.make_mesh((1, 1), ("data", "model"), device_type="cpu")
    assert m2.mesh_dim_names == ("data", "model")
    sh = parallel.batch_sharding(m2, "data")
    assert (sh.part, sh.parts, sh.rows(6)) == (0, 1, slice(0, 6))
    rep = parallel.replicated(m2)
    assert (rep.axis, rep.group, rep.rows(5)) == (None, None, slice(0, 5))
    with pytest.raises(ValueError, match="no dimension"):
        parallel.batch_sharding(m1, "model")
    with pytest.raises(ValueError, match="axis names"):
        parallel.make_mesh((1, 1), "data", device_type="cpu")
    with pytest.raises(ValueError, match="mesh's type"):
        pmesh.check_device(m1, "cuda")
    g = m2.get_group("model")
    pmesh.collective_calls.clear()
    x = torch.tensor([3.0, -0.0])
    assert pmesh.all_reduce(x, "min", g).tolist() == [3.0, -0.0]
    assert pmesh.all_gather_into(x[None], None, g).tolist() == [[[3.0, -0.0]]]
    assert pmesh.all_to_all(x[None], g).tolist() == [[3.0, -0.0]]
    assert pmesh.all_gather_object({"a": 1}, g) == [{"a": 1}]
    assert not pmesh.staged(x, g)
    assert dict(pmesh.collective_calls) == dict(
        all_reduce_min=1, all_gather=1, all_to_all=1, all_gather_object=1)


def test_split_rows():
    """A batch splits into equal parts over the ``data`` dimension;
    ``concat_parts`` joins ragged survivor rows padded with -1."""
    sh = pmesh.Sharding(mesh=None, axis="data", part=1, parts=2)
    assert sh.rows(4) == slice(2, 4)
    with pytest.raises(ValueError, match="does not split"):
        sh.rows(3)
    a = np.arange(6, dtype=np.int32).reshape(1, 3, 2)
    b = np.arange(2, dtype=np.int32).reshape(1, 1, 2)
    got = pmesh.concat_parts([a, b], axis=0)
    assert got.shape == (2, 3, 2)
    assert np.array_equal(got[1], [[0, 1], [-1, -1], [-1, -1]])


@pytest.mark.parametrize("part, multiple", [(0, None), (1, None), (1, 4)])
def test_local_batch(part, multiple):
    """A rank's rows, time-major: the batch padded by ``pad_batch`` to the
    multiple (the sharding's parts by default), cut to the rank's slice,
    and padded with zeros to the frames asked for; every row without a
    sharding."""
    rng = np.random.default_rng(5)
    scores = rng.standard_normal((3, 5, 4)).astype(np.float32)
    lengths = np.array([5, 2, 4], np.int32)
    sh = pmesh.Sharding(mesh=None, axis="data", part=part, parts=2)
    got_s, got_l = pmesh.local_batch(scores, lengths, 8, sh, multiple)
    ps, pl, _ = jax_pad_batch(scores, lengths, multiple or 2)
    rows = sh.rows(ps.shape[0])
    want_s = np.zeros((8, rows.stop - rows.start, 4), np.float32)
    want_s[:5] = ps[rows].transpose(1, 0, 2)
    same_array(want_s, got_s, "scores")
    same_array(pl[rows], got_l, "lengths")
    assert got_s.flags.c_contiguous and got_l.dtype == np.int32
    all_s, all_l = pmesh.local_batch(scores, lengths, 8, None)
    assert all_s.shape == (8, 3, 4) and np.array_equal(all_s[:5], scores.transpose(1, 0, 2))
    same_array(lengths, all_l, "lengths")


def test_decoders_take_a_mesh_argument():
    """Both batched decoders take ``mesh`` and ``data_axis`` where the JAX
    ones do, in the same positions."""
    import inspect

    for jcls, pcls in ((JaxViterbi, BatchedViterbiDecoder), (JaxLattice, BatchedLatticeDecoder)):
        jp = [p for p in inspect.signature(jcls).parameters]
        pp = [p for p in inspect.signature(pcls).parameters if p != "device"]
        assert jp == pp, (jp, pp)
    assert os.path.exists(os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py"))
