"""Twins of ``tests/test_profiling.py`` for the port: the decodes' wall
time and throughput stats, ``trace`` (a Chrome trace holding the decode's
named range) and ``annotate``, each beside the JAX package's on the same
graph and scores."""

import json

import numpy as np
import pytest

from kaldi_decoder_tpu.decoders.frontier import config_for_graph as jax_config_for_graph
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxLattice
from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.fst.synthetic import synthetic_graph as jax_synthetic_graph
from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, BatchedViterbiDecoder, config_for_graph
from kaldi_decoder_tpu_torch.fst.synthetic import synthetic_graph
from kaldi_decoder_tpu_torch.utils import profiling
from kaldi_decoder_tpu_torch.utils.logging import DecodeStats


@pytest.fixture(scope="module")
def graphs():
    return (jax_synthetic_graph(60, 240, 12, seed=3, eps_arcs=20),
            synthetic_graph(60, 240, 12, seed=3, eps_arcs=20))


def _scores(B, T, V, seed=0):
    rng = np.random.default_rng(seed)
    return np.log(rng.dirichlet(np.ones(V), size=(B, T)).astype(np.float32))


def test_viterbi_stats_report_throughput(graphs):
    jg, pg = graphs
    scores = _scores(3, 17, 12)
    js = JaxViterbi(jg, jax_config_for_graph(jg, beam=12.0)).decode(scores).stats(1)
    st = BatchedViterbiDecoder(pg, config_for_graph(pg, beam=12.0), device="cpu").decode(
        scores).stats(1)
    assert st.wall_seconds > 0.0
    assert (st.batch_frames, st.num_frames) == (js.batch_frames, js.num_frames) == (3 * 17, 17)
    assert st.frames_per_second > 0.0
    assert st.audio_seconds_per_second(0.04) == pytest.approx(st.frames_per_second * 0.04)
    assert "frames/s=" in st.summary()


def test_lattice_stats_report_throughput(graphs):
    jg, pg = graphs
    scores = _scores(2, 11, 12)
    js = JaxLattice(jg, jax_config_for_graph(jg, beam=12.0)).decode(scores).stats()
    st = BatchedLatticeDecoder(pg, config_for_graph(pg, beam=12.0), device="cpu").decode(
        scores).stats()
    assert st.wall_seconds > 0.0
    assert (st.batch_frames, st.num_frames) == (js.batch_frames, js.num_frames) == (2 * 11, 11)
    assert st.frames_per_second > 0.0


def test_unmeasured_stats_report_zero():
    st = DecodeStats(num_frames=10)
    assert st.frames_per_second == 0.0
    assert st.audio_seconds_per_second(0.04) == 0.0


def test_trace_context_runs(tmp_path, graphs):
    """trace() wraps a decode without changing it and writes a Chrome
    trace that holds the decode's named range."""
    _, pg = graphs
    dec = BatchedViterbiDecoder(pg, config_for_graph(pg, beam=12.0), device="cpu")
    scores = _scores(1, 5, 12)
    want = dec.decode(scores).best_path(0)
    with profiling.trace(str(tmp_path)):
        res = dec.decode(scores)
    got = res.best_path(0)
    assert got is not None and got == want
    with open(tmp_path / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "kdtpu.viterbi_decode[0]" in names


def test_annotate_is_context_manager():
    with profiling.annotate("kdtpu.test", step=3):
        pass
    with profiling.annotate("kdtpu.test", step=4, device="cpu"):
        pass
    with profiling.WallTimer() as timer:
        pass
    assert timer.elapsed >= 0.0
