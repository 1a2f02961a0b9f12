"""K3, the frame tail, and the frame driver against the JAX package, on the CPU.

``kernels.frame.frame_tail_plain`` (with the frame bodies around it, the
port's ``lattice_frame_body`` and ``frame_step_batched``) against
the JAX frame steps, frame by frame, raw bits; the next frame's GetCutoff
it gives against the JAX ``get_cutoff`` of the new frontier; then the
driver's static-buffer frame (``lattice_chunk`` and ``viterbi_chunk``, run
eagerly here with the plain versions) against the JAX chunk functions
(``build_lattice_chunk_fn`` and ``build_chunk_fn``, jitted on the CPU)
over whole chunks, twice on the same driver with other inputs.  The
inputs cover rows that end mid-chunk, an all-+inf row, and frames where
GetCutoff takes its max_active and its min_active branches, on the small
HLG folded (no eps closure on the device) and unfolded (eps depth 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.decoders import frontier as jfrontier
from kaldi_decoder_tpu.decoders import lattice_dev as jlattice_dev
from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxLattice
from kaldi_decoder_tpu.decoders.viterbi import BatchedViterbiDecoder as JaxViterbi
from kaldi_decoder_tpu.ops.cutoff import get_cutoff as jax_get_cutoff
from kaldi_decoder_tpu_torch import BatchedLatticeDecoder, BatchedViterbiDecoder
from kaldi_decoder_tpu_torch.decoders import driver
from kaldi_decoder_tpu_torch.decoders.frontier import StepState, frame_step_batched
from kaldi_decoder_tpu_torch.decoders.lattice_dev import lattice_chunk, lattice_frame_body
from kaldi_decoder_tpu_torch.decoders.viterbi import viterbi_chunk
from kaldi_decoder_tpu_torch.fst.fold import fold_eps
from kaldi_decoder_tpu_torch.kernels.frame import frame_start, frame_tail, frame_tail_plain
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff

from _torch_util import hlg_batch, small_hlg, twin_configs

B = 4
# name: frontier kwargs.  "max_active": a narrow max_active under a wide
# beam, so GetCutoff's max_active branch binds; "min_active": a narrow
# beam over a wide min_active, so its min_active branch loosens the cutoff.
CONFIGS = {
    "max_active": dict(frontier_size=64, max_active=10, min_active=2, beam=40.0),
    "min_active": dict(frontier_size=64, max_active=48, min_active=30, beam=0.5),
}
CASES = [(c, fold) for c in sorted(CONFIGS) for fold in (True, False)]


def _raw(x):
    """An array's raw bits (float32 as int32), as numpy."""
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eq(ref, got, what):
    r, g = _raw(ref), _raw(got)
    assert r.shape == g.shape, (what, r.shape, g.shape)
    assert np.array_equal(r, g), what


def _inputs(seed, lengths_of=None):
    """Scores (B, T, V) and lengths, rows ending at different frames, from
    the small HLG's utterances."""
    scores, lengths, _ = hlg_batch(B, seed=seed)
    if lengths_of is not None:
        lengths = np.minimum(lengths, lengths_of)
    return scores, lengths.astype(np.int32)


def _start(st, dead_row):
    """The decoder's start frontier with row ``dead_row`` all +inf (no live
    token), as numpy (states, costs, base)."""
    states, costs, base = (x.numpy().copy() for x in st)
    costs[dead_row] = np.inf
    return states, costs, base


def _lattice_twins(config, fold):
    _, jg, pg = small_hlg()
    jdev = JaxLattice(jg, None, pad_time_to=8, fold=fold)._dev_graph
    pdev = fold_eps(pg).device if fold else pg
    jfc, pfc = twin_configs(jdev, pdev, **CONFIGS[config])
    kw = dict(lattice_beam=5.0, pad_time_to=8, em_records=256, fold=fold)
    jdec = JaxLattice(jg, jfc, **kw)
    pdec = BatchedLatticeDecoder(pg, pfc, device="cpu", **kw)
    assert jdec.cfg.frontier.eps_iters == pdec.cfg.frontier.eps_iters == (0 if fold else 1)
    return jdec, pdec


def _viterbi_twins(config, fold):
    _, jg, pg = small_hlg()
    jdev = JaxViterbi(jg, None, pad_time_to=8, fold=fold)._dev_graph
    pdev = fold_eps(pg).device if fold else pg
    jfc, pfc = twin_configs(jdev, pdev, **CONFIGS[config])
    jdec = JaxViterbi(jg, jfc, pad_time_to=8, fold=fold)
    pdec = BatchedViterbiDecoder(pg, pfc, pad_time_to=8, fold=fold, device="cpu")
    assert jdec.cfg.eps_iters == pdec.cfg.eps_iters == (0 if fold else 1)
    return jdec, pdec


def _jax_state(states, costs, base):
    return jfrontier.StepState(jnp.asarray(states), jnp.asarray(costs), jnp.asarray(base))


def _port_state(states, costs, base):
    return StepState(torch.from_numpy(states), torch.from_numpy(costs), torch.from_numpy(base))


def _branches(fc, costs):
    """Which GetCutoff branch each row of a (B, K) relative frontier takes:
    counts of (max_active, min_active) rows."""
    c = torch.from_numpy(np.asarray(costs))
    cut = get_cutoff(c, fc.beam, fc.max_active, fc.min_active, fc.beam_delta, costs_sorted=True)
    beam_cut = c[:, 0] + fc.beam
    return int((cut.cutoff < beam_cut).sum()), int((cut.cutoff > beam_cut).sum())


@pytest.mark.parametrize("config,fold", CASES)
def test_lattice_frame_tail_matches_jax(config, fold):
    """The lattice frame (body + ``frame_tail_plain``) against the JAX
    frame step, frame by frame: the new state, every output and the next
    frame's GetCutoff, raw bits; frozen rows and an all-+inf row among
    them, and GetCutoff's branch for this config taken."""
    jdec, pdec = _lattice_twins(config, fold)
    fc, S = pdec.cfg.frontier, pdec._dev_graph.num_states
    scores, lengths = _inputs(seed=5)
    st0 = _start(pdec._init(B)[0], dead_row=2)
    jst, pst = _jax_state(*st0), _port_state(*st0)
    step = jax.jit(lambda s, sc, fa: jlattice_dev.lattice_frame_step_batched(
        s, sc, fa, jdec._pg_dev, jdec.cfg, S))
    cut_of = jax.vmap(lambda c: jax_get_cutoff(c, fc.beam, fc.max_active, fc.min_active,
                                               fc.beam_delta, costs_sorted=True))
    taken = [0, 0]
    T = int(lengths.max())
    for t in range(T):
        fa = lengths > t
        jst, jout = step(jst, jnp.asarray(scores[:, t]), jnp.asarray(fa))
        cut = get_cutoff(pst.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                         costs_sorted=True)
        tin = lattice_frame_body(pst, cut.cutoff, cut.adaptive_beam,
                                 torch.from_numpy(scores[:, t]), torch.from_numpy(fa),
                                 pdec._pg, pdec.cfg, S)
        pst, pout, nxt = frame_tail_plain(pst, cut.cutoff, tin, torch.from_numpy(fa), fc)
        for f in ("states", "costs", "base"):
            _eq(getattr(jst, f), getattr(pst, f), (t, f))
        for f in pout._fields:
            _eq(getattr(jout, f), getattr(pout, f), (t, f))
        jcut = cut_of(jst.costs)
        _eq(jcut.cutoff, nxt.cutoff, (t, "next cutoff"))
        _eq(jcut.adaptive_beam, nxt.adaptive_beam, (t, "next adaptive_beam"))
        assert not bool(np.isfinite(pst.costs[2].numpy()).any())  # the +inf row stays empty
        m, n = _branches(fc, pst.costs.numpy())
        taken[0] += m
        taken[1] += n
    assert (~(lengths[:, None] > np.arange(T))).any()  # some rows froze
    assert taken[0 if config == "max_active" else 1] > 0, taken


@pytest.mark.parametrize("config,fold", CASES)
def test_viterbi_frame_tail_matches_jax(config, fold):
    """The Viterbi frame (body + ``frame_tail_plain``, the backpointer
    gather included) against the JAX frame step, frame by frame."""
    jdec, pdec = _viterbi_twins(config, fold)
    cfg, S = pdec.cfg, pdec._dev_graph.num_states
    scores, lengths = _inputs(seed=6)
    st0 = _start(pdec._init(B)[0], dead_row=1)
    jst, pst = _jax_state(*st0), _port_state(*st0)
    step = jax.jit(lambda s, sc, fa: jfrontier.frame_step_batched(
        s, sc, fa, jdec._pg_dev, jdec.cfg, S))
    for t in range(int(lengths.max())):
        fa = lengths > t
        jst, jout = step(jst, jnp.asarray(scores[:, t]), jnp.asarray(fa))
        pst, pout = frame_step_batched(pst, torch.from_numpy(scores[:, t]),
                                       torch.from_numpy(fa), pdec._pg, cfg, S)
        for f in ("states", "costs", "base"):
            _eq(getattr(jst, f), getattr(pst, f), (t, f))
        for f in pout._fields:
            _eq(getattr(jout, f), getattr(pout, f), (t, f))


def _lattice_chunk_twins(jdec, pdec, scores, lengths, st0):
    S = pdec._dev_graph.num_states
    jst, jout = jdec._chunk_fn(jdec._pg_dev, jnp.asarray(scores), jnp.asarray(lengths),
                               _jax_state(*st0))
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2)))
    pst, pout = lattice_chunk(pdec._pg, scores_tm, torch.from_numpy(lengths),
                              _port_state(*st0), pdec.cfg, S)
    for f in ("states", "costs", "base"):
        _eq(getattr(jst, f), getattr(pst, f), f)
    for f in pout._fields:
        _eq(getattr(jout, f), getattr(pout, f), f)
    return pst


@pytest.mark.parametrize("config,fold", CASES)
def test_lattice_chunk_driver_matches_jax(config, fold):
    """``lattice_chunk`` through the frame driver's static buffers against the
    JAX ``build_lattice_chunk_fn``: two chunks of other lengths, scores and
    start states on one driver (stale state would show in the second),
    then a chunk that starts from the first one's final state."""
    jdec, pdec = _lattice_twins(config, fold)
    S = pdec._dev_graph.num_states
    scores, lengths = _inputs(seed=7)
    C = scores.shape[1]
    st0 = _start(pdec._init(B)[0], dead_row=3)
    fin = _lattice_chunk_twins(jdec, pdec, scores, lengths, st0)
    drv = driver.driver_for(True, pdec._pg, pdec.cfg, S, B, scores.shape[2], "cpu")
    scores2, lengths2 = _inputs(seed=8, lengths_of=C)
    _lattice_chunk_twins(jdec, pdec, scores2[:, :C], lengths2, _start(pdec._init(B)[0], 0))
    _lattice_chunk_twins(jdec, pdec, scores2[:, :9], np.minimum(lengths2, 9),
                         tuple(x.numpy() for x in fin))
    assert driver.driver_for(True, pdec._pg, pdec.cfg, S, B, scores.shape[2], "cpu") is drv
    assert drv.slots.io is None  # the chunk's tensors are not kept


def _viterbi_chunk_twins(jdec, pdec, scores, lengths, st0):
    S = pdec._dev_graph.num_states
    jst, jout = jdec._chunk_fn(jdec._pg_dev, jnp.asarray(scores), jnp.asarray(lengths),
                               _jax_state(*st0))
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2)))
    pst, pout = viterbi_chunk(pdec._pg, scores_tm, torch.from_numpy(lengths),
                              _port_state(*st0), pdec.cfg, S)
    for f in ("states", "costs", "base"):
        _eq(getattr(jst, f), getattr(pst, f), f)
    for f in pout._fields:
        _eq(getattr(jout, f), getattr(pout, f), f)


@pytest.mark.parametrize("config,fold", CASES)
def test_viterbi_chunk_driver_matches_jax(config, fold):
    """``viterbi_chunk`` through the frame driver against the JAX
    ``build_chunk_fn``, twice on one driver with other inputs."""
    jdec, pdec = _viterbi_twins(config, fold)
    scores, lengths = _inputs(seed=9)
    C = scores.shape[1]
    _viterbi_chunk_twins(jdec, pdec, scores, lengths, _start(pdec._init(B)[0], dead_row=0))
    scores2, lengths2 = _inputs(seed=10, lengths_of=C)
    _viterbi_chunk_twins(jdec, pdec, scores2[:, :C], lengths2, _start(pdec._init(B)[0], 3))


def test_frame_start_and_tail_on_the_slots():
    """The wrappers' CPU side on one frame driver's slots: the first-frame mode
    loads the chunk and GetCutoff of its start state, and each tail writes
    row t, advances t and leaves the next frame's K1 inputs, as
    ``frame_tail_plain`` gives them."""
    _, pdec = _lattice_twins("min_active", True)
    fc, S = pdec.cfg.frontier, pdec._dev_graph.num_states
    scores, lengths = _inputs(seed=11)
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2)))
    st0 = _port_state(*_start(pdec._init(B)[0], dead_row=1))
    drv = driver.FrameDriver(True, pdec._pg, pdec.cfg, S, B, scores.shape[2], "cpu")
    io = drv.begin(scores_tm, torch.from_numpy(lengths), st0)
    s = drv.slots
    cut = get_cutoff(st0.costs, fc.beam, fc.max_active, fc.min_active, fc.beam_delta,
                     costs_sorted=True)
    assert int(s.args[0]) == 0 and int(s.args[1]) == scores_tm.shape[0]
    for ref, got in ((cut.cutoff, s.cutoff), (cut.adaptive_beam, s.adaptive_beam),
                     (scores_tm[0], s.scores_t), (st0.costs, s.state.costs)):
        _eq(ref, got, "first frame")
    assert frame_start.launches == 0 and frame_tail.launches == 0  # the CPU launches nothing
    for t in range(3):
        st = StepState(*(x.clone() for x in s.state))
        fa = io.lengths > t
        tin = drv.body()
        final, out, nxt = frame_tail_plain(st, s.cutoff.clone(), tin, fa, fc)
        frame_tail(s, tin, fc)
        assert int(s.args[0]) == t + 1
        for ref, got in zip(final, s.state):
            _eq(ref, got, (t, "state"))
        for f, ref in zip(out._fields, out):
            _eq(ref, getattr(io.outs, f)[t], (t, f))
        _eq(nxt.cutoff, s.cutoff, (t, "cutoff"))
        _eq(nxt.adaptive_beam, s.adaptive_beam, (t, "adaptive_beam"))
        _eq(scores_tm[t + 1], s.scores_t, (t, "scores_t"))
        _eq(io.lengths > t + 1, s.active, (t, "active"))


@pytest.mark.parametrize("lattice", [True, False])
def test_eager_frames_is_the_step_loop(lattice):
    """``driver.eager_frames()`` runs the loop the frame driver replaced (the
    frame steps, each frame's outputs copied into the chunk's buffers),
    and gives what the frame driver's static-buffer frame gives, on the unfolded
    graph (eps closure on the device)."""
    _, pdec = (_lattice_twins if lattice else _viterbi_twins)("max_active", False)
    S = pdec._dev_graph.num_states
    scores, lengths = _inputs(seed=12)
    scores_tm = torch.from_numpy(np.ascontiguousarray(scores.transpose(1, 0, 2)))
    st0 = _port_state(*_start(pdec._init(B)[0], dead_row=2))
    run = lattice_chunk if lattice else viterbi_chunk
    args = (pdec._pg, scores_tm, torch.from_numpy(lengths), st0, pdec.cfg, S)
    with driver.eager_frames():
        ref = run(*args)
    got = run(*args)
    for r, g in zip(ref[0], got[0]):
        _eq(r, g, "state")
    for f in ref[1]._fields:
        _eq(getattr(ref[1], f), getattr(got[1], f), f)
