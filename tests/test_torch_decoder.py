"""The port's slice as a whole against the JAX decoder, on the CPU.

``BatchedLatticeDecoder.decode(device_prune=True)`` of both packages on
the same graph, scores and config: the per-chunk survivor rows and
counts (eps rows included), the per-frame stats and the 1-best labels of
every utterance must be equal.  Cases cover an eps-folded HLG, the same
HLG unfolded (the device eps path), a graph with no eps arcs,
remainder-lane overflow and frontier saturation.
"""

import numpy as np
import pytest

from kaldi_decoder_tpu.decoders.lattice import BatchedLatticeDecoder as JaxDecoder
from kaldi_decoder_tpu_torch import BatchedLatticeDecoder
from kaldi_decoder_tpu_torch.fst.fold import fold_eps

from _torch_util import (
    assert_same_config,
    hlg_batch,
    jax_host_library,
    noeps_batch,
    small_hlg,
    small_noeps,
    twin_configs,
)

CASES = {
    # name: (graph, frontier kwargs, decoder kwargs, expect overflow, expect
    # saturation; None: not checked)
    "hlg": ("hlg", dict(frontier_size=64, max_active=48), dict(em_records=512),
            False, None),
    "hlg_unfolded": ("hlg", dict(frontier_size=64, max_active=48),
                     dict(em_records=512, fold=False), False, None),
    "hlg_overflow": ("hlg", dict(frontier_size=64, max_active=48, rem_budget=16),
                     dict(em_records=512), True, None),
    "hlg_saturated": ("hlg", dict(frontier_size=16, max_active=12, min_active=4),
                      dict(em_records=64), None, True),
    "noeps": ("noeps", dict(frontier_size=64, max_active=40, beam=8.0),
              dict(em_records=256, lattice_beam=4.0), None, None),
}


def _twins(case):
    kind, fkw, dkw, _, _ = CASES[case]
    dkw = dict(dict(lattice_beam=5.0, pad_time_to=8), **dkw)
    fold = dkw.get("fold", True)
    if kind == "hlg":
        _, jg, pg = small_hlg()
        scores, lengths, _ = hlg_batch(3, seed=11)
        jdev = JaxDecoder(jg, None, pad_time_to=8, fold=fold)._dev_graph
        pdev = fold_eps(pg).device if fold else pg
    else:
        jg, pg = small_noeps()
        scores, lengths = noeps_batch(3, 30, seed=2)
        jdev, pdev = jg, pg
    jfc, pfc = twin_configs(jdev, pdev, **fkw)
    jdec = JaxDecoder(jg, jfc, **dkw)
    pdec = BatchedLatticeDecoder(pg, pfc, device="cpu", **dkw)
    assert_same_config(jdec.cfg.frontier, pdec.cfg.frontier, eps=not fold)
    assert jdec.cfg.em_records == pdec.cfg.em_records
    assert jdec.cfg.eps_records == pdec.cfg.eps_records
    return jdec, pdec, scores, lengths


@pytest.mark.parametrize("case", sorted(CASES))
def test_slice_matches_jax(case):
    jdec, pdec, scores, lengths = _twins(case)
    jres = jdec.decode(scores, lengths, chunk_frames=8, device_prune=True)
    pres = pdec.decode(scores, lengths, chunk_frames=8, device_prune=True)
    B = scores.shape[0]

    for field in ("num_active", "cutoffs", "overflows", "saturations"):
        np.testing.assert_array_equal(
            getattr(jres, field), getattr(pres, field), err_msg=field
        )
    np.testing.assert_array_equal(jres.init_states, pres.init_states)
    np.testing.assert_array_equal(jres.init_costs, pres.init_costs)
    assert len(jres.survivors) == len(pres.survivors)
    for jc, pc in zip(jres.survivors, pres.survivors):
        assert jc["frame0"] == pc["frame0"]
        np.testing.assert_array_equal(jc["overflow"], pc["overflow"])
        # The JAX sweep keeps eps links only where the device graph has eps arcs.
        assert np.asarray(jc["eps_count"]).any() == (jdec.cfg.frontier.eps_iters > 0)
        for name in ("tok", "em", "eps"):
            cnt = np.asarray(jc[f"{name}_count"])
            np.testing.assert_array_equal(cnt, pc[f"{name}_count"])
            for b in range(B):
                np.testing.assert_array_equal(
                    np.asarray(jc[f"{name}_rows"])[b, : cnt[b]],
                    pc[f"{name}_rows"][b, : cnt[b]],
                    err_msg=f"{name} rows, chunk {jc['frame0']}, b={b}",
                )
    jax_host_library()
    for b in range(B):
        assert jres.best_path_labels(b) == pres.best_path_labels(b), b
        assert not pres.sweep_overflowed(b)

    _, _, _, want_ovf, want_sat = CASES[case]
    if want_ovf is not None:
        assert bool(pres.overflows.any()) == want_ovf
    if want_sat is not None:
        assert bool(pres.saturations.any()) == want_sat


@pytest.mark.parametrize("case", ["hlg", "noeps"])
def test_device_prune_keeps_the_lattice(case):
    """The port's swept result gives the same pruned lattice and labels as
    its full-record result."""
    from kaldi_decoder_tpu_torch.lattice.prune import flat_arc_arrays

    _, pdec, scores, lengths = _twins(case)
    full = pdec.decode(scores, lengths, chunk_frames=8, device_prune=False)
    swept = pdec.decode(scores, lengths, chunk_frames=8, device_prune=True)
    assert full.survivors is None and swept.survivors is not None
    np.testing.assert_array_equal(full.num_active, swept.num_active)
    for b in range(scores.shape[0]):
        fa, fs = flat_arc_arrays(full._prune(b)), flat_arc_arrays(swept._prune(b))
        for x, y in zip(fa, fs):
            np.testing.assert_array_equal(x, y)
        assert full.best_path_labels(b) == swept.best_path_labels(b)


def test_sweep_overflow_falls_back_to_full_records(monkeypatch):
    """A survivor buffer overflow re-runs the decode with
    ``device_prune=False`` on the same device, and the labels stay."""
    import dataclasses

    from kaldi_decoder_tpu_torch.decoders import lattice as plattice

    _, pdec, scores, lengths = _twins("hlg")
    full = pdec.decode(scores, lengths, chunk_frames=8, device_prune=False)
    real = plattice.sweep_config
    monkeypatch.setattr(
        plattice, "sweep_config",
        lambda cfg, C: dataclasses.replace(real(cfg, C), tok_cap=8, em_cap=8),
    )
    res = pdec.decode(scores, lengths, chunk_frames=8, device_prune=True)
    assert res.survivors is None and res.em_records is not None
    for b in range(scores.shape[0]):
        assert res.best_path_labels(b) == full.best_path_labels(b)

