"""Twin tests of the port's CTC encoder against ``kaldi_decoder_tpu/models/ctc.py``:
the JAX ``init_params`` tree carried across as numpy arrays by
``encoder_from_numpy``, the same seeded features through both, posteriors
within 1e-5; and the encoder feeding the port's ``FasterDecoder`` on a
CTC topology end to end, as ``tests/test_model_e2e.py`` does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.models.ctc import CtcEncoderConfig as JaxConfig
from kaldi_decoder_tpu.models.ctc import forward as jax_forward
from kaldi_decoder_tpu.models.ctc import init_params
from kaldi_decoder_tpu_torch import DecodableCtc, FasterDecoder
from kaldi_decoder_tpu_torch.fst import ctc_topo
from kaldi_decoder_tpu_torch.models import CtcEncoder, CtcEncoderConfig, encoder_from_numpy

SMALL = dict(num_features=16, hidden_dim=32, num_layers=2, vocab_size=12, subsampling=4)


def _numpy_params(cfg, seed):
    params = init_params(JaxConfig(**cfg), jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("cfg,T", [
    (SMALL, 40),
    (dict(num_features=20, hidden_dim=48, num_layers=3, vocab_size=30, subsampling=3), 61),
])
def test_encoder_matches_jax(cfg, T):
    params = _numpy_params(cfg, 0)
    feats = np.random.default_rng(0).normal(size=(2, T, cfg["num_features"])).astype(np.float32)
    want = np.asarray(jax_forward(params, jnp.asarray(feats), JaxConfig(**cfg)))
    enc = encoder_from_numpy(params, CtcEncoderConfig(**cfg), "cpu")
    with torch.no_grad():
        got = enc(torch.from_numpy(feats)).numpy()
    assert got.shape == want.shape == (2, T // cfg["subsampling"], cfg["vocab_size"])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=1e-4)


def test_encoder_defaults_and_seeded_init():
    """The defaults are the original's; weights drawn from a seeded
    generator are the same each time and have the original's shapes."""
    cfg = CtcEncoderConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JaxConfig())
    a = CtcEncoder(cfg, torch.Generator().manual_seed(3), device="cpu")
    b = CtcEncoder(cfg, torch.Generator().manual_seed(3), device="cpu")
    params = _numpy_params(dict(num_features=80, hidden_dim=256, num_layers=4, vocab_size=500,
                                subsampling=4), 0)
    c = encoder_from_numpy(params, cfg, "cpu")
    for (ka, va), (kb, vb), (kc, vc) in zip(a.state_dict().items(), b.state_dict().items(),
                                           c.state_dict().items()):
        assert ka == kb == kc and torch.equal(va, vb) and va.shape == vc.shape
    with pytest.raises(ValueError):
        encoder_from_numpy(params, CtcEncoderConfig(num_layers=3), "cpu")


def test_encoder_to_decoder_end_to_end():
    """Encoder posteriors feed the port's FasterDecoder on ctc_topo through
    DecodableCtc; the best path equals the JAX pipeline's."""
    from kaldi_decoder_tpu.decodable import DecodableCtc as JaxDecodableCtc
    from kaldi_decoder_tpu.decoders import FasterDecoder as JaxFasterDecoder
    from kaldi_decoder_tpu.fst import ctc_topo as jax_ctc_topo
    from kaldi_decoder_tpu.fst import path_labels as jax_path_labels
    from kaldi_decoder_tpu_torch.fst import path_labels

    params = _numpy_params(SMALL, 0)
    feats = np.random.default_rng(1).normal(size=(1, 80, SMALL["num_features"]))
    enc = encoder_from_numpy(params, CtcEncoderConfig(**SMALL), "cpu")
    with torch.no_grad():
        logp = enc(torch.from_numpy(feats.astype(np.float32)))[0].numpy()
    dec = FasterDecoder(ctc_topo(SMALL["vocab_size"]), device="cpu")
    dec.decode(DecodableCtc(logp))
    ok, best = dec.get_best_path()
    assert ok and dec.num_frames_decoded() == logp.shape[0]
    jdec = JaxFasterDecoder(jax_ctc_topo(SMALL["vocab_size"]))
    jdec.decode(JaxDecodableCtc(logp))
    jok, jbest = jdec.get_best_path()
    assert jok and path_labels(best) == jax_path_labels(jbest)
