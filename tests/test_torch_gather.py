"""The port's row gather against the JAX package's row gathers, on the CPU.

Every Pallas kernel of the repo is a row gather of the packed ``em_block``
table (``scripts/gather*_bench.py``).  The two that take an ``interpret``
switch run here in Pallas interpret mode, as their scripts validate them on
the CPU: ``gather3_bench.block_gather`` on an (S, 16) table and
``gather4_bench.pallas_gather`` on the lane-packed (ceil(S/8), 128) table.
The main path's own gather, ``pg.em_block[safe]`` in
``frontier.expand_emitting``, runs as plain ``jnp`` on a packed HLG.  The
port's :func:`row_gather` must give the same rows, and on CPU tensors it
runs its plain version and launches nothing.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaldi_decoder_tpu.fst.pack import pack_graph_device as jax_pack
from kaldi_decoder_tpu_torch.kernels.gather import row_gather

from _torch_util import small_hlg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CACHE_KEYS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def _script(name):
    """Import ``scripts/<name>.py``, undoing its compilation-cache settings."""
    prev = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in prev.items():
            jax.config.update(k, v)
    return mod


def _case(name, rng):
    """(JAX rows, table, indices) of one gather."""
    if name == "em_block":
        _, cg, _ = small_hlg()
        table = np.array(jax_pack(cg, 3, 1, 4).em_block)
        idx = rng.integers(0, cg.num_states, size=(3, 64)).astype(np.int32)
        return np.asarray(jnp.asarray(table)[jnp.asarray(idx)]), table, idx
    if name == "block_gather":
        g3 = _script("gather3_bench")
        table = rng.integers(0, 1 << 20, size=(g3.S, g3.WID)).astype(np.int32)
        idx = rng.integers(0, g3.S, size=2048).astype(np.int32)
        ref = g3.block_gather(jnp.asarray(table), jnp.asarray(idx), interpret=True)
        return np.asarray(ref), table, idx
    g4 = _script("gather4_bench")
    flat = rng.integers(0, 1 << 20, size=(g4.S, g4.WID)).astype(np.int32)
    table = g4.pack_table(flat)
    idx = rng.integers(0, g4.S, size=256).astype(np.int32)
    groups = g4.pallas_gather(jnp.asarray(table), jnp.asarray(idx), ch=128, interpret=True)
    # The kernel gathers group rows; its sub-row select equals the flat rows.
    picked = g4.lane_select(groups, jnp.asarray(idx))
    np.testing.assert_array_equal(np.asarray(picked), flat[idx])
    return np.asarray(groups), table, idx // g4.G


@pytest.mark.parametrize("name", ["em_block", "block_gather", "pallas_gather"])
def test_row_gather_matches_jax(name):
    ref, table, idx = _case(name, np.random.default_rng(7))
    before = row_gather.launches
    got = row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert row_gather.launches == before == 0
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
