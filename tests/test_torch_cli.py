"""Twin tests of the port's command line against the JAX package's
(``kaldi_decoder_tpu/cli.py``), on the setup of ``tests/test_cli.py``: the
same HLG files, word table and posteriors; the port runs with ``--device
cpu``.  Every field of every JSON line but ``seconds`` must be equal, and
the lattices each writes must be the same bytes."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from kaldi_decoder_tpu.cli import main as jax_main
from kaldi_decoder_tpu_torch.cli import main
from kaldi_decoder_tpu_torch.fst.hlg import make_hlg, make_utterances
from kaldi_decoder_tpu_torch.fst.io import write_const_fst, write_fst

from _torch_util import jax_host_library

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    g = make_hlg(num_words=50, num_tokens=20, num_sentences=200, seed=2)
    rng = np.random.default_rng(9)
    scores, lengths, refs = make_utterances(g, 2, rng, words_per_utt=(2, 4))
    graphs = {"vector": str(tmp / "HLG.fst"), "const": str(tmp / "HLG.const.fst")}
    write_fst(g.hlg, graphs["vector"])
    write_const_fst(g.hlg, graphs["const"])
    words = tmp / "words.txt"
    with open(words, "w") as f:
        f.write("<eps> 0\n")
        for w, _ in g.lexicon:
            f.write(f"word{w} {w}\n")
    logits = []
    for b in range(2):
        p = tmp / f"utt{b}.npy"
        np.save(p, scores[b, : lengths[b]])
        logits.append(str(p))
    return tmp, refs, graphs, str(words), logits


def _lines(capsys, fn, argv):
    assert fn(argv) == 0
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def _twin(capsys, argv, lattice_dir=None):
    """The JAX CLI's lines (and written lattices), then the port's; the
    lines without ``seconds``."""
    jax_host_library()
    want = _lines(capsys, jax_main, argv)
    written = {}
    for rec in want:
        if "lattice" in rec:
            with open(rec["lattice"], "rb") as f:
                written[rec["lattice"]] = f.read()
            os.remove(rec["lattice"])
    got = _lines(capsys, main, argv + ["--device", "cpu"])
    for rec in got:
        if "lattice" in rec:
            with open(rec["lattice"], "rb") as f:
                assert f.read() == written[rec["lattice"]], rec["lattice"]
    for rec in want + got:
        assert rec.pop("seconds") >= 0
    assert got == want
    return got


@pytest.mark.parametrize("graph_key", ["vector", "const"])
def test_decode_lattice_matches_jax(cli_setup, capsys, graph_key):
    tmp, refs, graphs, words, logits = cli_setup
    lat_dir = tmp / f"lats_{graph_key}"
    lat_dir.mkdir(exist_ok=True)
    got = _twin(capsys, [
        "decode", "--graph", graphs[graph_key], "--logits", *logits, "--decoder", "lattice",
        "--words", words, "--nbest", "5", "--lattice-dir", str(lat_dir), "--beam", "16",
        "--max-active", "2000", "--lattice-beam", "6",
    ])
    for b, rec in enumerate(got):
        assert rec["hyp"] == " ".join(f"word{w}" for w in refs[b])
        assert rec["nbest"][0]["hyp"] == rec["hyp"] and "lattice" in rec


def test_decode_faster_matches_jax(cli_setup, capsys):
    tmp, refs, graphs, words, logits = cli_setup
    got = _twin(capsys, ["decode", "--graph", graphs["vector"], "--logits", *logits,
                         "--decoder", "faster", "--words", words, "--beam", "16",
                         "--max-active", "2000"])
    assert got[0]["hyp"] == " ".join(f"word{w}" for w in refs[0])


def test_decode_without_words_and_log_softmax_matches_jax(cli_setup, capsys):
    tmp, refs, graphs, words, logits = cli_setup
    got = _twin(capsys, ["decode", "--graph", graphs["vector"], "--logits", logits[0],
                         "--beam", "16", "--max-active", "2000", "--apply-log-softmax"])
    assert got[0]["hyp"] == " ".join(str(w) for w in refs[0])


@pytest.mark.parametrize("graph_key", ["vector", "const"])
def test_info_matches_jax(cli_setup, capsys, graph_key):
    _, _, graphs, _, _ = cli_setup
    jax_host_library()
    want = _lines(capsys, jax_main, ["info", "--graph", graphs[graph_key]])
    assert _lines(capsys, main, ["info", "--graph", graphs[graph_key]]) == want


def test_device_cuda_without_card_exits_nonzero(cli_setup):
    """``python -m kaldi_decoder_tpu_torch.cli`` with the default device
    and no card exits non-zero with the reason; with ``--device cpu`` it
    decodes."""
    _, _, graphs, _, logits = cli_setup
    argv = [sys.executable, "-m", "kaldi_decoder_tpu_torch.cli", "decode", "--graph",
            graphs["vector"], "--logits", logits[0], "--beam", "16"]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr
    assert out.stdout == ""
    out = subprocess.run(argv + ["--device", "cpu"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "hyp" in json.loads(out.stdout)
