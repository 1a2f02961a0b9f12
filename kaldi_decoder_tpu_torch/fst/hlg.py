"""Native HLG decoding graphs and workload synthesis: lexicon, corpus, CTC posteriors.

A jax-free copy of ``kaldi_decoder_tpu/fst/hlg.py`` (``random_lexicon``,
``sample_corpus``, ``HlgGraph``, ``build_hlg``, ``make_hlg``,
``words_to_tokens``, ``synth_posteriors``, ``make_utterances``), kept
because importing the original imports jax.  With them the bench's
utterances and transcripts are rebuilt from the seed exactly as
``bench.py`` builds them, from the cached graph, on any numpy:
``sample_corpus`` draws its Zipf samples through ``_zipf``, numpy's
pre-2.3 algorithm, so the corpus that built the cached graph does not
change with numpy's version; and a test graph is built from a seed
(``make_hlg``: ``connect(ctc_topo ∘ L ∘ bigram-G)``) without the JAX
package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from kaldi_decoder_tpu_torch.fst.fst import StdVectorFst
from kaldi_decoder_tpu_torch.fst.ops import compose, connect
from kaldi_decoder_tpu_torch.fst.topo import ctc_topo, lexicon_fst, ngram_fst


def random_lexicon(
    num_words: int,
    num_tokens: int,
    rng: np.random.Generator,
    min_len: int = 3,
    max_len: int = 8,
) -> List[Tuple[int, List[int]]]:
    """Random pronunciation lexicon: word ids 1..num_words, token ids in
    1..num_tokens-1 (0 is the CTC blank and never appears in a
    pronunciation)."""
    if num_tokens < 3:
        raise ValueError("need at least 3 tokens (blank + 2 symbols)")
    lex = []
    seen = set()
    for w in range(1, num_words + 1):
        while True:
            ln = int(rng.integers(min_len, max_len + 1))
            toks = tuple(int(t) for t in rng.integers(1, num_tokens, size=ln))
            if toks not in seen:  # homophones would make WER ambiguous
                seen.add(toks)
                break
        lex.append((w, list(toks)))
    return lex


def _zipf(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy up to 2.2 draws it: the rejection
    method on pairs of uniform doubles, consuming the stream the same way.
    numpy 2.3 changed ``Generator.zipf``; drawing through ``rng.random``,
    whose stream is stable, keeps the corpus that built the cached bench
    graph, and so the bench's transcripts, the same on any numpy."""
    am1 = a - 1.0
    b = 2.0**am1
    out = np.empty(size, np.int64)
    for i in range(size):
        while True:
            U = 1.0 - rng.random()
            V = rng.random()
            Xf = U ** (-1.0 / am1)
            if Xf > 9.223372036854776e18:  # beyond int64: rejected
                continue
            X = float(math.floor(Xf))
            T = (1.0 + 1.0 / X) ** am1
            if V * X * (T - 1.0) / (b - 1.0) <= T / b:
                out[i] = int(X)
                break
    return out


def sample_corpus(
    num_words: int,
    num_sentences: int,
    rng: np.random.Generator,
    mean_len: float = 8.0,
    zipf_a: float = 1.3,
) -> List[List[int]]:
    """Zipf-distributed random sentences over word ids 1..num_words (the
    bigram-G training text)."""
    out = []
    for _ in range(num_sentences):
        n = max(1, int(rng.poisson(mean_len)))
        ws = np.minimum(_zipf(rng, zipf_a, n), num_words).astype(int)
        out.append([int(w) for w in ws])
    return out


@dataclasses.dataclass
class HlgGraph:
    """A built HLG plus everything needed to synthesize/score utterances."""

    hlg: StdVectorFst
    lexicon: List[Tuple[int, List[int]]]
    num_tokens: int  # V — CTC ids incl. blank 0; graph ilabels are id+1
    corpus: List[List[int]]

    @property
    def pron(self) -> Dict[int, List[int]]:
        return dict(self.lexicon)


def build_hlg(
    lexicon: Sequence[Tuple[int, Sequence[int]]],
    sentences: Sequence[Sequence[int]],
    num_tokens: int,
    modified_topo: bool = False,
) -> StdVectorFst:
    """HLG = connect(ctc_topo(V) ∘ L ∘ G).

    Composition order matches the icefall recipes feeding the reference:
    the H side consumes ``token_id + 1`` input labels (the DecodableCtc
    ``index - 1`` convention, `decodable-ctc.cc:22-29`), L maps token
    sequences to word ids, the bigram G weighs word sequences and adds
    epsilon backoff arcs.
    """
    H = ctc_topo(num_tokens, modified=modified_topo)
    L = lexicon_fst(list(lexicon))
    G = ngram_fst(sentences)
    HL = compose(H, L)
    HLG = compose(HL, G)
    return connect(HLG)


def make_hlg(
    num_words: int = 1000,
    num_tokens: int = 50,
    num_sentences: int = 2000,
    seed: int = 0,
    modified_topo: bool = False,
    min_len: int = 3,
    max_len: int = 8,
) -> HlgGraph:
    """One-call native HLG: random lexicon + Zipf corpus + bigram G."""
    rng = np.random.default_rng(seed)
    lex = random_lexicon(num_words, num_tokens, rng, min_len, max_len)
    corpus = sample_corpus(num_words, num_sentences, rng)
    hlg = build_hlg(lex, corpus, num_tokens, modified_topo)
    return HlgGraph(hlg=hlg, lexicon=lex, num_tokens=num_tokens, corpus=corpus)


def words_to_tokens(
    words: Sequence[int], pron: Dict[int, List[int]]
) -> List[int]:
    """Word sequence -> CTC token sequence via the lexicon."""
    toks: List[int] = []
    for w in words:
        toks.extend(pron[int(w)])
    return toks


def synth_posteriors(
    token_seq: Sequence[int],
    num_tokens: int,
    rng: np.random.Generator,
    frames_per_token: Tuple[int, int] = (1, 3),
    blank_prob: float = 0.5,
    peak: float = 4.0,
    noise_alpha: float = 0.3,
) -> np.ndarray:
    """CTC-aligned synthetic log-softmax posteriors for ``token_seq``.

    Each token occupies 1..frames_per_token[1] frames (CTC repeats
    collapse); a blank frame is inserted with probability ``blank_prob``
    between tokens and always between identical neighbours.  Per-frame
    noise comes from a Dirichlet; ``peak`` is the log-odds boost of the
    aligned id.  Returns (T, V) float32 where column j scores CTC id j
    (graph ilabel j+1).
    """
    ids: List[int] = []
    prev = None
    for t in token_seq:
        t = int(t)
        if prev is not None and (t == prev or rng.random() < blank_prob):
            ids.append(0)  # blank separator
        reps = int(rng.integers(frames_per_token[0], frames_per_token[1] + 1))
        ids.extend([t] * reps)
        prev = t
    ids.append(0)  # trailing blank
    T = len(ids)
    arr = np.asarray(ids)
    logp = np.log(
        rng.dirichlet(np.ones(num_tokens) * noise_alpha, size=T)
    ).astype(np.float64)
    logp[np.arange(T), arr] += peak
    logp -= np.log(np.exp(logp).sum(axis=1, keepdims=True))
    return logp.astype(np.float32)


def make_utterances(
    g: HlgGraph,
    batch: int,
    rng: np.random.Generator,
    words_per_utt: Tuple[int, int] = (3, 8),
    from_corpus: bool = True,
    **synth_kw,
) -> Tuple[np.ndarray, np.ndarray, List[List[int]]]:
    """Sample transcripts and synthesize a padded posterior batch.

    Returns (scores (B, T, V), lengths (B,), transcripts).  Transcripts
    come from the G training corpus by default so the grammar assigns
    them reasonable probability (out-of-LM word sequences are still
    decodable through backoff).
    """
    transcripts: List[List[int]] = []
    per_utt: List[np.ndarray] = []
    pron = g.pron
    lo, hi = words_per_utt
    sent_pool = [s for s in g.corpus if lo <= len(s) <= hi] if from_corpus else []
    for _ in range(batch):
        if sent_pool:
            words = list(sent_pool[int(rng.integers(len(sent_pool)))])
        else:
            n = int(rng.integers(lo, hi + 1))
            words = [int(w) for w in rng.integers(1, len(g.lexicon) + 1, size=n)]
        transcripts.append(words)
        toks = words_to_tokens(words, pron)
        per_utt.append(synth_posteriors(toks, g.num_tokens, rng, **synth_kw))
    T = max(s.shape[0] for s in per_utt)
    V = g.num_tokens
    scores = np.full((batch, T, V), np.log(1.0 / V), np.float32)
    lengths = np.zeros(batch, np.int32)
    for b, s in enumerate(per_utt):
        scores[b, : s.shape[0]] = s
        lengths[b] = s.shape[0]
    return scores, lengths, transcripts
