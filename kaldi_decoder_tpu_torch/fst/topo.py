"""Decoding-graph builders: CTC topologies and test-graph generators.

A jax-free copy of ``kaldi_decoder_tpu/fst/topo.py`` (all of it, lines
14-290: ``ctc_topo``, ``linear_acceptor``, ``random_fst``, ``ngram_fst``,
``lexicon_fst``), kept because importing the original imports jax;
``tests/test_torch_fst_io.py`` holds the copy equal to the original.

H-graph input labels are ``token_id + 1`` so that epsilon (0) and the CTC
blank (token 0) do not collide, which is why ``DecodableCtc`` reads
``p[frame, index - 1]`` (`kaldi-decoder/csrc/decodable-ctc.cc:22-29`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from kaldi_decoder_tpu_torch.fst.fst import EPSILON, StdVectorFst


def ctc_topo(num_tokens: int, modified: bool = False) -> StdVectorFst:
    """Build the CTC topology acceptor H over ``num_tokens`` CTC ids.

    Token 0 is the blank.  Input labels are ``token_id + 1`` (the reference's
    H convention, `decodable-ctc.cc:22-29`); output labels are raw token ids
    (blank/repeats emit epsilon).

    ``modified=False``: the standard CTC topology — repeats collapse, a
    blank is required between two identical tokens, O(V^2) arcs.

    ``modified=True``: the compact variant (k2-style "modified" topo) with
    O(V) arcs: every token loops on a single state; repeats collapse via a
    per-token emitting state with an epsilon-output self-loop.
    """
    fst = StdVectorFst()
    if modified:
        # State 0 is start/final.  For each non-blank token t there is a
        # state s_t entered while emitting olabel t; its self-loop re-emits
        # the token with eps output; returning to 0 is free (eps).
        s0 = fst.add_state()
        fst.set_start(s0)
        fst.set_final(s0)
        fst.add_arc(s0, 1, EPSILON, 0.0, s0)  # blank self-loop
        for t in range(1, num_tokens):
            st = fst.add_state()
            fst.add_arc(s0, t + 1, t, 0.0, st)  # first emission
            fst.add_arc(st, t + 1, EPSILON, 0.0, st)  # repeats
            fst.add_arc(st, EPSILON, EPSILON, 0.0, s0)  # leave (free)
            fst.set_final(st)
        return fst

    # Standard topology: state 0 = "just emitted blank (or start)";
    # state s_t = "just emitted token t".
    s0 = fst.add_state()
    fst.set_start(s0)
    fst.set_final(s0)
    tok_state = {}
    for t in range(1, num_tokens):
        tok_state[t] = fst.add_state()
        fst.set_final(tok_state[t])
    fst.add_arc(s0, 1, EPSILON, 0.0, s0)  # blank repeat
    for t in range(1, num_tokens):
        fst.add_arc(s0, t + 1, t, 0.0, tok_state[t])
    for t in range(1, num_tokens):
        st = tok_state[t]
        fst.add_arc(st, t + 1, EPSILON, 0.0, st)  # repeat collapses
        fst.add_arc(st, 1, EPSILON, 0.0, s0)  # blank resets
        for u in range(1, num_tokens):
            if u != t:
                fst.add_arc(st, u + 1, u, 0.0, tok_state[u])
    return fst


def linear_acceptor(labels: Sequence[int], shift_ilabel: int = 0) -> StdVectorFst:
    """Linear chain accepting exactly ``labels`` (olabel == label)."""
    fst = StdVectorFst()
    cur = fst.add_state()
    fst.set_start(cur)
    for lab in labels:
        nxt = fst.add_state()
        fst.add_arc(cur, lab + shift_ilabel, lab, 0.0, nxt)
        cur = nxt
    fst.set_final(cur)
    return fst


def random_fst(
    num_states: int,
    num_symbols: int,
    rng: np.random.Generator,
    mean_arcs_per_state: float = 3.0,
    eps_prob: float = 0.2,
    final_prob: float = 0.3,
    max_weight: float = 4.0,
    acyclic_eps: bool = True,
    olabel_symbols: Optional[int] = None,
) -> StdVectorFst:
    """Seeded random WFST for differential tests.

    Input labels are in ``1..num_symbols`` (score index = ilabel - 1) with a
    fraction ``eps_prob`` of epsilon arcs.  Epsilon arcs only go to
    higher-numbered states when ``acyclic_eps`` so the epsilon closure is a
    DAG (HLG-like; the reference worklist also assumes convergent closures).
    Every state gets at least one outgoing emitting arc and the graph is
    made connected from the start state via a random spanning chain.
    """
    if olabel_symbols is None:
        olabel_symbols = num_symbols
    fst = StdVectorFst()
    fst.add_states(num_states)
    fst.set_start(0)

    def rand_weight() -> float:
        return float(np.round(rng.uniform(0.0, max_weight), 3))

    # Spanning chain to guarantee reachability.
    perm = rng.permutation(num_states - 1) + 1
    prev = 0
    for s in perm:
        fst.add_arc(
            prev,
            int(rng.integers(1, num_symbols + 1)),
            int(rng.integers(0, olabel_symbols + 1)),
            rand_weight(),
            int(s),
        )
        prev = int(s)

    for s in range(num_states):
        n_extra = max(1, int(rng.poisson(mean_arcs_per_state)))
        for _ in range(n_extra):
            dst = int(rng.integers(0, num_states))
            if rng.random() < eps_prob:
                if acyclic_eps:
                    if s == num_states - 1:
                        continue
                    dst = int(rng.integers(s + 1, num_states))
                fst.add_arc(
                    s, EPSILON, int(rng.integers(0, olabel_symbols + 1)),
                    rand_weight(), dst,
                )
            else:
                fst.add_arc(
                    s,
                    int(rng.integers(1, num_symbols + 1)),
                    int(rng.integers(0, olabel_symbols + 1)),
                    rand_weight(),
                    dst,
                )
        if rng.random() < final_prob or s == num_states - 1:
            fst.set_final(s, rand_weight())
    return fst


def ngram_fst(
    sentences: Sequence[Sequence[int]],
    vocab: Optional[Sequence[int]] = None,
    discount: float = 0.4,
) -> StdVectorFst:
    """Bigram grammar acceptor G with absolute-discounting backoff.

    The reference decodes through HLG graphs whose G is an n-gram LM
    acceptor built by Kaldi/icefall tooling (the reference's `README.md:16-20`);
    this is the native equivalent so full HLG graphs can be built in-repo.
    Standard Kaldi G topology:

    * state per word history ``h`` (plus a start state for the ``<s>``
      history and a backoff/unigram state);
    * arc ``h --w:w/-log p(w|h)--> state(w)`` for every seen bigram;
    * epsilon backoff arc ``h --eps/-log bow(h)--> backoff state`` (the
      eps-input arcs HLG composition and decoding must handle);
    * from the backoff state, ``w:w/-log p_uni(w)`` for every vocab word;
    * final weight ``-log p(</s>|h)`` per history (end-of-sentence mass).

    ``sentences`` are sequences of word ids >= 1 (0 is epsilon).  The eps
    subgraph is a depth-1 DAG (history -> backoff), so the graph is
    fold-friendly (:mod:`kaldi_decoder_tpu_torch.fst.fold`).
    """
    if not 0.0 < discount < 1.0:
        raise ValueError("discount must be in (0, 1)")
    uni: dict = {}
    big: dict = {}
    EOS = -1  # internal end-of-sentence event key
    for sent in sentences:
        hist = 0  # 0 == <s> history (not a word id; word ids are >= 1)
        for w in sent:
            w = int(w)
            if w <= 0:
                raise ValueError("word ids must be >= 1 (0 is epsilon)")
            uni[w] = uni.get(w, 0) + 1
            big[(hist, w)] = big.get((hist, w), 0) + 1
            hist = w
        big[(hist, EOS)] = big.get((hist, EOS), 0) + 1
    if vocab is None:
        vocab = sorted(uni)
    vocab = [int(w) for w in vocab]
    if not vocab:
        raise ValueError("empty vocabulary")

    # Unigram distribution with add-one smoothing over vocab + </s>.
    n_tokens = sum(uni.values()) + sum(
        c for (h, w), c in big.items() if w == EOS
    )
    denom_uni = n_tokens + len(vocab) + 1
    p_uni = {w: (uni.get(w, 0) + 1) / denom_uni for w in vocab}
    p_uni_eos = (sum(c for (h, w), c in big.items() if w == EOS) + 1) / denom_uni

    # Per-history counts for discounting, and bigrams grouped by history.
    hist_count: dict = {}
    by_hist: dict = {}
    for (h, w), c in big.items():
        hist_count[h] = hist_count.get(h, 0) + c
        by_hist.setdefault(h, []).append((w, c))

    fst = StdVectorFst()
    start = fst.add_state()  # <s> history
    backoff = fst.add_state()  # unigram state
    fst.set_start(start)
    word_state = {w: fst.add_state() for w in vocab}

    def hstate(h: int) -> int:
        return start if h == 0 else word_state[h]

    nl = np.log
    # Backoff state: unigram arcs + eos final.
    for w in vocab:
        fst.add_arc(backoff, w, w, float(-nl(p_uni[w])), word_state[w])
    fst.set_final(backoff, float(-nl(p_uni_eos)))

    seen_hists = sorted(hist_count, key=lambda h: (h != 0, h))
    for h in seen_hists:
        s = hstate(h)
        tot = hist_count[h]
        bow = discount * len(by_hist[h]) / tot
        fst.add_arc(s, EPSILON, EPSILON, float(-nl(bow)), backoff)
        for w, c in by_hist[h]:
            p = (c - discount) / tot
            if p <= 0:
                continue
            if w == EOS:
                fst.set_final(s, float(-nl(p)))
            else:
                fst.add_arc(s, w, w, float(-nl(p)), word_state[w])
    # Histories never seen (word only at sentence end): pure backoff.
    for w in vocab:
        if w not in hist_count:
            fst.add_arc(word_state[w], EPSILON, EPSILON, 0.0, backoff)
    return fst


def lexicon_fst(
    lexicon: Sequence,
    word_weights: Optional[Sequence[float]] = None,
    loop: bool = True,
) -> StdVectorFst:
    """Trie-shaped lexicon transducer L: token sequences -> word ids.

    ``lexicon`` is a sequence of ``(word_id, token_ids)`` pairs; tokens are
    the raw CTC ids the topology's *output* labels carry, so
    ``compose(ctc_topo(V), lexicon_fst(lex))`` builds an HL decoding graph
    (the graph icefall feeds the reference decoders,
    the reference's `README.md:16-20`).  The word id rides the first arc
    of the word (Kaldi L convention); with ``loop`` an epsilon arc returns
    from each word end to the root so word sequences are accepted.
    """
    fst = StdVectorFst()
    root = fst.add_state()
    fst.set_start(root)
    fst.set_final(root)  # empty word sequence accepted
    # trie: node -> {token -> (node, has_word_olabel)}; shared prefixes must
    # not share the word olabel, so the olabel goes on the first arc unique
    # to the word (first arc overall here: words sharing a first token get
    # distinct first arcs, like Kaldi's L with disambiguation collapsed).
    for i, (word, toks) in enumerate(lexicon):
        toks = list(toks)
        if not toks:
            raise ValueError(f"word {word} has an empty pronunciation")
        w = float(word_weights[i]) if word_weights is not None else 0.0
        cur = root
        for j, t in enumerate(toks):
            nxt = fst.add_state()
            fst.add_arc(cur, int(t), int(word) if j == 0 else EPSILON,
                        w if j == 0 else 0.0, nxt)
            cur = nxt
        fst.set_final(cur)
        if loop:
            fst.add_arc(cur, EPSILON, EPSILON, 0.0, root)
    return fst
