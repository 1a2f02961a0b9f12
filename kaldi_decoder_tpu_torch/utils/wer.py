"""Word error rate: the accuracy metric of the decoder's workload.

A copy of ``kaldi_decoder_tpu/utils/wer.py``, kept because importing the
original imports jax.  Decodes of CTC posteriors are scored by WER in the
icefall recipes that feed k2-fsa/kaldi-decoder; this scores the port's
end-to-end decodes the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, int, int, int]:
    """Levenshtein alignment counts: (substitutions, insertions, deletions,
    correct) between ``ref`` and ``hyp`` token sequences."""
    R, H = len(ref), len(hyp)
    # dp[j] = (cost, subs, ins, dels) for prefix alignment.
    prev = [(j, 0, j, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                c, s, n, d = prev[j - 1]
                cand = (c, s, n, d)
            else:
                c, s, n, d = prev[j - 1]
                cand = (c + 1, s + 1, n, d)
            c, s, n, d = cur[j - 1]
            if c + 1 < cand[0]:
                cand = (c + 1, s, n + 1, d)
            c, s, n, d = prev[j]
            if c + 1 < cand[0]:
                cand = (c + 1, s, n, d + 1)
            cur.append(cand)
        prev = cur
    cost, subs, ins, dels = prev[H]
    correct = R - subs - dels
    return subs, ins, dels, correct


@dataclasses.dataclass
class WerStats:
    """Aggregate WER over a set of utterances."""

    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    correct: int = 0
    ref_words: int = 0
    utterances: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def wer(self) -> float:
        return self.errors / self.ref_words if self.ref_words else 0.0

    @property
    def accuracy(self) -> float:
        return 1.0 - self.wer

    def __str__(self) -> str:
        return (
            f"WER {100 * self.wer:.2f}% "
            f"[{self.errors} errs = {self.substitutions} sub + "
            f"{self.insertions} ins + {self.deletions} del / "
            f"{self.ref_words} words, {self.utterances} utts]"
        )


def wer(refs: Sequence[Sequence], hyps: Sequence[Sequence]) -> WerStats:
    """Aggregate WER of hypothesis transcripts vs references."""
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps must have equal length")
    st = WerStats()
    for r, h in zip(refs, hyps):
        s, i, d, c = edit_distance(list(r), list(h))
        st.substitutions += s
        st.insertions += i
        st.deletions += d
        st.correct += c
        st.ref_words += len(r)
        st.utterances += 1
    return st
