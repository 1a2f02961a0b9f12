"""Acoustic-score sources ("decodables").

A copy of ``kaldi_decoder_tpu/decodable/decodable.py`` (numpy only),
kept because importing the original imports jax.  It mirrors the
reference's acoustic interface (`kaldi-decoder/csrc/decodable-itf.h:65-102`):
a decodable answers "what is the log-likelihood of input label *i*
(1-based) at frame *t*", grows ``num_frames_ready`` when streaming, and
signals the last frame.  The decoders consume scores as dense ``(T, V)``
arrays; a ``DecodableInterface`` subclass written in Python is
materialized into one by :func:`scores_from_decodable`.  Emitting arcs
store ``score_idx = ilabel - 1`` (`decodable-ctc.cc:22-29`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


class DecodableInterface:
    """Abstract acoustic-score source (decodable-itf.h:65-102 parity).

    Subclass and implement ``log_likelihood`` / ``is_last_frame`` /
    ``num_frames_ready`` / ``num_indices`` exactly as with the reference's
    Python trampoline.  Frames are 0-based; indices are 1-based.
    """

    def log_likelihood(self, frame: int, index: int) -> float:
        raise NotImplementedError

    def is_last_frame(self, frame: int) -> bool:
        raise NotImplementedError

    def num_frames_ready(self) -> int:
        """Frames currently available; -1 means 'not supported' in the
        reference (decodable-itf.h:87-96) but all our decodables support it."""
        raise NotImplementedError

    def num_indices(self) -> int:
        raise NotImplementedError

    # -- dense fast path ----------------------------------------------------

    def score_matrix(self) -> Optional[np.ndarray]:
        """If the scores exist as a dense ``(num_frames_ready - offset, V)``
        float32 log-prob matrix, return it (fast path). Else None and the
        decoders fall back to element-wise materialization."""
        return None

    def frame_offset(self) -> int:
        """First frame covered by :meth:`score_matrix` (streaming chunks)."""
        return 0


class DecodableCtc(DecodableInterface):
    """CTC decodable over a ``(T, V)`` log-softmax matrix
    (decodable-ctc.h:13-43 parity, including the streaming ``offset``).

    ``log_likelihood(frame, index) == log_probs[frame - offset, index - 1]``
    (`decodable-ctc.cc:22-29`).
    """

    def __init__(self, log_probs: np.ndarray, offset: int = 0):
        log_probs = np.ascontiguousarray(log_probs, dtype=np.float32)
        if log_probs.ndim != 2:
            raise ValueError(
                f"DecodableCtc expects a 2-D (T, V) matrix, got {log_probs.shape}"
            )
        self._log_probs = log_probs
        self._offset = int(offset)

    def log_likelihood(self, frame: int, index: int) -> float:
        assert index >= 1, "indices are 1-based (decodable-ctc.cc:26)"
        return float(self._log_probs[frame - self._offset, index - 1])

    def num_frames_ready(self) -> int:
        return self._offset + self._log_probs.shape[0]

    def num_indices(self) -> int:
        return self._log_probs.shape[1]

    def is_last_frame(self, frame: int) -> bool:
        assert frame < self.num_frames_ready()
        return frame == self.num_frames_ready() - 1

    def score_matrix(self) -> np.ndarray:
        return self._log_probs

    def frame_offset(self) -> int:
        return self._offset


# Alias: any dense (T, V) log-prob matrix, CTC or otherwise.
DecodableMatrix = DecodableCtc


def scores_from_decodable(
    decodable: DecodableInterface,
    start_frame: int,
    end_frame: int,
    num_indices: Optional[int] = None,
) -> np.ndarray:
    """Materialize ``[start_frame, end_frame)`` of a decodable as a dense
    float32 matrix of log-likelihoods, using the fast path when available.

    This is the bridge that keeps Python-defined decodables (the trampoline
    API surface, `python/csrc/decodable-itf.cc:16-53`) usable with the
    array-based device decoders.
    """
    sm = decodable.score_matrix()
    if sm is not None:
        off = decodable.frame_offset()
        lo, hi = start_frame - off, end_frame - off
        if lo < 0 or hi > sm.shape[0]:
            raise ValueError(
                f"frames [{start_frame}, {end_frame}) not covered by score "
                f"matrix (offset={off}, rows={sm.shape[0]})"
            )
        return sm[lo:hi]
    V = num_indices if num_indices is not None else decodable.num_indices()
    T = end_frame - start_frame
    out = np.empty((T, V), dtype=np.float32)
    for t in range(T):
        frame = start_frame + t
        for i in range(V):
            out[t, i] = decodable.log_likelihood(frame, i + 1)
    return out
