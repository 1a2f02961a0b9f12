"""Logging and per-utterance decode statistics.

A jax-free copy of ``get_logger`` and ``DecodeStats`` from
``kaldi_decoder_tpu/utils/logging.py``: the package's logger (the parent
of its modules' ``logging.getLogger(__name__)``, so named after this
package), and the reference's log lines and soft failure signals
(`lattice-simple-decoder.cc:146-153`, `simple-decoder.cc:78-100`) as
structured per-utterance data.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np

_LOGGER_NAME = "kaldi_decoder_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


@dataclasses.dataclass
class DecodeStats:
    """Per-utterance statistics from a device decode.

    Mirrors the information the reference exposes through log lines and
    soft failure signals (`lattice-simple-decoder.cc:146-153`,
    `simple-decoder.cc:78-100`), but as structured data.
    """

    num_frames: int = 0
    # Number of active (valid) frontier slots after each frame's pruning.
    active_per_frame: Optional[np.ndarray] = None
    # Best (lowest) total cost per frame.
    best_cost_per_frame: Optional[np.ndarray] = None
    # Beam cutoff actually applied per frame (absolute cost).
    cutoff_per_frame: Optional[np.ndarray] = None
    # Number of frames where the candidate arc budget overflowed and
    # candidates had to be dropped (0 == exact search within the beam).
    arc_budget_overflows: int = 0
    # Number of frames where more distinct states fit the beam than the
    # frontier has slots — the decoder silently behaved as if
    # max_active == frontier_size on those frames, a capacity divergence
    # from the reference's unbounded token stores.  Raise frontier_size
    # (or lower beam/max_active) if this is nonzero on a beam-only decode.
    frontier_saturated_frames: int = 0
    # Wall-clock seconds of the device decode that produced this result,
    # covering the whole batch it was part of (0.0 == not measured).
    wall_seconds: float = 0.0
    # Total frames decoded across that batch (>= num_frames when batched).
    batch_frames: int = 0

    @property
    def frames_per_second(self) -> float:
        """Batch decode throughput in frames/s (0.0 if unmeasured)."""
        if self.wall_seconds <= 0.0:
            return 0.0
        return (self.batch_frames or self.num_frames) / self.wall_seconds

    def audio_seconds_per_second(self, frame_seconds: float) -> float:
        """Real-time factor given the acoustic frame rate (e.g. 0.04 for
        conformer subsampling-4): audio seconds decoded per wall second."""
        return self.frames_per_second * float(frame_seconds)

    def summary(self) -> str:
        if self.active_per_frame is None or self.num_frames == 0:
            return "DecodeStats(empty)"
        act = np.asarray(self.active_per_frame)[: self.num_frames]
        fps = self.frames_per_second
        # Throughput is batch-level (batch_frames / wall_seconds), not this
        # single utterance's rate — label it as such.
        perf = (
            f", batch_frames/s={fps:.0f} ({self.batch_frames} frames)"
            if fps
            else ""
        )
        return (
            f"DecodeStats(frames={self.num_frames}, "
            f"mean_active={float(act.mean()):.1f}, "
            f"max_active={int(act.max())}, "
            f"overflows={self.arc_budget_overflows}, "
            f"saturated={self.frontier_saturated_frames}{perf})"
        )
