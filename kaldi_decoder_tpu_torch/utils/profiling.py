"""Tracing and profiling hooks in torch.

The port of ``kaldi_decoder_tpu/utils/profiling.py``:

* :func:`trace` — a context manager around :class:`torch.profiler.profile`
  (host and, on a card, device activity) that writes a Chrome trace,
  ``trace.json``, into ``logdir`` (open it in Perfetto or
  ``chrome://tracing``);
* :func:`annotate` — a named range for each decode call
  (:func:`torch.profiler.record_function`, and an NVTX range when the
  decode runs on a CUDA device);
* :class:`WallTimer`.

The port's decodes are wrapped where the original's are:
``BatchedViterbiDecoder.decode``, ``BatchedLatticeDecoder.decode_async``
and the streaming lattice decoders' ``advance_decoding``.  A profiler
that cannot start degrades to a warning, so a decode never fails on a
profiling feature.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profiler trace of everything inside the block and write
    it to ``logdir/trace.json``.

    Usage::

        with profiling.trace("kdtpu-trace"):
            result = decoder.decode(scores)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:  # another profiler is running, or no backend
        logger.warning("torch.profiler trace unavailable: %s", e)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(logdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str, step: int = 0, device=None):
    """A named range ``name[step]`` for the trace: a profiler record and,
    on a CUDA ``device``, an NVTX range."""
    label = f"{name}[{step}]"
    with torch.profiler.record_function(label):
        if device is not None and torch.device(device).type == "cuda":
            with torch.cuda.nvtx.range(label):
                yield
        else:
            yield


class WallTimer:
    """Wall-clock timer; ``elapsed`` is valid after the block exits.

    The caller synchronizes with the device inside the block (a download
    of an output does).
    """

    def __enter__(self):
        self.elapsed = 0.0
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
