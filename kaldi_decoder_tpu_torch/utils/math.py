"""Small math helpers.

A jax-free copy of ``kaldi_decoder_tpu/utils/math.py`` (``approx_equal``,
``approx_equal_array``): the reference's relative-tolerance float
comparison (`kaldi-decoder/csrc/kaldi-math.h:36-44`), used by the
final-frame lattice link pruning (`lattice-simple-decoder.cc:512`).
"""

from __future__ import annotations

import math

INF = float("inf")


def approx_equal(a: float, b: float, relative_tolerance: float = 0.001) -> bool:
    """Relative-tolerance comparison matching kaldi-math.h:36-44.

    ``a == b`` if ``|a - b| <= relative_tolerance * (|a| + |b|)``.
    """
    if a == b:
        return True
    if math.isinf(a) or math.isinf(b) or a != a or b != b:
        return False
    return abs(a - b) <= relative_tolerance * (abs(a) + abs(b))


def approx_equal_array(a, b, relative_tolerance: float = 0.001):
    """Vectorized ``approx_equal`` over numpy arrays (elementwise bool).

    Exact equality (including inf == inf) passes; any NaN or one-sided inf
    fails; otherwise the kaldi-math.h:36-44 relative test applies.
    """
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    exact = a == b
    finite = np.isfinite(a) & np.isfinite(b)
    # Only subtract where both operands are finite: inf - inf would emit a
    # RuntimeWarning (nan) even though the mask discards the result.
    diff = np.subtract(a, b, out=np.zeros_like(a), where=finite)
    rel = np.abs(diff) <= relative_tolerance * (np.abs(a) + np.abs(b))
    return exact | (finite & rel)
