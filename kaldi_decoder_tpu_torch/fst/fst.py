"""Host-side weighted FST objects (the FST types the 1-best is returned in).

A jax-free copy of ``kaldi_decoder_tpu/fst/fst.py`` (``TropicalWeight``,
``LatticeWeight``, ``Arc``, ``LatticeArc``, ``VectorFst``,
``StdVectorFst``, ``Lattice``), kept because importing the original
imports jax.  ``tests/test_torch_viterbi.py`` holds the copy equal to the
original.

Two semirings, as in the reference: ``TropicalWeight`` (``fst::StdArc``,
plus = min, times = +) and ``LatticeWeight``, a ``(graph_cost,
acoustic_cost)`` pair compared by its sum with a tie-break on
``graph_cost`` (kaldifst ``lattice-weight.h``).  Arcs are stored
struct-of-arrays per state.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

INF = float("inf")

# Label value used for epsilon, as in OpenFst.
EPSILON = 0

# Sentinel for "no state" (fst::kNoStateId).
NO_STATE = -1


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


class TropicalWeight:
    """Utility namespace for the tropical (min, +) semiring over floats."""

    @staticmethod
    def zero() -> float:
        return INF

    @staticmethod
    def one() -> float:
        return 0.0

    @staticmethod
    def plus(a: float, b: float) -> float:
        return min(a, b)

    @staticmethod
    def times(a: float, b: float) -> float:
        return a + b


class LatticeWeight:
    """(graph_cost, acoustic_cost) pair semiring (kaldifst lattice-weight.h).

    Total order: compare by value1+value2, ties broken by value1 (graph cost),
    exactly like kaldifst's ``Compare(LatticeWeight, LatticeWeight)``.
    """

    @staticmethod
    def zero() -> Tuple[float, float]:
        return (INF, INF)

    @staticmethod
    def one() -> Tuple[float, float]:
        return (0.0, 0.0)

    @staticmethod
    def total(w: Tuple[float, float]) -> float:
        return w[0] + w[1]

    @staticmethod
    def plus(a: Tuple[float, float], b: Tuple[float, float]) -> Tuple[float, float]:
        # Kaldi's lattice-weight.h Compare: smaller total cost compares
        # "larger" (better); on equal totals it tests
        # ``w1.v1 + w2.v2 < w2.v1 + w1.v2`` — i.e. the weight with the
        # SMALLER value1 (graph cost) compares larger.  Plus returns w1
        # when Compare(w1, w2) >= 0, so on a full tie the first argument
        # wins.  (fstext/lattice-weight.h, vendored by kaldifst; used via
        # `faster-decoder.h:20`.)
        ta, tb = a[0] + a[1], b[0] + b[1]
        if ta < tb:
            return a
        if tb < ta:
            return b
        return a if a[0] <= b[0] else b

    @staticmethod
    def times(a: Tuple[float, float], b: Tuple[float, float]) -> Tuple[float, float]:
        return (a[0] + b[0], a[1] + b[1])


# ---------------------------------------------------------------------------
# Arc containers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Arc:
    """A single arc (view object; storage is struct-of-arrays)."""

    ilabel: int
    olabel: int
    weight: float  # tropical
    nextstate: int


@dataclasses.dataclass
class LatticeArc:
    ilabel: int
    olabel: int
    weight: Tuple[float, float]  # (graph_cost, acoustic_cost)
    nextstate: int


class _StateArcs:
    """Growable struct-of-arrays arc storage for one state."""

    __slots__ = ("ilabels", "olabels", "weights", "nextstates")

    def __init__(self, weight_dim: int):
        self.ilabels: List[int] = []
        self.olabels: List[int] = []
        # weight_dim==1: list of float; weight_dim==2: list of (g, a) tuples
        self.weights: List = []
        self.nextstates: List[int] = []

    def __len__(self) -> int:
        return len(self.ilabels)


# ---------------------------------------------------------------------------
# VectorFst
# ---------------------------------------------------------------------------


class VectorFst:
    """Mutable FST over the tropical or lattice semiring.

    API intentionally close to ``fst::VectorFst`` (the subset the reference
    exercises: `Start/Final/AddState/AddArc/SetStart/SetFinal/NumStates/
    ArcIterator` — see `simple-decoder.cc:104-148`), with pythonic naming.
    """

    #: "standard" (tropical float) or "lattice" ((graph, acoustic) pair)
    arc_type = "standard"
    _weight_dim = 1

    def __init__(self):
        self._start: int = NO_STATE
        self._finals: List[object] = []  # per-state final weight (zero() = not final)
        self._arcs: List[_StateArcs] = []

    # -- semiring helpers ---------------------------------------------------

    @classmethod
    def weight_zero(cls):
        return INF if cls._weight_dim == 1 else (INF, INF)

    @classmethod
    def weight_one(cls):
        return 0.0 if cls._weight_dim == 1 else (0.0, 0.0)

    # -- construction -------------------------------------------------------

    def add_state(self) -> int:
        self._finals.append(self.weight_zero())
        self._arcs.append(_StateArcs(self._weight_dim))
        return len(self._arcs) - 1

    def add_states(self, n: int) -> None:
        for _ in range(n):
            self.add_state()

    def set_start(self, state: int) -> None:
        self._start = state

    def _quantize(self, weight):
        # Weights are single-precision on disk and on device (fst::StdArc /
        # LatticeWeight are float); quantize at insertion so equality and
        # IO roundtrips are exact.
        if self._weight_dim == 1:
            return float(np.float32(weight))
        return (float(np.float32(weight[0])), float(np.float32(weight[1])))

    def set_final(self, state: int, weight=None) -> None:
        if weight is None:
            weight = self.weight_one()
        self._finals[state] = self._quantize(weight)

    def add_arc(self, state: int, ilabel: int, olabel: int, weight, nextstate: int) -> None:
        sa = self._arcs[state]
        sa.ilabels.append(int(ilabel))
        sa.olabels.append(int(olabel))
        sa.weights.append(self._quantize(weight))
        sa.nextstates.append(int(nextstate))

    def reserve_states(self, n: int) -> None:  # parity no-op
        pass

    def delete_states(self) -> None:
        self._start = NO_STATE
        self._finals = []
        self._arcs = []

    # -- queries ------------------------------------------------------------

    @property
    def start(self) -> int:
        return self._start

    def final(self, state: int):
        """Final weight of ``state`` (``weight_zero()`` if not final)."""
        return self._finals[state]

    def is_final(self, state: int) -> bool:
        return self._finals[state] != self.weight_zero()

    @property
    def num_states(self) -> int:
        return len(self._arcs)

    def num_arcs(self, state: int) -> int:
        return len(self._arcs[state])

    @property
    def total_num_arcs(self) -> int:
        return sum(len(a) for a in self._arcs)

    def num_input_epsilons(self, state: int) -> int:
        """# arcs with ilabel==0 (``fst::NumInputEpsilons``,
        used at `lattice-simple-decoder.cc:139`)."""
        return sum(1 for il in self._arcs[state].ilabels if il == EPSILON)

    def arcs(self, state: int) -> Iterator:
        """Iterate arcs of ``state`` (the ``fst::ArcIterator`` analogue)."""
        sa = self._arcs[state]
        if self._weight_dim == 1:
            for i in range(len(sa)):
                yield Arc(sa.ilabels[i], sa.olabels[i], sa.weights[i], sa.nextstates[i])
        else:
            for i in range(len(sa)):
                yield LatticeArc(
                    sa.ilabels[i], sa.olabels[i], sa.weights[i], sa.nextstates[i]
                )

    def state_arc_arrays(self, state: int):
        """Raw struct-of-arrays access (ilabels, olabels, weights, nextstates)."""
        sa = self._arcs[state]
        return sa.ilabels, sa.olabels, sa.weights, sa.nextstates

    # -- conversion ---------------------------------------------------------

    def to_arrays(self):
        """Flatten to CSR-style numpy arrays.

        Returns dict with ``row_ptr`` (S+1,), ``ilabel``/``olabel``/
        ``nextstate`` (E,), ``weight`` (E,) or (E,2), ``final`` (S,) or (S,2),
        ``start``.
        """
        S = self.num_states
        degrees = np.array([len(a) for a in self._arcs], dtype=np.int64)
        row_ptr = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(degrees, out=row_ptr[1:])
        E = int(row_ptr[-1])
        ilabel = np.empty(E, dtype=np.int32)
        olabel = np.empty(E, dtype=np.int32)
        nextstate = np.empty(E, dtype=np.int32)
        if self._weight_dim == 1:
            weight = np.empty(E, dtype=np.float32)
        else:
            weight = np.empty((E, 2), dtype=np.float32)
        for s in range(S):
            sa = self._arcs[s]
            if not sa.ilabels:
                continue
            lo, hi = row_ptr[s], row_ptr[s + 1]
            ilabel[lo:hi] = sa.ilabels
            olabel[lo:hi] = sa.olabels
            nextstate[lo:hi] = sa.nextstates
            weight[lo:hi] = sa.weights
        if self._weight_dim == 1:
            final = np.array(self._finals, dtype=np.float32)
        else:
            final = np.array(
                [list(f) for f in self._finals] if S else np.zeros((0, 2)),
                dtype=np.float32,
            ).reshape(S, 2)
        return {
            "row_ptr": row_ptr,
            "ilabel": ilabel,
            "olabel": olabel,
            "nextstate": nextstate,
            "weight": weight,
            "final": final,
            "start": self._start,
        }

    @classmethod
    def from_arrays(cls, row_ptr, ilabel, olabel, weight, nextstate, final, start):
        """Inverse of :meth:`to_arrays`."""
        fst = cls()
        S = len(final)
        fst.add_states(S)
        weight = np.asarray(weight)
        for s in range(S):
            lo, hi = int(row_ptr[s]), int(row_ptr[s + 1])
            sa = fst._arcs[s]
            sa.ilabels = [int(x) for x in ilabel[lo:hi]]
            sa.olabels = [int(x) for x in olabel[lo:hi]]
            sa.nextstates = [int(x) for x in nextstate[lo:hi]]
            if cls._weight_dim == 1:
                sa.weights = [float(x) for x in weight[lo:hi]]
            else:
                sa.weights = [(float(g), float(a)) for g, a in weight[lo:hi]]
        final = np.asarray(final)
        for s in range(S):
            if cls._weight_dim == 1:
                f = float(final[s])
                if f != INF:
                    fst.set_final(s, f)
            else:
                g, a = float(final[s][0]), float(final[s][1])
                if g != INF or a != INF:
                    fst.set_final(s, (g, a))
        fst.set_start(int(start))
        return fst

    # -- misc ---------------------------------------------------------------

    def __eq__(self, other) -> bool:
        if not isinstance(other, VectorFst) or self.arc_type != other.arc_type:
            return NotImplemented
        if self._start != other._start or self.num_states != other.num_states:
            return False
        if self._finals != other._finals:
            return False
        for s in range(self.num_states):
            a, b = self._arcs[s], other._arcs[s]
            if (
                a.ilabels != b.ilabels
                or a.olabels != b.olabels
                or a.weights != b.weights
                or a.nextstates != b.nextstates
            ):
                return False
        return True

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(states={self.num_states}, "
            f"arcs={self.total_num_arcs}, start={self._start})"
        )


class StdVectorFst(VectorFst):
    """Tropical-weight FST (``fst::StdVectorFst``)."""

    arc_type = "standard"
    _weight_dim = 1


class Lattice(VectorFst):
    """FST over the (graph_cost, acoustic_cost) lattice semiring
    (``fst::Lattice`` == ``fst::VectorFst<fst::LatticeArc>``)."""

    arc_type = "lattice"
    _weight_dim = 2

    def arc_total_weight(self, w: Tuple[float, float]) -> float:
        return w[0] + w[1]
