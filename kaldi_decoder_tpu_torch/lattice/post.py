"""Lattice post-processing: n-best, determinization, scaling, rescoring.

A jax-free copy of ``kaldi_decoder_tpu/lattice/post.py`` (all of it,
lines 22-477), kept because importing the original imports jax;
``tests/test_torch_post.py`` holds the copy equal to the original.

* :func:`nbest` — best-first path enumeration over the lattice DAG using
  exact cost-to-go lower bounds (``fst::ShortestPath`` with n > 1 in the
  lattice semiring).
* :func:`determinize_lattice` — the best-scoring path of each word
  sequence, as a deterministic word lattice (the reference's
  ``determinize_lattice`` flag, `lattice-simple-decoder.h:57-60`).
* :func:`scale_lattice` — (graph, acoustic) scaling with Kaldi's scale
  matrix [[lm_scale, 0], [0, acoustic_scale]].
* :func:`rescore_lattice_with_lm` — graph costs replaced or interpolated
  from an external word-level LM callback.

Lattices here are decoder outputs: acyclic and of modest size, so host
Python is the right tool.
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kaldi_decoder_tpu_torch.fst.fst import EPSILON, INF, Lattice
from kaldi_decoder_tpu_torch.fst.ops import topological_order

Path = Tuple[Tuple[int, ...], Tuple[int, ...], float, float]
# (ilabels, olabels, graph_cost, ac_cost) — eps labels excluded from tuples


def _beta(lat: Lattice) -> List[float]:
    """Exact cost-to-final per state (DAG backward DP)."""
    order = topological_order(lat)
    if order is None:
        raise ValueError("lattice must be acyclic")
    beta = [INF] * lat.num_states
    for s in reversed(order):
        if lat.is_final(s):
            fw = lat.final(s)
            beta[s] = fw[0] + fw[1]
        for arc in lat.arcs(s):
            c = arc.weight[0] + arc.weight[1] + beta[arc.nextstate]
            if c < beta[s]:
                beta[s] = c
    return beta


def nbest(
    lat: Lattice,
    n: int,
    unique_word_sequences: bool = False,
    max_expansions: int = 1_000_000,
) -> List[Path]:
    """Up to ``n`` cheapest complete paths, cheapest first.

    A* over partial paths with the exact remaining cost as heuristic, so
    paths pop in true cost order.  With ``unique_word_sequences`` paths
    whose (eps-free) olabel sequence was already produced are skipped —
    poor man's determinization.
    """
    if lat.start < 0 or n <= 0:
        return []
    beta = _beta(lat)
    if beta[lat.start] == INF:
        return []
    counter = itertools.count()
    # (priority, tiebreak, state, g_graph, g_ac, ilabels, olabels).
    # state == -1 marks a *completion event*: finishing at a final state is
    # queued at its exact total cost rather than emitted when the state
    # pops — a final state's pop priority uses beta (which may prefer
    # continuing), so eager emission could record a non-minimal path for a
    # word sequence and mis-order the output.
    heap = [(beta[lat.start], next(counter), lat.start, 0.0, 0.0, (), ())]
    out: List[Path] = []
    seen_words = set()
    expansions = 0
    while heap and len(out) < n and expansions < max_expansions:
        prio, _, s, gg, ga, ils, ols = heapq.heappop(heap)
        expansions += 1
        if s == -1:
            if not unique_word_sequences or ols not in seen_words:
                seen_words.add(ols)
                out.append((ils, ols, gg, ga))
            continue
        if lat.is_final(s):
            fw = lat.final(s)
            heapq.heappush(
                heap,
                (
                    gg + fw[0] + ga + fw[1],
                    next(counter),
                    -1,
                    gg + fw[0],
                    ga + fw[1],
                    ils,
                    ols,
                ),
            )
        for arc in lat.arcs(s):
            w = arc.weight
            ng, na = gg + w[0], ga + w[1]
            nb = beta[arc.nextstate]
            if nb == INF:
                continue
            heapq.heappush(
                heap,
                (
                    ng + na + nb,
                    next(counter),
                    arc.nextstate,
                    ng,
                    na,
                    ils + ((arc.ilabel,) if arc.ilabel != EPSILON else ()),
                    ols + ((arc.olabel,) if arc.olabel != EPSILON else ()),
                ),
            )
    return out


def paths_to_fst(paths: Sequence[Path]) -> Lattice:
    """Build a prefix-tree lattice from explicit paths (deterministic in
    olabels; weights pushed to the first divergent arc's tail)."""
    lat = Lattice()
    root = lat.add_state()
    lat.set_start(root)
    # Simple prefix tree on olabel sequences; each path's full weight goes
    # on its final state to keep label-determinism trivial.
    children: Dict[Tuple[int, int], int] = {}
    for ils, ols, g, a in paths:
        cur = root
        for lab in ols:
            key = (cur, lab)
            if key not in children:
                nxt = lat.add_state()
                lat.add_arc(cur, lab, lab, (0.0, 0.0), nxt)
                children[key] = nxt
            cur = children[key]
        # Parallel word sequences that are prefixes of each other share a
        # final state only if identical; set/min the final weight.
        if lat.is_final(cur):
            old = lat.final(cur)
            if old[0] + old[1] <= g + a:
                continue
        lat.set_final(cur, (g, a))
    return lat


class DeterminizedAlignments:
    """Token alignments carried through determinization.

    ``arcs[(state, arc_index)]`` is the ilabel string extracted on that
    arc (the longest common prefix of the subset's residual strings —
    Kaldi's left-string-semiring common divisor); ``finals[state]`` is
    the best final element's residual string.  The exact alignment of a
    word-sequence path = concatenation of its arcs' strings + the final
    string (see :func:`alignment_of`)."""

    def __init__(self):
        self.arcs: Dict[Tuple[int, int], Tuple[int, ...]] = {}
        self.finals: Dict[int, Tuple[int, ...]] = {}


def alignment_of(
    det: Lattice, aligns: DeterminizedAlignments, words: Sequence[int]
) -> Optional[Tuple[int, ...]]:
    """Exact token alignment of ``words`` in a determinized lattice.

    Walks the deterministic lattice (at most one arc per word per state)
    concatenating arc strings, then appends the final state's residual.
    Returns None when the word sequence is not in the lattice.  This is
    the DeterminizeLatticePruned capability: alignment recovery without
    re-enumerating the raw lattice (`lattice-simple-decoder.h:57-60`)."""
    if det.start < 0:
        return None
    s = det.start
    out: Tuple[int, ...] = ()
    for w in words:
        hit = None
        for i, arc in enumerate(det.arcs(s)):
            if arc.olabel == w:
                hit = (i, arc)
                break
        if hit is None:
            return None
        out += aligns.arcs.get((s, hit[0]), ())
        s = hit[1].nextstate
    if not det.is_final(s):
        return None
    return out + aligns.finals.get(s, ())


def determinize_lattice(
    lat: Lattice,
    beam: Optional[float] = None,
    max_states: int = 1_000_000,
    with_alignments: bool = False,
):
    """Exact weighted determinization over word sequences
    (DeterminizeLatticePruned semantics: the reference's
    ``determinize_lattice`` flag, `lattice-simple-decoder.h:57-60`).

    Output: a *deterministic* word-level lattice — from any state, at most
    one out-arc per word — containing **every** word sequence of the input
    with its exact minimal (graph, acoustic) cost, built by weighted
    subset construction over the olabel projection.  With ``beam``, paths
    worse than ``best + beam`` are pruned *during* construction using
    exact cost-to-final lower bounds (the "Pruned" in
    DeterminizeLatticePruned), which is what keeps worst-case blowup away
    on decoder output lattices.

    ``with_alignments=True`` additionally carries the input-label (token)
    strings through the subset construction in the (weight x left-string)
    semiring Kaldi's DeterminizeLatticePruned uses: each subset element
    holds its residual ilabel string, each word arc extracts the longest
    common prefix, and final states keep the best final element's
    residual.  Returns ``(Lattice, DeterminizedAlignments)``; the exact
    token alignment of ANY word sequence in the lattice is the
    concatenation of its arcs' strings plus the final state's string —
    no re-enumeration of the raw lattice needed.  (Note: keying subsets
    on residual strings can split states the weight-only construction
    merges, exactly as in Kaldi.)

    Weight pairs (g, a) compare by ``g + a`` (LatticeWeight order); the
    minimal pair is extracted onto arcs, residuals stay in subset
    elements, rounded to 1e-6 for subset hashing.
    """
    empty = (Lattice(), DeterminizedAlignments()) if with_alignments else Lattice()
    if lat.start < 0:
        return empty
    beta = _beta(lat)
    if beta[lat.start] == INF:
        return empty
    limit = INF if beam is None else beta[lat.start] + beam + 1e-9

    # Element value: (g, a) or (g, a, ilabels-tuple) with alignments.
    def closure(elems: Dict[int, tuple], alpha: float):
        """Relax word-eps arcs (olabel == 0) to a fixed point; prune
        elements that cannot reach a final state within the beam.
        Word-eps arcs may still carry ilabels (token arcs that emit no
        word); those extend the element strings."""
        work = list(elems.items())
        out = dict(elems)
        while work:
            s, val = work.pop()
            g, a = val[0], val[1]
            for arc in lat.arcs(s):
                if arc.olabel != EPSILON:
                    continue
                ng, na = g + arc.weight[0], a + arc.weight[1]
                if alpha + ng + na + beta[arc.nextstate] > limit:
                    continue
                cur = out.get(arc.nextstate)
                if cur is None or ng + na < cur[0] + cur[1]:
                    if with_alignments:
                        ns = val[2] + (
                            (arc.ilabel,) if arc.ilabel != EPSILON else ()
                        )
                        nv = (ng, na, ns)
                    else:
                        nv = (ng, na)
                    out[arc.nextstate] = nv
                    work.append((arc.nextstate, nv))
        return {
            s: v
            for s, v in out.items()
            if alpha + v[0] + v[1] + beta[s] <= limit
        }

    def lcp(strings):
        first = min(strings, key=len)
        n = len(first)
        for s in strings:
            i = 0
            m = min(n, len(s))
            while i < m and s[i] == first[i]:
                i += 1
            n = i
            if n == 0:
                break
        return first[:n]

    def normalize(elems: Dict[int, tuple]):
        """Extract the minimal weight pair (and the LCP string with
        alignments); key the residual subset."""
        mng, mna = min(
            ((v[0], v[1]) for v in elems.values()),
            key=lambda w: w[0] + w[1],
        )
        if with_alignments:
            common = lcp([v[2] for v in elems.values()])
            cn = len(common)
            resid = {
                s: (g - mng, a - mna, st[cn:])
                for s, (g, a, st) in elems.items()
            }
            key = frozenset(
                (s, round(g, 6), round(a, 6), st)
                for s, (g, a, st) in resid.items()
            )
            return key, (mng, mna), common, resid
        resid = {s: (v[0] - mng, v[1] - mna) for s, v in elems.items()}
        key = frozenset(
            (s, round(v[0], 6), round(v[1], 6)) for s, v in resid.items()
        )
        return key, (mng, mna), (), resid

    out = Lattice()
    aligns = DeterminizedAlignments()
    zero = (0.0, 0.0, ()) if with_alignments else (0.0, 0.0)
    start_elems = closure({lat.start: zero}, 0.0)
    if not start_elems:
        return empty
    # No weight extraction at the start subset (a Lattice has no initial
    # weight); its residuals are absolute. lat.start has residual (0, 0)
    # so they are already normalized in the usual case.
    key0 = frozenset(
        ((s,) + tuple(round(x, 6) for x in v[:2]) + ((v[2],) if with_alignments else ()))
        for s, v in start_elems.items()
    )
    ids: Dict[frozenset, int] = {key0: out.add_state()}
    out.set_start(ids[key0])
    info = {ids[key0]: (start_elems, 0.0)}
    # Best-first (Dijkstra) order over det states by alpha — the cheapest
    # accumulated extraction to reach the subset.  Arc extractions are
    # nonnegative, so the first pop settles the true minimal alpha; this
    # matters for beam pruning: a subset reachable along two det paths
    # must be pruned against its *cheapest* alpha, not its first-seen one.
    queue = [(0.0, ids[key0])]
    done = set()
    while queue:
        alpha, sid = heapq.heappop(queue)
        if sid in done:
            continue
        done.add(sid)
        resid, alpha = info[sid]
        # Final weight: min over final elements (its residual string is
        # the alignment tail after the last word).
        fg, fa = INF, INF
        fstr = ()
        for s, v in resid.items():
            if lat.is_final(s):
                wg, wa = lat.final(s)
                if v[0] + wg + v[1] + wa < fg + fa:
                    fg, fa = v[0] + wg, v[1] + wa
                    if with_alignments:
                        fstr = v[2]
        if fg + fa < INF:
            out.set_final(sid, (fg, fa))
            if with_alignments:
                aligns.finals[sid] = fstr
        # Group outgoing word arcs.
        by_word: Dict[int, Dict[int, tuple]] = {}
        for s, v in resid.items():
            g, a = v[0], v[1]
            for arc in lat.arcs(s):
                if arc.olabel == EPSILON:
                    continue
                ng, na = g + arc.weight[0], a + arc.weight[1]
                if alpha + ng + na + beta[arc.nextstate] > limit:
                    continue
                d = by_word.setdefault(arc.olabel, {})
                cur = d.get(arc.nextstate)
                if cur is None or ng + na < cur[0] + cur[1]:
                    if with_alignments:
                        ns = v[2] + (
                            (arc.ilabel,) if arc.ilabel != EPSILON else ()
                        )
                        d[arc.nextstate] = (ng, na, ns)
                    else:
                        d[arc.nextstate] = (ng, na)
        for w, elems in sorted(by_word.items()):
            elems = closure(elems, alpha)
            if not elems:
                continue
            key, (wg, wa), common, resid_n = normalize(elems)
            child_alpha = alpha + wg + wa
            if key not in ids:
                if len(ids) >= max_states:
                    raise RuntimeError(
                        f"determinize_lattice exceeded {max_states} states; "
                        "pass a (smaller) beam"
                    )
                ids[key] = out.add_state()
                info[ids[key]] = (resid_n, child_alpha)
                heapq.heappush(queue, (child_alpha, ids[key]))
            elif child_alpha < info[ids[key]][1] and ids[key] not in done:
                # Cheaper det path to the same subset: lazy decrease-key.
                info[ids[key]] = (resid_n, child_alpha)
                heapq.heappush(queue, (child_alpha, ids[key]))
            if with_alignments:
                aligns.arcs[(sid, out.num_arcs(sid))] = common
            out.add_arc(sid, w, w, (wg, wa), ids[key])
    if with_alignments:
        return out, aligns
    return out


def scale_lattice(
    lat: Lattice, acoustic_scale: float = 1.0, lm_scale: float = 1.0
) -> Lattice:
    """Scale (graph, acoustic) weights (Kaldi's ScaleLattice with the
    diagonal scale matrix [[lm_scale, 0], [0, acoustic_scale]])."""
    out = Lattice()
    out.add_states(lat.num_states)
    for s in range(lat.num_states):
        if lat.is_final(s):
            g, a = lat.final(s)
            out.set_final(s, (g * lm_scale, a * acoustic_scale))
        for arc in lat.arcs(s):
            g, a = arc.weight
            out.add_arc(
                s, arc.ilabel, arc.olabel,
                (g * lm_scale, a * acoustic_scale), arc.nextstate,
            )
    if lat.start >= 0:
        out.set_start(lat.start)
    return out


def rescore_lattice_with_lm(
    lat: Lattice,
    lm_cost_fn: Callable[[Tuple[int, ...], int], float],
    lm_scale: float = 1.0,
    old_lm_scale: float = 0.0,
) -> Lattice:
    """LM rescoring hook: add ``lm_scale * lm_cost_fn(history, word)`` to
    each word arc's graph cost (optionally keeping ``old_lm_scale`` of the
    original graph cost on word arcs).

    ``lm_cost_fn(history_words, word) -> cost`` is any callable — e.g. an
    n-gram lookup or a neural LM scored on host.  States are visited with
    their lattice-topological word history; because a lattice state can be
    reached with different histories, states are split per history
    (standard lattice-rescoring expansion).
    """
    if lat.start < 0:
        return Lattice()
    out = Lattice()
    # (state, history) -> new state id; BFS expansion.
    idx: Dict[Tuple[int, Tuple[int, ...]], int] = {}

    def get(state: int, hist: Tuple[int, ...]) -> int:
        key = (state, hist)
        if key not in idx:
            idx[key] = out.add_state()
            if lat.is_final(state):
                out.set_final(idx[key], lat.final(state))
        return idx[key]

    start = get(lat.start, ())
    out.set_start(start)
    stack = [(lat.start, ())]
    visited = set()
    while stack:
        state, hist = stack.pop()
        if (state, hist) in visited:
            continue
        visited.add((state, hist))
        src = get(state, hist)
        for arc in lat.arcs(state):
            g, a = arc.weight
            if arc.olabel != EPSILON:
                lm_cost = lm_cost_fn(hist, arc.olabel)
                g = old_lm_scale * g + lm_scale * lm_cost
                nhist = hist + (arc.olabel,)
            else:
                nhist = hist
            dst = get(arc.nextstate, nhist)
            out.add_arc(src, arc.ilabel, arc.olabel, (g, a), dst)
            if (arc.nextstate, nhist) not in visited:
                stack.append((arc.nextstate, nhist))
    return out
