"""Host FST algorithms applied to best paths.

A jax-free copy of the parts of ``kaldi_decoder_tpu/fst/ops.py`` that the
1-best and lattice results need: ``connect``, ``topological_order``,
``remove_eps_local`` (the ``fst::RemoveEpsLocal`` cleanup of best paths,
`kaldi-decoder/csrc/faster-decoder.cc:422`), ``shortest_path``
(``fst::ShortestPath`` over lattices, `lattice-simple-decoder.cc:578`),
``path_labels`` and ``path_total_cost``.  ``tests/test_torch_viterbi.py``
and ``tests/test_torch_host.py`` hold the copy equal to the original.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from kaldi_decoder_tpu_torch.fst.fst import EPSILON, INF, VectorFst


def connect(fst: VectorFst) -> VectorFst:
    """Return a trimmed copy: only states both accessible from the start and
    co-accessible to a final state survive (``fst::Connect``)."""
    S = fst.num_states
    cls = type(fst)
    if S == 0 or fst.start < 0:
        return cls()

    # Forward reachability.
    fwd = [False] * S
    stack = [fst.start]
    fwd[fst.start] = True
    while stack:
        s = stack.pop()
        for arc in fst.arcs(s):
            if not fwd[arc.nextstate]:
                fwd[arc.nextstate] = True
                stack.append(arc.nextstate)

    # Backward reachability over reversed arcs.
    rev: List[List[int]] = [[] for _ in range(S)]
    for s in range(S):
        if not fwd[s]:
            continue
        for arc in fst.arcs(s):
            rev[arc.nextstate].append(s)
    bwd = [False] * S
    stack = [s for s in range(S) if fwd[s] and fst.is_final(s)]
    for s in stack:
        bwd[s] = True
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if not bwd[p]:
                bwd[p] = True
                stack.append(p)

    keep = [s for s in range(S) if fwd[s] and bwd[s]]
    new_id = {s: i for i, s in enumerate(keep)}
    out = cls()
    out.add_states(len(keep))
    for s in keep:
        ns = new_id[s]
        if fst.is_final(s):
            out.set_final(ns, fst.final(s))
        for arc in fst.arcs(s):
            if arc.nextstate in new_id:
                out.add_arc(ns, arc.ilabel, arc.olabel, arc.weight, new_id[arc.nextstate])
    if fst.start in new_id:
        out.set_start(new_id[fst.start])
    return out


def topological_order(fst: VectorFst) -> Optional[List[int]]:
    """Topological order of states, or None if the FST has a cycle."""
    S = fst.num_states
    indeg = [0] * S
    for s in range(S):
        for arc in fst.arcs(s):
            indeg[arc.nextstate] += 1
    queue = [s for s in range(S) if indeg[s] == 0]
    order = []
    while queue:
        s = queue.pop()
        order.append(s)
        for arc in fst.arcs(s):
            indeg[arc.nextstate] -= 1
            if indeg[arc.nextstate] == 0:
                queue.append(arc.nextstate)
    return order if len(order) == S else None


def _times(fst: VectorFst, a, b):
    if fst._weight_dim == 1:
        return a + b
    return (a[0] + b[0], a[1] + b[1])


def _plus(fst: VectorFst, a, b):
    if fst._weight_dim == 1:
        return min(a, b)
    # LatticeWeight natural order: smaller total wins; on equal totals the
    # smaller value1 (graph cost) wins (see LatticeSemiring.plus).
    ta, tb = a[0] + a[1], b[0] + b[1]
    if ta != tb:
        return a if ta < tb else b
    return a if a[0] <= b[0] else b


def remove_eps_local(fst: VectorFst) -> VectorFst:
    """Local epsilon removal (``fst::RemoveEpsLocal`` semantics).

    Removes arcs with ``ilabel == olabel == 0`` whenever doing so cannot
    change the language: either the destination state has a single entering
    arc (merge destination into source), or the source state has a single
    leaving arc and no final weight (forward the source into the
    destination).  Applied to the linear chains produced by GetBestPath
    (`faster-decoder.cc:393-422`) this collapses all double-epsilon arcs.
    Returns a trimmed copy.
    """
    work = connect(fst)
    S = work.num_states
    if S == 0:
        return work

    changed = True
    while changed:
        changed = False
        in_deg = [0] * work.num_states
        for s in range(work.num_states):
            for arc in work.arcs(s):
                in_deg[arc.nextstate] += 1
        for s in range(work.num_states):
            il, ol, w, ns = work.state_arc_arrays(s)
            for i in range(len(il)):
                t = ns[i]
                if il[i] != EPSILON or ol[i] != EPSILON or t == s:
                    continue
                wa = w[i]
                if in_deg[t] == 1 and t != work.start:
                    # Merge t into s: delete the eps arc, re-source t's arcs.
                    del il[i], ol[i], w[i], ns[i]
                    til, tol, tw, tns = work.state_arc_arrays(t)
                    for j in range(len(til)):
                        work.add_arc(s, til[j], tol[j], _times(work, wa, tw[j]), tns[j])
                        in_deg[tns[j]] += 1
                    til.clear(); tol.clear(); tw.clear(); tns.clear()
                    if work.is_final(t):
                        fw = _times(work, wa, work.final(t))
                        if work.is_final(s):
                            fw = _plus(work, work.final(s), fw)
                        work.set_final(s, fw)
                        work._finals[t] = work.weight_zero()
                    changed = True
                    break
                if len(il) == 1 and not work.is_final(s):
                    # s has only this eps arc: forward s into t.
                    del il[i], ol[i], w[i], ns[i]
                    if s == work.start:
                        work.set_start(t)
                    else:
                        for p in range(work.num_states):
                            pil, pol, pw, pns = work.state_arc_arrays(p)
                            for j in range(len(pns)):
                                if pns[j] == s:
                                    pns[j] = t
                                    pw[j] = _times(work, pw[j], wa)
                    changed = True
                    break
            if changed:
                break
    return connect(work)


def _arc_cost(fst: VectorFst, w) -> float:
    return w if fst._weight_dim == 1 else (w[0] + w[1])


def shortest_path(fst: VectorFst) -> VectorFst:
    """Single shortest (lowest total cost) successful path
    (``fst::ShortestPath(ifst, &ofst)`` with ``n == 1``,
    `lattice-simple-decoder.cc:574-580`): a linear FST from the start to
    one final state, empty if there is no successful path.  An acyclic FST
    (every decoder lattice) goes through the host library's C++ DAG pass,
    as in the original; a cyclic one through Dijkstra on (total, graph)
    pairs, the LatticeWeight natural order."""
    from kaldi_decoder_tpu_torch import native

    cls = type(fst)
    out = cls()
    S = fst.num_states
    if S == 0 or fst.start < 0:
        return out

    arr = fst.to_arrays()
    src = np.repeat(np.arange(S, dtype=np.int32), np.diff(arr["row_ptr"])).astype(np.int32)
    w = arr["weight"]
    fin = arr["final"]
    if fst._weight_dim == 1:
        w_total, fin_total = w, fin
        w_graph = fin_graph = None
    else:
        w_total, fin_total = w.sum(axis=1), fin.sum(axis=1)
        # Natural-order tie-break on the graph component
        # (lattice-weight.h Compare).
        w_graph = w[:, 0]
        fin_graph = np.where(np.isfinite(fin[:, 0]), fin[:, 0], 0.0)
    try:
        path = native.shortest_path_arrays(
            S, src, w_total, arr["nextstate"], fin_total, fst.start,
            w_graph=w_graph, final_graph=fin_graph,
        )
    except ValueError:
        path = False  # cyclic: Dijkstra below
    if path is not False:
        if path is None:
            return out
        cur = out.add_state()
        out.set_start(cur)
        il, ol, ns = arr["ilabel"], arr["olabel"], arr["nextstate"]
        last = fst.start
        for a in path:
            nxt = out.add_state()
            wa = w[a] if fst._weight_dim == 1 else (float(w[a][0]), float(w[a][1]))
            out.add_arc(cur, int(il[a]), int(ol[a]), wa, nxt)
            cur = nxt
            last = int(ns[a])
        out.set_final(cur, fst.final(last))
        return out

    # Distances are (total, graph) pairs so equal totals tie-break on the
    # graph component; for tropical FSTs the graph component is 0.
    def _pair_cost(w):
        if fst._weight_dim == 1:
            return (w, 0.0)
        return (w[0] + w[1], w[0])

    dist: List[Tuple[float, float]] = [(INF, INF)] * S
    # Backpointer: (prev_state, ilabel, olabel, weight)
    back: List[Optional[Tuple[int, int, int, object]]] = [None] * S
    dist[fst.start] = (0.0, 0.0)
    heap = [((0.0, 0.0), fst.start)]
    done = [False] * S
    while heap:
        d, s = heapq.heappop(heap)
        if done[s]:
            continue
        done[s] = True
        for arc in fst.arcs(s):
            ac = _pair_cost(arc.weight)
            nd = (d[0] + ac[0], d[1] + ac[1])
            if nd < dist[arc.nextstate]:
                dist[arc.nextstate] = nd
                back[arc.nextstate] = (s, arc.ilabel, arc.olabel, arc.weight)
                heapq.heappush(heap, (nd, arc.nextstate))

    best_final, best_cost = -1, (INF, INF)
    for s in range(S):
        if fst.is_final(s) and dist[s][0] != INF:
            fc = _pair_cost(fst.final(s))
            c = (dist[s][0] + fc[0], dist[s][1] + fc[1])
            if c < best_cost:
                best_cost, best_final = c, s
    if best_final < 0:
        return out

    # Walk backpointers, then emit the path forward.
    rev = []
    s = best_final
    while back[s] is not None:
        p, il, ol, w = back[s]
        rev.append((il, ol, w))
        s = p
    cur = out.add_state()
    out.set_start(cur)
    for il, ol, w in reversed(rev):
        nxt = out.add_state()
        out.add_arc(cur, il, ol, w, nxt)
        cur = nxt
    out.set_final(cur, fst.final(best_final))
    return out


def path_labels(fst: VectorFst, side: str = "olabel", keep_eps: bool = False):
    """Extract the label sequence of a *linear* FST (a best path)."""
    if fst.start < 0:
        return []
    labels = []
    s = fst.start
    visited = set()
    while True:
        if s in visited:
            raise ValueError("path_labels: FST is not a simple path")
        visited.add(s)
        arcs = list(fst.arcs(s))
        if not arcs:
            break
        if len(arcs) != 1:
            raise ValueError("path_labels: FST is not linear")
        arc = arcs[0]
        lab = arc.ilabel if side == "ilabel" else arc.olabel
        if keep_eps or lab != EPSILON:
            labels.append(lab)
        s = arc.nextstate
    return labels


def path_total_cost(fst: VectorFst) -> float:
    """Total cost (weights + final) of a linear FST; INF if empty."""
    if fst.start < 0:
        return INF
    total = 0.0
    s = fst.start
    while True:
        arcs = list(fst.arcs(s))
        if not arcs:
            break
        arc = arcs[0]
        total += _arc_cost(fst, arc.weight)
        s = arc.nextstate
    if fst.is_final(s):
        total += _arc_cost(fst, fst.final(s))
    return total
