"""Host FST algorithms applied to best paths.

A jax-free copy of the parts of ``kaldi_decoder_tpu/fst/ops.py`` that the
1-best result needs: ``connect``, ``remove_eps_local`` (the
``fst::RemoveEpsLocal`` cleanup of best paths,
`kaldi-decoder/csrc/faster-decoder.cc:422`), ``path_labels`` and
``path_total_cost``.  ``tests/test_torch_viterbi.py`` holds the copy
equal to the original.
"""

from __future__ import annotations

from typing import List

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
