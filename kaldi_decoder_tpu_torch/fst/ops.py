"""Host FST algorithms: best paths, trimming and composition.

A jax-free copy of the parts of ``kaldi_decoder_tpu/fst/ops.py`` that the
1-best and lattice results need: ``connect``, ``topological_order``,
``remove_eps_local`` (the ``fst::RemoveEpsLocal`` cleanup of best paths,
`kaldi-decoder/csrc/faster-decoder.cc:422`), ``shortest_path``
(``fst::ShortestPath`` over lattices, `lattice-simple-decoder.cc:578`),
``path_labels``, ``path_total_cost`` and ``compose`` (lines 384-581, the
weighted composition that builds HL/HLG graphs).
``tests/test_torch_viterbi.py``, ``tests/test_torch_host.py`` and
``tests/test_torch_fst_io.py`` hold the copy equal to the original.
"""

from __future__ import annotations

import heapq
from typing import List, Optional, Tuple

import numpy as np

from kaldi_decoder_tpu_torch.fst.fst import EPSILON, INF, StdVectorFst, VectorFst


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


def compose(a: VectorFst, b: VectorFst) -> StdVectorFst:
    """Weighted composition ``a ∘ b`` over the tropical semiring.

    The capability the reference gets from kaldifst/OpenFst's ``compose``
    (used by icefall to build HL/HLG decoding graphs fed to the decoders,
    the reference's `README.md:16-20`); here it builds realistic test and
    production graphs natively (e.g. ``compose(ctc_topo(V), lexicon_fst(...))``).

    Uses the standard 3-state epsilon-sequencing filter so epsilon output
    labels of ``a`` and epsilon input labels of ``b`` compose without
    generating redundant interleavings:

    * real match (olabel_a == ilabel_b > 0): any filter state -> 0
    * eps-eps joint move: only from filter 0 -> 0
    * a-side eps-output move (b holds): filter 0/1 -> 1
    * b-side eps-input move (a holds): filter 0/2 -> 2

    Vectorized batched BFS over (state_a, state_b, filter) triples: each
    round joins all frontier pairs' arcs with numpy searchsorted/repeat
    (no per-arc Python), so HL-scale compositions (tens of thousands of
    output states) take well under a second.
    """
    if a.num_states == 0 or b.num_states == 0 or a.start < 0 or b.start < 0:
        return StdVectorFst()
    A = a.to_arrays()
    B = b.to_arrays()
    if A["weight"].ndim != 1 or B["weight"].ndim != 1:
        raise TypeError("compose supports tropical (standard) FSTs")
    rowA = A["row_ptr"].astype(np.int64)
    SB = b.num_states

    # Sort b's arcs by (state, ilabel) so each (state, label) block is one
    # searchsorted range on a combined key.
    degB = np.diff(B["row_ptr"]).astype(np.int64)
    srcB = np.repeat(np.arange(SB, dtype=np.int64), degB)
    orderB = np.lexsort((B["ilabel"], srcB))
    bil = B["ilabel"][orderB].astype(np.int64)
    bol = B["olabel"][orderB]
    bw = B["weight"][orderB]
    bnext = B["nextstate"][orderB]
    # Key stride must exceed every label that can be probed (a-side olabels
    # too, else a large olabel overflows into the next state's key block).
    maxlab = 1 + max(
        int(bil.max()) if len(bil) else 0,
        int(A["olabel"].max()) if len(A["olabel"]) else 0,
    )
    bkey = srcB[orderB] * maxlab + bil

    def enc(sa, sb, f):
        return (sa.astype(np.int64) * SB + sb) * 3 + f

    start_key = int(enc(np.int64(a.start), np.int64(b.start), 0))
    ids = {start_key: 0}
    out = StdVectorFst()
    out.add_state()
    out.set_start(0)

    finals_a = np.array(
        [a.final(s) for s in range(a.num_states)], dtype=np.float64
    )
    finals_b = np.array(
        [b.final(s) for s in range(SB)], dtype=np.float64
    )

    # Per-round arc sink: (src_id, ilabel, olabel, weight, dst_key).
    arc_src: List[np.ndarray] = []
    arc_il: List[np.ndarray] = []
    arc_ol: List[np.ndarray] = []
    arc_w: List[np.ndarray] = []
    arc_dk: List[np.ndarray] = []

    frontier = np.array([[a.start, b.start, 0]], dtype=np.int64)
    frontier_ids = np.array([0], dtype=np.int64)

    def ragged_join(starts, counts):
        """(starts, counts) -> (owner, flat_index) arrays."""
        total = int(counts.sum())
        owner = np.repeat(np.arange(len(counts)), counts)
        within = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        return owner, starts[owner] + within

    while len(frontier):
        sa, sb, ff = frontier[:, 0], frontier[:, 1], frontier[:, 2]
        pid = frontier_ids

        # Flatten all a-side arcs of the frontier pairs.
        degs = rowA[sa + 1] - rowA[sa]
        p_of, aidx = ragged_join(rowA[sa], degs)
        ail = A["ilabel"][aidx].astype(np.int64)
        aol = A["olabel"][aidx].astype(np.int64)
        aw = A["weight"][aidx].astype(np.float64)
        anext = A["nextstate"][aidx].astype(np.int64)
        a_sb = sb[p_of]
        a_f = ff[p_of]

        segs = []  # (src_id, il, ol, w, dst_key)

        # Real matches + eps-eps joint moves against b's sorted arcs.
        joint = (aol > 0) | ((aol == 0) & (a_f == 0))
        if np.any(joint):
            j = np.flatnonzero(joint)
            want = a_sb[j] * maxlab + aol[j]
            lo = np.searchsorted(bkey, want, side="left")
            hi = np.searchsorted(bkey, want, side="right")
            jo, bidx = ragged_join(lo, hi - lo)
            ja = j[jo]
            segs.append((
                pid[p_of[ja]],
                ail[ja],
                bol[bidx].astype(np.int64),
                aw[ja] + bw[bidx],
                enc(anext[ja], bnext[bidx].astype(np.int64), np.int64(0)),
            ))

        # a-side eps-output solo move (b holds still): filter 0/1 -> 1.
        solo_a = (aol == 0) & (a_f != 2)
        if np.any(solo_a):
            m = np.flatnonzero(solo_a)
            segs.append((
                pid[p_of[m]],
                ail[m],
                np.zeros(len(m), np.int64),
                aw[m],
                enc(anext[m], a_sb[m], np.int64(1)),
            ))

        # b-side eps-input solo move (a holds still): filter 0/2 -> 2.
        solo_b_ok = ff != 1
        if np.any(solo_b_ok):
            q = np.flatnonzero(solo_b_ok)
            want_lo = sb[q] * maxlab  # label 0 block
            lo = np.searchsorted(bkey, want_lo, side="left")
            hi = np.searchsorted(bkey, want_lo + 1, side="left")
            qo, bidx = ragged_join(lo, hi - lo)
            qq = q[qo]
            segs.append((
                pid[qq],
                np.zeros(len(qq), np.int64),
                bol[bidx].astype(np.int64),
                bw[bidx].astype(np.float64),
                enc(sa[qq], bnext[bidx].astype(np.int64), np.int64(2)),
            ))

        if not segs:
            break
        src = np.concatenate([s[0] for s in segs])
        il = np.concatenate([s[1] for s in segs])
        ol = np.concatenate([s[2] for s in segs])
        w = np.concatenate([s[3] for s in segs])
        dk = np.concatenate([s[4] for s in segs])
        arc_src.append(src)
        arc_il.append(il)
        arc_ol.append(ol)
        arc_w.append(w)
        arc_dk.append(dk)

        # New triples -> ids; unseen ones form the next frontier.
        uniq = np.unique(dk)
        fresh = [k for k in uniq.tolist() if k not in ids]
        if fresh:
            base = len(ids)
            for i, k in enumerate(fresh):
                ids[k] = base + i
            out.add_states(len(fresh))
            fr = np.array(fresh, dtype=np.int64)
            f_new = fr % 3
            pair = fr // 3
            frontier = np.stack([pair // SB, pair % SB, f_new], axis=1)
            frontier_ids = np.arange(base, base + len(fresh), dtype=np.int64)
        else:
            frontier = np.zeros((0, 3), np.int64)
            frontier_ids = np.zeros((0,), np.int64)

    # Emit arcs (map dst keys -> ids) grouped by source, order preserved.
    if arc_src:
        src = np.concatenate(arc_src)
        il = np.concatenate(arc_il)
        ol = np.concatenate(arc_ol)
        w = np.concatenate(arc_w)
        dk = np.concatenate(arc_dk)
        dst = np.array([ids[int(k)] for k in dk], dtype=np.int64)
        order = np.argsort(src, kind="stable")
        for i in order:
            out.add_arc(int(src[i]), int(il[i]), int(ol[i]), float(w[i]), int(dst[i]))

    # Final weights: final_a(sa) (+) final_b(sb), any filter state.
    key_arr = np.array(sorted(ids, key=ids.get), dtype=np.int64)
    pair = key_arr // 3
    fa = finals_a[pair // SB]
    fb = finals_b[pair % SB]
    tot = fa + fb
    for s in np.flatnonzero(np.isfinite(tot)):
        out.set_final(int(s), float(tot[s]))
    return connect(out)
