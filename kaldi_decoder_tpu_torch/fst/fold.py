"""Epsilon precomposition: fold eps closures into emitting arcs.

A jax-free copy of ``kaldi_decoder_tpu/fst/fold.py`` (numpy only), kept
because importing the original imports jax; ``tests/test_torch_host.py``
holds it equal to the original.

The reference interleaves every frame's emitting expansion with an
epsilon-closure worklist (`kaldi-decoder/csrc/faster-decoder.cc:59-119`).
On TPU that closure costs bounded-iteration expansions + dedups per frame
— typically half the frame time.  For graphs with an *acyclic* epsilon
subgraph (H/HL/HLG all qualify) the closure can be precomposed at graph
compile time instead:

    for every emitting arc e = (s --i:o/w--> t)
    and every eps path p = t => u (weight wp):
        add folded arc (s --i:o/w+wp--> u)

The device then decodes an **eps-free** graph — one expansion + one dedup
per frame — while a host-side path table maps every folded arc id back to
its original arc sequence ``[em_arc, eps_arc...]``, so best paths and
lattices are reconstructed in terms of the ORIGINAL graph, with identical
labels, weights and intermediate states.

Exactness conditions (checked; fold refuses otherwise):

* acyclic epsilon subgraph (finite ``eps_depth``);
* non-negative epsilon weights — then a composite path's intermediate
  costs never exceed its final cost, so pruning at the final cost keeps
  exactly the tokens the reference's per-iteration cutoff keeps;
* bounded blowup (folded arcs <= ``max_blowup`` x original).

One knowable divergence, shared in kind with the runtime path: when
``max_active`` evicts an eps-intermediate state from the frontier, the
lattice loses links through it (the reference's hash can also evict under
``PossiblyResizeHash`` pressure, `faster-decoder.cc:338-345`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays

INF = np.float32(np.inf)


@dataclasses.dataclass(frozen=True)
class StartClosure:
    """Host-computed eps closure of the start state (InitDecoding,
    `faster-decoder.cc:42-56`)."""

    states: np.ndarray  # (n,) int32, min-cost order
    costs: np.ndarray  # (n,) float32
    # Min-cost eps path (original eps arc ids) from start to each state.
    paths: List[List[int]]
    # All (src_state, eps_arc) records inside the closure region —
    # the init lattice links (`lattice-simple-decoder.cc:17-34`).
    eps_records: np.ndarray  # (m, 2) int32


@dataclasses.dataclass(frozen=True)
class FoldedGraph:
    """Eps-free device graph + host mapping back to the original."""

    device: CsrGraph  # eps-free; same state space as orig
    orig: CsrGraph
    # Folded arc id -> original arc path: path_arcs[path_ptr[i]] is the
    # emitting arc, the rest are eps arcs in forward order.
    path_ptr: np.ndarray  # (E'+1,) int64
    path_arcs: np.ndarray  # int32
    eps_src: np.ndarray  # (E_eps,) int32 — source state of each orig eps arc
    start: StartClosure

    def em_arc_of(self, folded_arc: np.ndarray) -> np.ndarray:
        return self.path_arcs[self.path_ptr[folded_arc]]

    def eps_path_of(self, folded_arc: int) -> List[int]:
        lo, hi = int(self.path_ptr[folded_arc]), int(self.path_ptr[folded_arc + 1])
        return [int(a) for a in self.path_arcs[lo + 1 : hi]]

    def expand_em_records(
        self, records: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Folded (src_state, folded_arc) records -> original-graph records.

        Returns (em_records (M, 2), eps_records (Me, 2)); both deduped.
        An eps arc's source state is a graph property (``eps_src``), so
        eps records need no per-path context.
        """
        ok = records[:, 1] >= 0
        src = records[ok, 0].astype(np.int64)
        fa = records[ok, 1].astype(np.int64)
        if len(fa) == 0:
            z = np.zeros((0, 2), np.int32)
            return z, z
        em = np.stack([src, self.path_arcs[self.path_ptr[fa]]], axis=1)
        em = np.unique(em, axis=0).astype(np.int32)

        lo = self.path_ptr[fa] + 1
        hi = self.path_ptr[fa + 1]
        lens = (hi - lo).astype(np.int64)
        tot = int(lens.sum())
        if tot == 0:
            return em, np.zeros((0, 2), np.int32)
        pos = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
        arcs = self.path_arcs[np.repeat(lo, lens) + pos]
        arcs = np.unique(arcs)
        eps = np.stack([self.eps_src[arcs], arcs], axis=1).astype(np.int32)
        return em, eps


    def expand_with_alphas(
        self,
        records: np.ndarray,
        src_states: np.ndarray,
        src_alphas: np.ndarray,
        scores_t: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Folded records -> original records + synthesized token alphas.

        Closes the folded-lattice reconstruction hole (ADVICE r1 item 4 /
        VERDICT r2 weak #3): a record's eps-intermediate states may have
        been evicted from the device frontier (K boundary / max_active)
        while the composite destination survived; reconstruction must not
        depend on their survival.  Every state along a recorded path is
        therefore returned with its path-prefix forward cost so the host
        can materialize the missing tokens (`lattice-simple-decoder.cc:82-120`
        FindOrAddToken creates intermediates unconditionally).

        Because every eps-path *prefix* is itself a folded arc (the
        closure enumeration includes single arcs), a prefix cost is always
        >= the frontier alpha when the state did survive — callers keep
        the frontier value on merge, so surviving tokens are unaffected.

        Args: ``records (R, 2)`` device ``(src_state, folded_arc)`` rows
        (-1 padded); ``src_states``/``src_alphas`` the *sorted* frame-t
        frontier; ``scores_t (V,)`` the frame's acoustic row.
        Returns ``(em_records, eps_records, token_states, token_alphas)``
        with records deduped and token alphas min-reduced per state.
        """
        ga = self.orig.arrays
        z2 = np.zeros((0, 2), np.int32)
        z = np.zeros((0,), np.int64)
        ok = records[:, 1] >= 0
        src = records[ok, 0].astype(np.int64)
        fa = records[ok, 1].astype(np.int64)
        if len(fa) == 0 or len(src_states) == 0:
            return z2, z2, z, np.zeros((0,), np.float64)
        # Drop records whose source token is missing (cannot happen for
        # device-emitted records — sources are frontier slots — but keeps
        # the function total).
        pos = np.searchsorted(src_states, src)
        pos = np.clip(pos, 0, max(len(src_states) - 1, 0))
        has_src = (len(src_states) > 0) & (src_states[pos] == src)
        src, fa, pos = src[has_src], fa[has_src], pos[has_src]
        if len(fa) == 0:
            return z2, z2, z, np.zeros((0,), np.float64)
        alpha_src = src_alphas[pos].astype(np.float64)

        em_arc = self.path_arcs[self.path_ptr[fa]].astype(np.int64)
        # Key-based row dedup (np.unique(axis=0) is ~10x slower).
        nE = self.orig.num_emitting_arcs + 1
        ukey = np.unique(src * nE + em_arc)
        em = np.stack([ukey // nE, ukey % nE], axis=1).astype(np.int32)
        c0 = (
            alpha_src
            + ga.em_weight[em_arc].astype(np.float64)
            - scores_t[ga.em_score_idx[em_arc]].astype(np.float64)
        )
        tok_states = [ga.em_next[em_arc].astype(np.int64)]
        tok_alphas = [c0]

        lo = self.path_ptr[fa] + 1
        hi = self.path_ptr[fa + 1]
        lens = (hi - lo).astype(np.int64)
        tot = int(lens.sum())
        if tot:
            within = np.arange(tot) - np.repeat(np.cumsum(lens) - lens, lens)
            arcs = self.path_arcs[np.repeat(lo, lens) + within].astype(np.int64)
            w = ga.eps_weight[arcs].astype(np.float64)
            # Prefix sum within each record's chain (cumsum with per-chain
            # reset): pref[i] = sum of the chain's weights up to arc i.
            # cw_ex[k] = total weight before flat position k; zero-length
            # chains (plain em arcs) repeat away.
            cw = np.cumsum(w)
            cw_ex = np.concatenate([[0.0], cw])
            starts = np.cumsum(lens) - lens
            pref = cw - np.repeat(cw_ex[starts], lens)
            tok_states.append(ga.eps_next[arcs].astype(np.int64))
            tok_alphas.append(np.repeat(c0, lens) + pref)
            uarcs = np.unique(arcs)
            eps = np.stack(
                [self.eps_src[uarcs], uarcs], axis=1
            ).astype(np.int32)
        else:
            eps = z2

        states = np.concatenate(tok_states)
        alphas = np.concatenate(tok_alphas)
        order = np.lexsort((alphas, states))
        states, alphas = states[order], alphas[order]
        first = np.ones(len(states), bool)
        first[1:] = states[1:] != states[:-1]
        return em, eps, states[first], alphas[first]


def _eps_paths_per_state(
    orig: CsrGraph, budget: int
) -> Optional[List[List[Tuple[int, float, List[int]]]]]:
    """All eps paths (dst, weight, arc list) from every state.

    Memoized DFS over the acyclic eps subgraph; returns None if the total
    path count exceeds ``budget``.
    """
    ga = orig.arrays
    S = orig.num_states
    row = ga.eps_row_ptr
    nxt = ga.eps_next
    w = ga.eps_weight
    memo: List[Optional[list]] = [None] * S
    total = 0

    order = _eps_topo_order(orig)
    if order is None:
        return None
    for s in order:  # reverse-topological: successors first
        lo, hi = int(row[s]), int(row[s + 1])
        if lo == hi:
            memo[s] = []
            continue
        out = []
        for a in range(lo, hi):
            t = int(nxt[a])
            wa = float(w[a])
            out.append((t, wa, [a]))
            for (u, wu, pu) in memo[t]:
                out.append((u, wa + wu, [a] + pu))
        total += len(out)
        if total > budget:
            return None
        memo[s] = out
    return memo


def _eps_topo_order(orig: CsrGraph) -> Optional[np.ndarray]:
    """States in reverse topological order of the eps subgraph (successors
    before predecessors); None if cyclic."""
    ga = orig.arrays
    S = orig.num_states
    row, nxt = ga.eps_row_ptr, ga.eps_next
    outdeg_rem = np.diff(row).astype(np.int64)
    # Reverse adjacency via arc sort by nextstate.
    order = []
    stack = list(np.flatnonzero(outdeg_rem == 0))
    if len(nxt):
        rev_sort = np.argsort(nxt, kind="stable")
        rev_targets = nxt[rev_sort]
        rev_starts = np.searchsorted(rev_targets, np.arange(S + 1))
        eps_src = np.repeat(np.arange(S, dtype=np.int32), np.diff(row))
    while stack:
        s = stack.pop()
        order.append(s)
        if len(nxt):
            for k in range(int(rev_starts[s]), int(rev_starts[s + 1])):
                p = int(eps_src[rev_sort[k]])
                outdeg_rem[p] -= 1
                if outdeg_rem[p] == 0:
                    stack.append(p)
    if len(order) != S:
        return None
    return np.asarray(order, dtype=np.int64)


def _start_closure(orig: CsrGraph) -> StartClosure:
    """Min-cost eps closure from the start state + all closure eps arcs."""
    ga = orig.arrays
    row, nxt, w = ga.eps_row_ptr, ga.eps_next, ga.eps_weight
    start = orig.start_state
    cost = {start: 0.0}
    path: dict = {start: []}
    recs = []
    # Bellman-Ford bounded by eps depth (DAG; nonneg weights).
    frontier = [start]
    seen_arcs = set()
    for _ in range((orig.eps_depth or 0) + 1):
        new_frontier = []
        for s in frontier:
            for a in range(int(row[s]), int(row[s + 1])):
                if a not in seen_arcs:
                    seen_arcs.add(a)
                    recs.append((s, a))
                t = int(nxt[a])
                c = cost[s] + float(w[a])
                if t not in cost or c < cost[t]:
                    cost[t] = c
                    path[t] = path[s] + [a]
                    new_frontier.append(t)
        if not new_frontier:
            break
        frontier = new_frontier
    states = np.array(sorted(cost, key=lambda s: (cost[s], s)), np.int32)
    costs = np.array([cost[int(s)] for s in states], np.float32)
    paths = [path[int(s)] for s in states]
    eps_records = (
        np.array(recs, np.int32) if recs else np.zeros((0, 2), np.int32)
    )
    return StartClosure(
        states=states, costs=costs, paths=paths, eps_records=eps_records
    )


def fold_eps(orig: CsrGraph, max_blowup: float = 6.0) -> Optional[FoldedGraph]:
    """Precompose eps closures into emitting arcs; None if not foldable
    (cyclic eps, negative eps weights, or blowup beyond ``max_blowup``)."""
    if not orig.has_eps:
        return None
    if orig.eps_depth is None:
        return None  # cyclic eps subgraph: keep runtime closure
    ga = orig.arrays
    if len(ga.eps_weight) and float(ga.eps_weight.min()) < 0.0:
        return None  # negative eps weights break cutoff equivalence

    budget = int(max_blowup * max(orig.num_emitting_arcs, 1))
    closures = _eps_paths_per_state(orig, budget)
    if closures is None:
        return None

    S = orig.num_states
    E = orig.num_emitting_arcs
    em_src = np.repeat(
        np.arange(S, dtype=np.int64), np.diff(ga.em_row_ptr)
    )

    # Flatten the per-state closures into CSR form once.
    clo_cnt = np.fromiter((len(c) for c in closures), np.int64, count=S)
    clo_ptr = np.zeros(S + 1, np.int64)
    clo_ptr[1:] = np.cumsum(clo_cnt)
    nclo = int(clo_ptr[-1])
    clo_dst = np.empty(nclo, np.int32)
    clo_w = np.empty(nclo, np.float32)
    clo_plen = np.empty(nclo, np.int64)
    clo_path_parts: List[List[int]] = []
    k = 0
    for c in closures:
        for (u, wu, pu) in c:
            clo_dst[k], clo_w[k], clo_plen[k] = u, wu, len(pu)
            clo_path_parts.append(pu)
            k += 1
    clo_path_ptr = np.zeros(nclo + 1, np.int64)
    clo_path_ptr[1:] = np.cumsum(clo_plen)
    clo_paths = (
        np.fromiter(
            (a for pu in clo_path_parts for a in pu),
            np.int32,
            count=int(clo_path_ptr[-1]),
        )
        if nclo
        else np.zeros(0, np.int32)
    )

    # Per emitting arc e: the original arc, then one composite per closure
    # entry of its destination — all fully vectorized.  Original em arcs
    # are CSR-ordered by source and composites sit right after their base
    # arc, so the folded arc list is already grouped by source state.
    n_ext = clo_cnt[ga.em_next]  # (E,)
    E2 = int(E + n_ext.sum())
    if E2 > budget + E:
        return None
    base = np.arange(E, dtype=np.int64) + np.concatenate(
        [[0], np.cumsum(n_ext)[:-1]]
    )  # position of each original arc
    tot_ext = int(n_ext.sum())
    em_of_comp = np.repeat(np.arange(E, dtype=np.int64), n_ext)
    j = np.arange(tot_ext, dtype=np.int64) - np.repeat(
        np.cumsum(n_ext) - n_ext, n_ext
    )
    entry = clo_ptr[ga.em_next[em_of_comp]] + j
    comp_pos = base[em_of_comp] + 1 + j

    new_next = np.empty(E2, np.int32)
    new_w = np.empty(E2, np.float32)
    new_il = np.empty(E2, np.int32)
    new_ol = np.empty(E2, np.int32)
    new_next[base] = ga.em_next
    new_w[base] = ga.em_weight
    new_il[base] = ga.em_ilabel
    new_ol[base] = ga.em_olabel
    new_next[comp_pos] = clo_dst[entry]
    new_w[comp_pos] = ga.em_weight[em_of_comp] + clo_w[entry]
    new_il[comp_pos] = ga.em_ilabel[em_of_comp]
    new_ol[comp_pos] = ga.em_olabel[em_of_comp]

    # Paths: [em_arc] for originals, [em_arc] + closure path for composites.
    plen = np.ones(E2, np.int64)
    plen[comp_pos] = 1 + clo_plen[entry]
    p_ptr2 = np.zeros(E2 + 1, np.int64)
    p_ptr2[1:] = np.cumsum(plen)
    path_arcs2 = np.empty(int(p_ptr2[-1]), np.int32)
    path_arcs2[p_ptr2[base]] = np.arange(E, dtype=np.int32)
    path_arcs2[p_ptr2[comp_pos]] = em_of_comp.astype(np.int32)
    if tot_ext:
        lens_e = clo_plen[entry]
        tot_tail = int(lens_e.sum())
        jj = np.arange(tot_tail, dtype=np.int64) - np.repeat(
            np.cumsum(lens_e) - lens_e, lens_e
        )
        path_arcs2[np.repeat(p_ptr2[comp_pos] + 1, lens_e) + jj] = clo_paths[
            np.repeat(clo_path_ptr[entry], lens_e) + jj
        ]

    new_cnt = np.diff(ga.em_row_ptr).astype(np.int64) + np.bincount(
        em_src, weights=n_ext, minlength=S
    ).astype(np.int64)
    em_row_ptr = np.zeros(S + 1, np.int32)
    em_row_ptr[1:] = np.cumsum(new_cnt)

    il2 = new_il
    arrays = GraphArrays(
        em_row_ptr=em_row_ptr,
        em_ilabel=il2,
        em_olabel=new_ol,
        em_weight=new_w,
        em_next=new_next,
        em_score_idx=(il2 - 1).astype(np.int32),
        eps_row_ptr=np.zeros(S + 1, np.int32),
        eps_olabel=np.zeros(0, np.int32),
        eps_weight=np.zeros(0, np.float32),
        eps_next=np.zeros(0, np.int32),
        final_cost=ga.final_cost,
    )
    deg = np.diff(em_row_ptr)
    device = CsrGraph(
        arrays=arrays,
        num_states=S,
        num_emitting_arcs=E2,
        num_eps_arcs=0,
        start_state=orig.start_state,
        eps_depth=0,
        max_em_out_degree=int(deg.max()) if S else 0,
        max_eps_out_degree=0,
        max_score_idx=orig.max_score_idx,
    )
    eps_src = np.repeat(
        np.arange(S, dtype=np.int32), np.diff(ga.eps_row_ptr)
    )
    return FoldedGraph(
        device=device,
        orig=orig,
        path_ptr=p_ptr2,
        path_arcs=path_arcs2,
        eps_src=eps_src,
        start=_start_closure(orig),
    )
