"""Sharded-graph decoding: states partitioned across a ``model`` mesh dimension.

The torch counterpart of ``kaldi_decoder_tpu/parallel/graph_shard.py``.
States are partitioned contiguously across P ranks; each rank owns the
out-arcs of its states and uploads only its part of the graph.  Per
frame, every rank expands its local frontier, routes each candidate token
to its destination state's owner with one ``all_to_all`` over the mesh's
``model`` group, and dedups and prunes locally: global per-state dedup
holds because ownership is a partition.  Every rank runs the decoder
(SPMD): one rank is one shard of the original's ``shard_map``, and where
the mesh also has a ``data`` dimension the batch is split over it.

Semantics are the original's: the beam is global (the cutoff uses the
global best, an ``all_reduce`` MIN, and the max/min-active order
statistics of the union of the shards' frontiers, :func:`_global_cutoff`);
``max_active`` capacity is per shard; backpointers carry *global* slot ids
``rank * K_local + slot`` and records global state ids, so the host
results (``ViterbiResult``, ``LatticeResult``) are reused unchanged.  The
sharded decoders never fold eps arcs (the original's module docstring says
why): the eps closure runs every frame, its candidates routed like the
emitting ones, for a fixed ``eps_iters`` iterations whose results after
the last global change are discarded on the device (``changed`` is
reduced with MAX, never read by the host).

On the card the frame runs the port's hand-written kernels at shard
shapes: K1 (``kernels.expand.expand_filter``, the ``src_slot`` variant on
the Viterbi path, the lattice variant on the lattice path) on the local
frontier; K6 (``kernels.dedup.dedup_select``) on the routed lanes, ``P *
route_cap`` wide with ``part_size`` states, and again each eps iteration
with the K incumbents first; K2 (``kernels.dedup_rec.dedup_select_rec``)
on the routed lanes and, with ``num_incumbents = K``, each eps iteration
of the lattice path.  The eps expansion (``frontier.expand_eps``, K5) and
the routing's sort, scan and scatter (:func:`_route`, K7) are plain torch
on the card too.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepState,
    _backpointers,
    _identity_bp,
    config_for_graph,
    expand_eps,
)
from kaldi_decoder_tpu_torch.fst.csr import CsrGraph, GraphArrays
from kaldi_decoder_tpu_torch.fst.pack import (
    EM_FIELDS,
    EPS_FIELDS,
    INF_BITS,
    PackedGraph,
    pack_graph,
    pack_graph_device,
)
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
from kaldi_decoder_tpu_torch.parallel.mesh import (
    all_gather_cat,
    all_gather_object,
    all_reduce,
    all_to_all,
    batch_sharding,
    check_device,
    local_batch,
)

INF = float("inf")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Graph partitioning (host, numpy)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """A CsrGraph partitioned into P contiguous state ranges.

    ``packed`` holds every part's packed tables stacked on a leading (P,)
    axis, the flat tables padded to a common length: the original's
    layout, kept to hold the port's partition to it; a decoder's rank
    slices and packs only its own part (:func:`local_part`).  Local arc
    ids + ``em_arc_offset[p]`` recover *global* arc ids, because
    contiguous state partitioning slices the global CSR arc order.
    """

    graph: CsrGraph  # the original, for host-side result reconstruction
    packed: PackedGraph  # leading (P,) axis on every table
    num_parts: int
    part_size: int  # Sp: states per part (last part padded)
    em_arc_offset: np.ndarray  # (P,) int32
    eps_arc_offset: np.ndarray  # (P,) int32


def _slice_part(ga: GraphArrays, lo: int, hi: int, sp: int) -> CsrGraph:
    """Local CsrGraph for states [lo, hi), padded to sp states.

    nextstate / score_idx stay GLOBAL (routing happens after expansion).
    """
    em_lo, em_hi = int(ga.em_row_ptr[lo]), int(ga.em_row_ptr[hi])
    eps_lo, eps_hi = int(ga.eps_row_ptr[lo]), int(ga.eps_row_ptr[hi])
    em_row = np.zeros(sp + 1, np.int32)
    em_row[: hi - lo + 1] = ga.em_row_ptr[lo : hi + 1] - em_lo
    em_row[hi - lo + 1 :] = em_row[hi - lo]
    eps_row = np.zeros(sp + 1, np.int32)
    eps_row[: hi - lo + 1] = ga.eps_row_ptr[lo : hi + 1] - eps_lo
    eps_row[hi - lo + 1 :] = eps_row[hi - lo]
    final = np.full(sp, np.float32(np.inf))
    final[: hi - lo] = ga.final_cost[lo:hi]
    la = GraphArrays(
        em_row_ptr=em_row,
        em_ilabel=ga.em_ilabel[em_lo:em_hi],
        em_olabel=ga.em_olabel[em_lo:em_hi],
        em_weight=ga.em_weight[em_lo:em_hi],
        em_next=ga.em_next[em_lo:em_hi],
        em_score_idx=ga.em_score_idx[em_lo:em_hi],
        eps_row_ptr=eps_row,
        eps_olabel=ga.eps_olabel[eps_lo:eps_hi],
        eps_weight=ga.eps_weight[eps_lo:eps_hi],
        eps_next=ga.eps_next[eps_lo:eps_hi],
        final_cost=final,
    )
    em_deg = np.diff(em_row)
    eps_deg = np.diff(eps_row)
    return CsrGraph(
        arrays=la,
        num_states=sp,
        num_emitting_arcs=em_hi - em_lo,
        num_eps_arcs=eps_hi - eps_lo,
        start_state=0,  # unused locally
        eps_depth=None,
        max_em_out_degree=int(em_deg.max()) if sp else 0,
        max_eps_out_degree=int(eps_deg.max()) if sp else 0,
        max_score_idx=-1,
    )


def _pad_flat(flat, n: int, fields: int):
    """Pad a flat table (numpy or tensor) to ``n`` rows.  Pad rows mark
    every packed arc's weight column +inf so stray lanes self-invalidate
    (em rows hold FLAT_GROUP arcs of ``fields`` ints each; eps rows hold
    one arc)."""
    if flat.shape[0] >= n:
        return flat
    pad = np.zeros((n - flat.shape[0], flat.shape[1]), np.int32)
    pad[:, ::fields] = INF_BITS
    if isinstance(flat, np.ndarray):
        return np.concatenate([flat, pad], axis=0)
    return torch.cat([flat, torch.from_numpy(pad).to(flat.device)], dim=0)


def _part_bounds(num_states: int, num_parts: int, p: int) -> Tuple[int, int, int]:
    """Part ``p``'s states [lo, hi) and the states of every part."""
    sp = -(-num_states // num_parts)  # ceil
    return min(p * sp, num_states), min((p + 1) * sp, num_states), sp


def shard_graph(
    graph: CsrGraph, num_parts: int, w_em: int, w_eps: int, flat_group: int = 4
) -> ShardedGraph:
    """Partition states contiguously into ``num_parts`` and pack each part."""
    local = []
    em_off = np.zeros(num_parts, np.int32)
    eps_off = np.zeros(num_parts, np.int32)
    for p in range(num_parts):
        lo, hi, sp = _part_bounds(graph.num_states, num_parts, p)
        em_off[p] = graph.arrays.em_row_ptr[lo]
        eps_off[p] = graph.arrays.eps_row_ptr[lo]
        local.append(_slice_part(graph.arrays, lo, hi, sp))
    packs = [pack_graph(g, w_em, w_eps, flat_group) for g in local]
    e_max = max(p.em_flat.shape[0] for p in packs)
    z_max = max(p.eps_flat.shape[0] for p in packs)
    stacked = PackedGraph(
        em_block=np.stack([p.em_block for p in packs]),
        em_flat=np.stack([_pad_flat(p.em_flat, e_max, EM_FIELDS) for p in packs]),
        eps_block=np.stack([p.eps_block for p in packs]),
        eps_flat=np.stack([_pad_flat(p.eps_flat, z_max, EPS_FIELDS) for p in packs]),
    )
    return ShardedGraph(
        graph=graph,
        packed=stacked,
        num_parts=num_parts,
        part_size=sp,
        em_arc_offset=em_off,
        eps_arc_offset=eps_off,
    )


class LocalPart(NamedTuple):
    """One rank's part of a state-sharded graph."""

    packed: PackedGraph  # on the rank's device
    num_parts: int
    part_size: int  # Sp: states per part (last part padded)
    em_arc_offset: int
    eps_arc_offset: int


def local_part(
    graph: CsrGraph, num_parts: int, p: int, w_em: int, w_eps: int, flat_group: int, device
) -> LocalPart:
    """Part ``p`` of ``num_parts``, sliced on the host and packed on
    ``device`` (``pack_graph_device``): ``shard_graph``'s ``packed[:, p]``
    without the pad rows that stack the parts' flat tables to one length,
    but one: a part without arcs of a kind keeps one pad row of that
    table, since the plain expansions read row 0 for their masked lanes."""
    lo, hi, sp = _part_bounds(graph.num_states, num_parts, p)
    pg = pack_graph_device(_slice_part(graph.arrays, lo, hi, sp), w_em, w_eps, flat_group, device)
    return LocalPart(
        packed=pg._replace(em_flat=_pad_flat(pg.em_flat, 1, EM_FIELDS),
                           eps_flat=_pad_flat(pg.eps_flat, 1, EPS_FIELDS)),
        num_parts=num_parts,
        part_size=sp,
        em_arc_offset=int(graph.arrays.em_row_ptr[lo]),
        eps_arc_offset=int(graph.arrays.eps_row_ptr[lo]),
    )


# ---------------------------------------------------------------------------
# Token routing (K7, plain torch)
# ---------------------------------------------------------------------------


class Routed(NamedTuple):
    """Per-rank receive buffers after the all_to_all (flattened P*C)."""

    state_local: torch.Tensor  # (B, P*C) int32, Sp == invalid sentinel
    cost: torch.Tensor  # (B, P*C) float32, +inf invalid
    gslot: torch.Tensor  # (B, P*C) int32 global source slot (or state)
    arc: torch.Tensor  # (B, P*C) int32 global arc id
    overflow: torch.Tensor  # (B,) bool — a (src, dst) bucket overflowed


def route_buffers(
    dst_g: torch.Tensor,  # (B, N) global destination states
    cost: torch.Tensor,  # (B, N) +inf invalid
    gslot: torch.Tensor,  # (B, N) global source slot (or state)
    arc_g: torch.Tensor,  # (B, N) global arc id
    sp: int,
    num_parts: int,
    cap: int,
    local_slack_beam: Optional[float] = None,
):
    """The send side of :func:`_route`: the (P, B, cap, 4) int32 buffer
    whose slice p goes to rank p, rows ``[local state, cost bits, slot,
    arc]``, and the overflow flag (B,).

    One 3-key sort by (owner, local state, cost) groups candidates and
    performs the local pre-routing dedup: each (owner, state) run's leader
    is its local per-state minimum.  It is a stable sort by cost, then a
    stable sort by the (owner, state) key, so equal keys keep candidate
    order; the original's comparator takes -0.0 and +0.0 as equal, so
    they are folded for the cost sort.  With ``local_slack_beam`` None
    (best-path decode) only leaders are routed; with a beam (lattice
    decode) non-leaders are routed while ``cost - local minimum`` is at
    most the beam (the global slack is no smaller, so what is dropped is
    beyond the lattice beam).  Within-run positions place survivors in the
    fixed (P, cap) buffer; a bucket overflow drops candidates and sets the
    flag."""
    B, N = dst_g.shape
    dev = dst_g.device
    valid = torch.isfinite(cost)
    owner = torch.div(dst_g, sp, rounding_mode="floor")
    key = torch.where(valid, owner, num_parts)
    dloc = torch.where(valid, dst_g - owner * sp, sp)
    _, by_cost = torch.sort(torch.where(cost == 0, 0.0, cost), dim=1, stable=True)
    okey = key.long() * (sp + 1) + dloc.long()
    _, by_key = torch.sort(okey.gather(1, by_cost), dim=1, stable=True)
    perm = by_cost.gather(1, by_key)
    k2, d2, c2, s2, a2 = (x.gather(1, perm) for x in (key, dloc, cost, gslot, arc_g))

    lane = torch.arange(N, device=dev).expand(B, N)
    first = torch.ones((B, N), dtype=torch.bool, device=dev)
    # (owner, state)-run leaders: the local per-state minima.
    state_leader = first.clone()
    state_leader[:, 1:] = (k2[:, 1:] != k2[:, :-1]) | (d2[:, 1:] != d2[:, :-1])
    if local_slack_beam is None:
        keep = state_leader & (k2 < num_parts)
    else:
        run_min = c2.gather(1, torch.where(state_leader, lane, 0).cummax(dim=1).values)
        keep = (k2 < num_parts) & (c2 - run_min <= local_slack_beam)
    # Position among kept lanes within each owner run (exclusive count).
    owner_leader = first
    owner_leader[:, 1:] = k2[:, 1:] != k2[:, :-1]
    kept = keep.to(torch.int32)
    csum = kept.cumsum(dim=1, dtype=torch.int32)
    start = torch.where(owner_leader, lane, 0).cummax(dim=1).values
    within = (csum - kept) - (csum.gather(1, start) - kept.gather(1, start))
    ok = keep & (within < cap)
    flat = num_parts * cap
    tgt = torch.where(ok, k2 * cap + within, flat).long()
    rows = torch.stack(
        [d2, torch.where(ok, c2, INF).view(torch.int32), s2, a2], dim=-1
    ).to(torch.int32)
    send = torch.zeros((B, flat + 1, 4), dtype=torch.int32, device=dev)
    send[..., 1] = INF_BITS
    send[..., 3] = NO_ARC
    # Targets are unique but for the spill column ``flat``, which is dropped.
    send.scatter_(1, tgt[..., None].expand(B, N, 4), rows)
    send = send[:, :flat].reshape(B, num_parts, cap, 4).transpose(0, 1).contiguous()
    return send, (keep & (within >= cap)).any(dim=1)


def _route(dst_g, cost, gslot, arc_g, sp: int, num_parts: int, cap: int, group,
           local_slack_beam: Optional[float] = None) -> Routed:
    """Bucket candidates by owner rank (:func:`route_buffers`) and
    exchange them over ``group`` with one ``all_to_all`` of the four
    columns."""
    B = dst_g.shape[0]
    send, ovf = route_buffers(dst_g, cost, gslot, arc_g, sp, num_parts, cap, local_slack_beam)
    recv = all_to_all(send, group)  # (P, B, cap, 4): slice p from rank p
    recv = recv.transpose(0, 1).reshape(B, num_parts * cap, 4)
    c = recv[..., 1].contiguous().view(torch.float32)
    # Invalid entries carry cost=+inf; make their state the dedup sentinel.
    d = torch.where(torch.isfinite(c), recv[..., 0], sp)
    return Routed(d, c, recv[..., 2].contiguous(), recv[..., 3].contiguous(), ovf)


# ---------------------------------------------------------------------------
# Sharded decode step
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardConfig:
    """Static sharded-decode parameters.

    ``frontier`` holds per-shard capacities (frontier_size = K per shard);
    beam semantics are global (cutoff from the global best), max_active
    is per-shard capacity.
    """

    frontier: FrontierConfig
    num_parts: int
    part_size: int
    route_cap: int  # per (src_rank, dst_rank) bucket capacity, emitting
    eps_route_cap: int

    @property
    def k_local(self) -> int:
        return self.frontier.frontier_size

    @property
    def k_total(self) -> int:
        return self.num_parts * self.frontier.frontier_size


def shard_config_for(
    sg, base: FrontierConfig, route_cap=None, eps_route_cap=None
) -> ShardConfig:
    """The shard config of ``base`` on ``sg``, a :class:`ShardedGraph` or
    a :class:`LocalPart` (of which only ``num_parts`` and ``part_size``
    are read)."""
    fc = base
    n = fc.num_candidates
    cap = route_cap or max(64, min(n, 2 * n // sg.num_parts))
    ne = fc.frontier_size * fc.eps_block_width + fc.eps_rem_budget
    ecap = eps_route_cap or max(64, min(ne, 2 * ne // sg.num_parts))
    return ShardConfig(
        frontier=fc,
        num_parts=sg.num_parts,
        part_size=sg.part_size,
        route_cap=cap,
        eps_route_cap=ecap,
    )


class _Shard(NamedTuple):
    """This rank's place: its model group and index, the global id of its
    first slot, and its parts' arc offsets."""

    group: object
    me: int
    my_base: int  # me * K_local
    em_off: int
    eps_off: int


def _identity_bp_g(k: int, my_base: int, device) -> torch.Tensor:
    ident = _identity_bp(k, device)
    ident[:, 0] += my_base
    return ident


def _masked_min(costs: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(costs), costs, INF).amin(dim=1)


def _flags(*xs) -> torch.Tensor:
    """Per-shard scalar flags as one int32 vector, for one MAX reduction."""
    return torch.stack([x.reshape(()) for x in xs]).to(torch.int32)


def _sharded_eps_iteration(st: StepState, cutoff_rel, pg, cfg: ShardConfig, sh: _Shard):
    """One routed epsilon relaxation over all shards."""
    fc = cfg.frontier
    K, Sp, Pn = fc.frontier_size, cfg.part_size, cfg.num_parts
    B = st.states.shape[0]
    cut = cutoff_rel[:, None]
    active = torch.isfinite(st.costs) & (st.costs <= cut)
    cand = expand_eps(st, active, pg, fc)
    ncost = torch.where(cand.cost <= cut, cand.cost, INF)
    rt = _route(cand.dst, ncost, sh.my_base + cand.src_slot, sh.eps_off + cand.arc_id,
                Sp, Pn, cfg.eps_route_cap, sh.group)
    # Incumbents first (win cost ties, like FindOrAddToken keep-existing).
    inc_slots = sh.my_base + torch.arange(K, dtype=torch.int32, device=st.states.device)
    cand_state = torch.cat([st.states, rt.state_local], dim=1)
    cand_cost = torch.cat([st.costs, rt.cost], dim=1)
    cand_slot = torch.cat([inc_slots.expand(B, K), rt.gslot], dim=1)
    cand_arc = torch.cat([torch.full((B, K), NO_ARC, dtype=torch.int32,
                                     device=st.states.device), rt.arc], dim=1)
    sel = dedup_select(cand_state, cand_cost, K, Sp)
    bp = _backpointers(sel.cand_idx, cand_slot, cand_arc)
    changed_local = ((sel.cand_idx >= 0) & (bp[..., 1] != NO_ARC)).any()
    changed = all_reduce(_flags(changed_local), "max", sh.group)[0] > 0
    ovf = rt.overflow.any() | cand.overflow.any()
    sat = (sel.num_unique > K).any()
    return StepState(sel.states, sel.costs, st.base), bp, changed, ovf, sat


def _sharded_eps_closure(st: StepState, cutoff_rel, pg, cfg: ShardConfig, sh: _Shard):
    """``eps_iters`` routed relaxations; an iteration after the last
    global change keeps the frontier and writes identity backpointers,
    selected on the device.  Returns (state, bp (B, D, K, 2), overflow,
    saturated), the flags () bool."""
    fc = cfg.frontier
    K, D = fc.frontier_size, fc.eps_iters
    B = st.states.shape[0]
    dev = st.states.device
    bps = torch.empty((B, D, K, 2), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    ovf, sat = stop, stop
    if D == 0:
        return st, bps, ovf, sat
    ident = _identity_bp_g(K, sh.my_base, dev)
    for d in range(D):
        nxt, bp, changed, o, s = _sharded_eps_iteration(st, cutoff_rel, pg, cfg, sh)
        st = StepState(*(torch.where(stop, old, new) for new, old in zip(nxt, st)))
        bps[:, d] = torch.where(stop, ident, bp)
        ovf = ovf | (~stop & o)
        sat = sat | (~stop & s)
        stop = stop | ~changed
    return st, bps, ovf, sat


def _global_cutoff(st: StepState, cfg: ShardConfig, group):
    """GetCutoff with *global* semantics over all shards' frontiers
    (`faster-decoder.cc:244-336`): beam cutoff from the global best, the
    max/min-active order statistics over the union of the per-shard
    (sorted) frontiers.  Returns (cutoff (B,), adaptive_beam (B,)).

    When neither bound can bind (max_active >= total capacity and
    min_active == 0) only the global best is exchanged; otherwise each
    shard contributes its cost prefix of length m = min(needed+1, K) —
    the global n-th smallest is always within the union of per-shard
    n+1-prefixes — through one all-gather, and the order statistics are
    read off a stable sort of the merged prefixes (keyed with -0.0 and
    +0.0 equal, as the original's sort compares them).
    """
    fc = cfg.frontier
    K = fc.frontier_size
    best = all_reduce(_masked_min(st.costs), "min", group)  # (B,)
    beam_cutoff = best + fc.beam
    if fc.max_active >= cfg.k_total and fc.min_active == 0:
        return beam_cutoff, torch.full_like(best, fc.beam)

    count = all_reduce(torch.isfinite(st.costs).sum(dim=1, dtype=torch.int32), "sum", group)
    m = int(min(max(fc.max_active, fc.min_active) + 1, K))
    merged = all_gather_cat(st.costs[:, :m].contiguous(), 1, group)  # (B, P*m)
    order = torch.sort(torch.where(merged == 0, 0.0, merged), dim=1, stable=True).indices
    merged = merged.gather(1, order)
    PM = merged.shape[1]
    max_cut = torch.where(count > fc.max_active, merged[:, min(fc.max_active, PM - 1)], INF)
    min_cut = torch.where(
        count > fc.min_active,
        best if fc.min_active == 0 else merged[:, min(fc.min_active, PM - 1)],
        INF,
    )
    use_max = max_cut < beam_cutoff
    use_min = (~use_max) & (min_cut > beam_cutoff)
    cutoff = torch.where(use_max, max_cut, torch.where(use_min, min_cut, beam_cutoff))
    adaptive = torch.where(
        use_max,
        max_cut - best + fc.beam_delta,
        torch.where(use_min, min_cut - best + fc.beam_delta, fc.beam),
    ).to(torch.float32)
    return cutoff, adaptive


def _emit_expand(st: StepState, scores_t, pg, fc: FrontierConfig, cutoff, adaptive_beam,
                 group, with_src_slot: bool):
    """K1 on the local frontier under the global cutoff, then the global
    beam filter: lanes at or above ``min over shards of min(cost) +
    adaptive_beam``.  K1's own filter, by its shard's minimum, drops only
    lanes the global one drops too, and the minimum of the shards'
    ``min + adaptive_beam`` is the global ``min + adaptive_beam`` (float
    rounding is monotonic).  Returns (expansion, costs filtered, the next
    cutoff (B,))."""
    ex = expand_filter(st.states, st.costs, cutoff, adaptive_beam, scores_t, pg, fc,
                       with_src_slot=with_src_slot)
    next_cutoff = all_reduce(ex.next_cutoff, "min", group)
    ncost = torch.where(ex.cost < next_cutoff[:, None], ex.cost, INF)
    return ex, ncost, next_cutoff


def _rebase(st: StepState, mid: StepState, frame_active, group):
    """The global rebase by the best cost, and the freeze of rows whose
    utterance has ended.  Returns (final state, the rebase (B,) with 0
    where no token lives, num_active (B,))."""
    m = all_reduce(_masked_min(mid.costs), "min", group)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    fa = frame_active
    final = StepState(
        states=torch.where(fa[:, None], mid.states, st.states),
        costs=torch.where(fa[:, None], mid.costs - m_safe[:, None], st.costs),
        base=torch.where(fa, mid.base + m_safe, st.base),
    )
    num_active = all_reduce(torch.isfinite(mid.costs).sum(dim=1, dtype=torch.int32), "sum", group)
    return final, m_safe, num_active


class ShardStepOut(NamedTuple):
    """Per-frame outputs of the sharded Viterbi frame, (B, ...) each, the
    slot axes local; stacked over a chunk they gain a leading T."""

    bp_emit: torch.Tensor  # (B, K, 2) int32 (global slot, global arc)
    bp_eps: torch.Tensor  # (B, D, K, 2) int32
    num_active: torch.Tensor  # (B,) int32, global
    best_cost: torch.Tensor  # (B,) float32, absolute
    cutoff: torch.Tensor  # (B,) float32, absolute
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool


def _sharded_frame(st: StepState, scores_t, frame_active, pg, cfg: ShardConfig, sh: _Shard):
    """One sharded frame: global GetCutoff, local expand (K1), route, local
    dedup (K6), routed eps closure, global rebase."""
    fc = cfg.frontier
    K, Sp, Pn = fc.frontier_size, cfg.part_size, cfg.num_parts
    dev = st.states.device

    cutoff, adaptive_beam = _global_cutoff(st, cfg, sh.group)
    ex, ncost, next_cutoff = _emit_expand(st, scores_t, pg, fc, cutoff, adaptive_beam,
                                          sh.group, with_src_slot=True)
    rt = _route(ex.dst, ncost, sh.my_base + ex.src_slot, sh.em_off + ex.arc_id,
                Sp, Pn, cfg.route_cap, sh.group)
    sel = dedup_select(rt.state_local, rt.cost, K, Sp)
    bp_emit = _backpointers(sel.cand_idx, rt.gslot, rt.arc)
    em_sat = (sel.num_unique > K).any()
    mid = StepState(sel.states, sel.costs, st.base)
    mid, bp_eps, eps_ovf, eps_sat = _sharded_eps_closure(mid, next_cutoff, pg, cfg, sh)
    final, m_safe, num_active = _rebase(st, mid, frame_active, sh.group)
    # Per-shard flags are OR-reduced over the model group.
    flags = all_reduce(_flags((ex.overflow | rt.overflow).any() | eps_ovf, em_sat | eps_sat),
                       "max", sh.group) > 0
    fa = frame_active
    ident = _identity_bp_g(K, sh.my_base, dev)
    out = ShardStepOut(
        bp_emit=torch.where(fa[:, None, None], bp_emit, ident),
        bp_eps=torch.where(fa[:, None, None, None], bp_eps, ident),
        num_active=torch.where(fa, num_active, 0),
        best_cost=torch.where(fa, mid.base + m_safe, st.base),
        cutoff=st.base + cutoff,
        overflow=fa & flags[0],
        saturated=fa & flags[1],
    )
    return final, out


def sharded_chunk(frame, pg, scores_tm, lengths, st0: StepState, cfg, sh: _Shard):
    """T sharded frames (``frame``: :func:`_sharded_frame` or
    :func:`_sharded_lattice_frame`) from ``st0``, the original's
    ``lax.scan`` in ``shard_map``; frames t >= lengths are no-ops.
    Returns the final state and the per-frame outputs stacked (T, B, ...)."""
    T = scores_tm.shape[0]
    st, outs = st0, None
    for t in range(T):
        st, o = frame(st, scores_tm[t], lengths > t, pg, cfg, sh)
        if outs is None:
            outs = type(o)(*(torch.empty((T,) + x.shape, dtype=x.dtype, device=x.device)
                             for x in o))
        for buf, x in zip(outs, o):
            buf[t].copy_(x)
    return st, outs


# ---------------------------------------------------------------------------
# Decoder objects
# ---------------------------------------------------------------------------


class _ShardedDecoder:
    """What both sharded decoders share: the mesh, this rank's part of the
    graph on ``device``, the padded batch and its split, the start
    frontier and the gathering of the results."""

    def __init__(self, graph: CsrGraph, config, mesh, model_axis: str, data_axis: str,
                 pad_time_to: int, device, what: str):
        if mesh is None:
            raise ValueError(f"{what} requires a mesh")
        if not isinstance(graph, CsrGraph):
            raise TypeError(f"expected a kaldi_decoder_tpu_torch CsrGraph, got {type(graph)!r}")
        self.graph = graph
        self.mesh = mesh
        self.device = check_device(mesh, device)
        self.model_axis = model_axis
        names = mesh.mesh_dim_names or ()
        self.data_axis = data_axis if data_axis in names else None
        self._model = batch_sharding(mesh, model_axis)
        self._rows = batch_sharding(mesh, self.data_axis) if self.data_axis else None
        self.pad_time_to = pad_time_to
        fc = config if config is not None else config_for_graph(graph)
        self._fc = fc
        me = self._model.part
        self._part = local_part(graph, self._model.parts, me, fc.block_width,
                                fc.eps_block_width, fc.flat_group, self.device)
        self._pg = self._part.packed
        self._sh = _Shard(
            group=self._model.group,
            me=me,
            my_base=me * fc.frontier_size,
            em_off=self._part.em_arc_offset,
            eps_off=self._part.eps_arc_offset,
        )

    def _batch(self, scores, lengths):
        """(scores, lengths, this rank's padded scores (T, Bl, V) on the
        device, its lengths (Bl,) on the device)."""
        scores = np.asarray(scores, np.float32)
        if scores.ndim == 2:
            scores = scores[None]
        B, T, _ = scores.shape
        if lengths is None:
            lengths = np.full((B,), T, np.int32)
        lengths = np.asarray(lengths, np.int32)
        Tp = max(_round_up(T, self.pad_time_to), self.pad_time_to)
        scores_tm, lengths_p = local_batch(scores, lengths, Tp, self._rows)
        return (
            scores,
            lengths,
            torch.from_numpy(scores_tm).to(self.device),
            torch.from_numpy(lengths_p).to(self.device),
        )

    def _init_state(self, batch: int) -> StepState:
        """This rank's slots of the start frontier: the start state alone,
        in slot 0 of its owner."""
        K, Sp = self._fc.frontier_size, self._part.part_size
        owner, local = divmod(self.graph.start_state, Sp)
        states = torch.zeros((batch, K), dtype=torch.int32, device=self.device)
        costs = torch.full((batch, K), INF, dtype=torch.float32, device=self.device)
        if owner == self._sh.me:
            states[:, 0] = local
            costs[:, 0] = 0.0
        return StepState(states, costs, torch.zeros((batch,), dtype=torch.float32,
                                                    device=self.device))

    def _gather(self, out: dict, slot_axes: dict, batch_axes: dict) -> dict:
        """Every rank's host arrays joined: along each field's slot axis over
        the model group (fields without one are equal on every shard), then
        along its batch axis over the data group."""
        parts = all_gather_object(out, self._sh.group)
        out = {k: (np.concatenate([p[k] for p in parts], axis=slot_axes[k])
                   if k in slot_axes else v) for k, v in out.items()}
        if self._rows is not None:
            parts = all_gather_object(out, self._rows.group)
            out = {k: (np.concatenate([p[k] for p in parts], axis=batch_axes[k])
                       if k in batch_axes else v) for k, v in out.items()}
        return out

    def _global_states(self, states: torch.Tensor) -> torch.Tensor:
        """Local state ids -> global, clamped for the last part's padding."""
        return (states + self._sh.me * self._part.part_size).clamp(max=self.graph.num_states - 1)


class ShardedViterbiDecoder(_ShardedDecoder):
    """Best-path decoder over a state-sharded graph on a device mesh.

    ``mesh`` must have a ``model`` dimension (P = its size); an optional
    ``data`` dimension splits the utterance batch as well.  Every rank of
    the mesh constructs the decoder and calls ``decode`` with the same
    arguments, and every rank gets the whole result.  Host-side results
    reuse :class:`ViterbiResult` — backpointers use global slot ids.
    """

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        mesh=None,
        model_axis: str = "model",
        data_axis: str = "data",
        route_cap: Optional[int] = None,
        pad_time_to: int = 32,
        *,
        device,
    ):
        super().__init__(graph, config, mesh, model_axis, data_axis, pad_time_to, device,
                         "ShardedViterbiDecoder")
        self.cfg = shard_config_for(self._part, self._fc, route_cap=route_cap)

    # Effective result config: global frontier of K_total slots.
    def _result_cfg(self) -> FrontierConfig:
        return dataclasses.replace(self.cfg.frontier, frontier_size=self.cfg.k_total)

    def decode(self, scores: np.ndarray, lengths: Optional[np.ndarray] = None):
        from kaldi_decoder_tpu_torch.decoders.viterbi import ViterbiResult

        scores, lengths, scores_tm, lengths_dev = self._batch(scores, lengths)
        cut = torch.full((scores_tm.shape[1],), INF, dtype=torch.float32, device=self.device)
        st0, bp_init, _, _ = _sharded_eps_closure(
            self._init_state(scores_tm.shape[1]), cut, self._pg, self.cfg, self._sh
        )
        stf, outs = sharded_chunk(_sharded_frame, self._pg, scores_tm, lengths_dev, st0,
                                  self.cfg, self._sh)
        out = dict(
            bp_init=bp_init[0].cpu().numpy(),  # the init closure is batch-invariant
            bp_emit=outs.bp_emit.cpu().numpy(),
            bp_eps=outs.bp_eps.cpu().numpy(),
            frontier_states=self._global_states(stf.states).cpu().numpy(),
            frontier_costs=(stf.base[:, None] + stf.costs).cpu().numpy(),
            num_active=outs.num_active.cpu().numpy(),
            best_costs=outs.best_cost.cpu().numpy(),
            cutoffs=outs.cutoff.cpu().numpy(),
            overflows=outs.overflow.cpu().numpy(),
            saturations=outs.saturated.cpu().numpy(),
        )
        out = self._gather(
            out,
            slot_axes=dict(bp_init=1, bp_emit=2, bp_eps=3, frontier_states=1,
                           frontier_costs=1),
            batch_axes=dict(bp_emit=1, bp_eps=1, frontier_states=0, frontier_costs=0,
                            num_active=1, best_costs=1, cutoffs=1, overflows=1,
                            saturations=1),
        )
        return ViterbiResult(graph=self.graph, cfg=self._result_cfg(), scores=scores,
                             lengths=lengths, **out)


# ---------------------------------------------------------------------------
# Sharded lattice decoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLatticeConfig:
    """ShardConfig + per-shard record budgets (lattice_dev analogue)."""

    shard: ShardConfig
    em_records: int  # per shard: frontier winners + slack-selected extras
    eps_records: int  # per shard, per eps iteration
    lattice_beam: float = 10.0


def shard_lattice_config_for(
    sg,
    base: FrontierConfig,
    lattice_beam: float,
    em_records=None,
    eps_records=None,
    route_cap=None,
    eps_route_cap=None,
) -> ShardLatticeConfig:
    sc = shard_config_for(sg, base, route_cap, eps_route_cap)
    K = sc.k_local
    em_r = em_records or (K + max(512, 2048 // sg.num_parts))
    eps_r = eps_records or max(64, (sc.num_parts * sc.eps_route_cap) // 4)
    return ShardLatticeConfig(
        shard=sc,
        em_records=int(em_r),
        eps_records=int(eps_r),
        lattice_beam=float(lattice_beam),
    )


def _sharded_lattice_eps_iteration(st: StepState, cutoff_rel, pg, cfg: ShardLatticeConfig,
                                   sh: _Shard):
    """Routed epsilon relaxation emitting (global src_state, global arc)
    link records: the routed lanes after the K incumbents go through K2's
    eps call, which carries each lane's (source state, arc) into its
    records (the original maps record indices back through
    ``_rec_from_idx``); they are the winners' links first, then extras by
    slack, then -1 rows.  The original compacts the link rows of its
    ``K + eps_records`` records into ``eps_records`` rows, keeping the
    earliest; the link rows being a prefix, that is the first
    ``eps_records`` rows."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp, Pn = fc.frontier_size, sc.part_size, sc.num_parts
    B = st.states.shape[0]
    dev = st.states.device
    cut = cutoff_rel[:, None]
    active = torch.isfinite(st.costs) & (st.costs <= cut)
    cand = expand_eps(st, active, pg, fc)
    ncost = torch.where(cand.cost <= cut, cand.cost, INF)
    # Route (dst, cost, GLOBAL src state, global arc): the lattice needs
    # source states, not slots.
    src_state_g = torch.where(
        torch.isfinite(ncost), st.states.gather(1, cand.src_slot.long()) + sh.me * Sp, 0
    )
    sb = cfg.lattice_beam + 1e-4
    rt = _route(cand.dst, ncost, src_state_g, sh.eps_off + cand.arc_id, Sp, Pn,
                sc.eps_route_cap, sh.group, local_slack_beam=sb)
    cand_state = torch.cat([st.states, rt.state_local], dim=1)
    cand_cost = torch.cat([st.costs, rt.cost], dim=1)
    no_link = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    sel = dedup_select_rec(
        cand_state, cand_cost, K, Sp, K + cfg.eps_records, sb,
        payload=(torch.cat([no_link, rt.gslot], dim=1), torch.cat([no_link, rt.arc], dim=1)),
        num_incumbents=K,
    )
    is_link = sel.records[..., 2] >= 0  # the record's destination, -1 on padding
    rec = sel.records[:, : cfg.eps_records, :2]
    changed_local = ((sel.cand_idx >= K) & torch.isfinite(sel.costs)).any()
    changed = all_reduce(_flags(changed_local), "max", sh.group)[0] > 0
    # Spill: eligible links beyond the eps_records rows are dropped by the
    # compaction above — record overflow, flagged.
    spill = (is_link.sum(dim=1) > cfg.eps_records).any()
    ovf = rt.overflow.any() | cand.overflow.any() | sel.rec_overflow.any() | spill
    sat = (sel.num_unique > K).any()
    return StepState(sel.states, sel.costs, st.base), rec, changed, ovf, sat


def _sharded_lattice_eps_closure(st: StepState, cutoff_rel, pg, cfg: ShardLatticeConfig,
                                 sh: _Shard):
    """``eps_iters`` record-emitting routed relaxations, the iterations
    after the last global change discarded on the device.  Returns (state,
    records (B, D, R_eps, 2), overflow, saturated)."""
    D = cfg.shard.frontier.eps_iters
    B = st.states.shape[0]
    dev = st.states.device
    recs = torch.full((B, D, cfg.eps_records, 2), -1, dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    ovf, sat = stop, stop
    for d in range(D):
        nxt, rec, changed, o, s = _sharded_lattice_eps_iteration(st, cutoff_rel, pg, cfg, sh)
        st = StepState(*(torch.where(stop, old, new) for new, old in zip(nxt, st)))
        recs[:, d] = torch.where(stop, -1, rec)
        ovf = ovf | (~stop & o)
        sat = sat | (~stop & s)
        stop = stop | ~changed
    return st, recs, ovf, sat


class ShardLatticeStepOut(NamedTuple):
    """Per-frame outputs of the sharded lattice frame, (B, ...) each, the
    record and slot axes local; stacked over a chunk they gain a leading T."""

    em_records: torch.Tensor  # (B, R_em, 2) (global src state, global arc)
    eps_records: torch.Tensor  # (B, D, R_eps, 2)
    frontier_states: torch.Tensor  # (B, K) local state ids
    frontier_costs: torch.Tensor  # (B, K) absolute costs
    num_active: torch.Tensor  # (B,) int32, global
    cutoff: torch.Tensor  # (B,) float32
    overflow: torch.Tensor  # (B,) bool
    saturated: torch.Tensor  # (B,) bool


def _sharded_lattice_frame(st: StepState, scores_t, frame_active, pg, cfg: ShardLatticeConfig,
                           sh: _Shard):
    """One sharded lattice frame: global GetCutoff, expand (K1), route
    with source states, per-shard dedup + slack-selected records (K2),
    routed record-emitting eps closure, global rebase."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp, Pn = fc.frontier_size, sc.part_size, sc.num_parts

    cutoff, adaptive_beam = _global_cutoff(st, sc, sh.group)
    ex, ncost, next_cutoff = _emit_expand(st, scores_t, pg, fc, cutoff, adaptive_beam,
                                          sh.group, with_src_slot=False)
    # K1's src_state is the source slot's state on every lane of an active
    # slot, so on every finite lane.
    src_state_g = torch.where(torch.isfinite(ncost), ex.src_state + sh.me * Sp, 0)
    sb = cfg.lattice_beam + 1e-4
    rt = _route(ex.dst, ncost, src_state_g, sh.em_off + ex.arc_id, Sp, Pn, sc.route_cap,
                sh.group, local_slack_beam=sb)
    # K2 carries each lane's (source state, arc) into its records, what
    # the original's ``_rec_from_idx`` does with record indices.
    sel = dedup_select_rec(rt.state_local, rt.cost, K, Sp, cfg.em_records, sb,
                           payload=(rt.gslot, rt.arc))
    em_rec = sel.records[..., :2]
    em_sat = (sel.num_unique > K).any()
    em_ovf = rt.overflow.any() | ex.overflow.any() | sel.rec_overflow.any()

    mid = StepState(sel.states, sel.costs, st.base)
    mid, eps_recs, eps_ovf, eps_sat = _sharded_lattice_eps_closure(mid, next_cutoff, pg, cfg, sh)
    final, _, num_active = _rebase(st, mid, frame_active, sh.group)
    flags = all_reduce(_flags(em_ovf | eps_ovf, em_sat | eps_sat), "max", sh.group) > 0
    fa = frame_active
    out = ShardLatticeStepOut(
        em_records=torch.where(fa[:, None, None], em_rec, -1),
        eps_records=torch.where(fa[:, None, None, None], eps_recs, -1),
        frontier_states=final.states,
        frontier_costs=final.base[:, None] + final.costs,
        num_active=torch.where(fa, num_active, 0),
        cutoff=st.base + cutoff,
        overflow=fa & flags[0],
        saturated=fa & flags[1],
    )
    return final, out


class ShardedLatticeDecoder(_ShardedDecoder):
    """Lattice-generating decoder over a state-sharded graph (the sharded
    LatticeFasterDecoder capability: lattice generation + global
    adaptive-beam/max-active pruning).

    Every rank of the mesh constructs the decoder and calls ``decode`` with
    the same arguments, and every rank gets the whole result.  Host-side
    results reuse :class:`..decoders.lattice.LatticeResult` unchanged:
    records carry global (state, arc) ids and per-frame frontiers are
    concatenated across shards.
    """

    def __init__(
        self,
        graph: CsrGraph,
        config: Optional[FrontierConfig] = None,
        lattice_beam: float = 10.0,
        mesh=None,
        model_axis: str = "model",
        data_axis: str = "data",
        em_records: Optional[int] = None,
        eps_records: Optional[int] = None,
        route_cap: Optional[int] = None,
        pad_time_to: int = 32,
        *,
        device,
    ):
        super().__init__(graph, config, mesh, model_axis, data_axis, pad_time_to, device,
                         "ShardedLatticeDecoder")
        self.lattice_beam = float(lattice_beam)
        self.cfg = shard_lattice_config_for(
            self._part, self._fc, lattice_beam, em_records, eps_records, route_cap
        )

    def decode(self, scores: np.ndarray, lengths: Optional[np.ndarray] = None):
        from kaldi_decoder_tpu_torch.decoders.lattice import LatticeResult
        from kaldi_decoder_tpu_torch.decoders.lattice_dev import LatticeDevConfig

        scores, lengths, scores_tm, lengths_dev = self._batch(scores, lengths)
        cut = torch.full((scores_tm.shape[1],), INF, dtype=torch.float32, device=self.device)
        st0, init_recs, _, _ = _sharded_lattice_eps_closure(
            self._init_state(scores_tm.shape[1]), cut, self._pg, self.cfg, self._sh
        )
        _, outs = sharded_chunk(_sharded_lattice_frame, self._pg, scores_tm, lengths_dev, st0,
                                self.cfg, self._sh)
        out = dict(
            init_states=self._global_states(st0.states[0]).cpu().numpy(),
            init_costs=(st0.base[0] + st0.costs[0]).cpu().numpy(),
            init_eps_records=init_recs[0].cpu().numpy(),
            frame_states=self._global_states(outs.frontier_states).cpu().numpy(),
            frame_costs=outs.frontier_costs.cpu().numpy(),
            em_records=outs.em_records.cpu().numpy(),
            eps_records=outs.eps_records.cpu().numpy(),
            num_active=outs.num_active.cpu().numpy(),
            cutoffs=outs.cutoff.cpu().numpy(),
            overflows=outs.overflow.cpu().numpy(),
            saturations=outs.saturated.cpu().numpy(),
        )
        out = self._gather(
            out,
            slot_axes=dict(init_states=0, init_costs=0, init_eps_records=1, frame_states=2,
                           frame_costs=2, em_records=2, eps_records=3),
            batch_axes=dict(frame_states=1, frame_costs=1, em_records=1, eps_records=1,
                            num_active=1, cutoffs=1, overflows=1, saturations=1),
        )
        sc = self.cfg.shard
        result_cfg = LatticeDevConfig(
            frontier=dataclasses.replace(sc.frontier, frontier_size=sc.k_total),
            em_records=sc.num_parts * self.cfg.em_records,
            eps_records=sc.num_parts * self.cfg.eps_records,
            lattice_beam=self.lattice_beam,
        )
        return LatticeResult(
            graph=self.graph,
            cfg=result_cfg,
            lattice_beam=self.lattice_beam,
            scores=scores,
            lengths=lengths,
            fold=None,
            **out,
        )
