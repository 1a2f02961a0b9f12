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

On a card the frame runs the port's hand-written kernels at shard
shapes: K1 (``kernels.expand.expand_filter``, the ``src_slot`` variant on
the Viterbi path, the lattice variant on the lattice path) on the local
frontier; K7 (``kernels.route``: ``route_send`` before each
``all_to_all``, with the global beam filter and the payload's global
offsets folded in, ``route_recv`` after the emitting call's); K6
(``kernels.dedup.dedup_select``) on the routed lanes, ``P * route_cap``
wide with ``part_size`` states, and again each eps iteration on the K
incumbents and the received buffer, read in place
(``kernels.route.RoutedLanes``: no receive launch); K2
(``kernels.dedup_rec.dedup_select_rec``) on the routed lanes and, with
``num_incumbents = K``, each eps iteration of the lattice path, read in
place too; K5
(``kernels.eps.expand_eps_lanes``, without incumbents) gives each eps
iteration's lanes; the eps step's shard mode
(``kernels.eps.eps_step_shard``) closes each eps iteration (the
backpointers or links, the batch-wide stop, the carry, the local
``changed`` and, at the last, the frame's local values that the rebase
reduces; with no eps iterations, as on a graph without eps arcs, the
emitting K6 or K2 call writes those values as its last step, its
``reduce``);
K3's shard mode (``kernels.frame.frame_tail_shard``) ends the
frame (the rebase, the freeze, every output into row t of the chunk's
stacked buffers, ``t`` on the device, and the next frame's local half of
GetCutoff); :func:`_global_cutoff` opens each frame with K8's collectives
and its merge (``kernels.cutoff.global_cutoff_merge``), on the local half
that K3's shard mode wrote (a chunk's first frame reads the one its
first-frame mode wrote).  Between them run only the collectives, whose
kinds, order and number a frame are the original's.

A chunk runs on the static buffers of a sharded frame driver
(:mod:`kaldi_decoder_tpu_torch.parallel.shard_driver`, kept across
decodes): K3's shard mode's first-frame mode
(``kernels.frame.frame_start_shard``) loads the chunk's start state,
lengths and scores row 0 and its output pointers and writes K8's local
half of the start state, one launch a chunk, and under NCCL on a
card every frame after a driver's first is replayed from one captured
CUDA graph, the counterpart of the original's ``lax.scan``; over gloo
and on the CPU the same frame runs from the host loop.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    FrontierConfig,
    StepState,
    config_for_graph,
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
from kaldi_decoder_tpu_torch.kernels.cutoff import (
    CutoffLocal,
    empty_cutoff,
    empty_cutoff_local,
    global_cutoff_local,
    global_cutoff_merge,
)
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.eps import (
    ShardEpsCarry,
    empty_shard_eps_carry,
    eps_step_shard,
    expand_eps_lanes,
)
from kaldi_decoder_tpu_torch.kernels.expand import expand_filter
from kaldi_decoder_tpu_torch.kernels.frame import (
    FrameIO,
    ShardSlots,
    ShardTailInputs,
    empty_shard_outs,
    frame_start_shard,
    frame_tail_shard,
)
from kaldi_decoder_tpu_torch.kernels.route import (
    RoutedLanes,
    empty_route_lanes,
    empty_route_send,
    route_recv,
    route_send,
)
from kaldi_decoder_tpu_torch.parallel.mesh import (
    all_gather_into,
    all_gather_object,
    all_reduce,
    all_to_all,
    batch_sharding,
    check_device,
    local_batch,
)
from kaldi_decoder_tpu_torch.parallel import shard_driver
from kaldi_decoder_tpu_torch.parallel.shard_driver import ShardDriver, driver_for

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
# Token routing (K7)
# ---------------------------------------------------------------------------


class Routed(NamedTuple):
    """Per-rank receive buffers after the all_to_all (flattened P*C, after
    the incumbents when the call had them)."""

    state_local: torch.Tensor  # (B, P*C) int32, Sp == invalid sentinel
    cost: torch.Tensor  # (B, P*C) float32, +inf invalid
    gslot: torch.Tensor  # (B, P*C) int32 global source slot (or state)
    arc: torch.Tensor  # (B, P*C) int32 global arc id
    overflow: torch.Tensor  # (B,) bool — a (src, dst) bucket overflowed


class RoutedEps(NamedTuple):
    """An eps iteration's receive: the K incumbents and the received
    buffer, which its dedup call reads in place."""

    lanes: RoutedLanes
    overflow: torch.Tensor  # (B,) bool — a (src, dst) bucket overflowed


def _route(dst_g, cost, gslot, arc_g, sp: int, num_parts: int, cap: int, group,
           local_slack_beam: Optional[float] = None, *, cutoff=None, slot_states=None,
           slot_add: int = 0, arc_add: int = 0, incumbents=None, inc_slot_base=None,
           bufs: Optional[dict] = None, key: str = ""):
    """K7: bucket the lanes by owner rank (``kernels.route.route_send``,
    with the beam filter ``cutoff`` and the payload offsets folded in),
    exchange them over ``group`` with one ``all_to_all`` of the four
    columns, and lay out what arrived for the dedup call
    (``route_recv``): a :class:`Routed`.  With ``incumbents`` ((states,
    costs), slots ``inc_slot_base + k`` or -1: an eps iteration) no
    layout: a :class:`RoutedEps`, which the dedup call reads in place.  On
    a card ``bufs`` keeps the buffers of each call site ``key``, made at
    its first call: the send buffer, the received one and the laid-out
    lanes."""
    out = (None, None, None)
    if bufs is not None and dst_g.is_cuda:
        if key not in bufs:
            B, N = dst_g.shape
            send = empty_route_send(B, N, num_parts, cap, dst_g.device)
            bufs[key] = (send, torch.empty_like(send.buf),
                         None if incumbents is not None
                         else empty_route_lanes(B, num_parts * cap, dst_g.device))
        out = bufs[key]
    send = route_send(dst_g, cost, gslot, arc_g, sp, num_parts, cap, local_slack_beam, cutoff,
                      slot_states, slot_add, arc_add, out=out[0])
    recv = all_to_all(send.buf, group, out=out[1])  # (P, B, cap, 4): slice p from rank p
    if incumbents is not None:
        return RoutedEps(RoutedLanes(recv, sp, *incumbents, inc_slot_base), send.overflow)
    return Routed(*route_recv(recv, sp, out=out[2]), send.overflow)


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


class _Shard(NamedTuple):
    """This rank's place: its model group and index, the global id of its
    first slot, and its parts' arc offsets."""

    group: object
    me: int
    my_base: int  # me * K_local
    em_off: int
    eps_off: int


class _Bufs(NamedTuple):
    """A sharded frame's static buffers, kept by its driver across decodes:
    on a card each route call site's (made at its first call), the eps
    closure's carry, the slots (the carried frontier, the chunk's row
    lengths, K1's scores row and K3's table: ``kernels.frame.ShardSlots``),
    K8's (the local half that each frame's GetCutoff reads, written by the
    first-frame mode, then by K3's shard mode, :func:`_local_half`; on a
    card the merge's) and on a card each collective call site's output
    (made at its first call, :func:`_kept`)."""

    routes: dict
    carry: ShardEpsCarry
    slots: ShardSlots
    cutoff: dict
    coll: dict


def _bufs(sc: ShardConfig, batch: int, eps_width: int, width: int, device) -> _Bufs:
    """The buffers of a frame of ``batch`` rows of scores ``width`` wide,
    its eps closure keeping ``eps_width`` backpointers (K) or links
    (eps_records) an iteration."""
    return _Bufs({}, empty_shard_eps_carry(batch, sc.frontier.eps_iters, eps_width, device),
                 ShardSlots(batch, sc.frontier.frontier_size, width, device), {}, {})


def _kept(bufs: Optional[_Bufs], key: str, x: torch.Tensor) -> Optional[torch.Tensor]:
    """On a card, the output buffer of the collective call site ``key`` (of
    ``x``'s shape and type, made at its first call); else None (a new
    tensor a call)."""
    if bufs is None or not x.is_cuda:
        return None
    out = bufs.coll.get(key)
    if out is None:
        out = bufs.coll[key] = torch.empty_like(x, memory_format=torch.contiguous_format)
    return out


def _sharded_eps_iteration(st: StepState, cutoff_rel, pg, cfg: ShardConfig, sh: _Shard,
                           bufs: _Bufs):
    """One routed epsilon relaxation: K5's lanes, routed (K7), K6 on the K
    incumbents first (they win cost ties, like FindOrAddToken
    keep-existing) and the received lanes, read in place.  Returns (the
    selection, the :class:`RoutedEps`, K5's overflow)."""
    fc = cfg.frontier
    cand = expand_eps_lanes(st.states, st.costs, cutoff_rel, pg, fc, incumbents=False,
                            with_src_state=False)
    rt = _route(cand.dst, cand.cost, cand.src_slot, cand.arc_id, cfg.part_size,
                cfg.num_parts, cfg.eps_route_cap, sh.group, slot_add=sh.my_base,
                arc_add=sh.eps_off, incumbents=(st.states, st.costs), inc_slot_base=sh.my_base,
                bufs=bufs.routes, key="eps")
    sel = dedup_select(None, None, fc.frontier_size, cfg.part_size, routed=rt.lanes)
    return sel, rt, cand.overflow


def _sharded_lattice_eps_iteration(st: StepState, cutoff_rel, pg, cfg: "ShardLatticeConfig",
                                   sh: _Shard, bufs: _Bufs):
    """Routed epsilon relaxation emitting (global src_state, global arc)
    link records: the routed lanes (their payload the source slot's state
    as a global id: the lattice needs source states, not slots) after the
    K incumbents go through K2's eps call, read in place, which carries
    each lane's (source state, arc) into its records (the original maps record
    indices back through ``_rec_from_idx``); they are the winners' links
    first, then extras by slack, then -1 rows.  The original compacts the
    link rows of its ``K + eps_records`` records into ``eps_records``
    rows, keeping the earliest; the link rows being a prefix, the eps
    step keeps the first ``eps_records`` rows."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp = fc.frontier_size, sc.part_size
    cand = expand_eps_lanes(st.states, st.costs, cutoff_rel, pg, fc, incumbents=False,
                            with_src_state=False)
    sb = cfg.lattice_beam + 1e-4
    rt = _route(cand.dst, cand.cost, cand.src_slot, cand.arc_id, Sp, sc.num_parts,
                sc.eps_route_cap, sh.group, local_slack_beam=sb, slot_states=st.states,
                slot_add=sh.me * Sp, arc_add=sh.eps_off, incumbents=(st.states, st.costs),
                bufs=bufs.routes, key="eps")
    sel = dedup_select_rec(None, None, K, Sp, K + cfg.eps_records, sb, None, num_incumbents=K,
                           routed=rt.lanes)
    return sel, rt, cand.overflow


def _sharded_eps_closure(iteration, st: StepState, sc: ShardConfig, sh: _Shard, bufs: _Bufs,
                         em_overflow=(), em_num_unique=None, reduce: bool = False):
    """``eps_iters`` routed relaxations (``iteration(st)``: the 1-best or
    the lattice one) of the frontier ``st``, which the eps step
    (``kernels.eps.eps_step_shard``) updates in place; an iteration after
    the last global change keeps the frontier and writes identity
    backpointers or -1 links, selected on the device (``changed`` is
    reduced with MAX over ``sh.group`` after every step, never read by
    the host).  With ``reduce`` the last step also writes the frame's
    local values (best cost, finite count, the flag pair with the
    emitting call's ``em_overflow`` and ``em_num_unique`` folded in); with
    no iterations (D = 0) the emitting call has written them
    (:func:`_em_reduce`).  Returns the carry, whose ``out`` (B, D, width,
    2) holds every iteration's backpointers or links."""
    D = sc.frontier.eps_iters
    carry = bufs.carry
    red = None
    for d in range(D):
        sel, rt, exp_overflow = iteration(st)
        first = d == 0
        eps_step_shard(d, carry, st.states, st.costs, sel, exp_overflow, rt.overflow, red,
                       sh.my_base, lanes=rt.lanes, em_overflow=em_overflow if first else (),
                       em_num_unique=em_num_unique if first else None,
                       reduce=reduce and d == D - 1)
        red = all_reduce(carry.changed, "max", sh.group, out=_kept(bufs, "changed", carry.changed))
    return carry


def _em_reduce(sc: ShardConfig, bufs: _Bufs, em_overflow):
    """The emitting dedup call's ``reduce``: with no eps iterations (no
    eps step to write them) the frame's local values into the closure's
    carry, the emitting overflow flags ``em_overflow`` folded in; else
    None."""
    return None if sc.frontier.eps_iters else (bufs.carry, em_overflow)


def _cutoff_m(cfg: ShardConfig) -> Tuple[bool, int]:
    """(GetCutoff's early return: neither bound can bind, m): each shard's
    prefix of m = min(needed + 1, K) costs holds the global n-th smallest
    (1 where nothing is gathered)."""
    fc = cfg.frontier
    early = fc.max_active >= cfg.k_total and fc.min_active == 0
    return early, 1 if early else int(min(max(fc.max_active, fc.min_active) + 1,
                                          fc.frontier_size))


def _local_half(cfg: ShardConfig, bufs: _Bufs, batch: int, device) -> CutoffLocal:
    """The buffers of K8's local half that each frame's GetCutoff reads
    (``bufs.cutoff["local"]``, made at a driver's first chunk), which the
    first-frame mode writes from a chunk's start state and each frame's
    K3 shard mode for the next frame.  Its prefix is None where m is K
    (the all-gather reads the costs) or nothing is gathered.  On a card
    K8's merge buffers are made beside it."""
    loc = bufs.cutoff.get("local")
    if loc is None:
        early, m = _cutoff_m(cfg)
        loc = empty_cutoff_local(batch, m, device)
        if early or m >= cfg.frontier.frontier_size:
            loc = loc._replace(prefix=None)
        bufs.cutoff["local"] = loc
        if torch.device(device).type == "cuda":
            bufs.cutoff.update(out=empty_cutoff(batch, device),
                               merged=torch.empty((cfg.num_parts, batch, m),
                                                  dtype=torch.float32, device=device))
    return loc


def _global_cutoff(st: StepState, cfg: ShardConfig, group, bufs: Optional[_Bufs] = None):
    """GetCutoff with *global* semantics over all shards' frontiers
    (`faster-decoder.cc:244-336`): beam cutoff from the global best, the
    max/min-active order statistics over the union of the per-shard
    (sorted) frontiers.  Returns (cutoff (B,), adaptive_beam (B,)).

    The local half (each row's best cost, finite count and cost prefix of
    length m, :func:`_cutoff_m`) is ``bufs.cutoff["local"]``, which the
    first-frame mode and then each frame's K3 shard mode write (K8's
    local half on ``st`` without ``bufs``); the best is reduced (MIN) over
    ``group`` and, unless neither bound can bind, the count (SUM) and the
    prefixes (one all-gather, of the costs themselves where m is K); K8's
    merge then reads the order statistics off the merged prefixes and
    takes GetCutoff's branch.
    """
    fc = cfg.frontier
    early, m = _cutoff_m(cfg)
    out = bufs.cutoff if bufs is not None else {}
    loc = out.get("local")
    if loc is None:
        loc = global_cutoff_local(st.costs, m)
    best = all_reduce(loc.best, "min", group, out=_kept(bufs, "best", loc.best))  # (B,)
    count = merged = None
    if not early:
        count = all_reduce(loc.count, "sum", group, out=_kept(bufs, "count", loc.count))
        prefix = loc.prefix if loc.prefix is not None else st.costs
        merged = all_gather_into(prefix, out.get("merged"), group)  # (P, B, m)
    return global_cutoff_merge(best, count, merged, fc.beam, fc.beam_delta, fc.max_active,
                               fc.min_active, out=out.get("out"))


def _emit_expand(st: StepState, scores_t, pg, fc: FrontierConfig, cutoff, adaptive_beam,
                 group, with_src_slot: bool, bufs: Optional[_Bufs] = None):
    """K1 on the local frontier under the global cutoff, and the global
    beam filter's cutoff: ``min over shards of min(cost) +
    adaptive_beam``, which the route applies (lanes at or above it go
    +inf).  K1's own filter, by its shard's minimum, drops only lanes the
    global one drops too, and the minimum of the shards' ``min +
    adaptive_beam`` is the global ``min + adaptive_beam`` (float rounding
    is monotonic).  Returns (expansion, the next cutoff (B,))."""
    ex = expand_filter(st.states, st.costs, cutoff, adaptive_beam, scores_t, pg, fc,
                       with_src_slot=with_src_slot)
    return ex, all_reduce(ex.next_cutoff, "min", group,
                          out=_kept(bufs, "next_cutoff", ex.next_cutoff))


def _reduced(carry: ShardEpsCarry, group, bufs: Optional[_Bufs] = None):
    """The rebase's reductions over ``group`` of the eps closure's local
    values: the global best cost (MIN), the global finite count (SUM) and
    the frame's flags (MAX)."""
    return tuple(all_reduce(x, op, group, out=_kept(bufs, key, x)) for x, op, key in (
        (carry.red_min, "min", "red_min"), (carry.red_count, "sum", "red_count"),
        (carry.red_flags, "max", "red_flags")))


def _sharded_frame(pg, cfg: ShardConfig, sh: _Shard, bufs: _Bufs):
    """One sharded frame on the slots ``bufs.slots``: global GetCutoff,
    local expand (K1) of the scores row, route (K7), local dedup (K6),
    routed eps closure, global rebase by K3's shard mode, which updates
    the slots' state, writes row t of the chunk's outputs, the next
    frame's local half of GetCutoff and scores row."""
    fc = cfg.frontier
    K, Sp, Pn = fc.frontier_size, cfg.part_size, cfg.num_parts
    s = bufs.slots
    st = s.state

    cutoff, adaptive_beam = _global_cutoff(st, cfg, sh.group, bufs)
    ex, next_cutoff = _emit_expand(st, s.scores_t, pg, fc, cutoff, adaptive_beam, sh.group,
                                   with_src_slot=True, bufs=bufs)
    rt = _route(ex.dst, ex.cost, ex.src_slot, ex.arc_id, Sp, Pn, cfg.route_cap, sh.group,
                cutoff=next_cutoff, slot_add=sh.my_base, arc_add=sh.em_off, bufs=bufs.routes,
                key="em")
    sel = dedup_select(rt.state_local, rt.cost, K, Sp,
                       reduce=_em_reduce(cfg, bufs, (ex.overflow, rt.overflow)))
    mid = StepState(sel.states, sel.costs, st.base)
    carry = _sharded_eps_closure(
        lambda s: _sharded_eps_iteration(s, next_cutoff, pg, cfg, sh, bufs), mid, cfg, sh, bufs,
        em_overflow=(ex.overflow, rt.overflow), em_num_unique=sel.num_unique, reduce=True)
    best, num_active, flags = _reduced(carry, sh.group, bufs)
    tin = ShardTailInputs(mid.states, mid.costs, best, num_active, flags, cand_idx=sel.cand_idx,
                          gslot=rt.gslot, arc=rt.arc, bp_eps=carry.out, red_min=carry.red_min,
                          red_count=carry.red_count)
    frame_tail_shard(s, cutoff, tin, sh.my_base, local=bufs.cutoff["local"])


def _sharded_lattice_frame(pg, cfg: ShardLatticeConfig, sh: _Shard, bufs: _Bufs):
    """One sharded lattice frame on the slots ``bufs.slots``: global
    GetCutoff, expand (K1), route (K7) with source states, per-shard dedup
    + slack-selected records (K2), routed record-emitting eps closure,
    global rebase by K3's shard mode."""
    sc = cfg.shard
    fc = sc.frontier
    K, Sp, Pn = fc.frontier_size, sc.part_size, sc.num_parts
    s = bufs.slots
    st = s.state

    cutoff, adaptive_beam = _global_cutoff(st, sc, sh.group, bufs)
    ex, next_cutoff = _emit_expand(st, s.scores_t, pg, fc, cutoff, adaptive_beam, sh.group,
                                   with_src_slot=False, bufs=bufs)
    # K1's src_state is the source slot's state on every lane of an active
    # slot, so on every finite lane.
    sb = cfg.lattice_beam + 1e-4
    rt = _route(ex.dst, ex.cost, ex.src_state, ex.arc_id, Sp, Pn, sc.route_cap, sh.group,
                local_slack_beam=sb, cutoff=next_cutoff, slot_add=sh.me * Sp, arc_add=sh.em_off,
                bufs=bufs.routes, key="em")
    # K2 carries each lane's (source state, arc) into its records, what
    # the original's ``_rec_from_idx`` does with record indices.
    sel = dedup_select_rec(rt.state_local, rt.cost, K, Sp, cfg.em_records, sb,
                           payload=(rt.gslot, rt.arc),
                           reduce=_em_reduce(sc, bufs, (rt.overflow, ex.overflow)))
    mid = StepState(sel.states, sel.costs, st.base)
    carry = _sharded_eps_closure(
        lambda s: _sharded_lattice_eps_iteration(s, next_cutoff, pg, cfg, sh, bufs), mid, sc, sh,
        bufs, em_overflow=(rt.overflow, ex.overflow, sel.rec_overflow),
        em_num_unique=sel.num_unique, reduce=True)
    best, num_active, flags = _reduced(carry, sh.group, bufs)
    tin = ShardTailInputs(mid.states, mid.costs, best, num_active, flags,
                          em_records=sel.records, eps_records=carry.out, red_min=carry.red_min,
                          red_count=carry.red_count)
    frame_tail_shard(s, cutoff, tin, sh.my_base, local=bufs.cutoff["local"])


def _pg_ids(pg) -> tuple:
    """The ids of a rank's packed tables: the part of a kept driver's key
    that names the decoder it decodes for."""
    return tuple(id(x) for x in pg)


def frame_driver(lattice: bool, pg, cfg, sh: _Shard, batch: int, width: int,
                 device) -> ShardDriver:
    """The kept sharded frame driver of these arguments (the lattice frame
    when ``lattice``, ``cfg`` a :class:`ShardLatticeConfig`; else the
    1-best frame), or a new one: its buffers for ``batch`` rows of scores
    ``width`` wide on ``device``, its frame over ``sh.group``."""
    dev = torch.device(device)
    sc = cfg.shard if lattice else cfg
    key = (lattice, _pg_ids(pg), cfg, id(sh.group), tuple(sh[1:]), batch, width, str(dev))

    def make():
        bufs = _bufs(sc, batch, cfg.eps_records if lattice else sc.k_local, width, dev)
        frame = _sharded_lattice_frame if lattice else _sharded_frame
        # The driver holds pg and sh (in its frame), so the ids in its key
        # stay theirs.
        return ShardDriver(lambda: frame(pg, cfg, sh, bufs), bufs, (sh.group,), dev, batch,
                           sc.part_size)
    return driver_for(key, make)


def sharded_chunk(drv: ShardDriver, scores_tm, lengths, st0: StepState, cfg):
    """T sharded frames from ``st0`` on the driver ``drv``'s buffers, the
    original's ``lax.scan`` in ``shard_map``; frames t >= lengths are
    no-ops.  K3's shard mode's first-frame mode loads the chunk into the
    slots and writes K8's local half of its start state; each frame's K3
    shard mode writes the frame's outputs into row t of the chunk's
    stacked buffers, the next frame's local half of GetCutoff and scores
    row.  Returns the final state (a copy) and the per-frame outputs
    stacked (T, B, ...)."""
    T, B = scores_tm.shape[:2]
    lattice = isinstance(cfg, ShardLatticeConfig)
    sc = cfg.shard if lattice else cfg
    fc = sc.frontier
    bufs = drv.bufs
    outs = empty_shard_outs(T, B, fc.frontier_size, fc.eps_iters, lattice, scores_tm.device,
                            cfg.em_records if lattice else 0, cfg.eps_records if lattice else 0)
    frame_start_shard(bufs.slots, FrameIO(scores_tm.contiguous(), lengths, st0, outs),
                      local=_local_half(sc, bufs, B, scores_tm.device))
    drv.run(T)
    bufs.slots.io = None  # the chunk's tensors are the caller's now
    return StepState(*(x.clone() for x in bufs.slots.state)), outs


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

    def close(self) -> None:
        """Release this decoder's kept sharded frame drivers
        (``shard_driver.release``): its card finished with them and their
        graphs destroyed, which under NCCL hold the group's communicators.
        Call it (or end the decoder's ``with`` block) before a plain
        ``torch.distributed.destroy_process_group()``; a later decode makes
        its driver again."""
        ids = _pg_ids(self._pg)
        shard_driver.release(lambda key: key[1] == ids)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

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
        _, B, V = scores_tm.shape
        drv = frame_driver(False, self._pg, self.cfg, self._sh, B, V, self.device)
        bufs = drv.bufs
        cut = torch.full((B,), INF, dtype=torch.float32, device=self.device)
        st0 = self._init_state(B)
        carry = _sharded_eps_closure(
            lambda s: _sharded_eps_iteration(s, cut, self._pg, self.cfg, self._sh, bufs),
            st0, self.cfg, self._sh, bufs)
        bp_init = carry.out[0].clone()  # the init closure is batch-invariant
        stf, outs = sharded_chunk(drv, scores_tm, lengths_dev, st0, self.cfg)
        out = dict(
            bp_init=bp_init.cpu().numpy(),
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
        _, B, V = scores_tm.shape
        sc = self.cfg.shard
        drv = frame_driver(True, self._pg, self.cfg, self._sh, B, V, self.device)
        bufs = drv.bufs
        cut = torch.full((B,), INF, dtype=torch.float32, device=self.device)
        st0 = self._init_state(B)
        carry = _sharded_eps_closure(
            lambda s: _sharded_lattice_eps_iteration(s, cut, self._pg, self.cfg, self._sh, bufs),
            st0, sc, self._sh, bufs)
        init_recs = carry.out[0].clone()
        _, outs = sharded_chunk(drv, scores_tm, lengths_dev, st0, self.cfg)
        out = dict(
            init_states=self._global_states(st0.states[0]).cpu().numpy(),
            init_costs=(st0.base[0] + st0.costs[0]).cpu().numpy(),
            init_eps_records=init_recs.cpu().numpy(),
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
