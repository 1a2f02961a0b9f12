"""Token frontier: configuration, arc expansion and the Viterbi frame, batched.

The torch counterpart of ``kaldi_decoder_tpu/decoders/frontier.py``
(``FrontierConfig``, ``config_for_graph``, ``StepState``, ``Candidates``,
``_owner_of_lanes``, ``expand_emitting``, ``expand_eps``, ``StepOut``,
the eps iteration and closure and the Viterbi frame step) and of
``_cfg_for_device_graph`` and ``_folded_init`` from
``kaldi_decoder_tpu/decoders/viterbi.py``.  The
JAX code is single-utterance and vmapped; here every array carries a
leading batch dimension B.

:func:`expand_emitting` is the plain version of the expansion region: on
a CUDA tensor the decoder runs the hand-written kernel
(:mod:`kaldi_decoder_tpu_torch.kernels.expand`) instead, and the two are
held equal lane for lane.  Scores are read with a plain gather (the JAX
default, a one-hot matrix product, was a TPU choice and equals the
gather on finite scores), and the float order of each candidate cost is
the original's: ``(alpha + w) + (-score)``.  Dedup and top-K of the
Viterbi frame and of every eps iteration go through K6
(:func:`kaldi_decoder_tpu_torch.kernels.dedup.dedup_select`), whose plain
version is :func:`kaldi_decoder_tpu_torch.ops.segment.dedup_select`.
Likewise :func:`expand_eps` is the plain core of K5: an eps iteration's
lanes come from :func:`kaldi_decoder_tpu_torch.kernels.eps.expand_eps_lanes`
and its dedup call and closing step from ``kernels.eps.eps_dedup`` (on a
card one K6 launch whose last step is the eps step), each a hand-written
kernel on a card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.pack import EM_FIELDS, EPS_FIELDS, PackedGraph
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.ops.cutoff import get_cutoff
from kaldi_decoder_tpu_torch.ops.segment import score_lookup

INF = float("inf")

# Backpointer arc-id sentinel: "no arc, token carried over" (identity).
NO_ARC = -1


@dataclasses.dataclass(frozen=True)
class FrontierConfig:
    """Decode parameters: the reference's beam semantics
    (`faster-decoder.h:24-63`) plus fixed capacities.

    The eps fields size the eps closure on the device: ``eps_block_width``
    and ``eps_rem_budget`` are the block and remainder lanes of one eps
    expansion, ``eps_iters`` the relaxations per frame (the graph's eps
    depth; 0 on an eps-free device graph), and ``eps_exact`` is False when
    the eps subgraph is cyclic, so that ``eps_iters`` is only a budget and
    a frame still improving at its last iteration is flagged as an
    overflow."""

    beam: float = 16.0
    max_active: int = 2**31 - 1
    min_active: int = 20
    beam_delta: float = 0.5
    # Frontier capacity K: max unique states tracked per frame.
    frontier_size: int = 2048
    # Emitting block width W; arcs beyond W go through remainder lanes.
    block_width: int = 8
    # Flat lane budget for emitting remainder arcs (fat states).
    rem_budget: int = 4096
    # Epsilon block width and remainder budget.
    eps_block_width: int = 4
    eps_rem_budget: int = 1024
    # Emitting arcs per remainder unit (em_flat row).
    flat_group: int = 4
    # Epsilon-closure iterations per frame (the graph's eps depth if known).
    eps_iters: int = 0
    # True when eps_iters is the graph's exact (acyclic) eps depth.
    eps_exact: bool = True
    # Capacity fields the caller set explicitly (None == hand-built
    # config, every field intentional); excluded from eq/hash.
    explicit: Optional[Tuple[str, ...]] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def validate(self) -> None:
        if self.beam <= 0:
            raise ValueError("beam must be > 0")
        if self.max_active <= 1:
            raise ValueError("max_active must be > 1")  # faster-decoder.cc:27
        if not (0 <= self.min_active < self.max_active):
            raise ValueError("need 0 <= min_active < max_active")
        if self.frontier_size < 1 or self.block_width < 1:
            raise ValueError("frontier_size and block_width must be >= 1")
        if self.rem_budget < 1 or self.eps_rem_budget < 1:
            raise ValueError("lane budgets must be >= 1")

    @property
    def expand_lanes(self) -> int:
        """Frontier prefix the expansion reads: the frontier is cost-sorted
        and GetCutoff admits at most ``max_active`` tokens, so slots past
        that prefix are never active."""
        if self.max_active >= self.frontier_size:
            return self.frontier_size
        return min(self.frontier_size, max(8, -(-self.max_active // 8) * 8))

    @property
    def rem_units(self) -> int:
        return -(-self.rem_budget // self.flat_group)

    @property
    def num_candidates(self) -> int:
        return self.expand_lanes * self.block_width + self.rem_units * self.flat_group


def _next_pow2(x: int) -> int:
    return 1 << max(3, (x - 1).bit_length())


def config_for_graph(graph: CsrGraph, base: Optional[FrontierConfig] = None, **kw):
    """A FrontierConfig with capacities sized for ``graph`` (same rules
    as the original)."""
    cfg = base or FrontierConfig()
    kw.pop("explicit", None)
    explicit = tuple(sorted(kw))
    kw.setdefault("beam", cfg.beam)
    kw.setdefault("max_active", cfg.max_active)
    kw.setdefault("min_active", cfg.min_active)
    kw.setdefault("beam_delta", cfg.beam_delta)
    kw.setdefault("flat_group", cfg.flat_group)

    K = kw.get("frontier_size", cfg.frontier_size)
    K = max(8, min(K, _next_pow2(max(graph.num_states, 2))))
    kw["frontier_size"] = K

    deg = np.diff(graph.arrays.em_row_ptr)
    nz = deg[deg > 0]
    p70 = int(np.quantile(nz, 0.7)) if len(nz) else 1
    W = kw.get("block_width", max(1, min(p70, 24, graph.max_em_out_degree or 1)))
    kw["block_width"] = max(1, W)

    if "rem_budget" not in kw:
        exp_rem = float(np.maximum(nz - W, 0).mean()) if len(nz) else 0.0
        rem = int(max(2048, min(6 * K, 2 * exp_rem * K + 2048)))
        kw["rem_budget"] = min(rem, max(graph.num_emitting_arcs, 8))
    kw["rem_budget"] = max(8, kw["rem_budget"])

    if graph.num_eps_arcs:
        edeg = np.diff(graph.arrays.eps_row_ptr)
        enz = edeg[edeg > 0]
        ep50 = int(np.quantile(enz, 0.5)) if len(enz) else 1
        We = kw.get(
            "eps_block_width", max(1, min(ep50, 8, graph.max_eps_out_degree or 1))
        )
        kw["eps_block_width"] = max(1, We)
        kw["eps_rem_budget"] = max(
            8, kw.get("eps_rem_budget", min(max(512, K // 2), graph.num_eps_arcs))
        )
        depth = graph.eps_depth
        if depth is None:
            depth = 16  # cyclic eps subgraph: bounded fixed-point iterations
            kw.setdefault("eps_exact", False)
        kw.setdefault("eps_iters", depth)
    else:
        kw["eps_block_width"] = 1
        kw["eps_rem_budget"] = 8
        kw["eps_iters"] = 0
    out = FrontierConfig(explicit=explicit, **kw)
    out.validate()
    return out


_CAPACITY_FIELDS = (
    "frontier_size",
    "block_width",
    "rem_budget",
    "eps_block_width",
    "eps_rem_budget",
    "eps_iters",
)
_EPS_FIELDS = ("eps_block_width", "eps_rem_budget", "eps_iters")


def _cfg_for_device_graph(dev_graph: CsrGraph, config: Optional[FrontierConfig]):
    """Config sized for the (possibly eps-folded) device graph: beam
    fields from the caller, capacities the caller set explicitly kept,
    the rest re-derived.  The eps capacities follow the device graph
    either way: re-derived when it has no eps arcs (a folded graph), or
    when the caller's config was built for an eps-free graph.

    As in the original, ``flat_group`` is not carried over: the device
    config takes the default (see ROADMAP Queue 3)."""
    if config is None:
        return config_for_graph(dev_graph)
    keep = _CAPACITY_FIELDS if config.explicit is None else tuple(
        f for f in _CAPACITY_FIELDS if f in config.explicit
    )
    kw = {f: getattr(config, f) for f in keep}
    if not dev_graph.has_eps or config.eps_iters == 0:
        for f in _EPS_FIELDS:
            kw.pop(f, None)
    return config_for_graph(
        dev_graph,
        beam=config.beam,
        max_active=config.max_active,
        min_active=config.min_active,
        beam_delta=config.beam_delta,
        **kw,
    )


class StepState(NamedTuple):
    """Carried frontier, (B, K) sorted by increasing cost per row.

    ``costs`` are relative to ``base`` (B,); empty slots cost +inf."""

    states: torch.Tensor  # (B, K) int32
    costs: torch.Tensor  # (B, K) float32
    base: torch.Tensor  # (B,) float32


class Candidates(NamedTuple):
    """Flat candidate arcs of one expansion (block + remainder lanes)."""

    dst: torch.Tensor  # (B, N) int32
    cost: torch.Tensor  # (B, N) float32, +inf invalid
    src_slot: torch.Tensor  # (B, N) int32
    src_state: torch.Tensor  # (B, N) int32
    arc_id: torch.Tensor  # (B, N) int32, global arc index
    overflow: torch.Tensor  # (B,) bool — remainder budget exceeded


def start_frontier(states: np.ndarray, costs: np.ndarray, cfg: FrontierConfig,
                   batch: int, device) -> StepState:
    """Frontier of the given tokens (cheapest first, at most K) broadcast
    over the batch, with base 0."""
    K = cfg.frontier_size
    n = min(len(states), K)
    order = np.argsort(costs, kind="stable")[:n]
    st = np.zeros(K, np.int32)
    co = np.full(K, np.float32(np.inf))
    st[:n] = np.asarray(states)[order]
    co[:n] = np.asarray(costs)[order]
    return StepState(
        states=torch.from_numpy(st).to(device).expand(batch, K).contiguous(),
        costs=torch.from_numpy(co).to(device).expand(batch, K).contiguous(),
        base=torch.zeros((batch,), dtype=torch.float32, device=device),
    )


def _folded_init(fold, cfg: FrontierConfig, batch: int, device) -> StepState:
    """Initial frontier from the host-computed start closure."""
    sc = fold.start
    return start_frontier(sc.states, sc.costs, cfg, batch, device)


def _owner_of_lanes(n_units: torch.Tensor, budget: int):
    """Map ``budget`` flat lanes to their owning slots, per row.

    Returns ``(owner (B, budget), starts (B, K), total (B,))``: the slot
    owning each lane (segment starts scattered with max, then a running
    max), each slot's first lane (exclusive prefix sum of ``n_units``)
    and the total units requested (``total > budget`` means overflow)."""
    B, K = n_units.shape
    csum = torch.cumsum(n_units, dim=1, dtype=torch.int32)
    starts = csum - n_units
    # Column ``budget`` collects the starts beyond the lane budget, which
    # the original drops.
    at = torch.where(n_units > 0, starts, budget).clamp(max=budget).long()
    slot_ids = torch.arange(K, dtype=torch.int32, device=n_units.device).expand(B, K)
    owner0 = torch.zeros((B, budget + 1), dtype=torch.int32, device=n_units.device)
    owner0.scatter_reduce_(1, at, slot_ids, "amax")
    owner = owner0[:, :budget].cummax(dim=1).values
    return owner, starts, csum[:, -1]


def expand_emitting(
    st: StepState,
    active: torch.Tensor,  # (B, K) bool
    scores_t: torch.Tensor,  # (B, V) float32
    pg: PackedGraph,
    cfg: FrontierConfig,
) -> Candidates:
    """Every emitting arc of every active slot as a candidate lane:
    ``expand_lanes * W`` block lanes, then ``rem_units * G`` remainder
    lanes for the arcs beyond W of fat states."""
    K, W = cfg.expand_lanes, cfg.block_width
    states, costs, active = st.states[:, :K], st.costs[:, :K], active[:, :K]
    B = states.shape[0]
    dev = states.device
    safe = torch.where(active, states, 0)

    # Block lanes: one row of em_block per slot, with its [row_lo, deg].
    row = pg.em_block[safe.long()]
    row_lo = row[..., W * EM_FIELDS]
    deg = torch.where(active, row[..., W * EM_FIELDS + 1], 0)
    blk = row[..., : W * EM_FIELDS].reshape(B, K, W, EM_FIELDS)
    w_arc = blk[..., 0].contiguous().view(torch.float32)  # +inf on padding
    nxt = blk[..., 1]
    sidx = blk[..., 2]
    lane_w = torch.arange(W, dtype=torch.int32, device=dev)
    cost_blk = torch.where(active[..., None], costs[..., None] + w_arc, INF)
    arc_blk = row_lo[..., None] + lane_w
    src_blk = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(B, K, W)

    # Remainder lanes: arcs W.. of fat states, mapped onto units of G arcs.
    G = cfg.flat_group
    Ru = cfg.rem_units
    tail_lo = row_lo + W
    tail_hi = row_lo + deg
    has_rem = deg > W
    u_first = torch.where(has_rem, tail_lo // G, 0)
    n_units = torch.where(has_rem, (tail_hi - 1) // G - u_first + 1, 0)
    owner, starts, total = _owner_of_lanes(n_units, Ru)
    own = owner.long()
    j = torch.arange(Ru, dtype=torch.int32, device=dev)
    valid = j < total[:, None]
    unit = (u_first - starts).gather(1, own) + j
    rows = pg.em_flat[torch.where(valid, unit, 0).long()].reshape(B, Ru, G, EM_FIELDS)
    arc_rem = unit[..., None] * G + torch.arange(G, dtype=torch.int32, device=dev)
    in_range = (
        valid[..., None]
        & (arc_rem >= tail_lo.gather(1, own)[..., None])
        & (arc_rem < tail_hi.gather(1, own)[..., None])
    )
    own_cost = costs.gather(1, own)
    cost_rem = torch.where(
        in_range, own_cost[..., None] + rows[..., 0].contiguous().view(torch.float32), INF
    )
    src_rem = owner[..., None].expand(B, Ru, G)

    dst = torch.cat([nxt.reshape(B, -1), rows[..., 1].reshape(B, -1)], dim=1)
    sidx_all = torch.cat([sidx.reshape(B, -1), rows[..., 2].reshape(B, -1)], dim=1)
    cost = torch.cat([cost_blk.reshape(B, -1), cost_rem.reshape(B, -1)], dim=1)
    cost = cost + (-score_lookup(sidx_all, scores_t))  # inf + finite stays inf
    state_blk = safe[..., None].expand(B, K, W)
    state_rem = safe.gather(1, own)[..., None].expand(B, Ru, G)
    return Candidates(
        dst=dst,
        cost=cost,
        src_slot=torch.cat([src_blk.reshape(B, -1), src_rem.reshape(B, -1)], dim=1),
        src_state=torch.cat([state_blk.reshape(B, -1), state_rem.reshape(B, -1)], dim=1),
        arc_id=torch.cat([arc_blk.reshape(B, -1), arc_rem.reshape(B, -1)], dim=1),
        overflow=total > Ru,
    )


def expand_eps(
    st: StepState,
    active: torch.Tensor,  # (B, K) bool
    pg: PackedGraph,
    cfg: FrontierConfig,
) -> Candidates:
    """Every eps arc of every active slot as a candidate lane: ``K * We``
    block lanes, then ``eps_rem_budget`` remainder lanes of one arc each
    for the arcs beyond We (there are no flat groups on the eps side).
    Remainder lanes past the total keep the owner the lane map gives them
    and cost +inf."""
    K, W, R = cfg.frontier_size, cfg.eps_block_width, cfg.eps_rem_budget
    states, costs = st.states, st.costs
    B = states.shape[0]
    dev = states.device
    safe = torch.where(active, states, 0)

    row = pg.eps_block[safe.long()]
    row_lo = row[..., W * EPS_FIELDS]
    deg = torch.where(active, row[..., W * EPS_FIELDS + 1], 0)
    blk = row[..., : W * EPS_FIELDS].reshape(B, K, W, EPS_FIELDS)
    w_arc = blk[..., 0].contiguous().view(torch.float32)
    cost_blk = torch.where(active[..., None], costs[..., None] + w_arc, INF)
    arc_blk = row_lo[..., None] + torch.arange(W, dtype=torch.int32, device=dev)
    src_blk = torch.arange(K, dtype=torch.int32, device=dev)[:, None].expand(B, K, W)

    rem_deg = (deg - W).clamp(min=0)
    owner, starts, total = _owner_of_lanes(rem_deg, R)
    own = owner.long()
    j = torch.arange(R, dtype=torch.int32, device=dev)
    valid = j < total[:, None]
    arc_rem = (row_lo + W - starts).gather(1, own) + j
    rows = pg.eps_flat[torch.where(valid, arc_rem, 0).long()]
    cost_rem = torch.where(
        valid, costs.gather(1, own) + rows[..., 0].contiguous().view(torch.float32), INF
    )
    return Candidates(
        dst=torch.cat([blk[..., 1].reshape(B, -1), rows[..., 1]], dim=1),
        cost=torch.cat([cost_blk.reshape(B, -1), cost_rem], dim=1),
        src_slot=torch.cat([src_blk.reshape(B, -1), owner], dim=1),
        src_state=torch.cat(
            [safe[..., None].expand(B, K, W).reshape(B, -1), safe.gather(1, own)], dim=1
        ),
        arc_id=torch.cat([arc_blk.reshape(B, -1), arc_rem], dim=1),
        overflow=total > R,
    )


class StepOut(NamedTuple):
    """Per-frame outputs of the Viterbi frame step, (B, ...) each;
    stacked over a chunk they gain a leading T."""

    bp_emit: torch.Tensor  # (B, K, 2) int32: (prev_slot, emitting arc id)
    bp_eps: torch.Tensor  # (B, D, K, 2) int32: per eps iteration
    num_active: torch.Tensor  # (B,) int32
    best_cost: torch.Tensor  # (B,) float32, absolute
    cutoff: torch.Tensor  # (B,) float32, absolute cutoff used for expansion
    overflow: torch.Tensor  # (B,) bool — any lane budget overflow this frame
    # More distinct in-beam states than frontier slots: the frontier kept
    # only its K cheapest, a hidden max_active=K the reference does not have.
    saturated: torch.Tensor  # (B,) bool


def _identity_bp(k: int, device) -> torch.Tensor:
    """(K, 2) backpointers ``(slot, NO_ARC)``: every token carried over."""
    slots = torch.arange(k, dtype=torch.int32, device=device)
    return torch.stack([slots, torch.full_like(slots, NO_ARC)], dim=-1)


def start_state(start: int, cfg: FrontierConfig, device) -> StepState:
    """Frontier (B = 1) holding only the start token at cost 0
    (`faster-decoder.cc:42-56` InitDecoding, before its eps closure)."""
    K = cfg.frontier_size
    states = torch.zeros((1, K), dtype=torch.int32, device=device)
    costs = torch.full((1, K), INF, dtype=torch.float32, device=device)
    states[0, 0] = start
    costs[0, 0] = 0.0
    return StepState(states, costs, torch.zeros((1,), dtype=torch.float32, device=device))


def _backpointers(cand_idx: torch.Tensor, cand_slot: torch.Tensor,
                  cand_arc: torch.Tensor) -> torch.Tensor:
    """(B, K, 2) ``(cand_slot, cand_arc)`` of each selected slot's winning
    candidate ``cand_idx`` (B, K); ``(0, NO_ARC)`` on empty slots."""
    ok = cand_idx >= 0
    idx = torch.where(ok, cand_idx, 0).long()
    return torch.stack(
        [
            torch.where(ok, cand_slot.gather(1, idx), 0),
            torch.where(ok, cand_arc.gather(1, idx), NO_ARC),
        ],
        dim=-1,
    ).to(torch.int32)


def eps_candidates(st: StepState, cutoff_rel: torch.Tensor, pg: PackedGraph,
                   cfg: FrontierConfig):
    """The candidate lanes of one eps relaxation (K5,
    ``kernels.eps.expand_eps_lanes``): the K incumbents first, then the eps
    arcs of the tokens at or under the cutoff, each with its cost, or +inf
    above the cutoff.  Returns (state, cost, slot, arc) (B, K + N_eps) and
    the expansion's overflow (B,)."""
    from kaldi_decoder_tpu_torch.kernels.eps import expand_eps_lanes

    lanes = expand_eps_lanes(st.states, st.costs, cutoff_rel, pg, cfg, incumbents=True,
                             with_src_state=False)
    return lanes.dst, lanes.cost, lanes.src_slot, lanes.arc_id, lanes.overflow


def _eps_relax(st: StepState, cutoff_rel: torch.Tensor, pg: PackedGraph, cfg: FrontierConfig,
               num_states: int, d: int, carry, row_active: torch.Tensor, exact: bool,
               bufs=None) -> StepState:
    """Iteration ``d`` of an eps closure on its ``carry``
    (``kernels.eps.EpsCarry``): K5's lanes, the K incumbents first, then
    K6 with the eps step as its last step (``kernels.eps.eps_dedup``).
    ``bufs``: on a card, K5's and K6's output buffers and K6's scratch, or
    None.  Returns the new frontier."""
    # Imported here: kernels.eps imports this module.
    from kaldi_decoder_tpu_torch.kernels.eps import eps_dedup, expand_eps_lanes

    lanes_out, sel_out, scratch = bufs or (None, None, None)
    lanes = expand_eps_lanes(st.states, st.costs, cutoff_rel, pg, cfg, incumbents=True,
                             with_src_state=False, out=lanes_out)
    sel = eps_dedup(d, carry, row_active, lanes, exact, cfg.frontier_size, num_states,
                    out=sel_out, scratch=scratch)
    return StepState(sel.states, sel.costs, st.base)


def eps_iteration(
    st: StepState,
    cutoff_rel: torch.Tensor,  # (B,)
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
):
    """One epsilon relaxation of every row: expand the eps arcs of every
    live token (K5), merge with the incumbent frontier keeping per-state
    minima (K6), then the eps step.

    Reference semantics (`faster-decoder.cc:59-119`): tokens with cost >
    cutoff are not expanded, new tokens with cost > cutoff are dropped,
    and an incumbent is only replaced by a strictly cheaper token (the
    incumbents go first, so K6's lowest-lane rule lets them win ties).
    Returns (state, bp (B, K, 2), changed, overflow, saturated), the last
    three (B,) bool."""
    from kaldi_decoder_tpu_torch.kernels.eps import empty_eps_carry

    B, dev = st.states.shape[0], st.states.device
    carry = empty_eps_carry(B, 1, cfg.frontier_size, False, dev)
    every = torch.ones((B,), dtype=torch.bool, device=dev)
    nxt = _eps_relax(st, cutoff_rel, pg, cfg, num_states, 0, carry, every, True)
    return nxt, carry.out[:, 0], carry.changed, carry.overflow, carry.saturated


def eps_closure_batched(
    st: StepState,  # (B, K)
    cutoff_rel: torch.Tensor,  # (B,)
    row_active: torch.Tensor,  # (B,) bool — rows past their length don't count
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    bufs=None,
) -> Tuple[StepState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Whole-batch epsilon closure, ``eps_iters`` iterations, no host sync:
    each is K5, K6 and the eps step (:func:`_eps_relax`).

    The original's ``while_loop`` stops once no active row changed.  Here
    every one of the ``eps_iters`` iterations runs, and the results are
    those of the early exit, for this reason: an iteration that changes
    nothing in a row had a dedup-sorted frontier as its input (the output
    of a dedup/top-K) and no eps lane won a slot, so its output is that
    same frontier; the next iteration then sees the same input and
    returns the same frontier, identity backpointers on the live slots
    and the same overflow and saturation flags, which the running OR
    already holds.  Once every active row is unchanged, so is every later
    iteration.  Two things are kept as the early exit leaves them: the
    backpointers of an iteration the original never ran are the identity
    ``(slot, NO_ARC)`` on every slot (a run iteration writes ``(0,
    NO_ARC)`` on empty slots), which the eps step selects on the device
    (``ran``); and with ``eps_exact=False`` every active row is flagged
    when some active row still changed at the last iteration.  Rows with
    ``row_active`` False may go on changing; the frame discards their
    results.  ``bufs``: on a card, ``kernels.eps.EpsBufs`` (the frame
    driver's static buffers), or None.

    Returns (state, bp (B, D, K, 2), overflow (B,), saturated (B,))."""
    from kaldi_decoder_tpu_torch.kernels.eps import empty_eps_carry

    K, D = cfg.frontier_size, cfg.eps_iters
    B = st.states.shape[0]
    dev = st.states.device
    if D == 0:
        z = torch.zeros((B,), dtype=torch.bool, device=dev)
        return st, torch.empty((B, 0, K, 2), dtype=torch.int32, device=dev), z, z
    carry = bufs.carry if bufs is not None else empty_eps_carry(B, D, K, False, dev)
    for d in range(D):
        st = _eps_relax(st, cutoff_rel, pg, cfg, num_states, d, carry, row_active,
                        cfg.eps_exact, bufs[:3] if bufs is not None else None)
    return st, carry.out, carry.overflow, carry.saturated


def init_closure(pg: PackedGraph, start: int, num_states: int, cfg: FrontierConfig,
                 device) -> Tuple[StepState, torch.Tensor]:
    """InitDecoding's unbounded eps closure (`faster-decoder.cc:53`): the
    batched closure with B = 1 and cutoff +inf.  Returns the (1, K)
    frontier and its backpointers (D, K, 2)."""
    st = start_state(start, cfg, device)
    cut = torch.full((1,), INF, dtype=torch.float32, device=device)
    active = torch.ones((1,), dtype=torch.bool, device=device)
    st, bp, _, _ = eps_closure_batched(st, cut, active, pg, cfg, num_states)
    return st, bp[0]


def _emit(st: StepState, cutoff, adaptive_beam, scores_t, pg: PackedGraph,
          cfg: FrontierConfig, num_states: int, bufs=None):
    """K1 with each lane's source slot under the frame's GetCutoff
    (``cutoff``, ``adaptive_beam``), then dedup and top-K (K6).  ``bufs``:
    on a card, the frame driver's ``FrameBufs`` (K1's and K6's output
    buffers and K6's scratch are used here), or None."""
    # Imported here: kernels.expand imports this module.
    from kaldi_decoder_tpu_torch.kernels.expand import expand_filter

    ex_out, sel_out, scratch = bufs[:3] if bufs is not None else (None, None, None)
    ex = expand_filter(st.states, st.costs, cutoff, adaptive_beam, scores_t, pg, cfg,
                       with_src_slot=True, out=ex_out)
    sel = dedup_select(ex.dst, ex.cost, cfg.frontier_size, num_states, out=sel_out,
                       scratch=scratch)
    return ex, sel


def frame_emit_stage(
    st: StepState,
    scores_t: torch.Tensor,  # (B, V)
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
):
    """Emitting stage of every row: GetCutoff, the expansion with the
    beam filter (K1, with each lane's source slot), dedup and top-K (K6)
    and the backpointer gather.

    Returns (mid_state, bp_emit (B, K, 2), next_cutoff_rel, cutoff_abs,
    overflow, saturated)."""
    cut = get_cutoff(
        st.costs, cfg.beam, cfg.max_active, cfg.min_active, cfg.beam_delta,
        costs_sorted=True,
    )
    ex, sel = _emit(st, cut.cutoff, cut.adaptive_beam, scores_t, pg, cfg, num_states)
    bp_emit = _backpointers(sel.cand_idx, ex.src_slot, ex.arc_id)
    mid = StepState(sel.states, sel.costs, st.base)
    sat = sel.num_unique > cfg.frontier_size
    return mid, bp_emit, ex.next_cutoff, st.base + cut.cutoff, ex.overflow, sat


def frame_body(
    st: StepState,  # (B, K)
    cutoff: torch.Tensor,  # (B,) the frame's GetCutoff, relative to st.base
    adaptive_beam: torch.Tensor,  # (B,)
    scores_t: torch.Tensor,  # (B, V)
    frame_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
    bufs=None,
):
    """The Viterbi frame before its tail: K1 and K6, then the eps closure
    under K1's next cutoff (ProcessNonemitting(weight_cutoff),
    `faster-decoder.cc:149-151`): K5, K6 and the eps step each iteration.
    ``bufs`` as :func:`_emit`'s, its ``eps`` the closure's.  Returns
    the :class:`kaldi_decoder_tpu_torch.kernels.frame.TailInputs` of the
    frame's tail (K3)."""
    # Imported here: kernels.frame imports this module.
    from kaldi_decoder_tpu_torch.kernels.frame import TailInputs

    ex, sel = _emit(st, cutoff, adaptive_beam, scores_t, pg, cfg, num_states, bufs)
    mid = StepState(sel.states, sel.costs, st.base)
    bp_eps = sel.states.new_empty((st.states.shape[0], 0, cfg.frontier_size, 2))
    eps_ovf = eps_sat = None  # an eps-free device graph: no closure
    if cfg.eps_iters:
        mid, bp_eps, eps_ovf, eps_sat = eps_closure_batched(
            mid, ex.next_cutoff, frame_active, pg, cfg, num_states,
            bufs.eps if bufs is not None else None,
        )
    return TailInputs(mid.states, mid.costs, ex.overflow, sel.num_unique, eps_ovf, eps_sat,
                      cand_idx=sel.cand_idx, src_slot=ex.src_slot, arc_id=ex.arc_id,
                      bp_eps=bp_eps)


def frame_step_batched(
    st: StepState,  # (B, K)
    scores_t: torch.Tensor,  # (B, V)
    frame_active: torch.Tensor,  # (B,) bool
    pg: PackedGraph,
    cfg: FrontierConfig,
    num_states: int,
) -> Tuple[StepState, StepOut]:
    """Whole-batch Viterbi frame: GetCutoff, :func:`frame_body`, then its
    tail (the rebase by each row's best cost and the freeze of rows whose
    utterance has ended, with identity backpointers;
    ``kernels.frame.frame_tail_plain``)."""
    from kaldi_decoder_tpu_torch.kernels.frame import frame_tail_plain

    cut = get_cutoff(
        st.costs, cfg.beam, cfg.max_active, cfg.min_active, cfg.beam_delta,
        costs_sorted=True,
    )
    tin = frame_body(st, cut.cutoff, cut.adaptive_beam, scores_t, frame_active, pg, cfg,
                     num_states)
    final, out, _ = frame_tail_plain(st, cut.cutoff, tin, frame_active, cfg)
    return final, out
