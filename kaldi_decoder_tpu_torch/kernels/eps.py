"""K5: the eps iteration's candidate lanes; and the eps step, its closing step.

One eps relaxation of a frame's frontier is K5, then the dedup call (K6 on
the 1-best paths, K2's eps call with the K incumbents first on the lattice
paths) with the eps step as its last step:

- :func:`expand_eps_lanes` gives the candidate lanes of the tokens at or
  under the cutoff: with ``incumbents`` the K tokens themselves first, as
  ``(state, cost, slot, -1, -1)``, then every eps arc of every active slot
  (``frontier.expand_eps``: K*We block lanes, then ``eps_rem_budget``
  remainder lanes through the owner map), each costing ``alpha + w``, or
  +inf above the cutoff.  The columns are ``dst, cost, src_slot,
  src_state, arc_id`` and the expansion's ``overflow`` (B,); the 1-best
  calls read ``src_slot``, the lattice calls ``src_state``, and a caller
  may leave out the column it does not read.
- :func:`eps_dedup` is the dedup call on those lanes, which also updates
  the closure's :class:`EpsCarry` in place (:func:`eps_step_plain` says
  what): iteration ``d``'s backpointers (1-best: each slot's ``(src_slot,
  arc_id)`` of its winning lane) or records (lattice: the first ``r_eps``
  rows), the identity or -1 once the batch has stopped; the running
  overflow and saturation of the active rows; each row's ``changed``;
  ``ran`` (the batch has not stopped) and, at the last iteration of a
  cyclic eps budget, the overflow of every active row when some active
  row still changed.  On a card that is one launch of K6 or K2 whose last
  step is the eps step (``csrc/eps_step.cuh``).

The sharded decoders' closure (``parallel/graph_shard.py``) routes each
iteration's lanes between K5 and the dedup call (which reads them in
place, ``kernels.route.RoutedLanes``) and reduces its ``changed`` over
the ranks, so its step, :func:`eps_step_shard`, is a launch of its own:
it applies the batch-wide ``stop`` of the iterations before (the carried
state kept, the identity or -1 rows written), then writes this
iteration's local ``changed`` for the next MAX reduction, and at the
closure's last iteration the local values the frame's rebase and flags
reduce, and from which K3's shard mode derives the next frame's local
half of GetCutoff.  A sharded frame without eps iterations (``eps_iters``
0, as on a graph without eps arcs) has its emitting dedup call write those
values as its last step (``kernels.dedup.shard_reduce``, the call's
``reduce``), whose plain version is ``kernels.dedup.eps_reduce_shard_plain``.

On CPU tensors the wrappers run the plain torch versions,
:func:`expand_eps_lanes_plain`, the dedup call's plain version then
:func:`eps_step_plain`, and :func:`eps_step_shard_plain`; on CUDA tensors
they launch ``csrc/eps.cu``, ``csrc/dedup.cu`` or ``csrc/dedup_rec.cu``
or raise.  The carry lives in device memory, so that an eps closure
replays in a captured frame; each wrapper takes ``out=`` buffers
(:func:`empty_eps_lanes`, :func:`empty_eps_carry`) so that a captured
frame allocates nothing.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from kaldi_decoder_tpu_torch.decoders.frontier import (
    NO_ARC,
    FrontierConfig,
    StepState,
    _backpointers,
    _identity_bp,
    expand_eps,
)
from kaldi_decoder_tpu_torch.fst.pack import EPS_FIELDS, PackedGraph
from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_clusters,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)
from kaldi_decoder_tpu_torch.kernels.cutoff import first_min_count
from kaldi_decoder_tpu_torch.kernels.dedup import dedup_select
from kaldi_decoder_tpu_torch.kernels.dedup_rec import dedup_select_rec
from kaldi_decoder_tpu_torch.kernels.route import RoutedLanes, routed_args, routed_lanes_plain

INF = float("inf")
# EpsCarry.flags: ran, and the clusters done with the iteration (low half)
# beside the active rows that changed (high half) (csrc/eps_step.cuh Flags).
FLAG_WORDS = 2
MAX_ROWS = (1 << 16) - 1  # rows a step takes (either kind): its 16-bit counts reach B
# ShardEpsCarry.flags: stop; words 2-3 the kernel's count of the rows done
# with the iteration (beside those that changed, overflowed, saturated;
# 0 between launches); words 5 and 6 the running overflow and saturation
# (csrc/eps.cu ShardFlags).  Words 0, 5 and 6 are all the plain version
# writes; the kernel leaves words 1-4 at 0.
SHARD_FLAG_WORDS = 7


class EpsLanes(NamedTuple):
    dst: torch.Tensor  # (B, N) int32
    cost: torch.Tensor  # (B, N) float32, +inf above the cutoff
    src_slot: Optional[torch.Tensor]  # (B, N) int32, or None when not asked for
    src_state: Optional[torch.Tensor]  # (B, N) int32 (-1 on incumbents), or None
    arc_id: torch.Tensor  # (B, N) int32 (-1 on incumbents)
    overflow: torch.Tensor  # (B,) bool — remainder lane budget exceeded


class EpsCarry(NamedTuple):
    """An eps closure's state across its D iterations, updated in place."""

    flags: torch.Tensor  # (FLAG_WORDS,) int32: ran, and the kernel's count word (0)
    overflow: torch.Tensor  # (B,) bool, running over the iterations
    saturated: torch.Tensor  # (B,) bool, running
    changed: torch.Tensor  # (B,) bool, the last iteration's
    out: torch.Tensor  # (B, D, K, 2) int32 backpointers, or (B, D, r_eps, 4) records


class EpsBufs(NamedTuple):
    """Static buffers of a frame's eps closure (the frame driver's): K5's
    lanes, the dedup call's output and scratch, the carry."""

    lanes: EpsLanes
    selection: object  # kernels.dedup.empty_selection / dedup_rec.empty_lattice_selection
    scratch: tuple
    carry: EpsCarry


def eps_lane_count(fc: FrontierConfig, incumbents: bool) -> int:
    """Lanes a row of one eps expansion: the incumbents, K*We, R."""
    K = fc.frontier_size
    return (K if incumbents else 0) + K * fc.eps_block_width + fc.eps_rem_budget


def expand_eps_lanes_plain(
    states: torch.Tensor,  # (B, K) int32
    costs: torch.Tensor,  # (B, K) float32, relative
    cutoff_rel: torch.Tensor,  # (B,) float32: expand slots with cost <= cutoff
    pg: PackedGraph,
    fc: FrontierConfig,
    incumbents: bool,
    with_src_slot: bool = True,
    with_src_state: bool = True,
) -> EpsLanes:
    cut = cutoff_rel[:, None]
    active = torch.isfinite(costs) & (costs <= cut)
    cand = expand_eps(StepState(states, costs, None), active, pg, fc)
    ncost = torch.where(cand.cost <= cut, cand.cost, INF)
    cols = (cand.dst, ncost, cand.src_slot, cand.src_state, cand.arc_id)
    if incumbents:
        B, K = states.shape
        slots = torch.arange(K, dtype=torch.int32, device=states.device).expand(B, K)
        none = torch.full_like(states, NO_ARC)
        cols = tuple(torch.cat([x, c], dim=1)
                     for x, c in zip((states, costs, slots, none, none), cols))
    dst, cost, src_slot, src_state, arc_id = cols
    return EpsLanes(dst, cost, src_slot if with_src_slot else None,
                    src_state if with_src_state else None, arc_id, cand.overflow)


def empty_eps_lanes(batch: int, lanes: int, device, with_src_slot: bool = True,
                    with_src_state: bool = True) -> EpsLanes:
    """Uninitialised output buffers of K5 (``expand_eps_lanes``'s ``out``)."""
    i32 = dict(dtype=torch.int32, device=device)

    def col(want=True):
        return torch.empty((batch, lanes), **i32) if want else None
    return EpsLanes(col(), torch.empty((batch, lanes), dtype=torch.float32, device=device),
                    col(with_src_slot), col(with_src_state), col(),
                    torch.empty((batch,), dtype=torch.bool, device=device))


def expand_eps_lanes(
    states, costs, cutoff_rel, pg: PackedGraph, fc: FrontierConfig, incumbents: bool,
    with_src_slot: bool = True, with_src_state: bool = True,
    out: Optional[EpsLanes] = None, blocks: int = 0,
) -> EpsLanes:
    """K5 on the tensors' device: plain torch on the CPU, one launch of
    ``csrc/eps.cu`` on a card, which reads each active slot's eps_block row
    itself: a cluster of blocks a row, which scan the row's slots once
    between them.  On a card, ``out`` (from :func:`empty_eps_lanes`) is
    written and returned instead of fresh buffers, and ``blocks`` (8, 4, 2
    or 1) sets the cluster size instead of :func:`blocks_per_row`'s choice.
    ``expand_eps_lanes.launches`` counts K5 launches."""
    dev = states.device
    if dev.type == "cpu":
        return expand_eps_lanes_plain(states, costs, cutoff_rel, pg, fc, incumbents,
                                      with_src_slot, with_src_state)
    if dev.type != "cuda":
        raise ValueError(f"expand_eps_lanes runs on cpu or cuda tensors, not {dev}")
    B, K = states.shape
    We, R = fc.eps_block_width, fc.eps_rem_budget
    if K != fc.frontier_size:
        raise ValueError(f"frontier has {K} slots, config says {fc.frontier_size}")
    if blocks not in (0, 1, 2, 4, 8):
        raise ValueError(f"blocks must be 0 (chosen), 1, 2, 4 or 8, not {blocks}")
    check(states, "states", torch.int32, (B, K), dev)
    check(costs, "costs", torch.float32, (B, K), dev)
    check(cutoff_rel, "cutoff_rel", torch.float32, (B,), dev)
    check(pg.eps_block, "eps_block", torch.int32,
          (pg.eps_block.shape[0], We * EPS_FIELDS + 2), dev)
    if pg.eps_flat.shape[0] == 0:
        raise ValueError("expand_eps_lanes needs a graph with eps arcs")
    check(pg.eps_flat, "eps_flat", torch.int32, (pg.eps_flat.shape[0], EPS_FIELDS), dev)
    N = eps_lane_count(fc, incumbents)
    if out is None:
        out = empty_eps_lanes(B, N, dev, with_src_slot, with_src_state)
    else:
        check_like(out, empty_eps_lanes(B, N, "meta", with_src_slot, with_src_state), "out", dev)
        if (out.src_slot is None) != (not with_src_slot) or \
                (out.src_state is None) != (not with_src_state):
            raise ValueError("out's source columns differ from the ones asked for")
    rc = kernels().kd_expand_eps(
        ptr(states), ptr(costs), ptr(cutoff_rel), ptr(pg.eps_block), ptr(pg.eps_flat),
        B, K, We, R, K if incumbents else 0, blocks, ptr(out.dst), ptr(out.cost),
        ptr(out.src_slot) if with_src_slot else None,
        ptr(out.src_state) if with_src_state else None, ptr(out.arc_id), ptr(out.overflow),
        stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_expand_eps launch failed: {cuda_error(rc)}")
    expand_eps_lanes.launches += 1
    return out


expand_eps_lanes.launches = 0


def blocks_per_row(batch: int, lanes: int) -> int:
    """The blocks a row (a cluster) K5 launches with for ``batch`` rows of
    ``lanes`` lanes each."""
    return kernels().kd_expand_eps_blocks(batch, lanes)


def empty_eps_carry(batch: int, iters: int, width: int, lattice: bool, device) -> EpsCarry:
    """An eps closure's carry for ``batch`` rows and ``iters`` iterations:
    ``out`` is (B, D, width, 4) records (``width`` = r_eps) when
    ``lattice``, else (B, D, width, 2) backpointers (``width`` = K).  The
    flags start at 0, as the kernel leaves them."""
    b = dict(dtype=torch.bool, device=device)
    return EpsCarry(
        flags=torch.zeros((FLAG_WORDS,), dtype=torch.int32, device=device),
        overflow=torch.zeros((batch,), **b), saturated=torch.zeros((batch,), **b),
        changed=torch.zeros((batch,), **b),
        out=torch.empty((batch, iters, width, 4 if lattice else 2), dtype=torch.int32,
                        device=device),
    )


def _is_lattice(sel) -> bool:
    return getattr(sel, "records", None) is not None


def eps_step_plain(d: int, carry: EpsCarry, row_active: torch.Tensor,
                   exp_overflow: torch.Tensor, sel, exact: bool,
                   lanes: Optional[EpsLanes] = None) -> None:
    """Iteration ``d`` of the closure's D (``carry.out.shape[1]``) after
    its dedup call ``sel``: a ``kernels.dedup_rec.LatticeSelection`` of
    K2's eps call (lattice; records of ``K + r_eps`` rows), else the
    K6 ``Selection`` of ``lanes`` (K5's, with ``src_slot``).
    ``exp_overflow`` (B,) is K5's.  Updates ``carry`` in place."""
    K = sel.states.shape[1]
    D = carry.out.shape[1]
    dev = sel.states.device
    ran = carry.flags[0] != 0 if d else torch.ones((), dtype=torch.bool, device=dev)
    if _is_lattice(sel):
        r_eps = carry.out.shape[2]
        spill = sel.records[:, r_eps, 1] >= 0
        changed = ((sel.cand_idx >= K) & torch.isfinite(sel.costs)).any(dim=1)
        o = exp_overflow | sel.rec_overflow | spill
        carry.out[:, d] = torch.where(ran, sel.records[:, :r_eps], -1)
    else:
        bp = _backpointers(sel.cand_idx, lanes.src_slot, lanes.arc_id)
        changed = ((sel.cand_idx >= 0) & (bp[..., 1] != NO_ARC)).any(dim=1)
        o = exp_overflow
        carry.out[:, d] = torch.where(ran, bp, _identity_bp(K, dev))
    s = sel.num_unique > K
    ovf = o & row_active
    sat = s & row_active
    if d:
        ovf, sat = carry.overflow | ovf, carry.saturated | sat
    go = (changed & row_active).any()
    if d == D - 1 and not exact:
        ovf = ovf | (go & row_active)  # cyclic-eps budget: unconverged
    carry.overflow.copy_(ovf)
    carry.saturated.copy_(sat)
    carry.changed.copy_(changed)
    carry.flags[0] = (ran & go).to(torch.int32)


class StepArgs(ctypes.Structure):
    """The eps step of one eps dedup call, as the kernels take it
    (``csrc/eps_step.cuh`` Step): flags null runs none."""

    _fields_ = [("d", ctypes.c_int), ("D", ctypes.c_int), ("exact", ctypes.c_int),
                ("width", ctypes.c_int)] + [
        (name, ctypes.c_void_p) for name in ("src_slot", "arc_id", "row_active", "exp_ovf",
                                             "flags", "ovf", "sat", "changed", "out")]


def eps_dedup(d: int, carry: EpsCarry, row_active: torch.Tensor, lanes: EpsLanes, exact: bool,
              k: int, num_states: int, slack_beam: Optional[float] = None, out=None,
              scratch=None):
    """Iteration ``d`` of the closure's D (``carry.out.shape[1]``): the
    dedup call on K5's ``lanes`` (the K incumbents first), then the eps
    step on ``carry``.  The lattice paths' (``slack_beam`` given, ``carry``
    of r_eps records a row): K2's eps call of ``k + r_eps`` records; the
    1-best paths' (``lanes`` with ``src_slot``): K6.  On the CPU, the dedup
    call's plain version and :func:`eps_step_plain`; on a card one launch
    of K6 or K2 that runs the step as its last step, into ``out`` and with
    ``scratch`` (as the dedup wrappers take them) when given.  Returns the
    selection.  ``eps_dedup.launches`` counts the steps run inside a dedup
    launch (each is counted as a K6 or K2 launch too)."""
    lattice = slack_beam is not None
    r_eps = carry.out.shape[2]

    def dedup(step=None):
        if lattice:
            return dedup_select_rec(lanes.dst, lanes.cost, k, num_states, k + r_eps, slack_beam,
                                    (lanes.src_state, lanes.arc_id), num_incumbents=k,
                                    out=out, scratch=scratch, step=step)
        return dedup_select(lanes.dst, lanes.cost, k, num_states, out=out, scratch=scratch,
                            step=step)

    dev = lanes.dst.device
    if dev.type == "cpu":
        sel = dedup()
        eps_step_plain(d, carry, row_active, lanes.overflow, sel, exact, lanes)
        return sel
    if dev.type != "cuda":
        raise ValueError(f"eps_dedup runs on cpu or cuda tensors, not {dev}")
    B = lanes.dst.shape[0]
    D = carry.out.shape[1]
    if not 0 <= d < D:
        raise ValueError(f"iteration {d} of {D}")
    if B > MAX_ROWS:
        raise ValueError(f"an eps call with the step takes at most {MAX_ROWS} rows, not {B}")
    check(row_active, "row_active", torch.bool, (B,), dev)
    check(lanes.overflow, "lanes.overflow", torch.bool, (B,), dev)
    check(carry.flags, "carry.flags", torch.int32, (FLAG_WORDS,), dev)
    for name in ("overflow", "saturated", "changed"):
        check(getattr(carry, name), f"carry.{name}", torch.bool, (B,), dev)
    N = lanes.dst.shape[1]
    if lattice:
        if lanes.src_state is None:
            raise ValueError("the lattice eps call needs K5's lanes with src_state")
        check(carry.out, "carry.out", torch.int32, (B, D, r_eps, 4), dev)
    else:
        if lanes.src_slot is None:
            raise ValueError("the 1-best eps step needs K5's lanes with src_slot")
        check(lanes.src_slot, "lanes.src_slot", torch.int32, (B, N), dev)
        check(lanes.arc_id, "lanes.arc_id", torch.int32, (B, N), dev)
        check(carry.out, "carry.out", torch.int32, (B, D, k, 2), dev)
    step = StepArgs(d, D, int(exact), r_eps if lattice else k,
                    None if lattice else lanes.src_slot.data_ptr(),
                    None if lattice else lanes.arc_id.data_ptr(), row_active.data_ptr(),
                    lanes.overflow.data_ptr(), carry.flags.data_ptr(),
                    carry.overflow.data_ptr(), carry.saturated.data_ptr(),
                    carry.changed.data_ptr(), carry.out.data_ptr())
    sel = dedup(step)
    eps_dedup.launches += 1
    return sel


eps_dedup.launches = 0


class ShardEpsCarry(NamedTuple):
    """A sharded eps closure's state across its D iterations, updated in
    place, beside the carried frontier."""

    flags: torch.Tensor  # (SHARD_FLAG_WORDS,) int32, zero before the first iteration
    changed: torch.Tensor  # (1,) int32: this iteration's local `changed`, for a MAX reduction
    out: torch.Tensor  # (B, D, width, 2) int32: backpointers (width K) or links (width r_eps)
    # The closure's last iteration, with ``reduce`` (with no iteration, the
    # emitting dedup call's ``reduce``): the local values the frame reduces
    # over the ranks.
    red_min: torch.Tensor  # (B,) float32: the carried frontier's smallest finite cost, or +inf
    red_count: torch.Tensor  # (B,) int32: its finite costs
    red_flags: torch.Tensor  # (2,) int32: the closure's overflow and saturation (any row)
    # (1,) int64: the emitting call's count of the rows done with the local
    # values (csrc/shard_reduce.cuh; 0 between calls, unread on the CPU).
    red_done: torch.Tensor


def empty_shard_eps_carry(batch: int, iters: int, width: int, device) -> ShardEpsCarry:
    """A sharded eps closure's carry for ``batch`` rows and ``iters``
    iterations of ``width`` backpointers or links a row."""
    i32 = dict(dtype=torch.int32, device=device)
    return ShardEpsCarry(
        flags=torch.zeros((SHARD_FLAG_WORDS,), **i32),
        changed=torch.zeros((1,), **i32),
        out=torch.empty((batch, iters, width, 2), **i32),
        red_min=torch.empty((batch,), dtype=torch.float32, device=device),
        red_count=torch.empty((batch,), **i32),
        red_flags=torch.zeros((2,), **i32),
        red_done=torch.zeros((1,), dtype=torch.int64, device=device),
    )


def eps_step_shard_plain(d: int, carry: ShardEpsCarry, states: torch.Tensor,
                         costs: torch.Tensor, sel, exp_overflow: torch.Tensor,
                         route_overflow: torch.Tensor, changed_prev: Optional[torch.Tensor],
                         slot_base: int, lanes=None, em_overflow=(), em_num_unique=None,
                         reduce: bool = False) -> None:
    """Iteration ``d`` of a sharded closure's D (``carry.out.shape[1]``)
    after its dedup call ``sel`` (K6's ``Selection`` of the routed lanes
    ``lanes``, a ``kernels.route.RoutedLanes`` or their columns, which give
    each lane's ``gslot`` and ``arc``; or K2's ``LatticeSelection`` of its
    eps call, records of ``K + r_eps`` rows).
    ``stop`` is the iterations' before: false at d = 0, else the carried
    stop or ``changed_prev`` (the MAX-reduced ``carry.changed`` of d - 1)
    zero.  Unless stopped, the carried frontier (``states``, ``costs``,
    (B, K), in place) becomes ``sel``'s and row d of ``carry.out`` the
    backpointers ``(gslot, arc)`` of each slot's winning lane (1-best) or
    the first r_eps records' ``(src, arc)`` (lattice); once stopped, the
    identity ``(slot_base + k, NO_ARC)`` or -1.  The batch's overflow (K5's
    ``exp_overflow``, the route's ``route_overflow``, the lattice's record
    overflow and spill, and ``em_overflow``, the emitting call's) and
    saturation (``num_unique > K``, and ``em_num_unique``'s) run on unless
    stopped.  ``carry.changed`` gets the local ``changed``; with
    ``reduce``, ``red_min``, ``red_count`` and ``red_flags`` the frame's
    local values."""
    K = sel.states.shape[1]
    dev = sel.states.device
    if d == 0:
        stop = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        stop = (carry.flags[0] != 0) | (changed_prev[0] == 0)
    if _is_lattice(sel):
        width = carry.out.shape[2]
        changed = ((sel.cand_idx >= K) & torch.isfinite(sel.costs)).any()
        # Spill: links beyond the r_eps rows kept are dropped: record overflow.
        spill = (sel.records[..., 2] >= 0).sum(dim=1) > width
        o = exp_overflow | route_overflow | sel.rec_overflow | spill
        carry.out[:, d] = torch.where(stop, -1, sel.records[:, :width, :2])
    else:
        if isinstance(lanes, RoutedLanes):
            lanes = routed_lanes_plain(lanes)
        bp = _backpointers(sel.cand_idx, lanes.gslot, lanes.arc)
        changed = ((sel.cand_idx >= 0) & (bp[..., 1] != NO_ARC)).any()
        o = exp_overflow | route_overflow
        ident = _identity_bp(K, dev)
        ident[:, 0] += slot_base
        carry.out[:, d] = torch.where(stop, ident, bp)
    s = sel.num_unique > K
    for x in em_overflow:
        o = o | x
    if em_num_unique is not None:
        s = s | (em_num_unique > K)
    states.copy_(torch.where(stop, states, sel.states))
    costs.copy_(torch.where(stop, costs, sel.costs))
    ovf = ~stop & o.any()
    sat = ~stop & s.any()
    if d:
        ovf, sat = ovf | (carry.flags[5] != 0), sat | (carry.flags[6] != 0)
    carry.flags[0], carry.flags[5], carry.flags[6] = stop, ovf, sat
    carry.changed[0] = changed
    if reduce:
        red_min, red_count = first_min_count(costs)
        carry.red_min.copy_(red_min)
        carry.red_count.copy_(red_count)
        carry.red_flags[0], carry.red_flags[1] = ovf, sat


def shard_step_cluster_size(batch: int, k: int) -> int:
    """The blocks a row (a cluster) the eps step's shard mode launches with
    for ``batch`` rows of ``k`` slots."""
    return kernels().kd_eps_step_shard_cluster(batch, k)


def eps_step_shard(d: int, carry: ShardEpsCarry, states, costs, sel, exp_overflow,
                   route_overflow, changed_prev, slot_base: int, lanes=None, em_overflow=(),
                   em_num_unique=None, reduce: bool = False, clusters: int = 0) -> None:
    """The sharded eps step on the tensors' device: :func:`eps_step_shard_plain`
    on the CPU, one launch of ``csrc/eps.cu`` on a card (a cluster of
    blocks a row, the batch's flags in ``carry.flags``), counted in
    ``eps_step_shard.launches``; ``clusters`` (8, 4, 2 or 1) sets the
    blocks a row instead of :func:`shard_step_cluster_size`'s choice.
    ``em_overflow`` holds at most three (B,) bool tensors; on a card the
    1-best step's ``lanes`` are a ``kernels.route.RoutedLanes``, read in
    place.  A row's smallest cost is its first smallest in slot order, the
    bits of that slot."""
    dev = sel.states.device
    if dev.type == "cpu":
        return eps_step_shard_plain(d, carry, states, costs, sel, exp_overflow, route_overflow,
                                    changed_prev, slot_base, lanes, em_overflow, em_num_unique,
                                    reduce)
    if dev.type != "cuda":
        raise ValueError(f"eps_step_shard runs on cpu or cuda tensors, not {dev}")
    B, K = sel.states.shape
    D, width = carry.out.shape[1:3]
    if not 0 <= d < D:
        raise ValueError(f"iteration {d} of {D}")
    if B > MAX_ROWS:
        raise ValueError(f"the eps step's shard mode takes at most {MAX_ROWS} rows, not {B}")
    check_clusters(clusters)
    if d > 0:
        check(changed_prev, "changed_prev", torch.int32, (1,), dev)
    if len(em_overflow) > 3:
        raise ValueError(f"at most three emitting overflow flags, not {len(em_overflow)}")
    lattice = _is_lattice(sel)
    check(states, "states", torch.int32, (B, K), dev)
    check(costs, "costs", torch.float32, (B, K), dev)
    check(sel.states, "sel.states", torch.int32, (B, K), dev)
    check(sel.costs, "sel.costs", torch.float32, (B, K), dev)
    check(sel.cand_idx, "cand_idx", torch.int32, (B, K), dev)
    check(sel.num_unique, "num_unique", torch.int32, (B,), dev)
    for i, x in enumerate((exp_overflow, route_overflow) + tuple(em_overflow)):
        check(x, f"overflow[{i}]", torch.bool, (B,), dev)
    if em_num_unique is not None:
        check(em_num_unique, "em_num_unique", torch.int32, (B,), dev)
    check(carry.flags, "carry.flags", torch.int32, (SHARD_FLAG_WORDS,), dev)
    check(carry.changed, "carry.changed", torch.int32, (1,), dev)
    check(carry.out, "carry.out", torch.int32, (B, D, width, 2), dev)
    check(carry.red_min, "carry.red_min", torch.float32, (B,), dev)
    check(carry.red_count, "carry.red_count", torch.int32, (B,), dev)
    check(carry.red_flags, "carry.red_flags", torch.int32, (2,), dev)
    R_rec = 0
    rargs = None
    if lattice:
        R_rec = sel.records.shape[1]
        if R_rec < width:
            raise ValueError(f"K2's eps call has {R_rec} record rows, fewer than {width}")
        check(sel.rec_overflow, "rec_overflow", torch.bool, (B,), dev)
        check(sel.records, "records", torch.int32, (B, R_rec, 4), dev)
    else:
        if width != K:
            raise ValueError(f"the 1-best closure keeps {K} backpointers a row, not {width}")
        if not isinstance(lanes, RoutedLanes):
            raise ValueError("on a card the 1-best step reads the dedup call's routed lanes "
                             "(kernels.route.RoutedLanes)")
        if lanes.recv.shape[1] != B:
            raise ValueError(f"routed lanes of {lanes.recv.shape[1]} rows, not {B}")
        rargs = routed_args(lanes)
    em = [ptr(x) for x in em_overflow] + [None] * (3 - len(em_overflow))
    rc = kernels().kd_eps_step_shard(
        int(lattice), B, K, D, d, width, R_rec, slot_base, int(reduce),
        ptr(sel.cand_idx), ptr(sel.num_unique), ptr(sel.states), ptr(sel.costs),
        ptr(sel.rec_overflow) if lattice else None, ptr(sel.records) if lattice else None,
        None if lattice else ctypes.c_void_p(ctypes.addressof(rargs)),
        ptr(exp_overflow), ptr(route_overflow), *em,
        ptr(em_num_unique) if em_num_unique is not None else None,
        ptr(changed_prev) if d > 0 else None, ptr(carry.flags), ptr(carry.changed),
        ptr(states), ptr(costs), ptr(carry.out), ptr(carry.red_min), ptr(carry.red_count),
        ptr(carry.red_flags), clusters, stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_eps_step_shard launch failed: {cuda_error(rc)}")
    eps_step_shard.launches += 1


eps_step_shard.launches = 0
