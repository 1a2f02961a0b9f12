"""K7: the shard route, its send side and its receive side.

A sharded frame routes each candidate lane to the rank that owns its
destination state (``parallel/graph_shard.py``): the send side buckets a
row's lanes by owner into the ``(P, B, cap, 4)`` int32 buffer whose slice
p goes to rank p in one ``all_to_all``; the receive side turns the
buffer received into the lanes the dedup call reads.

- :func:`route_send` keeps, per row, the lanes that survive the local
  pre-routing dedup in the stable order by (owner, local state, cost)
  (-0.0 and +0.0 equal, each keeping its bits): each (owner, state) run's
  leader, and on the lattice path every lane within ``local_slack_beam``
  of its run's leader.  Kept lane j of owner p's run goes to ``(p, b,
  j)`` as ``[local state, cost bits, slot, arc]`` while ``j < cap``; the
  rest of the buffer holds ``[0, INF_BITS, 0, NO_ARC]``, and a row whose
  bucket overflows is flagged.  It folds in what the frame applies to the
  lanes first: the global beam filter (``cost < cutoff``, else +inf) and
  the payload's global offsets (``slot = src + slot_add``, or
  ``slot_states[src] + slot_add``; ``arc + arc_add``).
- :func:`route_recv` maps the received ``(P, B, cap, 4)`` buffer onto
  ``(B, P*cap)`` lanes ``state, cost, gslot, arc`` (the state Sp where the
  cost is +inf) for the emitting call.  An eps iteration's dedup call
  reads its lanes in place, from a :class:`RoutedLanes` (the K frontier
  tokens, slots ``inc_slot_base + k`` or -1 and arc ``NO_ARC``, then the
  received buffer), through ``csrc/common.cuh:routed_entry``:
  :func:`routed_lanes_plain` is that map in torch, and
  :func:`route_recv_plain` with incumbents the layout it reads.

On CPU tensors the wrappers run the plain torch versions,
:func:`route_send_plain` and :func:`route_recv_plain`; on CUDA tensors
they launch ``csrc/route.cu`` or raise.  Each takes ``out=`` buffers
(:func:`empty_route_send`, :func:`empty_route_lanes`) sized once a
decode.  On a card the send side is a cluster of blocks a row
(:func:`send_cluster_size`), each block's share of the row in its shared
memory up to ``SMEM_LANES`` lanes, past it in the scratch rows of
:func:`empty_route_send`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from kaldi_decoder_tpu_torch.fst.pack import INF_BITS
from kaldi_decoder_tpu_torch.kernels._build import (
    check,
    check_clusters,
    check_like,
    cuda_error,
    kernels,
    ptr,
    stream,
)

INF = float("inf")
NO_ARC = -1  # decoders/frontier.py NO_ARC (the kernels' modules load before it)
MAX_PARTS = 64  # csrc/route.cu: the most ranks a route takes
MIN_LANES = 768  # csrc/route.cu: the fewest lanes a block of the send side's cluster takes
SMEM_LANES = 7936  # csrc/route.cu: the most lanes a block keeps in shared memory


class RouteSend(NamedTuple):
    """The send side's result, and on a card its sort's scratch."""

    buf: torch.Tensor  # (P, B, cap, 4) int32: [local state, cost bits, slot, arc]
    overflow: torch.Tensor  # (B,) bool — a (row, owner) bucket overflowed
    scratch: Optional[tuple] = None  # two (B, N) int64 rows, two (B, N) int32 rows


class RoutedLanes(NamedTuple):
    """An eps iteration's lanes where the all_to_all left them: lane j < K
    of row b is incumbent j (``inc_states``, ``inc_costs``, slot
    ``inc_slot_base + j`` or -1, arc ``NO_ARC``), lane j >= K the entry
    ``recv[p, b, c]``, ``p, c = divmod(j - K, cap)`` (its state ``sp``
    where its cost is +inf)."""

    recv: torch.Tensor  # (P, B, cap, 4) int32, slice p from rank p
    sp: int
    inc_states: torch.Tensor  # (B, K) int32
    inc_costs: torch.Tensor  # (B, K) float32
    inc_slot_base: Optional[int] = None

    @property
    def lanes(self) -> int:
        P, _, cap, _ = self.recv.shape
        return self.inc_states.shape[1] + P * cap


class RoutedArgs(ctypes.Structure):
    """A :class:`RoutedLanes` as the kernels take it (``csrc/common.cuh``
    Routed)."""

    _fields_ = [("recv", ctypes.c_void_p), ("inc_states", ctypes.c_void_p),
                ("inc_costs", ctypes.c_void_p)] + [
        (name, ctypes.c_int) for name in ("B", "P", "cap", "K", "sp", "has_base", "base")]


def routed_args(src: RoutedLanes) -> RoutedArgs:
    """``src`` checked (int32 entries and states, float32 costs, one
    device, contiguous, int indices) and as the kernels take it."""
    P, B, cap, _ = src.recv.shape
    dev = src.recv.device
    K = src.inc_states.shape[1]
    check(src.recv, "recv", torch.int32, (P, B, cap, 4), dev)
    check(src.inc_states, "inc_states", torch.int32, (B, K), dev)
    check(src.inc_costs, "inc_costs", torch.float32, (B, K), dev)
    if P < 1 or cap < 1 or src.sp < 1 or B * (K + P * cap) >= 1 << 31:
        raise ValueError(f"routed lanes of {P} parts, cap {cap}, part size {src.sp}, "
                         f"{B} rows of {K} incumbents: out of range")
    base = src.inc_slot_base
    return RoutedArgs(src.recv.data_ptr(), src.inc_states.data_ptr(), src.inc_costs.data_ptr(),
                      B, P, cap, K, src.sp, int(base is not None), base or 0)


def routed_lanes_plain(src: RoutedLanes) -> "RouteLanes":
    """The lanes of ``src`` as (B, K + P*cap) columns, each lane looked
    up by the kernels' rule (``csrc/common.cuh:routed_entry``): lane j < K
    the incumbent, lane j >= K ``recv[p, b, c]``, ``p, c = divmod(j - K,
    cap)``."""
    P, B, cap, _ = src.recv.shape
    K = src.inc_states.shape[1]
    dev = src.recv.device
    q = torch.arange(P * cap, dtype=torch.int64, device=dev)
    p, c = q // cap, q % cap
    ent = src.recv[p[None, :], torch.arange(B, device=dev)[:, None], c[None, :]]  # (B, P*cap, 4)
    cost = ent[..., 1].contiguous().view(torch.float32)
    routed = (torch.where(torch.isfinite(cost), ent[..., 0], src.sp), cost, ent[..., 2],
              ent[..., 3])
    if src.inc_slot_base is None:
        slots = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    else:
        slots = (src.inc_slot_base + torch.arange(K, dtype=torch.int32, device=dev)).expand(B, K)
    inc = (src.inc_states, src.inc_costs, slots,
           torch.full((B, K), NO_ARC, dtype=torch.int32, device=dev))
    return RouteLanes(*(torch.cat([x, y], dim=1).contiguous() for x, y in zip(inc, routed)))


class RouteLanes(NamedTuple):
    """The receive side's lanes, (B, inc + P*cap) each."""

    state_local: torch.Tensor  # int32, Sp where the cost is +inf
    cost: torch.Tensor  # float32, +inf invalid
    gslot: torch.Tensor  # int32 global source slot (or state); the incumbents' own
    arc: torch.Tensor  # int32 global arc id; NO_ARC on the incumbents


def route_send_plain(
    dst_g: torch.Tensor,  # (B, N) int32 global destination states
    cost: torch.Tensor,  # (B, N) float32, +inf invalid
    src: torch.Tensor,  # (B, N) int32 the payload's slot (or a slot of slot_states)
    arc: torch.Tensor,  # (B, N) int32 the payload's arc
    sp: int,
    num_parts: int,
    cap: int,
    local_slack_beam: Optional[float] = None,
    cutoff: Optional[torch.Tensor] = None,  # (B,) float32: lanes at or above go +inf
    slot_states: Optional[torch.Tensor] = None,  # (B, K) int32: the slot column is its row
    slot_add: int = 0,
    arc_add: int = 0,
) -> RouteSend:
    """One 3-key order by (owner, local state, cost) groups the lanes and
    performs the local pre-routing dedup: each (owner, state) run's
    leader is its local per-state minimum.  It is a stable sort by cost,
    then a stable sort by the (owner, state) key, so equal keys keep lane
    order; the reference's comparator takes -0.0 and +0.0 as equal, so
    they are folded for the cost sort.  With ``local_slack_beam`` None
    (best-path decode) only leaders are routed; with a beam (lattice
    decode) non-leaders are routed while ``cost - local minimum`` is at
    most the beam (the global slack is no smaller, so what is dropped is
    beyond the lattice beam).  Within-run positions place survivors in the
    fixed (P, cap) buffer; a bucket overflow drops lanes and sets the
    flag.  Lanes past the beam filter are invalid; the payload of an
    invalid lane is never read."""
    B, N = dst_g.shape
    dev = dst_g.device
    if cutoff is not None:
        cost = torch.where(cost < cutoff[:, None], cost, INF)
    if slot_states is not None:
        src = slot_states.gather(1, src.clamp(0, slot_states.shape[1] - 1).long())
    gslot = src + slot_add
    arc_g = arc + arc_add
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
    return RouteSend(send, (keep & (within >= cap)).any(dim=1))


def empty_route_send(batch: int, lanes: int, num_parts: int, cap: int, device) -> RouteSend:
    """Uninitialised buffers of K7's send side (``route_send``'s ``out``)
    for ``batch`` rows of ``lanes`` lanes, with its scratch: the sort's
    two element rows, a cost key and a count a lane, read only where a
    block's share of a row exceeds ``SMEM_LANES``."""
    i64 = dict(dtype=torch.int64, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    shape = (batch, lanes)
    return RouteSend(
        buf=torch.empty((num_parts, batch, cap, 4), **i32),
        overflow=torch.empty((batch,), dtype=torch.bool, device=device),
        scratch=(torch.empty(shape, **i64), torch.empty(shape, **i64), torch.empty(shape, **i32),
                 torch.empty(shape, **i32)),
    )


def send_cluster_size(lanes: int) -> int:
    """The blocks a row (a cluster) K7's send side launches with for rows
    of ``lanes`` lanes."""
    return kernels().kd_route_send_cluster(lanes)


def route_send(dst_g, cost, src, arc, sp: int, num_parts: int, cap: int,
               local_slack_beam: Optional[float] = None, cutoff=None, slot_states=None,
               slot_add: int = 0, arc_add: int = 0,
               out: Optional[RouteSend] = None, clusters: int = 0) -> RouteSend:
    """K7's send side on the tensors' device: :func:`route_send_plain` on
    the CPU, one launch of ``csrc/route.cu`` on a card (a cluster of
    blocks a row; ``clusters`` (8, 4, 2 or 1) sets their number instead of
    :func:`send_cluster_size`'s choice), into ``out`` (from
    :func:`empty_route_send`) when given.  On a card a valid lane's
    destination must lie in ``[0, num_parts * sp)``.
    ``route_send.launches`` counts its launches."""
    dev = dst_g.device
    if dev.type == "cpu":
        return route_send_plain(dst_g, cost, src, arc, sp, num_parts, cap, local_slack_beam,
                                cutoff, slot_states, slot_add, arc_add)
    if dev.type != "cuda":
        raise ValueError(f"route_send runs on cpu or cuda tensors, not {dev}")
    B, N = dst_g.shape
    if not 1 <= num_parts <= MAX_PARTS:
        raise ValueError(f"route_send takes 1 to {MAX_PARTS} parts, not {num_parts}")
    if sp < 1 or cap < 1 or num_parts * sp >= 1 << 31:
        raise ValueError(f"part size {sp} and cap {cap} must be positive, P*Sp below 2^31")
    if N < 1:
        raise ValueError("route_send takes at least one lane a row")
    check_clusters(clusters)
    for name, x, dtype in (("dst_g", dst_g, torch.int32), ("cost", cost, torch.float32),
                           ("src", src, torch.int32), ("arc", arc, torch.int32)):
        check(x, name, dtype, (B, N), dev)
    if cutoff is not None:
        check(cutoff, "cutoff", torch.float32, (B,), dev)
    K = 0
    if slot_states is not None:
        K = slot_states.shape[1]
        check(slot_states, "slot_states", torch.int32, (B, K), dev)
    if out is None:
        out = empty_route_send(B, N, num_parts, cap, dev)
    else:
        check(out.buf, "out.buf", torch.int32, (num_parts, B, cap, 4), dev)
        check(out.overflow, "out.overflow", torch.bool, (B,), dev)
        if out.scratch is None or len(out.scratch) != 4:
            raise ValueError("out needs the four scratch rows (empty_route_send)")
        for i, x in enumerate(out.scratch):
            check(x, f"scratch[{i}]", torch.int64 if i < 2 else torch.int32, (B, N), dev)
    k0, k1, v0, v1 = out.scratch
    lattice = local_slack_beam is not None
    rc = kernels().kd_route_send(
        ptr(dst_g), ptr(cost), ptr(src), ptr(arc),
        ptr(cutoff) if cutoff is not None else None,
        ptr(slot_states) if slot_states is not None else None,
        B, N, K, sp, num_parts, cap, slot_add, arc_add, int(lattice),
        ctypes.c_float(local_slack_beam if lattice else 0.0),
        ptr(k0), ptr(k1), ptr(v0), ptr(v1), ptr(out.buf), ptr(out.overflow), clusters,
        stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_route_send launch failed: {cuda_error(rc)}")
    route_send.launches += 1
    return out


route_send.launches = 0


def route_recv_plain(recv: torch.Tensor, sp: int, inc_states=None, inc_costs=None,
                     inc_slot_base: Optional[int] = None) -> RouteLanes:
    """``recv`` (P, B, cap, 4), slice p from rank p, as (B, P*cap) lanes
    in rank order, after the incumbents when ``inc_states`` (B, K) and
    ``inc_costs`` are given."""
    P, B, cap, _ = recv.shape
    r = recv.transpose(0, 1).reshape(B, P * cap, 4)
    c = r[..., 1].contiguous().view(torch.float32)
    # Invalid entries carry cost=+inf; make their state the dedup sentinel.
    lanes = (torch.where(torch.isfinite(c), r[..., 0], sp), c, r[..., 2].contiguous(),
             r[..., 3].contiguous())
    if inc_states is None:
        return RouteLanes(*lanes)
    K = inc_states.shape[1]
    dev = recv.device
    if inc_slot_base is None:
        slots = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    else:
        slots = (inc_slot_base + torch.arange(K, dtype=torch.int32, device=dev)).expand(B, K)
    arcs = torch.full((B, K), NO_ARC, dtype=torch.int32, device=dev)
    return RouteLanes(*(torch.cat([x, y], dim=1)
                        for x, y in zip((inc_states, inc_costs, slots, arcs), lanes)))


def empty_route_lanes(batch: int, lanes: int, device) -> RouteLanes:
    """Uninitialised output buffers of K7's receive side (``route_recv``'s
    ``out``): ``lanes`` = the incumbents + P*cap."""
    i32 = dict(dtype=torch.int32, device=device)
    shape = (batch, lanes)
    return RouteLanes(torch.empty(shape, **i32),
                      torch.empty(shape, dtype=torch.float32, device=device),
                      torch.empty(shape, **i32), torch.empty(shape, **i32))


def route_recv(recv, sp: int, out: Optional[RouteLanes] = None) -> RouteLanes:
    """K7's receive side on the tensors' device, without incumbents (the
    emitting call's; an eps iteration's dedup call reads its lanes in
    place, :class:`RoutedLanes`): :func:`route_recv_plain` on the CPU, one
    launch of ``csrc/route.cu`` on a card, into ``out`` (from
    :func:`empty_route_lanes`) when given.  ``route_recv.launches`` counts
    its launches."""
    dev = recv.device
    if dev.type == "cpu":
        return route_recv_plain(recv, sp)
    if dev.type != "cuda":
        raise ValueError(f"route_recv runs on cpu or cuda tensors, not {dev}")
    P, B, cap, _ = recv.shape
    check(recv, "recv", torch.int32, (P, B, cap, 4), dev)
    L = P * cap
    if B * L >= 1 << 31:
        raise ValueError(f"route_recv takes fewer than 2^31 lanes, not {B} x {L}")
    if out is None:
        out = empty_route_lanes(B, L, dev)
    else:
        check_like(out, empty_route_lanes(B, L, "meta"), "out", dev)
    rc = kernels().kd_route_recv(
        ptr(recv), B, P, cap, sp, ptr(out.state_local), ptr(out.cost), ptr(out.gslot),
        ptr(out.arc), stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"kd_route_recv launch failed: {cuda_error(rc)}")
    route_recv.launches += 1
    return out


route_recv.launches = 0
