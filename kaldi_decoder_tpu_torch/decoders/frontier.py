"""Token frontier: configuration and emitting arc expansion, batched.

The torch counterpart of ``kaldi_decoder_tpu/decoders/frontier.py``
(``FrontierConfig``, ``config_for_graph``, ``StepState``, ``Candidates``,
``_owner_of_lanes``, ``expand_emitting``) and of ``_cfg_for_device_graph``
and ``_folded_init`` from ``kaldi_decoder_tpu/decoders/viterbi.py``.  The
JAX code is single-utterance and vmapped; here every array carries a
leading batch dimension B.

:func:`expand_emitting` is the plain version of the expansion region: on
a CUDA tensor the decoder runs the hand-written kernel
(:mod:`kaldi_decoder_tpu_torch.kernels.expand`) instead, and the two are
held equal lane for lane.  Scores are read with a plain gather (the JAX
default, a one-hot matrix product, was a TPU choice and equals the
gather on finite scores), and the float order of each candidate cost is
the original's: ``(alpha + w) + (-score)``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph
from kaldi_decoder_tpu_torch.fst.pack import EM_FIELDS, PackedGraph
from kaldi_decoder_tpu_torch.ops.segment import score_lookup

INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FrontierConfig:
    """Decode parameters: the reference's beam semantics
    (`faster-decoder.h:24-63`) plus fixed capacities.

    The original's eps fields (``eps_block_width``, ``eps_rem_budget``,
    ``eps_iters``, ``eps_exact``) size the eps closure on the device, which
    the port does not run: its device graph is eps-free."""

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
    # Emitting arcs per remainder unit (em_flat row).
    flat_group: int = 4
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
        if self.rem_budget < 1:
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
    out = FrontierConfig(explicit=explicit, **kw)
    out.validate()
    return out


_CAPACITY_FIELDS = ("frontier_size", "block_width", "rem_budget")


def _cfg_for_device_graph(dev_graph: CsrGraph, config: Optional[FrontierConfig]):
    """Config sized for the (possibly eps-folded) device graph: beam
    fields from the caller, capacities the caller set explicitly kept,
    the rest re-derived.

    As in the original, ``flat_group`` is not carried over: the device
    config takes the default (see ROADMAP Queue 3)."""
    if config is None:
        return config_for_graph(dev_graph)
    keep = _CAPACITY_FIELDS if config.explicit is None else tuple(
        f for f in _CAPACITY_FIELDS if f in config.explicit
    )
    kw = {f: getattr(config, f) for f in keep}
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
