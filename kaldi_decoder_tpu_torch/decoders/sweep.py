"""Windowed backward extra-cost sweep of one chunk, batched over B.

The torch counterpart of ``kaldi_decoder_tpu/decoders/sweep.py``
(``SweepConfig``, ``sweep_config``, ``SweepOut`` and ``_sweep_one``).  The
sweep runs backwards over the chunk's frames: the chunk boundary and
utterance-final frames get extra cost 0 (the Token-constructor
initialisation, `lattice-simple-decoder.h:200`), each record's extra is
``extra(dst) + slack`` (`lattice-simple-decoder.cc:254-296`), and tokens and
links within ``lattice_beam`` plus a float32 margin are compacted, in
order, into survivor buffers with caps and an overflow flag.

On a device graph with eps arcs (``eps_iters`` D > 0) each frame's slot
extras are first refined by the eps Bellman over the frame's D x Re eps
records: a pass joins each record's ``extra(dst) + slack`` by source
state (clamped at 0) and lowers the slot extras to it.  Extras only fall,
so the iteration converges from above and must run to quiescence: it
stops when a pass lowers nothing, or at the bound (D + 2 when the eps
graph is exact, else min(K, D * Re) + 2), where a frame still changing
inside the emitted range sets the overflow flag.  The eps links within
the beam are compacted into their own survivor buffer.

:func:`sweep_plain` is the plain torch version; on a CUDA tensor the
decoder runs the hand-written kernel
(:mod:`kaldi_decoder_tpu_torch.kernels.sweep`) instead.  The join by state,
a dense compare in the original, is a scatter-min into a per-utterance
table of S entries and a gather.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

INF = float("inf")
MARGIN = 1e-3  # f32 sweep vs f64 host-final-prune safety margin


@dataclasses.dataclass(frozen=True)
class SweepConfig:
    """Sweep shapes (capacities scale with the chunk length)."""

    frontier_size: int  # K
    em_records: int  # R per frame
    chunk_frames: int  # T
    lattice_beam: float
    tok_cap: int  # token buffer rows per utterance (excl. final K block)
    em_cap: int  # em-link buffer rows (excl. final R block)
    eps_records: int = 0  # Re per frame per eps iteration
    eps_iters: int = 0  # D
    eps_exact: bool = True  # D is the graph's exact acyclic eps depth
    eps_cap: int = 8  # eps-link buffer rows (excl. final D*Re block)

    @property
    def eps_bound(self) -> int:
        """The most Bellman passes a frame runs."""
        D = self.eps_iters
        return D + 2 if self.eps_exact else min(self.frontier_size, D * self.eps_records) + 2


def sweep_config(cfg, chunk_frames: int) -> SweepConfig:
    """Capacities from a LatticeDevConfig and the chunk length (the
    original's rule: one frontier/record block plus a per-frame
    allowance)."""
    fc = cfg.frontier
    T = chunk_frames
    return SweepConfig(
        frontier_size=fc.frontier_size,
        em_records=cfg.em_records,
        chunk_frames=T,
        lattice_beam=float(cfg.lattice_beam),
        tok_cap=fc.frontier_size + 192 * T,
        em_cap=cfg.em_records + 320 * T,
        eps_records=cfg.eps_records,
        eps_iters=fc.eps_iters,
        eps_exact=fc.eps_exact,
        eps_cap=max(64 * T, 8),
    )


class SweepOut(NamedTuple):
    """Per-utterance survivor buffers (rows beyond count are undefined)."""

    tok_rows: torch.Tensor  # (B, tok_cap + K, 3): [frame, state, alpha_bits]
    tok_count: torch.Tensor  # (B,) int32
    em_rows: torch.Tensor  # (B, em_cap + R, 3): [frame, src_state, arc_id]
    em_count: torch.Tensor  # (B,) int32
    eps_rows: torch.Tensor  # (B, eps_cap + max(D, 1) * Re, 3): [frame, src_state, arc_id]
    eps_count: torch.Tensor  # (B,) int32
    overflow: torch.Tensor  # (B,) bool — a buffer exceeded its cap, or a
    # frame's eps Bellman was still changing at its bound


def _join_min(keys, states, vals, num_states: int):
    """Per row: min over {vals[j] : states[j] == key} for each key, +inf
    when absent or when the key is negative (record padding)."""
    B = keys.shape[0]
    table = torch.full((B, num_states + 1), INF, dtype=torch.float32, device=keys.device)
    table.scatter_reduce_(1, torch.where(states >= 0, states, num_states).long(), vals, "amin")
    out = table.gather(1, torch.where(keys >= 0, keys, num_states).long())
    return torch.where(keys >= 0, out, INF)


def _compact_rows(keep, cols, frame: int):
    """Keep-rows first in their original order: ((B, n, 3) rows, count)."""
    n = keep.shape[1]
    lane = torch.arange(n, device=keep.device)
    skey, order = torch.sort(torch.where(keep, lane, n), dim=1, stable=True)
    ok = skey < n
    rows = torch.stack(
        [torch.where(ok, frame, -1).to(torch.int32)]
        + [torch.where(ok, c.gather(1, order), -1).to(torch.int32) for c in cols],
        dim=-1,
    ).to(torch.int32)
    return rows, keep.sum(dim=1, dtype=torch.int32)


def _append(buf, off, rows, count, cap: int):
    """Write each row block at its offset clamped to ``cap``; returns
    (new offsets, overflowed)."""
    B, n, _ = rows.shape
    off_w = off.clamp(max=cap)
    idx = off_w[:, None] + torch.arange(n, device=buf.device)
    buf.scatter_(1, idx[..., None].expand(B, n, 3).long(), rows)
    new_off = off_w + count
    return new_off.clamp(max=cap + n), new_off > cap


def sweep_plain(
    frontier_states: torch.Tensor,  # (T, B, K) int32
    frontier_costs: torch.Tensor,  # (T, B, K) float32 absolute alphas
    em_records: torch.Tensor,  # (T, B, R, 4) int32
    init_states: torch.Tensor,  # (B, K) chunk-entry frontier states
    rem: torch.Tensor,  # (B,) int32 — remaining utterance frames
    sc: SweepConfig,
    num_states: int,
    eps_records: Optional[torch.Tensor] = None,  # (T, B, D, Re, 4) int32; D > 0 only
) -> SweepOut:
    T, K, R = sc.chunk_frames, sc.frontier_size, sc.em_records
    D, Re = sc.eps_iters, sc.eps_records
    B = init_states.shape[0]
    dev = init_states.device
    beam = sc.lattice_beam
    boundary = rem.clamp(max=T)
    tok_buf = torch.full((B, sc.tok_cap + K, 3), -1, dtype=torch.int32, device=dev)
    em_buf = torch.full((B, sc.em_cap + R, 3), -1, dtype=torch.int32, device=dev)
    eps_buf = torch.full((B, sc.eps_cap + max(D, 1) * Re, 3), -1, dtype=torch.int32,
                         device=dev)
    tok_off = torch.zeros((B,), dtype=torch.int32, device=dev)
    em_off = torch.zeros((B,), dtype=torch.int32, device=dev)
    eps_off = torch.zeros((B,), dtype=torch.int32, device=dev)
    ovf = torch.zeros((B,), dtype=torch.bool, device=dev)
    extra_next = torch.full((B, K), INF, dtype=torch.float32, device=dev)

    for t in range(T - 1, -1, -1):
        f = t + 1  # token-frame index of frontier[t]
        states_t1, alpha_t1, em_t = frontier_states[t], frontier_costs[t], em_records[t]
        live = torch.isfinite(alpha_t1)
        at_boundary = (f >= boundary)[:, None]
        emit = (f <= boundary)[:, None]  # frames past the boundary are frozen
        extra = torch.where(at_boundary, torch.where(live, 0.0, INF), extra_next)

        if D:
            # The eps Bellman within frame f, to quiescence (every row
            # runs until none changes; a row that converged stays put).
            flat = eps_records[t].reshape(B, D * Re, 4)
            evalid = flat[..., 1] >= 0
            eslack = flat[..., 3].contiguous().view(torch.float32)
            changed = torch.ones((B,), dtype=torch.bool, device=dev)
            it = 0
            while it < sc.eps_bound and bool(changed.any()):
                ex_dst = _join_min(flat[..., 2], states_t1, extra, num_states)
                le = torch.where(evalid, ex_dst + eslack, INF)
                upd = _join_min(states_t1, flat[..., 0], le.clamp_min(0.0), num_states)
                ex2 = torch.minimum(extra, upd)
                changed = (ex2 < extra).any(dim=1)
                extra = ex2
                it += 1
            nonconv = changed & emit[:, 0]
            ex_dst = _join_min(flat[..., 2], states_t1, extra, num_states)
            le_eps = torch.where(evalid, ex_dst + eslack, INF)

        tok_keep = emit & live & (extra <= beam + 2 * MARGIN)
        rows, n = _compact_rows(tok_keep, (states_t1, alpha_t1.view(torch.int32)), f)
        tok_off, o1 = _append(tok_buf, tok_off, rows, n, sc.tok_cap)

        if D:
            keep = emit & (le_eps <= beam + MARGIN)
            rows, n = _compact_rows(keep, (flat[..., 0], flat[..., 1]), f)
            eps_off, o2 = _append(eps_buf, eps_off, rows, n, sc.eps_cap)
            ovf = ovf | o2 | nonconv

        valid = em_t[..., 1] >= 0
        slack = em_t[..., 3].contiguous().view(torch.float32)
        ex_dst = _join_min(em_t[..., 2], states_t1, extra, num_states)
        le = torch.where(valid, ex_dst + slack, INF)
        keep = emit & (le <= beam + MARGIN)
        rows, n = _compact_rows(keep, (em_t[..., 0], em_t[..., 1]), t)
        em_off, o3 = _append(em_buf, em_off, rows, n, sc.em_cap)

        prev_states = frontier_states[t - 1] if t > 0 else init_states
        extra_next = _join_min(
            prev_states, em_t[..., 0], torch.where(keep, le.clamp_min(0.0), INF),
            num_states,
        )
        ovf = ovf | o1 | o3

    return SweepOut(
        tok_rows=tok_buf,
        tok_count=tok_off.clamp(max=sc.tok_cap),
        em_rows=em_buf,
        em_count=em_off.clamp(max=sc.em_cap),
        eps_rows=eps_buf,
        eps_count=eps_off.clamp(max=sc.eps_cap),
        overflow=ovf,
    )
