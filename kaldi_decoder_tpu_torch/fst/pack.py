"""Packed graph tables for frontier expansion.

The layout is the JAX package's (``kaldi_decoder_tpu/fst/pack.py``):

* ``em_block (S, W*3 + 2)`` — each state's first W emitting arcs
  ``[weight_bits, next, score_idx]`` (weight +inf marks padding) plus a
  trailing ``[row_lo, deg]`` header;
* ``em_flat (ceil(E/G), G*3)`` — all emitting arcs packed G per row for
  the remainder lanes (arcs beyond W of fat states); pad arcs carry +inf
  weights;
* ``eps_block (S, We*2 + 2)`` / ``eps_flat (E_eps, 2)`` — the same for eps
  arcs, with fields ``[weight_bits, next]``; an eps-free graph gets the
  empty tables the original gives it (all-padding blocks, no flat rows).

Weights are float32 bit-cast into the int32 word.  Arc order in blocks
matches the flat CSR order, so ``arc_id = row_ptr[s] + w`` for block lanes.

The row pointers and final costs of the original's ``PackedGraph`` are
left out: no device code reads them.  :func:`pack_graph` is a numpy copy
of the original's ``pack_graph`` for these tables;
:func:`pack_graph_device` uploads only the flat tables and builds the
block tables on the given device, with the same result.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from kaldi_decoder_tpu_torch.fst.csr import CsrGraph

INF_BITS = int(np.float32(np.inf).view(np.int32))

EM_FIELDS = 3  # weight, next, score_idx
EPS_FIELDS = 2  # weight, next
FLAT_GROUP = 4


class PackedGraph(NamedTuple):
    """Packed arc tables (numpy arrays or int32 tensors)."""

    em_block: object  # (S, W_em * 3 + 2) int32 — arcs + [row_lo, deg]
    em_flat: object  # (ceil(E_em/G), G*3) int32
    eps_block: object  # (S, W_eps * 2 + 2) int32 — arcs + [row_lo, deg]
    eps_flat: object  # (E_eps, 2) int32


def _flat_tables(graph: CsrGraph, flat_group: int):
    """(em_flat (E, 3), em_flat packed (ceil(E/G), G*3), eps_flat (E_eps, 2))."""
    ga = graph.arrays
    E = graph.num_emitting_arcs
    em_flat = (
        np.stack(
            [np.ascontiguousarray(ga.em_weight).view(np.int32), ga.em_next,
             ga.em_score_idx],
            axis=1,
        ).astype(np.int32)
        if E
        else np.zeros((0, EM_FIELDS), np.int32)
    )
    G = flat_group
    n_units = (E + G - 1) // G if E else 0
    em_flat_p = np.empty((n_units * G, EM_FIELDS), np.int32)
    em_flat_p[:, 0] = INF_BITS
    em_flat_p[:, 1:] = 0
    em_flat_p[:E] = em_flat
    eps_flat = (
        np.stack(
            [np.ascontiguousarray(ga.eps_weight).view(np.int32), ga.eps_next], axis=1
        ).astype(np.int32)
        if graph.num_eps_arcs
        else np.zeros((0, EPS_FIELDS), np.int32)
    )
    return em_flat, em_flat_p.reshape(n_units, G * EM_FIELDS), eps_flat


def _blocks_numpy(row_ptr, flat, w: int, nfields: int):
    S = len(row_ptr) - 1
    blk = np.empty((S, w, nfields), np.int32)
    blk[..., 0] = INF_BITS  # weight = +inf marks padding
    blk[..., 1:] = 0
    deg = np.diff(row_ptr)
    if len(flat):
        take = np.minimum(deg, w)
        s_idx = np.repeat(np.arange(S), take)
        w_idx = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
        arc_idx = row_ptr[:-1].astype(np.int64).repeat(take) + w_idx
        blk[s_idx, w_idx] = flat[arc_idx]
    hdr = np.stack([row_ptr[:-1].astype(np.int32), deg.astype(np.int32)], axis=1)
    return np.concatenate([blk.reshape(S, w * nfields), hdr], axis=1)


def pack_graph(
    graph: CsrGraph, w_em: int, w_eps: int, flat_group: int = FLAT_GROUP
) -> PackedGraph:
    """Numpy packed tables (``kaldi_decoder_tpu.fst.pack.pack_graph``
    without the row pointers and final costs)."""
    ga = graph.arrays
    em_flat, em_flat_p, eps_flat = _flat_tables(graph, flat_group)
    return PackedGraph(
        em_block=_blocks_numpy(ga.em_row_ptr, em_flat, w_em, EM_FIELDS),
        em_flat=em_flat_p,
        eps_block=_blocks_numpy(ga.eps_row_ptr, eps_flat, w_eps, EPS_FIELDS),
        eps_flat=eps_flat,
    )


def _blocks_torch(row_ptr, flat, w: int, nfields: int):
    S = row_ptr.shape[0] - 1
    lo = row_ptr[:-1]
    deg = row_ptr[1:] - row_ptr[:-1]
    lane = torch.arange(w, dtype=torch.int32, device=row_ptr.device)
    valid = lane[None, :] < deg[:, None]
    arc = torch.where(valid, lo[:, None] + lane[None, :], 0)
    if flat.shape[0] == 0:
        rows = torch.zeros((S, w, nfields), dtype=torch.int32, device=row_ptr.device)
    else:
        rows = flat.reshape(-1, nfields)[arc.long()]
    w_bits = torch.where(valid, rows[..., 0], INF_BITS)
    rest = torch.where(valid[..., None], rows[..., 1:], 0)
    blk = torch.cat([w_bits[..., None], rest], dim=-1)
    return torch.cat(
        [blk.reshape(S, w * nfields), lo[:, None], deg[:, None]], dim=1
    ).to(torch.int32).contiguous()


def pack_graph_device(
    graph: CsrGraph, w_em: int, w_eps: int, flat_group: int, device
) -> PackedGraph:
    """Packed tables as int32 tensors on ``device``.

    Only the flat tables are uploaded; the block tables, which repeat the
    flat arc data about W-fold, are built on the device.  The result
    equals ``packed_from_numpy(pack_graph(...), device)``."""
    ga = graph.arrays
    _, em_flat_p, eps_flat = _flat_tables(graph, flat_group)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=torch.int32)

    em_flat_t, eps_flat_t = up(em_flat_p), up(eps_flat)
    return PackedGraph(
        em_block=_blocks_torch(up(ga.em_row_ptr), em_flat_t, w_em, EM_FIELDS),
        em_flat=em_flat_t,
        eps_block=_blocks_torch(up(ga.eps_row_ptr), eps_flat_t, w_eps, EPS_FIELDS),
        eps_flat=eps_flat_t,
    )


def packed_from_numpy(pg, device) -> PackedGraph:
    """Carry the tables of any ``PackedGraph``-shaped tuple (the JAX
    package's device tables, or :func:`pack_graph`'s) onto ``device`` as
    tensors."""
    return PackedGraph(
        *(
            torch.from_numpy(np.array(np.asarray(getattr(pg, f)))).to(device)
            for f in PackedGraph._fields
        )
    )
