"""Link recall: the device lattice's links against the exact oracle's.

The measurement of ``scripts/measure_recall.py`` in the port: one
utterance is decoded by an :class:`OracleLatticeDecoder` (on the host)
and by a :class:`BatchedLatticeDecoder` with ``device_prune=False``, and
the two lattices' canonical link sets are compared.  The caller builds
both decoders with the configuration it measures.  ``oracle_link_set``
and ``device_link_set`` are copies of ``tests/_lattice_util.py:6-51``.
"""

from __future__ import annotations

import time

import numpy as np

from kaldi_decoder_tpu_torch.decodable import DecodableCtc
from kaldi_decoder_tpu_torch.decoders.lattice import BatchedLatticeDecoder
from kaldi_decoder_tpu_torch.decoders.ref_lattice import OracleLatticeDecoder
from kaldi_decoder_tpu_torch.fst.ops import path_labels


def oracle_link_set(d):
    """Canonical link set {(f_src, state_src, f_dst, state_dst, il, ol,
    g, a)} from an OracleLatticeDecoder's pruned token structure."""
    where = {}
    for f, toks in enumerate(d.active_toks):
        for state, tok in toks.items():
            where[id(tok)] = (f, state)
    links = set()
    for f, toks in enumerate(d.active_toks):
        for state, tok in toks.items():
            for l in tok.links:
                if id(l.next_tok) not in where:
                    continue
                fd, sd = where[id(l.next_tok)]
                links.add(
                    (f, state, fd, sd, l.ilabel, l.olabel,
                     round(float(l.graph_cost), 3), round(float(l.ac_cost), 3))
                )
    return links


def device_link_set(res, b=0):
    """Same canonical link set from a LatticeResult's pruned lattice."""
    pl = res._prune(b)
    assert pl is not None
    links = set()
    for f in range(pl.num_frames + 1):
        toks = pl.tokens[f]
        for lk, fd in (
            (pl.eps_links[f], f),
            (pl.em_links[f] if f < pl.num_frames else None, f + 1),
        ):
            if lk is None:
                continue
            dtoks = pl.tokens[fd]
            for i in range(len(lk.src)):
                if not lk.keep[i]:
                    continue
                links.add(
                    (
                        f,
                        int(toks.states[lk.src[i]]),
                        fd,
                        int(dtoks.states[lk.dst[i]]),
                        int(lk.ilabel[i]),
                        int(lk.olabel[i]),
                        round(float(lk.graph_cost[i]), 3),
                        round(float(lk.ac_cost[i]), 3),
                    )
                )
    return links


def oracle_lattice(oracle: OracleLatticeDecoder, scores: np.ndarray):
    """``oracle``'s decode of one utterance's (T, V) scores: (link set,
    best-path labels or None, seconds)."""
    t0 = time.perf_counter()
    oracle.decode(DecodableCtc(scores))
    links = oracle_link_set(oracle)
    best = oracle.get_best_path()
    return links, (path_labels(best) if best is not None else None), time.perf_counter() - t0


def device_recall(dec: BatchedLatticeDecoder, scores: np.ndarray, olinks, olabels,
                  chunk_frames: int) -> dict:
    """Decode one utterance's (T, V) scores with ``dec``
    (``device_prune=False``, chunks of ``chunk_frames``) and compare its
    link set and best path with the oracle's."""
    T = scores.shape[0]
    t0 = time.perf_counter()
    res = dec.decode(scores[None], np.array([T], np.int32), chunk_frames=chunk_frames,
                     device_prune=False)
    seconds = time.perf_counter() - t0
    dlat = res.best_path(0)
    dlinks = device_link_set(res)
    st = res.stats(0)
    hit = len(olinks & dlinks)
    f = dec.cfg.frontier
    return {
        "em_records": dec.cfg.em_records,
        "recall": hit / max(len(olinks), 1),
        "device_links": len(dlinks),
        "oracle_links": len(olinks),
        "common_links": hit,
        "extra": len(dlinks - olinks),
        "overflow_frames": int(st.arc_budget_overflows),
        "saturated_frames": int(st.frontier_saturated_frames),
        "best_path_match": bool(dlat is not None and path_labels(dlat) == olabels),
        "seconds": seconds,
        "device_config": dict({k: getattr(f, k) for k in (
            "beam", "max_active", "min_active", "beam_delta", "frontier_size", "block_width",
            "rem_budget", "flat_group", "eps_iters")},
            em_records=dec.cfg.em_records, lattice_beam=dec.cfg.lattice_beam),
    }
