"""Dedup by state, top-K frontier selection and lattice records, batched.

The torch counterpart of ``kaldi_decoder_tpu/ops/segment.py``
(``_sort_by_state``, ``_select``, ``dedup_select``, ``dedup_select_rec``,
``score_lookup``) on (B, N) candidate arrays.  Record order decides which links a full
record buffer keeps, so the tie rules of the original are kept exactly:

* the stable 2-key sort by (state, cost) is two stable sorts, by cost
  and then by state, so equal (state, cost) pairs keep candidate order;
* ``lax.top_k`` keeps the lower index on ties, which is what a stable
  ascending sort of the leader costs gives (``torch.topk`` promises no
  order on ties); its float order puts -0.0 below +0.0, where the sorts
  take them as equal, so the leader costs are sorted by their IEEE
  total-order keys;
* extras are ordered by slack with a stable sort, so equal slacks keep
  the state-sorted order;
* the segmented forward fill of each run's minimum is a gather at the
  index of the lane's run leader.

:func:`dedup_select_rec` is the plain version of K2
(:mod:`kaldi_decoder_tpu_torch.kernels.dedup_rec`), the lattice frame's
dedup/select/records region, and :func:`dedup_select` the plain version
of K6 (:mod:`kaldi_decoder_tpu_torch.kernels.dedup`): the wrappers run
them for CPU tensors, and on the card they are the kernels' oracles.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INF = float("inf")


class Selection(NamedTuple):
    states: torch.Tensor  # (B, K) int32 — new frontier, cost-sorted
    costs: torch.Tensor  # (B, K) float32 — +inf for empty slots
    cand_idx: torch.Tensor  # (B, K) int32 — winning candidate lane, -1 if empty
    num_unique: torch.Tensor  # (B,) int32 — distinct in-beam states


class SelectionRec(NamedTuple):
    states: torch.Tensor  # (B, K) int32 — new frontier, cost-sorted
    costs: torch.Tensor  # (B, K) float32 — +inf for empty slots
    num_unique: torch.Tensor  # (B,) int32 — distinct in-beam states
    recs: Tuple[torch.Tensor, ...]  # payload columns, (B, R) int32, -1 padded
    rec_overflow: torch.Tensor  # (B,) bool — eligible links exceeded R
    rec_dst: torch.Tensor  # (B, R) int32 — destination state per record
    rec_slack: torch.Tensor  # (B, R) float32 — link slack, +inf on padding
    # (B, K) int32 winning lane per slot, -1 if empty: the eps call's
    # (num_incumbents > 0); None for the emitting call.
    cand_idx: Optional[torch.Tensor] = None


def score_lookup(score_idx: torch.Tensor, scores_t: torch.Tensor) -> torch.Tensor:
    """Acoustic log-prob per lane, ``scores_t[b, score_idx[b, i]]`` (the
    DecodableCtc lookup, `decodable-ctc.cc:22-29`)."""
    return scores_t.gather(1, score_idx.long())


def _sort_by_state(cand_state, cand_cost, num_states: int, payload):
    """Stable sort by (state, cost); invalid (+inf) candidates get state
    ``num_states`` and sink to the end.  Returns (s2, c2, pay2, leader):
    the first lane of each equal-state run is its per-state minimum."""
    skey = torch.where(torch.isfinite(cand_cost), cand_state, num_states)
    # The original's sort comparator takes -0.0 and +0.0 as equal; fold
    # them so that no backend's float sort tells them apart.
    ckey = torch.where(cand_cost == 0, 0.0, cand_cost)
    _, by_cost = torch.sort(ckey, dim=1, stable=True)
    s2, by_state = torch.sort(skey.gather(1, by_cost), dim=1, stable=True)
    perm = by_cost.gather(1, by_state)
    c2 = cand_cost.gather(1, perm)
    pay2 = tuple(p.gather(1, perm) for p in payload)
    leader = torch.ones_like(s2, dtype=torch.bool)
    leader[:, 1:] = s2[:, 1:] != s2[:, :-1]
    return s2, c2, pay2, leader


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """int32 keys of float32 values in IEEE total order (-0.0 below +0.0),
    the order of ``lax.top_k``."""
    b = x.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _select(s2, c2, leader, k: int, num_states: int):
    """The K cheapest run leaders form the new frontier.  Returns
    (states, costs, num_unique, pos) with ``pos`` the winners' sorted
    positions."""
    lcost = torch.where(leader & (s2 < num_states), c2, INF)
    _, pos = torch.sort(_total_order(lcost), dim=1, stable=True)
    pos = pos[:, :k]
    costs = lcost.gather(1, pos)
    live = torch.isfinite(costs)
    states = torch.where(live, s2.gather(1, pos), 0).to(torch.int32)
    num_unique = torch.isfinite(lcost).sum(dim=1, dtype=torch.int32)
    return states, costs, num_unique, pos


def dedup_select(
    cand_state: torch.Tensor,  # (B, N) int32
    cand_cost: torch.Tensor,  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
) -> Selection:
    """Per-state min-cost dedup, then the K cheapest states, with each
    slot's winning lane (the original's ``need_idx=True`` call).  A
    state's winner is its cheapest lane, the lowest lane among equal
    costs; the frontier is ordered by (cost, state).  With fewer than K
    lanes the frontier is padded as an empty slot is (state 0, +inf,
    lane -1)."""
    B, n = cand_cost.shape
    lane = torch.arange(n, dtype=torch.int32, device=cand_cost.device).expand(B, n)
    s2, c2, (i2,), leader = _sort_by_state(cand_state, cand_cost, num_states, (lane,))
    states, costs, num_unique, pos = _select(s2, c2, leader, k, num_states)
    live = torch.isfinite(costs)
    cand_idx = torch.where(live, i2.gather(1, pos), -1).to(torch.int32)
    if n < k:
        pad = k - n
        states = torch.nn.functional.pad(states, (0, pad))
        costs = torch.nn.functional.pad(costs, (0, pad), value=INF)
        cand_idx = torch.nn.functional.pad(cand_idx, (0, pad), value=-1)
    return Selection(states, costs, cand_idx, num_unique)


def dedup_select_rec(
    cand_state: torch.Tensor,  # (B, N) int32
    cand_cost: torch.Tensor,  # (B, N) float32, +inf == invalid
    k: int,
    num_states: int,
    r: int,
    slack_beam: float,
    payload: Tuple[torch.Tensor, ...],  # (B, N) int32 columns to record
    num_incumbents: int = 0,
) -> SelectionRec:
    """Per-state min-cost dedup, the K cheapest states, and lattice
    records: the winners' own links first, then up to ``r`` minus the
    winners extra links by smallest slack ``cost - winner_cost(dst)`` at
    most ``slack_beam``.  The original's calls with ``sweep_cols=True``:
    the lattice emitting stage's (``need_idx=False``, no incumbents) and,
    with ``num_incumbents``, the eps iteration's (``need_idx=True``): its
    first ``num_incumbents`` lanes are carried tokens, not links, so they
    take part in the dedup and the frontier (the lowest lane wins a tie,
    so an incumbent keeps its slot against an equal-cost eps lane) but
    never become records, and ``cand_idx`` gives each slot's winning
    lane."""
    B, n = cand_cost.shape
    extra = ()
    if num_incumbents:
        extra = (torch.arange(n, dtype=torch.int32, device=cand_cost.device).expand(B, n),)
    s2, c2, pay2, leader = _sort_by_state(cand_state, cand_cost, num_states, payload + extra)
    states, costs, num_unique, pos = _select(s2, c2, leader, k, num_states)
    cand_idx = None
    is_link = True
    if num_incumbents:
        pay2, i2 = pay2[:-1], pay2[-1]
        cand_idx = torch.where(torch.isfinite(costs), i2.gather(1, pos), -1).to(torch.int32)
        is_link = i2 >= num_incumbents

    if r <= k:
        # Winners-only budget: records are the frontier winners in slot order.
        okr = torch.isfinite(costs[:, :r])
        if num_incumbents:
            okr = okr & (cand_idx[:, :r] >= num_incumbents)
        posk = pos[:, :r]
        recs = tuple(
            torch.where(okr, p.gather(1, posk), -1).to(torch.int32) for p in pay2
        )
        num_valid = torch.isfinite(c2).sum(dim=1, dtype=torch.int32)
        return SelectionRec(
            states=states,
            costs=costs,
            num_unique=num_unique,
            recs=recs,
            rec_overflow=num_valid > r,
            rec_dst=torch.where(okr, states[:, :r], -1).to(torch.int32),
            rec_slack=torch.where(okr, 0.0, INF).to(torch.float32),
            cand_idx=cand_idx,
        )

    lane = torch.arange(n, device=c2.device).expand(B, n)
    run_leader = torch.where(leader, lane, 0).cummax(dim=1).values
    run_min = c2.gather(1, run_leader)
    slack = c2 - run_min
    run_sel = run_min <= costs[:, k - 1 : k]
    finite = torch.isfinite(c2)
    win_link = leader & run_sel & finite & is_link
    extra_ok = (~leader) & run_sel & finite & is_link & (slack <= slack_beam)
    # Winner links first (key -1 guarantees them a slot), then extras by
    # ascending slack; the stable sort keeps state-sorted order on ties.
    # The original's comparator takes a -0.0 slack as equal to +0.0: fold
    # them so that no backend's float sort tells them apart.
    key = torch.where(win_link, -1.0, torch.where(extra_ok, slack, INF))
    key = torch.where(key == 0, 0.0, key)
    skey, order = torch.sort(key, dim=1, stable=True)
    take = min(r, n)
    skey, order = skey[:, :take], order[:, :take]
    ok_r = skey < INF
    recs = tuple(
        torch.where(ok_r, p.gather(1, order), -1).to(torch.int32) for p in pay2
    )
    rec_dst = torch.where(ok_r, s2.gather(1, order), -1).to(torch.int32)
    # Winner rows carry key -1 but their slack is 0 by definition.  The
    # original's ``maximum(key, 0.0)`` gives +0.0 for a -0.0 slack, where
    # ``clamp_min`` would keep -0.0.
    rec_slack = torch.where(ok_r, torch.where(skey > 0, skey, 0.0), INF).to(torch.float32)
    if take < r:  # record budget beyond the candidate count: pad
        pad = torch.full((B, r - take), -1, dtype=torch.int32, device=c2.device)
        recs = tuple(torch.cat([p, pad], dim=1) for p in recs)
        rec_dst = torch.cat([rec_dst, pad], dim=1)
        rec_slack = torch.cat([rec_slack, torch.full_like(pad, INF, dtype=torch.float32)], dim=1)
    rec_overflow = (key < INF).sum(dim=1) > r
    return SelectionRec(
        states=states,
        costs=costs,
        num_unique=num_unique,
        recs=recs,
        rec_overflow=rec_overflow,
        rec_dst=rec_dst,
        rec_slack=rec_slack,
        cand_idx=cand_idx,
    )
