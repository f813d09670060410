"""Regexp and approximate search stepped over index row ranges.

The reference's do_regexp_query (src/main/server.c:1656, pseudocode at
1711-1790): a queue_map of ([first,last], matched-string) -> per-NFA-state
error counts; each popped entry computes its reachable characters,
batch-requests Occ for every candidate character, forks new ranges, and
merges state vectors on range collision; final states emit match ranges.

Here, as in femto_tpu, the frontier is expanded one *character layer* at a
time: all (entry, char) forks of the whole frontier become ONE batched
backward step on the index's device (kernel C's backward_step on the
card, ops/search_ops.backward_step_pair).  The host keeps the small NFA
state vectors and the dedup map.

Approximate search: state = cost per NFA state (cost_bound == not
present), with substitution/insertion applied on character steps and
deletion applied as a transitive relaxation — the reference's
nfa_errcnt_t semantics (nfa.h:74-120).  Substitutions are never applied
on the first backward step (the pattern's last character), matching
QUERY_FORMAT.txt's documented speedup.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..alphabet import ALPHA_SIZE
from ..fmindex import FMIndex
from ..ops import search_ops as S
from .ast import ApproxSettings
from .nfa import NFA


@dataclasses.dataclass
class RegexpMatch:
    first: int
    last: int
    cost: int
    match: bytes  # matched string, in alphabet order (forward text order)


def _bucket(x: int, minimum: int = 64) -> int:
    b = minimum
    while b < x:
        b *= 2
    return b


def _backward_step(index: FMIndex, cs, firsts, lasts):
    B = len(cs)
    Bp = _bucket(B)
    c = np.full(Bp, -1, dtype=np.int32)
    f = np.zeros(Bp, dtype=np.int32)
    l = np.zeros(Bp, dtype=np.int32)
    c[:B], f[:B], l[:B] = cs, firsts, lasts
    # paged index (paged.PagedIndex): fault the layer's segment demand in
    # before the dispatch — the host frontier engine is naturally
    # compatible with paging because each layer's ranges live on the host
    ensure = getattr(index, "_ensure_rows", None)
    if ensure is not None:
        ensure(np.concatenate([f[:B], l[:B]]))
    dev = index.device
    nf, nl = S.backward_step_pair(
        index.arrays, torch.from_numpy(c).to(dev),
        torch.from_numpy(f).to(dev), torch.from_numpy(l).to(dev))
    return nf.cpu().numpy()[:B], nl.cpu().numpy()[:B]


NO_COST = 0xFF


class _NFAMats:
    """Flattened transition arrays for vectorized batched stepping:
    src[T], dst[T], mask[T, ALPHA]."""

    def __init__(self, nfa: NFA):
        src, dst, masks = [], [], []
        for s in range(nfa.num_states):
            for mask, t in nfa.trans[s]:
                src.append(s)
                dst.append(t)
                masks.append(mask)
        self.num_states = nfa.num_states
        self.src = np.asarray(src, dtype=np.int64)
        self.dst = np.asarray(dst, dtype=np.int64)
        if masks:
            self.mask = np.stack(masks)  # [T, ALPHA]
        else:
            self.mask = np.zeros((0, ALPHA_SIZE), dtype=bool)


def _nfa_mats(nfa: NFA) -> _NFAMats:
    if not hasattr(nfa, "_mats"):
        nfa._mats = _NFAMats(nfa)
    return nfa._mats


def _start_costs(nfa: NFA, settings: ApproxSettings) -> np.ndarray:
    """Initial cost vector: start state at 0, plus deletion relaxation."""
    costs = np.full((1, nfa.num_states), NO_COST, dtype=np.int32)
    costs[0, 0] = 0
    return _relax_deletions_batch(_nfa_mats(nfa), costs, settings)[0]


def _relax_deletions_batch(mats: _NFAMats, costs: np.ndarray,
                           settings: ApproxSettings) -> np.ndarray:
    """Deletion = pattern character missing from the data: advance the NFA
    without consuming a text character, paying delete_cost.
    costs: int32[E, S], relaxed in place (returned)."""
    if settings.cost_bound <= 1 or len(mats.src) == 0:
        return costs
    E, S = costs.shape
    rounds = max(1, -(-settings.cost_bound // max(settings.delete_cost, 1)))
    eidx = np.repeat(np.arange(E), len(mats.src))
    didx = np.tile(mats.dst, E)
    for _ in range(rounds):
        cand = costs[:, mats.src] + settings.delete_cost  # [E, T]
        before = costs.copy()
        np.minimum.at(costs, (eidx, didx), cand.reshape(-1))
        costs[costs >= settings.cost_bound] = NO_COST
        if (costs == before).all():
            break
    return costs


def _step_costs_batch(mats: _NFAMats, costs: np.ndarray, cs: np.ndarray,
                      settings: ApproxSettings,
                      allow_subst: bool) -> np.ndarray:
    """Advance a batch of cost vectors by their text characters.
    costs: int32[E, S]; cs: int[E]; returns int32[E, S]."""
    E, S = costs.shape
    out = np.full((E, S), NO_COST, dtype=np.int32)
    if len(mats.src):
        tc = mats.mask[:, cs].T                      # [E, T] char matches
        base = costs[:, mats.src]                    # [E, T]
        exact = np.where(tc, base, NO_COST)
        eidx = np.repeat(np.arange(E), len(mats.src))
        didx = np.tile(mats.dst, E)
        np.minimum.at(out, (eidx, didx), exact.reshape(-1))
        if allow_subst and settings.cost_bound > 1:
            sub = np.where(~tc, base + settings.subst_cost, NO_COST)
            np.minimum.at(out, (eidx, didx), sub.reshape(-1))
    if settings.cost_bound > 1:
        # insertion: extra character in the data; stay in the same state
        out = np.minimum(out, costs + settings.insert_cost)
    out[out >= settings.cost_bound] = NO_COST
    return _relax_deletions_batch(mats, out, settings)


def _step_costs(nfa: NFA, costs: np.ndarray, c: int,
                settings: ApproxSettings, allow_subst: bool) -> np.ndarray:
    """Single-entry wrapper over the batched stepper."""
    return _step_costs_batch(
        _nfa_mats(nfa), costs[None, :].copy(), np.asarray([c]),
        settings, allow_subst,
    )[0]


def _reachable_chars(nfa: NFA, costs: np.ndarray,
                     settings: ApproxSettings) -> np.ndarray:
    """Candidate characters: exact transitions from live states; under
    approximate settings, any character may extend (subst/insert)."""
    live = costs < settings.cost_bound
    if not live.any():
        return np.zeros(ALPHA_SIZE, dtype=bool)
    approx = settings.cost_bound > 1 and (
        (costs[live].min() + min(settings.subst_cost, settings.insert_cost))
        < settings.cost_bound
    )
    if approx:
        m = np.ones(ALPHA_SIZE, dtype=bool)
        m[:5] = False
        return m
    m = np.zeros(ALPHA_SIZE, dtype=bool)
    for s in np.nonzero(live)[0]:
        m |= nfa.char_union[s]
    return m


def _final_cost(nfa: NFA, costs: np.ndarray,
                settings: ApproxSettings) -> Optional[int]:
    c = costs[nfa.accept].min() if nfa.accept.any() else NO_COST
    return int(c) if c < settings.cost_bound else None


def run_regexp(
    index: FMIndex,
    nfa: NFA,
    settings: ApproxSettings = ApproxSettings.exact(),
    max_results: int = 10000,
    max_frontier: int = 65536,
    max_len: int = 256,
) -> List[RegexpMatch]:
    """Find all matching strings as (row range, cost, string)."""
    # Start from the REAL row space [row0, n_rows): shape-padded and
    # sharded builds keep pad suffixes as leading rows (fmindex.FMMeta),
    # exactly like backward_search's init (ops/search_ops.py:35-37).
    row0 = index.meta.row0
    n_rows = index.meta.n_rows
    results: List[RegexpMatch] = []

    costs0 = _start_costs(nfa, settings)
    # Frontier entries: (first, last, costs, matched-bytes-reversed)
    frontier: List[Tuple[int, int, np.ndarray, bytes]] = [
        (row0, n_rows, costs0, b"")
    ]
    fc0 = _final_cost(nfa, costs0, settings)
    if fc0 is not None:
        results.append(RegexpMatch(row0, n_rows, fc0, b""))

    depth = 0
    while frontier and depth < max_len and len(results) < max_results:
        depth += 1
        # fork every entry by its reachable characters; one batched device
        # call for the whole layer
        cs: List[int] = []
        fs: List[int] = []
        ls: List[int] = []
        owners: List[int] = []
        for ei, (f, l, costs, _s) in enumerate(frontier):
            for c in np.nonzero(_reachable_chars(nfa, costs, settings))[0]:
                cs.append(int(c))
                fs.append(f)
                ls.append(l)
                owners.append(ei)
        if not cs:
            break
        nf, nl = _backward_step(index, cs, fs, ls)

        # batch-step all surviving forks' cost vectors at once
        allow_subst = depth > 1  # no substitution at the pattern's last char
        surv = [i for i in range(len(cs)) if nl[i] > nf[i]]
        nxt: Dict[Tuple[int, int], Tuple[np.ndarray, bytes]] = {}
        if surv:
            mats = _nfa_mats(nfa)
            cost_block = np.stack([frontier[owners[i]][2] for i in surv])
            char_block = np.asarray([cs[i] for i in surv])
            stepped = _step_costs_batch(
                mats, cost_block, char_block, settings, allow_subst
            )
            # merge forks into the next frontier (add_mapping semantics:
            # range collision -> min-merge cost vectors, server.c:1571-1653)
            for j, i in enumerate(surv):
                nc = stepped[j]
                if (nc >= settings.cost_bound).all():
                    continue
                c = cs[i]
                key = (int(nf[i]), int(nl[i]))
                s0 = frontier[owners[i]][3]
                new_s = bytes([c - 5]) + s0 if c >= 5 else s0
                if key in nxt:
                    old_c, old_s = nxt[key]
                    nxt[key] = (np.minimum(old_c, nc), old_s)
                else:
                    nxt[key] = (nc, new_s)
        frontier = []
        for (f2, l2), (nc, s) in nxt.items():
            fc = _final_cost(nfa, nc, settings)
            if fc is not None:
                results.append(RegexpMatch(f2, l2, fc, s))
            # keep extending while any state is live
            if (nc < settings.cost_bound).any():
                frontier.append((f2, l2, nc, s))
            if len(frontier) >= max_frontier:
                break

    return dedupe_matches(results)


def dedupe_matches(matches: List[RegexpMatch]) -> List[RegexpMatch]:
    """Drop duplicate ranges (keeping min cost) AND prune ranges entirely
    subsumed by a containing result — the reference's sort + subsumption
    prune (server.c:1476-1563): regexp_result_cmp orders (first asc,
    last DESC) so the widest range leads and nested ranges (longer
    strings inside a shorter string's row range, e.g. 'ab' within 'a'
    for 'a|ab') are removed for an accurate result count."""
    best: Dict[Tuple[int, int], RegexpMatch] = {}
    for m in matches:
        key = (m.first, m.last)
        if key not in best or m.cost < best[key].cost:
            best[key] = m
    out: List[RegexpMatch] = []
    cf = cl = None
    for m in sorted(best.values(), key=lambda m: (m.first, -m.last)):
        if cf is not None and m.first >= cf and m.last <= cl:
            continue
        out.append(m)
        cf, cl = m.first, m.last
    return out


def match_rows(matches: List[RegexpMatch]) -> List[Tuple[int, int]]:
    """Union of match row ranges as disjoint intervals (for counting
    distinct matching positions)."""
    iv = sorted((m.first, m.last) for m in matches)
    out: List[Tuple[int, int]] = []
    for f, l in iv:
        if out and f <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], l))
        else:
            out.append((f, l))
    return out
