"""Device-side lockstep regex frontier: the NFA search with its state on the
card.

The host engine (regexp.py) keeps NFA state vectors on the host and
dispatches one backward step per character layer.  This module keeps the
frontier on the index's device: a fixed-capacity array of (first, last,
per-state cost) entries advances one character layer per step — forking
every live entry by every alphabet symbol, ranking all forks of the layer
at once, min-merging duplicate ranges and compacting back to capacity —
the queue_map of the reference's server.c:1656 as a device array stepped
in lockstep (femto_tpu's query/regexp_device.py).

A layer is three kernels on the card (ops/regex_ops.py regex_fork, kernel
H's stable radix sort over the forks' (first, last) keys, regex_merge);
the host loop replaces femto_tpu's lax.while_loop and reads one int32 per
layer (the next frontier's live count, or -1 on overflow), which also
sizes the next layer's fork grid.  The frontier, costs and results stay on
the card; one read at the end brings the results back.  last_stats says
what the last search did.

Supports exact and approximate (cost-vector) matching with the same
semantics as regexp.py; with_strings=True reconstructs each match's
string by one psi walk (kernel E).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..alphabet import ALPHA_SIZE, CHARACTER_OFFSET
from ..fmindex import FMIndex
from ..ops import regex_ops as RO
from ..ops import search_ops as S
from ..ops import sort_ops as SO
from .ast import ApproxSettings
from .nfa import NFA
from .regexp import NO_COST, RegexpMatch, _nfa_mats, _start_costs, dedupe_matches

# What the last search did: layers stepped, the largest live frontier,
# host reads of device memory (one per layer, one for the results, one
# for the strings), and the capacities of the run that answered.
last_stats: Dict[str, object] = {}


def _bucket(x: int, m: int) -> int:
    return max(m, -(-x // m) * m)


def _nfa_device_arrays(nfa: NFA, device) -> RO.FrontierNFA:
    """The NFA's transition arrays on the device, padded to shape buckets
    as femto_tpu pads them (S to 16 states, T to 32 transitions; pad
    transitions 0 -> 0 with all-false masks, pad states unreachable), in
    the per-transition form and grouped by destination."""
    mats = _nfa_mats(nfa)
    T = _bucket(len(mats.src), 32)
    S_ = _bucket(nfa.num_states, 16)
    src = np.zeros(T, np.int64)
    dst = np.zeros(T, np.int64)
    mask = np.zeros((T, ALPHA_SIZE), bool)
    if len(mats.src):
        src[: len(mats.src)] = mats.src
        dst[: len(mats.dst)] = mats.dst
        mask[: len(mats.src)] = mats.mask
    accept = np.zeros(S_, np.int32)
    accept[: nfa.num_states] = nfa.accept
    order = np.argsort(dst, kind="stable")
    in_off = np.zeros(S_ + 1, np.int32)
    np.cumsum(np.bincount(dst, minlength=S_), out=in_off[1:])
    words = np.zeros((T, RO.MASK_WORDS * 32), bool)
    words[:, :ALPHA_SIZE] = mask[order]
    in_mask = np.packbits(words.reshape(T, RO.MASK_WORDS, 32), axis=2,
                          bitorder="little").view("<u4")[..., 0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return RO.FrontierNFA(
        S=S_, T=T, src=put(src), dst=put(dst), mask=put(mask),
        accept=put(accept), in_off=put(in_off),
        in_src=put(src[order].astype(np.int32)),
        in_mask=put(in_mask.view(np.int32)))


def run_regexp_device(
    index: FMIndex,
    nfa: NFA,
    settings: ApproxSettings = ApproxSettings.exact(),
    frontier_cap: int = 256,
    results_cap: int = 4096,
    max_len: int = 64,
    with_strings: bool = False,
    max_frontier_cap: int = 16384,
    max_results_cap: int = 262144,
    max_max_len: int = 1024,
    on_layer: Optional[Callable] = None,
) -> List[RegexpMatch]:
    """Device-frontier regex search.

    with_strings=True reconstructs each matched string by a batched
    psi-walk from the match's first row (its length equals the layer depth
    it was found at); otherwise matches carry match=b"".  On capacity
    overflow (frontier, results, or match length) the capacities grow
    fourfold and the search re-runs on the device (the growth analog of
    the reference's unbounded queue_map, server.c:1656); FrontierOverflow
    is raised only past the max_* caps (callers then fall back to the host
    engine).  A kernel that fails to build or launch, or memory that runs
    out, raises its own error.  on_layer(depth, n_live, nd, cfg, bufs), when
    given, is called before every layer of every run (bufs: first, last,
    costs, res, state on the device)."""
    retries = 0
    while True:
        try:
            out = _run_regexp_device_once(
                index, nfa, settings, frontier_cap, results_cap, max_len,
                with_strings, on_layer,
            )
            last_stats["retries"] = retries
            return out
        except _DeviceCapacityOverflow:
            if (frontier_cap >= max_frontier_cap
                    and results_cap >= max_results_cap
                    and max_len >= max_max_len):
                raise FrontierOverflow(
                    "device regex frontier overflow at maximum capacities"
                )
            frontier_cap = min(frontier_cap * 4, max_frontier_cap)
            results_cap = min(results_cap * 4, max_results_cap)
            max_len = min(max_len * 4, max_max_len)
            retries += 1


class FrontierOverflow(RuntimeError):
    """The search outgrew the device frontier's maximum capacities: the
    one error on which the engine answers through the host engine."""


class _DeviceCapacityOverflow(Exception):
    """One run outgrew its capacities; run_regexp_device grows them."""


def _initial_state(index: FMIndex, nfa: NFA, settings: ApproxSettings,
                   frontier_cap: int, results_cap: int):
    """(nfa arrays, layer settings, [first, last, costs, res, state]) of a
    search that has not stepped: entry 0 spans the REAL row space
    [row0, n_rows) with the start costs, and the start entry is recorded
    as a result if it already accepts.  Made on the host, one copy each
    to the index's device."""
    dev = index.device
    nd = _nfa_device_arrays(nfa, dev)
    S_pad, F, R = nd.S, frontier_cap, results_cap
    n, row0 = index.meta.n_rows, index.meta.row0
    c0 = np.full(S_pad, NO_COST, np.int32)
    c0[: nfa.num_states] = _start_costs(nfa, settings).astype(np.int32)
    del_rounds = (
        0 if settings.cost_bound <= 1
        else max(1, -(-settings.cost_bound // max(settings.delete_cost, 1)))
    )
    cfg = RO.LayerCfg(
        cost_bound=settings.cost_bound, subst=settings.subst_cost,
        delete=settings.delete_cost, insert=settings.insert_cost,
        del_rounds=del_rounds, half_bits=RO.half_bits_for(n))
    first = np.zeros(F, np.int32)
    last = np.zeros(F, np.int32)
    costs = np.full((F, S_pad), NO_COST, np.int32)
    first[0], last[0], costs[0] = row0, n, c0
    res = np.zeros((4, R), np.int32)
    res[2] = NO_COST
    state = np.zeros(RO.STATE_LEN, np.int32)
    accept = np.zeros(S_pad, bool)
    accept[: nfa.num_states] = nfa.accept
    acc0 = int(np.min(np.where(accept, c0, NO_COST)))
    res[0, 0] = row0
    if acc0 < settings.cost_bound:
        res[1, 0], res[2, 0], state[0] = n, acc0, 1
    return nd, cfg, [torch.from_numpy(a).to(dev)
                     for a in (first, last, costs, res, state)]


def _layer(index: FMIndex, nd: RO.FrontierNFA, cfg: RO.LayerCfg, depth: int,
           n_live: int, first, last, costs, res, state, rank=None) -> int:
    """One character layer from the n_live live entries: fork (kernel R),
    sort the forks by (first, last) (kernel H), merge (kernel R) into the
    frontier and results in place.  Returns the next live count, -1 on
    overflow: the layer's one read from the device.  rank: the sharded
    frontier's hook, rank(first, last, n_live) -> the forks' new ranges
    (int32[n_live * 261] each), which kernel R's regex_fork_ranked takes
    in place of ranking them itself."""
    if rank is None:
        keys, fcosts = RO.regex_fork(index.arrays, first, last, costs,
                                     n_live, nd, cfg, allow_subst=depth > 0)
    else:
        nf, nl = rank(first, last, n_live)
        keys, fcosts = RO.regex_fork_ranked(nf, nl, costs, n_live, nd, cfg,
                                            allow_subst=depth > 0)
        del nf, nl
    skeys, sidx = SO.radix_sort_pairs(keys, None, 0, 2 * cfg.half_bits)
    RO.regex_merge(skeys, sidx, fcosts, nd, cfg, depth, first, last, costs,
                   res, state)
    return int(state[3])


def _run_regexp_device_once(
    index: FMIndex,
    nfa: NFA,
    settings: ApproxSettings,
    frontier_cap: int,
    results_cap: int,
    max_len: int,
    with_strings: bool,
    on_layer: Optional[Callable] = None,
    rank: Optional[Callable] = None,
) -> List[RegexpMatch]:
    R = results_cap
    nd, cfg, bufs = _initial_state(index, nfa, settings, frontier_cap,
                                   results_cap)
    res, state = bufs[3], bufs[4]
    n_live, depth, reads, widest = 1, 0, 0, 1
    while n_live > 0 and depth < max_len:
        if on_layer is not None:
            on_layer(depth, n_live, nd, cfg, bufs)
        status = _layer(index, nd, cfg, depth, n_live, *bufs, rank=rank)
        reads += 1
        if status < 0:
            raise _DeviceCapacityOverflow(
                "device regex frontier overflow; raise frontier_cap/"
                "results_cap")
        n_live = status
        widest = max(widest, n_live)
        depth += 1
    # Stopping at max_len with a live frontier would silently drop longer
    # matches — report it as overflow so callers retry/fall back.
    if n_live > 0:
        raise _DeviceCapacityOverflow("device regex match longer than "
                                      "max_len")
    out = torch.cat([res.reshape(-1), state]).cpu().numpy()
    reads += 1
    cnt = int(out[4 * R])
    rf, rl, rc, rlen = (out[i * R: i * R + cnt] for i in range(4))
    strings = [b""] * cnt
    if with_strings and cnt:
        strings = _reconstruct_strings(index, rf, rlen)
        reads += 1
    last_stats.update(layers=depth, max_live=widest, reads=reads,
                      frontier_cap=frontier_cap, results_cap=R,
                      max_len=max_len, results=cnt)
    return dedupe_matches(
        [RegexpMatch(int(f), int(l), int(c), s)
         for f, l, c, s in zip(rf, rl, rc, strings)]
    )


def _reconstruct_strings(index: FMIndex, rows: np.ndarray,
                         lens: np.ndarray) -> List[bytes]:
    """One forward psi walk of max(lens) steps from every match's first
    row: the suffix at any row of a match range starts with the matched
    string (forward_query semantics)."""
    maxlen = int(lens.max()) if len(rows) else 0
    if maxlen == 0:
        return [b""] * len(rows)
    rr = torch.from_numpy(rows.astype(np.int32)).to(index.device)
    cols = S.psi_walk(index.arrays, rr, maxlen).cpu().numpy()
    out = []
    for i in range(len(rows)):
        seq = cols[i, : int(lens[i])]
        out.append(bytes(int(b) - CHARACTER_OFFSET for b in seq
                         if b >= CHARACTER_OFFSET))
    return out
