"""One layer of the device regex frontier: kernel wrappers + plain versions.

The counterparts of the layer body of femto_tpu/query/regexp_device.py
_frontier_loop: regex_fork (steps 1-3: reach, the FM step of every fork,
the forks' cost vectors) and regex_merge (steps 4b-6: min-merge of equal
ranges, results, compaction into the next frontier), both in
csrc/regex_frontier.cu (kernel R); regex_fork_ranked is regex_fork with
the forks' ranges given, the sharded frontier's fork (its ranks are
summed over the mesh before it, parallel/dist_query.py).  The sort
between them is kernel H (ops/sort_ops.radix_sort_pairs) over the keys.
query/regexp_device.py drives them.  Each wrapper launches its kernel for
tensors on the card and takes the plain PyTorch version beside it for
tensors on the CPU; a CUDA tensor never falls back.  The plain versions
repeat femto_tpu's lockstep code; everything is integers, so kernel and
plain version agree bit for bit.

A frontier of capacity F is first, last int32[F] and costs int32[F, S];
its live entries are rows [0, n_live).  A fork of entry f by symbol a is
row f * 261 + a.  Its key is (first << half_bits) | last when it is alive
(reachable, a non-empty range, some state under cost_bound), else DEAD =
2^(2 half_bits) - 1, which sorts after every live key.  The results are
res int32[4, R] (first, last, cost, length) and the state int32[8]:
[0] results so far, [1] overflow (0/1), [2] live entries of the next
frontier, [3] status (that count, -1 on overflow), [4] the results before
the last merge.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..alphabet import ALPHA_SIZE, CHARACTER_OFFSET
from ..fmindex import FMArrays
from . import rank as R
from .search_ops import _index_tensors, fm_view

NO_COST = 0xFF
INT32_MAX = 0x7FFFFFFF
MASK_WORDS = (ALPHA_SIZE + 31) // 32
STATE_LEN = 8


@dataclasses.dataclass
class FrontierNFA:
    """An NFA padded to S states and T transitions (pad transitions 0 -> 0
    with an empty mask, pad states unreachable), on one device, in the two
    forms the layer takes: per transition (src, dst, mask: the plain
    versions) and grouped by destination (in_off, in_src, in_mask as
    uint32 bit words stored in int32: the kernels)."""

    S: int
    T: int
    src: torch.Tensor       # int64[T]
    dst: torch.Tensor       # int64[T]
    mask: torch.Tensor      # bool[T, 261]
    accept: torch.Tensor    # int32[S], 0 or 1
    in_off: torch.Tensor    # int32[S + 1]
    in_src: torch.Tensor    # int32[T]
    in_mask: torch.Tensor   # int32[T, MASK_WORDS]


@dataclasses.dataclass(frozen=True)
class LayerCfg:
    """The cost settings of a search and the key's field width."""

    cost_bound: int
    subst: int
    delete: int
    insert: int
    del_rounds: int
    half_bits: int

    @property
    def dead(self) -> int:
        return (1 << (2 * self.half_bits)) - 1


def half_bits_for(n_rows: int) -> int:
    """Bits of one key field: first < last <= n_rows < 2^bits, so a live
    key's first field is below the dead key's."""
    return max(int(n_rows).bit_length(), 1)


# ---------------------------------------------------------------------------
# regex_fork: steps 1-3 of a layer
# ---------------------------------------------------------------------------


def _segment_min(contrib: torch.Tensor, seg: torch.Tensor, S: int,
                 init: torch.Tensor = None) -> torch.Tensor:
    """min over the last axis of contrib [E, T] grouped by seg[T] -> [E, S]
    (INT32_MAX where a group is empty, or min with init)."""
    E = contrib.shape[0]
    out = (torch.full((E, S), INT32_MAX, dtype=torch.int32,
                      device=contrib.device) if init is None
           else init.clone())
    return out.scatter_reduce(1, seg[None, :].expand(E, -1), contrib,
                              "amin", include_self=True)


def regex_fork_plain(arrays: FMArrays, first: torch.Tensor,
                     last: torch.Tensor, costs: torch.Tensor, n_live: int,
                     nfa: FrontierNFA, cfg: LayerCfg, allow_subst: bool):
    A = ALPHA_SIZE
    chars = torch.arange(A, dtype=torch.int32, device=costs.device).repeat(
        n_live)
    nf, nl = R.backward_step_pair(
        arrays, chars, first[:n_live].repeat_interleave(A),
        last[:n_live].repeat_interleave(A))
    return regex_fork_ranked_plain(nf, nl, costs, n_live, nfa, cfg,
                                   allow_subst)


def regex_fork_ranked_plain(nf: torch.Tensor, nl: torch.Tensor,
                            costs: torch.Tensor, n_live: int,
                            nfa: FrontierNFA, cfg: LayerCfg,
                            allow_subst: bool):
    A = ALPHA_SIZE
    dev = costs.device
    bound = cfg.cost_bound
    approx = bound > 1
    cl = costs[:n_live]                                   # [F', S]
    base_c = cl[:, nfa.src]                               # [F', T]
    reach = ((base_c < bound)[:, :, None] & nfa.mask[None]).any(dim=1)
    if approx:
        any_live = (cl.min(dim=1).values + min(cfg.subst, cfg.insert)
                    < bound)
        sub_ok = torch.arange(A, device=dev) >= CHARACTER_OFFSET
        reach = reach | (any_live[:, None] & sub_ok[None, :])
    valid = reach.reshape(-1) & (nl > nf)
    mT = nfa.mask.T[None]                                 # [1, A, T]
    bc = base_c[:, None, :]                               # [F', 1, T]
    contrib = torch.where(mT, bc, NO_COST)
    if approx:
        sub = (torch.where(~mT, bc + cfg.subst, NO_COST) if allow_subst
               else torch.full_like(contrib, NO_COST))
        contrib = torch.minimum(contrib, sub)
    nc = _segment_min(contrib.reshape(n_live * A, nfa.T).to(torch.int32),
                      nfa.dst, nfa.S)
    if approx:
        nc = torch.minimum(
            nc, (cl + cfg.insert).repeat_interleave(A, dim=0))
    nc = torch.where(nc >= bound, NO_COST, nc)
    for _ in range(cfg.del_rounds):
        relaxed = _segment_min(nc[:, nfa.src] + cfg.delete, nfa.dst, nfa.S,
                               init=nc)
        nc = torch.where(relaxed >= bound, NO_COST, relaxed)
    alive = (nc < bound).any(dim=1) & valid
    keys = torch.where(alive, (nf.long() << cfg.half_bits) | nl.long(),
                       cfg.dead)
    fcosts = torch.where(alive[:, None], nc, NO_COST).to(torch.int32)
    return keys, fcosts


def regex_fork(arrays: FMArrays, first: torch.Tensor, last: torch.Tensor,
               costs: torch.Tensor, n_live: int, nfa: FrontierNFA,
               cfg: LayerCfg, allow_subst: bool):
    """The forks of entries [0, n_live) of a frontier by every symbol:
    (keys int64[n_live * 261], fcosts int32[n_live * 261, S]); a dead
    fork has the DEAD key and a NO_COST row.  Kernel R on the card."""
    F = first.shape[0]
    kernels.check(first, "first", torch.int32, 1)
    kernels.check(last, "last", torch.int32, 1, (F,))
    kernels.check(costs, "costs", torch.int32, 2, (F, nfa.S))
    if not 0 < n_live <= F:
        raise ValueError("need 0 < n_live <= the frontier's capacity")
    if not kernels.on_card(first, last, costs, nfa.in_off,
                           *_index_tensors(arrays)):
        return regex_fork_plain(arrays, first, last, costs, n_live, nfa,
                                cfg, allow_subst)
    kernels.check(nfa.in_off, "in_off", torch.int32, 1, (nfa.S + 1,))
    kernels.check(nfa.in_src, "in_src", torch.int32, 1, (nfa.T,))
    kernels.check(nfa.in_mask, "in_mask", torch.int32, 2,
                  (nfa.T, MASK_WORDS))
    view, lay = fm_view(arrays)
    dev = first.device
    E = n_live * ALPHA_SIZE
    keys = torch.empty(E, dtype=torch.int64, device=dev)
    fcosts = torch.empty((E, nfa.S), dtype=torch.int32, device=dev)
    n_scratch = kernels.size("regex_fork_scratch", n_live, nfa.S)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=dev)
               if n_scratch else None)
    kernels.launch("regex_fork", view, first.data_ptr(), last.data_ptr(),
                   costs.data_ptr(), n_live, nfa.S, nfa.T,
                   nfa.in_off.data_ptr(), nfa.in_src.data_ptr(),
                   nfa.in_mask.data_ptr(), cfg.cost_bound, cfg.subst,
                   cfg.delete, cfg.insert, cfg.del_rounds, int(allow_subst),
                   cfg.half_bits, keys.data_ptr(), fcosts.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   layout=lay)
    return keys, fcosts


def regex_fork_ranked(nf: torch.Tensor, nl: torch.Tensor,
                      costs: torch.Tensor, n_live: int, nfa: FrontierNFA,
                      cfg: LayerCfg, allow_subst: bool):
    """regex_fork with each fork's new range given: nf, nl int32[n_live *
    261] (fork f * 261 + a: entry f's range stepped by symbol a, (0, 0)
    where a is absent), as the sharded frontier sums them over the mesh.
    Same outputs as regex_fork.  Kernel R on the card."""
    F = costs.shape[0]
    E = n_live * ALPHA_SIZE
    kernels.check(costs, "costs", torch.int32, 2, (F, nfa.S))
    kernels.check(nf, "nf", torch.int32, 1, (E,))
    kernels.check(nl, "nl", torch.int32, 1, (E,))
    if not 0 < n_live <= F:
        raise ValueError("need 0 < n_live <= the frontier's capacity")
    if not kernels.on_card(nf, nl, costs, nfa.in_off):
        return regex_fork_ranked_plain(nf, nl, costs, n_live, nfa, cfg,
                                       allow_subst)
    kernels.check(nfa.in_off, "in_off", torch.int32, 1, (nfa.S + 1,))
    kernels.check(nfa.in_src, "in_src", torch.int32, 1, (nfa.T,))
    kernels.check(nfa.in_mask, "in_mask", torch.int32, 2,
                  (nfa.T, MASK_WORDS))
    dev = costs.device
    keys = torch.empty(E, dtype=torch.int64, device=dev)
    fcosts = torch.empty((E, nfa.S), dtype=torch.int32, device=dev)
    n_scratch = kernels.size("regex_fork_scratch", n_live, nfa.S)
    scratch = (torch.empty(n_scratch, dtype=torch.int32, device=dev)
               if n_scratch else None)
    kernels.launch("regex_fork_ranked", costs.data_ptr(), nf.data_ptr(),
                   nl.data_ptr(), n_live, nfa.S, nfa.T,
                   nfa.in_off.data_ptr(), nfa.in_src.data_ptr(),
                   nfa.in_mask.data_ptr(), cfg.cost_bound, cfg.subst,
                   cfg.delete, cfg.insert, cfg.del_rounds, int(allow_subst),
                   cfg.half_bits, keys.data_ptr(), fcosts.data_ptr(),
                   None if scratch is None else scratch.data_ptr())
    return keys, fcosts


# ---------------------------------------------------------------------------
# regex_merge: steps 4b-6 of a layer
# ---------------------------------------------------------------------------


def regex_merge_plain(skeys, sidx, fcosts, nfa: FrontierNFA, cfg: LayerCfg,
                      depth: int, first, last, costs, res, state) -> None:
    E, S = skeys.shape[0], nfa.S
    F, Rc = first.shape[0], res.shape[1]
    dev = skeys.device
    b = cfg.half_bits
    new_seg = torch.ones(E, dtype=torch.bool, device=dev)
    new_seg[1:] = skeys[1:] != skeys[:-1]
    run_id = torch.cumsum(new_seg.to(torch.int64), dim=0) - 1
    scost = fcosts[sidx.long()]
    merged = torch.full((E, S), INT32_MAX, dtype=torch.int32, device=dev)
    merged = merged.scatter_reduce(0, run_id[:, None].expand(E, S), scost,
                                   "amin", include_self=True)
    scost = merged[run_id]
    keep = (skeys != cfg.dead) & new_seg
    acc = torch.where(nfa.accept.bool()[None, :], scost, NO_COST).min(
        dim=1).values
    hit = keep & (acc < cfg.cost_bound)
    sf = (skeys >> b).to(torch.int32)
    sl = (skeys & ((1 << b) - 1)).to(torch.int32)
    rc, ovf = int(state[0]), int(state[1])
    n_hits, n_keep = int(hit.sum()), int(keep.sum())
    hslot = rc + torch.cumsum(hit.to(torch.int64), dim=0) - 1
    w = hit & (hslot < Rc)
    for row, val in ((0, sf), (1, sl), (2, acc)):
        res[row, hslot[w]] = val[w].to(torch.int32)
    res[3, hslot[w]] = depth + 1
    kslot = torch.cumsum(keep.to(torch.int64), dim=0) - 1
    wk = keep & (kslot < F)
    first[kslot[wk]] = sf[wk]
    last[kslot[wk]] = sl[wk]
    costs[kslot[wk]] = scost[wk]
    ovf = int(bool(ovf) or rc + n_hits > Rc or n_keep > F)
    state[:5] = torch.tensor([min(rc + n_hits, Rc), ovf, min(n_keep, F),
                              -1 if ovf else n_keep, rc], dtype=torch.int32)


def regex_merge(skeys: torch.Tensor, sidx: torch.Tensor,
                fcosts: torch.Tensor, nfa: FrontierNFA, cfg: LayerCfg,
                depth: int, first: torch.Tensor, last: torch.Tensor,
                costs: torch.Tensor, res: torch.Tensor,
                state: torch.Tensor) -> None:
    """Merge the sorted forks (skeys int64[E] and their rows sidx int32[E]
    from kernel H over regex_fork's keys) into the next frontier (first,
    last, costs: the live rows rewritten in place, the rest untouched) and
    the results res int32[4, R]; state int32[8] updated in place (module
    docstring).  Kernel R on the card: three launches, no host read."""
    E = skeys.shape[0]
    F = first.shape[0]
    kernels.check(skeys, "skeys", torch.int64, 1)
    kernels.check(sidx, "sidx", torch.int32, 1, (E,))
    kernels.check(fcosts, "fcosts", torch.int32, 2, (E, nfa.S))
    kernels.check(last, "last", torch.int32, 1, (F,))
    kernels.check(costs, "costs", torch.int32, 2, (F, nfa.S))
    kernels.check(res, "res", torch.int32, 2)
    kernels.check(state, "state", torch.int32, 1, (STATE_LEN,))
    kernels.check(nfa.accept, "accept", torch.int32, 1, (nfa.S,))
    if res.shape[0] != 4 or E == 0:
        raise ValueError("res must be int32[4, R] and E > 0")
    if not kernels.on_card(skeys, sidx, fcosts, first, last, costs, res,
                           state, nfa.accept):
        return regex_merge_plain(skeys, sidx, fcosts, nfa, cfg, depth,
                                 first, last, costs, res, state)
    dev = skeys.device
    tile_counts = torch.empty(kernels.size("regex_merge_tiles", E),
                              dtype=torch.int32, device=dev)
    acc = torch.empty(E, dtype=torch.int32, device=dev)
    kernels.launch("regex_merge", skeys.data_ptr(), sidx.data_ptr(),
                   fcosts.data_ptr(), E, nfa.S, nfa.accept.data_ptr(),
                   cfg.cost_bound, cfg.half_bits, F, res.shape[1], depth,
                   first.data_ptr(), last.data_ptr(), costs.data_ptr(),
                   res.data_ptr(), state.data_ptr(), tile_counts.data_ptr(),
                   acc.data_ptr())
