"""Sharded queries: index rows distributed over the mesh.

The counterpart of femto_tpu/parallel/dist_query.py, every tier (full,
compact, packed, vseg, vrle).  Count and locate run two schemes, as
there:

  * routed (the default): the query lanes are split over the shards, and
    every step routes each lane's (row, code) request to the shard owning
    the row by a Valiant exchange (parallel/bins.py); the owner answers
    from its own blocks (kernel K18f's owner_occ / owner_lf, the shards'
    checkpoints carry the global base) and the answers travel back.  Hot
    rows can overflow the exchange capacity: the wrapper retries with the
    capacity times 4 and, past max_retries, falls through to
  * masked psum: every shard sees every lane, answers for the rows it owns
    and 0 for the others (masked_occ / masked_lf), one psum per step.

Both return replicated int32 tensors.  sharded_arrays_from_numpy carries a
femto_tpu sharded index (np.asarray of its global arrays) across to the
mesh.

The query engine over a sharded index (sharded_regexp_matches,
sharded_term_ranges, sharded_count_query, sharded_docs_query): the device
regex frontier of query/regexp_device.py runs replicated, the same on
every shard, and each layer's ranks are answered by the shards together:
K18f's masked_occ_rows of every live entry's first and last rows (every
symbol's masked occ at each row), one psum over the mesh, plus C[code]
(0 for absent codes), then kernel
R's regex_fork_ranked, H's sort and R's merge.  Past its largest
capacities the sharded frontier raises RuntimeError (it has no host
engine to fall back on).  Offsets come from sharded_locate, and Boolean
queries combine the same host Results as the single-device engine.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..alphabet import ALPHA_SIZE
from ..fmindex import FMIndex, arrays_from_numpy
from ..ops import dist_ops as DO
from ..ops import rank as R
from . import bins
from .mesh import shard_ids

# FMArrays fields that are cut into the shards' blocks (femto_tpu's
# _specs_for_arrays): full / compact / packed (occ_l1 too where it has
# more than its one dummy row), and the row tiers, whose occ_ckpt,
# mark_bits, seg_syms and seg_rle are replicated one-row markers
SHARDED_FIELDS = ("bwt", "occ_ckpt", "mark_bits", "mark_ckpt", "mark_vals")
ROW_SHARDED_FIELDS = ("bwt", "occ_l1", "mark_ckpt", "mark_vals", "seg_ovf",
                      "seg_nsym", "seg_woff", "seg_cont")


def _nseg_local(index, mesh) -> int:
    return index.meta.n_seg // mesh.D


def _to_mesh(x, mesh) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32)).to(mesh.device)


def _lane_blocks(x: np.ndarray, mesh, fill) -> torch.Tensor:
    """The query lanes padded to D blocks; the process's blocks [Dl, ...]."""
    B = x.shape[0]
    Bp = -(-B // mesh.D) * mesh.D
    xp = np.full((Bp,) + x.shape[1:], fill, np.int32)
    xp[:B] = x
    Bl = Bp // mesh.D
    own = xp[mesh.shard0 * Bl:(mesh.shard0 + mesh.Dl) * Bl]
    return _to_mesh(own.reshape((mesh.Dl, Bl) + x.shape[1:]), mesh)


def _gather_lanes(mesh, x: torch.Tensor, B: int) -> torch.Tensor:
    """Replicated [B]: every shard's lanes end to end."""
    return mesh.all_gather(x).reshape(-1)[:B]


def _backward_search_routed(index, mesh, pats_local, *, cap: int, key: int):
    arrays, meta = index.arrays, index.meta
    D = mesh.D
    Dl, B_local, P = pats_local.shape
    RR = 2 * B_local
    nseg_local = _nseg_local(index, mesh)
    rows_per_shard = nseg_local * meta.seg
    dev = pats_local.device
    first = torch.full((Dl, B_local), meta.row0, dtype=torch.int32,
                       device=dev)
    last = torch.full((Dl, B_local), meta.n_rows, dtype=torch.int32,
                      device=dev)
    rid = (shard_ids(mesh)[:, None] * RR
           + torch.arange(RR, dtype=torch.int32, device=dev)[None])
    C = arrays.C
    of = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(P):
        col = pats_local[:, :, P - 1 - t]
        kkey = bins.fold_in(key, t)
        active = col >= 0
        cd1 = R.map_char(arrays, col)
        rows = torch.cat([first, last], dim=1)
        cc = torch.cat([cd1, cd1], dim=1)
        dest = torch.clamp(torch.div(rows, rows_per_shard,
                                     rounding_mode="floor"), max=D - 1)
        recs, v, of1 = bins.valiant_exchange(mesh, dest, [rows, cc, rid],
                                             cap, kkey)
        vb = v.bool()
        vals = DO.owner_occ(arrays, torch.where(vb, recs[0], 0),
                            torch.where(vb, recs[1], -1), v,
                            nseg_local=nseg_local, shard0=mesh.shard0,
                            n_rows_total=D * rows_per_shard)
        back, v2, of2 = bins.valiant_exchange(
            mesh, torch.div(recs[2], RR, rounding_mode="floor"),
            [recs[2], vals], cap, bins.fold_in(kkey, 1), valid=v)
        o = torch.zeros((Dl, RR), dtype=torch.int32, device=dev)
        DO.owner_place(back[0], v2, [back[1]], [o], base_mul=RR,
                       shard0=mesh.shard0)
        valid_c = cd1 >= 0
        base = C[torch.where(valid_c, cd1, 0).long()]
        first = torch.where(active, torch.where(valid_c, base + o[:, :B_local],
                                                0), first)
        last = torch.where(active, torch.where(valid_c, base + o[:, B_local:],
                                               0), last)
        of = torch.maximum(of, torch.maximum(of1, of2))
    return first, last, of


def _backward_search_psum(index, mesh, pats):
    arrays, meta = index.arrays, index.meta
    B, P = pats.shape
    nseg_local = _nseg_local(index, mesh)
    first = torch.full((B,), meta.row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), meta.n_rows, dtype=torch.int32,
                      device=pats.device)
    for t in range(P):
        col = pats[:, P - 1 - t]
        active = col >= 0
        cd = R.map_char(arrays, torch.where(active, col, 0))
        valid = cd >= 0
        base = arrays.C[torch.where(valid, cd, 0).long()]
        o = mesh.psum(DO.masked_occ(
            arrays, torch.cat([cd, cd]), torch.cat([first, last]),
            Dl=mesh.Dl, nseg_local=nseg_local, shard0=mesh.shard0,
            n_rows_total=mesh.D * nseg_local * meta.seg))
        nf = torch.where(valid, base + o[:B], 0)
        nl = torch.where(valid, base + o[B:], 0)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return first, last


def sharded_backward_search(index: FMIndex, mesh, pats: np.ndarray,
                            routed: bool = True, cap_factor: float = 6.0,
                            max_retries: int = 3, seed: int = 0):
    """Count ranges over a sharded index.  pats: int32[B, P] right-aligned
    (-1 padded).  Returns (first, last), int32[B] replicated tensors on the
    mesh's device.  routed=True splits the lanes over the shards and routes
    each rank request to the row's owner; hot-row skew that overflows the
    exchange capacity retries with cap * 4, then falls back to the masked
    psum scheme."""
    pats = np.asarray(pats, np.int32)
    B = pats.shape[0]
    D = mesh.D
    if routed:
        pp = _lane_blocks(pats, mesh, -1)
        Bp = -(-B // D) * D
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * 2 * B_local / D)))
        for attempt in range(max_retries):
            first, last, of = _backward_search_routed(
                index, mesh, pp, cap=min(cap, 2 * Bp), key=seed + attempt)
            if int(of) <= 0:
                return (_gather_lanes(mesh, first, B),
                        _gather_lanes(mesh, last, B))
            cap *= 4
    return _backward_search_psum(index, mesh, _to_mesh(pats, mesh))


def _owner_lf_view(index, nseg_local):
    """K18f owner_lf's view of a sharded index (dist_ops.owner_lf_view),
    made once and kept on the index: the view of a sharded index does not
    change after its build, so a routed locate step pays one allocation
    and one launch for its owner answers."""
    kept = index.owner_lf_view
    if kept is None or kept[0] is not index.arrays or kept[1] != nseg_local:
        kept = index.owner_lf_view = (
            index.arrays, nseg_local,
            DO.owner_lf_view(index.arrays, nseg_local))
    return kept[2]


def _locate_routed(index, mesh, rows_local, *, cap: int, key: int):
    arrays, meta = index.arrays, index.meta
    D = mesh.D
    Dl, B_local = rows_local.shape
    nseg_local = _nseg_local(index, mesh)
    lf_view = _owner_lf_view(index, nseg_local)
    rows_per_shard = nseg_local * meta.seg
    dev = rows_local.device
    rid = (shard_ids(mesh)[:, None] * B_local
           + torch.arange(B_local, dtype=torch.int32, device=dev)[None])
    rows = rows_local
    offs = torch.full((Dl, B_local), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((Dl, B_local), dtype=torch.bool, device=dev)
    of = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(meta.mark_period + 1):
        kkey = bins.fold_in(key, i)
        dest = torch.clamp(torch.div(rows, rows_per_shard,
                                     rounding_mode="floor"), max=D - 1)
        recs, v, of1 = bins.valiant_exchange(mesh, dest, [rows, rid], cap,
                                             kkey)
        ans = DO.owner_lf(arrays, recs[0], v, nseg_local=nseg_local,
                          shard0=mesh.shard0, view=lf_view)
        back, v2, of2 = bins.valiant_exchange(
            mesh, torch.div(recs[1], B_local, rounding_mode="floor"),
            [recs[1], ans], cap, bins.fold_in(kkey, 1), valid=v)
        a = torch.zeros((Dl, B_local), dtype=torch.int32, device=dev)
        DO.owner_place(back[0], v2, [back[1]], [a], base_mul=B_local,
                       shard0=mesh.shard0)
        hit = (a >= 0) & ~done
        offs = torch.where(hit, a + i, offs)
        done = done | hit
        rows = torch.where(done, rows, -1 - a)
        of = torch.maximum(of, torch.maximum(of1, of2))
    return offs, of


def _locate_psum(index, mesh, rows):
    arrays, meta = index.arrays, index.meta
    nseg_local = _nseg_local(index, mesh)
    B = rows.shape[0]
    offs = torch.full((B,), -1, dtype=torch.int32, device=rows.device)
    done = torch.zeros(B, dtype=torch.bool, device=rows.device)
    for i in range(meta.mark_period + 1):
        ans = mesh.psum(DO.masked_lf(arrays, rows, Dl=mesh.Dl,
                                     nseg_local=nseg_local,
                                     shard0=mesh.shard0))
        hit = (ans >= 0) & ~done
        offs = torch.where(hit, ans + i, offs)
        done = done | hit
        rows = torch.where(done, rows, -1 - ans)
    return offs


def sharded_locate(index: FMIndex, mesh, rows: np.ndarray,
                   routed: bool = True, cap_factor: float = 6.0,
                   max_retries: int = 3, seed: int = 0) -> torch.Tensor:
    """Text offset of each row (int32[B] replicated) over a sharded index,
    by LF walks whose steps the rows' owners answer (routed, retried with
    a larger capacity on hot-row skew) or the masked psum walk."""
    rows = np.asarray(rows, np.int32)
    B = rows.shape[0]
    D = mesh.D
    if routed:
        rr = _lane_blocks(rows, mesh, 0)
        Bp = -(-B // D) * D
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * B_local / D)))
        for attempt in range(max_retries):
            offs, of = _locate_routed(index, mesh, rr, cap=min(cap, Bp),
                                      key=seed + attempt)
            if int(of) <= 0:
                return _gather_lanes(mesh, offs, B)
            cap *= 4
    return _locate_psum(index, mesh, _to_mesh(rows, mesh))


def sharded_arrays_from_numpy(arrays_np: Mapping[str, np.ndarray], meta: Any,
                              mesh, **kw) -> FMIndex:
    """Carry a sharded index across: femto_tpu's sharded arrays as numpy
    (np.asarray of each global array: the shard blocks end to end) and its
    FMMeta -> the port's FMIndex of the process's blocks on the mesh's
    device (every block on a LocalMesh; its own on a DistMesh).  Other
    keywords go to fmindex.arrays_from_numpy."""
    arrays = {k: np.asarray(v) for k, v in arrays_np.items()
              if v is not None}
    if mesh.Dl != mesh.D:
        row_tier = "seg_nsym" in arrays
        for k in (ROW_SHARDED_FIELDS if row_tier
                  else SHARDED_FIELDS + ("occ_l1",)):
            a = arrays.get(k)
            if a is None or (k == "occ_l1" and a.shape[0] <= 1):
                continue
            blk = a.shape[0] // mesh.D
            arrays[k] = a[mesh.shard0 * blk:(mesh.shard0 + mesh.Dl) * blk]
    return arrays_from_numpy(arrays, meta, device=mesh.device, **kw)


# ---------------------------------------------------------------------------
# The query engine over a sharded index (femto_tpu's dist_query.py 560-812)
# ---------------------------------------------------------------------------

# the sharded frontier's capacities: the first run's, and the largest it
# grows to (fourfold per overflow) before it raises (femto_tpu's
# sharded_regexp_matches)
FRONTIER_CAPS = (256, 4096, 64)
MAX_FRONTIER_CAPS = (16384, 262144, 1024)


def _fork_ranks(index: FMIndex, mesh):
    """The sharded frontier's rank hook (query/regexp_device._layer): the
    new range of every fork (entry f, symbol a) of the n_live live
    entries, int32[n_live * 261] each, from K18f's masked_occ_rows of the
    entries' first and last rows (every symbol's masked occ at each row)
    on every local shard, one psum over the mesh and C[code]; (0, 0)
    where a is absent (femto_tpu's backward_step_pair_sharded)."""
    arrays, meta = index.arrays, index.meta
    nseg_local = _nseg_local(index, mesh)
    n_rows_total = mesh.D * nseg_local * meta.seg
    sym = torch.arange(ALPHA_SIZE, dtype=torch.int32, device=mesh.device)
    cd = R.map_char(arrays, sym).to(torch.int32)
    valid = cd >= 0
    base = torch.where(valid, arrays.C[torch.where(valid, cd, 0).long()], 0)

    def rank(first, last, n_live):
        A = ALPHA_SIZE
        rows = torch.cat([first[:n_live], last[:n_live]])
        occ = mesh.psum(DO.masked_occ_rows(
            arrays, rows, Dl=mesh.Dl, nseg_local=nseg_local,
            shard0=mesh.shard0, n_rows_total=n_rows_total))
        occ = torch.where(valid, base + occ.view(2, n_live, A), 0)
        return occ[0].reshape(-1), occ[1].reshape(-1)

    return rank


def sharded_regexp_matches(index: FMIndex, mesh, nfa, settings=None,
                           frontier_cap: int = FRONTIER_CAPS[0],
                           results_cap: int = FRONTIER_CAPS[1],
                           max_len: int = FRONTIER_CAPS[2],
                           on_layer=None):
    """Run the NFA frontier against a sharded index: deduped RegexpMatch
    list (match strings empty: row ranges and costs).  The frontier runs
    replicated on the index's device (query/regexp_device.py), its ranks
    summed over the mesh (_fork_ranks).  On capacity overflow the
    capacities grow fourfold and the search re-runs; past
    MAX_FRONTIER_CAPS it raises RuntimeError.  on_layer: as
    run_regexp_device's, called before every layer of every run."""
    from ..query import regexp_device as RD
    from ..query.ast import ApproxSettings

    if settings is None:
        settings = ApproxSettings.exact()
    rank = _fork_ranks(index, mesh)
    retries = 0
    while True:
        try:
            out = RD._run_regexp_device_once(
                index, nfa, settings, frontier_cap, results_cap, max_len,
                with_strings=False, on_layer=on_layer, rank=rank)
            RD.last_stats["retries"] = retries
            return out
        except RD._DeviceCapacityOverflow:
            if all(c >= m for c, m in zip(
                    (frontier_cap, results_cap, max_len), MAX_FRONTIER_CAPS)):
                raise RuntimeError("sharded regex frontier overflow at caps")
            frontier_cap = min(frontier_cap * 4, MAX_FRONTIER_CAPS[0])
            results_cap = min(results_cap * 4, MAX_FRONTIER_CAPS[1])
            max_len = min(max_len * 4, MAX_FRONTIER_CAPS[2])
            retries += 1


def sharded_term_ranges(index: FMIndex, mesh, term):
    """Row ranges (first, last, cost) of one query term against a sharded
    index: literal terms run the sharded backward search, regex and
    approximate terms the sharded frontier."""
    from ..alphabet import pattern_to_alpha
    from ..query.ast import as_literal
    from ..query.nfa import compile_nfa
    from ..query.planning import matches_empty, streamline
    from ..search import pack_patterns

    regexp = streamline(term.regexp)
    if matches_empty(regexp):
        return [(index.meta.row0, index.meta.n_rows, 0)]
    lit = as_literal(regexp)
    if lit is not None and term.approx.cost_bound <= 1:
        packed, _ = pack_patterns([pattern_to_alpha(lit)])
        first, last = sharded_backward_search(index, mesh, packed)
        f, l = int(first[0]), int(last[0])
        return [(f, l, 0)] if l > f else []
    matches = sharded_regexp_matches(index, mesh, compile_nfa(regexp),
                                     term.approx)
    return [(m.first, m.last, m.cost) for m in matches]


def sharded_count_query(index: FMIndex, mesh, query: str,
                        icase: bool = False) -> int:
    """count_query against a sharded index: the matching positions of a
    term query (regex and approximate included), the matching documents
    of a Boolean one (query/engine.count_query's semantics), answered
    from the sharded arrays alone."""
    from ..query.ast import QTerm
    from ..query.engine import _warn_truncated, apply_icase
    from ..query.parser import parse_query
    from ..query.regexp import RegexpMatch, match_rows

    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    if isinstance(node, QTerm):
        iv = match_rows([RegexpMatch(f, l, c, b"")
                         for f, l, c in sharded_term_ranges(index, mesh,
                                                            node)])
        return sum(l - f for f, l in iv)
    res = _sharded_execute(index, mesh, node)
    _warn_truncated(res, query)
    return len(res.doc_set())


# Per-term work bound, used only when the caller opts out of full
# evaluation (full_eval=False): each Boolean operand then locates at most
# this many rows, and the truncation is flagged.
SHARDED_TERM_CAP = 1_000_000

# Rows located per sharded_locate call when a term streams all its rows.
SHARDED_LOCATE_WINDOW = 1 << 20


def _sharded_locate_docs(index: FMIndex, mesh, iv, cap=None):
    """(docs, offsets, truncated) of a union of row intervals through
    sharded_locate: cap None streams every row in SHARDED_LOCATE_WINDOW
    windows; a positive cap locates at most that many rows and flags the
    truncation."""
    from ..search import offsets_to_docs

    D = mesh.D
    total = sum(l - f for f, l in iv)
    truncated = cap is not None and total > cap
    spans = []
    budget = cap
    for f, l in iv:
        take = l - f if budget is None else min(l - f, budget)
        if take <= 0:
            break
        for wf in range(f, f + take, SHARDED_LOCATE_WINDOW):
            spans.append((wf, min(wf + SHARDED_LOCATE_WINDOW, f + take)))
        if budget is not None:
            budget -= take
    if not spans:
        return np.zeros(0, np.int64), np.zeros(0, np.int64), truncated
    docs_all, offs_all = [], []
    for wf, wl in spans:
        rows = np.arange(wf, wl, dtype=np.int32)
        rows = np.concatenate([rows, np.full((-len(rows)) % D, rows[0],
                                             np.int32)])
        offs = sharded_locate(index, mesh, rows).cpu().numpy()[:wl - wf]
        d, o = offsets_to_docs(index, offs.astype(np.int64))
        docs_all.append(d)
        offs_all.append(o)
    return np.concatenate(docs_all), np.concatenate(offs_all), truncated


def _sharded_execute(index: FMIndex, mesh, node, term_cap=None):
    """query/engine.execute against a sharded index: each term's rows from
    sharded ranges and sharded_locate, the Boolean nodes combined by the
    host Results algebra (query/results.py).  term_cap None evaluates
    every operand in full."""
    from ..query.ast import QAnd, QNot, QOr, QTerm, QThen, QWithin
    from ..query.regexp import RegexpMatch, match_rows
    from ..query.results import (Results, intersect, subtract, then_within,
                                 union)

    if isinstance(node, QTerm):
        ranges = sharded_term_ranges(index, mesh, node)
        iv = match_rows([RegexpMatch(f, l, c, b"") for f, l, c in ranges])
        docs, offs, truncated = _sharded_locate_docs(index, mesh, iv,
                                                     cap=term_cap)
        res = Results.from_doc_offsets(docs, offs)
        res.count = sum(l - f for f, l in iv)
        res.truncated = truncated
        return res
    a = _sharded_execute(index, mesh, node.left, term_cap)
    b = _sharded_execute(index, mesh, node.right, term_cap)
    if isinstance(node, QAnd):
        return intersect(a, b)
    if isinstance(node, QOr):
        return union(a, b)
    if isinstance(node, QNot):
        return subtract(a, b)
    if isinstance(node, QThen):
        return then_within(a, b, node.distance, ordered=True)
    if isinstance(node, QWithin):
        return then_within(a, b, node.distance, ordered=False)
    raise TypeError(node)


def sharded_docs_query(index: FMIndex, mesh, query: str,
                       with_offsets: bool = True, icase: bool = False,
                       max_matches=None, full_eval: bool = True):
    """docs_query against a sharded index: a list of (doc_id, info,
    offsets), term ranges from the sharded engines, offsets from
    sharded_locate, the Boolean algebra on the host.  full_eval True
    evaluates every term exactly (streamed); False bounds each term at
    SHARDED_TERM_CAP rows and warns of truncation.  max_matches limits
    the documents returned."""
    from ..query.engine import _warn_truncated, apply_icase
    from ..query.parser import parse_query
    from ..query.results import ResultType

    node = parse_query(query)
    if icase:
        node = apply_icase(node)
    res = _sharded_execute(index, mesh, node,
                           term_cap=None if full_eval else SHARDED_TERM_CAP)
    _warn_truncated(res, query)
    out = []
    for d in res.doc_set():
        if with_offsets and res.type == ResultType.DOC_OFFSETS:
            offs = res.offsets[res.docs == d].tolist()
        else:
            offs = []
        out.append((int(d), index.infos[int(d)], offs))
        if max_matches is not None and len(out) >= max_matches:
            break
    return out
