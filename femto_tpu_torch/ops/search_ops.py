"""Backward search, locate, extraction and psi walks: kernel wrappers +
plain versions, over every storage tier (full, compact, packed, vseg,
vrle).

The counterparts of femto_tpu/ops/search_ops.py backward_search,
backward_search_steps, locate_rows, extract_backward and psi_step
(scanned as search.py _psi_scan_jit), of ops/rank.py
backward_step_pair on free lanes (the host regex engine's step), and of
the steps of femto_tpu/paged.py (_pair_step, _walk_step, _resolve_marks;
its _extract_step is extract_backward at one step), which paged serving
dispatches one at a time over a row cache (FMArrays.seg_slot).  Each wrapper launches its CUDA kernel (csrc/
backward_search.cu, csrc/lf_walk.cu, csrc/psi_walk.cu; one instantiation
per layout, picked from dtypes and shapes as ops/rank.py does) for tensors
on the card and takes the plain PyTorch version beside it for tensors on
the CPU; a CUDA tensor never falls back.  The plain versions repeat
femto_tpu's lockstep loops with the ops/rank.py steps.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..alphabet import ALPHA_SIZE, INVALID_ALPHA
from ..fmindex import FMArrays
from . import rank as R


def fm_view(arrays: FMArrays):
    """(kernels.FmView, layout name) of an index, after checking the
    tensors every search kernel reads against the layout's dtypes and
    shapes.  Raises on a layout the kernels do not take."""
    lay = R.layout(arrays)
    seg = R.seg_size(arrays)
    K = R.alpha_count(arrays)
    row_tier = R.is_row_tier(arrays)
    # the true segment count: under paging bwt is the row cache
    n_seg = (arrays.seg_slot.shape[0] if arrays.seg_slot is not None
             else arrays.bwt.shape[0])
    kernels.check(arrays.C, "C", torch.int32, 1)
    # the row tiers keep their marks in the rows: one-row dummies here
    kernels.check(arrays.mark_bits, "mark_bits", torch.uint32, 2,
                  (1 if row_tier else n_seg, seg // 32))
    if seg % 32 != 0 or arrays.bwt.data_ptr() % 16 != 0:
        raise ValueError("bwt rows must be 16-byte aligned (seg % 32 == 0)")
    view = kernels.FmView(
        bwt=arrays.bwt.data_ptr(), occ_ckpt=arrays.occ_ckpt.data_ptr(),
        C=arrays.C.data_ptr(), n_seg=n_seg, seg=seg, K=K,
        layout=kernels.LAYOUTS.index(lay))
    if lay == "full":
        kernels.check(arrays.bwt, "bwt", torch.uint16, 2, (n_seg, seg))
        kernels.check(arrays.occ_ckpt, "occ_ckpt", torch.int32, 2, (n_seg, K))
    else:
        kernels.check(arrays.occ_ckpt, "occ_ckpt", torch.uint16, 2,
                      (1 if row_tier else n_seg, K))
        grp = R.l1_grp(arrays)
        kernels.check(arrays.occ_l1, "occ_l1", torch.int32, 2,
                      (n_seg // grp, K))
        if n_seg % grp != 0:
            raise ValueError("n_seg must be a multiple of the L1 group")
        view.occ_l1, view.grp = arrays.occ_l1.data_ptr(), grp
    if lay == "packed":
        kernels.check(arrays.bwt, "bwt", torch.uint32, 2)
        per_word, bits = R.pack_geometry(arrays)
        if (1 << bits) - 1 < K:
            raise ValueError("packed code width leaves no pad code")
        view.W, view.per_word, view.bits = arrays.bwt.shape[1], per_word, bits
    elif lay == "compact":
        kernels.check(arrays.bwt, "bwt", torch.uint16, 2, (n_seg, seg))
    elif row_tier:
        _row_view(arrays, view, n_seg)
    if arrays.seg_slot is not None:
        if not row_tier:
            raise ValueError("paged serving (seg_slot) takes the row tiers "
                             "(vseg, vrle) only")
        kernels.check(arrays.seg_slot, "seg_slot", torch.int32, 1, (n_seg,))
        view.seg_slot = arrays.seg_slot.data_ptr()
    if R.is_remapped(arrays):
        kernels.check(arrays.alpha_map, "alpha_map", torch.int32, 1,
                      (ALPHA_SIZE,))
        kernels.check(arrays.alpha_rev, "alpha_rev", torch.int32, 1, (K,))
        view.alpha_map = arrays.alpha_map.data_ptr()
        view.alpha_rev = arrays.alpha_rev.data_ptr()
    return view, lay


def _row_view(arrays: FMArrays, view, n_seg: int) -> None:
    """Fill the row tiers' part of a view from ops/rank.VsegGeom, after
    checking the row-tier fields (bwt: n_seg rows, or a paged index's
    cache rows)."""
    g = R.VsegGeom(arrays)
    kernels.check(arrays.bwt, "bwt", torch.uint32, 2)
    kernels.check(arrays.seg_nsym, "seg_nsym", torch.uint8, 1, (n_seg,))
    kernels.check(arrays.seg_woff, "seg_woff", torch.int32, 1, (n_seg,))
    kernels.check(arrays.seg_ovf, "seg_ovf", torch.uint32, 2)
    if g.W < g.Wmode or g.w_main not in range(1, 17) or not 1 <= g.S <= 255:
        raise ValueError("row geometry does not fit the row's shape")
    if g.n_side > 1 and g.Ws != -(-g.seg // (32 // g.w_side)):
        raise ValueError("side rows do not hold seg codes")
    view.seg_ovf = arrays.seg_ovf.data_ptr()
    view.seg_nsym = arrays.seg_nsym.data_ptr()
    view.seg_woff = arrays.seg_woff.data_ptr()
    view.row_words, view.code_words, view.w_main = g.total, g.W, g.w_main
    view.off_syms, view.off_mk = g.off_syms, g.off_mk
    view.off_mck, view.off_rel = g.off_mck, g.off_rel
    view.S, view.wide = g.S, int(g.wide)
    view.w_side, view.side_words, view.n_side = g.w_side, g.Ws, g.n_side
    if R.vrle_flat_cont(arrays):
        kernels.check(arrays.seg_cont, "seg_cont", torch.uint32, 2)
        view.seg_cont = arrays.seg_cont.data_ptr()
        view.G = arrays.seg_cont.shape[1]
        view.ngr = arrays.seg_rle.shape[0] - 3
        view.X = arrays.seg_cont.shape[0]


def _index_tensors(arrays: FMArrays):
    ts = (arrays.bwt, arrays.occ_ckpt, arrays.occ_l1, arrays.C,
          arrays.alpha_map, arrays.alpha_rev)
    if R.is_row_tier(arrays):
        ts += (arrays.seg_ovf, arrays.seg_nsym, arrays.seg_woff)
        if arrays.seg_cont is not None:
            ts += (arrays.seg_cont,)
    if arrays.seg_slot is not None:
        ts += (arrays.seg_slot,)
    return ts


# ---------------------------------------------------------------------------
# Kernel C: backward search
# ---------------------------------------------------------------------------


def backward_search_plain(arrays: FMArrays, n: int, pats: torch.Tensor,
                          row0: int = 0):
    """femto_tpu's lockstep scan: one backward step per pattern column,
    last column first; -1 columns (left padding) leave the range as is."""
    B = pats.shape[0]
    first = torch.full((B,), row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), n, dtype=torch.int32, device=pats.device)
    for j in range(pats.shape[1] - 1, -1, -1):
        col = pats[:, j]
        active = col >= 0
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return first, last


def backward_search(arrays: FMArrays, n: int, pats: torch.Tensor,
                    row0: int = 0):
    """Batched FM count ranges.  pats: int32[B, P], right-aligned, -1 on
    the left.  Returns (first, last) int32[B]: half-open row ranges over
    [row0, n).  Kernel C on the card."""
    kernels.check(pats, "pats", torch.int32, 2)
    if not kernels.on_card(pats, *_index_tensors(arrays)):
        return backward_search_plain(arrays, n, pats, row0)
    view, lay = fm_view(arrays)
    B, P = pats.shape
    first = torch.empty(B, dtype=torch.int32, device=pats.device)
    last = torch.empty(B, dtype=torch.int32, device=pats.device)
    kernels.launch("backward_search", view, pats.data_ptr(), B, P, n, row0,
                   first.data_ptr(), last.data_ptr(), layout=lay)
    return first, last


def backward_search_steps_plain(arrays: FMArrays, n: int,
                                pats: torch.Tensor, row0: int = 0):
    """femto_tpu's backward_search_steps scan: a column steps only while
    the range is non-empty; the previous range and the matched count
    follow each step that leaves it non-empty."""
    B = pats.shape[0]
    first = torch.full((B,), row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), n, dtype=torch.int32, device=pats.device)
    pf, pl = first.clone(), last.clone()
    matched = torch.zeros(B, dtype=torch.int32, device=pats.device)
    for j in range(pats.shape[1] - 1, -1, -1):
        col = pats[:, j]
        active = (col >= 0) & (last > first)
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        keep_prev = active & (nl > nf)
        pf = torch.where(keep_prev, nf, pf)
        pl = torch.where(keep_prev, nl, pl)
        matched = matched + keep_prev.to(torch.int32)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return first, last, pf, pl, matched


def backward_search_steps(arrays: FMArrays, n: int, pats: torch.Tensor,
                          row0: int = 0):
    """backward_search that also returns, per pattern, the last non-empty
    range and how many symbols matched before the range emptied (the
    reference's "too few matches" report).  pats as backward_search.
    Returns (first, last, prev_first, prev_last, matched), int32[B] each.
    Kernel C on the card."""
    kernels.check(pats, "pats", torch.int32, 2)
    if not kernels.on_card(pats, *_index_tensors(arrays)):
        return backward_search_steps_plain(arrays, n, pats, row0)
    view, lay = fm_view(arrays)
    B, P = pats.shape
    outs = [torch.empty(B, dtype=torch.int32, device=pats.device)
            for _ in range(5)]
    kernels.launch("backward_search_steps", view, pats.data_ptr(), B, P, n,
                   row0, *(o.data_ptr() for o in outs), layout=lay)
    return tuple(outs)


def backward_step_plain(arrays: FMArrays, c: torch.Tensor,
                        first: torch.Tensor, last: torch.Tensor):
    """ops/rank.py backward_step_pair, femto_tpu's step."""
    return R.backward_step_pair(arrays, c, first, last)


def backward_step_pair(arrays: FMArrays, c: torch.Tensor,
                       first: torch.Tensor, last: torch.Tensor):
    """One FM backward step on free lanes: alphabet symbols c and ranges
    [first, last), int32[B] each -> the new (first, last).  A symbol
    outside the alphabet or absent from it (the -1 pad lanes included)
    gives (0, 0).  Kernel C on the card."""
    B = c.shape[0]
    for name, t in (("c", c), ("first", first), ("last", last)):
        kernels.check(t, name, torch.int32, 1, (B,))
    if not kernels.on_card(c, first, last, *_index_tensors(arrays)):
        return backward_step_plain(arrays, c, first, last)
    view, lay = fm_view(arrays)
    nf = torch.empty_like(first)
    nl = torch.empty_like(last)
    kernels.launch("backward_step", view, c.data_ptr(), first.data_ptr(),
                   last.data_ptr(), B, nf.data_ptr(), nl.data_ptr(),
                   layout=lay)
    return nf, nl


def _row_layout(arrays: FMArrays) -> None:
    if not R.is_row_tier(arrays):
        raise ValueError("the paged steps take the row tiers (vseg, vrle) "
                         "only")


def backward_step_masked_plain(arrays: FMArrays, c: torch.Tensor,
                               first: torch.Tensor, last: torch.Tensor):
    """femto_tpu/paged.py _pair_step: backward_step_pair on the lanes
    with c >= 0; the others keep their range."""
    active = c >= 0
    nf, nl = R.backward_step_pair(arrays, c, first, last)
    return torch.where(active, nf, first), torch.where(active, nl, last)


def backward_step_masked(arrays: FMArrays, c: torch.Tensor,
                         first: torch.Tensor, last: torch.Tensor):
    """One masked FM backward step (a paged count's per-column dispatch):
    lanes with c >= 0 step as backward_step_pair does, lanes with c < 0
    keep (first, last).  int32[B] each; row tiers only.  Kernel C on the
    card."""
    B = c.shape[0]
    for name, t in (("c", c), ("first", first), ("last", last)):
        kernels.check(t, name, torch.int32, 1, (B,))
    _row_layout(arrays)
    if not kernels.on_card(c, first, last, *_index_tensors(arrays)):
        return backward_step_masked_plain(arrays, c, first, last)
    view, lay = fm_view(arrays)
    nf = torch.empty_like(first)
    nl = torch.empty_like(last)
    kernels.launch("backward_step_masked", view, c.data_ptr(),
                   first.data_ptr(), last.data_ptr(), B, nf.data_ptr(),
                   nl.data_ptr(), layout=lay)
    return nf, nl


# ---------------------------------------------------------------------------
# Kernel D: LF walks (locate, extract)
# ---------------------------------------------------------------------------


def locate_rows_plain(arrays: FMArrays, mark_period: int,
                      rows: torch.Tensor) -> torch.Tensor:
    """femto_tpu's lockstep walk: LF until marked, at most mark_period + 1
    checks; offset = mark value + steps walked, -1 if no mark was hit."""
    B = rows.shape[0]
    granks = torch.zeros(B, dtype=torch.int32, device=rows.device)
    steps = torch.full((B,), -1, dtype=torch.int32, device=rows.device)
    done = torch.zeros(B, dtype=torch.bool, device=rows.device)
    i = 0
    while i <= mark_period and not bool(done.all()):
        nxt, bit, grank = R.lf_grank_step(arrays, rows)
        is_m = bit & ~done
        granks = torch.where(is_m, grank, granks)
        steps = torch.where(is_m, i, steps)
        done = done | is_m
        rows = torch.where(done, rows, nxt)
        i += 1
    offs = torch.full((B,), -1, dtype=torch.int32, device=rows.device)
    if bool(done.any()):
        offs[done] = R.mark_offset(arrays, granks[done]) + steps[done]
    return offs


def locate_rows(arrays: FMArrays, mark_period: int,
                rows: torch.Tensor) -> torch.Tensor:
    """Text offset of the suffix at each row (int32[B]; rows in
    [0, n_rows)), by LF walk to a marked row.  Kernel D on the card."""
    kernels.check(rows, "rows", torch.int32, 1)
    kernels.check(arrays.mark_ckpt, "mark_ckpt", torch.int32, 1,
                  (arrays.mark_bits.shape[0],))
    kernels.check(arrays.mark_vals, "mark_vals", torch.uint32, 1)
    kernels.check(arrays.mark_meta, "mark_meta", torch.int32, 1, (5,))
    if not kernels.on_card(rows, *_index_tensors(arrays), arrays.mark_bits,
                           arrays.mark_ckpt, arrays.mark_vals,
                           arrays.mark_meta):
        return locate_rows_plain(arrays, mark_period, rows)
    view, lay = fm_view(arrays)
    out = torch.empty_like(rows)
    kernels.launch("lf_locate", view, rows.data_ptr(), rows.shape[0],
                   arrays.mark_bits.data_ptr(), arrays.mark_ckpt.data_ptr(),
                   arrays.mark_vals.data_ptr(), arrays.mark_vals.shape[0],
                   arrays.mark_meta.data_ptr(), mark_period, out.data_ptr(),
                   layout=lay)
    return out


def lf_walk_step_plain(arrays: FMArrays, rows: torch.Tensor,
                      granks: torch.Tensor, steps: torch.Tensor,
                      done: torch.Tensor, i: int):
    """femto_tpu/paged.py _walk_step: one lockstep locate step."""
    nxt, bit, grank = R.lf_grank_step(arrays, rows)
    is_m = bit & ~done
    granks = torch.where(is_m, grank, granks)
    steps = torch.where(is_m, torch.full_like(steps, i), steps)
    done = done | is_m
    return torch.where(done, rows, nxt), granks, steps, done


def lf_walk_step(arrays: FMArrays, rows: torch.Tensor, granks: torch.Tensor,
                 steps: torch.Tensor, done: torch.Tensor, i: int):
    """One step of a paged locate walk: lanes not done that sit on a
    marked row take its mark rank and step number i and are done; the
    others step LF.  rows, granks, steps int32[B], done bool[B] -> the
    four after the step; row tiers only.  Kernel D on the card."""
    B = rows.shape[0]
    for name, t in (("rows", rows), ("granks", granks), ("steps", steps)):
        kernels.check(t, name, torch.int32, 1, (B,))
    kernels.check(done, "done", torch.bool, 1, (B,))
    _row_layout(arrays)
    if not kernels.on_card(rows, granks, steps, done,
                           *_index_tensors(arrays)):
        return lf_walk_step_plain(arrays, rows, granks, steps, done, i)
    view, lay = fm_view(arrays)
    outs = (torch.empty_like(rows), torch.empty_like(granks),
            torch.empty_like(steps), torch.empty_like(done))
    kernels.launch("lf_walk_step", view, rows.data_ptr(), granks.data_ptr(),
                   steps.data_ptr(), done.data_ptr(), B, i,
                   *(o.data_ptr() for o in outs), layout=lay)
    return outs


def resolve_marks_plain(arrays: FMArrays, granks: torch.Tensor,
                        steps: torch.Tensor) -> torch.Tensor:
    """femto_tpu/paged.py _resolve_marks: mark_offset(granks) + steps."""
    return (R.mark_offset(arrays, granks) + steps).to(torch.int32)


def resolve_marks(arrays: FMArrays, granks: torch.Tensor,
                  steps: torch.Tensor) -> torch.Tensor:
    """Text offsets after a paged locate walk: the mark value of each
    lane's mark rank plus its steps (int32[B]).  Kernel D on the card."""
    B = granks.shape[0]
    kernels.check(granks, "granks", torch.int32, 1, (B,))
    kernels.check(steps, "steps", torch.int32, 1, (B,))
    kernels.check(arrays.mark_vals, "mark_vals", torch.uint32, 1)
    kernels.check(arrays.mark_meta, "mark_meta", torch.int32, 1, (5,))
    if not kernels.on_card(granks, steps, arrays.mark_vals,
                           arrays.mark_meta):
        return resolve_marks_plain(arrays, granks, steps)
    out = torch.empty_like(granks)
    kernels.launch("resolve_marks", granks.data_ptr(), steps.data_ptr(), B,
                   arrays.mark_vals.data_ptr(), arrays.mark_vals.shape[0],
                   arrays.mark_meta.data_ptr(), out.data_ptr())
    return out


def extract_backward_plain(arrays: FMArrays, rows: torch.Tensor,
                           num_steps: int):
    """femto_tpu's scan: num_steps LF steps, emitting each row's code,
    unmapped to the alphabet.  A row outside the text (negative, or a pad
    row past n, whose code is not below K) stays put and emits its pad
    code (INVALID_ALPHA for a negative row), as kernel D does.  There the
    port departs from femto_tpu, which reads such rows through clamped
    indices and walks on to rows that stand for no text position."""
    K = R.alpha_count(arrays)
    codes = []
    for _ in range(num_steps):
        live = rows >= 0
        safe = torch.where(live, rows, 0)
        code = R.bwt_code_at(arrays, safe)
        pad = ~live | (code >= K)
        step = torch.where(pad, 0, safe)
        code_ok = torch.where(pad, 0, code)
        codes.append(torch.where(
            live, torch.where(pad, code, R.unmap_char(arrays, code_ok)),
            INVALID_ALPHA).to(torch.int32))
        rows = torch.where(pad, rows, R.lf_step(arrays, step))
    if not codes:
        return (torch.zeros((rows.shape[0], 0), dtype=torch.int32,
                            device=rows.device), rows)
    return torch.stack(codes, dim=1), rows


def extract_backward(arrays: FMArrays, rows: torch.Tensor, num_steps: int):
    """Walk LF num_steps times from each row (rows in [0, n)), collecting
    symbols.  Returns (chars int32[B, num_steps], final_rows int32[B]):
    chars[:, t] is the symbol t+1 positions before each row's suffix.
    Kernel D on the card."""
    kernels.check(rows, "rows", torch.int32, 1)
    if not kernels.on_card(rows, *_index_tensors(arrays)):
        return extract_backward_plain(arrays, rows, num_steps)
    view, lay = fm_view(arrays)
    B = rows.shape[0]
    chars = torch.empty((B, num_steps), dtype=torch.int32, device=rows.device)
    final = torch.empty_like(rows)
    kernels.launch("lf_extract", view, rows.data_ptr(), B, num_steps,
                   chars.data_ptr(), final.data_ptr(), layout=lay)
    return chars, final


# ---------------------------------------------------------------------------
# Kernel E: psi walks (extract_context's forward half)
# ---------------------------------------------------------------------------


def psi_walk_plain(arrays: FMArrays, rows: torch.Tensor,
                   num_steps: int) -> torch.Tensor:
    """femto_tpu's _psi_scan_jit: num_steps psi steps, emitting each row's
    first symbol."""
    chars = []
    for _ in range(num_steps):
        rows, c = R.psi_step(arrays, rows)
        chars.append(c)
    if not chars:
        return torch.zeros((rows.shape[0], 0), dtype=torch.int32,
                           device=rows.device)
    return torch.stack(chars, dim=1).to(torch.int32)


def psi_walk(arrays: FMArrays, rows: torch.Tensor,
             num_steps: int) -> torch.Tensor:
    """Walk psi (forward) num_steps times from each row (rows in [0, n)),
    collecting the first symbol of each row's suffix.  Returns chars
    int32[B, num_steps]: chars[:, t] is the symbol t positions after each
    row's suffix start.  Kernel E on the card."""
    kernels.check(rows, "rows", torch.int32, 1)
    if not kernels.on_card(rows, *_index_tensors(arrays)):
        return psi_walk_plain(arrays, rows, num_steps)
    view, lay = fm_view(arrays)
    B = rows.shape[0]
    chars = torch.empty((B, num_steps), dtype=torch.int32, device=rows.device)
    kernels.launch("psi_walk", view, rows.data_ptr(), B, num_steps,
                   chars.data_ptr(), layout=lay)
    return chars
