"""On-device index packaging (all five storage tiers): kernel wrappers +
plain versions.

The counterpart of femto_tpu/ops/build_ops.py.  The aux word and the
suffix-sort payload are kernel K (csrc/sa_payload.cu); the split of the
pulled words with the occ histogram and checkpoints is kernel A (absolute
int32 checkpoints) or A' (uint16 relative ones + L1 rows over the used
columns), both in csrc/occ_build.cu; the mark bitmap, checkpoints, doc
SEOF rows and bit-packed mark values are kernel B (csrc/marks_build.cu);
the packed tier's BWT words are kernel F (csrc/pack_build.cu).  The row
tiers (vseg, vrle) take A's histogram and B's marks into kernel M
(csrc/vseg_build.cu: symbol lists, serving rows, side table) and, on
vrle, kernel N (csrc/vrle_build.cu: slot counts, packed slots, the flat
continuation store), around femto_tpu's host plan (vrle_plan).  The
per-segment document lists are kernel P (csrc/doc_lists.cu) and the uint8
text upload's expansion kernel Q (csrc/text_expand.cu).  Each
wrapper launches its kernel for tensors on the card and takes the plain
PyTorch version beside it for tensors on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..alphabet import (ALPHA_SIZE, CHARACTER_OFFSET, EOH, INVALID_ALPHA,
                        SEOF, SOH)
from ..fmindex import FMArrays, l1_group_for
from ..suffix import text_alphabet
from .rank import i32_to_u16, i64_to_u32, u16_to_i32, u32_to_i64
from .sort_ops import gather_rows


def mark_cap(n: int, ndocs: int, mark_period: int, seg: int) -> int:
    """Static upper bound on the number of marked rows."""
    if mark_period == 0:
        base = 2 * ndocs + 2
    else:
        base = n // mark_period + 2 * ndocs + 2
    return -(-base // 128) * 128


def mark_pack_geom(n: int, mark_period: int, ndocs: int, cap: int):
    """(bits, exc_base, exc_cap, n_words) of the packed mark-value store:
    grid marks (multiples of the period) keep k = value // period in
    `bits`-wide slots; the other marks (doc starts and SEOFs) keep
    k = exc_base + j, an index into an int32 exception region appended
    after the n_words packed words."""
    if mark_period == 0:
        return 1, 1, 1, 1
    exc_base = n // mark_period + 2
    exc_cap = 2 * ndocs + 2
    bits = max(int(np.ceil(np.log2(exc_base + exc_cap + 1))), 1)
    if bits > 31:
        raise ValueError("corpus too large for packed mark values")
    if cap * bits >= (1 << 31):
        raise ValueError(
            "packed mark store exceeds int32 bit addressing; raise "
            "mark_period or chunk the corpus")
    n_words = (cap * bits + 31) // 32 + 1
    return bits, exc_base, exc_cap, n_words


def sa_payload_plain(text: torch.Tensor, doc_starts: torch.Tensor, *, n: int,
                     mark_period: int, ndocs: int) -> torch.Tensor:
    """payload[p] = text[p-1 mod n] | aux[p] << 9 with the per-position aux
    word: bit 0 = the position is mark sampled (doc start, doc SEOF, or on
    the global period grid), bits 1.. = doc id + 1 at the doc's SEOF
    position.  Empty (degenerate) docs are dropped from the SEOF scatter."""
    dev = doc_starts.device
    ds = doc_starts.long()
    nonempty = ds[1:] > ds[:-1]
    seof_pos = torch.where(nonempty, ds[1:] - 1, n)
    tag = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    tag[seof_pos] = torch.arange(1, ndocs + 1, dtype=torch.int64, device=dev)
    tag = tag[:n]
    if mark_period == 0:
        aux = tag << 1
    else:
        marked = torch.zeros(n + 1, dtype=torch.bool, device=dev)
        marked[ds[:-1]] = True
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        marked = marked[:n] | (tag > 0) | (idx % mark_period == 0)
        aux = marked.long() | (tag << 1)
    return torch.roll(text.long(), 1) | (aux << 9)


def build_sa_payload(text: torch.Tensor, doc_starts: torch.Tensor, *, n: int,
                     mark_period: int, ndocs: int) -> torch.Tensor:
    """Suffix-sort payload (int64[n]) whose pull is the BWT + aux word:
    payload[sa[r]] holds row r's BWT symbol in the low 9 bits and its
    mark/SEOF word above (see sa_payload_plain).  text int32[n], doc_starts
    int32[ndocs + 1].  Kernel K on the card."""
    kernels.check(text, "text", torch.int32, 1, (n,))
    kernels.check(doc_starts, "doc_starts", torch.int32, 1, (ndocs + 1,))
    if mark_period < 0:
        raise ValueError("mark_period must be >= 0")
    if not kernels.on_card(text, doc_starts):
        return sa_payload_plain(text, doc_starts, n=n,
                                mark_period=mark_period, ndocs=ndocs)
    payload = torch.empty(n, dtype=torch.int64, device=text.device)
    kernels.launch("sa_payload", text.data_ptr(), n, doc_starts.data_ptr(),
                   ndocs, mark_period, payload.data_ptr())
    return payload


# ---------------------------------------------------------------------------
# Kernel A: BWT split + occ checkpoints
# ---------------------------------------------------------------------------


def _split_hist(pull: torch.Tensor, *, n_seg: int, seg: int):
    """(bwt uint16[n_seg, seg], a_row int32[n], per-segment symbol counts
    int64[n_seg, 261]) of the pulled words."""
    n = pull.shape[0]
    dev = pull.device
    sym = pull & 511
    a_row = (pull >> 9).to(torch.int32)
    bwt = torch.full((n_seg * seg,), INVALID_ALPHA, dtype=torch.int16,
                     device=dev)
    bwt[:n] = sym.to(torch.int16)
    seg_id = torch.arange(n, dtype=torch.int64, device=dev) // seg
    valid = sym < ALPHA_SIZE
    per_seg = torch.bincount((seg_id * ALPHA_SIZE + sym)[valid],
                             minlength=n_seg * ALPHA_SIZE).view(n_seg,
                                                               ALPHA_SIZE)
    return bwt.view(torch.uint16).view(n_seg, seg), a_row, per_seg


def _checkpoints(per_seg: torch.Tensor):
    """(exclusive checkpoints int64[n_seg, K], C int32[K+1]) of counts."""
    C = torch.zeros(per_seg.shape[1] + 1, dtype=torch.int64,
                    device=per_seg.device)
    C[1:] = torch.cumsum(per_seg.sum(dim=0), dim=0)
    occ = torch.zeros_like(per_seg)
    occ[1:] = torch.cumsum(per_seg[:-1], dim=0)
    return occ, C.to(torch.int32)


def occ_build_plain(pull: torch.Tensor, *, n_seg: int, seg: int):
    """(bwt uint16[n_seg, seg], a_row int32[n], occ_ckpt int32[n_seg, 261],
    C int32[262]) from the pulled words: the split, a per-segment
    histogram, and exclusive checkpoints down the segments."""
    bwt, a_row, per_seg = _split_hist(pull, n_seg=n_seg, seg=seg)
    occ, C = _checkpoints(per_seg)
    return bwt, a_row, occ.to(torch.int32), C


def occ_build(pull: torch.Tensor, *, n_seg: int, seg: int):
    """Kernel A on the card (see occ_build_plain for the outputs)."""
    kernels.check(pull, "pull", torch.int64, 1)
    n = pull.shape[0]
    if seg % 32 != 0 or n_seg * seg <= n:
        raise ValueError("need seg % 32 == 0 and n_seg * seg > n")
    if not kernels.on_card(pull):
        return occ_build_plain(pull, n_seg=n_seg, seg=seg)
    dev = pull.device
    bwt = torch.empty((n_seg, seg), dtype=torch.uint16, device=dev)
    a_row = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty((n_seg, ALPHA_SIZE), dtype=torch.int32, device=dev)
    C = torch.empty(ALPHA_SIZE + 1, dtype=torch.int32, device=dev)
    n_tiles = -(-n_seg // 1024)
    tiles = torch.empty((n_tiles, ALPHA_SIZE), dtype=torch.int32, device=dev)
    kernels.launch("occ_build", pull.data_ptr(), n, n_seg, seg,
                   bwt.data_ptr(), a_row.data_ptr(), occ.data_ptr(),
                   C.data_ptr(), tiles.data_ptr())
    return bwt, a_row, occ, C


def occ_build_compact_plain(pull: torch.Tensor, alpha_rev: torch.Tensor, *,
                            n_seg: int, seg: int, want_hist: bool = False):
    """(bwt uint16[n_seg, seg], a_row int32[n], occ_ckpt uint16[n_seg, K],
    occ_l1 int32[n_seg/grp, K], C int32[K+1]) over the K used symbols
    alpha_rev (int32[K], ascending; every symbol on the compact tier):
    femto_tpu's _ckpt_stage(compact=True) of the used columns.  With
    want_hist, the per-segment counts of those columns (int32[n_seg, K],
    the row tiers' input) come last."""
    grp = l1_group_for(seg)
    bwt, a_row, per_seg = _split_hist(pull, n_seg=n_seg, seg=seg)
    used = per_seg[:, alpha_rev.long()]
    occ, C = _checkpoints(used)
    occ_l1 = occ[::grp]
    rel = occ - torch.repeat_interleave(occ_l1, grp, dim=0)
    out = (bwt, a_row, i32_to_u16(rel.to(torch.int32)),
           occ_l1.to(torch.int32), C)
    return out + (used.to(torch.int32),) if want_hist else out


def occ_build_compact(pull: torch.Tensor, alpha_map: torch.Tensor,
                      alpha_rev: torch.Tensor, *, n_seg: int, seg: int,
                      want_hist: bool = False):
    """Kernel A' on the card (see occ_build_compact_plain for the
    outputs); alpha_map int32[261] maps each symbol to its column or -1.
    The histogram is the kernel's own scratch, returned with want_hist."""
    kernels.check(pull, "pull", torch.int64, 1)
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(alpha_rev, "alpha_rev", torch.int32, 1)
    n = pull.shape[0]
    grp = l1_group_for(seg)
    if seg % 32 != 0 or n_seg * seg <= n or n_seg % grp != 0:
        raise ValueError("need seg % 32 == 0, n_seg * seg > n and n_seg a "
                         "multiple of the L1 group")
    if not kernels.on_card(pull, alpha_map, alpha_rev):
        return occ_build_compact_plain(pull, alpha_rev, n_seg=n_seg, seg=seg,
                                       want_hist=want_hist)
    dev = pull.device
    K = alpha_rev.shape[0]

    def empty(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    bwt = empty(torch.uint16, n_seg, seg)
    a_row = empty(torch.int32, n)
    occ = empty(torch.uint16, n_seg, K)
    occ_l1 = empty(torch.int32, n_seg // grp, K)
    C = empty(torch.int32, K + 1)
    hist = empty(torch.int32, n_seg, K)
    tiles = empty(torch.int32, -(-n_seg // 1024), K)
    kernels.launch("occ_build_compact", pull.data_ptr(), n, n_seg, seg,
                   alpha_map.data_ptr(), K, grp, bwt.data_ptr(),
                   a_row.data_ptr(), occ.data_ptr(), occ_l1.data_ptr(),
                   C.data_ptr(), hist.data_ptr(), tiles.data_ptr())
    out = (bwt, a_row, occ, occ_l1, C)
    return out + (hist,) if want_hist else out


# ---------------------------------------------------------------------------
# Kernel F: the packed tier's BWT words
# ---------------------------------------------------------------------------


def pack_widths(K: int):
    """(per_word, bits) for a dense alphabet of K codes: the pad value
    (all ones in `bits`) must be >= K so it never matches a query code,
    and bits = 32 // per_word, as the query side derives it from shapes."""
    per_word = 32 // max(1, int(K).bit_length())
    return per_word, 32 // per_word


def pack_build_plain(bwt: torch.Tensor, alpha_map: torch.Tensor, *,
                     per_word: int, bits: int) -> torch.Tensor:
    """uint32[n_seg, W] words of the uint16 BWT rows: each symbol's dense
    code, per_word codes of `bits` bits to a word; the all-ones pad code
    past row n and past seg in each row."""
    n_seg, seg = bwt.shape
    W = -(-seg // per_word)
    pad = (1 << bits) - 1
    sym = u16_to_i32(bwt).long()
    valid = sym < ALPHA_SIZE
    code = torch.where(valid, alpha_map[torch.where(valid, sym, 0)].long(),
                       -1)
    codes = torch.full((n_seg, W * per_word), pad, dtype=torch.int64,
                       device=bwt.device)
    codes[:, :seg] = torch.where(code >= 0, code, pad)
    shifts = torch.arange(per_word, device=bwt.device) * bits
    words = (codes.view(n_seg, W, per_word) << shifts).sum(dim=2)
    return i64_to_u32(words)


def pack_build(bwt: torch.Tensor, alpha_map: torch.Tensor, *, per_word: int,
               bits: int) -> torch.Tensor:
    """Kernel F on the card (see pack_build_plain for the output)."""
    kernels.check(bwt, "bwt", torch.uint16, 2)
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    if per_word * bits > 32 or per_word < 1:
        raise ValueError("need 1 <= per_word and per_word * bits <= 32")
    if not kernels.on_card(bwt, alpha_map):
        return pack_build_plain(bwt, alpha_map, per_word=per_word, bits=bits)
    n_seg, seg = bwt.shape
    W = -(-seg // per_word)
    words = torch.empty((n_seg, W), dtype=torch.uint32, device=bwt.device)
    kernels.launch("pack_build", bwt.data_ptr(), n_seg, seg,
                   alpha_map.data_ptr(), W, per_word, bits, words.data_ptr())
    return words


# ---------------------------------------------------------------------------
# Kernel B: marks
# ---------------------------------------------------------------------------


def _marks_geometry(n, ndocs, mark_period, seg):
    cap = mark_cap(n, ndocs, mark_period, seg)
    bits, exc_base, exc_cap, n_words = mark_pack_geom(n, mark_period, ndocs,
                                                      cap)
    return cap, bits, exc_base, exc_cap, n_words


def _mark_meta(mark_period, cap, bits, exc_base, n_words, dev):
    meta = ([bits, exc_base, mark_period, n_words, cap] if mark_period
            else [1, 1, 0, 1, cap])
    return torch.tensor(meta, dtype=torch.int32, device=dev)


def marks_build_plain(sa: torch.Tensor, a_row: torch.Tensor, *, n_seg: int,
                      seg: int, mark_period: int, ndocs: int):
    """(mark_bits uint32[n_seg, seg/32], mark_ckpt int32[n_seg], mark_vals
    uint32[...], mark_meta int32[5], n_marks int32[], doc_seof_rows
    int32[ndocs]) from the row-order suffix array and aux words."""
    n = sa.shape[0]
    dev = sa.device
    cap, bits, exc_base, exc_cap, n_words = _marks_geometry(
        n, ndocs, mark_period, seg)
    marked = torch.zeros(n_seg * seg, dtype=torch.int64, device=dev)
    marked[:n] = (a_row & 1).long()
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))
    mark_bits = i64_to_u32((marked.view(-1, 32) * weights).sum(dim=1))
    per_seg = marked.view(n_seg, seg).sum(dim=1)
    mark_ckpt = torch.zeros(n_seg, dtype=torch.int64, device=dev)
    mark_ckpt[1:] = torch.cumsum(per_seg[:-1], dim=0)
    n_marks = per_seg.sum().to(torch.int32)
    tag = (a_row >> 1).long()
    seof = torch.nonzero(tag > 0).flatten()
    doc_seof_rows = torch.zeros(ndocs, dtype=torch.int32, device=dev)
    doc_seof_rows[tag[seof] - 1] = seof.to(torch.int32)
    if mark_period == 0:
        mark_vals = torch.zeros(2, dtype=torch.int64, device=dev)
    else:
        mv = sa[marked[:n] != 0].long()           # values in row order
        is_exc = (mv % mark_period) != 0
        exc_rank = torch.cumsum(is_exc.long(), dim=0) - 1
        k = torch.where(is_exc, exc_base + exc_rank, mv // mark_period)
        bp = torch.arange(k.shape[0], dtype=torch.int64, device=dev) * bits
        wi = bp >> 5
        sh = bp & 31
        words = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
        words.index_add_(0, wi, torch.bitwise_left_shift(k, sh) & 0xFFFFFFFF)
        words.index_add_(0, wi + 1, torch.bitwise_right_shift(k, 32 - sh))
        exc = torch.zeros(exc_cap, dtype=torch.int64, device=dev)
        exc[exc_rank[is_exc]] = mv[is_exc]
        mark_vals = torch.cat([words[:n_words], exc & 0xFFFFFFFF])
    return (mark_bits.view(n_seg, seg // 32), mark_ckpt.to(torch.int32),
            i64_to_u32(mark_vals),
            _mark_meta(mark_period, cap, bits, exc_base, n_words, dev),
            n_marks, doc_seof_rows)


def marks_build(sa: torch.Tensor, a_row: torch.Tensor, *, n_seg: int,
                seg: int, mark_period: int, ndocs: int):
    """Kernel B on the card (see marks_build_plain for the outputs)."""
    kernels.check(sa, "sa", torch.int32, 1)
    n = sa.shape[0]
    kernels.check(a_row, "a_row", torch.int32, 1, (n,))
    if seg % 32 != 0 or n_seg * seg <= n:
        raise ValueError("need seg % 32 == 0 and n_seg * seg > n")
    if not kernels.on_card(sa, a_row):
        return marks_build_plain(sa, a_row, n_seg=n_seg, seg=seg,
                                 mark_period=mark_period, ndocs=ndocs)
    dev = sa.device
    cap, bits, exc_base, exc_cap, n_words = _marks_geometry(
        n, ndocs, mark_period, seg)

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    mark_bits = torch.empty((n_seg, seg // 32), dtype=torch.uint32,
                            device=dev)
    mark_ckpt = i32(n_seg)
    doc_seof_rows = torch.zeros(ndocs, dtype=torch.int32, device=dev)
    totals = i32(2)
    if mark_period:
        mark_vals = torch.zeros(n_words + exc_cap, dtype=torch.int32,
                                device=dev).view(torch.uint32)
        kslots = torch.zeros(cap, dtype=torch.int32, device=dev)
    else:
        mark_vals = torch.zeros(2, dtype=torch.int32,
                                device=dev).view(torch.uint32)
        kslots = i32(1)
    scratch = [i32(n_seg) for _ in range(3)]  # seg_marks, seg_exc, exc_ckpt
    kernels.launch("marks_build", sa.data_ptr(), a_row.data_ptr(), n, n_seg,
                   seg, mark_period, cap, bits, exc_base, exc_cap, n_words,
                   mark_bits.data_ptr(), mark_ckpt.data_ptr(),
                   mark_vals.data_ptr(), doc_seof_rows.data_ptr(),
                   totals.data_ptr(), *(t.data_ptr() for t in scratch),
                   kslots.data_ptr())
    return (mark_bits, mark_ckpt, mark_vals,
            _mark_meta(mark_period, cap, bits, exc_base, n_words, dev),
            totals[0], doc_seof_rows)


# ---------------------------------------------------------------------------
# The row tiers (vseg, vrle): host geometry and plan
# ---------------------------------------------------------------------------

VSEG_SMAX = 32   # vseg symbol-list capacity; more symbols -> nsym 255
VRLE_SMAX = 64   # vrle symbol-list capacity (w_s <= 6 keeps 4 length bits)
VRLE_CONT_G = 16  # words per granule row of the flat continuation store
SYM_PAD = 1 << 20  # symbol-list pad before the stored lists clip it


def vseg_width_for(seg: int, w: int):
    """(effective width, words per row) for candidate width w: the query
    side re-derives the width as 32 // ceil(seg / W), so the build
    canonicalises w up to that value (femto_tpu's _vseg_width_for)."""
    W = -(-seg // (32 // w))
    per_word = -(-seg // W)
    return 32 // per_word, W


def vseg_width_candidates(seg: int):
    """Deduped (w_eff, W) candidate main widths."""
    out, seen = [], set()
    for w in (1, 2, 3, 4, 5):
        w_eff, W = vseg_width_for(seg, w)
        if W not in seen:
            seen.add(W)
            out.append((w_eff, W))
    return out


def vseg_sym_store(w_main: int, wide: bool) -> int:
    """Stored symbol-list length: min(SMAX, 2^w_main) rounded up to the
    per-word packing unit (4 u8 / 2 u16 symbols per uint32)."""
    per = 2 if wide else 4
    return -(-min(VSEG_SMAX, 1 << w_main) // per) * per


def vrle_ws_np(nsym: np.ndarray) -> np.ndarray:
    """Per-segment RLE symbol width ceil(log2(max(nsym, 2))), capped at 6."""
    n = nsym.astype(np.int64)
    return (1 + (n > 2) + (n > 4) + (n > 8) + (n > 16) + (n > 32)).astype(
        np.int32)


def vrle_slot_geom_np(nsym: np.ndarray):
    """(w_slot, lenbits) per segment: 6/8/10-bit slots for symbol widths
    1-2/3-4/5-6, lenbits = w_slot - ws."""
    ws = vrle_ws_np(nsym)
    w_slot = 6 + 2 * ((ws > 2).astype(np.int32) + (ws > 4).astype(np.int32))
    return w_slot, w_slot - ws


def vrle_plan(nsym_np: np.ndarray, slots_np: np.ndarray, *, seg: int,
              n_seg: int, wide: bool, Wside: int):
    """Host argmin over (w_main, A_words, C_words) -- femto_tpu's
    vrle_plan, line for line: per-segment mode = RLE slots if the
    segment's slot bits fit the main code area, RLE plus a continuation
    if they fit A + C words, else fixed w_main-bit codes if its alphabet
    fits, else the side table.  Returns (w_main, A_words, C_words,
    s_store, rle_np, cont_np, wfit_np)."""
    sym_b = 2 if wide else 1
    per = 2 if wide else 4
    rle_alpha = (nsym_np <= VRLE_SMAX) & (nsym_np < 255)
    w_slot_np, _ = vrle_slot_geom_np(nsym_np)
    bits_np = slots_np.astype(np.int64) * w_slot_np
    best = None
    pcts = np.percentile(bits_np / 32.0,
                         [30, 40, 50, 60, 70, 80, 90, 95, 99]) \
        if n_seg else np.array([seg])
    for w_eff, Wm in vseg_width_candidates(seg):
        wfit = (nsym_np <= (1 << w_eff)) & (nsym_np < 255)
        a_cands = {Wm}
        for p in pcts:
            a_cands.add(max(int(np.ceil(p)), Wm))
        a_cands.add(seg // 4)
        for A in sorted(a_cands):
            if A > max(seg // 2, Wm):
                continue
            for C in (0, A // 2, A, 2 * A):
                if C > seg // 4 and C > A:
                    continue
                rle = rle_alpha & (bits_np <= A * 32)
                cont = (rle_alpha & ~rle
                        & (bits_np <= (A + C) * 32)) if C else \
                    np.zeros_like(rle)
                cov = rle | cont | wfit
                n_cov = int(cov.sum())
                smax_cov = int(nsym_np[cov].max()) if n_cov else 2
                s_store = -(-min(max(smax_cov, 2), VRLE_SMAX) // per) * per
                cont_words = int(np.sum(
                    (-(-bits_np[cont] // 32)) - A)) if cont.any() else 0
                bytes_w = (n_seg * (A * 4 + s_store * sym_b)
                           + cont_words * 4
                           + int((~cov).sum()) * Wside * 4)
                if best is None or bytes_w < best[0]:
                    best = (bytes_w, w_eff, A, C, s_store, rle, cont, wfit)
    _, w_main, A_words, C_words, s_store, rle_np, cont_np, wfit_np = best
    return w_main, A_words, C_words, s_store, rle_np, cont_np, wfit_np


# ---------------------------------------------------------------------------
# Kernel M: symbol lists and row assembly (vseg, and vrle's rows)
# ---------------------------------------------------------------------------


def seg_syms_plain(hist: torch.Tensor, smax: int):
    """(syms int32[n_seg, smax] the sorted present codes of each segment,
    pad SYM_PAD; nsym uint8[n_seg], 255 above smax) from the per-segment
    histogram over the dense codes (femto_tpu's _stats_from_hist)."""
    n_seg, K = hist.shape
    pres = hist > 0
    nsym = pres.sum(dim=1)
    rank = torch.cumsum(pres.long(), dim=1) - 1
    tgt = torch.where(pres & (rank < smax), rank, smax)
    codes = torch.arange(K, dtype=torch.int32, device=hist.device)
    syms = torch.full((n_seg, smax + 1), SYM_PAD, dtype=torch.int32,
                      device=hist.device)
    syms.scatter_(1, tgt, codes.expand(n_seg, K).contiguous())
    return (syms[:, :smax].contiguous(),
            torch.where(nsym > smax, 255, nsym).to(torch.uint8))


def seg_syms(hist: torch.Tensor, smax: int):
    """Kernel M's symbol lists on the card (see seg_syms_plain)."""
    kernels.check(hist, "hist", torch.int32, 2)
    if not 1 <= smax <= 255:
        raise ValueError("smax must lie in [1, 255]")
    if not kernels.on_card(hist):
        return seg_syms_plain(hist, smax)
    n_seg, K = hist.shape
    syms = torch.empty((n_seg, smax), dtype=torch.int32, device=hist.device)
    nsym = torch.empty(n_seg, dtype=torch.uint8, device=hist.device)
    kernels.launch("seg_syms", hist.data_ptr(), n_seg, K, smax,
                   syms.data_ptr(), nsym.data_ptr())
    return syms, nsym


def _dense_codes(bwt: torch.Tensor, alpha_map: torch.Tensor) -> torch.Tensor:
    """int64[n_seg, seg] dense code of each BWT symbol; the pad rows past
    n (INVALID_ALPHA) get a code above every symbol-list entry."""
    sym = u16_to_i32(bwt).long()
    valid = sym < ALPHA_SIZE
    return torch.where(valid, alpha_map[torch.where(valid, sym, 0)].long(),
                       SYM_PAD + 7)


def _local_codes(bwt: torch.Tensor, alpha_map: torch.Tensor,
                 syms: torch.Tensor) -> torch.Tensor:
    """int64[n_seg, seg] local code of each position: the number of the
    segment's listed symbols below its dense code (its rank in the list
    when listed); 0 on the pad rows."""
    codes = _dense_codes(bwt, alpha_map)
    lc = torch.searchsorted(syms.long().contiguous(), codes.contiguous())
    return torch.where(codes < SYM_PAD, lc, 0)


def _pack_fields(vals: torch.Tensor, w: int) -> torch.Tensor:
    """int64[R, seg] values of w bits -> int64[R, ceil(seg / (32 // w))]
    words, 32 // w fields to a word from bit 0 up, zero fields past seg."""
    per = 32 // w
    R, seg = vals.shape
    W = -(-seg // per)
    full = vals.new_zeros((R, W * per))
    full[:, :seg] = vals
    shifts = torch.arange(per, device=vals.device) * w
    return (full.view(R, W, per) << shifts).sum(dim=2)


def vseg_rows_plain(bwt: torch.Tensor, alpha_map: torch.Tensor,
                    syms: torch.Tensor, nsym: torch.Tensor,
                    seg_woff: torch.Tensor, mark_bits: torch.Tensor,
                    mark_ckpt: torch.Tensor, occ_rel: torch.Tensor, *,
                    w_main: int, code_words: int, s_store: int, wide: bool,
                    rle: torch.Tensor | None = None) -> torch.Tensor:
    """uint32[n_seg, total] serving rows: [code area | symbol list | mark
    words | mark checkpoint | uint16-relative checkpoints in pairs].

    The code area (code_words words) holds each segment's local codes at
    w_main bits where its alphabet fits (nsym <= 2^w_main, not 255), else
    zeros (its codes live in the side table); a segment with seg_woff < 0
    takes the first code_words words of its row of rle (vrle).  The list
    holds the first s_store symbols, pads clipped to 0xFF (u8) or 0xFFFF
    (wide: u16), 4 or 2 to a word."""
    n_seg, _ = bwt.shape
    lc = _local_codes(bwt, alpha_map, syms)
    fits = (nsym.long() <= (1 << w_main)) & (nsym.long() < 255)
    packed = _pack_fields(torch.where(fits[:, None], lc, 0), w_main)
    code = packed.new_zeros((n_seg, code_words))
    code[:, :packed.shape[1]] = packed
    if rle is not None:
        code = torch.where((seg_woff < 0)[:, None],
                           u32_to_i64(rle[:, :code_words]), code)
    per = 2 if wide else 4
    sv = torch.clamp(syms[:, :s_store].long(), max=0xFFFF if wide else 0xFF)
    shifts = torch.arange(per, device=bwt.device) * (32 // per)
    sym_words = (sv.view(n_seg, s_store // per, per) << shifts).sum(dim=2)
    rel = u16_to_i32(occ_rel).long()
    if rel.shape[1] % 2:
        rel = torch.cat([rel, rel.new_zeros((n_seg, 1))], dim=1)
    rel_words = rel[:, 0::2] | (rel[:, 1::2] << 16)
    return i64_to_u32(torch.cat(
        [code, sym_words, u32_to_i64(mark_bits),
         (mark_ckpt.long() & 0xFFFFFFFF)[:, None], rel_words], dim=1))


def vseg_rows(bwt: torch.Tensor, alpha_map: torch.Tensor, syms: torch.Tensor,
              nsym: torch.Tensor, seg_woff: torch.Tensor,
              mark_bits: torch.Tensor, mark_ckpt: torch.Tensor,
              occ_rel: torch.Tensor, *, w_main: int, code_words: int,
              s_store: int, wide: bool, rle: torch.Tensor | None = None
              ) -> torch.Tensor:
    """Kernel M's row assembly on the card (see vseg_rows_plain)."""
    kernels.check(bwt, "bwt", torch.uint16, 2)
    n_seg, seg = bwt.shape
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(syms, "syms", torch.int32, 2)
    kernels.check(nsym, "nsym", torch.uint8, 1, (n_seg,))
    kernels.check(seg_woff, "seg_woff", torch.int32, 1, (n_seg,))
    kernels.check(mark_bits, "mark_bits", torch.uint32, 2, (n_seg, seg // 32))
    kernels.check(mark_ckpt, "mark_ckpt", torch.int32, 1, (n_seg,))
    kernels.check(occ_rel, "occ_rel", torch.uint16, 2)
    per = 2 if wide else 4
    if (w_main not in range(1, 17) or s_store % per
            or not 0 < s_store <= syms.shape[1]
            or code_words < -(-seg // (32 // w_main))
            or occ_rel.shape[0] != n_seg or syms.shape[0] != n_seg):
        raise ValueError("inconsistent row geometry")
    if rle is not None:
        kernels.check(rle, "rle", torch.uint32, 2)
        if rle.shape[0] != n_seg or rle.shape[1] < code_words:
            raise ValueError("rle must be [n_seg, >= code_words]")
    tensors = (bwt, alpha_map, syms, nsym, seg_woff, mark_bits, mark_ckpt,
               occ_rel) + ((rle,) if rle is not None else ())
    if not kernels.on_card(*tensors):
        return vseg_rows_plain(bwt, alpha_map, syms, nsym, seg_woff,
                               mark_bits, mark_ckpt, occ_rel, w_main=w_main,
                               code_words=code_words, s_store=s_store,
                               wide=wide, rle=rle)
    K = occ_rel.shape[1]
    total = code_words + s_store // per + seg // 32 + 1 + -(-K // 2)
    out = torch.empty((n_seg, total), dtype=torch.uint32, device=bwt.device)
    kernels.launch("vseg_rows", bwt.data_ptr(), n_seg, seg,
                   alpha_map.data_ptr(), syms.data_ptr(), syms.shape[1],
                   nsym.data_ptr(), seg_woff.data_ptr(), w_main, code_words,
                   rle.data_ptr() if rle is not None else None,
                   rle.shape[1] if rle is not None else 0, s_store, int(wide),
                   mark_bits.data_ptr(), mark_ckpt.data_ptr(),
                   occ_rel.data_ptr(), K, total, out.data_ptr())
    return out


def side_rows_plain(bwt: torch.Tensor, alpha_map: torch.Tensor,
                    ovf_idx: torch.Tensor, *, w_side: int) -> torch.Tensor:
    """uint32[n_ovf + 1, Ws] side table: row 0 zeros, then each listed
    segment's GLOBAL dense codes at w_side bits (0 on the pad rows)."""
    codes = _dense_codes(bwt.view(torch.int16)[ovf_idx.long()], alpha_map)
    words = _pack_fields(torch.where(codes < SYM_PAD, codes, 0), w_side)
    return i64_to_u32(torch.cat([words.new_zeros((1, words.shape[1])),
                                 words]))


def side_rows(bwt: torch.Tensor, alpha_map: torch.Tensor,
              ovf_idx: torch.Tensor, *, w_side: int) -> torch.Tensor:
    """Kernel M's side table on the card (see side_rows_plain)."""
    kernels.check(bwt, "bwt", torch.uint16, 2)
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(ovf_idx, "ovf_idx", torch.int32, 1)
    if w_side not in range(1, 17):
        raise ValueError("w_side must lie in [1, 16]")
    if not kernels.on_card(bwt, alpha_map, ovf_idx):
        return side_rows_plain(bwt, alpha_map, ovf_idx, w_side=w_side)
    n_seg, seg = bwt.shape
    Ws = -(-seg // (32 // w_side))
    novf = ovf_idx.shape[0]
    out = torch.empty((novf + 1, Ws), dtype=torch.uint32, device=bwt.device)
    kernels.launch("side_rows", bwt.data_ptr(), n_seg, seg,
                   alpha_map.data_ptr(), ovf_idx.data_ptr(), novf, w_side,
                   Ws, out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Kernel N: vrle slots
# ---------------------------------------------------------------------------


def _slot_starts(lc: torch.Tensor, nsym: torch.Tensor):
    """(is_slot bool[n_seg, seg], lenbits int64[n_seg]): slot starts of
    each segment's runs of local codes, runs split at 2^lenbits - 1."""
    from .rank import vrle_slot_geom

    seg = lc.shape[1]
    _, lenbits = vrle_slot_geom(nsym)
    maxlen = (1 << lenbits) - 1
    iota = torch.arange(seg, device=lc.device).expand_as(lc)
    brk = torch.ones_like(lc, dtype=torch.bool)
    brk[:, 1:] = lc[:, 1:] != lc[:, :-1]
    run_start = torch.cummax(torch.where(brk, iota, 0), dim=1).values
    return brk | ((iota - run_start) % maxlen[:, None] == 0), lenbits


def vrle_slot_count_plain(bwt: torch.Tensor, alpha_map: torch.Tensor,
                          syms: torch.Tensor,
                          nsym: torch.Tensor) -> torch.Tensor:
    """int32[n_seg] RLE slots per segment at its own slot geometry
    (femto_tpu's _vrle_slot_stats)."""
    is_slot, _ = _slot_starts(_local_codes(bwt, alpha_map, syms), nsym)
    return is_slot.sum(dim=1).to(torch.int32)


def vrle_slot_count(bwt: torch.Tensor, alpha_map: torch.Tensor,
                    syms: torch.Tensor, nsym: torch.Tensor) -> torch.Tensor:
    """Kernel N's slot counts on the card (see vrle_slot_count_plain)."""
    kernels.check(bwt, "bwt", torch.uint16, 2)
    n_seg, seg = bwt.shape
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(syms, "syms", torch.int32, 2)
    kernels.check(nsym, "nsym", torch.uint8, 1, (n_seg,))
    if not kernels.on_card(bwt, alpha_map, syms, nsym):
        return vrle_slot_count_plain(bwt, alpha_map, syms, nsym)
    out = torch.empty(n_seg, dtype=torch.int32, device=bwt.device)
    kernels.launch("vrle_slot_count", bwt.data_ptr(), n_seg, seg,
                   alpha_map.data_ptr(), syms.data_ptr(), syms.shape[1],
                   nsym.data_ptr(), out.data_ptr())
    return out


def vrle_pack_plain(bwt: torch.Tensor, alpha_map: torch.Tensor,
                    syms: torch.Tensor, nsym: torch.Tensor,
                    seg_woff: torch.Tensor, *, words: int) -> torch.Tensor:
    """uint32[n_seg, words]: the RLE slots (local code << lenbits | run
    length) of each segment with seg_woff < 0, bit-packed from bit 0 at
    its 6/8/10-bit slot width (femto_tpu's _vrle_pack_slots, slots past
    the words dropped); zeros for the other segments."""
    from .rank import vrle_slot_geom

    n_seg, seg = bwt.shape
    lc = _local_codes(bwt, alpha_map, syms)
    is_slot, lenbits = _slot_starts(lc, nsym)
    w_slot, _ = vrle_slot_geom(nsym)
    iota = torch.arange(seg, device=bwt.device).expand_as(lc)
    slot_idx = torch.cumsum(is_slot.long(), dim=1) - 1
    # a slot ends where the next one starts: suffix-min of the starts
    idxs = torch.where(is_slot, iota, seg)
    nxt = torch.full_like(idxs, seg)
    nxt[:, :-1] = torch.flip(torch.cummin(torch.flip(idxs, [1]), dim=1)
                             .values, [1])[:, 1:]
    val = (lc << lenbits[:, None]) | (nxt - iota)
    keep = (is_slot & (slot_idx < ((words * 32) // w_slot)[:, None])
            & (seg_woff < 0)[:, None])
    bp = slot_idx * w_slot[:, None]
    wi = bp >> 5
    sh = bp & 31
    rowbase = torch.arange(n_seg, device=bwt.device)[:, None] * (words + 2)
    out = torch.zeros(n_seg * (words + 2), dtype=torch.int64,
                      device=bwt.device)
    out.index_add_(0, (rowbase + wi)[keep], ((val << sh) & 0xFFFFFFFF)[keep])
    hi = torch.where(sh > 0, val >> (32 - sh), 0)
    out.index_add_(0, (rowbase + wi + 1)[keep], hi[keep])
    return i64_to_u32(out.view(n_seg, words + 2)[:, :words])


def vrle_pack(bwt: torch.Tensor, alpha_map: torch.Tensor, syms: torch.Tensor,
              nsym: torch.Tensor, seg_woff: torch.Tensor, *,
              words: int) -> torch.Tensor:
    """Kernel N's slot packing on the card (see vrle_pack_plain)."""
    kernels.check(bwt, "bwt", torch.uint16, 2)
    n_seg, seg = bwt.shape
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(syms, "syms", torch.int32, 2)
    kernels.check(nsym, "nsym", torch.uint8, 1, (n_seg,))
    kernels.check(seg_woff, "seg_woff", torch.int32, 1, (n_seg,))
    if words < 1:
        raise ValueError("words must be >= 1")
    if not kernels.on_card(bwt, alpha_map, syms, nsym, seg_woff):
        return vrle_pack_plain(bwt, alpha_map, syms, nsym, seg_woff,
                               words=words)
    out = torch.empty((n_seg, words), dtype=torch.uint32, device=bwt.device)
    kernels.launch("vrle_pack", bwt.data_ptr(), n_seg, seg,
                   alpha_map.data_ptr(), syms.data_ptr(), syms.shape[1],
                   nsym.data_ptr(), seg_woff.data_ptr(), words,
                   out.data_ptr())
    return out


def cont_flatten_plain(rle: torch.Tensor, cont_idx: torch.Tensor,
                       cwords: torch.Tensor, offs: torch.Tensor, *,
                       first: int, total: int) -> torch.Tensor:
    """uint32[total] flat continuation store: the words from column first
    on of rle's row cont_idx[k], cwords[k] of them, at offs[k]; zeros
    elsewhere (femto_tpu's _flatten_ragged with fill 0)."""
    cols = rle.shape[1] - first
    j = torch.arange(cols, device=rle.device)
    valid = j[None, :] < cwords.long()[:, None]
    idx = offs.long()[:, None] + j[None, :]
    src = rle.view(torch.int32)[cont_idx.long(), first:]
    out = torch.zeros(total, dtype=torch.int32, device=rle.device)
    out[idx[valid]] = src[valid]
    return out.view(torch.uint32)


def cont_flatten(rle: torch.Tensor, cont_idx: torch.Tensor,
                 cwords: torch.Tensor, offs: torch.Tensor, *, first: int,
                 total: int) -> torch.Tensor:
    """Kernel N's continuation store on the card (see
    cont_flatten_plain)."""
    kernels.check(rle, "rle", torch.uint32, 2)
    kernels.check(cont_idx, "cont_idx", torch.int32, 1)
    m = cont_idx.shape[0]
    kernels.check(cwords, "cwords", torch.int32, 1, (m,))
    kernels.check(offs, "offs", torch.int32, 1, (m,))
    if not 0 <= first <= rle.shape[1]:
        raise ValueError("first must lie in [0, rle.shape[1]]")
    if not kernels.on_card(rle, cont_idx, cwords, offs):
        return cont_flatten_plain(rle, cont_idx, cwords, offs, first=first,
                                  total=total)
    out = torch.empty(total, dtype=torch.uint32, device=rle.device)
    kernels.launch("cont_flatten", rle.data_ptr(), rle.shape[0],
                   rle.shape[1], first, cont_idx.data_ptr(),
                   cwords.data_ptr(), offs.data_ptr(), m, total,
                   out.data_ptr())
    return out


def _host_i32(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def _side_table(bwt, alpha_map, cov: np.ndarray, w_side: int):
    """(seg_ovf, ovf_idx) of the segments cov leaves out."""
    ovf_idx = np.nonzero(~cov)[0].astype(np.int32)
    if not len(ovf_idx):
        return torch.zeros((1, 1), dtype=torch.int32,
                           device=bwt.device).view(torch.uint32), ovf_idx
    return side_rows(bwt, alpha_map, _host_i32(ovf_idx, bwt.device),
                     w_side=w_side), ovf_idx


def _sym_marker(s_store: int, wide: bool, dev) -> torch.Tensor:
    """seg_syms: a [1, s_store] marker whose dtype says u8 or u16 lists."""
    z = torch.zeros((1, s_store), dtype=torch.int16 if wide else torch.uint8,
                    device=dev)
    return z.view(torch.uint16) if wide else z


@dataclass
class RowPlan:
    """What a row-tier build decides on the host from the symbol counts
    (and, on vrle, the slot counts): the row geometry, each segment's mode
    and the continuations' place in the flat store.  Kernel M's symbol
    lists ride along for the assembly."""
    tier: str
    w_main: int
    code_words: int        # words of the code area (vrle: A)
    C_words: int           # vrle: the continuation budget C; vseg: 0
    s_store: int           # symbol-list entries stored in a row
    smax: int              # VSEG_SMAX or VRLE_SMAX
    w_side: int
    wide: bool             # K > 256: u16 symbol lists
    syms: torch.Tensor     # int32[n_seg, smax] (kernel M)
    nsym: torch.Tensor     # uint8[n_seg] (kernel M)
    slots: np.ndarray | None    # vrle: RLE slots per segment (kernel N)
    seg_woff: np.ndarray   # int32[n_seg]: -(2 + off), -1, 0 or side row
    cont_idx: np.ndarray   # int32[m]: the continued segments
    cwords: np.ndarray     # int64[m]: their continuation words
    offs: np.ndarray       # int64[m + 1]: their offsets, the end last
    ngr: int               # granule rows a continuation window reads
    has_rle: bool

    @property
    def cont_total(self) -> int:
        """Words of the flat continuation store, ngr guard granules
        included."""
        return int(self.offs[-1]) + self.ngr * VRLE_CONT_G


def row_plan(tier: str, bwt: torch.Tensor, hist: torch.Tensor,
             alpha_map: torch.Tensor) -> RowPlan:
    """The host plan of a "vseg" or "vrle" build from kernel A''s BWT and
    histogram -- femto_tpu's width choice (_build_vseg) and vrle_plan
    (_build_vrle).  Kernel M makes the symbol lists and, on vrle, kernel N
    the slot counts; only those counts cross to the host."""
    n_seg, seg = bwt.shape
    wide = hist.shape[1] > 256
    w_side, Wside = vseg_width_for(seg, 9 if wide else 8)
    smax = VSEG_SMAX if tier == "vseg" else VRLE_SMAX
    syms, nsym = seg_syms(hist, smax)
    nsym_np = nsym.cpu().numpy().astype(np.int32)
    woff = np.zeros(n_seg, np.int32)
    C_words, slots_np, ngr, has_rle = 0, None, 1, False
    cont_idx = np.zeros(0, np.int32)
    cwords = np.zeros(0, np.int64)
    offs = np.zeros(1, np.int64)
    if tier == "vseg":
        best = None
        for w_eff, Wm in vseg_width_candidates(seg):
            cov = (nsym_np <= (1 << w_eff)) & (nsym_np < 255)
            nbytes = n_seg * Wm * 4 + int((~cov).sum()) * Wside * 4
            if best is None or nbytes < best[0]:
                best = (nbytes, w_eff, cov)
        _, w_main, cov = best
        s_store = vseg_sym_store(w_main, wide)
        code_words = -(-seg // (32 // w_main))
    else:
        slots_np = vrle_slot_count(bwt, alpha_map, syms, nsym).cpu().numpy()
        (w_main, code_words, C_words, s_store, rle_np, cont_np,
         wfit_np) = vrle_plan(nsym_np, slots_np, seg=seg, n_seg=n_seg,
                              wide=wide, Wside=Wside)
        cov = rle_np | cont_np | wfit_np
        cont_idx = np.nonzero(cont_np)[0].astype(np.int32)
        woff[rle_np] = -1
        has_rle = bool((rle_np | cont_np).any())
        if len(cont_idx):
            w_slot_np, _ = vrle_slot_geom_np(nsym_np)
            bits_np = slots_np.astype(np.int64) * w_slot_np
            cwords = (-(-bits_np[cont_idx] // 32) - code_words)
            G = VRLE_CONT_G
            offs = np.zeros(len(cont_idx) + 1, np.int64)
            np.cumsum((-(-cwords // G)) * G, out=offs[1:])
            ngr = max(1, -(-C_words // G))
            woff[cont_idx] = -(2 + offs[:-1].astype(np.int32))
    woff[~cov] = np.arange(1, int((~cov).sum()) + 1, dtype=np.int32)
    return RowPlan(tier=tier, w_main=w_main, code_words=code_words,
                   C_words=C_words, s_store=s_store, smax=smax,
                   w_side=w_side, wide=wide, syms=syms, nsym=nsym,
                   slots=slots_np, seg_woff=woff, cont_idx=cont_idx,
                   cwords=cwords, offs=offs, ngr=ngr, has_rle=has_rle)


def build_row_tier(plan: RowPlan, bwt: torch.Tensor, alpha_map: torch.Tensor,
                   occ_rel: torch.Tensor, mark_bits: torch.Tensor,
                   mark_ckpt: torch.Tensor):
    """(serving rows, the row-tier fields) of a "vseg" or "vrle" index
    from kernel A' (bwt, the relative checkpoints), kernel B (the marks)
    and the build's row_plan -- femto_tpu's _build_vseg and _build_vrle:
    kernel N packs the run-length slots and the continuation store, kernel
    M the rows and the side table."""
    dev = bwt.device
    syms, nsym = plan.syms, plan.nsym
    seg_woff = _host_i32(plan.seg_woff, dev)
    extra = {}
    rle = None
    if plan.tier == "vrle":
        if plan.has_rle:
            rle = vrle_pack(bwt, alpha_map, syms, nsym, seg_woff,
                            words=plan.code_words + plan.C_words)
        m = len(plan.cont_idx)
        if m:
            flat = cont_flatten(
                rle, _host_i32(plan.cont_idx, dev),
                _host_i32(plan.cwords, dev), _host_i32(plan.offs[:-1], dev),
                first=plan.code_words, total=plan.cont_total)
            extra["seg_cont"] = flat.view(-1, VRLE_CONT_G)
        else:
            extra["seg_cont"] = torch.zeros(
                (1, 1), dtype=torch.int32, device=dev).view(torch.uint32)
        scheme = (3 + plan.ngr if m else 3) if plan.has_rle else 1
        extra["seg_rle"] = torch.zeros((scheme, plan.w_main),
                                       dtype=torch.int32, device=dev)
    rows = vseg_rows(bwt, alpha_map, syms, nsym, seg_woff, mark_bits,
                     mark_ckpt, occ_rel, w_main=plan.w_main,
                     code_words=plan.code_words, s_store=plan.s_store,
                     wide=plan.wide, rle=rle)
    del rle
    seg_ovf, _ = _side_table(bwt, alpha_map, plan.seg_woff <= 0,
                             plan.w_side)
    extra.update(seg_ovf=seg_ovf, seg_nsym=nsym, seg_woff=seg_woff,
                 seg_syms=_sym_marker(plan.s_store, plan.wide, dev))
    return rows, extra


def build_fm_arrays_device(text: torch.Tensor, sa: torch.Tensor,
                           doc_starts: torch.Tensor, *, n: int, seg: int,
                           mark_period: int, ndocs: int, tier: str = "full",
                           pull: torch.Tensor | None = None,
                           alpha: np.ndarray | None = None
                           ) -> Tuple[FMArrays, torch.Tensor, int]:
    """Assemble FMArrays of tier "full", "compact", "packed", "vseg" or
    "vrle" on the tensors' device.  Returns (arrays, n_marks scalar
    tensor, alpha_used: K on the remapped tiers, else 0).

    pull: the BWT + aux words suffix_array pulled from build_sa_payload's
    payload (int64[n]); gathered here through sa when not given.  alpha:
    the symbols in the text, ascending, as suffix.text_alphabet gives them
    (the remapped tiers' dense alphabet); found here by that one histogram
    of the text on its device when not given (a host np.bincount of the
    text, femto_tpu's way, made a 256 MiB build on the H100's host take
    1.71 s instead of 0.25 s, PERF.md)."""
    if tier not in ("full", "compact", "packed", "vseg", "vrle"):
        raise ValueError(f"unknown tier {tier!r}")
    row_tier = tier in ("vseg", "vrle")
    if pull is None:
        pull = gather_rows(
            build_sa_payload(text, doc_starts, n=n, mark_period=mark_period,
                             ndocs=ndocs), sa)
    dev = text.device
    n_seg = n // seg + 1
    ident = torch.arange(ALPHA_SIZE, dtype=torch.int32, device=dev)
    alpha_map, alpha_rev, alpha_used = ident, ident.clone(), 0
    if tier == "full":
        bwt, a_row, occ_ckpt, C = occ_build(pull, n_seg=n_seg, seg=seg)
        occ_l1 = torch.zeros((1, ALPHA_SIZE), dtype=torch.int32, device=dev)
    else:
        # compact tiers: uint16 relative checkpoints need whole L1 groups
        grp = l1_group_for(seg)
        n_seg = -(-n_seg // grp) * grp
        if tier != "compact":
            used = np.asarray(text_alphabet(text) if alpha is None else alpha,
                              dtype=np.int32)
            if used.size and used.max() >= ALPHA_SIZE:
                raise ValueError("symbols must lie in [0, 261)")
            alpha_used = len(used)
            amap = np.full(ALPHA_SIZE, -1, np.int32)
            amap[used] = np.arange(alpha_used, dtype=np.int32)
            alpha_map = torch.from_numpy(amap).to(dev)
            alpha_rev = torch.from_numpy(used).to(dev)
        bwt, a_row, occ_ckpt, occ_l1, C, *hist = occ_build_compact(
            pull, alpha_map, alpha_rev, n_seg=n_seg, seg=seg,
            want_hist=row_tier)
        if tier == "packed":
            per_word, bits = pack_widths(alpha_used)
            bwt = pack_build(bwt, alpha_map, per_word=per_word, bits=bits)
    mark_bits, mark_ckpt, mark_vals, mark_meta, n_marks, doc_seof_rows = \
        marks_build(sa, a_row, n_seg=n_seg, seg=seg, mark_period=mark_period,
                    ndocs=ndocs)
    del a_row
    extra = {}
    if row_tier:
        # kernel M (and N on vrle) after B: the rows carry the marks and
        # checkpoints, which stay behind as one-row dummies
        plan = row_plan(tier, bwt, hist[0], alpha_map)
        del hist
        bwt, extra = build_row_tier(plan, bwt, alpha_map, occ_ckpt,
                                    mark_bits, mark_ckpt)
        del plan
        occ_ckpt = occ_ckpt[:1].clone()
        mark_bits = mark_bits[:1].clone()
        mark_ckpt = mark_ckpt[:1].clone()
    arrays = FMArrays(
        bwt=bwt, occ_ckpt=occ_ckpt, occ_l1=occ_l1, C=C, mark_bits=mark_bits,
        mark_ckpt=mark_ckpt, mark_vals=mark_vals, doc_starts=doc_starts,
        doc_seof_rows=doc_seof_rows, alpha_map=alpha_map,
        alpha_rev=alpha_rev, mark_meta=mark_meta, **extra,
    )
    return arrays, n_marks, alpha_used


# ---------------------------------------------------------------------------
# Kernel P: per-segment document lists (K14)
# ---------------------------------------------------------------------------


def doc_lists_plain(sa: torch.Tensor, doc_starts: torch.Tensor, *,
                    n_real: int, n_seg: int, seg: int):
    n_rows = sa.shape[0]
    v = sa.long()
    doc = torch.searchsorted(doc_starts.long(), v, right=True) - 1
    big = torch.iinfo(torch.int32).max
    doc = torch.where((v >= 0) & (v < n_real), doc, big)
    d = torch.full((n_seg * seg,), big, dtype=torch.int64, device=sa.device)
    d[:n_rows] = doc
    d2 = torch.sort(d.reshape(n_seg, seg), dim=1)[0]
    uniq = torch.ones_like(d2, dtype=torch.bool)
    uniq[:, 1:] = d2[:, 1:] != d2[:, :-1]
    uniq &= d2 != big
    counts = uniq.sum(dim=1).to(torch.int32)
    # left-compacted: the unique ids move to the front of their row
    order = torch.sort((~uniq).to(torch.uint8), dim=1, stable=True)[1]
    vals = torch.gather(d2, 1, order)
    j = torch.arange(seg, device=sa.device)[None, :]
    vals = torch.where(j < counts[:, None].long(), vals, -1)
    return vals.to(torch.int32), counts


def doc_lists(sa: torch.Tensor, doc_starts: torch.Tensor, *, n_real: int,
              n_seg: int, seg: int):
    """(vals int32[n_seg, seg], counts int32[n_seg]): row s of vals holds
    the sorted unique documents of the rows [s*seg, (s+1)*seg), then -1;
    counts[s] is their number.  Row r's document is the last doc_starts
    entry <= sa[r]; rows with sa[r] >= n_real (the pad rows of a
    shape-padded build) and rows past sa's length hold none.  sa int32
    [n_rows], doc_starts int32[ndocs + 1] (a padded build's extra entries
    equal n_real).  Kernel P on the card (csrc/doc_lists.cu); there vals
    may be a view of wider rows (segments above 8192 rows sort in global
    memory)."""
    kernels.check(sa, "sa", torch.int32, 1)
    kernels.check(doc_starts, "doc_starts", torch.int32, 1)
    if seg <= 0 or seg % 32 or n_seg * seg < sa.shape[0]:
        raise ValueError("need seg a positive multiple of 32 and n_seg * "
                         "seg >= len(sa)")
    if not kernels.on_card(sa, doc_starts):
        return doc_lists_plain(sa, doc_starts, n_real=n_real, n_seg=n_seg,
                               seg=seg)
    dev = sa.device
    stride = kernels.size("doc_lists_stride", seg)
    vals = torch.empty((n_seg, stride), dtype=torch.int32, device=dev)
    counts = torch.empty(n_seg, dtype=torch.int32, device=dev)
    kernels.launch("doc_lists", sa.data_ptr(), sa.shape[0], n_real,
                   doc_starts.data_ptr(), doc_starts.shape[0], seg, n_seg,
                   vals.data_ptr(), stride, counts.data_ptr())
    return vals[:, :seg], counts


def flatten_ragged_plain(vals: torch.Tensor, counts: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    j = torch.arange(vals.shape[1], device=vals.device)[None, :]
    return vals[j < counts[:, None].long()]


def flatten_ragged(vals: torch.Tensor, counts: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """int32[offsets[-1]]: the first counts[s] entries of each row of vals
    (int32[n_seg, W], rows may be strided), row after row, row s at
    offsets[s] (int64[n_seg + 1], the running sum of counts).  Kernel P on
    the card."""
    n_seg = vals.shape[0]
    if vals.dtype != torch.int32 or vals.dim() != 2 or vals.stride(1) != 1:
        raise ValueError("vals must be int32[n_seg, W] with unit column "
                         "stride")
    kernels.check(counts, "counts", torch.int32, 1, (n_seg,))
    kernels.check(offsets, "offsets", torch.int64, 1, (n_seg + 1,))
    if not kernels.on_card(vals, counts, offsets):
        return flatten_ragged_plain(vals, counts, offsets)
    total = int(offsets[-1].item())
    docs = torch.empty(total, dtype=torch.int32, device=vals.device)
    if n_seg and total:
        kernels.launch("flatten_ragged", vals.data_ptr(), vals.stride(0),
                       counts.data_ptr(), offsets.data_ptr(), n_seg,
                       docs.data_ptr())
    return docs


def build_doc_lists_device(sa: torch.Tensor, doc_starts: torch.Tensor, *,
                           n: int, n_seg: int, seg: int):
    """(offsets int64[n_seg+1], docs int32[total]) host arrays: the
    segment lists of doc_lists, their counts summed on the host (as
    femto_tpu's build_doc_lists_device does) and flattened by
    flatten_ragged on the device; only the counts and the flat lists cross
    to the host.  n is the real text length: pad rows drop out."""
    vals, counts = doc_lists(sa, doc_starts, n_real=n, n_seg=n_seg, seg=seg)
    offsets = np.zeros(n_seg + 1, np.int64)
    np.cumsum(counts.cpu().numpy().astype(np.int64), out=offsets[1:])
    flat = flatten_ragged(vals, counts,
                          torch.from_numpy(offsets).to(sa.device))
    return offsets, flat.cpu().numpy()


# ---------------------------------------------------------------------------
# Kernel Q: the uint8 text upload's expansion
# ---------------------------------------------------------------------------


def expand_u8_plain(u8: torch.Tensor, n_real: int, seof_pos: torch.Tensor,
                    soh_pos: torch.Tensor, eoh_pos: torch.Tensor
                    ) -> torch.Tensor:
    n = u8.shape[0]
    t = u8.to(torch.int32) + CHARACTER_OFFSET
    t[n_real:] = 0
    for pos, code in ((seof_pos, SEOF), (soh_pos, SOH), (eoh_pos, EOH)):
        p = pos.long()
        t[p[(p >= 0) & (p < n)]] = code
    return t


def expand_u8(u8: torch.Tensor, n_real: int, seof_pos: torch.Tensor,
              soh_pos: torch.Tensor, eoh_pos: torch.Tensor) -> torch.Tensor:
    """int32[n] alphabet codes from raw content bytes (femto_tpu.fmindex.
    _expand_u8): u8 + CHARACTER_OFFSET below n_real, the pad symbol 0 from
    there, then SEOF, SOH and EOH at their positions (int32 arrays; the
    ones outside [0, n), such as the INT32_MAX pads of _escape_positions,
    are dropped).  u8 uint8[n].  Kernel Q on the card
    (csrc/text_expand.cu)."""
    kernels.check(u8, "u8", torch.uint8, 1)
    n = u8.shape[0]
    if not 0 <= n_real <= n:
        raise ValueError("need 0 <= n_real <= len(u8)")
    pos = (seof_pos, soh_pos, eoh_pos)
    for name, p in zip(("seof_pos", "soh_pos", "eoh_pos"), pos):
        kernels.check(p, name, torch.int32, 1)
    if not kernels.on_card(u8, *pos):
        return expand_u8_plain(u8, n_real, *pos)
    out = torch.empty(n, dtype=torch.int32, device=u8.device)
    kernels.launch("expand_u8", u8.data_ptr(), n, n_real, CHARACTER_OFFSET,
                   seof_pos.data_ptr(), seof_pos.shape[0], SEOF,
                   soh_pos.data_ptr(), soh_pos.shape[0], SOH,
                   eoh_pos.data_ptr(), eoh_pos.shape[0], EOH,
                   out.data_ptr())
    return out
