"""Rank (occ), LF and psi steps over the full, compact and packed tiers,
in plain PyTorch.

The counterpart of femto_tpu/ops/rank.py for the row tiers: batched
tensor versions of the same functions, which the plain versions of the
search kernels (ops/search_ops.py) are built from.  They run on either
device; the CUDA kernels replace them on the card.  The layout is read
from dtypes and shapes, as femto_tpu's static dispatch does: a uint32
bwt is packed, a uint16 occ_ckpt is relative to occ_l1, and a C other
than int32[262] (or a packed bwt) means a dense, remapped alphabet.

torch has no uint32 shifts or popcount on the CPU, so bit words are
widened to int64 (:func:`u32_to_i64`) and counted by bit tricks.
"""

from __future__ import annotations

import torch

from ..alphabet import ALPHA_SIZE
from ..fmindex import FMArrays

_U32 = 0xFFFFFFFF


def u16_to_i32(t: torch.Tensor) -> torch.Tensor:
    """uint16 (or int16-viewed) bits -> int32 values.  Unsigned tensors are
    viewed as signed before any indexing or arithmetic: torch implements
    few ops for uint16/uint32, fewest on the card."""
    return t.view(torch.int16).to(torch.int32) & 0xFFFF


def i32_to_u16(t: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 2^16) -> uint16 tensor with the same bits."""
    return torch.where(t >= 2**15, t - 2**16, t).to(torch.int16).view(
        torch.uint16)


def u32_to_i64(t: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32-viewed) bits -> int64 values."""
    return t.view(torch.int32).to(torch.int64) & _U32


def i64_to_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> uint32 tensor with the same bits."""
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32).view(
        torch.uint32)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 value in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _U32) >> 24


# ---------------------------------------------------------------------------
# Layout dispatch (femto_tpu/ops/rank.py:25-119, 182)
# ---------------------------------------------------------------------------


def seg_size(arrays: FMArrays) -> int:
    """Rows per segment (from the always-unpacked mark bitmap)."""
    return arrays.mark_bits.shape[1] * 32


def n_segments(arrays: FMArrays) -> int:
    return arrays.occ_ckpt.shape[0]


def is_packed(arrays: FMArrays) -> bool:
    return arrays.bwt.dtype == torch.uint32


def is_remapped(arrays: FMArrays) -> bool:
    return arrays.C.shape[0] != ALPHA_SIZE + 1 or is_packed(arrays)


def layout(arrays: FMArrays) -> str:
    """"full", "compact" or "packed" (kernels.LAYOUTS), from dtypes."""
    if is_packed(arrays):
        return "packed"
    return "compact" if arrays.occ_ckpt.dtype == torch.uint16 else "full"


def alpha_count(arrays: FMArrays) -> int:
    """Dense alphabet size K (261 for identity tiers)."""
    return arrays.C.shape[0] - 1


def map_char(arrays: FMArrays, c: torch.Tensor) -> torch.Tensor:
    """Alphabet code -> dense code; codes outside the alphabet or absent
    from the index -> -1 (which counts nothing)."""
    ok = (c >= 0) & (c < ALPHA_SIZE)
    if not is_remapped(arrays):
        return torch.where(ok, c, -1)
    return torch.where(ok, arrays.alpha_map[torch.where(ok, c, 0).long()], -1)


def unmap_char(arrays: FMArrays, c: torch.Tensor) -> torch.Tensor:
    """Dense code -> alphabet code."""
    if not is_remapped(arrays):
        return c
    return arrays.alpha_rev[c.long()]


def pack_geometry(arrays: FMArrays):
    """(per_word, bits) of the packed BWT, derived from shapes."""
    per_word = -(-seg_size(arrays) // arrays.bwt.shape[1])
    return per_word, 32 // per_word


def l1_grp(arrays: FMArrays) -> int:
    """Segments per L1 checkpoint group, derived from shapes (the build
    pads n_seg to a multiple of the group, so the division is exact)."""
    return max(1, n_segments(arrays) // arrays.occ_l1.shape[0])


def gather_segments(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    """int32[B, seg] code rows of segments s (the packed tier's words
    unpacked; its pad slots hold the all-ones code, >= K)."""
    if not is_packed(arrays):
        return u16_to_i32(arrays.bwt.view(torch.int16)[s.long()])
    words = u32_to_i64(arrays.bwt.view(torch.int32)[s.long()])    # [B, W]
    per_word, bits = pack_geometry(arrays)
    shifts = torch.arange(per_word, device=words.device) * bits
    vals = (words[:, :, None] >> shifts[None, None, :]) & ((1 << bits) - 1)
    return vals.reshape(words.shape[0], -1)[:, :seg_size(arrays)].to(
        torch.int32)


def bwt_code_at(arrays: FMArrays, r: torch.Tensor) -> torch.Tensor:
    """Dense BWT code at each row (int32[B])."""
    seg = seg_size(arrays)
    s = (r // seg).long()
    off = (r % seg).long()
    if not is_packed(arrays):
        return u16_to_i32(arrays.bwt.view(torch.int16)[s, off])
    per_word, bits = pack_geometry(arrays)
    word = u32_to_i64(arrays.bwt.view(torch.int32)[s, off // per_word])
    return ((word >> ((off % per_word) * bits)) & ((1 << bits) - 1)).to(
        torch.int32)


def ckpt_base(arrays: FMArrays, s: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Occurrences of dense code c before segment s (int32): the absolute
    checkpoint, or the uint16 relative one plus its group's L1 row."""
    s, c = s.long(), c.long()
    if arrays.occ_ckpt.dtype != torch.uint16:
        return arrays.occ_ckpt[s, c]
    rel = u16_to_i32(arrays.occ_ckpt.view(torch.int16)[s, c])
    return arrays.occ_l1[s // l1_grp(arrays), c] + rel


def _within(segdata: torch.Tensor, c: torch.Tensor,
            off: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[b] among the first off[b] codes of segdata[b]."""
    iota = torch.arange(segdata.shape[1], device=segdata.device)
    hit = (segdata == c[:, None]) & (iota[None, :] < off[:, None])
    return hit.sum(dim=1).to(torch.int32)


def _occ_dense(arrays: FMArrays, cd: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """occ for dense codes cd (cd < 0 counts nothing) before rows r."""
    seg = seg_size(arrays)
    n_seg = n_segments(arrays)
    valid = cd >= 0
    cc = torch.where(valid, cd, 0)
    at_end = r >= n_seg * seg
    s = torch.clamp(r // seg, max=n_seg - 1)
    off = r - s * seg
    base = ckpt_base(arrays, s, cc)
    within = _within(gather_segments(arrays, s), cc, off)
    C = arrays.C
    total = C[(cc + 1).long()] - C[cc.long()]
    return torch.where(valid, torch.where(at_end, total, base + within),
                       0).to(torch.int32)


def backward_step_pair(arrays: FMArrays, c: torch.Tensor,
                       first: torch.Tensor, last: torch.Tensor):
    """One FM backward step for alphabet chars c: the new (first, last);
    chars outside the alphabet or absent from it give the empty range
    (0, 0)."""
    cd = map_char(arrays, c.to(torch.int32))
    valid = cd >= 0
    base = arrays.C[torch.where(valid, cd, 0).long()]
    o1 = _occ_dense(arrays, cd, first)
    o2 = _occ_dense(arrays, cd, last)
    z = torch.zeros_like(first)
    return torch.where(valid, base + o1, z), torch.where(valid, base + o2, z)


def lf_step(arrays: FMArrays, r: torch.Tensor) -> torch.Tensor:
    """LF(r) = C[BWT[r]] + occ(BWT[r], r): the row one text position back."""
    cd = bwt_code_at(arrays, r)
    return (arrays.C[cd.long()] + _occ_dense(arrays, cd, r)).to(torch.int32)


def select_char(arrays: FMArrays, c: torch.Tensor,
                k: torch.Tensor) -> torch.Tensor:
    """Row of the (k+1)-th occurrence of dense code c (femto_tpu's
    search_ops._select_char): bisect the segments for the largest s with
    ckpt_base(s, c) <= k, then scan that segment; s*seg + seg when no
    column hits."""
    n_seg = n_segments(arrays)
    seg = seg_size(arrays)
    lo = torch.zeros_like(c)
    hi = torch.full_like(c, n_seg - 1)
    while bool((lo < hi).any()):
        mid = (lo + hi + 1) // 2
        go_right = ckpt_base(arrays, mid, c) <= k
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, mid - 1)
    is_c = gather_segments(arrays, lo) == c[:, None]
    cum = torch.cumsum(is_c.to(torch.int32), dim=1)
    target = (k - ckpt_base(arrays, lo, c) + 1)[:, None]
    iota = torch.arange(seg, device=c.device)
    col = torch.where((cum == target) & is_c, iota, seg).min(dim=1).values
    return (lo * seg + col).to(torch.int32)


def psi_step(arrays: FMArrays, r: torch.Tensor):
    """Forward step (inverse LF): (row of the suffix one position later,
    the row's first symbol in the alphabet) -- femto_tpu's
    search_ops.psi_step.  The symbol is the last c with C[c] <= r."""
    cd = (torch.searchsorted(arrays.C, r, right=True) - 1).to(torch.int32)
    k = r - arrays.C[cd.long()]
    return select_char(arrays, cd, k), unmap_char(arrays, cd)


def _mark_words(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    return u32_to_i64(arrays.mark_bits.view(torch.int32)[s.long()])


def _grank(arrays: FMArrays, s, words, r, off) -> torch.Tensor:
    """mark_ckpt[s] + set bits of the segment's words before row r."""
    w_local = off // 32
    widx = torch.arange(words.shape[1], device=words.device)
    full = torch.where(widx[None, :] < w_local[:, None], words, 0)
    cnt = popcount32(full).sum(dim=1)
    word = words[torch.arange(words.shape[0], device=words.device),
                 w_local.long()]
    part = popcount32(word & ((1 << (r % 32).long()) - 1))
    return (arrays.mark_ckpt[s.long()] + cnt + part).to(torch.int32)


def mark_rank(arrays: FMArrays, r: torch.Tensor) -> torch.Tensor:
    """Marked rows before row r (index into the mark values)."""
    seg = seg_size(arrays)
    s = r // seg
    return _grank(arrays, s, _mark_words(arrays, s), r, r - s * seg)


def mark_offset(arrays: FMArrays, granks: torch.Tensor) -> torch.Tensor:
    """Decode the text offset stored for mark rank g (int32[B]): slot k of
    `bits` bits is k * period on the grid, or, from exc_base up, an index
    into the int32 exception region (build_ops.mark_pack_geom)."""
    bits, exc_base, period, exc_off, cap = arrays.mark_meta.tolist()
    mv = u32_to_i64(arrays.mark_vals)
    g = torch.clamp(granks.long(), 0, cap - 1)
    bp = g * bits
    wi = bp >> 5
    sh = bp & 31
    lo = mv[wi] >> sh
    hi = torch.where(sh == 0, 0, (mv[wi + 1] << (32 - sh)) & _U32)
    k = (lo | hi) & ((1 << bits) - 1)
    eidx = torch.clamp(exc_off + (k - exc_base), 0, mv.shape[0] - 1)
    exc = mv[eidx]
    exc = torch.where(exc >= 2**31, exc - 2**32, exc)
    return torch.where(k >= exc_base, exc, k * period).to(torch.int32)


def lf_grank_step(arrays: FMArrays, r: torch.Tensor):
    """Fused locate step: (LF(r), is r marked, mark rank of r), one
    segment row serving the symbol and its count."""
    seg = seg_size(arrays)
    s = r // seg
    off = r - s * seg
    segdata = gather_segments(arrays, s)
    c = segdata[torch.arange(r.shape[0], device=r.device), off.long()]
    lf = (arrays.C[c.long()] + ckpt_base(arrays, s, c)
          + _within(segdata, c, off)).to(torch.int32)
    words = _mark_words(arrays, s)
    word = words[torch.arange(r.shape[0], device=r.device), (off // 32).long()]
    bit = ((word >> (r % 32).long()) & 1) != 0
    return lf, bit, _grank(arrays, s, words, r, off)
