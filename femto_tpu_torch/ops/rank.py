"""Rank (occ) and LF steps over the full tier, in plain PyTorch.

The counterpart of femto_tpu/ops/rank.py for the full tier only: batched
tensor versions of the same functions, which the plain versions of the
search kernels (ops/search_ops.py) are built from.  They run on either
device; the CUDA kernels replace them on the card.

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


def seg_size(arrays: FMArrays) -> int:
    """Rows per segment (from the mark bitmap's shape)."""
    return arrays.mark_bits.shape[1] * 32


def n_segments(arrays: FMArrays) -> int:
    return arrays.occ_ckpt.shape[0]


def map_char(c: torch.Tensor) -> torch.Tensor:
    """Alphabet code -> itself, or -1 outside the alphabet (counts
    nothing): the full tier's identity map."""
    return torch.where((c >= 0) & (c < ALPHA_SIZE), c, -1)


def gather_segments(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    """int32[B, seg] symbol rows of segments s."""
    return u16_to_i32(arrays.bwt.view(torch.int16)[s.long()])


def bwt_code_at(arrays: FMArrays, r: torch.Tensor) -> torch.Tensor:
    """BWT symbol at each row (int32[B])."""
    seg = seg_size(arrays)
    s = r // seg
    return u16_to_i32(
        arrays.bwt.view(torch.int16)[s.long(), (r - s * seg).long()])


def ckpt_base(arrays: FMArrays, s: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Occurrences of c before segment s (int32 absolute checkpoints)."""
    return arrays.occ_ckpt[s.long(), c.long()]


def _within(segdata: torch.Tensor, c: torch.Tensor,
            off: torch.Tensor) -> torch.Tensor:
    """Occurrences of c[b] among the first off[b] symbols of segdata[b]."""
    iota = torch.arange(segdata.shape[1], device=segdata.device)
    hit = (segdata == c[:, None]) & (iota[None, :] < off[:, None])
    return hit.sum(dim=1).to(torch.int32)


def _occ_dense(arrays: FMArrays, cd: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """occ for codes cd (cd < 0 counts nothing) before rows r."""
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
    chars outside the alphabet give the empty range (0, 0)."""
    cd = map_char(c.to(torch.int32))
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
