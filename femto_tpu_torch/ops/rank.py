"""Rank (occ), LF and psi steps over every row layout, in plain PyTorch.

The counterpart of femto_tpu/ops/rank.py: batched tensor versions of the
same functions, which the plain versions of the search kernels
(ops/search_ops.py) are built from.  They run on either device; the CUDA
kernels replace them on the card.  The layout is read from dtypes and
shapes, as femto_tpu's static dispatch does: a seg_nsym field means a row
tier (vseg, or vrle when seg_rle is set too), a uint32 bwt otherwise is
packed, a uint16 occ_ckpt is relative to occ_l1, and a C other than
int32[262] (or a packed or row-tier bwt) means a dense, remapped alphabet.

The row tiers keep one uint32 row per segment: [code area | symbol list |
mark words | mark checkpoint | uint16-relative checkpoints] (VsegGeom).
The code area holds per-segment LOCAL codes (ranks in the segment's
sorted symbol list) at one width w_main, or, on vrle, run-length slots
that may continue into a flat store (seg_cont); segments that fit
neither live in a side table of global codes (seg_ovf).

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
    """Segment count: the row tiers keep their checkpoints inside the
    serving rows, and occ_ckpt is a one-row dtype marker there.  Paged
    serving: bwt is a row cache, and seg_slot holds the true count."""
    if arrays.seg_slot is not None:
        return arrays.seg_slot.shape[0]
    if is_row_tier(arrays):
        return arrays.bwt.shape[0]
    return arrays.occ_ckpt.shape[0]


def is_row_tier(arrays: FMArrays) -> bool:
    """One-row serving layout (vseg or vrle)."""
    return arrays.seg_nsym is not None


def is_vrle(arrays: FMArrays) -> bool:
    """Run-length coded row tier: seg_rle is its [scheme, w_main] marker."""
    return arrays.seg_rle is not None


def is_vseg(arrays: FMArrays) -> bool:
    return is_row_tier(arrays) and not is_vrle(arrays)


def is_packed(arrays: FMArrays) -> bool:
    return arrays.bwt.dtype == torch.uint32 and not is_row_tier(arrays)


def is_remapped(arrays: FMArrays) -> bool:
    return (arrays.C.shape[0] != ALPHA_SIZE + 1 or is_packed(arrays)
            or is_row_tier(arrays))


def layout(arrays: FMArrays) -> str:
    """"full", "compact", "packed", "vseg" or "vrle" (kernels.LAYOUTS),
    from dtypes and the fields present."""
    if is_row_tier(arrays):
        return "vrle" if is_vrle(arrays) else "vseg"
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


# ---------------------------------------------------------------------------
# Row tiers (femto_tpu/ops/rank.py:140-646)
# ---------------------------------------------------------------------------


class VsegGeom:
    """Static layout of a row-tier main row, all derived from array shapes
    (femto_tpu's _VsegGeom): [code area W | symbol list Wsym | mark words
    seg/32 | mark checkpoint 1 | uint16-relative checkpoints ceil(K/2)].

    vseg: the code area is the fixed-width row (Wmode == W, w_main
    re-derived from W).  vrle: the code area is A = W words holding RLE
    slots or fixed w_main-bit codes (w_main from the seg_rle marker's
    shape; Wmode the words of the fixed-width part).  seg_syms is a
    [1, S] marker whose dtype says u8 or u16 symbol lists (wide = K > 256);
    the side rows' width is 8 when there is no side row."""

    def __init__(self, arrays: FMArrays):
        self.seg = seg = seg_size(arrays)
        self.S = arrays.seg_syms.shape[1]
        self.wide = arrays.seg_syms.dtype == torch.uint16
        self.per_sym = 2 if self.wide else 4
        self.Wsym = self.S // self.per_sym
        self.Wmk = seg // 32
        Wrel = -(-alpha_count(arrays) // 2)
        self.total = arrays.bwt.shape[1]
        self.W = self.total - self.Wsym - self.Wmk - 1 - Wrel
        if arrays.seg_rle is not None:
            self.w_main = arrays.seg_rle.shape[1]
            self.Wmode = -(-seg // (32 // self.w_main))
        else:
            self.w_main = 32 // (-(-seg // self.W))
            self.Wmode = self.W
        self.off_syms = self.W
        self.off_mk = self.W + self.Wsym
        self.off_mck = self.off_mk + self.Wmk
        self.off_rel = self.off_mck + 1
        self.n_side = arrays.seg_ovf.shape[0]
        self.Ws = arrays.seg_ovf.shape[1]
        self.w_side = (32 // (-(-seg // self.Ws)) if self.n_side > 1 else 8)


def vrle_has_rle(arrays: FMArrays) -> bool:
    """Does this vrle index hold RLE rows (the marker's leading dim: 1 =
    none, 3 = sub-byte slots, 3 + ngr = sub-byte slots and a flat
    continuation store fetched as ngr granule rows)?"""
    return arrays.seg_rle is not None and arrays.seg_rle.shape[0] > 1


def vrle_flat_cont(arrays: FMArrays) -> bool:
    """Do continuations live in the flat granule store (marker dim >= 4)?"""
    return arrays.seg_rle is not None and arrays.seg_rle.shape[0] >= 4


def _rows(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    """int64[B, total] main rows of segments s (uint32 bits widened); on a
    paged index through seg_slot (femto_tpu's _bwt_row): PagedIndex maps
    every segment a step needs, an unmapped one reads dummy slot 0."""
    s = s.long()
    if arrays.seg_slot is not None:
        s = arrays.seg_slot[s].long()
    return u32_to_i64(arrays.bwt.view(torch.int32)[s])


def vseg_syms_from_row(g: VsegGeom, row: torch.Tensor) -> torch.Tensor:
    """int32[B, S] sorted symbol list unpacked from the rows (pads are the
    dtype's max, never below a real code)."""
    k = torch.arange(g.S, device=row.device)
    unit = 32 // g.per_sym
    words = row[:, g.off_syms + k // g.per_sym]
    mask = 0xFFFF if g.wide else 0xFF
    return ((words >> ((k % g.per_sym) * unit)) & mask).to(torch.int32)


def vseg_base_from_row(arrays: FMArrays, g: VsegGeom, row: torch.Tensor,
                       s: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Occurrences of dense code c before segment s: the row's relative
    checkpoint plus its group's L1 row."""
    c = c.long()
    word = row.gather(1, (g.off_rel + c // 2)[:, None])[:, 0]
    rel = (word >> ((c & 1) * 16)) & 0xFFFF
    return (arrays.occ_l1[s.long() // l1_grp(arrays), c] + rel).to(
        torch.int32)


def vseg_marks_from_row(g: VsegGeom, row: torch.Tensor, r: torch.Tensor):
    """(is_marked bool[B], mark rank int32[B]) of rows r from their
    segments' rows: the mark words and the mark checkpoint."""
    r = r.long()
    words = row[:, g.off_mk: g.off_mk + g.Wmk]
    w_local = (r % g.seg) // 32
    word = words.gather(1, w_local[:, None])[:, 0]
    bit = ((word >> (r % 32)) & 1) != 0
    widx = torch.arange(g.Wmk, device=row.device)
    full = torch.where(widx[None, :] < w_local[:, None], words, 0)
    cnt = popcount32(full).sum(dim=1)
    part = popcount32(word & ((1 << (r % 32)) - 1))
    mck = row[:, g.off_mck]
    return bit, (mck + cnt + part).to(torch.int32)


def decode_static(words: torch.Tensor, w: int, seg: int) -> torch.Tensor:
    """int64[B, W] words of w-bit fields -> int32[B, seg] codes (K13's
    fixed-width decode, femto_tpu's _decode_static)."""
    per_word = 32 // w
    pos = torch.arange(seg, device=words.device)
    word = words[:, pos // per_word]
    return ((word >> ((pos % per_word) * w)) & ((1 << w) - 1)).to(
        torch.int32)


def swar_lsbs(w: int) -> int:
    """Bit 0 of every w-bit field of a 32-bit word."""
    return sum(1 << (f * w) for f in range(32 // w))


def count_eq_packed(words: torch.Tensor, w: int, lq: torch.Tensor,
                    off: torch.Tensor) -> torch.Tensor:
    """SWAR rank: fields equal to lq among the first `off` w-bit fields of
    each lane's words (femto_tpu's _count_eq_packed); lq outside
    [0, 2^w) counts nothing."""
    per = 32 // w
    L = swar_lsbs(w)
    lq, off = lq.long(), off.long()
    valid = (lq >= 0) & (lq < (1 << w))
    z = words ^ (torch.where(valid, lq, 0)[:, None] * L)
    total, step = 0, 1
    while total < w - 1:
        k = min(step, w - 1 - total)
        z = z | (z >> k)
        total += k
        step *= 2
    eqbits = ~z & L
    wi = torch.arange(words.shape[1], device=words.device)[None, :]
    opw = (off // per)[:, None]
    partial = L & ((1 << ((off % per) * w)) - 1)
    mask = torch.where(wi < opw, L, torch.where(wi == opw, partial[:, None],
                                                0))
    cnt = popcount32(eqbits & mask).sum(dim=1)
    return torch.where(valid, cnt, 0).to(torch.int32)


def field_at(words: torch.Tensor, w: int, off: torch.Tensor) -> torch.Tensor:
    """int32[B]: the w-bit field at position off of each lane's words."""
    per = 32 // w
    off = off.long()
    wi = torch.clamp(off // per, max=words.shape[1] - 1)
    word = words.gather(1, wi[:, None])[:, 0]
    return ((word >> ((off % per) * w)) & ((1 << w) - 1)).to(torch.int32)


VRLE_SLOT_WIDTHS = (6, 8, 10)


def vrle_slot_geom(nsym: torch.Tensor):
    """(w_slot, lenbits) per segment from its symbol count: symbol width
    ws = ceil(log2(max(nsym, 2))) capped at 6, slots of 6/8/10 bits."""
    n = nsym.long()
    ws = (1 + (n > 2).long() + (n > 4).long() + (n > 8).long()
          + (n > 16).long() + (n > 32).long())
    w_slot = 6 + 2 * ((ws > 2).long() + (ws > 4).long())
    return w_slot, w_slot - ws


def bit_slot_stream(words: torch.Tensor, w: int, NS: int) -> torch.Tensor:
    """int64[B, Wtot] words -> int64[B, NS] w-bit little-endian fields
    (slot k = bits [k*w, k*w + w), straddling words); fields past the
    words' capacity are zero."""
    Wtot = words.shape[1]
    k = torch.arange(min(NS, (Wtot * 32) // w), device=words.device)
    wi = (k * w) >> 5
    sh = (k * w) & 31
    wi2 = torch.clamp(wi + 1, max=Wtot - 1)
    lo = words[:, wi] >> sh
    hi = torch.where(sh == 0, 0, (words[:, wi2] << ((32 - sh) & 31)) & _U32)
    out = (lo | hi) & ((1 << w) - 1)
    if out.shape[1] < NS:
        out = torch.cat([out, out.new_zeros(out.shape[0], NS - out.shape[1])],
                        dim=1)
    return out


def vrle_slots_from_row(arrays: FMArrays, g: VsegGeom, row: torch.Tensor,
                        s: torch.Tensor):
    """(lsym, slen, starts) int64[B, NS]: the slot view of RLE-mode rows.
    The code area's words and, on a flat continuation store, ngr granule
    rows from the segment's offset (rows clamped to the store) form one
    slot stream; lanes without a continuation read offset 0, and every
    slot past a true stream starts at >= seg (each stream's lengths sum
    to exactly seg), so it counts nothing."""
    words = row[:, :g.W]
    woff = arrays.seg_woff[s.long()].long()
    if vrle_flat_cont(arrays):
        G = arrays.seg_cont.shape[1]
        ngr = arrays.seg_rle.shape[0] - 3
        X = arrays.seg_cont.shape[0]
        g0 = torch.clamp(-woff - 2, min=0) // G
        gidx = torch.clamp(g0[:, None] + torch.arange(ngr, device=row.device),
                           max=X - 1)
        cw = u32_to_i64(arrays.seg_cont.view(torch.int32)[gidx])
        words = torch.cat([words, cw.reshape(cw.shape[0], ngr * G)], dim=1)
    w_slot, lenbits = vrle_slot_geom(
        arrays.seg_nsym.view(torch.uint8)[s.long()])
    NS = (words.shape[1] * 32) // min(VRLE_SLOT_WIDTHS)
    slots = words.new_zeros((words.shape[0], NS))
    for w in VRLE_SLOT_WIDTHS:  # each lane's stream at its own width only
        sel = torch.nonzero(w_slot == w)[:, 0]
        if sel.numel():
            slots[sel] = bit_slot_stream(words[sel], w, NS)
    lb = lenbits[:, None]
    lsym = slots >> lb
    slen = slots & ((1 << lb) - 1)
    starts = torch.cumsum(slen, dim=1) - slen
    return lsym, slen, starts


def vrle_within(sv, lq: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Occurrences of local code lq among the first `off` positions: a
    clamp-sum over the slots."""
    lsym, slen, starts = sv
    contrib = torch.minimum(torch.clamp(off.long()[:, None] - starts, min=0),
                            slen)
    return torch.where(lsym == lq.long()[:, None], contrib, 0).sum(
        dim=1).to(torch.int32)


def vrle_code_at(sv, off: torch.Tensor) -> torch.Tensor:
    """Local code at offset `off` (0 past the stream)."""
    lsym, slen, starts = sv
    o = off.long()[:, None]
    hit = (starts <= o) & (o < starts + slen)
    return torch.where(hit, lsym, 0).sum(dim=1).to(torch.int32)


def vrle_grid_from_row(arrays: FMArrays, g: VsegGeom, row: torch.Tensor,
                       s: torch.Tensor) -> torch.Tensor:
    """RLE-mode rows decoded to int32[B, seg] LOCAL codes (K13, cold
    path): each slot's symbol scattered at its start and filled forward
    (cummax of start << 8 | sym + 1)."""
    seg = g.seg
    lsym, slen, starts = vrle_slots_from_row(arrays, g, row, s)
    tgt = torch.where(slen > 0, torch.clamp(starts, max=seg), seg)
    pk = (starts << 8) | (lsym + 1)
    z = torch.zeros((row.shape[0], seg + 1), dtype=torch.int64,
                    device=row.device)
    z.scatter_(1, tgt, pk)
    filled = torch.cummax(z[:, :seg], dim=1).values
    return (torch.clamp(filled & 0xFF, min=1) - 1).to(torch.int32)


def vseg_local_grid(arrays: FMArrays, s: torch.Tensor):
    """(codes int32[B, seg] in per-lane space -- local codes, global ones
    on side lanes --, is_side bool[B], rows): K13's cold decode."""
    g = VsegGeom(arrays)
    row = _rows(arrays, s)
    grid = decode_static(row[:, :g.Wmode], g.w_main, g.seg)
    woff = arrays.seg_woff[s.long()]
    if vrle_has_rle(arrays):
        grid = torch.where((woff < 0)[:, None],
                           vrle_grid_from_row(arrays, g, row, s), grid)
    is_side = woff > 0
    if g.n_side > 1:
        side = u32_to_i64(arrays.seg_ovf.view(torch.int32)[
            torch.clamp(woff, 0, g.n_side - 1).long()])
        grid = torch.where(is_side[:, None],
                           decode_static(side, g.w_side, g.seg), grid)
    return grid, is_side, row


def gather_segments_vseg(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    """int32[B, seg] GLOBAL dense codes of row-tier segments: the local
    grid mapped through each segment's symbol list."""
    grid, is_side, row = vseg_local_grid(arrays, s)
    g = VsegGeom(arrays)
    syms = vseg_syms_from_row(g, row)
    mapped = syms.gather(1, torch.clamp(grid, 0, g.S - 1).long())
    return torch.where(is_side[:, None], grid, mapped)


class RowCtx:
    """Per-lane decode context of the row tiers (femto_tpu's _row_ctx):
    the main rows, the side rows (row 0, all zeros, for main lanes), and
    on a vrle index with RLE rows the slot view and which lanes use it."""

    def __init__(self, arrays: FMArrays, s: torch.Tensor):
        self.g = g = VsegGeom(arrays)
        self.row = _rows(arrays, s)
        woff = arrays.seg_woff[s.long()]
        self.is_side = woff > 0
        self.side_row = None
        if g.n_side > 1:
            self.side_row = u32_to_i64(arrays.seg_ovf.view(torch.int32)[
                torch.clamp(woff, 0, g.n_side - 1).long()])
        self.mode_rle = None
        self.sv = None
        if vrle_has_rle(arrays):
            self.mode_rle = woff < 0
            self.sv = vrle_slots_from_row(arrays, g, self.row, s)

    def within(self, lq: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
        """Occurrences of per-lane code lq in the first `off` rows of each
        lane's segment."""
        g = self.g
        w = count_eq_packed(self.row[:, :g.Wmode], g.w_main, lq, off)
        if self.side_row is not None:
            w = torch.where(self.is_side,
                            count_eq_packed(self.side_row, g.w_side, lq, off),
                            w)
        if self.sv is not None:
            w = torch.where(self.mode_rle, vrle_within(self.sv, lq, off), w)
        return w

    def code_at(self, off: torch.Tensor) -> torch.Tensor:
        """Per-lane code at in-segment offset `off` (local on main lanes,
        global on side lanes)."""
        g = self.g
        lc = field_at(self.row[:, :g.Wmode], g.w_main, off)
        if self.side_row is not None:
            lc = torch.where(self.is_side,
                             field_at(self.side_row, g.w_side, off), lc)
        if self.sv is not None:
            lc = torch.where(self.mode_rle, vrle_code_at(self.sv, off), lc)
        return lc

    def global_code(self, lc: torch.Tensor) -> torch.Tensor:
        """Dense code of per-lane code lc (through the symbol list on main
        lanes)."""
        syms = vseg_syms_from_row(self.g, self.row)
        cg = syms.gather(1, torch.clamp(lc, 0, self.g.S - 1).long()[:, None])
        return torch.where(self.is_side, lc, cg[:, 0])

    def query_code(self, cd: torch.Tensor) -> torch.Tensor:
        """Per-lane code of dense code cd: its rank in the segment's symbol
        list, -1 when absent; cd itself on side lanes."""
        syms = vseg_syms_from_row(self.g, self.row)
        ins = (syms < cd[:, None]).sum(dim=1)
        at = syms.gather(1, torch.clamp(ins, max=self.g.S - 1)[:, None])[:, 0]
        return torch.where(self.is_side, cd,
                           torch.where(at == cd, ins, -1)).to(torch.int32)


def gather_segments(arrays: FMArrays, s: torch.Tensor) -> torch.Tensor:
    """int32[B, seg] code rows of segments s (the packed tier's words
    unpacked; its pad slots hold the all-ones code, >= K; row-tier rows
    decoded to global codes, pad rows to an arbitrary present code)."""
    if is_row_tier(arrays):
        return gather_segments_vseg(arrays, s)
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
    if is_row_tier(arrays):
        ctx = RowCtx(arrays, s)
        return ctx.global_code(ctx.code_at(off))
    if not is_packed(arrays):
        return u16_to_i32(arrays.bwt.view(torch.int16)[s, off])
    per_word, bits = pack_geometry(arrays)
    word = u32_to_i64(arrays.bwt.view(torch.int32)[s, off // per_word])
    return ((word >> ((off % per_word) * bits)) & ((1 << bits) - 1)).to(
        torch.int32)


def ckpt_base(arrays: FMArrays, s: torch.Tensor,
              c: torch.Tensor) -> torch.Tensor:
    """Occurrences of dense code c before segment s (int32): the absolute
    checkpoint, or the uint16 relative one plus its group's L1 row (read
    from the segment's own row on the row tiers)."""
    if is_row_tier(arrays):
        return vseg_base_from_row(arrays, VsegGeom(arrays),
                                  _rows(arrays, s), s, c)
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
    if is_row_tier(arrays):
        # local code space: one row serves the base, the symbol list and
        # the count
        ctx = RowCtx(arrays, s)
        base = vseg_base_from_row(arrays, ctx.g, ctx.row, s, cc)
        within = ctx.within(ctx.query_code(cc), off)
    else:
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
    if is_row_tier(arrays):
        return vseg_marks_from_row(VsegGeom(arrays), _rows(arrays, s), r)[1]
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
    if is_row_tier(arrays):
        # one row serves the code, the symbol map, the base, the count and
        # the marks; the count is of the local code itself
        ctx = RowCtx(arrays, s)
        lc = ctx.code_at(off)
        c = ctx.global_code(lc)
        lf = (arrays.C[c.long()]
              + vseg_base_from_row(arrays, ctx.g, ctx.row, s, c)
              + ctx.within(lc, off)).to(torch.int32)
        bit, grank = vseg_marks_from_row(ctx.g, ctx.row, r)
        return lf, bit, grank
    segdata = gather_segments(arrays, s)
    c = segdata[torch.arange(r.shape[0], device=r.device), off.long()]
    lf = (arrays.C[c.long()] + ckpt_base(arrays, s, c)
          + _within(segdata, c, off)).to(torch.int32)
    words = _mark_words(arrays, s)
    word = words[torch.arange(r.shape[0], device=r.device), (off // 32).long()]
    bit = ((word >> (r % 32).long()) & 1) != 0
    return lf, bit, _grank(arrays, s, words, r, off)
