"""On-device index packaging (full, compact and packed tiers): kernel
wrappers + plain versions.

The counterpart of femto_tpu/ops/build_ops.py for those tiers.  The aux
word and the suffix-sort payload are kernel K (csrc/sa_payload.cu); the
split of the pulled words with the occ histogram and checkpoints is kernel
A (absolute int32 checkpoints) or A' (uint16 relative ones + L1 rows over
the used columns), both in csrc/occ_build.cu; the mark bitmap, checkpoints, doc
SEOF rows and bit-packed mark values are kernel B (csrc/marks_build.cu);
the packed tier's BWT words are kernel F (csrc/pack_build.cu).  Each
wrapper launches its kernel for tensors on the card and takes the plain
PyTorch version beside it for tensors on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..alphabet import ALPHA_SIZE, INVALID_ALPHA
from ..fmindex import FMArrays, l1_group_for
from ..suffix import text_alphabet
from .rank import i32_to_u16, i64_to_u32, u16_to_i32
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
                            n_seg: int, seg: int):
    """(bwt uint16[n_seg, seg], a_row int32[n], occ_ckpt uint16[n_seg, K],
    occ_l1 int32[n_seg/grp, K], C int32[K+1]) over the K used symbols
    alpha_rev (int32[K], ascending; every symbol on the compact tier):
    femto_tpu's _ckpt_stage(compact=True) of the used columns."""
    grp = l1_group_for(seg)
    bwt, a_row, per_seg = _split_hist(pull, n_seg=n_seg, seg=seg)
    occ, C = _checkpoints(per_seg[:, alpha_rev.long()])
    occ_l1 = occ[::grp]
    rel = occ - torch.repeat_interleave(occ_l1, grp, dim=0)
    return (bwt, a_row, i32_to_u16(rel.to(torch.int32)),
            occ_l1.to(torch.int32), C)


def occ_build_compact(pull: torch.Tensor, alpha_map: torch.Tensor,
                      alpha_rev: torch.Tensor, *, n_seg: int, seg: int):
    """Kernel A' on the card (see occ_build_compact_plain for the
    outputs); alpha_map int32[261] maps each symbol to its column or -1."""
    kernels.check(pull, "pull", torch.int64, 1)
    kernels.check(alpha_map, "alpha_map", torch.int32, 1, (ALPHA_SIZE,))
    kernels.check(alpha_rev, "alpha_rev", torch.int32, 1)
    n = pull.shape[0]
    grp = l1_group_for(seg)
    if seg % 32 != 0 or n_seg * seg <= n or n_seg % grp != 0:
        raise ValueError("need seg % 32 == 0, n_seg * seg > n and n_seg a "
                         "multiple of the L1 group")
    if not kernels.on_card(pull, alpha_map, alpha_rev):
        return occ_build_compact_plain(pull, alpha_rev, n_seg=n_seg, seg=seg)
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
    return bwt, a_row, occ, occ_l1, C


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


def build_fm_arrays_device(text: torch.Tensor, sa: torch.Tensor,
                           doc_starts: torch.Tensor, *, n: int, seg: int,
                           mark_period: int, ndocs: int, tier: str = "full",
                           pull: torch.Tensor | None = None,
                           alpha: np.ndarray | None = None
                           ) -> Tuple[FMArrays, torch.Tensor, int]:
    """Assemble FMArrays of tier "full", "compact" or "packed" on the
    tensors' device.  Returns (arrays, n_marks scalar tensor, alpha_used:
    K on the packed tier, else 0).

    pull: the BWT + aux words suffix_array pulled from build_sa_payload's
    payload (int64[n]); gathered here through sa when not given.  alpha:
    the symbols in the text, ascending, as suffix.text_alphabet gives them
    (the packed tier's dense alphabet); found here by that one histogram
    of the text on its device when not given (a host np.bincount of the
    text, femto_tpu's way, made a 256 MiB build on the H100's host take
    1.71 s instead of 0.25 s, PERF.md)."""
    if tier not in ("full", "compact", "packed"):
        raise NotImplementedError(
            f"tier={tier!r} is not ported yet (ROADMAP.md Q1 item 6)")
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
        if tier == "packed":
            used = np.asarray(text_alphabet(text) if alpha is None else alpha,
                              dtype=np.int32)
            if used.size and used.max() >= ALPHA_SIZE:
                raise ValueError("symbols must lie in [0, 261)")
            alpha_used = len(used)
            amap = np.full(ALPHA_SIZE, -1, np.int32)
            amap[used] = np.arange(alpha_used, dtype=np.int32)
            alpha_map = torch.from_numpy(amap).to(dev)
            alpha_rev = torch.from_numpy(used).to(dev)
        bwt, a_row, occ_ckpt, occ_l1, C = occ_build_compact(
            pull, alpha_map, alpha_rev, n_seg=n_seg, seg=seg)
        if tier == "packed":
            per_word, bits = pack_widths(alpha_used)
            bwt = pack_build(bwt, alpha_map, per_word=per_word, bits=bits)
    mark_bits, mark_ckpt, mark_vals, mark_meta, n_marks, doc_seof_rows = \
        marks_build(sa, a_row, n_seg=n_seg, seg=seg, mark_period=mark_period,
                    ndocs=ndocs)
    arrays = FMArrays(
        bwt=bwt, occ_ckpt=occ_ckpt, occ_l1=occ_l1, C=C, mark_bits=mark_bits,
        mark_ckpt=mark_ckpt, mark_vals=mark_vals, doc_starts=doc_starts,
        doc_seof_rows=doc_seof_rows, alpha_map=alpha_map,
        alpha_rev=alpha_rev, mark_meta=mark_meta,
    )
    return arrays, n_marks, alpha_used
