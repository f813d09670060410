"""Backward search, locate and extraction: kernel wrappers + plain versions.

The counterparts of femto_tpu/ops/search_ops.py backward_search,
locate_rows and extract_backward (full tier).  Each wrapper launches its
CUDA kernel (csrc/backward_search.cu, csrc/lf_walk.cu) for tensors on the
card and takes the plain PyTorch version beside it for tensors on the CPU;
a CUDA tensor never falls back.  The plain versions repeat femto_tpu's
lockstep loops with the ops/rank.py steps.
"""

from __future__ import annotations

import torch

from .. import kernels
from ..alphabet import ALPHA_SIZE
from ..fmindex import FMArrays
from . import rank as R


def check_full_tier(arrays: FMArrays) -> None:
    """The tensors every full-tier kernel reads, with their layouts."""
    n_seg, seg = arrays.bwt.shape
    kernels.check(arrays.bwt, "bwt", torch.uint16, 2)
    if seg % 32 != 0 or arrays.bwt.data_ptr() % 16 != 0:
        raise ValueError("bwt rows must be 16-byte aligned (seg % 32 == 0)")
    kernels.check(arrays.occ_ckpt, "occ_ckpt", torch.int32, 2,
                  (n_seg, ALPHA_SIZE))
    kernels.check(arrays.C, "C", torch.int32, 1, (ALPHA_SIZE + 1,))


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
    check_full_tier(arrays)
    kernels.check(pats, "pats", torch.int32, 2)
    if not kernels.on_card(pats, arrays.bwt, arrays.occ_ckpt, arrays.C):
        return backward_search_plain(arrays, n, pats, row0)
    B, P = pats.shape
    first = torch.empty(B, dtype=torch.int32, device=pats.device)
    last = torch.empty(B, dtype=torch.int32, device=pats.device)
    n_seg, seg = arrays.bwt.shape
    kernels.launch("backward_search", pats.data_ptr(), B, P,
                   arrays.bwt.data_ptr(), arrays.occ_ckpt.data_ptr(),
                   arrays.C.data_ptr(), n_seg, seg, n, row0,
                   first.data_ptr(), last.data_ptr())
    return first, last


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
    check_full_tier(arrays)
    kernels.check(rows, "rows", torch.int32, 1)
    n_seg, seg = arrays.bwt.shape
    kernels.check(arrays.mark_bits, "mark_bits", torch.uint32, 2,
                  (n_seg, seg // 32))
    kernels.check(arrays.mark_ckpt, "mark_ckpt", torch.int32, 1, (n_seg,))
    kernels.check(arrays.mark_vals, "mark_vals", torch.uint32, 1)
    kernels.check(arrays.mark_meta, "mark_meta", torch.int32, 1, (5,))
    if not kernels.on_card(rows, arrays.bwt, arrays.occ_ckpt, arrays.C,
                           arrays.mark_bits, arrays.mark_ckpt,
                           arrays.mark_vals, arrays.mark_meta):
        return locate_rows_plain(arrays, mark_period, rows)
    out = torch.empty_like(rows)
    kernels.launch("lf_locate", rows.data_ptr(), rows.shape[0],
                   arrays.bwt.data_ptr(), arrays.occ_ckpt.data_ptr(),
                   arrays.C.data_ptr(), n_seg, seg,
                   arrays.mark_bits.data_ptr(), arrays.mark_ckpt.data_ptr(),
                   arrays.mark_vals.data_ptr(), arrays.mark_vals.shape[0],
                   arrays.mark_meta.data_ptr(), mark_period, out.data_ptr())
    return out


def extract_backward_plain(arrays: FMArrays, rows: torch.Tensor,
                           num_steps: int):
    """femto_tpu's scan: num_steps LF steps, emitting each row's symbol."""
    codes = []
    for _ in range(num_steps):
        codes.append(R.bwt_code_at(arrays, rows))
        rows = R.lf_step(arrays, rows)
    if not codes:
        return (torch.zeros((rows.shape[0], 0), dtype=torch.int32,
                            device=rows.device), rows)
    return torch.stack(codes, dim=1), rows


def extract_backward(arrays: FMArrays, rows: torch.Tensor, num_steps: int):
    """Walk LF num_steps times from each row (rows in [0, n)), collecting
    BWT symbols.  Returns (chars int32[B, num_steps], final_rows int32[B]):
    chars[:, t] is the symbol t+1 positions before each row's suffix.
    Kernel D on the card."""
    check_full_tier(arrays)
    kernels.check(rows, "rows", torch.int32, 1)
    if not kernels.on_card(rows, arrays.bwt, arrays.occ_ckpt, arrays.C):
        return extract_backward_plain(arrays, rows, num_steps)
    B = rows.shape[0]
    chars = torch.empty((B, num_steps), dtype=torch.int32, device=rows.device)
    final = torch.empty_like(rows)
    n_seg, seg = arrays.bwt.shape
    kernels.launch("lf_extract", rows.data_ptr(), B, num_steps,
                   arrays.bwt.data_ptr(), arrays.occ_ckpt.data_ptr(),
                   arrays.C.data_ptr(), n_seg, seg, chars.data_ptr(),
                   final.data_ptr())
    return chars, final
