"""Query API: count / locate / extract / context over an FMIndex (every
tier) or a paged.PagedIndex.

The counterpart of femto_tpu/search.py.  Patterns are byte strings; every
query runs on the index's device, through kernel C (count), kernel D
(locate walk, extract, context before the match) and kernel E (context
from the match on) on the card.  The direct locate tier is one gather,
sa_direct[rows], through kernel L.  A PagedIndex (it has _ensure_rows)
answers count_ranges, locate_range, locate_rows_array and
extract_document with its own host-driven steps, at femto_tpu's four
dispatch points; context and whole-corpus extraction raise over it, since
they would read rows the cache does not hold.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .alphabet import CHARACTER_OFFSET, pattern_to_alpha
from .fmindex import FMIndex
from .metrics import metrics
from .ops import search_ops as S
from .ops import sort_ops as SO


def _bucket(x: int, minimum: int = 8) -> int:
    """Round up to a power of two."""
    b = minimum
    while b < x:
        b *= 2
    return b


def pack_patterns(
    patterns: Sequence[np.ndarray], pad_b: Optional[int] = None
) -> Tuple[np.ndarray, int]:
    """Right-align alpha-coded patterns into int32[B, P] padded with -1."""
    lens = np.fromiter(map(len, patterns), np.int64, len(patterns))
    flat = np.concatenate(patterns) if lens.sum() else np.zeros(0, np.int32)
    return _pack_flat(flat, lens, pad_b), len(patterns)


def _pack_flat(flat: np.ndarray, lens: np.ndarray,
               pad_b: Optional[int]) -> np.ndarray:
    """pack_patterns of the patterns laid end to end in flat, in
    whole-array numpy steps (no Python loop over the patterns)."""
    B = len(lens)
    Bp = pad_b if pad_b is not None else _bucket(B)
    Pp = _bucket(max(int(lens.max(initial=0)), 1), minimum=4)
    out = np.full((Bp, Pp), -1, dtype=np.int32)
    ends = np.cumsum(lens)
    # right-aligned: pattern i ends at column Pp-1
    col = np.arange(len(flat)) + np.repeat(Pp - ends, lens)
    out[np.repeat(np.arange(B), lens), col] = flat
    return out


def count_ranges(
    index: FMIndex, patterns: Sequence[bytes]
) -> Tuple[np.ndarray, np.ndarray]:
    """Row ranges [first, last) for each pattern."""
    metrics.count("queries/count", len(patterns))
    metrics.count("queries/backward_steps", sum(len(p) for p in patterns))
    if not patterns:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex: host-driven
        return index.count_ranges(patterns)
    lens = np.fromiter(map(len, patterns), np.int64, len(patterns))
    pats = _pack_flat(pattern_to_alpha(b"".join(patterns)), lens,
                      pad_b=len(patterns))
    first, last = S.backward_search(
        index.arrays, index.meta.n_rows,
        torch.from_numpy(pats).to(index.device), row0=index.meta.row0)
    return (first.cpu().numpy().astype(np.int64),
            last.cpu().numpy().astype(np.int64))


def count(index: FMIndex, patterns: Sequence[bytes]) -> np.ndarray:
    """Number of occurrences of each pattern across the corpus."""
    first, last = count_ranges(index, patterns)
    return last - first


def _locate_rows_dispatch(index: FMIndex, rows: torch.Tensor) -> torch.Tensor:
    if index.sa_direct is not None:
        return SO.gather_rows(index.sa_direct, rows)
    return S.locate_rows(index.arrays, index.meta.mark_period, rows)


def locate_range(
    index: FMIndex, first: int, last: int, max_matches: Optional[int] = None
) -> np.ndarray:
    """Text offsets for all rows in [first, last), ascending by row."""
    m = int(last - first)
    if max_matches is not None:
        m = min(m, max_matches)
    metrics.count("queries/locate_rows", max(m, 0))
    if m <= 0:
        return np.zeros(0, dtype=np.int64)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.locate_range(first, first + m)
    rows = torch.arange(first, first + m, dtype=torch.int32,
                        device=index.device)
    return _locate_rows_dispatch(index, rows).cpu().numpy().astype(np.int64)


def locate_rows_array(index: FMIndex, rows: np.ndarray) -> np.ndarray:
    """Text offsets for an arbitrary batch of rows in [0, n_rows)."""
    rows = np.asarray(rows)
    m = len(rows)
    if m == 0:
        return np.zeros(0, np.int64)
    if rows.min() < 0 or rows.max() >= index.meta.n_rows:
        raise ValueError("rows must lie in [0, n_rows)")
    metrics.count("queries/locate_rows", m)
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.locate_rows_array(rows)
    rr = torch.from_numpy(rows.astype(np.int32)).to(index.device)
    return _locate_rows_dispatch(index, rr).cpu().numpy().astype(np.int64)


def offsets_to_docs(
    index: FMIndex, offs: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Map global text offsets to (doc_id, offset_in_doc); matches inside a
    document's header section come back negative."""
    if offs.size == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    doc = np.searchsorted(index.doc_starts_np, offs, side="right") - 1
    doc_off = offs - index.doc_starts_np[doc]
    if index.header_lens_np is not None:
        doc_off = doc_off - index.header_lens_np[doc]
    return doc.astype(np.int64), doc_off.astype(np.int64)


def range_docs(index: FMIndex, first: int, last: int) -> np.ndarray:
    """Unique doc ids of rows [first, last): per-row locate, or, when the
    index carries chunk doc-lists (a femto_tpu doc_chunks=True index),
    the lists of the whole segments and per-row locate for the edges."""
    if index.chunk_docs_np is None:
        doc, _ = offsets_to_docs(index, locate_range(index, first, last))
        return np.unique(doc)
    seg = index.meta.seg
    s0 = -(-first // seg)   # first whole segment
    s1 = last // seg        # end of whole segments
    parts = []
    if s1 > s0:
        o = index.chunk_doc_offsets_np
        parts.append(index.chunk_docs_np[o[s0]:o[s1]].astype(np.int64))
        edges = [(first, min(s0 * seg, last)), (max(s1 * seg, first), last)]
    else:
        edges = [(first, last)]
    for f, l in edges:
        if l > f:
            parts.append(offsets_to_docs(index, locate_range(index, f, l))[0])
    if not parts:
        return np.zeros(0, np.int64)
    return np.unique(np.concatenate(parts))


def locate(
    index: FMIndex, pattern: bytes, max_matches: Optional[int] = None
) -> List[Tuple[int, int]]:
    """All (doc_id, offset) matches of pattern, sorted."""
    first, last = count_ranges(index, [pattern])
    offs = locate_range(index, int(first[0]), int(last[0]), max_matches)
    doc, doc_off = offsets_to_docs(index, offs)
    return sorted(zip(doc.tolist(), doc_off.tolist()))


def _content_lens(index: FMIndex) -> np.ndarray:
    lens = (np.diff(index.doc_starts_np) - 1).astype(np.int64)
    if index.header_lens_np is not None:
        lens = lens - index.header_lens_np
    return lens


def extract_document(index: FMIndex, doc_id: int) -> bytes:
    """Reconstruct document bytes from the index alone, by a backward LF
    walk from the document's SEOF row."""
    if hasattr(index, "_ensure_rows"):  # paged.PagedIndex
        return index.extract_document(doc_id)
    dlen = int(_content_lens(index)[doc_id])
    if dlen == 0:
        return b""
    rows = index.arrays.doc_seof_rows[doc_id: doc_id + 1].contiguous()
    chars, _ = S.extract_backward(index.arrays, rows, dlen)
    seq = chars.cpu().numpy()[0][::-1]  # reverse: the walk went backwards
    return (seq - CHARACTER_OFFSET).astype(np.uint8).tobytes()


def _refuse_paged(index, what: str) -> None:
    """femto_tpu's version of `what` has no paged dispatch and, over a
    PagedIndex, reads the uncached segments through dummy slot 0 and
    returns wrong bytes; the port raises instead."""
    if hasattr(index, "_ensure_rows"):
        raise NotImplementedError(
            f"{what} is not served over a paged index (its walks would "
            f"read rows the device cache does not hold); load the index "
            f"resident (FMIndex.load) for it")


def extract_all_documents(index: FMIndex) -> List[bytes]:
    """Reconstruct every document in one batched LF walk (rows = all doc
    SEOF rows, steps = the longest document)."""
    _refuse_paged(index, "extract_all_documents")
    lens = _content_lens(index)
    ndocs = len(lens)
    if ndocs == 0:
        return []
    maxlen = int(lens.max())
    if maxlen == 0:
        return [b""] * ndocs
    rows = index.arrays.doc_seof_rows[:ndocs].contiguous()
    chars = S.extract_backward(index.arrays, rows, maxlen)[0].cpu().numpy()
    return [(chars[d][: int(lens[d])][::-1] - CHARACTER_OFFSET)
            .astype(np.uint8).tobytes() for d in range(ndocs)]


def extract_context_batch(
    index: FMIndex, rows, before: int, pattern_len: int, after: int
) -> List[bytes]:
    """For each match row, `before` bytes of left context, the match and
    `after` bytes of right context, cut at the document's bounds (and
    header): one backward LF walk (kernel D) and one forward psi walk
    (kernel E) for the whole batch.  Raises NotImplementedError over a
    paged.PagedIndex."""
    _refuse_paged(index, "extract_context_batch")
    rows = np.asarray(rows, dtype=np.int64)
    B = len(rows)
    if B == 0:
        return []
    if rows.min() < 0 or rows.max() >= index.meta.n_rows:
        raise ValueError("rows must lie in [0, n_rows)")
    rr = torch.from_numpy(rows.astype(np.int32)).to(index.device)
    fwd_steps = pattern_len + after
    chars_fwd = (S.psi_walk(index.arrays, rr, fwd_steps).cpu().numpy()
                 if fwd_steps > 0 else np.zeros((B, 0), np.int32))
    chars_back = (S.extract_backward(index.arrays, rr, before)[0].cpu()
                  .numpy() if before > 0 else np.zeros((B, 0), np.int32))
    out = []
    for i in range(B):
        left = chars_back[i][::-1]
        nonchar = np.nonzero(left < CHARACTER_OFFSET)[0]
        if len(nonchar):
            left = left[int(nonchar.max()) + 1:]
        fwd = chars_fwd[i]
        stops = np.nonzero(fwd < CHARACTER_OFFSET)[0]
        if len(stops):
            fwd = fwd[: stops[0]]
        seq = np.concatenate([left, fwd]).astype(np.int64)
        out.append((seq - CHARACTER_OFFSET).astype(np.uint8).tobytes())
    return out


def extract_context(
    index: FMIndex, row: int, before: int, pattern_len: int, after: int
) -> bytes:
    """Single-row wrapper over extract_context_batch."""
    _refuse_paged(index, "extract_context")
    return extract_context_batch(index, [row], before, pattern_len, after)[0]
