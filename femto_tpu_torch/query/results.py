"""Result sets and Boolean combination.

The reference keeps sorted compressed document/offset lists with
union/intersect/subtract ops (src/main/results.{h,c}:
result types COUNT/DOCUMENTS/OFFSETS/DOC_OFFSETS, intersectResults/
unionResults results.h:115-121).  Here a result set is a sorted numpy
record array of (doc, offset) or just doc ids; Boolean THEN/WITHIN use
offsets with distance windows (QUERY_FORMAT.txt).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class ResultType(enum.Enum):
    COUNT = 0
    DOCUMENTS = 1
    DOC_OFFSETS = 2


@dataclasses.dataclass
class Results:
    """Sorted match results.

    docs:    int64[k] document ids (sorted, unique for DOCUMENTS type)
    offsets: int64[k] per-match offsets (DOC_OFFSETS only; sorted by
             (doc, offset))
    count:   total number of matching positions (rows)
    """

    type: ResultType
    count: int = 0
    docs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    offsets: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64)
    )
    # True when a term's materialized rows were capped (engine
    # BOOLEAN_TERM_CAP / sharded SHARDED_TERM_CAP): the doc/offset lists
    # may be incomplete.  The reference materializes full result sets
    # (results.h:115-121), so truncation here must never be silent —
    # combinators propagate the flag and the query entry points surface
    # it (warning + "truncated" in server JSON).
    truncated: bool = False

    @classmethod
    def from_doc_offsets(cls, docs, offsets) -> "Results":
        docs = np.asarray(docs, np.int64)
        offsets = np.asarray(offsets, np.int64)
        order = np.lexsort((offsets, docs))
        return cls(
            type=ResultType.DOC_OFFSETS,
            count=len(docs),
            docs=docs[order],
            offsets=offsets[order],
        )

    @classmethod
    def from_docs(cls, docs, count: Optional[int] = None) -> "Results":
        docs = np.unique(np.asarray(docs, np.int64))
        return cls(
            type=ResultType.DOCUMENTS,
            count=count if count is not None else len(docs),
            docs=docs,
        )

    def doc_set(self) -> np.ndarray:
        return np.unique(self.docs)


def _carry(out: Results, a: Results, b: Results) -> Results:
    out.truncated = a.truncated or b.truncated
    return out


def union(a: Results, b: Results) -> Results:
    if a.type == ResultType.DOC_OFFSETS and b.type == ResultType.DOC_OFFSETS:
        docs = np.concatenate([a.docs, b.docs])
        offs = np.concatenate([a.offsets, b.offsets])
        keys = np.stack([docs, offs], axis=1)
        uniq, idx = np.unique(keys, axis=0, return_index=True)
        return _carry(Results.from_doc_offsets(docs[idx], offs[idx]), a, b)
    return _carry(
        Results.from_docs(np.concatenate([a.doc_set(), b.doc_set()])), a, b)


def intersect(a: Results, b: Results) -> Results:
    """AND: documents present in both; keeps a's offsets when available."""
    common = np.intersect1d(a.doc_set(), b.doc_set())
    if a.type == ResultType.DOC_OFFSETS:
        keep = np.isin(a.docs, common)
        return _carry(
            Results.from_doc_offsets(a.docs[keep], a.offsets[keep]), a, b)
    return _carry(Results.from_docs(common), a, b)


def subtract(a: Results, b: Results) -> Results:
    """NOT: documents in a but not in b."""
    keepdocs = np.setdiff1d(a.doc_set(), b.doc_set())
    if a.type == ResultType.DOC_OFFSETS:
        keep = np.isin(a.docs, keepdocs)
        return _carry(
            Results.from_doc_offsets(a.docs[keep], a.offsets[keep]), a, b)
    return _carry(Results.from_docs(keepdocs), a, b)


def then_within(
    a: Results, b: Results, distance: int, ordered: bool
) -> Results:
    """THEN (ordered) / WITHIN (either order): documents where a match of b
    starts within `distance` characters of the start of a match of a
    (QUERY_FORMAT.txt boolean section).  Result keeps a's matching
    offsets."""
    if a.type != ResultType.DOC_OFFSETS or b.type != ResultType.DOC_OFFSETS:
        raise ValueError("THEN/WITHIN need offset results")
    if len(a.docs) == 0 or len(b.docs) == 0:
        return _carry(Results.from_doc_offsets(
            np.zeros(0, np.int64), np.zeros(0, np.int64)
        ), a, b)
    # Vectorized window join: b is sorted by (doc, offset), so an a-match
    # (doc, off) has a partner iff the composite-key interval
    # [key(doc, off+lo), key(doc, off+hi)] is non-empty in b.
    lo_delta = 0 if ordered else -distance
    hi_delta = distance
    big = int(max(a.offsets.max() + hi_delta, b.offsets.max())) + 2
    max_doc = int(max(a.docs.max(), b.docs.max()))
    if (max_doc + 1) * big < 2**62:
        kb = b.docs * big + b.offsets  # already (doc, offset)-sorted
        lo_off = np.maximum(a.offsets + lo_delta, 0)
        klo = a.docs * big + lo_off
        khi = a.docs * big + (a.offsets + hi_delta)
        keep = (
            np.searchsorted(kb, khi, side="right")
            > np.searchsorted(kb, klo, side="left")
        )
    else:  # composite key would overflow int64: per-shared-doc join
        keep = np.zeros(len(a.docs), bool)
        shared = np.intersect1d(a.doc_set(), b.doc_set())
        a_lo = np.searchsorted(a.docs, shared, side="left")
        a_hi = np.searchsorted(a.docs, shared, side="right")
        b_lo = np.searchsorted(b.docs, shared, side="left")
        b_hi = np.searchsorted(b.docs, shared, side="right")
        for al, ah, bl, bh in zip(a_lo, a_hi, b_lo, b_hi):
            offs = a.offsets[al:ah]
            bo = b.offsets[bl:bh]
            keep[al:ah] = (
                np.searchsorted(bo, offs + hi_delta, side="right")
                > np.searchsorted(bo, np.maximum(offs + lo_delta, 0), "left")
            )
    return _carry(
        Results.from_doc_offsets(a.docs[keep], a.offsets[keep]), a, b)
