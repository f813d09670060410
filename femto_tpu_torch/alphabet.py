"""Alphabet and document preparation (the port's own copy of
femto_tpu/alphabet.py: numpy only, so the port never imports femto_tpu).

Mirrors the *semantics* of the reference's 261-symbol alphabet
(femto's src/main/index_types.h:35-71): 256 byte values shifted up by
CHARACTER_OFFSET, below which sit reserved escape symbols.  The reference uses
escape value 0 (must be smallest so that escape+EOF is the minimal string,
index_types.h:36-39) and codes EOF/SEOF/SOH/EOH; we reserve the same five
code points so patterns containing header-section escapes remain expressible,
but our *prepared text* layout is TPU-native: documents are concatenated with
a single SEOF terminator symbol per document (no 9-char trailer to strip as
in block_format.txt:1-15) and document ids are kept in dense side arrays
instead of being spliced into the text.

Symbol order (ascending): ESCAPE(0) < EOF(1) < SEOF(2) < SOH(3) < EOH(4) <
byte+5.  SEOF terminates every document, so no query pattern (whose symbols
are all >= CHARACTER_OFFSET) can match across a document boundary, and every
suffix of the prepared text is distinct from any other that starts inside a
different document tail.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

# Reserved code points (same set as index_types.h:42-48).
ESCAPE = 0
EOF = 1
SEOF = 2
SOH = 3
EOH = 4
NUM_ESCAPE_CODES = 5

CHARACTER_OFFSET = NUM_ESCAPE_CODES  # = 5
ALPHA_SIZE = CHARACTER_OFFSET + 256  # = 261
# Sentinel for "no character" in padded pattern arrays / padded BWT tails.
INVALID_ALPHA = 0x1FF  # 511, outside the alphabet


def byte_to_alpha(b: int) -> int:
    return b + CHARACTER_OFFSET


def alpha_to_byte(a: int) -> int:
    return a - CHARACTER_OFFSET


def bytes_to_alpha(data: bytes) -> np.ndarray:
    """Translate raw bytes into alphabet codes (uint16)."""
    return np.frombuffer(data, dtype=np.uint8).astype(np.uint16) + CHARACTER_OFFSET


def alpha_to_bytes(arr: np.ndarray) -> bytes:
    """Translate alphabet codes back to bytes; escape symbols are dropped."""
    arr = np.asarray(arr)
    keep = arr >= CHARACTER_OFFSET
    return (arr[keep] - CHARACTER_OFFSET).astype(np.uint8).tobytes()


@dataclasses.dataclass
class PreparedText:
    """Concatenated alphabet-coded corpus plus document boundary metadata.

    text:        uint16[n] alphabet codes; doc i occupies
                 [doc_starts[i], doc_starts[i+1]) laid out as
                 [SOH header EOH]? content SEOF.
    doc_starts:  int64[ndocs+1] region prefix offsets into `text`.
    infos:       per-document opaque info strings (filenames/URLs), the
                 analog of the reference's doc_info records
                 (bwt_reader.h:144-176).
    header_lens: int64[ndocs] total header region length per doc
                 (0 or len(header)+2), or None when no headers exist;
                 content of doc i starts at doc_starts[i]+header_lens[i].
    """

    text: np.ndarray
    doc_starts: np.ndarray
    infos: List[bytes]
    header_lens: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    @property
    def num_docs(self) -> int:
        return int(self.doc_starts.shape[0]) - 1

    def header_len(self, d: int) -> int:
        return 0 if self.header_lens is None else int(self.header_lens[d])

    def doc_bytes(self, d: int) -> bytes:
        """Raw content bytes of document d (header/terminator stripped)."""
        s = int(self.doc_starts[d]) + self.header_len(d)
        e = int(self.doc_starts[d + 1])
        return alpha_to_bytes(self.text[s : e - 1])

    def header_bytes(self, d: int) -> bytes:
        h = self.header_len(d)
        if h == 0:
            return b""
        s = int(self.doc_starts[d])
        return alpha_to_bytes(self.text[s + 1 : s + h - 1])

    def doc_len(self, d: int) -> int:
        """Content length of document d in bytes (without terminator)."""
        return (int(self.doc_starts[d + 1] - self.doc_starts[d]) - 1
                - self.header_len(d))


def prepare_documents(
    docs: Sequence[bytes],
    infos: Optional[Sequence[bytes]] = None,
    headers: Optional[Sequence[bytes]] = None,
) -> PreparedText:
    """Two-pass document preparation (analog of bwt_prepare.{h,c}).

    Pass 1 counts, pass 2 ingests — done here with numpy concatenation; the
    native C++ loader in femto_tpu/io performs the same layout for large
    corpora.

    headers: optional per-document header sections, stored as
    SOH+header+EOH ahead of the content (the reference's header sections,
    block_format.txt:4-8).  Header bytes are searchable like content —
    their match offsets come back negative relative to the content start —
    but patterns cannot match across the SOH/EOH escape boundaries.
    """
    if infos is None:
        infos = [("doc%d" % i).encode() for i in range(len(docs))]
    infos = list(infos)
    if len(infos) != len(docs):
        raise ValueError("infos length must match docs length")
    if headers is not None and len(headers) != len(docs):
        raise ValueError("headers length must match docs length")

    def hdr_len(i: int) -> int:
        return (len(headers[i]) + 2) if headers is not None and headers[i] else 0

    lens = np.fromiter(
        (hdr_len(i) + len(d) + 1 for i, d in enumerate(docs)),
        dtype=np.int64, count=len(docs),
    )
    doc_starts = np.zeros(len(docs) + 1, dtype=np.int64)
    np.cumsum(lens, out=doc_starts[1:])
    n = int(doc_starts[-1])
    text = np.empty(n, dtype=np.uint16)
    for i, d in enumerate(docs):
        s = int(doc_starts[i])
        h = hdr_len(i)
        if h:
            text[s] = SOH
            text[s + 1 : s + h - 1] = bytes_to_alpha(headers[i])
            text[s + h - 1] = EOH
        if len(d):
            text[s + h : s + h + len(d)] = bytes_to_alpha(d)
        text[s + h + len(d)] = SEOF
    header_lens = None
    if headers is not None:
        header_lens = np.fromiter(
            (hdr_len(i) for i in range(len(docs))), dtype=np.int64,
            count=len(docs),
        )
    return PreparedText(text=text, doc_starts=doc_starts, infos=infos,
                        header_lens=header_lens)


def pattern_to_alpha(pattern: bytes) -> np.ndarray:
    """Encode a byte pattern for searching."""
    return bytes_to_alpha(pattern).astype(np.int32)


def should_mark(mark_period: int, pos: int, doc_offset: int,
                doc_len: int) -> bool:
    """Mark-sampling rule (the role of index_types.h:134-144): document
    start and final position are always marked; interior positions on the
    GLOBAL mark_period grid are marked.  The grid is global (round 4)
    rather than doc-relative so grid mark values are multiples of the
    period and bit-pack at ~log2(n/period) bits (build_ops.mark_pack_geom)
    — the walk bound is unchanged (< period LF steps to the grid point).
    doc_len includes the SEOF terminator."""
    if mark_period == 0:
        return False
    if doc_offset == 0 or doc_offset == doc_len - 1:
        return True
    return pos % mark_period == 0


def mark_positions_np(
    doc_starts: np.ndarray, mark_period: int
) -> np.ndarray:
    """Vectorized should_mark over every position of the prepared text.

    Returns a bool[n] array: position p is marked iff
    should_mark(mark_period, p, p - doc_start(p), doc_len(p)).
    """
    n = int(doc_starts[-1])
    if mark_period == 0:
        return np.zeros(n, dtype=bool)
    pos = np.arange(n, dtype=np.int64)
    doc_of = np.searchsorted(doc_starts, pos, side="right") - 1
    doc_off = pos - doc_starts[doc_of]
    doc_end = doc_starts[doc_of + 1] - doc_starts[doc_of]
    return (doc_off == 0) | (doc_off == doc_end - 1) | (pos % mark_period == 0)
