"""Multi-index search and chunked builds past 2^31 symbols (PyTorch).

The counterpart of femto_tpu/multi.py.  A MultiIndex presents several
FMIndexes as one corpus: counts add, doc ids are offset by each chunk's
base, Boolean queries are evaluated chunk by chunk (a document lives in
one chunk).  build_chunked_prepared splits one PreparedText at document
boundaries into chunks of at most max_chunk_symbols (int32 row ids stay
per chunk; doc ids and offsets compose to int64 on the host), builds each
on the card with per-segment doc lists, at one padded shape
(``uniform``), and ships each chunk's text as raw content bytes that
kernel Q (ops/build_ops.expand_u8) turns back into alphabet codes, the
next chunk's upload overlapping the current build (``prefetch``).
merge_indexes and IncrementalIndex rebuild from the text the indexes
themselves give back (extract_prepared).  A MultiIndex saved by femto_tpu
(a directory of chunk directories and multi.json) loads here, and back.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .alphabet import CHARACTER_OFFSET, PreparedText, prepare_documents
from .fmindex import (FMIndex, _escape_positions, build_index,
                      resolve_device)
from .ops.build_ops import expand_u8
from .search import count as _count
from .search import locate as _locate
from .search import locate_range

# Largest single-index chunk: int32 row ids must hold n plus slack.
MAX_CHUNK_SYMBOLS = 2**31 - 2**24


class MultiIndex:
    """A list of FMIndexes presented as one corpus; doc ids are offset by
    each chunk's base."""

    def __init__(self, indexes: Sequence):
        flat: List[FMIndex] = []
        for ix in indexes:
            if isinstance(ix, MultiIndex):
                flat.extend(ix.indexes)
            else:
                flat.append(ix)
        self.indexes = flat
        self.doc_base = np.cumsum([0] + [ix.num_docs for ix in self.indexes])

    @property
    def num_docs(self) -> int:
        return int(self.doc_base[-1])

    @property
    def n(self) -> int:
        return sum(ix.meta.n for ix in self.indexes)

    def info(self, doc: int) -> bytes:
        s = int(np.searchsorted(self.doc_base, doc, side="right") - 1)
        return self.indexes[s].infos[doc - int(self.doc_base[s])]

    def count(self, patterns: Sequence[bytes]) -> np.ndarray:
        total = np.zeros(len(patterns), dtype=np.int64)
        for ix in self.indexes:
            total += _count(ix, patterns)
        return total

    def locate(self, pattern: bytes, max_matches: Optional[int] = None
               ) -> List[Tuple[int, int]]:
        out: List[Tuple[int, int]] = []
        for s, ix in enumerate(self.indexes):
            rem = None if max_matches is None else max_matches - len(out)
            if rem is not None and rem <= 0:
                break
            for doc, off in _locate(ix, pattern, rem):
                out.append((doc + int(self.doc_base[s]), off))
        return sorted(out)

    def docs(self, pattern: bytes) -> List[int]:
        return sorted({d for d, _ in self.locate(pattern)})

    def docs_query(self, query: str, max_matches: Optional[int] = None,
                   with_offsets: bool = True):
        """(doc, info, offsets) of every matching document, chunk by
        chunk (query.engine.docs_query), doc ids made global."""
        from .query.engine import docs_query as _dq

        out = []
        for s, ix in enumerate(self.indexes):
            for doc, info, offs in _dq(ix, query, max_matches=max_matches,
                                       with_offsets=with_offsets):
                out.append((doc + int(self.doc_base[s]), info, offs))
            if max_matches is not None and len(out) >= max_matches:
                break
        return out[:max_matches] if max_matches is not None else out

    def count_query(self, query: str) -> int:
        """Matches of a single term summed over the chunks; for a Boolean
        query, the number of matching documents."""
        from .query.ast import QTerm
        from .query.engine import count_query as _cq
        from .query.parser import parse_query

        if isinstance(parse_query(query), QTerm):
            return sum(_cq(ix, query) for ix in self.indexes)
        return len(self.docs_query(query, with_offsets=False))

    # ---- persistence: a directory of chunk indexes + manifest ----

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        names = []
        for i, ix in enumerate(self.indexes):
            name = f"chunk{i:05d}"
            ix.save(os.path.join(path, name))
            names.append(name)
        with open(os.path.join(path, "multi.json"), "w") as f:
            json.dump({"chunks": names}, f)

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "MultiIndex":
        with open(os.path.join(path, "multi.json")) as f:
            manifest = json.load(f)
        return cls([FMIndex.load(os.path.join(path, c), device=device)
                    for c in manifest["chunks"]])


def build_chunked(docs: Sequence[bytes], chunk_docs: int,
                  **build_kwargs) -> MultiIndex:
    """A MultiIndex of one build_index per chunk_docs documents (doc lists
    on unless build_kwargs say otherwise)."""
    build_kwargs.setdefault("doc_chunks", True)
    return MultiIndex([
        build_index(prepare_documents(docs[i: i + chunk_docs]),
                    **build_kwargs)
        for i in range(0, len(docs), chunk_docs)])


def chunk_bounds(doc_starts: np.ndarray, max_chunk_symbols: int
                 ) -> List[Tuple[int, int]]:
    """[(d0, d1)]: the documents of each chunk, as many as fit in
    max_chunk_symbols from d0 on (femto_tpu's chunk bounds)."""
    ndocs = len(doc_starts) - 1
    bounds = []
    d0 = 0
    while d0 < ndocs:
        base = int(doc_starts[d0])
        d1 = d0 + 1
        while (d1 < ndocs
               and int(doc_starts[d1 + 1]) - base <= max_chunk_symbols):
            d1 += 1
        if int(doc_starts[d1]) - base > max_chunk_symbols:
            raise ValueError(f"document {d0} alone exceeds max_chunk_symbols")
        bounds.append((d0, d1))
        d0 = d1
    return bounds


class _Upload:
    """One chunk's text on its way to the card: the host staging buffers
    (pinned on the card's host) and the device copies, made on a side
    stream that an event closes.  take() makes the calling stream wait for
    that event and hands the tensors to it."""

    def __init__(self, host: List[np.ndarray], dev: torch.device,
                 side: Optional["torch.cuda.Stream"]):
        self.event = None
        if side is None:
            self.staged = []
            self.bufs = [torch.from_numpy(a) for a in host]
            return
        # pinned staging: an asynchronous copy needs page-locked memory; the
        # buffers stay referenced here until the build that reads the copies
        # has run, so no later chunk can reuse them under the copy
        self.staged = [torch.from_numpy(a).pin_memory() for a in host]
        with torch.cuda.stream(side):
            self.bufs = [t.to(dev, non_blocking=True) for t in self.staged]
            self.event = torch.cuda.Event()
            self.event.record(side)

    def take(self) -> List[torch.Tensor]:
        if self.event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(self.event)
            for b in self.bufs:
                # allocated on the side stream, used and freed on this one
                b.record_stream(cur)
        return self.bufs


def _content_u8(text: np.ndarray, n_build: int) -> np.ndarray:
    """uint8[n_build]: (text - CHARACTER_OFFSET) mod 256, the content
    bytes (escape slots hold garbage, overwritten by expand_u8), zero
    past the text."""
    u8 = np.zeros(n_build, np.uint8)
    np.subtract(text, CHARACTER_OFFSET, out=u8[: len(text)],
                casting="unsafe")
    return u8


def build_chunked_prepared(prepared: PreparedText,
                           max_chunk_symbols: int = MAX_CHUNK_SYMBOLS,
                           uniform: bool = True, prefetch: bool = True,
                           **build_kwargs) -> MultiIndex:
    """A MultiIndex over one PreparedText, split at document boundaries so
    that each chunk holds at most max_chunk_symbols symbols
    (femto_tpu.multi.build_chunked_prepared): the path for corpora past
    2^31 symbols.

    Doc lists are built by default (doc_chunks=True; pass False to skip).
    uniform=True builds every chunk of a multi-chunk corpus at one shape
    (the most symbols and the most documents of any chunk) through
    build_index's pad_shape, as femto_tpu does, so the chunks carry
    femto_tpu's row0, n_rows and doc ids.  Each chunk's text ships as raw content bytes plus
    the escape positions (_escape_positions), rebuilt on the card by
    expand_u8, or as uint16 where the text holds escapes the document
    layout does not place.  prefetch=True stages the next chunk's bytes in
    pinned host memory and copies them on a side stream while the current
    chunk builds; the build waits on the copy's event.  prefetch=False
    uploads each chunk just before its build (one chunk's bytes less of
    peak device memory)."""
    dev = resolve_device(build_kwargs.get("device", "cuda"))
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    starts = prepared.doc_starts
    bounds = chunk_bounds(starts, max_chunk_symbols)
    build_kwargs.setdefault("doc_chunks", True)
    pad_shape = None
    if uniform and len(bounds) > 1:
        pad_shape = (
            max(int(starts[d1]) - int(starts[d0]) for d0, d1 in bounds),
            max(d1 - d0 for d0, d1 in bounds),
        )

    def make_sub(i: int) -> PreparedText:
        d0, d1 = bounds[i]
        base = int(starts[d0])
        return PreparedText(
            text=prepared.text[base: int(starts[d1])],
            doc_starts=(starts[d0: d1 + 1] - base),
            infos=list(prepared.infos[d0: d1]),
            header_lens=(None if prepared.header_lens is None
                         else prepared.header_lens[d0: d1]),
        )

    def chunk_upload(i: int, sub: PreparedText
                     ) -> Callable[[], Dict[str, torch.Tensor]]:
        """Start chunk i's upload; returns the thunk that gives
        build_index's text_dev32 (or text_dev16) when the build runs."""
        d0, d1 = bounds[i]
        n_real = sub.n
        n_build = pad_shape[0] if pad_shape is not None else n_real
        ndocs_build = pad_shape[1] if pad_shape is not None else d1 - d0
        esc = _escape_positions(sub, ndocs_build)
        if esc is not None:
            up = _Upload([_content_u8(sub.text, n_build), *esc], dev, side)

            def thunk():
                u8, *pos = up.take()
                return {"text_dev32": expand_u8(u8, n_real, *pos)}

            return thunk
        t = np.zeros(n_build, np.uint16)
        t[:n_real] = sub.text
        up = _Upload([t.view(np.int16)], dev, side)
        return lambda: {"text_dev16": up.take()[0]}

    indexes = []
    subs = {0: make_sub(0)}
    pending = chunk_upload(0, subs[0]) if prefetch else None
    for i in range(len(bounds)):
        sub = subs.pop(i) if i in subs else make_sub(i)
        if pending is not None:
            thunk, pending = pending, None
        else:
            thunk = chunk_upload(i, sub)
        if prefetch and i + 1 < len(bounds):
            # the next chunk's upload starts before this build
            subs[i + 1] = make_sub(i + 1)
            pending = chunk_upload(i + 1, subs[i + 1])
        indexes.append(build_index(sub, pad_shape=pad_shape, **thunk(),
                                   **build_kwargs))
    return MultiIndex(indexes)


def extract_prepared(index: FMIndex) -> PreparedText:
    """The prepared text stream of an index (escapes and headers
    included), rebuilt from the index alone as whole arrays: the offsets of
    all rows [row0, n_rows) by locate, a window at a time, and each row's
    first symbol from C (text[sa[r]] = the symbol whose C range holds r)."""
    n = index.meta.n
    text = np.zeros(n, np.uint16)
    C = index.arrays.C.cpu().numpy().astype(np.int64)
    arev = index.arrays.alpha_rev.cpu().numpy().astype(np.int64)
    CH = 1 << 20
    for f in range(index.meta.row0, index.meta.n_rows, CH):
        l = min(f + CH, index.meta.n_rows)
        offs = locate_range(index, f, l)
        rows = np.arange(f, l, dtype=np.int64)
        cd = np.searchsorted(C, rows, side="right") - 1
        text[offs] = arev[cd].astype(np.uint16)
    return PreparedText(
        text=text,
        doc_starts=index.doc_starts_np.astype(np.int64).copy(),
        infos=list(index.infos),
        header_lens=(None if index.header_lens_np is None
                     else index.header_lens_np.copy()),
    )


def merge_prepared(indexes: Sequence[FMIndex]) -> PreparedText:
    """Several indexes' prepared streams, end to end, as one
    PreparedText."""
    parts = [extract_prepared(ix) for ix in indexes]
    starts = [np.zeros(1, np.int64)]
    base = 0
    any_hdr = any(p.header_lens is not None for p in parts)
    hdrs = []
    infos: List[bytes] = []
    for p in parts:
        starts.append(p.doc_starts[1:] + base)
        base += int(p.doc_starts[-1])
        infos.extend(p.infos)
        hdrs.append(p.header_lens if p.header_lens is not None
                    else np.zeros(p.num_docs, np.int64))
    return PreparedText(
        text=np.concatenate([p.text for p in parts]),
        doc_starts=np.concatenate(starts),
        infos=infos,
        header_lens=np.concatenate(hdrs) if any_hdr else None,
    )


def merge_indexes(indexes: Sequence[FMIndex], **build_kwargs) -> FMIndex:
    """One index over several: their texts rebuilt from the indexes
    (merge_prepared) and built anew."""
    return build_index(merge_prepared(indexes), **build_kwargs)


class IncrementalIndex:
    """Chunks added one build at a time; past max_shards chunks the
    smallest are merged into one rebuilt chunk (through the chunked build
    when the merge reaches 2^31 symbols)."""

    def __init__(self, max_shards: int = 4, **build_kwargs):
        self.max_shards = max_shards
        self.build_kwargs = build_kwargs
        self.multi = MultiIndex([])

    def add_documents(self, docs: Sequence[bytes],
                      infos: Optional[Sequence[bytes]] = None) -> None:
        shard = build_index(prepare_documents(docs, infos),
                            **self.build_kwargs)
        shards = self.multi.indexes + [shard]
        if len(shards) > self.max_shards:
            shards.sort(key=lambda ix: ix.meta.n)
            k = len(shards) - self.max_shards + 1
            prep = merge_prepared(shards[:k])
            if prep.n >= 2**31:
                merged = build_chunked_prepared(
                    prep, **self.build_kwargs).indexes
            else:
                merged = [build_index(prep, **self.build_kwargs)]
            shards = merged + shards[k:]
        self.multi = MultiIndex(shards)

    def count(self, patterns):
        return self.multi.count(patterns)

    def locate(self, pattern, max_matches=None):
        return self.multi.locate(pattern, max_matches)

    def docs_query(self, query, **kw):
        return self.multi.docs_query(query, **kw)

    def count_query(self, query):
        return self.multi.count_query(query)

    @property
    def num_docs(self):
        return self.multi.num_docs
