"""Serving a row-tier index larger than the device budget (PyTorch).

The counterpart of femto_tpu/paged.py, with the same host bookkeeping, so
that its answers, stats, slot maps and cache equal femto_tpu's after every
call:

  * the row-tier store (``bwt``: codes, symbol list, marks and relative
    checkpoints per row, most of a vseg/vrle index's bytes) stays on the
    host, an np.memmap over the flat .ftpu file, so it may exceed host
    memory and page from disk;
  * a fixed-budget device row cache uint32[cache_rows, W] holds recently
    served segments; FMArrays.seg_slot (int32[n_seg], slot 0 a dummy row)
    maps true segment ids to cache slots, and every serving kernel reads
    its rows through it (csrc/fm_common.cuh row_of, ops/rank._rows);
  * queries run as host-driven steps, one device dispatch per pattern
    column or LF step (kernel C's masked step, kernel D's lf_walk_step and
    one-step extract, resolve_marks at the end); before each dispatch the
    host faults in the segments of every lane's rows with one gather from
    the memmap into pinned memory, one asynchronous copy and one cache
    update (kernel T, csrc/paged.cu).  Eviction is a FIFO clock over the
    slots [1, cache_rows), skipping the slots whose segments the same
    dispatch needs.

The small arrays (C, occ_l1, alphabet maps, marks, seg_nsym, seg_woff,
seg_ovf, seg_cont, doc arrays) stay resident on the device.  Only the row
tiers page: one row per segment pages codes, marks and checkpoints at
once.  Context extraction is not served over the cache (search.py
raises): femto_tpu's returns wrong bytes there.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .alphabet import CHARACTER_OFFSET, pattern_to_alpha
from .fmindex import (FMArrays, FMIndex, FMMeta, _check_row_tier_layout,
                      _to_device, resolve_device)
from .ops import paged_ops as PO
from .ops import search_ops as S

Device = Union[str, torch.device]

# host entries of a saved index, which stay on the host
_HOST_ENTRIES = ("bwt", "doc_starts_np", "header_lens_np",
                 "chunk_doc_offsets_np", "chunk_docs_np", "sa_direct")


def _bucket(x: int, minimum: int = 64) -> int:
    b = minimum
    while b < x:
        b *= 2
    return b


class _Staging:
    """Pinned host buffers for the fault uploads (plain ones for a CPU
    index), grown to the largest batch, and the event of the last copy
    made from them: a refill waits for it, so no copy reads a buffer that
    is being refilled."""

    def __init__(self, dev: torch.device, W: int):
        self.dev, self.W = dev, W
        self.rows = self.idx = None
        self.event = None

    def upload(self, bwt_np: np.ndarray, miss: np.ndarray,
               idx: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rows bwt_np[miss] uint32[m, W], idx int32) on the device."""
        m = len(miss)
        if self.dev.type == "cpu":
            rows = torch.from_numpy(np.ascontiguousarray(bwt_np[miss]))
            return rows, torch.from_numpy(idx)
        if self.event is not None:
            self.event.synchronize()
        if self.rows is None or self.rows.shape[0] < m:
            cap = _bucket(m)
            self.rows = torch.empty((cap, self.W), dtype=torch.int32,
                                    pin_memory=True)
            self.idx = torch.empty(3 * cap, dtype=torch.int32,
                                   pin_memory=True)
        np.take(bwt_np, miss, axis=0,
                out=self.rows[:m].numpy().view(np.uint32))
        self.idx[:len(idx)].numpy()[:] = idx
        rows = self.rows[:m].to(self.dev, non_blocking=True)
        ids = self.idx[:len(idx)].to(self.dev, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record()
        return rows.view(torch.uint32), ids


class PagedIndex:
    """Serve a row-tier index larger than the device-memory budget.

    Duck-types the FMIndex surface the query layer needs (search.py
    dispatches count_ranges, locate_range, locate_rows_array and
    extract_document here); ``stats`` counts faults, hits, fetched bytes
    and dispatches, as femto_tpu's does."""

    def __init__(self, meta: FMMeta, infos: List[bytes], arrs: dict,
                 budget_bytes: int,
                 doc_starts_np: Optional[np.ndarray] = None,
                 header_lens_np: Optional[np.ndarray] = None, *,
                 device: Device = "cuda"):
        if "seg_nsym" not in arrs:
            raise ValueError(
                "paged serving supports the row tiers (vseg/vrle); "
                "rebuild with tier='vrle' (the big-corpus tier)")
        _check_row_tier_layout(arrs)
        if "mark_meta" not in arrs:
            raise ValueError("this index stores raw int32 mark values (a "
                             "legacy layout); rebuild it with the current "
                             "version")
        dev = resolve_device(device)
        self.meta = meta
        self.infos = infos
        self.bwt_np = arrs["bwt"]                    # host / memmap
        n_seg, W = self.bwt_np.shape
        row_bytes = W * 4
        resident = {}
        resident_bytes = 0
        for k, v in arrs.items():
            if k in _HOST_ENTRIES:
                continue
            resident[k] = _to_device(np.asarray(v), dev)
            resident_bytes += v.nbytes
        map_bytes = n_seg * 4
        # the budget is best-effort: resident arrays + a minimum useful
        # cache (256 rows) are always allocated, else no batch could run
        cache_rows = max(
            256, (budget_bytes - resident_bytes - map_bytes) // row_bytes)
        cache_rows = min(cache_rows, n_seg + 1)
        self.cache_rows = int(cache_rows)
        self._cache = torch.zeros((self.cache_rows, W), dtype=torch.int32,
                                  device=dev).view(torch.uint32)
        self._slot_map = torch.zeros(n_seg, dtype=torch.int32, device=dev)
        self._slot_map_np = np.zeros(n_seg, np.int32)
        self._slot_seg = np.zeros(self.cache_rows, np.int64)  # slot -> seg+1
        self._clock = 1
        self._staging = _Staging(dev, W)
        # the cache and the map are updated in place: these arrays stay
        self.arrays = FMArrays(
            bwt=self._cache, seg_slot=self._slot_map, **resident)
        self.doc_starts_np = (
            np.asarray(doc_starts_np) if doc_starts_np is not None
            else np.asarray(arrs["doc_starts_np"]))
        self.header_lens_np = header_lens_np
        if header_lens_np is None and "header_lens_np" in arrs:
            self.header_lens_np = np.asarray(arrs["header_lens_np"])
        # the host-side engine surface (query/engine works against a
        # PagedIndex through the search.py dispatch points)
        self.chunk_doc_offsets_np = (
            np.asarray(arrs["chunk_doc_offsets_np"])
            if "chunk_doc_offsets_np" in arrs else None)
        self.chunk_docs_np = (np.asarray(arrs["chunk_docs_np"])
                              if "chunk_docs_np" in arrs else None)
        self.sa_direct = None
        self.stats = {"faults": 0, "hits": 0, "fetched_bytes": 0,
                      "dispatches": 0}
        # host seconds in the fault path (the gather into staging, the
        # wait for the previous copy, the copy's and the update's launch)
        self.fault_seconds = 0.0

    @property
    def device(self) -> torch.device:
        return self._cache.device

    # ---- cache management ----

    def _clock_slots(self, segs: np.ndarray, k: int) -> np.ndarray:
        """The next k slots of the FIFO clock, skipping the slots whose
        tenant is in segs (sorted): femto_tpu's one-slot-at-a-time loop,
        scanned in windows.  segs fits the cache, so k slots are free
        within one turn of the clock."""
        turn = self.cache_rows - 1
        found = []
        scanned = 0
        while k > 0:
            w = min(max(2 * k, 64), turn - scanned)
            if w <= 0:
                raise AssertionError("the clock found too few free slots")
            cand = (self._clock - 1 + scanned + np.arange(w)) % turn + 1
            tenant = self._slot_seg[cand] - 1
            at = np.minimum(np.searchsorted(segs, tenant), len(segs) - 1)
            free = cand[(tenant < 0) | (segs[at] != tenant)][:k]
            found.append(free)
            k -= len(free)
            scanned += w
        slots = np.concatenate(found)
        nxt = int(slots[-1]) + 1
        self._clock = nxt if nxt < self.cache_rows else 1
        return slots

    def _ensure(self, segs: np.ndarray) -> None:
        """Fault in every segment of `segs` (true ids, any shape)."""
        segs = np.unique(segs)
        segs = segs[(segs >= 0) & (segs < self.bwt_np.shape[0])]
        miss = segs[self._slot_map_np[segs] == 0]
        self.stats["hits"] += len(segs) - len(miss)
        if len(miss) == 0:
            return
        if len(segs) > self.cache_rows - 1:
            raise ValueError(
                f"batch touches {len(segs)} segments but the cache holds "
                f"{self.cache_rows - 1}; raise the budget or lower the "
                f"batch size")
        # FIFO clock allocation over slots [1, cache_rows), skipping slots
        # whose tenant is part of THIS dispatch's demand (evicting a hit
        # segment mid-step would feed the dispatch a dummy row)
        slots = self._clock_slots(segs, len(miss))
        evict = self._slot_seg[slots]          # seg+1 of previous tenants
        evict_segs = evict[evict > 0] - 1
        # host bookkeeping
        self._slot_map_np[evict_segs] = 0
        self._slot_map_np[miss] = slots
        self._slot_seg[slots] = miss + 1
        # one host->device copy per fault batch: the rows, then the slots,
        # the fetched and the evicted segments in one index buffer
        t0 = time.perf_counter()
        m, k = len(miss), len(evict_segs)
        rows, ids = self._staging.upload(
            self.bwt_np, miss,
            np.concatenate([slots, miss, evict_segs]).astype(np.int32))
        PO.apply_faults(self._cache, self._slot_map, ids[:m], rows,
                        ids[2 * m:2 * m + k], ids[m:2 * m])
        self.fault_seconds += time.perf_counter() - t0
        self.stats["faults"] += m
        self.stats["fetched_bytes"] += m * self.bwt_np.shape[1] * 4

    def _segs_of_rows(self, rows: np.ndarray) -> np.ndarray:
        seg = self.meta.seg
        n_seg = self.bwt_np.shape[0]
        return np.minimum(rows // seg, n_seg - 1)

    def _ensure_rows(self, rows: np.ndarray) -> None:
        """Fault in the segments the given rows touch (the pre-dispatch
        hook the host regexp engine calls, query/regexp._backward_step)."""
        self._ensure(self._segs_of_rows(np.asarray(rows, np.int64)))

    # ---- queries (host-driven steps) ----

    def _batch_cap(self) -> int:
        """Rows per sub-batch so one dispatch's worst-case segment demand
        (one segment per lane-bound) always fits the cache."""
        return max(16, (self.cache_rows - 1) // 2)

    def _i32(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device)

    def count_ranges(self, patterns: Sequence[bytes]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched count: one device dispatch per pattern column, with the
        segment demand faulted in before each dispatch.  Batches bigger
        than the cache capacity split into sub-batches."""
        from .search import pack_patterns

        if not patterns:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cap = self._batch_cap()
        if len(patterns) > cap:
            outs = [self.count_ranges(patterns[i:i + cap])
                    for i in range(0, len(patterns), cap)]
            return (np.concatenate([o[0] for o in outs]),
                    np.concatenate([o[1] for o in outs]))
        pats, B = pack_patterns([pattern_to_alpha(p) for p in patterns])
        Bp, P = pats.shape
        first_np = np.full(Bp, self.meta.row0, np.int32)
        last_np = np.full(Bp, self.meta.n_rows, np.int32)
        first, last = self._i32(first_np), self._i32(last_np)
        pats_d = self._i32(pats.T.copy())            # one column a row
        for t in range(P - 1, -1, -1):
            if (pats[:, t] < 0).all():
                continue
            self._ensure(np.concatenate([
                self._segs_of_rows(first_np), self._segs_of_rows(last_np)]))
            first, last = S.backward_step_masked(self.arrays, pats_d[t],
                                                 first, last)
            self.stats["dispatches"] += 1
            both = torch.stack([first, last]).cpu().numpy()
            first_np, last_np = both[0], both[1]
        return first_np[:B].astype(np.int64), last_np[:B].astype(np.int64)

    def count(self, patterns: Sequence[bytes]) -> np.ndarray:
        f, l = self.count_ranges(patterns)
        return l - f

    def locate_range(self, first: int, last: int,
                     max_matches: Optional[int] = None) -> np.ndarray:
        m = int(last - first)
        if max_matches is not None:
            m = min(m, max_matches)
        if m <= 0:
            return np.zeros(0, np.int64)
        return self.locate_rows_array(
            np.arange(first, first + m, dtype=np.int32))

    def locate_rows_array(self, rows: np.ndarray) -> np.ndarray:
        """Mark-walk locate, host-driven: fault + dispatch per LF step.
        Batches bigger than the cache capacity split into sub-batches."""
        m = len(rows)
        if m == 0:
            return np.zeros(0, np.int64)
        cap = self._batch_cap()
        if m > cap:
            return np.concatenate([
                self.locate_rows_array(rows[i:i + cap])
                for i in range(0, m, cap)])
        Bp = _bucket(m)
        rows_np = np.zeros(Bp, np.int32)
        rows_np[:m] = rows
        rows_d = self._i32(rows_np)
        granks = torch.zeros(Bp, dtype=torch.int32, device=self.device)
        steps = torch.zeros_like(granks)
        done = torch.zeros(Bp, dtype=torch.bool, device=self.device)
        done_np = np.zeros(Bp, bool)
        i = 0
        while i <= self.meta.mark_period and not done_np.all():
            self._ensure(self._segs_of_rows(rows_np[~done_np]))
            rows_d, granks, steps, done = S.lf_walk_step(
                self.arrays, rows_d, granks, steps, done, i)
            self.stats["dispatches"] += 1
            state = torch.stack([rows_d, done.to(torch.int32)]).cpu().numpy()
            rows_np, done_np = state[0], state[1].astype(bool)
            i += 1
        offs = S.resolve_marks(self.arrays, granks, steps).cpu().numpy()
        return offs[:m].astype(np.int64)

    def locate(self, pattern: bytes,
               max_matches: Optional[int] = None
               ) -> List[Tuple[int, int]]:
        from .search import offsets_to_docs

        f, l = self.count_ranges([pattern])
        offs = self.locate_range(int(f[0]), int(l[0]), max_matches)
        doc, doc_off = offsets_to_docs(self, offs)
        return sorted(zip(doc.tolist(), doc_off.tolist()))

    def extract_document(self, doc_id: int) -> bytes:
        """Self-indexing extraction, host-driven: one faulted LF step per
        character (search.extract_document semantics)."""
        dlen = int(self.doc_starts_np[doc_id + 1]
                   - self.doc_starts_np[doc_id]) - 1
        if self.header_lens_np is not None:
            dlen -= int(self.header_lens_np[doc_id])
        if dlen <= 0:
            return b""
        rows_d = self.arrays.doc_seof_rows[doc_id:doc_id + 1].contiguous()
        rows_np = rows_d.cpu().numpy().astype(np.int64)
        out = np.empty(dlen, np.int64)
        for t in range(dlen):
            self._ensure(self._segs_of_rows(rows_np))
            chars, rows_d = S.extract_backward(self.arrays, rows_d, 1)
            self.stats["dispatches"] += 1
            both = torch.cat([chars[:, 0], rows_d]).cpu().numpy()
            out[t] = both[0]
            rows_np = both[1:].astype(np.int64)
        return (out[::-1] - CHARACTER_OFFSET).astype(np.uint8).tobytes()


def load_paged(path: str, budget_bytes: Optional[int] = None, *,
               device: Device = "cuda") -> PagedIndex:
    """Open a flat .ftpu row-tier index for paged serving on ``device``:
    the rows stay on disk (np.memmap), the device holds `budget_bytes` of
    cache and the small resident arrays.  The budget defaults to
    FEMTO_TPU_HBM_BUDGET (bytes; 1 GiB when unset)."""
    if budget_bytes is None:
        budget_bytes = int(os.environ.get(
            "FEMTO_TPU_HBM_BUDGET", str(1 << 30)))
    meta, infos, arrs = FMIndex.parse_flat(path)
    return PagedIndex(meta, infos, arrs, budget_bytes, device=device)


def load_auto(path: str, budget_bytes: Optional[int] = None, *,
              device: Device = "cuda"):
    """FMIndex.load, unless the index's arrays exceed the (optional)
    device budget: then a PagedIndex.  The budget comes from the argument
    or FEMTO_TPU_HBM_BUDGET; with neither set, always resident."""
    if budget_bytes is None:
        env = os.environ.get("FEMTO_TPU_HBM_BUDGET")
        budget_bytes = int(env) if env else None
    if budget_bytes is not None and os.path.isfile(path):
        meta, infos, arrs = FMIndex.parse_flat(path)
        total = sum(v.nbytes for v in arrs.values())
        if total > budget_bytes and "seg_nsym" in arrs:
            return PagedIndex(meta, infos, arrs, budget_bytes, device=device)
    return FMIndex.load(path, device=device)
