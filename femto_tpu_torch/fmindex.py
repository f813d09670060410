"""FM-index container, persistence and the single-device build (PyTorch).

The counterpart of femto_tpu/fmindex.py for its five storage tiers (full,
compact, packed, vseg, vrle): the same array fields with the same dtypes
and shapes (bit for bit what femto_tpu builds), held as torch tensors on
one device:

  * bwt       uint16[n_seg, seg] BWT symbols, INVALID_ALPHA past row n
              (full, compact) | uint32[n_seg, W] dense codes bit-packed
              32 // bits to a word, pad code all ones (packed) |
              uint32[n_seg, total] one serving row per segment (vseg,
              vrle; ops/rank.VsegGeom): the code area, the segment's
              sorted symbol list, its mark words, its mark checkpoint and
              its uint16-relative occ checkpoints;
  * occ_ckpt  int32[n_seg, 261] occurrences of c in BWT[0 : s*seg) (full)
              | uint16[n_seg, K] relative to occ_l1 int32[n_seg/grp, K],
              the checkpoint of every grp-th segment (compact, packed;
              grp = l1_group_for(seg), n_seg a multiple of it);
  * C         int32[K+1]: C[c] = number of codes < c (K = 261, or the
              packed tier's dense alphabet size);
  * alpha_map int32[261] symbol -> dense code or -1, alpha_rev int32[K]
              (identity on the full and compact tiers);
  * mark_bits uint32[n_seg, seg/32], mark_ckpt int32[n_seg]: sampled rows;
  * mark_vals uint32[...] + mark_meta int32[5]: bit-packed mark values
    (ops/build_ops.mark_pack_geom);
  * doc_starts int32[ndocs+1], doc_seof_rows int32[ndocs];
  * row tiers only: seg_nsym uint8[n_seg] symbols per segment (255 above
    the list's capacity); seg_woff int32[n_seg]: 0 fixed-width codes,
    > 0 the 1-based row of the side table seg_ovf uint32[n_ovf+1, Ws]
    (global codes; row 0 zeros), -1 RLE slots, -(2 + word offset) RLE
    slots continued in the flat store seg_cont uint32[X, 16]; seg_syms
    a [1, S] u8/u16 marker (list length and symbol dtype), seg_rle a
    [scheme, w_main] int32 marker of the vrle tier.  occ_ckpt,
    mark_bits and mark_ckpt are one-row dummies there: their rows live
    inside bwt.

Indexes persist as femto_tpu's .npz directories (save / load) and its
single-file .ftpu format (save_flat / parse_flat / load_flat), byte for
byte.  Entry points take an explicit ``device`` (default ``"cuda"``) and
raise when the card is asked for and absent; they never fall back to the
CPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .alphabet import (ALPHA_SIZE, CHARACTER_OFFSET, EOH, SEOF, SOH,
                       PreparedText)

DEFAULT_SEG = 256
DEFAULT_MARK_PERIOD = 20
L1_GROUP = 16  # segments per L1 checkpoint group (compact tiers)
TIERS = ("full", "compact", "packed", "vseg", "vrle")

# Fields that only paged serving (paged.PagedIndex) sets; no saved index
# carries them.
_OTHER_TIER_FIELDS = ("seg_slot",)


def l1_group_for(seg: int) -> int:
    """L1 group size for a segment length: the uint16 relative
    checkpoints must stay below 65536 within one group, so large segments
    halve the group (seg=4096 -> 8; the serving side derives it from
    array shapes, ops/rank._l1_grp)."""
    g = L1_GROUP
    while g > 1 and seg * g > 0xFFFF:
        g //= 2
    if seg * g > 0xFFFF:
        raise ValueError("segment too large for uint16 checkpoints")
    return g


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """torch.device for an entry point's ``device`` argument; raises when
    CUDA is asked for and torch sees no card (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' but torch.cuda.is_available() is false; pass "
                "device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


class FMArrays(NamedTuple):
    """Device tensors of the index (femto_tpu.fmindex.FMArrays' fields).

    Paged serving (paged.PagedIndex, row tiers only) sets seg_slot: bwt is
    then the device row cache uint32[cache_rows, total] and seg_slot
    int32[n_seg] maps each true segment id to its cache slot (slot 0 a
    dummy row); every other field is indexed by the true id."""

    bwt: torch.Tensor        # uint16[n_seg, seg] | uint32[n_seg, W] packed
    #                          | uint32[n_seg, total] rows (vseg, vrle)
    occ_ckpt: torch.Tensor   # int32[n_seg, 261] | uint16[n_seg, K] relative
    #                          | uint16[1, K] marker (vseg, vrle)
    occ_l1: torch.Tensor     # int32[n_seg/grp, K] | int32[1, 261] dummy
    C: torch.Tensor          # int32[K+1]
    mark_bits: torch.Tensor  # uint32[n_seg, seg//32] | [1, seg//32]
    mark_ckpt: torch.Tensor  # int32[n_seg] | [1]
    mark_vals: torch.Tensor  # uint32[n_words + exc_cap]
    doc_starts: torch.Tensor     # int32[ndocs+1]
    doc_seof_rows: torch.Tensor  # int32[ndocs]
    alpha_map: torch.Tensor  # int32[261] symbol -> dense code | -1
    alpha_rev: torch.Tensor  # int32[K] dense code -> symbol
    seg_ovf: Optional[torch.Tensor] = None   # uint32[n_ovf+1, Ws]
    seg_nsym: Optional[torch.Tensor] = None  # uint8[n_seg]
    seg_woff: Optional[torch.Tensor] = None  # int32[n_seg]
    seg_syms: Optional[torch.Tensor] = None  # uint8|uint16[1, S] marker
    mark_meta: Optional[torch.Tensor] = None  # int32[5]
    seg_rle: Optional[torch.Tensor] = None   # int32[scheme, w_main] marker
    seg_cont: Optional[torch.Tensor] = None  # uint32[X, G] flat store
    seg_slot: Optional[torch.Tensor] = None  # int32[n_seg] (paged)


@dataclasses.dataclass(frozen=True)
class FMMeta:
    """Static metadata (femto_tpu.fmindex.FMMeta)."""

    n: int            # real text length (symbols)
    seg: int          # rows per segment
    mark_period: int
    num_docs: int
    n_marks: int
    n_seg: int = 0
    alpha_used: int = 0
    n_rows: int = 0   # total rows (n, or n_pad for padded builds)
    row0: int = 0     # first real row (= n_rows - n)

    def __post_init__(self):
        if self.n_seg == 0:
            object.__setattr__(self, "n_seg", self.n // self.seg + 1)
        if self.n_rows == 0:
            object.__setattr__(self, "n_rows", self.n)


@dataclasses.dataclass
class FMIndex:
    """Device tensors + static meta + host-side metadata."""

    arrays: FMArrays
    meta: FMMeta
    doc_starts_np: np.ndarray  # int64[ndocs+1]
    infos: List[bytes]
    header_lens_np: Optional[np.ndarray] = None
    chunk_doc_offsets_np: Optional[np.ndarray] = None
    chunk_docs_np: Optional[np.ndarray] = None
    sa_direct: Optional[torch.Tensor] = None  # int32[n], locate="direct"
    # a sharded index's K18f owner_lf view (ops/dist_ops.owner_lf_view),
    # made on its first routed locate (parallel/dist_query.py) and kept
    # with the arrays and the shard size it was made for
    owner_lf_view: Optional[tuple] = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def n(self) -> int:
        return self.meta.n

    @property
    def num_docs(self) -> int:
        return self.meta.num_docs

    @property
    def device(self) -> torch.device:
        return self.arrays.bwt.device

    def _meta_json(self) -> dict:
        meta = dataclasses.asdict(self.meta)
        meta["infos"] = [i.decode("utf-8", "surrogateescape")
                         for i in self.infos]
        return meta

    def _host_arrays(self) -> "dict[str, np.ndarray]":
        """Every array of the index as host numpy, in femto_tpu's order:
        the FMArrays fields, then the host entries."""
        arrs = {k: v.cpu().numpy() for k, v in self.arrays._asdict().items()
                if v is not None}
        arrs["doc_starts_np"] = self.doc_starts_np
        if self.header_lens_np is not None:
            arrs["header_lens_np"] = self.header_lens_np
        if self.chunk_docs_np is not None:
            arrs["chunk_doc_offsets_np"] = self.chunk_doc_offsets_np
            arrs["chunk_docs_np"] = self.chunk_docs_np
        if self.sa_direct is not None:
            arrs["sa_direct"] = self.sa_direct.cpu().numpy()
        return arrs

    def save(self, path: str) -> None:
        """Write meta.json + arrays.npz in femto_tpu's directory format."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(self._meta_json(), f)
        np.savez(os.path.join(path, "arrays.npz"), **self._host_arrays())

    @classmethod
    def load(cls, path: str, device: Union[str, torch.device] = "cuda"
             ) -> "FMIndex":
        """Load an index directory or .ftpu file written by either
        package."""
        if os.path.isfile(path):
            return cls.load_flat(path, device=device)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            arrs = {k: z[k] for k in z.files}
        return arrays_from_numpy(arrs, meta, device=device)

    # ---- femto_tpu's single-file flat format (.ftpu) ----

    MAGIC = b"FTPU0001"
    PAGE = 4096

    def save_flat(self, path: str, compress: bool = False) -> None:
        """Write the index as one page-aligned file, byte for byte what
        femto_tpu's FMIndex.save_flat writes: MAGIC, the header length
        (8 bytes, little-endian), a JSON header {"meta", "arrays"} padded
        to a whole page, then each array's bytes (zlib level 6 with
        compress=True) padded to a page."""
        meta = self._meta_json()
        manifest, blobs = [], []
        for name, a in self._host_arrays().items():
            a = np.ascontiguousarray(a)
            entry = {"name": name, "dtype": str(a.dtype),
                     "shape": list(a.shape)}
            b = a.tobytes()
            if compress:
                b = zlib.compress(b, level=6)
                entry["codec"] = "zlib"
                entry["csize"] = len(b)
            manifest.append(entry)
            blobs.append(b)
        # offsets from a conservative header size, then one write
        probe = json.dumps({"meta": meta, "arrays": manifest}).encode()
        hdr_reserve = -(-(len(self.MAGIC) + 8 + len(probe) + 24 * len(manifest))
                        // self.PAGE) * self.PAGE
        off = hdr_reserve
        for m, b in zip(manifest, blobs):
            m["offset"] = off
            off += len(b) + ((-len(b)) % self.PAGE)
        hj = json.dumps({"meta": meta, "arrays": manifest}).encode()
        if len(self.MAGIC) + 8 + len(hj) > hdr_reserve:
            raise AssertionError("flat header outgrew its reserve")
        with open(path, "wb") as f:
            f.write(self.MAGIC)
            f.write(len(hj).to_bytes(8, "little"))
            f.write(hj)
            f.write(b"\0" * (hdr_reserve - len(self.MAGIC) - 8 - len(hj)))
            for b in blobs:
                f.write(b)
                f.write(b"\0" * ((-len(b)) % self.PAGE))

    @classmethod
    def parse_flat(cls, path: str):
        """Parse a .ftpu file without uploading anything: (meta, infos,
        arrays), the arrays host numpy views (read-only np.memmap for
        uncompressed blobs, inflated buffers for zlib ones)."""
        with open(path, "rb") as f:
            if f.read(len(cls.MAGIC)) != cls.MAGIC:
                raise ValueError("not a FTPU flat index file")
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen))
        meta_d = header["meta"]
        infos = [s.encode("utf-8", "surrogateescape")
                 for s in meta_d.pop("infos")]
        meta = FMMeta(**meta_d)
        arrs = {}
        for m in header["arrays"]:
            dtype, shape = np.dtype(m["dtype"]), tuple(m["shape"])
            if m.get("codec") == "zlib":
                with open(path, "rb") as f:
                    f.seek(m["offset"])
                    raw = zlib.decompress(f.read(m["csize"]))
                arrs[m["name"]] = np.frombuffer(raw, dtype=dtype).reshape(
                    shape)
            else:
                arrs[m["name"]] = np.memmap(path, dtype=dtype, mode="r",
                                            offset=m["offset"], shape=shape)
        return meta, infos, arrs

    @classmethod
    def load_flat(cls, path: str, device: Union[str, torch.device] = "cuda"
                  ) -> "FMIndex":
        """Load a .ftpu file onto ``device`` (arrays_from_numpy)."""
        meta, infos, arrs = cls.parse_flat(path)
        return arrays_from_numpy(arrs, meta, device=device, infos=infos)


def _to_device(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    # torch wants writable memory; read-only arrays (a JAX array's numpy
    # view, say) are copied
    return torch.from_numpy(np.require(a, requirements=["C", "W"])).to(dev)


def _check_row_tier_layout(arrays: Mapping[str, np.ndarray]) -> None:
    """Refuse the row-tier layouts this port does not serve, with a clear
    error: the obsolete vseg layout (femto_tpu's _check_layout), u8 vrle
    slots (marker leading dim 2) and the per-row continuation table
    (marker dim 3 with a many-row seg_cont)."""
    if "seg_nsym" not in arrays:
        return
    if "seg_ovf" not in arrays or arrays["bwt"].ndim != 2:
        raise ValueError("this vseg index uses an obsolete on-disk layout; "
                         "rebuild it with the current version (tier='vseg')")
    for k in ("seg_woff", "seg_syms"):
        if k not in arrays:
            raise ValueError(f"row-tier index without {k!r}")
    if "seg_rle" not in arrays:
        return
    scheme = arrays["seg_rle"].shape[0]
    if scheme == 2:
        raise ValueError("this vrle index stores u8 RLE slots (a legacy "
                         "layout); rebuild it with the current version "
                         "(tier='vrle')")
    from .ops.build_ops import VRLE_CONT_G

    # a sharded build keeps an unread store of zero granule rows, one a
    # shard, when no segment is continued
    cont = arrays.get("seg_cont")
    unread = (cont is not None and cont.ndim == 2
              and cont.shape[1] == VRLE_CONT_G and not cont.any())
    if cont is None or (scheme == 3 and cont.shape[0] > 1 and not unread):
        raise ValueError("this vrle index keeps a per-row continuation "
                         "table (a legacy layout); rebuild it with the "
                         "current version (tier='vrle')")


def arrays_from_numpy(arrays: Mapping[str, np.ndarray], meta: Any, *,
                      device: Union[str, torch.device] = "cuda",
                      infos: Optional[List[bytes]] = None) -> FMIndex:
    """Carry an index across: numpy arrays named after femto_tpu's FMArrays
    fields (plus the .npz host entries doc_starts_np, header_lens_np,
    chunk_doc_offsets_np, chunk_docs_np, sa_direct where present) and the
    FMMeta fields (a mapping, or any object with those attributes) -> the
    port's FMIndex on ``device``.  Indexes of every storage tier are
    taken (a seg_slot array, which only paged.PagedIndex sets, is
    refused); bits are kept as they are: uint8,
    uint16 and uint32 arrays stay uint8, uint16 and uint32 tensors.  ``infos`` defaults to meta["infos"] (a .npz
    directory's meta.json) or doc<i> names."""
    dev = resolve_device(device)
    if not isinstance(meta, Mapping):
        meta = {f.name: getattr(meta, f.name)
                for f in dataclasses.fields(FMMeta)}
    arrays = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    for k in _OTHER_TIER_FIELDS:
        if k in arrays:
            raise NotImplementedError(
                f"index field {k!r} belongs to paged serving: open the "
                f"index's .ftpu file with paged.PagedIndex (paged.load_paged "
                f"or paged.load_auto)")
    layout = (arrays["bwt"].dtype, arrays["occ_ckpt"].dtype)
    if layout not in ((np.uint16, np.int32), (np.uint16, np.uint16),
                      (np.uint32, np.uint16)):
        raise ValueError(f"unknown index layout (bwt, occ_ckpt) dtypes "
                         f"{layout}")
    _check_row_tier_layout(arrays)
    if "mark_meta" not in arrays:
        raise ValueError("this index stores raw int32 mark values (a legacy "
                         "layout); rebuild it with the current version")
    arrays.setdefault("occ_l1", np.zeros((1, ALPHA_SIZE), np.int32))
    arrays.setdefault("alpha_map", np.arange(ALPHA_SIZE, dtype=np.int32))
    arrays.setdefault("alpha_rev", np.arange(ALPHA_SIZE, dtype=np.int32))
    fm = FMArrays(**{k: _to_device(arrays[k], dev) for k in FMArrays._fields
                     if k in arrays})
    meta_fields = {f.name for f in dataclasses.fields(FMMeta)}
    fm_meta = FMMeta(**{k: int(v) for k, v in meta.items()
                        if k in meta_fields})
    if infos is None:
        if "infos" in meta:
            infos = [s.encode("utf-8", "surrogateescape") if isinstance(s, str)
                     else bytes(s) for s in meta["infos"]]
        else:
            infos = [b"doc%d" % i for i in range(fm_meta.num_docs)]
    doc_starts_np = arrays.get("doc_starts_np")
    if doc_starts_np is None:
        doc_starts_np = arrays["doc_starts"][: fm_meta.num_docs + 1]
    return FMIndex(
        arrays=fm, meta=fm_meta,
        doc_starts_np=np.asarray(doc_starts_np, dtype=np.int64),
        infos=list(infos),
        header_lens_np=arrays.get("header_lens_np"),
        chunk_doc_offsets_np=arrays.get("chunk_doc_offsets_np"),
        chunk_docs_np=arrays.get("chunk_docs_np"),
        sa_direct=(_to_device(arrays["sa_direct"], dev)
                   if "sa_direct" in arrays else None),
    )


def compute_chunk_doc_lists(sa_np: np.ndarray, doc_starts: np.ndarray,
                            seg: int, n_seg: int):
    """Per-segment sorted unique doc ids, host numpy
    (femto_tpu.fmindex.compute_chunk_doc_lists): (offsets int64[n_seg+1],
    docs int32[total]).  The host oracle of build_doc_lists_device."""
    n = len(sa_np)
    doc_of = (
        np.searchsorted(doc_starts.astype(np.int64), sa_np, side="right") - 1
    )
    pad = n_seg * seg - n
    d2 = np.concatenate([doc_of, np.full(pad, -1, dtype=doc_of.dtype)])
    d2 = np.sort(d2.reshape(n_seg, seg), axis=1)
    uniq = np.ones_like(d2, dtype=bool)
    uniq[:, 1:] = d2[:, 1:] != d2[:, :-1]
    uniq &= d2 >= 0
    counts = uniq.sum(axis=1)
    offsets = np.zeros(n_seg + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, d2[uniq].astype(np.int32)


def _escape_positions(prepared: PreparedText, ndocs_build: int):
    """(seof_pos, soh_pos, eoh_pos) int32[ndocs_build] for the uint8 text
    upload (femto_tpu.fmindex._escape_positions): each document's SEOF and
    its header's SOH and EOH positions, padded with INT32_MAX (outside
    every text, dropped by expand_u8).  None when the text holds escape
    symbols that the document layout does not place (a PreparedText built
    by hand): then the text cannot ship as content bytes, and the caller
    uploads it as uint16."""
    starts = prepared.doc_starts
    ndocs = prepared.num_docs
    seof = (starts[1:] - 1).astype(np.int64)
    n_hdr = 0
    soh = eoh = None
    if prepared.header_lens is not None:
        h = prepared.header_lens
        hd = np.flatnonzero(h > 0)
        n_hdr = len(hd)
        soh = starts[hd]
        eoh = starts[hd] + h[hd] - 1
    text = prepared.text
    if not (
        np.all(text[seof] == SEOF)
        and (n_hdr == 0 or (np.all(text[soh] == SOH)
                            and np.all(text[eoh] == EOH)))
        and int(np.count_nonzero(text < CHARACTER_OFFSET))
        == ndocs + 2 * n_hdr
    ):
        return None

    def pad(a):
        out = np.full(ndocs_build, np.iinfo(np.int32).max, np.int32)
        if a is not None:
            out[: len(a)] = a.astype(np.int32)
        return out

    return pad(seof), pad(soh), pad(eoh)


def _on_device(t: torch.Tensor, dev: torch.device) -> bool:
    """t lies on dev ("cuda" stands for the current card)."""
    return t.device.type == dev.type and (dev.index is None
                                          or t.device.index == dev.index)


def _device_text(prepared: PreparedText, n_build: int, dev: torch.device,
                 text_dev16: Optional[torch.Tensor],
                 text_dev32: Optional[torch.Tensor]) -> torch.Tensor:
    """The build's int32[n_build] text on ``dev``: text_dev32 as it is,
    text_dev16 widened, else the prepared text uploaded as its uint16 bits
    (symbols < 261 fit int16) and widened, padded with 0 to n_build."""
    if text_dev32 is not None:
        if (tuple(text_dev32.shape) != (n_build,)
                or text_dev32.dtype != torch.int32):
            raise ValueError("text_dev32 must be int32[n_build]")
        if not _on_device(text_dev32, dev):
            raise ValueError(f"text_dev32 lies on {text_dev32.device}, the "
                             f"build on {dev}")
        return text_dev32.contiguous()
    if text_dev16 is None:
        t = prepared.text.astype(np.uint16, copy=False)
        if n_build > prepared.n:
            t = np.concatenate([t, np.zeros(n_build - prepared.n, np.uint16)])
        text_dev16 = torch.from_numpy(
            np.ascontiguousarray(t).view(np.int16)).to(dev)
    elif (tuple(text_dev16.shape) != (n_build,)
          or text_dev16.dtype not in (torch.uint16, torch.int16)):
        raise ValueError("text_dev16 must be uint16[n_build]")
    elif not _on_device(text_dev16, dev):
        raise ValueError(f"text_dev16 lies on {text_dev16.device}, the "
                         f"build on {dev}")
    # the card has few uint16 ops: widen the int16 view of the same bits
    if text_dev16.dtype == torch.uint16:
        text_dev16 = text_dev16.view(torch.int16)
    return text_dev16.to(torch.int32)


def build_index(
    prepared: PreparedText,
    seg: int = DEFAULT_SEG,
    mark_period: int = DEFAULT_MARK_PERIOD,
    sa: Optional[np.ndarray] = None,
    device_build: bool = True,
    checkpoint_dir: Optional[str] = None,
    compact: bool = False,
    doc_chunks: bool = False,
    tier: Optional[str] = None,
    locate: str = "walk",
    pad_shape: Optional[Tuple[int, int]] = None,
    text_dev16: Optional[torch.Tensor] = None,
    text_dev32: Optional[torch.Tensor] = None,
    *,
    device: Union[str, torch.device] = "cuda",
) -> FMIndex:
    """Single-device index build: suffix sort and packaging on ``device``
    (femto_tpu.fmindex.build_index, the same positional parameters).

    tier: "full" (default), "compact" (uint16 relative checkpoints;
    compact=True spells it too), "packed" (compact checkpoints over the
    corpus's dense alphabet and a bit-packed BWT), "vseg" (one serving
    row per segment: local codes at one width, overflow segments in a
    side table) or "vrle" (the vseg row with run-length slots where they
    are smaller).  locate: "walk"
    (mark-sampled LF walk) or "direct" (keep the suffix array on the
    device: locate = one gather).  sa: optional precomputed suffix array
    (skips the sort).

    checkpoint_dir: the suffix array is kept there as sa_{n}.npy (the
    file femto_tpu writes and reads) and read back by later builds.
    doc_chunks: also build the per-segment document lists
    (chunk_doc_offsets_np, chunk_docs_np; kernel P).  pad_shape (n_pad,
    ndocs_pad): build at that shape, the text padded with the symbol 0
    and doc_starts with empty documents; the pad suffixes sort first and
    the index keeps them as meta.row0 leading rows (queries run over
    [row0, n_rows)).  text_dev16 (uint16 or int16[n_build]) / text_dev32
    (int32[n_build], escapes in place, as expand_u8 gives it): the
    (padded) text already on ``device``."""
    from .ops.build_ops import (build_doc_lists_device,
                                build_fm_arrays_device, build_sa_payload)
    from .ops.rank import n_segments
    from .ops.sort_ops import gather_rows
    from .suffix import suffix_array, text_alphabet

    if tier is None:
        tier = "compact" if compact else "full"
    if not device_build:
        raise NotImplementedError(
            "device_build=False (the host packaging path build_fm_arrays) "
            "is not ported (ROADMAP.md Q1 item 4, the host packaging "
            "path)")
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r}")
    if text_dev16 is not None and text_dev32 is not None:
        raise ValueError("pass at most one of text_dev16/text_dev32")
    if locate not in ("walk", "direct"):
        raise ValueError(f"unknown locate tier {locate!r}")
    if seg % 32 != 0 or seg <= 0:
        raise ValueError("seg must be a positive multiple of 32")
    n = prepared.n
    if n == 0:
        raise ValueError("cannot index an empty corpus")
    if n >= 2**31:
        raise ValueError(
            "single-index corpora are limited to 2^31 symbols (int32 row "
            "ids); use femto_tpu_torch.multi.build_chunked_prepared, which "
            "composes per-chunk int32 indexes into global int64 results")
    ndocs = prepared.num_docs
    if pad_shape is not None:
        n_build, ndocs_build = (int(x) for x in pad_shape)
        if sa is not None or checkpoint_dir is not None:
            raise ValueError("pad_shape is incompatible with a "
                             "precomputed/checkpointed suffix array")
        if n_build < n or ndocs_build < ndocs:
            raise ValueError("pad_shape smaller than the corpus")
        if n_build >= 2**31:
            raise ValueError("pad_shape needs n_pad < 2^31")
    else:
        n_build, ndocs_build = n, ndocs
    dev = resolve_device(device)
    text = _device_text(prepared, n_build, dev, text_dev16, text_dev32)
    del text_dev16, text_dev32
    ds_np = prepared.doc_starts.astype(np.int32)
    if ndocs_build > ndocs:
        ds_np = np.concatenate(
            [ds_np, np.full(ndocs_build - ndocs, n, np.int32)])
    doc_starts = _to_device(ds_np, dev)
    if checkpoint_dir is not None and sa is None:
        ckpt_path = os.path.join(checkpoint_dir, f"sa_{n}.npy")
        if os.path.exists(ckpt_path):
            sa = np.load(ckpt_path)
        else:
            sa = suffix_array(text).cpu().numpy()
            os.makedirs(checkpoint_dir, exist_ok=True)
            np.save(ckpt_path, sa)
    # one histogram of the text serves the sort's keys and the remapped
    # tiers' dense alphabet; a caller's sa on another tier needs neither.
    # A padded text holds the pad symbol 0, as femto_tpu's alphabet does.
    remapped = tier in ("packed", "vseg", "vrle")
    alpha = text_alphabet(text) if sa is None or remapped else None
    payload = build_sa_payload(text, doc_starts, n=n_build,
                               mark_period=mark_period, ndocs=ndocs_build)
    if sa is None:
        sa_dev, pull = suffix_array(text, payload=payload, alpha=alpha,
                                    n_real=n if n_build > n else None)
    else:
        sa_dev = _to_device(np.asarray(sa, dtype=np.int32), dev)
        pull = gather_rows(payload, sa_dev)
    del payload
    arrays, n_marks, alpha_used = build_fm_arrays_device(
        text, sa_dev, doc_starts, n=n_build, seg=seg, mark_period=mark_period,
        ndocs=ndocs_build, tier=tier, pull=pull, alpha=alpha)
    del text, pull
    meta = FMMeta(n=n, seg=seg, mark_period=mark_period, num_docs=ndocs,
                  n_marks=int(n_marks), n_seg=n_segments(arrays),
                  alpha_used=alpha_used, n_rows=n_build, row0=n_build - n)
    index = FMIndex(
        arrays=arrays, meta=meta,
        doc_starts_np=prepared.doc_starts.astype(np.int64),
        infos=list(prepared.infos),
        header_lens_np=prepared.header_lens,
        sa_direct=sa_dev if locate == "direct" else None,
    )
    if doc_chunks:
        # pad rows (sa >= n) drop out
        index.chunk_doc_offsets_np, index.chunk_docs_np = \
            build_doc_lists_device(sa_dev, doc_starts, n=n,
                                   n_seg=meta.n_seg, seg=seg)
    return index
