"""LCP arrays and the suffix-analysis application family (PyTorch).

The counterpart of femto_tpu/lcp.py: the LCP array behind the CLI's
find-unique, unique-kmers and suffix-similarity commands (the reference's
Chapel application layer: FindUnique, ExtractUniqueKmers,
SuffixSimilarity), with femto_tpu's semantics and its size switch.

The device path compares every pair (suffix, its SA predecessor) in
parallel with a window that doubles from 32 to 4096 symbols, and retires a
pair after its first mismatching window (kernel S, csrc/lcp.cu: one round,
then a stable compaction of the live pairs; the live count reaches the
host once a round).  Its text and lanes are tensors on ``torch_device``
(default the card, which it raises without); CPU tensors run the kernels'
plain versions.  Below _DEVICE_LCP_MIN_N symbols ``device=None`` takes
the host Kasai pass instead (the native ft_kasai, or _kasai_np where the
native library does not build), as femto_tpu does.  The host
post-processing (ranks, document lookups, the pair dictionary) is numpy.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from .alphabet import PreparedText
from .fmindex import resolve_device
from .ops import lcp_ops as L

# Below this size the host Kasai pass beats device dispatch overhead.
_DEVICE_LCP_MIN_N = 1 << 17

Device = Union[str, torch.device]

# what the last device LCP did: rounds, the window and the live lanes
# after each round (lanes that entered the first round at index 0)
last_stats: Dict[str, list] = {}


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    """int32 tensor on dev from a numpy array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(dev)


def batch_lcp(text: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """LCP of the suffix pairs (i, j) of text int32[n], int32[B] each, on
    the tensors' device; invalid lanes (valid bool[B] False) get 0.
    Returns int32[B]."""
    B = i.shape[0]
    out = torch.zeros(B, dtype=torch.int32, device=i.device)
    if B == 0:
        return out
    h = torch.zeros_like(out)
    orig = torch.arange(B, dtype=torch.int32, device=i.device)
    act = valid
    W = L.LCP_W_MIN
    live = [int(B)]
    windows = []
    while True:
        h, act = L.lcp_round(text, i, j, h, act, W)
        windows.append(W)
        i, j, h, orig, count = L.lcp_compact(out, i, j, h, act, orig,
                                             i.shape[0])
        m = int(count.item())
        live.append(m)
        if m == 0:
            break
        i, j, h, orig = i[:m], j[:m], h[:m], orig[:m]
        act = torch.ones(m, dtype=torch.bool, device=i.device)
        W = min(W * 2, L.LCP_W_MAX)
    last_stats.clear()
    last_stats.update(rounds=len(windows), windows=windows, live=live)
    return out


def batch_lcp_device(text_dev: torch.Tensor, i_np: np.ndarray,
                     j_np: np.ndarray, valid_np: np.ndarray) -> np.ndarray:
    """femto_tpu's batch_lcp_device: the lanes from numpy, the text a
    tensor on the device that runs them; int32[B] numpy back."""
    dev = text_dev.device
    return batch_lcp(
        text_dev, _as_tensor(i_np, dev), _as_tensor(j_np, dev),
        torch.from_numpy(np.ascontiguousarray(valid_np, bool)).to(dev),
    ).cpu().numpy()


def lcp_array(text, sa, device: Optional[bool] = None, *,
              torch_device: Device = "cuda") -> np.ndarray:
    """lcp[r] = LCP of suffixes SA[r-1], SA[r]; lcp[0] = 0.

    device=None picks the parallel device path for large inputs and the
    native/host Kasai pass for small ones (femto_tpu's switch); True and
    False force one.  text and sa are numpy arrays or tensors; the device
    path runs on ``torch_device``."""
    n = len(text)
    if device is None:
        device = n >= _DEVICE_LCP_MIN_N
    if device and n:
        dev = resolve_device(torch_device)
        text_t = _as_tensor(text, dev)
        sa_t = _as_tensor(sa, dev)
        j_t = torch.cat([sa_t[:1], sa_t[:-1]])
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        valid[0] = False
        return batch_lcp(text_t, sa_t, j_t, valid).cpu().numpy()
    if isinstance(text, torch.Tensor):
        text = text.cpu().numpy()
    if isinstance(sa, torch.Tensor):
        sa = sa.cpu().numpy()
    text = np.ascontiguousarray(text, dtype=np.uint16)
    sa32 = np.ascontiguousarray(sa, dtype=np.int32)
    out = np.zeros(n, dtype=np.int32)
    if n and kasai_native(text, sa32, out):
        return out
    return _kasai_np(text, sa32)


def kasai_native(text: np.ndarray, sa: np.ndarray, out: np.ndarray) -> bool:
    """The native library's Kasai pass (ft_kasai) into out, uint16 text and
    int32 sa contiguous; False when the library does not build."""
    from .io import native as nat

    if not nat.ensure_built():
        return False
    fn = nat._lib.ft_kasai
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    return fn(text.ctypes.data, sa.ctypes.data, len(text),
              out.ctypes.data) == 0


def _kasai_np(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    n = len(text)
    lcp = np.zeros(n, dtype=np.int32)
    if n == 0:
        return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = int(sa[r - 1])
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[r] = h
            if h:
                h -= 1
        else:
            h = 0
    return lcp


def sparse_plcp(text, sa, q: int = 64, *,
                torch_device: Device = "cuda") -> np.ndarray:
    """Sampled PLCP (Kärkkäinen): plcp values at positions 0, q, 2q, ...,
    plcp[i] = lcp(T[i..], T[phi(i)..]) with phi(i) = SA[ISA[i]-1], each
    pair compared by the parallel windowed batch on ``torch_device``."""
    n = len(text)
    if n == 0:
        return np.zeros(0, np.int32)
    if isinstance(sa, torch.Tensor):
        sa = sa.cpu().numpy()
    sa_np = np.asarray(sa, dtype=np.int64)
    isa = np.empty(n, dtype=np.int64)
    isa[sa_np] = np.arange(n, dtype=np.int64)
    pos = np.arange(0, n, q, dtype=np.int64)
    r = isa[pos]
    valid = r > 0
    phi = sa_np[np.maximum(r - 1, 0)]
    text_dev = _as_tensor(text, resolve_device(torch_device))
    return batch_lcp_device(text_dev, pos, phi, valid)


def unique_lengths(prepared: PreparedText, sa, lcp: Optional[np.ndarray] = None,
                   *, torch_device: Device = "cuda") -> np.ndarray:
    """FindUnique: for each text position i, the length of the shortest
    substring starting at i that occurs nowhere else (0 if none exists
    within the document): 1 + max(lcp with its SA neighbours), capped at
    the document's end."""
    text = prepared.text
    n = len(text)
    if isinstance(sa, torch.Tensor):
        sa = sa.cpu().numpy()
    if lcp is None:
        lcp = lcp_array(text, sa, torch_device=torch_device)
    rank = np.zeros(n, dtype=np.int64)
    rank[np.asarray(sa, dtype=np.int64)] = np.arange(n)
    lcp_next = np.concatenate([lcp[1:], np.zeros(1, np.int32)])
    need = 1 + np.maximum(lcp[rank], lcp_next[rank]).astype(np.int64)
    # distance to end of document (excluding the SEOF terminator)
    pos = np.arange(n, dtype=np.int64)
    doc_of = np.searchsorted(prepared.doc_starts, pos, side="right") - 1
    doc_content_end = prepared.doc_starts[doc_of + 1] - 1
    room = doc_content_end - pos
    out = np.where(need <= room, need, 0).astype(np.int32)
    # positions at/after a doc's content end (the SEOF itself) are 0
    out[room <= 0] = 0
    return out


def extract_unique_kmers(prepared: PreparedText, sa, k: int,
                         lcp: Optional[np.ndarray] = None, *,
                         torch_device: Device = "cuda"
                         ) -> List[Tuple[int, int]]:
    """ExtractUniqueKmers: (doc, offset) of every position whose minimal
    unique substring is at most k long (i.e. its k-mer is unique)."""
    ul = unique_lengths(prepared, sa, lcp, torch_device=torch_device)
    pos = np.nonzero((ul > 0) & (ul <= k))[0]
    doc_of = np.searchsorted(prepared.doc_starts, pos, side="right") - 1
    off = pos - prepared.doc_starts[doc_of]
    return list(zip(doc_of.tolist(), off.tolist()))


def suffix_similarity(prepared: PreparedText, sa,
                      lcp: Optional[np.ndarray] = None, min_lcp: int = 4,
                      *, torch_device: Device = "cuda"
                      ) -> Dict[Tuple[int, int], float]:
    """SuffixSimilarity: score document pairs by shared substrings.

    Adjacent SA rows of different documents with LCP >= min_lcp add their
    LCP to the pair's score; scores are normalized by the geometric mean
    of the two documents' lengths."""
    text = prepared.text
    if isinstance(sa, torch.Tensor):
        sa = sa.cpu().numpy()
    if lcp is None:
        lcp = lcp_array(text, sa, torch_device=torch_device)
    sa = np.asarray(sa, dtype=np.int64)
    doc_of = np.searchsorted(prepared.doc_starts, sa, side="right") - 1
    d_prev = doc_of[:-1]
    d_cur = doc_of[1:]
    l = lcp[1:]
    sel = (d_prev != d_cur) & (l >= min_lcp)
    pairs: Dict[Tuple[int, int], float] = {}
    a = np.minimum(d_prev[sel], d_cur[sel])
    b = np.maximum(d_prev[sel], d_cur[sel])
    for x, y, v in zip(a.tolist(), b.tolist(), l[sel].tolist()):
        pairs[(x, y)] = pairs.get((x, y), 0.0) + float(v)
    lens = np.maximum(np.diff(prepared.doc_starts) - 1, 1)
    return {
        (x, y): v / float(np.sqrt(lens[x] * lens[y]))
        for (x, y), v in pairs.items()
    }
