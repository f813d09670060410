"""Paged serving's cache update: kernel wrapper + plain version.

The counterpart of femto_tpu/paged.py _apply_faults (K16).  The wrapper
launches csrc/paged.cu's apply_faults for tensors on the card and takes
the plain PyTorch version beside it for tensors on the CPU; a CUDA tensor
never falls back.  Both update the cache and the slot map in place (the
JAX function returned new arrays): the cache is most of paged serving's
device memory, and a copy per fault batch would double it.
"""

from __future__ import annotations

import torch

from .. import kernels


def _in_range(idx: torch.Tensor, n: int) -> torch.Tensor:
    return (idx >= 0) & (idx < n)


def apply_faults_plain(cache: torch.Tensor, slot_map: torch.Tensor,
                       slots: torch.Tensor, rows: torch.Tensor,
                       evict_segs: torch.Tensor, segs: torch.Tensor) -> None:
    """cache[slots] = rows; slot_map[evict_segs] = 0; slot_map[segs] =
    slots, each dropping the entries whose index is out of range (the JAX
    scatters' mode="drop")."""
    ok = _in_range(slots, cache.shape[0])
    cache.view(torch.int32)[slots[ok].long()] = rows.view(torch.int32)[ok]
    ev = evict_segs[_in_range(evict_segs, slot_map.shape[0])]
    slot_map[ev.long()] = 0
    ok = _in_range(segs, slot_map.shape[0])
    slot_map[segs[ok].long()] = slots[ok]


def apply_faults(cache: torch.Tensor, slot_map: torch.Tensor,
                 slots: torch.Tensor, rows: torch.Tensor,
                 evict_segs: torch.Tensor, segs: torch.Tensor) -> None:
    """One cache update of paged serving, in place: the fetched rows
    uint32[m, W] into cache slots int32[m] of the row cache
    uint32[cache_rows, W], the evicted segments int32[k] unmapped and the
    fetched segments int32[m] mapped to their slots in slot_map
    int32[n_seg].  The evicted and the fetched segments must be disjoint
    (paged.PagedIndex's clock keeps them so).  Kernel T on the card."""
    m = segs.shape[0]
    kernels.check(cache, "cache", torch.uint32, 2)
    W = cache.shape[1]
    kernels.check(slot_map, "slot_map", torch.int32, 1)
    kernels.check(slots, "slots", torch.int32, 1, (m,))
    kernels.check(rows, "rows", torch.uint32, 2, (m, W))
    kernels.check(evict_segs, "evict_segs", torch.int32, 1)
    if evict_segs.shape[0] > m:
        raise ValueError("more evicted segments than fetched ones")
    if not kernels.on_card(cache, slot_map, slots, rows, evict_segs, segs):
        apply_faults_plain(cache, slot_map, slots, rows, evict_segs, segs)
        return
    kernels.launch("apply_faults", cache.data_ptr(), cache.shape[0], W,
                   slot_map.data_ptr(), slot_map.shape[0], slots.data_ptr(),
                   rows.data_ptr(), evict_segs.data_ptr(), segs.data_ptr(),
                   m, evict_segs.shape[0])
