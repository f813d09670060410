"""Suffix-array construction from torch primitives (sort, gather, scan).

The counterpart of femto_tpu/suffix.py's suffix_array contract: int32[n]
SA of a text of symbols in [1, 512) (0 only as trailing padding), with an
optional payload carried to row order (pull[r] = payload[sa[r]]).  The
suffix array is unique, so this independent algorithm gives the same bits:

  1. remap the symbols present to dense codes 1..K and pack as many as fit
     (63 // bit width) of each suffix's leading codes into one int64 key,
     zeros past the end (a suffix that ends sorts before its extensions);
  2. one stable sort of the keys;
  3. prefix doubling (Manber-Myers ranks, "group base slot" convention) over
     the still-tied slots only, until every rank is unique.

femto_tpu's TPU-specific driver (speculative rounds, shape buckets, direct
key extension) is not carried over; a hand-written radix sort for this
stage is queued in ROADMAP.md (K4/K6).
"""

from __future__ import annotations

from typing import Optional

import torch


def _tied(st: torch.Tensor) -> torch.Tensor:
    """Slots in groups of size > 1, given group-start flags."""
    nxt = torch.ones_like(st)
    nxt[:-1] = st[1:]
    return ~(st & nxt)


def _group_base(st: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """For each of the ascending ``slots``, the slot its group starts at
    (groups begin where the flags ``st`` are set; st[0] is).  A cumsum and
    a gather: torch's cummax runs a slow generic scan on the card."""
    return slots[st][torch.cumsum(st, dim=0) - 1]


def suffix_array(text: torch.Tensor, payload: Optional[torch.Tensor] = None):
    """Suffix array of ``text`` (int tensor of alphabet codes) as int32[n],
    on text's device; with ``payload`` returns (sa, payload[sa])."""
    n = int(text.shape[0])
    dev = text.device
    if n == 0:
        raise ValueError("empty text")
    if n >= 2**31:
        raise ValueError("suffix_array needs n < 2^31")
    t = text.long()
    if int(t.max()) >= 512 or int(t.min()) < 0:
        raise ValueError("symbols must lie in [0, 512)")
    used = torch.nonzero(torch.bincount(t, minlength=512)).flatten()
    K = int(used.shape[0])
    bits = max(1, K.bit_length())
    per = 63 // bits
    lut = torch.zeros(512, dtype=torch.int64, device=dev)
    lut[used] = torch.arange(1, K + 1, dtype=torch.int64, device=dev)
    codes = lut[t]
    del t, lut
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(min(per, n)):
        key[: n - j] |= codes[j:] << ((per - 1 - j) * bits)
    del codes
    skey, sa = torch.sort(key, stable=True)
    del key
    st = torch.ones(n, dtype=torch.bool, device=dev)
    st[1:] = skey[1:] != skey[:-1]
    del skey
    slots = torch.nonzero(_tied(st)).flatten()
    if slots.shape[0]:
        iota = torch.arange(n, dtype=torch.int64, device=dev)
        rank = torch.empty(n, dtype=torch.int64, device=dev)
        rank[sa] = _group_base(st, iota)
        del iota
    del st
    h = per
    while slots.shape[0]:
        # one doubling round over the tied slots: sort by (rank of the
        # h-prefix, rank of the next h symbols; -1 past the end), write
        # back into the same (ascending, group-contiguous) slots
        pos = sa[slots]
        pk = pos + h
        r2 = torch.where(pk < n, rank[torch.clamp(pk, max=n - 1)], -1)
        skey, order = torch.sort((rank[pos] << 32) | (r2 + 1), stable=True)
        sp = pos[order]
        st = torch.ones(slots.shape[0], dtype=torch.bool, device=dev)
        st[1:] = skey[1:] != skey[:-1]
        sa[slots] = sp
        rank[sp] = _group_base(st, slots)
        slots = slots[_tied(st)]
        h *= 2
    sa = sa.to(torch.int32)
    if payload is None:
        return sa
    return sa, payload[sa.long()]
