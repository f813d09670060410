"""The suffix sort's device steps: kernel wrappers + plain versions.

The counterparts of the jitted stages of femto_tpu/suffix.py (which has no
one file of ops): the alphabet histogram and the packed keys (kernel G,
csrc/sa_keys.cu), the stable radix sort of (key, value) pairs (kernel H,
csrc/radix_sort.cu), the group flags and the compaction of the tied slots
(kernel I, csrc/sa_groups.cu), the rank array and a round's keys and
write-back (kernel J, csrc/sa_rounds.cu), and the gather through the
suffix array (kernel L, csrc/sa_payload.cu).  femto_tpu_torch/suffix.py
drives them.  Each wrapper launches its kernel for tensors on the card and
takes the plain PyTorch version beside it for tensors on the CPU; a CUDA
tensor never falls back.  Everything is integers: kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .. import kernels

N_SYMS = 512            # symbols lie in [0, 512)
_TIED_TILE = 2048       # csrc/sa_groups.cu kTile


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _empty(dev, dtype, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=dev)


# ---------------------------------------------------------------------------
# Kernel G: alphabet histogram and packed keys
# ---------------------------------------------------------------------------


def sym_hist_plain(text: torch.Tensor) -> torch.Tensor:
    t = text.long()
    inside = (t >= 0) & (t < N_SYMS)
    hist = torch.bincount(t[inside], minlength=N_SYMS)
    outside = (~inside).sum().reshape(1)
    return torch.cat([hist, outside]).to(torch.int32)


def sym_hist(text: torch.Tensor) -> torch.Tensor:
    """int32[513]: occurrences of symbols 0..511 in ``text`` (int32[n]),
    then the number of symbols outside [0, 512).  Kernel G on the card."""
    kernels.check(text, "text", torch.int32, 1)
    if not kernels.on_card(text):
        return sym_hist_plain(text)
    out = torch.zeros(N_SYMS + 1, dtype=torch.int32, device=text.device)
    kernels.launch("sym_hist", text.data_ptr(), text.shape[0], out.data_ptr())
    return out


def sa_keys_plain(text: torch.Tensor, lut: torch.Tensor, *, bits: int,
                  per: int, n_real: Optional[int] = None) -> torch.Tensor:
    n = text.shape[0]
    t = text.long()
    inside = (t >= 0) & (t < N_SYMS)
    codes = torch.where(inside, lut.long()[torch.where(inside, t, 0)], 0)
    key = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in range(min(per, n)):
        key[: n - j] |= codes[j:] << ((per - 1 - j) * bits)
    if n_real is not None and n_real < n:
        key[n_real:] = torch.arange(n - 1 - n_real, -1, -1,
                                    dtype=torch.int64, device=text.device)
    return key


def sa_keys(text: torch.Tensor, lut: torch.Tensor, *, bits: int,
            per: int, n_real: Optional[int] = None) -> torch.Tensor:
    """int64[n] packed key of every suffix: the dense codes lut[text[p + j]]
    of its first ``per`` symbols, ``bits`` bits each, the first symbol
    highest, zeros past the end.  lut int32[512], 0 for absent symbols.
    n_real (a shape-padded text, pad symbols from n_real on): the pad
    suffixes get the keys n - 1 - p, below every real key, in the order of
    their lengths (csrc/sa_keys.cu).  Kernel G on the card, its launches
    counted apart under "sa_keys[n_real]" for a padded text."""
    kernels.check(text, "text", torch.int32, 1)
    kernels.check(lut, "lut", torch.int32, 1, (N_SYMS,))
    n = text.shape[0]
    if bits < 1 or per < 1 or per * bits > 63:
        raise ValueError("need bits >= 1, per >= 1 and per * bits <= 63")
    if n_real is not None and not 0 < n_real <= n:
        raise ValueError("need 0 < n_real <= n")
    padded = n_real is not None and n_real < n
    if not kernels.on_card(text, lut):
        return sa_keys_plain(text, lut, bits=bits, per=per, n_real=n_real)
    key = _empty(text.device, torch.int64, n)
    kernels.launch("sa_keys", text.data_ptr(), n, lut.data_ptr(), bits, per,
                   n_real if padded else n, key.data_ptr(),
                   layout="n_real" if padded else None)
    return key


# ---------------------------------------------------------------------------
# Kernel H: stable radix sort of (key, value) pairs
# ---------------------------------------------------------------------------


def radix_sort_pairs_plain(keys: torch.Tensor, vals: Optional[torch.Tensor],
                           bit_lo: int, bit_hi: int):
    m = keys.shape[0]
    if vals is None:
        vals = torch.arange(m, dtype=torch.int32, device=keys.device)
    field = (keys >> bit_lo) & ((1 << (bit_hi - bit_lo)) - 1)
    order = torch.sort(field, stable=True)[1]
    return keys[order], vals[order]


def radix_sort_pairs(keys: torch.Tensor, vals: Optional[torch.Tensor],
                     bit_lo: int, bit_hi: int):
    """(keys, vals) sorted stably by bits [bit_lo, bit_hi) of the keys
    (non-negative int64[m], m < 2^31); vals int32[m], or None for 0..m-1.
    The inputs are left as they were.  Kernel H on the card: one
    histogram launch, then one launch per 8-bit LSD pass between two
    buffer pairs allocated here (one launch in all where m fits one
    block's shared memory); scratch as csrc/radix_sort.cu sizes it."""
    kernels.check(keys, "keys", torch.int64, 1)
    m = keys.shape[0]
    if vals is not None:
        kernels.check(vals, "vals", torch.int32, 1, (m,))
    if not 0 <= bit_lo < bit_hi <= 63:
        raise ValueError("need 0 <= bit_lo < bit_hi <= 63")
    if not kernels.on_card(*([keys] if vals is None else [keys, vals])):
        return radix_sort_pairs_plain(keys, vals, bit_lo, bit_hi)
    if m >= 2**31:
        raise ValueError("kernel H sorts fewer than 2^31 elements")
    dev = keys.device
    passes = -(-(bit_hi - bit_lo) // 8)
    bufs = [(_empty(dev, torch.int64, m), _empty(dev, torch.int32, m))
            for _ in range(min(passes, 2))]
    if m == 0:
        return bufs[0]
    scratch = _empty(dev, torch.int32, kernels.size("radix_sort_scratch", m))
    k1, v1 = bufs[1] if passes > 1 else (None, None)
    kernels.launch("radix_sort_pairs", keys.data_ptr(), _ptr(vals),
                   bufs[0][0].data_ptr(), bufs[0][1].data_ptr(), _ptr(k1),
                   _ptr(v1), m, bit_lo, bit_hi, scratch.data_ptr())
    return bufs[(passes - 1) % 2]


# ---------------------------------------------------------------------------
# Kernel I: group flags and the compaction of the tied slots
# ---------------------------------------------------------------------------


def group_flags_plain(keys: torch.Tensor) -> torch.Tensor:
    flags = torch.ones(keys.shape[0], dtype=torch.uint8, device=keys.device)
    flags[1:] = (keys[1:] != keys[:-1]).to(torch.uint8)
    return flags


def group_flags(keys: torch.Tensor) -> torch.Tensor:
    """uint8[m]: 1 where a group of equal keys starts in the sorted
    ``keys`` (int64[m]); flags[0] is set.  Kernel I on the card."""
    kernels.check(keys, "keys", torch.int64, 1)
    if not kernels.on_card(keys):
        return group_flags_plain(keys)
    flags = _empty(keys.device, torch.uint8, keys.shape[0])
    if keys.shape[0]:
        kernels.launch("group_flags", keys.data_ptr(), keys.shape[0],
                       flags.data_ptr())
    return flags


def tied_compact_plain(flags: torch.Tensor,
                       slots: Optional[torch.Tensor] = None,
                       want_all: bool = False):
    m = flags.shape[0]
    st = flags.bool()
    if slots is None:
        slots = torch.arange(m, dtype=torch.int32, device=flags.device)
    nxt = torch.ones_like(st)
    nxt[:-1] = st[1:]
    tied = ~(st & nxt)
    # every element's group starts at the last flagged element at or before
    # it (a cumsum and a gather)
    base_all = slots[st][torch.cumsum(st, dim=0) - 1]
    return (slots[tied], base_all[tied], int(tied.sum()),
            base_all if want_all else None)


def tied_compact(flags: torch.Tensor, slots: Optional[torch.Tensor] = None,
                 want_all: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, int,
                            Optional[torch.Tensor]]:
    """The elements that lie in groups of more than one, given the group
    flags of m sorted elements and the slot of each (``slots`` int32[m]
    ascending; None: element i sits in slot i).  Returns (slots_next,
    base_next, count, base_all): the tied elements' slots and group base
    slots (int32[count], ascending), their number (one scalar read back
    from the device) and, with ``want_all``, every element's group base
    slot (int32[m]).  Kernel I on the card, in two launches: count, then
    write into outputs of the exact size."""
    kernels.check(flags, "flags", torch.uint8, 1)
    m = flags.shape[0]
    if slots is not None:
        kernels.check(slots, "slots", torch.int32, 1, (m,))
    if m == 0:
        raise ValueError("tied_compact needs at least one element")
    if not kernels.on_card(*([flags] if slots is None else [flags, slots])):
        return tied_compact_plain(flags, slots, want_all)
    dev = flags.device
    n_tiles = -(-m // _TIED_TILE)
    tile_cnt = _empty(dev, torch.int32, n_tiles)
    tile_last = _empty(dev, torch.int32, n_tiles)
    count_t = _empty(dev, torch.int32, 1)
    kernels.launch("tied_compact", flags.data_ptr(), _ptr(slots), m, 0,
                   tile_cnt.data_ptr(), tile_last.data_ptr(),
                   count_t.data_ptr(), None, None, None)
    count = int(count_t.item())
    slots_next = _empty(dev, torch.int32, count)
    base_next = _empty(dev, torch.int32, count)
    base_all = _empty(dev, torch.int32, m) if want_all else None
    if count or want_all:
        kernels.launch("tied_compact", flags.data_ptr(), _ptr(slots), m, 1,
                       tile_cnt.data_ptr(), tile_last.data_ptr(),
                       count_t.data_ptr(), slots_next.data_ptr(),
                       base_next.data_ptr(), _ptr(base_all))
    return slots_next, base_next, count, base_all


# ---------------------------------------------------------------------------
# Kernel J: the rank array, a round's keys and its write-back
# ---------------------------------------------------------------------------


def rank_init_plain(sa: torch.Tensor, slots: torch.Tensor,
                    base: torch.Tensor) -> torch.Tensor:
    n = sa.shape[0]
    rank = torch.empty(n, dtype=torch.int32, device=sa.device)
    rank[sa.long()] = torch.arange(n, dtype=torch.int32, device=sa.device)
    rank[sa[slots.long()].long()] = base
    return rank


def rank_init(sa: torch.Tensor, slots: torch.Tensor,
              base: torch.Tensor) -> torch.Tensor:
    """int32[n] rank[sa[r]] = group base slot of r: r itself, but base[t]
    for the tied slots r = slots[t].  Kernel J on the card."""
    kernels.check(sa, "sa", torch.int32, 1)
    m = slots.shape[0]
    kernels.check(slots, "slots", torch.int32, 1)
    kernels.check(base, "base", torch.int32, 1, (m,))
    if not kernels.on_card(sa, slots, base):
        return rank_init_plain(sa, slots, base)
    rank = _empty(sa.device, torch.int32, sa.shape[0])
    kernels.launch("rank_init", sa.data_ptr(), sa.shape[0], slots.data_ptr(),
                   base.data_ptr(), m, rank.data_ptr())
    return rank


def round_keys_plain(sa: torch.Tensor, slots: torch.Tensor, *, shift: int,
                     rank: Optional[torch.Tensor] = None, h: int = 0,
                     base: Optional[torch.Tensor] = None,
                     key0: Optional[torch.Tensor] = None, w: int = 0,
                     drop: int = 0):
    n = sa.shape[0]
    pos = sa[slots.long()]
    if rank is not None:
        hi = rank[pos.long()].long()
        q = pos.long() + h
        lo = torch.where(q < n, rank[q.clamp(max=n - 1)].long() + 1, 0)
    else:
        hi = base.long()
        q = pos.long() + w
        lo = torch.where(q < n, key0[q.clamp(max=n - 1)] >> drop, 0)
    return pos, (hi << shift) | lo


def round_keys(sa: torch.Tensor, slots: torch.Tensor, *, shift: int,
               rank: Optional[torch.Tensor] = None, h: int = 0,
               base: Optional[torch.Tensor] = None,
               key0: Optional[torch.Tensor] = None, w: int = 0,
               drop: int = 0):
    """(pos int32[m], key int64[m]) of the active slots: pos = sa[slots]
    and the round's sort key hi << shift | lo.  With ``rank`` (doubling):
    hi = rank[pos], lo = rank[pos + h] + 1, 0 past the end.  Else
    (extension): hi = base (each slot's group base), lo = key0[pos + w] >>
    drop, 0 past the end.  Kernel J on the card."""
    kernels.check(sa, "sa", torch.int32, 1)
    n = sa.shape[0]
    m = slots.shape[0]
    kernels.check(slots, "slots", torch.int32, 1)
    if rank is not None:
        kernels.check(rank, "rank", torch.int32, 1, (n,))
        tensors = (sa, slots, rank)
    else:
        kernels.check(base, "base", torch.int32, 1, (m,))
        kernels.check(key0, "key0", torch.int64, 1, (n,))
        tensors = (sa, slots, base, key0)
    if not 0 <= shift < 63 or not 0 <= drop < 63:
        raise ValueError("need 0 <= shift, drop < 63")
    if not kernels.on_card(*tensors):
        return round_keys_plain(sa, slots, shift=shift, rank=rank, h=h,
                                base=base, key0=key0, w=w, drop=drop)
    pos = _empty(sa.device, torch.int32, m)
    key = _empty(sa.device, torch.int64, m)
    if m:
        kernels.launch("round_keys", sa.data_ptr(), slots.data_ptr(), m, n,
                       _ptr(rank), h, None if rank is not None else _ptr(base),
                       None if rank is not None else _ptr(key0), w, shift,
                       drop, pos.data_ptr(), key.data_ptr(),
                       layout="doubling" if rank is not None else "extension")
    return pos, key


def round_commit_plain(sa: torch.Tensor, rank: Optional[torch.Tensor],
                       slots: torch.Tensor, spos: torch.Tensor,
                       base_all: Optional[torch.Tensor], *,
                       skey: Optional[torch.Tensor] = None, shift: int = 0,
                       base: Optional[torch.Tensor] = None) -> None:
    if skey is not None:
        # groups stay where they are: the active slots are ascending and a
        # group is a run of them, so the sort by (group base, ...) left
        # element t in the group of slots[t]
        assert torch.equal(skey >> shift, base.long()), \
            "a sorted element left its group's slots"
    sa[slots.long()] = spos
    if rank is not None:
        rank[spos.long()] = base_all


def round_commit(sa: torch.Tensor, rank: Optional[torch.Tensor],
                 slots: torch.Tensor, spos: torch.Tensor,
                 base_all: Optional[torch.Tensor], *,
                 skey: Optional[torch.Tensor] = None, shift: int = 0,
                 base: Optional[torch.Tensor] = None) -> None:
    """Write a sorted round back, in place: sa[slots[t]] = spos[t] and,
    with ``rank``, rank[spos[t]] = base_all[t] (every sorted element's new
    group base slot).  skey, shift and base (the sorted keys and each
    slot's group base before the round) let the plain version assert that
    no element left its group.  Kernel J on the card."""
    kernels.check(sa, "sa", torch.int32, 1)
    m = slots.shape[0]
    kernels.check(slots, "slots", torch.int32, 1)
    kernels.check(spos, "spos", torch.int32, 1, (m,))
    tensors = [sa, slots, spos]
    if rank is not None:
        kernels.check(rank, "rank", torch.int32, 1, (sa.shape[0],))
        kernels.check(base_all, "base_all", torch.int32, 1, (m,))
        tensors += [rank, base_all]
    if not kernels.on_card(*tensors):
        return round_commit_plain(sa, rank, slots, spos, base_all, skey=skey,
                                  shift=shift, base=base)
    if m:
        kernels.launch("round_commit", sa.data_ptr(), _ptr(rank),
                       slots.data_ptr(), spos.data_ptr(),
                       _ptr(base_all) if rank is not None else None, m)


# ---------------------------------------------------------------------------
# Kernel L: gather
# ---------------------------------------------------------------------------


def gather_rows_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    i = idx.long()
    inside = (i >= 0) & (i < src.shape[0])
    out = torch.full((idx.shape[0],), -1, dtype=src.dtype, device=src.device)
    out[inside] = src[i[inside]]
    return out


_GATHER_DTYPES = (torch.int32, torch.int64)


def gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = src[idx[i]] for an int32 or int64 ``src`` and int32 ``idx``;
    -1 where the index lies outside src.  Kernel L on the card: the direct
    locate tier and the pull of the sort's payload."""
    if src.dtype not in _GATHER_DTYPES:
        raise ValueError(f"src must be int32 or int64, got {src.dtype}")
    kernels.check(src, "src", src.dtype, 1)
    kernels.check(idx, "idx", torch.int32, 1)
    if not kernels.on_card(src, idx):
        return gather_rows_plain(src, idx)
    m = idx.shape[0]
    out = src.new_empty(m)
    if m:
        kernels.launch("gather_rows", src.data_ptr(), src.shape[0],
                       src.element_size(), idx.data_ptr(), m, out.data_ptr())
    return out


# columns one gather_cols launch takes (csrc/sa_payload.cu kMaxCols)
MAX_GATHER_COLS = 8


def gather_cols_plain(srcs: Sequence[torch.Tensor], idx: torch.Tensor,
                      outs: Sequence[torch.Tensor]) -> None:
    for src, out in zip(srcs, outs):
        out.copy_(gather_rows_plain(src, idx))


def gather_cols(srcs: Sequence[torch.Tensor], idx: torch.Tensor,
                outs: Optional[Sequence[torch.Tensor]] = None
                ) -> List[torch.Tensor]:
    """gather_rows of each column through one ``idx``: outs[c][i] =
    srcs[c][idx[i]], -1 outside [0, len); the columns are 1-D tensors of
    one length and one dtype (int32 or int64), written into ``outs``
    (contiguous 1-D tensors of len(idx) elements, e.g. rows of the
    caller's arrays) or into new tensors.  Kernel L on the card: up to 8
    columns a launch, each index read once.  Returns the outputs."""
    if not srcs:
        raise ValueError("gather_cols needs at least one column")
    dtype, n = srcs[0].dtype, srcs[0].shape[0]
    if dtype not in _GATHER_DTYPES:
        raise ValueError(f"columns must be int32 or int64, got {dtype}")
    kernels.check(idx, "idx", torch.int32, 1)
    m = idx.shape[0]
    for i, c in enumerate(srcs):
        kernels.check(c, f"srcs[{i}]", dtype, 1, (n,))
    if outs is None:
        outs = [c.new_empty(m) for c in srcs]
    elif len(outs) != len(srcs):
        raise ValueError(f"{len(srcs)} columns but {len(outs)} outputs")
    for i, o in enumerate(outs):
        kernels.check(o, f"outs[{i}]", dtype, 1, (m,))
    if not kernels.on_card(idx, *srcs, *outs):
        gather_cols_plain(srcs, idx, outs)
        return list(outs)
    for k in range(0, len(srcs) if m else 0, MAX_GATHER_COLS):
        cs, os_ = srcs[k:k + MAX_GATHER_COLS], outs[k:k + MAX_GATHER_COLS]
        pad = [None] * (MAX_GATHER_COLS - len(cs))
        kernels.launch("gather_cols", idx.data_ptr(), m, n,
                       srcs[0].element_size(), len(cs),
                       *[c.data_ptr() for c in cs], *pad,
                       *[o.data_ptr() for o in os_], *pad)
    return list(outs)
