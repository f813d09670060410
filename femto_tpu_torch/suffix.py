"""Suffix-array construction over the hand-written sort kernels.

The counterpart of femto_tpu/suffix.py's suffix_array: int32[n] SA of a
text of symbols in [0, 512), with an optional payload carried to row order
(pull[r] = payload[sa[r]]).  The suffix array is unique, so the port's key
widths give the same bits as the reference's.  suffix_array follows the
reference's three regimes over the steps of ops/sort_ops.py (kernels G, H,
I, J, L on the card, their plain versions on the CPU):

  1. the symbols present (sym_hist, unless the caller gives ``alpha``) get
     dense codes 1..K; sa_keys packs per = 63 // bits of each suffix's
     leading codes into ONE int64 key (the reference packs three 30-bit
     keys), zeros past the end; radix_sort_pairs sorts (key, position) over
     the per * bits key bits; group_flags + tied_compact give the slots
     that lie in groups of more than one (their count m is the one scalar
     read back per round);
  2. m = 0: done.  m > n / 4 (repetitive input): rank_init, then prefix
     doubling over the tied slots from h = per (Manber-Myers ranks, "group
     base slot" convention): round_keys, the sort, tied_compact,
     round_commit;
  3. otherwise up to _EXT_MAX_ROUNDS direct-extension rounds: each sorts
     the tied slots by (group base, the next e symbols), read from the kept
     first-sort keys at pos + W, with no rank array and no n-row scatter;
     if ties remain, rank_init once and doubling from h = W.

A round's sort key is one int64, hi << shift | lo, so one radix sort over
its used bits does a round.  That bounds what one extension round reads:
the e = min(per, (63 - bits of n) // bits) leading symbols of ONE key word
(7 symbols for a 5-bit alphabet at n = 2^28, 3 for a 9-bit one), where the
reference reads four 30-bit words.  The payload does not ride the sorts:
pull = gather_rows(payload, sa) once at the end.

A shape-padded text (``n_real``: pad symbols 0 from n_real on, as
build_index(pad_shape=...) makes it) gets distinct keys for its pad
suffixes in the first sort (csrc/sa_keys.cu), so the pad run settles there
instead of tying until the doubling rounds see its lengths.  The SA is the
padded text's own either way; only the work differs.

``last_stats`` records the regime and the tied count after each round of
the last call.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .ops import sort_ops as SO

_EXT_MAX_ROUNDS = 6   # direct-extension rounds before doubling takes over

# What the last suffix_array call did: K, bits, per, e, "tied" (the count
# after the first sort, then after each round), "ext_rounds",
# "dbl_rounds" and "regime" ("sorted", "doubling", "extension" or
# "extension+doubling").
last_stats: Dict[str, object] = {}


def key_widths(K: int):
    """(bits, per) of the packed keys for K dense codes 1..K."""
    bits = max(1, int(K).bit_length())
    return bits, 63 // bits


def alpha_lut(used: np.ndarray) -> np.ndarray:
    """int32[512] symbol -> dense code 1..K over the ascending symbols
    ``used``, 0 for the others."""
    used = np.asarray(used, dtype=np.int64)
    if used.size and (used.min() < 0 or used.max() >= SO.N_SYMS):
        raise ValueError("symbols must lie in [0, 512)")
    lut = np.zeros(SO.N_SYMS, np.int32)
    lut[used] = np.arange(1, used.size + 1, dtype=np.int32)
    return lut


def text_alphabet(text: torch.Tensor) -> np.ndarray:
    """The symbols that occur in ``text`` (int32[n] on any device),
    ascending, by one histogram on the text's device and one small
    read-back; raises on a symbol outside [0, 512)."""
    hist = SO.sym_hist(text).cpu().numpy()
    if hist[SO.N_SYMS]:
        raise ValueError("symbols must lie in [0, 512)")
    return np.nonzero(hist[:SO.N_SYMS])[0].astype(np.int32)


def _doubling(sa, slots, base, m, h, n, stats):
    """Prefix doubling over the tied slots until none is left."""
    rank = SO.rank_init(sa, slots, base)
    shift = n.bit_length()                  # rank + 1 <= n
    key_bits = shift + max(1, (n - 1).bit_length())
    while m > 0:
        if h >= 2 * n:
            raise RuntimeError("suffix sort did not converge")
        pos, key = SO.round_keys(sa, slots, shift=shift, rank=rank, h=h)
        skey, spos = SO.radix_sort_pairs(key, pos, 0, key_bits)
        del pos, key
        slots_next, base_next, m, base_all = SO.tied_compact(
            SO.group_flags(skey), slots, want_all=True)
        SO.round_commit(sa, rank, slots, spos, base_all, skey=skey,
                        shift=shift, base=base)
        slots, base = slots_next, base_next
        stats["tied"].append(m)
        stats["dbl_rounds"] += 1
        h *= 2


def suffix_array(text: torch.Tensor, payload: Optional[torch.Tensor] = None,
                 alpha: Optional[np.ndarray] = None,
                 n_real: Optional[int] = None):
    """Suffix array of ``text`` (int tensor of alphabet codes) as int32[n],
    on text's device; with ``payload`` (int32 or int64[n]) returns
    (sa, payload[sa]).

    alpha: optional host array of the symbols that occur in ``text``,
    ascending (a superset only weakens the key pack rate); when given, the
    histogram of the text and its read-back are skipped.

    n_real: the real length of a shape-padded text whose tail from n_real
    on is the pad symbol 0 (femto_tpu.suffix.suffix_array's n_real): the
    pad suffixes are settled by the first sort."""
    n = int(text.shape[0])
    if n == 0:
        raise ValueError("empty text")
    if n >= 2**31:
        raise ValueError("suffix_array needs n < 2^31")
    if n_real is not None and not 0 < n_real <= n:
        raise ValueError("need 0 < n_real <= n")
    if text.dtype != torch.int32 or not text.is_contiguous():
        text = text.to(torch.int32).contiguous()
    dev = text.device
    used = text_alphabet(text) if alpha is None else np.asarray(alpha)
    K = int(used.shape[0])
    bits, per = key_widths(K)
    lut = torch.from_numpy(alpha_lut(used)).to(dev)
    key0 = SO.sa_keys(text, lut, bits=bits, per=per, n_real=n_real)
    skey, sa = SO.radix_sort_pairs(key0, None, 0, per * bits)
    flags = SO.group_flags(skey)
    del skey
    slots, base, m, _ = SO.tied_compact(flags)
    del flags
    # extension rounds: how many symbols fit beside the group base
    base_bits = max(1, (n - 1).bit_length())
    e = min(per, (63 - base_bits) // bits)
    stats = last_stats
    stats.clear()
    stats.update(K=K, bits=bits, per=per, e=e, tied=[m], ext_rounds=0,
                 dbl_rounds=0)
    if m > n // 4:
        del key0
        _doubling(sa, slots, base, m, per, n, stats)
    elif m > 0:
        W = per
        while m > 0 and stats["ext_rounds"] < _EXT_MAX_ROUNDS:
            shift = e * bits
            pos, key = SO.round_keys(sa, slots, shift=shift, base=base,
                                     key0=key0, w=W, drop=(per - e) * bits)
            skey, spos = SO.radix_sort_pairs(key, pos, 0, shift + base_bits)
            del pos, key
            slots_next, base_next, m, _ = SO.tied_compact(
                SO.group_flags(skey), slots)
            SO.round_commit(sa, None, slots, spos, None, skey=skey,
                            shift=shift, base=base)
            slots, base = slots_next, base_next
            stats["tied"].append(m)
            stats["ext_rounds"] += 1
            W += e
        del key0
        if m > 0:
            _doubling(sa, slots, base, m, W, n, stats)
    stats["regime"] = "+".join(
        name for name, k in (("extension", "ext_rounds"),
                             ("doubling", "dbl_rounds")) if stats[k]
    ) or "sorted"
    if payload is None:
        return sa
    if payload.dtype not in (torch.int32, torch.int64):
        payload = payload.to(torch.int64)
    return sa, SO.gather_rows(payload.contiguous(), sa)


def bwt_from_sa(text: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """The BWT, L[r] = text[(sa[r] - 1) mod n], as one gather through the
    suffix array shifted by one (kernel L on the card;
    femto_tpu.suffix.bwt_from_sa).  text int32 or int64[n], sa int32[n];
    the result has text's dtype."""
    n = int(text.shape[0])
    if sa.dtype != torch.int32 or tuple(sa.shape) != (n,):
        raise ValueError("sa must be int32[n]")
    prev = torch.where(sa == 0, n - 1, sa - 1).to(torch.int32)
    return SO.gather_rows(text.contiguous(), prev.contiguous())
