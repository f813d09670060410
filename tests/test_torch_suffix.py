"""Parity of femto_tpu_torch's suffix sort with femto_tpu's, on the CPU.

Each plain version of a sort kernel (ops/sort_ops.py, and the payload in
ops/build_ops.py) is held against the JAX stage it replaces on the same
seeded numpy inputs, and suffix_array as a whole against femto_tpu's
suffix_array and the numpy oracle.  Everything is integers: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import suffix as JS
from femto_tpu.ops import build_ops as JB
from femto_tpu_torch import suffix as TS
from femto_tpu_torch.ops import build_ops as TB
from femto_tpu_torch.ops import sort_ops as SO
from tests.test_torch_build import CORPORA

I32 = torch.int32


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _twins():
    """Two identical documents among others: a long doubling tail."""
    rng = np.random.default_rng(21)
    doc = bytes(rng.integers(0, 256, size=1200).astype(np.uint8))
    return [doc, b"between", doc]


def _zipf_text(n, seed):
    """n symbols, p ~ 1/rank over 12 symbols, with one 40-symbol fragment
    copied twice: ties after the first sort, but short ones."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, 13)
    text = (rng.choice(12, size=n, p=p / p.sum()) + 3).astype(np.int32)
    text[n // 3: n // 3 + 40] = text[100:140]
    text[2 * n // 3: 2 * n // 3 + 40] = text[100:140]
    return text


def _texts():
    rng = np.random.default_rng(17)
    out = {name: (lambda f=f: ft.prepare_documents(f()).text
                  .astype(np.int32)) for name, f in CORPORA.items()}
    out["twins"] = lambda: ft.prepare_documents(_twins()).text.astype(
        np.int32)
    out["bytes"] = lambda: rng.integers(1, 261, size=4000).astype(np.int32)
    out["zipf"] = lambda: _zipf_text(6000, 9)
    out["n1"] = lambda: np.array([7], np.int32)
    out["n2_same"] = lambda: np.array([7, 7], np.int32)
    out["n2"] = lambda: np.array([9, 7], np.int32)
    return out


TEXTS = _texts()


# ---------------------------------------------------------------------------
# suffix_array as a whole
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,regime", [
    ("graft", "extension+doubling"), ("conformance", "doubling"),
    ("repeats", "doubling"), ("twins", "doubling"), ("bytes", "sorted"),
    ("zipf", "extension"), ("n1", "sorted"), ("n2_same", "sorted"),
    ("n2", "sorted"),
])
def test_suffix_array_matches_reference(name, regime):
    text = TEXTS[name]()
    n = len(text)
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    alpha = np.unique(text).astype(np.int32)
    sa, pull = tt.suffix_array(_t(text), _t(payload), alpha)
    assert TS.last_stats["regime"] == regime, TS.last_stats
    want = JS.suffix_array_np(text.astype(np.int64)).astype(np.int32)
    assert sa.dtype == I32 and np.array_equal(sa.numpy(), want)
    assert pull.dtype == I32 and np.array_equal(pull.numpy(), payload[want])
    if n > 1:
        j_sa, j_pull = JS.suffix_array(jnp.asarray(text),
                                       jnp.asarray(payload), alpha)
        assert np.array_equal(sa.numpy(), np.asarray(j_sa))
        assert np.array_equal(pull.numpy(), np.asarray(j_pull))
    # without alpha the histogram finds the same alphabet
    assert np.array_equal(tt.suffix_array(_t(text)).numpy(), want)
    assert TS.last_stats["K"] == len(alpha)


def test_regimes_follow_the_tied_count():
    """m = 0 ends after the first sort, m > n/4 goes straight to doubling,
    anything between extends first (at most _EXT_MAX_ROUNDS rounds)."""
    tt.suffix_array(_t(TEXTS["zipf"]()))
    st = dict(TS.last_stats)
    assert 0 < st["tied"][0] <= 6000 // 4
    assert 1 <= st["ext_rounds"] <= TS._EXT_MAX_ROUNDS
    assert st["dbl_rounds"] == 0 and st["tied"][-1] == 0
    tt.suffix_array(_t(TEXTS["repeats"]()))
    st = dict(TS.last_stats)
    assert st["tied"][0] > len(TEXTS["repeats"]()) // 4
    assert st["ext_rounds"] == 0 and st["dbl_rounds"] >= 5
    tt.suffix_array(_t(TEXTS["graft"]()))
    st = dict(TS.last_stats)
    assert st["ext_rounds"] == TS._EXT_MAX_ROUNDS and st["dbl_rounds"] >= 1
    assert len(st["tied"]) == 1 + st["ext_rounds"] + st["dbl_rounds"]


def test_suffix_array_arguments():
    t = _t(TEXTS["n2"]())
    # n_real, the fourth positional parameter as in femto_tpu, must lie in
    # [1, n]; pad suffixes sort first, shortest first
    with pytest.raises(ValueError, match="n_real"):
        tt.suffix_array(t, None, None, 0)
    with pytest.raises(ValueError, match="n_real"):
        tt.suffix_array(t, n_real=3)
    padded = _t(np.array([9, 7, 0, 0], np.int32))
    assert tt.suffix_array(padded, None, None, 2).tolist() == [3, 2, 1, 0]
    with pytest.raises(ValueError, match="512"):
        tt.suffix_array(_t(np.array([3, 600], np.int32)))
    with pytest.raises(ValueError, match="512"):
        tt.suffix_array(_t(np.array([3, -1], np.int32)))
    with pytest.raises(ValueError, match="empty"):
        tt.suffix_array(torch.zeros(0, dtype=I32))
    # a superset alphabet only weakens the pack rate
    text = TEXTS["zipf"]()
    want = JS.suffix_array_np(text.astype(np.int64))
    sa = tt.suffix_array(_t(text), alpha=np.arange(1, 300))
    assert np.array_equal(sa.numpy(), want)
    # int64 text and payload are taken too
    sa, pull = tt.suffix_array(_t(text.astype(np.int64)),
                               _t(np.arange(len(text)) << 33))
    assert np.array_equal(pull.numpy() >> 33, want)


# ---------------------------------------------------------------------------
# kernel G: histogram and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["graft", "zipf", "n1"])
def test_sym_hist_plain_matches_jax(name):
    text = TEXTS[name]()
    want = np.asarray(JS._alpha_hist(jnp.asarray(text), n=len(text)))
    got = SO.sym_hist(_t(text)).numpy()
    assert got.dtype == np.int32 and got.shape == (513,)
    assert np.array_equal(got[:512], want) and got[512] == 0
    assert np.array_equal(TS.text_alphabet(_t(text)), np.unique(text))
    bad = np.concatenate([text, [512, -5, 1 << 20]]).astype(np.int32)
    got = SO.sym_hist(_t(bad)).numpy()
    assert np.array_equal(got[:512], want) and got[512] == 3


@pytest.mark.parametrize("name,bits", [("zipf", 5), ("repeats", 4),
                                       ("graft", 9)])
def test_sa_keys_plain_matches_jax(name, bits):
    """At the reference's width (per = 30 // bits codes to a key) the
    packed key equals _remap_stage + _keys_stage's key0."""
    text = TEXTS[name]()
    n = len(text)
    used = np.unique(text).astype(np.int32)
    assert len(used).bit_length() <= bits
    per = 30 // bits
    codes = JS._remap_stage(jnp.asarray(text), jnp.asarray(used), n=n,
                            K=len(used))
    want = np.asarray(JS._keys_stage(codes, n=n, per_key=per, bits=bits,
                                     nkeys=1)[0])
    lut = _t(TS.alpha_lut(used))
    got = SO.sa_keys(_t(text), lut, bits=bits, per=per)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    # the port's full width: the same codes, more of them
    b, p = TS.key_widths(len(used))
    wide = SO.sa_keys(_t(text), lut, bits=b, per=p).numpy()
    if b == bits:
        assert np.array_equal(wide >> ((p - per) * b), want)
    assert wide.min() >= 0


def test_key_widths_and_lut():
    assert TS.key_widths(30) == (5, 12)
    assert TS.key_widths(257) == (9, 7)
    assert TS.key_widths(1) == (1, 63)
    assert TS.key_widths(512) == (10, 6)
    lut = TS.alpha_lut(np.array([2, 5, 511]))
    assert lut[2] == 1 and lut[5] == 2 and lut[511] == 3 and lut.sum() == 6
    with pytest.raises(ValueError):
        TS.alpha_lut(np.array([512]))


# ---------------------------------------------------------------------------
# kernel H: the sort
# ---------------------------------------------------------------------------


# (m, bit_lo, bit_hi, keys): the sizes about kernel H's tiles (1024 and
# 4096) and its one-block limit (4096), 8192, all-equal and reverse-sorted
# keys, and dist_sort's keys (int32 biased by 2^31, bits 0:32)
SORT_CASES = [
    (1, 0, 63, "random"), (31, 0, 63, "random"), (4097, 0, 63, "random"),
    (5000, 8, 24, "random"), (5000, 0, 5, "random"), (300, 32, 63, "random"),
    (1023, 0, 63, "random"), (1025, 0, 60, "random"),
    (4095, 0, 63, "random"), (4096, 0, 63, "random"),
    (8191, 0, 63, "random"), (8192, 0, 60, "random"), (8193, 8, 29, "random"),
    (5000, 0, 63, "equal"), (5000, 0, 63, "reverse"),
    (3000, 62, 63, "random"), (9000, 0, 32, "biased"),
]


@pytest.mark.parametrize(
    "m,bit_lo,bit_hi,kind", SORT_CASES,
    ids=[f"{m}-{lo}-{hi}" + ("" if kind == "random" else f"-{kind}")
         for m, lo, hi, kind in SORT_CASES])
def test_radix_sort_pairs_plain_matches_numpy(m, bit_lo, bit_hi, kind):
    rng = np.random.default_rng(m + bit_lo)
    keys = rng.integers(0, 2**63 - 1, size=m, dtype=np.int64)
    keys[rng.integers(0, m, size=m // 2)] = keys[0]   # many duplicates
    keys[::7] &= 0xFFFF
    if kind == "equal":
        keys[:] = keys[0]
    elif kind == "reverse":
        keys = np.ascontiguousarray(np.sort(keys)[::-1])
    elif kind == "biased":
        keys = rng.integers(-2**31, 2**31, size=m).astype(np.int64) + 2**31
    vals = rng.integers(0, 2**31 - 1, size=m).astype(np.int32)
    field = (keys >> bit_lo) & ((1 << (bit_hi - bit_lo)) - 1)
    order = np.argsort(field, kind="stable")
    sk, sv = SO.radix_sort_pairs(_t(keys), _t(vals), bit_lo, bit_hi)
    assert np.array_equal(sk.numpy(), keys[order])
    assert np.array_equal(sv.numpy(), vals[order])
    sk, sv = SO.radix_sort_pairs(_t(keys), None, bit_lo, bit_hi)
    assert sv.dtype == I32 and np.array_equal(sv.numpy(), order)
    with pytest.raises(ValueError):
        SO.radix_sort_pairs(_t(keys), None, 5, 5)


# ---------------------------------------------------------------------------
# kernels I and J on the state after the first sort
# ---------------------------------------------------------------------------


def _first_sort(text, per=None):
    """(sa, flags, key0, bits, per) after the port's first sort."""
    used = np.unique(text).astype(np.int32)
    bits, full = TS.key_widths(len(used))
    per = full if per is None else per
    key0 = SO.sa_keys(_t(text), _t(TS.alpha_lut(used)), bits=bits, per=per)
    skey, sa = SO.radix_sort_pairs(key0, None, 0, per * bits)
    return sa, SO.group_flags(skey), key0, bits, per


def _j(t):
    """A JAX array holding a copy of a tensor: jnp.asarray may alias the
    tensor's memory, and _filtered_round donates (overwrites) its state."""
    return jnp.array(np.array(t.numpy(), copy=True))


def _padded(a, M, fill):
    out = np.full(M, fill, np.int32)
    out[: len(a)] = a
    return out


@pytest.mark.parametrize("name", ["graft", "repeats", "zipf", "bytes"])
def test_tied_compact_plain_matches_jax(name):
    text = TEXTS[name]()
    n = len(text)
    sa, flags, _, _, _ = _first_sort(text)
    slots, base, m, base_all = SO.tied_compact(flags, want_all=True)
    st = jnp.asarray(flags.numpy().astype(bool))
    M = max(m, 1) + 5
    j_slots = JS._compact_select(st, n=n, M=M)
    j_base = JS._init_base(st, j_slots, n=n, M=M)
    assert m == int(np.sum(np.asarray(JS._unresolved_of(st, n=n))))
    assert np.array_equal(slots.numpy(), np.asarray(j_slots)[:m])
    assert np.array_equal(base.numpy(), np.asarray(j_base)[:m])
    assert (np.asarray(j_slots)[m:] == n).all()
    assert np.array_equal(slots.numpy(), np.asarray(
        JS._compact_slots(JS._unresolved_of(st, n=n), n=n, M=M))[:m])
    # every element's group base: the cummax of the flagged slots
    want_all = np.maximum.accumulate(
        np.where(flags.numpy() != 0, np.arange(n), 0))
    assert np.array_equal(base_all.numpy(), want_all)
    # through a slot list: the same groups, renamed
    if m:
        sub = SO.group_flags(_t(base.numpy().astype(np.int64)))
        s2, b2, m2, all2 = SO.tied_compact(sub, slots, want_all=True)
        assert m2 == m and torch.equal(s2, slots) and torch.equal(b2, base)
        assert torch.equal(all2, base)


@pytest.mark.parametrize("name", ["graft", "repeats", "zipf"])
def test_rank_init_plain_matches_jax(name):
    text = TEXTS[name]()
    n = len(text)
    sa, flags, _, _, _ = _first_sort(text)
    slots, base, m, _ = SO.tied_compact(flags)
    got = SO.rank_init(sa, slots, base)
    want = JS._rank_from_state(_j(sa),
                               jnp.asarray(flags.numpy().astype(bool)), n=n)
    assert got.dtype == I32 and np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["graft", "repeats", "twins"])
def test_doubling_round_matches_jax(name):
    """round_keys (doubling) + sort + tied_compact + round_commit against
    one _filtered_round from the same state."""
    text = TEXTS[name]()
    n = len(text)
    sa, flags, _, bits, per = _first_sort(text)
    slots, base, m, _ = SO.tied_compact(flags)
    assert m > 0
    rank = SO.rank_init(sa, slots, base)
    M = m + 3
    payload = np.arange(n, dtype=np.int32)
    j_sa, _, j_rank, j_slots, j_m = JS._filtered_round(
        _j(sa), jnp.asarray(payload[sa.numpy()]), _j(rank),
        jnp.asarray(_padded(slots.numpy(), M, n)), jnp.int32(per),
        jnp.asarray(payload), M=M)
    shift = n.bit_length()
    pos, key = SO.round_keys(sa, slots, shift=shift, rank=rank, h=per)
    skey, spos = SO.radix_sort_pairs(key, pos, 0,
                                     shift + (n - 1).bit_length())
    s2, b2, m2, base_all = SO.tied_compact(SO.group_flags(skey), slots,
                                           want_all=True)
    SO.round_commit(sa, rank, slots, spos, base_all, skey=skey, shift=shift,
                    base=base)
    assert m2 == int(j_m)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(rank.numpy(), np.asarray(j_rank))
    assert np.array_equal(s2.numpy(), np.asarray(j_slots)[:m2])
    # the new bases are the new ranks of the slots that stay tied
    assert np.array_equal(b2.numpy(), rank.numpy()[sa.numpy()[s2.numpy()]])


@pytest.mark.parametrize("name,e", [("graft", 3), ("zipf", 6),
                                    ("repeats", 7)])
def test_extension_round_matches_jax(name, e):
    """round_keys (extension) + sort + tied_compact + round_commit against
    one _extend_round_impl reading one word of e symbols (e * bits <= 30,
    the reference's key width) from the same state."""
    text = TEXTS[name]()
    n = len(text)
    sa, flags, key0, bits, per = _first_sort(text)
    assert e * bits <= 30 and e <= per
    slots, base, m, _ = SO.tied_compact(flags)
    assert m > 0
    used = np.unique(text).astype(np.int32)
    codes = JS._remap_stage(jnp.asarray(text), jnp.asarray(used), n=n,
                            K=len(used))
    j_key0 = JS._keys_stage(codes, n=n, per_key=e, bits=bits, nkeys=1)[0]
    M = m + 3
    payload = np.arange(n, dtype=np.int32)
    j_sa, _, j_st, j_slots, j_base, j_m = JS._extend_round_impl(
        _j(sa), jnp.asarray(payload[sa.numpy()]),
        jnp.asarray(flags.numpy().astype(bool)), jnp.asarray(payload), j_key0,
        jnp.asarray(_padded(slots.numpy(), M, n)),
        jnp.asarray(_padded(base.numpy(), M, 0)), jnp.int32(per),
        n=n, M=M, T=1, per_key=e)
    shift = e * bits
    pos, key = SO.round_keys(sa, slots, shift=shift, base=base, key0=key0,
                             w=per, drop=(per - e) * bits)
    skey, spos = SO.radix_sort_pairs(key, pos, 0,
                                     shift + (n - 1).bit_length())
    s2, b2, m2, _ = SO.tied_compact(SO.group_flags(skey), slots)
    SO.round_commit(sa, None, slots, spos, None, skey=skey, shift=shift,
                    base=base)
    assert m2 == int(j_m)
    assert np.array_equal(sa.numpy(), np.asarray(j_sa))
    assert np.array_equal(s2.numpy(), np.asarray(j_slots)[:m2])
    assert np.array_equal(b2.numpy(), np.asarray(j_base)[:m2])
    # and against a direct sort of the suffixes' first per + e symbols
    pad = np.concatenate([text, np.zeros(per + e, np.int32)])
    pref = np.stack([pad[j: j + n] for j in range(per + e)], axis=1)
    order = np.lexsort(pref[:, ::-1].T)
    assert np.array_equal(pref[sa.numpy()], pref[order])


def test_round_commit_plain_asserts_groups_stay():
    text = TEXTS["repeats"]()
    n = len(text)
    sa, flags, _, _, per = _first_sort(text)
    slots, base, m, _ = SO.tied_compact(flags)
    rank = SO.rank_init(sa, slots, base)
    shift = n.bit_length()
    pos, key = SO.round_keys(sa, slots, shift=shift, rank=rank, h=per)
    skey, spos = SO.radix_sort_pairs(key, pos, 0, 62)
    wrong = torch.roll(base, 1)
    with pytest.raises(AssertionError, match="group"):
        SO.round_commit(sa, None, slots, spos, None, skey=skey, shift=shift,
                        base=wrong)


# ---------------------------------------------------------------------------
# kernels K and L
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("corpus,mark_period", [
    ("repeats", 20), ("repeats", 0), ("conformance", 20), ("graft", 0),
])
def test_sa_payload_plain_matches_jax(corpus, mark_period):
    """`repeats` holds an empty document."""
    prepared = ft.prepare_documents(CORPORA[corpus]())
    text = prepared.text.astype(np.int32)
    ds = prepared.doc_starts.astype(np.int32)
    kw = dict(n=prepared.n, mark_period=mark_period,
              ndocs=prepared.num_docs)
    want = JB.build_sa_payload(jnp.asarray(text), jnp.asarray(ds), **kw)
    got = TB.sa_payload_plain(_t(text), _t(ds), **kw)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    assert torch.equal(TB.build_sa_payload(_t(text), _t(ds), **kw), got)
    with pytest.raises(ValueError, match="int32"):
        TB.build_sa_payload(_t(text.astype(np.int64)), _t(ds), **kw)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_gather_rows_plain(dtype):
    rng = np.random.default_rng(8)
    src = rng.integers(0, 2**31 - 1, size=1000).astype(dtype)
    idx = rng.integers(0, 1000, size=5000).astype(np.int32)
    got = SO.gather_rows(_t(src), _t(idx))
    assert got.dtype == _t(src).dtype
    assert np.array_equal(got.numpy(), src[idx])
    idx[:3] = [-1, 1000, 2**31 - 1]
    got = SO.gather_rows(_t(src), _t(idx)).numpy()
    assert (got[:3] == -1).all() and np.array_equal(got[3:], src[idx[3:]])
    assert SO.gather_rows(_t(src), _t(idx[:0])).shape == (0,)
    with pytest.raises(ValueError):
        SO.gather_rows(_t(src.astype(np.int16)), _t(idx))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("ncols", [1, 3, 8])
@pytest.mark.parametrize("m", [0, 1, 7, 4099])
def test_gather_cols_plain(dtype, ncols, m):
    """The multi-column form against per-column gather_rows_plain and
    numpy: -1 and out-of-range indices, lengths that are no multiple of
    4, idx and the outputs as views that start off a 16-byte boundary
    (rows of the caller's arrays)."""
    rng = np.random.default_rng(100 + 7 * ncols + m)
    n = 1003
    srcs = [rng.integers(-2**31, 2**31 - 1, size=n).astype(dtype)
            for _ in range(ncols)]
    big = rng.integers(0, n, size=m + 3).astype(np.int32)
    if m:
        big[1::5] = -1
        big[2::7] = n
        big[3::11] = 2**31 - 1
    idx = _t(big)[3:]                    # 12 bytes past the allocation
    outs = torch.full((ncols, m + 1), 7, dtype=_t(srcs[0]).dtype)[:, 1:]
    rows = [outs[c].contiguous() for c in range(ncols)]
    got = SO.gather_cols([_t(s) for s in srcs], idx, rows)
    assert len(got) == ncols and all(g is r for g, r in zip(got, rows))
    fresh = SO.gather_cols([_t(s) for s in srcs], idx)
    i = big[3:].astype(np.int64)
    inside = (i >= 0) & (i < n)
    for c, s in enumerate(srcs):
        want = np.where(inside, s[np.clip(i, 0, n - 1)], -1).astype(dtype)
        assert got[c].dtype == _t(s).dtype
        np.testing.assert_array_equal(got[c].numpy(), want)
        np.testing.assert_array_equal(fresh[c].numpy(), want)
        np.testing.assert_array_equal(
            SO.gather_rows_plain(_t(s), idx).numpy(), want)


def test_gather_cols_refuses():
    a = torch.arange(10, dtype=torch.int32)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        SO.gather_cols([], idx)
    with pytest.raises(ValueError):
        SO.gather_cols([a, a.long()], idx)           # two dtypes
    with pytest.raises(ValueError):
        SO.gather_cols([a, a[:9].clone()], idx)      # two lengths
    with pytest.raises(ValueError):
        SO.gather_cols([a], idx, [torch.empty(3, dtype=torch.int32)])
    with pytest.raises(ValueError):
        SO.gather_cols([a], idx, [])
    with pytest.raises(ValueError):
        SO.gather_cols([a.to(torch.int16)], idx)


def test_direct_locate_goes_through_gather_rows():
    docs = CORPORA["graft"]()
    ix = tt.build_index(tt.prepare_documents(docs), seg=64, mark_period=8,
                        locate="direct", device="cpu")
    rows = np.arange(0, ix.meta.n, 7)
    want = JS.suffix_array_np(tt.prepare_documents(docs).text
                              .astype(np.int64))[rows]
    assert np.array_equal(tt.locate_rows_array(ix, rows), want)
