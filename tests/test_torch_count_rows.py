"""Kernel C's four entries (ops/search_ops.backward_search,
backward_search_steps, backward_step_pair and backward_step_masked)
against femto_tpu's backward_search, backward_search_steps,
backward_step_pair and paged._pair_step on the same arrays.

On the CPU the wrappers run their plain versions; on the card the same
calls go through csrc/backward_search.cu, whose two routes (a thread or a
warp a pattern or lane, both reading a segment once where first and last
share it) chip_smoke.py holds to these plain versions.  Every answer is
an integer, so the tolerance is exact.

Indexes: every tier at seg 64 and 256 on a small mixed corpus; a vseg
index with side segments and u16 symbol lists, a vrle one with side
segments, a prose vrle index with continued run-length segments, and
pad_shape indexes (row0 > 0) on full, vseg and vrle; the packed and row
tiers are remapped (a dense alphabet).  Patterns: slices of the
documents, patterns that empty mid-pattern, absent and outside-alphabet
symbols, and patterns longer than 32 and 64 columns.  Lanes of the
one-step entries: ranges whose ends share a segment (empty and reversed
ones too), ranges ending on side and continued segments, ranges between
row0 - 1, row0, row0 + 1, n_rows - 1 and n_rows, drawn ranges and the
whole range; symbols of the alphabet, -1 lanes, 300 and symbols absent
from the index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import paged as jpaged
from femto_tpu.ops import rank as JR
from femto_tpu.ops import search_ops as JS
from femto_tpu_torch.alphabet import pattern_to_alpha
from femto_tpu_torch.ops import rank as R
from femto_tpu_torch.ops import search_ops as TS
from femto_tpu_torch.search import pack_patterns
from tests.test_torch_dist_query import _corpus
from tests.test_torch_rowtiers import _byte_complete_docs, _prose_docs
from tests.torch_threads import one_torch_thread  # noqa: F401

TIERS = ("full", "compact", "packed", "vseg", "vrle")


def _mixed_docs():
    rng = np.random.default_rng(18)
    return [b"the quick brown fox jumps over the lazy dog",
            b"pack my box with five dozen liquor jugs " * 3,
            b"",
            b"abracadabra" * 30,
            bytes(rng.integers(97, 105, size=2500).astype(np.uint8)),
            b"sheep black sheep baa baa black"]


# name -> (corpus, tier, seg, pad_shape)
INDEXES = {
    **{f"{tier}_{seg}": ("mixed", tier, seg, False)
       for tier in TIERS for seg in (64, 256)},
    "side_vseg_64": ("bytes", "vseg", 64, False),
    "side_vrle_64": ("overflow", "vrle", 64, False),
    "cont_vrle_256": ("prose", "vrle", 256, False),
    "pad_full_64": ("mixed", "full", 64, True),
    "pad_vseg_256": ("mixed", "vseg", 256, True),
    "pad_vrle_64": ("mixed", "vrle", 64, True),
}
ROW_INDEXES = [k for k, v in INDEXES.items() if v[1] in ("vseg", "vrle")]


def _docs(name):
    return {"mixed": _mixed_docs, "bytes": _byte_complete_docs,
            "prose": _prose_docs}.get(name, lambda: _corpus(name))()


@pytest.fixture(scope="module")
def indexes():
    out = {}
    for name, (corpus, tier, seg, pad) in INDEXES.items():
        docs = _docs(corpus)
        prep = tt.prepare_documents(docs)
        kw = dict(pad_shape=(prep.n + 300, prep.num_docs + 2)) if pad else {}
        out[name] = (tt.build_index(prep, seg=seg, mark_period=8, tier=tier,
                                    device="cpu", **kw), docs)
    assert bool((out["side_vseg_64"][0].arrays.seg_woff > 0).any()), \
        "no side segment"
    assert bool((out["side_vrle_64"][0].arrays.seg_woff > 0).any())
    assert bool((out["cont_vrle_256"][0].arrays.seg_woff < -1).any()), \
        "no continued run-length segment"
    for name in ("pad_full_64", "pad_vseg_256", "pad_vrle_64"):
        assert out[name][0].meta.row0 == 300, name
    for name in ("packed_64", "vseg_256", "vrle_64", "cont_vrle_256"):
        assert R.is_remapped(out[name][0].arrays), name
    return out


def _j(t):
    return jnp.array(np.array(t.numpy(), copy=True))


def _jarrays(arrays):
    return ft.FMArrays(**{k: None if v is None else _j(v)
                          for k, v in arrays._asdict().items()})


def _patterns(docs, rng):
    """int32[B, P] right-aligned patterns, -1 on the left: document
    slices of 1 to 80 symbols (past the warp route's 32-column loads),
    slices whose range empties mid-pattern (a symbol changed inside),
    absent and outside-alphabet symbols, the empty pattern."""
    text = b"".join(docs)
    pats = [pattern_to_alpha(b""), pattern_to_alpha(b"\x00zq\xfe"),
            pattern_to_alpha(b"a")]
    for _ in range(90):
        L = int(rng.integers(1, 81))
        if len(text) > L:
            o = int(rng.integers(0, len(text) - L))
            pats.append(pattern_to_alpha(text[o: o + L]))
    for p in pats[3:30]:
        q = p.copy()
        if len(q) > 2:  # a symbol changed mid-pattern: the range empties
            q[len(q) // 2] = (int(q[len(q) // 2]) + 101) % 256
        pats.append(q)
    packed, B = pack_patterns(pats)
    packed[B - 1, -2] = 300  # a code outside the alphabet
    return np.ascontiguousarray(packed[:B].astype(np.int32))


def _lanes(ix, rng, B=600):
    """(c, first, last) int32 lanes of the one-step entries."""
    A, meta = ix.arrays, ix.meta
    seg = R.seg_size(A)
    n_seg = R.n_segments(A)
    s = rng.integers(0, n_seg, 160)
    s[:4] = n_seg - 1
    a = s * seg + rng.integers(0, seg, 160)
    b = s * seg + rng.integers(0, seg, 160)
    a[4:8] = b[4:8]                          # empty ranges
    fs = [np.minimum(a, b), np.maximum(a[:10], b[:10])]   # 10 reversed
    ls = [np.maximum(a, b), np.minimum(a[:10], b[:10])]
    if R.is_row_tier(A):
        woff = A.seg_woff.numpy()
        for segs in (np.nonzero(woff > 0)[0], np.nonzero(woff < -1)[0]):
            if len(segs):
                r = (segs[rng.integers(0, len(segs), 64)] * seg
                     + rng.integers(0, seg, 64))
                r2 = np.roll(r, 1)
                fs.append(np.minimum(r, r2))
                ls.append(np.maximum(r, r2) + 1)
    ends = sorted({r for r in (meta.row0 - 1, meta.row0, meta.row0 + 1,
                               meta.n_rows - 1, meta.n_rows) if r >= 0})
    pairs = [(x, y) for x in ends for y in ends if x < y]
    fs.append(np.array([x for x, _ in pairs]))
    ls.append(np.array([y for _, y in pairs]))
    fs.append(np.array([meta.row0]))
    ls.append(np.array([meta.n_rows]))
    drawn = np.sort(rng.integers(0, meta.n_rows + 1, size=(B, 2)), axis=1)
    fs.append(drawn[:, 0])
    ls.append(drawn[:, 1])
    first = np.resize(np.concatenate(fs), B).astype(np.int32)
    last = np.resize(np.concatenate(ls), B).astype(np.int32)
    if R.is_remapped(A):
        amap = A.alpha_map.numpy()
        syms, absent = np.nonzero(amap >= 0)[0], np.nonzero(amap < 0)[0]
    else:
        syms, absent = np.arange(261), np.zeros(0, np.int64)
    c = syms[rng.integers(0, len(syms), B)].astype(np.int32)
    c[::8] = -1
    c[3::17] = 300
    if len(absent):
        c[5::13] = absent[rng.integers(0, len(absent), len(c[5::13]))]
    return c, first, last


@pytest.mark.parametrize("name", list(INDEXES))
def test_backward_search_like_femto(indexes, name):
    """backward_search from row0 to n_rows equals femto_tpu's."""
    ix, docs = indexes[name]
    pats = _patterns(docs, np.random.default_rng(1))
    meta = ix.meta
    got = TS.backward_search(ix.arrays, meta.n_rows, torch.from_numpy(pats),
                             meta.row0)
    want = JS.backward_search(_jarrays(ix.arrays), meta.n_rows,
                              jnp.asarray(pats), meta.row0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    counts = (got[1] - got[0]).numpy()
    assert (counts > 0).sum() > 50 and (counts[33:] <= 0).any(), \
        "patterns neither found nor emptied"


@pytest.mark.parametrize("name", list(INDEXES))
def test_backward_search_steps_like_femto(indexes, name):
    """backward_search_steps (the range, the last non-empty range and the
    matched count) equals femto_tpu's, ranges that empty mid-pattern
    included."""
    ix, docs = indexes[name]
    pats = _patterns(docs, np.random.default_rng(2))
    meta = ix.meta
    got = TS.backward_search_steps(ix.arrays, meta.n_rows,
                                   torch.from_numpy(pats), meta.row0)
    want = JS.backward_search_steps(_jarrays(ix.arrays), meta.n_rows,
                                    jnp.asarray(pats), meta.row0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    lens = (pats >= 0).sum(axis=1)
    assert ((got[4].numpy() > 0) & (got[4].numpy() < lens)).any(), \
        "no range emptied mid-pattern"


@pytest.mark.parametrize("name", list(INDEXES))
def test_backward_step_pair_like_femto(indexes, name):
    """One free-lane step (the host regex engine's) equals femto_tpu's
    backward_step_pair; -1, absent and outside-alphabet lanes give (0,
    0)."""
    ix, _ = indexes[name]
    c, first, last = _lanes(ix, np.random.default_rng(3))
    got = TS.backward_step_pair(ix.arrays, *map(torch.from_numpy,
                                                (c, first, last)))
    want = jax.jit(JR.backward_step_pair)(_jarrays(ix.arrays),
                                          *map(jnp.asarray, (c, first, last)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    dead = (c < 0) | (c >= 261)
    assert not got[0].numpy()[dead].any() and not got[1].numpy()[dead].any()


@pytest.mark.parametrize("name", ROW_INDEXES)
def test_backward_step_masked_like_femto(indexes, name):
    """The paged count's masked step equals femto_tpu's paged._pair_step:
    -1 lanes keep their range, the others step."""
    ix, _ = indexes[name]
    c, first, last = _lanes(ix, np.random.default_rng(4))
    got = TS.backward_step_masked(ix.arrays, *map(torch.from_numpy,
                                                  (c, first, last)))
    want = jpaged._pair_step(_jarrays(ix.arrays),
                             *map(jnp.asarray, (c, first, last)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keep = c < 0
    np.testing.assert_array_equal(got[0].numpy()[keep], first[keep])
    np.testing.assert_array_equal(got[1].numpy()[keep], last[keep])
