"""Parity of femto_tpu_torch's chunked builds with femto_tpu's, on the CPU.

The port's doc lists (kernel P's plain versions), shape-padded builds,
suffix_array(n_real=...), the uint8 upload (_escape_positions and kernel
Q's plain version), bwt_from_sa, checkpoint files and femto_tpu_torch.multi
(build_chunked_prepared, MultiIndex, extract_prepared, merge_indexes,
IncrementalIndex) against femto_tpu's on the same seeded inputs.  Every
output is integers or bytes: the tolerance is exact equality.  femto_tpu's
chunked indexes are built once per module (fixtures), because each new
shape costs femto_tpu an XLA compile.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import fmindex as JF
from femto_tpu import multi as JM
from femto_tpu import suffix as JS
from femto_tpu.alphabet import PreparedText as JPrepared
from femto_tpu.ops import build_ops as JB
from femto_tpu_torch import fmindex as TF
from femto_tpu_torch import multi as TM
from femto_tpu_torch import suffix as TSX
from femto_tpu_torch.alphabet import PreparedText
from femto_tpu_torch.ops import build_ops as TB
from tests.oracle import naive_count, naive_locate
from tests.test_torch_build import as_numpy, assert_same_bits
from tests.test_torch_query import _q_docs
from tests.test_torch_search import _carry
from tests.torch_threads import one_torch_thread  # noqa: F401

TIERS = ["full", "compact", "packed", "vseg", "vrle"]
NEEDLE = b"NEEDLE-XY"


def _docs():
    """Nine documents: letters, a binary one (bytes 0 and 255 included),
    an empty one; headers on some."""
    rng = np.random.default_rng(5)
    docs = [bytes(rng.integers(97, 103, size=int(rng.integers(30, 300)))
                  .astype(np.uint8)) for _ in range(9)]
    docs[3] = bytes([0, 255]) + bytes(rng.integers(0, 256, size=120)
                                      .astype(np.uint8))
    docs[5] = b""
    headers = [b"hdr%d" % i if i % 3 == 0 else b"" for i in range(9)]
    return docs, headers


def _chunk_docs():
    """Fourteen short documents, the needle planted in three."""
    rng = np.random.default_rng(11)
    docs = [bytes(rng.integers(97, 101, size=int(rng.integers(20, 110)))
                  .astype(np.uint8)) for _ in range(14)]
    for d in (0, 6, 13):
        docs[d] = docs[d][:5 + d] + NEEDLE + docs[d][5 + d:]
    docs[4] = bytes([0, 255, 7]) + docs[4]
    docs[9] = b""
    headers = [b"h%d" % i if i % 4 == 1 else b"" for i in range(14)]
    return docs, headers


def _prep(docs, headers):
    return (ft.prepare_documents(docs, headers=headers),
            tt.prepare_documents(docs, headers=headers))


def _assert_same_index(got, want, with_lists=True):
    for field in ft.FMArrays._fields:
        w = getattr(want.arrays, field)
        g = getattr(got.arrays, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert_same_bits(field, as_numpy(g), np.asarray(w))
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    assert_same_bits("doc_starts_np", got.doc_starts_np, want.doc_starts_np)
    assert got.infos == want.infos
    assert (got.header_lens_np is None) == (want.header_lens_np is None)
    if want.header_lens_np is not None:
        assert np.array_equal(got.header_lens_np, want.header_lens_np)
    if with_lists:
        assert want.chunk_docs_np is not None
        assert_same_bits("chunk_doc_offsets_np", got.chunk_doc_offsets_np,
                         want.chunk_doc_offsets_np)
        assert_same_bits("chunk_docs_np", got.chunk_docs_np,
                         want.chunk_docs_np)


@pytest.fixture(scope="module")
def corpus():
    docs, headers = _docs()
    jp, tp = _prep(docs, headers)
    return docs, jp, tp


# ---------------------------------------------------------------------------
# doc lists (K14) and shape-padded builds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("padded", [False, True], ids=["plain", "pad_shape"])
@pytest.mark.parametrize("tier", TIERS)
def test_doc_chunks_build_matches_jax(corpus, tier, padded):
    """build_index(doc_chunks=True): the doc lists and, under pad_shape,
    every field of every tier equal femto_tpu's."""
    docs, jp, tp = corpus
    kw = dict(seg=64, mark_period=8, tier=tier, doc_chunks=True)
    if padded:
        kw["pad_shape"] = (jp.n + 333, jp.num_docs + 3)
    want = ft.build_index(jp, **kw)
    got = tt.build_index(tp, device="cpu", **kw)
    _assert_same_index(got, want)
    if padded:
        assert got.meta.row0 == 333 and got.meta.n_rows == jp.n + 333
    if not padded:
        # the host oracle, the port's copy and femto_tpu's, agrees
        sa = JS.suffix_array_np(jp.text.astype(np.int64))
        n_seg = got.meta.n_seg
        offs, lists = TF.compute_chunk_doc_lists(sa, tp.doc_starts, 64,
                                                 n_seg)
        woffs, wlists = JF.compute_chunk_doc_lists(sa, jp.doc_starts, 64,
                                                   n_seg)
        for name, g, w in (("offsets", offs, woffs), ("docs", lists, wlists),
                           ("built", got.chunk_docs_np, lists)):
            assert_same_bits(name, g, w)


@pytest.mark.parametrize("seg", [64, 256, 2048, 65504])
def test_doc_lists_plain_matches_jax(corpus, seg):
    """Kernel P's plain versions against _doc_lists_stage and
    _flatten_ragged, up to the largest segment l1_group_for accepts, on a
    padded suffix array (pad rows and rows past it hold no document)."""
    docs, jp, tp = corpus
    assert TF.l1_group_for(seg) >= 1
    n = jp.n
    n_rows = n + 70
    text = np.concatenate([jp.text.astype(np.int32),
                           np.zeros(n_rows - n, np.int32)])
    sa = np.array(JS.suffix_array(jnp.asarray(text), n_real=n))
    ds = np.concatenate([jp.doc_starts,
                         np.full(2, n, np.int64)]).astype(np.int32)
    n_seg = n_rows // seg + 1
    wv, wc = JB._doc_lists_stage(jnp.asarray(sa), jnp.asarray(ds), n=n,
                                 n_seg=n_seg, seg=seg)
    vals, counts = TB.doc_lists(torch.from_numpy(sa), torch.from_numpy(ds),
                                n_real=n, n_seg=n_seg, seg=seg)
    assert_same_bits("vals", as_numpy(vals), np.asarray(wv))
    assert_same_bits("counts", as_numpy(counts), np.asarray(wc))
    offsets = np.zeros(n_seg + 1, np.int64)
    np.cumsum(as_numpy(counts), out=offsets[1:])
    flat = TB.flatten_ragged(vals, counts, torch.from_numpy(offsets))
    total = int(offsets[-1])
    wflat = JB._flatten_ragged(wv, wc, jnp.asarray(offsets[:-1].astype(
        np.int32)), total_pad=max(-(-total // 1024) * 1024, 1024), W=seg)
    assert_same_bits("docs", as_numpy(flat), np.asarray(wflat)[:total])
    woffs, wdocs = JB.build_doc_lists_device(
        jnp.asarray(sa), jnp.asarray(ds), n=n, n_seg=n_seg, seg=seg)
    offs, tdocs = TB.build_doc_lists_device(
        torch.from_numpy(sa), torch.from_numpy(ds), n=n, n_seg=n_seg,
        seg=seg)
    assert_same_bits("offsets", offs, woffs)
    assert_same_bits("docs", tdocs, wdocs)


@pytest.mark.parametrize("tier", ["full", "packed", "vseg"])
def test_pad_shape_answers_match_unpadded(corpus, tier):
    """A padded index answers as the unpadded one and the documents do
    (femto_tpu's test_pad_shape_parity, on the port)."""
    from femto_tpu_torch.query.engine import count_query

    docs, jp, tp = corpus
    base = tt.build_index(tp, seg=64, mark_period=8, tier=tier, device="cpu")
    pad = tt.build_index(tp, seg=64, mark_period=8, tier=tier, device="cpu",
                         pad_shape=(tp.n + 333, tp.num_docs + 3))
    for pat in [b"ab", b"ba", b"aa", docs[2][:5], docs[6][-4:], b"zzz",
                b"\x00\xff"]:
        assert int(tt.count(pad, [pat])[0]) == int(tt.count(base, [pat])[0])\
            == naive_count(docs, pat)
        assert tt.locate(pad, pat) == naive_locate(docs, pat)
    assert tt.extract_all_documents(pad) == docs
    for expr in ("ab[ab]", "a(b|c)"):
        assert count_query(pad, expr) == count_query(base, expr)


def test_pad_shape_arguments(corpus, tmp_path):
    docs, jp, tp = corpus
    with pytest.raises(ValueError, match="smaller"):
        tt.build_index(tp, device="cpu", pad_shape=(tp.n - 1, tp.num_docs))
    with pytest.raises(ValueError, match="smaller"):
        tt.build_index(tp, device="cpu", pad_shape=(tp.n, tp.num_docs - 1))
    with pytest.raises(ValueError, match="incompatible"):
        tt.build_index(tp, device="cpu", pad_shape=(tp.n + 5, tp.num_docs),
                       checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="incompatible"):
        tt.build_index(tp, device="cpu", pad_shape=(tp.n + 5, tp.num_docs),
                       sa=np.arange(tp.n))
    assert not os.listdir(tmp_path)


# ---------------------------------------------------------------------------
# suffix_array(n_real=...) and bwt_from_sa
# ---------------------------------------------------------------------------


def _padded_texts():
    rng = np.random.default_rng(9)
    p = 1.0 / np.arange(1, 13)
    zipf = (rng.choice(12, size=3000, p=p / p.sum()) + 3).astype(np.int32)
    zipf[1000:1040] = zipf[100:140]
    rep = np.tile(np.array([5, 6, 7, 5, 6, 8], np.int32), 300)
    docs, headers = _docs()
    prep = ft.prepare_documents(docs, headers=headers).text.astype(np.int32)
    return {"zipf": (zipf, 2500), "repeats": (rep, 700),
            "prepared": (prep, 5), "one": (np.array([9], np.int32), 1)}


@pytest.mark.parametrize("name", sorted(_padded_texts()))
def test_suffix_array_n_real_matches_jax(name):
    """The SA of a text padded with zeros equals femto_tpu's (and the
    port's without n_real: a text has one SA); with n_real the pad run
    settles in the first sort."""
    text, pad = _padded_texts()[name]
    n_real = len(text)
    t = np.concatenate([text, np.zeros(pad, np.int32)])
    want = np.asarray(JS.suffix_array(jnp.asarray(t), n_real=n_real))
    got = tt.suffix_array(torch.from_numpy(t), n_real=n_real)
    with_n_real = dict(TSX.last_stats)
    assert_same_bits("sa", as_numpy(got), want)
    plain = tt.suffix_array(torch.from_numpy(t))
    assert_same_bits("sa without n_real", as_numpy(plain), want)
    # without n_real the pad suffixes that hold a whole key tie
    per = with_n_real["per"]
    assert with_n_real["tied"][0] <= \
        TSX.last_stats["tied"][0] - max(0, pad - per + 1)
    # the keys: the pad suffixes n - 1 - p, the real ones unchanged
    from femto_tpu_torch.ops import sort_ops as SO

    used = np.unique(t).astype(np.int32)
    bits, per = TSX.key_widths(len(used))
    lut = torch.from_numpy(TSX.alpha_lut(used))
    k = SO.sa_keys(torch.from_numpy(t), lut, bits=bits, per=per,
                   n_real=n_real).numpy()
    k0 = SO.sa_keys(torch.from_numpy(t), lut, bits=bits, per=per).numpy()
    assert np.array_equal(k[:n_real], k0[:n_real])
    assert np.array_equal(k[n_real:], np.arange(pad - 1, -1, -1))


def test_bwt_from_sa_matches_jax(corpus):
    docs, jp, tp = corpus
    text = jp.text.astype(np.int32)
    sa = tt.suffix_array(torch.from_numpy(text))
    got = tt.bwt_from_sa(torch.from_numpy(text), sa)
    want = np.asarray(JS.bwt_from_sa(jnp.asarray(text),
                                     jnp.asarray(sa.numpy())))
    assert_same_bits("bwt", as_numpy(got), want)
    got64 = TSX.bwt_from_sa(torch.from_numpy(text.astype(np.int64)), sa)
    assert np.array_equal(got64.numpy(), want)
    with pytest.raises(ValueError, match="int32"):
        tt.bwt_from_sa(torch.from_numpy(text), sa.long())


# ---------------------------------------------------------------------------
# the uint8 upload
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra_docs", [0, 3])
@pytest.mark.parametrize("headers", [False, True])
def test_escape_positions_match_jax(headers, extra_docs):
    docs, hdrs = _docs()
    jp, tp = _prep(docs, hdrs if headers else None)
    got = TF._escape_positions(tp, tp.num_docs + extra_docs)
    want = JF._escape_positions(jp, jp.num_docs + extra_docs)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same_bits("positions", g, w)


def test_escape_positions_refuse_a_hand_built_text():
    """None, femto_tpu's switch to the uint16 upload, where the text holds
    an escape symbol that the document layout does not place."""
    docs, hdrs = _docs()
    for mod, prep in ((TF, tt.prepare_documents(docs, headers=hdrs)),
                      (JF, ft.prepare_documents(docs, headers=hdrs))):
        text = prep.text.copy()
        text[int(prep.doc_starts[1]) + 6] = 3  # a stray SOH in content
        cls = PreparedText if mod is TF else JPrepared
        hand = cls(text=text, doc_starts=prep.doc_starts, infos=prep.infos,
                   header_lens=prep.header_lens)
        assert mod._escape_positions(hand, prep.num_docs) is None
        assert mod._escape_positions(prep, prep.num_docs) is not None


@pytest.mark.parametrize("headers", [False, True])
def test_expand_u8_plain_matches_jax(headers):
    """Kernel Q's plain version against _expand_u8: headers, bytes 0 and
    255, an empty document, a padded tail and pad positions dropped."""
    docs, hdrs = _docs()
    jp, tp = _prep(docs, hdrs if headers else None)
    n, n_build, nd = tp.n, tp.n + 50, tp.num_docs + 2
    u8 = TM._content_u8(tp.text, n_build)
    jax_u8 = (jp.text.astype(np.int32) - 5).astype(np.uint8)
    assert np.array_equal(u8[:n], jax_u8) and not u8[n:].any()
    esc = TF._escape_positions(tp, nd)
    esc[0][-1] = n_build  # outside the text: dropped too
    got = TB.expand_u8(torch.from_numpy(u8), n, *map(torch.from_numpy, esc))
    want = JF._expand_u8(jnp.asarray(u8), n, *map(jnp.asarray, esc))
    assert_same_bits("codes", as_numpy(got), np.asarray(want))
    assert np.array_equal(as_numpy(got)[:n], tp.text.astype(np.int32))
    assert not as_numpy(got)[n:].any()


def test_device_text_arguments(corpus):
    """text_dev16 / text_dev32 give the same index as the host upload;
    wrong shapes, types and both at once are refused."""
    docs, jp, tp = corpus
    want = tt.build_index(tp, seg=64, mark_period=8, device="cpu")
    t16 = torch.from_numpy(tp.text.astype(np.uint16).view(np.int16))
    for kw in ({"text_dev16": t16},
               {"text_dev16": t16.view(torch.uint16)},
               {"text_dev32": torch.from_numpy(tp.text.astype(np.int32))}):
        got = tt.build_index(tp, seg=64, mark_period=8, device="cpu", **kw)
        _assert_same_index(got, want, with_lists=False)
    with pytest.raises(ValueError, match="text_dev32"):
        tt.build_index(tp, device="cpu", text_dev32=t16.to(torch.int32)[:-1])
    with pytest.raises(ValueError, match="text_dev32"):
        tt.build_index(tp, device="cpu", text_dev32=t16.to(torch.int64))
    with pytest.raises(ValueError, match="text_dev16"):
        tt.build_index(tp, device="cpu", text_dev16=t16.to(torch.int32))
    with pytest.raises(ValueError, match="lies on meta"):
        tt.build_index(tp, device="cpu", text_dev32=torch.empty(
            tp.n, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="at most one"):
        tt.build_index(tp, device="cpu", text_dev16=t16,
                       text_dev32=t16.to(torch.int32))


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["femto_tpu", "port"])
def test_checkpoint_dir_files_are_shared(corpus, tmp_path, monkeypatch,
                                         writer):
    """sa_{n}.npy written by one package is read by the other (whose sort
    is then never called), byte for byte the same file."""
    docs, jp, tp = corpus
    d = str(tmp_path)
    path = os.path.join(d, f"sa_{jp.n}.npy")
    if writer == "femto_tpu":
        want = ft.build_index(jp, seg=64, mark_period=8, checkpoint_dir=d)
        with open(path, "rb") as f:
            written = f.read()

        def no_sort(*a, **k):
            raise AssertionError("the checkpoint was not read")

        monkeypatch.setattr(TSX, "suffix_array", no_sort)
        got = tt.build_index(tp, seg=64, mark_period=8, checkpoint_dir=d,
                             device="cpu")
    else:
        got = tt.build_index(tp, seg=64, mark_period=8, checkpoint_dir=d,
                             device="cpu")
        with open(path, "rb") as f:
            written = f.read()
        monkeypatch.setattr(JS, "suffix_array", lambda *a, **k: 1 / 0)
        want = ft.build_index(jp, seg=64, mark_period=8, checkpoint_dir=d)
    _assert_same_index(got, want, with_lists=False)
    with open(path, "rb") as f:
        assert f.read() == written
    assert os.listdir(d) == [f"sa_{jp.n}.npy"]


# ---------------------------------------------------------------------------
# chunked builds and MultiIndex
# ---------------------------------------------------------------------------

CHUNK_QUERIES = ["NEEDLE AND ab", "NEEDLE-XY OR dcb", "ab NOT NEEDLE",
                 "acd THEN 5 bad"]


@pytest.fixture(scope="module")
def chunked():
    """femto_tpu's chunked indexes of the chunk corpus, one per
    (max_chunk_symbols, uniform)."""
    docs, headers = _chunk_docs()
    jp, tp = _prep(docs, headers)
    assert jp.n > 700
    out = {}
    for mcs in (600, 700):
        for uniform in (True, False):
            out[mcs, uniform] = JM.build_chunked_prepared(
                jp, max_chunk_symbols=mcs, uniform=uniform, seg=64,
                mark_period=8)
    return docs, jp, tp, out


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("mcs", [600, 700])
def test_build_chunked_prepared_matches_jax(chunked, mcs, uniform, prefetch):
    """Each chunk field for field (doc lists, row0, n_rows included), and
    count, locate and docs_query on the MultiIndex."""
    docs, jp, tp, jmis = chunked
    want = jmis[mcs, uniform]
    got = TM.build_chunked_prepared(tp, max_chunk_symbols=mcs,
                                    uniform=uniform, prefetch=prefetch,
                                    seg=64, mark_period=8, device="cpu")
    assert len(got.indexes) == len(want.indexes) >= 2
    for g, w in zip(got.indexes, want.indexes):
        _assert_same_index(g, w)
    if uniform:
        assert got.indexes[-1].meta.row0 > 0
    assert got.n == want.n == jp.n and got.num_docs == len(docs)
    pats = [NEEDLE, b"ab", b"dcb", b"\x00\xff", b"zz", b""]
    assert np.array_equal(got.count(pats), want.count(pats))
    assert got.count(pats[:-1]).tolist() == [naive_count(docs, p)
                                             for p in pats[:-1]]
    assert got.locate(NEEDLE) == want.locate(NEEDLE) \
        == naive_locate(docs, NEEDLE)
    assert got.locate(b"ab", max_matches=5) == \
        want.locate(b"ab", max_matches=5)
    for q in CHUNK_QUERIES:
        for wo in (True, False):
            assert got.docs_query(q, with_offsets=wo) == \
                want.docs_query(q, with_offsets=wo), (q, wo)
        assert got.count_query(q) == want.count_query(q), q
    assert got.info(3) == want.info(3)


def test_chunk_bounds_and_errors(chunked):
    docs, jp, tp, jmis = chunked
    with pytest.raises(ValueError, match="alone exceeds"):
        TM.build_chunked_prepared(tp, max_chunk_symbols=50, device="cpu")
    assert TM.MAX_CHUNK_SYMBOLS == JM.MAX_CHUNK_SYMBOLS
    one = TM.build_chunked_prepared(tp, seg=64, mark_period=8, device="cpu")
    assert len(one.indexes) == 1 and one.indexes[0].meta.row0 == 0
    # a hand-built text takes the uint16 upload: the same chunks
    text = tp.text.copy()
    text[int(tp.doc_starts[2]) + 1] = 3
    hand = PreparedText(text=text, doc_starts=tp.doc_starts,
                        infos=tp.infos, header_lens=tp.header_lens)
    jhand = JPrepared(text=text, doc_starts=jp.doc_starts, infos=jp.infos,
                      header_lens=jp.header_lens)
    assert TF._escape_positions(hand, 20) is None
    got = TM.build_chunked_prepared(hand, max_chunk_symbols=600, seg=64,
                                    mark_period=8, device="cpu")
    want = JM.build_chunked_prepared(jhand, max_chunk_symbols=600, seg=64,
                                     mark_period=8)
    for g, w in zip(got.indexes, want.indexes):
        _assert_same_index(g, w)


@pytest.mark.parametrize("direction", ["femto_tpu->port", "port->femto_tpu"])
def test_multi_index_directories_are_shared(chunked, tmp_path, direction):
    docs, jp, tp, jmis = chunked
    want = jmis[600, True]
    path = str(tmp_path / "multi")
    if direction == "femto_tpu->port":
        want.save(path)
        got = TM.MultiIndex.load(path, device="cpu")
        for g, w in zip(got.indexes, want.indexes):
            _assert_same_index(g, w)
    else:
        port = TM.build_chunked_prepared(tp, max_chunk_symbols=600, seg=64,
                                         mark_period=8, device="cpu")
        port.save(path)
        back = JM.MultiIndex.load(path)
        for g, w in zip(port.indexes, back.indexes):
            _assert_same_index(g, w)
        got = port
    assert got.locate(NEEDLE) == want.locate(NEEDLE)


def test_extract_prepared_and_merge_match_jax(chunked):
    """extract_prepared of every chunk (the padded one too), merge_indexes
    and merge_prepared against femto_tpu's."""
    docs, jp, tp, jmis = chunked
    want = jmis[600, True]
    port = TM.build_chunked_prepared(tp, max_chunk_symbols=600, seg=64,
                                     mark_period=8, device="cpu")
    for g, w in zip(port.indexes, want.indexes):
        pg, pw = TM.extract_prepared(g), JM.extract_prepared(w)
        assert_same_bits("text", pg.text, pw.text)
        assert_same_bits("doc_starts", pg.doc_starts, pw.doc_starts)
        assert pg.infos == pw.infos
        assert np.array_equal(pg.header_lens, pw.header_lens)
    merged = TM.merge_prepared(port.indexes)
    assert np.array_equal(merged.text, tp.text)
    assert np.array_equal(merged.doc_starts, tp.doc_starts)
    got = TM.merge_indexes(port.indexes, seg=64, mark_period=8,
                           doc_chunks=True, device="cpu")
    _assert_same_index(got, JM.merge_indexes(want.indexes, seg=64,
                                             mark_period=8, doc_chunks=True))


def test_incremental_index_matches_jax(chunked):
    """Two additions past max_shards=1: the second merges both shards
    into one rebuilt index (the chunks of test_build_chunked_matches_jax,
    so femto_tpu compiles no new shape for them)."""
    docs, jp, tp, jmis = chunked
    kw = dict(seg=64, mark_period=8)
    got = TM.IncrementalIndex(max_shards=1, device="cpu", **kw)
    want = JM.IncrementalIndex(max_shards=1, **kw)
    for part in (docs[:7], docs[7:]):
        got.add_documents(part)
        want.add_documents(part)
        assert len(got.multi.indexes) == len(want.multi.indexes) == 1
        _assert_same_index(got.multi.indexes[0], want.multi.indexes[0],
                           with_lists=False)
    assert got.num_docs == want.num_docs == len(docs)
    assert np.array_equal(got.count([b"ab", NEEDLE]),
                          want.count([b"ab", NEEDLE]))
    # the merge orders shards by size, so doc ids follow that order
    assert got.locate(NEEDLE) == want.locate(NEEDLE)
    assert got.docs_query("NEEDLE AND ab") == want.docs_query("NEEDLE AND ab")
    assert got.count_query("ab") == want.count_query("ab")


def test_build_chunked_matches_jax(chunked):
    docs, jp, tp, jmis = chunked
    got = TM.build_chunked(docs, 7, seg=64, mark_period=8, device="cpu")
    want = JM.build_chunked(docs, 7, seg=64, mark_period=8)
    assert len(got.indexes) == len(want.indexes) == 2
    for g, w in zip(got.indexes, want.indexes):
        _assert_same_index(g, w)


# ---------------------------------------------------------------------------
# extract_context_batch over the rows of a padded index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["full", "packed", "vrle"])
def test_context_over_all_real_rows_of_a_padded_index(tier):
    """Rows [row0, n_rows) of a pad_shape index, the top ones [n, n_rows)
    included, give femto_tpu's contexts: on the port's own padded build
    and on femto_tpu's carried across."""
    docs = _q_docs()
    jp = ft.prepare_documents(docs)
    kw = dict(seg=64, mark_period=8, tier=tier,
              pad_shape=(jp.n + 100, jp.num_docs + 2))
    jix = ft.build_index(jp, **kw)
    own = tt.build_index(tt.prepare_documents(docs), device="cpu", **kw)
    _assert_same_index(own, jix, with_lists=False)
    assert jix.meta.row0 == 100 and jix.meta.n_rows == jp.n + 100
    rows = np.arange(jix.meta.row0, jix.meta.n_rows)
    want = ft.search.extract_context_batch(jix, rows, 5, 3, 5)
    assert len(want) == jp.n and want[jp.n - 100] == b"fdfddfdecefad"
    for port in (own, _carry(jix)):
        assert tt.extract_context_batch(port, rows, 5, 3, 5) == want
        with pytest.raises(ValueError, match="rows"):
            tt.extract_context_batch(port, [jix.meta.n_rows], 5, 3, 5)
