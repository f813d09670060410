"""Parity of femto_tpu_torch's count / locate / extract with femto_tpu's.

On the CPU the port's wrappers run the plain PyTorch versions of kernels C
and D.  Every output is integers or bytes, so the tolerance is exact.  The
port serves three kinds of index here: its own build, a femto_tpu index
carried across with arrays_from_numpy, and a femto_tpu index saved as .npz
and loaded by the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.ops import rank as JR
from femto_tpu.ops import search_ops as JS
from femto_tpu.search import extract_all_documents as jax_extract_all
from femto_tpu.search import locate_rows_array as jax_locate_rows_array
from femto_tpu.search import pack_patterns as jax_pack_patterns
from femto_tpu_torch.ops import rank as TR
from femto_tpu_torch.ops import search_ops as TS
from tests.oracle import naive_count, naive_locate
from tests.test_conformance import build_corpus
from tests.test_torch_build import _graft_docs
from tests.torch_threads import one_torch_thread  # noqa: F401


def _carry(jax_index, **extra):
    """The port's index from a femto_tpu index's arrays and meta."""
    arrays = {k: np.asarray(v) for k, v in jax_index.arrays._asdict().items()
              if v is not None}
    return tt.arrays_from_numpy({**arrays, **extra}, jax_index.meta,
                                device="cpu", infos=jax_index.infos)


CASES = {
    "graft": (_graft_docs, 64, 8),
    "conformance": (lambda: build_corpus(np.random.default_rng(0xC0FFEE)),
                    64, 20),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request, tmp_path_factory):
    """(docs, femto_tpu index, {source: port index})."""
    make, seg, mp = CASES[request.param]
    docs = make()
    jix = ft.build_index(ft.prepare_documents(docs), seg=seg, mark_period=mp)
    path = str(tmp_path_factory.mktemp(request.param) / "jax_index")
    jix.save(path)
    ports = {
        "own": tt.build_index(tt.prepare_documents(docs), seg=seg,
                              mark_period=mp, device="cpu"),
        "carried": _carry(jix),
        "npz": tt.FMIndex.load(path, device="cpu"),
    }
    return docs, jix, ports


def _patterns(docs):
    pats = [b"", b"a", b"an", b"banana", b"zzzq", b"\x00",
            b"\xff\x00", b"\x00\x01\x00", b"abra", b"the lazy"]
    for d in docs:
        if len(d) >= 3:
            pats += [d[:3], d[len(d) // 2: len(d) // 2 + 5], d[-4:]]
    return pats


SOURCES = ["own", "carried", "npz"]


@pytest.mark.parametrize("source", SOURCES)
def test_count_parity(case, source):
    docs, jix, ports = case
    pats = _patterns(docs)
    got = tt.count(ports[source], pats)
    assert np.array_equal(got, ft.count(jix, pats))
    assert [naive_count(docs, p) for p in pats] == got.tolist()
    gf, gl = tt.count_ranges(ports[source], pats)
    wf, wl = ft.count_ranges(jix, pats)
    assert np.array_equal(gf, wf) and np.array_equal(gl, wl)


@pytest.mark.parametrize("source", SOURCES)
def test_locate_parity(case, source):
    docs, jix, ports = case
    for p in _patterns(docs)[1:12]:
        got = tt.locate(ports[source], p)
        assert got == ft.locate(jix, p), p
        assert got == naive_locate(docs, p), p
    assert tt.locate(ports[source], b"a", max_matches=3) == \
        ft.locate(jix, b"a", max_matches=3)


@pytest.mark.parametrize("source", SOURCES)
def test_extract_parity(case, source):
    docs, jix, ports = case
    for d in range(len(docs)):
        assert tt.extract_document(ports[source], d) == docs[d], d
    for d in (0, 2, len(docs) - 1):
        assert ft.extract_document(jix, d) == docs[d], d
    assert tt.extract_all_documents(ports[source]) == \
        jax_extract_all(jix) == docs


def test_pattern_longer_than_any_doc(case):
    docs, jix, ports = case
    pat = b"a" * (max(len(d) for d in docs) + 1)
    assert tt.count(ports["own"], [pat, b"a"]).tolist() == \
        ft.count(jix, [pat, b"a"]).tolist()
    assert tt.locate(ports["own"], pat) == []


@pytest.mark.parametrize("extra", [[], [b""], [b"", b"ab"], [b"x" * 9]])
def test_pack_patterns_matches_jax(case, extra):
    for pats in (_patterns(case[0]) + extra, extra):
        alpha = [tt.alphabet.pattern_to_alpha(p) for p in pats]
        for pad_b in (None, len(pats), len(pats) + 3):
            want = jax_pack_patterns(alpha, pad_b=pad_b)
            got = tt.search.pack_patterns(alpha, pad_b=pad_b)
            assert got[1] == want[1], pats
            assert got[0].dtype == want[0].dtype, pats
            assert np.array_equal(got[0], want[0]), (pats, pad_b)


def test_locate_rows_array_parity(case):
    docs, jix, ports = case
    rows = np.arange(jix.meta.n)
    want = jax_locate_rows_array(jix, rows)
    for source in SOURCES:
        assert np.array_equal(tt.locate_rows_array(ports[source], rows), want)
    with pytest.raises(ValueError):
        tt.locate_rows_array(ports["own"], np.array([jix.meta.n]))


def test_backward_search_plain_matches_jax(case):
    """Kernel C's plain version against femto_tpu's backward_search, on the
    same arrays, including a code outside the alphabet and row0 > 0."""
    docs, jix, ports = case
    port = ports["carried"]
    pats, _ = tt.search.pack_patterns(
        [tt.alphabet.pattern_to_alpha(p) for p in _patterns(docs)])
    pats[0, -1] = 300
    n = jix.meta.n
    for row0 in (0, 3):
        wf, wl = JS.backward_search(jix.arrays, n, jnp.asarray(pats), row0)
        gf, gl = TS.backward_search(port.arrays, n, torch.from_numpy(pats),
                                    row0)
        assert np.array_equal(gf.numpy(), np.asarray(wf)), row0
        assert np.array_equal(gl.numpy(), np.asarray(wl)), row0


def test_locate_rows_plain_matches_jax(case):
    """Kernel D's locate against femto_tpu's locate_rows on every row."""
    docs, jix, ports = case
    rows = np.arange(jix.meta.n, dtype=np.int32)
    mp = jix.meta.mark_period
    want = JS.locate_rows(jix.arrays, mp, jnp.asarray(rows))
    got = TS.locate_rows(ports["carried"].arrays, mp, torch.from_numpy(rows))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_rank_steps_match_jax(case):
    """The plain rank steps the kernels' plain versions are built from,
    against femto_tpu's, on every row."""
    docs, jix, ports = case
    arrays = ports["carried"].arrays
    rows = np.arange(jix.meta.n, dtype=np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    pairs = [
        (JR.bwt_code_at(jix.arrays, r_j), TR.bwt_code_at(arrays, r_t)),
        (JR.lf_step(jix.arrays, r_j), TR.lf_step(arrays, r_t)),
        (JR.mark_rank(jix.arrays, r_j), TR.mark_rank(arrays, r_t)),
    ]
    lf, bit, grank = JR.lf_grank_step(jix.arrays, r_j)
    pairs += zip((lf, bit, grank), TR.lf_grank_step(arrays, r_t))
    g = np.asarray(grank)[np.asarray(bit)]
    pairs.append((JR.mark_offset(jix.arrays, jnp.asarray(g)),
                  TR.mark_offset(arrays, torch.from_numpy(g))))
    for want, got in pairs:
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_extract_backward_plain_matches_jax(case):
    """Kernel D's extract against femto_tpu's extract_backward."""
    docs, jix, ports = case
    rng = np.random.default_rng(3)
    rows = rng.integers(0, jix.meta.n, size=64).astype(np.int32)
    wc, wr = JS.extract_backward(jix.arrays, jnp.asarray(rows), 40)
    gc, gr = TS.extract_backward(ports["carried"].arrays,
                                 torch.from_numpy(rows), 40)
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gr.numpy(), np.asarray(wr))


def test_extract_backward_plain_pad_rows_stay(case):
    """The port's contract for rows outside the text (negative, or past
    n in the last segment, whose code is the pad code), where it departs
    from femto_tpu (which reads them through clamped indices and walks
    on to rows that mean nothing): they stay put and emit their pad code,
    as kernel D has always done; the other lanes of the batch walk as
    femto_tpu's."""
    docs, jix, ports = case
    arrays = ports["carried"].arrays
    n = jix.meta.n
    rows = np.array([n - 1, -1, 5], np.int32)
    pad = n if n % jix.meta.seg else None
    if pad is not None:
        rows = np.append(rows, np.int32(pad))
    gc, gr = TS.extract_backward(arrays, torch.from_numpy(rows), 12)
    assert (gc[1] == 511).all() and int(gr[1]) == -1
    if pad is not None:
        assert (gc[3] == 511).all() and int(gr[3]) == pad
    ok = np.array([0, 2])
    wc, wr = JS.extract_backward(jix.arrays, jnp.asarray(rows[ok]), 12)
    np.testing.assert_array_equal(gc[ok].numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gr[ok].numpy(), np.asarray(wr))


def test_direct_tier_parity(tmp_path):
    docs = _graft_docs()
    jix = ft.build_index(ft.prepare_documents(docs), seg=64, mark_period=8,
                         locate="direct")
    own = tt.build_index(tt.prepare_documents(docs), seg=64, mark_period=8,
                         locate="direct", device="cpu")
    jix.save(str(tmp_path / "d"))
    loaded = tt.FMIndex.load(str(tmp_path / "d"), device="cpu")
    carried = _carry(jix, sa_direct=np.asarray(jix.sa_direct))
    for port in (own, loaded, carried):
        assert port.sa_direct is not None
        for p in [b"banana", b"an", b"a", b"\x00", b"zzzq"]:
            assert tt.locate(port, p) == ft.locate(jix, p), p
        rows = np.arange(jix.meta.n)
        assert np.array_equal(tt.locate_rows_array(port, rows),
                              jax_locate_rows_array(jix, rows))


def test_port_save_loads_in_both(tmp_path):
    docs = _graft_docs()
    port = tt.build_index(tt.prepare_documents(docs), seg=64, mark_period=8,
                          device="cpu")
    port.save(str(tmp_path / "p"))
    jix = ft.FMIndex.load(str(tmp_path / "p"))
    back = tt.FMIndex.load(str(tmp_path / "p"), device="cpu")
    pats = _patterns(docs)
    assert np.array_equal(ft.count(jix, pats), tt.count(port, pats))
    assert np.array_equal(tt.count(back, pats), tt.count(port, pats))
    assert ft.locate(jix, b"an") == tt.locate(back, b"an")
    assert back.infos == port.infos == jix.infos


def test_headers_and_mark_period_zero():
    docs = [b"hello world", b"", b"say hello", b"\x00hello\xff"]
    headers = [b"h1", b"", b"hello head", b"x"]
    jix = ft.build_index(ft.prepare_documents(docs, headers=headers),
                         seg=64, mark_period=0)
    port = tt.build_index(tt.prepare_documents(docs, headers=headers),
                          seg=64, mark_period=0, device="cpu")
    pats = [b"hello", b"head", b"o", b""]
    assert np.array_equal(tt.count(port, pats), ft.count(jix, pats))
    f, l = tt.count_ranges(port, [b"hello"])
    offs = tt.locate_range(port, int(f[0]), int(l[0]))
    assert (offs == -1).all() and len(offs) == 4
    assert np.array_equal(offs, ft.locate_range(jix, int(f[0]), int(l[0])))
    for d in range(len(docs)):
        assert tt.extract_document(port, d) == \
            ft.extract_document(jix, d) == docs[d]
    # with sampling on, header matches come back at negative offsets
    jix8 = ft.build_index(ft.prepare_documents(docs, headers=headers),
                          seg=64, mark_period=8)
    port8 = tt.build_index(tt.prepare_documents(docs, headers=headers),
                           seg=64, mark_period=8, device="cpu")
    for p in pats[:3]:
        assert tt.locate(port8, p) == ft.locate(jix8, p), p


def test_flat_files_are_not_ported_yet(tmp_path):
    """.ftpu files (ported since) written by femto_tpu, plain and zlib,
    load in the port and answer as femto_tpu does."""
    docs = _graft_docs()
    jix = ft.build_index(ft.prepare_documents(docs), seg=64, mark_period=8)
    pats = _patterns(docs)
    for compress in (False, True):
        path = str(tmp_path / f"ix{compress}.ftpu")
        jix.save_flat(path, compress=compress)
        port = tt.FMIndex.load(path, device="cpu")
        assert np.array_equal(tt.count(port, pats), ft.count(jix, pats))
        assert tt.locate(port, b"an") == ft.locate(jix, b"an")
        assert tt.extract_all_documents(port) == docs
        assert port.infos == jix.infos


def test_other_tiers_are_refused():
    """A seg_slot row-cache map belongs to paged.PagedIndex alone: an
    index carried across with one is refused."""
    jix = ft.build_index(ft.prepare_documents(_graft_docs()), seg=64,
                         mark_period=8, tier="vseg")
    with pytest.raises(NotImplementedError, match="PagedIndex"):
        _carry(jix, seg_slot=np.zeros(jix.meta.n_seg, np.int32))
