"""Parity of femto_tpu_torch's compact and packed tiers, .ftpu files and
extract_context / range_docs with femto_tpu's, on the CPU.

Every output is integers or bytes, so the tolerance is exact: the port's
compact and packed FMArrays and FMMeta must be bit-identical to femto_tpu's
for the same corpus, seg and mark_period; the plain versions of kernels
A', E and F must equal the JAX stages they replace on the same inputs; the
port's .ftpu files must be byte-identical to femto_tpu's; and every query
must give femto_tpu's answer on indexes from five sources: the port's own
build, arrays carried across, a femto_tpu .npz directory, and a femto_tpu
.ftpu file, plain and zlib-compressed.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import search as JSearch
from femto_tpu.fmindex import l1_group_for as jax_l1_group_for
from femto_tpu.ops import build_ops as JB
from femto_tpu.ops import rank as JR
from femto_tpu.ops import search_ops as JS
from femto_tpu_torch.ops import build_ops as TB
from femto_tpu_torch.ops import rank as TR
from femto_tpu_torch.ops import search_ops as TS
from tests.oracle import naive_count, naive_locate
from tests.test_torch_build import CORPORA, _stage_inputs, as_numpy, \
    assert_same_bits
from tests.test_torch_search import _carry, _patterns
from tests.torch_threads import one_torch_thread  # noqa: F401


def _assert_same_index(got, want):
    for field in ft.FMArrays._fields:
        w = getattr(want.arrays, field)
        g = getattr(got.arrays, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert_same_bits(field, as_numpy(g), np.asarray(w))
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    assert np.array_equal(got.doc_starts_np, want.doc_starts_np)
    assert got.infos == want.infos


@pytest.mark.parametrize("corpus,tier,seg,mark_period", [
    ("graft", "compact", 64, 8),
    ("conformance", "compact", 256, 20),
    ("repeats", "compact", 64, 0),
    ("graft", "packed", 256, 0),
    ("conformance", "packed", 64, 8),
    ("repeats", "packed", 256, 20),
    ("repeats", "packed", 64, 8),
    ("graft", "packed", 4096, 20),  # the L1 group halves to 8
])
def test_tier_build_parity(corpus, tier, seg, mark_period):
    docs = CORPORA[corpus]()
    want = ft.build_index(ft.prepare_documents(docs), seg=seg,
                          mark_period=mark_period, tier=tier)
    got = tt.build_index(tt.prepare_documents(docs), seg=seg,
                         mark_period=mark_period, tier=tier, device="cpu")
    _assert_same_index(got, want)
    assert got.meta.n_seg % tt.l1_group_for(seg) == 0
    assert tt.l1_group_for(seg) == jax_l1_group_for(seg)


def test_positional_build_index_matches_reference():
    """build_index takes the reference's positional order, device_build
    fifth: (prepared, seg, mark_period, sa, device_build, checkpoint_dir,
    compact, ...)."""
    docs = CORPORA["graft"]()
    want = ft.build_index(ft.prepare_documents(docs), 64, 8, None, True,
                          None, True)
    got = tt.build_index(tt.prepare_documents(docs), 64, 8, None, True,
                         None, True, device="cpu")
    assert got.arrays.occ_ckpt.dtype == torch.uint16  # compact=True
    _assert_same_index(got, want)


@pytest.mark.parametrize("corpus,seg", [("graft", 64), ("repeats", 256),
                                        ("conformance", 4096)])
def test_compact_and_pack_plain_match_jax(corpus, seg):
    """Kernel A' against _split_pull + _occ_stage(compact=True) (identity
    columns) and _hist_stage + _ckpt_stage(compact=True) over the used
    columns; kernel F against _pack_stage."""
    text, ds, sa, n, ndocs = _stage_inputs(CORPORA[corpus]())
    payload = JB.build_sa_payload(jnp.asarray(text), jnp.asarray(ds), n=n,
                                  mark_period=20, ndocs=ndocs)
    pull = np.asarray(payload)[sa]
    grp = jax_l1_group_for(seg)
    n_seg = -(-(n // seg + 1) // grp) * grp
    bwt, chars, a_row = JB._split_pull(jnp.asarray(pull), n=n,
                                       n_pad=n_seg * seg)
    pull_t = torch.from_numpy(pull.astype(np.int64))
    ident = torch.arange(261, dtype=torch.int32)
    got = TB.occ_build_compact(pull_t, ident, ident, n_seg=n_seg, seg=seg)
    C, occ, l1 = JB._occ_stage(chars, n=n, n_seg=n_seg, seg=seg, compact=True)
    for name, g, w in zip(("bwt", "a_row", "occ_ckpt", "occ_l1", "C"), got,
                          (np.asarray(bwt).reshape(n_seg, seg), a_row, occ,
                           l1, C)):
        assert_same_bits(name, as_numpy(g), np.asarray(w))

    used = np.unique(text).astype(np.int32)
    K = len(used)
    amap = np.full(261, -1, np.int32)
    amap[used] = np.arange(K, dtype=np.int32)
    amap_t = torch.from_numpy(amap)
    got = TB.occ_build_compact(pull_t, amap_t, torch.from_numpy(used),
                               n_seg=n_seg, seg=seg)
    per_seg = JB._hist_stage(chars, n_seg=n_seg, seg=seg, alpha=261)
    C, occ, l1 = JB._ckpt_stage(per_seg[:, jnp.asarray(used)], compact=True,
                                group=grp)
    for name, g, w in zip(("occ_ckpt", "occ_l1", "C"), got[2:], (occ, l1, C)):
        assert_same_bits(name, as_numpy(g), np.asarray(w))
    per_word, bits = TB.pack_widths(K)
    assert (per_word, bits) == JB._pack_widths(K)
    words = JB._pack_stage(chars, jnp.asarray(used), n=n, n_seg=n_seg,
                           seg=seg, per_word=per_word, bits=bits)
    assert_same_bits("words", as_numpy(TB.pack_build(
        got[0], amap_t, per_word=per_word, bits=bits)), np.asarray(words))


@pytest.mark.parametrize("K", [1, 2, 3, 31, 32, 255, 257, 261])
def test_pack_widths_match_jax(K):
    assert TB.pack_widths(K) == JB._pack_widths(K)


# ---------------------------------------------------------------------------
# queries on five index sources
# ---------------------------------------------------------------------------

SOURCES = ["own", "carried", "npz", "ftpu", "ftpu_zlib"]
QUERY_CASES = {
    "compact-conformance": ("conformance", "compact", 64, 20),
    "packed-graft": ("graft", "packed", 64, 8),
    "packed-repeats": ("repeats", "packed", 256, 8),
}


@pytest.fixture(scope="module", params=sorted(QUERY_CASES))
def tier_case(request, tmp_path_factory):
    """(docs, femto_tpu index, {source: port index})."""
    corpus, tier, seg, mp = QUERY_CASES[request.param]
    docs = CORPORA[corpus]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=seg, mark_period=mp,
                         tier=tier)
    tmp = tmp_path_factory.mktemp(request.param)
    jix.save(str(tmp / "npz"))
    jix.save_flat(str(tmp / "ix.ftpu"))
    jix.save_flat(str(tmp / "ixz.ftpu"), compress=True)
    ports = {
        "own": tt.build_index(tt.prepare_documents(docs), seg=seg,
                              mark_period=mp, tier=tier, device="cpu"),
        "carried": _carry(jix),
        "npz": tt.FMIndex.load(str(tmp / "npz"), device="cpu"),
        "ftpu": tt.FMIndex.load(str(tmp / "ix.ftpu"), device="cpu"),
        "ftpu_zlib": tt.FMIndex.load(str(tmp / "ixz.ftpu"), device="cpu"),
    }
    for port in ports.values():
        _assert_same_index(port, jix)
    return docs, jix, ports


def _context_rows(jix, docs):
    """Match rows of a few patterns, plus the first and last rows."""
    rows = [0, jix.meta.n - 1]
    for p in _patterns(docs)[1:8]:
        f, l = ft.count_ranges(jix, [p])
        rows += list(range(int(f[0]), min(int(l[0]), int(f[0]) + 6)))
    return np.asarray(rows, np.int64)


@pytest.mark.parametrize("source", SOURCES)
def test_tier_queries_parity(tier_case, source):
    docs, jix, ports = tier_case
    port = ports[source]
    pats = _patterns(docs)
    got = tt.count(port, pats)
    assert np.array_equal(got, ft.count(jix, pats))
    assert got.tolist() == [naive_count(docs, p) for p in pats]
    for g, w in zip(tt.count_ranges(port, pats), ft.count_ranges(jix, pats)):
        assert np.array_equal(g, w)
    for p in pats[1:10]:
        assert tt.locate(port, p) == ft.locate(jix, p) == \
            naive_locate(docs, p), p
    assert tt.extract_all_documents(port) == docs
    rows = _context_rows(jix, docs)
    for before, plen, after in ((5, 2, 7), (0, 3, 0), (9, 0, 0)):
        assert tt.extract_context_batch(port, rows, before, plen, after) == \
            JSearch.extract_context_batch(jix, rows, before, plen, after)
    assert tt.extract_context(port, int(rows[2]), 4, 1, 4) == \
        ft.extract_context(jix, int(rows[2]), 4, 1, 4)
    assert tt.extract_context_batch(port, [], 3, 1, 3) == []
    with pytest.raises(ValueError, match="rows"):
        tt.extract_context_batch(port, [jix.meta.n], 3, 1, 3)
    for p in pats[:10]:
        f, l = ft.count_ranges(jix, [p])
        assert np.array_equal(tt.range_docs(port, int(f[0]), int(l[0])),
                              JSearch.range_docs(jix, int(f[0]), int(l[0])))


def test_tier_kernel_plain_versions_match_jax(tier_case):
    """Kernels C, D and E's plain versions on the compact and packed
    layouts against femto_tpu's backward_search, locate_rows,
    extract_backward and psi_step, on every row."""
    docs, jix, ports = tier_case
    arrays = ports["carried"].arrays
    n, mp = jix.meta.n, jix.meta.mark_period
    pats, _ = tt.search.pack_patterns(
        [tt.alphabet.pattern_to_alpha(p) for p in _patterns(docs)])
    pats[0, -1] = 300
    pats[1, -1] = 260  # in the alphabet, absent from every test corpus
    wf, wl = JS.backward_search(jix.arrays, n, jnp.asarray(pats))
    gf, gl = TS.backward_search(arrays, n, torch.from_numpy(pats))
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert np.array_equal(gl.numpy(), np.asarray(wl))
    rows = np.arange(n, dtype=np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    assert np.array_equal(TS.locate_rows(arrays, mp, r_t).numpy(),
                          np.asarray(JS.locate_rows(jix.arrays, mp, r_j)))
    wc, wr = JS.extract_backward(jix.arrays, r_j[:64], 30)
    gc, gr = TS.extract_backward(arrays, r_t[:64], 30)
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gr.numpy(), np.asarray(wr))
    want = JSearch._psi_scan_jit(jix.arrays, n, r_j[::7], 12)
    assert np.array_equal(TS.psi_walk(arrays, r_t[::7].contiguous(),
                                      12).numpy(),
                          np.asarray(want))


@pytest.mark.parametrize("tier", ["full", "compact", "packed"])
def test_rank_and_psi_steps_match_jax(tier):
    """The plain steps kernels C, D and E are built from, against
    femto_tpu's, on every row of each layout: codes, segment rows,
    checkpoints, LF, the fused locate step, psi and select."""
    docs = CORPORA["repeats"]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=64, mark_period=8,
                         tier=tier)
    arrays = _carry(jix).arrays
    assert TR.layout(arrays) == tier
    n = jix.meta.n
    rows = np.arange(n, dtype=np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    s = rows // 64
    codes = np.array(JR.bwt_code_at(jix.arrays, r_j))
    pairs = [
        (codes, TR.bwt_code_at(arrays, r_t)),
        (JR.gather_segments(jix.arrays, jnp.asarray(s)),
         TR.gather_segments(arrays, torch.from_numpy(s))),
        (JR.ckpt_base(jix.arrays, jnp.asarray(s), jnp.asarray(codes)),
         TR.ckpt_base(arrays, torch.from_numpy(s), torch.from_numpy(codes))),
        (JR.lf_step(jix.arrays, r_j), TR.lf_step(arrays, r_t)),
        (JR.map_char(jix.arrays, jnp.arange(-2, 300)),
         TR.map_char(arrays, torch.arange(-2, 300))),
    ]
    pairs += zip(JR.lf_grank_step(jix.arrays, r_j),
                 TR.lf_grank_step(arrays, r_t))
    pairs += zip(JS.psi_step(jix.arrays, n, r_j), TR.psi_step(arrays, r_t))
    rng = np.random.default_rng(9)
    c = rng.integers(0, TR.alpha_count(arrays), size=200).astype(np.int32)
    C = np.asarray(jix.arrays.C)
    occ = C[c + 1] - C[c]
    c, occ = c[occ > 0], occ[occ > 0]
    k = (rng.random(len(c)) * occ).astype(np.int32)
    pairs.append((JS._select_char(jix.arrays, n, jnp.asarray(c),
                                  jnp.asarray(k)),
                  TR.select_char(arrays, torch.from_numpy(c),
                                 torch.from_numpy(k))))
    for i, (want, got) in enumerate(pairs):
        assert np.array_equal(got.numpy(), np.asarray(want)), i


# ---------------------------------------------------------------------------
# .ftpu files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier,locate,headers", [
    ("full", "direct", False), ("compact", "walk", True),
    ("packed", "walk", False),
])
def test_save_flat_byte_identical(tmp_path, tier, locate, headers):
    """The port's .ftpu equals femto_tpu's byte for byte (plain and zlib)
    and loads in both packages."""
    docs = CORPORA["graft"]()
    hdr = [b"h%d" % i for i in range(len(docs))] if headers else None
    jix = ft.build_index(ft.prepare_documents(docs, headers=hdr), seg=64,
                         mark_period=8, tier=tier, locate=locate)
    port = tt.build_index(tt.prepare_documents(docs, headers=hdr), seg=64,
                          mark_period=8, tier=tier, locate=locate,
                          device="cpu")
    for compress in (False, True):
        jp, tp = tmp_path / f"j{compress}.ftpu", tmp_path / f"t{compress}.ftpu"
        jix.save_flat(str(jp), compress=compress)
        port.save_flat(str(tp), compress=compress)
        assert tp.read_bytes() == jp.read_bytes(), compress
        back_j = ft.FMIndex.load(str(tp))
        back_t = tt.FMIndex.load(str(tp), device="cpu")
        _assert_same_index(back_t, back_j)
        assert (back_t.sa_direct is None) == (locate == "walk")
        pats = _patterns(docs)
        assert np.array_equal(ft.count(back_j, pats), tt.count(back_t, pats))
        assert ft.locate(back_j, b"an") == tt.locate(back_t, b"an")
    meta, infos, arrs = tt.FMIndex.parse_flat(str(tmp_path / "tFalse.ftpu"))
    assert isinstance(arrs["bwt"], np.memmap) and infos == port.infos
    assert meta == port.meta
    with open(tmp_path / "bad.ftpu", "wb") as f:
        f.write(b"NOTFTPU!" + bytes(64))
    with pytest.raises(ValueError, match="FTPU"):
        tt.FMIndex.load(str(tmp_path / "bad.ftpu"), device="cpu")


@pytest.mark.parametrize("tier", ["full", "packed"])
def test_range_docs_with_chunk_doc_lists(tmp_path, tier):
    """range_docs' chunk doc-list branch on a femto_tpu doc_chunks=True
    index carried across in a .ftpu file."""
    docs = CORPORA["conformance"]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=64, mark_period=8,
                         tier=tier, doc_chunks=True)
    jix.save_flat(str(tmp_path / "dc.ftpu"))
    port = tt.FMIndex.load(str(tmp_path / "dc.ftpu"), device="cpu")
    assert port.chunk_docs_np is not None
    ranges = [(0, jix.meta.n), (3, 200), (64, 128), (70, 75), (0, 0)]
    for p in (b"a", b"e", b"th"):
        f, l = ft.count_ranges(jix, [p])
        ranges.append((int(f[0]), int(l[0])))
    for f, l in ranges:
        got = tt.range_docs(port, f, l)
        assert np.array_equal(got, JSearch.range_docs(jix, f, l)), (f, l)
        offs = tt.locate_range(port, f, l)
        assert np.array_equal(got, np.unique(tt.offsets_to_docs(port,
                                                                offs)[0]))
