"""Parity of femto_tpu_torch's vseg and vrle tiers with femto_tpu's, on the
CPU.

Every output is integers or bytes, so the tolerance is exact: the port's
vseg and vrle FMArrays and FMMeta must be bit-identical to femto_tpu's for
the same corpus, seg and mark_period (side tables and u16 symbol lists of
a byte-complete corpus, run-length rows, continuation rows of real prose,
a DNA-like corpus, long repeats); the plain versions of kernels M and N
must equal the JAX stages they replace on the same inputs; the plain rank,
LF, psi and mark steps must equal femto_tpu's on the row layouts; every
query must give femto_tpu's answer on indexes from five sources (the
port's build, carried arrays, .npz, .ftpu plain and zlib); .ftpu files
must be byte-identical; and the legacy row-tier layouts are refused.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pydoc_data.topics as topics
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import search as JSearch
from femto_tpu.ops import build_ops as JB
from femto_tpu.ops import rank as JR
from femto_tpu.ops import search_ops as JS
from femto_tpu_torch.ops import build_ops as TB
from femto_tpu_torch.ops import rank as TR
from femto_tpu_torch.ops import search_ops as TS
from tests.oracle import naive_count, naive_locate
from tests.test_torch_build import _repeat_docs, as_numpy, assert_same_bits
from tests.test_torch_search import _carry, _patterns
from tests.torch_threads import one_torch_thread  # noqa: F401


def _byte_complete_docs():
    """tests/test_build_ops.py's vseg corpus: every byte value, so K > 256
    (u16 symbol lists) and overflow segments in the side table."""
    rng = np.random.default_rng(0xFE307)
    return [b"banana banana",
            bytes(rng.integers(0, 256, size=9000).astype(np.uint8)),
            b"vseg tier check", bytes(range(256)), b"a" * 500]


def _run_docs():
    """tests/test_build_ops.py's vrle corpus: run-heavy text (RLE rows)
    beside binary bytes and one-run segments."""
    rng = np.random.default_rng(0xFE307)
    return [b"banana banana bananas in pajamas " * 40,
            bytes(rng.integers(0, 256, size=6000).astype(np.uint8)),
            b"vrle tier check", bytes(range(256)), b"a" * 2000]


def _prose_docs():
    """38 KB of the pydoc topics in 2 KB documents and a short last one:
    real English, whose BWT runs make continued RLE rows at seg 256."""
    buf = "\n".join(sorted(topics.topics.values())).encode()[:38300]
    return [buf[i: i + 2000] for i in range(0, len(buf), 2000)]


def _dna_docs():
    rng = np.random.default_rng(5)
    return [bytes(np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, size=n)]) for n in (7000, 3000, 1)]


CORPORA = {"bytes": _byte_complete_docs, "runs": _run_docs,
           "prose": _prose_docs, "dna": _dna_docs, "repeats": _repeat_docs}


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


def _modes(arrays):
    w = as_numpy(arrays.seg_woff)
    return {"rle": int((w == -1).sum()), "cont": int((w < -1).sum()),
            "fixed": int((w == 0).sum()), "side": int((w > 0).sum())}


@pytest.mark.parametrize("corpus,tier,seg,mark_period,want", [
    ("bytes", "vseg", 64, 8, {"side"}),
    ("runs", "vrle", 128, 0, {"rle", "side"}),
    ("prose", "vseg", 256, 20, set()),
    ("dna", "vseg", 64, 0, set()),
    ("dna", "vrle", 512, 20, set()),
    ("repeats", "vrle", 2048, 8, {"rle"}),
])
def test_row_tier_build_parity(corpus, tier, seg, mark_period, want):
    """The port's build equals femto_tpu's field for field; `want` names
    segment modes the corpus must exercise."""
    docs = CORPORA[corpus]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=seg,
                         mark_period=mark_period, tier=tier)
    port = tt.build_index(tt.prepare_documents(docs), seg=seg,
                          mark_period=mark_period, tier=tier, device="cpu")
    _assert_same_index(port, jix)
    assert TR.layout(port.arrays) == tier
    assert port.meta.n_seg == port.arrays.bwt.shape[0]
    modes = _modes(port.arrays)
    assert all(modes[m] > 0 for m in want), modes
    if corpus == "bytes":
        assert port.arrays.seg_syms.dtype == torch.uint16


# ---------------------------------------------------------------------------
# the indexes the query and step tests share
# ---------------------------------------------------------------------------

QUERY_CASES = {
    # continued RLE rows, plain RLE rows and side rows in one index
    "prose-vrle": ("prose", "vrle", 256, 8),
    # side rows, u16 symbol lists (K > 256)
    "bytes-vseg": ("bytes", "vseg", 64, 8),
}


def _context_rows(jix, docs):
    rows = [0, jix.meta.n - 1]
    for p in _patterns(docs)[1:8]:
        f, l = ft.count_ranges(jix, [p])
        rows += list(range(int(f[0]), min(int(l[0]), int(f[0]) + 4)))
    return np.asarray(rows, np.int64)


def _jax_answers(jix, docs):
    """femto_tpu's answers to the query test's questions, asked once.
    Locate and range_docs take the patterns with at most 40 and 200 rows
    (and an absent one, and the first 256 rows), so that the plain LF
    walks stay short on the CPU."""
    pats = _patterns(docs)
    rows = _context_rows(jix, docs)
    ranges = ft.count_ranges(jix, pats)
    count = ft.count(jix, pats)
    loc = [p for p, c in zip(pats, count) if 0 < c <= 40][:5] + [b"zzzq"]
    spans = [(int(f), int(l)) for f, l, c in zip(*ranges, count)
             if 0 < c <= 200][:5] + [(0, min(256, jix.meta.n))]
    want = {
        "pats": pats, "rows": rows, "ranges": ranges, "count": count,
        "loc": loc, "locate": [ft.locate(jix, p) for p in loc],
        "ctx": JSearch.extract_context_batch(jix, rows, 5, 2, 7),
        "spans": spans,
        "rd": [JSearch.range_docs(jix, f, l) for f, l in spans],
    }
    assert count.tolist() == [naive_count(docs, p) for p in pats]
    assert want["locate"] == [naive_locate(docs, p) for p in loc]
    assert len(loc) == 6 and len(spans) == 6
    return want


@pytest.fixture(scope="module")
def row_cases(tmp_path_factory):
    """Builds a QUERY_CASES entry once for the module: (docs, femto_tpu
    index, {source: port index}, femto_tpu's answers)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _row_case(name, tmp_path_factory.mktemp(name))
        return cache[name]
    return get


def _row_case(name, tmp):
    corpus, tier, seg, mp = QUERY_CASES[name]
    docs = CORPORA[corpus]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=seg, mark_period=mp,
                         tier=tier)
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
    modes = _modes(ports["own"].arrays)
    if tier == "vrle":
        assert modes["cont"] and modes["rle"] and modes["side"], modes
        assert ports["own"].arrays.seg_rle.shape[0] > 3  # a flat store
    return docs, jix, ports, _jax_answers(jix, docs)


@pytest.fixture(scope="module", params=sorted(QUERY_CASES))
def row_case(request, row_cases):
    """One row tier's case, as row_cases builds it."""
    return row_cases(request.param)


@pytest.mark.parametrize("source", ["own", "carried", "npz", "ftpu",
                                    "ftpu_zlib"])
def test_row_tier_queries_parity(row_case, source):
    docs, _, ports, want = row_case
    port = ports[source]
    pats = want["pats"]
    assert np.array_equal(tt.count(port, pats), want["count"])
    for g, w in zip(tt.count_ranges(port, pats), want["ranges"]):
        assert np.array_equal(g, w)
    assert [tt.locate(port, p) for p in want["loc"]] == want["locate"]
    # the shortest document: a plain LF walk takes milliseconds a step here
    d = int(np.argmin([len(x) for x in docs]))
    assert tt.extract_document(port, d) == docs[d]
    assert tt.extract_context_batch(port, want["rows"], 5, 2, 7) == \
        want["ctx"]
    for (f, l), rd in zip(want["spans"], want["rd"]):
        assert np.array_equal(tt.range_docs(port, f, l), rd)


def test_row_tier_kernel_plain_versions_match_jax(row_case):
    """Kernels C, D and E's plain versions on the row layouts against
    femto_tpu's backward_search, locate_rows, extract_backward and psi."""
    docs, jix, ports, _ = row_case
    arrays = ports["carried"].arrays
    n, mp = jix.meta.n, jix.meta.mark_period
    pats, _ = tt.search.pack_patterns(
        [tt.alphabet.pattern_to_alpha(p) for p in _patterns(docs)])
    pats[0, -1] = 300
    wf, wl = JS.backward_search(jix.arrays, n, jnp.asarray(pats))
    gf, gl = TS.backward_search(arrays, n, torch.from_numpy(pats))
    assert np.array_equal(gf.numpy(), np.asarray(wf))
    assert np.array_equal(gl.numpy(), np.asarray(wl))
    rows = np.arange(0, n, 11, dtype=np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    assert np.array_equal(TS.locate_rows(arrays, mp, r_t).numpy(),
                          np.asarray(JS.locate_rows(jix.arrays, mp, r_j)))
    wc, wr = JS.extract_backward(jix.arrays, r_j[:48], 40)
    gc, gr = TS.extract_backward(arrays, r_t[:48].contiguous(), 40)
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gr.numpy(), np.asarray(wr))
    want = JSearch._psi_scan_jit(jix.arrays, n, r_j[::11], 10)
    assert np.array_equal(
        TS.psi_walk(arrays, r_t[::11].contiguous(), 10).numpy(),
        np.asarray(want))


EXTRACT_TIERS = ("full", "compact", "packed", "vseg", "vrle")


@pytest.mark.parametrize("B", [1, 5, "last_segment"])
@pytest.mark.parametrize("tier", EXTRACT_TIERS)
def test_extract_backward_every_tier_like_jax(row_cases, tier, B):
    """Kernel D's extract (its plain version on the CPU) on each of the
    five layouts of the prose corpus at seg 256, against femto_tpu's
    extract_backward: walks of 64 steps that cross segments, from rows in
    the last segment (whose positions past n hold the pad code) and from
    the ends of the text, or ("last_segment") from every row of the last
    segment inside the text; vrle is row_cases' prose index (continued
    RLE, plain RLE and side rows)."""
    if tier == "vrle":
        _, jix, ports, _ = row_cases("prose-vrle")
        arrays = ports["carried"].arrays
    else:
        docs = CORPORA["prose"]()
        jix = ft.build_index(ft.prepare_documents(docs), seg=256,
                             mark_period=8, tier=tier)
        arrays = _carry(jix).arrays
    n, seg = jix.meta.n, jix.meta.seg
    last = (n - 1) // seg * seg
    rng = np.random.default_rng(60 + (B if B != "last_segment" else 0))
    rows = np.concatenate([[n - 1, last, 0],
                           rng.integers(0, n, size=8)]).astype(np.int32)
    if B == "last_segment":
        rows = np.arange(last, n, dtype=np.int32)
    else:
        rows = rows[:B] if B == 1 else rows[[0, 1, 2, 5, 9]]
    wc, wr = JS.extract_backward(jix.arrays, jnp.asarray(rows), 64)
    gc, gr = TS.extract_backward(arrays, torch.from_numpy(rows), 64)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gr.numpy(), np.asarray(wr))
    # the walks cross segments and visit the last one
    segs = {int(r) // seg for r in rows}
    r = torch.from_numpy(rows)
    for _ in range(64):
        r = TR.lf_step(arrays, r)
        segs.update((r // seg).tolist())
    assert len(segs) > len(rows) // seg + 1 and last // seg in segs
    assert n % seg != 0          # the last segment holds pad positions


# (tier, case) of test_locate_rows_every_row_tier_like_jax: vseg is the
# bytes corpus (side rows, u16 symbol lists), vrle the prose (continued
# RLE, plain RLE and side rows); vseg has no run-length segments
LOCATE_CASES = [(tier, case) for tier in ("vseg", "vrle")
                for case in ("B1", "B5", "last_segment", "side", "continued",
                             "period1", "period3")
                if (tier, case) != ("vseg", "continued")]


@pytest.mark.parametrize("tier,case", LOCATE_CASES)
def test_locate_rows_every_row_tier_like_jax(row_cases, tier, case):
    """Kernel D's locate (its plain version on the CPU) on the row tiers
    against femto_tpu's locate_rows at the index's mark_period: walks of
    B = 1 and 5, from every in-text row of the last segment, from rows in
    side segments and in continued run-length segments; and at
    mark_period 1 and 3 (below the build's 8), where some walks reach no
    mark and give -1."""
    _, jix, ports, _ = row_cases("prose-vrle" if tier == "vrle"
                                 else "bytes-vseg")
    arrays = ports["carried"].arrays
    n, seg, mp = jix.meta.n, jix.meta.seg, jix.meta.mark_period
    rng = np.random.default_rng(70 + len(case))
    woff = arrays.seg_woff.numpy()
    if case in ("side", "continued"):
        segs = np.nonzero(woff > 0 if case == "side" else woff < -1)[0]
        assert len(segs) > 0
        rows = segs[rng.integers(0, len(segs), 24)] * seg + \
            rng.integers(0, seg, 24)
        rows = rows[rows < n]
    elif case == "last_segment":
        rows = np.arange((n - 1) // seg * seg, n)
    elif case in ("B1", "B5"):
        rows = np.concatenate([[n - 1], rng.integers(0, n, 4)])[
            : int(case[1:])]
    else:
        rows = rng.integers(0, n, 64)
        mp = int(case[-1])
    rows = rows.astype(np.int32)
    want = np.asarray(jax.jit(JS.locate_rows, static_argnums=1)(
        jix.arrays, mp, jnp.asarray(rows)))
    got = TS.locate_rows(arrays, mp, torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(got, want)
    if case.startswith("period"):
        assert (got < 0).any() and (got >= 0).any()
    else:
        assert (got >= 0).all()


def test_row_tier_steps_match_jax(row_case):
    """The plain steps kernels C, D and E are built from, against
    femto_tpu's on the row layouts: codes, decoded segments (K13),
    checkpoints, LF, the fused locate step, mark ranks, psi and select."""
    _, jix, ports, _ = row_case
    arrays = ports["carried"].arrays
    n, seg = jix.meta.n, jix.meta.seg
    rows = np.arange(0, n, 11, dtype=np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    s = np.arange(0, jix.meta.n_seg, 4, dtype=np.int32)
    # one XLA program per JAX step (eager dispatch compiles every op)
    J = {f.__name__: jax.jit(f) for f in (
        JR.bwt_code_at, JR.gather_segments, JR.ckpt_base, JR.lf_step,
        JR.mark_rank, JR.map_char, JR.lf_grank_step)}
    J.update({f.__name__: jax.jit(f, static_argnums=1)
              for f in (JS.psi_step, JS._select_char)})
    codes = np.array(J["bwt_code_at"](jix.arrays, r_j))
    pairs = [
        (codes, TR.bwt_code_at(arrays, r_t)),
        (J["gather_segments"](jix.arrays, jnp.asarray(s)),
         TR.gather_segments(arrays, torch.from_numpy(s))),
        (J["ckpt_base"](jix.arrays, jnp.asarray(rows // seg),
                        jnp.asarray(codes)),
         TR.ckpt_base(arrays, torch.from_numpy(rows // seg),
                      torch.from_numpy(codes))),
        (J["lf_step"](jix.arrays, r_j), TR.lf_step(arrays, r_t)),
        (J["mark_rank"](jix.arrays, r_j), TR.mark_rank(arrays, r_t)),
        (J["map_char"](jix.arrays, jnp.arange(-2, 300)),
         TR.map_char(arrays, torch.arange(-2, 300))),
    ]
    pairs += zip(J["lf_grank_step"](jix.arrays, r_j),
                 TR.lf_grank_step(arrays, r_t))
    pairs += zip(J["psi_step"](jix.arrays, n, r_j[::20]),
                 TR.psi_step(arrays, r_t[::20].contiguous()))
    rng = np.random.default_rng(9)
    C = np.asarray(jix.arrays.C)
    c = rng.integers(0, TR.alpha_count(arrays), size=300).astype(np.int32)
    occ = C[c + 1] - C[c]
    c, occ = c[occ > 0], occ[occ > 0]
    k = (rng.random(len(c)) * occ).astype(np.int32)
    pairs.append((J["_select_char"](jix.arrays, n, jnp.asarray(c),
                                    jnp.asarray(k)),
                  TR.select_char(arrays, torch.from_numpy(c),
                                 torch.from_numpy(k))))
    for i, (want, got) in enumerate(pairs):
        assert np.array_equal(got.numpy(), np.asarray(want)), i


def test_vrle_stream_edges_match_jax(row_cases):
    """The slot walk at its edges on the prose vrle index: a stream that
    ends exactly at the code area's last word, continued streams that end
    exactly at a word boundary, and the continuation stored last in the
    flat store (its window reads the guard granules).  At every offset of
    those segments the codes, the rank of every symbol, LF, select and psi
    equal femto_tpu's."""
    docs, jix, ports, _ = row_cases("prose-vrle")
    arrays = ports["carried"].arrays
    n, seg = jix.meta.n, jix.meta.seg
    bwt, amap, hist, *_ = _row_inputs(docs, seg, TB.VRLE_SMAX)
    plan = TB.row_plan("vrle", bwt, hist, amap)
    woff = plan.seg_woff
    assert np.array_equal(woff, as_numpy(arrays.seg_woff))
    w_slot, _ = TB.vrle_slot_geom_np(as_numpy(plan.nsym).astype(np.int32))
    bits = plan.slots.astype(np.int64) * w_slot
    code_end = np.nonzero((woff == -1) & (bits == 32 * plan.code_words))[0]
    cont_end = np.nonzero((woff < -1) & (bits % 32 == 0))[0]
    last = plan.cont_idx[np.argmax(plan.offs[:-1])]
    assert len(code_end) and len(cont_end)
    assert -woff[last] - 2 == plan.offs[-2]
    assert plan.cont_total == arrays.seg_cont.numel() == \
        plan.offs[-1] + plan.ngr * TB.VRLE_CONT_G
    segs = np.unique(np.concatenate([code_end[:2], cont_end[:2], [last]]))
    rows = (segs[:, None] * seg + np.arange(seg)).ravel()
    rows = rows[rows < n].astype(np.int32)
    r_j, r_t = jnp.asarray(rows), torch.from_numpy(rows)
    J = {f.__name__: jax.jit(f) for f in (
        JR.bwt_code_at, JR.lf_step, JR.backward_step_pair)}
    J.update({f.__name__: jax.jit(f, static_argnums=1)
              for f in (JS.psi_step, JS._select_char)})
    codes = np.array(J["bwt_code_at"](jix.arrays, r_j))
    assert np.array_equal(TR.bwt_code_at(arrays, r_t).numpy(), codes)
    lf = np.array(J["lf_step"](jix.arrays, r_j))
    assert np.array_equal(TR.lf_step(arrays, r_t).numpy(), lf)
    # the rank at every offset of each symbol these segments hold, of one
    # symbol they do not and of one outside the alphabet
    alpha = as_numpy(arrays.alpha_rev)
    held = np.unique(codes)
    chars = np.concatenate([alpha[held], alpha[np.setdiff1d(
        np.arange(len(alpha)), held)][:1], [300]]).astype(np.int32)
    cc = np.repeat(chars, len(rows))
    rr = np.tile(rows, len(chars))
    want = J["backward_step_pair"](jix.arrays, jnp.asarray(cc),
                                   jnp.asarray(rr), jnp.asarray(rr + 1))
    got = TR.backward_step_pair(arrays, torch.from_numpy(cc),
                                torch.from_numpy(rr),
                                torch.from_numpy(rr + 1))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # select of the occurrence at each row gives the row back
    C = np.asarray(jix.arrays.C)
    k = (lf - C[codes]).astype(np.int32)
    want = np.asarray(J["_select_char"](jix.arrays, n, jnp.asarray(codes),
                                        jnp.asarray(k)))
    got = TR.select_char(arrays, torch.from_numpy(codes),
                         torch.from_numpy(k)).numpy()
    assert np.array_equal(got, want) and np.array_equal(got, rows)
    # psi from the rows one text position back lands in these segments
    for g, w in zip(TR.psi_step(arrays, torch.from_numpy(lf)),
                    J["psi_step"](jix.arrays, n, jnp.asarray(lf))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert np.array_equal(TR.psi_step(arrays, torch.from_numpy(lf))[0]
                          .numpy(), rows)


# ---------------------------------------------------------------------------
# kernels M and N: plain versions against the JAX stages
# ---------------------------------------------------------------------------


def _row_inputs(docs, seg, smax):
    """(bwt uint16 tensor, alpha_map tensor, hist tensor, JAX codes2d,
    used, n, n_seg) of a corpus, through the port's plain build stages."""
    prep = tt.prepare_documents(docs)
    n, ndocs = prep.n, prep.num_docs
    text = torch.from_numpy(prep.text.astype(np.int32))
    ds = torch.from_numpy(prep.doc_starts.astype(np.int32))
    sa, pull = tt.suffix_array(
        text, payload=TB.build_sa_payload(text, ds, n=n, mark_period=8,
                                          ndocs=ndocs))
    used = np.unique(prep.text).astype(np.int32)
    amap = np.full(261, -1, np.int32)
    amap[used] = np.arange(len(used), dtype=np.int32)
    grp = tt.l1_group_for(seg)
    n_seg = -(-(n // seg + 1) // grp) * grp
    bwt, _, _, _, _, hist = TB.occ_build_compact(
        pull, torch.from_numpy(amap), torch.from_numpy(used), n_seg=n_seg,
        seg=seg, want_hist=True)
    chars = jnp.asarray((pull & 511).numpy().astype(np.int32))
    codes2d = JB._codes2d_stage(chars, jnp.asarray(used), n=n, n_seg=n_seg,
                                seg=seg)
    return bwt, torch.from_numpy(amap), hist, codes2d, used, n, n_seg


@pytest.mark.parametrize("corpus,seg,smax", [
    ("prose", 256, 64), ("bytes", 64, 32), ("runs", 128, 64),
])
def test_row_kernel_plain_versions_match_jax(corpus, seg, smax):
    """seg_syms == _stats_from_hist; vrle_slot_count == _vrle_slot_stats;
    vrle_pack == _vrle_pack_slots (every segment packed); side_rows ==
    _vseg_pack_uniform(side=True); vseg_rows' code area at w_main ==
    _vseg_pack_uniform(side=False)."""
    bwt, amap, hist, codes2d, used, n, n_seg = _row_inputs(
        CORPORA[corpus](), seg, smax)
    syms, nsym = TB.seg_syms(hist, smax)
    js, jn = JB._stats_from_hist(jnp.asarray(hist.numpy()), SMAX=smax)
    assert_same_bits("syms", as_numpy(syms), np.asarray(js))
    assert_same_bits("nsym", as_numpy(nsym), np.asarray(jn).astype(np.uint8))
    jslots = JB._vrle_slot_stats(codes2d, js, jn, seg=seg, SMAX=smax)
    slots = TB.vrle_slot_count(bwt, amap, syms, nsym)
    assert_same_bits("slots", as_numpy(slots), np.asarray(jslots))
    words = int(np.ceil(np.percentile(
        as_numpy(slots) * TB.vrle_slot_geom_np(as_numpy(nsym))[0], 60) / 32))
    jrle = JB._vrle_pack_slots(codes2d, js, jn, seg=seg, SMAX=smax,
                               A_words=words)
    every = torch.full((n_seg,), -1, dtype=torch.int32)
    assert_same_bits("rle", as_numpy(TB.vrle_pack(
        bwt, amap, syms, nsym, every, words=words)), np.asarray(jrle))
    assert not as_numpy(TB.vrle_pack(bwt, amap, syms, nsym,
                                     torch.zeros_like(every),
                                     words=words)).any()
    ovf = np.arange(0, n_seg, 3).astype(np.int32)
    for w in (8, 9):
        w_side, _ = TB.vseg_width_for(seg, w)
        jside = JB._vseg_pack_uniform(
            jnp.take(codes2d, jnp.asarray(ovf), axis=0),
            jnp.zeros((len(ovf), smax), jnp.int32),
            jnp.zeros((len(ovf),), jnp.int32), seg=seg, w=w_side,
            SMAX=smax, side=True)
        side = TB.side_rows(bwt, amap, torch.from_numpy(ovf), w_side=w_side)
        assert not as_numpy(side[0]).any()
        assert_same_bits("side", as_numpy(side[1:]), np.asarray(jside))
    for w_main in (1, 2, 3, 5):
        jmain = JB._vseg_pack_uniform(codes2d, js, jn, seg=seg, w=w_main,
                                      SMAX=smax, side=False)
        Wm = jmain.shape[1]
        rows = TB.vseg_rows(
            bwt, amap, syms, nsym, torch.zeros(n_seg, dtype=torch.int32),
            torch.zeros((n_seg, seg // 32), dtype=torch.int32).view(
                torch.uint32), torch.zeros(n_seg, dtype=torch.int32),
            TB.i32_to_u16(torch.zeros((n_seg, len(used)),
                                      dtype=torch.int32)),
            w_main=w_main, code_words=Wm, s_store=4, wide=False)
        assert_same_bits("code area", as_numpy(rows[:, :Wm]),
                         np.asarray(jmain))


def test_row_host_helpers_match_jax():
    """vseg_width_for / candidates / sym_store, the slot geometry, and
    vrle_plan over random symbol and slot counts, against femto_tpu."""
    for seg in (32, 64, 96, 128, 256, 512, 2048, 4096):
        for w in range(1, 11):
            assert TB.vseg_width_for(seg, w) == JB._vseg_width_for(seg, w)
        assert TB.vseg_width_candidates(seg) == \
            JB.vseg_width_candidates(seg)
    for w in range(1, 7):
        for wide in (False, True):
            assert TB.vseg_sym_store(w, wide) == JB.vseg_sym_store(w, wide)
    ns = np.arange(0, 256, dtype=np.int32)
    for got, want in zip(TB.vrle_slot_geom_np(ns), JB.vrle_slot_geom_np(ns)):
        assert np.array_equal(got, want)
    for got, want in zip(TR.vrle_slot_geom(torch.from_numpy(ns)),
                         JB.vrle_slot_geom_np(ns)):
        assert np.array_equal(got.numpy(), want)
    rng = np.random.default_rng(3)
    for seg, n_seg, wide in ((256, 300, False), (2048, 40, True),
                             (64, 1000, False)):
        nsym = rng.choice([1, 3, 9, 17, 40, 64, 255], size=n_seg).astype(
            np.int32)
        slots = rng.integers(1, seg // 3, size=n_seg).astype(np.int32)
        kw = dict(seg=seg, n_seg=n_seg, wide=wide,
                  Wside=TB.vseg_width_for(seg, 9 if wide else 8)[1])
        for got, want in zip(TB.vrle_plan(nsym, slots, **kw),
                             JB.vrle_plan(nsym, slots, **kw)):
            assert np.array_equal(got, want)


def test_cont_flatten_matches_jax():
    rng = np.random.default_rng(4)
    rle = rng.integers(0, 2**32, size=(12, 40), dtype=np.uint32)
    idx = np.array([1, 4, 5, 9], np.int32)
    first = 24
    cwords = np.array([3, 16, 1, 9], np.int32)
    offs = np.array([0, 16, 32, 48], np.int32)
    total = 48 + 2 * 16
    want = JB._flatten_ragged(jnp.asarray(rle[idx, first:]),
                              jnp.asarray(cwords), jnp.asarray(offs),
                              total_pad=total, W=40 - first, fill=0)
    got = TB.cont_flatten(torch.from_numpy(rle.view(np.int32)).view(
        torch.uint32), *(torch.from_numpy(a) for a in (idx, cwords, offs)),
        first=first, total=total)
    assert_same_bits("flat", as_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# .ftpu files and layouts refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["vseg", "vrle"])
def test_row_tier_save_flat_byte_identical(tmp_path, tier):
    docs = CORPORA["runs"]()
    jix = ft.build_index(ft.prepare_documents(docs), seg=128, mark_period=8,
                         tier=tier)
    port = tt.build_index(tt.prepare_documents(docs), seg=128,
                          mark_period=8, tier=tier, device="cpu")
    for compress in (False, True):
        jp, tp = tmp_path / f"j{compress}.ftpu", tmp_path / f"t{compress}.ftpu"
        jix.save_flat(str(jp), compress=compress)
        port.save_flat(str(tp), compress=compress)
        assert tp.read_bytes() == jp.read_bytes(), compress
        back = tt.FMIndex.load(str(tp), device="cpu")
        _assert_same_index(back, jix)
        assert tt.locate(back, b"banana") == ft.locate(jix, b"banana")


def test_legacy_row_layouts_are_refused():
    """u8 vrle slots (marker leading dim 2), the per-row continuation
    table (marker dim 3 with a many-row seg_cont), the obsolete vseg
    layout (no side table) and a carried seg_slot (paged.PagedIndex's
    own) are refused."""
    jix = ft.build_index(ft.prepare_documents(CORPORA["runs"]()), seg=128,
                         mark_period=8, tier="vrle")
    w_main = jix.arrays.seg_rle.shape[1]
    cont = np.zeros((3, 8), np.uint32)
    for extra, match in (
            ({"seg_rle": np.zeros((2, w_main), np.int32)}, "u8"),
            ({"seg_rle": np.zeros((3, w_main), np.int32), "seg_cont": cont},
             "continuation"),
            ({"seg_slot": np.zeros(4, np.int32)}, "PagedIndex")):
        exc = NotImplementedError if match == "PagedIndex" else ValueError
        with pytest.raises(exc, match=match):
            _carry(jix, **extra)
    vs = ft.build_index(ft.prepare_documents(CORPORA["runs"]()), seg=128,
                        mark_period=8, tier="vseg")
    arrays = {k: np.asarray(v) for k, v in vs.arrays._asdict().items()
              if v is not None and k != "seg_ovf"}
    with pytest.raises(ValueError, match="obsolete"):
        tt.arrays_from_numpy(arrays, vs.meta, device="cpu")
