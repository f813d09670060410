"""The port's sharded row tiers, doc lists, checkpoint / resume and sharded
query engine (femto_tpu_torch.parallel) against femto_tpu's
(femto_tpu.parallel) on the 8-virtual-device CPU mesh.

The port's LocalMesh(8) on the CPU runs every per-shard step's plain
PyTorch version; femto_tpu runs its shard_map bodies on the conftest's 8
virtual devices.  The same seeded corpora go through both, and every
comparison is exact: the vseg and vrle FMArrays blocks, meta and
LAST_BUILD_STATS; count and locate (routed and psum) and the naive
oracle; the doc lists; regex matches; count and docs query answers.
femto_tpu's sharded indexes are built once per module.  femto_tpu's
sharded ranges of the real rows are the same on every tier (the pad rows
sort first, row0 of them), so its full-tier answers, shifted by the
difference of row0, hold the port's full, packed, vseg and vrle indexes;
femto_tpu compiles its shard_map programs anew on every call, so each
distinct query term is evaluated by femto_tpu once per module (femto_tpu's
answer reused where the term recurs, femto_answers), count and locate
are held to femto_tpu on the five documents and to the text elsewhere,
and the queries past its list are held to the port's own single-device
engine.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.alphabet import ALPHA_SIZE, pattern_to_alpha
from femto_tpu.ops import rank as JR
from femto_tpu.parallel import dist_build as jdb
from femto_tpu.parallel import dist_query as jdq
from femto_tpu.parallel.mesh import make_mesh
from femto_tpu.query.nfa import compile_nfa as j_compile
from femto_tpu.query.parser import parse_query as j_parse
from femto_tpu.query.planning import streamline as j_streamline
from femto_tpu.search import pack_patterns
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.ops import regex_ops as RO
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel import dist_build as tdb
from femto_tpu_torch.parallel import dist_query as tdq
from femto_tpu_torch.parallel.distributed import put_global
from femto_tpu_torch.query import regexp_device as RD
from femto_tpu_torch.query.ast import QTerm
from femto_tpu_torch.query.engine import TruncationWarning, count_query, \
    docs_query
from femto_tpu_torch.query.nfa import compile_nfa as t_compile
from femto_tpu_torch.query.parser import parse_query as t_parse
from femto_tpu_torch.query.planning import streamline as t_streamline
from tests.oracle import naive_count, naive_locate
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 8
SEG = {"five": 32, "overflow": 32, "prose": 64}
ROW_CASES = [("five", "vseg"), ("five", "vrle"), ("overflow", "vseg"),
             ("prose", "vrle")]


def _corpus(name):
    if name == "five":
        # 3934 symbols: the full tier's padding (to 8 x 32) and the other
        # tiers' (to 8 x 32 x 16) are both 4096 rows, so femto_tpu's
        # builds of this corpus share their suffix-sort programs
        rng = np.random.default_rng(11)
        return [b"the quick brown fox jumps over the lazy dog",
                b"quack quick quack, the banana boat " * 2,
                b"",
                b"The QUICK Duck said Quack; pack my box with five dozen "
                b"liquor jugs",
                b"abracadabra" * 10 + bytes(rng.choice(
                    np.frombuffer(b"abcdr", np.uint8), size=3640))]
    if name == "overflow":
        # tests/test_dist.py's vseg overflow corpus: wide-alphabet noise
        # sends segments to the per-shard side tables
        rng = np.random.default_rng(0xFE307)
        return [b"aaaaaaaabbbbbbbb" * 40,
                bytes(rng.integers(1, 250, size=1500).astype(np.uint8)),
                b"abababab" * 30]
    import pydoc_data.topics as topics

    # the first 28,000 bytes (two documents): vrle continues some of their
    # segments (asserted below)
    buf = ("\n".join(sorted(topics.topics.values()))).encode()[:28000]
    return [buf[i:i + 25000] for i in range(0, len(buf), 25000)]


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(D)


@pytest.fixture(scope="module")
def tmesh():
    return LocalMesh(D, device="cpu")


@pytest.fixture(scope="module")
def built(jmesh, tmesh):
    """(docs, femto_tpu's index, the port's index, their LAST_BUILD_STATS)
    per (corpus, tier): the row-tier cases, and the five documents' full
    tier; doc lists on the five documents' full and vrle builds."""
    out = {}
    for corpus, tier in ROW_CASES + [("five", "full")]:
        docs = _corpus(corpus)
        kw = dict(seg=SEG[corpus], mark_period=8, tier=tier,
                  doc_chunks=corpus == "five" and tier != "vseg")
        jix = jdb.build_index_sharded(ft.prepare_documents(docs), jmesh, **kw)
        jstats = dict(jdb.LAST_BUILD_STATS)
        tix = tdb.build_index_sharded(tt.prepare_documents(docs), tmesh, **kw)
        out[corpus, tier] = (docs, jix, tix, jstats,
                             dict(tdb.LAST_BUILD_STATS))
    return out


@pytest.fixture(scope="module")
def port_tiers(built, tmesh):
    """The port's sharded five-document index of every tier."""
    docs = _corpus("five")
    prep = tt.prepare_documents(docs)
    out = {t: built["five", t][2] for t in ("full", "vseg", "vrle")}
    out["packed"] = tdb.build_index_sharded(prep, tmesh, seg=32,
                                            mark_period=8, tier="packed")
    return out


def _same_arrays(tix, jix):
    for name in tt.FMArrays._fields:
        want = getattr(jix.arrays, name)
        got = getattr(tix.arrays, name)
        if want is None:
            assert got is None, name
            continue
        want = np.asarray(want)
        got = got.cpu().numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("corpus,tier", ROW_CASES)
def test_row_tier_blocks(built, corpus, tier):
    """Every FMArrays block of the sharded vseg / vrle build, meta and
    LAST_BUILD_STATS equal femto_tpu's."""
    _, jix, tix, jstats, tstats = built[corpus, tier]
    assert tstats == jstats
    assert dict(tix.meta.__dict__) == {k: getattr(jix.meta, k)
                                       for k in tix.meta.__dict__}
    _same_arrays(tix, jix)
    woff = tix.arrays.seg_woff.numpy()
    if corpus == "overflow":
        assert (woff > 0).any(), "expected side-table segments"
    if corpus == "prose":
        assert (woff < -1).any(), "expected continuation segments"


PATS = {"five": [b"banana", b"the", b"abra", b"zz", b"a", b"quack", b"",
                 b"qu"],
        "overflow": [b"aaaa", b"abab", b"zzzz", b"ab", b"b", b"", b"ba",
                     b"bbbbbbbb"],
        "prose": [b"Python", b"lambda", b"zzqq", b"the", b"e", b"", b"for",
                  b"def"]}


def _packed(pats):
    return pack_patterns([pattern_to_alpha(p) for p in pats])


def _lane_pad(rows):
    return np.concatenate([rows, np.full((-len(rows)) % D, rows[0],
                                         np.int32)])


@pytest.fixture(scope="module")
def femto_five(built, jmesh):
    """femto_tpu's answers on its five-document full index, each computed
    once: the routed ranges of PATS["five"] and the offsets of every row.
    They hold the port's row tiers too: the five documents pad to the same
    4096 rows on every tier, and the pad rows sort first."""
    jix = built["five", "full"][1]
    packed, B = _packed(PATS["five"])
    jf, jl = jdq.sharded_backward_search(jix, jmesh, packed)
    every = np.arange(jix.meta.n_rows, dtype=np.int32)
    offs = np.asarray(jdq.sharded_locate(jix, jmesh, every))
    return jix.meta.row0, np.asarray(jf)[:B], np.asarray(jl)[:B], offs


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("corpus,tier", ROW_CASES)
def test_row_tier_count_locate(built, femto_five, tmesh, corpus, tier,
                               routed):
    """Count and locate over the sharded row tiers equal the text's, and
    on the five documents femto_tpu's (elsewhere psum equals routed); the
    located rows include walks from rows of the last shard."""
    docs, _, tix, _, _ = built[corpus, tier]
    pats = PATS[corpus]
    packed, B = _packed(pats)
    tf, tl = tdq.sharded_backward_search(tix, tmesh, packed, routed=routed)
    femto = corpus == "five"
    if femto:
        row0, jf, jl, joffs = femto_five
        assert tix.meta.row0 == row0
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_array_equal(tl.numpy(), jl)
    elif not routed:
        for got, want in zip((tf, tl), tdq.sharded_backward_search(
                tix, tmesh, packed)):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
    for p, c in zip(pats, (tl - tf).tolist()):
        assert c == (naive_count(docs, p) if p else tix.meta.n), (p, c)
    f, l = int(tf[1]), int(tl[1])
    per_shard = tix.meta.n_rows // D
    rows = _lane_pad(np.concatenate([
        np.arange(f, l, dtype=np.int32),
        np.arange(tix.meta.n_rows - per_shard, tix.meta.n_rows,
                  max(1, per_shard // 48), dtype=np.int32)]))
    got = tdq.sharded_locate(tix, tmesh, rows, routed=routed).numpy()
    if femto:
        np.testing.assert_array_equal(got, joffs[rows])
    elif not routed:
        np.testing.assert_array_equal(
            got, tdq.sharded_locate(tix, tmesh, rows).numpy())
    doc, off = tt.offsets_to_docs(tix, got[: l - f].astype(np.int64))
    assert sorted(zip(doc.tolist(), off.tolist())) == naive_locate(docs,
                                                                   pats[1])


@pytest.mark.parametrize("tier", ["vseg", "vrle"])
def test_owner_lf_view_made_once(built, tmesh, monkeypatch, tier):
    """The routed locate makes K18f owner_lf's view of a sharded index
    once and keeps it on the index with its arrays (on the CPU the view is
    None: the plain version answers); a second locate reuses it with the
    same answers, which equal the psum walk's; a view of other arrays is
    refused."""
    _, _, tix, _, _ = built["five", tier]
    made = []
    orig = DO.owner_lf_view
    monkeypatch.setattr(DO, "owner_lf_view",
                        lambda *a: made.append(a) or orig(*a))
    tix.owner_lf_view = None
    rows = _lane_pad(np.arange(tix.meta.row0, tix.meta.row0 + 100,
                               dtype=np.int32))
    first = tdq.sharded_locate(tix, tmesh, rows).numpy()
    again = tdq.sharded_locate(tix, tmesh, rows).numpy()
    nseg_local = tix.meta.n_seg // D
    assert len(made) == 1 and tix.owner_lf_view[:2] == (tix.arrays,
                                                         nseg_local)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_array_equal(
        tdq.sharded_locate(tix, tmesh, rows, routed=False).numpy(), first)
    other = DO.OwnerLfView(None, tier, D, nseg_local, (), None)
    req = torch.zeros((D, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="view"):
        DO.owner_lf(tix.arrays, req, req.to(torch.uint8),
                    nseg_local=nseg_local, shard0=0, view=other)


@pytest.mark.parametrize("tier", ["vseg", "vrle"])
def test_carried_row_tier_index(built, tmesh, tier):
    """femto_tpu's sharded row-tier index carried across
    (sharded_arrays_from_numpy) answers like the port's own build."""
    _, jix, tix, _, _ = built["five", tier]
    arrays = {k: np.asarray(v) for k, v in jix.arrays._asdict().items()
              if v is not None}
    cix = tdq.sharded_arrays_from_numpy(arrays, jix.meta, tmesh)
    packed, _ = _packed(PATS["five"])
    for got, want in zip(tdq.sharded_backward_search(cix, tmesh, packed),
                         tdq.sharded_backward_search(tix, tmesh, packed)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    rows = _lane_pad(np.arange(tix.meta.row0, tix.meta.n_rows, 5,
                               dtype=np.int32))
    np.testing.assert_array_equal(
        tdq.sharded_locate(cix, tmesh, rows).numpy(),
        tdq.sharded_locate(tix, tmesh, rows, routed=False).numpy())


@pytest.mark.parametrize("tier", ["full", "vrle"])
def test_doc_lists_like_femto_tpu(built, tier):
    _, jix, tix, _, _ = built["five", tier]
    np.testing.assert_array_equal(tix.chunk_doc_offsets_np,
                                  jix.chunk_doc_offsets_np)
    np.testing.assert_array_equal(tix.chunk_docs_np, jix.chunk_docs_np)
    assert tix.chunk_docs_np.dtype == np.asarray(jix.chunk_docs_np).dtype


def _text(docs, mesh):
    prep = tt.prepare_documents(docs)
    text_pad, n_pad = tdb.pad_text_for_mesh(prep.text, D, 32)
    return prep, put_global(text_pad, mesh), n_pad


def test_checkpoint_cleared_after_build(tmesh, tmp_path):
    """A completed checkpointed build leaves no dist_rank* file and counts
    right (femto_tpu's test_dist_build_checkpoint_resume)."""
    rng = np.random.default_rng(5)
    docs = [bytes(rng.integers(97, 101, size=300).astype(np.uint8))
            for _ in range(3)]
    ck = str(tmp_path / "ck")
    ix = tdb.build_index_sharded(tt.prepare_documents(docs), tmesh, seg=32,
                                 mark_period=8, checkpoint_dir=ck)
    assert not any(f.startswith("dist_rank") for f in os.listdir(ck))
    pats = [b"a", docs[0][:3], b"zz"]
    packed, _ = _packed(pats)
    f, l = tdq.sharded_backward_search(ix, tmesh, packed)
    for p, c in zip(pats, (l - f).tolist()):
        assert c == naive_count(docs, p)


@pytest.mark.parametrize("stage", ["seed", "dbl"])
def test_checkpoint_resume(tmesh, tmp_path, monkeypatch, stage):
    """A kept "seed" checkpoint (a low-tie corpus) or "dbl" checkpoint (one
    repeated symbol: the full doubling path) resumes: "resumed" is set and
    the SA, BWT and aux words equal the first build's, which equal the
    checkpoint-free build's."""
    if stage == "seed":
        rng = np.random.default_rng(42)
        docs = [bytes(rng.integers(97, 123, size=500).astype(np.uint8))
                for _ in range(3)]
    else:
        docs = [b"a" * 1200]
    prep, text, n_pad = _text(docs, tmesh)
    kw = dict(n=prep.n, doc_starts=torch.from_numpy(
        prep.doc_starts.astype(np.int32)), mark_period=8)
    want = tdb.dist_suffix_array(text, tmesh, **kw)
    ck = str(tmp_path / "ck")
    with monkeypatch.context() as m:
        m.setattr(tdb, "_ckpt_clear", lambda *a, **k: None)
        first = tdb.dist_suffix_array(text, tmesh, checkpoint_dir=ck, **kw)
    path = tdb.LAST_BUILD_STATS["path"]
    assert path == ("wide" if stage == "seed" else "doubling")
    with np.load(os.path.join(ck, os.listdir(ck)[0])) as z:
        assert str(z["stage"]) == stage
    again = tdb.dist_suffix_array(text, tmesh, checkpoint_dir=ck, **kw)
    assert tdb.LAST_BUILD_STATS.get("resumed")
    assert not os.listdir(ck)
    for a, b, c in zip(want, first, again):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_array_equal(a.numpy(), c.numpy())


# the regex queries held to femto_tpu's sharded engine: a class, an
# alternation, an approximate term and one whose frontier (94 live
# entries) overflows the first capacities, here a frontier of 64 entries
REGEX_QUERIES = {"qu[ia]ck": {}, "(fox|dog)": {}, "APPROX 1 banana": {},
                 "..": {"frontier_cap": 64}}
TIERS = ("full", "packed", "vseg", "vrle")


def _matches(ms, shift=0):
    return [(m.first + shift, m.last + shift, m.cost) for m in ms]


@pytest.fixture(scope="module")
def femto_regex(built, jmesh):
    """femto_tpu's sharded matches of REGEX_QUERIES on its full index."""
    jix = built["five", "full"][1]
    out = {}
    for q, kw in REGEX_QUERIES.items():
        node = j_parse(q)
        out[q] = _matches(jdq.sharded_regexp_matches(
            jix, jmesh, j_compile(j_streamline(node.regexp)), node.approx,
            **kw))
    return jix.meta.row0, out


@pytest.mark.parametrize("tier", TIERS)
def test_sharded_regexp_like_femto_tpu(port_tiers, femto_regex, tmesh, tier):
    row0, want = femto_regex
    tix = port_tiers[tier]
    for q, kw in REGEX_QUERIES.items():
        node = t_parse(q)
        got = tdq.sharded_regexp_matches(
            tix, tmesh, t_compile(t_streamline(node.regexp)), node.approx,
            **kw)
        assert _matches(got, row0 - tix.meta.row0) == want[q], (tier, q)
        assert RD.last_stats["retries"] == (q == "..")


@pytest.fixture(scope="module")
def femto_answers(built, femto_five):
    """femto_tpu's sharded query functions, its two costly steps computed
    by femto_tpu once: each distinct term's ranges, and the offsets of
    every row of an index (one sharded_locate of all of them, whose
    entries the queries' locates then read; femto_five's on the five
    documents' full index).  Its functions are deterministic, and they
    recompile on every call."""
    ranges = {}
    offsets = {id(built["five", "full"][1]): femto_five[3]}
    term_ranges, locate = jdq.sharded_term_ranges, jdq.sharded_locate

    def ranges_once(index, mesh, term, axis=jdq.DEFAULT_AXIS):
        key = (id(index), repr(term))
        if key not in ranges:
            ranges[key] = term_ranges(index, mesh, term, axis)
        return list(ranges[key])

    def located(index, mesh, rows, axis=jdq.DEFAULT_AXIS):
        if id(index) not in offsets:
            every = np.arange(index.meta.n_rows, dtype=np.int32)
            offsets[id(index)] = np.asarray(locate(index, mesh, every, axis))
        return offsets[id(index)][np.asarray(rows)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdq, "sharded_term_ranges", ranges_once)
        mp.setattr(jdq, "sharded_locate", located)
        yield jdq


# (query, icase) held to femto_tpu's sharded count_query and docs_query
FEMTO_QUERIES = [("qu[ia]ck", False), ("'quick' AND 'quack'", False),
                 ("quick THEN 20 quack", False), ("quack NOT quick", False),
                 ("QU[IA]CK", True), ("APPROX 2 banana boat", False)]


@pytest.mark.parametrize("query,icase", FEMTO_QUERIES)
def test_sharded_queries_like_femto_tpu(built, port_tiers, femto_answers,
                                        jmesh, tmesh, query, icase):
    """sharded_docs_query and sharded_count_query equal femto_tpu's on the
    full index (a Boolean count is the size of the document set the docs
    query evaluates, so one Boolean count is held).  The engine above the
    ranks is the same on every tier; the row tiers' ranks are held to
    femto_tpu's by the regex test above and to the single-device engine
    below."""
    jix = built["five", "full"][1]
    tix = port_tiers["full"]
    assert tdq.sharded_docs_query(tix, tmesh, query, icase=icase) == \
        femto_answers.sharded_docs_query(jix, jmesh, query, icase=icase)
    if isinstance(t_parse(query), QTerm) or "AND" in query:
        assert tdq.sharded_count_query(tix, tmesh, query, icase=icase) == \
            femto_answers.sharded_count_query(jix, jmesh, query,
                                              icase=icase)


# the rest: held to the port's single-device engine on every tier
OWN_QUERIES = [("count", "[a-z]+ck"), ("count", "APPROX 1 abracadabra"),
               ("docs", "banana WITHIN 8 boat"), ("docs", "'the' OR a{2,3}")]


@pytest.fixture(scope="module")
def singles():
    prep = tt.prepare_documents(_corpus("five"))
    return {t: tt.build_index(prep, seg=32, mark_period=8, tier=t,
                              device="cpu") for t in TIERS}


@pytest.mark.parametrize("tier", TIERS)
def test_sharded_queries_hold_single_device(port_tiers, singles, tmesh,
                                            tier):
    tix, six = port_tiers[tier], singles[tier]
    for kind, q in OWN_QUERIES:
        if kind == "count":
            assert tdq.sharded_count_query(tix, tmesh, q) == \
                count_query(six, q), (tier, q)
        else:
            got = tdq.sharded_docs_query(tix, tmesh, q)
            assert got == docs_query(six, q), (tier, q)


def test_truncation_flag_like_femto_tpu(built, port_tiers, femto_answers,
                                        jmesh, tmesh, monkeypatch):
    """full_eval=False with a lowered SHARDED_TERM_CAP truncates and warns
    as femto_tpu does (tests/test_dist.py:556); full evaluation stays
    exact, also in windows of 2 rows."""
    jix = built["five", "full"][1]
    tix = port_tiers["packed"]
    q = "'quick' AND 'quack'"
    node = t_parse(q)
    monkeypatch.setattr(tdq, "SHARDED_TERM_CAP", 2)
    monkeypatch.setattr(jdq, "SHARDED_TERM_CAP", 2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert not tdq._sharded_execute(tix, tmesh, node).truncated
        full = tdq.sharded_docs_query(tix, tmesh, q)
    monkeypatch.setattr(tdq, "SHARDED_LOCATE_WINDOW", 2)
    assert tdq.sharded_docs_query(tix, tmesh, q) == full
    monkeypatch.setattr(tdq, "SHARDED_LOCATE_WINDOW", 1 << 20)
    res = tdq._sharded_execute(tix, tmesh, node,
                               term_cap=tdq.SHARDED_TERM_CAP)
    jres = jdq._sharded_execute(jix, jmesh, j_parse(q), "bins",
                                term_cap=jdq.SHARDED_TERM_CAP)
    assert res.truncated and jres.truncated
    assert sorted(res.doc_set().tolist()) == sorted(
        jres.doc_set().tolist())
    with pytest.warns(TruncationWarning):
        tdq.sharded_docs_query(tix, tmesh, q, full_eval=False)


def test_sharded_frontier_overflow_raises(port_tiers, tmesh, monkeypatch):
    """Past its largest capacities the sharded frontier raises
    RuntimeError (it has no host engine to fall back on)."""
    monkeypatch.setattr(tdq, "MAX_FRONTIER_CAPS", (64, 4096, 64))
    node = t_parse("..")
    with pytest.raises(RuntimeError, match="overflow"):
        tdq.sharded_regexp_matches(port_tiers["vrle"], tmesh,
                                   t_compile(t_streamline(node.regexp)),
                                   frontier_cap=64)


def _j(t):
    """A JAX array holding a copy of a tensor (jnp.asarray may alias the
    tensor's memory)."""
    return jnp.array(np.array(t.numpy(), copy=True))


def _femto_rank(arrays):
    """A rank hook for query/regexp_device._layer whose forks' ranges come
    from femto_tpu's backward_step_pair on JAX copies of the arrays (one
    jitted program: the lanes are padded to 256 entries' forks)."""
    jarrays = ft.FMArrays(**{k: None if v is None else _j(v)
                             for k, v in arrays._asdict().items()})
    step = jax.jit(JR.backward_step_pair)

    def rank(first, last, n_live):
        A, F = ALPHA_SIZE, 256
        assert n_live <= F
        ends = [np.repeat(np.resize(x[:n_live].numpy(), F), A)
                for x in (first, last)]
        chars = np.tile(np.arange(A, dtype=np.int32), F)
        nf, nl = step(jarrays, jnp.asarray(chars), *map(jnp.asarray, ends))
        return (torch.from_numpy(np.array(nf[:n_live * A], np.int32)),
                torch.from_numpy(np.array(nl[:n_live * A], np.int32)))

    return rank


@pytest.mark.parametrize("q", list(REGEX_QUERIES))
def test_regex_fork_ranked_plain(singles, femto_regex, monkeypatch, q):
    """Kernel R's given-ranges fork (its plain version here), fed
    femto_tpu's backward_step_pair ranks on a single-device index layer
    after layer, with H's sort and R's merge: the matches equal
    femto_tpu's sharded engine's (shifted by row0)."""
    monkeypatch.setattr(RO, "regex_fork", None)   # the ranked entry only
    ix = singles["full"]
    row0, want = femto_regex
    node = t_parse(q)
    got = RD._run_regexp_device_once(
        ix, t_compile(t_streamline(node.regexp)), node.approx, 4096, 65536,
        64, with_strings=False, rank=_femto_rank(ix.arrays))
    assert _matches(got, row0 - ix.meta.row0) == want[q]
