"""Paged serving in femto_tpu_torch (paged.PagedIndex) against femto_tpu's.

One .ftpu file, built by the port on the CPU (vrle and vseg, seg 256,
mark_period 8) from tests/test_paged.py's pydoc corpus cut to 120 KB, is
opened by femto_tpu.paged.load_paged and by the port's load_paged
(device="cpu") at a budget of a quarter of its rows.  Every output is
integers or bytes, so the tolerance is exact: after every call the two
must give the same answers, the same stats, cache size, slot maps and
clock, and bit for bit the same cache.  The plain cache update and the
plain paged steps are held to the JAX functions they replace on the same
cache; context over a paged index raises (femto_tpu returns wrong bytes
there, ROADMAP Q3).
"""

import os

import jax.numpy as jnp
import numpy as np
import pydoc_data.topics as topics
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import paged as JP
from femto_tpu import search as JS
from femto_tpu.query import engine as JE
from femto_tpu.query.nfa import compile_nfa as j_compile_nfa
from femto_tpu.query.parser import parse_query as j_parse_query
from femto_tpu.query.planning import streamline as j_streamline
from femto_tpu.query.regexp import run_regexp as j_run_regexp
from femto_tpu_torch import paged as TP
from femto_tpu_torch import query as TQ
from femto_tpu_torch.ops import paged_ops as TPO
from femto_tpu_torch.ops import search_ops as TS
from femto_tpu_torch.query.nfa import compile_nfa
from femto_tpu_torch.query.parser import parse_query
from femto_tpu_torch.query.planning import streamline
from femto_tpu_torch.query.regexp import run_regexp
from tests.oracle import naive_count
from tests.torch_threads import one_torch_thread  # noqa: F401


def _docs():
    buf = ("\n".join(sorted(topics.topics.values()))).encode()[:120000]
    docs = [buf[i:i + 30000] for i in range(0, len(buf), 30000)]
    return docs + [b"zz-needle-zz" + buf[:500]]


def _quarter_budget(path):
    """The resident arrays, the slot map and a quarter of the rows."""
    meta, infos, arrs = ft.FMIndex.parse_flat(path)
    rows = arrs["bwt"]
    resident = sum(v.nbytes for k, v in arrs.items() if k != "bwt")
    return resident + rows.shape[0] * 4 + rows.nbytes // 4


@pytest.fixture(scope="module", params=["vrle", "vseg"])
def pair(request, tmp_path_factory):
    docs = _docs()
    ix = tt.build_index(tt.prepare_documents(docs), tier=request.param,
                        seg=256, mark_period=8, device="cpu")
    path = str(tmp_path_factory.mktemp("pg") / "idx.ftpu")
    ix.save_flat(path)
    budget = _quarter_budget(path)
    jpg = JP.load_paged(path, budget_bytes=budget)
    tpg = TP.load_paged(path, budget_bytes=budget, device="cpu")
    assert tpg.cache_rows == 256 < ix.meta.n_seg  # the least cache
    same_state(jpg, tpg)
    FILES[request.param] = (path, budget)
    return docs, ix, jpg, tpg


FILES = {}  # tier -> (.ftpu path, budget) of the fixture


def tier_of(ix):
    return "vrle" if ix.arrays.seg_rle is not None else "vseg"


def same_state(jpg, tpg):
    """Stats, cache size, slot maps, clock and cache rows, exactly."""
    assert tpg.stats == jpg.stats
    assert tpg.cache_rows == jpg.cache_rows
    assert tpg._clock == jpg._clock
    np.testing.assert_array_equal(tpg._slot_map_np, jpg._slot_map_np)
    np.testing.assert_array_equal(tpg._slot_seg, jpg._slot_seg)
    np.testing.assert_array_equal(tpg._slot_map.numpy(),
                                  np.asarray(jpg._slot_map))
    np.testing.assert_array_equal(tpg._cache.numpy(), np.asarray(jpg._cache))


def both_ranges(jpg, tpg, pattern):
    """count_ranges of one pattern on both paged indexes (equal)."""
    got = tt.count_ranges(tpg, [pattern])
    want = ft.count_ranges(jpg, [pattern])
    np.testing.assert_array_equal(np.stack(got), np.stack(want))
    return got


PATTERNS = [b"the", b"of ", b"index", b"zz-needle-zz", b"qqqqzz", b"a"]


def test_count_cold_then_warm(pair):
    docs, ix, jpg, tpg = pair
    want = np.asarray([naive_count(docs, p) for p in PATTERNS])
    np.testing.assert_array_equal(tpg.count(PATTERNS), want)
    np.testing.assert_array_equal(jpg.count(PATTERNS), want)
    same_state(jpg, tpg)
    faults = tpg.stats["faults"]
    np.testing.assert_array_equal(tt.count(tpg, PATTERNS), want)
    np.testing.assert_array_equal(ft.count(jpg, PATTERNS), want)
    assert tpg.stats["faults"] == faults  # warm: no new fault
    same_state(jpg, tpg)


def test_count_ranges(pair):
    docs, ix, jpg, tpg = pair
    pats = [b"in", b"tion", b"", b"\x00", b"Python"] * 3
    got = tt.count_ranges(tpg, pats)
    want = ft.count_ranges(jpg, pats)
    for g, w, r in zip(got, want, tt.count_ranges(ix, pats)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, r)
    same_state(jpg, tpg)


def test_locate_range(pair):
    docs, ix, jpg, tpg = pair
    f, l = both_ranges(jpg, tpg, b"index")
    got = tt.locate_range(tpg, int(f[0]), int(l[0]))
    np.testing.assert_array_equal(
        got, ft.locate_range(jpg, int(f[0]), int(l[0])))
    np.testing.assert_array_equal(got, tt.locate_range(ix, int(f[0]),
                                                       int(l[0])))
    same_state(jpg, tpg)


def test_disjoint_batches_recycle_slots(pair):
    """Three 320-row batches, two rows in each of 160 segments, over
    disjoint segments: together far more than the cache holds, so the
    clock recycles slots."""
    docs, ix, jpg, tpg = pair
    rng = np.random.default_rng(3)
    segs = rng.permutation(ix.meta.n_seg)[:480].reshape(3, 160)
    start = tpg.stats["faults"]
    for batch in segs:
        rows = np.minimum(np.repeat(batch, 2) * 256
                          + rng.integers(0, 256, 320),
                          ix.meta.n_rows - 1).astype(np.int32)
        got = tt.locate_rows_array(tpg, rows)
        np.testing.assert_array_equal(got, JS.locate_rows_array(jpg, rows))
        np.testing.assert_array_equal(got, tt.locate_rows_array(ix, rows))
        same_state(jpg, tpg)
    assert tpg.stats["faults"] - start > tpg.cache_rows


def test_locate(pair):
    docs, ix, jpg, tpg = pair
    got = tt.locate(tpg, b"zz-needle-zz")
    assert got == ft.locate(jpg, b"zz-needle-zz") == [(len(docs) - 1, 0)]
    assert tpg.locate(b"index", max_matches=7) == jpg.locate(
        b"index", max_matches=7)
    same_state(jpg, tpg)


def test_extract_document(pair):
    docs, ix, jpg, tpg = pair
    d = len(docs) - 1
    before = tpg.stats["dispatches"]
    assert tt.extract_document(tpg, d) == docs[d]
    assert ft.extract_document(jpg, d) == docs[d]
    assert tpg.stats["dispatches"] - before == len(docs[d])
    same_state(jpg, tpg)


@pytest.mark.parametrize("q", ["ind[ea]x", "APPROX 1 indx"])
def test_host_regex_engine(pair, q):
    """The host engine faults each layer in through _ensure_rows."""
    docs, ix, jpg, tpg = pair
    node = parse_query(q)
    got = sorted((m.first, m.last, m.cost) for m in run_regexp(
        tpg, compile_nfa(streamline(node.regexp)), node.approx))
    jnode = j_parse_query(q)
    want = sorted((m.first, m.last, m.cost) for m in j_run_regexp(
        jpg, j_compile_nfa(j_streamline(jnode.regexp)), jnode.approx))
    assert got == want
    same_state(jpg, tpg)


@pytest.mark.parametrize("q", ['"the" AND "index"', "ind[ea]x",
                               '"needle"'])
def test_engine_queries(pair, q):
    docs, ix, jpg, tpg = pair
    got = {d for d, _, _ in TQ.docs_query(tpg, q)}
    assert got == {d for d, _, _ in JE.docs_query(jpg, q)}
    assert got == {d for d, _, _ in TQ.docs_query(ix, q)}
    same_state(jpg, tpg)
    assert TQ.count_query(tpg, q) == JE.count_query(jpg, q)
    same_state(jpg, tpg)


def test_range_docs(pair):
    docs, ix, jpg, tpg = pair
    for pat in (b"index", b"the "):
        f, l = both_ranges(jpg, tpg, pat)
        got = tt.range_docs(tpg, int(f[0]), int(l[0]))
        np.testing.assert_array_equal(
            got, JS.range_docs(jpg, int(f[0]), int(l[0])))
        np.testing.assert_array_equal(
            got, tt.range_docs(ix, int(f[0]), int(l[0])))
        same_state(jpg, tpg)


def test_context_raises_over_a_paged_index(pair):
    """femto_tpu's extract_context_batch has no paged dispatch and returns
    wrong bytes over a PagedIndex; the port raises."""
    docs, ix, jpg, tpg = pair
    f, l = both_ranges(jpg, tpg, b"index")
    rows = np.arange(int(f[0]), int(l[0]))
    with pytest.raises(NotImplementedError, match="paged"):
        tt.extract_context_batch(tpg, rows, 5, 5, 5)
    with pytest.raises(NotImplementedError, match="paged"):
        tt.extract_context(tpg, int(rows[0]), 5, 5, 5)
    with pytest.raises(NotImplementedError, match="paged"):
        tt.extract_all_documents(tpg)
    # femto_tpu's fault, on a fresh paged index of the same file: every
    # match row's context differs from the resident index's
    path, budget = FILES[tier_of(ix)]
    fresh = JP.load_paged(path, budget_bytes=budget)
    want = tt.extract_context_batch(ix, rows, 5, 5, 5)
    got = JS.extract_context_batch(fresh, rows, 5, 5, 5)
    assert len(rows) == 5
    assert sum(g != w for g, w in zip(got, want)) == 5


def test_too_many_segments_raise(pair):
    docs, ix, jpg, tpg = pair
    rows = np.arange(tpg.cache_rows + 8) * 256
    for pg in (jpg, tpg):
        with pytest.raises(ValueError, match="segments"):
            pg._ensure_rows(rows)
    same_state(jpg, tpg)


def test_plain_steps_match_femto_tpu_on_the_same_cache(pair):
    """Each plain paged step on the port's half-filled cache against the
    JAX step on femto_tpu's identical one."""
    docs, ix, jpg, tpg = pair
    rng = np.random.default_rng(11)
    n_rows = ix.meta.n_rows
    B = 64
    rows = rng.integers(0, n_rows, B).astype(np.int32)
    for pg in (jpg, tpg):
        pg._ensure_rows(rows)
    same_state(jpg, tpg)
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    j = jnp.asarray
    # masked step: -1 lanes keep their range, absent symbols empty it
    c = rng.integers(0, 300, B).astype(np.int32)
    c[::5] = -1
    first = np.sort(rows)
    last = np.minimum(first + rng.integers(0, 3, B).astype(np.int32),
                      n_rows - 1).astype(np.int32)
    for pg in (jpg, tpg):
        pg._ensure_rows(np.concatenate([first, last]))
    got = TS.backward_step_masked(tpg.arrays, t(c), t(first), t(last))
    want = JP._pair_step(jpg.arrays, j(c), j(first), j(last))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # one locate step, then the mark decode
    granks = rng.integers(0, 50, B).astype(np.int32)
    steps = rng.integers(0, 5, B).astype(np.int32)
    done = rng.random(B) < 0.3
    got = TS.lf_walk_step(tpg.arrays, t(rows), t(granks), t(steps),
                          t(done), 3)
    want = JP._walk_step(jpg.arrays, j(rows), j(granks), j(steps), j(done),
                         jnp.int32(3))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(
        TS.resolve_marks(tpg.arrays, t(granks), t(steps)).numpy(),
        np.asarray(JP._resolve_marks(jpg.arrays, j(granks), j(steps))))
    # the one-step extract: (LF(r), the symbol at r in alphabet space)
    chars, nxt = TS.extract_backward(tpg.arrays, t(rows), 1)
    w_nxt, w_c = JP._extract_step(jpg.arrays, j(rows))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(w_nxt))
    np.testing.assert_array_equal(chars[:, 0].numpy(), np.asarray(w_c))
    same_state(jpg, tpg)


def test_paged_walk_every_step_matches_femto_tpu(pair):
    """A whole paged locate walk, i = 0 ... mark_period, step by step on a
    half-filled cache with a random seg_slot: before each step
    chip_smoke.walk_faults maps the segments of the lanes not done, after
    evicting those of the lanes that are done (a done lane reads no row);
    every step of the port's lf_walk_step (its plain version here) equals
    femto_tpu's _walk_step on the same cache, and the offsets after the
    walk equal locate on the resident index."""
    from chip_smoke import walk_faults

    docs, ix, jpg, tpg = pair
    rng = np.random.default_rng(23)
    bwt = ix.arrays.bwt.numpy()
    n_seg, W = bwt.shape
    seg, n, mp = ix.meta.seg, ix.meta.n, ix.meta.mark_period
    cache_rows = n_seg // 2 + 1
    cache = np.zeros((cache_rows, W), np.uint32)
    smap = np.zeros(n_seg, np.int32)
    slot_seg = np.full(cache_rows, -1, np.int64)
    segs = rng.permutation(n_seg)[: cache_rows - 1]
    slots = rng.permutation(cache_rows - 1) + 1
    cache[slots], smap[segs], slot_seg[slots] = bwt[segs], slots, segs
    B = 48
    r = rng.integers(0, n, 8 * B)
    start = r[smap[r // seg] > 0][:B].astype(np.int32)
    rows, granks, steps = start, np.zeros(B, np.int32), np.zeros(B, np.int32)
    done = np.zeros(B, bool)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    evicted = 0
    for i in range(mp + 1):
        slots, segs, gone = walk_faults(rows, done, seg, smap, slot_seg)
        cache[slots] = bwt[segs]
        evicted += gone
        assert (smap[rows[~done] // seg] > 0).all()
        t_arr = tpg.arrays._replace(bwt=t(cache.copy()),
                                    seg_slot=t(smap.copy()))
        j_arr = jpg.arrays._replace(bwt=jnp.asarray(cache),
                                    seg_slot=jnp.asarray(smap))
        got = TS.lf_walk_step(t_arr, t(rows), t(granks), t(steps), t(done),
                              i)
        want = JP._walk_step(j_arr, jnp.asarray(rows), jnp.asarray(granks),
                             jnp.asarray(steps), jnp.asarray(done),
                             jnp.int32(i))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        rows, granks, steps, done = (np.array(w) for w in want)
        if done.all():
            break
    assert done.all() and evicted > 0
    np.testing.assert_array_equal(
        TS.resolve_marks(t_arr, t(granks), t(steps)).numpy(),
        TS.locate_rows(ix.arrays, mp, t(start)).numpy())


def test_plain_apply_faults_matches_femto_tpu(pair):
    """The cache update with out-of-range (dropped) entries on copies of
    the two caches."""
    docs, ix, jpg, tpg = pair
    rng = np.random.default_rng(5)
    cache_rows, W = tpg._cache.shape
    n_seg = tpg._slot_map.shape[0]
    m = 24
    slots = rng.choice(cache_rows, m, replace=False).astype(np.int32)
    slots[-2:] = cache_rows + np.arange(2)           # dropped
    segs = rng.choice(n_seg, 2 * m, replace=False).astype(np.int32)
    segs, evict = segs[:m], segs[m:]
    segs[0] = n_seg                                    # dropped
    evict[3] = -1 - n_seg                              # dropped
    rows = rng.integers(0, 2**32, (m, W), dtype=np.uint64).astype(np.uint32)
    cache, smap = tpg._cache.clone(), tpg._slot_map.clone()
    TPO.apply_faults(cache, smap, torch.from_numpy(slots),
                     torch.from_numpy(rows), torch.from_numpy(evict),
                     torch.from_numpy(segs))
    w_cache, w_map = JP._apply_faults(
        jpg._cache, jpg._slot_map, jnp.asarray(slots), jnp.asarray(rows),
        jnp.asarray(evict), jnp.asarray(segs))
    np.testing.assert_array_equal(cache.numpy(), np.asarray(w_cache))
    np.testing.assert_array_equal(smap.numpy(), np.asarray(w_map))
    same_state(jpg, tpg)  # the index's own cache is untouched


def test_load_auto_and_refusals(tmp_path):
    docs = _docs()[:2]
    prep = tt.prepare_documents(docs)
    ix = tt.build_index(prep, tier="vrle", seg=256, mark_period=8,
                        device="cpu")
    path = str(tmp_path / "idx.ftpu")
    ix.save_flat(path)
    total = os.path.getsize(path)
    assert isinstance(TP.load_auto(path, budget_bytes=total // 3,
                                   device="cpu"), TP.PagedIndex)
    assert isinstance(TP.load_auto(path, budget_bytes=total * 10,
                                   device="cpu"), tt.FMIndex)
    old = os.environ.pop("FEMTO_TPU_HBM_BUDGET", None)
    os.environ["FEMTO_TPU_HBM_BUDGET"] = str(total // 3)
    try:
        pg = TP.load_auto(path, device="cpu")
        assert isinstance(pg, TP.PagedIndex)
        assert pg.cache_rows == JP.load_auto(path).cache_rows
        del os.environ["FEMTO_TPU_HBM_BUDGET"]
        assert isinstance(TP.load_auto(path, device="cpu"), tt.FMIndex)
    finally:
        os.environ.pop("FEMTO_TPU_HBM_BUDGET", None)
        if old is not None:
            os.environ["FEMTO_TPU_HBM_BUDGET"] = old
    full = str(tmp_path / "full.ftpu")
    tt.build_index(prep, seg=256, mark_period=8, device="cpu").save_flat(full)
    with pytest.raises(ValueError, match="row tiers"):
        TP.load_paged(full, budget_bytes=1, device="cpu")
    assert isinstance(TP.load_auto(full, budget_bytes=1, device="cpu"),
                      tt.FMIndex)
    # the seg_slot field belongs to PagedIndex alone
    arrs = {k: v.numpy() for k, v in ix.arrays._asdict().items()
            if v is not None}
    arrs["seg_slot"] = np.zeros(ix.meta.n_seg, np.int32)
    with pytest.raises(NotImplementedError, match="PagedIndex"):
        tt.arrays_from_numpy(arrs, ix.meta, device="cpu")
