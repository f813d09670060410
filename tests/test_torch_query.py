"""Parity of femto_tpu_torch.query with femto_tpu.query.

On the CPU the port's wrappers run the plain PyTorch versions of kernel
C's backward_step and backward_search_steps and of kernel R's regex_fork
and regex_merge (kernel H's sort too).  Every answer is integers or
bytes, so the tolerance is exact.  The indexes: the documents of
tests/test_regexp_device.py and tests/test_query.py at seg 64 on the
full, packed and vrle tiers (the port's own builds) and a femto_tpu
pad_shape index (row0 > 0) carried across with arrays_from_numpy.
femto_tpu's device engine compiles one XLA program per NFA shape and
capacity, so its runs here are few; its host engine and Python re hold
the rest.
"""

import dataclasses
import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.alphabet import pattern_to_alpha
from femto_tpu.ops import rank as JR
from femto_tpu.ops import search_ops as JS
from femto_tpu.query import engine as JE
from femto_tpu.query import nfa as JN
from femto_tpu.query import parser as JP
from femto_tpu.query import planning as JPL
from femto_tpu.query import regexp as JRX
from femto_tpu.query import regexp_device as JRD
from femto_tpu.query import results as JRES
from femto_tpu.search import pack_patterns
from femto_tpu_torch import query as TQ
from femto_tpu_torch.ops import regex_ops as TRO
from femto_tpu_torch.ops import search_ops as TS
from femto_tpu_torch.query import engine as TE
from femto_tpu_torch.query import nfa as TN
from femto_tpu_torch.query import planning as TPL
from femto_tpu_torch.query import regexp as TRX
from femto_tpu_torch.query import regexp_device as TRD
from femto_tpu_torch.query import results as TRES
from tests.test_regex_fuzz import gen_regex, py_count, py_docs
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_search import _carry


def _rd_docs():
    rng = np.random.default_rng(5)
    return [
        b"the quick brown fox jumps over the lazy dog",
        b"banana bandana bananas",
        b"abcabcabcabc",
        bytes(rng.integers(97, 101, size=300).astype(np.uint8)),
    ]


def _q_docs():
    rng = np.random.default_rng(3)
    return [
        b"the quick brown fox jumps over the lazy dog",
        b"pack my box with five dozen liquor jugs",
        b"sheep black sheep baa baa black",
        b"abcabcabcabc",
        b"banana bandana bananas",
        bytes(rng.integers(97, 103, size=400).astype(np.uint8)),
    ]


TIERS = ["full", "packed", "vrle", "pad"]


def _indexes(docs, tiers=TIERS[:3]):
    """({tier: femto_tpu index}, {tier: port index}): the port's own
    builds beside femto_tpu's of the same tier; "pad" is a femto_tpu
    pad_shape index (leading pad rows, row0 > 0) carried across."""
    prep = ft.prepare_documents(docs)
    jixs = {t: ft.build_index(prep, seg=64, mark_period=8, tier=t)
            for t in tiers}
    jixs["pad"] = ft.build_index(prep, seg=64, mark_period=8,
                                 pad_shape=(prep.n + 100,
                                            prep.num_docs + 2))
    assert jixs["pad"].meta.row0 > 0
    tprep = tt.prepare_documents(docs)
    ports = {t: tt.build_index(tprep, seg=64, mark_period=8, tier=t,
                               device="cpu") for t in tiers}
    ports["pad"] = _carry(jixs["pad"])
    return jixs, ports


@pytest.fixture(scope="module")
def rd():
    docs = _rd_docs()
    return (docs, *_indexes(docs))


@pytest.fixture(scope="module")
def qc():
    docs = _q_docs()
    return (docs, *_indexes(docs, ("full", "vrle")))


def _tree(x):
    """A parse tree / NFA part as nested plain values (masks as the
    indices they set), to compare the two packages' objects field by
    field."""
    if isinstance(x, np.ndarray):
        return ("array", x.dtype.str, x.shape, x.tobytes())
    if dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            (f.name, _tree(getattr(x, f.name)))
            for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return tuple(_tree(v) for v in x)
    return x


QUERIES = [
    "quick", "ban(ana|dana)", "ab[cd]", "b.n", "a+b", "(abc){2}",
    "shee?p|fox", "[ab]{3}", "[^a-z]", "a{2,3}", ".*quick.*", "x?",
    "APPROX 2 blacksheep", "APPROX 1:2:1:2 blacksheep", "APPROX blacksheep",
    "black AND sheep", "(black AND sheep) OR dog", "black THEN 20 sheep",
    "sheep WITHIN 6 black", "ba NOT sheep", r"black\ sheep",
    "'bl\\ack'", r"\x41\x42", "{x 41 42 }", r"\n\t", "QUICK",
    "0{1,64}1", "(ab|cd){1,64}",
]


@pytest.mark.parametrize("q", QUERIES)
def test_host_modules_match_femto(q):
    """parse_query, apply_icase, streamline, fold_case, matches_empty and
    compile_nfa (states, transitions, masks, accept, char_union)."""
    jn, tn = JP.parse_query(q), TQ.parse_query(q)
    assert _tree(tn) == _tree(jn)
    assert _tree(TE.apply_icase(tn)) == _tree(JE.apply_icase(jn))
    if isinstance(jn, JP.QTerm):
        for fn_t, fn_j in ((TPL.streamline, JPL.streamline),
                           (TPL.fold_case, JPL.fold_case)):
            assert _tree(fn_t(tn.regexp)) == _tree(fn_j(jn.regexp))
        assert TPL.matches_empty(tn.regexp) == JPL.matches_empty(jn.regexp)
        ja = JN.compile_nfa(JPL.streamline(jn.regexp))
        ta = TN.compile_nfa(TPL.streamline(tn.regexp))
        assert ta.num_states == ja.num_states
        assert np.array_equal(ta.accept, ja.accept)
        assert np.array_equal(ta.char_union, ja.char_union)
        assert _tree(ta.trans) == _tree(ja.trans)
        assert TN.MAX_REPEAT_EXPANSION == JN.MAX_REPEAT_EXPANSION == 64


def test_parse_errors_match_femto():
    for q in ["(ab", "[abc", "\\", '"abc', "a)", "\\xZZ", "a THEN b",
              "{x 4G}"]:
        with pytest.raises(JP.ParseError) as want:
            JP.parse_query(q)
        with pytest.raises(TQ.ParseError) as got:
            TQ.parse_query(q)
        assert str(got.value) == str(want.value)


def _results(r):
    return (r.type.name, r.count, r.docs.tolist(), r.offsets.tolist(),
            r.truncated)


@pytest.mark.parametrize("op", ["union", "intersect", "subtract", "then",
                                "within"])
def test_results_ops_match_femto(op):
    """Results set operations on seeded (doc, offset) sets, both operand
    types, with the truncation flag carried."""
    rng = np.random.default_rng(11)
    for trial in range(10):
        na, nb = rng.integers(0, 80, size=2)
        a = (rng.integers(0, 6, na), rng.integers(0, 300, na))
        b = (rng.integers(0, 6, nb), rng.integers(0, 300, nb))
        dist = int(rng.integers(0, 40))
        out = []
        for M in (JRES, TRES):
            ra, rb = M.Results.from_doc_offsets(*a), \
                M.Results.from_doc_offsets(*b)
            rb.truncated = bool(trial % 2)
            if op in ("then", "within"):
                out.append(_results(M.then_within(ra, rb, dist,
                                                  ordered=op == "then")))
            else:
                out.append(_results(getattr(M, op)(ra, rb)))
                out.append(_results(getattr(M, op)(
                    M.Results.from_docs(a[0]), M.Results.from_docs(b[0]))))
        half = len(out) // 2
        assert out[:half] == out[half:]


def _lanes(n_rows, rng, B=300):
    c = rng.integers(-1, 300, size=B).astype(np.int32)
    c[:40] = -1
    ends = np.sort(rng.integers(0, n_rows + 1, size=(B, 2)), axis=1)
    ends[:8] = (0, n_rows)
    return c, ends[:, 0].astype(np.int32), ends[:, 1].astype(np.int32)


@pytest.mark.parametrize("tier", TIERS)
def test_backward_step_pair_matches_femto(rd, tier):
    """Free lanes with -1 pads, out-of-alphabet and absent symbols."""
    docs, jixs, ports = rd
    ix, ref = ports[tier], jixs[tier]
    c, f, l = _lanes(ix.meta.n_rows, np.random.default_rng(7))
    got = TS.backward_step_pair(ix.arrays, torch.from_numpy(c),
                                torch.from_numpy(f), torch.from_numpy(l))
    want = JR.backward_step_pair(ref.arrays, jnp.asarray(c.copy()),
                                 jnp.asarray(f.copy()), jnp.asarray(l.copy()))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not got[1][torch.from_numpy((c < 0) | (c >= 261))].any()


@pytest.mark.parametrize("tier", TIERS)
def test_backward_search_steps_matches_femto(rd, tier):
    """test_core.py's too-few-matches case, pad lanes, row0."""
    docs, jixs, ports = rd
    ix, ref = ports[tier], jixs[tier]
    pats = [b"\xfebanana", b"banana", b"", b"zzzq", b"the lazy", b"ana",
            b"\x00\x01", docs[3][10:40]]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    packed[1, -2] = 300  # an out-of-alphabet code
    n, row0 = ix.meta.n_rows, ix.meta.row0
    got = TS.backward_search_steps(ix.arrays, n, torch.from_numpy(packed),
                                   row0)
    want = JS.backward_search_steps(ref.arrays, n,
                                    jnp.asarray(packed.copy()), row0)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    first, last, pf, pl, matched = (g.numpy() for g in got)
    assert last[0] <= first[0] and matched[0] == 6
    assert pl[0] - pf[0] == int(tt.count(ix, [b"banana"])[0])
    assert (matched[B:] == 0).all()


RD_CASES = [
    ("quick", None), ("ban(ana|dana)", None), ("ab[cd]", None),
    ("b.n", None), ("a+b", None), ("(abc){2}", None), ("shee?p|fox", None),
    ("[ab]{3}", None),
    ("quick", JRX.ApproxSettings.edit_distance(1)),
    ("quack", JRX.ApproxSettings.edit_distance(1)),
    ("bananna", JRX.ApproxSettings.edit_distance(1)),
    ("abcabc", JRX.ApproxSettings(cost_bound=2, subst_cost=2,
                                  delete_cost=1, insert_cost=2)),
    ("hello", JRX.ApproxSettings.edit_distance(1)),
]


def _nfas(q):
    j = JN.compile_nfa(JP.parse_query(q).regexp)
    t = TN.compile_nfa(TQ.parse_query(q).regexp)
    return j, t


def _tsettings(s):
    return TQ.ApproxSettings(**dataclasses.asdict(s or
                                                  JRX.ApproxSettings()))


def _full(ms):
    return [(m.first, m.last, m.cost, m.match) for m in ms]


def _ranges(ms):
    return sorted((m.first, m.last, m.cost) for m in ms)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("case", range(len(RD_CASES)))
def test_run_regexp_matches_femto(rd, tier, case):
    """The host engine (ranges, costs and strings, in order) and the
    device frontier's plain version (ranges and costs) against femto_tpu's
    host engine."""
    docs, jixs, ports = rd
    q, s = RD_CASES[case]
    jn, tn = _nfas(q)
    js = s or JRX.ApproxSettings()
    want = JRX.run_regexp(jixs[tier], jn, js)
    assert _full(TRX.run_regexp(ports[tier], tn, _tsettings(s))) == \
        _full(want)
    dev = TRD.run_regexp_device(ports[tier], tn, _tsettings(s))
    assert _ranges(dev) == _ranges(want)


@pytest.mark.parametrize("case", [0, 1, 3, 6, 8, 11, 12])
def test_run_regexp_device_matches_femto_device(rd, case):
    """Against femto_tpu's own device engine (one XLA program per NFA
    shape), with strings, on the full tier."""
    docs, jixs, ports = rd
    q, s = RD_CASES[case]
    jn, tn = _nfas(q)
    want = JRD.run_regexp_device(jixs["full"], jn, s or JRX.ApproxSettings(),
                                 with_strings=True)
    got = TRD.run_regexp_device(ports["full"], tn, _tsettings(s),
                                with_strings=True)
    assert _full(got) == _full(want)


def test_capacity_retry_and_long_repeats():
    """x{70}L outgrows max_len 64 and a frontier cap of 4 (retries, as
    femto_tpu's test_device_long_match_capacity_retry); a {1,64} repeat
    (80 states) and an approximate repeat against femto_tpu's host engine,
    with strings."""
    docs = [b"x" * 70 + b"L", b"filler doc", b"0001 01 00001 ab" * 3,
            b"abcdabcdab" * 5]
    prep = ft.prepare_documents(docs)
    jix = ft.build_index(prep, seg=64, mark_period=8)
    ix = tt.build_index(tt.prepare_documents(docs), seg=64, mark_period=8,
                        tier="vrle", device="cpu")
    for q, cap in (("x{70}L", 256), ("0{1,64}1", 4), ("APPROX 1 x{3}L", 4)):
        node = JP.parse_query(q)
        jn, tn = _nfas(q)
        want = JRX.run_regexp(jix, jn, node.approx)
        got = TRD.run_regexp_device(ix, tn, _tsettings(node.approx),
                                    frontier_cap=cap, with_strings=True)
        assert _full(got) == _full(want), q
        assert got, q
        if q == "x{70}L":  # longer than max_len 64
            assert TRD.last_stats["retries"] >= 1
    with pytest.raises(TRD.FrontierOverflow, match="maximum capacities"):
        TRD.run_regexp_device(ix, _nfas("x{70}L")[1], frontier_cap=4,
                              max_frontier_cap=4, results_cap=8,
                              max_results_cap=8, max_len=16, max_max_len=16)


@pytest.mark.parametrize("max_len", [1, 2])
@pytest.mark.parametrize("q", ["ban(ana|dana)", "APPROX 1 bandana"])
def test_frontier_layers_match_femto_loop(rd, q, max_len):
    """The results after one and two layers of the device frontier (fork,
    sort, merge) against femto_tpu's _frontier_loop stopped at max_len,
    on the pad_shape index (row0 > 0)."""
    docs, jixs, ports = rd
    ix = ports["pad"]
    node = JP.parse_query(q)
    jn, tn = _nfas(q)
    F, R = 64, 64
    src, dst, mask, accept, S, T = JRD._nfa_device_arrays(jn)
    c0 = np.full(S, JRX.NO_COST, np.int32)
    c0[: jn.num_states] = JRX._start_costs(jn, node.approx)
    a = node.approx
    cfg = JRD._Static(
        n=jixs["pad"].meta.n_rows, row0=jixs["pad"].meta.row0, S=S, T=T,
        F=F, R=R,
        max_len=max_len, cost_bound=a.cost_bound, subst=a.subst_cost,
        delete=a.delete_cost, insert=a.insert_cost,
        del_rounds=0 if a.cost_bound <= 1 else max(
            1, -(-a.cost_bound // max(a.delete_cost, 1))))
    rf, rl, rc, rlen, cnt, of = JRD._run_device(
        jixs["pad"].arrays, src, dst, mask, accept, jnp.asarray(c0), cfg)
    nd, lcfg, bufs = TRD._initial_state(ix, tn, _tsettings(a), F, R)
    assert nd.S == S and nd.T == T
    n_live = 1
    for depth in range(max_len):
        if n_live == 0:
            break
        n_live = TRD._layer(ix, nd, lcfg, depth, n_live, *bufs)
        assert n_live >= 0
    res, state = bufs[3].numpy(), bufs[4].numpy()
    for i, want in enumerate((rf, rl, rc, rlen)):
        assert np.array_equal(res[i], np.asarray(want)), i
    assert int(state[0]) == int(cnt)
    assert int(of) == int(bool(state[1]) or n_live > 0)


ENGINE_CASES = [
    ("count", "quick", {}), ("count", "ban(ana|dana)", {}),
    ("count", "ba+", {}), ("count", "b.x", {}), ("count", "[bl]a", {}),
    ("count", "ab[cd]ab", {}), ("count", "shee?p", {}),
    ("count", "a{2,3}", {}), ("count", "(abc){2}", {}),
    ("count", "[^a-z]", {}), ("count", ".*quick.*", {}), ("count", "a*", {}),
    ("count", "QUICK", {"icase": True}), ("count", "Shee?P", {"icase": True}),
    ("count", "APPROX 1 quick", {}), ("count", "black AND sheep", {}),
    ("docs", "ban(ana|dana)", {}), ("docs", "b.x", {}),
    ("docs", "black AND sheep", {}), ("docs", "black OR quick", {}),
    ("docs", "ba NOT sheep", {}), ("docs", "black THEN 6 sheep", {}),
    ("docs", "sheep WITHIN 6 black", {}), ("docs", "sheep THEN 2 black", {}),
    ("docs", "black THEN 6 sheep", {"with_offsets": False}),
    ("docs", "APPROX 1 quack", {}), ("docs", "QUICK OR Dog",
                                     {"icase": True}),
    ("docs", "a", {"max_matches": 2}),
    ("strings", "ban(ana|dana)a?", {}), ("strings", "APPROX 1 quack", {}),
    ("strings", "APPROX 1 quicck", {}), ("strings", "APPROX 1 quck", {}),
    ("strings", "APPROX 1:2:1:2 quicck", {}), ("strings", "ban(a|an)", {}),
    ("strings", "black", {}),
]


def _no_device(*args, **kwargs):
    raise RuntimeError("femto_tpu's host engine answers here")


@pytest.fixture
def femto_host_engine(monkeypatch):
    """femto_tpu's term_ranges / find_strings on its host engine, its own
    fallback: its device engine would compile a program per NFA shape."""
    monkeypatch.setattr(JRD, "run_regexp_device", _no_device)


def _engine_answer(M, ix, kind, q, kw):
    if kind == "count":
        return M.count_query(ix, q, **kw)
    if kind == "docs":
        return M.docs_query_ex(ix, q, **kw)
    return _full(M.find_strings(ix, q, **kw))


@pytest.mark.parametrize("tier", ["vrle", "pad"])
@pytest.mark.parametrize("case", range(len(ENGINE_CASES)))
def test_engine_matches_femto(qc, tier, case, femto_host_engine):
    """count_query / docs_query_ex (documents, offsets, truncation flag) /
    find_strings on test_query.py's cases."""
    docs, jixs, ports = qc
    kind, q, kw = ENGINE_CASES[case]
    want = _engine_answer(JE, jixs[tier], kind, q, kw)
    got = _engine_answer(TE, ports[tier], kind, q, kw)
    assert got == want


def test_execute_and_truncation_match_femto(qc, monkeypatch,
                                            femto_host_engine):
    """execute's Results, the opt-out cap and its warning, the windowed
    locate, as test_query.py's truncation and streaming cases."""
    docs, jixs, ports = qc
    ix, jix = ports["full"], jixs["full"]
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "BOOLEAN_TERM_CAP", 4)
    for q in ("a AND b", "black THEN 6 sheep", "ba NOT sheep"):
        for kw in ({}, {"term_cap": 4}, {"need_offsets": False}):
            j = JE.execute(jix, JP.parse_query(q), **kw)
            t = TE.execute(ix, TQ.parse_query(q), **kw)
            assert (t.type.name, t.count, t.docs.tolist(),
                    t.offsets.tolist(), t.truncated) == \
                (j.type.name, j.count, j.docs.tolist(), j.offsets.tolist(),
                 j.truncated)
    with pytest.warns(TE.TruncationWarning):
        got = TE.docs_query(ix, "a AND b", full_eval=False)
    with pytest.warns(JE.TruncationWarning):
        want = JE.docs_query(jix, "a AND b", full_eval=False)
    assert got == want
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert TE.docs_query_ex(ix, "a", max_matches=2) == \
            JE.docs_query_ex(jix, "a", max_matches=2)
    want = JE.docs_query(jix, "black THEN 6 sheep")
    for mod in (JE, TE):
        monkeypatch.setattr(mod, "LOCATE_WINDOW", 4)
    assert TE.docs_query(ix, "black THEN 6 sheep") == want
    assert TE.docs_query(ix, "a AND b") == JE.docs_query(jix, "a AND b")


def test_term_ranges_host_path_matches(qc):
    """device_frontier=False: the host engine answers term_ranges."""
    docs, jixs, ports = qc
    for q in ("ban(ana|dana)", "APPROX 1 quack", "quick", "x?"):
        jt, tt_ = JP.parse_query(q), TQ.parse_query(q)
        assert TE.term_ranges(ports["full"], tt_, device_frontier=False) \
            == JE.term_ranges(jixs["full"], jt, device_frontier=False)


def _raises(error):
    def fn(*args, **kwargs):
        raise error
    return fn


@pytest.mark.parametrize("entry", ["count", "strings"])
@pytest.mark.parametrize("error", [
    RuntimeError("CUDA kernel regex_fork[full] failed: cudaError_t 1"),
    RuntimeError("nvcc failed for regex_frontier.cu"),
    torch.cuda.OutOfMemoryError("CUDA out of memory"),
], ids=["launch", "build", "oom"])
def test_kernel_errors_reach_the_caller(qc, monkeypatch, error, entry):
    """A frontier kernel that fails to build or launch, or memory that
    runs out, raises from count_query / find_strings: only
    FrontierOverflow hands a term to the host engine."""
    ix = qc[2]["full"]
    monkeypatch.setattr(TRO, "regex_fork", _raises(error))
    with pytest.raises(type(error), match=re.escape(str(error))):
        if entry == "count":
            TE.count_query(ix, "ban(ana|dana)")
        else:
            TE.find_strings(ix, "APPROX 1 quack")


@pytest.mark.parametrize("q", ["ban(ana|dana)", "APPROX 1 quack"])
def test_overflow_past_the_caps_takes_the_host_engine(qc, monkeypatch, q):
    """Every run overflowing: the capacities grow to their maxima, then
    FrontierOverflow, and term_ranges / find_strings answer through the
    host engine with the device frontier's answers."""
    ix = qc[2]["full"]
    want = (TE.count_query(ix, q), _full(TE.find_strings(ix, q)))
    host = []
    monkeypatch.setattr(TRD, "_run_regexp_device_once", _raises(
        TRD._DeviceCapacityOverflow("device regex frontier overflow")))
    monkeypatch.setattr(TE, "run_regexp",
                        lambda *a, **k: host.append(1) or TRX.run_regexp(
                            *a, **k))
    with pytest.raises(TRD.FrontierOverflow):
        TRD.run_regexp_device(ix, _nfas(q)[1])
    assert (TE.count_query(ix, q), _full(TE.find_strings(ix, q))) == want
    assert len(host) == 2


@pytest.mark.parametrize("seed", range(6))
def test_regex_fuzz_matches_femto(seed, femto_host_engine):
    """test_regex_fuzz.py's seeded regexes: count_query and docs_query
    against Python re, as there, and on seeds 0 and 2 against femto_tpu's
    engine too (femto_tpu's test holds it to Python re on every seed)."""
    rng = np.random.default_rng(1000 + seed)
    docs = [
        bytes(rng.choice(list(b"abcd"), size=int(rng.integers(5, 120)))
              .astype(np.uint8))
        for _ in range(6)
    ]
    ix = tt.build_index(tt.prepare_documents(docs), seg=64, mark_period=8,
                        device="cpu")
    jix = (ft.build_index(ft.prepare_documents(docs), seg=64, mark_period=8)
           if seed in (0, 2) else None)
    for _ in range(12):
        fq, pq = gen_regex(rng)
        empty_ok = re.compile(pq.encode()).match(b"") is not None
        want = py_count(docs, pq) + (len(docs) if empty_ok else 0)
        got = TE.count_query(ix, fq)
        assert got == want, (fq, pq)
        wantd = list(range(len(docs))) if empty_ok else py_docs(docs, pq)
        gotd = TE.docs_query(ix, fq, with_offsets=False)
        assert [d for d, _, _ in gotd] == wantd, (fq, pq)
        if jix is not None:
            assert got == JE.count_query(jix, fq), (fq, pq)
            assert gotd == JE.docs_query(jix, fq, with_offsets=False)
