"""The port's sharded build and queries (femto_tpu_torch.parallel) against
femto_tpu's (femto_tpu.parallel) on the 8-virtual-device CPU mesh.

The port's LocalMesh(8) on the CPU runs every per-shard step's plain
PyTorch version; femto_tpu runs its shard_map bodies on the conftest's 8
virtual devices.  The same seeded inputs go through both, and everything
that leaves a module must agree exactly (no tolerance): delivered records
(as sets per destination: the Valiant routes differ by design), sorted
blocks, SA / BWT / a_row and LAST_BUILD_STATS, every FMArrays block of the
full, compact and packed tiers, the cross-shard prefix of the checkpoints
(kernel K18b's plain versions, also against numpy at edge shapes), and
count and locate answers of both schemes.  femto_tpu's sharded indexes
are built once per module.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.alphabet import pattern_to_alpha
from femto_tpu.parallel import bins as jbins
from femto_tpu.parallel import dist_build as jdb
from femto_tpu.parallel.dist_query import (
    sharded_backward_search as j_search, sharded_locate as j_locate)
from femto_tpu.parallel.dist_sort import dist_sort as j_dist_sort
from femto_tpu.parallel.mesh import DEFAULT_AXIS, make_mesh
from femto_tpu.search import pack_patterns
from femto_tpu_torch.alphabet import ALPHA_SIZE
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel import bins as tbins
from femto_tpu_torch.parallel import dist_build as tdb
from femto_tpu_torch.parallel import dist_query as tdq
from femto_tpu_torch.parallel.dist_sort import local_sort as t_local_sort
from femto_tpu_torch.parallel.dist_sort import dist_sort as t_dist_sort
from femto_tpu_torch.parallel.distributed import put_global
from tests.oracle import naive_count, naive_locate
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 8
AX = DEFAULT_AXIS
TIERS = ("full", "compact", "packed")


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(D)


@pytest.fixture(scope="module")
def tmesh():
    return LocalMesh(D, device="cpu")


def _smap(fn, mesh, n_in, n_out_sharded, n_out_rep=0, rep_in=()):
    ins = tuple(P() if i in rep_in else P(AX) for i in range(n_in))
    outs = tuple([P(AX)] * n_out_sharded + [P()] * n_out_rep)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=ins,
                                 out_specs=outs))


def _blocks(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.reshape(D, -1)))


def _per_dest(rv, valid):
    rv, valid = np.asarray(rv).reshape(D, -1), np.asarray(valid).reshape(
        D, -1).astype(bool)
    return [sorted(rv[d][valid[d]].tolist()) for d in range(D)]


@pytest.mark.parametrize("scheme", ["exchange", "valiant"])
def test_exchange_delivers_like_femto_tpu(jmesh, tmesh, scheme):
    rng = np.random.default_rng(7)
    m = 256
    vals = rng.integers(0, 1000, size=D * m).astype(np.int32)
    if scheme == "exchange":
        dest = rng.integers(0, D, size=D * m).astype(np.int32)
        cap = m
    else:
        # every record of source s to (s + 1) % D: the pair-concentrated
        # case a single hop could only carry at cap = m
        dest = ((np.arange(D * m) // m + 1) % D).astype(np.int32)
        cap = 2 * m // D + 64

    def f(v, d, key):
        if scheme == "exchange":
            recs, valid, of = jbins.exchange(d, [v], cap=cap, axis=AX)
        else:
            recs, valid, of = jbins.valiant_exchange(d, [v], cap=cap,
                                                     axis=AX, key=key)
        return recs[0], valid, of

    jr, jv, jof = _smap(f, jmesh, 3, 2, 1, rep_in=(2,))(
        jnp.asarray(vals), jnp.asarray(dest), jax.random.PRNGKey(1))
    if scheme == "exchange":
        (tr,), tv, tof = tbins.exchange(tmesh, _blocks(dest), [_blocks(vals)],
                                        cap)
    else:
        (tr,), tv, tof = tbins.valiant_exchange(
            tmesh, _blocks(dest), [_blocks(vals)], cap, key=1)
    assert int(jof) <= 0 and int(tof) <= 0
    want = [sorted(vals[dest == d].tolist()) for d in range(D)]
    assert _per_dest(tr.numpy(), tv.numpy()) == _per_dest(jr, jv) == want
    if scheme == "exchange":
        # one hop: the overflow scalar is the same as femto_tpu's
        assert int(tof) == int(jof)


def test_place_by_owner_like_femto_tpu(jmesh, tmesh):
    """Records routed to the owners of their positions and placed into
    dense blocks over the fills: the same global array as femto_tpu's."""
    rng = np.random.default_rng(9)
    m = 128
    gpos = rng.permutation(D * m).astype(np.int32)
    vals = rng.integers(-1000, 1000, size=D * m).astype(np.int32)
    valid = (rng.random(D * m) < 0.9)

    def f(g, v, ok):
        fill = jnp.full((m,), -7, jnp.int32)
        (out,), of = jbins.place_by_owner(g, [v], m, 2 * m // D + 64, AX,
                                          [fill], valid=ok)
        return out, of

    jout, jof = _smap(f, jmesh, 3, 1, 1)(jnp.asarray(gpos),
                                        jnp.asarray(vals),
                                        jnp.asarray(valid))
    fills = [torch.full((D, m), -7, dtype=torch.int32)]
    (tout,), tof = tbins.place_by_owner(
        tmesh, _blocks(gpos), [_blocks(vals)], m, 2 * m // D + 64, fills,
        valid=_blocks(valid.astype(np.uint8)))
    assert int(jof) <= 0 and int(tof) <= 0
    np.testing.assert_array_equal(tout.reshape(-1).numpy(), np.asarray(jout))


def test_exchange_overflow_reported(tmesh):
    """A bucket past cap is reported (never dropped in silence)."""
    m = 64
    dest = np.zeros(D * m, np.int32)
    vals = np.arange(D * m, dtype=np.int32)
    _, _, of = tbins.exchange(tmesh, _blocks(dest), [_blocks(vals)], 16)
    assert int(of) == m - 16


def _edge(edge, rng):
    """One edge of the exchange: (dest int32[D * m], valid bool[D * m] or
    None, cap of the one-hop exchange, cap of the Valiant one) on D shards
    of m records."""
    m = 0 if edge == "empty" else 32
    src = np.arange(D * m) // max(m, 1)
    dest = rng.integers(0, D, size=D * m).astype(np.int32)
    valid = None
    cap, vcap = m, 2 * m
    if edge == "dropped":
        valid = np.zeros(D * m, bool)
        cap = vcap = 8
    elif edge in ("at_cap", "past_cap"):
        # records 0..15 (or 0..16) of each shard for shard s + 3, the rest
        # spread over the others (at most 3 each): one bucket at (or one
        # past) a cap of 16
        k = np.arange(D * m) % m
        first = 16 if edge == "at_cap" else 17
        dest = np.where(k < first, (src + 3) % D,
                        (src + 4 + k % (D - 1)) % D).astype(np.int32)
        cap = 16
        if edge == "past_cap":
            # two hops: every record of every shard for shard 0 at a cap
            # of m / 4 (a pair carries m of them on average)
            vcap = m // 4
    elif edge == "empty":
        cap = vcap = 8
    elif edge == "one_dest":
        dest[:] = 5
    elif edge == "valid":
        valid = rng.random(D * m) < 0.7
        valid[2 * m: 3 * m] = False  # shard 2 sends nothing
    return dest, valid, cap, vcap


@pytest.mark.parametrize("scheme", ["exchange", "valiant"])
@pytest.mark.parametrize("edge", ["dropped", "at_cap", "past_cap", "empty",
                                  "one_dest", "valid"])
def test_exchange_edges_like_femto_tpu(jmesh, tmesh, scheme, edge):
    """bins.exchange and bins.valiant_exchange against femto_tpu's at the
    exchange's edges: every record dropped, one bucket at and one past
    cap, empty shards (m = 0), every record to one shard, valid flags with
    lanes off (and a shard with none on).  One hop: the received records,
    flags and overflow slot for slot.  Two hops (the routes differ by
    design): the records each shard receives as sets and their count, and
    the overflow exactly where no record is sent, else its sign."""
    rng = np.random.default_rng(11)
    dest, valid, cap, vcap = _edge(edge, rng)
    if scheme == "valiant" and edge == "past_cap":
        dest = np.zeros_like(dest)
    n = dest.shape[0]
    vals = rng.integers(-1000, 1000, size=n).astype(np.int32)
    ok = np.ones(n, bool) if valid is None else valid
    c = cap if scheme == "exchange" else vcap

    def f(v, d, okj, key):
        if scheme == "exchange":
            recs, rv, of = jbins.exchange(d, [v], cap=c, axis=AX, valid=okj)
        else:
            recs, rv, of = jbins.valiant_exchange(d, [v], cap=c, axis=AX,
                                                  key=key, valid=okj)
        return recs[0], rv, of

    jr, jv, jof = _smap(f, jmesh, 4, 2, 1, rep_in=(3,))(
        jnp.asarray(vals), jnp.asarray(dest), jnp.asarray(ok),
        jax.random.PRNGKey(1))
    tvalid = None if valid is None else _blocks(valid.astype(np.uint8))
    if scheme == "exchange":
        (tr,), tv, tof = tbins.exchange(tmesh, _blocks(dest), [_blocks(vals)],
                                        c, valid=tvalid)
        np.testing.assert_array_equal(tr.reshape(-1).numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tv.reshape(-1).numpy(),
                                      np.asarray(jv).astype(np.uint8))
        assert int(tof) == int(jof)
        return
    (tr,), tv, tof = tbins.valiant_exchange(
        tmesh, _blocks(dest), [_blocks(vals)], c, key=1, valid=tvalid)
    if not ok.any():
        assert int(tof) == int(jof) == -c
    else:
        assert (int(tof) > 0) == (int(jof) > 0)
    if int(tof) <= 0 and int(jof) <= 0:
        want = [sorted(vals[ok & (dest == d)].tolist()) for d in range(D)]
        assert _per_dest(tr.numpy(), tv.numpy()) == _per_dest(jr, jv) == want
        assert int(tv.sum()) == int(np.asarray(jv).sum()) == int(ok.sum())
    else:
        # both dropped records: each delivered no more than it was sent
        assert int(tv.sum()) < int(ok.sum())
        assert int(np.asarray(jv).sum()) < int(ok.sum())


@pytest.mark.parametrize("D_,mm,cap,ncols", [
    (1, 0, 4, 1), (3, 1, 2, 2), (4, 100, 8, 3), (7, 257, 40, 8),
    (127, 300, 3, 1)])
def test_bucket_pack_plain_valid_is_dest_d(D_, mm, cap, ncols):
    """bucket_pack_plain with valid flags equals the same call with dest
    set to D (dropped) where the flag is 0, on every output."""
    rng = np.random.default_rng(D_ + mm)
    Dl = 3
    dest = torch.from_numpy(rng.integers(-2, D_ + 2, size=(Dl, mm)).astype(
        np.int32))
    valid = torch.from_numpy((rng.random((Dl, mm)) < 0.6).astype(np.uint8))
    cols = [torch.from_numpy(rng.integers(-99, 99, size=(Dl, mm)).astype(
        np.int32)) for _ in range(ncols)]
    got = DO.bucket_pack_plain(dest, cols, D=D_, cap=cap, valid=valid)
    want = DO.bucket_pack_plain(
        torch.where(valid.bool(), dest, D_), cols, D=D_, cap=cap)
    for g, w in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    # the wrapper takes the plain version for CPU tensors
    wrapped = DO.bucket_pack(dest, cols, D=D_, cap=cap, valid=valid)
    for g, w in zip(wrapped[0] + list(wrapped[1:]), got[0] + list(got[1:])):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("case", ["ties", "sorted"])
def test_dist_sort_blocks(jmesh, tmesh, case):
    rng = np.random.default_rng(3)
    m = 128
    if case == "ties":
        k1 = rng.integers(0, 50, size=D * m).astype(np.int32)
    else:
        k1 = np.arange(D * m, dtype=np.int32)
    idx = np.arange(D * m, dtype=np.int32)
    pay = rng.integers(-5, 5, size=D * m).astype(np.int32)

    def f(a, b, c):
        (s1, s2), (p1,), of = j_dist_sort((a, b), (c,), AX, cap=m)
        return s1, s2, p1, of

    js1, js2, jp, jof = _smap(f, jmesh, 3, 3, 1)(
        jnp.asarray(k1), jnp.asarray(idx), jnp.asarray(pay))
    (ts1, ts2), (tp,), tof = t_dist_sort(
        tmesh, [_blocks(k1), _blocks(idx)], [_blocks(pay)], m, key=5)
    assert int(jof) <= 0 and int(tof) <= 0
    order = np.lexsort((idx, k1))
    for got, ref, want in ((ts1, js1, k1[order]), (ts2, js2, idx[order]),
                           (tp, jp, pay[order])):
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.asarray(ref))
        np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


@pytest.mark.parametrize("npay", [0, 1, 9])
def test_local_sort_like_lax_sort(npay):
    """local_sort's gathers (kernel L's gather_cols, up to 8 columns a
    launch: 2 keys and 9 payload columns take two) against femto_tpu's
    local sort, jax.lax.sort per shard with the keys first."""
    rng = np.random.default_rng(40 + npay)
    Dl, L = 3, 257
    k1 = rng.integers(0, 9, size=(Dl, L)).astype(np.int32)
    k2 = np.tile(np.arange(L, dtype=np.int32), (Dl, 1))
    pay = [rng.integers(-2**31, 2**31 - 1, size=(Dl, L)).astype(np.int32)
           for _ in range(npay)]
    got = t_local_sort([torch.from_numpy(k1), torch.from_numpy(k2)],
                         [torch.from_numpy(p) for p in pay])
    assert len(got) == 2 + npay
    for j in range(Dl):
        want = jax.lax.sort(tuple(jnp.asarray(c[j]) for c in [k1, k2] + pay),
                            num_keys=2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[j].numpy(), np.asarray(w))


def test_dist_sort_many_payload_columns(jmesh, tmesh):
    """dist_sort with 2 keys and 4 payload columns (6 columns, the most
    the rebalance takes: one gather_cols launch of 6 a local sort)
    against femto_tpu's."""
    rng = np.random.default_rng(41)
    m = 96
    k1 = rng.integers(0, 20, size=D * m).astype(np.int32)
    idx = np.arange(D * m, dtype=np.int32)
    pays = [rng.integers(-9, 9, size=D * m).astype(np.int32)
            for _ in range(4)]

    def f(a, b, *cs):
        (s1, s2), ps, of = j_dist_sort((a, b), tuple(cs), AX, cap=m)
        return (s1, s2, *ps, of)

    jout = _smap(f, jmesh, 6, 6, 1)(
        jnp.asarray(k1), jnp.asarray(idx), *[jnp.asarray(p) for p in pays])
    (ts1, ts2), tps, tof = t_dist_sort(
        tmesh, [_blocks(k1), _blocks(idx)], [_blocks(p) for p in pays], m)
    assert int(jout[-1]) <= 0 and int(tof) <= 0
    order = np.lexsort((idx, k1))
    for got, ref, want in zip([ts1, ts2, *tps], jout[:-1],
                              [k1[order], idx[order]]
                              + [p[order] for p in pays]):
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.asarray(ref))
        np.testing.assert_array_equal(got.reshape(-1).numpy(), want)


# dist_sort's rebalance at crafted received counts v (the exchange handed
# each shard v[d] records of REB_M-record blocks, base v's exclusive
# prefix): uneven blocks; two empty shards with places left unfilled
# (sum v < D * m); a far owner (shard 0's records reach shard 4, more
# than W = 3 shards away).
REB_M = 16
REBALANCE_CASES = {
    "uneven": [10, 25, 16, 5, 30, 12, 20, 10],
    "empty_shard": [20, 0, 30, 16, 16, 0, 30, 10],
    "far_owner": [80, 8, 8, 8, 8, 8, 8, 0],
}


def _crafted_received(v):
    """Each shard's received records, D * REB_M slots of which the first
    v[d] are valid: keys (k1, unique id) and one payload column."""
    rng = np.random.default_rng(sum(v) + len(set(v)))
    S = D * REB_M
    k1 = rng.integers(0, 40, size=(D, S)).astype(np.int32)
    ids = rng.permutation(D * S).astype(np.int32).reshape(D, S)
    pay = rng.integers(-9, 9, size=(D, S)).astype(np.int32)
    valid = np.arange(S)[None, :] < np.asarray(v)[:, None]
    return [k1, ids, pay], valid


@pytest.fixture(scope="module")
def femto_rebalance(jmesh):
    """femto_tpu's dist_sort on a D x REB_M corpus whose exchange returns
    the crafted records (given as inputs, so one compile serves every
    case): the sorted keys, payload and overflow."""
    # the module (femto_tpu.parallel's dist_sort attribute is the function)
    jds = importlib.import_module("femto_tpu.parallel.dist_sort")
    held = {}
    orig = jds.exchange

    def crafted(dest, cols, cap, axis):
        return held["cols"], held["valid"], jnp.int32(0)

    def f(a, b, c, r1, r2, r3, rv):
        held["cols"], held["valid"] = [r1, r2, r3], rv
        (s1, s2), (p1,), of = j_dist_sort((a, b), (c,), AX, cap=REB_M)
        return s1, s2, p1, of

    jds.exchange = crafted
    try:
        fn = _smap(f, jmesh, 7, 3, 1)
        k = np.arange(D * REB_M, dtype=np.int32)
        out = {}
        for case, v in REBALANCE_CASES.items():
            cols, valid = _crafted_received(v)
            out[case] = [np.asarray(x) for x in fn(
                jnp.asarray(k), jnp.asarray(k), jnp.asarray(k),
                *[jnp.asarray(c.reshape(-1)) for c in cols],
                jnp.asarray(valid.reshape(-1)))]
    finally:
        jds.exchange = orig
    return out


def _slices_rebalance(cols, v, base, m, W):
    """dist_sort's rebalance as D one-shard processes (a DistMesh, Dl 1)
    would run it: each process's local placement, then each offset's
    buffers sent to shard (p + off) mod D and merged by a where."""
    outs, far = [], []
    one = [([c[p:p + 1] for c in cols], v[p:p + 1], base[p:p + 1])
           for p in range(D)]
    for p, (c, vp, bp) in enumerate(one):
        o, f = DO.rebalance_local(c, vp, bp, m=m, W=W, shard0=p)
        outs.append(o)
        far.append(int(f[0]))
    for off in range(-W, W + 1):
        if off == 0:
            continue
        sent = [DO.rebalance_place(c, vp, bp, m=m, off=off, shard0=p)
                for p, (c, vp, bp) in enumerate(one)]
        for p in range(D):
            bufs, vbuf = sent[(p - off) % D]
            got = vbuf.bool()
            outs[p] = [torch.where(got, b, o) for b, o in zip(bufs, outs[p])]
    return [torch.cat([o[c] for o in outs]) for c in range(len(cols))], \
        max(far)


@pytest.mark.parametrize("mesh_view", ["local", "slices"])
@pytest.mark.parametrize("case", list(REBALANCE_CASES))
def test_rebalance_like_dist_sort(femto_rebalance, tmesh, monkeypatch, case,
                                  mesh_view):
    """The port's dist_sort at crafted received counts equals femto_tpu's
    (keys, payload, overflow), its rebalance by rebalance_local alone on
    the LocalMesh (one call a sort, no offset buffers); "slices" runs the
    same rebalance inputs as D DistMesh processes would (Dl 1, each
    shard0), through rebalance_local and the per-offset
    rebalance_place."""
    v = REBALANCE_CASES[case]
    cols, valid = _crafted_received(v)
    calls = {"rebalance_local": [], "rebalance_place": []}

    def exchange(mesh, dest, records, cap, valid_in=None):
        return ([torch.from_numpy(c) for c in cols],
                torch.from_numpy(valid.astype(np.uint8)),
                torch.zeros((), dtype=torch.int32))

    for name in calls:
        def spy(*a, _f=getattr(DO, name), _n=name, **kw):
            calls[_n].append((a, kw))
            return _f(*a, **kw)
        monkeypatch.setattr(DO, name, spy)
    monkeypatch.setattr(tbins, "exchange", exchange)
    k = torch.arange(D * REB_M, dtype=torch.int32).reshape(D, REB_M)
    (ts1, ts2), (tp,), tof = t_dist_sort(tmesh, [k, k.clone()], [k.clone()],
                                         REB_M)
    monkeypatch.undo()
    js1, js2, jp, jof = femto_rebalance[case]
    assert len(calls["rebalance_local"]) == 1 and not calls["rebalance_place"]
    assert int(tof) == int(jof) == int(case == "far_owner")
    got = [ts1, ts2, tp]
    if mesh_view == "slices":
        (rcols, rv, rbase), kw = calls["rebalance_local"][0]
        got, far = _slices_rebalance(rcols, rv, rbase, REB_M, kw["W"])
        assert far == int(jof)
    for g, want in zip(got, (js1, js2, jp)):
        np.testing.assert_array_equal(g.reshape(-1).numpy(), want)


# kernel K18b's prefix and add at edge shapes: (A, rows) with rows * A not
# always a multiple of 4, on the meshes (Dl, shard0) of a D-shard mesh
K18B_SHAPES = [(A, rows) for A in (1, 3, 256, 1024) for rows in (0, 1, 5)] \
    + [(1, 1 << 18), (3, 1 << 18)]
K18B_MESHES = ((1, 0), (1, 3), (4, 0), (4, 3))


def _wrap32(a):
    """int64 values as the int32 they wrap to."""
    return (np.asarray(a, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def _np_prefix(g, shard0, Dl, op):
    """numpy's (base int32[Dl, A], C int32[A + 1]) of gathered rows g."""
    g = g.astype(np.int64)
    base = np.zeros((Dl, g.shape[1]), np.int64)
    for d in range(Dl):
        if shard0 + d:
            before = g[: shard0 + d]
            base[d] = before.sum(0) if op == "sum" else \
                np.maximum(before.max(0), 0)
    return _wrap32(base), _wrap32(np.concatenate([[0], np.cumsum(g.sum(0))]))


@pytest.mark.parametrize("A,rows", K18B_SHAPES)
def test_k18b_prefix_and_add_like_numpy(A, rows):
    """mesh_exclusive (sum and max: negative rows give a base of 0),
    add_base and add_mesh_base on the CPU against numpy, int32 wrap
    included (the rows are drawn over all of int32, so sums wrap)."""
    rng = np.random.default_rng(A * 31 + rows)
    for Dl, shard0 in K18B_MESHES:
        g = rng.integers(-2**31, 2**31, size=(D, A)).astype(np.int32)
        x0 = rng.integers(-2**31, 2**31, size=(Dl, rows, A)).astype(np.int32)
        for op in ("sum", "max"):
            for want_c in (False, True):
                base, C = DO.mesh_exclusive(torch.from_numpy(g),
                                            shard0=shard0, Dl=Dl, op=op,
                                            want_c=want_c)
                wb, wc = _np_prefix(g, shard0, Dl, op)
                np.testing.assert_array_equal(base.numpy(), wb)
                assert (C is None) != want_c
                if want_c:
                    np.testing.assert_array_equal(C.numpy(), wc)
        wb, wc = _np_prefix(g, shard0, Dl, "sum")
        want_x = _wrap32(x0.astype(np.int64) + wb[:, None, :].astype(
            np.int64))
        x = torch.from_numpy(x0.copy())
        DO.add_base(x, torch.from_numpy(wb))
        np.testing.assert_array_equal(x.numpy(), want_x)
        for want_base in (False, True):
            for want_c in (False, True):
                x = torch.from_numpy(x0.copy())
                base, C = DO.add_mesh_base(x, torch.from_numpy(g),
                                           shard0=shard0,
                                           want_base=want_base,
                                           want_c=want_c)
                np.testing.assert_array_equal(x.numpy(), want_x)
                assert (base is None) != want_base
                assert (C is None) != want_c
                if want_base:
                    np.testing.assert_array_equal(base.numpy(), wb)
                if want_c:
                    np.testing.assert_array_equal(C.numpy(), wc)


def _shard_layouts():
    """(Dl, shard0) of the D-shard mesh's two kinds: a LocalMesh (every
    shard in one process) and each process of a DistMesh (one shard)."""
    return [(D, 0)] + [(1, r) for r in range(D)]


@pytest.mark.parametrize("dense", [False, True])
def test_add_mesh_base_like_shard_occ_base(jmesh, dense):
    """The fused prefix and add on a shard's relative checkpoints gives
    femto_tpu's _shard_occ_base: occ_abs and C, on the full alphabet and
    on the used columns (the compact tiers' dense rows)."""
    rng = np.random.default_rng(13)
    seg, nseg_local = 32, 6
    m = seg * nseg_local
    bwt = rng.integers(0, 40, size=D * m).astype(np.int32)
    bwt[rng.random(D * m) < 0.05] = ALPHA_SIZE - 1
    used = np.unique(bwt).astype(np.int32)

    def f(b):
        return jdb._shard_occ_base(b, jnp.asarray(used), seg=seg,
                                   dense=dense, axis=AX)

    _, jocc, jC = _smap(f, jmesh, 1, 2, 1)(jnp.asarray(bwt))
    cols = used if dense else np.arange(ALPHA_SIZE)
    A = len(cols)
    per = (bwt.reshape(D, nseg_local, seg)[..., None] == cols).sum(2)
    local = (np.cumsum(per, axis=1) - per).astype(np.int32)
    gathered = torch.from_numpy(per.sum(1).astype(np.int32))
    jocc = np.asarray(jocc).reshape(D, nseg_local, A)
    for Dl, shard0 in _shard_layouts():
        x = torch.from_numpy(local[shard0: shard0 + Dl].copy())
        base, C = DO.add_mesh_base(x, gathered, shard0=shard0, want_c=True)
        assert base is None
        np.testing.assert_array_equal(x.numpy(),
                                      jocc[shard0: shard0 + Dl])
        np.testing.assert_array_equal(C.numpy(), np.asarray(jC))


def test_add_mesh_base_like_exclusive_base(jmesh):
    """The mark site: the fused entry's base of one value a shard (A = 1)
    is femto_tpu's _exclusive_base, int32 wrap included, and the add puts
    it on every mark checkpoint of the shard."""
    rng = np.random.default_rng(17)
    v = rng.integers(-2**31, 2**31, size=D).astype(np.int32)

    def f(vb):
        return (jdb._exclusive_base(vb[0], AX)[None],)

    (jbase,) = _smap(f, jmesh, 1, 1)(jnp.asarray(v))
    jbase = np.asarray(jbase)
    ckpt = rng.integers(0, 1000, size=(D, 5, 1)).astype(np.int32)
    for Dl, shard0 in _shard_layouts():
        x = torch.from_numpy(ckpt[shard0: shard0 + Dl].copy())
        base, C = DO.add_mesh_base(x, torch.from_numpy(v).view(D, 1),
                                   shard0=shard0, want_base=True)
        assert C is None
        want = jbase[shard0: shard0 + Dl]
        np.testing.assert_array_equal(base.view(-1).numpy(), want)
        np.testing.assert_array_equal(
            x.numpy(), _wrap32(ckpt[shard0: shard0 + Dl].astype(np.int64)
                               + want[:, None, None]))


@pytest.mark.parametrize("entry,on_meta", [
    ("add_mesh_base", "x"), ("add_mesh_base", "gathered"),
    ("add_base", "x"), ("add_base", "base")])
def test_k18b_wrappers_refuse_mixed_devices(entry, on_meta):
    """A CPU tensor beside one on another device raises: the wrappers take
    the plain version for CPU tensors only."""
    x = torch.zeros((1, 2, 3), dtype=torch.int32,
                    device="meta" if on_meta == "x" else "cpu")
    other = torch.zeros((1, 3), dtype=torch.int32,
                        device="cpu" if on_meta == "x" else "meta")
    with pytest.raises(ValueError, match="devices"):
        if entry == "add_mesh_base":
            DO.add_mesh_base(x, other, shard0=0, want_c=True)
        else:
            DO.add_base(x, other)


def _five_docs():
    rng = np.random.default_rng(42)
    return [
        b"the quick brown fox jumps over the lazy dog",
        b"banana banana banana",
        b"",
        bytes(rng.integers(0, 256, size=500).astype(np.uint8)),
        b"abracadabra" * 10,
    ]


def _sa_case(case):
    """(text, doc_starts or None, mark_period) of each suffix-sort case."""
    if case == "docs":
        # the five documents with doc starts and marks: six extension
        # rounds, then the replicated doubling tail
        prep = ft.prepare_documents(_five_docs())
        return np.asarray(prep.text, np.int32), prep.doc_starts, 8
    # a single repeated symbol: the full distributed doubling path
    return np.full(3000, 5, np.int32), None, 0


@pytest.mark.parametrize("case", ["docs", "doubling"])
def test_dist_suffix_array_like_femto_tpu(jmesh, tmesh, case):
    text, ds, mp = _sa_case(case)
    n = len(text)
    text_pad, n_pad = jdb.pad_text_for_mesh(text, D, seg=32)
    kw = dict(n=n, mark_period=mp)
    jds = tds = None
    if ds is not None:
        jds = jax.device_put(jnp.asarray(ds.astype(np.int32)),
                             NamedSharding(jmesh, P()))
        tds = torch.from_numpy(ds.astype(np.int32))
    jsa, jbwt, jaux, jof = jdb.dist_suffix_array(
        jax.device_put(jnp.asarray(text_pad),
                       NamedSharding(jmesh, P(AX))),
        jmesh, doc_starts=jds, **kw)
    jstats = dict(jdb.LAST_BUILD_STATS)
    tsa, tbwt, taux, tof = tdb.dist_suffix_array(
        put_global(text_pad, tmesh), tmesh, doc_starts=tds, **kw)
    assert int(jof) <= 0 and int(tof) <= 0
    for got, want in ((tsa, jsa), (tbwt, jbwt), (taux, jaux)):
        np.testing.assert_array_equal(got.reshape(-1).numpy(),
                                      np.asarray(want))
    assert tdb.LAST_BUILD_STATS == jstats
    if case == "docs":
        assert jstats["path"] == "wide" and jstats["tail_rounds"] > 0
    else:
        assert jstats["path"] == "doubling" and jstats["dbl_rounds"] > 0


@pytest.fixture(scope="module")
def built(jmesh, tmesh):
    """femto_tpu's and the port's sharded index of the five documents, per
    tier (seg 32, mark_period 8)."""
    docs = _five_docs()
    jprep = ft.prepare_documents(docs)
    tprep = tt.prepare_documents(docs)
    out = {}
    for tier in TIERS:
        jix = jdb.build_index_sharded(jprep, jmesh, seg=32, mark_period=8,
                                      tier=tier)
        jstats = dict(jdb.LAST_BUILD_STATS)
        tix = tdb.build_index_sharded(tprep, tmesh, seg=32, mark_period=8,
                                      tier=tier)
        out[tier] = (jix, tix, jstats, dict(tdb.LAST_BUILD_STATS))
    return docs, out


@pytest.mark.parametrize("tier", TIERS)
def test_build_index_sharded_blocks(built, tier):
    _, out = built
    jix, tix, jstats, tstats = out[tier]
    assert tstats == jstats
    assert dict(tix.meta.__dict__) == {k: getattr(jix.meta, k)
                                       for k in tix.meta.__dict__}
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


PATS = [b"banana", b"the", b"abra", b"zz", b"a", b"\x00", b"", b"qu"]


def _packed(pats):
    return pack_patterns([pattern_to_alpha(p) for p in pats])


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("tier", TIERS)
def test_sharded_count_like_femto_tpu(built, jmesh, tmesh, tier, routed):
    docs, out = built
    jix, tix, _, _ = out[tier]
    packed, B = _packed(PATS)
    jf, jl = j_search(jix, jmesh, packed, routed=routed)
    tf, tl = tdq.sharded_backward_search(tix, tmesh, packed, routed=routed)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf)[:B])
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl)[:B])
    for p, c in zip(PATS, (tl - tf).tolist()):
        assert c == (naive_count(docs, p) if p else tix.meta.n), (p, c)


@pytest.mark.parametrize("routed", [True, False])
@pytest.mark.parametrize("tier", TIERS)
def test_sharded_locate_like_femto_tpu(built, jmesh, tmesh, tier, routed):
    """Offsets equal femto_tpu's routed walk (its psum walk gives the same
    offsets, tests/test_dist.py) and the text's."""
    docs, out = built
    jix, tix, _, _ = out[tier]
    packed, _ = _packed([b"a"])
    tf, tl = tdq.sharded_backward_search(tix, tmesh, packed)
    f, l = int(tf[0]), int(tl[0])
    rows = np.arange(f, l, dtype=np.int32)
    rows = np.concatenate([rows, np.full((-len(rows)) % D, f, np.int32)])
    got = tdq.sharded_locate(tix, tmesh, rows, routed=routed).numpy()
    if routed:
        want = np.asarray(j_locate(jix, jmesh, rows))
        np.testing.assert_array_equal(got, want[:len(rows)])
    else:
        np.testing.assert_array_equal(
            got, tdq.sharded_locate(tix, tmesh, rows).numpy())
    doc, off = tt.offsets_to_docs(tix, got[: l - f].astype(np.int64))
    assert sorted(zip(doc.tolist(), off.tolist())) == naive_locate(docs,
                                                                   b"a")


def test_routed_hot_row_skew(built, tmesh):
    """64 lanes on one row at cap_factor 1.0: the routed exchange
    overflows, retries with a larger capacity and stays exact."""
    docs, out = built
    _, tix, _, _ = out["full"]
    packed, B = _packed([b"banana"] * 64)
    f, l = tdq.sharded_backward_search(tix, tmesh, packed, cap_factor=1.0)
    assert ((l - f)[:B] == naive_count(docs, b"banana")).all()


def test_extract_and_empty_pattern_on_local_mesh(built, tmesh):
    """A LocalMesh index holds the global arrays: the single-device
    extract_document serves it; the empty pattern counts the real rows."""
    docs, out = built
    _, tix, _, _ = out["full"]
    assert tt.extract_document(tix, 1) == docs[1]
    assert tt.extract_document(tix, 4) == docs[4]
    packed, _ = _packed([b""])
    f, l = tdq.sharded_backward_search(tix, tmesh, packed)
    assert int(l[0] - f[0]) == tix.meta.n


@pytest.mark.parametrize("tier", ["full", "packed"])
def test_carried_sharded_index(built, tmesh, tier):
    """femto_tpu's sharded index carried across (sharded_arrays_from_numpy)
    answers like the port's own build of the same blocks."""
    _, out = built
    jix, tix, _, _ = out[tier]
    arrays = {k: np.asarray(v) for k, v in jix.arrays._asdict().items()
              if v is not None}
    cix = tdq.sharded_arrays_from_numpy(arrays, jix.meta, tmesh)
    assert cix.meta == tix.meta
    packed, B = _packed(PATS)
    for got, want in zip(tdq.sharded_backward_search(cix, tmesh, packed),
                         tdq.sharded_backward_search(tix, tmesh, packed)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    rows = np.arange(tix.meta.row0, tix.meta.n_rows, dtype=np.int32)[::7]
    rows = np.concatenate([rows, np.full((-len(rows)) % D, rows[0],
                                         np.int32)])
    np.testing.assert_array_equal(
        tdq.sharded_locate(cix, tmesh, rows).numpy(),
        tdq.sharded_locate(tix, tmesh, rows, routed=False).numpy())


def test_mark_capacity_retry(tmesh):
    """Identical documents cluster their doc-start marks in one shard: the
    per-shard mark capacity grows on overflow (femto_tpu's
    test_sharded_mark_overflow_retry) and locate stays exact."""
    docs = [b"identical document body text here " * 8] * 40
    tix = tdb.build_index_sharded(tt.prepare_documents(docs), tmesh, seg=32,
                                  mark_period=4, mark_cap_local0=128)
    assert tdb.LAST_BUILD_STATS["mark_cap_retries"] > 0
    packed, _ = _packed([b"body"])
    f, l = tdq.sharded_backward_search(tix, tmesh, packed)
    rows = np.arange(int(f[0]), int(l[0]), dtype=np.int32)
    rows = np.concatenate([rows, np.full((-len(rows)) % D, rows[0],
                                         np.int32)])
    offs = tdq.sharded_locate(tix, tmesh, rows).numpy()[: int(l[0] - f[0])]
    doc, off = tt.offsets_to_docs(tix, offs.astype(np.int64))
    assert sorted(zip(doc.tolist(), off.tolist())) == \
        naive_locate(docs, b"body")


def test_unknown_tier_raises(tmesh):
    prep = tt.prepare_documents([b"abc"])
    with pytest.raises(ValueError, match="unknown sharded tier"):
        tdb.build_index_sharded(prep, tmesh, seg=32, tier="dense")
