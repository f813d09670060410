"""K18c / K18d's mesh_scan and compact_rows (femto_tpu_torch.ops.dist_ops)
against femto_tpu's own expressions on the 8-virtual-device CPU mesh.

The port's wrappers take their plain PyTorch versions for CPU tensors:
mesh_scan (the counts of flags, the cummax of flag ? slot : 0, with or
without given slots) and compact_rows, which ranks its own flags.
femto_tpu runs the expressions they replace: _group_state's cummax
(femto_tpu/parallel/dist_build.py:195), _rank_refine's local_cum (148),
_rep_compact_body (305) through shard_map, and _rep_double_body's
new_base / cpos / tgt compaction (431-447) on a replicated array.  The
same seeded inputs go through both and must agree exactly, at the edges
the card's single-pass kernels care about: no flag and every flag, a
flag at a shard's first or last slot, m below, at and past one tile of
each kernel and not a multiple of 16, off + count past M, one-shard views (Dl 1,
shard0 > 0) and 1 to 9 columns, some of them the slot's global index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from femto_tpu.parallel import dist_build as jdb
from femto_tpu.parallel.mesh import DEFAULT_AXIS, make_mesh
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel import dist_build as tdb
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 8
AX = DEFAULT_AXIS
I32MAX = 2**31 - 1
SCAN_TILE = 16384    # csrc/dist_rounds.cu kScanTile (mesh_scan's tile)
COMPACT_TILE = 8192  # csrc/dist_rounds.cu kCompactTile (compact_rows')


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(D)


@pytest.fixture(scope="module")
def tmesh():
    return LocalMesh(D, device="cpu")


def _flags(pattern, n, rng, m):
    """uint8[n] flags of a pattern over D shards of m."""
    f = np.zeros(n, np.uint8)
    if pattern == "all":
        f[:] = 1
    elif pattern == "first":     # shard 3's first slot
        f[3 * m] = 1
    elif pattern == "last":      # shard 5's last slot
        f[6 * m - 1] = 1
    elif pattern == "random":
        f[:] = rng.random(n) < 0.3
    return f


_SCAN_FNS = {}


def _femto_scans(jmesh, m):
    """femto_tpu's scans per shard of m, one compile a shape: local_cum =
    cumsum(diff) with its last value (_rank_refine), base_local =
    cummax(where(st, slots, 0)), and _group_state's base and unresolved."""
    if m not in _SCAN_FNS:
        def body(st):
            me = jax.lax.axis_index(AX)
            stb = st.astype(bool)
            local_cum = jnp.cumsum(st.astype(jnp.int32))
            slots = me * m + jnp.arange(m, dtype=jnp.int32)
            base_local = jax.lax.cummax(jnp.where(stb, slots, 0))
            _, base, unres = jdb._group_state(stb, AX, D * m)
            return (local_cum, local_cum[-1:], base_local, base_local[-1:],
                    base, unres.astype(jnp.uint8))

        _SCAN_FNS[m] = jax.jit(jax.shard_map(
            body, mesh=jmesh, in_specs=(P(AX),), out_specs=(P(AX),) * 6))
    return _SCAN_FNS[m]


def _rows(x):
    return np.asarray(x).reshape(D, -1)


@pytest.mark.parametrize("m", [100, SCAN_TILE, SCAN_TILE + 9])
@pytest.mark.parametrize("pattern", ["none", "all", "first", "last",
                                     "random"])
def test_mesh_scan_like_femto_tpu(jmesh, tmesh, m, pattern):
    """mesh_scan "sum" against local_cum, "max" against _group_state's
    cummax, on the whole mesh (Dl 8) and on each shard alone (Dl 1,
    shard0 its index); _group_state's base and unresolved as well."""
    rng = np.random.default_rng(m)
    f = _flags(pattern, D * m, rng, m)
    cum, cum_last, bl, bl_last, base, unres = (
        _rows(x) for x in _femto_scans(jmesh, m)(jnp.asarray(f)))
    ft = torch.from_numpy(f.reshape(D, m).copy())
    for mode, want, want_last in (("sum", cum, cum_last),
                                  ("max", bl, bl_last)):
        out, last = DO.mesh_scan(ft, mode=mode, shard0=0)
        np.testing.assert_array_equal(out.numpy(), want)
        np.testing.assert_array_equal(last.numpy(), want_last[:, 0])
        for p in (0, 3, D - 1):
            o1, l1 = DO.mesh_scan(ft[p:p + 1], mode=mode, shard0=p)
            np.testing.assert_array_equal(o1.numpy()[0], want[p])
            assert int(l1[0]) == int(want_last[p, 0])
    tbase, tunres = tdb._group_state(tmesh, ft, D * m)
    np.testing.assert_array_equal(tbase.numpy(), base)
    np.testing.assert_array_equal(tunres.numpy(), unres)


def _st(pattern, n, rng, m):
    """Group-start flags whose unresolved slots (~(st & next)) take the
    pattern: none unresolved (every slot a start), all, shard 3's first
    slot with shard 2's last, the global first and last slots, random."""
    st = np.ones(n, bool)
    if pattern == "all":
        st[:] = False
    elif pattern == "boundary":
        st[3 * m] = False
    elif pattern == "ends":
        st[0] = st[n - 1] = False
    elif pattern == "random":
        st[:] = rng.random(n) < 0.8
    return st


_COMPACT_FNS = {}


def _femto_rep_compact(jmesh, m, M):
    key = (m, M)
    if key not in _COMPACT_FNS:
        def body(sa, st):
            return jdb._rep_compact_body(sa, st.astype(bool), n_pad=D * m,
                                         M=M, axis=AX)

        _COMPACT_FNS[key] = jax.jit(jax.shard_map(
            body, mesh=jmesh, in_specs=(P(AX), P(AX)),
            out_specs=(P(),) * 3))
    return _COMPACT_FNS[key]


@pytest.mark.parametrize("m", [96, COMPACT_TILE, COMPACT_TILE + 32])
@pytest.mark.parametrize("M_of", ["third", "whole"])
@pytest.mark.parametrize("pattern", ["none", "all", "boundary", "ends",
                                     "random"])
def test_rep_compact_like_femto_tpu(jmesh, tmesh, m, M_of, pattern):
    """_rep_compact (compact_rows of the unresolved slots at each shard's
    offset over the mesh, then the psum) against _rep_compact_body, M a
    third of the slots (off + count past M for most patterns) or all of
    them; and each shard's own compaction alone (Dl 1, shard0 its index,
    its off) against its part of femto_tpu's merged records."""
    rng = np.random.default_rng(m + len(pattern))
    n = D * m
    M = n // 3 if M_of == "third" else n
    sa = rng.permutation(n).astype(np.int32)
    st = _st(pattern, n, rng, m)
    want = [np.asarray(x) for x in _femto_rep_compact(jmesh, m, M)(
        jnp.asarray(sa), jnp.asarray(st.astype(np.uint8)))]
    sat = torch.from_numpy(sa.reshape(D, m).copy())
    stt = torch.from_numpy(st.astype(np.uint8).reshape(D, m))
    got = tdb._rep_compact(tmesh, sat, stt, n_pad=n, M=M)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # each shard's buffer alone: its records at [off, off + cnt), 0 past
    base_all, unres = tdb._group_state(tmesh, stt, n)
    cnt = unres.sum(dim=1, dtype=torch.int32)
    off = torch.cumsum(cnt, 0, dtype=torch.int32) - cnt
    live = np.arange(M) < int(cnt.sum())
    slots = np.where(live, want[0], 0)
    pos = np.where(live, want[1], 0)
    base = np.where(live, want[2], 0)
    for p in (0, 3, D - 1):
        bufs = DO.compact_rows(unres[p:p + 1], off[p:p + 1],
                               [None, sat[p:p + 1], base_all[p:p + 1]],
                               M=M, fills=[0, 0, 0], shard0=p)
        k = np.arange(M)
        mine = (k >= int(off[p])) & (k < int(off[p]) + int(cnt[p]))
        for b, w in zip(bufs, (slots, pos, base)):
            np.testing.assert_array_equal(b.numpy()[0], np.where(mine, w, 0))


@jax.jit
def _femto_rep_double_compaction(slots, stn, valid, sp, extra):
    """_rep_double_body's survivor compaction (dist_build.py:431-447) on
    replicated records, with `extra` columns placed by the same tgt."""
    M = slots.shape[0]
    n_pad = I32MAX - 1
    new_base = jax.lax.cummax(jnp.where(stn & valid, slots, 0))
    nxt = jnp.concatenate([stn[1:], jnp.ones((1,), bool)])
    keep = valid & ~(stn & nxt)
    cpos = jnp.cumsum(keep.astype(jnp.int32)) - 1
    tgt = jnp.where(keep, jnp.minimum(cpos, M - 1), M)
    slots2 = jnp.full((M + 1,), n_pad, jnp.int32).at[tgt].set(
        slots, mode="drop")[:M]
    pos2 = jnp.zeros((M + 1,), jnp.int32).at[tgt].set(sp, mode="drop")[:M]
    base2 = jnp.full((M + 1,), I32MAX, jnp.int32).at[tgt].set(
        new_base, mode="drop")[:M]
    # a None column: the record's index; the extra columns, fill -7
    idx = jnp.zeros((M + 1,), jnp.int32).at[tgt].set(
        jnp.arange(M, dtype=jnp.int32), mode="drop")[:M]
    ext = jnp.full((extra.shape[0], M + 1), -7, jnp.int32).at[:, tgt].set(
        extra, mode="drop")[:, :M]
    return (new_base, keep.astype(jnp.uint8), slots2, pos2, base2, idx, ext,
            jnp.sum(keep.astype(jnp.int32)))


def _records(case, M, rng):
    """Replicated records of _rep_double_body: ascending slots, group
    starts stn, valid; the survivors (keep) take the case's pattern."""
    slots = np.sort(rng.choice(8 * M, size=M, replace=False)).astype(
        np.int32)
    stn = rng.random(M) < 0.5
    valid = np.ones(M, bool)
    if case == "none":
        valid[:] = False
    elif case == "all":
        stn[:] = False
    elif case in ("first", "last"):
        j = 0 if case == "first" else M - 1
        valid[:] = False
        valid[j], stn[j] = True, False
    return slots, stn, valid


@pytest.mark.parametrize("M", [100, COMPACT_TILE - 1, COMPACT_TILE,
                               COMPACT_TILE + 1, SCAN_TILE + 1])
@pytest.mark.parametrize("case", ["none", "all", "first", "last", "random"])
@pytest.mark.parametrize("ncols", [1, 3, 8, 9])
def test_rep_double_compaction_like_femto_tpu(M, case, ncols):
    """mesh_scan "max" with slots (new_base) and compact_rows (cpos, tgt)
    against _rep_double_body's expressions on one replicated shard (Dl 1,
    shard0 0): the epilogue's three columns first, then a None column (the
    record's index) and extra columns, 1 to 9 in all (9: two launches on
    the card)."""
    rng = np.random.default_rng(M * 7 + ncols)
    slots, stn, valid = _records(case, M, rng)
    sp = rng.integers(0, 2**31 - 1, size=M).astype(np.int32)
    extra = rng.integers(-2**31, 2**31 - 1, size=(max(ncols - 4, 1), M)
                         ).astype(np.int32)
    nb, keep, s2, p2, b2, idx, ext, cnt = (np.asarray(x) for x in
                                           _femto_rep_double_compaction(
        jnp.asarray(slots), jnp.asarray(stn), jnp.asarray(valid),
        jnp.asarray(sp), jnp.asarray(extra)))

    def row(x):
        return torch.from_numpy(np.array(x)).view(1, -1)

    flags = row((stn & valid).astype(np.uint8))
    new_base, last = DO.mesh_scan(flags, mode="max", shard0=0,
                                  slots=row(slots))
    np.testing.assert_array_equal(new_base.numpy()[0], nb)
    assert int(last[0]) == int(nb[-1])
    cols = [row(slots), row(sp), new_base, None] + [
        row(e) for e in extra][:ncols - 4]
    fills = [I32MAX - 1, 0, I32MAX, 0] + [-7] * len(extra)
    wants = [s2, p2, b2, idx] + list(ext)
    kt = row(keep)
    got = DO.compact_rows(kt, torch.zeros(1, dtype=torch.int32),
                          cols[:ncols], M=M, fills=fills[:ncols], shard0=0)
    assert len(got) == ncols
    for g, w in zip(got, wants[:ncols]):
        np.testing.assert_array_equal(g.numpy()[0], w)
    assert int(kt.sum(dtype=torch.int32)) == int(cnt)


def test_compact_rows_plain_ranks_its_flags():
    """compact_rows' plain version against a loop over the slots, flags of
    any nonzero byte value, off + count past M, Dl 3 with shard0 2."""
    rng = np.random.default_rng(11)
    Dl, m, M, shard0 = 3, 37, 20, 2
    f = (rng.random((Dl, m)) < 0.4) * rng.integers(1, 256, size=(Dl, m))
    flags = torch.from_numpy(f.astype(np.uint8))
    off = torch.tensor([0, 5, 17], dtype=torch.int32)
    col = torch.from_numpy(rng.integers(-99, 99, size=(Dl, m)).astype(
        np.int32))
    a, b = DO.compact_rows(flags, off, [col, None], M=M, fills=[-1, -2],
                           shard0=shard0)
    for d in range(Dl):
        wa, wb = np.full(M, -1), np.full(M, -2)
        k = int(off[d])
        for p in range(m):
            if f[d, p]:
                if k < M:
                    wa[k], wb[k] = col[d, p], (shard0 + d) * m + p
                k += 1
        np.testing.assert_array_equal(a.numpy()[d], wa)
        np.testing.assert_array_equal(b.numpy()[d], wb)


def test_wrappers_refuse_bad_arguments():
    flags = torch.zeros((2, 5), dtype=torch.uint8)
    off = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        DO.compact_rows(flags, off, [], M=3, fills=[], shard0=0)
    with pytest.raises(ValueError):
        DO.compact_rows(flags, off, [None], M=3, fills=[0, 1], shard0=0)
    with pytest.raises(ValueError):
        DO.mesh_scan(flags, mode="min", shard0=0)
    with pytest.raises(ValueError):
        DO.mesh_scan(flags[:, :0], mode="sum", shard0=0)
