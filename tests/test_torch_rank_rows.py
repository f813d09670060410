"""The all-symbol rank of a row (K18f's masked_occ_rows on an index as
one shard, whose plain version runs on the CPU; on the card it and kernel
R's row route rank through csrc/fm_common.cuh's warp_rank_row) against
femto_tpu's backward_step_pair, and the sharded frontier's ranks (parallel/dist_query._fork_ranks over
K18f's masked_occ_rows and the psum) against femto_tpu's
backward_step_pair_sharded.

On the CPU the wrappers run their plain versions.  Every answer is an
integer, so the tolerance is exact.  Single-device indexes: every tier at
seg 64, a vseg index with side segments and u16 symbol lists and a vrle
one with side segments, a prose vrle index with continued run-length
segments, and pad_shape indexes
(row0 > 0); the packed and row tiers are remapped (a dense alphabet).
Rows: row0 and its neighbours, segment ends, the last segment's rows,
n_rows and the segments' end.  The sharded indexes (the port's builds on
a LocalMesh of 4) go to femto_tpu as JAX arrays placed on a 4-device
mesh with its own partition specs, and to the port both as that
LocalMesh and as four one-shard processes (each holding its own blocks,
as on a DistMesh), whose parts sum to the same ranks.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.alphabet import ALPHA_SIZE
from femto_tpu.ops import rank as JR
from femto_tpu.parallel import dist_query as jdq
from femto_tpu.parallel.mesh import make_mesh
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.ops import rank as R
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel import dist_build as tdb
from femto_tpu_torch.parallel import dist_query as tdq
from tests.test_torch_dist_query import _corpus
from tests.test_torch_rowtiers import _byte_complete_docs, _prose_docs
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 4


def _q_docs():
    rng = np.random.default_rng(3)
    return [b"the quick brown fox jumps over the lazy dog",
            b"pack my box with five dozen liquor jugs",
            b"sheep black sheep baa baa black",
            b"abcabcabcabc" * 9,
            bytes(rng.integers(97, 103, size=900).astype(np.uint8))]


# name -> (corpus, tier, seg, pad_shape)
SINGLE = {
    "full": ("q", "full", 64, False),
    "compact": ("q", "compact", 64, False),
    "packed": ("q", "packed", 64, False),
    "vseg": ("q", "vseg", 64, False),
    "vrle": ("q", "vrle", 64, False),
    "side_vseg": ("bytes", "vseg", 64, False),
    "side_vrle": ("overflow", "vrle", 64, False),
    "cont_vrle": ("prose", "vrle", 256, False),
    "pad_full": ("q", "full", 64, True),
    "pad_vrle": ("q", "vrle", 64, True),
}


def _docs(name):
    return {"q": _q_docs, "bytes": _byte_complete_docs,
            "prose": _prose_docs}.get(name, lambda: _corpus(name))()


@pytest.fixture(scope="module")
def singles():
    out = {}
    for name, (corpus, tier, seg, pad) in SINGLE.items():
        prep = tt.prepare_documents(_docs(corpus))
        kw = dict(pad_shape=(prep.n + 100, prep.num_docs + 2)) if pad else {}
        out[name] = tt.build_index(prep, seg=seg, mark_period=8, tier=tier,
                                   device="cpu", **kw)
    woff = out["side_vseg"].arrays.seg_woff
    assert bool((woff > 0).any()), "no side segment"
    assert bool((out["side_vrle"].arrays.seg_woff > 0).any())
    assert bool((out["cont_vrle"].arrays.seg_woff < -1).any()), \
        "no continued run-length segment"
    assert out["pad_full"].meta.row0 == 100
    for name in ("packed", "vseg", "vrle", "side_vrle", "cont_vrle"):
        assert R.is_remapped(out[name].arrays), name
    return out


def _edge_rows(meta, seg, n_seg, rng):
    """row0 and its neighbours, the ends of some segments, the last
    segment's rows, n_rows and the segments' end, and some drawn rows."""
    end = n_seg * seg
    rows = [meta.row0 - 1, meta.row0, meta.row0 + 1, meta.n_rows - 1,
            meta.n_rows, meta.n_rows + 1, end - 1, end]
    for s in (1, 2, n_seg // 2, n_seg - 1):
        rows += [s * seg - 1, s * seg, s * seg + 1, (s + 1) * seg - 1]
    rows += list(range((n_seg - 1) * seg, end, 7))
    rows += list(rng.integers(0, end, size=40))
    return np.unique(np.clip(np.asarray(rows, np.int64), 0, end)).astype(
        np.int32)


def _j(t):
    return jnp.array(np.array(t.numpy(), copy=True))


@pytest.mark.parametrize("name", list(SINGLE))
def test_occ_rows_like_backward_step_pair(singles, name):
    """Every symbol's step from each edge row: C[code] + masked_occ_rows
    on the index as one shard of one (Dl 1), 0 for a symbol outside the
    index's alphabet, equals femto_tpu's backward_step_pair (both range
    ends)."""
    ix = singles[name]
    A, seg = ix.arrays, R.seg_size(ix.arrays)
    n_seg = R.n_segments(A)
    rows = torch.from_numpy(_edge_rows(ix.meta, seg, n_seg,
                                       np.random.default_rng(7)))
    M = rows.shape[0]
    part = DO.masked_occ_rows(A, rows, Dl=1, nseg_local=n_seg, shard0=0,
                              n_rows_total=n_seg * seg)
    assert part.shape == (1, M * ALPHA_SIZE) and part.dtype == torch.int32
    cd = R.map_char(A, torch.arange(ALPHA_SIZE, dtype=torch.int32))
    valid = cd >= 0
    base = A.C[torch.where(valid, cd, 0).long()]
    got = torch.where(valid[None], base[None] + part.view(M, ALPHA_SIZE), 0)
    jarrays = ft.FMArrays(**{k: None if v is None else _j(v)
                             for k, v in A._asdict().items()})
    chars = np.tile(np.arange(ALPHA_SIZE, dtype=np.int32), M)
    lanes = jnp.asarray(np.repeat(rows.numpy(), ALPHA_SIZE))
    nf, nl = jax.jit(JR.backward_step_pair)(jarrays, jnp.asarray(chars),
                                            lanes, lanes)
    want = np.asarray(nf).reshape(M, ALPHA_SIZE)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(nl).reshape(M, ALPHA_SIZE),
                                  want)


# (corpus, tier, seg) of the sharded indexes: the five documents on every
# tier the sharded engine serves, a vseg index with side segments and a
# vrle index with continued ones
SHARDED = {"full": ("five", "full", 32), "packed": ("five", "packed", 32),
           "vseg": ("five", "vseg", 32), "vrle": ("five", "vrle", 32),
           "side_vseg": ("overflow", "vseg", 32),
           "cont_vrle": ("prose", "vrle", 64)}


@pytest.fixture(scope="module")
def sharded():
    mesh = LocalMesh(D, device="cpu")
    out = {name: tdb.build_index_sharded(
        tt.prepare_documents(_corpus(corpus)), mesh, seg=seg, mark_period=8,
        tier=tier) for name, (corpus, tier, seg) in SHARDED.items()}
    assert bool((out["side_vseg"].arrays.seg_woff > 0).any())
    assert bool((out["cont_vrle"].arrays.seg_woff < -1).any())
    return mesh, make_mesh(D), out


def _femto_step_sharded(jmesh, arrays, nseg_local, chars, first, last):
    """femto_tpu's backward_step_pair_sharded over the index's arrays
    placed on the mesh by femto_tpu's own partition specs."""
    axis = jdq.DEFAULT_AXIS
    jnp_arrays = ft.FMArrays(**{k: None if v is None else _j(v)
                                for k, v in arrays._asdict().items()})
    specs = jdq._specs_for_arrays(axis, jnp_arrays)
    placed = ft.FMArrays(**{
        k: None if v is None else jax.device_put(
            v, NamedSharding(jmesh, getattr(specs, k)))
        for k, v in jnp_arrays._asdict().items()})

    def body(a, c, f, l):
        return jdq.backward_step_pair_sharded(a, nseg_local, axis, c, f, l)

    mapped = jax.shard_map(body, mesh=jmesh,
                           in_specs=(specs, P(), P(), P()),
                           out_specs=(P(), P()))
    nf, nl = jax.jit(mapped)(placed, jnp.asarray(chars), jnp.asarray(first),
                             jnp.asarray(last))
    return np.asarray(nf), np.asarray(nl)


def _process_view(ix, d):
    """Shard d's process of a DistMesh of one-shard processes: its own
    blocks of the index (sharded_arrays_from_numpy at Dl = 1)."""
    mesh = types.SimpleNamespace(D=D, Dl=1, shard0=d, device="cpu")
    arrays = {k: v.numpy() for k, v in ix.arrays._asdict().items()
              if v is not None}
    return tdq.sharded_arrays_from_numpy(arrays, ix.meta, mesh)


@pytest.mark.parametrize("name", list(SHARDED))
def test_fork_ranks_like_backward_step_pair_sharded(sharded, name):
    """_fork_ranks (masked_occ_rows on the LocalMesh's 4 shards, the psum
    and C) equals femto_tpu's backward_step_pair_sharded at every symbol
    from edge rows (row0, shard and segment ends, n_rows, the mesh's
    rows' end); four one-shard processes' masked_occ_rows sum to the
    LocalMesh's."""
    mesh, jmesh, indexes = sharded
    ix = indexes[name]
    meta, seg = ix.meta, R.seg_size(ix.arrays)
    nseg_local = meta.n_seg // D
    rows = _edge_rows(meta, seg, meta.n_seg, np.random.default_rng(9))
    ends = np.arange(1, D) * nseg_local * seg + np.array([[-1], [0], [1]])
    rows = np.unique(np.concatenate([rows, ends.reshape(-1)]).astype(
        np.int32))
    if rows.shape[0] % 2:
        rows = rows[:-1]
    h = rows.shape[0] // 2
    first, last = torch.from_numpy(rows[:h]), torch.from_numpy(rows[h:])
    nf, nl = tdq._fork_ranks(ix, mesh)(first, last, h)
    chars = np.tile(np.arange(ALPHA_SIZE, dtype=np.int32), h)
    jf, jl = _femto_step_sharded(jmesh, ix.arrays, nseg_local, chars,
                                 np.repeat(rows[:h], ALPHA_SIZE),
                                 np.repeat(rows[h:], ALPHA_SIZE))
    np.testing.assert_array_equal(nf.numpy(), jf)
    np.testing.assert_array_equal(nl.numpy(), jl)
    kw = dict(nseg_local=nseg_local, n_rows_total=D * nseg_local * seg)
    rt = torch.from_numpy(rows)
    local = DO.masked_occ_rows(ix.arrays, rt, Dl=D, shard0=0, **kw)
    parts = [DO.masked_occ_rows(_process_view(ix, d).arrays, rt, Dl=1,
                                shard0=d, **kw) for d in range(D)]
    assert local.shape == (D, rows.shape[0] * ALPHA_SIZE)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), local.numpy())
    np.testing.assert_array_equal(mesh.psum(local).numpy(),
                                  sum(p[0] for p in parts).numpy())
