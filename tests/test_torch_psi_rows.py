"""Kernel E's psi walk (ops/search_ops.psi_walk) and its steps
(ops/rank.psi_step, select_char) against femto_tpu's search._psi_scan_jit,
search_ops.psi_step and search_ops._select_char on the same arrays.

On the CPU the wrapper runs its plain version; on the card the same call
goes through csrc/psi_walk.cu, whose two routes (a thread a walk, or a
warp a walk with a 32-way checkpoint search and a warp select in the row)
chip_smoke.py holds to this plain version.  Every answer is an integer,
so the tolerance is exact.

Indexes: every tier at seg 64 and 256 on a small mixed corpus; a vseg
index with side segments and u16 symbol lists, a prose vrle index with
continued run-length segments, and pad_shape indexes (row0 > 0) on full,
vseg and vrle; the packed and row tiers are remapped (a dense alphabet).
Rows: C[c] and C[c+1] - 1 of every present code; the rows whose step
lands on the first or the last field of a segment (segment 0, the last
and drawn ones), on offsets of the last segment and of side and continued
segments (LF of each such row, psi's inverse); and rows a few text
positions before a document's end, whose walks cross it.  Walks of 1, 64
and 200 steps from every fourth of those rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import search as JSearch
from femto_tpu.ops import search_ops as JS
from femto_tpu_torch.ops import rank as R
from femto_tpu_torch.ops import search_ops as TS
from tests.test_torch_count_rows import _mixed_docs
from tests.test_torch_dist_query import _corpus
from tests.test_torch_rowtiers import _byte_complete_docs, _prose_docs
from tests.torch_threads import one_torch_thread  # noqa: F401

TIERS = ("full", "compact", "packed", "vseg", "vrle")

# name -> (corpus, tier, seg, pad_shape)
INDEXES = {
    **{f"{tier}_{seg}": ("mixed", tier, seg, False)
       for tier in TIERS for seg in (64, 256)},
    "side_vseg_64": ("bytes", "vseg", 64, False),
    "side_vrle_64": ("overflow", "vrle", 64, False),
    "cont_vrle_256": ("prose", "vrle", 256, False),
    "pad_full_64": ("mixed", "full", 64, True),
    "pad_vseg_256": ("mixed", "vseg", 256, True),
    "pad_vrle_64": ("mixed", "vrle", 64, True),
}
STEPS = (1, 64, 200)
# the walks start from every fourth edge row (psi_step takes them all)
WALK_STRIDE = 4

def _docs(name):
    return {"mixed": _mixed_docs, "bytes": _byte_complete_docs,
            "prose": _prose_docs}.get(name, lambda: _corpus(name))()


@pytest.fixture(scope="module")
def indexes():
    out = {}
    for name, (corpus, tier, seg, pad) in INDEXES.items():
        prep = tt.prepare_documents(_docs(corpus))
        kw = dict(pad_shape=(prep.n + 300, prep.num_docs + 2)) if pad else {}
        out[name] = tt.build_index(prep, seg=seg, mark_period=8, tier=tier,
                                   device="cpu", **kw)
    for name in ("side_vseg_64", "side_vrle_64"):
        assert bool((out[name].arrays.seg_woff > 0).any()), name
    assert bool((out["cont_vrle_256"].arrays.seg_woff < -1).any()), \
        "no continued run-length segment"
    for name in ("pad_full_64", "pad_vseg_256", "pad_vrle_64"):
        assert out[name].meta.row0 == 300, name
    for name in ("packed_64", "vseg_256", "vrle_64", "cont_vrle_256"):
        assert R.is_remapped(out[name].arrays), name
    return out


@pytest.fixture(scope="module")
def jax_arrays(indexes):
    return {name: ft.FMArrays(**{
        k: None if v is None else jnp.array(np.array(v.numpy(), copy=True))
        for k, v in ix.arrays._asdict().items()})
        for name, ix in indexes.items()}


def _edge_rows(arrays, rng):
    """int32 rows (numpy) of the walks: see the module docstring."""
    seg, n_seg, K = R.seg_size(arrays), R.n_segments(arrays), \
        R.alpha_count(arrays)
    C = arrays.C.numpy().astype(np.int64)
    n = int(C[K])
    present = np.nonzero(C[1:] > C[:-1])[0]
    starts = np.concatenate([C[present], C[present + 1] - 1])
    s = np.concatenate([[0, n_seg - 1], rng.integers(0, n_seg, 24)])
    xs = [s * seg, s * seg + seg - 1]
    segs = [n_seg - 1]
    if R.is_row_tier(arrays):
        woff = arrays.seg_woff.numpy()
        for kind in (np.nonzero(woff > 0)[0], np.nonzero(woff < -1)[0]):
            if len(kind):
                segs += kind[rng.integers(0, len(kind), 8)].tolist()
    offs = np.concatenate([[0, 1, seg - 2, seg - 1],
                           rng.integers(0, seg, 8)])
    xs += [t * seg + offs for t in np.unique(segs)]
    x = np.unique(np.concatenate(xs))
    x = torch.from_numpy(x[(x >= 0) & (x < n)].astype(np.int32))
    x = x[R.bwt_code_at(arrays, x) < K]
    rows = [starts, R.lf_step(arrays, x).numpy()]
    r = arrays.doc_seof_rows.to(torch.int32)
    for _ in range(5):
        r = R.lf_step(arrays, r)
        rows.append(r.numpy())
    return np.concatenate(rows).astype(np.int32)


@pytest.fixture(scope="module")
def femto_walks(indexes, jax_arrays):
    """name -> (rows, femto_tpu's walk of max(STEPS) steps from them), made
    on first use: a shorter walk is its first columns."""
    cache = {}

    def get(name):
        if name not in cache:
            ix = indexes[name]
            rows = np.ascontiguousarray(_edge_rows(
                ix.arrays, np.random.default_rng(1))[::WALK_STRIDE])
            cache[name] = (rows, np.asarray(JSearch._psi_scan_jit(
                jax_arrays[name], ix.meta.n, jnp.asarray(rows), max(STEPS))))
        return cache[name]
    return get


@pytest.mark.parametrize("steps", STEPS)
@pytest.mark.parametrize("name", list(INDEXES))
def test_psi_walk_like_femto(indexes, femto_walks, name, steps):
    """psi_walk equals femto_tpu's _psi_scan_jit on the edge rows."""
    rows, want = femto_walks(name)
    got = TS.psi_walk(indexes[name].arrays, torch.from_numpy(rows), steps)
    assert got.shape == (len(rows), steps)
    np.testing.assert_array_equal(got.numpy(), want[:, :steps])


@pytest.mark.parametrize("name", list(INDEXES))
def test_psi_step_like_femto(indexes, jax_arrays, name):
    """One psi step (the next row and the row's symbol) equals femto_tpu's
    psi_step, and LF takes each next row back."""
    ix = indexes[name]
    rows = _edge_rows(ix.arrays, np.random.default_rng(2))
    got = R.psi_step(ix.arrays, torch.from_numpy(rows))
    want = jax.jit(JS.psi_step, static_argnums=1)(
        jax_arrays[name], ix.meta.n, jnp.asarray(rows))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(R.lf_step(ix.arrays, got[0]).numpy(),
                                  rows)


@pytest.mark.parametrize("name", list(INDEXES))
def test_select_char_like_femto(indexes, jax_arrays, name):
    """select_char equals femto_tpu's _select_char at the first and the
    last occurrence of every present code and at drawn ones."""
    ix = indexes[name]
    A = ix.arrays
    K = R.alpha_count(A)
    C = A.C.numpy().astype(np.int64)
    occ = C[1:K + 1] - C[:K]
    present = np.nonzero(occ > 0)[0]
    rng = np.random.default_rng(3)
    drawn = present[rng.integers(0, len(present), 200)]
    c = np.concatenate([present, present, drawn]).astype(np.int32)
    k = np.concatenate([np.zeros(len(present)), occ[present] - 1,
                        rng.random(len(drawn)) * occ[drawn]]).astype(
                            np.int32)
    got = R.select_char(A, torch.from_numpy(c), torch.from_numpy(k))
    want = jax.jit(JS._select_char, static_argnums=1)(
        jax_arrays[name], ix.meta.n, jnp.asarray(c), jnp.asarray(k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # each select lands on an occurrence of its code
    np.testing.assert_array_equal(R.bwt_code_at(A, got).numpy(), c)
