"""K18c's mesh_flags (femto_tpu_torch.ops.dist_ops) against femto_tpu's own
expressions on a 4-device CPU mesh.

The port's wrapper takes its plain PyTorch version for CPU tensors: 1
where a sorted slot's key tuple differs from the slot before it, the
shard before's last keys standing before a shard's first slot, and the
global slot 0 set to ``first``.  femto_tpu runs the expressions it
replaces through shard_map: _seed_sort_body's group starts
(femto_tpu/parallel/dist_build.py:292-299; first True) and _rank_refine's
adjacent diff (138-147; first False), over 1 to 6 key columns.  The same
seeded keys go through both and must agree exactly, at the edges the
card's kernel cares about: m of 1, 15, 16, 17 and 1000 (its 16 elements
a thread), keys of three values (ties inside a shard and across each
shard boundary), on the whole mesh and on one-shard and two-shard views
(shard0 > 0).  The wrapper refuses 0 or 7 key columns, a prev per column
missing, mismatched shapes and keys that are not int32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from femto_tpu.parallel.mesh import DEFAULT_AXIS, make_mesh
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel import dist_build as tdb
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 4
AX = DEFAULT_AXIS
MS = (1, 15, 16, 17, 1000)


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh(D)


@pytest.fixture(scope="module")
def tmesh():
    return LocalMesh(D, device="cpu")


def _femto_flags(jmesh, m, nk):
    """femto_tpu's group starts (_seed_sort_body) and adjacent diff
    (_rank_refine, over nk columns) per shard of m."""
    def body(*keys):
        D_ = jax.lax.axis_size(AX)
        me = jax.lax.axis_index(AX)
        gidx = me * m + jnp.arange(m, dtype=jnp.int32)
        perm = [(i, (i + 1) % D_) for i in range(D_)]
        # _seed_sort_body: group starts
        neq = jnp.zeros((m - 1,), bool)
        first = jnp.zeros((), bool)
        for sk in keys:
            prev = jax.lax.ppermute(sk[-1], AX, perm)
            neq = neq | (sk[1:] != sk[:-1])
            first = first | (sk[0] != prev)
        st = jnp.concatenate([jnp.where(gidx[0] == 0, True, first)[None],
                              neq])
        # _rank_refine: the diff with the previous device's last key
        diff = jnp.zeros((m,), bool)
        for sk in keys:
            prev = jax.lax.ppermute(sk[-1], AX, perm)
            diff = diff | (sk != jnp.concatenate([prev[None], sk[:-1]]))
        diff = jnp.where(gidx == 0, 0, diff.astype(jnp.int32))
        return st.astype(jnp.uint8), diff.astype(jnp.uint8)

    return jax.jit(jax.shard_map(body, mesh=jmesh, in_specs=(P(AX),) * nk,
                                 out_specs=(P(AX), P(AX))))


def _keys(rng, m, nk):
    """nk int32[D, m] key columns of three values; each shard's first
    slot equal to the shard before's last in every column on a third of
    the boundaries."""
    keys = rng.integers(0, 3, size=(nk, D, m)).astype(np.int32)
    for d in range(1, D, 3):
        keys[:, d, 0] = keys[:, d - 1, -1]
    return keys


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("nk", range(1, 7))
def test_mesh_flags_like_femto_tpu(jmesh, tmesh, nk, m):
    """mesh_flags with first True against the group starts, with first
    False against the adjacent diff: on the whole mesh (Dl 4, shard0 0,
    prev by the mesh's ppermute) and on views of one shard (Dl 1, shard0
    its index) and of shards 2 and 3 (Dl 2, shard0 2)."""
    keys = _keys(np.random.default_rng(100 * nk + m), m, nk)
    st, diff = (np.asarray(x).reshape(D, m) for x in _femto_flags(
        jmesh, m, nk)(*(jnp.asarray(k.reshape(-1)) for k in keys)))
    tk = [torch.from_numpy(k.copy()) for k in keys]
    prev = [tdb._prev_last(tmesh, k) for k in tk]
    for first, want in ((True, st), (False, diff)):
        got = DO.mesh_flags(tk, prev, shard0=0, first=first)
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        for lo, hi in ((0, 1), (1, 2), (3, 4), (2, 4)):
            part = DO.mesh_flags([k[lo:hi].contiguous() for k in tk],
                                 [p[lo:hi].contiguous() for p in prev],
                                 shard0=lo, first=first)
            np.testing.assert_array_equal(part.numpy(), want[lo:hi])


def _bad(case):
    k = torch.zeros((2, 8), dtype=torch.int32)
    p = torch.zeros(2, dtype=torch.int32)
    return {
        "no key": ([], []),
        "seven keys": ([k] * 7, [p] * 7),
        "prev missing": ([k, k], [p]),
        "keys of other shapes": ([k, torch.zeros((2, 9), dtype=torch.int32)],
                                 [p, p]),
        "prev of another shape": ([k], [torch.zeros(3, dtype=torch.int32)]),
        "int64 keys": ([k.long()], [p]),
        "int64 prev": ([k], [p.long()]),
        "keys not 2-D": ([k.reshape(-1)], [p]),
    }[case]


@pytest.mark.parametrize("case", ["no key", "seven keys", "prev missing",
                                  "keys of other shapes",
                                  "prev of another shape", "int64 keys",
                                  "int64 prev", "keys not 2-D"])
def test_mesh_flags_refuses_bad_arguments(case):
    keys, prev = _bad(case)
    with pytest.raises(ValueError):
        DO.mesh_flags(keys, prev, shard0=0, first=True)
