"""Distributed multi-key sample sort over the mesh.

The counterpart of femto_tpu/parallel/dist_sort.py: pass 1 = a local sort
of each shard's block, D * OVERSAMPLE regular samples, D - 1 splitters and
one (Valiant) exchange of every record to its splitter bucket; pass 2 = a
local sort of what arrived and an exact rebalance to equal blocks of m:
every record whose owner shard is local placed straight into its block
(on a LocalMesh, all of them: one launch), the others through a window of
ppermutes.  Keys are tuples of int32 columns compared lexicographically;
callers append a unique tiebreak key, so every output is deterministic
whatever the routes.  Invalid lanes sort last (every key INT32_MAX).

The local sorts are LSD passes of kernel H's stable radix_sort_pairs (the
last key first, 32 bits each, biased to unsigned, carrying a permutation),
then one gather of every column through the permutation (kernel L's
gather_cols, up to 8 columns a launch, straight into the outputs): jax's
lax.sort is not stable, but with unique keys the orders agree.  The
splitters' bucket and the rebalance are kernel K18b (ops/dist_ops.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..ops import dist_ops as DO
from ..ops import sort_ops as SO
from . import bins

OVERSAMPLE = 32  # samples per shard; bucket size <= m + n/(D*OVERSAMPLE)
_BIAS = 2**31


def local_sort(keys: Sequence[torch.Tensor],
               payload: Sequence[torch.Tensor] = ()) -> List[torch.Tensor]:
    """Each shard's columns (int32[Dl, L] each) sorted by the key columns,
    lexicographically, ties in their first order: the sorted keys, then
    the payload columns carried along."""
    cols = list(keys) + list(payload)
    Dl, L = keys[0].shape
    out = [torch.empty_like(c) for c in cols]
    for j in range(Dl):
        perm = None
        for k in reversed(keys):
            kj = k[j] if perm is None else SO.gather_rows(k[j], perm)
            _, perm = SO.radix_sort_pairs(kj.to(torch.int64) + _BIAS, perm,
                                          0, 32)
        SO.gather_cols([c[j] for c in cols], perm, [o[j] for o in out])
    return out


def _gather_cols(cols, idx):
    """int32[Dl, len(idx)] per column: each shard's values at idx."""
    out = [torch.empty((c.shape[0], idx.shape[0]), dtype=c.dtype,
                       device=c.device) for c in cols]
    for j in range(cols[0].shape[0]):
        SO.gather_cols([c[j] for c in cols], idx, [o[j] for o in out])
    return out


def dist_sort(mesh, keys: Sequence[torch.Tensor],
              payload: Sequence[torch.Tensor], cap: int,
              key: Optional[int] = None):
    """Globally sort (keys, payload) across the mesh; each shard ends with
    its equal block of the global order.  keys / payload: int32[Dl, m]
    per shard; the key tuple must be unique per element.  ``key`` (an int
    seed) selects the Valiant two-hop bucket exchange.  Returns
    (sorted_keys, sorted_payload, overflow int32 scalar: > 0 asks for a
    retry with a larger cap)."""
    D = mesh.D
    nk = len(keys)
    dev = keys[0].device
    Dl, m = keys[0].shape
    if D == 1:
        # one shard: one local sort, none of the splitter / exchange /
        # rebalance machinery (femto_tpu measured it at ~90x there)
        out = local_sort(keys, payload)
        return out[:nk], out[nk:], torch.zeros((), dtype=torch.int32,
                                               device=dev)
    # ---- pass 1: local sort, splitters from regular samples ----
    cols = local_sort(keys, payload)
    skeys = cols[:nk]
    S = min(OVERSAMPLE, m)
    samp_idx = ((torch.arange(S, dtype=torch.int64) * m) // S).to(
        torch.int32).to(dev)
    samples = _gather_cols(skeys, samp_idx)
    gathered = [mesh.all_gather(s).reshape(1, D * S) for s in samples]
    gathered = local_sort(gathered)
    spl_idx = ((torch.arange(D - 1, dtype=torch.int32) + 1) * S).to(dev)
    splitters = [SO.gather_rows(g[0], spl_idx) for g in gathered]
    dest = DO.splitter_bucket(skeys, splitters)
    del skeys
    # ---- route to buckets ----
    if key is None:
        received, rvalid, overflow1 = bins.exchange(mesh, dest, cols, cap)
    else:
        received, rvalid, overflow1 = bins.valiant_exchange(
            mesh, dest, cols, cap, key)
    del cols, dest
    # ---- pass 2: local sort of what arrived, invalid lanes last ----
    # (the valid records compacted first: a shard receives about m of its
    # D * cap slots)
    v = rvalid.sum(dim=1, dtype=torch.int32)
    L = max(1, int(v.max()))
    comp = DO.compact_rows(
        rvalid, torch.zeros(Dl, dtype=torch.int32, device=dev), received,
        M=L, shard0=mesh.shard0,
        fills=[DO.INT32_MAX if c < nk else 0 for c in range(len(received))])
    del received, rvalid
    received = local_sort(comp[:nk], comp[nk:])
    del comp
    # ---- exact rebalance to equal blocks of m ----
    base, _ = DO.mesh_exclusive(mesh.all_gather(v.view(Dl, 1)),
                                shard0=mesh.shard0, Dl=Dl)
    base = base.view(Dl).contiguous()
    W = min(3, D - 1)
    # every record whose owner shard is local, straight into its place:
    # on a LocalMesh the whole rebalance, one launch
    outs, far = DO.rebalance_local(received, v, base, m=m, W=W,
                                   shard0=mesh.shard0)
    if mesh.Dl < D:
        # owners in other processes: a buffer, a ppermute and a where an
        # offset
        for off in range(-W, W + 1):
            if off == 0:
                continue
            bufs, vbuf = DO.rebalance_place(received, v, base, m=m, off=off,
                                            shard0=mesh.shard0)
            vbuf = mesh.ppermute(vbuf, off)
            bufs = [mesh.ppermute(b, off) for b in bufs]
            got = vbuf.bool()
            outs = [torch.where(got, b, o) for b, o in zip(bufs, outs)]
    # an element owned outside the window is a rebalance failure (overflow)
    overflow = torch.maximum(overflow1, mesh.pmax(far))
    return outs[:nk], outs[nk:], overflow
