"""Sharded count and locate: index rows distributed over the mesh.

The counterpart of femto_tpu/parallel/dist_query.py's count and locate.
Two schemes, as there:

  * routed (the default): the query lanes are split over the shards, and
    every step routes each lane's (row, code) request to the shard owning
    the row by a Valiant exchange (parallel/bins.py); the owner answers
    from its own blocks (kernel K18f's owner_occ / owner_lf, the shards'
    checkpoints carry the global base) and the answers travel back.  Hot
    rows can overflow the exchange capacity: the wrapper retries with the
    capacity times 4 and, past max_retries, falls through to
  * masked psum: every shard sees every lane, answers for the rows it owns
    and 0 for the others (masked_occ / masked_lf), one psum per step.

Both return replicated int32 tensors.  sharded_arrays_from_numpy carries a
femto_tpu sharded index (np.asarray of its global arrays) across to the
mesh.  The query engine over a sharded index (regex, approximate, Boolean
and docs queries) is not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..fmindex import FMIndex, arrays_from_numpy
from ..ops import dist_ops as DO
from ..ops import rank as R
from . import bins
from .mesh import shard_ids

# FMArrays fields that are cut into the shards' blocks (femto_tpu's
# _specs_for_arrays, full / compact / packed): occ_l1 too where it has
# more than its one dummy row
SHARDED_FIELDS = ("bwt", "occ_ckpt", "mark_bits", "mark_ckpt", "mark_vals")


def _nseg_local(index, mesh) -> int:
    return index.meta.n_seg // mesh.D


def _check_tier(index) -> None:
    if R.is_row_tier(index.arrays):
        raise NotImplementedError(
            "sharded queries over the vseg and vrle tiers are not ported "
            "yet (see ROADMAP.md)")


def _to_mesh(x, mesh) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32)).to(mesh.device)


def _lane_blocks(x: np.ndarray, mesh, fill) -> torch.Tensor:
    """The query lanes padded to D blocks; the process's blocks [Dl, ...]."""
    B = x.shape[0]
    Bp = -(-B // mesh.D) * mesh.D
    xp = np.full((Bp,) + x.shape[1:], fill, np.int32)
    xp[:B] = x
    Bl = Bp // mesh.D
    own = xp[mesh.shard0 * Bl:(mesh.shard0 + mesh.Dl) * Bl]
    return _to_mesh(own.reshape((mesh.Dl, Bl) + x.shape[1:]), mesh)


def _gather_lanes(mesh, x: torch.Tensor, B: int) -> torch.Tensor:
    """Replicated [B]: every shard's lanes end to end."""
    return mesh.all_gather(x).reshape(-1)[:B]


def _backward_search_routed(index, mesh, pats_local, *, cap: int, key: int):
    arrays, meta = index.arrays, index.meta
    D = mesh.D
    Dl, B_local, P = pats_local.shape
    RR = 2 * B_local
    nseg_local = _nseg_local(index, mesh)
    rows_per_shard = nseg_local * meta.seg
    dev = pats_local.device
    first = torch.full((Dl, B_local), meta.row0, dtype=torch.int32,
                       device=dev)
    last = torch.full((Dl, B_local), meta.n_rows, dtype=torch.int32,
                      device=dev)
    rid = (shard_ids(mesh)[:, None] * RR
           + torch.arange(RR, dtype=torch.int32, device=dev)[None])
    C = arrays.C
    of = torch.zeros((), dtype=torch.int32, device=dev)
    for t in range(P):
        col = pats_local[:, :, P - 1 - t]
        kkey = bins.fold_in(key, t)
        active = col >= 0
        cd1 = R.map_char(arrays, col)
        rows = torch.cat([first, last], dim=1)
        cc = torch.cat([cd1, cd1], dim=1)
        dest = torch.clamp(torch.div(rows, rows_per_shard,
                                     rounding_mode="floor"), max=D - 1)
        recs, v, of1 = bins.valiant_exchange(mesh, dest, [rows, cc, rid],
                                             cap, kkey)
        vb = v.bool()
        vals = DO.owner_occ(arrays, torch.where(vb, recs[0], 0),
                            torch.where(vb, recs[1], -1), v,
                            nseg_local=nseg_local, shard0=mesh.shard0,
                            n_rows_total=D * rows_per_shard)
        back, v2, of2 = bins.valiant_exchange(
            mesh, torch.div(recs[2], RR, rounding_mode="floor"),
            [recs[2], vals], cap, bins.fold_in(kkey, 1), valid=v)
        o = torch.zeros((Dl, RR), dtype=torch.int32, device=dev)
        DO.owner_place(back[0], v2, [back[1]], [o], base_mul=RR,
                       shard0=mesh.shard0)
        valid_c = cd1 >= 0
        base = C[torch.where(valid_c, cd1, 0).long()]
        first = torch.where(active, torch.where(valid_c, base + o[:, :B_local],
                                                0), first)
        last = torch.where(active, torch.where(valid_c, base + o[:, B_local:],
                                               0), last)
        of = torch.maximum(of, torch.maximum(of1, of2))
    return first, last, of


def _backward_search_psum(index, mesh, pats):
    arrays, meta = index.arrays, index.meta
    B, P = pats.shape
    nseg_local = _nseg_local(index, mesh)
    first = torch.full((B,), meta.row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), meta.n_rows, dtype=torch.int32,
                      device=pats.device)
    for t in range(P):
        col = pats[:, P - 1 - t]
        active = col >= 0
        cd = R.map_char(arrays, torch.where(active, col, 0))
        valid = cd >= 0
        base = arrays.C[torch.where(valid, cd, 0).long()]
        o = mesh.psum(DO.masked_occ(
            arrays, torch.cat([cd, cd]), torch.cat([first, last]),
            Dl=mesh.Dl, nseg_local=nseg_local, shard0=mesh.shard0,
            n_rows_total=mesh.D * nseg_local * meta.seg))
        nf = torch.where(valid, base + o[:B], 0)
        nl = torch.where(valid, base + o[B:], 0)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return first, last


def sharded_backward_search(index: FMIndex, mesh, pats: np.ndarray,
                            routed: bool = True, cap_factor: float = 6.0,
                            max_retries: int = 3, seed: int = 0):
    """Count ranges over a sharded index.  pats: int32[B, P] right-aligned
    (-1 padded).  Returns (first, last), int32[B] replicated tensors on the
    mesh's device.  routed=True splits the lanes over the shards and routes
    each rank request to the row's owner; hot-row skew that overflows the
    exchange capacity retries with cap * 4, then falls back to the masked
    psum scheme."""
    _check_tier(index)
    pats = np.asarray(pats, np.int32)
    B = pats.shape[0]
    D = mesh.D
    if routed:
        pp = _lane_blocks(pats, mesh, -1)
        Bp = -(-B // D) * D
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * 2 * B_local / D)))
        for attempt in range(max_retries):
            first, last, of = _backward_search_routed(
                index, mesh, pp, cap=min(cap, 2 * Bp), key=seed + attempt)
            if int(of) <= 0:
                return (_gather_lanes(mesh, first, B),
                        _gather_lanes(mesh, last, B))
            cap *= 4
    return _backward_search_psum(index, mesh, _to_mesh(pats, mesh))


def _locate_routed(index, mesh, rows_local, *, cap: int, key: int):
    arrays, meta = index.arrays, index.meta
    D = mesh.D
    Dl, B_local = rows_local.shape
    nseg_local = _nseg_local(index, mesh)
    rows_per_shard = nseg_local * meta.seg
    dev = rows_local.device
    rid = (shard_ids(mesh)[:, None] * B_local
           + torch.arange(B_local, dtype=torch.int32, device=dev)[None])
    rows = rows_local
    offs = torch.full((Dl, B_local), -1, dtype=torch.int32, device=dev)
    done = torch.zeros((Dl, B_local), dtype=torch.bool, device=dev)
    of = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(meta.mark_period + 1):
        kkey = bins.fold_in(key, i)
        dest = torch.clamp(torch.div(rows, rows_per_shard,
                                     rounding_mode="floor"), max=D - 1)
        recs, v, of1 = bins.valiant_exchange(mesh, dest, [rows, rid], cap,
                                             kkey)
        ans = DO.owner_lf(arrays, recs[0], v, nseg_local=nseg_local,
                          shard0=mesh.shard0)
        back, v2, of2 = bins.valiant_exchange(
            mesh, torch.div(recs[1], B_local, rounding_mode="floor"),
            [recs[1], ans], cap, bins.fold_in(kkey, 1), valid=v)
        a = torch.zeros((Dl, B_local), dtype=torch.int32, device=dev)
        DO.owner_place(back[0], v2, [back[1]], [a], base_mul=B_local,
                       shard0=mesh.shard0)
        hit = (a >= 0) & ~done
        offs = torch.where(hit, a + i, offs)
        done = done | hit
        rows = torch.where(done, rows, -1 - a)
        of = torch.maximum(of, torch.maximum(of1, of2))
    return offs, of


def _locate_psum(index, mesh, rows):
    arrays, meta = index.arrays, index.meta
    nseg_local = _nseg_local(index, mesh)
    B = rows.shape[0]
    offs = torch.full((B,), -1, dtype=torch.int32, device=rows.device)
    done = torch.zeros(B, dtype=torch.bool, device=rows.device)
    for i in range(meta.mark_period + 1):
        ans = mesh.psum(DO.masked_lf(arrays, rows, Dl=mesh.Dl,
                                     nseg_local=nseg_local,
                                     shard0=mesh.shard0))
        hit = (ans >= 0) & ~done
        offs = torch.where(hit, ans + i, offs)
        done = done | hit
        rows = torch.where(done, rows, -1 - ans)
    return offs


def sharded_locate(index: FMIndex, mesh, rows: np.ndarray,
                   routed: bool = True, cap_factor: float = 6.0,
                   max_retries: int = 3, seed: int = 0) -> torch.Tensor:
    """Text offset of each row (int32[B] replicated) over a sharded index,
    by LF walks whose steps the rows' owners answer (routed, retried with
    a larger capacity on hot-row skew) or the masked psum walk."""
    _check_tier(index)
    rows = np.asarray(rows, np.int32)
    B = rows.shape[0]
    D = mesh.D
    if routed:
        rr = _lane_blocks(rows, mesh, 0)
        Bp = -(-B // D) * D
        B_local = Bp // D
        cap = max(16, int(np.ceil(cap_factor * B_local / D)))
        for attempt in range(max_retries):
            offs, of = _locate_routed(index, mesh, rr, cap=min(cap, Bp),
                                      key=seed + attempt)
            if int(of) <= 0:
                return _gather_lanes(mesh, offs, B)
            cap *= 4
    return _locate_psum(index, mesh, _to_mesh(rows, mesh))


def sharded_arrays_from_numpy(arrays_np: Mapping[str, np.ndarray], meta: Any,
                              mesh, **kw) -> FMIndex:
    """Carry a sharded index across: femto_tpu's sharded arrays as numpy
    (np.asarray of each global array: the shard blocks end to end) and its
    FMMeta -> the port's FMIndex of the process's blocks on the mesh's
    device (every block on a LocalMesh; its own on a DistMesh).  Other
    keywords go to fmindex.arrays_from_numpy."""
    arrays = {k: np.asarray(v) for k, v in arrays_np.items()
              if v is not None}
    if mesh.Dl != mesh.D:
        for k in SHARDED_FIELDS + ("occ_l1",):
            a = arrays.get(k)
            if a is None or (k == "occ_l1" and a.shape[0] <= 1):
                continue
            blk = a.shape[0] // mesh.D
            arrays[k] = a[mesh.shard0 * blk:(mesh.shard0 + mesh.Dl) * blk]
    return arrays_from_numpy(arrays, meta, device=mesh.device, **kw)
