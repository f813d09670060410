"""Record exchange over the mesh: capacity-padded bins.

The counterpart of femto_tpu/parallel/bins.py.  Senders bucket records by
destination shard into a [D, cap] buffer per column (kernel K18a's
bucket_pack, ops/dist_ops.py), and one all_to_all of the mesh delivers
every bucket.  Skew beyond ``cap`` is reported, never dropped in silence:
``overflow`` (the largest bucket's excess, a replicated int32 scalar on
the device, read by no exchange) is checked by the caller, which retries
with a larger capacity.  An exact exchange of uneven splits would need a
host read of the split sizes per exchange; the padded buffers keep every
exchange free of host syncs.

Every function takes per-shard tensors [Dl, mm] (parallel/mesh.py) and
returns per-shard tensors [Dl, D * cap], grouped by source shard.
Valiant intermediates come from a torch.Generator seeded from ``key`` and
the shard's index, so the routes differ from femto_tpu's jax.random ones;
what leaves the module does not.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..ops import dist_ops as DO
from .mesh import shard_ids

INT32_MAX = DO.INT32_MAX
_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from key and data (splitmix64's mixer), the
    counterpart of jax.random.fold_in."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def _valid_u8(valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    if valid is None or valid.dtype == torch.uint8:
        return valid
    return valid.to(torch.uint8)


def _pack(mesh, dest, records, cap, valid):
    """The send side of an exchange: (buffers, valid flags, overflow); the
    invalid lanes are dropped inside bucket_pack's launch."""
    return DO.bucket_pack(dest, list(records), D=mesh.D, cap=cap,
                          valid=_valid_u8(valid))


def _send(mesh, bufs, send_valid, over, cap):
    """The all_to_all of packed buffers, each freed once it is sent.

    bucket_pack puts its outputs in one allocation only up to
    dist_ops.ONE_ALLOCATION_BYTES of columns.  One allocation lives until
    its last view is freed, so above that it would hold every column sent
    so far beside its copy: (4 (ncols - 1) + 1) Dl D cap bytes more at the
    peak than one allocation a column.  At the sharded build's first call
    (chip_smoke.py phase 4h: 2^28 symbols on 4 shards, 5 columns, cap =
    m) that is about a third of the build's peak device memory (PERF.md,
    K18a), so large calls keep one allocation a column."""
    Dl, D = send_valid.shape[0], mesh.D
    sent = []
    while bufs:
        b = bufs.pop(0)
        sent.append(mesh.all_to_all(b.view(Dl, D, cap)).view(Dl, D * cap))
        del b
    recv_valid = mesh.all_to_all(send_valid.view(Dl, D, cap)).view(
        Dl, D * cap)
    return sent, recv_valid, mesh.pmax(over)


def exchange(mesh, dest: torch.Tensor, records: Sequence[torch.Tensor],
             cap: int, valid: Optional[torch.Tensor] = None):
    """Route records[i] to shard dest[i] (dest int32[Dl, mm] in [0, D);
    records int32[Dl, mm]; invalid lanes are not sent).  Returns
    (received int32[Dl, D*cap] per record, recv_valid uint8[Dl, D*cap],
    overflow int32 scalar: > 0 means records were dropped)."""
    bufs, send_valid, over = _pack(mesh, dest, records, cap, valid)
    return _send(mesh, bufs, send_valid, over, cap)


def random_dest(mesh, mm: int, key: int) -> torch.Tensor:
    """int32[Dl, mm] uniform shard indexes, each shard from its own
    generator (seeded from key and the shard's index)."""
    out = torch.empty((mesh.Dl, mm), dtype=torch.int32, device=mesh.device)
    for j in range(mesh.Dl):
        g = torch.Generator(device=mesh.device)
        g.manual_seed(fold_in(key, mesh.shard0 + j))
        out[j] = torch.randint(0, mesh.D, (mm,), generator=g,
                               device=mesh.device, dtype=torch.int32)
    return out


def valiant_exchange(mesh, dest: torch.Tensor,
                     records: Sequence[torch.Tensor], cap: int, key: int,
                     valid: Optional[torch.Tensor] = None):
    """Two-hop randomised (Valiant) exchange: each record first goes to a
    uniformly random shard, then to its destination, so every pair of
    shards carries about mm / D records a hop whatever the destinations.
    Same returns as exchange; overflow is the larger of the two hops'."""
    inter = random_dest(mesh, dest.shape[1], key)
    recs1, v1, of1 = exchange(mesh, inter, [dest] + list(records), cap,
                              valid)
    del inter
    # hop 2: pack, drop the first hop's buffers, then send
    packed = _pack(mesh, recs1[0], recs1[1:], cap, v1)
    del recs1, v1
    recs2, v2, of2 = _send(mesh, *packed, cap)
    return recs2, v2, torch.maximum(of1, of2)


def exchange_by_owner(mesh, gpos: torch.Tensor,
                      records: Sequence[torch.Tensor], m_owner: int,
                      cap: int, valid: Optional[torch.Tensor] = None):
    """Route each record to the shard owning global position gpos
    (gpos // m_owner).  Returns (received local positions, received
    records, recv_valid, overflow)."""
    owner = torch.div(gpos, m_owner, rounding_mode="floor").to(torch.int32)
    received, rvalid, overflow = exchange(
        mesh, owner, [gpos] + list(records), cap, valid)
    lpos = received[0] - shard_ids(mesh)[:, None] * m_owner
    return lpos, received[1:], rvalid, overflow


def place_by_owner(mesh, gpos: torch.Tensor,
                   records: Sequence[torch.Tensor], m_owner: int, cap: int,
                   fills: Sequence[torch.Tensor],
                   valid: Optional[torch.Tensor] = None):
    """Exchange records to the owners of their positions and place them
    in dense local blocks: out[r][gpos % m_owner] = records[r], over the
    fills int32[Dl, m_owner] (left in place).  Returns (outs, overflow)."""
    lpos, recs, rvalid, overflow = exchange_by_owner(
        mesh, gpos, records, m_owner, cap, valid)
    outs = list(fills)
    DO.owner_place(lpos, rvalid, recs, outs, base_mul=0, shard0=mesh.shard0)
    return outs, overflow
