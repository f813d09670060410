"""The sharded build's and sharded queries' device steps (K18a-K18f):
kernel wrappers + plain versions.

The counterparts of the shard_map bodies of femto_tpu/parallel/ (bins.py,
dist_sort.py, dist_build.py, dist_query.py).  Every tensor here carries
the shards a process holds along a leading dimension Dl (parallel/mesh.py:
all D shards on a LocalMesh, one on a DistMesh); ``shard0`` is the global
index of the first of them, and each kernel runs the shard dimension as
``blockIdx.y``, so one launch serves every local shard.  The collectives
between the steps are the mesh's (parallel/mesh.py), never a kernel's.

  K18a csrc/exchange.cu     bucket_pack (bins.exchange's bucketing and
                            capacity-padded scatter), owner_place (every
                            ``.at[idx].set`` of routed or replicated
                            records into a shard's block)
  K18b csrc/sample_sort.cu  splitter_bucket, rebalance_local and
                            rebalance_place (dist_sort's rebalance, one
                            kernel),
                            mesh_exclusive (the exclusive prefix over the
                            mesh of per-shard totals), add_base (a base
                            added to a shard's checkpoints) and
                            add_mesh_base (the base summed from the mesh's
                            totals inside add_base's kernel, one launch)
  K18c csrc/dist_rounds.cu  seed_keys, payload_block, mesh_flags,
                            mesh_scan, compact_rows, fetch_owned (the
                            suffix sort's per-shard bodies and the
                            replicated epilogue's psum fetches; the scan
                            and the compaction each one tile pass with a
                            decoupled look-back)
  K18f csrc/dist_query.cu   owner_occ, owner_lf (the routed schemes'
                            owner answers), masked_occ, masked_lf (the
                            psum schemes' local parts), masked_occ_rows
                            (every symbol's masked_occ at each row: the
                            sharded frontier's ranks), on all five
                            layouts

The local sorts of dist_sort and of the replicated epilogue run through
kernel H (radix_sort_pairs) and L (gather_rows), the packaging through A,
A', F and B (ops/build_ops.py).  Each wrapper launches its kernel for
tensors on the card and takes the plain PyTorch version beside it for
tensors on the CPU; a CUDA tensor never falls back.  Everything is
integers: kernel and plain version agree bit for bit.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import torch

from .. import kernels
from ..alphabet import ALPHA_SIZE
from ..fmindex import FMArrays
from . import rank as R
from .search_ops import _index_tensors, fm_view

INT32_MAX = 2**31 - 1
MAX_COLS = 8          # csrc/exchange.cu kMaxCols
MAX_BUCKETS = 128     # csrc/exchange.cu kMaxBuckets (D + 1 buckets)
PLACE_COLS = 4        # csrc/exchange.cu owner_place columns per launch
REBALANCE_COLS = 6    # csrc/sample_sort.cu kRebalanceCols
REBALANCE_WINDOW = 3  # csrc/sample_sort.cu kMaxWindow (dist_sort's W)
MAX_COLUMNS = 1024    # csrc/sample_sort.cu kMaxColumns (the prefix's A)
MAX_KEYS = 4          # csrc/sample_sort.cu kMaxKeys (splitter keys)
FLAG_KEYS = 6         # csrc/dist_rounds.cu kFlagKeys (mesh_flags keys)
COMPACT_COLS = 8      # csrc/dist_rounds.cu kMaxCols (compact_rows columns)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _ptrs(ts: Sequence[Optional[torch.Tensor]], k: int) -> List:
    return [_ptr(t) for t in ts] + [None] * (k - len(ts))


# ---------------------------------------------------------------------------
# K18a: bucketing by destination, owner placement
# ---------------------------------------------------------------------------


def bucket_pack_plain(dest: torch.Tensor, cols: Sequence[torch.Tensor], *,
                      D: int, cap: int,
                      valid: Optional[torch.Tensor] = None):
    Dl, mm = dest.shape
    dev = dest.device
    bufs = [torch.zeros((Dl, D * cap), dtype=torch.int32, device=dev)
            for _ in cols]
    vout = torch.zeros((Dl, D * cap), dtype=torch.uint8, device=dev)
    over = torch.empty(Dl, dtype=torch.int32, device=dev)
    for j in range(Dl):
        d = dest[j].long()
        d = torch.where((d < 0) | (d > D), D, d)
        if valid is not None:
            d = torch.where(valid[j].bool(), d, D)
        order = torch.sort(d, stable=True)[1]
        ds = d[order]
        counts = torch.bincount(ds, minlength=D + 1)
        starts = torch.cumsum(counts, 0) - counts
        pos = torch.arange(mm, device=dev) - starts[ds]
        ok = (pos < cap) & (ds < D)
        slot = (ds * cap + pos)[ok]
        vout[j, slot] = 1
        for b, c in zip(bufs, cols):
            b[j, slot] = c[j][order][ok]
        over[j] = int(counts[:D].max()) - cap
    return bufs, vout, over


# Output bytes up to which bucket_pack puts its columns in its one
# allocation with the flags and the overflow; above it each column is an
# allocation of its own, so that parallel/bins.py frees each once it is
# sent (one allocation would hold every column until the last one is
# sent: bins.py says what that would cost).
ONE_ALLOCATION_BYTES = 1 << 26


def _pack_out(Dl: int, W: int, ncols: int, scratch: int, dev):
    """bucket_pack's outputs (ncols columns int32[Dl, W], the flags
    uint8[Dl, W], over int32[Dl]) and its scratch (int32[scratch], or
    None), as views of one int32 allocation: the scratch first (its status
    words 8-byte aligned), then over, the columns where they are at most
    ONE_ALLOCATION_BYTES (else one allocation each), the flags last."""
    S = Dl * W
    whole = 4 * ncols * S <= ONE_ALLOCATION_BYTES
    nv = -(-S // 4)
    sizes = [scratch, Dl] + ([ncols * S] if whole else []) + [nv]
    parts = torch.empty(sum(sizes), dtype=torch.int32,
                        device=dev).split(sizes)
    if whole:
        bufs = list(parts[2].view(ncols, Dl, W).unbind(0))
    else:
        bufs = [torch.empty((Dl, W), dtype=torch.int32, device=dev)
                for _ in range(ncols)]
    vout = parts[-1].view(torch.uint8)
    if 4 * nv != S:
        vout = vout[:S]
    return bufs, vout.view(Dl, W), parts[1], parts[0] if scratch else None


def bucket_pack(dest: torch.Tensor, cols: Sequence[torch.Tensor], *, D: int,
                cap: int, valid: Optional[torch.Tensor] = None):
    """Records of each shard bucketed by destination: dest int32[Dl, mm] in
    [0, D] (D drops the record), cols int32[Dl, mm] each, valid uint8[Dl,
    mm] or None (0 drops the record).  Returns (bufs int32[Dl, D*cap] per
    column, valid uint8[Dl, D*cap], over int32[Dl]): a record with the
    p-th lowest index among those of its bucket d lands in slot d*cap + p
    when p < cap (bins.exchange's stable argsort); the other slots hold 0;
    over = max over d < D of the bucket's size - cap.  Kernel K18a on the
    card: one launch a call (and, above one block's records a shard, one
    memset of its scratch); the outputs are views of one allocation
    (_pack_out)."""
    kernels.check(dest, "dest", torch.int32, 2)
    Dl, mm = dest.shape
    for i, c in enumerate(cols):
        kernels.check(c, f"cols[{i}]", torch.int32, 2, (Dl, mm))
    if valid is not None:
        kernels.check(valid, "valid", torch.uint8, 2, (Dl, mm))
    if not 1 <= len(cols) <= MAX_COLS or not 1 <= D < MAX_BUCKETS \
            or cap < 1:
        raise ValueError(f"need 1 to {MAX_COLS} columns, 1 <= D < "
                         f"{MAX_BUCKETS} and cap >= 1")
    ts = [dest, *cols] + ([valid] if valid is not None else [])
    if not kernels.on_card(*ts):
        return bucket_pack_plain(dest, cols, D=D, cap=cap, valid=valid)
    bufs, vout, over, scratch = _pack_out(
        Dl, D * cap, len(cols), kernels.size("bucket_pack_scratch", mm, Dl, D),
        dest.device)
    kernels.launch("bucket_pack", dest.data_ptr(), _ptr(valid), mm, Dl, D,
                   cap, len(cols), *_ptrs(cols, MAX_COLS),
                   *_ptrs(bufs, MAX_COLS), vout.data_ptr(), over.data_ptr(),
                   _ptr(scratch))
    return bufs, vout, over


def owner_place_plain(idx, valid, recs, outs, *, base_mul: int, shard0: int):
    Dl, M = outs[0].shape
    rep = idx.dim() == 1
    for j in range(Dl):
        ij = (idx if rep else idx[j]).long() - (shard0 + j) * base_mul
        ok = (ij >= 0) & (ij < M)
        if valid is not None:
            ok &= (valid if rep else valid[j]).bool()
        for r, o in zip(recs, outs):
            o[j, ij[ok]] = (r if rep else r[j])[ok]


def owner_place(idx: torch.Tensor, valid: Optional[torch.Tensor],
                recs: Sequence[torch.Tensor], outs: Sequence[torch.Tensor],
                *, base_mul: int, shard0: int) -> None:
    """In place: outs[c][d, idx - (shard0 + d) * base_mul] = recs[c] for
    every record whose index falls in shard d's block [0, M) (and whose
    valid flag is set).  idx, valid, recs: [Dl, mm] per shard, or [mm]
    replicated (every shard sees every record and keeps its own); outs
    [Dl, M], int32 or uint8 like recs.  Kernel K18a on the card."""
    Dl, M = outs[0].shape
    rep = idx.dim() == 1
    kernels.check(idx, "idx", torch.int32, idx.dim())
    mm = idx.shape[-1]
    shape = (mm,) if rep else (Dl, mm)
    if not rep and idx.shape[0] != Dl:
        raise ValueError("idx must have the outputs' shard dimension")
    if valid is not None:
        kernels.check(valid, "valid", torch.uint8, len(shape), shape)
    dt = outs[0].dtype
    if dt not in (torch.int32, torch.uint8):
        raise ValueError("owner_place places int32 or uint8 columns")
    for i, (r, o) in enumerate(zip(recs, outs)):
        kernels.check(r, f"recs[{i}]", dt, len(shape), shape)
        kernels.check(o, f"outs[{i}]", dt, 2, (Dl, M))
    if len(recs) != len(outs) or not recs:
        raise ValueError("need one output per record column")
    if len(recs) > PLACE_COLS:
        for i in range(0, len(recs), PLACE_COLS):
            owner_place(idx, valid, recs[i:i + PLACE_COLS],
                        outs[i:i + PLACE_COLS], base_mul=base_mul,
                        shard0=shard0)
        return None
    ts = [idx, *recs, *outs] + ([valid] if valid is not None else [])
    if not kernels.on_card(*ts):
        return owner_place_plain(idx, valid, recs, outs, base_mul=base_mul,
                                 shard0=shard0)
    if mm:
        kernels.launch("owner_place", idx.data_ptr(), _ptr(valid), mm, Dl,
                       0 if rep else mm, shard0, base_mul, M,
                       outs[0].element_size(), len(recs),
                       *_ptrs(recs, PLACE_COLS), *_ptrs(outs, PLACE_COLS))


# ---------------------------------------------------------------------------
# K18b: splitters, rebalance, the prefix over the mesh
# ---------------------------------------------------------------------------


def _lex_less(a, b):
    """a < b lexicographically (lists of broadcastable int tensors)."""
    lt = torch.zeros(torch.broadcast_shapes(a[0].shape, b[0].shape),
                     dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(lt)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def splitter_bucket_plain(keys, splitters):
    ks = [k[:, :, None] for k in keys]
    ss = [s[None, None, :] for s in splitters]
    return _lex_less(ss, ks).sum(dim=2).to(torch.int32)


def splitter_bucket(keys: Sequence[torch.Tensor],
                    splitters: Sequence[torch.Tensor]) -> torch.Tensor:
    """Bucket of each key tuple (keys int32[Dl, m] each): the number of
    sorted splitter tuples (int32[S] each, replicated) lexicographically
    below it (dist_sort._bucket_of), int32[Dl, m].  Kernel K18b on the
    card: a binary search per key."""
    kernels.check(keys[0], "keys[0]", torch.int32, 2)
    shape = tuple(keys[0].shape)
    S = splitters[0].shape[0]
    for i, (k, s) in enumerate(zip(keys, splitters)):
        kernels.check(k, f"keys[{i}]", torch.int32, 2, shape)
        kernels.check(s, f"splitters[{i}]", torch.int32, 1, (S,))
    if not 1 <= len(keys) == len(splitters) <= MAX_KEYS:
        raise ValueError(f"need 1 to {MAX_KEYS} key columns")
    if not kernels.on_card(*keys, *splitters):
        return splitter_bucket_plain(keys, splitters)
    dest = torch.empty(shape, dtype=torch.int32, device=keys[0].device)
    kernels.launch("splitter_bucket", *_ptrs(keys, MAX_KEYS), len(keys),
                   shape[1], shape[0], *_ptrs(splitters, MAX_KEYS), S,
                   dest.data_ptr())
    return dest


def _check_rebalance(cols, v, base, m):
    """(Dl, R) of the rebalance's inputs, after checking them."""
    kernels.check(cols[0], "cols[0]", torch.int32, 2)
    Dl, Rn = cols[0].shape
    for i, c in enumerate(cols):
        kernels.check(c, f"cols[{i}]", torch.int32, 2, (Dl, Rn))
    kernels.check(v, "v", torch.int32, 1, (Dl,))
    kernels.check(base, "base", torch.int32, 1, (Dl,))
    if not 1 <= len(cols) <= REBALANCE_COLS or m < 1:
        raise ValueError(f"need 1 to {REBALANCE_COLS} columns and m >= 1")
    return Dl, Rn


def rebalance_local_plain(cols, v, base, *, m, W, shard0):
    Dl, Rn = cols[0].shape
    dev = cols[0].device
    outs = [torch.full((Dl, m), INT32_MAX, dtype=torch.int32, device=dev)
            for _ in cols]
    far = torch.zeros(Dl, dtype=torch.int32, device=dev)
    i = torch.arange(Rn, device=dev)
    # the highest shard first, so that the lowest wins where two overlap
    for j in reversed(range(Dl)):
        me = shard0 + j
        ok = i < int(v[j])
        gpos = int(base[j]) + i
        owner = gpos // m
        far[j] = int((ok & ((owner - me).abs() > W)).any())
        sel = (ok & ((owner - me).abs() <= W) & (owner >= shard0)
               & (owner < shard0 + Dl))
        place = (gpos - shard0 * m)[sel]
        for o, c in zip(outs, cols):
            o.view(-1)[place] = c[j][sel]
    return outs, far


def rebalance_local(cols: Sequence[torch.Tensor], v: torch.Tensor,
                    base: torch.Tensor, *, m: int, W: int, shard0: int):
    """dist_sort's rebalance of every record whose owner shard is local:
    element i < v[d] of shard d's sorted received records (cols int32[Dl,
    R] each) sits at global position base[d] + i and belongs to shard
    (base[d] + i) // m; one whose owner is a local shard at most W shards
    from d lands at its place in that shard's block.  Returns (outs
    int32[Dl, m] per column, INT32_MAX at the places no local record
    fills; far int32[Dl], 1 where a record's owner lies more than W shards
    away, its record left out).  Where two shards' records would fill one
    place (never when base is the exclusive prefix of v) the lower shard's
    wins, as the per-offset merge's did.  On a LocalMesh that is the whole
    rebalance.  Kernel K18b on the card (its rebalance kernel): one launch,
    each place written once."""
    Dl, Rn = _check_rebalance(cols, v, base, m)
    if not 0 <= W <= REBALANCE_WINDOW:
        raise ValueError(f"need 0 <= W <= {REBALANCE_WINDOW}")
    if not kernels.on_card(*cols, v, base):
        return rebalance_local_plain(cols, v, base, m=m, W=W, shard0=shard0)
    outs = [torch.empty((Dl, m), dtype=torch.int32, device=v.device)
            for _ in cols]
    far = torch.empty(Dl, dtype=torch.int32, device=v.device)
    kernels.launch("rebalance_local", *_ptrs(cols, REBALANCE_COLS),
                   len(cols), Rn, v.data_ptr(), base.data_ptr(), Dl, shard0,
                   m, W, *_ptrs(outs, REBALANCE_COLS), far.data_ptr())
    return outs, far


def rebalance_place_plain(cols, v, base, *, m, off, shard0):
    Dl, Rn = cols[0].shape
    dev = cols[0].device
    bufs = [torch.zeros((Dl, m), dtype=torch.int32, device=dev)
            for _ in cols]
    vbuf = torch.zeros((Dl, m), dtype=torch.uint8, device=dev)
    i = torch.arange(Rn, device=dev)
    for j in range(Dl):
        me = shard0 + j
        ok = i < int(v[j])
        gpos = int(base[j]) + i
        sel = ok & (gpos // m == me + off)
        p = (gpos - (me + off) * m)[sel]
        vbuf[j, p] = 1
        for b, c in zip(bufs, cols):
            b[j, p] = c[j][sel]
    return bufs, vbuf


def rebalance_place(cols: Sequence[torch.Tensor], v: torch.Tensor,
                    base: torch.Tensor, *, m: int, off: int, shard0: int):
    """dist_sort's windowed rebalance, one offset, for owners in another
    process (a DistMesh): the records of shard d (as rebalance_local's)
    that shard d + off owns go to their place in a buffer of its block,
    for the mesh's ppermute.  Returns (bufs int32[Dl, m] per column, 0
    where no record lands; vbuf uint8[Dl, m], 1 where one does).  Kernel
    K18b on the card (rebalance_local's kernel), one offset a launch."""
    Dl, Rn = _check_rebalance(cols, v, base, m)
    if not kernels.on_card(*cols, v, base):
        return rebalance_place_plain(cols, v, base, m=m, off=off,
                                     shard0=shard0)
    dev = v.device
    bufs = [torch.empty((Dl, m), dtype=torch.int32, device=dev)
            for _ in cols]
    vbuf = torch.empty((Dl, m), dtype=torch.uint8, device=dev)
    kernels.launch("rebalance_place", *_ptrs(cols, REBALANCE_COLS),
                   len(cols), Rn, v.data_ptr(), base.data_ptr(), Dl, shard0,
                   m, off, *_ptrs(bufs, REBALANCE_COLS), vbuf.data_ptr())
    return bufs, vbuf


def mesh_exclusive_plain(gathered, *, shard0, Dl, op, want_c):
    D, A = gathered.shape
    g = gathered.long()
    base = torch.zeros((Dl, A), dtype=torch.int64, device=g.device)
    for j in range(Dl):
        before = g[: shard0 + j]
        if before.shape[0]:
            base[j] = before.sum(0) if op == "sum" else \
                torch.clamp(before.amax(0), min=0)
    C = None
    if want_c:
        C = torch.zeros(A + 1, dtype=torch.int64, device=g.device)
        C[1:] = torch.cumsum(g.sum(0), 0)
        C = C.to(torch.int32)
    return base.to(torch.int32), C


def _prefix_out(Dl: int, A: int, want_base: bool, want_c: bool, dev):
    """The prefix's outputs, base int32[Dl, A] and C int32[A + 1] (each
    or None), in one allocation (views of one int32 buffer when both)."""
    if not want_c:
        return (torch.empty((Dl, A), dtype=torch.int32, device=dev)
                if want_base else None), None
    if not want_base:
        return None, torch.empty(A + 1, dtype=torch.int32, device=dev)
    buf = torch.empty(Dl * A + A + 1, dtype=torch.int32, device=dev)
    return buf[: Dl * A].view(Dl, A), buf[Dl * A:]


def _check_columns(A: int) -> None:
    if not 1 <= A <= MAX_COLUMNS:
        raise ValueError(f"need 1 to {MAX_COLUMNS} columns, got {A}")


def mesh_exclusive(gathered: torch.Tensor, *, shard0: int, Dl: int,
                   op: str = "sum", want_c: bool = False):
    """The exclusive prefix over the mesh of per-shard values (gathered
    int32[D, A], every shard's row): base[d] = the sum (op "sum") or the
    largest value, at least 0 (op "max"), of the rows of the shards before
    shard shard0 + d, int32[Dl, A]; with ``want_c`` also C int32[A + 1],
    the exclusive scan over the columns of the rows' sum (the global C of
    an occ table).  dist_build._exclusive_base / _group_state's carry;
    where the base only feeds add_base, add_mesh_base does both.  Kernel
    K18b on the card (one block)."""
    kernels.check(gathered, "gathered", torch.int32, 2)
    D, A = gathered.shape
    _check_columns(A)
    if op not in ("sum", "max"):
        raise ValueError("op must be 'sum' or 'max'")
    if not kernels.on_card(gathered):
        return mesh_exclusive_plain(gathered, shard0=shard0, Dl=Dl, op=op,
                                    want_c=want_c)
    base, C = _prefix_out(Dl, A, True, want_c, gathered.device)
    kernels.launch("mesh_exclusive", gathered.data_ptr(), D, A, shard0, Dl,
                   0 if op == "sum" else 1, base.data_ptr(), _ptr(C))
    return base, C


def add_base_plain(x, base):
    x += base[:, None, :]


def add_base(x: torch.Tensor, base: torch.Tensor) -> None:
    """In place: x[d, i, :] += base[d, :] (x int32[Dl, rows, A], base
    int32[Dl, A], A <= MAX_COLUMNS): a shard's checkpoints made global.
    Kernel K18b."""
    kernels.check(x, "x", torch.int32, 3)
    Dl, rows, A = x.shape
    kernels.check(base, "base", torch.int32, 2, (Dl, A))
    _check_columns(A)
    if not kernels.on_card(x, base):
        return add_base_plain(x, base)
    if rows:
        kernels.launch("add_base", x.data_ptr(), base.data_ptr(), rows, A, Dl)


def add_mesh_base_plain(x, gathered, *, shard0, want_base, want_c):
    base, C = mesh_exclusive_plain(gathered, shard0=shard0, Dl=x.shape[0],
                                   op="sum", want_c=want_c)
    add_base_plain(x, base)
    return (base if want_base else None), C


def add_mesh_base(x: torch.Tensor, gathered: torch.Tensor, *, shard0: int,
                  want_base: bool = False, want_c: bool = False):
    """mesh_exclusive (op "sum") then add_base in one launch: x[d, i, :]
    += base[d, :] in place, where base[d] is the sum of gathered int32[D,
    A]'s rows of the shards before shard0 + d (x int32[Dl, rows, A]).
    Returns (base int32[Dl, A] if ``want_base``, C int32[A + 1] if
    ``want_c``), each else None: the global checkpoints of
    dist_build._shard_occ_base (occ_ckpt or the L1 rows, with C) and
    _shard_marks (mark_ckpt, A = 1, with mark_base).  Kernel K18b's
    add_base kernel through its own entry, add_mesh_base: every block sums
    its shard's base from `gathered`, one block scans C; launched with no
    rows too, for C and the base."""
    kernels.check(x, "x", torch.int32, 3)
    Dl, rows, A = x.shape
    kernels.check(gathered, "gathered", torch.int32, 2)
    D = gathered.shape[0]
    kernels.check(gathered, "gathered", torch.int32, 2, (D, A))
    _check_columns(A)
    if not 0 <= shard0 <= D - Dl:
        raise ValueError(f"shards {shard0}..{shard0 + Dl - 1} outside a mesh "
                         f"of {D}")
    if not kernels.on_card(x, gathered):
        return add_mesh_base_plain(x, gathered, shard0=shard0,
                                   want_base=want_base, want_c=want_c)
    base, C = _prefix_out(Dl, A, want_base, want_c, x.device)
    kernels.launch("add_mesh_base", x.data_ptr(), rows, A, Dl,
                   gathered.data_ptr(), D, shard0, _ptr(base), _ptr(C))
    return base, C


# ---------------------------------------------------------------------------
# K18c / K18d: the suffix sort's per-shard bodies
# ---------------------------------------------------------------------------


def seed_keys_plain(text_ext, lut, *, m, n, n_pad, per_key, bits, nkeys,
                    shard0):
    Dl, Lx = text_ext.shape
    dev = text_ext.device
    codes = lut.long()[text_ext.long()]
    j = torch.arange(Lx, device=dev)
    out = []
    for q in range(nkeys):
        keys = torch.empty((Dl, m), dtype=torch.int32, device=dev)
        for d in range(Dl):
            gj = (shard0 + d) * m + j
            ce = torch.where(gj < n_pad, codes[d], 0)
            p0 = q * per_key
            key = torch.zeros(m, dtype=torch.int64, device=dev)
            for t in range(per_key):
                key |= ce[p0 + t: p0 + t + m] << ((per_key - 1 - t) * bits)
            g0 = gj[p0: p0 + m]
            keys[d] = torch.where(g0 >= n, -1 - g0, key).to(torch.int32)
        out.append(keys)
    return out


def seed_keys(text_ext: torch.Tensor, lut: torch.Tensor, *, m: int, n: int,
              n_pad: int, per_key: int, bits: int, nkeys: int,
              shard0: int) -> List[torch.Tensor]:
    """dist_build._seed_keys: the nkeys packed 30-bit seed keys of every
    suffix of each shard's block (int32[Dl, m] each), from the block and
    its right halo (text_ext int32[Dl, m + H], H >= per_key * nkeys) and
    the dense remap lut int32[512].  key q of position p packs the codes
    at p + q*per_key ... (0 past n_pad, first highest); a window that
    starts at a global position i >= n is the distinct negative -1 - i.
    Kernel K18c on the card."""
    kernels.check(text_ext, "text_ext", torch.int32, 2)
    kernels.check(lut, "lut", torch.int32, 1, (512,))
    Dl, Lx = text_ext.shape
    if not 1 <= nkeys <= 3 or Lx < m + per_key * nkeys - 1:
        raise ValueError("need 1 <= nkeys <= 3 and a halo of per_key * "
                         "nkeys - 1 symbols")
    if not kernels.on_card(text_ext, lut):
        return seed_keys_plain(text_ext, lut, m=m, n=n, n_pad=n_pad,
                               per_key=per_key, bits=bits, nkeys=nkeys,
                               shard0=shard0)
    keys = [torch.empty((Dl, m), dtype=torch.int32, device=text_ext.device)
            for _ in range(nkeys)]
    kernels.launch("seed_keys", text_ext.data_ptr(), Lx, m, Dl, shard0, n,
                   n_pad, lut.data_ptr(), per_key, bits, nkeys,
                   *_ptrs(keys, 3))
    return keys


def payload_block_plain(text, prev_last, doc_starts, *, n, mark_period,
                        ndocs, shard0):
    Dl, m = text.shape
    dev = text.device
    ds = doc_starts.long()
    out = torch.empty((Dl, m), dtype=torch.int32, device=dev)
    for d in range(Dl):
        g0 = (shard0 + d) * m
        gidx = g0 + torch.arange(m, device=dev)
        tag = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        lse = ds[1:] - 1 - g0
        ok = (lse >= 0) & (lse < m)
        tag[torch.where(ok, lse, m)] = torch.arange(1, ndocs + 1, device=dev)
        tag = tag[:m]
        is_start = torch.zeros(m + 1, dtype=torch.bool, device=dev)
        lst = ds[:-1] - g0
        ok = (lst >= 0) & (lst < m)
        is_start[torch.where(ok, lst, m)] = True
        is_start = is_start[:m]
        if mark_period == 0:
            marked = torch.zeros(m, dtype=torch.bool, device=dev)
        else:
            marked = is_start | (tag > 0) | (gidx % mark_period == 0)
        valid = gidx < n
        marked = marked & valid
        tag = torch.where(valid, tag, 0)
        aux = marked.long() | (tag << 1)
        t = text[d].long()
        t_prev = torch.cat([prev_last[d: d + 1].long(), t[:-1]])
        out[d] = (t_prev | (aux << 9)).to(torch.int32)
    return out


def payload_block(text: torch.Tensor, prev_last: torch.Tensor,
                  doc_starts: torch.Tensor, *, n: int, mark_period: int,
                  ndocs: int, shard0: int) -> torch.Tensor:
    """dist_build._payload_block: payload[p] = text[p - 1] | aux[p] << 9
    per shard block (int32[Dl, m]; prev_last int32[Dl] the last symbol of
    the shard before), aux bit 0 = mark sampled (doc start, SEOF, or the
    global period grid; only below n), bits 1.. = doc id + 1 at the doc's
    SEOF position.  Kernel K18c on the card."""
    kernels.check(text, "text", torch.int32, 2)
    Dl, m = text.shape
    kernels.check(prev_last, "prev_last", torch.int32, 1, (Dl,))
    kernels.check(doc_starts, "doc_starts", torch.int32, 1, (ndocs + 1,))
    if not kernels.on_card(text, prev_last, doc_starts):
        return payload_block_plain(text, prev_last, doc_starts, n=n,
                                   mark_period=mark_period, ndocs=ndocs,
                                   shard0=shard0)
    out = torch.empty((Dl, m), dtype=torch.int32, device=text.device)
    kernels.launch("payload_block", text.data_ptr(), prev_last.data_ptr(), m,
                   Dl, shard0, n, doc_starts.data_ptr(), ndocs, mark_period,
                   out.data_ptr())
    return out


def mesh_flags_plain(keys, prev, *, shard0, first):
    Dl, m = keys[0].shape
    neq = torch.zeros((Dl, m), dtype=torch.bool, device=keys[0].device)
    for k, p in zip(keys, prev):
        shifted = torch.cat([p[:, None], k[:, :-1]], dim=1)
        neq |= k != shifted
    if shard0 == 0:
        neq[0, 0] = bool(first)
    return neq.to(torch.uint8)


def mesh_flags(keys: Sequence[torch.Tensor], prev: Sequence[torch.Tensor],
               *, shard0: int, first: bool) -> torch.Tensor:
    """uint8[Dl, m]: 1 where a sorted slot's key tuple differs from the
    slot before it (keys int32[Dl, m] each; prev int32[Dl] each, the last
    key of the shard before); the global slot 0 gets ``first`` (group
    starts: True, _rank_refine's diff: False).  Kernel K18c on the card."""
    if not 1 <= len(keys) == len(prev) <= FLAG_KEYS:
        raise ValueError(f"need 1 to {FLAG_KEYS} key columns, each with "
                         f"its prev")
    kernels.check(keys[0], "keys[0]", torch.int32, 2)
    Dl, m = keys[0].shape
    for i, (k, p) in enumerate(zip(keys, prev)):
        kernels.check(k, f"keys[{i}]", torch.int32, 2, (Dl, m))
        kernels.check(p, f"prev[{i}]", torch.int32, 1, (Dl,))
    if not kernels.on_card(*keys, *prev):
        return mesh_flags_plain(keys, prev, shard0=shard0, first=first)
    out = torch.empty((Dl, m), dtype=torch.uint8, device=keys[0].device)
    kernels.launch("mesh_flags", *_ptrs(keys, FLAG_KEYS), len(keys),
                   *_ptrs(prev, FLAG_KEYS), m, Dl, shard0, int(first),
                   out.data_ptr())
    return out


def mesh_scan_plain(flags, *, mode, shard0, slots):
    Dl, m = flags.shape
    f = flags.bool()
    if mode == "sum":
        out = torch.cumsum(f.to(torch.int32), dim=1).to(torch.int32)
    else:
        if slots is None:
            slots = (shard0 + torch.arange(Dl, device=f.device)[:, None]) \
                * m + torch.arange(m, device=f.device)[None, :]
        out = torch.cummax(torch.where(f, slots.to(torch.int32), 0),
                           dim=1).values.to(torch.int32)
    return out, out[:, -1].contiguous()


def _with_scratch(scratch: int, sizes: Sequence[int], dev):
    """int32 views of one allocation: the scratch first (16-byte aligned,
    its status words 8-byte aligned), then each of `sizes`, each from a
    16-byte boundary."""
    pads = [scratch] + [-(-n // 4) * 4 for n in sizes]
    parts = torch.empty(sum(pads), dtype=torch.int32, device=dev).split(pads)
    return parts[0], [p[:n] for p, n in zip(parts[1:], sizes)]


def mesh_scan(flags: torch.Tensor, *, mode: str, shard0: int,
              slots: Optional[torch.Tensor] = None):
    """Inclusive scans along each shard's block of uint8 flags: mode "sum"
    counts the flags; mode "max" carries the last flagged slot (cummax of
    flag ? slot : 0, the slot the global index (shard0 + d) * m + p or,
    given, slots int32[Dl, m]).  Returns (out int32[Dl, m], last int32[Dl]
    = out[:, -1]).  Kernel K18c on the card: one launch a call, a single
    pass with a decoupled look-back, its scratch in the outputs'
    allocation (zeroed by one memset)."""
    kernels.check(flags, "flags", torch.uint8, 2)
    Dl, m = flags.shape
    if mode not in ("sum", "max") or m == 0:
        raise ValueError("mode must be 'sum' or 'max', and m > 0")
    if slots is not None:
        kernels.check(slots, "slots", torch.int32, 2, (Dl, m))
    ts = [flags] + ([slots] if slots is not None else [])
    if not kernels.on_card(*ts):
        return mesh_scan_plain(flags, mode=mode, shard0=shard0, slots=slots)
    scratch, (out, last) = _with_scratch(
        kernels.size("scan_scratch", m, Dl), [Dl * m, Dl], flags.device)
    kernels.launch("mesh_scan", flags.data_ptr(), _ptr(slots), m, Dl, shard0,
                   0 if mode == "sum" else 1, out.data_ptr(), last.data_ptr(),
                   scratch.data_ptr())
    return out.view(Dl, m), last


def compact_rows_plain(flags, off, cols, *, M, fills, shard0):
    Dl, m = flags.shape
    dev = flags.device
    outs = [torch.full((Dl, M), f, dtype=torch.int32, device=dev)
            for f in fills]
    p = torch.arange(m, device=dev)
    rank = torch.cumsum(flags.bool().to(torch.int64), dim=1)
    for d in range(Dl):
        k = int(off[d]) + rank[d] - 1
        ok = flags[d].bool() & (k < M)
        for c, o in zip(cols, outs):
            v = (shard0 + d) * m + p if c is None else c[d].long()
            o[d, k[ok]] = v[ok].to(torch.int32)
    return outs


def compact_rows(flags: torch.Tensor, off: torch.Tensor,
                 cols: Sequence[Optional[torch.Tensor]], *, M: int,
                 fills: Sequence[int], shard0: int) -> List[torch.Tensor]:
    """Stream compaction of the flagged slots of each shard: the flagged
    slot with inclusive count r in its shard's flags goes to off[d] + r - 1
    (off int32[Dl], >= 0) when that is below M, taking each column's value
    there (None: the slot's global index (shard0 + d) * m + p).  Returns
    int32[Dl, M] per column, ``fills`` elsewhere.  Kernel K18d on the card:
    it ranks the flags itself, one launch for up to COMPACT_COLS columns
    (a launch each COMPACT_COLS above), every output place written once
    inside it; the outputs and the scratch are one allocation."""
    kernels.check(flags, "flags", torch.uint8, 2)
    Dl, m = flags.shape
    kernels.check(off, "off", torch.int32, 1, (Dl,))
    for i, c in enumerate(cols):
        if c is not None:
            kernels.check(c, f"cols[{i}]", torch.int32, 2, (Dl, m))
    if not cols or len(cols) != len(fills):
        raise ValueError("need at least one column, each with its fill")
    if len(cols) > COMPACT_COLS:
        return [o for i in range(0, len(cols), COMPACT_COLS)
                for o in compact_rows(flags, off, cols[i:i + COMPACT_COLS],
                                      M=M, fills=fills[i:i + COMPACT_COLS],
                                      shard0=shard0)]
    ts = [flags, off] + [c for c in cols if c is not None]
    if not kernels.on_card(*ts):
        return compact_rows_plain(flags, off, cols, M=M, fills=fills,
                                  shard0=shard0)
    scratch, outs = _with_scratch(kernels.size("scan_scratch", m, Dl),
                                  [Dl * M] * len(cols), flags.device)
    if Dl * M:
        kernels.launch("compact_rows", flags.data_ptr(), off.data_ptr(), m,
                       Dl, shard0, M, len(cols),
                       *(list(fills) + [0] * (COMPACT_COLS - len(fills))),
                       *_ptrs(cols, COMPACT_COLS),
                       *_ptrs(outs, COMPACT_COLS), scratch.data_ptr())
    return [o.view(Dl, M) for o in outs]


def fetch_owned_plain(src, idx, valid, *, add, T, stride, shard0):
    Dl, m = src.shape
    M = idx.shape[0]
    out = torch.zeros((Dl, T, M), dtype=torch.int32, device=src.device)
    ok0 = torch.ones(M, dtype=torch.bool, device=src.device) \
        if valid is None else valid.bool()
    for d in range(Dl):
        for t in range(T):
            lq = idx.long() + add + t * stride - (shard0 + d) * m
            hit = ok0 & (lq >= 0) & (lq < m)
            out[d, t] = torch.where(hit, src[d][torch.clamp(lq, 0, m - 1)],
                                    0)
    return out


def fetch_owned(src: torch.Tensor, idx: torch.Tensor,
                valid: Optional[torch.Tensor], *, add: int, T: int = 1,
                stride: int = 0, shard0: int) -> torch.Tensor:
    """Each shard's part of a psum fetch from a sharded store (src
    int32[Dl, m]): out[d, t, k] = src at global position idx[k] + add +
    t * stride if shard shard0 + d owns it (and valid[k]), else 0;
    int32[Dl, T, M] (idx int32[M], valid uint8[M], replicated).  The
    mesh's psum then gives every shard the value.  Kernel K18c on the
    card."""
    kernels.check(src, "src", torch.int32, 2)
    Dl, m = src.shape
    kernels.check(idx, "idx", torch.int32, 1)
    M = idx.shape[0]
    if valid is not None:
        kernels.check(valid, "valid", torch.uint8, 1, (M,))
    ts = [src, idx] + ([valid] if valid is not None else [])
    if not kernels.on_card(*ts):
        return fetch_owned_plain(src, idx, valid, add=add, T=T,
                                 stride=stride, shard0=shard0)
    out = torch.empty((Dl, T, M), dtype=torch.int32, device=src.device)
    if M:
        kernels.launch("fetch_owned", src.data_ptr(), m, Dl, shard0,
                       idx.data_ptr(), _ptr(valid), M, add, T, stride,
                       out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# K18e: a shard's marks through kernel B
# ---------------------------------------------------------------------------


def shard_marks_plain(sa, a_row, *, seg, mark_period, cap, bits, exc_base,
                      exc_cap, n_words, ndocs):
    m = sa.shape[0]
    dev = sa.device
    nseg = m // seg
    marked = (a_row & 1) != 0
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=dev),
        torch.arange(32, device=dev))
    mark_bits = R.i64_to_u32((marked.long().view(-1, 32) * weights).sum(1))
    per_seg = marked.view(nseg, seg).sum(1)
    mark_ckpt = torch.zeros(nseg, dtype=torch.int64, device=dev)
    mark_ckpt[1:] = torch.cumsum(per_seg[:-1], 0)
    local = per_seg.sum().to(torch.int32).reshape(1)
    tag = (a_row >> 1).long()
    seof = torch.full((ndocs,), -1, dtype=torch.int32, device=dev)
    rows = torch.nonzero(tag > 0).flatten()
    seof[tag[rows] - 1] = rows.to(torch.int32)
    if mark_period == 0:
        mark_vals = torch.zeros(2, dtype=torch.int32, device=dev)
    else:
        mv = torch.full((cap,), -1, dtype=torch.int64, device=dev)
        vals = sa[marked].long()[:cap]
        mv[:vals.shape[0]] = vals
        valid = mv >= 0
        is_exc = valid & (mv % mark_period != 0)
        exc_rank = torch.cumsum(is_exc.long(), 0) - 1
        k = torch.where(is_exc, exc_base + exc_rank, mv // mark_period)
        k = torch.where(valid, k, 0)
        bp = torch.arange(cap, dtype=torch.int64, device=dev) * bits
        wi, sh = bp >> 5, bp & 31
        words = torch.zeros(n_words + 1, dtype=torch.int64, device=dev)
        words.index_add_(0, wi, torch.bitwise_left_shift(k, sh) & 0xFFFFFFFF)
        words.index_add_(0, wi + 1, torch.bitwise_right_shift(k, 32 - sh))
        exc = torch.zeros(exc_cap, dtype=torch.int64, device=dev)
        sel = is_exc & (exc_rank < exc_cap)
        exc[exc_rank[sel]] = mv[sel]
        mark_vals = R.i64_to_u32(torch.cat([words[:n_words] & 0xFFFFFFFF,
                                            exc & 0xFFFFFFFF]))
    if mark_period == 0:
        mark_vals = mark_vals.view(torch.uint32)
    return (mark_bits.view(nseg, seg // 32), mark_ckpt.to(torch.int32),
            mark_vals, local, seof)


def shard_marks(sa: torch.Tensor, a_row: torch.Tensor, *, seg: int,
                mark_period: int, cap: int, bits: int, exc_base: int,
                exc_cap: int, n_words: int, ndocs: int):
    """dist_build._shard_marks for one shard's block (sa, a_row int32[m]):
    (mark_bits uint32[m/seg, seg/32], mark_ckpt int32[m/seg] from 0, the
    packed store uint32[n_words + exc_cap] of the first ``cap`` marks (the
    geometry is the global n's, shared by every shard), the shard's mark
    count int32[1], doc_seof_rows int32[ndocs]: the local row of each
    document's SEOF in this block, -1 for the others).  Kernel B on the
    card (csrc/marks_build.cu with this geometry; its slot scratch holds
    every row of the block, so a count past cap stays in bounds and is
    reported by the count for the caller's retry)."""
    kernels.check(sa, "sa", torch.int32, 1)
    m = sa.shape[0]
    kernels.check(a_row, "a_row", torch.int32, 1, (m,))
    if seg % 32 != 0 or m % seg != 0:
        raise ValueError("need seg % 32 == 0 and whole segments")
    geo = dict(seg=seg, mark_period=mark_period, cap=cap, bits=bits,
               exc_base=exc_base, exc_cap=exc_cap, n_words=n_words,
               ndocs=ndocs)
    if not kernels.on_card(sa, a_row):
        return shard_marks_plain(sa, a_row, **geo)
    dev = sa.device
    nseg = m // seg

    def i32(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    mark_bits = torch.empty((nseg, seg // 32), dtype=torch.uint32,
                            device=dev)
    mark_ckpt = i32(nseg)
    seof = torch.full((ndocs,), -1, dtype=torch.int32, device=dev)
    totals = i32(2)
    if mark_period:
        mark_vals = torch.zeros(n_words + exc_cap, dtype=torch.int32,
                                device=dev).view(torch.uint32)
        kslots = torch.zeros(max(cap, m), dtype=torch.int32, device=dev)
    else:
        mark_vals = torch.zeros(2, dtype=torch.int32,
                                device=dev).view(torch.uint32)
        kslots = i32(1)
    scratch = [i32(nseg) for _ in range(3)]  # seg_marks, seg_exc, exc_ckpt
    kernels.launch("marks_build", sa.data_ptr(), a_row.data_ptr(), m, nseg,
                   seg, mark_period, cap, bits, exc_base, exc_cap, n_words,
                   mark_bits.data_ptr(), mark_ckpt.data_ptr(),
                   mark_vals.data_ptr(), seof.data_ptr(), totals.data_ptr(),
                   *(t.data_ptr() for t in scratch), kslots.data_ptr())
    return mark_bits, mark_ckpt, mark_vals, totals[:1], seof


# ---------------------------------------------------------------------------
# K18f: owner-side and masked occ / LF answers over a shard's blocks
# ---------------------------------------------------------------------------


def _row_shard(arrays, d, nseg_local):
    """A row tier's FMArrays of local shard d alone: its blocks of every
    sharded field (side rows and continuation offsets count from its own
    table and store) and its global mark base as mark_ckpt[0]."""
    Dl = arrays.bwt.shape[0] // nseg_local

    def blk(t):
        if t is None:
            return None
        k = t.shape[0] // Dl
        return t[d * k:(d + 1) * k]

    return arrays._replace(
        bwt=blk(arrays.bwt), occ_l1=blk(arrays.occ_l1),
        mark_ckpt=blk(arrays.mark_ckpt), mark_vals=blk(arrays.mark_vals),
        seg_ovf=blk(arrays.seg_ovf), seg_nsym=blk(arrays.seg_nsym),
        seg_woff=blk(arrays.seg_woff), seg_cont=blk(arrays.seg_cont))


def _occ_at(arrays, sl, off, c, nseg_local):
    """ckpt_base + the count of c among the first off codes of view
    segment sl (rank._occ_dense at shard-local segments); a row tier
    reads each lane's shard alone (_row_shard)."""
    if R.is_row_tier(arrays):
        out = torch.zeros(sl.shape[0], dtype=torch.int64, device=sl.device)
        for d in range(arrays.bwt.shape[0] // nseg_local):
            sel = torch.div(sl, nseg_local, rounding_mode="floor") == d
            if bool(sel.any()):
                sub = _row_shard(arrays, d, nseg_local)
                s = sl[sel] - d * nseg_local
                ctx = R.RowCtx(sub, s)
                cc = c[sel]
                out[sel] = (R.vseg_base_from_row(sub, ctx.g, ctx.row, s,
                                                 cc).long()
                            + ctx.within(ctx.query_code(cc), off[sel]))
        return out
    segdata = R.gather_segments(arrays, sl)
    iota = torch.arange(R.seg_size(arrays), device=sl.device)[None, :]
    within = ((segdata == c[:, None]) & (iota < off[:, None])).sum(1)
    return R.ckpt_base(arrays, sl, c).long() + within


def _owner_segment(arrays, rows, s, nseg_local, shard0):
    """The view segment of each routed lane (rows [Dl, R], s its rows'
    global segments, flattened): the global segment less shard0 *
    nseg_local, clipped to the view; on the row tiers the lane's own
    shard's segment, clipped to that shard's block (femto_tpu's
    owner-side clip)."""
    if not R.is_row_tier(arrays):
        return torch.clamp(s - shard0 * nseg_local, 0, arrays.bwt.shape[0] - 1)
    d = torch.arange(rows.shape[0], device=s.device).repeat_interleave(
        rows.shape[1])
    return d * nseg_local + torch.clamp(s - (shard0 + d) * nseg_local, 0,
                                        nseg_local - 1)


def owner_occ_plain(arrays, rows, cd, valid, *, nseg_local, shard0,
                    n_rows_total):
    seg = R.seg_size(arrays)
    r = rows.reshape(-1).long()
    c0 = cd.reshape(-1).long()
    ok = valid.reshape(-1).bool() & (c0 >= 0)
    c = torch.where(c0 >= 0, c0, 0)
    at_end = r >= n_rows_total
    s = torch.div(r, seg, rounding_mode="floor")
    sl = _owner_segment(arrays, rows, s, nseg_local, shard0)
    off = torch.clamp(r - s * seg, 0, seg - 1)
    total = arrays.C.long()[c + 1] - arrays.C.long()[c]
    v = torch.where(at_end, total, _occ_at(arrays, sl, off, c, nseg_local))
    return torch.where(ok, v, 0).to(torch.int32).reshape(rows.shape)


def owner_occ(arrays: FMArrays, rows: torch.Tensor, cd: torch.Tensor,
              valid: torch.Tensor, *, nseg_local: int, shard0: int,
              n_rows_total: int) -> torch.Tensor:
    """dist_query._occ_owner_compute: occ(dense code cd, row) for requests
    routed to the shard that owns the row (rows, cd int32[Dl, R], valid
    uint8[Dl, R]); arrays are the process's shard blocks end to end, whose
    checkpoints carry the global base, so a row's segment is its global
    segment less shard0 * nseg_local (on the row tiers the lane's own
    shard's segment, clipped to its block).  A row at n_rows_total counts
    every occurrence (C[c+1] - C[c]); invalid lanes and cd < 0 give 0.
    Kernel K18f on the card (every layout)."""
    kernels.check(rows, "rows", torch.int32, 2)
    shape = tuple(rows.shape)
    kernels.check(cd, "cd", torch.int32, 2, shape)
    kernels.check(valid, "valid", torch.uint8, 2, shape)
    if not kernels.on_card(rows, cd, valid, *_index_tensors(arrays)):
        return owner_occ_plain(arrays, rows, cd, valid,
                               nseg_local=nseg_local, shard0=shard0,
                               n_rows_total=n_rows_total)
    view, lay = fm_view(arrays)
    out = torch.empty(shape, dtype=torch.int32, device=rows.device)
    if rows.numel():
        kernels.launch("owner_occ", view, nseg_local, shard0,
                       rows.data_ptr(), cd.data_ptr(), valid.data_ptr(),
                       shape[1], shape[0], n_rows_total, out.data_ptr(),
                       layout=lay)
    return out


def masked_occ_plain(arrays, cd, r, *, Dl, nseg_local, shard0, n_rows_total):
    seg = R.seg_size(arrays)
    rr = r.long()
    c0 = cd.long()
    valid = c0 >= 0
    c = torch.where(valid, c0, 0)
    at_end = valid & (rr >= n_rows_total)
    s = torch.div(rr, seg, rounding_mode="floor")
    off = torch.clamp(rr - s * seg, 0, seg - 1)
    total = arrays.C.long()[c + 1] - arrays.C.long()[c]
    out = torch.empty((Dl, r.shape[0]), dtype=torch.int32, device=r.device)
    for d in range(Dl):
        g = shard0 + d
        slg = s - g * nseg_local
        mine = valid & ~at_end & (slg >= 0) & (slg < nseg_local)
        sl = torch.where(mine, d * nseg_local + slg, d * nseg_local)
        v = torch.where(mine, _occ_at(arrays, sl, off, c, nseg_local), 0)
        out[d] = (v + torch.where(at_end & (g == 0), total, 0)).to(
            torch.int32)
    return out


def masked_occ(arrays: FMArrays, cd: torch.Tensor, r: torch.Tensor, *,
               Dl: int, nseg_local: int, shard0: int,
               n_rows_total: int) -> torch.Tensor:
    """dist_query._occ_local_dense: each local shard's contribution to
    occ(dense cd, r) for replicated lanes (cd, r int32[B]): the owner's
    occ, the total C[c+1] - C[c] from shard 0 at r >= n_rows_total, 0
    elsewhere; int32[Dl, B], summed by the mesh's psum.  Kernel K18f on
    the card."""
    kernels.check(cd, "cd", torch.int32, 1)
    kernels.check(r, "r", torch.int32, 1, tuple(cd.shape))
    if not kernels.on_card(cd, r, *_index_tensors(arrays)):
        return masked_occ_plain(arrays, cd, r, Dl=Dl, nseg_local=nseg_local,
                                shard0=shard0, n_rows_total=n_rows_total)
    view, lay = fm_view(arrays)
    out = torch.empty((Dl, cd.shape[0]), dtype=torch.int32, device=cd.device)
    if cd.shape[0]:
        kernels.launch("masked_occ", view, nseg_local, shard0, Dl,
                       cd.data_ptr(), r.data_ptr(), cd.shape[0],
                       n_rows_total, out.data_ptr(), layout=lay)
    return out


def masked_occ_rows_plain(arrays, rows, *, Dl, nseg_local, shard0,
                          n_rows_total):
    M = rows.shape[0]
    sym = torch.arange(ALPHA_SIZE, dtype=torch.int32, device=rows.device)
    cd = R.map_char(arrays, sym).to(torch.int32)
    return masked_occ_plain(arrays, cd.repeat(M).contiguous(),
                            rows.repeat_interleave(ALPHA_SIZE).contiguous(),
                            Dl=Dl, nseg_local=nseg_local, shard0=shard0,
                            n_rows_total=n_rows_total)


def masked_occ_rows(arrays: FMArrays, rows: torch.Tensor, *, Dl: int,
                    nseg_local: int, shard0: int,
                    n_rows_total: int) -> torch.Tensor:
    """masked_occ of every alphabet symbol at each replicated row (rows
    int32[M]): int32[Dl, M * 261], entry [d, m * 261 + a] local shard d's
    part of occ(map_char(a), rows[m]) (0 for an absent symbol), as
    masked_occ over the lanes (map_char(a), rows[m]) gives it; summed by
    the mesh's psum.  The sharded frontier's ranks (K18h).  Kernel K18f
    on the card: a warp ranks an owned row for every code at once (the
    row route), or, in a build with -DFEMTO_R_ROW_RANK=0, a thread a lane
    (the lane route; csrc/fm_common.cuh's row_rank_min)."""
    kernels.check(rows, "rows", torch.int32, 1)
    if not kernels.on_card(rows, *_index_tensors(arrays)):
        return masked_occ_rows_plain(arrays, rows, Dl=Dl,
                                     nseg_local=nseg_local, shard0=shard0,
                                     n_rows_total=n_rows_total)
    view, lay = fm_view(arrays)
    M = rows.shape[0]
    out = torch.empty((Dl, M * ALPHA_SIZE), dtype=torch.int32,
                      device=rows.device)
    if M:
        kernels.launch("masked_occ_rows", view, nseg_local, shard0, Dl,
                       rows.data_ptr(), M, n_rows_total, out.data_ptr(),
                       layout=lay)
    return out


def _lf_answer(arrays, sl, r, nseg_local):
    """(lf, bit, mark value) of rows r at view segments sl: the routed
    locate's owner_answer.  The row tiers read each lane's shard alone
    (_row_shard), whose rows carry the segments' global mark checkpoints;
    the shard's mark base is mark_ckpt[shard]."""
    seg = R.seg_size(arrays)
    Dl = arrays.bwt.shape[0] // nseg_local
    shard = torch.div(sl, nseg_local, rounding_mode="floor")
    if R.is_row_tier(arrays):
        lf = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
        bit = torch.zeros(r.shape[0], dtype=torch.bool, device=r.device)
        lrank = torch.zeros_like(lf)
        for d in range(Dl):
            sel = shard == d
            if bool(sel.any()):
                sub = _row_shard(arrays, d, nseg_local)
                rl = (sl[sel] - d * nseg_local) * seg + torch.remainder(
                    r[sel], seg)
                f, b, g = R.lf_grank_step(sub, rl)
                lf[sel] = f.long()
                bit[sel] = b
                lrank[sel] = g.long() - arrays.mark_ckpt[d].long()
        return lf, bit, _mark_value_shard(arrays, shard, lrank, Dl)
    off = torch.remainder(r, seg)
    segdata = R.gather_segments(arrays, sl)
    lanes = torch.arange(r.shape[0], device=r.device)
    c = segdata[lanes, off].long()
    iota = torch.arange(seg, device=r.device)[None, :]
    within = ((segdata == c[:, None]) & (iota < off[:, None])).sum(1)
    lf = arrays.C.long()[c] + R.ckpt_base(arrays, sl, c).long() + within
    words = R._mark_words(arrays, sl)                   # [B, seg/32]
    wl = off // 32
    word = words[lanes, wl]
    sh = r % 32
    bit = ((word >> sh) & 1) != 0
    widx = torch.arange(words.shape[1], device=r.device)[None, :]
    cnt = torch.where(widx < wl[:, None], R.popcount32(words), 0).sum(1)
    part = R.popcount32(word & ((1 << sh) - 1))
    grank = arrays.mark_ckpt[sl].long() + cnt + part
    lrank = grank - arrays.mark_ckpt[shard * nseg_local].long()
    return lf, bit, _mark_value_shard(arrays, shard, lrank, Dl)


def _mark_value_shard(arrays, shard, lrank, Dl):
    """rank.mark_offset of each lane's slot lrank in its own shard's store
    (mark_vals holds the Dl local shards' stores end to end)."""
    bits, exc_base, period, exc_off, cap = arrays.mark_meta.tolist()
    mv = R.u32_to_i64(arrays.mark_vals)
    L = mv.shape[0] // Dl
    g = torch.clamp(lrank, 0, cap - 1)
    bp = g * bits
    wi = shard * L + (bp >> 5)
    sh = bp & 31
    lo = mv[wi] >> sh
    hi = torch.where(sh == 0, 0,
                     (mv[torch.clamp(wi + 1, max=mv.shape[0] - 1)]
                      << (32 - sh)) & 0xFFFFFFFF)
    k = (lo | hi) & ((1 << bits) - 1)
    eidx = shard * L + torch.clamp(exc_off + (k - exc_base), 0, L - 1)
    exc = mv[eidx]
    exc = torch.where(exc >= 2**31, exc - 2**32, exc)
    return torch.where(k >= exc_base, exc, k * period)


def owner_lf_plain(arrays, rows, valid, *, nseg_local, shard0):
    seg = R.seg_size(arrays)
    r = rows.reshape(-1).long()
    ok = valid.reshape(-1).bool()
    s = torch.div(r, seg, rounding_mode="floor")
    sl = _owner_segment(arrays, rows, s, nseg_local, shard0)
    r = torch.where(ok, r, 0)
    sl = torch.where(ok, sl, 0)
    lf, bit, mv = _lf_answer(arrays, sl, r, nseg_local)
    ans = torch.where(bit, mv, -1 - lf)
    return torch.where(ok, ans, 0).to(torch.int32).reshape(rows.shape)


def _mark_tensors(arrays):
    return (arrays.mark_bits, arrays.mark_ckpt, arrays.mark_vals,
            arrays.mark_meta)


def _check_marks(arrays, nseg_local):
    """The local shard count Dl, after checking the mark fields: mark_ckpt
    int32[n_seg] (the row tiers: int32[Dl], the shards' global mark
    bases) and one mark_vals store per local shard."""
    Dl = arrays.bwt.shape[0] // nseg_local
    kernels.check(arrays.mark_ckpt, "mark_ckpt", torch.int32, 1,
                  (Dl if R.is_row_tier(arrays) else arrays.bwt.shape[0],))
    kernels.check(arrays.mark_vals, "mark_vals", torch.uint32, 1)
    kernels.check(arrays.mark_meta, "mark_meta", torch.int32, 1, (5,))
    if arrays.bwt.shape[0] != Dl * nseg_local or \
            arrays.mark_vals.shape[0] % Dl:
        raise ValueError("mark_vals must hold one store per local shard")
    return Dl


class OwnerLfView(NamedTuple):
    """owner_lf's index arguments over one index on the card, checked once
    (owner_lf_view): the K18f view and its layout, the local shards, the
    mark fields' pointers and the arrays they point into."""

    view: kernels.FmView
    layout: str
    Dl: int
    nseg_local: int
    marks: tuple
    arrays: FMArrays


def owner_lf_view(arrays: FMArrays,
                  nseg_local: int) -> Optional[OwnerLfView]:
    """owner_lf's view of an index (fm_view and the mark checks), made once
    for many calls: a sharded index's arrays do not change after its build
    (paged indexes are never sharded).  None for an index on the CPU,
    whose calls take the plain version."""
    Dl = _check_marks(arrays, nseg_local)
    if not kernels.on_card(*_index_tensors(arrays), *_mark_tensors(arrays)):
        return None
    view, lay = fm_view(arrays)
    marks = (arrays.mark_bits.data_ptr(), arrays.mark_ckpt.data_ptr(),
             arrays.mark_vals.data_ptr(), arrays.mark_vals.shape[0],
             arrays.mark_meta.data_ptr())
    return OwnerLfView(view, lay, Dl, nseg_local, marks, arrays)


def owner_lf(arrays: FMArrays, rows: torch.Tensor, valid: torch.Tensor, *,
             nseg_local: int, shard0: int,
             view: Optional[OwnerLfView] = None) -> torch.Tensor:
    """dist_query._locate_routed_body's owner_answer for rows routed to
    their owner (rows int32[Dl, R], valid uint8[Dl, R]): the mark value if
    the row is marked (its rank less the shard's first checkpoint, decoded
    from the shard's own mark store), else -1 - LF(row); 0 on invalid
    lanes.  On the row tiers the marks ride the serving rows and the
    shard's base is mark_ckpt[shard].  ``view``: owner_lf_view(arrays,
    nseg_local), made once (a call then checks only rows and valid: one
    allocation and one launch).  Kernel K18f on the card: on vseg and vrle
    a warp a request up to kernel D's route limit (csrc/fm_common.cuh), a
    thread a request past it and on the other layouts."""
    kernels.check(rows, "rows", torch.int32, 2)
    kernels.check(valid, "valid", torch.uint8, 2, tuple(rows.shape))
    if view is None:
        _check_marks(arrays, nseg_local)
        if not kernels.on_card(rows, valid, *_index_tensors(arrays),
                               *_mark_tensors(arrays)):
            return owner_lf_plain(arrays, rows, valid,
                                  nseg_local=nseg_local, shard0=shard0)
        view = owner_lf_view(arrays, nseg_local)
    elif view.arrays is not arrays or view.nseg_local != nseg_local \
            or rows.shape[0] != view.Dl or not kernels.on_card(rows, valid):
        raise ValueError("owner_lf: the view is of other arrays or shards, "
                         "or the requests are not on the card")
    out = torch.empty_like(rows)
    if rows.numel():
        kernels.launch("owner_lf", view.view, nseg_local, shard0,
                       rows.data_ptr(), valid.data_ptr(), rows.shape[1],
                       rows.shape[0], *view.marks, out.data_ptr(),
                       layout=view.layout)
    return out


def masked_lf_plain(arrays, rows, *, Dl, nseg_local, shard0):
    seg = R.seg_size(arrays)
    r = rows.long()
    s = torch.div(r, seg, rounding_mode="floor")
    out = torch.empty((Dl, rows.shape[0]), dtype=torch.int32,
                      device=rows.device)
    for d in range(Dl):
        slg = s - (shard0 + d) * nseg_local
        mine = (slg >= 0) & (slg < nseg_local)
        sl = torch.where(mine, d * nseg_local + slg, d * nseg_local)
        rr = torch.where(mine, r, 0)
        lf, bit, mv = _lf_answer(arrays, sl, rr, nseg_local)
        out[d] = torch.where(mine, torch.where(bit, mv, -1 - lf), 0).to(
            torch.int32)
    return out


def masked_lf(arrays: FMArrays, rows: torch.Tensor, *, Dl: int,
              nseg_local: int, shard0: int) -> torch.Tensor:
    """dist_query._locate_body's local part: owner_lf's answer for each
    replicated row (int32[B]) from the local shard that owns it, 0 from
    the others; int32[Dl, B], summed by the mesh's psum.  Kernel K18f on
    the card."""
    kernels.check(rows, "rows", torch.int32, 1)
    _check_marks(arrays, nseg_local)
    if not kernels.on_card(rows, *_index_tensors(arrays),
                           *_mark_tensors(arrays)):
        return masked_lf_plain(arrays, rows, Dl=Dl, nseg_local=nseg_local,
                               shard0=shard0)
    view, lay = fm_view(arrays)
    out = torch.empty((Dl, rows.shape[0]), dtype=torch.int32,
                      device=rows.device)
    if rows.shape[0]:
        kernels.launch("masked_lf", view, nseg_local, shard0, Dl,
                       rows.data_ptr(), rows.shape[0],
                       arrays.mark_bits.data_ptr(),
                       arrays.mark_ckpt.data_ptr(),
                       arrays.mark_vals.data_ptr(),
                       arrays.mark_vals.shape[0],
                       arrays.mark_meta.data_ptr(), out.data_ptr(),
                       layout=lay)
    return out
