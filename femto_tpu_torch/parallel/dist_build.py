"""Distributed suffix array, BWT and index over the mesh.

The counterpart of femto_tpu/parallel/dist_build.py, all five tiers.  The
text is padded with trailing 0 symbols to n_pad = D * m and cut into
equal blocks (parallel/mesh.py), then sorted by the mesh edition of the
single-device design:

  1. ONE distributed sample sort (parallel/dist_sort.py) of wide packed
     seed keys (nkeys 30-bit int32 keys of per_key dense codes each,
     built on a right halo by kernel K18c's seed_keys) with the BWT + aux
     payload (payload_block) riding along;
  2. a replicated direct-extension epilogue over the unresolved slots:
     compacted to every shard (compact_rows + psum), extended
     by the next _EXT_T packed words per round (fetch_owned + psum), sorted
     locally (kernel H), written back (owner_place), with filtered
     doubling for long-repeat tails and the pull fix of the BWT payload;
  3. massively tied inputs (active set > n_pad / 4): full distributed
     prefix doubling rounds, each two Valiant exchanges and a distributed
     sort, and a final sort plus a routed pull of the payload.

The collectives are the mesh's; every per-shard body is a kernel of
ops/dist_ops.py (K18a-K18d) or of the single-device sort (H, L).  Each
shard then packages its own rows through kernels A, A', F and B
(ops/build_ops.py) and kernel K18b's cross-shard bases (add_mesh_base:
the prefix over the mesh and its add to the checkpoints in one launch).
The row tiers (vseg, vrle) add kernel M's symbol lists and N's slot
counts per shard; those O(n_seg) statistics cross to the host
once (mesh.all_gather), the host picks one geometry for every shard
(_row_plan), and M and N assemble each shard's rows with its global mark
checkpoints inside them.  Kernel P lists each shard's segments' documents
(doc_chunks).  The pad rows stay in the index as leading rows (meta.row0 =
pad, meta.n_rows = n_pad); no pattern can match them.

A sharded index holds the process's shard blocks end to end in every
row-dimension field: on a LocalMesh the global arrays (femto_tpu's
sharded arrays as numpy), on a DistMesh the process's own blocks; C,
doc_starts, doc_seof_rows, the alphabet maps and mark_meta are
replicated.  mark_vals holds one packed store per shard and mark_ckpt[0]
of each shard block is that shard's global mark base.  The row tiers
shard bwt (one serving row per segment), occ_l1, seg_nsym, seg_woff, the
per-shard side tables seg_ovf (max_ovf + 2 rows a shard, row 0 a dummy,
side rows numbered from 1 within the shard) and continuation stores
seg_cont (offsets within the shard), and mark_ckpt is int32[D] of the
shards' global mark bases (their rows carry the per-segment global
checkpoints); occ_ckpt, mark_bits, seg_syms and seg_rle are replicated
one-row markers, as femto_tpu lays them out.

checkpoint_dir saves each process's suffix-sort state as host files and
resumes from them (_ckpt_save, _ckpt_load).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..alphabet import ALPHA_SIZE, INVALID_ALPHA
from ..fmindex import (DEFAULT_MARK_PERIOD, DEFAULT_SEG, FMArrays, FMIndex,
                       FMMeta, l1_group_for)
from ..ops import build_ops as BO
from ..ops import dist_ops as DO
from ..ops import sort_ops as SO
from . import bins
from .dist_sort import dist_sort, local_sort
from .mesh import shard_ids

#: What the last dist_suffix_array call did (femto_tpu's keys and counts):
#: path ("wide" or "doubling"), full_sorts, full_exchanges, ext_rounds,
#: tail_rounds, dbl_rounds, span, m_act; build_index_sharded adds
#: mark_cap_retries.
LAST_BUILD_STATS: dict = {}

_I32MAX = DO.INT32_MAX
_EXT_T = 4            # packed words fetched per extension round
_EXT_MAX_ROUNDS = 6   # then switch to filtered doubling
_REP_CAP = 1 << 24    # replicated-active budget (records on every shard)
_KEY_BITS = 30        # payload bits per int32 seed key
_MIN_BUCKET = 1 << 16

def _pack_rate(K: int):
    """(per_key, bits) for dense codes in [1, K] (femto_tpu.suffix)."""
    if K >= 128:
        return 3, 9
    bits = max(1, int(K).bit_length())
    return _KEY_BITS // bits, bits


def _bucket_anchored(m: int, n: int) -> int:
    """Smallest n / 4^j >= m, floored at _MIN_BUCKET (femto_tpu.suffix)."""
    M = 1 << max((n - 1).bit_length(), _MIN_BUCKET.bit_length() - 1)
    while M // 4 >= m and M // 4 >= _MIN_BUCKET:
        M //= 4
    return min(M, n)


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------


def _gidx(mesh, m: int) -> torch.Tensor:
    """int32[Dl, m]: the global position of each slot."""
    return (shard_ids(mesh)[:, None] * m
            + torch.arange(m, dtype=torch.int32, device=mesh.device)[None])


def _prev_last(mesh, x: torch.Tensor) -> torch.Tensor:
    """[Dl]: the last element of the shard before (cyclic)."""
    return mesh.ppermute(x[:, -1].contiguous(), 1)


def _next_first(mesh, x: torch.Tensor) -> torch.Tensor:
    """[Dl]: the first element of the shard after (cyclic)."""
    return mesh.ppermute(x[:, 0].contiguous(), -1)


def _halo_right(mesh, x: torch.Tensor, H: int) -> torch.Tensor:
    """concat(x, the next H entries across blocks), cyclic over the mesh;
    whole following blocks when H exceeds the block."""
    m = x.shape[1]
    parts = [x]
    need, k = H, 1
    while need > 0:
        take = min(m, need)
        parts.append(mesh.ppermute(x[:, :take].contiguous(), -k))
        need -= take
        k += 1
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


def _exclusive_base(mesh, v: torch.Tensor) -> torch.Tensor:
    """int32[Dl]: the sum of v over the shards before each one."""
    base, _ = DO.mesh_exclusive(mesh.all_gather(v.view(mesh.Dl, 1)),
                                shard0=mesh.shard0, Dl=mesh.Dl)
    return base.view(mesh.Dl)


def _group_state(mesh, st: torch.Tensor, n_pad: int):
    """(base, unresolved) of per-slot group-start flags st uint8[Dl, m]:
    base = each slot's group base slot (a cummax with the carry of the
    shards before), unresolved = the slot lies in a group of more than
    one (uint8)."""
    base_local, last = DO.mesh_scan(st, mode="max", shard0=mesh.shard0)
    carry, _ = DO.mesh_exclusive(mesh.all_gather(last.view(mesh.Dl, 1)),
                                 shard0=mesh.shard0, Dl=mesh.Dl, op="max")
    base = torch.maximum(base_local, carry)
    nxt = torch.cat([st[:, 1:], _next_first(mesh, st)[:, None]], dim=1)
    if mesh.shard0 + mesh.Dl == mesh.D:
        nxt[-1, -1] = 1            # the global last slot
    unresolved = (1 - (st & nxt)).to(torch.uint8)
    return base, unresolved


def _col(x: torch.Tensor) -> torch.Tensor:
    """A replicated [M] array as the one-shard [1, M] the steps take."""
    return x.view(1, -1)


# ---------------------------------------------------------------------------
# the sort's bodies
# ---------------------------------------------------------------------------


def _seed_sort(mesh, keys, payload, *, n_pad: int, cap: int, rkey: int):
    """The ONE full-size distributed sort: wide packed keys + BWT payload.
    Returns (sa, pull, st, m_act, overflow)."""
    m = keys[0].shape[1]
    nkeys = len(keys)
    cols, (pull,), of = dist_sort(mesh, list(keys) + [_gidx(mesh, m)],
                                  [payload], cap, key=rkey)
    skeys, sa = cols[:nkeys], cols[nkeys]
    st = DO.mesh_flags(skeys, [_prev_last(mesh, k) for k in skeys],
                       shard0=mesh.shard0, first=True)
    del skeys, cols
    _, unresolved = _group_state(mesh, st, n_pad)
    m_act = mesh.psum(unresolved.sum(dim=1, dtype=torch.int32))
    return sa, pull, st, m_act, of


def _rep_compact(mesh, sa, st, *, n_pad: int, M: int):
    """The globally unresolved slots as REPLICATED [M] records (slot,
    suffix position, group base): each shard compacts its own at its
    offset over the mesh, one psum merges them."""
    base_all, unres = _group_state(mesh, st, n_pad)
    cnt = unres.sum(dim=1, dtype=torch.int32)
    off = _exclusive_base(mesh, cnt)
    bufs = DO.compact_rows(unres, off, [None, sa, base_all], M=M,
                           fills=[0, 0, 0], shard0=mesh.shard0)
    del base_all, unres
    slots, pos, base = (mesh.psum(b) for b in bufs)
    live = torch.arange(M, device=sa.device) < mesh.psum(cnt)
    return (torch.where(live, slots, n_pad), torch.where(live, pos, 0),
            torch.where(live, base, _I32MAX))


def _rep_sort_commit(mesh, sa, slots, pos, keys, *, n_pad: int,
                     rank=None):
    """Sort the replicated records by keys (carrying pos), write the sorted
    positions back into the sharded SA (and, with ``rank``, each one's new
    group base into the sharded rank store), and compact the survivors.
    Returns (stn, slots2, pos2, base2, m_dev)."""
    m = sa.shape[1]
    valid = (slots < n_pad).to(torch.uint8)
    srt = local_sort([_col(k) for k in keys], [_col(pos)])
    sp = srt[-1][0]
    stn = DO.mesh_flags(srt[:-1], [torch.zeros(1, dtype=torch.int32,
                                               device=sa.device)] * len(keys),
                        shard0=0, first=True)
    del srt
    new_base, _ = DO.mesh_scan(stn & _col(valid), mode="max", shard0=0,
                               slots=_col(slots))
    DO.owner_place(slots, valid, [sp], [sa], base_mul=m, shard0=mesh.shard0)
    if rank is not None:
        DO.owner_place(sp, valid, [new_base[0]], [rank], base_mul=m,
                       shard0=mesh.shard0)
    nxt = torch.cat([stn[0, 1:], torch.ones(1, dtype=torch.uint8,
                                            device=sa.device)])
    keep = (_col(valid) & (1 - (stn[0] & nxt))).to(torch.uint8)
    cnt = keep.sum(dim=1, dtype=torch.int32)
    M = slots.shape[0]
    slots2, pos2, base2 = DO.compact_rows(
        keep, torch.zeros(1, dtype=torch.int32, device=sa.device),
        [_col(slots), _col(sp), new_base], M=M, fills=[n_pad, 0, _I32MAX],
        shard0=0)
    return stn[0], slots2[0], pos2[0], base2[0], cnt


def _rep_extend(mesh, sa, st, key0, slots, pos, base, W: int, *, n_pad: int,
                T: int, per_key: int):
    """One replicated direct-extension round: the next T packed words per
    active suffix by one [T, M] psum over the sharded key0 store, a local
    sort, the write-back into the sharded SA / group-start blocks, and the
    compaction of the survivors."""
    m = sa.shape[1]
    valid = (slots < n_pad).to(torch.uint8)
    fetched = mesh.psum(DO.fetch_owned(key0, pos, valid, add=W, T=T,
                                       stride=per_key, shard0=mesh.shard0))
    vm = valid.bool()
    keys = [torch.where(vm, base, _I32MAX)] + [
        torch.where(vm, fetched[t], _I32MAX) for t in range(T)]
    del fetched
    stn, slots2, pos2, base2, cnt = _rep_sort_commit(
        mesh, sa, slots, pos, keys, n_pad=n_pad)
    DO.owner_place(slots, valid, [stn], [st], base_mul=m, shard0=mesh.shard0)
    return slots2, pos2, base2, int(cnt)


def _rank_scatter(mesh, sa, st, rkey: int, *, n_pad: int, cap: int):
    """rank[p] = the group base slot of suffix p (the sharded ISA), by one
    Valiant exchange of (position, base) to the position's owner."""
    m = sa.shape[1]
    base_all, _ = _group_state(mesh, st, n_pad)
    dest = torch.div(sa, m, rounding_mode="floor")
    recs, v, of = bins.valiant_exchange(mesh, dest, [sa, base_all], cap,
                                        rkey)
    rank = torch.zeros_like(sa)
    DO.owner_place(recs[0], v, [recs[1]], [rank], base_mul=m,
                   shard0=mesh.shard0)
    return rank, of


def _rep_double(mesh, sa, rank, slots, pos, base, k: int, *, n_pad: int):
    """One replicated filtered doubling round: rank[pos + k] by one [M]
    psum over the sharded rank store; sort, write back, compact."""
    valid = (slots < n_pad).to(torch.uint8)
    r2 = mesh.psum(DO.fetch_owned(rank, pos, valid, add=k,
                                  shard0=mesh.shard0))[0]
    r2 = torch.where(pos.to(torch.int64) + k < n_pad, r2, -1)
    vm = valid.bool()
    keys = [torch.where(vm, base, _I32MAX), torch.where(vm, r2, _I32MAX)]
    _, slots2, pos2, base2, cnt = _rep_sort_commit(
        mesh, sa, slots, pos, keys, n_pad=n_pad, rank=rank)
    return slots2, pos2, base2, int(cnt)


def _pull_fix(mesh, sa, pull, payload, slots0, *, n_pad: int):
    """Refresh pull[slot] = payload[sa[slot]] for the slots active after the
    seed sort: two [M] psum fetches and one placement."""
    m = sa.shape[1]
    valid = (slots0 < n_pad).to(torch.uint8)
    pos = mesh.psum(DO.fetch_owned(sa, slots0, valid, add=0,
                                   shard0=mesh.shard0))[0]
    val = mesh.psum(DO.fetch_owned(payload, pos, valid, add=0,
                                   shard0=mesh.shard0))[0]
    DO.owner_place(slots0, valid, [val], [pull], base_mul=m,
                   shard0=mesh.shard0)


def _rank_refine(mesh, rank, rank_k, gidx, key: int, *, cap: int):
    """A doubling round's core: sort (rank, rank_k, pos), refined ranks
    from adjacent diffs, scattered back to position order."""
    m = rank.shape[1]
    (s1, s2, sidx), _, of = dist_sort(mesh, [rank, rank_k, gidx], [], cap,
                                      key=bins.fold_in(key, 1))
    diff = DO.mesh_flags([s1, s2], [_prev_last(mesh, s1),
                                    _prev_last(mesh, s2)],
                         shard0=mesh.shard0, first=False)
    del s1, s2
    local_cum, last = DO.mesh_scan(diff, mode="sum", shard0=mesh.shard0)
    del diff
    new_rank_sorted = _exclusive_base(mesh, last)[:, None] + local_cum
    nuniq = mesh.psum(last) + 1
    dest = torch.div(sidx, m, rounding_mode="floor")
    recs, rvalid, of2 = bins.valiant_exchange(
        mesh, dest, [sidx, new_rank_sorted], cap, key)
    new_rank = torch.zeros_like(rank)
    DO.owner_place(recs[0], rvalid, [recs[1]], [new_rank], base_mul=m,
                   shard0=mesh.shard0)
    return new_rank, nuniq, torch.maximum(of, of2)


def _local_gather(mesh, src, lidx):
    """src[d, clip(lidx[d])] per shard (kernel L through the flat blocks)."""
    m = src.shape[1]
    flat = (torch.clamp(lidx, 0, m - 1)
            + torch.arange(src.shape[0], dtype=torch.int32,
                           device=src.device)[:, None] * m)
    return SO.gather_rows(src.reshape(-1), flat.reshape(-1)).view(lidx.shape)


def _dist_round(mesh, rank, k: int, key: int, *, n_pad: int, cap: int):
    """One full doubling round: rank[pos + k] fetched from its owner (two
    Valiant exchanges), then _rank_refine."""
    m = rank.shape[1]
    ids = shard_ids(mesh)[:, None]
    gidx = _gidx(mesh, m)
    tgt64 = gidx.to(torch.int64) + k
    ok = tgt64 < n_pad
    tgt = torch.where(ok, tgt64, 0).to(torch.int32)
    dest = torch.where(ok, torch.div(tgt, m, rounding_mode="floor"), ids)
    recs, v, of0 = bins.valiant_exchange(
        mesh, dest.to(torch.int32), [tgt, gidx], cap, bins.fold_in(key, 7),
        valid=ok)
    lv = _local_gather(mesh, rank, recs[0] - ids * m)
    back, v2, of0b = bins.valiant_exchange(
        mesh, torch.div(recs[1], m, rounding_mode="floor"), [recs[1], lv],
        cap, bins.fold_in(key, 8), valid=v)
    rank_k = torch.full_like(rank, -1)
    DO.owner_place(back[0], v2, [back[1]], [rank_k], base_mul=m,
                   shard0=mesh.shard0)
    new_rank, nuniq, of = _rank_refine(mesh, rank, rank_k, gidx, key,
                                       cap=cap)
    return new_rank, int(nuniq), torch.maximum(of, torch.maximum(of0, of0b))


def _dist_finalize(mesh, rank, payload, key: int, *, cap: int):
    """Final SA sort + the routed pull of each row's payload (its BWT
    symbol and aux word: payload[sa[r]], which is femto_tpu's packed
    text[sa[r] - 1] | aux[sa[r]] << 9).  Returns (sa, pull, overflow)."""
    m = rank.shape[1]
    ids = shard_ids(mesh)[:, None]
    gidx = _gidx(mesh, m)
    (_, sa), _, of = dist_sort(mesh, [rank, gidx], [], cap,
                               key=bins.fold_in(key, 1 << 29))
    recs, rvalid, of1 = bins.valiant_exchange(
        mesh, torch.div(sa, m, rounding_mode="floor"), [sa, gidx], cap,
        bins.fold_in(key, 1 << 30))
    vals = torch.where(rvalid.bool(),
                       _local_gather(mesh, payload, recs[0] - ids * m), 0)
    recs2, rvalid2, of2 = bins.valiant_exchange(
        mesh, torch.div(recs[1], m, rounding_mode="floor"), [recs[1], vals],
        cap, bins.fold_in(key, (1 << 30) + 1), valid=rvalid)
    pull = torch.full_like(sa, INVALID_ALPHA)
    DO.owner_place(recs2[0], rvalid2, [recs2[1]], [pull], base_mul=m,
                   shard0=mesh.shard0)
    return sa, pull, torch.maximum(of, torch.maximum(of1, of2))


def _text_hist(mesh, text: torch.Tensor) -> np.ndarray:
    """int64[512] symbol counts of the sharded text (kernel G per shard,
    one psum, one read-back)."""
    h = torch.stack([SO.sym_hist(text[j]) for j in range(text.shape[0])])
    return mesh.psum(h).cpu().numpy()[:512].astype(np.int64)


# ---------------------------------------------------------------------------
# checkpoint / resume (host I/O)
# ---------------------------------------------------------------------------
# Each process saves the shard blocks it holds; resume needs every
# process's file on a shared checkpoint_dir at the same stage, with the
# same process count: "seed" after the seed sort (sa, pull, st, m_act),
# "dbl" after each full doubling round (rank, k, nuniq, m_act).


def _process(mesh):
    """(index, count) of this process among the mesh's processes."""
    return mesh.shard0 // mesh.Dl, mesh.D // mesh.Dl


def _ckpt_file(checkpoint_dir: str, n_pad: int, pidx: int, nproc: int):
    return os.path.join(checkpoint_dir,
                        f"dist_rank_{n_pad}.p{pidx}of{nproc}.npz")


def _ckpt_save(checkpoint_dir: str, n_pad: int, stage: str, mesh, **arrs):
    """Save this process's shard blocks ([Dl, m] tensors) and scalars at
    `stage`; the file appears whole (written aside, then renamed)."""
    pidx, nproc = _process(mesh)
    out = {"stage": stage, "nproc": nproc}
    for name, v in arrs.items():
        out[name] = v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    path = _ckpt_file(checkpoint_dir, n_pad, pidx, nproc)
    with open(path + ".tmp", "wb") as f:
        np.savez(f, **out)
    os.replace(path + ".tmp", path)


def _ckpt_load(checkpoint_dir: str, n_pad: int, stage: str, mesh):
    """This process's blocks (tensors on the mesh's device) and scalars
    saved at `stage`, or None.  Every process's file must be there at that
    stage, so that all processes take the same branch."""
    pidx, nproc = _process(mesh)
    paths = [_ckpt_file(checkpoint_dir, n_pad, i, nproc)
             for i in range(nproc)]
    for p in paths:
        try:
            with np.load(p) as z:
                if str(z["stage"]) != stage or int(z["nproc"]) != nproc:
                    return None
        except (OSError, ValueError, KeyError):
            return None
    with np.load(paths[pidx]) as z:
        data = {k: z[k] for k in z.files if k not in ("stage", "nproc")}
    m = n_pad // mesh.D
    out = {}
    for k, v in data.items():
        if v.ndim == 2:
            if v.shape != (mesh.Dl, m):
                return None
            out[k] = torch.from_numpy(v).to(mesh.device)
        else:
            out[k] = int(v)
    return out


def _ckpt_clear(checkpoint_dir: str, n_pad: int, mesh):
    p = _ckpt_file(checkpoint_dir, n_pad, *_process(mesh))
    if os.path.exists(p):
        os.remove(p)


def _doubling(mesh, rank, payload, key: int, *, k: int, nuniq: int,
              n_pad: int, cap: int, stats: dict, overflow_acc: int,
              m_act: int, checkpoint_dir: Optional[str]):
    """Full distributed prefix doubling from the rank store (the wide
    sort's, or a "dbl" checkpoint's at k), then the final sort and the
    routed pull.  Returns (sa, pull, overflow)."""
    while nuniq < n_pad and k < 2 * n_pad and overflow_acc <= 0:
        rank, nuniq, of = _dist_round(mesh, rank, k, bins.fold_in(key, k),
                                      n_pad=n_pad, cap=cap)
        overflow_acc = max(overflow_acc, int(of))
        k *= 2
        stats["dbl_rounds"] += 1
        stats["full_exchanges"] += 3
        if checkpoint_dir is not None and overflow_acc <= 0:
            _ckpt_save(checkpoint_dir, n_pad, "dbl", mesh, rank=rank, k=k,
                       nuniq=nuniq, m_act=m_act)
    sa, pull, of = _dist_finalize(mesh, rank, payload, key, cap=cap)
    stats["full_sorts"] += 1
    stats["full_exchanges"] += 3
    return sa, pull, torch.clamp(of, min=overflow_acc)


def _dist_sa(text, mesh, *, cap_factor: float, seed: int, n: int,
             doc_starts: Optional[torch.Tensor], mark_period: int,
             alpha: Optional[np.ndarray],
             checkpoint_dir: Optional[str] = None):
    """dist_suffix_array with the payload kept whole: (sa, pull int32
    [Dl, m] = bwt | a_row << 9, overflow int32 scalar)."""
    global LAST_BUILD_STATS
    D = mesh.D
    Dl, m = text.shape
    n_pad = D * m
    cap = max(64, int(np.ceil(cap_factor * m / D)))
    key = seed
    dev = text.device
    if doc_starts is None:
        ndocs = 1
        doc_starts = torch.tensor([0, n], dtype=torch.int32, device=dev)
        mark_period = 0
    else:
        ndocs = int(doc_starts.shape[0]) - 1
    if ndocs >= (1 << 21):
        raise ValueError(
            "sharded build packs doc tags into 21 bits; corpora with >= 2^21"
            " documents need the chunked builder (femto_tpu_torch.multi)")
    if alpha is not None:
        used_np = np.asarray(alpha, np.int32)
    else:
        used_np = np.nonzero(_text_hist(mesh, text))[0].astype(np.int32)
    used_np = used_np[used_np > 0]
    K = max(1, int(used_np.shape[0]))
    per_key, bits = _pack_rate(K)
    nkeys = 2 if 2 * per_key >= 10 else 3
    span = per_key * nkeys
    if per_key > 3:
        # dense monotone remap: code(s) = #used symbols <= s (0 stays 0)
        used_l = used_np if used_np.size else np.ones(1, np.int32)
        lut_np = np.searchsorted(used_l, np.arange(512), side="right")
    else:
        lut_np = np.arange(512)
    lut = torch.from_numpy(lut_np.astype(np.int32)).to(dev)

    stats = {"path": "wide", "full_sorts": 1, "full_exchanges": 1,
             "ext_rounds": 0, "tail_rounds": 0, "dbl_rounds": 0,
             "span": span, "m_act": 0}

    keys = DO.seed_keys(_halo_right(mesh, text, span), lut, m=m, n=n,
                        n_pad=n_pad, per_key=per_key, bits=bits, nkeys=nkeys,
                        shard0=mesh.shard0)
    payload = DO.payload_block(text, _prev_last(mesh, text), doc_starts,
                               n=n, mark_period=mark_period, ndocs=ndocs,
                               shard0=mesh.shard0)
    key0 = keys[0]
    resumed = None
    if checkpoint_dir is not None:
        os.makedirs(checkpoint_dir, exist_ok=True)
        resumed = (_ckpt_load(checkpoint_dir, n_pad, "dbl", mesh)
                   or _ckpt_load(checkpoint_dir, n_pad, "seed", mesh))
        # a process whose build resumes may reach _ckpt_clear without a
        # collective: no file goes before every process has decided
        mesh.barrier()
    if resumed is not None:
        stats["resumed"] = True
        stats["m_act"] = resumed["m_act"]
    if resumed is not None and "rank" in resumed:
        # a "dbl" checkpoint: the doubling rounds go on from its k
        del keys, key0
        stats["path"] = "doubling"
        sa, pull, of = _doubling(
            mesh, resumed.pop("rank"), payload, key, k=resumed["k"],
            nuniq=resumed["nuniq"], n_pad=n_pad, cap=cap, stats=stats,
            overflow_acc=0, m_act=resumed["m_act"],
            checkpoint_dir=checkpoint_dir)
        _ckpt_clear(checkpoint_dir, n_pad, mesh)
        LAST_BUILD_STATS = stats
        return sa, pull, of
    if resumed is not None:
        sa, pull, st = resumed["sa"], resumed["pull"], resumed["st"]
        overflow_acc = 0
        m_act = resumed["m_act"]
    else:
        sa, pull, st, m_act_dev, of = _seed_sort(mesh, keys, payload,
                                                 n_pad=n_pad, cap=cap,
                                                 rkey=key)
        overflow_acc = int(of)
        m_act = int(m_act_dev)
        stats["m_act"] = m_act
        if checkpoint_dir is not None and overflow_acc <= 0:
            _ckpt_save(checkpoint_dir, n_pad, "seed", mesh, sa=sa, pull=pull,
                       st=st, m_act=m_act)
    del keys

    if overflow_acc <= 0 and m_act > 0:
        if m_act <= min(_REP_CAP, n_pad // 4):
            M0 = _bucket_anchored(m_act, n_pad)
            W = span
            slots0, pos, base = _rep_compact(mesh, sa, st, n_pad=n_pad,
                                             M=M0)
            slots, pos, base, m_act = _rep_extend(
                mesh, sa, st, key0, slots0, pos, base, W, n_pad=n_pad,
                T=_EXT_T, per_key=per_key)
            _pull_fix(mesh, sa, pull, payload, slots0, n_pad=n_pad)
            W += _EXT_T * per_key
            stats["ext_rounds"] = 1
            need_refix = False

            def shrink(slots, pos, base):
                M_next = _bucket_anchored(m_act, n_pad)
                return (slots[:M_next].contiguous(),
                        pos[:M_next].contiguous(),
                        base[:M_next].contiguous())

            if m_act > 0:
                slots, pos, base = shrink(slots, pos, base)
            while m_act > 0 and stats["ext_rounds"] < _EXT_MAX_ROUNDS:
                need_refix = True
                slots, pos, base, m_act = _rep_extend(
                    mesh, sa, st, key0, slots, pos, base, W, n_pad=n_pad,
                    T=_EXT_T, per_key=per_key)
                W += _EXT_T * per_key
                stats["ext_rounds"] += 1
                if m_act > 0:
                    slots, pos, base = shrink(slots, pos, base)
            if m_act > 0:
                # long-repeat tail: replicated filtered doubling; the ranks
                # are valid for k = W by construction
                need_refix = True
                rank, of = _rank_scatter(mesh, sa, st,
                                         bins.fold_in(key, 77),
                                         n_pad=n_pad, cap=cap)
                overflow_acc = max(overflow_acc, int(of))
                k = W
                while m_act > 0 and k < 2 * n_pad and overflow_acc <= 0:
                    slots, pos, base, m_act = _rep_double(
                        mesh, sa, rank, slots, pos, base, k, n_pad=n_pad)
                    k *= 2
                    stats["tail_rounds"] += 1
                    if m_act > 0:
                        slots, pos, base = shrink(slots, pos, base)
                del rank
            if need_refix:
                # rounds past the first reordered more slots: refresh the
                # payload pull from the final order
                _pull_fix(mesh, sa, pull, payload, slots0, n_pad=n_pad)
        else:
            # massively tied input: full distributed prefix doubling seeded
            # from the wide sort
            stats["path"] = "doubling"
            del key0
            rank, of = _rank_scatter(mesh, sa, st, bins.fold_in(key, 77),
                                     n_pad=n_pad, cap=cap)
            del sa, pull, st
            sa, pull, of = _doubling(
                mesh, rank, payload, key, k=span, nuniq=0, n_pad=n_pad,
                cap=cap, stats=stats,
                overflow_acc=max(overflow_acc, int(of)), m_act=m_act,
                checkpoint_dir=checkpoint_dir)
            if checkpoint_dir is not None:
                _ckpt_clear(checkpoint_dir, n_pad, mesh)
            LAST_BUILD_STATS = stats
            return sa, pull, of
    if checkpoint_dir is not None:
        _ckpt_clear(checkpoint_dir, n_pad, mesh)
    LAST_BUILD_STATS = stats
    return sa, pull, torch.full((), overflow_acc, dtype=torch.int32,
                                device=dev)


def dist_suffix_array(text: torch.Tensor, mesh, cap_factor: float = 4.0,
                      seed: int = 0, n: Optional[int] = None,
                      doc_starts: Optional[torch.Tensor] = None,
                      mark_period: int = 0,
                      checkpoint_dir: Optional[str] = None,
                      alpha: Optional[np.ndarray] = None):
    """Distributed SA + BWT of a padded text cut into the mesh's blocks.

    text: int32[Dl, m] (parallel/distributed.put_global of the padded
    text, n_pad = D * m, a multiple of D * SEG); n: the real length (n_pad
    by default); doc_starts: int32[ndocs + 1] on the mesh's device; alpha:
    the nonzero symbols present, ascending (skips the histogram).
    checkpoint_dir: save each process's blocks after the seed sort and
    after each full doubling round, and resume from the latest stage that
    every process's file holds (a shared directory; the files go when the
    call completes).  Returns (sa, bwt, a_row, overflow): int32[Dl, m]
    blocks (a_row: each row's mark bit and SEOF doc tag, 0 without
    doc_starts) and an int32 scalar; retry with a larger cap_factor when
    overflow > 0.  What the call did is left in LAST_BUILD_STATS
    ("resumed": True after a resume)."""
    if n is None:
        n = mesh.D * text.shape[1]
    sa, pull, of = _dist_sa(text, mesh, cap_factor=cap_factor, seed=seed,
                            n=n, doc_starts=doc_starts,
                            mark_period=mark_period, alpha=alpha,
                            checkpoint_dir=checkpoint_dir)
    return sa, pull & 511, pull >> 9, of


def pad_text_for_mesh(text_np: np.ndarray, D: int, seg: int = DEFAULT_SEG,
                      seg_group: int = 1):
    """Pad prepared text with trailing 0s to a multiple of D * seg *
    seg_group (seg_group = the L1 group for the compact and packed tiers,
    whose relative checkpoints need whole L1 groups per shard)."""
    n = int(text_np.shape[0])
    block = D * seg * seg_group
    n_pad = -(-n // block) * block
    out = np.zeros(n_pad, dtype=np.int32)
    out[:n] = text_np.astype(np.int32)
    return out, n_pad


# ---------------------------------------------------------------------------
# packaging
# ---------------------------------------------------------------------------


@dataclass
class _ShardRowPlan:
    """The host plan of a sharded row-tier build: one global geometry
    (femto_tpu's width argmin for vseg, vrle_plan over every shard's
    statistics for vrle), each segment's mode, and the per-shard
    capacities that keep the sharded arrays rectangular."""
    tier: str
    w_main: int
    code_words: int      # vseg: the row's code words; vrle: A
    C_words: int         # vrle: the continuation budget C; vseg: 0
    s_store: int
    w_side: int
    Wside: int
    wide: bool
    cov: np.ndarray      # bool[D, nseg_local]: not in the side table
    rle: np.ndarray      # bool[D, nseg_local]: run-length slots in the row
    cont: np.ndarray     # bool[D, nseg_local]: ... continued in seg_cont
    cw_al: np.ndarray    # int64[D, nseg_local]: continuation words, whole
                         # granules
    cwords: np.ndarray   # int64[D, nseg_local]: continuation words
    max_ovf: int         # side rows a shard holds at most
    cont_words: int      # words of a shard's continuation store
    has_rle: bool
    has_cont: bool
    ngr: int


def _row_plan(tier: str, nsym: np.ndarray, slots, *, seg: int, K: int):
    """_ShardRowPlan from every shard's symbol counts nsym int32[D,
    nseg_local] (and, on vrle, slot counts): femto_tpu's
    build_index_sharded host plan (dist_build.py 1538-1604)."""
    D, nl = nsym.shape
    n_seg = D * nl
    wide = K > 256
    w_side, Wside = BO.vseg_width_for(seg, 9 if wide else 8)
    G = BO.VRLE_CONT_G
    zero = np.zeros((D, nl), bool)
    zi = np.zeros((D, nl), np.int64)
    if tier == "vseg":
        best = None
        for w_eff, Wm in BO.vseg_width_candidates(seg):
            cov = (nsym <= (1 << w_eff)) & (nsym < 255)
            nbytes = n_seg * Wm * 4 + int((~cov).sum()) * Wside * 4
            if best is None or nbytes < best[0]:
                best = (nbytes, w_eff, Wm, cov)
        _, w_main, Wm, cov = best
        return _ShardRowPlan(
            tier=tier, w_main=w_main, code_words=Wm, C_words=0,
            s_store=BO.vseg_sym_store(w_main, wide), w_side=w_side,
            Wside=Wside, wide=wide, cov=cov, rle=zero, cont=zero, cw_al=zi,
            cwords=zi, max_ovf=int((~cov).sum(axis=1).max()), cont_words=0,
            has_rle=False, has_cont=False, ngr=1)
    (w_main, A, C, s_store, rle, cont, wfit) = BO.vrle_plan(
        nsym.reshape(-1), slots.reshape(-1), seg=seg, n_seg=n_seg,
        wide=wide, Wside=Wside)
    rle, cont = rle.reshape(D, nl), cont.reshape(D, nl)
    cov = rle | cont | wfit.reshape(D, nl)
    w_slot, _ = BO.vrle_slot_geom_np(nsym)
    bits = slots.astype(np.int64) * w_slot
    cwords = np.where(cont, -(-bits // 32) - A, 0)
    cw_al = -(-cwords // G) * G
    return _ShardRowPlan(
        tier=tier, w_main=w_main, code_words=A, C_words=C, s_store=s_store,
        w_side=w_side, Wside=Wside, wide=wide, cov=cov, rle=rle, cont=cont,
        cw_al=cw_al, cwords=cwords, max_ovf=int((~cov).sum(axis=1).max()),
        cont_words=int(cw_al.sum(axis=1).max()),
        has_rle=bool((rle | cont).any()), has_cont=bool(cont.any()),
        ngr=max(1, -(-max(C, 1) // G)))


def _shard_rows(plan: _ShardRowPlan, d: int, bwt, amap, syms, nsym, mbits,
                mckpt, occ_rel):
    """One shard's serving rows and row-tier fields at the global plan
    (femto_tpu's _package_shard_vseg / _package_shard_vrle): side rows
    numbered from 1 within the shard, the side table padded to max_ovf + 2
    rows, continuation offsets within the shard's own flat store of
    cont_words + ngr granules.  Kernels M and N at the plan's geometry."""
    dev = bwt.device
    G = BO.VRLE_CONT_G
    cov, rle, cont = plan.cov[d], plan.rle[d], plan.cont[d]
    woff = np.zeros(cov.shape[0], np.int64)
    woff[rle] = -1
    coffs = np.cumsum(plan.cw_al[d]) - plan.cw_al[d]
    woff[cont] = -(2 + coffs[cont])
    woff[~cov] = np.arange(1, int((~cov).sum()) + 1)
    seg_woff = BO._host_i32(woff, dev)
    rle_rows, cont_store = None, None
    if plan.tier == "vrle":
        if plan.has_rle:
            rle_rows = BO.vrle_pack(bwt, amap, syms, nsym, seg_woff,
                                    words=plan.code_words + plan.C_words)
        total = plan.cont_words + plan.ngr * G
        cidx = np.nonzero(cont)[0]
        if len(cidx):
            cont_store = BO.cont_flatten(
                rle_rows, BO._host_i32(cidx, dev),
                BO._host_i32(plan.cwords[d][cidx], dev),
                BO._host_i32(coffs[cidx], dev), first=plan.code_words,
                total=total)
        else:
            cont_store = torch.zeros(total, dtype=torch.int32,
                                     device=dev).view(torch.uint32)
    rows = BO.vseg_rows(bwt, amap, syms, nsym, seg_woff, mbits, mckpt,
                        occ_rel, w_main=plan.w_main,
                        code_words=plan.code_words, s_store=plan.s_store,
                        wide=plan.wide, rle=rle_rows)
    del rle_rows
    ovf = np.nonzero(~cov)[0]
    side = (BO.side_rows(bwt, amap, BO._host_i32(ovf, dev),
                         w_side=plan.w_side) if len(ovf) else None)
    pad = torch.zeros((plan.max_ovf + 2 - (len(ovf) + 1), plan.Wside),
                      dtype=torch.int32, device=dev).view(torch.uint32)
    if side is None:
        side = torch.zeros((1, plan.Wside), dtype=torch.int32,
                           device=dev).view(torch.uint32)
    return rows, seg_woff, torch.cat([side, pad]), cont_store


def _package(mesh, sa, pull, doc_starts, used_np, *, n_pad: int, seg: int,
             ndocs: int, cap_local: int, mark_geom, tier: str):
    """Each shard packages its own rows (kernels A or A', F, B; on the
    row tiers M and N at a host plan of every shard's statistics), then
    the cross-shard bases (K18b) make its checkpoints global.  Returns
    (fields dict, n_marks, mark_overflow) with host ints for the last
    two."""
    Dl, m = sa.shape
    dev = sa.device
    nseg_local = m // seg
    K = int(used_np.shape[0])
    bits_g, exc_base, exc_cap, n_words, period = mark_geom
    amap_np = np.full(ALPHA_SIZE, -1, np.int32)
    amap_np[used_np] = np.arange(K, dtype=np.int32)
    amap = torch.from_numpy(amap_np).to(dev)
    arev = torch.from_numpy(np.asarray(used_np, np.int32)).to(dev)
    row_tier = tier in ("vseg", "vrle")
    smax = BO.VSEG_SMAX if tier == "vseg" else BO.VRLE_SMAX
    grp = 1 if tier == "full" else l1_group_for(seg)
    bwts, occs, l1s, totals = [], [], [], []
    mbits, mckpts, mvals, nmarks, seofs = [], [], [], [], []
    symss, nsyms, slotss = [], [], []
    ids = shard_ids(mesh)
    for j in range(Dl):
        p64 = pull[j].to(torch.int64)
        if tier == "full":
            # one extra segment: kernel A takes n_seg * seg > n
            bwt, a_row, occ, C = BO.occ_build(p64, n_seg=nseg_local + 1,
                                              seg=seg)
            occs.append(occ[:nseg_local])
        else:
            bwt, a_row, occ, l1, C, *hist = BO.occ_build_compact(
                p64, amap, arev, n_seg=nseg_local + grp, seg=seg,
                want_hist=row_tier)
            occs.append(occ[:nseg_local])
            l1s.append(l1[:nseg_local // grp])
            if tier == "packed":
                per_word, bits = BO.pack_widths(K)
                bwt = BO.pack_build(bwt, amap, per_word=per_word, bits=bits)
            elif row_tier:
                # kernel M's symbol lists (and N's slot counts) of the
                # shard's segments: the statistics of the host plan
                bwt = bwt[:nseg_local]
                syms, nsym = BO.seg_syms(hist[0][:nseg_local], smax)
                symss.append(syms)
                nsyms.append(nsym)
                if tier == "vrle":
                    slotss.append(BO.vrle_slot_count(bwt, amap, syms, nsym))
                del hist
            else:
                # dense codes as uint16: F packs two 16-bit codes a word
                bwt = BO.pack_build(bwt, amap, per_word=2, bits=16).view(
                    torch.uint16)
        del p64
        bwts.append(bwt[:nseg_local])
        totals.append(C[1:] - C[:-1])
        mb, mc, mv, cnt, seof = DO.shard_marks(
            sa[j], a_row, seg=seg, mark_period=period, cap=cap_local,
            bits=bits_g, exc_base=exc_base, exc_cap=exc_cap,
            n_words=n_words, ndocs=ndocs)
        del a_row
        mbits.append(mb)
        mckpts.append(mc)
        mvals.append(mv)
        nmarks.append(cnt)
        seofs.append(torch.where(seof >= 0, seof + ids[j] * m, 0))
    # the cross-shard bases: exclusive prefix over the mesh of the totals,
    # added to the checkpoints in the same launch
    gathered = mesh.all_gather(torch.stack(totals))         # [D, A]
    if tier == "full":
        occ_ckpt = torch.stack(occs)
        _, C = DO.add_mesh_base(occ_ckpt, gathered, shard0=mesh.shard0,
                                want_c=True)
        occ_ckpt = occ_ckpt.view(Dl * nseg_local, -1)
        occ_l1 = torch.zeros((1, ALPHA_SIZE), dtype=torch.int32, device=dev)
    else:
        occ_l1 = torch.stack(l1s)
        _, C = DO.add_mesh_base(occ_l1, gathered, shard0=mesh.shard0,
                                want_c=True)
        occ_l1 = occ_l1.view(Dl * (nseg_local // grp), K)
    local_marks = torch.stack(nmarks).view(Dl)
    mark_ckpt = torch.stack(mckpts).view(Dl, nseg_local, 1)
    mark_base, _ = DO.add_mesh_base(
        mark_ckpt, mesh.all_gather(local_marks.view(Dl, 1)),
        shard0=mesh.shard0, want_base=True)
    n_marks = int(mesh.psum(local_marks))
    mark_of = int(mesh.pmax(torch.clamp(local_marks - cap_local, min=0)))
    fields = dict(
        C=C, mark_vals=torch.cat(mvals),
        doc_seof_rows=mesh.psum(torch.stack(seofs)),
        alpha_map=(torch.arange(ALPHA_SIZE, dtype=torch.int32, device=dev)
                   if tier == "full" else amap),
        alpha_rev=(torch.arange(ALPHA_SIZE, dtype=torch.int32, device=dev)
                   if tier == "full" else arev))
    if not row_tier:
        occ_ckpt = (occ_ckpt if tier == "full"
                    else torch.stack(occs).view(Dl * nseg_local, K))
        fields.update(bwt=torch.cat(bwts), occ_ckpt=occ_ckpt, occ_l1=occ_l1,
                      mark_bits=torch.cat(mbits),
                      mark_ckpt=mark_ckpt.view(-1))
        return fields, n_marks, mark_of
    # the row tiers: every shard's statistics cross to the host once, the
    # host picks one geometry, then each shard assembles its rows with its
    # global mark checkpoints inside them
    nsym_np = mesh.all_gather(torch.stack(nsyms).to(torch.int32)).cpu() \
        .numpy()
    slots_np = (mesh.all_gather(torch.stack(slotss)).cpu().numpy()
                if tier == "vrle" else None)
    plan = _row_plan(tier, nsym_np, slots_np, seg=seg, K=K)
    rows, woffs, ovfs, conts = [], [], [], []
    for j in range(Dl):
        r, w, o, c = _shard_rows(plan, mesh.shard0 + j, bwts[j], amap,
                                 symss[j], nsyms[j], mbits[j],
                                 mark_ckpt[j].view(-1), occs[j])
        bwts[j] = symss[j] = None
        rows.append(r)
        woffs.append(w)
        ovfs.append(o)
        conts.append(c)
    fields.update(
        bwt=torch.cat(rows),
        occ_ckpt=torch.zeros((1, K), dtype=torch.int16,
                             device=dev).view(torch.uint16),
        occ_l1=occ_l1,
        mark_bits=torch.zeros((1, seg // 32), dtype=torch.int32,
                              device=dev).view(torch.uint32),
        mark_ckpt=mark_base.view(Dl), seg_ovf=torch.cat(ovfs),
        seg_nsym=torch.cat(nsyms), seg_woff=torch.cat(woffs),
        seg_syms=BO._sym_marker(plan.s_store, plan.wide, dev))
    if tier == "vrle":
        scheme = (3 + plan.ngr if plan.has_cont else 3) if plan.has_rle \
            else 1
        fields.update(
            seg_rle=torch.zeros((scheme, plan.w_main), dtype=torch.int32,
                                device=dev),
            seg_cont=torch.cat(conts).view(-1, BO.VRLE_CONT_G))
    return fields, n_marks, mark_of


def _doc_lists(mesh, sa, doc_starts, *, n: int, seg: int):
    """(chunk_doc_offsets_np, chunk_docs_np) of a sharded build: kernel P
    lists each shard's segments' documents, the counts cross to the host,
    and P's flatten_ragged compacts each shard's lists (femto_tpu's
    build_index_sharded doc_chunks)."""
    Dl, m = sa.shape
    nseg_local = m // seg
    lists = [BO.doc_lists(sa[j], doc_starts, n_real=n, n_seg=nseg_local,
                          seg=seg) for j in range(Dl)]
    counts = np.concatenate([c.cpu().numpy() for _, c in lists]).astype(
        np.int64)
    offs = np.zeros(counts.shape[0] + 1, np.int64)
    np.cumsum(counts, out=offs[1:])
    flat = []
    for j, (vals, cnt) in enumerate(lists):
        o = offs[j * nseg_local: (j + 1) * nseg_local + 1]
        flat.append(BO.flatten_ragged(
            vals, cnt, torch.from_numpy(o - o[0]).to(sa.device)).cpu()
            .numpy())
    return offs, np.concatenate(flat).astype(np.int32)


def build_index_sharded(prepared, mesh, seg: int = DEFAULT_SEG,
                        mark_period: int = DEFAULT_MARK_PERIOD,
                        cap_factor: float = 4.0, max_retries: int = 3,
                        checkpoint_dir: Optional[str] = None,
                        tier: str = "full",
                        mark_cap_local0: Optional[int] = None,
                        doc_chunks: bool = False) -> FMIndex:
    """Distributed end-to-end build on the mesh's device: the sharded
    suffix sort, then per-shard packaging (tier "full", "compact",
    "packed", "vseg" or "vrle"); no host O(n) step (the row tiers pull
    O(n_seg) statistics for their plan).  Overflow of an exchange retries
    with a doubled cap_factor (a fresh seed each time), then with cap = m;
    the per-shard mark capacity grows on overflow.  checkpoint_dir: the
    suffix sort saves and resumes its state there (dist_suffix_array).
    doc_chunks: the per-segment document lists (chunk_doc_offsets_np,
    chunk_docs_np), host metadata that needs every shard in this process
    (a LocalMesh or a one-process DistMesh).  Returns an FMIndex of the
    process's shard blocks (see the module docstring)."""
    if tier not in ("full", "compact", "packed", "vseg", "vrle"):
        raise ValueError(f"unknown sharded tier {tier!r}")
    if doc_chunks and mesh.Dl != mesh.D:
        raise ValueError(
            "doc_chunks is host-side metadata and needs every shard "
            "addressable; build chunk doc-lists on single-process meshes")
    if tier != "full":
        l1_group_for(seg)
    from .distributed import put_global

    D = mesh.D
    dev = mesh.device
    n = prepared.n
    ndocs = prepared.num_docs
    text_pad, n_pad = pad_text_for_mesh(
        prepared.text, D, seg,
        seg_group=1 if tier == "full" else l1_group_for(seg))
    text_dev = put_global(text_pad, mesh)
    doc_starts_dev = torch.from_numpy(
        np.asarray(prepared.doc_starts, np.int32)).to(dev)
    # the symbol set from one histogram on the device (the pad symbols
    # taken off again)
    hist = _text_hist(mesh, text_dev)
    hist[0] -= n_pad - n
    alpha = np.nonzero(hist)[0].astype(np.int32)
    # the BWT of the padded text also holds the pad symbol 0
    used_np = (np.unique(np.concatenate([[0], alpha])).astype(np.int32)
               if n_pad > n else alpha)
    K = int(used_np.shape[0])

    cf = cap_factor
    for attempt in range(max_retries):
        sa, pull, overflow = _dist_sa(
            text_dev, mesh, cap_factor=cf, seed=attempt, n=n,
            doc_starts=doc_starts_dev, mark_period=mark_period, alpha=alpha,
            checkpoint_dir=checkpoint_dir)
        if int(overflow) <= 0:
            break
        cf *= 2.0
    else:
        # deterministic last resort: cap = m (one pair never carries more
        # than one shard's whole block)
        sa, pull, overflow = _dist_sa(
            text_dev, mesh, cap_factor=float(D), seed=max_retries, n=n,
            doc_starts=doc_starts_dev, mark_period=mark_period, alpha=alpha,
            checkpoint_dir=checkpoint_dir)
        if int(overflow) > 0:
            raise RuntimeError(
                "distributed sort capacity overflow even at cap=m")
    del text_dev

    m = n_pad // D
    cap_total = BO.mark_cap(n_pad, ndocs, mark_period, seg)
    cap_local = min(BO.mark_cap(m, min(ndocs, m), mark_period, seg) * 2,
                    cap_total)
    if mark_cap_local0 is not None:
        cap_local = min(max(128, -(-mark_cap_local0 // 128) * 128),
                        cap_total)
    mark_cap_retries = 0
    while True:
        if mark_period == 0:
            mark_geom = (1, 1, 1, 1, 0)
        else:
            bits_g, exc_base, exc_cap, n_words = BO.mark_pack_geom(
                n, mark_period, ndocs, cap_local)
            mark_geom = (bits_g, exc_base, exc_cap, n_words, mark_period)
        fields, n_marks, mark_of = _package(
            mesh, sa, pull, doc_starts_dev, used_np, n_pad=n_pad, seg=seg,
            ndocs=ndocs, cap_local=cap_local, mark_geom=mark_geom, tier=tier)
        if mark_of <= 0:
            break
        if cap_local >= cap_total:
            raise RuntimeError("per-shard mark capacity overflow")
        cap_local = min(cap_local * 4, cap_total)
        mark_cap_retries += 1
    LAST_BUILD_STATS["mark_cap_retries"] = mark_cap_retries
    del pull
    chunk_offs = chunk_docs = None
    if doc_chunks:
        chunk_offs, chunk_docs = _doc_lists(mesh, sa, doc_starts_dev, n=n,
                                            seg=seg)
    del sa
    arrays = FMArrays(
        doc_starts=doc_starts_dev,
        mark_meta=torch.tensor(
            [mark_geom[0], mark_geom[1], mark_geom[4], mark_geom[3],
             cap_local], dtype=torch.int32, device=dev),
        **fields)
    meta = FMMeta(n=n, seg=seg, mark_period=mark_period, num_docs=ndocs,
                  n_marks=n_marks, n_seg=n_pad // seg,
                  alpha_used=0 if tier == "full" else K, n_rows=n_pad,
                  row0=n_pad - n)
    return FMIndex(arrays=arrays, meta=meta,
                   doc_starts_np=np.asarray(prepared.doc_starts, np.int64),
                   infos=list(prepared.infos),
                   header_lens_np=prepared.header_lens,
                   chunk_doc_offsets_np=chunk_offs, chunk_docs_np=chunk_docs)
