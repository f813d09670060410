#!/usr/bin/env python3
"""On-card smoke test of femto_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py [--seed 1234]

Needs one CUDA card and nvcc; without them it exits non-zero and prints no
result.  It imports neither jax nor femto_tpu.  Phases (any failure exits
non-zero):

1. card and toolchain: nvidia-smi name and power limit, CUDA, nvcc, triton;
2. build every kernel under femto_tpu_torch/csrc/ with nvcc for sm_90a;
3. each kernel against its plain PyTorch version, bit for bit, on an 8 MiB
   seeded corpus (zipf English, a repeat-heavy, a binary and an empty doc);
4. the main path at full size (a 256 MiB zipf-English corpus in 64 KiB
   documents): build_index(tier="full", seg=256, mark_period=20), count of
   32768 16-symbol patterns, locate of 65536 rows (walk and direct), and
   extract_document of 8 documents, each checked, with the kernels'
   launch counts read around this phase alone;
5. numbers: medians of 3 runs, per-kernel times beside their bounds, their
   plain versions and a one-call PyTorch yardstick where one exists; the
   kernels at the main path's shapes are compared with their plain
   versions again;
6. where the time goes: device time by kernel and the device's busy share
   over one build, count, locate and extract (torch.profiler).

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and before that the "kernels" JSON line.  The
full record goes to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
DOC_SIZE = 1 << 16
PATLEN = 16
N_PATTERNS = 32768
N_LOCATE = 65536
MAIN_MIB = 256  # the main path's corpus size
ZIPF_LETTERS = b"etaoin shrdlucmfwypvbgkqjxz.,\n"
KERNELS = {  # entry -> (source, the femto_tpu function it replaces)
    "occ_build": ("femto_tpu_torch/csrc/occ_build.cu",
                  "femto_tpu/ops/build_ops.py:197"),
    "marks_build": ("femto_tpu_torch/csrc/marks_build.cu",
                    "femto_tpu/ops/build_ops.py:1033"),
    "backward_search": ("femto_tpu_torch/csrc/backward_search.cu",
                        "femto_tpu/ops/search_ops.py:23"),
    "lf_locate": ("femto_tpu_torch/csrc/lf_walk.cu",
                  "femto_tpu/ops/search_ops.py:115"),
    "lf_extract": ("femto_tpu_torch/csrc/lf_walk.cu",
                   "femto_tpu/ops/search_ops.py:342"),
}


class SmokeError(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def zipf_bytes(rng, n):
    """n bytes of zipf-distributed English letters (p ~ 1/rank over 30
    symbols), drawn through a 65536-entry quantile table."""
    p = 1.0 / np.arange(1, len(ZIPF_LETTERS) + 1)
    edges = np.round(np.cumsum(p / p.sum()) * 65536).astype(np.int64)
    table = np.repeat(np.frombuffer(ZIPF_LETTERS, np.uint8),
                      np.diff(np.concatenate([[0], edges])))
    return table[rng.integers(0, 65536, size=n, dtype=np.int64)]


def zipf_docs(rng, n_docs):
    """n_docs documents of DOC_SIZE - 1 bytes (DOC_SIZE symbols with SEOF)."""
    body = zipf_bytes(rng, n_docs * DOC_SIZE).reshape(n_docs, DOC_SIZE)
    return [body[i, : DOC_SIZE - 1].tobytes() for i in range(n_docs)]


def small_docs(rng):
    """~8 MiB: zipf English plus a repeat-heavy, a binary and an empty doc."""
    docs = zipf_docs(rng, 124)
    docs.append((b"abcabcabd" * (DOC_SIZE // 9 + 1))[: DOC_SIZE - 1])
    docs.append(b"a" * 8192)
    docs.append(rng.integers(0, 256, size=DOC_SIZE - 1, dtype=np.uint8)
                .tobytes())
    docs.append(b"")
    return docs


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def as_i64(t):
    import torch

    from femto_tpu_torch.ops.rank import u16_to_i32, u32_to_i64

    if t.dtype == torch.uint16:
        return u16_to_i32(t).long()
    if t.dtype == torch.uint32:
        return u32_to_i64(t)
    return t.long()


def max_abs_err(name, got, want):
    """Max |got - want| over matching tensors; raises unless bit-equal."""
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}[{i}]: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        if g.numel():
            err = max(err, int((as_i64(g) - as_i64(w)).abs().max()))
    check(err == 0, f"{name}: kernel differs from its plain version "
                    f"(max abs err {err})")
    return err


def cuda_ms(fn, reps=3):
    """Median device time of fn in ms (CUDA events), after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_runs(fn, reps=3):
    """[seconds] of reps runs of fn, each ending in a device sync."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def summary(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "runs": len(xs)}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def text_tensor(prepared, dev):
    import torch

    return torch.from_numpy(prepared.text.view(np.int16)).to(dev).to(
        torch.int32)


# ---------------------------------------------------------------------------
# bounds: bytes each function must move for this run's data, over HBM rate
# ---------------------------------------------------------------------------


def bound_occ_build(n, n_seg, seg):
    return (8 * n + 2 * n_seg * seg + 4 * n + 4 * 261 * n_seg
            + 4 * 262) / HBM_BYTES_PER_S * 1e3


def bound_marks_build(n, n_seg, seg, n_marks, mark_vals_len, ndocs):
    return (4 * n + 4 * n_marks + n_seg * seg // 8 + 4 * n_seg
            + 4 * mark_vals_len + 4 * ndocs) / HBM_BYTES_PER_S * 1e3


def bound_backward_search(arrays, pats, n_rows, row0):
    """Patterns + outputs + per valid step C[c] and, for first and last,
    one checkpoint int and the 2*off bytes of segment prefix counted."""
    import torch

    from femto_tpu_torch.ops import rank as R

    n_seg, seg = arrays.bwt.shape
    B, P = pats.shape
    first = torch.full((B,), row0, dtype=torch.int32, device=pats.device)
    last = torch.full((B,), n_rows, dtype=torch.int32, device=pats.device)
    total = 4 * B * P + 8 * B
    for j in range(P - 1, -1, -1):
        col = pats[:, j]
        active = col >= 0
        valid = active & (col < 261)
        total += 4 * int(valid.sum())
        for r in (first, last):
            inside = valid & (r < n_seg * seg)
            total += int((inside * (4 + 2 * (r % seg))).sum())
        nf, nl = R.backward_step_pair(arrays, col, first, last)
        first = torch.where(active, nf, first)
        last = torch.where(active, nl, last)
    return total / HBM_BYTES_PER_S * 1e3


def bound_locate(arrays, mark_period, rows):
    """Rows in, offsets out; per step the mark word, and on a miss the
    symbol, C[c], a checkpoint and the counted prefix; on a hit the
    segment's earlier mark words, mark_ckpt and two mark_vals words."""
    import torch

    from femto_tpu_torch.ops import rank as R

    seg = arrays.bwt.shape[1]
    total = 8 * rows.shape[0]
    done = torch.zeros_like(rows, dtype=torch.bool)
    r = rows
    for _ in range(mark_period + 1):
        if bool(done.all()):
            break
        nxt, bit, _ = R.lf_grank_step(arrays, r)
        act = ~done
        off = (r % seg).long()
        hit = bit & act
        miss = act & ~bit
        total += 4 * int(act.sum())
        total += int((hit * (4 * (off // 32) + 12)).sum())
        total += int((miss * (10 + 2 * off)).sum())
        done = done | hit
        r = torch.where(done, r, nxt)
    return total / HBM_BYTES_PER_S * 1e3


def bound_extract(isa, seof_pos, dlen, seg):
    """The rows an extract of one doc visits are isa[seof - t]; per step a
    symbol, C[c], a checkpoint, the counted prefix and the output int."""
    import torch

    pos = seof_pos - torch.arange(dlen, device=isa.device)
    off = isa[pos] % seg
    total = 8 + int((14 + 2 * off).sum())
    return total / HBM_BYTES_PER_S * 1e3


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_toolchain(record):
    import torch

    from femto_tpu_torch import kernels

    card = card_line()
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    check(nvcc.returncode == 0, "nvcc --version failed")
    try:
        import triton  # noqa: F401  (recorded, never used by the port)
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    record["toolchain"] = {
        "card": card, "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "nvcc": nvcc.stdout.strip().splitlines()[-1],
        "triton": triton_v, "python": sys.version.split()[0],
        "device_count": torch.cuda.device_count(),
    }
    log(f"[1] card: {card}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; {record['toolchain']['nvcc']}; "
        f"triton {triton_v}")


def phase_build(record):
    from femto_tpu_torch import kernels

    t0 = time.perf_counter()
    per = kernels.build()
    total = time.perf_counter() - t0
    record["build_seconds"] = {"total": total, **per}
    ptxas = {src: [ln.strip() for ln in log_.splitlines()
                   if "registers" in ln or "spill" in ln]
             for src, log_ in kernels.build_logs.items()}
    record["ptxas"] = ptxas
    log(f"[2] built {sorted(per)} in {total:.2f}s (parallel nvcc)")
    for src, lines in ptxas.items():
        for ln in lines:
            log(f"    {src}: {ln}")


def phase_parity(record, rng):
    """Every kernel against its plain version on an 8 MiB corpus."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.search import pack_patterns
    from femto_tpu_torch.alphabet import pattern_to_alpha

    dev = torch.device("cuda")
    docs = small_docs(rng)
    prepared = tt.prepare_documents(docs)
    n, ndocs, seg = prepared.n, prepared.num_docs, 256
    n_seg = n // seg + 1
    text = text_tensor(prepared, dev)
    ds = torch.from_numpy(prepared.doc_starts.astype(np.int32)).to(dev)
    errs = {}

    payload = BO.build_sa_payload(text, ds, n=n, mark_period=20, ndocs=ndocs)
    sa, pull = tt.suffix_array(text, payload=payload)
    a_k = BO.occ_build(pull, n_seg=n_seg, seg=seg)
    a_p = BO.occ_build_plain(pull, n_seg=n_seg, seg=seg)
    torch.cuda.synchronize()
    errs["occ_build"] = max_abs_err("occ_build", a_k, a_p)
    for mp in (20, 0):
        pl = BO.build_sa_payload(text, ds, n=n, mark_period=mp, ndocs=ndocs)
        a_row = (pl[sa.long()] >> 9).to(torch.int32)
        kw = dict(n_seg=n_seg, seg=seg, mark_period=mp, ndocs=ndocs)
        b_k = BO.marks_build(sa, a_row, **kw)
        b_p = BO.marks_build_plain(sa, a_row, **kw)
        torch.cuda.synchronize()
        errs[f"marks_build(mark_period={mp})"] = max_abs_err(
            f"marks_build(mark_period={mp})", b_k, b_p)

    # the whole build on the card against the whole build on the CPU
    ix = tt.build_index(prepared, seg=seg, mark_period=20, locate="direct",
                        device="cuda")
    ix_cpu = tt.build_index(prepared, seg=seg, mark_period=20, device="cpu")
    for k, v in ix_cpu.arrays._asdict().items():
        w = getattr(ix.arrays, k)
        check((v is None) == (w is None), f"field {k}")
        if v is not None:
            max_abs_err(f"build_index field {k}", [w.cpu()], [v])
    check(dataclasses.asdict(ix.meta) == dataclasses.asdict(ix_cpu.meta),
          "meta differs between card and CPU builds")
    check(torch.equal(ix.sa_direct, sa), "sa_direct differs")

    arrays = ix.arrays
    pats = []
    for _ in range(4000):
        d = int(rng.integers(0, len(docs) - 1))
        L = int(rng.integers(1, 41))
        if len(docs[d]) > L:
            o = int(rng.integers(0, len(docs[d]) - L))
            pats.append(docs[d][o: o + L])
    pats += [b"", b"\x00\x01\x02absent\xff", docs[-2][:300], b"e" * 60]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    packed[B - 1, -3] = 300  # a code outside the alphabet
    pt = torch.from_numpy(packed).to(dev)
    c_k = S.backward_search(arrays, n, pt)
    c_p = S.backward_search_plain(arrays, n, pt)
    torch.cuda.synchronize()
    errs["backward_search"] = max_abs_err("backward_search", c_k, c_p)
    counts = (c_k[1] - c_k[0])[: B - 1].cpu().numpy()
    check((counts[:-5] >= 1).all(), "a sliced pattern was not found")

    rows = torch.cat([
        torch.from_numpy(rng.integers(0, n, size=32768).astype(np.int32)),
        torch.arange(0, 2048, dtype=torch.int32)]).to(dev)
    rows = torch.cat([rows, arrays.doc_seof_rows])
    d_k = S.locate_rows(arrays, 20, rows)
    d_p = S.locate_rows_plain(arrays, 20, rows)
    torch.cuda.synchronize()
    errs["lf_locate"] = max_abs_err("lf_locate", [d_k], [d_p])
    check(torch.equal(d_k, sa[rows.long()]), "walk locate != suffix array")
    er = rows[:512].contiguous()
    e_k = S.extract_backward(arrays, er, 300)
    e_p = S.extract_backward_plain(arrays, er, 300)
    torch.cuda.synchronize()
    errs["lf_extract"] = max_abs_err("lf_extract", e_k, e_p)
    for d in (0, len(docs) - 4, len(docs) - 3, len(docs) - 2, len(docs) - 1):
        check(tt.extract_document(ix, d) == docs[d], f"extract doc {d}")
    record["parity_8mib"] = {"n": n, "ndocs": ndocs, "max_abs_err": errs}
    log(f"[3] 8 MiB parity (n={n}): every kernel equals its plain version "
        f"bit for bit: {sorted(errs)}")


def direct_count(text, pat_codes):
    """Occurrences of a pattern by a scan of the text on the card: the
    candidate starts of its first symbol, filtered symbol by symbol."""
    import torch

    P = len(pat_codes)
    cand = torch.nonzero(text[: text.shape[0] - P + 1] == int(pat_codes[0]))
    cand = cand.flatten()
    for k in range(1, P):
        cand = cand[text[cand + k] == int(pat_codes[k])]
    return int(cand.shape[0])


def phase_main(record, rng):
    """The port's main path at full size, through the user entry points,
    with the kernels' launch counts read around it."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.alphabet import pattern_to_alpha

    n_docs = (MAIN_MIB << 20) // DOC_SIZE
    t0 = time.perf_counter()
    docs = zipf_docs(rng, n_docs)
    prepared = tt.prepare_documents(docs)
    n = prepared.n
    t_data = time.perf_counter() - t0
    pd = rng.integers(0, n_docs, size=N_PATTERNS)
    po = rng.integers(0, DOC_SIZE - PATLEN - 2, size=N_PATTERNS)
    patterns = [docs[d][o: o + PATLEN] for d, o in zip(pd, po)]
    loc_rows = rng.integers(0, n, size=N_LOCATE).astype(np.int32)
    ext_docs = [int(d) for d in rng.choice(n_docs - 1, 7, replace=False)]
    ext_docs.append(n_docs - 1)
    log(f"[4] corpus: {MAIN_MIB} MiB zipf English, {n_docs} docs, n={n} "
        f"(made in {t_data:.1f}s)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    index = tt.build_index(prepared, seg=256, mark_period=20,
                           locate="direct", device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    walk = dataclasses.replace(index, sa_direct=None)
    t0 = time.perf_counter()
    first, last = tt.count_ranges(walk, patterns)
    t_count = time.perf_counter() - t0
    offs_walk = tt.locate_rows_array(walk, loc_rows)
    offs_direct = tt.locate_rows_array(index, loc_rows)
    matches = []
    for p in patterns:
        if len(matches) >= 256:
            break
        matches += [(p, d, o) for d, o in tt.locate(walk, p)]
    extracted = {d: tt.extract_document(walk, d) for d in ext_docs}
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    log(f"    main path: build {t_build:.2f}s (first call), count "
        f"{t_count:.3f}s, peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")

    counts = last - first
    check((counts >= 1).all(), "a pattern sliced from the text has count 0")
    text = text_tensor(prepared, torch.device("cuda"))
    for i in rng.choice(N_PATTERNS, 32, replace=False):
        want = direct_count(text, pattern_to_alpha(patterns[i]))
        check(int(counts[i]) == want,
              f"count of pattern {i}: {int(counts[i])} != scan {want}")
    check(np.array_equal(offs_walk, offs_direct),
          "walk locate differs from sa_direct[rows]")
    check(len(matches) >= 256, "fewer than 256 matches located")
    for p, d, o in matches[:256]:
        check(docs[d][o: o + len(p)] == p, f"located match {d}:{o} wrong")
    for d, got in extracted.items():
        check(got == docs[d], f"extract_document({d}) differs")
    for name, cnt in launches.items():
        check(cnt >= 1, f"kernel {name} was not launched on the main path")
    log(f"    checks: counts >= 1, 32 sampled counts == text scan, walk == "
        f"direct on {N_LOCATE} rows, 256 matches in the text, "
        f"{len(ext_docs)} documents extracted exactly")
    record["main_path"] = {
        "mib": MAIN_MIB, "n": n, "ndocs": n_docs, "seg": 256,
        "mark_period": 20,
        "first_build_s": t_build, "peak_device_bytes": peak,
        "n_marks": index.meta.n_marks, "launches": launches,
    }
    return dict(prepared=prepared, docs=docs, index=index, walk=walk,
                text=text, patterns=patterns, loc_rows=loc_rows,
                ext_docs=ext_docs, launches=launches)


def phase_numbers(record, st):
    """End-to-end rates (medians of 3) and each kernel at the main path's
    shapes against its bound, its plain version and a library call."""
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.ops import build_ops as BO
    from femto_tpu_torch.ops import search_ops as S
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.search import pack_patterns
    from femto_tpu_torch.suffix import suffix_array

    prepared, index, walk = st["prepared"], st["index"], st["walk"]
    text = st["text"]
    n, ndocs = prepared.n, prepared.num_docs
    mib = n / 2**20
    seg, mp = 256, 20
    n_seg = n // seg + 1
    dev = text.device
    ds = torch.from_numpy(prepared.doc_starts.astype(np.int32)).to(dev)
    rates = {}

    build = wall_runs(lambda: tt.build_index(prepared, seg=seg,
                                             mark_period=mp, device="cuda"))
    rates["build_mib_per_s"] = summary([mib / t for t in build])
    box = {}

    def sort():
        payload = BO.build_sa_payload(text, ds, n=n, mark_period=mp,
                                      ndocs=ndocs)
        box["sa"], box["pull"] = suffix_array(text, payload=payload)

    def package():
        box["arrays"] = BO.build_fm_arrays_device(
            text, box["sa"], ds, n=n, seg=seg, mark_period=mp, ndocs=ndocs,
            pull=box["pull"])

    rates["sort_mib_per_s"] = summary([mib / t for t in wall_runs(sort)])
    rates["packaging_mib_per_s"] = summary(
        [mib / t for t in wall_runs(package)])
    patterns = st["patterns"]
    steps = len(patterns) * PATLEN
    rates["count_steps_per_s"] = summary(
        [steps / t for t in wall_runs(lambda: tt.count(walk, patterns))])
    rows = st["loc_rows"]
    rates["locate_walk_rows_per_s"] = summary(
        [len(rows) / t
         for t in wall_runs(lambda: tt.locate_rows_array(walk, rows))])
    rates["locate_direct_rows_per_s"] = summary(
        [len(rows) / t
         for t in wall_runs(lambda: tt.locate_rows_array(index, rows))])
    d0 = st["ext_docs"][0]
    rates["extract_chars_per_s"] = summary(
        [(DOC_SIZE - 1) / t
         for t in wall_runs(lambda: tt.extract_document(walk, d0))])
    record["rates"] = rates
    for k, v in rates.items():
        log(f"[5] {k}: {v['median']:.6g} (min {v['min']:.6g}, max "
            f"{v['max']:.6g}, {v['runs']} runs)")

    # kernels at the main path's shapes
    arrays = walk.arrays
    sa, pull = box["sa"], box["pull"]
    a_row = BO.occ_build(pull, n_seg=n_seg, seg=seg)[1]
    kern = {}

    def kernel_row(name, run_k, run_p, bound_ms, library=None):
        got, want = run_k(), run_p()
        torch.cuda.synchronize()
        err = max_abs_err(name, got, want)
        del got, want
        ms = cuda_ms(run_k)
        plain_ms = cuda_ms(run_p, reps=1)
        lib_ms = cuda_ms(library) if library is not None else None
        src, replaces = KERNELS[name]
        kern[name] = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": st["launches"][name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms,
        }
        log(f"    {name}: {ms:.4g} ms (bound {bound_ms:.4g} ms, plain "
            f"{plain_ms:.4g} ms, library {lib_ms})")

    seg_sym = (torch.arange(n, device=dev) // seg) * 261 + (pull & 511)
    kernel_row(
        "occ_build",
        lambda: BO.occ_build(pull, n_seg=n_seg, seg=seg),
        lambda: BO.occ_build_plain(pull, n_seg=n_seg, seg=seg),
        bound_occ_build(n, n_seg, seg),
        library=lambda: torch.bincount(seg_sym, minlength=n_seg * 261))
    del seg_sym
    kw = dict(n_seg=n_seg, seg=seg, mark_period=mp, ndocs=ndocs)
    kernel_row(
        "marks_build",
        lambda: BO.marks_build(sa, a_row, **kw),
        lambda: BO.marks_build_plain(sa, a_row, **kw),
        bound_marks_build(n, n_seg, seg, index.meta.n_marks,
                          arrays.mark_vals.shape[0], ndocs))
    pt = torch.from_numpy(pack_patterns(
        [pattern_to_alpha(p) for p in patterns],
        pad_b=len(patterns))[0]).to(dev)
    kernel_row(
        "backward_search",
        lambda: S.backward_search(arrays, n, pt),
        lambda: S.backward_search_plain(arrays, n, pt),
        bound_backward_search(arrays, pt, n, 0))
    rt = torch.from_numpy(rows).to(dev)
    kernel_row(
        "lf_locate",
        lambda: [S.locate_rows(arrays, mp, rt)],
        lambda: [S.locate_rows_plain(arrays, mp, rt)],
        bound_locate(arrays, mp, rt))
    isa = torch.empty(n, dtype=torch.int64, device=dev)
    isa[index.sa_direct.long()] = torch.arange(n, device=dev)
    er = arrays.doc_seof_rows[d0: d0 + 1].contiguous()
    kernel_row(
        "lf_extract",
        lambda: S.extract_backward(arrays, er, DOC_SIZE - 1),
        lambda: S.extract_backward_plain(arrays, er, DOC_SIZE - 1),
        bound_extract(isa, int(prepared.doc_starts[d0 + 1]) - 1,
                      DOC_SIZE - 1, seg))
    record["kernels"] = list(kern.values())


def phase_profile(record, st):
    """Device time by kernel (torch.profiler, CUPTI) and the device's busy
    share over one call of each main-path step, for PERF.md's breakdown;
    "not measured" where the profiler reports no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import femto_tpu_torch as tt

    prepared, walk = st["prepared"], st["walk"]
    steps = {
        "build": lambda: tt.build_index(prepared, seg=256, mark_period=20,
                                        device="cuda"),
        "count": lambda: tt.count(walk, st["patterns"]),
        "locate_walk": lambda: tt.locate_rows_array(walk, st["loc_rows"]),
        "extract": lambda: tt.extract_document(walk, st["ext_docs"][0]),
    }
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only (kernels, copies): aten ops would count
        # their kernels a second time
        ops = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and e.self_device_time_total > 0),
                     key=lambda o: -o[1])
        dev_ms = sum(o[1] for o in ops)
        out[name] = {
            "wall_ms": wall_ms,
            "device_ms": dev_ms if ops else "not measured",
            "busy_share": dev_ms / wall_ms if ops else "not measured",
            "top": [{"op": k[:120], "ms": ms, "calls": c}
                    for k, ms, c in ops[:8]],
        }
        log(f"[6] {name}: wall {wall_ms:.3f} ms, device "
            f"{out[name]['device_ms']} ms, busy share "
            f"{out[name]['busy_share']}")
        for o in out[name]["top"][:4]:
            log(f"      {o['ms']:.3f} ms x{o['calls']} {o['op'][:90]}")
    record["profile"] = out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    record = {"seed": args.seed}
    rng = np.random.default_rng(args.seed)
    try:
        phase_toolchain(record)
        phase_build(record)
        phase_parity(record, rng)
        st = phase_main(record, rng)
        phase_numbers(record, st)
        phase_profile(record, st)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"total {record['seconds']:.1f}s")
    print(json.dumps({"kernels": record["kernels"]}))
    print(record["toolchain"]["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
