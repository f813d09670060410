"""Kernel C's two routes timed against each other on the card.

Builds femto_tpu_torch's five layouts at seg 256, 1024 and 2048 on three
corpora (chip_smoke.py's 256 MiB zipf corpus, its English prose and 32
MiB of random a/c/g/t), builds csrc/backward_search.cu twice more (every
call a warp a pattern or lane, every call a thread: chip_smoke.
C_ALTERNATIVES) and times both routes of each of C's four entries at
every power of two B from 1024 to 2^20: backward_search and
backward_search_steps on B patterns of 16 symbols drawn from the text,
backward_step (and on the row tiers backward_step_masked, with an eighth
of its lanes -1) at one step from the ranges of B drawn patterns of 1 to
8 symbols, by the symbol before each in the text.  Each call is held bit
for bit to the other route, and each pair timed in turns (warp, thread,
thread, warp; 2 rounds, 8 for calls under 0.25 ms) with CUDA events
around each call.  csrc/fm_common.cuh's c_warp_max is set from its
readings, and the record says how the routes it picks fare on them
(rule_check).  With --parent, the csrc/backward_search.cu of another
checkout (its root: for example the parent commit unpacked by `git
archive` into a git-ignored directory) is built beside this one and both
are timed in turns (5 rounds, each held to the other bit for bit) at
chip_smoke.py's count shapes: 32,768 patterns of 16 symbols on the zipf
corpus at seg 256 (every layout) and on the prose at seg 2048 (full,
vseg, vrle).  Writes chiprun_out/c_routes.json (every reading) and prints
the card and the corpora's sizes and segment kinds, one JSON object,
last.

    python3 chip_c_routes.py [--seed 5] [--parent DIR]
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np

import chip_smoke as cs
from chip_rank_routes import DNA_MIB, dna_docs

SEGS = (256, 1024, 2048)
SIZES = tuple(1 << k for k in range(10, 21))
PATLEN = 16
STEP_MAX = 8  # the longest pattern whose range a one-step call starts from


def event_ms(fn):
    """Device ms of one call of fn between two CUDA events."""
    import torch

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def pair_ms(warp, thread):
    """Both routes in turns (warp, thread, thread, warp) after a call of
    each, 2 rounds, or 8 where a call takes under 0.25 ms (launch-bound
    calls vary most): the median ms of each route's calls."""
    warp()
    thread()
    w, t = [], []
    rounds = 2
    r = 0
    while r < rounds:
        w.append(event_ms(warp))
        t += [event_ms(thread), event_ms(thread)]
        w.append(event_ms(warp))
        if r == 0 and max(w + t) < 0.25:
            rounds = 8
        r += 1
    return statistics.median(w), statistics.median(t)


def step_lanes(text, rng, B):
    """B patterns of 1 to STEP_MAX symbols drawn from the text's codes
    (int32[B, STEP_MAX], right-aligned, -1 on the left) and the symbol
    before each in the text (int32[B]): a one-step call's lanes step
    from each pattern's range by its symbol before."""
    import torch

    dev = text.device
    pos = torch.from_numpy(rng.integers(1, text.shape[0] - STEP_MAX,
                                        B)).to(dev)
    lens = torch.from_numpy(rng.integers(1, STEP_MAX + 1, B)).to(dev)
    cols = torch.arange(STEP_MAX, device=dev)
    pats = text[pos[:, None] + cols]
    pats = torch.where(cols[None, :] < (STEP_MAX - lens)[:, None], -1, pats)
    before = text[pos + STEP_MAX - lens - 1]
    return (pats.to(torch.int32).contiguous(),
            before.to(torch.int32).contiguous())


def probe(ix, text, forced, rng):
    """Both routes of each entry at every B of SIZES on one index:
    {entry: {B: [as-built route, warp ms, thread ms]}}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import search_ops as S

    A, meta = ix.arrays, ix.meta
    nr, r0 = meta.n_rows, meta.row0
    out = {}
    for B in SIZES:
        pats = cs.text_patterns(text, rng, B, PATLEN, PATLEN)
        short, c = step_lanes(text, rng, B)
        first, last = S.backward_search(A, nr, short, r0)
        masked = c.clone()
        masked[::8] = -1
        runs = {
            "backward_search": lambda: S.backward_search(A, nr, pats, r0),
            "backward_search_steps": lambda: S.backward_search_steps(
                A, nr, pats, r0),
            "backward_step": lambda: S.backward_step_pair(A, c, first,
                                                          last),
        }
        if R.is_row_tier(A):
            runs["backward_step_masked"] = lambda: S.backward_step_masked(
                A, masked, first, last)
        for entry, run in runs.items():
            def on(route, run=run):
                def call():
                    with kernels.variant("backward_search", forced[route]):
                        return run()
                return call

            warp, thread = on("warp"), on("thread")
            cs.max_abs_err(f"{entry} B={B}: warp route against thread "
                           f"route", cs._flat([warp()]), cs._flat([thread()]))
            w, t = pair_ms(warp, thread)
            out.setdefault(entry, {})[B] = [cs.c_route(A, B, entry), w, t]
        del pats, short, first, last, c, masked
    return out


def parent_lib(parent):
    """csrc/backward_search.cu of the checkout at `parent`, built with the
    port's flags and bound with its four entries' argument types."""
    from femto_tpu_torch import kernels

    so = os.path.join(kernels.BUILD_DIR, "libbackward_search.parent.so")
    out = subprocess.run(
        [kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", so,
         os.path.join(parent, "femto_tpu_torch", "csrc",
                      "backward_search.cu")],
        capture_output=True, text=True)
    cs.check(out.returncode == 0, f"nvcc failed for the parent's "
                                  f"backward_search.cu:\n{out.stdout}")
    lib = ctypes.CDLL(so)
    for entry in ("backward_search", "backward_search_steps",
                  "backward_step", "backward_step_masked"):
        fn = getattr(lib, "femto_" + entry)
        fn.argtypes = kernels.ENTRIES[entry][1] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def parent_rows(cases, lib):
    """backward_search as built against the parent's build (lib, through
    the same wrapper) on each case ({label: (index, patterns)}), held bit
    for bit, 5 rounds in turns: {label: {route, ms, parent_ms, turns_ms,
    ahead_rounds}}."""
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    out = {}
    for label, (ix, pats) in cases.items():
        A, nr = ix.arrays, ix.meta.n_rows

        def run(lib_=None, A=A, nr=nr, pats=pats):
            with kernels.variant("backward_search", lib_):
                return S.backward_search(A, nr, pats)

        cs.max_abs_err(f"{label}: against the parent's build",
                       list(run()), list(run(lib)))
        ms, p_ms, fours = cs.in_turns(run, lambda: run(lib), 5)
        out[label] = {"route": cs.c_route(A, pats.shape[0]), "ms": ms,
                      "parent_ms": p_ms, "turns_ms": fours,
                      "ahead_rounds": sum(k1 + k2 < l1 + l2
                                          for k1, l1, l2, k2 in fours)}
        cs.log(f"{label}: as built {ms:.4g} ms ({out[label]['route']}), "
               f"parent {p_ms:.4g}, first in {out[label]['ahead_rounds']} "
               f"of 5")
    return out


def rule_check(got):
    """How the routes the source picks fare on the sweep: for each (layout,
    seg) the largest ratio of the picked route's ms to the other's over
    the corpora, entries and B, and every reading where the picked route
    is more than 10% behind."""
    worst, behind = {}, []
    for key, entries in got.items():
        _, lay, _, seg = key.split()
        for entry, by_b in entries.items():
            for B, (route, w, t) in by_b.items():
                loss = w / t if route == "warp" else t / w
                cell = f"{lay} seg {seg}"
                worst[cell] = max(worst.get(cell, 1.0), loss)
                if loss > 1.1:
                    behind.append([key, entry, B, route, loss])
    return {"worst": worst,
            "behind": sorted(behind, key=lambda x: -x[4])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--parent", default=None,
                    help="root of another checkout whose count kernel is "
                         "timed against this one's")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_c_routes: no CUDA device", file=sys.stderr)
        return 1
    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import rank as R

    builds = cs.start_route_builds(["backward_search"])
    kernels.build()
    forced = cs.c_forced(builds)
    rng = np.random.default_rng(args.seed)
    corpora = {
        "zipf": tt.prepare_documents(cs.zipf_docs(
            rng, (cs.MAIN_MIB << 20) // cs.DOC_SIZE)),
        "prose": tt.prepare_documents(cs.prose_docs()),
        "dna": tt.prepare_documents(dna_docs(rng, DNA_MIB << 20)),
    }
    got, geometry, parent = {}, {}, None
    try:
        if args.parent is not None:
            lib = parent_lib(args.parent)
            cases = {}
            for name, seg, tiers in (("zipf", 256, cs.LAYOUTS),
                                     ("prose", cs.PROSE_SEG,
                                      ("full",) + cs.ROW_LAYOUTS)):
                text = cs.text_tensor(corpora[name], "cuda")
                pats = cs.text_patterns(text, rng, cs.N_PATTERNS, PATLEN,
                                        PATLEN)
                for tier in tiers:
                    cases[f"{name} {tier} seg {seg}"] = (tt.build_index(
                        corpora[name], seg=seg, mark_period=20, tier=tier,
                        device="cuda"), pats)
            parent = parent_rows(cases, lib)
            del cases, text, pats
            torch.cuda.empty_cache()
        for name, prep in corpora.items():
            text = cs.text_tensor(prep, "cuda")
            for seg in SEGS:
                for tier in cs.LAYOUTS:
                    key = f"{name} {tier} seg {seg}"
                    ix = tt.build_index(prep, seg=seg, mark_period=20,
                                        tier=tier, device="cuda")
                    A = ix.arrays
                    row = tier in cs.ROW_LAYOUTS
                    geometry[key] = {
                        "side": int((A.seg_woff > 0).sum()) if row else 0,
                        "continued": (int((A.seg_woff < -1).sum()) if row
                                      else 0),
                        "K": R.alpha_count(A),
                        "block_bytes_at_1024": cs.c_block_bytes(A, 1024)}
                    got[key] = probe(ix, text, forced, rng)
                    cs.log(f"{key}: " + "; ".join(
                        f"{e} " + ", ".join(f"{B}: {v[1]:.4g}/{v[2]:.4g}"
                                            for B, v in d.items())
                        for e, d in got[key].items()))
                    del ix, A
                    torch.cuda.empty_cache()
            del text
    except cs.SmokeError as e:
        print(f"chip_c_routes: FAILED: {e}", file=sys.stderr)
        return 1
    record = {"card": cs.card_line(),
              "n": {k: v.n for k, v in corpora.items()},
              "fields": ["route as built", "warp route ms",
                         "thread route ms"],
              "geometry": geometry, "routes": got, "parent": parent,
              "rule_check": rule_check(got)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "c_routes.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps({k: record[k] for k in ("card", "n", "fields",
                                             "geometry", "parent",
                                             "rule_check")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
