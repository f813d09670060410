"""The sharded full-tier build of two source trees, in turns on one card.

Profiles femto_tpu_torch's build_index_sharded of the 256 MiB zipf corpus
that phase 4h of chip_smoke.py builds (a LocalMesh of 4 shards, tier
"full", seg 256, mark_period 20) from two checkouts, in four processes:
tree A, B, B, A, each importing femto_tpu_torch from its own tree and
building its kernels there.  Each process builds the index once to warm
up, then profiles one build with torch.profiler: wall ms, device ms (every
device item: kernels, copies, fills, memsets), the busy share, the device
ms and calls of the rebalance's kernels, of mesh_flags', of mesh_scan's
and compact_rows' kernels (either design's: the earlier three-kernel scan
or the tile kernels), of memsets and of PyTorch's fills, rolls, wheres
and copies (memcpy: the uploads among them), and the launches of every
entry named in LAUNCHES.  Each
process also hashes the built index's FMArrays and meta and the suffix
array of the same text (dist_suffix_array), and the two trees' hashes
must agree.  The measuring code is this file's, the same for both trees.

    python3 chip_sharded_build_ab.py TREE_A TREE_B

TREE_A and TREE_B are the roots of two checkouts (for example the parent
commit unpacked by git archive into a git-ignored directory, and ".").
The record goes to chiprun_out/sharded_build_ab.json; the card's name and
power limit and a JSON summary are the last two lines of output.  It needs
one card and exits non-zero without one.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 7
MIB = 256
D = 4
# device items by kind: substrings of the kernels' names (either tree's)
KINDS = {"rebalance": ("rebalance",), "mesh_flags": ("mesh_flags_kernel",),
         "mesh_scan": ("scan_tiles_kernel", "scan_carry_kernel",
                       "scan_apply_kernel", "mesh_scan_tile"),
         "compact_rows": ("compact_rows",),
         "fill": ("FillFunctor",), "memset": ("Memset",),
         "roll": ("roll_cuda_kernel",), "where": ("where_kernel_impl",),
         "copy": ("direct_copy_kernel",), "memcpy": ("Memcpy",)}
# entries whose launches the record keeps
LAUNCHES = ("rebalance", "mesh_flags", "mesh_scan", "compact_rows")


def _smoke():
    """chip_smoke.py of this checkout, for its corpus (zipf_docs)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def one(tree):
    """The profile of one build from `tree`: a dict."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import torch
    from torch.profiler import ProfilerActivity, profile

    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.parallel import LocalMesh, build_index_sharded

    if not os.path.abspath(tt.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"femto_tpu_torch came from {tt.__file__}, "
                           f"not {tree}")
    smoke = _smoke()
    rng = np.random.default_rng(SEED)
    prepared = tt.prepare_documents(
        smoke.zipf_docs(rng, (MIB << 20) // smoke.DOC_SIZE))
    mesh = LocalMesh(D, "cuda")

    def build():
        return build_index_sharded(prepared, mesh, seg=256, mark_period=20)

    digest = index_digest(build(), prepared, mesh)
    torch.cuda.synchronize()
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        build()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    items = [(e.key, e.self_device_time_total / 1e3, e.count)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in items)
    return {
        "tree": tree, "n": prepared.n, "wall_ms": wall_ms,
        "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        "by_kind": {k: {"ms": sum(ms for n, ms, _ in items
                                  if any(t in n for t in tags)),
                        "calls": sum(c for n, _, c in items
                                     if any(t in n for t in tags))}
                    for k, tags in KINDS.items()},
        "launches": {k: v for k, v in kernels.launches.items()
                     if v and any(e in k for e in LAUNCHES)},
        "digest": digest,
        "top": [{"op": n[:120], "ms": ms, "calls": c}
                for n, ms, c in sorted(items, key=lambda x: -x[1])[:12]]}


def index_digest(ix, prepared, mesh):
    """blake2b of every FMArrays field and the meta of a sharded index,
    and of the suffix array of the same padded text (dist_suffix_array)."""
    import dataclasses
    import hashlib

    from femto_tpu_torch.parallel import dist_suffix_array, pad_text_for_mesh
    from femto_tpu_torch.parallel.distributed import put_global

    h = hashlib.blake2b(digest_size=16)
    for k, v in ix.arrays._asdict().items():
        h.update(k.encode())
        if v is not None:
            h.update(v.cpu().numpy().tobytes())
    h.update(json.dumps(dataclasses.asdict(ix.meta), sort_keys=True,
                        default=str).encode())
    tp, _ = pad_text_for_mesh(prepared.text, D, 256)
    sa = dist_suffix_array(put_global(tp, mesh), mesh, n=prepared.n)[0]
    return {"index": h.hexdigest(),
            "sa": hashlib.blake2b(sa.cpu().numpy().tobytes(),
                                  digest_size=16).hexdigest()}


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2])))
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_sharded_build_ab.py needs a card")
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    a, b = sys.argv[1:3]
    runs = []
    for tree in (a, b, b, a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True, timeout=900)
        if proc.returncode != 0:
            sys.exit(f"the build from {tree} failed:\n{proc.stdout[-4000:]}"
                     f"\n{proc.stderr[-4000:]}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        print(f"{tree}: wall {r['wall_ms']:.3f} ms, device "
              f"{r['device_ms']:.3f} ms, busy {r['busy_share']:.4f}, "
              f"launches {r['launches']}, by kind {r['by_kind']}",
              flush=True)
    digests = {r["tree"]: r["digest"] for r in runs}
    if len({json.dumps(d, sort_keys=True) for d in digests.values()}) != 1:
        sys.exit(f"the trees built different indexes: {digests}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    summary = {
        "card": card, "order": [a, b, b, a],
        "device_ms": {t: [r["device_ms"] for r in runs if r["tree"] ==
                          os.path.abspath(t)] for t in (a, b)},
        "by_kind_ms": {k: {t: [r["by_kind"][k]["ms"] for r in runs
                               if r["tree"] == os.path.abspath(t)]
                           for t in (a, b)}
                       for k in ("rebalance", "mesh_flags", "mesh_scan",
                                 "compact_rows", "fill", "memset",
                                 "memcpy")},
        "same_sa_and_index": True}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "sharded_build_ab.json"),
              "w") as f:
        json.dump({"summary": summary, "runs": runs}, f, indent=1)
    print(card)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
