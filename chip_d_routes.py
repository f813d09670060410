"""Kernel D's routes timed against each other on the card.

Builds femto_tpu_torch's layouts on chip_smoke.py's corpora (its main
zipf corpus at seg 256: full, compact, packed; the zipf corpus and the
prose at seg 256, 1024 and 2048: vseg, vrle), builds csrc/lf_walk.cu
twice more (every call a thread a walk, every call a warp a walk:
chip_smoke.D_ALTERNATIVES) and times both routes at batch sizes around
and past the limits of csrc/lf_walk.cu's warp_route_max: extract on each
index at 32 steps and at one step, and on the row tiers locate
(mark_period 20) and the first step of a paged walk (lf_walk_step), each
call held bit for bit to the other route.  Those limits are set from its
readings.  Writes chiprun_out/d_routes.json and prints the card and the
readings, one JSON object, last.

    python3 chip_d_routes.py [--seed 5]
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs

FIXED_SIZES = (2048, 4096, 8192, 16384, 32768)
ROW_SIZES = (1024, 4096, 16384, 65536, 262144, 1 << 20)
# the row tiers' segment sizes: the thread route's step grows with seg
ROW_SEGS = (256, 1024, 2048)


def sizes(label, arrays):
    from femto_tpu_torch.ops import rank as R

    return ROW_SIZES if R.is_row_tier(arrays) else FIXED_SIZES


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_d_routes: no CUDA device", file=sys.stderr)
        return 1
    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels

    builds = cs.start_route_builds(["lf_walk"])
    kernels.build()
    libs = cs.route_libs(builds["lf_walk"], "lf_walk")
    rng = np.random.default_rng(args.seed)
    zipf = tt.prepare_documents(cs.zipf_docs(
        rng, (cs.MAIN_MIB << 20) // cs.DOC_SIZE))
    prose = tt.prepare_documents(cs.prose_docs())
    indexes = [(f"zipf {tier} seg 256", tt.build_index(
        zipf, seg=256, mark_period=20, tier=tier, device="cuda").arrays,
        zipf.n) for tier in cs.TIER_LAYOUTS]
    rows = []
    for name, corpus in (("zipf", zipf), ("prose", prose)):
        for seg in ROW_SEGS:
            for tier in cs.ROW_LAYOUTS:
                ix = tt.build_index(corpus, seg=seg, mark_period=20,
                                    tier=tier, device="cuda")
                rows.append((f"{name} {tier} seg {seg}", ix.arrays,
                             corpus.n))
    indexes += rows
    try:
        got = {"lf_extract": cs.d_route_probe(libs, indexes, rng, sizes,
                                              (32, 1)),
               "lf_locate": cs.d_route_probe(libs, rows, rng, sizes, (20,),
                                             entry="lf_locate"),
               "lf_walk_step": cs.d_route_probe(libs, rows, rng, sizes,
                                                (1,), entry="lf_walk_step")}
    except cs.SmokeError as e:
        print(f"chip_d_routes: FAILED: {e}", file=sys.stderr)
        return 1
    record = {"card": cs.card_line(),
              "n": {"zipf": zipf.n, "prose": prose.n},
              "routes": got}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "d_routes.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
