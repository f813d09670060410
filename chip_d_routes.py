"""Kernel D's extract routes timed against each other on the card.

Builds femto_tpu_torch's five layouts as chip_smoke.py does (its main
zipf corpus at seg 256: full, compact, packed; its prose corpus at seg
2048: vseg, vrle), builds csrc/lf_walk.cu twice more (every extract call
a thread a walk, every call a warp a walk: chip_smoke.D_ALTERNATIVES) and
times both routes on each layout at batch sizes around and past the
limits of csrc/lf_walk.cu's warp_route_max, at 32 steps and at one step,
each call held bit for bit to the other route.  Those limits are set
from its readings.  Writes chiprun_out/d_routes.json and prints the card
and the readings, one JSON object, last.

    python3 chip_d_routes.py [--seed 5]
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs

FIXED_SIZES = (2048, 4096, 8192, 16384, 32768)
ROW_SIZES = (16384, 65536, 131072, 262144, 524288, 1 << 20)


def sizes(lay):
    return ROW_SIZES if lay in cs.ROW_LAYOUTS else FIXED_SIZES


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
    indexes = []
    for corpus, seg, tiers in ((zipf, 256, cs.TIER_LAYOUTS),
                               (prose, cs.PROSE_SEG, cs.ROW_LAYOUTS)):
        for tier in tiers:
            ix = tt.build_index(corpus, seg=seg, mark_period=20, tier=tier,
                                device="cuda")
            indexes.append((tier, ix.arrays, corpus.n))
    try:
        got = cs.d_route_probe(libs, indexes, rng, sizes, (32, 1))
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
