"""Kernel E's two routes timed against each other on the card.

Builds femto_tpu_torch's five layouts at seg 256, 1024 and 2048 on two
corpora (chip_smoke.py's 256 MiB zipf corpus and its English prose),
builds csrc/psi_walk.cu twice more (every call a warp a walk, every call
a thread a walk: chip_smoke.E_ALTERNATIVES) and times both routes of a
psi walk of 64 steps (the context batch's forward walk) from B rows drawn
from the text, at every power of two B from 256 to 2^18.  Each call is
held bit for bit to the other route, and each pair timed in turns (warp,
thread, thread, warp; 2 rounds, 8 for calls under 0.25 ms) with CUDA
events around each call.  csrc/psi_walk.cu's psi_warp_max is set from its
readings, and the record says how the routes it picks fare on them
(rule_check).  Writes chiprun_out/e_routes.json (every reading) and
prints the card and the worst readings, one JSON object, last.

    python3 chip_e_routes.py [--seed 5]
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs
from chip_c_routes import pair_ms, rule_check

SEGS = (256, 1024, 2048)
SIZES = tuple(1 << k for k in range(8, 19))
STEPS = cs.CTX[1] + cs.CTX[2]


def probe(ix, forced, rng):
    """Both routes at every B of SIZES on one index: {"psi_walk": {B:
    [as-built route, warp ms, thread ms]}}."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import search_ops as S

    A = ix.arrays
    n = int(A.C[-1])
    out = {}
    for B in SIZES:
        rows = torch.from_numpy(rng.integers(0, n, B).astype(np.int32)).to(
            A.C.device)

        def on(route, rows=rows):
            def call():
                with kernels.variant("psi_walk", forced[route]):
                    return S.psi_walk(A, rows, STEPS)
            return call

        warp, thread = on("warp"), on("thread")
        cs.max_abs_err(f"psi_walk B={B}: warp route against thread route",
                       [warp()], [thread()])
        w, t = pair_ms(warp, thread)
        out[B] = [cs.e_route(A, B), w, t]
        del rows
    return {"psi_walk": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_e_routes: no CUDA device", file=sys.stderr)
        return 1
    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import rank as R

    builds = cs.start_route_builds(["psi_walk"])
    kernels.build()
    forced = cs.e_forced(builds)
    rng = np.random.default_rng(args.seed)
    corpora = {
        "zipf": tt.prepare_documents(cs.zipf_docs(
            rng, (cs.MAIN_MIB << 20) // cs.DOC_SIZE)),
        "prose": tt.prepare_documents(cs.prose_docs()),
    }
    got, geometry = {}, {}
    try:
        for name, prep in corpora.items():
            for seg in SEGS:
                for tier in cs.LAYOUTS:
                    key = f"{name} {tier} seg {seg}"
                    ix = tt.build_index(prep, seg=seg, mark_period=20,
                                        tier=tier, device="cuda")
                    A = ix.arrays
                    row = tier in cs.ROW_LAYOUTS
                    geometry[key] = {
                        "n_seg": R.n_segments(A),
                        "side": int((A.seg_woff > 0).sum()) if row else 0,
                        "continued": (int((A.seg_woff < -1).sum()) if row
                                      else 0),
                        "K": R.alpha_count(A),
                        "block_bytes_at_1024": cs.e_block_bytes(A, 1024)}
                    got[key] = probe(ix, forced, rng)
                    cs.log(f"{key}: " + ", ".join(
                        f"{B}: {v[1]:.4g}/{v[2]:.4g}"
                        for B, v in got[key]["psi_walk"].items()))
                    del ix, A
                    torch.cuda.empty_cache()
    except cs.SmokeError as e:
        print(f"chip_e_routes: FAILED: {e}", file=sys.stderr)
        return 1
    record = {"card": cs.card_line(), "steps": STEPS,
              "n": {k: v.n for k, v in corpora.items()},
              "fields": ["route as built", "warp route ms",
                         "thread route ms"],
              "geometry": geometry, "routes": got,
              "rule_check": rule_check(got)}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "e_routes.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps({k: record[k] for k in ("card", "steps", "n",
                                             "geometry", "rule_check")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
