"""The all-symbol rank's two routes timed against each other on the card.

Builds femto_tpu_torch's five layouts at seg 256 and 2048 on three
corpora (chip_smoke.py's 256 MiB zipf corpus, its prose and a corpus of
random a/c/g/t, a small alphabet) and builds csrc/regex_frontier.cu and
csrc/dist_query.cu twice more (every rank by rows, every rank by codes:
chip_smoke.R_ALTERNATIVES).  On each index it times both routes of
kernel R's regex_fork at the layers of queries whose entries rank 1, 2,
4, 8, 16 and 26 codes (a class before two letters of a-t) and at the
widest layer of an approximate query (chip_smoke.fork_route_probe), and both routes of
K18f's masked_occ_rows on the index as one shard at 350 and 14,412 drawn
rows (the two query layers chip_smoke.py times); each call held bit for
bit to the other route, in turns over 5 rounds and queued behind a spin
kernel.  csrc/fm_common.cuh's row_rank_min is set from its readings.
Writes chiprun_out/rank_routes.json and prints the card and a summary,
one JSON object, last.

    python3 chip_rank_routes.py [--seed 5]
"""

import argparse
import json
import os
import sys

import numpy as np

import chip_smoke as cs

SEGS = (256, 2048)
DNA_MIB = 32
# the queries of the regex_fork probes: name -> (query, frontier cap, the
# layer's depth or None for the widest); the layer of "<class>[a-t]{2}"
# at depth 2 ranks the class's codes an entry (up to 400 entries; the
# frontier after it, up to 26 x 400, stays within the device search's
# largest capacity)
LETTER_QUERIES = {
    "k1": ("e[a-t]{2}", 1024, 2), "k2": ("[ae][a-t]{2}", 1024, 2),
    "k4": ("[aeio][a-t]{2}", 1024, 2), "k8": ("[a-h][a-t]{2}", 1024, 2),
    "k16": ("[a-p][a-t]{2}", 1024, 2), "k26": ("[a-z][a-t]{2}", 1024, 2),
    "approx1": ("APPROX 1 ther", 1024, None),
}
DNA_QUERIES = {
    "k1": ("a[acgt]{4}", 1024, 4), "k2": ("[ac][acgt]{4}", 1024, 4),
    "k4": ("[acgt]{5}", 1024, 4), "approx1": ("APPROX 1 acgtac", 1024, None),
}
# rows of the masked_occ_rows probes: zipf APPROX 1 ther's and prose
# APPROX 2 parameter's widest layers (two rows a live entry)
OCC_ROWS = (350, 14412)


def dna_docs(rng, nbytes):
    """Documents of DOC_SIZE - 1 random bytes of a, c, g and t."""
    step = cs.DOC_SIZE - 1
    body = np.frombuffer(b"acgt", np.uint8)[
        rng.integers(0, 4, size=nbytes)].tobytes()
    return [body[i: i + step] for i in range(0, nbytes, step)]


def occ_probe(ix, forced, rng, M):
    """masked_occ_rows on ix as one shard at M drawn rows on both routes
    (chip_smoke.rank_route_fields), with the route as built."""
    import torch

    from femto_tpu_torch import kernels
    from femto_tpu_torch.ops import dist_ops as DO
    from femto_tpu_torch.ops import rank as R
    from femto_tpu_torch.ops import search_ops as S

    A = ix.arrays
    n_seg, seg = ix.meta.n_seg, R.seg_size(A)
    rows = torch.from_numpy(rng.integers(
        0, ix.meta.n_rows, size=M).astype(np.int32)).to(A.C.device)
    kw = dict(Dl=1, nseg_local=n_seg, shard0=0, n_rows_total=n_seg * seg)

    def run():
        return DO.masked_occ_rows(A, rows, **kw)

    out = {"M": M, "K": R.alpha_count(A),
           "as_built": "rows" if kernels.size(
               "masked_occ_rows_route", S.fm_view(A)[0], M, 1) else "codes",
           "as_built_ms": cs.cuda_ms(run)}
    out.update(cs.rank_route_fields("dist_query", forced, run,
                                    f"masked_occ_rows M={M}")["rank_routes"])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_rank_routes: no CUDA device", file=sys.stderr)
        return 1
    import femto_tpu_torch as tt
    from femto_tpu_torch import kernels

    builds = cs.start_route_builds(["regex_frontier", "dist_query:rank"])
    kernels.build()
    fork_libs = cs.rank_forced(builds, "regex_frontier")
    occ_libs = cs.rank_forced(builds, "dist_query:rank")
    rng = np.random.default_rng(args.seed)
    corpora = {
        "zipf": (tt.prepare_documents(cs.zipf_docs(
            rng, (cs.MAIN_MIB << 20) // cs.DOC_SIZE)), LETTER_QUERIES),
        "prose": (tt.prepare_documents(cs.prose_docs()), LETTER_QUERIES),
        "dna": (tt.prepare_documents(dna_docs(rng, DNA_MIB << 20)),
                DNA_QUERIES),
    }
    got, summary = {}, {}
    try:
        for name, (prep, queries) in corpora.items():
            for seg in SEGS:
                for tier in cs.LAYOUTS:
                    key = f"{name} {tier} seg {seg}"
                    ix = tt.build_index(prep, seg=seg, mark_period=20,
                                        tier=tier, device="cuda")
                    rec = got[key] = {"fork": {}, "occ": {}}
                    for qn, (q, fcap, depth) in queries.items():
                        p = rec["fork"][qn] = cs.fork_route_probe(
                            ix, q, fcap, fork_libs, at_depth=depth)
                        summary[f"{key} fork {qn}"] = [
                            p["n_live"], p["reached"]["mean"],
                            p["row_min"], p["rows_queued_ms"],
                            p["codes_queued_ms"], p["rows_ms"],
                            p["codes_ms"], p["rows_ahead_rounds"]]
                    for M in OCC_ROWS:
                        p = rec["occ"][M] = occ_probe(ix, occ_libs, rng, M)
                        summary[f"{key} occ {M}"] = [
                            M, p["K"], p["as_built"], p["rows_queued_ms"],
                            p["codes_queued_ms"], p["rows_ms"],
                            p["codes_ms"], p["rows_ahead_rounds"]]
                    del ix
                    torch.cuda.empty_cache()
    except cs.SmokeError as e:
        print(f"chip_rank_routes: FAILED: {e}", file=sys.stderr)
        return 1
    record = {"card": cs.card_line(),
              "n": {k: v[0].n for k, v in corpora.items()},
              "fields": ["n_live or M", "codes an entry or K",
                         "rule's least count or route as built",
                         "rows queued ms", "codes queued ms",
                         "rows ms in turns", "codes ms in turns",
                         "rounds rows first of 5"],
              "summary": summary, "probes": got}
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "rank_routes.json"), "w") as f:
        json.dump(record, f, indent=1)
    print(record["card"])
    print(json.dumps({k: record[k] for k in ("card", "n", "fields",
                                             "summary")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
