"""Worker of the two-process DistMesh test (test_torch_multiprocess.py).

Run as: python tests/torch_mp_worker.py PROCESS_ID NUM_PROCESSES PORT [MODE]
Each process holds one shard of a gloo DistMesh on the CPU.  MODE "full"
(the default): build the sharded index of three documents in the full,
packed and vrle tiers, answer sharded counts (routed and psum), locate
and a regex and a Boolean query, refuse doc_chunks, and sort the padded
text with dist_suffix_array; process 0 prints one JSON line.  MODE
"kill1": a checkpointed build in which process 1 SIGKILLs itself right
after it saves its seed checkpoint (the survivor keeps its own file);
"kill2": fresh processes resume that build from the files and print
whether it resumed and counted right.  The checkpoint directory is
$FTPU_KR_CKDIR.  It imports no JAX.
"""

import json
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    mode = sys.argv[4] if len(sys.argv) > 4 else "full"
    import numpy as np
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.parallel import distributed as ftd
    from femto_tpu_torch.parallel.dist_build import (
        build_index_sharded, dist_suffix_array, pad_text_for_mesh)
    from femto_tpu_torch.parallel.dist_query import (
        sharded_backward_search, sharded_count_query, sharded_docs_query,
        sharded_locate)
    from femto_tpu_torch.search import pack_patterns

    assert "jax" not in sys.modules
    ftd.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid,
                   cpu_collectives="gloo")
    mesh = ftd.global_mesh(device="cpu")
    if mode.startswith("kill"):
        killresume(pid, mesh, mode)
        torch.distributed.destroy_process_group()
        return
    docs = [b"the quick brown fox jumps over the lazy dog",
            b"banana banana banana", b"abracadabra" * 5]
    prepared = tt.prepare_documents(docs)
    out = {}
    for tier in ("full", "packed", "vrle"):
        index = build_index_sharded(prepared, mesh, seg=32, mark_period=8,
                                    tier=tier)
        pats = [b"banana", b"abra", b"the", b"zz", b"a"]
        packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
        res = {}
        for routed in (True, False):
            f, l = sharded_backward_search(index, mesh, packed,
                                           routed=routed)
            res[f"routed={routed}"] = [f.tolist(), l.tolist()]
        f, l = res["routed=True"][0][0], res["routed=True"][1][0]
        rows = np.arange(f, l, dtype=np.int32)
        rows = np.concatenate([rows, np.full(len(rows) % 2, f, np.int32)])
        res["locate"] = sharded_locate(index, mesh, rows).tolist()
        res["regex"] = sharded_count_query(index, mesh, "ba(na)+")
        res["boolean"] = [[d, i.decode(), o] for d, i, o in
                          sharded_docs_query(index, mesh,
                                             "'the' AND 'fox'")]
        out[tier] = res
    try:
        build_index_sharded(prepared, mesh, seg=32, doc_chunks=True)
        out["doc_chunks"] = "built"
    except ValueError:
        out["doc_chunks"] = "refused"
    text_pad, _ = pad_text_for_mesh(prepared.text, nproc, 32)
    sa, bwt, _, of = dist_suffix_array(ftd.put_global(text_pad, mesh), mesh,
                                       n=prepared.n)
    out["sa"] = mesh.all_gather(sa).reshape(-1).tolist()
    out["overflow"] = int(of)
    if pid == 0:
        print("MP_RESULT:" + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


def killresume(pid, mesh, mode):
    """Kill-and-resume of a two-process checkpointed build (femto_tpu's
    tests/mp_worker.py killresume)."""
    import os
    import signal

    import numpy as np

    import femto_tpu_torch as tt
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.parallel import dist_build as db
    from femto_tpu_torch.parallel.dist_query import sharded_backward_search
    from femto_tpu_torch.search import pack_patterns

    ck = os.environ["FTPU_KR_CKDIR"]
    rng = np.random.default_rng(42)
    docs = [bytes(rng.integers(97, 123, size=1500).astype(np.uint8))
            for _ in range(3)] + [b"needle-banana-needle"]
    prepared = tt.prepare_documents(docs)
    if mode == "kill1":
        orig = db._ckpt_save

        def save_then_die(*a, **kw):
            orig(*a, **kw)
            if pid == 1 and a[2] == "seed":
                os.kill(os.getpid(), signal.SIGKILL)

        db._ckpt_save = save_then_die
        # the survivor may run on past its peer's death: it keeps its file
        db._ckpt_clear = lambda *a, **k: None
        db.build_index_sharded(prepared, mesh, seg=32, mark_period=8,
                               checkpoint_dir=ck)
        print("KR_PHASE1_SURVIVED", flush=True)
        return
    index = db.build_index_sharded(prepared, mesh, seg=32, mark_period=8,
                                   checkpoint_dir=ck)
    resumed = bool(db.LAST_BUILD_STATS.get("resumed"))
    pats = [b"banana", b"needle", b"zz"]
    packed, B = pack_patterns([pattern_to_alpha(p) for p in pats])
    first, last = sharded_backward_search(index, mesh, packed, routed=False)
    counts = (last - first)[:B].tolist()

    def cnt(d, p):  # overlapping occurrences (index semantics)
        return sum(d.startswith(p, i) for i in range(len(d)))

    want = [sum(cnt(d, p) for d in docs) for p in pats]
    mine = f".p{pid}of"
    if pid == 0:
        ok = (resumed and counts == want
              and not any(mine in f for f in os.listdir(ck)))
        print("MP_KILLRESUME:" + ("ok" if ok else
                                  f"bad resumed={resumed} {counts}!={want}"
                                  f" {os.listdir(ck)}"), flush=True)


if __name__ == "__main__":
    main()
