"""Worker of the two-process DistMesh test (test_torch_multiprocess.py).

Run as: python tests/torch_mp_worker.py PROCESS_ID NUM_PROCESSES PORT
Each process holds one shard of a gloo DistMesh on the CPU, builds the
sharded index of three documents, answers sharded counts (routed and
psum) and locate, and sorts the padded text with dist_suffix_array;
process 0 prints one JSON line.  It imports no JAX.
"""

import json
import sys


def main():
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    import numpy as np
    import torch

    import femto_tpu_torch as tt
    from femto_tpu_torch.alphabet import pattern_to_alpha
    from femto_tpu_torch.parallel import distributed as ftd
    from femto_tpu_torch.parallel.dist_build import (
        build_index_sharded, dist_suffix_array, pad_text_for_mesh)
    from femto_tpu_torch.parallel.dist_query import (
        sharded_backward_search, sharded_locate)
    from femto_tpu_torch.search import pack_patterns

    assert "jax" not in sys.modules
    ftd.initialize(f"localhost:{port}", num_processes=nproc, process_id=pid,
                   cpu_collectives="gloo")
    mesh = ftd.global_mesh(device="cpu")
    docs = [b"the quick brown fox jumps over the lazy dog",
            b"banana banana banana", b"abracadabra" * 5]
    prepared = tt.prepare_documents(docs)
    out = {}
    for tier in ("full", "packed"):
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
        out[tier] = res
    text_pad, _ = pad_text_for_mesh(prepared.text, nproc, 32)
    sa, bwt, _, of = dist_suffix_array(ftd.put_global(text_pad, mesh), mesh,
                                       n=prepared.n)
    out["sa"] = mesh.all_gather(sa).reshape(-1).tolist()
    out["overflow"] = int(of)
    if pid == 0:
        print("MP_RESULT:" + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
