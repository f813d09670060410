"""Two gloo processes on localhost running the port's DistMesh (one shard
each), the counterpart of tests/test_multiprocess.py: their sharded SA,
counts and locate equal the port's LocalMesh(2) in this process."""

import json
import os
import socket
import subprocess
import sys

import numpy as np

import femto_tpu_torch as tt
from femto_tpu_torch.alphabet import pattern_to_alpha
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel.dist_build import (
    build_index_sharded, dist_suffix_array, pad_text_for_mesh)
from femto_tpu_torch.parallel.dist_query import (
    sharded_backward_search, sharded_locate)
from femto_tpu_torch.parallel.distributed import put_global
from femto_tpu_torch.search import pack_patterns


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _local_answers():
    mesh = LocalMesh(2, device="cpu")
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
    text_pad, _ = pad_text_for_mesh(prepared.text, 2, 32)
    sa, _, _, of = dist_suffix_array(put_global(text_pad, mesh), mesh,
                                     n=prepared.n)
    out["sa"] = sa.reshape(-1).tolist()
    out["overflow"] = int(of)
    return out


def test_two_process_dist_mesh():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo
    worker = os.path.join(repo, "tests", "torch_mp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, err[-2000:]
    line = [ln for ln in outs[0][1].splitlines()
            if ln.startswith("MP_RESULT:")]
    assert line, outs[0][1]
    got = json.loads(line[0][len("MP_RESULT:"):])
    want = _local_answers()
    assert got == want
    assert got["overflow"] <= 0
    assert got["full"]["routed=True"] == got["full"]["routed=False"]
