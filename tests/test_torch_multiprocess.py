"""Two gloo processes on localhost running the port's DistMesh (one shard
each), the counterpart of tests/test_multiprocess.py: their sharded SA,
counts, locate and queries equal the port's LocalMesh(2) in this process,
and a checkpointed build whose second process is killed resumes in two
fresh processes."""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

import femto_tpu_torch as tt
from femto_tpu_torch.alphabet import pattern_to_alpha
from femto_tpu_torch.parallel import LocalMesh
from femto_tpu_torch.parallel.dist_build import (
    build_index_sharded, dist_suffix_array, pad_text_for_mesh)
from femto_tpu_torch.parallel.dist_query import (
    sharded_backward_search, sharded_count_query, sharded_docs_query,
    sharded_locate)
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
    out["doc_chunks"] = "refused"
    text_pad, _ = pad_text_for_mesh(prepared.text, 2, 32)
    sa, _, _, of = dist_suffix_array(put_global(text_pad, mesh), mesh,
                                     n=prepared.n)
    out["sa"] = sa.reshape(-1).tolist()
    out["overflow"] = int(of)
    return out


def test_two_process_dist_mesh():
    port = _free_port()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
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


def _launch(worker, mode, port, env):
    return [subprocess.Popen(
        [sys.executable, worker, str(pid), "2", str(port), mode], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]


def test_kill_and_resume_two_process_build(tmp_path):
    """One of two processes SIGKILLs itself right after it saves its
    seed-sort checkpoint; the stranded peer is reaped once its own file
    is there; two fresh processes on the same directory resume from the
    files and count right (femto_tpu's tests/test_multiprocess.py:55)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "torch_mp_worker.py")
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1",
               FTPU_KR_CKDIR=str(tmp_path))
    procs = _launch(worker, "kill1", _free_port(), env)
    try:
        assert procs[1].wait(timeout=60) == -9, procs[1].communicate()[1]
        deadline = time.monotonic() + 30
        while (len(os.listdir(tmp_path)) < 2 and procs[0].poll() is None
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            p.kill()
            p.communicate()
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and all(f.startswith("dist_rank_")
                                   for f in files), files
    procs = _launch(worker, "kill2", _free_port(), env)
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=60))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            raise
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert "MP_KILLRESUME:ok" in outs[0][0], outs[0]
