"""femto_tpu_torch stands alone: no JAX, no femto_tpu, no silent CPU path.

The port's package and chip_smoke.py must import neither jax nor anything
of femto_tpu, and its entry points must raise rather than fall back to the
CPU when the card is asked for and absent (this host has no card).
"""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import femto_tpu_torch as tt
from femto_tpu_torch import kernels
from femto_tpu_torch import lcp as TL
from femto_tpu_torch import paged as TP
from femto_tpu_torch import query as TQ
from femto_tpu_torch import parallel as TPAR
from femto_tpu_torch.ops import build_ops as TB
from femto_tpu_torch.ops import dist_ops as DO
from femto_tpu_torch.ops import lcp_ops as LO
from femto_tpu_torch.ops import paged_ops as PO
from femto_tpu_torch.ops import regex_ops as RO
from femto_tpu_torch.ops import search_ops as TS
from femto_tpu_torch.ops import sort_ops as SO

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "femto_tpu_torch")
FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|femto_tpu)\b(?!_torch)"
    r"|from\s+(jax|femto_tpu)\b(?!_torch))", re.M)


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_import_pulls_in_neither_jax_nor_femto_tpu():
    code = ("import sys, femto_tpu_torch, femto_tpu_torch.ops.build_ops, "
            "femto_tpu_torch.ops.sort_ops, femto_tpu_torch.ops.regex_ops, "
            "femto_tpu_torch.kernels, femto_tpu_torch.query, "
            "femto_tpu_torch.query.ast, femto_tpu_torch.query.parser, "
            "femto_tpu_torch.query.planning, femto_tpu_torch.query.nfa, "
            "femto_tpu_torch.query.results, femto_tpu_torch.query.regexp, "
            "femto_tpu_torch.query.regexp_device, "
            "femto_tpu_torch.query.engine, femto_tpu_torch.multi, "
            "femto_tpu_torch.paged, femto_tpu_torch.lcp, "
            "femto_tpu_torch.io.native, femto_tpu_torch.ops.paged_ops, "
            "femto_tpu_torch.ops.lcp_ops, femto_tpu_torch.ops.dist_ops, "
            "femto_tpu_torch.parallel, femto_tpu_torch.parallel.mesh, "
            "femto_tpu_torch.parallel.distributed, "
            "femto_tpu_torch.parallel.bins, "
            "femto_tpu_torch.parallel.dist_sort, "
            "femto_tpu_torch.parallel.dist_build, "
            "femto_tpu_torch.parallel.dist_query; "
            "print('jax' in sys.modules, 'femto_tpu' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_femto_tpu_import_in_source(path):
    with open(path) as f:
        hits = FORBIDDEN.findall(f.read())
    assert not hits, f"{path} imports {hits}"


def _cuda_sources():
    csrc = os.path.join(PKG, "csrc")
    return sorted(os.path.join(csrc, f) for f in os.listdir(csrc))


@pytest.mark.parametrize("path", _cuda_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_cuda_sources_include_only_the_runtime_and_fm_common(path):
    """No CUB, Thrust, CUTLASS or PyTorch header: a source builds in
    seconds with nvcc alone and every kernel in it is the port's own."""
    with open(path) as f:
        text = f.read()
    includes = re.findall(r'^\s*#\s*include\s*[<"]([^>"]+)[>"]', text, re.M)
    assert includes, path
    allowed = {"fm_common.cuh", "cstdint", "type_traits", "cuda_runtime.h"}
    assert set(includes) <= allowed, (path, includes)
    assert not re.search(r"\b(cub|thrust|cutlass|cute)::", text), path


def test_every_kernel_source_is_an_entry_and_is_built():
    stems = {os.path.basename(p)[:-3] for p in _cuda_sources()
             if p.endswith(".cu")}
    assert stems == set(kernels.SOURCES)
    assert {"sa_keys", "radix_sort", "sa_groups", "sa_rounds",
            "sa_payload", "regex_frontier", "doc_lists",
            "text_expand", "paged", "lcp"} <= stems


# entries whose plain version is not named <entry>_plain
PLAIN_NAMES = {"lf_locate": "locate_rows_plain",
               "lf_extract": "extract_backward_plain"}


@pytest.mark.parametrize("entry", sorted(kernels.ENTRIES))
def test_every_entry_has_a_plain_version_and_a_smoke_row(entry):
    """kernels.ENTRIES against the ops modules and chip_smoke.KERNELS."""
    import chip_smoke

    name = PLAIN_NAMES.get(entry, entry + "_plain")
    homes = [m for m in (TB, TS, SO, RO, PO, LO, DO) if hasattr(m, name)]
    assert len(homes) == 1, (entry, name)
    assert callable(getattr(homes[0], name))
    src, argtypes = kernels.ENTRIES[entry]
    rows = [k for k in chip_smoke.KERNELS
            if k == entry or k.startswith(entry + "[")]
    # one row per launch count: per layout, per mode, else one
    assert sorted(rows) == sorted(kernels.counters(entry)), (entry, rows)
    for k in rows:
        source, replaces = chip_smoke.KERNELS[k]
        assert source == f"femto_tpu_torch/csrc/{src}.cu"
        assert os.path.exists(os.path.join(ROOT, source))
        ref, line = replaces.split(":")
        assert ref.startswith("femto_tpu/") and int(line) > 0
        assert os.path.exists(os.path.join(ROOT, ref))
        on_a_path = any(k in path for path in chip_smoke.PATH_KERNELS.values())
        # an entry that no path calls is on none of them; every other is on
        # one
        assert on_a_path == (entry not in chip_smoke.NO_CALLER)
    with open(os.path.join(ROOT, f"femto_tpu_torch/csrc/{src}.cu")) as f:
        assert f'extern "C" int femto_{entry}(' in f.read()


def test_forbidden_pattern_catches_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "import femto_tpu", "from femto_tpu.ops import rank",
                 "    from femto_tpu import search"):
        assert FORBIDDEN.search(line), line
    for line in ("import femto_tpu_torch", "from femto_tpu_torch import x",
                 "from .ops import rank"):
        assert not FORBIDDEN.search(line), line


def test_entry_points_raise_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    prepared = tt.prepare_documents([b"abc", b"abd"])
    with pytest.raises(RuntimeError, match="cuda"):
        tt.build_index(prepared)
    ix = tt.build_index(prepared, seg=64, mark_period=4, device="cpu")
    ix.save(str(tmp_path / "ix"))
    with pytest.raises(RuntimeError, match="cuda"):
        tt.FMIndex.load(str(tmp_path / "ix"))
    arrays = {k: v.numpy() for k, v in ix.arrays._asdict().items()
              if v is not None}
    with pytest.raises(RuntimeError, match="cuda"):
        tt.arrays_from_numpy(arrays, ix.meta)
    with pytest.raises(ValueError, match="device"):
        tt.build_index(prepared, device="mps")
    # paged serving and the LCP device path default to the card too
    rows = tt.build_index(prepared, seg=64, mark_period=4, tier="vrle",
                          device="cpu")
    flat = str(tmp_path / "rows.ftpu")
    rows.save_flat(flat)
    with pytest.raises(RuntimeError, match="cuda"):
        TP.load_paged(flat, budget_bytes=1)
    with pytest.raises(RuntimeError, match="cuda"):
        TP.load_auto(flat, budget_bytes=1)
    assert isinstance(TP.load_auto(flat, budget_bytes=1, device="cpu"),
                      TP.PagedIndex)
    sa = np.arange(prepared.n, dtype=np.int32)
    with pytest.raises(RuntimeError, match="cuda"):
        TL.lcp_array(prepared.text, sa, device=True)
    with pytest.raises(RuntimeError, match="cuda"):
        TL.sparse_plcp(prepared.text, sa)
    # the sharded index: a mesh defaults to the card; on a CPU mesh the
    # build and the queries answer
    with pytest.raises(RuntimeError, match="cuda"):
        TPAR.LocalMesh(2)
    mesh = TPAR.LocalMesh(2, device="cpu")
    six = TPAR.build_index_sharded(prepared, mesh, seg=64, mark_period=4)
    assert six.device.type == "cpu"
    pats = np.array([[-1, 102, 103]], np.int32)
    first, last = TPAR.sharded_backward_search(six, mesh, pats)
    assert int(last[0] - first[0]) == 2
    offs = TPAR.sharded_locate(six, mesh, np.arange(six.meta.row0,
                                                    six.meta.row0 + 2,
                                                    dtype=np.int32))
    assert offs.device.type == "cpu" and (offs >= 0).all()
    rix = TPAR.build_index_sharded(prepared, mesh, seg=64, mark_period=4,
                                   tier="vrle")
    assert TPAR.sharded_count_query(rix, mesh, "ab[cd]") == 2


def test_query_engine_raises_without_a_card(tmp_path):
    """An index asked for the card cannot be had here, and a query on an
    index off both the card and the CPU raises in its first wrapper: no
    entry point of the query engine answers on the CPU in its place."""
    assert not torch.cuda.is_available()
    prepared = tt.prepare_documents([b"banana bandana", b"abc"])
    ix = tt.build_index(prepared, seg=64, mark_period=4, device="cpu")
    ix.save(str(tmp_path / "ix"))
    with pytest.raises(RuntimeError, match="cuda"):
        TQ.count_query(tt.FMIndex.load(str(tmp_path / "ix")), "ban(a|da)")
    meta = dataclasses.replace(ix, arrays=type(ix.arrays)(
        *(None if a is None else torch.empty_like(a, device="meta")
          for a in ix.arrays)))
    for call in (lambda: TQ.count_query(meta, "ban(a|da)"),
                 lambda: TQ.count_query(meta, "APPROX 1 banana"),
                 lambda: TQ.find_strings(meta, "b.n"),
                 lambda: TQ.docs_query(meta, "ban AND abc")):
        with pytest.raises(ValueError, match="devices"):
            call()
    assert TQ.count_query(ix, "ban(a|da)") == 2


def test_wrappers_refuse_mixed_devices():
    ix = tt.build_index(tt.prepare_documents([b"abc"]), seg=64,
                        mark_period=4, device="cpu")
    rows = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        TS.locate_rows(ix.arrays, 4, rows)
    with pytest.raises(ValueError, match="devices"):
        SO.gather_rows(torch.zeros(4, dtype=torch.int32), rows)
    with pytest.raises(ValueError, match="devices"):
        SO.sym_hist(rows)
    with pytest.raises(ValueError, match="devices"):
        SO.radix_sort_pairs(torch.zeros(2, dtype=torch.int64), rows, 0, 8)
    with pytest.raises(ValueError, match="int32"):
        TS.extract_backward(ix.arrays, torch.zeros(2, dtype=torch.int64), 3)
    # the sharded steps refuse them too
    with pytest.raises(ValueError, match="devices"):
        DO.bucket_pack(rows.view(1, 2), [torch.zeros((1, 2),
                                                     dtype=torch.int32)],
                       D=2, cap=2)
    with pytest.raises(ValueError, match="devices"):
        DO.masked_lf(ix.arrays, rows, Dl=1, nseg_local=ix.meta.n_seg,
                     shard0=0)
    nd = RO.FrontierNFA(S=16, T=32, src=None, dst=None, mask=None,
                        accept=None, in_off=torch.zeros(17, dtype=torch.int32),
                        in_src=None, in_mask=None)
    costs = torch.zeros((1, 16), dtype=torch.int32)
    forks = torch.zeros(261, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="devices"):
        RO.regex_fork_ranked(forks, forks, costs, 1, nd,
                             RO.LayerCfg(1, 1, 1, 1, 0, 8), False)


def test_variant_swaps_a_library_and_restores_the_built_one(monkeypatch):
    """kernels.variant (chip_smoke.py's route comparisons) serves a source's
    entries from another library inside the block only, even when the
    block raises; None stands for the built library."""
    built, other = object(), object()
    monkeypatch.setitem(kernels._libs, "radix_sort", built)
    with kernels.variant("radix_sort", other):
        assert kernels._libs["radix_sort"] is other
    with kernels.variant("radix_sort", None):
        assert kernels._libs["radix_sort"] is built
    with pytest.raises(RuntimeError):
        with kernels.variant("radix_sort", other):
            raise RuntimeError("a failed launch")
    assert kernels._libs["radix_sort"] is built


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card: non-zero exit and no result line, also from a directory
    that holds chip_smoke.py and nothing else of the repo."""
    src = os.path.join(ROOT, "chip_smoke.py")
    cwd = ROOT
    if alone:
        with open(src) as f, open(tmp_path / "chip_smoke.py", "w") as g:
            g.write(f.read())
        src, cwd = str(tmp_path / "chip_smoke.py"), str(tmp_path)
    out = subprocess.run([sys.executable, src], cwd=cwd, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_prepare_documents_matches_the_reference_layout():
    import femto_tpu as ft

    docs = [b"ab", b"", b"\x00\xff"]
    headers = [b"h", b"", b"xy"]
    got = tt.prepare_documents(docs, headers=headers)
    want = ft.prepare_documents(docs, headers=headers)
    assert np.array_equal(got.text, want.text)
    assert np.array_equal(got.doc_starts, want.doc_starts)
    assert np.array_equal(got.header_lens, want.header_lens)
    assert got.infos == want.infos
    assert np.array_equal(tt.alphabet.pattern_to_alpha(b"\x00z"),
                          ft.alphabet.pattern_to_alpha(b"\x00z"))
