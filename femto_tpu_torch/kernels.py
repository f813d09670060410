"""Build, bind and count the port's hand-written CUDA kernels.

Every source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``.  Libraries land in ``_build/`` beside
this file (listed in ``.gitignore``), named by a hash of the sources and
flags, and are built on first use: all sources at once, one ``nvcc`` each.

Each C entry point launches its kernels on the stream it is given,
allocates nothing, and returns ``cudaGetLastError()``; :func:`launch` raises
when that is not 0 and otherwise adds one to the entry's launch count.  It
keeps each entry's bound function after its first call and reads the raw
stream handle, so that a small call costs little host time.  The
search entries take the index as an :class:`FmView` and run one kernel
instantiation per row layout (full, compact, packed, vseg, vrle); their
launches are counted per layout, as ``"entry[layout]"`` (the paged steps
serve the vseg and vrle layouts only).  Nothing here is built for CPU
tensors: the wrappers in ``ops/`` check their inputs with :func:`check` and
take their plain PyTorch versions where :func:`on_card` says the tensors lie
on the CPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# csrc/fm_common.cuh Layout
LAYOUTS = ("full", "compact", "packed", "vseg", "vrle")


class FmView(ctypes.Structure):
    """csrc/fm_common.cuh FmView: the index as the search kernels see it
    (device pointers and the layout's geometry)."""

    _fields_ = [("bwt", _P), ("occ_ckpt", _P), ("occ_l1", _P), ("C", _P),
                ("alpha_map", _P), ("alpha_rev", _P), ("n_seg", _L),
                ("seg", _I), ("K", _I), ("grp", _I), ("W", _I),
                ("per_word", _I), ("bits", _I), ("layout", _I),
                # the row tiers (vseg, vrle)
                ("seg_ovf", _P), ("seg_nsym", _P), ("seg_woff", _P),
                ("seg_cont", _P), ("row_words", _I), ("code_words", _I),
                ("w_main", _I), ("off_syms", _I), ("off_mk", _I),
                ("off_mck", _I), ("off_rel", _I), ("S", _I), ("wide", _I),
                ("w_side", _I), ("side_words", _I), ("n_side", _I),
                ("G", _I), ("ngr", _I), ("X", _L),
                # paged serving: cache slot of each true segment, or null
                ("seg_slot", _P)]


_V = ctypes.POINTER(FmView)

# entry point -> (source stem, argument types without the trailing stream)
ENTRIES: Dict[str, Tuple[str, List]] = {
    "occ_build": ("occ_build", [_P, _L, _L, _I, _P, _P, _P, _P, _P]),
    "occ_build_compact": ("occ_build", [_P, _L, _L, _I, _P, _I, _I, _P, _P,
                                        _P, _P, _P, _P, _P]),
    "marks_build": ("marks_build", [_P, _P, _L, _L, _I, _I, _L, _I, _I, _I,
                                    _L, _P, _P, _P, _P, _P, _P, _P, _P, _P]),
    "pack_build": ("pack_build", [_P, _L, _I, _P, _I, _I, _I, _P]),
    # the row tiers: kernel M (vseg_build.cu) and N (vrle_build.cu)
    "seg_syms": ("vseg_build", [_P, _L, _I, _I, _P, _P]),
    "vseg_rows": ("vseg_build", [_P, _L, _I, _P, _P, _I, _P, _P, _I, _I,
                                 _P, _I, _I, _I, _P, _P, _P, _I, _I, _P]),
    "side_rows": ("vseg_build", [_P, _L, _I, _P, _P, _I, _I, _I, _P]),
    "vrle_slot_count": ("vrle_build", [_P, _L, _I, _P, _P, _I, _P, _P]),
    "vrle_pack": ("vrle_build", [_P, _L, _I, _P, _P, _I, _P, _P, _I, _P]),
    "cont_flatten": ("vrle_build", [_P, _L, _I, _I, _P, _P, _P, _I, _L,
                                    _P]),
    "backward_search": ("backward_search", [_V, _P, _I, _I, _I, _I, _P, _P]),
    "backward_search_steps": ("backward_search", [_V, _P, _I, _I, _I, _I,
                                                  _P, _P, _P, _P, _P]),
    "backward_step": ("backward_search", [_V, _P, _P, _P, _I, _P, _P]),
    # paged serving (paged.py, K16): C's masked step, D's locate step and
    # mark decode, and the cache update
    "backward_step_masked": ("backward_search", [_V, _P, _P, _P, _I, _P,
                                                 _P]),
    "lf_walk_step": ("lf_walk", [_V, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                                 _P]),
    "resolve_marks": ("lf_walk", [_P, _P, _I, _P, _L, _P, _P]),
    "apply_faults": ("paged", [_P, _L, _I, _P, _L, _P, _P, _P, _P, _I, _I]),
    # the LCP analytics (lcp.py, K17)
    "lcp_round": ("lcp", [_P, _L, _P, _P, _P, _P, _I, _I, _P, _P]),
    "lcp_compact": ("lcp", [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                            _P, _P]),
    "lf_locate": ("lf_walk", [_V, _P, _I, _P, _P, _P, _L, _P, _I, _P]),
    "lf_extract": ("lf_walk", [_V, _P, _I, _I, _P, _P]),
    "psi_walk": ("psi_walk", [_V, _P, _I, _I, _P]),
    # the suffix sort (ops/sort_ops.py) and its payload
    "sym_hist": ("sa_keys", [_P, _L, _P]),
    "sa_keys": ("sa_keys", [_P, _L, _P, _I, _I, _L, _P]),
    "radix_sort_pairs": ("radix_sort", [_P, _P, _P, _P, _P, _P, _L, _I, _I,
                                        _P]),
    "group_flags": ("sa_groups", [_P, _L, _P]),
    "tied_compact": ("sa_groups", [_P, _P, _L, _I, _P, _P, _P, _P, _P, _P]),
    "rank_init": ("sa_rounds", [_P, _L, _P, _P, _L, _P]),
    "round_keys": ("sa_rounds", [_P, _P, _L, _L, _P, _L, _P, _P, _L, _I, _I,
                                 _P, _P]),
    "round_commit": ("sa_rounds", [_P, _P, _P, _P, _P, _L]),
    "sa_payload": ("sa_payload", [_P, _L, _P, _I, _I, _P]),
    "gather_rows": ("sa_payload", [_P, _L, _I, _P, _L, _P]),
    # kernel L on up to 8 columns through one idx (the sharded sorts)
    "gather_cols": ("sa_payload", [_P, _L, _L, _I, _I] + [_P] * 16),
    # chunked builds: the uint8 text upload and the doc lists (K14)
    "expand_u8": ("text_expand", [_P, _L, _L, _I, _P, _L, _I, _P, _L, _I,
                                  _P, _L, _I, _P]),
    "doc_lists": ("doc_lists", [_P, _L, _L, _P, _I, _I, _L, _P, _I, _P]),
    "flatten_ragged": ("doc_lists", [_P, _I, _P, _P, _L, _P]),
    # the device regex frontier (ops/regex_ops.py, K15)
    "regex_fork": ("regex_frontier", [_V, _P, _P, _P, _I, _I, _I, _P, _P,
                                      _P, _I, _I, _I, _I, _I, _I, _I, _P,
                                      _P, _P]),
    "regex_merge": ("regex_frontier", [_P, _P, _P, _L, _I, _P, _I, _I, _I,
                                       _I, _I, _P, _P, _P, _P, _P, _P, _P]),
    # the sharded frontier's fork (K18h): the forks' ranges given
    "regex_fork_ranked": ("regex_frontier", [_P, _P, _P, _I, _I, _I, _P, _P,
                                             _P, _I, _I, _I, _I, _I, _I, _I,
                                             _P, _P, _P]),
    # the sharded build and queries (ops/dist_ops.py, K18a-K18f)
    "bucket_pack": ("exchange", [_P, _P, _L, _I, _I, _I, _I] + [_P] * 16
                    + [_P, _P, _P]),
    "owner_place": ("exchange", [_P, _P, _L, _I, _L, _I, _L, _L, _I, _I]
                    + [_P] * 8),
    "splitter_bucket": ("sample_sort", [_P] * 4 + [_I, _L, _I] + [_P] * 4
                        + [_I, _P]),
    # the rebalance by destination, one kernel: the local shards' blocks,
    # or one offset's buffers for owners in another process
    "rebalance_local": ("sample_sort", [_P] * 6 + [_I, _L, _P, _P, _I, _I,
                                                   _L, _I] + [_P] * 7),
    "rebalance_place": ("sample_sort", [_P] * 6 + [_I, _L, _P, _P, _I, _I,
                                                   _L, _I] + [_P] * 7),
    "mesh_exclusive": ("sample_sort", [_P, _I, _I, _I, _I, _I, _P, _P]),
    "add_base": ("sample_sort", [_P, _P, _L, _I, _I]),
    # the cross-shard prefix summed inside add_base's kernel (one launch)
    "add_mesh_base": ("sample_sort", [_P, _L, _I, _I, _P, _I, _I, _P, _P]),
    "seed_keys": ("dist_rounds", [_P, _L, _L, _I, _I, _L, _L, _P, _I, _I,
                                  _I, _P, _P, _P]),
    "payload_block": ("dist_rounds", [_P, _P, _L, _I, _I, _L, _P, _I, _I,
                                      _P]),
    "mesh_flags": ("dist_rounds", [_P] * 6 + [_I] + [_P] * 6
                   + [_L, _I, _I, _I, _P]),
    "mesh_scan": ("dist_rounds", [_P, _P, _L, _I, _I, _I, _P, _P, _P]),
    "compact_rows": ("dist_rounds", [_P, _P, _L, _I, _I, _L, _I]
                     + [_I] * 8 + [_P] * 17),
    "fetch_owned": ("dist_rounds", [_P, _L, _I, _I, _P, _P, _L, _L, _I, _L,
                                    _P]),
    "owner_occ": ("dist_query", [_V, _L, _I, _P, _P, _P, _L, _I, _L, _P]),
    "masked_occ": ("dist_query", [_V, _L, _I, _I, _P, _P, _L, _L, _P]),
    # the sharded frontier's ranks: every symbol's masked occ at each row
    "masked_occ_rows": ("dist_query", [_V, _L, _I, _I, _P, _L, _L, _P]),
    "owner_lf": ("dist_query", [_V, _L, _I, _P, _P, _L, _I, _P, _P, _P, _L,
                                _P, _P]),
    "masked_lf": ("dist_query", [_V, _L, _I, _I, _P, _L, _P, _P, _P, _L, _P,
                                 _P]),
}
# scratch sizes a source reports for its entries (no launch, not counted):
# name -> (source stem, argument types); each returns int32 elements
SIZES: Dict[str, Tuple[str, List]] = {
    "regex_fork_scratch": ("regex_frontier", [_I, _I]),
    "regex_merge_tiles": ("regex_frontier", [_L]),
    "doc_lists_stride": ("doc_lists", [_I]),
    "lcp_compact_scratch": ("lcp", [_L]),
    "radix_sort_scratch": ("radix_sort", [_L]),
    "bucket_pack_scratch": ("exchange", [_L, _I, _I]),
    # mesh_scan's and compact_rows' scratch (m, Dl): tile counters and
    # look-back status words, a multiple of 4
    "scan_scratch": ("dist_rounds", [_L, _I]),
    # not a size: the flags a tile of mesh_scan (0) or compact_rows (1)
    "scan_tile": ("dist_rounds", [_I]),
    # not sizes: the kernels one radix_sort_pairs call launches, and the
    # keys a tile there (0: one block sorts them all)
    "radix_sort_kernels": ("radix_sort", [_L, _I, _I]),
    "radix_sort_tile": ("radix_sort", [_L]),
    # not a size: the records a tile in a bucket_pack call (0: one block a
    # shard packs them all)
    "bucket_pack_tile": ("exchange", [_L]),
    # kernel D's route for a call of B walks on an index (view, B,
    # extract: 1 for lf_extract, 0 for lf_locate and lf_walk_step): the
    # bytes of a warp-a-walk block's dynamic shared memory, 0 where the
    # call takes a thread a walk
    "lf_walk_route": ("lf_walk", [_V, _I, _I]),
    # kernel C's route for a call on an index (view, B, one_step: 0 for
    # B patterns of backward_search or backward_search_steps, 1 for B
    # lanes of backward_step or backward_step_masked), one rule for its
    # four entries: the bytes of a warp-a-pattern block's dynamic shared
    # memory, 0 where the call takes a thread a pattern or lane
    "backward_search_route": ("backward_search", [_V, _I, _I]),
    # kernel E's route for a psi walk of B rows on an index (view, B): the
    # bytes of a warp-a-walk block's dynamic shared memory, 0 where the
    # call takes a thread a walk
    "psi_walk_route": ("psi_walk", [_V, _I]),
    # K18f owner_lf's route for a call of (view, R, Dl): the same rule on
    # its Dl x R requests, 0 on the thread route
    "owner_lf_route": ("dist_query", [_V, _L, _I]),
    # the all-symbol rank's rule (csrc/fm_common.cuh row_rank_min):
    # masked_occ_rows' route for a call of (view, M rows, Dl), the row
    # route's bytes of a block's shared memory, 0 on the lane route; and
    # the fewest codes an entry of regex_fork (view, S states) must rank
    # to rank by rows, 0x7fffffff where it never does
    "masked_occ_rows_route": ("dist_query", [_V, _L, _I]),
    "regex_fork_row_min": ("regex_frontier", [_V, _I]),
}
# entries that take an FmView: one count per layout
LAYOUT_ENTRIES = ("backward_search", "backward_search_steps", "backward_step",
                  "lf_locate", "lf_extract", "psi_walk", "regex_fork",
                  "owner_occ", "masked_occ", "masked_occ_rows", "owner_lf",
                  "masked_lf")
# entries that take an FmView of a row tier only: one count per row layout
ROW_LAYOUTS = ("vseg", "vrle")
ROW_LAYOUT_ENTRIES = ("backward_step_masked", "lf_walk_step")
# entries with modes that do different work: one count per mode (None: the
# entry's own name)
MODE_ENTRIES = {"round_keys": ("extension", "doubling"),
                "sa_keys": (None, "n_real")}
SOURCES = sorted({src for src, _ in ENTRIES.values()})


def counter(entry: str, layout: Optional[str] = None) -> str:
    """Name of the launch count of an entry (and layout or mode)."""
    return entry if layout is None else f"{entry}[{layout}]"


def counters(entry: str) -> List[str]:
    """Names of the launch counts of an entry: one per layout or mode."""
    if entry in LAYOUT_ENTRIES:
        kinds = LAYOUTS
    elif entry in ROW_LAYOUT_ENTRIES:
        kinds = ROW_LAYOUTS
    else:
        kinds = MODE_ENTRIES.get(entry, (None,))
    return [counter(entry, kind) for kind in kinds]


# Launches per entry point (and layout or mode) since the last
# reset_launches().
launches: Dict[str, int] = {
    name: 0 for entry in ENTRIES for name in counters(entry)}
# nvcc output (register and shared-memory use) of the last build, by source.
build_logs: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# entry -> its bound C function, filled by launch() on first use and
# emptied whenever a library is swapped (variant)
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    return found or "/usr/local/cuda/bin/nvcc"


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name == src + ".cu" or name.endswith(".cuh"):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"lib{src}.{h.hexdigest()[:12]}.so")


def build(sources=None) -> Dict[str, float]:
    """Compile the given sources (default: all) that are not built yet, all
    at once; returns seconds per source compiled.  Raises with the
    compiler's output when one fails."""
    sources = SOURCES if sources is None else sources
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _lib_path(src)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src + ".cu")]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    seconds = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        build_logs[src] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {src}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def bind(path: str, src: str) -> ctypes.CDLL:
    """The library at `path`, built from csrc/<src>.cu, with the argument
    and result types of that source's entries and sizes set."""
    lib = ctypes.CDLL(path)
    for entry, (s, argtypes) in ENTRIES.items():
        if s == src:
            fn = getattr(lib, "femto_" + entry)
            fn.argtypes = argtypes + [_P]
            fn.restype = _I
    for name, (s, argtypes) in SIZES.items():
        if s == src:
            fn = getattr(lib, "femto_" + name)
            fn.argtypes = argtypes
            fn.restype = _L
    return lib


def _lib(src: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(src)
        if lib is None:
            path = _lib_path(src)
            if not os.path.exists(path):
                build(SOURCES)
            lib = _libs[src] = bind(path, src)
        return lib


@contextlib.contextmanager
def variant(src: str, lib: Optional[ctypes.CDLL]):
    """Within the block, src's entries and sizes come from `lib` (bind of
    csrc/<src>.cu built with other -D flags; None: the built library, so
    that both sides of a comparison pay the same swap) through the same
    wrappers; launches count as usual.  For holding a design choice
    against its alternative (chip_smoke.py)."""
    built = _lib(src)
    with _lock:
        _libs[src] = built if lib is None else lib
        _fns.clear()
    try:
        yield lib
    finally:
        with _lock:
            _libs[src] = built
            _fns.clear()


def _bound(entry: str):
    """The entry's C function in its source's library (built on first
    use), cached in _fns."""
    src, _ = ENTRIES[entry]
    fn = getattr(_lib(src), "femto_" + entry)
    with _lock:
        _fns[entry] = fn
    return fn


def launch(entry: str, *args, layout: Optional[str] = None) -> None:
    """Call one C entry point on the current CUDA stream; raise if it
    reports a CUDA error, else count the launch (under its layout for the
    entries that take an FmView, under its mode for MODE_ENTRIES)."""
    name = counter(entry, layout)
    if name not in launches:
        raise ValueError(f"no kernel entry {name!r}")
    fn = _fns.get(entry) or _bound(entry)
    # the current stream's raw handle, with no Stream object a call
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(
        torch._C._cuda_getDevice()))
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")
    launches[name] += 1


def size(name: str, *args) -> int:
    """A scratch size (int32 elements) from the source that uses it
    (SIZES), so that the wrappers repeat none of its constants."""
    src, _ = SIZES[name]
    return int(getattr(_lib(src), "femto_" + name)(*args))


def on_card(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the card (launch the kernel), False if
    every one lies on the CPU (take the plain version); mixed or other
    devices raise."""
    if tensors and all(t.is_cuda for t in tensors):
        return True
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {types}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          shape=None) -> None:
    """Raise unless t is a contiguous ndim-D tensor of dtype (and shape)."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
