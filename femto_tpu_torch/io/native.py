"""ctypes binding for the native C++ corpus loader (native/femto_io.cpp).

femto_tpu/io/native.py as it is (it holds no JAX).  Builds the in-repo
native/femto_io.cpp on demand with ``make -C native`` into
native/libfemto_io.so; every function returns None (ensure_built False)
when a toolchain is unavailable, and its callers take their Python paths.
lcp.lcp_array calls the library's ft_kasai below its device size.  The
native path is the analog of the reference's C input plugins and
multithreaded staging.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from ..alphabet import PreparedText

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libfemto_io.so"))

_lib = None


def ensure_built(quiet: bool = True) -> bool:
    """Build the native library if needed; returns availability."""
    global _lib
    if _lib is not None:
        return True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=quiet,
            )
        except Exception:
            return False
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return False
    lib.ft_version.restype = ctypes.c_int
    lib.ft_corpus_sizes.restype = ctypes.c_int
    lib.ft_corpus_fill.restype = ctypes.c_int
    lib.ft_corpus_sizes_hdr.restype = ctypes.c_int
    lib.ft_corpus_fill_hdr.restype = ctypes.c_int
    lib.ft_fasta_sizes.restype = ctypes.c_int
    lib.ft_fasta_fill.restype = ctypes.c_int
    _lib = lib
    return True


def _path_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    keep = [p.encode() for p in paths]
    for i, p in enumerate(keep):
        arr[i] = p
    return arr, keep


def prepare_corpus_native(
    paths: Sequence[str], n_threads: int = 0,
    path_headers: bool = False,
) -> Optional[PreparedText]:
    """Two-pass native corpus preparation (one document per file).

    path_headers=True stores each file's path as a searchable SOH/EOH
    header section (the reference's doc-URL headers)."""
    if not ensure_built():
        return None
    if n_threads <= 0:
        n_threads = os.cpu_count() or 4
    arr, keep = _path_array(paths)
    total = ctypes.c_int64()
    ndocs = ctypes.c_int64()
    sizes_fn = (_lib.ft_corpus_sizes_hdr if path_headers
                else _lib.ft_corpus_sizes)
    if sizes_fn(arr, len(paths), ctypes.byref(total),
                ctypes.byref(ndocs)) != 0:
        raise OSError("unreadable input file")
    text = np.empty(total.value, dtype=np.uint16)
    starts = np.empty(ndocs.value + 1, dtype=np.int64)
    header_lens = None
    if path_headers:
        header_lens = np.empty(ndocs.value, dtype=np.int64)
        rc = _lib.ft_corpus_fill_hdr(
            arr, len(paths),
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            header_lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
    else:
        rc = _lib.ft_corpus_fill(
            arr, len(paths),
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n_threads,
        )
    if rc != 0:
        raise OSError("corpus read failed")
    infos = [p.encode() for p in paths]
    return PreparedText(text=text, doc_starts=starts, infos=infos,
                        header_lens=header_lens)


def prepare_fasta_native(
    paths: Sequence[str], reverse_complement: bool = False
) -> Optional[PreparedText]:
    if not ensure_built():
        return None
    arr, keep = _path_array(paths)
    total = ctypes.c_int64()
    ndocs = ctypes.c_int64()
    rcflag = 1 if reverse_complement else 0
    if _lib.ft_fasta_sizes(arr, len(paths), rcflag, ctypes.byref(total),
                           ctypes.byref(ndocs)) != 0:
        raise OSError("unreadable FASTA file")
    text = np.empty(total.value, dtype=np.uint16)
    starts = np.empty(ndocs.value + 1, dtype=np.int64)
    if _lib.ft_fasta_fill(
        arr, len(paths), rcflag,
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    ) != 0:
        raise OSError("FASTA read failed")
    infos = [b"rec%d" % i for i in range(ndocs.value)]
    return PreparedText(text=text, doc_starts=starts, infos=infos)
