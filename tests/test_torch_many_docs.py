"""The port's full-tier build of a corpus of 2^21 documents, held to
femto_tpu's on the CPU.

From 2^21 documents on, femto_tpu's document tag no longer fits beside
the 9-bit symbol in one int32 payload word (``_FUSE_DOC_LIMIT``,
femto_tpu/ops/build_ops.py), so it builds the marks through
``_aux_gather_stage`` instead of the fused payload.  The port's payload
is int64 and keeps one path.  The smallest such corpus (2^21 documents
of 0 or 1 bytes, drawn from a seed) goes through both builds; every
FMArrays field must be bit-identical, marks included.
"""

import dataclasses

import numpy as np

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.ops.build_ops import _FUSE_DOC_LIMIT
from tests.torch_threads import one_torch_thread  # noqa: F401


def test_full_tier_past_the_fused_doc_limit():
    rng = np.random.default_rng(21)
    ndocs = _FUSE_DOC_LIMIT
    lens = rng.integers(0, 2, size=ndocs)
    vals = rng.integers(0, 256, size=ndocs).astype(np.uint8)
    docs = [bytes(vals[i: i + 1]) if lens[i] else b"" for i in range(ndocs)]
    seg, mark_period = 64, 8
    want = ft.build_index(ft.prepare_documents(docs), seg=seg,
                          mark_period=mark_period)
    got = tt.build_index(tt.prepare_documents(docs), seg=seg,
                         mark_period=mark_period, device="cpu")
    assert want.meta.n_marks > 0
    for field in ft.FMArrays._fields:
        w = getattr(want.arrays, field)
        g = getattr(got.arrays, field)
        assert (w is None) == (g is None), field
        if w is not None:
            w, g = np.asarray(w), g.cpu().numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert np.array_equal(g, w), field
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    assert np.array_equal(got.doc_starts_np, want.doc_starts_np)
