"""Parity of femto_tpu_torch's index build with femto_tpu's, on the CPU.

Every output is integers, so the tolerance is exact: the port's full-tier
FMArrays must be bit-identical to femto_tpu's for the same corpus, seg and
mark_period, and each plain kernel version must equal the JAX stage it
replaces on the same numpy inputs.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu.ops import build_ops as JB
from femto_tpu.suffix import suffix_array_np
from femto_tpu_torch.ops import build_ops as TB
from tests.test_conformance import build_corpus

def _graft_docs():
    """The documents of __graft_entry__._small_index."""
    rng = np.random.default_rng(7)
    return [
        b"the quick brown fox jumps over the lazy dog",
        b"banana banana banana",
        bytes(rng.integers(0, 256, size=2000).astype(np.uint8)),
        b"abracadabra" * 20,
    ]


def _repeat_docs():
    """Long repeats: the suffix sort needs several doubling rounds."""
    rng = np.random.default_rng(11)
    return [
        b"abcabcabd" * 180,
        b"a" * 1500,
        b"",
        bytes(rng.integers(0, 4, size=700).astype(np.uint8)),
        b"abcabcabd" * 40 + b"!",
    ]


CORPORA = {
    "graft": _graft_docs,
    "conformance": lambda: build_corpus(np.random.default_rng(0xC0FFEE)),
    "repeats": _repeat_docs,
}


def as_numpy(t):
    """Tensor -> numpy with the same dtype and bits."""
    return t.cpu().numpy()


def assert_same_bits(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert np.array_equal(got, want), name


@pytest.mark.parametrize("corpus,seg,mark_period", [
    ("graft", 64, 8),
    ("graft", 256, 20),
    ("conformance", 64, 20),
    ("conformance", 256, 0),
    ("repeats", 64, 8),
])
def test_build_parity(corpus, seg, mark_period):
    docs = CORPORA[corpus]()
    jp = ft.prepare_documents(docs)
    want = ft.build_index(jp, seg=seg, mark_period=mark_period)
    got = tt.build_index(tt.prepare_documents(docs), seg=seg,
                         mark_period=mark_period, device="cpu")
    for field in ft.FMArrays._fields:
        w = getattr(want.arrays, field)
        g = getattr(got.arrays, field)
        assert (w is None) == (g is None), field
        if w is not None:
            assert_same_bits(field, as_numpy(g), np.asarray(w))
    assert dataclasses.asdict(got.meta) == dataclasses.asdict(want.meta)
    assert np.array_equal(got.doc_starts_np, want.doc_starts_np)
    assert got.infos == want.infos


def test_build_direct_keeps_suffix_array():
    docs = _graft_docs()
    prepared = tt.prepare_documents(docs)
    ix = tt.build_index(prepared, seg=64, mark_period=8, locate="direct",
                        device="cpu")
    want = suffix_array_np(prepared.text.astype(np.int64))
    assert_same_bits("sa_direct", as_numpy(ix.sa_direct),
                     want.astype(np.int32))
    given = tt.build_index(prepared, seg=64, mark_period=8, sa=want,
                           device="cpu")
    for field, got in given.arrays._asdict().items():
        if got is not None:
            assert_same_bits(field, as_numpy(got),
                             as_numpy(getattr(ix.arrays, field)))


@pytest.mark.parametrize("text", [
    "repeats", "single", "all_same", "random_binary",
])
def test_suffix_array_matches_oracle(text):
    rng = np.random.default_rng(5)
    if text == "repeats":
        arr = tt.prepare_documents(_repeat_docs()).text
    elif text == "single":
        arr = np.array([7], np.uint16)
    elif text == "all_same":
        arr = np.full(777, 9, np.uint16)
    else:
        arr = rng.integers(5, 7, size=3000).astype(np.uint16)
    t = torch.from_numpy(arr.astype(np.int32))
    payload = torch.from_numpy(rng.integers(0, 2**40, size=len(arr)))
    sa, pull = tt.suffix_array(t, payload=payload)
    want = suffix_array_np(arr.astype(np.int64))
    assert_same_bits("sa", as_numpy(sa), want.astype(np.int32))
    assert_same_bits("pull", as_numpy(pull), as_numpy(payload)[want])
    assert_same_bits("sa alone", as_numpy(tt.suffix_array(t)),
                     want.astype(np.int32))


def _stage_inputs(docs):
    """(text, doc_starts, sa, n, ndocs) of a corpus, as numpy."""
    prepared = ft.prepare_documents(docs)
    sa = suffix_array_np(prepared.text.astype(np.int64)).astype(np.int32)
    return (prepared.text.astype(np.int32),
            prepared.doc_starts.astype(np.int32), sa, prepared.n,
            prepared.num_docs)


@pytest.mark.parametrize("corpus,mark_period", [
    ("conformance", 20), ("repeats", 0), ("graft", 8),
])
def test_sa_payload_matches_jax(corpus, mark_period):
    text, ds, sa, n, ndocs = _stage_inputs(CORPORA[corpus]())
    want = JB.build_sa_payload(jnp.asarray(text), jnp.asarray(ds), n=n,
                               mark_period=mark_period, ndocs=ndocs)
    got = TB.build_sa_payload(torch.from_numpy(text), torch.from_numpy(ds),
                              n=n, mark_period=mark_period, ndocs=ndocs)
    assert np.array_equal(as_numpy(got), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("corpus,seg", [("graft", 64), ("conformance", 256)])
def test_occ_build_plain_matches_jax(corpus, seg):
    """Kernel A's plain version against _split_pull + _occ_stage."""
    text, ds, sa, n, ndocs = _stage_inputs(CORPORA[corpus]())
    payload = JB.build_sa_payload(jnp.asarray(text), jnp.asarray(ds), n=n,
                                  mark_period=20, ndocs=ndocs)
    pull = np.asarray(payload)[sa]
    n_seg = n // seg + 1
    bwt, chars, a_row = JB._split_pull(jnp.asarray(pull), n=n,
                                       n_pad=n_seg * seg)
    C, occ, _ = JB._occ_stage(chars, n=n, n_seg=n_seg, seg=seg)
    g_bwt, g_arow, g_occ, g_C = TB.occ_build(
        torch.from_numpy(pull.astype(np.int64)), n_seg=n_seg, seg=seg)
    assert_same_bits("bwt", as_numpy(g_bwt),
                     np.asarray(bwt).reshape(n_seg, seg))
    assert_same_bits("a_row", as_numpy(g_arow), np.asarray(a_row))
    assert_same_bits("occ_ckpt", as_numpy(g_occ), np.asarray(occ))
    assert_same_bits("C", as_numpy(g_C), np.asarray(C))


@pytest.mark.parametrize("corpus,seg,mark_period", [
    ("graft", 64, 8), ("conformance", 64, 20), ("conformance", 256, 0),
    ("repeats", 64, 3),
])
def test_marks_build_plain_matches_jax(corpus, seg, mark_period):
    """Kernel B's plain version against _marks_finish + _pack_mark_vals."""
    text, ds, sa, n, ndocs = _stage_inputs(CORPORA[corpus]())
    payload = JB.build_sa_payload(jnp.asarray(text), jnp.asarray(ds), n=n,
                                  mark_period=mark_period, ndocs=ndocs)
    a_row = (np.asarray(payload)[sa] >> 9).astype(np.int32)
    n_seg = n // seg + 1
    cap = JB.mark_cap(n, ndocs, mark_period, seg)
    bits_w, ckpt_w, vals_w, nm_w, seof_w = JB._marks_finish(
        jnp.asarray(sa), jnp.asarray(a_row), n=n, n_pad=n_seg * seg, seg=seg,
        cap=cap, ndocs=ndocs, mark_period=mark_period)
    if mark_period == 0:
        vals_w = np.zeros(2, np.uint32)
        meta_w = np.array([1, 1, 0, 1, cap], np.int32)
    else:
        bits, exc_base, exc_cap, n_words = JB.mark_pack_geom(
            n, mark_period, ndocs, cap)
        vals_w, meta_w = JB._pack_mark_vals(
            vals_w, cap=cap, bits=bits, exc_base=exc_base, exc_cap=exc_cap,
            period=mark_period, n_words=n_words)
    got = TB.marks_build(torch.from_numpy(sa), torch.from_numpy(a_row),
                         n_seg=n_seg, seg=seg, mark_period=mark_period,
                         ndocs=ndocs)
    for name, g, w in zip(
            ("mark_bits", "mark_ckpt", "mark_vals", "mark_meta", "n_marks",
             "doc_seof_rows"),
            got, (bits_w, ckpt_w, vals_w, meta_w, nm_w, seof_w)):
        assert_same_bits(name, as_numpy(g), np.asarray(w))


@pytest.mark.parametrize("kwargs", [
    {"device_build": False},
])
def test_options_outside_the_slice_raise(kwargs):
    prepared = tt.prepare_documents([b"abc"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tt.build_index(prepared, device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,exc", [
    ({"seg": 48}, ValueError), ({"locate": "psi"}, ValueError),
])
def test_bad_build_arguments_raise(kwargs, exc):
    with pytest.raises(exc):
        tt.build_index(tt.prepare_documents([b"abc"]), device="cpu", **kwargs)
