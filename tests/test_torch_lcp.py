"""The LCP analytics of femto_tpu_torch (lcp.py) against femto_tpu's.

Inputs are made from a seed with numpy and handed to both packages; every
output is integers (the similarity scores floats computed by the same
numpy expressions), so the tolerance is exact.  The port's device path
runs here on CPU tensors, through the plain versions of kernel S's
lcp_round and lcp_compact; femto_tpu's device path runs on the CPU in
JAX.  femto_tpu compiles a program per window and compaction size, so its
lanes stay at or below 2^14.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import femto_tpu as ft
import femto_tpu_torch as tt
from femto_tpu import lcp as JL
from femto_tpu.suffix import suffix_array_np
from femto_tpu_torch import lcp as TL
from femto_tpu_torch.ops import lcp_ops as LO


def _naive_lcp(text, sa):
    n = len(text)
    out = np.zeros(n, dtype=np.int32)
    for r in range(1, n):
        i, j = int(sa[r - 1]), int(sa[r])
        h = 0
        while i + h < n and j + h < n and text[i + h] == text[j + h]:
            h += 1
        out[r] = h
    return out


def _all_paths(text, sa):
    """The port's device path (plain kernels), its host path, femto_tpu's
    device path and _kasai_np: all equal; returns the LCP array."""
    got = TL.lcp_array(text, sa, device=True, torch_device="cpu")
    host = TL.lcp_array(text, sa, device=False)
    want = JL.lcp_array(text, sa, device=True)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(TL._kasai_np(text, sa), want)
    return got


@pytest.mark.parametrize("sigma", [2, 4])
def test_random_texts(sigma):
    rng = np.random.default_rng(40 + sigma)
    for n in (2, 37, 300, 3000):
        text = rng.integers(1, 1 + sigma, size=n).astype(np.uint16)
        sa = suffix_array_np(text)
        got = _all_paths(text, sa)
        if n <= 300:
            np.testing.assert_array_equal(got, _naive_lcp(text, sa))


def test_a_repeat_past_4096_keeps_the_window_there():
    """A run of 9000 symbols: its suffixes share up to 8999 symbols, past
    32 + 64 + ... + 4096 = 8160, so the window reaches 4096 and stays
    there for another round."""
    rng = np.random.default_rng(7)
    text = np.concatenate([rng.integers(1, 5, 2000), np.full(9000, 3),
                           rng.integers(1, 5, 2000)]).astype(np.uint16)
    sa = suffix_array_np(text)
    got = _all_paths(text, sa)
    assert got.max() >= 8999
    st = TL.last_stats
    assert st["windows"][-2:] == [4096, 4096]
    assert st["live"][0] == len(text) and st["live"][-1] == 0


@pytest.mark.parametrize("n", [0, 1])
def test_tiny_texts(n):
    text = np.full(n, 5, np.uint16)
    sa = np.arange(n, dtype=np.int32)
    for device in (True, False):
        got = TL.lcp_array(text, sa, device=device, torch_device="cpu")
        np.testing.assert_array_equal(got, JL.lcp_array(text, sa,
                                                        device=device))
        assert got.dtype == np.int32 and got.shape == (n,)


def test_batch_with_invalid_lanes_and_lanes_past_the_end():
    rng = np.random.default_rng(9)
    n = 2500
    text = rng.integers(1, 3, n).astype(np.uint16)
    B = 700
    i = rng.integers(0, n + 40, B).astype(np.int32)
    j = rng.integers(0, n + 40, B).astype(np.int32)
    i[:50] = n - rng.integers(1, 20, 50)      # windows over the end
    j[50:60] = i[50:60]                        # equal suffixes
    valid = rng.random(B) < 0.8
    got = TL.batch_lcp_device(
        torch.from_numpy(text.astype(np.int32)), i, j, valid)
    want = JL.batch_lcp_device(jnp.asarray(text.astype(np.int32)), i, j,
                               valid)
    np.testing.assert_array_equal(got, want)
    assert (got[~valid] == 0).all()
    np.testing.assert_array_equal(
        got[50:60], np.where(valid[50:60], np.maximum(n - i[50:60], 0), 0))


@pytest.mark.parametrize("q", [1, 7, 64])
def test_sparse_plcp(q):
    rng = np.random.default_rng(q)
    text = rng.integers(1, 5, 1500).astype(np.uint16)
    sa = suffix_array_np(text)
    got = TL.sparse_plcp(text, sa, q=q, torch_device="cpu")
    np.testing.assert_array_equal(got, JL.sparse_plcp(text, sa, q=q))
    plcp = np.zeros(len(text), np.int32)
    plcp[sa] = JL._kasai_np(text, sa)
    np.testing.assert_array_equal(got, plcp[::q])


def _corpus():
    rng = np.random.default_rng(21)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"shared-phrase-"]
    docs = [b" ".join(rng.choice(words, 60)) for _ in range(5)]
    docs += [docs[1][:150] + b"tail", b"", b"x"]
    return docs


def test_applications_match_femto_tpu():
    docs = _corpus()
    tp = tt.prepare_documents(docs)
    jp = ft.prepare_documents(docs)
    np.testing.assert_array_equal(tp.text, jp.text)
    sa = suffix_array_np(jp.text)
    lcp = TL.lcp_array(tp.text, sa, device=True, torch_device="cpu")
    for given in (None, lcp):
        np.testing.assert_array_equal(
            TL.unique_lengths(tp, sa, given),
            JL.unique_lengths(jp, sa, given))
        for k in (1, 3, 8):
            assert TL.extract_unique_kmers(tp, sa, k, given) == \
                JL.extract_unique_kmers(jp, sa, k, given)
        for min_lcp in (1, 4, 12):
            got = TL.suffix_similarity(tp, sa, given, min_lcp=min_lcp)
            want = JL.suffix_similarity(jp, sa, given, min_lcp=min_lcp)
            assert got == want and got


def test_device_none_switches_at_the_device_size():
    """device=None: the host pass below _DEVICE_LCP_MIN_N, the device path
    (here the card, which this host lacks) from it on."""
    assert TL._DEVICE_LCP_MIN_N == JL._DEVICE_LCP_MIN_N == 1 << 17
    rng = np.random.default_rng(17)
    n = TL._DEVICE_LCP_MIN_N
    text = rng.integers(1, 5, n).astype(np.uint16)
    sa = suffix_array_np(text)
    host = TL.lcp_array(text[:-1], suffix_array_np(text[:-1]))
    np.testing.assert_array_equal(
        host, TL._kasai_np(text[:-1], suffix_array_np(text[:-1])))
    with pytest.raises(RuntimeError, match="cuda"):
        TL.lcp_array(text, sa)
    TL.last_stats.clear()
    got = TL.lcp_array(text, sa, torch_device="cpu")
    assert TL.last_stats["rounds"] >= 1
    np.testing.assert_array_equal(got, TL.lcp_array(text, sa, device=False))


def test_plain_kernels_match_the_jax_steps():
    """lcp_round and lcp_compact's plain versions against femto_tpu's
    round and compaction at W = 32 and 4096, with fill slots."""
    rng = np.random.default_rng(33)
    n, B = 6000, 512
    text = np.concatenate([rng.integers(1, 3, n - 4500),
                           np.full(4500, 2)]).astype(np.int32)
    i = rng.integers(0, n, B).astype(np.int32)
    j = rng.integers(0, n, B).astype(np.int32)
    h = rng.integers(0, 40, B).astype(np.int32)
    valid = rng.random(B) < 0.9
    t = torch.from_numpy
    round_j = JL._round_cached()
    compact_j = JL._compact_cached()
    for W in (32, 4096):
        gh, ga = LO.lcp_round(t(text), t(i), t(j), t(h), t(valid), W)
        wh, wa = round_j(jnp.asarray(text), jnp.asarray(i), jnp.asarray(j),
                         jnp.asarray(h), jnp.asarray(valid), W)
        np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wa))
        orig = rng.permutation(B + 64)[:B].astype(np.int32)  # some >= B
        out = rng.integers(0, 9, B).astype(np.int32)
        m = int(np.asarray(wa).sum())
        M_out = 2 * m + 3
        got_out = t(out.copy())
        got = LO.lcp_compact(got_out, t(i), t(j), gh, ga, t(orig), M_out)
        want = compact_j(jnp.asarray(out), jnp.asarray(i), jnp.asarray(j),
                         wh, wa, jnp.asarray(orig), B_out=B, M_out=M_out)
        np.testing.assert_array_equal(got_out.numpy(), np.asarray(want[0]))
        for g, w in zip(got[:4], want[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert int(got[4]) == m
