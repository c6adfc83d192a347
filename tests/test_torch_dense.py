"""``DenseIndex`` of the PyTorch port against the JAX package's, on the CPU.

Mirrors ``tests/test_index.py`` (add/search, growth, delete/compact, empty,
snapshot, search_tail, bf16 storage) and ``tests/test_int8.py`` (int8
storage) with both indexes fed the same numpy rows and queries. Ids must be
equal; scores agree to 1e-6 (float32 summation order only).

int8: ``add`` normalises, then quantizes. The two packages' normalisations
sum the squares in different orders and differ by ulps in many rows, so
codes after ``add`` may differ by one step in at most 1e-5 of the codes
(scales by an ulp or two); where a test needs both indexes to hold the
same bytes, the port loads the JAX index's snapshot, which is bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.index.dense import DenseIndex as JaxDense
from optimized_rag_tpu_torch.index.dense import DenseIndex, _first_kept

torch.set_num_threads(2)

ATOL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _pair(dim, capacity_block, tile, dtype="float32"):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
           "int8": jnp.int8}[dtype]
    return (JaxDense(dim, capacity_block, dtype=jdt, tile=tile),
            DenseIndex(dim, capacity_block, dtype=dtype, tile=tile,
                       device="cpu"))


def _same(rj, rt, atol=ATOL):
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=atol)


def test_add_search_matches_jax(rng):
    jx, pt = _pair(64, 1024, 256)
    docs = _unit(rng, 500, 64)
    assert pt.add(docs).tolist() == jx.add(docs).tolist() == list(range(500))
    q = _unit(rng, 3, 64)
    _same(jx.search(q, k=5), pt.search(q, k=5))
    np.testing.assert_array_equal(pt.search(q, k=5).ids,
                                  np.argsort(-(q @ docs.T), axis=1)[:, :5])


def test_growth_across_capacity_block(rng):
    jx, pt = _pair(32, 256, 256)
    for _ in range(2):
        rows = _unit(rng, 200, 32)
        jx.add(rows)
        ids = pt.add(rows)
    assert ids[0] == 200 and pt.size == 400 and pt.capacity == jx.capacity
    q = _unit(rng, 1, 32)
    _same(jx.search(q, k=10), pt.search(q, k=10))


def test_delete_and_compact_match_jax(rng):
    jx, pt = _pair(32, 256, 256)
    docs = _unit(rng, 50, 32)
    jx.add(docs)
    pt.add(docs)
    q = docs[7:8]
    assert pt.search(q, k=1).ids[0, 0] == 7
    jx.delete([7])
    pt.delete([7])
    _same(jx.search(q, k=3), pt.search(q, k=3))
    assert 7 not in pt.search(q, k=3).ids
    np.testing.assert_array_equal(pt.compact(), jx.compact())
    assert pt.size == 49 and pt.epoch == jx.epoch
    _same(jx.search(q, k=4), pt.search(q, k=4))


def test_empty_search():
    pt = DenseIndex(16, 256, tile=256, device="cpu")
    res = pt.search(np.ones((2, 16), np.float32), k=4)
    assert (res.ids == -1).all() and np.isneginf(res.scores).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_state_dict_round_trip_both_ways(rng, dtype):
    """A snapshot written by either package loads in the other."""
    jx, pt = _pair(32, 256, 256, dtype)
    docs = _unit(rng, 100, 32)
    jx.add(docs)
    pt.add(docs)
    jx.delete([3])
    pt.delete([3])
    q = _unit(rng, 2, 32)
    from_jax = DenseIndex.from_state_dict(jx.state_dict(), device="cpu")
    from_port = JaxDense.from_state_dict(pt.state_dict())
    assert from_jax.dtype == pt.dtype and from_jax.size == 100
    for src, dst in ((jx, from_jax), (pt, from_port)):    # rows exact
        got, want = dst.state_dict(), src.state_dict()
        if dtype == "int8":             # codes and scales bit for bit
            assert got["embeddings"].dtype == want["embeddings"].dtype
            np.testing.assert_array_equal(got["embeddings"],
                                          want["embeddings"])
            np.testing.assert_array_equal(got["scale"].view(np.int32),
                                          want["scale"].view(np.int32))
        np.testing.assert_array_equal(
            got["embeddings"].astype(np.float32),
            want["embeddings"].astype(np.float32))
        assert (got["tombstones"] == [3]).all()
    _same(jx.search(q, 5), from_jax.search(q, 5))
    _same(pt.search(q, 5), from_port.search(q, 5))


@pytest.mark.parametrize("k", [1, 4, 9])
def test_first_kept_equals_the_row_loop(rng, k):
    """The filter of ``search`` and ``search_tail`` (each row's first k
    kept entries, padded with -inf and -1) against a loop over rows; the
    candidate lists run shorter and longer than k."""
    scores = rng.standard_normal((6, 7)).astype(np.float32)
    ids = rng.integers(-1, 12, (6, 7)).astype(np.int64)
    keep = (ids >= 0) & ~np.isin(ids, [2, 5, 11])
    keep[0] = False
    want_s = np.full((6, k), -np.inf, np.float32)
    want_i = np.full((6, k), -1, np.int64)
    for r in range(6):
        cols = np.flatnonzero(keep[r])[:k]
        want_s[r, :len(cols)] = scores[r, cols]
        want_i[r, :len(cols)] = ids[r, cols]
    got_s, got_i = _first_kept(scores, ids, keep, k)
    assert got_s.dtype == np.float32 and got_i.dtype == np.int64
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_i, want_i)


def test_search_tail(rng):
    jx, pt = _pair(16, 512, 256)
    old, new = (rng.standard_normal((n, 16)).astype(np.float32)
                for n in (300, 80))
    for idx in (jx, pt):
        idx.add(old)
        idx.add(new)
    q = new[:4]
    res = pt.search_tail(q, k=5, from_row=300)
    _same(jx.search_tail(q, k=5, from_row=300), res)
    assert (res.ids[:, 0] == np.arange(300, 304)).all()
    assert (pt.search_tail(q, k=5, from_row=pt.size).ids == -1).all()


def test_bf16_storage_matches_jax_and_f32(rng):
    """bf16 storage: 4x oversampled scan, float32 rescore — same ids as the
    JAX package's bf16 index and as the exact f32 index."""
    docs = _unit(rng, 4096, 64)
    jx, pt = _pair(64, 4096, 256, "bfloat16")
    f32 = DenseIndex(64, 4096, tile=256, device="cpu")
    for idx in (jx, pt, f32):
        idx.add(docs)
    q = _unit(rng, 8, 64)
    got = pt.search(q, k=10)
    _same(jx.search(q, k=10), got)
    np.testing.assert_array_equal(got.ids, f32.search(q, k=10).ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_route_matches_jax_pallas(rng, dtype):
    """``prefer_kernel=True`` on CPU takes the certified path through the
    kernels' twins, as ``prefer_pallas=True`` takes it in interpret mode."""
    jx, pt = _pair(32, 128 * 256, 128, dtype)
    docs = _unit(rng, 128 * 256 - 50, 32)
    docs[1000:1012] = docs[7] + 0.01 * rng.standard_normal((12, 32))
    jx.add(docs)
    pt.add(docs)
    jx.delete([1003])
    pt.delete([1003])
    q = np.concatenate([docs[7:8], _unit(rng, 3, 32)])
    _same(jx.search(q, k=3, prefer_pallas=True),
          pt.search(q, k=3, prefer_kernel=True))


# ------------------------------------------------------------ int8 storage

def _int8_pair(rng, n, dim, capacity_block, tile):
    """A JAX int8 index and the port's, loaded from its snapshot."""
    jx = JaxDense(dim, capacity_block, dtype=jnp.int8, tile=tile)
    jx.add(_unit(rng, n, dim))
    return jx, DenseIndex.from_state_dict(jx.state_dict(), device="cpu")


def test_int8_add_codes_match_jax(rng):
    """Codes after ``add``: at most one step apart in at most 1e-5 of the
    codes (normalisation ulps); scales, a row's max times 1/127, within
    four ulps (a few ulps of normalisation, then one rounding)."""
    docs = rng.standard_normal((8192, 64)).astype(np.float32)
    jx, pt = _pair(64, 4096, 256, "int8")
    jx.add(docs)
    pt.add(docs)
    assert pt.size == jx.size and pt.capacity == jx.capacity
    got, want = pt.state_dict(), jx.state_dict()
    assert got["embeddings"].dtype == np.int8
    step = np.abs(got["embeddings"].astype(np.int32)
                  - want["embeddings"].astype(np.int32))
    assert step.max() <= 1 and (step > 0).sum() <= 1e-5 * step.size
    ulps = np.abs(got["scale"].view(np.int32).astype(np.int64)
                  - want["scale"].view(np.int32))
    assert ulps.max() <= 4


@pytest.mark.parametrize("kernel_route", [False, True])
def test_int8_search_matches_jax(rng, kernel_route):
    """The default route (plain chunked scan) and the kernel route
    (``prefer_kernel=True``: certified int8-native, or K7 below 64*cc
    tiles) against the JAX index with ``prefer_pallas``, on the same
    codes; then the exact f32 index agrees on the top ids."""
    jx, pt = _int8_pair(rng, 128 * 256 - 50, 32, 128 * 256, 128)
    q = np.concatenate([pt.vectors_f32()[7:8].numpy(), _unit(rng, 3, 32)])
    kw_j = {"prefer_pallas": True} if kernel_route else {}
    kw_t = {"prefer_kernel": True} if kernel_route else {}
    for k in (1, 3):                             # cc 4: certified; cc 12: K7
        got = pt.search(q, k=k, **kw_t)
        _same(jx.search(q, k=k, **kw_j), got)
        assert got.ids[0, 0] == 7
        if kernel_route:
            assert got.route == ("certified" if k == 1 else "direct")


def test_int8_delete_and_compact_match_jax(rng):
    jx, pt = _int8_pair(rng, 300, 32, 256, 128)
    q = pt.vectors_f32()[7:8].numpy()
    assert pt.search(q, k=1).ids[0, 0] == 7
    jx.delete([7, 9])
    pt.delete([7, 9])
    assert float(pt.row_scale[7]) == 0.0 and not pt.embeddings()[9].any()
    _same(jx.search(q, k=3), pt.search(q, k=3))
    np.testing.assert_array_equal(pt.compact(), jx.compact())
    assert pt.size == 298 and pt.epoch == jx.epoch
    np.testing.assert_array_equal(pt.state_dict()["scale"],
                                  jx.state_dict()["scale"])
    _same(jx.search(q, k=4), pt.search(q, k=4))


def test_int8_search_tail_matches_jax(rng):
    jx, pt = _int8_pair(rng, 380, 16, 512, 256)
    q = pt.vectors_f32()[300:304].numpy()
    res = pt.search_tail(q, k=5, from_row=300)
    _same(jx.search_tail(q, k=5, from_row=300), res)
    assert (res.ids[:, 0] == np.arange(300, 304)).all()


def test_int8_get_vectors_and_row_scale(rng):
    jx, pt = _int8_pair(rng, 100, 32, 256, 128)
    assert pt.quantized and pt.row_scale.shape == (256,)
    np.testing.assert_array_equal(pt.vectors_f32().numpy(),
                                  np.asarray(jx.vectors_f32()))
    np.testing.assert_array_equal(pt.get([3, 50]).numpy(),
                                  np.asarray(jx.get([3, 50])))
    assert pt.embeddings().dtype == torch.int8
