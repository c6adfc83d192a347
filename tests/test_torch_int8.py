"""int8 corpus storage of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode) and the port's (the kernels' plain twins, which a CPU tensor
selects). Sizes follow ``tests/test_topk_r5.py``: tile 128, D 64.

Tolerances:

* ``quantize_int8``: codes and scales bit for bit.
* K3 (``packed_extract_int8``) and K5b (``extract_int8``): the int8-native
  score is exact in float32, so K5b's values and columns are bit for bit
  the reference's. K3's words are bit for bit the reference's except where
  XLA's CPU backend fuses the last scale multiply with the scan's +2 shift
  into one fused multiply-add (one rounding instead of two): there the
  reference word must equal that fused computation exactly (checked word
  by word), and the port keeps the two roundings the TPU kernel writes.
* K7 (``tile_topk_scaled``) and the plain scans with ``row_scale``: ids
  equal, scores within 1e-6 (float32 summation order only).
* The certified int8-native search: ids and certificate row equal, scores
  bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repair_cases as RC

from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu.ops.quantize import dequantize_int8 as j_dequantize
from optimized_rag_tpu.ops.quantize import quantize_int8 as j_quantize
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import topk_kernels as K
from optimized_rag_tpu_torch.ops.quantize import (
    dequantize_int8, quantize_int8)
from optimized_rag_tpu_torch.ops.similarity import normalize

torch.set_num_threads(2)

ATOL = 1e-6
TILE, GROUPS = 128, 8


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, b=8, d=64, tiles=80, k=10):
    """Each query's whole top-k inside one tile (the c2 cover's case)."""
    q = _unit(rng, b, d)
    c = rng.standard_normal((TILE * tiles, d)).astype(np.float32) * 0.1
    for bi in range(b):
        t0 = (bi * 7 + 3) * TILE
        c[t0:t0 + k] = q[bi] + 0.01 * rng.standard_normal((k, d))
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)


def _jq(x):
    """JAX's codes and scales as numpy."""
    return tuple(np.array(v) for v in j_quantize(jnp.asarray(x)))


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _same(jax_out, torch_out, atol=ATOL):
    js, ji = (np.asarray(a) for a in jax_out)
    ts, ti = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)


# ---------------------------------------------------------------- quantize

def _quantize_cases(rng):
    """100k unit rows, zero rows, and rows whose x * inv lands exactly on
    k + 0.5 (round half to even decides the code)."""
    x = _unit(rng, 100_000, 64)
    x[[5, 777, 99_999]] = 0.0
    m = np.float32(0.5)
    inv = np.float32(127.0) / m
    for r in range(1000, 3000):
        x[r, 0] = m
        x[r, 1:9] = ((np.arange(8) - 4 + 0.5) / inv).astype(np.float32)
    return x


def test_quantize_matches_jax_bit_for_bit(rng):
    x = _quantize_cases(rng)
    j8, js = _jq(x)
    t8, ts = quantize_int8(torch.from_numpy(x))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    halves = np.abs(np.abs(x[1000:3000, 1:9] * np.float32(254.0)) % 1 - 0.5)
    assert (halves == 0).sum() >= 2000     # the ties are really exercised
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  js.view(np.int32))
    assert (ts.numpy()[[5, 777, 99_999]] == 0).all()
    back = dequantize_int8(t8, ts).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(j_dequantize(jnp.asarray(j8), jnp.asarray(js))))


# ------------------------------------------------------------ kernel twins

def _int8_problem(rng, b=8, n_tiles=24, d=64, clustered=False):
    if clustered:
        q, c = _clustered(rng, b=b, d=d, tiles=n_tiles)
    else:
        q, c = _unit(rng, b, d), _unit(rng, TILE * n_tiles, d)
    c8, cs = _jq(c)
    q8, qs = _jq(q)
    return q, c8, cs, q8, qs


def _fused_words(q8, qs, c8, cs, size, t, b):
    """K3's two words of tile t for query b, the last scale multiply and
    the +2 shift rounded once (a fused multiply-add), as XLA's CPU backend
    compiles the reference. The product of two float32 values is exact in
    float64, and so is the sum with 2 at these magnitudes."""
    rows = np.arange(t * TILE, (t + 1) * TILE)
    raw = (c8[rows].astype(np.int64) @ q8[b].astype(np.int64)).astype(
        np.float32)
    a = raw * cs[rows]
    sh = (a.astype(np.float64) * np.float64(qs[b]) + 2.0).astype(np.float32)
    sh = np.where(rows < size, np.maximum(sh, np.float32(0)), np.float32(0))
    packed = (sh.view(np.int32) & -TILE) | np.arange(TILE, dtype=np.int32)
    gw = packed.reshape(GROUPS, TILE // GROUPS).max(axis=0)
    w0 = gw.max()
    return w0, np.where(gw == w0, 0, gw).max()


@pytest.mark.parametrize("size_cut", [0, 77])
def test_packed_int8_twin_matches_packed_pass(rng, size_cut):
    q, c8, cs, q8, qs = _int8_problem(rng)
    size = c8.shape[0] - size_cut
    (wj,) = J._packed_pass(jnp.asarray(q8), jnp.asarray(c8), size, TILE,
                           GROUPS, True, None, row_scale=jnp.asarray(cs),
                           q_scale=jnp.asarray(qs))
    wj = np.asarray(jax.lax.bitcast_convert_type(wj, jnp.int32))
    wt = K.packed_extract_int8(*_t(q8, qs, c8, cs), size, TILE, GROUPS)
    assert wt.dtype == torch.int32 and wt.shape == wj.shape
    differ = np.argwhere(wt.numpy() != wj)
    assert len(differ) <= wj.size // 100
    for t, r, b in differ:                     # each one the fused rounding
        assert wj[t, r, b] == _fused_words(q8, qs, c8, cs, size, t, b)[r]
    # Each port word's value bits are the two-rounding score of the row its
    # column names, and the best word is each query's best live row.
    q8t, qst, c8t, cst = _t(q8, qs, c8, cs)
    s = ((q8t.float() @ c8t.float().T) * cst) * qst[:, None]       # [B, N]
    rows = (torch.arange(wt.shape[0])[:, None, None] * TILE
            + (wt & (TILE - 1)).long())
    named = s.T[rows, torch.arange(wt.shape[2])]                   # [T, 2, B]
    live = (wt & -TILE) != 0
    assert bool((rows[live] < size).all())
    assert torch.equal(wt[live] & -TILE, (named[live] + 2.0).clamp_min(
        0.0).view(torch.int32) & -TILE)
    best = s[:, :size].max(dim=1).values
    assert torch.equal(T._unpack_lb(wt, TILE).amax(dim=(0, 1)), (
        (best + 2.0).view(torch.int32) & -TILE).view(torch.float32) - 2.0)


@pytest.mark.parametrize("rounds", [10, 64])
def test_extract_int8_twin_matches_extract_pass(rng, rounds):
    q, c8, cs, q8, qs = _int8_problem(rng, n_tiles=80, clustered=True)
    size = c8.shape[0] - 100
    tiles = np.array([3, 79, 0, 10, 17], np.int32)
    vj, colj = J._extract_pass(jnp.asarray(q8), jnp.asarray(c8), size, TILE,
                               rounds, jnp.asarray(tiles), True, None,
                               row_scale=jnp.asarray(cs),
                               q_scale=jnp.asarray(qs))
    vt, colt = K.extract_int8(*_t(q8, qs, c8, cs), size, TILE, rounds,
                              torch.from_numpy(tiles))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                  np.asarray(vj).view(np.int32))


def test_tile_topk_scaled_twin_matches_tile_pass(rng):
    q, c8, cs, _, _ = _int8_problem(rng, n_tiles=16)
    c8[300:310] = c8[5]                       # exact ties across tiles
    cs[300:310] = cs[5]
    size = c8.shape[0] - 77
    sj, ij = J._tile_pass(jnp.asarray(q), jnp.asarray(c8), size, TILE, 10,
                          True, jax.lax.Precision.DEFAULT,
                          row_scale=jnp.asarray(cs))
    st, it = K.tile_topk_scaled(*_t(q, c8, cs), size, TILE, 10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0,
                               atol=1e-5)


def test_int8_wrappers_count_only_launches(rng):
    """A CPU corpus takes the twins and counts nothing; any other device
    must launch or raise."""
    q, c8, cs, q8, qs = _int8_problem(rng, b=2, n_tiles=2)
    K.reset_launch_counts()
    args = _t(q8, qs, c8, cs)
    K.packed_extract_int8(*args, None, TILE, GROUPS)
    K.extract_int8(*args, None, TILE, 4, torch.tensor([1]))
    K.tile_topk_scaled(*_t(q, c8, cs), None, TILE, 4)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    meta = [a.to("meta") for a in args]
    for call in (lambda: K.packed_extract_int8(*meta, None, TILE, GROUPS),
                 lambda: K.extract_int8(*meta, None, TILE, 4,
                                        torch.tensor([1])),
                 lambda: K.tile_topk_scaled(torch.zeros(2, 64, device="meta"),
                                            meta[2], meta[3], None, TILE, 4)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


# ------------------------------------------------------ the top-k functions

@pytest.mark.parametrize("size", [None, 4096 - 100])
def test_exact_topk_row_scale(rng, size):
    q, c8, cs, _, _ = _int8_problem(rng, n_tiles=32)
    _same(J.exact_topk(jnp.asarray(q), jnp.asarray(c8), 10, size,
                       row_scale=jnp.asarray(cs)),
          T.exact_topk(*_t(q, c8), 10, size, row_scale=torch.from_numpy(cs)))


@pytest.mark.parametrize("n,chunk", [(4096, 1024), (4096 + 300, 1024),
                                     (2048, 700)])
def test_chunked_topk_row_scale(rng, n, chunk):
    q, c = _unit(rng, 4, 32), _unit(rng, n, 32)
    c8, cs = _jq(c)
    _same(J.chunked_topk(jnp.asarray(q), jnp.asarray(c8), 10, chunk=chunk,
                         row_scale=jnp.asarray(cs)),
          T.chunked_topk(*_t(q, c8), 10, chunk=chunk,
                         row_scale=torch.from_numpy(cs)))


def test_rescore_topk_row_scale(rng):
    q, c8, cs, _, _ = _int8_problem(rng, b=6, n_tiles=16)
    cand = rng.integers(0, c8.shape[0], (6, 40)).astype(np.int32)
    cand[:, -3:] = -1
    _same(J.rescore_topk(jnp.asarray(q), jnp.asarray(c8), jnp.asarray(cand),
                         10, row_scale=jnp.asarray(cs)),
          T.rescore_topk(*_t(q, c8, cand), 10,
                         row_scale=torch.from_numpy(cs)))


@pytest.mark.parametrize("size", [None, 128 * 24 - 77])
def test_tiled_topk_row_scale(rng, size):
    q, c8, cs, _, _ = _int8_problem(rng)
    _same(J.pallas_topk(jnp.asarray(q), jnp.asarray(c8), 10, size,
                        tile=TILE, interpret=True, row_scale=jnp.asarray(cs)),
          T.tiled_topk(*_t(q, c8), 10, size, tile=TILE,
                       row_scale=torch.from_numpy(cs)), atol=1e-5)


@pytest.mark.parametrize("case", ["random", "clustered", "overflow",
                                  "padding"])
def test_certified_int8_native_matches_jax(rng, case):
    q, c8, cs, _, _ = _int8_problem(rng, n_tiles=40 if case != "clustered"
                                    and case != "overflow" else 80,
                                    clustered=case in ("clustered",
                                                       "overflow"))
    kw = {"clustered": {"union_tiles": 16}, "overflow": {"union_tiles": 2},
          "padding": {"size": c8.shape[0] - 77}}.get(case, {})
    sj, pj = J.pallas_topk_certified(jnp.asarray(q), jnp.asarray(c8), 10,
                                     tile=TILE, interpret=True,
                                     row_scale=jnp.asarray(cs), **kw)
    st, pt = T.topk_certified(*_t(q, c8), 10, tile=TILE,
                              row_scale=torch.from_numpy(cs), **kw)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert (pt[-1, 0] > 0) == (case == "overflow")


def test_certified_int8_answers_the_int8_native_oracle(rng):
    """Certified ids and scores are the exact int8-native top-k: the code
    dot as a float32 product, then * row scale, then * query scale."""
    q, c8, cs, q8, qs = _int8_problem(rng, n_tiles=80, clustered=True)
    q8t, qst, c8t, cst = _t(q8, qs, c8, cs)
    s, ids = T.topk_certified(torch.from_numpy(q), c8t, 10, tile=TILE,
                              row_scale=cst)
    assert T.certificate_uncovered(ids) == 0
    ref = ((q8t.float() @ c8t.float().T) * cst) * qst[:, None]
    ref_s, ref_i = torch.sort(ref, dim=1, descending=True, stable=True)
    assert torch.equal(ids[:-1], ref_i[:, :10])
    assert torch.equal(s, ref_s[:, :10])


def test_certified_multi_int8_matches_jax(rng):
    q, c8, cs, _, _ = _int8_problem(rng, b=12, n_tiles=16)
    size = c8.shape[0] - 77
    sj, pj = J.pallas_topk_certified_multi(
        jnp.asarray(q), jnp.asarray(c8), 10, size, sub_batch=4, tile=TILE,
        interpret=True, row_scale=jnp.asarray(cs))
    st, pt = T.topk_certified_multi(*_t(q, c8), 10, size, sub_batch=4,
                                    tile=TILE, row_scale=torch.from_numpy(cs))
    _same((sj, pj), (st, pt), atol=0.0)
    assert pt.shape == (13, 10) and pt[-1, 0] == 0


def test_dispatch_row_scale_routes_like_jax(rng):
    """64*k tiles and more: certified int8-native in both packages (the
    certificate deferred); fewer: the tiled K7 search."""
    q, c = _clustered(rng, b=16, d=32, tiles=256, k=4)
    c8, cs = _jq(c)
    jargs = (jnp.asarray(q), jnp.asarray(c8), 4)
    targs = (*_t(q, c8), 4)
    sj, pj = J.dispatch_topk(*jargs, prefer_pallas=True, tile=64,
                             defer_certificate=True,
                             row_scale=jnp.asarray(cs))
    K.reset_launch_counts()
    st, pt = T.dispatch_topk(*targs, prefer_kernel=True, tile=64,
                             defer_certificate=True,
                             row_scale=torch.from_numpy(cs))
    assert pt.shape == (17, 4)
    _same((sj, pj), (st, pt), atol=0.0)
    _same(J.dispatch_topk(*jargs, prefer_pallas=True, tile=256,
                          row_scale=jnp.asarray(cs)),
          T.dispatch_topk(*targs, prefer_kernel=True, tile=256,
                          row_scale=torch.from_numpy(cs)), atol=1e-5)
    _same(J.dispatch_topk(*jargs, prefer_pallas=False,
                          row_scale=jnp.asarray(cs)),
          T.dispatch_topk(*targs, row_scale=torch.from_numpy(cs)))


# ------------------------------------------- repair of a failed certificate

def _native_oracle(qt, c8, cs, k):
    """The exact top-k of the int8-native score, ties to the lower row."""
    q8, qs = quantize_int8(qt)
    return T._topk((K.int8_dot(q8, c8).float() * cs[None, :]) * qs[:, None],
                   k)


@pytest.mark.parametrize("path", ["deferred", "crossover", "settled",
                                  "index"])
def test_int8_native_repair_is_the_native_answer(rng, monkeypatch, path):
    """The int8-native route's failed certificate repaired pair by pair (K4p
    scoring as K5b) is the exact top-k of the int8-native score, bit for
    bit, with no K7 rerun (K7 scores another function, the one the JAX
    package reruns): below the crossover, and past it ("crossover", every
    pair named), where the whole search reruns as K4p over every pair;
    through DenseIndex, that candidate set rescored in float32."""
    tile, k = 64, 1
    q, c = RC.runs_corpus(rng, 16, 32, tile, 256)
    qt = normalize(torch.from_numpy(q))   # as DenseIndex.search has them
    c8, cs = quantize_int8(torch.from_numpy(c))
    reruns = []
    real = T.tiled_topk
    monkeypatch.setattr(T, "tiled_topk",
                        lambda *a, **kw: reruns.append(1) or real(*a, **kw))
    cc = 4 * k                            # DenseIndex's int8 oversampling
    o_s, o_i = _native_oracle(qt, c8, cs, cc)
    if path == "index":
        index = DenseIndex(32, capacity_block=len(c), dtype="int8",
                           tile=tile, device="cpu")
        index.add(c)
        got = index.search(q, k, prefer_kernel=True)
        assert got.route == "fallback"
        w_s, w_i = T.rescore_topk(qt, index.embeddings(), o_i, k,
                                  row_scale=index.row_scale)
        np.testing.assert_array_equal(got.ids, w_i.numpy())
        np.testing.assert_array_equal(got.scores, w_s.numpy())
    elif path == "settled":
        s, i = T.dispatch_topk(qt, c8, cc, prefer_kernel=True, tile=tile,
                               row_scale=cs)
        assert torch.equal(i, o_i) and torch.equal(s, o_s)
    else:
        s, packed, cover = T.dispatch_deferred(qt, c8, cc, prefer_kernel=True,
                                               tile=tile, row_scale=cs)
        assert T.certificate_uncovered(packed) > 0
        assert cover.mode == "native"
        assert not torch.equal(packed[:-1], o_i)
        if path == "crossover":
            cover = T.Cover(torch.ones_like(cover.need), "native")
        s2, i2, pairs, rerun = T.repair_uncovered(
            qt, c8, cc, None, tile, s, packed[:-1], cover, row_scale=cs)
        assert rerun == (path == "crossover") and pairs > 0
        assert torch.equal(i2, o_i) and torch.equal(s2, o_s)
    assert not reruns
