"""The verified and ANN searches of the PyTorch port against the JAX
package, on the CPU.

Cases follow ``tests/test_ops_topk.py:142-225`` (``pallas_topk_verified``
and ``pallas_topk_verified_batch``) and ``tests/test_topk_r5.py`` (the
ANN path). The same numpy inputs go through the JAX functions (Pallas
kernels in interpret mode) and the port's (the kernels' plain twins).

Tolerances: ids equal, certificate rows equal, scores within 1e-6 (f32
summation order only). ANN scores are exact f32 rescores of the returned
ids.

Recorded divergence (ROADMAP Queue 3): on a corpus too small for the
packed scan (2 * tiles <= k), ``pallas_topk_ann`` asserts, and the port
answers the exact top-k, with id -1 where fewer than k rows exist.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu.ops.quantize import quantize_int8 as j_quantize
from optimized_rag_tpu_torch.ops import topk as T

torch.set_num_threads(2)

TILE = 128
ATOL = 1e-6


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, b=4, d=32, tiles=80, k=10, noise=0.01):
    """Each query's whole top-k inside one tile
    (``tests/test_ops_topk.py:_clustered_case``)."""
    q = _unit(rng, b, d)
    c = rng.standard_normal((TILE * tiles, d)).astype(np.float32) * 0.1
    for bi in range(b):
        t0 = (bi * 7 + 3) * TILE
        c[t0:t0 + k] = q[bi] + noise * rng.standard_normal((k, d))
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)


def _same(jax_out, torch_out, atol=ATOL):
    js, ji = (np.asarray(a) for a in jax_out)
    ts, ti = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)


def _exact_ids(q, c, k, size=None):
    s = q.astype(np.float64) @ c.astype(np.float64).T
    if size is not None:
        s[:, size:] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


# ---------------------------------------------------------------- verified

@pytest.mark.parametrize("case", ["clustered", "padding", "chunked"])
def test_verified_matches_jax(rng, case):
    kw, size = {}, None
    if case == "padding":
        q, c = _unit(rng, 8, 64), _unit(rng, TILE * 40, 64)
        size = TILE * 40 - 77
    else:
        q, c = _clustered(rng, b=8 if case == "chunked" else 4)
        if case == "chunked":            # query chunks under mem_budget
            kw["mem_budget"] = TILE * 10 * 32 * 4 * 2
    qj, cj = jnp.asarray(q), jnp.asarray(c)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    out = T.topk_verified(qt, ct, 10, size, tile=TILE, tile_k=2, **kw)
    _same(J.pallas_topk_verified(qj, cj, 10, size, tile=TILE, tile_k=2,
                                 interpret=True, **kw), out)
    np.testing.assert_array_equal(out[1].numpy(), _exact_ids(q, c, 10, size))


def test_verified_with_tile_k_at_least_k_is_the_tiled_search(rng):
    q, c = _unit(rng, 4, 32), _unit(rng, TILE * 8, 32)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    _same(T.tiled_topk(qt, ct, 4, tile=TILE),
          T.topk_verified(qt, ct, 4, tile=TILE, tile_k=4))


@pytest.mark.parametrize("case,union", [("clustered", 16), ("overflow", 2),
                                        ("padding", 8)])
def test_verified_batch_matches_jax(rng, case, union):
    size = None
    if case == "padding":
        q, c = _unit(rng, 16, 64), _unit(rng, TILE * 40, 64)
        size = TILE * 40 - 77
    else:
        q, c = _clustered(rng, b=8)
    sj, pj = J.pallas_topk_verified_batch(
        jnp.asarray(q), jnp.asarray(c), 10, size, tile=TILE, tile_k=2,
        union_tiles=union, interpret=True)
    st, pt = T.topk_verified_batch(torch.from_numpy(q), torch.from_numpy(c),
                                   10, size, tile=TILE, tile_k=2,
                                   union_tiles=union)
    _same((sj, pj), (st, pt))                     # certificate row included
    if case != "padding":               # 16 random queries may overflow 8
        assert (pt[-1, 0] > 0) == (case == "overflow")
    if pt[-1, 0] == 0:
        np.testing.assert_array_equal(pt[:-1].numpy(),
                                      _exact_ids(q, c, 10, size))


def test_verified_bf16_matches_jax(rng):
    """bf16 rows: the queries cast to bf16, exact products, f32 sums."""
    q, c = _clustered(rng, b=4)
    qj, cj = jnp.asarray(q), jnp.asarray(c).astype(jnp.bfloat16)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c).to(torch.bfloat16)
    _same(J.pallas_topk_verified(qj, cj, 10, tile=TILE, interpret=True),
          T.topk_verified(qt, ct, 10, tile=TILE), atol=1e-5)
    _same(J.pallas_topk_verified_batch(qj, cj, 10, tile=TILE,
                                       union_tiles=16, interpret=True),
          T.topk_verified_batch(qt, ct, 10, tile=TILE, union_tiles=16),
          atol=1e-5)


# --------------------------------------------------------------------- ANN

def _recall(ids, oracle):
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / oracle.shape[1]
                    for a, b in zip(ids, oracle)])


@pytest.mark.parametrize("case", ["random", "clustered"])
def test_ann_matches_jax(rng, case):
    if case == "random":
        q, c = _unit(rng, 8, 64), _unit(rng, TILE * 40, 64)
    else:
        q, c = _clustered(rng, tiles=60, noise=0.02)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    st, it = T.topk_ann(qt, ct, 10, tile=TILE)
    _same(J.pallas_topk_ann(jnp.asarray(q), jnp.asarray(c), 10, tile=TILE,
                            interpret=True), (st, it))
    assert _recall(it.numpy(), _exact_ids(q, c, 10)) >= (
        0.95 if case == "random" else 0.9)
    exact = np.einsum("bd,bkd->bk", q, c[it.numpy()])
    np.testing.assert_allclose(st.numpy(), exact, rtol=0, atol=2e-6)


def test_ann_padding_and_multi_match_jax(rng):
    q, c = _unit(rng, 8, 64), _unit(rng, TILE * 40, 64)
    size = c.shape[0] - 77
    qj, cj = jnp.asarray(q), jnp.asarray(c)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    s, i = T.topk_ann(qt, ct, 10, size, tile=TILE)
    _same(J.pallas_topk_ann(qj, cj, 10, size, tile=TILE, interpret=True),
          (s, i))
    assert int(i.max()) < size
    sm, im = T.topk_ann_multi(qt, ct, 10, size, sub_batch=4, tile=TILE)
    _same(J.pallas_topk_ann_multi(qj, cj, 10, size, sub_batch=4, tile=TILE,
                                  interpret=True), (sm, im))
    assert torch.equal(im, i)


def test_ann_int8_row_scale_matches_jax(rng):
    """An int8 corpus: the int8-native scan and c1 rescore."""
    q, c = _unit(rng, 8, 64), _unit(rng, TILE * 40, 64)
    c8, cs = (np.array(v) for v in j_quantize(jnp.asarray(c)))
    s, i = T.topk_ann(torch.from_numpy(q), torch.from_numpy(c8), 10,
                      tile=TILE, row_scale=torch.from_numpy(cs))
    _same(J.pallas_topk_ann(jnp.asarray(q), jnp.asarray(c8), 10, tile=TILE,
                            interpret=True, row_scale=jnp.asarray(cs)),
          (s, i))
    assert _recall(i.numpy(), _exact_ids(q, c, 10)) >= 0.9


def test_ann_small_corpus_is_exact_with_missing_ids(rng):
    """The recorded divergence: with 2 * tiles <= k the reference asserts;
    the port answers the exact top-k, -1 past the live rows."""
    q, c = _unit(rng, 3, 16), _unit(rng, TILE * 4, 16)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    with pytest.raises(AssertionError):
        J.pallas_topk_ann(jnp.asarray(q), jnp.asarray(c), 10, tile=TILE,
                          interpret=True)
    s, i = T.topk_ann(qt, ct, 10, tile=TILE)
    np.testing.assert_array_equal(i.numpy(), _exact_ids(q, c, 10))
    s, i = T.topk_ann(qt, ct[:8], 10, tile=TILE)
    assert (i[:, 8:] == -1).all() and (i[:, :8] >= 0).all()
    assert (s[:, 8:] <= -1e29).all()
