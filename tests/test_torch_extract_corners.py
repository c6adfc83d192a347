"""The selection twins at their corners, against the JAX package's passes.

K4, K5a, K5b, K6 and K7 are held on the card against their plain twins
(``tests/test_torch_kernels_cuda.py``). Here, on the CPU, those twins are
held against the reference's ``_extract_pass`` and ``_tile_pass`` (Pallas
in interpret mode) where a streaming selection is most easily wrong:

* a tile with fewer live rows than rounds: the tail repeats (-1e30,
  column 0 of the tile);
* a wholly dead tile (every row at or after ``size``);
* rounds equal to the tile;
* exact duplicate rows, inside one tile and either side of a tile border:
  ties go to the lower row.

Ids must be equal, ties and tail included; int8-native values bit for bit,
f32 values within 1e-6 and bf16 or scaled ones within 1e-5 (reduction-order
drift between XLA and torch.matmul).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu_torch.ops import topk_kernels as K
from optimized_rag_tpu_torch.ops.quantize import quantize_int8

torch.set_num_threads(2)

TILE, TILES, B, D = 128, 6, 8, 32
N = TILE * TILES
LISTED = np.array([1, 4, 2, 5, 0], np.int32)   # tiles of the union pass
CORNERS = {                      # (size, rounds)
    "tail": (4 * TILE + 5, 10),  # tile 4: 5 live rows; tile 5 dead
    "dead_tile": (4 * TILE, 10),
    "rounds_eq_tile": (N - 50, TILE),
    "duplicates": (N, 10),
}
ROUTES = ("f32", "bf16", "scaled", "int8")


def _data(seed):
    """Rows clustered around the queries, with exact duplicates: rows
    TILE+5 and TILE+9 aimed at query 0, rows 2*TILE+60 and 2*TILE+61 and
    rows 3*TILE-1 and 3*TILE (a tile border) aimed at query 1."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, D)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((N, D)).astype(np.float32) * 0.1
    for bi in range(B):
        t0 = (bi % TILES) * TILE + 20
        c[t0:t0 + 12] = q[bi] + 0.05 * rng.standard_normal((12, D))
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    for qi, rows in ((0, (TILE + 5, TILE + 9)),
                     (1, (2 * TILE + 60, 2 * TILE + 61)),
                     (1, (3 * TILE - 1, 3 * TILE))):
        row = q[qi] + 0.02 * rng.standard_normal(D).astype(np.float32)
        c[list(rows)] = row / np.linalg.norm(row)
    return q, c


def _operands(route, q, c):
    """(JAX operands and keywords, the port's call) of one route."""
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    if route in ("f32", "bf16"):
        jdt, tdt = ((jnp.float32, torch.float32) if route == "f32"
                    else (jnp.bfloat16, torch.bfloat16))
        cj = jnp.asarray(c).astype(jdt)
        return (jnp.asarray(q), cj, J._resolve_precision(cj, None), {}), (
            qt, ct.to(tdt))
    c8, cs = quantize_int8(ct)
    kw = {"row_scale": jnp.asarray(cs.numpy())}
    if route == "scaled":
        return (jnp.asarray(q), jnp.asarray(c8.numpy()),
                jax.lax.Precision.DEFAULT, kw), (qt, c8, cs)
    q8, qs = quantize_int8(qt)
    kw["q_scale"] = jnp.asarray(qs.numpy())
    return (jnp.asarray(q8.numpy()), jnp.asarray(c8.numpy()), None, kw), (
        q8, qs, c8, cs)


def _same(route, ref, got):
    (vj, ij), (vt, it) = ref, got
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    if route == "int8":
        np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                      np.asarray(vj).view(np.int32))
    else:
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0,
                                   atol=1e-6 if route == "f32" else 1e-5)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("corner", list(CORNERS))
def test_extract_twins_at_corners_match_extract_pass(corner, route):
    """K4 (f32, bf16), K5a (scaled) and K5b (int8) twins."""
    size, rounds = CORNERS[corner]
    q, c = _data(11)
    (qj, cj, prec, kw), port = _operands(route, q, c)
    ref = J._extract_pass(qj, cj, size, TILE, rounds, jnp.asarray(LISTED),
                          True, prec, **kw)
    tiles = torch.from_numpy(LISTED)
    fn = {"f32": K.extract, "bf16": K.extract, "scaled": K.extract_scaled,
          "int8": K.extract_int8}[route]
    v, col = fn(*port, size, TILE, rounds, tiles)
    _same(route, ref, (v, col))
    if corner == "tail":                   # slot 1 is tile 4, 5 live rows
        assert bool((v[1, 5:] == K.NEG_INF).all())
        assert bool((col[1, 5:] == 0).all())
    if corner in ("tail", "dead_tile"):    # slot 3 is tile 5, no live row
        assert bool((v[3] == K.NEG_INF).all()) and bool((col[3] == 0).all())


@pytest.mark.parametrize("route", ("f32", "bf16", "scaled"))
@pytest.mark.parametrize("corner", list(CORNERS))
def test_tile_twins_at_corners_match_tile_pass(corner, route):
    """K6 (f32, bf16) and K7 (scaled) twins, global ids."""
    size, rounds = CORNERS[corner]
    q, c = _data(12)
    (qj, cj, prec, kw), port = _operands(route, q, c)
    ref = J._tile_pass(qj, cj, size, TILE, rounds, True, prec, **kw)
    fn = K.tile_topk_scaled if route == "scaled" else K.tile_topk
    s, i = fn(*port, size, TILE, rounds)
    _same(route, ref, (s, i))
    if corner in ("tail", "dead_tile"):
        assert bool((s[5] == K.NEG_INF).all())
        assert bool((i[5] == 5 * TILE).all())
    if corner == "duplicates":             # the lower twin first
        ids = i.long()
        for lo, hi in ((TILE + 5, TILE + 9), (2 * TILE + 60, 2 * TILE + 61)):
            t = lo // TILE
            for b in range(B):
                col = ids[t, :, b].tolist()
                if hi in col:
                    assert lo in col and col.index(lo) < col.index(hi)
