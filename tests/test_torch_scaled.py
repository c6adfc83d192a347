"""The scaled certified route, the scan floor and the repairs of the third
port slice, against the JAX package on the CPU.

The same numpy inputs go through the JAX functions (Pallas kernels in
interpret mode) and the port's (the kernels' plain twins, which a CPU
tensor selects). Sizes follow ``tests/test_topk_r5.py``: tile 128, D 32-64.

Tolerances:

* K2 (``packed_extract_scaled``): the packed lower bounds within one
  quantisation step, and no word at fault under ``packed_word_faults``
  (each names a live row whose scaled score quantises to its bits within
  1e-5; words may differ only where a row sits on a boundary): both
  frameworks multiply bf16 operands exactly but may sum in another order.
* K5a (``extract_scaled``), K7 on float rows and F (``scan_floor``): columns
  equal, values within 1e-5 (f32 summation order only).
* The scaled certified search: ids and certificate row equal, scores within
  1e-5.
* The int8-native search at D=390 and D=1100 (beyond the 1040 codes whose
  float32 dot is exact): ids, certificate and scores bit for bit, and
  K5b's values; K3's words bit for bit except where XLA's CPU backend
  fuses the last scale multiply with the +2 shift (one rounding instead of
  two, as ``tests/test_torch_int8.py`` records).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import repair_cases as RC

from optimized_rag_tpu.index.dense import DenseIndex as JaxDense
from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu.ops.quantize import quantize_int8 as j_quantize
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import topk_kernels as K

torch.set_num_threads(2)

TILE, GROUPS = 128, 8
ATOL = 1e-5
DEFAULT = jax.lax.Precision.DEFAULT


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, b=8, d=32, tiles=80, k=10):
    """Each query's whole top-k inside one tile (the c2 cover's case)."""
    q = _unit(rng, b, d)
    c = rng.standard_normal((TILE * tiles, d)).astype(np.float32) * 0.1
    for bi in range(b):
        t0 = (bi * 7 + 3) * TILE
        c[t0:t0 + k] = q[bi] + 0.01 * rng.standard_normal((k, d))
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)


def _scaled_corpus(rng, c, kind):
    """The rows and scales of the scaled route: int8 codes with their
    quantisation scales, or float32 rows with arbitrary positive scales."""
    if kind == "int8":
        c8, cs = j_quantize(jnp.asarray(c))
        return np.array(c8), np.array(cs)
    return c, (rng.random(c.shape[0]) * 0.5 + 0.5).astype(np.float32)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _same(jax_out, torch_out, atol=ATOL):
    js, ji = (np.asarray(a) for a in jax_out)
    ts, ti = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)


# --------------------------------------------------- K2, K5a, K7, F twins

@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_packed_scaled_twin_matches_packed_pass(rng, kind):
    q, c = _unit(rng, 8, 64), _unit(rng, TILE * 24, 64)
    c, cs = _scaled_corpus(rng, c, kind)
    size = c.shape[0] - 77
    (wj,) = J._packed_pass(jnp.asarray(q), jnp.asarray(c), size, TILE,
                           GROUPS, True, DEFAULT, row_scale=jnp.asarray(cs))
    wj = torch.from_numpy(np.array(jax.lax.bitcast_convert_type(
        wj, jnp.int32)))
    qt, ct, cst = _t(q, c, cs)
    wt = K.packed_extract_scaled(qt, ct, cst, size, TILE, GROUPS)
    assert wt.dtype == torch.int32 and wt.shape == wj.shape
    lb = (T._unpack_lb(wt, TILE) - T._unpack_lb(wj, TILE)).abs().max()
    assert float(lb) <= 2.0 ** -12
    qb = qt.to(torch.bfloat16).float()
    faults, _ = K.packed_word_faults(qb, ct, size, TILE, wt, wj,
                                     row_scale=cst,
                                     rows_dtype=K.scaled_rows_dtype(ct))
    assert faults == 0


@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_extract_scaled_twin_matches_extract_pass(rng, kind):
    q, c = _clustered(rng, d=64)
    c, cs = _scaled_corpus(rng, c, kind)
    size = c.shape[0] - 100
    tiles = np.array([3, 79, 0, 10, 17], np.int32)
    vj, colj = J._extract_pass(jnp.asarray(q), jnp.asarray(c), size, TILE,
                               10, jnp.asarray(tiles), True, DEFAULT,
                               row_scale=jnp.asarray(cs))
    vt, colt = K.extract_scaled(*_t(q, c, cs), size, TILE, 10,
                                torch.from_numpy(tiles))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=ATOL)


def test_tile_topk_scaled_on_float_rows_matches_tile_pass(rng):
    """K7 on a float corpus with row scales: the rows rounded to bf16."""
    q, c = _unit(rng, 8, 64), _unit(rng, TILE * 16, 64)
    c, cs = _scaled_corpus(rng, c, "float32")
    size = c.shape[0] - 77
    sj, ij = J._tile_pass(jnp.asarray(q), jnp.asarray(c), size, TILE, 10,
                          True, DEFAULT, row_scale=jnp.asarray(cs))
    st, it = K.tile_topk_scaled(*_t(q, c, cs), size, TILE, 10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=ATOL)


def _jax_floor(q, c, tile):
    """The reference's floor kernel, as benchmarks/sweep_r4_kernel.py:128-145
    and benchmarks/sweep_r4c.py:157-180 define and launch it (their module
    level runs a benchmark, so the kernel is restated here), interpreted."""
    def _floor_kernel(q_ref, c_ref, out_ref, *, precision):
        scores = jax.lax.dot_general(
            q_ref[:].astype(c_ref.dtype), c_ref[:],
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32, precision=precision)
        out_ref[0, 0, :] = jnp.max(scores, axis=1)

    (n, d), b = c.shape, q.shape[0]
    return pl.pallas_call(
        functools.partial(_floor_kernel, precision=DEFAULT),
        interpret=True, grid=(n // tile,),
        in_specs=[pl.BlockSpec((b, d), lambda i: (0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((tile, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 1, b), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((n // tile, 1, b), jnp.float32),
    )(q, c)


@pytest.mark.parametrize("tile", [128, 512])
def test_scan_floor_twin_matches_floor_kernel(rng, tile):
    q, c = _unit(rng, 8, 64), _unit(rng, 4096, 64)
    fj = _jax_floor(jnp.asarray(q), jnp.asarray(c).astype(jnp.bfloat16),
                    tile)
    qt = torch.from_numpy(q)
    ft = K.scan_floor(qt, torch.from_numpy(c).to(torch.bfloat16), tile)
    assert ft.shape == fj.shape
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=0,
                               atol=ATOL)


def test_new_wrappers_count_only_launches(rng):
    """A CPU corpus takes the twins of K2, K5a and F and counts nothing;
    any other device must launch or raise."""
    q, c = _unit(rng, 2, 16), _unit(rng, 256, 16)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    cs = torch.ones(256)
    K.reset_launch_counts()
    K.packed_extract_scaled(qt, ct, cs, None, TILE, GROUPS)
    K.extract_scaled(qt, ct, cs, None, TILE, 4, torch.tensor([1]))
    K.scan_floor(qt, ct, TILE)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    qm, cm, csm = qt.to("meta"), ct.to("meta"), cs.to("meta")
    for call in (lambda: K.packed_extract_scaled(qm, cm, csm, None, TILE,
                                                 GROUPS),
                 lambda: K.extract_scaled(qm, cm, csm, None, TILE, 4,
                                          torch.tensor([1])),
                 lambda: K.scan_floor(qm, cm, TILE)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


# ------------------------------------------------ the scaled certified route

def _certified_case(rng, case):
    if case == "random":
        return _unit(rng, 8, 32), _unit(rng, TILE * 40, 32), {}
    if case == "clustered":
        q, c = _clustered(rng)
        return q, c, {"union_tiles": 16}
    if case == "overflow":                       # 8 hot tiles, 2 slots
        q, c = _clustered(rng)
        return q, c, {"union_tiles": 2}
    if case == "padding":
        return _unit(rng, 8, 32), _unit(rng, TILE * 40, 32), {
            "size": TILE * 40 - 77}
    raise ValueError(case)


@pytest.mark.parametrize("kind", ["int8", "float32"])
@pytest.mark.parametrize("case", ["random", "clustered", "overflow",
                                  "padding"])
def test_certified_scaled_matches_jax(rng, case, kind):
    """``int8_native=False`` on int8 codes, and ``row_scale`` on a float
    corpus: K2 scans, c1 rescores bf16 operands times the scale, K5a
    covers."""
    q, c, kw = _certified_case(rng, case)
    c, cs = _scaled_corpus(rng, c, kind)
    sj, pj = J.pallas_topk_certified(jnp.asarray(q), jnp.asarray(c), 10,
                                     tile=TILE, interpret=True,
                                     row_scale=jnp.asarray(cs),
                                     int8_native=False, **kw)
    K.reset_launch_counts()
    st, pt = T.topk_certified(*_t(q, c), 10, tile=TILE,
                              row_scale=torch.from_numpy(cs),
                              int8_native=False, **kw)
    _same((sj, pj), (st, pt))                     # certificate row included
    assert (pt[-1, 0] > 0) == (case == "overflow")


def test_certified_scaled_answers_its_oracle(rng):
    """Certified scaled ids are the exact top-k of bf16(q) x code, summed
    in f32, times the row scale; scores within 1e-5."""
    q, c = _clustered(rng)
    c8, cs = _scaled_corpus(rng, c, "int8")
    qt, c8t, cst = _t(q, c8, cs)
    s, ids = T.topk_certified(qt, c8t, 10, tile=TILE, row_scale=cst,
                              int8_native=False, union_tiles=16)
    assert T.certificate_uncovered(ids) == 0
    ref = (qt.to(torch.bfloat16).float() @ c8t.float().T) * cst
    ref_s, ref_i = torch.sort(ref, dim=1, descending=True, stable=True)
    assert torch.equal(ids[:-1], ref_i[:, :10])
    np.testing.assert_allclose(s.numpy(), ref_s[:, :10].numpy(), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("kind", ["int8", "float32"])
def test_certified_multi_scaled_matches_jax(rng, kind):
    q, c = _unit(rng, 12, 32), _unit(rng, TILE * 16, 32)
    c, cs = _scaled_corpus(rng, c, kind)
    size = c.shape[0] - 77
    sj, pj = J.pallas_topk_certified_multi(
        jnp.asarray(q), jnp.asarray(c), 10, size, sub_batch=4, tile=TILE,
        interpret=True, row_scale=jnp.asarray(cs), int8_native=False)
    st, pt = T.topk_certified_multi(*_t(q, c), 10, size, sub_batch=4,
                                    tile=TILE, row_scale=torch.from_numpy(cs),
                                    int8_native=False)
    _same((sj, pj), (st, pt))
    assert pt.shape == (13, 10) and pt[-1, 0] == 0


def test_dispatch_row_scale_on_float_corpus_routes_like_jax(rng):
    """``row_scale`` on a float corpus: the scaled certified route in both
    packages from 64*k tiles, the scaled tiled search (K7) below."""
    q, c = _clustered(rng, b=16, tiles=256, k=4)
    c, cs = _scaled_corpus(rng, c, "float32")
    jargs, targs = (jnp.asarray(q), jnp.asarray(c), 4), (*_t(q, c), 4)
    sj, pj = J.dispatch_topk(*jargs, prefer_pallas=True, tile=64,
                             defer_certificate=True,
                             row_scale=jnp.asarray(cs))
    st, pt = T.dispatch_topk(*targs, prefer_kernel=True, tile=64,
                             defer_certificate=True,
                             row_scale=torch.from_numpy(cs))
    assert pt.shape == (17, 4)
    _same((sj, pj), (st, pt))
    _same(J.dispatch_topk(*jargs, prefer_pallas=True, tile=256,
                          row_scale=jnp.asarray(cs)),
          T.dispatch_topk(*targs, prefer_kernel=True, tile=256,
                          row_scale=torch.from_numpy(cs)))


# ------------------------------------------------------- repair: tile 4096

@pytest.mark.parametrize("case", ["random", "clustered"])
def test_certified_at_tile_4096_matches_jax(rng, case):
    """The reference's default tile, with few tiles (8 of 4096 rows)."""
    q = _unit(rng, 4, 32)
    c = _unit(rng, 4096 * 8, 32)
    if case == "clustered":
        for bi in range(4):
            t0 = (bi * 2 + 1) * 4096 + 100
            c[t0:t0 + 10] = q[bi] + 0.01 * rng.standard_normal((10, 32))
        c /= np.linalg.norm(c, axis=1, keepdims=True)
    sj, pj = J.pallas_topk_certified(jnp.asarray(q), jnp.asarray(c), 10,
                                     interpret=True)
    st, pt = T.topk_certified(*_t(q, c), 10)
    _same((sj, pj), (st, pt), atol=1e-6)
    assert pt[-1, 0] == 0


# ------------------------------------------------------ repair: float16

@pytest.mark.parametrize("case", ["random", "clustered"])
def test_float16_twins_match_jax(rng, case):
    """K1, K4 and K6 on float16 rows: the queries cast to float16, exact
    products, f32 sums; then the certified search."""
    q, c = ((_unit(rng, 8, 32), _unit(rng, TILE * 40, 32))
            if case == "random" else _clustered(rng))
    qj, cj = jnp.asarray(q), jnp.asarray(c).astype(jnp.float16)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c).to(torch.float16)
    prec = J._resolve_precision(cj, None)
    size = c.shape[0] - 77
    (wj,) = J._packed_pass(qj, cj, size, TILE, GROUPS, True, prec)
    wj = torch.from_numpy(np.array(jax.lax.bitcast_convert_type(
        wj, jnp.int32)))
    wt = K.packed_extract(qt, ct, size, TILE, GROUPS)
    assert K.packed_word_faults(K._scan_queries(qt, ct), ct, size, TILE, wt,
                                wj)[0] == 0
    tiles = np.array([3, 39, 0, 10], np.int32)
    vj, colj = J._extract_pass(qj, cj, size, TILE, 10, jnp.asarray(tiles),
                               True, prec)
    vt, colt = K.extract(qt, ct, size, TILE, 10, torch.from_numpy(tiles))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=ATOL)
    sj, ij = J._tile_pass(qj, cj, size, TILE, 10, True, prec)
    st, it = K.tile_topk(qt, ct, size, TILE, 10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _same(J.pallas_topk_certified(qj, cj, 10, tile=TILE, interpret=True,
                                  union_tiles=16),
          T.topk_certified(qt, ct, 10, tile=TILE, union_tiles=16))


def test_float16_index_matches_jax(rng):
    """A float16 DenseIndex searches as the JAX package's does (k
    candidates, no oversample), and its snapshot loads both ways."""
    jx = JaxDense(32, 256, dtype=jnp.float16, tile=256)
    pt = DenseIndex(32, 256, dtype="float16", tile=256, device="cpu")
    docs = _unit(rng, 300, 32)
    jx.add(docs)
    from_jax = DenseIndex.from_state_dict(jx.state_dict(), device="cpu")
    assert from_jax.dtype == torch.float16
    pt.add(docs)
    state = pt.state_dict()
    assert state["dtype"] == "float16"
    np.testing.assert_array_equal(JaxDense.from_state_dict(state)
                                  .state_dict()["embeddings"],
                                  state["embeddings"])
    q = _unit(rng, 3, 32)
    rj, rt = jx.search(q, 5), from_jax.search(q, 5)
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=0, atol=1e-6)


# ------------------------------------------- repair: int8-native at any D

@pytest.mark.parametrize("d", [390, 1100])
def test_certified_int8_native_at_any_width_matches_jax(rng, d):
    """D=390 (no multiple of 4) and D=1100 (past the 1040 codes whose f32
    dot is exact): ids, certificate and scores bit for bit."""
    q, c = _clustered(rng, b=4, d=d, tiles=32)
    c8, cs = (np.array(v) for v in j_quantize(jnp.asarray(c)))
    sj, pj = J.pallas_topk_certified(jnp.asarray(q), jnp.asarray(c8), 10,
                                     tile=TILE, interpret=True,
                                     row_scale=jnp.asarray(cs),
                                     union_tiles=8)
    st, pt = T.topk_certified(*_t(q, c8), 10, tile=TILE,
                              row_scale=torch.from_numpy(cs), union_tiles=8)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy().view(np.int32),
                                  np.asarray(sj).view(np.int32))
    assert pt[-1, 0] == 0


def test_int8_twins_at_any_width_match_jax(rng):
    """K5b's values bit for bit, and K3's words within one quantisation
    step, at D=1100 (the exact int32 dot exceeds 2**24)."""
    q, c = _clustered(rng, b=2, d=1100, tiles=16)
    c8, cs = (np.array(v) for v in j_quantize(jnp.asarray(c)))
    q8, qs = (np.array(v) for v in j_quantize(jnp.asarray(q)))
    size = c8.shape[0] - 100
    tiles = np.array([3, 15, 0, 10], np.int32)
    jargs = (jnp.asarray(q8), jnp.asarray(c8))
    vj, colj = J._extract_pass(*jargs, size, TILE, 16, jnp.asarray(tiles),
                               True, None, row_scale=jnp.asarray(cs),
                               q_scale=jnp.asarray(qs))
    vt, colt = K.extract_int8(*_t(q8, qs, c8, cs), size, TILE, 16,
                              torch.from_numpy(tiles))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    np.testing.assert_array_equal(vt.numpy().view(np.int32),
                                  np.asarray(vj).view(np.int32))
    (wj,) = J._packed_pass(*jargs, size, TILE, GROUPS, True, None,
                           row_scale=jnp.asarray(cs), q_scale=jnp.asarray(qs))
    wj = np.asarray(jax.lax.bitcast_convert_type(wj, jnp.int32))
    wt = K.packed_extract_int8(*_t(q8, qs, c8, cs), size, TILE, GROUPS)
    assert np.abs(T._unpack_lb(wt, TILE).numpy() - np.asarray(
        J._unpack_lb(jnp.asarray(wj), TILE))).max() <= 2.0 ** -12
    assert (wt.numpy() != wj).mean() <= 0.01


# ------------------------------------- repair: one answer to bad scores

def _bad_row_case(rng):
    q = _unit(rng, 2, 16)
    c = np.concatenate([_unit(rng, TILE * 4 - 1, 16), -3.0 * q[:1]])
    return q, c


@pytest.mark.parametrize("route", ["native", "scaled", "scaled_float"])
def test_row_scale_routes_keep_the_score_precondition(rng, route):
    """The int8 and scaled twins raise on a live score outside (-2, 2), as
    the dense twin does; so do the certified search and the ANN."""
    q, c = _bad_row_case(rng)
    if route == "scaled_float":
        ct, cs = torch.from_numpy(c), torch.ones(c.shape[0])
    else:
        c8, cs = (torch.from_numpy(np.array(v))
                  for v in j_quantize(jnp.asarray(c)))
        ct = c8
    qt = torch.from_numpy(q)
    kw = {"row_scale": cs, "int8_native": route == "native"}
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.topk_certified(qt, ct, 4, tile=TILE, **kw)
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.topk_ann(qt, ct, 4, tile=TILE, row_scale=cs)


def test_flagged_certificate_raises_where_it_is_read(rng, monkeypatch):
    """On the card the scan's range flag turns the certificate to -1: its
    readers raise the twins' ValueError, and a multi-block certificate
    keeps the -1."""
    flag = K.new_flag("cpu")
    assert int(T._certificate_row(torch.tensor(3), flag, 4)[0, 0]) == 3
    flag[0] = 1
    row = T._certificate_row(torch.tensor(3), flag, 4)
    assert row.tolist() == [[-1, 0, 0, 0]]
    ids = torch.cat([torch.zeros((2, 4), dtype=torch.long), row])
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.certificate_uncovered(ids)
    index = DenseIndex(16, 256, tile=128, device="cpu")
    index.add(_unit(rng, 10, 16))
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        index._settle_certificate(torch.zeros(2, 16), torch.zeros(2, 4),
                                  ids.numpy(), 4)
    blocks = iter([(torch.zeros(2, 4), torch.cat([torch.zeros(
        (2, 4), dtype=torch.long), r]), flag,
        T.Cover(torch.zeros((2, 2), dtype=torch.bool), "dense")) for r in (
            torch.tensor([[5, 0, 0, 0]]), row)])
    monkeypatch.setattr(T, "_packed_search", lambda *a, **kw: next(blocks))
    _, ids_m = T.topk_certified_multi(torch.zeros(4, 16),
                                      torch.zeros(256, 16), 4, sub_batch=2,
                                      tile=128)
    assert int(ids_m[-1, 0]) == -1


# ------------------------------------------- repair of a failed certificate

@pytest.mark.parametrize("rows", ["float", "int8"])
def test_scaled_repair_equals_the_rerun(rng, monkeypatch, rows):
    """The scaled route's failed certificate (float rows with a row scale,
    or int8 codes read as scaled) repaired pair by pair, K4p scoring as K5a:
    the K7 rerun's answer bit for bit, deferred and settled, no rerun; and
    the JAX package's, deferred (the same scores and certificate row, ids
    the same or another copy of the row) and settled (rerun there)."""
    tile, k = 64, 2
    q, c = RC.runs_corpus(rng, 16, 32, tile, 128)
    # Float rows: a scale of each row's own value, so copies stay equal.
    c, cs = (_scaled_corpus(rng, c, rows) if rows == "int8"
             else (c, 0.75 + 0.2 * c[:, 0]))
    qt, ct, cst = _t(q, c, cs)
    s, packed, cover = T._certified(qt, ct, k, sub_batch=16, tile=tile,
                                    row_scale=cst, int8_native=False)
    assert T.certificate_uncovered(packed) > 0 and cover.mode == "scaled"
    s_r, i_r = T.tiled_topk(qt, ct, k, tile=tile, row_scale=cst)
    assert not torch.equal(packed[:-1], i_r)
    reruns = []
    real = T.tiled_topk
    monkeypatch.setattr(T, "tiled_topk",
                        lambda *a, **kw: reruns.append(1) or real(*a, **kw))
    s2, i2, pairs, rerun = T.repair_uncovered(qt, ct, k, None, tile, s,
                                              packed[:-1], cover,
                                              row_scale=cst)
    assert not rerun and not reruns and pairs > 0
    assert torch.equal(i2, i_r) and torch.equal(s2, s_r)
    qj, cj, csj = (jnp.asarray(np.array(a)) for a in (q, c, cs))
    if rows == "float":                   # dispatch's scaled route
        s3, i3 = T.dispatch_topk(qt, ct, k, prefer_kernel=True, tile=tile,
                                 row_scale=cst)
        assert not reruns
        assert torch.equal(i3, i_r) and torch.equal(s3, s_r)
        _same(J.dispatch_topk(qj, cj, k, prefer_pallas=True, tile=tile,
                              row_scale=csj), (s3, i3))
        sj, pj = J.dispatch_topk(qj, cj, k, prefer_pallas=True, tile=tile,
                                 defer_certificate=True, row_scale=csj)
    else:                                 # the scaled route over codes
        _same(J.pallas_topk(qj, cj, k, tile=tile, interpret=True,
                            row_scale=csj), (s2, i2))
        sj, pj = J.pallas_topk_certified(qj, cj, k, tile=tile,
                                         interpret=True, row_scale=csj,
                                         int8_native=False)
    sj, pj = np.asarray(sj), np.asarray(pj)
    np.testing.assert_array_equal(packed[-1].numpy(), pj[-1])
    np.testing.assert_allclose(s.numpy(), sj, rtol=0, atol=ATOL)
    rows_t = ct.float().numpy()
    np.testing.assert_array_equal(rows_t[packed[:-1].numpy()],
                                  rows_t[pj[:-1]])
