"""Top-k of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs go through the JAX function (Pallas kernels in
interpret mode) and its port counterpart (the kernels' plain twins, which a
CPU tensor selects). Both score in float32 with products exact for bf16
operands, so ids must match exactly, ties included (lowest index first);
scores agree to 1e-6 (f32, reduction-order drift only) or 1e-5 for bf16
corpora, where the two frameworks round the query cast alike but may sum
in another order. The CUDA kernels themselves are held against these twins
on the card by ``tests/test_torch_kernels_cuda.py``.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile

import repair_cases as RC
from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu_torch.index import dense
from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import topk_kernels as K
from optimized_rag_tpu_torch.utils import profiling

torch.set_num_threads(2)

F32_ATOL = 1e-6
BF16_ATOL = 1e-5
DTYPES = [(jnp.float32, torch.float32, F32_ATOL),
          (jnp.bfloat16, torch.bfloat16, BF16_ATOL)]


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, b=8, d=32, tile=128, tiles=80, k=10):
    """Each query's whole top-k inside one tile (contiguous same-document
    chunks): the case the c2 cover exists for."""
    n = tile * tiles
    q = _unit(rng, b, d)
    c = rng.standard_normal((n, d)).astype(np.float32) * 0.1
    for bi in range(b):
        t0 = (bi * 7 + 3) * tile
        c[t0:t0 + k] = q[bi] + 0.01 * rng.standard_normal((k, d))
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)


def _pair(q, c, jdt=jnp.float32, tdt=torch.float32):
    return ((jnp.asarray(q), jnp.asarray(c).astype(jdt)),
            (torch.from_numpy(q), torch.from_numpy(c).to(tdt)))


def _same(jax_out, torch_out, atol=F32_ATOL):
    js, ji = (np.asarray(a) for a in jax_out)
    ts, ti = (a.numpy() for a in torch_out)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(ts, js, rtol=0, atol=atol)


# ------------------------------------------------------ kernels' plain twins

@pytest.mark.parametrize("jdt,tdt,atol", DTYPES)
def test_packed_twin_matches_packed_pass(rng, jdt, tdt, atol):
    q, c = _unit(rng, 8, 64), _unit(rng, 128 * 24, 64)
    size = c.shape[0] - 77
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    (wj,) = J._packed_pass(qj, cj, size, 128, 8, True,
                           J._resolve_precision(cj, None))
    wj = np.asarray(jax.lax.bitcast_convert_type(wj, jnp.int32))
    wt = K.packed_extract(qt, ct, size, 128, 8)
    lb_j = np.asarray(J._unpack_lb(jnp.asarray(wj), 128))
    lb_t = T._unpack_lb(wt, 128).numpy()
    # Within one quantisation step (2**-12 on (2, 4)); packed bits equal.
    assert np.abs(lb_j - lb_t).max() <= 2.0 ** -12
    np.testing.assert_array_equal(wt.numpy(), wj)


def _mutate_column(w, tile):
    w[3, 0, 2] ^= 5                     # another row of the same tile
    return 1


def _mutate_value(w, tile):
    w[3, 1, 4] += 2 * tile              # two quantisation steps higher
    return 1


def _mutate_past_size(w, tile):
    w[-1, 0, 0] = (w[-1, 0, 0] & -tile) | (tile - 1)   # a padding row
    return 1


def _mutate_nothing(w, tile):
    return 0


@pytest.mark.parametrize("mutate", [_mutate_nothing, _mutate_column,
                                    _mutate_value, _mutate_past_size])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_packed_word_faults_catch_wrong_columns_and_values(rng, tdt, mutate):
    """The check that holds the CUDA K1 against its twin on the card: a
    word naming the wrong row, or a value two steps off, is a fault; JAX's own
    words agree with the twin's with no fault and no boundary exemption."""
    q, c = _unit(rng, 8, 64), _unit(rng, 128 * 24, 64)
    size = c.shape[0] - 77
    (qj, cj), (qt, ct) = _pair(q, c, jnp.float32 if tdt == torch.float32
                               else jnp.bfloat16, tdt)
    (wj,) = J._packed_pass(qj, cj, size, 128, 8, True,
                           J._resolve_precision(cj, None))
    wj = torch.from_numpy(np.array(jax.lax.bitcast_convert_type(wj,
                                                                jnp.int32)))
    qs = K._scan_queries(qt, ct)
    ref = K.packed_extract(qt, ct, size, 128, 8)
    want = mutate(wj, 128)
    assert K.packed_word_faults(qs, ct, size, 128, wj, ref) == (want, 0)


def test_packed_word_faults_exempt_only_boundary_rows(rng):
    """A word that names another live row of its tile passes only where
    the two rows' scores straddle a quantisation boundary (here: a drift
    of 1.0 puts every row on one), and is then counted as such."""
    q, c = _unit(rng, 4, 32), _unit(rng, 128 * 8, 32)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    ref = K.packed_extract(qt, ct, None, 128, 8)
    w = ref.clone()
    w[2, 0, 1] ^= 5
    assert K.packed_word_faults(qt, ct, None, 128, w, ref)[0] == 1
    assert K.packed_word_faults(qt, ct, None, 128, w, ref,
                                drift=1.0) == (0, 1)


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES)
def test_extract_twin_matches_extract_pass(rng, jdt, tdt, atol):
    q, c = _clustered(rng)
    size = c.shape[0] - 100                      # the last tile is partial
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    tiles = np.array([3, 79, 0, 10, 17], np.int32)
    vj, colj = J._extract_pass(qj, cj, size, 128, 10, jnp.asarray(tiles),
                               True, J._resolve_precision(cj, None))
    vt, colt = K.extract(qt, ct, size, 128, 10, torch.from_numpy(tiles))
    np.testing.assert_array_equal(colt.numpy(), np.asarray(colj))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=atol)


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES)
def test_tile_twin_matches_tile_pass(rng, jdt, tdt, atol):
    q, c = _unit(rng, 8, 64), _unit(rng, 128 * 16, 64)
    c[300:310] = c[5]                            # exact ties across tiles
    size = c.shape[0] - 77
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    sj, ij = J._tile_pass(qj, cj, size, 128, 10, True,
                          J._resolve_precision(cj, None))
    st, it = K.tile_topk(qt, ct, size, 128, 10)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=atol)


def test_twins_keep_the_score_precondition(rng):
    q = _unit(rng, 2, 16)
    c = np.concatenate([_unit(rng, 127, 16), -3.0 * q[:1]])  # score -3
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        K.packed_extract(qt, ct, None, 128, 8)
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        K.extract(qt, ct, None, 128, 4, torch.tensor([0]))


def test_wrappers_launch_or_raise_off_cpu(rng):
    """Only a CPU tensor takes the twin; any other device must launch a
    kernel or raise, and the twins never count as launches."""
    K.reset_launch_counts()
    q = torch.from_numpy(_unit(rng, 2, 16))
    c = torch.from_numpy(_unit(rng, 256, 16))
    K.packed_extract(q, c, None, 128, 8)
    K.extract(q, c, None, 128, 4, torch.tensor([1]))
    K.tile_topk(q, c, None, 128, 4)
    assert K.launch_counts() == dict.fromkeys(K.KERNELS, 0)
    qm, cm = q.to("meta"), c.to("meta")
    for call in (lambda: K.packed_extract(qm, cm, None, 128, 8),
                 lambda: K.extract(qm, cm, None, 128, 4, torch.tensor([1])),
                 lambda: K.tile_topk(qm, cm, None, 128, 4)):
        with pytest.raises(ValueError, match="no kernel"):
            call()


# ------------------------------------------------------------- exact scans

@pytest.mark.parametrize("size", [None, 4096 - 100])
def test_exact_topk(rng, size):
    q, c = _unit(rng, 8, 128), _unit(rng, 4096, 128)
    (qj, cj), (qt, ct) = _pair(q, c)
    _same(J.exact_topk(qj, cj, 10, size), T.exact_topk(qt, ct, 10, size))


@pytest.mark.parametrize("n,size", [(4096, None), (4096 + 300, None),
                                    (1000, None), (4096, 4096 - 77)])
def test_chunked_topk(rng, n, size):
    q, c = _unit(rng, 4, 32), _unit(rng, n, 32)
    (qj, cj), (qt, ct) = _pair(q, c)
    _same(J.chunked_topk(qj, cj, 10, size, chunk=1024),
          T.chunked_topk(qt, ct, 10, size, chunk=1024))


def test_duplicate_rows_tie_to_lowest_index(rng):
    """Exact duplicates tie exactly: every path returns the lower ids
    first, as lax.top_k does. The JAX certified path orders ties across
    tiles by candidate rank (row 2000 before rows 0-5 here); the port's
    returns the same rows and scores in exact_topk's order."""
    q, c = _unit(rng, 4, 32), _unit(rng, 128 * 20, 32)
    for bi in range(4):
        c[bi * 300:bi * 300 + 6] = q[bi]         # six identical rows
        c[2000 + bi] = q[bi]
    (qj, cj), (qt, ct) = _pair(q, c)
    exact = J.exact_topk(qj, cj, 8)
    _same(exact, T.exact_topk(qt, ct, 8))
    _same(J.chunked_topk(qj, cj, 8, chunk=512),
          T.chunked_topk(qt, ct, 8, chunk=512))
    _same(J.pallas_topk(qj, cj, 8, tile=128, interpret=True),
          T.tiled_topk(qt, ct, 8, tile=128))
    s, ids = T.topk_certified(qt, ct, 8, tile=128)
    assert T.certificate_uncovered(ids) == 0
    _same(exact, (s, ids[:-1]))
    js, ji = J.pallas_topk_certified(qj, cj, 8, tile=128, interpret=True)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_array_equal(np.sort(ids.numpy(), axis=1),
                                  np.sort(np.asarray(ji), axis=1))


def test_certified_and_rescore_break_cross_tile_ties_by_row(rng):
    """Exact ties between rows of different tiles, met in candidate order
    (the higher row ranks first in the packed scan), come out lower row
    first from topk_certified and rescore_topk."""
    q, c = _unit(rng, 2, 32), _unit(rng, 128 * 80, 32)
    for bi in range(2):
        c[700 + bi] = q[bi]                      # tile 5, column 60
        c[9000 + 120 + bi] = q[bi]               # tile 71, column 120
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    s, ids = T.topk_certified(qt, ct, 4, tile=128)
    assert T.certificate_uncovered(ids) == 0
    _same(J.exact_topk(jnp.asarray(q), jnp.asarray(c), 4), (s, ids[:-1]))
    cand = torch.tensor([[9120, 5, 700, 6], [9121, 701, 7, 8]])
    rs, ri = T.rescore_topk(qt, ct, cand, 2)
    assert ri.tolist() == [[700, 9120], [701, 9121]]
    assert float((rs - 1.0).abs().max()) <= F32_ATOL


# --------------------------------------------------------- tiled search

@pytest.mark.parametrize("k,size,tile_k", [(1, None, None), (10, None, None),
                                           (10, 4096 - 77, None),
                                           (10, None, 2)])
def test_tiled_topk(rng, k, size, tile_k):
    q, c = _clustered(rng, b=4, tiles=32) if tile_k else (
        _unit(rng, 8, 64), _unit(rng, 4096, 64))
    (qj, cj), (qt, ct) = _pair(q, c)
    _same(J.pallas_topk(qj, cj, k, size, tile=128, tile_k=tile_k,
                        interpret=True),
          T.tiled_topk(qt, ct, k, size, tile=128, tile_k=tile_k))


# ------------------------------------------------------ certified search

def _certified_case(rng, case):
    if case == "random":
        return _unit(rng, 8, 64), _unit(rng, 128 * 40, 64), {}
    if case == "clustered":
        q, c = _clustered(rng)
        return q, c, {"union_tiles": 16}
    if case == "overflow":                       # 8 hot tiles, 2 slots
        q, c = _clustered(rng)
        return q, c, {"union_tiles": 2}
    if case == "padding":
        return _unit(rng, 8, 64), _unit(rng, 128 * 40, 64), {
            "size": 128 * 40 - 77}
    if case == "negative":                       # every score below 0
        q = _unit(rng, 4, 32)
        base = rng.standard_normal((128 * 20, 32)).astype(np.float32)
        for bi in range(4):
            base -= 0.5 * np.abs(base @ q[bi])[:, None] * q[bi]
        return q, base / np.linalg.norm(base, axis=1, keepdims=True), {}
    if case == "single_unit":                    # all k in one strided unit
        tile, groups, d = 128, 8, 32
        small = tile // groups
        q = _unit(rng, 4, d)
        c = rng.standard_normal((tile * 60, d)).astype(np.float32) * 0.1
        for bi in range(4):
            t0 = (bi * 5 + 2) * tile
            for rank, g in enumerate(range(groups)):
                c[t0 + 3 + g * small] = (q[bi] * (1.0 - 0.001 * rank)
                                         + 0.001 * rng.standard_normal(d))
        return q, c / np.linalg.norm(c, axis=1, keepdims=True), {}
    raise ValueError(case)


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES)
@pytest.mark.parametrize("case", ["random", "clustered", "overflow",
                                  "padding", "negative", "single_unit"])
def test_certified_matches_jax(rng, case, jdt, tdt, atol):
    q, c, kw = _certified_case(rng, case)
    k = 8 if case == "single_unit" else 10
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    sj, pj = J.pallas_topk_certified(qj, cj, k, tile=128, interpret=True,
                                     **kw)
    st, pt = T.topk_certified(qt, ct, k, tile=128, **kw)
    _same((sj, pj), (st, pt), atol)               # certificate row included
    if case == "overflow":
        assert pt[-1, 0] > 0
    else:
        assert pt[-1, 0] == 0


def test_certified_multi_matches_jax(rng):
    q, c = _unit(rng, 12, 64), _unit(rng, 128 * 16, 64)
    size = 128 * 16 - 77
    (qj, cj), (qt, ct) = _pair(q, c)
    sj, pj = J.pallas_topk_certified_multi(qj, cj, 10, size, sub_batch=4,
                                           tile=128, interpret=True)
    st, pt = T.topk_certified_multi(qt, ct, 10, size, sub_batch=4, tile=128)
    _same((sj, pj), (st, pt))
    assert pt.shape == (13, 10) and pt[-1, 0] == 0


@pytest.mark.parametrize("jdt,tdt,atol", DTYPES)
def test_rescore_topk_matches_jax(rng, jdt, tdt, atol):
    q, c = _unit(rng, 6, 64), _unit(rng, 2048, 64)
    cand = rng.integers(0, 2048, (6, 40)).astype(np.int32)
    cand[:, -3:] = -1                            # missing candidates
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    _same(J.rescore_topk(qj, cj, jnp.asarray(cand), 10),
          T.rescore_topk(qt, ct, torch.from_numpy(cand), 10), F32_ATOL)


# ------------------------------------------------------------ dispatch

def test_dispatch_routes_certified_and_matches_jax(rng):
    """64*k tiles and more take the certified path in both packages, with
    the certificate deferred or settled."""
    q, c = _clustered(rng, b=16, tile=64, tiles=256, k=4)
    (qj, cj), (qt, ct) = _pair(q, c)
    K.reset_launch_counts()
    _same(J.dispatch_topk(qj, cj, 4, prefer_pallas=True, tile=64),
          T.dispatch_topk(qt, ct, 4, prefer_kernel=True, tile=64))
    sj, pj = J.dispatch_topk(qj, cj, 4, prefer_pallas=True, tile=64,
                             defer_certificate=True)
    st, pt = T.dispatch_topk(qt, ct, 4, prefer_kernel=True, tile=64,
                             defer_certificate=True)
    assert pt.shape == (17, 4)
    _same((sj, pj), (st, pt))


def test_dispatch_small_corpus_goes_tiled(rng, monkeypatch):
    calls = []
    monkeypatch.setattr(T, "_certified",
                        lambda *a, **kw: calls.append("certified"))
    q, c = _unit(rng, 4, 32), _unit(rng, 128 * 20, 32)
    (qj, cj), (qt, ct) = _pair(q, c)
    _same(J.dispatch_topk(qj, cj, 10, prefer_pallas=True, tile=128),
          T.dispatch_topk(qt, ct, 10, prefer_kernel=True, tile=128))
    assert not calls


def test_dispatch_default_route_on_cpu_is_plain(rng):
    q, c = _unit(rng, 3, 8), _unit(rng, 2048 + 300, 8)
    (qj, cj), (qt, ct) = _pair(q, c)
    _same(J.dispatch_topk(qj, cj, 5, prefer_pallas=False, chunk=1024),
          T.dispatch_topk(qt, ct, 5, chunk=1024))
    _same(J.dispatch_topk(qj, cj, 5), T.dispatch_topk(qt, ct, 5))


def test_dispatch_pads_large_batches_by_repeating_query0(monkeypatch):
    calls = {}

    def fake(name):
        def _f(q, c, k, size=None, **kw):
            calls[name] = (tuple(q.shape), kw.get("sub_batch"),
                           bool((q[-1] == q[0]).all()))
            return (torch.zeros((q.shape[0], k)),
                    torch.zeros((q.shape[0] + 1, k), dtype=torch.long),
                    T.Cover(torch.zeros((q.shape[0], 1), dtype=torch.bool),
                            "dense"))
        return _f

    monkeypatch.setattr(T, "_certified", fake("certified"))
    c = torch.zeros((2560, 8))
    q = torch.arange(1030 * 8, dtype=torch.float32).reshape(1030, 8)
    s, ids = T.dispatch_topk(q, c, 4, prefer_kernel=True, tile=4)
    assert calls.pop("certified") == ((2048, 8), 1024, True)
    assert s.shape == (1030, 4) and ids.shape == (1030, 4)
    T.dispatch_topk(q[:512], c, 4, prefer_kernel=True, tile=4)
    assert calls.pop("certified") == ((512, 8), 512, False)


def test_dispatch_padded_batch_certifies_exact(rng):
    n, d, k, tile = 16384, 8, 4, 64
    c, q = _unit(rng, n, d), _unit(rng, 1030, d)
    qt, ct = torch.from_numpy(q), torch.from_numpy(c)
    s, packed = T.dispatch_topk(qt, ct, k, prefer_kernel=True, tile=tile,
                                defer_certificate=True)
    assert packed.shape == (1031, k)
    assert T.certificate_uncovered(packed) == 0
    s_ref, i_ref = T.exact_topk(qt, ct, k)
    np.testing.assert_array_equal(packed[:-1].numpy(), i_ref.numpy())
    np.testing.assert_allclose(s.numpy(), s_ref.numpy(), rtol=0, atol=1e-6)


# ------------------------------------------- repair of a failed certificate

REPAIR_TILE = 64
# case -> (queries, D, tiles, k, corpus dtype, near-copies of query 0
# beyond c1's reach, tiles a query's chunk is stored in)
REPAIR_CASES = {"f32": (16, 32, 128, 2, torch.float32, False, 4),
                "bf16": (16, 32, 128, 2, torch.bfloat16, False, 4),
                "c3": (16, 32, 128, 2, torch.float32, True, 4),
                "multi": (1030, 16, 64, 1, torch.float32, False, 2)}


def _repair_case(rng, case):
    b, d, tiles, k, tdt, c3, per_query = REPAIR_CASES[case]
    q, c = RC.runs_corpus(rng, b, d, REPAIR_TILE, tiles, per_query, c3=c3)
    jdt, atol = ((jnp.bfloat16, BF16_ATOL) if tdt == torch.bfloat16
                 else (jnp.float32, F32_ATOL))
    (qj, cj), (qt, ct) = _pair(q, c, jdt, tdt)
    return qt, ct, k, (qj, cj, atol)


def _spy_reruns(monkeypatch):
    calls = []
    real = T.tiled_topk
    monkeypatch.setattr(T, "tiled_topk",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    return calls


@pytest.mark.parametrize("case", list(REPAIR_CASES))
def test_repair_equals_the_rerun(rng, monkeypatch, case):
    """A failed certificate (c2 pairs; with "c3" a c3 query too; "multi"
    1,030 queries padded to 2,048 in two sub-batches) repaired pair by pair
    gives the tiled rerun's answer bit for bit, deferred and settled, with
    no rerun; the certified answer alone differs from it."""
    qt, ct, k, _ = _repair_case(rng, case)
    s, packed, cover = T.dispatch_deferred(qt, ct, k, prefer_kernel=True,
                                           tile=REPAIR_TILE)
    uncovered = T.certificate_uncovered(packed)
    s_r, i_r = T.tiled_topk(qt, ct, k, tile=REPAIR_TILE)
    assert uncovered > 0 and not torch.equal(packed[:-1], i_r)
    assert packed.shape == (qt.shape[0] + 1, k)
    assert cover.need.shape == (qt.shape[0], ct.shape[0] // REPAIR_TILE)
    reruns = _spy_reruns(monkeypatch)
    s2, i2, pairs, rerun = T.repair_uncovered(qt, ct, k, None, REPAIR_TILE,
                                              s, packed[:-1], cover)
    assert not rerun and not reruns
    assert torch.equal(i2, i_r) and torch.equal(s2, s_r)
    # Without c3 the pairs are c2's, which the certificate counts; a c3
    # query adds its tiles whose best unit c1 did not rescore.
    assert pairs > uncovered if case == "c3" else pairs == uncovered
    s3, i3 = T.dispatch_topk(qt, ct, k, prefer_kernel=True, tile=REPAIR_TILE)
    assert not reruns
    assert torch.equal(i3, i_r) and torch.equal(s3, s_r)


@pytest.mark.parametrize("case", list(REPAIR_CASES))
def test_repair_matches_jax(rng, case):
    """dispatch_topk against the JAX package on the same cases: settled
    (repaired here, rerun there) the same answer; deferred the same scores
    and certificate row, the ids the same or another copy of the same row
    (the JAX certified path orders exact ties by candidate rank)."""
    qt, ct, k, (qj, cj, atol) = _repair_case(rng, case)
    _same(J.dispatch_topk(qj, cj, k, prefer_pallas=True, tile=REPAIR_TILE),
          T.dispatch_topk(qt, ct, k, prefer_kernel=True, tile=REPAIR_TILE),
          atol)
    sj, pj = (np.asarray(a) for a in J.dispatch_topk(
        qj, cj, k, prefer_pallas=True, tile=REPAIR_TILE,
        defer_certificate=True))
    s, packed = (a.numpy() for a in T.dispatch_topk(
        qt, ct, k, prefer_kernel=True, tile=REPAIR_TILE,
        defer_certificate=True))
    assert packed[-1, 0] > 0
    np.testing.assert_array_equal(packed[-1], pj[-1])
    np.testing.assert_allclose(s, sj, rtol=0, atol=atol)
    rows = ct.float().numpy()
    np.testing.assert_array_equal(rows[packed[:-1]], rows[pj[:-1]])


@pytest.mark.parametrize("extra", [-1, 0])
def test_repair_reruns_from_the_crossover(rng, monkeypatch, extra):
    """Any pairs beyond the covers' leave the answer exact; from T x
    ceil(B / 64) pairs on (K6's blocks) the tiled search reruns instead,
    with the same answer."""
    qt, ct, k, _ = _repair_case(rng, "f32")
    s, packed, cover = T.dispatch_deferred(qt, ct, k, prefer_kernel=True,
                                           tile=REPAIR_TILE)
    need = cover.need.clone()
    tiles = ct.shape[0] // REPAIR_TILE
    cross = tiles * -(-qt.shape[0] // K.SELECTION_QUERY_BLOCK)
    free = (~need).nonzero()
    add = free[:cross + extra - int(need.sum())]
    need[add[:, 0], add[:, 1]] = True
    reruns = _spy_reruns(monkeypatch)
    s2, i2, pairs, rerun = T.repair_uncovered(
        qt, ct, k, None, REPAIR_TILE, s, packed[:-1], T.Cover(need, "dense"))
    assert pairs == cross + extra
    assert rerun == (extra == 0) and len(reruns) == (extra == 0)
    s_r, i_r = T.tiled_topk(qt, ct, k, tile=REPAIR_TILE)
    assert torch.equal(i2, i_r) and torch.equal(s2, s_r)


def _whole_rerun(monkeypatch):
    """Make DenseIndex's repair take the whole rerun: a cover that names
    every pair (a superset of the pairs left, so still exact)."""
    real = T.repair_uncovered

    def every_pair(*a, **kw):
        cover = a[7]
        return real(*a[:7], T.Cover(torch.ones_like(cover.need), cover.mode),
                    **kw)
    monkeypatch.setattr(dense, "repair_uncovered", every_pair)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_index_repairs_a_failed_certificate(rng, monkeypatch, dtype):
    """DenseIndex.search over near-duplicate runs with tombstones: route
    "fallback", the uncovered pairs repaired (``search.fallback`` records
    ``pairs`` and ``rerun`` false), the answer the rerun's bit for bit,
    tombstoned rows filtered."""
    d, k = 16, 2
    tiles = 1280 if dtype == "bfloat16" else 320      # 64 * cc tiles
    q, c = RC.runs_corpus(rng, 16, d, REPAIR_TILE, tiles)
    index = DenseIndex(d, capacity_block=len(c), dtype=dtype,
                       tile=REPAIR_TILE, device="cpu")
    index.add(c)
    first = index.search(q, k, prefer_kernel=True)
    gone = [int(first.ids[0, 0]), int(first.ids[3, 1]), 5]
    index.delete(gone)
    reruns = _spy_reruns(monkeypatch)
    t0 = time.perf_counter()
    with profile():
        got = index.search(q, k, prefer_kernel=True)
    recs = profiling.RECORDER.records(t0, time.perf_counter())
    (fb,) = [r for r in recs if r.name == "search.fallback"]
    (top,) = [r for r in recs if r.name == "search"]
    assert got.route == "fallback" and not reruns
    assert fb.attrs["rerun"] is False and fb.attrs["pairs"] > 0
    assert top.attrs["uncovered"] > 0
    assert not set(gone) & set(got.ids.ravel().tolist())
    _whole_rerun(monkeypatch)
    with profile():
        want = index.search(q, k, prefer_kernel=True)
    (fb,) = [r for r in profiling.RECORDER.records(t0, time.perf_counter())
             if r.name == "search.fallback" and r.attrs["rerun"]]
    assert reruns and want.route == "fallback"
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_flagged_certificate_raises_before_the_repair(rng, monkeypatch):
    """A certificate of -1 (the scan's range flag) raises ValueError where
    it is read, with a cover at hand: nothing is repaired."""
    index = DenseIndex(16, 256, tile=128, device="cpu")
    index.add(RC.unit(rng, 10, 16))
    ids = np.zeros((3, 4), np.int64)
    ids[-1, 0] = -1
    called = []
    monkeypatch.setattr(dense, "repair_uncovered",
                        lambda *a, **kw: called.append(1))
    cover = T.Cover(torch.ones((2, 2), dtype=torch.bool), "dense")
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        index._settle_certificate(torch.zeros(2, 16), torch.zeros(2, 4), ids,
                                  4, cover)
    assert not called
