"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one (the kernels have
no CPU mode). The file imports neither JAX nor the JAX package, so on a
machine without JAX it runs alone:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_cuda.py

Tolerances: K1's packed lower bounds within one quantisation step (2**-12
on (2, 4)), since the kernel and cuBLAS sum in different orders; each
packed word names a live row whose exact score quantises to the word's
value within 1e-5, and equals the twin's word except where a row scores
within 1e-5 of a quantisation boundary (``packed_word_faults``). K4 and K6
scores within 1e-5, with ids equal except between rows whose scores differ
by less than that drift, where the kernel's row must score its value
(K4 and K6 score bf16 and f16 rows on the tensor cores, which sum in their
own order); exact duplicate rows in the order of their rows, the padding
tail (-1e30, column 0) exact. K3's words and K5b's values and columns are
bit for bit their twins' (the int8-native score is exact, at any width,
on the tensor cores too); K7 is held as K6 is. K2 is held as K1 is and K5a
as K4 is, scored as the scaled route (bf16 operands, f32 sum, x row
scale): the kernels sum in their own order and the twins by a matmul, so
their f32 sums may differ in the last bits. F within 1e-5 of its twin (the
same scores; the max is order-free). K1 and F over bf16 and f16 rows, and
K2 over int8 codes and bf16 rows, run on the tensor cores
(csrc/scan_mma.cuh), which sum in their own order: a row on a
quantisation boundary may quantise one step (tile * 2**-22) apart from the
twin's, which ``packed_word_faults`` counts as a boundary word.
"""

import numpy as np
import pytest
import torch

from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import scan_rounding as R
from optimized_rag_tpu_torch.ops import topk_kernels as K
from optimized_rag_tpu_torch.ops.quantize import quantize_int8

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _clustered(seed, b, d=384, tile=128, tiles=64, k=10):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((tile * tiles, d)).astype(np.float32) * 0.1
    for bi in range(b):
        t0 = ((bi * 7 + 3) % tiles) * tile
        c[t0:t0 + k] = q[bi] + 0.01 * rng.standard_normal((k, d))
    return q, c / np.linalg.norm(c, axis=1, keepdims=True)


def _agree(q, c, rows, vals, rows_ref, vals_ref, tol=1e-5, row_scale=None):
    """Scores within ``tol``; where ids differ, the kernel's row must score
    its value (rows rounded to bf16 and scaled for the scaled kernels)."""
    assert float((vals - vals_ref).abs().max()) <= tol
    mism = rows != rows_ref
    if bool(mism.any()):
        b_idx = torch.arange(q.shape[0], device=q.device).expand_as(rows)
        r = c[rows[mism].long()]
        if row_scale is not None and r.dtype != torch.int8:
            r = r.to(torch.bfloat16)
        s = (r.float() * q[b_idx[mism]]).sum(-1)
        if row_scale is not None:
            s = s * row_scale[rows[mism].long()]
        assert float((s - vals[mism]).abs().max()) <= tol


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16,
                                  torch.float16])
@pytest.mark.parametrize("b", [1, 33, 64, 130])
def test_kernels_match_twins(cuda_device, tdt, b):
    q, c = _clustered(b, b)
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device, tdt)
    size = c.shape[0] - 100
    qs = K._scan_queries(qt, ct)
    K.reset_launch_counts()
    w = K.packed_extract(qt, ct, size, 128, 8)
    w_p = K.packed_extract_plain(qs, ct, size, 128, 8)
    diff = (T._unpack_lb(w, 128) - T._unpack_lb(w_p, 128)).abs().max()
    assert float(diff) <= 2.0 ** -12
    faults, _ = K.packed_word_faults(qs, ct, size, 128, w, w_p)
    assert faults == 0
    tiles = torch.tensor([5, 0, 63, 3, 17], device=cuda_device)
    v, col = K.extract(qt, ct, size, 128, 10, tiles)
    v_p, col_p = K.extract_plain(qs, ct, size, 128, 10, tiles)
    base = (tiles * 128)[:, None, None]
    _agree(qs, ct, col + base, v, col_p + base, v_p)
    s, i = K.tile_topk(qt, ct, size, 128, 10)
    s_p, i_p = K.tile_topk_plain(qs, ct, size, 128, 10)
    _agree(qs, ct, i, s, i_p, s_p)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert {n: counts[n] for n in ("packed_extract", "extract",
                                   "tile_topk")} == dict.fromkeys(
        ("packed_extract", "extract", "tile_topk"), 1)


@pytest.mark.parametrize("b", [1, 33, 64, 130])
def test_int8_kernels_match_twins(cuda_device, b):
    q, c = _clustered(b, b)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device))
    qt = torch.from_numpy(q).to(cuda_device)
    q8, qs = quantize_int8(qt)
    size = c.shape[0] - 100
    K.reset_launch_counts()
    w = K.packed_extract_int8(q8, qs, c8, cs, size, 128, 8)
    w_p = K.packed_extract_int8_plain(q8, qs, c8, cs, size, 128, 8)
    assert torch.equal(w, w_p)
    tiles = torch.tensor([5, 0, 63, 3, 17], device=cuda_device)
    for rounds in (10, 64, 128):
        v, col = K.extract_int8(q8, qs, c8, cs, size, 128, rounds, tiles)
        v_p, col_p = K.extract_int8_plain(q8, qs, c8, cs, size, 128, rounds,
                                          tiles)
        assert torch.equal(v, v_p) and torch.equal(col, col_p)
    s, i = K.tile_topk_scaled(qt, c8, cs, size, 128, 10)
    qb = qt.to(torch.bfloat16).float()
    s_p, i_p = K.tile_topk_scaled_plain(qb, c8, cs, size, 128, 10)
    assert float((s - s_p).abs().max()) <= 1e-5
    mism = i != i_p
    if bool(mism.any()):                 # near-ties: the row scores its value
        b_idx = torch.arange(b, device=cuda_device).expand_as(i)
        rows = i[mism].long()
        true = (c8[rows].float() * qb[b_idx[mism]]).sum(-1) * cs[rows]
        assert float((true - s[mism]).abs().max()) <= 1e-5
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["packed_extract_int8"], counts["extract_int8"],
            counts["tile_topk_scaled"]) == (1, 3, 1)


def test_int8_certified_search_on_card_is_exact(cuda_device):
    """The int8-native certified path against its oracle: the exact
    int8-native scores (a float32 product of the codes, then * row scale,
    then * query scale), top-k with ties to the lower row."""
    q, c = _clustered(7, 16, d=64, tiles=700, k=4)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device))
    qt = torch.from_numpy(q).to(cuda_device)
    K.reset_launch_counts()
    s, ids = T.dispatch_topk(qt, c8, 4, tile=128, row_scale=cs)
    assert K.launch_counts()["packed_extract_int8"] == 1
    q8, qs = quantize_int8(qt)
    ref = ((q8.float() @ c8.float().T) * cs[None, :]) * qs[:, None]
    s_ref, i_ref = torch.sort(ref, dim=1, descending=True, stable=True)
    assert torch.equal(ids, i_ref[:, :4]) and torch.equal(s, s_ref[:, :4])


def test_quantize_on_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4096, 384)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    x[7] = 0
    c8, cs = quantize_int8(torch.from_numpy(x).to(cuda_device))
    h8, hs = quantize_int8(torch.from_numpy(x))
    assert torch.equal(c8.cpu(), h8)
    assert torch.equal(cs.cpu().view(torch.int32), hs.view(torch.int32))


def test_certified_search_on_card_is_exact(cuda_device):
    q, c = _clustered(7, 16, d=64, tiles=700, k=4)
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    s, ids = T.dispatch_topk(qt, ct, 4, tile=128)
    s_ref, i_ref = T.exact_topk(qt, ct, 4)
    assert torch.equal(ids, i_ref)
    assert float((s - s_ref).abs().max()) <= 1e-5


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn(4, 64, device=cuda_device)
    with pytest.raises(ValueError, match="power of two"):
        K.packed_extract(q, torch.randn(300, 64, device=cuda_device), None,
                         100, 4)
    big = 2 * K.MAX_EXTRACT_TILE
    with pytest.raises(ValueError, match=f"exceeds {K.MAX_EXTRACT_TILE}"):
        K.tile_topk(q, torch.randn(big, 64, device=cuda_device), None, big,
                    4)
    with pytest.raises(ValueError, match="shared memory"):
        K.packed_extract(q, torch.randn(big, 64, device=cuda_device), None,
                         big, 8)
    with pytest.raises(TypeError, match="dtype"):
        K.tile_topk(q, torch.zeros((1024, 64), dtype=torch.int8,
                                   device=cuda_device), None, 1024, 4)
    c8 = torch.zeros((1024, 66), dtype=torch.int8, device=cuda_device)
    cs = torch.ones(1024, device=cuda_device)
    q8 = torch.zeros((4, 66), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="q_scale"):
        K.packed_extract_int8(q8, cs[:3], c8, cs, None, 128, 8)
    with pytest.raises(ValueError, match="row_scale"):
        K.tile_topk_scaled(q, c8[:, :64].contiguous(), cs[:512], None, 128,
                           4)
    with pytest.raises(ValueError, match="row_scale"):
        K.packed_extract_scaled(q, c8[:, :64].contiguous(), cs[:512], None,
                                128, 8)


@pytest.mark.parametrize("cdt", [torch.int8, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 33, 64, 130])
def test_scaled_kernels_match_twins(cuda_device, cdt, b):
    """K2 and K5a (the scaled route) against their twins: K2's words by
    value and by the row their column names, K5a's values within 1e-5."""
    q, c = _clustered(b, b)
    qt = torch.from_numpy(q).to(cuda_device)
    c32 = torch.from_numpy(c).to(cuda_device)
    if cdt == torch.int8:
        ct, cs = quantize_int8(c32)
    else:
        ct = c32.to(cdt)
        cs = torch.rand(c.shape[0], device=cuda_device) * 0.5 + 0.5
    size = c.shape[0] - 100
    qb = qt.to(torch.bfloat16).float()
    rows_dtype = K.scaled_rows_dtype(ct)
    K.reset_launch_counts()
    w = K.packed_extract_scaled(qt, ct, cs, size, 128, 8)
    w_p = K.packed_extract_scaled_plain(qb, ct, cs, size, 128, 8)
    diff = (T._unpack_lb(w, 128) - T._unpack_lb(w_p, 128)).abs().max()
    assert float(diff) <= 2.0 ** -12
    faults, _ = K.packed_word_faults(qb, ct, size, 128, w, w_p,
                                     row_scale=cs, rows_dtype=rows_dtype)
    assert faults == 0
    tiles = torch.tensor([5, 0, 63, 3, 17], device=cuda_device)
    for rounds in (10, 64):
        v, col = K.extract_scaled(qt, ct, cs, size, 128, rounds, tiles)
        v_p, col_p = K.extract_scaled_plain(qb, ct, cs, size, 128, rounds,
                                            tiles)
        base = (tiles * 128)[:, None, None]
        _agree(qb, ct, col + base, v, col_p + base, v_p, row_scale=cs)
    s, i = K.tile_topk_scaled(qt, ct, cs, size, 128, 10)
    s_p, i_p = K.tile_topk_scaled_plain(qb, ct, cs, size, 128, 10)
    _agree(qb, ct, i, s, i_p, s_p, row_scale=cs)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["packed_extract_scaled"], counts["extract_scaled"],
            counts["tile_topk_scaled"]) == (1, 2, 1)


@pytest.mark.parametrize("tile", [2048, 4096, 8192, 16384])
def test_large_tiles_match_twins(cuda_device, tile):
    """K4, K5a, K5b, K6 and K7 at tiles above 1024, up to
    MAX_EXTRACT_TILE (64 queries a block at every tile)."""
    b, d = 33, 128
    q, c = _clustered(tile, b, d=d, tile=tile, tiles=16)
    qt = torch.from_numpy(q).to(cuda_device)
    c32 = torch.from_numpy(c).to(cuda_device)
    cb = c32.to(torch.bfloat16)
    c8, cs = quantize_int8(c32)
    q8, qs = quantize_int8(qt)
    size = c.shape[0] - 100
    qsb, qb = K._scan_queries(qt, cb), qt.to(torch.bfloat16).float()
    tiles = torch.tensor([5, 0, 15, 3], device=cuda_device)
    base = (tiles * tile)[:, None, None]
    v, col = K.extract(qt, cb, size, tile, 10, tiles)
    v_p, col_p = K.extract_plain(qsb, cb, size, tile, 10, tiles)
    _agree(qsb, cb, col + base, v, col_p + base, v_p)
    v, col = K.extract_scaled(qt, c8, cs, size, tile, 10, tiles)
    v_p, col_p = K.extract_scaled_plain(qb, c8, cs, size, tile, 10, tiles)
    _agree(qb, c8, col + base, v, col_p + base, v_p, row_scale=cs)
    v, col = K.extract_int8(q8, qs, c8, cs, size, tile, 64, tiles)
    v_p, col_p = K.extract_int8_plain(q8, qs, c8, cs, size, tile, 64, tiles)
    assert torch.equal(v, v_p) and torch.equal(col, col_p)
    s, i = K.tile_topk(qt, cb, size, tile, 10)
    s_p, i_p = K.tile_topk_plain(qsb, cb, size, tile, 10)
    _agree(qsb, cb, i, s, i_p, s_p)
    s, i = K.tile_topk_scaled(qt, c8, cs, size, tile, 10)
    s_p, i_p = K.tile_topk_scaled_plain(qb, c8, cs, size, tile, 10)
    _agree(qb, c8, i, s, i_p, s_p, row_scale=cs)


@pytest.mark.parametrize("tile,groups", [(4096, 4), (4096, 2), (16384, 8)])
def test_packed_scans_with_many_units_match_twins(cuda_device, tile, groups):
    """K1, K2 and K3 where 64 queries' unit winners (tile / groups of them,
    up to MAX_UNITS) would not fit in shared memory: 16 queries a block."""
    b, d = 33, 128
    q, c = _clustered(groups, b, d=d, tile=tile, tiles=8)
    qt = torch.from_numpy(q).to(cuda_device)
    c32 = torch.from_numpy(c).to(cuda_device)
    size = c.shape[0] - 100
    for ct in (c32, c32.to(torch.bfloat16)):
        qs = K._scan_queries(qt, ct)
        w = K.packed_extract(qt, ct, size, tile, groups)
        w_p = K.packed_extract_plain(qs, ct, size, tile, groups)
        diff = (T._unpack_lb(w, tile) - T._unpack_lb(w_p, tile)).abs().max()
        assert float(diff) <= 2.0 ** -12
        assert K.packed_word_faults(qs, ct, size, tile, w, w_p,
                                    groups=groups)[0] == 0
    c8, cs = quantize_int8(c32)
    q8, q_scale = quantize_int8(qt)
    w = K.packed_extract_int8(q8, q_scale, c8, cs, size, tile, groups)
    w_p = K.packed_extract_int8_plain(q8, q_scale, c8, cs, size, tile, groups)
    assert torch.equal(w, w_p)
    qb = qt.to(torch.bfloat16).float()
    w = K.packed_extract_scaled(qt, c8, cs, size, tile, groups)
    w_p = K.packed_extract_scaled_plain(qb, c8, cs, size, tile, groups)
    diff = (T._unpack_lb(w, tile) - T._unpack_lb(w_p, tile)).abs().max()
    assert float(diff) <= 2.0 ** -12
    assert K.packed_word_faults(qb, c8, size, tile, w, w_p,
                                row_scale=cs, groups=groups)[0] == 0


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16,
                                  torch.float16])
def test_scan_floor_matches_twin(cuda_device, tdt):
    q, c = _clustered(5, 70)
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device, tdt)
    K.reset_launch_counts()
    f = K.scan_floor(qt, ct, 1024)
    f_p = K.scan_floor_plain(K._scan_queries(qt, ct), ct, 1024)
    assert f.shape == (c.shape[0] // 1024, 1, 70)
    assert float((f - f_p).abs().max()) <= 1e-5
    assert K.launch_counts()["scan_floor"] == 1


@pytest.mark.parametrize("d,offset", [(390, 0), (390, 1), (1100, 0)])
def test_int8_kernels_at_any_width(cuda_device, d, offset):
    """K3's words and K5b's values bit for bit their twins' where D is no
    multiple of 4, rows are not 4-byte aligned, or D * 127**2 >= 2**24."""
    q, c = _clustered(d, 33, d=d, tiles=16)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device))
    if offset:                        # the same codes one byte off alignment
        buf = torch.zeros(c8.numel() + offset, dtype=torch.int8,
                          device=cuda_device)
        buf[offset:] = c8.reshape(-1)
        c8 = buf[offset:].view(c8.shape)
        assert c8.data_ptr() % 4
    qt = torch.from_numpy(q).to(cuda_device)
    q8, qs = quantize_int8(qt)
    size = c.shape[0] - 100
    w = K.packed_extract_int8(q8, qs, c8, cs, size, 128, 8)
    w_p = K.packed_extract_int8_plain(q8, qs, c8, cs, size, 128, 8)
    assert torch.equal(w, w_p)
    tiles = torch.tensor([5, 0, 15, 3], device=cuda_device)
    v, col = K.extract_int8(q8, qs, c8, cs, size, 128, 16, tiles)
    v_p, col_p = K.extract_int8_plain(q8, qs, c8, cs, size, 128, 16, tiles)
    assert torch.equal(v, v_p) and torch.equal(col, col_p)


def _scaled_oracle(q, c, cs, k):
    rows = c if c.dtype == torch.int8 else c.to(torch.bfloat16)
    ref = (q.to(torch.bfloat16).float() @ rows.float().T) * cs[None, :]
    s, i = torch.sort(ref, dim=1, descending=True, stable=True)
    return s[:, :k], i[:, :k]


@pytest.mark.parametrize("route", ["bf16", "scaled_int8", "scaled_f32",
                                   "native_int8"])
def test_certified_at_tile_4096_on_card_is_exact(cuda_device, route):
    """The certified path at the reference's default tile on each route,
    against its route's oracle."""
    q, c = _clustered(11, 16, d=64, tile=4096, tiles=40, k=10)
    qt = torch.from_numpy(q).to(cuda_device)
    c32 = torch.from_numpy(c).to(cuda_device)
    kw = {}
    if route == "bf16":
        ct = c32.to(torch.bfloat16)
        o_s, o_i = T.exact_topk(qt.to(torch.bfloat16).float(), ct, 10)
    elif route == "scaled_f32":
        ct = c32
        kw["row_scale"] = torch.rand(c.shape[0], device=cuda_device) + 0.5
        o_s, o_i = _scaled_oracle(qt, ct, kw["row_scale"], 10)
    else:
        ct, kw["row_scale"] = quantize_int8(c32)
        kw["int8_native"] = route == "native_int8"
        if kw["int8_native"]:
            q8, qs = quantize_int8(qt)
            ref = ((q8.float() @ ct.float().T) * kw["row_scale"][None, :]
                   * qs[:, None])
            o_s, o_i = torch.sort(ref, dim=1, descending=True, stable=True)
            o_s, o_i = o_s[:, :10], o_i[:, :10]
        else:
            o_s, o_i = _scaled_oracle(qt, ct, kw["row_scale"], 10)
    s, ids = T.topk_certified(qt, ct, 10, tile=4096, **kw)
    assert T.certificate_uncovered(ids) == 0
    assert torch.equal(ids[:-1], o_i)
    assert float((s - o_s).abs().max()) <= 1e-5


@pytest.mark.parametrize("route", ["f32", "native_int8", "scaled_int8"])
def test_range_flag_raises_on_card(cuda_device, route):
    """One unnormalised row (a score of -3): the kernel flags it, and the
    certificate's reader raises the twins' ValueError."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 32)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((128 * 300, 32)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[77] = -3.0 * q[0]                 # 300 tiles: dispatch certifies
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    kw = {}
    if route != "f32":
        ct, kw["row_scale"] = quantize_int8(ct)
        kw["int8_native"] = route == "native_int8"
    s, ids = T.topk_certified(qt, ct, 4, tile=128, **kw)
    assert int(ids[-1, 0]) == -1
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.certificate_uncovered(ids)
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.dispatch_topk(qt, ct, 4, prefer_kernel=True, tile=128, **{
            k: v for k, v in kw.items() if k == "row_scale"})
    with pytest.raises(ValueError, match=r"\(-2, 2\)"):
        T.topk_ann(qt, ct, 4, tile=128, **{
            k: v for k, v in kw.items() if k == "row_scale"})
    flag = K.new_flag(cuda_device)
    if route == "f32":
        K.packed_extract(qt, ct, None, 128, 8, flag)
        assert int(flag[0]) == 1
        flag.zero_()
        K.packed_extract(qt, ct, 77, 128, 8, flag)   # the row is padding
        assert int(flag[0]) == 0


# ------------------------------------------------ streaming selection corners

def _corner_data(seed, b, d, tile, tiles=6):
    """Clustered rows with two exact duplicate pairs aimed at queries 0 and
    1: rows tile+5 and tile+9 (one chunk of 128 rows) and rows 2*tile+127
    and 2*tile+128 (either side of a chunk border; of a tile border at tile
    128). Returns the pairs inside one tile and a ``size`` that leaves 5
    live rows in tile tiles-2 and none in the last tile."""
    q, c = _clustered(seed, b, d=d, tile=tile, tiles=tiles)
    rng = np.random.default_rng(seed + 1)
    pairs = ((tile + 5, tile + 9), (2 * tile + 127, 2 * tile + 128))
    for qi, (lo, hi) in enumerate(pairs):
        row = q[qi % b] + 0.05 * rng.standard_normal(d).astype(np.float32)
        c[lo] = c[hi] = row / np.linalg.norm(row)
    same_tile = tuple((lo, hi) for lo, hi in pairs if lo // tile == hi // tile)
    return q, c, same_tile, (tiles - 2) * tile + 5


def _lower_twin_first(ids, pairs):
    """Every exact duplicate pair: where the higher row is selected for a
    query, the lower row is selected for it too, and earlier."""
    ids = ids.long()
    for lo, hi in pairs:
        has_hi = (ids == hi).any(dim=-2)                  # [S, B]
        if not bool(has_hi.any()):
            continue
        pos = torch.arange(ids.shape[-2], device=ids.device)[None, :, None]
        big = ids.shape[-2]
        p_lo = torch.where(ids == lo, pos, big).amin(dim=-2)
        p_hi = torch.where(ids == hi, pos, big).amin(dim=-2)
        assert bool((p_lo[has_hi] < p_hi[has_hi]).all()), (lo, hi)


def _hold_selections(dev, q, c, size, tile, rounds, pairs):
    """K4, K5a, K5b, K6 and K7 on one input against their twins; the
    duplicate pairs in row order; the padding tail and the dead tile of K6
    exact. K4/K6 over f32 rows (FMA) and bf16 rows (tensor cores)."""
    qt = torch.from_numpy(q).to(dev)
    c32 = torch.from_numpy(c).to(dev)
    c8, cs = quantize_int8(c32)
    q8, qs = quantize_int8(qt)
    n_tiles = c.shape[0] // tile
    tiles = torch.tensor([1, n_tiles - 2, 2, n_tiles - 1, 0], device=dev)
    base = (tiles * tile)[:, None, None]
    qb = qt.to(torch.bfloat16).float()
    for ct in (c32, c32.to(torch.bfloat16)):
        qk = K._scan_queries(qt, ct)
        v, col = K.extract(qt, ct, size, tile, rounds, tiles)
        v_p, col_p = K.extract_plain(qk, ct, size, tile, rounds, tiles)
        _agree(qk, ct, col + base, v, col_p + base, v_p)
        _lower_twin_first(col + base, pairs)
        s, i = K.tile_topk(qt, ct, size, tile, rounds)
        s_p, i_p = K.tile_topk_plain(qk, ct, size, tile, rounds)
        _agree(qk, ct, i, s, i_p, s_p)
        _lower_twin_first(i, pairs)
        live = 5                               # rows of tile n_tiles - 2
        if rounds > live:                      # the padding tail
            assert bool((s[n_tiles - 2, live:] == K.NEG_INF).all())
            assert bool((i[n_tiles - 2, live:] == (n_tiles - 2) * tile).all())
            assert bool((v[1, live:] == K.NEG_INF).all())
            assert bool((col[1, live:] == 0).all())
        assert bool((s[n_tiles - 1] == K.NEG_INF).all())      # a dead tile
        assert bool((i[n_tiles - 1] == (n_tiles - 1) * tile).all())
    v, col = K.extract_scaled(qt, c8, cs, size, tile, rounds, tiles)
    v_p, col_p = K.extract_scaled_plain(qb, c8, cs, size, tile, rounds, tiles)
    _agree(qb, c8, col + base, v, col_p + base, v_p, row_scale=cs)
    _lower_twin_first(col + base, pairs)
    v, col = K.extract_int8(q8, qs, c8, cs, size, tile, rounds, tiles)
    v_p, col_p = K.extract_int8_plain(q8, qs, c8, cs, size, tile, rounds,
                                      tiles)
    assert torch.equal(v, v_p) and torch.equal(col, col_p)
    s, i = K.tile_topk_scaled(qt, c8, cs, size, tile, rounds)
    s_p, i_p = K.tile_topk_scaled_plain(qb, c8, cs, size, tile, rounds)
    _agree(qb, c8, i, s, i_p, s_p, row_scale=cs)
    _lower_twin_first(i, pairs)


@pytest.mark.parametrize("b", [1, 33, 64, 130, 1024])
@pytest.mark.parametrize("tile", [128, 1024, 4096, 16384])
def test_stream_selection_matches_twins(cuda_device, tile, b):
    """K4, K5a, K5b, K6 and K7 at 10 and 64 rounds, at every tile from 128
    to MAX_EXTRACT_TILE and batches from 1 to 1024 (one to 16 blocks of 64
    queries; the clusters that split a tile where blocks are few): a tile
    with fewer live rows than rounds, a dead tile, exact duplicate rows in
    one chunk and across a chunk border."""
    q, c, pairs, size = _corner_data(tile + b, b, 64, tile)
    for rounds in (10, 64):
        _hold_selections(cuda_device, q, c, size, tile, rounds, pairs)


@pytest.mark.parametrize("rounds", [100, "tile"])
@pytest.mark.parametrize("tile", [128, 1024])
def test_stream_selection_in_passes_matches_twins(cuda_device, tile, rounds):
    """rounds above the 64 a running list holds: passes of 64 below a
    floor, up to rounds equal to the tile; D=100 stages bf16 rows value by
    value (rows not 16-byte aligned)."""
    rounds = tile if rounds == "tile" else rounds
    q, c, pairs, size = _corner_data(tile + 7, 33, 100, tile)
    _hold_selections(cuda_device, q, c, size, tile, rounds, pairs)


def test_extract_writes_padding_for_absent_tiles(cuda_device):
    """A listed tile id below 0 or past N gives (-1e30, 0) in every round."""
    q, c = _clustered(3, 70, d=64, tiles=8)
    qt = torch.from_numpy(q).to(cuda_device)
    for ct in (torch.from_numpy(c).to(cuda_device),
               torch.from_numpy(c).to(cuda_device, torch.bfloat16)):
        tiles = torch.tensor([-1, 2, 8, 5], device=cuda_device)
        v, col = K.extract(qt, ct, None, 128, 16, tiles)
        for slot in (0, 2):
            assert bool((v[slot] == K.NEG_INF).all())
            assert bool((col[slot] == 0).all())
        ok = tiles[[1, 3]]
        v_p, col_p = K.extract_plain(K._scan_queries(qt, ct), ct, None, 128,
                                     16, ok)
        base = (ok * 128)[:, None, None]
        _agree(K._scan_queries(qt, ct), ct, col[[1, 3]] + base, v[[1, 3]],
               col_p + base, v_p)


def _pairs(tile, n_tiles, b, dev):
    """(pair_tile, pair_query) sorted by tile: 70 queries on tile 1 (two
    blocks of one run), a lone pair on tile 2, two on the tile with 5 live
    rows, one on the dead tile, three on tile 0."""
    want = ([(1, qi) for qi in range(70)] + [(2, 5)]
            + [(n_tiles - 2, 3), (n_tiles - 2, b - 30)]
            + [(n_tiles - 1, 7), (0, 1), (0, 64), (0, b - 1)])
    pt, pq = zip(*sorted(want))
    return (torch.tensor(pt, device=dev), torch.tensor(pq, device=dev))


@pytest.mark.parametrize("rounds", [10, 64, 100])
@pytest.mark.parametrize("tile", [128, 4096])
def test_extract_pairs_matches_k4_and_twin(cuda_device, tile, rounds):
    """K4p over f32, bf16 and f16 rows (as K4), scaled f32 rows and int8
    codes (as K5a) and int8-native (as K5b): each pair's list equals K4's
    (K5a's, K5b's) list of that tile for that query bit for bit, and its
    twin's within the drift (the int8-native one bit for bit); pairs grouped
    on shared tiles, a lone pair, a tile with 5 live rows, a tile past
    size."""
    dev = cuda_device
    q, c, _, size = _corner_data(tile + rounds, 130, 64, tile)
    qt, c32 = torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev)
    n_tiles = c.shape[0] // tile
    pt, pq = _pairs(tile, n_tiles, q.shape[0], dev)
    c8, cs = quantize_int8(c32)
    q8, qs = quantize_int8(qt)
    cs_f = torch.rand(c.shape[0], generator=torch.Generator(
        device=dev).manual_seed(3), device=dev) + 0.5
    cases = [(qt, ct, {}) for ct in (
        c32, c32.to(torch.bfloat16), c32.to(torch.float16))]
    cases += [(qt, c32, {"row_scale": cs_f}), (qt, c8, {"row_scale": cs}),
              (q8, c8, {"row_scale": cs, "q_scale": qs})]
    for qk, ct, kw in cases:
        v, col = K.extract_pairs(qk, ct, size, tile, rounds, pt, pq, **kw)
        if qk.dtype == torch.int8:
            v4, c4 = K.extract_int8(q8, qs, ct, cs, size, tile, rounds, pt)
            v_p, c_p = K.extract_pairs_plain(q8, ct, size, tile, rounds, pt,
                                             pq, **kw)
        elif kw:
            v4, c4 = K.extract_scaled(qk, ct, kw["row_scale"], size, tile,
                                      rounds, pt)
            qp = K._bf16_queries(qk)
            v_p, c_p = K.extract_pairs_plain(
                qp, ct, size, tile, rounds, pt, pq, row_scale=kw["row_scale"],
                rows_dtype=K.scaled_rows_dtype(ct))
        else:
            v4, c4 = K.extract(qk, ct, size, tile, rounds, pt)
            qp = K._scan_queries(qk, ct)
            v_p, c_p = K.extract_pairs_plain(qp, ct, size, tile, rounds, pt,
                                             pq)
        j = torch.arange(pt.shape[0], device=dev)
        assert torch.equal(v, v4[j, :, pq].T), (ct.dtype, kw.keys())
        assert torch.equal(col, c4[j, :, pq].T), (ct.dtype, kw.keys())
        if qk.dtype == torch.int8:
            assert torch.equal(v, v_p) and torch.equal(col, c_p)
        else:
            base = (pt * tile)[None, :]
            _agree(qp[pq], ct, col + base, v, c_p + base, v_p,
                   row_scale=kw.get("row_scale"))
        dead = pt == n_tiles - 1
        assert bool((v[:, dead] == K.NEG_INF).all())
        assert bool((col[:, dead] == 0).all())
        if rounds > 5:                                 # 5 live rows
            few = pt == n_tiles - 2
            assert bool((v[5:, few] == K.NEG_INF).all())
    empty = torch.zeros(0, dtype=torch.long, device=dev)
    v, col = K.extract_pairs(qt, c32, size, tile, rounds, empty, empty)
    assert v.shape == col.shape == (rounds, 0)


def test_repaired_search_at_the_bench_shape_equals_the_rerun(cuda_device):
    """1,048,576 x 128 bf16 rows, tile 4096, B = 1,024, k = 10, each query
    with near-duplicate rows in 8 tiles: the certificate fails, K4p repairs
    the uncovered pairs (no rerun), and the answer is the tiled rerun's up
    to the drift between the c1 rescore's sums (cuBLAS) and K6's FMA chain:
    scores within 1e-6, ids equal but where two rows score within it (two
    rows 7e-9 apart swap on this input)."""
    dev = cuda_device
    n, d, tile, b, k = 1 << 20, 128, 4096, 1024, 10
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.nn.functional.normalize(
        torch.randn(b, d, generator=g, device=dev), dim=1)
    c = torch.randn(n, d, generator=g, device=dev) * 0.1
    qi = torch.arange(b, device=dev)
    for j in range(8):
        rows = ((qi + 37 * j) % (n // tile)) * tile + qi * 4 + j % 4
        c[rows] = q + 0.02 * torch.randn(b, d, generator=g, device=dev)
    cb = torch.nn.functional.normalize(c, dim=1).to(torch.bfloat16)
    s, packed, cover = T._certified(q, cb, k, sub_batch=b, tile=tile)
    assert T.certificate_uncovered(packed) > 0
    s2, i2, pairs, rerun = T.repair_uncovered(q, cb, k, None, tile, s,
                                              packed[:-1], cover)
    assert not rerun and pairs > 0
    s_r, i_r = T.tiled_topk(q, cb, k, tile=tile)
    _agree(K._scan_queries(q, cb), cb, i2.T, s2.T, i_r.T, s_r.T, tol=1e-6)
    assert bool((i2.sort(dim=1).values.diff(dim=1) > 0).all())


def test_wide_bf16_rows_take_the_fma_stage(cuda_device):
    """bf16 rows wider than the tensor-core stage takes (kMmaMaxD, or its
    shared memory) are scored by FMA: the same holds at D=640."""
    q, c, pairs, size = _corner_data(5, 70, 640, 1024)
    _hold_selections(cuda_device, q, c, size, 1024, 16, pairs)


# (tile, groups, B, D): tile/G from 2 to 2048 (units inside one 64-row chunk
# and units of whole chunks), one or two warpgroups of queries, k-slices cut
# short (D=100, 390), rows no multiple of 16 bytes (D=100, 390, 1540: the
# producer warp copies them), split accumulation (tile 128 at D=384 and
# 390, tile 1024 at D=1536 and 2048), and rows too wide for the queries to
# stay in shared memory (D=1536, 1540, 2048: they stream through the ring).
_MMA_SCAN_CASES = [(128, 64, 1, 64), (128, 8, 33, 100), (128, 2, 130, 384),
                   (128, 1, 8, 390), (1024, 512, 64, 128),
                   (1024, 8, 130, 384), (1024, 16, 1024, 640),
                   (4096, 8, 1024, 128), (4096, 2, 8, 390),
                   (16384, 8, 33, 64), (16384, 512, 1, 100),
                   (1024, 8, 130, 1536), (1024, 16, 33, 2048),
                   (4096, 8, 64, 2048), (4096, 4, 1, 1540)]


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("tile,groups,b,d", _MMA_SCAN_CASES)
def test_tensor_core_scans_match_twins(cuda_device, tdt, tile, groups, b, d):
    """K1 and F over 16-bit rows on the tensor cores against their twins, as
    chip_smoke.py's hold does: K1's lower bounds within one quantisation
    step (tile * 2**-22 on (2, 4): the tensor cores sum in another order
    than the twin's matmul, so a row within that drift of a boundary may
    quantise one step apart) and no word at fault under
    ``packed_word_faults`` (drift 1e-5), F within 1e-5. Also:
    a padding tail (5 live rows in the second-to-last tile) and a dead last
    tile; exact duplicate rows in one unit, which must give the later row
    (the packed word's tie order), and either side of a 64-row chunk
    border."""
    rng = np.random.default_rng(tile + 7 * b + d)
    tiles = 6
    n, small = tile * tiles, tile // groups
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((n, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    unit_pair = (tile + 5, tile + 5 + small) if groups > 1 else None
    border = (2 * tile + 63, 2 * tile + 64)
    c[border[0]] = c[border[1]] = q[-1]
    if unit_pair:
        c[unit_pair[0]] = c[unit_pair[1]] = q[0]
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device, tdt)
    size = (tiles - 2) * tile + 5
    qs = K._scan_queries(qt, ct)
    K.reset_launch_counts()
    w = K.packed_extract(qt, ct, size, tile, groups)
    w_p = K.packed_extract_plain(qs, ct, size, tile, groups)
    diff = (T._unpack_lb(w, tile) - T._unpack_lb(w_p, tile)).abs().max()
    assert float(diff) <= tile * 2.0 ** -22
    assert K.packed_word_faults(qs, ct, size, tile, w, w_p,
                                groups=groups)[0] == 0
    assert torch.equal(w[tiles - 1], w_p[tiles - 1])        # the dead tile
    if unit_pair:                   # both copies top tile 1: the later wins
        assert int(w[1, 0, 0]) & (tile - 1) == unit_pair[1] - tile
    f = K.scan_floor(qt, ct, tile)
    f_p = K.scan_floor_plain(qs, ct, tile)
    assert float((f - f_p).abs().max()) <= 1e-5
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert (counts["packed_extract"], counts["scan_floor"]) == (1, 1)


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16])
def test_tensor_core_scan_range_flag(cuda_device, tdt):
    """A live row scoring -3 sets K1's flag over 16-bit rows; the same row
    as padding does not."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((1024, 64)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[700] = -3.0 * q[0]
    qt = torch.from_numpy(q).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device, tdt)
    flag = K.new_flag(cuda_device)
    K.packed_extract(qt, ct, None, 128, 8, flag)
    assert int(flag[0]) == 1
    flag.zero_()
    K.packed_extract(qt, ct, 700, 128, 8, flag)     # the row is padding
    assert int(flag[0]) == 0


def test_tensor_core_scan_refuses_what_its_bound_does_not_cover(cuda_device):
    """K1 over 16-bit rows raises at (tile, D) pairs where the tensor cores'
    rounding could exceed one quantisation step; F, which has no
    certificate, and K1 over f32 rows (the FMA kernel) take them."""
    q = torch.randn(4, 640, device=cuda_device)
    c = torch.randn(1024, 640, device=cuda_device)
    assert K.scan_accumulation(128, 640) is None
    with pytest.raises(ValueError, match="quantisation step"):
        K.packed_extract(q, c.to(torch.bfloat16), None, 128, 8)
    K.packed_extract(q, c, None, 128, 8)                     # f32: FMA
    K.scan_floor(q, c.to(torch.bfloat16), 128)              # F: no bound


@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16])
def test_tensor_core_scan_flags_queries_its_bound_does_not_cover(cuda_device,
                                                                 tdt):
    """At tile 128, D=384 (split accumulation, the least margin) the bound
    admits query norms up to ``scan_query_norm_limit`` (1.138) against
    normalised rows: a query of norm 1.2 sets K1's range flag, one of norm
    1.1 does not, and neither does any query at tile 1024."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((3, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((1024, 384)).astype(np.float32) * 0.05
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    ct = torch.from_numpy(c).to(cuda_device, tdt)
    assert 1.1 < K.scan_query_norm_limit(128, 384) < 1.2
    for scale, tile, want in ((1.2, 128, 1), (1.1, 128, 0), (1.2, 1024, 0)):
        qt = torch.from_numpy(q).to(cuda_device)
        qt[1] *= scale
        flag = K.new_flag(cuda_device)
        K.packed_extract(qt, ct, None, tile, 8, flag)
        assert int(flag[0]) == want, (scale, tile)


@pytest.mark.parametrize("mode", ["full", "split"])
@pytest.mark.parametrize("d", [64, 100, 128, 384, 1536, 2048])
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16])
def test_tensor_core_sums_within_rounding_bound(cuda_device, tdt, d, mode):
    """The main loop of K1 and F (``scan_sums``: its accumulators stored),
    in full and split accumulation, on operands that press on alignment
    and truncation (``ops/scan_rounding.operands``: mixed exponents in one
    k16 step, a large product beside small ones, cancellation): every sum
    within csrc/scan_mma.cuh's bound of the float64 sum of the exact
    products, with each pair's own S (ratio at most 1)."""
    q, c = R.operands(d, 130, 4096, d, tdt, cuda_device)
    sums = K.scan_sums(q, c, 1024, split=mode == "split")
    assert R.rounding_ratio(q, c, sums, mode) <= 1.0


# ------------------------------------------- K3 and K2 on the tensor cores

# (tile, groups, B, D, byte offset of the corpus): tile/G from 2 to 2048,
# one or two warpgroups of queries, slices cut short (D=100, 390, 1100),
# rows TMA cannot describe (D % 16 != 0, or a corpus 1-3 bytes off 16-byte
# alignment: the producer warp copies them), and queries too wide to stay
# in shared memory (K3 past D=2816, K2 over codes past D=1408: they stream
# through the ring).
_PACKED_MMA_CASES = [(128, 64, 1, 64, 0), (128, 8, 33, 100, 1),
                     (128, 2, 130, 384, 0), (128, 1, 8, 390, 2),
                     (1024, 512, 64, 128, 0), (1024, 8, 130, 384, 3),
                     (1024, 16, 1024, 1100, 0), (4096, 8, 1024, 128, 0),
                     (4096, 2, 8, 390, 0), (16384, 8, 33, 64, 1),
                     (16384, 512, 1, 100, 0), (1024, 8, 130, 2048, 0),
                     (4096, 4, 64, 2048, 2)]
# Only K3 (exact) takes these: queries streamed at D=3100 and 4000.
_INT8_WIDE_CASES = [(1024, 8, 33, 4000, 0), (1024, 8, 8, 3100, 1)]


def _packed_case_data(tile, groups, b, d, tiles=6):
    """Unit queries and rows; rows tile+5 and tile+5+tile/G (one unit) equal
    to query 0, rows 2*tile+63 and 2*tile+64 (a 64-row chunk border) equal
    to the last query; and a ``size`` that leaves 5 live rows in tile
    tiles-2 and none in the last tile."""
    rng = np.random.default_rng(tile + 7 * b + d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((tile * tiles, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    small = tile // groups
    unit_pair = (tile + 5, tile + 5 + small) if groups > 1 else None
    c[2 * tile + 63] = c[2 * tile + 64] = q[-1]
    if unit_pair:
        c[unit_pair[0]] = c[unit_pair[1]] = q[0]
    return q, c, unit_pair, (tiles - 2) * tile + 5


def _offset(t, offset):
    """The same values ``offset`` bytes past a 16-byte boundary."""
    if not offset:
        return t
    step = offset // t.element_size() or 1
    buf = torch.zeros(t.numel() + step, dtype=t.dtype, device=t.device)
    buf[step:] = t.reshape(-1)
    out = buf[step:].view(t.shape)
    assert out.data_ptr() % 16
    return out


def _hold_packed_corners(w, w_p, tile, tiles, unit_pair):
    """The dead tile equals the twin's; of two equal rows in one unit that
    top their tile, the later row wins (the packed word's tie order)."""
    assert torch.equal(w[tiles - 1], w_p[tiles - 1])
    if unit_pair:
        assert int(w[1, 0, 0]) & (tile - 1) == unit_pair[1] - tile


@pytest.mark.parametrize("tile,groups,b,d,offset",
                         _PACKED_MMA_CASES + _INT8_WIDE_CASES)
def test_int8_tensor_core_scan_matches_twin(cuda_device, tile, groups, b, d,
                                            offset):
    """K3 on the tensor cores (wgmma s8 x s8 -> s32): its words bit for bit
    its twin's, with a padding tail, a dead tile and exact duplicate rows
    in one unit and across a chunk border."""
    q, c, unit_pair, size = _packed_case_data(tile, groups, b, d)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device))
    c8 = _offset(c8, offset)
    q8, qs = quantize_int8(torch.from_numpy(q).to(cuda_device))
    K.reset_launch_counts()
    w = K.packed_extract_int8(q8, qs, c8, cs, size, tile, groups)
    w_p = K.packed_extract_int8_plain(q8, qs, c8, cs, size, tile, groups)
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_extract_int8"] == 1
    assert torch.equal(w, w_p)
    _hold_packed_corners(w, w_p, tile, 6, unit_pair)


@pytest.mark.parametrize("rows", ["int8", "bf16"])
@pytest.mark.parametrize("tile,groups,b,d,offset", _PACKED_MMA_CASES)
def test_scaled_tensor_core_scan_matches_twin(cuda_device, rows, tile,
                                              groups, b, d, offset):
    """K2 on the tensor cores over int8 codes (widened to bf16 in registers)
    and over bf16 rows with row scales, held as K1 is: lower bounds within
    one quantisation step of the tile, no word at fault under
    ``packed_word_faults`` (drift 1e-5), the same corners as K3's."""
    q, c, unit_pair, size = _packed_case_data(tile, groups, b, d)
    qt = torch.from_numpy(q).to(cuda_device)
    c32 = torch.from_numpy(c).to(cuda_device)
    if rows == "int8":
        ct, cs = quantize_int8(c32)
    else:           # scaled values of unit norm: rows / cs, times cs
        cs = torch.rand(c.shape[0], device=cuda_device) * 0.5 + 0.5
        for lo, hi in ((2 * tile + 63, 2 * tile + 64), unit_pair or (0, 0)):
            cs[hi] = cs[lo]              # equal rows keep equal scores
        ct = (c32 / cs[:, None]).to(torch.bfloat16)
    ct = _offset(ct, offset)
    qb = qt.to(torch.bfloat16).float()
    rows_dtype = K.scaled_rows_dtype(ct)
    K.reset_launch_counts()
    w = K.packed_extract_scaled(qt, ct, cs, size, tile, groups)
    w_p = K.packed_extract_scaled_plain(qb, ct, cs, size, tile, groups)
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_extract_scaled"] == 1
    diff = (T._unpack_lb(w, tile) - T._unpack_lb(w_p, tile)).abs().max()
    assert float(diff) <= tile * 2.0 ** -22
    assert K.packed_word_faults(qb, ct, size, tile, w, w_p, row_scale=cs,
                                rows_dtype=rows_dtype, groups=groups)[0] == 0
    _hold_packed_corners(w, w_p, tile, 6, unit_pair)


@pytest.mark.parametrize("kernel", ["int8", "scaled"])
def test_int8_tensor_core_scans_range_flag(cuda_device, kernel):
    """A live row of codes scoring about -3 sets K3's and K2's flag; the
    same row as padding does not."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 96)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((1024, 96)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    qt = torch.from_numpy(q).to(cuda_device)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device))
    q8, qs = quantize_int8(qt)
    c8[700] = -q8[0]
    cs[700] = 3.0 / float((q8[0].float() ** 2).sum() * qs[0])
    for size, want in ((None, 1), (700, 0)):
        flag = K.new_flag(cuda_device)
        if kernel == "int8":
            K.packed_extract_int8(q8, qs, c8, cs, size, 128, 8, flag)
        else:
            K.packed_extract_scaled(qt, c8, cs, size, 128, 8, flag)
        assert int(flag[0]) == want, size


def test_scaled_tensor_core_scan_refuses_what_its_bound_does_not_cover(
        cuda_device):
    """K2 over codes and bf16 rows raises at (tile, D) pairs where the
    tensor cores' rounding could exceed one quantisation step (tile 128,
    D=640); K2 over f32 rows (the FMA kernel) and K3 (exact) take them."""
    q = torch.randn(4, 640, device=cuda_device)
    c8, cs = quantize_int8(torch.randn(1024, 640, device=cuda_device))
    assert K.scan_accumulation(128, 640, "codes") is None
    assert K.scan_accumulation(128, 640, "scaled") is None
    for ct in (c8, c8.to(torch.bfloat16)):
        with pytest.raises(ValueError, match="quantisation step"):
            K.packed_extract_scaled(q, ct, cs, None, 128, 8)
    K.packed_extract_scaled(q, c8.float(), cs, None, 128, 8)      # FMA
    q8, qs = quantize_int8(q)
    K.packed_extract_int8(q8, qs, c8, cs, None, 128, 8)             # exact


def test_scaled_tensor_core_scan_flags_queries_its_bound_does_not_cover(
        cuda_device):
    """At tile 128, D=384 over codes (split accumulation) the bound admits
    query norms up to ``scan_query_norm_limit(128, 384, "codes")`` (1.052):
    a query of norm 1.1 sets K2's range flag, one of norm 1.03 does not,
    and neither does any query at tile 1024."""
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((1024, 384)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c8, cs = quantize_int8(torch.from_numpy(c).to(cuda_device) * 0.05)
    assert 1.03 < K.scan_query_norm_limit(128, 384, "codes") < 1.1
    for scale, tile, want in ((1.1, 128, 1), (1.03, 128, 0), (1.1, 1024, 0)):
        qt = torch.from_numpy(q).to(cuda_device)
        qt[1] *= scale
        flag = K.new_flag(cuda_device)
        K.packed_extract_scaled(qt, c8, cs, None, tile, 8, flag)
        assert int(flag[0]) == want, (scale, tile)


@pytest.mark.parametrize("mode", ["full", "split"])
@pytest.mark.parametrize("d", [64, 100, 128, 384, 1536, 2048])
def test_scaled_tensor_core_sums_within_rounding_bound(cuda_device, d, mode):
    """K2's main loop over int8 codes (``scan_sums`` of a code corpus: the
    codes widened to bf16 in registers, its accumulators stored), in full
    and split accumulation, on codes of +-127 beside small ones, sums that
    cancel and row scales over six binades
    (``ops/scan_rounding.code_operands``): every raw sum within
    csrc/scan_mma.cuh's bound of the float64 sum of the exact products,
    and every scaled score (the sum times its row scale, rounded) within
    the scaled bound, with each pair's own S."""
    q, c, cs = R.code_operands(d, 130, 4096, d, cuda_device)
    sums = K.scan_sums(q, c, 1024, split=mode == "split")
    assert R.rounding_ratio(q, c, sums, mode) <= 1.0
    assert R.rounding_ratio(q, c, sums, mode, row_scale=cs) <= 1.0
