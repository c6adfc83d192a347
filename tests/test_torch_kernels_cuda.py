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
by less than that drift, where the kernel's row must score its value.
K3's words and K5b's values and columns are bit for bit their twins' (the
int8-native score is exact in float32); K7 is held as K6 is.
"""

import numpy as np
import pytest
import torch

from optimized_rag_tpu_torch.ops import topk as T
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


def _agree(q, c, rows, vals, rows_ref, vals_ref, tol=1e-5):
    assert float((vals - vals_ref).abs().max()) <= tol
    mism = rows != rows_ref
    if bool(mism.any()):
        b_idx = torch.arange(q.shape[0], device=q.device).expand_as(rows)
        s = (c[rows[mism].long()].float() * q[b_idx[mism]]).sum(-1)
        assert float((s - vals[mism]).abs().max()) <= tol


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
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
    with pytest.raises(ValueError, match="shared memory"):
        K.tile_topk(q, torch.randn(4096, 64, device=cuda_device), None,
                    2048, 4)
    with pytest.raises(TypeError, match="dtype"):
        K.tile_topk(q, torch.randn(1024, 64, device=cuda_device).half(),
                    None, 1024, 4)
    c8 = torch.zeros((1024, 66), dtype=torch.int8, device=cuda_device)
    cs = torch.ones(1024, device=cuda_device)
    q8 = torch.zeros((4, 66), dtype=torch.int8, device=cuda_device)
    qs = torch.ones(4, device=cuda_device)
    with pytest.raises(ValueError, match="D % 4"):
        K.packed_extract_int8(q8, qs, c8, cs, None, 128, 8)
    with pytest.raises(ValueError, match="row_scale"):
        K.tile_topk_scaled(q, c8[:, :64].contiguous(), cs[:512], None, 128,
                           4)
