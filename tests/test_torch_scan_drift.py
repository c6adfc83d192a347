"""The certificate's cushion under the tensor-core scan's drift, on the CPU.

K1 over bf16/f16 rows keeps the tensor cores' f32 sums, which differ from
the exact sums by up to delta(D) (``topk_kernels.scan_drift_bound``, the
bound that csrc/scan_mma.cuh's header argues). Here a packer written in
the test replaces the port's K1 (``ops.topk.packed_extract``): the twin's
scores moved by delta with seeded random signs, all +delta or all -delta,
then packed as ``_pack_tile_scores`` packs them. At every tile the kernel
takes, over corpora with near-duplicate runs, each certified answer whose
certificate reads 0 must have the exact oracle's ids; at delta = 0 the
packer equals ``packed_extract_plain`` word for word and the answers equal
the JAX package's ``pallas_topk_certified`` (Pallas in interpret mode).
The same data tells a sound scan from an unsound one at each tile: a scan
1.5 or 2 quanta low certifies wrong answers there (the argument's limit is
one quantum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu_torch.ops import scan_rounding as R
from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import topk_kernels as K

K_TOP, B, GROUPS = 10, 6, 8
BANDS = 3        # queries 0-2: bands and runs; 3-5: one hidden row each
# (tile, D, tiles): tile 128 takes D=384 with split accumulation, 1024 and
# 4096 accumulate in full (the served and the benchmark's shapes). The last
# four tiles hold the hidden-row queries' rows alone.
CASES = [(128, 384, 48), (1024, 384, 16), (4096, 128, 12)]


def _level_row(rng, q, cos):
    """A unit row scoring ``cos`` against the unit query ``q``."""
    n = rng.standard_normal(q.shape[0]).astype(np.float32)
    n -= (n @ q) * q
    return cos * q + np.sqrt(1 - cos * cos) * n / np.linalg.norm(n)


def _row_in(rng, q, qs, lo, hi, pool=4096):
    """A bf16 unit row whose f32 score against the scan query ``qs`` (``q``
    rounded to bf16) lies in [lo, hi]: drawn from a pool aimed at the
    middle, since bf16 rounding moves a score by more than a quantum."""
    while True:
        n = rng.standard_normal((pool, q.shape[0])).astype(np.float32)
        n -= (n @ q)[:, None] * q
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        cos = (lo + hi) / 2
        rows = torch.from_numpy(cos * q + np.sqrt(1 - cos * cos) * n)
        rows = rows.to(torch.bfloat16).float()
        s = rows @ qs
        hit = ((s >= lo) & (s <= hi)).nonzero()
        if hit.numel():
            return rows[int(hit[0, 0])].numpy()


def _data(tile, d, tiles):
    """Unit queries and bf16 rows, in two kinds.

    Queries 0-2: the top k lies in a band of a few quanta around one level
    per query (0.6 + 0.05 b): in up to 6 tiles, three rows in three units,
    so that each tile's third row hides behind its two unit winners; and a
    run of 24 near-duplicate rows (noise 2e-3) at the same level, crossing
    a 64-row chunk border and a tile border.

    Queries 3-5, placed against the quantisation grid (beta a boundary, q
    one quantum): in a tile of their own, unit winners A (beta + 6q) and
    B (beta + 1.3q to 1.45q) and, in a third unit, H (beta + 1.15q to
    1.28q), which only c2 finds; in one unit of a shared tile, seven rows
    from beta + 2.5q up and T (beta + 1.02q to 1.12q), which c1 rescores,
    so tau = T < H. The tile of B stays in c2 while the scan reads B within
    a quantum (its upper bound is at least beta + 3q); a scan 1.5 or 2
    quanta low puts that bound at beta + q <= tau and certifies T in H's
    place."""
    rng = np.random.default_rng(tile + d)
    q = rng.standard_normal((B, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qs = torch.from_numpy(q).to(torch.bfloat16).float()
    c = rng.standard_normal((tile * tiles, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    quantum, small, bands = tile * 2.0 ** -22, tile // GROUPS, tiles - 4
    for bi in range(BANDS):
        level = 0.6 + 0.05 * bi
        for j in range(min(6, bands)):
            t = (bi * 5 + j) % bands
            for r in range(3):
                c[t * tile + 100 + 3 * bi + r] = _level_row(
                    rng, q[bi], level + quantum * rng.uniform(-0.5, 0.5))
        start = ((2 * bi + 1) * tile - 12) % (tile * bands - 24)
        run = _level_row(rng, q[bi], level) + 2e-3 * rng.standard_normal(
            (24, d))
        c[start:start + 24] = run / np.linalg.norm(run, axis=1,
                                                   keepdims=True)
    shared = (tiles - 1) * tile
    for bi in range(BANDS, B):
        beta = np.floor((0.62 + 0.06 * (bi - BANDS)) / quantum) * quantum

        def row(a, z):
            return _row_in(rng, q[bi], qs[bi], beta + a * quantum,
                           beta + z * quantum)
        own = (bands + bi - BANDS) * tile
        c[own + 20] = row(5.9, 6.1)                               # A
        c[own + 21] = row(1.3, 1.45)                              # B
        c[own + 22] = row(1.15, 1.28)                             # H
        unit = shared + 1 + bi - BANDS
        for g in range(GROUPS - 1):
            c[unit + g * small] = row(2.5 + 0.4 * g, 2.6 + 0.4 * g)
        c[unit + (GROUPS - 1) * small] = row(1.02, 1.12)          # T
    return q, torch.from_numpy(c).to(torch.bfloat16)


def _packer(delta, signs, seed):
    """K1's function on the twin's scores moved by ``delta``: ``signs``
    "random" (seeded), "plus" or "minus"."""
    def packed_extract(queries, corpus, size, tile, groups=8, flag=None):
        q = K._scan_queries(queries, corpus)
        s = q @ corpus.float().T                                  # [B, N]
        if signs == "random":
            gen = torch.Generator().manual_seed(seed)
            s = s + delta * (2.0 * torch.randint(0, 2, s.shape,
                                                 generator=gen) - 1.0)
        else:
            s = s + (delta if signs == "plus" else -delta)
        n = corpus.shape[0]
        live = torch.arange(n) < (n if size is None else size)
        sh = torch.where(live, torch.clamp_min(s + 2.0, 0.0), 0.0)
        col = torch.arange(n, dtype=torch.int32) % tile
        packed = (sh.view(torch.int32) & -tile) | col             # [B, N]
        units = packed.view(q.shape[0], n // tile, groups,
                             tile // groups).amax(2)
        w0 = units.amax(-1)
        w1 = torch.where(units == w0[..., None], 0, units).amax(-1)
        return torch.stack([w0.T, w1.T], dim=1).contiguous()     # [T, 2, B]
    return packed_extract


def _oracle(q, c):
    return T.exact_topk(torch.from_numpy(q).to(torch.bfloat16).float(), c,
                        K_TOP)


@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_drift_packer_at_zero_is_the_twin(tile, d, tiles):
    q, c = _data(tile, d, tiles)
    qt = torch.from_numpy(q)
    size = c.shape[0] - 77
    words = _packer(0.0, "plus", 0)(qt, c, size, tile, GROUPS)
    assert words.dtype == torch.int32
    assert torch.equal(words, K.packed_extract_plain(
        K._scan_queries(qt, c), c, size, tile, GROUPS))


@pytest.mark.parametrize("signs", ["zero", "random", "plus", "minus"])
@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_certified_is_exact_under_scan_drift(monkeypatch, tile, d, tiles,
                                             signs):
    """Certificate 0 means the oracle's ids, with the scan off by delta."""
    q, c = _data(tile, d, tiles)
    delta = 0.0 if signs == "zero" else K.scan_drift_bound(tile, d)
    assert delta < tile * 2.0 ** -22             # below one quantum
    monkeypatch.setattr(T, "packed_extract",
                        _packer(delta, signs, tile + d))
    o_s, o_i = _oracle(q, c)
    qt = torch.from_numpy(q)
    s, ids = T.topk_certified(qt, c, K_TOP, tile=tile, groups=GROUPS)
    s_m, ids_m = T.topk_certified_multi(qt, c, K_TOP, sub_batch=B // 2,
                                        tile=tile, groups=GROUPS)
    for scores, i in ((s, ids), (s_m, ids_m)):
        if T.certificate_uncovered(i) == 0:
            assert torch.equal(i[:-1], o_i)
            assert float((scores - o_s).abs().max()) <= 1e-5
    assert T.certificate_uncovered(ids) == 0     # the data certifies


@pytest.mark.parametrize("quanta", [1.5, 2.0])
@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_drift_past_the_cushion_certifies_wrong_answers(monkeypatch, tile, d,
                                                        tiles, quanta):
    """The data can tell: a scan that reads every score 1.5 or 2 quanta low
    (the argument allows one) gets a certificate of 0 for answers that
    miss rows of the exact top k."""
    q, c = _data(tile, d, tiles)
    monkeypatch.setattr(T, "packed_extract", _packer(
        quanta * tile * 2.0 ** -22, "minus", 0))
    _, o_i = _oracle(q, c)
    _, ids = T.topk_certified(torch.from_numpy(q), c, K_TOP, tile=tile,
                              groups=GROUPS)
    assert T.certificate_uncovered(ids) == 0
    assert not torch.equal(ids[BANDS:-1], o_i[BANDS:])


@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_certified_at_zero_drift_matches_jax(tile, d, tiles):
    q, c = _data(tile, d, tiles)
    cj = jnp.asarray(c.float().numpy()).astype(jnp.bfloat16)
    _, pj = J.pallas_topk_certified(jnp.asarray(q), cj, K_TOP, tile=tile,
                                    groups=GROUPS, interpret=True)
    _, pt = T.topk_certified(torch.from_numpy(q), c, K_TOP, tile=tile,
                             groups=GROUPS)
    assert int(np.asarray(pj)[-1, 0]) == int(pt[-1, 0]) == 0
    np.testing.assert_array_equal(np.asarray(pj)[:-1], pt[:-1].numpy())


def _tile_of(rows, tile=128, d=8):
    """A query and a tile of rows scoring 0 except ``rows`` {col: score}."""
    q = torch.zeros(1, d)
    q[0, 0] = 1.0
    corpus = torch.zeros(tile, d)
    corpus[:, 1] = 1.0                                    # every score 0
    for col, s in rows.items():
        corpus[col, 0], corpus[col, 1] = s, (1 - s * s) ** 0.5
    return q, corpus


def _word(s, col, tile=128):
    return int(K._quantise(torch.tensor(s), tile)) | col


def _pair(w1, w2):
    return torch.tensor([[[w1], [w2]]], dtype=torch.int32)   # [T, 2, B]


@pytest.mark.parametrize("x_score,faults", [(0.5 - 1e-7, 0),
                                            (0.5 - 1.2e-5, 2)])
def test_word_faults_allow_a_boundary_row_to_reorder_the_words(x_score,
                                                               faults):
    """Rows X (column 3), A (20) and C (40) of one tile, in three units,
    all quantise to the step just below 0.5 except X where it sits on that
    boundary: one scan ranks X first (words X, C), the other third (words
    C, A). With X on the boundary (within drift 1e-5) both pairs are exact
    packings of the tile and each passes against the other, although both
    second words name rows off the boundary. With X off it, (C, A) is the
    tile's packing and still passes, while (X, C) is two faults: X cannot
    reach the step above, and C stands where A belongs."""
    tile = 128
    q, corpus = _tile_of({3: x_score, 20: 0.5 - 2e-5, 40: 0.5 - 1.5e-5})
    step_down = 0.5 - tile * 2.0 ** -22 / 2
    ranked_first = _pair(_word(0.5, 3), _word(step_down, 40))
    ranked_third = _pair(_word(step_down, 40), _word(step_down, 20))
    assert K.packed_word_faults(q, corpus, None, tile, ranked_third,
                                ranked_first)[0] == 0
    assert K.packed_word_faults(q, corpus, None, tile, ranked_first,
                                ranked_third)[0] == faults


@pytest.mark.parametrize("b_score,c_col,faults", [
    (0.5 + 2e-6, 30, 1),     # B on the boundary, C's column below B's
    (0.5 + 2e-6, 60, 0),     # B on the boundary, C's column above B's
    (0.5 + 1.5e-5, 60, 1)])  # B off the boundary
def test_word_faults_catch_a_third_winner_in_place_of_the_second(
        b_score, c_col, faults):
    """Unit winners A (column 10, well above) and B (50, just above the
    boundary 0.5), and in a third unit C, one step below B. A pair (A, C)
    is the tile's packing only where B may quantise one step down (within
    drift 1e-5 of the boundary) and C then outranks it by its column; else
    C standing in for B is a fault, although B sits next to a boundary."""
    tile = 128
    step = tile * 2.0 ** -22
    q, corpus = _tile_of({10: 0.7, 50: b_score, c_col: 0.5 - step / 2})
    ref = _pair(_word(0.7, 10), _word(b_score, 50))
    third = _pair(_word(0.7, 10), _word(0.5 - step / 2, c_col))
    assert K.packed_word_faults(q, corpus, None, tile, third, ref) == (
        faults, 1 - faults)


def test_scan_accumulation_rule_matches_the_header():
    """The (tile, D) pairs csrc/scan_mma.cuh's header says K1 takes, in
    which accumulation, and where it refuses; F's accumulation: the rule's
    one home."""
    edges = {128: (144, 438), 256: (288, 915), 1024: (640, 3778),
             4096: (640, 15229)}
    for tile, (full, split) in edges.items():
        assert K.scan_accumulation(tile, full) == "full"
        assert K.scan_accumulation(tile, full + 1) == "split"
        assert K.scan_accumulation(tile, split) == "split"
        assert K.scan_accumulation(tile, split + 1) is None
    assert K.scan_accumulation(1024, 384) == "full"      # the served shape
    assert K.scan_accumulation(4096, 128) == "full"      # the benchmark's
    assert K.scan_accumulation(None, 640) == "full"      # F
    assert K.scan_accumulation(None, 641) == "split"
    for tile, d in ((128, 438), (1024, 384), (4096, 128), (1024, 3778)):
        # normalised queries fit under every limit the rule admits
        assert K.scan_query_norm_limit(tile, d) > 1.0 + 2.0 ** -8
        assert K.scan_drift_bound(tile, d) + 1.01 * d * 2.0 ** -24 <= (
            tile * 2.0 ** -22)


@pytest.mark.parametrize("d", [64, 100, 384])
@pytest.mark.parametrize("tdt", [torch.bfloat16, torch.float16])
def test_rounding_operands_press_on_the_bound(tdt, d):
    """``scan_rounding.operands`` gives unit rows and queries in the dtype's
    values, with sums that cancel to far below S; the plain twin of the
    raw sums (an f32 matmul, whose error is at most D u S) stays within the
    full-accumulation bound, which is 2.5 times wider."""
    q, c = R.operands(d, 16, 512, d, tdt, "cpu")
    assert c.dtype == tdt and torch.equal(q, q.to(tdt).float())
    assert float((c.float().norm(dim=1) - 1).abs().max()) < 2.0 ** -7
    exact = c.double() @ q.double().T
    s = c.double().abs() @ q.double().abs().T
    assert float((exact.abs() / s).min()) < 1e-3          # cancellation
    sums = K.scan_sums(q, c, 128)
    assert R.rounding_ratio(q, c, sums, "full") <= 1.0
