"""The certificate's cushion under the tensor-core scan's drift, on the CPU.

K1 over bf16/f16 rows and K2 over int8 codes keep the tensor cores' f32
sums, so their scores differ from the exact ones by up to delta(D)
(``topk_kernels.scan_drift_bound``, the bound that csrc/scan_mma.cuh's
header argues; for K2 the sum times the row scale). Here a packer written
in the test replaces the port's K1 (``ops.topk.packed_extract``) or K2
(``ops.topk.packed_extract_scaled``, the scaled route of an int8 corpus,
``int8_native=False``): the twin's scores moved by delta with seeded
random signs, all +delta or all -delta, then packed as
``_pack_tile_scores`` packs them. At every tile the kernel takes, over
corpora with near-duplicate runs, each certified answer whose certificate
reads 0 must have the exact oracle's ids; at delta = 0 the packer equals
the twin (``packed_extract_plain``, ``packed_extract_scaled_plain``) word
for word and the answers equal the JAX package's ``pallas_topk_certified``
(Pallas in interpret mode). The same data tells a sound scan from an
unsound one at each tile: a scan 1.5 or 2 quanta low certifies wrong
answers there (the argument's limit is one quantum).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimized_rag_tpu.ops import topk as J
from optimized_rag_tpu_torch.ops import scan_rounding as R
from optimized_rag_tpu_torch.ops import topk as T
from optimized_rag_tpu_torch.ops import topk_kernels as K
from optimized_rag_tpu_torch.ops.quantize import quantize_int8

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


def _store(rows, route):
    """Float rows [P, d] as the route stores them: (bf16 rows, None) for
    K1, (int8 codes, row scales) from ``quantize_int8`` for K2."""
    if route == "dense":
        return rows.to(torch.bfloat16), None
    return quantize_int8(rows)


def _scan_scores(stored, cs, qs):
    """The scan's function of stored rows against the scan query ``qs``:
    an f32 sum of exact products, times the row scale for K2."""
    s = stored.float() @ qs
    return s if cs is None else s * cs


def _row_in(rng, q, qs, lo, hi, route="dense", pool=4096):
    """A unit row, stored as the route stores it, whose scan score against
    ``qs`` (``q`` rounded to bf16) lies in [lo, hi]: (stored row, its scale
    or None), drawn from a pool aimed at the middle, since bf16 rounding
    or quantisation moves a score by more than a quantum."""
    while True:
        n = rng.standard_normal((pool, q.shape[0])).astype(np.float32)
        n -= (n @ q)[:, None] * q
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        cos = (lo + hi) / 2
        rows = torch.from_numpy(cos * q + np.sqrt(1 - cos * cos) * n)
        stored, cs = _store(rows.float(), route)
        s = _scan_scores(stored, cs, qs)
        hit = ((s >= lo) & (s <= hi)).nonzero()
        if hit.numel():
            i = int(hit[0, 0])
            return stored[i], None if cs is None else cs[i]


@functools.lru_cache(maxsize=None)     # the tests read it and never write
def _data(tile, d, tiles, route="dense"):
    """Unit queries and rows (bf16 for K1; int8 codes with row scales for
    K2: returns (q, corpus, row_scale or None)), in two kinds. The levels
    below are of the scan's score.

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
    rng = np.random.default_rng(tile + d + (route != "dense"))
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
    placed = {}
    for bi in range(BANDS, B):
        beta = np.floor((0.62 + 0.06 * (bi - BANDS)) / quantum) * quantum

        def row(a, z):
            return _row_in(rng, q[bi], qs[bi], beta + a * quantum,
                           beta + z * quantum, route)
        own = (bands + bi - BANDS) * tile
        placed[own + 20] = row(5.9, 6.1)                          # A
        placed[own + 21] = row(1.3, 1.45)                         # B
        placed[own + 22] = row(1.15, 1.28)                        # H
        unit = shared + 1 + bi - BANDS
        for g in range(GROUPS - 1):
            placed[unit + g * small] = row(2.5 + 0.4 * g, 2.6 + 0.4 * g)
        placed[unit + (GROUPS - 1) * small] = row(1.02, 1.12)     # T
    corpus, cs = _store(torch.from_numpy(c), route)
    for r, (stored, scale) in placed.items():
        corpus[r] = stored
        if cs is not None:
            cs[r] = scale
    if route == "dense":
        return q, corpus
    return q, corpus, cs


def _moved_pack(s, delta, signs, seed, size, tile, groups):
    """The scores [B, N] moved by ``delta`` (``signs`` "random" (seeded),
    "plus" or "minus"), packed as K1 packs them: words [T, 2, B]."""
    if signs == "random":
        gen = torch.Generator().manual_seed(seed)
        s = s + delta * (2.0 * torch.randint(0, 2, s.shape,
                                             generator=gen) - 1.0)
    else:
        s = s + (delta if signs == "plus" else -delta)
    b, n = s.shape
    live = torch.arange(n) < (n if size is None else size)
    sh = torch.where(live, torch.clamp_min(s + 2.0, 0.0), 0.0)
    col = torch.arange(n, dtype=torch.int32) % tile
    packed = (sh.view(torch.int32) & -tile) | col                 # [B, N]
    units = packed.view(b, n // tile, groups, tile // groups).amax(2)
    w0 = units.amax(-1)
    w1 = torch.where(units == w0[..., None], 0, units).amax(-1)
    return torch.stack([w0.T, w1.T], dim=1).contiguous()         # [T, 2, B]


def _packer(delta, signs, seed):
    """K1's function on the twin's scores moved by ``delta``: ``signs``
    "random" (seeded), "plus" or "minus"."""
    def packed_extract(queries, corpus, size, tile, groups=8, flag=None):
        q = K._scan_queries(queries, corpus)
        return _moved_pack(q @ corpus.float().T, delta, signs, seed, size,
                           tile, groups)
    return packed_extract


def _scaled_packer(delta, signs, seed):
    """K2's function (the queries rounded to bf16, an f32 sum, x row scale)
    on the twin's scores moved by ``delta``."""
    def packed_extract_scaled(queries, corpus, row_scale, size, tile,
                              groups=8, flag=None):
        q = K._bf16_queries(queries)
        return _moved_pack((q @ corpus.float().T) * row_scale, delta, signs,
                           seed, size, tile, groups)
    return packed_extract_scaled


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


# ------------------------------------------- the scaled route (K2 over codes)

def _scaled_oracle(q, c8, cs):
    """The scaled route's exact top-k: bf16(q) x codes in f32, x scale."""
    ref = (torch.from_numpy(q).to(torch.bfloat16).float() @ c8.float().T) \
        * cs
    s, i = torch.sort(ref, dim=1, descending=True, stable=True)
    return s[:, :K_TOP], i[:, :K_TOP]


@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_scaled_drift_packer_at_zero_is_the_twin(tile, d, tiles):
    q, c8, cs = _data(tile, d, tiles, "codes")
    assert c8.dtype == torch.int8
    qt = torch.from_numpy(q)
    size = c8.shape[0] - 77
    words = _scaled_packer(0.0, "plus", 0)(qt, c8, cs, size, tile, GROUPS)
    assert torch.equal(words, K.packed_extract_scaled_plain(
        K._bf16_queries(qt), c8, cs, size, tile, GROUPS))


@pytest.mark.parametrize("signs", ["zero", "random", "plus", "minus"])
@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_scaled_certified_is_exact_under_scan_drift(monkeypatch, tile, d,
                                                    tiles, signs):
    """The scaled route (int8 codes, ``int8_native=False``): certificate 0
    means the oracle's ids, with K2's scores off by its delta."""
    q, c8, cs = _data(tile, d, tiles, "codes")
    delta = (0.0 if signs == "zero"
             else K.scan_drift_bound(tile, d, "codes"))
    assert delta < tile * 2.0 ** -22             # below one quantum
    monkeypatch.setattr(T, "packed_extract_scaled",
                        _scaled_packer(delta, signs, tile + d))
    o_s, o_i = _scaled_oracle(q, c8, cs)
    qt = torch.from_numpy(q)
    kw = dict(tile=tile, groups=GROUPS, row_scale=cs, int8_native=False)
    s, ids = T.topk_certified(qt, c8, K_TOP, **kw)
    s_m, ids_m = T.topk_certified_multi(qt, c8, K_TOP, sub_batch=B // 2,
                                        **kw)
    for scores, i in ((s, ids), (s_m, ids_m)):
        if T.certificate_uncovered(i) == 0:
            assert torch.equal(i[:-1], o_i)
            assert float((scores - o_s).abs().max()) <= 1e-5
    assert T.certificate_uncovered(ids) == 0     # the data certifies


@pytest.mark.parametrize("quanta", [1.5, 2.0])
@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_scaled_drift_past_the_cushion_certifies_wrong_answers(
        monkeypatch, tile, d, tiles, quanta):
    """A K2 that reads every scaled score 1.5 or 2 quanta low gets a
    certificate of 0 for answers that miss rows of the exact top k."""
    q, c8, cs = _data(tile, d, tiles, "codes")
    monkeypatch.setattr(T, "packed_extract_scaled", _scaled_packer(
        quanta * tile * 2.0 ** -22, "minus", 0))
    _, o_i = _scaled_oracle(q, c8, cs)
    _, ids = T.topk_certified(torch.from_numpy(q), c8, K_TOP, tile=tile,
                              groups=GROUPS, row_scale=cs, int8_native=False)
    assert T.certificate_uncovered(ids) == 0
    assert not torch.equal(ids[BANDS:-1], o_i[BANDS:])


@pytest.mark.parametrize("tile,d,tiles", CASES)
def test_scaled_certified_at_zero_drift_matches_jax(tile, d, tiles):
    q, c8, cs = _data(tile, d, tiles, "codes")
    _, pj = J.pallas_topk_certified(
        jnp.asarray(q), jnp.asarray(c8.numpy()), K_TOP, tile=tile,
        groups=GROUPS, interpret=True, row_scale=jnp.asarray(cs.numpy()),
        int8_native=False)
    _, pt = T.topk_certified(torch.from_numpy(q), c8, K_TOP, tile=tile,
                             groups=GROUPS, row_scale=cs, int8_native=False)
    assert int(np.asarray(pj)[-1, 0]) == int(pt[-1, 0]) == 0
    np.testing.assert_array_equal(np.asarray(pj)[:-1], pt[:-1].numpy())


def test_scaled_scan_accumulation_rule_matches_the_header():
    """The (tile, D) pairs csrc/scan_mma.cuh's header says K2 takes over
    int8 codes ("codes") and bf16 rows ("scaled"), in which accumulation,
    and where it refuses; its S_max and drift at the benchmark's shape; K1's
    edges unchanged by the route parameter."""
    edges = {"codes": {128: (128, 401), 256: (270, 817), 1024: (640, 3091),
                       4096: (640, 10795)},
             "scaled": {128: (144, 436), 256: (288, 913),
                        1024: (640, 3776), 4096: (640, 15227)}}
    for route, by_tile in edges.items():
        for tile, (full, split) in by_tile.items():
            assert K.scan_accumulation(tile, full, route) == "full"
            assert K.scan_accumulation(tile, full + 1, route) == "split"
            assert K.scan_accumulation(tile, split, route) == "split"
            assert K.scan_accumulation(tile, split + 1, route) is None
    assert K.scan_accumulation(4096, 128, "codes") == "full"  # bench_shape
    assert K.scan_accumulation(128, 384, "codes") == "split"
    s_max, e = K._scan_terms(128, "codes")
    assert abs(s_max - 1.01 * (1 + 128 ** 0.5 / 254)) < 1e-12 and e == 2
    assert 1.054 < s_max < 1.055
    assert 1.087 < K._scan_terms(384, "codes")[0] < 1.088
    for route in ("codes", "scaled"):
        for tile, d in ((128, 384), (1024, 384), (4096, 128), (1024, 3000)):
            # normalised queries fit under every limit the rule admits
            assert K.scan_query_norm_limit(tile, d, route) > 1.0 + 2.0 ** -8
            s_max, e = K._scan_terms(d, route)
            assert K.scan_drift_bound(tile, d, route) + s_max * (
                d + e / 2) * 2.0 ** -24 <= tile * 2.0 ** -22
    assert K.scan_accumulation(128, 438) == "split"           # K1 as before
    with pytest.raises(ValueError, match="route"):
        K.scan_accumulation(1024, 384, "int8")


@pytest.mark.parametrize("d", [100, 390])
def test_int8_scan_from_query_codes_gives_the_twins_words(d):
    """K3 on the tensor cores takes the query codes as they are, K-major
    [B, D] (no packed words), in slices of 128 codes with zeros past D, and
    sums them exactly in int32, then (float(sum) x cs) x qs. That function,
    written out here slice by slice in 32-code steps (a wgmma k32 step) and
    packed chunk by chunk in the kernel's order (64-row chunks, the group
    innermost, per-unit maxima then the top two), gives the twin's words
    bit for bit at widths that cut a slice short."""
    tile, groups, b = 256, 4, 5
    rng = np.random.default_rng(d)
    q = rng.standard_normal((b, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = rng.standard_normal((tile * 4, d)).astype(np.float32)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    c[tile + 3] = c[tile + 3 + tile // groups] = q[0]     # one unit's pair
    c8, cs = quantize_int8(torch.from_numpy(c))
    q8, qs = quantize_int8(torch.from_numpy(q))
    size = 3 * tile + 9
    width = -(-d // 128) * 128
    q_pad = torch.nn.functional.pad(q8, (0, width - d)).to(torch.int64)
    c_pad = torch.nn.functional.pad(c8, (0, width - d)).to(torch.int64)
    acc = torch.zeros((c8.shape[0], b), dtype=torch.int64)
    for k0 in range(0, width, 32):                        # wgmma k32 steps
        acc += c_pad[:, k0:k0 + 32] @ q_pad[:, k0:k0 + 32].T
    assert int(acc.abs().max()) < 2 ** 31
    score = (acc.to(torch.int32).float() * cs[:, None]) * qs[None, :]
    small, mask = tile // groups, -tile
    words = torch.zeros((c8.shape[0] // tile, 2, b), dtype=torch.int32)
    for t in range(c8.shape[0] // tile):
        unit_max = torch.zeros((small, b), dtype=torch.int32)
        for j in range(0, small, 64):                     # the group inner
            for g in range(groups):
                rows = torch.arange(64) + g * small + j   # a 64-row chunk
                v = score[t * tile + rows]
                live = (t * tile + rows < size)[:, None]
                bits = (torch.clamp_min(v + 2.0, 0.0).view(torch.int32)
                        & mask)
                packed = torch.where(live, bits, 0) | rows[:, None].to(
                    torch.int32)
                unit_max[j:j + 64] = torch.maximum(unit_max[j:j + 64],
                                                   packed)
        w0 = unit_max.amax(0)
        w1 = torch.where(unit_max == w0, 0, unit_max).amax(0)
        words[t, 0], words[t, 1] = w0, w1
    twin = K.packed_extract_int8(q8, qs, c8, cs, size, tile, groups)
    assert torch.equal(twin, K.packed_extract_int8_plain(
        q8, qs, c8, cs, size, tile, groups))
    assert torch.equal(words, twin)
    assert int(words[1, 0, 0]) & (tile - 1) == 3 + tile // groups
