"""The packing epilogue's per-score arithmetic against its longer form.

csrc/scan_mma.cuh packs a live score v of K1, K2 and K3 as
``(bits(v + 2) & -tile) | row`` and raises the range flag from bit 30 of
the OR of the live scores' bits. The function it computes is the
reference's (``_pack_tile_scores``): ``(bits(max(v + 2, 0)) & -tile) |
row``, and a flag wherever a live ``|v| >= 2``. The two agree because

* for v in (-2, 2) the float32 sum v + 2 is positive (at least 2**-23), so
  the max with 0 changes nothing;
* for a finite v, bit 30 (the exponent's top bit) is set exactly when
  ``|v| >= 2``; it is also set for infinities (flagged by both) and NaNs
  (flagged only by the short form: a stricter check on inputs outside the
  precondition).

Here both forms run over float32 in numpy: random draws, the edges of
(-2, 2), the quantisation boundaries of the words at tiles 1024 and 4096
and one ulp either side of each, every float32 within 2**16 ulps of +-2,
and a sweep over random bit patterns.
"""

import numpy as np
import pytest

TWO = np.float32(2.0)
FLAG_BIT = 0x40000000


def _word(v, col, tile):
    """The word as the kernel now forms it."""
    return ((v + TWO).view(np.int32) & np.int32(-tile)) | col


def _word_reference(v, col, tile):
    """The word as the reference forms it: max(v + 2, 0) first."""
    return (np.maximum(v + TWO, np.float32(0.0)).view(np.int32)
            & np.int32(-tile)) | col


def _bits(u):
    return np.asarray(u, dtype=np.uint32).view(np.float32)


def _random(rng, tile):
    return np.concatenate([
        rng.uniform(-2.0, 2.0, 1 << 18).astype(np.float32),
        (rng.standard_normal(1 << 18) * 0.3).astype(np.float32),
        (rng.standard_normal(1 << 16) * 1e-30).astype(np.float32)])


def _edges(rng, tile):
    lo = np.nextafter(-TWO, TWO)                 # just above -2
    hi = np.nextafter(TWO, -TWO)                 # just below 2
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    v = np.array([lo, np.nextafter(lo, TWO), -0.0, 0.0, tiny, -tiny, hi,
                  np.nextafter(hi, -TWO), -1.0, 1.0, -0.5, 0.5],
                 dtype=np.float32)
    return np.concatenate([v, np.nextafter(v, TWO), np.nextafter(v, -TWO)])


def _quantum_boundaries(rng, tile):
    """v with v + 2 on a word's boundary (low log2(tile) bits clear) in
    (0, 4), and one ulp either side."""
    f = _bits(np.arange(tile, 0x40800000, tile, dtype=np.uint64))
    v = f - TWO                 # exact for f in [1, 4], rounded below 1
    return np.concatenate([v, np.nextafter(v, TWO), np.nextafter(v, -TWO)])


def _near_two(rng, tile):
    """Every float32 within 2**16 ulps of 2 and of -2."""
    k = np.arange(-(1 << 16), (1 << 16) + 1, dtype=np.int64)
    return np.concatenate([_bits(0x40000000 + k), _bits(0xC0000000 + k)])


def _sweep(rng, tile):
    return _bits(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64))


def _nonfinite(rng, tile):
    nan = rng.integers(0x7F800001, 0x80000000, 1 << 12, dtype=np.uint64)
    return np.concatenate([_bits(nan), _bits(nan | 0x80000000),
                           np.array([np.inf, -np.inf], dtype=np.float32)])


CASES = {"random": _random, "edges": _edges,
         "quantum_boundaries": _quantum_boundaries, "near_two": _near_two,
         "sweep": _sweep, "nonfinite": _nonfinite}


@pytest.mark.parametrize("tile", [1024, 4096])
@pytest.mark.parametrize("case", sorted(CASES))
def test_trimmed_packing_computes_the_reference_words_and_flag(case, tile):
    rng = np.random.default_rng(tile + len(case))
    v = CASES[case](rng, tile).astype(np.float32)
    flag = (v.view(np.int32) & FLAG_BIT) != 0
    with np.errstate(invalid="ignore"):
        live = (v > -TWO) & (v < TWO)            # the flag stays clear
        finite = np.isfinite(v)
        assert np.array_equal(flag[finite], np.abs(v[finite]) >= TWO)
    assert np.all(flag[~finite])                 # inf as before; NaN too
    assert not np.any(flag[live])
    v = v[live]
    col = rng.integers(0, tile, v.size).astype(np.int32)
    assert np.all(v + TWO > 0)
    assert np.array_equal(_word(v, col, tile), _word_reference(v, col, tile))
    if case in ("edges", "quantum_boundaries", "near_two"):
        assert v.size > 0
