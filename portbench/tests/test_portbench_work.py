"""``work.py``'s counts against hand counts at the cells' shapes."""

import pytest

from portbench import work


def test_k1_f32_served_bound_is_operations():
    # 2 * 64 * 4,194,304 * 384 operations at 67 TFLOP/s.
    ms, by = work.bound_ms(work.topk_bytes(64, 4_194_304, 384, 16,
                                           "float32"),
                           work.topk_flops(64, 4_194_304, 384), 67e12)
    assert by == "operations"
    assert ms == pytest.approx(3.077, abs=5e-4)
    assert work.topk_bound_ms(64, 4_194_304, 384, 16, "float32") == ms


def test_bf16_batch_bound():
    # PERF.md's K1 bf16 B=1024 bound: 2.779 ms; B=4096 is four of them.
    assert work.topk_bound_ms(1024, 10_485_760, 128, 40, "bfloat16") == \
        pytest.approx(2.779, abs=5e-4)
    assert work.topk_bound_ms(4096, 10_485_760, 128, 10, "bfloat16") == \
        pytest.approx(4 * 2.7794, rel=1e-3)


def test_bytes_bound_at_one_query():
    # B=1: 4,194,304 x 384 float32 rows read once, 1.923 ms at 3.35 TB/s.
    ms, by = work.bound_ms(work.topk_bytes(1, 4_194_304, 384, 10,
                                           "float32"),
                           work.topk_flops(1, 4_194_304, 384), 67e12)
    assert by == "bytes"
    assert ms == pytest.approx(4_194_304 * 384 * 4 / 3.35e12 * 1e3,
                               rel=1e-5)


def test_encoder_flops_by_hand():
    # 14 tokens, 6 layers, H=384, F=1536: per layer 2*14*(4*384^2 +
    # 2*384*1536) + 4*14^2*384, then the 384 x 384 projection.
    per_layer = 2 * 14 * (4 * 384 * 384 + 2 * 384 * 1536) + 4 * 196 * 384
    assert work.encoder_flops(14, 6, 384, 1536, 384) == \
        6 * per_layer + 2 * 384 * 384
    assert work.encoder_flops(14, 6, 384, 1536, 384) == 299_372_544
