"""Operations and bytes that the inputs need, and the chip's peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W), as
``chip_smoke.py:348`` and ``PERF.md`` state them (commit 6ca9d44): HBM
3.35 TB/s; float32 67 TFLOP/s outside the tensor cores; bfloat16 989
TFLOP/s; int8 1,979 TOP/s. ``bound_ms`` is a copy of ``chip_smoke.py:586-590``.

Counts are of what the inputs need: live rows, each input byte read once
and each output byte written once, real tokens (padding left out), real
queries (a padded batch's repeats left out).
"""

from __future__ import annotations

PEAK_BW = 3.35e12
PEAK = {"float32": 67e12, "bfloat16": 989e12, "float16": 989e12,
        "int8": 1979e12}
BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


def bound_ms(nbytes: float, flops: float, peak: float) -> tuple[float, str]:
    """The least time, and which of bytes or operations bounds it."""
    t_bytes, t_ops = nbytes / PEAK_BW, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def topk_flops(b: int, n: int, d: int) -> float:
    """Scores of ``b`` queries against ``n`` rows of width ``d``."""
    return 2.0 * b * n * d


def topk_bytes(b: int, n: int, d: int, k: int, dtype: str) -> float:
    """The rows and the float32 queries read once, k (score, id) pairs a
    query written once."""
    return n * d * BYTES[dtype] + b * d * 4 + b * k * (4 + 8)


def topk_bound_ms(b: int, n: int, d: int, k: int, dtype: str) -> float:
    return bound_ms(topk_bytes(b, n, d, k, dtype), topk_flops(b, n, d),
                    PEAK[dtype])[0]


def encoder_flops(tokens: int, layers: int, hidden: int, ffn: int,
                  out_dim: int) -> float:
    """Matmul and attention operations of one text of ``tokens`` real
    tokens: per layer and token the q, k, v and output projections (4
    H x H) and the MLP (2 H x F), per layer the scores and the weighted sum
    over real tokens (2 L^2 H each), and the pooled text's projection."""
    per_layer = (2.0 * tokens * (4 * hidden * hidden + 2 * hidden * ffn)
                 + 4.0 * tokens * tokens * hidden)
    return layers * per_layer + 2.0 * hidden * out_dim
