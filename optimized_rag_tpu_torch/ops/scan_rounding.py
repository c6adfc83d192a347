"""The tensor-core scan's rounding against its bound, on adversarial operands.

csrc/scan_mma.cuh bounds the difference between the tensor cores' f32 sum
of a K1 or F score and the exact sum of its exact 16-bit products by
``units(D) * u * S`` (u = 2**-24, S = sum |q_i c_i|,
``topk_kernels.scan_rounding_units``): 2.5 D16 in full accumulation, 40 +
D16/16 split. ``operands`` makes queries and rows that press on the
alignment and truncation that bound models: mixed exponents inside one
k16 step, one large product beside many small ones of one sign, and sums
that cancel to far below S. ``rounding_ratio`` is the largest error over
all pairs as a share of each pair's own bound (at most 1 where it holds),
the exact sums taken in float64 (exact products, a sum error near 2**-53
S).
"""

from __future__ import annotations

import numpy as np
import torch

from optimized_rag_tpu_torch.ops.topk_kernels import scan_rounding_units


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def operands(seed: int, b: int, n: int, d: int, dtype: torch.dtype,
             device) -> tuple[torch.Tensor, torch.Tensor]:
    """Queries f32 [b, d] (already in ``dtype``'s values) and rows [n, d] in
    ``dtype``, all of unit norm before rounding. Rows in four kinds, a
    quarter each: the query's magnitudes under random signs (cancellation);
    independent mixed exponents; one large term each 16 features beside
    small ones of the query's sign (the small ones meet the large one's
    alignment); the query with its second half negated (a sum near 0
    against S near 1)."""
    rng = np.random.default_rng(seed)
    span = 12 if dtype == torch.bfloat16 else 9    # f16 keeps to normals

    def mixed(shape):
        return (rng.choice([-1.0, 1.0], shape)
                * 2.0 ** -rng.integers(0, span, shape)
                * (1.0 + rng.random(shape)))
    q = _unit(mixed((b, d)))
    qi = rng.integers(0, b, n)
    kinds = np.arange(n) % 4
    rows = np.empty((n, d))
    flip = rng.choice([-1.0, 1.0], (n, d))
    rows[kinds == 0] = (np.abs(q[qi]) * flip)[kinds == 0]
    rows[kinds == 1] = mixed((n, d))[kinds == 1]
    lead = np.where(np.arange(d) % 16 == 0, 1.0, 2.0 ** -(span // 2))
    rows[kinds == 2] = (np.sign(q[qi]) * lead * (1.0 + 0.1 * rng.random(
        (n, d))))[kinds == 2]
    half = np.where(np.arange(d) < d // 2, 1.0, -1.0)
    rows[kinds == 3] = (q[qi] * half)[kinds == 3]
    qt = torch.from_numpy(q.astype(np.float32)).to(dtype).float()
    ct = torch.from_numpy(_unit(rows).astype(np.float32)).to(dtype)
    return qt.to(device), ct.to(device)


def rounding_ratio(q: torch.Tensor, corpus: torch.Tensor, sums: torch.Tensor,
                   mode: str) -> float:
    """max over (row, query) of |sums - exact| / (units(D) u S), ``sums``
    f32 [N, B] (``topk_kernels.scan_sums``), ``mode`` "full" or "split"."""
    q64, c64 = q.double(), corpus.double()
    exact = c64 @ q64.T
    s = c64.abs() @ q64.abs().T
    bound = scan_rounding_units(corpus.shape[1], mode) * 2.0 ** -24 * s
    err = (sums.double() - exact).abs()
    return float((err / bound.clamp_min(1e-300)).max())
