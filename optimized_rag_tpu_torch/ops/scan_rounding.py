"""The tensor-core scan's rounding against its bound, on adversarial operands.

csrc/scan_mma.cuh bounds the difference between the tensor cores' f32 sum
of a K1, K2 or F score and the exact sum of its exact products by
``units(D) * u * S`` (u = 2**-24, S = sum |q_i c_i|,
``topk_kernels.scan_rounding_units``): 2.5 D16 in full accumulation, 40 +
D16/16 split; and K2's score, that sum times the row scale rounded to
nearest, by ``(units(D) + 1) * u * cs * S``. ``operands`` makes 16-bit
queries and rows, and ``code_operands`` bf16 queries and int8 codes with
mixed row scales, that press on the alignment and truncation that bound
models: mixed exponents inside one k16 step, one large product beside many
small ones of one sign, and sums that cancel to far below S.
``rounding_ratio`` is the largest error over all pairs as a share of each
pair's own bound (at most 1 where it holds), the exact sums taken in
float64 (exact products, a sum error near 2**-53 S).
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


def code_operands(seed: int, b: int, n: int, d: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Queries f32 [b, d] (already bf16 values, unit norm before rounding),
    int8 codes [n, d] and row scales [n] spread over six binades. Codes in
    four kinds, a quarter each: the query's magnitudes (to 127) under
    random signs (cancellation); independent codes of mixed magnitudes
    (127, 63, ..., 1, 0); +-127 each 16 features beside codes of 1 or 2 of
    the query's sign (the small products meet the large one's alignment);
    the query's codes with the second half negated (a sum near 0 against S
    far above it)."""
    rng = np.random.default_rng(seed)
    q = _unit(rng.choice([-1.0, 1.0], (b, d)) * 2.0 ** -rng.integers(
        0, 12, (b, d)) * (1.0 + rng.random((b, d))))
    qi = rng.integers(0, b, n)
    kinds = np.arange(n) % 4
    full = np.round(127 * q[qi] / np.abs(q[qi]).max(1, keepdims=True))
    sign = np.sign(q[qi])
    rows = np.empty((n, d))
    rows[kinds == 0] = (np.abs(full) * rng.choice([-1.0, 1.0], (n, d)))[
        kinds == 0]
    rows[kinds == 1] = (rng.choice([-1.0, 1.0], (n, d)) * np.floor(
        127 / 2.0 ** rng.integers(0, 8, (n, d))))[kinds == 1]
    lead = np.where(np.arange(d) % 16 == 0, 127.0, 1.0)
    rows[kinds == 2] = (sign * np.minimum(lead * rng.integers(
        1, 3, (n, d)), 127))[kinds == 2]
    half = np.where(np.arange(d) < d // 2, 1.0, -1.0)
    rows[kinds == 3] = (full * half)[kinds == 3]
    cs = 2.0 ** -rng.uniform(6, 12, n) / 127
    qt = torch.from_numpy(q.astype(np.float32)).to(torch.bfloat16).float()
    return (qt.to(device), torch.from_numpy(rows.astype(np.int8)).to(device),
            torch.from_numpy(cs.astype(np.float32)).to(device))


def rounding_ratio(q: torch.Tensor, corpus: torch.Tensor, sums: torch.Tensor,
                   mode: str, row_scale=None) -> float:
    """max over (row, query) of |sums - exact| / (units(D) u S), ``sums``
    f32 [N, B] (``topk_kernels.scan_sums``), ``mode`` "full" or "split".
    With ``row_scale`` [N], K2's scores instead: the sums times the scale
    rounded to nearest in f32, against cs times the exact sum, each within
    (units(D) + 1) u cs S."""
    q64, c64 = q.double(), corpus.double()
    exact = c64 @ q64.T
    s = c64.abs() @ q64.abs().T
    units = scan_rounding_units(corpus.shape[1], mode)
    if row_scale is None:
        err, bound = (sums.double() - exact).abs(), units * s
    else:
        cs = row_scale.double()[:, None]
        err = ((sums * row_scale[:, None]).double() - cs * exact).abs()
        bound = (units + 1) * cs * s
    return float((err / (bound * 2.0 ** -24).clamp_min(1e-300)).max())
