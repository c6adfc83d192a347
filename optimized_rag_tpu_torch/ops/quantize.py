"""Symmetric per-row int8 quantisation for corpus storage.

Held against ``optimized_rag_tpu/ops/quantize.py`` (:26-45). Rows are unit
vectors (index/dense.py normalises before storing), so a symmetric
per-row scale loses nothing to offsets:

    q8[i] = round(x[i] * inv[i]),  inv[i] = 127 / max|x[i]|,
    scale[i] = max|x[i]| * f32(1/127),  score = (q . q8[i]) * scale[i]

The formulation is the function the JAX package actually computes, written
out so that codes and scales are bit for bit the same:

* XLA rewrites the reference's ``m / 127.0`` into ``m * f32(1/127)`` (the
  compiled graph multiplies by the constant 0.00787401572); ``m / 127``
  differs from it in about 4% of unit rows.
* ``127.0 / m`` with a Python scalar is computed by torch as
  ``reciprocal(m) * 127``, which is not correctly rounded; a tensor of 127s
  divided by ``m`` is, as XLA's division is.
* ``torch.round`` rounds half to even, as ``jnp.round`` does; products
  landing exactly on .5 decide a code.

Zero rows (tombstones, padding) get scale 0, so their scores stay exactly 0.
"""

from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """[N, D] float -> (int8 codes [N, D], per-row scale [N] f32)."""
    x = x.float()
    m = x.abs().amax(dim=1)
    scale = m * torch.tensor(1.0 / 127.0, dtype=torch.float32,
                             device=m.device)
    inv = torch.where(m > 0, torch.full_like(m, 127.0)
                      / torch.clamp_min(m, 1e-30), torch.zeros_like(m))
    q = torch.clamp(torch.round(x * inv[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(int8 [N, D], scale [N]) -> float32 [N, D]."""
    return q.float() * scale[:, None].float()
