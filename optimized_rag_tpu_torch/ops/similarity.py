"""Row normalisation and batched cosine similarity. Held against
``optimized_rag_tpu/ops/similarity.py`` (:21-57). The products run in full
float32 (``device.configure_numerics`` keeps TF32 off), as the reference
pins ``Precision.HIGHEST``."""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalise along the last axis (safe for zero rows)."""
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (xf / torch.clamp_min(norm, eps)).to(x.dtype)


def cosine_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cosine similarity between every row of ``a`` [M, D] and ``b``
    [N, D] -> [M, N] float32. Inputs need not be normalised."""
    return normalize(a).float() @ normalize(b).float().T


def pairwise_cosine(x: torch.Tensor) -> torch.Tensor:
    """All-pairs cosine similarity of the rows of ``x`` [N, D] -> [N, N]."""
    x = normalize(x).float()
    return x @ x.T


def batched_cosine(q: torch.Tensor, docs: torch.Tensor) -> torch.Tensor:
    """Row-wise cosine: q [B, D] against docs [B, D] -> [B] float32."""
    return torch.sum(normalize(q).float() * normalize(docs).float(), dim=-1)
