"""Score fusion: min-max normalisation, weighted hybrid blending, RRF,
temporal decay and the rerank blend.

Held against ``optimized_rag_tpu/ops/fusion.py`` (:27-99). All operate on
aligned float32 score tensors on any device.

``rrf_fuse`` accumulates with one ``index_add_`` per ranked list, in list
order: within a list the ids are distinct (padding slots add 0.0, which
changes no sum), so every id's sum runs in list order on the card as on
the CPU, as XLA's in-order scatter does; one ``index_add_`` over all lists
at once would add with atomics in no fixed order on the card.
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.topk import _topk

NEG_INF = -1e30


def minmax_normalize(scores: torch.Tensor, valid: torch.Tensor | None = None,
                     eps: float = 1e-9) -> torch.Tensor:
    """Min-max normalise along the last axis, ignoring invalid entries.

    A degenerate range (one candidate, or all scores equal) maps to 0.5;
    invalid entries map to 0."""
    s = scores.float()
    if valid is None:
        valid = torch.ones_like(s, dtype=torch.bool)
    inf = torch.tensor(float("inf"), device=s.device)
    lo = torch.where(valid, s, inf).amin(dim=-1, keepdim=True)
    hi = torch.where(valid, s, -inf).amax(dim=-1, keepdim=True)
    out = (s - lo) / torch.clamp_min(hi - lo, eps)
    out = torch.where(hi - lo < eps, torch.full_like(out, 0.5), out)
    return torch.where(valid, out, torch.zeros_like(out))


def weighted_sum(normed: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_s normed[s] * w[s] / sum(w) over the leading axis."""
    w = weights.float()
    w = w / torch.clamp_min(w.sum(), 1e-9)
    return torch.einsum("s...,s->...", normed, w)


def weighted_fusion(score_stack: torch.Tensor, weights: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Blend S aligned score channels [S, ...]: each min-max normalised
    over ``valid``, then weighted by ``weights`` [S] renormalised to sum
    to 1."""
    normed = torch.stack([minmax_normalize(s, valid) for s in score_stack])
    return weighted_sum(normed, weights.to(normed.device))


def rrf_fuse(indices_lists: torch.Tensor, valid: torch.Tensor, k_out: int,
             rrf_k: float = 60.0, num_candidates: int | None = None):
    """Reciprocal-rank fusion of L ranked lists of ids [L, K] (rank =
    position; ``valid`` [L, K] masks padding) into a dense [num_candidates]
    accumulator of 1/(rrf_k + rank + 1). Returns (scores [k_out],
    ids [k_out]), ties to the lower id."""
    assert num_candidates is not None, \
        "num_candidates (static corpus capacity) required"
    n_lists, k = indices_lists.shape
    dev = indices_lists.device
    rank = torch.arange(k, device=dev, dtype=torch.float32)
    contrib = torch.where(valid, 1.0 / (rrf_k + rank + 1.0),
                          torch.zeros((), device=dev))
    safe_ids = torch.where(valid, indices_lists, 0).long()
    acc = torch.zeros(num_candidates, device=dev)
    for j in range(n_lists):
        acc.index_add_(0, safe_ids[j], contrib[j])
    return _topk(acc, k_out)


def temporal_decay(age_days: torch.Tensor, half_life_days) -> torch.Tensor:
    """Exponential recency boost 0.5 ** (age / half_life)."""
    hl = torch.as_tensor(half_life_days, dtype=torch.float32,
                         device=age_days.device)
    return torch.exp2(-age_days.float() / hl)


def blend_rerank(new_scores: torch.Tensor, orig_scores: torch.Tensor,
                 blend_original: float = 0.3) -> torch.Tensor:
    """Reranker blend: (1 - b) * new + b * original."""
    b = torch.as_tensor(blend_original, dtype=torch.float32,
                        device=new_scores.device)
    return (1.0 - b) * new_scores.float() + b * orig_scores.float()
