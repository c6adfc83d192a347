"""Maximal Marginal Relevance diversification.

Held against ``optimized_rag_tpu/ops/mmr.py`` (:24-60): the candidates'
similarity matrix is one float32 matmul, and each greedy step is a masked
argmax of ``lambda*relevance - (1-lambda)*max_sim_to_selected``. The k
steps run on the device with no host sync between them; ``torch.argmax``
takes the first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.similarity import normalize

NEG_INF = -1e30


def mmr_select(embeddings: torch.Tensor, relevance: torch.Tensor, k: int,
               lam=0.7, valid: torch.Tensor | None = None):
    """Greedy MMR over n candidates, selecting k.

    embeddings [n, d]; relevance [n] (higher is better); valid [n] bool
    masks padded candidates. Returns (order [k] int32 indices into the
    candidate list, -1 once none remain; mmr_scores [k] float32)."""
    n = embeddings.shape[0]
    dev = embeddings.device
    emb = normalize(embeddings).float()
    sim = emb @ emb.T                                          # [n, n]
    rel = relevance.float().to(dev)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev)
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    neg = torch.tensor(NEG_INF, device=dev)
    selected = torch.zeros(n, dtype=torch.bool, device=dev)
    max_sim = torch.full((n,), NEG_INF, device=dev)
    any_sel = torch.zeros((), dtype=torch.bool, device=dev)
    order, scores = [], []
    for _ in range(k):
        # No penalty until something is selected: the first pick is pure
        # relevance.
        penalty = torch.where(any_sel, max_sim, torch.zeros((), device=dev))
        score = lam * rel - (1.0 - lam) * penalty
        score = torch.where(valid & ~selected, score, neg)
        j = torch.argmax(score)
        best = score[j]
        ok = best > NEG_INF / 2                 # candidates remain
        order.append(torch.where(ok, j, -1))
        scores.append(best)
        selected = selected | (ok & (torch.arange(n, device=dev) == j))
        max_sim = torch.where(ok, torch.maximum(max_sim, sim[j]), max_sim)
        any_sel = any_sel | ok
    if not k:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, device=dev))
    return torch.stack(order).int(), torch.stack(scores)
