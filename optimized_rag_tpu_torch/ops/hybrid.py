"""The two-call hybrid query: both retrieval channels in one call, then the
candidate union scored and fused in another.

Held against ``optimized_rag_tpu/ops/hybrid.py`` (:31-109):

  dual_topk        dense top-k (exact matmul, or the chunked scan over an
                   int8 corpus with ``row_scale``) and champion-list BM25
                   top-k, packed into one [2, B+1, k] float32 tensor
  fuse_candidates  gather the candidates' rows, exact semantic score,
                   temporal decay, per-channel min-max over the union,
                   weighted blend and top-k, packed into one [5, k] tensor

Each result is one tensor, so the host makes one copy a call. Ids ride as
float32, exact below 2^24 rows (asserted). Ties go to the lower index, as
``lax.top_k`` gives them.
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.bm25 import (
    bm25_score_champions, mask_past_size)
from optimized_rag_tpu_torch.ops.fusion import (
    minmax_normalize, temporal_decay, weighted_sum)
from optimized_rag_tpu_torch.ops.topk import (
    NEG_INF, _topk, chunked_topk, exact_topk)

MAX_PACKED_ROWS = 1 << 24   # float32 holds every integer id below this


def dense_channel(q_emb, corpus, k: int, size, row_scale=None):
    """Exact dense top-k [B, k]: a float32 matmul over float rows, or the
    chunked scan over int8 codes (one 65,536-row chunk dequantised at a
    time, so the corpus stays int8-resident)."""
    if row_scale is not None:
        return chunked_topk(q_emb, corpus, k, size=size, row_scale=row_scale)
    return exact_topk(q_emb, corpus, k, size=size)


def bm25_channel(q_terms, q_valid, champ_docs, champ_tf, champ_valid, idf,
                 doc_len, avg_len, k: int, size, k1: float, b: float):
    """BM25 top-k [k] over documents below ``size``."""
    scores = bm25_score_champions(q_terms, q_valid, champ_docs, champ_tf,
                                  champ_valid, idf, doc_len, avg_len,
                                  k1=k1, b=b)
    return _topk(mask_past_size(scores, size), k)


def dual_topk(q_emb, corpus, size, q_terms, q_valid, champ_docs, champ_tf,
              champ_valid, idf, doc_len, avg_len, k: int,
              k1: float = 1.5, b: float = 0.75, row_scale=None):
    """Both channels in one call. q_emb [B, D] normalised; BM25 arguments
    as in ops/bm25.py; ``row_scale`` [N] dequantises an int8 corpus.
    Returns packed [2, B+1, k] float32: [0, :B] dense scores, [1, :B]
    dense ids, [0, B] BM25 scores, [1, B] BM25 ids."""
    assert corpus.shape[0] < MAX_PACKED_ROWS, (
        f"dual_topk id packing is exact only below 2^24 rows; "
        f"got {corpus.shape[0]}")
    dev = corpus.device
    q_emb = torch.as_tensor(q_emb, device=dev).float()
    dense_s, dense_i = dense_channel(q_emb, corpus, k, size, row_scale)
    bm25_s, bm25_i = bm25_channel(q_terms, q_valid, champ_docs, champ_tf,
                                  champ_valid, idf, doc_len, avg_len, k,
                                  size, k1, b)
    packed = torch.zeros((2, dense_s.shape[0] + 1, k), device=dev)
    packed[0, :-1] = dense_s
    packed[1, :-1] = dense_i.float()
    packed[0, -1] = bm25_s
    packed[1, -1] = bm25_i.float()
    return packed


def score_candidates(q_emb, corpus, safe_ids, kw_scores, age_days,
                     cand_valid, weights, half_life_days, row_scale=None):
    """The union's channels and their blend: (fused [C] with -1e30 at
    invalid slots, sem [C], kw [C], tmp [C]). ``safe_ids`` [C] are row ids
    (0 at invalid slots)."""
    emb = corpus[safe_ids].float()                             # [C, D]
    if row_scale is not None:
        emb = emb * row_scale[safe_ids][:, None].float()
    sem = emb @ q_emb.float()                                  # [C]
    kw = kw_scores.float()
    tmp = temporal_decay(age_days, half_life_days)
    normed = torch.stack([minmax_normalize(s, cand_valid)
                          for s in (sem, kw, tmp)])
    fused = weighted_sum(normed, weights)
    fused = torch.where(cand_valid, fused,
                        torch.tensor(NEG_INF, device=fused.device))
    return fused, sem, kw, tmp


def fuse_candidates(q_emb, corpus, cand_ids, cand_valid, kw_scores,
                    age_days, weights, half_life_days, k: int,
                    row_scale=None):
    """Score and fuse a candidate union in one call.

    q_emb [D] normalised; cand_ids [C] (padded, ``cand_valid`` masks);
    kw_scores [C] BM25 scores (0 for dense-only candidates); age_days [C];
    weights [3] = (semantic, keyword, temporal); ``row_scale`` [N]
    dequantises gathered int8 rows. Returns packed [5, k] float32: fused
    score, position in the candidate list (-1 where invalid), and the
    semantic, BM25 and temporal scores at each winner."""
    dev = corpus.device
    t = lambda x, dtype=None: torch.as_tensor(x, device=dev, dtype=dtype)
    cand_ids, cand_valid = t(cand_ids).long(), t(cand_valid, torch.bool)
    fused, sem, kw, tmp = score_candidates(
        t(q_emb), corpus, cand_ids.clamp_min(0), t(kw_scores),
        t(age_days), cand_valid, t(weights), half_life_days, row_scale)
    top_s, pos = _topk(fused, k)
    pos = torch.where(top_s > NEG_INF / 2, pos, -1)
    safe_pos = pos.clamp_min(0)
    return torch.stack([top_s, pos.float(), sem[safe_pos], kw[safe_pos],
                        tmp[safe_pos]])
