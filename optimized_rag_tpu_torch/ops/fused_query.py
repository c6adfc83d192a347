"""The one-call hybrid query: encoder forward, both retrieval channels,
the candidate union, fusion and the final top-k, with one packed result.

Held against ``optimized_rag_tpu/ops/fused_query.py`` (:40-141):

  tokens -> BiEncoder forward -> L2/Matryoshka -> dense top-k + BM25
  top-k -> candidate-union dedup (on the device) -> gather + semantic
  re-score + temporal decay -> per-channel min-max -> weighted blend ->
  final top-k

It gives the two-call path's answers (ops/hybrid.py): the same union, the
same normalisation over it. The union's dedup is a stable sort of the ids
(invalid slots keyed 2^30, last) and an adjacent-duplicate merge: each
channel returns distinct ids, so a duplicate run is the (dense, BM25) pair
and one look-ahead moves the BM25 score onto the kept slot. The whole
result is one [6, max(k, D)] float32 tensor, so the host makes one copy a
query.
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.hybrid import (
    MAX_PACKED_ROWS, bm25_channel, dense_channel, score_candidates)
from optimized_rag_tpu_torch.ops.topk import NEG_INF, _topk

NEG_INF_HALF = NEG_INF / 2
_INVALID_KEY = 1 << 30  # sorts every invalid candidate past the valid ones


def encode_query_vector(model, q_ids, q_mask, matryoshka_dim=None):
    """The BiEncoder's unit vector [1, D] float32 for one tokenised query
    (a batch of one, not bucket-padded); Matryoshka truncation
    renormalises."""
    dev = next(model.parameters()).device
    with torch.inference_mode():
        q = model(torch.as_tensor(q_ids).to(dev).long(),
                  torch.as_tensor(q_mask).to(dev))
    if matryoshka_dim:
        q = q[:, :matryoshka_dim]
        q = q / torch.clamp_min(torch.linalg.vector_norm(
            q, dim=-1, keepdim=True), 1e-9)
    return q.float()


def union_candidates(dense_s, dense_i, bm25_s, bm25_i):
    """The two channels' candidates deduplicated, in ascending id order,
    invalid slots last. dense_* [C] and bm25_* [C] of one query. Returns
    (cand_ids [2C] with -1 at invalid slots, cand_valid [2C], kw [2C]: the
    BM25 score of each candidate, 0 for dense-only ones)."""
    d_ok = (dense_i >= 0) & (dense_s > NEG_INF_HALF)
    b_ok = (bm25_i >= 0) & (bm25_s > 0.0)
    ids = torch.cat([dense_i, bm25_i]).long()
    ok = torch.cat([d_ok, b_ok])
    zero = torch.zeros((), device=ids.device)
    kw = torch.cat([torch.zeros_like(bm25_s), torch.where(b_ok, bm25_s, zero)])
    key = torch.where(ok, ids, _INVALID_KEY)
    sid, order = torch.sort(key, stable=True)
    skw, sok = kw[order], ok[order]
    no = torch.zeros(1, dtype=torch.bool, device=ids.device)
    same = sid[1:] == sid[:-1]
    first = torch.cat([~no, ~same])
    same_next = torch.cat([same, no])
    kw_next = torch.cat([skw[1:], zero[None]])
    merged_kw = torch.maximum(skw, torch.where(same_next, kw_next, zero))
    cand_valid = sok & first
    return torch.where(cand_valid, sid, -1), cand_valid, merged_kw


def encode_and_retrieve(model, q_ids, q_mask, corpus, size,
                        q_terms, q_valid, champ_docs, champ_tf, champ_valid,
                        idf, doc_len, avg_len, created_days, now_days,
                        weights, half_life_days, *, matryoshka_dim,
                        candidate_k: int, k: int, k1: float = 1.5,
                        b: float = 0.75, row_scale=None):
    """One call from query tokens to the fused hybrid top-k.

    ``model`` is the BiEncoder module (``EmbeddingService.model``);
    ``created_days`` [N] is days since the epoch per row (zeros, with
    weights[2] = 0, when there is no temporal data); ``now_days`` a float.
    Returns packed [6, W] float32 on the corpus's device, W = max(k, D):
      row 0: fused scores   (cols [0, k))
      row 1: doc ids        (float32; exact below 2^24, asserted)
      row 2: semantic score at each winner
      row 3: BM25 score     at each winner
      row 4: temporal score at each winner
      row 5: the query embedding (cols [0, D)), for the caller's cache.
    """
    assert corpus.shape[0] < MAX_PACKED_ROWS, (
        f"fused-query id packing is exact only below 2^24 rows; "
        f"got {corpus.shape[0]}")
    dev = corpus.device
    q = encode_query_vector(model, q_ids, q_mask, matryoshka_dim)
    dense_s, dense_i = dense_channel(q, corpus, candidate_k, size, row_scale)
    bm25_s, bm25_i = bm25_channel(q_terms, q_valid, champ_docs, champ_tf,
                                  champ_valid, idf, doc_len, avg_len,
                                  candidate_k, size, k1, b)
    cand_ids, cand_valid, kw = union_candidates(dense_s[0], dense_i[0],
                                                bm25_s, bm25_i)
    safe = cand_ids.clamp_min(0)
    now = torch.tensor(now_days, dtype=torch.float32, device=dev)
    ages = torch.clamp_min(now - created_days[safe], 0.0)
    fused, sem, kw, tmp = score_candidates(
        q[0], corpus, safe, kw, ages, cand_valid,
        torch.as_tensor(weights, device=dev), half_life_days, row_scale)
    top_s, pos = _topk(fused, k)
    out_ids = torch.where(top_s > NEG_INF_HALF, cand_ids[pos], -1)

    d = q.shape[1]
    packed = torch.zeros((6, max(k, d)), device=dev)
    packed[0, :k] = top_s
    packed[1, :k] = out_ids.float()
    packed[2, :k] = sem[pos]
    packed[3, :k] = kw[pos]
    packed[4, :k] = tmp[pos]
    packed[5, :d] = q[0]
    return packed
