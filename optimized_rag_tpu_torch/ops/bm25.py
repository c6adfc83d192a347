"""BM25 lexical scoring over impact-ordered champion lists.

Held against ``optimized_rag_tpu/ops/bm25.py`` (:30-81). For every term the
index keeps its top ``cap`` documents by term frequency as dense padded
arrays ``champ_docs`` / ``champ_tf`` / ``champ_valid`` [V, cap]
(index/lexical.py). A query gathers the rows of its (at most 32) terms,
scores every posting, and accumulates into a dense [N] score vector.

The accumulation is one ``index_add_`` per query term, in query-term order.
Within one champion row a document appears at most once (padding slots
point at document 0 and add 0.0, which changes no sum), so each such call
adds without collisions, and a document matched by several terms (or by
one term twice, when two query tokens stem alike: ``encode_query`` does
not deduplicate) gets its sum in query-term order, as XLA's in-order
scatter on the CPU gives it. One ``index_add_`` over all [Q, cap] postings
would add a document's contributions with atomics in no fixed order on the
card, and a near-tie in ``bm25_topk`` could then swap from run to run.

BM25:  idf(t) * tf * (k1+1) / (tf + k1 * (1 - b + b * len_d / avg_len))
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.topk import _topk


def bm25_score_champions(query_terms, query_valid, champ_docs, champ_tf,
                         champ_valid, idf, doc_len, avg_len,
                         k1: float = 1.5, b: float = 0.75) -> torch.Tensor:
    """Dense BM25 score vector [N] float32 for one query (0 where no term
    matches). query_terms [Q] int champion rows (padded), query_valid [Q]
    bool; champ_* [V, cap]; idf [V]; doc_len [N]; avg_len a scalar."""
    dev = champ_docs.device
    query_valid = torch.as_tensor(query_valid, device=dev)
    q = torch.where(query_valid, torch.as_tensor(query_terms, device=dev),
                    0).long()
    docs = champ_docs[q].long()                       # [Q, cap]
    tf = champ_tf[q].float()
    pvalid = champ_valid[q] & query_valid[:, None]
    term_idf = idf[q].float()[:, None]
    safe_docs = torch.where(pvalid, docs, 0)
    dlen = doc_len[safe_docs].float()
    avg = torch.clamp_min(torch.as_tensor(avg_len, device=dev).float(), 1e-6)
    denom = tf + k1 * (1.0 - b + b * dlen / avg)
    contrib = term_idf * tf * (k1 + 1.0) / torch.clamp_min(denom, 1e-9)
    contrib = torch.where(pvalid, contrib, torch.zeros((), device=dev))
    acc = torch.zeros(doc_len.shape[0], device=dev)
    for t in range(q.shape[0]):
        acc.index_add_(0, safe_docs[t], contrib[t])
    return acc


def mask_past_size(scores: torch.Tensor, size) -> torch.Tensor:
    """-inf at every position >= ``size``."""
    row = torch.arange(scores.shape[0], device=scores.device)
    return torch.where(row < size, scores,
                       torch.tensor(float("-inf"), device=scores.device))


def bm25_topk(query_terms, query_valid, champ_docs, champ_tf, champ_valid,
              idf, doc_len, avg_len, k: int, size=None,
              k1: float = 1.5, b: float = 0.75):
    """BM25 scores, then top-k (ties to the lower id). Returns (scores [k],
    ids [k]); documents at or past ``size`` score -inf."""
    scores = bm25_score_champions(query_terms, query_valid, champ_docs,
                                  champ_tf, champ_valid, idf, doc_len,
                                  avg_len, k1=k1, b=b)
    if size is not None:
        scores = mask_past_size(scores, size)
    return _topk(scores, k)


def bm25_idf(doc_freq: torch.Tensor, num_docs) -> torch.Tensor:
    """Okapi BM25 idf: ln((N - df + 0.5) / (df + 0.5) + 1), float32."""
    df = doc_freq.float()
    n = torch.as_tensor(num_docs, dtype=torch.float32, device=df.device)
    return torch.log((n - df + 0.5) / (df + 0.5) + 1.0)
