"""Post-retrieval scoring in one call: rerank + MMR + relevance + sim.

Held against ``optimized_rag_tpu/ops/fused_eval.py`` (:30-91). The modular
path (cross-encoder forward, MMR selection, Self-RAG relevance cosine,
pairwise-consistency cosine) becomes one function with one packed result,
so the host makes one copy; the host keeps the decisions (routing policy,
contradiction heuristics, loop control).
"""

from __future__ import annotations

import torch

from optimized_rag_tpu_torch.ops.fusion import blend_rerank
from optimized_rag_tpu_torch.ops.mmr import mmr_select
from optimized_rag_tpu_torch.ops.similarity import normalize

NEG_INF = -1e30
MODES = ("ce", "emb", "none")


def rerank_eval_fused(ce_model, pair_ids, pair_mask, pair_types,
                      doc_embs, q_emb, orig_scores, valid,
                      blend_original, lam, *, k_mmr: int, mode: str,
                      device="cuda"):
    """The whole post-retrieval scoring pass on ``device``.

    mode: "ce" scores (query, doc) token pairs with the CrossEncoder module
    ``ce_model``; "emb" re-scores by query-doc cosine (bi-encoder rerank);
    "none" skips reranking (the policy said skip) but still runs MMR,
    relevance and consistency.

    doc_embs [N, D] (unit vectors; zero padding rows), q_emb [D] unit,
    orig_scores [N], valid [N] bool. Returns packed [5 + N, N] float32:
      row 0: rerank scores (new)      row 1: blended scores
      row 2: descending sort order    row 3: MMR selection (first k_mmr
                                             cols; indices into row 2's
                                             sorted list, -1 padded)
      row 4: per-candidate relevance in [0, 1] (Self-RAG semantic)
      rows 5..5+N: pairwise cosine similarity matrix
    """
    assert mode in MODES, mode
    t = lambda x: torch.as_tensor(x).to(device)
    emb = t(doc_embs).float()
    orig = t(orig_scores).float()
    valid = t(valid).bool()
    n = emb.shape[0]
    if mode == "ce":
        with torch.inference_mode():
            logits = ce_model(t(pair_ids).long(), t(pair_mask).long(),
                              t(pair_types).long())
        new = torch.sigmoid(logits.float())
        blended = blend_rerank(new, orig, blend_original)
    elif mode == "emb":
        new = emb @ t(q_emb).float()
        blended = blend_rerank(new, orig, blend_original)
    else:
        new = blended = orig
    blended_m = torch.where(valid, blended,
                            torch.tensor(NEG_INF, device=emb.device))
    _, order = torch.sort(-blended_m, stable=True)

    # MMR over the reranked (sorted) candidates, as
    # SelectiveReranker.apply_mmr runs it on the reranked list.
    mmr_order, _ = mmr_select(emb[order], blended_m[order], k_mmr, lam=lam,
                              valid=valid[order])

    # Self-RAG retrieval relevance: cosine mapped to [0, 1].
    dn = normalize(emb)
    qn = t(q_emb).float()
    qn = qn / torch.clamp_min(torch.linalg.vector_norm(qn), 1e-12)
    rel01 = torch.clamp((dn @ qn + 1.0) / 2.0, 0.0, 1.0)

    packed = torch.zeros((5 + n, n), device=emb.device)
    packed[0] = new
    packed[1] = blended
    packed[2] = order.float()
    packed[3, :k_mmr] = mmr_order.float()
    packed[4] = rel01
    packed[5:] = dn @ dn.T        # pairwise cosine, for the consistency scan
    return packed
