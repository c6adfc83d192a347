"""Host wrapper of the one-call post-retrieval pass.

Held against ``optimized_rag_tpu/engine/fused.py``. ``FusedRerankEval.run``
reproduces the modular sequence

    SelectiveReranker.rerank -> apply_mmr -> SelfRAG.evaluate_retrieval
    -> ConsistencyChecker pairwise cosine

in one call with one packed result (ops/fused_eval.py), on the reranker's
device. The routing policy, stats and score semantics are the
SelectiveReranker's own (engine/rerank.py; reference
rag/selective_reranker.py:88-226). N is padded to 8, 16 or 32 (then
multiples of 32), as the JAX package pads it: MMR runs over the padded
list, so the answers depend on the buckets.
"""

from __future__ import annotations

from typing import List

import numpy as np

from optimized_rag_tpu_torch.engine.types import (
    CONVERSATIONAL_INTENTS, FACTUAL_INTENTS, Intent, RetrievedDoc)
from optimized_rag_tpu_torch.ops.fused_eval import rerank_eval_fused

_N_BUCKETS = (8, 16, 32)


def _bucket(n: int) -> int:
    for b in _N_BUCKETS:
        if n <= b:
            return b
    return -(-n // _N_BUCKETS[-1]) * _N_BUCKETS[-1]


class FusedRerankEval:
    def __init__(self, reranker, embed_fn, cross_encoder=None):
        self.reranker = reranker            # SelectiveReranker (policy+stats)
        self.embed_fn = embed_fn
        self.cross_encoder = cross_encoder

    # ------------------------------------------------------------- routing

    def _mode(self, docs, intent) -> str:
        """Mirror SelectiveReranker.rerank routing, updating its stats."""
        rr = self.reranker
        do, _reason = rr.should_rerank(docs, intent)
        if not do:
            rr.stats["skipped"] += 1
            return "none"
        try:
            intent = Intent(intent)
        except (ValueError, TypeError):
            intent = None
        if intent in FACTUAL_INTENTS:
            order = ("ce", "emb")
        elif intent in CONVERSATIONAL_INTENTS:
            order = ("emb", "ce")
        else:
            order = ("ce", "emb")
        for mode in order:
            if mode == "ce" and self.cross_encoder is not None:
                rr.stats["reranked"] += 1
                return "ce"
            if mode == "emb" and rr.embedding_reranker is not None:
                rr.stats["embedding_reranked"] += 1
                return "emb"
        rr.stats["skipped"] += 1
        return "none"

    # ----------------------------------------------------------------- run

    def run(self, query: str, docs: List[RetrievedDoc],
            intent: Intent | str | None, k_mmr: int, lam: float) -> dict:
        """Returns {docs, relevance, per_doc, sufficient, sim, sel_idx}.

        ``docs`` is the reranked + MMR-diversified selection (score /
        rerank_score mutated in place like the modular path); ``sim`` is
        the pairwise cosine matrix over the SELECTED docs, for the
        consistency checker's contradiction heuristics.
        """
        if not docs:
            return {"docs": [], "relevance": 0.0, "per_doc": [],
                    "sufficient": False, "sim": None}
        mode = self._mode(docs, intent)
        n = len(docs)
        npad = _bucket(n)
        texts = [d.text for d in docs]
        embs = np.atleast_2d(self.embed_fn([query] + texts))
        q_emb = embs[0]
        doc_embs = np.zeros((npad, embs.shape[1]), np.float32)
        doc_embs[:n] = embs[1:]
        orig = np.zeros(npad, np.float32)
        orig[:n] = [d.score for d in docs]
        valid = np.zeros(npad, bool)
        valid[:n] = True
        if mode == "ce":
            ce = self.cross_encoder
            ids, mask, types = ce.tokenizer.encode_pairs(
                [(query, t) for t in texts], ce.max_len)
            pad = npad - n
            if pad:
                ids = np.pad(ids, ((0, pad), (0, 0)))
                mask = np.pad(mask, ((0, pad), (0, 0)))
                types = np.pad(types, ((0, pad), (0, 0)))
            ce_model = ce.model
        else:
            ids = mask = types = None
            ce_model = None
        k_mmr = max(1, min(k_mmr, npad))
        packed = rerank_eval_fused(
            ce_model, ids, mask, types, doc_embs, q_emb, orig, valid,
            self.reranker.blend_original, lam, k_mmr=k_mmr, mode=mode,
            device=self.reranker.device).cpu().numpy()
        new, blended = packed[0], packed[1]
        order = packed[2].astype(np.int64)
        mmr_order = packed[3, :k_mmr].astype(np.int64)
        rel01, sim = packed[4], packed[5:]

        if mode != "none":
            for i, d in enumerate(docs):
                d.rerank_score = float(new[i])
                d.score = float(blended[i])
        sorted_idx = [int(i) for i in order if i < n]
        if n > k_mmr:   # apply_mmr semantics: no-op when n <= k
            sel_idx = [sorted_idx[int(m)] for m in mmr_order
                       if 0 <= m < n]
        elif mode == "none":
            # Policy skipped reranking and MMR is a no-op: the modular
            # path returns docs in their original order.
            sel_idx = list(range(n))
        else:
            sel_idx = sorted_idx
        selected = [docs[i] for i in sel_idx]
        per_doc = [float(rel01[i]) for i in sel_idx]
        sim_sel = sim[np.ix_(sel_idx, sel_idx)] if sel_idx else None
        return {
            "docs": selected,
            "relevance": float(np.mean(per_doc)) if per_doc else 0.0,
            "per_doc": per_doc,
            "sufficient": bool(per_doc and max(per_doc) >= 0.5),
            "sim": sim_sel,
        }
