"""Selective reranking: policy + cross-encoder + MMR + RRF.

Held against ``optimized_rag_tpu/engine/rerank.py``. Re-implements the
reference's four ranking primitives (rag/reranker.py) and the
SelectiveReranker routing policy (rag/selective_reranker.py:88-160):

  * precision intents always rerank with the cross-encoder
  * <=5 results skip unless embedding scores are very low (<0.05 avg)
  * score-variance heuristic: high variance (>0.1) = clear winners, skip;
    low variance (<0.05) = rerank
  * rerank blend 0.7*new + 0.3*orig (reranker.py:77)
  * MMR diversification via ops/mmr.py (reranker.py:156-191)
  * RRF merge via ops/fusion.py (reranker.py:239-271)

The blends of a few scores run on the host; MMR runs on ``device``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.engine.types import (
    CONVERSATIONAL_INTENTS, FACTUAL_INTENTS, Intent, PRECISION_INTENTS,
    RetrievedDoc)
from optimized_rag_tpu_torch.ops.fusion import blend_rerank
from optimized_rag_tpu_torch.ops.mmr import mmr_select


def _blend(new, orig, blend_original: float) -> np.ndarray:
    """``blend_rerank`` of two host score vectors, on the host."""
    return blend_rerank(torch.from_numpy(np.asarray(new, np.float32)),
                        torch.from_numpy(np.asarray(orig, np.float32)),
                        blend_original).numpy()


class EmbeddingReranker:
    """Bi-encoder reranker: re-score candidates by query-doc cosine and
    blend with the original score (reference OpenAIReranker,
    rag/reranker.py:13-101 — its one batched embedding call for k+1 texts
    becomes one on-device encoder forward)."""

    def __init__(self, embed_fn: Callable, blend_original: float = 0.3):
        self.embed_fn = embed_fn
        self.blend_original = blend_original

    def rerank(self, query: str, docs: List[RetrievedDoc],
               top_k: int | None = None) -> List[RetrievedDoc]:
        if not docs:
            return []
        embs = np.atleast_2d(self.embed_fn([query] + [d.text for d in docs]))
        q, d_embs = embs[0], embs[1:]
        new = (d_embs @ q).astype(np.float32)
        orig = np.asarray([d.score for d in docs], np.float32)
        blended = _blend(new, orig, self.blend_original)
        order = np.argsort(-blended, kind="stable")
        out = []
        for i in order[: top_k or len(docs)]:
            doc = docs[int(i)]
            doc.rerank_score = float(new[int(i)])
            doc.score = float(blended[int(i)])
            out.append(doc)
        return out


class SelectiveReranker:
    def __init__(self, cross_encoder=None,
                 embed_fn: Optional[Callable] = None,
                 config=None,
                 blend_original: float | None = None,
                 low_score_force: float | None = None,
                 high_variance_skip: float | None = None,
                 low_variance_rerank: float | None = None,
                 device="cuda"):
        self.device = resolve_device(device)   # where MMR runs
        if config is None:
            from optimized_rag_tpu_torch.config import RerankConfig
            config = RerankConfig()
        self.config = config
        self.cross_encoder = cross_encoder  # CrossEncoderService or None
        self.embed_fn = embed_fn
        self.blend_original = (config.blend_original if blend_original is None
                               else blend_original)
        self.embedding_reranker = (EmbeddingReranker(embed_fn,
                                                     self.blend_original)
                                   if embed_fn is not None else None)
        self.low_score_force = (config.low_score_force if low_score_force
                                is None else low_score_force)
        self.high_variance_skip = (config.high_variance_skip
                                   if high_variance_skip is None
                                   else high_variance_skip)
        self.low_variance_rerank = (config.low_variance_rerank
                                    if low_variance_rerank is None
                                    else low_variance_rerank)
        self.stats = {"reranked": 0, "skipped": 0, "embedding_reranked": 0}

    # -------------------------------------------------------------- policy

    def should_rerank(self, docs: Sequence[RetrievedDoc],
                      intent: Intent | str | None) -> tuple[bool, str]:
        try:
            if Intent(intent) in PRECISION_INTENTS:
                return True, f"precision intent ({intent})"
        except (ValueError, TypeError):
            pass
        scores = [d.score for d in docs]
        if len(docs) <= 5:
            avg = float(np.mean(scores)) if scores else 0.0
            if avg < self.low_score_force:
                return True, f"low embedding scores ({avg:.3f})"
            return False, "too few results (<=5)"
        top = np.asarray(scores[:10], np.float32)
        var = float(np.var(top))
        if var > self.high_variance_skip:
            return False, f"high score variance ({var:.3f})"
        if var < self.low_variance_rerank:
            return True, f"low score variance ({var:.3f})"
        return True, "default rerank"

    # ------------------------------------------------------------- actions

    def rerank(self, query: str, docs: List[RetrievedDoc],
               intent: Intent | str | None = None, top_k: int | None = None
               ) -> List[RetrievedDoc]:
        """Apply the policy; returns (possibly) reranked docs.

        Routing mirrors the reference: precision intents -> cross-encoder,
        chat/search -> embedding reranker; fallback chain cross-encoder ->
        embedding reranker -> passthrough (selective_reranker.py:166-226).
        """
        if not docs:
            return docs
        do, _reason = self.should_rerank(docs, intent)
        if not do:
            self.stats["skipped"] += 1
            return docs[:top_k] if top_k else docs
        try:
            intent = Intent(intent)
        except (ValueError, TypeError):
            intent = None
        # Routing (selective_reranker.py:188-226): factual -> cross-encoder,
        # conversational -> embedding reranker, default -> whichever is
        # available (cross-encoder first); each falls back to the other.
        if intent in FACTUAL_INTENTS:
            order = (self.cross_encoder, self.embedding_reranker)
        elif intent in CONVERSATIONAL_INTENTS:
            order = (self.embedding_reranker, self.cross_encoder)
        else:  # unmatched intents: try any available reranker
            order = (self.cross_encoder, self.embedding_reranker)
        for reranker in order:
            if reranker is None:
                continue
            if reranker is self.embedding_reranker:
                self.stats["embedding_reranked"] += 1
                return self.embedding_reranker.rerank(query, docs, top_k)
            self.stats["reranked"] += 1
            return self._cross_encoder_rerank(query, docs, top_k)
        self.stats["skipped"] += 1
        return docs[:top_k] if top_k else docs

    def _cross_encoder_rerank(self, query: str, docs: List[RetrievedDoc],
                              top_k: int | None) -> List[RetrievedDoc]:
        new = self.cross_encoder.score_pairs(query, [d.text for d in docs])
        orig = np.asarray([d.score for d in docs], np.float32)
        blended = _blend(new, orig, self.blend_original)
        order = np.argsort(-blended, kind="stable")
        out = []
        for i in order[: top_k or len(docs)]:
            d = docs[int(i)]
            d.rerank_score = float(new[int(i)])
            d.score = float(blended[int(i)])
            out.append(d)
        return out

    def apply_mmr(self, docs: List[RetrievedDoc], k: int,
                  lam: float = 0.7,
                  embeddings: Optional[np.ndarray] = None
                  ) -> List[RetrievedDoc]:
        """Diversify to k docs (reference rag/nodes/helpers.py:183-256)."""
        if len(docs) <= k:
            return docs
        if embeddings is None:
            assert self.embed_fn is not None, "need embed_fn or embeddings"
            embeddings = self.embed_fn([d.text for d in docs])
        rel = np.asarray([d.score for d in docs], np.float32)
        dev = self.device
        order, _ = mmr_select(
            torch.as_tensor(np.asarray(embeddings, np.float32), device=dev),
            torch.from_numpy(rel).to(dev), k, lam=lam)
        return [docs[int(i)] for i in order.cpu().numpy() if i >= 0]

    @staticmethod
    def rrf_merge(lists: Sequence[Sequence[RetrievedDoc]], k_out: int,
                  rrf_k: float = 60.0) -> List[RetrievedDoc]:
        """Merge ranked lists by reciprocal-rank fusion.

        Candidates are deduplicated by (source, doc_id) — chunk, archival,
        core-memory, web, and KG docs live in distinct id namespaces (some
        negative), so fusing happens in a compact 0..C space built here and
        mapped back (reference rag/reranker.py:239-271). Candidate sets are
        tiny (tens of docs), so fusion runs on the host; the tensor path
        for aligned id spaces is ops.fusion.rrf_fuse.
        """
        lists = [lst for lst in lists if lst]
        if not lists:
            return []
        compact: dict = {}  # (source, doc_id) -> compact index
        docs: List[RetrievedDoc] = []
        for lst in lists:
            for d in lst:
                key = (getattr(d.source, "value", d.source), d.doc_id)
                if key not in compact:
                    compact[key] = len(docs)
                    docs.append(d)
        acc = np.zeros(len(docs), np.float64)
        for lst in lists:
            rows = [compact[(getattr(d.source, "value", d.source), d.doc_id)]
                    for d in lst]
            np.add.at(acc, rows,
                      1.0 / (rrf_k + np.arange(len(lst), dtype=np.float64)
                             + 1.0))
        order = np.argsort(-acc, kind="stable")[:k_out]
        out = []
        for i in order:
            d = docs[int(i)]
            d.score = float(acc[int(i)])
            out.append(d)
        return out
