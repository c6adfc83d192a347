"""Extractive context compression.

Re-implements rag/context_compressor.py:17-371: per-document sentence
selection capping context tokens, with the reference's conservative-mode
skip rules (:80-102) and confidence-adaptive aggressiveness. The sentence
scoring — 0.7*semantic + 0.3*lexical (:217) — runs as ONE batched embed +
matmul over all sentences of all documents instead of per-sentence calls.

Held against ``optimized_rag_tpu/engine/compressor.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional

import numpy as np

from optimized_rag_tpu_torch.engine.types import Intent, RetrievedDoc
from optimized_rag_tpu_torch.index.lexical import lexical_tokens

_SENT_RE = re.compile(r"(?<=[.!?])\s+|\n+")


def split_sentences(text: str) -> List[str]:
    return [s.strip() for s in _SENT_RE.split(text) if s.strip()]


def approx_tokens(text: str) -> int:
    """~4 chars/token (the reference's estimate, context_compressor.py:90)."""
    return max(1, len(text) // 4)


# per-intent compression thresholds (reference config.py:216-221)
_INTENT_THRESHOLDS = {
    Intent.QUESTION_ANSWERING: 0.5, Intent.FACT_CHECKING: 0.5,
    Intent.SUMMARIZATION: 0.3, Intent.CONVERSATIONAL: 0.7,
    Intent.MULTI_HOP_REASONING: 0.4, Intent.COMPARISON: 0.4,
}


class ContextCompressor:
    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 max_tokens: int = 2000, sentences_per_doc: int = 5,
                 semantic_weight: float = 0.7, lexical_weight: float = 0.3,
                 conservative_mode: bool = True, skip_doc_count: int = 7):
        self.embed_fn = embed_fn
        self.max_tokens = max_tokens
        self.sentences_per_doc = sentences_per_doc
        self.semantic_weight = semantic_weight
        self.lexical_weight = lexical_weight
        self.conservative_mode = conservative_mode
        self.skip_doc_count = skip_doc_count

    def compress(self, query: str, docs: List[RetrievedDoc],
                 max_tokens: Optional[int] = None,
                 intent: Intent | str | None = None,
                 confidence: float = 1.0) -> List[RetrievedDoc]:
        if not docs:
            return []
        budget = max_tokens or self.max_tokens

        # Conservative skip rules (reference :80-102).
        if len(docs) <= self.skip_doc_count:
            return docs
        if self.conservative_mode and confidence >= 0.6:
            total_chars = sum(len(d.text) for d in docs)
            if total_chars <= budget * 4:
                return docs
        if confidence < 0.6:
            return self._truncate_concat(docs, budget)
        per_doc = self.sentences_per_doc + (3 if confidence < 0.8 else 0)

        # Batched scoring: one embed call for query + all sentences.
        sent_lists = [split_sentences(d.text) for d in docs]
        flat = [s for sents in sent_lists for s in sents]
        if not flat:
            return docs
        embs = self.embed_fn([query] + flat)
        q_emb, s_emb = embs[0], embs[1:]
        semantic = s_emb @ q_emb  # unit vectors -> cosine
        q_terms = set(lexical_tokens(query))
        lexical = np.asarray(
            [len(q_terms & set(lexical_tokens(s))) / max(len(q_terms), 1)
             for s in flat], np.float32)
        scores = (self.semantic_weight * semantic
                  + self.lexical_weight * lexical)

        out, used, pos = [], 0, 0
        for d, sents in zip(docs, sent_lists):
            n = len(sents)
            doc_scores = scores[pos:pos + n]
            pos += n
            if n == 0:
                continue
            keep_idx = np.argsort(-doc_scores, kind="stable")[:per_doc]
            keep_idx = np.sort(keep_idx)  # restore document order
            kept = " ".join(sents[i] for i in keep_idx)
            cost = approx_tokens(kept)
            if used + cost > budget:
                break
            used += cost
            c = RetrievedDoc(**{**d.__dict__, "text": kept})
            c.metadata = {**d.metadata, "compressed": True,
                          "original_sentences": n,
                          "kept_sentences": int(len(keep_idx))}
            out.append(c)
        return out or docs[:1]

    @staticmethod
    def _truncate_concat(docs: List[RetrievedDoc], budget: int
                         ) -> List[RetrievedDoc]:
        """Low-confidence path: keep whole docs until the budget runs out
        (reference _concatenate_without_compression, :288)."""
        out, used = [], 0
        for d in docs:
            cost = approx_tokens(d.text)
            if used + cost > budget and out:
                break
            used += cost
            out.append(d)
        return out
