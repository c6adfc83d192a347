"""Shared engine types: intents, retrieval results, strategy tables.

A copy of ``optimized_rag_tpu/engine/types.py`` (the port imports nothing of
the JAX package, not even its JAX-free modules). Mirrors the reference's
9-way intent enum (rag/models/intent_analysis.py:6-15), the per-intent
(alpha, beta, gamma) hybrid weights (rag/retrieval.py:22-47) and the
per-intent retrieval strategies (rag/intent_recognizer.py:168-223).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Any, Dict, Optional


class Intent(str, enum.Enum):
    QUESTION_ANSWERING = "question_answering"
    SUMMARIZATION = "summarization"
    COMPARISON = "comparison"
    FACT_CHECKING = "fact_checking"
    MULTI_HOP_REASONING = "multi_hop_reasoning"
    CLARIFICATION = "clarification"
    CONVERSATIONAL = "conversational"
    INSTRUCTION = "instruction"
    SEARCH = "search"


class Source(str, enum.Enum):
    DOCUMENTS = "documents"
    ARCHIVAL = "archival"
    CONVERSATION = "conversation"
    CORE_MEMORY = "core_memory"
    KNOWLEDGE_GRAPH = "knowledge_graph"
    WEB = "web"


@dataclasses.dataclass
class RetrievedDoc:
    doc_id: int
    score: float
    text: str
    source: Source = Source.DOCUMENTS
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)
    created_at: float = dataclasses.field(default_factory=time.time)
    semantic_score: float = 0.0
    keyword_score: float = 0.0
    temporal_score: float = 0.0
    rerank_score: Optional[float] = None
    tier: int = 0


# (alpha=semantic, beta=keyword, gamma=temporal) per intent
# — reference rag/retrieval.py:22-47.
_INTENT_WEIGHTS: Dict[str, tuple] = {
    Intent.QUESTION_ANSWERING: (0.55, 0.40, 0.05),
    Intent.FACT_CHECKING: (0.50, 0.45, 0.05),
    Intent.MULTI_HOP_REASONING: (0.60, 0.30, 0.10),
    Intent.COMPARISON: (0.50, 0.45, 0.05),
    Intent.SUMMARIZATION: (0.65, 0.25, 0.10),
    Intent.SEARCH: (0.45, 0.50, 0.05),
    Intent.CLARIFICATION: (0.70, 0.20, 0.10),
    Intent.CONVERSATIONAL: (0.70, 0.20, 0.10),
    Intent.INSTRUCTION: (0.70, 0.20, 0.10),
}
_DEFAULT_WEIGHTS = (0.55, 0.35, 0.10)


def intent_weights(intent: Intent | str | None) -> tuple:
    try:
        return _INTENT_WEIGHTS[Intent(intent)]
    except (ValueError, KeyError, TypeError):
        return _DEFAULT_WEIGHTS


# per-intent retrieval strategy — reference rag/intent_recognizer.py:168-223.
_STRATEGIES: Dict[Intent, Dict[str, Any]] = {
    Intent.QUESTION_ANSWERING: dict(top_k=5, use_hybrid=True,
                                    use_reranking=True, diversity_weight=0.3),
    Intent.SUMMARIZATION: dict(top_k=10, use_hybrid=False,
                               use_reranking=True, diversity_weight=0.5),
    Intent.COMPARISON: dict(top_k=8, use_hybrid=True, use_reranking=True,
                            diversity_weight=0.7),
    Intent.FACT_CHECKING: dict(top_k=5, use_hybrid=True, use_reranking=True,
                               diversity_weight=0.2),
    Intent.MULTI_HOP_REASONING: dict(top_k=12, use_hybrid=True,
                                     use_reranking=True,
                                     diversity_weight=0.6),
    Intent.CLARIFICATION: dict(top_k=3, use_hybrid=False,
                               use_reranking=False, diversity_weight=0.1),
    Intent.CONVERSATIONAL: dict(top_k=2, use_hybrid=False,
                                use_reranking=False, diversity_weight=0.0),
    Intent.INSTRUCTION: dict(top_k=3, use_hybrid=False, use_reranking=False,
                             diversity_weight=0.0),
    Intent.SEARCH: dict(top_k=7, use_hybrid=True, use_reranking=True,
                        diversity_weight=0.5),
}


def retrieval_strategy(intent: Intent | str | None) -> Dict[str, Any]:
    try:
        return dict(_STRATEGIES[Intent(intent)])
    except (ValueError, KeyError, TypeError):
        return dict(top_k=5, use_hybrid=True, use_reranking=True,
                    diversity_weight=0.3)


PRECISION_INTENTS = frozenset({
    Intent.QUESTION_ANSWERING, Intent.MULTI_HOP_REASONING, Intent.COMPARISON,
    Intent.FACT_CHECKING, Intent.SUMMARIZATION, Intent.SEARCH,
})  # reference selective_reranker.py:104-116

# Routing inside _apply_reranking (reference selective_reranker.py:188-204):
# factual intents go to the cross-encoder, conversational ones to the cheap
# embedding reranker; each falls back to the other when unavailable.
FACTUAL_INTENTS = frozenset({
    Intent.QUESTION_ANSWERING, Intent.MULTI_HOP_REASONING, Intent.COMPARISON,
    Intent.FACT_CHECKING,
})
CONVERSATIONAL_INTENTS = frozenset({
    Intent.CONVERSATIONAL, Intent.SEARCH, Intent.CLARIFICATION,
})
