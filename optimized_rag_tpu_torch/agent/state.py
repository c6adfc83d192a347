"""Typed agent state threaded through the graph.

Dataclass mirror of the reference's Pydantic MemGPTState
(agent/state.py:62, ~60 fields) and ChatResponse (:8) — retrieval results,
verification scores, loop counters, HITL flags, web-fallback flags.

Held against ``optimized_rag_tpu/agent/state.py``, a copy whose imports
name the port's modules.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from optimized_rag_tpu_torch.engine.types import Intent, RetrievedDoc


@dataclass
class ChatResponse:
    answer: str = ""
    citations: List[int] = field(default_factory=list)
    sources: List[Dict[str, Any]] = field(default_factory=list)
    confidence: float = 0.0
    factuality_score: float = 0.0
    factuality_level: str = "unknown"
    support_ratio: float = 0.0
    faithfulness: float = 0.0
    refused: bool = False
    hitl_flagged: bool = False
    intent: Optional[str] = None
    tiers_used: List[int] = field(default_factory=list)
    uncertainty: float = 0.0
    warnings: List[str] = field(default_factory=list)
    metrics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AgentState:
    # input
    user_input: str = ""
    translated_input: Optional[str] = None
    language: str = "en"
    iteration: int = 0

    # intent / rewrite
    query_intent: Optional[Intent] = None
    intent_confidence: float = 0.0
    rewritten_query: Optional[str] = None
    query_variants: List[str] = field(default_factory=list)

    # memory retrieval
    archival_memories: List[RetrievedDoc] = field(default_factory=list)
    recent_messages: List[Dict] = field(default_factory=list)
    core_memory: Dict[str, str] = field(default_factory=dict)
    recall_bypass: bool = False      # conversation-reference fast path

    # routing
    needs_document_retrieval: bool = True
    data_sources: List[str] = field(default_factory=list)
    context_tokens: int = 0

    # retrieval
    rag_context: List[RetrievedDoc] = field(default_factory=list)
    kg_context: str = ""
    web_context: List[RetrievedDoc] = field(default_factory=list)
    tiers_used: List[int] = field(default_factory=list)
    retrieval_confidence: float = 0.0
    relevance_score: float = 0.0
    # Self-RAG retrieval relevance carried into the next tier-confidence
    # evaluation (reference rerank_and_eval.py:197-199 stamps it on results
    # for hierarchical_retriever.py:79-90's 60/40 blend).
    semantic_confidence: Optional[float] = None
    retrieval_weights: Dict[str, float] = field(default_factory=dict)

    # eval / compression
    consistency: Dict[str, Any] = field(default_factory=dict)
    compressed: bool = False
    cot_reasoning: str = ""
    synthesized_context: str = ""

    # generation
    response: str = ""
    citations: List[int] = field(default_factory=list)
    faithfulness: float = 0.0
    factuality_score: float = 0.0
    factuality_level: str = "unknown"
    support_ratio: float = 0.0
    uncited_ratio: float = 0.0
    uncertainty: float = 0.0
    refused: bool = False
    hitl_flagged: bool = False
    temporal_issues: List[str] = field(default_factory=list)
    attribution: Dict[str, Any] = field(default_factory=dict)
    citation_valid: bool = True
    warnings: List[str] = field(default_factory=list)

    # verification / loops
    verification_passed: bool = False
    claims: List[Dict[str, Any]] = field(default_factory=list)
    regeneration_attempts: int = 0
    refinement_attempts: int = 0
    reretrieve_attempts: int = 0
    web_search_attempted: bool = False

    # tools
    tool_calls: List[Dict[str, Any]] = field(default_factory=list)
    tool_results: List[str] = field(default_factory=list)

    # metrics
    metrics: Dict[str, Any] = field(default_factory=dict)

    @property
    def effective_query(self) -> str:
        return (self.rewritten_query or self.translated_input
                or self.user_input)

    def copy(self) -> "AgentState":
        return dataclasses.replace(self)
