"""DW-GRPO adaptive retrieval-weight learning.

Re-implements the semantics of rag/adaptive_weights.py:
  * ``QueryFeatureExtractor`` — complexity heuristics (:199-238) and domain
    indicators (:242-262)
  * ``PerformanceTracker`` — sliding window of per-query outcomes (:32-192)
  * ``DynamicWeightManager`` — template -> learned blend
    ``w = (1-a)*template + a*learned`` (:385-388), domain boosts
    (:402-413), normalization (:416-421), persistence every N queries
    (:489-501; persistence target is store/db.py instead of Postgres)

The produced weights feed ops/fusion.weighted_fusion as a device array.

Held against ``optimized_rag_tpu/engine/adaptive.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import enum
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np


class QueryComplexity(str, enum.Enum):
    SIMPLE = "simple"
    MODERATE = "moderate"
    COMPLEX = "complex"


_COMPLEX_KEYWORDS = (
    "compare", "difference between", "relationship", "why", "how does",
    "explain", "analyze", "multiple", "all", "every", "comprehensive")
_SIMPLE_KEYWORDS = (
    "what is", "who is", "when", "where", "define", "name", "list")

_DOMAINS = {
    "temporal": ("recent", "latest", "yesterday", "today", "last week",
                 "ago", "when"),
    "technical": ("code", "function", "class", "algorithm",
                  "implementation", "technical"),
    "factual": ("what is", "define", "meaning", "definition"),
    "conversational": ("how are", "tell me about", "can you", "please",
                       "help me"),
}

SOURCES = ("semantic", "keyword", "temporal", "knowledge_graph")


class QueryFeatureExtractor:
    @staticmethod
    def extract_complexity(query: str, intent: str | None) -> QueryComplexity:
        q = query.lower()
        if any(kw in q for kw in _COMPLEX_KEYWORDS):
            return QueryComplexity.COMPLEX
        if intent in ("multi_hop_reasoning", "multi_hop", "reasoning",
                      "synthesis"):
            return QueryComplexity.COMPLEX
        if any(kw in q for kw in _SIMPLE_KEYWORDS) and len(q.split()) < 10:
            return QueryComplexity.SIMPLE
        return QueryComplexity.MODERATE

    @staticmethod
    def extract_domain_indicators(query: str) -> Dict[str, float]:
        q = query.lower()
        return {d: min(sum(kw in q for kw in kws) / 3.0, 1.0)
                for d, kws in _DOMAINS.items()}


class PerformanceTracker:
    """Sliding-window stats of (weights used -> outcome quality)."""

    def __init__(self, window_size: int = 100):
        self.window_size = window_size
        self._records: dict = defaultdict(lambda: deque(maxlen=window_size))

    def record_query(self, intent: str, complexity: QueryComplexity,
                     weights: Dict[str, float], quality: float) -> None:
        self._records[(intent, complexity)].append((dict(weights),
                                                    float(quality)))

    def get_optimal_weights_for_complexity(
            self, intent: str, complexity: QueryComplexity
    ) -> Optional[Dict[str, float]]:
        """Quality-weighted average of recorded weights (needs >= 3 samples)."""
        recs = self._records.get((intent, complexity))
        if not recs or len(recs) < 3:
            return None
        total_q = sum(max(q, 1e-6) for _, q in recs)
        out = {s: 0.0 for s in SOURCES}
        for w, q in recs:
            for s in SOURCES:
                out[s] += w.get(s, 0.0) * max(q, 1e-6) / total_q
        return out

    def stats(self) -> dict:
        return {f"{i}/{c.value}": len(v)
                for (i, c), v in self._records.items()}


class DynamicWeightManager:
    """The DW-GRPO learner. ``db`` is any object with
    load_learned_weights(agent_id, intent, complexity) /
    save_learned_weights(agent_id, intent, complexity, weights) /
    save_performance(record) — store/db.py provides it."""

    def __init__(self, agent_id: str = "default", learning_rate: float = 0.01,
                 window_size: int = 100, persist_every: int = 10,
                 enable_learning: bool = True, db=None):
        self.agent_id = agent_id
        self.learning_rate = learning_rate
        self.persist_every = persist_every
        self.enable_learning = enable_learning
        self.db = db
        self.tracker = PerformanceTracker(window_size)
        self.feature_extractor = QueryFeatureExtractor()
        self._since_persist = 0
        self._last: Optional[tuple] = None

    def _template(self, intent: str | None) -> Dict[str, float]:
        from optimized_rag_tpu_torch.engine.types import intent_weights
        a, b, g = intent_weights(intent)
        return {"semantic": a, "keyword": b, "temporal": g,
                "knowledge_graph": 0.0}

    def calculate_optimal_weights(self, query: str, intent: str | None
                                  ) -> Dict[str, float]:
        complexity = self.feature_extractor.extract_complexity(query, intent)
        domains = self.feature_extractor.extract_domain_indicators(query)
        weights = self._template(intent)
        if self.enable_learning:
            learned = None
            if self.db is not None:
                learned = self.db.load_learned_weights(
                    self.agent_id, str(intent), complexity.value)
            if not learned:
                learned = self.tracker.get_optimal_weights_for_complexity(
                    str(intent), complexity)
            if learned:
                a = self.learning_rate
                weights = {s: (1 - a) * weights[s] + a * learned.get(s,
                                                                     weights[s])
                           for s in weights}
        # Domain boosts (reference :402-413).
        if domains.get("temporal", 0) > 0.5:
            boost = 0.15 * domains["temporal"]
            weights["temporal"] += boost
            weights["semantic"] -= boost * 0.7
            weights["keyword"] -= boost * 0.3
        if domains.get("technical", 0) > 0.5:
            boost = 0.1 * domains["technical"]
            weights["keyword"] += boost
            weights["semantic"] -= boost
        total = sum(weights.values())
        if total > 0:
            weights = {s: w / total for s, w in weights.items()}
        self._last = (str(intent), complexity)
        return weights

    def record_feedback(self, weights: Dict[str, float], quality: float,
                        intent: str | None = None,
                        complexity: QueryComplexity | None = None) -> None:
        if intent is None or complexity is None:
            if self._last is None:
                return
            intent, complexity = self._last
        self.tracker.record_query(str(intent), complexity, weights, quality)
        self._since_persist += 1
        if self.db is not None:
            self.db.save_performance(dict(
                agent_id=self.agent_id, intent=str(intent),
                complexity=complexity.value, weights=dict(weights),
                quality=float(quality)))
            if self._since_persist >= self.persist_every:
                learned = self.tracker.get_optimal_weights_for_complexity(
                    str(intent), complexity)
                if learned:
                    self.db.save_learned_weights(
                        self.agent_id, str(intent), complexity.value, learned)
                self._since_persist = 0

    def weights_array(self, weights: Dict[str, float]) -> np.ndarray:
        """(semantic, keyword, temporal) vector for ops.weighted_fusion."""
        return np.asarray([weights["semantic"], weights["keyword"],
                           weights["temporal"]], np.float32)
