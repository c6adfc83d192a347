"""3-tier cost-escalating hierarchical retrieval.

Re-implements rag/hierarchical_retriever.py semantics:
  Tier 1 — core-memory keyword scan (free)            (:369-438)
  Tier 2 — hybrid document retrieval (on-device)      (:440-499)
  Tier 3 — agentic fallback (KG / web via callback)   (:501-660)

Escalation is confidence-gated (< threshold, default 0.7, config.py:55).
Confidence = 0.35*avg + 0.25*count + 0.20*consistency + 0.20*top
(:31-74), optionally blended 60/40 with a Self-RAG semantic confidence
(:86-90); intent adjustments: qa/search boost on a strong top hit,
multi_hop penalty on <3 results (:96-105). Per-tier stats mirror
get_statistics (:661-686).

Held against ``optimized_rag_tpu/engine/hierarchical.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from optimized_rag_tpu_torch.engine.types import Intent, RetrievedDoc, Source

# EN + PT function words that must not count as keyword evidence in the
# tier-1 scan — without this, "what is the project about" clears the 0.3
# overlap threshold against any verbose core-memory block on {what, is,
# the, about} alone.
_STOPWORDS = frozenset("""
a about an and are as at be been but by can could did do does for from
had has have he her his how i if in is it its me my no not of on or our
she so that the their them they this to was we were what when where
which who why will with would you your
o a os as um uma de do da dos das em no na nos nas por para com sem que
qual quais como onde quando quem porque e ou não sim eu você ele ela
nós eles elas meu minha seu sua isso isto aquilo sobre entre foi ser
""".split())


class ConfidenceEvaluator:
    def __init__(self, w_avg=0.35, w_count=0.25, w_consistency=0.20,
                 w_top=0.20, semantic_blend=0.4, expected_count=5,
                 boost_threshold=0.85, boost_multiplier=1.15):
        self.w = (w_avg, w_count, w_consistency, w_top)
        self.semantic_blend = semantic_blend
        self.expected_count = expected_count
        self.boost_threshold = boost_threshold
        self.boost_multiplier = boost_multiplier

    def evaluate_confidence(self, docs: Sequence[RetrievedDoc],
                            intent: Intent | str | None = None,
                            semantic_confidence: Optional[float] = None
                            ) -> float:
        if not docs:
            return 0.0
        scores = np.asarray([d.score for d in docs], np.float32)
        avg, top = float(scores.mean()), float(scores.max())
        count_factor = min(len(docs) / self.expected_count, 1.0)
        consistency = (max(0.0, 1.0 - float(scores.var()))
                       if len(docs) > 1 else 0.5)
        wa, wc, wk, wt = self.w
        conf = wa * avg + wc * count_factor + wk * consistency + wt * top
        if semantic_confidence is not None:
            conf = ((1 - self.semantic_blend) * conf
                    + self.semantic_blend * semantic_confidence)
        intent_s = str(getattr(intent, "value", intent))
        if intent_s in ("question_answering", "search", "qa") \
                and top > self.boost_threshold:
            conf = min(conf * self.boost_multiplier, 1.0)
        elif intent_s in ("multi_hop_reasoning", "multi_hop") \
                and len(docs) < 3:
            conf *= 0.8
        return min(conf, 1.0)

    def should_escalate(self, confidence: float, threshold: float) -> bool:
        return confidence < threshold


class HierarchicalRetriever:
    """Host-side tier control over device retrieval steps.

    ``tier2_retriever`` is an engine.retriever.HybridRetriever;
    ``tier3_fn(query, intent) -> List[RetrievedDoc]`` is the agentic
    fallback (KG traversal + web search), injected by the agent layer.
    """

    def __init__(self, tier2_retriever,
                 core_memory_fn: Optional[Callable[[], Dict[str, str]]] = None,
                 tier3_fn: Optional[Callable] = None,
                 escalation_threshold: float = 0.7,
                 tier1_min_score: float = 0.3,
                 evaluator: Optional[ConfidenceEvaluator] = None):
        import inspect
        self.tier2 = tier2_retriever
        self.core_memory_fn = core_memory_fn
        self.tier3_fn = tier3_fn
        # Agentic tier-3 judges sufficiency over the tier-1/2 docs; pass
        # them when the callback accepts a third parameter.
        self._tier3_wants_context = bool(
            tier3_fn is not None
            and len(inspect.signature(tier3_fn).parameters) >= 3)
        self.threshold = escalation_threshold
        self.tier1_min_score = tier1_min_score
        self.evaluator = evaluator or ConfidenceEvaluator()
        self.stats = {
            "tier1_queries": 0, "tier2_queries": 0, "tier3_queries": 0,
            "tier1_hits": 0, "total_queries": 0,
            # Bounded: one float per query per tier would grow without limit
            # in a long-lived server; 1024 samples give a stable avg.
            "tier_latency_ms": {1: deque(maxlen=1024),
                                2: deque(maxlen=1024),
                                3: deque(maxlen=1024)},
        }

    # --------------------------------------------------------------- tiers

    def _retrieve_tier1(self, query: str) -> List[RetrievedDoc]:
        """Keyword scan over core memory blocks (reference :369-438)."""
        if self.core_memory_fn is None:
            return []
        t0 = time.time()
        self.stats["tier1_queries"] += 1
        q_terms = set(query.lower().split()) - _STOPWORDS
        out = []
        for i, (block, content) in enumerate(
                sorted(self.core_memory_fn().items())):
            text = str(content)
            terms = set(text.lower().split())
            overlap = len(q_terms & terms)
            if not q_terms:
                continue
            score = overlap / len(q_terms)
            if score >= self.tier1_min_score:
                out.append(RetrievedDoc(
                    doc_id=-1000 - i, score=score, text=text,
                    source=Source.CORE_MEMORY, tier=1,
                    metadata={"block": block}))
        self.stats["tier_latency_ms"][1].append((time.time() - t0) * 1e3)
        out.sort(key=lambda d: -d.score)
        return out

    def retrieve(self, query: str, top_k: int = 10,
                 intent: Intent | str | None = None,
                 weights: Optional[Dict[str, float]] = None,
                 semantic_confidence: Optional[float] = None
                 ) -> tuple[List[RetrievedDoc], dict]:
        """Returns (docs, info) where info has tier/confidence details."""
        self.stats["total_queries"] += 1
        info = {"tiers_used": [], "confidence": 0.0}

        docs = self._retrieve_tier1(query)
        if docs:
            info["tiers_used"].append(1)
            conf = self.evaluator.evaluate_confidence(
                docs, intent, semantic_confidence)
            info["confidence"] = conf
            if not self.evaluator.should_escalate(conf, self.threshold):
                self.stats["tier1_hits"] += 1
                return docs[:top_k], info

        t0 = time.time()
        self.stats["tier2_queries"] += 1
        t2 = self.tier2.retrieve(query, top_k=top_k, intent=intent,
                                 weights=weights)
        for d in t2:
            d.tier = 2
        self.stats["tier_latency_ms"][2].append((time.time() - t0) * 1e3)
        docs = t2 + [d for d in docs if d.tier == 1]
        info["tiers_used"].append(2)
        conf = self.evaluator.evaluate_confidence(t2, intent,
                                                  semantic_confidence)
        info["confidence"] = conf
        if not self.evaluator.should_escalate(conf, self.threshold) \
                or self.tier3_fn is None:
            return docs[:top_k], info

        t0 = time.time()
        self.stats["tier3_queries"] += 1
        info["tiers_used"].append(3)
        try:
            t3 = (self.tier3_fn(query, intent, docs)
                  if self._tier3_wants_context
                  else self.tier3_fn(query, intent)) or []
        except Exception as exc:  # fail-open like the reference (:610-626)
            info["tier3_error"] = str(exc)
            t3 = []
        for d in t3:
            d.tier = 3
        self.stats["tier_latency_ms"][3].append((time.time() - t0) * 1e3)
        merged = t3 + docs
        info["confidence"] = self.evaluator.evaluate_confidence(
            merged, intent, semantic_confidence)
        return merged[:top_k], info

    def get_statistics(self) -> dict:
        total = max(self.stats["total_queries"], 1)
        lat = {f"tier{t}_avg_ms": (float(np.mean(v)) if v else 0.0)
               for t, v in self.stats["tier_latency_ms"].items()}
        return {
            **{k: v for k, v in self.stats.items()
               if k != "tier_latency_ms"},
            "tier1_rate": self.stats["tier1_hits"] / total,
            "tier3_rate": self.stats["tier3_queries"] / total,
            **lat,
        }
