"""Query understanding: intent recognition, conversation-reference
detection, conditional rewriting, deterministic routing.

Re-implements:
  * IntentRecognizer (rag/intent_recognizer.py:20-156): reference-detector
    pre-check then structured LLM classification
  * ConversationReferenceDetector (rag/conversation_reference_detector.py:
    29-528): anaphora patterns + embedding similarity to history + LLM
    fallback, ensembled
  * QueryRewriter (rag/query_rewriter.py:21-536): System-1 heuristics
    decide which strategies apply; ZERO LLM calls when none do; single
    structured call otherwise; priority contextualized > reformulated >
    simplified > corrected. decompose/expand helpers for multi-hop.
  * QueryRouter (rag/router.py:22-108): deterministic DOCUMENTS-first
    source routing with personalization / follow-up keywords.

Held against ``optimized_rag_tpu/agent/rewriter.py``: the detector's one
cosine runs on its ``device`` in full float32 (TF32 stays off, as the
reference pins ``Precision.HIGHEST``), then one copy to the host; the rest
is a copy whose imports name the port's modules.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from optimized_rag_tpu_torch.agent import prompts
from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.engine.types import Intent, Source
from optimized_rag_tpu_torch.ops.similarity import cosine_matrix


# ---------------------------------------------------------------------------
# Conversation-reference detection
# ---------------------------------------------------------------------------

# EN + PT anaphora patterns (the reference is bilingual,
# conversation_reference_detector.py:204-380).
_REFERENCE_PATTERNS = (
    r"\b(you (said|mentioned|told)|earlier|before|previous(ly)?|"
    r"first question|last (question|answer)|what did i (say|ask))\b",
    r"\b(voc[eê] (disse|falou|mencionou)|anteriormente|"
    r"primeira pergunta|[uú]ltima (pergunta|resposta)|o que eu (disse|perguntei))\b",
)
_REF_RES = tuple(re.compile(p, re.IGNORECASE) for p in _REFERENCE_PATTERNS)

# Queries about the conversation itself — web search can never help these
# (reference hierarchical_retriever.py:470-499, bilingual pattern list).
_CONTEXT_QUERY_RES = tuple(re.compile(p, re.IGNORECASE) for p in (
    r"(primeir|[uú]ltim|pen[uú]ltim)a? pergunta", r"pergunta anterior",
    r"o que (eu )?(perguntei|disse|falei)", r"o que (voc[eê]|n[oó]s)"
    r" (disse|falou|conversamos)", r"nossa conversa",
    r"sobre o que conversamos",
    r"(first|last|previous) question", r"what did (i|we|you)",
    r"what (i|we|you) (ask|said|mention)", r"our conversation",
    r"what we (talked|discussed)", r"earlier in (this|our) conversation",
))


def is_conversation_context_query(query: str) -> bool:
    """True for queries about the conversation history itself, where
    external retrieval (web/KG) cannot help (reference :470-499)."""
    return any(rx.search(query) for rx in _CONTEXT_QUERY_RES)


# PT/EN coreference cue lexicons (reference
# conversation_reference_detector.py:267-357, re-written).
_ORDINALS = ("primeir", "segund", "terceir", "quart", "quint", "ultim",
             "penultim", "anterior", "first", "second", "third", "fourth",
             "fifth", "last", "previous", "prior", "preceding")
_DEMONSTRATIVES = ("isso", "isto", "aquilo", "esse", "este", "aquele",
                   "dessa", "desta", "daquela", "nessa", "nesta",
                   "this", "that", "these", "those")
_TEMPORAL_CUES = ("antes", "agora ha pouco", "voce disse", "você disse",
                  "eu disse", "falamos", "mencionou", "perguntei",
                  "respondeu", "conversamos", "earlier", "just now",
                  "you said", "i said", "we discussed", "mentioned",
                  "asked", "answered", "talked about")
_META_TERMS = ("pergunta", "resposta", "conversa", "topico", "tópico",
               "assunto", "discussao", "discussão", "dialogo", "diálogo",
               "questao", "questão", "question", "answer", "conversation",
               "topic", "subject", "discussion", "dialogue")
_NOT_SELF_CONTAINED = ("qual foi", "o que foi", "what was", "voce falou",
                       "você falou", "eu disse", "we talked", "sobre isso",
                       "about that", "about this", "a pergunta",
                       "the question", "antes", "earlier", "previously")
_SELF_CONTAINED = ("o que e", "o que é", "what is", "como funciona",
                   "how does", "how do", "por que", "why", "quem e",
                   "quem é", "who is", "onde fica", "where is")


class ConversationReferenceDetector:
    """Three-technique ensemble (reference
    conversation_reference_detector.py:50-528): semantic similarity to the
    history (one batched on-device cosine), PT/EN coreference heuristics
    (ordinal / demonstrative / temporal / meta cues with a self-contained
    damper), and an LLM fallback consulted only for the ambiguous middle
    band; results combine by weighted vote (:465-528)."""

    def __init__(self, embed_fn: Optional[Callable] = None, llm=None,
                 semantic_threshold: float = 0.75,
                 enable_llm_fallback: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn
        self.llm = llm
        self.semantic_threshold = semantic_threshold
        self.enable_llm_fallback = enable_llm_fallback

    # -- technique 1: semantic similarity (reference :113-196) --------------

    def _semantic(self, query: str, history: Sequence[Dict]) -> Dict:
        if self.embed_fn is None or not history:
            return {"is_reference": False, "confidence": 0.0}
        texts = [str(m.get("content", ""))[:500] for m in history[-10:]]
        texts = [t for t in texts if t]
        if not texts:
            return {"is_reference": False, "confidence": 0.0}
        embs = np.atleast_2d(self.embed_fn([query] + texts))
        e = torch.as_tensor(np.asarray(embs, np.float32), device=self.device)
        sims = cosine_matrix(e[:1], e[1:]).cpu().numpy()[0]
        best = int(np.argmax(sims))
        best_sim = float(sims[best])
        short = len(query.split()) <= 10
        hit = (short and best_sim > self.semantic_threshold) \
            or best_sim > 0.85
        return {"is_reference": hit, "confidence": max(best_sim, 0.0),
                "referenced_index": best if hit else None}

    # -- technique 2: coreference heuristics (reference :204-265) -----------

    def _coreference(self, query: str, history: Sequence[Dict]) -> Dict:
        ql = query.lower()
        words = ql.split()
        score, reasons = 0.0, []
        if any(o in ql for o in _ORDINALS):
            score += 0.4
            reasons.append("ordinal")
        if len(words) <= 6 and any(d in words for d in _DEMONSTRATIVES):
            score += 0.25
            reasons.append("demonstrative")
        if any(t in ql for t in _TEMPORAL_CUES):
            score += 0.2
            reasons.append("temporal")
        if any(m in ql for m in _META_TERMS):
            score += 0.35
            reasons.append("meta")
        if self._self_contained(ql):
            score *= 0.5
        if len(reasons) >= 2:
            score = min(score * 1.2, 1.0)
        ref_idx = self._resolve_ordinal(ql, len(history)) if history else None
        return {"is_reference": score > 0.5, "confidence": score,
                "reasons": reasons, "referenced_index": ref_idx}

    @staticmethod
    def _self_contained(ql: str) -> bool:
        if any(i in ql for i in _NOT_SELF_CONTAINED):
            return False
        return any(i in ql for i in _SELF_CONTAINED)

    @staticmethod
    def _resolve_ordinal(ql: str, n: int) -> Optional[int]:
        if n == 0:
            return None
        for cues, idx in ((("primeir", "first"), 0),
                          (("segund", "second"), 1),
                          (("terceir", "third"), 2),
                          (("penultim", "second to last"), max(n - 2, 0)),
                          (("ultim", "last", "anterior", "previous"), n - 1)):
            if any(c in ql for c in cues):
                return idx
        return None

    # -- technique 3: LLM fallback (reference :383-463) ----------------------

    def _llm_vote(self, query: str, history: Sequence[Dict]) -> Dict:
        if self.llm is None:
            return {"is_reference": False, "confidence": 0.0}
        recent = "\n".join(
            f"{m.get('role', 'user')}: {str(m.get('content', ''))[:150]}"
            for m in history[-5:]) or "(empty)"
        try:
            raw = self.llm.complete(prompts.CONVERSATION_REFERENCE_PROMPT
                                    .format(history=recent, query=query),
                                    task="conversation_reference")
        except Exception:
            return {"is_reference": False, "confidence": 0.0}
        up = raw.upper()
        is_ref = "IS_REFERENCE" in up and "NOT_REFERENCE" not in up
        m = re.search(r"[01]?\.\d+|[01]\b", raw)
        conf = float(m.group(0)) if m else (0.7 if is_ref else 0.3)
        return {"is_reference": is_ref, "confidence": conf}

    # -- ensemble (reference :465-528) ---------------------------------------

    def detect(self, query: str, history: Sequence[Dict]) -> Dict:
        history = list(history or [])
        pattern_hit = any(rx.search(query) for rx in _REF_RES)
        sem = self._semantic(query, history)
        if sem["is_reference"] and sem["confidence"] > 0.85:
            return {"is_reference": True, "method": "semantic",
                    "confidence": sem["confidence"], "pattern": pattern_hit,
                    "semantic": True,
                    "referenced_index": sem.get("referenced_index")}
        coref = self._coreference(query, history)
        if coref["is_reference"] and coref["confidence"] > 0.8:
            return {"is_reference": True, "method": "coreference",
                    "confidence": coref["confidence"],
                    "pattern": pattern_hit, "semantic": sem["is_reference"],
                    "referenced_index": coref.get("referenced_index")}
        results = [(sem, 0.35), (coref, 0.30)]
        ambiguous = (0.4 < max(sem["confidence"], coref["confidence"])
                     and history)
        if self.enable_llm_fallback and ambiguous:
            results.append((self._llm_vote(query, history), 0.35))
        total_w = sum(w for _, w in results)
        weighted = sum(r["confidence"] * w
                       for r, w in results if r["is_reference"]) / total_w
        votes = sum(1 for r, _ in results
                    if r["is_reference"] and r["confidence"] > 0.5)
        is_ref = weighted > 0.5 or votes >= 2 or pattern_hit
        return {"is_reference": is_ref, "method": "ensemble",
                "confidence": max(weighted,
                                  *(r["confidence"] for r, _ in results)),
                "pattern": pattern_hit, "semantic": sem["is_reference"],
                "referenced_index": coref.get("referenced_index")
                or sem.get("referenced_index")}


# ---------------------------------------------------------------------------
# Intent recognition
# ---------------------------------------------------------------------------

class IntentRecognizer:
    def __init__(self, llm, detector: Optional[ConversationReferenceDetector]
                 = None):
        self.llm = llm
        self.detector = detector

    def recognize(self, query: str, history: Sequence[Dict] = ()) -> Dict:
        # Pre-check: conversation references route to recall
        # (reference intent_recognizer.py:80-100).
        if self.detector is not None:
            ref = self.detector.detect(query, history)
            if ref["is_reference"]:
                return {"intent": Intent.CLARIFICATION, "confidence": 0.95,
                        "is_conversation_reference": True}
        out = self.llm.structured(
            prompts.INTENT_PROMPT.format(query=query),
            keys=("intent", "confidence", "reasoning"), task="intent")
        try:
            intent = Intent(out.get("intent", ""))
        except ValueError:
            intent = Intent.QUESTION_ANSWERING
        return {"intent": intent,
                "confidence": float(out.get("confidence", 0.5) or 0.5),
                "is_conversation_reference": False}


# ---------------------------------------------------------------------------
# Query rewriting
# ---------------------------------------------------------------------------

_AMBIGUOUS = re.compile(
    r"\b(it|that|this|those|these|he|she|they|them|one)\b", re.IGNORECASE)
_TYPO_HINTS = re.compile(r"(.)\1{2,}|\s{2,}")


class QueryRewriter:
    def __init__(self, llm, max_words_simple: int = 25):
        self.llm = llm
        self.max_words_simple = max_words_simple
        self.stats = {"llm_calls": 0, "skipped": 0}

    # System-1 heuristics (reference :92-102).
    def _needs_simplification(self, q: str) -> bool:
        return len(q.split()) > self.max_words_simple

    def _has_ambiguous_references(self, q: str) -> bool:
        return bool(_AMBIGUOUS.search(q))

    def _needs_reformulation(self, q: str, intent) -> bool:
        return intent in (Intent.MULTI_HOP_REASONING, Intent.COMPARISON) \
            and len(q.split()) > 12

    def _has_obvious_errors(self, q: str) -> bool:
        return bool(_TYPO_HINTS.search(q))

    def rewrite(self, query: str, intent: Optional[Intent] = None,
                history: Optional[Sequence[Dict]] = None) -> Dict:
        needs = {
            "simplify": self._needs_simplification(query),
            "contextualize": self._has_ambiguous_references(query)
            and bool(history),
            "reformulate": self._needs_reformulation(query, intent),
            "correct": self._has_obvious_errors(query),
        }
        if not any(needs.values()):
            self.stats["skipped"] += 1
            return {"original": query, "rewritten": query, "strategies": [],
                    "variants": [query]}
        self.stats["llm_calls"] += 1
        hist_text = "\n".join(
            f"{m.get('role', 'user').upper()}: {m.get('content', '')[:300]}"
            for m in (history or [])[-5:]) or "N/A"
        out = self.llm.structured(
            prompts.REWRITE_PROMPT.format(history=hist_text, query=query),
            keys=("rewritten_query", "simplified", "variants",
                  "corrections_applied"),
            task="rewrite")
        rewritten = str(out.get("rewritten_query") or query).strip() or query
        variants = out.get("variants") or [rewritten]
        if not isinstance(variants, list):
            variants = [str(variants)]
        return {"original": query, "rewritten": rewritten,
                "strategies": [k for k, v in needs.items() if v],
                "variants": [str(v) for v in variants if v][:4] or [rewritten]}

    def decompose_query(self, query: str) -> List[str]:
        raw = self.llm.complete(prompts.DECOMPOSE_PROMPT.format(query=query),
                                task="decompose")
        subs = [re.sub(r"^[\d\-.)\s]+", "", ln).strip()
                for ln in raw.splitlines() if ln.strip()]
        return [s for s in subs if len(s) > 3][:4] or [query]

    def expand_query(self, query: str) -> List[str]:
        raw = self.llm.complete(prompts.EXPAND_PROMPT.format(query=query),
                                task="expand")
        alts = [ln.strip("-• \t") for ln in raw.splitlines() if ln.strip()]
        return [query] + [a for a in alts if len(a) > 3][:2]

    def refine(self, query: str, problems: str) -> str:
        return self.llm.complete(
            prompts.REFINE_PROMPT.format(query=query, problems=problems),
            task="refine").strip() or query


# ---------------------------------------------------------------------------
# Deterministic routing
# ---------------------------------------------------------------------------

_PERSONAL_WORDS = ("me", "my", "i ", "remember", "you told")
_FOLLOWUP_WORDS = ("that", "it", "this", "previous", "earlier")


class QueryRouter:
    """DOCUMENTS-first deterministic routing (reference rag/router.py:26-60;
    its LLM path is dead code and intentionally not reproduced)."""

    def route(self, query: str) -> Dict:
        ql = f" {query.lower()} "
        sources = [Source.DOCUMENTS]
        reasoning = "documents first (local knowledge base priority)"
        if any(f" {w}" in ql for w in _PERSONAL_WORDS):
            sources.append(Source.ARCHIVAL)
            reasoning = "documents + archival (personalization detected)"
        if any(f" {w} " in ql for w in _FOLLOWUP_WORDS):
            sources.append(Source.CONVERSATION)
            reasoning += " + conversation history (follow-up detected)"
        return {"sources": sources, "reasoning": reasoning,
                "confidence": 1.0}
