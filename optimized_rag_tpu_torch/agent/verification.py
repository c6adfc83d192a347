"""Anti-hallucination verification stack.

Re-implements the reference's full Phase 1-3 battery with batched
on-device similarity where the reference looped over embeddings:

  SelfRAGEvaluator      rag/self_rag.py:22      retrieval relevance + claim
                                                 -level answer verification
  EnsembleVerifier      rag/ensemble_verifier.py:39  LLM + keyword-Jaccard +
                                                 embedding-cosine voting
  CitationValidator     rag/citation_validator.py:14  [N] format/completeness
  FactualityScorer      rag/factuality_scorer.py:12   composite score +
                                                 auto-refusal
  AttributionMapper     rag/attribution_mapper.py:14  sentence->citation map
  TemporalValidator     rag/temporal_validator.py:15  date/timeline checks
  quantify_uncertainty  rag/nodes/generate_response.py:468  5-factor
  exact_match_verify    rag/nodes/verify_response.py:18     60% term hit
  ConfidenceCalibrator  rag/confidence_calibrator.py:38 (orphan in the
                        reference — wired here into ChatResponse.confidence)
  ClaimAlignmentScorer  rag/claim_alignment.py:29 (orphan — exposed for API
                        parity)

Held against ``optimized_rag_tpu/agent/verification.py``. The four cosine
sites (EnsembleVerifier's claim and claim-batch, SelfRAGEvaluator's
relevance, ClaimAlignmentScorer) run ``cosine_matrix`` on the class's
``device`` in full float32 (TF32 stays off, as the reference pins
``Precision.HIGHEST``), with one copy to the host per call; the rest is a
copy whose imports name the port's modules.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from optimized_rag_tpu_torch.agent import prompts
from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.engine.types import RetrievedDoc
from optimized_rag_tpu_torch.index.lexical import lexical_tokens
from optimized_rag_tpu_torch.ops.similarity import cosine_matrix

_CITE_RE = re.compile(r"\[(\d+)\]")
_SENT_RE = re.compile(r"(?<=[.!?])\s+")
_ABBREV_TAIL = re.compile(
    r"\b(?:Dr|Mr|Mrs|Ms|Prof|St|vs|e\.g|i\.e|et al|al|Fig|Eq|"
    r"Sec|Tab|cf)\.$")
# Context-dependent tails: "No." is an abbreviation only before a
# number ("No. 5"); "etc." usually ENDS its sentence — join only a
# lowercase continuation. Treating them unconditionally merged real
# sentence pairs ("Is it supported? No. The fallback is used.").
_NO_TAIL = re.compile(r"\bNo\.$")
_ETC_TAIL = re.compile(r"\betc\.$")


def split_sentences(text: str) -> List[str]:
    """Sentence split that does not break after title abbreviations —
    a naive split turns "Dr. Alvarez" into a sentence boundary, which
    truncated extractive answers and misaligned claim verification."""
    parts = [s.strip() for s in _SENT_RE.split(text) if s.strip()]
    out: List[str] = []
    for p in parts:
        if out:
            prev = out[-1]
            if (_ABBREV_TAIL.search(prev)
                    or (_NO_TAIL.search(prev) and p[:1].isdigit())
                    or (_ETC_TAIL.search(prev) and p[:1].islower())):
                out[-1] = prev + " " + p
                continue
        out.append(p)
    return out


# ---------------------------------------------------------------------------
# Ensemble claim verification
# ---------------------------------------------------------------------------

def _cosine(a: np.ndarray, b: np.ndarray, device) -> np.ndarray:
    """``cosine_matrix`` of float32 rows ``a`` [M, D] and ``b`` [N, D] on
    ``device``, copied to the host once -> [M, N]."""
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return cosine_matrix(t(a), t(b)).cpu().numpy()


class EnsembleVerifier:
    """Per-claim 3-method vote: LLM + keyword Jaccard + embedding cosine.

    Combination rule (reference ensemble_verifier.py:287-368): weighted
    vote 0.5/0.3/0.2, 2-of-3 agreement, LLM override at confidence >= 0.85.
    """

    def __init__(self, llm, embed_fn: Callable,
                 weights=(0.5, 0.3, 0.2), embedding_threshold: float = 0.60,
                 keyword_threshold: float = 0.25,
                 llm_override_conf: float = 0.85, device="cuda"):
        self.device = resolve_device(device)
        self.llm = llm
        self.embed_fn = embed_fn
        self.weights = weights
        self.embedding_threshold = embedding_threshold
        self.keyword_threshold = keyword_threshold
        self.llm_override_conf = llm_override_conf
        self._emb_cache: Dict[str, np.ndarray] = {}

    def _llm_verify(self, claim: str, evidence: str) -> tuple[bool, float]:
        raw = self.llm.complete(
            prompts.VERIFY_CLAIM_PROMPT.format(claim=claim,
                                               evidence=evidence[:2000]),
            task="verify_claim")
        supported = "NOT_SUPPORTED" not in raw.upper() and \
            "SUPPORTED" in raw.upper()
        m = re.search(r"confidence[:=]?\s*([01]?\.\d+)", raw, re.IGNORECASE)
        return supported, float(m.group(1)) if m else 0.7

    def _keyword_verify(self, claim: str, evidence: str) -> tuple[bool, float]:
        a = set(lexical_tokens(claim))
        b = set(lexical_tokens(evidence))
        jac = len(a & b) / max(len(a | b), 1)
        containment = len(a & b) / max(len(a), 1)
        score = max(jac, containment * 0.8)
        return score >= self.keyword_threshold, min(score * 2, 1.0)

    def _embed(self, text: str) -> np.ndarray:
        hit = self._emb_cache.get(text)
        if hit is None:
            hit = np.atleast_2d(self.embed_fn([text]))[0]
            if len(self._emb_cache) > 512:
                self._emb_cache.pop(next(iter(self._emb_cache)))
            self._emb_cache[text] = hit
        return hit

    def _embedding_verify(self, claim: str, evidence: str
                          ) -> tuple[bool, float]:
        sim = float(_cosine(self._embed(claim)[None],
                            self._embed(evidence[:2000])[None],
                            self.device)[0, 0])
        return sim >= self.embedding_threshold, max(min(sim, 1.0), 0.0)

    def verify_claim(self, claim: str, evidence: str) -> Dict:
        emb_ok, emb_conf = self._embedding_verify(claim, evidence)
        return self._combine(claim, evidence, emb_ok, emb_conf)

    def verify_claims(self, claims: List[str],
                      evidence) -> List[Dict]:
        """Batch verification: ONE embedding dispatch for every claim +
        every evidence doc (per-claim dispatches each pay a device round
        trip; the reference pays an OpenAI RPC per claim instead,
        ensemble_verifier.py:237).

        ``evidence`` is a list of doc texts (preferred) or a single
        string. With a list, each claim is judged against its
        BEST-matching doc — a claim sourced from the 5th retrieved doc
        must not be graded against a truncated prefix of the 1st
        (that failure mode refused correct answers on the QA sheet).
        """
        if not claims:
            return []
        docs = [evidence] if isinstance(evidence, str) else list(evidence)
        docs = [d[:2000] for d in docs if d] or [""]
        embs = np.atleast_2d(self.embed_fn(claims + docs))
        sims = _cosine(embs[:len(claims)], embs[len(claims):],
                       self.device)                # [claims, docs]
        doc_toks = [set(lexical_tokens(d)) for d in docs]
        out = []
        for ci, claim in enumerate(claims):
            # Evidence doc selection, most reliable signal first: the
            # claim's own [N] citation when valid; else the doc that
            # lexically CONTAINS the claim best (embedding sim as the
            # tiebreak — an anisotropic encoder's argmax alone picks
            # wrong docs and a confident verifier then refuses correct
            # answers).
            cited = [int(m) - 1 for m in _CITE_RE.findall(claim)
                     if 1 <= int(m) <= len(docs)]
            if cited:
                b = cited[0]
            else:
                ctoks = set(lexical_tokens(claim))
                cont = [len(ctoks & dt) / max(len(ctoks), 1)
                        for dt in doc_toks]
                b = int(np.lexsort((sims[ci], np.asarray(cont)))[-1])
            emb_conf = float(np.clip(sims[ci, b], 0.0, 1.0))
            out.append(self._combine(
                claim, docs[b],
                bool(sims[ci].max() >= self.embedding_threshold),
                emb_conf))
        return out

    def _combine(self, claim: str, evidence: str, emb_ok: bool,
                 emb_conf: float) -> Dict:
        llm_ok, llm_conf = self._llm_verify(claim, evidence)
        kw_ok, kw_conf = self._keyword_verify(claim, evidence)
        votes = [(llm_ok, llm_conf), (kw_ok, kw_conf), (emb_ok, emb_conf)]
        w = self.weights
        weighted = sum(wi * (1.0 if ok else 0.0)
                       for wi, (ok, _) in zip(w, votes))
        agree = sum(ok for ok, _ in votes)
        supported = weighted >= 0.5 or agree >= 2
        # LLM override on high confidence (reference :349-368).
        if llm_conf >= self.llm_override_conf:
            supported = llm_ok
        return {"supported": supported,
                "confidence": float(np.mean([c for _, c in votes])),
                "methods": {"llm": (llm_ok, llm_conf),
                            "keyword": (kw_ok, kw_conf),
                            "embedding": (emb_ok, emb_conf)}}


# ---------------------------------------------------------------------------
# Self-RAG
# ---------------------------------------------------------------------------

class SelfRAGEvaluator:
    """Retrieval relevance judging + claim-level answer verification
    (reference rag/self_rag.py:49-482)."""

    def __init__(self, llm, embed_fn: Callable,
                 ensemble: Optional[EnsembleVerifier] = None,
                 max_claims: int = 10,
                 hallucination_support: float = 0.6,
                 uncited_ratio_limit: float = 0.5,
                 reretrieve_threshold: float = 0.4, device="cuda"):
        self.device = resolve_device(device)
        self.llm = llm
        self.embed_fn = embed_fn
        self.ensemble = ensemble
        self.max_claims = max_claims
        self.hallucination_support = hallucination_support
        self.uncited_ratio_limit = uncited_ratio_limit
        self.reretrieve_threshold = reretrieve_threshold

    def evaluate_retrieval(self, query: str, docs: Sequence[RetrievedDoc]
                           ) -> Dict:
        """Relevance of retrieved docs to the query — one batched cosine
        instead of per-doc LLM calls (the semantic path; reference :49)."""
        if not docs:
            return {"relevance": 0.0, "per_doc": [], "sufficient": False}
        embs = np.atleast_2d(self.embed_fn([query] + [d.text for d in docs]))
        sims = _cosine(embs[:1], embs[1:], self.device)[0]
        sims01 = np.clip((sims + 1.0) / 2.0, 0.0, 1.0)
        return {"relevance": float(sims01.mean()),
                "per_doc": [float(s) for s in sims01],
                "sufficient": bool(sims01.max() >= 0.5)}

    def extract_claims(self, query: str, answer: str) -> List[str]:
        raw = self.llm.complete(
            prompts.EXTRACT_CLAIMS_PROMPT.format(query=query, answer=answer),
            task="extract_claims")
        claims = [re.sub(r"^\d+[.)]\s*", "", ln).strip()
                  for ln in raw.splitlines() if ln.strip()]
        claims = [c for c in claims if len(c) > 3]
        # Prioritize uncited claims (reference :299-313).
        uncited = [c for c in claims if not _CITE_RE.search(c)]
        cited = [c for c in claims if _CITE_RE.search(c)]
        return (uncited + cited)[: self.max_claims]

    def evaluate_answer(self, query: str, answer: str,
                        docs: Sequence[RetrievedDoc]) -> Dict:
        """Multi-granularity verification (reference :270-423)."""
        claims = self.extract_claims(query, answer)
        evidence = "\n".join(d.text for d in docs)[:6000]
        if self.ensemble is not None:
            # Batched: one embedding dispatch covers every claim, each
            # judged against its best-matching doc.
            verdicts = self.ensemble.verify_claims(
                claims, [d.text for d in docs])
            results = [{"claim": c, **v} for c, v in zip(claims, verdicts)]
        else:
            results = []
            for claim in claims:
                kw = set(lexical_tokens(claim)) & set(
                    lexical_tokens(evidence))
                results.append({
                    "claim": claim,
                    "supported":
                        len(kw) / max(len(set(lexical_tokens(claim))), 1)
                        >= 0.4,
                    "confidence": 0.5})
        supported = sum(r["supported"] for r in results)
        support_ratio = supported / len(results) if results else 1.0
        sents = split_sentences(answer)
        uncited = [s for s in sents if not _CITE_RE.search(s)]
        uncited_ratio = len(uncited) / len(sents) if sents else 0.0
        hallucination = (support_ratio < self.hallucination_support
                         or uncited_ratio > self.uncited_ratio_limit)
        return {"claims": results, "support_ratio": support_ratio,
                "uncited_ratio": uncited_ratio,
                "hallucination_flag": hallucination}

    def should_reretrieve(self, relevance: float, attempts: int,
                          max_attempts: int = 2) -> bool:
        return relevance < self.reretrieve_threshold and \
            attempts < max_attempts


# ---------------------------------------------------------------------------
# Citation validation / factuality / attribution
# ---------------------------------------------------------------------------

class CitationValidator:
    """[N] format + source-map completeness (rag/citation_validator.py)."""

    def validate_citations(self, answer: str, num_sources: int,
                           strict: bool = False) -> Dict:
        cites = [int(c) for c in _CITE_RE.findall(answer)]
        invalid = [c for c in cites if c < 1 or c > num_sources]
        sents = split_sentences(answer)
        uncited = [s for s in sents
                   if not _CITE_RE.search(s) and len(s.split()) > 4]
        valid = not invalid and bool(cites) if num_sources else True
        if strict and uncited:
            valid = False
        return {"valid": valid, "citation_count": len(cites),
                "invalid_citations": invalid,
                "uncited_claims": uncited,
                "unique_sources_cited": len(set(cites))}


class FactualityScorer:
    """score = 0.50*support + 0.25*citation_coverage + 0.20*confidence
    + 0.05*retrieval_quality; x0.5 zero-citation penalty; refuse < 0.50
    (reference rag/factuality_scorer.py:25-226)."""

    def __init__(self, weights=(0.50, 0.25, 0.20, 0.05),
                 zero_citation_penalty: float = 0.5,
                 refusal_threshold: float = 0.50):
        self.weights = weights
        self.zero_citation_penalty = zero_citation_penalty
        self.refusal_threshold = refusal_threshold

    def calculate(self, support_ratio: float, citation_coverage: float,
                  confidence: float, retrieval_quality: float,
                  citation_count: int) -> Dict:
        ws, wc, wf, wr = self.weights
        score = (ws * support_ratio + wc * citation_coverage
                 + wf * confidence + wr * retrieval_quality)
        if citation_count == 0:
            score *= self.zero_citation_penalty
        level = ("excellent" if score >= 0.85 else
                 "good" if score >= 0.70 else
                 "fair" if score >= 0.50 else "poor")
        return {"factuality_score": float(score), "level": level,
                "should_refuse": score < self.refusal_threshold}


class AttributionMapper:
    """sentence -> citations -> sources map; fully_traceable at >= 95%
    (reference rag/attribution_mapper.py:14-216)."""

    def create_attribution_map(self, answer: str,
                               docs: Sequence[RetrievedDoc]) -> Dict:
        sents = split_sentences(answer)
        entries = []
        attributed = 0
        for s in sents:
            cites = [int(c) for c in _CITE_RE.findall(s)]
            srcs = [docs[c - 1].doc_id for c in cites
                    if 1 <= c <= len(docs)]
            if srcs:
                attributed += 1
            entries.append({"sentence": s, "citations": cites,
                            "source_ids": srcs})
        rate = attributed / len(sents) if sents else 1.0
        return {"entries": entries, "attribution_rate": rate,
                "fully_traceable": rate >= 0.95}

    @staticmethod
    def format_attribution_map(amap: Dict) -> str:
        lines = [f"attribution_rate={amap['attribution_rate']:.2f}"]
        for e in amap["entries"]:
            mark = ",".join(map(str, e["citations"])) or "-"
            lines.append(f"[{mark}] {e['sentence'][:80]}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Temporal validation
# ---------------------------------------------------------------------------

_DATE_RES = (
    re.compile(r"\b(\d{4})-(\d{2})-(\d{2})\b"),
    re.compile(r"\b(?:jan|feb|mar|apr|may|jun|jul|aug|sep|oct|nov|dec)"
               r"[a-z]*\.?\s+\d{1,2},?\s+(\d{4})\b", re.IGNORECASE),
    re.compile(r"\b(1[0-9]{3}|20[0-9]{2})\b"),
)


def extract_years(text: str) -> List[int]:
    years = []
    for rx in _DATE_RES:
        for m in rx.finditer(text):
            y = int(m.group(1))
            if 1000 <= y <= 2999:
                years.append(y)
    return years


class TemporalValidator:
    """Date/timeline hallucination checks (rag/temporal_validator.py:26-350):
    reversed ranges, answer-dates absent from context, future dates outside
    predictions."""

    _RANGE_RE = re.compile(r"\b(from|between)\s+(\d{4})\s+(?:to|and|until)"
                           r"\s+(\d{4})", re.IGNORECASE)
    _PREDICTION_WORDS = ("will", "expected", "forecast", "predict",
                         "planned", "upcoming", "future")

    def __init__(self, current_year: int = 2026):
        self.current_year = current_year

    def validate(self, answer: str, docs: Sequence[RetrievedDoc]) -> Dict:
        issues: List[str] = []
        for kind, a, b in self._RANGE_RE.findall(answer):
            if int(a) > int(b):
                issues.append(f"reversed date range {a}->{b}")
        context_years = set()
        for d in docs:
            context_years.update(extract_years(d.text))
        answer_l = answer.lower()
        is_prediction = any(w in answer_l for w in self._PREDICTION_WORDS)
        for y in extract_years(answer):
            if context_years and y not in context_years:
                issues.append(f"year {y} not present in any source")
            if y > self.current_year and not is_prediction:
                issues.append(f"non-prediction future year {y}")
        return {"valid": not issues, "issues": issues}


# ---------------------------------------------------------------------------
# Uncertainty / exact-match / calibration / alignment
# ---------------------------------------------------------------------------

_HEDGING = ("might", "maybe", "possibly", "probably", "likely", "perhaps",
            "it seems", "appears to", "could be", "may be", "uncertain",
            "not sure", "unclear")


def quantify_uncertainty(answer: str, faithfulness: float,
                         factuality_score: float, citation_valid: bool,
                         citation_count: int, context_sufficient: bool,
                         context_max_score: float) -> Dict:
    """5-factor uncertainty (reference generate_response.py:468-530)."""
    reasons: List[str] = []
    u = 0.0
    if faithfulness < 0.7:
        reasons.append(f"low faithfulness ({faithfulness:.2f})")
        u += 0.3 * (1.0 - faithfulness)
    if factuality_score < 0.5:
        reasons.append(f"low factuality ({factuality_score:.2f})")
        u += 0.3 * (1.0 - factuality_score)
    if not citation_valid:
        reasons.append(f"poor citations ({citation_count})")
        u += 0.2
    if not context_sufficient:
        reasons.append(f"weak context (max={context_max_score:.2f})")
        u += 0.2 * (1.0 - context_max_score)
    hedging = sum(1 for p in _HEDGING if p in answer.lower())
    if hedging >= 3:
        reasons.append(f"hedging language ({hedging})")
        u += min(0.1 * hedging, 0.3)
    u = min(u, 1.0)
    return {"uncertainty": u, "confidence": 1.0 - u, "reasons": reasons}


def exact_match_verify(claim: str, evidence: str,
                       term_ratio: float = 0.60) -> bool:
    """Pass 2 of verify_response: key-term hit rate >= 60%
    (reference rag/nodes/verify_response.py:18-43)."""
    terms = [t for t in lexical_tokens(claim) if len(t) > 3]
    if not terms:
        return True
    ev = evidence.lower()
    hits = sum(1 for t in terms if t in ev)
    return hits / len(terms) >= term_ratio


class ConfidenceCalibrator:
    """Temperature-scaling calibration, clamped to [0.05, 0.95]
    (reference rag/confidence_calibrator.py:38-72 — orphan there, wired
    into ChatResponse.confidence here)."""

    def __init__(self, temperature: float = 1.5,
                 lo: float = 0.05, hi: float = 0.95):
        self.temperature = temperature
        self.lo, self.hi = lo, hi

    def calibrate(self, confidence: float, support_ratio: float = 1.0,
                  had_contradictions: bool = False) -> float:
        c = min(max(confidence, 1e-6), 1 - 1e-6)
        logit = math.log(c / (1 - c)) / self.temperature
        cal = 1 / (1 + math.exp(-logit))
        if support_ratio < 0.5:
            cal *= 0.8    # penalty table (reference :58-72)
        if had_contradictions:
            cal *= 0.85
        return float(min(max(cal, self.lo), self.hi))


class ClaimAlignmentScorer:
    """claim <-> document alignment typing (rag/claim_alignment.py:29-43:
    exact / paraphrase / partial / weak thresholds)."""

    THRESHOLDS = (("exact", 0.95), ("paraphrase", 0.85),
                  ("partial", 0.70), ("weak", 0.50))

    def __init__(self, embed_fn: Callable, device="cuda"):
        self.device = resolve_device(device)
        self.embed_fn = embed_fn

    def align(self, claim: str, docs: Sequence[str]) -> Dict:
        if not docs:
            return {"type": "none", "best_doc": -1, "similarity": 0.0}
        embs = np.atleast_2d(self.embed_fn([claim] + list(docs)))
        sims = _cosine(embs[:1], embs[1:], self.device)[0]
        best = int(np.argmax(sims))
        sim = float(sims[best])
        kind = "none"
        for name, thr in self.THRESHOLDS:
            if sim >= thr:
                kind = name
                break
        return {"type": kind, "best_doc": best, "similarity": sim}
