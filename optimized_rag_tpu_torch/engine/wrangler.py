"""Ingest-time data wrangling: clean, structure, dedup, quality-score.

Re-implements rag/data_wrangler.py (TextCleaner:15, StructureExtractor:89,
Deduplicator:252, QualityScorer:329, DataWrangler:432):

  * exact dedup: md5 (reference :256)
  * fuzzy dedup: sequence similarity; Levenshtein lib if present, stdlib
    difflib otherwise (reference uses python-Levenshtein, :271)
  * semantic dedup: ONE batched all-pairs cosine over chunk embeddings
    instead of per-pair calls (reference :295)
  * quality = 0.3*readability + 0.4*density + 0.3*coherence (:427)

Held against ``optimized_rag_tpu/engine/wrangler.py``: the semantic
dedup's pairwise cosine runs on the deduplicator's ``device`` in full
float32, then one copy to the host. Only a ``Deduplicator`` (or
``DataWrangler``) given an ``embed_fn`` resolves a device; the text-only
paths need none.
"""

from __future__ import annotations

import hashlib
import re
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.ops.similarity import pairwise_cosine

try:
    import Levenshtein

    def _seq_ratio(a: str, b: str) -> float:
        return Levenshtein.ratio(a, b)
except ImportError:  # pragma: no cover
    import difflib

    def _seq_ratio(a: str, b: str) -> float:
        return difflib.SequenceMatcher(None, a, b).ratio()


_PT_WORDS = frozenset(
    "que não com uma para você como mais seu sua são dos das pelo pela "
    "também já muito quando então".split())
_ES_WORDS = frozenset(
    "que los las una para con por como más pero sus este esta son muy "
    "cuando entonces".split())
_EN_WORDS = frozenset(
    "the and that with for this have from are was were been they "
    "which their there".split())


def detect_language(text: str) -> str:
    """Coarse language tag (en/pt/es/other) from stopword hits — the
    reference uses langdetect (rag/data_wrangler.py), absent here; this
    covers its bilingual EN/PT usage."""
    words = set(w.lower() for w in text.split()[:300])
    scores = {"en": len(words & _EN_WORDS), "pt": len(words & _PT_WORDS),
              "es": len(words & _ES_WORDS)}
    best = max(scores, key=scores.get)
    if scores[best] == 0:
        return "en" if text.isascii() else "other"
    return best


class TextCleaner:
    _WS = re.compile(r"[ \t]+")
    _NL = re.compile(r"\n{3,}")
    _CTRL = re.compile(r"[\x00-\x08\x0b\x0c\x0e-\x1f\x7f]")
    _URL = re.compile(r"https?://\S+")
    _EMAIL = re.compile(r"\S+@\S+\.\S+")

    def clean(self, text: str, remove_urls: bool = False,
              remove_emails: bool = False) -> str:
        text = self._CTRL.sub("", text)
        if remove_urls:
            text = self._URL.sub(" ", text)
        if remove_emails:
            text = self._EMAIL.sub(" ", text)
        text = self._WS.sub(" ", text)
        text = self._NL.sub("\n\n", text)
        return "\n".join(line.strip() for line in text.split("\n")).strip()


class StructureExtractor:
    """Pulls tables / lists / code blocks out of markdown-ish text."""

    _CODE = re.compile(r"```.*?```", re.DOTALL)
    _TABLE_ROW = re.compile(r"^\s*\|.*\|\s*$", re.MULTILINE)
    _LIST_ITEM = re.compile(r"^\s*(?:[-*+]|\d+\.)\s+.+$", re.MULTILINE)
    _HEADING = re.compile(r"^(#{1,6})\s+(.*)$", re.MULTILINE)

    def extract(self, text: str) -> Dict:
        return {
            "code_blocks": self._CODE.findall(text),
            "table_rows": self._TABLE_ROW.findall(text),
            "list_items": self._LIST_ITEM.findall(text),
            "headings": [(len(h), t) for h, t in self._HEADING.findall(text)],
        }


class Deduplicator:
    def __init__(self, fuzzy_threshold: float = 0.92,
                 semantic_threshold: float = 0.95,
                 embed_fn: Optional[Callable] = None, device="cuda"):
        self.fuzzy_threshold = fuzzy_threshold
        self.semantic_threshold = semantic_threshold
        self.embed_fn = embed_fn
        self.device = (resolve_device(device) if embed_fn is not None
                       else None)

    @staticmethod
    def exact_key(text: str) -> str:
        return hashlib.md5(text.strip().lower().encode()).hexdigest()

    def dedup(self, texts: List[str], semantic: bool = False) -> List[int]:
        """Returns indices of texts to KEEP (first occurrence wins)."""
        keep: List[int] = []
        seen: set = set()
        for i, t in enumerate(texts):
            key = self.exact_key(t)
            if key in seen:
                continue
            # Fuzzy check only against already-kept nearby-size texts.
            dup = any(
                abs(len(t) - len(texts[j])) / max(len(t), len(texts[j]), 1)
                < 0.2 and _seq_ratio(t, texts[j]) >= self.fuzzy_threshold
                for j in keep)
            if dup:
                continue
            seen.add(key)
            keep.append(i)
        if semantic and self.embed_fn is not None and len(keep) > 1:
            emb = self.embed_fn([texts[i] for i in keep])
            sim = pairwise_cosine(torch.as_tensor(
                np.asarray(emb, np.float32), device=self.device)).cpu().numpy()
            final: List[int] = []
            for a in range(len(keep)):
                # Compare against the KEPT candidates (sim rows are
                # keep-local) — iterating positions 0..len(final)-1
                # checked the wrong rows once anything was dropped.
                if all(sim[a, b] < self.semantic_threshold
                       for b in final):
                    final.append(a)
            keep = [keep[a] for a in final]
        return keep


class QualityScorer:
    """Heuristic quality: 0.3*readability + 0.4*density + 0.3*coherence
    (reference :329-427)."""

    def score(self, text: str) -> float:
        words = text.split()
        if not words:
            return 0.0
        sents = max(text.count(".") + text.count("!") + text.count("?"), 1)
        avg_sentence_len = len(words) / sents
        readability = max(0.0, 1.0 - abs(avg_sentence_len - 17.5) / 35.0)
        unique = len(set(w.lower() for w in words))
        density = min(unique / len(words) * 1.5, 1.0)
        alpha_ratio = sum(w.isalpha() for w in words) / len(words)
        coherence = alpha_ratio
        return float(0.3 * readability + 0.4 * density + 0.3 * coherence)


class DataWrangler:
    """Clean -> structure -> quality pipeline for one document
    (reference DataWrangler.process, :432-539)."""

    def __init__(self, min_quality: float = 0.0,
                 embed_fn: Optional[Callable] = None, device="cuda"):
        self.cleaner = TextCleaner()
        self.extractor = StructureExtractor()
        self.scorer = QualityScorer()
        self.dedup = Deduplicator(embed_fn=embed_fn, device=device)
        self.min_quality = min_quality

    def process(self, text: str, metadata: Optional[Dict] = None) -> Dict:
        clean = self.cleaner.clean(text)
        structure = self.extractor.extract(clean)
        quality = self.scorer.score(clean)
        meta = dict(metadata or {})
        meta.setdefault("language", detect_language(clean))
        return {
            "content": clean,
            "structure": structure,
            "quality_score": quality,
            "accepted": quality >= self.min_quality,
            "metadata": meta,
        }
