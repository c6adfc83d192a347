"""Chunking strategies: fixed, recursive, semantic.

Re-implements rag/chunking.py (FixedSizeChunker:23, RecursiveChunker:69,
SemanticChunker:138). The semantic chunker's per-sentence embedding +
running-mean boundary test (:166-221) becomes a single batched embed of
all sentences followed by vectorized boundary detection.

Held against ``optimized_rag_tpu/engine/chunking.py``, a copy whose
imports name the port's modules.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from optimized_rag_tpu_torch.engine.compressor import split_sentences


def _mk_chunk(text: str, i: int, metadata: Optional[Dict]) -> Dict:
    return {"content": text,
            "metadata": {"chunk_id": i, "chunk_size": len(text),
                         **(metadata or {})}}


class FixedSizeChunker:
    """Sliding window by characters with overlap (reference :23-66)."""

    def __init__(self, chunk_size: int = 1200, overlap: int = 150):
        assert overlap < chunk_size
        self.chunk_size = chunk_size
        self.overlap = overlap

    def chunk(self, text: str, metadata: Optional[Dict] = None) -> List[Dict]:
        step = self.chunk_size - self.overlap
        parts = [text[i:i + self.chunk_size]
                 for i in range(0, max(len(text), 1), step)]
        parts = [p for p in parts if p.strip()] or [text]
        return [_mk_chunk(p, i, metadata) for i, p in enumerate(parts)]


class RecursiveChunker:
    """Structure-respecting recursive split (reference :69-137)."""

    SEPARATORS = ("\n\n\n", "\n\n", "\n", ". ", " ", "")

    def __init__(self, chunk_size: int = 1200, overlap: int = 150):
        self.chunk_size = chunk_size
        self.overlap = overlap

    def chunk(self, text: str, metadata: Optional[Dict] = None) -> List[Dict]:
        parts = [p for p in self._split(text, 0) if p.strip()]
        return [_mk_chunk(p, i, metadata) for i, p in enumerate(parts)]

    def _split(self, text: str, sep_idx: int) -> List[str]:
        if len(text) <= self.chunk_size:
            return [text]
        if sep_idx >= len(self.SEPARATORS) or self.SEPARATORS[sep_idx] == "":
            step = self.chunk_size - self.overlap
            return [text[i:i + self.chunk_size]
                    for i in range(0, len(text), step)]
        sep = self.SEPARATORS[sep_idx]
        chunks, current = [], ""
        for part in text.split(sep):
            if len(current) + len(part) + len(sep) <= self.chunk_size:
                current += part + sep
            else:
                if current:
                    chunks.append(current)
                if len(part) > self.chunk_size:
                    chunks.extend(self._split(part, sep_idx + 1))
                    current = ""
                else:
                    current = part + sep
        if current:
            chunks.append(current)
        return chunks


class SemanticChunker:
    """Embedding-boundary chunker (reference :138-236), batched.

    Groups consecutive sentences while cosine(running-mean, next) >=
    threshold and the chunk stays under max_chars.
    """

    def __init__(self, embed_fn: Callable[[List[str]], np.ndarray],
                 threshold: float = 0.75, max_chars: int = 2000,
                 min_sentences: int = 1):
        self.embed_fn = embed_fn
        self.threshold = threshold
        self.max_chars = max_chars
        self.min_sentences = min_sentences

    def chunk(self, text: str, metadata: Optional[Dict] = None) -> List[Dict]:
        sents = split_sentences(text)
        if not sents:
            return [_mk_chunk(text, 0, metadata)] if text.strip() else []
        if len(sents) == 1:
            return [_mk_chunk(sents[0], 0, metadata)]
        emb = self.embed_fn(sents)  # one batched forward for all sentences
        chunks: List[str] = []
        cur: List[str] = [sents[0]]
        mean = emb[0].astype(np.float64).copy()
        for s, e in zip(sents[1:], emb[1:]):
            mean_n = mean / max(np.linalg.norm(mean), 1e-9)
            sim = float(mean_n @ e)
            if sim >= self.threshold and \
                    sum(map(len, cur)) + len(s) <= self.max_chars:
                cur.append(s)
                mean += e  # running mean direction (reference :212-221)
            else:
                chunks.append(" ".join(cur))
                cur, mean = [s], e.astype(np.float64).copy()
        if cur:
            chunks.append(" ".join(cur))
        return [_mk_chunk(c, i, metadata) for i, c in enumerate(chunks)]
