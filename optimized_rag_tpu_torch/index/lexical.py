"""Lexical BM25 index with impact-ordered champion lists.

Held against ``optimized_rag_tpu/index/lexical.py``. The corpus statistics
are built once into dense arrays on the index's device, and each query is a
gather, the BM25 arithmetic, an accumulation and a top-k (ops/bm25.py).

The analyzer is a lowercase word split, a small stopword list, a light
stemmer and FNV-1a hashed term ids. ``add`` counts an ASCII text's terms in
the C++ analyzer (``native.term_counts``), as the JAX package does; a
non-ASCII text takes the Python analyzer, which is authoritative. In the
Python analyzer stems and term ids are memoised per word (a corpus repeats
a few thousand words). ``state_dict`` is interchangeable with the JAX
package's.
"""

from __future__ import annotations

import functools
import re
from collections import Counter, defaultdict

import numpy as np
import torch

from optimized_rag_tpu_torch import native
from optimized_rag_tpu_torch.device import resolve_device
from optimized_rag_tpu_torch.ops.bm25 import bm25_idf, bm25_topk

_WORD_RE = re.compile(r"[a-z0-9]+", re.UNICODE)

# A tiny stopword list: BM25 idf already downweights these, but dropping
# them keeps champion lists pointed at informative terms.
_STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on or that the "
    "to was were will with this these those i you we they what which who".split())


@functools.lru_cache(maxsize=1 << 16)
def _light_stem(w: str) -> str:
    """Suffix-strip + inflection normalization (scanning/scans/scan ->
    scan, stored/storing/store -> stor). Applied identically at index
    and query time, so it only has to be consistent, not linguistically
    perfect. Digit-bearing tokens (bfloat16, v5e) pass through."""
    if any(c.isdigit() for c in w):
        return w
    for suf in ("ings", "ing", "edly", "ed", "es", "s", "ly"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            w = w[: -len(suf)]
            break
    if len(w) > 3 and w[-1] == w[-2] and w[-1] not in "aeiou":
        w = w[:-1]
    if len(w) > 3 and w[-1] == "e":
        w = w[:-1]
    return w


def lexical_tokens(text: str) -> list[str]:
    return [_light_stem(t) for t in _WORD_RE.findall(text.lower())
            if t not in _STOPWORDS]


def _pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


class LexicalIndex:
    """Champion-list BM25 index on ``device``.

    ``cap`` bounds the postings kept per term (impact-ordered by tf);
    scoring is exact when every query term's document frequency <= cap.
    """

    def __init__(self, vocab_hash_bits: int = 17, cap: int = 1024,
                 k1: float = 1.5, b: float = 0.75, device="cuda"):
        self.device = resolve_device(device)
        self.vocab_size = 1 << vocab_hash_bits
        self.cap = cap
        self.k1, self.b = k1, b
        self._postings: dict[int, dict[int, int]] = defaultdict(dict)
        self._doc_len: list[float] = []
        self._device = None   # built arrays, invalidated on add
        self._row_of: dict[int, int] = {}  # term id -> champion row
        self._ids: dict[str, int] = {}     # memo of _term_id

    # ------------------------------------------------------------ building

    def _term_id(self, token: str) -> int:
        # Stable hash (Python's hash() is salted per-process).
        h = 2166136261
        for ch in token.encode("utf-8"):
            h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
        return h % self.vocab_size

    @property
    def size(self) -> int:
        return len(self._doc_len)

    def add(self, texts: list[str]) -> np.ndarray:
        """Add documents; ids align with DenseIndex insertion order.

        ASCII texts go through the C++ analyzer, the others through the
        Python one (``native.term_counts`` declines them)."""
        start = self.size
        ids = self._ids
        for text in texts:
            doc_id = len(self._doc_len)
            counts = native.term_counts(text, self.vocab_size)
            if counts is not None:
                terms, tfs, doc_len = counts
                self._doc_len.append(float(doc_len))
                for term, tf in zip(terms.tolist(), tfs.tolist()):
                    self._postings[term][doc_id] = tf
                continue
            toks = lexical_tokens(text)
            self._doc_len.append(float(len(toks)))
            # Counted per stem, as the JAX package's Python path counts:
            # where two stems share a hashed id, the one seen last sets the
            # count (the C++ analyzer adds them; the two paths differ there).
            for term, tf in Counter(toks).items():
                tid = ids.get(term)
                if tid is None:
                    tid = ids[term] = self._term_id(term)
                self._postings[tid][doc_id] = tf
        self._device = None
        return np.arange(start, self.size, dtype=np.int64)

    def build(self, padded_size: int | None = None) -> None:
        """Materialise the device arrays. Called lazily by search().

        Champion rows exist only for the terms that occur (plus one empty
        sentinel row); ``encode_query`` maps term ids to rows on the host.
        Rows, cap and ``doc_len`` are padded to powers of two, as the JAX
        package pads them; scores past ``size`` are masked to -inf in
        every consumer, and no champion row names a padded document.
        """
        n = max(self.size, 1)
        pad_n = padded_size or _pow2(n)
        terms = sorted(self._postings)
        cap_used = _pow2(max((min(len(p), self.cap)
                              for p in self._postings.values()), default=1))
        rows_pad = _pow2(len(terms) + 1)                 # +1 empty sentinel
        champ_docs = np.zeros((rows_pad, cap_used), np.int32)
        champ_tf = np.zeros((rows_pad, cap_used), np.float32)
        champ_valid = np.zeros((rows_pad, cap_used), bool)
        df = np.zeros(rows_pad, np.int64)
        self._row_of = {}
        for row, t in enumerate(terms):
            postings = self._postings[t]
            self._row_of[t] = row
            df[row] = len(postings)
            items = sorted(postings.items(), key=lambda kv: -kv[1])[:self.cap]
            m = len(items)
            champ_docs[row, :m] = [d for d, _ in items]
            champ_tf[row, :m] = [tf for _, tf in items]
            champ_valid[row, :m] = True
        doc_len = np.zeros(pad_n, np.float32)
        doc_len[:self.size] = self._doc_len
        avg = float(np.mean(self._doc_len)) if self._doc_len else 1.0
        dev = self.device
        self._device = {
            "champ_docs": torch.from_numpy(champ_docs).to(dev),
            "champ_tf": torch.from_numpy(champ_tf).to(dev),
            "champ_valid": torch.from_numpy(champ_valid).to(dev),
            "idf": bm25_idf(torch.from_numpy(df).to(dev), self.size or 1),
            "doc_len": torch.from_numpy(doc_len).to(dev),
            "avg_len": torch.tensor(np.float32(avg), device=dev),
        }

    # ------------------------------------------------------------- queries

    def encode_query(self, text: str, max_terms: int = 32):
        """Query terms -> champion rows (unknown terms drop), as numpy
        (rows [max_terms] int32, valid [max_terms] bool)."""
        if self._device is None:
            self.build()
        rows = [self._row_of[t]
                for t in (self._term_id(tok)
                          for tok in lexical_tokens(text))
                if t in self._row_of][:max_terms]
        q = np.zeros(max_terms, np.int32)
        valid = np.zeros(max_terms, bool)
        q[:len(rows)] = rows
        valid[:len(rows)] = True
        return q, valid

    def query_tensors(self, text: str, max_terms: int = 32):
        """``encode_query`` as tensors on the index's device."""
        q, valid = self.encode_query(text, max_terms)
        return (torch.from_numpy(q).to(self.device),
                torch.from_numpy(valid).to(self.device))

    def search(self, text: str, k: int, max_terms: int = 32):
        """Returns (scores [k] np.f32, ids [k] np.int64); -1 = no match."""
        if self._device is None:
            self.build()
        q, valid = self.query_tensors(text, max_terms)
        d = self._device
        k_eff = min(k, max(self.size, 1))
        scores, ids = bm25_topk(q, valid, d["champ_docs"], d["champ_tf"],
                                d["champ_valid"], d["idf"], d["doc_len"],
                                d["avg_len"], k=k_eff, size=self.size,
                                k1=self.k1, b=self.b)
        scores, ids = scores.cpu().numpy(), ids.cpu().numpy().astype(np.int64)
        out_s = np.full(k, -np.inf, np.float32)
        out_i = np.full(k, -1, np.int64)
        matched = scores > 0.0   # BM25 contributions are strictly positive
        m = int(matched.sum())
        out_s[:m] = scores[matched][:m]
        out_i[:m] = ids[matched][:m]
        return out_s, out_i

    # ------------------------------------------------------------ snapshot

    def state_dict(self) -> dict:
        terms = np.array(sorted(self._postings.keys()), np.int64)
        flat_docs, flat_tf, offsets = [], [], [0]
        for t in terms:
            for d, tf in sorted(self._postings[int(t)].items()):
                flat_docs.append(d)
                flat_tf.append(tf)
            offsets.append(len(flat_docs))
        return {
            "vocab_size": self.vocab_size, "cap": self.cap,
            "k1": self.k1, "b": self.b,
            "doc_len": np.asarray(self._doc_len, np.float32),
            "terms": terms,
            "offsets": np.asarray(offsets, np.int64),
            "flat_docs": np.asarray(flat_docs, np.int64),
            "flat_tf": np.asarray(flat_tf, np.int64),
        }

    @classmethod
    def from_state_dict(cls, state: dict, device="cuda") -> "LexicalIndex":
        bits = int(np.log2(int(state["vocab_size"])))
        idx = cls(bits, int(state["cap"]), float(state["k1"]),
                  float(state["b"]), device=device)
        idx._doc_len = [float(x) for x in state["doc_len"]]
        offs = state["offsets"]
        for j, t in enumerate(state["terms"]):
            lo, hi = int(offs[j]), int(offs[j + 1])
            idx._postings[int(t)] = {
                int(d): int(tf) for d, tf in
                zip(state["flat_docs"][lo:hi], state["flat_tf"][lo:hi])}
        return idx
