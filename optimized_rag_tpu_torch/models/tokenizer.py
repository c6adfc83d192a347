"""Offline deterministic tokenizers: hashing, and hashing with a learned
head vocabulary.

Held against ``optimized_rag_tpu/models/tokenizer.py``, giving the same
token ids. Lowercase word split, FNV-1a hash into a fixed id space, plus
character-trigram pieces for long words. ASCII text is tokenized by the C++
analyzer (``native.model_tokenize``, and a vocabulary handle of
``native.vocab_build`` for ``VocabTokenizer``), as the JAX package does;
non-ASCII text takes the Python path, which is authoritative.
"""

from __future__ import annotations

import re
import threading

import numpy as np

from optimized_rag_tpu_torch import native

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.UNICODE)

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
MASK_ID = 3
NUM_SPECIAL = 4
_TRIGRAM_SPLIT_LEN = 12  # words longer than this also emit trigram pieces


def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for byte in data:
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


class HashTokenizer:
    def __init__(self, vocab_size: int = 32768, max_len: int = 512):
        assert vocab_size > NUM_SPECIAL
        self.vocab_size = vocab_size
        self.max_len = max_len
        self._space = vocab_size - NUM_SPECIAL

    def _tid(self, token: str) -> int:
        return NUM_SPECIAL + _fnv1a(token.encode("utf-8")) % self._space

    def tokenize(self, text: str) -> list[int]:
        fast = native.model_tokenize(text, self.vocab_size, NUM_SPECIAL,
                                     _TRIGRAM_SPLIT_LEN)
        if fast is not None:
            return fast
        ids: list[int] = []
        for w in _WORD_RE.findall(text.lower()):
            ids.append(self._tid(w))
            if len(w) > _TRIGRAM_SPLIT_LEN:
                ids.extend(self._tid("##" + w[i:i + 3])
                           for i in range(0, len(w) - 2, 3))
        return ids

    def encode(self, text: str, max_len: int | None = None):
        """Single text -> (ids [L], mask [L]) with [CLS] ... [SEP]."""
        max_len = max_len or self.max_len
        body = self.tokenize(text)[: max_len - 2]
        ids = [CLS_ID] + body + [SEP_ID]
        mask = [1] * len(ids)
        pad = max_len - len(ids)
        return (np.asarray(ids + [PAD_ID] * pad, np.int32),
                np.asarray(mask + [0] * pad, np.int32))

    @staticmethod
    def _bucket_len(longest: int, cap: int) -> int:
        """Round a sequence length up the power-of-two ladder (min 8),
        capped at ``cap``: the same padded lengths as the JAX package."""
        length = 8
        while length < longest:
            length *= 2
        return min(length, cap)

    def encode_batch(self, texts: list[str], max_len: int | None = None):
        """Batch encode, padded to the pow2 length ladder
        (``_bucket_len``)."""
        cap = max_len or self.max_len
        toks = [self.tokenize(t)[: cap - 2] for t in texts]
        longest = max((len(t) for t in toks), default=0) + 2
        length = self._bucket_len(longest, cap)
        ids = np.full((len(texts), length), PAD_ID, np.int32)
        mask = np.zeros((len(texts), length), np.int32)
        for r, t in enumerate(toks):
            row = [CLS_ID] + t[: length - 2] + [SEP_ID]
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
        return ids, mask

    # ------------------------------------------------------------ persist

    def save(self, path: str) -> None:
        """HashTokenizer has no learned state; write a marker so load()
        round-trips either tokenizer kind."""
        with open(path, "w", encoding="utf-8") as f:
            f.write("#hash\n")

    @classmethod
    def load(cls, path: str, vocab_size: int, max_len: int = 512):
        with open(path, encoding="utf-8") as f:
            first = f.readline().rstrip("\n")
            if first == "#hash":
                return cls(vocab_size, max_len)
            words = [first] + [ln.rstrip("\n") for ln in f]
        return VocabTokenizer(words, vocab_size, max_len)

    def encode_pairs(self, pairs: list[tuple[str, str]],
                     max_len: int | None = None):
        """(query, doc) pairs -> (ids, mask, type_ids) for the cross-encoder.

        Layout: [CLS] query [SEP] doc [SEP]; type 0 for query, 1 for doc
        (mirrors the ms-marco cross-encoder input of rag/reranker.py:355).
        Sequence length buckets up the pow2 ladder (see _bucket_len).
        """
        cap = max_len or self.max_len
        rows = []
        for q, d in pairs:
            qt = self.tokenize(q)[: cap // 4]
            dt = self.tokenize(d)[: cap - len(qt) - 3]
            row = ([CLS_ID] + qt + [SEP_ID], dt + [SEP_ID])
            rows.append(row)
        longest = max((len(a) + len(b) for a, b in rows), default=0)
        length = self._bucket_len(longest, cap)
        ids = np.full((len(pairs), length), PAD_ID, np.int32)
        mask = np.zeros((len(pairs), length), np.int32)
        types = np.zeros((len(pairs), length), np.int32)
        for r, (a, b) in enumerate(rows):
            row = (a + b)[:length]
            ids[r, :len(row)] = row
            mask[r, :len(row)] = 1
            types[r, len(a):len(row)] = 1
        return ids, mask, types


class VocabTokenizer(HashTokenizer):
    """Hashing tokenizer with a LEARNED head vocabulary.

    FNV-mod collisions make distinct frequent words share one embedding
    row. Here the top-frequency words from the training
    corpus get dedicated collision-free ids; everything else falls back
    to the hash space (plus character trigrams for long words), so OOV
    behavior is unchanged and no network vocab is needed. Deterministic
    given the corpus; persists as one word per line next to the model
    checkpoint (``save``/``HashTokenizer.load``).
    """

    def __init__(self, words: list[str], vocab_size: int = 32768,
                 max_len: int = 512):
        super().__init__(vocab_size, max_len)
        limit = vocab_size - NUM_SPECIAL - 1024  # keep >=1k hash ids
        self.words = list(words)[:max(0, limit)]
        self.vocab = {w: NUM_SPECIAL + i for i, w in enumerate(self.words)}
        self._hash_base = NUM_SPECIAL + len(self.words)
        self._space = vocab_size - self._hash_base
        self._native_handle: int | None = None
        self._native_tried = False
        self._native_free = None       # bound at build; usable in __del__
        self._native_lock = threading.Lock()

    @classmethod
    def train(cls, texts, vocab_size: int = 32768, max_len: int = 512,
              max_words: int | None = None) -> "VocabTokenizer":
        from collections import Counter
        counts: Counter = Counter()
        for t in texts:
            counts.update(_WORD_RE.findall(t.lower()))
        limit = max_words or (vocab_size - NUM_SPECIAL - 1024)
        # deterministic order: by (-count, word)
        words = [w for w, _ in sorted(counts.items(),
                                      key=lambda kv: (-kv[1], kv[0]))[:limit]]
        return cls(words, vocab_size, max_len)

    def _tid(self, token: str) -> int:
        hit = self.vocab.get(token)
        if hit is not None:
            return hit
        return self._hash_base + _fnv1a(token.encode("utf-8")) % self._space

    def tokenize(self, text: str) -> list[int]:
        if not self._native_tried:
            # Built under a lock: two first-tokenize threads would both
            # build, and the loser's C++ vocabulary map would leak.
            with self._native_lock:
                if not self._native_tried:
                    self._native_handle = native.vocab_build(
                        self.words, self.vocab_size, NUM_SPECIAL,
                        _TRIGRAM_SPLIT_LEN)
                    if self._native_handle is not None:
                        # Bound now: __del__ at interpreter shutdown
                        # cannot import safely.
                        self._native_free = native.vocab_free
                    self._native_tried = True
        if self._native_handle is not None:
            fast = native.vocab_tokenize(self._native_handle, text)
            if fast is not None:
                return fast
        ids: list[int] = []
        for w in _WORD_RE.findall(text.lower()):
            ids.append(self._tid(w))
            if len(w) > _TRIGRAM_SPLIT_LEN and w not in self.vocab:
                ids.extend(self._tid("##" + w[i:i + 3])
                           for i in range(0, len(w) - 2, 3))
        return ids

    def __del__(self):
        # Release the C++ vocabulary map: it lives in a process-wide
        # registry that nothing else erases, and agents and tests make many
        # tokenizers.
        h = getattr(self, "_native_handle", None)
        free = getattr(self, "_native_free", None)
        if h is not None and free is not None:
            try:
                free(h)
            except Exception:
                pass
            self._native_handle = None

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.words))
