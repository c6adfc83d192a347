"""Frozen plain-Python copy of the checkpoint tokenizer's function.

Copied from ``optimized_rag_tpu_torch/models/tokenizer.py`` at commit
6ca9d44 (``_fnv1a`` :31-35, ``HashTokenizer.tokenize``'s Python path
:44-57, ``encode_batch`` :82-96, ``VocabTokenizer`` :162-208's Python
path), with the C++ fast path left out: the ids are those of the Python
path, which the program's tests hold its native analyzer to. The
vocabulary is the checkpoint's ``tokenizer.vocab.txt``, read as data.
"""

from __future__ import annotations

import re

import numpy as np

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]", re.UNICODE)

PAD_ID, CLS_ID, SEP_ID = 0, 1, 2
NUM_SPECIAL = 4
_TRIGRAM_SPLIT_LEN = 12


def _fnv1a(data: bytes) -> int:
    h = 2166136261
    for byte in data:
        h = ((h ^ byte) * 16777619) & 0xFFFFFFFF
    return h


class Tokenizer:
    """Lower-case word split; words of the learned head vocabulary get
    their own ids, others an FNV-1a hash into the rest of the id space,
    plus character-trigram pieces for words longer than 12 characters."""

    def __init__(self, vocab_path: str | None, vocab_size: int):
        words: list[str] = []
        if vocab_path is not None:
            with open(vocab_path, encoding="utf-8") as f:
                first = f.readline().rstrip("\n")
                if first != "#hash":
                    words = [first] + [ln.rstrip("\n") for ln in f]
        self.vocab_size = vocab_size
        self.words = words[:max(0, vocab_size - NUM_SPECIAL - 1024)]
        self.vocab = {w: NUM_SPECIAL + i for i, w in enumerate(self.words)}
        self._hash_base = NUM_SPECIAL + len(self.words)
        self._space = vocab_size - self._hash_base

    def _tid(self, token: str) -> int:
        hit = self.vocab.get(token)
        if hit is not None:
            return hit
        return self._hash_base + _fnv1a(token.encode("utf-8")) % self._space

    def tokenize(self, text: str) -> list[int]:
        ids: list[int] = []
        for w in _WORD_RE.findall(text.lower()):
            ids.append(self._tid(w))
            if len(w) > _TRIGRAM_SPLIT_LEN and w not in self.vocab:
                ids.extend(self._tid("##" + w[i:i + 3])
                           for i in range(0, len(w) - 2, 3))
        return ids

    def real_tokens(self, text: str, max_len: int) -> int:
        """Tokens the encoder sees for ``text``: [CLS], the body cut to
        ``max_len - 2``, [SEP]."""
        return min(len(self.tokenize(text)), max_len - 2) + 2

    def encode_batch(self, texts: list[str], max_len: int):
        """(ids, mask) [n, L], each row [CLS] body [SEP] then padding, L the
        longest row (padding is masked, so its length does not matter)."""
        toks = [[CLS_ID] + self.tokenize(t)[:max_len - 2] + [SEP_ID]
                for t in texts]
        length = max(len(t) for t in toks)
        ids = np.full((len(texts), length), PAD_ID, np.int64)
        mask = np.zeros((len(texts), length), np.int64)
        for r, t in enumerate(toks):
            ids[r, :len(t)] = t
            mask[r, :len(t)] = 1
        return ids, mask
