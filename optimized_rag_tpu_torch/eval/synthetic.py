"""Synthetic ground-truth evaluation harness.

SURVEY.md §7 hard parts: "No ground-truth datasets exist in the reference:
the eval harness (relevance labels for recall@10, 100k/1M/10M corpora)
must be synthesized." This module builds corpora where relevance is known
by construction and runs the full retrieval engine against them:

  * topic model: T topics, each with a vocabulary cluster; every document
    is drawn from one topic; every query is drawn from one topic and its
    relevant set is that topic's documents
  * embeddings come from whatever embed_fn the caller supplies (the real
    encoder, or the hashing fake) — relevance labels do not depend on
    embedding quality, so this measures the ENGINE (fusion, rerank,
    tiers), not the model

Held against ``optimized_rag_tpu/eval/synthetic.py``, a copy whose imports
name the port's modules.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

from optimized_rag_tpu_torch.eval.metrics import (
    mean_reciprocal_rank, precision_at_k, recall_at_k)


@dataclasses.dataclass
class SyntheticDataset:
    texts: List[str]
    doc_topics: np.ndarray           # [N] int
    queries: List[str]
    query_topics: np.ndarray         # [Q] int
    relevant: List[set]              # per query: doc ids of same topic

    @property
    def num_docs(self) -> int:
        return len(self.texts)


def make_dataset(num_docs: int = 500, num_topics: int = 20,
                 num_queries: int = 50, doc_words: int = 40,
                 query_words: int = 6, vocab_per_topic: int = 50,
                 shared_vocab: int = 200, seed: int = 0
                 ) -> SyntheticDataset:
    rng = np.random.default_rng(seed)
    shared = [f"common{i}" for i in range(shared_vocab)]
    topic_vocab = [[f"t{t}word{i}" for i in range(vocab_per_topic)]
                   for t in range(num_topics)]
    doc_topics = rng.integers(0, num_topics, num_docs)
    texts = []
    for t in doc_topics:
        own = rng.choice(topic_vocab[t], doc_words // 2).tolist()
        mix = rng.choice(shared, doc_words - len(own)).tolist()
        words = own + mix
        rng.shuffle(words)
        texts.append(" ".join(words))
    query_topics = rng.integers(0, num_topics, num_queries)
    queries = [" ".join(rng.choice(topic_vocab[t], query_words))
               for t in query_topics]
    relevant = [set(np.nonzero(doc_topics == t)[0].tolist())
                for t in query_topics]
    return SyntheticDataset(texts, doc_topics, queries, query_topics,
                            relevant)


def evaluate_retriever(retrieve: Callable[[str, int], Sequence],
                       dataset: SyntheticDataset, k: int = 10
                       ) -> Dict[str, float]:
    """retrieve(query, k) -> sequence of objects with .doc_id (or ints)."""
    rows = []
    for q in dataset.queries:
        docs = retrieve(q, k)
        ids = [getattr(d, "doc_id", d) for d in docs]
        ids = ids + [-1] * (k - len(ids))
        rows.append(ids[:k])
    got = np.asarray(rows)
    return {
        f"precision@{k}": float(precision_at_k(got, dataset.relevant,
                                               k).mean()),
        f"recall@{k}": float(recall_at_k(got, dataset.relevant, k).mean()),
        "mrr": mean_reciprocal_rank(got, dataset.relevant),
    }
