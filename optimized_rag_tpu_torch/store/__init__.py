"""Durable host-side state of the port, held against
``optimized_rag_tpu/store/__init__.py``: an embedded SQLite store owns the
payloads (document and chunk text, MemGPT memories, KG triples, learned
weights, performance logs, cost accounting); the indexes on the device own
search."""

from optimized_rag_tpu_torch.store.db import MetadataStore
from optimized_rag_tpu_torch.store.memory import MemoryManager
from optimized_rag_tpu_torch.store.kg import (
    KnowledgeGraphExtractor, KnowledgeGraphRetriever)
from optimized_rag_tpu_torch.store.cost import CostTracker, get_cost_tracker

__all__ = ["CostTracker", "KnowledgeGraphExtractor",
           "KnowledgeGraphRetriever", "MemoryManager", "MetadataStore",
           "get_cost_tracker"]
