"""Query engine of the port: hybrid retrieval, selective reranking and the
one-call post-retrieval pass. Re-exports what the port has of
``optimized_rag_tpu/engine/__init__.py``."""

from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
from optimized_rag_tpu_torch.engine.rerank import (
    EmbeddingReranker, SelectiveReranker)
from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
from optimized_rag_tpu_torch.engine.types import (
    Intent, RetrievedDoc, Source, intent_weights, retrieval_strategy)

__all__ = ["EmbeddingReranker", "FusedRerankEval", "HybridRetriever",
           "Intent", "RetrievedDoc", "SelectiveReranker", "Source",
           "intent_weights", "retrieval_strategy"]
