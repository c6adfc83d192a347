"""Query and ingestion engine of the port: hybrid retrieval, selective
reranking, the one-call post-retrieval pass, and the components a chat
turn consumes. Re-exports what the port has of
``optimized_rag_tpu/engine/__init__.py``."""

from optimized_rag_tpu_torch.engine.types import (
    Intent, RetrievedDoc, Source, intent_weights, retrieval_strategy)
from optimized_rag_tpu_torch.engine.adaptive import (
    DynamicWeightManager, PerformanceTracker, QueryFeatureExtractor)
from optimized_rag_tpu_torch.engine.retriever import HybridRetriever
from optimized_rag_tpu_torch.engine.rerank import (
    EmbeddingReranker, SelectiveReranker)
from optimized_rag_tpu_torch.engine.fused import FusedRerankEval
from optimized_rag_tpu_torch.engine.hierarchical import (
    ConfidenceEvaluator, HierarchicalRetriever)
from optimized_rag_tpu_torch.engine.compressor import ContextCompressor
from optimized_rag_tpu_torch.engine.consistency import ConsistencyChecker
from optimized_rag_tpu_torch.engine.chunking import (
    FixedSizeChunker, RecursiveChunker, SemanticChunker)
from optimized_rag_tpu_torch.engine.wrangler import (
    DataWrangler, Deduplicator, QualityScorer, TextCleaner)

__all__ = ["ConfidenceEvaluator", "ConsistencyChecker", "ContextCompressor",
           "DataWrangler", "Deduplicator", "DynamicWeightManager",
           "EmbeddingReranker", "FixedSizeChunker", "FusedRerankEval",
           "HierarchicalRetriever", "HybridRetriever", "Intent",
           "PerformanceTracker", "QualityScorer", "QueryFeatureExtractor",
           "RecursiveChunker", "RetrievedDoc", "SelectiveReranker",
           "SemanticChunker", "Source", "TextCleaner", "intent_weights",
           "retrieval_strategy"]
