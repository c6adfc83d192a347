"""IR evaluation metrics, held against ``optimized_rag_tpu/eval/__init__.py``
(the port has ``metrics`` and ``synthetic``; the other eval tools wait for
ROADMAP.md Queue 1 item 10)."""

from optimized_rag_tpu_torch.eval.metrics import (
    RAGEvaluator, mean_reciprocal_rank, ndcg_at_k, precision_at_k,
    recall_at_k)
