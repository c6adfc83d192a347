"""IR evaluation metrics, held against ``optimized_rag_tpu/eval/__init__.py``.

The eval tools are modules of their own, each held against the JAX
package's: ``qa_sheet`` and ``holdout_probes`` (the graded QA sheets over
the agent), ``kg_eval`` (triple extraction), ``encoder_gauntlet`` (the
hard-negative retrieval gauntlet), ``llm_endpoint`` (the loopback
OpenAI-compatible endpoint), ``synthetic`` and ``metrics``."""

from optimized_rag_tpu_torch.eval.metrics import (
    RAGEvaluator, mean_reciprocal_rank, ndcg_at_k, precision_at_k,
    recall_at_k)
