"""Host utilities: logging, token budgeting, metrics export, retry.
Held against ``optimized_rag_tpu/utils/__init__.py``."""

from optimized_rag_tpu_torch.utils.logging_config import setup_logging
from optimized_rag_tpu_torch.utils.tokens import (
    calculate_tokens, check_context_overflow, truncate_conversation)
from optimized_rag_tpu_torch.utils.metrics_export import MetricsExporter
from optimized_rag_tpu_torch.utils.retry import retry_with_backoff

__all__ = ["MetricsExporter", "calculate_tokens", "check_context_overflow",
           "retry_with_backoff", "setup_logging", "truncate_conversation"]
