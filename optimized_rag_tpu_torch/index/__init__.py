"""Indexes of the port (``optimized_rag_tpu/index/__init__.py:12-13``)."""

from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex

__all__ = ["DenseIndex", "LexicalIndex"]
