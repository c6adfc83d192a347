"""Indexes of the port (``optimized_rag_tpu/index/__init__.py:12``)."""

from optimized_rag_tpu_torch.index.dense import DenseIndex

__all__ = ["DenseIndex"]
