"""Indexes of the port (``optimized_rag_tpu/index/__init__.py``): the dense
and lexical indexes, their snapshots and the index policy."""

from optimized_rag_tpu_torch.index.dense import DenseIndex
from optimized_rag_tpu_torch.index.lexical import LexicalIndex
from optimized_rag_tpu_torch.index.policy import (
    build_index_for, mesh_or_none, select_index_kind)
from optimized_rag_tpu_torch.index.snapshot import (
    SNAPSHOT_FORMAT_VERSION, exists, load_state, save_state)

__all__ = ["DenseIndex", "LexicalIndex", "SNAPSHOT_FORMAT_VERSION",
           "build_index_for", "exists", "load_state", "mesh_or_none",
           "save_state", "select_index_kind"]
