"""Models of the port: tokenizer, bi-encoder, cross-encoder and checkpoint
conversion. Re-exports what the port has of
``optimized_rag_tpu/models/__init__.py``, and the loaders."""

from optimized_rag_tpu_torch.models.convert import (
    load_biencoder, load_crossencoder)
from optimized_rag_tpu_torch.models.encoder import (
    BiEncoder, CrossEncoder, CrossEncoderService, EmbeddingService,
    TransformerConfig)
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer

__all__ = ["BiEncoder", "CrossEncoder", "CrossEncoderService",
           "EmbeddingService", "HashTokenizer", "TransformerConfig",
           "load_biencoder", "load_crossencoder"]
