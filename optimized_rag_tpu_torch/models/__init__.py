"""Models of the port: tokenizer, bi-encoder, cross-encoder, checkpoint
conversion and training. Re-exports what the port has of
``optimized_rag_tpu/models/__init__.py``, the loaders, the trainers and the
checkpoint writer."""

from optimized_rag_tpu_torch.models.convert import (
    load_biencoder, load_crossencoder)
from optimized_rag_tpu_torch.models.encoder import (
    BiEncoder, CrossEncoder, CrossEncoderService, EmbeddingService,
    TransformerConfig)
from optimized_rag_tpu_torch.models.pretrain import (
    load_pretrained, pretrain_all, save_pretrained)
from optimized_rag_tpu_torch.models.tokenizer import HashTokenizer
from optimized_rag_tpu_torch.models.training import (
    AdamW, BiEncoderTrainer, CrossEncoderTrainer, DecoderTrainer)

__all__ = ["AdamW", "BiEncoder", "BiEncoderTrainer", "CrossEncoder",
           "CrossEncoderService", "CrossEncoderTrainer", "DecoderTrainer",
           "EmbeddingService", "HashTokenizer", "TransformerConfig",
           "load_biencoder", "load_crossencoder", "load_pretrained",
           "pretrain_all", "save_pretrained"]
