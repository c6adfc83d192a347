"""Tensor ops of the port: similarity, int8 quantisation and top-k with its
CUDA kernels. Re-exports what the port has of the reference's public names
(``optimized_rag_tpu/ops/__init__.py:20-25``), ``pallas_topk*`` under the
port's names."""

from optimized_rag_tpu_torch.ops.quantize import dequantize_int8, quantize_int8
from optimized_rag_tpu_torch.ops.similarity import normalize
from optimized_rag_tpu_torch.ops.topk import (
    chunked_topk, exact_topk, rescore_topk, tiled_topk, topk_ann,
    topk_certified, topk_verified)

__all__ = ["chunked_topk", "dequantize_int8", "exact_topk", "normalize",
           "quantize_int8", "rescore_topk", "tiled_topk", "topk_ann",
           "topk_certified", "topk_verified"]
