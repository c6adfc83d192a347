"""Tensor ops of the port: similarity, int8 quantisation, top-k with its
CUDA kernels, BM25, fusion, MMR, k-means and the hybrid query. Re-exports what the
port has of the reference's public names
(``optimized_rag_tpu/ops/__init__.py:20-31``), ``pallas_topk*`` under the
port's names."""

from optimized_rag_tpu_torch.ops.bm25 import bm25_score_champions
from optimized_rag_tpu_torch.ops.fusion import (
    minmax_normalize, rrf_fuse, temporal_decay, weighted_fusion)
from optimized_rag_tpu_torch.ops.kmeans import kmeans_assign, kmeans_fit
from optimized_rag_tpu_torch.ops.mmr import mmr_select
from optimized_rag_tpu_torch.ops.quantize import dequantize_int8, quantize_int8
from optimized_rag_tpu_torch.ops.similarity import (
    batched_cosine, cosine_matrix, normalize, pairwise_cosine)
from optimized_rag_tpu_torch.ops.topk import (
    chunked_topk, exact_topk, rescore_topk, tiled_topk, topk_ann,
    topk_certified, topk_verified)

__all__ = ["batched_cosine", "bm25_score_champions", "chunked_topk",
           "cosine_matrix", "dequantize_int8", "exact_topk", "kmeans_assign",
           "kmeans_fit", "minmax_normalize", "mmr_select", "normalize",
           "pairwise_cosine", "quantize_int8", "rescore_topk", "rrf_fuse",
           "temporal_decay", "tiled_topk", "topk_ann", "topk_certified",
           "topk_verified", "weighted_fusion"]
