// K6 and K7: per-tile top-k of the exact tiled search (the certified path's
// fallback, the whole search below 64*k tiles, and the first pass of the
// verified searches at tile_k=2).
//
// K6 replaces the TPU kernel `_tile_topk_kernel` + `_extract_tile_winners`
// (optimized_rag_tpu/ops/topk.py:142-175, launched by `_tile_pass`,
// :205-263); K7 replaces `_tile_topk_scaled_kernel` (:178-195), the same
// search scored as K2: the query rounded to bf16 times the rows rounded to
// bf16 (int8 codes are exact), an f32 sum, then x row scale (ScaledOps).
// For every corpus tile and query: the top `tile_k` rows in the order of
// repeated max / argmax (lowest column on ties) / mask, rows at or after
// `size` scoring -1e30. The [B, T*tile_k] merge stays in PyTorch.
//
// Output: s f32 [T, tile_k, B] and i int32 [T, tile_k, B], global row ids.
//
// Design: the streaming selection of topk_common.cuh (stream_topk_kernel)
// over every tile: 64 queries a block at any tile, each score computed
// once and folded into a running list per query; bf16 and f16 rows scored
// on the tensor cores as a filter, the rows that could enter a list
// rescored by the FMA chain (the values are the FMA kernels', bit for bit);
// the query blocks of a tile adjacent in the grid so that the tile is read
// from device memory once.
//
// K6 bound at the served f32 fallback's shape (B=64, N=4,194,304, D=384,
// H100 SXM): 206 GFLOP of f32 FMA at 67 TFLOP/s, 3.1 ms, against 6.4 GB at
// 3.35 TB/s, 1.9 ms: operations bind. At the reference benchmark's shape
// (B=1024, 10,485,760 x 128 bf16 rows, tile 4096) 2.75 TFLOP on the tensor
// cores at 989 TFLOP/s, 2.78 ms, against 2.68 GB, 0.80 ms: operations bind;
// the selection (10.7 G compares against a threshold, and the insertions)
// runs beside the products on the CUDA cores.
// K7 bound at the int8 fallback's shape (B=64, N=16,777,216, tile_k=64):
// 6.5 GB of codes and scales plus 0.54 GB of winners at 3.35 TB/s, 2.1 ms,
// against 824 GFLOP of bf16 x int8 products at 989 TFLOP/s on the tensor
// cores, 0.83 ms: bytes bind. K7 still widens the codes and runs f32 FMA on
// the CUDA cores (12 ms of FMA at 67 TFLOP/s), so operations bind it.
#include "topk_common.cuh"

// K6. qT: [D, B] f32 queries already rounded to the corpus dtype; corpus:
// [N, D] f32, bf16 or f16 (dtype code, topk_common.cuh).
extern "C" int orag_tile_topk(const float* qT, const void* corpus, int dtype,
                              const int* size, float* s, int* idx, int B,
                              int N, int D, int tile, int tile_k,
                              void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return orag::with_dense_ops(qT, corpus, dtype, D, [&](auto ops) {
    return orag::launch_stream(ops, size, nullptr, N / tile, s, idx, B, N,
                               D, tile, tile_k, true, st);
  });
}

// K7. qT: [D, B] f32 queries already rounded to bf16; corpus: [N, D] int8
// codes or f32/bf16/f16 rows (dtype code); cs: [N] row scales.
extern "C" int orag_tile_topk_scaled(const float* qT, const void* corpus,
                                     int dtype, const float* cs,
                                     const int* size, float* s, int* idx,
                                     int B, int N, int D, int tile,
                                     int tile_k, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return orag::with_scaled_ops(qT, corpus, dtype, cs, D, [&](auto ops) {
    return orag::launch_stream(ops, size, nullptr, N / tile, s, idx, B, N,
                               D, tile, tile_k, true, st);
  });
}

// Error text for the codes the entry points return.
extern "C" const char* orag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
