// K4, K5a and K5b: exact per-tile top-k over the union of suspicious tiles
// (the c2 cover); K4p (below): the same selection over (tile, query) pairs,
// the repair of what the covers leave uncovered.
//
// K4 replaces the TPU kernel `_extract_kernel` + `_extract_rounds`
// (optimized_rag_tpu/ops/topk.py:992-1018, 1053-1066, launched by
// `_extract_pass`, :1069-1141); K5a replaces `_extract_scaled_kernel`
// (:1021-1034), the same rounds scored as K2 (ScaledOps: the cover of the
// scaled route); K5b replaces `_extract_int8_kernel` (:1037-1050), the same
// rounds scored as K3 (Int8Ops). For each listed tile id and each query: the
// exact top-`rounds` rows of the tile in the order of repeated max / argmax
// (lowest column on ties) / mask; rows at or after `size` score -1e30; a
// slot whose id is negative or past N writes (-1e30, 0).
//
// Output: val f32 [U, rounds, B] and col int32 [U, rounds, B], the column
// local to its tile.
//
// Design: the streaming selection of topk_common.cuh (stream_topk_kernel):
// one block per (listed tile, 64 queries), reading its tile id from `tiles`
// itself (the TPU kernel's scalar prefetch); bf16 and f16 rows filtered on
// the tensor cores and rescored by the FMA chain. At the served shape (B=64,
// U=32) that is 32 blocks for 132 SMs, so each tile's rows are split over a
// cluster of 2 blocks whose lists rank 0 merges through distributed shared
// memory. Any rounds up to the tile work: above 64 in passes of 64.
//
// K4 bound at the f32 search path's shape (B=64, U=32 tiles of 1024 rows,
// D=384, H100 SXM): 2*B*U*tile*D = 1.6 GFLOP of f32 FMA at 67 TFLOP/s is 24
// us, against 50 MB of tiles at 3.35 TB/s, 15 us: operations bind. A bf16
// corpus is scored on the tensor cores, where bytes bind (7.5 us).
// K5b at the int8 path's shape (B=64, U=32, rounds=64): 12.6 MB of codes
// and scales, 3.8 us, against 1.6 G int8 operations at 1,979 TOP/s, 0.8 us:
// bytes bind. K5a at the reference benchmark's int8 shape (B=1024, U=32
// tiles of 4096, D=128, rounds=10): 17 MB of codes and scales, 5 us,
// against 34 GFLOP of bf16 products at 989 TFLOP/s, 35 us: operations bind;
// on the CUDA cores' f32 FMA, as it scores here, 0.5 ms at least.
//
// K4p: the exact per-pair repair after a nonzero certificate. For each
// listed (tile, query) pair, the query's exact top-`rounds` rows of that
// tile, in the same order and with the same values as K4, K5a or K5b (the
// operand policy of the certificate's cover; K6 and K7 score the same
// functions). The pairs come sorted by tile; each run of one tile's pairs
// is cut into blocks of up to kQB queries, adjacent in the grid, so a tile
// comes from device memory once and its rows are scored only against the
// queries that flagged it. The queries arrive gathered, one per pair
// ([D, P]); a block's queries are the pairs [j, j + block_n[j]); block_n is
// 0 where no block starts (those blocks leave at once).
//
// Output: val f32 [rounds, P] and col int32 [rounds, P], the column local
// to its tile.
//
// K4p bound at the reference benchmark's shape (10,485,760 x 128 bf16 rows,
// tile 4096, rounds 10), per pair whose tile no other pair shares: 1 MB of
// rows at 3.35 TB/s, 0.31 us, against 2 x 4096 x 128 = 1 MFLOP; so a call
// of P pairs over U distinct tiles reads U MB at least, and the rows of a
// block are scored against its queries only.
#include "topk_common.cuh"

namespace orag {

// Block j / split: pairs [j, j + block_n[j]) of tile pair_tile[j].
template <typename Ops, bool Mma>
__global__ void __launch_bounds__(kThreads, 2)
    pair_topk_kernel(const Ops ops, const int* __restrict__ size_ptr,
                     const int* __restrict__ pair_tile,
                     const int* __restrict__ block_n, float* __restrict__ val,
                     int* __restrict__ col, int P, int N, int D, int Dw,
                     int tile, int rounds, int split) {
  const int j = blockIdx.x / split;
  const int n = block_n[j];
  if (n <= 0) return;  // every block of the cluster reads the same j
  select_block<Ops, Mma>(ops, *size_ptr, pair_tile[j], 0, j, j + n, P, val,
                         col, N, D, Dw, tile, rounds, blockIdx.x % split,
                         split, 0);
}

template <typename Ops>
int launch_pairs(const Ops& ops, const int* size, const int* pair_tile,
                 const int* block_n, int P, float* val, int* col, int N,
                 int D, int tile, int rounds, cudaStream_t stream) {
  if (P <= 0) return 0;
  return with_stage<Ops>(D, rounds, [&](auto mma) {
    constexpr bool kMma = decltype(mma)::value;
    return launch_selection<Ops, kMma>(
        pair_topk_kernel<Ops, kMma>, (long long)P, tile, rounds, D, stream,
        ops, size, pair_tile, block_n, val, col, P, N, D, row_words<Ops>(D),
        tile, rounds);
  });
}

}  // namespace orag

// K4. qT: [D, B] f32 queries already rounded to the corpus dtype; corpus:
// [N, D] f32, bf16 or f16 (dtype code, topk_common.cuh).
extern "C" int orag_extract(const float* qT, const void* corpus, int dtype,
                            const int* size, const int* tiles, int U,
                            float* val, int* col, int B, int N, int D,
                            int tile, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return orag::with_dense_ops(qT, corpus, dtype, D, [&](auto ops) {
    return orag::launch_stream(ops, size, tiles, U, val, col, B, N, D, tile,
                               rounds, false, s);
  });
}

// K5a. qT: [D, B] f32 queries already rounded to bf16; corpus: [N, D] int8
// codes or f32/bf16/f16 rows (dtype code); cs: [N] row scales.
extern "C" int orag_extract_scaled(const float* qT, const void* corpus,
                                   int dtype, const float* cs,
                                   const int* size, const int* tiles, int U,
                                   float* val, int* col, int B, int N, int D,
                                   int tile, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return orag::with_scaled_ops(qT, corpus, dtype, cs, D, [&](auto ops) {
    return orag::launch_stream(ops, size, tiles, U, val, col, B, N, D, tile,
                               rounds, false, s);
  });
}

// K5b. qwT: [ceil(D/4), B] int32 words of 4 query codes (zero codes past
// D); qs: [B] query scales; corpus: [N, D] int8 codes; cs: [N] row scales.
extern "C" int orag_extract_int8(const int* qwT, const float* qs,
                                 const void* corpus, const float* cs,
                                 const int* size, const int* tiles, int U,
                                 float* val, int* col, int B, int N, int D,
                                 int tile, int rounds, void* stream) {
  return orag::launch_stream(orag::int8_ops(qwT, qs, corpus, cs, D), size,
                             tiles, U, val, col, B, N, D, tile, rounds,
                             false, static_cast<cudaStream_t>(stream));
}

// K4p scored as K4. qT: [D, P] f32 queries of the pairs, already rounded to
// the corpus dtype; corpus: [N, D] f32, bf16 or f16 (dtype code).
extern "C" int orag_extract_pairs(const float* qT, const void* corpus,
                                  int dtype, const int* size,
                                  const int* pair_tile, const int* block_n,
                                  int P, float* val, int* col, int N, int D,
                                  int tile, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return orag::with_dense_ops(qT, corpus, dtype, D, [&](auto ops) {
    return orag::launch_pairs(ops, size, pair_tile, block_n, P, val, col, N,
                              D, tile, rounds, s);
  });
}

// K4p scored as K5a. qT: [D, P] f32 queries of the pairs rounded to bf16;
// corpus: [N, D] int8 codes or f32/bf16/f16 rows (dtype code); cs: [N].
extern "C" int orag_extract_pairs_scaled(const float* qT, const void* corpus,
                                         int dtype, const float* cs,
                                         const int* size,
                                         const int* pair_tile,
                                         const int* block_n, int P,
                                         float* val, int* col, int N, int D,
                                         int tile, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return orag::with_scaled_ops(qT, corpus, dtype, cs, D, [&](auto ops) {
    return orag::launch_pairs(ops, size, pair_tile, block_n, P, val, col, N,
                              D, tile, rounds, s);
  });
}

// K4p scored as K5b. qwT: [ceil(D/4), P] int32 words of the pairs' query
// codes; qs: [P] their scales; corpus: [N, D] int8 codes; cs: [N].
extern "C" int orag_extract_pairs_int8(const int* qwT, const float* qs,
                                       const void* corpus, const float* cs,
                                       const int* size, const int* pair_tile,
                                       const int* block_n, int P, float* val,
                                       int* col, int N, int D, int tile,
                                       int rounds, void* stream) {
  return orag::launch_pairs(orag::int8_ops(qwT, qs, corpus, cs, D), size,
                            pair_tile, block_n, P, val, col, N, D, tile,
                            rounds, static_cast<cudaStream_t>(stream));
}
