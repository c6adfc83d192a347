// K4 and K5b: exact per-tile top-k over the union of suspicious tiles (the
// c2 cover).
//
// K4 replaces the TPU kernel `_extract_kernel` + `_extract_rounds`
// (optimized_rag_tpu/ops/topk.py:992-1018, 1053-1066, launched by
// `_extract_pass`, :1069-1141); K5b replaces `_extract_int8_kernel`
// (:1037-1050), the same rounds scored as K3 (Int8Ops). For each listed tile
// id and each query: the exact top-`rounds` rows of the tile by repeated
// max / argmax (lowest column on ties) / mask; rows at or after `size` score
// -1e30.
//
// Output: val f32 [U, rounds, B] and col int32 [U, rounds, B], the column
// local to its tile.
//
// Design: one block per (listed tile, group of 32 queries). The block reads
// its tile id from `tiles` itself (the TPU kernel's scalar prefetch), keeps
// the tile's [32 x tile] scores in shared memory (128 KB at tile=1024, so
// tile <= 1024), and runs the rounds one warp per query (extract_tile).
// The rounds loop takes any count up to the tile: the int8 search asks for
// 64 (a 4x oversample of QueryServer's k bucket of 16).
//
// K4 bound at the f32 search path's shape (B=64, U=32 tiles of 1024 rows,
// D=384, H100 SXM): 2*B*U*tile*D = 1.6 GFLOP of f32 FMA at 67 TFLOP/s is 24
// us, against 50 MB of tiles at 3.35 TB/s, 15 us: operations bind. A bf16
// corpus could use the tensor cores and bytes would bind (7.5 us).
// K5b at the int8 path's shape (B=64, U=32, rounds=64): 12.6 MB of codes
// and scales, 3.8 us, against 1.6 G int8 operations at 1,979 TOP/s, 0.8 us:
// bytes bind; the 64 extraction rounds, not the dot, set this kernel's time.
#include "topk_common.cuh"

namespace orag {

template <typename Ops>
__global__ void __launch_bounds__(kThreads)
    extract_kernel(const Ops ops, const int* __restrict__ size_ptr,
                   const int* __restrict__ tiles, float* __restrict__ val,
                   int* __restrict__ col, int B, int N, int Dw, int tile,
                   int rounds) {
  const int slot = blockIdx.x;
  const int t = tiles[slot];
  if (t < 0 || (long long)t * tile >= N) {  // block-uniform: no sync skipped
    for (int i = threadIdx.x; i < rounds * kExtractQB; i += kThreads) {
      const int r = i / kExtractQB, b = blockIdx.y * kExtractQB + i % kExtractQB;
      if (b < B) {
        val[((long long)slot * rounds + r) * B + b] = kNegInf;
        col[((long long)slot * rounds + r) * B + b] = 0;
      }
    }
    return;
  }
  extract_tile(ops, *size_ptr, B, Dw, tile, t, slot, rounds, 0, val, col);
}

template <typename Ops>
static int launch(const Ops& ops, const int* size, const int* tiles, int U,
                  float* val, int* col, int B, int N, int Dw, int tile,
                  int rounds, cudaStream_t stream) {
  const size_t smem = extract_smem_bytes<Ops>(tile);
  cudaError_t err = cudaFuncSetAttribute(
      extract_kernel<Ops>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(U, (B + kExtractQB - 1) / kExtractQB);
  extract_kernel<Ops><<<grid, kThreads, smem, stream>>>(
      ops, size, tiles, val, col, B, N, Dw, tile, rounds);
  return (int)cudaGetLastError();
}

}  // namespace orag

extern "C" int orag_extract(const float* qT, const void* corpus,
                            int corpus_bf16, const int* size, const int* tiles,
                            int U, float* val, int* col, int B, int N, int D,
                            int tile, int rounds, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return orag::launch(
        orag::DenseOps<__nv_bfloat16>{
            qT, static_cast<const __nv_bfloat16*>(corpus)},
        size, tiles, U, val, col, B, N, D, tile, rounds, s);
  return orag::launch(
      orag::DenseOps<float>{qT, static_cast<const float*>(corpus)}, size,
      tiles, U, val, col, B, N, D, tile, rounds, s);
}

// K5b. qwT: [D/4, B] int32 words of 4 query codes; qs: [B] query scales;
// corpus: [N, D] int8 codes (4-byte aligned); cs: [N] row scales.
extern "C" int orag_extract_int8(const int* qwT, const float* qs,
                                 const void* corpus, const float* cs,
                                 const int* size, const int* tiles, int U,
                                 float* val, int* col, int B, int N, int D,
                                 int tile, int rounds, void* stream) {
  if (!orag::int8_width_ok(D)) return (int)cudaErrorInvalidValue;
  return orag::launch(
      orag::Int8Ops{qwT, qs, static_cast<const int*>(corpus), cs}, size,
      tiles, U, val, col, B, N, D / 4, tile, rounds,
      static_cast<cudaStream_t>(stream));
}
