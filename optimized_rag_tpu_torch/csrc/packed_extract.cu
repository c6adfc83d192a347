// K1 and K3: packed single-pass scan of the certified top-k.
//
// K1 replaces the TPU kernel `_packed_extract_kernel` + `_pack_tile_scores`
// (optimized_rag_tpu/ops/topk.py:511-527, 576-618, launched by
// `_packed_pass`, :621-694); K3 replaces `_packed_extract_int8_kernel`
// (:548-573), the same scan over an int8 corpus with an int8-native dot.
// Per corpus tile of `tile` rows and per query: the score s (DenseOps for
// K1, Int8Ops for K3; topk_common.cuh), shifted to max(s + 2, 0) (rows at
// or after `size` become 0), the f32 bits with the low log2(tile) bits
// replaced by the tile-local column, the max over each strided unit
// {u, u + tile/G, ...}, and the two largest unit winners. A packed value is
// a non-negative int, so int order is float order and every reduction is an
// integer max.
//
// Output: int32 [T, 2, B], the bits the reference returns as f32.
//
// Design: one block per (tile, group of 64 queries). The block walks its
// tile in chunks of 128 rows; each chunk's [64 x 128] scores come from
// ScoreBlock (4x8 outputs a thread) and are packed in registers, then
// folded into per-unit winners with shared-memory atomicMax (any tile/G
// works; max is order-free, so the result is deterministic). One warp per
// query then takes the top two units. The packing epilogue is the same
// code for both scorers.
//
// K1 bound at the f32 search path's shape (B=64, N=4,194,304, D=384, H100
// SXM): 2*B*N*D = 206 GFLOP of f32 FMA on the CUDA cores (TF32 is a
// different function) at 67 TFLOP/s is 3.1 ms, against 6.4 GB of corpus at
// 3.35 TB/s, 1.9 ms: operations bind. A bf16 corpus halves the bytes (1.0
// ms), and its bf16 x bf16 products could run on the tensor cores, so bytes
// bind there. This first kernel scores on the CUDA cores in both cases.
//
// K3 bound at the int8 search path's shape (B=64, N=16,777,216, D=384):
// 6.44 GB of codes plus 67 MB of row scales at 3.35 TB/s is 1.9 ms, against
// 824 G int8 operations at 1,979 TOP/s on the tensor cores, 0.42 ms: bytes
// bind. This first K3 scores on the CUDA cores with __dp4a (4 multiply-adds
// an instruction, exact in int32), which is not enough for the byte bound:
// the tensor cores' s8 x s8 -> s32 path is the later step.
#include "topk_common.cuh"

namespace orag {

constexpr int kPackQB = 64;
template <typename Ops>
using PackBlock = ScoreBlock<Ops, kPackQB, 4, 8>;

template <typename Ops>
__global__ void __launch_bounds__(kThreads)
    packed_extract_kernel(const Ops ops, const int* __restrict__ size_ptr,
                          int* __restrict__ out, int B, int Dw, int tile,
                          int groups) {
  using Block = PackBlock<Ops>;
  extern __shared__ float smem[];
  const int small = tile / groups;
  int* gw = reinterpret_cast<int*>(smem + Block::kStageFloats);  // [QB][small]
  const int t = blockIdx.x, qbase = blockIdx.y * kPackQB;
  const int size = *size_ptr;
  const long long base = (long long)t * tile;
  for (int i = threadIdx.x; i < kPackQB * small; i += kThreads) gw[i] = 0;
  const int tq = threadIdx.x / Block::NR, tr = threadIdx.x % Block::NR;
  for (int r0 = 0; r0 < tile; r0 += kRows) {
    float acc[4][8];
    Block::run(ops, B, Dw, qbase, base + r0, smem, acc);  // syncs first
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = r0 + tr + j * Block::NR;
        float sh = fmaxf(acc[i][j] + 2.0f, 0.0f);
        if (base + col >= size) sh = 0.0f;
        const int packed = (__float_as_int(sh) & ~(tile - 1)) | col;
        atomicMax(&gw[(tq * 4 + i) * small + col % small], packed);
      }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = warp; qi < kPackQB; qi += kThreads / 32) {
    const int b = qbase + qi;
    if (b >= B) break;
    const int* row = gw + qi * small;
    int w0 = 0;
    for (int u = lane; u < small; u += 32) w0 = max(w0, row[u]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w0 = max(w0, __shfl_xor_sync(0xffffffffu, w0, off));
    int w1 = 0;  // unit values are distinct: only w0's own unit drops out
    for (int u = lane; u < small; u += 32)
      if (row[u] != w0) w1 = max(w1, row[u]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      w1 = max(w1, __shfl_xor_sync(0xffffffffu, w1, off));
    if (lane == 0) {
      out[((long long)t * 2 + 0) * B + b] = w0;
      out[((long long)t * 2 + 1) * B + b] = w1;
    }
  }
}

template <typename Ops>
static int launch(const Ops& ops, const int* size, int* out, int B, int N,
                  int Dw, int tile, int groups, cudaStream_t stream) {
  const size_t smem = (PackBlock<Ops>::kStageFloats +
                       (size_t)kPackQB * (tile / groups)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      packed_extract_kernel<Ops>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / tile, (B + kPackQB - 1) / kPackQB);
  packed_extract_kernel<Ops><<<grid, kThreads, smem, stream>>>(
      ops, size, out, B, Dw, tile, groups);
  return (int)cudaGetLastError();
}

}  // namespace orag

extern "C" int orag_packed_extract(const float* qT, const void* corpus,
                                   int corpus_bf16, const int* size, int* out,
                                   int B, int N, int D, int tile, int groups,
                                   void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (corpus_bf16)
    return orag::launch(
        orag::DenseOps<__nv_bfloat16>{
            qT, static_cast<const __nv_bfloat16*>(corpus)},
        size, out, B, N, D, tile, groups, s);
  return orag::launch(
      orag::DenseOps<float>{qT, static_cast<const float*>(corpus)}, size,
      out, B, N, D, tile, groups, s);
}

// K3. qwT: [D/4, B] int32 words of 4 query codes; qs: [B] query scales;
// corpus: [N, D] int8 codes (4-byte aligned); cs: [N] row scales.
extern "C" int orag_packed_extract_int8(const int* qwT, const float* qs,
                                        const void* corpus, const float* cs,
                                        const int* size, int* out, int B,
                                        int N, int D, int tile, int groups,
                                        void* stream) {
  if (!orag::int8_width_ok(D)) return (int)cudaErrorInvalidValue;
  return orag::launch(
      orag::Int8Ops{qwT, qs, static_cast<const int*>(corpus), cs}, size, out,
      B, N, D / 4, tile, groups, static_cast<cudaStream_t>(stream));
}
