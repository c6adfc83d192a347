// K1, K2 and K3: packed single-pass scan of the certified top-k.
//
// K1 replaces the TPU kernel `_packed_extract_kernel` + `_pack_tile_scores`
// (optimized_rag_tpu/ops/topk.py:511-527, 576-618, launched by
// `_packed_pass`, :621-694); K2 replaces `_packed_extract_scaled_kernel`
// (:530-545), the scan of the scaled route (`int8_native=False`): the query
// rounded to bf16 times the rows rounded to bf16, an f32 sum, x row scale;
// K3 replaces `_packed_extract_int8_kernel` (:548-573), the same scan over
// an int8 corpus with an int8-native dot. Per corpus tile of `tile` rows and
// per query: the score s, shifted to max(s + 2, 0) (rows at or after `size`
// become 0), the f32 bits with the low log2(tile) bits replaced by the
// tile-local column, the max over each strided unit {u, u + tile/G, ...},
// and the two largest unit winners. A packed value is a non-negative int,
// so int order is float order and every reduction is an integer max.
//
// Output: int32 [T, 2, B], the bits the reference returns as f32; and
// *flag = 1 when a live row scores outside (-2, 2) (the certified path's
// precondition, which the reference leaves unchecked on the device).
//
// The dispatch is by dtype. On the tensor cores (scan_mma.cuh: wgmma fed by
// TMA, register packing): K1 over bf16 and f16 rows, K2 over int8 codes and
// bf16 rows, and K3. On the CUDA cores, the FMA kernel below: K1 over f32
// rows (the tensor cores would need TF32, a different function), and K2
// over f16 and f32 rows, which would need a stage that rounds them to bf16
// (ROADMAP.md, Queue 2); no search path of the port gives K2 such rows at
// a measured shape.
//
// Design of the FMA kernel: one block per (tile, group of QB queries), QB
// = 64, or 16 where 64 queries' unit winners [64, tile/G] would not fit in
// shared memory (tile/G > 768). The block walks its tile in chunks of 128
// rows; each chunk's [QB x 128] scores come from ScoreBlock (QB/16 x 8
// outputs a thread; DenseOps for K1, ScaledOps for K2, topk_common.cuh) and
// are packed in registers, then folded into per-unit winners with
// shared-memory atomicMax (any tile/G works; max is order-free, so the
// result is deterministic). One warp per query then takes the top two
// units.
//
// K1 bound at the f32 search path's shape (B=64, N=4,194,304, D=384, H100
// SXM): 2*B*N*D = 206 GFLOP of f32 FMA on the CUDA cores (TF32 is a
// different function) at 67 TFLOP/s is 3.1 ms, against 6.4 GB of corpus at
// 3.35 TB/s, 1.9 ms: operations bind.
#include "scan_mma.cuh"
#include "topk_common.cuh"

namespace orag {

template <typename Ops, int QB>
using PackBlock = ScoreBlock<Ops, QB, QB / 16, 8>;

// MinBlocks blocks an SM (__launch_bounds__): 3 where three blocks' shared
// memory fits an SM (tile 1024 at groups 8, 57 KB each), which caps ptxas
// at 85 registers a thread (without the cap it takes 98-128 and K1 runs
// slower); 1 where only one fits (tile 4096: about 155 KB), no cap.
template <typename Ops, int QB, int MinBlocks>
__global__ void __launch_bounds__(kThreads, MinBlocks)
    packed_extract_kernel(const Ops ops, const int* __restrict__ size_ptr,
                          int* __restrict__ out, int* __restrict__ flag,
                          int B, int Dw, int tile, int groups) {
  using Block = PackBlock<Ops, QB>;
  constexpr int TQ = QB / 16;
  extern __shared__ float smem[];
  const int small = tile / groups;
  int* gw = reinterpret_cast<int*>(smem + Block::kStageFloats);  // [QB][small]
  const int t = blockIdx.x, qbase = blockIdx.y * QB;
  const int size = *size_ptr;
  const long long base = (long long)t * tile;
  for (int i = threadIdx.x; i < QB * small; i += kThreads) gw[i] = 0;
  const int tq = threadIdx.x / Block::NR, tr = threadIdx.x % Block::NR;
  bool bad = false;
  for (int r0 = 0; r0 < tile; r0 += kRows) {
    float acc[TQ][8];
    Block::run(ops, B, Dw, qbase, base + r0, smem, acc);  // syncs first
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = r0 + tr + j * Block::NR;
        const float s = acc[i][j];  // 0 for queries at or after B
        float sh = fmaxf(s + 2.0f, 0.0f);
        if (base + col >= size) {
          sh = 0.0f;
        } else if (s <= -2.0f || s >= 2.0f) {
          bad = true;
        }
        const int packed = (__float_as_int(sh) & ~(tile - 1)) | col;
        atomicMax(&gw[(tq * TQ + i) * small + col % small], packed);
      }
  }
  if (bad) *flag = 1;
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = warp; qi < QB; qi += kThreads / 32) {
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

template <typename Ops, int QB>
static size_t packed_smem_bytes(int tile, int groups) {
  return (PackBlock<Ops, QB>::kStageFloats +
          (size_t)QB * (tile / groups)) * sizeof(float);
}

template <typename Ops, int QB, int MinBlocks>
static int launch_blocks(const Ops& ops, const int* size, int* out,
                         int* flag, int B, int N, int Dw, int tile,
                         int groups, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      packed_extract_kernel<Ops, QB, MinBlocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / tile, (B + QB - 1) / QB);
  packed_extract_kernel<Ops, QB, MinBlocks><<<grid, kThreads, smem, stream>>>(
      ops, size, out, flag, B, Dw, tile, groups);
  return (int)cudaGetLastError();
}

// Building with -DORAG_PACKED_MIN_BLOCKS=1 or =3 forces one register
// policy at every tile, so that the two can be timed against each other
// (benchmarks_torch/packed_min_blocks.py).
template <typename Ops, int QB>
static int launch_qb(const Ops& ops, const int* size, int* out, int* flag,
                     int B, int N, int Dw, int tile, int groups,
                     cudaStream_t stream) {
  const size_t smem = packed_smem_bytes<Ops, QB>(tile, groups);
#ifdef ORAG_PACKED_MIN_BLOCKS
  const bool three = ORAG_PACKED_MIN_BLOCKS == 3;
#else
  const bool three = 3 * (smem + kSmemReserved) <= (size_t)kSmemPerSM;
#endif
  return three ? launch_blocks<Ops, QB, 3>(ops, size, out, flag, B, N, Dw,
                                           tile, groups, smem, stream)
               : launch_blocks<Ops, QB, 1>(ops, size, out, flag, B, N, Dw,
                                           tile, groups, smem, stream);
}

template <typename Ops>
static int launch(const Ops& ops, const int* size, int* out, int* flag,
                  int B, int N, int D, int tile, int groups,
                  cudaStream_t stream) {
  if (packed_smem_bytes<Ops, 64>(tile, groups) <= (size_t)kMaxSmem)
    return launch_qb<Ops, 64>(ops, size, out, flag, B, N, D, tile, groups,
                              stream);
  return launch_qb<Ops, 16>(ops, size, out, flag, B, N, D, tile, groups,
                            stream);
}

}  // namespace orag

// K1. qT: [D, B] f32 queries already rounded to the corpus dtype (f32
// rows; else null); qh: the same queries [B, D] in the corpus dtype (bf16
// and f16 rows; else null); corpus: [N, D] f32, bf16 or f16 (dtype code,
// topk_common.cuh); flag: int32 [1]. bf16 and f16 rows take the tensor-core
// scan in the accumulation the caller picked from its header's bound
// (`split`); f32 rows the FMA kernel above (split 0).
extern "C" int orag_packed_extract(const float* qT, const void* qh,
                                   const void* corpus, int dtype,
                                   const int* size, int* out, int* flag,
                                   int B, int N, int D, int tile, int groups,
                                   int split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace sc = orag::scan;
  if (dtype == orag::kBF16)
    return sc::launch<__nv_bfloat16, __nv_bfloat16, sc::kPack, sc::kNone>(
        qh, corpus, nullptr, nullptr, size, out, flag, B, N, D, tile, groups,
        split, s);
  if (dtype == orag::kF16)
    return sc::launch<__half, __half, sc::kPack, sc::kNone>(
        qh, corpus, nullptr, nullptr, size, out, flag, B, N, D, tile, groups,
        split, s);
  if (dtype != orag::kF32 || split) return (int)cudaErrorInvalidValue;
  return orag::launch(
      orag::DenseOps<float>{qT, static_cast<const float*>(corpus), D}, size,
      out, flag, B, N, D, tile, groups, s);
}

// K2. qT: [D, B] f32 queries already rounded to bf16 (f16 and f32 rows;
// else null); qh: the same queries [B, D] as bf16 (int8 codes and bf16
// rows; else null); corpus: [N, D] int8 codes or f32/bf16/f16 rows (dtype
// code); cs: [N] row scales. int8 codes and bf16 rows take the tensor-core
// scan in the accumulation the caller picked (`split`); f16 and f32 rows
// the FMA kernel (split 0).
extern "C" int orag_packed_extract_scaled(const float* qT, const void* qh,
                                          const void* corpus, int dtype,
                                          const float* cs, const int* size,
                                          int* out, int* flag, int B, int N,
                                          int D, int tile, int groups,
                                          int split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace sc = orag::scan;
  switch (dtype) {
    case orag::kI8:
      return sc::launch<int8_t, __nv_bfloat16, sc::kPack, sc::kRow>(
          qh, corpus, cs, nullptr, size, out, flag, B, N, D, tile, groups,
          split, s);
    case orag::kBF16:
      return sc::launch<__nv_bfloat16, __nv_bfloat16, sc::kPack, sc::kRow>(
          qh, corpus, cs, nullptr, size, out, flag, B, N, D, tile, groups,
          split, s);
    case orag::kF16:
      if (split) break;
      return orag::launch(orag::ScaledOps<__half>{qT,
                              static_cast<const __half*>(corpus), cs, D},
                          size, out, flag, B, N, D, tile, groups, s);
    case orag::kF32:
      if (split) break;
      return orag::launch(orag::ScaledOps<float>{qT,
                              static_cast<const float*>(corpus), cs, D},
                          size, out, flag, B, N, D, tile, groups, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K3 on the tensor cores. q8: [B, D] int8 query codes; qs: [B] query
// scales; corpus: [N, D] int8 codes; cs: [N] row scales. The int32 sums
// are exact (D <= 131,071).
extern "C" int orag_packed_extract_int8(const void* q8, const float* qs,
                                        const void* corpus, const float* cs,
                                        const int* size, int* out, int* flag,
                                        int B, int N, int D, int tile,
                                        int groups, void* stream) {
  namespace sc = orag::scan;
  return sc::launch<int8_t, int8_t, sc::kPack, sc::kRowQuery>(
      q8, corpus, cs, qs, size, out, flag, B, N, D, tile, groups, 0,
      static_cast<cudaStream_t>(stream));
}
