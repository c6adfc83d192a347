// F: the scan-floor kernel, per-tile max(q . c^T).
//
// Replaces the TPU kernel `_floor_kernel` of the reference's kernel sweeps,
// F1 (benchmarks/sweep_r4_kernel.py:128-133, launched by `floor_call`,
// :145) and F2 (benchmarks/sweep_r4c.py:157-162, launched by `floor_one`,
// :167), which compute the same function: the score block of the certified
// scan with one max per tile and query, and no extraction. It is the speed
// floor the packed scans K1 and K3 are timed against.
//
// Output: f32 [T, 1, B], the largest score of each tile for each query,
// scored as K1 (DenseOps: the query rounded to the corpus dtype, f32 FMA in
// ascending order). Every row counts (the reference's floor masks nothing).
//
// Over bf16 and f16 rows F runs the tensor-core scan of scan_mma.cuh with
// its max epilogue (wgmma fed by TMA). What follows is F over f32 rows.
//
// Design: K1's block (one block per tile and group of 64 queries, the same
// ScoreBlock and thread layout) with a max epilogue: each thread keeps the
// running max of its 4 queries over its rows in registers, then the 16
// threads that share a query fold theirs through shared memory. No
// atomics, and no tile-sized shared memory, so a block needs 28 KB at any
// tile.
//
// Bound at the reference benchmark's shape (B=1024, N=10,485,760, D=128,
// bf16 rows, tile 4096, H100 SXM): 2.75 TFLOP at 989 TFLOP/s on the tensor
// cores, 2.78 ms, against 2.68 GB of rows at 3.35 TB/s, 0.80 ms: operations
// bind: the tensor-core scan's bound. On the CUDA cores' f32 FMA, at 67
// TFLOP/s, the same work would take at least 41 ms.
#include <math.h>

#include "scan_mma.cuh"
#include "topk_common.cuh"

namespace orag {

constexpr int kFloorQB = 64;

template <typename Ops>
using FloorBlock = ScoreBlock<Ops, kFloorQB, 4, 8>;

template <typename Ops>
__global__ void __launch_bounds__(kThreads)
    scan_floor_kernel(const Ops ops, float* __restrict__ out, int B, int Dw,
                      int tile) {
  using Block = FloorBlock<Ops>;
  extern __shared__ float smem[];
  float* red = smem + Block::kStageFloats;  // [kFloorQB][NR]
  const int t = blockIdx.x, qbase = blockIdx.y * kFloorQB;
  const long long base = (long long)t * tile;
  const int tq = threadIdx.x / Block::NR, tr = threadIdx.x % Block::NR;
  float m[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int r0 = 0; r0 < tile; r0 += kRows) {
    float acc[4][8];
    Block::run(ops, B, Dw, qbase, base + r0, smem, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) m[i] = fmaxf(m[i], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) red[(tq * 4 + i) * Block::NR + tr] = m[i];
  __syncthreads();
  if (threadIdx.x < kFloorQB) {
    const int qi = threadIdx.x, b = qbase + qi;
    if (b < B) {
      float mx = red[qi * Block::NR];
      for (int r = 1; r < Block::NR; ++r)
        mx = fmaxf(mx, red[qi * Block::NR + r]);
      out[(long long)t * B + b] = mx;
    }
  }
}

template <typename Ops>
static int launch(const Ops& ops, float* out, int B, int N, int D, int tile,
                  cudaStream_t stream) {
  using Block = FloorBlock<Ops>;
  const size_t smem =
      (Block::kStageFloats + (size_t)kFloorQB * Block::NR) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scan_floor_kernel<Ops>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(N / tile, (B + kFloorQB - 1) / kFloorQB);
  scan_floor_kernel<Ops><<<grid, kThreads, smem, stream>>>(ops, out, B, D,
                                                           tile);
  return (int)cudaGetLastError();
}

}  // namespace orag

// F. qT: [D, B] f32 queries already rounded to the corpus dtype (f32 rows;
// else null); qh: the same queries [B, D] in the corpus dtype (bf16 and f16
// rows; else null);
// corpus: [N, D] f32, bf16 or f16 (dtype code, topk_common.cuh); out: f32
// [T, 1, B]. bf16 and f16 rows take the tensor-core scan (scan_mma.cuh) in
// the accumulation the caller picked (`split`), f32 rows the FMA kernel
// above (split 0).
extern "C" int orag_scan_floor(const float* qT, const void* qh,
                               const void* corpus, int dtype, float* out,
                               int B, int N, int D, int tile, int split,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace sc = orag::scan;
  if (dtype == orag::kBF16)
    return sc::launch<__nv_bfloat16, __nv_bfloat16, sc::kFloor, sc::kNone>(
        qh, corpus, nullptr, nullptr, nullptr, out, nullptr, B, N, D, tile,
        1, split, s);
  if (dtype == orag::kF16)
    return sc::launch<__half, __half, sc::kFloor, sc::kNone>(
        qh, corpus, nullptr, nullptr, nullptr, out, nullptr, B, N, D, tile,
        1, split, s);
  if (dtype != orag::kF32 || split) return (int)cudaErrorInvalidValue;
  return orag::launch(
      orag::DenseOps<float>{qT, static_cast<const float*>(corpus), D}, out, B,
      N, D, tile, s);
}

// The tensor-core scan's raw sums, f32 [N, B], in full (split 0) or split
// (1) accumulation: the main loop of K1 and F over bf16 or f16 rows, or of
// K2 over int8 codes (dtype int8: bf16 queries, the codes widened to bf16),
// with a store epilogue, by which the card tests hold its rounding to the
// bound of scan_mma.cuh. qh: the queries [B, D] as the rows' 16-bit type,
// or as bf16 for codes; N a multiple of tile.
extern "C" int orag_scan_sums(const void* qh, const void* corpus, int dtype,
                              float* out, int B, int N, int D, int tile,
                              int split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  namespace sc = orag::scan;
  switch (dtype) {
    case orag::kBF16:
      return sc::launch<__nv_bfloat16, __nv_bfloat16, sc::kRaw, sc::kNone>(
          qh, corpus, nullptr, nullptr, nullptr, out, nullptr, B, N, D, tile,
          1, split, s);
    case orag::kF16:
      return sc::launch<__half, __half, sc::kRaw, sc::kNone>(
          qh, corpus, nullptr, nullptr, nullptr, out, nullptr, B, N, D, tile,
          1, split, s);
    case orag::kI8:
      return sc::launch<int8_t, __nv_bfloat16, sc::kRaw, sc::kNone>(
          qh, corpus, nullptr, nullptr, nullptr, out, nullptr, B, N, D, tile,
          1, split, s);
  }
  return (int)cudaErrorInvalidValue;
}
