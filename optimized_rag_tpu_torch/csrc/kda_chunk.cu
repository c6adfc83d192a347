// KDA's walk over chunks: the sequential part of the chunked gated delta
// rule of Kimi Linear's KDA layers (optimized_rag_tpu_torch/ops/kda.py).
//
// It replaces no TPU kernel: the JAX package has no recurrent layer. It was
// added because the prefill's chunk walk is a loop of some 512 dependent
// steps a row, a layer and a prefill chunk, which in torch would be that
// many rounds of small launches from the host.
//
// For each segment (a row's tokens in one prefill chunk, cut into chunks of
// C = 64 by ops/kda.py, which also computes everything inside a chunk), for
// each head, from the row's state S [d_k, d_v] (float32, read from and
// written back to `state`), for each of its chunks in order:
//
//   u' = U - W S;   o = Q~ S + A_qk u';   S <- Diag(gamma) S + K^T u'
//
// with W, U, Q~ = q exp(G), K^ = k exp(G_C - G) [C, 128] each, A_qk [C, C]
// (lower, with its diagonal) and gamma = exp(G_C) [128]. Every product
// takes float32 operands and accumulates in float32 on the CUDA cores: no
// tensor core. A block walks one (segment, head) over 64 of the 128 value
// columns (the columns of S never mix), so each segment and head runs as
// two blocks; S's 64 columns stay in shared memory from the first chunk to
// the last.
//
// Bound: per chunk and head 3 C d_k d_v + C (C + 1) d_v / 2 multiply-adds
// (6.8 MFLOP) against five float32 tiles of C x 128 read or written and
// A_qk (176 KB): 39 FLOP a byte. That is above the ridge of float32 on the
// CUDA cores (67 TFLOP/s over 3.35 TB/s = 20), so this kernel is bound by
// its operations there: 3.3 ms for a prefill chunk of 65,536 tokens and 32
// heads (7.7 ms measured on an H100); and below the ridge of bf16 on the
// tensor cores (295), where bytes would bind (0.85 ms at bf16 operands).
// The two column blocks of a head read W, Q~ and K^ twice, the second time
// mostly from L2.
//
// Design: 256 threads; each of the [C][64] outputs of the first two
// products is one of 4 x 4 register tiles (16 row groups by 16 column
// groups), each of S's [128][64] one of 8 x 4. One shared buffer holds W,
// then Q~, then K^ of the chunk in turn (rows padded to 132 floats so that
// the two row groups a warp reads fall in different banks); u', A_qk,
// gamma and S have buffers of their own: 100 KB, two blocks an SM.
#include <cuda_runtime.h>

namespace kda {

constexpr int kC = 64;         // tokens a chunk
constexpr int kDK = 128;       // key channels a head
constexpr int kDV = 128;       // value channels a head
constexpr int kCols = 64;      // value columns a block walks
constexpr int kThreads = 256;
constexpr int kLdT = kDK + 4;  // row stride of the [C][d_k] tile buffer
constexpr int kLdA = kC + 4;   // row stride of A_qk's buffer

constexpr int kSmemFloats =
    kDK * kCols + kC * kLdT + kC * kLdA + kC * kCols + kDK;

// Rows [C][128] starting at `src` (row stride `ld` floats) into the tile
// buffer.
__device__ __forceinline__ void load_tile(float* __restrict__ t,
                                          const float* __restrict__ src,
                                          int ld) {
  for (int i = threadIdx.x; i < kC * kDK / 4; i += kThreads) {
    const int r = i / (kDK / 4), c = (i % (kDK / 4)) * 4;
    *reinterpret_cast<float4*>(t + r * kLdT + c) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)r * ld + c));
  }
}

__global__ void __launch_bounds__(kThreads)
    chunk_state_kernel(const float* __restrict__ wu,
                       const float* __restrict__ qt,
                       const float* __restrict__ aqk,
                       const float* __restrict__ kh,
                       const float* __restrict__ gam,
                       const int* __restrict__ offsets,
                       const int* __restrict__ rows,
                       float* __restrict__ state, float* __restrict__ out,
                       int H) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* S = smem;                  // [d_k][kCols]
  float* T = S + kDK * kCols;       // [C][kLdT]: W, then Q~, then K^
  float* A = T + kC * kLdT;         // [C][kLdA]
  float* Uc = A + kC * kLdA;        // [C][kCols]: u'
  float* g = Uc + kC * kCols;       // [d_k]

  const int col0 = blockIdx.x * kCols, h = blockIdx.y, seg = blockIdx.z;
  const int tid = threadIdx.x;
  float* st = state + ((size_t)rows[seg] * H + h) * kDK * kDV + col0;
  for (int i = tid; i < kDK * kCols / 4; i += kThreads) {
    const int d = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(S + d * kCols + c) =
        *reinterpret_cast<const float4*>(st + d * kDV + c);
  }
  const int r0 = (tid / 16) * 4;   // 4 rows of the [C][kCols] products
  const int c0 = (tid % 16) * 4;   // 4 columns
  const int d0 = (tid / 16) * 8;   // 8 rows of S in its update

  for (int n = offsets[seg]; n < offsets[seg + 1]; ++n) {
    const size_t m = (size_t)n * H + h;
    const float* wum = wu + m * kC * (kDK + kDV);
    __syncthreads();  // S is whole; the buffers are free
    load_tile(T, wum, kDK + kDV);
    for (int i = tid; i < kC * kC / 4; i += kThreads) {
      const int r = i / (kC / 4), c = (i % (kC / 4)) * 4;
      *reinterpret_cast<float4*>(A + r * kLdA + c) = __ldg(
          reinterpret_cast<const float4*>(aqk + m * kC * kC + r * kC + c));
    }
    if (tid < kDK) g[tid] = gam[m * kDK + tid];
    __syncthreads();

    // u' = U - W S
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(
          wum + (size_t)(r0 + i) * (kDK + kDV) + kDK + col0 + c0));
      acc[i][0] = u.x, acc[i][1] = u.y, acc[i][2] = u.z, acc[i][3] = u.w;
    }
#pragma unroll 4
    for (int d = 0; d < kDK; ++d) {
      const float4 s = *reinterpret_cast<const float4*>(S + d * kCols + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = T[(r0 + i) * kLdT + d];
        acc[i][0] -= w * s.x, acc[i][1] -= w * s.y;
        acc[i][2] -= w * s.z, acc[i][3] -= w * s.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(Uc + (r0 + i) * kCols + c0) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();  // u' is whole; W is read

    // o = Q~ S + A_qk u'
    load_tile(T, qt + m * kC * kDK, kDK);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kDK; ++d) {
      const float4 s = *reinterpret_cast<const float4*>(S + d * kCols + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float q = T[(r0 + i) * kLdT + d];
        acc[i][0] += q * s.x, acc[i][1] += q * s.y;
        acc[i][2] += q * s.z, acc[i][3] += q * s.w;
      }
    }
    // A_qk is 0 above its diagonal: rows r0..r0+3 need columns to r0+3.
    for (int t = 0; t < r0 + 4; ++t) {
      const float4 u = *reinterpret_cast<const float4*>(Uc + t * kCols + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = A[(r0 + i) * kLdA + t];
        acc[i][0] += a * u.x, acc[i][1] += a * u.y;
        acc[i][2] += a * u.z, acc[i][3] += a * u.w;
      }
    }
    float* om = out + m * kC * kDV + col0 + c0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<float4*>(om + (r0 + i) * kDV) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    __syncthreads();  // Q~ and S are read

    // S <- Diag(gamma) S + K^T u'
    load_tile(T, kh + m * kC * kDK, kDK);
    __syncthreads();
    float sa[8][4];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const float4 s =
          *reinterpret_cast<const float4*>(S + (d0 + a) * kCols + c0);
      const float y = g[d0 + a];
      sa[a][0] = y * s.x, sa[a][1] = y * s.y;
      sa[a][2] = y * s.z, sa[a][3] = y * s.w;
    }
#pragma unroll 2
    for (int r = 0; r < kC; ++r) {
      const float4 u = *reinterpret_cast<const float4*>(Uc + r * kCols + c0);
      const float4 k0 = *reinterpret_cast<const float4*>(T + r * kLdT + d0);
      const float4 k1 =
          *reinterpret_cast<const float4*>(T + r * kLdT + d0 + 4);
      const float k[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        sa[a][0] += k[a] * u.x, sa[a][1] += k[a] * u.y;
        sa[a][2] += k[a] * u.z, sa[a][3] += k[a] * u.w;
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
      *reinterpret_cast<float4*>(S + (d0 + a) * kCols + c0) =
          make_float4(sa[a][0], sa[a][1], sa[a][2], sa[a][3]);
  }
  __syncthreads();
  for (int i = tid; i < kDK * kCols / 4; i += kThreads) {
    const int d = i / (kCols / 4), c = (i % (kCols / 4)) * 4;
    *reinterpret_cast<float4*>(st + d * kDV + c) =
        *reinterpret_cast<const float4*>(S + d * kCols + c);
  }
}

}  // namespace kda

// The walk. wu: [N, H, C, 256] float32, each chunk's W (columns 0-127)
// beside its U (128-255); qt, kh: [N, H, C, 128]; aqk: [N, H, C, C]; gam:
// [N, H, 128]; offsets: [segments + 1] int32, the chunks of segment i are
// offsets[i] to offsets[i + 1] - 1; rows: [segments] int32, distinct, the
// row of `state` [B, H, 128, 128] (float32, read and written in place)
// that each segment carries; out: [N, H, C, 128] float32.
extern "C" int kda_chunk_state(const float* wu, const float* qt,
                               const float* aqk, const float* kh,
                               const float* gam, const int* offsets,
                               const int* rows, float* state, float* out,
                               int segments, int H, void* stream) {
  const size_t smem = (size_t)kda::kSmemFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kda::chunk_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(kda::kDV / kda::kCols, H, segments);
  kda::chunk_state_kernel<<<grid, kda::kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      wu, qt, aqk, kh, gam, offsets, rows, state, out, H);
  return (int)cudaGetLastError();
}
