// Shared device code of the top-k kernels (packed_extract.cu, extract.cu,
// tile_topk.cu, floor.cu): the score block, its three operand policies, the
// exact per-tile extraction rounds and the choice of queries per block.
//
// Scoring functions, each identical in its kernels and in the PyTorch code
// that rescores their candidates:
//
// * DenseOps (K1, K4, K6, F; f32, bf16 or f16 rows): queries arrive as f32
//   values already rounded to the corpus dtype; bf16 and f16 corpus values
//   are widened to f32 (a bf16 x bf16 or f16 x f16 product is exact in
//   f32); every dot product accumulates in f32 FMA over the feature axis in
//   ascending order. No TF32 anywhere: the packed certificate's cushion is
//   two quantisation steps (~2.4e-4 at tile=1024), and TF32 rounding (~1e-3)
//   would exceed it.
// * Int8Ops (K3, K5b; int8-native): int8 query codes against int8 row codes,
//   an exact int32 dot by __dp4a (4 codes a word; a last partial word is
//   padded with zero codes), then (float(i32) * row_scale) * query_scale,
//   rounded in that order. The dot is exact, so the score is one function
//   whatever the summation order, at any width.
// * ScaledOps (K2, K5a, K7): f32 queries already rounded to bf16 against
//   the rows rounded to bf16 (int8 codes and bf16 values are exact; f32 and
//   f16 rows round to nearest even), so every product is exact in f32; f32
//   FMA in ascending order, then x row_scale.
//
// K1, K2 and K3 also raise a flag when a live row scores outside (-2, 2),
// the certified path's precondition; the host turns it into the twins'
// ValueError where the certificate is read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace orag {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference
constexpr int kThreads = 256;      // threads of every block
constexpr int kDepth = 32;         // words (values, or 4-code groups) a stage
constexpr int kRows = 128;         // corpus rows scored per chunk
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may use
constexpr int kSmemPerSM = 233472;  // shared memory of one SM
constexpr int kSmemReserved = 1024; // what the runtime keeps of it a block

// Corpus dtype codes of the entry points (ops/topk_kernels.py _DTYPE_CODE).
enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// A corpus value as the scaled kernels score it: rounded to bf16.
__device__ __forceinline__ float bf16_value(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float bf16_value(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float bf16_value(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float bf16_value(__half v) {
  return bf16_value(__half2float(v));
}

// An operand policy says what one 4-byte shared-memory word holds, how a
// query word and a corpus word are read from device memory (k counts
// words), how two words multiply into the accumulator, and how the
// accumulator becomes the score.
template <typename T>
struct DenseOps {
  using Word = float;
  using Acc = float;
  const float* qT;  // [D, B] queries, transposed
  const T* c;       // [N, D] rows
  int D;
  __device__ Word q_word(int k, int b, int B) const {
    return qT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k) const {
    return to_float(c[row * D + k]);
  }
  __device__ static Acc mac(Word a, Word v, Acc acc) {
    return fmaf(a, v, acc);
  }
  __device__ float finish(Acc acc, int, long long) const { return acc; }
};

template <typename T>
struct ScaledOps {
  using Word = float;
  using Acc = float;
  const float* qT;    // [D, B] queries rounded to bf16, transposed
  const T* c;         // [N, D] rows (int8 codes, or float rows)
  const float* cs;    // [N] row scales
  int D;
  __device__ Word q_word(int k, int b, int B) const {
    return qT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k) const {
    return bf16_value(c[row * D + k]);
  }
  __device__ static Acc mac(Word a, Word v, Acc acc) {
    return fmaf(a, v, acc);
  }
  __device__ float finish(Acc acc, int, long long row) const {
    return __fmul_rn(acc, cs[row]);
  }
};

struct Int8Ops {
  using Word = int;
  using Acc = int;
  const int* qwT;    // [ceil(D/4), B] query code words, transposed
  const float* qs;   // [B] query scales
  const int8_t* c;   // [N, D] row codes
  const float* cs;   // [N] row scales
  int D;
  bool aligned;      // D % 4 == 0 and c 4-byte aligned: whole-word loads
  __device__ Word q_word(int k, int b, int B) const {
    return qwT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k) const {
    const int8_t* p = c + row * D + 4 * k;
    if (aligned) return *reinterpret_cast<const int*>(p);
    int w = 0;  // byte loads; codes past D stay 0
    for (int j = 0; j < 4 && 4 * k + j < D; ++j)
      w |= static_cast<int>(static_cast<uint8_t>(p[j])) << (8 * j);
    return w;
  }
  __device__ static Acc mac(Word a, Word v, Acc acc) {
    return __dp4a(a, v, acc);
  }
  __device__ float finish(Acc acc, int b, long long row) const {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), cs[row]), qs[b]);
  }
};

// Words a row of D features takes under a policy.
template <typename Ops>
inline int row_words(int D) {
  return std::is_same<Ops, Int8Ops>::value ? (D + 3) / 4 : D;
}

// Scores QB queries against kRows consecutive corpus rows.
//
// Queries are staged transposed ([Dw, B] words) so that staging reads are
// coalesced along the batch. Thread (tq, tr) owns queries tq*TQ + i and rows
// tr + j*NR of the chunk: a warp's row reads from shared memory hit
// consecutive banks, and its query reads are broadcasts. Scores of queries
// at or after B come out 0. Each score is the same sum whatever QB, TQ and
// TR are: one FMA chain over the words in ascending order.
template <typename Ops, int QB, int TQ, int TR>
struct ScoreBlock {
  using Word = typename Ops::Word;
  using Acc = typename Ops::Acc;
  static_assert(sizeof(Word) == sizeof(float), "one word a 4-byte slot");
  static constexpr int NR = kRows / TR;
  static constexpr int NQ = QB / TQ;
  static_assert(NQ * NR == kThreads, "thread layout must cover the block");
  static constexpr int kQStage = kDepth * QB;
  static constexpr int kCStride = kRows + 1;  // +1: conflict-free stores
  static constexpr int kStageFloats = kQStage + kDepth * kCStride;

  __device__ static void run(const Ops& ops, int B, int Dw, int qbase,
                             long long row0, float* stage,
                             float (&out)[TQ][TR]) {
    Word* q_s = reinterpret_cast<Word*>(stage);            // [kDepth][QB]
    Word* c_s = reinterpret_cast<Word*>(stage + kQStage);  // [kDepth][kCStride]
    const int tid = threadIdx.x;
    const int tq = tid / NR, tr = tid % NR;
    Acc acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i)
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = Acc(0);
    for (int k0 = 0; k0 < Dw; k0 += kDepth) {
      __syncthreads();  // every reader of the previous stage is done
      for (int idx = tid; idx < kDepth * QB; idx += kThreads) {
        const int kk = idx / QB, qi = idx % QB;
        const int k = k0 + kk, b = qbase + qi;
        q_s[idx] = (k < Dw && b < B) ? ops.q_word(k, b, B) : Word(0);
      }
      for (int idx = tid; idx < kRows * kDepth; idx += kThreads) {
        const int r = idx / kDepth, kk = idx % kDepth;
        const int k = k0 + kk;
        c_s[kk * kCStride + r] = k < Dw ? ops.c_word(row0 + r, k) : Word(0);
      }
      __syncthreads();
      const int kmax = min(kDepth, Dw - k0);
#pragma unroll 8
      for (int kk = 0; kk < kmax; ++kk) {
        Word a[TQ], v[TR];
#pragma unroll
        for (int i = 0; i < TQ; ++i) a[i] = q_s[kk * QB + tq * TQ + i];
#pragma unroll
        for (int j = 0; j < TR; ++j) v[j] = c_s[kk * kCStride + tr + j * NR];
#pragma unroll
        for (int i = 0; i < TQ; ++i)
#pragma unroll
          for (int j = 0; j < TR; ++j) acc[i][j] = Ops::mac(a[i], v[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int b = qbase + tq * TQ + i;
#pragma unroll
      for (int j = 0; j < TR; ++j)
        out[i][j] = b < B ? ops.finish(acc[i][j], b, row0 + tr + j * NR)
                          : 0.f;
    }
  }
};

// The thread layout of a block of QB queries (QB a power of two, 2..32):
// up to 8 query groups, the rest of the 256 threads along the chunk's rows.
template <int QB>
struct ExtractLayout {
  static constexpr int NQ = QB < 8 ? QB : 8;
  static constexpr int TQ = QB / NQ;
  static constexpr int NR = kThreads / NQ;
  static constexpr int TR = kRows / NR;
};

template <typename Ops, int QB>
using ExtractBlock = ScoreBlock<Ops, QB, ExtractLayout<QB>::TQ,
                                ExtractLayout<QB>::TR>;

// Exact top-`rounds` rows of one corpus tile for a block of QB queries:
// the tile's [QB, tile] scores live in shared memory, then each warp runs
// `rounds` max / lowest-column argmax / mask passes for its queries, as
// jnp.max / jnp.argmax / jnp.where do in the reference. Rows at or after
// `size` score kNegInf. Writes val[(slot*rounds + r)*B + b] and
// col[...] = column + col_base. Any rounds in [1, tile] work: the rounds
// loop keeps no per-round state outside shared memory.
template <typename Ops, int QB>
__device__ void extract_tile(const Ops& ops, int size, int B, int Dw,
                             int tile, int t, int slot, int rounds,
                             int col_base, float* __restrict__ val,
                             int* __restrict__ col) {
  using L = ExtractLayout<QB>;
  using Block = ExtractBlock<Ops, QB>;
  extern __shared__ float smem[];
  float* stage = smem;
  float* S = smem + Block::kStageFloats;  // [QB][tile]
  const int qbase = blockIdx.y * QB;
  const long long base = (long long)t * tile;
  const int tq = threadIdx.x / L::NR, tr = threadIdx.x % L::NR;
  for (int r0 = 0; r0 < tile; r0 += kRows) {
    float acc[L::TQ][L::TR];
    Block::run(ops, B, Dw, qbase, base + r0, stage, acc);
#pragma unroll
    for (int i = 0; i < L::TQ; ++i)
#pragma unroll
      for (int j = 0; j < L::TR; ++j) {
        const int cc = r0 + tr + j * L::NR;
        S[(tq * L::TQ + i) * tile + cc] =
            base + cc < size ? acc[i][j] : kNegInf;
      }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = warp; qi < QB; qi += kThreads / 32) {
    const int b = qbase + qi;
    if (b >= B) break;
    float* row = S + qi * tile;
    for (int r = 0; r < rounds; ++r) {
      float best = -3.0e38f;  // below every score and kNegInf
      int bcol = 0x7fffffff;
      for (int cc = lane; cc < tile; cc += 32) {
        const float v = row[cc];
        if (v > best) { best = v; bcol = cc; }  // strict: lowest column
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bcol, off);
        if (ob > best || (ob == best && oc < bcol)) { best = ob; bcol = oc; }
      }
      if (lane == 0) {
        const long long o = ((long long)slot * rounds + r) * B + b;
        val[o] = best;
        col[o] = bcol + col_base;
        row[bcol] = kNegInf;
      }
      __syncwarp();
    }
  }
}

template <int QB>
inline size_t extract_smem_bytes(int tile) {
  return (kDepth * QB + kDepth * (kRows + 1) + (size_t)QB * tile) *
         sizeof(float);
}

// Calls f(std::integral_constant<int, QB>{}) with the most queries a block
// can take while its [QB, tile] scores fit in shared memory: 32 up to tile
// 1024, 8 up to 4096, 2 up to 16384 (MAX_EXTRACT_TILE in
// ops/topk_kernels.py). Larger tiles return cudaErrorInvalidValue.
template <typename F>
int with_extract_qb(int tile, F&& f) {
  if (extract_smem_bytes<32>(tile) <= (size_t)kMaxSmem)
    return f(std::integral_constant<int, 32>{});
  if (extract_smem_bytes<8>(tile) <= (size_t)kMaxSmem)
    return f(std::integral_constant<int, 8>{});
  if (extract_smem_bytes<2>(tile) <= (size_t)kMaxSmem)
    return f(std::integral_constant<int, 2>{});
  return (int)cudaErrorInvalidValue;
}

// Calls f(ops) with the DenseOps of the corpus dtype code (f32, bf16, f16).
template <typename F>
int with_dense_ops(const float* qT, const void* corpus, int dtype, int D,
                   F&& f) {
  switch (dtype) {
    case kF32:
      return f(DenseOps<float>{qT, static_cast<const float*>(corpus), D});
    case kBF16:
      return f(DenseOps<__nv_bfloat16>{
          qT, static_cast<const __nv_bfloat16*>(corpus), D});
    case kF16:
      return f(DenseOps<__half>{qT, static_cast<const __half*>(corpus), D});
  }
  return (int)cudaErrorInvalidValue;
}

// Calls f(ops) with the ScaledOps of the corpus dtype code (any of four).
template <typename F>
int with_scaled_ops(const float* qT, const void* corpus, int dtype,
                    const float* cs, int D, F&& f) {
  switch (dtype) {
    case kF32:
      return f(ScaledOps<float>{qT, static_cast<const float*>(corpus), cs, D});
    case kBF16:
      return f(ScaledOps<__nv_bfloat16>{
          qT, static_cast<const __nv_bfloat16*>(corpus), cs, D});
    case kF16:
      return f(ScaledOps<__half>{qT, static_cast<const __half*>(corpus), cs,
                                 D});
    case kI8:
      return f(ScaledOps<int8_t>{qT, static_cast<const int8_t*>(corpus), cs,
                                 D});
  }
  return (int)cudaErrorInvalidValue;
}

inline Int8Ops int8_ops(const int* qwT, const float* qs, const void* corpus,
                        const float* cs, int D) {
  const bool aligned =
      D % 4 == 0 && reinterpret_cast<uintptr_t>(corpus) % 4 == 0;
  return Int8Ops{qwT, qs, static_cast<const int8_t*>(corpus), cs, D,
                 aligned};
}

}  // namespace orag
