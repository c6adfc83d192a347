// Shared device code of the top-k kernels (packed_extract.cu, extract.cu,
// tile_topk.cu): the score block, its three operand policies, and the exact
// per-tile extraction rounds.
//
// Scoring functions, each identical in its kernels and in the PyTorch code
// that rescores their candidates:
//
// * DenseOps (K1, K4, K6; f32 or bf16 rows): queries arrive as f32 values
//   already rounded to the corpus dtype; bf16 corpus values are widened to
//   f32 (a bf16 x bf16 product is exact in f32); every dot product
//   accumulates in f32 FMA over the feature axis in ascending order. No
//   TF32 anywhere: the packed certificate's cushion is two quantisation
//   steps (~2.4e-4 at tile=1024), and TF32 rounding (~1e-3) would exceed it.
// * Int8Ops (K3, K5b; int8-native): int8 query codes against int8 row codes,
//   an exact int32 dot by __dp4a (4 codes a word), then
//   (float(i32) * row_scale) * query_scale, rounded in that order. The dot
//   is exact, so the score is one function whatever the summation order.
// * ScaledOps (K7): f32 queries already rounded to bf16 against int8 codes
//   widened to f32 (a bf16 x int8 product is exact in f32), f32 FMA in
//   ascending order, then x row_scale.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace orag {

constexpr float kNegInf = -1e30f;  // NEG_INF of the reference
constexpr int kThreads = 256;      // threads of every block
constexpr int kDepth = 32;         // words (values, or 4-code groups) a stage
constexpr int kRows = 128;         // corpus rows scored per chunk

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// An operand policy says what one 4-byte shared-memory word holds, how a
// query word and a corpus word are read from device memory (k counts
// words; a row has `Dw` of them), how two words multiply into the
// accumulator, and how the accumulator becomes the score.
template <typename T>
struct DenseOps {
  using Word = float;
  using Acc = float;
  const float* qT;  // [D, B] queries, transposed
  const T* c;       // [N, D] rows
  __device__ Word q_word(int k, int b, int B) const {
    return qT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k, int Dw) const {
    return to_float(c[row * Dw + k]);
  }
  __device__ static Acc mac(Word a, Word v, Acc acc) {
    return fmaf(a, v, acc);
  }
  __device__ float finish(Acc acc, int, long long) const { return acc; }
};

struct ScaledOps {
  using Word = float;
  using Acc = float;
  const float* qT;    // [D, B] queries rounded to bf16, transposed
  const int8_t* c;    // [N, D] row codes
  const float* cs;    // [N] row scales
  __device__ Word q_word(int k, int b, int B) const {
    return qT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k, int Dw) const {
    return static_cast<float>(c[row * Dw + k]);
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
  const int* qwT;   // [D/4, B] query code words, transposed
  const float* qs;  // [B] query scales
  const int* cw;    // [N, D/4] row code words
  const float* cs;  // [N] row scales
  __device__ Word q_word(int k, int b, int B) const {
    return qwT[(long long)k * B + b];
  }
  __device__ Word c_word(long long row, int k, int Dw) const {
    return cw[row * Dw + k];
  }
  __device__ static Acc mac(Word a, Word v, Acc acc) {
    return __dp4a(a, v, acc);
  }
  __device__ float finish(Acc acc, int b, long long row) const {
    return __fmul_rn(__fmul_rn(__int2float_rn(acc), cs[row]), qs[b]);
  }
};

// Scores QB queries against kRows consecutive corpus rows.
//
// Queries are staged transposed ([Dw, B] words) so that staging reads are
// coalesced along the batch. Thread (tq, tr) owns queries tq*TQ + i and rows
// tr + j*NR of the chunk: a warp's row reads from shared memory hit
// consecutive banks, and its query reads are broadcasts. Scores of queries
// at or after B come out 0.
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
        c_s[kk * kCStride + r] =
            k < Dw ? ops.c_word(row0 + r, k, Dw) : Word(0);
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

// Exact top-`rounds` rows of one corpus tile for a block of 32 queries:
// the tile's [32, tile] scores live in shared memory, then each warp runs
// `rounds` max / lowest-column argmax / mask passes for its queries, as
// jnp.max / jnp.argmax / jnp.where do in the reference. Rows at or after
// `size` score kNegInf. Writes val[(slot*rounds + r)*B + b] and
// col[...] = column + col_base. Any rounds in [1, tile] work: the rounds
// loop keeps no per-round state outside shared memory.
constexpr int kExtractQB = 32;

template <typename Ops>
__device__ void extract_tile(const Ops& ops, int size, int B, int Dw,
                             int tile, int t, int slot, int rounds,
                             int col_base, float* __restrict__ val,
                             int* __restrict__ col) {
  using Block = ScoreBlock<Ops, kExtractQB, 4, 4>;
  extern __shared__ float smem[];
  float* stage = smem;
  float* S = smem + Block::kStageFloats;  // [kExtractQB][tile]
  const int qbase = blockIdx.y * kExtractQB;
  const long long base = (long long)t * tile;
  const int tq = threadIdx.x / Block::NR, tr = threadIdx.x % Block::NR;
  for (int r0 = 0; r0 < tile; r0 += kRows) {
    float acc[4][4];
    Block::run(ops, B, Dw, qbase, base + r0, stage, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cc = r0 + tr + j * Block::NR;
        S[(tq * 4 + i) * tile + cc] = base + cc < size ? acc[i][j] : kNegInf;
      }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int qi = warp; qi < kExtractQB; qi += kThreads / 32) {
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

template <typename Ops>
inline size_t extract_smem_bytes(int tile) {
  return (ScoreBlock<Ops, kExtractQB, 4, 4>::kStageFloats +
          (size_t)kExtractQB * tile) * sizeof(float);
}

// The int8 entry points take D in codes; the kernels count 4-code words.
inline bool int8_width_ok(int D) { return D > 0 && D % 4 == 0; }

}  // namespace orag
