// Shared device code of the top-k kernels (packed_extract.cu, extract.cu,
// tile_topk.cu, floor.cu): the score block, its three operand policies and
// the streaming per-tile selection of K4, K5a, K5b, K6 and K7. The
// tensor-core scan of K1 and F over 16-bit rows, K2 over int8 codes and
// bf16 rows, and K3 is in scan_mma.cuh.
//
// Scoring functions, each identical in its kernels and in the PyTorch code
// that rescores their candidates:
//
// * DenseOps (K1, K4, K6, F; f32, bf16 or f16 rows): queries arrive as f32
//   values already rounded to the corpus dtype; bf16 and f16 corpus values
//   are widened to f32 (a bf16 x bf16 or f16 x f16 product is exact in
//   f32); over f32 rows every dot product accumulates in f32 FMA over the
//   feature axis in ascending order. Over bf16 and f16 rows the products
//   run on the tensor cores (exact products, f32 accumulation in the tensor
//   cores' order): the selections K4 and K6 use them as a filter and
//   rescore every possible entrant by the ascending FMA chain (MmaStage
//   below); the packed scan K1 and the floor F keep the tensor cores' sums
//   (scan_mma.cuh, whose header bounds their rounding within one
//   quantisation step of the certificate, and refuses the (tile, D) pairs
//   where it is not). No TF32 anywhere: the packed certificate's cushion is
//   two quantisation steps (~2.4e-4 at tile=1024), and TF32 rounding
//   (~1e-3) would exceed it.
// * Int8Ops (K5b; int8-native): int8 query codes against int8 row codes,
//   an exact int32 dot by __dp4a (4 codes a word; a last partial word is
//   padded with zero codes), then (float(i32) * row_scale) * query_scale,
//   rounded in that order. The dot is exact, so the score is one function
//   whatever the summation order, at any width: K3 computes it on the
//   tensor cores (scan_mma.cuh), bit for bit the same.
// * ScaledOps (K5a, K7, and K2 over f16 and f32 rows): f32 queries already
//   rounded to bf16 against the rows rounded to bf16 (int8 codes and bf16
//   values are exact; f32 and f16 rows round to nearest even), so every
//   product is exact in f32; f32 FMA in ascending order, then x row_scale.
//   K2 over int8 codes and bf16 rows keeps the tensor cores' sums
//   (scan_mma.cuh, whose header bounds their rounding for the scaled
//   score).
//
// K1, K2 and K3 also raise a flag when a live row scores outside (-2, 2),
// the certified path's precondition; the host turns it into the twins'
// ValueError where the certificate is read.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
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
// TR are: one FMA chain over the words in ascending order. With SkipDead,
// a thread whose queries all lie at or after B skips the chain (its scores
// are then 0 without the work: a batch of 8 keeps one warp of eight busy).
template <typename Ops, int QB, int TQ, int TR, bool SkipDead = false>
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
      if (SkipDead && qbase + tq * TQ >= B) continue;
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

// ---------------------------------------------------------------------------
// Streaming per-tile selection (K4, K5a, K5b, K6, K7).
//
// For one corpus tile (or the part of it a block of a cluster owns) and a
// block of kQB = 64 queries, the block scores the tile kChunk = 128 rows at
// a time, writes the chunk's [64 x 128] f32 scores to shared memory and
// folds them into a running list per query: the best W (value, column)
// pairs so far, best first, W = min(rounds, kListCap). The order is value
// descending, then column ascending (`better`), which is the order of the
// reference's repeated max / lowest-column argmax / mask: every key is
// distinct (columns are), so the top-W by that order is one set in one
// order whatever order the candidates are offered in. A score reaches the
// list only if it beats the list's last entry (its threshold): after the
// first chunks almost every score fails that one compare. A warp folds its
// queries' lists (query w, w + 8, ...); up to three candidates of a batch go
// in one at a time, more by a bitonic sort and a merge (merge_batch).
//
// Lists start filled with the sentinel (kNegInf, column 0). Rows at or
// after `size` score kNegInf and never beat it, so a tile with fewer live
// rows than W ends in sentinels: (-1e30, column 0 of the tile) repeated,
// what the reference's argmax over an all -1e30 row gives. (Live scores are
// taken to lie above -1e30, as every score of normalised rows does.)
//
// rounds > kListCap run in passes of kListCap: pass p takes the best W keys
// strictly worse than pass p-1's last entry (the floor) and rescores the
// tile. A pass whose floors are all the sentinel writes sentinels at once.
//
// Scoring: bf16 and f16 rows (DenseOps, up to kMmaMaxD features) on the
// tensor cores, mma.sync m16n8k16 with f32 accumulation, as a filter: every
// row that could enter a list is rescored by DenseOps' own FMA chain, so
// the lists hold the FMA kernels' values bit for bit and the tensor cores'
// rounding decides no place (MmaStage). Every other policy (f32 rows,
// ScaledOps, Int8Ops) scores through ScoreBlock, the same FMA / dp4a chain
// as before, 4 queries x 8 rows a thread (FmaStage).
//
// Grid: one block per (slot, query block, part), the query blocks of one
// tile adjacent, so that a tile comes from device memory once and from L2
// for its other query blocks. Where slots x query blocks would leave SMs
// idle (fewer than kFillBlocks), a single-pass selection splits each tile's
// rows over a thread-block cluster of kMaxSplit = 2 blocks; rank 0 folds
// the other block's lists into its own through distributed shared memory
// and writes. Wider clusters were slower at the served shape (B=64, U=32,
// tile 1024): merging 4 or 8 lists of up to 64 entries costs more than the
// extra blocks gain (benchmarks_torch/selection_split.py times the caps).
// ---------------------------------------------------------------------------

constexpr int kQB = 64;           // queries a block
constexpr int kChunk = kRows;     // rows scored per chunk
constexpr int kListCap = 64;      // entries a running list holds
constexpr int kLdS = kChunk + 4;  // row stride of the score chunk, floats
constexpr int kFillBlocks = 264;  // two blocks an SM on 132 SMs
// Building with -DORAG_MAX_SPLIT=n caps the cluster at n blocks instead,
// so that caps can be timed against each other.
#ifndef ORAG_MAX_SPLIT
#define ORAG_MAX_SPLIT 2
#endif
constexpr int kMaxSplit = ORAG_MAX_SPLIT;  // blocks of a cluster (above)

// (v, c) before (v2, c2): a higher value, or an equal one at a lower column.
__device__ __forceinline__ bool better(float v, int c, float v2, int c2) {
  return v > v2 || (v == v2 && c < c2);
}

// Insert (v, c), which beats the last entry, into a warp's sorted list
// Lv/Lc of W <= 64 entries; each lane moves entries lane and lane + 32.
__device__ __forceinline__ void list_insert(float* Lv, int* Lc, int W,
                                            float v, int c, int lane) {
  const int i0 = lane, i1 = lane + 32;
  const bool h0 = i0 < W, h1 = i1 < W;
  const float v0 = h0 ? Lv[i0] : 0.f, v1 = h1 ? Lv[i1] : 0.f;
  const int c0 = h0 ? Lc[i0] : 0, c1 = h1 ? Lc[i1] : 0;
  const int pos =
      __popc(__ballot_sync(0xffffffffu, h0 && better(v0, c0, v, c))) +
      __popc(__ballot_sync(0xffffffffu, h1 && better(v1, c1, v, c)));
  const float p0v = (h0 && i0 > 0) ? Lv[i0 - 1] : 0.f;
  const int p0c = (h0 && i0 > 0) ? Lc[i0 - 1] : 0;
  const float p1v = h1 ? Lv[i1 - 1] : 0.f;
  const int p1c = h1 ? Lc[i1 - 1] : 0;
  __syncwarp();
  if (h0 && i0 >= pos) {
    Lv[i0] = i0 == pos ? v : p0v;
    Lc[i0] = i0 == pos ? c : p0c;
  }
  if (h1 && i1 >= pos) {
    Lv[i1] = i1 == pos ? v : p1v;
    Lc[i1] = i1 == pos ? c : p1c;
  }
  __syncwarp();
}

// Merge the lanes' candidates (v, c) where `ok` (each beating the last
// entry; keys distinct) into the warp's sorted list Lv/Lc of W <= 64
// entries: a bitonic sort of the 32 keys across the lanes (the others as
// (-inf, INT_MAX), below every entry), then every key's place in the union
// by a binary search of the other sorted sequence; the first W places are
// written back.
static __device__ __noinline__ void merge_batch(float* Lv, int* Lc, int W,
                                            float v, int c, bool ok,
                                            int lane) {
  const int n = __popc(__ballot_sync(0xffffffffu, ok));  // sorted to lanes < n
  if (!ok) {
    v = -INFINITY;
    c = 0x7fffffff;
  }
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, j);
      const int oc = __shfl_xor_sync(0xffffffffu, c, j);
      const bool keep_better = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_better ? better(ov, oc, v, c) : better(v, c, ov, oc)) {
        v = ov;
        c = oc;
      }
    }
  // This candidate's place: its rank plus the list entries before it.
  int lo = 0, hi = W;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(Lv[mid], Lc[mid], v, c)) lo = mid + 1; else hi = mid;
  }
  const int pos_c = lane + lo;
  // Each list entry's place: its index plus the candidates before it.
  float ev[2];
  int ec[2], pos_e[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int e = lane + 32 * h;
    ev[h] = e < W ? Lv[e] : 0.f;
    ec[h] = e < W ? Lc[e] : 0;
    int a = 0, b = 32;
#pragma unroll
    for (int step = 0; step < 6; ++step) {
      const int mid = min((a + b) >> 1, 31);
      const float mv = __shfl_sync(0xffffffffu, v, mid);
      const int mc = __shfl_sync(0xffffffffu, c, mid);
      if (a < b) {
        if (better(mv, mc, ev[h], ec[h])) a = mid + 1; else b = mid;
      }
    }
    pos_e[h] = e + a;
  }
  __syncwarp();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (lane + 32 * h < W && pos_e[h] < W) {
      Lv[pos_e[h]] = ev[h];
      Lc[pos_e[h]] = ec[h];
    }
  if (lane < n && pos_c < W) {
    Lv[pos_c] = v;
    Lc[pos_c] = c;
  }
  __syncwarp();
}

// Offer each lane's candidate (v, c) where `ok` to the warp's list; (tv,
// tc) is the list's last entry, kept current. A few go in one at a time,
// lowest lane first; more are merged in one step.
__device__ __forceinline__ void offer(float* Lv, int* Lc, int W, float& tv,
                                      int& tc, float v, int c, bool ok,
                                      int lane) {
  ok = ok && better(v, c, tv, tc);
  unsigned m = __ballot_sync(0xffffffffu, ok);
  if (__popc(m) > 3) {
    merge_batch(Lv, Lc, W, v, c, ok, lane);
    tv = Lv[W - 1];
    tc = Lc[W - 1];
    return;
  }
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(0xffffffffu, v, src);
    const int cc = __shfl_sync(0xffffffffu, c, src);
    if (better(cv, cc, tv, tc)) {  // warp-uniform: the threshold may rise
      list_insert(Lv, Lc, W, cv, cc, lane);
      tv = Lv[W - 1];
      tc = Lc[W - 1];
    }
  }
}

template <typename T>
__device__ __forceinline__ uint16_t half_bits(float v);
template <>
__device__ __forceinline__ uint16_t half_bits<__nv_bfloat16>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ uint16_t half_bits<__half>(float v) {
  return __half_as_ushort(__float2half_rn(v));
}

template <typename T>
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma_16816<__half>(float (&d)[4],
                                                  const uint32_t (&a)[4],
                                                  uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const uint16_t* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// bf16 / f16 bits to f32 (exact).
template <typename T>
__device__ __forceinline__ float bits_float(uint16_t h);
template <>
__device__ __forceinline__ float bits_float<__nv_bfloat16>(uint16_t h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}
template <>
__device__ __forceinline__ float bits_float<__half>(uint16_t h) {
  return __half2float(__ushort_as_half(h));
}

// The dot of two staged 16-bit vectors in f32 across the warp (the norms of
// the filter's margin): lane l sums
// features l, l+32, ... by FMA, then a butterfly adds the 32 partial sums.
// Every lane returns the same value, and identical rows give identical
// values wherever they lie.
template <typename T>
__device__ __forceinline__ float warp_dot(const uint16_t* a,
                                          const uint16_t* b, int D,
                                          int lane) {
  float acc = 0.f;
  for (int k = lane; k < D; k += 32)
    acc = fmaf(bits_float<T>(a[k]), bits_float<T>(b[k]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// The W-th largest (W <= 4 * 32) of the warp's values v[0..3] (4 a lane),
// by a radix select on their order-preserving bit patterns.
__device__ __forceinline__ float kth_largest(const float (&v)[4], int W) {
  uint32_t key[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t u = __float_as_uint(v[j]);
    key[j] = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  uint32_t t = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = t | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      cnt += __popc(__ballot_sync(0xffffffffu, key[j] >= cand));
    if (cnt >= W) t = cand;
  }
  return __uint_as_float((t & 0x80000000u) ? (t & 0x7fffffffu) : ~t);
}

// The dot of two staged 16-bit vectors as DenseOps scores it: one FMA chain
// over the features in ascending order, from 0 (bit for bit the FMA score
// block's value, and the order cuBLAS's f32 GEMM sums in).
template <typename T>
__device__ __forceinline__ float chain_dot(const uint16_t* a,
                                           const uint16_t* b, int D) {
  const uint32_t* a2 = reinterpret_cast<const uint32_t*>(a);
  const uint32_t* b2 = reinterpret_cast<const uint32_t*>(b);
  float acc = 0.f;
  for (int k = 0; 2 * k + 1 < D; ++k) {
    const uint32_t x = a2[k], y = b2[k];
    acc = fmaf(bits_float<T>(x & 0xffffu), bits_float<T>(y & 0xffffu), acc);
    acc = fmaf(bits_float<T>(x >> 16), bits_float<T>(y >> 16), acc);
  }
  if (D % 2) acc = fmaf(bits_float<T>(a[D - 1]), bits_float<T>(b[D - 1]), acc);
  return acc;
}

// The largest feature count the tensor-core filter takes (its margin below
// is sound up to here); wider bf16/f16 rows are scored by FMA.
constexpr int kMmaMaxD = 512;
// The filter's margin: |tensor-core sum - exact sum| <= D * 2^-23 *
// sum|q_i c_i| <= 2^-14 * |q| * |c| for D <= 512 (each of at most D
// additions loses under one unit in the last place of a value no larger
// than sum|q_i c_i|); the margin takes twice that.
constexpr float kMmaEps = 1.0f / 8192.0f;

// bf16 and f16 rows on the tensor cores, as a filter. The block stages its
// 64 queries once (as 16-bit values: they arrive as f32 already rounded to
// T, so the conversion is exact) and each chunk's 128 rows whole, rows
// padded to a multiple of 16 values plus 8 (conflict-free ldmatrix), with
// the L2 norm of every query and row. Warp w multiplies rows 32*(w%4).. by
// queries 32*(w/4).. with mma.sync m16n8k16 (2 x 4 products a 16-wide
// step, f32 accumulation); a warp whose queries all lie at or after B
// skips its products. The fold then rescores, from the staged values,
// every row whose tensor-core score lies within kMmaEps * |q| * |c| of the
// list's threshold (and of the floor), by DenseOps' own FMA chain: the
// lists hold exactly the values the FMA kernels gave, and the tensor cores'
// rounding never decides a place.
template <typename T>
struct MmaStage {
  __host__ __device__ static int ld(int D) { return (D + 15) / 16 * 16 + 8; }
  // q_s [kQB][ld] and c_s [kChunk][ld] 16-bit values, qn [kQB], rn [kChunk].
  __host__ __device__ static int floats(int D) {
    return (kQB + kChunk) * ld(D) / 2 + kQB + kChunk;
  }

  __device__ static void queries(const DenseOps<T>& ops, int B, int qbase,
                                 float* stage) {
    const int D = ops.D, L = ld(D), tid = threadIdx.x;
    uint16_t* q_s = reinterpret_cast<uint16_t*>(stage);
    float* qn = stage + floats(D) - kQB - kChunk;
    for (int idx = tid; idx < L * kQB; idx += kThreads) {
      const int k = idx / kQB, qi = idx % kQB, b = qbase + qi;
      q_s[qi * L + k] =
          (k < D && b < B) ? half_bits<T>(ops.qT[(long long)k * B + b]) : 0;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int qi = warp; qi < kQB; qi += kThreads / 32) {
      const uint16_t* v = q_s + qi * L;
      const float n2 = warp_dot<T>(v, v, D, lane);
      if (lane == 0) qn[qi] = sqrtf(n2);
    }
  }

  // Scores S[q * kLdS + row] of one chunk; syncs first (every reader of the
  // previous chunk is done) and after the rows are staged.
  __device__ static void chunk(const DenseOps<T>& ops, int B, int qbase,
                               long long row0, float* stage, float* S) {
    const int D = ops.D, L = ld(D), tid = threadIdx.x;
    const uint16_t* q_s = reinterpret_cast<const uint16_t*>(stage);
    uint16_t* c_s = reinterpret_cast<uint16_t*>(stage) + kQB * L;
    float* rn = stage + floats(D) - kChunk;
    const uint16_t* c = reinterpret_cast<const uint16_t*>(ops.c);
    const bool vec =
        D % 8 == 0 && reinterpret_cast<uintptr_t>(ops.c) % 16 == 0;
    __syncthreads();
    if (vec) {
      for (int idx = tid; idx < kChunk * (L / 8); idx += kThreads) {
        const int r = idx / (L / 8), k = (idx % (L / 8)) * 8;
        uint4 w = make_uint4(0, 0, 0, 0);
        if (k < D) w = *reinterpret_cast<const uint4*>(c + (row0 + r) * D + k);
        *reinterpret_cast<uint4*>(c_s + r * L + k) = w;
      }
    } else {
      for (int idx = tid; idx < kChunk * L; idx += kThreads) {
        const int r = idx / L, k = idx % L;
        c_s[r * L + k] = k < D ? c[(row0 + r) * D + k] : 0;
      }
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp; r < kChunk; r += kThreads / 32) {
      const uint16_t* v = c_s + r * L;
      const float n2 = warp_dot<T>(v, v, D, lane);
      if (lane == 0) rn[r] = sqrtf(n2);
    }
    const int rw = warp % 4, qw = warp / 4;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    if (qbase + qw * 32 < B) {
      for (int kk = 0; kk < D; kk += 16) {
        uint32_t a[2][4], bq[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldmatrix_x4(a[mt], c_s + (rw * 32 + mt * 16 + (lane % 8) +
                                    8 * ((lane / 8) % 2)) * L +
                                 kk + 8 * (lane / 16));
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldmatrix_x4(bq[np], q_s + (qw * 32 + np * 16 + (lane % 8) +
                                     8 * (lane / 16)) * L +
                                  kk + 8 * ((lane / 8) % 2));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_16816<T>(acc[mt][nt], a[mt], bq[nt / 2][2 * (nt % 2)],
                         bq[nt / 2][2 * (nt % 2) + 1]);
      }
    }
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = rw * 32 + mt * 16 + g, q = qw * 32 + nt * 8 + 2 * t;
        S[q * kLdS + r] = acc[mt][nt][0];
        S[(q + 1) * kLdS + r] = acc[mt][nt][1];
        S[q * kLdS + r + 8] = acc[mt][nt][2];
        S[(q + 1) * kLdS + r + 8] = acc[mt][nt][3];
      }
  }

  // Fold one chunk into the lists of warp w's queries w, w + 8, ...: the
  // tensor-core scores filter, the FMA chain decides. A row is a candidate
  // for a query only if its score plus the margin reaches the list's
  // threshold, and while the list is not yet full, the W-th best lower
  // bound (score minus margin) of the chunk's rows that surely lie below
  // the floor (W of them will score at least that). Each query's candidate
  // rows are written over its own spent score row, then the warp rescores
  // the candidates of all its queries 32 at a time (one FMA chain a lane)
  // and offers each to its query's list.
  __device__ static void fold(const DenseOps<T>& ops, const float* stage,
                              float* S, int qbase, int B, int r0, int nlive,
                              float* lv, int* lc, int P, int W,
                              const float* fv, const int* fc, int warp,
                              int lane) {
    constexpr int kQW = kQB / (kThreads / 32);  // queries a warp folds
    const int D = ops.D, L = ld(D);
    const uint16_t* q_s = reinterpret_cast<const uint16_t*>(stage);
    const uint16_t* c_s = q_s + kQB * L;
    const float* qn = stage + floats(D) - kQB - kChunk;
    const float* rn = qn + kQB;
    const unsigned below = (1u << lane) - 1;
    int start[kQW + 1];
    start[0] = 0;
#pragma unroll
    for (int i = 0; i < kQW; ++i) {
      const int q = warp + i * (kThreads / 32);
      int total = 0;
      if (qbase + q < B) {  // warp-uniform
        const float tv = lv[q * P + W - 1], flv = fv[q];
        const float qe = kMmaEps * qn[q];
        float sv[kChunk / 32], e[kChunk / 32];
        bool live[kChunk / 32];
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) {
          const int r = j * 32 + lane;
          sv[j] = S[q * kLdS + r];
          e[j] = qe * rn[r];
          live[j] = r0 + r < nlive;
        }
        float bound = tv;
        if (tv <= kNegInf) {  // the list still holds sentinels
          float lb[kChunk / 32];  // of rows surely below the floor only
#pragma unroll
          for (int j = 0; j < kChunk / 32; ++j)
            lb[j] = live[j] && sv[j] + e[j] < flv ? sv[j] - e[j] : -INFINITY;
          bound = fmaxf(bound, kth_largest(lb, W));
        }
        __syncwarp();  // every lane has read the row it now overwrites
        int* cand = reinterpret_cast<int*>(S + q * kLdS);
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) {
          const bool ok = live[j] && sv[j] + e[j] >= bound &&
                          sv[j] - e[j] <= flv;
          const unsigned m = __ballot_sync(0xffffffffu, ok);
          if (ok) cand[total + __popc(m & below)] = j * 32 + lane;
          total += __popc(m);
        }
      }
      start[i + 1] = start[i] + total;
    }
    __syncwarp();
    for (int b0 = 0; b0 < start[kQW]; b0 += 32) {
      const int idx = b0 + lane;
      int mine = -1, off = 0, r = 0;
#pragma unroll
      for (int i = 0; i < kQW; ++i)
        if (idx >= start[i] && idx < start[i + 1]) {
          mine = i;
          off = idx - start[i];
        }
      float x = 0.f;
      if (mine >= 0) {
        const int q = warp + mine * (kThreads / 32);
        r = reinterpret_cast<const int*>(S + q * kLdS)[off];
        x = chain_dot<T>(q_s + q * L, c_s + r * L, D);
      }
#pragma unroll
      for (int i = 0; i < kQW; ++i) {
        if (start[i + 1] <= b0 || start[i] >= b0 + 32) continue;
        const int q = warp + i * (kThreads / 32);
        float tv = lv[q * P + W - 1];
        int tc = lc[q * P + W - 1];
        offer(lv + q * P, lc + q * P, W, tv, tc, x, r0 + r,
              mine == i && better(fv[q], fc[q], x, r0 + r), lane);
      }
    }
  }
};

// The FMA / dp4a chunk scores (ScoreBlock at 64 queries, 4 x 8 a thread):
// exact for their policy, so the fold compares them directly.
template <typename Ops>
struct FmaStage {
  using Block = ScoreBlock<Ops, kQB, 4, 8, true>;
  static constexpr int kFloats = Block::kStageFloats;

  __device__ static void chunk(const Ops& ops, int B, int Dw, int qbase,
                               long long row0, float* stage, float* S) {
    float acc[4][8];
    Block::run(ops, B, Dw, qbase, row0, stage, acc);
    const int tq = threadIdx.x / Block::NR, tr = threadIdx.x % Block::NR;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        S[(tq * 4 + i) * kLdS + tr + j * Block::NR] = acc[i][j];
  }

  __device__ static void fold(const float* S, int q, int r0, int nlive,
                              float* Lv, int* Lc, int W, float flv, int flc,
                              int lane) {
    float tv = Lv[W - 1];
    int tc = Lc[W - 1];
#pragma unroll
    for (int j = 0; j < kChunk / 32; ++j) {
      const int cc = r0 + j * 32 + lane;
      const float v = cc < nlive ? S[q * kLdS + j * 32 + lane] : kNegInf;
      offer(Lv, Lc, W, tv, tc, v, cc, better(flv, flc, v, cc), lane);
    }
  }
};

// The 16-bit type whose rows a policy may score on the tensor cores.
template <typename Ops>
struct MmaType { using T = void; };
template <>
struct MmaType<DenseOps<__nv_bfloat16>> { using T = __nv_bfloat16; };
template <>
struct MmaType<DenseOps<__half>> { using T = __half; };

template <typename Ops, bool Mma>
__host__ __device__ inline int stage_floats(int D) {
  if constexpr (Mma)
    return MmaStage<typename MmaType<Ops>::T>::floats(D);
  else
    return FmaStage<Ops>::kFloats;
}

// Shared memory of a block: the stage, the score chunk, the lists
// ([kQB][P] values and columns) and each query's floor.
template <typename Ops, bool Mma>
inline size_t stream_smem_bytes(int D, int P) {
  return (stage_floats<Ops, Mma>(D) + (size_t)kQB * kLdS +
          2 * (size_t)kQB * P + 2 * kQB) * sizeof(float);
}

// Block (slot, query block qb, part `rank` of `split`): the top-`rounds` of
// tile t = tiles ? tiles[slot] : slot, written to val/col[(slot * rounds +
// r) * B + b], columns tile-local plus t * tile where `global_ids`. A slot
// with t < 0 or t * tile >= N has no live row: it writes sentinels. D is
// the feature count (the tensor-core stage's width).
template <typename Ops, bool Mma>
__global__ void __launch_bounds__(kThreads, 2)
    stream_topk_kernel(const Ops ops, const int* __restrict__ size_ptr,
                       const int* __restrict__ tiles, float* __restrict__ val,
                       int* __restrict__ col, int B, int N, int D, int Dw,
                       int tile, int rounds, int nqb, int split,
                       int global_ids) {
  namespace cg = cooperative_groups;
  extern __shared__ float smem[];
  float* stage = smem;
  float* S = stage + stage_floats<Ops, Mma>(D);      // [kQB][kLdS]
  const int P = min(rounds, kListCap);
  float* lv = S + kQB * kLdS;                         // [kQB][P]
  int* lc = reinterpret_cast<int*>(lv + kQB * P);     // [kQB][P]
  float* fv = reinterpret_cast<float*>(lc + kQB * P); // [kQB] floors
  int* fc = reinterpret_cast<int*>(fv + kQB);

  const int rank = blockIdx.x % split;
  const int qb = (blockIdx.x / split) % nqb;
  const int slot = blockIdx.x / split / nqb;
  const int qbase = qb * kQB;
  const int t = tiles ? tiles[slot] : slot;
  const bool valid = t >= 0 && (long long)t * tile < N;
  const long long base = valid ? (long long)t * tile : 0;
  const int size = *size_ptr;
  const int nlive =
      valid ? (int)max(0LL, min((long long)tile, (long long)size - base)) : 0;
  const int seg = tile / split;
  const int r_lo = rank * seg, r_hi = min(r_lo + seg, nlive);
  const int col_base = global_ids ? t * tile : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if constexpr (Mma) {
    if (r_lo < r_hi)
      MmaStage<typename MmaType<Ops>::T>::queries(ops, B, qbase, stage);
  }
  if (tid < kQB) {
    fv[tid] = INFINITY;  // pass 0: every key lies below the floor
    fc[tid] = -1;
  }
  for (int p0 = 0; p0 < rounds; p0 += P) {
    const int W = min(P, rounds - p0);
    for (int i = tid; i < kQB * P; i += kThreads) {
      lv[i] = kNegInf;
      lc[i] = 0;
    }
    const bool open = __syncthreads_or(tid < kQB && qbase + tid < B &&
                                       fv[tid] > kNegInf);
    if (open) {
      for (int r0 = r_lo; r0 < r_hi; r0 += kChunk) {
        if constexpr (Mma)
          MmaStage<typename MmaType<Ops>::T>::chunk(ops, B, qbase, base + r0,
                                                    stage, S);
        else
          FmaStage<Ops>::chunk(ops, B, Dw, qbase, base + r0, stage, S);
        __syncthreads();
        if constexpr (Mma) {
          MmaStage<typename MmaType<Ops>::T>::fold(ops, stage, S, qbase, B,
                                                   r0, nlive, lv, lc, P, W,
                                                   fv, fc, warp, lane);
        } else {
          for (int q = warp; q < kQB; q += kThreads / 32) {
            if (qbase + q >= B) break;
            FmaStage<Ops>::fold(S, q, r0, nlive, lv + q * P, lc + q * P, W,
                                fv[q], fc[q], lane);
          }
        }
        // The next chunk's scoring syncs before it writes the stage or S.
      }
    }
    __syncthreads();
    if (split > 1) {  // single pass only: every block of the cluster is here
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (rank == 0) {
        for (int q = warp; q < kQB; q += kThreads / 32) {
          if (qbase + q >= B) break;
          float* Lv = lv + q * P;
          int* Lc = lc + q * P;
          float tv = Lv[W - 1];
          int tc = Lc[W - 1];
          for (int r = 1; r < split; ++r) {
            const float* Rv = cluster.map_shared_rank(Lv, r);
            const int* Rc = cluster.map_shared_rank(Lc, r);
            for (int e0 = 0; e0 < W; e0 += 32) {
              const int e = e0 + lane;
              const bool in = e < W;
              offer(Lv, Lc, W, tv, tc, in ? Rv[e] : kNegInf, in ? Rc[e] : 0,
                    in, lane);
            }
          }
        }
      }
      cluster.sync();  // rank 0 has read every list: the blocks may leave
    }
    if (rank == 0) {
      for (int i = tid; i < kQB * W; i += kThreads) {
        const int r = i / kQB, q = i % kQB, b = qbase + q;
        if (b < B) {
          const long long o = ((long long)slot * rounds + p0 + r) * B + b;
          val[o] = lv[q * P + r];
          col[o] = lc[q * P + r] + col_base;
        }
      }
    }
    if (tid < kQB) {
      fv[tid] = lv[tid * P + W - 1];
      fc[tid] = lc[tid * P + W - 1];
    }
    __syncthreads();
  }
}

template <typename Ops, bool Mma>
int launch_stream_as(const Ops& ops, const int* size, const int* tiles,
                     int slots, float* val, int* col, int B, int N, int D,
                     int tile, int rounds, bool global_ids,
                     cudaStream_t stream) {
  const int Dw = row_words<Ops>(D);
  const int nqb = (B + kQB - 1) / kQB;
  const int P = rounds < kListCap ? rounds : kListCap;
  int split = 1;
  if (rounds <= kListCap)
    while (split < kMaxSplit && 2 * split * kChunk <= tile &&
           (long long)slots * nqb * split < kFillBlocks)
      split *= 2;
  const long long blocks = (long long)slots * nqb * split;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes<Ops, Mma>(D, P);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stream_topk_kernel<Ops, Mma>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, stream_topk_kernel<Ops, Mma>, ops, size,
                           tiles, val, col, B, N, D, Dw, tile, rounds, nqb,
                           split, global_ids ? 1 : 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch the streaming selection over `slots` tiles (ids from `tiles`, or
// the slot itself where `tiles` is null). The tensor-core stage (bf16/f16
// rows up to kMmaMaxD features, where its whole rows fit in shared memory:
// up to about 400 features at 64 rounds) and the split over a cluster are
// chosen from the shape alone.
template <typename Ops>
int launch_stream(const Ops& ops, const int* size, const int* tiles,
                  int slots, float* val, int* col, int B, int N, int D,
                  int tile, int rounds, bool global_ids,
                  cudaStream_t stream) {
  if (slots <= 0) return 0;
  if constexpr (!std::is_void<typename MmaType<Ops>::T>::value) {
    const int P = rounds < kListCap ? rounds : kListCap;
    if (D <= kMmaMaxD &&
        stream_smem_bytes<Ops, true>(D, P) <= (size_t)kMaxSmem)
      return launch_stream_as<Ops, true>(ops, size, tiles, slots, val, col,
                                         B, N, D, tile, rounds, global_ids,
                                         stream);
  }
  return launch_stream_as<Ops, false>(ops, size, tiles, slots, val, col, B,
                                      N, D, tile, rounds, global_ids, stream);
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
