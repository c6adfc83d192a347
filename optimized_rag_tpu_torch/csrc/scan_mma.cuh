// The packed scans K1, K2 and K3 and the scan floor (F) on the tensor cores:
// one main loop, wgmma fed by TMA, with three epilogues.
//
// Replaces the CUDA-core score block (ScoreBlock: f32 FMA, or __dp4a for
// int8) that these TPU kernels' ports ran before:
// * K1 over bf16 and f16 rows (`_packed_extract_kernel` /
//   `_pack_tile_scores`, optimized_rag_tpu/ops/topk.py:511-527, :576-618)
//   and F (`_floor_kernel`, benchmarks/sweep_r4_kernel.py:128,
//   benchmarks/sweep_r4c.py:157): a `dot_general` with f32 accumulation on
//   the MXU; here wgmma m64n64k16 bf16 x bf16 (or f16 x f16) -> f32.
// * K2 over int8 codes and bf16 rows (`_packed_extract_scaled_kernel`,
//   :530-545): the query rounded to bf16 times the rows rounded to bf16, an
//   f32 sum, then x row scale; here the same wgmma, then x cs[row]. int8
//   codes are exact in bf16: the consumers widen each TMA slice of codes
//   into a bf16 copy in shared memory (16 codes a thread at a time, 16-byte
//   loads and stores), once a block for both warpgroups, and the slice then
//   runs as K1's, A from a descriptor. Widening in registers instead (each
//   thread its own A fragment, wgmma with A from registers) widened every
//   code once a warpgroup and issued one commit group a step: 19.0 against
//   17.0 ms at the benchmark's shape (PERF.md, Findings). f16 and f32 rows
//   keep the FMA kernel of packed_extract.cu (a dispatch by dtype there).
// * K3 (`_packed_extract_int8_kernel`, :548-573): an int8-native
//   `dot_general(..., preferred_element_type=int32)`, then (i32 * cs) * qs;
//   here wgmma m64n64k32 s8 x s8 -> s32 (k-slices of 128 codes, 128 bytes
//   as for 16-bit values), then __fmul_rn(__fmul_rn(float(i32), cs[row]),
//   qs[b]). The int32 sums are exact, so K3's words are its twin's bit for
//   bit at any width, in any summation order; no bound is needed beyond
//   overflow: |sum| <= 128 * 128 * D < 2**31 for D <= 131,071
//   (`MAX_INT8_D`, which the wrapper enforces).
// f32 rows keep the FMA kernels for K1 and F (the tensor cores would need
// TF32, a different function): the dispatch is by dtype, in
// packed_extract.cu and floor.cu.
//
// What bounds it (H100 SXM). At the reference benchmark's shape (B=1024,
// N=10,485,760, D=128, tile 4096): 2.75 T products at 989 TFLOP/s (bf16:
// K1, F, K2) or 1,979 TOP/s (int8: K3), 2.78 or 1.39 ms, against 2.68 GB of
// bf16 rows (0.80 ms) or 1.38 GB of codes and scales (0.41 ms): the tensor
// cores bind, and the packing (3.5 CUDA-core instructions a score for K1,
// 10.7 G scores) runs beside them. At the served shapes (B=64, D=384, tile
// 1024: 4,194,304 bf16 rows for K1, 3.2 GB, 0.96 ms; 16,777,216 int8 codes
// for K3, 6.51 GB with the scales, 1.95 ms) bytes bind, so the ring has to
// keep device memory busy.
//
// Design.
// * Corpus rows are wgmma's M side (64 rows a chunk), queries its N side
//   (64 a consumer warpgroup; two warpgroups, 128 queries a block, where
//   B > 64, both reading each slice at once). Rows as M keeps the 64-row
//   granularity on the corpus, which every tile divides; queries as N
//   would let a batch of 1 pay for 8 instead of 64, but where B is small
//   the rows' bytes bind (at B=64 the products take a fifth of the bytes'
//   time), so one N keeps one instantiation an epilogue.
// * A k-slice is 128 bytes of a row: 64 bf16/f16 values or 128 int8 codes.
//   One wgmma step reads 32 bytes of each operand row (k16 for 16-bit
//   values, k32 for int8), so a slice is four steps, or eight where K2
//   widens codes to bf16 (the widened slice and the queries' then span two
//   tiles of 64 bf16 features).
// * The queries of a block are staged once, from [B, D] in the operand
//   type (bf16/f16 values, exact: they are already rounded to it; int8
//   codes for K3), in the 128-byte-swizzled K-major layout wgmma reads, and
//   stay resident for the whole tile where they fit in 232,448 bytes of
//   shared memory (one warpgroup: K1 and K2 to D=1408, K3 to D=2816). Past
//   that (`stream_q`) each ring stage carries the block's queries for its
//   k-slice beside the rows' (a second tensor map over the queries [B,
//   D]), so any D runs; the queries then come from L2 once a chunk.
// * A producer warp loads each chunk's k-slices (64 rows x 128 bytes, 8 KB,
//   128-byte swizzle) into a ring of kStages stages with TMA
//   (cp.async.bulk.tensor, a 2-D tensor map; values past D arrive as
//   zeros, which add exactly 0), one full and one empty mbarrier a stage.
//   Rows whose stride is no multiple of 16 bytes, or a corpus not 16-byte
//   aligned, cannot be described to TMA: there the producer warp copies the
//   slice with plain loads into the same swizzled layout and arrives on the
//   same barrier. The consumers issue one commit group of wgmma a slice
//   (accumulators in registers) and release a slice's stage once the next
//   slice is issued and its own group has completed. K2 over codes widens
//   the slice between two barriers across the consumers (before it, every
//   warpgroup's products of the last slice are done; after it, the widened
//   slice is complete), releases the codes' stage, then issues; its ring
//   has 3 stages, so that the 16 KB widened slice leaves two blocks an SM
//   at B > 64, D=128. Then the epilogue runs on the finished chunk.
// * Two blocks an SM at least (__launch_bounds__(288, 2)), so that one
//   block's epilogue overlaps the other's products. The running top twos
//   live in shared memory for that, and the folds at the tile's end reuse
//   the ring, so that K3 at the served shape (one warpgroup, D=384: 75 KB)
//   fits three blocks an SM. Measured slower on the card (PERF.md,
//   Findings): 128 queries a warpgroup (one block an SM), a ring filling
//   the shared memory, a ring of 8 stages, and the two warpgroups taking
//   the tensor cores in turn.
// * Grid: one block per (tile, query block), the query blocks of a tile
//   adjacent, so that a tile comes from device memory once and from L2 for
//   its other query blocks.
// * The accumulator layout (f32 or s32 alike): thread (warp w, lane l) of a
//   warpgroup holds rows 16w + l/4 and 16w + l/4 + 8 of the chunk, and
//   queries 8j + 2(l % 4) + {0, 1}, j < 8: 32 scores.
//
// F's epilogue: a running max per query in registers (16 a thread), folded
// across the 16 threads that share a query (shuffles, then shared memory)
// at the tile's end.
//
// The packing epilogue of K1, K2 and K3 (`_pack_tile_scores`): the score
// (the sum; K2: x cs[row], each thread loading its two rows' scales a
// chunk; K3: (float(sum) x cs[row]) x qs[b], the block's query scales
// staged once in shared memory: held in registers, a thread's 16 spilled
// under the 96 registers ptxas gives two blocks an SM), shifted to s + 2,
// rows at or after `size` to 0, the f32 bits with the low log2(tile) bits
// replaced by the tile-local row, the max over each strided unit {u, u +
// tile/G, ...}, the top two unit winners, and the range flag. That is the
// reference's function, which shifts to max(s + 2, 0), wherever the flag
// stays clear: a live s in (-2, 2) gives an f32 s + 2 of at least 2^-23,
// so the max with 0 changes nothing (and a flagged call's words are never
// read). The flag is bit 30 of the OR of the live scores' bits, tested
// once at the tile's end: for a finite s that bit, the exponent's top one,
// is set exactly when |s| >= 2; NaNs set it too. The padding test runs
// only in a chunk that reaches past `size` (a branch the whole block takes
// alike), so a score costs an FADD (s + 2), a LOP3 (low bits cleared, the
// row or-ed in), an integer max and half a LOP3 (the OR, two scores an
// instruction) after its multiplies (PERF.md has the SASS counts). Where a
// unit spans whole chunks (tile/G >= 64), the chunks are walked with the
// group innermost: chunk g*(tile/G) + 64j for g < G, then j + 1, so a
// unit's rows fall on the same accumulator register across the G chunks
// and its winner is a register integer max; after the G chunks each thread
// folds its 32 unit winners into its own top two for each of its 16
// queries (packed words are distinct by their row bits), and at the tile's
// end the 16 threads of a query merge their top twos (shuffles, then
// shared memory). No shared table of units and no atomics. Where tile/G <
// 64, a register keeps the max over the rows congruent to it modulo 64 for
// the whole tile, and a shared-memory fold at the end takes each unit's max
// over its 64/(tile/G) registers and the top two.
//
// The numerical argument (why K1 and K2 may keep the tensor cores' sums).
// Notation: u = 2^-24; p_i = q_i c_i the exact products (q the query as
// the scan takes it, c the row as 16-bit values or codes); S_raw = sum_i
// |p_i|; S = S_raw for K1, cs S_raw for K2 (the scaled products' sum).
// * Products: a bf16 x bf16 (or f16 x f16) product is exact in f32, and so
//   is bf16 x code (|code| <= 128 has 8 significant bits).
// * The tensor cores' accumulation is not IEEE round-to-nearest. The model
//   taken here is the one measured on NVIDIA's earlier tensor cores (Fasi,
//   Higham, Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor
//   cores", PeerJ CS 2021): a block of n_b >= 4 exact products and the
//   accumulator are aligned to the largest exponent among them, each term
//   truncated to the f32 significand, summed, and the sum normalised with
//   truncation. Each truncation loses less than one unit in the last place
//   of the largest term (<= 2u S_raw), and the normalisation less than 2u
//   S_raw, so a block costs at most (n_b + 1) 2u S_raw, and one k16 step
//   (16/n_b blocks) at most 40u S_raw.
// * Full accumulation (every k16 step onto the running accumulator), D16 =
//   D rounded up to 16 (the zero products past D add exactly 0):
//       delta_raw(D) <= (D16 / 16) * 40u S_raw = 2.5 D16 u S_raw.
// * Split accumulation (each k16 step into fresh registers, then added to a
//   running f32 sum by IEEE round-to-nearest FADD):
//       delta_raw(D) <= 40u S_raw + (D16 / 16) u S_raw.
//   units(D) = 2.5 D16 (full) or 40 + D16/16 (split).
// * The c1 rescore (`_exact_rowwise_scores`, an f32 matmul in some order,
//   IEEE round-to-nearest) drifts from the exact sum by at most D u S_raw.
// * K2's score and its c1 rescore (`_exact_rowwise_scores_scaled`) are
//   both their sum times cs rounded to nearest: each differs from cs times
//   its sum by at most u |score| <= u S (plus terms in u^2, which the 1.01
//   below covers). So the scan's scaled score is within
//       delta(D) = (units(D) + 1) u S
//   of the exact scaled score (cs times the exact sum), and c1's within
//   (D + 1) u S. For K1 there is no multiply: delta(D) = units(D) u S, c1
//   within D u S.
// * Soundness: a tile stays out of c2 (and a candidate out of c1, c3) only
//   when the word's upper bound, its value plus two quanta, is <= tau, the
//   k-th c1 score. Every row r the word stands for has a scan score below
//   its value plus one quantum, so c1(r) < ub - quantum + delta + drift:
//   sound while the two drifts together stay within one quantum. On (2, 4)
//   (scores in [0, 2)) the quantum is tile * 2^-22 = 4 tile u. So the scan
//   takes (tile, D) with full accumulation where
//       S_max (units_full(D) + D + e) <= 4 tile,
//   else with split accumulation where
//       S_max (units_split(D) + D + e) <= 4 tile,
//   and refuses the rest; e = 0 for K1 and 2 for K2 (the two roundings of
//   the multiply).
// * S_max, the largest S the route admits with normalised queries:
//   - K1: rows of norm at most 1 + 2^-8 (DenseIndex.add normalises them)
//     and the query rounded to bf16/f16: S <= (1 + 2^-9)(1 + 2^-8) < 1.01.
//   - K2 over bf16 rows scaled by `row_scale`: the same, for rows whose
//     scaled values (row x cs) have norm at most 1 + 2^-8: S_max = 1.01.
//   - K2 over int8 codes from `quantize_int8` of rows x of norm at most
//     1 + 2^-8: cs = max|x_i| f32(1/127) <= (1 + 2^-8)/127 and each
//     dequantised value code_i cs lies within cs/2 of x_i (round to
//     nearest; the few ulps of cs and of 127/max|x_i| are covered by the
//     slack below), so by Cauchy-Schwarz
//         S <= |q| |code cs| <= (1 + 2^-9)(|x| + sqrt(D) cs / 2)
//           <= (1 + 2^-9)(1 + 2^-8)(1 + sqrt(D)/254) < 1.01 (1 + sqrt(D)/254).
//     That is S_max = 1.01 (1 + sqrt(D)/254): 1.0549 at D=128, 1.0879 at
//     D=384, not K1's 1.01.
//   The rule lives in one place, `scan_accumulation(tile, D, route)` in
//   ops/topk_kernels.py (with `scan_drift_bound` and
//   `scan_query_norm_limit`); the wrappers raise where it refuses and pass
//   the mode in (`split`). K1: full to D=640 at tiles 1024 and 4096 (the
//   served D=384 and the benchmark's D=128: 1.01 * 448 u against a quantum
//   of 16,384 u), split to D=3778 at tile 1024 and D=15,229 at 4096; tile
//   128 full to D=144, split to D=438 (refuses D=640). K2 over bf16 rows:
//   two features fewer at each edge (split to D=436 at tile 128). K2 over
//   codes: tile 128 full to D=128, split to D=401; tile 256 full to D=270,
//   split to D=817; tile 1024 full to D=640, split to D=3091; tile 4096
//   full to D=640, split to D=10,795 (the benchmark's D=128: 1.0549 * 450 u
//   against 16,384 u).
// * Full accumulation also stops at D16 = 640 (40 k16 steps), for F too.
//   Its truncation is one-signed, so on a sum near 1 it drifts by a share
//   of a unit in the last place every step: measured on the card, F at
//   D=2048 (f16) was 1.1e-5 from its twin on a row equal to its query,
//   0.7 ulp a step, past the 1e-5 within which the card tests and
//   chip_smoke.py hold F and the packed words. 40 steps keep it under 40
//   ulp of 1 (4.8e-6); split accumulation rounds to nearest, so its error
//   does not pile up one way.
// * The precondition S <= S_max is the caller's: rows as above and
//   normalised queries. The wrappers check the queries on the card without
//   a host sync: where their largest norm (after the rounding the scan
//   takes) exceeds what the bound admits at (tile, D) for such rows
//   (`scan_query_norm_limit`), they set the range flag, and the
//   certificate reads -1 as for a score outside (-2, 2).
// * Below 2 (negative scores) the quanta halve with each binade, as they
//   do for the FMA kernels and for the reference's MXU pass: the argument
//   covers tau >= delta + drift (a word below 2 stands for rows scoring
//   below 0).
// * F has no certificate; it accumulates in full to D16 = 640, split past
//   that, and is held within 1e-5 of its twin.
// The measured counterpart of delta: the raw sums (`scan_sums`, this main
// loop in either accumulation with a store epilogue; over int8 codes K2's
// widening loop) against the exact sums on adversarial operands (mixed
// exponents, cancellation, codes of +-127 beside small ones), held to
// units(D) u S_raw with each pair's own S_raw in
// tests/test_torch_kernels_cuda.py; F's largest difference from its twin
// (chip_smoke.py's `score_diff`); and K1's and K2's words held against the
// twins' under `packed_word_faults` (drift 1e-5).
// tests/test_torch_scan_drift.py runs the certified routes (dense and
// scaled) on the CPU with the scan moved by delta, and shows that a scan
// 1.5 quanta off certifies wrong answers on the same data.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cudaTypedefs.h>
#include <string.h>

#include "topk_common.cuh"

namespace orag {
namespace scan {

constexpr int kM = 64;             // corpus rows a chunk (wgmma M)
constexpr int kRowBytes = 128;     // a k-slice of one row: 128 bytes
constexpr int kNQ = 64;            // queries a consumer warpgroup (wgmma N)
constexpr int kStages = 4;         // ring depth (K2 over codes: 3, below)
constexpr int kTileBytes = kM * kRowBytes;  // a slice of 64 rows or queries
constexpr int kAcc = kM * kNQ / 128;        // accumulators a thread: 32
constexpr int kQT = kNQ / 4;       // queries a thread: 16

// F's max, the packing of K1/K2/K3, and the raw sums (out f32 [N, B]) by
// which the card tests measure the accumulation against the exact sums.
enum Epilogue { kFloor = 0, kPack = 1, kRaw = 2 };
// What multiplies the sum into the score: nothing (K1, F), the row scale
// (K2), the row scale then the query scale (K3).
enum Scale { kNone = 0, kRow = 1, kRowQuery = 2 };

// An operand element: its raw bits, and the type TMA copies it as.
template <typename T>
struct Elem {
  using Bits = uint16_t;
  static constexpr CUtensorMapDataType kMap =
      std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Elem<int8_t> {
  using Bits = uint8_t;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const void* map,
                                            int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A named barrier over `threads` threads (ids 1.. ; 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A K-major, 128-byte-swizzled wgmma operand at shared address `a`: rows of
// 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t a) {
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |           // leading offset (unused)
         (static_cast<uint64_t>(1024 >> 4) << 32) |   // 8-row group stride
         (static_cast<uint64_t>(1) << 62);            // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of registers that an
// asynchronous wgmma reads or writes across its issue and wait.
__device__ __forceinline__ void fence_regs(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ORAG_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ORAG_WGMMA_OUT(c, d)                                                \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]),   \
      c(d[8]), c(d[9]), c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]),   \
      c(d[15]), c(d[16]), c(d[17]), c(d[18]), c(d[19]), c(d[20]),           \
      c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]), c(d[26]),           \
      c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define ORAG_F(x) "+f"(x)
#define ORAG_R(x) "+r"(x)

// One wgmma step, d (+)= A B^T over 32 bytes of each operand row, A [64
// rows] and B [64 queries] K-major in shared memory; `accumulate` 0
// overwrites d. The operand type picks the instruction.
__device__ __forceinline__ void mma_step(float (&d)[kAcc], uint64_t a,
                                         uint64_t b, int accumulate,
                                         __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ORAG_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ORAG_WGMMA_OUT(ORAG_F, d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma_step(float (&d)[kAcc], uint64_t a,
                                         uint64_t b, int accumulate, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " ORAG_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ORAG_WGMMA_OUT(ORAG_F, d)
      : "l"(a), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void mma_step(int (&d)[kAcc], uint64_t a,
                                         uint64_t b, int accumulate, int8_t) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " ORAG_WGMMA_D32
      ", %32, %33, p;\n}\n"
      : ORAG_WGMMA_OUT(ORAG_R, d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// Byte offset of byte `k` < 128 of row r in a 128-byte-swizzled block
// whose base is 1024-byte aligned.
__device__ __forceinline__ int sw128(int r, int k) {
  return r * kRowBytes + ((((k >> 4) ^ r) & 7) << 4) + (k & 15);
}

// Two int8 codes (the low 16 bits) as a bf16 pair, exactly: each code
// biased to 0..255 becomes the low byte of the f32 2^23 + code + 128, from
// which 2^23 + 128 is subtracted; the f32 pair rounds to bf16 exactly
// (|code| <= 128 has 8 significant bits).
__device__ __forceinline__ uint32_t codes_bf16x2(uint32_t two) {
  const uint32_t u = two ^ 0x8080u;
  const float lo =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 int8 codes as 16 bf16 values, exactly (memory order kept).
__device__ __forceinline__ void widen16(const uint4& c, uint4& lo,
                                        uint4& hi) {
  lo = make_uint4(codes_bf16x2(c.x), codes_bf16x2(c.x >> 16),
                  codes_bf16x2(c.y), codes_bf16x2(c.y >> 16));
  hi = make_uint4(codes_bf16x2(c.z), codes_bf16x2(c.z >> 16),
                  codes_bf16x2(c.w), codes_bf16x2(c.w >> 16));
}

// ------------------------------------------------------------ the kernel

struct Params {
  const void* q;          // [B, D] queries in the operand type (raw bits)
  const void* c;          // [N, D] rows (raw bits)
  const float* cs;        // [N] row scales (K2, K3)
  const float* qs;        // [B] query scales (K3)
  const int* size_ptr;    // live rows
  void* out;              // F: f32 [T, 1, B]; packed: int32 [T, 2, B];
                          // raw: f32 [N, B]
  int* flag;              // packed: range flag
  int B, N, D, tile, groups, nwg, use_tma, stream_q;
};

// Dynamic shared memory: the ring, the queries, the barriers, the top twos
// and K3's query scales. The folds at the tile's end reuse the ring.
// With resident queries a stage holds one k-slice of 64 rows; with streamed
// queries (`stream_q`) it holds the query block's tiles for the same
// features behind it (`qtiles` of them a warpgroup: 1, or 2 for K2 over
// codes). The packing keeps each thread's running top twos ([2][16] ints a
// thread, touched once every G chunks) in shared memory rather than
// registers, so that two blocks fit an SM.
struct Layout {
  int stage, ring, wide, queries, bars, top, scales, total;
  __host__ __device__ Layout(int D, int nwg, bool pack, bool stream_q,
                             int row_el, int qtiles, int stages,
                             bool widen) {
    const int slices = (D + row_el - 1) / row_el;
    stage = kTileBytes + (stream_q ? nwg * qtiles * kTileBytes : 0);
    ring = 0;
    wide = stages * stage;  // K2 over codes: a slice widened to bf16
    queries = wide + (widen ? 2 * kTileBytes : 0);
    bars = queries + (stream_q ? 0 : slices * qtiles * nwg * kTileBytes);
    top = bars + 2 * stages * 8;
    scales = top + (pack ? nwg * 128 * 2 * kQT * 4 : 0);
    total = scales + (pack ? nwg * kNQ * 4 : 0);  // K3's query scales
  }
};
// The folds at the tile's end: [4 warps][64][2] ints a warpgroup, or the
// tile/G < 64 fold's [64 rows][64] ints, in the ring (and the widened
// slice behind it).
static_assert(kStages * kTileBytes >= 2 * kM * kNQ * 4 &&
                  (kStages - 1) * kTileBytes + 2 * kTileBytes >=
                      2 * kM * kNQ * 4,
              "the ring must hold the folds of two warpgroups");

// The tile-local first row of chunk c. The packing with units of whole
// chunks walks the chunks group-innermost (see the header); else in order.
__device__ __forceinline__ int chunk_row(int c, int small, int groups,
                                         bool strided) {
  return strided ? (c % groups) * small + (c / groups) * kM : c * kM;
}

// Top-two merge of distinct packed words (0 is below every word).
__device__ __forceinline__ void top2_insert(int& t1, int& t2, int v) {
  const int lo = min(t1, v);
  t1 = max(t1, v);
  t2 = max(t2, lo);
}

// TR: the rows' type; TQ: the queries' (and the products') type: equal,
// except K2 over codes (int8 rows, bf16 queries: the rows widened in shared
// memory).
template <typename TR, typename TQ, int Epi, bool Split, int Sc>
__global__ void __launch_bounds__(2 * 128 + 32, 2)
    scan_mma_kernel(const __grid_constant__ CUtensorMap map,
                    const __grid_constant__ CUtensorMap qmap, const Params p) {
  constexpr bool kInt = std::is_same<TQ, int8_t>::value;
  using Acc = typename std::conditional<kInt, int, float>::type;
  using RBits = typename Elem<TR>::Bits;
  using QBits = typename Elem<TQ>::Bits;
  constexpr int kRowEl = kRowBytes / (int)sizeof(TR);  // features a slice
  constexpr int kQEl = kRowBytes / (int)sizeof(TQ);    // features a query tile
  constexpr int kQTiles = kRowEl / kQEl;               // query tiles a slice
  constexpr int kStep = 32 / (int)sizeof(TQ);          // features a step
  constexpr int kSteps = kRowEl / kStep;               // steps a slice
  // K2 over codes: each slice widened to bf16 in shared memory, with one
  // ring stage fewer to make room (two blocks an SM at B > 64, D=128).
  constexpr bool kWiden = !std::is_same<TR, TQ>::value;
  constexpr int kSt = kWiden ? kStages - 1 : kStages;
  static_assert(!kInt || (!Split && Epi == kPack), "int8: exact sums");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(p.D, p.nwg, Epi == kPack, p.stream_q, kRowEl, kQTiles, kSt,
                 kWiden);
  const int slices = (p.D + kRowEl - 1) / kRowEl;
  const int nqb = (p.B + kNQ * p.nwg - 1) / (kNQ * p.nwg);
  const int t = blockIdx.x / nqb;
  const int qbase = (blockIdx.x % nqb) * kNQ * p.nwg;
  const long long base = (long long)t * p.tile;
  const int tid = threadIdx.x;
  const int consumers = 128 * p.nwg;
  const uint32_t ring = smem_addr(smem + L.ring);
  const uint32_t full = smem_addr(smem + L.bars);
  const uint32_t empty = full + kSt * 8;
  const int chunks = p.tile / kM;
  const int small = p.tile / p.groups;
  const bool strided = Epi == kPack && small >= kM;
  const QBits* qbits = static_cast<const QBits*>(p.q);

  // Stage the resident queries: tile i of warpgroup w holds features
  // [i * kQEl, (i + 1) * kQEl) of its 64 queries (zeros past D and B).
  if (!p.stream_q) {
    const int nq = kNQ * p.nwg;
    const int width = slices * kRowEl;
    for (int idx = tid; idx < width * nq; idx += blockDim.x) {
      const int f = idx % width, n = idx / width;
      const int b = qbase + n;
      QBits v = 0;
      if (f < p.D && b < p.B) v = qbits[(long long)b * p.D + f];
      unsigned char* blk =
          smem + L.queries + ((f / kQEl) * p.nwg + n / kNQ) * kTileBytes;
      *reinterpret_cast<QBits*>(
          blk + sw128(n % kNQ, (f % kQEl) * (int)sizeof(TQ))) = v;
    }
  }
  float* qscale = reinterpret_cast<float*>(smem + L.scales);
  if constexpr (Sc == kRowQuery) {
    for (int n = tid; n < kNQ * p.nwg; n += blockDim.x)
      qscale[n] = qbase + n < p.B ? p.qs[qbase + n] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < kSt; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's one arrival a slice
      mbar_init(empty + 8 * s, 4 * p.nwg);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();  // the staged queries, for wgmma's reads
  __syncthreads();

  // The role, warp-uniform to the compiler too (so that ptxas need not
  // serialise the wgmma behind a divergent branch).
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg >= p.nwg) {
    // ---------------------------------------------------------- producer
    const int lane = tid % 32;
    const RBits* cbits = static_cast<const RBits*>(p.c);
    int stage = 0;
    uint32_t phase = 0;
    for (int c = 0; c < chunks; ++c) {
      const long long row = base + chunk_row(c, small, p.groups, strided);
      for (int s = 0; s < slices; ++s) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t dst = ring + stage * L.stage;
        if (p.use_tma) {
          if (lane == 0) {
            mbar_expect_tx(full + 8 * stage, L.stage);
            tma_load_2d(dst, &map, s * kRowEl, (int)row, full + 8 * stage);
            if (p.stream_q)  // the block's queries, 64 x nwg rows of q
              for (int j = 0; j < kQTiles; ++j)
                tma_load_2d(dst + kTileBytes + j * p.nwg * kTileBytes, &qmap,
                            (s * kQTiles + j) * kQEl, qbase,
                            full + 8 * stage);
          }
        } else {
          unsigned char* st = smem + L.ring + stage * L.stage;
          for (int idx = lane; idx < kM * kRowEl; idx += 32) {
            const int r = idx / kRowEl, k = idx % kRowEl;
            const int f = s * kRowEl + k;
            const RBits v = f < p.D ? cbits[(row + r) * p.D + f] : 0;
            *reinterpret_cast<RBits*>(st + sw128(r, k * (int)sizeof(TR))) =
                v;
          }
          if (p.stream_q) {
            const int nq = kNQ * p.nwg;
            for (int idx = lane; idx < kQTiles * nq * kQEl; idx += 32) {
              const int k = idx % kQEl, n = (idx / kQEl) % nq;
              const int j = idx / (kQEl * nq);
              const int f = (s * kQTiles + j) * kQEl + k, b = qbase + n;
              const QBits v =
                  f < p.D && b < p.B ? qbits[(long long)b * p.D + f] : 0;
              *reinterpret_cast<QBits*>(
                  st + kTileBytes + (j * p.nwg + n / kNQ) * kTileBytes +
                  sw128(n % kNQ, k * (int)sizeof(TQ))) = v;
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(full + 8 * stage);
        }
        if (++stage == kSt) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  const int wt = tid % 128;
  const int warp = wt / 32, lane = wt % 32;
  int size = 0;
  if constexpr (Epi == kPack) size = *p.size_ptr;
  const uint32_t qres = smem_addr(smem + L.queries) + wg * kTileBytes;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  Acc acc[kAcc];
  // F: running max per query. Packing: unit maxima (int bits) and top twos.
  float fm[kQT];
  int um[kAcc];
  // This thread's top twos: top[j * 128], j < 2 * kQT (t1 of query q at
  // j = q, t2 at j = kQT + q).
  int* top = reinterpret_cast<int*>(smem + L.top) + wg * 2 * kQT * 128 + wt;
  // K3: the query scales of this warpgroup's queries.
  const float* wg_qscale = qscale + wg * kNQ;
#pragma unroll
  for (int q = 0; q < kQT; ++q) fm[q] = -INFINITY;
  if constexpr (Epi == kPack) {
#pragma unroll
    for (int j = 0; j < 2 * kQT; ++j) top[j * 128] = 0;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) um[i] = 0;
  int seen = 0;  // packing: the OR of the live scores' bits
  int stage = 0;
  uint32_t phase = 0;
  const auto advance = [&]() {
    if (++stage == kSt) {
      stage = 0;
      phase ^= 1;
    }
  };
  const auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  // The B operand of step j of slice s, whose A lies at stage address a.
  const auto bdesc = [&](uint32_t a, int s, int j) {
    const int f = j * kStep;
    const int tl = f / kQEl, off = (f % kQEl) * (int)sizeof(TQ);
    const uint32_t b =
        p.stream_q ? a + kTileBytes + (tl * p.nwg + wg) * kTileBytes
                   : qres + (s * kQTiles + tl) * p.nwg * kTileBytes;
    return sw128_desc(b + off);
  };
  // Packing: rows at or after `lim` (tile-local) are padding.
  const int lim =
      (int)max(0LL, min((long long)p.tile, (long long)size - base));
  const int mask = ~(p.tile - 1);

  for (int c = 0; c < chunks; ++c) {
    const int row0 = chunk_row(c, small, p.groups, strided);
    float rs0 = 0.f, rs1 = 0.f;  // the row scales of rows r0 and r0 + 8
    if constexpr (Sc != kNone) {
      rs0 = p.cs[base + row0 + r0];
      rs1 = p.cs[base + row0 + r0 + 8];
    }
    if constexpr (kWiden) {
      // K2 over codes: the consumers widen each slice's codes into `wide`
      // (64 rows x 128 bf16: two 128-byte-swizzled tiles), each 16 codes
      // at a time, then the slice runs as K1's with A from `wide`. A
      // barrier before the widening (every warpgroup's products of the
      // last slice done) and one after it (the slice complete).
      const uint32_t wide = smem_addr(smem + L.wide);
      if constexpr (Split) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      } else {
        fence_regs(acc);
      }
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * L.stage;
        const unsigned char* st = smem + L.ring + stage * L.stage;
        wgmma_wait<0>();
        fence_regs(acc);
        named_sync(14, consumers);
        for (int job = wg * 128 + wt; job < kM * 8; job += consumers) {
          const int r = job / 8, g = job % 8;  // row, 16 codes
          uint4 lo, hi;
          widen16(*reinterpret_cast<const uint4*>(st + sw128(r, 16 * g)), lo,
                  hi);
          unsigned char* w = smem + L.wide + (g / 4) * kTileBytes;
          *reinterpret_cast<uint4*>(w + sw128(r, 32 * (g % 4))) = lo;
          *reinterpret_cast<uint4*>(w + sw128(r, 32 * (g % 4) + 16)) = hi;
        }
        if (!p.stream_q) release(stage);  // else B lies in the stage too
        fence_proxy_async();  // the widened slice, for wgmma's reads
        named_sync(14, consumers);
        const auto adesc = [&](int j) {
          return sw128_desc(wide + (j / 4) * kTileBytes + 32 * (j % 4));
        };
        if constexpr (Split) {
          const int ks = min(kSteps, (p.D - s * kRowEl + kStep - 1) / kStep);
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            if (j >= ks) break;
            float part[kAcc];
            wgmma_fence();
            mma_step(part, adesc(j), bdesc(a, s, j), 0, TQ());
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(part);
#pragma unroll
            for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
          }
        } else {
          // Every step runs, unguarded: codes and queries past D are zero.
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < kSteps; ++j)
            mma_step(acc, adesc(j), bdesc(a, s, j), s > 0 || j > 0, TQ());
          wgmma_commit();
        }
        if (p.stream_q) {
          wgmma_wait<0>();
          release(stage);
        }
        advance();
      }
      wgmma_wait<0>();
      fence_regs(acc);
    } else if constexpr (Split) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * L.stage;
        const int ks = min(kSteps, (p.D - s * kRowEl + kStep - 1) / kStep);
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          if (kk >= ks) break;
          Acc part[kAcc];
          wgmma_fence();
          mma_step(part, sw128_desc(a + 32 * kk), bdesc(a, s, kk), 0, TQ());
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
        release(stage);
        advance();
      }
    } else {
      // One commit group a slice; a slice's stage is released once the
      // next slice's products are issued and its own have completed. Every
      // slice runs all its steps, unguarded: values past D are zero in
      // both operands, so their products add exactly 0, and a wgmma behind
      // a branch is serialised by ptxas (C7520).
      fence_regs(acc);
      int prev = 0;
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * L.stage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          mma_step(acc, sw128_desc(a + 32 * kk), bdesc(a, s, kk),
                   s > 0 || kk > 0, TQ());
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        advance();
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(prev);
    }
    // Epilogue of the chunk: accumulator i holds row r0 + 8 * ((i / 2) % 2)
    // and query 8 * (i / 4) + 2 * (lane % 4) + i % 2.
    if constexpr (Epi == kRaw) {
      float* out = static_cast<float*>(p.out);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const long long row = base + row0 + r0 + 8 * ((i / 2) % 2);
        const int b = qbase + wg * kNQ + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        if (b < p.B) out[row * p.B + b] = acc[i];
      }
    } else if constexpr (Epi == kFloor) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int q = (i / 4) * 2 + (i % 2);
        fm[q] = fmaxf(fm[q], acc[i]);
      }
    } else {
      // The word of a live score v: bits(v + 2), low bits the row; its
      // bits OR into `seen`, whose bit 30 is the range flag (see the
      // header). Padding rows give the row alone and nothing to `seen`.
      const auto pack = [&](auto ragged) {
#pragma unroll
        for (int i = 0; i < kAcc; ++i) {
          const int col = row0 + r0 + 8 * ((i / 2) % 2);
          const float rs = (i / 2) % 2 ? rs1 : rs0;
          float v;
          if constexpr (Sc == kNone) {
            v = acc[i];
          } else if constexpr (Sc == kRow) {
            v = __fmul_rn(acc[i], rs);
          } else {
            v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), rs),
                          wg_qscale[8 * (i / 4) + 2 * (lane % 4) + i % 2]);
          }
          int bits = __float_as_int(v), word = __float_as_int(v + 2.0f);
          if constexpr (decltype(ragged)::value) {
            bits = col < lim ? bits : 0;
            word = col < lim ? word : 0;
          }
          seen |= bits;
          um[i] = max(um[i], (word & mask) | col);
        }
      };
      // Only a chunk that reaches past `lim` tests its rows one by one.
      if (row0 + kM <= lim)
        pack(std::false_type());
      else
        pack(std::true_type());
      if (strided && c % p.groups == p.groups - 1) {  // units complete
#pragma unroll
        for (int q = 0; q < kQT; ++q) {  // rows r0 and r0 + 8 of query q
          const int i = 4 * (q / 2) + q % 2;
          int a = top[q * 128], b = top[(kQT + q) * 128];
          top2_insert(a, b, um[i]);
          top2_insert(a, b, um[i + 2]);
          top[q * 128] = a;
          top[(kQT + q) * 128] = b;
          um[i] = um[i + 2] = 0;
        }
      }
    }
  }

  // ---------------------------------------------------------- tile's end
  if constexpr (Epi == kRaw) return;
  const int b0 = qbase + wg * kNQ;
  named_sync(15, consumers);  // every warpgroup's wgmma left the ring
  int* red = reinterpret_cast<int*>(smem + L.ring) + wg * 4 * kNQ * 2;
  if constexpr (Epi == kFloor) {
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1)
        fm[q] = fmaxf(fm[q], __shfl_xor_sync(0xffffffffu, fm[q], m));
    float* redf = reinterpret_cast<float*>(red);
    if (lane < 4) {
#pragma unroll
      for (int q = 0; q < kQT; ++q)
        redf[warp * kNQ + (q / 2) * 8 + 2 * lane + q % 2] = fm[q];
    }
    named_sync(1 + wg, 128);
    if (wt < kNQ && b0 + wt < p.B) {
      float m = redf[wt];
      for (int w = 1; w < 4; ++w) m = fmaxf(m, redf[w * kNQ + wt]);
      static_cast<float*>(p.out)[(long long)t * p.B + b0 + wt] = m;
    }
    return;
  } else {
    if (seen & 0x40000000) *p.flag = 1;  // some live |v| >= 2, or a NaN
    int* out = static_cast<int*>(p.out);
    if (!strided) {
      // tile/G < 64: register i holds the max over rows = its row mod 64;
      // unit u gathers the registers of rows u, u + small, ... < 64.
      int* fold = reinterpret_cast<int*>(smem + L.ring) + wg * kM * kNQ;
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int r = r0 + 8 * ((i / 2) % 2);
        const int q = 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        fold[r * kNQ + q] = um[i];
      }
      named_sync(1 + wg, 128);
      if (wt < kNQ && b0 + wt < p.B) {
        int w1 = 0, w2 = 0;
        for (int u = 0; u < small; ++u) {
          int m = 0;
          for (int r = u; r < kM; r += small) m = max(m, fold[r * kNQ + wt]);
          top2_insert(w1, w2, m);
        }
        out[((long long)t * 2 + 0) * p.B + b0 + wt] = w1;
        out[((long long)t * 2 + 1) * p.B + b0 + wt] = w2;
      }
      return;
    }
    int t1[kQT], t2[kQT];
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      t1[q] = top[q * 128];
      t2[q] = top[(kQT + q) * 128];
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q)
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        const int o1 = __shfl_xor_sync(0xffffffffu, t1[q], m);
        const int o2 = __shfl_xor_sync(0xffffffffu, t2[q], m);
        t2[q] = max(min(t1[q], o1), max(t2[q], o2));
        t1[q] = max(t1[q], o1);
      }
    if (lane < 4) {
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const int qi = (q / 2) * 8 + 2 * lane + q % 2;
        red[(warp * kNQ + qi) * 2 + 0] = t1[q];
        red[(warp * kNQ + qi) * 2 + 1] = t2[q];
      }
    }
    named_sync(1 + wg, 128);
    if (wt < kNQ && b0 + wt < p.B) {
      int w1 = red[wt * 2], w2 = red[wt * 2 + 1];
      for (int w = 1; w < 4; ++w) {
        const int o1 = red[(w * kNQ + wt) * 2];
        const int o2 = red[(w * kNQ + wt) * 2 + 1];
        w2 = max(min(w1, o1), max(w2, o2));
        w1 = max(w1, o1);
      }
      out[((long long)t * 2 + 0) * p.B + b0 + wt] = w1;
      out[((long long)t * 2 + 1) * p.B + b0 + wt] = w2;
    }
  }
}

// ------------------------------------------------------------------ host

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(ptr);
  }
  return fn;
}

// A 2-D tensor map of T [rows, D] in boxes of 128 bytes x `box_rows`,
// 128-byte swizzle (out-of-range values arrive as zeros).
template <typename T>
bool encode_map(CUtensorMap* map, const void* base, int rows, int D,
                int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)(kRowBytes / sizeof(T)),
                             (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, Elem<T>::kMap, 2, const_cast<void*>(base), dims,
                strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TR, typename TQ, int Epi, bool Split, int Sc>
int launch_as(const Params& p, const CUtensorMap& map,
              const CUtensorMap& qmap, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_mma_kernel<TR, TQ, Epi, Split, Sc>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nqb = (p.B + kNQ * p.nwg - 1) / (kNQ * p.nwg);
  const long long blocks = (long long)(p.N / p.tile) * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_mma_kernel<TR, TQ, Epi, Split, Sc>
      <<<(unsigned)blocks, 128 * p.nwg + 32, smem, stream>>>(map, qmap, p);
  return (int)cudaGetLastError();
}

// F (Epi kFloor, out f32 [T, 1, B]), a packed scan (kPack, out int32 [T,
// 2, B]) or the raw sums (kRaw, out f32 [N, B]) of rows TR against queries
// TQ; `split` 1 takes split accumulation (the caller decides, see the
// header; int8 x int8 sums are exact and take none).
// q: [B, D] queries as TQ; corpus: [N, D] as TR; cs: [N] row scales (Sc >=
// kRow); qs: [B] query scales (kRowQuery). Returns a cudaError_t code.
template <typename TR, typename TQ, int Epi, int Sc>
int launch(const void* q, const void* corpus, const float* cs,
           const float* qs, const int* size, void* out, int* flag, int B,
           int N, int D, int tile, int groups, int split,
           cudaStream_t stream) {
  constexpr int kRowEl = kRowBytes / (int)sizeof(TR);
  constexpr int kQTiles = kRowEl * (int)sizeof(TQ) / kRowBytes;
  constexpr bool kInt = std::is_same<TQ, int8_t>::value;
  constexpr bool kWiden = !std::is_same<TR, TQ>::value;
  if (split < 0 || split > 1 || (kInt && split) || tile % kM || B < 1 ||
      D < 1 || N < tile || N % tile)
    return (int)cudaErrorInvalidValue;
  // Two warpgroups (128 queries a block) where B > 64, both reading each
  // slice at once; the queries resident where they fit, else streamed
  // through the ring beside the rows.
  const bool pack = Epi == kPack;
  const auto smem_bytes = [&](int nwg, bool stream_q) {
    return (size_t)Layout(D, nwg, pack, stream_q, kRowEl, kQTiles,
                          kWiden ? kStages - 1 : kStages, kWiden).total +
           1024;  // + alignment to 1024 bytes
  };
  int nwg = B > kNQ ? 2 : 1;
  bool stream_q = false;
  if (smem_bytes(nwg, false) > (size_t)kMaxSmem) nwg = 1;
  if (smem_bytes(nwg, false) > (size_t)kMaxSmem) {
    stream_q = true;
    nwg = B > kNQ ? 2 : 1;
  }
  const size_t smem = smem_bytes(nwg, stream_q);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{q, corpus, cs, qs, size, out, flag, B, N, D, tile, groups, nwg,
           0, stream_q};
  CUtensorMap map, qmap;
  memset(&map, 0, sizeof(map));
  memset(&qmap, 0, sizeof(qmap));
  // TMA needs row strides of a multiple of 16 bytes and 16-byte alignment.
  const auto tma_ok = [&](const void* ptr, size_t el) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (D * el) % 16 == 0;
  };
  if (tma_ok(corpus, sizeof(TR)) && (!stream_q || tma_ok(q, sizeof(TQ)))) {
    if (!encode_map<TR>(&map, corpus, N, D, kM))
      return (int)cudaErrorNotSupported;
    if (stream_q && !encode_map<TQ>(&qmap, q, B, D, kNQ * nwg))
      return (int)cudaErrorNotSupported;
    p.use_tma = 1;
  }
  if constexpr (!kInt) {
    if (split)
      return launch_as<TR, TQ, Epi, true, Sc>(p, map, qmap, smem, stream);
  }
  return launch_as<TR, TQ, Epi, false, Sc>(p, map, qmap, smem, stream);
}

}  // namespace scan
}  // namespace orag
