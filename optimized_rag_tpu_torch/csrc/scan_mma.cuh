// The packed scan (K1) and the scan floor (F) over bf16 and f16 rows on the
// tensor cores: one main loop, wgmma fed by TMA, with two epilogues.
//
// Replaces, for 16-bit rows, the CUDA-core score block (ScoreBlock, f32
// FMA) that K1 (`_packed_extract_kernel` / `_pack_tile_scores`,
// optimized_rag_tpu/ops/topk.py:511-527, :576-618) and F (`_floor_kernel`,
// benchmarks/sweep_r4_kernel.py:128, benchmarks/sweep_r4c.py:157) ran
// before. Both TPU kernels score on the MXU (`dot_general` with f32
// accumulation); this is the same function on Hopper's tensor cores. f32
// rows keep the FMA kernels (the tensor cores would need TF32, a different
// function): the dispatch is by dtype, in packed_extract.cu and floor.cu.
//
// What bounds it (H100 SXM). At the reference benchmark's shape (B=1024,
// N=10,485,760, D=128, tile 4096): 2.75 TFLOP at 989 TFLOP/s, 2.78 ms,
// against 2.68 GB of rows at 3.35 TB/s, 0.80 ms: the tensor cores bind,
// and K1's packing (about 8 CUDA-core operations a score, 10.7 G scores)
// runs beside them. At the served shape (B=64, N=4,194,304, D=384, tile
// 1024): 3.2 GB of rows, 0.96 ms, against 0.21 TFLOP, 0.21 ms: bytes bind,
// so the ring has to keep device memory busy.
//
// Design.
// * Corpus rows are wgmma's M side (64 rows a chunk), queries its N side
//   (64 a consumer warpgroup; two warpgroups, 128 queries a block, where
//   B > 64, both reading each slice at once). Rows as M keeps the 64-row
//   granularity on the corpus, which every tile divides; queries as N
//   would let a batch of 1 pay for 8 instead of 64, but where B is small
//   the rows' bytes bind (at B=64 the products take a fifth of the bytes'
//   time), so one N keeps one instantiation an epilogue.
// * The queries of a block are staged once, as 16-bit values (they arrive
//   as f32 already rounded to the corpus dtype, so the conversion is
//   exact), in the 128-byte-swizzled K-major layout wgmma reads, and stay
//   resident for the whole tile where they fit: up to D=1344 (232,448 bytes
//   of shared memory, one warpgroup). Past that (`stream_q`) each ring
//   stage carries the block's queries for its k-slice beside the rows'
//   (a second tensor map over the same queries as 16-bit values [B, D]),
//   so any D runs; the queries then come from L2 once a chunk.
// * A producer warp loads each chunk's k-slices (64 rows x 64 features, 8
//   KB, 128-byte swizzle) into a ring of kStages stages with TMA
//   (cp.async.bulk.tensor, a 2-D tensor map; features past D arrive as
//   zeros), one full and one empty mbarrier a stage. Rows whose stride is
//   no multiple of 16 bytes (D % 8 != 0), or a corpus not 16-byte aligned,
//   cannot be described to TMA: there the producer warp copies the slice
//   with plain loads into the same swizzled layout and arrives on the same
//   barrier. The consumers issue one commit group of wgmma m64n64k16 a
//   slice (f32 accumulators in registers), release a slice's stage once
//   the next slice is issued and its own group has completed, and run the
//   epilogue on the finished chunk.
// * Two blocks an SM (__launch_bounds__(288, 2): F takes 72 registers, K1
//   96), so that one block's epilogue overlaps the other's products. K1's
//   running top twos live in shared memory for that. Measured slower on
//   the card (PERF.md, Findings): 128 queries a warpgroup (one block an
//   SM), a ring filling the shared memory, and the two warpgroups taking
//   the tensor cores in turn.
// * Grid: one block per (tile, query block), the query blocks of a tile
//   adjacent, so that a tile comes from device memory once and from L2 for
//   its other query blocks.
// * The accumulator layout: thread (warp w, lane l) of a warpgroup holds
//   rows 16w + l/4 and 16w + l/4 + 8 of the chunk, and queries
//   8j + 2(l % 4) + {0, 1}, j < 8: 32 scores.
//
// F's epilogue: a running max per query in registers (16 a thread), folded
// across the 16 threads that share a query (shuffles, then shared memory)
// at the tile's end.
//
// K1's epilogue (`_pack_tile_scores`): shift to max(s + 2, 0), rows at or
// after `size` to 0, the f32 bits with the low log2(tile) bits replaced by
// the tile-local row, the max over each strided unit {u, u + tile/G, ...},
// the top two unit winners, and the range flag. Where a unit spans whole
// chunks (tile/G >= 64), the chunks are walked with the group innermost:
// chunk g*(tile/G) + 64j for g < G, then j + 1, so a unit's rows fall on
// the same accumulator register across the G chunks and its winner is a
// register integer max; after the G chunks each thread folds its 32 unit
// winners into its own top two for each of its 16 queries (packed words
// are distinct by their row bits), and at the tile's end the 16 threads of
// a query merge their top twos (shuffles, then shared memory). No shared
// table of units and no atomics. Where tile/G < 64, a register keeps the
// max over the rows congruent to it modulo 64 for the whole tile, and a
// shared-memory fold at the end takes each unit's max over its 64/(tile/G)
// registers and the top two.
//
// The numerical argument (why the scan may keep the tensor cores' sums).
// Notation: u = 2^-24, S = sum_i |q_i c_i| <= |q| |c|.
// * Products: a bf16 x bf16 (or f16 x f16) product is exact in f32.
// * The tensor cores' accumulation is not IEEE round-to-nearest. The model
//   taken here is the one measured on NVIDIA's earlier tensor cores (Fasi,
//   Higham, Mikaitis and Pranesh, "Numerical behavior of NVIDIA tensor
//   cores", PeerJ CS 2021): a block of n_b >= 4 exact products and the
//   accumulator are aligned to the largest exponent among them, each term
//   truncated to the f32 significand, summed, and the sum normalised with
//   truncation. Each truncation loses less than one unit in the last place
//   of the largest term (<= 2u S), and the normalisation less than 2u S,
//   so a block costs at most (n_b + 1) 2u S, and one k16 step (16/n_b
//   blocks) at most 40u S.
// * Full accumulation (every k16 step onto the running accumulator), D16 =
//   D rounded up to 16 (the zero products past D add exactly 0):
//       delta_full(D) <= (D16 / 16) * 40u S = 2.5 D16 u S.
// * Split accumulation (each k16 step into fresh registers, then added to a
//   running f32 sum by IEEE round-to-nearest FADD):
//       delta_split(D) <= 40u S + (D16 / 16) u S.
// * The c1 rescore (`_exact_rowwise_scores`, an f32 matmul in some order,
//   IEEE round-to-nearest) drifts from the exact sum by at most D u S.
// * Soundness: a tile stays out of c2 (and a candidate out of c1, c3) only
//   when the word's upper bound, its value plus two quanta, is <= tau, the
//   k-th c1 score. Every row r the word stands for has a scan score below
//   its value plus one quantum, so c1(r) < ub - quantum + delta + drift:
//   sound while delta(D) + D u S <= one quantum. On (2, 4) (scores in
//   [0, 2)) the quantum is tile * 2^-22 = 4 tile u. With normalised queries
//   and rows rounded to bf16, S <= (1 + 2^-8)^2 < 1.01. So K1 takes
//   (tile, D) with full accumulation where
//       1.01 (2.5 D16 + D) <= 4 tile,
//   else with split accumulation where
//       1.01 (40 + D16 / 16 + D) <= 4 tile,
//   and refuses the rest. The rule lives in one place, the wrapper
//   (`scan_accumulation` in ops/topk_kernels.py), which raises where it
//   refuses and passes the mode in (`split`).
// * Full accumulation also stops at D16 = 640 (40 k16 steps), for F too.
//   Its truncation is one-signed, so on a sum near 1 it drifts by a share
//   of a unit in the last place every step: measured on the card, F at
//   D=2048 (f16) was 1.1e-5 from its twin on a row equal to its query,
//   0.7 ulp a step, past the 1e-5 within which the card tests and
//   chip_smoke.py hold F and K1's words. 40 steps keep it under 40 ulp of
//   1 (4.8e-6); split accumulation rounds to nearest, so its error does
//   not pile up one way. So tile 128 takes D <= 144 in full and D <= 438
//   split (refuses D=640); tile 256 full to D=288, split to D=915; tiles
//   1024 and 4096 full to D=640 (the served D=384 and the benchmark's
//   D=128: 1.01 * 448 u against a quantum of 16,384 u), then split, to
//   D=3778 at tile 1024 and D=15,229 at 4096. The c1 rescore's own D u S
//   takes the most of the quantum at large D: no order of the scan's sums
//   could take tile 1024 past D=4055.
// * The precondition S < 1.01 is the caller's: rows of norm at most
//   1 + 2^-8 (DenseIndex.add normalises them) and normalised queries. The
//   wrapper checks the queries on the card without a host sync: where their
//   largest norm exceeds what the bound admits at (tile, D) for such rows
//   (`scan_query_norm_limit`), it sets the range flag, and the certificate
//   reads -1 as for a score outside (-2, 2).
// * Below 2 (negative scores) the quanta halve with each binade, as they
//   do for the FMA kernels and for the reference's MXU pass: the argument
//   covers tau >= delta + drift (a word below 2 stands for rows scoring
//   below 0).
// * F has no certificate; it accumulates in full to D16 = 640, split past
//   that, and is held within 1e-5 of its twin.
// The measured counterpart of delta: the raw sums (`scan_sums`, this main
// loop in either accumulation with a store epilogue) against the exact sums
// on adversarial operands (mixed exponents, cancellation), held to delta
// with each pair's own S in tests/test_torch_kernels_cuda.py; F's largest
// difference from its twin (chip_smoke.py's `score_diff`); and K1's words
// held against the twin's under `packed_word_faults` (drift 1e-5).
// tests/test_torch_scan_drift.py runs the certified routes on the CPU with
// the scan moved by delta, and shows that a scan 1.5 quanta off certifies
// wrong answers on the same data.
#pragma once

#include <cuda.h>  // CUtensorMap (types only: the encoder is looked up)
#include <cudaTypedefs.h>
#include <string.h>

#include "topk_common.cuh"

namespace orag {
namespace scan {

constexpr int kM = 64;            // corpus rows a chunk (wgmma M)
constexpr int kSlice = 64;        // features a k-slice: 128 bytes of 16 bits
constexpr int kNQ = 64;           // queries a consumer warpgroup (wgmma N)
constexpr int kStages = 4;        // ring depth
constexpr int kStageBytes = kM * kSlice * 2;   // 8 KB
constexpr int kQSliceBytes = kNQ * kSlice * 2; // a warpgroup's queries, 8 KB
constexpr int kAcc = kM * kNQ / 128;           // accumulators a thread: 32
constexpr int kQT = kNQ / 4;      // queries a thread: 16

// F's max, K1's pack, and the raw sums (out f32 [N, B]) by which the card
// tests measure the accumulation against the exact sums.
enum Epilogue { kFloor = 0, kPack = 1, kRaw = 2 };

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

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_acc(float (&d)[kAcc]) {
#pragma unroll
  for (int i = 0; i < kAcc; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ORAG_WGMMA_D32                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define ORAG_WGMMA_OUT(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (+)= A B^T for A [64 rows x 16] and B [64 queries x 16], both K-major
// in shared memory; `accumulate` 0 overwrites d.
template <typename T>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[kAcc], uint64_t a,
                                               uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_64x64x16<__nv_bfloat16>(
    float (&d)[kAcc], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ORAG_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ORAG_WGMMA_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
template <>
__device__ __forceinline__ void wgmma_64x64x16<__half>(float (&d)[kAcc],
                                                       uint64_t a, uint64_t b,
                                                       int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " ORAG_WGMMA_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ORAG_WGMMA_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// Byte offset of 16-bit value (row r, feature k < 64) in a 128-byte-swizzled
// block whose base is 1024-byte aligned.
__device__ __forceinline__ int sw128_offset(int r, int k) {
  return r * 128 + ((((k >> 3) ^ r) & 7) << 4) + (k & 7) * 2;
}

// ------------------------------------------------------------ the kernel

struct Params {
  const float* qT;        // [D, B] queries, already rounded to T
  const uint16_t* qh;     // [B, D] the same queries as raw 16-bit values
  const uint16_t* c;      // [N, D] rows (raw 16-bit values)
  const int* size_ptr;    // live rows
  void* out;              // F: f32 [T, 1, B]; K1: int32 [T, 2, B]; raw [N, B]
  int* flag;              // K1: range flag
  int B, N, D, tile, groups, nwg, use_tma, stream_q;
};

// Dynamic shared memory: the ring, the queries, the barriers, the fold.
// With resident queries a stage holds one k-slice of 64 rows; with streamed
// queries (`stream_q`) it holds the query block's same k-slice behind it.
// K1 keeps each thread's running top twos ([2][16] ints a thread, touched
// once every G chunks) in shared memory rather than registers, so that two
// blocks fit an SM.
struct Layout {
  int stage, ring, queries, bars, fold, top, total;
  __host__ __device__ Layout(int D, int nwg, bool pack, bool stream_q) {
    const int slices = (D + kSlice - 1) / kSlice;
    stage = kStageBytes + (stream_q ? nwg * kQSliceBytes : 0);
    ring = 0;
    queries = kStages * stage;
    bars = queries + (stream_q ? 0 : slices * nwg * kQSliceBytes);
    fold = bars + 2 * kStages * 8;
    // Top twos [4 warps][64][2] ints a warpgroup (F uses half). The
    // tile/G < 64 fold reuses the ring (2 x 16 KB <= 32 KB).
    top = fold + nwg * 4 * kNQ * 2 * 4;
    total = top + (pack ? nwg * 128 * 2 * kQT * 4 : 0);
  }
};
static_assert(kStages * kStageBytes >= 2 * kM * kNQ * 4,
              "the ring must hold the small-unit fold of two warpgroups");

// The tile-local first row of chunk c. K1 with units of whole chunks walks
// the chunks group-innermost (see the header); otherwise in order.
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

template <typename T, int Epi, bool Split>
__global__ void __launch_bounds__(2 * 128 + 32, 2)
    scan_mma_kernel(const __grid_constant__ CUtensorMap map,
                    const __grid_constant__ CUtensorMap qmap, const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const Layout L(p.D, p.nwg, Epi == kPack, p.stream_q);
  const int slices = (p.D + kSlice - 1) / kSlice;
  const int nqb = (p.B + kNQ * p.nwg - 1) / (kNQ * p.nwg);
  const int t = blockIdx.x / nqb;
  const int qbase = (blockIdx.x % nqb) * kNQ * p.nwg;
  const long long base = (long long)t * p.tile;
  const int tid = threadIdx.x;
  const int consumers = 128 * p.nwg;
  const uint32_t ring = smem_addr(smem + L.ring);
  const uint32_t full = smem_addr(smem + L.bars);
  const uint32_t empty = full + kStages * 8;
  const int chunks = p.tile / kM;
  const int small = p.tile / p.groups;
  const bool strided = Epi == kPack && small >= kM;

  // Stage the resident queries: slice s, warpgroup w, query n, feature k.
  if (!p.stream_q) {
    const int nq = kNQ * p.nwg;
    const int total = slices * kSlice * nq;
    for (int idx = tid; idx < total; idx += blockDim.x) {
      const int n = idx % nq, k = idx / nq;
      const int b = qbase + n;
      uint16_t v = 0;
      if (k < p.D && b < p.B) v = half_bits<T>(p.qT[(long long)k * p.B + b]);
      unsigned char* blk = smem + L.queries +
                           ((k / kSlice) * p.nwg + n / kNQ) * kQSliceBytes;
      *reinterpret_cast<uint16_t*>(blk + sw128_offset(n % kNQ, k % kSlice)) =
          v;
    }
  }
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
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
            tma_load_2d(dst, &map, s * kSlice, (int)row, full + 8 * stage);
            if (p.stream_q)  // the block's queries, 64 x nwg rows of qh
              tma_load_2d(dst + kStageBytes, &qmap, s * kSlice, qbase,
                          full + 8 * stage);
          }
        } else {
          unsigned char* st = smem + L.ring + stage * L.stage;
          for (int idx = lane; idx < kM * kSlice; idx += 32) {
            const int r = idx / kSlice, k = idx % kSlice, f = s * kSlice + k;
            const uint16_t v = f < p.D ? p.c[(row + r) * p.D + f] : 0;
            *reinterpret_cast<uint16_t*>(st + sw128_offset(r, k)) = v;
          }
          if (p.stream_q) {
            for (int idx = lane; idx < kNQ * p.nwg * kSlice; idx += 32) {
              const int n = idx / kSlice, k = idx % kSlice;
              const int f = s * kSlice + k, b = qbase + n;
              const uint16_t v =
                  f < p.D && b < p.B ? p.qh[(long long)b * p.D + f] : 0;
              *reinterpret_cast<uint16_t*>(st + kStageBytes +
                                           sw128_offset(n, k)) = v;
            }
          }
          fence_proxy_async();
          __syncwarp();
          if (lane == 0) mbar_arrive(full + 8 * stage);
        }
        if (++stage == kStages) {
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
  const uint32_t qs = smem_addr(smem + L.queries) + wg * kQSliceBytes;
  const int qstride = p.nwg * kQSliceBytes;
  const int r0 = 16 * warp + lane / 4;  // this thread's rows: r0, r0 + 8
  float acc[kAcc];
  // F: running max per query. K1: unit maxima (int bits) and top twos.
  float fm[kQT];
  int um[kAcc];
  // This thread's top twos: top[j * 128], j < 2 * kQT (t1 of query q at
  // j = q, t2 at j = kQT + q).
  int* top = reinterpret_cast<int*>(smem + L.top) + wg * 2 * kQT * 128 + wt;
#pragma unroll
  for (int i = 0; i < kQT; ++i) fm[i] = -INFINITY;
  if constexpr (Epi == kPack) {
#pragma unroll
    for (int j = 0; j < 2 * kQT; ++j) top[j * 128] = 0;
  }
#pragma unroll
  for (int i = 0; i < kAcc; ++i) um[i] = 0;
  bool bad = false;
  int stage = 0;
  uint32_t phase = 0;
  const auto advance = [&]() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };
  const auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  };
  // K1: rows at or after `lim` (tile-local) are padding.
  const int lim =
      (int)max(0LL, min((long long)p.tile, (long long)size - base));
  const int mask = ~(p.tile - 1);

  for (int c = 0; c < chunks; ++c) {
    const int row0 = chunk_row(c, small, p.groups, strided);
    if constexpr (Split) {
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * L.stage;
        const uint32_t b = p.stream_q ? a + kStageBytes + wg * kQSliceBytes
                                      : qs + s * qstride;
        const int ks = min(kSlice, p.D - s * kSlice + 15) / 16;  // k16 steps
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk) {
          if (kk >= ks) break;
          float part[kAcc];
          wgmma_fence();
          wgmma_64x64x16<T>(part, sw128_desc(a + 32 * kk),
                            sw128_desc(b + 32 * kk), 0);
          wgmma_commit();
          wgmma_wait<0>();
          fence_acc(part);
#pragma unroll
          for (int i = 0; i < kAcc; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
        }
        release(stage);
        advance();
      }
    } else {
      // One commit group a slice; a slice's stage is released once the
      // next slice's products are issued and its own have completed. Every
      // slice runs all four k16 steps, unguarded: features past D are zero
      // in both operands, so their products add exactly 0, and a wgmma
      // behind a branch is serialised by ptxas (C7520).
      fence_acc(acc);
      int prev = 0;
      for (int s = 0; s < slices; ++s) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * L.stage;
        const uint32_t b = p.stream_q ? a + kStageBytes + wg * kQSliceBytes
                                      : qs + s * qstride;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSlice / 16; ++kk)
          wgmma_64x64x16<T>(acc, sw128_desc(a + 32 * kk),
                            sw128_desc(b + 32 * kk), s > 0 || kk > 0);
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          release(prev);
        }
        prev = stage;
        advance();
      }
      wgmma_wait<0>();
      fence_acc(acc);
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
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int col = row0 + r0 + 8 * ((i / 2) % 2);
        const float v = acc[i];
        const bool live = col < lim;
        bad |= live && fabsf(v) >= 2.0f;
        const int bits = __float_as_int(fmaxf(v + 2.0f, 0.0f)) & mask;
        um[i] = max(um[i], (live ? bits : 0) | col);
      }
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
  int* red = reinterpret_cast<int*>(smem + L.fold) + wg * 4 * kNQ * 2;
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
    if (bad) *p.flag = 1;
    int* out = static_cast<int*>(p.out);
    if (!strided) {
      // tile/G < 64: register i holds the max over rows = its row mod 64;
      // unit u gathers the registers of rows u, u + small, ... < 64.
      named_sync(15, consumers);  // every warpgroup's wgmma left the ring
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

// The dynamic shared memory of a launch (+ alignment to 1024 bytes).
inline size_t smem_bytes(int D, int nwg, bool pack, bool stream_q) {
  return (size_t)Layout(D, nwg, pack, stream_q).total + 1024;
}

// A 2-D tensor map of 16-bit values [rows, D] in boxes of 64 features x
// `box_rows`, 128-byte swizzle (out-of-range values arrive as zeros).
template <typename T>
bool encode_map(CUtensorMap* map, const void* base, int rows, int D,
                int box_rows) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {kSlice, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map,
                std::is_same<T, __half>::value
                    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int Epi, bool Split>
int launch_as(const Params& p, const CUtensorMap& map,
              const CUtensorMap& qmap, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      scan_mma_kernel<T, Epi, Split>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long nqb = (p.B + kNQ * p.nwg - 1) / (kNQ * p.nwg);
  const long long blocks = (long long)(p.N / p.tile) * nqb;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_mma_kernel<T, Epi, Split>
      <<<(unsigned)blocks, 128 * p.nwg + 32, smem, stream>>>(map, qmap, p);
  return (int)cudaGetLastError();
}

// F (Epi kFloor, out f32 [T, 1, B]), K1 (kPack, out int32 [T, 2, B]) or the
// raw sums (kRaw, out f32 [N, B]) over 16-bit rows; `split` 1 takes split
// accumulation (the caller decides, see the header).
// qT: [D, B] f32 queries already rounded to T; qh: the same [B, D] as T.
// Returns a cudaError_t code.
template <typename T, int Epi>
int launch(const float* qT, const void* qh, const void* corpus,
           const int* size, void* out, int* flag, int B, int N, int D,
           int tile, int groups, int split, cudaStream_t stream) {
  if (split < 0 || split > 1 || tile % kM || B < 1 || D < 1 || N < tile ||
      N % tile)
    return (int)cudaErrorInvalidValue;
  // Two warpgroups (128 queries a block) where B > 64, both reading each
  // slice at once; the queries resident where they fit, else streamed
  // through the ring beside the rows.
  const bool pack = Epi == kPack;
  int nwg = B > kNQ ? 2 : 1;
  bool stream_q = false;
  if (smem_bytes(D, nwg, pack, false) > (size_t)kMaxSmem) nwg = 1;
  if (smem_bytes(D, nwg, pack, false) > (size_t)kMaxSmem) {
    stream_q = true;
    nwg = B > kNQ ? 2 : 1;
  }
  const size_t smem = smem_bytes(D, nwg, pack, stream_q);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  Params p{qT, static_cast<const uint16_t*>(qh),
           static_cast<const uint16_t*>(corpus), size, out, flag, B, N, D,
           tile, groups, nwg, 0, stream_q};
  CUtensorMap map, qmap;
  memset(&map, 0, sizeof(map));
  memset(&qmap, 0, sizeof(qmap));
  const auto aligned = [](const void* ptr) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  if (D % 8 == 0 && aligned(corpus) && (!stream_q || aligned(qh))) {
    if (!encode_map<T>(&map, corpus, N, D, kM)) return (int)cudaErrorNotSupported;
    if (stream_q && !encode_map<T>(&qmap, qh, B, D, kNQ * nwg))
      return (int)cudaErrorNotSupported;
    p.use_tma = 1;
  }
  if (split) return launch_as<T, Epi, true>(p, map, qmap, smem, stream);
  return launch_as<T, Epi, false>(p, map, qmap, smem, stream);
}

}  // namespace scan
}  // namespace orag
