// Chained enc2 + enc3 of the SEGAN+ generator encoder in bf16 on Hopper's warpgroup MMA
// (sm_90a).
//
// Replaces, on the bf16 route, the TPU kernel `fused_enc23_fwd` of
// segan_pytorch_tpu/ops/pallas/encoder_fused.py:112 (`_kernel` :81, `_fold_weights` :47),
// beside csrc/encoder_fused.cu, which computes the same function:
//     pre2 = conv(reflect_pad(h1), w2) + b2      post2 = PReLU(pre2, a2)
//     pre3 = conv(reflect_pad(post2), w3) + b3   post3 = PReLU(pre3, a3)
// reflect pad (14, 15), stride 4, 31 taps padded to 32 (tap 31 zero); h1 (B, C1, T1)
// unpadded and contiguous, T1 % 16 == 0, T1 >= 64; C2 = 128, C3 = 256 (SEGAN+'s widths);
// bf16 in and out, fp32 sums, post2 rounded to bf16 before enc3 reads it, as the TPU
// kernel and `enc23_plain` round it. The wrapper (ops/kernels/encoder_fused.py, `_route`)
// sends a bf16 call here by shape and batch.
//
// What bounds it on the H100. 312 GFLOP at batch 300 against ~0.3 GB of activations:
// the tensor cores (989 TFLOP/s, 0.316 ms). enc23_mma_kernel (mma.sync) ran at 14 % of
// that: one synchronous mainloop, h1 staged single-buffered, every warp's weights read
// from L2 for every input channel. This kernel is the per-layer wgmma kernel's shape
// (conv1d_wgmma.cu) carried over to the chain:
//   - A block is two consumer warpgroups and one producer warp whose one thread keeps a
//     ring of STAGES shared-memory stages full by TMA (csrc/tma_ring.cuh: mbarrier pairs
//     with a trapping wait, cp.async.bulk.tensor); 288 threads, one block per SM. It owns
//     TILE = 64 enc3 rows of one batch row (phase B's m64 tile); the grid is B x
//     ceil(T3 / 64), the ragged last tile masked.
//   - Phase A (enc2) computes post2 on the SLOTS = 4 TILE + 28 = 284 padded rows that the
//     tile's enc3 windows read (slot p: padded post2 row 4 t0 + p, real row 4 t0 - 14 +
//     p), as 5 m64 tiles x n128 in three passes, one m64 tile a warpgroup: tiles 0-1, 2-3,
//     then tile 4, each warpgroup n64 of it. (Two passes of two tiles a warpgroup held 128
//     sums and A in 168 registers: ptxas spilled and serialised the MMAs, C7512, and the
//     kernel ran slower at every batch.) Each pass streams w2 and h1
//     through the ring, CC = 2 input channels a stage: w2 in `_wgmma_weights`' permuted
//     tap order (ops/kernels/conv1d_prelu.py) by one TMA box {64, 128} with the 128-byte
//     swizzle, read by descriptor; h1 by one box {96, CC, 1} per m16 group of rows
//     straight from its unpadded rows. Group q's window starts at sample 16 t0 - 70 +
//     64 q, 2 samples past a 16-byte boundary, where TMA must start a box: the box starts
//     XOFF = 2 samples earlier, and A is read from its window with two 4-byte loads a
//     fragment pair. TMA fills samples outside [0, T1) with zeros; boxes wholly past T1
//     are not loaded. A is built in registers with the per-layer kernel's maps, so the MMAs
//     of phase A are the per-layer wgmma kernel's, in its order (a stage's A, then its
//     MMAs as one commit group, waited for before the stage is released).
//     The reflect at T1 is written into the landed windows by the warps that read them,
//     in a row's first and last tile only: the mirror sources lie inside the same box.
//     pre2 is stored only for the 4 TILE rows the tile owns (one writer a row).
//   - post2 stays in shared memory in the TPU kernel's folded (space-to-depth) layout:
//     folded row u holds slots 4u .. 4u + 3 over all C2 channels, at depth index
//     s C2 + c. Depth is cut into chunks of 8 channels (16 bytes); within a chunk the
//     FROWS = TILE + 7 folded rows lie 16 bytes apart: the no-swizzle K-major layout of a
//     wgmma descriptor (core matrices of 8 rows x 16 bytes, SBO 128, LBO = FROWS x 16).
//     Folded tap q (0..7) of enc3 row m reads folded row m + q, so its A operand is the
//     same tile with the descriptor's start moved by q x 16 bytes: no im2col and no A in
//     registers. The slots no real row maps to are filled as enc23_mma_kernel fills them:
//     mirrored rows at either end (reflect at T2), else zero.
//   - Phase B (enc3): A (post2) and B (w3 folded, K-major: w3f[co, 512 q + 128 s + c] =
//     w3[co, c, 4q + s], the TPU kernel's `_fold_weights` transposed, made once per
//     weight and version by the wrapper) both by descriptor; w3f streams through the ring
//     by TMA, one box {64, 256} (32 KB) a stage, 64 stages; each warpgroup n128 of C3.
//     A stage's MMAs are committed as a group and released once the next stage's are
//     issued (no register operand to wait for).
//   - Epilogues: bias and PReLU in registers; post2 into the folded tile, pre2 from
//     registers; pre3 and post3 through shared memory, 16 bytes a lane when T3 % 8 == 0.
// What bounds it next (PERF.md): a block's own pipeline, not L2. One wave of blocks (up to
// 33 chunks) takes the same time whatever their number, and 300 chunks take about ten
// waves of it: the tensor cores reach some 40 % of their peak inside a block.
// Shared memory: the ring (4 x 32 KB) and post2 (64 chunks x 1136 B = 71 KB).
// tests/test_torch_encoder_fused_wgmma.py emulates these maps in float64 and reads the
// constants below.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "tma_ring.cuh"

namespace {

using mma_conv::KP;  // taps, padded by the wrapper
using mma_conv::prelu;
using namespace tma_ring;

constexpr int STRIDE = 4;
constexpr int PAD_L = 14;                      // the reflect pad (14, 15)
constexpr int PAD_R = 15;
constexpr int C2 = 128;                        // enc2's channels: phase A's N
constexpr int C3 = 256;                        // enc3's: phase B's N, n128 a warpgroup
constexpr int TILE = 64;                       // enc3 rows per block
constexpr int SLOTS = 284;                     // padded post2 rows one tile reads
constexpr int FROWS = 71;                      // folded post2 rows: slots / 4
constexpr int LBO = FROWS * 16;                // bytes between 8-channel chunks of post2
constexpr int CHUNKS = STRIDE * C2 / 8;        // chunks of a folded row (64)
constexpr int POST2_BYTES = CHUNKS * LBO;
constexpr int A_GROUPS = 20;                   // phase A's m16 groups: 5 m64 tiles
constexpr int CC = 2;                          // phase A: h1 channels per ring stage
constexpr int WIN = 96;                        // h1 samples per m16 group and channel
constexpr int XOFF = 2;                        // where a group's window starts in its box
constexpr int W_BOX = 64;                      // weight columns per box: 128 bytes
constexpr int W2_BYTES = W_BOX * 2 * C2;       // a phase A stage's w2: 16 KB
constexpr int W3_BYTES = W_BOX * 2 * C3;       // a phase B stage's w3f: 32 KB
constexpr int STAGES = 4;                      // ring stages
constexpr int STAGE_BYTES = W3_BYTES;
constexpr int B_ITERS = KP * C2 / W_BOX;       // phase B's stages (depth 4096)
constexpr int CONSUMERS = 2;                   // warpgroups that issue MMAs
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int OUT_LD = 16 + 8;                 // a channel's 16 rows in the epilogue tile
constexpr int A_PASSES = 3;                    // tiles 0-1, 2-3, then 4 split over N
constexpr int A_BOXES = 8;                     // h1 boxes per stage: 4 groups a warpgroup
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + POST2_BYTES + 2 * STAGES * 8;

using Boxes = XBoxes<STRIDE, CC, WIN, WIN / 2, 2>;  // one box {96, CC, 1}: 384 bytes
static_assert(SLOTS == STRIDE * TILE + KP - STRIDE && FROWS * STRIDE == SLOTS, "slots");
static_assert(A_GROUPS * 16 >= SLOTS && A_GROUPS * 16 - 64 < SLOTS, "whole m64 tiles");
static_assert(CC * KP == W_BOX, "a stage's w2 is one box");
// TMA starts a box on a 16-byte boundary; a window starts at 16 t0 - 70 + 64 q
static_assert((STRIDE * PAD_L + PAD_L + XOFF) % 8 == 0 && XOFF + 92 <= WIN, "boxes");
static_assert(W2_BYTES + A_BOXES * Boxes::BYTES <= STAGE_BYTES, "phase A stage");
static_assert(8 * C2 * OUT_LD * 2 <= STAGES * STAGE_BYTES, "epilogue tiles in the ring");
static_assert(SMEM <= 232448, "one block per SM");

// A wgmma descriptor of a K-major tile without swizzle: core matrices of 8 rows x 16
// bytes, rows 16 bytes apart, 8-row groups `sbo` bytes apart, the two 8-element chunks of
// a 16-deep step `lbo` bytes apart; `addr` may move by any multiple of 16 bytes.
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, fp32) += a (64 x 16, bf16, registers: each warp 16 rows in mma.sync's
// m16n8k16 A layout) * B (16 x 128, bf16, K-major in shared memory, `desc`).
__device__ __forceinline__ void wgmma_n128_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64) += a (registers, as above) * B (16 x 64, by `desc`).
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 128) += A (64 x 16, by `desc_a`) * B (16 x 128, by `desc_b`), both K-major in
// shared memory.
__device__ __forceinline__ void wgmma_n128_ss(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Four adjacent bf16 samples from p, 4-byte aligned (a window starts XOFF samples into
// its box), as two fragment registers: two 4-byte loads.
__device__ __forceinline__ uint2 load4(const __nv_bfloat16* p) {
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
  return make_uint2(q[0], q[1]);
}

// Where folded slot p, channel c of post2 lies, in bytes from the tile's start.
__device__ __forceinline__ int post2_offset(int p, int c) {
  return ((p % STRIDE) * (C2 / 8) + c / 8) * LBO + (p / STRIDE) * 16 + (c % 8) * 2;
}

// The group of rows whose window ring box j (warp j % 4 of warpgroup j / 4) holds in
// phase A's pass: passes 0 and 1 group 8 pass + j (m64 tile 2 pass + j / 4), pass 2 group
// 16 + j % 4 (m64 tile 4, a copy for each warpgroup).
__device__ __forceinline__ int box_group(int pass, int j) {
  return pass < 2 ? 8 * pass + j : 16 + j % 4;
}

// The reflect at either end of h1, written into a landed box whose first sample is
// `start`: samples -14..-1 take 14..1, samples T1..T1 + 14 take T1 - 2..T1 - 16, where the
// source lies in the same box (it does for every row that is stored); one warp.
__device__ __forceinline__ void reflect_window(__nv_bfloat16* win, int start, int T1,
                                               int lane) {
#pragma unroll
  for (int c = 0; c < CC; ++c)
    for (int i = lane; i < WIN; i += 32) {
      const int s = start + i;
      int src;
      if (s >= -PAD_L && s < 0)
        src = -s;
      else if (s >= T1 && s < T1 + PAD_R)
        src = 2 * T1 - 2 - s;
      else
        continue;
      if (src - start >= 0 && src - start < WIN) win[c * WIN + i] = win[c * WIN + src - start];
    }
}

// h1_map: h1 (B, C1, T1), boxes {WIN, CC, 1}; w2_map: w2 permuted (C2, C1 * 32), boxes
// {W_BOX, C2}; w3_map: w3 folded (C3, 4096), boxes {W_BOX, C3}; both 128-byte swizzle.
__global__ void __launch_bounds__(THREADS, 1)
enc23_wgmma_kernel(const __grid_constant__ CUtensorMap h1_map,
                   const __grid_constant__ CUtensorMap w2_map,
                   const __grid_constant__ CUtensorMap w3_map,
                   const __nv_bfloat16* __restrict__ b2, const __nv_bfloat16* __restrict__ a2,
                   const __nv_bfloat16* __restrict__ b3, const __nv_bfloat16* __restrict__ a3,
                   __nv_bfloat16* __restrict__ pre2, __nv_bfloat16* __restrict__ pre3,
                   __nv_bfloat16* __restrict__ post3, int C1, int T1, int tiles) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t post2 = ring + STAGES * STAGE_BYTES;
  uint8_t* const post2_ptr = ring_ptr + STAGES * STAGE_BYTES;
  const uint32_t full = post2 + POST2_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + STAGES * 8;   // empty[s] at empty + 8 s

  const int T2 = T1 / STRIDE;
  const int T3 = T2 / STRIDE;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TILE;
  const int t_end = min(t0 + TILE, T3);
  const int p0 = STRIDE * t0 - PAD_L;  // the real post2 row of slot 0, before reflection
  const int lo = max(0, p0);           // real rows that land in slots [0, SLOTS)
  const int hi = min(T2 - 1, p0 + SLOTS - 1);
  // the h1 sample where group 0's box starts, XOFF before its window
  const int x0 = STRIDE * p0 - PAD_L - XOFF;
  // a box of this tile holds samples outside [0, T1): a row's first or last tile
  const bool edge = x0 < 0 || x0 + STRIDE * 16 * (A_GROUPS - 1) + WIN > T1;
  const int a_iters = (C1 + CC - 1) / CC;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);               // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == CONSUMERS * 128) {
      int k = 0;
      for (int pass = 0; pass < A_PASSES; ++pass) {
        uint32_t bytes = W2_BYTES;
        for (int j = 0; j < A_BOXES; ++j)
          bytes += x0 + STRIDE * 16 * box_group(pass, j) < T1 ? Boxes::BYTES : 0;
        for (int it = 0; it < a_iters; ++it, ++k) {
          const int s = k % STAGES;
          mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, bytes);
          const uint32_t st = ring + s * STAGE_BYTES;
          tma_load_2d(st, &w2_map, it * CC * KP, 0, full + 8 * s);
          for (int j = 0; j < A_BOXES; ++j) {
            const int start = x0 + STRIDE * 16 * box_group(pass, j);
            if (start < T1)  // a window wholly past T1 is read by no stored row
              tma_load_3d(st + W2_BYTES + j * Boxes::BYTES, &h1_map, start, it * CC, b,
                          full + 8 * s);
          }
        }
      }
      for (int it = 0; it < B_ITERS; ++it, ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, W3_BYTES);
        tma_load_2d(ring + s * STAGE_BYTES, &w3_map, it * W_BOX, 0, full + 8 * s);
      }
    }
    return;
  }

  // the consumer warpgroups
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  int k = 0;  // ring stages consumed, in the producer's order

  // Phase A, passes 0 and 1: m64 tile 2 pass + wg, n128, one a warpgroup (64 sums and a
  // stage's A fragments a thread). Warp w supplies rows 16 w .. 16 w + 15: m16 group
  // 8 pass + 4 wg + w, ring box 4 wg + w.
  for (int pass = 0; pass < 2; ++pass) {
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    const int q = 8 * pass + 4 * wg + warp;
    for (int it = 0; it < a_iters; ++it, ++k) {
      const int s = k % STAGES;
      mbar_wait(full + 8 * s, (k / STAGES) & 1);
      uint8_t* const xs = ring_ptr + s * STAGE_BYTES + W2_BYTES + (4 * wg + warp) * Boxes::BYTES;
      const uint32_t ws = ring + s * STAGE_BYTES;
      if (edge) {
        reflect_window(reinterpret_cast<__nv_bfloat16*>(xs), x0 + STRIDE * 16 * q, T1, lane);
        fence_async_smem();  // the stage is refilled by TMA after these writes
        __syncwarp();
      }
      uint32_t af[CC][2][4];
#pragma unroll
      for (int c = 0; c < CC; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // row g at step h: samples 4 g + 8 t + 4 h + 0..3 of its window; row g + 8 32
          // samples on
          const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(xs) + c * WIN +
                                   XOFF + STRIDE * g + 8 * t + 4 * h;
          const uint2 r0 = load4(p);
          const uint2 r8 = load4(p + Boxes::ROW8);
          af[c][h][0] = r0.x;
          af[c][h][1] = r8.x;
          af[c][h][2] = r0.y;
          af[c][h][3] = r8.y;
        }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CC; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)  // channel c's taps, step h
          wgmma_n128_rs(acc, af[c][h], desc_sw128(ws + 64 * c + 32 * h));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // lane (g, t) of warp w holds rows 16 w + g (+ 8 for e >= 2) and channels
    // 8 j + 2 t + (e & 1) in acc[4 j + e]
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int eh = 0; eh < 2; ++eh) {
        const int p = 16 * q + g + 8 * eh;
        const int c = 8 * j + 2 * t;
        const float v0 = acc[4 * j + 2 * eh] + (b2 != nullptr ? __bfloat162float(b2[c]) : 0.f);
        const float v1 =
            acc[4 * j + 2 * eh + 1] + (b2 != nullptr ? __bfloat162float(b2[c + 1]) : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(post2_ptr + post2_offset(p, c)) =
            __floats2bfloat162_rn(prelu(v0, __bfloat162float(a2[c])),
                                  prelu(v1, __bfloat162float(a2[c + 1])));
        const int r = p0 + p;
        if (r >= STRIDE * t0 && r < STRIDE * t_end) {
          pre2[((long long)b * C2 + c) * T2 + r] = __float2bfloat16(v0);
          pre2[((long long)b * C2 + c + 1) * T2 + r] = __float2bfloat16(v1);
        }
      }
  }

  // Phase A, pass 2: m64 tile 4 (groups 16-19), warpgroup wg takes channels 64 wg ..
  // 64 wg + 63; warp w reads group 16 + w from its own copy, ring box 4 wg + w.
  {
    float acc[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.f;
    const int q = 16 + warp;
    const int box = 4 * wg + warp;
    for (int it = 0; it < a_iters; ++it, ++k) {
      const int s = k % STAGES;
      mbar_wait(full + 8 * s, (k / STAGES) & 1);
      uint8_t* const xs = ring_ptr + s * STAGE_BYTES + W2_BYTES + box * Boxes::BYTES;
      const uint32_t ws = ring + s * STAGE_BYTES + wg * 64 * 128;  // rows 64 wg.. of w2
      if (edge) {
        reflect_window(reinterpret_cast<__nv_bfloat16*>(xs), x0 + STRIDE * 16 * q, T1,
                       lane);
        fence_async_smem();
        __syncwarp();
      }
      uint32_t af[CC][2][4];
#pragma unroll
      for (int c = 0; c < CC; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(xs) + c * WIN +
                                   XOFF + STRIDE * g + 8 * t + 4 * h;
          const uint2 r0 = load4(p);
          const uint2 r8 = load4(p + Boxes::ROW8);
          af[c][h][0] = r0.x;
          af[c][h][1] = r8.x;
          af[c][h][2] = r0.y;
          af[c][h][3] = r8.y;
        }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < CC; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          wgmma_n64_rs(acc, af[c][h], desc_sw128(ws + 64 * c + 32 * h));
        }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int eh = 0; eh < 2; ++eh) {
        const int p = 16 * q + g + 8 * eh;
        const int c = 64 * wg + 8 * j + 2 * t;
        if (p >= SLOTS) continue;  // rows of the last m64 tile that no enc3 row reads
        const float v0 = acc[4 * j + 2 * eh] + (b2 != nullptr ? __bfloat162float(b2[c]) : 0.f);
        const float v1 =
            acc[4 * j + 2 * eh + 1] + (b2 != nullptr ? __bfloat162float(b2[c + 1]) : 0.f);
        *reinterpret_cast<__nv_bfloat162*>(post2_ptr + post2_offset(p, c)) =
            __floats2bfloat162_rn(prelu(v0, __bfloat162float(a2[c])),
                                  prelu(v1, __bfloat162float(a2[c + 1])));
        const int r = p0 + p;
        if (r >= STRIDE * t0 && r < STRIDE * t_end) {
          pre2[((long long)b * C2 + c) * T2 + r] = __float2bfloat16(v0);
          pre2[((long long)b * C2 + c + 1) * T2 + r] = __float2bfloat16(v1);
        }
      }
  }

  consumers_sync();  // every slot written
  if (lo > p0 || hi < p0 + SLOTS - 1) {
    // the slots of no real row: mirrored rows at either end (reflect at T2), else zero;
    // 16 bytes (8 channels) a unit
    for (int u = threadIdx.x; u < SLOTS * (C2 / 8); u += CONSUMERS * 128) {
      const int p = u / (C2 / 8);
      const int c = 8 * (u % (C2 / 8));
      const int r = p0 + p;
      if (r >= lo && r <= hi) continue;
      const int src = r < 0 ? -r : 2 * T2 - 2 - r;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src >= lo && src <= hi)
        v = *reinterpret_cast<const uint4*>(post2_ptr + post2_offset(src - p0, c));
      *reinterpret_cast<uint4*>(post2_ptr + post2_offset(p, c)) = v;
    }
  }
  fence_async_smem();  // post2's generic writes before the MMAs read it
  consumers_sync();

  // Phase B: enc3 rows t0 .. t0 + 63, channels 128 wg .. 128 wg + 127. Stage `it` holds
  // depth 64 it .. 64 it + 63 of w3f: folded tap q = it / 8, chunks 8 (it % 8) .. + 7.
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  for (int it = 0; it < B_ITERS; ++it, ++k) {
    const int s = k % STAGES;
    mbar_wait(full + 8 * s, (k / STAGES) & 1);
    const int q = it / (B_ITERS / (KP / STRIDE));
    const int chunk = (it % (B_ITERS / (KP / STRIDE))) * (W_BOX / 8);
    const uint32_t ws = ring + s * STAGE_BYTES + wg * 128 * 128;  // rows 128 wg.. of w3f
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < W_BOX / 16; ++kk) {
      wgmma_n128_ss(acc, desc_plain(post2 + (chunk + 2 * kk) * LBO + 16 * q, LBO, 128),
                    desc_sw128(ws + 32 * kk));
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's MMAs are done: release it
    fence_regs(acc);
    __syncwarp();
    if (it > 0 && lane == 0) mbar_arrive(empty + 8 * ((k - 1) % STAGES));
  }
  wgmma_wait_all();
  fence_regs(acc);

  // pre3 and post3 through shared memory: once both consumers are done with the ring,
  // each warp puts its 16 rows x 128 channels there, then writes them out
  consumers_sync();
  __nv_bfloat16* const tile =
      reinterpret_cast<__nv_bfloat16*>(ring_ptr) + (threadIdx.x / 32) * 128 * OUT_LD;
  const int n0 = 128 * wg;
  const int tw = t0 + 16 * warp;  // the warp's first row
  const bool vec = T3 % 8 == 0;   // rows of 8 steps are 16 aligned bytes
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // pre3, then post3
    __nv_bfloat16* const out = pass == 0 ? pre3 : post3;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);
        const float p = acc[4 * j + e] + (b3 != nullptr ? __bfloat162float(b3[n0 + cl]) : 0.f);
        tile[cl * OUT_LD + g + 8 * (e >> 1)] =
            __float2bfloat16(pass == 0 ? p : prelu(p, __bfloat162float(a3[n0 + cl])));
      }
    __syncwarp();
    if (vec) {  // 128 channels x 2 halves of 8 rows: lane l of step u takes unit 32 u + l
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int unit = 32 * u + lane;
        const int cl = unit >> 1;
        const int half = unit & 1;
        if (tw + 8 * half < t_end)
          *reinterpret_cast<uint4*>(out + ((long long)b * C3 + n0 + cl) * T3 + tw +
                                    8 * half) =
              *reinterpret_cast<const uint4*>(tile + cl * OUT_LD + 8 * half);
      }
    } else {  // 16 rows of a channel a half warp
      for (int u = 0; u < 64; ++u) {
        const int unit = 32 * u + lane;
        const int cl = unit >> 4;
        const int row = unit & 15;
        if (tw + row < t_end)
          out[((long long)b * C3 + n0 + cl) * T3 + tw + row] = tile[cl * OUT_LD + row];
      }
    }
    __syncwarp();  // the tile is read before the next pass writes it
  }
}

}  // namespace

// The chained kernel's bf16 wgmma route: h1 (B, C1, T1) contiguous and 16-byte aligned;
// w2 (C2 = 128, C1, 32) padded with its taps permuted for the MMA fragments (the
// wrapper's `_wgmma_weights`), w3 folded (C3 = 256, 4096) (`_fold_w3`), both 16-byte
// aligned; b2, b3 may be null. pre2 (B, C2, T1 / 4), pre3 and post3 (B, C3, T1 / 16),
// pre3 and post3 16-byte aligned. Needs T1 % 16 == 0, T1 >= 64. Launches on `stream` and
// returns cudaGetLastError() (0 on success), or the error of building the tensor maps; it
// does not synchronise and allocates nothing.
extern "C" int encoder_fused_wgmma_launch(const void* h1, const void* w2, const void* b2,
                                          const void* a2, const void* w3, const void* b3,
                                          const void* a3, void* pre2, void* pre3,
                                          void* post3, int B, int C1, int T1, int c2,
                                          int c3, void* stream) {
  const int T3 = T1 / (STRIDE * STRIDE);
  const long long tiles = (T3 + TILE - 1) / TILE;
  if (B <= 0 || C1 <= 0 || c2 != C2 || c3 != C3 || T1 % (STRIDE * STRIDE) != 0 || T1 < 64 ||
      (long long)B * tiles >= (1LL << 31) || (long long)C1 * KP >= (1LL << 31) ||
      reinterpret_cast<uintptr_t>(h1) % 16 != 0 || reinterpret_cast<uintptr_t>(w2) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w3) % 16 != 0 || reinterpret_cast<uintptr_t>(pre3) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(post3) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap h1_map, w2_map, w3_map;
  cudaError_t err = encode_x_map(&h1_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, h1, B, C1, T1,
                                 T1, WIN, CC);
  if (err == cudaSuccess)
    err = encode_w_map(&w2_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w2, C2, C1 * KP, W_BOX,
                       C2);
  if (err == cudaSuccess)
    err = encode_w_map(&w3_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w3, C3, KP * C2, W_BOX,
                       C3);
  if (err != cudaSuccess) return (int)err;
  static bool sized[MAX_DEVICES] = {};
  err = size_smem_once(enc23_wgmma_kernel, SMEM, sized);
  if (err != cudaSuccess) return (int)err;
  enc23_wgmma_kernel<<<(unsigned)(B * tiles), THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      h1_map, w2_map, w3_map, static_cast<const __nv_bfloat16*>(b2),
      static_cast<const __nv_bfloat16*>(a2), static_cast<const __nv_bfloat16*>(b3),
      static_cast<const __nv_bfloat16*>(a3), static_cast<__nv_bfloat16*>(pre2),
      static_cast<__nv_bfloat16*>(pre3), static_cast<__nv_bfloat16*>(post3), C1, T1,
      (int)tiles);
  return (int)cudaGetLastError();
}
