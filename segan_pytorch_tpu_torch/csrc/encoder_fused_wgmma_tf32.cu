// Chained enc2 + enc3 of the SEGAN+ generator encoder in fp32, by 3xTF32 on Hopper's
// warpgroup MMA (sm_90a).
//
// Replaces, on the fp32 route, the TPU kernel `fused_enc23_fwd` of
// segan_pytorch_tpu/ops/pallas/encoder_fused.py:112 (`_kernel` :81, `_fold_weights` :47),
// beside csrc/encoder_fused.cu (`enc23_tf32_kernel`, `enc23_kernel`), which compute the
// same function:
//     pre2 = conv(reflect_pad(h1), w2) + b2      post2 = PReLU(pre2, a2)
//     pre3 = conv(reflect_pad(post2), w3) + b3   post3 = PReLU(pre3, a3)
// reflect pad (14, 15), stride 4, 31 taps padded to 32 (tap 31 zero); h1 (B, C1, T1)
// unpadded, contiguous and 16-byte aligned, T1 % 16 == 0, T1 >= 64; C2 = 128, C3 = 256
// (SEGAN+'s widths); fp32 in and out, post2 kept in fp32 (not rounded). Every product is
// taken as small(x) big(w) + big(x) small(w) + big(x) big(w), in that order, each
// operand's TF32 parts rounded to nearest (csrc/mma_tf32.cuh), as csrc/conv1d_wgmma_tf32.cu
// takes it. The wrapper (ops/kernels/encoder_fused.py, `_route`) sends an fp32 call here
// by shape and alignment, with the cluster size by batch.
//
// What bounds it on the H100: the operations. 3 x 104 GFLOP of TF32 MMAs at 300 chunks
// against 495 TFLOP/s (1.89 ms), where enc23_tf32_kernel (mma.sync m16n8k8, one
// synchronous mainloop, both weight parts from L2 in every warp) took 10.4 ms. Next to
// them, L2: a block streams both TF32 parts of w2 once per phase-A pass and of w3 once.
//
// The design: csrc/conv1d_wgmma_tf32.cu's block on csrc/encoder_fused_wgmma.cu's chained
// plan, post2 in fp32 in shared memory, enc3's depth split over a thread-block cluster of
// CL = 1, 2 or 4 blocks (a template parameter; the wrapper picks it by batch).
//   - A block is two consumer warpgroups and one producer warp whose one thread keeps a
//     ring of STAGES shared-memory stages full by TMA (csrc/tma_ring.cuh: mbarrier pairs
//     with a trapping wait, cp.async.bulk.tensor); 288 threads, one block per SM. A
//     cluster owns TILE = 64 enc3 rows of one batch row; its block of rank r computes and
//     keeps the NA = C2 / CL channels r NA .. r NA + NA - 1 of post2, and sums enc3's
//     depth over them for all C3 channels of the tile. The grid is CL x B x ceil(T3 / 64),
//     clusters of CL consecutive blocks, the ragged last tile masked.
//   - Phase A (enc2) computes those channels of post2 on the SLOTS = 284 padded rows that
//     the tile's enc3 windows read (slot p: padded post2 row 4 t0 + p, real row
//     4 t0 - 14 + p), as 5 m64 tiles in three passes, one m64 tile a warpgroup and pass:
//     tiles 0-1 (m64 nNA), 2-3, then tile 4, each warpgroup NA / 2 of its channels. Each
//     pass streams through the ring, CC = CL input channels a stage, both TF32 parts of
//     w2 (`_padded_weights`: taps in their order, (C2, C1 x 32) K-major, one TMA box {32,
//     NA} a part and channel with the 128-byte swizzle, read by descriptor) and h1 by one
//     box {96, CC, 1} per m16 group of rows straight from its unpadded rows. Group q's
//     window starts at sample 16 t0 - 70 + 64 q, 2 samples past a 16-byte boundary,
//     where TMA must start a box: the box starts XOFF = 2 samples earlier (TMA fills
//     samples outside [0, T1) with zeros; boxes wholly past T1 are not loaded). A comes
//     from registers, split into its TF32 parts as its fragments are loaded (cvt.rna,
//     sub, cvt.rna): lane (g, t) of step st reads samples 4 g + 8 st + t and + 4 of its
//     window, row g + 8 32 samples on, free of bank conflicts. The reflect at T1 is
//     written into the landed windows by the warps that read them, in a row's first and
//     last tile only. pre2 is stored only for the 4 TILE rows the tile owns.
//   - Fresh-register partial sums, as in conv1d_wgmma_tf32.cu: each input channel's 12
//     MMAs (4 steps x 3 products) sum into zeroed registers (scale-d 0 on the first), one
//     commit group, waited for, then added to the running sums with fp32 adds, which
//     round to nearest (the tensor cores' own fp32 sums do not: one accumulator over a
//     16384-deep contraction drifted 1.2e-4 from float64). The other warpgroup's MMAs
//     fill the tensor cores meanwhile.
//   - post2 stays in shared memory in fp32, in the TPU kernel's folded (space-to-depth)
//     layout over the block's channels: folded row u holds slots 4u .. 4u + 3 at depth
//     s NA + c, u F floats from the start, the pitch F = 4 NA + 4 padded so that F % 32 ==
//     4: the 8 rows g of a fragment load fall on 8 distinct groups of 4 banks, and its
//     loads are free of bank conflicts. The slots no real row maps to are filled as
//     enc23_mma_kernel fills them: mirrored rows at either end (reflect at T2), else zero.
//   - Phase B (enc3): folded tap q of enc3 row m reads folded row m + q, so A (m64 x
//     8 depths) is loaded from that tile by the same fragment maps and split as it is
//     loaded; B is w3 folded K-major as `_fold_w3` folds it (w3f[co, 512 q + 128 s + c] =
//     w3[co, c, 4 q + s]) and split into its TF32 parts by the wrapper (once per weight
//     and version), streamed DK = 16 depths (64 bytes) a stage, both parts one TMA box
//     {16, 256} each with the 64-byte swizzle, read by descriptor; the block's stages
//     cover its own channels c = r NA .. r NA + NA - 1 of each (q, s). Each warpgroup
//     n128 of C3; a stage's 6 MMAs sum into fresh registers, folded as in phase A (a
//     span of 32, two stages, ran no faster and made ptxas spill).
//   - The cluster's reduction: after a cluster barrier (every block done with its ring),
//     each block pushes its fp32 partial pre3 through distributed shared memory into the
//     ring of the block that finishes their C3 / CL channels, a slot per rank; after a
//     second barrier each block adds its slots in rank order (the same order on every
//     run), adds b3, applies the PReLU and stores pre3 and post3, a row a thread. At CL =
//     1 the same path runs in the block's own memory.
// Shared memory (CL = 1 / 2 / 4): post2 146,544 / 73,840 / 37,488 B, the ring 2 / 4 / 4
// stages of 35 / 38 / 44 KB; the reduction's slots (68 KB) reuse the ring.
// tests/test_torch_encoder_fused_wgmma_tf32.py emulates these maps in float64 and reads the
// constants below.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "tma_ring.cuh"

namespace {

using mma_conv::KP;  // taps, padded by the wrapper
using mma_conv::prelu;
using mma_conv::split_tf32;
using namespace tma_ring;

constexpr int STRIDE = 4;
constexpr int PAD_L = 14;                      // the reflect pad (14, 15)
constexpr int PAD_R = 15;
constexpr int C2 = 128;                        // enc2's channels, cut over the cluster
constexpr int C3 = 256;                        // enc3's: phase B's N, n128 a warpgroup
constexpr int TILE = 64;                       // enc3 rows per cluster
constexpr int SLOTS = 284;                     // padded post2 rows one tile reads
constexpr int FROWS = 71;                      // folded post2 rows: slots / 4
constexpr int A_GROUPS = 20;                   // phase A's m16 groups: 5 m64 tiles
constexpr int WIN = 96;                        // h1 samples per m16 group and channel
constexpr int XOFF = 2;                        // where a group's window starts in its box
constexpr int STEPS = 4;                       // 8-deep steps per h1 channel
constexpr int DK = 16;                         // phase B depths per ring stage: 64 bytes
constexpr int CONSUMERS = 2;                   // warpgroups that issue MMAs
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int A_BOXES = 8;                     // h1 boxes per stage: 4 groups a warpgroup
constexpr int A_PASSES = 3;                    // tiles 0-1, 2-3, then 4 split over N
constexpr int RED_LD = TILE + 4;               // a channel's rows in a reduction slot
constexpr int MAX_SMEM = 232448;

// What depends on the cluster size CL (1, 2 or 4).
template <int CL>
struct Plan {
  static constexpr int NA = C2 / CL;          // post2 channels a block computes and keeps
  static constexpr int CC = CL;               // h1 channels per phase A stage
  static constexpr int F = 4 * NA + 4;        // floats from one folded post2 row to the next
  static constexpr int POST2_BYTES = FROWS * F * 4;
  static constexpr int W2_BOX = KP * NA * 4;  // one part of one channel's w2: 16 KB / CL
  static constexpr int W2_BYTES = 2 * CC * W2_BOX;  // w_big's boxes, then w_small's
  static constexpr int X_BYTES = CC * WIN * 4;      // one h1 box
  static constexpr int A_STAGE = W2_BYTES + A_BOXES * X_BYTES;
  static constexpr int W3_BOX = DK * C3 * 4;        // one part of a phase B stage: 16 KB
  static constexpr int B_STAGE = 2 * W3_BOX;
  static constexpr int STAGE_BYTES = ((A_STAGE > B_STAGE ? A_STAGE : B_STAGE) + 1023) / 1024 * 1024;
  static constexpr int STAGES = CL == 1 ? 2 : 4;
  static constexpr int CHUNKS = NA / DK;            // phase B stages per folded (q, s)
  static constexpr int B_ITERS = 8 * 4 * CHUNKS;    // phase B stages: depth 4096 / CL
  static constexpr int SHARE = C3 / CL;             // pre3 channels a block finishes
  static constexpr int RED_BYTES = C3 * RED_LD * 4;  // CL slots of SHARE channels
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + POST2_BYTES + 2 * STAGES * 8;
  static_assert(CL == 1 || CL == 2 || CL == 4, "clusters of 1, 2 or 4");
  static_assert(F % 32 == 4 && F % 4 == 0, "conflict-free fragment loads, 16-byte rows");
  static_assert(W2_BOX % 1024 == 0 && W3_BOX % 1024 == 0 && X_BYTES % 128 == 0,
                "swizzled boxes 1024-byte aligned, h1 boxes 128");
  static_assert(NA % DK == 0, "whole stages");
  static_assert(RED_BYTES <= STAGES * STAGE_BYTES, "the reduction's slots in the ring");
  static_assert(SMEM <= MAX_SMEM, "one block per SM");
};

static_assert(SLOTS == STRIDE * TILE + KP - STRIDE && FROWS * STRIDE == SLOTS, "slots");
static_assert(A_GROUPS * 16 >= SLOTS && A_GROUPS * 16 - 64 < SLOTS, "whole m64 tiles");
// TMA starts a box on a 16-byte boundary; a window starts at 16 t0 - 70 + 64 q
static_assert((STRIDE * PAD_L + PAD_L + XOFF) % 4 == 0 && XOFF + 92 <= WIN, "boxes");
static_assert(STEPS * 8 == KP, "a channel's taps in 8-deep steps");

// A wgmma descriptor of a K-major tile with the 64-byte swizzle: rows of 64 bytes, groups
// of 8 rows 512 bytes apart; `addr` may move by 32 bytes inside a row (one step of 8 TF32
// values).
__device__ __forceinline__ uint64_t desc_sw64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
}

// Every thread of every block of the cluster: arrive (releasing this thread's writes),
// then wait for all (acquiring theirs).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of shared-memory address `addr` of this block in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// d (64 x 128) (+)= a (64 x 8, TF32, registers) * B (8 x 128, TF32, K-major, `desc`)
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 64) (+)= a (64 x 8, TF32, registers) * B (8 x 64, TF32, K-major, `desc`)
__device__ __forceinline__ void mma_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 32) (+)= a (64 x 8, TF32, registers) * B (8 x 32, TF32, K-major, `desc`)
__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x 16) (+)= a (64 x 8, TF32, registers) * B (8 x 16, TF32, K-major, `desc`)
__device__ __forceinline__ void mma_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (64 x N) (+)= a * B for the widths the passes take
template <int N>
__device__ __forceinline__ void mma_tf32(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc, int accumulate) {
  if constexpr (N == 128) mma_n128(d, a, desc, accumulate);
  else if constexpr (N == 64) mma_n64(d, a, desc, accumulate);
  else if constexpr (N == 32) mma_n32(d, a, desc, accumulate);
  else mma_n16(d, a, desc, accumulate);
}

// The reflect at either end of h1, written into a landed box whose first sample is
// `start`: samples -14..-1 take 14..1, samples T1..T1 + 14 take T1 - 2..T1 - 16, where the
// source lies in the same box (it does for every row that is stored); one warp.
template <int CC>
__device__ __forceinline__ void reflect_window(float* win, int start, int T1, int lane) {
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

// The group of rows whose window ring box j (warp j % 4 of warpgroup j / 4) holds in
// phase A's pass: passes 0 and 1 group 8 pass + j (m64 tile 2 pass + j / 4), pass 2 group
// 16 + j % 4 (m64 tile 4, a copy for each warpgroup).
__device__ __forceinline__ int box_group(int pass, int j) {
  return pass < 2 ? 8 * pass + j : 16 + j % 4;
}

// What a block knows of its tile.
struct Tile {
  int rank;   // in the cluster: post2 channels rank NA .., enc3's depth over them
  int b, t0, t_end, T1, T2, T3;
  int p0;     // the real post2 row of slot 0, before reflection
  int x0;     // the h1 sample where group 0's box starts, XOFF before its window
  bool edge;  // a box of this tile holds samples outside [0, T1)
};

// One pass of phase A for a consumer warpgroup: one m64 tile x NW channels of post2 (all
// NA of the block's in passes 0 and 1, half of them in pass 2), summed over every h1
// channel, then stored: post2 into the folded tile, pre2 for the rows the tile owns.
template <int CL, int NW>
__device__ __forceinline__ void phase_a_pass(const Tile& T, int pass, int a_iters, int& k,
                                             uint32_t ring, uint8_t* ring_ptr, uint32_t full,
                                             uint32_t empty, float* post2,
                                             const float* __restrict__ b2,
                                             const float* __restrict__ a2,
                                             float* __restrict__ pre2) {
  using P = Plan<CL>;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int box = 4 * wg + warp;
  const int q = box_group(pass, box);          // this warp's m16 group
  const int n_off = pass < 2 ? 0 : NW * wg;    // its first row of the w2 boxes
  float acc[NW / 2], part[NW / 2];
#pragma unroll
  for (int e = 0; e < NW / 2; ++e) acc[e] = part[e] = 0.f;
  for (int it = 0; it < a_iters; ++it, ++k) {
    const int s = k % P::STAGES;
    mbar_wait(full + 8 * s, (k / P::STAGES) & 1);
    float* const xs = reinterpret_cast<float*>(ring_ptr + s * P::STAGE_BYTES + P::W2_BYTES +
                                               box * P::X_BYTES);
    const uint32_t ws = ring + s * P::STAGE_BYTES + n_off * 128;  // 128-byte rows
    if (T.edge) {
      reflect_window<P::CC>(xs, T.x0 + STRIDE * 16 * q, T.T1, lane);
      fence_async_smem();  // the stage is refilled by TMA after these writes
      __syncwarp();
    }
#pragma unroll
    for (int c = 0; c < P::CC; ++c) {
      // Per channel: its A fragments (both TF32 parts, 32 registers a lane), its 12 MMAs
      // into the fresh sums as one commit group, waited for, then folded
      uint32_t ab[STEPS][4], as[STEPS][4];
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        // row g at step st: samples 4 g + 8 st + t and t + 4 of its window; row g + 8 32
        // samples on
        const float* p = xs + c * WIN + XOFF + STRIDE * g + 8 * st + t;
        split_tf32(p[0], ab[st][0], as[st][0]);
        split_tf32(p[STRIDE * 8], ab[st][1], as[st][1]);
        split_tf32(p[4], ab[st][2], as[st][2]);
        split_tf32(p[STRIDE * 8 + 4], ab[st][3], as[st][3]);
      }
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int st = 0; st < STEPS; ++st) {
        // channel c's taps of step st: bytes 32 st of each row of its two boxes
        const uint64_t w_big = desc_sw128(ws + c * P::W2_BOX + 32 * st);
        const uint64_t w_small = desc_sw128(ws + (P::CC + c) * P::W2_BOX + 32 * st);
        mma_tf32<NW>(part, as[st], w_big, st > 0);  // the first from zero
        mma_tf32<NW>(part, ab[st], w_small, 1);
        mma_tf32<NW>(part, ab[st], w_big, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < NW / 2; ++e) acc[e] += part[e];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }
  // lane (g, t) of warp w holds rows 16 w + g (+ 8 for e >= 2) and channels
  // 8 j + 2 t + (e & 1) in acc[4 j + e]
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int eh = 0; eh < 2; ++eh) {
      const int p = 16 * q + g + 8 * eh;
      if (p >= SLOTS) continue;  // rows of the last m64 tile that no enc3 row reads
      const int cl = n_off + 8 * j + 2 * t;  // the block's channel
      const int c = T.rank * P::NA + cl;
      const float v0 = acc[4 * j + 2 * eh] + (b2 != nullptr ? b2[c] : 0.f);
      const float v1 = acc[4 * j + 2 * eh + 1] + (b2 != nullptr ? b2[c + 1] : 0.f);
      *reinterpret_cast<float2*>(post2 + (p / STRIDE) * P::F + (p % STRIDE) * P::NA + cl) =
          make_float2(prelu(v0, a2[c]), prelu(v1, a2[c + 1]));
      const int r = T.p0 + p;
      if (r >= STRIDE * T.t0 && r < STRIDE * T.t_end) {
        pre2[((long long)T.b * C2 + c) * T.T2 + r] = v0;
        pre2[((long long)T.b * C2 + c + 1) * T.T2 + r] = v1;
      }
    }
}

// h1_map: h1 (B, C1, T1), boxes {WIN, CC, 1}; w2b_map, w2s_map: w2's TF32 parts (C2,
// C1 x 32), boxes {32, NA}, 128-byte swizzle; w3b_map, w3s_map: w3 folded, its TF32 parts
// (C3, 4096), boxes {16, 256}, 64-byte swizzle. Grid CL x B x tiles (x), clusters of CL.
template <int CL>
__global__ void __launch_bounds__(THREADS, 1)
enc23_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap h1_map,
                        const __grid_constant__ CUtensorMap w2b_map,
                        const __grid_constant__ CUtensorMap w2s_map,
                        const __grid_constant__ CUtensorMap w3b_map,
                        const __grid_constant__ CUtensorMap w3s_map,
                        const float* __restrict__ b2, const float* __restrict__ a2,
                        const float* __restrict__ b3, const float* __restrict__ a3,
                        float* __restrict__ pre2, float* __restrict__ pre3,
                        float* __restrict__ post3, int C1, int T1, int tiles) {
  using P = Plan<CL>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  float* const post2 = reinterpret_cast<float*>(ring_ptr + P::STAGES * P::STAGE_BYTES);
  const uint32_t full = ring + P::STAGES * P::STAGE_BYTES + P::POST2_BYTES;  // full[s]: + 8 s
  const uint32_t empty = full + P::STAGES * 8;  // empty[s] at empty + 8 s

  Tile T;
  T.rank = blockIdx.x % CL;  // the cluster spans CL consecutive blocks of x
  const int tile = blockIdx.x / CL;
  T.T1 = T1;
  T.T2 = T1 / STRIDE;
  T.T3 = T.T2 / STRIDE;
  T.b = tile / tiles;
  T.t0 = (tile % tiles) * TILE;
  T.t_end = min(T.t0 + TILE, T.T3);
  T.p0 = STRIDE * T.t0 - PAD_L;
  T.x0 = STRIDE * T.p0 - PAD_L - XOFF;
  T.edge = T.x0 < 0 || T.x0 + STRIDE * 16 * (A_GROUPS - 1) + WIN > T1;
  const int lo = max(0, T.p0);  // real rows that land in slots [0, SLOTS)
  const int hi = min(T.T2 - 1, T.p0 + SLOTS - 1);
  const int a_iters = (C1 + P::CC - 1) / P::CC;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < P::STAGES; ++s) {
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
        uint32_t bytes = P::W2_BYTES;
        for (int j = 0; j < A_BOXES; ++j)
          bytes += T.x0 + STRIDE * 16 * box_group(pass, j) < T1 ? P::X_BYTES : 0;
        for (int it = 0; it < a_iters; ++it, ++k) {
          const int s = k % P::STAGES;
          mbar_wait(empty + 8 * s, ((k / P::STAGES) & 1) ^ 1);
          mbar_expect_tx(full + 8 * s, bytes);
          const uint32_t st = ring + s * P::STAGE_BYTES;
#pragma unroll
          for (int c = 0; c < P::CC; ++c) {
            const int col = (it * P::CC + c) * KP;  // channels past C1 read as 0
            tma_load_2d(st + c * P::W2_BOX, &w2b_map, col, T.rank * P::NA, full + 8 * s);
            tma_load_2d(st + (P::CC + c) * P::W2_BOX, &w2s_map, col, T.rank * P::NA,
                        full + 8 * s);
          }
          for (int j = 0; j < A_BOXES; ++j) {
            const int start = T.x0 + STRIDE * 16 * box_group(pass, j);
            if (start < T1)  // a window wholly past T1 is read by no stored row
              tma_load_3d(st + P::W2_BYTES + j * P::X_BYTES, &h1_map, start, it * P::CC, T.b,
                          full + 8 * s);
          }
        }
      }
      for (int it = 0; it < P::B_ITERS; ++it, ++k) {
        const int s = k % P::STAGES;
        mbar_wait(empty + 8 * s, ((k / P::STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, P::B_STAGE);
        // stage it: folded tap q, phase s of the fold, the block's channels DK chunk on
        const int q = it / (4 * P::CHUNKS);
        const int sp = (it / P::CHUNKS) % 4;
        const int col = 512 * q + C2 * sp + T.rank * P::NA + DK * (it % P::CHUNKS);
        const uint32_t st = ring + s * P::STAGE_BYTES;
        tma_load_2d(st, &w3b_map, col, 0, full + 8 * s);
        tma_load_2d(st + P::W3_BOX, &w3s_map, col, 0, full + 8 * s);
      }
    }
    __syncwarp();
    cluster_sync();  // the consumers are done with their rings
    cluster_sync();  // every partial sum is in its finisher's slot
    return;
  }

  // the consumer warpgroups
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  int k = 0;  // ring stages consumed, in the producer's order

  for (int pass = 0; pass < 2; ++pass)
    phase_a_pass<CL, P::NA>(T, pass, a_iters, k, ring, ring_ptr, full, empty, post2, b2, a2,
                            pre2);
  phase_a_pass<CL, P::NA / 2>(T, 2, a_iters, k, ring, ring_ptr, full, empty, post2, b2, a2,
                              pre2);

  consumers_sync();  // every slot written
  if (lo > T.p0 || hi < T.p0 + SLOTS - 1) {
    // the slots of no real row: mirrored rows at either end (reflect at T2), else zero;
    // 16 bytes (4 channels) a unit
    for (int u = threadIdx.x; u < SLOTS * (P::NA / 4); u += CONSUMERS * 128) {
      const int p = u / (P::NA / 4);
      const int cl = 4 * (u % (P::NA / 4));
      const int r = T.p0 + p;
      if (r >= lo && r <= hi) continue;
      const int src = r < 0 ? -r : 2 * T.T2 - 2 - r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      const int sp = src - T.p0;
      if (src >= lo && src <= hi)
        v = *reinterpret_cast<const float4*>(post2 + (sp / STRIDE) * P::F +
                                             (sp % STRIDE) * P::NA + cl);
      *reinterpret_cast<float4*>(post2 + (p / STRIDE) * P::F + (p % STRIDE) * P::NA + cl) = v;
    }
  }
  consumers_sync();

  // Phase B: enc3 rows t0 .. t0 + 63, channels 128 wg .. 128 wg + 127, over the block's
  // depth. Stage `it` holds depths 512 q + 128 s + rank NA + 16 chunk .. + 15 of w3f's
  // parts; A is post2's folded row m + q, depth s NA + 16 chunk + 8 kk + k.
  float acc[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;
  const float* const arow = post2 + (16 * warp + g) * P::F + t;
  for (int it = 0; it < P::B_ITERS; ++it, ++k) {
    // A's fragments of the stage's two 8-deep steps kk, both TF32 parts: rows g and g + 8
    // (8 folded rows on), depths kk 8 + t and + 4
    const int q = it / (4 * P::CHUNKS);
    const int sp = (it / P::CHUNKS) % 4;
    const float* const pa = arow + q * P::F + sp * P::NA + DK * (it % P::CHUNKS);
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      split_tf32(pa[8 * kk], ab[kk][0], as[kk][0]);
      split_tf32(pa[8 * kk + 8 * P::F], ab[kk][1], as[kk][1]);
      split_tf32(pa[8 * kk + 4], ab[kk][2], as[kk][2]);
      split_tf32(pa[8 * kk + 4 + 8 * P::F], ab[kk][3], as[kk][3]);
    }
    const int s = k % P::STAGES;
    mbar_wait(full + 8 * s, (k / P::STAGES) & 1);
    const uint32_t ws = ring + s * P::STAGE_BYTES + wg * 128 * 64;  // rows 128 wg..
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t w_big = desc_sw64(ws + 32 * kk);
      const uint64_t w_small = desc_sw64(ws + P::W3_BOX + 32 * kk);
      mma_n128(part, as[kk], w_big, kk > 0);  // a stage's first from zero
      mma_n128(part, ab[kk], w_small, 1);
      mma_n128(part, ab[kk], w_big, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(part);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += part[e];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // The partial sums, pushed into the ring of the block that finishes their channels
  // (rank ch / SHARE, slot this block's rank), channel-major: slot r, channel cl, row m at
  // float (r SHARE + cl) RED_LD + m
  cluster_sync();  // every block of the cluster is done with its ring
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = 128 * wg + 8 * j + 2 * t + (e & 1);
      const int owner = ch / P::SHARE;
      const int row = 16 * warp + g + 8 * (e >> 1);
      st_cluster_f32(map_rank(ring + (uint32_t)(((T.rank * P::SHARE + ch - owner * P::SHARE) *
                                                  RED_LD + row) * 4),
                              owner),
                     acc[4 * j + e]);
    }
  cluster_sync();  // every block's partial sums are in their finishers' rings
  // This block's channels: the slots' sums in rank order, the bias, the PReLU; a row a
  // thread, consecutive rows on consecutive threads
  const float* const red = reinterpret_cast<const float*>(ring_ptr);
  for (int i = threadIdx.x; i < P::SHARE * TILE; i += CONSUMERS * 128) {
    const int cl = i / TILE;
    const int m = i % TILE;
    if (T.t0 + m >= T.t_end) continue;
    float sum = red[cl * RED_LD + m];
#pragma unroll
    for (int r = 1; r < CL; ++r) sum += red[(r * P::SHARE + cl) * RED_LD + m];
    const int c = T.rank * P::SHARE + cl;
    const float p = sum + (b3 != nullptr ? b3[c] : 0.f);
    const long long o = ((long long)T.b * C3 + c) * T.T3 + T.t0 + m;
    pre3[o] = p;
    post3[o] = prelu(p, a3[c]);
  }
}

template <int CL>
int launch(const CUtensorMap& h1_map, const CUtensorMap& w2b_map, const CUtensorMap& w2s_map,
           const CUtensorMap& w3b_map, const CUtensorMap& w3s_map, const float* b2,
           const float* a2, const float* b3, const float* a3, float* pre2, float* pre3,
           float* post3, int blocks, int C1, int T1, int tiles, cudaStream_t stream) {
  static bool sized[MAX_DEVICES] = {};
  cudaError_t err = size_smem_once(enc23_wgmma_tf32_kernel<CL>, Plan<CL>::SMEM, sized);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)(CL * blocks));
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = Plan<CL>::SMEM;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, enc23_wgmma_tf32_kernel<CL>, h1_map, w2b_map, w2s_map,
                           w3b_map, w3s_map, b2, a2, b3, a3, pre2, pre3, post3, C1, T1, tiles);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The chained kernel's fp32 wgmma route: h1 (B, C1, T1) contiguous and 16-byte aligned;
// w2_big, w2_small the TF32 parts of w2 padded to 32 taps, (C2 = 128, C1, 32) each (the
// wrapper's `_padded_weights`), w3_big, w3_small those of w3 folded, (C3 = 256, 4096) each
// (`_fold_w3`, then split), all 16-byte aligned; b2, b3 may be null. pre2 (B, C2, T1 / 4),
// pre3 and post3 (B, C3, T1 / 16). `cluster` (1, 2 or 4) blocks share each tile of 64
// enc3 rows, each computing C2 / cluster channels of post2 and enc3's depth over them.
// Needs T1 % 16 == 0, T1 >= 64. Launches on `stream` and returns the launch's error (0
// on success), or the error of building the tensor maps; it does not synchronise and
// allocates nothing.
extern "C" int encoder_fused_wgmma_tf32_launch(const void* h1, const void* w2_big,
                                               const void* w2_small, const void* b2,
                                               const void* a2, const void* w3_big,
                                               const void* w3_small, const void* b3,
                                               const void* a3, void* pre2, void* pre3,
                                               void* post3, int cluster, int B, int C1,
                                               int T1, int c2, int c3, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16; };
  const int T3 = T1 / (STRIDE * STRIDE);
  const long long tiles = (T3 + TILE - 1) / TILE;
  if (B <= 0 || C1 <= 0 || c2 != C2 || c3 != C3 || T1 % (STRIDE * STRIDE) != 0 || T1 < 64 ||
      (cluster != 1 && cluster != 2 && cluster != 4) ||
      (long long)B * tiles * cluster >= (1LL << 31) || (long long)C1 * KP >= (1LL << 31) ||
      misaligned(h1) || misaligned(w2_big) || misaligned(w2_small) || misaligned(w3_big) ||
      misaligned(w3_small))
    return (int)cudaErrorInvalidValue;
  const int na = C2 / cluster;
  CUtensorMap h1_map, w2b_map, w2s_map, w3b_map, w3s_map;
  cudaError_t err = encode_x_map(&h1_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, h1, B, C1, T1,
                                 T1, WIN, cluster);
  if (err == cudaSuccess)
    err = encode_w_map(&w2b_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w2_big, C2, C1 * KP, KP,
                       na);
  if (err == cudaSuccess)
    err = encode_w_map(&w2s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w2_small, C2, C1 * KP,
                       KP, na);
  if (err == cudaSuccess)
    err = encode_w_map(&w3b_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w3_big, C3, KP * C2, DK,
                       C3, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == cudaSuccess)
    err = encode_w_map(&w3s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w3_small, C3, KP * C2,
                       DK, C3, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err != cudaSuccess) return (int)err;
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* const o2 = static_cast<float*>(pre2);
  float* const o3 = static_cast<float*>(pre3);
  float* const p3 = static_cast<float*>(post3);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = (int)(B * tiles);
  switch (cluster) {
    case 1:
      return launch<1>(h1_map, w2b_map, w2s_map, w3b_map, w3s_map, f(b2), f(a2), f(b3), f(a3),
                       o2, o3, p3, blocks, C1, T1, (int)tiles, s);
    case 2:
      return launch<2>(h1_map, w2b_map, w2s_map, w3b_map, w3s_map, f(b2), f(a2), f(b3), f(a3),
                       o2, o3, p3, blocks, C1, T1, (int)tiles, s);
    default:
      return launch<4>(h1_map, w2b_map, w2s_map, w3b_map, w3s_map, f(b2), f(a2), f(b3), f(a3),
                       o2, o3, p3, blocks, C1, T1, (int)tiles, s);
  }
}
