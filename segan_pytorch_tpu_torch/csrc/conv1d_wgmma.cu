// Fused strided conv1d + bias + PReLU in bf16 on Hopper's warpgroup MMA (sm_90a).
//
// Replaces, on the bf16 main path, the TPU kernel `fused_conv1d_prelu` of
// segan_pytorch_tpu/ops/pallas/conv1d.py (`_pallas_conv_prelu`, `_kernel`), beside the
// kernels of csrc/conv1d_prelu.cu, which computes the same function:
//     pre[b, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * x[b, ci, S t + k]
//     y = max(pre, 0) + slope[co] * min(pre, 0)
// bf16 in, fp32 sums, y and pre in bf16 (B, Cout, T_out); stride S = 4 (SEGAN+'s G and D)
// or 2 (Generator1D's encoder), a template parameter; the 31 taps padded to 32 (tap 31
// zero); samples at or past T_in read as 0. The wrapper (ops/kernels/conv1d_prelu.py,
// `_route`) sends a call here by shape and by x's layout.
//
// What bounds it on the H100. enc2..enc5 of SEGAN+'s generator each do about 0.54 GFLOP
// per 16384-sample chunk over a contraction of Cin * 32 = 2048..16384: bound by the tensor
// cores' operations (989 TFLOP/s), if the operands reach them. conv1d_mma_kernel (the
// mma.sync route) reached 11-14 % of that at 64 and 300 chunks: it staged x with one
// 2-byte load per element between two barriers while its MMAs waited, and every warp read
// its weights from L2 for every input channel.
//
// The design (the usual shape of a Hopper GEMM), as an implicit GEMM:
// M = B * T_out rows (batch and time flattened), N = Cout, depth Cin * 32.
//   - A block is two consumer warpgroups, each of MT m64 tiles (64 rows) x 128 channels
//     (MT = 2: a 256 x 128 block tile; MT = 1 for fewer rows), and one producer warp,
//     whose one thread keeps a ring of STAGES shared-memory stages full: 288 threads and
//     one block per SM, so that a consumer may hold 224 registers (its 64 MT fp32 sums
//     and a stage's A fragments) without setmaxnreg.
//   - A stage holds CC = 4 input channels: their 32 padded taps of the block's 128 output
//     channels (two TMA boxes of 64 taps x 128 rows, cp.async.bulk.tensor with a 128-byte
//     swizzle over a 2-D map of w, (Cout, Cin * 32)), and the x window of each m16 group
//     of rows over a 3-D map of x, (B, Cin, T_in) with rows `pitch` apart: at stride 4
//     WIN = 96 samples of each channel from 4 t0 (one TMA box {96, CC, 1}; 92 read); at
//     stride 2 one box {WIN_HALF = 48, CC, 1} for each 8-row half of the group, from
//     2 t of the half's first row (46 read), so that T_out % 8 == 0 is enough: a group
//     may span two batch rows (Generator1D's last layer, T_out = 8), a half never does.
//     Both fill a group's 768 bytes of a stage. TMA needs 16-byte strides, hence x in
//     rows whose pitch is a multiple of 8 (G and Generator1D pad into such rows,
//     ops/conv.py `reflect_pad_pitched`, `zero_pad_pitched`). The map's bound is T_in, so
//     TMA fills samples at or past T_in, and channels past Cin, with zeros: the last
//     row's zero tap reads sample T_in when (T_in - 31) % S == 0, and 0 x NaN would be
//     NaN.
//   - full / empty mbarrier pairs: the producer waits for a stage to be empty, announces
//     its bytes (arrive.expect_tx) and issues its copies; consumers wait for it to be
//     full, run its MMAs, and each warp releases it.
//   - Consumers issue wgmma.mma_async m64n128k16 (bf16, fp32 sums in registers): A, x,
//     from registers, B, w, from the swizzled tile through a descriptor. A is built from
//     the staged window with the mma.sync kernel's index maps: in step h (0, 1) of a
//     channel, contraction index 2q + e and 2q + 8 + e (lane quad q, e = 0, 1) takes tap
//     8q + 4h + e and 8q + 4h + 2 + e, so a row's four A values of a lane are adjacent
//     samples: one 8-byte shared-memory load at stride 4 (rows g and g + 8 of the warp's
//     m16 group: two loads per step and m64 tile), two 4-byte loads at stride 2, where a
//     row starts at sample 2 g + 8 q + 4 h of its window (`load_a4`, csrc/mma_bf16.cuh).
//     The taps do not depend on the stride: only a row's first sample moves. B must hold
//     the same taps at the same contraction
//     index, so the wrapper permutes the padded taps once per weight and version
//     (`_wgmma_weights`): w_perm[co, ci, 16 h + k] = w_pad[co, ci, tap_h(k)]. A step then
//     reads 32 contiguous bytes of each weight row, the descriptor's start moved by
//     32 bytes inside the 128-byte swizzle span.
//   - A warpgroup loads a whole stage's A fragments, fences, issues the stage's 8 MT
//     MMAs as one commit group, waits for it and releases the stage: the other
//     warpgroup's MMAs fill the tensor cores while one loads, and the producer runs
//     STAGES - 1 stages ahead. (A group per channel with A double-buffered across
//     channels would overlap the loads, but ptxas serialises MMAs whose register
//     operands are loaded while earlier ones are in flight: its warning C7513.)
//   - Epilogue: bias and PReLU in registers; y and pre through shared memory (the ring,
//     once both consumers are done with it), 16 bytes a lane: T_out % 8 == 0, so an
//     8-row half's 8 time steps of one channel are 16 aligned bytes. Split-K (the deep, short
//     layers at small batch) writes fp32 partial sums to the wrapper's workspace, and
//     csrc/splitk_epilogue.cuh adds them in a fixed order.
// The tensor maps are built by the C entry point on every launch, from the pointers and
// shapes it is given (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so
// the library needs no -lcuda), and passed as __grid_constant__ parameters: a CUDA graph
// records them with the launch. The ring's pieces are csrc/tma_ring.cuh's, shared with
// csrc/conv1d_wgmma_tf32.cu. tests/test_torch_conv1d_wgmma.py emulates these index maps
// in float64.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "splitk_epilogue.cuh"
#include "tma_ring.cuh"

namespace {

using conv_epilogue::launch_splitk_epilogue;
using mma_conv::KP;  // taps, padded by the wrapper
using mma_conv::load_a4;
using mma_conv::prelu;
using namespace tma_ring;

constexpr int BN = 128;         // output channels per block: the MMA's N
constexpr int CC = 4;           // input channels per ring stage
constexpr int STAGES = 4;       // ring stages
constexpr int WIN = 96;         // stride 4: staged samples per m16 group and channel (92 read)
constexpr int WIN_HALF = 48;    // stride 2: the same per 8-row half (46 read)
constexpr int W_BOX = 64;       // taps per weight box: 128 bytes, the swizzle's span
constexpr int W_BOX_BYTES = W_BOX * 2 * BN;          // 16 KB
constexpr int W_STAGE_BYTES = CC * KP / W_BOX * W_BOX_BYTES;
constexpr int X_GROUP_BYTES = CC * WIN * 2;          // one m16 group's windows of a stage
constexpr int CONSUMERS = 2;    // warpgroups that issue MMAs
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int OUT_LD = 16 + 8;  // a channel's 16 rows in the epilogue tile, padded
static_assert(WIN % 8 == 0 && X_GROUP_BYTES % 128 == 0, "16-byte rows, aligned groups");
static_assert(CC * KP % W_BOX == 0, "whole weight boxes per stage");

// The x windows of stride S (csrc/tma_ring.cuh)
template <int S>
using Boxes = XBoxes<S, CC, WIN, WIN_HALF, 2>;

template <int MT, int S>
struct Plan {
  static constexpr int GROUPS = CONSUMERS * MT * 4;  // m16 groups per block
  static constexpr int BOXES = GROUPS * Boxes<S>::PER_GROUP;  // x boxes per block
  static constexpr int TILE_M = GROUPS * 16;
  static constexpr int STAGE_BYTES = W_STAGE_BYTES + GROUPS * X_GROUP_BYTES;
  // ring, 2 STAGES barriers, (b, S t) of each box; 1 KB of slack to align the ring
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + BOXES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "each stage's weight boxes 1024-byte aligned");
  static_assert(8 * 32 * OUT_LD * 2 <= STAGES * STAGE_BYTES, "epilogue tiles in the ring");
};

// d (64 x 128, fp32, the m64nNk16 accumulator layout) += a (64 x 16, bf16, registers:
// each warp 16 rows in mma.sync's m16n8k16 A layout) * B (16 x 128, bf16, K-major in
// shared memory, `desc`).
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
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

// x_map: x (B, Cin, T_in), rows `pitch` apart, boxes {Boxes<S>::SAMPLES, CC, 1}; w_map:
// the permuted weights (Cout, Cin * 32), boxes {W_BOX, BN}, 128-byte swizzle. `slice`
// input channels (a multiple of CC) per split-K slice (blockIdx.z); partial, when not
// null, takes fp32 partial sums. y and pre must be 16-byte aligned; Cout % BN == 0,
// T_out % Boxes<S>::ROWS == 0 (16 at stride 4, 8 at stride 2).
template <int MT, int S>
__global__ void __launch_bounds__(THREADS, 1)
conv1d_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map,
                    const __nv_bfloat16* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ slope, __nv_bfloat16* __restrict__ y,
                    __nv_bfloat16* __restrict__ pre, float* __restrict__ partial, int B,
                    int Cin, int Cout, int T_out, int slice) {
  using P = Plan<MT, S>;
  using X = Boxes<S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * P::STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + STAGES * 8;              // empty[s] at empty + 8 s
  int2* const coord = reinterpret_cast<int2*>(ring_ptr + STAGES * P::STAGE_BYTES +
                                              2 * STAGES * 8);

  const int M = B * T_out;  // the entry point checks that it fits
  const int m0 = blockIdx.x * P::TILE_M;
  const int n0 = blockIdx.y * BN;
  const int c_begin = blockIdx.z * slice;
  const int c_end = min(Cin, c_begin + slice);
  const int iters = (c_end - c_begin + CC - 1) / CC;
  const int live_boxes = min(P::BOXES, (M - m0) / X::ROWS);  // M % ROWS == 0
  const int live_groups = (live_boxes + X::PER_GROUP - 1) / X::PER_GROUP;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS * 4);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < P::BOXES) {  // box j's window: batch row b, first sample S t of its row 0
    const int r = m0 + X::ROWS * threadIdx.x;
    const int b = r / T_out;
    coord[threadIdx.x] = make_int2(b, S * (r - b * T_out));
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {  // the producer warp: one thread issues every copy
    if (threadIdx.x == CONSUMERS * 128) {
      const uint32_t bytes = W_STAGE_BYTES + live_boxes * X::BYTES;
      for (int k = 0; k < iters; ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, bytes);
        const int c0 = c_begin + k * CC;
        const uint32_t st = ring + s * P::STAGE_BYTES;
#pragma unroll
        for (int h = 0; h < W_STAGE_BYTES / W_BOX_BYTES; ++h)
          tma_load_2d(st + h * W_BOX_BYTES, &w_map, c0 * KP + h * W_BOX, n0, full + 8 * s);
        for (int j = 0; j < live_boxes; ++j) {
          const int2 bt = coord[j];
          tma_load_3d(st + W_STAGE_BYTES + j * X::BYTES, &x_map, bt.y, c0, bt.x,
                      full + 8 * s);
        }
      }
    }
  } else {  // a consumer warpgroup: rows 64 (MT wg + i) + 16 warp + 0..15 of the tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int q_first = wg * MT * 4;  // this warpgroup's first m16 group
    const int mt_live = min(MT, max(0, (live_groups - q_first + 3) / 4));
    float acc[MT][64];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[i][e] = 0.f;

    if (mt_live == 0) {  // no live row: release each stage as it fills
      for (int k = 0; k < iters; ++k) {
        mbar_wait(full + 8 * (k % STAGES), (k / STAGES) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (k % STAGES));
      }
    } else {
      // A stage's A fragments first (32 MT registers a lane), then its 8 MT MMAs as one
      // commit group, waited for before the stage is released. Every m64 tile issues its
      // MMAs (a warpgroup-uniform condition per tile would serialise them); rows past M
      // are not stored (at stride 2 a group's second half past M is not loaded either:
      // its rows read what the stage held, and no row of theirs is stored).
      for (int k = 0; k < iters; ++k) {
        const int s = k % STAGES;
        mbar_wait(full + 8 * s, (k / STAGES) & 1);
        const uint8_t* xs = ring_ptr + s * P::STAGE_BYTES + W_STAGE_BYTES;
        const uint32_t ws = ring + s * P::STAGE_BYTES;
        uint32_t af[CC][2][MT][4];
#pragma unroll
        for (int c = 0; c < CC; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              // row g of group q at step h: samples S g + 8 t + 4 h + 0..3 of its box;
              // row g + 8 ROW8 elements on
              const __nv_bfloat16* p =
                  reinterpret_cast<const __nv_bfloat16*>(
                      xs + (q_first + 4 * i + warp) * X_GROUP_BYTES) +
                  c * X::SAMPLES + S * g + 8 * t + 4 * h;
              const uint2 r0 = load_a4<S>(p);
              const uint2 r8 = load_a4<S>(p + X::ROW8);
              af[c][h][i][0] = r0.x;
              af[c][h][i][1] = r8.x;
              af[c][h][i][2] = r0.y;
              af[c][h][i][3] = r8.y;
            }
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CC; ++c)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // channel c's taps: box c / 2, bytes 64 (c % 2) + 32 h of each weight row
            const uint64_t desc = desc_sw128(ws + (c * KP / W_BOX) * W_BOX_BYTES +
                                             (c * KP % W_BOX) * 2 + 32 * h);
#pragma unroll
            for (int i = 0; i < MT; ++i) wgmma_m64n128k16(acc[i], af[c][h][i], desc);
          }
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int i = 0; i < MT; ++i) fence_regs(acc[i]);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // The accumulator of m64 tile i: warp w, lane (g, t) holds rows 16 w + g (+ 8 for
    // e >= 2) and channels 8 j + 2 t + (e & 1) in acc[i][4 j + e], j = 0..15. A group's
    // second half is live when its box is (at stride 4 always with the group).
    if (partial != nullptr) {  // split-K: fp32 partial sums; the epilogue kernel finishes
      float* const part = partial + (long long)blockIdx.z * M * Cout;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int q = q_first + 4 * i + warp;
        if (q >= live_groups) continue;
        const long long base0 = X::half_base(coord, q, 0, Cout, T_out);
        const long long base8 = X::half_base(coord, q, 1, Cout, T_out);
        const bool live8 = q * X::PER_GROUP + X::PER_GROUP - 1 < live_boxes;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < 2 || live8)
              part[(e < 2 ? base0 : base8) + g +
                   (long long)(n0 + 8 * j + 2 * t + (e & 1)) * T_out] = acc[i][4 * j + e];
      }
      return;
    }
    // y and pre through shared memory: once both consumers are done with the ring, each
    // warp puts one m16 group's 128 channels x 16 rows there, then writes 16 bytes a lane
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    __nv_bfloat16* const tile =
        reinterpret_cast<__nv_bfloat16*>(ring_ptr) + (threadIdx.x / 32) * BN * OUT_LD;
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int q = q_first + 4 * i + warp;
      if (q >= live_groups) continue;
      const long long base0 = X::half_base(coord, q, 0, Cout, T_out);
      const long long base8 = X::half_base(coord, q, 1, Cout, T_out);
      const bool live8 = q * X::PER_GROUP + X::PER_GROUP - 1 < live_boxes;
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {  // pre, then y
        __nv_bfloat16* const out = pass == 0 ? pre : y;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = 8 * j + 2 * t + (e & 1);
            const float p =
                acc[i][4 * j + e] + (bias != nullptr ? __bfloat162float(bias[n0 + cl]) : 0.f);
            tile[cl * OUT_LD + g + 8 * (e >> 1)] =
                __float2bfloat16(pass == 0 ? p : prelu(p, __bfloat162float(slope[n0 + cl])));
          }
        __syncwarp();
        // 128 channels x 2 halves of 8 rows: lane l of step u takes unit 32 u + l
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int unit = 32 * u + lane;
          const int cl = unit >> 1;
          const int half = unit & 1;
          if (half == 0 || live8)
            *reinterpret_cast<uint4*>(out + (half ? base8 : base0) +
                                      (long long)(n0 + cl) * T_out) =
                *reinterpret_cast<const uint4*>(tile + cl * OUT_LD + 8 * half);
        }
        __syncwarp();  // the tile is read before the next pass writes it
      }
    }
  }
}

template <int MT, int S>
int launch_wgmma(const void* x, const void* w, const void* bias, const void* slope, void* y,
                 void* pre, float* partial, int splits, int B, int Cin, int T_in, int pitch,
                 int Cout, int T_out, cudaStream_t stream) {
  using P = Plan<MT, S>;
  // input channels per split, whole ring stages, no empty slice
  const int slice = ((Cin + splits - 1) / splits + CC - 1) / CC * CC;
  splits = (Cin + slice - 1) / slice;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  CUtensorMap x_map, w_map;
  cudaError_t err = encode_x_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, B, Cin,
                                 T_in, pitch, Boxes<S>::SAMPLES, CC);
  if (err == cudaSuccess)
    err = encode_w_map(&w_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, Cout, Cin * KP, W_BOX,
                       BN);
  if (err != cudaSuccess) return (int)err;
  static bool sized[MAX_DEVICES] = {};
  err = size_smem_once(conv1d_wgmma_kernel<MT, S>, P::SMEM, sized);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * T_out;
  const dim3 grid((unsigned)((M + P::TILE_M - 1) / P::TILE_M), (unsigned)(Cout / BN),
                  (unsigned)splits);
  conv1d_wgmma_kernel<MT, S><<<grid, THREADS, P::SMEM, stream>>>(
      x_map, w_map, static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(slope), static_cast<__nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(pre), splits > 1 ? partial : nullptr, B, Cin, Cout, T_out,
      slice);
  if (splits > 1)
    launch_splitk_epilogue<__nv_bfloat16>(partial, bias, slope, y, pre, M * Cout, Cout,
                                          T_out, splits, stream);
  return (int)cudaGetLastError();
}

template <int S>
int launch_stride(const void* x, const void* w, const void* bias, const void* slope, void* y,
                  void* pre, float* partial, int m_tiles, int splits, int B, int Cin,
                  int T_in, int pitch, int Cout, int T_out, cudaStream_t stream) {
  if (T_out % Boxes<S>::ROWS != 0 || (long long)S * (T_out - 1) >= T_in)
    return (int)cudaErrorInvalidValue;
  switch (m_tiles) {
    case 1:
      return launch_wgmma<1, S>(x, w, bias, slope, y, pre, partial, splits, B, Cin, T_in,
                                pitch, Cout, T_out, stream);
    case 2:
      return launch_wgmma<2, S>(x, w, bias, slope, y, pre, partial, splits, B, Cin, T_in,
                                pitch, Cout, T_out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The wgmma route, bfloat16 only: x (B, Cin, T_in) with rows `pitch` elements apart
// (batch rows Cin * pitch apart; pitch % 8 == 0 and x 16-byte aligned, as TMA needs),
// w the padded weights with their taps permuted for the MMA fragments (the wrapper's
// `_wgmma_weights`), (Cout, Cin, 32), 16-byte aligned; stride 4 or 2. Needs Cout % 128
// == 0, T_out % 16 == 0 at stride 4 and T_out % 8 == 0 at stride 2, and B * T_out < 2^31;
// window samples at or past T_in read as 0. m_tiles (1 or 2) picks the block tile, 128
// m_tiles rows x 128 channels; splits the split-K slices, cut on whole ring stages of 4
// input channels (the wrapper allocates a float32 workspace of splits * B * Cout * T_out
// when > 1). bias may be null. Launches on `stream` and returns cudaGetLastError() (0 on
// success), or the error of building the tensor maps; it does not synchronise and
// allocates nothing.
extern "C" int conv1d_prelu_wgmma_launch(const void* x, const void* w, const void* bias,
                                         const void* slope, void* y, void* pre,
                                         void* partial, int m_tiles, int splits, int B,
                                         int Cin, int T_in, int pitch, int Cout, int T_out,
                                         int stride, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || T_out <= 0 || splits <= 0 || Cout % BN != 0 ||
      pitch < T_in || pitch % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 || (long long)B * T_out >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  switch (stride) {
    case 4:
      return launch_stride<4>(x, w, bias, slope, y, pre, ws, m_tiles, splits, B, Cin, T_in,
                              pitch, Cout, T_out, s);
    case 2:
      return launch_stride<2>(x, w, bias, slope, y, pre, ws, m_tiles, splits, B, Cin, T_in,
                              pitch, Cout, T_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
