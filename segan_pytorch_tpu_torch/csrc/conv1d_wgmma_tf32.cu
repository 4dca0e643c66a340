// Fused strided conv1d + bias + PReLU in fp32, by 3xTF32 on Hopper's warpgroup MMA
// (sm_90a).
//
// Replaces, on the fp32 main path, the TPU kernel `fused_conv1d_prelu` of
// segan_pytorch_tpu/ops/pallas/conv1d.py (`_pallas_conv_prelu`, `_kernel`), beside the
// kernels of csrc/conv1d_prelu.cu and csrc/conv1d_wgmma.cu, which compute the same
// function:
//     pre[b, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * x[b, ci, S t + k]
//     y = max(pre, 0) + slope[co] * min(pre, 0)
// fp32 in and out, (B, Cout, T_out); stride S = 4 or 2 (a template parameter), the 31
// taps padded to 32 (tap 31 zero); samples at or past T_in read as 0. It computes what
// conv1d_tf32_kernel (the mma.sync
// route) computes: every product as small(x) big(w) + big(x) small(w) + big(x) big(w),
// in that order, each operand's TF32 parts rounded to nearest (csrc/mma_tf32.cuh). The
// wrapper (ops/kernels/conv1d_prelu.py, `_route`) sends a call here by shape and x's
// layout.
//
// What bounds it on the H100: the operations. enc2..enc5 of SEGAN+'s generator each take
// 3 x 2 x 0.52 GFLOP of TF32 MMAs per 16384-sample chunk and layer (three products per
// fp32 product), over a contraction of Cin * 32 = 2048..16384, against 495 TFLOP/s of
// dense TF32. The mma.sync route reached 20-23 % of that bound at 64-300 chunks: it
// staged x between two barriers while its MMAs waited, every warp read both weight parts
// from L2 for every input channel, and m16n8k8 TF32 issues at the rate of m16n8k16 bf16.
//
// The design is csrc/conv1d_wgmma.cu's (the usual shape of a Hopper GEMM, as an implicit
// GEMM: M = B * T_out rows, N = Cout, depth Cin * 32), with what TF32 changes:
//   - A block is two consumer warpgroups of one m64 tile each (a 128 x 128 block tile)
//     and one producer warp, whose one thread keeps a ring of STAGES stages full: 288
//     threads, one block per SM, up to 224 registers a consumer thread.
//   - A stage holds CC input channels: both TF32 parts of their weights, w_big then
//     w_small, one TMA box of 32 taps (128 bytes, the swizzle's span) x 128 output
//     channels per part and channel, with the 128-byte swizzle, from one 2-D map of each
//     part (Cout, Cin * 32), K-major as TF32 wgmma needs for an operand in shared memory;
//     and the x windows of each m16 group from a 3-D map of x with rows `pitch` apart, as
//     csrc/conv1d_wgmma.cu stages them: at stride 4 WIN = 96 fp32 samples of each channel
//     from 4 t0 (one box {96, CC, 1}), at stride 2 one box {WIN_HALF = 48, CC, 1} for each
//     8-row half from 2 t of its first row, so that T_out % 8 == 0 is enough (TMA fills
//     samples at or past T_in, and channels past Cin, with zeros).
//   - The weights are the mma.sync route's, padded to 32 taps and split by the wrapper
//     once per weight and version (`_padded_weights`: one copy for both fp32 routes, and
//     none made for this one). The taps stay in their order: 8-deep step s of a channel
//     takes taps 8 s + 0..7 at contraction index 0..7, so it reads 32 contiguous bytes
//     of each weight row (the descriptor moves by 32 bytes in the span), and a lane's A
//     values of row r (indices t and t + 4, the wgmma k8 A layout: {(g, t), (g + 8, t),
//     (g, t + 4), (g + 8, t + 4)}) are samples S r + 8 s + t and S r + 8 s + t + 4 of the
//     window (row g + 8 in the other half's box at stride 2), four 4-byte loads a step,
//     free of bank conflicts at either stride.
//   - x is split into its TF32 parts as its fragments are loaded (cvt.rna, sub, cvt.rna),
//     as the mma.sync route does (a split at staging measured 4-9 % slower there).
//   - Fresh-register partial sums. The tensor cores' own fp32 sums do not round to
//     nearest: one accumulator over enc5's 16384-deep contraction drifted 1.2e-4 from
//     float64 at batch 300 on the H100, over the 1e-4 limit. So the 12 wgmma
//     m64n128k8 of a channel (4 steps x 3 products) sum into a zeroed accumulator (scale-d
//     0 on the first), and that partial sum is added to the running sums with fp32 adds,
//     which round to nearest, once per input channel. A channel is one commit group,
//     waited for before its fold; the other warpgroup's MMAs fill the tensor cores
//     meanwhile. The fresh sums double the accumulator registers (64 + 64 fp32 a thread),
//     hence one m64 tile per warpgroup, where the bf16 kernel takes two.
//   - Epilogue: bias and PReLU in registers; y and pre through shared memory (the ring,
//     once both consumers are done with it), 16 bytes a lane. Split-K (the deep, short
//     layers at small batch) writes fp32 partial sums to the wrapper's workspace, and
//     csrc/splitk_epilogue.cuh adds them in a fixed order.
// The tensor maps are built by the C entry point on every launch and passed as
// __grid_constant__ parameters, so a CUDA graph records them with the launch
// (csrc/tma_ring.cuh). tests/test_torch_conv1d_wgmma_tf32.py emulates these index maps,
// the split and the folds in float64.

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "mma_tf32.cuh"
#include "splitk_epilogue.cuh"
#include "tma_ring.cuh"

namespace {

using conv_epilogue::launch_splitk_epilogue;
using mma_conv::KP;      // taps, padded by the wrapper
using mma_conv::prelu;
using mma_conv::split_tf32;
using namespace tma_ring;

constexpr int BN = 128;         // output channels per block: the MMA's N
constexpr int CC = 2;           // input channels per ring stage
constexpr int STAGES = 3;       // ring stages
constexpr int WIN = 96;         // stride 4: staged samples per m16 group and channel (92 read)
constexpr int WIN_HALF = 48;    // stride 2: the same per 8-row half (46 read)
constexpr int STEPS = 4;        // 8-deep steps per channel
constexpr int W_BOX_BYTES = KP * 4 * BN;           // one part of one channel: 16 KB
constexpr int W_STAGE_BYTES = 2 * CC * W_BOX_BYTES;  // w_big's boxes, then w_small's
constexpr int X_GROUP_BYTES = CC * WIN * 4;        // one m16 group's windows of a stage
constexpr int CONSUMERS = 2;    // warpgroups that issue MMAs, one m64 tile each
constexpr int GROUPS = CONSUMERS * 4;              // m16 groups per block
constexpr int TILE_M = GROUPS * 16;
constexpr int THREADS = 128 * CONSUMERS + 32;      // and one producer warp
constexpr int STAGE_BYTES = W_STAGE_BYTES + GROUPS * X_GROUP_BYTES;
constexpr int OUT_LD = 16 + 4;  // a channel's 16 rows in the epilogue tile, padded
static_assert(STEPS * 8 == KP, "a channel's taps in 8-deep steps");
static_assert(WIN % 4 == 0 && X_GROUP_BYTES % 128 == 0, "16-byte rows, aligned groups");
static_assert(STAGE_BYTES % 1024 == 0, "each stage's weight boxes 1024-byte aligned");
static_assert(GROUPS * BN * OUT_LD * 4 <= STAGES * STAGE_BYTES, "epilogue tiles in the ring");

// The x windows of stride S (csrc/tma_ring.cuh), and the block's shared memory at S:
// the ring, 2 STAGES barriers, (b, S t) of each box; 1 KB of slack to align the ring
template <int S>
using Boxes = XBoxes<S, CC, WIN, WIN_HALF, 4>;
template <int S>
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 +
                     GROUPS * Boxes<S>::PER_GROUP * 8;
static_assert(SMEM<2> <= 232448, "a block's shared memory");

// d (64 x 128, fp32, the m64nNk8 accumulator layout) = a (64 x 8, TF32, registers: warp
// w holds rows 16 w + 0..15, lane (g, t) {(g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)})
// * B (8 x 128, TF32, K-major in shared memory, `desc`) + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc, int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// x_map: x (B, Cin, T_in), rows `pitch` apart, boxes {Boxes<S>::SAMPLES, CC, 1}; wb_map,
// ws_map: the padded weights' TF32 parts (Cout, Cin * 32), boxes {KP, BN}, 128-byte
// swizzle. `slice` input channels (a multiple of CC) per split-K slice (blockIdx.z);
// partial, when not null, takes fp32 partial sums. y and pre must be 16-byte aligned;
// Cout % BN == 0, T_out % Boxes<S>::ROWS == 0 (16 at stride 4, 8 at stride 2).
template <int S>
__global__ void __launch_bounds__(THREADS, 1)
conv1d_wgmma_tf32_kernel(const __grid_constant__ CUtensorMap x_map,
                         const __grid_constant__ CUtensorMap wb_map,
                         const __grid_constant__ CUtensorMap ws_map,
                         const float* __restrict__ bias, const float* __restrict__ slope,
                         float* __restrict__ y, float* __restrict__ pre,
                         float* __restrict__ partial, int B, int Cin, int Cout, int T_out,
                         int slice) {
  using X = Boxes<S>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const uint32_t full = ring + STAGES * STAGE_BYTES;  // full[s] at full + 8 s
  const uint32_t empty = full + STAGES * 8;           // empty[s] at empty + 8 s
  int2* const coord = reinterpret_cast<int2*>(ring_ptr + STAGES * STAGE_BYTES +
                                              2 * STAGES * 8);

  const int M = B * T_out;  // the entry point checks that it fits
  const int m0 = blockIdx.x * TILE_M;
  const int n0 = blockIdx.y * BN;
  const int c_begin = blockIdx.z * slice;
  const int c_end = min(Cin, c_begin + slice);
  const int iters = (c_end - c_begin + CC - 1) / CC;
  const int live_boxes = min(GROUPS * X::PER_GROUP, (M - m0) / X::ROWS);  // M % ROWS == 0
  const int live_groups = (live_boxes + X::PER_GROUP - 1) / X::PER_GROUP;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's expect_tx
      mbar_init(empty + 8 * s, CONSUMERS * 4);      // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < GROUPS * X::PER_GROUP) {  // box j's window: batch row b, first sample S t of its row 0
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
        const uint32_t st = ring + s * STAGE_BYTES;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          tma_load_2d(st + c * W_BOX_BYTES, &wb_map, (c0 + c) * KP, n0, full + 8 * s);
          tma_load_2d(st + (CC + c) * W_BOX_BYTES, &ws_map, (c0 + c) * KP, n0, full + 8 * s);
        }
        for (int j = 0; j < live_boxes; ++j) {
          const int2 bt = coord[j];
          tma_load_3d(st + W_STAGE_BYTES + j * X::BYTES, &x_map, bt.y, c0, bt.x,
                      full + 8 * s);
        }
      }
    }
  } else {  // a consumer warpgroup: rows 64 wg + 16 warp + 0..15 of the tile
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int q = wg * 4 + warp;  // this warp's m16 group
    float acc[64], part[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = part[e] = 0.f;

    if (wg * 4 >= live_groups) {  // no live row: release each stage as it fills
      for (int k = 0; k < iters; ++k) {
        mbar_wait(full + 8 * (k % STAGES), (k / STAGES) & 1);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * (k % STAGES));
      }
    } else {
      // Per channel: its A fragments (both TF32 parts of x, 32 registers a lane), its 12
      // MMAs into the fresh sums as one commit group, waited for, then folded. Every warp
      // of the warpgroup issues the MMAs (they are warpgroup-wide); rows past M are not
      // stored (at stride 2 a group's second half past M is not loaded either: its rows
      // read what the stage held, and no row of theirs is stored).
      for (int k = 0; k < iters; ++k) {
        const int s = k % STAGES;
        mbar_wait(full + 8 * s, (k / STAGES) & 1);
        const float* xs = reinterpret_cast<const float*>(ring_ptr + s * STAGE_BYTES +
                                                         W_STAGE_BYTES + q * X_GROUP_BYTES);
        const uint32_t ws = ring + s * STAGE_BYTES;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          uint32_t ab[STEPS][4], as[STEPS][4];
#pragma unroll
          for (int st = 0; st < STEPS; ++st) {
            // row g at step st: samples S g + 8 st + t and t + 4 of its box; row g + 8
            // ROW8 elements on
            const float* p = xs + c * X::SAMPLES + S * g + 8 * st + t;
            split_tf32(p[0], ab[st][0], as[st][0]);
            split_tf32(p[X::ROW8], ab[st][1], as[st][1]);
            split_tf32(p[4], ab[st][2], as[st][2]);
            split_tf32(p[X::ROW8 + 4], ab[st][3], as[st][3]);
          }
          fence_regs(part);
          wgmma_fence();
#pragma unroll
          for (int st = 0; st < STEPS; ++st) {
            // channel c's taps of step st: bytes 32 st of each row of its two boxes
            const uint64_t w_big = desc_sw128(ws + c * W_BOX_BYTES + 32 * st);
            const uint64_t w_small = desc_sw128(ws + (CC + c) * W_BOX_BYTES + 32 * st);
            wgmma_m64n128k8_tf32(part, as[st], w_big, st > 0);  // the first from zero
            wgmma_m64n128k8_tf32(part, ab[st], w_small, 1);
            wgmma_m64n128k8_tf32(part, ab[st], w_big, 1);
          }
          wgmma_commit();
          wgmma_wait_all();
          fence_regs(part);
#pragma unroll
          for (int e = 0; e < 64; ++e) acc[e] += part[e];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // The accumulator: lane (g, t) holds rows 16 warp + g (+ 8 for e >= 2) and channels
    // 8 j + 2 t + (e & 1) in acc[4 j + e], j = 0..15. A group's second half is live when
    // its box is (at stride 4 always with the group).
    const long long base0 = q < live_groups ? X::half_base(coord, q, 0, Cout, T_out) : 0;
    const long long base8 = q < live_groups ? X::half_base(coord, q, 1, Cout, T_out) : 0;
    const bool live8 = q * X::PER_GROUP + X::PER_GROUP - 1 < live_boxes;
    if (partial != nullptr) {  // split-K: fp32 partial sums; the epilogue kernel finishes
      if (q < live_groups) {
        float* const out = partial + (long long)blockIdx.z * M * Cout;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < 2 || live8)
              out[(e < 2 ? base0 : base8) + g +
                  (long long)(n0 + 8 * j + 2 * t + (e & 1)) * T_out] = acc[4 * j + e];
      }
      return;
    }
    // y and pre through shared memory: once both consumers are done with the ring, each
    // warp puts its m16 group's 128 channels x 16 rows there, then writes 16 bytes a lane
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    float* const tile = reinterpret_cast<float*>(ring_ptr) + (threadIdx.x / 32) * BN * OUT_LD;
    if (q < live_groups) {
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {  // pre, then y
        float* const out = pass == 0 ? pre : y;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = 8 * j + 2 * t + (e & 1);
            const float p = acc[4 * j + e] + (bias != nullptr ? bias[n0 + cl] : 0.f);
            tile[cl * OUT_LD + g + 8 * (e >> 1)] = pass == 0 ? p : prelu(p, slope[n0 + cl]);
          }
        __syncwarp();
        // 128 channels x 4 quarters of 4 rows (two a half): lane l of step u takes unit
        // 32 u + l
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          const int unit = 32 * u + lane;
          const int cl = unit >> 2;
          const int quarter = unit & 3;
          if (quarter < 2 || live8)
            *reinterpret_cast<float4*>(out + (quarter < 2 ? base0 : base8) +
                                       (long long)(n0 + cl) * T_out + 4 * (quarter & 1)) =
                *reinterpret_cast<const float4*>(tile + cl * OUT_LD + 4 * quarter);
        }
        __syncwarp();  // the tile is read before the next pass writes it
      }
    }
  }
}

template <int S>
int launch_tf32(const void* x, const void* w_big, const void* w_small, const void* bias,
                const void* slope, void* y, void* pre, float* partial, int splits, int B,
                int Cin, int T_in, int pitch, int Cout, int T_out, cudaStream_t stream) {
  using X = Boxes<S>;
  if (T_out % X::ROWS != 0 || (long long)S * (T_out - 1) >= T_in)
    return (int)cudaErrorInvalidValue;
  // input channels per split, whole ring stages, no empty slice
  const int slice = ((Cin + splits - 1) / splits + CC - 1) / CC * CC;
  splits = (Cin + slice - 1) / slice;
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;

  CUtensorMap x_map, wb_map, ws_map;
  cudaError_t err = encode_x_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, x, B, Cin, T_in,
                                 pitch, X::SAMPLES, CC);
  if (err == cudaSuccess)
    err = encode_w_map(&wb_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w_big, Cout, Cin * KP,
                       KP, BN);
  if (err == cudaSuccess)
    err = encode_w_map(&ws_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, w_small, Cout, Cin * KP,
                       KP, BN);
  if (err != cudaSuccess) return (int)err;
  static bool sized[MAX_DEVICES] = {};
  err = size_smem_once(conv1d_wgmma_tf32_kernel<S>, SMEM<S>, sized);
  if (err != cudaSuccess) return (int)err;
  const long long M = (long long)B * T_out;
  const dim3 grid((unsigned)((M + TILE_M - 1) / TILE_M), (unsigned)(Cout / BN),
                  (unsigned)splits);
  conv1d_wgmma_tf32_kernel<S><<<grid, THREADS, SMEM<S>, stream>>>(
      x_map, wb_map, ws_map, static_cast<const float*>(bias), static_cast<const float*>(slope),
      static_cast<float*>(y), static_cast<float*>(pre), splits > 1 ? partial : nullptr, B,
      Cin, Cout, T_out, slice);
  if (splits > 1)
    launch_splitk_epilogue<float>(partial, bias, slope, y, pre, M * Cout, Cout, T_out, splits,
                                  stream);
  return (int)cudaGetLastError();
}

}  // namespace

// The wgmma route in fp32 (3xTF32): x (B, Cin, T_in) with rows `pitch` elements apart
// (batch rows Cin * pitch apart; pitch % 4 == 0 and x 16-byte aligned, as TMA needs),
// w_big and w_small the TF32 parts of the weights padded to 32 taps, (Cout, Cin, 32) each
// (the wrapper's `_padded_weights`, as conv1d_prelu_tf32_launch takes them), 16-byte
// aligned; y and pre 16-byte aligned; stride 4 or 2. Needs Cout % 128 == 0, T_out % 16
// == 0 at stride 4 and T_out % 8 == 0 at stride 2, and B * T_out < 2^31; window samples
// at or past T_in read as 0. m_tiles must be 1 (the block tile, 128 rows x 128
// channels); splits the split-K slices, cut on whole ring stages of 2 input channels (the
// wrapper allocates a float32 workspace of splits * B * Cout * T_out when > 1). bias may
// be null. Launches on `stream` and returns cudaGetLastError() (0 on success), or the
// error of building the tensor maps; it does not synchronise and allocates nothing.
extern "C" int conv1d_prelu_wgmma_tf32_launch(const void* x, const void* w_big,
                                              const void* w_small, const void* bias,
                                              const void* slope, void* y, void* pre,
                                              void* partial, int m_tiles, int splits, int B,
                                              int Cin, int T_in, int pitch, int Cout,
                                              int T_out, int stride, void* stream) {
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16; };
  if (m_tiles != 1 || B <= 0 || Cin <= 0 || Cout <= 0 || T_out <= 0 || splits <= 0 ||
      Cout % BN != 0 || pitch < T_in || pitch % 4 != 0 || misaligned(x) ||
      misaligned(w_big) || misaligned(w_small) || misaligned(y) || misaligned(pre) ||
      (long long)B * T_out >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  float* const ws = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stride) {
    case 4:
      return launch_tf32<4>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin, T_in,
                            pitch, Cout, T_out, s);
    case 2:
      return launch_tf32<2>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin, T_in,
                            pitch, Cout, T_out, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
