// Chained enc2 + enc3 of the SEGAN+ generator encoder for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_enc23_fwd` of
// segan_pytorch_tpu/ops/pallas/encoder_fused.py:112 (`_kernel` :81): two GConv1DBlocks,
// each a reflect pad (14, 15) then a stride-4, 31-tap conv + bias + PReLU, in one launch,
// with enc2's post-activation kept on chip:
//     pre2 = conv(reflect_pad(h1), w2) + b2      post2 = PReLU(pre2, a2)
//     pre3 = conv(reflect_pad(post2), w3) + b3   post3 = PReLU(pre3, a3)
// h1 is enc1's post-activation (B, C1, T1), unpadded; w2 (C2, C1, 31), w3 (C3, C2, 31);
// b2, b3 may be null (--no_bias). pre2 (B, C2, T1/4), pre3 and post3 (B, C3, T1/16) are
// written in h1's dtype (fp32 or bf16); sums are fp32. post2 is rounded to h1's dtype
// before enc3 reads it, as the TPU kernel rounds it.
//
// Three kernels; the wrapper (ops/kernels/encoder_fused.py, `_route`) picks one by dtype
// and shape, never as a fallback:
//   fp32, C2 % 8 == 0 and C3 % 8 == 0 (every SEGAN+ shape): enc23_tf32_kernel<TILE>, fp32
//     by 3xTF32 on the tensor cores (mma.sync m16n8k8), TILE 16 or 32 chosen by batch;
//   fp32, any other shape: enc23_kernel<float>, fp32 FMAs on the CUDA cores;
//   bf16: enc23_mma_kernel, bf16 tensor cores (mma.sync m16n8k16, fp32 sums).
//
// What bounds the work on the H100. At the SEGAN+ widths (64 -> 128 -> 256 channels,
// T1 = 4096 per 16384-sample chunk) each layer costs 2 * T_out * Cout * Cin * 31 = 0.52
// GFLOP per chunk against about 1 MB of activations in bf16: some 500 FLOP per byte, so
// the pair is bound by arithmetic (312 GFLOP at batch 300). Chaining saves only post2's
// round trip through device memory and the two reflect-padded copies, about 0.4 GB at
// batch 300 in bf16 (~0.13 ms at 3.35 TB/s).
//
// All three: one 256-thread block per (batch row, tile of TILE enc3 output rows), in
// no order; nothing passes between blocks. Phase A computes post2, for all C2 channels,
// on the real rows the tile's enc3 windows read, so enc2's halo is recomputed rather
// than read from a neighbour; post2 goes to shared memory in h1's dtype, and pre2 is
// stored only for the 4 * TILE rows the tile owns, so every pre2 row is written by one
// block. Phase B computes enc3's TILE rows x C3 channels from that shared memory and
// stores pre3 and post3.
//
// fp32 FMAs (enc23_kernel<float>). Both phases are implicit GEMMs in tiles of 32 rows x
// 128 channels over the weights' own depth order (ci-major, then 31 taps): each 16-deep
// stage is gathered through the reflect maps (a division by 31 per element) into shared
// memory, and every thread accumulates a 2 x 8 sub-tile with FMAs. The weights (1 + 4 MB)
// stay in the 50 MB L2. Bound by the FMA pipes and the unoverlapped staging (PERF.md).
//
// bf16 (enc23_mma_kernel). The wrapper pads w2 and w3 to 32 taps, tap 31 zero (as the
// Pallas kernel's _fold_weights does), so each input channel is two 16-deep MMA steps and
// no division by 31 is left. The reflect pads are applied once, while staging, so that
// every operand is a plain strided read of shared memory:
//   Phase A stages h1, a chunk of CC channels at a time, over the window of padded rows
//   [4 lo, 4 lo + WIN) that the tile's post2 rows read (reflected at T1, clamped past the
//   end where only discarded rows read). post2 lives in shared memory by padded row:
//   slot p holds padded post2 row 4 t0 + p; phase A writes the real rows, then one pass
//   fills the mirrored slots at either end of the sequence (reflect at T2) and zeroes the
//   slots no real row maps to, which only discarded rows and zero taps read.
//   In both phases the A operand of output row m, input channel ci and tap k is then
//   buf[ci][4 m + k]. Within a channel the contraction takes the taps in the order that
//   makes each lane's operands contiguous: lane quad t feeds taps 8 t + 4 h + {0..3} at
//   MMA step h, so its A fragment is one 8-byte shared load per row (bank-conflict free:
//   lane (g, t) reads 8-byte unit g + 2 t + const) and its B fragment for both steps is
//   one 16-byte load of the padded weights, read straight from L2 (w2 0.25 MB, w3 2 MB).
//   tests/test_torch_encoder_fused.py emulates exactly these index maps in float64.
//   Warps: phase A 2 x 4 warps of 80 rows x 32 channels (160 >= 156 rows), phase B 8
//   warps of 32 rows x 32 channels; the mainloop (warp_conv_mma, csrc/mma_bf16.cuh) is
//   shared with the per-layer kernel. One synchronous mainloop: no cp.async, TMA or wgmma,
//   so the L2 latency of the weight loads and the single-buffered h1 staging are what
//   bounds it next; every block reads all of w3 (2 MB) from L2, 4.8 GB at batch 300.
// Needs C2 % 8 == 0 and C3 % 8 == 0 (whole n8 tiles); C1 is free.
//
// fp32 on the tensor cores (enc23_tf32_kernel<TILE>). The fp32 limit against the plain
// version is 1e-4 relative and one TF32 product gives ~1e-3, so every product is taken
// in 3xTF32 by the per-layer fp32 kernel's mainloop, warp_conv_3xtf32 (csrc/mma_tf32.cuh,
// whose header has the error terms): each operand as a (big, small) pair of TF32 parts,
// three MMAs per product, and half a channel's MMAs summed in fresh registers and added
// with fp32 adds (the tensor cores' own sums truncate; enc3's depth is 128 x 32). The
// wrapper pads w2 and w3 to 32 taps and splits them once per weight and version; h1 and
// post2 are split in registers as their fragments are loaded. post2 stays fp32 and is not
// rounded (h1's dtype is fp32). The plan is enc23_mma_kernel's: h1 staged per chunk of
// channels over the window [4 lo, 4 lo + WIN), reflected at T1 while staging; post2 by
// padded slot, the mirror fill at T2 and zeroes where no real row maps; every A operand
// read as buf[ci][4 m + k]. What changes in fp32:
//   Registers. A warp's m16 tile costs 16 fp32 accumulators per 32 channels, and the
//   mainloop adds 16 partial sums, 32 registers of weight parts and the split A values,
//   inside the 128 registers that two blocks per SM allow. So phase A (2 x 4 warps, each
//   MA / 32 rows x 32 channels, as the bf16 kernel) runs its rows in passes of at most
//   PT = 3 m16 tiles, restaging h1 for each pass (two passes at TILE 32, one at 16);
//   phase B is 8 warps of TILE rows x 32 channels.
//   Shared memory: post2 in fp32 (C2 x SLOTS x 4 B, 80 KB at TILE 32) and an h1 chunk of
//   CC channels: 101 KB at TILE 32 (CC 8), 73 KB at TILE 16 (CC 16), so two blocks fit.
//   Tile by batch. At TILE 32 a chunk of one batch row is 8 blocks on 132 SMs. TILE 16
//   halves the rows per block and recomputes more of enc2's halo (92 post2 rows for 64
//   owned against 156 for 128: ~11 % more MMAs), so the wrapper takes it only where the
//   TILE 32 grid would leave SMs idle (B * ceil(T3 / 32) < SMs: B <= 16 at T1 = 4096).
//   What bounds it: the operations, 3 x 32/31 of the useful FLOPs in TF32 MMAs, and the
//   weight parts read from L2 by every block (w3's 8.4 MB in phase B, w2's 2.1 MB once
//   per row group and pass in phase A); no cp.async, TMA or wgmma.
// tests/test_torch_encoder_fused_tf32.py emulates these index maps and the split in
// float64, and reads the constants below.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using mma_conv::KP;  // 32 taps, padded by the wrapper
using mma_conv::NT;  // n8 tiles per warp (32 channels)
using mma_conv::prelu;
using mma_conv::warp_conv_3xtf32;
using mma_conv::warp_conv_mma;

constexpr int KW = 31;                             // taps, hard-coded as in the TPU kernel
constexpr int STRIDE = 4;
constexpr int PAD_L = KW / 2 - 1;                  // 14 (the right pad, 15, is implied)
constexpr int TILE = 32;                           // enc3 output rows per block
constexpr int ROWS2 = STRIDE * TILE + KW - STRIDE; // 155 post2 rows read by one tile
constexpr int BM = 32;                             // GEMM tile rows
constexpr int BN = 128;                            // GEMM tile channels
constexpr int BK = 16;                             // contraction depth per stage
constexpr int THREADS = 256;                       // 16 x 16 threads
constexpr int TM = BM / 16;                        // 2 rows per thread
constexpr int TN = BN / 16;                        // 8 channels per thread
constexpr int BS_LD = BN + 4;                      // keeps float4 rows 16-byte aligned
static_assert(TM == 2 && TN == 8, "the inner loop reads a float2 and two float4s");
static_assert(BK * BM == 2 * THREADS && BK * BN == 8 * THREADS, "stage load mapping");

// the bf16 kernel's constants
constexpr int SLOTS = STRIDE * TILE + KP - STRIDE; // 156 padded post2 rows one tile reads
constexpr int MA = 160;                            // phase A rows: 10 m16 tiles >= SLOTS
constexpr int WIN = STRIDE * (MA - 1) + KP;        // 668 padded h1 rows that they read
constexpr int CC = 16;                             // h1 channels staged at a time
constexpr int MTA = 5;                             // phase A: m16 tiles per warp (80 rows)
constexpr int MTB = TILE / 16;                     // phase B: m16 tiles per warp (32 rows)
static_assert(MA >= SLOTS && 2 * MTA * 16 == MA && THREADS == 256, "2 x 4 warps in phase A");
static_assert(SLOTS % 4 == 0 && WIN % 4 == 0, "8-byte aligned rows of shared memory");

// The fp32 tensor-core kernel's constants, by its tile of TILE enc3 rows per block: SLOTS
// padded post2 rows, MA phase A rows (whole m16 tiles, two rows of warps), WIN padded h1
// rows that they read, CC h1 channels staged at a time.
template <int TILE> struct Tf32Tile;
template <> struct Tf32Tile<16> {
  static constexpr int SLOTS = 92, MA = 96, WIN = 412, CC = 16;
};
template <> struct Tf32Tile<32> {
  static constexpr int SLOTS = 156, MA = 160, WIN = 668, CC = 8;
};
constexpr int PT = 3;  // phase A: m16 tiles per warp and pass

// The fp32 kernel's conversions: float only, so that nothing instantiates it for bf16.
__device__ __forceinline__ float to_float(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }

// torch's 'reflect' (and the JAX _reflect_pad_rows): mirror without repeating the edge.
// Valid for -n < r < 2n - 1.
__device__ __forceinline__ int reflect(int r, int n) {
  r = r < 0 ? -r : r;
  return r >= n ? 2 * n - 2 - r : r;
}

// acc = A (m_count x depth, gathered by load_a(m, d)) times W^T, where W is row-major
// (channels x depth) and this tile takes channels [n0, n0 + n_count). Rows and channels
// past the counts compute zeros.
template <typename T, typename LoadA>
__device__ __forceinline__ void gemm_tile(float (&acc)[TM][TN], const LoadA& load_a,
                                          int m_count, const T* __restrict__ w, int n0,
                                          int n_count, int depth, float (*As)[BM],
                                          float (*Bs)[BS_LD]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // rows tx * TM + i
  const int ty = tid / 16;   // channels ty * TN + j
  const int a_m = tid % BM;  // A stage: row a_m at depths a_k and a_k + 8
  const int a_k = tid / BM;
  const int b_k = tid % BK;  // W stage: depth b_k of channels b_n + 16 * j
  const int b_n = tid / BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < depth; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int kk = a_k + i * (THREADS / BM);
      const int d = k0 + kk;
      As[kk][a_m] = (a_m < m_count && d < depth) ? load_a(a_m, d) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int nn = b_n + j * (THREADS / BK);
      const int d = k0 + b_k;
      Bs[b_k][nn] =
          (nn < n_count && d < depth) ? to_float(w[(long long)(n0 + nn) * depth + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(&As[kk][tx * TM]);
      const float4 lo = *reinterpret_cast<const float4*>(&Bs[kk][ty * TN]);
      const float4 hi = *reinterpret_cast<const float4*>(&Bs[kk][ty * TN + 4]);
      const float av[TM] = {a.x, a.y};
      const float bv[TN] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
enc23_kernel(const T* __restrict__ h1, const T* __restrict__ w2, const T* __restrict__ b2,
             const T* __restrict__ a2, const T* __restrict__ w3, const T* __restrict__ b3,
             const T* __restrict__ a3, T* __restrict__ pre2, T* __restrict__ pre3,
             T* __restrict__ post3, int C1, int T1, int C2, int C3, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* post2 = reinterpret_cast<T*>(smem);  // [C2][ROWS2], row m is real post2 row lo + m
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BS_LD];

  const int T2 = T1 / STRIDE;
  const int T3 = T2 / STRIDE;
  const long long b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TILE;
  const int t_end = min(t0 + TILE, T3);
  // real post2 rows that the windows of enc3 rows [t0, t_end) read, reflections included
  const int lo = max(0, STRIDE * t0 - PAD_L);
  const int hi = min(T2 - 1, STRIDE * (t_end - 1) + KW - 1 - PAD_L);
  const int rows = hi - lo + 1;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* x = h1 + b * C1 * T1;
  float acc[TM][TN];

  // Phase A: enc2 on post2 rows [lo, hi]; pre2 only for the owned rows [4 t0, 4 t_end).
  const int depth2 = C1 * KW;
  for (int m0 = 0; m0 < rows; m0 += BM) {
    const auto load_h1 = [&](int m, int d) {
      const int ci = d / KW;
      const int k = d - ci * KW;
      const int r = reflect(STRIDE * (lo + m0 + m) + k - PAD_L, T1);
      return to_float(x[(long long)ci * T1 + r]);
    };
    for (int n0 = 0; n0 < C2; n0 += BN) {
      gemm_tile<T>(acc, load_h1, min(BM, rows - m0), w2, n0, min(BN, C2 - n0), depth2, As,
                   Bs);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int co = n0 + ty * TN + j;
        if (co >= C2) continue;
        const float bco = b2 != nullptr ? to_float(b2[co]) : 0.f;
        const float aco = to_float(a2[co]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = m0 + tx * TM + i;
          if (m >= rows) continue;
          const float p = acc[i][j] + bco;
          post2[co * ROWS2 + m] = from_float<T>(fmaxf(p, 0.f) + aco * fminf(p, 0.f));
          const int r = lo + m;
          if (r >= STRIDE * t0 && r < STRIDE * t_end)
            pre2[(b * C2 + co) * (long long)T2 + r] = from_float<T>(p);
        }
      }
    }
  }
  __syncthreads();  // post2 complete before phase B gathers from it

  // Phase B: enc3 on rows [t0, t_end) from post2 in shared memory.
  const int depth3 = C2 * KW;
  for (int m0 = t0; m0 < t_end; m0 += BM) {
    const auto load_post2 = [&](int m, int d) {
      const int ci = d / KW;
      const int k = d - ci * KW;
      const int r = reflect(STRIDE * (m0 + m) + k - PAD_L, T2);
      return to_float(post2[ci * ROWS2 + r - lo]);
    };
    for (int n0 = 0; n0 < C3; n0 += BN) {
      gemm_tile<T>(acc, load_post2, min(BM, t_end - m0), w3, n0, min(BN, C3 - n0), depth3,
                   As, Bs);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int co = n0 + ty * TN + j;
        if (co >= C3) continue;
        const float bco = b3 != nullptr ? to_float(b3[co]) : 0.f;
        const float aco = to_float(a3[co]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int t = m0 + tx * TM + i;
          if (t >= t_end) continue;
          const float p = acc[i][j] + bco;
          const long long off = (b * C3 + co) * (long long)T3 + t;
          pre3[off] = from_float<T>(p);
          post3[off] = from_float<T>(fmaxf(p, 0.f) + aco * fminf(p, 0.f));
        }
      }
    }
  }
}

// The bf16 kernel: w2 (C2, C1, KP) and w3 (C3, C2, KP), tap 31 zero. Dynamic shared
// memory: post2 [C2][SLOTS], then the h1 chunk [CC][WIN].
__global__ void __launch_bounds__(THREADS, 2)
enc23_mma_kernel(const __nv_bfloat16* __restrict__ h1, const __nv_bfloat16* __restrict__ w2,
                 const __nv_bfloat16* __restrict__ b2, const __nv_bfloat16* __restrict__ a2,
                 const __nv_bfloat16* __restrict__ w3, const __nv_bfloat16* __restrict__ b3,
                 const __nv_bfloat16* __restrict__ a3, __nv_bfloat16* __restrict__ pre2,
                 __nv_bfloat16* __restrict__ pre3, __nv_bfloat16* __restrict__ post3, int C1,
                 int T1, int C2, int C3, int tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* post2 = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = post2 + C2 * SLOTS;  // C2 % 8 == 0 keeps it 16-byte aligned

  const int T2 = T1 / STRIDE;
  const int T3 = T2 / STRIDE;
  const long long b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TILE;
  const int t_end = min(t0 + TILE, T3);
  const int p0 = STRIDE * t0 - PAD_L;  // the real post2 row of slot 0, before reflection
  // real post2 rows that land in slots [0, SLOTS); the mirrored ones are among them
  const int lo = max(0, p0);
  const int hi = min(T2 - 1, p0 + SLOTS - 1);
  const int rows = hi - lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16* x = h1 + b * C1 * T1;

  // Phase A: enc2 on post2 rows lo + m, m < rows, as 2 x 4 warps of 80 rows x 32 channels.
  const int ma0 = (warp / 4) * MTA * 16;
  const int mt_live_a = min(MTA, max(0, (rows - ma0 + 15) / 16));
  for (int nb = 0; nb < C2; nb += 4 * NT * 8) {
    const int n0 = nb + (warp % 4) * NT * 8;
    const int nt_live = min(NT, max(0, (C2 - n0) / 8));
    float acc[MTA][NT][4] = {};
    for (int c0 = 0; c0 < C1; c0 += CC) {
      const int cc = min(CC, C1 - c0);
      __syncthreads();  // the previous chunk is no longer read
      // padded h1 row STRIDE * lo + j of each channel, reflected at T1; rows past the
      // padded end are clamped: only discarded rows m >= rows read them
      for (int e = threadIdx.x; e < cc * WIN; e += THREADS) {
        const int c = e / WIN;
        const int j = e - c * WIN;
        const int r = min(max(reflect(STRIDE * lo + j - PAD_L, T1), 0), T1 - 1);
        xs[e] = x[(long long)(c0 + c) * T1 + r];
      }
      __syncthreads();
      if (mt_live_a > 0 && nt_live > 0)
        warp_conv_mma<MTA>(acc, xs, WIN, ma0, mt_live_a, w2 + c0 * KP, C1, n0, nt_live, cc);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = n0 + 8 * j + 2 * t + (e & 1);
        const float bco = b2 != nullptr ? __bfloat162float(b2[co]) : 0.f;
        const float aco = __bfloat162float(a2[co]);
#pragma unroll
        for (int i = 0; i < MTA; ++i) {
          const int m = ma0 + 16 * i + g + 8 * (e >> 1);
          if (m >= rows) continue;
          const float p = acc[i][j][e] + bco;
          const int r = lo + m;
          post2[co * SLOTS + r - p0] = __float2bfloat16(prelu(p, aco));
          if (r >= STRIDE * t0 && r < STRIDE * t_end)
            pre2[(b * C2 + co) * (long long)T2 + r] = __float2bfloat16(p);
        }
      }
    }
  }
  __syncthreads();  // every real row is in its slot
  // The other slots: mirrored rows at either end (reflect at T2), else zero.
  for (int co = warp; co < C2; co += THREADS / 32) {
    for (int s = lane; s < SLOTS; s += 32) {
      const int r = p0 + s;
      if (r >= lo && r <= hi) continue;
      const int src = r < 0 ? -r : 2 * T2 - 2 - r;
      post2[co * SLOTS + s] = src >= lo && src <= hi ? post2[co * SLOTS + src - p0]
                                                     : __float2bfloat16(0.f);
    }
  }
  __syncthreads();  // post2 complete before phase B reads it

  // Phase B: enc3 on rows t0 + m, m < t_end - t0, as 8 warps of 32 rows x 32 channels.
  const int mt_live_b = (t_end - t0 + 15) / 16;
  for (int nb = 0; nb < C3; nb += (THREADS / 32) * NT * 8) {
    const int n0 = nb + warp * NT * 8;
    const int nt_live = min(NT, max(0, (C3 - n0) / 8));
    if (nt_live <= 0) continue;
    float acc[MTB][NT][4] = {};
    warp_conv_mma<MTB>(acc, post2, SLOTS, 0, mt_live_b, w3, C2, n0, nt_live, C2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = n0 + 8 * j + 2 * t + (e & 1);
        const float bco = b3 != nullptr ? __bfloat162float(b3[co]) : 0.f;
        const float aco = __bfloat162float(a3[co]);
#pragma unroll
        for (int i = 0; i < MTB; ++i) {
          const int tt = t0 + 16 * i + g + 8 * (e >> 1);
          if (tt >= t_end) continue;
          const float p = acc[i][j][e] + bco;
          const long long off = (b * C3 + co) * (long long)T3 + tt;
          pre3[off] = __float2bfloat16(p);
          post3[off] = __float2bfloat16(prelu(p, aco));
        }
      }
    }
  }
}

// The fp32 tensor-core kernel: w2 and w3 as their TF32 parts (big, small), each (Cout,
// Cin, KP) with tap 31 zero. Dynamic shared memory: post2 [C2][SLOTS], then the h1 chunk
// [CC][WIN], both fp32.
template <int TILE>
__global__ void __launch_bounds__(THREADS, 2)
enc23_tf32_kernel(const float* __restrict__ h1, const float* __restrict__ w2_big,
                  const float* __restrict__ w2_small, const float* __restrict__ b2,
                  const float* __restrict__ a2, const float* __restrict__ w3_big,
                  const float* __restrict__ w3_small, const float* __restrict__ b3,
                  const float* __restrict__ a3, float* __restrict__ pre2,
                  float* __restrict__ pre3, float* __restrict__ post3, int C1, int T1,
                  int C2, int C3, int tiles) {
  using P = Tf32Tile<TILE>;
  constexpr int RT = P::MA / 32;  // phase A: m16 tiles per row of warps (3 or 5)
  constexpr int MTB = TILE / 16;  // phase B: m16 tiles per warp
  static_assert(P::SLOTS == STRIDE * TILE + KP - STRIDE && P::MA % 32 == 0 &&
                    P::MA >= P::SLOTS && P::MA - 16 < P::SLOTS &&
                    P::WIN == STRIDE * (P::MA - 1) + KP && THREADS == 256,
                "2 x 4 warps in phase A, whole m16 tiles over the slots");
  static_assert(P::SLOTS % 2 == 0 && P::WIN % 2 == 0,
                "8-byte aligned rows of shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  float* post2 = reinterpret_cast<float*>(smem);
  float* xs = post2 + C2 * P::SLOTS;  // C2 % 8 == 0 keeps it 16-byte aligned

  const int T2 = T1 / STRIDE;
  const int T3 = T2 / STRIDE;
  const long long b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x % tiles) * TILE;
  const int t_end = min(t0 + TILE, T3);
  const int p0 = STRIDE * t0 - PAD_L;  // the real post2 row of slot 0, before reflection
  // real post2 rows that land in slots [0, SLOTS); the mirrored ones are among them
  const int lo = max(0, p0);
  const int hi = min(T2 - 1, p0 + P::SLOTS - 1);
  const int rows = hi - lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float* x = h1 + b * C1 * T1;

  // Phase A: enc2 on post2 rows lo + m, m < rows, as 2 x 4 warps of RT m16 tiles x 32
  // channels, in passes of at most PT m16 tiles; h1 is staged anew for each pass.
  for (int nb = 0; nb < C2; nb += 4 * NT * 8) {
    const int n0 = nb + (warp % 4) * NT * 8;
    const int nt_live = min(NT, max(0, (C2 - n0) / 8));
    for (int pass = 0; pass * PT < RT; ++pass) {
      const int ma0 = ((warp / 4) * RT + pass * PT) * 16;
      const int mt_live = min(min(PT, RT - pass * PT), max(0, (rows - ma0 + 15) / 16));
      float acc[PT][NT][4] = {};
      for (int c0 = 0; c0 < C1; c0 += P::CC) {
        const int cc = min(P::CC, C1 - c0);
        __syncthreads();  // the previous chunk is no longer read
        // padded h1 row STRIDE * lo + j of each channel, reflected at T1; rows past the
        // padded end are clamped: only discarded rows m >= rows read them
        for (int e = threadIdx.x; e < cc * P::WIN; e += THREADS) {
          const int c = e / P::WIN;
          const int j = e - c * P::WIN;
          const int r = min(max(reflect(STRIDE * lo + j - PAD_L, T1), 0), T1 - 1);
          xs[e] = x[(long long)(c0 + c) * T1 + r];
        }
        __syncthreads();
        if (mt_live > 0 && nt_live > 0)
          warp_conv_3xtf32<PT>(acc, xs, P::WIN, ma0, mt_live, w2_big + c0 * KP,
                               w2_small + c0 * KP, C1, n0, nt_live, cc);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt_live) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int co = n0 + 8 * j + 2 * t + (e & 1);
          const float bco = b2 != nullptr ? b2[co] : 0.f;
          const float aco = a2[co];
#pragma unroll
          for (int i = 0; i < PT; ++i) {
            // tiles i >= mt_live belong to the next pass or to the next row of warps
            const int m = ma0 + 16 * i + g + 8 * (e >> 1);
            if (i >= mt_live || m >= rows) continue;
            const float p = acc[i][j][e] + bco;
            const int r = lo + m;
            post2[co * P::SLOTS + r - p0] = prelu(p, aco);
            if (r >= STRIDE * t0 && r < STRIDE * t_end)
              pre2[(b * C2 + co) * (long long)T2 + r] = p;
          }
        }
      }
    }
  }
  __syncthreads();  // every real row is in its slot
  // The other slots: mirrored rows at either end (reflect at T2), else zero.
  for (int co = warp; co < C2; co += THREADS / 32) {
    for (int s = lane; s < P::SLOTS; s += 32) {
      const int r = p0 + s;
      if (r >= lo && r <= hi) continue;
      const int src = r < 0 ? -r : 2 * T2 - 2 - r;
      post2[co * P::SLOTS + s] =
          src >= lo && src <= hi ? post2[co * P::SLOTS + src - p0] : 0.f;
    }
  }
  __syncthreads();  // post2 complete before phase B reads it

  // Phase B: enc3 on rows t0 + m, m < t_end - t0, as 8 warps of TILE rows x 32 channels.
  const int mt_live_b = (t_end - t0 + 15) / 16;
  for (int nb = 0; nb < C3; nb += (THREADS / 32) * NT * 8) {
    const int n0 = nb + warp * NT * 8;
    const int nt_live = min(NT, max(0, (C3 - n0) / 8));
    if (nt_live <= 0) continue;
    float acc[MTB][NT][4] = {};
    warp_conv_3xtf32<MTB>(acc, post2, P::SLOTS, 0, mt_live_b, w3_big, w3_small, C2, n0,
                          nt_live, C2);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = n0 + 8 * j + 2 * t + (e & 1);
        const float bco = b3 != nullptr ? b3[co] : 0.f;
        const float aco = a3[co];
#pragma unroll
        for (int i = 0; i < MTB; ++i) {
          const int tt = t0 + 16 * i + g + 8 * (e >> 1);
          if (tt >= t_end) continue;
          const float p = acc[i][j][e] + bco;
          const long long off = (b * C3 + co) * (long long)T3 + tt;
          pre3[off] = p;
          post3[off] = prelu(p, aco);
        }
      }
    }
  }
}

// Launches `kernel` on one block per (batch row, tile) with `smem` bytes of dynamic
// shared memory, which above 48 KB must be allowed explicitly, or the launch is refused.
template <typename T, typename Kernel>
int launch(Kernel kernel, size_t smem, const void* h1, const void* w2, const void* b2,
           const void* a2, const void* w3, const void* b3, const void* a3, void* pre2,
           void* pre3, void* post3, int B, int C1, int T1, int C2, int C3,
           cudaStream_t stream) {
  const int T3 = T1 / (STRIDE * STRIDE);
  const int tiles = (T3 + TILE - 1) / TILE;
  const long long blocks = (long long)B * tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that a later launch does not report it
    return (int)err;
  }
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(a2), static_cast<const T*>(w3), static_cast<const T*>(b3),
      static_cast<const T*>(a3), static_cast<T*>(pre2), static_cast<T*>(pre3),
      static_cast<T*>(post3), C1, T1, C2, C3, tiles);
  return (int)cudaGetLastError();
}

// enc23_tf32_kernel<TILE> on one block per (batch row, tile), as `launch`.
template <int TILE>
int launch_tf32(const void* h1, const void* w2_big, const void* w2_small, const void* b2,
                const void* a2, const void* w3_big, const void* w3_small, const void* b3,
                const void* a3, void* pre2, void* pre3, void* post3, int B, int C1, int T1,
                int C2, int C3, cudaStream_t stream) {
  using P = Tf32Tile<TILE>;
  const int T3 = T1 / (STRIDE * STRIDE);
  const int tiles = (T3 + TILE - 1) / TILE;
  const long long blocks = (long long)B * tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)C2 * P::SLOTS + P::CC * P::WIN) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      enc23_tf32_kernel<TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that a later launch does not report it
    return (int)err;
  }
  enc23_tf32_kernel<TILE><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(h1), static_cast<const float*>(w2_big),
      static_cast<const float*>(w2_small), static_cast<const float*>(b2),
      static_cast<const float*>(a2), static_cast<const float*>(w3_big),
      static_cast<const float*>(w3_small), static_cast<const float*>(b3),
      static_cast<const float*>(a3), static_cast<float*>(pre2), static_cast<float*>(pre3),
      static_cast<float*>(post3), C1, T1, C2, C3, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, w2 (C2, C1, 31) and w3 (C3, C2, 31), the FMA kernel; 1 = bfloat16,
// w2 (C2, C1, 32) and w3 (C3, C2, 32) with tap 31 zero, C2 % 8 == 0 and C3 % 8 == 0, the
// MMA kernel. b2 and b3 may be null. Needs T1 % 16 == 0 and T1 >= 64 (the reflect pad of
// 15 needs T1 / 4 >= 16). Launches on `stream` and returns the cudaError_t (0 on
// success); it does not synchronise and allocates nothing.
extern "C" int encoder_fused_launch(int dtype, const void* h1, const void* w2,
                                    const void* b2, const void* a2, const void* w3,
                                    const void* b3, const void* a3, void* pre2, void* pre3,
                                    void* post3, int B, int C1, int T1, int C2, int C3,
                                    void* stream) {
  if (B <= 0 || C1 <= 0 || C2 <= 0 || C3 <= 0 || T1 % (STRIDE * STRIDE) != 0 || T1 < 64)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(enc23_kernel<float>, (size_t)C2 * ROWS2 * sizeof(float), h1, w2,
                           b2, a2, w3, b3, a3, pre2, pre3, post3, B, C1, T1, C2, C3, s);
    case 1:
      if (C2 % 8 != 0 || C3 % 8 != 0) return (int)cudaErrorInvalidValue;
      return launch<__nv_bfloat16>(enc23_mma_kernel,
                                   ((size_t)C2 * SLOTS + CC * WIN) * sizeof(__nv_bfloat16),
                                   h1, w2, b2, a2, w3, b3, a3, pre2, pre3, post3, B, C1, T1,
                                   C2, C3, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fp32 tensor-core route, by 3xTF32: w2 and w3 given as their TF32 parts, each
// (Cout, Cin, 32) with tap 31 zero and 16-byte aligned; tile (16 or 32) enc3 rows per
// block. Needs C2 % 8 == 0, C3 % 8 == 0, T1 % 16 == 0 and T1 >= 64; b2 and b3 may be
// null. As encoder_fused_launch, it launches on `stream`, returns the cudaError_t (0 on
// success), does not synchronise and allocates nothing.
extern "C" int encoder_fused_tf32_launch(const void* h1, const void* w2_big,
                                         const void* w2_small, const void* b2,
                                         const void* a2, const void* w3_big,
                                         const void* w3_small, const void* b3,
                                         const void* a3, void* pre2, void* pre3,
                                         void* post3, int tile, int B, int C1, int T1,
                                         int C2, int C3, void* stream) {
  if (B <= 0 || C1 <= 0 || C2 <= 0 || C3 <= 0 || T1 % (STRIDE * STRIDE) != 0 || T1 < 64 ||
      C2 % 8 != 0 || C3 % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile) {
    case 16:
      return launch_tf32<16>(h1, w2_big, w2_small, b2, a2, w3_big, w3_small, b3, a3, pre2,
                             pre3, post3, B, C1, T1, C2, C3, s);
    case 32:
      return launch_tf32<32>(h1, w2_big, w2_small, b2, a2, w3_big, w3_small, b3, a3, pre2,
                             pre3, post3, B, C1, T1, C2, C3, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
