// Fused strided conv1d + bias + PReLU for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_conv1d_prelu` of
// segan_pytorch_tpu/ops/pallas/conv1d.py (`_pallas_conv_prelu`, `_kernel`): the conv +
// bias + PReLU of every SEGAN generator encoder layer. It computes
//     pre[b, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * x[b, ci, t*stride + k]
//     y = max(pre, 0) + slope[co] * min(pre, 0)
// and writes BOTH y and pre, because the generator's skips carry the pre-activation.
// x is already reflect-padded, in torch's (B, Cin, T_in) layout with rows `pitch`
// elements apart (pitch >= T_in: G pads into rows of a multiple of 8 samples, the layout
// TMA reads); w is (Cout, Cin, K); y and pre are (B, Cout, T_out). Sums are fp32; inputs
// and outputs are fp32 or bf16.
//
// What bounds it on the H100. On the main path (K=31, stride 4, 16384-sample chunks)
// enc2..enc5 each cost about 0.52 GFLOP per chunk over a deep contraction
// (Cin*K = 1984..15872), so they are bound by arithmetic. enc1 has Cin=1: a depth of 31
// against 64 outputs is about 15 FLOP per byte moved, so it is bound by memory
// bandwidth (writing y and pre). Deep layers have few output rows per chunk (enc5: 16),
// which starves a kernel that tiles one chunk at a time. Generator1D's encoder (K=31,
// stride 2, 11 layers, Cout 16..1024) is alike: its first layer bound by bytes, the rest
// by arithmetic (about 0.13 GFLOP per chunk and layer, the last 0.26).
//
// Three kernels; the wrapper (ops/kernels/conv1d_prelu.py, `_route`) picks one of them,
// or csrc/conv1d_wgmma.cu's, by shape, dtype and x's layout. Stride 4 or 2 (a template
// parameter), K <= 32, Cout % 8 == 0 and T_out % 16 == 0 (every main-path layer, and
// Generator1D's but its last) take the tensor cores:
//   conv1d_mma_kernel: bf16, on mma.sync m16n8k16, where the wgmma kernel does not
//     take the call (few rows, Cout under 128, or x in rows TMA cannot read);
//   conv1d_tf32_kernel: fp32, by 3xTF32 on mma.sync m16n8k8;
//   conv1d_prelu_kernel<T>: every other shape, and enc1 (Cin = 1) at few rows, on fp32
//     FMAs.
//
// All are implicit GEMMs: M = B*T_out rows (batch and time flattened, so enc5's 16 rows
// per chunk still fill the tiles), N = Cout, depth Cin*K. The Pallas kernel folds the
// stride into channels (space-to-depth) to feed the TPU's MXU; that is a TPU layout trick
// and is not carried over.
//
// conv1d_prelu_kernel<T> (FMAs). Each thread gathers its row's taps straight from x in
// the weights' own depth order (ci-major, then k; the window overlaps between
// neighbouring rows and stays in L1). A 64x64 output tile per 256-thread block; each
// stage stages a 16-deep slice of x and w in shared memory, converted to fp32, and every
// thread accumulates a 4x4 sub-tile with FMAs. Ragged edges in M, N and depth are masked,
// so any T_out, Cin (including 1) and stride is taken.
//
// conv1d_mma_kernel (tensor cores; the design of enc23_mma_kernel in encoder_fused.cu).
// The wrapper pads w to 32 taps, tap 31 zero, so each input channel is two 16-deep MMA
// steps and the A operand of row t, channel ci and tap k is x[b][ci][S t + k] (stride S,
// 4 or 2), with no division by 31. Every T_out is a multiple of 16, so an m16 group of
// rows lies in one chunk b. Staging is per m16 group, whatever the tile: group q (rows
// from t0) gets a window of W samples of each channel, x[b][ci][S t0 + j]: at stride 4
// WG = 96 (4*15 + 32 = 92 are read, padded to 16 bytes), at stride 2 WG_S2 = 64 (62
// read). So tiles that span chunks (enc4, enc5) take the same path as tiles inside one
// (at a cost of 96 staged samples per 64 rows, against 64 + 28 for a contiguous window).
// Samples at or past T_in are staged as 0: the zero tap 31 of the last row reads sample
// S (T_out - 1) + 31, which is T_in when (T_in - 31) % S == 0, and a staged slot must be
// finite even where a zero weight multiplies it (0 x NaN = NaN).
// Staging takes STAGED = 128 group windows at a time (CC = 128 / groups channels, 24 KB);
// each thread stages fixed window positions of every channel of the chunk, so that its
// loads are independent and its address arithmetic is done once.
// The mainloop is warp_conv_mma (csrc/mma_bf16.cuh): lane quad t takes taps 8t + 4h +
// 0..3 at step h, one 8-byte shared-memory load per A row (two 4-byte loads at stride 2,
// where a row's window starts on odd samples) and one 16-byte __ldg of the padded weights
// per channel (from L2) for both steps. Each warp computes 64 rows x 32 channels; the 8
// warps of a block are laid out warps_m x (8 / warps_m), chosen by the wrapper: 4 x 2
// (256 rows x 64 channels) for Cout <= 64 (enc1), 2 x 4 (128 x 128) for Cout <= 128
// (enc2), else 1 x 8 (64 x 256), which stages the least x per MMA; at stride 2 8 x 1
// (512 x 32) for Cout <= 32 (Generator1D's first three layers), so no warp idles.
// The epilogue adds the bias (none under --no_bias), applies the PReLU and stores y and
// pre in bf16. A fragment holds 2 channels x 2 time steps, so stores straight from it
// would write 2 bytes a lane; each warp passes its 64 x 32 tile through shared memory
// instead and writes 16 bytes a lane (enc1, which only writes, is bound by these stores).
// One synchronous mainloop (no cp.async, TMA or wgmma), 2 blocks per SM: the staging of
// x is not overlapped with the MMAs of the same block; csrc/conv1d_wgmma.cu is the design
// for this card, with these index maps. tests/test_torch_conv1d_mma.py emulates them in
// float64.
//
// conv1d_tf32_kernel (fp32 on the tensor cores). The fp32 limit against the plain
// version is 1e-4 relative, and one TF32 product (10 mantissa bits) gives about 1e-3, so
// each operand is split into two TF32 parts and every product takes three MMAs
// (mainloop warp_conv_3xtf32, csrc/mma_tf32.cuh; its header has the error terms). What
// bounds it: on enc2..enc5 the operations, 3 x 2 x 0.52 GFLOP of TF32 MMAs per chunk and
// layer, 6x the MMA instructions of the bf16 kernel (m16n8k8 TF32 issues at the rate of
// m16n8k16 bf16); on enc1 the bytes, y and pre now in fp32. The design keeps the bf16
// kernel's plan (per m16 group windows of 96 samples, zero at or past T_in, warps of 64
// rows x 32 channels, the same block tiles and split-K) and gives the extra MMAs the
// issue slots: the weights are split once by the wrapper (`_padded_weights` keeps the
// (big, small) pair per weight and version), x is split in registers as its fragments
// are loaded (one cvt, sub, cvt per value for three MMAs, and one staged plane); splitting
// w in registers or x at staging measured 4-9 % slower at B >= 64. The
// tensor cores' own fp32 sums are not rounded to nearest (one accumulator over enc5's
// depth drifted 1.2e-4 from float64 on the H100), so each m16 tile sums half a channel
// in fresh registers and adds that to its accumulators with fp32 adds. The tap
// order follows m16n8k8's fragments: step s of a channel takes taps 8t + 2s and
// 8t + 2s + 1 at contraction index t and t + 4, so a row's A values are one 8-byte load
// and a channel's B values two 16-byte loads of each part. Staging takes STAGED_TF32 = 64
// group windows at a time (24 KB of static shared memory, 2 blocks per SM). y and pre are
// stored straight from the fragments: in fp32 the 8 lanes that hold one channel's 8
// consecutive time steps fill a 32-byte sector, so the bf16 kernel's pass through shared
// memory is not needed (tools/conv1d_mma_ab.py measures both). Split-K sums in fp32
// through the same epilogue kernel. tests/test_torch_conv1d_tf32.py emulates these index
// maps and the split in float64.
//
// Split-K, all three kernels: when the output tiles alone would not fill the card (the deep,
// short layers, and any layer at serving batch sizes), the depth is cut into `splits`
// slices, one per grid z-slice (the MMA kernel cuts on whole input channels). Each writes
// its fp32 partial sums to a workspace the wrapper allocates, and a second kernel
// (csrc/splitk_epilogue.cuh) adds them in a fixed order (deterministic), then applies the
// bias and PReLU.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "splitk_epilogue.cuh"

namespace {

using conv_epilogue::from_float;
using conv_epilogue::launch_splitk_epilogue;
using conv_epilogue::to_float;
using mma_conv::KP;
using mma_conv::NT;
using mma_conv::prelu;
using mma_conv::warp_conv_3xtf32;
using mma_conv::warp_conv_mma;

constexpr int BM = 64;        // output rows (flattened batch * time) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // contraction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4 x 4 sub-tile
constexpr int TM = 4;
constexpr int TN = 4;
static_assert(THREADS % BM == 0 && BK * BM == 4 * THREADS, "A-tile load mapping");
static_assert(THREADS % BK == 0 && BK * BN == 4 * THREADS, "B-tile load mapping");

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1d_prelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ slope,
                    T* __restrict__ y, T* __restrict__ pre, float* __restrict__ partial,
                    int B, int Cin, int pitch, int Cout, int T_out, int K, int stride,
                    int split_depth) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN + 1];  // +1: the w-tile store walks depth across a warp

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // owns rows tx + 16*i
  const int ty = tid / 16;  // owns channels ty + 16*j
  const long long M = (long long)B * T_out;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int depth = Cin * K;
  // this block's slice of the contraction: [d_begin, d_end)
  const int d_begin = blockIdx.z * split_depth;
  const int d_end = min(depth, d_begin + split_depth);

  // A tile: this thread always loads row a_m of the tile, at depths a_k + 4*i.
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  const long long a_row = m0 + a_m;
  const bool a_valid = a_row < M;
  const T* x_row = x;
  if (a_valid) {
    const long long b = a_row / T_out;
    const long long t = a_row - b * T_out;
    x_row = x + b * (long long)Cin * pitch + t * stride;
  }
  // B tile: this thread loads depth b_k of channels b_n + 16*j (coalesced along depth).
  const int b_k = tid % BK;
  const int b_n = tid / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = d_begin; k0 < d_end; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BK * BM / THREADS; ++i) {
      const int kk = a_k + i * (THREADS / BM);
      const int d = k0 + kk;
      float v = 0.f;
      if (a_valid && d < d_end) {
        const int ci = d / K;
        const int k = d - ci * K;
        v = to_float(x_row[(long long)ci * pitch + k]);
      }
      As[kk][a_m] = v;
    }
#pragma unroll
    for (int j = 0; j < BK * BN / THREADS; ++j) {
      const int nn = b_n + j * (THREADS / BK);
      const int co = n0 + nn;
      const int d = k0 + b_k;
      Bs[b_k][nn] = (co < Cout && d < d_end) ? to_float(w[(long long)co * depth + d]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* part = partial != nullptr ? partial + (long long)blockIdx.z * M * Cout : nullptr;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int co = n0 + ty + 16 * j;
    if (co >= Cout) continue;
    const float bco = bias != nullptr ? to_float(bias[co]) : 0.f;
    const float aco = to_float(slope[co]);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const long long m = m0 + tx + 16 * i;
      if (m >= M) continue;
      const long long b = m / T_out;
      const long long t = m - b * T_out;
      const long long off = (b * Cout + co) * (long long)T_out + t;
      if (part != nullptr) {  // split-K: the epilogue kernel finishes
        part[off] = acc[i][j];
        continue;
      }
      const float p = acc[i][j] + bco;
      pre[off] = from_float<T>(p);
      y[off] = from_float<T>(fmaxf(p, 0.f) + aco * fminf(p, 0.f));
    }
  }
}

long long num_tiles(int B, int Cout, int T_out) {
  return (((long long)B * T_out + BM - 1) / BM) * ((Cout + BN - 1) / BN);
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* slope, void* y,
           void* pre, float* partial, int splits, int B, int Cin, int pitch, int Cout,
           int T_out, int K, int stride, cudaStream_t stream) {
  const long long M = (long long)B * T_out;
  const int stages = (Cin * K + BK - 1) / BK;
  const int per = (stages + splits - 1) / splits;  // stages per split
  splits = (stages + per - 1) / per;               // no empty slice
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN),
                  (unsigned)splits);
  conv1d_prelu_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<const T*>(slope), static_cast<T*>(y), static_cast<T*>(pre),
      splits > 1 ? partial : nullptr, B, Cin, pitch, Cout, T_out, K, stride, per * BK);
  if (splits > 1)
    launch_splitk_epilogue<T>(partial, bias, slope, y, pre, M * Cout, Cout, T_out, splits,
                              stream);
  return (int)cudaGetLastError();
}

// The tensor-core kernels' constants.
constexpr int MMA_MT = 4;    // m16 tiles per warp: 64 rows
constexpr int WG = 96;       // staged samples per m16 group and channel at stride 4 (92 read)
constexpr int WG_S2 = 64;    // the same at stride 2 (62 read)
constexpr int STAGED = 128;  // group windows staged at a time (channels x groups)
constexpr int OUT_LD = MMA_MT * 16 + 8;  // a warp's output tile in shared memory: one
                                         // channel's 64 rows, padded (bank-conflict free)
constexpr int SMEM = STAGED * WG > 8 * 32 * OUT_LD ? STAGED * WG : 8 * 32 * OUT_LD;
static_assert(WG >= 4 * 15 + KP && WG % 8 == 0, "a group's window, in 16-byte units");
static_assert(WG_S2 >= 2 * 15 + KP && WG_S2 % 8 == 0 && WG_S2 <= WG, "the same at stride 2");
static_assert(OUT_LD % 8 == 0, "16-byte rows of the output tile");

// An m16 group's staged window at stride S, in samples.
template <int S>
struct GroupWindow {
  static_assert(S == 4 || S == 2, "stride 4 or 2");
  static constexpr int W = S == 4 ? WG : WG_S2;
};

// bf16 only, stride S. w is (Cout, Cin, KP), the taps padded with zeros; `slice` input
// channels per split-K slice (blockIdx.z). Block tile: WM x (8 / WM) warps of 64 rows x
// 32 channels. y and pre must be 16-byte aligned.
template <int WM, int S>
__global__ void __launch_bounds__(THREADS, 2)
conv1d_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                  const __nv_bfloat16* __restrict__ bias,
                  const __nv_bfloat16* __restrict__ slope, __nv_bfloat16* __restrict__ y,
                  __nv_bfloat16* __restrict__ pre, float* __restrict__ partial, int B,
                  int Cin, int T_in, int pitch, int Cout, int T_out, int slice) {
  constexpr int WN = 8 / WM;
  constexpr int NQ = WM * MMA_MT;     // m16 groups per block
  constexpr int TILE_M = NQ * 16;
  constexpr int TILE_N = WN * NT * 8;
  constexpr int CC = STAGED / NQ;     // channels staged at a time
  constexpr int W = GroupWindow<S>::W;  // staged samples per group and channel
  static_assert(WM * WN == THREADS / 32 && CC * NQ == STAGED, "8 warps, 128 windows");
  // the x chunk [channel][group][sample] in the mainloop, then each warp's output tile
  // [channel][row] in the epilogue
  __shared__ __align__(16) __nv_bfloat16 smem[SMEM];
  __shared__ long long q_in[NQ];   // group q's window in x: b Cin pitch + S t0
  __shared__ long long q_out[NQ];  // its row 0 in y and pre, channel 0: b Cout T_out + t0
  __shared__ int q_len[NQ];        // samples of its window inside x (0: no such group)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long long M = (long long)B * T_out;
  const long long m0 = (long long)blockIdx.x * TILE_M;
  const int wm = warp / WN;
  const int n0 = blockIdx.y * TILE_N + (warp % WN) * NT * 8;
  const int c_begin = blockIdx.z * slice;
  const int c_end = min(Cin, c_begin + slice);
  if (threadIdx.x < NQ) {
    const long long r = m0 + 16 * threadIdx.x;
    const long long b = r / T_out;
    const int t0 = (int)(r - b * T_out);
    const bool live = r < M;
    q_in[threadIdx.x] = live ? b * Cin * pitch + S * t0 : 0;
    q_out[threadIdx.x] = live ? b * Cout * T_out + t0 : 0;
    q_len[threadIdx.x] = live ? T_in - S * t0 : 0;
  }
  // M % 16 == 0: whole m16 tiles
  const int mt_live = (int)min((long long)MMA_MT, max(0LL, (M - m0) / 16 - wm * MMA_MT));
  const int nt_live = min(NT, max(0, (Cout - n0) / 8));

  float acc[MMA_MT][NT][4] = {};
  for (int c0 = c_begin; c0 < c_end; c0 += CC) {
    const int cc = min(CC, c_end - c0);
    __syncthreads();  // the group table is written; the previous chunk is no longer read
    // each thread stages fixed window positions p (group q, sample j) of every channel:
    // the address arithmetic is done once, and the channels' loads are independent
    for (int p = threadIdx.x; p < NQ * W; p += THREADS) {
      const int q = p / W;
      const int j = p - q * W;
      const bool inside = j < q_len[q];
      const __nv_bfloat16* src = x + q_in[q] + (long long)c0 * pitch + j;
#pragma unroll 8
      for (int c = 0; c < cc; ++c)
        smem[c * NQ * W + p] = inside ? src[(long long)c * pitch] : __float2bfloat16(0.f);
    }
    __syncthreads();
    if (mt_live > 0 && nt_live > 0)
      warp_conv_mma<MMA_MT, S, W>(acc, smem + wm * MMA_MT * W, NQ * W, 0, mt_live,
                                  w + (long long)c0 * KP, Cin, n0, nt_live, cc);
  }

  if (partial != nullptr) {  // split-K: fp32 partial sums; the epilogue kernel finishes
    float* part = partial + (long long)blockIdx.z * M * Cout;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= nt_live) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int co = n0 + 8 * j + 2 * t + (e & 1);
#pragma unroll
        for (int i = 0; i < MMA_MT; ++i) {
          if (i >= mt_live) continue;
          part[q_out[wm * MMA_MT + i] + (long long)co * T_out + g + 8 * (e >> 1)] =
              acc[i][j][e];
        }
      }
    }
    return;
  }
  // y and pre through shared memory: a fragment holds 2 channels x 2 rows, and a store
  // straight from it would write 2 bytes a lane. Each warp puts its 32 channels x 64
  // rows there, then writes 16 bytes a lane: 8 rows of one channel of one m16 group.
  __syncthreads();  // every warp is done with the x chunk
  __nv_bfloat16* tile = smem + warp * 32 * OUT_LD;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {  // pre, then y
    __nv_bfloat16* out = pass == 0 ? pre : y;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);
        if (j >= nt_live) continue;
        const float bco = bias != nullptr ? __bfloat162float(bias[n0 + cl]) : 0.f;
        const float aco = __bfloat162float(slope[n0 + cl]);
#pragma unroll
        for (int i = 0; i < MMA_MT; ++i) {
          const float p = acc[i][j][e] + bco;
          tile[cl * OUT_LD + 16 * i + g + 8 * (e >> 1)] =
              __float2bfloat16(pass == 0 ? p : prelu(p, aco));
        }
      }
    }
    __syncwarp();
    // 32 channels x 4 groups x 2 halves of 8 rows: lane l of step s takes unit s*32 + l
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int u = s * 32 + lane;
      const int half = u & 1;
      const int i = (u >> 1) & (MMA_MT - 1);
      const int cl = u >> 3;
      if (i < mt_live && cl < 8 * nt_live) {
        const long long off = q_out[wm * MMA_MT + i] + (long long)(n0 + cl) * T_out + 8 * half;
        *reinterpret_cast<uint4*>(out + off) =
            *reinterpret_cast<const uint4*>(tile + cl * OUT_LD + 16 * i + 8 * half);
      }
    }
    __syncwarp();  // the tile is read before the next pass writes it
  }
}

template <int WM>
int launch_mma(const void* x, const void* w, const void* bias, const void* slope, void* y,
               void* pre, float* partial, int splits, int B, int Cin, int T_in, int pitch,
               int Cout, int T_out, int stride, cudaStream_t stream) {
  constexpr int TILE_M = WM * MMA_MT * 16;
  constexpr int TILE_N = (8 / WM) * NT * 8;
  const long long M = (long long)B * T_out;
  const int slice = (Cin + splits - 1) / splits;  // input channels per split
  splits = (Cin + slice - 1) / slice;             // no empty slice
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (M + TILE_M - 1) / TILE_M;
  if (tiles_m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_m, (unsigned)((Cout + TILE_N - 1) / TILE_N),
                  (unsigned)splits);
  auto kernel = conv1d_mma_kernel<WM, 2>;
  if constexpr (WM != 8) {  // 8 x 1 warps: a stride-2 tile alone (the wrapper's plans)
    if (stride == 4) kernel = conv1d_mma_kernel<WM, 4>;
  }
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<const __nv_bfloat16*>(slope),
      static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(pre),
      splits > 1 ? partial : nullptr, B, Cin, T_in, pitch, Cout, T_out, slice);
  if (splits > 1)
    launch_splitk_epilogue<__nv_bfloat16>(partial, bias, slope, y, pre, M * Cout, Cout,
                                          T_out, splits, stream);
  return (int)cudaGetLastError();
}

// The fp32 tensor-core kernel's staging: STAGED_TF32 group windows at a time,
// 64 x 96 x 4 B = 24 KB of static shared memory (128 windows would be 48 KB).
constexpr int STAGED_TF32 = 64;

// fp32 only, by 3xTF32, stride S. w_big and w_small are the TF32 parts of w, each (Cout,
// Cin, KP) with the taps padded with zeros; the rest as conv1d_mma_kernel.
template <int WM, int S>
__global__ void __launch_bounds__(THREADS, 2)
conv1d_tf32_kernel(const float* __restrict__ x, const float* __restrict__ w_big,
                   const float* __restrict__ w_small, const float* __restrict__ bias,
                   const float* __restrict__ slope, float* __restrict__ y,
                   float* __restrict__ pre, float* __restrict__ partial, int B, int Cin,
                   int T_in, int pitch, int Cout, int T_out, int slice) {
  constexpr int WN = 8 / WM;
  constexpr int NQ = WM * MMA_MT;       // m16 groups per block
  constexpr int TILE_M = NQ * 16;
  constexpr int TILE_N = WN * NT * 8;
  constexpr int CC = STAGED_TF32 / NQ;  // channels staged at a time
  constexpr int W = GroupWindow<S>::W;   // staged samples per group and channel
  static_assert(WM * WN == THREADS / 32 && CC * NQ == STAGED_TF32, "8 warps, 64 windows");
  __shared__ __align__(16) float smem[STAGED_TF32 * WG];  // [channel][group][sample]
  __shared__ long long q_in[NQ];   // group q's window in x: b Cin pitch + S t0
  __shared__ long long q_out[NQ];  // its row 0 in y and pre, channel 0: b Cout T_out + t0
  __shared__ int q_len[NQ];        // samples of its window inside x (0: no such group)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const long long M = (long long)B * T_out;
  const long long m0 = (long long)blockIdx.x * TILE_M;
  const int wm = warp / WN;
  const int n0 = blockIdx.y * TILE_N + (warp % WN) * NT * 8;
  const int c_begin = blockIdx.z * slice;
  const int c_end = min(Cin, c_begin + slice);
  if (threadIdx.x < NQ) {
    const long long r = m0 + 16 * threadIdx.x;
    const long long b = r / T_out;
    const int t0 = (int)(r - b * T_out);
    const bool live = r < M;
    q_in[threadIdx.x] = live ? b * Cin * pitch + S * t0 : 0;
    q_out[threadIdx.x] = live ? b * Cout * T_out + t0 : 0;
    q_len[threadIdx.x] = live ? T_in - S * t0 : 0;
  }
  // M % 16 == 0: whole m16 tiles
  const int mt_live = (int)min((long long)MMA_MT, max(0LL, (M - m0) / 16 - wm * MMA_MT));
  const int nt_live = min(NT, max(0, (Cout - n0) / 8));

  float acc[MMA_MT][NT][4] = {};
  for (int c0 = c_begin; c0 < c_end; c0 += CC) {
    const int cc = min(CC, c_end - c0);
    __syncthreads();  // the group table is written; the previous chunk is no longer read
    for (int p = threadIdx.x; p < NQ * W; p += THREADS) {
      const int q = p / W;
      const int j = p - q * W;
      const bool inside = j < q_len[q];
      const float* src = x + q_in[q] + (long long)c0 * pitch + j;
#pragma unroll 8
      for (int c = 0; c < cc; ++c)
        smem[c * NQ * W + p] = inside ? src[(long long)c * pitch] : 0.f;
    }
    __syncthreads();
    if (mt_live > 0 && nt_live > 0)
      warp_conv_3xtf32<MMA_MT, S, W>(acc, smem + wm * MMA_MT * W, NQ * W, 0, mt_live,
                                     w_big + (long long)c0 * KP, w_small + (long long)c0 * KP,
                                     Cin, n0, nt_live, cc);
  }

  // Straight from the fragments: for one channel, the 8 lanes of a quad position write 8
  // consecutive time steps, one whole 32-byte sector. Under split-K, fp32 partial sums;
  // the epilogue kernel finishes.
  float* const part =
      partial != nullptr ? partial + (long long)blockIdx.z * M * Cout : nullptr;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt_live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = n0 + 8 * j + 2 * t + (e & 1);
      const float bco = bias != nullptr ? bias[co] : 0.f;
      const float aco = slope[co];
#pragma unroll
      for (int i = 0; i < MMA_MT; ++i) {
        if (i >= mt_live) continue;
        const long long off =
            q_out[wm * MMA_MT + i] + (long long)co * T_out + g + 8 * (e >> 1);
        if (part != nullptr) {
          part[off] = acc[i][j][e];
          continue;
        }
        const float p = acc[i][j][e] + bco;
        pre[off] = p;
        y[off] = prelu(p, aco);
      }
    }
  }
}

template <int WM>
int launch_tf32(const void* x, const void* w_big, const void* w_small, const void* bias,
                const void* slope, void* y, void* pre, float* partial, int splits, int B,
                int Cin, int T_in, int pitch, int Cout, int T_out, int stride,
                cudaStream_t stream) {
  constexpr int TILE_M = WM * MMA_MT * 16;
  constexpr int TILE_N = (8 / WM) * NT * 8;
  const long long M = (long long)B * T_out;
  const int slice = (Cin + splits - 1) / splits;  // input channels per split
  splits = (Cin + slice - 1) / slice;             // no empty slice
  if (splits > 1 && partial == nullptr) return (int)cudaErrorInvalidValue;
  const long long tiles_m = (M + TILE_M - 1) / TILE_M;
  if (tiles_m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles_m, (unsigned)((Cout + TILE_N - 1) / TILE_N),
                  (unsigned)splits);
  auto kernel = conv1d_tf32_kernel<WM, 2>;
  if constexpr (WM != 8) {  // 8 x 1 warps: a stride-2 tile alone (the wrapper's plans)
    if (stride == 4) kernel = conv1d_tf32_kernel<WM, 4>;
  }
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w_big),
      static_cast<const float*>(w_small), static_cast<const float*>(bias),
      static_cast<const float*>(slope), static_cast<float*>(y), static_cast<float*>(pre),
      splits > 1 ? partial : nullptr, B, Cin, T_in, pitch, Cout, T_out, slice);
  if (splits > 1)
    launch_splitk_epilogue<float>(partial, bias, slope, y, pre, M * Cout, Cout, T_out,
                                  splits, stream);
  return (int)cudaGetLastError();
}

// Whether the tensor-core entry points take the call: stride 4 or 2 (warps_m 8 at 2
// alone), whole n8 tiles of channels and m16 tiles of time steps, and every row's first
// sample inside x.
bool tensor_core_shape(int B, int Cin, int T_in, int pitch, int Cout, int T_out,
                       int stride, int splits, int warps_m) {
  return B > 0 && Cin > 0 && Cout > 0 && T_out > 0 && splits > 0 && Cout % 8 == 0 &&
         T_out % 16 == 0 && pitch >= T_in &&
         (stride == 2 || (stride == 4 && warps_m != 8)) &&
         (long long)stride * (T_out - 1) < T_in;
}

}  // namespace

// How many depth slices to cut the contraction into: enough output tiles for two blocks
// on each of `num_sms` SMs, keeping at least 8 stages (128 of depth) per slice. The
// wrapper allocates a float32 workspace of splits * B * Cout * T_out when it is > 1.
extern "C" int conv1d_prelu_splits(int B, int Cin, int Cout, int T_out, int K,
                                   int num_sms) {
  const long long tiles = num_tiles(B, Cout, T_out);
  const long long target = 2LL * num_sms;
  const int stages = (Cin * K + BK - 1) / BK;
  if (tiles >= target || stages < 16) return 1;
  long long splits = (target + tiles - 1) / tiles;
  if (splits > stages / 8) splits = stages / 8;
  return splits > 1 ? (int)splits : 1;
}

// dtype: 0 = float32, 1 = bfloat16. x is (B, Cin, T_in) with rows `pitch` elements apart
// (pitch >= T_in; batch rows Cin * pitch apart). bias may be null; partial is the split-K
// workspace (null when splits == 1). Launches on `stream` and returns cudaGetLastError()
// (0 on success); it does not synchronise and allocates nothing.
extern "C" int conv1d_prelu_launch(int dtype, const void* x, const void* w,
                                   const void* bias, const void* slope, void* y,
                                   void* pre, void* partial, int splits, int B, int Cin,
                                   int T_in, int pitch, int Cout, int T_out, int K,
                                   int stride, void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || stride <= 0 || T_out <= 0 ||
      splits <= 0 || pitch < T_in || (long long)(T_out - 1) * stride + K > T_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, bias, slope, y, pre, ws, splits, B, Cin, pitch, Cout, T_out,
                           K, stride, s);
    case 1:
      return launch<__nv_bfloat16>(x, w, bias, slope, y, pre, ws, splits, B, Cin, pitch,
                                   Cout, T_out, K, stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route, bfloat16 only: x (B, Cin, T_in) with rows `pitch` apart (as
// conv1d_prelu_launch), w (Cout, Cin, 32) with the taps past the conv's K zero, stride 4
// or 2. Needs Cout % 8 == 0 and T_out % 16 == 0; window samples at or past T_in read as
// 0. warps_m (1, 2, 4, or at stride 2 also 8) picks the block tile, 64 warps_m rows x
// 256 / warps_m channels; splits the split-K slices, cut on whole input channels (the wrapper allocates
// a float32 workspace of splits * B * Cout * T_out when > 1). bias may be null. Launches
// on `stream` and returns cudaGetLastError() (0 on success); it does not synchronise and
// allocates nothing.
extern "C" int conv1d_prelu_mma_launch(const void* x, const void* w, const void* bias,
                                       const void* slope, void* y, void* pre,
                                       void* partial, int warps_m, int splits, int B,
                                       int Cin, int T_in, int pitch, int Cout, int T_out,
                                       int stride, void* stream) {
  if (!tensor_core_shape(B, Cin, T_in, pitch, Cout, T_out, stride, splits, warps_m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  switch (warps_m) {
    case 1:
      return launch_mma<1>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in, pitch, Cout,
                           T_out, stride, s);
    case 2:
      return launch_mma<2>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in, pitch, Cout,
                           T_out, stride, s);
    case 4:
      return launch_mma<4>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in, pitch, Cout,
                           T_out, stride, s);
    case 8:
      return launch_mma<8>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in, pitch, Cout,
                           T_out, stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core route in float32, by 3xTF32: as conv1d_prelu_mma_launch, with w given
// as its TF32 parts w_big and w_small, each (Cout, Cin, 32) with the taps past the conv's
// K zero, 16-byte aligned. y and pre need no alignment beyond fp32's.
extern "C" int conv1d_prelu_tf32_launch(const void* x, const void* w_big,
                                        const void* w_small, const void* bias,
                                        const void* slope, void* y, void* pre,
                                        void* partial, int warps_m, int splits, int B,
                                        int Cin, int T_in, int pitch, int Cout, int T_out,
                                        int stride, void* stream) {
  if (!tensor_core_shape(B, Cin, T_in, pitch, Cout, T_out, stride, splits, warps_m))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  switch (warps_m) {
    case 1:
      return launch_tf32<1>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin,
                            T_in, pitch, Cout, T_out, stride, s);
    case 2:
      return launch_tf32<2>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin,
                            T_in, pitch, Cout, T_out, stride, s);
    case 4:
      return launch_tf32<4>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin,
                            T_in, pitch, Cout, T_out, stride, s);
    case 8:
      return launch_tf32<8>(x, w_big, w_small, bias, slope, y, pre, ws, splits, B, Cin,
                            T_in, pitch, Cout, T_out, stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
