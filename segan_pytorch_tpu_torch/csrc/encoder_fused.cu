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
// What bounds it on the H100. At the SEGAN+ widths (64 -> 128 -> 256 channels, T1 = 4096
// per 16384-sample chunk) each layer costs 2 * T_out * Cout * Cin * 31 = 0.52 GFLOP per
// chunk against about 1 MB of activations in bf16: some 500 FLOP per byte, so the pair is
// bound by arithmetic (312 GFLOP at batch 300). Chaining saves only post2's round trip
// through device memory and the two reflect-padded copies, about 0.4 GB at batch 300 in
// bf16 (~0.13 ms at 3.35 TB/s).
//
// What the design does about it. One 256-thread block per (batch row, tile of TILE enc3
// output rows), in no order; nothing passes between blocks.
//   Phase A computes post2, for all C2 channels, on the real rows the tile's enc3 windows
//   read: at most 4 * TILE + 27 rows, so the halo is recomputed (1.21x enc2's work at
//   TILE = 32) rather than read from a neighbour. h1's taps are gathered through the
//   reflect map at T1 (no padded copy in device memory). post2 goes to shared memory in
//   h1's dtype; pre2 is stored only for the 4 * TILE rows the tile owns, so every pre2 row
//   is written by exactly one block.
//   Phase B computes enc3's TILE rows x C3 channels from that shared memory, through the
//   reflect map at T2, and stores pre3 and post3.
// Both phases are implicit GEMMs in tiles of 32 rows x 128 channels: each 16-deep stage
// of the contraction (the weights' own order, ci-major then tap) is staged in shared
// memory as fp32 and every thread accumulates a 2 x 8 sub-tile with FMAs; the weights
// (1 + 4 MB in fp32) stay in the 50 MB L2. The Pallas kernel's space-to-depth fold, its
// zero 32nd tap and its zero-padded tail rows exist to feed the TPU's matrix unit and are
// not carried over: the 31 taps are computed directly. No tensor cores yet (wgmma fed by
// TMA is later work), so at batch 1 only T1 / 512 blocks run, on a card of 132 SMs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T>
int launch(const void* h1, const void* w2, const void* b2, const void* a2, const void* w3,
           const void* b3, const void* a3, void* pre2, void* pre3, void* post3, int B, int C1,
           int T1, int C2, int C3, cudaStream_t stream) {
  const int T3 = T1 / (STRIDE * STRIDE);
  const int tiles = (T3 + TILE - 1) / TILE;
  const long long blocks = (long long)B * tiles;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  // post2's tile above 48 KB must be allowed explicitly, or the launch is refused
  const size_t smem = (size_t)C2 * ROWS2 * sizeof(T);
  const cudaError_t err = cudaFuncSetAttribute(
      enc23_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that a later launch does not report it
    return (int)err;
  }
  enc23_kernel<T><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(h1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      static_cast<const T*>(a2), static_cast<const T*>(w3), static_cast<const T*>(b3),
      static_cast<const T*>(a3), static_cast<T*>(pre2), static_cast<T*>(pre3),
      static_cast<T*>(post3), C1, T1, C2, C3, tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. b2 and b3 may be null. Needs T1 % 16 == 0 and
// T1 >= 64 (the reflect pad of 15 needs T1 / 4 >= 16). Launches on `stream` and returns
// the cudaError_t (0 on success); it does not synchronise and allocates nothing.
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
      return launch<float>(h1, w2, b2, a2, w3, b3, a3, pre2, pre3, post3, B, C1, T1, C2, C3,
                           s);
    case 1:
      return launch<__nv_bfloat16>(h1, w2, b2, a2, w3, b3, a3, pre2, pre3, post3, B, C1, T1,
                                   C2, C3, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
