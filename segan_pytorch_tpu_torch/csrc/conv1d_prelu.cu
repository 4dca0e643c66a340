// Fused strided conv1d + bias + PReLU for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_conv1d_prelu` of
// segan_pytorch_tpu/ops/pallas/conv1d.py (`_pallas_conv_prelu`, `_kernel`): the conv +
// bias + PReLU of every SEGAN generator encoder layer. It computes
//     pre[b, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * x[b, ci, t*stride + k]
//     y = max(pre, 0) + slope[co] * min(pre, 0)
// and writes BOTH y and pre, because the generator's skips carry the pre-activation.
// x is already reflect-padded, in torch's (B, Cin, T_in) layout; w is (Cout, Cin, K);
// y and pre are (B, Cout, T_out). Sums are fp32; inputs and outputs are fp32 or bf16.
//
// What bounds it on the H100. On the main path (K=31, stride 4, 16384-sample chunks)
// enc2..enc5 each cost about 0.52 GFLOP per chunk over a deep contraction
// (Cin*K = 1984..15872), so they are bound by arithmetic. enc1 has Cin=1: a depth of 31
// against 64 outputs is about 15 FLOP per byte moved, so it is bound by memory
// bandwidth. Deep layers have few output rows per chunk (enc5: 16), which starves a
// kernel that tiles one chunk at a time.
//
// What the design does about it. It is an implicit GEMM: M = B*T_out rows (batch and
// time flattened, so enc5's 16 rows per chunk still fill 64-row tiles), N = Cout,
// depth Cin*K in the weights' own order (ci-major, then k). The Pallas kernel folds the
// stride into channels (space-to-depth) to feed the TPU's MXU; that is a TPU layout
// trick and is not carried over: here each thread gathers its row's taps straight from
// x (the window overlaps between neighbouring rows and stays in L1). A 64x64 output tile
// per 256-thread block; each stage stages a 16-deep slice of x and w in shared memory,
// converted to fp32, and every thread accumulates a 4x4 sub-tile with FMAs. The
// epilogue adds the bias (none under --no_bias), applies the PReLU and stores y and pre
// with neighbouring threads on neighbouring time steps. Ragged edges in M, N and depth
// are masked, so any T_out, Cin (including 1) and stride is taken.
// Split-K: when the output tiles alone would not give every SM two blocks (the deep,
// short layers, and any layer at serving batch sizes), the depth is cut into `splits`
// ranges, one per grid z-slice. Each writes its fp32 partial sums to a workspace the
// wrapper allocates, and a second kernel adds them in a fixed order (deterministic),
// then applies the bias and PReLU.
// Later work: tensor cores (wgmma) fed by TMA.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int BM = 64;        // output rows (flattened batch * time) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 16;        // contraction depth per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, each owning a 4 x 4 sub-tile
constexpr int TM = 4;
constexpr int TN = 4;
static_assert(THREADS % BM == 0 && BK * BM == 4 * THREADS, "A-tile load mapping");
static_assert(THREADS % BK == 0 && BK * BN == 4 * THREADS, "B-tile load mapping");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv1d_prelu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const T* __restrict__ bias, const T* __restrict__ slope,
                    T* __restrict__ y, T* __restrict__ pre, float* __restrict__ partial,
                    int B, int Cin, int T_in, int Cout, int T_out, int K, int stride,
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
    x_row = x + b * (long long)Cin * T_in + t * stride;
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
        v = to_float(x_row[(long long)ci * T_in + k]);
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

// Sums the split-K partials (B, Cout, T_out) x splits in order, adds bias, applies PReLU.
template <typename T>
__global__ void splitk_epilogue_kernel(const float* __restrict__ partial,
                                       const T* __restrict__ bias,
                                       const T* __restrict__ slope, T* __restrict__ y,
                                       T* __restrict__ pre, long long total, int Cout,
                                       int T_out, int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    float p = 0.f;
    for (int z = 0; z < splits; ++z) p += partial[z * total + i];
    const int co = (int)((i / T_out) % Cout);
    if (bias != nullptr) p += to_float(bias[co]);
    pre[i] = from_float<T>(p);
    y[i] = from_float<T>(fmaxf(p, 0.f) + to_float(slope[co]) * fminf(p, 0.f));
  }
}

long long num_tiles(int B, int Cout, int T_out) {
  return (((long long)B * T_out + BM - 1) / BM) * ((Cout + BN - 1) / BN);
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* slope, void* y,
           void* pre, float* partial, int splits, int B, int Cin, int T_in, int Cout,
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
      splits > 1 ? partial : nullptr, B, Cin, T_in, Cout, T_out, K, stride, per * BK);
  if (splits > 1) {
    const long long total = M * Cout;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    splitk_epilogue_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536), threads, 0,
                                stream>>>(partial, static_cast<const T*>(bias),
                                          static_cast<const T*>(slope),
                                          static_cast<T*>(y), static_cast<T*>(pre), total,
                                          Cout, T_out, splits);
  }
  return (int)cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16. bias may be null; partial is the split-K workspace
// (null when splits == 1). Launches on `stream` and returns cudaGetLastError() (0 on
// success); it does not synchronise and allocates nothing.
extern "C" int conv1d_prelu_launch(int dtype, const void* x, const void* w,
                                   const void* bias, const void* slope, void* y,
                                   void* pre, void* partial, int splits, int B, int Cin,
                                   int T_in, int Cout, int T_out, int K, int stride,
                                   void* stream) {
  if (B <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || stride <= 0 || T_out <= 0 ||
      splits <= 0 || (long long)(T_out - 1) * stride + K > T_in)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  switch (dtype) {
    case 0:
      return launch<float>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in, Cout, T_out,
                           K, stride, s);
    case 1:
      return launch<__nv_bfloat16>(x, w, bias, slope, y, pre, ws, splits, B, Cin, T_in,
                                   Cout, T_out, K, stride, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
