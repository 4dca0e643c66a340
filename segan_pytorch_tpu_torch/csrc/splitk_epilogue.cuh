// The split-K epilogue shared by the per-layer kernels of csrc/conv1d_prelu.cu and
// csrc/conv1d_wgmma.cu: when a kernel cuts the contraction into `splits` slices, each
// slice writes fp32 partial sums (B, Cout, T_out) to a workspace, and this kernel adds
// them in slice order (deterministic), adds the bias and applies the PReLU.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace conv_epilogue {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
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

// Sums `splits` slices of partial sums (B, Cout, T_out) into y and pre.
template <typename T>
void launch_splitk_epilogue(const float* partial, const void* bias, const void* slope,
                            void* y, void* pre, long long total, int Cout, int T_out,
                            int splits, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  splitk_epilogue_kernel<T><<<(unsigned)(blocks < 65536 ? blocks : 65536), threads, 0,
                              stream>>>(partial, static_cast<const T*>(bias),
                                        static_cast<const T*>(slope), static_cast<T*>(y),
                                        static_cast<T*>(pre), total, Cout, T_out, splits);
}

}  // namespace conv_epilogue
