// The tensor-core mainloop shared by the bf16 kernels of csrc/conv1d_prelu.cu and
// csrc/encoder_fused.cu: a conv of stride 4 or 2 whose taps are padded to 32 (tap 31
// zero), so that each input channel is two 16-deep steps of mma.sync m16n8k16 (bf16 in,
// fp32 sums). The stride is a template parameter; encoder_fused.cu takes the default, 4.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace mma_conv {

constexpr int STRIDE = 4;  // the conv's stride, by default (the other one taken: 2)
constexpr int KP = 32;     // taps, padded by the wrappers
constexpr int NT = 4;      // n8 tiles per warp (32 channels)

// c += a (16 x 16, row-major) * b (16 x 8, column-major) on the tensor cores; fragments
// as the PTX ISA lays them out for m16n8k16: lane (g = lane / 4, t = lane % 4) holds
// a = {A[g][2t..2t+1], A[g+8][2t..2t+1], A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]},
// b = {B[2t..2t+1][g], B[2t+8..2t+9][g]}, c = {C[g][2t..2t+1], C[g+8][2t..2t+1]}.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four adjacent bf16 samples from p, as two fragment registers: one 8-byte load at
// stride 4, where a lane's first sample (4 g + 8 t + 4 h of its window) is 8-byte aligned;
// two 4-byte loads at stride 2, where it (2 g + 8 t + 4 h) is 4-byte aligned only.
template <int S>
__device__ __forceinline__ uint2 load_a4(const __nv_bfloat16* p) {
  static_assert(S == 4 || S == 2, "stride 4 or 2");
  if constexpr (S == 4) {
    return *reinterpret_cast<const uint2*>(p);
  } else {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
    return make_uint2(q[0], q[1]);
  }
}

// One warp's share of a conv of stride S with 32 taps, on the tensor cores:
//   acc[i][j] += sum over ci < cin, k < KP of
//                a[ci * lda + MT_STRIDE * i + S (m0 + r) + k] * w[(n * w_cin + ci) * KP + k]
// for rows r = 0..15 of m16 tile i and channels n = n0 + 8 j + (0..7). With the default
// MT_STRIDE (16 S) the tiles' rows are consecutive, row m = m0 + 16 i + r at S m; a
// larger one gives each m16 tile a window of its own. m16 tiles i >= mt_live and n8
// tiles j >= nt_live are skipped (both warp-uniform). The 16-deep step h of channel ci
// takes, at contraction index 2t + e and 2t + 8 + e (e = 0, 1), the taps 8t + 4h + e and
// 8t + 4h + 2 + e, whatever the stride: lane quad t's A values of a row are then four
// adjacent bf16 (load_a4) and its B values of both steps eight (one 16-byte load).
template <int MT, int S = STRIDE, int MT_STRIDE = S * 16>
__device__ __forceinline__ void warp_conv_mma(float (&acc)[MT][NT][4],
                                              const __nv_bfloat16* a, int lda, int m0,
                                              int mt_live,
                                              const __nv_bfloat16* __restrict__ w, int w_cin,
                                              int n0, int nt_live, int cin) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16* a_lane = a + S * (m0 + g) + 8 * t;
  const __nv_bfloat16* w_lane = w + (long long)(n0 + g) * w_cin * KP + 8 * t;
#pragma unroll 2
  for (int ci = 0; ci < cin; ++ci) {
    uint4 b[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      b[j] = j < nt_live ? __ldg(reinterpret_cast<const uint4*>(
                               w_lane + ((long long)8 * j * w_cin + ci) * KP))
                         : make_uint4(0, 0, 0, 0);
    const __nv_bfloat16* a_ci = a_lane + ci * lda;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt_live) continue;
        const __nv_bfloat16* p = a_ci + MT_STRIDE * i + 4 * h;
        const uint2 r0 = load_a4<S>(p);          // row g
        const uint2 r8 = load_a4<S>(p + S * 8);  // row g + 8
        const uint32_t af[4] = {r0.x, r8.x, r0.y, r8.y};
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt_live) mma_bf16(acc[i][j], af, h ? b[j].z : b[j].x, h ? b[j].w : b[j].y);
      }
    }
  }
}

__device__ __forceinline__ float prelu(float p, float a) {
  return fmaxf(p, 0.f) + a * fminf(p, 0.f);
}

}  // namespace mma_conv
