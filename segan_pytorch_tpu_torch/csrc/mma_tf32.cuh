// The fp32 tensor-core mainloop of csrc/conv1d_prelu.cu: the conv of stride 4 or 2 with
// taps padded to 32 (tap 31 zero) of warp_conv_mma (csrc/mma_bf16.cuh), in fp32 by a 3xTF32
// split on mma.sync m16n8k8 (TF32 in, fp32 sums). Each fp32 operand v is split into
// big = tf32(v) and small = tf32(v - big), both rounded to nearest with ties away from
// zero (cvt.rna), and a product a b is taken as small(a) big(b) + big(a) small(b) +
// big(a) big(b), in that order into one accumulator. That drops small(a) small(b) and
// the rounding of the two small parts, each at most about 2^-22 |a| |b|, where one TF32
// product loses up to 2^-11 |a| |b|.
// The tensor cores' own fp32 sums are not rounded to nearest: with every MMA of a
// 16384-deep output (enc5, 512 channels x 32 taps) summed in one accumulator, the H100
// drifted 1.2e-4 from float64 (the plain fp32 version 5.5e-6). So each m16 tile sums
// half a channel (two 8-deep steps, six MMAs) into fresh registers and adds them to the
// accumulator with fp32 adds, which round to nearest.
#pragma once

#include <cstdint>

#include "mma_bf16.cuh"

namespace mma_conv {

// v rounded to TF32 (10 mantissa bits), round to nearest, ties away from zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// v = big + small to about 2^-22 |v|: v - big is exact in fp32
__device__ __forceinline__ void split_tf32(float v, uint32_t& big, uint32_t& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - __uint_as_float(big));
}

// c += a (16 x 8, row-major) * b (8 x 8, column-major) on the tensor cores, TF32 in, fp32
// sums; fragments as the PTX ISA lays them out for m16n8k8 .tf32: lane (g = lane / 4,
// t = lane % 4) holds a = {A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]},
// b = {B[t][g], B[t+4][g]}, c = {C[g][2t..2t+1], C[g+8][2t..2t+1]}.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the two small terms first, then big x big
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4], uint32_t b0_big,
                                           uint32_t b1_big, uint32_t b0_small,
                                           uint32_t b1_small) {
  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
  mma_tf32(c, a_big, b0_big, b1_big);
}

// One warp's share of a conv of stride S with 32 taps, in fp32 by 3xTF32:
//   acc[i][j] += sum over ci < cin, k < KP of
//                a[ci * lda + MT_STRIDE * i + S (m0 + r) + k] * w[(n * w_cin + ci) * KP + k]
// for rows r = 0..15 of m16 tile i and channels n = n0 + 8 j + (0..7), as warp_conv_mma.
// w comes as its TF32 parts w_big + w_small, split once by the wrapper; a is split here,
// as its fragments are loaded. Half a channel's sums go through `part` (see above). The
// 8-deep step s (0..3) of channel ci takes, at contraction index t and t + 4, the taps
// 8t + 2s and 8t + 2s + 1: lane quad t's A values of a row are then two adjacent fp32
// (one 8-byte load: S g + 8t + 4h + 2s is even at either stride), and its B values of the
// four steps taps 8t..8t+7 (two 16-byte loads of each part, one per pair of steps).
template <int MT, int S = STRIDE, int MT_STRIDE = S * 16>
__device__ __forceinline__ void warp_conv_3xtf32(float (&acc)[MT][NT][4], const float* a,
                                                 int lda, int m0, int mt_live,
                                                 const float* __restrict__ w_big,
                                                 const float* __restrict__ w_small,
                                                 int w_cin, int n0, int nt_live, int cin) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const float* a_lane = a + S * (m0 + g) + 8 * t;
  const long long w_lane = (long long)(n0 + g) * w_cin * KP + 8 * t;
#pragma unroll 1
  for (int ci = 0; ci < cin; ++ci) {
    const float* a_ci = a_lane + ci * lda;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // taps 8t + 4h + 0..3: steps 2h and 2h + 1
      uint4 bb[NT], bs[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const long long o = w_lane + ((long long)8 * j * w_cin + ci) * KP + 4 * h;
        bb[j] = j < nt_live ? __ldg(reinterpret_cast<const uint4*>(w_big + o))
                            : make_uint4(0, 0, 0, 0);
        bs[j] = j < nt_live ? __ldg(reinterpret_cast<const uint4*>(w_small + o))
                            : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i >= mt_live) continue;
        float part[NT][4] = {};
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float* p = a_ci + MT_STRIDE * i + 4 * h + 2 * s;
          const float2 r0 = *reinterpret_cast<const float2*>(p);               // row g
          const float2 r8 = *reinterpret_cast<const float2*>(p + S * 8);  // row g + 8
          uint32_t ab[4], as[4];
          split_tf32(r0.x, ab[0], as[0]);
          split_tf32(r8.x, ab[1], as[1]);
          split_tf32(r0.y, ab[2], as[2]);
          split_tf32(r8.y, ab[3], as[3]);
#pragma unroll
          for (int j = 0; j < NT; ++j)
            if (j < nt_live)
              mma_3xtf32(part[j], ab, as, s ? bb[j].z : bb[j].x, s ? bb[j].w : bb[j].y,
                         s ? bs[j].z : bs[j].x, s ? bs[j].w : bs[j].y);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
      }
    }
  }
}

}  // namespace mma_conv
