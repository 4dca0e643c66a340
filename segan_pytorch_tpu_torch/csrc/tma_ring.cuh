// The pieces of a TMA / mbarrier ring feeding wgmma, shared by the per-layer kernels of
// csrc/conv1d_wgmma.cu (bf16) and csrc/conv1d_wgmma_tf32.cu (fp32 by 3xTF32), the chained
// ones of csrc/encoder_fused_wgmma*.cu and csrc/conv1d_rows.cu: barriers with a wait that
// traps instead of hanging, TMA tile loads, the descriptor of a K-major tile with the
// 128-byte swizzle, the x windows of either stride, wgmma's and the proxies' fences, and
// on the host the tensor maps
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so that a library
// needs no -lcuda) and the shared-memory size set once per device.
#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma_ring {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

constexpr unsigned long long WAIT_LIMIT_NS = 20000000000ull;  // 20 s
constexpr int MAX_DEVICES = 64;

// Waits until the phase of parity `parity` of the barrier has completed. A wait past
// WAIT_LIMIT_NS traps: a pipeline fault then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0)
      start = now;
    else if (now - start > WAIT_LIMIT_NS)
      __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// A wgmma descriptor of a K-major tile with the 128-byte swizzle: rows of 128 bytes,
// groups of 8 rows 1024 bytes apart; `addr` may move by 32-byte steps inside a row (one
// step of 16 bf16 or 8 TF32 values).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// The x windows of an m16 group of rows of a per-layer conv of stride S (4 or 2) whose
// ring stage holds CC input channels of ELEM-byte samples: at stride 4 one TMA box of WIN
// samples a group (4 * 15 + 32 = 92 read); at stride 2 one of WIN_HALF for each 8-row
// half (2 * 7 + 32 = 46 read), from the half's own first row, so that a group may span
// two batch rows and T_out % 8 == 0 is enough. Both fill a group's bytes alike. Box j of
// a block holds rows ROWS j .. ROWS (j + 1) - 1 of its tile, from (b, S t) of its first
// row; ROW8 is where row g + 8 starts, in elements, from row g (in the group's one box, or
// at the same place of its second half's).
template <int S, int CC, int WIN, int WIN_HALF, int ELEM>
struct XBoxes {
  static_assert(S == 4 || S == 2, "stride 4 or 2");
  static_assert(WIN >= 4 * 15 + 32 && WIN_HALF >= 2 * 7 + 32 && 2 * WIN_HALF == WIN,
                "a group's window, or two halves in its bytes");
  static constexpr int PER_GROUP = S == 4 ? 1 : 2;
  static constexpr int ROWS = 16 / PER_GROUP;
  static constexpr int SAMPLES = S == 4 ? WIN : WIN_HALF;
  static constexpr int BYTES = CC * SAMPLES * ELEM;
  static constexpr int ROW8 = S == 4 ? S * 8 : CC * SAMPLES;
  static_assert(BYTES % 128 == 0, "TMA destinations 128-byte aligned");

  // Where rows 8 hh .. 8 hh + 7 of m16 group q of the tile lie in y and pre (channel 0),
  // from the boxes' (b, S t): the group's box at stride 4, the half's own at stride 2.
  static __device__ __forceinline__ long long half_base(const int2* coord, int q, int hh,
                                                        int Cout, int T_out) {
    const int2 bt = coord[q * PER_GROUP + hh * (PER_GROUP - 1)];
    return (long long)bt.x * Cout * T_out + bt.y / S + (PER_GROUP == 1 ? 8 * hh : 0);
  }
};

// Keeps the compiler from moving reads or writes of the accumulators across the
// asynchronous MMAs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Orders this thread's generic writes to shared memory before later asynchronous-proxy
// accesses of it (a TMA refill, a wgmma read).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (null if it has none).
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor maps of a per-layer conv, elements of `elem` bytes.
// x (B, Cin, T_in) with rows `pitch` elements apart, boxes {win, cc, 1} of one batch row,
// no swizzle (TMA fills samples at or past T_in, and channels past Cin, with zeros).
inline cudaError_t encode_x_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                const void* x, int B, int Cin, int T_in, int pitch, int win,
                                int cc) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[3] = {(cuuint64_t)T_in, (cuuint64_t)Cin, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)pitch * elem, (cuuint64_t)Cin * pitch * elem};
  const cuuint32_t box[3] = {(cuuint32_t)win, (cuuint32_t)cc, 1};
  const cuuint32_t ones[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(x), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// w, `rows` rows of `cols` elements (K-major: a row is an output channel's taps), boxes
// {box_cols, box_rows} with the 128-byte swizzle (box_cols * elem == 128), or the one
// given (the 64-byte one: box_cols * elem == 64); columns past `cols` read as 0.
inline cudaError_t encode_w_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                                const void* w, int rows, int cols, int box_cols,
                                int box_rows,
                                CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorInitializationError;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(w), dims, strides, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// Sets `kernel`'s dynamic shared-memory size once per device, `sized` being that
// kernel's own flags (the attribute belongs to the device's context): a first launch
// under CUDA graph capture is then no different from another.
template <typename Kernel>
inline cudaError_t size_smem_once(Kernel kernel, int bytes, bool (&sized)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!sized[device]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    sized[device] = true;
  }
  return cudaSuccess;
}

}  // namespace tma_ring
