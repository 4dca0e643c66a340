// Fused strided conv1d + bias + PReLU in bf16 for calls of few rows, on Hopper (sm_90a).
//
// Replaces, on the bf16 main path at serving's shapes, the TPU kernel `fused_conv1d_prelu`
// of segan_pytorch_tpu/ops/pallas/conv1d.py (`_pallas_conv_prelu`, `_kernel`), beside the
// kernels of csrc/conv1d_prelu.cu and csrc/conv1d_wgmma.cu, which compute the same
// function:
//     pre[b, co, t] = bias[co] + sum_{ci, k} w[co, ci, k] * x[b, ci, 4 t + k]
//     y = max(pre, 0) + slope[co] * min(pre, 0)
// bf16 in, fp32 sums, y and pre in bf16 (B, Cout, T_out); stride 4; K <= 32 taps padded to
// 32 by the wrapper (the padded taps zero); samples at or past T_in read as 0. The wrapper
// (ops/kernels/conv1d_prelu.py, `_route`) sends a call here when B * T_out is small.
//
// What bounds it on the H100. A layer of G at one chunk, a streamed window or a short
// file has a few rows (B * T_out = 2..256) against up to 32 MiB of weights (enc5: 1024 x
// 512 x 32 taps in bf16): a matrix-vector product in disguise, B * T_out operations per
// weight byte (16 at enc5 of one chunk), against the 295 at which the tensor cores become
// the limit. Reading the weights once, at 3.35 TB/s, bounds it (enc5: 10 us); at the
// smaller layers a launch's fixed costs do. The other routes' tiles put the rows on the
// MMA's M side (64 or 128 rows), so that most of each tile is empty, fill the card by
// cutting the depth into split-K slices whose fp32 partial sums of the whole output go
// through device memory to a second kernel, and, where T_out % 16 != 0, fall back to the
// FMA kernel.
//
// The design: one launch a layer that streams the weights once.
//   - Swap-AB: D (64 output channels x N rows) = W (64 x depth) . X (depth x N), the
//     output channels on the MMA's M side and the rows on its N side, in mma.sync m16n8k16
//     tiles: each of four warps takes 16 channels by N rows (N >= 32: eight warps, two a
//     16-channel group, each half the rows, so that every SM sub-partition has two warps to
//     hide the MMAs' latency). N = B * T_out of the block's tile rounded up to 8, 16, 32,
//     64, 128 or 256 (a template parameter); rows past the live ones are never stored. Row
//     n of the tile is (b, t) = divmod(r0 + n, T_out), so that a tile may cross batch rows
//     and T_out may be anything.
//   - The weights, in the wrapper's m64-tile order (``_rows_copy``: each 64 output
//     channels x one input-channel pair's 64 taps contiguous, 8 KB), come through a ring of
//     STAGES such tiles that one producer thread keeps full by TMA from the launch on (the
//     128-byte swizzle, csrc/tma_ring.cuh), and reach the MMAs by ldmatrix. Their tensor map
//     is encoded once per weight copy (`conv1d_rows_encode`, called when the wrapper makes
//     the copy) and handed to every launch: a call encodes none.
//   - x takes no tensor map: at these shapes a block's share of x is a few KB per input
//     channel. The consumer threads stage it once in shared memory, per input channel the
//     samples that each batch row of the tile reads, end to end, by one 1-D bulk copy (TMA)
//     per channel and batch row where x's rows are 16-byte aligned (G's pitched pad), by
//     plain loads where they are not and for the last samples before T_in; samples at or
//     past T_in are staged as 0. The MMAs' B fragments (2 x 2 taps of one row a lane) are
//     4-byte loads from there: no im2col copy of x, the windows of neighbouring rows
//     overlapping in place. (A wgmma form of the same swap-AB, which has to build each
//     stage's B tile in shared memory through the swizzle first, spent longer per stage:
//     PERF.md.)
//   - Split-K in a thread-block cluster: the input channels are cut into `cluster` slices
//     (1, 2, 4 or 8), one a block, so that the blocks of all output-channel tiles and row
//     tiles cover the card (the wrapper's `_rows_plan`), each streaming a disjoint part of
//     W. Each block pushes its fp32 partial sums through distributed shared memory into
//     the block that finishes their 64 / cluster channels, a slot per block; after one
//     cluster barrier each block adds its slots in rank order (the same order on every
//     run), adds the bias, applies the PReLU and stores y and pre. No workspace, no second
//     launch.
// tests/test_torch_conv1d_rows.py emulates these index maps in float64.

#include <algorithm>
#include <cstdint>
#include <cstring>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"
#include "tma_ring.cuh"

namespace {

using mma_conv::KP;  // taps, padded by the wrapper
using mma_conv::prelu;
using namespace tma_ring;

constexpr int BM = 64;                       // output channels per block: 4 warps of m16
constexpr int PAIR_BYTES = BM * 2 * KP * 2;  // 8 KB: an m64 tile's taps of two channels
constexpr int STAGES = 8;                    // ring stages, a channel pair each
constexpr int MAX_CLUSTER = 8;               // portable clusters
constexpr int MAX_SMEM = 232448;             // dynamic shared memory a block may use
constexpr int SEG_SLACK = 40;                // a batch row's staged samples past 4 a row
constexpr int CHANNEL_ALIGN = 8;             // the weight copy's channels, padded

// Where each piece lies in a block's dynamic shared memory, from a 1024-byte aligned
// base: the weight ring, the partial sums this block finishes (a slot of BM / cluster
// channels x (N + 4) rows, fp32, for each block of the cluster), x's windows (`slice`
// channels of `lr` samples), each row's window start in `raw` and its (b, t) offset in y,
// the tile's bias and slope, its batch rows' places in the windows (``Segment``: b, s0,
// base and the samples a bulk copy takes; then len), and the barriers. The wrapper's
// `_rows_smem` mirrors it.
struct Layout {
  int red, raw, rowoff, outbase, coef, segs, bars, bytes;
  __host__ __device__ Layout(int n, int slice, int lr) {
    red = STAGES * PAIR_BYTES;
    raw = red + BM * (n + 4) * 4;
    rowoff = raw + slice * lr * 2;
    outbase = (rowoff + 4 * n + 7) / 8 * 8;
    coef = outbase + 8 * n;
    segs = coef + 2 * BM * 4;
    bars = segs + 20 * n;
    bytes = 1024 + bars + (2 * STAGES + 1) * 8;  // and the slack to align the base
  }
};

// The consumer warps (4 or 8, the first warps of the block) and the producer warp after
// them: N of 32 or more splits each output-channel group's rows between two warps, so
// that each SM sub-partition has two warps to hide its MMAs' latency.
template <int N>
struct Warps {
  static constexpr int CONSUMERS = N >= 32 ? 8 : 4;
  static constexpr int CT = 32 * CONSUMERS;  // consumer threads
  static constexpr int THREADS = CT + 32;
  static constexpr int JT = N / 8 / (CONSUMERS / 4);  // n8 tiles of rows a warp
};

// The consumer warps' own barrier (barrier 0 is the block's).
template <int CT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CT) : "memory");
}

// Every thread of every block of the cluster: arrive (releasing this thread's writes),
// then wait for all (acquiring theirs).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The address of shared-memory address `addr` of this block in block `rank` of the
// cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b)
               : "memory");
}

// A 1-D bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16) from global `src`
// to shared `dst`, both 16-byte aligned, completing on barrier `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A's m16n8k16 fragments of rows 16 w .. 16 w + 15, taps 16 kk .. 16 kk + 15 of a weight
// tile (64 rows of 128 bytes, 128-byte swizzle): lane l gives row (l & 7) + 8 (l / 8 & 1)
// of chunk 2 kk + l / 16.
__device__ __forceinline__ void ldmatrix_a(uint32_t (&a)[4], uint32_t tile, int w, int kk,
                                           int lane) {
  const int row = 16 * w + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int chunk = 2 * kk + (lane >> 4);
  const uint32_t addr = tile + row * 128 + ((chunk ^ (row & 7)) << 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Where batch row b_first + j of a tile's rows lies in a channel's staged windows: its
// samples s0 .. s0 + len - 1 (s0 = 4 t of its first row, rounded down to 8), at `base`
// (a multiple of 8 samples: 16-byte aligned for the bulk copies).
struct Segment {
  int b, s0, len, base;
  __device__ Segment(int j, int r0, int n_live, int T_out, int b_first) {
    b = b_first + j;
    const int t_first = j == 0 ? r0 - b * T_out : 0;
    const int t_last = min(T_out - 1, r0 + n_live - 1 - b * T_out);
    s0 = 4 * t_first / 8 * 8;
    len = (4 * t_last + KP - s0 + 7) / 8 * 8;
    if (j == 0) {
      base = 0;
    } else {  // after the first batch row's samples and j - 1 whole ones
      const int t0 = r0 - b_first * T_out;
      const int first = (4 * min(T_out - 1, r0 + n_live - 1 - b_first * T_out) + KP -
                         4 * t0 / 8 * 8 + 7) / 8 * 8;
      base = first + (j - 1) * ((4 * (T_out - 1) + KP + 7) / 8 * 8);
    }
  }
};

// w_map: the weight copy in m64-tile order (``_rows_copy``): (Cout / 64) x (Cin8 / 2)
// tiles of 64 rows (output channels) x 64 taps (a channel pair), each tile 8 KB in a row,
// Cin8 = Cin rounded up to CHANNEL_ALIGN; a 2-D map of 64 taps x rows, boxes {64, 64},
// 128-byte swizzle. Grid (cluster, Cout / BM, row tiles), clusters of (cluster, 1, 1):
// block (r, m, z) takes output channels BM m .. BM m + 63, rows `rows_per_tile` z onward
// and input channels `slice` r onward (`slice` a multiple of 2), and finishes the
// channels `share` r onward of its tile. `lr` samples per channel of `raw`; `bulk`: x's
// rows start 16-byte aligned (pitch % 8 == 0).
template <int N>
__global__ void __launch_bounds__(Warps<N>::THREADS, 1)
conv1d_rows_kernel(const __grid_constant__ CUtensorMap w_map, const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ bias,
                   const __nv_bfloat16* __restrict__ slope, __nv_bfloat16* __restrict__ y,
                   __nv_bfloat16* __restrict__ pre, int B, int Cin, int T_in, int pitch,
                   int Cout, int T_out, int rows_per_tile, int slice, int lr, int bulk) {
  using W = Warps<N>;
  constexpr int CT = W::CT;
  constexpr int NP = N + 4;  // a channel's row of partial sums, padded
  const Layout L(N, slice, lr);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_base = smem_u32(smem_raw);
  const uint32_t base = (raw_base + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - raw_base);
  const uint32_t ring = base;
  __nv_bfloat16* const raw = reinterpret_cast<__nv_bfloat16*>(base_ptr + L.raw);
  const uint32_t raw_addr = base + L.raw;
  int* const rowoff = reinterpret_cast<int*>(base_ptr + L.rowoff);
  long long* const outbase = reinterpret_cast<long long*>(base_ptr + L.outbase);
  float* const coef = reinterpret_cast<float*>(base_ptr + L.coef);  // bias, slope
  const float* const red = reinterpret_cast<const float*>(base_ptr + L.red);
  int4* const segs = reinterpret_cast<int4*>(base_ptr + L.segs);  // b, s0, base, whole
  int* const seglen = reinterpret_cast<int*>(base_ptr + L.segs + 16 * N);
  const uint32_t full = base + L.bars;       // full[s] at full + 8 s
  const uint32_t empty = full + STAGES * 8;  // empty[s] at empty + 8 s
  const uint32_t x_bar = empty + STAGES * 8;

  const int cluster = gridDim.x;
  const int rank = blockIdx.x;  // the cluster spans the grid's x
  const int share = BM / cluster;  // output channels a block finishes
  const int m0 = blockIdx.y * BM;
  const int r0 = blockIdx.z * rows_per_tile;
  const long long M = (long long)B * T_out;
  const int n_live = (int)min((long long)rows_per_tile, M - r0);  // <= N
  const int b_first = r0 / T_out;
  const int nseg = (r0 + n_live - 1) / T_out - b_first + 1;  // batch rows the tile touches
  const int c_begin = rank * slice;
  const int nch = max(0, min(Cin, c_begin + slice) - c_begin);  // this block's channels
  const int iters = (nch + 1) / 2;  // ring stages: a channel pair each
  const int pieces = nch * nseg;    // x's copies: a channel's samples of a batch row
  const long long batch_stride = (long long)Cin * pitch;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);                // the producer's expect_tx
      mbar_init(empty + 8 * s, W::CONSUMERS);    // one arrival per consumer warp
    }
    mbar_init(x_bar, CT);  // every consumer thread's expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = tid; j < nseg; j += W::THREADS) {
    const Segment sg(j, r0, n_live, T_out, b_first);
    // the whole 16-byte units before T_in go by bulk copy where x's rows are aligned
    segs[j] = make_int4(sg.b, sg.s0, sg.base,
                        bulk ? min(sg.len, max(0, T_in - sg.s0) / 8 * 8) : 0);
    seglen[j] = sg.len;
  }
  __syncthreads();

  if (tid >= CT) {  // the producer warp
    if (tid == CT) {  // every weight copy, from the start
      // this block's first tile: m64 tile m's pair c_begin / 2
      const int tile0 = blockIdx.y * ((Cin + CHANNEL_ALIGN - 1) / CHANNEL_ALIGN *
                                      (CHANNEL_ALIGN / 2)) + c_begin / 2;
      for (int k = 0; k < iters; ++k) {
        const int s = k % STAGES;
        mbar_wait(empty + 8 * s, ((k / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + 8 * s, PAIR_BYTES);
        tma_load_2d(ring + s * PAIR_BYTES, &w_map, 0, (tile0 + k) * BM, full + 8 * s);
      }
    } else {  // the tile's bias and slope, for the epilogue
      for (int c = tid - CT - 1; c < BM; c += 31) {
        coef[c] = bias != nullptr ? __bfloat162float(bias[m0 + c]) : 0.f;
        coef[BM + c] = __bfloat162float(slope[m0 + c]);
      }
    }
    __syncwarp();
    cluster_sync();  // every block's partial sums are in their finishers' shared memory
    return;
  }

  // x's windows of this block's channels, once: for each channel and batch row of the
  // tile, the samples its rows' windows read, one bulk copy where x's rows start 16-byte
  // aligned, as far as whole 16-byte units lie before T_in; the rest (all of it where x's
  // rows are not aligned) by plain loads, the samples at or past T_in as 0
  {
    uint32_t bytes = 0;
    for (int i = tid; i < pieces; i += CT) bytes += 2 * segs[i % nseg].w;
    mbar_expect_tx(x_bar, bytes);  // this thread's arrival, with its copies' bytes
    for (int i = tid; i < pieces; i += CT) {
      const int c = i / nseg;
      const int4 sg = segs[i - c * nseg];
      if (sg.w > 0)
        bulk_load(raw_addr + 2 * (c * lr + sg.z),
                  x + sg.x * batch_stride + (long long)(c_begin + c) * pitch + sg.y, 2 * sg.w,
                  x_bar);
    }
  }
  for (int n = tid; n < N; n += CT) {  // row n: (b, t), its window in raw
    int off = 0;
    long long out = 0;
    if (n < n_live) {
      const int r = r0 + n;
      const int b = r / T_out;
      const int4 sg = segs[b - b_first];
      off = sg.z + 4 * (r - b * T_out) - sg.y;
      out = (long long)b * Cout * T_out + (r - b * T_out);
    }
    rowoff[n] = off;  // rows past the live ones read row 0's window, never stored
    outbase[n] = out;
  }
  {
    int rest = 0;  // samples a piece leaves to plain loads, at most
    for (int j = 0; j < nseg; ++j) rest = max(rest, seglen[j] - segs[j].w);
    for (int i = tid; i < pieces * rest; i += CT) {
      const int piece = i / rest;
      const int c = piece / nseg;
      const int j = piece - c * nseg;
      const int4 sg = segs[j];
      const int s = sg.w + i - piece * rest;
      if (s < seglen[j])
        raw[c * lr + sg.z + s] =
            sg.y + s < T_in
                ? x[sg.x * batch_stride + (long long)(c_begin + c) * pitch + sg.y + s]
                : __float2bfloat16(0.f);
    }
  }
  mbar_wait(x_bar, 0);
  consumer_sync<CT>();  // every thread's plain stores and row offsets

  // Warp w: output channels 16 (w % 4) .. + 15 by rows 8 j0 .. 8 (j0 + JT) - 1 (j0 = JT (w
  // / 4)), fp32 sums in mma.sync's accumulator layout: lane (g, t) holds channels
  // 16 (w % 4) + g (+ 8) and rows 8 (j0 + j) + 2 t (+ 1) in acc[j][e]
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int group = warp % 4;
  const int j0 = W::JT * (warp / 4);
  float acc[W::JT][4];
#pragma unroll
  for (int j = 0; j < W::JT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  {
    const int g = lane / 4;
    const int t = lane % 4;
    int ro[W::JT];  // this lane's rows' windows, 2 t samples on
#pragma unroll
    for (int j = 0; j < W::JT; ++j) ro[j] = rowoff[8 * (j0 + j) + g] + 2 * t;
    for (int k = 0; k < iters; ++k) {
      const int s = k % STAGES;
      mbar_wait(full + 8 * s, (k / STAGES) & 1);
      const uint32_t tile = ring + s * PAIR_BYTES;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // 16 taps a step: channel 2 k + kk / 2
        const int c = 2 * k + kk / 2;
        uint32_t a[4];
        ldmatrix_a(a, tile, group, kk, lane);
        if (c < nch) {  // B (tap x row) straight from the windows: taps 2 t, 2 t + 1 and
                        // 2 t + 8, 2 t + 9 of row 8 (j0 + j) + g
          const __nv_bfloat16* xc = raw + c * lr + 16 * (kk & 1);
#pragma unroll
          for (int j = 0; j < W::JT; ++j) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xc + ro[j]);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xc + ro[j] + 8);
            mma_conv::mma_bf16(acc[j], a, b0, b1);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  // The partial sums, pushed into the shared memory of the block that finishes their
  // channels (rank ch / share, slot this block's rank)
  {
    const int g = lane / 4;
    const int t = lane % 4;
    const uint32_t red_addr = base + L.red;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = 16 * group + g + 8 * h;
      const int owner = ch / share;
      const uint32_t dst = map_rank(
          red_addr + (uint32_t)((rank * share + ch - owner * share) * NP + 8 * j0 + 2 * t) *
                         4,
          owner);
#pragma unroll
      for (int j = 0; j < W::JT; ++j)
        st_cluster_f2(dst + 32 * j, acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
  cluster_sync();  // every block's partial sums are in their finishers' shared memory
  // This block's channels: the slots' sums in rank order, the bias, the PReLU
  for (int i = tid; i < share * n_live; i += CT) {
    const int cl = i / n_live;
    const int n = i - cl * n_live;
    float sum = red[cl * NP + n];
    for (int q = 1; q < cluster; ++q) sum += red[(q * share + cl) * NP + n];
    const int c = rank * share + cl;
    const float p = sum + coef[c];
    const long long o = outbase[n] + (long long)(m0 + c) * T_out;
    pre[o] = __float2bfloat16(p);
    y[o] = __float2bfloat16(prelu(p, coef[BM + c]));
  }
}

// The samples of x a block stages per input channel: its rows' windows, a batch row's
// from 4 t of its first row rounded down to 8, 32 samples past 4 t of its last, rounded
// up to 8: at most 4 a row and 40 a batch row the tile touches.
int raw_samples(int B, int T_out, int rows_per_tile) {
  const int nseg = std::min(B, (rows_per_tile + T_out - 2) / T_out + 1);
  return (4 * rows_per_tile + SEG_SLACK * nseg + 7) / 8 * 8;
}

template <int N>
int launch_rows(const CUtensorMap& map, const void* x, const void* bias, const void* slope,
                void* y, void* pre, int rows_per_tile, int cluster, int B, int Cin, int T_in,
                int pitch, int Cout, int T_out, cudaStream_t stream) {
  static bool ready[MAX_DEVICES] = {};
  const long long M = (long long)B * T_out;
  const long long tiles = (M + rows_per_tile - 1) / rows_per_tile;
  const int slice = ((Cin + cluster - 1) / cluster + 1) / 2 * 2;
  const int lr = raw_samples(B, T_out, rows_per_tile);
  const Layout L(N, slice, lr);
  if (L.bytes > MAX_SMEM || tiles > 65535) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!ready[device]) {  // once per device, so that a launch under graph capture sets nothing
    err = cudaFuncSetAttribute(conv1d_rows_kernel<N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    ready[device] = true;
  }
  const int bulk = reinterpret_cast<uintptr_t>(x) % 16 == 0 && pitch % 8 == 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)cluster, (unsigned)(Cout / BM), (unsigned)tiles);
  config.blockDim = dim3(Warps<N>::THREADS);
  config.dynamicSmemBytes = L.bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, conv1d_rows_kernel<N>, map,
                           static_cast<const __nv_bfloat16*>(x),
                           static_cast<const __nv_bfloat16*>(bias),
                           static_cast<const __nv_bfloat16*>(slope),
                           static_cast<__nv_bfloat16*>(y), static_cast<__nv_bfloat16*>(pre), B,
                           Cin, T_in, pitch, Cout, T_out, rows_per_tile, slice, lr, bulk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The tensor map of the weight copy `w` in m64-tile order (``_rows_copy``: (Cout / 64) x
// (Cin8 / 2) tiles of 64 x 64 bf16, Cin8 = Cin rounded up to 8), 16-byte aligned, as the
// kernel reads it, written into `map_out` (128 bytes of the caller's); the wrapper
// encodes it once per weight copy. Returns 0 or the encoder's error.
extern "C" int conv1d_rows_encode(void* map_out, const void* w, int Cout, int Cin) {
  if (Cout <= 0 || Cin <= 0 || Cout % BM != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int pairs = (Cin + CHANNEL_ALIGN - 1) / CHANNEL_ALIGN * (CHANNEL_ALIGN / 2);
  CUtensorMap map;
  const cudaError_t err = encode_w_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w,
                                       Cout / BM * pairs * BM, 2 * KP, 2 * KP, BM);
  if (err != cudaSuccess) return (int)err;
  std::memcpy(map_out, &map, sizeof map);
  return 0;
}

// The rows route, bfloat16, stride 4: x (B, Cin, T_in) with rows `pitch` elements apart
// (batch rows Cin * pitch apart; any alignment), `w_map` the weights' map from
// conv1d_rows_encode (128 bytes of host memory), bias (may be null) and slope (Cout,), y
// and pre (B, Cout, T_out). n (8, 16, 32, 64, 128, 256) is the MMA's width, at least
// rows_per_tile, the rows a block takes; cluster (1, 2, 4, 8, 16) the blocks that split
// the input channels. Needs Cin > 1, Cout % 64 == 0, T_out = (T_in - 32) / 4 + 1 or less
// with every window's samples past T_in read as 0, and a plan whose shared memory fits
// (the wrapper's `_rows_plan`). Launches on `stream` and returns the launch's error (0 on
// success); it does not synchronise, allocates nothing and encodes no tensor map.
extern "C" int conv1d_rows_launch(const void* x, const void* w_map, const void* bias,
                                  const void* slope, void* y, void* pre, int n,
                                  int rows_per_tile, int cluster, int B, int Cin, int T_in,
                                  int pitch, int Cout, int T_out, void* stream) {
  if (B <= 0 || Cin <= 1 || Cout <= 0 || Cout % BM != 0 || T_out <= 0 || pitch < T_in ||
      rows_per_tile <= 0 || rows_per_tile > n || cluster <= 0 || cluster > MAX_CLUSTER ||
      BM % cluster != 0 || 4LL * (T_out - 1) >= T_in || (long long)B * T_out >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  std::memcpy(&map, w_map, sizeof map);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define ROWS_CASE(N)                                                                       \
  case N:                                                                                  \
    return launch_rows<N>(map, x, bias, slope, y, pre, rows_per_tile, cluster, B, Cin,     \
                          T_in, pitch, Cout, T_out, s);
    ROWS_CASE(8)
    ROWS_CASE(16)
    ROWS_CASE(32)
    ROWS_CASE(64)
    ROWS_CASE(128)
    ROWS_CASE(256)
#undef ROWS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
