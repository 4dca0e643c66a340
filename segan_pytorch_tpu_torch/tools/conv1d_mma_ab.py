"""Where the time of the per-layer tensor-core kernels goes, and what their design
choices buy: a same-call A/B of source variants of ``conv1d_mma_kernel`` (bf16) and
``conv1d_tf32_kernel`` (fp32, with its mainloop in csrc/mma_tf32.cuh) of
csrc/conv1d_prelu.cu on one CUDA device.

    python -m segan_pytorch_tpu_torch.tools.conv1d_mma_ab [--batch 1 64 300]
        [--dtype bfloat16 float32]

Each variant is the kernel's source with its edits, built with the port's nvcc flags
into build/conv1d_mma_ab/<dtype>/<name>/ (all at once) and bound with ctypes. bf16:

  as is                 : the kernel the wrapper launches
  no MMAs               : the mainloop's MMAs skipped (staging, epilogue, split-K remain)
  no staging            : x not staged into shared memory (the MMAs read what it holds)
  no stores             : y and pre not stored (split-K partial sums still are)
  staging per element   : each thread stages successive elements of the chunk, with a
                          division, a modulo and a 64-bit address for each
  stores from fragments : y and pre stored straight from the MMA fragments, 2 bytes a
                          lane, not through shared memory

The first three edits add a condition that is false at run time (``slice < 0``), so the
compiler keeps the code around them. fp32 (3xTF32):

  as is                      : the kernel the wrapper launches: w split by the wrapper,
                               x split in registers at fragment load, y and pre stored
                               straight from the fragments
  w split in registers       : w loaded unsplit (the padded weights) and split after the
                               load, in every warp, for every channel
  x split at staging         : x split once as it is staged, into two planes of shared
                               memory (32 windows at a time, not 64), the mainloop loading
                               both parts
  stores through shared memory : y and pre through shared memory, 16 bytes a lane, as
                               the bf16 kernel stores them
  one sum in the tensor cores: every MMA straight into the accumulators, without the
                               partial sums of half a channel added by fp32 adds
                               (diagnostic: the tensor cores' sums are not rounded to
                               nearest, and this fails 1e-4 at enc5 for B = 300)
  fresh sums from a zero C   : the first MMA of each partial sum takes C = 0, not
                               sixteen registers zeroed for it
  1 block per SM             : launch bounds of one block per SM, so up to 255 registers
                               a thread (the kernel as is: two blocks, 128, and spills)
  1xTF32                     : big x big alone (diagnostic: the cost of the other two
                               MMAs; its error is TF32's, ~1e-3)

For the layers with Cout > 128, 'tile 2x4' runs the kernel as is on the 128 x 128 block
tile instead of the 64 x 256 one the wrapper picks; in fp32, 'FMA kernel' runs
``conv1d_prelu_kernel<float>`` (the FMA route) from the same library, with its own
split-K. At the five SEGAN+ encoder shapes (x padded as G pads it), for each dtype and
batch, it holds each variant that computes
the function against the plain version (into NaN-filled outputs; 2e-2 in bf16, 1e-4 in
fp32), then times every variant and cuDNN's ``F.conv1d`` (TF32 off in fp32) in turns
(CUDA events, median of 20 after 3 warm-ups), per layer and summed over the encoder.
'as is' minus a diagnostic variant is what that part costs beyond what overlaps it. The
CLI needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops.kernels import build
from ..ops.kernels import conv1d_prelu as K
from .encoder_fused_bench import ms_in_turns

_STAGE_FIXED = """    for (int p = threadIdx.x; p < NQ * W; p += THREADS) {
      const int q = p / W;
      const int j = p - q * W;
      const bool inside = j < q_len[q];
      const __nv_bfloat16* src = x + q_in[q] + (long long)c0 * pitch + j;
#pragma unroll 8
      for (int c = 0; c < cc; ++c)
        smem[c * NQ * W + p] = inside ? src[(long long)c * pitch] : __float2bfloat16(0.f);
    }
"""
_STAGE_PER_ELEMENT = """    for (int e = threadIdx.x; e < cc * NQ * W; e += THREADS) {
      const int c = e / (NQ * W);
      const int q = (e / W) % NQ;
      const int j = e % W;
      smem[e] = j < q_len[q] ? x[q_in[q] + (long long)(c0 + c) * pitch + j]
                             : __float2bfloat16(0.f);
    }
"""
_EPILOGUE_START = "  // y and pre through shared memory"
_EPILOGUE_END = "    __syncwarp();  // the tile is read before the next pass writes it\n  }\n"
_STORES_FROM_FRAGMENTS = """#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j >= nt_live) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int co = n0 + 8 * j + 2 * t + (e & 1);
      const float bco = bias != nullptr ? __bfloat162float(bias[co]) : 0.f;
      const float aco = __bfloat162float(slope[co]);
#pragma unroll
      for (int i = 0; i < MMA_MT; ++i) {
        if (i >= mt_live) continue;
        const long long off =
            q_out[wm * MMA_MT + i] + (long long)co * T_out + g + 8 * (e >> 1);
        const float p = acc[i][j][e] + bco;
        pre[off] = __float2bfloat16(p);
        y[off] = __float2bfloat16(prelu(p, aco));
      }
    }
  }
"""


def _epilogue_from_fragments(src: str) -> str:
    i, j = src.index(_EPILOGUE_START), src.index(_EPILOGUE_END) + len(_EPILOGUE_END)
    return src[:i] + _STORES_FROM_FRAGMENTS + src[j:]


# bf16: name -> (text of conv1d_mma_kernel, its replacement), or a function of the source
EDITS = {
    "as is": None,
    "no MMAs": ("    if (mt_live > 0 && nt_live > 0)\n      warp_conv_mma",
                "    if (mt_live > 0 && nt_live > 0 && slice < 0)\n      warp_conv_mma"),
    "no staging": ("for (int p = threadIdx.x; p < NQ * W; p += THREADS) {",
                   "for (int p = threadIdx.x; p < NQ * W * (slice < 0); p += THREADS) {"),
    "no stores": ("      if (i < mt_live && cl < 8 * nt_live) {",
                  "      if (i < mt_live && cl < 8 * nt_live && slice < 0) {"),
    "staging per element": (_STAGE_FIXED, _STAGE_PER_ELEMENT),
    "stores from fragments": _epilogue_from_fragments,
}
UNWRITTEN = ("no MMAs", "no staging", "no stores")  # they leave y and pre unwritten
# their outputs are not the function's within the tolerance: errors printed, not held
DIAGNOSTIC = UNWRITTEN + ("one sum in the tensor cores", "1xTF32")
CHANS = [1, 64, 128, 256, 512, 1024]  # SEGAN+ encoder widths
T = 16384  # samples per chunk
# each kernel's text in csrc/conv1d_prelu.cu: from its launch bounds to its launcher
REGIONS = {"bfloat16": ("conv1d_mma_kernel(const", "int launch_mma("),
           "float32": ("__launch_bounds__(THREADS, 2)\nconv1d_tf32_kernel(const",
                       "int launch_tf32(")}
HEADER = "mma_tf32.cuh"  # the fp32 kernel's mainloop

_TF32_EPILOGUE_START = "  // Straight from the fragments"
_TF32_STORES_THROUGH_SMEM = """  if (partial != nullptr) {  // split-K: fp32 partial sums; the epilogue kernel finishes
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
  // y and pre through shared memory, one m16 tile at a time: each warp puts its 32
  // channels x 16 rows there (padded rows of 20), then writes 16 bytes a lane
  __syncthreads();  // every warp is done with the x chunk
  constexpr int LD = 20;
  float* tile = smem + warp * 32 * LD;
#pragma unroll
  for (int i = 0; i < MMA_MT; ++i) {
    if (i >= mt_live) continue;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {  // pre, then y
      float* out = pass == 0 ? pre : y;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j >= nt_live) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t + (e & 1);
          const float p = acc[i][j][e] + (bias != nullptr ? bias[n0 + cl] : 0.f);
          tile[cl * LD + g + 8 * (e >> 1)] = pass == 0 ? p : prelu(p, slope[n0 + cl]);
        }
      }
      __syncwarp();
      // 32 channels x 4 runs of 4 rows: lane l of step s takes unit s * 32 + l
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int u = s * 32 + lane;
        const int cl = u >> 2;
        if (cl < 8 * nt_live)
          *reinterpret_cast<float4*>(out + q_out[wm * MMA_MT + i] +
                                     (long long)(n0 + cl) * T_out + 4 * (u & 3)) =
              *reinterpret_cast<const float4*>(tile + cl * LD + 4 * (u & 3));
      }
      __syncwarp();  // the tile is read before the next pass writes it
    }
  }
}

"""


def _tf32_stores_through_smem(src: str) -> str:
    i = src.index(_TF32_EPILOGUE_START)
    j = src.index("template <int WM>\nint launch_tf32(")
    return src[:i] + _TF32_STORES_THROUGH_SMEM + src[j:]


# fp32: name -> edits, each (file, text, its replacement) with the file "cu" (the text
# within conv1d_tf32_kernel) or "cuh" (csrc/mma_tf32.cuh), or a function of the .cu source
TF32_EDITS = {
    "as is": [],
    "w split in registers": [("cuh", """        bb[j] = j < nt_live ? __ldg(reinterpret_cast<const uint4*>(w_big + o))
                            : make_uint4(0, 0, 0, 0);
        bs[j] = j < nt_live ? __ldg(reinterpret_cast<const uint4*>(w_small + o))
                            : make_uint4(0, 0, 0, 0);
""", """        const float4 v = j < nt_live ? __ldg(reinterpret_cast<const float4*>(w_big + o))
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
        split_tf32(v.x, bb[j].x, bs[j].x);
        split_tf32(v.y, bb[j].y, bs[j].y);
        split_tf32(v.z, bb[j].z, bs[j].z);
        split_tf32(v.w, bb[j].w, bs[j].w);
""")],
    "x split at staging": [
        ("cu", "constexpr int CC = STAGED_TF32 / NQ;", "constexpr int CC = STAGED_TF32 / (2 * NQ);"),
        ("cu", "CC * NQ == STAGED_TF32,", "2 * CC * NQ == STAGED_TF32,"),
        ("cu", """        smem[c * NQ * W + p] = inside ? src[(long long)c * pitch] : 0.f;
""", """      {
        uint32_t big, small;
        mma_conv::split_tf32(inside ? src[(long long)c * pitch] : 0.f, big, small);
        smem[2 * c * NQ * W + p] = __uint_as_float(big);
        smem[(2 * c + 1) * NQ * W + p] = __uint_as_float(small);
      }
"""),
        ("cu", "NQ * W, 0, mt_live,", "2 * NQ * W, 0, mt_live,"),
        ("cuh", """          uint32_t ab[4], as[4];
          split_tf32(r0.x, ab[0], as[0]);
          split_tf32(r8.x, ab[1], as[1]);
          split_tf32(r0.y, ab[2], as[2]);
          split_tf32(r8.y, ab[3], as[3]);
""", """          const float2 s0 = *reinterpret_cast<const float2*>(p + lda / 2);
          const float2 s8 = *reinterpret_cast<const float2*>(p + lda / 2 + S * 8);
          const uint32_t ab[4] = {__float_as_uint(r0.x), __float_as_uint(r8.x),
                                  __float_as_uint(r0.y), __float_as_uint(r8.y)};
          const uint32_t as[4] = {__float_as_uint(s0.x), __float_as_uint(s8.x),
                                  __float_as_uint(s0.y), __float_as_uint(s8.y)};
""")],
    "stores through shared memory": _tf32_stores_through_smem,
    "one sum in the tensor cores": [
        ("cuh", """        float part[NT][4] = {};
""", ""), ("cuh", "mma_3xtf32(part[j], ab, as,", "mma_3xtf32(acc[i][j], ab, as,"),
        ("cuh", """#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[j][e];
""", "")],
    "fresh sums from a zero C": [("cuh", """// One warp's share""", """// d = a b + 0: the first MMA of a fresh partial sum, without zeroed registers
__device__ __forceinline__ void mma_tf32_zero_c(float (&d)[4], const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// One warp's share"""), ("cuh", "        float part[NT][4] = {};\n", "        float part[NT][4];\n"),
        ("cuh", """              mma_3xtf32(part[j], ab, as, s ? bb[j].z : bb[j].x, s ? bb[j].w : bb[j].y,
                         s ? bs[j].z : bs[j].x, s ? bs[j].w : bs[j].y);""", """              if (s == 0) {
                mma_tf32_zero_c(part[j], as, bb[j].x, bb[j].y);
                mma_tf32(part[j], ab, bs[j].x, bs[j].y);
                mma_tf32(part[j], ab, bb[j].x, bb[j].y);
              } else {
                mma_3xtf32(part[j], ab, as, bb[j].z, bb[j].w, bs[j].z, bs[j].w);
              }""")],
    "1 block per SM": [("cu", "__launch_bounds__(THREADS, 2)\nconv1d_tf32_kernel(",
                        "__launch_bounds__(THREADS, 1)\nconv1d_tf32_kernel(")],
    "1xTF32": [("cuh", """  mma_tf32(c, a_small, b0_big, b1_big);
  mma_tf32(c, a_big, b0_small, b1_small);
""", "")],
}
UNSPLIT_W = ("w split in registers",)  # variants that take the padded weights unsplit


def _edit(src: str, old: str, new: str, name: str, region=None) -> str:
    """src with `old` replaced by `new`, inside `region` (its start and end texts) when
    given; raises unless `old` occurs there exactly once."""
    i = src.index(region[0]) if region else 0
    j = src.index(region[1], i) if region else len(src)
    if src[i:j].count(old) != 1:
        raise RuntimeError(f"variant {name!r}: its edit no longer matches the source")
    return src[:i] + src[i:j].replace(old, new) + src[j:]


def variant_sources() -> Dict[str, str]:
    """The bf16 kernel's variants: csrc/conv1d_prelu.cu with each edit; raises if an edit
    does not apply exactly once."""
    src = (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    out = {}
    for name, edit in EDITS.items():
        if edit is None:
            out[name] = src
        elif callable(edit):
            out[name] = edit(src)
        else:
            out[name] = _edit(src, *edit, name, REGIONS["bfloat16"])
    return out


def tf32_variant_sources() -> Dict[str, Tuple[str, str]]:
    """The fp32 kernel's variants: (csrc/conv1d_prelu.cu, csrc/mma_tf32.cuh) with each
    variant's edits; raises if an edit does not apply exactly once."""
    cu0 = (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    cuh0 = (build.CSRC_DIR / HEADER).read_text()
    out = {}
    for name, edits in TF32_EDITS.items():
        cu, cuh = cu0, cuh0
        if callable(edits):
            cu = edits(cu)
        else:
            for where, old, new in edits:
                if where == "cu":
                    cu = _edit(cu, old, new, name, REGIONS["float32"])
                else:
                    cuh = _edit(cuh, old, new, name)
        out[name] = (cu, cuh)
    return out


def _variant_dir(dtype: str, name: str):
    return build.BUILD_DIR.parent / "conv1d_mma_ab" / dtype / name.replace(" ", "_")


def _build(dtype: str, name: str, src: str, header: Optional[str] = None):
    """Compile a variant into build/conv1d_mma_ab/<dtype>/<name>/ and bind its
    tensor-core entry point. `header`, when given, is its csrc/mma_tf32.cuh, found
    beside the source before csrc/."""
    d = _variant_dir(dtype, name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "conv1d_prelu.cu").write_text(src)
    if header is not None:
        (d / HEADER).write_text(header)
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                           "-o", str(lib), str(d / "conv1d_prelu.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    if dtype == "float32":
        fn = ctypes.CDLL(str(lib)).conv1d_prelu_tf32_launch
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    else:
        fn = ctypes.CDLL(str(lib)).conv1d_prelu_mma_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the A/B; returns {(dtype, batch, layer or "sum"): {arm: ms}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 64, 300])
    ap.add_argument("--dtype", nargs="+", choices=("bfloat16", "float32"),
                    default=["bfloat16", "float32"])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv1d_mma_ab needs a CUDA device")
    jobs = []  # (dtype, variant, .cu source, mma_tf32.cuh or None)
    if "bfloat16" in args.dtype:
        jobs += [("bfloat16", n, src, None) for n, src in variant_sources().items()]
    if "float32" in args.dtype:
        jobs += [("float32", n, cu, cuh) for n, (cu, cuh) in tf32_variant_sources().items()]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per variant, all at once
        built = list(pool.map(lambda job: _build(*job), jobs))
    fns: Dict[str, Dict[str, object]] = {}
    for (dtype, name, _, _), fn in zip(jobs, built):
        fns.setdefault(dtype, {})[name] = fn
    if "float32" in args.dtype:  # the FMA kernel of the fp32 library as is
        fma_lib = ctypes.CDLL(str(_variant_dir("float32", "as is") / "lib.so"))
        fma_lib.conv1d_prelu_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                                                + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fma_lib.conv1d_prelu_splits.argtypes = [ctypes.c_int] * 6
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's fp32 conv as the port runs it
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"tensor-core kernel variants on {torch.cuda.get_device_name(0)}", flush=True)
    g = torch.Generator().manual_seed(0)
    res = {}
    for dtype_name in args.dtype:
        dtype = getattr(torch, dtype_name)
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
        for B in args.batch:
            t_out = T
            for layer in range(5):
                t_out //= 4
                cin, cout, t_in = CHANS[layer], CHANS[layer + 1], 4 * t_out + 29  # G's pads
                x = torch.randn((B, cin, t_in), generator=g).to(dtype).cuda()
                w = (torch.randn((cout, cin, 31), generator=g) / (cin * 31) ** 0.5
                     ).to(dtype).cuda()
                a = (torch.rand((cout,), generator=g) * 0.3).to(dtype).cuda()
                padded = K._pad_taps(w)
                # the weights each variant takes: bf16 padded; fp32 split, or padded twice
                # for the variants that split them themselves
                parts = K._split_tf32(padded) if dtype == torch.float32 else None
                warps_m, splits = K._mma_plan(B, cin, cout, t_out, sms)
                outs = [torch.full((B, cout, t_out), float("nan"), dtype=dtype,
                                   device="cuda") for _ in range(2)]
                stream = torch.cuda.current_stream().cuda_stream

                def launch(fn, name, tile=(warps_m, splits)):
                    part = (torch.empty((tile[1], B, cout, t_out), dtype=torch.float32,
                                        device="cuda") if tile[1] > 1 else None)
                    if parts is None:
                        ws = (padded.data_ptr(),)
                    elif name in UNSPLIT_W:
                        ws = (padded.data_ptr(), padded.data_ptr())
                    else:
                        ws = (parts[0].data_ptr(), parts[1].data_ptr())
                    err = fn(x.data_ptr(), *ws, None, a.data_ptr(), outs[0].data_ptr(),
                             outs[1].data_ptr(), part.data_ptr() if part is not None else None,
                             tile[0], tile[1], B, cin, t_in, t_in, cout, t_out, 4, stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: cudaError {err}")

                def launch_fma(lib):
                    fma_splits = lib.conv1d_prelu_splits(B, cin, cout, t_out, 31, sms)
                    part = (torch.empty((fma_splits, B, cout, t_out), dtype=torch.float32,
                                        device="cuda") if fma_splits > 1 else None)
                    err = lib.conv1d_prelu_launch(
                        0, x.data_ptr(), w.data_ptr(), None, a.data_ptr(), outs[0].data_ptr(),
                        outs[1].data_ptr(), part.data_ptr() if part is not None else None,
                        fma_splits, B, cin, t_in, t_in, cout, t_out, 31, 4, stream)
                    if err != 0:
                        raise RuntimeError(f"launch failed: cudaError {err}")

                arms = {name: (lambda fn=fn, name=name: launch(fn, name))
                        for name, fn in fns[dtype_name].items()}
                if cout > 128:
                    tile = (2, K._mma_splits(B, cin, cout, t_out, sms, 2))
                    arms["tile 2x4"] = lambda: launch(fns[dtype_name]["as is"], "as is", tile)
                if dtype == torch.float32:
                    arms["FMA kernel"] = lambda: launch_fma(fma_lib)
                ref = K.conv1d_prelu_plain(x, w, None, a, 4)
                errs = {}
                for name, arm in arms.items():
                    if name in UNWRITTEN:
                        continue
                    for o in outs:
                        o.fill_(float("nan"))
                    arm()
                    errs[name] = max(_rel_err(o, r) for o, r in zip(outs, ref))
                    if name not in DIAGNOSTIC and not errs[name] <= tol:  # NaN fails too
                        raise AssertionError(f"{dtype_name} B={B} enc{layer + 1}: {name!r} "
                                             f"vs plain {errs[name]:.3e} > {tol}")
                del ref
                arms["cuDNN"] = lambda: F.conv1d(x, w, stride=4)
                ms = ms_in_turns(arms)
                res[dtype_name, B, layer + 1] = ms
                flops = 2.0 * B * t_out * cout * cin * 31
                print(f"{dtype_name} B={B} enc{layer + 1} (tile {warps_m}x{8 // warps_m} "
                      f"warps, {splits} splits): "
                      + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
                      + f" ms; as is {flops / ms['as is'] * 1e-9:.1f} TFLOP/s; rel err vs "
                      + "plain " + ", ".join(f"{n} {e:.1e}" for n, e in errs.items()),
                      flush=True)
            res[dtype_name, B, "sum"] = {
                n: sum(res[dtype_name, B, layer][n] for layer in range(1, 6))
                for n in res[dtype_name, B, 1]}
            print(f"{dtype_name} B={B} encoder sum: " + ", ".join(
                f"{n} {v:.4f}" for n, v in res[dtype_name, B, "sum"].items()) + " ms",
                flush=True)
    return res


if __name__ == "__main__":
    main()
