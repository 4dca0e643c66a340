"""Where the time of the per-layer tensor-core kernel goes, and what its design choices
buy: a same-call A/B of source variants of ``conv1d_mma_kernel`` (csrc/conv1d_prelu.cu)
on one CUDA device.

    python -m segan_pytorch_tpu_torch.tools.conv1d_mma_ab [--batch 1 64 300]

Each variant is the kernel's source with one edit, built with the port's nvcc flags
into build/conv1d_mma_ab/<name>/ (all at once) and bound with ctypes:

  as is                 : the kernel the wrapper launches
  no MMAs               : the mainloop's MMAs skipped (staging, epilogue, split-K remain)
  no staging            : x not staged into shared memory (the MMAs read what it holds)
  no stores             : y and pre not stored (split-K partial sums still are)
  staging per element   : each thread stages successive elements of the chunk, with a
                          division, a modulo and a 64-bit address for each
  stores from fragments : y and pre stored straight from the MMA fragments, 2 bytes a
                          lane, not through shared memory

The first three edits add a condition that is false at run time (``slice < 0``), so the
compiler keeps the code around them. For the layers with Cout > 128, 'tile 2x4' runs the
kernel as is on the 128 x 128 block tile instead of the 64 x 256 one the wrapper picks.
At the five SEGAN+ encoder shapes in bf16 (x padded as G pads it), for each batch, it
holds each variant that computes the function against the plain version (into
NaN-filled outputs), then times every variant and cuDNN's ``F.conv1d`` in turns (CUDA
events, median of 20 after 3 warm-ups), per layer and summed over the encoder. 'as is'
minus a diagnostic variant is what that part costs beyond what overlaps it. The CLI
needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from ..ops.kernels import build
from ..ops.kernels import conv1d_prelu as K
from .encoder_fused_bench import ms_in_turns

_STAGE_FIXED = """    for (int p = threadIdx.x; p < NQ * WG; p += THREADS) {
      const int q = p / WG;
      const int j = p - q * WG;
      const bool inside = j < q_len[q];
      const __nv_bfloat16* src = x + q_in[q] + (long long)c0 * T_in + j;
#pragma unroll 8
      for (int c = 0; c < cc; ++c)
        smem[c * NQ * WG + p] = inside ? src[(long long)c * T_in] : __float2bfloat16(0.f);
    }
"""
_STAGE_PER_ELEMENT = """    for (int e = threadIdx.x; e < cc * NQ * WG; e += THREADS) {
      const int c = e / (NQ * WG);
      const int q = (e / WG) % NQ;
      const int j = e % WG;
      smem[e] = j < q_len[q] ? x[q_in[q] + (long long)(c0 + c) * T_in + j]
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


# name -> (text of csrc/conv1d_prelu.cu, its replacement), or a function of the source
EDITS = {
    "as is": None,
    "no MMAs": ("    if (mt_live > 0 && nt_live > 0)\n      warp_conv_mma",
                "    if (mt_live > 0 && nt_live > 0 && slice < 0)\n      warp_conv_mma"),
    "no staging": ("for (int p = threadIdx.x; p < NQ * WG; p += THREADS) {",
                   "for (int p = threadIdx.x; p < NQ * WG * (slice < 0); p += THREADS) {"),
    "no stores": ("      if (i < mt_live && cl < 8 * nt_live) {",
                  "      if (i < mt_live && cl < 8 * nt_live && slice < 0) {"),
    "staging per element": (_STAGE_FIXED, _STAGE_PER_ELEMENT),
    "stores from fragments": _epilogue_from_fragments,
}
DIAGNOSTIC = ("no MMAs", "no staging", "no stores")  # their outputs are not the function's
CHANS = [1, 64, 128, 256, 512, 1024]  # SEGAN+ encoder widths
T = 16384  # samples per chunk


def variant_sources() -> Dict[str, str]:
    """The source of each variant; raises if an edit does not apply exactly once."""
    src = (build.CSRC_DIR / "conv1d_prelu.cu").read_text()
    out = {}
    for name, edit in EDITS.items():
        if edit is None:
            out[name] = src
        elif callable(edit):
            out[name] = edit(src)
        elif src.count(edit[0]) == 1:
            out[name] = src.replace(*edit)
        else:
            raise RuntimeError(f"variant {name!r}: its edit no longer matches "
                               f"csrc/conv1d_prelu.cu")
    return out


def _build(name: str, src: str):
    d = build.BUILD_DIR.parent / "conv1d_mma_ab" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "conv1d_prelu.cu").write_text(src)
    lib = d / "lib.so"
    proc = subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC_DIR),
                           "-o", str(lib), str(d / "conv1d_prelu.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name!r}:\n{proc.stderr}")
    fn = ctypes.CDLL(str(lib)).conv1d_prelu_mma_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _rel_err(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the A/B; returns {(batch, layer or "sum"): {arm: ms}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[1, 64, 300])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("conv1d_mma_ab needs a CUDA device")
    sources = variant_sources()
    with ThreadPoolExecutor(len(sources)) as pool:
        fns = dict(zip(sources, pool.map(_build, sources, sources.values())))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"conv1d_mma_kernel variants on {torch.cuda.get_device_name(0)}", flush=True)
    g = torch.Generator().manual_seed(0)
    res = {}
    for B in args.batch:
        t_out = T
        for layer in range(5):
            t_out //= 4
            cin, cout, t_in = CHANS[layer], CHANS[layer + 1], 4 * t_out + 29  # G's pads
            x = torch.randn((B, cin, t_in), generator=g).bfloat16().cuda()
            w = (torch.randn((cout, cin, 31), generator=g) / (cin * 31) ** 0.5
                 ).bfloat16().cuda()
            a = (torch.rand((cout,), generator=g) * 0.3).bfloat16().cuda()
            wp = K._pad_taps(w)
            warps_m, splits = K._mma_plan(B, cin, cout, t_out, sms)
            outs = [torch.full((B, cout, t_out), float("nan"), dtype=torch.bfloat16,
                               device="cuda") for _ in range(2)]
            stream = torch.cuda.current_stream().cuda_stream

            def launch(fn, tile=(warps_m, splits)):
                part = (torch.empty((tile[1], B, cout, t_out), dtype=torch.float32,
                                    device="cuda") if tile[1] > 1 else None)
                err = fn(x.data_ptr(), wp.data_ptr(), None, a.data_ptr(), outs[0].data_ptr(),
                         outs[1].data_ptr(), part.data_ptr() if part is not None else None,
                         tile[0], tile[1], B, cin, t_in, cout, t_out, stream)
                if err != 0:
                    raise RuntimeError(f"launch failed: cudaError {err}")

            arms = {name: (lambda fn=fn: launch(fn)) for name, fn in fns.items()}
            if cout > 128:
                tile = (2, K._mma_splits(B, cin, cout, t_out, sms, 2))
                arms["tile 2x4"] = lambda: launch(fns["as is"], tile)
            ref = K.conv1d_prelu_plain(x, w, None, a, 4)
            for name, arm in arms.items():
                if name in DIAGNOSTIC:
                    continue
                for o in outs:
                    o.fill_(float("nan"))
                arm()
                err = max(_rel_err(o, r) for o, r in zip(outs, ref))
                if not err <= 2e-2:  # NaN fails too
                    raise AssertionError(f"B={B} enc{layer + 1}: {name!r} vs plain {err:.3e}")
            arms["cuDNN"] = lambda: F.conv1d(x, w, stride=4)
            ms = ms_in_turns(arms)
            res[B, layer + 1] = ms
            flops = 2.0 * B * t_out * cout * cin * 31
            print(f"B={B} enc{layer + 1} (tile {warps_m}x{8 // warps_m} warps, {splits} "
                  f"splits): " + ", ".join(f"{n} {v:.4f}" for n, v in ms.items())
                  + f" ms; as is {flops / ms['as is'] * 1e-9:.1f} TFLOP/s", flush=True)
        res[B, "sum"] = {n: sum(res[B, layer][n] for layer in range(1, 6))
                         for n in res[B, 1]}
        print(f"B={B} encoder sum: " + ", ".join(
            f"{n} {v:.4f}" for n, v in res[B, "sum"].items()) + " ms", flush=True)
    return res


if __name__ == "__main__":
    main()
