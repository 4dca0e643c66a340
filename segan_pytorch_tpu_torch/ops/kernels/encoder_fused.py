"""Chained enc2 + enc3 forward: the port of the Pallas kernel
``segan_pytorch_tpu/ops/pallas/encoder_fused.py:fused_enc23_fwd``.

Two GConv1DBlocks of the SEGAN+ encoder (reflect pad (14, 15), stride-4 31-tap conv +
bias + PReLU) in one kernel, enc2's post-activation kept on chip. As in the JAX
package, no model calls it: its caller is the A/B tool
``segan_pytorch_tpu_torch/tools/encoder_fused_bench.py``. Three pieces, as for every
kernel of the port:

- ``enc23_plain``: the same function in plain PyTorch. CPU tensors take it, and the
  tests and ``chip_smoke.py`` hold the CUDA kernel against it.
- ``fused_enc23_fwd``: the wrapper. On a CPU tensor it returns the plain version; on a
  CUDA tensor it launches a hand-written kernel (``csrc/encoder_fused.cu``,
  ``csrc/encoder_fused_wgmma.cu``, ``csrc/encoder_fused_wgmma_tf32.cu``) or raises.
  Forward only, as the Pallas kernel.
- ``_launch``: the launch itself, which also takes preallocated outputs.

Five kernels on the card, chosen by dtype, shape and batch (``_route``), never as a
fallback: fp32 at SEGAN+'s widths (C2 128, C3 256) with h1 16-byte aligned, from
WGMMA_TF32_MIN_ROWS enc3 rows, runs by a 3xTF32 split on TF32 ``wgmma`` fed by a TMA ring
(``enc23_wgmma_tf32_kernel``, ``csrc/encoder_fused_wgmma_tf32.cu``, a library of its own),
enc3's depth split over a thread-block cluster of 1, 2 or 4 blocks chosen by batch
(``_wgmma_tf32_cluster``); other fp32 calls with C2 and C3 multiples of 8 run on
``mma.sync`` by the same split (``enc23_tf32_kernel``), with a tile of 16 or 32 enc3 rows
per block chosen by batch (``_tf32_tile``); any other fp32 shape runs FMAs on the CUDA
cores; bf16 at SEGAN+'s widths from WGMMA_MIN_ROWS enc3 rows runs on ``wgmma`` fed by a
TMA ring (``enc23_wgmma_kernel``, ``csrc/encoder_fused_wgmma.cu``, a library of its own),
other bf16 calls on ``mma.sync`` (``enc23_mma_kernel``), which needs C2 and C3 multiples
of 8. The tensor-core kernels take the weights padded to 32 taps, in fp32 split
into their TF32 parts (``conv1d_prelu._padded_weights``); the wgmma kernel takes w2 with
its taps permuted as the per-layer wgmma route's (``conv1d_prelu._permuted_weights``) and
w3 folded as the Pallas kernel's ``_fold_weights``, transposed (``_folded_weights``);
the fp32 wgmma kernel takes w2 split as ``enc23_tf32_kernel`` does and w3 folded, then
split (``_folded_weights``); each is made once per weight and version. ``launches``
counts all launches, ``launches_tf32`` those of ``enc23_tf32_kernel``, ``launches_tile16``
those of them at the tile of 16, ``launches_wgmma`` those of the bf16 wgmma kernel and
``launches_wgmma_tf32`` those of the fp32 one.

Layout (torch's, not the JAX package's): h1, enc1's post-activation, (B, C1, T1)
unpadded and contiguous, with T1 % 16 == 0 and T1 >= 64; w2 (C2, C1, 31); b2 (C2,) or
None; a2 (C2,); likewise w3, b3, a3 with C3. Outputs, in h1's dtype: pre2 (B, C2,
T1/4), pre3 and post3 (B, C3, T1/16). The Pallas kernel's ``batch_tile`` is a VMEM tiling
knob and has no counterpart here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..conv import reflect_pad_1d
from . import build
from .conv1d_prelu import (KP, _cached, _pad_taps, _padded_weights, _permuted_weights,
                           _sm_count, _split_tf32, conv1d_prelu_plain)

# kernel launches since the counter was last set to 0 (the wrapper alone adds to them):
# all of them, those of the fp32 mma.sync (3xTF32) kernel, of those the ones at the tile
# of 16 enc3 rows, those of the bf16 wgmma kernel and those of the fp32 (3xTF32) one
launches = 0
launches_tf32 = 0
launches_tile16 = 0
launches_wgmma = 0
launches_wgmma_tf32 = 0

K = 31  # taps and stride are fixed, as in the Pallas kernel
S = 4
PAD = (K // 2 - 1, K // 2)

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the bf16 wgmma kernel's widths and enc3 rows per block (csrc/encoder_fused_wgmma.cu)
WGMMA_C2, WGMMA_C3, WGMMA_TILE = 128, 256, 64
# enc3 rows (B T1 / 16) from which a bf16 call takes it (``_route``): one 16384-sample
# chunk, the least batch timed
WGMMA_MIN_ROWS = 256
# the same for the fp32 wgmma kernel (csrc/encoder_fused_wgmma_tf32.cu), which takes the
# bf16 one's widths and tile, and the cluster sizes it is built for
WGMMA_TF32_MIN_ROWS = 256
WGMMA_TF32_CLUSTERS = (1, 2, 4)
# w3 folded for the wgmma kernels (in fp32 also split), by the weight tensor it was made
# from: weight -> (its version when made, copy)
_folded = WeakIdKeyDictionary()
Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def enc23_plain(h1: torch.Tensor, w2: torch.Tensor, b2: Optional[torch.Tensor],
                a2: torch.Tensor, w3: torch.Tensor, b3: Optional[torch.Tensor],
                a3: torch.Tensor) -> Outputs:
    """The kernel's function in plain PyTorch: (pre2, pre3, post3)."""
    post2, pre2 = conv1d_prelu_plain(reflect_pad_1d(h1, *PAD), w2, b2, a2, S)
    # post2 is in h1's dtype, so in bf16 enc3 reads it rounded, as the kernels do
    post3, pre3 = conv1d_prelu_plain(reflect_pad_1d(post2, *PAD), w3, b3, a3, S)
    return pre2, pre3, post3


def _check(h1, w2, b2, a2, w3, b3, a3) -> None:
    if h1.dim() != 3 or w2.dim() != 3 or w3.dim() != 3:
        raise ValueError(f"need h1 (B, C1, T1), w2 (C2, C1, {K}) and w3 (C3, C2, {K}), got "
                         f"{tuple(h1.shape)}, {tuple(w2.shape)} and {tuple(w3.shape)}")
    _, c1, t1 = h1.shape
    c2, c3 = w2.shape[0], w3.shape[0]
    if t1 % (S * S) != 0:
        raise ValueError(f"T1 = {t1} must be a multiple of {S * S}")
    if t1 < 64:
        raise ValueError(f"T1 = {t1} < 64: the reflect pad of {PAD[1]} needs T1/{S} >= 16")
    if w2.shape[2] != K or w3.shape[2] != K:
        raise ValueError(f"the kernel has {K} taps, got w2 {tuple(w2.shape)} and "
                         f"w3 {tuple(w3.shape)}")
    if w2.shape[1] != c1 or w3.shape[1] != c2:
        raise ValueError(f"channels do not chain: h1 has {c1}, w2 is {tuple(w2.shape)}, "
                         f"w3 is {tuple(w3.shape)}")
    for name, v, c in (("b2", b2, c2), ("a2", a2, c2), ("b3", b3, c3), ("a3", a3, c3)):
        if v is not None and v.shape != (c,):
            raise ValueError(f"{name} must be ({c},), got {tuple(v.shape)}")
    tensors = [t for t in (h1, w2, b2, a2, w3, b3, a3) if t is not None]
    if any(t.device != h1.device for t in tensors):
        raise ValueError("h1, the weights, biases and slopes must lie on one device")
    if any(t.dtype != h1.dtype for t in tensors):
        raise TypeError(f"h1, the weights, biases and slopes must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")


def _wgmma_shape(dtype: torch.dtype, c2: int, c3: int, aligned: bool) -> bool:
    """Whether the wgmma kernel of the dtype (bf16 or fp32) takes the call: SEGAN+'s
    widths (C2 = 128, one MMA tile of phase A, cut over the fp32 kernel's cluster; C3 =
    256, n128 a consumer warpgroup) and h1 16-byte aligned, as TMA reads it (T1 % 16 == 0
    makes its rows so)."""
    return (dtype in _DTYPE_CODES and c2 == WGMMA_C2 and c3 == WGMMA_C3 and aligned)


def _route(dtype: torch.dtype, c2: int, c3: int, rows: int = 0,
           aligned: bool = True) -> str:
    """Which kernel a CUDA call takes, from its dtype, widths, enc3 rows (B T1 / 16) and
    whether h1 is 16-byte aligned: in fp32 "wgmma_tf32" where ``_wgmma_shape`` holds and
    the call has WGMMA_TF32_MIN_ROWS enc3 rows, "tf32" (``mma.sync`` by 3xTF32) for the
    other calls with whole n8 tiles of channels (C2 and C3 multiples of 8), "fma" for any
    other fp32 shape; "wgmma" for bf16 where ``_wgmma_shape`` holds and the call has
    WGMMA_MIN_ROWS enc3 rows, "mma" for the other bf16 calls (which need whole n8 tiles;
    ``_launch`` raises otherwise).

    The figures it rests on (``tools/encoder_fused_bench.py --device_batches``: the device
    alone, CUDA graphs of 10 calls through the C entry points; NVIDIA H100 80GB HBM3 at
    700.00 W): at SEGAN+'s widths the wgmma kernel took 0.083 ms against enc23_mma_kernel's
    0.151 at one chunk, 0.091 against 0.203 at 32, 0.171 against 0.417 at 64 and 0.801
    against 2.111 at 300; a wrapper call in turns 0.21 against 0.24 ms at one chunk. Fewer
    enc3 rows than a chunk's (T1 < 4096 at B = 1) were not timed: they keep mma.sync.
    In fp32 the wgmma kernel, at the cluster ``_wgmma_tf32_cluster`` picks, took 0.160 ms
    against enc23_tf32_kernel's 0.358 at one chunk, 0.234 against 0.402 at 8, 0.236
    against 0.692 at 16, 0.423 against 1.101 at 32, 0.840 against 2.182 at 64 and 4.121
    against 10.157 at 300 (the same tool and card, ``--dtype float32``): it takes every
    call from one chunk's enc3 rows, WGMMA_TF32_MIN_ROWS; fewer were not timed."""
    if dtype == torch.bfloat16:
        return ("wgmma" if _wgmma_shape(dtype, c2, c3, aligned) and rows >= WGMMA_MIN_ROWS
                else "mma")
    if _wgmma_shape(dtype, c2, c3, aligned) and rows >= WGMMA_TF32_MIN_ROWS:
        return "wgmma_tf32"
    return "tf32" if c2 % 8 == 0 and c3 % 8 == 0 else "fma"


def _fold_w3(w3: torch.Tensor) -> torch.Tensor:
    """w3 (C3, C2, 31) as the wgmma kernel's B of enc3, K-major: (C3, 32 C2) with
    w3f[co, 4 C2 q + C2 s + c] = w3[co, c, 4 q + s], tap 31 zero: the Pallas kernel's
    ``_fold_weights`` (KP, S Cin, Cout) with its axes (q, s c) flattened and transposed."""
    c3, c2 = w3.shape[:2]
    return (_pad_taps(w3.detach()).view(c3, c2, KP // S, S).permute(0, 2, 3, 1)
            .reshape(c3, KP * c2))


def _fold_split_w3(w3: torch.Tensor):
    """The wgmma kernels' w3: ``_fold_w3(w3)``, in fp32 split into its TF32 parts (a
    (big, small) pair, as ``conv1d_prelu._mma_weights`` splits)."""
    wf = _fold_w3(w3)
    return _split_tf32(wf) if w3.dtype == torch.float32 else wf


def _folded_weights(w3: torch.Tensor):
    """``_fold_split_w3(w3)``, made once per weight and version, under the rules of
    ``conv1d_prelu._padded_weights``."""
    return _cached(_folded, w3, _fold_split_w3)


def _tf32_tile(B: int, t1: int, num_sms: int) -> int:
    """enc3 rows per block of the 3xTF32 kernel: 32, unless its blocks would leave SMs
    idle (B * ceil(T3 / 32) < SMs, B <= 16 at T1 = 4096 on 132 SMs); then 16, which
    recomputes more of enc2's halo per row but fills twice the SMs. On the H100 TILE 16
    won at B = 1, 8 and 16 and lost at 32 and 64 (PERF.md)."""
    return 16 if B * -(-(t1 // (S * S)) // 32) < num_sms else 32


def _wgmma_tf32_cluster(B: int, t1: int, num_sms: int) -> int:
    """Blocks per cluster of the fp32 wgmma kernel, each taking C2 / cluster channels of
    post2 and enc3's depth over them for the cluster's 64 enc3 rows: 4 while 8 blocks a
    tile fit the SMs, else 2 while 2 do, else 1. A block of a larger cluster does less
    work less efficiently (every rank loads and splits the same h1 windows, its MMAs are
    narrower), so a cluster pays only where it fills idle SMs. On the H100 (132 SMs,
    ``tools/encoder_fused_bench.py --dtype float32 --device_batches ... --clusters 1 2
    4``, device ms; NVIDIA H100 80GB HBM3 at 700.00 W) at T1 = 4096: clusters of 1 / 2 /
    4 took 0.386 / 0.225 / 0.160 at B = 1, 0.390 / 0.229 / 0.161 at 4, 0.405 / 0.234 /
    0.318 at 8, 0.415 / 0.236 / 0.473 at 16, 0.422 / 0.467 / 0.791 at 32, 0.838 / 0.926
    / 1.444 at 64 and 4.143 / 4.305 / 6.461 at 300."""
    tiles = B * -(-(t1 // (S * S)) // WGMMA_TILE)
    return 4 if 8 * tiles <= num_sms else (2 if 2 * tiles <= num_sms else 1)


@functools.cache
def _entries():
    lib = build.load_library("encoder_fused")
    launch = lib.encoder_fused_launch
    launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    launch.restype = ctypes.c_int
    launch_tf32 = lib.encoder_fused_tf32_launch
    launch_tf32.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    launch_tf32.restype = ctypes.c_int
    return launch, launch_tf32


@functools.cache
def _wgmma_entry():
    """encoder_fused_wgmma_launch of csrc/encoder_fused_wgmma.cu, a library of its own."""
    fn = build.load_library("encoder_fused_wgmma").encoder_fused_wgmma_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_tf32_entry():
    """encoder_fused_wgmma_tf32_launch of csrc/encoder_fused_wgmma_tf32.cu, a library of
    its own."""
    fn = build.load_library("encoder_fused_wgmma_tf32").encoder_fused_wgmma_tf32_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(h1, w2, b2, a2, w3, b3, a3, out: Optional[Outputs] = None,
            force: Optional[str] = None, tile: Optional[int] = None,
            cluster: Optional[int] = None) -> Outputs:
    """Launch the kernel on checked CUDA tensors, into ``out`` (pre2, pre3, post3) when
    it is given, else into new tensors. For same-call comparisons only: ``force`` takes
    that route in place of ``_route``'s ("wgmma_tf32", "tf32" or "fma" in fp32, "wgmma"
    or "mma" in bf16; it raises where the route does not take the call), ``tile`` (16 or
    32) sets the fp32 ``mma.sync`` kernel's tile and ``cluster`` (1, 2 or 4) the fp32
    wgmma kernel's cluster."""
    global launches, launches_tf32, launches_tile16, launches_wgmma, launches_wgmma_tf32
    if h1.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {h1.dtype}")
    inputs = [t for t in (h1, w2, b2, a2, w3, b3, a3) if t is not None]
    if not all(t.is_contiguous() for t in inputs):
        raise ValueError("the CUDA kernel needs contiguous inputs")
    B, c1, t1 = h1.shape
    c2, c3 = w2.shape[0], w3.shape[0]
    if max(B, c1 * KP, t1, c2 * KP, c3) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit size arguments")
    aligned = h1.data_ptr() % 16 == 0
    fp32 = h1.dtype == torch.float32
    if force is None:
        route = _route(h1.dtype, c2, c3, B * (t1 // (S * S)), aligned)
    elif force in (("wgmma_tf32", "tf32", "fma") if fp32 else ("mma", "wgmma")):
        route = force
    else:
        raise ValueError(f"force={force!r} names no route of {h1.dtype}: 'wgmma_tf32', "
                         f"'tf32' or 'fma' in fp32, 'mma' or 'wgmma' in bf16")
    if route in ("wgmma", "wgmma_tf32") and not _wgmma_shape(h1.dtype, c2, c3, aligned):
        raise ValueError(f"the wgmma kernels take C2 = {WGMMA_C2}, C3 = {WGMMA_C3} and h1 "
                         f"16-byte aligned; got C2 = {c2}, C3 = {c3}")
    if route in ("mma", "tf32") and (c2 % 8 or c3 % 8):
        raise ValueError(f"the mma.sync kernels run whole n8 tiles of the tensor cores: C2 "
                         f"= {c2} and C3 = {c3} must be multiples of 8")
    if tile is not None and (route != "tf32" or tile not in (16, 32)):
        raise ValueError(f"tile (16 or 32) is the 3xTF32 mma.sync kernel's, got {tile} on "
                         f"the {route} route")
    if cluster is not None and (route != "wgmma_tf32" or cluster not in WGMMA_TF32_CLUSTERS):
        raise ValueError(f"cluster {WGMMA_TF32_CLUSTERS} is the fp32 wgmma kernel's, got "
                         f"{cluster} on the {route} route")
    if route == "wgmma":
        w2, w3 = _permuted_weights(w2), _folded_weights(w3)
    elif route == "wgmma_tf32":
        w2, w3 = _padded_weights(w2), _folded_weights(w3)
    elif route != "fma":
        w2, w3 = _padded_weights(w2), _padded_weights(w3)
    shapes = ((B, c2, t1 // S), (B, c3, t1 // (S * S)), (B, c3, t1 // (S * S)))
    if out is None:
        out = tuple(torch.empty(s, dtype=h1.dtype, device=h1.device) for s in shapes)
    elif any(o.shape != s or o.dtype != h1.dtype or o.device != h1.device
             or not o.is_contiguous() for o, s in zip(out, shapes)):
        raise ValueError(f"out must be contiguous {h1.dtype} tensors on {h1.device} of "
                         f"shapes {shapes}")
    pre2, pre3, post3 = out
    if route == "wgmma" and (pre3.data_ptr() % 16 or post3.data_ptr() % 16):
        raise ValueError("the wgmma kernel stores 16-byte units: pre3 and post3 must be "
                         "16-byte aligned")
    ptr = lambda v: v.data_ptr() if v is not None else None
    with torch.cuda.device(h1.device):
        stream = torch.cuda.current_stream(h1.device).cuda_stream
        if route == "wgmma":
            err = _wgmma_entry()(h1.data_ptr(), w2.data_ptr(), ptr(b2), a2.data_ptr(),
                                 w3.data_ptr(), ptr(b3), a3.data_ptr(), pre2.data_ptr(),
                                 pre3.data_ptr(), post3.data_ptr(), B, c1, t1, c2, c3,
                                 stream)
        elif route == "wgmma_tf32":
            if cluster is None:
                cluster = _wgmma_tf32_cluster(B, t1, _sm_count(h1.device.index))
            err = _wgmma_tf32_entry()(h1.data_ptr(), w2[0].data_ptr(), w2[1].data_ptr(),
                                      ptr(b2), a2.data_ptr(), w3[0].data_ptr(),
                                      w3[1].data_ptr(), ptr(b3), a3.data_ptr(),
                                      pre2.data_ptr(), pre3.data_ptr(), post3.data_ptr(),
                                      cluster, B, c1, t1, c2, c3, stream)
        elif route == "tf32":
            if tile is None:
                tile = _tf32_tile(B, t1, _sm_count(h1.device.index))
            err = _entries()[1](h1.data_ptr(), w2[0].data_ptr(), w2[1].data_ptr(),
                                ptr(b2), a2.data_ptr(), w3[0].data_ptr(), w3[1].data_ptr(),
                                ptr(b3), a3.data_ptr(), pre2.data_ptr(), pre3.data_ptr(),
                                post3.data_ptr(), tile, B, c1, t1, c2, c3, stream)
        else:
            err = _entries()[0](_DTYPE_CODES[h1.dtype], h1.data_ptr(), w2.data_ptr(),
                                ptr(b2), a2.data_ptr(), w3.data_ptr(), ptr(b3),
                                a3.data_ptr(), pre2.data_ptr(), pre3.data_ptr(),
                                post3.data_ptr(), B, c1, t1, c2, c3, stream)
    if err != 0:
        raise RuntimeError(f"encoder_fused kernel launch failed ({route} route): "
                           f"cudaError {err}")
    launches += 1
    launches_wgmma += route == "wgmma"
    launches_wgmma_tf32 += route == "wgmma_tf32"
    if route == "tf32":
        launches_tf32 += 1
        launches_tile16 += tile == 16
    return pre2, pre3, post3


def fused_enc23_fwd(h1: torch.Tensor, w2: torch.Tensor, b2: Optional[torch.Tensor],
                    a2: torch.Tensor, w3: torch.Tensor, b3: Optional[torch.Tensor],
                    a3: torch.Tensor) -> Outputs:
    """Chained enc2 + enc3 forward: (pre2, pre3, post3). pre2 and pre3 are the skip
    tensors; post3 feeds enc4.

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    _check(h1, w2, b2, a2, w3, b3, a3)
    if h1.device.type == "cpu":
        return enc23_plain(h1, w2, b2, a2, w3, b3, a3)
    if h1.device.type != "cuda":
        raise ValueError(f"fused_enc23_fwd runs on cpu or cuda, not {h1.device}")
    return _launch(h1, w2, b2, a2, w3, b3, a3)
