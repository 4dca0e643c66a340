"""Fused strided conv1d + bias + PReLU: the port of the Pallas kernel
``segan_pytorch_tpu/ops/pallas/conv1d.py:fused_conv1d_prelu``.

Three pieces, as for every kernel of the port:

- ``conv1d_prelu_plain``: the same function in plain PyTorch. CPU tensors take it, and
  the tests and ``chip_smoke.py`` hold the CUDA kernel against it.
- ``fused_conv1d_prelu``: the wrapper. On a CPU tensor it returns the plain version; on
  a CUDA tensor it launches the hand-written kernel (``csrc/conv1d_prelu.cu``) or raises.
  ``launches`` counts the wrapper's calls that launch the kernel, ``launches_mma`` those
  of them that took the tensor-core route (both dtypes), ``launches_tf32`` those of them
  in fp32. A call under CUDA graph capture records the launch into the graph and counts
  once; the graph's replays run the kernel again and move no counter.
- Two routes on the card, chosen by shape (``_route``), never as a fallback: stride 4,
  K <= 32, Cout % 8 == 0 and T_out % 16 == 0 (every main-path layer) runs on the tensor
  cores (``mma.sync``: bf16 as it is, fp32 by a 3xTF32 split), with the weights padded
  to 32 taps (``_pad_taps``) and in fp32 split into their TF32 parts (``_split_tf32``),
  once per weight and version (``_padded_weights``; never while a CUDA graph is being
  captured, which records the pad instead); every other shape runs the FMA kernel.
- ``conv1d_prelu``: the differentiable op (``Conv1dPReLU``). Its backward mirrors the
  JAX custom VJP ``_bwd`` in plain torch ops, as the JAX backward is not a kernel either.

Layout (torch's, not the JAX package's): x (B, Cin, T_in), already padded; w (Cout,
Cin, K); b (Cout,) or None; a (Cout,). Both outputs, y = PReLU(pre) and pre =
conv(x, w) + b, are (B, Cout, T_out) in x's dtype, with T_out = (T_in - K)//stride + 1.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..conv import at_least_fp32, conv1d, conv1d_weight, conv_transpose1d
from . import build

# kernel launches since the counter was last set to 0 (the wrapper alone adds to them):
# all of them, those of the tensor-core route, and of those the fp32 (3xTF32) ones
launches = 0
launches_mma = 0
launches_tf32 = 0
# the counters and the weight cache are shared by every thread that runs G (the server's
# two batchers do)
_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KP = 32  # taps of the tensor-core kernels' weights: K and zero taps
MMA_MIN_SLICE = 4  # input channels per split-K slice of the MMA route, at least
# the MMA route's padded weights, by the weight tensor they were made from:
# weight -> (its version when padded, padded copy)
_padded = WeakIdKeyDictionary()


def _pad_taps(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, K <= 32) weights as (Cout, Cin, 32), the taps past K zero: the
    counterpart of the Pallas kernels' ``_fold_weights``, which pad 31 taps to 32 too. A
    stride-4 conv with these gives the same rows: a window's extra taps add zero."""
    return F.pad(w, (0, KP - w.shape[-1])).contiguous()


def _tf32_round(v: torch.Tensor) -> torch.Tensor:
    """float32 v rounded to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` rounds: to
    nearest, ties away from zero, on the 13 low bits of the bit pattern (a carry goes
    into the exponent, so the largest finite values round to infinity). NaN stays NaN."""
    r = ((v.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)
    return torch.where(torch.isnan(v), v, r)


def _split_tf32(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """float32 v as its two TF32 parts (big, small): big = tf32(v) and small =
    tf32(v - big), so that v = big + small to about 2^-22 |v|."""
    big = _tf32_round(v)
    return big, _tf32_round(v - big)


def _mma_weights(w: torch.Tensor):
    """The tensor-core route's weights: (Cout, Cin, 32) padded in bf16; in fp32 also
    split, a (big, small) pair of them (a pair, not one stacked tensor: indexing a
    tensor on every call costs the wrapper microseconds)."""
    wp = _pad_taps(w.detach())
    return _split_tf32(wp) if w.dtype == torch.float32 else wp


def _padded_weights(w: torch.Tensor):
    """``_mma_weights(w)``, made once while w lives and is not changed in place, so that
    a model's forward pads no weight on every call (at a batch of one chunk the host time
    of the pad is as long as the kernel). A change in place is seen by w's version
    counter, which an optimizer step or ``load_state_dict`` bumps and which autograd
    also relies on; writes through ``w.data`` bypass it, as they bypass autograd, and so
    do a CUDA graph's replays, after which the graph's owner bumps the versions of what it
    wrote (``models/multistep.py``). While a stream is capturing, the pad (and split) is
    recorded into the graph and the cache is neither read nor written: an entry taken
    then would feed every replay the weights of capture time."""
    # inference tensors keep no version counter
    if torch.is_inference(w) or _capturing():
        return _mma_weights(w)
    with _lock:
        hit = _padded.get(w)
        if hit is None or hit[0] != w._version:
            hit = _padded[w] = (w._version, _mma_weights(w))
    return hit[1]


def _capturing() -> bool:
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _route(dtype: torch.dtype, cout: int, k: int, stride: int, t_out: int) -> str:
    """Which kernel a CUDA call takes: "mma" (tensor cores; fp32 by 3xTF32) for bf16 or
    fp32 with stride 4, K <= 32, whole n8 tiles of channels and whole m16 tiles of time
    steps, so that an m16 tile never spans two batch rows; "fma" for every other shape."""
    if (dtype in _DTYPE_CODES and stride == 4 and k <= KP and cout % 8 == 0
            and t_out % 16 == 0):
        return "mma"
    return "fma"


def _mma_plan(B: int, cin: int, cout: int, t_out: int, num_sms: int) -> Tuple[int, int]:
    """(warps_m, splits) of the MMA route, both dtypes. The block tile is warps_m x
    (8 / warps_m) warps of 64 rows x 32 channels: 4 x 2 for Cout <= 64 (enc1), 2 x 4 for
    Cout <= 128 and more than 64 rows (enc2), else 1 x 8, the widest, which stages the
    least x per MMA."""
    warps_m = 4 if cout <= 64 else (2 if cout <= 128 and B * t_out > 64 else 1)
    return warps_m, _mma_splits(B, cin, cout, t_out, num_sms, warps_m)


def _mma_splits(B: int, cin: int, cout: int, t_out: int, num_sms: int,
                warps_m: int) -> int:
    """Split-K slices of the MMA route for a tile of warps_m x (8 / warps_m) warps: when
    the tiles would not give every SM a block, the input channels are cut into slices of
    at least MMA_MIN_SLICE, aiming at two blocks per SM. Counts the slices, none of them
    empty, as the kernel cuts them."""
    tiles = -(-B * t_out // (64 * warps_m)) * -(-cout // (256 // warps_m))
    splits = 1
    if tiles < num_sms:
        splits = max(1, min(-(-2 * num_sms // tiles), cin // MMA_MIN_SLICE))
    per = -(-cin // splits)
    return -(-cin // per)


def _prelu(pre: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(pre, 0) + a.view(1, -1, 1) * torch.clamp_max(pre, 0)


def conv1d_prelu_plain(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       a: torch.Tensor, stride: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: (y, pre)."""
    pre = conv1d(x, w, b, stride)
    return _prelu(pre, a), pre


def _check(x, w, b, a, stride) -> int:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"need x (B, Cin, T_in) and w (Cout, Cin, K), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    B, cin, t_in = x.shape
    cout, w_cin, k = w.shape
    if w_cin != cin:
        raise ValueError(f"x has {cin} channels, w expects {w_cin}")
    if a.shape != (cout,) or (b is not None and b.shape != (cout,)):
        raise ValueError(f"b and a must be ({cout},), got "
                         f"{None if b is None else tuple(b.shape)} and {tuple(a.shape)}")
    if not isinstance(stride, int) or stride < 1:
        raise ValueError(f"stride must be a positive int, got {stride!r}")
    t_out = (t_in - k) // stride + 1
    if t_out < 1:
        raise ValueError(f"input of length {t_in} is shorter than the kernel ({k})")
    tensors = [x, w, a] + ([b] if b is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, w, b and a must lie on one device")
    if any(t.dtype != x.dtype for t in tensors):
        raise TypeError(f"x, w, b and a must share one dtype, got "
                        f"{[t.dtype for t in tensors]}")
    return t_out


@functools.cache
def _entries():
    lib = build.load_library("conv1d_prelu")
    launch = lib.conv1d_prelu_launch
    launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
    launch.restype = ctypes.c_int
    splits = lib.conv1d_prelu_splits
    splits.argtypes = [ctypes.c_int] * 6
    splits.restype = ctypes.c_int
    launch_mma = lib.conv1d_prelu_mma_launch
    launch_mma.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    launch_mma.restype = ctypes.c_int
    launch_tf32 = lib.conv1d_prelu_tf32_launch
    launch_tf32.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    launch_tf32.restype = ctypes.c_int
    return launch, splits, launch_mma, launch_tf32


@functools.cache
def _sm_count(device_index) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch(x, w, b, a, stride: int, t_out: int,
            out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
            force_fma: bool = False):
    """Launch the kernel on checked CUDA tensors, into ``out`` (y, pre) when it is
    given, else into new tensors. ``force_fma`` takes the FMA kernel whatever the shape,
    for same-call comparisons of the two routes."""
    global launches, launches_mma, launches_tf32
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16, got {x.dtype}")
    if not all(t.is_contiguous() for t in (x, w, a) + ((b,) if b is not None else ())):
        raise ValueError("the CUDA kernel needs contiguous x, w, b and a")
    B, cin, t_in = x.shape
    cout, _, k = w.shape
    if max(B, cin * KP, t_in, cout) >= 2 ** 31:
        raise ValueError("a dimension exceeds the kernel's 32-bit size arguments")
    route = "fma" if force_fma else _route(x.dtype, cout, k, stride, t_out)
    shape = (B, cout, t_out)
    if out is None:
        out = (torch.empty(shape, dtype=x.dtype, device=x.device),
               torch.empty(shape, dtype=x.dtype, device=x.device))
    elif any(o.shape != shape or o.dtype != x.dtype or o.device != x.device
             or not o.is_contiguous() for o in out):
        raise ValueError(f"out must be two contiguous {x.dtype} tensors on {x.device} of "
                         f"shape {shape}")
    y, pre = out
    tf32 = route == "mma" and x.dtype == torch.float32
    if route == "mma" and not tf32 and (y.data_ptr() % 16 or pre.data_ptr() % 16):
        raise ValueError("the bf16 MMA route stores 16-byte units: y and pre must be "
                         "16-byte aligned")
    launch, splits_of, launch_mma, launch_tf32 = _entries()
    if route == "mma":
        warps_m, splits = _mma_plan(B, cin, cout, t_out, _sm_count(x.device.index))
        w = _padded_weights(w)
    else:
        splits = splits_of(B, cin, cout, t_out, k, _sm_count(x.device.index))
    # split-K workspace: fp32 partial sums, one (B, Cout, T_out) slab per depth slice
    partial = (torch.empty((splits, B, cout, t_out), dtype=torch.float32, device=x.device)
               if splits > 1 else None)
    w_ptrs = (w[0].data_ptr(), w[1].data_ptr()) if tf32 else (w.data_ptr(),)
    ptrs = (x.data_ptr(), *w_ptrs, b.data_ptr() if b is not None else None,
            a.data_ptr(), y.data_ptr(), pre.data_ptr(),
            partial.data_ptr() if partial is not None else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if tf32:
            err = launch_tf32(*ptrs, warps_m, splits, B, cin, t_in, cout, t_out, stream)
        elif route == "mma":
            err = launch_mma(*ptrs, warps_m, splits, B, cin, t_in, cout, t_out, stream)
        else:
            err = launch(_DTYPE_CODES[x.dtype], *ptrs, splits, B, cin, t_in, cout, t_out,
                         k, stride, stream)
    if err != 0:
        raise RuntimeError(f"conv1d_prelu kernel launch failed ({route} route): "
                           f"cudaError {err}")
    with _lock:
        launches += 1
        if route == "mma":
            launches_mma += 1
            launches_tf32 += tf32
    return y, pre


def fused_conv1d_prelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                       a: torch.Tensor, stride: int = 4
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, pre) = (PReLU(conv(x, w) + b, a), conv(x, w) + b).

    CPU tensors take the plain version; CUDA tensors launch the kernel or raise."""
    t_out = _check(x, w, b, a, stride)
    if x.device.type == "cpu":
        return conv1d_prelu_plain(x, w, b, a, stride)
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv1d_prelu runs on cpu or cuda, not {x.device}")
    return _launch(x, w, b, a, stride, t_out)


class Conv1dPReLU(torch.autograd.Function):
    """Differentiable ``fused_conv1d_prelu``; backward as the JAX ``_bwd``."""

    @staticmethod
    def forward(ctx, x, w, b, a, stride):
        y, pre = fused_conv1d_prelu(x, w, b, a, stride)
        ctx.stride = stride
        ctx.has_bias = b is not None
        ctx.save_for_backward(x, w, a, pre)
        return y, pre

    @staticmethod
    def backward(ctx, gy, gpre):
        x, w, a, pre = ctx.saved_tensors
        s = ctx.stride
        # PReLU: dpre = gy * (pre > 0 ? 1 : a) + gpre; da = sum gy * min(pre, 0)
        af = at_least_fp32(a).view(1, -1, 1)
        gyf, pref = at_least_fp32(gy), at_least_fp32(pre)
        dpre = torch.where(pref > 0, gyf, gyf * af) + at_least_fp32(gpre)
        da = (gyf * torch.clamp_max(pref, 0)).sum(dim=(0, 2)).to(a.dtype)
        db = dpre.sum(dim=(0, 2)).to(a.dtype) if ctx.has_bias else None
        dpre = dpre.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_transpose1d(dpre, w, stride=s)
            # when (T_in - K) % stride != 0 the last samples touch no window: zero grad
            dx = F.pad(dx, (0, x.shape[2] - dx.shape[2]))
        if ctx.needs_input_grad[1]:
            dw = conv1d_weight(x, w.shape, dpre, stride=s)
        return dx, dw, db, da, None


def conv1d_prelu(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 a: torch.Tensor, stride: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable fused conv + bias + PReLU; see the module docstring."""
    return Conv1dPReLU.apply(x, w, b, a, stride)
