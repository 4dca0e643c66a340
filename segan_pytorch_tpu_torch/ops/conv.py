"""1-D convolution ops on torch's (B, C, T) layout, with the JAX package's semantics
(``segan_pytorch_tpu/ops/conv.py``).

Weights are in torch's layouts: conv (Cout, Cin, K), transposed conv (Cin, Cout, K).
The JAX package keeps (K, Cin, Cout) for both; ``utils/checkpoint.py`` converts.

Precision: the JAX package runs every fp32 conv and matmul at ``Precision.HIGHEST``.
cuDNN would run an fp32 conv in TF32 by default (``torch.backends.cudnn.allow_tf32`` is
True), about 1e-3 relative off, so every conv and matmul of the port goes through
``full_precision``, which turns TF32 off for fp32 inputs around the call and then restores
the caller's setting. Autograd runs a conv's backward after the forward's context has
closed, so the train step (``models/segan.py``) holds the same context around its
forward and backward passes both.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import torch
import torch.nn.functional as F


def reflect_pad_1d(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    """Reflect-pad the time axis of a (B, C, T) tensor, as ``jnp.pad(mode='reflect')``
    pads the JAX package's: torch's F.pad where it can (each pad shorter than T); a pad of
    T or more (G's deep layers on a short window: a stream of 2048 samples reaches enc5
    with T = 8 and pads it by 14 and 15) reflects again and again, a triangle wave of
    period 2 (T - 1) over the indices, which F.pad refuses."""
    if pad_left == 0 and pad_right == 0:
        return x
    T = x.shape[-1]
    if max(pad_left, pad_right) < T:
        return F.pad(x, (pad_left, pad_right), mode="reflect")
    idx = torch.arange(-pad_left, T + pad_right, device=x.device)
    period = 2 * (T - 1)
    if period:
        idx = torch.remainder(idx, period)
        idx = torch.where(idx >= T, period - idx, idx)
    else:
        idx = torch.zeros_like(idx)
    return x.index_select(-1, idx)


def zero_pad_1d(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    if pad_left == 0 and pad_right == 0:
        return x
    return F.pad(x, (pad_left, pad_right))


class _HeldFlags:
    """Holds process-wide backend flags at fixed values while any thread is inside, and
    gives back the values found when the first thread came in once the last one leaves.
    The flags are global, and several threads run G at once (a server's batchers, and its
    handler or WebSocket threads for unbatched streams): a context that restored its own
    entry values would turn a flag back on under another thread's conv. Re-entrant, so a
    caller may hold it around ops that enter it again. No other flag is touched
    (``torch.backends.cudnn.flags`` would reset ``enabled`` and ``benchmark`` too)."""

    def __init__(self, *flags):
        self._flags = flags  # (namespace, attribute, value inside)
        self._lock = threading.Lock()
        self._depth = 0
        self._saved = ()

    def __enter__(self):
        with self._lock:
            if self._depth == 0:
                self._saved = tuple(getattr(ns, name) for ns, name, _ in self._flags)
                for ns, name, value in self._flags:
                    setattr(ns, name, value)
            self._depth += 1

    def __exit__(self, *exc):
        with self._lock:
            self._depth -= 1
            if self._depth == 0:
                for (ns, name, _), value in zip(self._flags, self._saved):
                    setattr(ns, name, value)


# TF32 off for cuDNN's convs and cuBLAS's matmuls
_NO_TF32 = _HeldFlags((torch.backends.cudnn, "allow_tf32", False),
                      (torch.backends.cuda.matmul, "allow_tf32", False))
_NO_ONEDNN = _HeldFlags((torch.backends.mkldnn, "enabled", False))


def full_precision(dtype: torch.dtype):
    """The port's one TF32 policy: a context in which a conv of ``dtype`` runs as the
    JAX package's does. fp32 turns TF32 off; other dtypes need nothing."""
    return _NO_TF32 if dtype == torch.float32 else contextlib.nullcontext()


def at_least_fp32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, or as it is when wider: the dtype of statistics, losses and the PReLU's
    backward under bf16 compute (a float64 reference keeps its precision)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1, dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """VALID 1-D convolution: x (B, Cin, T), weight (Cout, Cin / groups, K) -> (B, Cout,
    T')."""
    with full_precision(x.dtype):
        return F.conv1d(x, weight, bias, stride=stride, dilation=dilation, groups=groups)


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (..., in) @ weight (out, in).T + bias: torch's ``F.linear``."""
    with full_precision(x.dtype):
        return F.linear(x, weight, bias)


def conv1d_weight(x: torch.Tensor, weight_shape: Sequence[int], grad: torch.Tensor,
                  stride: int = 1) -> torch.Tensor:
    """The gradient of ``conv1d`` with respect to its weight (Cout, Cin, K)."""
    with full_precision(x.dtype):
        return torch.nn.grad.conv1d_weight(x, weight_shape, grad, stride=stride)


def conv_transpose1d(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None, stride: int = 4,
                     padding: int = 0) -> torch.Tensor:
    """torch.nn.ConvTranspose1d semantics: x (B, Cin, L), weight (Cin, Cout, K) ->
    (B, Cout, (L-1)*stride + K - 2*padding). The JAX package computes this outside
    any Pallas kernel too.

    On the CPU it bypasses oneDNN: in the torch 2.13.0 CPU build, oneDNN's transposed
    conv returned sums off by 1.0-2.4 on outputs of magnitude 3-6 (held against
    float64) for 512 and more input channels, and differed from call to call; torch's
    own CPU kernel agrees with float64 to 2e-6."""
    with full_precision(x.dtype):
        if x.device.type != "cpu":
            return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding)
        with _NO_ONEDNN:
            return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding)
