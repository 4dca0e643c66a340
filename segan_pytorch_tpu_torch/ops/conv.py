"""1-D convolution ops on torch's (B, C, T) layout, with the JAX package's semantics
(``segan_pytorch_tpu/ops/conv.py``).

Weights are in torch's layouts: conv (Cout, Cin, K), transposed conv (Cin, Cout, K).
The JAX package keeps (K, Cin, Cout) for both; ``utils/checkpoint.py`` converts.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def reflect_pad_1d(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    """Reflect-pad the time axis of a (B, C, T) tensor (torch F.pad mode='reflect')."""
    if pad_left == 0 and pad_right == 0:
        return x
    return F.pad(x, (pad_left, pad_right), mode="reflect")


def zero_pad_1d(x: torch.Tensor, pad_left: int, pad_right: int) -> torch.Tensor:
    if pad_left == 0 and pad_right == 0:
        return x
    return F.pad(x, (pad_left, pad_right))


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
           stride: int = 1) -> torch.Tensor:
    """VALID 1-D convolution: x (B, Cin, T), weight (Cout, Cin, K) -> (B, Cout, T')."""
    return F.conv1d(x, weight, bias, stride=stride)


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
    if x.device.type != "cpu":
        return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        return F.conv_transpose1d(x, weight, bias, stride=stride, padding=padding)
    finally:
        torch.backends.mkldnn.enabled = prev
