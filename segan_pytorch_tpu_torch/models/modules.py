"""Generator building blocks as torch ``nn.Module``s on the (B, C, T) layout: the
counterparts of ``segan_pytorch_tpu/models/modules.py``.

Parameter names and layouts are the upstream torch state_dict's ('conv.weight'
(Cout, Cin, K), 'deconv.weight' (Cin, Cout, K), 'act.weight' (C,), ...), so a
reference-format checkpoint loads strictly. Every module draws its initial values
from the ``torch.Generator`` it is given.

Only the norm-free blocks are ported: ``bnorm`` and ``snorm`` raise
``NotImplementedError`` (ROADMAP.md, queue A item 1).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops import initializers as init
from ..ops.kernels.conv1d_prelu import conv1d_prelu


def _check_norm(norm_type: Optional[str]):
    if norm_type in ("bnorm", "snorm"):
        raise NotImplementedError(
            f"norm_type={norm_type!r} is not ported yet (ROADMAP.md, queue A item 1: "
            f"BatchNorm1d and spectral norm)")
    if norm_type not in (None, "none"):
        raise TypeError(f"Unrecognized norm type: {norm_type}")


class PReLU(nn.Module):
    """Per-channel PReLU over (B, C, T), slope 'weight' of shape (C,)."""

    def __init__(self, num_parameters: int, init_val: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((num_parameters,), float(init_val)))

    def forward(self, x):
        a = self.weight.view(1, -1, 1)
        return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


class Conv1d(nn.Module):
    """VALID conv1d; callers pad. weight (Cout, Cin, K) ~ N(0, 0.02), bias zeros."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 1,
                 use_bias: bool = True, w_init: Callable = init.normal_002,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(w_init((out_ch, in_ch, kwidth), generator))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        return conv_ops.conv1d(x, self.weight, self.bias, self.stride)


class ConvTranspose1d(nn.Module):
    """torch nn.ConvTranspose1d semantics, with torch's default init: weight (Cin, Cout,
    K) and bias ~ U(±1/sqrt(Cout*K)). The upstream SEGAN init never matches this layer."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 4,
                 padding: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(
            init.torch_default_convT_weight((in_ch, out_ch, kwidth), generator))
        self.bias = nn.Parameter(
            init.torch_default_bias((out_ch,), out_ch * kwidth, generator))

    def forward(self, x):
        return conv_ops.conv_transpose1d(x, self.weight, self.bias, self.stride,
                                         self.padding)


class GConv1DBlock(nn.Module):
    """Reflect pad -> conv1d (+ bias) -> PReLU (slope init 0), norm-free.

    The pad is asymmetric, (K//2 - 1, K//2), when strided and symmetric otherwise. The
    conv, bias and PReLU run as one fused op (``ops/kernels/conv1d_prelu.py``): the
    hand-written kernel on a CUDA device, its plain version on the CPU. The
    ``use_pallas`` switch of the JAX package has no counterpart here."""

    def __init__(self, ninp: int, fmaps: int, kwidth: int, stride: int = 1,
                 use_bias: bool = True, norm_type: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_norm(norm_type)
        self.kwidth, self.stride = kwidth, stride
        self.conv = Conv1d(ninp, fmaps, kwidth, stride=stride, use_bias=use_bias,
                           generator=generator)
        self.act = PReLU(fmaps, init_val=0.0)

    def forward(self, x, ret_linear: bool = False):
        kw = self.kwidth
        pad = (kw // 2 - 1, kw // 2) if self.stride > 1 else (kw // 2, kw // 2)
        x_p = conv_ops.reflect_pad_1d(x, *pad)
        h, a = conv1d_prelu(x_p, self.conv.weight, self.conv.bias, self.act.weight,
                            self.stride)
        return (h, a) if ret_linear else h


class GDeconv1DBlock(nn.Module):
    """ConvTranspose1d with padding max(0, (stride - K)//-2), the last sample trimmed
    when K is odd, then PReLU (slope init 0), Tanh or ReLU.

    The deconv always has a bias, even under --no_bias: the upstream block accepts a
    bias argument but never passes it on, and the checkpoints carry 'deconv.bias'."""

    def __init__(self, ninp: int, fmaps: int, kwidth: int, stride: int = 4,
                 norm_type: Optional[str] = None, act: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_norm(norm_type)
        if act not in (None, "Tanh", "ReLU"):
            raise TypeError(f"Unsupported deconv act: {act}")
        self.kwidth = kwidth
        self.deconv = ConvTranspose1d(ninp, fmaps, kwidth, stride=stride,
                                      padding=max(0, (stride - kwidth) // -2),
                                      generator=generator)
        self.act_name = act
        if act is None:
            self.act = PReLU(fmaps, init_val=0.0)

    def forward(self, x):
        h = self.deconv(x)
        if self.kwidth % 2 != 0:
            h = h[:, :, :-1]
        if self.act_name == "Tanh":
            return torch.tanh(h)
        if self.act_name == "ReLU":
            return torch.relu(h)
        return self.act(h)
