"""Generator and Discriminator building blocks as torch ``nn.Module``s on the (B, C, T)
layout: the counterparts of ``segan_pytorch_tpu/models/modules.py``.

Parameter names and layouts are the upstream torch state_dict's ('conv.weight'
(Cout, Cin, K), 'deconv.weight' (Cin, Cout, K), 'act.weight' (C,), 'norm.running_mean',
...), so a reference-format checkpoint loads strictly. Every module draws its initial
values from the ``torch.Generator`` it is given.

Norms: ``bnorm`` is ported for GConv1DBlock (the Discriminator's blocks); a bnorm
GDeconv1DBlock (a bnorm generator) raises ``NotImplementedError`` (ROADMAP.md, queue A
item 7). ``snorm`` (spectral norm, WSEGAN's) is ported for every conv, deconv, Linear and
the PReLUs of D's heads, with the state names of torch's legacy
``nn.utils.spectral_norm``: the parameter 'weight_orig' and the buffers 'weight_u' and
'weight_v' (see ``spectral_weight``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops import initializers as init
from ..ops.kernels.conv1d_prelu import conv1d_prelu


def _check_norm(norm_type: Optional[str], bnorm: bool = False):
    """Refuse the norms a block does not have: bnorm unless ``bnorm``."""
    if norm_type == "bnorm" and not bnorm:
        raise NotImplementedError(
            "a bnorm GDeconv1DBlock (gnorm_type='bnorm') is not ported yet (ROADMAP.md, "
            "queue A item 7)")
    if norm_type not in (None, "none", "bnorm", "snorm"):
        raise TypeError(f"Unrecognized norm type: {norm_type}")


# ---------------------------------------------------------------------------
# spectral norm: the counterpart of spectral_normalize / declare_spectral
# ---------------------------------------------------------------------------
def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """v / (||v|| + eps), the JAX package's form (torch's divides by max(||v||, eps))."""
    return v / (torch.linalg.vector_norm(v) + eps)


def declare_spectral(module: nn.Module, weight: torch.Tensor, rows: int, cols: int,
                     generator: Optional[torch.Generator]):
    """Give `module` the state of torch's legacy spectral norm: the unnormalised weight as
    the parameter 'weight_orig', and the power iteration's u (rows,) and v (cols,) as the
    fp32 buffers 'weight_u' and 'weight_v', drawn N(0, 1) from `generator` and
    normalised."""
    module.weight_orig = nn.Parameter(weight)
    u = torch.empty(rows).normal_(generator=generator)
    v = torch.empty(cols).normal_(generator=generator)
    module.register_buffer("weight_u", _l2normalize(u))
    module.register_buffer("weight_v", _l2normalize(v))


def spectral_weight(module: nn.Module, matrix: Callable) -> torch.Tensor:
    """weight_orig / sigma, sigma = u . W v with W = matrix(weight_orig) viewed as (rows,
    cols), as torch's legacy spectral norm and the JAX ``spectral_normalize`` compute it.

    In training mode u and v first advance by one power iteration on the detached W, in
    fp32 (or wider) whatever the weight's dtype, and are written back into the buffers:
    once per forward, the JAX ``snorm_impl='per_apply'`` default. sigma takes W with its
    gradient and u, v without; the buffers stay fp32 under a bf16 copy of the weight.
    Eval mode uses u and v as they are."""
    w = module.weight_orig
    u, v = module.weight_u, module.weight_v
    if module.training:
        with torch.no_grad():
            m = conv_ops.at_least_fp32(matrix(w.detach()))
            v_new = _l2normalize(m.t() @ u.to(m.dtype))
            u_new = _l2normalize(m @ v_new)
            u.copy_(u_new)
            v.copy_(v_new)
        # this forward's graph keeps the new tensors, not the buffers, which the next
        # forward updates in place
        u, v = u_new, v_new
    m = conv_ops.at_least_fp32(matrix(w))
    sigma = u.to(m.dtype) @ m @ v.to(m.dtype)
    return w / sigma.to(w.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU over (B, C, T) or (B, C), slope 'weight' of shape (C,); with
    ``snorm`` the slope is spectrally normalised as a (C, 1) matrix (upstream's D heads
    do this to one PReLU)."""

    def __init__(self, num_parameters: int, init_val: float = 0.25, snorm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.snorm = snorm
        a = torch.full((num_parameters,), float(init_val))
        if snorm:
            declare_spectral(self, a, num_parameters, 1, generator)
        else:
            self.weight = nn.Parameter(a)

    def get_weight(self) -> torch.Tensor:
        if self.snorm:
            return spectral_weight(self, lambda a: a[:, None])
        return self.weight

    def forward(self, x):
        a = self.get_weight().view((1, -1) + (1,) * (x.dim() - 2))
        return torch.clamp_min(x, 0) + a * torch.clamp_max(x, 0)


class BatchNorm1d(nn.Module):
    """torch nn.BatchNorm1d on (B, C, T): statistics per channel over (B, T), in fp32
    (or wider) whatever the input's dtype; the output in the input's dtype.

    In training mode an optional (B,) ``mask`` takes the rows with mask 0 (the padding
    of a ragged last batch) out of the statistics, so the masked batch normalises as
    the smaller batch would. The running statistics move by ``momentum`` towards the
    batch mean and the unbiased batch variance; eval mode normalises with them.

    The variance is the two-pass mean of squared deviations. The JAX package's default
    (``bn_impl`` 'onepass', E[x^2] - E[x]^2) is a TPU lowering knob; the two agree to
    rounding at activation scale (``tests/test_torch_discriminator.py`` holds both).
    The JAX ``stats_groups`` (the fused real/fake D pass of the ``fuse_d`` knob, off by
    default) is not ported."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        xf = conv_ops.at_least_fp32(x)
        if self.training:
            if mask is None:
                n = float(x.shape[0] * x.shape[2])
                mean = xf.mean(dim=(0, 2))
                var = (xf - mean.view(1, -1, 1)).square().mean(dim=(0, 2))
            else:
                w = mask.float().view(-1, 1, 1)
                n = torch.clamp_min(w.sum() * x.shape[2], 1.0)
                mean = (xf * w).sum(dim=(0, 2)) / n
                var = ((xf - mean.view(1, -1, 1)).square() * w).sum(dim=(0, 2)) / n
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / (n - 1).clamp_min(1) if torch.is_tensor(n)
                                  else n / max(n - 1, 1))
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean.view(1, -1, 1)) * torch.rsqrt(var.view(1, -1, 1) + self.eps)
        return (y * self.weight.view(1, -1, 1) + self.bias.view(1, -1, 1)).to(x.dtype)


class _Weighted(nn.Module):
    """A layer whose weight is 'weight', or with ``snorm`` 'weight_orig' normalised by
    ``spectral_weight`` over the (rows, cols) view ``_matrix``."""

    snorm = False

    def _init_weight(self, weight: torch.Tensor, snorm: bool,
                     generator: Optional[torch.Generator]):
        self.snorm = snorm
        if snorm:
            rows, cols = self._matrix(weight).shape
            declare_spectral(self, weight, rows, cols, generator)
        else:
            self.weight = nn.Parameter(weight)

    @staticmethod
    def _matrix(w: torch.Tensor) -> torch.Tensor:
        return w.reshape(w.shape[0], -1)

    def get_weight(self) -> torch.Tensor:
        """The weight that the layer applies: w, or with snorm w / sigma."""
        return spectral_weight(self, self._matrix) if self.snorm else self.weight


class Conv1d(_Weighted):
    """VALID conv1d; callers pad. weight (Cout, Cin, K) ~ N(0, 0.02), bias zeros; snorm
    views it as (Cout, Cin*K), as torch's spectral norm does."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 1,
                 use_bias: bool = True, w_init: Callable = init.normal_002,
                 snorm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        w = w_init((out_ch, in_ch, kwidth), generator)
        self._init_weight(w, snorm, generator)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def forward(self, x):
        return conv_ops.conv1d(x, self.get_weight(), self.bias, self.stride)


class Linear(_Weighted):
    """torch nn.Linear: weight (out, in) xavier-uniform (SEGAN's init), bias torch's
    default U(±1/sqrt(in)); snorm views the weight as it is."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 snorm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        w = init.xavier_uniform((out_features, in_features), generator)
        b = (init.torch_default_bias((out_features,), in_features, generator)
             if use_bias else None)
        self._init_weight(w, snorm, generator)
        self.bias = nn.Parameter(b) if use_bias else None

    def forward(self, x):
        return conv_ops.linear(x, self.get_weight(), self.bias)


class ConvTranspose1d(_Weighted):
    """torch nn.ConvTranspose1d semantics, with torch's default init: weight (Cin, Cout,
    K) and bias ~ U(±1/sqrt(Cout*K)). The upstream SEGAN init never matches this layer.
    snorm views the weight along dim 1, as torch's spectral norm does for transposed
    convs: (Cout, Cin*K)."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 4,
                 padding: int = 0, snorm: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        w = init.torch_default_convT_weight((in_ch, out_ch, kwidth), generator)
        b = init.torch_default_bias((out_ch,), out_ch * kwidth, generator)
        self._init_weight(w, snorm, generator)
        self.bias = nn.Parameter(b)

    @staticmethod
    def _matrix(w: torch.Tensor) -> torch.Tensor:
        return w.transpose(0, 1).reshape(w.shape[1], -1)

    def forward(self, x):
        return conv_ops.conv_transpose1d(x, self.get_weight(), self.bias, self.stride,
                                         self.padding)


class GConv1DBlock(nn.Module):
    """Reflect pad -> conv1d (+ bias) -> [BatchNorm1d] -> PReLU (slope init 0).

    The pad is asymmetric, (K//2 - 1, K//2), when strided and symmetric otherwise.
    Without a BatchNorm (norm-free or ``snorm``), the conv, bias and PReLU run as one
    fused op (``ops/kernels/conv1d_prelu.py``): the hand-written kernel on a CUDA device,
    its plain version on the CPU; with snorm on the spectrally normalised weight w / sigma,
    whose gradient autograd takes on to 'weight_orig'. The ``use_pallas`` switch of the
    JAX package has no counterpart here. With ``bnorm`` the norm sits between the conv and
    the PReLU, so the block takes the plain conv, as the JAX block does; ``mask`` reaches
    the norm."""

    def __init__(self, ninp: int, fmaps: int, kwidth: int, stride: int = 1,
                 use_bias: bool = True, norm_type: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_norm(norm_type, bnorm=True)
        self.kwidth, self.stride = kwidth, stride
        self.conv = Conv1d(ninp, fmaps, kwidth, stride=stride, use_bias=use_bias,
                           snorm=norm_type == "snorm", generator=generator)
        self.norm = BatchNorm1d(fmaps) if norm_type == "bnorm" else None
        self.act = PReLU(fmaps, init_val=0.0)

    def forward(self, x, ret_linear: bool = False, mask: Optional[torch.Tensor] = None):
        kw = self.kwidth
        pad = (kw // 2 - 1, kw // 2) if self.stride > 1 else (kw // 2, kw // 2)
        x_p = conv_ops.reflect_pad_1d(x, *pad)
        if self.norm is None:
            h, a = conv1d_prelu(x_p, self.conv.get_weight(), self.conv.bias,
                                self.act.weight, self.stride)
        else:
            a = self.norm(self.conv(x_p), mask)
            h = self.act(a)
        return (h, a) if ret_linear else h


class GDeconv1DBlock(nn.Module):
    """ConvTranspose1d with padding max(0, (stride - K)//-2), the last sample trimmed
    when K is odd, then PReLU (slope init 0), Tanh or ReLU; with ``snorm`` the deconv's
    weight is spectrally normalised.

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
                                      snorm=norm_type == "snorm", generator=generator)
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
