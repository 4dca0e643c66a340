"""Generator and Discriminator building blocks as torch ``nn.Module``s on the (B, C, T)
layout: the counterparts of ``segan_pytorch_tpu/models/modules.py``.

Parameter names and layouts are the upstream torch state_dict's ('conv.weight'
(Cout, Cin, K), 'deconv.weight' (Cin, Cout, K), 'act.weight' (C,), 'norm.running_mean',
...), so a reference-format checkpoint loads strictly. Every module draws its initial
values from the ``torch.Generator`` it is given.

Norms: ``bnorm`` (BatchNorm1d) and ``snorm`` (spectral norm, WSEGAN's) are ported for
every block that takes a norm. snorm covers every conv, deconv, Linear and the PReLUs of
D's heads, with the state names of torch's legacy ``nn.utils.spectral_norm``: the
parameter 'weight_orig' and the buffers 'weight_u' and 'weight_v' (see
``spectral_weight``).

Besides G's and D's blocks the module holds the rest of the JAX package's blocks, with
its names and upstream's state names: ``LayerNorm``, ``ResBlock1D``, ``ResARModule``,
``SincConv`` (D's front end), ``CombFilter``, ``PostProcessingCombNet``,
``Conv1DResBlock`` and ``pos_code``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops import initializers as init
from ..ops.kernels.conv1d_prelu import conv1d_prelu
from ..parallel import sharding


def _check_norm(norm_type: Optional[str]):
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
    Eval mode uses u and v as they are.

    A layer split over the model axis (its ``tp``: (axis, 0) holds rows of W, (axis, 1)
    columns; ``parallel/sharding.py``) iterates on the whole W: W v and W^T u are summed
    or gathered over the axis, so u and v stay whole and equal on every rank, and sigma
    is the sum of every rank's part (its gradient reaches every part)."""
    w = module.weight_orig
    u, v = module.weight_u, module.weight_v
    axis, dim = getattr(module, "tp", None) or (None, None)
    if module.training:
        with torch.no_grad():
            m = conv_ops.at_least_fp32(matrix(w.detach()))
            if axis is None:
                v_new = _l2normalize(m.t() @ u.to(m.dtype))
                u_new = _l2normalize(m @ v_new)
            elif dim == 0:  # this rank's rows
                rows = axis.part(u.shape[0])
                v_new = _l2normalize(sharding.all_reduce(m.t() @ u[rows].to(m.dtype), axis))
                u_new = _l2normalize(sharding.gather_cat(m @ v_new, axis))
            else:  # this rank's columns
                cols = axis.part(v.shape[0])
                v_new = _l2normalize(sharding.gather_cat(m.t() @ u.to(m.dtype), axis))
                u_new = _l2normalize(sharding.all_reduce(m @ v_new[cols], axis))
            u.copy_(u_new)
            v.copy_(v_new)
        # this forward's graph keeps the new tensors, not the buffers, which the next
        # forward updates in place
        u, v = u_new, v_new
    m = conv_ops.at_least_fp32(matrix(w))
    if axis is None:
        sigma = u.to(m.dtype) @ m @ v.to(m.dtype)
    elif dim == 0:
        sigma = sharding.all_reduce(u[axis.part(u.shape[0])].to(m.dtype) @ m @ v.to(m.dtype),
                                    axis)
    else:
        sigma = sharding.all_reduce(u.to(m.dtype) @ m @ v[axis.part(v.shape[0])].to(m.dtype),
                                    axis)
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

    With ``axis`` (the data axis, ``parallel/sharding.py`` ``Axis``, set by the engine of
    a multi-GPU run) the statistics are those of the global batch, as under the JAX data
    mesh (``segan_pytorch_tpu/models/modules.py:107``): the masked count and sum, then
    the masked sum of squared deviations, are summed over the axis by autograd's
    all-reduce, whose backward takes the gradient to every rank's rows; the running
    variance's unbiased factor takes the global count.

    The variance is the two-pass mean of squared deviations. The JAX package's default
    (``bn_impl`` 'onepass', E[x^2] - E[x]^2) is a TPU lowering knob; the two agree to
    rounding at activation scale (``tests/test_torch_discriminator.py`` holds both).
    The JAX ``stats_groups`` (the fused real/fake D pass of the ``fuse_d`` knob, off by
    default) is not ported."""

    axis = None  # the data axis of a multi-GPU run

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked", torch.tensor(0, dtype=torch.long))

    def _stats(self, xf, mask):
        """(mean, biased variance, count) of the training batch: of the global batch
        with an axis."""
        if mask is None and self.axis is None:
            mean = xf.mean(dim=(0, 2))
            var = (xf - mean.view(1, -1, 1)).square().mean(dim=(0, 2))
            return mean, var, float(xf.shape[0] * xf.shape[2])
        w = (mask.to(xf.dtype) if mask is not None
             else xf.new_ones(xf.shape[0])).view(-1, 1, 1)
        total, count = (xf * w).sum(dim=(0, 2)), w.sum() * xf.shape[2]
        if self.axis is not None:
            packed = sharding.all_reduce(torch.cat([total, count.view(1)]), self.axis)
            total, count = packed[:-1], packed[-1]
        n = torch.clamp_min(count, 1.0)
        mean = total / n
        sq = ((xf - mean.view(1, -1, 1)).square() * w).sum(dim=(0, 2))
        if self.axis is not None:
            sq = sharding.all_reduce(sq, self.axis)
        return mean, sq / n, n

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        xf = conv_ops.at_least_fp32(x)
        if self.training:
            mean, var, n = self._stats(xf, mask)
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


class LayerNorm(nn.Module):
    """Upstream's hand-rolled LayerNorm (the JAX ``LayerNorm``): (x - mean) / std over
    time, per (batch, channel) of a (B, C, T) tensor, with the unbiased std. No
    parameters."""

    def forward(self, x):
        mean = x.mean(dim=2, keepdim=True)
        std = x.std(dim=2, keepdim=True, unbiased=True)
        return (x - mean) / std


def build_norm(norm_type: Optional[str], num_feats: int) -> Optional[BatchNorm1d]:
    """A BatchNorm1d for bnorm; None for no norm and for snorm, which lives in the
    layers' weights."""
    _check_norm(norm_type)
    return BatchNorm1d(num_feats) if norm_type == "bnorm" else None


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
    """VALID conv1d; callers pad. weight (Cout, Cin, K) ~ N(0, 0.02) and bias zeros (the
    SEGAN init), or with ``torch_init`` torch's own Conv1d init, both U(±1/sqrt(Cin*K));
    snorm views the weight as (Cout, Cin*K), as torch's spectral norm does."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 1,
                 dilation: int = 1, use_bias: bool = True,
                 w_init: Callable = init.normal_002, torch_init: bool = False,
                 snorm: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        shape = (out_ch, in_ch, kwidth)
        w = (init.torch_default_conv_weight if torch_init else w_init)(shape, generator)
        self._init_weight(w, snorm, generator)
        self.bias = None
        if use_bias:
            self.bias = nn.Parameter(
                init.torch_default_bias((out_ch,), in_ch * kwidth, generator)
                if torch_init else torch.zeros(out_ch))

    def forward(self, x):
        return conv_ops.conv1d(x, self.get_weight(), self.bias, self.stride,
                               self.dilation)


class Linear(_Weighted):
    """torch nn.Linear: weight (out, in) xavier-uniform (SEGAN's init) unless ``w_init``
    says otherwise, bias torch's default U(±1/sqrt(in)); snorm views the weight as it
    is. ``tp`` (axis, dim), set on D's head by ``parallel/sharding.py`` ``shard_head``,
    makes it column-parallel (dim 0: its rows of the weight) or row-parallel (dim 1: its
    columns, the partial outputs summed over the model axis)."""

    tp = None

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 snorm: bool = False, w_init: Callable = init.xavier_uniform,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w = w_init((out_features, in_features), generator)
        b = (init.torch_default_bias((out_features,), in_features, generator)
             if use_bias else None)
        self._init_weight(w, snorm, generator)
        self.bias = nn.Parameter(b) if use_bias else None

    def forward(self, x):
        tp = getattr(self, "tp", None)
        if tp is None:
            return conv_ops.linear(x, self.get_weight(), self.bias)
        axis, dim = tp
        if dim == 0:  # column-parallel: this rank's output features of the whole input
            return conv_ops.linear(sharding.to_model(x, axis), self.get_weight(), self.bias)
        # row-parallel: this rank's input features; the bias once, after the sum
        y = sharding.from_model(conv_ops.linear(x, self.get_weight(), None), axis)
        return y + self.bias if self.bias is not None else y


class ConvTranspose1d(_Weighted):
    """torch nn.ConvTranspose1d semantics, with torch's default init unless ``w_init``
    says otherwise: weight (Cin, Cout, K) and bias ~ U(±1/sqrt(Cout*K)). The upstream
    SEGAN init never matches this layer.
    snorm views the weight along dim 1, as torch's spectral norm does for transposed
    convs: (Cout, Cin*K)."""

    def __init__(self, in_ch: int, out_ch: int, kwidth: int, stride: int = 4,
                 padding: int = 0, snorm: bool = False, use_bias: bool = True,
                 w_init: Callable = init.torch_default_convT_weight,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        w = w_init((in_ch, out_ch, kwidth), generator)
        b = (init.torch_default_bias((out_ch,), out_ch * kwidth, generator)
             if use_bias else None)
        self._init_weight(w, snorm, generator)
        self.bias = nn.Parameter(b) if use_bias else None

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
        self.kwidth, self.stride = kwidth, stride
        self.conv = Conv1d(ninp, fmaps, kwidth, stride=stride, use_bias=use_bias,
                           snorm=norm_type == "snorm", generator=generator)
        self.norm = build_norm(norm_type, fmaps)
        self.act = PReLU(fmaps, init_val=0.0)

    def forward(self, x, ret_linear: bool = False, mask: Optional[torch.Tensor] = None):
        kw = self.kwidth
        pad = (kw // 2 - 1, kw // 2) if self.stride > 1 else (kw // 2, kw // 2)
        if self.norm is None:  # the kernel reads x in 16-byte aligned rows
            x_p = conv_ops.reflect_pad_pitched(x, *pad)
            h, a = conv1d_prelu(x_p, self.conv.get_weight(), self.conv.bias,
                                self.act.weight, self.stride)
        else:
            a = self.norm(self.conv(conv_ops.reflect_pad_1d(x, *pad)), mask)
            h = self.act(a)
        return (h, a) if ret_linear else h


class GDeconv1DBlock(nn.Module):
    """ConvTranspose1d with padding max(0, (stride - K)//-2), the last sample trimmed
    when K is odd, [BatchNorm1d], then PReLU (slope init 0), Tanh or ReLU; with ``snorm``
    the deconv's weight is spectrally normalised. With ``bnorm`` the norm takes every
    row (G's norms have no mask, as in the JAX package).

    The deconv always has a bias, even under --no_bias: the upstream block accepts a
    bias argument but never passes it on, and the checkpoints carry 'deconv.bias'."""

    def __init__(self, ninp: int, fmaps: int, kwidth: int, stride: int = 4,
                 norm_type: Optional[str] = None, act: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if act not in (None, "Tanh", "ReLU"):
            raise TypeError(f"Unsupported deconv act: {act}")
        self.kwidth = kwidth
        self.deconv = ConvTranspose1d(ninp, fmaps, kwidth, stride=stride,
                                      padding=max(0, (stride - kwidth) // -2),
                                      snorm=norm_type == "snorm", generator=generator)
        self.norm = build_norm(norm_type, fmaps)
        self.act_name = act
        if act is None:
            self.act = PReLU(fmaps, init_val=0.0)

    def forward(self, x):
        h = self.deconv(x)
        if self.kwidth % 2 != 0:
            h = h[:, :, :-1]
        if self.norm is not None:
            h = self.norm(h)
        if self.act_name == "Tanh":
            return torch.tanh(h)
        if self.act_name == "ReLU":
            return torch.relu(h)
        return self.act(h)


class ResBlock1D(nn.Module):
    """Bottleneck residual block (upstream's ``ResBlock1D``): a 1x1 entry conv to
    ``hidden_size``, a dilated K-wide conv over a reflect pad, a 1x1 exit conv back to
    ``num_inputs``, each conv followed by its norm ('entry_norm', 'mid_norm',
    'exit_norm') and the first two by a ReLU; out = ReLU(skip_alpha * x + h), with
    'skip_alpha' (1,) initialised to 0. The convs have torch's own init."""

    def __init__(self, num_inputs: int, hidden_size: int, kwidth: int, dilation: int = 1,
                 use_bias: bool = True, norm_type: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kwidth, self.dilation = kwidth, dilation
        sn = norm_type == "snorm"

        def conv(cin, cout, k, d=1):
            return Conv1d(cin, cout, k, dilation=d, use_bias=use_bias, torch_init=True,
                          snorm=sn, generator=generator)

        self.entry_conv = conv(num_inputs, hidden_size, 1)
        self.entry_norm = build_norm(norm_type, hidden_size)
        self.mid_conv = conv(hidden_size, hidden_size, kwidth, dilation)
        self.mid_norm = build_norm(norm_type, hidden_size)
        self.exit_conv = conv(hidden_size, num_inputs, 1)
        self.exit_norm = build_norm(norm_type, num_inputs)
        self.skip_alpha = nn.Parameter(torch.zeros(1))

    @staticmethod
    def _norm(norm: Optional[nn.Module], h: torch.Tensor) -> torch.Tensor:
        return norm(h) if norm is not None else h

    def forward(self, x):
        h = torch.relu(self._norm(self.entry_norm, self.entry_conv(x)))
        pad = (self.kwidth // 2) * self.dilation
        h = self.mid_conv(conv_ops.reflect_pad_1d(h, pad, pad))
        h = torch.relu(self._norm(self.mid_norm, h))
        h = self._norm(self.exit_norm, self.exit_conv(h))
        return torch.relu(self.skip_alpha.view(1, 1, 1) * x + h)


class ResARModule(nn.Module):
    """Causal dilated residual module (upstream's ``ResARModule``): zero pad (K - 1) x
    dilation on the left, the dilated conv 'dil_conv', its norm and a PReLU (slope init
    0) give h; returns (x + norm(conv_1x1_skip(h)), norm(conv_1x1_res(h))). The convs
    have torch's own init."""

    def __init__(self, ninp: int, fmaps: int, res_fmaps: int, kwidth: int, dilation: int,
                 use_bias: bool = True, norm_type: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kwidth, self.dilation = kwidth, dilation
        sn = norm_type == "snorm"

        def conv(cin, cout, k, d=1):
            return Conv1d(cin, cout, k, dilation=d, use_bias=use_bias, torch_init=True,
                          snorm=sn, generator=generator)

        self.dil_conv = conv(ninp, fmaps, kwidth, dilation)
        self.dil_norm = build_norm(norm_type, fmaps)
        self.act = PReLU(fmaps, init_val=0.0)
        self.conv_1x1_skip = conv(fmaps, ninp, 1)
        self.conv_1x1_skip_norm = build_norm(norm_type, ninp)
        self.conv_1x1_res = conv(fmaps, res_fmaps, 1)
        self.conv_1x1_res_norm = build_norm(norm_type, res_fmaps)

    def forward(self, x):
        norm = ResBlock1D._norm
        h = self.dil_conv(conv_ops.zero_pad_1d(x, (self.kwidth - 1) * self.dilation, 0))
        h = self.act(norm(self.dil_norm, h))
        y = x + norm(self.conv_1x1_skip_norm, self.conv_1x1_skip(h))
        res = norm(self.conv_1x1_res_norm, self.conv_1x1_res(h))
        return y, res


def _mel_init(n_filt: int, fs: float):
    """SincNet's mel-spaced band edges (upstream's and the JAX ``SincConv._mel_init``):
    each filter's low cut 'filt_b1' and its band 'filt_band', normalised by fs."""
    high_freq_mel = 2595 * np.log10(1 + (fs / 2) / 700)
    mel_points = np.linspace(80, high_freq_mel, n_filt)
    f_cos = 700 * (10 ** (mel_points / 2595) - 1)
    b1 = np.roll(f_cos, 1)
    b2 = np.roll(f_cos, -1)
    b1[0] = 30
    b2[-1] = (fs / 2) - 100
    return b1 / fs, (b2 - b1) / fs


class SincConv(nn.Module):
    """SincNet's parametric band-pass filter bank (upstream's ``SincConv``): ``N_filt``
    filters of ``Filt_dim`` taps, each the difference of two windowed sinc low-passes at
    |filt_b1| + 50 Hz and that plus |filt_band| + 50 Hz (normalised by fs), scaled to a
    peak of 1 and Hamming-windowed. 'filt_b1' and 'filt_band' (N_filt,) start mel-spaced.

    The bank is built vectorised, as the JAX package builds it. The sine arguments reach
    ~400 rad, so the bank is built in fp32 (or wider) from the parameters, whatever their
    dtype: a bank built in bf16 is wrong, not just imprecise. Its conv runs in that dtype
    too, and only the output takes x's dtype: on an H100 at batch 300 cuDNN's bf16 conv of
    251 taps took longer than the fp32 one (PERF.md §6, smoke phase 12). (The JAX
    package's bf16 D stops at this conv: it refuses the fp32 bank against bf16 x.) Each
    channel of x goes through the bank as a row of its own, in one conv with no groups,
    which cuDNN ran faster than the grouped conv over the channels."""

    def __init__(self, N_filt: int, Filt_dim: int, fs: float, padding: str = "VALID"):
        super().__init__()
        if padding not in ("VALID", "SAME"):
            raise ValueError(f"Unrecognized padding {padding!r}")
        self.N_filt, self.Filt_dim, self.fs, self.padding = N_filt, Filt_dim, fs, padding
        b1, band = _mel_init(N_filt, fs)
        self.filt_b1 = nn.Parameter(torch.tensor(b1, dtype=torch.float32))
        self.filt_band = nn.Parameter(torch.tensor(band, dtype=torch.float32))

    def bank(self) -> torch.Tensor:
        """The filters (N_filt, 1, Filt_dim), in fp32 or the parameters' wider dtype."""
        N, fs = self.Filt_dim, self.fs
        dev = self.filt_b1.device
        t_right = torch.linspace(1, (N - 1) / 2, int((N - 1) / 2), dtype=torch.float32,
                                 device=dev) / fs
        b1 = conv_ops.at_least_fp32(self.filt_b1)
        beg = torch.abs(b1) + 50.0 / fs
        end = beg + (torch.abs(conv_ops.at_least_fp32(self.filt_band)) + 50.0 / fs)

        def low_pass(f):
            band = (f * fs)[:, None]
            arg = 2 * math.pi * band * t_right[None, :]
            y_right = torch.sin(arg) / arg
            ones = torch.ones((f.shape[0], 1), dtype=y_right.dtype, device=dev)
            y = torch.cat([torch.flip(y_right, dims=(1,)), ones, y_right], dim=1)
            return 2 * f[:, None] * y

        band_pass = low_pass(end) - low_pass(beg)
        band_pass = band_pass / band_pass.amax(dim=1, keepdim=True)
        n = torch.linspace(0, N, N, dtype=torch.float32, device=dev)
        window = 0.54 - 0.46 * torch.cos(2 * math.pi * n / N)
        return (band_pass * window[None, :])[:, None, :]

    def forward(self, x):
        """x (B, C, T) -> (B, C * N_filt, T') in x's dtype, every channel through the one
        bank: channel c's filters are outputs [c N_filt, (c + 1) N_filt), so two channels
        give the JAX D's concatenation of their outputs. T' = T with 'SAME' (a reflect pad
        of Filt_dim // 2 each side), T - Filt_dim + 1 with 'VALID'."""
        B, C, T = x.shape
        bank = self.bank()
        dtype = torch.promote_types(bank.dtype, x.dtype)
        rows = x.reshape(B * C, 1, T).to(dtype)
        if self.padding == "SAME":
            rows = conv_ops.reflect_pad_1d(rows, self.Filt_dim // 2, self.Filt_dim // 2)
        y = conv_ops.conv1d(rows, bank.to(dtype))
        return y.reshape(B, C * self.N_filt, y.shape[-1]).to(x.dtype)


def _comb_init(shape, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """A comb's (Cout, Cin, 2) weight: tap 0 ~ U(0, 1), tap 1 = 1 (upstream's init)."""
    w = torch.ones(tuple(shape))
    w[:, :, 0] = torch.empty(tuple(shape[:2])).uniform_(0.0, 1.0, generator=generator)
    return w


class CombFilter(nn.Module):
    """A two-tap comb, y[t] = w0 x[t - L] + w1 x[t] per channel pair: the conv 'filt'
    (K = 2, dilation L, no bias) after a causal zero pad of L (upstream's
    ``CombFilter``)."""

    def __init__(self, ninputs: int, fmaps: int, L: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.L = L
        self.filt = Conv1d(ninputs, fmaps, 2, dilation=L, use_bias=False,
                           w_init=_comb_init, generator=generator)

    def forward(self, x):
        return self.filt(conv_ops.zero_pad_1d(x, self.L, 0))


class PostProcessingCombNet(nn.Module):
    """Parallel combs 'filts.{i}' at the delays ``L`` (fmaps // len(L) channels each),
    concatenated, then the bias-free Linear 'W' (fmaps -> 1, torch's init) over the
    channels: (B, ninputs, T) -> (B, 1, T) (upstream's ``PostProcessingCombNet``)."""

    def __init__(self, ninputs: int, fmaps: int, L: Sequence[int] = (4, 8, 16, 32),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.filts = nn.ModuleList(CombFilter(ninputs, fmaps // len(L), l,
                                              generator=generator) for l in L)
        self.W = Linear(fmaps, 1, use_bias=False, w_init=init.torch_default_conv_weight,
                        generator=generator)

    def forward(self, x):
        hs = torch.cat([f(x) for f in self.filts], dim=1)
        return self.W(hs.transpose(1, 2)).transpose(1, 2)


class Conv1DResBlock(nn.Module):
    """Dilated conv residual block (upstream's ``Conv1DResBlock``): one stage per
    dilation, 'convs.{n}' then the PReLU 'acts.{n}' (slope init 0.25); the first stage
    strided (a zero pad of (K//2 - 1, K//2)) or, with ``transpose``, a transposed conv of
    padding (K - 4) // 2, the later ones stride 1 over a zero pad of ((K - 1) d) // 2
    each side; fmaps channels at the first and last stage, fmaps // 4 between; the first
    stage's output added to the last's. Weights N(0, 0.02).

    Where (K - 4) // 2 is negative (K < 4) the transposed stage takes padding 0 and
    zero-pads its output on the right by as many samples, as the JAX package does;
    upstream's ``output_padding`` would put the bias there instead."""

    def __init__(self, ninputs: int, fmaps: int, kwidth: int = 3,
                 dilations: Sequence[int] = (1, 2, 4, 8), stride: int = 4,
                 use_bias: bool = True, transpose: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dilations = list(dilations)
        if dilations[0] != 1 or len(dilations) < 2:
            raise ValueError(f"dilations must start at 1 and have two or more: {dilations}")
        self.kwidth, self.stride, self.transpose = kwidth, stride, transpose
        self.dilations = dilations
        self.convs, self.acts = nn.ModuleList(), nn.ModuleList()
        prev_in = ninputs
        for n, d in enumerate(dilations):
            curr_fmaps = (fmaps if n == 0 or n + 1 >= len(dilations)
                          else max(fmaps // 4, 1))
            if n == 0 and transpose:
                conv = ConvTranspose1d(prev_in, curr_fmaps, kwidth, stride=stride,
                                       padding=max((kwidth - 4) // 2, 0),
                                       use_bias=use_bias, w_init=init.normal_002,
                                       generator=generator)
            else:
                conv = Conv1d(prev_in, curr_fmaps, kwidth,
                              stride=stride if n == 0 else 1, dilation=d,
                              use_bias=use_bias, generator=generator)
            self.convs.append(conv)
            self.acts.append(PReLU(curr_fmaps))
            prev_in = curr_fmaps

    def forward(self, x):
        h, res_act, kw = x, None, self.kwidth
        for n, (conv, act) in enumerate(zip(self.convs, self.acts)):
            if n == 0 and self.transpose:
                h = conv(h)
                h = conv_ops.zero_pad_1d(h, 0, max(-((kw - 4) // 2), 0))
            else:
                if n == 0 and self.stride > 1:
                    pad = (kw // 2 - 1, kw // 2)
                else:
                    p = ((kw - 1) * self.dilations[n]) // 2
                    pad = (p, p)
                h = conv(conv_ops.zero_pad_1d(h, *pad))
            h = act(h)
            if n == 0:
                res_act = h
        return h + res_act


def pos_code(chunk_pos: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x plus the sinusoidal code of each sample's position in the utterance (upstream's
    ``pos_code``): x (B, C, T), chunk_pos (B,) the slice index of each row, so position
    = chunk_pos * T + t; channel 2i takes sin(position w_i) and 2i + 1 cos, w_i =
    10000^(-2i / C). C even."""
    B, C, T = x.shape
    chunk_pos = torch.as_tensor(chunk_pos, device=x.device)
    position = chunk_pos.reshape(B, 1) * T + torch.arange(T, device=x.device)[None, :]
    # the frequencies in float64 on the host, then fp32: the same angles on every device
    div_term = torch.exp(torch.arange(0, C, 2, dtype=torch.float64)
                         * (-math.log(10000.0) / C)).to(x.device, torch.float32)
    ang = position[:, None, :].to(torch.float32) * div_term[None, :, None]
    pe = torch.zeros_like(x)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return x + pe
