"""Generator1D, the legacy SEGAN v1 research generator: the counterpart of
``segan_pytorch_tpu/models/generator1d.py`` (a reconstruction of upstream's dead
``Generator1D``, whose ``GBlock`` upstream never defined).

Public shapes are the JAX package's: x (B, T, ninputs), z (B, T_b, z_dim) or, under
``rnn_core``, the LSTM's initial hidden state (2, B, C_b // 2); the output (B, T, 1).
Inside, every tensor is (B, C, T). Parameter names follow the JAX module paths with a
list index after a dot ('gen_enc.0.conv.weight' for 'gen_enc_0/conv/weight');
``utils/checkpoint.py`` ``generator1d_state_from_jax`` converts JAX variables.

An encoder ``GBlock1D`` is [cheby1 FIR] -> pad -> strided conv (or ``Conv1DResBlock``)
-> [LayerNorm] -> [dropout] -> activation, returning (activated, pre-activation). With
a PReLU and neither LayerNorm nor dropout, its conv, bias and PReLU run as one
``conv1d_prelu`` call (``ops/kernels/conv1d_prelu.py``): the hand-written kernel on a
CUDA device, its plain version on the CPU; with snorm on w / sigma. At the default stride
of 2 the kernel takes its FMA route (the tensor-core route is for stride 4). A decoder
block is a transposed conv, or a linear upsampling then a stride-1 conv (``linterp``),
with the same tail.

Random draws come from explicit ``torch.Generator``s: the initial weights from the one
given to the constructor, z and the dropout masks from the one given to ``forward``.
Train and eval are ``module.train()``: it governs dropout and the spectral norm's power
iteration.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops.kernels.conv1d_prelu import conv1d_prelu
from .generator import GSkip
from .modules import (Conv1d, Conv1DResBlock, ConvTranspose1d, LayerNorm, PReLU,
                      PostProcessingCombNet, pos_code)

ACTS = (None, "PReLU", "ReLU", "Tanh", "LeakyReLU")


def _cheby1_aal_taps(pooling: int, ntaps: int = 65) -> np.ndarray:
    """Impulse response of upstream's anti-aliasing filter, cheby1(8, 0.05, 0.8 /
    pooling), as float32 taps."""
    from scipy.signal import cheby1, dimpulse, dlti

    system = dlti(*cheby1(8, 0.05, 0.8 / pooling))
    _, yout = dimpulse(system, n=ntaps)
    return np.asarray(yout[0], np.float32).reshape(-1)


def _build_act(act: Optional[str], fmaps: int) -> Optional[nn.Module]:
    """The block's activation module: a PReLU (slope init 0.25, the JAX PReLU's default)
    or None for the parameter-free ones."""
    if act == "glu":
        raise NotImplementedError("glu GBlock activation is not reconstructed")
    if act not in ACTS:
        raise TypeError(f"Unsupported Generator1D activation: {act}")
    return PReLU(fmaps) if act == "PReLU" else None


def _apply_act(act: Optional[str], module: Optional[nn.Module],
               h: torch.Tensor) -> torch.Tensor:
    if act is None:  # the last decoder layer under no_tanh: a linear output
        return h
    if act == "PReLU":
        return module(h)
    if act == "ReLU":
        return torch.relu(h)
    if act == "Tanh":
        return torch.tanh(h)
    return torch.nn.functional.leaky_relu(h, 0.01)  # jax.nn.leaky_relu's slope


def _dropout(h: torch.Tensor, p: float, generator: Optional[torch.Generator]):
    """Inverted dropout, as flax's: each element kept with probability 1 - p and scaled
    by 1 / (1 - p), the mask drawn from `generator` (on h's device)."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))


class GBlock1D(nn.Module):
    """The reconstructed v1 GBlock (see the module docstring): forward(x) ->
    (activated, pre-activation), both (B, fmaps, T').

    Encoder (``enc``): with ``aal`` the 65-tap cheby1 FIR on every channel (a depthwise
    conv; the JAX block builds a dense (K, C, C) kernel with eye(C)) over a zero pad of
    (32, 32); then ``Conv1DResBlock`` (``convblock``) or a pad of (K // 2, K - 1 - K // 2),
    zero or reflect (``pad_type``), and a stride-``pooling`` conv 'conv'. Decoder: with
    ``linterp`` a linear upsampling by ``pooling`` (the JAX formula, whose first sample
    extrapolates: its weight is taken against the clipped lower index) and a zero-padded
    stride-1 conv; else the transposed conv 'deconv' (padding max(0, (pooling - K) //
    -2), a bias, the last sample trimmed for odd K). Then [LayerNorm over time], [dropout,
    in training], the activation 'act'."""

    def __init__(self, ninp: int, fmaps: int, kwidth: int, act: Optional[str] = None,
                 lnorm: bool = False, dropout: float = 0.0, pooling: int = 2,
                 enc: bool = True, use_bias: bool = False, aal: bool = False,
                 snorm: bool = False, convblock: bool = False, linterp: bool = False,
                 pad_type: str = "constant",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pad_type not in ("constant", "reflect"):
            raise ValueError(f"Unrecognized pad_type {pad_type!r}")
        self.kwidth, self.pooling, self.enc, self.pad_type = kwidth, pooling, enc, pad_type
        self.convblock = enc and convblock
        self.linterp = not enc and linterp and pooling > 1
        self.act_name, self.p_drop = act, dropout
        if enc and aal:
            self.register_buffer("aal_taps", torch.from_numpy(_cheby1_aal_taps(pooling)),
                                 persistent=False)
        else:
            self.aal_taps = None
        if self.convblock:
            self.conv = Conv1DResBlock(ninp, fmaps, kwidth, stride=pooling,
                                       use_bias=use_bias, generator=generator)
        elif enc or self.linterp or pooling <= 1:
            self.conv = Conv1d(ninp, fmaps, kwidth, stride=pooling if enc else 1,
                               use_bias=use_bias, snorm=snorm, generator=generator)
        else:
            self.deconv = ConvTranspose1d(ninp, fmaps, kwidth, stride=pooling,
                                          padding=max(0, (pooling - kwidth) // -2),
                                          use_bias=True, snorm=snorm, generator=generator)
        self.norm = LayerNorm() if lnorm else None
        self.act = _build_act(act, fmaps)
        # conv + bias + PReLU as one op: an encoder's plain conv with nothing between
        self.fused = (enc and not self.convblock and act == "PReLU" and not lnorm
                      and dropout == 0)

    def _pad(self, h: torch.Tensor) -> torch.Tensor:
        lpad = self.kwidth // 2
        rpad = self.kwidth - 1 - lpad
        if self.enc and self.pad_type == "reflect":
            return conv_ops.reflect_pad_1d(h, lpad, rpad)
        return conv_ops.zero_pad_1d(h, lpad, rpad)

    def _upsample(self, h: torch.Tensor) -> torch.Tensor:
        T, p = h.shape[-1], self.pooling
        src = (torch.arange(T * p, dtype=torch.float32, device=h.device) + 0.5) / p - 0.5
        lo = torch.clamp(torch.floor(src).long(), 0, T - 1)
        hi = torch.clamp(lo + 1, 0, T - 1)
        w = (src - lo).to(h.dtype)
        return h[:, :, lo] * (1 - w) + h[:, :, hi] * w

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = x
        if self.aal_taps is not None:
            C, n = h.shape[1], self.aal_taps.shape[0]
            taps = self.aal_taps.to(h.dtype).view(1, 1, n).expand(C, 1, n)
            h = conv_ops.conv1d(conv_ops.zero_pad_1d(h, n // 2, n - 1 - n // 2), taps,
                                groups=C)
        if self.convblock:
            h = self.conv(h)
        elif self.fused:
            return conv1d_prelu(self._pad(h), self.conv.get_weight(), self.conv.bias,
                                self.act.get_weight(), self.pooling)
        elif self.enc or self.linterp or self.pooling <= 1:
            h = self.conv(self._pad(self._upsample(h) if self.linterp else h))
        else:
            h = self.deconv(h)
            if self.kwidth % 2 != 0:
                h = h[:, :, :-1]
        if self.norm is not None:
            h = self.norm(h)
        if self.p_drop > 0 and self.training:
            h = _dropout(h, self.p_drop, generator)
        return _apply_act(self.act_name, self.act, h), h


class _BiLSTM(nn.LSTM):
    """The bidirectional LSTM core (batch first): z (2, B, hidden) is the initial hidden
    state of the forward and the reverse direction, the cells start at zero, and the
    output is the two directions concatenated, (B, T, 2 hidden). The weights follow
    torch's gate order i, f, g, o, as flax's ``OptimizedLSTMCell`` kernels do; its
    biases live in 'bias_ih_l0[_reverse]' and 'bias_hh_l0[_reverse]' is 0 after a load
    from JAX (flax has one bias a gate). Init U(+-1 / sqrt(hidden)), torch's, from
    `generator`. cuDNN takes bf16; a bf16 copy's weights (cast one by one, as
    ``SEGAN._g()`` casts) stay outside cuDNN's one buffer, which ``flatten_parameters``
    refuses for bf16, so cuDNN packs them at every call (it warns once)."""

    def __init__(self, input_size: int, hidden: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(input_size, hidden, batch_first=True, bidirectional=True)
        bound = 1.0 / math.sqrt(hidden)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
        h0 = h0.to(x.dtype).contiguous()
        with conv_ops.full_precision(x.dtype):
            out, _ = super().forward(x, (h0, torch.zeros_like(h0)))
        return out


def _per_layer(value, n: int) -> list:
    if isinstance(value, (list, tuple)):
        value = list(value)
        return value * n if len(value) == 1 else value
    return [value] * n


class Generator1D(nn.Module):
    """The reconstructed legacy v1 generator: encoder 'gen_enc', [the LSTM 'rnn_core'],
    skips 'alpha_<i>' (``GSkip``), decoder 'gen_dec', and the output stages 'comb_net'
    (``post_proc``), 'out_gate' and 'out_filter' (``big_out_filter``), each there only
    when its option is on; the options are the JAX class's (see its docstring).
    ``linterp_mode`` is accepted and, as in the JAX package, has no effect."""

    def __init__(self, ninputs: int, enc_fmaps: Sequence[int], kwidth: int,
                 activations: Union[str, Sequence[Optional[str]], None] = None,
                 lnorm: bool = False, dropout: float = 0.0,
                 pooling: Union[int, Sequence[int]] = 2, z_dim: int = 256,
                 z_all: bool = False, z_std: float = 1.0, skip: bool = True,
                 skip_blacklist: Sequence[int] = (),
                 dec_activations: Optional[Sequence[Optional[str]]] = None,
                 use_bias: bool = False, aal: bool = False, aal_out: bool = False,
                 skip_init: str = "one", skip_dropout: float = 0.0, no_tanh: bool = False,
                 rnn_core: bool = False, linterp: bool = False, linterp_mode: str = "linear",
                 mlpconv: bool = False, dec_kwidth: Optional[int] = None, no_z: bool = False,
                 skip_type: str = "alpha", num_spks: Optional[int] = None,
                 skip_merge: str = "sum", snorm: bool = False, convblock: bool = False,
                 post_skip: bool = False, use_pos_code: bool = False, satt: bool = False,
                 dec_fmaps: Optional[Sequence[int]] = None,
                 up_poolings: Optional[Sequence[int]] = None, post_proc: bool = False,
                 out_gate: bool = False, big_out_filter: bool = False,
                 freeze_enc: bool = False, skip_kwidth: int = 11,
                 pad_type: str = "constant", generator: Optional[torch.Generator] = None):
        super().__init__()
        if mlpconv:  # upstream raises here too
            raise NotImplementedError("MLPconv is not useful and should be deleted")
        if satt:
            raise NotImplementedError("satt relies on upstream's missing GBlock "
                                      "attention — not reconstructable")
        enc_fmaps = list(enc_fmaps)
        n_enc = len(enc_fmaps)
        poolings = _per_layer(pooling, n_enc)
        acts = ["PReLU" if a is None else a for a in _per_layer(activations, n_enc)]
        if dec_fmaps is None:
            dec_fmaps, up_poolings = enc_fmaps[:-1][::-1] + [1], poolings[::-1]
        elif up_poolings is None:
            raise ValueError("dec_fmaps needs up_poolings")
        dec_fmaps, up_poolings = list(dec_fmaps), list(up_poolings)
        dec_acts = (list(dec_activations) if dec_activations is not None
                    else [acts[0]] * len(dec_fmaps))
        dec_kwidth = dec_kwidth or kwidth
        self.z_dim, self.z_std, self.z_all, self.no_z = z_dim, z_std, z_all, no_z
        self.num_spks, self.post_skip, self.freeze_enc = num_spks, post_skip, freeze_enc
        self.use_pos_code, self.up_poolings = use_pos_code, up_poolings
        self.skip_layers = ({i for i in range(n_enc - 1) if i not in skip_blacklist}
                            if skip else set())

        self.gen_enc = nn.ModuleList()
        ninp = ninputs
        for fmap, pool, act in zip(enc_fmaps, poolings, acts):
            self.gen_enc.append(GBlock1D(ninp, fmap, kwidth, act=act, lnorm=lnorm,
                                         dropout=dropout, pooling=pool, enc=True,
                                         use_bias=use_bias, aal=aal, snorm=snorm,
                                         convblock=convblock, pad_type=pad_type,
                                         generator=generator))
            ninp = fmap
        self.rnn_core = None
        if rnn_core:
            self.rnn_core = _BiLSTM(ninp, ninp // 2, generator)
            ninp = 2 * (ninp // 2)
        elif not no_z:
            ninp += z_dim
        z_up = self.rnn_core is None and not no_z

        self.gen_dec = nn.ModuleList()
        enc_idx = n_enc - 1
        for l_i, (fmap, act, pool) in enumerate(zip(dec_fmaps, dec_acts, up_poolings)):
            if self._takes_skip(enc_idx, pool):
                setattr(self, f"alpha_{enc_idx}", GSkip(
                    skip_type, enc_fmaps[enc_idx], skip_init=skip_init,
                    skip_dropout=skip_dropout, merge_mode=skip_merge, kwidth=skip_kwidth,
                    use_bias=True, generator=generator))
                if skip_merge == "concat":
                    ninp += enc_fmaps[enc_idx]
            if l_i > 0 and z_all and z_up:
                ninp += z_dim
            if num_spks is not None:
                ninp += num_spks
            last = l_i >= len(dec_fmaps) - 1
            act_l = (None if no_tanh else "Tanh") if last else act
            self.gen_dec.append(GBlock1D(
                ninp, fmap, dec_kwidth, act=act_l, lnorm=lnorm and not last,
                dropout=0.0 if last else dropout, pooling=pool, enc=pool <= 1,
                use_bias=use_bias, snorm=snorm, convblock=convblock, linterp=linterp,
                pad_type=pad_type, generator=generator))
            ninp = fmap
            enc_idx -= 1

        if aal_out:  # the cheby1 taps and one zero tap, a 66-tap FIR on the output
            taps = np.concatenate([_cheby1_aal_taps(int(np.max(up_poolings))), [0.0]])
            self.register_buffer("aal_out_taps", torch.tensor(taps, dtype=torch.float32),
                                 persistent=False)
        else:
            self.aal_out_taps = None
        self.comb_net = PostProcessingCombNet(1, 512, generator=generator) \
            if post_proc else None
        # the reconstructed OutGate (upstream's class is absent): x * sigmoid(conv(x))
        self.out_gate = Conv1d(1, 1, 1, use_bias=True, generator=generator) \
            if out_gate else None
        self.out_filter = Conv1d(1, 1, 513, use_bias=True, generator=generator) \
            if big_out_filter else None

    def _takes_skip(self, enc_idx: int, pool: int) -> bool:
        return enc_idx in self.skip_layers and pool > 1

    def sample_z(self, bottleneck_shape: Tuple[int, int, int],
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """z for the bottleneck (B, T_b, C_b): z_std N(0, 1) of shape (B, T_b, z_dim), or
        under ``rnn_core`` the LSTM's h0 (2, B, C_b // 2); from `generator` and on its
        device (the CPU without one)."""
        B, Tb, C = bottleneck_shape
        shape = (2, B, C // 2) if self.rnn_core is not None else (B, Tb, self.z_dim)
        device = generator.device if generator is not None else None
        return self.z_std * torch.randn(shape, generator=generator, device=device)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None, spkid=None,
                slice_idx=0, ret_hid: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, T, ninputs) -> (B, T, 1); z as ``sample_z`` gives it, drawn from
        `generator` when None; spkid (B,) when ``num_spks``; slice_idx an int or (B,) for
        ``use_pos_code``. With ret_hid also a dict of the hidden tensors ('enc_<i>',
        'enc_zc', 'dec_<i>', each (B, T, C), and 'z')."""
        if self.num_spks is not None and spkid is None:
            raise ValueError("Please specify spk ID to network to build OH identifier in "
                             "decoder")
        hall: Dict[str, torch.Tensor] = {}
        hi = x.transpose(1, 2)
        skips: Dict[int, torch.Tensor] = {}
        for l_i, blk in enumerate(self.gen_enc):
            hi, linear_hi = blk(hi, generator)
            if l_i in self.skip_layers:
                skips[l_i] = hi if self.post_skip else linear_hi
            if ret_hid:
                hall[f"enc_{l_i}"] = hi.transpose(1, 2)
        B, Cb, Tb = hi.shape
        z_up = None
        if self.rnn_core is not None:
            if z is None:
                z = (torch.zeros((2, B, Cb // 2), dtype=hi.dtype, device=hi.device)
                     if self.no_z else self.sample_z((B, Tb, Cb), generator))
            hi = self.rnn_core(hi.transpose(1, 2), z.to(hi.device)).transpose(1, 2)
        else:
            if not self.no_z:
                if z is None:
                    z = self.sample_z((B, Tb, Cb), generator)
                if z.dim() != hi.dim():
                    raise ValueError(f"len(z.size) {z.dim()} != len(hi.size) {hi.dim()}")
                z_up = z.to(hi.device, hi.dtype).transpose(1, 2)
                hi = torch.cat([z_up, hi], dim=1)  # z first
                if ret_hid:
                    hall["enc_zc"] = hi.transpose(1, 2)
            if self.use_pos_code:
                hi = pos_code(torch.as_tensor(slice_idx).broadcast_to((B,)), hi)
        if self.freeze_enc:  # after the skips were taken: their gradients still flow
            hi = hi.detach()
        spk_oh = None
        if self.num_spks is not None:
            ids = torch.as_tensor(spkid, device=hi.device).reshape(B).long()
            spk_oh = nn.functional.one_hot(ids, self.num_spks).to(hi.dtype)

        enc_idx = len(self.gen_enc) - 1
        for l_i, blk in enumerate(self.gen_dec):
            if self._takes_skip(enc_idx, self.up_poolings[l_i]):
                hi = getattr(self, f"alpha_{enc_idx}")(skips[enc_idx], hi)
            if l_i > 0 and self.z_all and z_up is not None:
                z_up = torch.cat([z_up, z_up], dim=2)  # z's time doubles at every stage
                hi = torch.cat([hi, z_up], dim=1)
            if spk_oh is not None:
                hi = torch.cat([hi, spk_oh[:, :, None].expand(-1, -1, hi.shape[2])], dim=1)
            hi, _ = blk(hi, generator)
            enc_idx -= 1
            if ret_hid:
                hall[f"dec_{l_i}"] = hi.transpose(1, 2)

        if self.aal_out_taps is not None:
            n = self.aal_out_taps.shape[0]
            hp = conv_ops.zero_pad_1d(hi, (n - 1) // 2, n - 1 - (n - 1) // 2)
            hi = conv_ops.conv1d(hp, self.aal_out_taps.to(hi.dtype).view(1, 1, n))
        if self.comb_net is not None:
            hi = torch.tanh(self.comb_net(hi))
        if self.out_gate is not None:
            hi = hi * torch.sigmoid(self.out_gate(hi))
        if self.out_filter is not None:
            hi = self.out_filter(conv_ops.zero_pad_1d(hi, 256, 256))
        y = hi.transpose(1, 2)
        if ret_hid:
            hall["z"] = z
            return y, hall
        return y
