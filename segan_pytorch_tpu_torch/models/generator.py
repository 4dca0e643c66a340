"""SEGAN+ Generator: the counterpart of ``segan_pytorch_tpu/models/generator.py``.

Strided conv encoder -> z concatenated at the bottleneck -> transposed-conv decoder
with skips and a Tanh output. Public shapes are the JAX package's: x (B, T, 1), z (B,
T / prod(poolings), z_dim), output (B, T, 1). Inside, every tensor is (B, C, T).

Every encoder layer of a norm-free or snorm G runs the hand-written conv + bias + PReLU
kernel on a CUDA device (``models/modules.py`` ``GConv1DBlock``). A bnorm G
(``gnorm_type='bnorm'``) has a BatchNorm between each conv and its activation, so its
encoder takes the plain conv, as the JAX block does, and launches no kernel; its
decoder blocks normalise after the deconv (and the odd-K trim). G's norms take every
row, with no mask, in training as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import conv as conv_ops
from ..ops import initializers as init
from .modules import Conv1d, GConv1DBlock, GDeconv1DBlock

_ALPHA_INITS = {"zero": init.zeros, "randn": init.standard_normal, "one": init.ones}


class GSkip(nn.Module):
    """Skip shuttle from an encoder layer to its decoder mirror.

    skip_type 'alpha' (learnt per-channel scale 'skip_k' of shape (1, C, 1)),
    'constant' (the same, frozen) or 'conv' (a K-wide zero-padded conv 'skip_k');
    merge_mode 'sum' or 'concat' (order [hi, sk_h]). Dropout acts in training only."""

    def __init__(self, skip_type: str, size: int, skip_init: str = "one",
                 skip_dropout: float = 0.0, merge_mode: str = "sum", kwidth: int = 11,
                 use_bias: bool = True, generator: Optional[torch.Generator] = None):
        super().__init__()
        if merge_mode not in ("sum", "concat"):
            raise TypeError(f"Unrecognized skip merge mode: {merge_mode}")
        self.skip_type, self.merge_mode, self.kwidth = skip_type, merge_mode, kwidth
        if skip_type in ("alpha", "constant"):
            if skip_init not in _ALPHA_INITS:
                raise TypeError(f"Unrecognized alpha init scheme: {skip_init}")
            k = _ALPHA_INITS[skip_init]((size,), generator).view(1, size, 1)
            self.skip_k = nn.Parameter(k, requires_grad=(skip_type == "alpha"))
        elif skip_type == "conv":
            self.skip_k = Conv1d(size, size, kwidth, use_bias=use_bias,
                                 generator=generator)
        else:
            raise TypeError(f"Unrecognized GSkip scheme: {skip_type}")
        self.dropout = nn.Dropout(skip_dropout) if skip_dropout > 0 else None

    def forward(self, hj, hi):
        if self.skip_type == "conv":
            pad = self.kwidth // 2 if self.kwidth > 1 else 0
            sk_h = self.skip_k(conv_ops.zero_pad_1d(hj, pad, pad))
        else:
            sk_h = self.skip_k * hj
        if self.dropout is not None:
            sk_h = self.dropout(sk_h)
        if self.merge_mode == "sum":
            return sk_h + hi
        return torch.cat([hi, sk_h], dim=1)


class Generator(nn.Module):
    """Encoder GConv1DBlocks 'enc_blocks', decoder 'dec_blocks', skips 'alpha_<i>'.

    The plan is the JAX package's (and upstream's): a skip for every encoder layer
    but the last; z (z_dim channels, default fmaps[-1]) concatenated FIRST at the
    bottleneck; decoder fmaps fmaps[::-1][1:] + [1], doubling input channels under
    'concat' for the layers that take a skip; the last layer ends in Tanh."""

    def __init__(self, ninputs: int, fmaps: Sequence[int], kwidth: Union[int, List[int]],
                 poolings: Sequence[int], dec_fmaps: Optional[List[int]] = None,
                 dec_kwidth: Union[int, List[int], None] = None,
                 dec_poolings: Optional[List[int]] = None, z_dim: Optional[int] = None,
                 no_z: bool = False, skip: bool = True, use_bias: bool = False,
                 skip_init: str = "one", skip_dropout: float = 0.0,
                 skip_type: str = "alpha", norm_type: Optional[str] = None,
                 skip_merge: str = "sum", skip_kwidth: int = 11,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        fmaps, poolings = list(fmaps), list(poolings)
        kwidths = [kwidth] * len(fmaps) if isinstance(kwidth, int) else list(kwidth)
        self.poolings, self.no_z = poolings, no_z
        self.z_dim = None if no_z else (z_dim if z_dim is not None else fmaps[-1])

        self.enc_blocks = nn.ModuleList()
        ninp = ninputs
        for fmap, pool, kw in zip(fmaps, poolings, kwidths):
            self.enc_blocks.append(GConv1DBlock(ninp, fmap, kw, stride=pool,
                                                use_bias=use_bias, norm_type=norm_type,
                                                generator=generator))
            ninp = fmap
        n_enc = len(self.enc_blocks)
        self.skip_layers = set(range(n_enc - 1)) if skip else set()
        if not no_z:
            ninp += self.z_dim

        dec_fmaps = fmaps[::-1][1:] + [1] if dec_fmaps is None else list(dec_fmaps)
        self.dec_poolings = poolings[:] if dec_poolings is None else list(dec_poolings)
        if dec_kwidth is None:
            dec_kwidth = kwidths[:]
        elif isinstance(dec_kwidth, int):
            dec_kwidth = [dec_kwidth] * len(dec_fmaps)
        self.dec_blocks = nn.ModuleList()
        enc_idx = n_enc - 1
        for pi, (fmap, pool, kw) in enumerate(
                zip(dec_fmaps, self.dec_poolings, dec_kwidth), start=1):
            if self._takes_skip(enc_idx, pool):
                setattr(self, f"alpha_{enc_idx}", GSkip(
                    skip_type, fmaps[enc_idx], skip_init=skip_init,
                    skip_dropout=skip_dropout, merge_mode=skip_merge,
                    kwidth=skip_kwidth, use_bias=use_bias, generator=generator))
            if skip and pi > 1 and pool > 1 and skip_merge == "concat":
                ninp *= 2
            if pool > 1:
                act = "Tanh" if pi >= len(dec_fmaps) else None
                blk = GDeconv1DBlock(ninp, fmap, kw, stride=pool, norm_type=norm_type,
                                     act=act, generator=generator)
            else:
                blk = GConv1DBlock(ninp, fmap, kw, stride=1, use_bias=use_bias,
                                   norm_type=norm_type, generator=generator)
            self.dec_blocks.append(blk)
            ninp = fmap
            enc_idx -= 1

    def _takes_skip(self, enc_idx: int, pool: int) -> bool:
        return enc_idx in self.skip_layers and pool > 1

    def sample_z(self, x_shape: Tuple[int, ...],
                 generator: Optional[torch.Generator] = None) -> Optional[torch.Tensor]:
        """z ~ N(0, 1) of shape (B, T_bottleneck, z_dim), from `generator` and on its
        device (the CPU without one)."""
        if self.no_z:
            return None
        t = x_shape[1]
        for p in self.poolings:
            t //= p
        return torch.randn((x_shape[0], t, self.z_dim), generator=generator,
                           device=generator.device if generator is not None else None)

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None,
                ret_hid: bool = False):
        """x (B, T, 1), z (B, T', z_dim) -> (B, T, 1); with ret_hid also a dict of the
        hidden tensors ('enc_<i>', 'enc_zc', 'dec_<i>', 'z'), each (B, T, C)."""
        hall: Dict[str, torch.Tensor] = {}
        hi = x.transpose(1, 2)
        skips: Dict[int, torch.Tensor] = {}
        for l_i, blk in enumerate(self.enc_blocks):
            hi, linear_hi = blk(hi, ret_linear=True)
            if l_i in self.skip_layers:
                skips[l_i] = linear_hi  # skips carry the PRE-activation
            if ret_hid:
                hall[f"enc_{l_i}"] = hi.transpose(1, 2)
        if not self.no_z:
            if z is None:
                z = torch.randn((hi.shape[0], hi.shape[2], self.z_dim),
                                dtype=hi.dtype, device=hi.device)
            if z.dim() != hi.dim():
                raise ValueError(f"len(z.shape) {z.dim()} != len(hi.shape) {hi.dim()}")
            hi = torch.cat([z.transpose(1, 2).to(hi.dtype), hi], dim=1)  # z first
            if ret_hid:
                hall["enc_zc"] = hi.transpose(1, 2)
        enc_idx = len(self.enc_blocks) - 1
        for l_i, blk in enumerate(self.dec_blocks):
            if self._takes_skip(enc_idx, self.dec_poolings[l_i]):
                hi = getattr(self, f"alpha_{enc_idx}")(skips[enc_idx], hi)
            hi = blk(hi)
            enc_idx -= 1
            if ret_hid:
                hall[f"dec_{l_i}"] = hi.transpose(1, 2)
        y = hi.transpose(1, 2)
        if ret_hid:
            hall["z"] = z
            return y, hall
        return y


def build_generator(cfg, generator: Optional[torch.Generator] = None) -> Generator:
    """Assemble a Generator from a SEGANConfig, initialised from `generator`."""
    return Generator(
        ninputs=1,
        fmaps=cfg.genc_fmaps,
        kwidth=cfg.gkwidth,
        poolings=cfg.genc_poolings,
        dec_fmaps=cfg.gdec_fmaps,
        dec_kwidth=cfg.gdec_kwidth,
        dec_poolings=cfg.gdec_poolings,
        z_dim=cfg.z_dim,
        no_z=cfg.no_z,
        skip=not cfg.no_skip,
        use_bias=cfg.bias,
        skip_init=cfg.skip_init,
        skip_type=cfg.skip_type,
        norm_type=cfg.gnorm_type,
        skip_merge=cfg.skip_merge,
        skip_kwidth=cfg.skip_kwidth,
        generator=generator,
    )
