"""SEGAN Discriminator: the counterpart of ``segan_pytorch_tpu/models/discriminator.py``.

A stack of GConv1DBlocks (conv -> BatchNorm -> PReLU by default) over the (judged,
noisy) pair, each block after a random phase-shift roll of the time axis, then one of
five heads. The input is torch's (B, 2, T), channel 0 the judged wav and channel 1 the
noisy one (the JAX D takes (B, T, 2)); the hidden activations in ``int_act`` are
(B, C, T), and the 'mlp' head's logit (B, 1, T').

Parameter names are upstream's: 'enc_blocks.<i>.{conv,norm,act}', the 'none' head
'fc.{0,2,4}' (Linear) with 'fc.{1,3}' (PReLU), 'pool_conv' + 'fc' for 'conv', 'fc' for
'gmax'/'gavg' and 'mlp.{0,1,2}' for 'mlp'. The 'none' head flattens (B, C, T) to C*T, as
upstream does (the JAX D flattens (B, T, C) to T*C; ``utils/checkpoint.py`` permutes
fc.0 between them).

With ``sinc_conv`` both channels first go through one ``SincConv`` of fmaps[0] // 2
filters (K = 251, a 'SAME' reflect pad), named 'sinc_conv', and the blocks take fmaps[1:]
zipped with the poolings: a default D then has four blocks, and at 16384 samples its
'none' head needs ``pool_slen`` 64. The phase-shift rolls come before the blocks, not
the filter bank, as in the JAX D.

With ``norm_type='snorm'`` (WSEGAN's D) the blocks have no BatchNorm and their convs are
spectrally normalised, and so are the heads' layers as upstream has them: in 'none'
fc.0, fc.2 and the PReLU fc.3 (not fc.1 nor fc.4), in 'conv' pool_conv and fc, in
'gmax'/'gavg' fc, in 'mlp' mlp.0 and the PReLU mlp.1 (not mlp.2).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.roll import phase_shift_roll
from .modules import Conv1d, GConv1DBlock, Linear, PReLU, SincConv


class Discriminator(nn.Module):
    """forward(x (B, 2, T), mask=None, phase=None, generator=None) -> (logit, int_act).

    The phase shift (WaveGAN's trick) rolls the time axis before every block by a shift
    in [1, phase_shift], right or left. The draws are ``phase``, a (n_layers, 2) array
    of (shift, right) rows, when given; else they come from ``generator``; with
    neither, nothing rolls, as the JAX D does not roll without its 'phase' stream. A
    ``phase`` tensor on x's device is read there (a CUDA graph of the step records the
    rolls with its buffer); any other is read on the host, where it costs no sync."""

    def __init__(self, ninputs: int, fmaps: Sequence[int], kwidth: int,
                 poolings: Sequence[int], pool_type: str = "none",
                 pool_slen: Optional[int] = None, norm_type: Optional[str] = "bnorm",
                 use_bias: bool = True, phase_shift: Optional[int] = None,
                 sinc_conv: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        if pool_slen is None:
            raise ValueError("Please specify D network pool seq len (pool_slen) in the end "
                             "of the conv stack: [inp_len // (total_pooling_factor)]")
        if phase_shift is not None and not (isinstance(phase_shift, int) and phase_shift > 1):
            raise ValueError(f"phase_shift must be an int > 1, got {phase_shift!r}")
        if pool_type not in ("none", "conv", "gmax", "gavg", "mlp"):
            raise TypeError(f"Unrecognized pool type: {pool_type}")
        fmaps = list(fmaps)
        self.pool_type, self.pool_slen, self.phase_shift = pool_type, pool_slen, phase_shift
        self.sinc_conv = None
        ninp, blocks = ninputs, fmaps
        if sinc_conv:
            # one bank of fmaps[0] // 2 filters for both channels; the blocks take the
            # rest of fmaps, zipped with the poolings from the first
            self.sinc_conv = SincConv(fmaps[0] // 2, 251, 16e3, padding="SAME")
            ninp, blocks = fmaps[0], fmaps[1:]
        self.enc_blocks = nn.ModuleList()
        for fmap, pool in zip(blocks, poolings):
            self.enc_blocks.append(GConv1DBlock(ninp, fmap, kwidth, stride=pool,
                                                use_bias=use_bias, norm_type=norm_type,
                                                generator=generator))
            ninp = fmap
        c = fmaps[-1]
        g = generator
        sn = norm_type == "snorm"  # spectral norm in the head too, with upstream's quirks
        if pool_type == "none":
            # the second PReLU is spectrally normalised and the last Linear is not
            self.fc = nn.Sequential(Linear(pool_slen * c, 256, snorm=sn, generator=g),
                                    PReLU(256),
                                    Linear(256, 128, snorm=sn, generator=g),
                                    PReLU(128, snorm=sn, generator=g),
                                    Linear(128, 1, generator=g))
        elif pool_type == "conv":
            self.pool_conv = Conv1d(c, 1, 1, snorm=sn, generator=g)
            self.fc = Linear(pool_slen, 1, snorm=sn, generator=g)
        elif pool_type in ("gmax", "gavg"):
            self.fc = Linear(c, 1, snorm=sn, generator=g)
        else:  # mlp: the last conv is not spectrally normalised
            self.mlp = nn.Sequential(Conv1d(c, c, 1, snorm=sn, generator=g),
                                     PReLU(c, snorm=sn, generator=g),
                                     Conv1d(c, 1, 1, generator=g))

    def sample_phase(self, generator: Optional[torch.Generator] = None,
                     passes: Optional[int] = None) -> Optional[torch.Tensor]:
        """(shift, right) draws for one pass, (n_layers, 2), or for ``passes`` passes,
        (passes, n_layers, 2), on the CPU from ``generator``; None without a phase
        shift."""
        if self.phase_shift is None:
            return None
        lead = (passes,) if passes is not None else ()
        shape = lead + (len(self.enc_blocks),)
        shift = torch.randint(1, self.phase_shift + 1, shape, generator=generator)
        right = torch.randint(0, 2, shape, generator=generator)
        return torch.stack([shift, right], dim=-1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                phase=None, generator: Optional[torch.Generator] = None):
        if self.phase_shift is None:
            phase = None
        elif phase is None and generator is not None:
            phase = self.sample_phase(generator)
        if phase is not None and not (torch.is_tensor(phase) and phase.device == x.device):
            phase = torch.as_tensor(phase).tolist()
        int_act: Dict[str, torch.Tensor] = {}
        h = x if self.sinc_conv is None else self.sinc_conv(x)
        for ii, blk in enumerate(self.enc_blocks):
            if phase is not None:
                shift, right = phase[ii]
                h = phase_shift_roll(h, shift, right)
            h = blk(h, mask=mask)
            int_act[f"h_{ii}"] = h
        if self.pool_type == "none":
            y = self.fc(h.reshape(h.shape[0], -1))
        elif self.pool_type == "conv":
            hp = self.pool_conv(h).reshape(h.shape[0], -1)
            int_act["avg_conv_h"] = hp
            y = self.fc(hp)
        elif self.pool_type == "gmax":
            y = self.fc(h.amax(dim=2))
        elif self.pool_type == "gavg":
            y = self.fc(h.mean(dim=2))
        else:
            y = self.mlp(h)
        int_act["logit"] = y
        return y, int_act


def build_discriminator(cfg, generator: Optional[torch.Generator] = None) -> Discriminator:
    """Assemble a Discriminator from a SEGANConfig, initialised from `generator`. Its
    convs carry a bias whatever ``cfg.bias`` says, as upstream's D does."""
    return Discriminator(
        ninputs=2,
        fmaps=cfg.denc_fmaps,
        kwidth=cfg.gkwidth if cfg.dkwidth is None else cfg.dkwidth,
        poolings=cfg.denc_poolings,
        pool_type=cfg.dpool_type,
        pool_slen=cfg.dpool_slen,
        norm_type=cfg.dnorm_type,
        phase_shift=cfg.phase_shift,
        sinc_conv=cfg.sinc_conv,
        generator=generator,
    )


def d_input(judged: torch.Tensor, noisy: torch.Tensor) -> torch.Tensor:
    """D's input (B, 2, T) from the judged and the noisy wav, each (B, T, 1)."""
    return torch.cat([judged.transpose(1, 2), noisy.transpose(1, 2)], dim=1)
