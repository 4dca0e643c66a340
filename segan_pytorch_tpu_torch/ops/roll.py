"""The Discriminator's phase-shift roll: the counterpart of
``segan_pytorch_tpu/ops/roll.py:phase_shift_roll``.

A circular roll of the time axis, dim 2 of (B, C, T); autograd's backward is the inverse
roll. The (shift, right) draws are passed in. The JAX package's halo-buffer lowering
(``roll_impl``) is a TPU choice with the same values, and has no counterpart here.
"""
from __future__ import annotations

import torch


def phase_shift_roll(x: torch.Tensor, shift: int, right: bool) -> torch.Tensor:
    """Roll the time axis of (B, C, T) by ``+shift`` when ``right``, else ``-shift``."""
    return torch.roll(x, int(shift) if right else -int(shift), dims=2)
