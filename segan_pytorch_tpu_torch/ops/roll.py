"""The Discriminator's phase-shift roll: the counterpart of
``segan_pytorch_tpu/ops/roll.py:phase_shift_roll``.

A circular roll of the time axis, dim 2 of (B, C, T); its backward is the inverse roll.
The (shift, right) draws are passed in, as host ints or as tensors. With ints it is
``torch.roll``. With tensors it reads them where they lie and never on the host, as the
JAX roll takes traced shifts: a gather of x at (t - amount) mod T, which a CUDA graph
records with the draws' buffers, so each replay rolls by the draws copied there. Both are
the same permutation, equal bit for bit. The JAX package's halo-buffer lowering
(``roll_impl``) is a TPU choice with the same values, and has no counterpart here.
"""
from __future__ import annotations

from typing import Union

import torch

Shift = Union[int, torch.Tensor]


def _gather_roll(x: torch.Tensor, amount: torch.Tensor) -> torch.Tensor:
    """``torch.roll(x, amount, dims=2)`` for a 0-d integer tensor ``amount``."""
    T = x.shape[2]
    index = torch.remainder(torch.arange(T, device=x.device) - amount, T)
    return x.index_select(2, index)


class _RollTime(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, amount):
        ctx.save_for_backward(amount)
        return _gather_roll(x, amount)

    @staticmethod
    def backward(ctx, grad):
        (amount,) = ctx.saved_tensors
        return _gather_roll(grad, -amount), None


def phase_shift_roll(x: torch.Tensor, shift: Shift, right: Shift) -> torch.Tensor:
    """Roll the time axis of (B, C, T) by ``+shift`` when ``right``, else ``-shift``.
    ``shift`` and ``right`` are host ints, or integer tensors on x's device."""
    if not torch.is_tensor(shift):
        return torch.roll(x, int(shift) if right else -int(shift), dims=2)
    return _RollTime.apply(x, torch.where(right.bool(), shift, -shift))
