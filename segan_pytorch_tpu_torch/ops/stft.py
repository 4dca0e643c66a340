"""The STFT power spectrum of WSEGAN's power loss: the counterpart of
``segan_pytorch_tpu/ops/stft.py`` (its 'fft' method).

``torch.stft`` as the upstream loss calls it: n_fft = min(T, 2048), hop 160, a
rectangular window of 320 samples centred in the n_fft frame (upstream passes
window=None; the ones window here is the same window, passed so that torch does not warn),
normalized=True, center=True with reflect padding, one-sided. The power is re^2 + im^2,
not |X|^2 through abs(): the modulus's gradient at an all-zero frame is 0/0, and a bf16
generator does put out such frames. The JAX package's 'matmul' method and
``stft_precision`` are TPU lowering knobs and have no counterpart here.
"""
from __future__ import annotations

import torch

HOP, WIN = 160, 320


def stft_power(x: torch.Tensor, n_fft: int = 2048) -> torch.Tensor:
    """|STFT|^2 / n_fft of (B, T) -> (B, n_fft//2 + 1, frames), torch.stft's layout, in
    fp32 (or wider) whatever x's dtype."""
    x = x if x.dtype in (torch.float32, torch.float64) else x.float()
    n_fft = min(x.shape[-1], n_fft)
    win = min(WIN, n_fft)
    spec = torch.stft(x, n_fft, hop_length=HOP, win_length=win,
                      window=torch.ones(win, dtype=x.dtype, device=x.device),
                      center=True, pad_mode="reflect", normalized=True, onesided=True,
                      return_complex=True)
    return spec.real.square() + spec.imag.square()


def power_spectrum_db(x: torch.Tensor, n_fft: int = 2048) -> torch.Tensor:
    """10 log10(|STFT|^2 + 1e-19) of (B, T), with a finite gradient at all-zero frames
    (upstream's model.py:645-652, whose constant is written 10e-20)."""
    return 10.0 * torch.log10(stft_power(x, n_fft) + 10e-20)
