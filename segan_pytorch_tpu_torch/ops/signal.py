"""Waveform helpers: copies of the numpy functions of ``segan_pytorch_tpu/ops/signal.py``
(pinned by ``tests/test_torch_config.py``), the numpy form of ``normalize_wave_minmax``
among them, and torch versions of its array functions (``denormalize_wave_minmax``,
``abs_short_normalize_wave_minmax``, ``dynamic_normalize_wave_minmax``,
``pre_emphasize``, ``de_emphasize``; ``tests/test_torch_signal.py``). The datasets and
the evaluation workers import this module on the host, so torch is imported only by
the functions that take tensors."""
from __future__ import annotations

import numpy as np
from scipy.signal import lfilter


def normalize_wave_minmax(x: np.ndarray) -> np.ndarray:
    """int16 PCM -> [-1, 1] float: (2/65535)*(x - 32767) + 1."""
    return (2.0 / 65535.0) * (np.asarray(x).astype(np.float32) - 32767.0) + 1.0


def abs_normalize_wave_minmax(x: np.ndarray) -> np.ndarray:
    """x as int32 over its largest magnitude (the F0 dataset's normalisation)."""
    x = np.asarray(x).astype(np.int32)
    return x / np.max(np.abs(x))


def denormalize_wave_minmax(x):
    """Upstream's inverse of ``normalize_wave_minmax`` (its utils.py:23-24), 65535 x / 2 -
    1 + 32767, on a tensor or an array."""
    return (65535.0 * x / 2.0) - 1.0 + 32767.0


def abs_short_normalize_wave_minmax(x):
    """x over the int16 magnitude 32767, on a tensor or an array."""
    return x / 32767.0


def dynamic_normalize_wave_minmax(x):
    """x (integer PCM, a tensor or an array) mapped onto [-1, 1] by its own minimum and
    maximum, in float64 as the JAX function's numpy computes it."""
    import torch

    x = torch.as_tensor(x).to(torch.int32)
    imax, imin = float(x.max()), float(x.min())
    return ((x.double() - imin) / (imax - imin)) * 2 - 1


def pre_emphasize(x, coef: float = 0.95):
    """y[0] = x[0]; y[t] = x[t] - coef*x[t-1] along the last axis of a tensor (..., T)."""
    import torch

    if coef <= 0:
        return x
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], dim=-1)


def de_emphasize(y, coef: float = 0.95):
    """The inverse IIR x[t] = coef*x[t-1] + y[t] along the last axis of a tensor (..., T),
    in log2(T) parallel steps on the tensor's device, as the JAX function's associative
    scan computes it: after the step of offset d every x[t] holds the sum of coef^k
    y[t - k] over its last 2d samples."""
    import torch

    if coef <= 0:
        return y
    x, d = y, 1
    while d < y.shape[-1]:
        x = torch.cat([x[..., :d], x[..., d:] + (coef ** d) * x[..., :-d]], dim=-1)
        d *= 2
    return x


def pre_emphasize_np(x: np.ndarray, coef: float = 0.95) -> np.ndarray:
    """y[0] = x[0]; y[t] = x[t] - coef*x[t-1]."""
    if coef <= 0:
        return x
    x0 = np.reshape(x[0], (1,))
    return np.concatenate((x0, x[1:] - coef * x[:-1]), axis=0)


def de_emphasize_np(y: np.ndarray, coef: float = 0.95) -> np.ndarray:
    """Inverse IIR x[t] = coef*x[t-1] + y[t], exact and sequential (scipy lfilter)."""
    if coef <= 0:
        return y
    return lfilter([1.0], [1.0, -coef], y, axis=-1).astype(np.float32)


def div_n_len(T: int, n: int) -> int:
    """The length ``make_div_n_np`` pads T samples to: the next multiple of n, with
    upstream's quirk (the JAX ``make_div_n``) that a multiple of n gets a full n more."""
    return T + n - T % n


def make_div_n_np(x: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the last axis to ``div_n_len`` of its length."""
    T = x.shape[-1]
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, div_n_len(T, n) - T)])


def slice_signal_indices(n_samples: int, window_size: int, stride: float):
    """(beg, end) windows of `window_size` at `stride` fraction of it."""
    assert 0 < stride <= 1, stride
    offset = int(window_size * stride)
    return [(b, b + window_size) for b in range(0, n_samples - window_size + 1, offset)]
