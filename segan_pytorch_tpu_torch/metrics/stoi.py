"""Short-Time Objective Intelligibility (STOI), Taal et al. 2010/2011: a copy of
``segan_pytorch_tpu/metrics/stoi.py`` (numpy and scipy only), pinned to it by
``tests/test_torch_aux_data.py``.

Resample to 10 kHz, remove silent frames (40 dB below the peak, 256-sample Hann frames,
50% overlap), 1/3-octave band decomposition (15 bands from 150 Hz) over a 512-point FFT,
384 ms (N = 30 frames) short-time segments, normalised and clipped correlation,
averaged.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
from scipy.signal import resample_poly

FS = 10000
N_FRAME = 256
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150
N = 30
BETA = -15.0
DYN_RANGE = 40


def _thirdoct(fs: int, nfft: int, num_bands: int, min_freq: float):
    f = np.linspace(0, fs, nfft + 1)[: nfft // 2 + 1]
    k = np.arange(num_bands)
    cf = 2.0 ** (k / 3.0) * min_freq
    fl = np.sqrt((2.0 ** (k / 3.0) * min_freq) * (2.0 ** ((k - 1) / 3.0) * min_freq))
    fr = np.sqrt((2.0 ** (k / 3.0) * min_freq) * (2.0 ** ((k + 1) / 3.0) * min_freq))
    A = np.zeros((num_bands, len(f)))
    for i in range(num_bands):
        fl_i = np.argmin((f - fl[i]) ** 2)
        fr_i = np.argmin((f - fr[i]) ** 2)
        A[i, fl_i:fr_i] = 1
    rnk = np.sum(A, axis=1)
    end = np.argmax((rnk[1:] >= rnk[:-1]) & (rnk[1:] != 0)) if num_bands > 1 else 0
    return A, cf


def _frame_sig(x: np.ndarray, frame_len: int, hop: int) -> np.ndarray:
    # the MATLAB grid is `1:K:(length(x)-N)`: the last frame start is at most length-N
    # (1-based), i.e. a frame never includes the final sample
    n = (len(x) - frame_len - 1) // hop + 1 if len(x) > frame_len else 0
    if n <= 0:
        return np.zeros((0, frame_len))
    idx = np.arange(n)[:, None] * hop + np.arange(frame_len)[None, :]
    return x[idx]


def _remove_silent_frames(x, y, dyn_range, frame_len, hop):
    w = np.hanning(frame_len + 2)[1:-1]
    xf = _frame_sig(x, frame_len, hop) * w
    yf = _frame_sig(y, frame_len, hop) * w
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-16)
    mask = energies > (np.max(energies) - dyn_range)
    xf, yf = xf[mask], yf[mask]
    # overlap-add back
    n_out = (xf.shape[0] - 1) * hop + frame_len if xf.shape[0] else 0
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(xf.shape[0]):
        xs[i * hop : i * hop + frame_len] += xf[i]
        ys[i * hop : i * hop + frame_len] += yf[i]
    return xs, ys


def stoi(clean: np.ndarray, deg: np.ndarray, fs_sig: int = 16000,
         dyn_range: float = DYN_RANGE) -> float:
    """d = stoi(clean, degraded, fs). Higher is better, roughly in [0, 1].

    dyn_range overrides the silent-frame threshold (standard: 40 dB below the peak
    frame). A stricter value (e.g. 25) scores active-speech regions only, which tells
    intelligibility changes apart from artefacts in the pauses."""
    d, _ = _stoi_impl(clean, deg, fs_sig, dyn_range)
    return d


def stoi_band_profile(clean: np.ndarray, deg: np.ndarray, fs_sig: int = 16000,
                      dyn_range: float = DYN_RANGE):
    """Per-band diagnostic: (center_freqs_hz, mean short-time correlation per
    1/3-octave band). stoi() is the mean of the second array. Shows WHICH
    bands lose temporal-envelope correlation under an enhancer."""
    _, per_band = _stoi_impl(clean, deg, fs_sig, dyn_range)
    _, cf = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    return cf, per_band


def _stoi_impl(clean, deg, fs_sig, dyn_range):
    clean = np.asarray(clean, np.float64).reshape(-1)
    deg = np.asarray(deg, np.float64).reshape(-1)
    L = min(len(clean), len(deg))
    clean, deg = clean[:L], deg[:L]
    if fs_sig != FS:
        frac = Fraction(FS, fs_sig).limit_denominator(1000)
        clean = resample_poly(clean, frac.numerator, frac.denominator)
        deg = resample_poly(deg, frac.numerator, frac.denominator)
    hop = N_FRAME // 2
    clean, deg = _remove_silent_frames(clean, deg, dyn_range, N_FRAME, hop)
    nan = float("nan"), np.full((NUM_BANDS,), np.nan)
    if len(clean) < N_FRAME * 2:
        return nan
    A, _ = _thirdoct(FS, NFFT, NUM_BANDS, MIN_FREQ)
    w = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frame_sig(clean, N_FRAME, hop) * w
    yf = _frame_sig(deg, N_FRAME, hop) * w
    X = np.abs(np.fft.rfft(xf, NFFT, axis=1)) ** 2  # (F, 257)
    Y = np.abs(np.fft.rfft(yf, NFFT, axis=1)) ** 2
    Xb = np.sqrt(X @ A.T)  # (F, bands)
    Yb = np.sqrt(Y @ A.T)
    if Xb.shape[0] < N:
        return nan
    band_sum = np.zeros((NUM_BANDS,))
    n_seg = 0
    for m in range(N, Xb.shape[0] + 1):
        Xseg = Xb[m - N : m].T  # (bands, N)
        Yseg = Yb[m - N : m].T
        alpha = np.sqrt(
            np.sum(Xseg**2, axis=1, keepdims=True)
            / (np.sum(Yseg**2, axis=1, keepdims=True) + 1e-16)
        )
        Yprime = Yseg * alpha
        Yprime = np.minimum(Yprime, Xseg * (1 + 10 ** (-BETA / 20)))
        x0 = Xseg - Xseg.mean(axis=1, keepdims=True)
        y0 = Yprime - Yprime.mean(axis=1, keepdims=True)
        corr = np.sum(x0 * y0, axis=1) / (
            np.linalg.norm(x0, axis=1) * np.linalg.norm(y0, axis=1) + 1e-16
        )
        band_sum += corr
        n_seg += 1
    per_band = band_sum / n_seg
    return float(per_band.mean()), per_band
