"""Acoustic-feature file I/O and F0 analysis: a copy of ``segan_pytorch_tpu/data/aco.py``
(numpy only), pinned to it by ``tests/test_torch_aux_data.py``.

- ``read_aco_file`` / ``write_aco_file``: raw float32 binary matrices (the aho format);
- ``interpolation``: unvoiced frames (marked by a sentinel, -1e10 at the call sites)
  interpolated linearly, with the voiced/unvoiced mask;
- ``f0_autocorr``: an autocorrelation F0 tracker, log-F0 and U/V per 80-sample hop (5 ms
  at 16 kHz);
- ``wav2lf0``: the ``ahocoder16_64`` binary where it is on PATH, else ``f0_autocorr``.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np


def read_aco_file(path: str, out_shape: Optional[tuple] = None) -> np.ndarray:
    data = np.fromfile(path, dtype=np.float32)
    if out_shape is not None:
        data = data.reshape(out_shape)
    return data


def write_aco_file(path: str, data: np.ndarray):
    np.asarray(data, np.float32).tofile(path)


def interpolation(signal: np.ndarray, unvoiced_symbol: float
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Linearly interpolate across unvoiced frames; returns (interpolated, uv_mask).

    As ``ahoproc_tools.interpolate.interpolation``: the uv mask is 1 for voiced frames;
    leading and trailing unvoiced regions take the nearest voiced value."""
    sig = np.asarray(signal, np.float32).reshape(-1)
    uv = (sig > unvoiced_symbol + 1).astype(np.float32) if unvoiced_symbol < -1e5 \
        else (sig != unvoiced_symbol).astype(np.float32)
    voiced_idx = np.where(uv > 0)[0]
    out = sig.copy()
    if voiced_idx.size == 0:
        return out, uv
    idx = np.arange(sig.shape[0])
    out = np.interp(idx, voiced_idx, sig[voiced_idx]).astype(np.float32)
    return out, uv


def f0_autocorr(wav: np.ndarray, srate: int = 16000, hop: int = 80,
                win: int = 320, fmin: float = 60.0, fmax: float = 400.0,
                voicing_thresh: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    """Autocorrelation F0 tracker: (lf0, uv) per hop. lf0 is log(F0) for voiced frames
    and log(60) for unvoiced ones (the F0 dataset's unvoiced fill), uv in {0, 1}."""
    wav = np.asarray(wav, np.float32).reshape(-1)
    n_frames = max(0, 1 + (len(wav) - win) // hop)
    lf0 = np.full((n_frames,), np.log(60.0), np.float32)
    uv = np.zeros((n_frames,), np.float32)
    lag_min = int(srate / fmax)
    lag_max = min(int(srate / fmin), win - 1)
    if n_frames <= 0 or lag_max <= lag_min:
        return lf0, uv
    idx = np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    frames = wav[idx]
    frames = frames - frames.mean(axis=1, keepdims=True)
    # full autocorrelation via rfft (vectorized over frames)
    nfft = int(2 ** np.ceil(np.log2(2 * win)))
    spec = np.fft.rfft(frames, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :win]
    ac0 = np.maximum(ac[:, :1], 1e-12)
    nac = ac / ac0
    seg = nac[:, lag_min:lag_max]
    best = np.argmax(seg, axis=1)
    best_val = seg[np.arange(n_frames), best]
    energy = (frames**2).mean(axis=1)
    voiced = (best_val > voicing_thresh) & (energy > 1e-6)
    f0 = srate / (best + lag_min).astype(np.float32)
    lf0[voiced] = np.log(f0[voiced])
    uv[voiced] = 1.0
    return lf0, uv


def wav2lf0(wav: np.ndarray, srate: int = 16000) -> Tuple[np.ndarray, np.ndarray]:
    """wav -> (interpolated lf0, uv): the `ahocoder16_64` binary when it is on PATH,
    else the built-in autocorrelation tracker."""
    if shutil.which("ahocoder16_64") is not None:
        import tempfile

        from .wav_io import write_wav

        f = tempfile.NamedTemporaryFile(delete=False, suffix=".wav")
        f.close()
        try:
            write_wav(f.name, wav, srate, subtype="pcm16")
            lf0_path = f.name + ".lf0"
            subprocess.run(
                ["ahocoder16_64", f.name, lf0_path, f.name + ".cc", f.name + ".fv"],
                check=True, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            lf0 = read_aco_file(lf0_path)
            ilf0, uv = interpolation(lf0, -10000000000)
            ilf0[ilf0 < -1000] = np.log(60)
            return ilf0, uv
        finally:
            for ext in ("", ".lf0", ".cc", ".fv"):
                try:
                    os.unlink(f.name + ext)
                except OSError:
                    pass
    lf0, uv = f0_autocorr(wav, srate)
    ilf0, _ = interpolation(np.where(uv > 0, lf0, -1e10).astype(np.float32),
                            -10000000000)
    ilf0[~np.isfinite(ilf0)] = np.log(60)
    return ilf0.astype(np.float32), uv
