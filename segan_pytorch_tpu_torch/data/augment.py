"""On-the-fly additive-noise augmentation with ITU P.56 active-speech-level scaling:
``Additive`` and ``ComposeAdditive`` of ``segan_pytorch_tpu/data/augment.py``, copied so
that the same noises, clean slice and ``RandomState`` give the same noisy slice bit for
bit (``tests/test_torch_augment.py`` and ``tests/test_torch_signal.py`` hold them
against the originals).

The noise segment is scaled so that the SNR against the clean signal's *active speech
level* (P.56 method B, not its raw energy) hits a target drawn from ``snr_levels``; a
result that clips is scaled down until it does not. Reference: upstream's
segan/utils.py:51-297 (Additive, addnoise_asl, asl_P56, bin_interp).

The P.56 activity count (upstream utils.py:206-215) is a sequential loop over samples;
it is vectorized across thresholds with numpy (the early ``break`` of the upstream inner
loop relies on active levels never rising with the threshold, which the cumulative
masking below reproduces exactly).
"""
from __future__ import annotations

import glob
import os
from typing import Sequence

import numpy as np
from scipy.signal import lfilter

from .wav_io import read_wav_16k


class ComposeAdditive:
    """A transform that keeps its input beside the additive one's output: x -> (x,
    additive(x))."""

    def __init__(self, additive):
        self.additive = additive

    def __call__(self, x):
        return x, self.additive(x)


class Additive:
    def __init__(self, noises_dir: str, snr_levels: Sequence[int] = (0, 5, 10),
                 rng: np.random.RandomState = None):
        self.noises_dir = noises_dir
        self.snr_levels = list(snr_levels)
        self.rng = rng or np.random
        noises = sorted(glob.glob(os.path.join(noises_dir, "*.wav")))
        if len(noises) == 0:
            raise ValueError(f"[!] No noises found in {noises_dir}")
        self.noises = []
        for npath in noises:
            nwav, _ = read_wav_16k(npath, 16000)
            self.noises.append({"file": npath, "data": nwav.astype(np.float32)})
        self.eps = 1e-22

    def __call__(self, wav, srate: int = 16000, nbits: int = 16) -> np.ndarray:
        wav = np.asarray(wav, np.float32)
        if wav.ndim > 1:
            wav = wav.reshape((-1,))
        noise_idx = int(self.rng.choice(len(self.noises)))
        noise = self.noises[noise_idx]["data"]
        snr = float(self.rng.choice(self.snr_levels))
        noisy, _ = self.addnoise_asl(wav, noise, srate, nbits, snr)
        # anti-clipping renorm (ref utils.py:90-94)
        small = 0.1
        while np.max(noisy) >= 1 or np.min(noisy) < -1:
            noisy = noisy / (1.0 + small)
            small += 0.1
        return noisy.astype(np.float32)

    def addnoise_asl(self, clean, noise, srate, nbits, snr):
        Px, asl, c0 = self.asl_P56(clean, srate, nbits)
        x_len = clean.shape[0]
        noise_len = noise.shape[0]
        if noise_len <= x_len:
            raise ValueError("Noise length has to be greater than speech length!")
        rand_start_limit = int(noise_len - x_len + 1)
        rand_start = int(np.round((rand_start_limit - 1) * self.rng.rand() + 1))
        noise_segment = noise[rand_start : rand_start + x_len]
        noise_bounds = (rand_start, rand_start + x_len)
        Pn = np.dot(noise_segment.T, noise_segment) / x_len
        sf = np.sqrt(Px / Pn / (10 ** (snr / 10)))
        return clean + noise_segment * sf, noise_bounds

    def asl_P56(self, x, srate, nbits):
        """ITU P.56 method B active speech level (ref utils.py:180-253)."""
        T = 0.03
        H = 0.2
        M = 15.9
        thres_no = nbits - 1
        eps = self.eps
        I = int(np.ceil(srate * H))
        g = np.exp(-1 / (srate * T))
        c = 2.0 ** np.arange(-15, thres_no - 15)  # 2^-15 .. 2^-1
        x = np.asarray(x)
        assert x.ndim == 1, x.shape
        sq = float(np.dot(x, x))
        x_len = x.shape[0]
        x_abs = np.abs(x)
        p = lfilter(np.ones(1) - g, np.array([1, -g]), x_abs)
        q = lfilter(np.ones(1) - g, np.array([1, -g]), p)

        # Vectorized activity counting. Reference per-sample loop (utils.py:206-215):
        #   active if q[k] >= c[j]  -> resets hangover
        #   else if hangover < I    -> still counted, hangover++
        #   else break (thresholds are increasing, inner loop stops at first inactive-j)
        # For each threshold j independently: a[j] = #samples within I of a q>=c[j] event.
        # The 'break' only skips j' > j when j is in hangover-exhausted state; since
        # q >= c[j'] implies q >= c[j] for j' > j (c increasing), exhausted hangover at j
        # implies exhausted at j' too — per-threshold independence holds exactly.
        a = np.zeros(c.shape[0], dtype=np.int64)
        for j in range(thres_no):
            active = q >= c[j]
            if not active.any():
                a[j] = 0
                continue
            idx = np.arange(x_len)
            last_active = np.where(active, idx, -(10 * I))
            last_active = np.maximum.accumulate(last_active)
            hang = idx - last_active
            a[j] = int(np.sum((active) | (hang <= I)))  # hangover window of I samples
        # NOTE on parity: the reference increments the hangover counter while counting, so
        # a sample is counted when the counter has not yet reached I (strictly fewer than
        # I prior hang increments). hang<=I above reproduces the same count: the first
        # inactive sample after an active one has hang=1 .. the I-th has hang=I.

        asl = 0
        asl_ms = 0
        c0 = None
        if a[0] == 0:
            return asl_ms, asl, c0
        AdB1 = 10 * np.log10(sq / a[0] + eps)
        CdB1 = 20 * np.log10(c[0] + eps)
        if AdB1 - CdB1 < M:
            return asl_ms, asl, c0
        AdB = np.zeros(c.shape[0])
        CdB = np.zeros(c.shape[0])
        Delta = np.zeros(c.shape[0])
        AdB[0], CdB[0], Delta[0] = AdB1, CdB1, AdB1 - CdB1
        for j in range(1, AdB.shape[0]):
            AdB[j] = 10 * np.log10(sq / (a[j] + eps) + eps)
            CdB[j] = 20 * np.log10(c[j] + eps)
        for j in range(1, Delta.shape[0]):
            if a[j] != 0:
                Delta[j] = AdB[j] - CdB[j]
                if Delta[j] <= M:
                    asl_ms_log, cl0 = self.bin_interp(
                        AdB[j], AdB[j - 1], CdB[j], CdB[j - 1], M, 0.5
                    )
                    asl_ms = 10 ** (asl_ms_log / 10)
                    asl = (sq / x_len) / asl_ms
                    c0 = 10 ** (cl0 / 20)
                    break
        return asl_ms, asl, c0

    def bin_interp(self, upcount, lwcount, upthr, lwthr, Margin, tol):
        """ref utils.py:255-297."""
        if tol < 0:
            tol = -tol
        iterno = 1
        if np.abs(upcount - upthr - Margin) < tol:
            return lwcount, lwthr
        if np.abs(lwcount - lwthr - Margin) < tol:
            return lwcount, lwthr
        midcount = (upcount + lwcount) / 2
        midthr = (upthr + lwthr) / 2
        while True:
            diff = midcount - midthr - Margin
            if np.abs(diff) <= tol:
                break
            iterno += 1
            if iterno > 20:
                tol *= 1.1
            if diff > tol:
                midcount = (upcount + midcount) / 2
                midthr = (upthr + midthr) / 2
            elif diff < -tol:
                midcount = (midcount - lwcount) / 2
                midthr = (midthr + lwthr) / 2
        return midcount, midthr
