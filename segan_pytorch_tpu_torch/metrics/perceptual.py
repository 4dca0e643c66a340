"""PESQ-like perceptual quality metric (P.862-structured, NOT ITU-certified): a copy of
``segan_pytorch_tpu/metrics/perceptual.py``, pinned to it by ``tests/test_torch_metrics.py``.

The reference's validation objective needs a PESQ value (COVL+PESQ+SSNR early stopping,
ref model.py:413-414) but obtains it from an external ITU `pesqmain` binary
(utils.py:339). When no certified backend exists, this module provides a metric with the
same *structure* as ITU-T P.862 — level alignment, Hann-framed Bark-band pitch-power
densities, Zwicker loudness, asymmetric+symmetric disturbance, Lp time aggregation, MOS
mapping — using analytic Bark/threshold curves instead of the ITU tables.

It is monotonic with distortion and lives on the MOS scale, which is what early stopping
and relative comparisons need; absolute values are NOT interchangeable with certified
PESQ scores (see metrics/pesq.py for the backend order).
"""
from __future__ import annotations

import numpy as np


def _bark(f):
    return 7.0 * np.arcsinh(f / 650.0)


def _bark_inv(z):
    return 650.0 * np.sinh(z / 7.0)


def _abs_thresh_db(f):
    """Terhardt absolute hearing threshold approximation (dB SPL)."""
    f = np.maximum(f, 20.0) / 1000.0
    return (3.64 * f**-0.8 - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f**4)


class _Model:
    def __init__(self, sr: int = 16000, n_bands: int = 49):
        self.sr = sr
        self.frame = 512 if sr == 16000 else 256
        self.hop = self.frame // 2
        self.window = 0.5 * (1 - np.cos(2 * np.pi * np.arange(self.frame)
                                        / self.frame))
        fmax = min(sr / 2.0, 8000.0)
        edges_bark = np.linspace(_bark(50.0), _bark(fmax), n_bands + 1)
        self.edges_hz = _bark_inv(edges_bark)
        freqs = np.fft.rfftfreq(self.frame, 1.0 / sr)
        self.band_of_bin = np.clip(
            np.searchsorted(self.edges_hz, freqs) - 1, -1, n_bands - 1)
        self.band_width = np.diff(edges_bark)
        centers = 0.5 * (self.edges_hz[:-1] + self.edges_hz[1:])
        self.centers = centers
        # hearing-threshold SHAPE from the Terhardt curve, anchored 45 dB below the
        # (normalized) mean speech band power — band powers are O(1) after the
        # reference-power normalization in pesq_like
        tdb = _abs_thresh_db(centers)
        self.p0 = 10.0 ** ((tdb - tdb.min()) / 10.0) * 10.0 ** (-4.5)
        self.n_bands = n_bands
        # modified Zwicker exponent per P.862's low-frequency adjustment
        self.gamma = np.where(centers < 1000.0,
                              0.23 + 0.00002 * (1000.0 - centers), 0.23)

    def frames_power(self, x):
        if len(x) < self.frame:
            x = np.pad(x, (0, self.frame - len(x)))
        n = 1 + max(0, (len(x) - self.frame)) // self.hop
        idx = (np.arange(n)[:, None] * self.hop
               + np.arange(self.frame)[None, :])
        fr = x[idx] * self.window
        spec = np.abs(np.fft.rfft(fr, axis=1)) ** 2
        return fr, spec

    def bark_bands(self, spec):
        out = np.zeros((spec.shape[0], self.n_bands))
        for b in range(self.n_bands):
            sel = self.band_of_bin == b
            if sel.any():
                out[:, b] = spec[:, sel].sum(axis=1)
        return out / np.maximum(self.band_width, 1e-6)

    def loudness(self, ppd):
        p0 = self.p0[None, :]
        g = self.gamma[None, :]
        sl = 0.1866  # global loudness scale
        s = sl * (p0 / 0.5) ** g * ((0.5 + 0.5 * ppd / p0) ** g - 1.0)
        return np.maximum(s, 0.0)


def _align_level(x, target=1e7 / 32768.0**2):
    p = np.mean(x**2) + 1e-20
    return x * np.sqrt(target / p)


def _crude_delay(ref, deg, sr):
    """Envelope cross-correlation delay estimate (P.862 crude align)."""
    hop = sr // 250  # 4 ms
    n = min(len(ref), len(deg)) // hop
    if n < 8:
        return 0
    er = np.log1p(np.abs(ref[: n * hop]).reshape(n, hop).mean(axis=1) * 1e4)
    ed = np.log1p(np.abs(deg[: n * hop]).reshape(n, hop).mean(axis=1) * 1e4)
    er -= er.mean()
    ed -= ed.mean()
    denom = np.linalg.norm(er) * np.linalg.norm(ed)
    if denom < 1e-12:
        return 0
    corr = np.correlate(ed, er, mode="full") / denom
    peak = int(np.argmax(corr))
    lag = peak - (n - 1)
    # only trust a confident, sane estimate; else assume aligned inputs
    if corr[peak] < 0.5 or abs(lag * hop) > len(ref) // 4:
        return 0
    return int(lag * hop)


def pesq_like(ref_wav: np.ndarray, deg_wav: np.ndarray, sr: int = 16000) -> float:
    """P.862-structured MOS estimate in [1.0, 4.64]. See module docstring."""
    ref = np.asarray(ref_wav, np.float64).reshape(-1)
    deg = np.asarray(deg_wav, np.float64).reshape(-1)
    L = min(len(ref), len(deg))
    ref, deg = ref[:L], deg[:L]
    if L < 2048:
        return 1.0
    # time alignment (mostly 0 for enhancement pairs, but cheap to do)
    d = _crude_delay(ref, deg, sr)
    if d > 0:
        deg = deg[d:]
        ref = ref[: len(deg)]
    elif d < 0:
        ref = ref[-d:]
        deg = deg[: len(ref)]
    ref = _align_level(ref)
    deg = _align_level(deg)
    m = _Model(sr)
    fr_r, spec_r = m.frames_power(ref)
    fr_d, spec_d = m.frames_power(deg)
    ppd_r = m.bark_bands(spec_r)
    ppd_d = m.bark_bands(spec_d)
    # normalize both to the reference's mean band power so the perceptual constants
    # below live on a signal-independent O(1) scale (the ITU tables pin this scale
    # implicitly; we pin it explicitly)
    P = np.mean(ppd_r) + 1e-20
    ppd_r = ppd_r / P
    ppd_d = ppd_d / P
    # partial frequency-response compensation of the reference toward the degraded
    mean_r = ppd_r.mean(axis=0)
    mean_d = ppd_d.mean(axis=0)
    # narrow partial compensation: forgive mild (±3 dB) per-band response tilts;
    # anything stronger (sharp filtering, band removal) counts as distortion —
    # stricter than certified PESQ's filtering leniency, which suits enhancement eval
    comp = np.clip((mean_d + 1e-3) / (mean_r + 1e-3), 0.5, 2.0)
    ppd_r_c = ppd_r * comp[None, :]
    # short-term gain compensation of the degraded
    num = (ppd_r_c.sum(axis=1) + 0.05)
    den = (ppd_d.sum(axis=1) + 0.05)
    gain = np.clip(num / den, 3e-4, 5.0)
    ppd_d_c = ppd_d * gain[:, None]
    l_r = m.loudness(ppd_r_c)
    l_d = m.loudness(ppd_d_c)
    d_raw = l_d - l_r
    # deadzone: ignore differences below a quarter of the smaller loudness
    dead = 0.25 * np.minimum(l_d, l_r)
    d_sym = np.sign(d_raw) * np.maximum(np.abs(d_raw) - dead, 0.0)
    # asymmetry factor: additive distortions hurt more than omissions
    asym = ((ppd_d_c + 1e-2) / (ppd_r_c + 1e-2)) ** 1.2
    asym = np.where(asym < 3.0, 0.0, np.minimum(asym, 12.0))
    d_asym = d_sym * asym
    bw = m.band_width[None, :]
    # DIST_SCALE: empirical calibration putting disturbances on a scale where the
    # MOS mapping below spans its range over 0-30 dB SNR degradations (the ITU tables
    # fix this scale implicitly; without them it must be set by calibration)
    DIST_SCALE = 175.0
    frame_sym = DIST_SCALE * np.sqrt(np.sum((d_sym**2) * bw, axis=1) / np.sum(bw))
    frame_asym = DIST_SCALE * np.sum(np.abs(d_asym) * bw, axis=1) / np.sum(bw)
    # emphasize audible frames
    energy_w = ((spec_r.sum(axis=1) + 1e5) / 1e7) ** 0.04
    frame_sym = np.minimum(frame_sym / np.maximum(energy_w, 1e-3), 45.0)
    frame_asym = np.minimum(frame_asym / np.maximum(energy_w, 1e-3), 45.0)

    def lp_time(dfr, p_split=6.0, p_time=2.0, win=20):
        n = len(dfr)
        if n == 0:
            return 0.0
        nw = max(1, n // (win // 2) - 1)
        vals = []
        for i in range(nw):
            seg = dfr[i * win // 2 : i * win // 2 + win]
            if len(seg):
                vals.append(np.mean(seg**p_split) ** (1.0 / p_split))
        vals = np.asarray(vals)
        return np.mean(vals**p_time) ** (1.0 / p_time)

    dsym_t = lp_time(frame_sym)
    dasym_t = lp_time(frame_asym)
    raw = 4.5 - 0.1 * dsym_t - 0.0309 * dasym_t
    # P.862.2-style logistic mapping to MOS-LQO
    mos = 0.999 + (4.999 - 0.999) / (1.0 + np.exp(-1.3669 * raw + 3.8224))
    return float(np.clip(mos, 1.0, 4.64))
