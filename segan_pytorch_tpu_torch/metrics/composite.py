"""Objective speech-quality metrics: SSNR, WSS, LLR and the Hu-Loizou composite
(CSIG/CBAK/COVL), a copy of ``segan_pytorch_tpu/metrics/composite.py`` (NumPy and SciPy,
no framework), pinned to it by ``tests/test_torch_metrics.py``. They run on the host,
in the evaluation worker pool of ``SEGAN.evaluate``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from scipy.linalg import toeplitz

from .pesq import PESQ


def _frames(x: np.ndarray, winlength: int, skiprate: int, num_frames: int) -> np.ndarray:
    idx = np.arange(num_frames)[:, None] * skiprate + np.arange(winlength)[None, :]
    return x[idx]


def _hann_ref(winlength: int) -> np.ndarray:
    # ref utils.py:376-377: 0.5*(1-cos(2*pi*linspace(1..w)/ (w+1)))
    time = np.linspace(1, winlength, winlength) / (winlength + 1)
    return 0.5 * (1 - np.cos(2 * np.pi * time))


def SSNR(ref_wav: np.ndarray, deg_wav: np.ndarray, srate: int = 16000, eps: float = 1e-10
         ) -> Tuple[float, list]:
    """Segmental SNR (ref utils.py:350-395): 30 ms Hann frames, skip 1/4, clamped [-10,35]
    per frame; also returns the overall SNR."""
    ref_wav = np.asarray(ref_wav, np.float64)
    deg_wav = np.asarray(deg_wav, np.float64)
    dif = ref_wav - deg_wav
    # guard the digitally-silent reference BEFORE the log (log10(0) warns);
    # -inf is exactly what the reference's unguarded expression evaluates to
    ref_pow = np.sum(ref_wav**2)
    overall_snr = (10 * np.log10(ref_pow / (np.sum(dif**2) + 10e-20))
                   if ref_pow > 0 else -np.inf)

    winlength = int(np.round(30 * srate / 1000))
    skiprate = winlength // 4
    MIN_SNR, MAX_SNR = -10, 35
    num_frames = int(ref_wav.shape[0] / skiprate - (winlength / skiprate))
    window = _hann_ref(winlength)
    cf = _frames(ref_wav, winlength, skiprate, num_frames) * window
    pf = _frames(deg_wav, winlength, skiprate, num_frames) * window
    sig = np.sum(cf**2, axis=1)
    noi = np.sum((cf - pf) ** 2, axis=1)
    seg = 10 * np.log10(sig / (noi + eps) + eps)
    seg = np.clip(seg, MIN_SNR, MAX_SNR)
    return float(overall_snr), seg.tolist()


# ---------------------------------------------------------------------------
# WSS — Klatt weighted spectral slope over 25 critical bands (ref utils.py:442-596)
# ---------------------------------------------------------------------------
_CENT_FREQ = np.array(
    [50.0, 120, 190, 260, 330, 400, 470, 540, 617.372, 703.378, 798.717, 904.128,
     1020.38, 1148.30, 1288.72, 1442.54, 1610.70, 1794.16, 1993.93, 2211.08,
     2446.71, 2701.97, 2978.04, 3276.17, 3597.63]
)
_BANDWIDTH = np.array(
    [70.0, 70, 70, 70, 70, 70, 70, 77.3724, 86.0056, 95.3398, 105.411, 116.256,
     127.914, 140.423, 153.823, 168.154, 183.457, 199.776, 217.153, 235.631,
     255.255, 276.072, 298.126, 321.465, 346.136]
)


def _crit_filters(srate: int, n_fftby2: int) -> np.ndarray:
    max_freq = srate / 2
    num_crit = 25
    bw_min = _BANDWIDTH[0]
    min_factor = np.exp(-30.0 / (2 * 2.303))
    j = np.arange(n_fftby2)[None, :]
    f0 = np.floor((_CENT_FREQ / max_freq) * n_fftby2)[:, None]
    bw = ((_BANDWIDTH / max_freq) * n_fftby2)[:, None]
    norm = (np.log(bw_min) - np.log(_BANDWIDTH))[:, None]
    filt = np.exp(-11 * (((j - f0) / bw) ** 2) + norm)
    return filt * (filt > min_factor)


def _loc_peaks(slope: np.ndarray, energy: np.ndarray) -> np.ndarray:
    """Nearest-peak search per the reference walk (utils.py:539-564), vectorized over
    frames. slope: (F, 24); energy: (F, 25). Returns (F, 24)."""
    F, S = slope.shape  # S = 24
    pos = slope > 0
    out = np.empty((F, S), energy.dtype)
    # for i with slope>0: n = first index >= i with (n == S) or slope[n] <= 0; take E[n-1]
    # (the ref loop stops when n hits S(=num_crit-1) even if slope still >0)
    # compute 'next non-positive at or after i', capped at S
    next_np = np.full((F, S + 1), S, dtype=np.int64)
    for i in range(S - 1, -1, -1):
        next_np[:, i] = np.where(pos[:, i], next_np[:, i + 1], i)
    # for i with slope<=0: n = first index <= i going down with slope[n] > 0, or -1;
    # take E[n+1]
    prev_pos = np.full((F, S + 1), -1, dtype=np.int64)
    for i in range(S):
        prev_pos[:, i + 1] = np.where(pos[:, i], i, prev_pos[:, i])
    fidx = np.arange(F)[:, None]
    iidx = np.arange(S)[None, :]
    n_right = next_np[:, :S]
    n_left = prev_pos[:, 1:][fidx, iidx - 0]  # prev_pos at i (inclusive)
    # NOTE: for slope[i] <= 0 the walk starts at n=i and moves left while slope[n] <= 0,
    # ending at the first n with slope[n] > 0; result E[n+1]. prev_pos[:, i+1] already
    # equals that first positive index at-or-before i.
    take_right = energy[fidx, np.maximum(n_right - 1, 0)]
    take_left = energy[fidx, np.minimum(n_left + 1, S)]
    out = np.where(pos, take_right, take_left)
    return out


def wss(ref_wav: np.ndarray, deg_wav: np.ndarray, srate: int) -> list:
    """Weighted spectral slope distortion per frame (ref utils.py:442-596)."""
    clean = np.asarray(ref_wav, np.float64)
    proc = np.asarray(deg_wav, np.float64)
    assert clean.shape[0] == proc.shape[0]

    winlength = round(30 * srate / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    num_crit = 25
    n_fft = int(2 ** np.ceil(np.log(2 * winlength) / np.log(2)))
    n_fftby2 = n_fft // 2
    Kmax, Klocmax = 20, 1
    crit = _crit_filters(srate, n_fftby2)  # (25, n_fftby2)

    num_frames = int(clean.shape[0] / skiprate - (winlength / skiprate))
    window = _hann_ref(winlength)
    cf = _frames(clean, winlength, skiprate, num_frames) * window
    pf = _frames(proc, winlength, skiprate, num_frames) * window
    cspec = np.abs(np.fft.fft(cf, n_fft, axis=1)) ** 2
    pspec = np.abs(np.fft.fft(pf, n_fft, axis=1)) ** 2
    ce = cspec[:, :n_fftby2] @ crit.T  # (F, 25)
    pe = pspec[:, :n_fftby2] @ crit.T
    ce = 10 * np.log10(np.maximum(ce, 1e-10))
    pe = 10 * np.log10(np.maximum(pe, 1e-10))

    cs = ce[:, 1:num_crit] - ce[:, : num_crit - 1]  # (F, 24)
    ps = pe[:, 1:num_crit] - pe[:, : num_crit - 1]
    clp = _loc_peaks(cs, ce)
    plp = _loc_peaks(ps, pe)
    dbmax_c = np.max(ce, axis=1, keepdims=True)
    dbmax_p = np.max(pe, axis=1, keepdims=True)
    Wmax_c = Kmax / (Kmax + dbmax_c - ce[:, : num_crit - 1])
    Wloc_c = Klocmax / (Klocmax + clp - ce[:, : num_crit - 1])
    W_c = Wmax_c * Wloc_c
    Wmax_p = Kmax / (Kmax + dbmax_p - pe[:, : num_crit - 1])
    Wloc_p = Klocmax / (Klocmax + plp - pe[:, : num_crit - 1])
    W_p = Wmax_p * Wloc_p
    W = (W_c + W_p) / 2
    distortion = np.sum(W * (cs - ps) ** 2, axis=1) / np.sum(W, axis=1)
    return distortion.tolist()


# ---------------------------------------------------------------------------
# LLR — LPC log-likelihood ratio, Levinson–Durbin order 16 (ref utils.py:598-715)
# ---------------------------------------------------------------------------
def lpcoeff(speech_frame: np.ndarray, model_order: int):
    """Autocorrelation + Levinson–Durbin (ref utils.py:659-715). Returns
    (acorr, refcoeff, lpparams) as float32 like the reference."""
    winlength = speech_frame.shape[0]
    R = np.array(
        [np.sum(speech_frame[: winlength - k] * speech_frame[k:winlength])
         for k in range(model_order + 1)]
    )
    a = np.ones((model_order,))
    E = np.zeros((model_order + 1,))
    rcoeff = np.zeros((model_order,))
    E[0] = R[0]
    for i in range(model_order):
        if i == 0:
            sum_term = 0.0
            a_past = a[:0]
        else:
            a_past = a[:i].copy()
            sum_term = np.sum(a_past * R[i:0:-1])
        rcoeff[i] = (R[i + 1] - sum_term) / E[i]
        a[i] = rcoeff[i]
        if i > 0:
            a[:i] = a_past[:i] - rcoeff[i] * a_past[::-1]
        E[i + 1] = (1 - rcoeff[i] * rcoeff[i]) * E[i]
    acorr = np.array(R, np.float32)
    refcoeff = np.array(rcoeff, np.float32)
    lpparams = np.array([1] + list(-a), np.float32)
    return acorr, refcoeff, lpparams


def llr(ref_wav: np.ndarray, deg_wav: np.ndarray, srate: int) -> np.ndarray:
    clean = np.asarray(ref_wav, np.float64)
    proc = np.asarray(deg_wav, np.float64)
    assert clean.shape[0] == proc.shape[0]
    winlength = round(30 * srate / 1000.0)
    skiprate = int(np.floor(winlength / 4))
    P = 10 if srate < 10000 else 16
    num_frames = int(clean.shape[0] / skiprate - (winlength / skiprate))
    window = _hann_ref(winlength)
    cf = _frames(clean, winlength, skiprate, num_frames) * window
    pf = _frames(proc, winlength, skiprate, num_frames) * window
    distortion = []
    for k in range(num_frames):
        # Digitally-silent frames (exact zeros) would divide 0/0 inside
        # Levinson–Durbin (R[0] == 0 -> E[0] == 0) and again in num/den below.
        # Guard BEFORE the divide — mark the frame non-finite (CompositeEval's
        # trimmed mean drops non-finite frames) so metric evaluation is
        # warning-free. The reference has the same hole with no guard
        # (ref utils.py:659-715); these frames crash/poison it, so skipping
        # them is a no-op on any input the reference itself can score.
        if not np.any(cf[k]) or not np.any(pf[k]):
            distortion.append(np.float64("nan"))
            continue
        R_clean, _, A_clean = lpcoeff(cf[k], P)
        _, _, A_proc = lpcoeff(pf[k], P)
        A_clean = A_clean[None, :].astype(np.float64)
        A_proc = A_proc[None, :].astype(np.float64)
        toe = toeplitz(R_clean.astype(np.float64))
        num = np.squeeze(A_proc @ toe @ A_proc.T)
        den = np.squeeze(A_clean @ toe @ A_clean.T)
        # guard ONLY the exact cases that warn (den==0 divide; ratio<=0 log) —
        # the reference's unguarded np.log(num/den) yields non-finite values
        # there anyway, and CompositeEval drops non-finite frames; every frame
        # the reference scores finitely takes the identical np.log path
        if den == 0:
            distortion.append(np.float64("nan"))
            continue
        ratio = num / den
        distortion.append(np.log(ratio) if ratio > 0 else np.float64("nan"))
    return np.array(distortion)


# ---------------------------------------------------------------------------
# Composite (ref utils.py:397-440)
# ---------------------------------------------------------------------------
def CompositeEval(ref_wav, deg_wav, log_all: bool = False, pesq_value: Optional[float] = None):
    """Hu–Loizou composite measures. 95-percentile trimmed means of WSS/LLR, PESQ + SSNR,
    MOS-clamped combinations (coefficients at ref utils.py:431-436)."""
    alpha = 0.95
    len_ = min(ref_wav.shape[0], deg_wav.shape[0])
    ref_wav = ref_wav[:len_]
    deg_wav = deg_wav[:len_]

    wss_dist_vec = sorted(wss(ref_wav, deg_wav, 16000))
    wss_dist = np.mean(wss_dist_vec[: int(round(len(wss_dist_vec) * alpha))])

    LLR_dist = llr(ref_wav, deg_wav, 16000)
    # Digitally-silent frames (R[0] == 0) make Levinson–Durbin divide 0/0 —
    # the reference has the same hole (ref utils.py:659-715, no guard) and one
    # such frame would poison the trimmed mean into NaN (seen on corpora whose
    # pauses are exact zeros). Drop non-finite frame distortions instead; a
    # no-op on any input the reference itself can score.
    LLR_dist = sorted(LLR_dist[np.isfinite(LLR_dist)])
    LLR_len = round(len(LLR_dist) * alpha)
    llr_mean = np.mean(LLR_dist[:LLR_len]) if LLR_len else np.nan

    snr_mean, segsnr_mean = SSNR(ref_wav, deg_wav, 16000)
    segSNR = np.mean(segsnr_mean)

    if pesq_value is None:
        pesq_raw = PESQ(ref_wav, deg_wav)
    else:
        pesq_raw = pesq_value
    if pesq_raw is None:
        pesq_raw = -1.0
    pesq_raw = float(pesq_raw)

    def trim_mos(val):
        return min(max(val, 1), 5)

    Csig = 3.093 - 1.029 * llr_mean + 0.603 * pesq_raw - 0.009 * wss_dist
    Cbak = 1.634 + 0.478 * pesq_raw - 0.007 * wss_dist + 0.063 * segSNR
    Covl = 1.594 + 0.805 * pesq_raw - 0.512 * llr_mean - 0.007 * wss_dist
    Csig, Cbak, Covl = trim_mos(Csig), trim_mos(Cbak), trim_mos(Covl)
    if log_all:
        return Csig, Cbak, Covl, pesq_raw, segSNR
    return Csig, Cbak, Covl


def eval_composite(clean_utt, Genh_utt, noisy_utt=None):
    """Per-utterance dict, optional noisy baseline (ref utils.py:299-316)."""
    clean_utt = np.asarray(clean_utt).reshape(-1)
    Genh_utt = np.asarray(Genh_utt).reshape(-1)
    csig, cbak, covl, pesq, ssnr = CompositeEval(clean_utt, Genh_utt, True)
    evals = {"csig": csig, "cbak": cbak, "covl": covl, "pesq": pesq, "ssnr": ssnr}
    if noisy_utt is not None:
        noisy_utt = np.asarray(noisy_utt).reshape(-1)
        csig, cbak, covl, pesq, ssnr = CompositeEval(clean_utt, noisy_utt, True)
        return evals, {"csig": csig, "cbak": cbak, "covl": covl, "pesq": pesq,
                       "ssnr": ssnr}
    return evals


def composite_helper(args):
    return eval_composite(*args)
