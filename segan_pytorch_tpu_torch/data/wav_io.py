"""WAV read/write on scipy: copies of ``read_wav_raw``, ``_to_float``, ``read_wav_16k``,
``wav_num_samples_16k`` and ``write_wav`` of ``segan_pytorch_tpu/data/wav_io.py``
(pinned by ``tests/test_torch_config.py``)."""
from __future__ import annotations

import struct
from fractions import Fraction

import numpy as np
from scipy.io import wavfile as _wavfile
from scipy.signal import resample_poly


def read_wav_raw(path: str):
    """scipy wavfile.read passthrough: (rate, samples) with native dtype."""
    return _wavfile.read(path)


def _to_float(wav: np.ndarray) -> np.ndarray:
    if wav.dtype == np.int16:
        return wav.astype(np.float32) / 32768.0
    if wav.dtype == np.int32:
        return wav.astype(np.float32) / 2147483648.0
    if wav.dtype == np.uint8:
        return (wav.astype(np.float32) - 128.0) / 128.0
    return wav.astype(np.float32)


def read_wav_16k(path: str, sr: int = 16000):
    """librosa.load(path, sr) equivalent: mono float32 in [-1,1], resampled."""
    rate, wav = _wavfile.read(path)
    wav = _to_float(np.asarray(wav))
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if rate != sr:
        frac = Fraction(sr, rate).limit_denominator(1000)
        wav = resample_poly(wav, frac.numerator, frac.denominator).astype(np.float32)
    return wav.astype(np.float32), sr


def wav_num_samples_16k(path: str):
    """Sample count at 16 kHz from the RIFF header alone (no decode); None when the
    header cannot prove it (not RIFF, not 16 kHz, compressed): callers then read the
    whole file."""
    try:
        with open(path, "rb") as f:
            riff = f.read(12)
            if len(riff) < 12 or riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
                return None
            fmt = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    return None
                cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
                if cid == b"fmt ":
                    body = f.read(size)
                    if len(body) < 16:
                        return None
                    (tag, n_ch, rate, _br, block_align,
                     _bits) = struct.unpack("<HHIIHH", body[:16])
                    if tag not in (1, 3) or rate != 16000 or block_align == 0:
                        return None  # compressed / needs resampling
                    fmt = (n_ch, block_align)
                elif cid == b"data":
                    if fmt is None:
                        return None
                    return size // fmt[1]
                else:
                    f.seek(size + (size & 1), 1)
    except OSError:
        return None


def write_wav(path: str, wav: np.ndarray, sr: int = 16000, subtype: str = "float"):
    """Write a wav. 'float' keeps float32; 'pcm16' clips to [-1, 1] and quantizes."""
    wav = np.asarray(wav)
    if subtype == "pcm16":
        wav = np.clip(wav, -1.0, 1.0)
        wav = (wav * 32767.0).astype(np.int16)
    else:
        wav = wav.astype(np.float32)
    _wavfile.write(path, sr, wav)
