"""WAV read/write on scipy: copies of ``read_wav_raw`` and ``write_wav`` of
``segan_pytorch_tpu/data/wav_io.py`` (pinned by ``tests/test_torch_config.py``)."""
from __future__ import annotations

import numpy as np
from scipy.io import wavfile as _wavfile


def read_wav_raw(path: str):
    """scipy wavfile.read passthrough: (rate, samples) with native dtype."""
    return _wavfile.read(path)


def write_wav(path: str, wav: np.ndarray, sr: int = 16000, subtype: str = "float"):
    """Write a wav. 'float' keeps float32; 'pcm16' clips to [-1, 1] and quantizes."""
    wav = np.asarray(wav)
    if subtype == "pcm16":
        wav = np.clip(wav, -1.0, 1.0)
        wav = (wav * 32767.0).astype(np.int16)
    else:
        wav = wav.astype(np.float32)
    _wavfile.write(path, sr, wav)
