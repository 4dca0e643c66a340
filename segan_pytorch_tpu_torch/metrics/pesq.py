"""PESQ (ITU-T P.862) scoring with pluggable backends: a copy of
``segan_pytorch_tpu/metrics/pesq.py`` with the same backend chain and the same
``SEGAN_TPU_PESQ`` modes, pinned to it by ``tests/test_torch_metrics.py``.

The reference shells out to an external ITU `pesqmain` binary, writing temp PCM16 wavs
and parsing stdout; that backend is used when the binary is on PATH, then the `pesq`
python package when installed, then the native C++ pipeline (``native/pesq862.cpp``,
not ITU-certified), then a spectral approximation.
"""
from __future__ import annotations

import os
import re
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_WARNED = False


def _pesq_binary(ref_wav: np.ndarray, deg_wav: np.ndarray, sr: int = 16000) -> Optional[float]:
    """ref utils.py:318-347: write temp PCM16 wavs, run `pesqmain ref deg +16000 +wb`."""
    from ..data.wav_io import write_wav

    tfl = tempfile.NamedTemporaryFile(delete=False)
    tfl.close()
    ref_tfl = tfl.name + "_ref.wav"
    deg_tfl = tfl.name + "_deg.wav"
    try:
        write_wav(ref_tfl, np.asarray(ref_wav), sr, subtype="pcm16")
        write_wav(deg_tfl, np.asarray(deg_wav), sr, subtype="pcm16")
        p = subprocess.run(
            ["pesqmain", ref_tfl, deg_tfl, f"+{sr}", "+wb"],
            stdout=subprocess.PIPE,
            encoding="ascii",
        )
        res_line = p.stdout.split("\n")[-2]
        results = re.split(r"\s+", res_line)
        val = results[-1]
        if "error!" in val:
            return -1.0
        return float(val)
    except Exception:
        return None
    finally:
        for f in (tfl.name, ref_tfl, deg_tfl):
            try:
                os.unlink(f)
            except OSError:
                pass


def _pesq_python(ref_wav: np.ndarray, deg_wav: np.ndarray, sr: int = 16000) -> Optional[float]:
    try:
        from pesq import pesq as _pesq  # optional dependency

        return float(_pesq(sr, np.asarray(ref_wav), np.asarray(deg_wav), "wb"))
    except Exception:
        return None


def PESQ(ref_wav: np.ndarray, deg_wav: np.ndarray, sr: int = 16000) -> Optional[float]:
    """Backend order: ITU `pesqmain` binary (certified, reference parity) → python
    `pesq` package (certified) → native C++ P.862 pipeline
    (metrics/pesq_native.py — full algorithm structure, regenerated tables, NOT
    ITU-certified) → spectral approximation (metrics/perceptual.py) → None (-1).

    SEGAN_TPU_PESQ selects: auto (the chain above) | strict (certified backends
    only, else None) | native (force the C++ pipeline) | approx (force the
    spectral approximation)."""
    global _WARNED
    mode = os.environ.get("SEGAN_TPU_PESQ", "auto")
    if mode not in ("approx", "native"):
        if shutil.which("pesqmain") is not None:
            v = _pesq_binary(ref_wav, deg_wav, sr)
            if v is not None:
                return v
        v = _pesq_python(ref_wav, deg_wav, sr)
        if v is not None:
            return v
        if mode == "strict":
            if not _WARNED:
                print("pesqmain not found! Please add it to your PATH "
                      "(PESQ will read as -1)")
                _WARNED = True
            return None
    if mode != "approx":
        from .pesq_native import pesq_native

        v = pesq_native(ref_wav, deg_wav, sr, wb=True)
        if v is not None:
            if not _WARNED:
                print("[PESQ] using the native P.862 pipeline (no certified "
                      "pesqmain/python-pesq backend found) — full-algorithm "
                      "scores on the MOS-LQO scale, but NOT ITU-certified; see "
                      "tools/pesq_validate.py")
                _WARNED = True
            return v
    from .perceptual import pesq_like

    if not _WARNED:
        print("[PESQ] no certified backend (pesqmain / python-pesq); using the "
              "P.862-structured approximation — values are comparable across runs "
              "but NOT interchangeable with certified PESQ")
        _WARNED = True
    return pesq_like(ref_wav, deg_wav, sr)
